// The bidirectional recurrent sweep across the frequency bands of one
// streaming frame, shared by bsrnn_stack.cu (LSTM cells) and
// dprnn_stack.cu (GRU cells).
//
// For the stream a thread block owns, a forward recurrence runs over bands
// 0..F-1 and a backward one over bands F-1..0, both from a zero state, at
// the same time: step f of the loop runs forward band f and backward band
// F-1-f, so the serial chain is F steps and not 2F. Thread u owns hidden
// unit j = u mod Hd of direction d = u / Hd and computes that unit's G
// gate pre-activations itself, so the cell update needs no exchange
// between threads; one __syncthreads() per step publishes the new h
// (double-buffered) to every thread.
//
// The input projection is computed inside each step, [x_band | h] against
// [W_ih; W_hh], rather than hoisted out of the loop as the Pallas kernels
// do: the FLOPs are the same and no [2, F, G*Hd] buffer is needed, which at
// BSRNN-S would take 127 KB of shared memory in float32, more than half of
// what a block may use. Its arithmetic is the hoisted one all the same: the
// input half is summed in float32 and rounded to T, then the float32
// recurrent half is added.
//
// Every thread of the block calls band_sweep; it ends with
// __syncthreads().
#pragma once

#include "stack_common.cuh"

namespace fe {

// An LSTM cell (torch gate order i, f, g, o) as the sweep runs it: the
// input half carries round_T(b_ih + b_hh) (summed in T, as the Pallas
// kernel sums them), the state is the cell c in float32.
template <typename T>
struct LstmCell {
  static constexpr int kGates = 4;
  __device__ static float bias_x(const T* b_ih, const T* b_hh, int n) {
    return round_t<T>(load_f(b_ih[n]) + load_f(b_hh[n]));
  }
  __device__ static float bias_h(const T*, int) { return 0.f; }
  // gx: input half (rounded to T), gh: recurrent half; returns h'.
  __device__ static float update(const float* gx, const float* gh,
                                 float& c) {
    const float i = sigmoid_f(gx[0] + gh[0]);
    const float f = sigmoid_f(gx[1] + gh[1]);
    const float g = tanhf(gx[2] + gh[2]);
    const float o = sigmoid_f(gx[3] + gh[3]);
    c = f * c + i * g;
    return o * tanhf(c);
  }
};

// A GRU cell (torch gate order r, z, n): b_ih rides the input half, b_hh
// the recurrent half (the n gate needs r * (h W_hn + b_hn)); the state is
// h itself in float32.
template <typename T>
struct GruCell {
  static constexpr int kGates = 3;
  __device__ static float bias_x(const T* b_ih, const T*, int n) {
    return load_f(b_ih[n]);
  }
  __device__ static float bias_h(const T* b_hh, int n) {
    return load_f(b_hh[n]);
  }
  __device__ static float update(const float* gx, const float* gh,
                                 float& h) {
    const float r = sigmoid_f(gx[0] + gh[0]);
    const float z = sigmoid_f(gx[1] + gh[1]);
    const float n = tanhf(gx[2] + r * gh[2]);
    h = (1.0f - z) * n + z * h;
    return h;
  }
};

// Floats of shared memory band_sweep uses besides xs and ys: the
// double-buffered rounded h [2, 2, Hd] and the cell state [2, Hd].
__host__ __device__ inline size_t sweep_smem_floats(int hd) {
  return 3 * 2 * static_cast<size_t>(hd);
}

// xs: [F, C] float32 activations (values exact in T); ys: [F, 2Hd] float32
// output, band f's row [fwd h | bwd h] (torch bidirectional layout),
// rounded to T; scratch: sweep_smem_floats(Hd) floats. w_ih: [2, C, G*Hd],
// b_ih: [2, 1, G*Hd], w_hh: [2, Hd, G*Hd], b_hh: [2, 1, G*Hd] for this
// layer (direction 0 forward, 1 backward; [in, out]).
template <typename T, class Cell>
__device__ void band_sweep(const float* xs, float* ys, float* scratch,
                           const T* w_ih, const T* b_ih, const T* w_hh,
                           const T* b_hh, int bands, int ch, int hd) {
  constexpr int G = Cell::kGates;
  const int gh_n = G * hd;                 // gate columns per direction
  const int units = 2 * hd;
  float* hr = scratch;                     // [2][2][Hd] rounded h
  float* st = scratch + 2 * units;         // [2][Hd] cell state
  for (int e = threadIdx.x; e < 3 * units; e += blockDim.x) scratch[e] = 0.f;
  __syncthreads();

  for (int f = 0; f < bands; ++f) {
    const float* h_cur = hr + (f & 1) * units;
    float* h_next = hr + ((f + 1) & 1) * units;
    for (int u = threadIdx.x; u < units; u += blockDim.x) {
      const int d = u / hd;
      const int j = u - d * hd;
      const int band = d == 0 ? f : bands - 1 - f;
      const T* wi = w_ih + static_cast<size_t>(d) * ch * gh_n + j;
      const T* wh = w_hh + static_cast<size_t>(d) * hd * gh_n + j;
      const float* xrow = xs + band * ch;
      const float* hrow = h_cur + d * hd;
      float ax[G], ah[G];
#pragma unroll
      for (int g = 0; g < G; ++g) ax[g] = ah[g] = 0.f;
#pragma unroll 4
      for (int k = 0; k < ch; ++k) {
        const float xv = xrow[k];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          ax[g] = fmaf(xv, load_f(wi[static_cast<size_t>(k) * gh_n + g * hd]),
                       ax[g]);
        }
      }
#pragma unroll 4
      for (int k = 0; k < hd; ++k) {
        const float hv = hrow[k];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          ah[g] = fmaf(hv, load_f(wh[static_cast<size_t>(k) * gh_n + g * hd]),
                       ah[g]);
        }
      }
      const size_t bo = static_cast<size_t>(d) * gh_n + j;
      float gx[G], gr[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        gx[g] = round_t<T>(ax[g] + Cell::bias_x(b_ih + bo, b_hh + bo, g * hd));
        gr[g] = ah[g] + Cell::bias_h(b_hh + bo, g * hd);
      }
      const float hv = round_t<T>(Cell::update(gx, gr, st[u]));
      h_next[u] = hv;
      ys[band * units + u] = hv;
    }
    __syncthreads();
  }
}

}  // namespace fe
