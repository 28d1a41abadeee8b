// BSRNN's LSTM layer stack for one streaming frame, as one CUDA kernel for
// Hopper (sm_90a). ops/_build.py compiles this file with nvcc into a shared
// library with a plain C interface; ops/bsrnn_stack.py loads it with
// ctypes and launches it on PyTorch's current stream.
//
// Replaces fastenhancer_tpu/ops/bsrnn_stack.py::bsrnn_stack_step, the
// Pallas TPU kernel, for the folded layer form. Per layer:
//   time-LSTM step on every (band, stream) row  -> (h, c)[i]
//   x = x + fc_time(h)
//   bidirectional LSTM sweep across the F bands -> ys [F, 2H]
//   x = x + fc_freq(ys)
// Products accumulate in float32 and the gate math is float32; values are
// rounded to the activation type T where the Pallas kernel rounds them:
// the new h and c, each fc output before its residual, each residual sum,
// the sweep's input projection, its h (for its product and its output).
// The sweep's c stays float32, as there. Shared memory holds float32
// copies of values that are exact in T.
//
// What bounds it on the H100. At BSRNN-S (C=64, H=2C=128, 6 layers, 31
// bands) and 256 streams one frame is 30.4 GFLOP (319,488 multiply-adds
// per row per layer, 7,936 rows, 6 layers) over about 55 MB of carries,
// frame and weights: 31 us at the bf16 tensor-core peak, so operations
// bound it, the first kernel of the port where arithmetic matters. This
// kernel runs that arithmetic as float32 FMAs on the CUDA cores, not on
// the tensor cores, so the floor it can reach is the float32 rate (67
// TFLOP/s: about 0.45 ms), and with a load for each weight it falls short
// of that. The serial chain is 6 layers x (1 + 31) dependent steps.
//
// Two forms. The bfloat16 form on the tensor cores (band_tc.cuh, below as
// bsrnn_stack_tc_kernel; entry bsrnn_stack_tc_bf16) takes C and H
// multiples of 16 with C <= 64 and H <= 128, BSRNN-S and -XT among them:
// a cluster of two blocks per tile of streams shares each weight fragment
// over the tile and keeps each direction's recurrent weights on chip
// through the sweep. The scalar form below (bsrnn_stack_kernel) is the
// float32 form, the card's correctness reference, and takes every other
// shape; ops/bsrnn_stack.py::kernel_form picks one before launch.
//
// The scalar design. One thread block per stream runs the whole stack with
// no grid-wide sync, since each layer's sweep couples the bands of one
// stream only; 256 streams give 256 blocks, two per SM on the 132 SMs. The
// forward and backward sweeps run at the same time on two halves of the
// block (band_sweep.cuh), so the chain is 31 steps per layer, not 62. The
// weights (about 640 KB per layer in bf16) do not fit shared memory and
// come from L2 (3.9 MB in all); in the time cell each weight a thread
// loads serves 8 rows. Blocks of 2 and 4 streams, where each weight load
// serves every stream of the block, measured slower at BSRNN-S and 256
// streams in bf16 (3.90 and 6.17 ms against 3.58 ms for one stream per
// block): fewer loads per FMA did not pay for the warps and SMs they
// idled. The stream's activations, the time cell's carries and the sweep's
// output stay in shared memory (43 KB at BSRNN-S) for the whole stack.
//
// Layouts (frequency-major rows, as the Pallas kernel's): x and x_out
// [F, B, C]; h and h_out [L, 2 (h, c), F, B, H]; thread block b owns
// stream b. h_out is a separate buffer; each block reads its rows of h[i]
// before it writes any of h_out[i].

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "band_sweep.cuh"
#include "band_tc.cuh"
#include "stack_common.cuh"

namespace {

using fe::BandPlan;
using fe::kThreads;

// rows of one thread's register tile in the time cell
constexpr int kRows = 8;

// The time-LSTM step of one layer on the stream's F band rows: gates =
// x.W_ih + h.W_hh + b (float32), the cell from c, h' -> hn (float32 copy)
// and h' and c' rounded to T into row f of h_out_h and h_out_c. xs: [F, C],
// ht: [F, H] in shared memory; c_in, h_out_h, h_out_c: the stream's rows of
// this layer's carries, row f at f * row_ld. Thread item (j, chunk) holds
// unit j's four gates for kRows rows, so each weight it loads serves kRows
// rows.
template <typename T>
__device__ void lstm_time_cell(const float* xs, const float* ht, float* hn,
                               const T* c_in, T* h_out_h, T* h_out_c,
                               size_t row_ld, const T* w_ih, const T* w_hh,
                               const T* bias, int rows, int ch, int hd) {
  const int g4 = 4 * hd;
  const int chunks = (rows + kRows - 1) / kRows;
  for (int e = threadIdx.x; e < chunks * hd; e += blockDim.x) {
    const int j = e % hd;
    const int r0 = (e / hd) * kRows;
    int row[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) row[r] = min(r0 + r, rows - 1);
    float acc[kRows][4];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[r][g] = 0.f;
    }
#pragma unroll 2
    for (int k = 0; k < ch; ++k) {
      float w[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        w[g] = fe::load_f(w_ih[static_cast<size_t>(k) * g4 + g * hd + j]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float xv = xs[row[r] * ch + k];
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[r][g] = fmaf(xv, w[g], acc[r][g]);
      }
    }
#pragma unroll 2
    for (int k = 0; k < hd; ++k) {
      float w[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        w[g] = fe::load_f(w_hh[static_cast<size_t>(k) * g4 + g * hd + j]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float hv = ht[row[r] * hd + k];
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[r][g] = fmaf(hv, w[g], acc[r][g]);
      }
    }
    float b[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) b[g] = fe::load_f(bias[g * hd + j]);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r0 + r >= rows) break;
      const size_t o = (r0 + r) * row_ld + j;
      const float ig = fe::sigmoid_f(acc[r][0] + b[0]);
      const float fg = fe::sigmoid_f(acc[r][1] + b[1]);
      const float gg = tanhf(acc[r][2] + b[2]);
      const float og = fe::sigmoid_f(acc[r][3] + b[3]);
      const float c = fg * fe::load_f(c_in[o]) + ig * gg;
      const T h_new = fe::store_t<T>(og * tanhf(c));
      hn[(r0 + r) * hd + j] = fe::load_f(h_new);
      h_out_h[o] = h_new;
      h_out_c[o] = fe::store_t<T>(c);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, fe::kMinBlocks)
    bsrnn_stack_kernel(const T* __restrict__ x, const T* __restrict__ h,
                       T* __restrict__ x_out, T* __restrict__ h_out,
                       BandPlan<T> p, int batch, int bands, int ch, int hd,
                       int layers) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int b = blockIdx.x;
  const int fc = bands * ch;
  const int g4 = 4 * hd;
  const size_t x_ld = static_cast<size_t>(batch) * ch;  // between bands
  const size_t h_ld = static_cast<size_t>(batch) * hd;
  float* xs = smem;                   // [F, C] activations
  float* ys = xs + fc;                // [F, 2H] sweep output
  float* ht = ys;                     // [F, H] time cell input h
  float* hn = ys + bands * hd;        // [F, H] time cell output h
  float* scratch = ys + bands * 2 * hd;  // the sweep's state

  for (int e = tid; e < fc; e += nt) {
    const int f = e / ch;
    xs[e] = fe::load_f(x[f * x_ld + b * ch + (e - f * ch)]);
  }
  __syncthreads();

  for (int i = 0; i < layers; ++i) {
    // this stream's rows of h[i, 0] and h[i, 1]
    const size_t lh = static_cast<size_t>(i) * 2 * bands * h_ld + b * hd;
    const size_t lc = lh + bands * h_ld;
    for (int e = tid; e < bands * hd; e += nt) {
      const int f = e / hd;
      ht[e] = fe::load_f(h[lh + f * h_ld + (e - f * hd)]);
    }
    __syncthreads();

    // --- time-LSTM step, fc_time + residual ---
    lstm_time_cell<T>(xs, ht, hn, h + lc, h_out + lh, h_out + lc, h_ld,
                      p.w_tih + static_cast<size_t>(i) * ch * g4,
                      p.w_thh + static_cast<size_t>(i) * hd * g4,
                      p.b_t + static_cast<size_t>(i) * g4, bands, ch, hd);
    __syncthreads();
    fe::linear_rows<T>(hn, xs, p.w_fct + static_cast<size_t>(i) * hd * ch,
                       p.b_fct + static_cast<size_t>(i) * ch, bands, hd, ch,
                       xs);
    __syncthreads();

    // --- bidirectional sweep over the bands, fc_freq + residual ---
    fe::band_sweep<T, fe::LstmCell<T>>(
        xs, ys, scratch, p.w_fih + static_cast<size_t>(i) * 2 * ch * g4,
        p.b_fih + static_cast<size_t>(i) * 2 * g4,
        p.w_fhh + static_cast<size_t>(i) * 2 * hd * g4,
        p.b_fhh + static_cast<size_t>(i) * 2 * g4, bands, ch, hd);
    fe::linear_rows<T>(ys, xs, p.w_fcf + static_cast<size_t>(i) * 2 * hd * ch,
                       p.b_fcf + static_cast<size_t>(i) * ch, bands, 2 * hd,
                       ch, xs);
    __syncthreads();
  }

  for (int e = tid; e < fc; e += nt) {
    const int f = e / ch;
    x_out[f * x_ld + b * ch + (e - f * ch)] = fe::store_t<T>(xs[e]);
  }
}

size_t smem_bytes(int bands, int ch, int hd) {
  return (static_cast<size_t>(bands) * (ch + 2 * hd) +
          fe::sweep_smem_floats(hd)) *
         sizeof(float);
}

template <typename T>
int launch(const void* x, const void* h, void* x_out, void* h_out,
           const void* w_tih, const void* w_thh, const void* b_t,
           const void* w_fct, const void* b_fct, const void* w_fih,
           const void* b_fih, const void* w_fhh, const void* b_fhh,
           const void* w_fcf, const void* b_fcf, int batch, int bands, int ch,
           int hd, int layers, void* stream) {
  const size_t smem = smem_bytes(bands, ch, hd);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bsrnn_stack_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const BandPlan<T> plan{
      static_cast<const T*>(w_tih), static_cast<const T*>(w_thh),
      static_cast<const T*>(b_t),   static_cast<const T*>(w_fct),
      static_cast<const T*>(b_fct), static_cast<const T*>(w_fih),
      static_cast<const T*>(b_fih), static_cast<const T*>(w_fhh),
      static_cast<const T*>(b_fhh), static_cast<const T*>(w_fcf),
      static_cast<const T*>(b_fcf)};
  bsrnn_stack_kernel<T>
      <<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(x), static_cast<const T*>(h),
          static_cast<T*>(x_out), static_cast<T*>(h_out), plan, batch, bands,
          ch, hd, layers);
  return static_cast<int>(cudaGetLastError());
}

// The bfloat16 form on the tensor cores (band_tc.cuh): a cluster of two
// thread blocks per tile of 8 streams, one per sweep direction. Its shared
// memory allows one block per SM, so the kernel may take up to 255
// registers a thread (half of each warp's W_hh fragments live in them).
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kThreads, 1)
    bsrnn_stack_tc_kernel(fe::tc::BandArgs a, int bands, int ch, int hd) {
  extern __shared__ __align__(16) unsigned char smem_tc[];
  fe::tc::band_stack_tc(a, bands, ch, hd,
                        reinterpret_cast<fe::tc::bf16*>(smem_tc));
}

size_t tc_smem_bytes(int bands, int ch, int hd) {
  return fe::tc::BandGeom(bands, ch, hd).elems() * sizeof(fe::tc::bf16);
}

int launch_tc(const fe::tc::BandArgs& a, int bands, int ch, int hd,
              void* stream) {
  const size_t smem = tc_smem_bytes(bands, ch, hd);
  const cudaError_t err = cudaFuncSetAttribute(
      bsrnn_stack_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (a.batch + fe::tc::kTile - 1) / fe::tc::kTile;
  bsrnn_stack_tc_kernel<<<2 * tiles, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(a, bands, ch,
                                                               hd);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 on success).
int bsrnn_stack_f32(const void* x, const void* h, void* x_out, void* h_out,
                    const void* w_tih, const void* w_thh, const void* b_t,
                    const void* w_fct, const void* b_fct, const void* w_fih,
                    const void* b_fih, const void* w_fhh, const void* b_fhh,
                    const void* w_fcf, const void* b_fcf, int batch,
                    int bands, int ch, int hd, int layers, void* stream) {
  return launch<float>(x, h, x_out, h_out, w_tih, w_thh, b_t, w_fct, b_fct,
                       w_fih, b_fih, w_fhh, b_fhh, w_fcf, b_fcf, batch, bands,
                       ch, hd, layers, stream);
}

int bsrnn_stack_bf16(const void* x, const void* h, void* x_out, void* h_out,
                     const void* w_tih, const void* w_thh, const void* b_t,
                     const void* w_fct, const void* b_fct, const void* w_fih,
                     const void* b_fih, const void* w_fhh, const void* b_fhh,
                     const void* w_fcf, const void* b_fcf, int batch,
                     int bands, int ch, int hd, int layers, void* stream) {
  return launch<__nv_bfloat16>(x, h, x_out, h_out, w_tih, w_thh, b_t, w_fct,
                               b_fct, w_fih, b_fih, w_fhh, b_fhh, w_fcf,
                               b_fcf, batch, bands, ch, hd, layers, stream);
}

// The bfloat16 tensor-core form: xp_ws and ys_ws are the workspaces of
// band_tc.cuh ([tiles, 2, F, H/16, 32, 16] and [tiles, F * 8, 2H] bf16,
// tiles of 8 streams). Shapes outside the form (C or H not a multiple of
// 16, C > 64, H > 128) return cudaErrorInvalidValue.
int bsrnn_stack_tc_bf16(const void* x, const void* h, void* x_out,
                        void* h_out, const void* w_tih, const void* w_thh,
                        const void* b_t, const void* w_fct, const void* b_fct,
                        const void* w_fih, const void* b_fih,
                        const void* w_fhh, const void* b_fhh,
                        const void* w_fcf, const void* b_fcf, void* xp_ws,
                        void* ys_ws, int batch, int bands, int ch, int hd,
                        int layers, void* stream) {
  if (ch % 16 || hd % 16 || ch > fe::tc::kMaxC || hd > fe::tc::kMaxH) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  using B = fe::tc::bf16;
  const fe::tc::BandArgs a{
      static_cast<const B*>(x),
      static_cast<const B*>(h),
      static_cast<B*>(x_out),
      static_cast<B*>(h_out),
      {static_cast<const B*>(w_tih), static_cast<const B*>(w_thh),
       static_cast<const B*>(b_t), static_cast<const B*>(w_fct),
       static_cast<const B*>(b_fct), static_cast<const B*>(w_fih),
       static_cast<const B*>(b_fih), static_cast<const B*>(w_fhh),
       static_cast<const B*>(b_fhh), static_cast<const B*>(w_fcf),
       static_cast<const B*>(b_fcf)},
      static_cast<B*>(xp_ws),
      static_cast<B*>(ys_ws),
      batch,
      layers};
  return launch_tc(a, bands, ch, hd, stream);
}

// dynamic shared memory of one block of the tensor-core form
size_t bsrnn_stack_tc_smem(int bands, int ch, int hd) {
  return tc_smem_bytes(bands, ch, hd);
}

const char* bsrnn_stack_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
