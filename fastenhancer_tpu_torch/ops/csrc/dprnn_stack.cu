// The dprnn block stack for one streaming frame, as one CUDA kernel for
// Hopper (sm_90a). ops/_build.py compiles this file with nvcc into a shared
// library with a plain C interface; ops/dprnn_stack.py loads it with
// ctypes and launches it on PyTorch's current stream.
//
// Replaces fastenhancer_tpu/ops/dprnn_stack.py::dprnn_stack_step, the
// Pallas TPU kernel, for the folded block form. Per block:
//   time-GRU step on every (bin, stream) row    -> h_new[i]
//   x = x + trnn_fc(h_new)
//   bidirectional GRU sweep across the F' bins  -> ys [F', 2Hd]
//   x = x + frnn_fc(ys)
// Products accumulate in float32 and the gate math is float32; values are
// rounded to the activation type T where the Pallas kernel rounds them:
// the new carry, each fc output before its residual, each residual sum,
// the sweep's input projection (b_ih in; b_hh rides the recurrent half, in
// float32), its h for its product and its output. The sweep's h also stays
// in float32 for the z * h term, as there.
//
// What bounds it on the H100. At DPRNN-B (F'=24, C'=36, Hd=18, 3 blocks)
// and 256 streams one frame is 0.60 GFLOP over about 3.6 MB of carries,
// frame and weights: about 1.1 us at the memory rate, so bytes bound it.
// Its time is latency: 3 x (1 + 24) dependent steps, each a short dot
// product per thread, and the launch.
//
// The design. One thread block per stream, as the RNNFormer stack kernel
// (rnnformer_stack.cu), so 256 streams give 256 blocks for the 132 SMs.
// The time-GRU step is that kernel's (fe::gru_rows in stack_common.cuh)
// over the stream's F' rows; the sweep is the one bsrnn_stack.cu runs with
// LSTM cells (fe::band_sweep in band_sweep.cuh), here with GRU cells, both
// directions at once so the chain is F' steps per block, not 2F'. The
// stream's activations, carry and sweep output stay in shared memory for
// the whole stack (14 KB at DPRNN-B); the weights (about 16k values per
// block) are read from global memory, where L1/L2 keep them.
//
// Layouts (frequency-major rows, as the Pallas kernel's): x and x_out
// [F', B, C]; h and h_out [NB, F', B, C]; thread block b owns stream b.
// h_out is a separate buffer; each block reads its rows of h[i] before it
// writes any of h_out[i].

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "band_sweep.cuh"
#include "stack_common.cuh"

namespace {

using fe::kThreads;

// Stacked plan of the folded blocks (ops/dprnn_stack.py::plan_dprnn_stack).
// Matrices are [in, out]; NB leads every array.
template <typename T>
struct DprnnPlan {
  const T* w_xr;   // [NB, C, C]       time GRU input weights, gate r
  const T* w_hr;   // [NB, C, C]       time GRU recurrent weights, gate r
  const T* b_r;    // [NB, 1, C]       b_ir + b_hr
  const T* w_xz;   // [NB, C, C]
  const T* w_hz;   // [NB, C, C]
  const T* b_z;    // [NB, 1, C]       b_iz + b_hz
  const T* w_xn;   // [NB, C, C]
  const T* w_hn;   // [NB, C, C]
  const T* b_xn;   // [NB, 1, C]       b_in
  const T* b_hn;   // [NB, 1, C]       b_hn
  const T* w_tfc;  // [NB, C, C]       trnn_fc (post-BN folded)
  const T* b_tfc;  // [NB, 1, C]
  const T* w_fih;  // [NB, 2, C, 3Hd]  sweep input weights (fwd, bwd)
  const T* b_fih;  // [NB, 2, 1, 3Hd]
  const T* w_fhh;  // [NB, 2, Hd, 3Hd] sweep recurrent weights
  const T* b_fhh;  // [NB, 2, 1, 3Hd]
  const T* w_ffc;  // [NB, 2Hd, C]     frnn_fc (post-BN folded)
  const T* b_ffc;  // [NB, 1, C]
};

template <typename T>
__global__ void __launch_bounds__(kThreads, fe::kMinBlocks)
    dprnn_stack_kernel(const T* __restrict__ x, const T* __restrict__ h,
                       T* __restrict__ x_out, T* __restrict__ h_out,
                       DprnnPlan<T> p, int batch, int bins, int ch, int hd,
                       int nblocks) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int b = blockIdx.x;
  const int fc = bins * ch;
  const size_t cc = static_cast<size_t>(ch) * ch;
  const int g3 = 3 * hd;
  const size_t row_ld = static_cast<size_t>(batch) * ch;  // between bins
  float* xs = smem;               // [F, C] activations
  float* hs = xs + fc;            // [F, C] carry of the current block
  float* hn = hs + fc;            // [F, C] new carry
  float* ys = hn + fc;            // [F, 2Hd] sweep output
  float* scratch = ys + bins * 2 * hd;  // the sweep's state

  for (int e = tid; e < fc; e += nt) {
    const int f = e / ch;
    xs[e] = fe::load_f(x[f * row_ld + b * ch + (e - f * ch)]);
  }
  __syncthreads();

  for (int i = 0; i < nblocks; ++i) {
    const size_t base = static_cast<size_t>(i) * bins * row_ld + b * ch;
    for (int e = tid; e < fc; e += nt) {
      const int f = e / ch;
      hs[e] = fe::load_f(h[base + f * row_ld + (e - f * ch)]);
    }
    __syncthreads();

    // --- time-GRU step, trnn_fc + residual ---
    const size_t ic = static_cast<size_t>(i) * ch;
    fe::gru_rows<T>(xs, hs, hn, h_out + base, row_ld, p.w_xr + i * cc,
                    p.w_xz + i * cc, p.w_xn + i * cc, p.w_hr + i * cc,
                    p.w_hz + i * cc, p.w_hn + i * cc, p.b_r + ic, p.b_z + ic,
                    p.b_xn + ic, p.b_hn + ic, bins, ch);
    __syncthreads();
    fe::fc_residual<T>(hn, xs, p.w_tfc + i * cc, p.b_tfc + ic, bins, ch);
    __syncthreads();

    // --- bidirectional sweep over the bins, frnn_fc + residual ---
    fe::band_sweep<T, fe::GruCell<T>>(
        xs, ys, scratch, p.w_fih + static_cast<size_t>(i) * 2 * ch * g3,
        p.b_fih + static_cast<size_t>(i) * 2 * g3,
        p.w_fhh + static_cast<size_t>(i) * 2 * hd * g3,
        p.b_fhh + static_cast<size_t>(i) * 2 * g3, bins, ch, hd);
    fe::linear_rows<T>(ys, xs, p.w_ffc + static_cast<size_t>(i) * 2 * hd * ch,
                       p.b_ffc + ic, bins, 2 * hd, ch, xs);
    __syncthreads();
  }

  for (int e = tid; e < fc; e += nt) {
    const int f = e / ch;
    x_out[f * row_ld + b * ch + (e - f * ch)] = fe::store_t<T>(xs[e]);
  }
}

size_t smem_bytes(int bins, int ch, int hd) {
  return (3 * static_cast<size_t>(bins) * ch +
          static_cast<size_t>(bins) * 2 * hd + fe::sweep_smem_floats(hd)) *
         sizeof(float);
}

template <typename T>
int launch(const void* x, const void* h, void* x_out, void* h_out,
           const void* const* plan, int batch, int bins, int ch, int hd,
           int nblocks, void* stream) {
  const size_t smem = smem_bytes(bins, ch, hd);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dprnn_stack_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const auto w = [plan](int k) { return static_cast<const T*>(plan[k]); };
  const DprnnPlan<T> p{w(0),  w(1),  w(2),  w(3),  w(4),  w(5),
                       w(6),  w(7),  w(8),  w(9),  w(10), w(11),
                       w(12), w(13), w(14), w(15), w(16), w(17)};
  dprnn_stack_kernel<T>
      <<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(x), static_cast<const T*>(h),
          static_cast<T*>(x_out), static_cast<T*>(h_out), p, batch, bins, ch,
          hd, nblocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 on success). The 18 plan
// arrays come in ops/dprnn_stack.py::PLAN_KEYS order.
int dprnn_stack_f32(const void* x, const void* h, void* x_out, void* h_out,
                    const void* w_xr, const void* w_hr, const void* b_r,
                    const void* w_xz, const void* w_hz, const void* b_z,
                    const void* w_xn, const void* w_hn, const void* b_xn,
                    const void* b_hn, const void* w_tfc, const void* b_tfc,
                    const void* w_fih, const void* b_fih, const void* w_fhh,
                    const void* b_fhh, const void* w_ffc, const void* b_ffc,
                    int batch, int bins, int ch, int hd, int nblocks,
                    void* stream) {
  const void* plan[] = {w_xr, w_hr, b_r,   w_xz,  w_hz,  b_z,
                        w_xn, w_hn, b_xn,  b_hn,  w_tfc, b_tfc,
                        w_fih, b_fih, w_fhh, b_fhh, w_ffc, b_ffc};
  return launch<float>(x, h, x_out, h_out, plan, batch, bins, ch, hd,
                       nblocks, stream);
}

int dprnn_stack_bf16(const void* x, const void* h, void* x_out, void* h_out,
                     const void* w_xr, const void* w_hr, const void* b_r,
                     const void* w_xz, const void* w_hz, const void* b_z,
                     const void* w_xn, const void* w_hn, const void* b_xn,
                     const void* b_hn, const void* w_tfc, const void* b_tfc,
                     const void* w_fih, const void* b_fih, const void* w_fhh,
                     const void* b_fhh, const void* w_ffc, const void* b_ffc,
                     int batch, int bins, int ch, int hd, int nblocks,
                     void* stream) {
  const void* plan[] = {w_xr, w_hr, b_r,   w_xz,  w_hz,  b_z,
                        w_xn, w_hn, b_xn,  b_hn,  w_tfc, b_tfc,
                        w_fih, b_fih, w_fhh, b_fhh, w_ffc, b_ffc};
  return launch<__nv_bfloat16>(x, h, x_out, h_out, plan, batch, bins, ch, hd,
                               nblocks, stream);
}

const char* dprnn_stack_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
