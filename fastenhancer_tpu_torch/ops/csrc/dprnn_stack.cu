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
// Its time is latency: 3 x (1 + 24) dependent steps and the launch.
//
// The design. One thread block per stream, as the RNNFormer stack kernel
// (rnnformer_stack.cu), so 256 streams give 256 blocks for the 132 SMs,
// in two forms:
//   - float32 (the card's correctness reference) and the shapes the
//     tensor-core form does not take: scalar FMA chains. The time-GRU step
//     is the RNNFormer kernel's (fe::gru_rows in stack_common.cuh) over the
//     stream's F' rows; the sweep is the one bsrnn_stack.cu runs with LSTM
//     cells (fe::band_sweep in band_sweep.cuh), here with GRU cells, both
//     directions at once so the chain is F' steps per block, not 2F'; the
//     weights are read from global memory, where L1/L2 keep them; in that
//     sweep only 2Hd threads work, each reading its unit's 3 (C + Hd)
//     weights from global memory every step, and a __syncthreads() ends
//     each step (about 2 us a step at DPRNN-B);
//   - bfloat16 with Hd <= 32 (DPRNN-T/B/S): dprnn_tc.cuh. The products on
//     the tensor cores through stack_tc.cuh's stages (weights staged a
//     stage ahead by run_stages), the sweep's input projection hoisted out
//     of the recurrence into one product, and the recurrence one warp a
//     direction with W_hh in registers and h exchanged by shuffles, no
//     block barrier inside it.
//
// Layouts (frequency-major rows, as the Pallas kernel's): x and x_out
// [F', B, C]; h and h_out [NB, F', B, C]; thread block b owns stream b.
// h_out is a separate buffer; each block reads its rows of h[i] before it
// writes any of h_out[i].

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "band_sweep.cuh"
#include "dprnn_tc.cuh"
#include "stack_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using fe::DprnnPlan;
using fe::kThreads;

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

// The bfloat16 form on the tensor cores (dprnn_tc.cuh), for Hd <= kMaxHd.
// Shared memory, in bf16 elements: a 16-byte chunk of zeros (and 16 bytes
// unused), the activations (DprnnGeom::act) and the two weight slots.
template <int kMaxHd>
__global__ void __launch_bounds__(kThreads, fe::kMinBlocks)
    dprnn_stack_tc_kernel(const bf16* __restrict__ x,
                          const bf16* __restrict__ h,
                          bf16* __restrict__ x_out, bf16* __restrict__ h_out,
                          DprnnPlan<bf16> p, int batch, int bins, int ch,
                          int hd, int nblocks) {
  extern __shared__ __align__(16) unsigned char smem_tc[];
  const fe::tc::DprnnGeom g(bins, ch, hd);
  bf16* zero = reinterpret_cast<bf16*>(smem_tc);
  bf16* act = zero + 16;
  bf16* slot = act + g.act();
  const fe::tc::DprnnTiles t(act, g);
  const int b = blockIdx.x;
  const size_t row_ld = static_cast<size_t>(batch) * ch;  // between bins
  if (threadIdx.x < 8) zero[threadIdx.x] = __float2bfloat16_rn(0.f);
  fe::tc::run_stages_direct(
      4 * nblocks, slot, slot + g.slot(),
      [&](int s, auto& v) { fe::tc::dprnn_pieces(s, v, p, g); },
      [&](int s) {
        // each block's GRU stage brings the stream's carry rows of that
        // block into hs (the first also its frame into xs); the rows are
        // B * C apart, and 8-byte aligned only when b is odd at C = 36
        if ((s & 3) != 0) return;
        if (s == 0) {
          fe::tc::stage_rows_strided(t.xs, g.s.ldc, x + b * ch, row_ld,
                                     bins, ch);
        }
        fe::tc::stage_rows_strided(
            t.hs, g.s.ldc,
            h + static_cast<size_t>(s >> 2) * bins * row_ld + b * ch, row_ld,
            bins, ch);
      },
      [&](int) {},
      [&](int s, const bf16* w) {
        fe::tc::dprnn_stage<kMaxHd>(s, w, t, h_out + b * ch, row_ld, g,
                                    zero);
      });
  for (int e = threadIdx.x; e < bins * ch; e += blockDim.x) {
    const int f = e / ch;
    const int j = e - f * ch;
    x_out[f * row_ld + b * ch + j] = t.xs[f * g.s.ldc + j];
  }
}

// The register tile of W_hh each lane holds: the smallest of 16, 24, 32
// that covers Hd (0: the tensor-core form does not take Hd).
int max_hd_of(int hd) {
  return hd <= 16 ? 16 : (hd <= 24 ? 24 : (hd <= 32 ? 32 : 0));
}

size_t smem_bytes_tc(int bins, int ch, int hd) {
  const fe::tc::DprnnGeom g(bins, ch, hd);
  return (16 + static_cast<size_t>(g.act()) + 2 * g.slot()) * sizeof(bf16);
}

template <int kMaxHd>
int launch_tc_form(const bf16* x, const bf16* h, bf16* x_out, bf16* h_out,
                   const DprnnPlan<bf16>& p, int batch, int bins, int ch,
                   int hd, int nblocks, cudaStream_t stream) {
  const size_t smem = smem_bytes_tc(bins, ch, hd);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dprnn_stack_tc_kernel<kMaxHd>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dprnn_stack_tc_kernel<kMaxHd><<<batch, kThreads, smem, stream>>>(
      x, h, x_out, h_out, p, batch, bins, ch, hd, nblocks);
  return static_cast<int>(cudaGetLastError());
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

// The tensor-core form (bfloat16, Hd <= 32; dprnn_tc.cuh), same
// arguments as dprnn_stack_bf16. Returns cudaErrorInvalidValue for an Hd
// it does not take.
int dprnn_stack_tc_bf16(const void* x, const void* h, void* x_out,
                        void* h_out, const void* w_xr, const void* w_hr,
                        const void* b_r, const void* w_xz, const void* w_hz,
                        const void* b_z, const void* w_xn, const void* w_hn,
                        const void* b_xn, const void* b_hn, const void* w_tfc,
                        const void* b_tfc, const void* w_fih,
                        const void* b_fih, const void* w_fhh,
                        const void* b_fhh, const void* w_ffc,
                        const void* b_ffc, int batch, int bins, int ch,
                        int hd, int nblocks, void* stream) {
  const void* plan[] = {w_xr, w_hr, b_r,   w_xz,  w_hz,  b_z,
                        w_xn, w_hn, b_xn,  b_hn,  w_tfc, b_tfc,
                        w_fih, b_fih, w_fhh, b_fhh, w_ffc, b_ffc};
  const auto w = [&plan](int k) { return static_cast<const bf16*>(plan[k]); };
  const DprnnPlan<bf16> p{w(0),  w(1),  w(2),  w(3),  w(4),  w(5),
                          w(6),  w(7),  w(8),  w(9),  w(10), w(11),
                          w(12), w(13), w(14), w(15), w(16), w(17)};
  const auto xt = static_cast<const bf16*>(x);
  const auto ht = static_cast<const bf16*>(h);
  const auto xo = static_cast<bf16*>(x_out);
  const auto ho = static_cast<bf16*>(h_out);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (max_hd_of(hd)) {
    case 16:
      return launch_tc_form<16>(xt, ht, xo, ho, p, batch, bins, ch, hd,
                                nblocks, st);
    case 24:
      return launch_tc_form<24>(xt, ht, xo, ho, p, batch, bins, ch, hd,
                                nblocks, st);
    case 32:
      return launch_tc_form<32>(xt, ht, xo, ho, p, batch, bins, ch, hd,
                                nblocks, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Bytes of dynamic shared memory one thread block (one stream) of the
// tensor-core form needs; ops/dprnn_stack.py::tc_smem_bytes computes the
// same.
size_t dprnn_stack_smem_bf16(int bins, int ch, int hd) {
  return smem_bytes_tc(bins, ch, hd);
}

const char* dprnn_stack_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
