// The RNNFormer block stack for one streaming frame, as one CUDA kernel for
// Hopper (sm_90a). ops/_build.py compiles this file with nvcc into a shared
// library with a plain C interface; ops/rnnformer_stack.py loads it with
// ctypes and launches it on PyTorch's current stream.
//
// Replaces fastenhancer_tpu/ops/rnnformer_stack.py::rnnformer_stack_step, the
// Pallas TPU kernel. It computes what that kernel's stack_math computes,
// block after block:
//   GRU step (torch gate order r, z, n)      -> h_new[i]
//   x = x + rnn_fc(h_new) ; x = x + pe[i]
//   x = x + attn_fc(MHSA over the F frequency rows of each stream)
// in two forms, one template each: the folded default block form, and the
// ln ablation's (stack_math(ln=True); wb_fc and wb_afc given), where each
// fc output is LayerNorm'd over the stream's [F, C] tile before its
// residual, out = diff + rsqrt(var + eps) * (weight * bias), the
// reference's affine quirk (fe::ln_residual).
// Matmuls accumulate in float32 and the gate and softmax math is float32.
// Results are rounded to the activation type T at the Pallas kernel's
// points: h_new, each fc output before its residual, each residual sum, the
// pe sum, q/k/v after the bias, the probabilities and the attention output.
// The block math itself is in the shared headers, which the whole-frame
// kernel (fused_frame.cu) runs too.
//
// The one difference from the Pallas kernel: the softmax is stabilised with
// each head's own row max (as nn/attention.py's XLA path does) instead of
// the max across heads, so no head can underflow to 0/0.
//
// What bounds it on the H100. At FastEnhancer_B (B=256 streams, F=24,
// C=36, H=4, 3 blocks) one frame is about 0.6 GFLOP over 1.3 MB of
// activations and carries and 0.17 MB of weights: far too small to be
// FLOP- or bandwidth-bound. Its time is latency: the launch and the chain
// of about 30 dependent, barrier-separated phases inside each thread block.
// The design runs the whole stack as one launch, one thread block per
// stream: all of a stream's F rows stay in shared memory across all
// blocks, so nothing but the carry touches device memory between phases,
// and 256 streams give 256 independent thread blocks for the 132 SMs.
//
// Two forms per block type. The float32 forms (the card's correctness
// reference: TF32 would break their 1e-5 tolerance) keep scalar float32
// FMA chains, one output per thread, weights read from global memory
// (fe::rnnformer_stack_frame, stack_common.cuh). The bfloat16 forms (the
// served type) run every product on the tensor cores (stack_tc.cuh, on
// mma_common.cuh's mma.sync routines): the GRU as six products per output
// tile into four register accumulators, rnn_fc, q/k/v and attn_fc with
// their residual epilogues, and the attention's q.k^T and P.v, with the
// softmax in registers. Activations are bf16 tiles, and each block's
// weights come in four stages: bulk copies (cp.async.bulk on an mbarrier)
// into a staging buffer while the stage before computes, then one pass
// into a slot with padded rows for ldmatrix (54,176 bytes of shared memory
// a stream at FE_B: 2 blocks per SM). What still bounds it (python -m
// fastenhancer_tpu_torch.phase_profile): the chain of 12 barrier-separated
// stages, about half of it the products' ldmatrix/mma latency over 8
// warps, 30% moving each stage into the slot and starting the next one's
// copies, 20% the attention. The LN form adds, per LayerNorm, one pass that writes the fc
// output whole and two block-wide reductions over the F*C = 864 values of
// the tile (warp shuffles, then 8 partial sums in shared memory).
//
// Carry layout: h and h_out are [NB, B*F, C], rows batch-major
// [b0f0..b0fF, b1f0..]; thread block b owns rows b*F..b*F+F-1 of every
// block's carry. h_out is a separate buffer (the wrapper allocates it).
// Each thread block reads all of its rows of h[i] into shared memory before
// it writes any row of h_out[i], so an in-place update (h_out == h) would be
// safe too.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <type_traits>

#include "stack_common.cuh"
#include "stack_tc.cuh"

namespace {

using bf16 = __nv_bfloat16;
using fe::kThreads;
using fe::StackPlan;

template <typename T, bool kLn>
__global__ void __launch_bounds__(kThreads, fe::kMinBlocks)
    rnnformer_stack_kernel(const T* __restrict__ x, const T* h,
                           T* __restrict__ x_out, T* h_out, StackPlan<T> p,
                           fe::LnPlan<T> ln, int batch, int freq, int ch,
                           int heads, int nblocks, float scale) {
  extern __shared__ float smem[];
  const int fc = freq * ch;
  const int b = blockIdx.x;
  for (int e = threadIdx.x; e < fc; e += blockDim.x) {
    smem[e] = fe::load_f(x[static_cast<size_t>(b) * fc + e]);
  }
  __syncthreads();
  fe::rnnformer_stack_frame<T, kLn>(smem, h, h_out, p, b, batch, freq, ch,
                                    heads, nblocks, scale, ln);
  for (int e = threadIdx.x; e < fc; e += blockDim.x) {
    x_out[static_cast<size_t>(b) * fc + e] = fe::store_t<T>(smem[e]);
  }
}

// The bfloat16 forms on the tensor cores (stack_tc.cuh). Shared memory, in
// bf16 elements: a 16-byte chunk of zeros and the stages' mbarrier, the
// activations (StackGeom::act), the weight slot and the staging buffer.
template <bool kLn>
__global__ void __launch_bounds__(kThreads, fe::kMinBlocks)
    rnnformer_stack_tc_kernel(const bf16* __restrict__ x, const bf16* h,
                              bf16* __restrict__ x_out, bf16* h_out,
                              StackPlan<bf16> p, fe::LnPlan<bf16> ln,
                              int batch, int freq, int ch, int heads,
                              int nblocks, float scale) {
  extern __shared__ __align__(16) unsigned char smem_tc[];
  const fe::tc::StackGeom g(freq, ch, heads);
  bf16* zero = reinterpret_cast<bf16*>(smem_tc);
  auto* bar = reinterpret_cast<uint64_t*>(smem_tc + 16);
  bf16* act = zero + 16;
  bf16* slot = act + g.act();
  bf16* staging = slot + g.slot();
  const int b = blockIdx.x;
  if (threadIdx.x < 8) zero[threadIdx.x] = __float2bfloat16_rn(0.f);
  fe::tc::stack_init(act, g);
  if (threadIdx.x == 0) {
    fe::tc::mbar_init(bar);
    fe::tc::mbar_fence_init();
  }
  __syncthreads();
  const bf16* wb_fc = kLn ? ln.wb_fc : nullptr;
  const bf16* wb_afc = kLn ? ln.wb_afc : nullptr;
  fe::tc::run_stages(
      4 * nblocks, staging, slot, bar,
      [&](int s, auto& v) {
        fe::tc::stack_pieces(s, v, p, wb_fc, wb_afc, g);
      },
      [&](int s) {
        // stage 0 also brings this stream's frame into x
        if (s == 0) {
          fe::tc::stage_rows(act, g.ldc,
                             x + static_cast<size_t>(b) * freq * ch, freq,
                             ch);
        }
        fe::tc::stack_side(s, h, act + g.tile(), b, batch, g);
      },
      [&](int s) { fe::tc::stack_pre_stage(s, act, g, scale, zero); },
      [&](int s, const bf16* w) {
        fe::tc::stack_stage<kLn>(s, w, act, h_out, b, batch, g, ln.eps,
                                 zero);
      });
  for (int e = threadIdx.x; e < freq * ch; e += blockDim.x) {
    x_out[static_cast<size_t>(b) * freq * ch + e] =
        act[e / ch * g.ldc + e % ch];
  }
}

size_t smem_bytes_tc(int freq, int ch, int heads) {
  const fe::tc::StackGeom g(freq, ch, heads);
  return (16 + static_cast<size_t>(g.act()) + g.slot() + g.staging()) *
         sizeof(bf16);
}

size_t smem_bytes(int freq, int ch, int heads) {
  return fe::stack_smem_floats(freq, ch, heads) * sizeof(float);
}

template <typename T, bool kLn>
int launch_form(const T* x, const T* h, T* x_out, T* h_out,
                const StackPlan<T>& plan, const fe::LnPlan<T>& ln, int batch,
                int freq, int ch, int heads, int nblocks, float scale,
                cudaStream_t stream) {
  constexpr bool kTc = std::is_same_v<T, bf16>;
  const size_t smem =
      kTc ? smem_bytes_tc(freq, ch, heads) : smem_bytes(freq, ch, heads);
  const void* kernel;
  if constexpr (kTc) {
    kernel = reinterpret_cast<const void*>(rnnformer_stack_tc_kernel<kLn>);
  } else {
    kernel = reinterpret_cast<const void*>(rnnformer_stack_kernel<T, kLn>);
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if constexpr (kTc) {
    rnnformer_stack_tc_kernel<kLn><<<batch, kThreads, smem, stream>>>(
        x, h, x_out, h_out, plan, ln, batch, freq, ch, heads, nblocks, scale);
  } else {
    rnnformer_stack_kernel<T, kLn><<<batch, kThreads, smem, stream>>>(
        x, h, x_out, h_out, plan, ln, batch, freq, ch, heads, nblocks, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

// wb_fc == nullptr selects the folded default form (wb_afc and eps unread).
template <typename T>
int launch(const void* x, const void* h, void* x_out, void* h_out,
           const void* w_x, const void* w_h, const void* b_gru,
           const void* w_fc, const void* b_fc, const void* w_qkv,
           const void* b_qkv, const void* w_afc, const void* b_afc,
           const void* pe, const void* wb_fc, const void* wb_afc, int batch,
           int freq, int ch, int heads, int nblocks, float eps,
           void* stream) {
  const StackPlan<T> plan{
      static_cast<const T*>(w_x),   static_cast<const T*>(w_h),
      static_cast<const T*>(b_gru), static_cast<const T*>(w_fc),
      static_cast<const T*>(b_fc),  static_cast<const T*>(w_qkv),
      static_cast<const T*>(b_qkv), static_cast<const T*>(w_afc),
      static_cast<const T*>(b_afc), static_cast<const T*>(pe)};
  const fe::LnPlan<T> ln{static_cast<const T*>(wb_fc),
                         static_cast<const T*>(wb_afc), eps};
  const float scale = static_cast<float>(1.0 / std::sqrt(double(ch / heads)));
  const auto xt = static_cast<const T*>(x);
  const auto ht = static_cast<const T*>(h);
  const auto st = static_cast<cudaStream_t>(stream);
  if (wb_fc != nullptr) {
    return launch_form<T, true>(xt, ht, static_cast<T*>(x_out),
                                static_cast<T*>(h_out), plan, ln, batch, freq,
                                ch, heads, nblocks, scale, st);
  }
  return launch_form<T, false>(xt, ht, static_cast<T*>(x_out),
                               static_cast<T*>(h_out), plan, ln, batch, freq,
                               ch, heads, nblocks, scale, st);
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 on success). wb_fc and
// wb_afc ([NB, C] each) and eps are the LN form's; null wb_fc runs the
// folded default form.
int rnnformer_stack_f32(const void* x, const void* h, void* x_out,
                        void* h_out, const void* w_x, const void* w_h,
                        const void* b_gru, const void* w_fc, const void* b_fc,
                        const void* w_qkv, const void* b_qkv,
                        const void* w_afc, const void* b_afc, const void* pe,
                        const void* wb_fc, const void* wb_afc, int batch,
                        int freq, int ch, int heads, int nblocks, float eps,
                        void* stream) {
  return launch<float>(x, h, x_out, h_out, w_x, w_h, b_gru, w_fc, b_fc, w_qkv,
                       b_qkv, w_afc, b_afc, pe, wb_fc, wb_afc, batch, freq,
                       ch, heads, nblocks, eps, stream);
}

int rnnformer_stack_bf16(const void* x, const void* h, void* x_out,
                         void* h_out, const void* w_x, const void* w_h,
                         const void* b_gru, const void* w_fc,
                         const void* b_fc, const void* w_qkv,
                         const void* b_qkv, const void* w_afc,
                         const void* b_afc, const void* pe,
                         const void* wb_fc, const void* wb_afc, int batch,
                         int freq, int ch, int heads, int nblocks, float eps,
                         void* stream) {
  return launch<__nv_bfloat16>(x, h, x_out, h_out, w_x, w_h, b_gru, w_fc,
                               b_fc, w_qkv, b_qkv, w_afc, b_afc, pe, wb_fc,
                               wb_afc, batch, freq, ch, heads, nblocks, eps,
                               stream);
}

// Bytes of dynamic shared memory one thread block (one stream) of the
// bfloat16 form needs; the wrapper checks it against the card's limit.
size_t rnnformer_stack_smem_bf16(int freq, int ch, int heads) {
  return smem_bytes_tc(freq, ch, heads);
}

const char* rnnformer_stack_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
