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
// Shared memory holds float32 copies of values that are exact in T. The
// block math itself is fe::rnnformer_stack_frame in stack_common.cuh, which
// the whole-frame kernel (fused_frame.cu) runs too.
//
// The one difference from the Pallas kernel: the softmax is stabilised with
// each head's own row max (as nn/attention.py's XLA path does) instead of
// the max across heads, so no head can underflow to 0/0.
//
// What bounds it on the H100. At FastEnhancer_B (B=256 streams, F=24,
// C=36, H=4, 3 blocks) one frame is about 0.6 GFLOP over 1.3 MB of
// activations and carries and 0.17 MB of weights: far too small to be
// FLOP- or bandwidth-bound. Its time is latency: the launch, the chain of
// dependent phases inside each block, and the serial k-loops of tiny
// C-wide dot products. The design answers that by running the whole stack
// as one launch, with one thread block per stream: all of a stream's F rows
// (x, h, q, k, v and the H*F*F logits) stay in shared memory across all
// blocks, so nothing but the carry touches device memory between phases,
// and 256 streams give 256 independent thread blocks for the 132 SMs. The
// weights are read from global memory, where L1/L2 keep them (each block's
// weights are read by every stream). Tensor cores (wgmma), TMA and weight
// staging in shared memory are left to later work. The LN form adds, per
// LayerNorm, one pass that writes the fc output whole and two block-wide
// reductions over the F*C = 864 values of the tile (warp shuffles, then 8
// partial sums in shared memory): 6 LayerNorms, 12 reductions, a frame at
// FastEnhancer_B's 3 blocks, a few microseconds of barriers beside the
// same chain of dot products.
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

#include "stack_common.cuh"

namespace {

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

size_t smem_bytes(int freq, int ch, int heads) {
  return fe::stack_smem_floats(freq, ch, heads) * sizeof(float);
}

template <typename T, bool kLn>
int launch_form(const T* x, const T* h, T* x_out, T* h_out,
                const StackPlan<T>& plan, const fe::LnPlan<T>& ln, int batch,
                int freq, int ch, int heads, int nblocks, float scale,
                cudaStream_t stream) {
  const size_t smem = smem_bytes(freq, ch, heads);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rnnformer_stack_kernel<T, kLn>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  rnnformer_stack_kernel<T, kLn><<<batch, kThreads, smem, stream>>>(
      x, h, x_out, h_out, plan, ln, batch, freq, ch, heads, nblocks, scale);
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

const char* rnnformer_stack_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
