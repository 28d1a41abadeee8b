// The RNNFormer block stack for one streaming frame, as one CUDA kernel for
// Hopper (sm_90a). ops/_build.py compiles this file with nvcc into a shared
// library with a plain C interface; ops/rnnformer_stack.py loads it with
// ctypes and launches it on PyTorch's current stream.
//
// Replaces fastenhancer_tpu/ops/rnnformer_stack.py::rnnformer_stack_step, the
// Pallas TPU kernel. It computes what that kernel's stack_math computes for
// the folded default block form (no LayerNorm), block after block:
//   GRU step (torch gate order r, z, n)      -> h_new[i]
//   x = x + rnn_fc(h_new) ; x = x + pe[i]
//   x = x + attn_fc(MHSA over the F frequency rows of each stream)
// Matmuls accumulate in float32 and the gate and softmax math is float32.
// Results are rounded to the activation type T at the Pallas kernel's
// points: h_new, each fc output before its residual, each residual sum, the
// pe sum, q/k/v after the bias, the probabilities and the attention output.
// Shared memory holds float32 copies of values that are exact in T.
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
// staging in shared memory are left to later work.
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

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load_f(float v) { return v; }
__device__ __forceinline__ float load_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T store_t(float v);
template <>
__device__ __forceinline__ float store_t<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 store_t<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T's precision, kept as float
template <typename T>
__device__ __forceinline__ float round_t(float v) {
  return load_f(store_t<T>(v));
}

__device__ __forceinline__ float sigmoid_f(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// Stacked plan of the folded blocks (ops/rnnformer_stack.py::plan_stack).
// Matrices are [in, out]; NB leads every array.
template <typename T>
struct Plan {
  const T* w_x;    // [NB, 3, C, C] GRU input weights, gates r, z, n
  const T* w_h;    // [NB, 3, C, C] GRU recurrent weights
  const T* b_gru;  // [NB, 4, C]    b_ir + b_hr, b_iz + b_hz, b_in, b_hn
  const T* w_fc;   // [NB, C, C]    rnn_fc (post-norm folded)
  const T* b_fc;   // [NB, C]
  const T* w_qkv;  // [NB, 3, C, C] q, k, v; column h*d + t is head h, dim t
  const T* b_qkv;  // [NB, 3, C]
  const T* w_afc;  // [NB, C, C]    attn_fc (post-norm folded)
  const T* b_afc;  // [NB, C]
  const T* pe;     // [NB, F, C]    zeros for blocks without an embedding
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rnnformer_stack_kernel(const T* __restrict__ x, const T* h,
                           T* __restrict__ x_out, T* h_out, Plan<T> p,
                           int batch, int freq, int ch, int heads, int nblocks,
                           float scale) {
  extern __shared__ float smem[];
  const int fc = freq * ch;
  const int ff = freq * freq;
  const int d = ch / heads;
  const size_t cc = static_cast<size_t>(ch) * ch;
  float* xs = smem;     // [F, C] activations
  float* hs = xs + fc;  // [F, C] carry of the current block
  float* hn = hs + fc;  // [F, C] new carry
  float* qs = hn + fc;  // [F, C] queries, then the attention output
  float* ks = qs + fc;  // [F, C] keys
  float* vs = ks + fc;  // [F, C] values
  float* ps = vs + fc;  // [H, F, F] logits, then probabilities
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  for (int e = tid; e < fc; e += nt) {
    xs[e] = load_f(x[static_cast<size_t>(b) * fc + e]);
  }

  for (int i = 0; i < nblocks; ++i) {
    const size_t rows = (static_cast<size_t>(i) * batch + b) * fc;
    for (int e = tid; e < fc; e += nt) hs[e] = load_f(h[rows + e]);
    __syncthreads();

    // --- GRU step ---
    {
      const T* wx = p.w_x + i * 3 * cc;
      const T* wh = p.w_h + i * 3 * cc;
      const T* bg = p.b_gru + static_cast<size_t>(i) * 4 * ch;
      for (int e = tid; e < fc; e += nt) {
        const int f = e / ch;
        const int j = e - f * ch;
        const float* xrow = xs + f * ch;
        const float* hrow = hs + f * ch;
        float axr = 0.f, axz = 0.f, axn = 0.f;
        float ahr = 0.f, ahz = 0.f, ahn = 0.f;
        for (int k = 0; k < ch; ++k) {
          const float xv = xrow[k];
          const float hv = hrow[k];
          const size_t o = static_cast<size_t>(k) * ch + j;
          axr = fmaf(xv, load_f(wx[o]), axr);
          axz = fmaf(xv, load_f(wx[cc + o]), axz);
          axn = fmaf(xv, load_f(wx[2 * cc + o]), axn);
          ahr = fmaf(hv, load_f(wh[o]), ahr);
          ahz = fmaf(hv, load_f(wh[cc + o]), ahz);
          ahn = fmaf(hv, load_f(wh[2 * cc + o]), ahn);
        }
        const float r = sigmoid_f(axr + ahr + load_f(bg[j]));
        const float z = sigmoid_f(axz + ahz + load_f(bg[ch + j]));
        const float n = tanhf(axn + load_f(bg[2 * ch + j]) +
                              r * (ahn + load_f(bg[3 * ch + j])));
        const T h_new = store_t<T>((1.0f - z) * n + z * hrow[j]);
        hn[e] = load_f(h_new);
        h_out[rows + e] = h_new;
      }
    }
    __syncthreads();

    // --- rnn_fc + residual, then the positional embedding ---
    {
      const T* w = p.w_fc + i * cc;
      const T* bias = p.b_fc + static_cast<size_t>(i) * ch;
      const T* pe = p.pe + static_cast<size_t>(i) * fc;
      for (int e = tid; e < fc; e += nt) {
        const int f = e / ch;
        const int j = e - f * ch;
        const float* a = hn + f * ch;
        float acc = 0.f;
        for (int k = 0; k < ch; ++k) {
          acc = fmaf(a[k], load_f(w[static_cast<size_t>(k) * ch + j]), acc);
        }
        const float y = round_t<T>(acc + load_f(bias[j]));
        const float xr = round_t<T>(y + xs[e]);
        xs[e] = round_t<T>(xr + load_f(pe[e]));
      }
    }
    __syncthreads();

    // --- q, k, v ---
    {
      const T* w = p.w_qkv + i * 3 * cc;
      const T* bias = p.b_qkv + static_cast<size_t>(i) * 3 * ch;
      for (int e = tid; e < fc; e += nt) {
        const int f = e / ch;
        const int j = e - f * ch;
        const float* a = xs + f * ch;
        float aq = 0.f, ak = 0.f, av = 0.f;
        for (int k = 0; k < ch; ++k) {
          const float xv = a[k];
          const size_t o = static_cast<size_t>(k) * ch + j;
          aq = fmaf(xv, load_f(w[o]), aq);
          ak = fmaf(xv, load_f(w[cc + o]), ak);
          av = fmaf(xv, load_f(w[2 * cc + o]), av);
        }
        qs[e] = round_t<T>(aq + load_f(bias[j]));
        ks[e] = round_t<T>(ak + load_f(bias[ch + j]));
        vs[e] = round_t<T>(av + load_f(bias[2 * ch + j]));
      }
    }
    __syncthreads();

    // --- logits[h, f, g] = q[f, head h] . k[g, head h] * scale ---
    for (int e = tid; e < heads * ff; e += nt) {
      const int hh = e / ff;
      const int r2 = e - hh * ff;
      const int f = r2 / freq;
      const int g = r2 - f * freq;
      const float* q = qs + f * ch + hh * d;
      const float* k = ks + g * ch + hh * d;
      float acc = 0.f;
      for (int t = 0; t < d; ++t) acc = fmaf(q[t], k[t], acc);
      ps[e] = acc * scale;
    }
    __syncthreads();

    // --- softmax over the keys of each (head, query) row ---
    for (int row = tid; row < heads * freq; row += nt) {
      float* s = ps + static_cast<size_t>(row) * freq;
      float mx = s[0];
      for (int g = 1; g < freq; ++g) mx = fmaxf(mx, s[g]);
      float den = 0.f;
      for (int g = 0; g < freq; ++g) {
        const float ev = expf(s[g] - mx);
        s[g] = ev;
        den += ev;
      }
      for (int g = 0; g < freq; ++g) s[g] = round_t<T>(s[g] / den);
    }
    __syncthreads();

    // --- attention output[f, j] = sum_g P[head(j), f, g] * v[g, j] ---
    for (int e = tid; e < fc; e += nt) {
      const int f = e / ch;
      const int j = e - f * ch;
      const float* prow = ps + (static_cast<size_t>(j / d) * freq + f) * freq;
      float acc = 0.f;
      for (int g = 0; g < freq; ++g) acc = fmaf(prow[g], vs[g * ch + j], acc);
      qs[e] = round_t<T>(acc);
    }
    __syncthreads();

    // --- attn_fc + residual ---
    {
      const T* w = p.w_afc + i * cc;
      const T* bias = p.b_afc + static_cast<size_t>(i) * ch;
      for (int e = tid; e < fc; e += nt) {
        const int f = e / ch;
        const int j = e - f * ch;
        const float* a = qs + f * ch;
        float acc = 0.f;
        for (int k = 0; k < ch; ++k) {
          acc = fmaf(a[k], load_f(w[static_cast<size_t>(k) * ch + j]), acc);
        }
        const float y = round_t<T>(acc + load_f(bias[j]));
        xs[e] = round_t<T>(y + xs[e]);
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < fc; e += nt) {
    x_out[static_cast<size_t>(b) * fc + e] = store_t<T>(xs[e]);
  }
}

size_t smem_bytes(int freq, int ch, int heads) {
  return (6 * static_cast<size_t>(freq) * ch +
          static_cast<size_t>(heads) * freq * freq) *
         sizeof(float);
}

template <typename T>
int launch(const void* x, const void* h, void* x_out, void* h_out,
           const void* w_x, const void* w_h, const void* b_gru,
           const void* w_fc, const void* b_fc, const void* w_qkv,
           const void* b_qkv, const void* w_afc, const void* b_afc,
           const void* pe, int batch, int freq, int ch, int heads,
           int nblocks, void* stream) {
  const size_t smem = smem_bytes(freq, ch, heads);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rnnformer_stack_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const Plan<T> plan{
      static_cast<const T*>(w_x),   static_cast<const T*>(w_h),
      static_cast<const T*>(b_gru), static_cast<const T*>(w_fc),
      static_cast<const T*>(b_fc),  static_cast<const T*>(w_qkv),
      static_cast<const T*>(b_qkv), static_cast<const T*>(w_afc),
      static_cast<const T*>(b_afc), static_cast<const T*>(pe)};
  const float scale = static_cast<float>(1.0 / std::sqrt(double(ch / heads)));
  rnnformer_stack_kernel<T>
      <<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(x), static_cast<const T*>(h),
          static_cast<T*>(x_out), static_cast<T*>(h_out), plan, batch, freq,
          ch, heads, nblocks, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 on success).
int rnnformer_stack_f32(const void* x, const void* h, void* x_out,
                        void* h_out, const void* w_x, const void* w_h,
                        const void* b_gru, const void* w_fc, const void* b_fc,
                        const void* w_qkv, const void* b_qkv,
                        const void* w_afc, const void* b_afc, const void* pe,
                        int batch, int freq, int ch, int heads, int nblocks,
                        void* stream) {
  return launch<float>(x, h, x_out, h_out, w_x, w_h, b_gru, w_fc, b_fc, w_qkv,
                       b_qkv, w_afc, b_afc, pe, batch, freq, ch, heads,
                       nblocks, stream);
}

int rnnformer_stack_bf16(const void* x, const void* h, void* x_out,
                         void* h_out, const void* w_x, const void* w_h,
                         const void* b_gru, const void* w_fc,
                         const void* b_fc, const void* w_qkv,
                         const void* b_qkv, const void* w_afc,
                         const void* b_afc, const void* pe, int batch,
                         int freq, int ch, int heads, int nblocks,
                         void* stream) {
  return launch<__nv_bfloat16>(x, h, x_out, h_out, w_x, w_h, b_gru, w_fc,
                               b_fc, w_qkv, b_qkv, w_afc, b_afc, pe, batch,
                               freq, ch, heads, nblocks, stream);
}

const char* rnnformer_stack_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
