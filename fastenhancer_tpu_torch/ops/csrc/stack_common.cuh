// Device code shared by the port's CUDA kernels (rnnformer_stack.cu,
// fused_frame.cu, dpt_stack.cu, bsrnn_stack.cu, dprnn_stack.cu): type
// conversion and rounding, the row-wise linear layers, the GRU step over a
// stream's rows, the H-head frequency self-attention, the ln ablation's
// LayerNorm over a stream's [F, C] tile, and the whole RNNFormer block
// stack of one stream for one frame, in its folded default form and its
// LayerNorm form.
//
// This is the scalar float32 design: every function is called by all
// threads of a thread block that owns one stream, work is spread over the
// block's threads with a stride loop (one output per thread, a float32 FMA
// chain over K with weights read from global memory), activations live in
// float32 shared memory, and each function ends with __syncthreads() where
// a later phase reads what it wrote. Results are rounded to the activation
// type T at the Pallas kernels' points, so shared memory holds float32
// copies of values that are exact in T. The float32 forms of kernels #1
// and #7 and every form of #2, #3 and #6 run on it; the bfloat16 forms of
// #1 and #7 run on the tensor cores instead (mma_common.cuh,
// stack_tc.cuh), and reuse block_sum, softmax_rows and the plans from here.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace fe {

constexpr int kThreads = 256;
// Every kernel is declared __launch_bounds__(kThreads, kMinBlocks). Without
// the minimum, ptxas built the bfloat16 block stack with 48 registers and
// spills, and it ran 1.9x slower on the H100 than with it (which allows
// 128 registers a thread: two 256-thread blocks per SM).
constexpr int kMinBlocks = 2;

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

// y[r, j] = round_T(a[r, :] . w[:, j] + bias[j]) for r < rows, j < n_out;
// a: [rows, n_in] float32 in shared memory, w: [n_in, n_out], bias: [n_out]
// (nullptr for none). With res, y[e] = round_T(that + res[e]); res may be
// y itself (each element is read before it is written). The caller
// synchronises before reading y.
template <typename T>
__device__ __forceinline__ void linear_rows(const float* a, float* y,
                                            const T* w, const T* bias,
                                            int rows, int n_in, int n_out,
                                            const float* res = nullptr) {
  for (int e = threadIdx.x; e < rows * n_out; e += blockDim.x) {
    const int r = e / n_out;
    const int j = e - r * n_out;
    const float* ar = a + r * n_in;
    float acc = bias ? load_f(bias[j]) : 0.f;
    for (int k = 0; k < n_in; ++k) {
      acc = fmaf(ar[k], load_f(w[static_cast<size_t>(k) * n_out + j]), acc);
    }
    const float v = round_t<T>(acc);
    y[e] = res ? round_t<T>(v + res[e]) : v;
  }
}

// xs[f, j] = round_T(round_T(a[f, :] . w[:, j] + bias[j]) + xs[f, j]):
// an fc with its residual, C -> C on [F, C] rows.
template <typename T>
__device__ __forceinline__ void fc_residual(const float* a, float* xs,
                                            const T* w, const T* bias,
                                            int freq, int ch) {
  for (int e = threadIdx.x; e < freq * ch; e += blockDim.x) {
    const int f = e / ch;
    const int j = e - f * ch;
    const float* ar = a + f * ch;
    float acc = 0.f;
    for (int k = 0; k < ch; ++k) {
      acc = fmaf(ar[k], load_f(w[static_cast<size_t>(k) * ch + j]), acc);
    }
    const float y = round_t<T>(acc + load_f(bias[j]));
    xs[e] = round_t<T>(y + xs[e]);
  }
}

// q, k, v = round_T(xs . w_qkv[o] + b_qkv[o]) for o = 0, 1, 2 on [F, C]
// rows; w_qkv: [3, C, C] ([in, out], column h*d + t is head h, dim t),
// b_qkv: [3, C].
template <typename T>
__device__ __forceinline__ void qkv_rows(const float* xs, float* qs,
                                         float* ks, float* vs, const T* w,
                                         const T* bias, int freq, int ch) {
  const size_t cc = static_cast<size_t>(ch) * ch;
  for (int e = threadIdx.x; e < freq * ch; e += blockDim.x) {
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

// Sum of v over the thread block (kThreads threads, every one calling),
// returned to every thread: a shuffle sum in each warp, then each thread
// adds the warps' sums from red (kThreads / 32 floats of shared memory).
// One __syncthreads(); red must not be written again until every thread
// has returned.
__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < kThreads / 32; ++w) s += red[w];
  return s;
}

// The ln ablation's post-norm and residual on one stream's [F, C] tile.
// y holds an fc's output (rounded to T, visible to all threads). Its mean
// and variance over all F*C values are taken in float32, mean first and
// then the squared differences (two passes: E[y^2] - mean^2 would lose
// digits), and
//   xs[f, j] = round_T(round_T(diff + rsqrt(var + eps) * wb[j]) + xs[f, j])
// with diff = y[f, j] - mean: the reference's affine quirk, where the
// normalized diff is never scaled and wb = weight * bias. Two
// __syncthreads(), one per reduction, each into its own half of red; the
// caller synchronises before reading xs.
template <typename T>
__device__ __forceinline__ void ln_residual(const float* y, float* xs,
                                            const T* wb, float eps, int freq,
                                            int ch) {
  __shared__ float red[2 * (kThreads / 32)];
  const int fc = freq * ch;
  float s = 0.f;
  for (int e = threadIdx.x; e < fc; e += blockDim.x) s += y[e];
  const float mean = block_sum(s, red) / static_cast<float>(fc);
  float q = 0.f;
  for (int e = threadIdx.x; e < fc; e += blockDim.x) {
    const float d = y[e] - mean;
    q = fmaf(d, d, q);
  }
  const float var = block_sum(q, red + kThreads / 32) / static_cast<float>(fc);
  const float inv = rsqrtf(var + eps);
  for (int e = threadIdx.x; e < fc; e += blockDim.x) {
    const int j = e % ch;
    const float out = round_t<T>((y[e] - mean) + inv * load_f(wb[j]));
    xs[e] = round_t<T>(out + xs[e]);
  }
}

// In place over `rows` rows of `len` float32 logits: softmax with the row's
// own max, probabilities rounded to T.
template <typename T>
__device__ __forceinline__ void softmax_rows(float* ps, int rows, int len) {
  for (int row = threadIdx.x; row < rows; row += blockDim.x) {
    float* s = ps + static_cast<size_t>(row) * len;
    float mx = s[0];
    for (int g = 1; g < len; ++g) mx = fmaxf(mx, s[g]);
    float den = 0.f;
    for (int g = 0; g < len; ++g) {
      const float ev = expf(s[g] - mx);
      s[g] = ev;
      den += ev;
    }
    for (int g = 0; g < len; ++g) s[g] = round_t<T>(s[g] / den);
  }
}

// H-head self-attention over the F frequency rows of one stream, on
// q, k, v already in shared memory ([F, C] each). The softmax is
// stabilised with each (head, query) row's own max. Leaves the attention
// output (rounded to T) in qs; ps holds [H, F, F] floats of scratch.
template <typename T>
__device__ void freq_attention(float* qs, const float* ks, const float* vs,
                               float* ps, int freq, int ch, int heads,
                               float scale) {
  const int ff = freq * freq;
  const int d = ch / heads;
  // logits[h, f, g] = q[f, head h] . k[g, head h] * scale
  for (int e = threadIdx.x; e < heads * ff; e += blockDim.x) {
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
  softmax_rows<T>(ps, heads * freq, freq);
  __syncthreads();
  // output[f, j] = sum_g P[head(j), f, g] * v[g, j]
  for (int e = threadIdx.x; e < freq * ch; e += blockDim.x) {
    const int f = e / ch;
    const int j = e - f * ch;
    const float* prow = ps + (static_cast<size_t>(j / d) * freq + f) * freq;
    float acc = 0.f;
    for (int g = 0; g < freq; ++g) acc = fmaf(prow[g], vs[g * ch + j], acc);
    qs[e] = round_t<T>(acc);
  }
  __syncthreads();
}

// One GRU step (torch gate order r, z, n) on `rows` rows of C channels:
//   r = sigmoid(x.W_xr + h.W_hr + b_r),  z = sigmoid(x.W_xz + h.W_hz + b_z)
//   n = tanh(x.W_xn + b_xn + r * (h.W_hn + b_hn)),  h' = (1 - z) n + z h
// x = xs and h = hs are [rows, C] float32 in shared memory; the weights are
// [C, C] ([in, out]) and the biases [C]. h' is rounded to T and written to
// hn (float32 copies, [rows, C]) and to row f of h_out at h_out + f*out_ld.
// The caller synchronises before reading hn.
template <typename T>
__device__ __forceinline__ void gru_rows(
    const float* xs, const float* hs, float* hn, T* h_out, size_t out_ld,
    const T* wxr, const T* wxz, const T* wxn, const T* whr, const T* whz,
    const T* whn, const T* b_r, const T* b_z, const T* b_xn, const T* b_hn,
    int rows, int ch) {
  for (int e = threadIdx.x; e < rows * ch; e += blockDim.x) {
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
      axr = fmaf(xv, load_f(wxr[o]), axr);
      axz = fmaf(xv, load_f(wxz[o]), axz);
      axn = fmaf(xv, load_f(wxn[o]), axn);
      ahr = fmaf(hv, load_f(whr[o]), ahr);
      ahz = fmaf(hv, load_f(whz[o]), ahz);
      ahn = fmaf(hv, load_f(whn[o]), ahn);
    }
    const float r = sigmoid_f(axr + ahr + load_f(b_r[j]));
    const float z = sigmoid_f(axz + ahz + load_f(b_z[j]));
    const float n =
        tanhf(axn + load_f(b_xn[j]) + r * (ahn + load_f(b_hn[j])));
    const T h_new = store_t<T>((1.0f - z) * n + z * hrow[j]);
    hn[e] = load_f(h_new);
    h_out[f * out_ld + j] = h_new;
  }
}

// Stacked plan of the folded RNNFormer blocks
// (ops/rnnformer_stack.py::plan_stack). Matrices are [in, out]; NB leads
// every array.
template <typename T>
struct StackPlan {
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

// The ln ablation's LayerNorm terms (plan_stack(..., ln_eps=...)).
template <typename T>
struct LnPlan {
  const T* wb_fc;   // [NB, C] rnn_post_norm's weight * bias
  const T* wb_afc;  // [NB, C] attn_post_norm's weight * bias
  float eps;
};

// Floats of shared memory rnnformer_stack_frame uses: six [F, C] buffers
// and the [H, F, F] logits.
__host__ __device__ inline size_t stack_smem_floats(int freq, int ch,
                                                    int heads) {
  return 6 * static_cast<size_t>(freq) * ch +
         static_cast<size_t>(heads) * freq * freq;
}

// Every RNNFormer block of one frame for stream b: the activations x
// ([F, C], float32, already in smem[0 : F*C] and visible to all threads)
// are updated in place. Per block: GRU step (torch gate order r, z, n) on
// the stream's carry rows h[i][b*F : b*F+F] -> h_out[i] (rounded to T),
// rnn_fc + residual, + pe[i], H-head frequency MHSA, attn_fc + residual.
// Each block reads all its carry rows into shared memory before it writes
// any row of h_out, so h_out == h would be safe too. With kLn (the ln
// ablation's form) each fc's output is first written out whole (the rnn_fc
// one over the carry buffer, the attn_fc one over the keys, both free by
// then), normalised by ln_residual with `ln`'s terms, and only then added
// to the residual.
template <typename T, bool kLn = false>
__device__ void rnnformer_stack_frame(float* smem, const T* h, T* h_out,
                                      const StackPlan<T>& p, int b, int batch,
                                      int freq, int ch, int heads,
                                      int nblocks, float scale,
                                      const LnPlan<T>& ln = LnPlan<T>{}) {
  const int fc = freq * ch;
  const size_t cc = static_cast<size_t>(ch) * ch;
  float* xs = smem;     // [F, C] activations
  float* hs = xs + fc;  // [F, C] carry of the current block
  float* hn = hs + fc;  // [F, C] new carry
  float* qs = hn + fc;  // [F, C] queries, then the attention output
  float* ks = qs + fc;  // [F, C] keys
  float* vs = ks + fc;  // [F, C] values
  float* ps = vs + fc;  // [H, F, F] logits, then probabilities
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  for (int i = 0; i < nblocks; ++i) {
    const size_t rows = (static_cast<size_t>(i) * batch + b) * fc;
    for (int e = tid; e < fc; e += nt) hs[e] = load_f(h[rows + e]);
    __syncthreads();

    // --- GRU step ---
    {
      const T* wx = p.w_x + i * 3 * cc;
      const T* wh = p.w_h + i * 3 * cc;
      const T* bg = p.b_gru + static_cast<size_t>(i) * 4 * ch;
      gru_rows<T>(xs, hs, hn, h_out + rows, ch, wx, wx + cc, wx + 2 * cc, wh,
                  wh + cc, wh + 2 * cc, bg, bg + ch, bg + 2 * ch, bg + 3 * ch,
                  freq, ch);
    }
    __syncthreads();

    // --- rnn_fc + residual, then the positional embedding ---
    if constexpr (kLn) {
      linear_rows<T>(hn, hs, p.w_fc + i * cc,
                     p.b_fc + static_cast<size_t>(i) * ch, freq, ch, ch);
      __syncthreads();
      ln_residual<T>(hs, xs, ln.wb_fc + static_cast<size_t>(i) * ch, ln.eps,
                     freq, ch);
    } else {
      fc_residual<T>(hn, xs, p.w_fc + i * cc,
                     p.b_fc + static_cast<size_t>(i) * ch, freq, ch);
    }
    {
      const T* pe = p.pe + static_cast<size_t>(i) * fc;
      for (int e = tid; e < fc; e += nt) xs[e] = round_t<T>(xs[e] + load_f(pe[e]));
    }
    __syncthreads();

    // --- frequency MHSA, attn_fc + residual ---
    qkv_rows<T>(xs, qs, ks, vs, p.w_qkv + i * 3 * cc,
                p.b_qkv + static_cast<size_t>(i) * 3 * ch, freq, ch);
    __syncthreads();
    freq_attention<T>(qs, ks, vs, ps, freq, ch, heads, scale);
    if constexpr (kLn) {
      linear_rows<T>(qs, ks, p.w_afc + i * cc,
                     p.b_afc + static_cast<size_t>(i) * ch, freq, ch, ch);
      __syncthreads();
      ln_residual<T>(ks, xs, ln.wb_afc + static_cast<size_t>(i) * ch, ln.eps,
                     freq, ch);
    } else {
      fc_residual<T>(qs, xs, p.w_afc + i * cc,
                     p.b_afc + static_cast<size_t>(i) * ch, freq, ch);
    }
    __syncthreads();
  }
}

}  // namespace fe
