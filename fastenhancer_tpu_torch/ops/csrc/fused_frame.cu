// FastEnhancer's whole spec->mask model for one streaming frame, as one
// CUDA kernel for Hopper (sm_90a). ops/_build.py compiles this file with
// nvcc into a shared library with a plain C interface; ops/fused_frame.py
// loads it with ctypes and launches it on PyTorch's current stream.
//
// Replaces fastenhancer_tpu/ops/fused_frame.py::fused_frame_step, the Pallas
// TPU kernel, for the folded fastenhancer.default form (SiLU, k0 = 2s, no
// post_act). For each stream, in order:
//   PreNet: 2-tap valid conv on the strided-reshaped frame [F_enc+1, 2s]
//   encoder: n_enc same-padded k-tap frequency convs (+ residual)
//   rf_pre: frequency resample F_enc -> F', 1x1 conv C -> C'
//   the RNNFormer block stack (fe::rnnformer_stack_frame, the code that
//     rnnformer_stack.cu runs)
//   rf_post: resample F' -> F_enc, 1x1 conv C' -> C (+ residual)
//   decoder: split-weight skip sum + SiLU, k-tap conv + SiLU (+ residual)
//   dec_post: split-weight skip sum + SiLU
//   ConvTranspose (stride s, k = 2s) as s phases of two taps, + bias, mask
// Sums accumulate in float32 and SiLU/sigmoid/tanh run in float32; results
// are rounded to the activation type T where the Pallas kernel rounds: each
// conv or linear output (before SiLU), each SiLU, each residual sum, the
// stack's points; the ConvTranspose output stays float32 through the mask
// and is rounded once when stored.
//
// What bounds it on the H100. At FastEnhancer_B in bf16 with B=256 streams
// one frame is about 2.1 GFLOP (the stack is 0.6 of it) over about 1.9 MB
// of inputs, carries and outputs: a few microseconds of the card at its
// peak rates. The frame is latency-bound: dozens of dependent phases, each
// a small matrix product over 24 or 64 rows. The PyTorch path around the
// stack kernel spends about 80 launches on these phases, each with its own
// host dispatch; this kernel spends one. One thread block per stream keeps
// every activation of that stream in shared memory for the whole frame
// (the input frame, the n_enc + 1 encoder skips, two work tiles and the
// stack's tiles), and nothing but the input frame, the carries and the
// mask touches device memory.
//
// Two forms. The float32 form (fused_frame_kernel<float>, the card's
// correctness reference) runs every product as a scalar float32 FMA chain,
// one output per thread, its weights read from global memory (L1/L2). The
// bfloat16 form (fused_frame_tc_kernel, the served type) runs every
// product on the tensor cores (mma.sync m16n8k16, mma_common.cuh): PreNet
// as a 2-tap product over the strided frame, each k-tap conv as k products
// over row-shifted tiles (the halo rows come from a chunk of zeros), each
// skip concat as two K segments, each frequency resample with its weight
// as a transposed A, the stack as stack_tc.cuh. Activations are bf16 tiles,
// and the frame is one run of 22 weight stages at FE_B (run_stages): each
// stage's arrays arrive by bulk copy while the stage before computes, then
// move into a slot with padded rows (91,056 bytes of shared memory a stream
// at FE_B, 2 streams per SM). Only the ConvTranspose phases (under 0.1 M
// MACs a stream) stay scalar, and the mask stays float32 until it is
// stored.
// What still bounds the bf16 form (python -m
// fastenhancer_tpu_torch.phase_profile): the chain of barrier-separated
// stages, each a few hundred cycles of ldmatrix/mma latency per output tile
// over 8 warps (about half the cycles), plus per stage the move into the
// padded slot and the start of the next stage's copies (about a third),
// and the attention. Under __launch_bounds__(256, 2) the kernel is capped
// at 128 registers and spills a little (ptxas: some 50-100 bytes stored a
// thread): the stack's code alone takes 110-128 of them. One stream per
// block: 256 streams fill 132 SMs at 2 blocks each in one wave (packing 2
// streams into a block was not tried).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <type_traits>

#include "mma_common.cuh"
#include "stack_common.cuh"
#include "stack_tc.cuh"

namespace {

using fe::kThreads;
using fe::load_f;
using fe::round_t;
using fe::sigmoid_f;
using fe::StackPlan;
using fe::store_t;

constexpr int kMaxEnc = 6;  // ops/fused_frame.py MAX_ENC

// The frame plan (ops/fused_frame.py::plan_frame): conv taps [k, Cin, Cout],
// matrices [in, out], the ConvTranspose phases [s, C, 2].
template <typename T>
struct FramePlan {
  const T* w_enc_pre;  // [2, 2s, C]
  const T* b_enc_pre;  // [C]
  const T* w_enc[kMaxEnc];
  const T* b_enc[kMaxEnc];
  const T* w_rf_pre_lin;   // [F_enc, F']
  const T* w_rf_pre;       // [C, C']
  const T* b_rf_pre;       // [C']
  const T* w_rf_post_lin;  // [F', F_enc]
  const T* w_rf_post;      // [C', C]
  const T* b_rf_post;      // [C]
  const T* w_dec_x[kMaxEnc];
  const T* w_dec_s[kMaxEnc];
  const T* b_dec_1[kMaxEnc];
  const T* w_dec_2[kMaxEnc];
  const T* b_dec_2[kMaxEnc];
  const T* w_post_x;   // [C, C]
  const T* w_post_s;   // [C, C]
  const T* b_post;     // [C]
  const T* w_convt_a;  // [s, C, 2] taps on row m
  const T* w_convt_b;  // [s, C, 2] taps on row m-1 (r < s/2) or m+1
  const T* b_convt;    // [2s]
};

struct FrameDims {
  int batch, f_enc, block_freq, ch, block_ch, heads, nblocks, stride, n_enc,
      resnet, mask;  // mask: 0 none, 1 sigmoid, 2 tanh
  int enc_ks[kMaxEnc];
};

__host__ __device__ inline int work_floats(const FrameDims& d) {
  int w = d.f_enc * d.ch;
  if (d.block_freq * d.ch > w) w = d.block_freq * d.ch;
  if (d.f_enc * d.block_ch > w) w = d.f_enc * d.block_ch;
  return w;
}

// ops/fused_frame.py::smem_bytes
size_t smem_bytes(const FrameDims& d) {
  const size_t fc = static_cast<size_t>(d.f_enc) * d.ch;
  return ((d.f_enc + 1) * 2 * static_cast<size_t>(d.stride) +
          (d.n_enc + 1) * fc + 2 * static_cast<size_t>(work_floats(d)) +
          fe::stack_smem_floats(d.block_freq, d.block_ch, d.heads)) *
         sizeof(float);
}

// SiLU at the Pallas kernel's points: the sum rounded to T, SiLU in
// float32, rounded to T
template <typename T>
__device__ __forceinline__ float silu_t(float acc) {
  const float v = round_t<T>(acc);
  return round_t<T>(v * sigmoid_f(v));
}

// out = silu_T(same-padded k-tap conv of in), [rows, C] -> [rows, C];
// with res, out = round_T(that + res) (res may be out itself)
template <typename T>
__device__ void conv_silu(const float* in, float* out, const T* w,
                          const T* bias, int k, int rows, int ch,
                          const float* res) {
  const int pad = (k - 1) / 2;
  const size_t cc = static_cast<size_t>(ch) * ch;
  for (int e = threadIdx.x; e < rows * ch; e += blockDim.x) {
    const int f = e / ch;
    const int c = e - f * ch;
    float acc = load_f(bias[c]);
    for (int j = 0; j < k; ++j) {
      const int fi = f + j - pad;
      if (fi < 0 || fi >= rows) continue;
      const float* a = in + fi * ch;
      const T* wj = w + j * cc + c;
      for (int ci = 0; ci < ch; ++ci) {
        acc = fmaf(a[ci], load_f(wj[static_cast<size_t>(ci) * ch]), acc);
      }
    }
    const float y = silu_t<T>(acc);
    out[e] = res ? round_t<T>(y + res[e]) : y;
  }
}

// out = silu_T(a @ wx + s @ ws + bias): a skip concat and a 1x1 conv as a
// split-weight sum, [rows, C] -> [rows, C]
template <typename T>
__device__ void skip_linear_silu(const float* a, const float* s, float* out,
                                 const T* wx, const T* ws, const T* bias,
                                 int rows, int ch) {
  for (int e = threadIdx.x; e < rows * ch; e += blockDim.x) {
    const int f = e / ch;
    const int c = e - f * ch;
    const float* ar = a + f * ch;
    const float* sr = s + f * ch;
    float acc = load_f(bias[c]);
    for (int k = 0; k < ch; ++k) {
      const size_t o = static_cast<size_t>(k) * ch + c;
      acc = fmaf(ar[k], load_f(wx[o]), acc);
      acc = fmaf(sr[k], load_f(ws[o]), acc);
    }
    out[e] = silu_t<T>(acc);
  }
}

// out[o, c] = round_T(sum_f in[f, c] * w[f, o]): the frequency resample,
// [f_in, ch] -> [f_out, ch]
template <typename T>
__device__ void freq_resample(const float* in, float* out, const T* w,
                              int f_in, int f_out, int ch) {
  for (int e = threadIdx.x; e < f_out * ch; e += blockDim.x) {
    const int o = e / ch;
    const int c = e - o * ch;
    float acc = 0.f;
    for (int f = 0; f < f_in; ++f) {
      acc = fmaf(in[f * ch + c], load_f(w[static_cast<size_t>(f) * f_out + o]),
                 acc);
    }
    out[e] = round_t<T>(acc);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, fe::kMinBlocks)
    fused_frame_kernel(const T* __restrict__ x, const T* h,
                       T* __restrict__ mask_out, T* h_out, FramePlan<T> p,
                       StackPlan<T> sp, FrameDims dm, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int ch = dm.ch, fe_ = dm.f_enc, s2 = 2 * dm.stride;
  const int fc = fe_ * ch;
  const int work = work_floats(dm);
  float* xin = smem;                        // [F_enc+1, 2s] input frame
  float* skips = xin + (fe_ + 1) * s2;      // n_enc+1 x [F_enc, C]
  float* buf_a = skips + (dm.n_enc + 1) * fc;
  float* buf_b = buf_a + work;
  float* st = buf_b + work;                 // the stack's buffers, xs first
  const float* no_res = nullptr;

  for (int e = tid; e < (fe_ + 1) * s2; e += nt) {
    xin[e] = load_f(x[static_cast<size_t>(b) * (fe_ + 1) * s2 + e]);
  }
  __syncthreads();

  // --- PreNet: 2-tap valid conv over the strided-reshaped frame ---
  for (int e = tid; e < fc; e += nt) {
    const int f = e / ch;
    const int c = e - f * ch;
    float acc = load_f(p.b_enc_pre[c]);
    for (int k = 0; k < s2; ++k) {
      acc = fmaf(xin[f * s2 + k], load_f(p.w_enc_pre[k * ch + c]), acc);
      acc = fmaf(xin[(f + 1) * s2 + k],
                 load_f(p.w_enc_pre[(s2 + k) * ch + c]), acc);
    }
    skips[e] = silu_t<T>(acc);
  }
  __syncthreads();

  // --- encoder convs; skips[i + 1] keeps each conv's output ---
  const float* cur = skips;
  for (int i = 0; i < dm.n_enc; ++i) {
    float* out = skips + (i + 1) * fc;
    conv_silu<T>(cur, out, p.w_enc[i], p.b_enc[i], dm.enc_ks[i], fe_, ch,
                 no_res);
    __syncthreads();
    if (dm.resnet) {
      for (int e = tid; e < fc; e += nt) buf_a[e] = round_t<T>(out[e] + cur[e]);
      __syncthreads();
      cur = buf_a;
    } else {
      cur = out;
    }
  }
  const float* x_res = cur;  // buf_a with resnet, the last skip without

  // --- rf_pre: resample F_enc -> F' into buf_b, 1x1 conv into the stack ---
  freq_resample<T>(cur, buf_b, p.w_rf_pre_lin, fe_, dm.block_freq, ch);
  __syncthreads();
  fe::linear_rows<T>(buf_b, st, p.w_rf_pre, p.b_rf_pre, dm.block_freq, ch,
                     dm.block_ch);
  __syncthreads();

  // --- the RNNFormer block stack ---
  fe::rnnformer_stack_frame<T>(st, h, h_out, sp, b, dm.batch, dm.block_freq,
                               dm.block_ch, dm.heads, dm.nblocks, scale);

  // --- rf_post: resample F' -> F_enc into buf_b, 1x1 conv into buf_a ---
  freq_resample<T>(st, buf_b, p.w_rf_post_lin, dm.block_freq, fe_,
                   dm.block_ch);
  __syncthreads();
  fe::linear_rows<T>(buf_b, buf_a, p.w_rf_post, p.b_rf_post, fe_,
                     dm.block_ch, ch, dm.resnet ? x_res : no_res);
  __syncthreads();

  // --- decoder: skip sum + SiLU into buf_b, k-tap conv + SiLU into buf_a ---
  for (int i = 0; i < dm.n_enc; ++i) {
    const float* skip = skips + (dm.n_enc - i) * fc;
    skip_linear_silu<T>(buf_a, skip, buf_b, p.w_dec_x[i], p.w_dec_s[i],
                        p.b_dec_1[i], fe_, ch);
    __syncthreads();
    conv_silu<T>(buf_b, buf_a, p.w_dec_2[i], p.b_dec_2[i],
                 dm.enc_ks[dm.n_enc - 1 - i], fe_, ch,
                 dm.resnet ? buf_a : no_res);
    __syncthreads();
  }

  // --- dec_post: skip sum (the PreNet output) + SiLU into buf_b ---
  skip_linear_silu<T>(buf_a, skips, buf_b, p.w_post_x, p.w_post_s, p.b_post,
                      fe_, ch);
  __syncthreads();

  // --- ConvTranspose phases + bias + mask: out[f, r*2 + o] ---
  const int half = dm.stride / 2;
  for (int e = tid; e < fe_ * s2; e += nt) {
    const int f = e / s2;
    const int ro = e - f * s2;
    const int r = ro / 2;
    const int o = ro - r * 2;
    const int other = r < half ? f - 1 : f + 1;
    const T* wa = p.w_convt_a + static_cast<size_t>(r) * ch * 2 + o;
    const T* wb = p.w_convt_b + static_cast<size_t>(r) * ch * 2 + o;
    const float* y = buf_b + f * ch;
    float acc = load_f(p.b_convt[ro]);
    for (int c = 0; c < ch; ++c) acc = fmaf(y[c], load_f(wa[2 * c]), acc);
    if (other >= 0 && other < fe_) {
      const float* yo = buf_b + other * ch;
      for (int c = 0; c < ch; ++c) acc = fmaf(yo[c], load_f(wb[2 * c]), acc);
    }
    if (dm.mask == 1) {
      acc = sigmoid_f(acc);
    } else if (dm.mask == 2) {
      acc = tanhf(acc);
    }
    mask_out[static_cast<size_t>(b) * fe_ * s2 + e] = store_t<T>(acc);
  }
}

// ---------------------------------------------------------------------------
// The bfloat16 form on the tensor cores (mma_common.cuh, stack_tc.cuh)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
using fe::tc::AOp;
using fe::tc::ATOp;
using fe::tc::BOp;
using fe::tc::bf;
using fe::tc::gemm;
using fe::tc::ld_of;
using fe::tc::mma_tiles;
using fe::tc::rnd;
using fe::tc::round8;
using fe::tc::silu_r;
using fe::tc::stage_rows;

// a[i] with constant indices only: a kernel parameter array indexed at run
// time is copied to local memory first, by every thread.
template <typename P>
__device__ __forceinline__ P pick(const P (&a)[kMaxEnc], int i) {
  P r = a[0];
#pragma unroll
  for (int j = 1; j < kMaxEnc; ++j) {
    if (i == j) r = a[j];
  }
  return r;
}

// Sizes, in bf16 elements, of the bf16 frame's shared memory: a chunk of
// zeros and the stages' mbarrier, the input frame, the n_enc + 1 skips
// [F_enc, C], two work tiles [max(F_enc, F'), max(C, C')], the stack's
// activations, the weight slot (padded rows) and the staging buffer
// (packed), each as large as the largest stage.
struct FrameGeom {
  int ldx, ldc, ldw, xin, skip, work, slot, staging;
  fe::tc::StackGeom st;
  explicit FrameGeom(const FrameDims& d)
      : st(d.block_freq, d.block_ch, d.heads) {
    const int c = d.ch, c2 = d.block_ch, s2 = 2 * d.stride;
    const int fe_ = d.f_enc, f2 = d.block_freq;
    const int rows_w = fe_ > f2 ? fe_ : f2;
    ldx = ld_of(s2);
    ldc = ld_of(c);
    ldw = ld_of(c > c2 ? c : c2);
    xin = (fe_ + 1) * ldx;
    skip = fe_ * ldc;
    work = rows_w * ldw;
    int kmax = 1;
    for (int i = 0; i < d.n_enc; ++i) {
      kmax = d.enc_ks[i] > kmax ? d.enc_ks[i] : kmax;
    }
    const int b = round8(c);
    const int slots[] = {
        st.slot(),
        2 * s2 * ldc + b,                                    // PreNet
        kmax * c * ldc + b,                                  // k-tap convs
        fe_ * ld_of(f2) + c * ld_of(c2) + round8(c2),        // rf_pre
        f2 * ld_of(fe_) + c2 * ldc + b,                      // rf_post
        2 * c * ldc + b};                                    // skip sums
    const int packed[] = {
        st.staging(),
        round8(2 * s2 * c) + b,
        round8(kmax * c * c) + b,
        round8(fe_ * f2) + round8(c * c2) + round8(c2),
        round8(f2 * fe_) + round8(c2 * c) + b,
        2 * round8(c * c) + b};
    slot = staging = 0;
    for (int v : slots) slot = v > slot ? v : slot;
    for (int v : packed) staging = v > staging ? v : staging;
  }
  size_t elems(int n_enc) const {
    return 16 + static_cast<size_t>(xin) +
           (n_enc + 1) * static_cast<size_t>(skip) +
           2 * static_cast<size_t>(work) + static_cast<size_t>(st.act()) +
           slot + staging;
  }
};

// The frame as fused_frame_kernel computes it, with every product on the
// tensor cores, as one run of weight stages (PreNet, the n_enc encoder
// convs, rf_pre, the stack's 4 * NB, rf_post, per decoder unit its skip sum
// and its conv, dec_post; run_stages inlines each piece of code once). The
// ConvTranspose phases stay scalar.
__global__ void __launch_bounds__(kThreads, fe::kMinBlocks)
    fused_frame_tc_kernel(const bf16* __restrict__ x, const bf16* h,
                          bf16* __restrict__ mask_out, bf16* h_out,
                          FramePlan<bf16> p, StackPlan<bf16> sp, FrameDims dm,
                          FrameGeom geo, float scale) {
  extern __shared__ __align__(16) unsigned char smem_tc[];
  const int b = blockIdx.x;
  const int c = dm.ch, c2 = dm.block_ch, fe_ = dm.f_enc, f2 = dm.block_freq;
  const int s2 = 2 * dm.stride, n_enc = dm.n_enc;
  const int ldc = geo.ldc, ldw = geo.ldw;
  const fe::tc::StackGeom& g = geo.st;
  bf16* zero = reinterpret_cast<bf16*>(smem_tc);
  auto* bar = reinterpret_cast<uint64_t*>(smem_tc + 16);
  bf16* xin = zero + 16;                  // [F_enc+1, 2s]
  bf16* skips = xin + geo.xin;            // n_enc+1 x [F_enc, C]
  bf16* buf_a = skips + (n_enc + 1) * geo.skip;
  bf16* buf_b = buf_a + geo.work;
  bf16* st = buf_b + geo.work;            // the stack's tiles, x first
  bf16* slot = st + g.act();
  bf16* staging = slot + geo.slot;
  if (threadIdx.x < 8) zero[threadIdx.x] = __float2bfloat16_rn(0.f);
  fe::tc::stack_init(st, g);
  if (threadIdx.x == 0) {
    fe::tc::mbar_init(bar);
    fe::tc::mbar_fence_init();
  }
  __syncthreads();

  const int s_stack = n_enc + 2;               // first stage of the stack
  const int s_post = s_stack + 4 * dm.nblocks;  // rf_post
  const int stages = s_post + 2 + 2 * n_enc;
  const auto pieces = [&](int s, auto& v) {
    if (s == 0) {
      v.mat(p.w_enc_pre, 2 * s2, c);
      v.vec(p.b_enc_pre, c);
    } else if (s <= n_enc) {
      v.mat(pick(p.w_enc, s - 1), pick(dm.enc_ks, s - 1) * c, c);
      v.vec(pick(p.b_enc, s - 1), c);
    } else if (s == n_enc + 1) {
      v.mat(p.w_rf_pre_lin, fe_, f2);
      v.mat(p.w_rf_pre, c, c2);
      v.vec(p.b_rf_pre, c2);
    } else if (s < s_post) {
      fe::tc::stack_pieces(s - s_stack, v, sp, nullptr, nullptr, g);
    } else if (s == s_post) {
      v.mat(p.w_rf_post_lin, f2, fe_);
      v.mat(p.w_rf_post, c2, c);
      v.vec(p.b_rf_post, c);
    } else {
      const int u = s - s_post - 1;  // 2i: skip sum i, 2i+1: conv i
      const int i = u >> 1;
      if (i == n_enc) {
        v.mat(p.w_post_x, c, c);
        v.mat(p.w_post_s, c, c);
        v.vec(p.b_post, c);
      } else if ((u & 1) == 0) {
        v.mat(pick(p.w_dec_x, i), c, c);
        v.mat(pick(p.w_dec_s, i), c, c);
        v.vec(pick(p.b_dec_1, i), c);
      } else {
        v.mat(pick(p.w_dec_2, i), pick(dm.enc_ks, n_enc - 1 - i) * c, c);
        v.vec(pick(p.b_dec_2, i), c);
      }
    }
  };
  const auto side = [&](int s) {
    if (s == 0) {
      stage_rows(xin, geo.ldx, x + static_cast<size_t>(b) * (fe_ + 1) * s2,
                 fe_ + 1, s2);
    } else if (s >= s_stack && s < s_post) {
      fe::tc::stack_side(s - s_stack, h, st + g.tile(), b, dm.batch, g);
    }
  };

  // out = silu(k-tap same-padded conv of `in` ([F_enc, C], stride ld_in)
  // with the taps in slot w); with res, round(that + out) (in place)
  const auto conv = [&](const bf16* in, int ld_in, const bf16* w, int k,
                        bf16* out, int ld_out, bool res) {
    const int pad = (k - 1) / 2;
    const bf16* bias = w + k * c * ldc;
    gemm(
        1, fe_, c,
        [&](int, float (&acc)[fe::tc::kMaxNT][4], int m0,
              int n0, int cnt) {
          for (int j = 0; j < k; ++j) {
            mma_tiles(acc, AOp{in, ld_in, fe_, c, j - pad},
                     BOp{w + j * c * ldc, ldc, c}, m0, n0, cnt, zero);
          }
        },
        [&](int, int r, int j, float v) {
          const float y = silu_r(v + bf(bias[j]));
          bf16& o = out[r * ld_out + j];
          o = __float2bfloat16_rn(res ? y + bf(o) : y);
        });
  };
  // out = silu(a . W_x + s . W_s + b): a skip concat and a 1x1 conv
  const auto skip_sum = [&](const bf16* a, int ld_a, const bf16* s,
                            const bf16* w, bf16* out) {
    const bf16* bias = w + 2 * c * ldc;
    gemm(
        1, fe_, c,
        [&](int, float (&acc)[fe::tc::kMaxNT][4], int m0,
              int n0, int cnt) {
          mma_tiles(acc, AOp{a, ld_a, fe_, c, 0}, BOp{w, ldc, c}, m0, n0, cnt,
                   zero);
          mma_tiles(acc, AOp{s, ldc, fe_, c, 0}, BOp{w + c * ldc, ldc, c}, m0,
                   n0, cnt, zero);
        },
        [&](int, int r, int j, float v) {
          out[r * ldw + j] = __float2bfloat16_rn(silu_r(v + bf(bias[j])));
        });
  };

  const bf16* cur = skips;  // the encoder's running output
  int ld_cur = ldc;
  const auto compute = [&](int s, const bf16* w) {
    if (s == 0) {
      // --- PreNet: 2-tap valid conv over the strided-reshaped frame ---
      const bf16* bias = w + 2 * s2 * ldc;
      gemm(
          1, fe_, c,
          [&](int, float (&acc)[fe::tc::kMaxNT][4], int m0,
              int n0, int cnt) {
            for (int j = 0; j < 2; ++j) {
              mma_tiles(acc, AOp{xin, geo.ldx, fe_ + 1, s2, j},
                       BOp{w + j * s2 * ldc, ldc, s2}, m0, n0, cnt, zero);
            }
          },
          [&](int, int r, int j, float v) {
            skips[r * ldc + j] = __float2bfloat16_rn(silu_r(v + bf(bias[j])));
          });
    } else if (s <= n_enc) {
      // --- encoder conv s-1 into skips[s] (+ the residual into buf_a) ---
      bf16* out = skips + s * geo.skip;
      conv(cur, ld_cur, w, pick(dm.enc_ks, s - 1), out, ldc, false);
      if (dm.resnet) {
        __syncthreads();
        for (int e = threadIdx.x; e < fe_ * c; e += blockDim.x) {
          const int r = e / c, j = e - r * c;
          buf_a[r * ldw + j] = __float2bfloat16_rn(
              bf(out[r * ldc + j]) + bf(cur[r * ld_cur + j]));
        }
        cur = buf_a;
        ld_cur = ldw;
      } else {
        cur = out;
      }
    } else if (s == n_enc + 1) {
      // --- rf_pre: resample F_enc -> F' into buf_b, 1x1 conv into x ---
      const bf16* wc = w + fe_ * ld_of(f2);
      const bf16* bias = wc + c * g.ldc;
      gemm(
          1, f2, c,
          [&](int, float (&acc)[fe::tc::kMaxNT][4], int m0,
              int n0, int cnt) {
            mma_tiles(acc, ATOp{w, ld_of(f2), f2, fe_}, BOp{cur, ld_cur, fe_},
                     m0, n0, cnt, zero);
          },
          [&](int, int r, int j, float v) {
            buf_b[r * ldw + j] = __float2bfloat16_rn(v);
          });
      __syncthreads();
      gemm(
          1, f2, c2,
          [&](int, float (&acc)[fe::tc::kMaxNT][4], int m0,
              int n0, int cnt) {
            mma_tiles(acc, AOp{buf_b, ldw, f2, c, 0}, BOp{wc, g.ldc, c}, m0,
                     n0, cnt, zero);
          },
          [&](int, int r, int j, float v) {
            st[r * g.ldc + j] = __float2bfloat16_rn(v + bf(bias[j]));
          });
    } else if (s < s_post) {
      fe::tc::stack_stage<false>(s - s_stack, w, st, h_out, b, dm.batch, g,
                                 0.f, zero);
    } else if (s == s_post) {
      // --- rf_post: resample F' -> F_enc into buf_b, 1x1 conv into buf_a;
      // with resnet the residual is buf_a itself (the encoder's last sum)
      const bf16* wc = w + f2 * ld_of(fe_);
      const bf16* bias = wc + c2 * ldc;
      gemm(
          1, fe_, c2,
          [&](int, float (&acc)[fe::tc::kMaxNT][4], int m0,
              int n0, int cnt) {
            mma_tiles(acc, ATOp{w, ld_of(fe_), fe_, f2}, BOp{st, g.ldc, f2},
                     m0, n0, cnt, zero);
          },
          [&](int, int r, int j, float v) {
            buf_b[r * ldw + j] = __float2bfloat16_rn(v);
          });
      __syncthreads();
      gemm(
          1, fe_, c,
          [&](int, float (&acc)[fe::tc::kMaxNT][4], int m0,
              int n0, int cnt) {
            mma_tiles(acc, AOp{buf_b, ldw, fe_, c2, 0}, BOp{wc, ldc, c2}, m0,
                     n0, cnt, zero);
          },
          [&](int, int r, int j, float v) {
            const float y = rnd(v + bf(bias[j]));
            buf_a[r * ldw + j] = __float2bfloat16_rn(
                dm.resnet ? y + bf(buf_a[r * ldw + j]) : y);
          });
    } else {
      const int u = s - s_post - 1;
      const int i = u >> 1;
      if (i == n_enc) {
        // --- dec_post: skip sum (the PreNet output) + SiLU into buf_b ---
        skip_sum(buf_a, ldw, skips, w, buf_b);
      } else if ((u & 1) == 0) {
        // --- decoder unit i: skip sum + SiLU into buf_b ---
        skip_sum(buf_a, ldw, skips + (n_enc - i) * geo.skip, w, buf_b);
      } else {
        // --- then its k-tap conv + SiLU into buf_a ---
        conv(buf_b, ldw, w, pick(dm.enc_ks, n_enc - 1 - i), buf_a, ldw,
             dm.resnet != 0);
      }
    }
  };
  fe::tc::run_stages(
      stages, staging, slot, bar, pieces, side,
      [&](int s) {
        if (s >= s_stack && s < s_post) {
          fe::tc::stack_pre_stage(s - s_stack, st, g, scale, zero);
        }
      },
      compute);

  // --- ConvTranspose phases + bias + mask: out[f, r*2 + o] ---
  const int half = dm.stride / 2;
  for (int e = threadIdx.x; e < fe_ * s2; e += blockDim.x) {
    const int f = e / s2;
    const int ro = e - f * s2;
    const int r = ro / 2;
    const int o = ro - r * 2;
    const int other = r < half ? f - 1 : f + 1;
    const bf16* wa = p.w_convt_a + static_cast<size_t>(r) * c * 2 + o;
    const bf16* wb = p.w_convt_b + static_cast<size_t>(r) * c * 2 + o;
    const bf16* y = buf_b + f * ldw;
    float acc = bf(p.b_convt[ro]);
    for (int j = 0; j < c; ++j) acc = fmaf(bf(y[j]), bf(wa[2 * j]), acc);
    if (other >= 0 && other < fe_) {
      const bf16* yo = buf_b + other * ldw;
      for (int j = 0; j < c; ++j) acc = fmaf(bf(yo[j]), bf(wb[2 * j]), acc);
    }
    if (dm.mask == 1) {
      acc = sigmoid_f(acc);
    } else if (dm.mask == 2) {
      acc = tanhf(acc);
    }
    mask_out[static_cast<size_t>(b) * fe_ * s2 + e] = __float2bfloat16_rn(acc);
  }
}

// The size table (see the entries below) into dm; false if it cannot be
// read.
bool read_dims(const int* dims, int n_dims, FrameDims& dm) {
  if (n_dims < 11) return false;
  dm.batch = dims[0];
  dm.f_enc = dims[1];
  dm.block_freq = dims[2];
  dm.ch = dims[3];
  dm.block_ch = dims[4];
  dm.heads = dims[5];
  dm.nblocks = dims[6];
  dm.stride = dims[7];
  dm.n_enc = dims[8];
  dm.resnet = dims[9];
  dm.mask = dims[10];
  const int n = dm.n_enc;
  if (n < 0 || n > kMaxEnc || n_dims != 11 + n) return false;
  for (int i = 0; i < n; ++i) dm.enc_ks[i] = dims[11 + i];
  return true;
}

template <typename T>
int launch(const void* x, const void* h, void* mask_out, void* h_out,
           const void* const* frame, int n_frame, const void* const* stack,
           const int* dims, int n_dims, void* stream) {
  FrameDims dm{};
  if (!read_dims(dims, n_dims, dm) || n_frame != 14 + 7 * dm.n_enc) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n = dm.n_enc;

  // the pointer table in ops/fused_frame.py::frame_plan_keys order
  FramePlan<T> p{};
  auto next = [&frame](int& k) { return static_cast<const T*>(frame[k++]); };
  int k = 0;
  p.w_enc_pre = next(k);
  p.b_enc_pre = next(k);
  for (int i = 0; i < n; ++i) {
    p.w_enc[i] = next(k);
    p.b_enc[i] = next(k);
  }
  p.w_rf_pre_lin = next(k);
  p.w_rf_pre = next(k);
  p.b_rf_pre = next(k);
  p.w_rf_post_lin = next(k);
  p.w_rf_post = next(k);
  p.b_rf_post = next(k);
  for (int i = 0; i < n; ++i) {
    p.w_dec_x[i] = next(k);
    p.w_dec_s[i] = next(k);
    p.b_dec_1[i] = next(k);
    p.w_dec_2[i] = next(k);
    p.b_dec_2[i] = next(k);
  }
  p.w_post_x = next(k);
  p.w_post_s = next(k);
  p.b_post = next(k);
  p.w_convt_a = next(k);
  p.w_convt_b = next(k);
  p.b_convt = next(k);

  const StackPlan<T> sp{
      static_cast<const T*>(stack[0]), static_cast<const T*>(stack[1]),
      static_cast<const T*>(stack[2]), static_cast<const T*>(stack[3]),
      static_cast<const T*>(stack[4]), static_cast<const T*>(stack[5]),
      static_cast<const T*>(stack[6]), static_cast<const T*>(stack[7]),
      static_cast<const T*>(stack[8]), static_cast<const T*>(stack[9])};

  constexpr bool kTc = std::is_same_v<T, bf16>;
  const FrameGeom geo(dm);
  const size_t smem = kTc ? geo.elems(dm.n_enc) * sizeof(bf16)
                          : smem_bytes(dm);
  const void* kernel;
  if constexpr (kTc) {
    kernel = reinterpret_cast<const void*>(fused_frame_tc_kernel);
  } else {
    kernel = reinterpret_cast<const void*>(fused_frame_kernel<T>);
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const float scale =
      static_cast<float>(1.0 / std::sqrt(double(dm.block_ch / dm.heads)));
  const auto st = static_cast<cudaStream_t>(stream);
  if constexpr (kTc) {
    fused_frame_tc_kernel<<<dm.batch, kThreads, smem, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(h),
        static_cast<T*>(mask_out), static_cast<T*>(h_out), p, sp, dm, geo,
        scale);
  } else {
    fused_frame_kernel<T><<<dm.batch, kThreads, smem, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(h),
        static_cast<T*>(mask_out), static_cast<T*>(h_out), p, sp, dm, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 on success), or
// cudaErrorInvalidValue for size tables it cannot read. frame: the frame
// plan's pointers (ops/fused_frame.py::frame_plan_keys order); stack: the
// block-stack plan's ten pointers (ops/rnnformer_stack.py PLAN_KEYS);
// dims: batch, F_enc, F', C, C', H, NB, stride, n_enc, resnet, mask kind,
// then the n_enc encoder kernel sizes.
int fused_frame_f32(const void* x, const void* h, void* mask_out,
                    void* h_out, const void* const* frame, int n_frame,
                    const void* const* stack, const int* dims, int n_dims,
                    void* stream) {
  return launch<float>(x, h, mask_out, h_out, frame, n_frame, stack, dims,
                       n_dims, stream);
}

int fused_frame_bf16(const void* x, const void* h, void* mask_out,
                     void* h_out, const void* const* frame, int n_frame,
                     const void* const* stack, const int* dims, int n_dims,
                     void* stream) {
  return launch<__nv_bfloat16>(x, h, mask_out, h_out, frame, n_frame, stack,
                               dims, n_dims, stream);
}

// Bytes of dynamic shared memory one thread block (one stream) of the
// bfloat16 form needs for this size table (0 if it cannot be read); the
// wrapper checks it against the card's limit.
size_t fused_frame_smem_bf16(const int* dims, int n_dims) {
  FrameDims dm{};
  if (!read_dims(dims, n_dims, dm)) return 0;
  return FrameGeom(dm).elems(dm.n_enc) * sizeof(bf16);
}

const char* fused_frame_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
