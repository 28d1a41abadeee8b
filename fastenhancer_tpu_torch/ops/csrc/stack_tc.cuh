// The RNNFormer block stack of one stream for one frame in bfloat16, on the
// tensor cores (mma_common.cuh): the bf16 form of
// fe::rnnformer_stack_frame (stack_common.cuh), which the float32 forms of
// rnnformer_stack.cu and fused_frame.cu keep. Same math, same rounding
// points:
//   - GRU: x.W_x and h.W_h as six products per output tile into four
//     register accumulators (x.W_xr + h.W_hr and x.W_xz + h.W_hz summed in
//     one each, the n gate's two apart), the gates in float32 on the
//     un-rounded sums, h' rounded to bf16;
//   - rnn_fc: round(acc + b), round(+ residual), round(+ pe) in the
//     epilogue; the LN form writes round(acc + b) whole and normalises it
//     (ln_residual_tc) before the residual;
//   - q, k, v: round(acc + b), three products, written head-padded;
//   - attention: per head, q.k^T and P.v on the tensor cores, the softmax
//     with each row's own max in float32 registers, P rounded to bf16;
//   - attn_fc: as rnn_fc without pe.
// Activations are bf16 tiles in shared memory (values are exact in bf16 at
// every rounding point). The weights come through the caller's
// run_stages, four stages a block (stack stage j = 4 i + phase): GRU (w_x,
// w_h, b_gru; the block's carry rows into h), rnn_fc (w_fc, b_fc, pe,
// wb_fc), qkv (w_qkv, b_qkv), attn_fc (w_afc, b_afc, wb_afc). gru_tc,
// fc_residual_tc, qkv_tc and attention_tc are also the dprnn and dpt
// stacks' stages (dprnn_tc.cuh, dpt_tc.cuh).
#pragma once

#include "mma_common.cuh"

namespace fe {
namespace tc {

// Sizes, in bf16 elements, of the bf16 stack's shared memory pieces. q, k
// and v are head-padded: head h's d columns start at h * dp, dp = d rounded
// up to 16, so each head is 16-byte aligned for ldmatrix.
struct StackGeom {
  int f, c, heads, d, dp, ldc, ldq, ldp;
  unsigned dmag;  // j / d == (j * dmag) >> 20 for the j < C of a row
  __host__ __device__ StackGeom(int freq, int ch, int h)
      : f(freq), c(ch), heads(h), d(ch / h), dp((ch / h + 15) & ~15),
        ldc(ld_of(ch)), ldq(ld_of(h * ((ch / h + 15) & ~15))),
        ldp(ld_of(freq)), dmag((1u << 20) / (ch / h) + 1) {}
  // one [C, C] weight in the slot (padded rows)
  __host__ __device__ int mat() const { return c * ldc; }
  // one [F, C] activation tile
  __host__ __device__ int tile() const { return f * ldc; }
  // one head-padded [F, H * dp] q, k or v tile
  __host__ __device__ int qkv() const { return f * ldq; }
  // the activation region: x, h, h' tiles, q, k, v, and the [H, F, F]
  // probabilities
  __host__ __device__ int act() const {
    return 3 * tile() + 3 * qkv() + heads * f * ldp;
  }
  // the largest stage in the slot: the GRU's w_x, w_h and b_gru, or
  // rnn_fc's w_fc, b_fc, pe and wb_fc (qkv and attn_fc are smaller)
  __host__ __device__ int slot() const {
    const int gru = 6 * mat() + round8(4 * c);
    const int fc = mat() + 2 * round8(c) + round8(f * c);
    return gru > fc ? gru : fc;
  }
  // the same stages packed in the staging buffer
  __host__ __device__ int staging() const {
    const int gru = 2 * round8(3 * c * c) + round8(4 * c);
    const int fc = round8(c * c) + 2 * round8(c) + round8(f * c);
    return gru > fc ? gru : fc;
  }
};

struct StackTiles {
  bf16 *xs, *hs, *hn, *qs, *ks, *vs, *ps;
  __device__ __forceinline__ StackTiles(bf16* act, const StackGeom& g)
      : xs(act), hs(act + g.tile()), hn(act + 2 * g.tile()),
        qs(act + 3 * g.tile()), ks(qs + g.qkv()), vs(ks + g.qkv()),
        ps(vs + g.qkv()) {}
};

// The arrays of stack stage j (block j / 4; GRU, rnn_fc, qkv, attn_fc) to
// the visitor v (LoadV, MoveV), in slot order. wb_fc / wb_afc are null for
// the default form.
template <class V>
__device__ __forceinline__ void stack_pieces(int j, V& v,
                                             const StackPlan<bf16>& p,
                                             const bf16* wb_fc,
                                             const bf16* wb_afc,
                                             const StackGeom& g) {
  const size_t i = j >> 2;
  const int c = g.c;
  const size_t cc = static_cast<size_t>(c) * c;
  switch (j & 3) {
    case 0:
      v.mat(p.w_x + i * 3 * cc, 3 * c, c);
      v.mat(p.w_h + i * 3 * cc, 3 * c, c);
      v.vec(p.b_gru + i * 4 * c, 4 * c);
      break;
    case 1:
      v.mat(p.w_fc + i * cc, c, c);
      v.vec(p.b_fc + i * c, c);
      v.vec(p.pe + i * g.f * c, g.f * c);
      if (wb_fc) v.vec(wb_fc + i * c, c);
      break;
    case 2:
      v.mat(p.w_qkv + i * 3 * cc, 3 * c, c);
      v.vec(p.b_qkv + i * 3 * c, 3 * c);
      break;
    default:
      v.mat(p.w_afc + i * cc, c, c);
      v.vec(p.b_afc + i * c, c);
      if (wb_afc) v.vec(wb_afc + i * c, c);
  }
}

// The activations stack stage j needs copied in besides its weights: the
// GRU stage's carry rows of stream b into hs (h: [NB, B*F, C]).
__device__ __forceinline__ void stack_side(int j, const bf16* h, bf16* hs,
                                           int b, int batch,
                                           const StackGeom& g) {
  if ((j & 3) == 0) {
    const size_t i = j >> 2;
    stage_rows(hs, g.ldc, h + (i * batch + b) * g.f * g.c, g.f, g.c);
  }
}

// fn(r, j, e) for each element e = r * c + j of an [f, c] tile, spread
// over the block's threads (r, j stepped without a division per element)
template <class Fn>
__device__ __forceinline__ void for_tile(int f, int c, const Fn& fn) {
  const int dr = kThreads / c, dc = kThreads - dr * c;
  int r = threadIdx.x / c;
  int j = threadIdx.x - r * c;
  for (; r < f; r += dr) {
    fn(r, j, r * c + j);
    j += dc;
    if (j >= c) {
      j -= c;
      ++r;
    }
  }
}

// One GRU step on the stream's F rows: w is the GRU stage's slot (w_x and
// w_h as 3C padded rows each, then b_r, b_z, b_xn, b_hn, each bias_ld
// apart; 0 is C, packed). h' goes to hn and to the carry rows h_out, row r
// at h_out + r * out_ld (0 is C, contiguous). The caller synchronises.
__device__ __forceinline__ void gru_tc(const bf16* xs, const bf16* hs,
                                       bf16* hn, bf16* h_out, const bf16* w,
                                       const StackGeom& g, const bf16* zero,
                                       size_t out_ld = 0, int bias_ld = 0) {
  const int f = g.f, c = g.c, ld = g.ldc, mat = g.mat();
  const bf16* wh = w + 3 * mat;
  const bf16* bias = wh + 3 * mat;
  if (out_ld == 0) out_ld = c;
  if (bias_ld == 0) bias_ld = c;
  const AOp ax{xs, ld, f, c, 0};
  const AOp ah{hs, ld, f, c, 0};
  const BOp wr{w, ld, c}, wz{w + mat, ld, c}, wn{w + 2 * mat, ld, c};
  const BOp hr{wh, ld, c}, hz{wh + mat, ld, c}, hnw{wh + 2 * mat, ld, c};
  const uint32_t z = smem_u32(zero);
  const int lane = threadIdx.x & 31;
  const int nt = (c + 7) / 8;
  const int tiles = (f + 15) / 16 * nt;
  for (int t = threadIdx.x >> 5; t < tiles; t += kWarps) {
    const int m0 = t / nt * 16;
    const int n0 = (t % nt) * 8;
    // x.W_xr + h.W_hr and x.W_xz + h.W_hz each in one accumulator; the n
    // gate's two products apart (r scales h.W_hn + b_hn alone)
    float acc_r[4] = {}, acc_z[4] = {}, acc_xn[4] = {}, acc_hn[4] = {};
    for (int k0 = 0; k0 < c; k0 += 16) {
      uint32_t fx[4], fh[4], fb[2];
      ax.load(fx, m0, k0, z);
      ah.load(fh, m0, k0, z);
      wr.load(fb, k0, n0, z);
      mma_bf16(acc_r, fx, fb);
      hr.load(fb, k0, n0, z);
      mma_bf16(acc_r, fh, fb);
      wz.load(fb, k0, n0, z);
      mma_bf16(acc_z, fx, fb);
      hz.load(fb, k0, n0, z);
      mma_bf16(acc_z, fh, fb);
      wn.load(fb, k0, n0, z);
      mma_bf16(acc_xn, fx, fb);
      hnw.load(fb, k0, n0, z);
      mma_bf16(acc_hn, fh, fb);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = m0 + (lane >> 2) + (e >> 1) * 8;
      const int j = n0 + 2 * (lane & 3) + (e & 1);
      if (r >= f || j >= c) continue;
      const float rg = sigmoid_f(acc_r[e] + bf(bias[j]));
      const float zg = sigmoid_f(acc_z[e] + bf(bias[bias_ld + j]));
      const float ng = tanhf(acc_xn[e] + bf(bias[2 * bias_ld + j]) +
                             rg * (acc_hn[e] + bf(bias[3 * bias_ld + j])));
      const bf16 hv =
          __float2bfloat16_rn((1.0f - zg) * ng + zg * bf(hs[r * ld + j]));
      hn[r * ld + j] = hv;
      h_out[r * out_ld + j] = hv;
    }
  }
}

// An fc with its residual on the stream's F rows: xs = round(round(a . w +
// bias) + xs), then with kPe xs = round(xs + pe). a: [F, k] (stride lda),
// w: [k, C] from a slot (stride ldc), bias [C], pe [F, C] contiguous. The
// caller synchronises.
template <bool kPe>
__device__ __forceinline__ void fc_residual_tc(const bf16* a, int lda, int k,
                                               bf16* xs, const bf16* w,
                                               const bf16* bias,
                                               const bf16* pe,
                                               const StackGeom& g,
                                               const bf16* zero) {
  const int f = g.f, c = g.c, ld = g.ldc;
  const BOp wf{w, ld, k};
  gemm(
      1, f, c,
      [&](int, float (&acc)[kMaxNT][4], int m0, int n0, int cnt) {
        mma_tiles(acc, AOp{a, lda, f, k, 0}, wf, m0, n0, cnt, zero);
      },
      [&](int, int r, int jj, float v) {
        const float y = rnd(v + bf(bias[jj]));
        if constexpr (kPe) {
          const float x1 = rnd(y + bf(xs[r * ld + jj]));
          xs[r * ld + jj] = __float2bfloat16_rn(x1 + bf(pe[r * c + jj]));
        } else {
          xs[r * ld + jj] = __float2bfloat16_rn(y + bf(xs[r * ld + jj]));
        }
      });
}

// q, k, v = round(xs . w_o + b_o) for o = 0, 1, 2, written head-padded to
// t.qs, t.ks, t.vs; w: a qkv stage's slot (3C padded rows, then the 3C
// biases). The caller synchronises.
__device__ __forceinline__ void qkv_tc(const StackTiles& t, const bf16* w,
                                       const StackGeom& g, const bf16* zero) {
  const int f = g.f, c = g.c, ld = g.ldc;
  const bf16* bias = w + 3 * g.mat();
  gemm(
      3, f, c,
      [&](int q, float (&acc)[kMaxNT][4], int m0, int n0, int cnt) {
        mma_tiles(acc, AOp{t.xs, ld, f, c, 0}, BOp{w + q * g.mat(), ld, c},
                  m0, n0, cnt, zero);
      },
      [&](int q, int r, int jj, float v) {
        bf16* out = q == 0 ? t.qs : (q == 1 ? t.ks : t.vs);
        const int hh = static_cast<int>((jj * g.dmag) >> 20);
        out[r * g.ldq + hh * g.dp + (jj - hh * g.d)] =
            __float2bfloat16_rn(v + bf(bias[q * c + jj]));
      });
}

// fe::ln_residual on bf16 tiles: y ([F, ld], an fc output rounded to bf16)
// normalised over its F x C values (mean, then squared differences, in
// float32), xs = round(round(diff + rsqrt(var + eps) * wb) + xs), then
// xs = round(xs + pe) where pe ([F, C] contiguous) is given. Two
// __syncthreads(); the caller synchronises before reading xs.
__device__ __forceinline__ void ln_residual_tc(const bf16* y, bf16* xs,
                                               const bf16* wb,
                                               const bf16* pe, float eps,
                                               const StackGeom& g) {
  __shared__ float red[2 * kWarps];
  const int c = g.c, ld = g.ldc, n = g.f * c;
  float s = 0.f;
  for_tile(g.f, c, [&](int r, int j, int) { s += bf(y[r * ld + j]); });
  const float mean = block_sum(s, red) / static_cast<float>(n);
  float q = 0.f;
  for_tile(g.f, c, [&](int r, int j, int) {
    const float d = bf(y[r * ld + j]) - mean;
    q = fmaf(d, d, q);
  });
  const float inv = rsqrtf(block_sum(q, red + kWarps) /
                           static_cast<float>(n) + eps);
  for_tile(g.f, c, [&](int r, int j, int e) {
    const int o = r * ld + j;
    const float out = rnd((bf(y[o]) - mean) + inv * bf(wb[j]));
    float v = rnd(out + bf(xs[o]));
    if (pe) v = rnd(v + bf(pe[e]));
    xs[o] = __float2bfloat16_rn(v);
  });
}

// Key tiles (8 keys each) a row's softmax keeps in registers in one pass;
// wider rows take three passes that recompute the logits.
constexpr int kKeyRegTiles = 4;

// H-head self-attention over the F rows on the tensor cores. qs, ks, vs
// are head-padded ([F, ldq], the columns past d of each head zero in ks);
// the output, rounded, goes to out ([F, C], stride ldc, the real layout).
// One warp per (head, 16 query rows) takes the softmax of each row with its
// own max over the 4 lanes that hold it (two shuffles): with F <= 8 *
// kKeyRegTiles, q_h . k_h^T of every key tile into registers once; else in
// three passes over the key tiles, each recomputing one tile's logits (the
// max, then the sum of exp(s - max), then the probabilities). The
// probabilities, rounded to bf16, go to ps ([H, F, ldp]); then P_h . v_h
// as a product. Ends after its last pass without a barrier (the caller's
// next acquire has one).
__device__ __forceinline__ void attention_tc(const bf16* qs, const bf16* ks,
                                             const bf16* vs, bf16* ps,
                                             bf16* out, const StackGeom& g,
                                             float scale, const bf16* zero) {
  const int f = g.f;
  const int lane = threadIdx.x & 31;
  const int mt = (f + 15) / 16;
  const int nt = (f + 7) / 8;
  for (int t = threadIdx.x >> 5; t < g.heads * mt; t += kWarps) {
    const int hh = t / mt;
    const int m0 = (t - hh * mt) * 16;
    const AOp a{qs + hh * g.dp, g.ldq, f, g.d, 0};
    const BTOp bk{ks + hh * g.dp, g.ldq, f, g.d};
    // the scaled logits of key tile n: rows lane/4 (0, 1), lane/4 + 8 (2, 3)
    const uint32_t z = smem_u32(zero);
    const auto logits = [&](int n, float (&s)[4]) {
      s[0] = s[1] = s[2] = s[3] = 0.f;
      for (int k0 = 0; k0 < g.d; k0 += 16) {
        uint32_t fa[4], fb[2];
        a.load(fa, m0, k0, z);
        bk.load(fb, k0, n * 8, z);
        mma_bf16(s, fa, fb);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) s[q] *= scale;
    };
    const auto in_row = [&](int n, int q) {
      return n * 8 + 2 * (lane & 3) + (q & 1) < f;
    };
    const auto store = [&](int n, int q, float p) {
      const int row = m0 + (lane >> 2) + (q >> 1) * 8;
      if (row < f && in_row(n, q)) {
        ps[(static_cast<size_t>(hh) * f + row) * g.ldp + n * 8 +
           2 * (lane & 3) + (q & 1)] = __float2bfloat16_rn(p);
      }
    };
    const auto quad_max = [&](float (&v)[2]) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        v[half] = fmaxf(v[half], __shfl_xor_sync(0xffffffffu, v[half], 1));
        v[half] = fmaxf(v[half], __shfl_xor_sync(0xffffffffu, v[half], 2));
      }
    };
    const auto quad_sum = [&](float (&v)[2]) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        v[half] += __shfl_xor_sync(0xffffffffu, v[half], 1);
        v[half] += __shfl_xor_sync(0xffffffffu, v[half], 2);
      }
    };
    float mx[2] = {-INFINITY, -INFINITY};
    float den[2] = {0.f, 0.f};
    if (nt <= kKeyRegTiles) {
      float s[kKeyRegTiles][4];
#pragma unroll
      for (int n = 0; n < kKeyRegTiles; ++n) {
        if (n >= nt) break;
        logits(n, s[n]);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (in_row(n, q)) mx[q >> 1] = fmaxf(mx[q >> 1], s[n][q]);
        }
      }
      quad_max(mx);
#pragma unroll
      for (int n = 0; n < kKeyRegTiles; ++n) {
        if (n >= nt) break;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          s[n][q] = in_row(n, q) ? expf(s[n][q] - mx[q >> 1]) : 0.f;
          den[q >> 1] += s[n][q];
        }
      }
      quad_sum(den);
#pragma unroll
      for (int n = 0; n < kKeyRegTiles; ++n) {
        if (n >= nt) break;
#pragma unroll
        for (int q = 0; q < 4; ++q) store(n, q, s[n][q] / den[q >> 1]);
      }
    } else {
      for (int n = 0; n < nt; ++n) {
        float s[4];
        logits(n, s);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (in_row(n, q)) mx[q >> 1] = fmaxf(mx[q >> 1], s[q]);
        }
      }
      quad_max(mx);
      for (int n = 0; n < nt; ++n) {
        float s[4];
        logits(n, s);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (in_row(n, q)) den[q >> 1] += expf(s[q] - mx[q >> 1]);
        }
      }
      quad_sum(den);
      for (int n = 0; n < nt; ++n) {
        float s[4];
        logits(n, s);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          store(n, q, expf(s[q] - mx[q >> 1]) / den[q >> 1]);
        }
      }
    }
  }
  __syncthreads();
  gemm(
      g.heads, f, g.d,
      [&](int hh, float (&acc)[kMaxNT][4], int m0, int n0, int cnt) {
        mma_tiles(acc,
                  AOp{ps + static_cast<size_t>(hh) * f * g.ldp, g.ldp, f, f,
                      0},
                  BOp{vs + hh * g.dp, g.ldq, f}, m0, n0, cnt, zero);
      },
      [&](int hh, int r, int j, float v) {
        out[r * g.ldc + hh * g.d + j] = __float2bfloat16_rn(v);
      });
}

// The head padding of k must be zero (it meets q's masked columns); q's and
// v's padding only reaches outputs that are never stored. Call once before
// the stack's first stage (the next barrier publishes it).
__device__ __forceinline__ void stack_init(bf16* act, const StackGeom& g) {
  const StackTiles t(act, g);
  for (int e = threadIdx.x; e < g.qkv(); e += blockDim.x) {
    t.ks[e] = __float2bfloat16_rn(0.f);
  }
}

// What precedes the acquire of stack stage j: the attention before each
// attn_fc stage (it needs no weights).
__device__ __forceinline__ void stack_pre_stage(int j, bf16* act,
                                                const StackGeom& g,
                                                float scale,
                                                const bf16* zero) {
  if ((j & 3) == 3) {
    const StackTiles t(act, g);
    attention_tc(t.qs, t.ks, t.vs, t.ps, t.qs, g, scale, zero);
  }
}

// Stack stage j (block j / 4: GRU, rnn_fc, qkv or attn_fc) on its slot w.
// h_out: the [NB, B*F, C] new carries. The caller synchronises after it
// (and then releases the slot).
template <bool kLn>
__device__ __forceinline__ void stack_stage(int j, const bf16* w, bf16* act,
                                            bf16* h_out, int b, int batch,
                                            const StackGeom& g, float eps,
                                            const bf16* zero) {
  const StackTiles t(act, g);
  const int i = j >> 2;
  const int f = g.f, c = g.c, ld = g.ldc;
  switch (j & 3) {
    case 0:
      gru_tc(t.xs, t.hs, t.hn,
             h_out + (static_cast<size_t>(i) * batch + b) * f * c, w, g,
             zero);
      break;
    case 1: {  // rnn_fc + residual, then the positional embedding
      const bf16* bias = w + g.mat();
      const bf16* pe = bias + round8(c);
      if constexpr (kLn) {
        const BOp wf{w, ld, c};
        gemm(
            1, f, c,
            [&](int, float (&acc)[kMaxNT][4], int m0, int n0, int cnt) {
              mma_tiles(acc, AOp{t.hn, ld, f, c, 0}, wf, m0, n0, cnt, zero);
            },
            [&](int, int r, int jj, float v) {
              t.hs[r * ld + jj] = __float2bfloat16_rn(v + bf(bias[jj]));
            });
        __syncthreads();
        ln_residual_tc(t.hs, t.xs, pe + round8(f * c), pe, eps, g);
      } else {
        fc_residual_tc<true>(t.hn, ld, c, t.xs, w, bias, pe, g, zero);
      }
      break;
    }
    case 2:  // q, k, v, head-padded
      qkv_tc(t, w, g, zero);
      break;
    default: {  // attn_fc + residual
      const bf16* bias = w + g.mat();
      if constexpr (kLn) {
        const BOp wf{w, ld, c};
        gemm(
            1, f, c,
            [&](int, float (&acc)[kMaxNT][4], int m0, int n0, int cnt) {
              mma_tiles(acc, AOp{t.qs, ld, f, c, 0}, wf, m0, n0, cnt, zero);
            },
            [&](int, int r, int jj, float v) {
              t.hn[r * ld + jj] = __float2bfloat16_rn(v + bf(bias[jj]));
            });
        __syncthreads();
        ln_residual_tc(t.hn, t.xs, bias + round8(c), nullptr, eps, g);
      } else {
        fc_residual_tc<false>(t.qs, ld, c, t.xs, w, bias, nullptr, g, zero);
      }
    }
  }
}

}  // namespace tc
}  // namespace fe
