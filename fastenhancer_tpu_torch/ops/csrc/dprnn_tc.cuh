// The dprnn block stack of one stream for one frame in bfloat16, on the
// tensor cores: the bf16 form of dprnn_stack.cu's kernel, whose float32
// form keeps the scalar code (stack_common.cuh, band_sweep.cuh). Same
// math, same rounding points as dprnn_stack_reference.
//
// Built on stack_tc.cuh's stages, run by mma_common.cuh's
// run_stages_direct (each stage's weights copied by every thread straight
// into padded rows a stage ahead), four stages a block (stage j = 4 i +
// phase):
//   0. time GRU: gru_tc on the stream's F' rows; the slot holds w_xr, w_xz,
//      w_xn, w_hr, w_hz, w_hn ([C, C] each, padded rows: the layout of the
//      block stack's w_x and w_h) and the four biases, each padded to 8
//      values (gru_tc's bias_ld); the carries go out at a stride of B*C
//      between bins (gru_tc's out_ld), since they are frequency-major;
//   1. trnn_fc + residual (fc_residual_tc without pe);
//   2. the sweep: the input projection xp[d] = round(x . W_fih[d] +
//      b_fih[d]) for both directions as one product [F', C] . [C, 3Hd] per
//      direction, hoisted out of the recurrence as the Pallas kernel
//      hoists it, kept as a bf16 tile [F', 2, 3Hd]; then the recurrence,
//      one warp per direction (band_sweep_warp below);
//   3. frnn_fc + residual on the sweep's output [F', 2Hd].
//
// The recurrence, warp-synchronous. Warp d runs direction d; each lane
// owns one hidden unit, its float32 h and its b_fhh. Each of the F' steps
// computes h W_fhh[d] on the tensor cores (mma.sync, W_fhh's fragments in
// registers for the whole sweep, the columns permuted so that a lane's
// accumulators hold its own unit's three gates: see band_sweep_warp), adds
// xp[d, band] (read from shared memory a step ahead), runs the GRU cell
// with r scaling (h W_hn + b_hn), writes the rounded h' to ys [F', 2Hd] in
// shared memory and gathers the next step's A fragment from the lanes of
// its units with at most 8 shuffles. Nothing inside the loop waits for
// another warp: the two directions run at once, and run_stages' barrier
// after the stage ends the sweep. The cell's sigmoid and tanh are
// tanh.approx.f32 (tanh_fast, sigmoid_fast: at most 2^-11 relative error,
// an eighth of a bf16 ulp). A step takes about 640 cycles at DPRNN-B
// (phase_profile; NVIDIA H100): the chain of its shuffles, two dependent
// mma k-steps and the cell. A first form held W_fhh's columns as float32
// in registers and broadcast h with 24 shuffles a step: ~1,190 cycles.
#pragma once

#include "stack_tc.cuh"

namespace fe {

// Stacked plan of the folded blocks (ops/dprnn_stack.py::plan_dprnn_stack),
// read by both forms. Matrices are [in, out]; NB leads every array.
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

namespace tc {

// Sizes, in bf16 elements, of the tensor-core form's shared memory pieces
// (ops/dprnn_stack.py::tc_smem_bytes counts the same).
struct DprnnGeom {
  StackGeom s;  // F', C and the [C, C] / [F', C] tiles (heads unused)
  int hd, g3, ldw, ldy;
  __host__ __device__ DprnnGeom(int bins, int ch, int hidden)
      : s(bins, ch, 1), hd(hidden), g3(3 * hidden), ldw(ld_of(3 * hidden)),
        ldy(ld_of(2 * hidden)) {}
  // xp: [F', 2, 3Hd], packed
  __host__ __device__ int xp() const { return round8(s.f * 2 * g3); }
  // x, h, h' tiles, xp, ys [F', ldy]
  __host__ __device__ int act() const {
    return 3 * s.tile() + xp() + s.f * ldy;
  }
  __host__ __device__ int slot() const {
    const int c = s.c, c8 = round8(c), v = round8(2 * g3);
    const int gru = 6 * s.mat() + 4 * c8;
    const int tfc = s.mat() + c8;
    const int sweep = 2 * c * ldw + v + 2 * hd * ldw + v;
    const int ffc = 2 * hd * s.ldc + c8;
    return max4(gru, tfc, sweep, ffc);
  }
  __host__ __device__ static int max4(int a, int b, int c, int d) {
    const int x = a > b ? a : b, y = c > d ? c : d;
    return x > y ? x : y;
  }
};

struct DprnnTiles {
  bf16 *xs, *hs, *hn, *xp, *ys;
  __device__ __forceinline__ DprnnTiles(bf16* act, const DprnnGeom& g)
      : xs(act), hs(act + g.s.tile()), hn(act + 2 * g.s.tile()),
        xp(act + 3 * g.s.tile()), ys(xp + g.xp()) {}
};

// The arrays of stage j (block j / 4: GRU, trnn_fc, sweep, frnn_fc) to
// the visitor v (DirectV), in slot order.
template <class V>
__device__ __forceinline__ void dprnn_pieces(int j, V& v,
                                             const DprnnPlan<bf16>& p,
                                             const DprnnGeom& g) {
  const size_t i = j >> 2;
  const int c = g.s.c, hd = g.hd, g3 = g.g3;
  const size_t cc = static_cast<size_t>(c) * c;
  switch (j & 3) {
    case 0:
      v.mat(p.w_xr + i * cc, c, c);
      v.mat(p.w_xz + i * cc, c, c);
      v.mat(p.w_xn + i * cc, c, c);
      v.mat(p.w_hr + i * cc, c, c);
      v.mat(p.w_hz + i * cc, c, c);
      v.mat(p.w_hn + i * cc, c, c);
      v.vec(p.b_r + i * c, c);
      v.vec(p.b_z + i * c, c);
      v.vec(p.b_xn + i * c, c);
      v.vec(p.b_hn + i * c, c);
      break;
    case 1:
      v.mat(p.w_tfc + i * cc, c, c);
      v.vec(p.b_tfc + i * c, c);
      break;
    case 2:
      v.mat(p.w_fih + i * 2 * c * g3, 2 * c, g3);
      v.vec(p.b_fih + i * 2 * g3, 2 * g3);
      v.mat(p.w_fhh + i * 2 * hd * g3, 2 * hd, g3);
      v.vec(p.b_fhh + i * 2 * g3, 2 * g3);
      break;
    default:
      v.mat(p.w_ffc + i * 2 * hd * c, 2 * hd, c);
      v.vec(p.b_ffc + i * c, c);
  }
}

// The recurrence of both directions over the F' bands (see the note at
// the top): warps 0 and 1, the other warps return at once. xp: [F', 2,
// 3Hd] (b_fih in, rounded); w_hh: [2Hd, ldw] (direction d's Hd rows from
// d * Hd); b_hh: [2, 3Hd]; ys: [F', ldy], row f = [fwd h | bwd h] of band
// f, rounded. kMaxHd >= Hd, at most 32.
//
// Lane (g, c) (g = lane / 4, c = lane % 4) owns unit slot j = g of quad
// position c: unit U(c, j) = 2c + (j & 1) + 8 (j >> 1), j < kU. h W_hh is one
// mma.m16n8k16 row of products: every row of A is h (so lane (g, c)'s A
// fragment of k-step ks holds h[16 ks + 2c + {0, 1, 8, 9}], the units of
// its own quad position's slots 4 ks .. 4 ks + 3), B is W_hh with its
// columns permuted so that column 8t + 2c + e of n-tile t = 3 jj + q is
// gate q of unit U(c, 2 jj + e): each lane's D fragment then holds the
// three gates of the units its quad position owns, and the lane of slot j
// picks its own three. Its W fragments stay in registers for the sweep.
template <int kMaxHd>
__device__ __forceinline__ void band_sweep_warp(const bf16* xp,
                                                const bf16* w_hh,
                                                const bf16* b_hh, bf16* ys,
                                                const DprnnGeom& g) {
  constexpr int kU = 2 * ((kMaxHd + 7) / 8);  // unit slots a quad position
  constexpr int kNT = 3 * kU / 2;             // n-tiles
  constexpr int kKS = (kU + 3) / 4;           // k-steps of 16 units
  const int d = threadIdx.x >> 5;
  if (d >= 2) return;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2, cq = lane & 3;
  const int hd = g.hd, g3 = g.g3, f = g.s.f;
  const auto unit = [](int c, int j) { return 2 * c + (j & 1) + 8 * (j >> 1); };
  const auto w_at = [&](int k, int col_c, int slot, int q) {
    const int u = unit(col_c, slot);
    return k < hd && u < hd && slot < kU
               ? w_hh[(d * hd + k) * g.ldw + q * hd + u]
               : __float2bfloat16_rn(0.f);
  };
  const auto pack = [](bf16 lo, bf16 hi) {
    return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
           (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
  };
  // B fragments: lane (g, c) holds column 8t + g (quad position g / 2,
  // slot 2 (t / 3) + g % 2, gate t % 3), rows 16 ks + 2c + {0, 1} and
  // {8, 9}
  uint32_t wf[kNT][kKS][2];
#pragma unroll
  for (int t = 0; t < kNT; ++t) {
    const int slot = 2 * (t / 3) + (gq & 1);
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int k = 16 * ks + 2 * cq + 8 * h2;
        wf[t][ks][h2] = pack(w_at(k, gq >> 1, slot, t % 3),
                             w_at(k + 1, gq >> 1, slot, t % 3));
      }
    }
  }
  const int u = unit(cq, gq);
  const bool live = gq < kU && u < hd;
  float bh[3], gx[3], nx[3];
  const bf16* xrow = xp + d * g3 + u;
  const auto load_x = [&](int band, float (&v)[3]) {
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      v[q] = live ? bf(xrow[band * 2 * g3 + q * hd]) : 0.f;
    }
  };
#pragma unroll
  for (int q = 0; q < 3; ++q) bh[q] = live ? bf(b_hh[d * g3 + q * hd + u]) : 0.f;
  load_x(d ? f - 1 : 0, gx);
  float h = 0.f;
  uint32_t hb = 0;  // the rounded h, bf16 bits (0 for a slot past Hd)
  const int jj = gq >> 1, e = gq & 1;
  for (int step = 0; step < f; ++step) {
    const int band = d ? f - 1 - step : step;
    if (step + 1 < f) load_x(d ? band - 1 : band + 1, nx);
    // A: h of this quad position's slots, from their lanes
    uint32_t hs[kKS * 4];
#pragma unroll
    for (int j = 0; j < kKS * 4; ++j) {
      hs[j] = __shfl_sync(0xffffffffu, hb, (4 * j + cq) & 31);
      if (j >= kU) hs[j] = 0;
    }
    // k-steps outer: the n-tiles' products are independent, so each
    // tile's second k-step issues after the other tiles' first, not
    // stalled behind its own (a warp issues in order)
    float acc[kNT][4] = {};
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
      const uint32_t a0 = hs[4 * ks] | (hs[4 * ks + 1] << 16);
      const uint32_t a2 = hs[4 * ks + 2] | (hs[4 * ks + 3] << 16);
      const uint32_t a[4] = {a0, a0, a2, a2};
#pragma unroll
      for (int t = 0; t < kNT; ++t) mma_bf16(acc[t], a, wf[t][ks]);
    }
    // this lane's three gates: n-tiles 3 jj + q, column 2c + e
    float hh[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int j2 = 0; j2 < kU / 2; ++j2) {
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float v = e ? acc[3 * j2 + q][1] : acc[3 * j2 + q][0];
        if (j2 == jj) hh[q] = v;
      }
    }
    const float r = sigmoid_fast(gx[0] + (hh[0] + bh[0]));
    const float z = sigmoid_fast(gx[1] + (hh[1] + bh[1]));
    const float n = tanh_fast(gx[2] + r * (hh[2] + bh[2]));
    h = (1.0f - z) * n + z * h;
    const bf16 hv = __float2bfloat16_rn(h);
    hb = live ? __bfloat16_as_ushort(hv) : 0u;
    if (live) ys[band * g.ldy + d * hd + u] = hv;
#pragma unroll
    for (int q = 0; q < 3; ++q) gx[q] = nx[q];
  }
}

// Stage j (block j / 4) on its slot w. h_out: this stream's carry rows of
// block 0 ([NB, F', B, C]: h_out + ((i * F' + f) * B) * C for bin f of
// block i), row_ld = B * C. The caller synchronises after it.
template <int kMaxHd>
__device__ __forceinline__ void dprnn_stage(int j, const bf16* w,
                                            const DprnnTiles& t, bf16* h_out,
                                            size_t row_ld,
                                            const DprnnGeom& g,
                                            const bf16* zero) {
  const StackGeom& s = g.s;
  const size_t i = j >> 2;
  switch (j & 3) {
    case 0:
      gru_tc(t.xs, t.hs, t.hn, h_out + i * s.f * row_ld, w, s, zero, row_ld,
             round8(s.c));
      break;
    case 1:
      fc_residual_tc<false>(t.hn, s.ldc, s.c, t.xs, w, w + s.mat(), nullptr,
                            s, zero);
      break;
    case 2: {
      const bf16* w_ih = w;
      const bf16* b_ih = w_ih + 2 * s.c * g.ldw;
      const bf16* w_hh = b_ih + round8(2 * g.g3);
      const bf16* b_hh = w_hh + 2 * g.hd * g.ldw;
      gemm(
          2, s.f, g.g3,
          [&](int d, float (&acc)[kMaxNT][4], int m0, int n0, int cnt) {
            mma_tiles(acc, AOp{t.xs, s.ldc, s.f, s.c, 0},
                      BOp{w_ih + d * s.c * g.ldw, g.ldw, s.c}, m0, n0, cnt,
                      zero);
          },
          [&](int d, int r, int jj, float v) {
            t.xp[r * 2 * g.g3 + d * g.g3 + jj] =
                __float2bfloat16_rn(v + bf(b_ih[d * g.g3 + jj]));
          });
      __syncthreads();
      band_sweep_warp<kMaxHd>(t.xp, w_hh, b_hh, t.ys, g);
      break;
    }
    default:
      fc_residual_tc<false>(t.ys, g.ldy, 2 * g.hd, t.xs, w,
                            w + 2 * g.hd * s.ldc, nullptr, s, zero);
  }
}

}  // namespace tc
}  // namespace fe
