// The BSRNN LSTM stack of bsrnn_stack.cu in bfloat16 on the tensor cores
// (mma_common.cuh): the same function as the scalar form, which keeps
// float32 and the shapes this form does not take, rounded at the same
// points.
//
// Work unit: a tile of kTile = 8 streams, run by a cluster of two thread
// blocks, rank q = 0 and 1. Each weight fragment a warp loads serves every
// stream of the tile. Per layer:
//   1. time cell: gates = [x | h] . [W_tih; W_thh] (one float32
//      accumulator), the LSTM cell in registers, then fc_time and its
//      residual. Rank q takes its half of the tile's F * kTile rows. The
//      weights pass through a ring of three shared-memory slots, one stage
//      of kUnits units (all four gates, every K row) at a time, the copies
//      two stages ahead of the products. A warp's task holds the n-tiles
//      {u, H+u, 2H+u, 3H+u} of 8 units for 32 rows, so one lane's
//      accumulators hold i, f, g and o of the same (row, unit). The new x
//      rows go to both blocks' x tiles (the peer's through distributed
//      shared memory).
//   2. input projection, after a cluster barrier: block q is direction q
//      of the sweep and computes xp = round(x . W_fih[q] + round(b_fih[q] +
//      b_fhh[q])) for every row of the tile, as W^T . x^T: the mma's M is
//      the 4H gate columns, N the 8 streams of one band. Warp w owns the
//      16 units 16w..16w+15 (m-tiles of gate g at gH + 16w), holds its W^T
//      fragments in registers across the F bands, and writes its
//      accumulators to the global workspace xp_ws in fragment order: the
//      lane that writes a value is the lane that reads it back in step 3.
//   3. recurrence: W_hh[q] is copied once into padded shared rows, and
//      each warp holds the fragments of its W_hh^T's first kRegSteps
//      k-steps in registers through the sweep (the rest it reads from
//      shared memory every step; all of them in registers spilled). Each
//      of the F steps computes W_hh^T . h^T for the tile (h: [8, H] bf16 in
//      a double buffer, c in float32 registers), adds xp (prefetched into
//      registers a step ahead), runs the cell and writes the rounded h to
//      the double buffer and to the global workspace ys_ws; one
//      __syncthreads() a step.
//   4. fc_freq, after a cluster barrier: rank q's rows of ys_ws (both
//      directions) times W_fcf plus the residual, written to both x tiles.
// Streams past B in the last tile are zero rows that are never stored.
//
// Layouts: x, x_out [F, B, C]; h, h_out [L, 2, F, B, H]; a tile's row
// r = f * kTile + s is band f, stream b0 + s. xp_ws: [tiles, 2, F, H/16,
// 32 lanes, 16] bf16; ys_ws: [tiles, F * kTile, 2H] bf16 (row r: [fwd h |
// bwd h]). Shared memory: the 16-byte zero chunk, the x tile [F * kTile,
// ldx], the h double buffer [2, kTile, ldh] and one region each phase
// reuses (the time cell's h and c/h' rows of a chunk and its ring; W_fih[q];
// W_hh[q]; a chunk of ys rows and W_fcf). The plan's arrays are read as
// they are, row-major [in, out].
//
// What bounds it on the H100. At BSRNN-S and 256 streams its 64 blocks
// (one per SM: 193 KB of shared memory each) take about 0.54 ms against
// the 31 us operations bound (chip_smoke.py; NVIDIA H100 80GB HBM3, 700
// W). python -m fastenhancer_tpu_torch.phase_profile puts ~40% of the
// cycles in the time cell and ~35% in the 31 sweep steps of ~2,000 cycles
// each: with 8 warps a block, both are bound by the latency of their
// ldmatrix/mma chains and the barriers between phases, not by a pipe's
// rate. 16 warps a block (128 registers a thread) spilled and ran slower.
#pragma once

#include "cluster.cuh"
#include "mma_common.cuh"

namespace fe {

// Stacked plan of the folded layers (ops/bsrnn_stack.py::plan_band_stack),
// read by both forms. Matrices are [in, out], gates in torch order (i, f,
// g, o); L leads every array.
template <typename T>
struct BandPlan {
  const T* w_tih;  // [L, C, 4H]     time LSTM input weights
  const T* w_thh;  // [L, H, 4H]     time LSTM recurrent weights
  const T* b_t;    // [L, 1, 4H]     b_ih + b_hh
  const T* w_fct;  // [L, H, C]      fc_time
  const T* b_fct;  // [L, 1, C]
  const T* w_fih;  // [L, 2, C, 4H]  sweep input weights (fwd, bwd)
  const T* b_fih;  // [L, 2, 1, 4H]
  const T* w_fhh;  // [L, 2, H, 4H]  sweep recurrent weights
  const T* b_fhh;  // [L, 2, 1, 4H]
  const T* w_fcf;  // [L, 2H, C]     fc_freq
  const T* b_fcf;  // [L, 1, C]
};

namespace tc {

// streams of a tile: the N of the input projection's and the sweep's mma
constexpr int kTile = 8;
// units of one time-cell weight stage (all four gates)
constexpr int kUnits = 16;
// slots of the time cell's weight ring
constexpr int kSlots = 3;
// rows of the time cell's and fc_freq's A tiles in shared memory at once
constexpr int kChunk = 128;
// the largest C and H this form takes: W_fih's fragments of one warp (C /
// 16 k-steps) and one 16-unit group per warp (H / 16 <= kWarps)
constexpr int kMaxC = 64;
constexpr int kMaxH = 16 * kWarps;
// k-steps of W_hh^T a warp holds in registers through the sweep
constexpr int kRegSteps = 4;

// ---------------------------------------------------------------------------
// The cluster of two blocks (cluster.cuh)
// ---------------------------------------------------------------------------

// the generic address of *p's counterpart in the peer block's shared memory
template <typename P>
__device__ __forceinline__ P* peer_of(P* p) {
  return cluster_map(p, cluster_rank() ^ 1);
}

// ---------------------------------------------------------------------------
// Geometry, shared with the host's size query
// ---------------------------------------------------------------------------

struct BandGeom {
  int f, c, hd, s, rows, half, ldx, ldh, ldg, ldy, lds, stage;
  __host__ __device__ BandGeom(int bands, int ch, int hidden)
      : f(bands), c(ch), hd(hidden), s(kTile), rows(bands * kTile),
        half(0), ldx(ld_of(ch)), ldh(ld_of(hidden)), ldg(ld_of(4 * hidden)),
        ldy(ld_of(2 * hidden)), lds(ld_of(4 * kUnits)), stage(0) {
    // rank 0's rows: half of them, rounded up to whole m-tiles
    const int h16 = ((rows + 1) / 2 + 15) & ~15;
    half = h16 < rows ? h16 : rows;
    const int tw = (ch + hidden) * lds;  // a time-cell stage
    const int fw = hidden * ldx;         // fc_time's weight
    stage = tw > fw ? tw : fw;
  }
  __host__ __device__ int xtile() const { return rows * ldx; }
  __host__ __device__ int hbuf() const { return s * ldh; }
  __host__ __device__ int region() const {
    const int cell = 2 * kChunk * ldh + kSlots * stage;
    const int whh = hd * ldg;
    const int wih = c * ldg;
    const int fcf = kChunk * ldy + 2 * hd * ldx;
    int r = cell > whh ? cell : whh;
    r = r > wih ? r : wih;
    return r > fcf ? r : fcf;
  }
  // bf16 elements of the block's shared memory (8: the zero chunk)
  __host__ __device__ size_t elems() const {
    return 8 + static_cast<size_t>(xtile()) + 2 * hbuf() + region();
  }
};

// ---------------------------------------------------------------------------
// Pieces
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(
              __bfloat16_as_ushort(__float2bfloat16_rn(hi)))
          << 16);
}

// rows [ra, ra + n) of the tile, `cols` wide, from rows of a global [F, B,
// cols] array (row (f, b) at (f * batch + b) * cols) into dst with stride
// ld, 16-byte cp.async chunks; rows of streams >= batch are zeroed.
__device__ __forceinline__ void load_tile_rows(bf16* dst, int ld,
                                               const bf16* src, int ra, int n,
                                               int cols, int b0, int batch) {
  const int per = cols / 8;
  for (int e = threadIdx.x; e < n * per; e += kThreads) {
    const int r = e / per;
    const int k = e - r * per;
    const int row = ra + r;
    const int b = b0 + (row & (kTile - 1));
    bf16* d = dst + static_cast<size_t>(r) * ld + 8 * k;
    if (b < batch) {
      cp_async<16>(d, src + (static_cast<size_t>(row / kTile) * batch + b) *
                                cols + 8 * k);
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
    }
  }
}

// Stage st of the time cell's ring: units [st * kUnits, +kUnits) of all
// four gates of [W_tih; W_thh] ([C + H, 4H]) into dst [C + H, lds], gate g
// at columns g * kUnits.
__device__ __forceinline__ void copy_cell_stage(bf16* dst, int lds,
                                                const bf16* w_ih,
                                                const bf16* w_hh, int st,
                                                int c, int hd) {
  constexpr int kPer = 4 * kUnits / 8;  // 16-byte chunks a row
  const int g4 = 4 * hd;
  for (int e = threadIdx.x; e < (c + hd) * kPer; e += kThreads) {
    const int k = e / kPer;
    const int q = e - k * kPer;
    const int g = q / (kUnits / 8);
    const int part = q - g * (kUnits / 8);
    const bf16* src = (k < c ? w_ih + static_cast<size_t>(k) * g4
                             : w_hh + static_cast<size_t>(k - c) * g4) +
                      g * hd + st * kUnits + 8 * part;
    cp_async<16>(dst + k * lds + g * kUnits + 8 * part, src);
  }
}

// The kernel's arguments.
struct BandArgs {
  const bf16* x;
  const bf16* h;
  bf16* x_out;
  bf16* h_out;
  BandPlan<bf16> p;
  bf16* xp_ws;
  bf16* ys_ws;
  int batch, layers;
};

// An fc with its residual on tile rows [ra, ra + n): x[ra + r] =
// round(round(a[r] . w + bias) + x[ra + r]), written to both blocks' x
// tiles. a: [n, k] (stride lda), w: [k, C] (stride ldx) in shared memory.
// A warp's task is one m-tile and every n-tile of the C <= kMaxC columns,
// so each A fragment serves C / 8 independent mma chains.
__device__ __forceinline__ void fc_rows(const bf16* a, int lda, int k,
                                        const bf16* w, const bf16* bias,
                                        const BandGeom& g, int ra, int n,
                                        bf16* xt, bf16* xt_peer,
                                        const bf16* zero) {
  constexpr int kNT = kMaxC / 8;
  const int nt = g.c / 8;
  const int lane = threadIdx.x & 31;
  const uint32_t z = smem_u32(zero);
  const AOp ao{a, lda, n, k, 0};
  const BOp wo{w, g.ldx, k};
  for (int m0 = (threadIdx.x >> 5) * 16; m0 < n; m0 += 16 * kWarps) {
    float acc[kNT][4] = {};
#pragma unroll 2
    for (int k0 = 0; k0 < k; k0 += 16) {
      uint32_t fa[4];
      ao.load(fa, m0, k0, z);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        if (j < nt) {
          uint32_t fb[2];
          wo.load(fb, k0, 8 * j, z);
          mma_bf16(acc[j], fa, fb);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      if (j >= nt) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = m0 + (lane >> 2) + (e >> 1) * 8;
        if (r >= n) continue;
        const int col = 8 * j + 2 * (lane & 3) + (e & 1);
        const size_t o = static_cast<size_t>(ra + r) * g.ldx + col;
        const bf16 out =
            __float2bfloat16_rn(rnd(acc[j][e] + bf(bias[col])) + bf(xt[o]));
        xt[o] = out;
        xt_peer[o] = out;
      }
    }
  }
}

// The time cell and fc_time of layer i on tile rows [ra, ra + n), n <=
// kChunk: h rows into ht, the c rows into hn (each cell overwrites its c
// with its h'), ring stages in `ring`.
__device__ __forceinline__ void time_cell_chunk(const BandArgs& a,
                                                const BandGeom& g, int i,
                                                int ra, int n, int b0,
                                                bf16* xt, bf16* xt_peer,
                                                bf16* reg, const bf16* zero) {
  const int c = g.c, hd = g.hd, g4 = 4 * hd;
  const size_t fbh = static_cast<size_t>(g.f) * a.batch * hd;
  bf16* ht = reg;
  bf16* hn = ht + kChunk * g.ldh;
  bf16* ring = hn + kChunk * g.ldh;
  const bf16* w_ih = a.p.w_tih + static_cast<size_t>(i) * c * g4;
  const bf16* w_hh = a.p.w_thh + static_cast<size_t>(i) * hd * g4;
  const bf16* b_t = a.p.b_t + static_cast<size_t>(i) * g4;
  bf16* h_new = a.h_out + 2 * i * fbh;
  bf16* c_new = h_new + fbh;
  const int lane = threadIdx.x & 31;
  const int cells = hd / kUnits;  // then one stage of fc_time's weight
  const int pairs = (n + 31) / 32;  // a task's two m-tiles
  constexpr int kSub = kUnits / 8;

  // stage st's copies into slot st % kSlots, one commit group each
  auto copy_stage = [&](int st) {
    bf16* slot = ring + (st % kSlots) * g.stage;
    if (st < cells) {
      copy_cell_stage(slot, g.lds, w_ih, w_hh, st, c, hd);
    } else if (st == cells) {
      copy_rows_async<16>(slot, g.ldx,
                          a.p.w_fct + static_cast<size_t>(i) * hd * c, hd, c);
    }
    cp_async_commit();
  };
  load_tile_rows(ht, g.ldh, a.h + 2 * i * fbh, ra, n, hd, b0, a.batch);
  load_tile_rows(hn, g.ldh, a.h + (2 * i + 1) * fbh, ra, n, hd, b0,
                 a.batch);
  for (int st = 0; st < kSlots - 1; ++st) copy_stage(st);
  for (int st = 0; st <= cells; ++st) {
    // every group but the newest has landed: stage st's
    cp_async_wait<kSlots - 2>();
    __syncthreads();
    // the slot stage st - 1 used is free: two stages ahead
    copy_stage(st + kSlots - 1);
    const bf16* w = ring + (st % kSlots) * g.stage;
    if (st < cells) {
      const AOp ax{xt + static_cast<size_t>(ra) * g.ldx, g.ldx, n, c, 0};
      const AOp ah{ht, g.ldh, n, hd, 0};
      const BOp bw{w, g.lds, c + hd};
      const uint32_t z = smem_u32(zero);
      // a task: two m-tiles (32 rows) of 8 units, all four gates
      for (int task = threadIdx.x >> 5; task < pairs * kSub;
           task += kWarps) {
        const int m0 = (task / kSub) * 32;
        const int sub = task % kSub;
        const int u0 = st * kUnits + sub * 8 + 2 * (lane & 3);
        float bias[4][2];
#pragma unroll
        for (int gt = 0; gt < 4; ++gt) {
          bias[gt][0] = bf(b_t[gt * hd + u0]);
          bias[gt][1] = bf(b_t[gt * hd + u0 + 1]);
        }
        float acc[2][4][4] = {};
#pragma unroll 2
        for (int k0 = 0; k0 < c; k0 += 16) {
          uint32_t fa[2][4];
          ax.load(fa[0], m0, k0, z);
          ax.load(fa[1], m0 + 16, k0, z);
#pragma unroll
          for (int gt = 0; gt < 4; ++gt) {
            uint32_t fb[2];
            bw.load(fb, k0, gt * kUnits + sub * 8, z);
            mma_bf16(acc[0][gt], fa[0], fb);
            mma_bf16(acc[1][gt], fa[1], fb);
          }
        }
#pragma unroll 2
        for (int k0 = 0; k0 < hd; k0 += 16) {
          uint32_t fa[2][4];
          ah.load(fa[0], m0, k0, z);
          ah.load(fa[1], m0 + 16, k0, z);
#pragma unroll
          for (int gt = 0; gt < 4; ++gt) {
            uint32_t fb[2];
            bw.load(fb, c + k0, gt * kUnits + sub * 8, z);
            mma_bf16(acc[0][gt], fa[0], fb);
            mma_bf16(acc[1][gt], fa[1], fb);
          }
        }
        // accumulators e = 2 rh + q: row half rh, unit u0 + q; each
        // (row, unit pair) leaves as one 4-byte store of h' and one of c'
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
          for (int rh = 0; rh < 2; ++rh) {
            const int r = m0 + 16 * mi + (lane >> 2) + rh * 8;
            if (r >= n) continue;
            bf16* cell = hn + r * g.ldh + u0;  // c in, h' out
            const uint32_t c_pair = *reinterpret_cast<const uint32_t*>(cell);
            float cv[2], hv[2];
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              const int e = 2 * rh + q;
              const float ig = sigmoid_fast(acc[mi][0][e] + bias[0][q]);
              const float fg = sigmoid_fast(acc[mi][1][e] + bias[1][q]);
              const float gg = tanh_fast(acc[mi][2][e] + bias[2][q]);
              const float og = sigmoid_fast(acc[mi][3][e] + bias[3][q]);
              cv[q] = fg * (q ? hi_bf16(c_pair) : lo_bf16(c_pair)) + ig * gg;
              hv[q] = og * tanh_fast(cv[q]);
            }
            const uint32_t h_pair = pack_bf16(hv[0], hv[1]);
            *reinterpret_cast<uint32_t*>(cell) = h_pair;
            const int row = ra + r;
            const int b = b0 + (row & (kTile - 1));
            if (b < a.batch) {
              const size_t o =
                  (static_cast<size_t>(row / kTile) * a.batch + b) * hd + u0;
              *reinterpret_cast<uint32_t*>(h_new + o) = h_pair;
              *reinterpret_cast<uint32_t*>(c_new + o) =
                  pack_bf16(cv[0], cv[1]);
            }
          }
        }
      }
    } else {
      // fc_time + residual, to both blocks' x tiles
      fc_rows(hn, g.ldh, hd, w, a.p.b_fct + static_cast<size_t>(i) * c, g,
              ra, n, xt, xt_peer, zero);
    }
    __syncthreads();
  }
}

// Where lane `lane` of warp `ug` keeps its 16 xp values of band 0 of
// direction d (the next band 16 * 32 * H / 16 values on).
__device__ __forceinline__ bf16* xp_of(const BandArgs& a, const BandGeom& g,
                                       int tile, int d, int ug, int lane) {
  return a.xp_ws +
         (((static_cast<size_t>(tile) * 2 + d) * g.f * (g.hd / 16) + ug) *
              32 + lane) * 16;
}

// The input projection of direction d (step 2): xp for every band of the
// tile into xp_ws, in the fragment order the recurrence reads: per lane
// and band, gate g's values at 4 g + e for the mma's accumulator e.
__device__ __forceinline__ void input_projection(const BandArgs& a,
                                                 const BandGeom& g, int i,
                                                 int d, int tile,
                                                 const bf16* xt, bf16* reg,
                                                 const bf16* zero) {
  const int c = g.c, hd = g.hd, g4 = 4 * hd;
  const size_t wo = (2 * static_cast<size_t>(i) + d) * g4;
  copy_rows_async<16>(reg, g.ldg, a.p.w_fih + wo * c, c, g4);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int ug = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (ug < hd / 16) {
    const uint32_t z = smem_u32(zero);
    const int j0 = 16 * ug;
    const int ks = c / 16;
    float xb[4][2];
    uint32_t fa[4][kMaxC / 16][4];
    const ATOp wt{reg, g.ldg, g4, c};
#pragma unroll
    for (int gt = 0; gt < 4; ++gt) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const size_t n = wo + gt * hd + j0 + (lane >> 2) + 8 * hf;
        xb[gt][hf] = rnd(bf(a.p.b_fih[n]) + bf(a.p.b_fhh[n]));
      }
#pragma unroll
      for (int k = 0; k < kMaxC / 16; ++k) {
        if (k < ks) wt.load(fa[gt][k], gt * hd + j0, 16 * k, z);
      }
    }
    bf16* out = xp_of(a, g, tile, d, ug, lane);
    const size_t band_step = static_cast<size_t>(hd / 16) * 32 * 16;
#pragma unroll 2
    for (int f = 0; f < g.f; ++f) {
      const BTOp bx{xt + static_cast<size_t>(f) * kTile * g.ldx, g.ldx,
                    kTile, c};
      float acc[4][4] = {};
#pragma unroll
      for (int k = 0; k < kMaxC / 16; ++k) {
        if (k < ks) {
          uint32_t fb[2];
          bx.load(fb, 16 * k, 0, z);
#pragma unroll
          for (int gt = 0; gt < 4; ++gt) mma_bf16(acc[gt], fa[gt][k], fb);
        }
      }
      uint32_t w[8];
#pragma unroll
      for (int gt = 0; gt < 4; ++gt) {
        w[2 * gt] = pack_bf16(acc[gt][0] + xb[gt][0], acc[gt][1] + xb[gt][0]);
        w[2 * gt + 1] =
            pack_bf16(acc[gt][2] + xb[gt][1], acc[gt][3] + xb[gt][1]);
      }
      uint4* dst = reinterpret_cast<uint4*>(out + f * band_step);
      dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
      dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
    }
  }
  __syncthreads();
}

// The recurrence of direction d (step 3) over the F bands, h into hb's
// double buffer and ys_ws.
__device__ __forceinline__ void recurrence(const BandArgs& a,
                                           const BandGeom& g, int i, int d,
                                           int tile, bf16* hb, bf16* reg,
                                           const bf16* zero) {
  const int hd = g.hd, g4 = 4 * hd;
  copy_rows_async<16>(
      reg, g.ldg, a.p.w_fhh + (2 * static_cast<size_t>(i) + d) * hd * g4, hd,
      g4);
  cp_async_commit();
  for (int e = threadIdx.x; e < 2 * g.hbuf(); e += kThreads) {
    hb[e] = __ushort_as_bfloat16(0);
  }
  cp_async_wait<0>();
  __syncthreads();
  const int ug = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool active = ug < hd / 16;
  const int j0 = 16 * ug;
  const int ks = hd / 16;
  const uint32_t z = smem_u32(zero);
  const ATOp wt{reg, g.ldg, g4, hd};
  uint32_t wr[4][kRegSteps][4];
  if (active) {
#pragma unroll
    for (int gt = 0; gt < 4; ++gt) {
#pragma unroll
      for (int k = 0; k < kRegSteps; ++k) {
        if (k < ks) wt.load(wr[gt][k], gt * hd + j0, 16 * k, z);
      }
    }
  }
  const uint4* xp =
      reinterpret_cast<const uint4*>(xp_of(a, g, tile, d, ug, lane));
  const int band_step = (hd / 16) * 32 * 2;  // in uint4
  bf16* ys = a.ys_ws + static_cast<size_t>(tile) * g.rows * 2 * hd + d * hd;
  float cs[4] = {};
  uint4 xn[2];
  if (active) {
    const int band = d ? g.f - 1 : 0;
    xn[0] = xp[band * band_step];
    xn[1] = xp[band * band_step + 1];
  }
  for (int t = 0; t < g.f; ++t) {
    const int band = d ? g.f - 1 - t : t;
    const bf16* h_cur = hb + (t & 1) * g.hbuf();
    bf16* h_next = hb + ((t + 1) & 1) * g.hbuf();
    if (active) {
      const uint32_t wv[8] = {xn[0].x, xn[0].y, xn[0].z, xn[0].w,
                              xn[1].x, xn[1].y, xn[1].z, xn[1].w};
      if (t + 1 < g.f) {  // the next band's xp, a step ahead
        const int next = d ? band - 1 : band + 1;
        xn[0] = xp[next * band_step];
        xn[1] = xp[next * band_step + 1];
      }
      float acc[4][4] = {};
      const BTOp bh{h_cur, g.ldh, kTile, hd};
#pragma unroll
      for (int k = 0; k < kMaxH / 16; ++k) {
        if (k < ks) {
          uint32_t fb[2];
          bh.load(fb, 16 * k, 0, z);
#pragma unroll
          for (int gt = 0; gt < 4; ++gt) {
            if (k < kRegSteps) {
              mma_bf16(acc[gt], wr[gt][k < kRegSteps ? k : 0], fb);
            } else {
              uint32_t fa[4];
              wt.load(fa, gt * hd + j0, 16 * k, z);
              mma_bf16(acc[gt], fa, fb);
            }
          }
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float gate[4];
#pragma unroll
        for (int gt = 0; gt < 4; ++gt) {
          const uint32_t word = wv[2 * gt + (e >> 1)];
          gate[gt] =
              ((e & 1) ? hi_bf16(word) : lo_bf16(word)) + acc[gt][e];
        }
        const float ig = sigmoid_fast(gate[0]);
        const float fg = sigmoid_fast(gate[1]);
        const float gg = tanh_fast(gate[2]);
        const float og = sigmoid_fast(gate[3]);
        cs[e] = fg * cs[e] + ig * gg;
        const bf16 hv = __float2bfloat16_rn(og * tanh_fast(cs[e]));
        const int u = j0 + (lane >> 2) + (e >> 1) * 8;
        const int s = 2 * (lane & 3) + (e & 1);
        h_next[s * g.ldh + u] = hv;
        ys[static_cast<size_t>(band * kTile + s) * 2 * hd + u] = hv;
      }
    }
    __syncthreads();
  }
}

// fc_freq + residual of layer i on tile rows [ra, ra + n), n <= kChunk:
// their ys rows (both directions) from ys_ws into the region, W_fcf
// already on its way to the region past them (fcf_of), both blocks' x
// tiles updated.
__device__ __forceinline__ bf16* fcf_of(bf16* reg, const BandGeom& g) {
  return reg + kChunk * g.ldy;
}

__device__ __forceinline__ void fc_freq_chunk(const BandArgs& a,
                                              const BandGeom& g, int i,
                                              int tile, int ra, int n,
                                              bf16* xt, bf16* xt_peer,
                                              bf16* reg, const bf16* zero) {
  const int y2 = 2 * g.hd;
  copy_rows_async<16>(
      reg, g.ldy,
      a.ys_ws + (static_cast<size_t>(tile) * g.rows + ra) * y2, n, y2);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  fc_rows(reg, g.ldy, y2, fcf_of(reg, g),
          a.p.b_fcf + static_cast<size_t>(i) * g.c, g, ra, n, xt, xt_peer,
          zero);
  __syncthreads();
}

// The whole stack for the tile of cluster blockIdx.x / 2; called by every
// thread of both blocks. smem: g.elems() bf16, 16-byte aligned.
__device__ __forceinline__ void band_stack_tc(const BandArgs& a, int bands,
                                              int ch, int hd, bf16* smem) {
  const BandGeom g(bands, ch, hd);
  const int q = cluster_rank();
  const int tile = blockIdx.x >> 1;
  const int b0 = tile * kTile;
  bf16* zero = smem;
  bf16* xt = smem + 8;
  bf16* hb = xt + g.xtile();
  bf16* reg = hb + 2 * g.hbuf();
  bf16* xt_peer = peer_of(xt);
  if (threadIdx.x == 0) {
    *reinterpret_cast<uint4*>(zero) = make_uint4(0, 0, 0, 0);
  }
  load_tile_rows(xt, g.ldx, a.x, 0, g.rows, ch, b0, a.batch);
  cp_async_commit();
  cp_async_wait<0>();
  // both blocks started (before any write to the peer) and the tile loaded
  cluster_sync();
  const int r0 = q ? g.half : 0;
  const int nr = q ? g.rows - g.half : g.half;
  for (int i = 0; i < a.layers; ++i) {
    for (int ra = r0; ra < r0 + nr; ra += kChunk) {
      const int n = r0 + nr - ra < kChunk ? r0 + nr - ra : kChunk;
      time_cell_chunk(a, g, i, ra, n, b0, xt, xt_peer, reg, zero);
    }
    cluster_sync();
    input_projection(a, g, i, q, tile, xt, reg, zero);
    recurrence(a, g, i, q, tile, hb, reg, zero);
    // W_hh is done with: W_fcf's copy overlaps the barrier
    copy_rows_async<16>(fcf_of(reg, g), g.ldx,
                        a.p.w_fcf + static_cast<size_t>(i) * 2 * hd * ch,
                        2 * hd, ch);
    cp_async_commit();
    __threadfence();
    cluster_sync();
    for (int ra = r0; ra < r0 + nr; ra += kChunk) {
      const int n = r0 + nr - ra < kChunk ? r0 + nr - ra : kChunk;
      fc_freq_chunk(a, g, i, tile, ra, n, xt, xt_peer, reg, zero);
    }
  }
  const int per = ch / 8;
  for (int e = threadIdx.x; e < nr * per; e += kThreads) {
    const int r = e / per;
    const int k = e - r * per;
    const int row = r0 + r;
    const int b = b0 + (row & (kTile - 1));
    if (b < a.batch) {
      *reinterpret_cast<uint4*>(
          a.x_out + (static_cast<size_t>(row / kTile) * a.batch + b) * ch +
          8 * k) =
          *reinterpret_cast<const uint4*>(xt + static_cast<size_t>(row) *
                                                   g.ldx + 8 * k);
    }
  }
  // no block exits while its peer may still write to its shared memory
  cluster_sync();
}

}  // namespace tc
}  // namespace fe
