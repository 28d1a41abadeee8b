// The GRU scan of gru_scan.cu in bfloat16 on the tensor cores: the same
// function as the scalar form (which keeps float32), with the Pallas
// kernel's cast points: the state stays float32 across all T steps, w_hh
// and b_hh are exact, the gate math is float32, and only ys and h_T are
// rounded to bfloat16. H is even (x_proj, ys and h_T move as bf16 pairs).
//
// Work unit: a tile of kRows = 16 rows for all T steps, one thread block
// of tc_warps(H) warps. Each step is the product h [16, H] . W_hh^T
// [H, 3H] on mma.sync m16n8k16 (mma_common.cuh), then the cell.
//   - The columns of W_hh^T are permuted: n-tile 3u + q holds gate q (r,
//     z, n) of units 8u .. 8u + 7 (the units padded to U = ceil(H / 8)
//     groups of 8, K to KS = ceil(H / 16) k-steps of 16, with zeros).
//     Lane (g, c) of a warp (g = lane / 4, c = lane % 4) then holds in its
//     accumulators of n-tiles 3u, 3u + 1 and 3u + 2 all three gate sums of
//     rows g and g + 8 for units 8u + 2c and 8u + 2c + 1, and computes h'
//     for exactly those four (row, unit) pairs, which are its part of the
//     next step's A (k-step u / 2: a0/a1 for even u, a2/a3 for odd u).
//   - Warp w owns the unit groups w G .. w G + G - 1: G = 1 up to H = 64,
//     2 above, so up to 8 warps a tile, each warp's products and cells on
//     its own sub-partition where there are at most 4. Each writes its part
//     of A into a double-buffered shared tile; after the step's one
//     __syncthreads() every warp reads the whole A back with ldmatrix.
//     (One warp for the whole tile, A kept in its own registers with no
//     barrier, was about half as fast at H = 20: its 36 mma and 72 MUFU
//     operations a step all fall on one sub-partition.)
//   - The float32 state survives the bf16 products: each lane keeps its h
//     in float32 registers (the state), and A = hi + lo, hi = bf16(h), lo =
//     bf16(h - hi), two mma per (k-step, n-tile), hi products summed from
//     b_hh and lo products from 0 in separate accumulators (chains half as
//     long), then added. B (w_hh) is exact in bf16. The product is then
//     within about 2^-16 of h's own size of the float32 one; h rounded to
//     bf16 once a step (nn.gru's cast point) drifts about 500 times further
//     over 126 steps.
//   - W_hh^T's B fragments are computed from w_hh [3H, H] once, in the
//     kernel, and stay in registers for the whole sequence up to H = 64;
//     above that (H <= 128) they stay in shared memory in fragment order,
//     each lane reading its 8 bytes a fragment.
//   - The gates: sigmoid(v) = 1 / (1 + 2^(-v log2 e)) on ex2.approx and
//     rcp.approx, tanh(v) = 2 sigmoid(2v) - 1: two MUFU operations each
//     and about 1e-7 absolute error. (tanh.approx's 2^-11 relative error at
//     every one of 126 steps would throw away what the split keeps.)
//   - x_proj: each lane loads its own 12 gate inputs a step (6 bf16 pairs a
//     unit group) from global memory straight into registers, two steps
//     ahead, into two buffers that the unrolled time loop takes in turn.
//     A ring of x_proj slabs in shared memory, filled by cp.async.bulk (or
//     cp.async) several steps ahead, cost more than the loads it hid: the
//     mbarrier wait and the refill sat on every step's path.
//   - ys[t] is written from registers as 4-byte bf16 pairs after the
//     barrier; rows past N and units past H are never stored.
// Every loop of a step runs a compile-time count (one instantiation per
// (KS, G)), so a step is straight-line code with no divergent branch.
// What bounds it: the T dependent steps, each a chain of ldmatrix, mma,
// MUFU and FMA latencies and a barrier; the bytes (x_proj in, ys out: 21
// MB at the valid step) take 6 us at 3.35 TB/s.
#pragma once

#include "mma_common.cuh"

namespace fe {
namespace gru {

using tc::bf16;

// rows of a tile: the mma's M
constexpr int kRows = 16;
// warps of a tile's block at most
constexpr int kMaxWarps = 8;

// The tile's geometry and shared memory (bytes), shared with the host's
// size query: the h tile [2 steps][hi, lo][16][ldk] bf16, then W_hh^T's B
// fragments [3U][KS][32 lanes][2] where they are not in registers (H >
// 64).
struct GruTcGeom {
  int hid, units, ksteps, groups, ldk;
  bool reg_b;
  __host__ __device__ explicit GruTcGeom(int h)
      : hid(h), units((h + 7) / 8), ksteps((h + 15) / 16),
        groups((h + 7) / 8 <= 8 ? 1 : 2),
        ldk(tc::ld_of(16 * ((h + 15) / 16))), reg_b(h <= 64) {}
  // warps a tile: one per G unit groups
  __host__ __device__ int warps() const {
    return (units + groups - 1) / groups;
  }
  __host__ __device__ size_t hbuf_bytes() const {
    return static_cast<size_t>(4) * kRows * ldk * 2;
  }
  __host__ __device__ size_t bytes() const {
    return hbuf_bytes() +
           (reg_b ? 0 : static_cast<size_t>(3) * units * ksteps * 32 * 8);
  }
};

struct GruTcArgs {
  const bf16* x_proj;  // [T, N, 3H], 4-byte aligned
  const bf16* h0;      // [N, H]
  const bf16* w_hh;    // [3H, H]
  const bf16* b_hh;    // [3H]
  bf16* ys;            // [T, N, H]
  bf16* h_t;           // [N, H]
  int steps, rows, hid;
};

__device__ __forceinline__ uint32_t bits_of(bf16 v) {
  return __bfloat16_as_ushort(v);
}

// Register j of the B fragment of W_hh^T for n-tile nt = 3u + q, k-step
// ks, lane (g, c): B[k][n] = w_hh[q H + 8u + n][k], k = 16 ks + 8 j + 2c
// (low half) and k + 1 (high half), n = g; zero past H on either side.
__device__ __forceinline__ uint32_t b_frag(const bf16* w_hh, int hid, int nt,
                                           int ks, int j, int lane) {
  const int u = nt / 3;
  const int unit = 8 * u + (lane >> 2);
  const int k = 16 * ks + 8 * j + 2 * (lane & 3);
  if (unit >= hid) return 0u;
  const bf16* row =
      w_hh + static_cast<size_t>((nt - 3 * u) * hid + unit) * hid;
  const uint32_t lo = k < hid ? bits_of(row[k]) : 0u;
  const uint32_t hi = k + 1 < hid ? bits_of(row[k + 1]) : 0u;
  return lo | (hi << 16);
}

// 2^v and 1 / v on the MUFU unit, subnormals flushed (no fix-up code
// around them, as __expf and __fdividef have)
__device__ __forceinline__ float ex2_approx(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(v));
  return r;
}
__device__ __forceinline__ float rcp_approx(float v) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(v));
  return r;
}
__device__ __forceinline__ float sigmoid_mufu(float v) {
  return rcp_approx(1.f + ex2_approx(-1.44269504088896341f * v));
}
__device__ __forceinline__ float tanh_mufu(float v) {
  return fmaf(2.f, sigmoid_mufu(2.f * v), -1.f);
}

// a and b rounded to bf16 as one pair (a the low half), by one packed
// conversion
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// hi = the bf16 pair (a, b), lo = the pair of what rounding left off
__device__ __forceinline__ void split_pair(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  hi = pack_bf16(a, b);
  lo = pack_bf16(a - __uint_as_float(hi << 16),
                 b - __uint_as_float(hi & 0xffff0000u));
}

// One tile's whole sequence; every thread of the block (geom.warps()
// warps) calls it. kKS: the k-steps; kG: the unit groups of each warp (the
// last warp's groups past U compute values that nothing reads); kRegB: B
// in registers. Every loop of a step runs a compile-time count.
template <int kKS, int kG, bool kRegB>
__device__ __forceinline__ void gru_tile(const GruTcArgs& a, char* smem) {
  // two accumulators a gate (hi and lo products apart) while registers
  // allow: chains half as long
  constexpr bool kTwoAcc = kG == 1;
  const int hid = a.hid, g3 = 3 * hid;
  const GruTcGeom geom(hid);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gq = lane >> 2, cq = lane & 3;
  const int row0 = blockIdx.x * kRows;
  const int tile_rows = min(kRows, a.rows - row0);
  bf16* hbuf = reinterpret_cast<bf16*>(smem);
  auto* frag = reinterpret_cast<uint2*>(smem + geom.hbuf_bytes());
  // the units this warp owns: groups u = warp G + j, j < kG (G = kG)
  const int g_first = warp * kG;
  const int g_cnt = min(kG, geom.units - g_first);

  if (!kRegB) {
    const int n = 3 * geom.units * kKS * 32;
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int l = e & 31;
      const int ks = (e >> 5) % kKS;
      const int nt = (e >> 5) / kKS;
      frag[e] = make_uint2(b_frag(a.w_hh, hid, nt, ks, 0, l),
                           b_frag(a.w_hh, hid, nt, ks, 1, l));
    }
  }
  {
    auto* hb = reinterpret_cast<uint32_t*>(hbuf);
    for (int e = threadIdx.x; e < 2 * kRows * geom.ldk; e += blockDim.x) {
      hb[e] = 0u;  // both steps' hi and lo; padded columns stay zero
    }
  }

  // the state of this lane's four (row, unit) pairs of each group (rows
  // gq, gq + 8; units 8u + 2cq, + 1), the biases, the B fragments; units
  // past H (and rows past N) hold values that no output reads
  float h[kG][4];
  float bias[kG][3][2];
  uint32_t bw[kRegB ? 3 * kG : 1][kRegB ? kKS : 1][2];
#pragma unroll
  for (int j = 0; j < kG; ++j) {
    const int unit = 8 * (g_first + j) + 2 * cq;
    const bool on = unit < hid;  // H even: unit + 1 too
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = gq + 8 * (e >> 1);
      h[j][e] = on && r < tile_rows
                    ? __bfloat162float(a.h0[static_cast<size_t>(row0 + r) *
                                                hid +
                                            unit + (e & 1)])
                    : 0.f;
    }
#pragma unroll
    for (int q = 0; q < 3; ++q) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        bias[j][q][e] =
            on ? __bfloat162float(a.b_hh[q * hid + unit + e]) : 0.f;
      }
      if (kRegB) {
#pragma unroll
        for (int ks = 0; ks < kKS; ++ks) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            bw[kRegB ? 3 * j + q : 0][kRegB ? ks : 0][r] =
                b_frag(a.w_hh, hid, 3 * (g_first + j) + q, ks, r, lane);
          }
        }
      }
    }
  }
  __syncthreads();  // the zeroed tile before any warp's part of A

  // h (hi and lo halves) into the shared A tile of step `buf`
  const auto publish = [&](int buf) {
    auto* hb = reinterpret_cast<uint32_t*>(hbuf + buf * 2 * kRows * geom.ldk);
    const int half = kRows * geom.ldk / 2;  // lo after hi, in words
#pragma unroll
    for (int j = 0; j < kG; ++j) {
      if (j >= g_cnt) break;
      uint32_t hi0, lo0, hi1, lo1;
      split_pair(h[j][0], h[j][1], hi0, lo0);
      split_pair(h[j][2], h[j][3], hi1, lo1);
      const int col = 4 * (g_first + j) + cq;
      hb[gq * geom.ldk / 2 + col] = hi0;
      hb[(gq + 8) * geom.ldk / 2 + col] = hi1;
      hb[half + gq * geom.ldk / 2 + col] = lo0;
      hb[half + (gq + 8) * geom.ldk / 2 + col] = lo1;
    }
  };
  // x_proj of step t: gate q of rows gq, gq + 8 of each group, as bf16
  // pairs from global memory (rows past N read the tile's row 0, units
  // past H the row's unit 0)
  const auto load_x = [&](int t, uint32_t (&xb)[kG][3][2]) {
    const bf16* xt =
        a.x_proj + (static_cast<size_t>(t) * a.rows + row0) * g3;
#pragma unroll
    for (int j = 0; j < kG; ++j) {
      const int unit = 8 * (g_first + j) + 2 * cq;
      const int uo = unit < hid ? unit : 0;
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int r = gq + 8 * e2 < tile_rows ? gq + 8 * e2 : 0;
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          xb[j][q][e2] = __ldg(reinterpret_cast<const unsigned int*>(
              xt + r * g3 + q * hid + uo));
        }
      }
    }
  };
  publish(0);
  __syncthreads();

  const size_t out_ld = static_cast<size_t>(a.rows) * hid;
  uint32_t ahi[kKS][4], alo[kKS][4];
  // step t, its x_proj in xb (loaded two steps ahead); reloads xb with step
  // t + 2 once the cell has read it
  const auto step = [&](int t, uint32_t (&xb)[kG][3][2]) {
    // the whole A from the shared tile of this step
    const bf16* hb = hbuf + (t & 1) * 2 * kRows * geom.ldk;
    const uint32_t base =
        tc::smem_u32(hb + (lane & 15) * geom.ldk + (lane >> 4) * 8);
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
      tc::ldsm_x4(ahi[ks], base + 32 * ks);
      tc::ldsm_x4(alo[ks], base + 32 * ks + 2 * kRows * geom.ldk);
    }
    // the gate sums: the hi products from b_hh, the lo products from 0
    // (kTwoAcc) or onto the same sums
    float acc[kG][3][4], acc_lo[kTwoAcc ? kG : 1][3][4];
#pragma unroll
    for (int j = 0; j < kG; ++j) {
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        acc[j][q][0] = acc[j][q][2] = bias[j][q][0];
        acc[j][q][1] = acc[j][q][3] = bias[j][q][1];
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_lo[kTwoAcc ? j : 0][q][e] = 0.f;
      }
    }
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
#pragma unroll
      for (int j = 0; j < kG; ++j) {
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          uint32_t b[2];
          if (kRegB) {
            b[0] = bw[kRegB ? 3 * j + q : 0][kRegB ? ks : 0][0];
            b[1] = bw[kRegB ? 3 * j + q : 0][kRegB ? ks : 0][1];
          } else {
            const int nt = 3 * min(g_first + j, geom.units - 1) + q;
            const uint2 f = frag[(nt * kKS + ks) * 32 + lane];
            b[0] = f.x;
            b[1] = f.y;
          }
          tc::mma_bf16(acc[j][q], ahi[ks], b);
          tc::mma_bf16(kTwoAcc ? acc_lo[kTwoAcc ? j : 0][q] : acc[j][q],
                       alo[ks], b);
        }
      }
    }
    // the cell, float32
#pragma unroll
    for (int j = 0; j < kG; ++j) {
      const bool on = 8 * (g_first + j) + 2 * cq < hid;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float s[3], x[3];
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          s[q] = kTwoAcc ? acc[j][q][e] + acc_lo[kTwoAcc ? j : 0][q][e]
                         : acc[j][q][e];
          const uint32_t w = xb[j][q][e >> 1];
          x[q] = on ? __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16))
                    : 0.f;
        }
        const float r = sigmoid_mufu(x[0] + s[0]);
        const float z = sigmoid_mufu(x[1] + s[1]);
        const float n = tanh_mufu(fmaf(r, s[2], x[2]));
        h[j][e] = fmaf(z, h[j][e] - n, n);
      }
    }
    if (t + 2 < a.steps) load_x(t + 2, xb);
    // h into the next step's A; then every warp has written its part
    publish((t + 1) & 1);
    __syncthreads();
    // ys[t], off the path to the next step
    bf16* yt = a.ys + static_cast<size_t>(t) * out_ld +
               static_cast<size_t>(row0) * hid;
#pragma unroll
    for (int j = 0; j < kG; ++j) {
      const int unit = 8 * (g_first + j) + 2 * cq;
      if (unit < hid) {
        if (gq < tile_rows) {
          *reinterpret_cast<uint32_t*>(yt + gq * hid + unit) =
              pack_bf16(h[j][0], h[j][1]);
        }
        if (gq + 8 < tile_rows) {
          *reinterpret_cast<uint32_t*>(yt + (gq + 8) * hid + unit) =
              pack_bf16(h[j][2], h[j][3]);
        }
      }
    }
  };
  // the time loop, unrolled by two so that each step's x_proj buffer is a
  // fixed set of registers
  uint32_t xa[kG][3][2], xb[kG][3][2];
  if (a.steps > 0) load_x(0, xa);
  if (a.steps > 1) load_x(1, xb);
  for (int t = 0; t < a.steps; t += 2) {
    step(t, xa);
    if (t + 1 < a.steps) step(t + 1, xb);
  }
  // h_T
  bf16* ht = a.h_t + static_cast<size_t>(row0) * hid;
#pragma unroll
  for (int j = 0; j < kG; ++j) {
    const int unit = 8 * (g_first + j) + 2 * cq;
    if (unit < hid) {
      if (gq < tile_rows) {
        *reinterpret_cast<uint32_t*>(ht + gq * hid + unit) =
            pack_bf16(h[j][0], h[j][1]);
      }
      if (gq + 8 < tile_rows) {
        *reinterpret_cast<uint32_t*>(ht + (gq + 8) * hid + unit) =
            pack_bf16(h[j][2], h[j][3]);
      }
    }
  }
}

}  // namespace gru
}  // namespace fe
