// The dptransformer block stack of one stream for one frame in bfloat16,
// on the tensor cores where the Pallas kernel's rounding allows it: the
// bf16 form of dpt_stack.cu's kernel, whose float32 form keeps the scalar
// code (stack_common.cuh). Same math, same rounding points as
// dpt_stack_reference.
//
// Built on stack_tc.cuh's stages, run by mma_common.cuh's
// run_stages_direct (each stage's weights copied by every thread straight
// into padded rows a stage ahead), four stages a block (stage j = 4 i +
// phase):
//   0. time q, k, v: qkv_tc on w_tqkv (the block stack's w_qkv layout),
//      head-padded;
//   1. the cached time attention (before the stage: it needs no weights),
//      then time_fc + residual + pe: fc_residual_tc with pe;
//   2. frequency q, k, v: qkv_tc on w_fqkv;
//   3. the frequency attention (attention_tc, each (row, head)'s own
//      softmax max), then freq_fc + residual.
//
// The cached time attention. Each frame reads the stream's whole K/V cache,
// [NB, L, F, C] each (321 KB a stream at DPT-B, 82.3 MB over 256 streams):
// the bytes bound the kernel. Block i's K and V slabs ([L, F, C], contiguous)
// flow through a ring of kRing chunks in shared memory, each chunk a run of
// whole slots of at most kChunkBytes, filled by cp.async.bulk on its own
// mbarrier. The chunks form one sequence over the kernel (K_0, V_0, K_1,
// V_1, ...), and a chunk is issued as soon as the chunk kRing before it
// has been read: K_i's first chunks while the stages of block i - 1 (or
// block i's time q, k, v) run, V_i's while the logits are computed, K_{i+1}'s
// while the value mix runs and through block i's last three stages. The
// products of the attention stay on the CUDA cores, as the Pallas kernel
// rounds them:
//   - logits: each q * k product rounded to bf16 (two at a time:
//     mul.rn.bf16x2 rounds each exact product as the float32 product
//     rounded to bf16 does), summed in float32 over the head's d values in
//     order, times scale, plus the slot's bias (slot s was
//     written ((ptr - 1 - s) mod L) + 1 frames ago and takes time_pe[h,
//     L - age]; the frame itself takes time_pe[h, L]: a [H, L+1] table made
//     once a frame). A thread owns one row (head h, bin f), holds its q in
//     registers, and takes every (256 / (H F))-th slot of a chunk;
//   - softmax per (row, head) over the L+1 keys in float32 with the row's
//     max, P rounded to bf16: a quad of lanes a row, the keys strided over
//     the quad, two shuffles a reduction;
//   - value mix: a float32 sum of P * V over the slots, chunk by chunk
//     (kept in float32 between chunks), plus P * v of the frame itself,
//     rounded.
// The logits are stored key-major, [L+1, ldr] floats with ldr = H F
// rounded up to 8 mod 32 banks: a warp's stores (consecutive rows) and the
// softmax's reads (8 rows x 4 keys) then fall in 32 distinct banks (a
// row-major [H F, L+1] array put every lane of the softmax on one bank).
// Then the frame's k and v are written into slot ptr of the cache in
// place.
#pragma once

#include "stack_tc.cuh"

namespace fe {

// Stacked plan of the folded dpt blocks (ops/dpt_stack.py::plan_dpt_stack),
// read by both forms. Matrices are [in, out]; NB leads every array but
// time_pe.
template <typename T>
struct DptPlan {
  const T* w_tqkv;   // [NB, 3, C, C] time q, k, v; column h*d + t = head h
  const T* b_tqkv;   // [NB, 3, C]
  const T* w_tfc;    // [NB, C, C]    time_fc (post-norm folded)
  const T* b_tfc;    // [NB, C]
  const T* w_fqkv;   // [NB, 3, C, C] frequency q, k, v
  const T* b_fqkv;   // [NB, 3, C]
  const T* w_ffc;    // [NB, C, C]    freq_fc (post-norm folded)
  const T* b_ffc;    // [NB, C]
  const T* pe;       // [NB, F, C]    zeros for blocks without an embedding
  const T* time_pe;  // [H, L+1]      relative-age bias, shared by all blocks
};

namespace tc {

// Chunks of the K/V cache in flight a thread block, and the most bytes of
// whole slots a chunk holds (ops/dpt_stack.py keeps the same numbers)
constexpr int kRing = 4;
constexpr int kChunkBytes = 16384;
// The widest head whose q a thread holds in registers (the form takes
// C / H <= kMaxD), and the most channel pairs of the frame a thread sums in
// the value mix (the form takes F C <= 2 kThreads kMaxPairs)
constexpr int kMaxD = 16;
constexpr int kMaxPairs = 4;
// The head of shared memory: the zero chunk and the ring's kRing
// mbarriers, in bf16 elements, rounded up to 16 bytes so that every tile
// behind it stays 16-byte aligned for ldmatrix (48 bytes)
constexpr int kDptHead = round8(8 + 4 * kRing);

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

// Sizes, in bf16 elements, of the tensor-core form's shared memory pieces
// (ops/dpt_stack.py::tc_smem_bytes counts the same).
struct DptGeom {
  StackGeom s;
  int lb, keys, rows, ldr, slot_el, chunk_slots, chunks, chunk_el;
  __host__ __device__ DptGeom(int freq, int ch, int heads, int lookbehind)
      : s(freq, ch, heads), lb(lookbehind), keys(lookbehind + 1),
        rows(heads * freq), ldr(heads * freq + (40 - heads * freq % 32) % 32),
        slot_el(freq * ch),
        chunk_slots(clamp(kChunkBytes / (2 * freq * ch), 1, lookbehind)),
        chunks((lookbehind + chunk_slots - 1) / chunk_slots),
        chunk_el(chunk_slots * freq * ch) {}
  __host__ __device__ static int clamp(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
  }
  // float32 [L+1, ldr] logits and the [H, L+1] slot bias, in floats
  __host__ __device__ int logits() const { return round4(keys * ldr); }
  __host__ __device__ int bias() const { return round4(s.heads * keys); }
  // the block stack's tiles, then the logits and the bias
  __host__ __device__ int act() const {
    return s.act() + 2 * (logits() + bias());
  }
  __host__ __device__ int ring() const { return kRing * chunk_el; }
  // the largest stage: q, k, v (3 [C, C] and 3C biases) or time_fc with pe
  __host__ __device__ int slot() const {
    const int qkv = 3 * s.mat() + round8(3 * s.c);
    const int tfc = s.mat() + round8(s.c) + round8(s.f * s.c);
    return qkv > tfc ? qkv : tfc;
  }
};

// The arrays of stage j (block j / 4: time qkv, time_fc, freq qkv,
// freq_fc) to the visitor v (DirectV), in slot order.
template <class V>
__device__ __forceinline__ void dpt_pieces(int j, V& v,
                                           const DptPlan<bf16>& p,
                                           const DptGeom& g) {
  const size_t i = j >> 2;
  const int c = g.s.c;
  const size_t cc = static_cast<size_t>(c) * c;
  switch (j & 3) {
    case 0:
      v.mat(p.w_tqkv + i * 3 * cc, 3 * c, c);
      v.vec(p.b_tqkv + i * 3 * c, 3 * c);
      break;
    case 1:
      v.mat(p.w_tfc + i * cc, c, c);
      v.vec(p.b_tfc + i * c, c);
      v.vec(p.pe + i * g.slot_el, g.slot_el);
      break;
    case 2:
      v.mat(p.w_fqkv + i * 3 * cc, 3 * c, c);
      v.vec(p.b_fqkv + i * 3 * c, 3 * c);
      break;
    default:
      v.mat(p.w_ffc + i * cc, c, c);
      v.vec(p.b_ffc + i * c, c);
  }
}

// The ring of cache chunks (see the note at the top). Chunk q of the
// sequence is chunk q % chunks of block q / (2 chunks)'s K slab (or, in
// the second half of the block's chunks, its V slab); it lives in ring
// entry q % kRing and completes phase (q / kRing) & 1 of that entry's
// mbarrier. Every thread keeps `issued` (the same everywhere); thread 0
// issues.
struct KvRing {
  bf16* buf;
  uint64_t* bars;
  const bf16* kc;
  const bf16* vc;
  size_t slab;    // this stream's slab of block 0: b * L * F * C
  size_t stride;  // between blocks: B * L * F * C
  int total, issued;
  __device__ __forceinline__ void issue(int q, const DptGeom& g) const {
    const int i = q / (2 * g.chunks);
    const int r = q - i * 2 * g.chunks;
    const bool is_v = r >= g.chunks;
    const int s0 = (is_v ? r - g.chunks : r) * g.chunk_slots;
    const int n = g.lb - s0 < g.chunk_slots ? g.lb - s0 : g.chunk_slots;
    const bf16* src = (is_v ? vc : kc) + i * stride + slab +
                      static_cast<size_t>(s0) * g.slot_el;
    uint64_t* bar = bars + q % kRing;
    const uint32_t bytes = static_cast<uint32_t>(n) * g.slot_el * 2;
    mbar_expect_tx(bar, bytes);
    bulk_copy(buf + (q % kRing) * g.chunk_el, src, bytes, bar);
    mbar_arrive(bar);
  }
  // issue every chunk up to consumed + kRing (consumed: the chunks every
  // thread has finished reading, behind a __syncthreads)
  __device__ __forceinline__ void fill(int consumed, const DptGeom& g) {
    const int upto = consumed + kRing < total ? consumed + kRing : total;
    if (issued >= upto) return;
    if (threadIdx.x == 0) {
      fence_proxy_async();  // after the generic reads of the entries
      for (int q = issued; q < upto; ++q) issue(q, g);
    }
    issued = upto;
  }
  __device__ __forceinline__ const bf16* wait(int q, const DptGeom& g) const {
    mbar_wait(bars + q % kRing, (q / kRing) & 1);
    return buf + (q % kRing) * g.chunk_el;
  }
};

// Block i's cached time attention on the frame's head-padded q, k, v
// (t.qs, t.ks, t.vs): the output, rounded, to t.qs as an [F, ldc] tile,
// then the frame's k and v to kslot and vslot (slot ptr of block i's K and
// V slabs, [F, C]). lg: the [L+1, ldr] logits; bias: the [H, L+1] slot
// bias. Ends with the global writes, without a barrier.
__device__ __forceinline__ void time_attention_tc(
    int i, KvRing& ring, const StackTiles& t, float* lg, const float* bias,
    const DptGeom& g, float scale, bf16* kslot, bf16* vslot) {
  const StackGeom& s = g.s;
  const int f = s.f, c = s.c, d = s.d, lb = g.lb, keys = g.keys;
  const int rows = g.rows, ldr = g.ldr;
  // thread -> row r = h F + bin, and the slots sp, sp + per, ... of a chunk
  const int per = kThreads / rows;
  const int sp = threadIdx.x / rows;
  const int r = threadIdx.x - sp * rows;
  const bool active = sp < per;
  const int hh = r / f;
  const int ff = r - hh * f;
  const int qo = ff * s.ldq + hh * s.dp;
  // the row's q as bf16 pairs (zero past d: k's run continues into the
  // next head); q * k two products at a time, each rounded to bf16
  uint32_t q2[kMaxD / 2];
#pragma unroll
  for (int u = 0; u < kMaxD / 2; ++u) {
    const uint32_t w =
        active && 2 * u < d
            ? *reinterpret_cast<const uint32_t*>(t.qs + qo + 2 * u)
            : 0u;
    q2[u] = 2 * u + 1 < d ? w : (w & 0xffffu);
  }
  // k's pair u; past d (odd d) the high half is masked, since the value
  // there may be stale shared memory and 0 * NaN is NaN
  const auto pair = [d](const bf16* k, int u) {
    const uint32_t w =
        static_cast<uint32_t>(__bfloat16_as_ushort(k[2 * u])) |
        (static_cast<uint32_t>(__bfloat16_as_ushort(k[2 * u + 1])) << 16);
    return 2 * u + 1 < d ? w : (w & 0xffffu);
  };
  // the logits of keys k0 and k1 (k1 may be null), summed in order over d
  const auto dot2 = [&](const bf16* k0, const bf16* k1, float& a0,
                        float& a1) {
    a0 = a1 = 0.f;
#pragma unroll
    for (int u = 0; u < kMaxD / 2; ++u) {
      if (2 * u >= d) break;
      const uint32_t p0 = mul_bf16x2(q2[u], pair(k0, u));
      a0 += lo_bf16(p0);
      a0 += hi_bf16(p0);
      if (k1) {
        const uint32_t p1 = mul_bf16x2(q2[u], pair(k1, u));
        a1 += lo_bf16(p1);
        a1 += hi_bf16(p1);
      }
    }
  };
  const float* brow = bias + hh * keys;
  // the frame's own key (index L) needs no cache
  if (active && sp == 0) {
    float a0, a1;
    dot2(t.ks + qo, nullptr, a0, a1);
    lg[lb * ldr + r] = a0 * scale + brow[lb];
  }
  const int koff = ff * c + hh * d;  // the row's run in a slot
  const int q0 = i * 2 * g.chunks;
  for (int ci = 0; ci < g.chunks; ++ci) {
    const bf16* kch = ring.wait(q0 + ci, g);
    const int s0 = ci * g.chunk_slots;
    const int n = lb - s0 < g.chunk_slots ? lb - s0 : g.chunk_slots;
    if (active) {
      for (int sl = sp; sl < n; sl += 2 * per) {
        const bool two = sl + per < n;
        float a0, a1;
        dot2(kch + sl * g.slot_el + koff,
             two ? kch + (sl + per) * g.slot_el + koff : nullptr, a0, a1);
        lg[(s0 + sl) * ldr + r] = a0 * scale + brow[s0 + sl];
        if (two) lg[(s0 + sl + per) * ldr + r] = a1 * scale + brow[s0 + sl + per];
      }
    }
    __syncthreads();
    ring.fill(q0 + ci + 1, g);
  }
  // softmax of each row over the L+1 keys: 8 rows a warp, a quad of lanes
  // a row
  {
    const int lane = threadIdx.x & 31;
    const int qd = lane & 3;
    for (int r0 = (threadIdx.x >> 5) * 8; r0 < rows; r0 += kWarps * 8) {
      const int row = r0 + (lane >> 2);
      const bool ok = row < rows;
      float* col = lg + row;
      float mx = -INFINITY;
      if (ok) {
        for (int k = qd; k < keys; k += 4) mx = fmaxf(mx, col[k * ldr]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      float den = 0.f;
      if (ok) {
        for (int k = qd; k < keys; k += 4) {
          const float ev = expf(col[k * ldr] - mx);
          col[k * ldr] = ev;
          den += ev;
        }
      }
      den += __shfl_xor_sync(0xffffffffu, den, 1);
      den += __shfl_xor_sync(0xffffffffu, den, 2);
      if (ok) {
        for (int k = qd; k < keys; k += 4) {
          col[k * ldr] = rnd(col[k * ldr] / den);
        }
      }
    }
  }
  __syncthreads();
  // value mix: thread -> the channel pairs (2p, 2p + 1) of the frame's
  // [F, C] for p = tid + k * kThreads; both channels' probabilities and
  // float32 sums in registers across the chunks
  const int pairs = f * c / 2;
  int pcol[kMaxPairs][2];  // the channel's column of lg: h F + bin
  float acc[kMaxPairs][2] = {};
#pragma unroll
  for (int k = 0; k < kMaxPairs; ++k) {
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int e = 2 * (threadIdx.x + k * kThreads) + h2;
      const int fr = e / c;
      const int j = e - fr * c;
      pcol[k][h2] = static_cast<int>((j * s.dmag) >> 20) * f + fr;
    }
  }
  for (int ci = 0; ci < g.chunks; ++ci) {
    const int q = q0 + g.chunks + ci;
    const bf16* vch = ring.wait(q, g);
    const int s0 = ci * g.chunk_slots;
    const int n = lb - s0 < g.chunk_slots ? lb - s0 : g.chunk_slots;
    for (int sl = 0; sl < n; ++sl) {
      const float* prow = lg + (s0 + sl) * ldr;
      const uint32_t* vrow =
          reinterpret_cast<const uint32_t*>(vch + sl * g.slot_el);
#pragma unroll
      for (int k = 0; k < kMaxPairs; ++k) {
        const int p = threadIdx.x + k * kThreads;
        if (p >= pairs) break;
        const uint32_t v2 = vrow[p];
        acc[k][0] = fmaf(prow[pcol[k][0]], lo_bf16(v2), acc[k][0]);
        acc[k][1] = fmaf(prow[pcol[k][1]], hi_bf16(v2), acc[k][1]);
      }
    }
    __syncthreads();
    ring.fill(q + 1, g);
  }
  // plus the frame's own value, rounded: the attention output as an
  // [F, ldc] tile in t.qs
#pragma unroll
  for (int k = 0; k < kMaxPairs; ++k) {
    const int p = threadIdx.x + k * kThreads;
    if (p >= pairs) break;
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int e = 2 * p + h2;
      const int fr = e / c;
      const int j = e - fr * c;
      const int h = pcol[k][h2] / f;
      const float v = fmaf(lg[lb * ldr + pcol[k][h2]],
                           bf(t.vs[fr * s.ldq + h * s.dp + j - h * d]),
                           acc[k][h2]);
      t.qs[fr * s.ldc + j] = __float2bfloat16_rn(v);
    }
  }
  // The frame's k and v into slot ptr, in place: the one hazard this design
  // adds. The ring's bulk copies read the cache from device memory
  // asynchronously, so slot ptr may be overwritten only once the ring's
  // copy of it has landed and been read: every chunk of block i's K and V
  // slabs was waited for above, and every chunk issued since reads block
  // i + 1's slabs.
  for_tile(f, c, [&](int fr, int j, int e) {
    const int h = static_cast<int>((j * s.dmag) >> 20);
    const int o = fr * s.ldq + h * s.dp + j - h * d;
    kslot[e] = t.ks[o];
    vslot[e] = t.vs[o];
  });
}

// Stage j (block j / 4) on its slot w; the attentions run before stages 1
// and 3 (the caller's pre). The caller synchronises after it.
__device__ __forceinline__ void dpt_stage(int j, const bf16* w,
                                          const StackTiles& t,
                                          const DptGeom& g,
                                          const bf16* zero) {
  const StackGeom& s = g.s;
  switch (j & 3) {
    case 1:  // time_fc + residual, then pe
      fc_residual_tc<true>(t.qs, s.ldc, s.c, t.xs, w, w + s.mat(),
                           w + s.mat() + round8(s.c), s, zero);
      break;
    case 3:  // freq_fc + residual
      fc_residual_tc<false>(t.qs, s.ldc, s.c, t.xs, w, w + s.mat(), nullptr,
                            s, zero);
      break;
    default:  // time or frequency q, k, v
      qkv_tc(t, w, s, zero);
  }
}

}  // namespace tc
}  // namespace fe
