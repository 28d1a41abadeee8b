// Tensor-core device code for the bfloat16 forms of the block stack
// (rnnformer_stack.cu), the whole frame (fused_frame.cu), the BSRNN stack
// (band_tc.cuh) and the dprnn and dpt stacks (dprnn_tc.cuh, dpt_tc.cuh) on
// Hopper (sm_90a): a block-level product on mma.sync, and shared memory
// slots that asynchronous copies fill with the next phase's weights while
// the current phase computes.
//
// The product. Y[M x N] = sum of terms A[M x K] . B[K x N], A and B bf16 in
// shared memory, float32 accumulation, on
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32. The output's 16x8
// tiles are shared out over the block's 8 warps; each warp walks K in steps
// of 16 with ldmatrix fragments: A row-major (x4), or a weight [K, M] used
// as A (x4.trans), B row-major [K, N] (x2.trans), or keys [N, K] as B (x2).
// Every tile has a padded row stride (ld a multiple of 8 with ld / 8 odd,
// so the 8 rows of one ldmatrix matrix fall in 8 distinct 16-byte bank
// groups). The epilogue is a functor called on every (row, col, acc)
// inside M x N, so bias, rounding to bf16, residual and SiLU happen in
// registers at the plain version's points. Nothing is padded with zeros in
// memory:
//   - a fragment row outside its operand (an A row >= M, or shifted out of
//     range by a conv tap; a B row >= K) is read from a 16-byte chunk of
//     zeros, so a conv's halo and the K padding of B are exact zeros;
//   - the columns of a row-major A fragment past K (K not a multiple of
//     16) are zeroed in the registers after ldmatrix, so stale shared
//     memory (even a NaN bit pattern) never meets the zero rows of B;
//   - columns of B past N and rows of A past M only reach outputs outside
//     M x N, which the epilogue never sees.
//
// The stages. Each phase's weights and biases (a stage) are copied from
// the plans' row-major [in, out] arrays as they are: each contiguous array
// whose address and size are multiples of 16 bytes is one cp.async.bulk
// copy, started by thread 0 and counted on an mbarrier (expect_tx /
// complete_tx), the others (short biases) per-thread cp.async chunks of
// 16, 8 or 4 bytes as their alignment allows, all into one staging buffer,
// while the phase before computes. When the phase before is done, one pass
// over shared memory moves the stage into the weight slot with padded rows
// (ldmatrix needs 16-byte aligned rows, which a row of 36 bf16 values is
// not) and the next stage's copies start (run_stages). run_stages_direct
// skips the staging buffer and the move: every thread copies its share of
// the next stage straight into the padded rows of the other of two slots.
// Every call below is made by all threads of the block.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "stack_common.cuh"

namespace fe {
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kWarps = kThreads / 32;

// x rounded up to a multiple of 8 (16 bytes of bf16)
__host__ __device__ constexpr int round8(int x) { return (x + 7) & ~7; }

// Row stride (elements) of a bf16 tile n wide in shared memory: a multiple
// of 8 with an odd number of 16-byte chunks, so ldmatrix's 8 row reads hit
// 8 bank groups.
__host__ __device__ constexpr int ld_of(int n) {
  return (round8(n) / 8) % 2 ? round8(n) : round8(n) + 8;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers and asynchronous copies into shared memory
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(1));
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::);
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  uint64_t state;
  asm volatile("mbarrier.arrive.shared::cta.b64 %0, [%1];\n"
               : "=l"(state)
               : "r"(smem_u32(bar)));
  (void)state;
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity));
}

// the async proxy (bulk copies) after the generic proxy's last reads of a
// slot
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::);
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "n"(kBytes));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Chunk e = r * per + c of each thread, stepping (r, c) without a
// division per chunk.
template <int kBytes>
__device__ __forceinline__ void copy_rows_async(bf16* dst, int ld,
                                                const bf16* src, int rows,
                                                int cols) {
  const int per = cols * 2 / kBytes;
  const auto* s = reinterpret_cast<const char*>(src);
  auto* d = reinterpret_cast<char*>(dst);
  const int dr = kThreads / per, dc = kThreads - dr * per;
  int r = threadIdx.x / per;
  int c = threadIdx.x - r * per;
  for (; r < rows; r += dr) {
    cp_async<kBytes>(d + (static_cast<size_t>(r) * ld * 2 + c * kBytes),
                     s + (static_cast<size_t>(r) * cols * 2 + c * kBytes));
    c += dc;
    if (c >= per) {
      c -= per;
      ++r;
    }
  }
}

// dst[r * ld + c] = src[r * cols + c] for r < rows, c < cols: global rows
// (contiguous) into a shared tile with stride ld (a multiple of 8; dst
// 16-byte aligned), per-thread cp.async chunks as wide as the source
// address and the row length allow, plain copies for a 2-byte-aligned
// source. Visible to the block after cp_async_wait and __syncthreads.
__device__ __forceinline__ void stage_rows(bf16* dst, int ld, const bf16* src,
                                           int rows, int cols) {
  const auto a = static_cast<unsigned>(reinterpret_cast<uintptr_t>(src)) |
                 static_cast<unsigned>(cols * 2);
  if ((a & 15) == 0) {
    copy_rows_async<16>(dst, ld, src, rows, cols);
  } else if ((a & 7) == 0) {
    copy_rows_async<8>(dst, ld, src, rows, cols);
  } else if ((a & 3) == 0) {
    copy_rows_async<4>(dst, ld, src, rows, cols);
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += blockDim.x) {
      const int r = e / cols;
      dst[static_cast<size_t>(r) * ld + (e - r * cols)] = src[e];
    }
  }
}

// dst[r * ld + c] = src[r * src_ld + c] for r < rows, c < cols: rows at a
// stride of src_ld elements (one stream's rows of a frequency-major
// [F, B, C] array), per-thread cp.async chunks as wide as the address, the
// row length and the stride allow (8 bytes for the 72-byte rows of an odd
// stream at C = 36), plain copies for a 2-byte-aligned source. Visible to
// the block after cp_async_wait and __syncthreads.
template <int kBytes>
__device__ __forceinline__ void copy_strided_async(bf16* dst, int ld,
                                                   const bf16* src,
                                                   size_t src_ld, int rows,
                                                   int cols) {
  const int per = cols * 2 / kBytes;
  for (int e = threadIdx.x; e < rows * per; e += kThreads) {
    const int r = e / per;
    const int c = e - r * per;
    cp_async<kBytes>(
        reinterpret_cast<char*>(dst + static_cast<size_t>(r) * ld) +
            c * kBytes,
        reinterpret_cast<const char*>(src + r * src_ld) + c * kBytes);
  }
}

__device__ __forceinline__ void stage_rows_strided(bf16* dst, int ld,
                                                   const bf16* src,
                                                   size_t src_ld, int rows,
                                                   int cols) {
  const auto a = static_cast<unsigned>(reinterpret_cast<uintptr_t>(src)) |
                 static_cast<unsigned>(cols * 2) |
                 static_cast<unsigned>(src_ld * 2);
  if ((a & 15) == 0) {
    copy_strided_async<16>(dst, ld, src, src_ld, rows, cols);
  } else if ((a & 7) == 0) {
    copy_strided_async<8>(dst, ld, src, src_ld, rows, cols);
  } else if ((a & 3) == 0) {
    copy_strided_async<4>(dst, ld, src, src_ld, rows, cols);
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += blockDim.x) {
      const int r = e / cols;
      dst[static_cast<size_t>(r) * ld + (e - r * cols)] =
          src[r * src_ld + (e - r * cols)];
    }
  }
}

// n contiguous values into dst (16-byte aligned): one bulk copy by thread 0
// on `bar` when the source address and the size are multiples of 16 bytes,
// else per-thread chunks. Returns dst + n rounded up to 16 bytes: where the
// next array of a stage goes.
__device__ __forceinline__ bf16* stage_flat(bf16* dst, const bf16* src,
                                            int n, uint64_t* bar) {
  const unsigned bytes = static_cast<unsigned>(n) * 2;
  if (((static_cast<unsigned>(reinterpret_cast<uintptr_t>(src)) | bytes) &
       15) == 0) {
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar, bytes);
      bulk_copy(dst, src, bytes, bar);
    }
  } else {
    stage_rows(dst, round8(n), src, 1, n);
  }
  return dst + round8(n);
}

template <typename W>
__device__ __forceinline__ void move_words(bf16* dst, int ld, const bf16* src,
                                           int rows, int cols) {
  const int per = cols * 2 / static_cast<int>(sizeof(W));
  const int dr = kThreads / per, dc = kThreads - dr * per;
  int r = threadIdx.x / per;
  int c = threadIdx.x - r * per;
  for (; r < rows; r += dr) {
    reinterpret_cast<W*>(dst + static_cast<size_t>(r) * ld)[c] =
        reinterpret_cast<const W*>(src + static_cast<size_t>(r) * cols)[c];
    c += dc;
    if (c >= per) {
      c -= per;
      ++r;
    }
  }
}

// dst[r * ld + c] = src[r * cols + c], shared to shared (src 16-byte
// aligned), in the widest words the row length allows
__device__ __forceinline__ void move_rows(bf16* dst, int ld, const bf16* src,
                                          int rows, int cols) {
  if (cols % 4 == 0) {
    move_words<uint2>(dst, ld, src, rows, cols);
  } else if (cols % 2 == 0) {
    move_words<uint32_t>(dst, ld, src, rows, cols);
  } else {
    move_words<uint16_t>(dst, ld, src, rows, cols);
  }
}

// The two visitors of a stage's arrays, in the order the stage lists them
// (mat: a [rows, cols] matrix, padded to ld_of(cols) in the slot; vec: n
// values). LoadV copies each from global memory into the staging buffer,
// packed; MoveV moves each from there to the slot.
struct LoadV {
  bf16* at;
  uint64_t* bar;
  __device__ __forceinline__ void mat(const bf16* src, int rows, int cols) {
    at = stage_flat(at, src, rows * cols, bar);
  }
  __device__ __forceinline__ void vec(const bf16* src, int n) {
    at = stage_flat(at, src, n, bar);
  }
};

struct MoveV {
  const bf16* from;
  bf16* to;
  __device__ __forceinline__ void mat(const bf16*, int rows, int cols) {
    move_rows(to, ld_of(cols), from, rows, cols);
    from += round8(rows * cols);
    to += rows * ld_of(cols);
  }
  __device__ __forceinline__ void vec(const bf16*, int n) {
    move_rows(to, round8(n), from, 1, n);
    from += round8(n);
    to += round8(n);
  }
};

// Runs `stages` stages: for stage s, pre(s) (work that needs no weights),
// then its weights moved from the staging buffer into the slot, then stage
// s + 1's copies started (pieces(s + 1, LoadV&) and side(s + 1), the
// per-thread copies of activations that stage needs), then compute(s,
// slot). Every piece of code is called from one place, so all of it is
// inlined. bar must be initialised (mbar_init) and visible to the block.
template <class Pieces, class Side, class Pre, class Compute>
__device__ __forceinline__ void run_stages(int stages, bf16* staging,
                                           bf16* slot, uint64_t* bar,
                                           const Pieces& pieces,
                                           const Side& side, const Pre& pre,
                                           const Compute& compute) {
  for (int s = -1; s < stages; ++s) {
    if (s >= 0) {
      pre(s);
      cp_async_wait<0>();
      mbar_wait(bar, s & 1);
      __syncthreads();
      MoveV mv{staging, slot};
      pieces(s, mv);
      __syncthreads();
    }
    if (s + 1 < stages) {
      LoadV lv{staging, bar};
      if (threadIdx.x == 0) fence_proxy_async();
      pieces(s + 1, lv);
      side(s + 1);
      if (threadIdx.x == 0) mbar_arrive(bar);
      cp_async_commit();
    }
    if (s >= 0) {
      compute(s, static_cast<const bf16*>(slot));
      __syncthreads();
    }
  }
}

// The third visitor: each array straight from global memory into its slot
// with padded rows (ld_of(cols) for a matrix, round8(n) for a vector, the
// layout MoveV leaves), per-thread cp.async chunks as wide as the
// alignment allows (stage_rows).
struct DirectV {
  bf16* to;
  __device__ __forceinline__ void mat(const bf16* src, int rows, int cols) {
    stage_rows(to, ld_of(cols), src, rows, cols);
    to += rows * ld_of(cols);
  }
  __device__ __forceinline__ void vec(const bf16* src, int n) {
    stage_rows(to, round8(n), src, 1, n);
    to += round8(n);
  }
};

// run_stages without the staging buffer: two slots in turn, each stage's
// arrays copied by every thread straight into its slot's padded rows
// (DirectV) a stage ahead, so no pass moves them and no thread issues all
// the copies. For stage s: pre(s); stage s + 1's copies into the other
// slot (its last reader, compute(s - 1), finished behind the barrier after
// it) and side(s + 1); wait for stage s's copies; compute(s, slot). Two
// barriers a stage (run_stages has three and a move pass). The slots take
// the largest stage padded twice, where run_stages takes it padded once
// and packed once.
template <class Pieces, class Side, class Pre, class Compute>
__device__ __forceinline__ void run_stages_direct(int stages, bf16* slot0,
                                                  bf16* slot1,
                                                  const Pieces& pieces,
                                                  const Side& side,
                                                  const Pre& pre,
                                                  const Compute& compute) {
  DirectV first{slot0};
  pieces(0, first);
  side(0);
  cp_async_commit();
  for (int s = 0; s < stages; ++s) {
    pre(s);
    if (s + 1 < stages) {
      DirectV next{(s & 1) ? slot0 : slot1};
      pieces(s + 1, next);
      side(s + 1);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    compute(s, static_cast<const bf16*>((s & 1) ? slot1 : slot0));
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// Fragments and the mma
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(p));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(p));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(p));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2],
                                              uint32_t p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(p));
}

// acc += a (16x16, row) . b (16x8, col), float32 accumulators
__device__ __forceinline__ void mma_bf16(float (&acc)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The operands below hold 32-bit shared-memory addresses (fewer registers
// and address instructions than generic pointers); `zero` is the address
// of the 16-byte chunk of zeros.

// A tile as A, row-major: A[r][c] = p[(r + shift) * ld + c] for
// 0 <= r + shift < rows, c < k; zero elsewhere (rows through the zero
// chunk, columns >= k masked in the registers).
struct AOp {
  uint32_t p;
  int ld, rows, k, shift;
  __device__ __forceinline__ AOp(const bf16* ptr, int ld_, int rows_, int k_,
                                 int shift_)
      : p(smem_u32(ptr)), ld(ld_), rows(rows_), k(k_), shift(shift_) {}
  __device__ __forceinline__ void load(uint32_t (&f)[4], int m0, int k0,
                                       uint32_t zero) const {
    const int lane = threadIdx.x & 31;
    const int r = m0 + (lane & 15) + shift;
    const int c = k0 + (lane >> 4) * 8;
    ldsm_x4(f, r >= 0 && r < rows && c < k ? p + 2 * (r * ld + c) : zero);
    if (k0 + 16 > k) {
      const int kk = k0 + 2 * (lane & 3);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int kq = kk + (q >> 1) * 8;
        f[q] &= (kq < k ? 0x0000ffffu : 0u) | (kq + 1 < k ? 0xffff0000u : 0u);
      }
    }
  }
};

// A weight [K, M] ([in, out]) used as A, i.e. A = W^T: A[r][c] =
// p[c * ld + r] for r < m, c < k (rows of the store >= k come from the
// zero chunk; columns >= m reach only discarded outputs).
struct ATOp {
  uint32_t p;
  int ld, m, k;
  __device__ __forceinline__ ATOp(const bf16* ptr, int ld_, int m_, int k_)
      : p(smem_u32(ptr)), ld(ld_), m(m_), k(k_) {}
  __device__ __forceinline__ void load(uint32_t (&f)[4], int m0, int k0,
                                       uint32_t zero) const {
    const int lane = threadIdx.x & 31;
    const int mat = lane >> 3;
    const int kk = k0 + (lane & 7) + (mat >> 1) * 8;
    const int mm = m0 + (mat & 1) * 8;
    ldsm_x4_trans(f, kk < k && mm < m ? p + 2 * (kk * ld + mm) : zero);
  }
};

// A tile as B, row-major [K, N] (a weight, or an activation):
// B[r][c] = p[r * ld + c], rows >= k from the zero chunk.
struct BOp {
  uint32_t p;
  int ld, k;
  __device__ __forceinline__ BOp(const bf16* ptr, int ld_, int k_)
      : p(smem_u32(ptr)), ld(ld_), k(k_) {}
  __device__ __forceinline__ void load(uint32_t (&f)[2], int k0, int n0,
                                       uint32_t zero) const {
    const int kk = k0 + (threadIdx.x & 15);
    ldsm_x2_trans(f, kk < k ? p + 2 * (kk * ld + n0) : zero);
  }
};

// The keys as B of q.k^T: an activation tile [N, K] row-major,
// B[r][c] = p[c * ld + r] for r < k, c < n; rows of the store >= n and
// 8-column chunks at or past k come from the zero chunk (the A side masks
// the columns past k inside a chunk).
struct BTOp {
  uint32_t p;
  int ld, n, k;
  __device__ __forceinline__ BTOp(const bf16* ptr, int ld_, int n_, int k_)
      : p(smem_u32(ptr)), ld(ld_), n(n_), k(k_) {}
  __device__ __forceinline__ void load(uint32_t (&f)[2], int k0, int n0,
                                       uint32_t zero) const {
    const int lane = threadIdx.x & 31;
    const int nn = n0 + (lane & 7);
    const int kk = k0 + ((lane >> 3) & 1) * 8;
    ldsm_x2(f, nn < n && kk < k ? p + 2 * (nn * ld + kk) : zero);
  }
};

// Output tiles one warp holds at a time: up to kMaxNT 16x8 tiles along N,
// independent accumulation chains that share each A fragment.
constexpr int kMaxNT = 2;

// acc[j] += A[m0:m0+16, :] . B[:, n0+8j:n0+8j+8] for j < cnt, over the
// term's K
template <class A, class B>
__device__ __forceinline__ void mma_tiles(float (&acc)[kMaxNT][4], const A& a,
                                          const B& b, int m0, int n0,
                                          int cnt, const bf16* zero_ptr) {
  const uint32_t zero = smem_u32(zero_ptr);
  for (int k0 = 0; k0 < b.k; k0 += 16) {
    uint32_t fa[4];
    a.load(fa, m0, k0, zero);
#pragma unroll
    for (int j = 0; j < kMaxNT; ++j) {
      if (j >= cnt) break;
      uint32_t fb[2];
      b.load(fb, k0, n0 + 8 * j, zero);
      mma_bf16(acc[j], fa, fb);
    }
  }
}

// Tasks of `cnt` n-tiles (cnt <= g, g the fewest that keeps the tasks
// within one round of the 8 warps, at most kMaxNT) for each of `groups`
// products of M x N outputs, in turn over the warps: prod(grp, acc, m0, n0,
// cnt) adds every term of the task's tiles into acc (mma_tiles), then
// ep(grp, row, col, acc) runs on each output inside M x N. The caller
// synchronises before reading outputs.
template <class Prod, class Ep>
__device__ __forceinline__ void gemm(int groups, int m, int n,
                                     const Prod& prod, const Ep& ep) {
  const int lane = threadIdx.x & 31;
  const int mt = (m + 15) / 16;
  const int nt = (n + 7) / 8;
  const int rows = groups * mt;  // (group, m-tile) pairs
  const int per_row = rows >= kWarps ? 1 : kWarps / rows;
  int g = (nt + per_row - 1) / per_row;
  g = g > kMaxNT ? kMaxNT : g;
  const int chunks = (nt + g - 1) / g;
  for (int task = threadIdx.x >> 5; task < rows * chunks; task += kWarps) {
    const int row = task / chunks;
    const int chunk = task - row * chunks;
    const int grp = row / mt;
    const int m0 = (row - grp * mt) * 16;
    const int n0 = chunk * g * 8;
    const int cnt = nt - chunk * g < g ? nt - chunk * g : g;
    float acc[kMaxNT][4] = {};
    prod(grp, acc, m0, n0, cnt);
#pragma unroll
    for (int j = 0; j < kMaxNT; ++j) {
      if (j >= cnt) break;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = m0 + (lane >> 2) + (q >> 1) * 8;
        const int c = n0 + 8 * j + 2 * (lane & 3) + (q & 1);
        if (r < m && c < n) ep(grp, r, c, acc[j][q]);
      }
    }
  }
}

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }
// The two products of bf16 pairs a and b (low halves, high halves), each
// rounded to bf16 as one bf16 multiply rounds the exact product: the same
// value as the float32 product (exact for bf16 operands) rounded to bf16.
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
// a bf16 pair's low and high halves as floats
__device__ __forceinline__ float lo_bf16(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_bf16(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// tanh and sigmoid on the MUFU unit, one tanh.approx.f32 each
// (sigmoid(v) = (1 + tanh(v / 2)) / 2): at most 2^-11 relative error, an
// eighth of a bf16 ulp. The recurrent cells (band_tc.cuh, dprnn_tc.cuh)
// take them: with the accurate expf, division and tanhf (an exp and a
// reciprocal a function) the BSRNN sweep's cells were bound by the MUFU
// unit's 16 operations a clock.
__device__ __forceinline__ float tanh_fast(float v) {
  float r;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(r) : "f"(v));
  return r;
}
__device__ __forceinline__ float sigmoid_fast(float v) {
  return fmaf(0.5f, tanh_fast(0.5f * v), 0.5f);
}

__device__ __forceinline__ float rnd(float v) { return round_t<bf16>(v); }

// SiLU at the plain version's points: the sum rounded, SiLU in float32,
// rounded
__device__ __forceinline__ float silu_r(float acc) {
  const float v = rnd(acc);
  return rnd(v * sigmoid_f(v));
}

}  // namespace tc
}  // namespace fe
