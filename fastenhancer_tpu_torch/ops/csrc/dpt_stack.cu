// The dptransformer block stack for one streaming frame, as one CUDA kernel
// for Hopper (sm_90a). ops/_build.py compiles this file with nvcc into a
// shared library with a plain C interface; ops/dpt_stack.py loads it with
// ctypes and launches it on PyTorch's current stream.
//
// Replaces fastenhancer_tpu/ops/dpt_stack.py::dpt_stack_step, the Pallas TPU
// kernel, for the folded block form. Per block:
//   q, k, v = x W_tqkv                     (the frame's time projections)
//   time attention of each (stream, bin) row over its L cached slots and
//     itself, logits q.k * scale + time_pe[h, L - age], softmax per
//     (row, head) over the L+1 keys, value mix
//   x = x + time_fc(attn) ; x = x + pe[i]
//   x = x + freq_fc(MHSA over the F frequency rows of each stream)
// and the frame's k, v go into slot ptr of the cache. Matmuls and sums
// accumulate in float32, softmaxes are float32, and results are rounded to
// the activation type T where the Pallas kernel rounds: q/k/v, the time
// attention's q*k products (an elementwise product in T there), the
// probabilities, the attention outputs, fc outputs and residual sums.
//
// The rotating-slot algorithm (ops/dpt_stack.py's docstring): slot s was
// written ((ptr - 1 - s) mod L) + 1 frames ago; the kernel computes that
// age itself from ptr, which it reads from device memory, so the host never
// waits. Each thread block reads every slot of its stream, including slot
// ptr (the oldest frame, still in this frame's window), before it writes
// the frame's k and v into slot ptr IN PLACE; the wrapper documents that kc
// and vc are updated in place. Thread block 0 writes (ptr + 1) mod L to
// ptr_out, a separate buffer, since every block reads ptr.
//
// Frequency MHSA: each (head, query) row's softmax takes its own max (as in
// rnnformer_stack.cu), where the Pallas kernel takes the max across heads.
//
// What bounds it on the H100. At DPT-B in bf16 with B=256 streams (F=24,
// C=36, H=4, NB=3, L=31) the K/V cache is 2*3*31*256*24*36*2 B = 82.3 MB
// and every frame reads all of it: about 25 us at 3.35 TB/s, against about
// 0.5 GFLOP of arithmetic. The kernel is bound by those bytes. The cache
// is [NB, B, L, F, C], so one stream's slice of one block is one
// contiguous run, read from device memory once per frame; only the
// frame's own slot is written. One thread block per stream, in two forms:
//   - float32 (the card's correctness reference) and the shapes the
//     tensor-core form does not take: scalar FMA chains with the weights
//     read from global memory (stack_common.cuh); the cache is read by
//     plain loads inside the compute loops, neighbouring threads on
//     neighbouring addresses, nothing in flight ahead of its use;
//   - bfloat16 where a slot's F*C*2 bytes are a multiple of 16 (DPT-T/B/S):
//     dpt_tc.cuh. The products on the tensor cores through stack_tc.cuh's
//     stages, and the cache streamed through a ring of shared-memory
//     chunks by bulk copies on mbarriers, issued as far ahead as the ring
//     allows: block i + 1's keys while block i's products run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

#include "dpt_tc.cuh"
#include "stack_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using fe::DptPlan;
using fe::kThreads;
using fe::load_f;
using fe::round_t;
using fe::store_t;

template <typename T>
__global__ void __launch_bounds__(kThreads, fe::kMinBlocks)
    dpt_stack_kernel(const T* __restrict__ x, T* kc, T* vc,
                     const int* __restrict__ ptr_in, T* __restrict__ x_out,
                     int* __restrict__ ptr_out, DptPlan<T> p, int batch,
                     int freq, int ch, int heads, int nblocks, int lookbehind,
                     float scale) {
  extern __shared__ float smem[];
  const int fc = freq * ch;
  const int d = ch / heads;
  const int lb = lookbehind;
  const int n_keys = lb + 1;
  const size_t cc = static_cast<size_t>(ch) * ch;
  float* xs = smem;     // [F, C] activations
  float* qs = xs + fc;  // [F, C] queries, then the attention output
  float* ks = qs + fc;  // [F, C] this frame's keys
  float* vs = ks + fc;  // [F, C] this frame's values
  float* ps = vs + fc;  // [H, F, L+1] or [H, F, F] logits, probabilities
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  // taken mod L, so no pointer value can send a write outside the slab
  const int ptr = (*ptr_in % lookbehind + lookbehind) % lookbehind;

  for (int e = tid; e < fc; e += nt) {
    xs[e] = load_f(x[static_cast<size_t>(b) * fc + e]);
  }
  if (b == 0 && tid == 0) *ptr_out = (ptr + 1) % lb;
  __syncthreads();

  for (int i = 0; i < nblocks; ++i) {
    // this stream's L slots of block i: [L, F, C], contiguous
    const size_t slab = (static_cast<size_t>(i) * batch + b) * lb * fc;
    T* kcache = kc + slab;
    T* vcache = vc + slab;

    // --- the frame's time q, k, v ---
    fe::qkv_rows<T>(xs, qs, ks, vs, p.w_tqkv + i * 3 * cc,
                    p.b_tqkv + static_cast<size_t>(i) * 3 * ch, freq, ch);
    __syncthreads();

    // --- logits[h, f, s] = sum_t round_T(q * k) * scale + bias ---
    // thread e -> (s, f, h), h fastest: neighbouring threads read
    // neighbouring d-runs of the cache
    for (int e = tid; e < n_keys * freq * heads; e += nt) {
      const int s = e / (freq * heads);
      const int r = e - s * freq * heads;
      const int f = r / heads;
      const int hh = r - f * heads;
      const float* q = qs + f * ch + hh * d;
      float acc = 0.f;
      int col;  // time_pe column of this key
      if (s < lb) {
        const T* k = kcache + static_cast<size_t>(s) * fc + f * ch + hh * d;
        for (int t = 0; t < d; ++t) acc += round_t<T>(q[t] * load_f(k[t]));
        const int age = ((ptr - 1 - s) % lb + lb) % lb + 1;
        col = lb - age;
      } else {
        const float* k = ks + f * ch + hh * d;
        for (int t = 0; t < d; ++t) acc += round_t<T>(q[t] * k[t]);
        col = lb;
      }
      ps[(static_cast<size_t>(hh) * freq + f) * n_keys + s] =
          acc * scale + load_f(p.time_pe[hh * n_keys + col]);
    }
    __syncthreads();
    fe::softmax_rows<T>(ps, heads * freq, n_keys);
    __syncthreads();

    // --- value mix: out[f, j] = sum_s P[head(j), f, s] * v_s[f, j] ---
    for (int e = tid; e < fc; e += nt) {
      const int f = e / ch;
      const int j = e - f * ch;
      const float* prow = ps + (static_cast<size_t>(j / d) * freq + f) * n_keys;
      float acc = 0.f;
      for (int s = 0; s < lb; ++s) {
        acc = fmaf(prow[s], load_f(vcache[static_cast<size_t>(s) * fc + e]),
                   acc);
      }
      acc = fmaf(prow[lb], vs[e], acc);
      qs[e] = round_t<T>(acc);
    }
    __syncthreads();  // every read of slot ptr is done

    // --- the frame's k, v into slot ptr; time_fc + residual; pe ---
    {
      T* kslot = kcache + static_cast<size_t>(ptr) * fc;
      T* vslot = vcache + static_cast<size_t>(ptr) * fc;
      for (int e = tid; e < fc; e += nt) {
        kslot[e] = store_t<T>(ks[e]);
        vslot[e] = store_t<T>(vs[e]);
      }
    }
    fe::fc_residual<T>(qs, xs, p.w_tfc + i * cc,
                       p.b_tfc + static_cast<size_t>(i) * ch, freq, ch);
    {
      const T* pe = p.pe + static_cast<size_t>(i) * fc;
      for (int e = tid; e < fc; e += nt) {
        xs[e] = round_t<T>(xs[e] + load_f(pe[e]));
      }
    }
    __syncthreads();

    // --- frequency MHSA, freq_fc + residual ---
    fe::qkv_rows<T>(xs, qs, ks, vs, p.w_fqkv + i * 3 * cc,
                    p.b_fqkv + static_cast<size_t>(i) * 3 * ch, freq, ch);
    __syncthreads();
    fe::freq_attention<T>(qs, ks, vs, ps, freq, ch, heads, scale);
    fe::fc_residual<T>(qs, xs, p.w_ffc + i * cc,
                       p.b_ffc + static_cast<size_t>(i) * ch, freq, ch);
    __syncthreads();
  }

  for (int e = tid; e < fc; e += nt) {
    x_out[static_cast<size_t>(b) * fc + e] = store_t<T>(xs[e]);
  }
}

// The bfloat16 form (dpt_tc.cuh). Shared memory, in bf16 elements: the
// head (a 16-byte chunk of zeros and the ring's kRing mbarriers), the
// activations and float32 logits (DptGeom::act), the cache ring and the two
// weight slots.
__global__ void __launch_bounds__(kThreads, fe::kMinBlocks)
    dpt_stack_tc_kernel(const bf16* __restrict__ x, bf16* kc, bf16* vc,
                        const int* __restrict__ ptr_in,
                        bf16* __restrict__ x_out, int* __restrict__ ptr_out,
                        DptPlan<bf16> p, int batch, int freq, int ch,
                        int heads, int nblocks, int lookbehind, float scale) {
  extern __shared__ __align__(16) unsigned char smem_tc[];
  const fe::tc::DptGeom g(freq, ch, heads, lookbehind);
  bf16* zero = reinterpret_cast<bf16*>(smem_tc);
  auto* ring_bars = reinterpret_cast<uint64_t*>(smem_tc + 16);
  bf16* act = zero + fe::tc::kDptHead;
  float* logits = reinterpret_cast<float*>(act + g.s.act());
  float* bias = logits + g.logits();
  bf16* ring_buf = act + g.act();
  bf16* slot = ring_buf + g.ring();
  const fe::tc::StackTiles t(act, g.s);
  const int b = blockIdx.x;
  const int lb = lookbehind;
  // taken mod L, so no pointer value can send a write outside the slab
  const int ptr = (*ptr_in % lb + lb) % lb;
  if (b == 0 && threadIdx.x == 0) *ptr_out = (ptr + 1) % lb;
  if (threadIdx.x < 8) zero[threadIdx.x] = __float2bfloat16_rn(0.f);
  fe::tc::stack_init(act, g.s);
  // each key's bias this frame: slot s < L was written ((ptr - 1 - s) mod
  // L) + 1 frames ago and takes time_pe[h, L - age]; the frame itself
  // time_pe[h, L]
  for (int e = threadIdx.x; e < heads * g.keys; e += blockDim.x) {
    const int hh = e / g.keys;
    const int sk = e - hh * g.keys;
    const int col = sk < lb ? lb - ((ptr - 1 - sk) % lb + lb) % lb - 1 : lb;
    bias[e] = load_f(p.time_pe[hh * g.keys + col]);
  }
  if (threadIdx.x == 0) {
    for (int r = 0; r < fe::tc::kRing; ++r) fe::tc::mbar_init(ring_bars + r);
    fe::tc::mbar_fence_init();
  }
  __syncthreads();
  const size_t frame = g.slot_el;  // one stream's [F, C]
  const size_t slab = lb * frame;  // its L slots of one block
  fe::tc::KvRing ring{ring_buf, ring_bars, kc, vc, b * slab, batch * slab,
                      nblocks * 2 * g.chunks, 0};
  ring.fill(0, g);  // block 0's first keys, while its q, k, v are computed
  fe::tc::run_stages_direct(
      4 * nblocks, slot, slot + g.slot(),
      [&](int s, auto& v) { fe::tc::dpt_pieces(s, v, p, g); },
      [&](int s) {
        if (s == 0) {
          fe::tc::stage_rows(t.xs, g.s.ldc, x + b * frame, freq, ch);
        }
      },
      [&](int s) {
        if ((s & 3) == 1) {
          const size_t at = (s >> 2) * batch * slab + b * slab +
                            static_cast<size_t>(ptr) * g.slot_el;
          fe::tc::time_attention_tc(s >> 2, ring, t, logits, bias, g, scale,
                                    kc + at, vc + at);
        } else if ((s & 3) == 3) {
          fe::tc::attention_tc(t.qs, t.ks, t.vs, t.ps, t.qs, g.s, scale,
                               zero);
        }
      },
      [&](int s, const bf16* w) { fe::tc::dpt_stage(s, w, t, g, zero); });
  for (int e = threadIdx.x; e < freq * ch; e += blockDim.x) {
    x_out[b * frame + e] = t.xs[e / ch * g.s.ldc + e % ch];
  }
}

size_t smem_bytes_tc(int freq, int ch, int heads, int lookbehind) {
  const fe::tc::DptGeom g(freq, ch, heads, lookbehind);
  return (fe::tc::kDptHead + static_cast<size_t>(g.act()) + g.ring() +
          2 * g.slot()) *
         sizeof(bf16);
}

size_t smem_bytes(int freq, int ch, int heads, int lookbehind) {
  const int keys = freq > lookbehind + 1 ? freq : lookbehind + 1;
  return (4 * static_cast<size_t>(freq) * ch +
          static_cast<size_t>(heads) * freq * keys) *
         sizeof(float);
}

template <typename T>
int launch(const void* x, void* kc, void* vc, const void* ptr, void* x_out,
           void* ptr_out, const void* const* plan, int batch, int freq,
           int ch, int heads, int nblocks, int lookbehind, void* stream) {
  const size_t smem = smem_bytes(freq, ch, heads, lookbehind);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dpt_stack_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const DptPlan<T> p{
      static_cast<const T*>(plan[0]), static_cast<const T*>(plan[1]),
      static_cast<const T*>(plan[2]), static_cast<const T*>(plan[3]),
      static_cast<const T*>(plan[4]), static_cast<const T*>(plan[5]),
      static_cast<const T*>(plan[6]), static_cast<const T*>(plan[7]),
      static_cast<const T*>(plan[8]), static_cast<const T*>(plan[9])};
  const float scale = static_cast<float>(1.0 / std::sqrt(double(ch / heads)));
  dpt_stack_kernel<T>
      <<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(x), static_cast<T*>(kc), static_cast<T*>(vc),
          static_cast<const int*>(ptr), static_cast<T*>(x_out),
          static_cast<int*>(ptr_out), p, batch, freq, ch, heads, nblocks,
          lookbehind, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 on success). The ten plan
// pointers come in ops/dpt_stack.py's PLAN_KEYS order.
int dpt_stack_f32(const void* x, void* kc, void* vc, const void* ptr,
                  void* x_out, void* ptr_out, const void* w_tqkv,
                  const void* b_tqkv, const void* w_tfc, const void* b_tfc,
                  const void* w_fqkv, const void* b_fqkv, const void* w_ffc,
                  const void* b_ffc, const void* pe, const void* time_pe,
                  int batch, int freq, int ch, int heads, int nblocks,
                  int lookbehind, void* stream) {
  const void* plan[10] = {w_tqkv, b_tqkv, w_tfc, b_tfc, w_fqkv,
                          b_fqkv, w_ffc,  b_ffc, pe,    time_pe};
  return launch<float>(x, kc, vc, ptr, x_out, ptr_out, plan, batch, freq, ch,
                       heads, nblocks, lookbehind, stream);
}

int dpt_stack_bf16(const void* x, void* kc, void* vc, const void* ptr,
                   void* x_out, void* ptr_out, const void* w_tqkv,
                   const void* b_tqkv, const void* w_tfc, const void* b_tfc,
                   const void* w_fqkv, const void* b_fqkv, const void* w_ffc,
                   const void* b_ffc, const void* pe, const void* time_pe,
                   int batch, int freq, int ch, int heads, int nblocks,
                   int lookbehind, void* stream) {
  const void* plan[10] = {w_tqkv, b_tqkv, w_tfc, b_tfc, w_fqkv,
                          b_fqkv, w_ffc,  b_ffc, pe,    time_pe};
  return launch<__nv_bfloat16>(x, kc, vc, ptr, x_out, ptr_out, plan, batch,
                               freq, ch, heads, nblocks, lookbehind, stream);
}

// The tensor-core form (bfloat16, F*C*2 a multiple of 16; dpt_tc.cuh),
// same arguments as dpt_stack_bf16. kc and vc must be 16-byte aligned.
int dpt_stack_tc_bf16(const void* x, void* kc, void* vc, const void* ptr,
                      void* x_out, void* ptr_out, const void* w_tqkv,
                      const void* b_tqkv, const void* w_tfc,
                      const void* b_tfc, const void* w_fqkv,
                      const void* b_fqkv, const void* w_ffc,
                      const void* b_ffc, const void* pe, const void* time_pe,
                      int batch, int freq, int ch, int heads, int nblocks,
                      int lookbehind, void* stream) {
  const void* plan[10] = {w_tqkv, b_tqkv, w_tfc, b_tfc, w_fqkv,
                          b_fqkv, w_ffc,  b_ffc, pe,    time_pe};
  const auto w = [&plan](int k) { return static_cast<const bf16*>(plan[k]); };
  const DptPlan<bf16> p{w(0), w(1), w(2), w(3), w(4),
                        w(5), w(6), w(7), w(8), w(9)};
  const size_t smem = smem_bytes_tc(freq, ch, heads, lookbehind);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dpt_stack_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const float scale = static_cast<float>(1.0 / std::sqrt(double(ch / heads)));
  dpt_stack_tc_kernel<<<batch, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(kc),
      static_cast<bf16*>(vc), static_cast<const int*>(ptr),
      static_cast<bf16*>(x_out), static_cast<int*>(ptr_out), p, batch, freq,
      ch, heads, nblocks, lookbehind, scale);
  return static_cast<int>(cudaGetLastError());
}

// Bytes of dynamic shared memory one thread block (one stream) of the
// tensor-core form needs; ops/dpt_stack.py::tc_smem_bytes computes the
// same.
size_t dpt_stack_smem_bf16(int freq, int ch, int heads, int lookbehind) {
  return smem_bytes_tc(freq, ch, heads, lookbehind);
}

const char* dpt_stack_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
