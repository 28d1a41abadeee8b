// Active-segment RMS of each row, as one CUDA kernel for Hopper (sm_90a).
// ops/_build.py compiles this file with nvcc into a shared library with a
// plain C interface; ops/segmental_rms.py loads it with ctypes and launches
// it on PyTorch's current stream.
//
// Replaces fastenhancer_tpu/ops/segmental_rms.py::segmental_rms_pallas, the
// Pallas TPU kernel. For each row of wav [B, T]:
//   n        = T / win frames of win samples (the tail is dropped)
//   p[f]     = mean of the frame's squares                (the frame power)
//   thr      = max(max_f p[f] * rel_ratio, abs_floor)
//   out[row] = sqrt(mean of p[f] over p[f] > thr), or +inf if none is
// and, when T < win (n == 0), the RMS of the whole row. Sums accumulate in
// float32 whatever the input type; the result is rounded to the input type,
// as the Pallas kernel's out_shape is.
//
// What bounds it on the H100: bytes. Every sample is read once and 4 bytes
// per row are written; at the shard recipe's train batch, [32, 64000]
// float32 is 8.2 MB, about 2.4 us at 3.35 TB/s. The arithmetic (one FMA a
// sample) is far below the memory rate.
//
// The design. A cluster of K thread blocks per row (K in 1, 2, 4, 8: the
// largest with B * K <= 132 SMs, chosen by the wrapper), so that a small
// batch still spreads over the card: at B = 32, K = 4 gives 128 blocks.
// Block `rank` takes the row's frames [n rank / K, n (rank + 1) / K); each
// of its 8 warps takes every 8th of them. A warp reads its frame with
// 16-byte loads (4 float32 or 8 bfloat16 samples a lane), all of a
// 1,600-sample frame in flight at once (kUnroll a lane, into separate
// accumulators), with scalar loads for the head before the first 16-byte
// boundary (a row or frame that does not start on one) and for the tail;
// a shuffle reduction gives the frame's power, which lane 0 stores into
// rank 0's shared array through distributed shared memory (mapa,
// st.shared::cluster). After one cluster barrier, warp 0 of rank 0 reduces
// the powers twice with shuffles, first their max, then the count and the
// sum of the active ones, and writes the result; every other warp has
// exited. A row shorter than one frame is summed by warp 0 of rank 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "cluster.cuh"
#include "stack_common.cuh"  // load_f, store_t

namespace {

using fe::kThreads;
constexpr int kWarps = kThreads / 32;
// 16-byte loads a lane keeps in flight: a whole 1,600-sample frame (400
// float32 or 200 bfloat16 vectors) in one batch
constexpr int kUnroll = 16;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}

// acc + the squares of the 16 bytes w
__device__ __forceinline__ float sumsq(const float*, uint4 w, float acc) {
  const uint32_t v[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float f = __uint_as_float(v[i]);
    acc = fmaf(f, f, acc);
  }
  return acc;
}

__device__ __forceinline__ float sumsq(const __nv_bfloat16*, uint4 w,
                                       float acc) {
  const uint32_t v[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float lo = __uint_as_float(v[i] << 16);
    const float hi = __uint_as_float(v[i] & 0xffff0000u);
    acc = fmaf(lo, lo, acc);
    acc = fmaf(hi, hi, acc);
  }
  return acc;
}

// the sum of x[0..n)^2 over one warp; every lane gets it
template <typename T>
__device__ __forceinline__ float warp_sumsq(const T* x, long long n) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  const int lane = threadIdx.x & 31;
  const auto addr = reinterpret_cast<uintptr_t>(x);
  const long long head = min(
      static_cast<long long>(((16 - (addr & 15)) & 15) / sizeof(T)), n);
  const long long nv = (n - head) / kVec;
  const long long tail0 = head + nv * kVec;
  float acc[kUnroll] = {};
  if (lane < head) {
    const float v = fe::load_f(x[lane]);
    acc[0] = v * v;
  }
  if (tail0 + lane < n) {
    const float v = fe::load_f(x[tail0 + lane]);
    acc[1] = v * v;
  }
  const uint4* xv = reinterpret_cast<const uint4*>(x + head);
  long long i = lane;
  for (; i + (kUnroll - 1) * 32 < nv; i += kUnroll * 32) {
    uint4 w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) w[u] = __ldg(xv + i + u * 32);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc[u] = sumsq(x, w[u], acc[u]);
  }
  // the last (fewer than kUnroll * 32) vectors, their loads still all
  // issued before the first is used
  uint4 w[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    w[u] = i + u * 32 < nv ? __ldg(xv + i + u * 32) : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) acc[u] = sumsq(x, w[u], acc[u]);
  float s = 0.f;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) s += acc[u];
  return warp_sum(s);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, fe::kMinBlocks)
    segmental_rms_kernel(const T* __restrict__ wav, T* __restrict__ out,
                         long long len, int win, float rel_ratio,
                         float abs_floor) {
  extern __shared__ float pow_f[];  // [n] frame powers (rank 0's are read)
  const int k = fe::cluster_size();
  const int rank = fe::cluster_rank();
  const int row = blockIdx.x / k;
  const T* x = wav + static_cast<size_t>(row) * len;
  const int n = static_cast<int>(len / win);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  if (n == 0) {  // shorter than one frame: the RMS of the whole row
    if (rank == 0 && warp == 0) {
      const float s = warp_sumsq(x, len);
      if (lane == 0) {
        out[row] = fe::store_t<T>(sqrtf(s / static_cast<float>(len)));
      }
    }
    return;
  }

  const int f1 = n * (rank + 1) / k;
  for (int f = n * rank / k + warp; f < f1; f += kWarps) {
    const float p = warp_sumsq(x + static_cast<size_t>(f) * win, win);
    if (lane == 0) {
      fe::store_cluster(pow_f + f, 0, p / static_cast<float>(win));
    }
  }
  fe::cluster_sync();  // every frame's power is in rank 0's pow_f
  if (rank != 0 || warp != 0) return;

  // rank 0's warp 0: the max, then the count and sum of the active powers
  float m = 0.f;  // powers are >= 0
  for (int f = lane; f < n; f += 32) m = fmaxf(m, pow_f[f]);
  const float thr = fmaxf(warp_max(m) * rel_ratio, abs_floor);
  float cnt = 0.f, sum = 0.f;
  for (int f = lane; f < n; f += 32) {
    const float p = pow_f[f];
    if (p > thr) {
      cnt += 1.f;
      sum += p;
    }
  }
  cnt = warp_sum(cnt);
  sum = warp_sum(sum);
  if (lane == 0) {
    out[row] = fe::store_t<T>(cnt > 0.f ? sqrtf(sum / cnt) : INFINITY);
  }
}

size_t smem_bytes(long long len, int win) {
  return static_cast<size_t>(len / win) * sizeof(float);
}

template <typename T>
int launch(const void* wav, void* out, int batch, long long len, int win,
           int cluster, float rel_ratio, float abs_floor, void* stream) {
  const size_t smem = smem_bytes(len, win);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        segmental_rms_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(batch * cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, segmental_rms_kernel<T>, static_cast<const T*>(wav),
      static_cast<T*>(out), len, win, rel_ratio, abs_floor);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 on success). wav is
// [batch, len] contiguous; out is [batch]; cluster (1, 2, 4 or 8) thread
// blocks a row.
int segmental_rms_f32(const void* wav, void* out, int batch, long long len,
                      int win, int cluster, float rel_ratio, float abs_floor,
                      void* stream) {
  return launch<float>(wav, out, batch, len, win, cluster, rel_ratio,
                       abs_floor, stream);
}

int segmental_rms_bf16(const void* wav, void* out, int batch, long long len,
                       int win, int cluster, float rel_ratio, float abs_floor,
                       void* stream) {
  return launch<__nv_bfloat16>(wav, out, batch, len, win, cluster, rel_ratio,
                               abs_floor, stream);
}

const char* segmental_rms_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
