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
// The design. One thread block per row, as the Pallas grid has one
// program per row. Each warp takes every kWarps-th frame, its lanes stride
// over the frame's samples (consecutive lanes on consecutive addresses, so
// the loads coalesce) and a shuffle reduction gives the frame's power,
// which goes to shared memory. After one barrier the block reduces the
// powers twice, first their max, then the count and the sum of the active
// ones; one thread writes the result. With B rows only B blocks run: at
// B=32 that is 32 of the 132 SMs, so one row's read rate, not the card's,
// sets the time. Splitting a row over several blocks is left for later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

#include "stack_common.cuh"

namespace {

using fe::kThreads;
constexpr int kWarps = kThreads / 32;

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

// the sum (or max) of v over the block; every thread gets the result.
// red: kWarps floats of shared memory, free on entry.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = kMax ? warp_max(v) : warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kWarps; ++w) r = kMax ? fmaxf(r, red[w]) : r + red[w];
  __syncthreads();  // red may be reused right after
  return r;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, fe::kMinBlocks)
    segmental_rms_kernel(const T* __restrict__ wav, T* __restrict__ out,
                         long long len, int win, float rel_ratio,
                         float abs_floor) {
  extern __shared__ float smem[];
  float* red = smem;             // [kWarps] reduction scratch
  float* pow_f = smem + kWarps;  // [n] frame powers
  const T* x = wav + static_cast<size_t>(blockIdx.x) * len;
  const int n = static_cast<int>(len / win);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  if (n == 0) {  // shorter than one frame: the RMS of the whole row
    float acc = 0.f;
    for (long long i = threadIdx.x; i < len; i += kThreads) {
      const float v = fe::load_f(x[i]);
      acc = fmaf(v, v, acc);
    }
    acc = block_reduce<false>(acc, red);
    if (threadIdx.x == 0) {
      out[blockIdx.x] = fe::store_t<T>(sqrtf(acc / static_cast<float>(len)));
    }
    return;
  }

  for (int f = warp; f < n; f += kWarps) {
    const T* xf = x + static_cast<size_t>(f) * win;
    float acc = 0.f;
    for (int i = lane; i < win; i += 32) {
      const float v = fe::load_f(xf[i]);
      acc = fmaf(v, v, acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) pow_f[f] = acc / static_cast<float>(win);
  }
  __syncthreads();

  float m = 0.f;  // powers are >= 0
  for (int f = threadIdx.x; f < n; f += kThreads) m = fmaxf(m, pow_f[f]);
  const float thr = fmaxf(block_reduce<true>(m, red) * rel_ratio, abs_floor);

  float cnt = 0.f, sum = 0.f;
  for (int f = threadIdx.x; f < n; f += kThreads) {
    const float p = pow_f[f];
    if (p > thr) {
      cnt += 1.f;
      sum += p;
    }
  }
  cnt = block_reduce<false>(cnt, red);
  sum = block_reduce<false>(sum, red);
  if (threadIdx.x == 0) {
    out[blockIdx.x] =
        fe::store_t<T>(cnt > 0.f ? sqrtf(sum / cnt) : INFINITY);
  }
}

size_t smem_bytes(long long len, int win) {
  return (kWarps + static_cast<size_t>(len / win)) * sizeof(float);
}

template <typename T>
int launch(const void* wav, void* out, int batch, long long len, int win,
           float rel_ratio, float abs_floor, void* stream) {
  const size_t smem = smem_bytes(len, win);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        segmental_rms_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  segmental_rms_kernel<T>
      <<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(wav), static_cast<T*>(out), len, win,
          rel_ratio, abs_floor);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 on success). wav is
// [batch, len] contiguous; out is [batch].
int segmental_rms_f32(const void* wav, void* out, int batch, long long len,
                      int win, float rel_ratio, float abs_floor,
                      void* stream) {
  return launch<float>(wav, out, batch, len, win, rel_ratio, abs_floor,
                       stream);
}

int segmental_rms_bf16(const void* wav, void* out, int batch, long long len,
                       int win, float rel_ratio, float abs_floor,
                       void* stream) {
  return launch<__nv_bfloat16>(wav, out, batch, len, win, rel_ratio,
                               abs_floor, stream);
}

const char* segmental_rms_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
