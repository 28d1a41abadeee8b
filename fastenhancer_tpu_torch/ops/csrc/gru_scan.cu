// The GRU recurrence over a whole sequence, as one CUDA kernel for Hopper
// (sm_90a). ops/_build.py compiles this file with nvcc into a shared library
// with a plain C interface; ops/gru_scan.py loads it with ctypes and
// launches it on PyTorch's current stream.
//
// Replaces fastenhancer_tpu/ops/gru_scan.py::gru_scan_pallas, the Pallas TPU
// kernel: the recurrent half of nn.gru (torch gate order r, z, n),
//   x_proj [T, N, 3H] (= x W_ih^T + b_ih), h0 [N, H], w_hh [3H, H], b_hh [3H]
//   r = sigmoid(x_r + h W_hr^T + b_hr)
//   z = sigmoid(x_z + h W_hz^T + b_hz)
//   n = tanh(x_n + r * (h W_hn^T + b_hn))
//   h' = (1 - z) * n + z * h                 -> ys [T, N, H], h_T [N, H]
// With the Pallas kernel's cast points: the state stays float32 across all
// T steps, w_hh and b_hh are read in float32, the gate math is float32, and
// only ys and h_T are rounded to the activation type T.
//
// What bounds it on the H100. By bytes, the read of x_proj and the write
// of ys: at the valid step of the shard recipe (T=126, N=64*16=1024, H=20,
// bf16) about 21 MB, about 6 us at 3.35 TB/s. Its time is latency: T
// dependent steps, each a dot product of length H per gate and a barrier.
//
// Two forms. The bfloat16 form runs on the tensor cores (gru_scan_tc.cuh:
// a tile of 16 rows a thread block, one warp a group of 8 units, h W_hh^T
// on mma.sync with the float32 state split into two bf16 halves, W_hh's
// fragments in registers, x_proj loaded into registers two steps ahead);
// ops/gru_scan.py::kernel_form picks it for every bfloat16 shape it takes
// (even H <= 128). The float32 form below (and bf16 at odd H) is the
// scalar design and the correctness reference.
//
// The scalar design. A thread block owns a tile of R rows for all T steps; the
// time loop runs inside the kernel, which takes the place of the Pallas
// grid's sequential time dimension and its VMEM scratch state. Shared
// memory holds w_hh transposed to [H, 3H] in float32 (so the threads of a
// warp read consecutive words), b_hh, and the tile's state twice: step t
// reads one copy and writes the other, so one __syncthreads per step
// suffices. Each thread owns one (row, hidden unit) pair: it computes the
// three gate dots over H, the update, and the ys[t] store, and it loads
// x_proj[t + 1]'s three values into registers before step t's dots, so
// the global load's latency overlaps the arithmetic. The wrapper picks R
// (R * H <= 256) so that about one block runs per SM. No lane padding of
// the gates to 128: that was the TPU's tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "gru_scan_tc.cuh"
#include "stack_common.cuh"

namespace {

using fe::kThreads;

template <typename T>
__global__ void __launch_bounds__(kThreads, fe::kMinBlocks)
    gru_scan_kernel(const T* __restrict__ x_proj, const T* __restrict__ h0,
                    const T* __restrict__ w_hh, const T* __restrict__ b_hh,
                    T* __restrict__ ys, T* __restrict__ h_t, int steps,
                    int rows, int hid, int tile) {
  extern __shared__ float smem[];
  const int g3 = 3 * hid;
  float* wt = smem;                  // [H, 3H]: wt[k, g] = w_hh[g, k]
  float* bh = wt + hid * g3;         // [3H]
  float* hs = bh + g3;               // [2, R, H] the state, twice
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int row0 = blockIdx.x * tile;
  const int tile_rows = min(tile, rows - row0);

  for (int e = tid; e < hid * g3; e += nt) {
    const int g = e / hid;
    const int k = e - g * hid;
    wt[k * g3 + g] = fe::load_f(w_hh[e]);
  }
  for (int e = tid; e < g3; e += nt) bh[e] = fe::load_f(b_hh[e]);
  for (int e = tid; e < tile_rows * hid; e += nt) {
    hs[e] = fe::load_f(h0[static_cast<size_t>(row0) * hid + e]);
  }

  // this thread's (row, unit) pair; threads past the tile only keep time
  const int r = tid / hid;
  const int j = tid - r * hid;
  const bool active = r < tile_rows;
  const size_t row = static_cast<size_t>(row0) + r;
  const size_t step_ld = static_cast<size_t>(rows) * g3;
  const T* xp = x_proj + row * g3 + j;
  float xr = 0.f, xz = 0.f, xn = 0.f;
  if (active && steps > 0) {
    xr = fe::load_f(xp[0]);
    xz = fe::load_f(xp[hid]);
    xn = fe::load_f(xp[2 * hid]);
  }
  __syncthreads();

  for (int t = 0; t < steps; ++t) {
    const float* hc = hs + (t & 1) * tile * hid;
    float* hn = hs + ((t + 1) & 1) * tile * hid;
    float nxr = 0.f, nxz = 0.f, nxn = 0.f;
    if (active && t + 1 < steps) {
      const T* nx = xp + (t + 1) * step_ld;
      nxr = fe::load_f(nx[0]);
      nxz = fe::load_f(nx[hid]);
      nxn = fe::load_f(nx[2 * hid]);
    }
    if (active) {
      const float* hrow = hc + r * hid;
      float ar = bh[j], az = bh[hid + j], an = bh[2 * hid + j];
      for (int k = 0; k < hid; ++k) {
        const float hk = hrow[k];
        const float* wk = wt + k * g3;
        ar = fmaf(hk, wk[j], ar);
        az = fmaf(hk, wk[hid + j], az);
        an = fmaf(hk, wk[2 * hid + j], an);
      }
      const float rg = fe::sigmoid_f(xr + ar);
      const float zg = fe::sigmoid_f(xz + az);
      const float ng = tanhf(xn + rg * an);
      const float h = (1.f - zg) * ng + zg * hrow[j];
      hn[r * hid + j] = h;
      ys[t * static_cast<size_t>(rows) * hid + row * hid + j] =
          fe::store_t<T>(h);
    }
    xr = nxr;
    xz = nxz;
    xn = nxn;
    __syncthreads();
  }
  if (active) {
    h_t[row * hid + j] = fe::store_t<T>(hs[(steps & 1) * tile * hid +
                                           r * hid + j]);
  }
}

size_t smem_bytes(int hid, int tile) {
  return (static_cast<size_t>(hid) * 3 * hid + 3 * hid +
          2 * static_cast<size_t>(tile) * hid) *
         sizeof(float);
}

template <typename T>
int launch(const void* x_proj, const void* h0, const void* w_hh,
           const void* b_hh, void* ys, void* h_t, int steps, int rows,
           int hid, int tile, void* stream) {
  const size_t smem = smem_bytes(hid, tile);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gru_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = (tile * hid + 31) / 32 * 32;
  const int blocks = (rows + tile - 1) / tile;
  gru_scan_kernel<T>
      <<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(x_proj), static_cast<const T*>(h0),
          static_cast<const T*>(w_hh), static_cast<const T*>(b_hh),
          static_cast<T*>(ys), static_cast<T*>(h_t), steps, rows, hid, tile);
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core form's kernels, one for each (k-steps, unit groups a
// warp) that an even H <= 128 needs: one group a warp up to H = 64 (W_hh's
// fragments in registers), two above (in shared memory). Up to 255
// registers a thread: at most eight warps a block and a block a tile, so
// registers do not limit the blocks an SM holds.
template <int kKS, int kG, bool kRegB>
__global__ void __launch_bounds__(fe::gru::kMaxWarps * 32, 1)
    gru_scan_tc_kernel(fe::gru::GruTcArgs a) {
  extern __shared__ __align__(16) char smem_tc[];
  fe::gru::gru_tile<kKS, kG, kRegB>(a, smem_tc);
}

using TcKernel = void (*)(fe::gru::GruTcArgs);

// the kernel for H's k-steps (H even, 2 <= H <= 128), or nullptr
TcKernel tc_kernel(int ksteps) {
  switch (ksteps) {
    case 1: return gru_scan_tc_kernel<1, 1, true>;
    case 2: return gru_scan_tc_kernel<2, 1, true>;
    case 3: return gru_scan_tc_kernel<3, 1, true>;
    case 4: return gru_scan_tc_kernel<4, 1, true>;
    case 5: return gru_scan_tc_kernel<5, 2, false>;
    case 6: return gru_scan_tc_kernel<6, 2, false>;
    case 7: return gru_scan_tc_kernel<7, 2, false>;
    case 8: return gru_scan_tc_kernel<8, 2, false>;
    default: return nullptr;
  }
}

int launch_tc(const void* x_proj, const void* h0, const void* w_hh,
              const void* b_hh, void* ys, void* h_t, int steps, int rows,
              int hid, void* stream) {
  if (hid < 2 || hid % 2 || rows < 1 ||
      reinterpret_cast<uintptr_t>(x_proj) % 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const fe::gru::GruTcGeom g(hid);
  const TcKernel kernel = tc_kernel(g.ksteps);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = g.bytes();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const fe::gru::GruTcArgs args{
      static_cast<const __nv_bfloat16*>(x_proj),
      static_cast<const __nv_bfloat16*>(h0),
      static_cast<const __nv_bfloat16*>(w_hh),
      static_cast<const __nv_bfloat16*>(b_hh),
      static_cast<__nv_bfloat16*>(ys),
      static_cast<__nv_bfloat16*>(h_t),
      steps,
      rows,
      hid};
  const int blocks = (rows + fe::gru::kRows - 1) / fe::gru::kRows;
  kernel<<<blocks, 32 * g.warps(), smem,
           static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 on success). x_proj is
// [steps, rows, 3 hid], h0 and h_t [rows, hid], w_hh [3 hid, hid], b_hh
// [3 hid], ys [steps, rows, hid], all contiguous; tile rows per block with
// tile * hid <= 256.
int gru_scan_f32(const void* x_proj, const void* h0, const void* w_hh,
                 const void* b_hh, void* ys, void* h_t, int steps, int rows,
                 int hid, int tile, void* stream) {
  return launch<float>(x_proj, h0, w_hh, b_hh, ys, h_t, steps, rows, hid,
                       tile, stream);
}

int gru_scan_bf16(const void* x_proj, const void* h0, const void* w_hh,
                  const void* b_hh, void* ys, void* h_t, int steps, int rows,
                  int hid, int tile, void* stream) {
  return launch<__nv_bfloat16>(x_proj, h0, w_hh, b_hh, ys, h_t, steps, rows,
                               hid, tile, stream);
}

// The tensor-core form (bfloat16, even H <= 128 only, x_proj 4-byte
// aligned): a thread block of ops/gru_scan.py::tc_warps(H) warps per tile
// of 16 rows. Same arguments as gru_scan_bf16 but the rows per block.
int gru_scan_tc_bf16(const void* x_proj, const void* h0, const void* w_hh,
                     const void* b_hh, void* ys, void* h_t, int steps,
                     int rows, int hid, void* stream) {
  return launch_tc(x_proj, h0, w_hh, b_hh, ys, h_t, steps, rows, hid,
                   stream);
}

// the tensor-core form's shared memory per block, in bytes
long long gru_scan_tc_smem(int hid) {
  return static_cast<long long>(fe::gru::GruTcGeom(hid).bytes());
}

const char* gru_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
