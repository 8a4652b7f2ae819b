// Output-stationary matmul with zero-value tile gating (K7) for Hopper
// (sm_90a). Built by repro_torch/kernels/_build.py with nvcc into a shared
// library with a plain C interface, loaded with ctypes.
//
// Replaces the TPU kernel
//   src/repro/kernels/zvg_matmul/kernel.py::zvg_matmul_pallas
// out[M, N] = a[M, K] @ b[K, N] in float32, a and b both float32 or both
// bfloat16, and gated[Mb, Kb] (Mb = ceil(M / bm), Kb = ceil(K / bk)): 1
// where the [bm, bk] tile of a holds no value other than zero, else 0.
// The gate tests VALUES, a != 0, as the TPU kernel's jnp.any(a != 0) does:
// -0.0 counts as zero (gated) and NaN as live. (The decode kernel K2 in
// zvg_matmul.cu tests raw bits instead and keeps -0.0 live.) Rows and
// columns past M, K and N are zeros, as the TPU kernel's padding is.
//
// Two kernels on the caller's stream:
//   * gate_kernel, one block per (m, k) tile: its threads test the tile's
//     values (a warp reads 32 adjacent k) and meet in __syncthreads_or;
//   * tiled_kernel, one block per kTM x kTN output tile: the block walks K
//     in steps of kTK, and before each step reads the gated flag of the
//     (m, k) tile the step lies in. bm is a multiple of kTM and bk of kTK,
//     so a block's rows lie in one tile row and a step in one tile column:
//     when the tile is gated the whole block skips the step, loading
//     neither its A slice nor its B slice. Otherwise the block stages the
//     A slice (transposed) and the B slice in shared memory as float32 and
//     each of its 256 threads accumulates a 4 x 4 patch of the output with
//     fmaf, k in order. A bfloat16 product is exact in float32, so the
//     result differs from a float32 product of the same operands only in
//     the order of the sums. A block with every step gated writes +0.0.
//
// Bound on an H100: 2*M*K*N operations of the live tiles at 989 TFLOP/s
// (the bfloat16 tensor-core rate), or a and b read once, out written once
// (for ResNet50 at 224 px, about 8.2 GFLOP over its 54 sites, 8.3 us). This
// simple kernel uses no tensor cores: it runs on the float32 FMA pipes
// (67 TFLOP/s at most) from shared memory, so it sits far off that bound.
// wgmma tiles fed by TMA are the later change that makes it fast.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTM = 64;          // output rows per block
constexpr int kTN = 64;          // output columns per block
constexpr int kTK = 16;          // k per staged step
constexpr int kPatch = 4;        // a thread's output patch is 4 x 4
constexpr int kMaxGrid = 65535;

enum Dtype { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gate_kernel(const T* __restrict__ a, int M, int K, int bm, int bk,
            int32_t* __restrict__ gated) {
  const int kb = blockIdx.x, mb = blockIdx.y;
  const int m0 = mb * bm, k0 = kb * bk;
  const int rows = min(bm, M - m0), cols = min(bk, K - k0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int live = 0;
  for (int r = warp; r < rows && !live; r += kThreads / 32) {
    const T* row = a + static_cast<size_t>(m0 + r) * K + k0;
    for (int c = lane; c < cols; c += 32)
      live |= to_f(row[c]) != 0.0f;     // NaN != 0: live; -0.0: zero
  }
  live = __syncthreads_or(live);
  if (threadIdx.x == 0)
    gated[static_cast<size_t>(mb) * gridDim.x + kb] = live ? 0 : 1;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
tiled_kernel(const T* __restrict__ a, const T* __restrict__ b,
             const int32_t* __restrict__ gated, int M, int K, int N, int bm,
             int bk, int Kb, float* __restrict__ out) {
  __shared__ float As[kTK][kTM + 4];   // A slice, transposed: As[k][m]
  __shared__ float Bs[kTK][kTN];
  const int tid = threadIdx.x;
  const int tx = tid % (kTN / kPatch), ty = tid / (kTN / kPatch);
  const int m0 = blockIdx.y * kTM, n0 = blockIdx.x * kTN;
  const int32_t* gate_row = gated + static_cast<size_t>(m0 / bm) * Kb;
  float acc[kPatch][kPatch] = {};
  for (int k0 = 0; k0 < K; k0 += kTK) {
    if (gate_row[k0 / bk]) continue;   // the same for every thread
#pragma unroll
    for (int i = 0; i < kTM * kTK / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / kTK, c = e % kTK;
      const int m = m0 + r, k = k0 + c;
      As[c][r] = m < M && k < K ? to_f(a[static_cast<size_t>(m) * K + k])
                                : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kTK * kTN / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / kTN, c = e % kTN;
      const int k = k0 + r, n = n0 + c;
      Bs[r][c] = k < K && n < N ? to_f(b[static_cast<size_t>(k) * N + n])
                                : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kTK; ++k) {
      float av[kPatch], bv[kPatch];
#pragma unroll
      for (int i = 0; i < kPatch; ++i) {
        av[i] = As[k][ty * kPatch + i];
        bv[i] = Bs[k][tx * kPatch + i];
      }
#pragma unroll
      for (int i = 0; i < kPatch; ++i)
#pragma unroll
        for (int j = 0; j < kPatch; ++j)
          acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kPatch; ++i) {
    const int m = m0 + ty * kPatch + i;
    if (m >= M) break;
#pragma unroll
    for (int j = 0; j < kPatch; ++j) {
      const int n = n0 + tx * kPatch + j;
      if (n < N) out[static_cast<size_t>(m) * N + n] = acc[i][j];
    }
  }
}

template <typename T>
cudaError_t launch(const void* a, const void* b, int M, int K, int N, int bm,
                   int bk, float* out, int32_t* gated, cudaStream_t stream) {
  const int Mb = (M + bm - 1) / bm, Kb = (K + bk - 1) / bk;
  gate_kernel<T><<<dim3(Kb, Mb), kThreads, 0, stream>>>(
      static_cast<const T*>(a), M, K, bm, bk, gated);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kTN - 1) / kTN, (M + kTM - 1) / kTM);
  tiled_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), gated, M, K, N, bm,
      bk, Kb, out);
  return cudaGetLastError();
}

}  // namespace

// out[M, N] (float32) = a[M, K] @ b[K, N], a and b of one dtype (0:
// float32, 1: bfloat16), skipping every [bm, bk] tile of a that holds only
// zeros, and gated[ceil(M / bm), ceil(K / bk)] (int32, 1 = skipped). bm
// must be a multiple of 64 and bk of 16. Returns cudaGetLastError() after
// the launches (cudaErrorInvalidValue for arguments the kernels do not
// take).
extern "C" int zt_zvg_tiled_matmul(const void* a, const void* b, int dtype,
                                   int M, int K, int N, int bm, int bk,
                                   float* out, int32_t* gated,
                                   void* stream) {
  if (M < 1 || K < 1 || N < 1 || bm < kTM || bm % kTM || bk < kTK ||
      bk % kTK || (dtype != kF32 && dtype != kBF16) ||
      (M + bm - 1) / bm > kMaxGrid || (M + kTM - 1) / kTM > kMaxGrid)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == kF32
          ? launch<float>(a, b, M, K, N, bm, bk, out, gated, s)
          : launch<__nv_bfloat16>(a, b, M, K, N, bm, bk, out, gated, s));
}
