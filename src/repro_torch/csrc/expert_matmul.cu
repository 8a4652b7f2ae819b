// K8: the grouped gated expert product of a dropless mixture of experts.
//
// A decode step of DeepSeek-V2-Lite routes each of its 128 rows to 6 of 64
// experts: 768 (row, expert) pairs, sorted by expert, so expert e's rows
// are x[offsets[e] .. offsets[e + 1]) and every expert is touched. Its
// products read each touched expert's weights once: 28.8 GB a step over
// 26 layers, 91% of the step's weight bytes, at ~12 rows an expert (about
// 24 FLOP a weight byte, far below the 295 a byte of the bfloat16 tensor
// cores): so what bounds K8 is reading the weights, and a loop over the
// experts (64 x 3 x 26 launches a step) would leave the card idle between
// launches. One launch computes one projection over every expert's
// segment:
//   * One block per (column tile of 64, expert, row tile of 64): the grid
//     holds as many row tiles an expert as the most rows an expert can
//     hold (the tokens of the call), and a block whose row tile starts at
//     or past its expert's segment end returns before its first load (the
//     offsets stay on the card; the host never reads them).
//   * K2's wide route machinery (hopper.cuh): a ring of shared-memory
//     stages of 64 k, fed by TMA from one producer warp -- the x tile [64
//     rows from the segment's start, 64 k] and the expert's weight tile
//     [64 k, 64 columns], the weights seen as one [E K, N] array so that
//     expert e's k0 is row e K + k0 (K is a whole number of stages, so a
//     stage never reaches the next expert's) -- and one consumer
//     warpgroup of wgmma.mma_async m64n64k16, bf16 in, float32
//     accumulators, each stage's sum added into a second float32
//     accumulator as K2's are. Rows past the segment (the next expert's)
//     are multiplied and not written; rows past the array land as TMA's
//     zeros.
//   * Gated (w_up given): the gate and up tiles share the x tile and the
//     stage, two accumulators, and the epilogue writes SiLU(gate) * up
//     rounded as the model's bfloat16 gated MLP rounds it: gate and up
//     each rounded to bfloat16, then exp, 1 + e, the quotient, the
//     product with the gate and the product with up, each rounded.
//   * K2's row gate: while the tensor cores work on a stage, each consumer
//     warp ORs the bits of its 16 rows of the x tile; a row with no
//     nonzero word in all of K is written +0.0.
//   * No K split and no atomics: a row's sums are in k order inside one
//     block, whatever rows share its tile or its call, so a token's result
//     does not depend on its batch mates.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hk;

constexpr int kBM = 64;                   // rows of a tile (a warpgroup)
constexpr int kBN = 64;                   // columns of a tile
constexpr int kKS = 64;                   // k a stage: 128-byte rows
constexpr int kThreads = 4 * 32 + 32;     // a consumer warpgroup + producer
constexpr int kABytes = kBM * kKS * 2;
constexpr int kBBytes = kKS * kBN * 2;
constexpr int kAcc = kBN / 2;             // floats a thread an accumulator

template <bool GLU>
struct Shape {
  static constexpr int kStageBytes = kABytes + (GLU ? 2 : 1) * kBBytes;
  static constexpr int kStages = GLU ? 4 : 6;   // two blocks an SM
  static constexpr int kSmem = 1024 + kStages * kStageBytes + 2 * kStages * 8;
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// SiLU(g) * u with every step rounded to bfloat16, as the model's gated
// MLP computes it in bfloat16 (models/layers.py::silu): the sum of each
// product rounded once, exp(-g), 1 + e, 1 / (1 + e), g times it, times u
// (rounded by the store)
__device__ __forceinline__ float silu_mul(float g, float u) {
  g = round_bf16(g);
  u = round_bf16(u);
  const float e = round_bf16(expf(-g));
  const float sig = round_bf16(__fdiv_rn(1.0f, round_bf16(e + 1.0f)));
  return round_bf16(g * sig) * u;
}

// out[P, N] (bf16): per expert e, rows offsets[e] .. offsets[e + 1] of
// x[P, K] times w0[e] ([K, N] rows e K .. e K + K - 1 of the map), or,
// with GLU, SiLU(x w0[e]) * (x w1[e]).
template <bool GLU>
__global__ void __launch_bounds__(kThreads, 2)
expert_kernel(const __grid_constant__ CUtensorMap map_x,
              const __grid_constant__ CUtensorMap map_w0,
              const __grid_constant__ CUtensorMap map_w1,
              const int* __restrict__ offsets, bf16* __restrict__ out, int K,
              int N) {
  using S = Shape<GLU>;
  const int e = blockIdx.y;
  const int seg1 = offsets[e + 1];
  const int m0 = offsets[e] + kBM * blockIdx.z;
  if (m0 >= seg1) return;   // past the segment: the whole block, at once
  const int n0 = blockIdx.x * kBN;
  const int wrow = e * K;   // the expert's first row of the weight map

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::kStages *
                                               S::kStageBytes);
  uint64_t* empty = full + S::kStages;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {   // the producer warp: the ring's TMA loads
    if (lane == 0) {
      prefetch_map(&map_x);
      prefetch_map(&map_w0);
      if (GLU) prefetch_map(&map_w1);
      int s = 0;
      uint32_t phase = 0;
      for (int k0 = 0; k0 < K; k0 += kKS) {
        mbar_wait(&empty[s], phase ^ 1);
        uint8_t* stage = smem + s * S::kStageBytes;
        mbar_expect_tx(&full[s], S::kStageBytes);
        tma_load(stage, &map_x, k0, m0, &full[s]);
        tma_load(stage + kABytes, &map_w0, n0, wrow + k0, &full[s]);
        if (GLU)
          tma_load(stage + kABytes + kBBytes, &map_w1, n0, wrow + k0,
                   &full[s]);
        if (++s == S::kStages) { s = 0; phase ^= 1; }
      }
    }
    __syncwarp();
    return;
  }

  // the consumer warpgroup; the m64n64 accumulator layout: thread (warp
  // w4, lane l) holds rows 16 w4 + l / 4 and + 8, columns 8 j + 2 (l % 4)
  // and + 1
  const int w4 = warp;
  const int row0 = 16 * w4 + lane / 4, col0 = 2 * (lane % 4);
  float acc0[kAcc], tot0[kAcc], acc1[GLU ? kAcc : 1], tot1[GLU ? kAcc : 1];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc0[i] = tot0[i] = 0.0f;
  if constexpr (GLU) {
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc1[i] = tot1[i] = 0.0f;
  }
  uint32_t bits = 0;   // the words this lane tests, ORed
  int s = 0;
  uint32_t phase = 0;
  for (int k0 = 0; k0 < K; k0 += kKS) {
    mbar_wait(&full[s], phase);
    const uint8_t* stage = smem + s * S::kStageBytes;
    const uint32_t a_addr = smem_addr(stage);
    const uint32_t b_addr = a_addr + kABytes;
    fence_operands(acc0);
    if constexpr (GLU) fence_operands(acc1);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kKS / 16; ++kk) {
      // A: K-major 128-byte rows, 8-row groups 1024 bytes apart, k16 steps
      // 32 bytes into the row. B: N-major, one 64-column box of 64 rows,
      // 8-row groups 1024 bytes apart, k16 steps 16 rows (2048 bytes) down
      // (K2's wide route's descriptors)
      const uint64_t da = make_desc(a_addr + kk * 32, 16, 16 * kKS, 1);
      const uint64_t db0 = make_desc(b_addr + kk * 2048, kKS * 128, 1024, 1);
      wgmma(acc0, da, db0, kk > 0);
      if constexpr (GLU) {
        const uint64_t db1 =
            make_desc(b_addr + kBBytes + kk * 2048, kKS * 128, 1024, 1);
        wgmma(acc1, da, db1, kk > 0);
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // the row gate while the tensor cores work: lanes 2 i and 2 i + 1 test
    // the two halves of row 16 w4 + i (a row is 128 bytes; the swizzle
    // moves 16-byte pieces within it)
    const uint4* half = reinterpret_cast<const uint4*>(
        stage + (16 * w4 + lane / 2) * kKS * 2) + lane % 2 * 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint4 u = half[i];
      bits |= u.x | u.y | u.z | u.w;
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_operands(acc0);
    if constexpr (GLU) fence_operands(acc1);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
#pragma unroll
    for (int i = 0; i < kAcc; ++i) tot0[i] += acc0[i];
    if constexpr (GLU) {
#pragma unroll
      for (int i = 0; i < kAcc; ++i) tot1[i] += acc1[i];
    }
    if (++s == S::kStages) { s = 0; phase ^= 1; }
  }
  bits |= __shfl_xor_sync(0xFFFFFFFFu, bits, 1);
  // bit 2 i (and 2 i + 1): row 16 w4 + i has a nonzero word
  const uint32_t live = __ballot_sync(0xFFFFFFFFu, bits != 0);
#pragma unroll
  for (int i = 0; i < kAcc; i += 2) {
    const int r = row0 + ((i & 2) ? 8 : 0);
    const int m = m0 + r, n = n0 + col0 + 8 * (i / 4);
    if (m < seg1 && n < N) {   // N a multiple of 8: n + 1 < N too
      const bool on = live >> (2 * (r - 16 * w4)) & 1;
      float v0 = 0.0f, v1 = 0.0f;
      if (on) {
        if constexpr (GLU) {
          v0 = silu_mul(tot0[i], tot1[i]);
          v1 = silu_mul(tot0[i + 1], tot1[i + 1]);
        } else {
          v0 = tot0[i];
          v1 = tot0[i + 1];
        }
      }
      *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(m) * N +
                                         n) = __floats2bfloat162_rn(v0, v1);
    }
  }
}

template <bool GLU>
cudaError_t launch(const void* x, const void* w0, const void* w1,
                   const int* offsets, void* out, int P, int K, int N, int E,
                   int row_tiles, cudaStream_t stream) {
  using S = Shape<GLU>;
  const auto kernel = expert_kernel<GLU>;
  CUtensorMap map_x, map_w0, map_w1;
  if (!cached_map(&map_x, x, P, K, kBM, kKS) ||
      !cached_map(&map_w0, w0, E * K, N, kKS, kBN))
    return cudaErrorInvalidValue;
  if (GLU) {
    if (!cached_map(&map_w1, w1, E * K, N, kKS, kBN))
      return cudaErrorInvalidValue;
  } else {
    map_w1 = map_w0;   // not read
  }
  static bool ready = false;   // its shared memory
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const dim3 grid((N + kBN - 1) / kBN, E, row_tiles);
  kernel<<<grid, kThreads, S::kSmem, stream>>>(
      map_x, map_w0, map_w1, offsets, static_cast<bf16*>(out), K, N);
  return cudaGetLastError();
}

}  // namespace

// K8: out[P, N] = per expert e, x[offsets[e] .. offsets[e + 1]) @ w[e]
// (w_up null), or SiLU(x_e @ w[e]) * (x_e @ w_up[e]); x [P, K], w and w_up
// [E, K, N], out [P, N], all bfloat16 and contiguous, offsets [E + 1]
// int32 on the card, no segment longer than row_tiles * tile_m rows
// (tile_m must be 64), K a multiple of 64, N of 8, every base 16-byte
// aligned. The launch goes to stream on device, made current for it
// where it is not. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int em_expert_matmul(const void* x, const void* w,
                                const void* w_up, const void* offsets,
                                void* out, int P, int K, int N, int E,
                                int row_tiles, int tile_m, int device,
                                void* stream) {
  int current = device;
  if (cudaGetDevice(&current) != cudaSuccess || current != device) {
    if (cudaSetDevice(device) != cudaSuccess)
      return static_cast<int>(cudaErrorInvalidDevice);
    const int err = em_expert_matmul(x, w, w_up, offsets, out, P, K, N, E,
                                     row_tiles, tile_m, device, stream);
    cudaSetDevice(current);
    return err;
  }
  if (P < 1 || K < 1 || N < 1 || E < 1 || E > 65535 || row_tiles < 1 ||
      row_tiles > 65535 || tile_m != kBM || K % kKS || N % 8 ||
      static_cast<long long>(E) * K > 0x7FFFFFFF ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16 ||
      reinterpret_cast<uintptr_t>(w_up) % 16 || !offsets)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const int* off = static_cast<const int*>(offsets);
  const cudaError_t err =
      w_up ? launch<true>(x, w, w_up, off, out, P, K, N, E, row_tiles, st)
           : launch<false>(x, w, nullptr, off, out, P, K, N, E, row_tiles,
                           st);
  return static_cast<int>(err == cudaSuccess ? cudaGetLastError() : err);
}
