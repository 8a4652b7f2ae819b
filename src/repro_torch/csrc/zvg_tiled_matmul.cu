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
// What bounds it on an H100: 2*M*K*N operations of the live tiles at
// 989 TFLOP/s (the bfloat16 tensor-core rate), or a and b read once and
// out written once at 3.35 TB/s. Over ResNet50's 54 sites at 224 px that
// is 8.2 GFLOP (8.3 us) against about 139 MB (41.5 us): bytes bound it.
// The first Hopper version of this kernel ran float32 FMAs on the SIMT
// pipes from synchronously staged tiles (0.17% of the tensor-core rate)
// and gave the 7 x 7 sites (M = 49) 8 blocks walking K = 4608.
//
// Launches, all on the caller's stream:
//   * gate_kernel, one block per (m, k) tile: its threads test the tile's
//     values with 16-byte loads where the rows allow it and meet in
//     __syncthreads_or.
//   * bfloat16 operands: wgmma_kernel, one block per tile_m x tile_n
//     output tile (tile_m 64 or 128, dividing bm; tile_n 64 or 128) and
//     k split. A ring of 4 shared-memory stages holds an A tile [tile_m,
//     kS] (K-major) and a B tile [kS, tile_n] (N-major: b is [K, N]
//     row-major, so wgmma reads B transposed), both loaded by TMA
//     (cp.async.bulk.tensor, one mbarrier per stage) with 128-byte
//     swizzle (A: the swizzle of its kS-wide rows, 64/32-byte for kS 32/16).
//     One producer warp reads the gated map and issues loads only for the
//     live stages; a stage is skipped where every [bm, bk] tile that its
//     rows and k touch is gated (stage_gated). One or two consumer
//     warpgroups (64 rows each) run wgmma.mma_async m64n{tile_n}k16 (bf16
//     in, float32 accumulators in registers) on each stage that arrives
//     and add the stage's sum into a second float32 accumulator, so no sum
//     runs longer than kS products inside the tensor core. kS (64, 32 or
//     16) is the largest that divides bk (64 where none does), and tile_m
//     is 128 only where it divides bm: on the main path's 128-blocks every
//     skipped stage lies inside one gated tile and the kernel skips what
//     the map marks, and at any other block (the JAX package takes any)
//     it skips less but computes the same product. A block whose every
//     stage is gated writes +0.0.
//   * Split-K where the output tiles number fewer than the SMs (the
//     planner, kernels/zvg_matmul/kernel.py::tiled_plan, picks the split
//     as whole bk tiles rounded up to whole stages, at most 16): the
//     splits of an output
//     tile form a thread-block cluster. Each sends its float32 sums of
//     every row to the block that owns the row (distributed shared
//     memory), and after one cluster barrier each block sums its share of
//     the rows in split order and writes them: no workspace, no atomics,
//     no second pass, and a result that does not change from run to run.
//     (A first version wrote partials to global memory and had the last
//     block of each tile, found by an atomic ticket, sum them: a workspace
//     to allocate a call, and a fence, an atomic and the partials' reads
//     on every split site's critical path.)
//   * Operands TMA cannot describe (a row stride that is not a multiple of
//     16 bytes) are zero-padded by the wrapper to a multiple of 8 in K and
//     N before the launch; zeros change neither the product nor the map,
//     which the gate launch takes on the unpadded a.
//
// Float32 operands keep the first version's SIMT kernel (tiled_kernel:
// 64 x 64 output tiles, k steps of 16 staged in shared memory, 4 x 4 fmaf
// patches a thread, a step skipped by the same rule as a stage). They run in no main path, only in the test cases,
// and a float32 product on the tensor cores would be TF32, about three
// decimal digits, far outside the stated tolerance.

#include <cstdint>
#include <mutex>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kTM = 64;          // SIMT route: output rows per block
constexpr int kTN = 64;          // SIMT route: output columns per block
constexpr int kTK = 16;          // SIMT route: k per staged step
constexpr int kPatch = 4;        // SIMT route: a thread's patch is 4 x 4
constexpr int kMaxGrid = 65535;
constexpr int kStages = 4;       // wgmma route: shared-memory ring depth
constexpr int kMaxSplits = 16;   // wgmma route: blocks a cluster, k splits

enum Dtype { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// value != 0 on raw words: -0.0 is zero, NaN is not
__device__ __forceinline__ bool live4(uint4 u, float) {
  return ((u.x | u.y | u.z | u.w) & 0x7FFFFFFFu) != 0u;
}
__device__ __forceinline__ bool live4(uint4 u, __nv_bfloat16) {
  return ((u.x | u.y | u.z | u.w) & 0x7FFF7FFFu) != 0u;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gate_kernel(const T* __restrict__ a, int M, int K, int bm, int bk, bool vec,
            int32_t* __restrict__ gated) {
  const int kb = blockIdx.x, mb = blockIdx.y;
  const int m0 = mb * bm, k0 = kb * bk;
  const int rows = min(bm, M - m0), cols = min(bk, K - k0);
  int live = 0;
  if (vec) {  // 16-byte loads: K and bk multiples of 16 / sizeof(T)
    constexpr int kV = 16 / sizeof(T);
    const int per_row = cols / kV;
    for (int i = threadIdx.x; i < rows * per_row && !live; i += kThreads) {
      const int r = i / per_row, c = i % per_row;
      const uint4 u = *reinterpret_cast<const uint4*>(
          a + static_cast<size_t>(m0 + r) * K + k0 + c * kV);
      live = live4(u, T());
    }
  } else {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int r = warp; r < rows && !live; r += kThreads / 32) {
      const T* row = a + static_cast<size_t>(m0 + r) * K + k0;
      for (int c = lane; c < cols; c += 32)
        live |= to_f(row[c]) != 0.0f;   // NaN != 0: live; -0.0: zero
    }
  }
  live = __syncthreads_or(live);
  if (threadIdx.x == 0)
    gated[static_cast<size_t>(mb) * gridDim.x + kb] = live ? 0 : 1;
}

// Whether every [bm, bk] tile of the map that a block's rows [m0, m1) and
// one k stage [k0, k1) touch is gated, for the warp (every lane returns the
// same). On the main path's blocks (bm and bk multiples of the row tile and
// the stage) that is one entry of the map; smaller or unaligned blocks
// touch several, and a stage is skipped only where all are gated.
__device__ __forceinline__ bool stage_gated(const int32_t* __restrict__ gated,
                                            int Kb, int bm, int bk, int m0,
                                            int m1, int k0, int k1) {
  const int mb0 = m0 / bm, kb0 = k0 / bk;
  const int nm = (m1 - 1) / bm - mb0 + 1, nk = (k1 - 1) / bk - kb0 + 1;
  bool live = false;
  for (int i = threadIdx.x % 32; i < nm * nk && !live; i += 32)
    live = !gated[static_cast<size_t>(mb0 + i / nk) * Kb + kb0 + i % nk];
  return !__any_sync(0xFFFFFFFFu, live);
}

// ---------------------------------------------------------- float32 route
__global__ void __launch_bounds__(kThreads)
tiled_kernel(const float* __restrict__ a, const float* __restrict__ b,
             const int32_t* __restrict__ gated, int M, int K, int N, int bm,
             int bk, int Kb, float* __restrict__ out) {
  __shared__ float As[kTK][kTM + 4];   // A slice, transposed: As[k][m]
  __shared__ float Bs[kTK][kTN];
  const int tid = threadIdx.x;
  const int tx = tid % (kTN / kPatch), ty = tid / (kTN / kPatch);
  const int m0 = blockIdx.y * kTM, n0 = blockIdx.x * kTN;
  const int m1 = min(M, m0 + kTM);
  float acc[kPatch][kPatch] = {};
  for (int k0 = 0; k0 < K; k0 += kTK) {
    // the same for every thread
    if (stage_gated(gated, Kb, bm, bk, m0, m1, k0, min(K, k0 + kTK)))
      continue;
#pragma unroll
    for (int i = 0; i < kTM * kTK / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / kTK, c = e % kTK;
      const int m = m0 + r, k = k0 + c;
      As[c][r] = m < M && k < K ? a[static_cast<size_t>(m) * K + k] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kTK * kTN / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / kTN, c = e % kTN;
      const int k = k0 + r, n = n0 + c;
      Bs[r][c] = k < K && n < N ? b[static_cast<size_t>(k) * N + n] : 0.0f;
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

// ------------------------------------------------ bfloat16 route: wgmma
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), swizzle mode (1: 128 B, 2: 64 B,
// 3: 32 B). Every tile starts on a 1024-byte boundary, so the base
// offset field stays 0.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo,
                                              uint32_t swizzle) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 |
         static_cast<uint64_t>(swizzle) << 62;
}

template <int NREG>
__device__ __forceinline__ void fence_operands(float (&d)[NREG]) {
#pragma unroll
  for (int i = 0; i < NREG; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (+)= A[64 x 16] (K-major) x B[16 x 64] (N-major), bf16 in, f32 out
__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t da,
                                      uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (+)= A[64 x 16] (K-major) x B[16 x 128] (N-major), bf16 in, f32 out
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t da,
                                      uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Shapes of one instantiation: NWG consumer warpgroups (tile_m = 64 NWG),
// tile_n = BN columns, k stage KS.
template <int NWG, int BN, int KS>
struct Tile {
  static constexpr int kBM = 64 * NWG;
  static constexpr int kABytes = kBM * KS * 2;
  static constexpr int kBBytes = KS * BN * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kThreads = NWG * 128 + 32;   // + the producer warp
  static constexpr int kSmem = kStages * kStageBytes + 2 * kStages * 8 + 1024;
  // A rows are KS * 2 bytes: 128-, 64- or 32-byte swizzle
  static constexpr uint32_t kASwizzle = KS == 64 ? 1 : KS == 32 ? 2 : 3;
  static constexpr int kAcc = BN / 2;                // floats a thread
};

template <int NWG, int BN, int KS>
__global__ void __launch_bounds__(Tile<NWG, BN, KS>::kThreads, 1)
wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
             const __grid_constant__ CUtensorMap map_b,
             const int32_t* __restrict__ gated, int M, int K, int N, int bm,
             int bk, int Kb, int k_per_split, float* __restrict__ out) {
  using T = Tile<NWG, BN, KS>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * T::kStageBytes);
  uint64_t* empty = full + kStages;
  // recv[split][share][BN]: the splits' sums of this block's share of the
  // tile's rows
  float* recv = reinterpret_cast<float*>(empty + kStages);
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = cluster.num_blocks();     // the cluster spans K
  const int split = cluster.block_rank();
  const int share = (T::kBM + splits - 1) / splits;   // rows a block sums

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * T::kBM;
  const int m1 = min(M, m0 + T::kBM);
  // the split's k range, whole stages: [ks0, ks1)
  const int ks0 = split * k_per_split, ks1 = min(K, ks0 + k_per_split);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWG * 4);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == NWG * 4) {   // the producer warp: TMA loads of live stages
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n"
                   :: "l"(reinterpret_cast<uint64_t>(&map_a)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n"
                   :: "l"(reinterpret_cast<uint64_t>(&map_b)) : "memory");
    }
    int s = 0;
    uint32_t phase = 0;
    for (int k0 = ks0; k0 < ks1; k0 += KS) {
      if (stage_gated(gated, Kb, bm, bk, m0, m1, k0, min(K, k0 + KS)))
        continue;
      if (lane == 0) {
        mbar_wait(&empty[s], phase ^ 1);
        uint8_t* stage = smem + s * T::kStageBytes;
        mbar_expect_tx(&full[s], T::kStageBytes);
        tma_load(stage, &map_a, k0, m0, &full[s]);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load(stage + T::kABytes + j * KS * 128, &map_b, n0 + 64 * j,
                   k0, &full[s]);
      }
      __syncwarp();
      if (++s == kStages) { s = 0; phase ^= 1; }
    }
  } else {   // consumer warpgroups: rows m0 + 64 wg .. + 63
    const int wg = warp / 4;
    float acc[T::kAcc], tot[T::kAcc];
#pragma unroll
    for (int i = 0; i < T::kAcc; ++i) acc[i] = tot[i] = 0.0f;
    int s = 0;
    uint32_t phase = 0;
    for (int k0 = ks0; k0 < ks1; k0 += KS) {
      if (stage_gated(gated, Kb, bm, bk, m0, m1, k0, min(K, k0 + KS)))
        continue;
      {
        mbar_wait(&full[s], phase);
        const uint32_t a_addr = smem_addr(smem + s * T::kStageBytes) +
                                wg * 64 * KS * 2;
        const uint32_t b_addr = smem_addr(smem + s * T::kStageBytes) +
                                T::kABytes;
        fence_operands(acc);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < KS / 16; ++kk) {
          // A: K-major, rows KS * 2 bytes apart, 8-row groups 16 KS bytes
          // apart, k16 steps 32 bytes into the row. B: N-major, 64-column
          // boxes of KS rows (KS * 128 bytes) side by side, 8-row groups
          // 1024 bytes apart, k16 steps 16 rows (2048 bytes) down.
          const uint64_t da = make_desc(a_addr + kk * 32, 16, 16 * KS,
                                        T::kASwizzle);
          const uint64_t db = make_desc(b_addr + kk * 2048, KS * 128, 1024,
                                        1);
          wgmma(acc, da, db, kk > 0);
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fence_operands(acc);
        if (lane == 0) mbar_arrive(&empty[s]);
#pragma unroll
        for (int i = 0; i < T::kAcc; ++i) tot[i] += acc[i];
        if (++s == kStages) { s = 0; phase ^= 1; }
      }
    }
    // the m64nBN accumulator layout: thread (warp w4, lane l) holds rows
    // 16 w4 + l / 4 and + 8, columns 8 j + 2 (l % 4) and + 1
    const int row0 = wg * 64 + 16 * (warp % 4) + lane / 4;
    const int col0 = 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < T::kAcc; ++i) {
      const int r = row0 + ((i & 2) ? 8 : 0);
      const int c = col0 + 8 * (i / 4) + (i & 1);
      if (splits == 1) {
        if (m0 + r < M && n0 + c < N)
          out[static_cast<size_t>(m0 + r) * N + n0 + c] = tot[i];
      } else {   // to the block that sums row r
        *cluster.map_shared_rank(
            recv + (split * share + r % share) * BN + c, r / share) = tot[i];
      }
    }
  }
  if (splits == 1) return;

  // this block's share of the tile's rows: the splits' sums in split order
  cluster.sync();   // every split's sums are in
  const int r0 = split * share, rn = min(T::kBM, r0 + share) - r0;
  for (int i = threadIdx.x; i < rn * BN; i += T::kThreads) {
    const int rl = i / BN, c = i % BN;
    const int m = m0 + r0 + rl, n = n0 + c;
    if (m >= M || n >= N) continue;
    float sum = recv[rl * BN + c];
    for (int q = 1; q < splits; ++q) sum += recv[(q * share + rl) * BN + c];
    out[static_cast<size_t>(m) * N + n] = sum;
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime so
// that the library need not link libcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A 2-D bf16 map of a row-major [rows, cols] array, boxes [box_rows,
// box_cols] (box_cols * 2 bytes: 128, 64 or 32 with the same swizzle).
// A map depends on nothing but these arguments, so the last kMaps made
// are kept and a call with the same arguments (the same weights, say)
// takes its map from there.
constexpr int kMaps = 256;

struct MapEntry {
  const void* base;
  int rows, cols, box_rows, box_cols;
  CUtensorMap map;
};

bool make_map(CUtensorMap* map, const void* base, int rows, int cols,
              int box_rows, int box_cols) {
  static MapEntry cache[kMaps];
  static int next = 0;
  static std::mutex lock;
  const std::lock_guard<std::mutex> guard(lock);
  for (const MapEntry& e : cache)
    if (e.base == base && e.rows == rows && e.cols == cols &&
        e.box_rows == box_rows && e.box_cols == box_cols) {
      *map = e.map;
      return true;
    }
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUtensorMapSwizzle swizzle =
      box_cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                     : box_cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                      : CU_TENSOR_MAP_SWIZZLE_32B;
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
             const_cast<void*>(base), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  cache[next] = {base, rows, cols, box_rows, box_cols, *map};
  next = (next + 1) % kMaps;
  return true;
}

// The bfloat16 route's arguments, as the entry takes them.
struct WgmmaArgs {
  const void* ap;
  const void* bp;
  const int32_t* gated;
  int M, K, Kp, N, Np, bm, bk, Kb, k_per_split;
  float* out;
};

template <int NWG, int BN, int KS>
cudaError_t launch_wgmma(const WgmmaArgs& g, cudaStream_t stream) {
  using T = Tile<NWG, BN, KS>;
  const auto kernel = wgmma_kernel<NWG, BN, KS>;
  CUtensorMap map_a, map_b;
  if (!make_map(&map_a, g.ap, g.M, g.Kp, T::kBM, KS) ||
      !make_map(&map_b, g.bp, g.Kp, g.Np, KS, 64))
    return cudaErrorInvalidValue;
  const int splits = (g.K + g.k_per_split - 1) / g.k_per_split;
  const int share = (T::kBM + splits - 1) / splits;
  const size_t smem =
      T::kSmem + (splits > 1 ? sizeof(float) * splits * share * BN : 0);
  static size_t sized = 0;
  if (smem > sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    sized = smem;
  }
  static bool wide = false;   // clusters of more than the portable 8
  if (splits > 8 && !wide) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    wide = true;
  }
  const dim3 grid((g.N + BN - 1) / BN, (g.M + T::kBM - 1) / T::kBM, splits);
  if (splits == 1) {   // a cluster of one: the plain launch is cheaper
    kernel<<<grid, T::kThreads, smem, stream>>>(
        map_a, map_b, g.gated, g.M, g.K, g.N, g.bm, g.bk, g.Kb,
        g.k_per_split, g.out);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(T::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, map_a, map_b, g.gated, g.M, g.K,
                            g.N, g.bm, g.bk, g.Kb, g.k_per_split, g.out);
}

template <int NWG, int BN>
cudaError_t dispatch_ks(int ks, const WgmmaArgs& g, cudaStream_t st) {
  if (ks == 64) return launch_wgmma<NWG, BN, 64>(g, st);
  if (ks == 32) return launch_wgmma<NWG, BN, 32>(g, st);
  return launch_wgmma<NWG, BN, 16>(g, st);
}

}  // namespace

// out[M, N] (float32) = a[M, K] @ b[K, N], a and b of one dtype (0:
// float32, 1: bfloat16), skipping every stage of the product whose rows
// and k lie wholly in [bm, bk] tiles of a that hold only zeros, and
// gated[ceil(M / bm), ceil(K / bk)] (int32, 1 = a tile of zeros), for any
// bm, bk >= 1.
//
// bfloat16: ap [M, Kp] and bp [Kp, Np] are a and b zero-padded to row
// strides of a multiple of 16 bytes (the same tensors where they already
// are), 16-byte aligned; the gate reads a itself. tile_m (64 or 128) and
// tile_n (64 or 128) are the output tile, k_stage (64, 32 or 16) the k of
// a shared-memory stage and k_per_split (a multiple of k_stage) the k each
// split walks (at most 16 splits, a cluster). Float32: ap, bp, Kp, Np,
// tile_m, tile_n, k_stage and k_per_split are not read. The launches go to
// stream on device, made current for them where it is not.
// Returns cudaGetLastError() after the launches (cudaErrorInvalidValue
// for arguments the kernels do not take).
extern "C" int zt_zvg_tiled_matmul(const void* a, const void* ap,
                                   const void* bp, int dtype, int M, int K,
                                   int Kp, int N, int Np, int bm, int bk,
                                   int tile_m, int tile_n, int k_stage,
                                   int k_per_split, float* out,
                                   int32_t* gated, int device,
                                   void* stream) {
  int current = device;
  if (cudaGetDevice(&current) != cudaSuccess || current != device) {
    if (cudaSetDevice(device) != cudaSuccess)
      return static_cast<int>(cudaErrorInvalidDevice);
    const int err = zt_zvg_tiled_matmul(a, ap, bp, dtype, M, K, Kp, N, Np,
                                        bm, bk, tile_m, tile_n, k_stage,
                                        k_per_split, out, gated, device,
                                        stream);
    cudaSetDevice(current);
    return err;
  }
  if (M < 1 || K < 1 || N < 1 || bm < 1 || bk < 1 ||
      (dtype != kF32 && dtype != kBF16) ||
      (M + bm - 1) / bm > kMaxGrid || (M + kTM - 1) / kTM > kMaxGrid)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const int Mb = (M + bm - 1) / bm, Kb = (K + bk - 1) / bk;
  const bool bf16 = dtype == kBF16;
  if (bf16) {
    const int splits =
        k_per_split < 1 ? 0 : (K + k_per_split - 1) / k_per_split;
    if (Kp < K || Kp % 8 || Np < N || Np % 8 ||
        (k_stage != 64 && k_stage != 32 && k_stage != 16) ||
        k_per_split < 1 || k_per_split % k_stage ||
        (tile_m != 64 && tile_m != 128) || (tile_n != 64 && tile_n != 128) ||
        reinterpret_cast<uintptr_t>(ap) % 16 ||
        reinterpret_cast<uintptr_t>(bp) % 16 ||
        (M + tile_m - 1) / tile_m > kMaxGrid || splits > kMaxSplits)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const int elem = bf16 ? 2 : 4;
  const bool vec = (K * elem) % 16 == 0 && (bk * elem) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a) % 16 == 0;
  if (bf16)
    gate_kernel<__nv_bfloat16><<<dim3(Kb, Mb), kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(a), M, K, bm, bk, vec, gated);
  else
    gate_kernel<float><<<dim3(Kb, Mb), kThreads, 0, st>>>(
        static_cast<const float*>(a), M, K, bm, bk, vec, gated);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!bf16) {
    const dim3 grid((N + kTN - 1) / kTN, (M + kTM - 1) / kTM);
    tiled_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(a), static_cast<const float*>(bp), gated,
        M, K, N, bm, bk, Kb, out);
    return static_cast<int>(cudaGetLastError());
  }
  const WgmmaArgs g{ap, bp, gated, M, K, Kp, N, Np, bm, bk, Kb, k_per_split,
                    out};
  if (tile_m == 128)
    err = tile_n == 128 ? dispatch_ks<2, 128>(k_stage, g, st)
                        : dispatch_ks<2, 64>(k_stage, g, st);
  else
    err = tile_n == 128 ? dispatch_ks<1, 128>(k_stage, g, st)
                        : dispatch_ks<1, 64>(k_stage, g, st);
  return static_cast<int>(err);
}
