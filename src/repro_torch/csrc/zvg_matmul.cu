// The serving decode path's two kernels, for Hopper (sm_90a). Built by
// repro_torch/kernels/_build.py with nvcc into a shared library with a
// plain C interface, loaded with ctypes.
//
// K2, zm_gated_row_matmul, replaces the TPU kernel
//   src/repro/kernels/zvg_matmul/fused.py::gated_row_matmul
// out[M, N] = x[M, K] @ w[K, N] with per-row zero-value gating: a row whose
// words are all +0.0 (a test on the raw bits, so -0.0 and subnormal rows
// compute) skips the multiply-accumulates and is filled with +0.0. The
// fill is the port's own ungated product of such a row: the plain version
// (torch.matmul) and an accumulator started at +0.0 both give +0.0. (The
// reference fills -0.0 in the columns where all of w[:, j] is negative;
// XLA's own dot gives +0.0 there, so comparisons across the two
// frameworks treat +0.0 and -0.0 as equal.) x and w are bfloat16 or
// float32, in any pair; the output is float32 when either is, else
// bfloat16, rounded once to nearest even from the float32 accumulator.
//
// The TPU kernel's grid is (M,): one row per step, the whole weight per
// step, so the card would read w M times. Here each block owns a tile of
// kTileN columns and reads its slice of w once for every row: the block
// first tests every row's bits (__syncthreads_or), writes the fill for the
// dead rows, then runs the multiply-accumulates for up to kRows live rows
// per pass. A thread holds kVec adjacent columns (one 16-byte load of
// bfloat16 weights per k) and every kKSlices-th k; the partial sums meet
// by warp shuffles and then in shared memory, in a fixed order, so a
// result does not change from run to run.
//
// Bound on an H100: at decode (M = 4) the product does 2*M*K*N operations
// on K*N weight words, about 4 operations per byte read, far below the 295
// at which bfloat16 tensor cores would bound it: reading w once at
// 3.35 TB/s is the bound (about 0.28 ms for the 928 MB of bfloat16
// weights one Qwen1.5-0.5B decode step reads). No tensor cores, TMA or
// split-K across blocks yet: a layer of N = 1024 columns runs only 32
// blocks, which the later change that makes it fast addresses.
//
// K3, zm_fused_matmul_counters, replaces the TPU kernel
//   src/repro/kernels/zvg_matmul/fused.py::fused_matmul_counters
// One launch emits K2's product of a[B, K] and w[K, N] and, in separate
// block ranges of the same grid, the coding-menu counters of the decode
// streams through the walk of the fused power-counter pass
// (pc::walk_lane in power_counters.cuh, the code K1 runs):
//   * per request row b, the west stream: T = K cycles over lanes_w lanes,
//     the row's bfloat16 words in lane 0 and zero words in the other lanes,
//     which are real words of the padded [1, K] -> [R, K] tile and are
//     counted, in the counters and in rowzeros;
//   * once per batch, the north stream: T = K cycles over lanes_n lanes,
//     w's bfloat16 words in lanes 0..N-1 and zero words in the padding
//     lanes N..lanes_n-1, counted likewise.
// Float words become bfloat16 by round to nearest even, NaN as 0x7FC0 |
// sign << 15. What bounds K3 is the latency of the K-long sequential walk,
// not its bytes (about 1 MB at the serving shapes: bfloat16 activations,
// float32 weights, int32 counters).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "power_counters.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileN = 32;                      // columns per block
constexpr int kVec = 8;                         // columns per thread
constexpr int kColThreads = kTileN / kVec;      // 4 threads span a tile row
constexpr int kKSlices = kThreads / kColThreads;  // 64 k-slices per block
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;                        // live rows per pass
constexpr int kChunkK = 256;                    // k staged per x chunk

enum Dtype { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ bool nonzero_bits(float x) {
  return __float_as_uint(x) != 0u;
}
__device__ __forceinline__ bool nonzero_bits(__nv_bfloat16 x) {
  return __bfloat16_as_ushort(x) != 0u;
}

// kVec weights of row k from column col0, as floats (0 past N).
__device__ __forceinline__ void load_w(const float* __restrict__ w, int k,
                                       int col0, int N, bool vec,
                                       float (&v)[kVec]) {
  const float* row = w + static_cast<size_t>(k) * N + col0;
  if (vec && col0 + kVec <= N) {
    const float4 a = *reinterpret_cast<const float4*>(row);
    const float4 b = *reinterpret_cast<const float4*>(row + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int c = 0; c < kVec; ++c) v[c] = col0 + c < N ? row[c] : 0.f;
  }
}

__device__ __forceinline__ void load_w(const __nv_bfloat16* __restrict__ w,
                                       int k, int col0, int N, bool vec,
                                       float (&v)[kVec]) {
  const __nv_bfloat16* row = w + static_cast<size_t>(k) * N + col0;
  if (vec && col0 + kVec <= N) {
    const uint4 u = *reinterpret_cast<const uint4*>(row);
    const uint32_t words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(words[i] << 16);
      v[2 * i + 1] = __uint_as_float(words[i] & 0xFFFF0000u);
    }
  } else {
#pragma unroll
    for (int c = 0; c < kVec; ++c)
      v[c] = col0 + c < N ? __bfloat162float(row[c]) : 0.f;
  }
}

struct TileSmem {
  float xs[kChunkK][kRows];           // staged live rows of x, as floats
  float red[kWarps][kRows][kTileN];   // per-warp partial sums
  int rows[kRows];                    // the live rows of this pass
};

// Multiply-accumulates of the nl live rows sm.rows[0..nl) for the block's
// column tile starting at n0, written to out.
template <typename TA, typename TW, typename TO>
__device__ __forceinline__ void mac_pass(const TA* __restrict__ x,
                                         const TW* __restrict__ w,
                                         TO* __restrict__ out, int K, int N,
                                         int n0, bool vec, int nl,
                                         TileSmem& sm) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tx = lane & (kColThreads - 1);
  const int ky = warp * (32 / kColThreads) + lane / kColThreads;
  const int col0 = n0 + tx * kVec;
  float acc[kRows][kVec];
#pragma unroll
  for (int j = 0; j < kRows; ++j)
#pragma unroll
    for (int c = 0; c < kVec; ++c) acc[j][c] = 0.f;

  for (int kc = 0; kc < K; kc += kChunkK) {
    __syncthreads();  // the previous chunk is consumed
    for (int i = tid; i < nl * kChunkK; i += kThreads) {
      const int j = i / kChunkK, kk = i % kChunkK;
      sm.xs[kk][j] = kc + kk < K
          ? to_f(x[static_cast<size_t>(sm.rows[j]) * K + kc + kk]) : 0.f;
    }
    __syncthreads();
    const int kend = min(kChunkK, K - kc);
#pragma unroll 4
    for (int kk = ky; kk < kend; kk += kKSlices) {
      float wv[kVec];
      load_w(w, kc + kk, col0, N, vec, wv);
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (j < nl) {
          const float xv = sm.xs[kk][j];
#pragma unroll
          for (int c = 0; c < kVec; ++c) acc[j][c] = fmaf(xv, wv[c], acc[j][c]);
        }
      }
    }
  }
  // the 8 k-slices of a warp, then the warps, in a fixed order
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
#pragma unroll
    for (int c = 0; c < kVec; ++c) {
      float v = acc[j][c];
#pragma unroll
      for (int off = kColThreads; off < 32; off <<= 1)
        v += __shfl_xor_sync(0xFFFFFFFFu, v, off);
      acc[j][c] = v;
    }
  }
  if (lane < kColThreads) {
#pragma unroll
    for (int j = 0; j < kRows; ++j)
      if (j < nl)
#pragma unroll
        for (int c = 0; c < kVec; ++c) sm.red[warp][j][tx * kVec + c] = acc[j][c];
  }
  __syncthreads();
  static_assert(kRows * kTileN == kThreads, "one output per thread");
  const int j = tid / kTileN, c = tid % kTileN;
  if (j < nl && n0 + c < N) {
    float s = 0.f;
#pragma unroll
    for (int wp = 0; wp < kWarps; ++wp) s += sm.red[wp][j][c];
    store(out + static_cast<size_t>(sm.rows[j]) * N + n0 + c, s);
  }
  __syncthreads();  // red and rows are reused by the next pass
}

// One column tile of the gated product: every row's liveness, the fill
// for the dead ones, the multiply-accumulates for the live ones.
template <typename TA, typename TW, typename TO>
__device__ __forceinline__ void gated_tile(const TA* __restrict__ x,
                                           const TW* __restrict__ w,
                                           TO* __restrict__ out, int M,
                                           int K, int N, int tile, bool vec,
                                           TileSmem& sm) {
  const int tid = threadIdx.x;
  const int n0 = tile * kTileN;
  int nl = 0;
  for (int m = 0; m < M; ++m) {
    const TA* xm = x + static_cast<size_t>(m) * K;
    bool any = false;
    for (int k = tid; k < K && !any; k += kThreads) any = nonzero_bits(xm[k]);
    if (__syncthreads_or(any)) {
      if (tid == 0) sm.rows[nl] = m;
      ++nl;  // the same on every thread
    } else if (tid < kTileN && n0 + tid < N) {
      store(out + static_cast<size_t>(m) * N + n0 + tid, 0.f);
    }
    if (nl == kRows || (m == M - 1 && nl > 0)) {
      mac_pass(x, w, out, K, N, n0, vec, nl, sm);
      nl = 0;
    }
  }
}

template <typename TA, typename TW, typename TO>
__global__ void __launch_bounds__(kThreads)
gated_row_matmul_kernel(const TA* __restrict__ x, const TW* __restrict__ w,
                        TO* __restrict__ out, int M, int K, int N, bool vec) {
  __shared__ TileSmem sm;
  gated_tile(x, w, out, M, K, N, blockIdx.x, vec, sm);
}

struct Streams {
  int32_t* wc;       // [B, n_rows_w, lanes_w]
  int32_t* wz;       // [B, K]
  int n_rows_w;
  int lanes_w;
  int west_chunks;   // blocks per west stream
  int32_t* nc;       // [n_rows_n, lanes_n]
  int32_t* nz;       // [K]
  int lanes_n;
};

template <typename TA, typename TW, typename TO, int NSEG>
__global__ void __launch_bounds__(kThreads)
fused_matmul_counters_kernel(const TA* __restrict__ a,
                             const TW* __restrict__ w, TO* __restrict__ out,
                             int B, int K, int N, bool vec, int n_tiles,
                             const Streams s, const pc::Params pw,
                             const pc::Params pn) {
  __shared__ TileSmem sm;
  int bid = blockIdx.x;
  if (bid < n_tiles) {  // the product
    gated_tile(a, w, out, B, K, N, bid, vec, sm);
    return;
  }
  bid -= n_tiles;
  const int warp_base = threadIdx.x & ~31;
  if (bid < B * s.west_chunks) {  // one request row's west stream
    const int b = bid / s.west_chunks;
    const int chunk = (bid % s.west_chunks) * kThreads;
    if (chunk + warp_base >= s.lanes_w) return;  // a whole warp past the edge
    const int lane = chunk + threadIdx.x;
    const TA* ab = a + static_cast<size_t>(b) * K;
    const auto load = [&](int t) {
      return lane == 0 ? pc::bf16_word(ab[t]) : 0u;
    };
    pc::walk_lane<NSEG>(
        load, K, lane < s.lanes_w, s.wz + static_cast<size_t>(b) * K,
        s.wc + static_cast<size_t>(b) * s.n_rows_w * s.lanes_w + lane,
        s.lanes_w, pw);
    return;
  }
  bid -= B * s.west_chunks;  // the north stream
  const int chunk = bid * kThreads;
  if (chunk + warp_base >= s.lanes_n) return;
  const int lane = chunk + threadIdx.x;
  const auto load = [&](int t) {
    return lane < N ? pc::bf16_word(w[static_cast<size_t>(t) * N + lane])
                    : 0u;
  };
  pc::walk_lane<NSEG>(load, K, lane < s.lanes_n, s.nz, s.nc + lane,
                      s.lanes_n, pn);
}

inline bool vec_ok(const void* w, int N) {
  return N % kVec == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
}

template <typename TA, typename TW, typename TO>
cudaError_t launch_gemm(const void* x, const void* w, void* out, int M, int K,
                        int N, cudaStream_t stream) {
  const int tiles = (N + kTileN - 1) / kTileN;
  gated_row_matmul_kernel<TA, TW, TO><<<tiles, kThreads, 0, stream>>>(
      static_cast<const TA*>(x), static_cast<const TW*>(w),
      static_cast<TO*>(out), M, K, N, vec_ok(w, N));
  return cudaGetLastError();
}

template <typename TA, typename TW, typename TO, int NSEG>
cudaError_t launch_fused(const void* a, const void* w, void* out, int B,
                         int K, int N, const Streams& s, const pc::Params& pw,
                         const pc::Params& pn, cudaStream_t stream) {
  const int tiles = (N + kTileN - 1) / kTileN;
  const int north_chunks = (s.lanes_n + kThreads - 1) / kThreads;
  const int blocks = tiles + B * s.west_chunks + north_chunks;
  fused_matmul_counters_kernel<TA, TW, TO, NSEG>
      <<<blocks, kThreads, 0, stream>>>(
          static_cast<const TA*>(a), static_cast<const TW*>(w),
          static_cast<TO*>(out), B, K, N, vec_ok(w, N), tiles, s, pw, pn);
  return cudaGetLastError();
}

template <int NSEG>
cudaError_t dispatch_fused(int a_dtype, int w_dtype, const void* a,
                           const void* w, void* out, int B, int K, int N,
                           const Streams& s, const pc::Params& pw,
                           const pc::Params& pn, cudaStream_t st) {
  using bf = __nv_bfloat16;
  if (a_dtype == kBF16 && w_dtype == kBF16)
    return launch_fused<bf, bf, bf, NSEG>(a, w, out, B, K, N, s, pw, pn, st);
  if (a_dtype == kBF16)
    return launch_fused<bf, float, float, NSEG>(a, w, out, B, K, N, s, pw, pn,
                                                st);
  if (w_dtype == kBF16)
    return launch_fused<float, bf, float, NSEG>(a, w, out, B, K, N, s, pw, pn,
                                                st);
  return launch_fused<float, float, float, NSEG>(a, w, out, B, K, N, s, pw, pn,
                                                 st);
}

inline bool dtypes_ok(int a_dtype, int w_dtype, int out_dtype) {
  const bool in_ok = (a_dtype == kF32 || a_dtype == kBF16) &&
                     (w_dtype == kF32 || w_dtype == kBF16);
  const int want = (a_dtype == kBF16 && w_dtype == kBF16) ? kBF16 : kF32;
  return in_ok && out_dtype == want;
}

}  // namespace

// K2: out[M, N] = gated x[M, K] @ w[K, N], all contiguous, dtype codes
// 0 = float32, 1 = bfloat16 (out float32 unless both inputs are bfloat16).
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// arguments the kernel does not take).
extern "C" int zm_gated_row_matmul(const void* x, int x_dtype, const void* w,
                                   int w_dtype, void* out, int out_dtype,
                                   int M, int K, int N, void* stream) {
  if (M < 1 || K < 1 || N < 1 || !dtypes_ok(x_dtype, w_dtype, out_dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  using bf = __nv_bfloat16;
  const auto st = static_cast<cudaStream_t>(stream);
  if (x_dtype == kBF16 && w_dtype == kBF16)
    return static_cast<int>(launch_gemm<bf, bf, bf>(x, w, out, M, K, N, st));
  if (x_dtype == kBF16)
    return static_cast<int>(
        launch_gemm<bf, float, float>(x, w, out, M, K, N, st));
  if (w_dtype == kBF16)
    return static_cast<int>(
        launch_gemm<float, bf, float>(x, w, out, M, K, N, st));
  return static_cast<int>(
      launch_gemm<float, float, float>(x, w, out, M, K, N, st));
}

// K3: the product out[B, N] of a[B, K] and w[K, N] as K2 computes it, and
// the counters of the B west streams into wc[B, n_rows_w, lanes_w] and
// wz[B, K], and of the north stream into nc[n_rows_n, lanes_n] and nz[K]
// (wz and nz zeroed by the caller). Each edge's CounterSpec comes
// flattened as pc_fused_counters takes it. lanes_n must be at least N.
extern "C" int zm_fused_matmul_counters(
    const void* a, int a_dtype, const void* w, int w_dtype, void* out,
    int out_dtype, int B, int K, int N, int32_t* wc, int32_t* wz,
    int n_rows_w, int lanes_w, int w_segs, const uint32_t* w_seg_masks,
    int w_variants, const uint32_t* w_variant_segs, int w_zvg, int w_hist,
    int32_t* nc, int32_t* nz, int n_rows_n, int lanes_n, int n_segs,
    const uint32_t* n_seg_masks, int n_variants,
    const uint32_t* n_variant_segs, int n_zvg, int n_hist, void* stream) {
  pc::Params pw, pn;
  if (B < 1 || K < 1 || N < 1 || lanes_w < 1 || lanes_n < N ||
      !dtypes_ok(a_dtype, w_dtype, out_dtype) ||
      !pc::make_params(pw, n_rows_w, w_segs, w_seg_masks, w_variants,
                       w_variant_segs, w_zvg, w_hist) ||
      !pc::make_params(pn, n_rows_n, n_segs, n_seg_masks, n_variants,
                       n_variant_segs, n_zvg, n_hist))
    return static_cast<int>(cudaErrorInvalidValue);
  Streams s{wc, wz, n_rows_w, lanes_w, (lanes_w + kThreads - 1) / kThreads,
            nc, nz, lanes_n};
  const auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      (w_segs <= 4 && n_segs <= 4)
          ? dispatch_fused<4>(a_dtype, w_dtype, a, w, out, B, K, N, s, pw, pn,
                              st)
          : dispatch_fused<pc::kMaxSegs>(a_dtype, w_dtype, a, w, out, B, K,
                                         N, s, pw, pn, st);
  return static_cast<int>(err);
}
