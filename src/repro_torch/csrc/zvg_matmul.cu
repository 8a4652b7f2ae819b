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
// What bounds it on an H100: at decode (M of 4 or 8 rows) the product does
// at most 8 multiply-accumulates per weight word, far below the 295
// operations a byte at which bfloat16 tensor cores would bound it, and at
// 3.35 TB/s that is about 13 T FMA/s at 8 rows, under a quarter of the
// SIMT FMA pipes: reading w once bounds it (about 0.28 ms for the 928 MB
// of bfloat16 weights one Qwen1.5-0.5B decode step reads). The first
// Hopper version missed that bound for want of blocks and bytes in flight:
// one block of 256 threads per 32 columns (32 blocks for N = 1024, each
// walking all of K), 224-228 registers a thread (one block an SM), every
// block re-testing every row, and x re-staged behind two barriers every
// 256 k. This version (stream_kernel) streams w instead, on the FMA pipes
// (no tensor cores: at 8 rows they would idle on the bytes all the same):
//   * A block is 8 warps over one tile of 32 x V adjacent columns (V = 8
//     for bfloat16 w, one 16-byte load a lane, 512 bytes a warp per k row;
//     V = 4 for float32), its warps taking every 8th k row of the block's
//     k range. A lane keeps two sets of rows in flight (4 rows a set at 4
//     rows a pass, 2 at 8): one set is multiplied while the other loads,
//     and the first two are requested before anything else waits.
//   * Where the column tiles number fewer than the 132 SMs, a cluster of
//     up to 16 blocks (one per k split) takes a tile; the plan is
//     kernels/zvg_matmul/kernel.py::decode_plan. Each block stages x's
//     rows of its k range once, as float32 in shared memory from where
//     each k broadcasts them, and tests their bits as it stages them; the
//     cluster ORs the splits' tests through distributed shared memory, so
//     each row's liveness covers all of K and each word of x is tested
//     once per column tile without a read of its own. (A prologue launch
//     that tested each row once a call added a launch's device time to
//     every call, a large share of the time of the 1024-column layers.)
//   * An accumulator of R x V floats a thread (R = 4 rows a pass up to M =
//     4, else 8; more rows take more passes); a gated row skips its MACs.
//     The warps' sums meet in shared memory in warp order. Unsplit, the
//     block writes them; split, each block sends each column's sums to
//     the block of the cluster that owns the column (distributed shared
//     memory), and after one cluster barrier the owners add the splits'
//     sums in split order and write them, rounded once: no workspace, no
//     atomics, and a result that does not change from run to run. Gated
//     rows are written as +0.0.
//
// K3, zm_fused_matmul_counters, replaces the TPU kernel
//   src/repro/kernels/zvg_matmul/fused.py::fused_matmul_counters
// One launch emits the gated product of a[B, K] and w[K, N] (the first
// Hopper version's column tiles, gated_tile below) and, in separate
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

#include <algorithm>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cooperative_groups.h>

#include "power_counters.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// K3's product tiles (gated_tile, mac_pass)
constexpr int kTileN = 32;                      // columns per block
constexpr int kVec = 8;                         // columns per thread
constexpr int kColThreads = kTileN / kVec;      // 4 threads span a tile row
constexpr int kKSlices = kThreads / kColThreads;  // 64 k-slices per block
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

// ------------------------------------------------------------------ K2
constexpr int kSWarps = 8;         // warps a block, splitting its k range
constexpr int kMaxSplits = 16;     // blocks a cluster: the splits of K
constexpr int kMaxSplitK = 2048;   // k rows a block stages x for

// a lane's 16 bytes of weights as V floats
template <int V>
__device__ __forceinline__ void unpack_w(uint4 u, float (&v)[V]);
template <>
__device__ __forceinline__ void unpack_w<8>(uint4 u, float (&v)[8]) {
  const uint32_t words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(words[i] << 16);
    v[2 * i + 1] = __uint_as_float(words[i] & 0xFFFF0000u);
  }
}
template <>
__device__ __forceinline__ void unpack_w<4>(uint4 u, float (&v)[4]) {
  v[0] = __uint_as_float(u.x); v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z); v[3] = __uint_as_float(u.w);
}

// the 16 bytes of weights of row k from column col (zeros past N)
template <typename TW>
__device__ __forceinline__ uint4 load_row(const TW* __restrict__ w, int k,
                                          int col, int N, bool vec) {
  constexpr int V = 16 / sizeof(TW);
  const TW* p = w + static_cast<size_t>(k) * N + col;
  if (vec && col + V <= N) {   // streamed once: no L1 line, 256-byte L2 fetch
    uint4 u;
    asm("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
        : "=r"(u.x), "=r"(u.y), "=r"(u.z), "=r"(u.w) : "l"(p));
    return u;
  }
  __align__(16) TW v[V];
#pragma unroll
  for (int c = 0; c < V; ++c) v[c] = col + c < N ? p[c] : TW(0.0f);
  return *reinterpret_cast<const uint4*>(v);
}

// one set of U k rows a lane: rows k, k + 8, ... of the block's range
// (zeros past its end)
template <typename TW, int U>
__device__ __forceinline__ void load_set(const TW* __restrict__ w, int k0,
                                         int k, int klen, int col, int N,
                                         bool vec, uint4 (&u)[U]) {
#pragma unroll
  for (int j = 0; j < U; ++j) {
    const int kj = k + j * kSWarps;
    u[j] = kj < klen ? load_row(w, k0 + kj, col, N, vec)
                     : make_uint4(0, 0, 0, 0);
  }
}

// the multiply-accumulates of one set, for the live rows
template <int V, int R, int U>
__device__ __forceinline__ void mac_set(const uint4 (&u)[U], int k, int klen,
                                        const float* xs, uint32_t live,
                                        float (&acc)[R][V]) {
#pragma unroll
  for (int j = 0; j < U; ++j) {
    const int kj = k + j * kSWarps;
    if (kj < klen) {
      float wv[V];
      unpack_w<V>(u[j], wv);
      float xv[R];
#pragma unroll
      for (int r = 0; r < R; r += 4) {
        const float4 q = *reinterpret_cast<const float4*>(xs + kj * R + r);
        xv[r] = q.x; xv[r + 1] = q.y; xv[r + 2] = q.z; xv[r + 3] = q.w;
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (live >> r & 1)   // a gated row skips its MACs
#pragma unroll
          for (int c = 0; c < V; ++c)
            acc[r][c] = fmaf(xv[r], wv[c], acc[r][c]);
    }
  }
}

// x's rows p .. p + R - 1 over the block's k range, as floats in xs[k][R]
// (0 past M), and in *mask the rows among them with a word whose bits are
// not all 0. Where the rows allow 16-byte loads (K and k0 multiples of 8)
// and the range needs at most 4 a thread, load() puts them in flight and
// store() lands them; otherwise store() reads x itself.
template <typename TA, int R>
struct XStage {
  static constexpr int kVX = 16 / sizeof(TA);
  uint4 u[4];
  bool held = false;

  __device__ __forceinline__ void load(const TA* __restrict__ x, int M,
                                       int K, int p, int k0, int klen,
                                       bool xvec) {
    const int per_row = klen / kVX, n = R * per_row;
    held = xvec && n <= 4 * kThreads;
    if (!held) return;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = threadIdx.x + j * kThreads, r = i / per_row;
      u[j] = i < n && p + r < M
          ? __ldg(reinterpret_cast<const uint4*>(
                x + static_cast<size_t>(p + r) * K + k0 + (i % per_row) * kVX))
          : make_uint4(0, 0, 0, 0);
    }
  }

  __device__ __forceinline__ void land(int i, int per_row, uint4 v,
                                       float* __restrict__ xs,
                                       uint32_t& live) {
    const int r = i / per_row, kk = (i % per_row) * kVX;
    float f[kVX];
    unpack_w<kVX>(v, f);
#pragma unroll
    for (int t = 0; t < kVX; ++t) xs[(kk + t) * R + r] = f[t];
    if (v.x | v.y | v.z | v.w) live |= 1u << r;
  }

  __device__ __forceinline__ void store(const TA* __restrict__ x, int M,
                                        int K, int p, int k0, int klen,
                                        bool xvec, float* __restrict__ xs,
                                        uint32_t* mask) {
    uint32_t live = 0;
    const int per_row = klen / kVX, n = R * per_row;
    if (held) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = threadIdx.x + j * kThreads;
        if (i < n) land(i, per_row, u[j], xs, live);
      }
    } else if (xvec) {
      for (int i = threadIdx.x; i < n; i += kThreads) {
        const int r = i / per_row;
        const uint4 v = p + r < M
            ? __ldg(reinterpret_cast<const uint4*>(
                  x + static_cast<size_t>(p + r) * K + k0 + (i % per_row) * kVX))
            : make_uint4(0, 0, 0, 0);
        land(i, per_row, v, xs, live);
      }
    } else {
      for (int i = threadIdx.x; i < R * klen; i += kThreads) {
        const int r = i / klen, kk = i % klen;
        float v = 0.f;
        if (p + r < M) {
          const TA word = x[static_cast<size_t>(p + r) * K + k0 + kk];
          v = to_f(word);
          if (nonzero_bits(word)) live |= 1u << r;
        }
        xs[kk * R + r] = v;
      }
    }
    live = __reduce_or_sync(0xFFFFFFFFu, live);
    if (live && threadIdx.x % 32 == 0) atomicOr(mask, live);
  }
};

template <int R>
struct Rows {   // weight rows a lane holds per set, for R rows a pass
  static constexpr int kU = R == 4 ? 4 : 2;
};

template <typename TA, typename TW, typename TO, int R>
__global__ void __launch_bounds__(kThreads, 2)
stream_kernel(const TA* __restrict__ x, const TW* __restrict__ w,
              TO* __restrict__ out, int M, int K, int N, int kps, bool vec,
              bool xvec) {
  constexpr int V = 16 / sizeof(TW);        // columns a lane
  constexpr int kCols = 32 * V;             // columns a block
  constexpr int kOuts = R * kCols / kThreads;   // block sums a thread
  constexpr int U = Rows<R>::kU;
  constexpr int kStep = kSWarps * U;        // k rows of a set, all warps
  extern __shared__ float dyn[];
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = cluster.num_blocks();        // the cluster spans K
  const int rank = cluster.block_rank();
  const int share = (kCols + splits - 1) / splits;  // columns a block sums
  // xs[kps][R] (a pass's R rows of x, as floats), then, reusing it, each
  // warp's sums red[warp][R][kCols]; recv[split][R][share]: the splits'
  // sums of this block's share of the columns
  float* xs = dyn;
  float* recv = dyn + max(kps * R, kSWarps * R * kCols);
  __shared__ uint32_t masks[2];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n0 = blockIdx.x * kCols, col = n0 + lane * V;
  const int k0 = blockIdx.y * kps, klen = min(K, k0 + kps) - k0;

  if (tid == 0) masks[0] = masks[1] = 0;
  __syncthreads();
  // the first pass's x, then the first two sets of weights, go in flight
  // before the liveness is known (x first: behind the weights, its loads
  // would wait on the whole stream's traffic)
  XStage<TA, R> xst;
  xst.load(x, M, K, 0, k0, klen, xvec);
  uint4 cur[U], nxt[U];
  load_set<TW, U>(w, k0, warp, klen, col, N, vec, cur);
  load_set<TW, U>(w, k0, warp + kStep, klen, col, N, vec, nxt);

  for (int p = 0; p < M; p += R) {   // rows p .. p + R - 1
    const int b = (p / R) & 1;
    if (tid == 0) masks[b ^ 1] = 0;   // the next pass's
    if (p > 0) xst.load(x, M, K, p, k0, klen, xvec);
    xst.store(x, M, K, p, k0, klen, xvec, xs, &masks[b]);
    cluster.sync();   // every split's test of its k range is in
    // rows of the pass with a nonzero word in all of K: lane q reads split
    // q's test
    uint32_t live = lane < splits ? *cluster.map_shared_rank(&masks[b], lane)
                                  : 0u;
    live = __reduce_or_sync(0xFFFFFFFFu, live);
    if (live) {
      float acc[R][V];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < V; ++c) acc[r][c] = 0.f;
      if (p > 0) {
        load_set<TW, U>(w, k0, warp, klen, col, N, vec, cur);
        load_set<TW, U>(w, k0, warp + kStep, klen, col, N, vec, nxt);
      }
      // two sets of rows in turn: one is used while the other loads
      for (int kk = warp; kk < klen; kk += 2 * kStep) {
        mac_set<V, R, U>(cur, kk, klen, xs, live, acc);
        load_set<TW, U>(w, k0, kk + 2 * kStep, klen, col, N, vec, cur);
        mac_set<V, R, U>(nxt, kk + kStep, klen, xs, live, acc);
        load_set<TW, U>(w, k0, kk + 3 * kStep, klen, col, N, vec, nxt);
      }
      __syncthreads();   // xs is read no more: red takes its place
      float* red = xs;
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < V; c += 4)
          *reinterpret_cast<float4*>(red + (warp * R + r) * kCols +
                                     lane * V + c) =
              make_float4(acc[r][c], acc[r][c + 1], acc[r][c + 2],
                          acc[r][c + 3]);
      __syncthreads();
      // block sum e = (row r, column c), the warps' sums in warp order,
      // written, or split, sent to the block that sums column c
#pragma unroll
      for (int i = 0; i < kOuts; ++i) {
        const int e = tid + i * kThreads;
        const int r = e / kCols, c = e % kCols;
        float sum = red[e];
#pragma unroll
        for (int wp = 1; wp < kSWarps; ++wp) sum += red[wp * R * kCols + e];
        if (!(live >> r & 1)) continue;
        if (splits == 1) {
          if (p + r < M && n0 + c < N)
            store(out + static_cast<size_t>(p + r) * N + n0 + c, sum);
        } else {
          *cluster.map_shared_rank(
              recv + (rank * R + r) * share + c % share, c / share) = sum;
        }
      }
    }
    if (splits == 1) {   // the +0.0 of the gated rows
      for (int i = tid; i < R * kCols; i += kThreads) {
        const int r = i / kCols, c = i % kCols;
        if (!(live >> r & 1) && p + r < M && n0 + c < N)
          store(out + static_cast<size_t>(p + r) * N + n0 + c, 0.f);
      }
    } else {
      cluster.sync();   // every split's sums are in
      // this block's share of the tile's columns: the splits' sums in
      // split order, or the +0.0 of a gated row
      const int c0 = rank * share, cn = min(kCols, c0 + share) - c0;
      for (int i = tid; i < R * cn; i += kThreads) {
        const int r = i / cn, cl = i % cn;
        if (p + r >= M || n0 + c0 + cl >= N) continue;
        float sum = 0.f;
        if (live >> r & 1) {
          sum = recv[r * share + cl];
          for (int q = 1; q < splits; ++q)
            sum += recv[(q * R + r) * share + cl];
        }
        store(out + static_cast<size_t>(p + r) * N + n0 + c0 + cl, sum);
      }
    }
    if (p + R < M) __syncthreads();   // recv and xs are reused next pass
  }
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

template <typename TA, typename TW, typename TO, int R>
cudaError_t launch_stream(const void* x, const void* w, void* out, int M,
                          int K, int N, int kps, cudaStream_t stream) {
  constexpr int kCols = 32 * (16 / sizeof(TW));
  const auto kernel = stream_kernel<TA, TW, TO, R>;
  const int tiles = (N + kCols - 1) / kCols;
  const int splits = (K + kps - 1) / kps;
  const size_t smem =
      sizeof(float) * (std::max(kps * R, kSWarps * R * kCols) +
                       (splits > 1 ? R * (kCols + splits) : 0));
  static size_t sized = 48 * 1024;
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
  const bool xvec = K % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (splits == 1) {   // a cluster of one: the plain launch is cheaper
    kernel<<<tiles, kThreads, smem, stream>>>(
        static_cast<const TA*>(x), static_cast<const TW*>(w),
        static_cast<TO*>(out), M, K, N, kps, vec_ok(w, N), xvec);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles, splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<const TA*>(x),
                            static_cast<const TW*>(w), static_cast<TO*>(out),
                            M, K, N, kps, vec_ok(w, N), xvec);
}

template <typename TA, typename TW, typename TO>
cudaError_t launch_gemm(const void* x, const void* w, void* out, int M, int K,
                        int N, int kps, cudaStream_t stream) {
  if (M <= 4)
    return launch_stream<TA, TW, TO, 4>(x, w, out, M, K, N, kps, stream);
  return launch_stream<TA, TW, TO, 8>(x, w, out, M, K, N, kps, stream);
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
// k_per_split: the k rows each of the cluster's splits walks (from
// decode_plan): a multiple of 8 up to 2048, at most 16 splits, or at least
// K for no split. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int zm_gated_row_matmul(const void* x, int x_dtype, const void* w,
                                   int w_dtype, void* out, int out_dtype,
                                   int M, int K, int N, int k_per_split,
                                   void* stream) {
  if (M < 1 || K < 1 || N < 1 || !dtypes_ok(x_dtype, w_dtype, out_dtype) ||
      k_per_split < 1 ||
      (k_per_split < K &&
       (k_per_split % 8 || k_per_split > kMaxSplitK ||
        (K + k_per_split - 1) / k_per_split > kMaxSplits)) ||
      (k_per_split >= K && K > kMaxSplitK))
    return static_cast<int>(cudaErrorInvalidValue);
  const int kps = std::min(k_per_split, K);
  using bf = __nv_bfloat16;
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_dtype == kBF16 && w_dtype == kBF16)
    err = launch_gemm<bf, bf, bf>(x, w, out, M, K, N, kps, st);
  else if (x_dtype == kBF16)
    err = launch_gemm<bf, float, float>(x, w, out, M, K, N, kps, st);
  else if (w_dtype == kBF16)
    err = launch_gemm<float, bf, float>(x, w, out, M, K, N, kps, st);
  else
    err = launch_gemm<float, float, float>(x, w, out, M, K, N, kps, st);
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
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
