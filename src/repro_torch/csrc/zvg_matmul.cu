// The serving decode path's two kernels, for Hopper (sm_90a). Built by
// repro_torch/kernels/_build.py with nvcc into a shared library with a
// plain C interface, loaded with ctypes.
//
// K2, zm_gated_row_matmul, replaces the TPU kernel
//   src/repro/kernels/zvg_matmul/fused.py::gated_row_matmul
// out[M, N] = x[M, K] @ w[K, N] with per-row zero-value gating: a row whose
// words are all +0.0 (a test on the raw bits, so -0.0 and subnormal rows
// compute; for int8 rows the value test, which is the same) skips the
// multiply-accumulates and is filled with zero. The fill is the port's own
// ungated product of such a row: the plain version (torch.matmul) and an
// accumulator started at +0.0 both give +0.0. (The reference fills -0.0 in
// the columns where all of w[:, j] is negative; XLA's own dot gives +0.0
// there, so comparisons across the two frameworks treat +0.0 and -0.0 as
// equal.) x and w are float32, bfloat16 or int8, in any pair; the output
// type is the reference's jnp.result_type: int8 with int8 gives int8
// (summed exactly in int32 and wrapped to int8 on the store: x @ w mod
// 256), int8 with a float gives that float, bfloat16 with float32 gives
// float32; float outputs are rounded once from the float32 accumulator.
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
//     V = 4 for float32, 16 for int8), its warps taking every 8th k row of
//     the block's k range. A lane keeps two sets of rows in flight (4 rows
//     a set at 4 rows a pass, 2 at 8): one set is multiplied while the
//     other loads, and the first two are requested before anything else
//     waits.
//   * Where the column tiles number fewer than the 132 SMs, a cluster of
//     up to 16 blocks (one per k split) takes a tile; the plan is
//     kernels/zvg_matmul/kernel.py::decode_plan. Each block stages x's
//     rows of its k range, as float32 (int32 for int8 x int8) in shared
//     memory from where each k broadcasts them, and tests their bits as it
//     stages them; the cluster ORs the splits' tests through distributed
//     shared memory, so each row's liveness covers all of K and each word
//     of x is tested once per column tile without a read of its own. A
//     split longer than the 2048 k rows a block stages at once (K above
//     16 x 2048) stages x in pieces of 2048, one after another, testing
//     the later pieces before the cluster's liveness barrier, so any K is
//     taken (in an instantiation of its own: the usual one carries none
//     of it). (A prologue launch that tested each row once a call added a
//     launch's device time to every call, a large share of the time of
//     the 1024-column layers.)
//   * An accumulator of R x V a thread (R = 4 rows a pass up to M = 4 or
//     with int8 weights, else 8; more rows take more passes); a gated row
//     skips its MACs. The warps' sums meet in shared memory in warp order.
//     Unsplit, the block writes them; split, each block sends each
//     column's sums to the block of the cluster that owns the column
//     (distributed shared memory), and after one cluster barrier the
//     owners add the splits' sums in split order and write them, rounded
//     once: no workspace, no atomics, and a result that does not change
//     from run to run. Gated rows are written as zero.
//
// What bounds K2 at wide decode batches: at 128 rows (MiniCPM3-4B served
// 128 at a time) the product is 128 FLOP a weight byte, still below the
// 295 a byte of the bfloat16 tensor cores, so reading w once still bounds
// it: 7.6 GB of weights a decode step, about 2.3 ms. The stream route
// cannot come near: it takes 8 rows a pass, so 16 passes over w, and its
// 0.98 TFLOP a step on the 67 TFLOP/s SIMT pipes alone is ~15 ms (it took
// ~152 ms). So bfloat16 x bfloat16 calls (kernel.py::wide_route: rows TMA
// can describe, and WIDE_MIN_ROWS or more, one, since this route took less
// time than the stream route at every row count from 1 to 128) take a
// second route, wide::stream_kernel, on the tensor cores; float32, int8,
// mixed pairs and other strides keep the stream route:
//   * One block per output tile of tile_m x tile_n (tile_m 64 or 128: one
//     or two consumer warpgroups of wgmma.mma_async m64nNk16, bf16 in,
//     float32 accumulators; tile_n 64 or 128). A ring of shared-memory
//     stages of 64 k (x [tile_m, 64], K-major, and w [64, tile_n], which
//     wgmma reads as B transposed) is fed by TMA from one producer warp,
//     one mbarrier a stage; rows past M and k past K land as TMA's zeros.
//     Each stage's sum is added into a second float32 accumulator, so no
//     sum runs longer than one stage inside the tensor core. Where the
//     tiles number fewer than the 132 SMs, K splits across a cluster of up
//     to 16 blocks, which meet as the stream route's do (distributed
//     shared memory, split order, one cluster barrier); where they number
//     more (the lm head's 574), one block an SM walks them, so one tile's
//     epilogue overlaps the next tile's loads.
//   * The row gate, as the stream route's: while the tensor cores work on
//     a stage, each consumer warp ORs the bits of its 16 rows of the x
//     tile the stage holds, so no word of x is read twice; a cluster ORs
//     its splits' words with the sums. A row with no nonzero word in all
//     of K is written +0.0 whatever w holds (inf and NaN included); live
//     rows are rounded once from float32. (A row tile with no live row
//     still loads and multiplies w: its liveness is known only once all
//     of x has arrived, and a test of x before the loads would read x
//     twice and stall every call behind it; in a decode step the 128 rows
//     are one row tile and hold the step's live requests.)
//   * One launch a call, no memset and no padding copy; tensor maps are
//     kept by pointer and shape, so a decode step's calls find theirs.
//
// K3, zm_fused_matmul_counters, replaces the TPU kernel
//   src/repro/kernels/zvg_matmul/fused.py::fused_matmul_counters
// The gated product of a[B, K] and w[K, N] as K2 computes it, and the
// coding-menu counters of the decode streams:
//   * per request row b, the west stream: T = K cycles over lanes_w lanes,
//     the row's bfloat16 words in lane 0 and zero words in the other lanes,
//     which are real words of the padded [1, K] -> [R, K] tile and are
//     counted, in the counters and in rowzeros;
//   * once per batch, the north stream: T = K cycles over lanes_n lanes,
//     w's bfloat16 words in lanes 0..N-1 and zero words in the padding
//     lanes N..lanes_n-1, counted likewise.
// Float words become bfloat16 by round to nearest even, NaN as 0x7FC0 |
// sign << 15. What bounds K3 on an H100 is its bytes, about 1 MB at the
// serving shape (bfloat16 activations, float32 weights, int32 counters):
// 0.3 us. The first Hopper version walked each lane's T = K = 1024
// cycles in one thread, a dependent chain of ~430 ns a cycle (0.44 ms a
// launch, all of it the chain), and ran the product in 32-column
// tiles beside it. This version makes two launches on the caller's stream:
//   * the product is K2's stream_kernel, on decode_plan's split: two
//     launches, not one, because the two roles want different grids (the
//     product clusters of k splits, the walk clusters of chunks, of other
//     sizes) and the product's blocks would otherwise wait on the walk's;
//     the second launch costs a launch gap, not a chain;
//   * the counters are pc::walk_chunked (power_counters.cuh): each lane's
//     K cycles cut into chunks (kernels/power_counters/kernel.py::
//     chunk_plan: 16 cycles at K = 1024, 8 warps a block, a cluster of 8
//     blocks a 32-lane group), summarised, composed in cycle order and
//     re-walked from their true start states, so a thread walks 2 x 16
//     cycles, not 1024. Its loads are branch-free (a padding lane reads a
//     clamped column, a west lane other than 0 reads lane 0's word, and a
//     select drops them), so that a chunk's loads are all in flight before
//     the first is used.

#include <algorithm>
#include <cstdint>
#include <type_traits>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cooperative_groups.h>

#include "hopper.cuh"
#include "power_counters.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kSWarps = 8;         // warps a block, splitting its k range
constexpr int kMaxSplits = 16;     // blocks a cluster: the splits of K
constexpr int kPiece = 2048;       // k rows a block stages x for at once

enum Dtype { kF32 = 0, kBF16 = 1, kI8 = 2 };

// the accumulator: int32 for int8 x int8 (exact), float32 otherwise
template <typename TA, typename TW>
struct AccOf { using type = float; };
template <>
struct AccOf<int8_t, int8_t> { using type = int; };

// the output: jnp.result_type of the pair
template <typename TA, typename TW>
struct OutOf { using type = float; };
template <typename T>
struct OutOf<T, T> { using type = T; };
template <>
struct OutOf<int8_t, bf16> { using type = bf16; };
template <>
struct OutOf<bf16, int8_t> { using type = bf16; };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return x; }

template <typename A, typename T>
__device__ __forceinline__ A to_acc(T x) {
  if constexpr (std::is_same_v<A, int>) return static_cast<int>(x);
  else return to_f(x);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store(int8_t* p, int v) {   // x @ w mod 256
  *p = static_cast<int8_t>(static_cast<uint8_t>(v & 0xFF));
}

__device__ __forceinline__ bool nonzero_bits(float x) {
  return __float_as_uint(x) != 0u;
}
__device__ __forceinline__ bool nonzero_bits(bf16 x) {
  return __bfloat16_as_ushort(x) != 0u;
}
__device__ __forceinline__ bool nonzero_bits(int8_t x) { return x != 0; }

__device__ __forceinline__ float mad(float x, float w, float acc) {
  return fmaf(x, w, acc);
}
__device__ __forceinline__ int mad(int x, int w, int acc) {
  return x * w + acc;
}

__device__ __forceinline__ uint32_t bits_of(float x) {
  return __float_as_uint(x);
}
__device__ __forceinline__ uint32_t bits_of(int x) {
  return static_cast<uint32_t>(x);
}

template <typename A>
__device__ __forceinline__ A from_bits(uint32_t u) {
  if constexpr (std::is_same_v<A, int>) return static_cast<int>(u);
  else return __uint_as_float(u);
}

// 16 bytes of T as 16 / sizeof(T) accumulator values
__device__ __forceinline__ void unpack(uint4 u, float (&v)[8], bf16) {
  const uint32_t words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(words[i] << 16);
    v[2 * i + 1] = __uint_as_float(words[i] & 0xFFFF0000u);
  }
}
__device__ __forceinline__ void unpack(uint4 u, float (&v)[4], float) {
  v[0] = __uint_as_float(u.x); v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z); v[3] = __uint_as_float(u.w);
}
template <typename A>
__device__ __forceinline__ void unpack(uint4 u, A (&v)[16], int8_t) {
  const uint32_t words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[4 * i + j] = static_cast<A>(static_cast<int8_t>(words[i] >> (8 * j)));
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

// the multiply-accumulates of one set, for the live rows; xs holds x's
// rows from the block's k row `xoff` on
template <typename TW, typename A, int R, int U>
__device__ __forceinline__ void mac_set(const uint4 (&u)[U], int k, int klen,
                                        const A* xs, int xoff, uint32_t live,
                                        A (&acc)[R][16 / sizeof(TW)]) {
  constexpr int V = 16 / sizeof(TW);
#pragma unroll
  for (int j = 0; j < U; ++j) {
    const int kj = k + j * kSWarps;
    if (kj < klen) {
      A wv[V];
      unpack(u[j], wv, TW(0.0f));
      A xv[R];
#pragma unroll
      for (int r = 0; r < R; r += 4) {
        const uint4 q =
            *reinterpret_cast<const uint4*>(xs + (kj - xoff) * R + r);
        xv[r] = from_bits<A>(q.x); xv[r + 1] = from_bits<A>(q.y);
        xv[r + 2] = from_bits<A>(q.z); xv[r + 3] = from_bits<A>(q.w);
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (live >> r & 1)   // a gated row skips its MACs
#pragma unroll
          for (int c = 0; c < V; ++c) acc[r][c] = mad(xv[r], wv[c], acc[r][c]);
    }
  }
}

// x's rows p .. p + R - 1 over k rows [k0, k0 + klen), as accumulator
// values in xs[k][R] (0 past M), and in *mask the rows among them with a
// word whose bits are not all 0. Where the rows allow 16-byte loads (K and
// k0 multiples of 16 / sizeof(TA)) and the range needs at most 4 a thread,
// load() puts them in flight and store() lands them; otherwise store()
// reads x itself. test() only tests.
template <typename TA, typename A, int R>
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
                                       A* __restrict__ xs, uint32_t& live) {
    const int r = i / per_row, kk = (i % per_row) * kVX;
    A f[kVX];
    unpack(v, f, TA(0.0f));
#pragma unroll
    for (int t = 0; t < kVX; ++t) xs[(kk + t) * R + r] = f[t];
    if (v.x | v.y | v.z | v.w) live |= 1u << r;
  }

  __device__ __forceinline__ static void vote(uint32_t live, uint32_t* mask) {
    live = __reduce_or_sync(0xFFFFFFFFu, live);
    if (mask && live && threadIdx.x % 32 == 0) atomicOr(mask, live);
  }

  __device__ __forceinline__ void store(const TA* __restrict__ x, int M,
                                        int K, int p, int k0, int klen,
                                        bool xvec, A* __restrict__ xs,
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
        A v = 0;
        if (p + r < M) {
          const TA word = x[static_cast<size_t>(p + r) * K + k0 + kk];
          v = to_acc<A>(word);
          if (nonzero_bits(word)) live |= 1u << r;
        }
        xs[kk * R + r] = v;
      }
    }
    vote(live, mask);
  }

  __device__ __forceinline__ static void test(const TA* __restrict__ x,
                                              int M, int K, int p, int k0,
                                              int klen, bool xvec,
                                              uint32_t* mask) {
    uint32_t live = 0;
    if (xvec) {
      const int per_row = klen / kVX;
      for (int i = threadIdx.x; i < R * per_row; i += kThreads) {
        const int r = i / per_row;
        if (p + r >= M) continue;
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(
            x + static_cast<size_t>(p + r) * K + k0 + (i % per_row) * kVX));
        if (v.x | v.y | v.z | v.w) live |= 1u << r;
      }
    } else {
      for (int i = threadIdx.x; i < R * klen; i += kThreads) {
        const int r = i / klen;
        if (p + r < M &&
            nonzero_bits(x[static_cast<size_t>(p + r) * K + k0 + i % klen]))
          live |= 1u << r;
      }
    }
    vote(live, mask);
  }
};

template <int R>
struct Rows {   // weight rows a lane holds per set, for R rows a pass
  static constexpr int kU = R == 4 ? 4 : 2;
};

// PIECES: the block's k range is longer than kPiece, and x is staged in
// pieces (an instantiation of its own, so that the registers of the usual
// path do not carry the restaging code)
template <typename TA, typename TW, typename TO, int R, bool PIECES>
__global__ void __launch_bounds__(kThreads, 2)
stream_kernel(const TA* __restrict__ x, const TW* __restrict__ w,
              TO* __restrict__ out, int M, int K, int N, int kps, bool vec,
              bool xvec) {
  using A = typename AccOf<TA, TW>::type;
  constexpr int V = 16 / sizeof(TW);        // columns a lane
  constexpr int kCols = 32 * V;             // columns a block
  constexpr int kOuts = R * kCols / kThreads;   // block sums a thread
  constexpr int U = Rows<R>::kU;
  constexpr int kStep = kSWarps * U;        // k rows of a set, all warps
  static_assert(kPiece % (2 * kStep) == 0, "pieces hold whole set pairs");
  extern __shared__ float dyn[];
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = cluster.num_blocks();        // the cluster spans K
  const int rank = cluster.block_rank();
  const int share = (kCols + splits - 1) / splits;  // columns a block sums
  // xs[min(kps, kPiece)][R] (a pass's R rows of x), then, reusing it,
  // each warp's sums red[warp][R][kCols]; recv[split][R][share]: the
  // splits' sums of this block's share of the columns
  A* xs = reinterpret_cast<A*>(dyn);
  A* recv = xs + max(min(kps, kPiece) * R, kSWarps * R * kCols);
  __shared__ uint32_t masks[2];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n0 = blockIdx.x * kCols, col = n0 + lane * V;
  const int k0 = blockIdx.y * kps, klen = min(K, k0 + kps) - k0;
  const int plen = PIECES ? min(klen, kPiece) : klen;   // the first piece

  if (tid == 0) masks[0] = masks[1] = 0;
  __syncthreads();
  // the first pass's x, then the first two sets of weights, go in flight
  // before the liveness is known (x first: behind the weights, its loads
  // would wait on the whole stream's traffic)
  XStage<TA, A, R> xst;
  xst.load(x, M, K, 0, k0, plen, xvec);
  uint4 cur[U], nxt[U];
  load_set<TW, U>(w, k0, warp, klen, col, N, vec, cur);
  load_set<TW, U>(w, k0, warp + kStep, klen, col, N, vec, nxt);

  for (int p = 0; p < M; p += R) {   // rows p .. p + R - 1
    const int b = (p / R) & 1;
    if (tid == 0) masks[b ^ 1] = 0;   // the next pass's
    if (p > 0) xst.load(x, M, K, p, k0, plen, xvec);
    xst.store(x, M, K, p, k0, plen, xvec, xs, &masks[b]);
    if constexpr (PIECES)
      for (int pb = kPiece; pb < klen; pb += kPiece)   // the later pieces
        XStage<TA, A, R>::test(x, M, K, p, k0 + pb, min(kPiece, klen - pb),
                               xvec, &masks[b]);
    cluster.sync();   // every split's test of its k range is in
    // rows of the pass with a nonzero word in all of K: lane q reads split
    // q's test
    uint32_t live = lane < splits ? *cluster.map_shared_rank(&masks[b], lane)
                                  : 0u;
    live = __reduce_or_sync(0xFFFFFFFFu, live);
    if (live) {
      A acc[R][V];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < V; ++c) acc[r][c] = 0;
      if (p > 0) {
        load_set<TW, U>(w, k0, warp, klen, col, N, vec, cur);
        load_set<TW, U>(w, k0, warp + kStep, klen, col, N, vec, nxt);
      }
      // two sets of rows in turn: one is used while the other loads
      for (int base = 0; base < klen; base += 2 * kStep) {
        const int xoff = PIECES ? base / kPiece * kPiece : 0;
        if (PIECES && base > 0 && base == xoff) {   // the next piece of x
          __syncthreads();
          // word by word: the accumulators and both sets of weights are
          // live here, and 16-byte staging would spill them
          XStage<TA, A, R> piece;
          piece.store(x, M, K, p, k0 + base, min(kPiece, klen - base), false,
                      xs, nullptr);
          __syncthreads();
        }
        const int kk = base + warp;
        mac_set<TW, A, R, U>(cur, kk, klen, xs, xoff, live, acc);
        load_set<TW, U>(w, k0, kk + 2 * kStep, klen, col, N, vec, cur);
        mac_set<TW, A, R, U>(nxt, kk + kStep, klen, xs, xoff, live, acc);
        load_set<TW, U>(w, k0, kk + 3 * kStep, klen, col, N, vec, nxt);
      }
      __syncthreads();   // xs is read no more: red takes its place
      A* red = xs;
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < V; c += 4)
          *reinterpret_cast<uint4*>(red + (warp * R + r) * kCols + lane * V +
                                    c) =
              make_uint4(bits_of(acc[r][c]), bits_of(acc[r][c + 1]),
                         bits_of(acc[r][c + 2]), bits_of(acc[r][c + 3]));
      __syncthreads();
      // block sum e = (row r, column c), the warps' sums in warp order,
      // written, or split, sent to the block that sums column c
#pragma unroll
      for (int i = 0; i < kOuts; ++i) {
        const int e = tid + i * kThreads;
        const int r = e / kCols, c = e % kCols;
        A sum = red[e];
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
    if (splits == 1) {   // the zeros of the gated rows
      for (int i = tid; i < R * kCols; i += kThreads) {
        const int r = i / kCols, c = i % kCols;
        if (!(live >> r & 1) && p + r < M && n0 + c < N)
          store(out + static_cast<size_t>(p + r) * N + n0 + c, A(0));
      }
    } else {
      cluster.sync();   // every split's sums are in
      // this block's share of the tile's columns: the splits' sums in
      // split order, or the zero of a gated row
      const int c0 = rank * share, cn = min(kCols, c0 + share) - c0;
      for (int i = tid; i < R * cn; i += kThreads) {
        const int r = i / cn, cl = i % cn;
        if (p + r >= M || n0 + c0 + cl >= N) continue;
        A sum = 0;
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

template <typename TA, typename TW, int R, bool PIECES>
cudaError_t launch_stream(const void* x, const void* w, void* out, int M,
                          int K, int N, int kps, cudaStream_t stream) {
  using TO = typename OutOf<TA, TW>::type;
  constexpr int V = 16 / sizeof(TW);
  constexpr int kCols = 32 * V;
  const auto kernel = stream_kernel<TA, TW, TO, R, PIECES>;
  const int tiles = (N + kCols - 1) / kCols;
  const int splits = (K + kps - 1) / kps;
  const size_t smem =
      sizeof(float) * (std::max(std::min(kps, kPiece) * R,
                                kSWarps * R * kCols) +
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
  constexpr int kVX = 16 / sizeof(TA);
  const bool vec = N % V == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const bool xvec = K % kVX == 0 && kps % kVX == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (splits == 1) {   // a cluster of one: the plain launch is cheaper
    kernel<<<tiles, kThreads, smem, stream>>>(
        static_cast<const TA*>(x), static_cast<const TW*>(w),
        static_cast<TO*>(out), M, K, N, kps, vec, xvec);
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
                            M, K, N, kps, vec, xvec);
}

template <typename TA, typename TW, int R>
cudaError_t launch_rows(const void* x, const void* w, void* out, int M, int K,
                        int N, int kps, cudaStream_t stream) {
  if (kps > kPiece)
    return launch_stream<TA, TW, R, true>(x, w, out, M, K, N, kps, stream);
  return launch_stream<TA, TW, R, false>(x, w, out, M, K, N, kps, stream);
}

template <typename TA, typename TW>
cudaError_t launch_gemm(const void* x, const void* w, void* out, int M, int K,
                        int N, int kps, cudaStream_t stream) {
  // int8 weights (16 columns a lane) keep 4 rows a pass: 8 would not fit
  // the accumulators in the registers two blocks an SM leave
  if constexpr (std::is_same_v<TW, int8_t>) {
    return launch_rows<TA, TW, 4>(x, w, out, M, K, N, kps, stream);
  } else {
    if (M <= 4)
      return launch_rows<TA, TW, 4>(x, w, out, M, K, N, kps, stream);
    return launch_rows<TA, TW, 8>(x, w, out, M, K, N, kps, stream);
  }
}

template <typename TA>
cudaError_t gemm_by_w(int w_dtype, const void* x, const void* w, void* out,
                      int M, int K, int N, int kps, cudaStream_t st) {
  if (w_dtype == kBF16)
    return launch_gemm<TA, bf16>(x, w, out, M, K, N, kps, st);
  if (w_dtype == kI8)
    return launch_gemm<TA, int8_t>(x, w, out, M, K, N, kps, st);
  return launch_gemm<TA, float>(x, w, out, M, K, N, kps, st);
}

cudaError_t gemm(int x_dtype, int w_dtype, const void* x, const void* w,
                 void* out, int M, int K, int N, int kps, cudaStream_t st) {
  if (x_dtype == kBF16)
    return gemm_by_w<bf16>(w_dtype, x, w, out, M, K, N, kps, st);
  if (x_dtype == kI8)
    return gemm_by_w<int8_t>(w_dtype, x, w, out, M, K, N, kps, st);
  return gemm_by_w<float>(w_dtype, x, w, out, M, K, N, kps, st);
}

// jnp.result_type of two dtype codes
inline int result_dtype(int a, int b) {
  if (a == b) return a;
  if (a == kI8) return b;
  if (b == kI8) return a;
  return kF32;
}

inline bool known(int d) { return d == kF32 || d == kBF16 || d == kI8; }

// k_per_split as decode_plan makes it: a multiple of 8, at most 16 splits,
// or at least K for no split
inline bool split_ok(int K, int kps) {
  return kps >= 1 &&
         (kps >= K || (kps % 8 == 0 && (K + kps - 1) / kps <= kMaxSplits));
}

// ---------------------------------------------------- K2's wide route
// bf16 x bf16 on the tensor cores (see the note above). Its
// kernel is named stream_kernel too, in a namespace of its own: the
// profile's short name of every K2 launch, whichever route.
namespace wide {

using namespace hk;

constexpr int kKS = 64;                  // k a stage: 128-byte rows of x
constexpr int kSmemBudget = 200 * 1024;  // the ring and the splits' sums

// Shapes of one instantiation: NWG consumer warpgroups (tile_m = 64 NWG),
// tile_n = BN columns.
template <int NWG, int BN>
struct Shape {
  static constexpr int kBM = 64 * NWG;
  static constexpr int kABytes = kBM * kKS * 2;
  static constexpr int kBBytes = kKS * BN * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  // the splits' float32 sums of a block's share of a tile's rows: splits
  // x ceil(kBM / splits) rows, at most kBM + kMaxSplits - 1
  static constexpr int kRecvBytes = (kBM + kMaxSplits) * BN * 4;
  static constexpr int kStages =
      std::min(8, (kSmemBudget - kRecvBytes) / kStageBytes);
  static constexpr int kThreads = NWG * 128 + 32;   // + the producer warp
  static constexpr int kAcc = BN / 2;               // floats a thread
  static constexpr int kWords = kBM / 16;   // liveness words, 16 rows each
  static constexpr int kSmem = 1024 + kStages * kStageBytes +
                               2 * kStages * 8 + kMaxSplits * kWords * 4 +
                               kRecvBytes;
};

// out[M, N] (bf16) = gated x[M, K] @ w[K, N], both bf16, through TMA maps
// of x (boxes [tile_m, 64]) and w (boxes [64, 64]). Output tile t is rows
// (t % m_tiles) tile_m and columns (t / m_tiles) BN on. Unsplit, block b
// walks tiles b, b + gridDim.x, ... (persistent where the tiles outnumber
// the blocks); split, each of the tiles blocks takes one tile, and the
// cluster along z holds its splits of K, k_per_split rows each.
template <int NWG, int BN>
__global__ void __launch_bounds__(Shape<NWG, BN>::kThreads, 1)
stream_kernel(const __grid_constant__ CUtensorMap map_x,
              const __grid_constant__ CUtensorMap map_w,
              bf16* __restrict__ out, int M, int K, int N, int k_per_split,
              int m_tiles, int tiles) {
  using S = Shape<NWG, BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::kStages *
                                               S::kStageBytes);
  uint64_t* empty = full + S::kStages;
  // words[split][j]: bits 2 i and 2 i + 1 say whether row 16 j + i of the
  // tile has a word whose bits are not all 0 in that split's k range
  uint32_t* words = reinterpret_cast<uint32_t*>(empty + S::kStages);
  // recv[split][share][BN]: the splits' sums of this block's share of the
  // tile's rows
  float* recv = reinterpret_cast<float*>(words + kMaxSplits * S::kWords);
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = cluster.num_blocks();     // the cluster spans K
  const int split = cluster.block_rank();
  const int share = (S::kBM + splits - 1) / splits;   // rows a block sums
  const int ks0 = split * k_per_split, ks1 = min(K, ks0 + k_per_split);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWG * 4);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == NWG * 4) {   // the producer warp: the ring's TMA loads
    if (lane == 0) {
      prefetch_map(&map_x);
      prefetch_map(&map_w);
      int s = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t % m_tiles * S::kBM, n0 = t / m_tiles * BN;
        for (int k0 = ks0; k0 < ks1; k0 += kKS) {
          mbar_wait(&empty[s], phase ^ 1);
          uint8_t* stage = smem + s * S::kStageBytes;
          mbar_expect_tx(&full[s], S::kStageBytes);
          tma_load(stage, &map_x, k0, m0, &full[s]);
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load(stage + S::kABytes + j * kKS * 128, &map_w, n0 + 64 * j,
                     k0, &full[s]);
          if (++s == S::kStages) { s = 0; phase ^= 1; }
        }
      }
    }
    __syncwarp();
  } else {   // consumer warpgroups: rows 64 wg .. 64 wg + 63 of a tile
    const int wg = warp / 4, w4 = warp % 4;
    // the m64nBN accumulator layout: thread (warp w4, lane l) holds rows
    // 16 w4 + l / 4 and + 8, columns 8 j + 2 (l % 4) and + 1
    const int row0 = 16 * w4 + lane / 4, col0 = 2 * (lane % 4);
    int s = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = t % m_tiles * S::kBM, n0 = t / m_tiles * BN;
      float acc[S::kAcc], tot[S::kAcc];
#pragma unroll
      for (int i = 0; i < S::kAcc; ++i) acc[i] = tot[i] = 0.0f;
      uint32_t bits = 0;   // the words this lane tests, ORed
      for (int k0 = ks0; k0 < ks1; k0 += kKS) {
        mbar_wait(&full[s], phase);
        const uint8_t* stage = smem + s * S::kStageBytes;
        const uint32_t a_addr = smem_addr(stage) + wg * 64 * kKS * 2;
        const uint32_t b_addr = smem_addr(stage) + S::kABytes;
        fence_operands(acc);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < kKS / 16; ++kk) {
          // A: K-major 128-byte rows, 8-row groups 1024 bytes apart, k16
          // steps 32 bytes into the row. B: N-major, 64-column boxes of 64
          // rows (8192 bytes) side by side, 8-row groups 1024 bytes apart,
          // k16 steps 16 rows (2048 bytes) down.
          const uint64_t da = make_desc(a_addr + kk * 32, 16, 16 * kKS, 1);
          const uint64_t db = make_desc(b_addr + kk * 2048, kKS * 128, 1024,
                                        1);
          wgmma(acc, da, db, kk > 0);
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        // the row gate while the tensor cores work: lanes 2 i and 2 i + 1
        // test the two halves of row 16 w4 + i of the warpgroup's rows (a
        // row is 128 bytes; the swizzle moves 16-byte pieces within it)
        const uint4* half = reinterpret_cast<const uint4*>(
            stage + (wg * 64 + 16 * w4 + lane / 2) * kKS * 2) + lane % 2 * 4;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint4 u = half[i];
          bits |= u.x | u.y | u.z | u.w;
        }
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fence_operands(acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
#pragma unroll
        for (int i = 0; i < S::kAcc; ++i) tot[i] += acc[i];
        if (++s == S::kStages) { s = 0; phase ^= 1; }
      }
      bits |= __shfl_xor_sync(0xFFFFFFFFu, bits, 1);
      // bit 2 i (and 2 i + 1): row 16 w4 + i has a nonzero word here
      const uint32_t live = __ballot_sync(0xFFFFFFFFu, bits != 0);
      if (splits == 1) {
#pragma unroll
        for (int i = 0; i < S::kAcc; i += 2) {
          const int r = row0 + ((i & 2) ? 8 : 0);
          const int m = m0 + wg * 64 + r, n = n0 + col0 + 8 * (i / 4);
          if (m < M && n < N) {   // N even: n + 1 < N too
            const bool on = live >> (2 * (r - 16 * w4)) & 1;
            *reinterpret_cast<__nv_bfloat162*>(
                out + static_cast<size_t>(m) * N + n) =
                __floats2bfloat162_rn(on ? tot[i] : 0.0f,
                                      on ? tot[i + 1] : 0.0f);
          }
        }
      } else {   // to the blocks that sum the rows: liveness and sums
        if (lane < splits)
          *cluster.map_shared_rank(&words[split * S::kWords + wg * 4 + w4],
                                   lane) = live;
#pragma unroll
        for (int i = 0; i < S::kAcc; i += 2) {
          const int r = wg * 64 + row0 + ((i & 2) ? 8 : 0);
          const int c = col0 + 8 * (i / 4);
          *cluster.map_shared_rank(
              reinterpret_cast<float2*>(
                  recv + (split * share + r % share) * BN + c),
              r / share) = make_float2(tot[i], tot[i + 1]);
        }
      }
    }
  }
  if (splits == 1) return;

  // this block's share of the tile's rows: the splits' sums in split
  // order, rounded once, or the +0.0 of a row no split found live
  cluster.sync();   // every split's sums and liveness are in
  const int m0 = blockIdx.x % m_tiles * S::kBM;
  const int n0 = blockIdx.x / m_tiles * BN;
  const int r0 = split * share, rn = min(S::kBM, r0 + share) - r0;
  for (int i = threadIdx.x; i < rn * BN; i += S::kThreads) {
    const int rl = i / BN, c = i % BN, r = r0 + rl;
    const int m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) continue;
    uint32_t word = 0;
    for (int q = 0; q < splits; ++q) word |= words[q * S::kWords + r / 16];
    float sum = 0.0f;
    if (word >> (2 * (r % 16)) & 1) {
      sum = recv[rl * BN + c];
      for (int q = 1; q < splits; ++q) sum += recv[(q * share + rl) * BN + c];
    }
    out[static_cast<size_t>(m) * N + n] = __float2bfloat16_rn(sum);
  }
}

template <int NWG, int BN>
cudaError_t launch(const void* x, const void* w, void* out, int M, int K,
                   int N, int kps, int workers, cudaStream_t stream) {
  using S = Shape<NWG, BN>;
  const auto kernel = stream_kernel<NWG, BN>;
  CUtensorMap map_x, map_w;
  if (!cached_map(&map_x, x, M, K, S::kBM, kKS) ||
      !cached_map(&map_w, w, K, N, kKS, kKS))
    return cudaErrorInvalidValue;
  static bool ready = false;   // its shared memory, clusters past 8
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const int m_tiles = (M + S::kBM - 1) / S::kBM;
  const int tiles = m_tiles * ((N + BN - 1) / BN);
  const int splits = (K + kps - 1) / kps;
  if (splits == 1) {   // a cluster of one: the plain launch is cheaper
    kernel<<<std::min(workers, tiles), S::kThreads, S::kSmem, stream>>>(
        map_x, map_w, static_cast<bf16*>(out), M, K, N, kps, m_tiles,
        tiles);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles, 1, splits);
  cfg.blockDim = dim3(S::kThreads);
  cfg.dynamicSmemBytes = S::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, map_x, map_w,
                            static_cast<bf16*>(out), M, K, N, kps, m_tiles,
                            tiles);
}

}  // namespace wide

// ------------------------------------------------------------------ K3
struct Streams {
  int32_t* wc;       // [B, n_rows_w, lanes_w]
  int32_t* wz;       // [B, K]
  int n_rows_w;
  int lanes_w;
  int groups_w;      // 32-lane groups of a west stream
  int32_t* nc;       // [n_rows_n, lanes_n]
  int32_t* nz;       // [K]
  int n_rows_n;
  int lanes_n;
};

// One cluster a 32-lane group: blockIdx.x the group (the B west streams'
// groups, then the north stream's), blockIdx.y the block of the cluster.
template <typename TA, typename TW, int NSEG>
__global__ void __launch_bounds__(pc::kWalkWarps * 32)
walk_kernel(const TA* __restrict__ a, const TW* __restrict__ w, int B, int K,
            int N, int chunk, const Streams s, const pc::Params pw,
            const pc::Params pn) {
  __shared__ pc::ChunkShared sm;
  const int g = blockIdx.x, lane_in = threadIdx.x % 32;
  if (g < B * s.groups_w) {   // request row b's west stream
    const int b = g / s.groups_w, lane = (g % s.groups_w) * 32 + lane_in;
    const TA* ab = a + static_cast<size_t>(b) * K;
    const auto load = [&](int t) {   // every lane reads, lane 0 keeps
      const uint32_t word = pc::bf16_word(ab[t]);
      return lane == 0 ? word : 0u;
    };
    pc::walk_chunked<NSEG>(
        load, K, chunk, lane < s.lanes_w, s.wz + static_cast<size_t>(b) * K,
        s.wc + static_cast<size_t>(b) * s.n_rows_w * s.lanes_w + lane,
        s.lanes_w, pw, s.n_rows_w, sm);
  } else {                    // the north stream
    const int lane = (g - B * s.groups_w) * 32 + lane_in;
    const int col = min(lane, N - 1);   // the padding lanes read column N-1
    const auto load = [&](int t) {
      const uint32_t word = pc::bf16_word(w[static_cast<size_t>(t) * N + col]);
      return lane < N ? word : 0u;
    };
    pc::walk_chunked<NSEG>(load, K, chunk, lane < s.lanes_n, s.nz,
                           s.nc + lane, s.lanes_n, pn, s.n_rows_n, sm);
  }
}

template <typename TA, typename TW, int NSEG>
cudaError_t launch_walk(const void* a, const void* w, int B, int K, int N,
                        int chunk, int cluster, const Streams& s,
                        const pc::Params& pw, const pc::Params& pn,
                        cudaStream_t stream) {
  const int groups = B * s.groups_w + (s.lanes_n + 31) / 32;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(groups, cluster);
  cfg.blockDim = dim3(pc::kWalkWarps * 32);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cluster;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, walk_kernel<TA, TW, NSEG>,
                            static_cast<const TA*>(a),
                            static_cast<const TW*>(w), B, K, N, chunk, s, pw,
                            pn);
}

template <typename TA, typename TW>
cudaError_t launch_fused(const void* a, const void* w, void* out, int B,
                         int K, int N, int kps, int chunk, int cluster,
                         bool wide_segs, const Streams& s,
                         const pc::Params& pw, const pc::Params& pn,
                         cudaStream_t st) {
  cudaError_t err = launch_gemm<TA, TW>(a, w, out, B, K, N, kps, st);
  if (err != cudaSuccess) return err;
  return wide_segs
             ? launch_walk<TA, TW, pc::kMaxSegs>(a, w, B, K, N, chunk,
                                                 cluster, s, pw, pn, st)
             : launch_walk<TA, TW, 4>(a, w, B, K, N, chunk, cluster, s, pw,
                                      pn, st);
}

}  // namespace

// K2: out[M, N] = gated x[M, K] @ w[K, N], all contiguous, dtype codes
// 0 = float32, 1 = bfloat16, 2 = int8 (out of jnp.result_type of the
// pair). k_per_split: the k rows each of the cluster's splits walks (from
// decode_plan): a multiple of 8, at most 16 splits, or at least K for no
// split; any K. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int zm_gated_row_matmul(const void* x, int x_dtype, const void* w,
                                   int w_dtype, void* out, int out_dtype,
                                   int M, int K, int N, int k_per_split,
                                   void* stream) {
  if (M < 1 || K < 1 || N < 1 || !known(x_dtype) || !known(w_dtype) ||
      out_dtype != result_dtype(x_dtype, w_dtype) ||
      !split_ok(K, k_per_split))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      gemm(x_dtype, w_dtype, x, w, out, M, K, N, std::min(k_per_split, K),
           static_cast<cudaStream_t>(stream));
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}

// K2's wide route: out[M, N] = gated x[M, K] @ w[K, N], all bfloat16 and
// contiguous, K and N multiples of 8, x and w 16-byte aligned (rows TMA
// can describe). tile_m (64 or 128) and tile_n (64 or 128) are the output
// tile; k_per_split (a multiple of 64) the k each of a cluster's splits
// walks (at most 16 splits); workers the blocks of an unsplit grid, which
// walk the tiles (wide_plan). The launch goes to stream on device, made
// current for it where it is not. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int zm_gated_row_matmul_wide(const void* x, const void* w,
                                        void* out, int M, int K, int N,
                                        int tile_m, int tile_n,
                                        int k_per_split, int workers,
                                        int device, void* stream) {
  int current = device;
  if (cudaGetDevice(&current) != cudaSuccess || current != device) {
    if (cudaSetDevice(device) != cudaSuccess)
      return static_cast<int>(cudaErrorInvalidDevice);
    const int err = zm_gated_row_matmul_wide(x, w, out, M, K, N, tile_m,
                                             tile_n, k_per_split, workers,
                                             device, stream);
    cudaSetDevice(current);
    return err;
  }
  const int splits = k_per_split < 1 ? 0 : (K + k_per_split - 1) / k_per_split;
  if (M < 1 || K < 1 || N < 1 || K % 8 || N % 8 ||
      (tile_m != 64 && tile_m != 128) || (tile_n != 64 && tile_n != 128) ||
      k_per_split < 1 || k_per_split % wide::kKS || splits > kMaxSplits ||
      workers < 1 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (tile_m == 128)
    err = tile_n == 128
              ? wide::launch<2, 128>(x, w, out, M, K, N, k_per_split,
                                     workers, st)
              : wide::launch<2, 64>(x, w, out, M, K, N, k_per_split, workers,
                                    st);
  else
    err = tile_n == 128
              ? wide::launch<1, 128>(x, w, out, M, K, N, k_per_split,
                                     workers, st)
              : wide::launch<1, 64>(x, w, out, M, K, N, k_per_split, workers,
                                    st);
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}

// K3: the product out[B, N] of a[B, K] and w[K, N] as K2 computes it
// (float32 or bfloat16 operands, k_per_split from decode_plan), and the
// counters of the B west streams into wc[B, n_rows_w, lanes_w] and
// wz[B, K], and of the north stream into nc[n_rows_n, lanes_n] and nz[K]
// (wz and nz zeroed by the caller), walked in chunks of `chunk` cycles by
// clusters of `cluster` blocks (chunk_plan: cluster * 8 * chunk >= K, at
// most 8 blocks). Each edge's CounterSpec comes flattened as
// pc_fused_counters takes it. lanes_n must be at least N.
extern "C" int zm_fused_matmul_counters(
    const void* a, int a_dtype, const void* w, int w_dtype, void* out,
    int out_dtype, int B, int K, int N, int32_t* wc, int32_t* wz,
    int n_rows_w, int lanes_w, int w_segs, const uint32_t* w_seg_masks,
    int w_variants, const uint32_t* w_variant_segs, int w_zvg, int w_hist,
    int32_t* nc, int32_t* nz, int n_rows_n, int lanes_n, int n_segs,
    const uint32_t* n_seg_masks, int n_variants,
    const uint32_t* n_variant_segs, int n_zvg, int n_hist, int k_per_split,
    int chunk, int cluster, void* stream) {
  pc::Params pw, pn;
  const bool floats = (a_dtype == kF32 || a_dtype == kBF16) &&
                      (w_dtype == kF32 || w_dtype == kBF16);
  if (B < 1 || K < 1 || N < 1 || lanes_w < 1 || lanes_n < N || !floats ||
      out_dtype != result_dtype(a_dtype, w_dtype) ||
      !split_ok(K, k_per_split) || chunk < 1 || cluster < 1 || cluster > 8 ||
      static_cast<long long>(cluster) * pc::kWalkWarps * chunk < K ||
      !pc::make_params(pw, n_rows_w, w_segs, w_seg_masks, w_variants,
                       w_variant_segs, w_zvg, w_hist) ||
      !pc::make_params(pn, n_rows_n, n_segs, n_seg_masks, n_variants,
                       n_variant_segs, n_zvg, n_hist))
    return static_cast<int>(cudaErrorInvalidValue);
  const Streams s{wc, wz, n_rows_w, lanes_w, (lanes_w + 31) / 32,
                  nc, nz, n_rows_n, lanes_n};
  const auto st = static_cast<cudaStream_t>(stream);
  const int kps = std::min(k_per_split, K);
  const bool wide = w_segs > 4 || n_segs > 4;
  cudaError_t err;
  if (a_dtype == kBF16 && w_dtype == kBF16)
    err = launch_fused<bf16, bf16>(a, w, out, B, K, N, kps, chunk, cluster,
                                   wide, s, pw, pn, st);
  else if (a_dtype == kBF16)
    err = launch_fused<bf16, float>(a, w, out, B, K, N, kps, chunk, cluster,
                                    wide, s, pw, pn, st);
  else if (w_dtype == kBF16)
    err = launch_fused<float, bf16>(a, w, out, B, K, N, kps, chunk, cluster,
                                    wide, s, pw, pn, st);
  else
    err = launch_fused<float, float>(a, w, out, B, K, N, kps, chunk,
                                     cluster, wide, s, pw, pn, st);
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}
