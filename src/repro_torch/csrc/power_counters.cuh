// Device code shared by every kernel that walks a systolic-array edge
// stream: the walk of the fused power-counter pass (the held register,
// the BIC invert recurrences, the ones histograms), the scan that gives
// each chunk of a walk its start state, and the host-side checks of the
// walk's arguments. power_counters.cu (K1, the counter pass alone),
// zvg_matmul.cu (K3, the decode matmul fused with its counters) and
// bic_encode.cu (K6, whose invert line is one segment's recurrence) include
// it, so the step arithmetic is one piece of code; K1 and K3 replace walks
// of the TPU kernel
//   src/repro/kernels/power_counters/kernel.py::fused_counters_pallas
// (K3 through src/repro/kernels/zvg_matmul/fused.py::fused_matmul_counters).
//
// What bounds a walk on an H100 is its bytes (each 16-bit word read once,
// the counters written once: microseconds at 3.35 TB/s), but a walk of T
// cycles in one thread is a dependent chain of T steps. So every walk here
// cuts a lane's T cycles into chunks walked in parallel and composes what
// each chunk does to the carried state (the TPU kernel's "parallel"
// algorithm): walk_chunked (K3) and walk_grouped (K1), see their sections.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cooperative_groups.h>

namespace pc {

constexpr int kMaxSegs = 31;
constexpr int kMaxVariants = 64;
constexpr int kWordBits = 16;
constexpr uint32_t kMant = 0x007Fu;
constexpr uint32_t kNotSign = 0x7FFFu;

struct Params {
  int n_segs;
  int n_variants;
  int zvg;
  int hist;
  uint32_t seg_mask[kMaxSegs];
  int seg_width[kMaxSegs];
  uint32_t variant_segs[kMaxVariants];  // bit si: variant uses segment si
};

// Fills `p` from a CounterSpec's flattened form (its unique segment masks
// and one bitmask of segment indices per BIC variant). Returns false for
// arguments the walk does not take, among them an n_rows other than the
// spec's row count.
inline bool make_params(Params& p, int n_rows, int n_segs,
                        const uint32_t* seg_masks, int n_variants,
                        const uint32_t* variant_segs, int zvg, int hist) {
  const int want_rows = 3 + (zvg ? 3 : 0) + 2 * n_variants * (zvg ? 2 : 1) +
                        (hist ? kWordBits : 0);
  if (n_segs < 0 || n_segs > kMaxSegs || n_variants < 0 ||
      n_variants > kMaxVariants || (n_variants > 0) != (n_segs > 0) ||
      n_rows != want_rows)
    return false;
  p = Params{};
  p.n_segs = n_segs;
  p.n_variants = n_variants;
  p.zvg = zvg;
  p.hist = hist;
  for (int i = 0; i < n_segs; ++i) {
    p.seg_mask[i] = seg_masks[i] & 0xFFFFu;
    p.seg_width[i] = __builtin_popcount(p.seg_mask[i]);
  }
  for (int v = 0; v < n_variants; ++v) p.variant_segs[v] = variant_segs[v];
  return true;
}

// The bfloat16 word of a float: round to nearest even, and every NaN
// becomes 0x7FC0 | sign << 15 (the word XLA's cast writes, and the port's
// core/bits.to_bits). A select, not a branch: a branch on a loaded value
// keeps the compiler from issuing the next cycles' loads before it, which
// serialised a walk's loads at one memory latency a cycle.
__device__ __forceinline__ uint32_t bf16_word(float x) {
  const uint32_t u = __float_as_uint(x);
  const uint32_t nan = 0x7FC0u | ((u >> 16) & 0x8000u);
  const uint32_t w = __bfloat16_as_ushort(__float2bfloat16_rn(x));
  return (u & 0x7FFFFFFFu) > 0x7F800000u ? nan : w;
}

__device__ __forceinline__ uint32_t bf16_word(__nv_bfloat16 x) {
  return __bfloat16_as_ushort(x);
}

template <int NSEG>
struct BicState {
  uint32_t inv;      // packed invert lines
  int dsum[NSEG];    // sum over flips of (w - 2d): data-toggle correction
  int fsum[NSEG];    // invert-line toggles
};

// One cycle of every segment's invert recurrence: a distance above w/2
// toggles the line, below keeps it, exactly w/2 clears it (the reference's
// _bic_step). Within a segment the encoded bus toggles d bits when the
// line holds and w - d when it flips, so the encoded stream is never
// formed.
template <int NSEG>
__device__ __forceinline__ void bic_step(BicState<NSEG>& s, uint32_t xo,
                                         const Params& p) {
  int d[NSEG];
  uint32_t tog = 0u, clr = 0u;
#pragma unroll
  for (int si = 0; si < NSEG; ++si) {
    if (si < p.n_segs) {
      d[si] = __popc(xo & p.seg_mask[si]);
      const int w = p.seg_width[si];
      tog |= static_cast<uint32_t>(2 * d[si] > w) << si;
      clr |= static_cast<uint32_t>(2 * d[si] == w) << si;
    }
  }
  const uint32_t inv = (s.inv ^ tog) & ~clr;
  const uint32_t flip = inv ^ s.inv;
  s.inv = inv;
#pragma unroll
  for (int si = 0; si < NSEG; ++si) {
    if (si < p.n_segs) {
      const int f = (flip >> si) & 1;
      s.fsum[si] += f;
      s.dsum[si] += f * (p.seg_width[si] - 2 * d[si]);
    }
  }
}

// A lane's walk state and counts: the previous word, the held register,
// the previous is-zero bit, the invert lines of both encoded streams and
// every row's running sum. step() takes one cycle (per lane the counts
// accumulate in registers; the per-cycle zero words are summed into
// rowzeros by the walks below, a warp ballot and one atomicAdd per warp
// and cycle, integer and so exact in any order); emit() hands each row of
// CounterSpec.rows, in order, to sink(row, value).
template <int NSEG>
struct Walk {
  uint32_t prev = 0u, held = 0u;
  bool prev_z = false;
  int raw = 0, mant = 0, zeros = 0, hraw = 0, hmant = 0, iszero = 0;
  int ones[kWordBits];
  BicState<NSEG> br{}, bh{};

  __device__ __forceinline__ Walk() {
#pragma unroll
    for (int i = 0; i < kWordBits; ++i) ones[i] = 0;
  }

  __device__ __forceinline__ void step(uint32_t w, bool z, const Params& p) {
    const uint32_t xo = w ^ prev;
    prev = w;
    raw += __popc(xo);
    mant += __popc(xo & kMant);
    zeros += z;
    if (p.n_segs) bic_step<NSEG>(br, xo, p);
    if (p.zvg) {
      const uint32_t h = z ? held : w;
      const uint32_t ho = h ^ held;
      held = h;
      hraw += __popc(ho);
      hmant += __popc(ho & kMant);
      iszero += (z != prev_z);
      prev_z = z;
      if (p.n_segs) bic_step<NSEG>(bh, ho, p);
    }
    if (p.hist) {
#pragma unroll
      for (int bit = 0; bit < kWordBits; ++bit) ones[bit] += (w >> bit) & 1u;
    }
  }

  template <typename Sink>
  __device__ __forceinline__ void emit(const Sink& sink,
                                       const Params& p) const {
    int row = 0;
    sink(row++, raw);
    sink(row++, mant);
    sink(row++, zeros);
    if (p.zvg) {
      sink(row++, hraw);
      sink(row++, hmant);
      sink(row++, iszero);
    }
    row = emit_variants(sink, row, raw, br, p);
    if (p.zvg) row = emit_variants(sink, row, hraw, bh, p);
    if (p.hist) {
#pragma unroll
      for (int bit = 0; bit < kWordBits; ++bit) sink(row++, ones[bit]);
    }
  }

  template <typename Sink>
  __device__ __forceinline__ static int emit_variants(
      const Sink& sink, int row, int base, const BicState<NSEG>& s,
      const Params& p) {
    for (int v = 0; v < p.n_variants; ++v) {
      const uint32_t segs = p.variant_segs[v];
      int data = base, inv = 0;
#pragma unroll
      for (int si = 0; si < NSEG; ++si) {
        if (si < p.n_segs && ((segs >> si) & 1u)) {
          data += s.dsum[si];
          inv += s.fsum[si];
        }
      }
      sink(row++, data);
      sink(row++, inv);
    }
    return row;
  }
};

// ------------------------------------------------------------------------
// The chunked walk: the TPU kernel's "parallel" algorithm (the reference's
// _compose_packed and its MAX scan over cycle << 16 | word), laid out for
// threads. A lane's T cycles are cut into chunks of C; one warp walks one
// chunk of 32 adjacent lanes, so its ballots over rowzeros line up, and a
// thread block cluster of `CL` blocks of kWalkWarps warps holds every chunk
// of its 32 lanes (CL * kWalkWarps * C >= T; the plan is kernels/
// zvg_matmul/kernel.py::chunk_plan).
//   pass 1: each thread sums up its chunk: the composed step functions of
//     both invert recurrences (packed (f(0), f(1)) words, one bit lane per
//     unique segment), the chunk's first and last live word (the held
//     register's carry; the held stream's steps before the first live
//     word are the identity, and only that word's step depends on the
//     held value at the chunk's start) and the rowzeros ballots;
//   combine: the summaries compose in cycle order -- warp 0 folds its
//     block's chunks, the blocks' folds meet through distributed shared
//     memory, each block folds the blocks before it in rank order -- and
//     give every chunk its start state (held word, both invert words; the
//     previous word and is-zero bit are the stream's own word at t0 - 1);
//   pass 2: each thread re-walks its chunk from that state and counts
//     every row (Walk::step); the counts are integers, summed in shared
//     memory and then across the cluster, so exact in any order.
// walk_grouped (K1, below) is this walk laid out for batched and wide
// streams; it shares these pieces.
constexpr int kWalkWarps = 8;   // warps a block, one chunk each
constexpr int kMaxRows = 6 + 4 * kMaxVariants + kWordBits;

// A packed step function of the invert lines: the lines after the step
// where they were 0 (f0) and where they were 1 (f1), one bit a segment.
struct Fn {
  uint32_t f0, f1;
};

__device__ __forceinline__ Fn fn_identity() { return {0u, 0xFFFFFFFFu}; }

// g after f
__device__ __forceinline__ Fn fn_then(Fn f, Fn g) {
  return {(f.f0 & g.f1) | (~f.f0 & g.f0), (f.f1 & g.f1) | (~f.f1 & g.f0)};
}

__device__ __forceinline__ uint32_t fn_apply(Fn f, uint32_t s) {
  return (f.f0 & ~s) | (f.f1 & s);
}

// the step function of one cycle whose bus changes by xo (bic_step's rule:
// above w/2 toggles the line, below keeps it, exactly w/2 clears it)
template <int NSEG>
__device__ __forceinline__ Fn bic_fn(uint32_t xo, const Params& p) {
  uint32_t tog = 0u, clr = 0u;
#pragma unroll
  for (int si = 0; si < NSEG; ++si) {
    if (si < p.n_segs) {
      const int d = __popc(xo & p.seg_mask[si]);
      const int w = p.seg_width[si];
      tog |= static_cast<uint32_t>(2 * d > w) << si;
      clr |= static_cast<uint32_t>(2 * d == w) << si;
    }
  }
  return {tog & ~clr, ~tog & ~clr};
}

// What a run of cycles does to the walk's carried state.
struct ChunkSum {
  Fn raw;            // the raw stream's invert lines across the run
  Fn held;           // the held stream's, after the run's first live word
  uint32_t first;    // the first live (non-zero) word
  uint32_t last;     // the last live word: the held register after the run
  bool has;          // the run holds a live word
};

// The state a chunk starts from, beyond the stream's own previous word.
struct ChunkStart {
  uint32_t held, inv_r, inv_h;
};

__device__ __forceinline__ ChunkSum chunk_identity() {
  return {fn_identity(), fn_identity(), 0u, 0u, false};
}

// the run a, then the run b
template <int NSEG>
__device__ __forceinline__ ChunkSum chunk_then(const ChunkSum& a,
                                               const ChunkSum& b,
                                               const Params& p) {
  ChunkSum r;
  r.raw = fn_then(a.raw, b.raw);
  if (!a.has) {
    r.held = b.held; r.first = b.first; r.last = b.last; r.has = b.has;
  } else if (!b.has) {
    r.held = a.held; r.first = a.first; r.last = a.last; r.has = true;
  } else {
    r.held = fn_then(fn_then(a.held, bic_fn<NSEG>(b.first ^ a.last, p)),
                     b.held);
    r.first = a.first; r.last = b.last; r.has = true;
  }
  return r;
}

template <int NSEG>
__device__ __forceinline__ ChunkStart chunk_apply(const ChunkSum& c,
                                                  ChunkStart s,
                                                  const Params& p) {
  s.inv_r = fn_apply(c.raw, s.inv_r);
  if (c.has) {
    s.inv_h = fn_apply(c.held,
                       fn_apply(bic_fn<NSEG>(c.first ^ s.held, p), s.inv_h));
    s.held = c.last;
  }
  return s;
}

// A summary in shared memory: six words per lane.
__device__ __forceinline__ void put_sum(uint32_t (*dst)[32], int lane,
                                        const ChunkSum& c) {
  dst[0][lane] = c.raw.f0;
  dst[1][lane] = c.raw.f1;
  dst[2][lane] = c.held.f0;
  dst[3][lane] = c.held.f1;
  dst[4][lane] = c.first | (static_cast<uint32_t>(c.has) << 16);
  dst[5][lane] = c.last;
}

__device__ __forceinline__ ChunkSum get_sum(const uint32_t (*src)[32],
                                            int lane) {
  ChunkSum c;
  c.raw = {src[0][lane], src[1][lane]};
  c.held = {src[2][lane], src[3][lane]};
  c.first = src[4][lane] & 0xFFFFu;
  c.has = (src[4][lane] >> 16) & 1u;
  c.last = src[5][lane];
  return c;
}

struct ChunkShared {
  uint32_t sum[kWalkWarps][6][32];     // each warp's chunk, per lane
  uint32_t agg[6][32];                 // the block's chunks, composed
  uint32_t start[kWalkWarps][3][32];   // each chunk's start state
  int32_t counts[kMaxRows][32];        // the block's counts, per lane
};

// A chunked walk's `load(t)` must take any t in [0, T) for any lane,
// valid or not, without a branch (a lane past the stream's edge reads a
// clamped address and returns 0 by a select), so that the walks below
// issue kAhead cycles' loads unconditionally, back to back, before any is
// used: a load under a condition stays behind the uses before it, and the
// walk then waits a memory latency a cycle.
constexpr int kAhead = 8;    // cycles a chunked walk loads at once

// The words of cycles u0 .. u0 + N - 1 (those past t1 repeat t1 - 1's).
template <int N, typename Load>
__device__ __forceinline__ void load_ahead(const Load& load, int u0, int t1,
                                           uint32_t (&buf)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    buf[i] = load(min(u0 + i, t1 - 1)) & 0xFFFFu;
}

// Pass 1 over cycles [t0, t1) of a valid or invalid lane: the summary, and
// the rowzeros ballots.
template <int NSEG, typename Load>
__device__ __forceinline__ ChunkSum summarize(const Load& load, int t0,
                                              int t1, bool valid,
                                              int32_t* __restrict__ rz,
                                              const Params& p) {
  const int lane = threadIdx.x & 31;
  ChunkSum c = chunk_identity();
  const uint32_t before = load(max(t0 - 1, 0)) & 0xFFFFu;
  uint32_t prev = (valid && t0 > 0) ? before : 0u;
  for (int u0 = t0; u0 < t1; u0 += kAhead) {
    uint32_t buf[kAhead];
    load_ahead(load, u0, t1, buf);
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      if (u0 + i >= t1) break;   // the same for the whole warp
      const uint32_t w = valid ? buf[i] : 0u;
      const bool z = valid && (w & kNotSign) == 0u;
      const unsigned zb = __ballot_sync(0xFFFFFFFFu, z);
      if (lane == 0 && zb) atomicAdd(&rz[u0 + i], __popc(zb));
      if (p.n_segs) c.raw = fn_then(c.raw, bic_fn<NSEG>(w ^ prev, p));
      prev = w;
      if (!z) {
        if (!c.has) {
          c.has = true;
          c.first = w;
        } else if (p.zvg && p.n_segs) {
          c.held = fn_then(c.held, bic_fn<NSEG>(w ^ c.last, p));
        }
        c.last = w;
      }
    }
  }
  return c;
}

// Pass 2 over cycles [t0, t1) of a valid lane from the chunk's start state:
// the counts.
template <int NSEG, typename Load>
__device__ __forceinline__ Walk<NSEG> walk_chunk(const Load& load, int t0,
                                                 int t1,
                                                 const ChunkStart& st,
                                                 const Params& p) {
  Walk<NSEG> wk;
  const uint32_t before = load(max(t0 - 1, 0)) & 0xFFFFu;
  if (t0 > 0) {
    wk.prev = before;
    wk.prev_z = (before & kNotSign) == 0u;
  }
  wk.held = st.held;
  wk.br.inv = st.inv_r;
  wk.bh.inv = st.inv_h;
  for (int u0 = t0; u0 < t1; u0 += kAhead) {
    uint32_t buf[kAhead];
    load_ahead(load, u0, t1, buf);
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      if (u0 + i >= t1) break;
      wk.step(buf[i], (buf[i] & kNotSign) == 0u, p);
    }
  }
  return wk;
}

// The chunked walk of 32 adjacent lanes (this warp's lane: `valid` where it
// is one of the stream's) over T cycles, by one cluster of blocks of
// kWalkWarps warps, every block calling it with the same arguments: chunk
// `rank * kWalkWarps + warp` covers cycles [c * C, min(T, (c + 1) * C)).
// `load(t)` returns the lane's word at cycle t, as the note above
// summarize asks; `out` points at the lane's first counter row, the rows
// `stride` words apart, written by the cluster's first block; `rz` at the
// stream's rowzeros[T], summed into with atomics (zeroed by the caller).
template <int NSEG, typename Load>
__device__ __forceinline__ void walk_chunked(const Load& load, int T, int C,
                                             bool valid,
                                             int32_t* __restrict__ rz,
                                             int32_t* __restrict__ out,
                                             size_t stride, const Params& p,
                                             int n_rows, ChunkShared& sm) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = cluster.block_rank(), blocks = cluster.num_blocks();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = rank * kWalkWarps + warp;
  const int t0 = min(T, c * C), t1 = min(T, t0 + C);

  for (int i = threadIdx.x; i < n_rows * 32; i += kWalkWarps * 32)
    sm.counts[i / 32][i % 32] = 0;
  put_sum(sm.sum[warp], lane, summarize<NSEG>(load, t0, t1, valid, rz, p));
  __syncthreads();
  if (warp == 0) {   // this block's chunks, composed in order
    ChunkSum a = get_sum(sm.sum[0], lane);
    for (int w = 1; w < kWalkWarps; ++w)
      a = chunk_then<NSEG>(a, get_sum(sm.sum[w], lane), p);
    put_sum(sm.agg, lane, a);
  }
  cluster.sync();    // every block's composition is in
  if (warp == 0) {   // the start of each of this block's chunks
    ChunkStart st{0u, 0u, 0u};
    for (int q = 0; q < rank; ++q)
      st = chunk_apply<NSEG>(
          get_sum(cluster.map_shared_rank(sm.agg, q), lane), st, p);
    for (int w = 0; w < kWalkWarps; ++w) {
      sm.start[w][0][lane] = st.held;
      sm.start[w][1][lane] = st.inv_r;
      sm.start[w][2][lane] = st.inv_h;
      st = chunk_apply<NSEG>(get_sum(sm.sum[w], lane), st, p);
    }
  }
  __syncthreads();
  const ChunkStart st{sm.start[warp][0][lane], sm.start[warp][1][lane],
                      sm.start[warp][2][lane]};
  if (valid && t0 < t1)
    walk_chunk<NSEG>(load, t0, t1, st, p)
        .emit([&](int row, int v) {
          if (v) atomicAdd(&sm.counts[row][lane], v);
        }, p);
  cluster.sync();    // every block's counts are in
  if (rank == 0) {   // the blocks' counts in rank order
    for (int i = threadIdx.x; i < n_rows * 32; i += kWalkWarps * 32) {
      const int row = i / 32, l = i % 32;
      int v = sm.counts[row][l];
      for (int q = 1; q < blocks; ++q)
        v += cluster.map_shared_rank(&sm.counts[0][0], q)[row * 32 + l];
      sm.counts[row][l] = v;
    }
  }
  __syncthreads();
  if (rank == 0 && valid)
    for (int row = 0; row < n_rows; ++row)
      out[static_cast<size_t>(row) * stride] = sm.counts[row][lane];
  cluster.sync();    // no block leaves while its counts may be read
}


// ------------------------------------------------------------------------
// The grouped walk (K1, and K6's invert scan): the chunked walk laid out
// for batched and wide streams, from a plan (kernels/power_counters/
// kernel.py::counter_plan) that trades chunks for lane groups. A block of
// kWalkWarps warps holds kWalkWarps / `split` lane groups (32 adjacent
// lanes of one stream of the batch), `split` warps a group; the `cl`
// blocks of a cluster hold the same groups, so a group is cut into
// cl * split chunks: warp `sub` of its group in block `rank` walks chunk
// c = rank * split + sub, cycles [c * C, min(T, (c + 1) * C)).
//   * A group of one chunk (split = cl = 1: short streams, or enough groups
//     to fill the card) is walked in one pass from the all-zero bus
//     (walk_whole).
//   * Otherwise pass 1 summarises each chunk, and each warp folds, itself,
//     the summaries before its chunk (chunk_start): those of the earlier
//     blocks of its cluster (a cluster holds one group a block), read from
//     distributed shared memory all at once after one cluster barrier,
//     then those of the earlier warps of its block. A block's only other
//     wait on the cluster is at its end, for the others to have read its
//     summary.
// K1's counts go to global memory directly: stored by a walk in one pass,
// summed by atomics (integers, exact in any order; zeroed by the caller)
// when a group has several chunks, so no count is staged in shared memory.

// Launches a walk kernel over `blocks` blocks of kWalkWarps warps, in
// clusters of `cl` blocks along x where cl > 1 (past the portable 8 the
// kernel is allowed the non-portable size first).
template <typename... Params, typename... Args>
inline cudaError_t launch_walk(void (*kernel)(Params...), unsigned blocks,
                               int cl, cudaStream_t stream, Args... args) {
  if (cl > 8) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kWalkWarps * 32);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cl > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// Arrive at and wait on the cluster's barrier apart (cluster.sync() is
// both), so that a block waits only where it must.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// One kind of chunk summary, for chunk_start: the counter walk's (held
// register and both invert recurrences) ...
template <int NSEG>
struct CounterScan {
  using Sum = ChunkSum;
  using Start = ChunkStart;
  static constexpr int kWords = 6;
  const Params& p;
  __device__ __forceinline__ Sum identity() const { return chunk_identity(); }
  __device__ __forceinline__ Sum then(const Sum& a, const Sum& b) const {
    return chunk_then<NSEG>(a, b, p);
  }
  __device__ __forceinline__ Start apply(const Sum& c, Start s) const {
    return chunk_apply<NSEG>(c, s, p);
  }
  __device__ __forceinline__ void put(uint32_t (*dst)[32], int lane,
                                      const Sum& c) const {
    put_sum(dst, lane, c);
  }
  __device__ __forceinline__ Sum get(const uint32_t (*src)[32],
                                     int lane) const {
    return get_sum(src, lane);
  }
};

// ... and one invert line's (K6): its composed step function.
struct InvertScan {
  using Sum = Fn;
  using Start = uint32_t;
  static constexpr int kWords = 2;
  __device__ __forceinline__ Sum identity() const { return fn_identity(); }
  __device__ __forceinline__ Sum then(Sum a, Sum b) const {
    return fn_then(a, b);
  }
  __device__ __forceinline__ Start apply(Sum f, Start s) const {
    return fn_apply(f, s);
  }
  __device__ __forceinline__ void put(uint32_t (*dst)[32], int lane,
                                      Sum f) const {
    dst[0][lane] = f.f0;
    dst[1][lane] = f.f1;
  }
  __device__ __forceinline__ Sum get(const uint32_t (*src)[32],
                                     int lane) const {
    return {src[0][lane], src[1][lane]};
  }
};

constexpr int kMaxCluster = 16;   // blocks of a cluster (non-portable)

template <int WORDS>
struct ScanShared {
  uint32_t sum[kWalkWarps][WORDS][32];   // each warp's chunk
  uint32_t agg[WORDS][32];               // the block's chunks, composed
  uint32_t earlier[kMaxCluster][WORDS][32];   // the earlier blocks' aggs
};

// The start state of this warp's chunk, from `mine`, the summary of its
// own chunk (the identity for a warp without a stream), with every warp of
// the block calling it; see the section's note. A cluster (cl > 1) holds
// one group a block (split = kWalkWarps): its blocks' compositions are
// read from distributed shared memory all at once, a warp a block, and
// folded locally. With cl > 1 the caller must call cluster_wait() before
// it leaves.
template <class Scan>
__device__ __forceinline__ typename Scan::Start chunk_start(
    const Scan& scan, const typename Scan::Sum& mine, int split, int cl,
    ScanShared<Scan::kWords>& sm) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = warp % split;
  scan.put(sm.sum[warp], lane, mine);
  __syncthreads();
  typename Scan::Sum before = scan.identity();   // this block's, earlier
  for (int w = warp - sub; w < warp; ++w)
    before = scan.then(before, scan.get(sm.sum[w], lane));
  typename Scan::Start st{};
  if (cl > 1) {
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = cluster.block_rank();
    if (warp == kWalkWarps - 1) scan.put(sm.agg, lane, scan.then(before, mine));
    cluster.sync();   // every block's chunks are composed
    for (int q = warp; q < rank; q += kWalkWarps) {
      const uint32_t* src = cluster.map_shared_rank(&sm.agg[0][0], q);
#pragma unroll
      for (int i = 0; i < Scan::kWords; ++i)
        sm.earlier[q][i][lane] = src[i * 32 + lane];
    }
    cluster_arrive();   // this block has read the others
    __syncthreads();
    for (int q = 0; q < rank; ++q)
      st = scan.apply(scan.get(sm.earlier[q], lane), st);
  }
  return scan.apply(before, st);
}

// The one-pass walk of a block's groups over all T cycles from the
// all-zero bus, every warp of the block calling it (a warp without a group
// walks zeros). The rowzeros ballots of a batch of cycles are summed in
// shared memory over the block's warps of one stream, and their first warp
// adds the sums, one atomic a stream and cycle: the groups of a wide
// stream add into the same T counters, where an atomic a warp and cycle
// queued hundreds deep on each (392 groups of MobileNetV1's first
// depthwise batch). `b` is the warp's stream, `rz` its rowzeros.
template <int NSEG, typename Load>
__device__ __forceinline__ Walk<NSEG> walk_whole(const Load& load, int T,
                                                 bool live, bool valid,
                                                 int b,
                                                 int32_t* __restrict__ rz,
                                                 const Params& p) {
  __shared__ int zeros[2][kWalkWarps][kAhead];   // by batch parity
  __shared__ int stream[kWalkWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) stream[warp] = live ? b : -1;
  Walk<NSEG> wk;
  for (int u0 = 0, k = 0; u0 < T; u0 += kAhead, k ^= 1) {
    uint32_t buf[kAhead];
    load_ahead(load, u0, T, buf);
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      if (u0 + i >= T) break;   // the same for the whole block
      const bool z = valid && (buf[i] & kNotSign) == 0u;
      const unsigned zb = __ballot_sync(0xFFFFFFFFu, z);
      if (lane == 0) zeros[k][warp][i] = __popc(zb);
      wk.step(buf[i], z, p);
    }
    __syncthreads();   // the batch's counts are in
    const int me = stream[warp];
    if (lane < kAhead && u0 + lane < T && me >= 0 &&
        (warp == 0 || stream[warp - 1] != me)) {
      int n = 0;
      for (int w = warp; w < kWalkWarps && stream[w] == me; ++w)
        n += zeros[k][w][lane];
      if (n) atomicAdd(&rz[u0 + lane], n);
    }
  }
  return wk;
}

// The grouped counter walk of this warp's lane: `live` where the warp has
// a group of the batch (of stream `b`), `valid` where the lane is one of
// its stream's; `load(t)` as the note above summarize asks, `out` at the
// lane's first counter row (rows `stride` words apart), `rz` at its
// stream's rowzeros[T]; every warp of the block calls it with the same
// plan, whose split * cl is 1 exactly when ONE_PASS (an instantiation of
// its own, which carries none of the fold's registers).
template <int NSEG, bool ONE_PASS, typename Load>
__device__ __forceinline__ void walk_grouped(const Load& load, int T, int C,
                                             int split, int cl, bool live,
                                             bool valid, int b,
                                             int32_t* __restrict__ rz,
                                             int32_t* __restrict__ out,
                                             size_t stride, const Params& p,
                                             ScanShared<6>& sm) {
  if constexpr (ONE_PASS) {   // one chunk a group: counts stored
    const Walk<NSEG> wk = walk_whole<NSEG>(load, T, live, valid, b, rz, p);
    if (valid)
      wk.emit([&](int row, int v) {
        out[static_cast<size_t>(row) * stride] = v;
      }, p);
  } else {
    const int sub = (threadIdx.x / 32) % split;
    const int rank =
        cl > 1 ? static_cast<int>(
                     cooperative_groups::this_cluster().block_rank())
               : 0;
    const int c = rank * split + sub;
    const int t0 = min(T, c * C), t1 = min(T, t0 + C);
    const CounterScan<NSEG> scan{p};
    const ChunkStart st = chunk_start(
        scan, live ? summarize<NSEG>(load, t0, t1, valid, rz, p)
                   : chunk_identity(),
        split, cl, sm);
    if (live && valid && t0 < t1)
      walk_chunk<NSEG>(load, t0, t1, st, p)
          .emit([&](int row, int v) {
            atomicAdd(&out[static_cast<size_t>(row) * stride], v);
          }, p);
    if (cl > 1) cluster_wait();   // no block leaves while it may be read
  }
}

}  // namespace pc
