// Device code shared by every kernel that walks a systolic-array edge
// stream: the walk of the fused power-counter pass (the held register,
// the BIC invert recurrences, the ones histograms) and the host-side
// checks of its arguments. power_counters.cu (K1, the counter pass alone)
// and zvg_matmul.cu (K3, the decode matmul fused with its counters) both
// include it, so the counter arithmetic is one piece of code; both
// replace walks of the TPU kernel
//   src/repro/kernels/power_counters/kernel.py::fused_counters_pallas
// (K3 through src/repro/kernels/zvg_matmul/fused.py::fused_matmul_counters).
//
// What bounds a walk on an H100 is its bytes (each 16-bit word read once,
// the counters written once: microseconds at 3.35 TB/s), but a walk of T
// cycles in one thread is a dependent chain of T steps. Two walks live
// here:
//   * walk_lane (K1): one thread per lane over T cycles from an all-zero
//     bus, writing per lane every row of CounterSpec.rows in order; the
//     per-cycle zero words of the lanes are summed into rowzeros[t] by a
//     warp ballot and one atomicAdd per warp and cycle (integer, so exact
//     in any order). All threads of a warp walk the same T, so that the
//     ballots line up; a thread whose lane is not `valid` walks with its
//     warp, votes "non-zero" and writes nothing. At ~430 ns a cycle its
//     chain was all of K3's 0.44 ms and is most of K1's time.
//   * walk_chunked (K3, and K1's redesign next): the chain cut into
//     chunks walked in parallel, see its section below.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cooperative_groups.h>

namespace pc {

constexpr int kMaxSegs = 31;
constexpr int kMaxVariants = 64;
constexpr int kWordBits = 16;
constexpr int kChunk = 8;
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

// A lane's walk state and counts, for the chunked walk: the previous word,
// the held register, the previous is-zero bit, the invert lines of both
// encoded streams and every row's running sum. step() takes one cycle, as
// walk_lane's loop body does; emit() hands each row of CounterSpec.rows,
// in order, to sink(row, value). (walk_lane keeps its own copy of the
// step: K1 built on this struct measured 1.35% slower on an H100, and K1's
// own redesign onto the chunked walk comes next.)
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

template <int NSEG>
__device__ __forceinline__ int write_variants(int32_t* out, int row,
                                              size_t stride, int base,
                                              const BicState<NSEG>& s,
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
    out[static_cast<size_t>(row++) * stride] = data;
    out[static_cast<size_t>(row++) * stride] = inv;
  }
  return row;
}

// The per-lane walk. `load(t)` returns the lane's word at cycle t (called
// only for a valid lane); `out` points at the lane's first counter row,
// the rows `stride` words apart; `rz` at the stream's rowzeros[T]. Loads
// are issued kChunk cycles ahead of their use.
template <int NSEG, typename Load>
__device__ __forceinline__ void walk_lane(const Load& load, int T, bool valid,
                                          int32_t* __restrict__ rz,
                                          int32_t* __restrict__ out,
                                          size_t stride, const Params& p) {
  const int lane = threadIdx.x & 31;
  uint32_t prev = 0u, held = 0u;
  bool prev_z = false;
  int raw = 0, mant = 0, zeros = 0, hraw = 0, hmant = 0, iszero = 0;
  int ones[kWordBits];
#pragma unroll
  for (int i = 0; i < kWordBits; ++i) ones[i] = 0;
  BicState<NSEG> br{}, bh{};

  for (int t0 = 0; t0 < T; t0 += kChunk) {
    uint32_t buf[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const int t = t0 + i;
      buf[i] = (valid && t < T) ? (load(t) & 0xFFFFu) : 0u;
    }
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const int t = t0 + i;
      if (t >= T) break;  // the same t for every thread: no divergence
      const uint32_t w = buf[i];
      const bool z = valid && (w & kNotSign) == 0u;
      const unsigned zb = __ballot_sync(0xFFFFFFFFu, z);
      if (lane == 0 && zb) atomicAdd(&rz[t], __popc(zb));

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
  }
  if (!valid) return;

  int row = 0;
  out[static_cast<size_t>(row++) * stride] = raw;
  out[static_cast<size_t>(row++) * stride] = mant;
  out[static_cast<size_t>(row++) * stride] = zeros;
  if (p.zvg) {
    out[static_cast<size_t>(row++) * stride] = hraw;
    out[static_cast<size_t>(row++) * stride] = hmant;
    out[static_cast<size_t>(row++) * stride] = iszero;
  }
  row = write_variants<NSEG>(out, row, stride, raw, br, p);
  if (p.zvg) row = write_variants<NSEG>(out, row, stride, hraw, bh, p);
  if (p.hist) {
#pragma unroll
    for (int bit = 0; bit < kWordBits; ++bit)
      out[static_cast<size_t>(row++) * stride] = ones[bit];
  }
}


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
//     every row as walk_lane does; the counts are integers, summed in
//     shared memory and then across the cluster, so exact in any order.
constexpr int kWalkWarps = 8;   // chunks a block, one warp each
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

// The words of cycles u0 .. u0 + kAhead - 1 (those past t1 repeat t1 - 1's).
template <typename Load>
__device__ __forceinline__ void load_ahead(const Load& load, int u0, int t1,
                                           uint32_t (&buf)[kAhead]) {
#pragma unroll
  for (int i = 0; i < kAhead; ++i)
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
// `load`, `rz`, `out` and `stride` as walk_lane takes them; rz is summed
// into with atomics (zeroed by the caller), out written by the cluster's
// first block; `load` as the note above summarize asks.
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

}  // namespace pc
