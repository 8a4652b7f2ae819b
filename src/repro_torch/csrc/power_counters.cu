// Fused power-counter pass over one systolic-array edge stream, for
// Hopper (sm_90a). Built by repro_torch/kernels/_build.py with nvcc into a
// shared library with a plain C interface, loaded with ctypes.
//
// Replaces the TPU kernel
//   src/repro/kernels/power_counters/kernel.py::fused_counters_pallas
// (and computes what it computes, not a block-by-block copy): one walk
// over a [T, L] stream of 16-bit bus words from an all-zero bus emits,
// per lane, every counter row of CounterSpec.rows (raw and mantissa
// toggles, zero words, zero-held register toggles and is-zero line
// toggles, BIC data and invert toggles per variant over the raw and the
// held stream, optional ones histograms), plus the per-cycle zero counts
// rowzeros[T]. A batch [B, T, L] runs in one launch.
//
// Design: the grouped walk of power_counters.cuh (pc::walk_grouped) over
// every 32-lane group of every stream of the batch, as the plan
// (kernels/power_counters/kernel.py::counter_plan) lays it out: a group's
// T cycles are cut into split * cl chunks walked by `split` warps of a
// block in each of a cluster's `cl` blocks, their summaries (the composed
// packed (f(0), f(1)) invert step functions, the reference's
// _compose_packed, and the first and last live word for the held
// register) folded in cycle order and each chunk re-walked from its start
// state; a group of one chunk (short streams, or enough groups to fill
// the card) is walked in one pass. The group index runs over the batch
// and the lanes together (blockIdx.x / cl), so a block may hold groups of
// several streams. Loads are branch-free (a lane past L reads lane L - 1
// and keeps 0), so kAhead cycles' loads are in flight at once. The kernel
// masks its ragged lane edge itself: no padding, no host-side correction.
//
// Bound on an H100: the pass reads each word once (2*T*L bytes as uint16,
// which the CNN main path hands it; int32 words are also taken) and writes
// 4*(n_rows*L + T) bytes: microseconds at 3.35 TB/s for the main path's
// streams. What a launch costs instead is its longest chain: two passes
// over a chunk (~0.2 us a cycle, one batch of loads a memory latency) and
// the fold's barriers, or one pass over T for a group of one chunk.

#include <cstdint>
#include <cuda_runtime.h>

#include "power_counters.cuh"

namespace {

constexpr int kThreads = pc::kWalkWarps * 32;

template <typename Word, int NSEG, bool ONE_PASS>
__global__ void __launch_bounds__(kThreads)
counters_kernel(const Word* __restrict__ x, int B, int T, int L, int groups,
                int n_rows, int chunk, int split, int cl,
                int32_t* __restrict__ counts, int32_t* __restrict__ rowzeros,
                const pc::Params p) {
  __shared__ pc::ScanShared<6> sm;
  // B * groups < 2^31, checked by the entry
  const int item = static_cast<int>(blockIdx.x / cl) *
                       (pc::kWalkWarps / split) +
                   static_cast<int>(threadIdx.x / 32) / split;
  const bool live = item < B * groups;
  const int b = live ? item / groups : 0;
  const int lane = (item - b * groups) * 32 + threadIdx.x % 32;
  const bool valid = live && lane < L;
  const int col = min(lane, L - 1);
  const Word* xb = x + static_cast<size_t>(b) * T * L + col;
  const auto load = [&](int t) {
    const uint32_t w = static_cast<uint32_t>(xb[static_cast<size_t>(t) * L]);
    return valid ? w : 0u;
  };
  pc::walk_grouped<NSEG, ONE_PASS>(
      load, T, chunk, split, cl, live, valid, b,
      rowzeros + static_cast<size_t>(b) * T,
      counts + static_cast<size_t>(b) * n_rows * L + col, L, p, sm);
}

template <typename Word, int NSEG>
cudaError_t launch(const void* x, int B, int T, int L, int n_rows, int chunk,
                   int split, int cl, int32_t* counts, int32_t* rowzeros,
                   const pc::Params& p, cudaStream_t stream) {
  const int groups = (L + 31) / 32;
  const int per_block = pc::kWalkWarps / split;
  const unsigned blocks = static_cast<unsigned>(
      (static_cast<int64_t>(B) * groups + per_block - 1) / per_block * cl);
  const auto kernel = split * cl == 1 ? counters_kernel<Word, NSEG, true>
                                      : counters_kernel<Word, NSEG, false>;
  return pc::launch_walk(kernel, blocks, cl, stream,
                         static_cast<const Word*>(x), B, T, L, groups, n_rows,
                         chunk, split, cl, counts, rowzeros, p);
}

}  // namespace

// Counts one batch of edge streams x[B, T, L] (word_bytes 2: uint16 words,
// 4: int32 words holding 0..65535) into counts[B, n_rows, L] and
// rowzeros[B, T] on the plan (chunk, split, cl) of counter_plan: split in
// 1, 2, 4, 8, cl in 1..16 (with split 8 past 1), split * cl * chunk >= T.
// rowzeros must be zeroed by the caller, and counts too where split * cl
// > 1 (they are summed into). seg_masks[n_segs] are the spec's unique
// segments, variant_segs[n_variants] one bitmask of segment indices per
// BIC variant. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int pc_fused_counters(const void* x, int word_bytes, int B, int T,
                                 int L, int chunk, int split, int cl,
                                 int32_t* counts, int32_t* rowzeros,
                                 int n_rows, int n_segs,
                                 const uint32_t* seg_masks, int n_variants,
                                 const uint32_t* variant_segs, int zvg,
                                 int hist, void* stream) {
  pc::Params p;
  if (B < 1 || B > 65535 || T < 1 || L < 1 ||
      (word_bytes != 2 && word_bytes != 4) ||
      (split != 1 && split != 2 && split != 4 && split != 8) || cl < 1 ||
      cl > pc::kMaxCluster || (cl > 1 && split != pc::kWalkWarps) ||
      chunk < 1 || static_cast<int64_t>(split) * cl * chunk < T ||
      static_cast<int64_t>(B) * ((L + 31) / 32) * cl > 0x7FFFFFFF ||
      !pc::make_params(p, n_rows, n_segs, seg_masks, n_variants,
                       variant_segs, zvg, hist))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (word_bytes == 2) {
    err = n_segs <= 4
              ? launch<uint16_t, 4>(x, B, T, L, n_rows, chunk, split, cl,
                                    counts, rowzeros, p, s)
              : launch<uint16_t, pc::kMaxSegs>(x, B, T, L, n_rows, chunk,
                                               split, cl, counts, rowzeros,
                                               p, s);
  } else {
    err = n_segs <= 4
              ? launch<int32_t, 4>(x, B, T, L, n_rows, chunk, split, cl,
                                   counts, rowzeros, p, s)
              : launch<int32_t, pc::kMaxSegs>(x, B, T, L, n_rows, chunk,
                                              split, cl, counts, rowzeros, p,
                                              s);
  }
  return static_cast<int>(err);
}
