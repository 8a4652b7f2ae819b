// Single-segment bus-invert encoder (K6) for Hopper (sm_90a). Built by
// repro_torch/kernels/_build.py with nvcc into a shared library with a
// plain C interface, loaded with ctypes.
//
// Replaces the TPU kernel
//   src/repro/kernels/bic_encode/kernel.py::bic_encode_pallas
// For a [T, L] stream of 16-bit bus words from a bus idling at 0, with one
// segment `mask` of width w = popcount(mask): the invert line of lane l at
// cycle t is
//   inv_t = inv_{t-1} ? (2 d_t < w) : (2 d_t > w),
//   d_t = popcount((x_t ^ x_{t-1}) & mask),  x_{-1} = 0,  inv_{-1} = 0,
// and the transmitted word is tx_t = inv_t ? x_t ^ mask : x_t. Inverting a
// segment flips all of its bits, so the distance of x_t to the previous
// TRANSMITTED word is d_t or w - d_t, and d_t needs only the raw stream:
// this is bit for bit the serial encoder of repro_torch.core.bic (ties,
// 2 d_t == w, keep the data). tx keeps the input's word type (uint16, or
// int32 in 0..65535); inv is one byte per word (a torch.bool tensor).
//
// Design: the recurrence is one segment's invert line of the counter walk,
// so its step is pc::bic_fn (f0 = 2d > w, f1 = 2d < w, ties keep the data)
// and a run of cycles composes to one packed (f(0), f(1)) pair, bit 0 --
// the TPU kernel's associative scan. The T cycles of each 32-lane group
// are cut into chunks as the counter walk's plan cuts them (split warps of
// a block in each of a cluster's cl blocks, kernels/bic_encode/kernel.py::
// bic_plan):
//   pass 1: each warp composes its chunk's step functions;
//   combine: pc::chunk_start folds the chunks before each one in cycle
//     order, within the block and across the cluster through distributed
//     shared memory (two bits a lane);
//   pass 2: each warp re-walks its chunk from that invert state and writes
//     tx and inv; a warp's loads and stores of one cycle are adjacent.
// A group of one chunk walks in one pass. Loads are branch-free (a lane
// past L reads lane L - 1, a cycle past the chunk repeats its last), and
// a whole chunk of up to 40 cycles is loaded at once in pass 1 and kept
// in registers for pass 2: a step is a popcount and a select, so what a
// pass waits for is its loads.
//
// Bound on an H100: each word is read once (2 bytes as uint16) and written
// twice (2 bytes of tx, 1 byte of inv): 5*T*L bytes at 3.35 TB/s; the
// integer work per word is a few operations. What a launch costs instead is
// its longest chain: two passes over a chunk (one batch of loads a memory
// latency) and the fold's barriers.

#include <cstdint>
#include <cuda_runtime.h>

#include "power_counters.cuh"

namespace {

constexpr int kThreads = pc::kWalkWarps * 32;

// S: the cycles whose loads are in flight at once. Pass 1 stages its
// chunk's words in registers when they fit (chunk <= S), and pass 2 then
// reads nothing from memory again.
template <typename Word, int S>
__global__ void __launch_bounds__(kThreads)
bic_encode_kernel(const Word* __restrict__ x, int T, int L, int groups,
                  uint32_t mask, int chunk, int split, int cl,
                  Word* __restrict__ tx, uint8_t* __restrict__ inv) {
  __shared__ pc::ScanShared<2> sm;
  pc::Params p{};
  p.n_segs = 1;
  p.seg_mask[0] = mask;
  p.seg_width[0] = __popc(mask);
  const int warp = threadIdx.x / 32;
  const int item = blockIdx.x / cl * (pc::kWalkWarps / split) + warp / split;
  const bool live = item < groups;
  const int lane = item * 32 + threadIdx.x % 32;
  const bool valid = live && lane < L;
  const int col = min(lane, L - 1);
  const auto load = [&](int t) {
    return static_cast<uint32_t>(x[static_cast<size_t>(t) * L + col]);
  };
  const int rank = cl > 1 ? static_cast<int>(
                                cooperative_groups::this_cluster().block_rank())
                          : 0;
  const int c = rank * split + warp % split;
  const int t0 = min(T, c * chunk), t1 = min(T, t0 + chunk);
  uint32_t prev = t0 > 0 ? load(t0 - 1) & 0xFFFFu : 0u;
  uint32_t state = 0u;
  uint32_t w[S];
  const bool two = split * cl > 1;   // a group of several chunks
  if (two) {   // pass 1, and the fold
    pc::Fn f = pc::fn_identity();
    if (live) {
      uint32_t q = prev;
      for (int s0 = t0; s0 < t1; s0 += S) {
        pc::load_ahead(load, s0, t1, w);
#pragma unroll
        for (int i = 0; i < S; ++i) {
          if (s0 + i >= t1) break;   // the same for the whole warp
          f = pc::fn_then(f, pc::bic_fn<1>(w[i] ^ q, p));
          q = w[i];
        }
      }
    }
    state = pc::chunk_start(pc::InvertScan{}, f, split, cl, sm);
  }
  if (valid) {   // pass 2
    const bool staged = two && t1 - t0 <= S;
    for (int s0 = t0; s0 < t1; s0 += S) {
      if (!staged) pc::load_ahead(load, s0, t1, w);
#pragma unroll
      for (int i = 0; i < S; ++i) {
        if (s0 + i >= t1) break;
        state = pc::fn_apply(pc::bic_fn<1>(w[i] ^ prev, p), state) & 1u;
        const size_t o = static_cast<size_t>(s0 + i) * L + lane;
        tx[o] = static_cast<Word>(state ? w[i] ^ mask : w[i]);
        inv[o] = static_cast<uint8_t>(state);
        prev = w[i];
      }
    }
  }
  if (cl > 1) pc::cluster_wait();   // no block leaves while it may be read
}

// chunks of up to 8 cycles stage 8 words, longer ones up to 40 (ResNet50's
// longest chunk is 36 cycles), in segments of 40 past that
template <typename Word>
cudaError_t launch(const void* x, int T, int L, uint32_t mask, int chunk,
                   int split, int cl, void* tx, uint8_t* inv,
                   cudaStream_t stream) {
  const int groups = (L + 31) / 32;
  const int per_block = pc::kWalkWarps / split;
  const unsigned blocks = (groups + per_block - 1) / per_block * cl;
  const auto kernel = chunk <= 8 ? bic_encode_kernel<Word, 8>
                                 : bic_encode_kernel<Word, 40>;
  return pc::launch_walk(kernel, blocks, cl, stream,
                         static_cast<const Word*>(x), T, L, groups, mask,
                         chunk, split, cl, static_cast<Word*>(tx), inv);
}

}  // namespace

// Encodes x[T, L] (word_bytes 2: uint16 words, 4: int32 words holding
// 0..65535) with bus-invert coding on the segment mask (1..0xFFFF) into
// tx[T, L] of the same word type and inv[T, L] (one byte each, 0 or 1), on
// the plan (chunk, split, cl) of bic_plan: split in 1, 2, 4, 8, cl in
// 1..16 (with split 8 past 1), split * cl * chunk >= T. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for arguments
// the kernel does not take).
extern "C" int be_bic_encode(const void* x, int word_bytes, int T, int L,
                             uint32_t mask, int chunk, int split, int cl,
                             void* tx, uint8_t* inv, void* stream) {
  if (T < 1 || L < 1 || mask == 0u || mask > 0xFFFFu ||
      (word_bytes != 2 && word_bytes != 4) ||
      (split != 1 && split != 2 && split != 4 && split != 8) || cl < 1 ||
      cl > pc::kMaxCluster || (cl > 1 && split != pc::kWalkWarps) ||
      chunk < 1 ||
      static_cast<int64_t>(split) * cl * chunk < T ||
      static_cast<int64_t>(L + 31) / 32 * cl > 0x7FFFFFFF)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      word_bytes == 2
          ? launch<uint16_t>(x, T, L, mask, chunk, split, cl, tx, inv, s)
          : launch<int32_t>(x, T, L, mask, chunk, split, cl, tx, inv, s));
}
