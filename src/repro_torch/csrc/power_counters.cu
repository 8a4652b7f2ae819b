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
// rowzeros[T]. A batch [B, T, L] runs in one launch (blockIdx.y = b).
//
// Design: one thread per lane walks T in order (pc::walk_lane in
// power_counters.cuh, shared with the fused decode kernel of
// zvg_matmul.cu), so a warp's loads of one cycle are adjacent in memory.
// All state lives in registers: the previous word, the held register, the
// previous is-zero bit, one packed invert word per encoded stream (bit si =
// unique segment si, at most 31) and the per-row accumulators. Each step
// takes the segment distances with __popc. The kernel masks its ragged
// lane edge itself: no padding, no host-side correction.
//
// Bound on an H100: the pass reads each word once (2*T*L bytes as uint16,
// which the CNN main path hands it; int32 words are also taken) and writes
// 4*(n_rows*L + T) bytes. At the main path's sizes that is a few MB,
// microseconds at 3.35 TB/s, so what bounds this simple design is the
// latency of the T-long sequential walk per lane (a K = 4608 layer with
// 512 lanes runs only 16 warps). Loads are
// issued pc::kChunk cycles ahead to hide some of it. The later change that
// makes it fast splits T into chunks walked in parallel and combines them
// through the packed (f(0), f(1)) invert composition (the reference's
// _compose_packed) and a MAX over (cycle << 16 | word) for the held
// register.

#include <cstdint>
#include <cuda_runtime.h>

#include "power_counters.cuh"

namespace {

constexpr int kThreads = 128;

template <typename Word, int NSEG>
__global__ void __launch_bounds__(kThreads)
counters_kernel(const Word* __restrict__ x, int T, int L, int n_rows,
                int32_t* __restrict__ counts, int32_t* __restrict__ rowzeros,
                const pc::Params p) {
  const int b = blockIdx.y;
  const int l = blockIdx.x * kThreads + threadIdx.x;
  const Word* xb = x + static_cast<size_t>(b) * T * L;
  const auto load = [&](int t) {
    return static_cast<uint32_t>(xb[static_cast<size_t>(t) * L + l]);
  };
  pc::walk_lane<NSEG>(load, T, l < L, rowzeros + static_cast<size_t>(b) * T,
                      counts + static_cast<size_t>(b) * n_rows * L + l, L, p);
}

template <typename Word, int NSEG>
cudaError_t launch(const void* x, int B, int T, int L, int n_rows,
                   int32_t* counts, int32_t* rowzeros, const pc::Params& p,
                   cudaStream_t stream) {
  const dim3 grid((L + kThreads - 1) / kThreads, B);
  counters_kernel<Word, NSEG><<<grid, kThreads, 0, stream>>>(
      static_cast<const Word*>(x), T, L, n_rows, counts, rowzeros, p);
  return cudaGetLastError();
}

}  // namespace

// Counts one batch of edge streams x[B, T, L] (word_bytes 2: uint16 words,
// 4: int32 words holding 0..65535) into counts[B, n_rows, L] and
// rowzeros[B, T]; rowzeros must be zeroed by the caller. seg_masks[n_segs]
// are the spec's unique segments, variant_segs[n_variants] one bitmask of
// segment indices per BIC variant. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int pc_fused_counters(const void* x, int word_bytes, int B, int T,
                                 int L, int32_t* counts, int32_t* rowzeros,
                                 int n_rows, int n_segs,
                                 const uint32_t* seg_masks, int n_variants,
                                 const uint32_t* variant_segs, int zvg,
                                 int hist, void* stream) {
  pc::Params p;
  if (B < 1 || B > 65535 || T < 1 || L < 1 ||
      (word_bytes != 2 && word_bytes != 4) ||
      !pc::make_params(p, n_rows, n_segs, seg_masks, n_variants,
                       variant_segs, zvg, hist))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (word_bytes == 2) {
    err = n_segs <= 4
              ? launch<uint16_t, 4>(x, B, T, L, n_rows, counts, rowzeros, p, s)
              : launch<uint16_t, pc::kMaxSegs>(x, B, T, L, n_rows, counts,
                                               rowzeros, p, s);
  } else {
    err = n_segs <= 4
              ? launch<int32_t, 4>(x, B, T, L, n_rows, counts, rowzeros, p, s)
              : launch<int32_t, pc::kMaxSegs>(x, B, T, L, n_rows, counts,
                                              rowzeros, p, s);
  }
  return static_cast<int>(err);
}
