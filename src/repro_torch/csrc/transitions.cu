// Streaming bit-transition counter (K5) for Hopper (sm_90a). Built by
// repro_torch/kernels/_build.py with nvcc into a shared library with a
// plain C interface, loaded with ctypes.
//
// Replaces the TPU kernel
//   src/repro/kernels/transitions/kernel.py::transitions_pallas
// out[l] = sum_t popcount((x[t, l] ^ x[t - 1, l]) & mask), with x[-1, l] =
// init[l] (zeros when no init is given), over a [T, L] stream of 16-bit bus
// words held as uint16 or as int32 in 0..65535.
//
// Design: one thread per lane, so a warp's loads of one cycle are adjacent
// in memory, and a grid of lane tiles times T chunks. A thread walks its
// chunk of kChunkT cycles (more when T would need more than 65535 chunks),
// reading the word before the chunk as its first "previous" word, keeps a
// partial sum in a register and adds it to out[l] with one integer
// atomicAdd: integer adds give the same sum in any order, so the result
// does not change from run to run. The caller zeroes out. No padding: the
// TPU kernel pads T with copies of the last row and L with zeros only to
// fit its blocks, and those pads add no transitions.
//
// Bound on an H100: the pass reads each word once (2*T*L bytes as uint16)
// and writes 4*L bytes; XOR, AND and __popc are a few integer operations
// per word, so the bytes bound it, at 3.35 TB/s. At the sizes the
// quickstart and the ResNet50 weight streams give it (at most 4608 x 512
// words, 4.7 MB as uint16, 1.4 us) one launch is mostly launch latency.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunkT = 64;      // cycles per thread, at least
constexpr int kMaxGridY = 65535;

template <typename Word>
__global__ void __launch_bounds__(kThreads)
transitions_kernel(const Word* __restrict__ x,
                   const int32_t* __restrict__ init, int T, int L,
                   int chunk, uint32_t mask, int32_t* __restrict__ out) {
  const int l = blockIdx.x * kThreads + threadIdx.x;
  if (l >= L) return;
  const int t0 = blockIdx.y * chunk;
  const int t1 = min(T, t0 + chunk);
  uint32_t prev;
  if (t0 == 0)
    prev = init ? static_cast<uint32_t>(init[l]) : 0u;
  else
    prev = static_cast<uint32_t>(x[static_cast<size_t>(t0 - 1) * L + l]);
  int sum = 0;
#pragma unroll 8
  for (int t = t0; t < t1; ++t) {
    const uint32_t w = static_cast<uint32_t>(x[static_cast<size_t>(t) * L + l]);
    sum += __popc((w ^ prev) & mask);
    prev = w;
  }
  if (sum) atomicAdd(out + l, sum);
}

template <typename Word>
cudaError_t launch(const void* x, const int32_t* init, int T, int L,
                   uint32_t mask, int32_t* out, cudaStream_t stream) {
  int chunk = kChunkT;
  if ((T + chunk - 1) / chunk > kMaxGridY) chunk = (T + kMaxGridY - 1) / kMaxGridY;
  const dim3 grid((L + kThreads - 1) / kThreads, (T + chunk - 1) / chunk);
  transitions_kernel<Word><<<grid, kThreads, 0, stream>>>(
      static_cast<const Word*>(x), init, T, L, chunk, mask, out);
  return cudaGetLastError();
}

}  // namespace

// Adds the per-lane transition counts of x[T, L] (word_bytes 2: uint16
// words, 4: int32 words holding 0..65535) under mask (its low 16 bits)
// into out[L], which the caller zeroes. init[L] (int32 words, or null for
// an all-zero bus) is the bus state before cycle 0. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for
// arguments the kernel does not take).
extern "C" int tr_count_transitions(const void* x, int word_bytes,
                                    const int32_t* init, int T, int L,
                                    uint32_t mask, int32_t* out,
                                    void* stream) {
  if (T < 1 || L < 1 || (word_bytes != 2 && word_bytes != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  mask &= 0xFFFFu;
  return static_cast<int>(
      word_bytes == 2 ? launch<uint16_t>(x, init, T, L, mask, out, s)
                      : launch<int32_t>(x, init, T, L, mask, out, s));
}
