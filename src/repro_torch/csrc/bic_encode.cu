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
// Design: one thread per lane walks T in order with the invert state in a
// register, loading kAhead cycles' words before it steps through them so
// that several loads are in flight; a warp's loads and stores of one cycle
// are adjacent in memory. The TPU kernel instead composes the step
// functions (f(0), f(1)) with an associative scan inside each T block and
// carries the state across blocks. That chunked form, which lets blocks
// walk chunks of T in parallel and combine them in a second pass, is the
// later change that makes this kernel fast.
//
// Bound on an H100: each word is read once (2 bytes as uint16) and written
// twice (2 bytes of tx, 1 byte of inv): 5*T*L bytes at 3.35 TB/s; the
// integer work per word is a few operations. This simple design is bound
// by the latency of the T-long serial walk per lane instead (a ResNet50
// weight stream of T = 4608 cycles over 512 lanes runs 16 warps).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kAhead = 8;        // cycles loaded before they are encoded

template <typename Word>
__global__ void __launch_bounds__(kThreads)
bic_encode_kernel(const Word* __restrict__ x, int T, int L, uint32_t mask,
                  int width, Word* __restrict__ tx,
                  uint8_t* __restrict__ inv) {
  const int l = blockIdx.x * kThreads + threadIdx.x;
  if (l >= L) return;
  uint32_t prev = 0u;
  bool state = false;
  for (int t0 = 0; t0 < T; t0 += kAhead) {
    uint32_t w[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i)
      w[i] = t0 + i < T
                 ? static_cast<uint32_t>(x[static_cast<size_t>(t0 + i) * L + l])
                 : 0u;
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      if (t0 + i >= T) break;
      const int d2 = 2 * __popc((w[i] ^ prev) & mask);
      state = state ? d2 < width : d2 > width;
      const size_t o = static_cast<size_t>(t0 + i) * L + l;
      tx[o] = static_cast<Word>(state ? w[i] ^ mask : w[i]);
      inv[o] = state ? 1 : 0;
      prev = w[i];
    }
  }
}

template <typename Word>
cudaError_t launch(const void* x, int T, int L, uint32_t mask, void* tx,
                   uint8_t* inv, cudaStream_t stream) {
  const int grid = (L + kThreads - 1) / kThreads;
  bic_encode_kernel<Word><<<grid, kThreads, 0, stream>>>(
      static_cast<const Word*>(x), T, L, mask, __builtin_popcount(mask),
      static_cast<Word*>(tx), inv);
  return cudaGetLastError();
}

}  // namespace

// Encodes x[T, L] (word_bytes 2: uint16 words, 4: int32 words holding
// 0..65535) with bus-invert coding on the segment mask (1..0xFFFF) into
// tx[T, L] of the same word type and inv[T, L] (one byte each, 0 or 1).
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// arguments the kernel does not take).
extern "C" int be_bic_encode(const void* x, int word_bytes, int T, int L,
                             uint32_t mask, void* tx, uint8_t* inv,
                             void* stream) {
  if (T < 1 || L < 1 || mask == 0u || mask > 0xFFFFu ||
      (word_bytes != 2 && word_bytes != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      word_bytes == 2 ? launch<uint16_t>(x, T, L, mask, tx, inv, s)
                      : launch<int32_t>(x, T, L, mask, tx, inv, s));
}
