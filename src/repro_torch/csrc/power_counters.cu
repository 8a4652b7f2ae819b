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
// Design: one thread per lane walks T in order, so a warp's loads of one
// cycle are adjacent in memory. All state lives in registers: the
// previous word, the held register, the previous is-zero bit, one packed
// invert word per encoded stream (bit si = unique segment si, at most 31)
// and the per-row accumulators. Each step takes the segment distances with
// __popc; the invert rule is the reference's: a distance above w/2 toggles
// the line, below keeps it, exactly w/2 clears it. Within a segment the
// encoded bus toggles d bits when the line holds and w - d when it flips,
// so the encoded stream is never formed. rowzeros[t] is a warp ballot and
// one atomicAdd per warp and cycle (integer, so exact in any order). The
// kernel masks its ragged lane edge itself: no padding, no host-side
// correction.
//
// Bound on an H100: the pass reads each word once (2*T*L bytes as uint16,
// which the CNN main path hands it; int32 words are also taken) and writes
// 4*(n_rows*L + T) bytes. At the main path's sizes that is a few MB,
// microseconds at 3.35 TB/s, so what bounds this simple design is the latency of the T-long sequential walk
// per lane (a K = 4608 layer with 512 lanes runs only 16 warps). Loads are
// issued CHUNK cycles ahead to hide some of it. The later change that
// makes it fast splits T into chunks walked in parallel and combines them
// through the packed (f(0), f(1)) invert composition (the reference's
// _compose_packed) and a MAX over (cycle << 16 | word) for the held
// register.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxSegs = 31;
constexpr int kMaxVariants = 64;
constexpr int kWordBits = 16;
constexpr int kThreads = 128;
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

template <int NSEG>
struct BicState {
  uint32_t inv;      // packed invert lines
  int dsum[NSEG];    // sum over flips of (w - 2d): data-toggle correction
  int fsum[NSEG];    // invert-line toggles
};

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

template <int NSEG>
__device__ __forceinline__ int write_variants(int32_t* out, int row, int L,
                                              int base,
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
    out[static_cast<size_t>(row++) * L] = data;
    out[static_cast<size_t>(row++) * L] = inv;
  }
  return row;
}

template <typename Word, int NSEG>
__global__ void __launch_bounds__(kThreads)
counters_kernel(const Word* __restrict__ x, int T, int L, int n_rows,
                int32_t* __restrict__ counts, int32_t* __restrict__ rowzeros,
                const Params p) {
  const int b = blockIdx.y;
  const int l = blockIdx.x * kThreads + threadIdx.x;
  const bool valid = l < L;
  const int lane = threadIdx.x & 31;
  const Word* xb = x + static_cast<size_t>(b) * T * L;
  int32_t* rz = rowzeros + static_cast<size_t>(b) * T;

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
      buf[i] = (valid && t < T)
                   ? static_cast<uint32_t>(xb[static_cast<size_t>(t) * L + l])
                         & 0xFFFFu
                   : 0u;
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

  int32_t* out = counts + static_cast<size_t>(b) * n_rows * L + l;
  int row = 0;
  out[static_cast<size_t>(row++) * L] = raw;
  out[static_cast<size_t>(row++) * L] = mant;
  out[static_cast<size_t>(row++) * L] = zeros;
  if (p.zvg) {
    out[static_cast<size_t>(row++) * L] = hraw;
    out[static_cast<size_t>(row++) * L] = hmant;
    out[static_cast<size_t>(row++) * L] = iszero;
  }
  row = write_variants<NSEG>(out, row, L, raw, br, p);
  if (p.zvg) row = write_variants<NSEG>(out, row, L, hraw, bh, p);
  if (p.hist) {
#pragma unroll
    for (int bit = 0; bit < kWordBits; ++bit)
      out[static_cast<size_t>(row++) * L] = ones[bit];
  }
}

template <typename Word, int NSEG>
cudaError_t launch(const void* x, int B, int T, int L, int n_rows,
                   int32_t* counts, int32_t* rowzeros, const Params& p,
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
  const int want_rows = 3 + (zvg ? 3 : 0) + 2 * n_variants * (zvg ? 2 : 1) +
                        (hist ? kWordBits : 0);
  if (B < 1 || B > 65535 || T < 1 || L < 1 || n_segs < 0 ||
      n_segs > kMaxSegs || n_variants < 0 || n_variants > kMaxVariants ||
      (n_variants > 0) != (n_segs > 0) || n_rows != want_rows ||
      (word_bytes != 2 && word_bytes != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.n_segs = n_segs;
  p.n_variants = n_variants;
  p.zvg = zvg;
  p.hist = hist;
  for (int i = 0; i < n_segs; ++i) {
    p.seg_mask[i] = seg_masks[i] & 0xFFFFu;
    p.seg_width[i] = __builtin_popcount(p.seg_mask[i]);
  }
  for (int v = 0; v < n_variants; ++v) p.variant_segs[v] = variant_segs[v];
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (word_bytes == 2) {
    err = n_segs <= 4
              ? launch<uint16_t, 4>(x, B, T, L, n_rows, counts, rowzeros, p, s)
              : launch<uint16_t, kMaxSegs>(x, B, T, L, n_rows, counts,
                                           rowzeros, p, s);
  } else {
    err = n_segs <= 4
              ? launch<int32_t, 4>(x, B, T, L, n_rows, counts, rowzeros, p, s)
              : launch<int32_t, kMaxSegs>(x, B, T, L, n_rows, counts,
                                          rowzeros, p, s);
  }
  return static_cast<int>(err);
}
