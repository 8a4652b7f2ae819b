// Device code shared by every kernel that walks a systolic-array edge
// stream: the per-lane walk of the fused power-counter pass (the held
// register, the BIC invert recurrences, the ones histograms) and the
// host-side checks of its arguments. power_counters.cu (the counter pass
// alone) and zvg_matmul.cu (the decode matmul fused with its counters)
// both include it, so the counter arithmetic is one piece of code.
//
// A walk runs one thread per lane over T cycles from an all-zero bus and
// writes, per lane, every row of CounterSpec.rows in order; the per-cycle
// zero words of the lanes are summed into rowzeros[t] by a warp ballot and
// one atomicAdd per warp and cycle (integer, so exact in any order). All
// threads of a warp must walk the same T, so that the ballots line up; a
// thread whose lane is not `valid` walks with its warp, votes "non-zero"
// and writes nothing.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
// core/bits.to_bits).
__device__ __forceinline__ uint32_t bf16_word(float x) {
  const uint32_t u = __float_as_uint(x);
  if ((u & 0x7FFFFFFFu) > 0x7F800000u) return 0x7FC0u | ((u >> 16) & 0x8000u);
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
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

}  // namespace pc
