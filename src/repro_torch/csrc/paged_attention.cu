// The paged decode attention of the serving path, for Hopper (sm_90a).
// Built by repro_torch/kernels/_build.py with nvcc into a shared library
// with a plain C interface, loaded with ctypes.
//
// K4, pa_paged_decode_attention, replaces the TPU kernel
//   src/repro/kernels/zvg_matmul/fused.py::fused_paged_attention
// For every request row b and query head h = g * rep + r (g the KV head,
// rep = H / KV query heads per KV head):
//   out[b, 0, h, :] = softmax_j(cap(scale * q[b, 0, h, :] . K_j)) @ V_j
// over the row's logical positions j < lengths[b], where position j lives
// at (page = pages[b, j / PS], offset j % PS) of the pools
// k_pool, v_pool [P, PS, KV, HD], and cap(s) = tanh(s / softcap) * softcap
// when softcap > 0. q, the pools and the output share one dtype (float32 or
// bfloat16); scores, the softmax and the P.V sums are float32, and the
// output is rounded once. The kernel only reads pages: rows that share
// prefix pages, and dead rows whose tables are all the trash page 0, are
// both safe.
//
// The TPU kernel gathers every row's pages into a dense [B, MP * PS] view
// inside one gridless call and runs the dense attention on it, reading
// the whole table width. Here one block of kWarps warps owns one
// (row, KV head) pair and walks only the positions below the row's length
// in tiles of 32: lane j of a warp takes position 32 t + j, reads its K
// row once and scores it against the rep query heads of the group (held
// in shared memory), and the warp keeps an online softmax per head (the
// running max and sum in registers); each lane then accumulates the
// HD / 32 output dims it owns from the tile's V rows, read whole rows at
// a time across the warp. The warps split the tiles and meet at the end
// in shared memory, in a fixed order, so a result does not change from
// run to run. The plain version rounds the scores and the probabilities
// to q's dtype before they meet V; this kernel does not, so the two agree
// to a tolerance, not bit for bit (stated in chip_smoke.py).
//
// Bound on an H100: each K and V element below the length is read once,
// Σ_b length_b * KV * HD * 2 words, plus q, the output and the tables,
// at 3.35 TB/s; about 4 operations per byte, far below the tensor cores'
// line. At serving shapes (8 rows, lengths near 200, KV 16, HD 64, bf16)
// that is about 1.5 us a launch. A block per (row, KV head) runs only
// B * KV blocks of 4 warps, and the K rows are read one row per lane:
// split-KV across blocks, TMA page loads and wgmma are left to the change
// that makes it fast.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xFFFFFFFFu;

enum Dtype { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Eight consecutive words from a 16-byte aligned address, as floats.
__device__ __forceinline__ void load8(const float* __restrict__ p,
                                      float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* __restrict__ p,
                                      float (&v)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(words[i] << 16);
    v[2 * i + 1] = __uint_as_float(words[i] & 0xFFFF0000u);
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// EPL: output dims per lane (HD <= 32 * EPL); MAXREP: query heads per KV
// head the instantiation holds (rep <= MAXREP).
template <typename T, int EPL, int MAXREP>
__global__ void __launch_bounds__(kThreads)
    paged_decode_attention_kernel(const T* __restrict__ q,
                                  const T* __restrict__ k_pool,
                                  const T* __restrict__ v_pool,
                                  const int32_t* __restrict__ pages,
                                  const int32_t* __restrict__ lengths,
                                  T* __restrict__ out, int H, int KV, int HD,
                                  int PS, int MP, float scale, float softcap) {
  constexpr int D = 32 * EPL;
  __shared__ float s_q[MAXREP][D];
  __shared__ float s_m[kWarps][MAXREP];
  __shared__ float s_l[kWarps][MAXREP];
  __shared__ float s_acc[kWarps][MAXREP][D];

  const int g = blockIdx.x, b = blockIdx.y;
  const int rep = H / KV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* q_row = q + (static_cast<size_t>(b) * H + g * rep) * HD;
  for (int i = threadIdx.x; i < rep * HD; i += kThreads)
    s_q[i / HD][i % HD] = to_f(q_row[i]);
  __syncthreads();

  const int len = min(max(lengths[b], 0), MP * PS);
  const int32_t* table = pages + static_cast<size_t>(b) * MP;
  const size_t pos_stride = static_cast<size_t>(KV) * HD;

  float m[MAXREP], l[MAXREP], acc[MAXREP][EPL];
#pragma unroll
  for (int r = 0; r < MAXREP; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < EPL; ++i) acc[r][i] = 0.f;
  }

  const int n_tiles = (len + 31) / 32;
  for (int t = warp; t < n_tiles; t += kWarps) {
    const int pos = t * 32 + lane;
    const bool valid = pos < len;
    long long row = 0;  // element offset of (page, offset, g, 0)
    if (valid)
      row = (static_cast<long long>(table[pos / PS]) * PS + pos % PS) *
                static_cast<long long>(pos_stride) +
            static_cast<long long>(g) * HD;
    float s[MAXREP];
#pragma unroll
    for (int r = 0; r < MAXREP; ++r) s[r] = 0.f;
    if (valid) {
      const T* k_row = k_pool + row;
      for (int d0 = 0; d0 < HD; d0 += 8) {
        float k8[8];
        load8(k_row + d0, k8);
#pragma unroll
        for (int r = 0; r < MAXREP; ++r) {
          if (r < rep) {
#pragma unroll
            for (int c = 0; c < 8; ++c) s[r] = fmaf(s_q[r][d0 + c], k8[c], s[r]);
          }
        }
      }
    }
    float p[MAXREP];
#pragma unroll
    for (int r = 0; r < MAXREP; ++r) {
      p[r] = 0.f;
      if (r >= rep) continue;
      float x = s[r] * scale;
      if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
      x = valid ? x : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(x));  // lane 0 is valid
      p[r] = valid ? expf(x - m_new) : 0.f;
      const float corr = expf(m[r] - m_new);         // 0 on the first tile
      l[r] = l[r] * corr + warp_sum(p[r]);
#pragma unroll
      for (int i = 0; i < EPL; ++i) acc[r][i] *= corr;
      m[r] = m_new;
    }
    const int n_valid = min(32, len - t * 32);
    for (int j = 0; j < n_valid; ++j) {
      const T* v_row = v_pool + __shfl_sync(kFull, row, j);
      float v[EPL];
#pragma unroll
      for (int i = 0; i < EPL; ++i) {
        const int d = lane + 32 * i;
        v[i] = d < HD ? to_f(v_row[d]) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < MAXREP; ++r) {
        if (r >= rep) continue;
        const float pj = __shfl_sync(kFull, p[r], j);
#pragma unroll
        for (int i = 0; i < EPL; ++i) acc[r][i] = fmaf(pj, v[i], acc[r][i]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < MAXREP; ++r) {
    if (r >= rep) continue;
    if (lane == 0) {
      s_m[warp][r] = m[r];
      s_l[warp][r] = l[r];
    }
#pragma unroll
    for (int i = 0; i < EPL; ++i) s_acc[warp][r][lane + 32 * i] = acc[r][i];
  }
  __syncthreads();

  T* out_row = out + (static_cast<size_t>(b) * H + g * rep) * HD;
  for (int i = threadIdx.x; i < rep * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w][r]);
    float sum = 0.f, o = 0.f;
    if (mx > -INFINITY) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float f = expf(s_m[w][r] - mx);   // 0 for a warp with no tile
        sum = fmaf(s_l[w][r], f, sum);
        o = fmaf(s_acc[w][r][d], f, o);
      }
      o /= sum;
    }
    store(out_row + i, o);
  }
}

template <typename T, int EPL, int MAXREP>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   void* out, const int32_t* pages, const int32_t* lengths,
                   int B, int H, int KV, int HD, int PS, int MP, float scale,
                   float softcap, cudaStream_t stream) {
  paged_decode_attention_kernel<T, EPL, MAXREP>
      <<<dim3(KV, B), kThreads, 0, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k_pool),
          static_cast<const T*>(v_pool), pages, lengths, static_cast<T*>(out),
          H, KV, HD, PS, MP, scale, softcap);
  return cudaGetLastError();
}

template <typename T, int EPL>
cudaError_t by_rep(int rep, const void* q, const void* k, const void* v,
                   void* out, const int32_t* pages, const int32_t* lengths,
                   int B, int H, int KV, int HD, int PS, int MP, float scale,
                   float softcap, cudaStream_t st) {
  if (rep <= 1)
    return launch<T, EPL, 1>(q, k, v, out, pages, lengths, B, H, KV, HD, PS,
                             MP, scale, softcap, st);
  if (rep <= 2)
    return launch<T, EPL, 2>(q, k, v, out, pages, lengths, B, H, KV, HD, PS,
                             MP, scale, softcap, st);
  if (rep <= 4)
    return launch<T, EPL, 4>(q, k, v, out, pages, lengths, B, H, KV, HD, PS,
                             MP, scale, softcap, st);
  return launch<T, EPL, 8>(q, k, v, out, pages, lengths, B, H, KV, HD, PS, MP,
                           scale, softcap, st);
}

template <typename T>
cudaError_t by_hd(int rep, const void* q, const void* k, const void* v,
                  void* out, const int32_t* pages, const int32_t* lengths,
                  int B, int H, int KV, int HD, int PS, int MP, float scale,
                  float softcap, cudaStream_t st) {
  if (HD <= 32)
    return by_rep<T, 1>(rep, q, k, v, out, pages, lengths, B, H, KV, HD, PS,
                        MP, scale, softcap, st);
  if (HD <= 64)
    return by_rep<T, 2>(rep, q, k, v, out, pages, lengths, B, H, KV, HD, PS,
                        MP, scale, softcap, st);
  return by_rep<T, 4>(rep, q, k, v, out, pages, lengths, B, H, KV, HD, PS, MP,
                      scale, softcap, st);
}

}  // namespace

// K4: out[B, 1, H, HD] of q[B, 1, H, HD] against k_pool, v_pool
// [P, PS, KV, HD] through pages int32[B, MP] up to lengths int32[B]
// (clamped to [0, MP * PS]; a row of length 0 gets zeros), all contiguous,
// 16-byte aligned, one dtype (0 = float32, 1 = bfloat16). HD a multiple of
// 8 up to 128, H / KV at most 8. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int pa_paged_decode_attention(const void* q, const void* k_pool,
                                         const void* v_pool, void* out,
                                         int dtype, const int32_t* pages,
                                         const int32_t* lengths, int B, int H,
                                         int KV, int HD, int PS, int MP,
                                         float scale, float softcap,
                                         void* stream) {
  if (B < 1 || B > 65535 || KV < 1 || KV > 65535 || H % KV || H / KV > 8 ||
      HD < 8 || HD > 128 || HD % 8 || PS < 1 || MP < 1 ||
      (dtype != kF32 && dtype != kBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rep = H / KV;
  const auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == kBF16
          ? by_hd<__nv_bfloat16>(rep, q, k_pool, v_pool, out, pages, lengths,
                                 B, H, KV, HD, PS, MP, scale, softcap, st)
          : by_hd<float>(rep, q, k_pool, v_pool, out, pages, lengths, B, H,
                         KV, HD, PS, MP, scale, softcap, st);
  return static_cast<int>(err);
}
