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
// both safe. The plain version rounds the scores and the probabilities to
// q's dtype before they meet V; this kernel does not, so the two agree to
// a tolerance, not bit for bit (kernels/zvg_matmul/cases.py).
//
// The TPU kernel gathers every row's pages into a dense [B, MP * PS] view
// inside one gridless call and runs the dense attention on it, reading
// the whole table width.
//
// Bound on an H100: each K and V element below the length is read once,
// sum_b length_b * KV * HD * 2 words, plus q, the output and the tables,
// at 3.35 TB/s; about 4 operations per byte, far below the tensor cores'
// line. At the serving shape (8 rows, lengths near 130, KV 16, HD 64,
// bf16) that is about 0.6 us a launch. The first Hopper version took 25.8
// us: one block of 4 warps per (row, KV head), 128 blocks, lane j scoring
// position 32 t + j from its own K row, then a P.V loop over the tile's
// positions that loaded each V row and used it at once -- a chain of up to
// 32 dependent global loads a tile -- so the launch was latency, not bytes.
// This version (split_attention_kernel):
//   * splits the positions across blocks: a block takes (split, KV head,
//     row) and a chunk of S positions (S a whole number of pages, 64 at
//     pages of 16), and the splits of one (row, KV head) form a thread
//     block cluster of up to 8; a table wider than 8 chunks gives each
//     block every 8th chunk. The plan comes from the table width MP * PS,
//     which the host knows, never from lengths, which live on the card
//     (kernels/zvg_matmul/kernel.py::paged_plan): 512 blocks at the
//     serving shape. A chunk past the row's length does no work and still
//     joins the combine, with m = -inf and l = 0;
//   * stages a chunk's pages before any arithmetic: every 16-byte
//     cp.async of its K and V rows is issued at once into shared memory,
//     then the block waits once, so no load waits on another;
//   * scores with L = HD / 8 (rounded up to a power of two) lanes a
//     position, each lane 8 dims of the K row in shared memory against
//     the group's rep query heads in registers, summed by shuffles: a
//     K row is read whole and conflict-free by its lanes. (No mma.sync:
//     at decode a KV head has at most 8 query rows, and the scores are a
//     small share of the time.) Each thread then owns 8 output dims of one
//     head and sums P.V over every S-th position of its slice from shared
//     memory; the slices meet in shared memory in slice order;
//   * combines (m, l, acc) of the cluster's blocks through distributed
//     shared memory, each block writing its share of the outputs from the
//     blocks' partials in rank order: no workspace, no atomics, and a
//     result that does not change from run to run. Rows that share prefix
//     pages read them once per row; L2 serves the repeats. (Reading the
//     chunk's page ids beside q and the length, and the merge's remote
//     reads all at once through shared memory, were each measured slower
//     on an H100: PERF.md, section 6.)

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxPos = 64;     // positions of a chunk
constexpr int kMaxHD = 128;
constexpr int kMaxCluster = 8;
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

// Eight consecutive words from a 16-byte aligned shared address, as floats.
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(words[i] << 16);
    v[2 * i + 1] = __uint_as_float(words[i] & 0xFFFF0000u);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n"
               ::: "memory");
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

// L: lanes a position in the scores (HD <= 8 L); MAXREP: query heads per
// KV head the instantiation holds (rep <= MAXREP). Grid (cluster, KV, B),
// one cluster a (row, KV head); chunk c covers positions [c S, c S + S).
template <typename T, int L, int MAXREP>
__global__ void __launch_bounds__(kThreads)
split_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool,
                       const int32_t* __restrict__ pages,
                       const int32_t* __restrict__ lengths,
                       T* __restrict__ out, int H, int KV, int HD, int PS,
                       int MP, int S, int chunks, float scale, float softcap) {
  constexpr int E = 16 / sizeof(T);            // words a 16-byte copy
  constexpr int kGroups = kThreads / L;        // positions a score step
  extern __shared__ __align__(16) unsigned char stage_raw[];
  T* sK = reinterpret_cast<T*>(stage_raw);     // [S][HD]
  T* sV = sK + S * HD;                         // [S][HD]
  __shared__ __align__(16) float sQ[MAXREP][kMaxHD];
  __shared__ float sP[MAXREP][kMaxPos];        // scores, then probabilities
  __shared__ float sM[MAXREP], sL[MAXREP], sC[MAXREP];
  __shared__ float red[kThreads * 8];          // P.V slices' sums
  __shared__ float blk[MAXREP * kMaxHD];       // this block's acc

  cg::cluster_group cluster = cg::this_cluster();
  const int CL = cluster.num_blocks(), rank = cluster.block_rank();
  const int g = blockIdx.y, b = blockIdx.z;
  const int rep = H / KV, G = HD / 8;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  const T* q_row = q + (static_cast<size_t>(b) * H + g * rep) * HD;
  for (int i = tid; i < rep * HD; i += kThreads)
    sQ[i / HD][i % HD] = to_f(q_row[i]);
  if (tid < MAXREP) {
    sM[tid] = -INFINITY;
    sL[tid] = 0.f;
  }
  const int32_t* table = pages + static_cast<size_t>(b) * MP;
  const int len = min(max(lengths[b], 0), MP * PS);
  __syncthreads();

  // the score lanes: group grp of L lanes takes a position, lane gl its
  // dims 8 gl .. 8 gl + 7
  const int gl = lane % L, grp = tid / L;
  float qv[MAXREP][8];
#pragma unroll
  for (int r = 0; r < MAXREP; ++r)
#pragma unroll
    for (int d = 0; d < 8; ++d)
      qv[r][d] = (r < rep && gl < G) ? sQ[r][8 * gl + d] : 0.f;
  // the P.V threads: item (head r_pv, dims 8 dg ..) and position slice
  const int items = rep * G, slices = kThreads / items;
  const bool pv = tid < items * slices;
  const int item = tid % items, slice = tid / items;
  const int r_pv = item / G, dg = item % G;
  float acc[8];
#pragma unroll
  for (int d = 0; d < 8; ++d) acc[d] = 0.f;

  const size_t pos_stride = static_cast<size_t>(KV) * HD;
  for (int c = rank; c < chunks; c += CL) {
    const int pos0 = c * S, n = min(S, len - pos0);
    if (n <= 0) break;   // the same for the whole block
    __syncthreads();     // the previous chunk's stage is consumed
    // every K and V row of the chunk in flight at once
    const int pieces = HD / E, per = n * pieces;
    for (int i = tid; i < 2 * per; i += kThreads) {
      const int which = i / per, j = (i % per) / pieces, pc = i % pieces;
      const int pos = pos0 + j;
      const size_t src = (static_cast<size_t>(table[pos / PS]) * PS +
                          pos % PS) * pos_stride +
                         static_cast<size_t>(g) * HD + pc * E;
      cp_async16((which ? sV : sK) + j * HD + pc * E,
                 (which ? v_pool : k_pool) + src);
    }
    cp_async_wait_all();
    __syncthreads();

    for (int base = 0; base < n; base += kGroups) {
      const int j = base + grp;
      float s[MAXREP];
#pragma unroll
      for (int r = 0; r < MAXREP; ++r) s[r] = 0.f;
      if (j < n && gl < G) {
        float k8[8];
        load8(sK + j * HD + 8 * gl, k8);
#pragma unroll
        for (int r = 0; r < MAXREP; ++r)
#pragma unroll
          for (int d = 0; d < 8; ++d) s[r] = fmaf(qv[r][d], k8[d], s[r]);
      }
#pragma unroll
      for (int r = 0; r < MAXREP; ++r) {
#pragma unroll
        for (int o = L / 2; o > 0; o >>= 1)
          s[r] += __shfl_xor_sync(kFull, s[r], o);
        if (r < rep && j < n && gl == r % L) {   // heads over the lanes
          float x = s[r] * scale;
          if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
          sP[r][j] = x;
        }
      }
    }
    __syncthreads();

    // the chunk's softmax, a warp a head, merged into the running one
    for (int r = warp; r < rep; r += kWarps) {
      const float x0 = lane < n ? sP[r][lane] : -INFINITY;
      const float x1 = lane + 32 < n ? sP[r][lane + 32] : -INFINITY;
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(x0, x1)));
      const float p0 = lane < n ? expf(x0 - m_new) : 0.f;
      const float p1 = lane + 32 < n ? expf(x1 - m_new) : 0.f;
      if (lane < n) sP[r][lane] = p0;
      if (lane + 32 < n) sP[r][lane + 32] = p1;
      const float sum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);   // 0 on the first chunk
        sC[r] = corr;
        sL[r] = sL[r] * corr + sum;
        sM[r] = m_new;
      }
    }
    __syncthreads();

    if (pv) {
      const float corr = sC[r_pv];
#pragma unroll
      for (int d = 0; d < 8; ++d) acc[d] *= corr;
      for (int j = slice; j < n; j += slices) {
        const float p = sP[r_pv][j];
        float v8[8];
        load8(sV + j * HD + 8 * dg, v8);
#pragma unroll
        for (int d = 0; d < 8; ++d) acc[d] = fmaf(p, v8[d], acc[d]);
      }
    }
  }

  // this block's partial: its slices in slice order
  if (pv) {
#pragma unroll
    for (int d = 0; d < 8; ++d) red[(slice * items + item) * 8 + d] = acc[d];
  }
  __syncthreads();
  for (int e = tid; e < rep * HD; e += kThreads) {
    float sum = red[e];
    for (int sl = 1; sl < slices; ++sl) sum += red[sl * items * 8 + e];
    blk[e] = sum;
  }
  cluster.sync();   // every block's partial is in

  // this block's share of the outputs: the blocks' partials in rank order
  T* out_row = out + (static_cast<size_t>(b) * H + g * rep) * HD;
  const int share = (rep * HD + CL - 1) / CL;
  const int e0 = rank * share, e1 = min(rep * HD, e0 + share);
  for (int e = e0 + tid; e < e1; e += kThreads) {
    const int r = e / HD;
    float mx = -INFINITY;
    for (int qb = 0; qb < CL; ++qb)
      mx = fmaxf(mx, *cluster.map_shared_rank(&sM[r], qb));
    float sum = 0.f, o = 0.f;
    if (mx > -INFINITY) {
      for (int qb = 0; qb < CL; ++qb) {
        const float f = expf(*cluster.map_shared_rank(&sM[r], qb) - mx);
        sum = fmaf(*cluster.map_shared_rank(&sL[r], qb), f, sum);
        o = fmaf(*cluster.map_shared_rank(&blk[e], qb), f, o);
      }
      o /= sum;
    }
    store(out_row + e, o);
  }
  cluster.sync();   // no block leaves while its partial may be read
}

struct Args {
  const void *q, *k, *v;
  void* out;
  const int32_t *pages, *lengths;
  int B, H, KV, HD, PS, MP, S, chunks, cluster;
  float scale, softcap;
};

template <typename T, int L, int MAXREP>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const auto kernel = split_attention_kernel<T, L, MAXREP>;
  const size_t smem = 2 * sizeof(T) * a.S * a.HD;
  static size_t sized = 48 * 1024;
  if (smem > sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    sized = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.cluster, a.KV, a.B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.pages, a.lengths, static_cast<T*>(a.out),
      a.H, a.KV, a.HD, a.PS, a.MP, a.S, a.chunks, a.scale, a.softcap);
}

template <typename T, int L>
cudaError_t by_rep(const Args& a, cudaStream_t st) {
  const int rep = a.H / a.KV;
  if (rep <= 1) return launch<T, L, 1>(a, st);
  if (rep <= 2) return launch<T, L, 2>(a, st);
  if (rep <= 4) return launch<T, L, 4>(a, st);
  return launch<T, L, 8>(a, st);
}

template <typename T>
cudaError_t by_hd(const Args& a, cudaStream_t st) {
  if (a.HD <= 16) return by_rep<T, 2>(a, st);
  if (a.HD <= 32) return by_rep<T, 4>(a, st);
  if (a.HD <= 64) return by_rep<T, 8>(a, st);
  return by_rep<T, 16>(a, st);
}

}  // namespace

// K4: out[B, 1, H, HD] of q[B, 1, H, HD] against k_pool, v_pool
// [P, PS, KV, HD] through pages int32[B, MP] up to lengths int32[B]
// (clamped to [0, MP * PS]; a row of length 0 gets zeros), all contiguous,
// 16-byte aligned, one dtype (0 = float32, 1 = bfloat16). HD a multiple of
// 8 up to 128, H / KV at most 8. The plan (paged_plan): chunks of S <= 64
// positions, `chunks` of them covering MP * PS, a cluster of `cluster` <= 8
// blocks a (row, KV head). Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int pa_paged_decode_attention(const void* q, const void* k_pool,
                                         const void* v_pool, void* out,
                                         int dtype, const int32_t* pages,
                                         const int32_t* lengths, int B, int H,
                                         int KV, int HD, int PS, int MP,
                                         int S, int chunks, int cluster,
                                         float scale, float softcap,
                                         void* stream) {
  if (B < 1 || B > 65535 || KV < 1 || KV > 65535 || H % KV || H / KV > 8 ||
      HD < 8 || HD > kMaxHD || HD % 8 || PS < 1 || MP < 1 || S < 1 ||
      S > kMaxPos || cluster < 1 || cluster > kMaxCluster ||
      chunks < cluster || static_cast<long long>(S) * chunks <
                              static_cast<long long>(MP) * PS ||
      (dtype != kF32 && dtype != kBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k_pool, v_pool, out, pages, lengths, B, H, KV, HD, PS, MP,
               S, chunks, cluster, scale, softcap};
  const auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == kBF16 ? by_hd<__nv_bfloat16>(a, st)
                                         : by_hd<float>(a, st);
  return static_cast<int>(err);
}
