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
// Design (the grid comes from kernels/transitions/kernel.py::
// transitions_plan, which the wrapper passes in):
//   * Wide loads. On the vector route a thread reads 16 bytes of adjacent
//     lanes a cycle (8 uint16 or 4 int32 words), XORs them against the
//     previous cycle's vector and counts each 16-bit field with __popc.
//     It needs L a multiple of the vector and a 16-byte aligned base, so
//     every row is aligned; the scalar route (one word a thread) takes
//     the rest. The route is chosen by shape and address before launch.
//   * Short chunks, loads first. A block is 256 threads: `tx` lane vectors
//     across, `ty` thread rows along T; a thread walks `cycles` cycles,
//     issuing a batch of 8 loads (the first with the word before its
//     chunk) before the first use. Lanes past L and
//     cycles past its chunk read a clamped address and add 0 by a select,
//     so no load sits under a branch. The word before a chunk is its
//     first "previous" word, so no carry crosses chunks.
//   * Few rounds of loads, no atomics, no zero fill. At these sizes a
//     launch is latency: each batch of loads costs about one memory
//     latency and a cluster barrier about as much, so the plan takes the
//     fewest batches, then no cluster, then the widest lane tile. Lane
//     tiles are independent; along T a tile is one block, or a cluster of
//     up to 8 (16 if forced). Per-lane sums are added over a warp's rows by
//     shuffles, over the block's warps in shared memory, and over the
//     cluster's blocks in block rank 0's shared memory, which every block
//     writes its sums into through distributed shared memory (one cluster
//     barrier after that; the one that lets them write is split around
//     the loads); one thread of rank 0 then stores out[l] once.
//     Integer sums: the result does not change from run to run.
//
// Bound on an H100: the pass reads each word once (2*T*L bytes as uint16)
// and writes 4*L bytes; XOR, AND and __popc are a few integer operations
// per word, so the bytes bound it, at 3.35 TB/s: 1.4 us for the largest
// ResNet50 weight stream (4608 x 512), 15.3 us over all 54. At these sizes
// a launch is mostly its latency: a few microseconds.

#include <cstdint>
#include <cuda_runtime.h>

#include <cooperative_groups.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 8;        // loads a thread issues before using one
constexpr int kMaxCluster = 16;  // blocks of a cluster (non-portable)
constexpr int kMaxLanes = 64;    // lanes of a block's tile (tx * VEC)

// One cycle's words of a thread: VEC adjacent lanes, loaded at once, and
// the per-lane popcounts of (w ^ prev) & mask added to s[] where `ok`.
template <typename Word, int VEC>
struct Lanes;

template <>
struct Lanes<uint16_t, 8> {   // 8 uint16 words, one 16-byte load
  using Pack = uint4;
  static __device__ __forceinline__ Pack load(const uint16_t* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ Pack from_init(const int32_t* init) {
    uint32_t r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      r[j] = (static_cast<uint32_t>(init[2 * j]) & 0xFFFFu) |
             (static_cast<uint32_t>(init[2 * j + 1]) << 16);
    return make_uint4(r[0], r[1], r[2], r[3]);
  }
  static __device__ __forceinline__ void count(int (&s)[8], const Pack& w,
                                               const Pack& p, uint32_t m,
                                               bool ok) {
    const uint32_t m2 = m | (m << 16);
    const uint32_t d[4] = {(w.x ^ p.x) & m2, (w.y ^ p.y) & m2,
                           (w.z ^ p.z) & m2, (w.w ^ p.w) & m2};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[2 * j] += ok ? __popc(d[j] & 0xFFFFu) : 0;
      s[2 * j + 1] += ok ? __popc(d[j] >> 16) : 0;
    }
  }
};

template <>
struct Lanes<int32_t, 4> {    // 4 int32 words, one 16-byte load
  using Pack = uint4;
  static __device__ __forceinline__ Pack load(const int32_t* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ Pack from_init(const int32_t* init) {
    return make_uint4(init[0], init[1], init[2], init[3]);
  }
  static __device__ __forceinline__ void count(int (&s)[4], const Pack& w,
                                               const Pack& p, uint32_t m,
                                               bool ok) {
    s[0] += ok ? __popc((w.x ^ p.x) & m) : 0;
    s[1] += ok ? __popc((w.y ^ p.y) & m) : 0;
    s[2] += ok ? __popc((w.z ^ p.z) & m) : 0;
    s[3] += ok ? __popc((w.w ^ p.w) & m) : 0;
  }
};

template <typename Word>
struct Lanes<Word, 1> {       // one word (any L, any alignment)
  using Pack = uint32_t;
  static __device__ __forceinline__ Pack load(const Word* p) {
    return static_cast<uint32_t>(__ldg(p));
  }
  static __device__ __forceinline__ Pack from_init(const int32_t* init) {
    return static_cast<uint32_t>(init[0]);
  }
  static __device__ __forceinline__ void count(int (&s)[1], const Pack& w,
                                               const Pack& p, uint32_t m,
                                               bool ok) {
    s[0] += ok ? __popc((w ^ p) & m) : 0;
  }
};

// Block (tile, rank): tile = blockIdx.x / cl, rank = its place in the
// cluster along T. Thread (x, y) takes lane vector tile * tx + x (VEC
// lanes) and thread row rank * ty + y: cycles [row * cycles, ...).
template <typename Word, int VEC>
__global__ void __launch_bounds__(kThreads)
transitions_kernel(const Word* __restrict__ x,
                   const int32_t* __restrict__ init, int T, int L, int tx,
                   int cycles, int cl, uint32_t mask,
                   int32_t* __restrict__ out) {
  using R = Lanes<Word, VEC>;
  __shared__ int warp_sums[kWarps][kMaxLanes];
  __shared__ int cluster_sums[kMaxCluster][kMaxLanes];   // rank 0's is read
  // first half of the barrier that makes sure every block of the cluster
  // has started before another writes into its shared memory; its wait
  // comes after the loads, so it costs nothing on the way
  if (cl > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::
                               : "memory");

  const int ty = kThreads / tx;
  const int tid = threadIdx.x;
  const int tx_i = tid % tx, ty_i = tid / tx;
  const int tile = blockIdx.x / cl, rank = blockIdx.x % cl;
  const int nvec = (L + VEC - 1) / VEC;
  const int v = tile * tx + tx_i;
  const bool lane_ok = v < nvec;
  const size_t col = static_cast<size_t>(min(v, nvec - 1)) * VEC;
  const int t0 = (rank * ty + ty_i) * cycles;
  const int t1 = min(T, t0 + cycles);       // t1 <= t0: an idle thread
  const int last = max(min(t1, T) - 1, 0);  // clamp for loads past t1

  int s[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) s[i] = 0;
  // the word before the chunk is loaded with the first batch, from a
  // clamped row; a chunk at t = 0 takes init (or zeros) instead
  typename R::Pack prev = R::load(
      x + static_cast<size_t>(max(min(t0, T) - 1, 0)) * L + col);
  for (int base = 0; base < cycles; base += kBatch) {
    typename R::Pack w[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int t = min(t0 + base + j, last);
      w[j] = R::load(x + static_cast<size_t>(t) * L + col);
    }
    if (base == 0 && t0 == 0)
      prev = init ? R::from_init(init + col) : typename R::Pack{};
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      R::count(s, w[j], prev, mask, lane_ok && t0 + base + j < t1);
      prev = w[j];
    }
  }

  // over the warp's rows (lanes tx apart hold the same lane vector)
  for (int off = tx; off < 32; off *= 2) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) s[i] += __shfl_xor_sync(~0u, s[i], off);
  }
  const int warp = tid / 32, lane = tid % 32;
  if (lane < tx) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) warp_sums[warp][lane * VEC + i] = s[i];
  }
  __syncthreads();
  const int n_lanes = tx * VEC;
  int bs = 0;
  if (tid < n_lanes) {
#pragma unroll
    for (int w2 = 0; w2 < kWarps; ++w2) bs += warp_sums[w2][tid];
  }
  const int l = tile * n_lanes + tid;
  if (cl == 1) {
    if (tid < n_lanes && l < L) out[l] = bs;
    return;
  }
  // every block stores its sums into rank 0's shared memory (no remote
  // loads), one barrier, and rank 0 adds them up and stores out
  cg::cluster_group cluster = cg::this_cluster();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (tid < n_lanes)
    cluster.map_shared_rank(&cluster_sums[0][0], 0)[rank * kMaxLanes + tid] =
        bs;
  cluster.sync();
  if (rank == 0 && tid < n_lanes) {
    int total = 0;
    for (int q = 0; q < cl; ++q) total += cluster_sums[q][tid];
    if (l < L) out[l] = total;
  }
}

template <typename Word, int VEC>
cudaError_t launch(const void* x, const int32_t* init, int T, int L, int tx,
                   int cycles, int cl, int tiles, uint32_t mask,
                   int32_t* out, cudaStream_t stream) {
  auto kernel = transitions_kernel<Word, VEC>;
  if (cl > 8) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(tiles) * cl);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cl > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<const Word*>(x), init,
                            T, L, tx, cycles, cl, mask, out);
}

}  // namespace

// Stores the per-lane transition counts of x[T, L] (word_bytes 2: uint16
// words, 4: int32 words holding 0..65535) under mask (its low 16 bits)
// into out[L]. init[L] (int32 words, or null for an all-zero bus) is the
// bus state before cycle 0. The grid is the plan's
// (kernels/transitions/kernel.py::transitions_plan): vec words a thread
// loads a cycle (16 / word_bytes on the vector route, else 1), tx lane
// vectors a block across, `cycles` cycles a thread, clusters of cl blocks
// along T, `tiles` lane tiles. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for arguments the kernel does not take: among
// them a plan that leaves a cycle or a lane uncovered, and a vector route
// on an unaligned base or an L that is not a multiple of the vector).
extern "C" int tr_count_transitions(const void* x, int word_bytes,
                                    const int32_t* init, int T, int L,
                                    uint32_t mask, int32_t* out,
                                    void* stream, int vec, int tx,
                                    int cycles, int cl, int tiles) {
  const bool vector = vec > 1;
  const int nvec = vector ? L / vec : L;
  if (T < 1 || L < 1 || (word_bytes != 2 && word_bytes != 4) ||
      (vector && (vec * word_bytes != 16 || L % vec != 0 ||
                  reinterpret_cast<uintptr_t>(x) % 16 != 0)) ||
      (!vector && vec != 1) || tx < 1 || tx > 32 || kThreads % tx != 0 ||
      tx * vec > kMaxLanes || cycles < 1 || cl < 1 || cl > kMaxCluster ||
      tiles < 1 || static_cast<long long>(tiles) * tx < nvec ||
      static_cast<long long>(cl) * (kThreads / tx) * cycles < T ||
      static_cast<long long>(cl) * (kThreads / tx) * cycles >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  mask &= 0xFFFFu;
  cudaError_t err;
  if (word_bytes == 2)
    err = vector ? launch<uint16_t, 8>(x, init, T, L, tx, cycles, cl, tiles,
                                       mask, out, s)
                 : launch<uint16_t, 1>(x, init, T, L, tx, cycles, cl, tiles,
                                       mask, out, s);
  else
    err = vector ? launch<int32_t, 4>(x, init, T, L, tx, cycles, cl, tiles,
                                      mask, out, s)
                 : launch<int32_t, 1>(x, init, T, L, tx, cycles, cl, tiles,
                                      mask, out, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
