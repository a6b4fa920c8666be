// The score core shared by P1 (head_attention.cu) and P10/P15
// (batched_qk.cu): for one row g of (G, c, N) q and k, the c x c sums
// q_r . k_c over N in fp32 (and, for P1, |q_r|^2 and |k_c|^2), split over
// the S blocks of one thread-block cluster and met in a fixed order.
//
// A block walks its chunk of columns kTile at a time. The tile of q and k
// (c rows, zero rows up to a multiple of 3 and zero columns past the
// chunk) moves in loads of VEC elements (16 bytes where N and the bases
// allow), all of a step's loads in flight at once, into registers while
// the previous tile is summed; then into shared memory in the input's type
// (row pitch kTile * sizeof(T) + 16 bytes: 16-byte stores, and the rows a
// warp reads at one column fall on distinct banks). Thread t owns the 3 x 3
// register tile (t % tiles) of the c x c matrix and the columns
// t / tiles, t / tiles + slices, ... of each step: 9 fused multiply-adds
// for 6 shared-memory loads, summed per step and then into the running
// sums (a long fp32 sum over N = 60,000 columns would otherwise add ~1,000
// terms in a row). The slices meet in slice order in shared memory, then
// the cluster's blocks through distributed shared memory in rank order: no
// atomics, so two calls give the same bits, and every block of the cluster
// holds the same sums.
#pragma once

#include <initializer_list>

#include <cooperative_groups.h>

#include "common.cuh"

namespace hvi_cidnet {
namespace qk {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kTile = 256;         // columns a step
constexpr int kRt = 3;             // a thread's register tile: 3 q rows x 3 k rows
constexpr int kMaxC = 32;          // rows of q and k a g
constexpr int kMaxCluster = 8;     // portable cluster size

__host__ __device__ inline int side_tiles(int c) { return (c + kRt - 1) / kRt; }
__host__ __device__ inline int rows_pad(int c) { return side_tiles(c) * kRt; }
__host__ __device__ inline int slices(int c) { return kThreads / (side_tiles(c) * side_tiles(c)); }
__host__ __device__ inline int entries(int c, bool norms) { return c * c + (norms ? 2 * c : 0); }
// row pitch of the staged tiles, in elements of an itemsize-byte type
__host__ __device__ inline int pitch(int itemsize) { return kTile + 16 / itemsize; }
// shared memory of the score core, in bytes: the q and k tiles, then (fp32)
// the slices' partials and the block's sums
__host__ __device__ inline int core_bytes(int c, bool norms, int itemsize) {
  return 2 * rows_pad(c) * pitch(itemsize) * itemsize + 4 * (slices(c) + 1) * entries(c, norms);
}
// c rounded up to the kernels' instantiations: 8, 20 (c = 18 at every site
// of the forward) or 32
__host__ __device__ inline int c_max(int c) { return c <= 8 ? 8 : c <= 20 ? 20 : 32; }

// One operand's tile: rows [0, RMAX) x columns [col0, col0 + kTile) of
// src (row pitch n), VEC elements a load; element i of thread t is vector
// (t + i * kThreads): row / (kTile / VEC), column % (kTile / VEC). Zero past
// c and past col_end (which, with n, is a multiple of VEC).
template <typename T, int VEC, int RMAX>
struct Tile {
  static constexpr int kPerRow = kTile / VEC;
  static constexpr int kLoads = (RMAX * kPerRow + kThreads - 1) / kThreads;
  using V = typename VecBytes<sizeof(T) * VEC>::type;
  V r[kLoads];

  __device__ __forceinline__ void load(const T* __restrict__ src, int c, int64_t n, int64_t col0,
                                       int64_t col_end) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int row = idx / kPerRow;
      const int64_t col = col0 + (idx % kPerRow) * VEC;
      if (row < c && col < col_end) load_vec<sizeof(V)>(&r[i], src + row * n + col);
      else r[i] = V{};
    }
  }
  __device__ __forceinline__ void store(T* s, int rows) const {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int row = idx / kPerRow;
      if (row < rows)
        store_vec<sizeof(V)>(s + row * pitch(sizeof(T)) + (idx % kPerRow) * VEC, &r[i]);
    }
  }
};

// The block's sums over columns [col0, col_end) of one g (q, k: its c x n
// rows, c <= RMAX) in shared memory (smem: core_bytes(c, kNorms,
// sizeof(T))), returned as red: red[i * c + j] = q_i . k_j, then (kNorms)
// |q_i|^2 at c * c + i and |k_j|^2 at c * c + c + j. Ends with a block
// barrier.
template <typename T, int VEC, int RMAX, bool kNorms>
__device__ float* block_scores(const T* __restrict__ q, const T* __restrict__ k, int c,
                               int64_t n, int64_t col0, int64_t col_end, unsigned char* smem) {
  constexpr int kP = kTile + 16 / static_cast<int>(sizeof(T));
  const int ts = side_tiles(c), tiles = ts * ts, sl = kThreads / tiles, rows = ts * kRt;
  const int e_count = entries(c, kNorms);
  T* sq = reinterpret_cast<T*>(smem);
  T* sk = sq + rows * kP;
  float* part = reinterpret_cast<float*>(sk + rows * kP);
  float* red = part + sl * e_count;
  const int tile = threadIdx.x % tiles, slice = threadIdx.x / tiles;
  const bool active = slice < sl;
  const int ti = tile / ts, tj = tile - ti * ts;
  float sum[kRt][kRt], sq_q[kRt], sq_k[kRt];  // running sums over the steps
#pragma unroll
  for (int r = 0; r < kRt; ++r) {
    sq_q[r] = sq_k[r] = 0.0f;
#pragma unroll
    for (int s = 0; s < kRt; ++s) sum[r][s] = 0.0f;
  }
  Tile<T, VEC, RMAX> tq, tk;
  tq.load(q, c, n, col0, col_end);
  tk.load(k, c, n, col0, col_end);
  const T* pq = sq + ti * kRt * kP;
  const T* pk = sk + tj * kRt * kP;
  for (int64_t c0 = col0; c0 < col_end; c0 += kTile) {
    __syncthreads();  // the last step's readers are done
    tq.store(sq, rows);
    tk.store(sk, rows);
    __syncthreads();
    if (c0 + kTile < col_end) {  // the next tile's loads fly while this one is summed
      tq.load(q, c, n, c0 + kTile, col_end);
      tk.load(k, c, n, c0 + kTile, col_end);
    }
    if (!active) continue;
    const int width = static_cast<int>(min64(kTile, col_end - c0));
    float acc[kRt][kRt], nq[kRt], nk[kRt];  // this step's sums
#pragma unroll
    for (int r = 0; r < kRt; ++r) {
      nq[r] = nk[r] = 0.0f;
#pragma unroll
      for (int s = 0; s < kRt; ++s) acc[r][s] = 0.0f;
    }
#pragma unroll 2
    for (int col = slice; col < width; col += sl) {
      float a[kRt], b[kRt];
#pragma unroll
      for (int r = 0; r < kRt; ++r) {
        a[r] = load_f32(pq, r * kP + col);
        b[r] = load_f32(pk, r * kP + col);
      }
#pragma unroll
      for (int r = 0; r < kRt; ++r)
#pragma unroll
        for (int s = 0; s < kRt; ++s) acc[r][s] = fmaf(a[r], b[s], acc[r][s]);
      if (kNorms) {
        if (tj == 0)
#pragma unroll
          for (int r = 0; r < kRt; ++r) nq[r] = fmaf(a[r], a[r], nq[r]);
        if (ti == 0)
#pragma unroll
          for (int s = 0; s < kRt; ++s) nk[s] = fmaf(b[s], b[s], nk[s]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRt; ++r) {
      sq_q[r] += nq[r];
      sq_k[r] += nk[r];
#pragma unroll
      for (int s = 0; s < kRt; ++s) sum[r][s] += acc[r][s];
    }
  }
  if (active) {  // each entry once: the norms from the first tile column (q) and row (k)
    float* mine = part + slice * e_count;
#pragma unroll
    for (int r = 0; r < kRt; ++r) {
      const int i = ti * kRt + r, j0 = tj * kRt;
#pragma unroll
      for (int s = 0; s < kRt; ++s)
        if (i < c && j0 + s < c) mine[i * c + j0 + s] = sum[r][s];
      if (kNorms && tj == 0 && i < c) mine[c * c + i] = sq_q[r];
      if (kNorms && ti == 0 && j0 + r < c) mine[c * c + c + j0 + r] = sq_k[r];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < e_count; e += kThreads) {
    float s = 0.0f;
    for (int p = 0; p < sl; ++p) s += part[p * e_count + e];
    red[e] = s;
  }
  return red;
}

// The cluster's sums of red over its blocks, rank 0 first, for entries
// [lo, hi): put(e, sum). Every block that asks for an entry gets the same
// bits. Starts and ends with a cluster barrier (the second keeps each
// block's shared memory alive until the others have read it).
template <typename Put>
__device__ __forceinline__ void cluster_sum(float* red, int lo, int hi, Put&& put) {
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();  // every block's red is written
  const int blocks = static_cast<int>(cl.num_blocks());
  for (int e = lo + static_cast<int>(threadIdx.x); e < hi; e += kThreads) {
    float v[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)  // every remote load in flight, then the sum in order
      v[r] = r < blocks ? cl.map_shared_rank(red, r)[e] : 0.0f;
    float s = v[0];
#pragma unroll
    for (int r = 1; r < kMaxCluster; ++r)
      if (r < blocks) s += v[r];
    put(e, s);
  }
  cl.sync();
}

// Launch `kernel` on grid (splits, g) in clusters of `splits` blocks along
// x, with `smem` bytes of dynamic shared memory; returns a cudaError_t code.
template <typename... KArgs, typename... Args>
int launch_cluster(void (*kernel)(KArgs...), int splits, unsigned int g, int64_t smem,
                   cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(kernel), cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>(splits), g);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned int>(splits);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, static_cast<KArgs>(args)...);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// The plan's split of N and load width are ones the kernels take: splits
// blocks of `chunk` columns (a multiple of kTile), none empty, one cluster;
// vec elements (1, 2, or 16 bytes' worth) dividing n and every base's
// offset from a 16-byte boundary.
inline bool split_ok(int64_t n, int splits, int64_t chunk) {
  return n >= 1 && splits >= 1 && splits <= kMaxCluster && chunk >= kTile && chunk % kTile == 0 &&
         (splits - 1) * chunk < n && splits * chunk >= n;
}
inline bool vec_ok(int vec, int itemsize, int64_t n, std::initializer_list<const void*> bases) {
  if (!(vec == 1 || vec == 2 || vec * itemsize == 16) || n % vec) return false;
  for (const void* p : bases)
    if (reinterpret_cast<uintptr_t>(p) % (static_cast<uintptr_t>(vec) * itemsize)) return false;
  return true;
}

}  // namespace qk
}  // namespace hvi_cidnet
