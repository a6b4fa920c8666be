// The score core shared by P1 (head_attention.cu) and P10/P15
// (batched_qk.cu): for one row g of (G, c, N) q and k, the c x c sums
// q_r . k_c over N in fp32 (and, for P1, |q_r|^2 and |k_c|^2), split over
// the S blocks of one thread-block cluster and met in a fixed order. Two
// arms, one per input type.
//
// fp32 (block_scores, on the CUDA cores; TF32 would keep three digits). A
// block walks its chunk of columns kTile at a time. The tile of q and k
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
// terms in a row). The slices meet in slice order in shared memory.
//
// bf16 (mma_block_scores, on the tensor cores). The 3 x 3 CUDA-core tiles
// spent ~2.7 instructions a multiply-add, and the products, not the bytes,
// bounded the kernels. Here q and k stream through a ring of `stages`
// shared-memory stages of kMmaTile = 512 columns: where every row starts
// 16-byte aligned ("direct"), one bulk copy a row (the copy engine, an
// mbarrier a stage); else 16-byte cp.async copies of each row's aligned
// cover, then a realignment pass (row_stream.cuh). On the card a block's
// stream cost ~2-3 us a stage whatever the ring's depth (two stages of 512
// columns beat two to five of 256 by 1.7x), so the stages are wide, the
// ring two deep, and two blocks share an SM. Warp w takes the k16 steps
// 16 w, 16 (w + 8), ... of each stage (64 of its columns): q's rows as m16
// tiles (zero-padded to 32) and k's as the n8 operand (24 or 32), mma.sync
// m16n8k16 bf16 -> fp32 through ldmatrix (wgmma wants 64-row tiles: 18 rows
// would waste 3/4 of each). Rows c .. 32 are never staged: their ldmatrix
// lanes read a zeroed 16-byte line. k's n8 fragments are halves of its m16
// ones, and |q_r|^2, |k_c|^2 are the diagonals of X X^T from the same
// fragments. A warp sums each stage's 64 columns into fresh accumulators,
// then into its running fp32 sums (as the fp32 arm: a long fp32 sum would
// add ~1,000 terms in a row); the warps meet in warp order in shared
// memory.
//
// Then the cluster's blocks meet through distributed shared memory in rank
// order: no atomics, so two calls give the same bits, and every block of
// the cluster holds the same sums.
#pragma once

#include <initializer_list>

#include <cooperative_groups.h>

#include "common.cuh"
#include "mma.cuh"
#include "row_stream.cuh"

namespace hvi_cidnet {
namespace qk {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kTile = 256;         // columns a step
constexpr int kRt = 3;             // a thread's register tile: 3 q rows x 3 k rows
constexpr int kMaxC = 32;          // rows of q and k a g
constexpr int kMaxCluster = 8;     // blocks a cluster of the fp32 arm: the portable size
constexpr int kMmaMaxCluster = 16; // of the bf16 arm: past 8 non-portable

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

// ---------------------------------------------------------------------------
// bf16: the tensor-core score core
// ---------------------------------------------------------------------------

constexpr int kWarps = kThreads / 32;
constexpr int kMmaTile = 512;                // columns a ring stage
constexpr int kMmaPitch = kMmaTile + 8;      // staged rows: an ldmatrix's 8 rows on distinct banks
constexpr int kMaxStages = 6;
constexpr int kMaxApplyStages = 8;           // cp_async_wait_dyn's range

// P1's apply streams v alone, half a stage's bytes a step: twice the stages
__host__ __device__ inline int apply_stages(int stages) {
  return 2 * stages < kMaxApplyStages ? 2 * stages : kMaxApplyStages;
}
// fp32 values of the reduction: the warps' partials, the block's sums, the
// cluster's sums, then (P1, norms) the c x c softmax
__host__ __device__ inline int reduce_floats(int c, bool norms) {
  const int e = entries(c, norms);
  return kWarps * e + 2 * e + (norms ? c * c : 0);
}
// the area after the ring: the realigned q and k tiles (c x kMmaPitch bf16
// each), or the reduction; P1's apply reuses it for the realigned v and the
// output tile
__host__ __device__ inline int aux_bytes(int c, bool norms) {
  const int tiles = 4 * c * kMmaPitch, red = 4 * reduce_floats(c, norms);
  return ((tiles > red ? tiles : red) + 15) / 16 * 16;
}
// shared memory of a bf16 block: the ring (stages x (q, k) x c rows), the
// aux area, a zeroed 16-byte line, the rows' element offsets (c int64), the
// ring's mbarriers (kMaxStages for the scores, kMaxApplyStages for P1's v)
__host__ __device__ inline int mma_bytes(int c, bool norms, int stages) {
  return stages * 4 * c * kMmaPitch + aux_bytes(c, norms) + 16 + 8 * c +
         8 * (kMaxStages + kMaxApplyStages);
}

struct MmaSmem {
  bf16* ring;
  bf16* aux;
  const bf16* zero;
  int64_t* rowbase;
  uint64_t* bars;  // the scores' stages, then P1's v stages from kMaxStages

  // Carve smem, write row g's offsets and the zero line, initialise the
  // mbarriers; ends with a block barrier.
  __device__ MmaSmem(unsigned char* smem, int c, bool norms, int stages, int64_t g, int64_t n) {
    ring = reinterpret_cast<bf16*>(smem);
    unsigned char* p = smem + stages * 4 * c * kMmaPitch;
    aux = reinterpret_cast<bf16*>(p);
    p += aux_bytes(c, norms);
    zero = reinterpret_cast<const bf16*>(p);
    rowbase = reinterpret_cast<int64_t*>(p + 16);
    bars = reinterpret_cast<uint64_t*>(rowbase + c);
    if (threadIdx.x == 0) {
      *reinterpret_cast<uint4*>(p) = make_uint4(0u, 0u, 0u, 0u);
      for (int i = 0; i < kMaxStages + kMaxApplyStages; ++i) mbar_init(bars + i, 1);
      mbar_fence_init();
    }
    for (int r = threadIdx.x; r < c; r += kThreads) rowbase[r] = (g * c + r) * n;
    __syncthreads();
  }
};

// A direct stage by the bulk copy engine: columns [n0, stop) of rows [0, c)
// of a, then (b) of b, into st (row pitch kMmaPitch), every row starting
// 16-byte aligned and stop - n0 a multiple of 8. Warp 0 issues, a lane a
// row; lane 0 first tells `bar` the bytes to expect. Columns past stop keep
// what they held.
__device__ __forceinline__ void bulk_stage(bf16* st, const bf16* a, const bf16* b, int c,
                                           const int64_t* rowbase, int64_t n0, int64_t stop,
                                           uint64_t* bar) {
  if (threadIdx.x >= 32) return;
  const unsigned int bytes = 2u * static_cast<unsigned int>(stop - n0);
  const int rows = b ? 2 * c : c;
  if (threadIdx.x == 0) mbar_arrive_expect(bar, bytes * rows);
  __syncwarp();
  for (int r = threadIdx.x; r < rows; r += 32)
    bulk_copy(st + r * kMmaPitch, (r < c ? a + rowbase[r] : b + rowbase[r - c]) + n0, bytes, bar);
}

// Element offset, from a staged tile's start, of the row this lane gives
// ldmatrix for 16-row tile mi (rows 16 mi + lane % 16, columns + 8 (lane /
// 16)), or -1 past c: that lane reads the zero line.
__device__ __forceinline__ int frag_offset(int mi, int c) {
  const int lane = threadIdx.x & 31, r = 16 * mi + (lane & 15);
  return r < c ? r * kMmaPitch + (lane >> 4) * 8 : -1;
}
__device__ __forceinline__ const bf16* frag_row(const bf16* tile, int off, int kk,
                                                const bf16* zero) {
  return off >= 0 ? tile + off + kk : zero;
}

// The block's sums over columns [col0, col_end) of one g (q, k: its c x n
// rows in tensors of `total` elements; c <= 8 NT) on the tensor cores,
// returned as red (in sm.aux): red[i * c + j] = q_i . k_j, then (kNorms)
// |q_i|^2 at c * c + i and |k_j|^2 at c * c + c + j. `after_loop()` runs
// once the ring and the aux area are free, before the reduction (P1 issues
// v's first copies there). Ends with a block barrier.
template <int NT, bool kNorms, typename AfterLoop>
__device__ float* mma_block_scores(const bf16* __restrict__ q, const bf16* __restrict__ k, int c,
                                   int64_t total, int64_t col0, int64_t col_end, int stages,
                                   bool direct, const MmaSmem& sm, AfterLoop&& after_loop) {
  constexpr int MT = (NT + 1) / 2;  // 16-row tiles of q (and of k)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int stage_elems = 2 * c * kMmaPitch;
  const int steps = static_cast<int>((col_end - col0 + kMmaTile - 1) / kMmaTile);
  const RowStream qs{q, total, sm.rowbase, c, kMmaTile,
                     static_cast<int>((reinterpret_cast<uintptr_t>(q) & 15) >> 1)};
  const RowStream ks{k, total, sm.rowbase, c, kMmaTile,
                     static_cast<int>((reinterpret_cast<uintptr_t>(k) & 15) >> 1)};
  auto issue = [&](int step) {
    if (step < steps) {
      const int slot = step % stages;
      bf16* st = sm.ring + slot * stage_elems;
      const int64_t n0 = col0 + static_cast<int64_t>(step) * kMmaTile;
      const int64_t stop = min64(col_end, n0 + kMmaTile);
      if (direct) {
        bulk_stage(st, q, k, c, sm.rowbase, n0, stop, sm.bars + slot);
      } else {
        qs.issue(st, n0, stop, false);
        ks.issue(st + c * kMmaPitch, n0, stop, false);
      }
    }
    if (!direct) cp_async_commit();  // an empty group past the end keeps the count in step
  };
  for (int s = 0; s < stages - 1; ++s) issue(s);

  int off[MT];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) off[mi] = frag_offset(mi, c);
  float sum[MT][NT][4], nrm[2][MT][2];  // running sums over the steps
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
    for (int e = 0; e < 4 * NT; ++e) sum[mi][e >> 2][e & 3] = 0.0f;
    nrm[0][mi][0] = nrm[0][mi][1] = nrm[1][mi][0] = nrm[1][mi][1] = 0.0f;
  }

  for (int s = 0; s < steps; ++s) {
    if (direct)  // step s has landed
      mbar_wait(sm.bars + s % stages, (s / stages) & 1);
    else  // (this thread's copies)
      cp_async_wait_dyn(stages - 2);
    __syncthreads();        // ... everyone's; step s - 1 is no longer read
    issue(s + stages - 1);  // into step s - 1's stage
    bf16* tq = sm.ring + (s % stages) * stage_elems;
    bf16* tk = tq + c * kMmaPitch;
    const int width =
        static_cast<int>(min64(kMmaTile, col_end - col0 - static_cast<int64_t>(s) * kMmaTile));
    if (!direct) {
      qs.realign(tq, sm.aux, width);
      ks.realign(tk, sm.aux + c * kMmaPitch, width);
      __syncthreads();
      tq = sm.aux;
      tk = sm.aux + c * kMmaPitch;
    } else if (width & 15) {  // the last k16 step's 8 columns past the copy: zeros
      for (int r = threadIdx.x; r < 2 * c; r += kThreads)
        *reinterpret_cast<uint4*>(tq + r * kMmaPitch + width) = make_uint4(0u, 0u, 0u, 0u);
      fence_proxy_async();  // before later bulk copies into the same bytes
      __syncthreads();
    }
    float acc[MT][NT][4], nacc[2][MT][2][4];  // this step's sums
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
      for (int e = 0; e < 4 * NT; ++e) acc[mi][e >> 2][e & 3] = 0.0f;
#pragma unroll
      for (int e = 0; e < 16; ++e) nacc[e >> 3][mi][(e >> 2) & 1][e & 3] = 0.0f;
    }
    for (int kk = 16 * warp; kk < width; kk += 16 * kWarps) {  // none reads past width's k16
      uint32_t a[MT][4], b[MT][4];  // a[mi][0, 2]: rows 0-7 of tile mi, [1, 3]: rows 8-15
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        ldmatrix_x4(a[mi], frag_row(tq, off[mi], kk, sm.zero));
        ldmatrix_x4(b[mi], frag_row(tk, off[mi], kk, sm.zero));
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)  // k's 8-row tile nt: half nt % 2 of its 16-row tile
          mma_bf16(acc[mi][nt], a[mi], b[nt >> 1][nt & 1], b[nt >> 1][2 + (nt & 1)]);
      if (kNorms) {
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (2 * mi + h >= NT) continue;  // rows past 8 NT: none
            mma_bf16(nacc[0][mi][h], a[mi], a[mi][h], a[mi][2 + h]);
            mma_bf16(nacc[1][mi][h], b[mi], b[mi][h], b[mi][2 + h]);
          }
      }
    }
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
      for (int e = 0; e < 4 * NT; ++e) sum[mi][e >> 2][e & 3] += acc[mi][e >> 2][e & 3];
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // the diagonal: row 8 h + g8 of lanes with g8 / 2 == t4
        const bool odd = g8 & 1;      // (a select: a lane-dependent index would leave registers)
        nrm[0][mi][h] += odd ? nacc[0][mi][h][2 * h + 1] : nacc[0][mi][h][2 * h];
        nrm[1][mi][h] += odd ? nacc[1][mi][h][2 * h + 1] : nacc[1][mi][h][2 * h];
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring and the aux area are free
  after_loop();

  const int e_count = entries(c, kNorms);
  float* part = reinterpret_cast<float*>(sm.aux);
  float* red = part + kWarps * e_count;
  float* mine = part + warp * e_count;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 16 * mi + g8 + 8 * (e >> 1), j = 8 * nt + 2 * t4 + (e & 1);
        if (i < c && j < c) mine[i * c + j] = sum[mi][nt][e];
      }
    if (kNorms && (g8 >> 1) == t4) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * mi + 8 * h + g8;
        if (2 * mi + h < NT && r < c) {
          mine[c * c + r] = nrm[0][mi][h];
          mine[c * c + c + r] = nrm[1][mi][h];
        }
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < e_count; e += kThreads) {  // the warps in warp order
    float s = part[e];
    for (int w = 1; w < kWarps; ++w) s += part[w * e_count + e];
    red[e] = s;
  }
  __syncthreads();
  return red;
}

// The cluster's sums of red over its blocks, rank 0 first, for entries
// [lo, hi): put(e, sum). Every block that asks for an entry gets the same
// bits. kMax: the arm's largest cluster (kMaxCluster or kMmaMaxCluster),
// the remote loads a thread keeps in flight. Starts and ends with a cluster
// barrier (the second keeps each block's shared memory alive until the
// others have read it).
template <int kMax, typename Put>
__device__ __forceinline__ void cluster_sum(float* red, int lo, int hi, Put&& put) {
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();  // every block's red is written
  const int blocks = static_cast<int>(cl.num_blocks());
  for (int e = lo + static_cast<int>(threadIdx.x); e < hi; e += kThreads) {
    float v[kMax];
#pragma unroll
    for (int r = 0; r < kMax; ++r)  // every remote load in flight, then the sum in order
      v[r] = r < blocks ? cl.map_shared_rank(red, r)[e] : 0.0f;
    float s = v[0];
#pragma unroll
    for (int r = 1; r < kMax; ++r)
      if (r < blocks) s += v[r];
    put(e, s);
  }
  cl.sync();
}

// Let `fn` run in clusters of more than kMaxCluster (8) blocks, once per kernel and
// device (an H100 holds 16 clusters of 12 at two blocks an SM). Returns a
// cudaError_t code.
inline int allow_wide_clusters(const void* fn) {
  static std::mutex mu;
  static std::set<std::pair<const void*, int>> done;
  int device = 0;
  cudaGetDevice(&device);
  std::lock_guard<std::mutex> lock(mu);
  if (done.count({fn, device})) return 0;
  const cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) done.insert({fn, device});
  return static_cast<int>(err);
}

// Launch `kernel` on grid (splits, g) in clusters of `splits` blocks along
// x, with `smem` bytes of dynamic shared memory; returns a cudaError_t code.
template <typename... KArgs, typename... Args>
int launch_cluster(void (*kernel)(KArgs...), int splits, unsigned int g, int64_t smem,
                   cudaStream_t stream, Args... args) {
  const int capped = raise_smem_cap(reinterpret_cast<const void*>(kernel), smem);
  if (capped) return capped;
  if (splits > kMaxCluster) {
    const int wide = allow_wide_clusters(reinterpret_cast<const void*>(kernel));
    if (wide) return wide;
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
// blocks of `chunk` columns (a multiple of kTile), none empty, one cluster
// of at most max_cluster (the arm's: kMaxCluster or kMmaMaxCluster);
// vec elements (1, 2, or 16 bytes' worth) dividing n and every base's
// offset from a 16-byte boundary.
inline bool split_ok(int64_t n, int splits, int64_t chunk, int max_cluster) {
  return n >= 1 && splits >= 1 && splits <= max_cluster && chunk >= kTile && chunk % kTile == 0 &&
         (splits - 1) * chunk < n && splits * chunk >= n;
}
inline bool vec_ok(int vec, int itemsize, int64_t n, std::initializer_list<const void*> bases) {
  if (!(vec == 1 || vec == 2 || vec * itemsize == 16) || n % vec) return false;
  for (const void* p : bases)
    if (reinterpret_cast<uintptr_t>(p) % (static_cast<uintptr_t>(vec) * itemsize)) return false;
  return true;
}
// The bf16 arm's chunks, ring and copy mode are ones it takes: chunks of
// whole stages; 2 .. kMaxStages stages; vec 8 (direct: n and every base put
// every row on a 16-byte boundary) or 1 (realigned: any start).
inline bool mma_ok(int64_t chunk, int stages, int vec, int64_t n,
                   std::initializer_list<const void*> bases) {
  return chunk % kMmaTile == 0 && stages >= 2 && stages <= kMaxStages &&
         (vec == 1 || (vec == 8 && vec_ok(8, 2, n, bases)));
}

// Clusters of `cluster` blocks of `kernel` (smem bytes of dynamic shared
// memory each) that the card holds at once (cudaOccupancyMaxActiveClusters:
// a cluster takes SMs of one GPC, so fewer blocks fit than SMs x blocks an
// SM). The plan keeps its clusters within one wave of them. Returns the
// count, or minus a cudaError_t code.
template <typename... KArgs>
int active_clusters(void (*kernel)(KArgs...), int cluster, int64_t smem) {
  const int capped = raise_smem_cap(reinterpret_cast<const void*>(kernel), smem);
  if (capped) return -capped;
  if (cluster > kMaxCluster) {
    const int wide = allow_wide_clusters(reinterpret_cast<const void*>(kernel));
    if (wide) return -wide;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>(cluster), 1);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned int>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int count = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(&count, kernel, &cfg);
  return err != cudaSuccess ? -static_cast<int>(err) : count;
}

}  // namespace qk
}  // namespace hvi_cidnet
