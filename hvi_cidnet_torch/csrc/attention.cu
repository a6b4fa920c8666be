// K5: channel ("transposed") attention of the CAB blocks on NCHW q/k/v,
// read as (B, C, N) with N = H*W.
//
// Replaces the Pallas kernel hvi_cidnet_tpu/ops/attention.py:181
// _attn_kernel (call :239 in attention_bcn_pallas :217), whose (B, C, N)
// operand is exactly the port's NCHW activation. The plain twin is
// channel_attention in hvi_cidnet_torch/ops/attention.py (dispatcher in
// ops/attention_cuda.py). Per image:
//
//   S = q k^T over N, in fp32;
//   optionally S = (S * rsqrt(max(|q_r|^2, 1e-24))) * rsqrt(max(|k_c|^2, 1e-24))
//     (F.normalize of q and k over space, hoisted past the product);
//   S *= temperature[head(r)] per row;
//   block-diagonal head mask, then an fp32 softmax per row;
//   optionally A = W attn, W the (C_out, C_in) project_out weight in fp32
//     (proj(attn v) == (W attn) v);
//   out = A.to(v.dtype) v, accumulated in fp32 and rounded once.
//
// Three launches behind one C entry point (one call = one CAB site):
//
// 1. scores: grid (splits, B, item groups). Blocks run in parallel on the
//    SMs (the TPU grid ran in order on one core), so the contraction over N
//    is split: each long-lived block walks `chunk` columns of one image and
//    writes, for its slice, the C x cp block-diagonal entries of S plus
//    |q_r|^2 and |k_c|^2 to a partial buffer (B, splits, C*cp + 2C).
// 2. rows: grid (heads * kRowsCluster, B), a cluster of kRowsCluster blocks
//    per (head, image). The cluster reduces the head's partials over the
//    splits in a fixed order (no atomics: two calls give the same bits),
//    each block a slice, and shares the sums through distributed shared
//    memory; then norms, temperature and softmax per row, then the head's
//    columns of A (folded: A[:, head] = W[:, head] attn_head) or its rows
//    (unfolded: attn on the diagonal block, zeros elsewhere), in v's type.
// 3. apply: out = A v, grid (splits, B), long-lived blocks over N.
//
// Bound: the bytes of q, k, v and out (the C x C matrices are tiny): per
// column of one image 8C bytes in bf16 against ~2C(C + cp + 2) operations,
// at most 41 operations a byte, far below the 295 of the tensor cores.
//
// bf16 (serving): both products on the tensor cores, mma.sync m16n8k16
// bf16 -> fp32 fed by ldmatrix. A bf16 x bf16 product is exact in fp32, as
// the twin's fp32 bmm of the widened operands; A is already rounded to
// bf16, so the apply equals the twin's bf16 bmm up to the order of its fp32
// sum. q, k and v stream through rings of shared-memory stages by 16-byte
// cp.async. Where q, k, v and out start 16-byte aligned and N % 8 == 0
// (levels 1 and 2 of the forward), every row does, and the products read
// the stages as they land ("direct"). Elsewhere rows start anywhere (N =
// 3750 puts a bf16 row on a 4-byte boundary; tests use odd N and tensors 2
// bytes past a 16-byte boundary): each row is copied as its 16-byte-aligned
// cover, at a per-row shift into the stage (a chunk that leaves the tensor
// is copied element by element: nothing is read past it), and a
// realignment pass moves each row to shift 0 in a padded tile, zeroing
// columns past the block's slice. Tiles have pitch tile + 8 (the eight
// rows of an ldmatrix fall on distinct banks); rows C .. C16 (C rounded up
// to 16) are zero. The scores pass computes only the m16 x n8 tiles that
// hold block-diagonal entries: a work item is one 16-row tile of q and up
// to kItemTiles 8-row tiles of k, so one A fragment feeds up to four
// products; |q_r|^2 and |k_c|^2 are the diagonals of X_m X_m^T per 16-row
// tile, on the tensor cores from the same fragments.
//
// fp32: CUDA-core FMAs (TF32 would keep three digits). Scores: a block
// stages 32 columns at a time (channel-minor, odd pitch: no bank
// conflicts) and accumulates the block-diagonal entries it owns; apply: A
// and a C x 64 tile of v in shared memory.
//
// The launch plan (splits, tiles, stages, threads, shared memory, the
// scratch layout) comes from the host: ops/attention_cuda.py:attention_plan.
#include <algorithm>
#include <mutex>
#include <set>
#include <utility>

#include <cooperative_groups.h>

#include "common.cuh"
#include "mma.cuh"

namespace hvi_cidnet {

// The host's plan: ops/attention_cuda.py:AttentionPlan, field for field
// (outside the anonymous namespace: the C entry point takes it).
struct AttentionPlan {
  int64_t splits, chunk, score_tile, score_threads, score_groups, items_per_warp, score_smem;
  int64_t apply_splits, apply_chunk, apply_tile, apply_threads, apply_mt, apply_smem;
  int64_t rows_smem, part_stride, a_offset, scratch_bytes, direct, score_stages;
};

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxChannels = 192;
constexpr int kMaxThreads = 512;
constexpr int kMaxSmem = 232448;     // shared memory one block may use (227 KB)
// fp32 arm
constexpr int kAttnThreads = 256;
constexpr int kScoreTile = 32;       // spatial columns staged per step of the scores pass
constexpr int kMaxEntriesPerThread = 16;
constexpr int kEntriesPerBlock = kAttnThreads * kMaxEntriesPerThread;
constexpr int kApplyTile = 64;       // spatial columns per block of the apply
constexpr int kApplyRows = 8;        // output rows per accumulator set
// bf16 arm: ops/attention_cuda.py APPLY_STAGES, ROWS_CLUSTER, ITEM_TILES, APPLY_NT,
// NORM_SLOTS, ROWS_THREADS; the scores ring (2 stages direct, 4 realigned) comes with the plan
constexpr int kApplyStages = 3;
constexpr int kRowsCluster = 8;      // rows-pass blocks per (head, image): one cluster
constexpr int kItemTiles = 4;        // 8-row k tiles per scores work item
constexpr int kApplyNT = 4;          // 8-column output tiles per warp of the apply
constexpr int kNormSlots = 3;        // norm items per warp of the scores pass
constexpr int kRowsThreads = 256;

__host__ __device__ inline int round16(int c) { return (c + 15) / 16 * 16; }

// Work item `idx` of the scores pass: 16-row q tile `mi` against 8-row k
// tiles [n0, n1). Tile mi needs the k rows of every head its rows touch;
// that range is cut into items of kItemTiles tiles. False past the last.
__host__ __device__ inline bool score_item(int idx, int c, int cp, int* mi, int* n0, int* n1) {
  for (int m = 0; m * 16 < c; ++m) {
    const int r1 = 16 * m + 15 < c ? 16 * m + 15 : c - 1;
    const int lo = (16 * m / cp) * cp / 8, hi = ((r1 / cp + 1) * cp + 7) / 8;
    const int cnt = (hi - lo + kItemTiles - 1) / kItemTiles;
    if (idx < cnt) {
      *mi = m;
      *n0 = lo + idx * kItemTiles;
      *n1 = hi < *n0 + kItemTiles ? hi : *n0 + kItemTiles;
      return true;
    }
    idx -= cnt;
  }
  return false;
}

inline int score_items(int c, int cp) {
  int count = 0, mi, n0, n1;
  while (score_item(count, c, cp, &mi, &n0, &n1)) ++count;
  return count;
}


// Rows [0, rows) of one image's (rows, n) bf16 matrix, columns [n0, n_stop)
// with n0 a multiple of 8, through the ring. `rowbase[r]` (shared memory)
// is the element offset of row r in the tensor `base` of `total` elements.
struct RowStream {
  const bf16* base;
  int64_t total;
  const int64_t* rowbase;
  int rows, tile, mis;  // mis: base's misalignment to 16 bytes, in elements

  __device__ __forceinline__ int pitch() const { return tile + 8; }
  // where element n0 + j of row r sits in a raw stage: r * pitch + shift(r) + j
  __device__ __forceinline__ int shift(int r) const { return static_cast<int>((rowbase[r] + mis) & 7); }

  // Issue the copies of columns [n0, n_stop) into `raw` (no commit). A warp
  // takes max(1, 128 / tile) rows at a time, a lane a 16-byte chunk of a
  // row's cover (at most tile / 8 + 1 chunks). With `direct` (every shift
  // 0), the chunks of the stage past n_stop are zeroed: products read it.
  __device__ __forceinline__ void issue(bf16* raw, int64_t n0, int64_t n_stop, bool direct) const {
    const int per_row = min(32, tile / 4);  // lanes per row, a power of two
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
    const int sub = lane / per_row, lane_in_row = lane & (per_row - 1);
    const int rows_per_step = 32 / per_row;
    for (int r = warp * rows_per_step + sub; r < rows; r += warps * rows_per_step) {
      const int64_t g0 = rowbase[r] + n0;
      const int64_t first = g0 - ((g0 + mis) & 7);
      const int chunks = static_cast<int>((g0 + (n_stop - n0) - first + 7) >> 3);
      for (int i = lane_in_row; i <= tile / 8; i += per_row) {
      bf16* dst = raw + r * pitch() + 8 * i;
      if (i < chunks) {
        const int64_t e = first + 8 * i;
        if (e >= 0 && e + 8 <= total) {
          cp_async16(dst, base + e);
        } else {  // the tensor's ragged first or last chunk
#pragma unroll
          for (int j = 0; j < 8; ++j)
            dst[j] = (e + j >= 0 && e + j < total) ? base[e + j] : __float2bfloat16_rn(0.0f);
        }
      } else if (direct && 8 * i < tile) {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      }
      }
    }
  }

  // Move each row of `raw` to shift 0 in `dst` (pitch tile + 8), zeroing
  // columns at or past `valid`.
  __device__ __forceinline__ void realign(const bf16* raw, bf16* dst, int valid) const {
    const int chunks = tile >> 3, log_chunks = __ffs(chunks) - 1;
    for (int idx = threadIdx.x; idx < rows * chunks; idx += blockDim.x) {
      const int r = idx >> log_chunks, i = idx & (chunks - 1);
      const int s = shift(r);
      const uint32_t* w = reinterpret_cast<const uint32_t*>(raw + r * pitch()) + (s >> 1) + 4 * i;
      const uint32_t w4 = w[4];
      uint32_t o[4] = {w[0], w[1], w[2], w[3]};
      const unsigned int bits = (s & 1) * 16;
      o[0] = __funnelshift_r(o[0], o[1], bits);
      o[1] = __funnelshift_r(o[1], o[2], bits);
      o[2] = __funnelshift_r(o[2], o[3], bits);
      o[3] = __funnelshift_r(o[3], w4, bits);
      const int left = valid - 8 * i;  // values of this chunk inside the slice
      if (left < 8) {
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const uint32_t keep_lo = 2 * m < left ? 0xffffu : 0u;
          const uint32_t keep_hi = 2 * m + 1 < left ? 0xffff0000u : 0u;
          o[m] &= keep_lo | keep_hi;
        }
      }
      *reinterpret_cast<uint4*>(dst + r * pitch() + 8 * i) = make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
};

// zero rows [from, to) of a (to, pitch) bf16 tile
__device__ __forceinline__ void zero_rows(bf16* t, int from, int to, int pitch) {
  for (int i = threadIdx.x; i < (to - from) * pitch / 8; i += blockDim.x)
    reinterpret_cast<uint4*>(t + from * pitch)[i] = make_uint4(0u, 0u, 0u, 0u);
}

// Pass 1, bf16: scores on the tensor cores. Shared memory: STAGES (2 direct, 4 realigned) raw
// stages of q and k (2 c16 x (tile + 8) each, rows c .. c16 zero), the
// realigned q and k tiles (2 c16 x (tile + 8), unless `direct`), each
// tensor's row offsets (2 c int64). With `direct` (q and k 16-byte aligned,
// n % 8 == 0: every row starts 16-byte aligned) the products read the raw
// stages and the realignment pass and its barrier drop out.
// Besides the block-diagonal items, a warp owns up to kNormSlots norm
// items (tensor z, 16-row tile m): the diagonal of X_m X_m^T, from the
// same fragment as both operands (block group 0 only).
template <int IPW, int STAGES>
__global__ void __launch_bounds__(kMaxThreads)
    scores_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      float* __restrict__ part, int64_t total, int c, int cp, int64_t n,
                      int64_t chunk, int splits, int64_t stride, int tile, int items_per_block,
                      int direct) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int c16 = round16(c), pitch = tile + 8;
  bf16* raw = reinterpret_cast<bf16*>(smem_raw);
  const int stage_elems = 2 * c16 * pitch;
  bf16* qa = raw + STAGES * stage_elems;  // realigned q, then k
  bf16* ka = qa + c16 * pitch;
  int64_t* rowbase = reinterpret_cast<int64_t*>(direct ? qa : ka + c16 * pitch);

  const int split = blockIdx.x;
  const int64_t b = blockIdx.y;
  const int64_t n_begin = split * chunk;
  const int64_t n_end = min64(n, n_begin + chunk);
  const int steps = static_cast<int>((n_end - n_begin + tile - 1) / tile);
  for (int r = threadIdx.x; r < c; r += blockDim.x) rowbase[r] = (b * c + r) * n;
  __syncthreads();
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(q) & 15) >> 1);
  const int mis_k = static_cast<int>((reinterpret_cast<uintptr_t>(k) & 15) >> 1);
  const RowStream qs{q, total, rowbase, c, tile, mis};
  const RowStream ks{k, total, rowbase, c, tile, mis_k};

  auto issue = [&](int step) {
    if (step < steps) {
      bf16* st = raw + (step % STAGES) * stage_elems;
      const int64_t n0 = n_begin + static_cast<int64_t>(step) * tile;
      const int64_t stop = min64(n_end, n0 + tile);
      qs.issue(st, n0, stop, direct);
      ks.issue(st + c16 * pitch, n0, stop, direct);
    }
    cp_async_commit();  // an empty group past the end keeps the count in step
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);

  // rows c .. c16 of every tile stay zero
  for (int s = 0; s < STAGES; ++s) {
    zero_rows(raw + s * stage_elems, c, c16, pitch);
    zero_rows(raw + s * stage_elems + c16 * pitch, c, c16, pitch);
  }
  if (!direct) {
    zero_rows(qa, c, c16, pitch);
    zero_rows(ka, c, c16, pitch);
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  int item_m[IPW], item_n0[IPW], item_n1[IPW];
#pragma unroll
  for (int j = 0; j < IPW; ++j) {
    const int idx = blockIdx.z * items_per_block + warp + j * warps;
    if (j * warps + warp >= items_per_block ||
        !score_item(idx, c, cp, &item_m[j], &item_n0[j], &item_n1[j])) {
      item_m[j] = 0;
      item_n0[j] = item_n1[j] = 0;  // no tiles
    }
  }
  float acc[IPW][kItemTiles][4];
#pragma unroll
  for (int j = 0; j < IPW; ++j)
#pragma unroll
    for (int t = 0; t < kItemTiles; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][t][e] = 0.0f;
  // norm items u = (warps - 1 - warp) + j * warps < 2 * mtiles: tensor u / mtiles,
  // tile u % mtiles (from the last warp down: the first warps hold the items)
  const int mtiles = c16 / 16;
  const int norm_items = blockIdx.z == 0 ? 2 * mtiles : 0;
  float nacc[kNormSlots][2][4];
#pragma unroll
  for (int j = 0; j < kNormSlots; ++j)
#pragma unroll
    for (int e = 0; e < 8; ++e) nacc[j][e >> 2][e & 3] = 0.0f;

  for (int s = 0; s < steps; ++s) {
    cp_async_wait<STAGES - 2>();  // step s has landed (this thread's copies)
    __syncthreads();               // ... everyone's; step s - 1 is no longer read
    issue(s + STAGES - 1);        // into step s - 1's stage
    const bf16* tq = raw + (s % STAGES) * stage_elems;
    const bf16* tk = tq + c16 * pitch;
    if (!direct) {
      const int valid = static_cast<int>(min64(tile, n_end - n_begin - static_cast<int64_t>(s) * tile));
      qs.realign(tq, qa, valid);
      ks.realign(tk, ka, valid);
      __syncthreads();
      tq = qa;
      tk = ka;
    }

    for (int kk = 0; kk < tile; kk += 16) {
#pragma unroll
      for (int j = 0; j < IPW; ++j) {
        if (item_n1[j] <= item_n0[j]) continue;  // warp-uniform
        uint32_t a[4];
        ldmatrix_x4(a, tq + (item_m[j] * 16 + (lane & 15)) * pitch + kk + (lane >> 4) * 8);
#pragma unroll
        for (int t = 0; t < kItemTiles; ++t) {
          const int nt = item_n0[j] + t;
          if (nt < item_n1[j]) {
            uint32_t bb[2];
            ldmatrix_x2(bb, tk + (nt * 8 + (lane & 7)) * pitch + kk + ((lane >> 3) & 1) * 8);
            mma_bf16(acc[j][t], a, bb[0], bb[1]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kNormSlots; ++j) {
        const int u = warps - 1 - warp + j * warps;
        if (u >= norm_items) continue;  // warp-uniform
        const int z = u >= mtiles, mi = u - z * mtiles;
        uint32_t a[4];  // rows 16 mi .. + 15: a[0], a[2] are rows 0-7, a[1], a[3] rows 8-15
        ldmatrix_x4(a, (z ? tk : tq) + (mi * 16 + (lane & 15)) * pitch + kk + (lane >> 4) * 8);
        mma_bf16(nacc[j][0], a, a[0], a[2]);
        mma_bf16(nacc[j][1], a, a[1], a[3]);
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block

  // the block-diagonal entries of this slice, each in exactly one item
  float* dst = part + (b * splits + split) * stride;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < IPW; ++j) {
#pragma unroll
    for (int t = 0; t < kItemTiles; ++t) {
      const int nt = item_n0[j] + t;
      if (nt >= item_n1[j]) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = item_m[j] * 16 + g + (e >> 1) * 8;
        const int col = nt * 8 + 2 * t4 + (e & 1);
        const int head = r / cp;
        if (r < c && col < c && col / cp == head) dst[r * cp + col - head * cp] = acc[j][t][e];
      }
    }
  }
  // |q_r|^2, then |k_r|^2: the diagonals, rows g and g + 8 of lanes with g == 2 t4 + h
#pragma unroll
  for (int j = 0; j < kNormSlots; ++j) {
    const int u = warps - 1 - warp + j * warps;
    if (u >= norm_items || (g >> 1) != t4) continue;
    const int z = u >= mtiles, mi = u - z * mtiles, h = g & 1;
    if (mi * 16 + g < c) dst[c * cp + z * c + mi * 16 + g] = nacc[j][0][h];
    if (mi * 16 + 8 + g < c) dst[c * cp + z * c + mi * 16 + 8 + g] = nacc[j][1][2 + h];
  }
}

// Pass 3, bf16: out = A v on the tensor cores. A comes from the rows pass
// as (B, c16, c16 + 8), zero-padded. Warp (wm, wn) owns output row tiles
// [wm * MT, wm * MT + MT) and columns [32 wn, 32 wn + 32) of each tile of
// `tile` = 32 * (warps per row group) columns. Shared memory: A (c16 x
// (c16 + 8)), kApplyStages raw stages of v (c16 x (tile + 8), rows c .. c16
// zero), with `direct` (v and out 16-byte aligned, n % 8 == 0) the output
// tile (c16 x (tile + 8)), which leaves through 16-byte stores, else the
// realigned v tile, and v's row offsets (c int64). Without `direct` the
// fragments are stored as they are: 4-byte pairs where the element is
// 4-byte aligned, else 2-byte values.
template <int MT>
__global__ void __launch_bounds__(kMaxThreads)
    apply_mma_kernel(const bf16* __restrict__ a, const bf16* __restrict__ v,
                     bf16* __restrict__ out, int64_t total, int c, int64_t n, int64_t chunk,
                     int tile, int direct) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int c16 = round16(c), pitch = tile + 8, a_pitch = c16 + 8;
  bf16* as = reinterpret_cast<bf16*>(smem_raw);
  bf16* raw = as + c16 * a_pitch;
  const int stage_elems = c16 * pitch;
  bf16* os = raw + kApplyStages * stage_elems;  // the output tile (`direct`)
  bf16* va = os;                               // or the realigned v
  int64_t* rowbase = reinterpret_cast<int64_t*>(os + stage_elems);

  const int64_t b = blockIdx.y;
  const int64_t n_begin = blockIdx.x * chunk;
  const int64_t n_end = min64(n, n_begin + chunk);
  const int steps = static_cast<int>((n_end - n_begin + tile - 1) / tile);
  for (int r = threadIdx.x; r < c; r += blockDim.x) rowbase[r] = (b * c + r) * n;
  __syncthreads();
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(v) & 15) >> 1);
  const RowStream vs{v, total, rowbase, c, tile, mis};

  auto issue = [&](int step) {
    if (step < steps) {
      const int64_t n0 = n_begin + static_cast<int64_t>(step) * tile;
      vs.issue(raw + (step % kApplyStages) * stage_elems, n0, min64(n_end, n0 + tile), direct);
    }
    cp_async_commit();
  };
  // A arrives with step 0's group: the rows pass wrote it in this very
  // layout (c16 x a_pitch, zero-padded), so it is one contiguous span
  const bf16* ab = a + b * c16 * a_pitch;
  for (int i = threadIdx.x; i < c16 * a_pitch / 8; i += blockDim.x) cp_async16(as + 8 * i, ab + 8 * i);
#pragma unroll
  for (int s = 0; s < kApplyStages - 1; ++s) issue(s);
  for (int s = 0; s < kApplyStages; ++s) zero_rows(raw + s * stage_elems, c, c16, pitch);
  if (!direct) zero_rows(va, c, c16, pitch);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wn_count = tile / (8 * kApplyNT);
  const int wm = warp / wn_count, wn = warp - wm * wn_count;
  const int mtiles = c16 / 16;
  const int g = lane >> 2, t4 = lane & 3;
  const bool out4 = (reinterpret_cast<uintptr_t>(out) & 3) == 0;

  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kApplyStages - 2>();
    __syncthreads();  // step s landed; step s - 1's stage and output tile are free
    issue(s + kApplyStages - 1);
    const int64_t n0 = n_begin + static_cast<int64_t>(s) * tile;
    const int valid = static_cast<int>(min64(tile, n_end - n0));
    const bf16* tv = raw + (s % kApplyStages) * stage_elems;
    if (!direct) {
      vs.realign(tv, va, valid);
      __syncthreads();
      tv = va;
    }

    float acc[MT][kApplyNT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int t = 0; t < kApplyNT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][t][e] = 0.0f;
    for (int kk = 0; kk < c16; kk += 16) {
      uint32_t bf[kApplyNT][2];
#pragma unroll
      for (int p = 0; p < kApplyNT / 2; ++p) {
        // matrices: rows kk / kk + 8 of columns 16p / 16p + 8 of this warp's 32
        const int mtx = lane >> 3;
        uint32_t r4[4];
        ldmatrix_x4_trans(r4, tv + (kk + (lane & 7) + (mtx & 1) * 8) * pitch + wn * 32 +
                                  16 * p + (mtx >> 1) * 8);
        bf[2 * p][0] = r4[0];
        bf[2 * p][1] = r4[1];
        bf[2 * p + 1][0] = r4[2];
        bf[2 * p + 1][1] = r4[3];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int mi = wm * MT + i;
        if (mi >= mtiles) continue;  // warp-uniform
        uint32_t af[4];
        ldmatrix_x4(af, as + (mi * 16 + (lane & 15)) * a_pitch + kk + (lane >> 4) * 8);
#pragma unroll
        for (int t = 0; t < kApplyNT; ++t) mma_bf16(acc[i][t], af, bf[t][0], bf[t][1]);
      }
    }
    if (direct) {
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int mi = wm * MT + i;
        if (mi >= mtiles) continue;
#pragma unroll
        for (int t = 0; t < kApplyNT; ++t) {
          const int col = wn * 32 + t * 8 + 2 * t4;
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<__nv_bfloat162*>(os + (mi * 16 + g + 8 * h) * pitch + col) =
                __floats2bfloat162_rn(acc[i][t][2 * h], acc[i][t][2 * h + 1]);
        }
      }
      __syncthreads();  // the output tile is complete; rows start 16-byte aligned
      const int chunks = valid >> 3;
      for (int idx = threadIdx.x; idx < c * chunks; idx += blockDim.x) {
        const int r = idx / chunks, i = idx - r * chunks;
        *reinterpret_cast<uint4*>(out + rowbase[r] + n0 + 8 * i) =
            *reinterpret_cast<const uint4*>(os + r * pitch + 8 * i);
      }
    } else {
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int mi = wm * MT + i;
        if (mi >= mtiles) continue;
#pragma unroll
        for (int t = 0; t < kApplyNT; ++t) {
          const int col = wn * 32 + t * 8 + 2 * t4;  // within the tile
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = mi * 16 + g + 8 * h;
            if (r >= c || col >= valid) continue;
            const int64_t e = rowbase[r] + n0 + col;
            const float lo = acc[i][t][2 * h], hi = acc[i][t][2 * h + 1];
            if (col + 1 < valid && out4 && (e & 1) == 0) {
              *reinterpret_cast<__nv_bfloat162*>(out + e) = __floats2bfloat162_rn(lo, hi);
            } else {
              out[e] = __float2bfloat16_rn(lo);
              if (col + 1 < valid) out[e + 1] = __float2bfloat16_rn(hi);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();
}

// Pass 1, fp32. EPT: entries per thread (a power of two, from the entry count).
template <int EPT>
__global__ void __launch_bounds__(kAttnThreads)
    scores_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      float* __restrict__ part, int c, int cp, int64_t n, int64_t chunk,
                      int splits, int64_t stride) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                   // (kScoreTile, c + 1): column j of the tile, channel-minor
  float* ks = smem + kScoreTile * (c + 1);
  const int cq = c + 1;               // odd pitch: the staging stores fall on distinct banks

  const int split = blockIdx.x;
  const int64_t b = blockIdx.y;
  const int group = blockIdx.z;
  const int64_t n_begin = split * chunk;
  const int64_t n_end = min64(n, n_begin + chunk);
  const float* qb = q + b * c * n;
  const float* kb = k + b * c * n;
  const int entries = c * cp;

  int rq[EPT], rk[EPT];
  float acc[EPT];
#pragma unroll
  for (int i = 0; i < EPT; ++i) {
    const int e = group * kEntriesPerBlock + threadIdx.x + i * kAttnThreads;
    const int r = e < entries ? e / cp : 0;  // out-of-range slots compute on row 0, unwritten
    const int j = e < entries ? e - r * cp : 0;
    rq[i] = r;
    rk[i] = (r / cp) * cp + j;
    acc[i] = 0.0f;
  }
  const bool norms = group == 0 && static_cast<int>(threadIdx.x) < c;
  float qq = 0.0f, kk = 0.0f;

  for (int64_t n0 = n_begin; n0 < n_end; n0 += kScoreTile) {
    for (int idx = threadIdx.x; idx < c * kScoreTile; idx += kAttnThreads) {
      const int ch = idx / kScoreTile, j = idx % kScoreTile;
      const int64_t col = n0 + j;
      const bool in = col < n_end;
      qs[j * cq + ch] = in ? qb[ch * n + col] : 0.0f;
      ks[j * cq + ch] = in ? kb[ch * n + col] : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kScoreTile; ++j) {
      const float* qrow = qs + j * cq;
      const float* krow = ks + j * cq;
#pragma unroll
      for (int i = 0; i < EPT; ++i) acc[i] = fmaf(qrow[rq[i]], krow[rk[i]], acc[i]);
      if (norms) {
        const float a = qrow[threadIdx.x], bb = krow[threadIdx.x];
        qq = fmaf(a, a, qq);
        kk = fmaf(bb, bb, kk);
      }
    }
    __syncthreads();
  }

  float* dst = part + (b * splits + split) * stride;
#pragma unroll
  for (int i = 0; i < EPT; ++i) {
    const int e = group * kEntriesPerBlock + threadIdx.x + i * kAttnThreads;
    if (e < entries) dst[e] = acc[i];
  }
  if (norms) {
    dst[entries + threadIdx.x] = qq;
    dst[entries + c + threadIdx.x] = kk;
  }
}

// Pass 3, fp32: out = A v; grid (N tiles, B), kApplyTile columns x 4 row groups.
__global__ void __launch_bounds__(kAttnThreads)
    apply_f32_kernel(const float* __restrict__ a, const float* __restrict__ v,
                     float* __restrict__ out, int c, int cpad, int64_t n) {
  extern __shared__ __align__(16) float smem[];
  float* as = smem;               // (c, cpad), zero-padded columns
  float* vs = smem + c * cpad;    // (cpad, kApplyTile), zero-padded rows and columns
  const int64_t b = blockIdx.y;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kApplyTile;
  const float* ab = a + b * c * c;
  const float* vb = v + b * c * n;

  for (int idx = threadIdx.x; idx < c * cpad; idx += kAttnThreads) {
    const int r = idx / cpad, d = idx % cpad;
    as[idx] = d < c ? ab[r * c + d] : 0.0f;
  }
  for (int idx = threadIdx.x; idx < cpad * kApplyTile; idx += kAttnThreads) {
    const int d = idx / kApplyTile, j = idx % kApplyTile;
    const int64_t col = n0 + j;
    vs[idx] = (d < c && col < n) ? vb[d * n + col] : 0.0f;
  }
  __syncthreads();

  constexpr int kGroups = kAttnThreads / kApplyTile;
  const int j = threadIdx.x % kApplyTile;
  const int g = threadIdx.x / kApplyTile;
  const int64_t col = n0 + j;
  for (int r0 = g * kApplyRows; r0 < c; r0 += kGroups * kApplyRows) {
    float acc[kApplyRows];
    const float4* arow[kApplyRows];
#pragma unroll
    for (int i = 0; i < kApplyRows; ++i) {
      acc[i] = 0.0f;
      const int r = min(r0 + i, c - 1);  // rows past c read row c-1 and are not written
      arow[i] = reinterpret_cast<const float4*>(as + r * cpad);
    }
    for (int d4 = 0; d4 < cpad / 4; ++d4) {
      const float v0 = vs[(4 * d4 + 0) * kApplyTile + j];
      const float v1 = vs[(4 * d4 + 1) * kApplyTile + j];
      const float v2 = vs[(4 * d4 + 2) * kApplyTile + j];
      const float v3 = vs[(4 * d4 + 3) * kApplyTile + j];
#pragma unroll
      for (int i = 0; i < kApplyRows; ++i) {
        const float4 w = arow[i][d4];
        acc[i] = fmaf(w.x, v0, acc[i]);
        acc[i] = fmaf(w.y, v1, acc[i]);
        acc[i] = fmaf(w.z, v2, acc[i]);
        acc[i] = fmaf(w.w, v3, acc[i]);
      }
    }
    if (col < n) {
#pragma unroll
      for (int i = 0; i < kApplyRows; ++i)
        if (r0 + i < c) out[(b * c + r0 + i) * n + col] = acc[i];
    }
  }
}

// Pass 2: one cluster of kRowsCluster blocks per (head, image). Shared
// memory: the head's cp x cp scores (softmaxed in place), then |q_r|^2 of
// its rows and |k_c|^2 of its columns. Block rank r of the cluster sums
// the splits of the r-th slice of these values (at batch 1 there are a few
// hundred splits and only `heads` clusters), then every block gathers the
// other slices through distributed shared memory, runs the softmax of all
// rows, and writes every kRowsCluster-th output of the head. A is written as (B, a_rows, a_pitch): (c, c) in fp32, the apply's
// shared-memory image (c16, c16 + 8) in bf16, whose padding block 0 zeroes.
template <typename T, typename TW>
__global__ void __launch_bounds__(kRowsThreads)
    rows_kernel(const float* __restrict__ part, const float* __restrict__ temperature,
                const TW* __restrict__ wproj, T* __restrict__ a_out, int c, int cp, int splits,
                int64_t stride, int normalize, int a_rows, int a_pitch) {
  extern __shared__ __align__(16) float vals[];
  namespace cg = cooperative_groups;
  cg::cluster_group cl = cg::this_cluster();
  const int rank = static_cast<int>(cl.block_rank());
  const int head = blockIdx.x / kRowsCluster;
  const int64_t b = blockIdx.y;
  const int base = head * cp;
  const int entries = c * cp;
  const int nv = cp * cp + 2 * cp;
  const int per = (nv + kRowsCluster - 1) / kRowsCluster;

  // This block's slice [lo, hi) of the values, summed over the splits in
  // split order: `slices` threads a value, each over a run of splits, then
  // the runs in order.
  const float* src = part + b * splits * stride;
  const int lo = rank * per, cnt = max(0, min(nv, lo + per) - lo);
  const int slices = max(1, kRowsThreads / max(1, cnt));
  const int span = (splits + slices - 1) / slices;
  float* runs = vals + nv;  // [slices][cnt]
  for (int t = threadIdx.x; t < cnt * slices; t += kRowsThreads) {
    const int j = t / cnt, i = lo + t - j * cnt;
    const int64_t off = i < cp * cp ? static_cast<int64_t>(base) * cp + i
                        : i < cp * cp + cp ? entries + base + (i - cp * cp)
                                           : entries + c + base + (i - cp * cp - cp);
    const int sp_end = min(splits, (j + 1) * span);
    // sixteen loads in flight, then added in order
    float s = 0.0f;
    int sp = j * span;
    for (; sp + 16 <= sp_end; sp += 16) {
      float t[16];
#pragma unroll
      for (int u = 0; u < 16; ++u) t[u] = src[(sp + u) * stride + off];
#pragma unroll
      for (int u = 0; u < 16; ++u) s += t[u];
    }
    for (; sp < sp_end; ++sp) s += src[sp * stride + off];
    if (slices == 1) vals[i] = s;
    else runs[t] = s;  // slices * cnt <= kRowsThreads
  }
  if (slices > 1) {
    __syncthreads();
    for (int i = threadIdx.x; i < cnt; i += kRowsThreads) {
      float s = 0.0f;
      for (int j = 0; j < slices; ++j) s += runs[j * cnt + i];
      vals[lo + i] = s;
    }
  }
  cl.sync();  // every slice is summed
  for (int i = threadIdx.x; i < nv; i += kRowsThreads) {
    const int owner = i / per;
    if (owner != rank) vals[i] = cl.map_shared_rank(vals, owner)[i];
  }
  cl.sync();  // no block reads another's values any more

  const float t = temperature[head];
  for (int r = threadIdx.x; r < cp; r += kRowsThreads) {
    float* row = vals + r * cp;
    const float* kn = vals + cp * cp + cp;
    const float inv_q = rsqrtf(fmaxf(vals[cp * cp + r], 1e-24f));
    float m = __int_as_float(0xff800000);  // -inf
    for (int j = 0; j < cp; ++j) {
      float s = row[j];
      if (normalize) s = (s * inv_q) * rsqrtf(fmaxf(kn[j], 1e-24f));
      s = s * t;
      row[j] = s;
      m = fmaxf(m, s);
    }
    float sum = 0.0f;
    for (int j = 0; j < cp; ++j) {
      row[j] = expf(row[j] - m);
      sum += row[j];
    }
    for (int j = 0; j < cp; ++j) row[j] = row[j] / sum;
  }
  __syncthreads();

  T* ab = a_out + b * a_rows * a_pitch;
  const int first = rank * kRowsThreads + threadIdx.x, step = kRowsCluster * kRowsThreads;
  if (head == 0) {  // the padding: columns c .. a_pitch of every row, rows c .. a_rows
    const int wide = a_pitch - c;
    for (int i = first; i < a_rows * wide; i += step) {
      const int r = i / wide;
      ab[r * a_pitch + c + i - r * wide] = from_f32<T>(0.0f);
    }
    for (int i = first; i < (a_rows - c) * c; i += step)
      ab[c * a_pitch + (i / c) * a_pitch + i % c] = from_f32<T>(0.0f);
  }
  if (wproj == nullptr) {  // rows [base, base + cp): attn on the head's block, zeros elsewhere
    for (int i = first; i < cp * c; i += step) {
      const int r = i / c, d = i - r * c;
      const bool in = d >= base && d < base + cp;
      ab[(base + r) * a_pitch + d] = from_f32<T>(in ? vals[r * cp + d - base] : 0.0f);
    }
  } else {  // columns [base, base + cp): A[row][base + j] = sum_m W[row][base + m] attn[m][j]
    for (int i = first; i < c * cp; i += step) {
      const int row = i / cp, j = i - row * cp;
      float acc = 0.0f;
#pragma unroll 6
      for (int m = 0; m < cp; ++m)
        acc = fmaf(load_f32(wproj, static_cast<int64_t>(row) * c + base + m), vals[m * cp + j],
                   acc);
      ab[row * a_pitch + base + j] = from_f32<T>(acc);
    }
  }
}

// Lift a kernel's dynamic shared-memory cap to what one block may use, once
// per kernel and device: the host work of a call stays small at level 3.
int set_smem(const void* fn, int64_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  static std::mutex mu;
  static std::set<std::pair<const void*, int>> done;
  int device = 0;
  cudaGetDevice(&device);
  std::lock_guard<std::mutex> lock(mu);
  if (done.count({fn, device})) return 0;
  const cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess) done.insert({fn, device});
  return static_cast<int>(err);
}

template <typename K, typename... Args>
int launch(K kernel, dim3 grid, int threads, int64_t smem, cudaStream_t stream, Args... args) {
  int err = set_smem(reinterpret_cast<const void*>(kernel), smem);
  if (err) return err;
  kernel<<<grid, threads, static_cast<size_t>(smem), stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// the same, in clusters of `cluster` blocks along x
template <typename... KArgs, typename... Args>
int launch_cluster(void (*kernel)(KArgs...), int cluster, dim3 grid, int threads, int64_t smem,
                   cudaStream_t stream, Args... args) {
  if (cluster <= 1) return launch(kernel, grid, threads, smem, stream, args...);
  int err = set_smem(reinterpret_cast<const void*>(kernel), smem);
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, static_cast<KArgs>(args)...));
}

// shared memory of the bf16 passes (bytes): bf16 tiles, then the row offsets
int64_t scores_smem_bf16(int c, int tile, int stages, bool direct) {
  return 2LL * ((stages + (direct ? 0 : 1)) * 2 * round16(c)) * (tile + 8) + 8LL * c;
}
int64_t apply_smem_bf16(int c, int tile) {
  const int64_t c16 = round16(c);
  return 2 * (c16 * (c16 + 8) + (kApplyStages + 1) * c16 * (tile + 8)) + 8LL * c;
}

bool pow2(int64_t x) { return x > 0 && (x & (x - 1)) == 0; }

// The plan's checks: the splits cover n with none empty, the tiles are
// what the kernels take, shared memory is what they use.
bool plan_ok(const AttentionPlan& p, int dtype, int64_t b, int c, int heads, int64_t n,
             const void* q, const void* k, const void* v, const void* out) {
  const int cp = c / heads;
  const int64_t entries = static_cast<int64_t>(c) * cp;
  bool ok = p.splits >= 1 && p.chunk >= 1 && (p.splits - 1) * p.chunk < n &&
            p.splits * p.chunk >= n && p.apply_splits >= 1 && p.apply_chunk >= 1 &&
            (p.apply_splits - 1) * p.apply_chunk < n && p.apply_splits * p.apply_chunk >= n &&
            p.splits <= 0x7fffffffLL && p.apply_splits <= 0x7fffffffLL &&
            p.part_stride == entries + 2 * c &&
            p.rows_smem == 4LL * (static_cast<int64_t>(cp) * cp + 2 * cp + kRowsThreads) &&
            p.rows_smem <= kMaxSmem &&
            p.a_offset >= 4 * b * p.splits * p.part_stride && heads * kRowsCluster <= 0x7fffffff &&
            p.a_offset % 16 == 0 &&
            p.scratch_bytes >= p.a_offset + (dtype == kFloat32 ? 4 * b * c * c
                                                                : 2 * b * round16(c) * (round16(c) + 8));
  if (!ok) return false;
  if (dtype == kFloat32) {
    const int cpad = (c + 3) / 4 * 4;
    return p.direct == 0 && p.score_tile == kScoreTile && p.chunk % kScoreTile == 0 &&
           p.score_threads == kAttnThreads &&
           p.score_groups == (entries + kEntriesPerBlock - 1) / kEntriesPerBlock &&
           p.score_smem == 2LL * kScoreTile * (c + 1) * 4 && p.apply_tile == kApplyTile &&
           p.apply_chunk == kApplyTile && p.apply_threads == kAttnThreads &&
           p.apply_smem == (static_cast<int64_t>(c) * cpad + cpad * kApplyTile) * 4;
  }
  const int64_t items = score_items(c, cp);
  const int64_t warps = p.score_threads / 32;
  const int64_t mtiles = round16(c) / 16;
  const int64_t wn = p.apply_tile / (8 * kApplyNT);
  const bool direct = p.direct != 0;
  auto aligned = [](const void* t) { return (reinterpret_cast<uintptr_t>(t) & 15) == 0; };
  if (direct && !(n % 8 == 0 && aligned(q) && aligned(k) && aligned(v) && aligned(out)))
    return false;
  return (p.direct == 0 || p.direct == 1) && 2 * mtiles <= kNormSlots * warps &&
         pow2(p.score_tile) && p.score_tile >= 32 && p.score_tile <= 512 &&
         p.chunk % p.score_tile == 0 && p.score_threads % 32 == 0 &&
         p.score_threads >= 32 && p.score_threads <= kMaxThreads &&
         (p.items_per_warp == 1 || p.items_per_warp == 2 || p.items_per_warp == 4) &&
         p.score_groups >= 1 && p.score_groups <= 65535 &&
         p.score_groups * warps * p.items_per_warp >= items &&
         (p.score_groups - 1) * warps * p.items_per_warp < items &&
         p.score_stages == (direct ? 2 : 4) &&
         p.score_smem == scores_smem_bf16(c, static_cast<int>(p.score_tile),
                                          static_cast<int>(p.score_stages), direct) &&
         p.score_smem <= kMaxSmem && pow2(p.apply_tile) && p.apply_tile >= 32 &&
         p.apply_tile <= 256 && p.apply_chunk % p.apply_tile == 0 && p.apply_mt >= 1 &&
         p.apply_mt <= 3 && p.apply_threads == 32 * wn * ((mtiles + p.apply_mt - 1) / p.apply_mt) &&
         p.apply_threads <= kMaxThreads &&
         p.apply_smem == apply_smem_bf16(c, static_cast<int>(p.apply_tile)) &&
         p.apply_smem <= kMaxSmem;
}

template <typename T>
int launch_rows(const AttentionPlan& p, const float* part, const float* temp, const void* w,
                int w_dtype, T* a, int64_t b, int c, int heads, int normalize,
                cudaStream_t stream) {
  const dim3 grid(heads * kRowsCluster, static_cast<unsigned int>(b));
  const int cp = c / heads;
  const int sp = static_cast<int>(p.splits);
  const bool f32 = sizeof(T) == 4;
  const int a_rows = f32 ? c : round16(c), a_pitch = f32 ? c : round16(c) + 8;
  if (w == nullptr)
    return launch_cluster(rows_kernel<T, float>, kRowsCluster, grid, kRowsThreads, p.rows_smem,
                          stream, part, temp,
                  static_cast<const float*>(nullptr), a, c, cp, sp, p.part_stride, normalize,
                  a_rows, a_pitch);
  if (w_dtype == kFloat32)
    return launch_cluster(rows_kernel<T, float>, kRowsCluster, grid, kRowsThreads, p.rows_smem,
                          stream, part, temp,
                  static_cast<const float*>(w), a, c, cp, sp, p.part_stride, normalize, a_rows,
                  a_pitch);
  return launch_cluster(rows_kernel<T, bf16>, kRowsCluster, grid, kRowsThreads, p.rows_smem,
                        stream, part, temp,
                static_cast<const bf16*>(w), a, c, cp, sp, p.part_stride, normalize, a_rows,
                a_pitch);
}

int launch_f32(const AttentionPlan& p, const float* q, const float* k, const float* v, float* out,
               const float* temp, const void* w, int w_dtype, float* part, float* a, int64_t b,
               int c, int heads, int64_t n, int normalize, cudaStream_t stream) {
  const int cp = c / heads;
  const int entries = c * cp;
  const int per_thread = (std::min(entries, kEntriesPerBlock) + kAttnThreads - 1) / kAttnThreads;
  const dim3 grid(static_cast<unsigned int>(p.splits), static_cast<unsigned int>(b),
                  static_cast<unsigned int>(p.score_groups));
  auto scores = [&](auto kernel) {
    return launch(kernel, grid, kAttnThreads, p.score_smem, stream, q, k, part, c, cp, n,
                  p.chunk, static_cast<int>(p.splits), p.part_stride);
  };
  int err = per_thread <= 1   ? scores(scores_f32_kernel<1>)
            : per_thread <= 2 ? scores(scores_f32_kernel<2>)
            : per_thread <= 4 ? scores(scores_f32_kernel<4>)
            : per_thread <= 8 ? scores(scores_f32_kernel<8>)
                              : scores(scores_f32_kernel<16>);
  if (err) return err;
  err = launch_rows<float>(p, part, temp, w, w_dtype, a, b, c, heads, normalize, stream);
  if (err) return err;
  return launch(apply_f32_kernel,
                dim3(static_cast<unsigned int>(p.apply_splits), static_cast<unsigned int>(b)),
                kAttnThreads, p.apply_smem, stream, a, v, out, c, (c + 3) / 4 * 4, n);
}

int launch_bf16(const AttentionPlan& p, const bf16* q, const bf16* k, const bf16* v, bf16* out,
                const float* temp, const void* w, int w_dtype, float* part, bf16* a, int64_t b,
                int c, int heads, int64_t n, int normalize, cudaStream_t stream) {
  const int cp = c / heads;
  const int64_t total = b * c * n;
  const int tile = static_cast<int>(p.score_tile);
  const int threads = static_cast<int>(p.score_threads);
  const int per_block = static_cast<int>(p.items_per_warp * (threads / 32));
  const dim3 grid(static_cast<unsigned int>(p.splits), static_cast<unsigned int>(b),
                  static_cast<unsigned int>(p.score_groups));
  auto scores = [&](auto kernel) {
    return launch(kernel, grid, threads, p.score_smem, stream, q, k, part, total, c, cp, n,
                  p.chunk, static_cast<int>(p.splits), p.part_stride, tile, per_block,
                  static_cast<int>(p.direct));
  };
  // two stages where rows start aligned (direct), four where they are realigned
  auto by_stages = [&](auto two, auto four) {
    return p.score_stages == 2 ? scores(two) : scores(four);
  };
  int err = p.items_per_warp == 1 ? by_stages(scores_mma_kernel<1, 2>, scores_mma_kernel<1, 4>)
            : p.items_per_warp == 2 ? by_stages(scores_mma_kernel<2, 2>, scores_mma_kernel<2, 4>)
                                    : by_stages(scores_mma_kernel<4, 2>, scores_mma_kernel<4, 4>);
  if (err) return err;
  err = launch_rows<bf16>(p, part, temp, w, w_dtype, a, b, c, heads, normalize, stream);
  if (err) return err;
  const dim3 agrid(static_cast<unsigned int>(p.apply_splits), static_cast<unsigned int>(b));
  auto apply = [&](auto kernel) {
    return launch(kernel, agrid, static_cast<int>(p.apply_threads), p.apply_smem, stream, a, v,
                  out, total, c, n, p.apply_chunk, static_cast<int>(p.apply_tile),
                  static_cast<int>(p.direct));
  };
  return p.apply_mt == 1   ? apply(apply_mma_kernel<1>)
         : p.apply_mt == 2 ? apply(apply_mma_kernel<2>)
                           : apply(apply_mma_kernel<3>);
}

}  // namespace
}  // namespace hvi_cidnet

using namespace hvi_cidnet;

// q, k, v, out: (b, c, n) contiguous, one type; temp: `heads` fp32 values;
// w: the (c, c) project_out weight (fp32 or bf16, w_dtype) or null.
// scratch: plan->scratch_bytes on the device: the fp32 partials (b, splits,
// c*cp + 2c) at 0, A at plan->a_offset: (b, c, c) fp32, or (b, c16, c16 + 8)
// bf16 with c16 = c rounded up to 16.
// plan: ops/attention_cuda.py:attention_plan, in host memory. Returns the
// first CUDA error, or cudaErrorInvalidValue for a plan it cannot run.
extern "C" int attention_forward(const void* q, const void* k, const void* v, void* out, int dtype,
                                 const void* temp, const void* w, int w_dtype, void* scratch,
                                 const AttentionPlan* plan, int64_t b, int c, int heads,
                                 int64_t n, int normalize, cudaStream_t stream) {
  if (plan == nullptr || b < 1 || b > 65535 || c < 1 || c > kMaxChannels || heads < 1 ||
      c % heads || n < 1 || (dtype != kFloat32 && dtype != kBFloat16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (w != nullptr && w_dtype != kFloat32 && w_dtype != kBFloat16)
    return static_cast<int>(cudaErrorInvalidValue);
  const AttentionPlan& p = *plan;
  if (!plan_ok(p, dtype, b, c, heads, n, q, k, v, out))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* tp = static_cast<const float*>(temp);
  float* part = static_cast<float*>(scratch);
  void* a = static_cast<unsigned char*>(scratch) + p.a_offset;
  if (dtype == kFloat32)
    return launch_f32(p, static_cast<const float*>(q), static_cast<const float*>(k),
                      static_cast<const float*>(v), static_cast<float*>(out), tp, w, w_dtype,
                      part, static_cast<float*>(a), b, c, heads, n, normalize, stream);
  return launch_bf16(p, static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                     static_cast<const bf16*>(v), static_cast<bf16*>(out), tp, w, w_dtype, part,
                     static_cast<bf16*>(a), b, c, heads, n, normalize, stream);
}
