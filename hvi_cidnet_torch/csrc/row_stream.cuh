// RowStream: rows of a bf16 (rows, n) matrix streamed into a ring of
// shared-memory stages by 16-byte cp.async copies, at any 2-byte start
// (K5's scores and apply passes in attention.cu; the bf16 score core of P1
// and P10/P15 in qk_scores.cuh). A row whose start is not 16-byte aligned
// is copied as its 16-byte-aligned cover at a per-row shift, and a
// realignment pass moves it to shift 0.
#pragma once

#include "common.cuh"

namespace hvi_cidnet {
namespace {

using bf16 = __nv_bfloat16;

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

}  // namespace
}  // namespace hvi_cidnet
