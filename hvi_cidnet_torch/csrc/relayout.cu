// P7, P8/P9/P11, P12/P13 and P14: the TPU relayouts as one kernel, a
// batched 2-D transpose with a strided middle axis,
//
//   out[g, y, m, x] = in[g, x, m, y],  in (G, X, M, Y), out (G, Y, M, X),
//
// both contiguous, on 2- or 4-byte elements (their bits are copied: bf16,
// fp16, fp32 alike).
//
// Replaces the Pallas kernels that copy a 3-D array under an axis
// permutation (each equal to a numpy transpose bit for bit):
//   P7  experiments/transpose_kernel_r3.py:38 `_t_kernel` (via
//       make_transpose, call :73): (HW, C, B) -> (HW, B, C), (B, HW, C),
//       (B, C, HW) at steps 1, 2, 3;
//   P8  experiments/relayout_probe_r5h.py:61 `_t3_kernel` (call :67) and
//   P9  :79 `_t2_kernel` (call :86): (N, C, B) -> (B, C, N);
//   P11 :211 `_t2r_kernel` (call :219): (B, C, N) -> (N, C, B);
//   P12 experiments/mosaic_micro_r5h.py:43 `_t3_kernel` (call :50) and
//   P13 :62 `_t2_kernel` (call :70): (N, C, B) -> (G, B, C, n_blk);
//   P14 :85 `_pack_kernel` (call :94): (N, C, B) -> (G, B, n_blk, C).
// Each maps onto (G, X, M, Y) on the host (ops/relayout_cuda.py:geometry);
// the plain versions are ops/relayout.py. The port's HWCB serving contract
// (models/cidnet.py, input_layout="hwcb") runs P14 at its entry and P11 at
// its exit.
//
// Bound: bytes. Each element is read once and written once; there is no
// arithmetic.
//
// Design. The TPU kernels' blocks (whole channel planes in VMEM, lane-dim
// tiling of 128) do not carry over. Here a block moves one tile of TX x TY
// elements of one (g, m) slab through shared memory: it reads the tile's
// TX input rows along y (contiguous in the input) and writes its TY output
// rows along x (contiguous in the output), each with the widest vector
// (up to 16 bytes) the extent and the base address allow. The host plan
// (ops/relayout_cuda.py:relayout_plan, cached per shape) picks:
//   - the tile from the extents: a long side against a narrow one where an
//     axis is short (Y = B = 8 at the HWCB entry: 8 x 512; X = B at the
//     exit: 512 x 8), 64 x 64 where both are long, ~4096 elements a tile;
//   - the threads of a warp along a row on each side (lx, sx) and the row
//     pitch of the shared tile, which together set the sectors the warp's
//     vectors touch, the threads busy and the bank conflicts of the
//     shared-memory accesses (a load's vector is stored to the tile whole
//     where the pitch keeps it aligned, else element by element; the store
//     side reads the tile's columns element by element): the plan scores
//     each choice on one warp and keeps the best;
//   - slabs a work item: a (g, m) slab smaller than half a tile (M = 1;
//     P7 at steps 1: 36 x 8 elements) shares its work item with its
//     neighbours, whose rows follow it in memory on both sides: input row
//     r of the item is row r % X of slab r / X, stored at tile[x][s Y + y],
//     so output row s Y + y reads tile[.][s Y + y] as with one slab;
//   - the grid: at most 8 blocks an SM, each walking work items (tile, g,
//     m) with m fastest, so the slabs of one tile, whose rows interleave in
//     memory when Y or X is narrow, are read and written close in time and
//     share their sectors in L2. Four 64-bit divisions a work item, none
//     an element (one a row where an item holds several slabs); offsets are
//     64-bit (G X M Y passes 2^31 at batch 32).
// A copy (one of the swapped axes of extent 1 once unit axes are dropped:
// the HWCB entry and exit at batch 1) takes a vector copy loop, no tile.
#include "common.cuh"

namespace hvi_cidnet {
namespace {

constexpr int kRelayoutThreads = 256;
constexpr int kRelayoutSmem = 48 * 1024;

template <typename E, int V>
struct alignas(V * sizeof(E)) Vec {
  E v[V];
};

template <typename E, int VI, int VO>
__global__ void __launch_bounds__(kRelayoutThreads)
    relayout_kernel(const E* __restrict__ in, E* __restrict__ out, int64_t gm_count,
                    int64_t m_count, int64_t x_ext, int64_t y_ext, int tx, int ty, int pitch,
                    int lx_shift, int sx_shift, int slabs, int64_t tiles_y, int64_t work) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* tile = reinterpret_cast<E*>(smem_raw);
  const int t = threadIdx.x;
  const int l_col = t & ((1 << lx_shift) - 1), l_row = t >> lx_shift;
  const int l_rows = kRelayoutThreads >> lx_shift, l_step = VI << lx_shift;
  const int s_col = t & ((1 << sx_shift) - 1), s_row = t >> sx_shift;
  const int s_rows = kRelayoutThreads >> sx_shift, s_step = VO << sx_shift;
  const int64_t in_row = m_count * y_ext, out_row = m_count * x_ext;
  const bool vec_tile = pitch % VI == 0;  // a shared row keeps the vectors aligned
  const int64_t groups = (gm_count + slabs - 1) / slabs;
  for (int64_t w = blockIdx.x; w < work; w += gridDim.x) {
    const int64_t tile_i = w / groups, gm = (w - tile_i * groups) * slabs;  // m fastest
    const int64_t g = gm / m_count, m = gm - g * m_count;
    const int64_t tx_i = tile_i / tiles_y, ty_i = tile_i - tx_i * tiles_y;
    const int64_t x0 = tx_i * tx, y0 = ty_i * ty;
    const int nx = static_cast<int>(min64(tx, x_ext - x0));
    const int ny = static_cast<int>(min64(ty, y_ext - y0));
    const int ns = static_cast<int>(min64(slabs, gm_count - gm));  // slabs this item
    // ns * nx input rows of ny elements along y -> tile[x][s * ny + y]
    const E* src = in + ((g * x_ext + x0) * m_count + m) * y_ext + y0;
    for (int r = l_row; r < ns * nx; r += l_rows) {
      int s = 0, xr = r;  // input row r is row xr of slab s
      if (slabs > 1) {
        s = r / nx;
        xr = r - s * nx;
      }
      const E* row = src + r * in_row;
      E* trow = tile + xr * pitch + s * ny;
      for (int v = l_col * VI; v < ny; v += l_step) {
        Vec<E, VI> vals;
        load_vec<VI * sizeof(E)>(vals.v, row + v);
        if (vec_tile) {
          store_vec<VI * sizeof(E)>(trow + v, vals.v);
        } else {
#pragma unroll
          for (int k = 0; k < VI; ++k) trow[v + k] = vals.v[k];
        }
      }
    }
    __syncthreads();
    // ns * ny output rows of nx elements along x <- tile[.][s * ny + y]
    E* dst = out + ((g * y_ext + y0) * m_count + m) * x_ext + x0;
    for (int r = s_row; r < ns * ny; r += s_rows) {
      E* row = dst + r * out_row;
      for (int v = s_col * VO; v < nx; v += s_step) {
        Vec<E, VO> vals;
#pragma unroll
        for (int k = 0; k < VO; ++k) vals.v[k] = tile[(v + k) * pitch + r];
        store_vec<VO * sizeof(E)>(row + v, vals.v);
      }
    }
    __syncthreads();  // the tile is refilled by the next work item
  }
}

template <typename E, int V>
__global__ void __launch_bounds__(kRelayoutThreads)
    copy_kernel(const E* __restrict__ in, E* __restrict__ out, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kRelayoutThreads * V;
  for (int64_t i = (static_cast<int64_t>(blockIdx.x) * kRelayoutThreads + threadIdx.x) * V;
       i < n; i += stride) {
    Vec<E, V> vals;
    load_vec<V * sizeof(E)>(vals.v, in + i);
    store_vec<V * sizeof(E)>(out + i, vals.v);
  }
}

struct Args {
  const void* in;
  void* out;
  int64_t g, x, m, y;
  int tx, ty, pitch, lx_shift, sx_shift, slabs, blocks, smem;
};

template <typename E, int VI, int VO>
int launch_transpose(const Args& a, cudaStream_t stream) {
  const int64_t tiles_y = (a.y + a.ty - 1) / a.ty, tiles_x = (a.x + a.tx - 1) / a.tx;
  const int64_t groups = (a.g * a.m + a.slabs - 1) / a.slabs;
  relayout_kernel<E, VI, VO><<<a.blocks, kRelayoutThreads, a.smem, stream>>>(
      static_cast<const E*>(a.in), static_cast<E*>(a.out), a.g * a.m, a.m, a.x, a.y, a.tx,
      a.ty, a.pitch, a.lx_shift, a.sx_shift, a.slabs, tiles_y, groups * tiles_x * tiles_y);
  return static_cast<int>(cudaGetLastError());
}

template <typename E, int V>
int launch_copy(const Args& a, cudaStream_t stream) {
  copy_kernel<E, V><<<a.blocks, kRelayoutThreads, 0, stream>>>(
      static_cast<const E*>(a.in), static_cast<E*>(a.out), a.y);
  return static_cast<int>(cudaGetLastError());
}

template <typename E, int VI>
int pick_vo(int vo, const Args& a, cudaStream_t s) {
  if (vo == 1) return launch_transpose<E, VI, 1>(a, s);
  if (vo == 2) return launch_transpose<E, VI, 2>(a, s);
  if (vo == 4) return launch_transpose<E, VI, 4>(a, s);
  if constexpr (sizeof(E) == 2) {
    if (vo == 8) return launch_transpose<E, VI, 8>(a, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename E>
int pick_vi(bool copy, int vi, int vo, const Args& a, cudaStream_t s) {
  if (copy) {
    if (vi == 1) return launch_copy<E, 1>(a, s);
    if (vi == 2) return launch_copy<E, 2>(a, s);
    if (vi == 4) return launch_copy<E, 4>(a, s);
    if constexpr (sizeof(E) == 2) {
      if (vi == 8) return launch_copy<E, 8>(a, s);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (vi == 1) return pick_vo<E, 1>(vo, a, s);
  if (vi == 2) return pick_vo<E, 2>(vo, a, s);
  if (vi == 4) return pick_vo<E, 4>(vo, a, s);
  if constexpr (sizeof(E) == 2) {
    if (vi == 8) return pick_vo<E, 8>(vo, a, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// log2 of a power of two in [1, 256], else -1
int shift_of(int n) {
  for (int s = 0; s <= 8; ++s)
    if (n == (1 << s)) return s;
  return -1;
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % static_cast<uintptr_t>(bytes) == 0;
}

}  // namespace
}  // namespace hvi_cidnet

using namespace hvi_cidnet;

// in: (g, x, m, y) contiguous; out: (g, y, m, x) contiguous; itemsize 2 or
// 4 bytes. x == 1 (with g == m == 1) is a copy of y elements in vectors of
// vi (== vo). Otherwise tx, ty, pitch, vi, vo, lx, sx, slabs, blocks, smem:
// the plan of ops/relayout_cuda.py:relayout_plan (slabs > 1: that many
// whole slabs a work item, m == 1). Returns a cudaError_t code,
// cudaErrorInvalidValue for a plan it cannot run.
extern "C" int relayout(const void* in, void* out, int itemsize, int64_t g, int64_t x, int64_t m,
                        int64_t y, int tx, int ty, int pitch, int vi, int vo, int lx, int sx,
                        int slabs, int blocks, int smem, cudaStream_t stream) {
  const int lx_shift = shift_of(lx), sx_shift = shift_of(sx);
  const bool copy = x == 1;
  bool ok = (itemsize == 2 || itemsize == 4) && g >= 1 && x >= 1 && m >= 1 && y >= 1 &&
            blocks >= 1 && vi >= 1 && vo >= 1 && vi * itemsize <= 16 && vo * itemsize <= 16 &&
            y % vi == 0 && aligned(in, vi * itemsize);
  if (copy) {
    ok = ok && g == 1 && m == 1 && vo == vi && smem == 0 && aligned(out, vi * itemsize);
  } else {
    ok = ok && lx_shift >= 0 && sx_shift >= 0 && tx >= 1 && tx <= x && ty >= 1 && ty <= y &&
         x % vo == 0 && tx % vo == 0 && ty % vi == 0 && slabs >= 1 &&
         (slabs == 1 || (m == 1 && tx == x && ty == y && slabs <= g)) &&
         static_cast<int64_t>(pitch) >= static_cast<int64_t>(slabs) * ty && smem >= 0 &&
         smem <= kRelayoutSmem && static_cast<int64_t>(smem) ==
         static_cast<int64_t>(tx) * pitch * itemsize && aligned(out, vo * itemsize);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{in, out, g, x, m, y, tx, ty, pitch, lx_shift, sx_shift, slabs, blocks, smem};
  if (itemsize == 2) return pick_vi<unsigned short>(copy, vi, vo, a, stream);
  return pick_vi<unsigned int>(copy, vi, vo, a, stream);
}
