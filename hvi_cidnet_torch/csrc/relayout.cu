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
// arithmetic. What keeps a transpose from that bound is a sector read or
// written in halves (one axis narrow: 16 bytes of B = 8 bf16 a row), loads
// that wait for stores, and the threads' own address arithmetic and
// shared-memory traffic.
//
// Design. The host plan (ops/relayout_cuda.py:relayout_plan, cached per
// shape and offsets) picks one of three arms; where both copying arms can
// run, the rule follows their times on an H100 at the forward's shapes
// (hvi_cidnet_torch/cli/kernel_times.py --arms).
//
// The bulk arm (M > 1 once unit axes are dropped, and M rows of the narrow
// axis 512 bytes or more; both X and Y a whole number of 16-byte vectors,
// both tensors 16-byte aligned): persistent
// blocks walk work items, each the
// tile [x0, x0 + tx) x [y0, y0 + ty) of k slabs g and tm channels m, with
// every m of the item and the narrow axis whole, so neither side touches a
// sector that another item touches. A ring of 2-3 stages, each an input
// and an output buffer in shared memory: warp 0 keeps the next items'
// loads in flight while all warps transpose this one, and stores leave by
// the copy engine, waited for (cp.async.bulk.wait_group.read) only before
// their buffer is refilled. Each side is moved one of two ways:
//   - a narrow side (its rows along the narrow axis, all m): bulk copies
//     (cp.async.bulk, 1-D), a copy a row (s, a) of tm rows of m, or one copy
//     an item where the stage keeps the tensor's own layout; rows sit at a
//     padded pitch where that avoids bank conflicts;
//   - a long side (its rows 128 bytes along the long axis): boxes of a TMA
//     tensor map (4-D, G Y M X or G X M Y) of one 128-byte line by tmb
//     channels by the narrow extent, 128-byte swizzle, tmb odd (so the lines
//     of 8 consecutive rows of one m fall on 8 distinct swizzle phases);
//     loads past the tensor's edge land as zeros, stores are clipped there.
// The transposition reads the input buffer and writes the output buffer in
// 16-byte vectors on both sides: 2-byte elements as 8 x 8 blocks, four a
// warp, by ldmatrix.x4.trans (8 x-rows of 8 y each, read as their
// transpose) and stmatrix.x4 (written as 8 y-rows of 8 x); 4-byte elements
// as 4 x 4 blocks over four lanes, one 16-byte row a lane in, a register
// transposition by three shuffle-free rotations and four shuffles, one
// 16-byte row a lane out. Pitches and swizzle keep each 8-lane phase of
// those accesses on 8 distinct 16-byte bank groups (ops/relayout_cuda.py,
// tests/test_torch_launch_plan.py replays them).
//
// The cp.async arm (M = 1, where a tile's rows are whole runs on both sides
// and no sector is split; M channels too few for the bulk arm's narrow rows
// to reach 512 bytes; rows that are not a whole number of 16-byte vectors,
// or tensors off 16-byte alignment: copies TMA and the bulk engine cannot
// make): a block moves a tile of tx x ty elements of one (g, m)
// slab, or of `slabs` whole slabs of G where M = 1: cp.async copies of the
// widest vectors the extents and the starts allow into a two-stage ring
// (relayout_async_kernel: the next item's copies in flight while this one
// is stored) where at least half the blocks take a second item, else PR
// 10's one-stage kernel (relayout_kernel: loads through registers an item
// at a time, element by element into the tile where the pitch that avoids
// bank conflicts breaks the vectors' alignment); the store side reads the
// tile's columns element by element into vectors along x;
// the plan scores the threads a row and the pitch on one warp (sectors,
// threads busy, wavefronts).
//
// The copy arm (a swapped axis of extent 1 once unit axes are dropped: the
// HWCB entry and exit at batch 1): a vector copy loop, no tile.
#include <cstring>

#include "common.cuh"
#include "tensor_map.cuh"

namespace hvi_cidnet {
namespace {

constexpr int kRelayoutThreads = 256;
constexpr int kWarps = kRelayoutThreads / 32;  // the bulk arm's transposing warps
constexpr int kBulkThreads = kRelayoutThreads + 32;  // and its producer warp
constexpr int kMaxStages = 3;  // the ring's depth at most
constexpr int kRingAlign = 1024;  // the 128-byte swizzle's period
constexpr int kLine = 128;        // bytes of a tensor map box's inner line
constexpr int kSmemCap = 227 * 1024;

// ---------------------------------------------------------------------------
// The bulk arm
// ---------------------------------------------------------------------------

// n / d by a float reciprocal, corrected by one (exact for n < 2^22): the
// transposition's indices, a few per 16-byte access, cost no integer division
struct FastDiv {
  int d;
  float inv;
  __device__ __forceinline__ int operator()(int n) const {
    int q = __float2int_rz(__int2float_rn(n) * inv);
    q += (q + 1) * d <= n;
    q -= q * d > n;
    return q;
  }
};

__device__ __forceinline__ FastDiv fast_div(int d) { return {d, __frcp_rn(static_cast<float>(d))}; }

// One side of an item: rows (s, a) of tm channels m, each along b (input:
// a = x, b = y; output: a = y, b = x). A bulk side (b whole) keeps row
// rho = s * ta + a at byte (rho >> run_shift) * pr + (rho & (run - 1)) * rb
// of its buffer (run 0: at rho * rb, one bulk copy for all rows), channel m
// at m * pm in it: runs of `run` rows (a power of two), each one bulk copy
// (rows that follow each other in the tensor), at a padded pitch pr. A long
// box side (kLongBox) keeps channel block im = m / tmb, line bi of b in
// region (im * nbb + bi) * box_bytes, and there row (a, m % tmb) as line a *
// tmb + m % tmb, its 16-byte chunk c at c ^ (line & 7) (the 128-byte
// swizzle). A narrow box side (kNarrowBox: b whole, padded to pr bytes, the
// pad past the tensor's edge) keeps block im and rows a in [256 ia, 256 ia +
// 256) in region (im * nab + ia) * box_bytes, row (a % 256, m % tmb) at
// ((a % 256) * tmb + m % tmb) * pr.
enum { kBulkSide = 0, kLongBox = 1, kNarrowBox = 2 };
constexpr int kBoxRows = 256;  // a box's extent along a, at most
struct Side {
  int64_t a_ext, b_ext;
  int box;  // kBulkSide, kLongBox or kNarrowBox
  int ta;   // rows of a in the buffer (a slab's)
  int run, run_shift, pr, rb, pm;
  int tmb, nbb, nab, box_bytes;
};

struct BulkArgs {
  const unsigned char* in;
  unsigned char* out;
  int64_t g, x, m, y;
  int tx, ty, tm, k;
  Side in_side, out_side;
  int in_bytes, out_bytes, stages, pair_y;
  int64_t tiles_x, tiles_y, m_chunks, items;
};

struct Item {
  int64_t g0, m0, x0, y0;
  int ns, nm, nx, ny;
};

__device__ __forceinline__ unsigned int smem_u32(const void* p) {
  return static_cast<unsigned int>(__cvta_generic_to_shared(p));
}

// the item's divisors, once a block
struct ItemDivs {
  FastDiv tiles_x, tiles_y, m_chunks, tmb;
};

__device__ __forceinline__ Item item_of(const BulkArgs& a, const ItemDivs& dv, int w) {
  Item it;
  int t = dv.tiles_x(w);
  const int tx_i = w - t * static_cast<int>(a.tiles_x);
  w = t;
  t = dv.tiles_y(w);
  const int ty_i = w - t * static_cast<int>(a.tiles_y);
  const int gc = dv.m_chunks(t), mc = t - gc * static_cast<int>(a.m_chunks);
  it.g0 = static_cast<int64_t>(gc) * a.k;
  it.m0 = static_cast<int64_t>(mc) * a.tm;
  it.x0 = static_cast<int64_t>(tx_i) * a.tx;
  it.y0 = static_cast<int64_t>(ty_i) * a.ty;
  it.ns = static_cast<int>(min64(a.k, a.g - it.g0));
  it.nm = static_cast<int>(min64(a.tm, a.m - it.m0));
  it.nx = static_cast<int>(min64(a.tx, a.x - it.x0));
  it.ny = static_cast<int>(min64(a.ty, a.y - it.y0));
  return it;
}

// byte offset in a side's buffer of 16-byte chunk bc (along b) of row (s, a, m)
__device__ __forceinline__ int chunk_at(const Side& sd, const FastDiv& tmb, int s, int a, int m,
                                        int bc) {
  if (sd.box == kLongBox) {
    const int im = tmb(m), line = a * sd.tmb + (m - im * sd.tmb);
    return (im * sd.nbb + (bc >> 3)) * sd.box_bytes + line * kLine + (((bc & 7) ^ (line & 7)) << 4);
  }
  if (sd.box == kNarrowBox) {
    const int im = tmb(m);
    return (im * sd.nab + (a >> 8)) * sd.box_bytes +
           ((a & (kBoxRows - 1)) * sd.tmb + m - im * sd.tmb) * sd.pr + (bc << 4);
  }
  const int rho = s * sd.ta + a;
  const int at = sd.run ? (rho >> sd.run_shift) * sd.pr + (rho & (sd.run - 1)) * sd.rb : rho * sd.rb;
  return at + m * sd.pm + (bc << 4);
}

// 4-D box of a tensor map at (c0, c1, c2, c3), innermost first
__device__ __forceinline__ void box_load(void* smem, const CUtensorMap* map, int c0, int c1, int c2,
                                         int c3, void* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(smem)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void box_store(const CUtensorMap* map, const void* smem, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(smem)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// every bulk group of this thread but the newest has read its shared memory
__device__ __forceinline__ void bulk_wait_read_but_one() {
  asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
}

// Warp 0 (this lane's share) moves one side of an item: the rows (s, a, m)
// of ns x na x nm, nb elements each along b, from (g0, a0, m0, b0). Load:
// tensor -> buffer, the bytes reported to `bar`; store: buffer -> tensor in
// this lane's bulk group.
template <int E, bool kLoad>
__device__ __forceinline__ void move_side(const Side& sd, const CUtensorMap* map,
                                          const unsigned char* src, unsigned char* dst,
                                          unsigned char* buf, int64_t m_ext, int64_t g0,
                                          int64_t a0, int64_t m0, int64_t b0, int ns, int na,
                                          int nm, int nb, void* bar, int lane) {
  if (sd.box == kNarrowBox) {  // boxes of b padded, tmb channels, up to kBoxRows rows
    const int nab = (na + kBoxRows - 1) / kBoxRows, boxes = (nm + sd.tmb - 1) / sd.tmb * nab;
    for (int u = lane; u < boxes; u += 32) {
      const int im = u / nab, ia = u - im * nab;
      unsigned char* at = buf + (im * sd.nab + ia) * sd.box_bytes;
      const int c1 = static_cast<int>(m0) + im * sd.tmb, c2 = static_cast<int>(a0) + ia * kBoxRows;
      if (kLoad) {
        box_load(at, map, 0, c1, c2, static_cast<int>(g0), bar);
      } else {
        box_store(map, at, 0, c1, c2, static_cast<int>(g0));
      }
    }
    return;
  }
  if (sd.box) {  // boxes of one 128-byte line along b, tmb channels, the side's a tile
    constexpr int kUnit = kLine / E;
    const int nbb = (nb + kUnit - 1) / kUnit, boxes = (nm + sd.tmb - 1) / sd.tmb * nbb;
    for (int u = lane; u < boxes; u += 32) {
      const int im = u / nbb, bi = u - im * nbb;
      unsigned char* at = buf + (im * sd.nbb + bi) * sd.box_bytes;
      const int c0 = static_cast<int>(b0) + bi * kUnit, c1 = static_cast<int>(m0) + im * sd.tmb;
      if (kLoad) {
        box_load(at, map, c0, c1, static_cast<int>(a0), static_cast<int>(g0), bar);
      } else {
        box_store(map, at, c0, c1, static_cast<int>(a0), static_cast<int>(g0));
      }
    }
    return;
  }
  // runs of rows rho = s * ta + a (na of the last slab's ta), all nm channels
  const int rows = (ns - 1) * sd.ta + na, line_bytes = static_cast<int>(nm * sd.b_ext * E);
  const int run = sd.run ? sd.run : rows;
  for (int u = lane; u * run < rows; u += 32) {
    const int rho = u * run, s = rho / sd.ta, a = rho - s * sd.ta;
    const int64_t row = (((g0 + s) * sd.a_ext + a0 + a) * m_ext + m0) * sd.b_ext + b0;
    const unsigned int bytes = static_cast<unsigned int>(min(run, rows - rho) * line_bytes);
    unsigned char* at = buf + u * sd.pr;
    if (kLoad) {
      bulk_copy(at, src + row * E, bytes, bar);
    } else {
      bulk_store(dst + row * E, at, bytes);
    }
  }
}

// The bytes an item's loads report: full boxes (past the tensor's edge too)
template <int E>
__device__ __forceinline__ unsigned int load_bytes(const Side& sd, const Item& it) {
  if (sd.box == kNarrowBox) {
    const int nab = (it.nx + kBoxRows - 1) / kBoxRows, rows = min(sd.ta, kBoxRows);
    return static_cast<unsigned int>((it.nm + sd.tmb - 1) / sd.tmb * nab * sd.pr * sd.tmb * rows);
  }
  if (sd.box) {
    constexpr int kUnit = kLine / E;
    const int nbb = (it.ny + kUnit - 1) / kUnit;
    return static_cast<unsigned int>((it.nm + sd.tmb - 1) / sd.tmb * nbb * kLine * sd.tmb * sd.ta);
  }
  return static_cast<unsigned int>(it.ns * it.nx * it.nm * it.ny * E);
}

// 2-byte elements: 8 x 8 blocks (s, m, yo, xo), four a warp instruction.
// Lanes 8i .. 8i + 7 name the rows of block i: x-rows to ldmatrix.x4.trans,
// which returns each block transposed, y-rows to stmatrix.x4.
__device__ __forceinline__ void transpose_b16(const BulkArgs& a, const FastDiv& tmb,
                                              const Item& it, const unsigned char* sin,
                                              unsigned char* sout, int warp, int lane) {
  const int nbx = it.nx >> 3, nby = it.ny >> 3;
  const int blocks = it.ns * it.nm * nby * nbx, r = lane & 7;
  const FastDiv by_x = fast_div(nbx), by_m = fast_div(it.nm), by_y = fast_div(nby);
  for (int q0 = warp * 4; q0 < blocks; q0 += kWarps * 4) {
    int q = min(q0 + (lane >> 3), blocks - 1);  // the tail repeats the last block
    int t = by_x(q);
    const int xo = q - t * nbx;
    q = by_m(t);
    const int mm = t - q * it.nm;
    const int s = by_y(q), yo = q - s * nby;
    uint32_t v0, v1, v2, v3;
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v0), "=r"(v1), "=r"(v2), "=r"(v3)
                 : "r"(smem_u32(sin + chunk_at(a.in_side, tmb, s, 8 * xo + r, mm, yo)))
                 : "memory");
    asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(
                     smem_u32(sout + chunk_at(a.out_side, tmb, s, 8 * yo + r, mm, xo))),
                 "r"(v0), "r"(v1), "r"(v2), "r"(v3)
                 : "memory");
  }
}

// A 4 x 4 transposition over lanes r = 0 .. 3 of a group, row r in, column
// r out: two butterflies, halves swapped with lane r ^ 2, then words with r ^ 1
__device__ __forceinline__ void transpose4(uint32_t (&e)[4], int r) {
  const bool hi = r & 2;
  const uint32_t h0 = __shfl_xor_sync(0xffffffffu, hi ? e[0] : e[2], 2, 4);
  const uint32_t h1 = __shfl_xor_sync(0xffffffffu, hi ? e[1] : e[3], 2, 4);
  e[0] = hi ? h0 : e[0];  // rows r and r ^ 2, this lane's two columns (selects, no
  e[1] = hi ? h1 : e[1];  // indexing by lane: the array stays in registers)
  e[2] = hi ? e[2] : h0;
  e[3] = hi ? e[3] : h1;
  const bool odd = r & 1;
  const uint32_t w0 = __shfl_xor_sync(0xffffffffu, odd ? e[0] : e[1], 1, 4);
  const uint32_t w1 = __shfl_xor_sync(0xffffffffu, odd ? e[2] : e[3], 1, 4);
  e[0] = odd ? w0 : e[0];
  e[1] = odd ? e[1] : w0;
  e[2] = odd ? w1 : e[2];
  e[3] = odd ? e[3] : w1;
}

// 4-byte elements: 4 x 4 blocks over four lanes (r = lane & 3 holds x-row r
// of its block in, y-row r out: transpose4). Two blocks share an 8-lane phase: along x
// (pair_y 0: 8 consecutive x-rows of one chunk in, two adjacent chunks of 4
// y-rows out) or along y; blocks run along the paired axis, then m.
__device__ __forceinline__ void transpose_b32(const BulkArgs& a, const FastDiv& tmb,
                                              const Item& it, const unsigned char* sin,
                                              unsigned char* sout, int warp, int lane) {
  const int nbx = it.nx >> 2, nby = it.ny >> 2, r = lane & 3;
  const int fast = a.pair_y ? nby : nbx, slow = a.pair_y ? nbx : nby;
  const int fast_even = fast + (fast & 1);  // an odd count's last block pairs with itself
  const int blocks = it.ns * it.nm * slow * fast_even;
  const FastDiv by_fast = fast_div(fast_even), by_m = fast_div(it.nm), by_slow = fast_div(slow);
  for (int q0 = warp * 8; q0 < blocks; q0 += kWarps * 8) {
    int q = min(q0 + (lane >> 2), blocks - 1);
    int t = by_fast(q);
    const int f = min(q - t * fast_even, fast - 1);
    q = by_m(t);
    const int mm = t - q * it.nm;
    const int s = by_slow(q), sl = q - s * slow;
    const int xo = a.pair_y ? sl : f, yo = a.pair_y ? f : sl;
    const uint4 row = *reinterpret_cast<const uint4*>(
        sin + chunk_at(a.in_side, tmb, s, 4 * xo + r, mm, yo));
    uint32_t e[4] = {row.x, row.y, row.z, row.w};
    transpose4(e, r);
    *reinterpret_cast<uint4*>(sout + chunk_at(a.out_side, tmb, s, 4 * yo + r, mm, xo)) =
        make_uint4(e[0], e[1], e[2], e[3]);
  }
}

__device__ __forceinline__ void mbar_arrive(void* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Warp kWarps, the producer, issues every copy; warps 0 .. kWarps - 1
// transpose. Stage s of the ring holds item j = s, s + stages, ...; its
// barriers: full (the item's loads have landed), done (every consumer warp
// has transposed it, its writes fenced for the copy engine) and free (the
// stores of the item before it in that stage have read the output buffer).
template <int E>
__global__ void __launch_bounds__(kBulkThreads)
    relayout_bulk_kernel(const BulkArgs a, const __grid_constant__ CUtensorMap in_map,
                         const __grid_constant__ CUtensorMap out_map) {
  extern __shared__ __align__(1024) unsigned char ring_raw[];
  // the ring 1024-byte aligned (the swizzle's period), its barriers after it
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(ring_raw) + kRingAlign - 1) & ~uintptr_t(kRingAlign - 1));
  const int stages = a.stages;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * (a.in_bytes + a.out_bytes));
  uint64_t* done = full + kMaxStages;
  uint64_t* freed = done + kMaxStages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(done + s, kWarps);
      mbar_init(freed + s, 1);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const ItemDivs dv{fast_div(static_cast<int>(a.tiles_x)), fast_div(static_cast<int>(a.tiles_y)),
                    fast_div(static_cast<int>(a.m_chunks)), fast_div(a.in_side.tmb)};
  const int items = static_cast<int>(a.items), first = static_cast<int>(blockIdx.x);
  const int mine = first < items ? (items - 1 - first) / static_cast<int>(gridDim.x) + 1 : 0;
  auto in_buf = [&](int j) { return ring + (j % stages) * (a.in_bytes + a.out_bytes); };
  auto item = [&](int j) { return item_of(a, dv, first + j * static_cast<int>(gridDim.x)); };
  if (warp == kWarps) {
    for (int j = 0; j < mine + stages; ++j) {
      const int st = j - stages;  // the item this step stores, transposed in j's stage
      if (st >= 0 && st < mine) {
        mbar_wait(done + j % stages, static_cast<unsigned int>((st / stages) & 1));
        const Item it = item(st);
        move_side<E, false>(a.out_side, &out_map, nullptr, a.out, in_buf(st) + a.in_bytes, a.m,
                            it.g0, it.y0, it.m0, it.x0, it.ns, it.ny, it.nm, it.nx, nullptr, lane);
        bulk_commit();
      }
      if (j < mine) {  // its input buffer: fresh, or item st's, transposed
        const Item it = item(j);
        void* bar = full + j % stages;
        if (lane == 0) mbar_arrive_expect(bar, load_bytes<E>(a.in_side, it));
        __syncwarp();
        move_side<E, true>(a.in_side, &in_map, a.in, nullptr, in_buf(j), a.m, it.g0, it.x0,
                           it.m0, it.y0, it.ns, it.nx, it.nm, it.ny, bar, lane);
      }
      const int read = st - 1;  // the item whose stores must have read its output buffer
      if (read >= 0 && read < mine) {
        if (st < mine) {
          bulk_wait_read_but_one();  // all but this step's own stores
        } else {
          bulk_wait_read();
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(freed + read % stages);
      }
    }
    bulk_wait_all();
    return;
  }
  for (int j = 0; j < mine; ++j) {
    const int s = j % stages;
    mbar_wait(full + s, static_cast<unsigned int>((j / stages) & 1));
    if (j >= stages) mbar_wait(freed + s, static_cast<unsigned int>((j / stages + 1) & 1));
    const Item it = item(j);
    unsigned char* sin = in_buf(j);
    unsigned char* sout = sin + a.in_bytes;
    if constexpr (E == 2) {
      transpose_b16(a, dv.tmb, it, sin, sout, warp, lane);
    } else {
      transpose_b32(a, dv.tmb, it, sin, sout, warp, lane);
    }
    fence_proxy_async();  // the copy engine reads what this thread wrote
    __syncwarp();
    if (lane == 0) mbar_arrive(done + s);
  }
}

// The tensor map of a box side: the tensor (G, A, M, B) as 4-D, B innermost,
// boxes of one 128-byte line x tmb x ta x 1, 128-byte swizzle (kLongBox), or
// of B padded to pr bytes x tmb x min(ta, kBoxRows) x 1, no swizzle
// (kNarrowBox); zeros past the edges.
int encode_side(CUtensorMap* map, const void* base, int itemsize, const Side& sd, int64_t g,
                int64_t m) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(sd.b_ext), static_cast<cuuint64_t>(m),
                              static_cast<cuuint64_t>(sd.a_ext), static_cast<cuuint64_t>(g)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sd.b_ext * itemsize),
                                 static_cast<cuuint64_t>(m * sd.b_ext * itemsize),
                                 static_cast<cuuint64_t>(sd.a_ext * m * sd.b_ext * itemsize)};
  const bool narrow = sd.box == kNarrowBox;
  const cuuint32_t box[4] = {static_cast<cuuint32_t>((narrow ? sd.pr : kLine) / itemsize),
                             static_cast<cuuint32_t>(sd.tmb),
                             static_cast<cuuint32_t>(narrow && sd.ta > kBoxRows ? kBoxRows : sd.ta),
                             1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  if (encode(map, itemsize == 2 ? CU_TENSOR_MAP_DATA_TYPE_UINT16 : CU_TENSOR_MAP_DATA_TYPE_UINT32,
             4, const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             narrow ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

// ---------------------------------------------------------------------------
// The cp.async arm
// ---------------------------------------------------------------------------

template <typename E, int V>
struct alignas(V * sizeof(E)) Vec {
  E v[V];
};

// Two stages (the plan's where the tile's rows keep the input vectors
// aligned and at least half the blocks take a second item): cp.async
// copies into a two-stage ring, the next item's copies in flight while this
// one is stored
template <typename E, int VI, int VO>
__global__ void __launch_bounds__(kRelayoutThreads)
    relayout_async_kernel(const E* __restrict__ in, E* __restrict__ out, int64_t gm_count,
                          int64_t m_count, int64_t x_ext, int64_t y_ext, int tx, int ty, int pitch,
                          int lx_shift, int sx_shift, int slabs, int64_t tiles_y, int64_t work) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* const tiles = reinterpret_cast<E*>(smem_raw);
  const int t = threadIdx.x, tile_elems = tx * pitch;
  const int l_col = t & ((1 << lx_shift) - 1), l_row = t >> lx_shift;
  const int l_rows = kRelayoutThreads >> lx_shift, l_step = VI << lx_shift;
  const int s_col = t & ((1 << sx_shift) - 1), s_row = t >> sx_shift;
  const int s_rows = kRelayoutThreads >> sx_shift, s_step = VO << sx_shift;
  const int64_t in_row = m_count * y_ext, out_row = m_count * x_ext;
  const int64_t groups = (gm_count + slabs - 1) / slabs;
  struct Tile {
    const E* src;
    E* dst;
    int nx, ny, ns;
  };
  auto tile_of = [&](int64_t w) {  // slabs fastest
    Tile tl;
    const int64_t tile_i = w / groups, gm = (w - tile_i * groups) * slabs;
    const int64_t g = gm / m_count, m = gm - g * m_count;
    const int64_t tx_i = tile_i / tiles_y, ty_i = tile_i - tx_i * tiles_y;
    const int64_t x0 = tx_i * tx, y0 = ty_i * ty;
    tl.nx = static_cast<int>(min64(tx, x_ext - x0));
    tl.ny = static_cast<int>(min64(ty, y_ext - y0));
    tl.ns = static_cast<int>(min64(slabs, gm_count - gm));
    tl.src = in + ((g * x_ext + x0) * m_count + m) * y_ext + y0;
    tl.dst = out + ((g * y_ext + y0) * m_count + m) * x_ext + x0;
    return tl;
  };
  // ns * nx input rows of ny elements along y -> tile[x][s * ny + y]; several
  // slabs an item only where M = 1 and the tiles are whole: input row r is
  // then row r % nx of slab r / nx, r rows on from the item's first
  auto load = [&](const Tile& tl, E* tile) {
    for (int r = l_row; r < tl.ns * tl.nx; r += l_rows) {
      int s = 0, xr = r;
      if (slabs > 1) {
        s = r / tl.nx;
        xr = r - s * tl.nx;
      }
      const E* row = tl.src + r * in_row;
      E* trow = tile + xr * pitch + s * tl.ny;
      for (int v = l_col * VI; v < tl.ny; v += l_step)
        cp_async_zfill<VI * sizeof(E)>(trow + v, row + v, true);
    }
    cp_async_commit();
  };
  int buf = 0;
  if (blockIdx.x < work) load(tile_of(blockIdx.x), tiles);
  for (int64_t w = blockIdx.x; w < work; w += gridDim.x) {
    const Tile tl = tile_of(w);
    if (w + gridDim.x < work) {
      load(tile_of(w + gridDim.x), tiles + (buf ^ 1) * tile_elems);  // stored last item
    } else {
      cp_async_commit();
    }
    cp_async_wait<1>();
    __syncthreads();
    // ns * ny output rows of nx elements along x <- tile[.][s * ny + y]
    const E* tile = tiles + buf * tile_elems;
    for (int r = s_row; r < tl.ns * tl.ny; r += s_rows) {
      E* row = tl.dst + r * out_row;
      for (int v = s_col * VO; v < tl.nx; v += s_step) {
        Vec<E, VO> vals;
#pragma unroll
        for (int k = 0; k < VO; ++k) vals.v[k] = tile[(v + k) * pitch + r];
        store_vec<VO * sizeof(E)>(row + v, vals.v);
      }
    }
    __syncthreads();  // the tile is refilled by a later item
    buf ^= 1;
  }
}

// One stage (PR 10's kernel): each item's loads through registers into the
// tile, as vectors where its rows keep them aligned, then its stores
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

// ---------------------------------------------------------------------------
// Launches
// ---------------------------------------------------------------------------

// The plan's numbers, in ops/relayout_cuda.py:RelayoutPlan's order
struct Plan {
  int arm, tx, ty, tm, k, vi, vo, lx, sx, pitch, in_box, in_run, in_pr, out_box, out_run,
      out_pr, tmb, pair_y, stages, blocks, smem;
};
constexpr int kPlanFields = 21;
static_assert(sizeof(Plan) == kPlanFields * sizeof(int), "Plan is the C array's layout");
enum { kCopy = 0, kBulk = 1, kAsync = 2 };

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }
int round_up(int64_t a, int b) { return static_cast<int>(cdiv(a, b) * b); }

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % static_cast<uintptr_t>(bytes) == 0;
}

// log2 of a power of two in [1, 256], else -1
int shift_of(int n) {
  for (int s = 0; s <= 8; ++s)
    if (n == (1 << s)) return s;
  return -1;
}

// one side of the bulk arm from the plan; false where the plan breaks a rule
// the copies or the buffer layout need
bool make_side(Side* sd, int itemsize, int64_t a_ext, int64_t b_ext, int64_t m, int ta, int tb,
               int tm, int k, int box, int run, int pr, int tmb) {
  sd->a_ext = a_ext;
  sd->b_ext = b_ext;
  sd->box = box;
  sd->ta = ta;
  sd->tmb = tmb;
  sd->pm = tb * itemsize;
  sd->rb = tm * sd->pm;
  const int unit = kLine / itemsize;
  const bool boxes = k == 1 && tmb >= 1 && tmb <= 256 && tmb % 2 == 1 && tm % tmb == 0 && ta >= 1;
  if (box == kLongBox) {  // tb whole lines, tmb | tm (the last chunk of M cut at the tensor's edge)
    sd->nbb = tb / unit;
    sd->nab = 1;
    sd->box_bytes = round_up(static_cast<int64_t>(kLine) * tmb * ta, kRingAlign);
    sd->run = 1;
    sd->pr = 0;
    return boxes && tb % unit == 0 && ta <= kBoxRows;
  }
  if (box == kNarrowBox) {  // b whole, padded to pr bytes; ta rows in boxes of kBoxRows
    sd->nbb = 1;
    sd->nab = static_cast<int>(cdiv(ta, kBoxRows));
    sd->box_bytes = round_up(static_cast<int64_t>(pr) * tmb * (ta < kBoxRows ? ta : kBoxRows),
                             kRingAlign);
    sd->run = 1;
    sd->pr = pr;
    return boxes && tb == b_ext && pr % 16 == 0 && pr >= tb * itemsize &&
           pr <= kBoxRows * itemsize && (ta <= kBoxRows || ta % kBoxRows == 0);
  }
  if (box != kBulkSide) return false;
  sd->run = run;
  sd->run_shift = run > 0 ? __builtin_ctz(static_cast<unsigned int>(run)) : 0;
  sd->pr = pr;
  sd->nbb = sd->box_bytes = 0;
  // several rows a copy: whole rows (all m) that follow each other in the tensor
  const bool follow = tm == m && (k == 1 || ta == a_ext);
  return tb == b_ext && run >= 0 && (run & (run - 1)) == 0 && (run == 1 || follow) &&
         pr % 16 == 0 && (run == 0 ? pr == sd->rb : static_cast<int64_t>(pr) >= int64_t{run} * sd->rb);
}

int side_bytes(const Side& sd, int k, int tm) {
  if (sd.box) return tm / sd.tmb * sd.nbb * sd.nab * sd.box_bytes;
  const int64_t rows = static_cast<int64_t>(k) * sd.ta;
  return round_up(sd.run ? cdiv(rows, sd.run) * sd.pr : rows * sd.rb, kRingAlign);
}

template <int E>
int launch_bulk(const void* in, void* out, int64_t g, int64_t x, int64_t m, int64_t y,
                const Plan& p, cudaStream_t stream) {
  BulkArgs a{};
  a.in = static_cast<const unsigned char*>(in);
  a.out = static_cast<unsigned char*>(out);
  a.g = g;
  a.x = x;
  a.m = m;
  a.y = y;
  a.tx = p.tx;
  a.ty = p.ty;
  a.tm = p.tm;
  a.k = p.k;
  constexpr int V = 16 / E;
  bool ok = x % V == 0 && y % V == 0 && aligned(in, 16) && aligned(out, 16) && p.tx % V == 0 &&
            p.ty % V == 0 && p.tx >= 1 && p.ty >= 1 && p.tm >= 1 && p.tm <= m && p.k >= 1 &&
            p.k <= g && p.stages >= 2 && p.stages <= kMaxStages;
  ok = ok &&
       make_side(&a.in_side, E, x, y, m, p.tx, p.ty, p.tm, p.k, p.in_box, p.in_run, p.in_pr,
                 p.tmb) &&
       make_side(&a.out_side, E, y, x, m, p.ty, p.tx, p.tm, p.k, p.out_box, p.out_run, p.out_pr,
                 p.tmb);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  a.in_bytes = side_bytes(a.in_side, p.k, p.tm);
  a.out_bytes = side_bytes(a.out_side, p.k, p.tm);
  a.stages = p.stages;
  a.pair_y = p.pair_y;
  a.tiles_x = cdiv(x, p.tx);
  a.tiles_y = cdiv(y, p.ty);
  a.m_chunks = cdiv(m, p.tm);
  a.items = cdiv(g, p.k) * a.m_chunks * a.tiles_x * a.tiles_y;
  const int64_t smem = kRingAlign + static_cast<int64_t>(p.stages) * (a.in_bytes + a.out_bytes) +
                       3 * 8 * kMaxStages;
  if (smem != p.smem || smem > kSmemCap || p.blocks < 1 || a.items >= (int64_t{1} << 22))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap in_map{}, out_map{};
  if (p.in_box) {
    const int err = encode_side(&in_map, in, E, a.in_side, g, m);
    if (err) return err;
  }
  if (p.out_box) {
    const int err = encode_side(&out_map, out, E, a.out_side, g, m);
    if (err) return err;
  }
  const int err = raise_smem_cap(reinterpret_cast<const void*>(relayout_bulk_kernel<E>), smem);
  if (err) return err;
  relayout_bulk_kernel<E><<<p.blocks, kBulkThreads, static_cast<size_t>(smem), stream>>>(
      a, in_map, out_map);
  return static_cast<int>(cudaGetLastError());
}

template <typename E, int VI, int VO>
int launch_async(const void* in, void* out, int64_t g, int64_t x, int64_t m, int64_t y,
                 const Plan& p, cudaStream_t stream) {
  const int64_t tiles_y = cdiv(y, p.ty), tiles_x = cdiv(x, p.tx);
  const int64_t groups = cdiv(g * m, p.k);
  auto kernel = p.stages == 2 ? relayout_async_kernel<E, VI, VO> : relayout_kernel<E, VI, VO>;
  const int err = raise_smem_cap(reinterpret_cast<const void*>(kernel), p.smem);
  if (err) return err;
  kernel<<<p.blocks, kRelayoutThreads, static_cast<size_t>(p.smem), stream>>>(
      static_cast<const E*>(in), static_cast<E*>(out), g * m, m, x, y, p.tx, p.ty, p.pitch,
      shift_of(p.lx), shift_of(p.sx), p.k, tiles_y, groups * tiles_x * tiles_y);
  return static_cast<int>(cudaGetLastError());
}

template <typename E, int V>
int launch_copy(const void* in, void* out, int64_t n, int blocks, cudaStream_t stream) {
  copy_kernel<E, V><<<blocks, kRelayoutThreads, 0, stream>>>(static_cast<const E*>(in),
                                                              static_cast<E*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

template <typename E, int VI>
int async_vo(const void* in, void* out, int64_t g, int64_t x, int64_t m, int64_t y,
             const Plan& p, cudaStream_t s) {
  if (p.vo == 1) return launch_async<E, VI, 1>(in, out, g, x, m, y, p, s);
  if (p.vo == 2) return launch_async<E, VI, 2>(in, out, g, x, m, y, p, s);
  if (p.vo == 4) return launch_async<E, VI, 4>(in, out, g, x, m, y, p, s);
  if constexpr (sizeof(E) == 2) {
    if (p.vo == 8) return launch_async<E, VI, 8>(in, out, g, x, m, y, p, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename E>
int dispatch(const void* in, void* out, int64_t g, int64_t x, int64_t m, int64_t y, const Plan& p,
             cudaStream_t s) {
  constexpr int E_ = sizeof(E);
  if (p.arm == kBulk) return launch_bulk<E_>(in, out, g, x, m, y, p, s);
  if (p.arm == kCopy) {
    if (p.vi == 1) return launch_copy<E, 1>(in, out, y, p.blocks, s);
    if (p.vi == 2) return launch_copy<E, 2>(in, out, y, p.blocks, s);
    if (p.vi == 4) return launch_copy<E, 4>(in, out, y, p.blocks, s);
    if constexpr (E_ == 2) {
      if (p.vi == 8) return launch_copy<E, 8>(in, out, y, p.blocks, s);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (p.vi == 1) return async_vo<E, 1>(in, out, g, x, m, y, p, s);
  if (p.vi == 2) return async_vo<E, 2>(in, out, g, x, m, y, p, s);
  if (p.vi == 4) return async_vo<E, 4>(in, out, g, x, m, y, p, s);
  if constexpr (E_ == 2) {
    if (p.vi == 8) return async_vo<E, 8>(in, out, g, x, m, y, p, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace hvi_cidnet

using namespace hvi_cidnet;

// in: (g, x, m, y) contiguous; out: (g, y, m, x) contiguous; itemsize 2 or
// 4 bytes; plan: the 21 ints of ops/relayout_cuda.py:RelayoutPlan.c_plan
// (arm 0: a copy of y elements, g == x == m == 1, in vectors of vi; arm 1:
// the bulk arm; arm 2: the cp.async arm, k whole slabs of G a work item where
// M = 1).
// Returns a cudaError_t code, cudaErrorInvalidValue for a plan it cannot run.
extern "C" int relayout(const void* in, void* out, int itemsize, int64_t g, int64_t x, int64_t m,
                        int64_t y, const int* plan, cudaStream_t stream) {
  Plan p;
  memcpy(&p, plan, sizeof(Plan));
  bool ok = (itemsize == 2 || itemsize == 4) && g >= 1 && x >= 1 && m >= 1 && y >= 1 &&
            p.blocks >= 1;
  if (p.arm == kCopy) {
    ok = ok && g == 1 && x == 1 && m == 1 && p.vi >= 1 && p.vi * itemsize <= 16 &&
         y % p.vi == 0 && aligned(in, p.vi * itemsize) && aligned(out, p.vi * itemsize) &&
         p.smem == 0;
  } else if (p.arm == kAsync) {
    ok = ok && x > 1 && shift_of(p.lx) >= 0 && shift_of(p.sx) >= 0 && p.vi >= 1 && p.vo >= 1 &&
         p.vi * itemsize <= 16 && p.vo * itemsize <= 16 && y % p.vi == 0 && x % p.vo == 0 &&
         aligned(in, p.vi * itemsize) && aligned(out, p.vo * itemsize) && p.tx >= 1 &&
         p.tx <= x && p.ty >= 1 && p.ty <= y && p.tx % p.vo == 0 && p.ty % p.vi == 0 &&
         p.k >= 1 && (p.k == 1 || (m == 1 && p.tx == x && p.ty == y && p.k <= g)) &&
         static_cast<int64_t>(p.pitch) >= static_cast<int64_t>(p.k) * p.ty &&
         (p.stages == 1 || (p.stages == 2 && p.pitch % p.vi == 0)) &&
         static_cast<int64_t>(p.smem) ==
             static_cast<int64_t>(p.stages) * p.tx * p.pitch * itemsize &&
         p.smem <= kSmemCap;
  } else {
    ok = ok && p.arm == kBulk && x > 1;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  if (itemsize == 2) return dispatch<unsigned short>(in, out, g, x, m, y, p, stream);
  return dispatch<unsigned int>(in, out, g, x, m, y, p, stream);
}
