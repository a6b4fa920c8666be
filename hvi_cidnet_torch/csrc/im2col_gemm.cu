// P6: the products of a dense conv staged as im2col, out[b] = W a[b]:
// W (C_out, K) and a (B, K, N) contiguous, one type (fp32 or bf16), fp32
// accumulation, out (B, C_out, N) rounded once to a's type.
//
// Replaces the Pallas kernel experiments/flat_pilot_r3.py:62 `_dot_kernel`
// (via pallas_im2col_dots, call :77), which takes one (K, N) operand whose
// N is a multiple of its tile (its grid drops the columns past the last
// full tile) and reads K and C_out from module globals. This kernel takes
// a batch, any N, any K and C_out <= 144. Plain version: im2col_dots_plain
// in hvi_cidnet_torch/ops/im2col_cuda.py, which also stages the operand of
// a 3x3 conv (F.unfold) for the port's im2col route and holds the launch
// plan.
//
// Bound: bytes. The staged operand is read once (9 C_in values a pixel),
// against 2 C_out flops for each of its values: at C_out = 36, 72 flops for
// 2 bytes in bf16, far below the tensor cores' ~295 a byte.
//
// bf16, `im2col_mma_kernel`: a pipelined GEMM on the tensor cores (wgmma),
// one persistent block of two warpgroups an SM. Block i takes rows [g
// rows, g rows + rows) of W (64 or 128: one or two m64 tiles; C_out 144 in
// two groups of 72) and walks the (image, 256-column) tiles i / groups, i /
// groups + gridDim.x / groups, ...; the groups of a tile run side by side,
// so the second read of its operand comes from L2. Each tile is a sequence
// of 64-deep steps of K, and the steps of all of a block's tiles flow
// through one ring of 3 to 6 stages (what fits in 227 KB), so the next
// tile's loads are in flight under this tile's last products and stores.
// - A stage holds the operand's step (64 K rows x 256 columns) in the
//   128-byte-swizzled MN-major layout that wgmma reads as B, and W's
//   64-deep slice in the 128-byte-swizzled K-major layout it reads as A;
//   W is packed into those slices once a call by im2col_pack_kernel.
// - Where the operand's rows start 16-byte aligned (N % 8 == 0 and an
//   aligned start: N = 240,000, 60,000, 15,000 in the forward) one thread
//   feeds the ring by the TMA unit: four 64 x 64 boxes of a 3-D tensor map
//   (zeros past K and N) and W's slice as one bulk copy, counted by the
//   stage's mbarrier, started as soon as the products leave a stage. Else
//   (N = 3,750, odd starts) every thread copies with cp.async, 2 to 8 bytes
//   at a time, zero past K and N.
// - Warpgroup h runs wgmma m64n128k16 on columns [128 h, 128 h + 128) for
//   each m64 tile of W and 16-deep slice of the step (a bf16 product is
//   exact in fp32; the tensor core sums in fp32).
// - A finished tile is rounded once to bf16. With the TMA unit it goes to a
//   staged row-major tile in shared memory and out by bulk stores, one an
//   output row, that run on while the block goes on; else straight from
//   the accumulators, the lanes of a quad swapping fragments so that each
//   stores 16 bytes where N % 8 == 0 (4-byte pairs or single values else).
// Why this shape (measured on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md
// section 6): mma.sync with fragments in registers re-read W from shared
// memory in every warp each step and stalled on it, and per-thread cp.async
// copies and the epilogue's stores ran one after the other with the
// products; the TMA unit and bulk stores take the copies off the warps, and
// wgmma reads both operands from shared memory once a warpgroup.
// fp32, `im2col_f32_kernel`: the CUDA cores (TF32 would keep three
// digits). Block (x, b) writes columns [128 x, 128 x + 128) of image b for
// every output channel; it walks K in 32-row steps, the step's tile of a
// loaded into registers while the previous step is summed, the weights'
// step (zero past C_out and K) read from L2 beside it. Thread (r, q) owns
// rows [2 MT r, 2 MT r + 2 MT) and columns [4 q, 4 q + 4): a float4 of a
// and float2 broadcasts of W a step, each product an fmaf; a moves in the
// widest loads (VEC elements, at most 16 bytes) that divide N and a's
// offset from a 16-byte boundary.
#include <cuda.h>

#include "common.cuh"
#include "mma.cuh"
#include "tensor_map.cuh"

namespace hvi_cidnet {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kNTile = 128;           // fp32: output columns a block
constexpr int kMaxMT = 9;             // C_out <= 144
constexpr int kKcF = 32;              // fp32: K rows a step
constexpr int kNTileB = 256;          // bf16: output columns a tile, 128 a warpgroup
constexpr int kKsB = 64;              // bf16: K rows a step (one 128-byte swizzle atom of W)
constexpr int kMinStagesB = 3, kMaxStagesB = 6;  // bf16: the ring's stages (the plan picks them)
constexpr int kOpBytesB = kKsB * kNTileB * 2;  // bf16: a stage's operand, 32 KB
constexpr int64_t kSmemLimit = 232448;

inline int64_t f32_smem_bytes(int mt) { return 4LL * (kKcF * kNTile + kKcF * mt * 16); }
constexpr int kOutPitchB = 2 * kNTileB + 16;  // bf16, TMA: the staged output's rows, in bytes
// bf16: the ring's stages (the operand's step and W's 64-deep slice of mr
// m64 tiles); with the TMA unit (tma) also the staged output tile and a
// barrier a stage; and 1 KB to align the stages to the swizzle's 1 KB atoms
inline int64_t mma_smem_bytes(int mr, int stages, bool tma) {
  return static_cast<int64_t>(stages) * (kOpBytesB + mr * 64 * kKsB * 2) +
         (tma ? static_cast<int64_t>(mr) * 64 * kOutPitchB + 8LL * stages : 0) + 1024;
}

template <typename T, int VEC, int KC>
struct ATile {
  static constexpr int kPerRow = kNTile / VEC;
  static constexpr int kLoads = KC * kPerRow / kThreads;
  using V = typename VecBytes<sizeof(T) * VEC>::type;
  V r[kLoads];

  __device__ __forceinline__ void load(const T* __restrict__ ab, int kdim, int64_t n, int k0,
                                       int64_t n0) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int row = idx / kPerRow;
      const int64_t col = n0 + (idx % kPerRow) * VEC;
      if (k0 + row < kdim && col < n) load_vec<sizeof(V)>(&r[i], ab + (k0 + row) * n + col);
      else r[i] = V{};
    }
  }
  __device__ __forceinline__ void store(T* s, int pitch) const {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      store_vec<sizeof(V)>(s + (idx / kPerRow) * pitch + (idx % kPerRow) * VEC, &r[i]);
    }
  }
};

// W, once a call, as the bf16 kernel's slices: wp[g][s][r][64] holds W[g
// rows + r][64 s + c * 8 + e] at c' * 8 + e with c' = c ^ (r % 8) (the
// 128-byte swizzle, K-major), r < 64 mr; zero past the group's rows, C_out
// and K
__global__ void im2col_pack_kernel(const bf16* __restrict__ w, bf16* __restrict__ wp, int kdim,
                                   int cout, int rows, int mrows, int ksteps, int64_t total) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int kk = static_cast<int>(i % kKsB);
    int64_t q = i / kKsB;
    const int r = static_cast<int>(q % mrows);
    q /= mrows;
    const int s = static_cast<int>(q % ksteps), g = static_cast<int>(q / ksteps);
    const int row = g * rows + r, k = s * kKsB + kk;
    wp[i - kk + (((kk >> 3) ^ (r & 7)) << 3) + (kk & 7)] =
        r < rows && row < cout && k < kdim ? w[static_cast<int64_t>(row) * kdim + k]
                                           : __float2bfloat16_rn(0.0f);
  }
}

__device__ __forceinline__ uint32_t pick4(const uint32_t (&v)[4], int i) {
  return i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
}

// one m64 x 128 block of a finished tile from a warpgroup's accumulators
// (d[4 i + 2 h + v]: row 16 (warp % 4) + lane / 4 + 8 h, column 8 i + 2 (lane
// % 4) + v): rows [0, rows) of ob (row 0 = the block's first), columns col0 +
// [0, 128) below n
__device__ __forceinline__ void store_m64(const float (&d)[64], bf16* __restrict__ ob, int rows,
                                          int64_t n, int64_t col0) {
  const int lane = threadIdx.x & 31, q = lane & 3, r0 = ((threadIdx.x >> 5) & 3) * 16;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + (lane >> 2) + 8 * h;
#pragma unroll
    for (int i0 = 0; i0 < 16; i0 += 4) {
      uint32_t v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat162 p =
            __floats2bfloat162_rn(d[4 * (i0 + j) + 2 * h], d[4 * (i0 + j) + 2 * h + 1]);
        v[j] = *reinterpret_cast<const uint32_t*>(&p);
      }
      if (n % 8 == 0) {
        // quad transpose: lane q gathers n8 chunk i0 + q of its row, u[t] = lane t's v[q]
        uint32_t u[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const uint32_t got =
              __shfl_sync(0xffffffffu, pick4(v, (q + t) & 3), (lane & ~3) | ((q - t) & 3));
          const int from = (q - t) & 3;
          u[0] = from == 0 ? got : u[0];
          u[1] = from == 1 ? got : u[1];
          u[2] = from == 2 ? got : u[2];
          u[3] = from == 3 ? got : u[3];
        }
        const int64_t col = col0 + 8 * (i0 + q);
        if (row < rows && col < n)
          *reinterpret_cast<uint4*>(ob + static_cast<int64_t>(row) * n + col) =
              make_uint4(u[0], u[1], u[2], u[3]);
        continue;
      }
      if (row >= rows) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t col = col0 + 8 * (i0 + j) + 2 * q;
        bf16* o = ob + static_cast<int64_t>(row) * n + col;
        if (n % 2 == 0) {  // both columns in or out, one 4-byte store
          if (col < n) *reinterpret_cast<uint32_t*>(o) = v[j];
        } else {
          if (col < n) o[0] = __float2bfloat16_rn(d[4 * (i0 + j) + 2 * h]);
          if (col + 1 < n) o[1] = __float2bfloat16_rn(d[4 * (i0 + j) + 2 * h + 1]);
        }
      }
    }
  }
}

// a block's place in its sequence of steps: K step k of the (image b,
// column tile nt) tile; tiles walker, walker + walkers, ... in 32-bit
// arithmetic, one division a tile (a 64-bit division costs ~100
// instructions, and every thread would pay it every step)
struct StepCursor {
  int k, b, nt;
  __device__ __forceinline__ void start(int walker, int n_tiles) {
    k = 0;
    b = walker / n_tiles;
    nt = walker - b * n_tiles;
  }
  __device__ __forceinline__ void advance(int ksteps, int walkers, int n_tiles) {
    if (++k < ksteps) return;
    k = 0;
    nt += walkers;
    if (nt >= n_tiles) {
      b += nt / n_tiles;
      nt %= n_tiles;
    }
  }
};

// The bf16 GEMM: persistent blocks of two warpgroups; block i takes rows
// [g rows, g rows + rows) of W (g = i % groups, rows <= 64 MR) and walks the
// (image, 256-column) tiles i / groups, i / groups + gridDim.x / groups, ...,
// one step a 64-deep slice of K through a ring of `stages` stages. A stage
// holds the operand's step in the 128-byte-swizzled MN-major layout of
// wgmma's B (four 64-column atoms of 64 rows x 128 bytes, the 16-byte chunk
// c of row k at c ^ (k % 8)) and W's slice (K-major, swizzled likewise,
// packed by im2col_pack_kernel). Warpgroup h runs wgmma m64n128k16 on
// columns [128 h, 128 h + 128) for each m64 tile of W and 16-deep slice.
// - VEC == 8 (rows 16-byte aligned): the TMA unit. Thread 0 loads each step
//   as four 64 x 64 boxes of `tmap` (zeros past K and N) and W's slice as one
//   bulk copy, all counted by the stage's mbarrier, into the stage the
//   products have just left; a finished tile is rounded once into a staged
//   row-major tile and written by bulk stores, one an output row, which run
//   on while the block goes on.
// - Else every thread copies VEC elements at a time with cp.async (zero past
//   K and N), and the tile goes straight from the accumulators to memory.
template <int MR, int VEC>
__global__ void __launch_bounds__(kThreads, 1)
    im2col_mma_kernel(const __grid_constant__ CUtensorMap tmap, const bf16* __restrict__ a,
                      const bf16* __restrict__ wp, bf16* __restrict__ out, int kdim, int cout,
                      int64_t n, int rows, int groups, int n_tiles, int tiles, int ksteps,
                      int stages) {
  constexpr bool kTma = VEC == 8;
  constexpr int kWBytes = MR * 64 * kKsB * 2;  // W's slice of a step
  constexpr int kStageBytes = kOpBytesB + kWBytes;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const unsigned int raw_s = static_cast<unsigned int>(__cvta_generic_to_shared(smem_raw));
  unsigned char* ring = smem_raw + ((1024u - (raw_s & 1023u)) & 1023u);  // 1 KB aligned
  unsigned char* staged = ring + stages * kStageBytes;  // TMA: [64 MR][kOutPitchB]
  uint64_t* bars = reinterpret_cast<uint64_t*>(staged + MR * 64 * kOutPitchB);  // TMA: [stages]
  const int tid = threadIdx.x, wg = tid >> 7;
  const int g = blockIdx.x % groups, row0 = g * rows;
  const int grows = min(rows, cout - row0);  // W's rows of this group
  const int walker = blockIdx.x / groups, walkers = gridDim.x / groups;
  const int my_tiles = walker < tiles ? (tiles - 1 - walker) / walkers + 1 : 0;
  const int steps = my_tiles * ksteps;
  const bf16* wg_src = wp + static_cast<int64_t>(g) * ksteps * (kWBytes / 2);

  if constexpr (kTma) {
    if (tid == 0) {
      for (int i = 0; i < stages; ++i) mbar_init(bars + i, 1);
      mbar_fence_init();
    }
    __syncthreads();
  }
  // step s into stage st (TMA: thread 0 alone; else every thread, one commit
  // group, empty past the end); `ahead` walks the steps `lead` before the
  // products' cursor: TMA refills a stage as soon as the products leave it,
  // cp.async one step later (at the next step's barrier)
  StepCursor ahead, cur;
  ahead.start(walker, n_tiles);
  cur.start(walker, n_tiles);
  auto fill = [&](int s, int st) {
    if (s < steps) {
      unsigned char* sb = ring + st * kStageBytes;
      const int k0 = ahead.k * kKsB;
      const unsigned char* wsrc =
          reinterpret_cast<const unsigned char*>(wg_src) + static_cast<int64_t>(ahead.k) * kWBytes;
      if constexpr (kTma) {
        mbar_arrive_expect(bars + st, kStageBytes);
#pragma unroll
        for (int at = 0; at < kNTileB / 64; ++at)
          tma_load_3d(sb + at * (kKsB * 128), &tmap, ahead.nt * kNTileB + 64 * at, k0, ahead.b,
                      bars + st);
        bulk_copy(sb + kOpBytesB, wsrc, kWBytes, bars + st);
      } else {
        const bf16* ab = a + static_cast<int64_t>(ahead.b) * kdim * n;
        const int64_t n0 = static_cast<int64_t>(ahead.nt) * kNTileB;
        constexpr int kPerRow = kNTileB / VEC;
#pragma unroll 4
        for (int i = tid; i < kKsB * kPerRow; i += kThreads) {
          const int row = i / kPerRow, col = (i % kPerRow) * VEC;
          const bool valid = k0 + row < kdim && n0 + col < n;
          unsigned char* dst = sb + (col >> 6) * (kKsB * 128) + row * 128 +
                               ((((col >> 3) & 7) ^ (row & 7)) << 4) + (col & 7) * 2;
          cp_async_zfill<2 * VEC>(
              dst, valid ? ab + static_cast<int64_t>(k0 + row) * n + n0 + col : ab, valid);
        }
        for (int i = tid; i < kWBytes / 16; i += kThreads)
          cp_async16(sb + kOpBytesB + 16 * i, wsrc + 16 * i);
      }
      ahead.advance(ksteps, walkers, n_tiles);
    }
    if constexpr (!kTma) cp_async_commit();
  };
  const int lead = kTma ? stages : stages - 1;
  if (!kTma || tid == 0)
    for (int s = 0; s < lead; ++s) fill(s, s);

  float acc[MR][64];
#pragma unroll
  for (int mr = 0; mr < MR; ++mr)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[mr][i] = 0.0f;
  int stage = 0;           // s % stages
  unsigned int phase = 0;  // TMA: (s / stages) % 2, the parity of the stage's barrier
  for (int s = 0; s < steps; ++s) {
    if constexpr (kTma) {
      mbar_wait(bars + stage, phase);  // step s has landed
    } else {
      cp_async_wait_dyn(stages - 2);  // step s has landed (this thread's copies)
      fence_proxy_async();            // ... and is visible to wgmma's reads
      __syncthreads();                // everyone's; step s - 1's products are done with its stage
      fill(s + stages - 1, stage == 0 ? stages - 1 : stage - 1);
    }
    const unsigned char* sb = ring + stage * kStageBytes;
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kKsB / 16; ++j) {
      // B: columns 128 wg + [0, 128) = atoms 2 wg, 2 wg + 1 (LBO: an atom),
      // rows 16 j + [0, 16) (SBO: 8 rows of 128 bytes)
      const uint64_t db = wgmma_desc(sb + wg * 2 * (kKsB * 128) + j * 16 * 128, kKsB * 128, 1024);
#pragma unroll
      for (int mr = 0; mr < MR; ++mr) {
        // A: W's rows 64 mr + [0, 64) (SBO: 8 rows), K 16 j + [0, 16) (32 bytes in)
        const uint64_t da = wgmma_desc(sb + kOpBytesB + mr * 64 * 128 + j * 32, 16, 1024);
        wgmma_m64n128k16(acc[mr], da, db, cur.k > 0 || j > 0);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int mr = 0; mr < MR; ++mr) wgmma_fence_acc(acc[mr]);
    if constexpr (kTma) {
      __syncthreads();  // both warpgroups' products are done with the stage
      if (tid == 0) fill(s + stages, stage);
    }
    if (++stage == stages) {
      stage = 0;
      phase ^= 1u;
    }
    if (cur.k == ksteps - 1) {
      const int64_t n0 = static_cast<int64_t>(cur.nt) * kNTileB;
      bf16* ob = out + (static_cast<int64_t>(cur.b) * cout + row0) * n;
      if constexpr (kTma) {
        // d[4 i + 2 h + v]: row 64 mr + 16 (warp % 4) + lane / 4 + 8 h, column
        // 128 wg + 8 i + 2 (lane % 4) + v
        if (tid < MR * 64) bulk_wait_read();  // the last tile's stores have read `staged`
        __syncthreads();
        const int lane = tid & 31, r = ((tid >> 5) & 3) * 16 + (lane >> 2);
#pragma unroll
        for (int mr = 0; mr < MR; ++mr)
#pragma unroll
          for (int i = 0; i < 16; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const __nv_bfloat162 v =
                  __floats2bfloat162_rn(acc[mr][4 * i + 2 * h], acc[mr][4 * i + 2 * h + 1]);
              *reinterpret_cast<__nv_bfloat162*>(
                  staged + (64 * mr + r + 8 * h) * kOutPitchB +
                  2 * (128 * wg + 8 * i + 2 * (lane & 3))) = v;
            }
        fence_proxy_async();  // the staged tile, seen by the copy engine
        __syncthreads();
        if (tid < grows) {
          bulk_store(ob + static_cast<int64_t>(tid) * n + n0, staged + tid * kOutPitchB,
                     2u * static_cast<unsigned int>(min64(kNTileB, n - n0)));
          bulk_commit();
        }
      } else {
#pragma unroll
        for (int mr = 0; mr < MR; ++mr)
          store_m64(acc[mr], ob + static_cast<int64_t>(mr) * 64 * n, grows - 64 * mr, n,
                    n0 + wg * 128);
      }
    }
    cur.advance(ksteps, walkers, n_tiles);
  }
  if constexpr (kTma) {
    if (tid < MR * 64) bulk_wait_all();  // the last stores are done with `staged`
  } else {
    cp_async_wait<0>();  // no copy outlives the block
  }
}

template <int MT, int VEC>
__global__ void __launch_bounds__(kThreads)
    im2col_f32_kernel(const float* __restrict__ a, const float* __restrict__ w,
                      float* __restrict__ out, int kdim, int cout, int64_t n) {
  constexpr int kM = MT * 16, kRows = 2 * MT;
  extern __shared__ __align__(16) float smem_f[];
  float* as = smem_f;               // [kKcF][kNTile]
  float* ws = as + kKcF * kNTile;   // [kKcF][kM]: W^T, a thread's rows side by side
  const int q = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * kRows;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kNTile;
  const int64_t b = blockIdx.y;
  const float* ab = a + b * kdim * n;

  float acc[kRows][4];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  constexpr int kWLoads = kKcF * kM / kThreads;
  ATile<float, VEC, kKcF> tile;
  tile.load(ab, kdim, n, 0, n0);
  for (int k0 = 0; k0 < kdim; k0 += kKcF) {
    float wr[kWLoads];  // element (kk, m) = idx / kM, idx % kM of the step's weights, transposed
#pragma unroll
    for (int i = 0; i < kWLoads; ++i) {
      const int idx = threadIdx.x + i * kThreads, kk = idx / kM, m = idx % kM;
      wr[i] = m < cout && k0 + kk < kdim ? w[static_cast<int64_t>(m) * kdim + k0 + kk] : 0.0f;
    }
    __syncthreads();
    tile.store(as, kNTile);
#pragma unroll
    for (int i = 0; i < kWLoads; ++i) ws[threadIdx.x + i * kThreads] = wr[i];
    __syncthreads();
    if (k0 + kKcF < kdim) tile.load(ab, kdim, n, k0 + kKcF, n0);
    const int kn = min(kKcF, kdim - k0);
    for (int kk = 0; kk < kn; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(as + kk * kNTile + 4 * q);
      const float* wr = ws + kk * kM + r0;
#pragma unroll
      for (int i = 0; i < kRows; i += 2) {
        const float2 wv = *reinterpret_cast<const float2*>(wr + i);
        acc[i][0] = fmaf(wv.x, av.x, acc[i][0]);
        acc[i][1] = fmaf(wv.x, av.y, acc[i][1]);
        acc[i][2] = fmaf(wv.x, av.z, acc[i][2]);
        acc[i][3] = fmaf(wv.x, av.w, acc[i][3]);
        acc[i + 1][0] = fmaf(wv.y, av.x, acc[i + 1][0]);
        acc[i + 1][1] = fmaf(wv.y, av.y, acc[i + 1][1]);
        acc[i + 1][2] = fmaf(wv.y, av.z, acc[i + 1][2]);
        acc[i + 1][3] = fmaf(wv.y, av.w, acc[i + 1][3]);
      }
    }
  }

  const int64_t col = n0 + 4 * q;
  float* ob = out + b * cout * n;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = r0 + i;
    if (row >= cout) continue;
    float* o = ob + static_cast<int64_t>(row) * n + col;
    if (VEC == 4 && col < n) {  // n % 4 == 0: the four columns are in or out together
      *reinterpret_cast<float4*>(o) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (col + j < n) o[j] = acc[i][j];
    }
  }
}

template <int MT>
int launch_f32(const void* a, const void* w, void* out, int64_t b, int kdim, int cout, int64_t n,
               int vec, int64_t n_tiles, int64_t smem, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned int>(n_tiles), static_cast<unsigned int>(b));
  const size_t sm = static_cast<size_t>(smem);
  const float* ap = static_cast<const float*>(a);
  const float* wp = static_cast<const float*>(w);
  float* op = static_cast<float*>(out);
  if (vec == 4)
    im2col_f32_kernel<MT, 4><<<grid, kThreads, sm, stream>>>(ap, wp, op, kdim, cout, n);
  else if (vec == 2)
    im2col_f32_kernel<MT, 2><<<grid, kThreads, sm, stream>>>(ap, wp, op, kdim, cout, n);
  else im2col_f32_kernel<MT, 1><<<grid, kThreads, sm, stream>>>(ap, wp, op, kdim, cout, n);
  return static_cast<int>(cudaGetLastError());
}

template <int MR, int VEC>
int launch_mma_vec(const CUtensorMap& tmap, const bf16* a, const bf16* wp, bf16* out, int kdim,
                   int cout, int64_t n, int rows, int groups, int n_tiles, int tiles, int ksteps,
                   int stages, int64_t blocks, int64_t smem, cudaStream_t stream) {
  const int err = raise_smem_cap(reinterpret_cast<const void*>(im2col_mma_kernel<MR, VEC>), smem);
  if (err) return err;
  im2col_mma_kernel<MR, VEC><<<static_cast<unsigned int>(blocks), kThreads,
                               static_cast<size_t>(smem), stream>>>(
      tmap, a, wp, out, kdim, cout, n, rows, groups, n_tiles, tiles, ksteps, stages);
  return static_cast<int>(cudaGetLastError());
}

template <int MR>
int launch_mma(const void* a, const void* w, void* wpack, void* out, int64_t b, int kdim,
               int cout, int64_t n, int vec, int groups, int64_t n_tiles, int stages,
               int64_t blocks, int64_t smem, cudaStream_t stream) {
  const int rows = (cout + groups - 1) / groups, ksteps = (kdim + kKsB - 1) / kKsB;
  const int64_t total = static_cast<int64_t>(groups) * ksteps * MR * 64 * kKsB;
  const int64_t pack_need = (total + kThreads - 1) / kThreads;
  im2col_pack_kernel<<<static_cast<int>(pack_need < 1024 ? pack_need : 1024), kThreads, 0,
                       stream>>>(static_cast<const bf16*>(w), static_cast<bf16*>(wpack), kdim,
                                 cout, rows, MR * 64, ksteps, total);
  const bf16* ap = static_cast<const bf16*>(a);
  const bf16* wp = static_cast<const bf16*>(wpack);
  bf16* op = static_cast<bf16*>(out);
  const int tiles = static_cast<int>(b * n_tiles), nt = static_cast<int>(n_tiles);
  CUtensorMap tmap{};
  if (vec == 8) {  // the operand as (n, kdim, b), 64 x 64 boxes, 128-byte swizzle, zeros outside
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(kdim),
                                static_cast<cuuint64_t>(b)};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(n) * 2,
                                   static_cast<cuuint64_t>(n) * kdim * 2};
    const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(kKsB), 1};
    const cuuint32_t unit[3] = {1, 1, 1};
    if (encode(&tmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(a), dims, strides,
               box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_mma_vec<MR, 8>(tmap, ap, wp, op, kdim, cout, n, rows, groups, nt, tiles, ksteps,
                                 stages, blocks, smem, stream);
  }
  if (vec == 4)
    return launch_mma_vec<MR, 4>(tmap, ap, wp, op, kdim, cout, n, rows, groups, nt, tiles, ksteps,
                                 stages, blocks, smem, stream);
  if (vec == 2)
    return launch_mma_vec<MR, 2>(tmap, ap, wp, op, kdim, cout, n, rows, groups, nt, tiles, ksteps,
                                 stages, blocks, smem, stream);
  return launch_mma_vec<MR, 1>(tmap, ap, wp, op, kdim, cout, n, rows, groups, nt, tiles, ksteps,
                               stages, blocks, smem, stream);
}

}  // namespace
}  // namespace hvi_cidnet

using namespace hvi_cidnet;

// a: (b, kdim, n), w: (cout, kdim), out: (b, cout, n), contiguous, one type
// (dtype). The plan of ops/im2col_cuda.py:im2col_plan: m_tiles (16-row
// tiles of W a block: fp32 ceil(cout / 16); bf16 64 or 128 rows, 4 or 8),
// vec (elements a copy of a: a power of two of at most 16 bytes that divides
// n and a's offset from a 16-byte boundary; out starts aligned), n_tiles
// (column tiles of an image: 128 fp32, 256 bf16), smem (dynamic shared
// memory in bytes). bf16 also: wpack (scratch for W's packed slices, groups
// x ceil(kdim / 64) x 16 m_tiles x 64 elements), groups (blocks that share
// a tile, each ceil(cout / groups) rows of W), blocks (the persistent grid,
// a multiple of groups), stages (the ring's, 3 to 6); fp32 takes groups 1,
// blocks n_tiles b, stages 0. Returns a cudaError_t code,
// cudaErrorInvalidValue for a plan it cannot run.
extern "C" int im2col_dots(const void* a, const void* w, void* wpack, void* out, int dtype,
                           int64_t b, int kdim, int cout, int64_t n, int m_tiles, int vec,
                           int64_t n_tiles, int64_t smem, int groups, int64_t blocks, int stages,
                           cudaStream_t stream) {
  const bool bf = dtype == kBFloat16;
  const int64_t vec_bytes = static_cast<int64_t>(vec) * (bf ? 2 : 4);
  const auto aligned = [](const void* p, int64_t bytes) {
    return reinterpret_cast<uintptr_t>(p) % bytes == 0;
  };
  if ((!bf && dtype != kFloat32) || b < 1 || b > 65535 || kdim < 1 || cout < 1 ||
      cout > kMaxMT * 16 || n < 1 || vec < 1 || (vec & (vec - 1)) || vec_bytes > 16 || n % vec ||
      !aligned(a, vec_bytes) || !aligned(out, vec_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!bf) {
    if (m_tiles != (cout + 15) / 16 || n_tiles != (n + kNTile - 1) / kNTile ||
        n_tiles > 2147483647LL || smem != f32_smem_bytes(m_tiles) || groups != 1 ||
        blocks != n_tiles * b)
      return static_cast<int>(cudaErrorInvalidValue);
#define HVI_P6_F32(MTV) \
  case MTV:             \
    return launch_f32<MTV>(a, w, out, b, kdim, cout, n, vec, n_tiles, smem, stream);
    switch (m_tiles) {
      HVI_P6_F32(1)
      HVI_P6_F32(2)
      HVI_P6_F32(3)
      HVI_P6_F32(4)
      HVI_P6_F32(5)
      HVI_P6_F32(6)
      HVI_P6_F32(7)
      HVI_P6_F32(8)
      HVI_P6_F32(9)
    }
#undef HVI_P6_F32
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int mr = m_tiles / 4, ksteps = (kdim + kKsB - 1) / kKsB;
  if (groups < 1 || (m_tiles != 4 && m_tiles != 8) ||
      (cout + groups - 1) / groups > 64 * mr || (cout + groups - 1) / groups <= 64 * (mr - 1) ||
      n_tiles != (n + kNTileB - 1) / kNTileB || b * n_tiles * ksteps > 2147483647LL ||
      blocks < groups || blocks % groups || blocks > 2147483647LL || stages < kMinStagesB ||
      stages > kMaxStagesB || smem != mma_smem_bytes(mr, stages, vec == 8) || smem > kSmemLimit ||
      wpack == nullptr || !aligned(wpack, 16) || !aligned(out, 16))
    return static_cast<int>(cudaErrorInvalidValue);
  return mr == 1 ? launch_mma<1>(a, w, wpack, out, b, kdim, cout, n, vec, groups, n_tiles,
                                 stages, blocks, smem, stream)
                 : launch_mma<2>(a, w, wpack, out, b, kdim, cout, n, vec, groups, n_tiles,
                                 stages, blocks, smem, stream);
}
