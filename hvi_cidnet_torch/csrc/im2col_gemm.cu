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
// Design: block (x, b) writes columns [128 x, 128 x + 128) of image b for
// every output channel (C_out padded to MT 16-row tiles with zero
// weights). It walks K in steps (64 rows bf16, 32 fp32): the step's
// (K-step x 128) tile of a is loaded into registers while the previous
// step is summed, then stored to shared memory; rows past K and columns
// past N are zero. The weights' step (zero past C_out and K) is read from
// L2 into registers, all of its loads in flight at once, before the step's
// first barrier, then stored to shared memory beside the operand's.
// - bf16: the tensor cores. Warp w owns columns [16 w, 16 w + 16): per
//   16-deep slice, one ldmatrix.trans of a (two n8 fragments) and, per
//   m16 tile, one ldmatrix of W and two mma.sync m16n8k16 bf16 -> fp32
//   (a bf16 product is exact in fp32; the tensor core sums in fp32).
// - fp32: the CUDA cores (TF32 would keep three digits). Thread (r, q)
//   owns rows [2 MT r, 2 MT r + 2 MT) and columns [4 q, 4 q + 4): a float4
//   of a and float2 broadcasts of W a step, each product an fmaf.
// a moves in the widest loads (VEC elements, at most 16 bytes) that divide
// N and a's offset from a 16-byte boundary: 16 bytes at N = 240,000,
// 60,000 and 15,000, 4 bytes (bf16) at N = 3,750.
#include "common.cuh"
#include "mma.cuh"

namespace hvi_cidnet {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kNTile = 128;           // output columns a block
constexpr int kMaxMT = 9;             // C_out <= 144
constexpr int kKcB = 64;              // bf16: K rows a step
constexpr int kAPitchB = kNTile + 8;  // 272 bytes: ldmatrix rows on distinct banks
constexpr int kWPitchB = kKcB + 8;    // 144 bytes
constexpr int kKcF = 32;              // fp32: K rows a step

__host__ __device__ inline int64_t smem_bytes(int dtype, int mt) {
  return dtype == kBFloat16 ? 2LL * (kKcB * kAPitchB + mt * 16 * kWPitchB)
                            : 4LL * (kKcF * kNTile + kKcF * mt * 16);
}

// a's (kc x kNTile) step at rows [k0, k0 + kc), columns [n0, n0 + kNTile)
// of one image, VEC elements a load, into registers; zero past K and N
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

template <int MT, int VEC>
__global__ void __launch_bounds__(kThreads)
    im2col_mma_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w,
                      bf16* __restrict__ out, int kdim, int cout, int64_t n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* as = reinterpret_cast<bf16*>(smem_raw);  // [kKcB][kAPitchB]
  bf16* ws = as + kKcB * kAPitchB;               // [MT * 16][kWPitchB]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kNTile;
  const int64_t b = blockIdx.y;
  const bf16* ab = a + b * kdim * n;
  const bf16 zero = __float2bfloat16_rn(0.0f);

  float acc[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

  constexpr int kWLoads = MT * 16 * kKcB / kThreads;
  ATile<bf16, VEC, kKcB> tile;
  tile.load(ab, kdim, n, 0, n0);
  for (int k0 = 0; k0 < kdim; k0 += kKcB) {
    bf16 wr[kWLoads];  // element (m, kk) = idx / kKcB, idx % kKcB of the step's weights
#pragma unroll
    for (int i = 0; i < kWLoads; ++i) {
      const int idx = threadIdx.x + i * kThreads, m = idx / kKcB, kk = idx % kKcB;
      wr[i] = m < cout && k0 + kk < kdim ? w[static_cast<int64_t>(m) * kdim + k0 + kk] : zero;
    }
    __syncthreads();  // the last step's readers are done
    tile.store(as, kAPitchB);
#pragma unroll
    for (int i = 0; i < kWLoads; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      ws[(idx / kKcB) * kWPitchB + idx % kKcB] = wr[i];
    }
    __syncthreads();
    if (k0 + kKcB < kdim) tile.load(ab, kdim, n, k0 + kKcB, n0);
    const int steps = min(kKcB / 16, (kdim - k0 + 15) / 16);
    for (int s = 0; s < steps; ++s) {
      uint32_t bf[4];  // the n8 fragments of columns [16 warp, 16 warp + 8) and [+8, +16)
      ldmatrix_x4_trans(bf, as + (s * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kAPitchB +
                                warp * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t af[4];
        ldmatrix_x4(af, ws + (mt * 16 + (lane & 15)) * kWPitchB + s * 16 + (lane >> 4) * 8);
        mma_bf16(acc[mt][0], af, bf[0], bf[1]);
        mma_bf16(acc[mt][1], af, bf[2], bf[3]);
      }
    }
  }

  // d[0], d[1]: row 16 mt + lane / 4, columns 2 (lane % 4) and + 1; d[2], d[3]: row + 8
  bf16* ob = out + b * cout * n;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int64_t col = n0 + warp * 16 + nt * 8 + 2 * (lane & 3);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = mt * 16 + (lane >> 2) + 8 * h;
        if (row >= cout) continue;
        bf16* o = ob + static_cast<int64_t>(row) * n + col;
        if (VEC >= 2 && col < n) {  // n even: both columns in, one 4-byte store
          *reinterpret_cast<__nv_bfloat162*>(o) =
              __floats2bfloat162_rn(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
        } else {
          if (col < n) o[0] = __float2bfloat16_rn(acc[mt][nt][2 * h]);
          if (col + 1 < n) o[1] = __float2bfloat16_rn(acc[mt][nt][2 * h + 1]);
        }
      }
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
int launch_mt(const void* a, const void* w, void* out, int dtype, int64_t b, int kdim, int cout,
              int64_t n, int vec, int64_t n_tiles, int64_t smem, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned int>(n_tiles), static_cast<unsigned int>(b));
  const size_t sm = static_cast<size_t>(smem);
  if (dtype == kBFloat16) {
    const bf16* ap = static_cast<const bf16*>(a);
    const bf16* wp = static_cast<const bf16*>(w);
    bf16* op = static_cast<bf16*>(out);
    if (vec == 8) im2col_mma_kernel<MT, 8><<<grid, kThreads, sm, stream>>>(ap, wp, op, kdim, cout, n);
    else if (vec == 4) im2col_mma_kernel<MT, 4><<<grid, kThreads, sm, stream>>>(ap, wp, op, kdim, cout, n);
    else if (vec == 2) im2col_mma_kernel<MT, 2><<<grid, kThreads, sm, stream>>>(ap, wp, op, kdim, cout, n);
    else im2col_mma_kernel<MT, 1><<<grid, kThreads, sm, stream>>>(ap, wp, op, kdim, cout, n);
  } else {
    const float* ap = static_cast<const float*>(a);
    const float* wp = static_cast<const float*>(w);
    float* op = static_cast<float*>(out);
    if (vec == 4) im2col_f32_kernel<MT, 4><<<grid, kThreads, sm, stream>>>(ap, wp, op, kdim, cout, n);
    else if (vec == 2) im2col_f32_kernel<MT, 2><<<grid, kThreads, sm, stream>>>(ap, wp, op, kdim, cout, n);
    else im2col_f32_kernel<MT, 1><<<grid, kThreads, sm, stream>>>(ap, wp, op, kdim, cout, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace hvi_cidnet

using namespace hvi_cidnet;

// a: (b, kdim, n), w: (cout, kdim), out: (b, cout, n), contiguous, one type
// (dtype). m_tiles, vec, n_tiles, smem: the plan of ops/im2col_cuda.py:
// im2col_plan (16-row tiles of C_out, elements a load of a, 128-column
// tiles, dynamic shared memory in bytes; vec: a power of two of at most
// 16 bytes that divides n and a's and out's offsets from a 16-byte
// boundary). Returns a cudaError_t code,
// cudaErrorInvalidValue for a plan it cannot run.
extern "C" int im2col_dots(const void* a, const void* w, void* out, int dtype, int64_t b,
                           int kdim, int cout, int64_t n, int m_tiles, int vec, int64_t n_tiles,
                           int64_t smem, cudaStream_t stream) {
  const bool bf = dtype == kBFloat16;
  const int64_t vec_bytes = static_cast<int64_t>(vec) * (bf ? 2 : 4);
  const auto aligned = [vec_bytes](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % vec_bytes == 0;
  };
  if ((!bf && dtype != kFloat32) || b < 1 || b > 65535 || kdim < 1 || cout < 1 ||
      cout > kMaxMT * 16 || n < 1 || m_tiles != (cout + 15) / 16 ||
      n_tiles != (n + kNTile - 1) / kNTile || n_tiles > 2147483647LL ||
      vec < 1 || (vec & (vec - 1)) || vec_bytes > 16 || n % vec || !aligned(a) ||
      !aligned(out) ||
      smem != smem_bytes(dtype, m_tiles))
    return static_cast<int>(cudaErrorInvalidValue);
#define HVI_P6_MT(MTV) \
  case MTV:            \
    return launch_mt<MTV>(a, w, out, dtype, b, kdim, cout, n, vec, n_tiles, smem, stream);
  switch (m_tiles) {
    HVI_P6_MT(1)
    HVI_P6_MT(2)
    HVI_P6_MT(3)
    HVI_P6_MT(4)
    HVI_P6_MT(5)
    HVI_P6_MT(6)
    HVI_P6_MT(7)
    HVI_P6_MT(8)
    HVI_P6_MT(9)
  }
#undef HVI_P6_MT
  return static_cast<int>(cudaErrorInvalidValue);
}
