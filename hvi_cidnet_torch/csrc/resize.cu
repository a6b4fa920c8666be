// K3 and K4: bilinear x0.5 (+ PReLU) and bilinear x2, align_corners=True,
// on NCHW activations.
//
// Replaces the Pallas kernels of hvi_cidnet_tpu/ops/resize_pallas.py:
//   K3 _half_kernel   (:76, call :120 in scale_half_pallas :107; model
//      dispatcher half_prelu :238) -> resize_half_prelu below;
//   K4 _double_kernel (:143, call :184 in scale_double_pallas :171; model
//      dispatcher double_bilinear :273) -> resize_double below.
// Reference semantics: nn.UpsamplingBilinear2d(0.5 / 2) in NormDownsample /
// NormUpsample (net/transformer_utils.py:38-40, 57-59). The plain twins are
// half_prelu_plain / double_bilinear_plain in ops/resize_cuda.py, which run
// the same taps and weights in the same order (bitwise equal in fp32 and bf16).
//
// What carries over from the TPU kernels is the arithmetic, not the layout:
// per axis the x0.5 output i reads source rows {2i, 2i+1, 2i+2} and the x2
// output reads two neighbours of i/2; the weights are the exact rows of the
// dense align_corners interpolation matrix (ops/resize.py:_band_weights),
// computed once per size on the host in float64 and uploaded as fp32, so
// they are bitwise the JAX package's weights. The H pass runs first, then
// the W pass, both in fp32, with one rounding to the output type (and the
// PReLU of K3 applied in fp32 before it), as the Pallas kernels do.
//
// Edge taps: K3's third tap on the last output row/column (source 2i+2 == H)
// and K4's outer taps at the borders have weight 0 and fall outside the
// image; the index is clamped to the edge so nothing reads past the tensor
// (0 * NaN from an out-of-bounds read would be NaN).
//
// K3 is bound by bytes: it reads the input once and writes a quarter as
// much (1.25 x input bytes; loads are 80% of them) for ~12 multiply-adds
// per output. The first design (one thread per output in a 64-bit
// grid-stride loop: two 64-bit divisions, nine scalar 2-byte loads, six
// weight loads and a 2-byte store per output) ran at a third of the bound.
// The design, after K4's:
//   - blocks of (plane, band of output rows, group of column chunks) with a
//     launch plan from the host (ops/resize_cuda.py:half_plan, cached per
//     shape): three divisions per block and none per element, 64-bit
//     arithmetic only for plane and row offsets. Column groups vary fastest
//     and a thread row spans a whole output row where it fits (tx = the
//     row's chunks, up to 128), so a block reads whole lines;
//   - loads are the widest aligned vector the source row pitch and the
//     base address allow (the plan's `load`: 16 B for a bf16 row of 600,
//     8 B at 300, 4 B at 150), and each thread loads one such vector per
//     source row (two 2-byte loads at the narrowest): neighbouring threads
//     read neighbouring vectors, so a warp's load is one contiguous run of
//     a row. A thread owns the load's output columns (half its elements:
//     4 / 2 / 1 bf16 at block1 / 2 / 3) plus one halo column, and stores
//     them as one vector (8 / 4 / 2 B: the widest the output pitch allows
//     at those sites);
//   - each thread walks a band of output rows i, loading only source rows
//     2i+1 and 2i+2 per step: row 2i+2 stays in registers as the next
//     step's row 2i, so each input row is read once (the band's first row
//     and the halo columns aside, which the L1 serves);
//   - latency: the next step's two rows are loaded into registers before
//     this step computes (software pipelining by one step). Registers do
//     it, not a cp.async ring as in K7: a thread's state is a few rows of
//     at most 18 bytes, and no input element but the halo serves two
//     threads, so shared memory would only add a copy. (On the card a first
//     cut that gave each thread 16 bytes of output, two 16-byte loads per
//     row, took 128 registers, spilled at the narrow widths and ran block3
//     no faster than the one-output-per-thread design; loading two steps
//     ahead instead of one was no faster.)
//   - weights load once per thread (the chunk's W taps) and per step (the
//     row's three H taps); the order of operations is the twin's, so K3 is
//     bitwise equal to it in fp32 and bf16.
//
// K4 is bound by bytes: it reads the input once and writes four times as
// much (5 x input bytes; stores are 80% of them) for 6 multiply-adds per
// output. What held the first design at ~140 G outputs/s, far below that,
// was per-output work: two 64-bit divisions for the indices, eight weight
// and tap loads and a 2-byte store per output. The design:
//   - blocks of (plane, band of source rows, group of column chunks) with a
//     launch plan from the host (ops/resize_cuda.py:double_plan): three
//     divisions per block and none per element, 64-bit arithmetic only for
//     plane and row offsets. Column groups vary fastest over the grid and a
//     warp writes 512 contiguous bytes of a row, so the blocks resident
//     together write whole lines of a few planes (64-byte strips scattered
//     over every plane ran bf16 at half the speed);
//   - each thread owns 16 bytes of output columns (8 bf16 / 4 fp32, from an
//     even column 2s) and walks a few source rows j, writing output rows 2j
//     and 2j+1. Source rows j-1, j, j+1 live in registers and one new row
//     is loaded per step, so each loaded element serves four outputs;
//   - the H-pass value of each source column is computed once per output
//     row and feeds the two to four output columns that read it;
//   - stores are the widest aligned vector the row pitch allows (the plan's
//     `store`): 16 B when 2w * sizeof(T) is a multiple of 16 (600 x 400's
//     block1 in bf16), else 8 B or 4 B. 2w is even, so a pair always fits.
//     Rows at a 300 B or 600 B pitch start only 4- or 8-byte aligned, which
//     is why the width is per launch and not fixed at 16 B.
#include "common.cuh"

namespace hvi_cidnet {
namespace {

// K3 takes a launch plan (ops/resize_cuda.py:half_plan): block (tx, ty), a
// 1-D grid of planes x gy row bands x gz column groups, column groups
// fastest. A thread owns one chunk of kOut output columns [c0, c0 + kOut)
// and walks `rows_per_thread` output rows i; each step reads source rows
// 2i+1 and 2i+2 at source columns [2 c0, 2 c0 + 2 kOut], the last of which
// (the halo) is the next chunk's first. The chunk is what one vector load
// of kLoad elements covers (kOut = kLoad / 2; two loads when kLoad is 1),
// so neighbouring threads load neighbouring vectors: a warp's load is
// contiguous. kLoad divides w, so chunks tile the output row exactly and
// each is one aligned store of kOut elements (kOut divides w / 2).
constexpr int kMaxHalfThreads = 512;

template <typename T, int kLoad>
struct HalfChunk {
  static constexpr int kOut = kLoad > 1 ? kLoad / 2 : 1;  // output columns
  static constexpr int kIn = 2 * kOut;                    // source columns but the halo
};

// One source row of a chunk as loaded: 2 kOut elements in kIn / kLoad
// aligned vectors, and the halo column
template <typename T, int kLoad>
struct HalfRow {
  alignas(16) T v[HalfChunk<T, kLoad>::kIn];
  T halo;

  __device__ __forceinline__ void load(const T* __restrict__ row, int s0, int halo_col) {
#pragma unroll
    for (int q = 0; q < HalfChunk<T, kLoad>::kIn / kLoad; ++q)
      load_vec<kLoad * sizeof(T)>(v + q * kLoad, row + s0 + q * kLoad);
    halo = row[halo_col];
  }
  __device__ __forceinline__ float operator[](int e) const {
    return e < HalfChunk<T, kLoad>::kIn ? load_f32(v, e) : load_f32(&halo, 0);
  }
};

template <typename T, int kLoad>
__global__ void __launch_bounds__(kMaxHalfThreads)
    half_prelu_kernel(const T* __restrict__ x, T* __restrict__ out, const float* __restrict__ wh,
                      const float* __restrict__ ww, const float* __restrict__ alpha_ptr, int h,
                      int w, int rows_per_thread, int gy, int gz) {
  using C = HalfChunk<T, kLoad>;
  const int ho = h / 2, wo = w / 2;
  // (plane, band, column group) of this block: divisions once per block
  const unsigned int bz = blockIdx.x % gz, rest = blockIdx.x / gz;
  const unsigned int by = rest % gy;
  const int64_t plane = rest / gy;
  const int c0 = (bz * blockDim.x + threadIdx.x) * C::kOut;
  const int i0 = (by * blockDim.y + threadIdx.y) * rows_per_thread;
  if (c0 >= wo || i0 >= ho) return;
  const int i1 = min(ho, i0 + rows_per_thread);
  const T* src = x + plane * h * w;
  T* dst = out + plane * ho * wo + c0;
  const int s0 = 2 * c0;
  // the halo column, clamped: at the right edge of an even row it is w (weight 0)
  const int halo = min(s0 + C::kIn, w - 1);
  const float alpha = *alpha_ptr;

  // W-pass weights of the chunk's outputs, loaded once; ww = [a | b | c] by
  // output column
  float wa[C::kOut], wb[C::kOut], wc[C::kOut];
#pragma unroll
  for (int k = 0; k < C::kOut; ++k) {
    wa[k] = ww[c0 + k];
    wb[k] = ww[wo + c0 + k];
    wc[k] = ww[2 * wo + c0 + k];
  }

  // row 2i in fp32 registers; rows 2i+1 and 2i+2 as loaded, and the next
  // step's two rows in flight while this step computes
  float prev[C::kIn + 1];
  HalfRow<T, kLoad> r1, r2;
  r1.load(src + static_cast<int64_t>(2 * i0) * w, s0, halo);
#pragma unroll
  for (int e = 0; e <= C::kIn; ++e) prev[e] = r1[e];
  r1.load(src + static_cast<int64_t>(2 * i0 + 1) * w, s0, halo);
  r2.load(src + static_cast<int64_t>(min(2 * i0 + 2, h - 1)) * w, s0, halo);
  for (int i = i0; i < i1; ++i) {
    HalfRow<T, kLoad> n1, n2;
    const bool more = i + 1 < i1;
    if (more) {
      n1.load(src + static_cast<int64_t>(2 * i + 3) * w, s0, halo);
      n2.load(src + static_cast<int64_t>(min(2 * i + 4, h - 1)) * w, s0, halo);
    }
    // H pass per source column, in the twin's order: (a*x0 + b*x1) + c*x2
    const float ha = wh[i], hb = wh[ho + i], hc = wh[2 * ho + i];
    float mid[C::kIn + 1];
#pragma unroll
    for (int e = 0; e <= C::kIn; ++e) {
      const float x2 = r2[e];
      mid[e] = prev[e] * ha + r1[e] * hb + x2 * hc;
      prev[e] = x2;
    }
    // W pass, PReLU in fp32, one rounding
    alignas(16) T vals[C::kOut];
#pragma unroll
    for (int k = 0; k < C::kOut; ++k) {
      const float v = mid[2 * k] * wa[k] + mid[2 * k + 1] * wb[k] + mid[2 * k + 2] * wc[k];
      vals[k] = from_f32<T>(fmaxf(v, 0.0f) + alpha * fminf(v, 0.0f));
    }
    store_vec<C::kOut * sizeof(T)>(dst + static_cast<int64_t>(i) * wo, vals);
    if (more) {
      r1 = n1;
      r2 = n2;
    }
  }
}

// K4 takes its own launch plan (ops/resize_cuda.py:double_plan): block
// (tx, ty), a 1-D grid of planes x gy row bands x gz column groups, column
// groups fastest, so that blocks that run together write neighbouring
// memory. A thread owns one chunk
// of kChunk = 16 / sizeof(T) output columns [c0, c0 + kChunk), c0 even, and
// walks `rows_per_thread` source rows j, writing output rows 2j and 2j + 1.
template <typename T>
struct DoubleChunk {
  static constexpr int kChunk = 16 / static_cast<int>(sizeof(T));  // outputs per row
  static constexpr int kSrc = kChunk / 2 + 2;  // source columns s-1 .. s+kChunk/2
};

// one source row at the chunk's clamped columns, widened to fp32
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* __restrict__ row, const int (&cols)[N],
                                         float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = load_f32(row, cols[i]);
}

// One output row of the chunk: the H pass mid[i] = x[r0][col i] * h0 +
// x[r1][col i] * h1 once per source column, then the W pass per output
// (mids (ia[k], ia[k] + 1) with weights (wa[k], wb[k])), one rounding,
// kStore-element vector stores (the tail vector past the row is skipped).
template <typename T, int kStore>
__device__ __forceinline__ void double_row(const float* r0, const float* r1, float h0, float h1,
                                           const float* wa, const float* wb, T* dst, int c0,
                                           int ow) {
  using C = DoubleChunk<T>;
  float mid[C::kSrc];
#pragma unroll
  for (int i = 0; i < C::kSrc; ++i) mid[i] = r0[i] * h0 + r1[i] * h1;
  alignas(16) T vals[C::kChunk];
#pragma unroll
  for (int k = 0; k < C::kChunk; ++k) {
    // even output 2jj: mids of source (jj-1, jj); odd 2jj+1: (jj, jj+1);
    // mid index i holds source column s - 1 + i, with jj = s + k / 2
    const int i0 = k / 2 + (k & 1);
    vals[k] = from_f32<T>(mid[i0] * wa[k] + mid[i0 + 1] * wb[k]);
  }
#pragma unroll
  for (int v = 0; v < C::kChunk / kStore; ++v)
    if (c0 + v * kStore < ow) store_vec<kStore * sizeof(T)>(dst + v * kStore, vals + v * kStore);
}

template <typename T, int kStore>
__global__ void double_kernel(const T* __restrict__ x, T* __restrict__ out,
                              const float* __restrict__ wh, const float* __restrict__ ww, int h,
                              int w, int rows_per_thread, int gy, int gz) {
  using C = DoubleChunk<T>;
  const int ow = 2 * w;
  // (plane, band, column group) of this block: divisions once per block
  const unsigned int bz = blockIdx.x % gz, rest = blockIdx.x / gz;
  const unsigned int by = rest % gy;
  const int64_t plane = rest / gy;
  const int c0 = (bz * blockDim.x + threadIdx.x) * C::kChunk;
  const int j0 = (by * blockDim.y + threadIdx.y) * rows_per_thread;
  if (c0 >= ow || j0 >= h) return;
  const int j1 = min(h, j0 + rows_per_thread);
  const T* src = x + plane * h * w;
  T* dst = out + plane * 4 * h * w + c0;
  const int s = c0 / 2;  // c0 >= 0: a shift

  // edge taps clamped in-bounds (their weight is 0): nothing reads past a plane
  int cols[C::kSrc];
#pragma unroll
  for (int i = 0; i < C::kSrc; ++i) cols[i] = max(0, min(s - 1 + i, w - 1));
  // W-pass weights of each output column; ww = [ae | be | ao | bo] by source
  // index (clamped for the columns of a tail chunk past the row: not stored)
  float wa[C::kChunk], wb[C::kChunk];
#pragma unroll
  for (int k = 0; k < C::kChunk; ++k) {
    const int jj = min(s + k / 2, w - 1);
    wa[k] = ww[(k & 1) ? 2 * w + jj : jj];
    wb[k] = ww[(k & 1) ? 3 * w + jj : w + jj];
  }

  // source rows j-1, j, j+1 (clamped) in registers; each step loads one
  float prev[C::kSrc], cur[C::kSrc], next[C::kSrc];
  load_row(src + static_cast<int64_t>(max(j0 - 1, 0)) * w, cols, prev);
  load_row(src + static_cast<int64_t>(j0) * w, cols, cur);
  for (int j = j0; j < j1; ++j) {
    load_row(src + static_cast<int64_t>(min(j + 1, h - 1)) * w, cols, next);
    // even output row 2j: rows (j-1, j) with (ae, be); odd 2j+1: (j, j+1), (ao, bo)
    double_row<T, kStore>(prev, cur, wh[j], wh[h + j], wa, wb,
                          dst + static_cast<int64_t>(2 * j) * ow, c0, ow);
    double_row<T, kStore>(cur, next, wh[2 * h + j], wh[3 * h + j], wa, wb,
                          dst + static_cast<int64_t>(2 * j + 1) * ow, c0, ow);
#pragma unroll
    for (int i = 0; i < C::kSrc; ++i) {
      prev[i] = cur[i];
      cur[i] = next[i];
    }
  }
}

template <typename T, int kLoad>
int launch_half_vec(const void* x, void* out, const void* wh, const void* ww, const void* alpha,
                    int64_t n, int h, int w, int tx, int ty, int rows_per_thread, int gy, int gz,
                    cudaStream_t stream) {
  const dim3 block(tx, ty);
  half_prelu_kernel<T, kLoad><<<static_cast<unsigned int>(n * gy * gz), block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<const float*>(wh),
      static_cast<const float*>(ww), static_cast<const float*>(alpha), h, w, rows_per_thread, gy,
      gz);
  return static_cast<int>(cudaGetLastError());
}

// the plan's load width must divide the source row and align the input
// (then every load, and every store of a chunk, is an aligned vector: the
// output is a fresh allocation); the blocks must cover the output
template <typename T>
int launch_half_prelu(const void* x, void* out, const void* wh, const void* ww,
                      const void* alpha, int64_t n, int64_t h, int64_t w, int load, int tx,
                      int ty, int rows_per_thread, int gy, int gz, cudaStream_t stream) {
  const int64_t ho = h / 2, wo = w / 2;
  const int out_chunk = load > 1 ? load / 2 : 1;  // HalfChunk::kOut
  const bool ok = n >= 1 && h >= 2 && w >= 2 && h * w <= 0x7fffffffLL && gy >= 1 && gz >= 1 &&
                  n * gy * gz <= 0x7fffffffLL && tx >= 1 && ty >= 1 && rows_per_thread >= 1 &&
                  tx * ty <= kMaxHalfThreads && load >= 1 && load * sizeof(T) <= 16 &&
                  w % load == 0 && reinterpret_cast<uintptr_t>(x) % (load * sizeof(T)) == 0 &&
                  reinterpret_cast<uintptr_t>(out) % (out_chunk * sizeof(T)) == 0 &&
                  static_cast<int64_t>(gy) * ty * rows_per_thread >= ho &&
                  static_cast<int64_t>(gz) * tx * out_chunk >= wo;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const int hi = static_cast<int>(h), wi = static_cast<int>(w);
  switch (load * static_cast<int>(sizeof(T))) {
    case 16:
      return launch_half_vec<T, 16 / sizeof(T)>(x, out, wh, ww, alpha, n, hi, wi, tx, ty,
                                                rows_per_thread, gy, gz, stream);
    case 8:
      return launch_half_vec<T, 8 / sizeof(T)>(x, out, wh, ww, alpha, n, hi, wi, tx, ty,
                                               rows_per_thread, gy, gz, stream);
    case 4:
      return launch_half_vec<T, 4 / sizeof(T)>(x, out, wh, ww, alpha, n, hi, wi, tx, ty,
                                               rows_per_thread, gy, gz, stream);
    case 2:  // bf16 only: an odd source width or a base off 4-byte alignment
      if constexpr (sizeof(T) == 2)
        return launch_half_vec<T, 1>(x, out, wh, ww, alpha, n, hi, wi, tx, ty, rows_per_thread,
                                     gy, gz, stream);
      return static_cast<int>(cudaErrorInvalidValue);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int kStore>
int launch_double_vec(const void* x, void* out, const void* wh, const void* ww, int64_t n, int h,
                      int w, int tx, int ty, int rows_per_thread, int gy, int gz,
                      cudaStream_t stream) {
  const dim3 block(tx, ty);
  double_kernel<T, kStore><<<static_cast<unsigned int>(n * gy * gz), block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<const float*>(wh),
      static_cast<const float*>(ww), h, w, rows_per_thread, gy, gz);
  return static_cast<int>(cudaGetLastError());
}

// the plan's store width (elements) must divide the output row, and the
// output must be aligned to it: every store is then an aligned vector
template <typename T>
int launch_double(const void* x, void* out, const void* wh, const void* ww, int64_t n,
                  int64_t h, int64_t w, int store, int tx, int ty, int rows_per_thread, int gy,
                  int gz, cudaStream_t stream) {
  constexpr int kChunk = DoubleChunk<T>::kChunk;
  const bool ok = n >= 1 && gy >= 1 && gz >= 1 && n * gy * gz <= 0x7fffffffLL && h >= 1 &&
                  w >= 1 && h * w <= 0x7fffffffLL &&
                  store >= 1 && kChunk % store == 0 && (2 * w) % store == 0 &&
                  reinterpret_cast<uintptr_t>(out) % (store * sizeof(T)) == 0 &&
                  static_cast<int64_t>(gy) * ty * rows_per_thread >= h &&
                  static_cast<int64_t>(gz) * tx * kChunk >= 2 * w;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const int hi = static_cast<int>(h), wi = static_cast<int>(w);
  switch (store * static_cast<int>(sizeof(T))) {
    case 16:
      return launch_double_vec<T, 16 / sizeof(T)>(x, out, wh, ww, n, hi, wi, tx, ty,
                                                  rows_per_thread, gy, gz, stream);
    case 8:
      return launch_double_vec<T, 8 / sizeof(T)>(x, out, wh, ww, n, hi, wi, tx, ty,
                                                 rows_per_thread, gy, gz, stream);
    case 4:  // bf16 pairs; an fp32 row always takes 8 bytes (2w is even)
      if constexpr (sizeof(T) == 2)
        return launch_double_vec<T, 2>(x, out, wh, ww, n, hi, wi, tx, ty, rows_per_thread, gy,
                                       gz, stream);
      return static_cast<int>(cudaErrorInvalidValue);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace hvi_cidnet

using namespace hvi_cidnet;

// x: (n, h, w) contiguous planes (n = B*C); out: (n, h/2, w/2); wh: 3*(h/2)
// fp32 weights [a|b|c]; ww: 3*(w/2); alpha: one fp32 PReLU slope on the
// device. load, tx, ty, rows_per_thread, gy, gz: the launch plan of
// ops/resize_cuda.py:half_plan. Returns cudaGetLastError().
extern "C" int resize_half_prelu(const void* x, void* out, int dtype, const void* wh,
                                 const void* ww, const void* alpha, int64_t n, int64_t h,
                                 int64_t w, int load, int tx, int ty, int rows_per_thread,
                                 int gy, int gz, cudaStream_t stream) {
  if (dtype == kFloat32)
    return launch_half_prelu<float>(x, out, wh, ww, alpha, n, h, w, load, tx, ty,
                                    rows_per_thread, gy, gz, stream);
  if (dtype == kBFloat16)
    return launch_half_prelu<__nv_bfloat16>(x, out, wh, ww, alpha, n, h, w, load, tx, ty,
                                            rows_per_thread, gy, gz, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// x: (n, h, w); out: (n, 2h, 2w); wh: 4*h fp32 weights [ae|be|ao|bo]; ww: 4*w.
// store, tx, ty, rows_per_thread, gy, gz: the launch plan of
// ops/resize_cuda.py:double_plan.
extern "C" int resize_double(const void* x, void* out, int dtype, const void* wh,
                             const void* ww, int64_t n, int64_t h, int64_t w, int store, int tx,
                             int ty, int rows_per_thread, int gy, int gz, cudaStream_t stream) {
  if (dtype == kFloat32)
    return launch_double<float>(x, out, wh, ww, n, h, w, store, tx, ty, rows_per_thread, gy, gz,
                                stream);
  if (dtype == kBFloat16)
    return launch_double<__nv_bfloat16>(x, out, wh, ww, n, h, w, store, tx, ty, rows_per_thread,
                                        gy, gz, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
