// K1 and K2: the HVI colour transform, fused.
//
// Replaces the Pallas kernels of hvi_cidnet_tpu/ops/hvi_pallas.py:
//   K1 _hvit_kernel  (:57, launched by _run :174; on the default path through
//      rgb_to_hvi_pallas_hwcb :343) -> hvi_rgb_to_hvi below;
//   K2 _phvit_kernel (:102, via _run :174; default path hvi_to_rgb_pallas_hwcb
//      :393) -> hvi_hvi_to_rgb below.
// What they compute is hvi_cidnet_torch/ops/hvi.py, the plain twin these
// kernels are held against on the card.
//
// Layout: the TPU kernels packed (rows, 128) planes and transposed around
// them; none of that carries over. K1 reads NHWC RGB (B, H, W, 3) and writes
// NCHW HVI (B, 3, H, W); K2 reads NCHW HVI and writes NHWC RGB. The layout
// change at the model's boundary is absorbed into the kernels' indexing.
//
// K1 moves 6 elements a pixel (an (8, 400, 600) bf16 batch is 6.9 us of
// traffic at 3.35 TB/s) and, like K2, is bound by its math: precise sinf,
// powf, sinf and cosf and IEEE divisions. The first design (one thread per
// pixel in a 64-bit grid-stride loop, a 64-bit p / hw per pixel, three
// scalar loads at a 3-element stride, three scalar plane stores, three
// divisions by denom, fmodf, hue / 6) was ~322 SASS instructions a pixel
// on the fast path; on the card its loads, indexing and stores alone (the
// math replaced by a copy) ran at 7.5 us for that batch, its math with
// planar I/O at 21.2 us, the whole at 23.5 us (PERF.md, step 0). The design
// below is K2's, reversed: a 2-D grid with no division per pixel, 16-byte
// cp.async copies of whole NHWC lines and vector stores of the three
// planes, both staged through shared memory, the per-pixel loop not
// unrolled, and four exact rewrites of the math (rgb_to_hvi_pixel).
// cp.async keeps all of a block's copies in flight at once: with register
// loads the fp32 arm, whose 46 MB at batch 8 do not stay in L2, ran 17%
// slower (PERF.md).
//
// K2 moves the same bytes but is bound by its math: with precise powf, sinf,
// atan2f, sqrtf and two IEEE divisions a pixel is ~264 SASS instructions
// on the fast path, ~15 us for that batch at one instruction per clock per
// scheduler. The first design (one thread per pixel) also paid a 64-bit
// division, three strided plane loads and three 2-byte stores at a 6-byte
// stride per pixel (~312 instructions); on the card, with the math
// replaced by a copy it ran at 11 us, with the math and one coalesced
// output at 30 us, as a whole at 30 us (PERF.md). The design below: a 2-D
// grid with no division per pixel, vector loads of the three planes and
// 16-byte stores of whole NHWC lines, both staged through shared memory,
// the per-pixel loop not unrolled (its code stays small), and three exact
// rewrites of the math (hvi_to_rgb_pixel).
//
// Traps kept as the twin has them:
// * mod is floored in both mod(., 6) (K1) and mod(., 1) (K2), as jnp.mod and
//   torch.remainder are; a bare fmodf truncates. In K2 a hue just under 0
//   wraps to 1 - tiny, rounds to 1.0f, gives hi == 6 and a black pixel.
// * Divisions by a Python scalar in the twin (K1's hue / 6, K2's / (2 pi))
//   are, on the card, multiplies by the fp32 reciprocal: PyTorch's CUDA
//   division by a CPU scalar computes them so. The kernels do the same.
// * No --use_fast_math; --fmad=false keeps each op rounded as torch rounds it
//   (ops/_build.py), so the select chain's float equalities match the twin.
// * K2 uses atan2f, the twin's function (jnp.arctan2 / torch.atan2), not the
//   TPU kernel's polynomial atan2 (hvi_pallas.py:80-99).
// * density_k arrives as a device pointer: no host sync to read it.
// * Output rounds once from fp32; K1 rounds through the input type first,
//   exactly as the twin's .astype(input dtype).astype(compute dtype).
#include "common.cuh"

namespace hvi_cidnet {
namespace {

constexpr float kEps = 1e-8f;
constexpr float kHalfPi = static_cast<float>(0.5 * 3.141592653589793);
constexpr float kTwoPi = static_cast<float>(2.0 * 3.141592653589793);
constexpr float kInvTwoPi = 1.0f / kTwoPi;  // rounded once, as PyTorch's 1 / scalar
constexpr float kSixth = 1.0f / 6.0f;        // likewise

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// K1 per pixel: the twin's ops in its order, with four rewrites that drop
// instructions and leave every output bit as the card's twin has it:
// * one division by denom: the twin computes three quotients and its select
//   chain keeps one (B-max, then G-max, then R-max override, gray gives 0);
//   here the numerator is selected first, in the same priority, and divided
//   once: the kept quotient is the same operation on the same operands;
// * the floored mod(x, 6) of x = (g - b) / denom as x < 0 ? x + 6 : x:
//   |g - b| <= max - min <= denom, so |x| <= 1, fmodf gives x, and the floored
//   mod adds 6 to a negative x with one rounding; -0 stays -0 in both;
// * hue / 6 as hue * (1 / 6), 1 / 6 rounded to fp32 once, as the card's twin;
// * sincosf for cos(2 pi h) and sin(2 pi h): the bits of cosf and sinf at
//   every fp32 hue in [0, 1) (checked on the card, PERF.md).
// Precise powf and sinf and the IEEE divisions of the hue and the
// saturation stay: the twin's torch.pow, torch.sin and divisions.
__device__ __forceinline__ void rgb_to_hvi_pixel(float r, float g, float b, float k,
                                                 float& h_out, float& v_out, float& value) {
  value = fmaxf(fmaxf(r, g), b);
  const float vmin = fminf(fminf(r, g), b);
  const float denom = value - vmin + kEps;
  const bool r_max = r == value, g_max = g == value;
  const float q = (r_max ? g - b : g_max ? b - r : r - g) / denom;
  float hue = r_max ? (q < 0.0f ? q + 6.0f : q) : (g_max ? 2.0f : 4.0f) + q;
  hue = (vmin == value) ? 0.0f : hue;
  hue = hue * kSixth;

  float sat = (value - vmin) / (value + kEps);
  sat = (value == 0.0f) ? 0.0f : sat;

  const float cs = powf(sinf(value * kHalfPi) + kEps, k);
  float sin_h, cos_h;
  sincosf(kTwoPi * hue, &sin_h, &cos_h);
  h_out = cs * sat * cos_h;
  v_out = cs * sat * sin_h;
}

// K1 and K2 take launch plans (ops/hvi_cuda.py: rgb_to_hvi_plan,
// hvi_to_rgb_plan): a 2-D grid of (pixel runs, images) and blocks of
// kRgbThreads; block (x, y) owns pixels [x * run, (x + 1) * run) of image y
// (run = kRgbThreads * pixels per thread).
constexpr int kRgbThreads = 256;

// K1, K2's layout reversed. V divides H * W and aligns the output, so every
// plane store is a whole aligned vector.
//   1. the block copies its NHWC line (3 * run contiguous elements) into
//      shared memory as 16-byte cp.async copies, at the input's offset from
//      a 16-byte boundary (`shift`), the parts of the first and last vectors
//      inside the block's range element by element;
//   2. each thread converts the pixels tid, tid + threads, ...: neighbouring
//      threads, neighbouring pixels; H, V and I go to three shared plane
//      runs;
//   3. the block stores each plane run, one V-element vector per thread and
//      plane at a time.
template <typename In, typename Out, int V>
__global__ void __launch_bounds__(kRgbThreads)
    rgb_to_hvi_kernel(const In* __restrict__ img, Out* __restrict__ out,
                      const float* __restrict__ k_ptr, int hw, int run) {
  constexpr int kVec16 = 16 / static_cast<int>(sizeof(In));  // elements per 16 bytes
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float k_s;
  Out* planes = reinterpret_cast<Out*>(smem_raw);      // [3][run]
  In* line = reinterpret_cast<In*>(planes + 3 * run);  // [shift + 3 * run]
  const int p0 = blockIdx.x * run;
  const int n = min(run, hw - p0);
  const In* src = img + (static_cast<int64_t>(blockIdx.y) * hw + p0) * 3;
  Out* dst = out + static_cast<int64_t>(blockIdx.y) * 3 * hw + p0;
  const int shift = static_cast<int>(reinterpret_cast<uintptr_t>(src) % 16 / sizeof(In));

  if (threadIdx.x == 0) k_s = *k_ptr;  // density_k, once per block
  // element e of line is src[e - shift]: base is 16-byte aligned. Elements
  // [shift, end) are loaded: the whole vectors in [first, last), then the
  // head [shift, min(first, end)) and the tail [max(last, head_end), end),
  // each under kVec16 elements, one element a thread
  const In* base = src - shift;
  const int end = shift + 3 * n;
  const int first = shift ? kVec16 : 0;
  const int last = end / kVec16 * kVec16;
  for (int e0 = first + threadIdx.x * kVec16; e0 < last; e0 += blockDim.x * kVec16)
    cp_async16(line + e0, base + e0);
  cp_async_commit();
  const int head_end = min(first, end);
  const int tail = max(last, head_end);
  if (shift + static_cast<int>(threadIdx.x) < head_end)
    line[shift + threadIdx.x] = base[shift + threadIdx.x];
  if (tail + static_cast<int>(threadIdx.x) < end)
    line[tail + threadIdx.x] = base[tail + threadIdx.x];
  cp_async_wait<0>();
  __syncthreads();

  const float k = k_s;
#pragma unroll 1
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    const In* px = line + shift + 3 * p;
    float h, v, i;
    rgb_to_hvi_pixel(load_f32(px, 0), load_f32(px, 1), load_f32(px, 2), k, h, v, i);
    planes[p] = from_f32<Out>(round_through<In>(h));
    planes[run + p] = from_f32<Out>(round_through<In>(v));
    planes[2 * run + p] = from_f32<Out>(round_through<In>(i));
  }
  __syncthreads();

  for (int q = threadIdx.x * V; q < n; q += blockDim.x * V) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
      store_vec<V * sizeof(Out)>(dst + static_cast<int64_t>(c) * hw + q, planes + c * run + q);
  }
}

// K2 per pixel: the twin's ops in its order, with three rewrites that
// drop instructions (the math, not the bytes, binds K2; PERF.md):
// * the hue's "/ (2 pi)" is a multiply by the fp32 reciprocal of 2 pi:
//   PyTorch's CUDA division by a Python scalar, which the twin's is, does
//   exactly that (on the CPU it divides; the two differ by an ulp at most);
// * floored mod(x, 1) is x - floorf(x): exact for |x| < 1, and |x| <= 0.5
//   here (|atan2f| <= fp32 pi, over fp32 2 pi). For x >= 0 both give x; for
//   x < 0 fmodf gives x and the mod adds 1 with one rounding, as x - (-1)
//   does; -0 gives +0 against -0, and both land in sector 0 alike;
// * the sector select is three select chains, no branches.
// Precise sinf, powf, atan2f, sqrtf and the two IEEE divisions stay: the
// twin's functions (torch.sin, torch.pow, torch.atan2, torch.sqrt).
__device__ __forceinline__ void hvi_to_rgb_pixel(float hh, float vv, float ii, float k, int gated,
                                                 int gated2, float alpha, float alpha_s,
                                                 float& r, float& g, float& b) {
  float h_c = clampf(hh, -1.0f, 1.0f);
  float v_c = clampf(vv, -1.0f, 1.0f);
  const float i_c = clampf(ii, 0.0f, 1.0f);

  const float cs = powf(sinf(i_c * kHalfPi) + kEps, k);
  h_c = clampf(h_c / (cs + kEps), -1.0f, 1.0f);
  v_c = clampf(v_c / (cs + kEps), -1.0f, 1.0f);

  const float turns = atan2f(v_c + kEps, h_c + kEps) * kInvTwoPi;
  const float h = turns - floorf(turns);
  float s = sqrtf(h_c * h_c + v_c * v_c + kEps);
  if (gated) s = s * alpha_s;
  s = clampf(s, 0.0f, 1.0f);
  const float v = clampf(i_c, 0.0f, 1.0f);

  const float hi = floorf(h * 6.0f);
  const float f = h * 6.0f - hi;
  const float pp = v * (1.0f - s);
  const float q = v * (1.0f - f * s);
  const float t = v * (1.0f - (1.0f - f) * s);

  // six disjoint sectors (r, g, b): 0 (v, t, p), 1 (q, v, p), 2 (p, v, t),
  // 3 (p, q, v), 4 (t, p, v), 5 (v, p, q); hi == 6 matches none and stays
  // black
  const bool s0 = hi == 0.0f, s1 = hi == 1.0f, s2 = hi == 2.0f;
  const bool s3 = hi == 3.0f, s4 = hi == 4.0f, s5 = hi == 5.0f;
  r = (s0 || s5) ? v : s1 ? q : (s2 || s3) ? pp : s4 ? t : 0.0f;
  g = (s1 || s2) ? v : s0 ? t : s3 ? q : (s4 || s5) ? pp : 0.0f;
  b = (s3 || s4) ? v : (s0 || s1) ? pp : s2 ? t : s5 ? q : 0.0f;
  if (gated2) {
    r = r * alpha;
    g = g * alpha;
    b = b * alpha;
  }
}

// K2. V divides H * W and aligns the input, so every plane load is a whole
// aligned vector.
//   1. the block loads its run of each of the three planes into shared
//      memory, one V-pixel vector per thread and plane at a time;
//   2. each thread converts the pixels tid, tid + threads, ...: neighbouring
//      threads, neighbouring pixels; the RGB triples go to shared memory at
//      the output's offset from a 16-byte boundary (`shift`);
//   3. the block writes its lines of NHWC output (3 * run contiguous
//      elements) as 16-byte vectors, the part of a vector outside the
//      block's range element by element.

template <typename T, int V>
__global__ void __launch_bounds__(kRgbThreads)
    hvi_to_rgb_kernel(const T* __restrict__ hvi, T* __restrict__ out,
                      const float* __restrict__ k_ptr, int hw, int run, int gated, int gated2,
                      float alpha, float alpha_s) {
  constexpr int kVec16 = 16 / static_cast<int>(sizeof(T));  // elements per 16 bytes
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float k_s;
  T* planes = reinterpret_cast<T*>(smem_raw);  // [3][run]
  T* rgb = planes + 3 * run;                   // [shift + 3 * run]
  const int p0 = blockIdx.x * run;
  const int n = min(run, hw - p0);
  const T* src = hvi + static_cast<int64_t>(blockIdx.y) * 3 * hw + p0;
  T* dst = out + (static_cast<int64_t>(blockIdx.y) * hw + p0) * 3;
  const int shift = static_cast<int>(reinterpret_cast<uintptr_t>(dst) % 16 / sizeof(T));

  if (threadIdx.x == 0) k_s = *k_ptr;  // density_k, once per block
  for (int q = threadIdx.x * V; q < n; q += blockDim.x * V) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
      load_vec<V * sizeof(T)>(planes + c * run + q, src + static_cast<int64_t>(c) * hw + q);
  }
  __syncthreads();

  const float k = k_s;
#pragma unroll 1
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    float r, g, b;
    hvi_to_rgb_pixel(load_f32(planes, p), load_f32(planes, run + p),
                     load_f32(planes, 2 * run + p), k, gated, gated2, alpha, alpha_s, r, g, b);
    T* o = rgb + shift + 3 * p;
    o[0] = from_f32<T>(r);
    o[1] = from_f32<T>(g);
    o[2] = from_f32<T>(b);
  }
  __syncthreads();

  // element e of rgb is dst[e - shift]: base is 16-byte aligned
  T* base = dst - shift;
  const int end = shift + 3 * n;
  for (int e0 = threadIdx.x * kVec16; e0 < end; e0 += blockDim.x * kVec16) {
    if (e0 >= shift && e0 + kVec16 <= end) {
      store_vec<16>(base + e0, rgb + e0);
    } else {
      for (int e = max(e0, shift); e < min(e0 + kVec16, end); ++e) base[e] = rgb[e];
    }
  }
}

template <typename In, typename Out, int V>
int launch_rgb_to_hvi_vec(const void* img, void* out, const void* k, int64_t batch, int hw,
                          int run, int runs, cudaStream_t stream) {
  const dim3 grid(runs, static_cast<unsigned int>(batch));
  const size_t smem = 3 * run * sizeof(Out) + (3 * run + 16 / sizeof(In)) * sizeof(In);
  rgb_to_hvi_kernel<In, Out, V><<<grid, kRgbThreads, smem, stream>>>(
      static_cast<const In*>(img), static_cast<Out*>(out), static_cast<const float*>(k), hw,
      run);
  return static_cast<int>(cudaGetLastError());
}

// the plan's vector (elements) must divide H * W and align the output, its
// run be whole vectors and a multiple of 8 (the NHWC line after the planes
// then starts 16-byte aligned) in at most 48 KB of shared memory, and its
// blocks cover every image
template <typename In, typename Out>
int launch_rgb_to_hvi(const void* img, void* out, const void* k, int64_t batch, int64_t hw,
                      int vec, int run, int runs, cudaStream_t stream) {
  const bool ok = batch >= 1 && batch <= 65535 && hw >= 1 && 3 * hw <= 0x7fffffffLL &&
                  vec >= 1 && vec * sizeof(Out) <= 16 && hw % vec == 0 &&
                  reinterpret_cast<uintptr_t>(out) % (vec * sizeof(Out)) == 0 &&
                  reinterpret_cast<uintptr_t>(img) % sizeof(In) == 0 && run >= vec &&
                  run % vec == 0 && run % 8 == 0 &&
                  3 * run * sizeof(Out) + (3 * run + 16 / sizeof(In)) * sizeof(In) <= 48 * 1024 &&
                  runs >= 1 && static_cast<int64_t>(runs) * run >= hw;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const int h = static_cast<int>(hw);
  switch (vec * static_cast<int>(sizeof(Out))) {
    case 16:
      return launch_rgb_to_hvi_vec<In, Out, 16 / sizeof(Out)>(img, out, k, batch, h, run, runs,
                                                             stream);
    case 8:
      return launch_rgb_to_hvi_vec<In, Out, 8 / sizeof(Out)>(img, out, k, batch, h, run, runs,
                                                            stream);
    case 4:
      return launch_rgb_to_hvi_vec<In, Out, 4 / sizeof(Out)>(img, out, k, batch, h, run, runs,
                                                            stream);
    case 2:  // bf16 output only: an odd H * W or a base off 4-byte alignment
      if constexpr (sizeof(Out) == 2)
        return launch_rgb_to_hvi_vec<In, Out, 1>(img, out, k, batch, h, run, runs, stream);
      return static_cast<int>(cudaErrorInvalidValue);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int V>
int launch_hvi_to_rgb_vec(const void* hvi, void* out, const void* k, int64_t batch, int hw,
                          int run, int runs, int gated, int gated2, float alpha, float alpha_s,
                          cudaStream_t stream) {
  const dim3 grid(runs, static_cast<unsigned int>(batch));
  const size_t smem = (6 * run + 16 / sizeof(T)) * sizeof(T);
  hvi_to_rgb_kernel<T, V><<<grid, kRgbThreads, smem, stream>>>(
      static_cast<const T*>(hvi), static_cast<T*>(out), static_cast<const float*>(k), hw, run,
      gated, gated2, alpha, alpha_s);
  return static_cast<int>(cudaGetLastError());
}

// the plan's vector (pixels) must divide H * W and align the input, its run
// be whole vectors and 16-byte lines of RGB in at most 48 KB of shared
// memory, and its blocks cover every image
template <typename T>
int launch_hvi_to_rgb(const void* hvi, void* out, const void* k, int64_t batch, int64_t hw,
                      int vec, int run, int runs, int gated, int gated2, float alpha,
                      float alpha_s, cudaStream_t stream) {
  const bool ok = batch >= 1 && batch <= 65535 && hw >= 1 && 3 * hw <= 0x7fffffffLL &&
                  vec >= 1 && vec * sizeof(T) <= 16 && hw % vec == 0 &&
                  reinterpret_cast<uintptr_t>(hvi) % (vec * sizeof(T)) == 0 &&
                  reinterpret_cast<uintptr_t>(out) % sizeof(T) == 0 && run >= vec &&
                  run % vec == 0 && (3 * run * sizeof(T)) % 16 == 0 &&
                  (6 * run + 16 / sizeof(T)) * sizeof(T) <= 48 * 1024 && runs >= 1 &&
                  static_cast<int64_t>(runs) * run >= hw;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const int h = static_cast<int>(hw);
  switch (vec * static_cast<int>(sizeof(T))) {
    case 16:
      return launch_hvi_to_rgb_vec<T, 16 / sizeof(T)>(hvi, out, k, batch, h, run, runs,
                                                      gated, gated2, alpha, alpha_s, stream);
    case 8:
      return launch_hvi_to_rgb_vec<T, 8 / sizeof(T)>(hvi, out, k, batch, h, run, runs,
                                                     gated, gated2, alpha, alpha_s, stream);
    case 4:
      return launch_hvi_to_rgb_vec<T, 4 / sizeof(T)>(hvi, out, k, batch, h, run, runs,
                                                     gated, gated2, alpha, alpha_s, stream);
    case 2:  // bf16 only: an odd H * W or a base off 4-byte alignment
      if constexpr (sizeof(T) == 2)
        return launch_hvi_to_rgb_vec<T, 1>(hvi, out, k, batch, h, run, runs, gated,
                                           gated2, alpha, alpha_s, stream);
      return static_cast<int>(cudaErrorInvalidValue);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace hvi_cidnet

using namespace hvi_cidnet;

// img: (B, H, W, 3) contiguous; out: (B, 3, H, W) contiguous; k: one fp32 on
// the device. vec, run, runs: the launch plan of
// ops/hvi_cuda.py:rgb_to_hvi_plan. Returns cudaGetLastError().
extern "C" int hvi_rgb_to_hvi(const void* img, int in_dtype, void* out, int out_dtype,
                              const void* k, int64_t batch, int64_t hw, int vec, int run,
                              int runs, cudaStream_t stream) {
  if (in_dtype == kFloat32 && out_dtype == kFloat32)
    return launch_rgb_to_hvi<float, float>(img, out, k, batch, hw, vec, run, runs, stream);
  if (in_dtype == kFloat32 && out_dtype == kBFloat16)
    return launch_rgb_to_hvi<float, __nv_bfloat16>(img, out, k, batch, hw, vec, run, runs,
                                                   stream);
  if (in_dtype == kBFloat16 && out_dtype == kFloat32)
    return launch_rgb_to_hvi<__nv_bfloat16, float>(img, out, k, batch, hw, vec, run, runs,
                                                   stream);
  if (in_dtype == kBFloat16 && out_dtype == kBFloat16)
    return launch_rgb_to_hvi<__nv_bfloat16, __nv_bfloat16>(img, out, k, batch, hw, vec, run,
                                                           runs, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// hvi: (B, 3, H, W) contiguous; out: (B, H, W, 3) contiguous, same dtype;
// k: one fp32 on the device. vec, run, runs: the launch plan of
// ops/hvi_cuda.py:hvi_to_rgb_plan. Returns cudaGetLastError().
extern "C" int hvi_hvi_to_rgb(const void* hvi, void* out, int dtype, const void* k,
                              int64_t batch, int64_t hw, int vec, int run, int runs, int gated,
                              int gated2, float alpha, float alpha_s, cudaStream_t stream) {
  if (dtype == kFloat32)
    return launch_hvi_to_rgb<float>(hvi, out, k, batch, hw, vec, run, runs, gated,
                                    gated2, alpha, alpha_s, stream);
  if (dtype == kBFloat16)
    return launch_hvi_to_rgb<__nv_bfloat16>(hvi, out, k, batch, hw, vec, run, runs,
                                            gated, gated2, alpha, alpha_s, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
