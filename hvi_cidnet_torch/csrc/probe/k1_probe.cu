// Step-0 probe of K1 (RGB -> HVI, csrc/hvi.cu), run by
// hvi_cidnet_torch/cli/k1_probe.py: variants timed beside the kernel to
// find out whether its bytes or its instruction issue bound it, and a check
// of one exact rewrite. Built on its own; the kernels' library (ops/_build.py)
// compiles csrc/*.cu only.
//
// k1_probe_variant(mode, ...):
//   0 first_cut   K1's first design: one thread a pixel in a 64-bit
//                 grid-stride loop, a 64-bit p / hw a pixel, three scalar
//                 loads at a 3-element stride, three scalar plane stores,
//                 three divisions by denom, fmodf, hue / 6.0f;
//   1 copy_old    mode 0's loads, indexing and stores, the math replaced by a
//                 copy (r, g, b to the H, V, I planes);
//   2 math_planar mode 0's math on planar input (3, n) and planar output
//                 (3, n): one coalesced element a plane per pixel, int index;
//   3 copy_new    a 2-D grid (pixel runs, images), each block's NHWC line
//                 loaded in 16-byte vectors through shared memory, the three
//                 plane runs stored in 16-byte vectors; a copy, no math.
// k1_probe_sincos(): over every fp32 hue h in [0, 1), counts the h where
// sincosf(2 pi h) differs in bits from (sinf(2 pi h), cosf(2 pi h)).
#include "../common.cuh"

namespace hvi_cidnet {
namespace {

constexpr float kEps = 1e-8f;
constexpr float kHalfPi = static_cast<float>(0.5 * 3.141592653589793);
constexpr float kTwoPi = static_cast<float>(2.0 * 3.141592653589793);

__device__ __forceinline__ float floored_mod(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.0f && ((m < 0.0f) != (b < 0.0f))) m += b;
  return m;
}

// the first design's math: H, V, I of one pixel
__device__ __forceinline__ void first_cut_math(float r, float g, float b, float k, float& h_out,
                                               float& v_out, float& value) {
  value = fmaxf(fmaxf(r, g), b);
  const float vmin = fminf(fminf(r, g), b);
  const float denom = value - vmin + kEps;
  float hue = (b == value) ? 4.0f + (r - g) / denom : 0.0f;
  hue = (g == value) ? 2.0f + (b - r) / denom : hue;
  hue = (r == value) ? floored_mod((g - b) / denom, 6.0f) : hue;
  hue = (vmin == value) ? 0.0f : hue;
  hue = hue / 6.0f;
  float sat = (value - vmin) / (value + kEps);
  sat = (value == 0.0f) ? 0.0f : sat;
  const float cs = powf(sinf(value * kHalfPi) + kEps, k);
  h_out = cs * sat * cosf(kTwoPi * hue);
  v_out = cs * sat * sinf(kTwoPi * hue);
}

template <typename In, typename Out, bool kMath>
__global__ void first_cut(const In* __restrict__ img, Out* __restrict__ out,
                          const float* __restrict__ k_ptr, int64_t n_pix, int64_t hw) {
  const float k = kMath ? *k_ptr : 0.0f;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; p < n_pix;
       p += stride) {
    const float r = load_f32(img, 3 * p);
    const float g = load_f32(img, 3 * p + 1);
    const float b = load_f32(img, 3 * p + 2);
    float h_out = r, v_out = g, value = b;
    if (kMath) first_cut_math(r, g, b, k, h_out, v_out, value);
    const int64_t bi = p / hw;
    Out* o = out + bi * 3 * hw + (p - bi * hw);
    o[0] = from_f32<Out>(round_through<In>(h_out));
    o[hw] = from_f32<Out>(round_through<In>(v_out));
    o[2 * hw] = from_f32<Out>(round_through<In>(value));
  }
}

template <typename In, typename Out>
__global__ void math_planar(const In* __restrict__ rgb, Out* __restrict__ out,
                            const float* __restrict__ k_ptr, int n) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  float h_out, v_out, value;
  first_cut_math(load_f32(rgb, p), load_f32(rgb, n + p), load_f32(rgb, 2 * n + p), *k_ptr, h_out,
                 v_out, value);
  out[p] = from_f32<Out>(round_through<In>(h_out));
  out[n + p] = from_f32<Out>(round_through<In>(v_out));
  out[2 * n + p] = from_f32<Out>(round_through<In>(value));
}

// 256 threads, `run` pixels a block; planes first, then the NHWC line at
// the input's shift from a 16-byte boundary
template <typename In, typename Out, int V>
__global__ void __launch_bounds__(256)
    copy_new(const In* __restrict__ img, Out* __restrict__ out, int hw, int run) {
  constexpr int kIn16 = 16 / static_cast<int>(sizeof(In));
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Out* planes = reinterpret_cast<Out*>(smem_raw);
  In* line = reinterpret_cast<In*>(planes + 3 * run);
  const int p0 = blockIdx.x * run;
  const int n = min(run, hw - p0);
  const In* src = img + (static_cast<int64_t>(blockIdx.y) * hw + p0) * 3;
  Out* dst = out + static_cast<int64_t>(blockIdx.y) * 3 * hw + p0;
  const int shift = static_cast<int>(reinterpret_cast<uintptr_t>(src) % 16 / sizeof(In));
  const In* base = src - shift;
  const int end = shift + 3 * n;
  for (int e0 = threadIdx.x * kIn16; e0 < end; e0 += blockDim.x * kIn16) {
    if (e0 >= shift && e0 + kIn16 <= end) {
      load_vec<16>(line + e0, base + e0);
    } else {
      for (int e = max(e0, shift); e < min(e0 + kIn16, end); ++e) line[e] = base[e];
    }
  }
  __syncthreads();
#pragma unroll 1
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    const In* px = line + shift + 3 * p;
#pragma unroll
    for (int c = 0; c < 3; ++c) planes[c * run + p] = from_f32<Out>(load_f32(px, c));
  }
  __syncthreads();
  for (int q = threadIdx.x * V; q < n; q += blockDim.x * V) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
      store_vec<V * sizeof(Out)>(dst + static_cast<int64_t>(c) * hw + q, planes + c * run + q);
  }
}

__global__ void sincos_check(unsigned int* mismatches) {
  // fp32 hues in [0, 1): bit patterns 0 .. 0x3f7fffff
  const unsigned int stride = gridDim.x * blockDim.x;
  unsigned int bad = 0;
  for (unsigned int u = blockIdx.x * blockDim.x + threadIdx.x; u < 0x3f800000u; u += stride) {
    const float x = kTwoPi * __uint_as_float(u);
    float s, c;
    sincosf(x, &s, &c);
    bad += (__float_as_uint(s) != __float_as_uint(sinf(x))) ||
           (__float_as_uint(c) != __float_as_uint(cosf(x)));
  }
  if (bad) atomicAdd(mismatches, bad);
}

template <typename In, typename Out>
int launch(int mode, const void* img, void* out, const void* k, int batch, int hw, int run,
           cudaStream_t s) {
  const int64_t n_pix = static_cast<int64_t>(batch) * hw;
  auto i = static_cast<const In*>(img);
  auto o = static_cast<Out*>(out);
  auto kp = static_cast<const float*>(k);
  const unsigned int blocks = grid_for(n_pix);
  if (mode == 0) first_cut<In, Out, true><<<blocks, kThreads, 0, s>>>(i, o, kp, n_pix, hw);
  if (mode == 1) first_cut<In, Out, false><<<blocks, kThreads, 0, s>>>(i, o, kp, n_pix, hw);
  if (mode == 2) {
    const int n = static_cast<int>(n_pix);
    math_planar<In, Out><<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(i, o, kp, n);
  }
  if (mode == 3) {
    constexpr int V = 16 / sizeof(Out);
    if (hw % V || reinterpret_cast<uintptr_t>(out) % 16 || run % 16)
      return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((hw + run - 1) / run, batch);
    const size_t smem = 3 * run * sizeof(Out) + (3 * run + 16 / sizeof(In)) * sizeof(In);
    copy_new<In, Out, V><<<grid, 256, smem, s>>>(i, o, hw, run);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace hvi_cidnet

using namespace hvi_cidnet;

// img: (B, H, W, 3) contiguous, or (3, B*H*W) for mode 2; out: (B, 3, H, W)
// contiguous, or (3, B*H*W) for mode 2. Returns cudaGetLastError().
extern "C" int k1_probe_variant(int mode, const void* img, int in_dtype, void* out,
                                int out_dtype, const void* k, int batch, int hw, int run,
                                cudaStream_t s) {
  if (in_dtype == kFloat32 && out_dtype == kFloat32)
    return launch<float, float>(mode, img, out, k, batch, hw, run, s);
  if (in_dtype == kBFloat16 && out_dtype == kBFloat16)
    return launch<__nv_bfloat16, __nv_bfloat16>(mode, img, out, k, batch, hw, run, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int k1_probe_sincos(unsigned int* mismatches, cudaStream_t s) {
  sincos_check<<<132 * 16, 256, 0, s>>>(mismatches);
  return static_cast<int>(cudaGetLastError());
}
