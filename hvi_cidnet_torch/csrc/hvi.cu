// K1 and K2: the HVI colour transform, fused, one thread per pixel.
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
// Bound: memory bandwidth. Per pixel K1 moves 3 loads + 3 stores (24 bytes
// in fp32, 12 in bf16) for ~60 flops of transcendental work (sinf, cosf x2,
// powf); K2 the same bytes with atan2f, sqrtf, powf, sinf. At the H100's
// 3.35 TB/s an (8, 400, 600) fp32 batch is ~11 us of traffic. Loads and
// stores of neighbouring threads are neighbouring addresses (the NHWC side
// touches 3 consecutive elements per thread).
//
// Traps kept as the twin has them:
// * mod is floored in both mod(., 6) (K1) and mod(., 1) (K2), as jnp.mod and
//   torch.remainder are; a bare fmodf truncates. In K2 a hue just under 0
//   wraps to 1 - tiny, rounds to 1.0f, gives hi == 6 and a black pixel.
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

__device__ __forceinline__ float floored_mod(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.0f && ((m < 0.0f) != (b < 0.0f))) m += b;
  return m;
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

template <typename In, typename Out>
__global__ void rgb_to_hvi_kernel(const In* __restrict__ img, Out* __restrict__ out,
                                  const float* __restrict__ k_ptr, int64_t n_pix, int64_t hw) {
  const float k = *k_ptr;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; p < n_pix;
       p += stride) {
    const float r = load_f32(img, 3 * p);
    const float g = load_f32(img, 3 * p + 1);
    const float b = load_f32(img, 3 * p + 2);
    const float value = fmaxf(fmaxf(r, g), b);
    const float vmin = fminf(fminf(r, g), b);
    const float denom = value - vmin + kEps;

    // reference write order: B-max, G-max, R-max, gray; later writes win
    float hue = (b == value) ? 4.0f + (r - g) / denom : 0.0f;
    hue = (g == value) ? 2.0f + (b - r) / denom : hue;
    hue = (r == value) ? floored_mod((g - b) / denom, 6.0f) : hue;
    hue = (vmin == value) ? 0.0f : hue;
    hue = hue / 6.0f;

    float sat = (value - vmin) / (value + kEps);
    sat = (value == 0.0f) ? 0.0f : sat;

    const float cs = powf(sinf(value * kHalfPi) + kEps, k);
    const float h_out = cs * sat * cosf(kTwoPi * hue);
    const float v_out = cs * sat * sinf(kTwoPi * hue);

    const int64_t bi = p / hw;
    Out* o = out + bi * 3 * hw + (p - bi * hw);
    o[0] = from_f32<Out>(round_through<In>(h_out));
    o[hw] = from_f32<Out>(round_through<In>(v_out));
    o[2 * hw] = from_f32<Out>(round_through<In>(value));
  }
}

template <typename T>
__global__ void hvi_to_rgb_kernel(const T* __restrict__ hvi, T* __restrict__ out,
                                  const float* __restrict__ k_ptr, int64_t n_pix, int64_t hw,
                                  int gated, int gated2, float alpha, float alpha_s) {
  const float k = *k_ptr;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; p < n_pix;
       p += stride) {
    const int64_t bi = p / hw;
    const T* x = hvi + bi * 3 * hw + (p - bi * hw);
    float h_c = clampf(load_f32(x, 0), -1.0f, 1.0f);
    float v_c = clampf(load_f32(x, hw), -1.0f, 1.0f);
    const float i_c = clampf(load_f32(x, 2 * hw), 0.0f, 1.0f);

    const float cs = powf(sinf(i_c * kHalfPi) + kEps, k);
    h_c = clampf(h_c / (cs + kEps), -1.0f, 1.0f);
    v_c = clampf(v_c / (cs + kEps), -1.0f, 1.0f);

    const float h = floored_mod(atan2f(v_c + kEps, h_c + kEps) / kTwoPi, 1.0f);
    float s = sqrtf(h_c * h_c + v_c * v_c + kEps);
    if (gated) s = s * alpha_s;
    s = clampf(s, 0.0f, 1.0f);
    const float v = clampf(i_c, 0.0f, 1.0f);

    const float hi = floorf(h * 6.0f);
    const float f = h * 6.0f - hi;
    const float pp = v * (1.0f - s);
    const float q = v * (1.0f - f * s);
    const float t = v * (1.0f - (1.0f - f) * s);

    // six disjoint sectors; hi == 6 matches none and stays black
    float r = 0.0f, g = 0.0f, b = 0.0f;
    if (hi == 0.0f) { r = v; g = t; b = pp; }
    else if (hi == 1.0f) { r = q; g = v; b = pp; }
    else if (hi == 2.0f) { r = pp; g = v; b = t; }
    else if (hi == 3.0f) { r = pp; g = q; b = v; }
    else if (hi == 4.0f) { r = t; g = pp; b = v; }
    else if (hi == 5.0f) { r = v; g = pp; b = q; }
    if (gated2) {
      r = r * alpha;
      g = g * alpha;
      b = b * alpha;
    }
    T* o = out + 3 * p;
    o[0] = from_f32<T>(r);
    o[1] = from_f32<T>(g);
    o[2] = from_f32<T>(b);
  }
}

template <typename In, typename Out>
int launch_rgb_to_hvi(const void* img, void* out, const void* k, int64_t n_pix, int64_t hw,
                      cudaStream_t stream) {
  rgb_to_hvi_kernel<In, Out><<<grid_for(n_pix), kThreads, 0, stream>>>(
      static_cast<const In*>(img), static_cast<Out*>(out), static_cast<const float*>(k), n_pix,
      hw);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hvi_to_rgb(const void* hvi, void* out, const void* k, int64_t n_pix, int64_t hw,
                      int gated, int gated2, float alpha, float alpha_s, cudaStream_t stream) {
  hvi_to_rgb_kernel<T><<<grid_for(n_pix), kThreads, 0, stream>>>(
      static_cast<const T*>(hvi), static_cast<T*>(out), static_cast<const float*>(k), n_pix, hw,
      gated, gated2, alpha, alpha_s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace hvi_cidnet

using namespace hvi_cidnet;

// img: (B, H, W, 3) contiguous; out: (B, 3, H, W) contiguous; k: one fp32 on
// the device. n_pix = B*H*W, hw = H*W. Returns cudaGetLastError().
extern "C" int hvi_rgb_to_hvi(const void* img, int in_dtype, void* out, int out_dtype,
                              const void* k, int64_t n_pix, int64_t hw, cudaStream_t stream) {
  if (in_dtype == kFloat32 && out_dtype == kFloat32)
    return launch_rgb_to_hvi<float, float>(img, out, k, n_pix, hw, stream);
  if (in_dtype == kFloat32 && out_dtype == kBFloat16)
    return launch_rgb_to_hvi<float, __nv_bfloat16>(img, out, k, n_pix, hw, stream);
  if (in_dtype == kBFloat16 && out_dtype == kFloat32)
    return launch_rgb_to_hvi<__nv_bfloat16, float>(img, out, k, n_pix, hw, stream);
  if (in_dtype == kBFloat16 && out_dtype == kBFloat16)
    return launch_rgb_to_hvi<__nv_bfloat16, __nv_bfloat16>(img, out, k, n_pix, hw, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// hvi: (B, 3, H, W) contiguous; out: (B, H, W, 3) contiguous, same dtype.
extern "C" int hvi_hvi_to_rgb(const void* hvi, void* out, int dtype, const void* k,
                              int64_t n_pix, int64_t hw, int gated, int gated2, float alpha,
                              float alpha_s, cudaStream_t stream) {
  if (dtype == kFloat32)
    return launch_hvi_to_rgb<float>(hvi, out, k, n_pix, hw, gated, gated2, alpha, alpha_s,
                                    stream);
  if (dtype == kBFloat16)
    return launch_hvi_to_rgb<__nv_bfloat16>(hvi, out, k, n_pix, hw, gated, gated2, alpha,
                                            alpha_s, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
