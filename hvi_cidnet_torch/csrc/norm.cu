// K6: channel LayerNorm over dim 1 of NCHW activations: biased variance,
// eps inside the rsqrt (net/transformer_utils.py:24-29).
//
// Replaces the Pallas kernel hvi_cidnet_tpu/ops/norm_pallas.py:53
// _ln_kernel (call :90 in layer_norm_pallas :76). The plain twin is
// layer_norm_channels in hvi_cidnet_torch/ops/conv.py (dispatcher in
// ops/norm_cuda.py), whose two numeric forms this kernel repeats:
//
// * fp32: the exact two-pass form u = mean(x), s = mean((x-u)^2),
//   y = w * ((x - u) * rsqrt(s + eps)) + b;
// * bf16: fp32 statistics as E[x^2] - E[x]^2 clamped at 0, scale =
//   rsqrt(s + eps) and shift = u rounded to bf16, then an apply that rounds
//   after each of (x - shift), * scale, w *, + b, as the twin's bf16
//   elementwise ops do.
//
// Bound: memory bandwidth (x read once, y written once; ~8 flops an element).
// A block owns kPixels pixels of one image, one per thread, and loops over
// the C channels: neighbouring threads read neighbouring pixels of one
// channel plane, so every load and store coalesces. The block's C x kPixels
// slice is staged in shared memory, each thread in its own column, so the
// statistics and the apply read x from device memory once. No thread reads
// another's column, so the kernel needs no barrier.
#include <type_traits>

#include "common.cuh"

namespace hvi_cidnet {
namespace {

constexpr int kPixels = 128;  // pixels (= threads) per block

template <typename T>
__global__ void __launch_bounds__(kPixels)
    layer_norm_kernel(const T* __restrict__ x, T* __restrict__ out, const float* __restrict__ weight,
                      const float* __restrict__ bias, int c, int64_t hw, int64_t tiles_per_image,
                      float eps) {
  extern __shared__ unsigned char smem_raw[];
  T* col = reinterpret_cast<T*>(smem_raw) + threadIdx.x;  // this thread's column, stride kPixels

  const int64_t b = blockIdx.x / tiles_per_image;
  const int64_t p = (blockIdx.x - b * tiles_per_image) * kPixels + threadIdx.x;
  if (p >= hw) return;
  const T* src = x + b * c * hw + p;
  T* dst = out + b * c * hw + p;

  if constexpr (std::is_same<T, float>::value) {
    float sum = 0.0f;
    for (int ch = 0; ch < c; ++ch) {
      const float v = src[ch * hw];
      col[ch * kPixels] = v;
      sum += v;
    }
    const float u = sum / c;
    float ss = 0.0f;
    for (int ch = 0; ch < c; ++ch) {
      const float d = col[ch * kPixels] - u;
      ss += d * d;
    }
    const float r = rsqrtf(ss / c + eps);
    for (int ch = 0; ch < c; ++ch) {
      const float d = col[ch * kPixels] - u;
      dst[ch * hw] = weight[ch] * (d * r) + bias[ch];
    }
  } else {
    float sum = 0.0f, sq = 0.0f;
    for (int ch = 0; ch < c; ++ch) {
      const T v = src[ch * hw];
      col[ch * kPixels] = v;
      const float f = load_f32(&v, 0);
      sum += f;
      sq += f * f;
    }
    const float u = sum / c;
    const float s = fmaxf(sq / c - u * u, 0.0f);
    const float scale = round_through<T>(rsqrtf(s + eps));
    const float shift = round_through<T>(u);
    for (int ch = 0; ch < c; ++ch) {
      const float d = round_through<T>(load_f32(col, static_cast<int64_t>(ch) * kPixels) - shift);
      const float t = round_through<T>(d * scale);
      const float y = round_through<T>(round_through<T>(weight[ch]) * t);
      dst[ch * hw] = from_f32<T>(y + round_through<T>(bias[ch]));
    }
  }
}

template <typename T>
int launch_layer_norm(const void* x, void* out, const void* weight, const void* bias, int64_t b,
                      int c, int64_t hw, float eps, cudaStream_t stream) {
  const int64_t tiles = (hw + kPixels - 1) / kPixels;
  const size_t smem = static_cast<size_t>(c) * kPixels * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        layer_norm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  layer_norm_kernel<T><<<static_cast<unsigned int>(b * tiles), kPixels, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<const float*>(weight),
      static_cast<const float*>(bias), c, hw, tiles, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace hvi_cidnet

using namespace hvi_cidnet;

// x, out: (b, c, hw) contiguous; weight, bias: c fp32 values on the device.
// c <= 256 (the shared-memory column). Returns cudaGetLastError().
extern "C" int layer_norm_channels(const void* x, void* out, int dtype, const void* weight,
                                   const void* bias, int64_t b, int c, int64_t hw, float eps,
                                   cudaStream_t stream) {
  if (c < 1 || c > 256 || b < 1 || hw < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kFloat32) return launch_layer_norm<float>(x, out, weight, bias, b, c, hw, eps, stream);
  if (dtype == kBFloat16)
    return launch_layer_norm<__nv_bfloat16>(x, out, weight, bias, b, c, hw, eps, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
