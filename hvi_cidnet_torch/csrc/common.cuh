// Shared helpers of the port's CUDA kernels: fp32/bf16 loads and stores,
// 64-bit grid-stride loops, and the dtype codes of the C interface
// (0 = float32, 1 = bfloat16; see hvi_cidnet_torch/ops/_build.py).
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace hvi_cidnet {

constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;
constexpr int kThreads = 256;

__device__ __forceinline__ float load_f32(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);  // round to nearest even, as torch's .to(bfloat16)
}

// x rounded to T and widened back to fp32
template <typename T>
__device__ __forceinline__ float round_through(float x);
template <>
__device__ __forceinline__ float round_through<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_through<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) { return a > b ? a : b; }

// Enough blocks to fill the card several times over; a grid-stride loop
// with 64-bit indices covers the rest (a (128, 36, 400, 600) activation
// has 1.1e9 elements, past the int32 range).
inline unsigned int grid_for(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  const int64_t cap = 132 * 32;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  return static_cast<unsigned int>(blocks);
}

}  // namespace hvi_cidnet
