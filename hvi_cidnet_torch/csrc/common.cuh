// Shared helpers of the port's CUDA kernels: fp32/bf16 loads and stores,
// vector loads and stores of 2 to 16 bytes, cp.async copies, 64-bit
// grid-stride loops, and the dtype codes of the C interface (0 = float32,
// 1 = bfloat16; see hvi_cidnet_torch/ops/_build.py).
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

// the unsigned type of kBytes (2, 4, 8 or 16): one vector access
template <int kBytes>
struct VecBytes;
template <>
struct VecBytes<2> { using type = unsigned short; };
template <>
struct VecBytes<4> { using type = unsigned int; };
template <>
struct VecBytes<8> { using type = uint2; };
template <>
struct VecBytes<16> { using type = uint4; };

// kBytes of vals to dst (aligned to kBytes) in one store
template <int kBytes>
__device__ __forceinline__ void store_vec(void* dst, const void* vals) {
  using V = typename VecBytes<kBytes>::type;
  *static_cast<V*>(dst) = *static_cast<const V*>(vals);
}

// kBytes of src (aligned to kBytes) to vals in one load
template <int kBytes>
__device__ __forceinline__ void load_vec(void* vals, const void* src) {
  using V = typename VecBytes<kBytes>::type;
  *static_cast<V*>(vals) = *static_cast<const V*>(src);
}

// 16-byte copies from device to shared memory that bypass L1 (cp.async.cg),
// committed and waited for in groups
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned int s = static_cast<unsigned int>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

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
