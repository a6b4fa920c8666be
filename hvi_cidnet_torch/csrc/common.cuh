// Shared helpers of the port's CUDA kernels: fp32/bf16 loads and stores,
// vector loads and stores of 2 to 16 bytes, cp.async copies (zero-filling
// ones too), mbarriers and bulk copies, 64-bit grid-stride loops, and the
// dtype codes of the C interface (0 = float32, 1 = bfloat16; see
// hvi_cidnet_torch/ops/_build.py).
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mutex>
#include <set>
#include <utility>

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
// BYTES (2, 4, 8 or 16; both addresses aligned to it) from device to shared
// memory, or zeros where !valid (gmem is not read then). 4, 8 and 16 bytes
// are cp.async copies (16 bypassing L1); 2 bytes, which cp.async cannot
// copy, a plain load and store.
template <int BYTES>
__device__ __forceinline__ void cp_async_zfill(void* smem, const void* gmem, bool valid) {
  const unsigned int s = static_cast<unsigned int>(__cvta_generic_to_shared(smem));
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n)
                 : "memory");
  } else if constexpr (BYTES == 8 || BYTES == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(gmem),
                 "n"(BYTES), "r"(n)
                 : "memory");
  } else {
    *static_cast<unsigned short*>(smem) = valid ? *static_cast<const unsigned short*>(gmem) : 0;
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// mbarriers and the bulk copy engine (the TMA unit's 1-D copies): a barrier
// in shared memory counts `count` arrivals and the bytes it expects; a bulk
// copy of `bytes` (a multiple of 16, both addresses 16-byte aligned) reports
// its bytes to it when they have landed
__device__ __forceinline__ void mbar_init(void* bar, int count) {
  const unsigned int b = static_cast<unsigned int>(__cvta_generic_to_shared(bar));
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(b), "r"(count) : "memory");
}
// makes the initialised barriers visible to the copy engine
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive_expect(void* bar, unsigned int bytes) {
  const unsigned int b = static_cast<unsigned int>(__cvta_generic_to_shared(bar));
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b), "r"(bytes)
               : "memory");
}
// waits until the barrier's phase `parity` has completed
__device__ __forceinline__ void mbar_wait(void* bar, unsigned int parity) {
  const unsigned int b = static_cast<unsigned int>(__cvta_generic_to_shared(bar));
  unsigned int done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(b), "r"(parity)
        : "memory");
  }
}
__device__ __forceinline__ void bulk_copy(void* smem, const void* gmem, unsigned int bytes,
                                          void* bar) {
  const unsigned int s = static_cast<unsigned int>(__cvta_generic_to_shared(smem));
  const unsigned int b = static_cast<unsigned int>(__cvta_generic_to_shared(bar));
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(s), "l"(gmem), "r"(bytes), "r"(b)
      : "memory");
}
// a 3-D tile of a tensor map (the TMA unit): box at coordinates (c0, c1, c2),
// innermost first, into smem (1 KB aligned for the 128-byte swizzle);
// elements past the tensor's edges land as zeros, and the box's full bytes
// are reported to the barrier
__device__ __forceinline__ void tma_load_3d(void* smem, const void* tmap, int c0, int c1, int c2,
                                            void* bar) {
  const unsigned int s = static_cast<unsigned int>(__cvta_generic_to_shared(smem));
  const unsigned int b = static_cast<unsigned int>(__cvta_generic_to_shared(bar));
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(s),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(c0), "r"(c1), "r"(c2), "r"(b)
      : "memory");
}
// bytes (a multiple of 16, both addresses 16-byte aligned) from shared to
// device memory by the copy engine, in this thread's bulk group; the group's
// wait below returns once the engine has read the source
__device__ __forceinline__ void bulk_store(void* gmem, const void* smem, unsigned int bytes) {
  const unsigned int s = static_cast<unsigned int>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(gmem),
               "r"(s), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// orders this thread's earlier accesses of shared memory before the copy
// engine's later ones
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// cp_async_wait<n> for a count known only at run time (a ring whose depth
// the launch plan picks: at most 8 stages, so n in [0, 6])
__device__ __forceinline__ void cp_async_wait_dyn(int n) {
  switch (n) {
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<0>(); break;
  }
}

// Lift a kernel's dynamic shared-memory cap to a block's 227 KB, once per
// kernel and device, when a launch asks for more than the default 48 KB. The
// attribute is the kernel's, shared by every host thread: setting it to each
// launch's own size would race, as one thread could lower it between another
// thread's setting and launch (data-parallel replicas and the server launch
// from several threads, at several sizes). Returns a cudaError_t code.
inline int raise_smem_cap(const void* fn, int64_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  static std::mutex mu;
  static std::set<std::pair<const void*, int>> done;
  int device = 0;
  cudaGetDevice(&device);
  std::lock_guard<std::mutex> lock(mu);
  if (done.count({fn, device})) return 0;
  const cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  if (err == cudaSuccess) done.insert({fn, device});
  return static_cast<int>(err);
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
