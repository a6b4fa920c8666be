// P1: channel attention per (image, head) with q and k L2-normalised over
// space, on (G, c, N) q, k, v, G = batch * heads, N = H * W.
//
// Replaces the Pallas kernel experiments/attn_kernel_probe_r2.py:32
// `_attn_kernel` (via attn_pallas, call :53), which computes one image's
// (heads = 1) attention in one grid step with its temperature baked in.
// Here row g takes temps[g % heads]. Plain version: head_attention_plain in
// hvi_cidnet_torch/ops/head_attention_cuda.py (launch plan there too).
// Per g:
//
//   S = q k^T over N, fp32 (products of fp32-widened values);
//   S = ((S * rsqrt(max(|q_r|^2, 1e-24))) * rsqrt(max(|k_c|^2, 1e-24))) * t,
//     the squares in fp32;
//   A = softmax(S) over each row, fp32, then rounded to v's type;
//   out = A v, accumulated in fp32, rounded once to q's type.
//
// Bound: bytes. Per column it does 2 c^2 multiply-adds (1,296 flops at
// c = 18) for 4 c values read or written (144 bytes in bf16), 9 flops a
// byte, below the fp32 CUDA cores' ~20: the CUDA cores serve both types,
// and the fp32 arm stays exact (c = 18 would need padding for mma.sync).
//
// Design: one launch, one thread-block cluster of S <= 8 blocks per g (the
// plan's `splits`; one block a g would fill 16 of 132 SMs at batch 8).
// Block s takes columns [s * chunk, (s + 1) * chunk):
// 1. its partial scores and norms by the score core (qk_scores.cuh);
// 2. the cluster's sums through distributed shared memory, rank 0 first,
//    so every block holds the same bits of S and the norms;
// 3. the c x c softmax (one thread a row), A kept transposed in shared
//    memory, rows padded to CM (c_max: 8, 20 or 32);
// 4. A applied to its own columns of v: each thread one or two adjacent
//    columns (two where the loads of the score core are wider than one
//    element), the c values of v in registers, A read as float4
//    broadcasts (four FMAs a load), the output written once.
// Two blocks an SM (at most 128 registers a thread).
#include "qk_scores.cuh"

namespace hvi_cidnet {
namespace {

using qk::kThreads;

// shared memory, in bytes: the score core, the cluster's sums (fp32), then
// A^T (c x cm fp32) from a 16-byte boundary
__host__ __device__ inline int at_offset(int c, int itemsize) {
  return (qk::core_bytes(c, true, itemsize) + 4 * qk::entries(c, true) + 15) / 16 * 16;
}
__host__ __device__ inline int smem_bytes(int c, int itemsize) {
  return at_offset(c, itemsize) + 4 * c * qk::c_max(c);
}

template <typename T, int CM, int VEC>
__global__ void __launch_bounds__(kThreads, 2)
    head_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, T* __restrict__ out,
                          const float* __restrict__ temps, int heads, int c, int64_t n,
                          int64_t chunk) {
  constexpr int kAv = VEC >= 2 ? 2 : 1;  // columns a thread of the apply
  using AV = typename VecBytes<sizeof(T) * kAv>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int e_count = qk::entries(c, true);
  float* tot = reinterpret_cast<float*>(smem + qk::core_bytes(c, true, sizeof(T)));
  float* at = reinterpret_cast<float*>(smem + at_offset(c, sizeof(T)));  // at[j * CM + i] = A[i][j]
  const int64_t g = blockIdx.y;
  const int64_t col0 = blockIdx.x * chunk;
  const int64_t col_end = min64(n, col0 + chunk);
  const int64_t base = g * c * n;

  float* red = qk::block_scores<T, VEC, (CM + 2) / 3 * 3, true>(q + base, k + base, c, n, col0,
                                                                col_end, smem);
  qk::cluster_sum(red, 0, e_count, [&](int e, float s) { tot[e] = s; });

  const float t = temps[g % heads];
  const int r = threadIdx.x;
  if (r < c) {  // row r of the softmax
    float* row = tot + r * c;
    const float* kn = tot + c * c + c;
    const float inv_q = rsqrtf(fmaxf(tot[c * c + r], 1e-24f));
    float m = __int_as_float(0xff800000);  // -inf
    for (int j = 0; j < c; ++j) {
      const float s = ((row[j] * inv_q) * rsqrtf(fmaxf(kn[j], 1e-24f))) * t;
      row[j] = s;
      m = fmaxf(m, s);
    }
    float sum = 0.0f;
    for (int j = 0; j < c; ++j) {
      row[j] = expf(row[j] - m);
      sum += row[j];
    }
    for (int j = 0; j < c; ++j) at[j * CM + r] = round_through<T>(row[j] / sum);
  } else if (r < CM) {
    for (int j = 0; j < c; ++j) at[j * CM + r] = 0.0f;  // the padding rows of A
  }
  __syncthreads();

  const T* vb = v + base;
  T* ob = out + base;
  for (int64_t c0 = col0 + kAv * threadIdx.x; c0 < col_end; c0 += kAv * kThreads) {
    float vv[CM][kAv], acc[CM][kAv];
#pragma unroll
    for (int j = 0; j < CM; ++j) {  // every load in flight before the sums
      T pair[kAv];
      if (j < c) load_vec<sizeof(AV)>(pair, vb + j * n + c0);
#pragma unroll
      for (int e = 0; e < kAv; ++e) {
        vv[j][e] = j < c ? load_f32(pair, e) : 0.0f;
        acc[j][e] = 0.0f;
      }
    }
#pragma unroll
    for (int j = 0; j < CM; ++j) {
      if (j >= c) break;
#pragma unroll
      for (int i = 0; i < CM; i += 4) {
        const float4 a = *reinterpret_cast<const float4*>(at + j * CM + i);
#pragma unroll
        for (int e = 0; e < kAv; ++e) {
          acc[i][e] = fmaf(a.x, vv[j][e], acc[i][e]);
          acc[i + 1][e] = fmaf(a.y, vv[j][e], acc[i + 1][e]);
          acc[i + 2][e] = fmaf(a.z, vv[j][e], acc[i + 2][e]);
          acc[i + 3][e] = fmaf(a.w, vv[j][e], acc[i + 3][e]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < CM; ++i) {
      if (i >= c) break;
      T pair[kAv];
#pragma unroll
      for (int e = 0; e < kAv; ++e) pair[e] = from_f32<T>(acc[i][e]);
      store_vec<sizeof(AV)>(ob + i * n + c0, pair);
    }
  }
}

template <typename T, int CM, int VEC>
int launch(const void* q, const void* k, const void* v, void* out, const void* temps, int heads,
           int64_t g, int c, int64_t n, int splits, int64_t chunk, int64_t smem,
           cudaStream_t stream) {
  return qk::launch_cluster(head_attention_kernel<T, CM, VEC>, splits,
                            static_cast<unsigned int>(g), smem, stream, static_cast<const T*>(q),
                            static_cast<const T*>(k), static_cast<const T*>(v),
                            static_cast<T*>(out), static_cast<const float*>(temps), heads, c, n,
                            chunk);
}

template <typename T, int CM>
int launch_vec(int vec, const void* q, const void* k, const void* v, void* out,
               const void* temps, int heads, int64_t g, int c, int64_t n, int splits,
               int64_t chunk, int64_t smem, cudaStream_t stream) {
  constexpr int kWide = 16 / sizeof(T);
  if (vec == kWide)
    return launch<T, CM, kWide>(q, k, v, out, temps, heads, g, c, n, splits, chunk, smem, stream);
  if (vec == 2)
    return launch<T, CM, 2>(q, k, v, out, temps, heads, g, c, n, splits, chunk, smem, stream);
  return launch<T, CM, 1>(q, k, v, out, temps, heads, g, c, n, splits, chunk, smem, stream);
}

template <typename T>
int launch_cm(int vec, const void* q, const void* k, const void* v, void* out, const void* temps,
              int heads, int64_t g, int c, int64_t n, int splits, int64_t chunk, int64_t smem,
              cudaStream_t stream) {
  const int cm = qk::c_max(c);
  if (cm == 8)
    return launch_vec<T, 8>(vec, q, k, v, out, temps, heads, g, c, n, splits, chunk, smem, stream);
  if (cm == 20)
    return launch_vec<T, 20>(vec, q, k, v, out, temps, heads, g, c, n, splits, chunk, smem,
                             stream);
  return launch_vec<T, 32>(vec, q, k, v, out, temps, heads, g, c, n, splits, chunk, smem, stream);
}

}  // namespace
}  // namespace hvi_cidnet

using namespace hvi_cidnet;

// q, k, v, out: (g, c, n) contiguous, one type (dtype); temps: `heads` fp32
// values on the device, row i of q taking temps[i % heads]. splits, chunk,
// vec, smem: the plan of ops/head_attention_cuda.py:head_attention_plan
// (blocks a cluster, columns a block, elements a load, dynamic shared
// memory in bytes). Returns a cudaError_t code, cudaErrorInvalidValue for a
// plan it cannot run.
extern "C" int head_attention(const void* q, const void* k, const void* v, void* out, int dtype,
                              const void* temps, int heads, int64_t g, int c, int64_t n,
                              int splits, int64_t chunk, int vec, int64_t smem,
                              cudaStream_t stream) {
  const int itemsize = dtype == kFloat32 ? 4 : 2;
  if ((dtype != kFloat32 && dtype != kBFloat16) || c < 1 || c > qk::kMaxC || g < 1 ||
      g > 65535 || heads < 1 || g % heads || !qk::split_ok(n, splits, chunk) ||
      !qk::vec_ok(vec, itemsize, n, {q, k, v, out}) || smem != smem_bytes(c, itemsize) ||
      smem > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kFloat32)
    return launch_cm<float>(vec, q, k, v, out, temps, heads, g, c, n, splits, chunk, smem, stream);
  return launch_cm<__nv_bfloat16>(vec, q, k, v, out, temps, heads, g, c, n, splits, chunk, smem,
                                  stream);
}
