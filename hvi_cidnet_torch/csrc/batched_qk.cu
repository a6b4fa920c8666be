// P10/P15: the batched score product s[g] = q[g] k[g]^T over N, in fp32,
// on (G, c, N) q and k (fp32 or bf16), G = batch * heads.
//
// Replaces the Pallas kernels experiments/relayout_probe_r5h.py:98
// `_dot_kernel` (via dot_bcn, call :110: the sum accumulated over a grid of
// N blocks) and experiments/mosaic_micro_r5h.py:106 `_bdot_kernel` (via
// bdot, call :117: all of N in one block), which compute this one
// function. P10 as written never zeroes its output before the first `+=`
// (interpret mode returns NaN); P15 and this kernel compute what P10 was
// meant to. Plain version: batched_qk_plain in
// hvi_cidnet_torch/ops/batched_qk_cuda.py (launch plan there too). The
// port's route runs it at TNSM's noise-aware attention, whose q and k are
// not normalised, so P1 cannot serve it; the temperature, softmax and value
// product follow as plain ops.
//
// Bound: bytes, q and k read once (the c x c output is tiny): c^2
// multiply-adds a column for 2c values, 4.5 flops a byte in bf16 at c = 18.
//
// Design: the score core of qk_scores.cuh on a cluster of S <= 8 blocks
// per g, each block a chunk of N; the cluster's sums meet through
// distributed shared memory in rank order (two calls give the same bits),
// each block writing its share of the c x c entries. Two blocks an SM.
#include "qk_scores.cuh"

namespace hvi_cidnet {
namespace {

using qk::kThreads;

template <typename T, int CM, int VEC>
__global__ void __launch_bounds__(kThreads, 2)
    batched_qk_kernel(const T* __restrict__ q, const T* __restrict__ k, float* __restrict__ out,
                      int c, int64_t n, int64_t chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t g = blockIdx.y;
  const int64_t col0 = blockIdx.x * chunk;
  const int64_t base = g * c * n;
  float* red = qk::block_scores<T, VEC, (CM + 2) / 3 * 3, false>(
      q + base, k + base, c, n, col0, min64(n, col0 + chunk), smem);
  const int e_count = c * c, per = (e_count + gridDim.x - 1) / gridDim.x;
  const int lo = blockIdx.x * per;
  float* og = out + g * e_count;
  qk::cluster_sum(red, lo, min(e_count, lo + per), [&](int e, float s) { og[e] = s; });
}

template <typename T, int CM, int VEC>
int launch(const void* q, const void* k, float* out, int64_t g, int c, int64_t n, int splits,
           int64_t chunk, int64_t smem, cudaStream_t stream) {
  return qk::launch_cluster(batched_qk_kernel<T, CM, VEC>, splits, static_cast<unsigned int>(g),
                            smem, stream, static_cast<const T*>(q), static_cast<const T*>(k), out,
                            c, n, chunk);
}

template <typename T, int CM>
int launch_vec(int vec, const void* q, const void* k, float* out, int64_t g, int c, int64_t n,
               int splits, int64_t chunk, int64_t smem, cudaStream_t stream) {
  constexpr int kWide = 16 / sizeof(T);
  if (vec == kWide) return launch<T, CM, kWide>(q, k, out, g, c, n, splits, chunk, smem, stream);
  if (vec == 2) return launch<T, CM, 2>(q, k, out, g, c, n, splits, chunk, smem, stream);
  return launch<T, CM, 1>(q, k, out, g, c, n, splits, chunk, smem, stream);
}

template <typename T>
int launch_cm(int vec, const void* q, const void* k, float* out, int64_t g, int c, int64_t n,
              int splits, int64_t chunk, int64_t smem, cudaStream_t stream) {
  const int cm = qk::c_max(c);
  if (cm == 8) return launch_vec<T, 8>(vec, q, k, out, g, c, n, splits, chunk, smem, stream);
  if (cm == 20) return launch_vec<T, 20>(vec, q, k, out, g, c, n, splits, chunk, smem, stream);
  return launch_vec<T, 32>(vec, q, k, out, g, c, n, splits, chunk, smem, stream);
}

}  // namespace
}  // namespace hvi_cidnet

using namespace hvi_cidnet;

// q, k: (g, c, n) contiguous, one type (dtype); out: (g, c, c) fp32.
// splits, chunk, vec, smem: the plan of ops/batched_qk_cuda.py:qk_plan.
// Returns a cudaError_t code, cudaErrorInvalidValue for a plan it cannot
// run.
extern "C" int batched_qk(const void* q, const void* k, void* out, int dtype, int64_t g, int c,
                          int64_t n, int splits, int64_t chunk, int vec, int64_t smem,
                          cudaStream_t stream) {
  const int itemsize = dtype == kFloat32 ? 4 : 2;
  if ((dtype != kFloat32 && dtype != kBFloat16) || c < 1 || c > qk::kMaxC || g < 1 ||
      g > 65535 || !qk::split_ok(n, splits, chunk) || !qk::vec_ok(vec, itemsize, n, {q, k}) ||
      smem != qk::core_bytes(c, false, itemsize) || smem > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  float* o = static_cast<float*>(out);
  if (dtype == kFloat32) return launch_cm<float>(vec, q, k, o, g, c, n, splits, chunk, smem, stream);
  return launch_cm<__nv_bfloat16>(vec, q, k, o, g, c, n, splits, chunk, smem, stream);
}
