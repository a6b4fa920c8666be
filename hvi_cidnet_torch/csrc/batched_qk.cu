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
// On the CUDA cores (the first design's 3 x 3 register tiles, ~2.7
// instructions a multiply-add) that was above what they issue: the products
// bounded it, at 5.3x the bytes. On the tensor cores the products cost a
// fraction of the copies; what holds it back is each block's stream (~10
// GB/s a block whatever its ring's depth), so the time goes with the columns
// a block walks (PERF.md, PR 19's phases).
//
// Design: a cluster of S blocks per g, each block a chunk of N; the
// cluster's sums meet through distributed shared memory in rank order (two
// calls give the same bits), each block writing its share of the c x c
// entries. bf16: the tensor-core score core of qk_scores.cuh
// (mma_block_scores: a ring of 512-column stages filled by bulk copies or
// cp.async, mma.sync from ldmatrix fragments), with up to 16 blocks a g, as
// many as keep every cluster in one wave of the card's (a cluster left over
// doubles the time). fp32: the CUDA-core core (block_scores), at most 8.
// Two blocks an SM.
#include "qk_scores.cuh"

namespace hvi_cidnet {
namespace {

using qk::kThreads;

// each block of the cluster (at most kMax) writes entries [rank * per,
// (rank + 1) * per)
template <int kMax>
__device__ __forceinline__ void write_share(float* red, float* __restrict__ out, int64_t g, int c) {
  const int e_count = c * c, per = (e_count + gridDim.x - 1) / gridDim.x;
  const int lo = blockIdx.x * per;
  float* og = out + g * e_count;
  qk::cluster_sum<kMax>(red, lo, min(e_count, lo + per), [&](int e, float s) { og[e] = s; });
}

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
  write_share<qk::kMaxCluster>(red, out, g, c);
}

// NT: k's 8-row tiles, ceil(c / 8)
template <int NT>
__global__ void __launch_bounds__(kThreads, 2)
    batched_qk_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                          float* __restrict__ out, int c, int64_t n, int64_t chunk, int stages,
                          int direct) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t g = blockIdx.y;
  const int64_t col0 = blockIdx.x * chunk;
  const qk::MmaSmem sm(smem, c, false, stages, g, n);
  float* red = qk::mma_block_scores<NT, false>(q, k, c, static_cast<int64_t>(gridDim.y) * c * n,
                                               col0, min64(n, col0 + chunk), stages, direct != 0,
                                               sm, [] {});
  write_share<qk::kMmaMaxCluster>(red, out, g, c);
}

template <int CM, int VEC>
int launch(const void* q, const void* k, float* out, int64_t g, int c, int64_t n, int splits,
           int64_t chunk, int64_t smem, cudaStream_t stream) {
  return qk::launch_cluster(batched_qk_kernel<float, CM, VEC>, splits, static_cast<unsigned int>(g),
                            smem, stream, static_cast<const float*>(q),
                            static_cast<const float*>(k), out, c, n, chunk);
}

template <int CM>
int launch_vec(int vec, const void* q, const void* k, float* out, int64_t g, int c, int64_t n,
               int splits, int64_t chunk, int64_t smem, cudaStream_t stream) {
  if (vec == 4) return launch<CM, 4>(q, k, out, g, c, n, splits, chunk, smem, stream);
  if (vec == 2) return launch<CM, 2>(q, k, out, g, c, n, splits, chunk, smem, stream);
  return launch<CM, 1>(q, k, out, g, c, n, splits, chunk, smem, stream);
}

int launch_f32(int vec, const void* q, const void* k, float* out, int64_t g, int c, int64_t n,
               int splits, int64_t chunk, int64_t smem, cudaStream_t stream) {
  const int cm = qk::c_max(c);
  if (cm == 8) return launch_vec<8>(vec, q, k, out, g, c, n, splits, chunk, smem, stream);
  if (cm == 20) return launch_vec<20>(vec, q, k, out, g, c, n, splits, chunk, smem, stream);
  return launch_vec<32>(vec, q, k, out, g, c, n, splits, chunk, smem, stream);
}

template <int NT>
int launch_mma(const void* q, const void* k, float* out, int64_t g, int c, int64_t n, int splits,
               int64_t chunk, int stages, int direct, int64_t smem, cudaStream_t stream) {
  return qk::launch_cluster(batched_qk_mma_kernel<NT>, splits, static_cast<unsigned int>(g), smem,
                            stream, static_cast<const __nv_bfloat16*>(q),
                            static_cast<const __nv_bfloat16*>(k), out, c, n, chunk, stages,
                            direct);
}

int launch_bf16(const void* q, const void* k, float* out, int64_t g, int c, int64_t n,
                int splits, int64_t chunk, int stages, int direct, int64_t smem,
                cudaStream_t stream) {
  switch ((c + 7) / 8) {
    case 1: return launch_mma<1>(q, k, out, g, c, n, splits, chunk, stages, direct, smem, stream);
    case 2: return launch_mma<2>(q, k, out, g, c, n, splits, chunk, stages, direct, smem, stream);
    case 3: return launch_mma<3>(q, k, out, g, c, n, splits, chunk, stages, direct, smem, stream);
    default: return launch_mma<4>(q, k, out, g, c, n, splits, chunk, stages, direct, smem, stream);
  }
}

}  // namespace
}  // namespace hvi_cidnet

using namespace hvi_cidnet;

// q, k: (g, c, n) contiguous, one type (dtype); out: (g, c, c) fp32.
// splits, chunk, vec, stages, smem: the plan of ops/batched_qk_cuda.py:
// qk_plan (fp32: vec elements a load, stages 0; bf16: vec 8 direct or 1
// realigned, stages of the ring). Returns a cudaError_t code,
// cudaErrorInvalidValue for a plan it cannot run.
extern "C" int batched_qk(const void* q, const void* k, void* out, int dtype, int64_t g, int c,
                          int64_t n, int splits, int64_t chunk, int vec, int stages, int64_t smem,
                          cudaStream_t stream) {
  const bool f32 = dtype == kFloat32;
  const int max_cluster = f32 ? qk::kMaxCluster : qk::kMmaMaxCluster;
  if ((!f32 && dtype != kBFloat16) || c < 1 || c > qk::kMaxC || g < 1 || g > 65535 ||
      !qk::split_ok(n, splits, chunk, max_cluster) || smem > 232448 ||
      (f32 ? stages != 0 || !qk::vec_ok(vec, 4, n, {q, k}) || smem != qk::core_bytes(c, false, 4)
           : !qk::mma_ok(chunk, stages, vec, n, {q, k}) || smem != qk::mma_bytes(c, false, stages)))
    return static_cast<int>(cudaErrorInvalidValue);
  float* o = static_cast<float*>(out);
  if (f32) return launch_f32(vec, q, k, o, g, c, n, splits, chunk, smem, stream);
  return launch_bf16(q, k, o, g, c, n, splits, chunk, stages, vec == 8, smem, stream);
}

// The bf16 kernel's clusters of `cluster` blocks at `smem` bytes that the
// card holds at once, at c rows (ops/batched_qk_cuda.py:card_clusters), or
// minus a cudaError_t code.
extern "C" int batched_qk_active_clusters(int c, int cluster, int64_t smem) {
  switch ((c + 7) / 8) {
    case 1: return qk::active_clusters(batched_qk_mma_kernel<1>, cluster, smem);
    case 2: return qk::active_clusters(batched_qk_mma_kernel<2>, cluster, smem);
    case 3: return qk::active_clusters(batched_qk_mma_kernel<3>, cluster, smem);
    default: return qk::active_clusters(batched_qk_mma_kernel<4>, cluster, smem);
  }
}
