// K5: channel ("transposed") attention of the CAB blocks on NCHW q/k/v,
// read as (B, C, N) with N = H*W.
//
// Replaces the Pallas kernel hvi_cidnet_tpu/ops/attention.py:181
// _attn_kernel (call :239 in attention_bcn_pallas :217), whose (B, C, N)
// operand is exactly the port's NCHW activation. The plain twin is
// channel_attention in hvi_cidnet_torch/ops/attention.py (dispatcher in
// ops/attention_cuda.py). Per image:
//
//   S = q k^T over N, in fp32;
//   optionally S = (S * rsqrt(max(|q_r|^2, 1e-24))) * rsqrt(max(|k_c|^2, 1e-24))
//     (F.normalize of q and k over space, hoisted past the product);
//   S *= temperature[head(r)] per row;
//   block-diagonal head mask, then an fp32 softmax per row;
//   optionally A = W attn, W the (C_out, C_in) project_out weight in fp32
//     (proj(attn v) == (W attn) v);
//   out = A.to(v.dtype) v, accumulated in fp32 and rounded once.
//
// Three passes behind one C entry point (one call = one CAB site):
//
// 1. scores: grid (splits, B, entry groups). Blocks run in parallel on
//    the SMs (the TPU grid ran in order on one core), so the contraction
//    over N is split: each block stages kScoreTile columns of q and k at a
//    time in shared memory and accumulates, for its slice of N, only the
//    C x cp block-diagonal entries (the masked ones never reach the output:
//    computing them would cost `heads` times the work) plus |q_r|^2 and
//    |k_c|^2, and writes them to a partial buffer (B, splits, C*cp + 2C).
// 2. softmax rows: grid (C, B). Each row reduces its partials over the
//    splits in a fixed order (no atomics: two calls give the same bits),
//    then norms, temperature, softmax. Without a fold it writes the row of
//    A (rounded through v's type); with one it writes attn (B, C, cp).
// 3. (fold only) A[c][d] = sum over m in head(d) of W[c][m] attn[m][d].
// 4. apply: grid (N tiles, B). A (C x C, fp32) and a C x kApplyTile tile
//    of v sit in shared memory; out[c][n] = sum_d A[c][d] v[d][n].
//
// Bound: at the forward's shapes the bytes of q, k, v and out (the C x C
// matrices are tiny), except at level 3, where the C^2 N apply on CUDA
// cores (fp32 FMAs, 67 TFLOP/s) takes longer than the bytes; on tensor
// cores (bf16, 989 TFLOP/s) the bytes bound every site. This first version
// uses CUDA-core FMAs throughout; mma/wgmma is later work.
#include <algorithm>

#include "common.cuh"

namespace hvi_cidnet {
namespace {

constexpr int kAttnThreads = 256;
constexpr int kScoreTile = 32;       // spatial columns staged per step of pass 1
constexpr int kMaxEntriesPerThread = 16;
constexpr int kEntriesPerBlock = kAttnThreads * kMaxEntriesPerThread;
constexpr int kApplyTile = 64;       // spatial columns per block of the apply
constexpr int kApplyRows = 8;        // output rows per accumulator set
constexpr int kMaxChannels = 192;    // A (C x C fp32) + the v tile fit shared memory
constexpr int kRowThreads = 128;

// Pass 1. EPT: entries per thread (a power of two, from the entry count).
template <typename T, int EPT>
__global__ void __launch_bounds__(kAttnThreads)
    scores_kernel(const T* __restrict__ q, const T* __restrict__ k, float* __restrict__ part,
                  int c, int cp, int64_t n, int64_t chunk, int splits, int64_t stride) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                   // (kScoreTile, c): column j of the tile, channel-minor
  float* ks = smem + kScoreTile * c;

  const int split = blockIdx.x;
  const int64_t b = blockIdx.y;
  const int group = blockIdx.z;
  const int64_t n_begin = split * chunk;
  const int64_t n_end = min64(n, n_begin + chunk);
  const T* qb = q + b * c * n;
  const T* kb = k + b * c * n;
  const int entries = c * cp;

  int rq[EPT], rk[EPT];
  float acc[EPT];
#pragma unroll
  for (int i = 0; i < EPT; ++i) {
    const int e = group * kEntriesPerBlock + threadIdx.x + i * kAttnThreads;
    const int r = e < entries ? e / cp : 0;  // out-of-range slots compute on row 0, unwritten
    const int j = e < entries ? e - r * cp : 0;
    rq[i] = r;
    rk[i] = (r / cp) * cp + j;
    acc[i] = 0.0f;
  }
  const bool norms = group == 0 && static_cast<int>(threadIdx.x) < c;
  float qq = 0.0f, kk = 0.0f;

  for (int64_t n0 = n_begin; n0 < n_end; n0 += kScoreTile) {
    for (int idx = threadIdx.x; idx < c * kScoreTile; idx += kAttnThreads) {
      const int ch = idx / kScoreTile, j = idx % kScoreTile;
      const int64_t col = n0 + j;
      const bool in = col < n_end;
      qs[j * c + ch] = in ? load_f32(qb, ch * n + col) : 0.0f;
      ks[j * c + ch] = in ? load_f32(kb, ch * n + col) : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kScoreTile; ++j) {
      const float* qrow = qs + j * c;
      const float* krow = ks + j * c;
#pragma unroll
      for (int i = 0; i < EPT; ++i) acc[i] = fmaf(qrow[rq[i]], krow[rk[i]], acc[i]);
      if (norms) {
        const float a = qrow[threadIdx.x], bb = krow[threadIdx.x];
        qq = fmaf(a, a, qq);
        kk = fmaf(bb, bb, kk);
      }
    }
    __syncthreads();
  }

  float* dst = part + (b * splits + split) * stride;
#pragma unroll
  for (int i = 0; i < EPT; ++i) {
    const int e = group * kEntriesPerBlock + threadIdx.x + i * kAttnThreads;
    if (e < entries) dst[e] = acc[i];
  }
  if (norms) {
    dst[entries + threadIdx.x] = qq;
    dst[entries + c + threadIdx.x] = kk;
  }
}

// Pass 2: one block per (row r, image b).
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
    softmax_rows_kernel(const float* __restrict__ part, const float* __restrict__ temperature,
                        float* __restrict__ attn, float* __restrict__ a_out, int c, int cp,
                        int splits, int64_t stride, int normalize) {
  __shared__ float vals[2 * kMaxChannels + 1];  // S[r][0..cp), |q_r|^2, |k_col|^2 of the head
  __shared__ float row[kMaxChannels];
  const int r = blockIdx.x;
  const int64_t b = blockIdx.y;
  const int head = r / cp;
  const int base = head * cp;
  const int entries = c * cp;
  const int nq = 2 * cp + 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  const float* src = part + b * splits * stride;
  for (int qi = warp; qi < nq; qi += kRowThreads / 32) {
    const int64_t off = qi < cp ? r * cp + qi
                        : qi == cp ? entries + r
                                   : entries + c + base + (qi - cp - 1);
    float s = 0.0f;
    for (int sp = lane; sp < splits; sp += 32) s += src[sp * stride + off];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) vals[qi] = s;
  }
  __syncthreads();

  if (threadIdx.x == 0) {
    const float inv_q = rsqrtf(fmaxf(vals[cp], 1e-24f));
    const float t = temperature[head];
    float m = __int_as_float(0xff800000);  // -inf
    for (int j = 0; j < cp; ++j) {
      float s = vals[j];
      if (normalize) s = (s * inv_q) * rsqrtf(fmaxf(vals[cp + 1 + j], 1e-24f));
      s = s * t;
      row[j] = s;
      m = fmaxf(m, s);
    }
    float sum = 0.0f;
    for (int j = 0; j < cp; ++j) {
      row[j] = expf(row[j] - m);
      sum += row[j];
    }
    for (int j = 0; j < cp; ++j) row[j] = row[j] / sum;
  }
  __syncthreads();

  if (attn != nullptr) {
    for (int j = threadIdx.x; j < cp; j += kRowThreads) attn[(b * c + r) * cp + j] = row[j];
  } else {
    for (int d = threadIdx.x; d < c; d += kRowThreads) {
      const bool in = d >= base && d < base + cp;
      a_out[(b * c + r) * c + d] = in ? round_through<T>(row[d - base]) : 0.0f;
    }
  }
}

// Pass 3 (fold): one block per (output row, image).
template <typename T, typename TW>
__global__ void __launch_bounds__(kAttnThreads)
    fold_kernel(const float* __restrict__ attn, const TW* __restrict__ wproj,
                float* __restrict__ a_out, int c, int cp) {
  const int row = blockIdx.x;
  const int64_t b = blockIdx.y;
  for (int d = threadIdx.x; d < c; d += kAttnThreads) {
    const int base = (d / cp) * cp;
    const int j = d - base;
    float acc = 0.0f;
    for (int m = base; m < base + cp; ++m)
      acc = fmaf(load_f32(wproj, static_cast<int64_t>(row) * c + m), attn[(b * c + m) * cp + j],
                 acc);
    a_out[(b * c + row) * c + d] = round_through<T>(acc);
  }
}

// Pass 4: out = A v; grid (N tiles, B), kApplyTile columns x 4 row groups.
template <typename T>
__global__ void __launch_bounds__(kAttnThreads)
    apply_kernel(const float* __restrict__ a, const T* __restrict__ v, T* __restrict__ out, int c,
                 int cpad, int64_t n) {
  extern __shared__ __align__(16) float smem[];
  float* as = smem;               // (c, cpad), zero-padded columns
  float* vs = smem + c * cpad;    // (cpad, kApplyTile), zero-padded rows and columns
  const int64_t b = blockIdx.y;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kApplyTile;
  const float* ab = a + b * c * c;
  const T* vb = v + b * c * n;

  for (int idx = threadIdx.x; idx < c * cpad; idx += kAttnThreads) {
    const int r = idx / cpad, d = idx % cpad;
    as[idx] = d < c ? ab[r * c + d] : 0.0f;
  }
  for (int idx = threadIdx.x; idx < cpad * kApplyTile; idx += kAttnThreads) {
    const int d = idx / kApplyTile, j = idx % kApplyTile;
    const int64_t col = n0 + j;
    vs[idx] = (d < c && col < n) ? load_f32(vb, d * n + col) : 0.0f;
  }
  __syncthreads();

  constexpr int kGroups = kAttnThreads / kApplyTile;
  const int j = threadIdx.x % kApplyTile;
  const int g = threadIdx.x / kApplyTile;
  const int64_t col = n0 + j;
  for (int r0 = g * kApplyRows; r0 < c; r0 += kGroups * kApplyRows) {
    float acc[kApplyRows];
    const float4* arow[kApplyRows];
#pragma unroll
    for (int i = 0; i < kApplyRows; ++i) {
      acc[i] = 0.0f;
      const int r = min(r0 + i, c - 1);  // rows past c read row c-1 and are not written
      arow[i] = reinterpret_cast<const float4*>(as + r * cpad);
    }
    for (int d4 = 0; d4 < cpad / 4; ++d4) {
      const float v0 = vs[(4 * d4 + 0) * kApplyTile + j];
      const float v1 = vs[(4 * d4 + 1) * kApplyTile + j];
      const float v2 = vs[(4 * d4 + 2) * kApplyTile + j];
      const float v3 = vs[(4 * d4 + 3) * kApplyTile + j];
#pragma unroll
      for (int i = 0; i < kApplyRows; ++i) {
        const float4 w = arow[i][d4];
        acc[i] = fmaf(w.x, v0, acc[i]);
        acc[i] = fmaf(w.y, v1, acc[i]);
        acc[i] = fmaf(w.z, v2, acc[i]);
        acc[i] = fmaf(w.w, v3, acc[i]);
      }
    }
    if (col < n) {
#pragma unroll
      for (int i = 0; i < kApplyRows; ++i)
        if (r0 + i < c) out[(b * c + r0 + i) * n + col] = from_f32<T>(acc[i]);
    }
  }
}

int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

template <typename T, int EPT>
int launch_scores(const T* q, const T* k, float* part, int64_t b, int c, int cp, int64_t n,
                  int splits, int64_t chunk, int64_t stride, cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(kScoreTile) * c * sizeof(float);
  int err = set_smem(reinterpret_cast<const void*>(scores_kernel<T, EPT>), smem);
  if (err) return err;
  const int groups = (c * cp + kEntriesPerBlock - 1) / kEntriesPerBlock;
  dim3 grid(splits, static_cast<unsigned int>(b), groups);
  scores_kernel<T, EPT><<<grid, kAttnThreads, smem, stream>>>(q, k, part, c, cp, n, chunk, splits,
                                                              stride);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TW>
int launch_fold(const float* attn, const void* w, float* a, int64_t b, int c, int cp,
                cudaStream_t stream) {
  fold_kernel<T, TW><<<dim3(c, static_cast<unsigned int>(b)), kAttnThreads, 0, stream>>>(
      attn, static_cast<const TW*>(w), a, c, cp);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_attention(const void* qv, const void* kv, const void* vv, void* outv,
                     const float* temp, const void* w, int w_dtype, float* part, float* attn,
                     float* a, int64_t b, int c, int heads, int64_t n, int splits, int64_t chunk,
                     int normalize, cudaStream_t stream) {
  const T* q = static_cast<const T*>(qv);
  const T* k = static_cast<const T*>(kv);
  const T* v = static_cast<const T*>(vv);
  T* out = static_cast<T*>(outv);
  const int cp = c / heads;
  const int entries = c * cp;
  const int64_t stride = entries + 2 * c;
  const int per_thread = (std::min(entries, kEntriesPerBlock) + kAttnThreads - 1) / kAttnThreads;

  int err;
  if (per_thread <= 1) err = launch_scores<T, 1>(q, k, part, b, c, cp, n, splits, chunk, stride, stream);
  else if (per_thread <= 2) err = launch_scores<T, 2>(q, k, part, b, c, cp, n, splits, chunk, stride, stream);
  else if (per_thread <= 4) err = launch_scores<T, 4>(q, k, part, b, c, cp, n, splits, chunk, stride, stream);
  else if (per_thread <= 8) err = launch_scores<T, 8>(q, k, part, b, c, cp, n, splits, chunk, stride, stream);
  else err = launch_scores<T, 16>(q, k, part, b, c, cp, n, splits, chunk, stride, stream);
  if (err) return err;

  const bool fold = w != nullptr;
  softmax_rows_kernel<T><<<dim3(c, static_cast<unsigned int>(b)), kRowThreads, 0, stream>>>(
      part, temp, fold ? attn : nullptr, a, c, cp, splits, stride, normalize);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;

  if (fold) {
    if (w_dtype == kFloat32) err = launch_fold<T, float>(attn, w, a, b, c, cp, stream);
    else err = launch_fold<T, __nv_bfloat16>(attn, w, a, b, c, cp, stream);
    if (err) return err;
  }

  const int cpad = (c + 3) / 4 * 4;
  const size_t smem = (static_cast<size_t>(c) * cpad + static_cast<size_t>(cpad) * kApplyTile) *
                      sizeof(float);
  err = set_smem(reinterpret_cast<const void*>(apply_kernel<T>), smem);
  if (err) return err;
  dim3 grid(static_cast<unsigned int>((n + kApplyTile - 1) / kApplyTile),
            static_cast<unsigned int>(b));
  apply_kernel<T><<<grid, kAttnThreads, smem, stream>>>(a, v, out, c, cpad, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace hvi_cidnet

using namespace hvi_cidnet;

// q, k, v, out: (b, c, n) contiguous, one type; temp: `heads` fp32 values;
// w: the (c, c) project_out weight (fp32 or bf16, w_dtype) or null.
// Scratch, fp32, allocated by the caller: part (b, splits, c*cp + 2c);
// attn (b, c, cp), used only with w; a (b, c, c). The splits cover n in
// steps of `chunk` (a multiple of 32). Returns the first CUDA error.
extern "C" int attention_forward(const void* q, const void* k, const void* v, void* out, int dtype,
                                 const void* temp, const void* w, int w_dtype, void* part,
                                 void* attn, void* a, int64_t b, int c, int heads, int64_t n,
                                 int splits, int64_t chunk, int normalize, cudaStream_t stream) {
  if (b < 1 || c < 1 || c > kMaxChannels || heads < 1 || c % heads || n < 1 || splits < 1 ||
      chunk % kScoreTile || (splits - 1) * chunk >= n || splits * chunk < n || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (w != nullptr && w_dtype != kFloat32 && w_dtype != kBFloat16)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* tp = static_cast<const float*>(temp);
  float* pp = static_cast<float*>(part);
  float* ap = static_cast<float*>(attn);
  float* aa = static_cast<float*>(a);
  if (dtype == kFloat32)
    return launch_attention<float>(q, k, v, out, tp, w, w_dtype, pp, ap, aa, b, c, heads, n,
                                   splits, chunk, normalize, stream);
  if (dtype == kBFloat16)
    return launch_attention<__nv_bfloat16>(q, k, v, out, tp, w, w_dtype, pp, ap, aa, b, c, heads,
                                           n, splits, chunk, normalize, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
