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
// byte. On the CUDA cores (the first design's 3 x 3 register tiles, ~2.7
// instructions a multiply-add) that was above what they issue, and P1 ran
// at 4.4x its bytes; the tensor cores take it far below their ridge. What
// holds the bf16 arm back on the card now is each block's stream: a block
// moves ~10 GB/s whatever its ring's depth, so the time goes with the
// columns a block walks (PERF.md, PR 19's phases).
//
// Design: one launch, one thread-block cluster of S blocks per g (the
// plan's `splits`; fp32 at most 8; bf16 up to 16, as many as keep every
// cluster in one wave of the card's: 12 at level 1, batch 8).
// Block s takes columns [s * chunk, (s + 1) * chunk):
// 1. its partial scores and norms by the score core (qk_scores.cuh);
// 2. the cluster's sums through distributed shared memory, rank 0 first,
//    so every block holds the same bits of S and the norms;
// 3. the c x c softmax;
// 4. A applied to its own columns of v, the output written once.
//
// bf16 (head_attention_mma_kernel): the tensor-core score core (a ring of
// 512-column stages filled by bulk copies or cp.async, mma.sync from
// ldmatrix fragments; qk_scores.cuh). v's first
// stages are issued into the ring as soon as the scores are summed, so they
// fly during the block's and the cluster's sums and the softmax (a warp a
// row, fp32, shuffles in a fixed butterfly). A, rounded to bf16, is built
// once into each warp's m16 x k16 fragments (rows and columns zero past c)
// and kept in registers; v streams through the ring (twice the stages: half
// a stage's bytes a step); out = A v by mma.sync, v's k16 x n8 fragments
// through ldmatrix.trans, fp32 accumulators rounded once to bf16 into a
// staged output tile, which leaves by one bulk store a row where every row
// starts 16-byte aligned (two tiles in turns), else with each row at its
// 16-byte shift in 16-byte stores (the rows' ragged ends element by
// element).
// fp32 (head_attention_kernel): the CUDA-core score core; the softmax one
// thread a row, A kept transposed in shared memory, rows padded to CM
// (c_max: 8, 20 or 32); each thread applies A to one or two adjacent
// columns (two where the score core's loads are wider than one element),
// the c values of v in registers, A read as float4 broadcasts (four FMAs a
// load). Two blocks an SM (at most 128 registers a thread).
#include "qk_scores.cuh"

namespace hvi_cidnet {
namespace {

using qk::kThreads;
using bf16 = __nv_bfloat16;

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
  qk::cluster_sum<qk::kMaxCluster>(red, 0, e_count, [&](int e, float s) { tot[e] = s; });

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

// waits until at most one of this thread's bulk stores still reads shared memory
__device__ __forceinline__ void bulk_wait_read_but_one() {
  asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// NT: k's 8-row tiles, ceil(c / 8); MT = ceil(NT / 2) 16-row tiles of q, of
// out and of v's k16 steps
template <int NT>
__global__ void __launch_bounds__(kThreads, 2)
    head_attention_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, bf16* __restrict__ out,
                              const float* __restrict__ temps, int heads, int c, int64_t n,
                              int64_t chunk, int stages, int direct) {
  constexpr int MT = (NT + 1) / 2;
  constexpr int kTileCols = qk::kMmaTile, kPitch = qk::kMmaPitch;
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t g = blockIdx.y;
  const int64_t col0 = blockIdx.x * chunk;
  const int64_t col_end = min64(n, col0 + chunk);
  const int64_t total = static_cast<int64_t>(gridDim.y) * c * n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const qk::MmaSmem sm(smem, c, true, stages, g, n);

  const int as = qk::apply_stages(stages);
  const int steps = static_cast<int>((col_end - col0 + kTileCols - 1) / kTileCols);
  const RowStream vs{v, total, sm.rowbase, c, kTileCols,
                     static_cast<int>((reinterpret_cast<uintptr_t>(v) & 15) >> 1)};
  auto issue_v = [&](int step) {
    if (step < steps) {
      const int slot = step % as;
      bf16* st = sm.ring + slot * c * kPitch;
      const int64_t n0 = col0 + static_cast<int64_t>(step) * kTileCols;
      const int64_t stop = min64(col_end, n0 + kTileCols);
      if (direct)  // columns past stop: stale, but each output column reads only its own
        qk::bulk_stage(st, v, nullptr, c, sm.rowbase, n0, stop, sm.bars + qk::kMaxStages + slot);
      else
        vs.issue(st, n0, stop, false);
    }
    if (!direct) cp_async_commit();
  };
  // 1. the block's sums; v's first stages issued once the ring is free
  float* red = qk::mma_block_scores<NT, true>(q, k, c, total, col0, col_end, stages, direct != 0,
                                              sm, [&] {
                                                for (int s = 0; s < as - 1; ++s) issue_v(s);
                                              });
  // 2. the cluster's
  const int e_count = qk::entries(c, true);
  float* tot = red + e_count;
  float* at = tot + e_count;  // A[i][j] at i * c + j, rounded to bf16
  qk::cluster_sum<qk::kMmaMaxCluster>(red, 0, e_count, [&](int e, float s) { tot[e] = s; });

  // 3. the softmax, a warp a row, lane j its column j
  const float t = temps[g % heads];
  for (int r = warp; r < c; r += qk::kWarps) {
    float s = __int_as_float(0xff800000);  // -inf
    if (lane < c)
      s = ((tot[r * c + lane] * rsqrtf(fmaxf(tot[c * c + r], 1e-24f))) *
           rsqrtf(fmaxf(tot[c * c + c + lane], 1e-24f))) * t;
    float m = s;
#pragma unroll
    for (int o = 16; o; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float ex = lane < c ? expf(s - m) : 0.0f;
    float sum = ex;  // every lane ends with the same bits: each stage adds one pair both ways
#pragma unroll
    for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane < c) at[r * c + lane] = round_through<bf16>(ex / sum);
  }
  __syncthreads();
  // A's fragments for the whole apply: a[mi][ks] the m16 x k16 tile (rows
  // 16 mi .., columns 16 ks ..); registers 0-3: (g8, 2 t4), (g8 + 8, 2 t4),
  // (g8, 2 t4 + 8), (g8 + 8, 2 t4 + 8) and the next column
  uint32_t af[MT][MT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ks = 0; ks < MT; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 16 * mi + g8 + 8 * (e & 1), j = 16 * ks + 2 * t4 + 8 * (e >> 1);
        af[mi][ks][e] = pack_bf16(i < c && j < c ? at[i * c + j] : 0.0f,
                                  i < c && j + 1 < c ? at[i * c + j + 1] : 0.0f);
      }
  __syncthreads();  // the aux area is the realigned v and the output tile from here

  // 4. out = A v over the block's columns, through the ring. The output
  // tile: direct, two in turns, each row leaving by a bulk store (lane r of
  // warp 0 row r); else after the realigned v, leaving by 16-byte stores.
  bf16* va = sm.aux;
  const int mis_out = static_cast<int>((reinterpret_cast<uintptr_t>(out) & 15) >> 1);
  int voff[MT];  // this lane's ldmatrix.trans row: v row 16 ks + lane % 8 + 8 (lane / 8 % 2)
#pragma unroll
  for (int ks = 0; ks < MT; ++ks) {
    const int r = 16 * ks + (lane & 7) + ((lane >> 3) & 1) * 8;
    voff[ks] = r < c ? r * kPitch + (lane >> 4) * 8 : -1;
  }
  for (int s = 0; s < steps; ++s) {
    bf16* os = sm.aux + (direct ? s & 1 : 1) * c * kPitch;
    if (direct) {  // step s has landed; this lane's store of step s - 2 has read its tile
      mbar_wait(sm.bars + qk::kMaxStages + s % as, (s / as) & 1);
      if (threadIdx.x < c) bulk_wait_read_but_one();
    } else {
      cp_async_wait_dyn(as - 2);
    }
    __syncthreads();  // step s - 1's stage and this step's output tile are free
    issue_v(s + as - 1);
    const int64_t n0 = col0 + static_cast<int64_t>(s) * kTileCols;
    const int width = static_cast<int>(min64(kTileCols, col_end - n0));
    const bf16* tv = sm.ring + (s % as) * c * kPitch;
    if (!direct) {
      vs.realign(tv, va, width);
      __syncthreads();
      tv = va;
    }
    for (int wc = 32 * warp; wc < width; wc += 32 * qk::kWarps) {  // this warp's 32 columns
      float acc[MT][4][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int e = 0; e < 16; ++e) acc[mi][e >> 2][e & 3] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < MT; ++ks) {
        uint32_t bv[4][2];  // n8 tiles of columns wc + 8 t: rows 16 ks .. + 7, then + 8 .. + 15
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          uint32_t r4[4];
          ldmatrix_x4_trans(r4, qk::frag_row(tv, voff[ks], wc + 16 * p, sm.zero));
          bv[2 * p][0] = r4[0];
          bv[2 * p][1] = r4[1];
          bv[2 * p + 1][0] = r4[2];
          bv[2 * p + 1][1] = r4[3];
        }
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int tt = 0; tt < 4; ++tt) mma_bf16(acc[mi][tt], af[mi][ks], bv[tt][0], bv[tt][1]);
      }
      // into the output tile, row i at its shift (the output's 16-byte grid)
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 16 * mi + g8 + 8 * h;
          if (i >= c) continue;
          const int sh = direct ? 0 : static_cast<int>((sm.rowbase[i] + mis_out) & 7);
          bf16* d = os + i * kPitch + sh + wc + 2 * t4;
#pragma unroll
          for (int tt = 0; tt < 4; ++tt) {
            const float lo = acc[mi][tt][2 * h], hi = acc[mi][tt][2 * h + 1];
            if (sh & 1) {
              d[8 * tt] = __float2bfloat16_rn(lo);
              d[8 * tt + 1] = __float2bfloat16_rn(hi);
            } else {
              *reinterpret_cast<__nv_bfloat162*>(d + 8 * tt) = __floats2bfloat162_rn(lo, hi);
            }
          }
        }
    }
    if (direct) {
      fence_proxy_async();  // the tile's writes before the copy engine reads them
      __syncthreads();      // the output tile is complete
      if (threadIdx.x < c) {
        bulk_store(out + sm.rowbase[threadIdx.x] + n0, os + threadIdx.x * kPitch, 2u * width);
        bulk_commit();
      }
      continue;
    }
    __syncthreads();  // the output tile is complete
    // chunk ch of row r's tile is the output's 16-byte chunk at columns
    // [8 ch - shift, 8 ch - shift + 8); its ends, partly outside the step,
    // go element by element
    constexpr int kChunks = kPitch / 8;
    for (int idx = threadIdx.x; idx < c * kChunks; idx += kThreads) {
      const int r = idx / kChunks, ch = idx - r * kChunks;
      const int sh = direct ? 0 : static_cast<int>((sm.rowbase[r] + mis_out) & 7);
      const int lo = max(0, sh - 8 * ch), hi = min(8, sh + width - 8 * ch);
      if (lo >= hi) continue;
      const int64_t e = sm.rowbase[r] + n0 - sh + 8 * ch;
      const bf16* src = os + r * kPitch + 8 * ch;
      if (lo == 0 && hi == 8) {
        *reinterpret_cast<uint4*>(out + e) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int j = lo; j < hi; ++j) out[e + j] = src[j];
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block
  if (direct && threadIdx.x < c) bulk_wait_all();
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

template <int CM>
int launch_vec(int vec, const void* q, const void* k, const void* v, void* out,
               const void* temps, int heads, int64_t g, int c, int64_t n, int splits,
               int64_t chunk, int64_t smem, cudaStream_t stream) {
  if (vec == 4)
    return launch<float, CM, 4>(q, k, v, out, temps, heads, g, c, n, splits, chunk, smem, stream);
  if (vec == 2)
    return launch<float, CM, 2>(q, k, v, out, temps, heads, g, c, n, splits, chunk, smem, stream);
  return launch<float, CM, 1>(q, k, v, out, temps, heads, g, c, n, splits, chunk, smem, stream);
}

int launch_f32(int vec, const void* q, const void* k, const void* v, void* out, const void* temps,
               int heads, int64_t g, int c, int64_t n, int splits, int64_t chunk, int64_t smem,
               cudaStream_t stream) {
  const int cm = qk::c_max(c);
  if (cm == 8)
    return launch_vec<8>(vec, q, k, v, out, temps, heads, g, c, n, splits, chunk, smem, stream);
  if (cm == 20)
    return launch_vec<20>(vec, q, k, v, out, temps, heads, g, c, n, splits, chunk, smem, stream);
  return launch_vec<32>(vec, q, k, v, out, temps, heads, g, c, n, splits, chunk, smem, stream);
}

template <int NT>
int launch_mma(const void* q, const void* k, const void* v, void* out, const void* temps,
               int heads, int64_t g, int c, int64_t n, int splits, int64_t chunk, int stages,
               int direct, int64_t smem, cudaStream_t stream) {
  return qk::launch_cluster(head_attention_mma_kernel<NT>, splits, static_cast<unsigned int>(g),
                            smem, stream, static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                            static_cast<const bf16*>(v), static_cast<bf16*>(out),
                            static_cast<const float*>(temps), heads, c, n, chunk, stages, direct);
}

int launch_bf16(const void* q, const void* k, const void* v, void* out, const void* temps,
                int heads, int64_t g, int c, int64_t n, int splits, int64_t chunk, int stages,
                int direct, int64_t smem, cudaStream_t stream) {
  switch ((c + 7) / 8) {
    case 1:
      return launch_mma<1>(q, k, v, out, temps, heads, g, c, n, splits, chunk, stages, direct,
                           smem, stream);
    case 2:
      return launch_mma<2>(q, k, v, out, temps, heads, g, c, n, splits, chunk, stages, direct,
                           smem, stream);
    case 3:
      return launch_mma<3>(q, k, v, out, temps, heads, g, c, n, splits, chunk, stages, direct,
                           smem, stream);
    default:
      return launch_mma<4>(q, k, v, out, temps, heads, g, c, n, splits, chunk, stages, direct,
                           smem, stream);
  }
}

}  // namespace
}  // namespace hvi_cidnet

using namespace hvi_cidnet;

// q, k, v, out: (g, c, n) contiguous, one type (dtype); temps: `heads` fp32
// values on the device, row i of q taking temps[i % heads]. splits, chunk,
// vec, stages, smem: the plan of ops/head_attention_cuda.py:
// head_attention_plan (blocks a cluster, columns a block; fp32: elements a
// load, stages 0; bf16: vec 8 direct or 1 realigned, stages of the scores'
// ring; dynamic shared memory in bytes). Returns a cudaError_t code,
// cudaErrorInvalidValue for a plan it cannot run.
extern "C" int head_attention(const void* q, const void* k, const void* v, void* out, int dtype,
                              const void* temps, int heads, int64_t g, int c, int64_t n,
                              int splits, int64_t chunk, int vec, int stages, int64_t smem,
                              cudaStream_t stream) {
  const bool f32 = dtype == kFloat32;
  const int max_cluster = f32 ? qk::kMaxCluster : qk::kMmaMaxCluster;
  if ((!f32 && dtype != kBFloat16) || c < 1 || c > qk::kMaxC || g < 1 || g > 65535 ||
      heads < 1 || g % heads || !qk::split_ok(n, splits, chunk, max_cluster) || smem > 232448 ||
      (f32 ? stages != 0 || !qk::vec_ok(vec, 4, n, {q, k, v, out}) || smem != smem_bytes(c, 4)
           : !qk::mma_ok(chunk, stages, vec, n, {q, k, v, out}) ||
                 smem != qk::mma_bytes(c, true, stages)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (f32)
    return launch_f32(vec, q, k, v, out, temps, heads, g, c, n, splits, chunk, smem, stream);
  return launch_bf16(q, k, v, out, temps, heads, g, c, n, splits, chunk, stages, vec == 8, smem,
                     stream);
}

// The bf16 kernel's clusters of `cluster` blocks at `smem` bytes that the
// card holds at once, at c rows (ops/batched_qk_cuda.py:card_clusters), or
// minus a cudaError_t code.
extern "C" int head_attention_active_clusters(int c, int cluster, int64_t smem) {
  switch ((c + 7) / 8) {
    case 1: return qk::active_clusters(head_attention_mma_kernel<1>, cluster, smem);
    case 2: return qk::active_clusters(head_attention_mma_kernel<2>, cluster, smem);
    case 3: return qk::active_clusters(head_attention_mma_kernel<3>, cluster, smem);
    default: return qk::active_clusters(head_attention_mma_kernel<4>, cluster, smem);
  }
}
