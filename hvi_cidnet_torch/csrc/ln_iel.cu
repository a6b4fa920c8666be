// P2/P3: LayerNorm + IEL (+ residual) in one kernel, on NCHW activations:
//
//   t = LN(x)  (channel LayerNorm, biased variance, eps inside the rsqrt)
//   h1, h2 = dw(pi(t)) split in halves  (1x1 to 2 * hidden, depthwise 3x3)
//   out = po((tanh(dw1(h1)) + h1) * (tanh(dw2(h2)) + h2)) [+ x]
//
// Replaces the Pallas kernels experiments/iel_fused_pallas.py:75 `kernel`
// (via fused_iel, call :186) and experiments/iel_pallas_nhcw.py:104
// `_kernel` (via _pallas_ln_iel, call :209): two layouts of one function.
// The plain version is ln_iel in hvi_cidnet_torch/ops/ln_iel.py (dispatcher
// and launch plan in ops/ln_iel_cuda.py); like it, the kernel reads x and
// the weights in the activation dtype and computes in fp32 throughout,
// rounding once at the store.
//
// Bound: operations. Per output pixel the two 1x1 products alone take
// 2 * (2 * hidden * C + hidden * C) flops (~20,500 at C = 36, hidden = 95)
// against 2 * C values read and written; on the fp32 CUDA cores that is
// ~140x past the card's balance point. What the fusion removes is the
// unfused chain's traffic: its 2 * hidden-channel intermediates (pi, dw,
// the gates, the product) never reach device memory.
//
// The products accumulate with explicit fmaf (the library builds with
// --fmad=false, which leaves a * b + c unfused): the sums are taken in
// another order than the plain version's anyway, and an fma rounds once.
//
// Design (simple and right first; a tensor-core version is later work):
//   - one block of 512 threads (256 ran ~1.3x slower on an NVIDIA H100
//     80GB HBM3 at 700 W: one block an SM, for its shared memory, then
//     held too few warps; PERF.md, section 6) takes a
//     TH x 16 output tile of one image (TH = 8, 4 or 2,
//     the tallest whose shared memory fits: the host's plan);
//   - it stages x over the tile and a 2-pixel ring in shared memory, fp32,
//     and normalises it in place, one thread a pixel, with K6's fp32
//     two-pass statistics (csrc/norm.cu); the ring outside the image is 0;
//   - it walks the hidden channels in chunks of 16 of each half:
//       the 1x1 expansion over the (TH+4) x 20 region (8 rows a thread,
//       weights read as float4 broadcasts),
//       the first depthwise conv over the (TH+2) x 18 region, re-masked to
//       0 outside the image: SAME zero padding applies to the
//       intermediates, so pi(LN(x)) is 0 there and so is dw(pi(LN(x)))
//       where the gate's depthwise conv reads it,
//       the gate's depthwise conv with tanh and the add over the tile, the
//       product of the halves,
//       the project_out contribution, added to a C x TH x 16 fp32
//       accumulator in shared memory;
//     channels past hidden (the widths 95/191/383 are odd) have zero
//     weights, so they add nothing;
//   - then it adds the residual and writes the tile.
#include "common.cuh"

namespace hvi_cidnet {
namespace {

constexpr int kLnIelThreads = 512;
constexpr int kChunk = 16;          // hidden channels of each half per chunk
constexpr int kTileW = 16;          // output tile width
constexpr int kRows = 8;            // expansion rows a thread computes per item
constexpr int kRing2W = kTileW + 4;  // width of the 2-pixel-ring region
constexpr int kRing1W = kTileW + 2;  // width of the 1-pixel-ring region

// floats of the block's shared memory; the layout below, in this order:
//   xs [C][P2], acc [C][P0], wt [C][2 * kChunk], wpo [C][kChunk],
//   wdw [2 * kChunk][9], wg [2 * kChunk][9], pi [2 * kChunk][P2] (the
//   product [kChunk][P0] reuses it), t1 [2 * kChunk][P1]
__host__ __device__ inline int ln_iel_smem_floats(int c, int th) {
  const int p2 = (th + 4) * kRing2W, p1 = (th + 2) * kRing1W, p0 = th * kTileW;
  return c * (p2 + p0 + 3 * kChunk) + 2 * 2 * kChunk * 9 + 2 * kChunk * (p2 + p1);
}

template <typename T>
__global__ void __launch_bounds__(kLnIelThreads)
ln_iel_kernel(const T* __restrict__ x, T* __restrict__ out, const float* __restrict__ ln_w,
              const float* __restrict__ ln_b, const T* __restrict__ w_pi,
              const T* __restrict__ w_dw, const T* __restrict__ w_dw1,
              const T* __restrict__ w_dw2, const T* __restrict__ w_po, int c, int hid, int h,
              int w, int th, int tiles_x, int tiles_y, float eps, int residual) {
  extern __shared__ __align__(16) float sm[];
  const int p2 = (th + 4) * kRing2W, p1 = (th + 2) * kRing1W, p0 = th * kTileW;
  float* xs = sm;
  float* acc = xs + c * p2;
  float* wt = acc + c * p0;
  float* wpo = wt + c * 2 * kChunk;
  float* wdw = wpo + c * kChunk;
  float* wg = wdw + 2 * kChunk * 9;
  float* pi = wg + 2 * kChunk * 9;
  float* t1 = pi + 2 * kChunk * p2;
  float* prod = pi;

  const int tid = threadIdx.x;
  int blk = blockIdx.x;
  const int tx = blk % tiles_x;
  blk /= tiles_x;
  const int ty = blk % tiles_y;
  const int b = blk / tiles_y;
  const int y0 = ty * th, x0 = tx * kTileW;
  const int64_t plane = static_cast<int64_t>(h) * w;
  const T* xb = x + static_cast<int64_t>(b) * c * plane;
  T* ob = out + static_cast<int64_t>(b) * c * plane;

  // x over the tile and its 2-pixel ring, 0 outside the image
  for (int i = tid; i < c * p2; i += kLnIelThreads) {
    const int ch = i / p2, p = i - ch * p2;
    const int gy = y0 - 2 + p / kRing2W, gx = x0 - 2 + p % kRing2W;
    float v = 0.0f;
    if (gy >= 0 && gy < h && gx >= 0 && gx < w)
      v = load_f32(xb, ch * plane + static_cast<int64_t>(gy) * w + gx);
    xs[i] = v;
  }
  for (int i = tid; i < c * p0; i += kLnIelThreads) acc[i] = 0.0f;
  __syncthreads();

  // LayerNorm in place, one thread a pixel: u = mean(x), s = mean((x-u)^2),
  // w * ((x - u) * rsqrt(s + eps)) + b; 0 outside the image
  for (int p = tid; p < p2; p += kLnIelThreads) {
    const int gy = y0 - 2 + p / kRing2W, gx = x0 - 2 + p % kRing2W;
    const bool inside = gy >= 0 && gy < h && gx >= 0 && gx < w;
    float s = 0.0f;
    for (int ch = 0; ch < c; ++ch) s += xs[ch * p2 + p];
    const float u = s / c;
    float ss = 0.0f;
    for (int ch = 0; ch < c; ++ch) {
      const float d = xs[ch * p2 + p] - u;
      ss += d * d;
    }
    const float r = rsqrtf(ss / c + eps);
    for (int ch = 0; ch < c; ++ch) {
      const float d = xs[ch * p2 + p] - u;
      xs[ch * p2 + p] = inside ? ln_w[ch] * (d * r) + ln_b[ch] : 0.0f;
    }
  }

  for (int j0 = 0; j0 < hid; j0 += kChunk) {
    __syncthreads();  // the last chunk's readers are done (and, first, the LN)
    // the chunk's weights, fp32; row k < kChunk is hidden channel j0 + k of
    // the dwconv1 half, row kChunk + k the same channel of the dwconv2 half
    for (int i = tid; i < c * 2 * kChunk; i += kLnIelThreads) {
      const int ch = i / (2 * kChunk), k = i - ch * 2 * kChunk;
      const int j = j0 + k % kChunk;
      const int row = k < kChunk ? j : hid + j;
      wt[i] = j < hid ? load_f32(w_pi, static_cast<int64_t>(row) * c + ch) : 0.0f;
    }
    for (int i = tid; i < c * kChunk; i += kLnIelThreads) {
      const int ch = i / kChunk, j = j0 + i % kChunk;
      wpo[i] = j < hid ? load_f32(w_po, static_cast<int64_t>(ch) * hid + j) : 0.0f;
    }
    for (int i = tid; i < 2 * kChunk * 9; i += kLnIelThreads) {
      const int k = i / 9, tap = i - k * 9;
      const int j = j0 + k % kChunk;
      float a = 0.0f, g = 0.0f;
      if (j < hid) {
        a = load_f32(w_dw, static_cast<int64_t>(k < kChunk ? j : hid + j) * 9 + tap);
        g = load_f32(k < kChunk ? w_dw1 : w_dw2, static_cast<int64_t>(j) * 9 + tap);
      }
      wdw[i] = a;
      wg[i] = g;
    }
    __syncthreads();

    // 1x1 expansion over the 2-ring region: pi[k][p] = sum_ch wt[ch][k] * xs[ch][p]
    for (int i = tid; i < (2 * kChunk / kRows) * p2; i += kLnIelThreads) {
      const int grp = i / p2, p = i - grp * p2;
      float a[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) a[r] = 0.0f;
      const float* wr = wt + grp * kRows;
      for (int ch = 0; ch < c; ++ch) {
        const float v = xs[ch * p2 + p];
        const float4 lo = *reinterpret_cast<const float4*>(wr + ch * 2 * kChunk);
        const float4 hi = *reinterpret_cast<const float4*>(wr + ch * 2 * kChunk + 4);
        a[0] = fmaf(lo.x, v, a[0]);
        a[1] = fmaf(lo.y, v, a[1]);
        a[2] = fmaf(lo.z, v, a[2]);
        a[3] = fmaf(lo.w, v, a[3]);
        a[4] = fmaf(hi.x, v, a[4]);
        a[5] = fmaf(hi.y, v, a[5]);
        a[6] = fmaf(hi.z, v, a[6]);
        a[7] = fmaf(hi.w, v, a[7]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) pi[(grp * kRows + r) * p2 + p] = a[r];
    }
    __syncthreads();

    // first depthwise conv over the 1-ring region, 0 outside the image
    for (int i = tid; i < 2 * kChunk * p1; i += kLnIelThreads) {
      const int k = i / p1, p = i - k * p1;
      const int ry = p / kRing1W, rx = p - ry * kRing1W;
      const int gy = y0 - 1 + ry, gx = x0 - 1 + rx;
      float s = 0.0f;
      if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
        const float* src = pi + k * p2 + ry * kRing2W + rx;  // the window's top left
        const float* wk = wdw + k * 9;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap)
          s = fmaf(wk[tap], src[(tap / 3) * kRing2W + tap % 3], s);
      }
      t1[i] = s;
    }
    __syncthreads();

    // the gates and their product over the tile (into pi's storage)
    for (int i = tid; i < kChunk * p0; i += kLnIelThreads) {
      const int j = i / p0, p = i - j * p0;
      const int ry = p / kTileW, rx = p - ry * kTileW;
      const float* s1 = t1 + j * p1 + ry * kRing1W + rx;
      const float* s2 = s1 + kChunk * p1;
      const float* g1w = wg + j * 9;
      const float* g2w = wg + (kChunk + j) * 9;
      float a1 = 0.0f, a2 = 0.0f;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int o = (tap / 3) * kRing1W + tap % 3;
        a1 = fmaf(g1w[tap], s1[o], a1);
        a2 = fmaf(g2w[tap], s2[o], a2);
      }
      const float g1 = tanhf(a1) + s1[kRing1W + 1];
      const float g2 = tanhf(a2) + s2[kRing1W + 1];
      prod[i] = g1 * g2;
    }
    __syncthreads();

    // project_out: acc[ch][p] += sum_j wpo[ch][j] * prod[j][p]; a thread
    // keeps one pixel (p0 divides the block) and walks channels
    {
      const int p = tid % p0;
      float pr[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) pr[j] = prod[j * p0 + p];
      for (int ch = tid / p0; ch < c; ch += kLnIelThreads / p0) {
        float a = acc[ch * p0 + p];
        const float4* wr = reinterpret_cast<const float4*>(wpo + ch * kChunk);
#pragma unroll
        for (int j = 0; j < kChunk / 4; ++j) {
          const float4 wv = wr[j];
          a = fmaf(wv.x, pr[4 * j], a);
          a = fmaf(wv.y, pr[4 * j + 1], a);
          a = fmaf(wv.z, pr[4 * j + 2], a);
          a = fmaf(wv.w, pr[4 * j + 3], a);
        }
        acc[ch * p0 + p] = a;
      }
    }
  }
  __syncthreads();

  for (int i = tid; i < c * p0; i += kLnIelThreads) {
    const int ch = i / p0, p = i - ch * p0;
    const int gy = y0 + p / kTileW, gx = x0 + p % kTileW;
    if (gy < h && gx < w) {
      const int64_t off = ch * plane + static_cast<int64_t>(gy) * w + gx;
      float v = acc[i];
      if (residual) v = v + load_f32(xb, off);
      ob[off] = from_f32<T>(v);
    }
  }
}

template <typename T>
int launch_ln_iel(const void* x, void* out, const void* ln_w, const void* ln_b, const void* w_pi,
                  const void* w_dw, const void* w_dw1, const void* w_dw2, const void* w_po, int b,
                  int c, int hid, int h, int w, int th, int tiles_x, int tiles_y, int residual,
                  float eps, int smem, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      ln_iel_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = static_cast<int64_t>(b) * tiles_y * tiles_x;
  ln_iel_kernel<T><<<static_cast<unsigned int>(blocks), kLnIelThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<const float*>(ln_w),
      static_cast<const float*>(ln_b), static_cast<const T*>(w_pi), static_cast<const T*>(w_dw),
      static_cast<const T*>(w_dw1), static_cast<const T*>(w_dw2), static_cast<const T*>(w_po), c,
      hid, h, w, th, tiles_x, tiles_y, eps, residual);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace hvi_cidnet

using namespace hvi_cidnet;

// x, out: (b, c, h, w) contiguous; ln_w, ln_b: c fp32 values; w_pi (2 *
// hid, c), w_dw (2 * hid, 9), w_dw1 and w_dw2 (hid, 9), w_po (c, hid), in
// x's dtype. th .. smem: the plan of ops/ln_iel_cuda.py:ln_iel_plan (tile
// height, tiles across and down, shared memory in bytes). Returns a
// cudaError_t code, cudaErrorInvalidValue for a plan it cannot run.
extern "C" int ln_iel(const void* x, void* out, int dtype, const void* ln_w, const void* ln_b,
                      const void* w_pi, const void* w_dw, const void* w_dw1, const void* w_dw2,
                      const void* w_po, int b, int c, int hid, int h, int w, int th, int tiles_x,
                      int tiles_y, int residual, float eps, int smem, cudaStream_t stream) {
  if (b < 1 || c < 1 || hid < 1 || h < 1 || w < 1 || (th != 8 && th != 4 && th != 2) ||
      tiles_x != (w + kTileW - 1) / kTileW || tiles_y != (h + th - 1) / th ||
      smem != 4 * ln_iel_smem_floats(c, th) || smem > 232448 ||
      static_cast<int64_t>(b) * tiles_y * tiles_x > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kFloat32)
    return launch_ln_iel<float>(x, out, ln_w, ln_b, w_pi, w_dw, w_dw1, w_dw2, w_po, b, c, hid, h,
                                w, th, tiles_x, tiles_y, residual, eps, smem, stream);
  if (dtype == kBFloat16)
    return launch_ln_iel<__nv_bfloat16>(x, out, ln_w, ln_b, w_pi, w_dw, w_dw1, w_dw2, w_po, b, c,
                                        hid, h, w, th, tiles_x, tiles_y, residual, eps, smem,
                                        stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
