// P2/P3: LayerNorm + IEL (+ residual) in one kernel, on NCHW activations:
//
//   t = LN(x)  (channel LayerNorm, biased variance, eps inside the rsqrt)
//   h1, h2 = dw(pi(t)) split in halves  (1x1 to 2 * hidden, depthwise 3x3)
//   out = po((tanh(dw1(h1)) + h1) * (tanh(dw2(h2)) + h2)) [+ x]
//
// Replaces the Pallas kernels experiments/iel_fused_pallas.py:75 `kernel`
// (via fused_iel, call :186) and experiments/iel_pallas_nhcw.py:104
// `_kernel` (via _pallas_ln_iel, call :209): two layouts of one function in
// fp32; in bf16 the port follows P3's rounding points. The plain version is
// ln_iel in hvi_cidnet_torch/ops/ln_iel.py (dispatcher and launch plans in
// ops/ln_iel_cuda.py); like it, the kernels read x and the weights in the
// activation dtype and compute in fp32, but for two roundings to the
// activation dtype: t before the expansion and the gates' product before
// project_out (P3, :140 and :163; the identity in fp32). They round the
// result once at the store.
//
// Two arms, by dtype (the host's plans pick).
//
// bf16, `ln_iel_mma_kernel`: both products on the tensor cores (mma.sync
// m16n8k16, bf16 operands, fp32 sums: exactly P3's products once t and the
// product are bf16). Bound: the depthwise convs, tanh and the gates on the
// fp32 CUDA cores (~36 operations a pixel and expanded channel) ahead of
// the products (2 * 3 * hidden * C a pixel at 989 TFLOP/s) and the bytes.
// Design:
//   - a block takes an 8 x TW output tile of one image: two blocks of 256
//     threads an SM and TW = 16 where their shared memory allows (C <= 48:
//     one block's barriers and serial phases then overlap the other's),
//     else one block of 512 threads, TW = 32 (C <= 72) or 16;
//   - x over the tile and a 2-pixel ring goes into a channel-minor tile
//     A[pixel][C, padded to 16], rows padded by 16 bytes (no bank
//     conflicts for ldmatrix), normalised a thread a pixel with K6's fp32
//     two-pass statistics, rounded to bf16, 0 outside the image: the
//     expansion of a zero row is 0, the SAME zero padding of pi(LN(x)).
//     Where C <= 72 (48 for 256 threads) a thread loads its pixel's
//     channels into registers (a warp's loads on neighbouring pixels) and
//     writes its normalised row; else the threads load ring rows of one
//     channel, then normalise in place;
//   - the hidden channels go in chunks of 16 of each half: the expansion
//     (M = the 32 channels, N = the ring's pixels, K = C) into fp32
//     [pixel][channel]; then a lane a channel (its taps in registers), a
//     warp a strip of rows walked along columns with a sliding register
//     window: the first depthwise conv over the 1-pixel ring, re-masked to
//     0 outside the image, and the gate's depthwise conv, tanh and the add
//     over the tile, fp32, the two halves' product met by a shuffle and
//     rounded to bf16 into [pixel][16] (no bank met twice in these phases);
//     project_out (M = the tile's pixels, N = C, K = 16), its fp32 sums in
//     registers across all the chunks;
//   - the weights are packed once a call by ln_iel_pack_kernel, chunk by
//     chunk in the layout the block reads (W_pi and W_po in bf16, both
//     depthwise convs' taps in fp32, zero past hidden and C), and each
//     chunk's arrive by cp.async during the chunk before;
//   - at the end the residual is read in the sums' own layout and added in
//     fp32, the result rounded once into shared memory (over the tiles
//     above) and written as whole row vectors of each output plane.
//
// fp32, `ln_iel_kernel` (simple and right first; TF32 would keep three
// digits): every stage on the fp32 CUDA cores.
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
//
// The products accumulate with explicit fmaf (the library builds with
// --fmad=false, which leaves a * b + c unfused): the sums are taken in
// another order than the plain version's anyway, and an fma rounds once.
#include "common.cuh"
#include "mma.cuh"

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
  const int err = raise_smem_cap(reinterpret_cast<const void*>(ln_iel_kernel<T>), smem);
  if (err) return err;
  const int64_t blocks = static_cast<int64_t>(b) * tiles_y * tiles_x;
  ln_iel_kernel<T><<<static_cast<unsigned int>(blocks), kLnIelThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<const float*>(ln_w),
      static_cast<const float*>(ln_b), static_cast<const T*>(w_pi), static_cast<const T*>(w_dw),
      static_cast<const T*>(w_dw1), static_cast<const T*>(w_dw2), static_cast<const T*>(w_po), c,
      hid, h, w, th, tiles_x, tiles_y, eps, residual);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core arm
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kMTileH = 8;          // output rows a tile
constexpr int kHalf = 16;           // hidden channels of each half a chunk: project_out's k16
constexpr int kExp = 2 * kHalf;     // expanded channels a chunk
constexpr int kPrPitch = kHalf + 8;  // bf16 a pixel of the product tile: 48-byte rows
constexpr int kMaxNtw = 9;          // project_out's n8 tiles a warp
constexpr int kTapPitch = 12;       // fp32 a channel's 9 taps, padded: three 16-byte loads
constexpr int kPiPitch = 36;        // fp32 a pixel of the expansion: 4 mod 32 banks

// The geometry of a 8 x TW tile for THREADS threads: the 2-pixel ring's
// region (P2 pixels, RW2 wide), the 1-pixel ring's (P1, RW1), the tile's
// (P0) and the epilogue's bf16 pitch (OP, 4 mod 32 banks: the fragments'
// stores meet no bank twice); warps, m16 tiles of the tile (MT0) and
// project_out's warps an m16 tile (NH)
template <int TW, int THREADS>
struct LiGeom {
  static constexpr int WARPS = THREADS / 32;
  static constexpr int RW2 = TW + 4, P2 = (kMTileH + 4) * RW2;
  static constexpr int RW1 = TW + 2, P1 = (kMTileH + 2) * RW1;
  static constexpr int P0 = kMTileH * TW, OP = P0 + 8;
  static constexpr int MT0 = P0 / 16, NH = WARPS / MT0;
  // C up to which the LayerNorm holds a pixel's channels in registers: the
  // arms' widest C, 48 (256 threads) and 72 (8 x 32); the arm for C > 72
  // stages x in shared memory
  static constexpr int REG_C = THREADS == 256 ? 48 : TW == 32 ? 72 : 0;
  static_assert(P2 % 8 == 0 && P0 % 16 == 0 && WARPS % MT0 == 0, "whole mma tiles");
  static_assert(WARPS % 2 == 0 && OP / 2 % 32 == 4, "two row strips; bank-free stores");
};

// bytes of one chunk's packed weights: W_pi [kExp][cp + 8] and W_po
// [npad][kPrPitch] in bf16, the depthwise taps [kExp][kTapPitch] and the
// gate's in fp32
__host__ __device__ inline int li_chunk_bytes(int cp, int npad) {
  return 2 * kExp * (cp + 8) + 2 * npad * kPrPitch + 2 * 4 * kExp * kTapPitch;
}
// dynamic shared memory of ln_iel_mma_kernel<tw>: A, the expansion, the first
// depthwise conv, the product and two chunks of weights
__host__ __device__ inline int li_smem_bytes(int tw, int cp, int npad) {
  const int p2 = (kMTileH + 4) * (tw + 4), p1 = (kMTileH + 2) * (tw + 2), p0 = kMTileH * tw;
  return 2 * p2 * (cp + 8) + 4 * (p2 * kPiPitch + p1 * kExp) + 2 * p0 * kPrPitch +
         2 * li_chunk_bytes(cp, npad);
}

// The weights, once a call, chunk k after chunk k - 1 (li_chunk_bytes each):
// W_pi row n < kExp is hidden channel j = 16 k + n % 16 of half n / 16 (row
// half * hid + j of w_pi), columns past C zero; W_po row n < npad holds
// w_po[n][16 k + e] for e < 16, zero past C, hidden and e; the taps of w_dw
// row half * hid + j and of w_dw1 / w_dw2 row j, widened to fp32; zero past
// hidden.
__global__ void ln_iel_pack_kernel(const bf16* __restrict__ w_pi, const bf16* __restrict__ w_dw,
                                   const bf16* __restrict__ w_dw1,
                                   const bf16* __restrict__ w_dw2,
                                   const bf16* __restrict__ w_po, unsigned char* __restrict__ wp,
                                   int c, int hid, int cp, int npad, int chunks) {
  const int ap = cp + 8;
  const int n_pi = kExp * ap, n_po = npad * kPrPitch, n_tap = kExp * kTapPitch;
  const int per = n_pi + n_po + 2 * n_tap;  // slots a chunk
  const int cw = li_chunk_bytes(cp, npad);
  const int64_t total = static_cast<int64_t>(chunks) * per;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int k = static_cast<int>(i / per), q = static_cast<int>(i % per);
    unsigned char* base = wp + static_cast<int64_t>(k) * cw;
    if (q < n_pi) {
      const int n = q / ap, e = q % ap, j = kHalf * k + n % kHalf;
      const bool ok = j < hid && e < c;
      reinterpret_cast<bf16*>(base)[q] =
          ok ? w_pi[static_cast<int64_t>((n / kHalf) * hid + j) * c + e] : __float2bfloat16_rn(0.0f);
    } else if (q < n_pi + n_po) {
      const int r = q - n_pi, n = r / kPrPitch, e = r % kPrPitch, j = kHalf * k + e;
      const bool ok = n < c && e < kHalf && j < hid;
      reinterpret_cast<bf16*>(base + 2 * n_pi)[r] =
          ok ? w_po[static_cast<int64_t>(n) * hid + j] : __float2bfloat16_rn(0.0f);
    } else {
      const int r = q - n_pi - n_po, gate = r / n_tap, n = (r % n_tap) / kTapPitch;
      const int tap = r % kTapPitch, half = n / kHalf, j = kHalf * k + n % kHalf;
      float v = 0.0f;
      if (j < hid && tap < 9) {
        const bf16* src = gate ? (half ? w_dw2 : w_dw1) : w_dw;
        const int row = gate ? j : half * hid + j;
        v = __bfloat162float(src[row * 9 + tap]);
      }
      reinterpret_cast<float*>(base + 2 * n_pi + 2 * n_po)[r] = v;
    }
  }
}

// a channel's taps (kTapPitch floats, 16-byte aligned) in three loads
__device__ __forceinline__ void taps12(float (&t)[kTapPitch], const float* src) {
#pragma unroll
  for (int v = 0; v < kTapPitch / 4; ++v) {
    const float4 q = reinterpret_cast<const float4*>(src)[v];
    t[4 * v] = q.x;
    t[4 * v + 1] = q.y;
    t[4 * v + 2] = q.z;
    t[4 * v + 3] = q.w;
  }
}

// block i: image i / (tiles_y tiles_x), tile row (i / tiles_x) % tiles_y,
// column i % tiles_x; parts past the image are computed and not written.
// Warp w keeps project_out's sums of m16 tile w % MT0 of the tile's pixels
// (row-major) and of NTW n8 tiles of channels from (w / MT0) NTW. 512
// threads take one block an SM, 256 two (their shared memory allowing).
template <int TW, int THREADS, int NTW>
__global__ void __launch_bounds__(THREADS, 512 / THREADS)
    ln_iel_mma_kernel(const bf16* __restrict__ x, bf16* __restrict__ out,
                      const float* __restrict__ ln_w, const float* __restrict__ ln_b,
                      const unsigned char* __restrict__ wp, int c, int h, int w, int tiles_x,
                      int tiles_y, int cp, int chunks, int npad, int vec_log, float eps,
                      int residual) {
  using G = LiGeom<TW, THREADS>;
  const int ap = cp + 8;
  const int cw = li_chunk_bytes(cp, npad);
  extern __shared__ __align__(16) unsigned char li_sm[];
  bf16* a_s = reinterpret_cast<bf16*>(li_sm);                  // [P2][ap]
  float* pi_s = reinterpret_cast<float*>(li_sm + 2 * G::P2 * ap);  // [P2][kPiPitch]
  float* t1_s = pi_s + G::P2 * kPiPitch;                    // [P1][kExp]
  bf16* pr_s = reinterpret_cast<bf16*>(t1_s + kExp * G::P1);  // [P0][kPrPitch]
  unsigned char* w_s = reinterpret_cast<unsigned char*>(pr_s + G::P0 * kPrPitch);  // 2 chunks
  bf16* ob_s = reinterpret_cast<bf16*>(li_sm);  // the epilogue's [c][OP], over a_s .. t1_s

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int blk = blockIdx.x;
  const int tx = blk % tiles_x;
  blk /= tiles_x;
  const int ty = blk % tiles_y;
  const int b = blk / tiles_y;
  const int y0 = ty * kMTileH, x0 = tx * TW;
  const int64_t plane = static_cast<int64_t>(h) * w;
  const bf16* xb = x + static_cast<int64_t>(b) * c * plane;
  bf16* ob = out + static_cast<int64_t>(b) * c * plane;

  // chunk k's weights into buffer k % 2, one commit group
  auto load_w = [&](int k) {
    const unsigned char* src = wp + static_cast<int64_t>(k) * cw;
    unsigned char* dst = w_s + (k & 1) * cw;
    for (int i = tid; i < cw / 16; i += THREADS) cp_async16(dst + 16 * i, src + 16 * i);
    cp_async_commit();
  };
  load_w(0);

  if (c <= G::REG_C) {
    // x over the tile and its 2-pixel ring, normalised into A[pixel][channel]:
    // a thread a pixel (a warp's loads on neighbouring pixels of a ring row),
    // all its channels loaded together into registers, two bf16 a register;
    // u = mean(x), s = mean((x-u)^2) (K6's two passes), w * ((x - u) *
    // rsqrt(s + eps)) + b rounded to bf16, 8 channels a 16-byte store; 0
    // outside the image and past C
    constexpr int kPairs = (G::REG_C + 15) / 16 * 8;  // the padded row's channel pairs
    for (int p = tid; p < G::P2; p += THREADS) {
      const int gy = y0 - 2 + p / G::RW2, gx = x0 - 2 + p % G::RW2;
      const bool inside = gy >= 0 && gy < h && gx >= 0 && gx < w;
      const unsigned short* src =
          reinterpret_cast<const unsigned short*>(xb) + static_cast<int64_t>(gy) * w + gx;
      uint32_t v2[kPairs > 0 ? kPairs : 1];
#pragma unroll
      for (int q = 0; q < kPairs; ++q) {
        const uint32_t lo = inside && 2 * q < c ? src[2 * q * plane] : 0u;
        const uint32_t hi = inside && 2 * q + 1 < c ? src[(2 * q + 1) * plane] : 0u;
        v2[q] = lo | (hi << 16);
      }
      auto pair = [&](int q) {
        return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v2[q]));
      };
      float s = 0.0f;
#pragma unroll
      for (int q = 0; q < kPairs; ++q) {
        const float2 f = pair(q);
        if (2 * q < c) s += f.x;
        if (2 * q + 1 < c) s += f.y;
      }
      const float u = s / c;
      float ss = 0.0f;
#pragma unroll
      for (int q = 0; q < kPairs; ++q) {
        const float2 f = pair(q);
        if (2 * q < c) ss += (f.x - u) * (f.x - u);
        if (2 * q + 1 < c) ss += (f.y - u) * (f.y - u);
      }
      const float rs = rsqrtf(ss / c + eps);
      uint4* row = reinterpret_cast<uint4*>(a_s + p * ap);
#pragma unroll
      for (int q = 0; q < kPairs; q += 4) {
        if (2 * q >= cp) break;
        uint32_t u4[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = pair(q + e);
          const int ch = 2 * (q + e);
          const float o0 = inside && ch < c ? ln_w[ch] * ((f.x - u) * rs) + ln_b[ch] : 0.0f;
          const float o1 =
              inside && ch + 1 < c ? ln_w[ch + 1] * ((f.y - u) * rs) + ln_b[ch + 1] : 0.0f;
          const __nv_bfloat162 o = __floats2bfloat162_rn(o0, o1);
          u4[e] = *reinterpret_cast<const uint32_t*>(&o);
        }
        row[q / 4] = make_uint4(u4[0], u4[1], u4[2], u4[3]);
      }
    }
  } else {
    // x over the tile and its 2-pixel ring -> A[pixel][channel], 0 outside
    // the image and past C: a thread a ring row of one channel, its loads
    // issued together (a warp's lanes on neighbouring channels: its stores
    // meet no bank twice)
    const unsigned short* xs = reinterpret_cast<const unsigned short*>(xb);
    unsigned short* as16 = reinterpret_cast<unsigned short*>(a_s);
    for (int i = tid; i < cp * (kMTileH + 4); i += THREADS) {
      const int ch = i % cp, r = i / cp, gy = y0 - 2 + r;
      const bool row_in = ch < c && gy >= 0 && gy < h;
      const unsigned short* src = xs + ch * plane + static_cast<int64_t>(gy) * w;
      unsigned short v[G::RW2];
#pragma unroll
      for (int j = 0; j < G::RW2; ++j) {
        const int gx = x0 - 2 + j;
        v[j] = row_in && gx >= 0 && gx < w ? src[gx] : static_cast<unsigned short>(0);
      }
#pragma unroll
      for (int j = 0; j < G::RW2; ++j) as16[(r * G::RW2 + j) * ap + ch] = v[j];
    }
    __syncthreads();

    // LayerNorm in place, a thread a pixel, 8 channels a 16-byte access:
    // u = mean(x), s = mean((x-u)^2), w * ((x - u) * rsqrt(s + eps)) + b
    // rounded to bf16; 0 outside the image and past C
    for (int p = tid; p < G::P2; p += THREADS) {
      const int gy = y0 - 2 + p / G::RW2, gx = x0 - 2 + p % G::RW2;
      const bool inside = gy >= 0 && gy < h && gx >= 0 && gx < w;
      uint4* row = reinterpret_cast<uint4*>(a_s + p * ap);
      float s = 0.0f;
      for (int v = 0; v < cp / 8; ++v) {
        const uint4 q = row[v];
        const uint32_t u4[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u4[e]));
          s += f.x;
          s += f.y;
        }
      }
      const float u = s / c;
      float ss = 0.0f;
      for (int v = 0; v < cp / 8; ++v) {
        const uint4 q = row[v];
        const uint32_t u4[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u4[e]));
          const float d0 = f.x - u, d1 = f.y - u;
          if (8 * v + 2 * e < c) ss += d0 * d0;
          if (8 * v + 2 * e + 1 < c) ss += d1 * d1;
        }
      }
      const float rs = rsqrtf(ss / c + eps);
      for (int v = 0; v < cp / 8; ++v) {
        const uint4 q = row[v];
        uint32_t u4[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u4[e]));
          const int ch = 8 * v + 2 * e;
          const float o0 = inside && ch < c ? ln_w[ch] * ((f.x - u) * rs) + ln_b[ch] : 0.0f;
          const float o1 =
              inside && ch + 1 < c ? ln_w[ch + 1] * ((f.y - u) * rs) + ln_b[ch + 1] : 0.0f;
          const __nv_bfloat162 o = __floats2bfloat162_rn(o0, o1);
          u4[e] = *reinterpret_cast<const uint32_t*>(&o);
        }
        row[v] = make_uint4(u4[0], u4[1], u4[2], u4[3]);
      }
    }
  }

  float acc[NTW][4];
#pragma unroll
  for (int j = 0; j < NTW; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  const int am = (lane & 7) + ((lane >> 3) & 1) * 8, ah = lane >> 4;
  const int bn = (lane & 7) + (lane >> 4) * 8, bh = (lane >> 3) & 1;
  const int mt0 = warp % G::MT0, nt0 = (warp / G::MT0) * NTW;  // project_out's tiles

  for (int k = 0; k < chunks; ++k) {
    cp_async_wait<0>();  // chunk k's weights (this thread's copies)
    __syncthreads();     // ... everyone's; chunk k - 1 is done with the other buffer
    if (k + 1 < chunks) load_w(k + 1);
    const unsigned char* wk = w_s + (k & 1) * cw;
    const bf16* wpi = reinterpret_cast<const bf16*>(wk);                       // [kExp][ap]
    const bf16* wpo = reinterpret_cast<const bf16*>(wk + 2 * kExp * ap);         // [npad][24]
    const float* tdw = reinterpret_cast<const float*>(wk + 2 * kExp * ap + 2 * npad * kPrPitch);
    const float* tg = tdw + kExp * kTapPitch;

    // the expansion, D[n][p] = sum_ch W_pi[n][ch] A[p][ch]: M = the chunk's
    // 32 channels (two m16 tiles), N = the ring's pixels (n8 tiles 2 warp
    // and 2 warp + 1, then 2 WARPS further on, ...), K = C; D into
    // pi_s[p][n], whose 36-float pitch puts a fragment's 32 values on 32
    // banks
    for (int t0 = 2 * warp; t0 < G::P2 / 8; t0 += 2 * G::WARPS) {
      const int nt = t0 + 1 < G::P2 / 8 ? 2 : 1;  // n8 tiles t0 and t0 + 1: four chains
      float d[2][2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) d[u][mt][e] = 0.0f;
      for (int kk = 0; kk < cp; kk += 16) {
        uint32_t af[2][4], bfr[4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) ldmatrix_x4(af[mt], wpi + (16 * mt + am) * ap + kk + 8 * ah);
        // lanes 0-15 address tile t0's rows (k halves 0, 1), 16-31 tile t0 + 1's
        ldmatrix_x4(bfr, a_s + (8 * t0 + (lane & 7) + 8 * (nt == 2 ? lane >> 4 : 0)) * ap + kk +
                             8 * ((lane >> 3) & 1));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(d[0][mt], af[mt], bfr[0], bfr[1]);
          mma_bf16(d[1][mt], af[mt], bfr[2], bfr[3]);
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (u < nt)
              pi_s[(8 * (t0 + u) + 2 * (lane & 3) + (e & 1)) * kPiPitch + 16 * mt + (lane >> 2) +
                   8 * (e >> 1)] = d[u][mt][e];
    }
    __syncthreads();

    // the first depthwise conv over the 1-pixel ring, 0 outside the image:
    // lane n takes channel n (its taps in registers), warp w rows [5 s, 5 s
    // + 5) (s = w % 2) of a range of columns, walked left to right with the
    // window's last two columns kept
    {
      constexpr int Q = G::WARPS / 2;
      const int r0 = 5 * (warp % 2), qi = warp / 2;
      const int c_lo = qi * G::RW1 / Q, c_hi = (qi + 1) * G::RW1 / Q;
      float tk[kTapPitch], win[7][3];
      taps12(tk, tdw + lane * kTapPitch);
      const float* src = pi_s + r0 * G::RW2 * kPiPitch + lane;
#pragma unroll
      for (int r = 0; r < 7; ++r)
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) win[r][dx] = src[(r * G::RW2 + c_lo + dx) * kPiPitch];
      float nxt[7];  // the next column, loaded a step ahead
#pragma unroll
      for (int r = 0; r < 7; ++r) nxt[r] = src[(r * G::RW2 + c_lo + 2) * kPiPitch];
      // unrolled to the longest range: the window's shifts are renames
#pragma unroll
      for (int k = 0; k < (G::RW1 + Q - 1) / Q; ++k) {
        const int col = c_lo + k;
        if (col >= c_hi) break;
#pragma unroll
        for (int r = 0; r < 7; ++r) win[r][2] = nxt[r];
        if (col + 1 < c_hi)
#pragma unroll
          for (int r = 0; r < 7; ++r) nxt[r] = src[(r * G::RW2 + col + 3) * kPiPitch];
        const int gx = x0 - 1 + col;
#pragma unroll
        for (int r = 0; r < 5; ++r) {
          float a = 0.0f;
#pragma unroll
          for (int tap = 0; tap < 9; ++tap) a = fmaf(tk[tap], win[r + tap / 3][tap % 3], a);
          const int gy = y0 - 1 + r0 + r;
          t1_s[((r0 + r) * G::RW1 + col) * kExp + lane] =
              gy >= 0 && gy < h && gx >= 0 && gx < w ? a : 0.0f;
        }
#pragma unroll
        for (int r = 0; r < 7; ++r) {
          win[r][0] = win[r][1];
          win[r][1] = win[r][2];
        }
      }
    }
    __syncthreads();

    // the gates over the tile: lane n takes channel n, warp w rows [4 s, 4 s
    // + 4) (s = w % 2) of a range of columns, as above; lane j < 16 meets
    // channel 16 + j (the other half) by a shuffle and writes their
    // product, rounded to bf16, to pr_s[pixel][j]
    {
      constexpr int Q = G::WARPS / 2;
      const int r0 = 4 * (warp % 2), qi = warp / 2;
      const int c_lo = qi * TW / Q;
      static_assert(TW % Q == 0, "the gates' column ranges: equal");
      float tk[kTapPitch], win[6][3];
      taps12(tk, tg + lane * kTapPitch);
      const float* src = t1_s + r0 * G::RW1 * kExp + lane;
#pragma unroll
      for (int r = 0; r < 6; ++r)
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) win[r][dx] = src[(r * G::RW1 + c_lo + dx) * kExp];
      float nxt[6];
#pragma unroll
      for (int r = 0; r < 6; ++r) nxt[r] = src[(r * G::RW1 + c_lo + 2) * kExp];
#pragma unroll
      for (int k = 0; k < TW / Q; ++k) {  // every range TW / Q columns
        const int col = c_lo + k;
#pragma unroll
        for (int r = 0; r < 6; ++r) win[r][2] = nxt[r];
        if (k + 1 < TW / Q)
#pragma unroll
          for (int r = 0; r < 6; ++r) nxt[r] = src[(r * G::RW1 + col + 3) * kExp];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float a = 0.0f;
#pragma unroll
          for (int tap = 0; tap < 9; ++tap) a = fmaf(tk[tap], win[r + tap / 3][tap % 3], a);
          const float g = tanhf(a) + win[r + 1][1];
          const float other = __shfl_xor_sync(0xffffffffu, g, kHalf);
          if (lane < kHalf)
            pr_s[((r0 + r) * TW + col) * kPrPitch + lane] = __float2bfloat16_rn(g * other);
        }
#pragma unroll
        for (int r = 0; r < 6; ++r) {
          win[r][0] = win[r][1];
          win[r][1] = win[r][2];
        }
      }
    }
    __syncthreads();

    // project_out: acc[p][n] += sum_j product[p][j] W_po[n][j]
    {
      uint32_t af[4];
      ldmatrix_x4(af, pr_s + (16 * mt0 + am) * kPrPitch + 8 * ah);
#pragma unroll
      for (int j = 0; j < NTW; j += 2) {
        const bf16* bp = wpo + (8 * (nt0 + j) + bn) * kPrPitch + 8 * bh;
        if (j + 1 < NTW) {
          uint32_t bfr[4];
          ldmatrix_x4(bfr, bp);
          mma_bf16(acc[j], af, bfr[0], bfr[1]);
          mma_bf16(acc[j + 1], af, bfr[2], bfr[3]);
        } else {
          uint32_t bfr[2];
          ldmatrix_x2(bfr, bp);
          mma_bf16(acc[j], af, bfr[0], bfr[1]);
        }
      }
    }
  }
  // the residual, read in the sums' own layout (every load issued
  // together) and added in fp32, rounded once into ob_s[channel][pixel];
  // then whole row vectors (1 << vec_log elements; it divides w) of each
  // output plane
  float res[NTW][4];
#pragma unroll
  for (int j = 0; j < NTW; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ch = 8 * (nt0 + j) + 2 * (lane & 3) + (e & 1);
      const int px = 16 * mt0 + (lane >> 2) + 8 * (e >> 1), gy = y0 + px / TW, gx = x0 + px % TW;
      res[j][e] = residual && ch < c && gy < h && gx < w
                      ? __bfloat162float(xb[ch * plane + static_cast<int64_t>(gy) * w + gx])
                      : 0.0f;
    }
  __syncthreads();  // every warp is done with the tiles under ob_s
#pragma unroll
  for (int j = 0; j < NTW; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ch = 8 * (nt0 + j) + 2 * (lane & 3) + (e & 1);
      const float v = residual ? acc[j][e] + res[j][e] : acc[j][e];
      if (ch < c)
        ob_s[ch * G::OP + 16 * mt0 + (lane >> 2) + 8 * (e >> 1)] = __float2bfloat16_rn(v);
    }
  __syncthreads();
  const int vec = 1 << vec_log, per_row = TW >> vec_log;
  for (int i = tid; i < c * kMTileH * per_row; i += THREADS) {
    const int v = i % per_row, r = (i / per_row) % kMTileH, ch = i / (per_row * kMTileH);
    const int gy = y0 + r, gx = x0 + v * vec;
    if (gy >= h || gx >= w) continue;
    bf16* dst = ob + ch * plane + static_cast<int64_t>(gy) * w + gx;
    const bf16* src = ob_s + ch * G::OP + r * TW + v * vec;
    if (vec_log == 3) store_vec<16>(dst, src);
    else if (vec_log == 2) store_vec<8>(dst, src);
    else if (vec_log == 1) store_vec<4>(dst, src);
    else *dst = *src;
  }
}

template <int TW, int THREADS, int NTW>
int launch_ln_iel_mma(const void* x, void* out, const void* ln_w, const void* ln_b,
                      const void* w_pi, const void* w_dw, const void* w_dw1, const void* w_dw2,
                      const void* w_po, void* wpack, int b, int c, int hid, int h, int w,
                      int tiles_x, int tiles_y, int cp, int chunks, int npad, int vec_log,
                      int residual, float eps, int smem, cudaStream_t stream) {
  const int64_t slots = static_cast<int64_t>(chunks) *
                        (kExp * (cp + 8) + npad * kPrPitch + 2 * kExp * kTapPitch);
  const int64_t pack_need = (slots + 255) / 256;
  ln_iel_pack_kernel<<<static_cast<int>(pack_need < 1024 ? pack_need : 1024), 256, 0, stream>>>(
      static_cast<const bf16*>(w_pi), static_cast<const bf16*>(w_dw),
      static_cast<const bf16*>(w_dw1), static_cast<const bf16*>(w_dw2),
      static_cast<const bf16*>(w_po), static_cast<unsigned char*>(wpack), c, hid, cp, npad,
      chunks);
  const int err =
      raise_smem_cap(reinterpret_cast<const void*>(ln_iel_mma_kernel<TW, THREADS, NTW>), smem);
  if (err) return err;
  const int64_t blocks = static_cast<int64_t>(b) * tiles_y * tiles_x;
  ln_iel_mma_kernel<TW, THREADS, NTW>
      <<<static_cast<unsigned int>(blocks), THREADS, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(out), static_cast<const float*>(ln_w),
      static_cast<const float*>(ln_b), static_cast<const unsigned char*>(wpack), c, h, w, tiles_x,
      tiles_y, cp, chunks, npad, vec_log, eps, residual);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace hvi_cidnet

using namespace hvi_cidnet;

// x, out: (b, c, h, w) contiguous; ln_w, ln_b: c fp32 values; w_pi (2 *
// hid, c), w_dw (2 * hid, 9), w_dw1 and w_dw2 (hid, 9), w_po (c, hid), in
// x's dtype. tile .. vec: the plan of ops/ln_iel_cuda.py. fp32
// (ln_iel_plan): tile the tile height, tiles across and down, smem the
// shared memory in bytes; wpack, threads, ntw and vec unused. bf16
// (ln_iel_mma_plan): tile the tile width (32 or 16; 8 rows), tiles across
// and down, smem, threads a block (256 where two blocks share an SM, else
// 512), ntw project_out's n8 tiles a warp, vec the output's store width in
// elements
// (it divides w, out starts aligned to it), wpack scratch for the
// packed weights (ceil(hid / 16) chunks of li_chunk_bytes, 16-byte
// aligned). Returns a cudaError_t code, cudaErrorInvalidValue for a plan it
// cannot run.
extern "C" int ln_iel(const void* x, void* out, int dtype, const void* ln_w, const void* ln_b,
                      const void* w_pi, const void* w_dw, const void* w_dw1, const void* w_dw2,
                      const void* w_po, void* wpack, int b, int c, int hid, int h, int w,
                      int tile, int tiles_x, int tiles_y, int residual, float eps, int smem,
                      int threads, int ntw, int vec, cudaStream_t stream) {
  if (b < 1 || c < 1 || hid < 1 || h < 1 || w < 1 ||
      static_cast<int64_t>(b) * tiles_y * tiles_x > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kBFloat16) {
    const int cp = (c + 15) / 16 * 16, chunks = (hid + kHalf - 1) / kHalf;
    const int nh = (threads / 32) / (kMTileH * tile / 16);  // project_out's warps an m16 tile
    const int npad = 8 * ntw * (nh > 0 ? nh : 1), nt = (c + 7) / 8;
    const int vec_log = vec == 8 ? 3 : vec == 4 ? 2 : vec == 2 ? 1 : 0;
    const int op = kMTileH * tile + 8;
    if ((tile != 32 && tile != 16) || (threads != 512 && threads != 256) || nh < 1 ||
        ntw < 1 || ntw > kMaxNtw || ntw != (nt + nh - 1) / nh ||
        tiles_x != (w + tile - 1) / tile || tiles_y != (h + kMTileH - 1) / kMTileH ||
        smem != li_smem_bytes(tile, cp, npad) || smem > 232448 ||
        2 * c * op > li_smem_bytes(tile, cp, npad) - 2 * li_chunk_bytes(cp, npad) ||
        (vec != 1 && vec != 2 && vec != 4 && vec != 8) || w % vec ||
        reinterpret_cast<uintptr_t>(out) % (2 * vec) || wpack == nullptr ||
        reinterpret_cast<uintptr_t>(wpack) % 16)
      return static_cast<int>(cudaErrorInvalidValue);
#define HVI_P23_ARGS                                                                          \
  x, out, ln_w, ln_b, w_pi, w_dw, w_dw1, w_dw2, w_po, wpack, b, c, hid, h, w, tiles_x, tiles_y, \
      cp, chunks, npad, vec_log, residual, eps, smem, stream
#define HVI_P23(TWV, THV, NTV) \
  if (tile == TWV && threads == THV && ntw == NTV) \
    return launch_ln_iel_mma<TWV, THV, NTV>(HVI_P23_ARGS);
    HVI_P23(16, 256, 1) HVI_P23(16, 256, 2) HVI_P23(16, 256, 3) HVI_P23(16, 256, 4)
    HVI_P23(16, 256, 5) HVI_P23(16, 256, 6)
    HVI_P23(32, 512, 1) HVI_P23(32, 512, 2) HVI_P23(32, 512, 3) HVI_P23(32, 512, 4)
    HVI_P23(32, 512, 5) HVI_P23(32, 512, 6) HVI_P23(32, 512, 7) HVI_P23(32, 512, 8)
    HVI_P23(32, 512, 9)
    HVI_P23(16, 512, 5) HVI_P23(16, 512, 6) HVI_P23(16, 512, 7) HVI_P23(16, 512, 8)
    HVI_P23(16, 512, 9)
#undef HVI_P23
#undef HVI_P23_ARGS
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int th = tile;
  if (dtype != kFloat32 || (th != 8 && th != 4 && th != 2) ||
      tiles_x != (w + kTileW - 1) / kTileW || tiles_y != (h + th - 1) / th ||
      smem != 4 * ln_iel_smem_floats(c, th) || smem > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_ln_iel<float>(x, out, ln_w, ln_b, w_pi, w_dw, w_dw1, w_dw2, w_po, b, c, hid, h, w,
                              th, tiles_x, tiles_y, residual, eps, smem, stream);
}
