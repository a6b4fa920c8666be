// P4 and P5: the dense 3x3 stride-1 convolution on NCHW activations, and
// NormDownsample fused: conv 3x3 (zero SAME padding) -> bilinear x0.5
// (align_corners=True) -> PReLU with one shared slope.
//
// Replace the Pallas kernels experiments/conv_pallas_nhcw.py:64 `_kernel`
// (via _pallas_conv3x3, call :107; `pad_mode` "zero" or "edge", the
// replication pad of the stems and heads) and
// experiments/fused_pallas_nhcw.py:67 `_kernel` (via _pallas_down, call
// :131). Plain versions: conv3x3_plain and conv3x3_half_prelu_plain in
// hvi_cidnet_torch/ops/conv3x3_cuda.py (dispatchers and launch plans there
// too). Both kernels read x and the weights in the activation dtype and
// accumulate in fp32; P5 keeps the conv rows in fp32 through the H pass,
// rounds its rows to the activation dtype where the TPU kernel does
// (experiments/fused_pallas_nhcw.py:98; the W taps too, :153), and rounds
// once more at the store (the identity in fp32 but for the store).
//
// P4 in bf16. Bound: x read once and the output written once over 3.35 TB/s,
// or the products, 2 * 9 * C_in flops per output channel and pixel, over
// the tensor cores' 989 TFLOP/s (a bf16 product is exact in fp32, and the
// tensor cores sum in fp32): bytes at every site of the forward but up3
// (C_in 144, where the operations take 5.7 us against 3.9); ~160 flops a
// byte at C_in = C_out = 36 against the card's ~295. Two arms, one plan
// each (ops/conv3x3_cuda.py picks by shape):
//
// `conv3x3_mma_kernel`, an implicit GEMM on the tensor cores (every site but
// the heads). Read as a GEMM: M = an 8 x 32 tile of output pixels, N = the
// output channels (C_out, or a group of at most 72, padded to 8), K = 9
// taps x C_in, walked in chunks of 16 input channels.
// - Persistent blocks: one or two an SM, each taking a channel group and
//   walking tiles; its steps (a tile's chunk) flow through a ring of 3 to 8
//   stages, so the next tile's copies run under this tile's products and
//   stores. One block computes every output channel of its tile (C_out <=
//   72; more in groups of equal size), so x is read once plus its halo.
// - The halo rectangle (10 x 34) of each chunk arrives by cp.async 16-byte
//   copies of the aligned granules that cover each row (a row of NCHW x
//   starts at any 2-byte offset; the offset of its first column is kept
//   beside it): `stage_rows`. Rows are clamped (edge pad) or zeroed (zero
//   pad) there. The weights, packed once a call by conv3x3_pack_kernel as
//   [group][chunk][tap][channel][16 input channels], stay in shared memory
//   where every chunk fits beside the ring, else come with each stage.
// - One pass turns the chunk's rows into a channel-minor tile A[pixel][16
//   channels], 32-byte rows whose two 16-byte halves swap every 4 rows (no
//   bank conflicts for any 8 consecutive rows): every tap's slice of A is
//   then the tile shifted by whole pixels, dy rows and dx columns, and
//   every ldmatrix row starts on a 16-byte boundary whatever dx is. (The
//   Pallas kernel rolls its rows twice, experiments/conv_pallas_nhcw.py
//   :64-80; a channel-major tile would need a copy per dx.) The pass clamps
//   the column (edge pad) or writes zeros (zero pad, channels past C_in).
// - mma.sync m16n8k16 bf16 -> fp32 through ldmatrix: warp w takes output
//   row w of the tile, two m16 tiles of pixels, every n8 tile of channels.
//   mma.sync and not wgmma: wgmma's M = 64 rows of A must be evenly strided
//   8-row groups, which the 34-pixel rows of a tap's shifted slice are not.
// - The results are rounded once into a [channel][pixel] tile over A and
//   stored as whole row vectors of each output plane (16 bytes where the
//   width allows).
// `conv3x3_small_kernel`, the heads (C_out <= 2) on the CUDA cores: there
// the tensor arm pads N to 8 and re-reads every staged pixel for each tap,
// for 1 or 2 products. It walks the same tiles through the same ring of
// staged rows; each thread sums a 2 x 2 block of pixels over a quarter of
// the input channels, reading its 4 x 4 window straight from the staged
// rows, and the quarters are added at the tile's end.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6): the arms
// are limited by the work done in shared memory per staged element (the
// transpose pass, 9 reads of A per element, the window reads), not by
// their copies; the stems and heads take most of P4's time.
// The fp32 arm of P4 stays on the CUDA cores (TF32 would keep three digits).
//
// P5 in bf16, `conv3x3_half_mma_kernel`: the tensor arm's implicit GEMM over
// the 7 x 33 conv region a 3 x 16 tile of the half-size output reads (its
// last row and column recomputed by the next tile: 4.8 conv pixels an
// output against 4), flat in m16 tiles, each ldmatrix row its own pixel's
// halo row; the epilogue stages the fp32 region in shared memory and runs
// the bands and the PReLU, a thread an output column. Bound: the products
// on the tensor cores (mma.sync), then the bytes.
//
// P5 in fp32 and the fp32 P4 (`conv3x3_kernel`): `conv_region`. A block of
// 256 threads computes a rectangle of conv outputs for CO (4 or 12) output
// channels, one pixel a thread, CO fp32 accumulators each. It walks the input channels 8 at a
// time: it stages their input rectangle with its 1-pixel halo (zero or
// clamped to the edge) and their CO x 9 taps in shared memory, fp32, then
// every thread adds 9 taps x CO products (the taps read as float4
// broadcasts, each product added with an explicit fmaf: the library builds
// with --fmad=false, and the sums run in another order than cuDNN's
// anyway). P4's rectangle is an 8 x 32 output tile, written straight
// from the accumulators. P5's is the 7 x 33 conv rows and columns that a
// 3 x 16 tile of the half-size output reads (rows 2o .. 2o + 2 of every
// output row o, and the same for columns); the block keeps them in shared
// memory and applies K3's float64-derived band weights (ops/resize.py,
// passed as K3 takes them), the H pass and then the W pass in the order of
// K3 and its plain version, then the PReLU. Bound: operations on the fp32
// CUDA cores; P5 also saves writing the full-resolution conv output and
// reading it back for the x0.5 (K3's input).
//
// Occupancy: the fp32 P5 is held to 64 registers (four blocks an SM, a few
// bytes of spills), which ran ~8% faster than its free 80 at every site on an
// NVIDIA H100 80GB HBM3 at 700 W; the same cap on the fp32 P4 (80 of its
// 128 registers, three blocks an SM) ran ~6% slower over its sites
// (PERF.md section 6).
#include "common.cuh"
#include "mma.cuh"

namespace hvi_cidnet {
namespace {

constexpr int kConvThreads = 256;
constexpr int kCiStep = 8;          // input channels staged at a time
constexpr int kTileH = 8;           // P4: output tile
constexpr int kTileW = 32;
constexpr int kHalfH = 3;           // P5: half-size output tile
constexpr int kHalfW = 16;
constexpr int kRegH = 2 * kHalfH + 1;  // P5: the conv rectangle it reads
constexpr int kRegW = 2 * kHalfW + 1;

// P4, bf16: the tensor-core arm
using bf16 = __nv_bfloat16;
constexpr int kMmaTileH = 8;     // output rows a tile: one a warp
constexpr int kMmaTileW = 32;    // output columns a tile: two m16 tiles a warp
constexpr int kHaloH = kMmaTileH + 2, kHaloW = kMmaTileW + 2, kHaloPx = kHaloH * kHaloW;
constexpr int kChunk = 16;       // input channels a chunk: one k16 step a tap
constexpr int kRow = 16;         // elements a row of A and of a tap's weights (32 bytes)
constexpr int kRawGran = 6;      // 16-byte granules a staged row: 34 columns at any 2-byte offset
constexpr int kRawPitch = 8 * kRawGran;
constexpr int kRawStage = kChunk * kHaloH * kRawPitch;  // elements
constexpr int kOutPitch = kMmaTileH * kMmaTileW + 8;    // the epilogue's [channel][pixel]
constexpr int kMaxNT = 9;        // n8 tiles a block: at most 72 output channels
constexpr int kMinStages = 3, kMaxStages = 8;
constexpr int kSmallThreads = 256;  // the CUDA-core arm: 2 x 2 pixels a thread, 4 parts of C_in

// P5, bf16: the tensor-core arm. A tile is kDnTo x kDnTq of the half-size
// output; it reads the (2 kDnTo + 1) x (2 kDnTq + 1) conv outputs from conv
// row 2 o0 and column 2 q0 on (the region), whose last row and column are
// the next tile's first: recomputed there, 231 conv pixels for 48 outputs
// (4.8 a output, 4 without the overlap), in 15 m16 tiles of which the last
// is 7 pixels short.
constexpr int kDnTo = 3, kDnTq = 16;
constexpr int kDnRegH = 2 * kDnTo + 1, kDnRegW = 2 * kDnTq + 1, kDnRegPx = kDnRegH * kDnRegW;
constexpr int kDnMTiles = (kDnRegPx + 15) / 16;
constexpr int kDnHaloH = kDnRegH + 2, kDnHaloW = kDnRegW + 2, kDnHaloPx = kDnHaloH * kDnHaloW;
constexpr int kDnRawStage = kChunk * kDnHaloH * kRawPitch;  // elements (35 columns fit 6 granules)
constexpr int kDnEpiNT = 3;        // n8 tiles of channels the epilogue stages at a time
constexpr int kDnEpiPitch = 260;   // floats a channel's region in the epilogue: 4 mod 32 banks
static_assert(kDnMTiles <= 16 && kDnMTiles > 8, "two m16 tiles a warp, 8 warps");

// element offset of half h (8 elements) of row r of a tile of 32-byte rows:
// the halves swap every 4 rows, so the 8 rows an ldmatrix reads, at any
// start, fall on distinct banks
__host__ __device__ constexpr int swz(int r, int h) { return r * kRow + 8 * (h ^ ((r >> 2) & 1)); }

// bytes of the region that holds A[pixel][16] and, after a tile's last
// products, the epilogue's [channel][pixel]
__host__ __device__ constexpr int mma_epi_bytes(int nt) {
  return 2 * (kHaloPx * kRow > 8 * nt * kOutPitch ? kHaloPx * kRow : 8 * nt * kOutPitch);
}
// dynamic shared memory of conv3x3_small_kernel<co>: the weights in fp32 for
// every chunk, three quarters' sums, the ring's stages of staged rows and
// their offsets
__host__ __device__ constexpr int small_smem_bytes(int co, int chunks, int stages) {
  return 4 * chunks * kChunk * 9 * co + 4 * (kSmallThreads / 64 - 1) * 64 * 4 * co +
         stages * (2 * kRawStage + 4 * kChunk * kHaloH);
}
// dynamic shared memory of conv3x3_mma_kernel<nt>: wslots chunks of weights
// (all chunks, or one a stage), the ring's stages of staged rows and of
// their offsets, the A / epilogue region
__host__ __device__ constexpr int mma_smem_bytes(int nt, int stages, int wslots) {
  return 2 * wslots * 9 * 8 * nt * kRow + stages * (2 * kRawStage + 4 * kChunk * kHaloH) +
         mma_epi_bytes(nt);
}

// bytes of the region that holds P5's A[pixel][16] and, after a tile's last
// products, kDnEpiNT n8 tiles of its fp32 conv region [channel][pixel]
__host__ __device__ constexpr int dn_epi_bytes() {
  return 2 * kDnHaloPx * kRow > 4 * 8 * kDnEpiNT * kDnEpiPitch ? 2 * kDnHaloPx * kRow
                                                                : 4 * 8 * kDnEpiNT * kDnEpiPitch;
}
// dynamic shared memory of conv3x3_half_mma_kernel<nt>, laid out as
// mma_smem_bytes' with P5's stages and region
__host__ __device__ constexpr int dn_smem_bytes(int nt, int stages, int wslots) {
  return 2 * wslots * 9 * 8 * nt * kRow + stages * (2 * kDnRawStage + 4 * kChunk * kDnHaloH) +
         dn_epi_bytes();
}

// The conv outputs of rows [r0, r0 + rh) and columns [c0, c0 + rw) of one
// image for output channels [co0, co0 + CO): thread t < rh * rw takes pixel
// (t / rw, t % rw) into acc; the others only stage. Rows and columns outside
// the image are computed from the padded input too (P5 reads none of them
// with a nonzero weight). s_in holds kCiStep * (rh + 2) * (rw + 2) floats,
// s_w kCiStep * 9 * CO.
template <typename T, int CO>
__device__ __forceinline__ void conv_region(const T* __restrict__ xb, const T* __restrict__ wgt,
                                            int cin, int cout, int h, int w, int co0, int r0,
                                            int c0, int rh, int rw, bool edge, float* s_in,
                                            float* s_w, float (&acc)[CO]) {
  const int tid = threadIdx.x;
  const int ih = rh + 2, iw = rw + 2, n_in = ih * iw;
  const bool active = tid < rh * rw;
  const int py = tid / rw, px = tid - py * rw;
  const int64_t plane = static_cast<int64_t>(h) * w;
#pragma unroll
  for (int q = 0; q < CO; ++q) acc[q] = 0.0f;
  for (int ci0 = 0; ci0 < cin; ci0 += kCiStep) {
    const int nci = min(kCiStep, cin - ci0);
    __syncthreads();  // the last step's readers are done
    for (int i = tid; i < nci * n_in; i += kConvThreads) {
      const int ci = i / n_in, q = i - ci * n_in;
      const int iy = q / iw, ix = q - iy * iw;
      int gy = r0 - 1 + iy, gx = c0 - 1 + ix;
      float v = 0.0f;
      if (edge) {
        gy = min(max(gy, 0), h - 1);
        gx = min(max(gx, 0), w - 1);
        v = load_f32(xb, (ci0 + ci) * plane + static_cast<int64_t>(gy) * w + gx);
      } else if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
        v = load_f32(xb, (ci0 + ci) * plane + static_cast<int64_t>(gy) * w + gx);
      }
      s_in[i] = v;
    }
    for (int i = tid; i < nci * 9 * CO; i += kConvThreads) {
      const int co = i % CO, t = i / CO;  // t = ci * 9 + tap
      const int ci = t / 9, tap = t - ci * 9;
      s_w[i] = co0 + co < cout
                   ? load_f32(wgt, (static_cast<int64_t>(co0 + co) * cin + ci0 + ci) * 9 + tap)
                   : 0.0f;
    }
    __syncthreads();
    if (active) {
      for (int ci = 0; ci < nci; ++ci) {
        const float* src = s_in + ci * n_in + py * iw + px;
        const float* wr = s_w + ci * 9 * CO;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const float v = src[(tap / 3) * iw + tap % 3];
#pragma unroll
          for (int q = 0; q < CO; q += 4) {
            const float4 wv = *reinterpret_cast<const float4*>(wr + tap * CO + q);
            acc[q] = fmaf(wv.x, v, acc[q]);
            acc[q + 1] = fmaf(wv.y, v, acc[q + 1]);
            acc[q + 2] = fmaf(wv.z, v, acc[q + 2]);
            acc[q + 3] = fmaf(wv.w, v, acc[q + 3]);
          }
        }
      }
    }
  }
}

// block b: tile column b % tiles_x, tile row (b / tiles_x) % tiles_y,
// channel group (b / (tiles_x * tiles_y)) % groups, image b / (tiles_x *
// tiles_y * groups)
struct BlockPos {
  int tx, ty, g, b;
};

__device__ __forceinline__ BlockPos block_pos(int tiles_x, int tiles_y, int groups) {
  int blk = blockIdx.x;
  BlockPos pos;
  pos.tx = blk % tiles_x;
  blk /= tiles_x;
  pos.ty = blk % tiles_y;
  blk /= tiles_y;
  pos.g = blk % groups;
  pos.b = blk / groups;
  return pos;
}

template <typename T, int CO>
__global__ void __launch_bounds__(kConvThreads)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ wgt, T* __restrict__ out, int cin,
               int cout, int h, int w, int edge, int tiles_x, int tiles_y, int groups) {
  __shared__ __align__(16) float s_in[kCiStep * (kTileH + 2) * (kTileW + 2)];
  __shared__ __align__(16) float s_w[kCiStep * 9 * CO];
  const BlockPos pos = block_pos(tiles_x, tiles_y, groups);
  const int64_t plane = static_cast<int64_t>(h) * w;
  const int co0 = pos.g * CO, r0 = pos.ty * kTileH, c0 = pos.tx * kTileW;
  float acc[CO];
  conv_region<T, CO>(x + static_cast<int64_t>(pos.b) * cin * plane, wgt, cin, cout, h, w, co0,
                     r0, c0, kTileH, kTileW, edge != 0, s_in, s_w, acc);
  const int gy = r0 + threadIdx.x / kTileW, gx = c0 + threadIdx.x % kTileW;
  if (gy >= h || gx >= w) return;
  T* ob = out + (static_cast<int64_t>(pos.b) * cout + co0) * plane +
          static_cast<int64_t>(gy) * w + gx;
#pragma unroll
  for (int q = 0; q < CO; ++q)
    if (co0 + q < cout) ob[q * plane] = from_f32<T>(acc[q]);
}

template <typename T, int CO>
__global__ void __launch_bounds__(kConvThreads, 4)
conv3x3_half_prelu_kernel(const T* __restrict__ x, const T* __restrict__ wgt,
                          T* __restrict__ out, const float* __restrict__ wh,
                          const float* __restrict__ ww, const float* __restrict__ alpha, int cin,
                          int cout, int h, int w, int tiles_x, int tiles_y, int groups) {
  __shared__ __align__(16) float s_in[kCiStep * (kRegH + 2) * (kRegW + 2)];
  __shared__ __align__(16) float s_w[kCiStep * 9 * CO];
  __shared__ float s_conv[CO * kRegH * kRegW];
  const BlockPos pos = block_pos(tiles_x, tiles_y, groups);
  const int ho = h / 2, wo = w / 2;
  const int co0 = pos.g * CO, o0 = pos.ty * kHalfH, q0 = pos.tx * kHalfW;
  const int64_t plane = static_cast<int64_t>(h) * w;
  float acc[CO];
  conv_region<T, CO>(x + static_cast<int64_t>(pos.b) * cin * plane, wgt, cin, cout, h, w, co0,
                     2 * o0, 2 * q0, kRegH, kRegW, false, s_in, s_w, acc);
  if (threadIdx.x < kRegH * kRegW) {
#pragma unroll
    for (int q = 0; q < CO; ++q) s_conv[q * kRegH * kRegW + threadIdx.x] = acc[q];
  }
  __syncthreads();
  const float a = *alpha;
  const int64_t oplane = static_cast<int64_t>(ho) * wo;
  for (int i = threadIdx.x; i < CO * kHalfH * kHalfW; i += kConvThreads) {
    const int q = i / (kHalfH * kHalfW), r = i - q * (kHalfH * kHalfW);
    const int oy = r / kHalfW, ox = r - oy * kHalfW;
    const int oi = o0 + oy, oj = q0 + ox;
    if (co0 + q >= cout || oi >= ho || oj >= wo) continue;
    // output (oi, oj) = sum of conv (2oi + dy, 2oj + dx), dy, dx in 0..2,
    // H taps (wh[oi], wh[ho + oi], wh[2ho + oi]) first, then W taps; a
    // third tap past the edge has weight 0 and is skipped
    const float ah = wh[oi], bh = wh[ho + oi], chh = wh[2 * ho + oi];
    const float aw = ww[oj], bw = ww[wo + oj], cww = ww[2 * wo + oj];
    const bool row3 = 2 * oi + 2 < h, col3 = 2 * oj + 2 < w;
    const float* s = s_conv + q * kRegH * kRegW + 2 * oy * kRegW + 2 * ox;
    float hh[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      float v = s[d] * ah + s[kRegW + d] * bh;
      if (row3) v = v + s[2 * kRegW + d] * chh;
      hh[d] = v;
    }
    float v = hh[0] * aw + hh[1] * bw;
    if (col3) v = v + hh[2] * cww;
    v = fmaxf(v, 0.0f) + a * fminf(v, 0.0f);
    out[(static_cast<int64_t>(pos.b) * cout + co0 + q) * oplane + static_cast<int64_t>(oi) * wo +
        oj] = from_f32<T>(v);
  }
}

// The weights of conv3x3_mma_kernel, once a call: row (g, k, tap, n) of
// wp holds w[g * cg + n][16 k + e][tap] (OIHW, tap = 3 dy + dx) for e in
// [0, 16), its halves placed by swz(n, e / 8); zero for n past the group's cg
// channels, past C_out, and input channels past C_in. So a chunk's weights
// are one contiguous copy of the tile the kernel reads.
__global__ void conv3x3_pack_kernel(const bf16* __restrict__ w, bf16* __restrict__ wp, int cin,
                                    int cout, int cg, int ng, int chunks, int64_t total) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int e = static_cast<int>(i % kRow);
    int64_t r = i / kRow;
    const int n = static_cast<int>(r % ng);
    r /= ng;
    const int tap = static_cast<int>(r % 9);
    r /= 9;
    const int k = static_cast<int>(r % chunks), g = static_cast<int>(r / chunks);
    const int co = g * cg + n, ci = k * kChunk + e;
    wp[(i - i % (static_cast<int64_t>(ng) * kRow)) + swz(n, e >> 3) + (e & 7)] =
        n < cg && co < cout && ci < cin ? w[(static_cast<int64_t>(co) * cin + ci) * 9 + tap]
                                        : __float2bfloat16_rn(0.0f);
  }
}

// VEC bf16 values of the epilogue's row to out (both aligned to VEC)
template <int VEC>
__device__ __forceinline__ void store_row_vec(bf16* dst, const bf16* src) {
  store_vec<2 * VEC>(dst, src);
}

// a block's place in its sequence of steps: chunk k of the 8 x 32 output
// tile t (image b, input rows from r0 - 1, the halo's columns c0 - 1 ..
// c0 + 32 that lie in the image: [lo, hi)); tiles walker, walker + walkers,
// ... in 32-bit arithmetic, two divisions a tile (a 64-bit division costs
// ~100 instructions, and every thread would pay it every step)
struct MmaCursor {
  int k, t, b, r0, c0, lo, hi;
  __device__ __forceinline__ void place(int tiles_x, int per_img, int w) {
    b = t / per_img;
    const int rem = t - b * per_img, ty = rem / tiles_x;
    r0 = ty * kMmaTileH;
    c0 = (rem - ty * tiles_x) * kMmaTileW;
    lo = max(c0 - 1, 0);
    hi = min(c0 + kHaloW - 1, w);
  }
  __device__ __forceinline__ void start(int walker, int tiles_x, int per_img, int w) {
    k = 0;
    t = walker;
    place(tiles_x, per_img, w);
  }
  __device__ __forceinline__ void advance(int chunks, int walkers, int tiles_x, int per_img,
                                          int w) {
    if (++k < chunks) return;
    k = 0;
    t += walkers;
    place(tiles_x, per_img, w);
  }
};

// chunk k's input rows of tile A into a raw stage: row (ci, r) of the stage
// holds the 16-byte granules that cover columns [lo, hi) of input row r0 -
// 1 + r (clamped for the edge pad) of channel 16 k + ci of image b (xb: the
// image's first channel); os[(ci, r)] = the element offset of column lo in
// it, -1 for a row of zeros (a zero-pad row or a channel past C_in). Every
// copy is one cp.async of a whole aligned granule: a row starts at any
// 2-byte offset (x is NCHW of any width and start).
// HALO_H: the input rows a chunk stages (P4's 10; P5's tensor arm, 9).
template <int HALO_H = kHaloH, typename Cursor = MmaCursor>
__device__ __forceinline__ void stage_rows(bf16* rs, int* os, const bf16* __restrict__ xb,
                                           const Cursor& A, int cin, int h, int w, int edge,
                                           int64_t plane, int tid, int nthreads) {
  const int k = A.k;
  const bf16* xk = xb + static_cast<int64_t>(k) * kChunk * plane;
  for (int i = tid; i < kChunk * HALO_H * kRawGran; i += nthreads) {
    const int gi = i % kRawGran, cr = i / kRawGran;
    const int r = cr % HALO_H, ci = cr / HALO_H;
    int gy = A.r0 - 1 + r;
    bool ok = k * kChunk + ci < cin;
    if (edge) gy = min(max(gy, 0), h - 1);
    else ok = ok && gy >= 0 && gy < h;
    if (!ok) {
      if (gi == 0) os[cr] = -1;
      continue;
    }
    const bf16* src = xk + ci * plane + static_cast<int64_t>(gy) * w + A.lo;
    const uintptr_t a0 = reinterpret_cast<uintptr_t>(src);
    const uintptr_t a1 = reinterpret_cast<uintptr_t>(src + (A.hi - A.lo));
    const uintptr_t g0 = (a0 & ~static_cast<uintptr_t>(15)) + 16 * gi;
    if (gi == 0) os[cr] = static_cast<int>(a0 & 15) / 2;
    if (g0 < a1) cp_async16(rs + cr * kRawPitch + 8 * gi, reinterpret_cast<const void*>(g0));
  }
}

// Persistent blocks: block i takes channel group g = i % groups and walks the
// tiles i / groups, i / groups + gridDim.x / groups, ... (tile t: image t /
// (tiles_x tiles_y), tile row (t / tiles_x) % tiles_y, column t % tiles_x).
// Its steps, one a (tile, chunk of 16 input channels), flow through a ring
// of `stages` stages; the weights of every chunk stay in shared memory
// (resident) or come with each step (a stage's own copy).
template <int NT>
__global__ void __launch_bounds__(kConvThreads, 2)
    conv3x3_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wp,
                       bf16* __restrict__ out, int nb, int cin, int cout, int h, int w, int edge,
                       int tiles_x, int tiles_y, int groups, int cg, int chunks, int vec_log,
                       int stages, int resident) {
  constexpr int NG = 8 * NT;
  constexpr int kWChunk = 9 * NG * kRow;  // elements of one chunk's weights
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ws = reinterpret_cast<bf16*>(smem_raw);       // [chunks or stages][9][NG][kRow]
  bf16* raw = ws + (resident ? chunks : stages) * kWChunk;  // [stages][16][kHaloH][kRawPitch]
  bf16* as = raw + stages * kRawStage;                // A[kHaloPx][kRow] / [NG][kOutPitch]
  int* offs = reinterpret_cast<int*>(as + mma_epi_bytes(NT) / 2);  // [stages][16][kHaloH]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = blockIdx.x % groups, walker = blockIdx.x / groups, walkers = gridDim.x / groups;
  const int per_img = tiles_x * tiles_y, tiles = nb * per_img;
  const int my_tiles = walker < tiles ? (tiles - 1 - walker) / walkers + 1 : 0;
  const int steps = my_tiles * chunks;
  const int64_t plane = static_cast<int64_t>(h) * w;
  const bf16* wg = wp + static_cast<int64_t>(g) * chunks * kWChunk;
  // `ahead` walks the steps stages - 1 before the products' cursor `T`
  MmaCursor ahead, T;
  ahead.start(walker, tiles_x, per_img, w);
  T.start(walker, tiles_x, per_img, w);

  if (resident)  // every chunk's weights of group g, once
    for (int i = tid; i < chunks * kWChunk / 8; i += kConvThreads)
      cp_async16(ws + 8 * i, wg + 8 * i);
  cp_async_commit();

  // step s into stage st, one commit group (empty past the end): the
  // chunk's input rows (stage_rows) and, unless resident, its weights
  auto fill = [&](int s, int st) {
    if (s < steps) {
      const int k = ahead.k;
      stage_rows(raw + st * kRawStage, offs + st * kChunk * kHaloH,
                 x + static_cast<int64_t>(ahead.b) * cin * plane, ahead, cin, h, w, edge, plane,
                 tid, kConvThreads);
      if (!resident) {
        const bf16* wsrc = wg + static_cast<int64_t>(k) * kWChunk;
        bf16* wdst = ws + st * kWChunk;
        for (int i = tid; i < kWChunk / 8; i += kConvThreads)
          cp_async16(wdst + 8 * i, wsrc + 8 * i);
      }
      ahead.advance(chunks, walkers, tiles_x, per_img, w);
    }
    cp_async_commit();
  };

  // stage st's rows -> A[pixel][16 channels]: job j = half * kHaloPx + p
  // writes channels [8 half, 8 half + 8) of halo pixel p as one 16-byte store
  auto transpose = [&](int st) {
    const unsigned short* rs = reinterpret_cast<const unsigned short*>(raw) + st * kRawStage;
    const int* os = offs + st * kChunk * kHaloH;
    for (int j = tid; j < 2 * kHaloPx; j += kConvThreads) {
      const int half = j / kHaloPx, p = j - half * kHaloPx;
      const int r = p / kHaloW;
      int c = T.c0 - 1 + p - r * kHaloW;
      bool in = true;
      if (c < 0 || c >= w) {
        if (edge) c = min(max(c, 0), w - 1);
        else in = false;
      }
      const int col = c - T.lo;
      uint32_t v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t e[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int cr = (half * 8 + 2 * q + u) * kHaloH + r;
          const int o = os[cr];
          e[u] = in && o >= 0 ? rs[cr * kRawPitch + col + o] : 0u;
        }
        v[q] = e[0] | (e[1] << 16);
      }
      *reinterpret_cast<uint4*>(as + swz(p, half)) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  };

  // the accumulators; with few channels (NT <= 2) one set a kernel row dy,
  // summed at the epilogue, so that a warp has more than NT * 2 chains of
  // dependent products in flight
  constexpr int ND = NT <= 2 ? 3 : 1;
  float acc[ND][2][NT][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[d][mt][j][e] = 0.0f;
  // ldmatrix rows: A's pixel and channel half, B's channel and input-channel half
  const int am = (lane & 7) + ((lane >> 3) & 1) * 8, ah = lane >> 4;
  const int bn = (lane & 7) + (lane >> 4) * 8, bh = (lane >> 3) & 1;
  const int per_row_log = 5 - vec_log;  // output vectors a tile row: 32 >> vec_log

  for (int s = 0; s < stages - 1; ++s) fill(s, s);
  int cur = 0;  // s % stages
  for (int s = 0; s < steps; ++s) {
    cp_async_wait_dyn(stages - 2);  // the weights and step s have landed (this thread's)
    __syncthreads();                // ... everyone's; step s - 1's readers are done
    fill(s + stages - 1, cur == 0 ? stages - 1 : cur - 1);  // into step s - 1's stage
    const int k = T.k;
    transpose(cur);
    __syncthreads();
    const bf16* wst = ws + (resident ? k : cur) * kWChunk;
    cur = cur + 1 == stages ? 0 : cur + 1;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3, d = dy % ND;
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix_x4(af[mt], as + swz((warp + dy) * kHaloW + mt * 16 + dx + am, ah));
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        const bf16* bp = wst + tap * NG * kRow + swz(j * 8 + bn, bh);
        if (j + 1 < NT) {
          uint32_t bf[4];
          ldmatrix_x4(bf, bp);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_bf16(acc[d][mt][j], af[mt], bf[0], bf[1]);
            mma_bf16(acc[d][mt][j + 1], af[mt], bf[2], bf[3]);
          }
        } else {
          uint32_t bf[2];
          ldmatrix_x2(bf, bp);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) mma_bf16(acc[d][mt][j], af[mt], bf[0], bf[1]);
        }
      }
    }
    if (k != chunks - 1) {
      T.advance(chunks, walkers, tiles_x, per_img, w);
      continue;
    }

    // the tile's epilogue: d[e] of tile (mt, j) is pixel 16 mt + lane / 4 (+ 8
    // for e >= 2) of warp's row, channel 8 j + 2 (lane % 4) + e % 2; rounded
    // once into ob_s[channel][pixel] (over A), then stored as row vectors of
    // each output plane
    __syncthreads();  // every warp's products are done with A
    bf16* ob_s = as;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int px = warp * kMmaTileW + mt * 16 + (lane >> 2) + 8 * (e >> 1);
          float v = acc[0][mt][j][e];
#pragma unroll
          for (int d = 1; d < ND; ++d) v += acc[d][mt][j][e];
          ob_s[(j * 8 + 2 * (lane & 3) + (e & 1)) * kOutPitch + px] = __float2bfloat16_rn(v);
#pragma unroll
          for (int d = 0; d < ND; ++d) acc[d][mt][j][e] = 0.0f;
        }
    __syncthreads();
    const int co0 = g * cg, cgr = min(cg, cout - co0);
    bf16* ob = out + (static_cast<int64_t>(T.b) * cout + co0) * plane;
    const int vec = 1 << vec_log;
    for (int i = tid; i < (cgr * kMmaTileH) << per_row_log; i += kConvThreads) {
      const int v = i & ((1 << per_row_log) - 1), r = (i >> per_row_log) & (kMmaTileH - 1);
      const int n = i >> (per_row_log + 3);
      const int gy = T.r0 + r, gx = T.c0 + v * vec;
      if (gy >= h || gx >= w) continue;
      bf16* dst = ob + n * plane + static_cast<int64_t>(gy) * w + gx;
      const bf16* src = ob_s + n * kOutPitch + r * kMmaTileW + v * vec;
      if (vec_log == 3) store_row_vec<8>(dst, src);
      else if (vec_log == 2) store_row_vec<4>(dst, src);
      else if (vec_log == 1) store_row_vec<2>(dst, src);
      else *dst = *src;
    }
    T.advance(chunks, walkers, tiles_x, per_img, w);
  }
  cp_async_wait<0>();  // no copy outlives the block
}

// The CUDA-core arm, for the heads (C_out <= 2): there the tensor cores would
// pad N to 8 and re-read every staged pixel for each of the 9 taps, for 2
// products a pixel and tap, while the conv is bound by its bytes on any
// unit. Persistent blocks of 256 threads walk the same 8 x 32 tiles through
// the same ring of staged rows (stage_rows, cp.async) as the tensor arm.
// Thread t owns the 2 x 2 pixels at output rows 2 (t % 64 / 16) + {0, 1},
// columns 2 (t % 16) + {0, 1} of the tile, for input channels of parity t /
// 64 modulo 4: it reads their 4 x 4 window straight from the staged rows
// (the row's offset, the column clamped or masked) and the weights from
// shared memory in fp32, one fmaf a product; at the tile's end the three
// other quarters' sums are added to the first quarter's through shared
// memory, in quarter order, and rounded once.
template <int CO>
__global__ void __launch_bounds__(kSmallThreads)
    conv3x3_small_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wgt,
                         bf16* __restrict__ out, int nb, int cin, int cout, int h, int w,
                         int edge, int tiles_x, int tiles_y, int chunks, int stages) {
  constexpr int kParts = kSmallThreads / 64;  // the input channels' split
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* wsm = reinterpret_cast<float*>(smem_raw);  // [16 chunks][9][CO]
  float* red = wsm + chunks * kChunk * 9 * CO;      // [kParts - 1][64][4][CO]
  bf16* raw = reinterpret_cast<bf16*>(red + (kParts - 1) * 64 * 4 * CO);  // [stages][kRawStage]
  int* offs = reinterpret_cast<int*>(raw + stages * kRawStage);  // [stages][16][kHaloH]
  const int tid = threadIdx.x, part = tid >> 6, q = tid & 63;
  const int walker = blockIdx.x, walkers = gridDim.x;
  const int per_img = tiles_x * tiles_y, tiles = nb * per_img;
  const int my_tiles = walker < tiles ? (tiles - 1 - walker) / walkers + 1 : 0;
  const int steps = my_tiles * chunks;
  const int64_t plane = static_cast<int64_t>(h) * w;
  // the weights, fp32, zero past C_in and C_out ([channel][tap][co])
  for (int i = tid; i < chunks * kChunk * 9 * CO; i += kSmallThreads) {
    const int c = i % CO, t = (i / CO) % 9, ci = i / (9 * CO);
    wsm[i] = ci < cin && c < cout
                 ? __bfloat162float(wgt[(static_cast<int64_t>(c) * cin + ci) * 9 + t])
                 : 0.0f;
  }
  MmaCursor ahead, T;
  ahead.start(walker, tiles_x, per_img, w);
  T.start(walker, tiles_x, per_img, w);
  auto fill = [&](int s, int st) {
    if (s < steps) {
      stage_rows(raw + st * kRawStage, offs + st * kChunk * kHaloH,
                 x + static_cast<int64_t>(ahead.b) * cin * plane, ahead, cin, h, w, edge, plane,
                 tid, kSmallThreads);
      ahead.advance(chunks, walkers, tiles_x, per_img, w);
    }
    cp_async_commit();
  };
  for (int s = 0; s < stages - 1; ++s) fill(s, s);

  const int r = 2 * (q >> 4), c = 2 * (q & 15);  // the 2 x 2 pixels' first output row, column
  int col[4];  // the window's columns c0 - 1 + c + j (clamped for the edge pad) - lo
  bool in[4];  // ... inside the image (always, for the edge pad)
  auto place = [&]() {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int gc = T.c0 - 1 + c + j;
      in[j] = edge || (gc >= 0 && gc < w);
      if (edge) gc = min(max(gc, 0), w - 1);
      col[j] = gc - T.lo;
    }
  };
  place();
  float acc[4][CO];  // [pixel: 2 dy + dx][channel]
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int o = 0; o < CO; ++o) acc[p][o] = 0.0f;
  int cur = 0;  // s % stages
  for (int s = 0; s < steps; ++s) {
    cp_async_wait_dyn(stages - 2);  // step s has landed (this thread's copies)
    __syncthreads();                // ... everyone's; step s - 1's readers are done
    fill(s + stages - 1, cur == 0 ? stages - 1 : cur - 1);
    const unsigned short* rs = reinterpret_cast<const unsigned short*>(raw) + cur * kRawStage;
    const int* os = offs + cur * kChunk * kHaloH;
    cur = cur + 1 == stages ? 0 : cur + 1;
    const int k = T.k, nci = min(kChunk, cin - k * kChunk);
    for (int ci = part; ci < nci; ci += kParts) {
      float v[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int cr = ci * kHaloH + r + i, o = os[cr];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[i][j] = o >= 0 && in[j] ? __uint_as_float(
                                          static_cast<uint32_t>(rs[cr * kRawPitch + col[j] + o])
                                          << 16)
                                    : 0.0f;
      }
      const float* wc = wsm + (k * kChunk + ci) * 9 * CO;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap % 3;
        float wv[CO];
        if constexpr (CO == 2) {  // both channels' weight in one 8-byte load
          const float2 pair = *reinterpret_cast<const float2*>(wc + 2 * tap);
          wv[0] = pair.x;
          wv[1] = pair.y;
        } else {
          wv[0] = wc[tap];
        }
#pragma unroll
        for (int o = 0; o < CO; ++o)
#pragma unroll
          for (int p = 0; p < 4; ++p)
            acc[p][o] = fmaf(wv[o], v[dy + (p >> 1)][dx + (p & 1)], acc[p][o]);
      }
    }
    if (k == chunks - 1) {  // the tile's outputs: the quarters' sums, rounded once
      if (part > 0) {
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int o = 0; o < CO; ++o) red[(((part - 1) * 64 + q) * 4 + p) * CO + o] = acc[p][o];
      }
      __syncthreads();
      const int gx = T.c0 + c;
      if (part == 0) {
#pragma unroll
        for (int i = 0; i < kParts - 1; ++i)
#pragma unroll
          for (int p = 0; p < 4; ++p)
#pragma unroll
            for (int o = 0; o < CO; ++o) acc[p][o] += red[((i * 64 + q) * 4 + p) * CO + o];
#pragma unroll
        for (int dy = 0; dy < 2; ++dy) {
          const int gy = T.r0 + r + dy;
          if (gy >= h || gx >= w) continue;
          bf16* ob = out + static_cast<int64_t>(T.b) * cout * plane + static_cast<int64_t>(gy) * w +
                     gx;
#pragma unroll
          for (int o = 0; o < CO; ++o) {
            if (o >= cout) break;
            const float a0 = acc[2 * dy][o], a1 = acc[2 * dy + 1][o];
            if (gx + 1 < w && (w & 1) == 0) {  // an even offset: one 4-byte store
              *reinterpret_cast<__nv_bfloat162*>(ob + o * plane) = __floats2bfloat162_rn(a0, a1);
            } else {
              ob[o * plane] = __float2bfloat16_rn(a0);
              if (gx + 1 < w) ob[o * plane + 1] = __float2bfloat16_rn(a1);
            }
          }
        }
      }
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int o = 0; o < CO; ++o) acc[p][o] = 0.0f;
      T.advance(chunks, walkers, tiles_x, per_img, w);
      place();
    } else {
      T.advance(chunks, walkers, tiles_x, per_img, w);
    }
  }
  cp_async_wait<0>();  // no copy outlives the block
}

// P5's place in its sequence of steps: chunk k of the half-size output tile
// t (image b; its conv region from row r0 = 2 o0 and column c0 = 2 q0; the
// halo's columns c0 - 1 .. c0 + 2 kDnTq + 1 that lie in the image: [lo,
// hi)); as MmaCursor
struct DnCursor {
  int k, t, b, r0, c0, lo, hi;
  __device__ __forceinline__ void place(int tiles_x, int per_img, int w) {
    b = t / per_img;
    const int rem = t - b * per_img, ty = rem / tiles_x;
    r0 = 2 * kDnTo * ty;
    c0 = 2 * kDnTq * (rem - ty * tiles_x);
    lo = max(c0 - 1, 0);
    hi = min(c0 - 1 + kDnHaloW, w);
  }
  __device__ __forceinline__ void start(int walker, int tiles_x, int per_img, int w) {
    k = 0;
    t = walker;
    place(tiles_x, per_img, w);
  }
  __device__ __forceinline__ void advance(int chunks, int walkers, int tiles_x, int per_img,
                                          int w) {
    if (++k < chunks) return;
    k = 0;
    t += walkers;
    place(tiles_x, per_img, w);
  }
};

// P5 in bf16: conv3x3_mma_kernel's implicit GEMM (persistent blocks, the
// cp.async ring of staged rows, the swizzled channel-minor tile A, the
// weights of conv3x3_pack_kernel, mma.sync) over P5's conv region, with its
// own epilogue. M = the region's 231 pixels, flat: with 256 threads (two
// blocks an SM) warp w takes m16 tiles w and w + 8, with 512 (one block an
// SM, 72-channel groups) tile w; each lane's ldmatrix row is its pixel's
// own shifted halo row, so the region's rows need not be whole m16 tiles. After a tile's last
// chunk, kDnEpiNT n8 tiles at a time: the fp32 conv region into shared
// memory, then a thread an output: the H band (rows 2o, 2o + 1, 2o + 2 with
// K3's fp32 taps, the third skipped past the edge, where its weight is 0),
// rounded to bf16 (experiments/fused_pallas_nhcw.py:98), the W band with
// the taps rounded to bf16 (:153), the PReLU in fp32, one rounding at the
// store.
template <int NT, int THREADS>
__global__ void __launch_bounds__(THREADS, 512 / THREADS)
    conv3x3_half_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wp,
                            bf16* __restrict__ out, const float* __restrict__ wh,
                            const float* __restrict__ ww, const float* __restrict__ alpha, int nb,
                            int cin, int cout, int h, int w, int tiles_x, int tiles_y, int groups,
                            int cg, int chunks, int stages, int resident) {
  constexpr int NG = 8 * NT;
  constexpr int kWChunk = 9 * NG * kRow;
  constexpr int kMtw = THREADS == 256 ? 2 : 1;  // m16 tiles a warp: w (and w + 8)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ws = reinterpret_cast<bf16*>(smem_raw);
  bf16* raw = ws + (resident ? chunks : stages) * kWChunk;  // [stages][16][kDnHaloH][kRawPitch]
  bf16* as = raw + stages * kDnRawStage;  // A[kDnHaloPx][kRow] / fp32 [8 kDnEpiNT][kDnEpiPitch]
  int* offs = reinterpret_cast<int*>(as + dn_epi_bytes() / 2);  // [stages][16][kDnHaloH]
  float* ep = reinterpret_cast<float*>(as);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = blockIdx.x % groups, walker = blockIdx.x / groups, walkers = gridDim.x / groups;
  const int per_img = tiles_x * tiles_y, tiles = nb * per_img;
  const int my_tiles = walker < tiles ? (tiles - 1 - walker) / walkers + 1 : 0;
  const int steps = my_tiles * chunks;
  const int64_t plane = static_cast<int64_t>(h) * w;
  const int ho = h / 2, wo = w / 2;
  const bf16* wg = wp + static_cast<int64_t>(g) * chunks * kWChunk;
  DnCursor ahead, T;
  ahead.start(walker, tiles_x, per_img, w);
  T.start(walker, tiles_x, per_img, w);

  if (resident)
    for (int i = tid; i < chunks * kWChunk / 8; i += THREADS)
      cp_async16(ws + 8 * i, wg + 8 * i);
  cp_async_commit();

  auto fill = [&](int s, int st) {
    if (s < steps) {
      const int k = ahead.k;
      stage_rows<kDnHaloH>(raw + st * kDnRawStage, offs + st * kChunk * kDnHaloH,
                           x + static_cast<int64_t>(ahead.b) * cin * plane, ahead, cin, h, w, 0,
                           plane, tid, THREADS);
      if (!resident) {
        const bf16* wsrc = wg + static_cast<int64_t>(k) * kWChunk;
        bf16* wdst = ws + st * kWChunk;
        for (int i = tid; i < kWChunk / 8; i += THREADS)
          cp_async16(wdst + 8 * i, wsrc + 8 * i);
      }
      ahead.advance(chunks, walkers, tiles_x, per_img, w);
    }
    cp_async_commit();
  };

  // stage st's rows -> A[halo pixel][16 channels], zero outside the image
  auto transpose = [&](int st) {
    const unsigned short* rs = reinterpret_cast<const unsigned short*>(raw) + st * kDnRawStage;
    const int* os = offs + st * kChunk * kDnHaloH;
    for (int j = tid; j < 2 * kDnHaloPx; j += THREADS) {
      const int half = j / kDnHaloPx, p = j - half * kDnHaloPx;
      const int r = p / kDnHaloW;
      const int c = T.c0 - 1 + p - r * kDnHaloW;
      const bool in = c >= 0 && c < w;
      const int col = c - T.lo;
      uint32_t v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t e[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int cr = (half * 8 + 2 * q + u) * kDnHaloH + r;
          const int o = os[cr];
          e[u] = in && o >= 0 ? rs[cr * kRawPitch + col + o] : 0u;
        }
        v[q] = e[0] | (e[1] << 16);
      }
      *reinterpret_cast<uint4*>(as + swz(p, half)) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  };

  float acc[kMtw][NT][4];
#pragma unroll
  for (int mt = 0; mt < kMtw; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.0f;
  const int am = (lane & 7) + ((lane >> 3) & 1) * 8, ah = lane >> 4;
  const int bn = (lane & 7) + (lane >> 4) * 8, bh = (lane >> 3) & 1;
  // the warp's m16 tiles: w and, with 8 warps, w + 8; with 16 warps one, the
  // 16th warp none
  const bool one = warp < kDnMTiles, two = kMtw == 2 && warp + 8 < kDnMTiles;
  int hb[kMtw];  // the halo pixel at tap (0, 0) of this lane's ldmatrix row, each m16 tile
#pragma unroll
  for (int mt = 0; mt < kMtw; ++mt) {
    int i = 16 * (warp + 8 * mt) + am;
    if (i >= kDnRegPx) i = 0;  // past the region: computed, never stored
    hb[mt] = (i / kDnRegW) * kDnHaloW + i % kDnRegW;
  }
  const float a = *alpha;

  for (int s = 0; s < stages - 1; ++s) fill(s, s);
  int cur = 0;
  for (int s = 0; s < steps; ++s) {
    cp_async_wait_dyn(stages - 2);
    __syncthreads();
    fill(s + stages - 1, cur == 0 ? stages - 1 : cur - 1);
    const int k = T.k;
    transpose(cur);
    __syncthreads();
    const bf16* wst = ws + (resident ? k : cur) * kWChunk;
    cur = cur + 1 == stages ? 0 : cur + 1;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      if (!one) break;
      const int off = (tap / 3) * kDnHaloW + tap % 3;
      uint32_t af[2][4];
      ldmatrix_x4(af[0], as + swz(hb[0] + off, ah));
      if (two) ldmatrix_x4(af[1], as + swz(hb[kMtw - 1] + off, ah));
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        const bf16* bp = wst + tap * NG * kRow + swz(j * 8 + bn, bh);
        if (j + 1 < NT) {
          uint32_t bf[4];
          ldmatrix_x4(bf, bp);
          mma_bf16(acc[0][j], af[0], bf[0], bf[1]);
          mma_bf16(acc[0][j + 1], af[0], bf[2], bf[3]);
          if (two) {
            mma_bf16(acc[kMtw - 1][j], af[1], bf[0], bf[1]);
            mma_bf16(acc[kMtw - 1][j + 1], af[1], bf[2], bf[3]);
          }
        } else {
          uint32_t bf[2];
          ldmatrix_x2(bf, bp);
          mma_bf16(acc[0][j], af[0], bf[0], bf[1]);
          if (two) mma_bf16(acc[kMtw - 1][j], af[1], bf[0], bf[1]);
        }
      }
    }
    if (k != chunks - 1) {
      T.advance(chunks, walkers, tiles_x, per_img, w);
      continue;
    }

    // the tile's epilogue, kDnEpiNT n8 tiles (8 kDnEpiNT channels) a pass:
    // d[e] of tile (mt, j) is region pixel 16 (warp + 8 mt) + lane / 4 (+ 8
    // for e >= 2), channel 8 j + 2 (lane % 4) + e % 2
    // A thread keeps one output column q (THREADS is a multiple of
    // kDnTq) and walks rows and channels: its W taps, rounded to bf16, and
    // the tile's H taps are read once a tile.
    const int o0 = T.r0 / 2, q0 = T.c0 / 2;
    const int cgr = min(cg, cout - g * cg);
    bf16* ob = out + (static_cast<int64_t>(T.b) * cout + g * cg) * ho * wo;
    const int q = tid % kDnTq, oj = q0 + q;
    float tw[3] = {0.0f, 0.0f, 0.0f}, th[kDnTo][3];
    if (oj < wo)
#pragma unroll
      for (int d = 0; d < 3; ++d) tw[d] = round_through<bf16>(ww[d * wo + oj]);
#pragma unroll
    for (int oy = 0; oy < kDnTo; ++oy)
#pragma unroll
      for (int d = 0; d < 3; ++d) th[oy][d] = o0 + oy < ho ? wh[d * ho + o0 + oy] : 0.0f;
    const bool col3 = 2 * oj + 2 < w;
#pragma unroll
    for (int j0 = 0; j0 < NT; j0 += kDnEpiNT) {
      __syncthreads();  // the products are done with A; the last pass's readers with ep
#pragma unroll
      for (int mt = 0; mt < kMtw; ++mt)
#pragma unroll
        for (int jj = 0; jj < kDnEpiNT; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = j0 + jj, i = 16 * (warp + 8 * mt) + (lane >> 2) + 8 * (e >> 1);
            if (j < NT && (mt == 0 ? one : two) && i < kDnRegPx)
              ep[(jj * 8 + 2 * (lane & 3) + (e & 1)) * kDnEpiPitch + i] = acc[mt][j][e];
          }
      __syncthreads();
      const int nch = min(8 * kDnEpiNT, cgr - 8 * j0);
      if (oj >= wo) continue;
      for (int i = tid / kDnTq; i < nch * kDnTo; i += THREADS / kDnTq) {
        const int oy = i % kDnTo, n = i / kDnTo, oi = o0 + oy;
        if (oi >= ho) continue;
        const bool row3 = 2 * oi + 2 < h;
        const float* src = ep + n * kDnEpiPitch + 2 * oy * kDnRegW + 2 * q;
        float hh[3];
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          float v = src[d] * th[oy][0] + src[kDnRegW + d] * th[oy][1];
          if (row3) v = v + src[2 * kDnRegW + d] * th[oy][2];
          hh[d] = round_through<bf16>(v);
        }
        float v = hh[0] * tw[0] + hh[1] * tw[1];
        if (col3) v = v + hh[2] * tw[2];
        v = fmaxf(v, 0.0f) + a * fminf(v, 0.0f);
        ob[(static_cast<int64_t>(8 * j0 + n) * ho + oi) * wo + oj] = __float2bfloat16_rn(v);
      }
    }
#pragma unroll
    for (int mt = 0; mt < kMtw; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.0f;
    T.advance(chunks, walkers, tiles_x, per_img, w);
  }
  cp_async_wait<0>();
}

template <int CO>
int launch_small(const void* x, const void* wgt, void* out, int b, int cin, int cout, int h,
                 int w, int edge, int tiles_x, int tiles_y, int smem, int blocks, int stages,
                 cudaStream_t stream) {
  const int err = raise_smem_cap(reinterpret_cast<const void*>(conv3x3_small_kernel<CO>), smem);
  if (err) return err;
  conv3x3_small_kernel<CO><<<blocks, kSmallThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wgt), static_cast<bf16*>(out), b, cin,
      cout, h, w, edge, tiles_x, tiles_y, (cin + kChunk - 1) / kChunk, stages);
  return static_cast<int>(cudaGetLastError());
}

template <int NT>
int launch_mma(const void* x, const void* wgt, void* wpack, void* out, int b, int cin, int cout,
               int h, int w, int edge, int cg, int tiles_x, int tiles_y, int groups, int vec,
               int smem, int blocks, int stages, int resident, cudaStream_t stream) {
  constexpr int NG = 8 * NT;
  const int chunks = (cin + kChunk - 1) / kChunk;
  const int64_t total = static_cast<int64_t>(groups) * chunks * 9 * NG * kRow;
  const int64_t pack_need = (total + kConvThreads - 1) / kConvThreads;
  const int pack_blocks = static_cast<int>(pack_need < 1024 ? pack_need : 1024);
  conv3x3_pack_kernel<<<pack_blocks, kConvThreads, 0, stream>>>(
      static_cast<const bf16*>(wgt), static_cast<bf16*>(wpack), cin, cout, cg, NG, chunks, total);
  const int err = raise_smem_cap(reinterpret_cast<const void*>(conv3x3_mma_kernel<NT>), smem);
  if (err) return err;
  const int vec_log = vec == 8 ? 3 : vec == 4 ? 2 : vec == 2 ? 1 : 0;
  conv3x3_mma_kernel<NT><<<blocks, kConvThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wpack), static_cast<bf16*>(out), b,
      cin, cout, h, w, edge, tiles_x, tiles_y, groups, cg, chunks, vec_log, stages, resident);
  return static_cast<int>(cudaGetLastError());
}

template <int NT, int THREADS>
int launch_half_mma(const void* x, const void* wgt, void* wpack, void* out, const void* wh,
                    const void* ww, const void* alpha, int b, int cin, int cout, int h, int w,
                    int cg, int tiles_x, int tiles_y, int groups, int smem, int blocks, int stages,
                    int resident, cudaStream_t stream) {
  constexpr int NG = 8 * NT;
  const int chunks = (cin + kChunk - 1) / kChunk;
  const int64_t total = static_cast<int64_t>(groups) * chunks * 9 * NG * kRow;
  const int64_t pack_need = (total + kConvThreads - 1) / kConvThreads;
  const int pack_blocks = static_cast<int>(pack_need < 1024 ? pack_need : 1024);
  conv3x3_pack_kernel<<<pack_blocks, kConvThreads, 0, stream>>>(
      static_cast<const bf16*>(wgt), static_cast<bf16*>(wpack), cin, cout, cg, NG, chunks, total);
  const int err =
      raise_smem_cap(reinterpret_cast<const void*>(conv3x3_half_mma_kernel<NT, THREADS>), smem);
  if (err) return err;
  conv3x3_half_mma_kernel<NT, THREADS><<<blocks, THREADS, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wpack), static_cast<bf16*>(out),
      static_cast<const float*>(wh), static_cast<const float*>(ww),
      static_cast<const float*>(alpha), b, cin, cout, h, w, tiles_x, tiles_y, groups, cg, chunks,
      stages, resident);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int CO>
int launch_conv(const void* x, const void* wgt, void* out, int b, int cin, int cout, int h, int w,
                int edge, int tiles_x, int tiles_y, int groups, cudaStream_t stream) {
  const int64_t blocks = static_cast<int64_t>(b) * groups * tiles_y * tiles_x;
  conv3x3_kernel<T, CO><<<static_cast<unsigned int>(blocks), kConvThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wgt), static_cast<T*>(out), cin, cout, h, w,
      edge, tiles_x, tiles_y, groups);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int CO>
int launch_half(const void* x, const void* wgt, void* out, const void* wh, const void* ww,
                const void* alpha, int b, int cin, int cout, int h, int w, int tiles_x,
                int tiles_y, int groups, cudaStream_t stream) {
  const int64_t blocks = static_cast<int64_t>(b) * groups * tiles_y * tiles_x;
  conv3x3_half_prelu_kernel<T, CO><<<static_cast<unsigned int>(blocks), kConvThreads, 0,
                                     stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wgt), static_cast<T*>(out),
      static_cast<const float*>(wh), static_cast<const float*>(ww),
      static_cast<const float*>(alpha), cin, cout, h, w, tiles_x, tiles_y, groups);
  return static_cast<int>(cudaGetLastError());
}

bool bad_grid(int b, int cout, int co_tile, int tiles_x, int tiles_y, int groups) {
  return b < 1 || cout < 1 || (co_tile != 4 && co_tile != 12) ||
         groups != (cout + co_tile - 1) / co_tile ||
         static_cast<int64_t>(b) * groups * tiles_y * tiles_x > 2147483647LL;
}

}  // namespace
}  // namespace hvi_cidnet

using namespace hvi_cidnet;

// P4. x: (b, cin, h, w), wgt: (cout, cin, 3, 3), out: (b, cout, h, w), all
// contiguous in one dtype; edge: 1 for the replication pad, 0 for zeros.
// co_tile .. groups: the plan of ops/conv3x3_cuda.py, tiles across and down
// and groups of co_tile output channels. fp32 (conv3x3_plan): co_tile 4 or
// 12; wpack unused, the rest 0. bf16 (conv3x3_mma_plan): co_tile <= 72
// channels a group, 8 x 32 tiles; wpack scratch for the packed weights
// (groups x ceil(cin / 16) x 9 x 8 ceil(co_tile / 8) x 16 elements), vec
// the output's store width in elements (it divides w), smem the dynamic
// shared memory, blocks the persistent grid (a multiple of groups), stages
// the ring's (3 to 8), resident 1 to keep every chunk's weights in shared
// memory, arm 0. Or bf16 by the CUDA-core arm (conv3x3_small_plan), arm 1:
// C_out <= 2, co_tile = C_out, one group, the same tiles, blocks, stages and
// smem; wpack, vec and resident unused. Returns a cudaError_t code,
// cudaErrorInvalidValue for a plan it cannot run.
extern "C" int conv3x3(const void* x, const void* wgt, void* wpack, void* out, int dtype, int b,
                       int cin, int cout, int h, int w, int edge, int co_tile, int tiles_x,
                       int tiles_y, int groups, int vec, int smem, int blocks, int stages,
                       int resident, int arm, cudaStream_t stream) {
  if (cin < 1 || h < 1 || w < 1 || b < 1 || cout < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kBFloat16 && arm == 1) {  // the CUDA-core arm: C_out <= 2, one group
    const int chunks = (cin + kChunk - 1) / kChunk;
    if (cout > 2 || co_tile != cout || groups != 1 ||
        tiles_x != (w + kMmaTileW - 1) / kMmaTileW || tiles_y != (h + kMmaTileH - 1) / kMmaTileH ||
        static_cast<int64_t>(b) * tiles_y * tiles_x * chunks > 2147483647LL || blocks < groups ||
        blocks % groups || stages < kMinStages || stages > kMaxStages ||
        smem != small_smem_bytes(co_tile, chunks, stages) || smem > 232448 ||
        reinterpret_cast<uintptr_t>(out) % 4)
      return static_cast<int>(cudaErrorInvalidValue);
    return cout == 1 ? launch_small<1>(x, wgt, out, b, cin, cout, h, w, edge, tiles_x, tiles_y,
                                       smem, blocks, stages, stream)
                     : launch_small<2>(x, wgt, out, b, cin, cout, h, w, edge, tiles_x, tiles_y,
                                       smem, blocks, stages, stream);
  }
  if (arm != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kBFloat16) {
    const int nt = (co_tile + 7) / 8, chunks = (cin + kChunk - 1) / kChunk;
    if (co_tile < 1 || nt > kMaxNT || groups != (cout + co_tile - 1) / co_tile ||
        tiles_x != (w + kMmaTileW - 1) / kMmaTileW || tiles_y != (h + kMmaTileH - 1) / kMmaTileH ||
        static_cast<int64_t>(b) * tiles_y * tiles_x * chunks > 2147483647LL || blocks < groups ||
        blocks % groups || stages < kMinStages || stages > kMaxStages ||
        (resident != 0 && resident != 1) ||
        smem != mma_smem_bytes(nt, stages, resident ? chunks : stages) || smem > 232448 ||
        (vec != 1 && vec != 2 && vec != 4 && vec != 8) || w % vec ||
        reinterpret_cast<uintptr_t>(out) % (2 * vec) || wpack == nullptr ||
        reinterpret_cast<uintptr_t>(wpack) % 16)
      return static_cast<int>(cudaErrorInvalidValue);
#define HVI_P4_NT(NTV)                                                                        \
  case NTV:                                                                                   \
    return launch_mma<NTV>(x, wgt, wpack, out, b, cin, cout, h, w, edge, co_tile, tiles_x,    \
                           tiles_y, groups, vec, smem, blocks, stages, resident, stream);
    switch (nt) {
      HVI_P4_NT(1)
      HVI_P4_NT(2)
      HVI_P4_NT(3)
      HVI_P4_NT(4)
      HVI_P4_NT(5)
      HVI_P4_NT(6)
      HVI_P4_NT(7)
      HVI_P4_NT(8)
      HVI_P4_NT(9)
    }
#undef HVI_P4_NT
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype != kFloat32 || bad_grid(b, cout, co_tile, tiles_x, tiles_y, groups) ||
      tiles_x != (w + kTileW - 1) / kTileW || tiles_y != (h + kTileH - 1) / kTileH)
    return static_cast<int>(cudaErrorInvalidValue);
  return co_tile == 4
             ? launch_conv<float, 4>(x, wgt, out, b, cin, cout, h, w, edge, tiles_x, tiles_y,
                                     groups, stream)
             : launch_conv<float, 12>(x, wgt, out, b, cin, cout, h, w, edge, tiles_x, tiles_y,
                                      groups, stream);
}

// P5. x: (b, cin, h, w), wgt: (cout, cin, 3, 3), out: (b, cout, h / 2,
// w / 2), contiguous, one dtype; wh, ww: K3's (3, h / 2) and (3, w / 2) fp32
// band weights (ops/resize.py:half_weights); alpha: one fp32 value on the
// device. co_tile .. groups: the plan of ops/conv3x3_cuda.py. fp32
// (half_plan): co_tile 4 or 12, 3 x 16 tiles; wpack unused, smem .. resident
// 0. bf16 (half_mma_plan): co_tile <= 72 channels a group, kDnTo x kDnTq
// tiles; wpack scratch for the packed weights (as P4's), smem the dynamic
// shared memory, blocks the persistent grid (a multiple of groups), stages
// the ring's (3 to 8), resident 1 to keep every chunk's weights in shared
// memory, threads a block (256, two an SM; 512 where one block takes an
// SM). Returns a cudaError_t code, cudaErrorInvalidValue for a plan it
// cannot run.
extern "C" int conv3x3_half_prelu(const void* x, const void* wgt, void* wpack, void* out,
                                  int dtype, const void* wh, const void* ww, const void* alpha,
                                  int b, int cin, int cout, int h, int w, int co_tile,
                                  int tiles_x, int tiles_y, int groups, int smem, int blocks,
                                  int stages, int resident, int threads, cudaStream_t stream) {
  if (cin < 1 || h < 2 || w < 2 || b < 1 || cout < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kBFloat16) {
    const int nt = (co_tile + 7) / 8, chunks = (cin + kChunk - 1) / kChunk;
    if (co_tile < 1 || nt > kMaxNT || groups != (cout + co_tile - 1) / co_tile ||
        tiles_x != (w / 2 + kDnTq - 1) / kDnTq || tiles_y != (h / 2 + kDnTo - 1) / kDnTo ||
        static_cast<int64_t>(b) * tiles_y * tiles_x * chunks > 2147483647LL || blocks < groups ||
        blocks % groups || stages < kMinStages || stages > kMaxStages ||
        (resident != 0 && resident != 1) ||
        smem != dn_smem_bytes(nt, stages, resident ? chunks : stages) || smem > 232448 ||
        (threads != 256 && threads != 512) || wpack == nullptr ||
        reinterpret_cast<uintptr_t>(wpack) % 16)
      return static_cast<int>(cudaErrorInvalidValue);
#define HVI_P5_NT(NTV)                                                                       \
  case NTV:                                                                                  \
    return threads == 256                                                                    \
               ? launch_half_mma<NTV, 256>(x, wgt, wpack, out, wh, ww, alpha, b, cin, cout, h, \
                                           w, co_tile, tiles_x, tiles_y, groups, smem, blocks, \
                                           stages, resident, stream)                         \
               : launch_half_mma<NTV, 512>(x, wgt, wpack, out, wh, ww, alpha, b, cin, cout, h, \
                                           w, co_tile, tiles_x, tiles_y, groups, smem, blocks, \
                                           stages, resident, stream);
    switch (nt) {
      HVI_P5_NT(1)
      HVI_P5_NT(2)
      HVI_P5_NT(3)
      HVI_P5_NT(4)
      HVI_P5_NT(5)
      HVI_P5_NT(6)
      HVI_P5_NT(7)
      HVI_P5_NT(8)
      HVI_P5_NT(9)
    }
#undef HVI_P5_NT
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype != kFloat32 || bad_grid(b, cout, co_tile, tiles_x, tiles_y, groups) ||
      tiles_x != (w / 2 + kHalfW - 1) / kHalfW || tiles_y != (h / 2 + kHalfH - 1) / kHalfH)
    return static_cast<int>(cudaErrorInvalidValue);
  return co_tile == 4 ? launch_half<float, 4>(x, wgt, out, wh, ww, alpha, b, cin, cout, h, w,
                                              tiles_x, tiles_y, groups, stream)
                      : launch_half<float, 12>(x, wgt, out, wh, ww, alpha, b, cin, cout, h, w,
                                               tiles_x, tiles_y, groups, stream);
}
