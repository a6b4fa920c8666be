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
// accumulate in fp32; P5 keeps the conv rows in fp32 through the x0.5 and
// the PReLU and rounds once at the store.
//
// Bound: operations, 2 * C_in * 9 flops per output channel and pixel on the
// fp32 CUDA cores (~1,300x the card's balance point at C_in = 36 in bf16);
// P5 also saves writing the full-resolution conv output and reading it back
// for the x0.5 (K3's input), some 5/4 of the conv's output bytes. cuDNN runs
// the same conv on the tensor cores: this direct kernel is expected to lose
// to it; a tensor-core version is later work.
//
// Design: one core, `conv_region`. A block of 256 threads computes a
// rectangle of conv outputs for CO (4 or 12) output channels, one pixel a
// thread, CO fp32 accumulators each. It walks the input channels 8 at a
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
// K3 and its plain version, then the PReLU.
//
// Occupancy: P5 is held to 64 registers (four blocks an SM, a few bytes of
// spills), which ran ~8% faster than its free 80 at every site on an
// NVIDIA H100 80GB HBM3 at 700 W; the same cap on P4 (80 of its 128
// registers, three blocks an SM) ran ~6% slower over its sites (PERF.md
// section 6).
#include "common.cuh"

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
// co_tile .. groups: the plan of ops/conv3x3_cuda.py:conv3x3_plan (output
// channels a block, tiles across and down, channel groups). Returns a
// cudaError_t code, cudaErrorInvalidValue for a plan it cannot run.
extern "C" int conv3x3(const void* x, const void* wgt, void* out, int dtype, int b, int cin,
                       int cout, int h, int w, int edge, int co_tile, int tiles_x, int tiles_y,
                       int groups, cudaStream_t stream) {
  if (cin < 1 || h < 1 || w < 1 || bad_grid(b, cout, co_tile, tiles_x, tiles_y, groups) ||
      tiles_x != (w + kTileW - 1) / kTileW || tiles_y != (h + kTileH - 1) / kTileH)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kFloat32)
    return co_tile == 4
               ? launch_conv<float, 4>(x, wgt, out, b, cin, cout, h, w, edge, tiles_x, tiles_y,
                                       groups, stream)
               : launch_conv<float, 12>(x, wgt, out, b, cin, cout, h, w, edge, tiles_x, tiles_y,
                                        groups, stream);
  if (dtype == kBFloat16)
    return co_tile == 4 ? launch_conv<__nv_bfloat16, 4>(x, wgt, out, b, cin, cout, h, w, edge,
                                                        tiles_x, tiles_y, groups, stream)
                        : launch_conv<__nv_bfloat16, 12>(x, wgt, out, b, cin, cout, h, w, edge,
                                                         tiles_x, tiles_y, groups, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// P5. x: (b, cin, h, w), wgt: (cout, cin, 3, 3), out: (b, cout, h / 2,
// w / 2), contiguous, one dtype; wh, ww: K3's (3, h / 2) and (3, w / 2) fp32
// band weights (ops/resize.py:half_weights); alpha: one fp32 value on the
// device. co_tile .. groups: ops/conv3x3_cuda.py:half_plan.
extern "C" int conv3x3_half_prelu(const void* x, const void* wgt, void* out, int dtype,
                                  const void* wh, const void* ww, const void* alpha, int b,
                                  int cin, int cout, int h, int w, int co_tile, int tiles_x,
                                  int tiles_y, int groups, cudaStream_t stream) {
  if (cin < 1 || h < 2 || w < 2 || bad_grid(b, cout, co_tile, tiles_x, tiles_y, groups) ||
      tiles_x != (w / 2 + kHalfW - 1) / kHalfW || tiles_y != (h / 2 + kHalfH - 1) / kHalfH)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kFloat32)
    return co_tile == 4 ? launch_half<float, 4>(x, wgt, out, wh, ww, alpha, b, cin, cout, h, w,
                                                tiles_x, tiles_y, groups, stream)
                        : launch_half<float, 12>(x, wgt, out, wh, ww, alpha, b, cin, cout, h, w,
                                                 tiles_x, tiles_y, groups, stream);
  if (dtype == kBFloat16)
    return co_tile == 4
               ? launch_half<__nv_bfloat16, 4>(x, wgt, out, wh, ww, alpha, b, cin, cout, h, w,
                                               tiles_x, tiles_y, groups, stream)
               : launch_half<__nv_bfloat16, 12>(x, wgt, out, wh, ww, alpha, b, cin, cout, h, w,
                                                tiles_x, tiles_y, groups, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
