// K7: the IEL gate branch, tanh(dw2(dw1(y))) + dw1(y), in one pass over NCHW
// activations. dw1 and dw2 are depthwise 3x3 convs with zero SAME padding.
//
// Replaces the Pallas kernel hvi_cidnet_tpu/ops/iel_pallas.py:72
// _branch_kernel (call :178 in iel_branch_pallas :145). The plain twin is
// iel_branch in hvi_cidnet_torch/ops/iel.py (dispatcher in ops/iel_cuda.py):
// two dwconv3x3 calls, tanh and an add (reference net/LCA.py:53-60).
//
// Arithmetic, as the twin runs it on the card: each conv accumulates its
// nine taps in fp32 as fma(w, x, acc), rows outer and columns inner, from 0
// (PyTorch's depthwise kernel, conv_depthwise2d_forward_kernel, compiles
// its `value += w * x` to the same FMA chain), then rounds once to the
// activation type; tanh runs in fp32 on the rounded dw2 output and rounds;
// the residual add rounds once more. The weights come in the activation
// type, as the twin casts them (`w.to(x.dtype)`).
//
// dw2's zero padding pads dw1's OUTPUT: t1 is zero wherever its position
// lies outside the image, not a value extrapolated by dw1 from the zero
// border of y (iel_pallas.py:127-136).
//
// Bound: memory bandwidth. The twin makes about five passes over the
// hidden-width tensor (2.66x the block width); this kernel reads y once,
// plus the halo, and writes once. One block owns one (plane, kTileH x
// kTileW) output tile: it stages the tile plus a 2-pixel halo of y in shared
// memory (zeros outside the image), computes t1 on the tile plus a 1-pixel
// ring into shared memory, then dw2, tanh and the add. Halo reads are
// (kTileH+4)(kTileW+4) / (kTileH kTileW) = 1.41x the tile and mostly hit L2.
#include "common.cuh"

namespace hvi_cidnet {
namespace {

constexpr int kTileH = 16;
constexpr int kTileW = 32;
constexpr int kIelThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kIelThreads)
    iel_branch_kernel(const T* __restrict__ y, T* __restrict__ out, const T* __restrict__ w1,
                      const T* __restrict__ w2, int c, int h, int w, int tiles_w,
                      int64_t tiles_per_plane) {
  __shared__ float s_y[kTileH + 4][kTileW + 4];
  __shared__ float s_t1[kTileH + 2][kTileW + 2];

  const int64_t plane = blockIdx.x / tiles_per_plane;
  const int tile = static_cast<int>(blockIdx.x - plane * tiles_per_plane);
  const int y0 = (tile / tiles_w) * kTileH;
  const int x0 = (tile % tiles_w) * kTileW;
  const int ch = static_cast<int>(plane % c);
  const T* src = y + plane * h * w;

  float k1[9], k2[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    k1[i] = load_f32(w1, ch * 9 + i);
    k2[i] = load_f32(w2, ch * 9 + i);
  }

  // y over rows [y0-2, y0+kTileH+2) x cols [x0-2, x0+kTileW+2), zero outside
  for (int i = threadIdx.x; i < (kTileH + 4) * (kTileW + 4); i += kIelThreads) {
    const int r = i / (kTileW + 4), cc = i % (kTileW + 4);
    const int gy = y0 - 2 + r, gx = x0 - 2 + cc;
    const bool in = gy >= 0 && gy < h && gx >= 0 && gx < w;
    s_y[r][cc] = in ? load_f32(src, static_cast<int64_t>(gy) * w + gx) : 0.0f;
  }
  __syncthreads();

  // t1 = dw1(y) over rows [y0-1, y0+kTileH+1) x cols [x0-1, x0+kTileW+1),
  // rounded to T; zero outside the image (dw2's padding)
  for (int i = threadIdx.x; i < (kTileH + 2) * (kTileW + 2); i += kIelThreads) {
    const int r = i / (kTileW + 2), cc = i % (kTileW + 2);
    const int gy = y0 - 1 + r, gx = x0 - 1 + cc;
    float t = 0.0f;
    if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
      float acc = 0.0f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) acc = fmaf(k1[dy * 3 + dx], s_y[r + dy][cc + dx], acc);
      t = round_through<T>(acc);
    }
    s_t1[r][cc] = t;
  }
  __syncthreads();

  T* dst = out + plane * h * w;
  for (int i = threadIdx.x; i < kTileH * kTileW; i += kIelThreads) {
    const int r = i / kTileW, cc = i % kTileW;
    const int gy = y0 + r, gx = x0 + cc;
    if (gy >= h || gx >= w) continue;
    float acc = 0.0f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) acc = fmaf(k2[dy * 3 + dx], s_t1[r + dy][cc + dx], acc);
    const float th = round_through<T>(tanhf(round_through<T>(acc)));
    dst[static_cast<int64_t>(gy) * w + gx] = from_f32<T>(th + s_t1[r + 1][cc + 1]);
  }
}

template <typename T>
int launch_iel_branch(const void* y, void* out, const void* w1, const void* w2, int64_t planes,
                      int c, int h, int w, cudaStream_t stream) {
  const int tiles_w = (w + kTileW - 1) / kTileW;
  const int64_t tiles = static_cast<int64_t>(tiles_w) * ((h + kTileH - 1) / kTileH);
  const int64_t blocks = planes * tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  iel_branch_kernel<T><<<static_cast<unsigned int>(blocks), kIelThreads, 0, stream>>>(
      static_cast<const T*>(y), static_cast<T*>(out), static_cast<const T*>(w1),
      static_cast<const T*>(w2), c, h, w, tiles_w, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace hvi_cidnet

using namespace hvi_cidnet;

// y, out: (planes, h, w) contiguous with planes = B*C; w1, w2: (C, 9)
// depthwise taps in the activation type. Returns cudaGetLastError().
extern "C" int iel_branch(const void* y, void* out, int dtype, const void* w1, const void* w2,
                          int64_t planes, int c, int h, int w, cudaStream_t stream) {
  if (c < 1 || planes < 1 || planes % c || h < 1 || w < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kFloat32) return launch_iel_branch<float>(y, out, w1, w2, planes, c, h, w, stream);
  if (dtype == kBFloat16)
    return launch_iel_branch<__nv_bfloat16>(y, out, w1, w2, planes, c, h, w, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
