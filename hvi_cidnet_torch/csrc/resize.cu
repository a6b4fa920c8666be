// K3 and K4: bilinear x0.5 (+ PReLU) and bilinear x2, align_corners=True,
// on NCHW activations, one thread per output pixel.
//
// Replaces the Pallas kernels of hvi_cidnet_tpu/ops/resize_pallas.py:
//   K3 _half_kernel   (:76, call :120 in scale_half_pallas :107; model
//      dispatcher half_prelu :238) -> resize_half_prelu below;
//   K4 _double_kernel (:143, call :184 in scale_double_pallas :171; model
//      dispatcher double_bilinear :273) -> resize_double below.
// Reference semantics: nn.UpsamplingBilinear2d(0.5 / 2) in NormDownsample /
// NormUpsample (net/transformer_utils.py:38-40, 57-59). The plain twins are
// half_prelu_plain / double_bilinear_plain in ops/resize_cuda.py, which run
// the same taps and weights in the same order (bitwise equal in fp32).
//
// What carries over from the TPU kernels is the arithmetic, not the layout:
// per axis the x0.5 output i reads source rows {2i, 2i+1, 2i+2} and the x2
// output reads two neighbours of i/2; the weights are the exact rows of the
// dense align_corners interpolation matrix (ops/resize.py:_band_weights),
// computed once per size on the host in float64 and uploaded as fp32, so
// they are bitwise the JAX package's weights. The H pass runs first, then
// the W pass, both in fp32, with one rounding to the output type (and the
// PReLU of K3 applied in fp32 before it), as the Pallas kernels do.
//
// Bound: memory bandwidth. K3 reads each input element about once (the 3x3
// tap windows of neighbouring outputs overlap in L1/L2) and writes a quarter
// as many: ~1.25 x input bytes per call (2.5 bytes per input element in bf16,
// 5 in fp32), for 12 multiply-adds per output. K4 reads the input once and
// writes four times as much: ~5 x input bytes, 6 multiply-adds per output.
// Neighbouring threads take neighbouring output columns, so loads and stores
// coalesce. Indices are 64-bit: (128, 36, 400, 600) is 1.1e9 elements.
//
// Edge taps: K3's third tap on the last output row/column (source 2i+2 == H)
// and K4's outer taps at the borders have weight 0 and fall outside the
// image; the index is clamped to the edge so nothing reads past the tensor
// (0 * NaN from an out-of-bounds read would be NaN).
#include "common.cuh"

namespace hvi_cidnet {
namespace {

template <typename T>
__global__ void half_prelu_kernel(const T* __restrict__ x, T* __restrict__ out,
                                  const float* __restrict__ wh, const float* __restrict__ ww,
                                  const float* __restrict__ alpha_ptr, int64_t n, int64_t h,
                                  int64_t w) {
  const int64_t ho = h / 2, wo = w / 2;
  const int64_t total = n * ho * wo;
  const float alpha = *alpha_ptr;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t o = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; o < total;
       o += stride) {
    const int64_t plane = o / (ho * wo);
    const int64_t rem = o - plane * ho * wo;
    const int64_t i = rem / wo;
    const int64_t j = rem - i * wo;
    const T* src = x + plane * h * w;

    const int64_t rows[3] = {2 * i, 2 * i + 1, min64(2 * i + 2, h - 1)};
    const int64_t cols[3] = {2 * j, 2 * j + 1, min64(2 * j + 2, w - 1)};
    const float ha = wh[i], hb = wh[ho + i], hc = wh[2 * ho + i];
    const float wa = ww[j], wb = ww[wo + j], wc = ww[2 * wo + j];

    float mid[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      mid[c] = load_f32(src, rows[0] * w + cols[c]) * ha +
               load_f32(src, rows[1] * w + cols[c]) * hb +
               load_f32(src, rows[2] * w + cols[c]) * hc;
    }
    const float v = mid[0] * wa + mid[1] * wb + mid[2] * wc;
    out[o] = from_f32<T>(fmaxf(v, 0.0f) + alpha * fminf(v, 0.0f));
  }
}

template <typename T>
__global__ void double_kernel(const T* __restrict__ x, T* __restrict__ out,
                              const float* __restrict__ wh, const float* __restrict__ ww,
                              int64_t n, int64_t h, int64_t w) {
  const int64_t oh = 2 * h, ow = 2 * w;
  const int64_t total = n * oh * ow;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t o = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; o < total;
       o += stride) {
    const int64_t plane = o / (oh * ow);
    const int64_t rem = o - plane * oh * ow;
    const int64_t oy = rem / ow;
    const int64_t ox = rem - oy * ow;
    const T* src = x + plane * h * w;

    // weights per source index j: [ae | be | ao | bo], each of length h (w);
    // even outputs 2j take (j-1, j) with (ae, be), odd outputs 2j+1 take
    // (j, j+1) with (ao, bo)
    const int64_t jy = oy >> 1, jx = ox >> 1;
    int64_t r0, r1, c0, c1;
    float h0, h1, w0, w1;
    if ((oy & 1) == 0) {
      r0 = max64(jy - 1, 0); r1 = jy; h0 = wh[jy]; h1 = wh[h + jy];
    } else {
      r0 = jy; r1 = min64(jy + 1, h - 1); h0 = wh[2 * h + jy]; h1 = wh[3 * h + jy];
    }
    if ((ox & 1) == 0) {
      c0 = max64(jx - 1, 0); c1 = jx; w0 = ww[jx]; w1 = ww[w + jx];
    } else {
      c0 = jx; c1 = min64(jx + 1, w - 1); w0 = ww[2 * w + jx]; w1 = ww[3 * w + jx];
    }
    const float m0 = load_f32(src, r0 * w + c0) * h0 + load_f32(src, r1 * w + c0) * h1;
    const float m1 = load_f32(src, r0 * w + c1) * h0 + load_f32(src, r1 * w + c1) * h1;
    out[o] = from_f32<T>(m0 * w0 + m1 * w1);
  }
}

template <typename T>
int launch_half_prelu(const void* x, void* out, const void* wh, const void* ww,
                      const void* alpha, int64_t n, int64_t h, int64_t w, cudaStream_t stream) {
  half_prelu_kernel<T><<<grid_for(n * (h / 2) * (w / 2)), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<const float*>(wh),
      static_cast<const float*>(ww), static_cast<const float*>(alpha), n, h, w);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_double(const void* x, void* out, const void* wh, const void* ww, int64_t n, int64_t h,
                  int64_t w, cudaStream_t stream) {
  double_kernel<T><<<grid_for(n * 4 * h * w), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<const float*>(wh),
      static_cast<const float*>(ww), n, h, w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace hvi_cidnet

using namespace hvi_cidnet;

// x: (n, h, w) contiguous planes (n = B*C); out: (n, h/2, w/2); wh: 3*(h/2)
// fp32 weights [a|b|c]; ww: 3*(w/2); alpha: one fp32 PReLU slope on the
// device. Returns cudaGetLastError().
extern "C" int resize_half_prelu(const void* x, void* out, int dtype, const void* wh,
                                 const void* ww, const void* alpha, int64_t n, int64_t h,
                                 int64_t w, cudaStream_t stream) {
  if (dtype == kFloat32) return launch_half_prelu<float>(x, out, wh, ww, alpha, n, h, w, stream);
  if (dtype == kBFloat16)
    return launch_half_prelu<__nv_bfloat16>(x, out, wh, ww, alpha, n, h, w, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// x: (n, h, w); out: (n, 2h, 2w); wh: 4*h fp32 weights [ae|be|ao|bo]; ww: 4*w.
extern "C" int resize_double(const void* x, void* out, int dtype, const void* wh,
                             const void* ww, int64_t n, int64_t h, int64_t w,
                             cudaStream_t stream) {
  if (dtype == kFloat32) return launch_double<float>(x, out, wh, ww, n, h, w, stream);
  if (dtype == kBFloat16) return launch_double<__nv_bfloat16>(x, out, wh, ww, n, h, w, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
