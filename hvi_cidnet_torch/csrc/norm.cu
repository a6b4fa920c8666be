// K6: channel LayerNorm over dim 1 of NCHW activations: biased variance,
// eps inside the rsqrt (net/transformer_utils.py:24-29).
//
// Replaces the Pallas kernel hvi_cidnet_tpu/ops/norm_pallas.py:53
// _ln_kernel (call :90 in layer_norm_pallas :76). The plain twin is
// layer_norm_channels in hvi_cidnet_torch/ops/conv.py (dispatcher in
// ops/norm_cuda.py), whose two numeric forms this kernel repeats:
//
// * fp32: the exact two-pass form u = mean(x), s = mean((x-u)^2),
//   y = w * ((x - u) * rsqrt(s + eps)) + b;
// * bf16: fp32 statistics as E[x^2] - E[x]^2 clamped at 0, scale =
//   rsqrt(s + eps) and shift = u rounded to bf16, then an apply that rounds
//   after each of (x - shift), * scale, w *, + b, as the twin's bf16
//   elementwise ops do.
//
// Bound: memory bandwidth (x read once, y written once; ~8 flops an
// element). The first design (one pixel a thread, C scalar loads one after
// another) kept too few loads in flight. Here a block owns P = lanes * V
// pixels of one image:
//   - a thread takes V neighbouring pixels with one vector load per
//     channel (8 bytes where the plane pitch and the base allow it,
//     narrower where they do not: a bf16 plane of 50 x 75 is 7500 bytes;
//     16-byte loads ran slower on the card);
//   - the channel planes are spread over the block's `groups` thread
//     groups: thread (g, lane) loads channels g, g + groups, ... (CPT of
//     them, a template parameter, so the loop unrolls and every load issues
//     before the first use) and keeps them in registers: x is read once;
//   - per pixel, the groups' partial sums meet in shared memory and are
//     added in group order (a fixed order);
//   - the host's plan (ops/norm_cuda.py:layer_norm_plan) shrinks P until
//     the grid fills the card, at batch 1 as well as 8.
#include <type_traits>

#include "common.cuh"

namespace hvi_cidnet {
namespace {

constexpr int kMaxThreads = 512;

template <int BYTES>
struct VecOf;
template <>
struct VecOf<2> { using type = unsigned short; };
template <>
struct VecOf<4> { using type = unsigned int; };
template <>
struct VecOf<8> { using type = uint2; };

template <typename T, int V, int CPT>
__global__ void __launch_bounds__(kMaxThreads)
    layer_norm_kernel(const T* __restrict__ x, T* __restrict__ out,
                      const float* __restrict__ weight, const float* __restrict__ bias, int c,
                      int64_t hw, int64_t tiles, int log_lanes, int groups, float eps) {
  using Vec = typename VecOf<V * sizeof(T)>::type;
  extern __shared__ float red[];  // partials [2][groups][P], then totals [2][P]
  const int lanes = 1 << log_lanes, pixels = lanes * V;
  float* part = red;
  float* part2 = red + groups * pixels;
  float* tot = part2 + groups * pixels;
  float* tot2 = tot + pixels;

  const int64_t b = blockIdx.x / tiles;  // once per block
  const int64_t tile = blockIdx.x - b * tiles;
  const int lane = threadIdx.x & (lanes - 1), g = threadIdx.x >> log_lanes;
  const int64_t p0 = tile * pixels + lane * V;
  const bool active = p0 < hw;  // hw % V == 0: all V pixels or none
  const T* src = x + b * c * hw + p0;
  T* dst = out + b * c * hw + p0;

  Vec raw[CPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    const int ch = g + i * groups;
    if (active && ch < c) raw[i] = *reinterpret_cast<const Vec*>(src + ch * hw);
    else raw[i] = Vec{};
  }
  auto val = [&](int i, int v) { return load_f32(reinterpret_cast<const T*>(&raw[i]), v); };

  // totals over the groups, in group order, for the block's pixels
  auto reduce = [&](const float* p, float* t) {
    __syncthreads();
    for (int px = threadIdx.x; px < pixels; px += blockDim.x) {
      float s = 0.0f;
      for (int gg = 0; gg < groups; ++gg) s += p[gg * pixels + px];
      t[px] = s;
    }
    __syncthreads();
  };

  float sum[V], sq[V];
#pragma unroll
  for (int v = 0; v < V; ++v) sum[v] = sq[v] = 0.0f;
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
#pragma unroll
    for (int v = 0; v < V; ++v) {  // absent channels hold +0: the sums do not move
      const float f = val(i, v);
      sum[v] += f;
      if constexpr (!std::is_same<T, float>::value) sq[v] += f * f;
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    part[g * pixels + lane * V + v] = sum[v];
    if constexpr (!std::is_same<T, float>::value) part2[g * pixels + lane * V + v] = sq[v];
  }
  reduce(part, tot);

  if constexpr (std::is_same<T, float>::value) {
    float u[V], ss[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      u[v] = tot[lane * V + v] / c;
      ss[v] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      if (g + i * groups < c) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float d = val(i, v) - u[v];
          ss[v] += d * d;
        }
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) part2[g * pixels + lane * V + v] = ss[v];
    reduce(part2, tot2);
    if (!active) return;
    float r[V];
#pragma unroll
    for (int v = 0; v < V; ++v) r[v] = rsqrtf(tot2[lane * V + v] / c + eps);
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int ch = g + i * groups;
      if (ch < c) {
        const float w = weight[ch], bb = bias[ch];
        Vec res;
        float* o = reinterpret_cast<float*>(&res);
#pragma unroll
        for (int v = 0; v < V; ++v) o[v] = w * ((val(i, v) - u[v]) * r[v]) + bb;
        *reinterpret_cast<Vec*>(dst + ch * hw) = res;
      }
    }
  } else {
    reduce(part2, tot2);
    if (!active) return;
    float scale[V], shift[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float u = tot[lane * V + v] / c;
      const float s = fmaxf(tot2[lane * V + v] / c - u * u, 0.0f);
      scale[v] = round_through<T>(rsqrtf(s + eps));
      shift[v] = round_through<T>(u);
    }
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int ch = g + i * groups;
      if (ch < c) {
        const float w = round_through<T>(weight[ch]), bb = round_through<T>(bias[ch]);
        Vec res;
        T* o = reinterpret_cast<T*>(&res);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float d = round_through<T>(val(i, v) - shift[v]);
          const float t = round_through<T>(d * scale[v]);
          const float y = round_through<T>(w * t);
          o[v] = from_f32<T>(y + bb);
        }
        *reinterpret_cast<Vec*>(dst + ch * hw) = res;
      }
    }
  }
}

template <typename T, int V>
int launch_v(const T* x, T* out, const float* weight, const float* bias, int64_t b, int c,
             int64_t hw, float eps, int lanes, int groups, int cpt, int smem, cudaStream_t stream) {
  const int64_t pixels = static_cast<int64_t>(lanes) * V;
  const int64_t tiles = (hw + pixels - 1) / pixels;
  const int threads = lanes * groups;
  const int log_lanes = __builtin_ctz(static_cast<unsigned>(lanes));
  auto go = [&](auto kernel) {
    const int err = raise_smem_cap(reinterpret_cast<const void*>(kernel), smem);
    if (err) return err;
    kernel<<<static_cast<unsigned int>(b * tiles), threads, smem, stream>>>(
        x, out, weight, bias, c, hw, tiles, log_lanes, groups, eps);
    return static_cast<int>(cudaGetLastError());
  };
  return cpt == 9 ? go(layer_norm_kernel<T, V, 9>) : go(layer_norm_kernel<T, V, 18>);
}

template <typename T>
int launch_layer_norm(const void* x, void* out, const void* weight, const void* bias, int64_t b,
                      int c, int64_t hw, float eps, int vec, int lanes, int groups, int cpt,
                      int smem, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  const float* w = static_cast<const float*>(weight);
  const float* bb = static_cast<const float*>(bias);
  switch (vec) {
    case 1: return launch_v<T, 1>(xp, op, w, bb, b, c, hw, eps, lanes, groups, cpt, smem, stream);
    case 2: return launch_v<T, 2>(xp, op, w, bb, b, c, hw, eps, lanes, groups, cpt, smem, stream);
    default:
      if constexpr (sizeof(T) == 2)
        return launch_v<T, 4>(xp, op, w, bb, b, c, hw, eps, lanes, groups, cpt, smem, stream);
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace hvi_cidnet

using namespace hvi_cidnet;

// x, out: (b, c, hw) contiguous; weight, bias: c fp32 values on the device.
// vec .. smem: the plan of ops/norm_cuda.py:layer_norm_plan (pixels per
// thread, lanes per channel row, thread groups, channels per thread, shared
// memory in bytes). Returns a cudaError_t code, cudaErrorInvalidValue for a
// plan it cannot run.
extern "C" int layer_norm_channels(const void* x, void* out, int dtype, const void* weight,
                                   const void* bias, int64_t b, int c, int64_t hw, float eps,
                                   int vec, int lanes, int groups, int cpt, int smem,
                                   cudaStream_t stream) {
  const int itemsize = dtype == kFloat32 ? 4 : 2;
  const int64_t pixels = static_cast<int64_t>(lanes) * vec;
  const int64_t threads = static_cast<int64_t>(lanes) * groups;
  const uintptr_t align = static_cast<uintptr_t>(vec) * itemsize;
  const bool ok =
      (dtype == kFloat32 || dtype == kBFloat16) && c >= 1 && c <= 256 && b >= 1 && hw >= 1 &&
      (vec == 1 || vec == 2 || vec == 4) && vec * itemsize <= 8 && hw % vec == 0 &&
      reinterpret_cast<uintptr_t>(x) % align == 0 && reinterpret_cast<uintptr_t>(out) % align == 0 &&
      lanes >= 1 && (lanes & (lanes - 1)) == 0 && groups >= 1 && threads % 32 == 0 &&
      threads <= kMaxThreads && (cpt == 9 || cpt == 18) &&
      static_cast<int64_t>(groups) * cpt >= c &&
      smem == (2 * groups * pixels + 2 * pixels) * 4 && smem <= 232448 &&
      b * ((hw + pixels - 1) / pixels) <= 0x7fffffffLL;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kFloat32)
    return launch_layer_norm<float>(x, out, weight, bias, b, c, hw, eps, vec, lanes, groups, cpt,
                                    smem, stream);
  return launch_layer_norm<__nv_bfloat16>(x, out, weight, bias, b, c, hw, eps, vec, lanes, groups,
                                          cpt, smem, stream);
}
