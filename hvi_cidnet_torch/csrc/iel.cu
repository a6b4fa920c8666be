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
// type, as the twin casts them (`w.to(x.dtype)`). Out-of-image taps read
// zeros: fma(w, 0, acc) == acc, as skipping them does.
//
// dw2's zero padding pads dw1's OUTPUT: t1 is zero wherever its position
// lies outside the image, not a value extrapolated by dw1 from the zero
// border of y (iel_pallas.py:127-136).
//
// Bound: memory bandwidth (read y once, write once). The first design (one
// block per 16 x 32 tile: load the halo tile, barrier, t1, barrier, store)
// ran at 10x that bound whatever the dtype or the instruction count: each
// block waited on its own loads, with ~7 KB in flight per SM where 3.35
// TB/s needs ~25 KB. This design keeps loads in flight while it computes:
//   - a long-lived block owns one plane, or a contiguous range of its rows
//     (the plan splits planes until the grid fills the card at batch 1),
//     and walks down it one band of `bh` full-width rows at a time;
//   - y arrives in a ring of kStages shared-memory stages by cp.async
//     (16-byte, L2-only). A full-width band is one contiguous span, so it
//     is copied as a flat span: the start is aligned down to 16 bytes (a
//     per-band shift puts aligned chunks on aligned stage offsets; rows of
//     the band outside the image are not copied), and a 16-byte chunk
//     that pokes out of the tensor is copied element by element, so
//     nothing reads past the allocation. Row pitches of 150-1280 bytes and planes that start only
//     4-byte aligned need nothing else. Band k + kStages - 1 is issued as
//     soon as band k - 1 is no longer read, so up to three bands are in
//     flight while one is computed;
//   - computation lags the stream by two rows: step k computes the t1 rows
//     whose y rows have landed (bands k - 1 and k), into a double-buffered
//     t1 band in shared memory (in T: t1 is rounded to T anyway), then
//     the output rows whose t1 rows are all there (the last two t1 rows of
//     step k - 1 are read from the other buffer). So y is read from device
//     memory once, plus two halo rows at each end of a row range;
//   - a thread owns a pair of neighbouring columns (or `pairs_per_thread`
//     pairs) of a group of rows and walks down it with a 3 x 4 register
//     window: per row, four shared loads of y and three aligned pair loads
//     of t1 feed two outputs of each conv, not eighteen loads. With the
//     loads in flight, instructions bound the kernel (fp32 runs as fast as
//     bf16), so the rows are unrolled, the inner loops step pointers and
//     mask with bit operations instead of branching. Column zero padding is
//     a mask on a clamped read for y and zero columns in the t1 buffers;
//     rows outside the image read a zero row;
//   - no division per element: one per block (plane, range) and one per
//     thread (group, column); everything else steps.
// The launch plan (band height, groups, threads, ranges, stage size, shared
// memory) comes from the host: ops/iel_cuda.py:iel_plan.
#include "common.cuh"

namespace hvi_cidnet {
namespace {

constexpr int kStages = 4;  // ops/iel_cuda.py:STAGES
constexpr int kMaxIelThreads = 512;

// nine taps at columns [off, off + 3) of three window rows, rows outer and
// columns inner, from 0
template <int kOff>
__device__ __forceinline__ float conv3x3(const float (&k)[9], const float (&a)[4],
                                         const float (&b)[4], const float (&c)[4]) {
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i) acc = fmaf(k[i], a[kOff + i], acc);
#pragma unroll
  for (int i = 0; i < 3; ++i) acc = fmaf(k[3 + i], b[kOff + i], acc);
#pragma unroll
  for (int i = 0; i < 3; ++i) acc = fmaf(k[6 + i], c[kOff + i], acc);
  return acc;
}

// two neighbouring elements at an even index, as one 4- or 8-byte access
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);  // each rounded as from_f32
}

template <typename T>
struct IelBlock {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // elements per 16 B

  const T* __restrict__ y;
  int64_t total;       // elements of y
  int64_t plane_off;   // first element of this block's plane
  int mis;             // y's misalignment to 16 B, in elements
  int w, bh;
  int ys;              // first row of band 0 (may be < 0)
  int y_hi;            // rows past the stream: min(h, last output row + 3)

  __device__ int band_first(int m) const { return ys + m * bh; }

  // A stage holds band m's rows at index (row - band_first(m)) * w + col +
  // shift(m): the shift puts 16-byte-aligned global chunks on 16-byte
  // boundaries. Rows outside the image are never loaded (reads are masked).
  __device__ int shift(int m) const {
    return static_cast<int>((plane_off + static_cast<int64_t>(band_first(m)) * w + mis) &
                            (kVec - 1));
  }

  // issue band m's copy into `stage` and commit it (an empty group past
  // the stream keeps the group count in step with the bands)
  __device__ void load(int m, T* stage) const {
    const int bf = band_first(m);
    const int r0 = max(bf, 0), r1 = min(bf + bh, y_hi);
    if (r0 < r1) {
      const int64_t e0 = plane_off + static_cast<int64_t>(r0) * w;
      const int64_t e1 = plane_off + static_cast<int64_t>(r1) * w;
      const int64_t first = e0 - ((e0 + mis) & (kVec - 1));  // aligned down
      T* dst = stage + (r0 - bf) * w + shift(m) - static_cast<int>(e0 - first);
      const int chunks = static_cast<int>((e1 - first + kVec - 1) / kVec);
      for (int i = threadIdx.x; i < chunks; i += blockDim.x) {
        const int64_t e = first + static_cast<int64_t>(i) * kVec;
        if (e >= 0 && e + kVec <= total) {
          cp_async16(dst + i * kVec, y + e);
        } else {  // the tensor's ragged first or last chunk
#pragma unroll
          for (int j = 0; j < kVec; ++j)
            dst[i * kVec + j] = (e + j >= 0 && e + j < total) ? y[e + j] : from_f32<T>(0.0f);
        }
      }
    }
    cp_async_commit();
  }
};

// v if keep, else +0.0f, without a branch
__device__ __forceinline__ float keep_or_zero(bool keep, float v) {
  return __int_as_float(__float_as_int(v) & -static_cast<int>(keep));
}

// at most 64 registers a thread: three 320-thread blocks fit an SM
template <typename T>
__global__ void __launch_bounds__(kMaxIelThreads, 2)
    iel_branch_kernel(const T* __restrict__ y, T* __restrict__ out, const T* __restrict__ w1,
                      const T* __restrict__ w2, int64_t total, int c, int h, int w, int bh,
                      int groups, int group_size, int pairs_per_thread, int ranges,
                      int rows_per_range, int stage_elems) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* stages = reinterpret_cast<T*>(smem_raw);
  // t1 column c sits at index c + 2 of a row of pitch tw (even, >= w + 5):
  // pairs (2i, 2i + 1) are aligned, and columns -2, -1, w, w + 1 ... are zero
  const int tw = (w + 6) & ~1;
  T* t1buf = stages + kStages * stage_elems;  // 2 x bh x tw
  T* zero_row = t1buf + 2 * bh * tw;          // w
  const T zero = from_f32<T>(0.0f);

  const int64_t plane = blockIdx.x / ranges;  // once per block
  const int range = static_cast<int>(blockIdx.x - plane * ranges);
  const int ob = range * rows_per_range;      // output rows [ob, oe)
  const int oe = min(h, ob + rows_per_range);
  const int ch = static_cast<int>(plane % c);

  IelBlock<T> blk;
  blk.y = y;
  blk.total = total;
  blk.plane_off = plane * h * w;
  blk.mis = static_cast<int>((reinterpret_cast<uintptr_t>(y) & 15) / sizeof(T));
  blk.w = w;
  blk.bh = bh;
  blk.ys = ob - 2;
  blk.y_hi = min(h, oe + 2);
  // step k writes output rows [ob - 4 + k * bh, ob - 4 + (k + 1) * bh)
  const int steps = (oe - ob + 4 + bh - 1) / bh;

  // the stream starts before anything else touches shared memory
#pragma unroll
  for (int m = 0; m < kStages - 1; ++m) blk.load(m, stages + m * stage_elems);

  float k1[9], k2[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    k1[i] = load_f32(w1, ch * 9 + i);
    k2[i] = load_f32(w2, ch * 9 + i);
  }
  for (int i = threadIdx.x; i < w; i += blockDim.x) zero_row[i] = zero;
  for (int i = threadIdx.x; i < 2 * bh; i += blockDim.x) {
    T* row = t1buf + i * tw;
    row[0] = row[1] = zero;
    for (int j = w + 2; j < tw; ++j) row[j] = zero;
  }

  // this thread: rows [r0, r0 + rg) of each band, column pairs (c0, c0 + 1)
  // with c0 = 2 * (q + m * group_size), m < pairs_per_thread (one division)
  const int g = threadIdx.x / group_size;
  const int q = threadIdx.x - g * group_size;
  const int rg = bh / groups;
  const int r0 = g * rg;
  const bool active = g < groups;
  T* dst = out + blk.plane_off;
  const bool out_pairs = (reinterpret_cast<uintptr_t>(dst) & (2 * sizeof(T) - 1)) == 0;

  int slot = 0;  // stage of band k
  for (int k = 0; k < steps; ++k) {
    cp_async_wait<kStages - 2>();  // band k has landed (this thread's copies)
    __syncthreads();               // ... everyone's; step k - 1's t1 reads are done
    const int prev_slot = slot == 0 ? kStages - 1 : slot - 1;
    const int first = blk.band_first(k);
    const T* y_cur = stages + slot * stage_elems + blk.shift(k) - first * w;  // + row * w
    const T* y_prev = stages + prev_slot * stage_elems + blk.shift(k - 1) - (first - bh) * w;
    T* t1_cur = t1buf + (k & 1) * bh * tw;
    const T* t1_prev = t1buf + ((k + 1) & 1) * bh * tw;

    // t1 rows t = first - 1 + r for r in [r0, r0 + rg): y rows t - 1 .. t + 1.
    // Rows outside the image read the zero row; so do rows before the
    // stream (only at k = 0, feeding rows that are not written).
    if (active) {
      auto y_row = [&](int row) -> const T* {
        const bool ok = row >= 0 && row < h && (k > 0 || row >= first);
        return ok ? (row >= first ? y_cur : y_prev) + row * w : zero_row;
      };
      for (int m = 0, c0 = 2 * q; m < pairs_per_thread && c0 < w; ++m, c0 += 2 * group_size) {
        // y columns c0 - 1 .. c0 + 2, zero outside the image (clamped reads)
        const bool has_l = c0 > 0, has_1 = c0 + 1 < w, has_2 = c0 + 2 < w;
        const int il = has_l ? c0 - 1 : c0, i1 = has_1 ? c0 + 1 : c0, i2 = has_2 ? c0 + 2 : c0;
        auto read = [&](const T* row, float (&v)[4]) {
          v[0] = keep_or_zero(has_l, load_f32(row, il));
          v[1] = load_f32(row, c0);
          v[2] = keep_or_zero(has_1, load_f32(row, i1));
          v[3] = keep_or_zero(has_2, load_f32(row, i2));
        };
        float a[4], b[4], cc[4];
        read(y_row(first + r0 - 2), a);
        read(y_row(first + r0 - 1), b);
        // rows r >= r0 >= 0 lie in band k: step a pointer, mask by the image
        const T* yp = y_cur + (first + r0) * w;
        T* tp = t1_cur + r0 * tw + c0 + 2;
        int t = first - 1 + r0;
#pragma unroll 2
        for (int r = r0; r < r0 + rg; ++r, yp += w, tp += tw, ++t) {
          // y row t + 1: the zero row above or below the image
          read(static_cast<unsigned>(t + 1) < static_cast<unsigned>(h) ? yp : zero_row, cc);
          // t1 outside the image, and column c0 + 1 past it, stay zero
          const bool in = t >= 0 && t < h;
          store_pair(tp, keep_or_zero(in, conv3x3<0>(k1, a, b, cc)),
                     keep_or_zero(in && has_1, conv3x3<1>(k1, a, b, cc)));
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            a[i] = b[i];
            b[i] = cc[i];
          }
        }
      }
    }
    __syncthreads();  // t1 of step k is complete; band k - 1 is no longer read

    // band k + kStages - 1 takes band k - 1's stage
    blk.load(k + kStages - 1, stages + prev_slot * stage_elems);

    // output rows o = first - 2 + r: t1 rows o - 1 .. o + 1, the first two
    // of them from step k - 1's buffer when r < 2
    if (active) {
      for (int m = 0, c0 = 2 * q; m < pairs_per_thread && c0 < w; ++m, c0 += 2 * group_size) {
        const bool has_1 = c0 + 1 < w;
        // t1 columns c0 - 1 .. c0 + 2: three aligned pairs from column c0 - 2
        auto read = [&](const T* row, float (&v)[4]) {
          const float2 p0 = load_pair(row), p1 = load_pair(row + 2), p2 = load_pair(row + 4);
          v[0] = p0.y;
          v[1] = p1.x;
          v[2] = p1.y;
          v[3] = p2.x;
        };
        auto t1_row = [&](int r) -> const T* {
          return (r >= 0 ? t1_cur + r * tw : t1_prev + (bh + r) * tw) + c0;
        };
        float a[4], b[4], cc[4];
        read(t1_row(r0 - 2), a);
        read(t1_row(r0 - 1), b);
        const T* tp = t1_cur + r0 * tw + c0;
        int o = first - 2 + r0;
        T* op = dst + static_cast<int64_t>(o) * w + c0;
#pragma unroll 2
        for (int r = r0; r < r0 + rg; ++r, tp += tw, ++o, op += w) {
          read(tp, cc);
          if (o >= ob && o < oe) {
            const float lo = round_through<T>(tanhf(round_through<T>(conv3x3<0>(k2, a, b, cc))));
            if (has_1) {
              const float hi =
                  round_through<T>(tanhf(round_through<T>(conv3x3<1>(k2, a, b, cc))));
              // the pair is aligned on even rows or even widths
              if (out_pairs && ((o & w & 1) == 0)) {
                store_pair(op, lo + b[1], hi + b[2]);
              } else {
                op[0] = from_f32<T>(lo + b[1]);
                op[1] = from_f32<T>(hi + b[2]);
              }
            } else {
              op[0] = from_f32<T>(lo + b[1]);
            }
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            a[i] = b[i];
            b[i] = cc[i];
          }
        }
      }
    }
    slot = slot == kStages - 1 ? 0 : slot + 1;
  }
  cp_async_wait<0>();  // no copy outlives the block
}

template <typename T>
int launch_iel_branch(const void* y, void* out, const void* w1, const void* w2, int64_t planes,
                      int c, int h, int w, int bh, int groups, int group_size,
                      int pairs_per_thread, int threads, int ranges, int rows_per_range,
                      int stage_elems, int smem_bytes, cudaStream_t stream) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  const int64_t blocks = planes * ranges;
  const int64_t need =
      (static_cast<int64_t>(kStages) * stage_elems + 2LL * bh * ((w + 6) & ~1) + w) * sizeof(T);
  const bool ok = bh >= 2 && groups >= 1 && bh % groups == 0 && group_size >= 1 &&
                  2LL * group_size * pairs_per_thread >= w &&
                  static_cast<int64_t>(groups) * group_size <= threads &&
                  threads <= kMaxIelThreads && ranges >= 1 && blocks <= 0x7fffffffLL &&
                  static_cast<int64_t>(ranges) * rows_per_range >= h &&
                  static_cast<int64_t>(ranges - 1) * rows_per_range < h &&
                  stage_elems % kVec == 0 && stage_elems >= bh * w + 2 * kVec &&
                  smem_bytes >= need && static_cast<int64_t>(h) * w <= 0x7fffffffLL;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const int err =
      raise_smem_cap(reinterpret_cast<const void*>(iel_branch_kernel<T>), smem_bytes);
  if (err) return err;
  iel_branch_kernel<T><<<static_cast<unsigned int>(blocks), threads, smem_bytes, stream>>>(
      static_cast<const T*>(y), static_cast<T*>(out), static_cast<const T*>(w1),
      static_cast<const T*>(w2), planes * h * w, c, h, w, bh, groups, group_size,
      pairs_per_thread, ranges, rows_per_range, stage_elems);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace hvi_cidnet

using namespace hvi_cidnet;

// y, out: (planes, h, w) contiguous with planes = B*C; w1, w2: (C, 9)
// depthwise taps in the activation type. bh .. smem_bytes: the launch plan
// of ops/iel_cuda.py:iel_plan. Returns a cudaError_t code.
extern "C" int iel_branch(const void* y, void* out, int dtype, const void* w1, const void* w2,
                          int64_t planes, int c, int h, int w, int bh, int groups,
                          int group_size, int pairs_per_thread, int threads, int ranges,
                          int rows_per_range, int stage_elems, int smem_bytes,
                          cudaStream_t stream) {
  if (c < 1 || planes < 1 || planes % c || h < 1 || w < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kFloat32)
    return launch_iel_branch<float>(y, out, w1, w2, planes, c, h, w, bh, groups, group_size,
                                    pairs_per_thread, threads, ranges, rows_per_range,
                                    stage_elems, smem_bytes, stream);
  if (dtype == kBFloat16)
    return launch_iel_branch<__nv_bfloat16>(y, out, w1, w2, planes, c, h, w, bh, groups,
                                            group_size, pairs_per_thread, threads, ranges,
                                            rows_per_range, stage_elems, smem_bytes, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
