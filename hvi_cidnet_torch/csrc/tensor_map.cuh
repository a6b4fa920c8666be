// The TMA unit's tensor maps: libcuda's encoder, shared by the kernels that
// copy through tensor maps (P6 in im2col_gemm.cu, the relayout in relayout.cu).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

namespace hvi_cidnet {
namespace {

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime (no libcuda link)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

}  // namespace
}  // namespace hvi_cidnet
