// Host side of the tensor (TMA) copies of the flash-attention kernels:
// cuTensorMapEncodeTiled looked up through the runtime (no -lcuda), and the
// 4-d (d, t, h, b) map of a 16-bit (B, H, T, D) view that
// flash_attention_fwd.cu and flash_attention_bwd.cu both build.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace mxt {

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled by the runtime's entry-point query (no -lcuda)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-d map (d, t, h, b) of a 16-bit (B, H, T, D) view with element strides
// st, sh, sb, read or written in boxes of 64 x `rows` with the 128-byte
// swizzle. A dimension of size 1 gets a stride TMA accepts (it is never
// stepped). False when TMA cannot describe the view: the base is not 16-byte
// aligned, or a stride is not a multiple of 16 bytes.
inline bool make_map(CUtensorMap* map, CUtensorMapDataType type,
                     const void* ptr, int D, int T, int H, int B,
                     long long st, long long sh, long long sb, int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const long long elem[3] = {st, sh, sb};
  cuuint64_t strides[3];
  cuuint64_t extent = static_cast<cuuint64_t>(D) * 2;
  for (int i = 0; i < 3; ++i) {
    cuuint64_t bytes = static_cast<cuuint64_t>(elem[i]) * 2;
    if (dims[i + 1] == 1) bytes = (extent + 15) / 16 * 16;
    strides[i] = bytes;
    extent = bytes * dims[i + 1];
  }
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(map, type, 4, const_cast<void*>(ptr), dims, strides, box,
                step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T>
struct TmaType;
template <>
struct TmaType<__nv_bfloat16> {
  static constexpr CUtensorMapDataType value = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <>
struct TmaType<__half> {
  static constexpr CUtensorMapDataType value = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
};

}  // namespace mxt
