// Host side of the tensor (TMA) copies: cuTensorMapEncodeTiled looked up
// through the runtime (no -lcuda), one builder of 4-d maps over a strided
// view, and its two users' shapes: the (d, t, h, b) map of a 16-bit or
// f32 (B, H, T, D) view (the flash-attention kernels) and the (inner,
// rows, n) map of an (N, C, M) tensor (conv_fused.cu).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// A 4-d map of a view of `esize`-byte elements: dims[0] innermost (unit
// stride), elem[i] the element stride of dims[i + 1], read or written in
// boxes of box[0..3]. A dimension of size 1 gets a stride TMA accepts (it
// is never stepped). False when TMA cannot describe the view: the base is
// not 16-byte aligned, or a stride is not a multiple of 16 bytes.
inline bool make_map_4d(CUtensorMap* map, CUtensorMapDataType type, int esize,
                        const void* ptr, const long long* dims,
                        const long long* elem, const int* box,
                        CUtensorMapSwizzle swizzle) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16) return false;
  cuuint64_t gdims[4], strides[3];
  cuuint32_t gbox[4];
  for (int i = 0; i < 4; ++i) {
    gdims[i] = static_cast<cuuint64_t>(dims[i]);
    gbox[i] = static_cast<cuuint32_t>(box[i]);
  }
  cuuint64_t extent = gdims[0] * esize;
  for (int i = 0; i < 3; ++i) {
    cuuint64_t bytes = static_cast<cuuint64_t>(elem[i]) * esize;
    if (gdims[i + 1] == 1) bytes = (extent + 15) / 16 * 16;
    if (bytes % 16) return false;
    strides[i] = bytes;
    extent = bytes * gdims[i + 1];
  }
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(map, type, 4, const_cast<void*>(ptr), gdims, strides, gbox,
                step, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The 4-d map (d, t, h, b) of a (B, H, T, D) view of `esize`-byte elements
// (16-bit by default, or f32) with element strides st, sh, sb, read or
// written in 128-byte-swizzled boxes of one 128-byte row (64 16-bit or 32
// f32 values) x `rows`.
inline bool make_map(CUtensorMap* map, CUtensorMapDataType type,
                     const void* ptr, int D, int T, int H, int B,
                     long long st, long long sh, long long sb, int rows,
                     int esize = 2) {
  const long long dims[4] = {D, T, H, B}, elem[3] = {st, sh, sb};
  const int box[4] = {128 / esize, rows, 1, 1};
  return make_map_4d(map, type, esize, ptr, dims, elem, box,
                     CU_TENSOR_MAP_SWIZZLE_128B);
}

// The map (inner, rows, n, 1) of a contiguous (N, C, M) tensor seen in
// groups of `group` channels: row r holds channels group * r .. group * r +
// group - 1 back to back (inner = group * M elements), so its stride is
// group * M elements, a multiple of 16 bytes where the tensor's own rows
// are not. Boxes of box_inner x box_rows (x 1 x 1); group = 1 is the tensor
// as it lies. C % group == 0.
inline bool make_map_ncm(CUtensorMap* map, CUtensorMapDataType type,
                         int esize, const void* ptr, int N, int C, int M,
                         int group, int box_inner, int box_rows,
                         CUtensorMapSwizzle swizzle) {
  const long long inner = static_cast<long long>(group) * M;
  const long long dims[4] = {inner, C / group, N, 1};
  const long long elem[3] = {inner, static_cast<long long>(C) * M, 0};
  const int box[4] = {box_inner, box_rows, 1, 1};
  return make_map_4d(map, type, esize, ptr, dims, elem, box, swizzle);
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
template <>
struct TmaType<float> {
  static constexpr CUtensorMapDataType value = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};

}  // namespace mxt
