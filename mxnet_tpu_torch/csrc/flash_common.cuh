// Pieces shared by the flash-attention forward and backward kernels (and
// conv_fused.cu): tile sizes, bf16 / fp16 packing, the dynamic shared
// memory limit of a kernel.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mxt {

constexpr int BM = 64;            // query rows per tile
constexpr int BN = 64;            // keys per tile
constexpr float NEG_BIG = -1e30f; // the TPU kernel's _NEG_INF

template <typename T> struct Half;

template <> struct Half<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  static __device__ __forceinline__ uint16_t bits(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
};

template <> struct Half<__half> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  static __device__ __forceinline__ uint16_t bits(float x) {
    return __half_as_ushort(__float2half_rn(x));
  }
};

template <typename K>
cudaError_t set_smem(K kern, size_t smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace mxt
