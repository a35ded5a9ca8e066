// Pieces shared by the flash-attention forward and backward kernels:
// tile sizes, the 16-bit tensor-core product (mma.sync m16n8k16, f32
// accumulate) for bf16 and fp16, and the shared-memory tile loaders.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mxt {

constexpr int BM = 64;            // query rows per tile
constexpr int BN = 64;            // keys per tile
constexpr int PAD = 8;            // shared-memory row padding (elements)
constexpr float NEG_BIG = -1e30f; // the TPU kernel's _NEG_INF

template <typename T> struct Half;

template <> struct Half<__nv_bfloat16> {
  static __device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                             const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  static __device__ __forceinline__ uint16_t bits(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
};

template <> struct Half<__half> {
  static __device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                             const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  static __device__ __forceinline__ uint16_t bits(float x) {
    return __half_as_ushort(__float2half_rn(x));
  }
};

// Copy rows [r0, r0 + R) x [0, DP) of a 16-bit (rows x D) matrix with row
// stride st into shared memory (row stride S); rows past n and columns past
// D read as zero. vec: whole 16-byte chunks (D % 8 == 0, aligned).
template <int R, int DP, int S>
__device__ __forceinline__ void load_rows(uint16_t* dst, const uint16_t* src,
                                          long long st, int r0, int n, int D,
                                          bool vec) {
  if (vec) {
    constexpr int CH = DP / 8;
    for (int i = threadIdx.x; i < R * CH; i += blockDim.x) {
      const int r = i / CH, c = (i % CH) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (r0 + r < n && c < D)
        val = *reinterpret_cast<const uint4*>(src + (r0 + r) * st + c);
      *reinterpret_cast<uint4*>(dst + r * S + c) = val;
    }
  } else {
    for (int i = threadIdx.x; i < R * DP; i += blockDim.x) {
      const int r = i / DP, c = i % DP;
      dst[r * S + c] = (r0 + r < n && c < D) ? src[(r0 + r) * st + c] : 0;
    }
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The same copy started asynchronously: with vec, 16-byte cp.async copies
// (zero-filled past n rows / D columns) left in flight until the caller's
// cp_async_wait; otherwise plain loads.
template <int R, int DP, int S>
__device__ __forceinline__ void stage_rows(uint16_t* dst, const uint16_t* src,
                                           long long st, int r0, int n, int D,
                                           bool vec) {
  if (!vec) {
    load_rows<R, DP, S>(dst, src, st, r0, n, D, false);
    return;
  }
  constexpr int CH = DP / 8;
  for (int i = threadIdx.x; i < R * CH; i += blockDim.x) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool in = r0 + r < n && c < D;
    const uint16_t* g = in ? src + (r0 + r) * st + c : src;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst + r * S + c)), "l"(g), "r"(in ? 16 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// B operands of two adjacent 8-wide n tiles of one 16-deep k step, out of a
// row-major (k x n) 16-bit tile in shared memory (row stride S) through
// ldmatrix.trans: lanes 0-15 address rows k0 + 0..15 at column n0, lanes
// 16-31 the same rows at column n0 + 8. b[0..1] feed tile n0, b[2..3] tile
// n0 + 8.
template <int S>
__device__ __forceinline__ void ldmatrix_b_trans(uint32_t* b,
                                                 const uint16_t* tile, int k0,
                                                 int n0, int lane) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0,%1,%2,%3}, [%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(smem_addr(tile + (k0 + (lane & 15)) * S + n0 + (lane >> 4) * 8))
      : "memory");
}

// A operand (16 x 16, row-major) of rows [r0, r0 + 16) and columns
// [c0, c0 + 16) of a 16-bit tile in shared memory with row stride S.
template <int S>
__device__ __forceinline__ void load_a(uint32_t* a, const uint16_t* tile,
                                       int r0, int c0, int g, int t4) {
  const uint16_t* p = tile + (r0 + g) * S + c0 + t4 * 2;
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * S);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * S + 8);
}

template <typename K>
cudaError_t set_smem(K kern, size_t smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace mxt
