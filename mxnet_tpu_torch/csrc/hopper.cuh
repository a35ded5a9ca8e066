// Hopper (sm_90a) building blocks: wgmma on shared-memory operands in the
// canonical no-swizzle layout, mbarriers, 1-D bulk copies and the 8/16-byte
// cp.async that zero-fills. Used by conv_fused.cu's dgrad and wgrad kernels.
//
// The operand layout ("INTERLEAVE", no swizzle): a tile of R rows along M
// (or N) and 64 along K is stored as 8 x 8 core matrices of 128 contiguous
// bytes; core matrix (row group rg, k group kg) starts at 16-byte unit
// kg * R + rg * 8. Inside it, a K-major operand keeps row r % 8 in unit
// r % 8 (8 consecutive k per unit); an MN-major operand keeps k % 8 in unit
// k % 8 (8 consecutive rows per unit). Both give a descriptor with leading
// byte offset R * 16 (the next k group) and stride byte offset 128 (the next
// row group); a k16 step advances the start by 2 * R * 16 bytes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace hop {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A wgmma shared-memory descriptor of the layout above: start address,
// leading byte offset lbo (next k group), stride byte offset 128.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(128 >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads or writes across an
// asynchronous wgmma
__device__ __forceinline__ void fence_regs(float* d, int n) {
#pragma unroll
  for (int i = 0; i < n; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// generic-proxy writes to shared memory (st.shared, cp.async) made visible
// to the async proxy (wgmma, bulk copies)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

#define HOP_D8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
    "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define HOP_WGMMA_128(TY, TA, TB)                                             \
  asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "          \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "    \
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "    \
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "                  \
      "%64, %65, p, 1, 1, " TA ", " TB ";\n}\n"                               \
      : HOP_D8(0), HOP_D8(8), HOP_D8(16), HOP_D8(24), HOP_D8(32),           \
        HOP_D8(40), HOP_D8(48), HOP_D8(56)                                   \
      : "l"(da), "l"(db), "r"(1))

// d (64 f32 per thread: the m64n128 accumulator of one warpgroup) +=
// A (64 x 16) * B (16 x 128), both from shared memory. TA / TB: 0 for a
// K-major operand, 1 for an MN-major ("transposed") one.
template <typename T, int TA, int TB>
__device__ __forceinline__ void wgmma_128(float* d, uint64_t da, uint64_t db);
template <>
__device__ __forceinline__ void wgmma_128<__nv_bfloat16, 0, 0>(float* d,
                                                               uint64_t da,
                                                               uint64_t db) {
  HOP_WGMMA_128("bf16", "0", "0");
}
template <>
__device__ __forceinline__ void wgmma_128<__half, 0, 0>(float* d, uint64_t da,
                                                        uint64_t db) {
  HOP_WGMMA_128("f16", "0", "0");
}
template <>
__device__ __forceinline__ void wgmma_128<__nv_bfloat16, 1, 1>(float* d,
                                                               uint64_t da,
                                                               uint64_t db) {
  HOP_WGMMA_128("bf16", "1", "1");
}
template <>
__device__ __forceinline__ void wgmma_128<__half, 1, 1>(float* d, uint64_t da,
                                                        uint64_t db) {
  HOP_WGMMA_128("f16", "1", "1");
}
#undef HOP_WGMMA_128
#undef HOP_D8

// ---------------------------------------------------------------- mbarriers
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// one arrival that also announces `bytes` of bulk copies to come
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// waits until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// 1-D bulk copy of `bytes` (a multiple of 16; both addresses 16-byte
// aligned) from global to shared memory, completing on `bar`
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                        uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// --------------------------------------------------------------- cp.async
// 16 or 8 bytes, zero-filled when !ok (src is then not read)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp8(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 8 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace hop
