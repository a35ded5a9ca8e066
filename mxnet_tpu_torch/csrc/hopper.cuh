// Hopper (sm_90a) building blocks: wgmma on shared-memory operands in the
// canonical no-swizzle layout, mbarriers, 1-D bulk copies and the 8/16-byte
// cp.async that zero-fills, used by conv_fused.cu's wgrad kernels; and, for
// the flash-attention kernels and conv_fused.cu's fwd and dgrad, wgmma on
// 128-byte-swizzled operands (B K-major or MN-major, A swizzled or in
// registers, loaded there by ldmatrix; TF32 operands split for 3xTF32),
// tensor (TMA) copies, named
// barriers, stmatrix and the bulk f32 reduce-add into global memory (the
// second half of this file).
//
// The operand layout ("INTERLEAVE", no swizzle): a tile of R rows along M
// (or N) and 64 along K is stored as 8 x 8 core matrices of 128 contiguous
// bytes; core matrix (row group rg, k group kg) starts at 16-byte unit
// kg * R + rg * 8. Inside it, a K-major operand keeps row r % 8 in unit
// r % 8 (8 consecutive k per unit). The descriptor's leading byte offset is
// R * 16 (the next k group), its stride byte offset 128 (the next row
// group); a k16 step advances the start by 2 * R * 16 bytes.
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
// A (64 x 16) * B (16 x 128), both K-major from shared memory.
template <typename T>
__device__ __forceinline__ void wgmma_128(float* d, uint64_t da, uint64_t db);
template <>
__device__ __forceinline__ void wgmma_128<__nv_bfloat16>(float* d, uint64_t da,
                                                         uint64_t db) {
  HOP_WGMMA_128("bf16", "0", "0");
}
template <>
__device__ __forceinline__ void wgmma_128<__half>(float* d, uint64_t da,
                                                  uint64_t db) {
  HOP_WGMMA_128("f16", "0", "0");
}
#undef HOP_WGMMA_128

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

// the reverse: `bytes` (a multiple of 16; both addresses 16-byte aligned)
// from shared to global memory, in the thread's bulk group
__device__ __forceinline__ void bulk_s2g(void* dst, const void* src,
                                        uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(smem_u32(src)), "r"(bytes)
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

// ------------------------------------------------- 128-byte-swizzled tiles
// What a TMA copy with CU_TENSOR_MAP_SWIZZLE_128B writes: a tile of rows of
// 64 16-bit values (128 bytes), row r at byte r * 128 with its 16-byte
// chunk c stored at chunk c ^ (r % 8); 8 rows (1024 bytes) make one swizzle
// atom, and the tile starts on a 1024-byte boundary. Wider rows are cut
// into 64-wide panels stored one after another.
//
// K-major operand (Q or K in S = Q K^T: rows along M or N, 64 k per row):
// stride byte offset 1024 (the next 8 rows), leading byte offset unused;
// the k16 step kk of a panel starts 32 * kk bytes in.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}
__device__ __forceinline__ uint64_t desc_kmajor_sw128(uint32_t addr) {
  return desc_sw128(addr, 16, 1024);
}
// MN-major operand (V in O += P V: row = k, 64 n per row): stride byte
// offset 1024 (the next 8 k), leading byte offset `panel_bytes` (the next 64
// n); the k16 step kk starts 2048 * kk bytes in.
__device__ __forceinline__ uint64_t desc_mnmajor_sw128(uint32_t addr,
                                                       uint32_t panel_bytes) {
  return desc_sw128(addr, panel_bytes, 1024);
}

#define HOP_WGMMA_RS_64(TY, TB)  \
  asm volatile(  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"  \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "  \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
      "%28, %29, %30, %31},"  \
      "{%32, %33, %34, %35}, %36, p, 1, 1, " TB ";\n}\n"  \
      :  \
      HOP_D8(0), HOP_D8(8), HOP_D8(16), HOP_D8(24)  \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))

#define HOP_WGMMA_RS_128(TY, TB)  \
  asm volatile(  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"  \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "  \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "  \
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "  \
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"  \
      "{%64, %65, %66, %67}, %68, p, 1, 1, " TB ";\n}\n"  \
      :  \
      HOP_D8(0), HOP_D8(8), HOP_D8(16), HOP_D8(24), HOP_D8(32),  \
      HOP_D8(40), HOP_D8(48), HOP_D8(56)  \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))

#define HOP_WGMMA_RS_256(TY, TB)  \
  asm volatile(  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"  \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " "  \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "  \
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "  \
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "  \
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "  \
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "  \
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "  \
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "  \
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "  \
      "%127},"  \
      "{%128, %129, %130, %131}, %132, p, 1, 1, " TB ";\n}\n"  \
      :  \
      HOP_D8(0), HOP_D8(8), HOP_D8(16), HOP_D8(24), HOP_D8(32),  \
      HOP_D8(40), HOP_D8(48), HOP_D8(56), HOP_D8(64), HOP_D8(72),  \
      HOP_D8(80), HOP_D8(88), HOP_D8(96), HOP_D8(104), HOP_D8(112),  \
      HOP_D8(120)  \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))

#define HOP_WGMMA_SS_32(TY, TB)  \
  asm volatile(  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"  \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " "  \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
      "%15},"  \
      "%16, %17, p, 1, 1, 0, " TB ";\n}\n"  \
      :  \
      HOP_D8(0), HOP_D8(8)  \
      : "l"(da), "l"(db), "r"(scale_d))

#define HOP_WGMMA_SS_64(TY, TB)  \
  asm volatile(  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"  \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "  \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
      "%28, %29, %30, %31},"  \
      "%32, %33, p, 1, 1, 0, " TB ";\n}\n"  \
      :  \
      HOP_D8(0), HOP_D8(8), HOP_D8(16), HOP_D8(24)  \
      : "l"(da), "l"(db), "r"(scale_d))

#define HOP_WGMMA_SS_128(TY, TB)  \
  asm volatile(  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"  \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "  \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "  \
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "  \
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"  \
      "%64, %65, p, 1, 1, 0, " TB ";\n}\n"  \
      :  \
      HOP_D8(0), HOP_D8(8), HOP_D8(16), HOP_D8(24), HOP_D8(32),  \
      HOP_D8(40), HOP_D8(48), HOP_D8(56)  \
      : "l"(da), "l"(db), "r"(scale_d))

// d (N / 2 f32 per thread: the m64nN accumulator of one warpgroup) +=
// A (64 x 16, in registers: the m16n8k16 A fragment of each warp's 16 rows)
// * B (16 x N, shared memory, descriptor db); TB: 0 K-major B, 1 MN-major.
// scale_d = 0 overwrites d.
template <typename T, int N, int TB>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db, int scale_d);
// d (N / 2 f32 per thread) = / += A (64 x 16) * B (16 x N), both from
// shared memory, A K-major; TB: 0 K-major B, 1 MN-major.
template <typename T, int N, int TB = 0>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int scale_d);

#define HOP_RS(TYPE, TY, N, TB)                                            \
  template <>                                                              \
  __device__ __forceinline__ void wgmma_rs<TYPE, N, TB>(                   \
      float* d, const uint32_t* a, uint64_t db, int scale_d) {             \
    HOP_WGMMA_RS_##N(TY, #TB);                                             \
  }
HOP_RS(__nv_bfloat16, "bf16", 64, 1)
HOP_RS(__nv_bfloat16, "bf16", 128, 1)
HOP_RS(__nv_bfloat16, "bf16", 256, 1)
HOP_RS(__half, "f16", 64, 1)
HOP_RS(__half, "f16", 128, 1)
HOP_RS(__half, "f16", 256, 1)
HOP_RS(__nv_bfloat16, "bf16", 64, 0)
HOP_RS(__nv_bfloat16, "bf16", 128, 0)
HOP_RS(__half, "f16", 64, 0)
HOP_RS(__half, "f16", 128, 0)
#undef HOP_RS
#define HOP_SS(TYPE, TY, N, TB)                                            \
  template <>                                                              \
  __device__ __forceinline__ void wgmma_ss<TYPE, N, TB>(                   \
      float* d, uint64_t da, uint64_t db, int scale_d) {                   \
    HOP_WGMMA_SS_##N(TY, #TB);                                             \
  }
HOP_SS(__nv_bfloat16, "bf16", 32, 0)
HOP_SS(__half, "f16", 32, 0)
HOP_SS(__nv_bfloat16, "bf16", 64, 0)
HOP_SS(__nv_bfloat16, "bf16", 128, 0)
HOP_SS(__half, "f16", 64, 0)
HOP_SS(__half, "f16", 128, 0)
HOP_SS(__nv_bfloat16, "bf16", 64, 1)
HOP_SS(__nv_bfloat16, "bf16", 128, 1)
HOP_SS(__half, "f16", 64, 1)
HOP_SS(__half, "f16", 128, 1)
#undef HOP_SS

// ------------------------------------------------------------ TF32 operands
// wgmma takes .tf32 operands only K-major (no transpose flag), as 32-bit
// values of which the tensor cores read the top 19 bits (10 mantissa
// bits). An f32 x splits into two of them, x = hi + lo exactly: hi = x
// rounded to TF32 (to nearest, ties away from zero), lo = x - hi (exact in
// f32, |lo| <= 2^-11 |x|), of which the tensor cores read 10 mantissa bits
// (to 2^-21 |x|). Three TF32 products hi hi' + hi lo' + lo hi' in f32 sums
// give an f32 product to about 2^-21 relative (3xTF32), where one TF32
// product keeps 2^-11. hi must round: lo then takes either sign, so the
// bits the tensor cores drop err both ways. Truncated (hi = x with its low
// bits cleared, lo always of x's sign), every product erred low by up to
// 3 2^-20 and the errors added up along a row: the gradient through a
// score q . q of 288 columns missed its f32 tolerance of 1e-4.
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// Where element r of an 8-element group along K sits in a K-major TF32 B
// operand whose A is an accumulator fragment (P or ds as wgmma_tf32_rs32's
// register A): the fragment takes k = t4 from the accumulator's column
// 2 t4 and k = t4 + 4 from 2 t4 + 1, so element 2 c of the group is stored
// at c and element 2 c + 1 at c + 4
__device__ __forceinline__ int tf32_key_pos(int r) {
  return (r & ~7) | ((r & 1) << 2) | ((r & 7) >> 1);
}

// d (16 f32) = (scale_d 0) or += A (64 x 8 TF32 in registers: a[0] row g,
// k t4; a[1] row g + 8, k t4; a[2] row g, k t4 + 4; a[3] row g + 8, k t4 +
// 4 of each warp's 16 rows, g = lane / 4, t4 = lane % 4) * B (8 x 32,
// K-major in shared memory)
__device__ __forceinline__ void wgmma_tf32_rs32(float* d, const uint32_t* a,
                                                uint64_t db,
                                                int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : HOP_D8(0), HOP_D8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}
// acc (16 f32) = (scale_d 0) or += A (halves ah, al) x B (TF32 halves,
// K-major in shared memory: hi at b, lo `lo` bytes on) as three TF32
// products, ah bh + ah bl + al bh (3xTF32)
__device__ __forceinline__ void wgmma_tf32_3x(float* acc, const uint32_t* ah,
                                              const uint32_t* al, uint32_t b,
                                              uint32_t lo, int scale_d = 1) {
  const uint64_t bh = desc_kmajor_sw128(b);
  wgmma_tf32_rs32(acc, ah, bh, scale_d);
  wgmma_tf32_rs32(acc, ah, desc_kmajor_sw128(b + lo));
  wgmma_tf32_rs32(acc, al, bh);
}

// The TF32 halves of k8 step kk of a register A operand whose f32 rows ra
// and rb = ra + 8 lie raw in a 128-byte-swizzled panel of 32 columns (ao:
// the byte offset of row ra's word t4; g = ra % 8): a[0] (ra, 8 kk + t4),
// a[1] (rb, ..), a[2] (ra, 8 kk + t4 + 4), a[3] (rb, ..)
__device__ __forceinline__ void tf32_rows_split(const unsigned char* panel,
                                                int ao, int g, int kk,
                                                uint32_t* hi, uint32_t* lo) {
  const int c0 = ((2 * kk) ^ g) << 4, c1 = ((2 * kk + 1) ^ g) << 4;
  const int bo = ao + 8 * 128;
  tf32_split(*reinterpret_cast<const float*>(panel + ao + c0), hi[0], lo[0]);
  tf32_split(*reinterpret_cast<const float*>(panel + bo + c0), hi[1], lo[1]);
  tf32_split(*reinterpret_cast<const float*>(panel + ao + c1), hi[2], lo[2]);
  tf32_split(*reinterpret_cast<const float*>(panel + bo + c1), hi[3], lo[3]);
}

// An m64n32 accumulator fragment x (rows g, g + 8; element 4 j + e at
// column 8 j + 2 t4 + (e & 1)), times mul, as the TF32 A operand of its 4
// k8 steps along the columns: step j takes (g, 8 j + 2 t4), (g + 8, ..),
// (g, 8 j + 2 t4 + 1), (g + 8, ..), so its B stores each 8-element group
// at tf32_key_pos
__device__ __forceinline__ void tf32_acc_split(const float* x, float mul,
                                               uint32_t (*hi)[4],
                                               uint32_t (*lo)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    tf32_split(x[4 * j] * mul, hi[j][0], lo[j][0]);
    tf32_split(x[4 * j + 2] * mul, hi[j][1], lo[j][1]);
    tf32_split(x[4 * j + 1] * mul, hi[j][2], lo[j][2]);
    tf32_split(x[4 * j + 3] * mul, hi[j][3], lo[j][3]);
  }
}
#undef HOP_WGMMA_RS_64
#undef HOP_WGMMA_RS_128
#undef HOP_WGMMA_RS_256
#undef HOP_WGMMA_SS_32
#undef HOP_WGMMA_SS_64
#undef HOP_WGMMA_SS_128
#undef HOP_D8

// ------------------------------------------------------------ tensor copies
// plain arrival (no transaction bytes)
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// 4-d tensor copy of one box of the tensor map `map` (a __grid_constant__
// kernel parameter) at element coordinates (c0 innermost .. c3) into shared
// memory, completing on `bar`; elements outside the tensor read as zero.
__device__ __forceinline__ void tma_load_4d(void* dst, const void* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
// the reverse: one box from shared memory to the tensor; elements outside
// the tensor are not written. Completes in the thread's bulk group.
__device__ __forceinline__ void tma_store_4d(const void* map, const void* src,
                                             int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_store_commit_and_wait() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Four 8 x 8 16-bit matrices loaded transposed: lane l gives the shared
// address of row l % 8 of matrix l / 8 (16 contiguous bytes, any row
// order); r[i] receives matrix i's elements [2 (l % 4)][l / 4] (low half)
// and [2 (l % 4) + 1][l / 4]. With rows = k and columns = m of an MN-major
// tile this is the m16n8k16 / wgmma A fragment of 16 m x 16 k.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// loads from shared memory at a 32-bit shared address
__device__ __forceinline__ float lds_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}
__device__ __forceinline__ uint16_t lds_u16(uint32_t addr) {
  uint16_t v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(addr));
  return v;
}

// barrier `id` (1..15; 0 is __syncthreads) over `count` threads: wait
// for all of them, or only arrive
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Four 8 x 8 16-bit matrices stored transposed: r[i] holds matrix i in the
// mma fragment layout (lane l: row l / 4, columns 2 (l % 4) and + 1); lane l
// gives the shared-memory address of row l % 8 of transposed matrix l / 8
// (column l % 8 of the fragment's matrix, 16 contiguous bytes).
__device__ __forceinline__ void stmatrix_x4_trans(uint32_t addr,
                                                  const uint32_t* r) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], "
      "{%1, %2, %3, %4};\n" ::"r"(addr),
      "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
      : "memory");
}

// `bytes` (a multiple of 16; both addresses 16-byte aligned) of f32 in
// shared memory added element by element into global memory, atomically
// per element, in the thread's bulk group. The source may be rewritten
// once bulk_wait_read<n> has returned; the sums are complete in global
// memory after bulk_wait<n>.
__device__ __forceinline__ void bulk_reduce_add_f32(float* dst,
                                                    const void* src,
                                                    uint32_t bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 "
      "[%0], [%1], %2;\n" ::"l"(dst),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// mbar_wait that traps (a launch error, not a hung card) when the phase
// has not completed within about 2^32 clock cycles
__device__ __forceinline__ void mbar_wait_or_trap(uint64_t* bar,
                                                  uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  const long long t0 = clock64();
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1ll << 32)) __trap();
  }
}

// 2^x on the special-function unit (flushes subnormals to zero)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace hop
