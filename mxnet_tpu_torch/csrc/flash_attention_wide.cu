// The f32 dk / dv of flash attention for heads above 256 on Hopper
// (sm_90a), bound through a plain C entry: wide_dkv.
//
// Replaces, for f32 at head_dim > 256 only (route "wide_f32" of
// ops/cuda/attention.py:head_dim_route): mxnet_tpu/ops/pallas/attention.py,
// _flash_bwd_dkv_kernel, which takes any head dim. flash_attention_bwd.cu
// takes head dims up to 256; 16-bit heads above it take the tiled wgmma
// kernels of flash_attention_wide_wg.cu (the forward and dq) and
// flash_attention_wide_dkv.cu (dk / dv), and f32 heads the 3xTF32 forward
// and dq of flash_attention_wide_wg.cu. This kernel is the simple route
// for the f32 dk / dv, off every main path of the port (no zoo model has
// such heads), written to be right for any D:
//
//   wide_dkv:  from the forward's lse and delta = rowsum(dout * out),
//              p = exp(s - lse), dp = dout v^T (dropped out as the forward
//              drops p: the keep bit of philox.cuh, the same pure function
//              of (seed, b, h, row, col) as the other kernels draw),
//              ds0 = p (dp - delta), dv = p_d^T dout, dk = (ds0 * scale)^T q.
//
// The causal mask is top-left (col <= row); masked scores add nothing. A
// warp owns one key row of one (batch, head), and its lanes stride the
// head dim: a score is a lane-strided dot product reduced by a butterfly,
// a few of them at once (their loads and reductions independent), so every
// sum runs in a fixed order and two runs give the same bits (no atomics).
// The outputs are produced in slices of 256 columns (8 f32 accumulators a
// lane), each slice a walk over the queries in order that recomputes the
// scores it needs, so any head dim fits in registers. Accumulation and
// outputs are f32.
//
// Bound: this kernel re-reads q and dout once per 256-column slice and
// does the products on the FMA pipe, so it is bound by neither the card's
// bytes nor its tensor cores: a simple kernel that is right, for a case no
// main path takes (PERF.md).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace wide {

constexpr int WARPS = 4;        // rows a block
constexpr int SLICE = 8;        // output columns a lane holds: 256 a warp
// scores a warp computes at once: the fastest of 1, 2 and 4 at (2, 4, 512,
// 288) bf16 (PERF.md section 6)
constexpr int KB_DKV = 4;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ void st(float* p, float x) { *p = x; }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// out[i] = sum_d a[d] * b[i][d] over the head dim for i < KB, lanes
// strided, each the same value on every lane
template <int KB, typename T>
__device__ __forceinline__ void dots(const T* a, const T* const* b, int D,
                                     int lane, float* out) {
  float acc[KB];
#pragma unroll
  for (int i = 0; i < KB; ++i) acc[i] = 0.f;
  for (int d = lane; d < D; d += 32) {
    const float x = ld(a + d);
#pragma unroll
    for (int i = 0; i < KB; ++i) acc[i] = fmaf(x, ld(b[i] + d), acc[i]);
  }
#pragma unroll
  for (int i = 0; i < KB; ++i) out[i] = warp_sum(acc[i]);
}

// KB rows from row j0 of base (stride st), the ones past end repeating
// the last valid row (their results are dropped)
template <int KB, typename T>
__device__ __forceinline__ void rows(const T* base, long long st, int j0,
                                     int end, const T** out) {
#pragma unroll
  for (int i = 0; i < KB; ++i) out[i] = base + min(j0 + i, end - 1) * st;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* bias;
  const float* lse;     // (B, H, Tq) f32
  const float* delta;   // (B, H, Tq) f32
  const int* seed;
  void* dk;
  void* dv;
  int B, H, Tq, Tk, D;
  long long q_sb, q_sh, q_st;
  long long k_sb, k_sh, k_st;
  long long v_sb, v_sh, v_st;
  long long do_sb, do_sh, do_st;
  long long o_sb, o_sh, o_st;
  long long dk_sb, dk_sh, dk_st;
  long long dv_sb, dv_sh, dv_st;
  long long b_sb, b_sh, b_sq, b_sk;
  float scale;
  int causal;
  int dropout;
  uint32_t drop_threshold;
  float drop_scale;
};

__device__ __forceinline__ bool kept(const Args& a, uint2 key, int b, int h,
                                     int row, int col) {
  return !a.dropout ||
         mxt::dropout_keep(key, b, h, row, col, a.drop_threshold);
}

// One score's share of the backward, as flash_attention_bwd.cu score_grad:
// p_d (for dv) and ds0 = p (dp - delta), unscaled.
__device__ __forceinline__ void grads(const Args& a, uint2 key, int b, int h,
                                      int row, int col, float s, float dp,
                                      float lse, float delta, float& pd,
                                      float& ds0) {
  const float p = expf(s - lse);
  pd = p;
  if (a.dropout) {
    const bool keep = kept(a, key, b, h, row, col);
    pd = keep ? p * a.drop_scale : 0.f;
    dp = keep ? dp * a.drop_scale : 0.f;
  }
  ds0 = p * (dp - delta);
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32) wide_dkv(const Args a) {
  const int lane = threadIdx.x & 31;
  const int col = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int h = blockIdx.y, b = blockIdx.z;
  if (col >= a.Tk) return;
  const T* kr = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh +
                col * a.k_st;
  const T* vr = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh +
                col * a.v_st;
  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* dob = static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh;
  const float* bp = a.bias ? a.bias + b * a.b_sb + h * a.b_sh : nullptr;
  const long long bh = (static_cast<long long>(b) * a.H + h) * a.Tq;
  const int i0 = a.causal ? col : 0;   // queries that see this key
  const uint2 key = a.dropout ? mxt::dropout_key(a.seed) : make_uint2(0, 0);
  constexpr int KB = KB_DKV;
  T* dkr = static_cast<T*>(a.dk) + b * a.dk_sb + h * a.dk_sh + col * a.dk_st;
  T* dvr = static_cast<T*>(a.dv) + b * a.dv_sb + h * a.dv_sh + col * a.dv_st;
  for (int d0 = 0; d0 < a.D; d0 += 32 * SLICE) {
    float ak[SLICE], av[SLICE];
#pragma unroll
    for (int r = 0; r < SLICE; ++r) ak[r] = av[r] = 0.f;
    for (int i0q = i0; i0q < a.Tq; i0q += KB) {
      const T* qr[KB];
      const T* dor[KB];
      rows<KB>(qb, a.q_st, i0q, a.Tq, qr);
      rows<KB>(dob, a.do_st, i0q, a.Tq, dor);
      float s[KB], dp[KB];
      dots<KB>(kr, qr, a.D, lane, s);
      dots<KB>(vr, dor, a.D, lane, dp);
#pragma unroll
      for (int u = 0; u < KB; ++u) {
        const int i = i0q + u;
        if (i >= a.Tq) break;
        float x = s[u] * a.scale;
        if (bp) x += bp[i * a.b_sq + col * a.b_sk];
        float pd, ds0;
        grads(a, key, b, h, i, col, x, dp[u], a.lse[bh + i], a.delta[bh + i],
              pd, ds0);
        const float w = ds0 * a.scale;
#pragma unroll
        for (int r = 0; r < SLICE; ++r) {
          const int d = d0 + r * 32 + lane;
          if (d < a.D) {
            av[r] = fmaf(pd, ld(dor[u] + d), av[r]);
            ak[r] = fmaf(w, ld(qr[u] + d), ak[r]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < SLICE; ++r) {
      const int d = d0 + r * 32 + lane;
      if (d < a.D) {
        st(dkr + d, ak[r]);
        st(dvr + d, av[r]);
      }
    }
  }
}

cudaError_t launch(const Args& a, cudaStream_t s) {
  const dim3 grid((a.Tk + WARPS - 1) / WARPS, a.H, a.B);
  wide_dkv<float><<<grid, WARPS * 32, 0, s>>>(a);
  return cudaGetLastError();
}

// f32 (dtype 0) alone
bool bad(int dtype, int B, int H, int Tq, int Tk, int D, int dropout,
         const int* seed) {
  return dtype != 0 || D < 1 || B < 1 || H < 1 || Tq < 1 || Tk < 1 ||
         B > 65535 || H > 65535 || (dropout && !seed);
}

}  // namespace wide

// The dk / dv kernel, with mxt_flash_attention_bwd's arguments, for f32
// (dtype 0) and kind 2 alone (dq, ds unused); strides: q, k, v, dout, dq,
// dk, dv as (batch, head, time) triples, then the bias's four.
extern "C" int mxt_flash_wide_bwd(
    int kind, int dtype, const void* q, const void* k, const void* v,
    const void* dout, const float* bias, const float* lse, const float* delta,
    void* dq, void* dk, void* dv, float* ds, int B, int H, int Tq, int Tk,
    int D, const long long* strides, float scale, int causal,
    const int* seed, int dropout, unsigned int drop_threshold,
    float drop_scale, void* stream) {
  if (wide::bad(dtype, B, H, Tq, Tk, D, dropout, seed) || kind != 2 ||
      !lse || !delta || !dk || !dv)
    return static_cast<int>(cudaErrorInvalidValue);
  wide::Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.bias = bias; a.lse = lse;
  (void)dq;
  (void)ds;
  a.delta = delta; a.dk = dk; a.dv = dv;
  a.B = B; a.H = H; a.Tq = Tq; a.Tk = Tk; a.D = D;
  long long* dst[25] = {&a.q_sb,  &a.q_sh,  &a.q_st,  &a.k_sb,  &a.k_sh,
                        &a.k_st,  &a.v_sb,  &a.v_sh,  &a.v_st,  &a.do_sb,
                        &a.do_sh, &a.do_st, &a.o_sb,  &a.o_sh,  &a.o_st,
                        &a.dk_sb, &a.dk_sh, &a.dk_st, &a.dv_sb, &a.dv_sh,
                        &a.dv_st, &a.b_sb,  &a.b_sh,  &a.b_sq,  &a.b_sk};
  for (int i = 0; i < 25; ++i) *dst[i] = strides[i];
  a.scale = scale; a.causal = causal; a.seed = seed; a.dropout = dropout != 0;
  a.drop_threshold = drop_threshold; a.drop_scale = drop_scale;
  return static_cast<int>(
      wide::launch(a, static_cast<cudaStream_t>(stream)));
}
