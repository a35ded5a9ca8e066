// Flash attention at head dims above 256 for Hopper (sm_90a), bound through
// plain C entries: the forward and the backward's dq / dkv pair.
//
// Replaces, for head_dim > 256 only: mxnet_tpu/ops/pallas/attention.py,
// _flash_fwd_kernel, _flash_bwd_dq_kernel and _flash_bwd_dkv_kernel, which
// take any head dim. flash_attention_fwd.cu and flash_attention_bwd.cu tile
// the head dim into wgmma panels and registers sized up to 256; these
// kernels are the simple route for wider heads, off every main path of the
// port (no zoo model has such heads), written to be right for any D. The
// routes of ops/cuda/attention.py:head_dim_route that take them: f32 at
// every D > 256 ("wide_rows": all three), and wide_dkv alone for 16-bit
// D > 512 ("wide_stream"); 16-bit heads take the tiled wgmma forward and
// dq of flash_attention_wide_wg.cu at every D > 256, and the tiled wide_dkv
// of flash_attention_wide_dkv.cu up to 512. So wide_fwd and wide_dq serve
// f32 alone:
//
//   wide_fwd:  out = softmax(q k^T * scale + bias) v and lse = m + log l,
//              the denominator over the undropped probabilities, the kept
//              ones scaled by 1 / (1 - rate) (the keep bit of philox.cuh,
//              the same pure function of (seed, b, h, row, col) as the
//              other kernels draw);
//   wide_dq:   from the forward's lse and delta = rowsum(dout * out),
//              p = exp(s - lse), dp = dout v^T (dropout as the forward),
//              ds0 = p (dp - delta), dq = (ds0 * scale) k, and ds0 itself
//              into an f32 (B, H, Tq, Tk) tensor when the bias is learned;
//   wide_dkv:  dv = p_d^T dout, dk = (ds0 * scale)^T q.
//
// The causal mask is top-left (col <= row); masked scores add nothing. A
// warp owns one query row (fwd, dq) or one key row (dkv) of one (batch,
// head), and its lanes stride the head dim: a score is a lane-strided dot
// product reduced by a butterfly, a few of them at once (their loads and
// reductions independent), so every sum runs in a fixed order and two runs
// give the same bits (no atomics). The outputs are produced in slices of
// 256 columns (8 f32 accumulators a lane), each slice a walk over the keys
// (queries for dkv) in order that recomputes the scores it needs, so any
// head dim fits in registers; the forward first walks the keys once for
// the row max and denominator. Accumulation is in f32; each output is
// rounded once to q's dtype (f32, bf16, fp16).
//
// Bound: these kernels re-read K (or q and dout) once per 256-column slice
// and do the products on the FMA pipe, so they are bound by neither the
// card's bytes nor its tensor cores: a simple kernel that is right, for a
// case no main path takes (PERF.md).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace wide {

constexpr int WARPS = 4;        // rows a block
constexpr int SLICE = 8;        // output columns a lane holds: 256 a warp
// scores a warp computes at once, by kernel: the fastest of 1, 2 and 4 at
// (2, 4, 512, 288) bf16 (PERF.md section 6)
constexpr int KB_FWD = 2, KB_DQ = 1, KB_DKV = 4;
constexpr float NEG_BIG = -1e30f;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float ld(const __half* p) {
  return __half2float(*p);
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void st(__half* p, float x) {
  *p = __float2half_rn(x);
}

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
  void* o;              // forward: out; dq kernel: dq
  float* lse_out;       // forward: (B, H, Tq) f32
  void* dk;
  void* dv;
  float* ds;            // (B, H, Tq, Tk) f32, or null
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

// the scaled scores of row `row` against keys j0 .. j0 + KB - 1 (the
// ones at or past kend are not used), with the bias
template <int KB, typename T>
__device__ __forceinline__ void scores(const Args& a, const T* qr,
                                       const T* kb, const float* bp, int row,
                                       int j0, int kend, int lane, float* s) {
  const T* kr[KB];
  rows<KB>(kb, a.k_st, j0, kend, kr);
  dots<KB>(qr, kr, a.D, lane, s);
#pragma unroll
  for (int i = 0; i < KB; ++i) {
    s[i] *= a.scale;
    if (bp && j0 + i < kend) s[i] += bp[row * a.b_sq + (j0 + i) * a.b_sk];
  }
}

__device__ __forceinline__ bool kept(const Args& a, uint2 key, int b, int h,
                                     int row, int col) {
  return !a.dropout ||
         mxt::dropout_keep(key, b, h, row, col, a.drop_threshold);
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32) wide_fwd(const Args a) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int h = blockIdx.y, b = blockIdx.z;
  if (row >= a.Tq) return;
  const T* qr = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh +
                row * a.q_st;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  const float* bp = a.bias ? a.bias + b * a.b_sb + h * a.b_sh : nullptr;
  const int kend = a.causal ? min(a.Tk, row + 1) : a.Tk;
  const uint2 key = a.dropout ? mxt::dropout_key(a.seed) : make_uint2(0, 0);
  constexpr int KB = KB_FWD;

  // the row's max (floored at -1e30, as the other kernels start it) and
  // denominator, online over the keys in order
  float m = NEG_BIG, l = 0.f;
  for (int j0 = 0; j0 < kend; j0 += KB) {
    float s[KB];
    scores<KB>(a, qr, kb, bp, row, j0, kend, lane, s);
#pragma unroll
    for (int i = 0; i < KB; ++i) {
      if (j0 + i >= kend) break;
      const float mn = fmaxf(m, s[i]);
      l = l * expf(m - mn) + expf(s[i] - mn);
      m = mn;
    }
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
  T* orow = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh + row * a.o_st;
  for (int d0 = 0; d0 < a.D; d0 += 32 * SLICE) {
    float acc[SLICE];
#pragma unroll
    for (int r = 0; r < SLICE; ++r) acc[r] = 0.f;
    for (int j0 = 0; j0 < kend; j0 += KB) {
      float s[KB];
      scores<KB>(a, qr, kb, bp, row, j0, kend, lane, s);
#pragma unroll
      for (int i = 0; i < KB; ++i) {
        const int j = j0 + i;
        if (j >= kend) break;
        float p = expf(s[i] - m);
        if (a.dropout) p = kept(a, key, b, h, row, j) ? p * a.drop_scale : 0.f;
        const T* vr = vb + j * a.v_st;
#pragma unroll
        for (int r = 0; r < SLICE; ++r) {
          const int d = d0 + r * 32 + lane;
          if (d < a.D) acc[r] = fmaf(p, ld(vr + d), acc[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < SLICE; ++r) {
      const int d = d0 + r * 32 + lane;
      if (d < a.D) st(orow + d, acc[r] * inv);
    }
  }
  if (lane == 0)
    a.lse_out[(static_cast<long long>(b) * a.H + h) * a.Tq + row] =
        m + logf(fmaxf(l, 1e-30f));
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
__global__ void __launch_bounds__(WARPS * 32) wide_dq(const Args a) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int h = blockIdx.y, b = blockIdx.z;
  if (row >= a.Tq) return;
  const T* qr = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh +
                row * a.q_st;
  const T* dor = static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh +
                 row * a.do_st;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  const float* bp = a.bias ? a.bias + b * a.b_sb + h * a.b_sh : nullptr;
  const long long bhr = (static_cast<long long>(b) * a.H + h) * a.Tq + row;
  const float lse = a.lse[bhr], delta = a.delta[bhr];
  const int kend = a.causal ? min(a.Tk, row + 1) : a.Tk;
  const uint2 key = a.dropout ? mxt::dropout_key(a.seed) : make_uint2(0, 0);
  constexpr int KB = KB_DQ;
  float* dsr = a.ds ? a.ds + bhr * a.Tk : nullptr;
  T* dqr = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh + row * a.o_st;
  for (int d0 = 0; d0 < a.D; d0 += 32 * SLICE) {
    float acc[SLICE];
#pragma unroll
    for (int r = 0; r < SLICE; ++r) acc[r] = 0.f;
    for (int j0 = 0; j0 < kend; j0 += KB) {
      float s[KB], dp[KB];
      scores<KB>(a, qr, kb, bp, row, j0, kend, lane, s);
      const T* vr[KB];
      rows<KB>(vb, a.v_st, j0, kend, vr);
      dots<KB>(dor, vr, a.D, lane, dp);
#pragma unroll
      for (int i = 0; i < KB; ++i) {
        const int j = j0 + i;
        if (j >= kend) break;
        float pd, ds0;
        grads(a, key, b, h, row, j, s[i], dp[i], lse, delta, pd, ds0);
        if (dsr && d0 == 0 && lane == 0) dsr[j] = ds0;
        const float w = ds0 * a.scale;
        const T* kr = kb + j * a.k_st;
#pragma unroll
        for (int r = 0; r < SLICE; ++r) {
          const int d = d0 + r * 32 + lane;
          if (d < a.D) acc[r] = fmaf(w, ld(kr + d), acc[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < SLICE; ++r) {
      const int d = d0 + r * 32 + lane;
      if (d < a.D) st(dqr + d, acc[r]);
    }
  }
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

template <typename T>
cudaError_t launch(int kind, const Args& a, cudaStream_t s) {
  const int rows = kind == 2 ? a.Tk : a.Tq;
  const dim3 grid((rows + WARPS - 1) / WARPS, a.H, a.B);
  if (kind == 0)
    wide_fwd<T><<<grid, WARPS * 32, 0, s>>>(a);
  else if (kind == 1)
    wide_dq<T><<<grid, WARPS * 32, 0, s>>>(a);
  else
    wide_dkv<T><<<grid, WARPS * 32, 0, s>>>(a);
  return cudaGetLastError();
}

cudaError_t dispatch(int kind, int dtype, const Args& a, cudaStream_t s) {
  if (dtype == 0) return launch<float>(kind, a, s);
  if (dtype == 1) return launch<__nv_bfloat16>(kind, a, s);
  return launch<__half>(kind, a, s);
}

bool bad(int dtype, int B, int H, int Tq, int Tk, int D, int dropout,
         const int* seed) {
  return dtype < 0 || dtype > 2 || D < 1 || B < 1 || H < 1 || Tq < 1 ||
         Tk < 1 || B > 65535 || H > 65535 || (dropout && !seed);
}

}  // namespace wide

// The forward, with mxt_flash_attention_fwd's arguments (strides: q, k, v,
// out as (batch, head, time) triples, then the bias's four).
extern "C" int mxt_flash_wide_fwd(int dtype, const void* q, const void* k,
                                  const void* v, const float* bias, void* out,
                                  float* lse, int B, int H, int Tq, int Tk,
                                  int D, const long long* strides, float scale,
                                  int causal, const int* seed, int dropout,
                                  unsigned int drop_threshold,
                                  float drop_scale, void* stream) {
  if (wide::bad(dtype, B, H, Tq, Tk, D, dropout, seed) || !out || !lse)
    return static_cast<int>(cudaErrorInvalidValue);
  wide::Args a{};
  a.q = q; a.k = k; a.v = v; a.bias = bias; a.o = out; a.lse_out = lse;
  a.B = B; a.H = H; a.Tq = Tq; a.Tk = Tk; a.D = D;
  a.q_sb = strides[0]; a.q_sh = strides[1]; a.q_st = strides[2];
  a.k_sb = strides[3]; a.k_sh = strides[4]; a.k_st = strides[5];
  a.v_sb = strides[6]; a.v_sh = strides[7]; a.v_st = strides[8];
  a.o_sb = strides[9]; a.o_sh = strides[10]; a.o_st = strides[11];
  a.b_sb = strides[12]; a.b_sh = strides[13]; a.b_sq = strides[14];
  a.b_sk = strides[15];
  a.scale = scale; a.causal = causal; a.seed = seed; a.dropout = dropout != 0;
  a.drop_threshold = drop_threshold; a.drop_scale = drop_scale;
  return static_cast<int>(
      wide::dispatch(0, dtype, a, static_cast<cudaStream_t>(stream)));
}

// The backward pair, with mxt_flash_attention_bwd's arguments: kind 1 the
// dq kernel (writes dq, and ds when it is not null), 2 the dk / dv kernel;
// strides: q, k, v, dout, dq, dk, dv as (batch, head, time) triples, then
// the bias's four.
extern "C" int mxt_flash_wide_bwd(
    int kind, int dtype, const void* q, const void* k, const void* v,
    const void* dout, const float* bias, const float* lse, const float* delta,
    void* dq, void* dk, void* dv, float* ds, int B, int H, int Tq, int Tk,
    int D, const long long* strides, float scale, int causal,
    const int* seed, int dropout, unsigned int drop_threshold,
    float drop_scale, void* stream) {
  if (wide::bad(dtype, B, H, Tq, Tk, D, dropout, seed) || kind < 1 ||
      kind > 2 || !lse || !delta || (kind == 1 && !dq) ||
      (kind == 2 && (!dk || !dv)))
    return static_cast<int>(cudaErrorInvalidValue);
  wide::Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.bias = bias; a.lse = lse;
  a.delta = delta; a.o = dq; a.dk = dk; a.dv = dv; a.ds = ds;
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
      wide::dispatch(kind, dtype, a, static_cast<cudaStream_t>(stream)));
}
