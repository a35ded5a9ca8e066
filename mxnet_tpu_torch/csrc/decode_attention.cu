// One-token decode attention over a slot-based KV cache, for Hopper
// (sm_90a), bound through a plain C entry.
//
// Counterpart of the per-slot decode attention of
// mxnet_tpu/serving/model.py:335-343 (_slot_block_step: scores over the
// cache, the position mask, softmax, the value sum), which the JAX package
// leaves to XLA einsums: no Pallas kernel is replaced. For every slot s and
// head h, with n = pos[s] + 1 visible positions (clamped to [1, L]):
//   sc[t] = scale * sum_d q[s, h, d] * k[s, t, h, d]       t < n
//   p[t]  = exp(sc[t] - max_t sc) / sum_t exp(sc[t] - max_t sc)
//   out[s, h, d] = sum_t p[t] * v[s, t, h, d]
// Everything is computed in f32 and the output rounded to the cache's
// dtype (f32, bf16 or fp16).
//
// Placement does not change a result: a block reads only its slot's first n
// rows, and every sum runs in an order fixed by n and the head dim alone,
// so a slot's output has the same bits whatever the bucket L (the rows past
// n are never read), the slot index, the number of slots or the other
// slots' contents. That is what lets the generation engine migrate a
// sequence to a larger KV bucket, or score k + 1 positions in one
// speculative pass, without changing a token.
//
// Layout: two kernels. decode_partial, grid (H, S, ceil(L / CHUNK)), 256
// threads: block c takes positions [c * CHUNK, (c + 1) * CHUNK) of its slot
// and head (a block past the slot's n returns at once), stages q and its
// scores in shared memory, and writes its chunk's max m_c, sum
// l_c = sum exp(sc - m_c) and o_c[d] = sum exp(sc - m_c) v[d] to an f32
// workspace. Scores: a warp per position (the 32 lanes stride the head
// dim, reading the row with coalesced loads; a warp has ROWS rows in
// flight), reduced by a butterfly. Max and sum: per-thread strided
// partials, a butterfly per warp, then the eight warp results added in
// order. Values: 256 / D thread groups take every (256 / D)-th position,
// one thread per head-dim element (coalesced rows); the groups' partials
// are added in order. decode_combine, grid (H, S): m = max_c m_c,
// l = sum_c exp(m_c - m) l_c and out = sum_c exp(m_c - m) o_c / l over the
// slot's chunks c < ceil(n / CHUNK), in chunk order. Chunks are fixed by
// position, so the order of every sum depends on n and D alone.
//
// Bound: bytes. Each visible K and V row of each slot is read once, q read
// and out written once.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>

namespace da {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 8;     // positions a warp scores at once
constexpr int CHUNK = 128;  // positions a partial block takes
constexpr int MAX_D = 256;

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

// every thread gets the block's sum (or max); the warps' results are
// combined in warp order
__device__ __forceinline__ float block_sum(float x, float* red) {
  for (int off = 16; off; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float r = 0.f;
  for (int w = 0; w < WARPS; ++w) r += red[w];
  __syncthreads();
  return r;
}

__device__ __forceinline__ float block_max(float x, float* red) {
  for (int off = 16; off; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float r = -INFINITY;
  for (int w = 0; w < WARPS; ++w) r = fmaxf(r, red[w]);
  __syncthreads();
  return r;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_partial(const T* __restrict__ q, long long qs0, long long qs1,
               const T* __restrict__ k, const T* __restrict__ v,
               long long ks0, long long ks1, long long ks2,
               const long long* __restrict__ pos, float* __restrict__ ws,
               int L, int D, float scale) {
  __shared__ float sc[CHUNK];
  __shared__ float qf[MAX_D];
  __shared__ float part[THREADS];
  __shared__ float red[WARPS];
  const int h = blockIdx.x, s = blockIdx.y, c = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long p = pos[s];
  const int n = p < 0 ? 1 : (p >= L ? L : static_cast<int>(p) + 1);
  const int t_lo = c * CHUNK;
  if (t_lo >= n) return;
  const int t_n = min(CHUNK, n - t_lo);

  const T* qr = q + s * qs0 + h * qs1;
  for (int d = tid; d < D; d += THREADS) qf[d] = ld(qr + d);
  __syncthreads();

  // each warp takes ROWS consecutive positions at a time, their loads in
  // flight together; a score's sum order is the same whichever warp
  // computes it
  const T* kb = k + s * ks0 + h * ks2 + t_lo * ks1;
  for (int t0 = warp * ROWS; t0 < t_n; t0 += WARPS * ROWS) {
    float acc[ROWS];
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      acc[u] = 0.f;
      if (t0 + u < t_n) {
        const T* kr = kb + (t0 + u) * ks1;
        for (int d = lane; d < D; d += 32)
          acc[u] = fmaf(qf[d], ld(kr + d), acc[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      for (int off = 16; off; off >>= 1)
        acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], off);
      if (lane == 0 && t0 + u < t_n) sc[t0 + u] = acc[u] * scale;
    }
  }
  __syncthreads();

  float m = -INFINITY;
  for (int t = tid; t < t_n; t += THREADS) m = fmaxf(m, sc[t]);
  m = block_max(m, red);
  float sum = 0.f;
  for (int t = tid; t < t_n; t += THREADS) {
    const float e = expf(sc[t] - m);
    sc[t] = e;
    sum += e;
  }
  sum = block_sum(sum, red);     // its barrier publishes sc

  const int G = THREADS / D;
  const int g = tid / D, d = tid - g * D;
  float acc = 0.f;
  if (g < G) {
    const T* vb = v + s * ks0 + h * ks2 + t_lo * ks1 + d;
#pragma unroll 4
    for (int t = g; t < t_n; t += G)
      acc = fmaf(sc[t], ld(vb + t * ks1), acc);
  }
  part[tid] = acc;
  __syncthreads();
  // workspace of (slot, head): NC records of D + 2 floats (o_c, m_c, l_c)
  const int NC = (L + CHUNK - 1) / CHUNK;
  float* rec = ws + ((static_cast<long long>(s) * gridDim.x + h) * NC + c)
                        * (D + 2);
  if (tid < D) {
    float r = 0.f;
    for (int gg = 0; gg < G; ++gg) r += part[gg * D + tid];
    rec[tid] = r;
  }
  if (tid == 0) {
    rec[D] = m;
    rec[D + 1] = sum;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_combine(const long long* __restrict__ pos,
               const float* __restrict__ ws, T* __restrict__ out,
               long long os0, long long os1, int L, int D) {
  const int h = blockIdx.x, s = blockIdx.y, d = threadIdx.x;
  if (d >= D) return;
  const long long p = pos[s];
  const int n = p < 0 ? 1 : (p >= L ? L : static_cast<int>(p) + 1);
  const int NC = (L + CHUNK - 1) / CHUNK, nc = (n + CHUNK - 1) / CHUNK;
  const float* rec = ws + (static_cast<long long>(s) * gridDim.x + h) * NC
                              * (D + 2);
  float m = -INFINITY;
  for (int c = 0; c < nc; ++c) m = fmaxf(m, rec[c * (D + 2) + D]);
  float l = 0.f, o = 0.f;
  for (int c = 0; c < nc; ++c) {
    const float* r = rec + c * (D + 2);
    const float w = expf(r[D] - m);
    l = fmaf(w, r[D + 1], l);
    o = fmaf(w, r[d], o);
  }
  st(out + s * os0 + h * os1 + d, o / l);
}

template <typename T>
int launch(const void* q, long long qs0, long long qs1, const void* k,
           const void* v, long long ks0, long long ks1, long long ks2,
           const void* pos, void* ws, void* out, long long os0,
           long long os1, int S, int H, int L, int D, float scale,
           cudaStream_t stream) {
  const int NC = (L + CHUNK - 1) / CHUNK;
  decode_partial<T><<<dim3(H, S, NC), THREADS, 0, stream>>>(
      static_cast<const T*>(q), qs0, qs1, static_cast<const T*>(k),
      static_cast<const T*>(v), ks0, ks1, ks2,
      static_cast<const long long*>(pos), static_cast<float*>(ws), L, D,
      scale);
  decode_combine<T><<<dim3(H, S), THREADS, 0, stream>>>(
      static_cast<const long long*>(pos), static_cast<const float*>(ws),
      static_cast<T*>(out), os0, os1, L, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace da

// dtype: 0 f32, 1 bf16, 2 fp16. q (S, H, D) with strides (qs0, qs1, 1);
// k and v (S, L, H, D) with strides (ks0, ks1, ks2, 1); pos (S,) int64;
// ws an f32 workspace of S * H * ceil(L / 128) * (D + 2) floats; out
// (S, H, D) with strides (os0, os1, 1).
extern "C" int mxt_decode_attention(int dtype, const void* q, long long qs0,
                                    long long qs1, const void* k,
                                    const void* v, long long ks0,
                                    long long ks1, long long ks2,
                                    const void* pos, void* ws, void* out,
                                    long long os0, long long os1, int S,
                                    int H, int L, int D, float scale,
                                    void* stream) {
  if (dtype < 0 || dtype > 2 || S < 1 || H < 1 || L < 1 || D < 1 ||
      D > da::MAX_D || S > 65535 || H > 65535 || !q || !k || !v || !pos ||
      !ws || !out)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return da::launch<float>(q, qs0, qs1, k, v, ks0, ks1, ks2, pos, ws, out,
                             os0, os1, S, H, L, D, scale, s);
  if (dtype == 1)
    return da::launch<__nv_bfloat16>(q, qs0, qs1, k, v, ks0, ks1, ks2, pos,
                                     ws, out, os0, os1, S, H, L, D, scale, s);
  return da::launch<__half>(q, qs0, qs1, k, v, ks0, ks1, ks2, pos, ws, out,
                            os0, os1, S, H, L, D, scale, s);
}
