// One-token decode attention over a slot-based KV cache, for Hopper
// (sm_90a), bound through a plain C entry: one kernel a call.
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
// rows, and every sum runs in an order fixed by position, n and the head
// dim alone, so a slot's output has the same bits whatever the bucket L
// (the rows past n are never read), the slot index, the number of slots or
// the other slots' contents. That is what lets the generation engine
// migrate a sequence to a larger KV bucket, or score k + 1 positions in one
// speculative pass, without changing a token.
//
// Bound: bytes. Each visible K and V row of each slot is read once, q read
// and out written once. What the design does about it:
// - grid (H, S, ceil(L / CHUNK)): block c takes positions [c * CHUNK,
//   (c + 1) * CHUNK) of its slot and head (a block past the slot's n
//   returns at once); each of its 4 warps takes CHUNK / 4 of them;
// - 16-byte copies: a lane holds 8 elements of a row (one 16-byte copy in
//   16 bits), LPR = 8, 16 or 32 lanes a row for D <= 64, 128, 256, so a
//   D = 64 row is 8 lanes and a warp takes 4 rows a wave;
// - a ring in shared memory, STAGES stages a warp of STAGE_WAVES waves of K
//   and of V each, filled by cp.async: a warp computes on one stage while
//   the next STAGES - 1 are in flight, K and V together. Each lane copies
//   only what it reads itself, so a lane's own cp.async.wait_group is all
//   the ordering the ring needs (no barrier, no mbarrier);
// - an online softmax: each lane keeps the running max, sum and its 8
//   columns of the output over its rows, the rows of a warp are merged by
//   a butterfly over the lanes of one column segment, the 4 warps in warp
//   order in shared memory;
// - the combine in the same launch: a slot's only chunk (n <= CHUNK) writes
//   out at once; otherwise each chunk writes its (o, m, l) record to the
//   f32 workspace, and the last block of its (slot, head) to finish (a
//   ticket from the slot's counter, atomicInc wrapping it back to 0 for the
//   next call or graph replay) reads the records in chunk order: arrival
//   order never enters a sum. It loads every chunk's (m, l) at once into
//   shared memory and each output column's records unrolled, so the
//   combine waits on two loads' latency, not on one a chunk;
// - head dims above 256 (decode_wide): a warp takes one row at a time, its
//   lanes striding the row's 8-element segments, q and each warp's output
//   columns in shared memory, so any head dim that fits in shared memory
//   runs; the same chunks, merge and combine, no ring.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace da {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int CHUNK = 256;                // positions a block
constexpr int ROWS_W = CHUNK / WARPS;     // positions a warp
constexpr int SEG = 8;                    // elements a lane copies at once
constexpr int STAGE_WAVES = 4;            // waves of rows a ring stage
constexpr int STAGES = 3;                 // ring stages a warp
constexpr int SMEM_MAX = 227 * 1024;

__device__ __forceinline__ float tof(float x) { return x; }
__device__ __forceinline__ float tof(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float tof(__half x) { return __half2float(x); }
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void st(__half* p, float x) {
  *p = __float2half_rn(x);
}

// 8 elements of a row, as loaded: one 16-byte access for 16 bits, two for
// f32 where the row is aligned and the segment whole, else element by
// element (zero past the head dim)
template <typename T> struct Seg {
  uint4 x;
  __device__ __forceinline__ void zero() { x = make_uint4(0, 0, 0, 0); }
  __device__ __forceinline__ void load(const T* p, int d0, int D, bool vec) {
    if (vec && d0 + SEG <= D) {
      x = *reinterpret_cast<const uint4*>(p + d0);
    } else {
      T* e = reinterpret_cast<T*>(&x);
#pragma unroll
      for (int i = 0; i < SEG; ++i)
        e[i] = d0 + i < D ? p[d0 + i] : T(0.f);
    }
  }
  __device__ __forceinline__ void get(float* f) const {
    const T* e = reinterpret_cast<const T*>(&x);
#pragma unroll
    for (int i = 0; i < SEG; ++i) f[i] = tof(e[i]);
  }
};
template <> struct Seg<float> {
  float4 x, y;
  __device__ __forceinline__ void zero() {
    x = y = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __device__ __forceinline__ void load(const float* p, int d0, int D,
                                       bool vec) {
    if (vec && d0 + SEG <= D) {
      x = *reinterpret_cast<const float4*>(p + d0);
      y = *reinterpret_cast<const float4*>(p + d0 + 4);
    } else {
      float* e = reinterpret_cast<float*>(this);
#pragma unroll
      for (int i = 0; i < SEG; ++i) e[i] = d0 + i < D ? p[d0 + i] : 0.f;
    }
  }
  __device__ __forceinline__ void get(float* f) const {
    f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
    f[4] = y.x; f[5] = y.y; f[6] = y.z; f[7] = y.w;
  }
};

// A lane's segment of one row into its place in the ring: cp.async (16
// bytes, zero-filled for a row past n) where the segment is whole and
// aligned, else loaded and stored by the lane; `row` is a readable row
// (the slot's first) when !ok.
template <typename T>
__device__ __forceinline__ void fetch(Seg<T>* dst, const T* row, int d0,
                                      int D, bool ok, bool vec) {
  if (vec) {
    const char* src = reinterpret_cast<const char*>(row + (ok ? d0 : 0));
#pragma unroll
    for (int i = 0; i < static_cast<int>(sizeof(Seg<T>)) / 16; ++i)
      hop::cp16(reinterpret_cast<char*>(dst) + 16 * i, src + 16 * i, ok);
  } else {
    Seg<T> x;
    if (ok) x.load(row, d0, D, false);
    else x.zero();
    *dst = x;
  }
}

struct Params {
  const void* q;
  long long qs0, qs1;
  const void* k;
  const void* v;
  long long ks0, ks1, ks2;
  const long long* pos;
  float* ws;              // S * H * ceil(L / CHUNK) records of D + 2 floats
  unsigned int* cnt;      // S * H tickets, 0 between calls
  void* out;
  long long os0, os1;
  int S, H, L, D;
  float scale;
  int vec;                // every row 16-byte aligned: vector loads
};

// exp(x - m), 0 for x = -inf (a lane or warp that saw no row)
__device__ __forceinline__ float wexp(float x, float m) {
  return x == -INFINITY ? 0.f : expf(x - m);
}

__host__ __device__ __forceinline__ int chunks(int L) {
  return (L + CHUNK - 1) / CHUNK;
}

__device__ __forceinline__ int visible(const Params& a, int s) {
  const long long p = a.pos[s];
  return p < 0 ? 1 : (p >= a.L ? a.L : static_cast<int>(p) + 1);
}

// decode_rows' shape for LPR lanes a row: RPW rows a wave, WAVES waves a
// warp in NST ring stages of SW waves, a stage SLOT segments (K then V)
template <typename T, int LPR> struct Shape {
  static constexpr int RPW = 32 / LPR;
  static constexpr int WAVES = ROWS_W / RPW;
  static constexpr int SW = WAVES < STAGE_WAVES ? WAVES : STAGE_WAVES;
  static constexpr int NST = WAVES / SW;
  static constexpr int SLOT = 2 * SW * 32;
  static constexpr size_t RING = sizeof(Seg<T>) * WARPS * STAGES * SLOT;
  static_assert(WAVES % SW == 0, "a warp's waves fill whole stages");
};

// Shared memory after the ring (decode_rows) or nothing (decode_wide):
// each warp's (m, l) and output columns, (decode_wide) q in f32, and the
// combine's chunk maxima (then weights) and sums.
struct Smem {
  float* m;     // [WARPS]
  float* l;     // [WARPS]
  float* o;     // [WARPS][D]
  float* q;     // [D], decode_wide
  float* cm;    // [chunks(L)]
  float* cl;    // [chunks(L)]
  int* last;
};

__device__ __forceinline__ Smem carve(unsigned char* raw, size_t ring, int D,
                                      int NC, bool wide) {
  float* base = reinterpret_cast<float*>(raw + ring);
  Smem sm;
  sm.m = base;
  sm.l = base + WARPS;
  sm.last = reinterpret_cast<int*>(base + 2 * WARPS);
  sm.o = base + 2 * WARPS + 4;
  sm.q = sm.o + WARPS * D;
  sm.cm = sm.q + (wide ? D : 0);
  sm.cl = sm.cm + NC;
  return sm;
}

inline size_t smem_bytes(size_t ring, int D, int L, bool wide) {
  return ring + sizeof(float) * (2 * WARPS + 4 +
                                 static_cast<size_t>(WARPS) * D +
                                 (wide ? D : 0) + 2 * chunks(L));
}

// The block's end: the 4 warps merged in warp order into the chunk's
// (o, m, l); the slot's only chunk writes out, else the chunk's record goes
// to the workspace and the last of the slot's chunks combines them all in
// chunk order.
template <typename T>
__device__ void finish(const Params& a, const Smem& sm, int s, int h, int c,
                       int n) {
  __syncthreads();
  float M = -INFINITY;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) M = fmaxf(M, sm.m[w]);
  float wt[WARPS], Lc = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    wt[w] = wexp(sm.m[w], M);
    Lc = fmaf(sm.l[w], wt[w], Lc);
  }
  const int nc = chunks(n);
  T* orow = static_cast<T*>(a.out) + s * a.os0 + h * a.os1;
  if (nc == 1) {
    for (int d = threadIdx.x; d < a.D; d += THREADS) {
      float o = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) o = fmaf(sm.o[w * a.D + d], wt[w], o);
      st(orow + d, o / Lc);
    }
    return;
  }
  float* recs = a.ws + (static_cast<long long>(s) * a.H + h) *
                           chunks(a.L) * (a.D + 2);
  float* rec = recs + static_cast<long long>(c) * (a.D + 2);
  for (int d = threadIdx.x; d < a.D; d += THREADS) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) o = fmaf(sm.o[w * a.D + d], wt[w], o);
    rec[d] = o;
  }
  if (threadIdx.x == 0) {
    rec[a.D] = M;
    rec[a.D + 1] = Lc;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned t = atomicInc(a.cnt + s * a.H + h, nc - 1);
    *sm.last = t == static_cast<unsigned>(nc - 1);
  }
  __syncthreads();
  if (!*sm.last) return;
  __threadfence();
  // every chunk's (m, l) at once, then the weights exp(m_c - m) in place
  for (int cc = threadIdx.x; cc < nc; cc += THREADS) {
    const float* r = recs + cc * (a.D + 2);
    sm.cm[cc] = __ldcg(r + a.D);
    sm.cl[cc] = __ldcg(r + a.D + 1);
  }
  __syncthreads();
  float m = -INFINITY;
  for (int cc = 0; cc < nc; ++cc) m = fmaxf(m, sm.cm[cc]);
  float l = 0.f;
  for (int cc = 0; cc < nc; ++cc) l = fmaf(expf(sm.cm[cc] - m), sm.cl[cc], l);
  __syncthreads();
  for (int cc = threadIdx.x; cc < nc; cc += THREADS)
    sm.cm[cc] = expf(sm.cm[cc] - m);
  __syncthreads();
  for (int d = threadIdx.x; d < a.D; d += THREADS) {
    float o = 0.f;
#pragma unroll 8
    for (int cc = 0; cc < nc; ++cc)
      o = fmaf(sm.cm[cc], __ldcg(recs + cc * (a.D + 2) + d), o);
    st(orow + d, o / l);
  }
}

// D <= 8 * LPR: LPR lanes a row, the warp's rows streamed through its ring.
template <typename T, int LPR>
__global__ void __launch_bounds__(THREADS) decode_rows(const Params a) {
  using R = Shape<T, LPR>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x, s = blockIdx.y, c = blockIdx.z;
  const int n = visible(a, s);
  const int t_lo = c * CHUNK;
  if (t_lo >= n) return;
  const Smem sm = carve(smem, R::RING, a.D, chunks(a.L), false);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane / LPR, d0 = (lane % LPR) * SEG;
  const bool cols = d0 < a.D;
  const bool vec = a.vec && d0 + SEG <= a.D;
  const T* kb = static_cast<const T*>(a.k) + s * a.ks0 + h * a.ks2;
  const T* vb = static_cast<const T*>(a.v) + s * a.ks0 + h * a.ks2;
  const int t_w0 = t_lo + warp * ROWS_W, t_w = t_w0 + r;
  // the stages that hold the warp's visible rows (the same on every lane)
  const int rows = min(n - t_w0, ROWS_W);
  const int nst = rows <= 0 ? 0 : (rows + R::SW * R::RPW - 1) /
                                      (R::SW * R::RPW);
  Seg<T>* ring = reinterpret_cast<Seg<T>*>(smem) +
                 warp * STAGES * R::SLOT + lane;
  auto load_stage = [&](int stage) {
    Seg<T>* slot = ring + (stage % STAGES) * R::SLOT;
#pragma unroll
    for (int u = 0; u < R::SW; ++u) {
      const int t = t_w + (stage * R::SW + u) * R::RPW;
      const bool ok = t < n && cols;
      fetch(slot + u * 32, ok ? kb + t * a.ks1 : kb, d0, a.D, ok, vec);
      fetch(slot + (R::SW + u) * 32, ok ? vb + t * a.ks1 : vb, d0, a.D, ok,
            vec);
    }
  };
#pragma unroll
  for (int stage = 0; stage < STAGES - 1; ++stage) {
    if (stage < nst) load_stage(stage);
    hop::cp_commit();
  }

  float qf[SEG];
  {
    Seg<T> qs;
    if (cols)
      qs.load(static_cast<const T*>(a.q) + s * a.qs0 + h * a.qs1, d0, a.D,
              a.vec);
    else
      qs.zero();
    qs.get(qf);
  }
  float m = -INFINITY, l = 0.f, o[SEG];
#pragma unroll
  for (int i = 0; i < SEG; ++i) o[i] = 0.f;
  for (int stage = 0; stage < nst; ++stage) {
    __syncwarp();                   // the slot refilled was read last stage
    if (stage + STAGES - 1 < nst) load_stage(stage + STAGES - 1);
    hop::cp_commit();
    hop::cp_wait<STAGES - 1>();     // this lane's copies of `stage` landed
    const Seg<T>* slot = ring + (stage % STAGES) * R::SLOT;
    float sc[R::SW];
    float mx = m;
#pragma unroll
    for (int u = 0; u < R::SW; ++u) {
      const Seg<T> ks = slot[u * 32];
      float kf[SEG], x = 0.f;
      ks.get(kf);
#pragma unroll
      for (int i = 0; i < SEG; ++i) x = fmaf(qf[i], kf[i], x);
#pragma unroll
      for (int off = 1; off < LPR; off <<= 1)
        x += __shfl_xor_sync(0xffffffffu, x, off);
      sc[u] = t_w + (stage * R::SW + u) * R::RPW < n ? x * a.scale
                                                     : -INFINITY;
      mx = fmaxf(mx, sc[u]);
    }
    if (mx == -INFINITY) continue;            // none of this lane's rows
    const float corr = wexp(m, mx);
    l *= corr;
#pragma unroll
    for (int i = 0; i < SEG; ++i) o[i] *= corr;
#pragma unroll
    for (int u = 0; u < R::SW; ++u) {
      const float p = wexp(sc[u], mx);
      const Seg<T> vs = slot[(R::SW + u) * 32];
      float vf[SEG];
      vs.get(vf);
      l += p;
#pragma unroll
      for (int i = 0; i < SEG; ++i) o[i] = fmaf(p, vf[i], o[i]);
    }
    m = mx;
  }
  // the warp's row groups merged, lanes of one column segment together
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, off);
    const float mx = fmaxf(m, m2);
    const float a1 = mx == -INFINITY ? 0.f : wexp(m, mx);
    const float a2 = mx == -INFINITY ? 0.f : wexp(m2, mx);
    l = __fadd_rn(__fmul_rn(l, a1), __fmul_rn(l2, a2));
#pragma unroll
    for (int i = 0; i < SEG; ++i) {
      const float o2 = __shfl_xor_sync(0xffffffffu, o[i], off);
      o[i] = __fadd_rn(__fmul_rn(o[i], a1), __fmul_rn(o2, a2));
    }
    m = mx;
  }
  if (r == 0 && cols) {
#pragma unroll
    for (int i = 0; i < SEG; ++i)
      if (d0 + i < a.D) sm.o[warp * a.D + d0 + i] = o[i];
  }
  if (lane == 0) {
    sm.m[warp] = m;
    sm.l[warp] = l;
  }
  finish<T>(a, sm, s, h, c, n);
}

// D > 256: a warp takes one row at a time, its lanes over the row's
// 8-element segments; q and the warps' output columns in shared memory.
template <typename T>
__global__ void __launch_bounds__(THREADS) decode_wide(const Params a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x, s = blockIdx.y, c = blockIdx.z;
  const int n = visible(a, s);
  const int t_lo = c * CHUNK;
  if (t_lo >= n) return;
  const Smem sm = carve(smem, 0, a.D, chunks(a.L), true);
  float* qs = sm.q;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* qr = static_cast<const T*>(a.q) + s * a.qs0 + h * a.qs1;
  for (int d = threadIdx.x; d < a.D; d += THREADS) qs[d] = tof(qr[d]);
  float* ow = sm.o + warp * a.D;
  for (int d = lane; d < a.D; d += 32) ow[d] = 0.f;
  __syncthreads();
  const int nseg = (a.D + SEG - 1) / SEG;
  const T* kb = static_cast<const T*>(a.k) + s * a.ks0 + h * a.ks2;
  const T* vb = static_cast<const T*>(a.v) + s * a.ks0 + h * a.ks2;
  float m = -INFINITY, l = 0.f;
  for (int i = 0; i < ROWS_W; ++i) {
    const int t = t_lo + warp * ROWS_W + i;
    if (t >= n) break;
    const T* kr = kb + t * a.ks1;
    float x = 0.f;
    for (int g = lane; g < nseg; g += 32) {
      Seg<T> ks;
      ks.load(kr, g * SEG, a.D, a.vec);
      float kf[SEG];
      ks.get(kf);
#pragma unroll
      for (int e = 0; e < SEG; ++e)
        if (g * SEG + e < a.D) x = fmaf(qs[g * SEG + e], kf[e], x);
    }
#pragma unroll
    for (int off = 16; off; off >>= 1)
      x += __shfl_xor_sync(0xffffffffu, x, off);
    const float sc = x * a.scale;
    const float mx = fmaxf(m, sc);
    const float corr = wexp(m, mx), p = expf(sc - mx);
    l = fmaf(l, corr, p);
    const T* vr = vb + t * a.ks1;
    for (int g = lane; g < nseg; g += 32) {
      Seg<T> vs;
      vs.load(vr, g * SEG, a.D, a.vec);
      float vf[SEG];
      vs.get(vf);
#pragma unroll
      for (int e = 0; e < SEG; ++e) {
        const int d = g * SEG + e;
        if (d < a.D) ow[d] = fmaf(p, vf[e], ow[d] * corr);
      }
    }
    m = mx;
  }
  if (lane == 0) {
    sm.m[warp] = m;
    sm.l[warp] = l;
  }
  finish<T>(a, sm, s, h, c, n);
}

// The kernel for (T, D) and its shared memory at bucket L.
template <typename T>
void (*pick(int D, int L, size_t* smem))(Params) {
  const int segs = (D + SEG - 1) / SEG;
  if (segs > 32) {
    *smem = smem_bytes(0, D, L, true);
    return decode_wide<T>;
  }
  if (segs <= 8) {
    *smem = smem_bytes(Shape<T, 8>::RING, D, L, false);
    return decode_rows<T, 8>;
  }
  if (segs <= 16) {
    *smem = smem_bytes(Shape<T, 16>::RING, D, L, false);
    return decode_rows<T, 16>;
  }
  *smem = smem_bytes(Shape<T, 32>::RING, D, L, false);
  return decode_rows<T, 32>;
}

template <typename T>
cudaError_t launch(const Params& a, cudaStream_t stream) {
  size_t smem = 0;
  void (*kern)(Params) = pick<T>(a.D, a.L, &smem);
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(a.H, a.S, chunks(a.L));
  kern<<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace da

// Positions a block takes (the workspace holds ceil(L / this) records a
// slot and head).
extern "C" int mxt_decode_chunk() { return da::CHUNK; }

// 1 if a block's shared memory holds the kernel for dtype (0 f32, 1 bf16,
// 2 fp16), head dim D and bucket L, else 0.
extern "C" int mxt_decode_fits(int dtype, int L, int D) {
  size_t smem = 0;
  if (dtype == 0) da::pick<float>(D, L, &smem);
  else if (dtype == 1) da::pick<__nv_bfloat16>(D, L, &smem);
  else da::pick<__half>(D, L, &smem);
  return smem <= static_cast<size_t>(da::SMEM_MAX);
}

// dtype: 0 f32, 1 bf16, 2 fp16. q (S, H, D) with strides (qs0, qs1, 1);
// k and v (S, L, H, D) with strides (ks0, ks1, ks2, 1); pos (S,) int64; ws
// an f32 workspace of S * H * ceil(L / CHUNK) * (D + 2) floats; cnt S * H
// unsigned ints, 0 before the call and after it; out (S, H, D) with
// strides (os0, os1, 1); vec: q, k and v may be read 16 bytes at a time
// (every row 16-byte aligned).
extern "C" int mxt_decode_attention(int dtype, const void* q, long long qs0,
                                    long long qs1, const void* k,
                                    const void* v, long long ks0,
                                    long long ks1, long long ks2,
                                    const void* pos, void* ws, void* cnt,
                                    void* out, long long os0, long long os1,
                                    int S, int H, int L, int D, float scale,
                                    int vec, void* stream) {
  if (dtype < 0 || dtype > 2 || S < 1 || H < 1 || L < 1 || D < 1 ||
      S > 65535 || H > 65535 || !q || !k || !v || !pos || !ws || !cnt ||
      !out)
    return static_cast<int>(cudaErrorInvalidValue);
  const da::Params a{q, qs0, qs1, k, v, ks0, ks1, ks2,
                     static_cast<const long long*>(pos),
                     static_cast<float*>(ws),
                     static_cast<unsigned int*>(cnt), out, os0, os1, S, H,
                     L, D, scale, vec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(da::launch<float>(a, s));
  if (dtype == 1) return static_cast<int>(da::launch<__nv_bfloat16>(a, s));
  return static_cast<int>(da::launch<__half>(a, s));
}
