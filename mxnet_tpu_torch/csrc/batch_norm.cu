// BatchNorm's training forward and backward for Hopper (sm_90a), bound
// through plain C entries.
//
// Counterpart of mxnet_tpu/ops/nn.py, _bn_train_math, _bn_train_fwd and
// _bn_train_bwd (the custom VJP of _bn_train_core) and _bn_batch_stats. The
// JAX package leaves this math to XLA, so no Pallas kernel is replaced.
// Over x viewed as (outer, C, inner) (NCHW: inner = H*W; NHWC and 2-d:
// inner = 1), per channel c and over its N = outer*inner elements:
//   bn_stats:      S1 = sum(x - s), S2 = sum((x - s)^2) about a shift s, in f32;
//                  shifted: mean = S1/N + s, var = max(S2/N - (S1/N)^2, 0);
//                  centered (s = the mean of a first sweep): var = S2/N;
//                  inv = 1/sqrt(var + eps)
//   bn_apply:      out = ((x - mean) * inv) * g + b                 (x's dtype)
//   bn_bwd_reduce: db = sum(dy), dg = sum(dy * (x - mean) * inv)    (f32)
//   bn_bwd_apply:  dx = (g*inv) * ((dy - db*(1/N)) - xhat * dg*(1/N))
//                       + dmean*(1/N) + dvar*(2/N) * (x - mean)     (x's dtype)
//                  each of the three terms only when its operand is given
// The elementwise kernels round every f32 operation as the plain versions in
// ops/cuda/batch_norm.py do (__fsub_rn, __fmul_rn, __fadd_rn are never
// contracted into an FMA), so with the same statistics they write the same
// bits.
//
// One walk serves all four. A block takes a group of cg channels of a split
// of the images. Where a channel's run is long (inner >= 256) a group is one
// channel, and the block's threads walk the (image, vector) pairs of its
// runs. Otherwise a group is as many whole runs as the block's threads hold
// at once (one image's cg*inner contiguous elements, up to 1024 or 2048), so
// short runs (M = 49, 196) and channel rows (NHWC) are read as long
// contiguous spans; each thread keeps its positions' sums (or its
// positions' per-channel coefficients) in registers across the images, each
// position with its own channel, and where a span is shorter than the block,
// the threads take several images at once (rows). Accesses are 16 bytes
// where every vector starts 16-byte aligned (a run of one channel, or a span
// of several: there a vector may hold the end of one channel's run and the
// start of the next, so M = 196 and 49 take 16-byte loads too), else 8
// bytes where every one starts 8-byte aligned, else one element
// (ops/cuda/batch_norm.py:bn_plan decides).
//
// The sums are the same from run to run, to the bit: each thread adds its
// elements in a fixed order, a block adds its threads' sums in a fixed tree
// and writes one partial per channel to a workspace, and the last block of a
// channel group to finish (an integer counter; no float atomics) adds the
// splits' partials in a fixed order and writes the results.
#include <stdint.h>
#include <type_traits>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace bn {

constexpr int T = 256;          // threads a block
constexpr int WARPS = T / 32;
constexpr int MAX_SPAN = 2048;  // positions a group's span may hold

template <typename E> __device__ __forceinline__ float to_f(E v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f<__half>(__half v) {
  return __half2float(v);
}
template <typename E> __device__ __forceinline__ E from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}

// a vector of V elements: one 16- or 8-byte access, or one element
template <typename E, int V> struct Vec {
  using T = typename std::conditional<V * sizeof(E) == 16, uint4,
                                      uint2>::type;
};

template <typename E, int V>
__device__ __forceinline__ void load(const E* p, float (&f)[V]) {
  if constexpr (V == 1) {
    f[0] = to_f(p[0]);
  } else {
    static_assert(V * sizeof(E) == 16 || V * sizeof(E) == 8,
                  "vectors are 16 or 8 bytes");
    typename Vec<E, V>::T u = *reinterpret_cast<const typename Vec<E, V>::T*>(p);
    const E* e = reinterpret_cast<const E*>(&u);
#pragma unroll
    for (int j = 0; j < V; ++j) f[j] = to_f(e[j]);
  }
}

template <typename E, int V>
__device__ __forceinline__ void store(E* p, const float (&f)[V]) {
  if constexpr (V == 1) {
    p[0] = from_f<E>(f[0]);
  } else {
    typename Vec<E, V>::T u;
    E* e = reinterpret_cast<E*>(&u);
#pragma unroll
    for (int j = 0; j < V; ++j) e[j] = from_f<E>(f[j]);
    *reinterpret_cast<typename Vec<E, V>::T*>(p) = u;
  }
}

// slots a thread holds in a group's span: four elements' worth (one 16-byte
// vector of 16-bit elements: eight)
template <int V> struct Slots { static constexpr int value = V >= 4 ? 1 : 4 / V; };

// The walk of a block: its channel group [c0, c0 + cn) and images [o0, o1).
struct Walk {
  int outer, C, inner;
  int cg;     // channels a group (1: one channel's runs, walked flat)
  int per;    // images a split
  int rows;   // images a pass of a group's span (grouped walk)
  int c0, cn, o0, o1;
  __device__ void init(int outer_, int C_, int inner_, int cg_, int per_,
                       int rows_) {
    outer = outer_; C = C_; inner = inner_; cg = cg_; per = per_; rows = rows_;
    c0 = blockIdx.x * cg;
    cn = min(cg, C - c0);
    o0 = blockIdx.y * per;
    o1 = min(outer, o0 + per);
  }
  __device__ __forceinline__ size_t off(int o, int pos) const {
    return (static_cast<size_t>(o) * C + c0) * inner + pos;
  }
};

// ------------------------------------------------------------- reductions
// KIND 0 (bn_stats): per element d = x - s; s1 += d, s2 += d*d.
// KIND 1 (bn_bwd_reduce): xhat = (x - mean)*inv; s1 += dy, s2 += dy*xhat.
struct RArgs {
  const void* x;
  const void* dy;
  const float* p0;     // KIND 0: shift (null: 0); KIND 1: mean
  const float* p1;     // KIND 1: inv
  float* ws;           // (splits, C, 2) partial sums
  int* count;          // a counter a group, zero at launch
  float* o0;           // KIND 0: mean (null: not written); KIND 1: dg
  float* o1;           // KIND 0: var;  KIND 1: db
  float* o2;           // KIND 0: inv
  int outer, C, inner, cg, per, rows, splits;
  int centered;
  float eps, nf;
};

template <int KIND>
__device__ __forceinline__ void chan_consts(const RArgs& a, int c, float& k0,
                                            float& k1) {
  if (KIND == 0) {
    k0 = a.p0 ? a.p0[c] : 0.f;
    k1 = 0.f;
  } else {
    k0 = a.p0[c];
    k1 = a.p1[c];
  }
}

template <int KIND>
__device__ __forceinline__ void accumulate(float xv, float dyv, float k0,
                                           float k1, float& s1, float& s2) {
  if (KIND == 0) {
    float d = xv - k0;
    s1 += d;
    s2 += d * d;
  } else {
    float xh = __fmul_rn(__fsub_rn(xv, k0), k1);
    s1 += dyv;
    s2 += dyv * xh;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The last block of a group adds the splits' partials in a fixed order (a
// lane each split mod 32, then a fixed tree) and writes the group's
// results.
template <int KIND>
__device__ void finish(const RArgs& a, const Walk& w) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(a.count + blockIdx.x, 1) == a.splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = warp; j < w.cn; j += WARPS) {
    const int c = w.c0 + j;
    float s1 = 0.f, s2 = 0.f;
    for (int s = lane; s < a.splits; s += 32) {
      const float2 p = __ldcg(
          reinterpret_cast<const float2*>(a.ws) + static_cast<size_t>(s) * a.C + c);
      s1 += p.x;
      s2 += p.y;
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane != 0) continue;
    if (KIND == 0) {
      float k0 = a.p0 ? a.p0[c] : 0.f;
      float var;
      if (a.centered) {
        var = s2 / a.nf;
      } else {
        const float mc = s1 / a.nf;
        var = fmaxf(__fsub_rn(s2 / a.nf, __fmul_rn(mc, mc)), 0.f);
        if (a.o0) a.o0[c] = __fadd_rn(mc, k0);
      }
      a.o1[c] = var;
      a.o2[c] = 1.f / sqrtf(__fadd_rn(var, a.eps));
    } else {
      a.o0[c] = s2;
      a.o1[c] = s1;
    }
  }
}

__device__ __forceinline__ void write_partial(const RArgs& a, int c, float s1,
                                              float s2) {
  reinterpret_cast<float2*>(a.ws)[static_cast<size_t>(blockIdx.y) * a.C + c] =
      make_float2(s1, s2);
}

template <typename E, int V, bool ONE, int KIND>
__global__ void __launch_bounds__(T) reduce_kernel(RArgs a) {
  Walk w;
  w.init(a.outer, a.C, a.inner, a.cg, a.per, a.rows);
  const E* x = static_cast<const E*>(a.x);
  const E* dy = static_cast<const E*>(a.dy);
  const int t = threadIdx.x;
  if constexpr (ONE) {
    // one channel: its runs, (image, vector) pairs walked flat
    float k0, k1;
    chan_consts<KIND>(a, w.c0, k0, k1);
    const int vpr = w.inner / V;            // vectors a run
    const int items = (w.o1 - w.o0) * vpr;
    float s1 = 0.f, s2 = 0.f;
#pragma unroll 4
    for (int i = t; i < items; i += T) {
      const int o = i / vpr;
      const size_t p = w.off(w.o0 + o, (i - o * vpr) * V);
      float xv[V], dv[V];
      load<E, V>(x + p, xv);
      if (KIND == 1) load<E, V>(dy + p, dv);
#pragma unroll
      for (int j = 0; j < V; ++j)
        accumulate<KIND>(xv[j], KIND == 1 ? dv[j] : 0.f, k0, k1, s1, s2);
    }
    __shared__ float red[2][WARPS];
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if ((t & 31) == 0) {
      red[0][t >> 5] = s1;
      red[1][t >> 5] = s2;
    }
    __syncthreads();
    if (t == 0) {
      float r1 = 0.f, r2 = 0.f;
#pragma unroll
      for (int i = 0; i < WARPS; ++i) {
        r1 += red[0][i];
        r2 += red[1][i];
      }
      write_partial(a, w.c0, r1, r2);
    }
  } else {
    // a group of whole runs: each thread's positions fixed across images
    constexpr int K = Slots<V>::value;
    __shared__ float sh[2][MAX_SPAN];
    const int span = w.cn * w.inner;
    const int nsf = w.cg * w.inner / V;     // vectors a full group's span
    const int nsl = span / V;
    int r = 0, slot0 = t, step = T;
    if (w.rows > 1) {
      r = t / nsf;
      slot0 = t - r * nsf;
      step = nsf;                           // one slot: the next is past the span
    }
    const bool active = r < w.rows;
    float s1[K][V], s2[K][V], k0[K][V], k1[K][V];
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int j = 0; j < V; ++j) {
        s1[k][j] = s2[k][j] = 0.f;
        const int s = slot0 + k * step;
        k0[k][j] = k1[k][j] = 0.f;
        if (active && s < nsl) chan_consts<KIND>(a, w.c0 + (s * V + j) / w.inner,
                                                 k0[k][j], k1[k][j]);
      }
    if (active) {
      for (int o = w.o0 + r; o < w.o1; o += w.rows) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int s = slot0 + k * step;
          if (s >= nsl) continue;
          const size_t p = w.off(o, s * V);
          float xv[V], dv[V];
          load<E, V>(x + p, xv);
          if (KIND == 1) load<E, V>(dy + p, dv);
#pragma unroll
          for (int j = 0; j < V; ++j)
            accumulate<KIND>(xv[j], KIND == 1 ? dv[j] : 0.f, k0[k][j],
                             k1[k][j], s1[k][j], s2[k][j]);
        }
      }
    }
    // the positions' sums, row by row, then each channel's in fixed order
    const int rows_here = w.rows;
    for (int rr = 0; rr < rows_here; ++rr) {
      if (active && r == rr) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int s = slot0 + k * step;
          if (s >= nsl) continue;
#pragma unroll
          for (int j = 0; j < V; ++j) {
            const int pos = s * V + j;
            if (rr == 0) {
              sh[0][pos] = s1[k][j];
              sh[1][pos] = s2[k][j];
            } else {
              sh[0][pos] += s1[k][j];
              sh[1][pos] += s2[k][j];
            }
          }
        }
      }
      __syncthreads();
    }
    if (w.inner >= 32) {
      const int lane = t & 31;
      for (int jc = t >> 5; jc < w.cn; jc += WARPS) {
        float r1 = 0.f, r2 = 0.f;
        for (int i = lane; i < w.inner; i += 32) {
          r1 += sh[0][jc * w.inner + i];
          r2 += sh[1][jc * w.inner + i];
        }
        r1 = warp_sum(r1);
        r2 = warp_sum(r2);
        if (lane == 0) write_partial(a, w.c0 + jc, r1, r2);
      }
    } else {
      for (int jc = t; jc < w.cn; jc += T) {
        float r1 = 0.f, r2 = 0.f;
        for (int i = 0; i < w.inner; ++i) {
          r1 += sh[0][jc * w.inner + i];
          r2 += sh[1][jc * w.inner + i];
        }
        write_partial(a, w.c0 + jc, r1, r2);
      }
    }
  }
  finish<KIND>(a, w);
}

// ---------------------------------------------------------- elementwise
// KIND 0 (bn_apply): out = ((x - mean) * inv) * g + b.
// KIND 1 (bn_bwd_apply): dx = A*((dy - mdb) - xhat*mdg) [+ cm] [+ cv*(x - m)]
// with A = g*inv, mdb = db*(1/N), mdg = dg*(1/N), cm = dmean*(1/N),
// cv = dvar*(2/N); 1/N and 2/N come rounded to f32 from the caller.
struct AArgs {
  const void* x;
  const void* dy;        // KIND 1: null when the output's cotangent is absent
  const float* mean;
  const float* inv;
  const float* g;        // KIND 1: null with dy
  const float* b;        // KIND 0
  const float* dg;       // KIND 1
  const float* db;
  const float* dmean;    // KIND 1: null when absent
  const float* dvar;
  void* out;
  int outer, C, inner, cg, per, rows;
  float inv_n, two_n;
};

struct Coef {
  float m, iv, g, b;          // KIND 0; KIND 1: m, iv, A, mdb
  float mdg, cm, cv;          // KIND 1
};

template <int KIND>
__device__ __forceinline__ Coef coef(const AArgs& a, int c) {
  Coef k;
  k.m = a.mean[c];
  k.iv = a.inv ? a.inv[c] : 0.f;   // bn_bwd_apply without dy needs none
  k.mdg = k.cm = k.cv = 0.f;
  if (KIND == 0) {
    k.g = a.g[c];
    k.b = a.b[c];
  } else {
    k.g = k.b = 0.f;
    if (a.dy) {
      k.g = __fmul_rn(a.g[c], k.iv);
      k.b = __fmul_rn(a.db[c], a.inv_n);
      k.mdg = __fmul_rn(a.dg[c], a.inv_n);
    }
    if (a.dmean) k.cm = __fmul_rn(a.dmean[c], a.inv_n);
    if (a.dvar) k.cv = __fmul_rn(a.dvar[c], a.two_n);
  }
  return k;
}

template <int KIND>
__device__ __forceinline__ float elem(const AArgs& a, const Coef& k, float xv,
                                      float dyv) {
  const float d = __fsub_rn(xv, k.m);
  const float xh = __fmul_rn(d, k.iv);
  if (KIND == 0) return __fadd_rn(__fmul_rn(xh, k.g), k.b);
  float r = 0.f;
  if (a.dy)
    r = __fmul_rn(k.g, __fsub_rn(__fsub_rn(dyv, k.b), __fmul_rn(xh, k.mdg)));
  if (a.dmean) r = __fadd_rn(r, k.cm);
  if (a.dvar) r = __fadd_rn(r, __fmul_rn(k.cv, d));
  return r;
}

template <typename E, int V, bool ONE, int KIND>
__global__ void __launch_bounds__(T) apply_kernel(AArgs a) {
  Walk w;
  w.init(a.outer, a.C, a.inner, a.cg, a.per, a.rows);
  const E* x = static_cast<const E*>(a.x);
  const E* dy = static_cast<const E*>(a.dy);
  E* out = static_cast<E*>(a.out);
  const bool has_dy = KIND == 1 && dy != nullptr;
  const int t = threadIdx.x;
  if constexpr (ONE) {
    const Coef k = coef<KIND>(a, w.c0);
    const int vpr = w.inner / V;
    const int items = (w.o1 - w.o0) * vpr;
#pragma unroll 4
    for (int i = t; i < items; i += T) {
      const int o = i / vpr;
      const size_t p = w.off(w.o0 + o, (i - o * vpr) * V);
      float xv[V], dv[V], ov[V];
      load<E, V>(x + p, xv);
      if (has_dy) load<E, V>(dy + p, dv);
#pragma unroll
      for (int j = 0; j < V; ++j)
        ov[j] = elem<KIND>(a, k, xv[j], has_dy ? dv[j] : 0.f);
      store<E, V>(out + p, ov);
    }
  } else {
    constexpr int K = Slots<V>::value;
    const int span = w.cn * w.inner;
    const int nsf = w.cg * w.inner / V;
    const int nsl = span / V;
    int r = 0, slot0 = t, step = T;
    if (w.rows > 1) {
      r = t / nsf;
      slot0 = t - r * nsf;
      step = nsf;
    }
    if (r >= w.rows) return;
    Coef k[K][V];
#pragma unroll
    for (int kk = 0; kk < K; ++kk)
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int s = slot0 + kk * step;
        if (s < nsl) k[kk][j] = coef<KIND>(a, w.c0 + (s * V + j) / w.inner);
      }
    for (int o = w.o0 + r; o < w.o1; o += w.rows) {
#pragma unroll
      for (int kk = 0; kk < K; ++kk) {
        const int s = slot0 + kk * step;
        if (s >= nsl) continue;
        const size_t p = w.off(o, s * V);
        float xv[V], dv[V], ov[V];
        load<E, V>(x + p, xv);
        if (has_dy) load<E, V>(dy + p, dv);
#pragma unroll
        for (int j = 0; j < V; ++j)
          ov[j] = elem<KIND>(a, k[kk][j], xv[j], has_dy ? dv[j] : 0.f);
        store<E, V>(out + p, ov);
      }
    }
  }
}

// ------------------------------------------------------------- dispatch
template <typename E, int V, int KIND, typename Args, bool REDUCE>
void launch_v(const Args& a, int one, dim3 grid, cudaStream_t st) {
  if constexpr (REDUCE) {
    if (one) reduce_kernel<E, V, true, KIND><<<grid, T, 0, st>>>(a);
    else reduce_kernel<E, V, false, KIND><<<grid, T, 0, st>>>(a);
  } else {
    if (one) apply_kernel<E, V, true, KIND><<<grid, T, 0, st>>>(a);
    else apply_kernel<E, V, false, KIND><<<grid, T, 0, st>>>(a);
  }
}

template <typename E, int KIND, typename Args, bool REDUCE>
cudaError_t launch_t(const Args& a, int vec, int one, int groups, int splits,
                     cudaStream_t st) {
  constexpr int VV = 16 / sizeof(E);
  dim3 grid(groups, splits);
  if (vec == VV) launch_v<E, VV, KIND, Args, REDUCE>(a, one, grid, st);
  else if (vec == VV / 2) launch_v<E, VV / 2, KIND, Args, REDUCE>(a, one, grid, st);
  else launch_v<E, 1, KIND, Args, REDUCE>(a, one, grid, st);
  return cudaGetLastError();
}

template <int KIND, bool REDUCE, typename Args>
cudaError_t launch(int dtype, const Args& a, int vec, int one, int groups,
                   int splits, cudaStream_t st) {
  if (dtype == 0)
    return launch_t<float, KIND, Args, REDUCE>(a, vec, one, groups, splits, st);
  if (dtype == 1)
    return launch_t<__nv_bfloat16, KIND, Args, REDUCE>(a, vec, one, groups,
                                                       splits, st);
  if (dtype == 2)
    return launch_t<__half, KIND, Args, REDUCE>(a, vec, one, groups, splits, st);
  return cudaErrorInvalidValue;
}

// the plan's walk must fit the kernels (ops/cuda/batch_norm.py:bn_plan)
bool bad_walk(int dtype, int outer, int C, int inner, int one, int vec, int cg,
              int per, int splits, int rows) {
  if (dtype < 0 || dtype > 2 || outer < 1 || C < 1 || inner < 1 || cg < 1 ||
      per < 1 || splits < 1 || splits > 65535 || rows < 1)
    return true;
  const int vv = dtype == 0 ? 4 : 8;
  if (vec != 1 && vec != vv && vec != vv / 2) return true;
  if ((splits - 1) * per >= outer || splits * per < outer) return true;
  if (one) return cg != 1 || inner % vec != 0 || rows != 1;
  if ((cg * inner) % vec != 0 || (C % cg) * inner % vec != 0) return true;
  const int slots = vec >= 4 ? 1 : 4 / vec;
  const int nsf = cg * inner / vec;
  if (cg * inner > MAX_SPAN) return true;
  if (rows == 1) return nsf > T * slots;
  return nsf * rows > T;
}

}  // namespace bn

extern "C" int mxt_bn_stats(int dtype, const void* x, const float* shift,
                            int centered, float eps, float* mean, float* var,
                            float* inv, float* ws, int* count, int outer,
                            int C, int inner, int one, int vec, int cg,
                            int per, int splits, int rows, void* stream) {
  if (bn::bad_walk(dtype, outer, C, inner, one, vec, cg, per, splits, rows) ||
      (centered && (!shift || mean)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int groups = (C + cg - 1) / cg;
  cudaError_t e = cudaMemsetAsync(count, 0, sizeof(int) * groups, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  bn::RArgs a{x, nullptr, shift, nullptr, ws, count, mean, var, inv,
              outer, C, inner, cg, per, rows, splits, centered, eps,
              static_cast<float>(static_cast<double>(outer) * inner)};
  return static_cast<int>(
      bn::launch<0, true>(dtype, a, vec, one, groups, splits, st));
}

extern "C" int mxt_bn_apply(int dtype, const void* x, const float* mean,
                            const float* inv, const float* g, const float* b,
                            void* out, int outer, int C, int inner, int one,
                            int vec, int cg, int per, int splits, int rows,
                            void* stream) {
  if (bn::bad_walk(dtype, outer, C, inner, one, vec, cg, per, splits, rows))
    return static_cast<int>(cudaErrorInvalidValue);
  bn::AArgs a{x, nullptr, mean, inv, g, b, nullptr, nullptr, nullptr, nullptr,
              out, outer, C, inner, cg, per, rows, 0.f, 0.f};
  return static_cast<int>(bn::launch<0, false>(
      dtype, a, vec, one, (C + cg - 1) / cg, splits,
      static_cast<cudaStream_t>(stream)));
}

extern "C" int mxt_bn_bwd_reduce(int dtype, const void* x, const void* dy,
                                 const float* mean, const float* inv,
                                 float* dg, float* db, float* ws, int* count,
                                 int outer, int C, int inner, int one, int vec,
                                 int cg, int per, int splits, int rows,
                                 void* stream) {
  if (bn::bad_walk(dtype, outer, C, inner, one, vec, cg, per, splits, rows))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int groups = (C + cg - 1) / cg;
  cudaError_t e = cudaMemsetAsync(count, 0, sizeof(int) * groups, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  bn::RArgs a{x, dy, mean, inv, ws, count, dg, db, nullptr,
              outer, C, inner, cg, per, rows, splits, 0, 0.f,
              static_cast<float>(static_cast<double>(outer) * inner)};
  return static_cast<int>(
      bn::launch<1, true>(dtype, a, vec, one, groups, splits, st));
}

extern "C" int mxt_bn_bwd_apply(int dtype, const void* x, const void* dy,
                                const float* mean, const float* inv,
                                const float* g, const float* dg,
                                const float* db, const float* dmean,
                                const float* dvar, void* dx, float inv_n,
                                float two_n, int outer, int C, int inner,
                                int one, int vec, int cg, int per, int splits,
                                int rows, void* stream) {
  if (bn::bad_walk(dtype, outer, C, inner, one, vec, cg, per, splits, rows) ||
      (dy && (!inv || !g || !dg || !db)))
    return static_cast<int>(cudaErrorInvalidValue);
  bn::AArgs a{x, dy, mean, inv, g, nullptr, dg, db, dmean, dvar, dx,
              outer, C, inner, cg, per, rows, inv_n, two_n};
  return static_cast<int>(bn::launch<1, false>(
      dtype, a, vec, one, (C + cg - 1) / cg, splits,
      static_cast<cudaStream_t>(stream)));
}
