// The trainer's multi-tensor optimizer update for Hopper (sm_90a), bound
// through a plain C entry: one launch updates every parameter of a step
// that shares a layout (operation, weight dtype, f32 master or none).
//
// Counterpart of mxnet_tpu/gluon/trainer.py:833 _fused_update, one compiled
// program applying SGD / Adam / AdamW (mxnet_tpu/optimizer/optimizer.py) to a
// group of up to MXNET_OPTIMIZER_AGGREGATION_SIZE parameters. The JAX package
// leaves this math to XLA, so no Pallas kernel is replaced. Per element, in
// the order of the eager PyTorch version (optimizer/optimizer.py: the
// gradient's rescale and clip in Optimizer._plain_update, then SGD._step,
// Adam._step or AdamW._step):
//   g = grad * rescale, clamped to [lo, hi] when clipping
//   SGD:       g += wd*w; m = mu*m + g (with momentum); w -= lr*(m or g)
//   Adam:      g += wd*w; m = b1*m + (1-b1)*g; v = b2*v + (1-b2)*g*g;
//              w -= lr_t*m / (sqrt(v) + eps)
//   AdamW:     m, v as Adam without wd in g;
//              w -= lr*((m*(1/c1)) / (sqrt(v*(1/c2)) + eps) + wd*w)
// with lr, wd and the bias terms (lr_t, 1/c1, 1/c2) per tensor and the
// group's scalars (rescale, clip bounds, mu or b1, 1-b1, b2, 1-b2, eps)
// per tensor too, all rounded on the host as PyTorch rounds a Python scalar
// (to f32; a division by one runs as a multiplication by its f32
// reciprocal). Every f32 operation is __f*_rn (never contracted into an
// FMA), and every result the eager version keeps in a 16-bit tensor is
// rounded to 16 bits (round to nearest even) where it does, so the kernel
// writes the plain version's bits.
//
// Weights: f32; bf16 or fp16 with an f32 master (the master is updated, then
// rounded to the weight); bf16 or fp16 alone (the math in 16-bit tensors, as
// the eager version runs it). The gradient has the weight's dtype. States:
// SGD's momentum in the math dtype (f32 with a master), Adam's m and v f32.
// Everything is written in place: no tensor moves.
//
// Bound: bytes. Each element's gradient is read once, its weight (or master)
// and states read and written once, and a master's 16-bit weight written:
// 28 bytes for bf16 AdamW with a master, 20 for bf16 SGD with momentum and a
// master. What the design does about it:
// - one launch for every tensor of a layout, whatever the groups (their
//   scalars ride in the records), so a step pays one ramp and one tail;
// - a persistent grid, a few blocks an SM, each walking its share of a
//   table of chunks (ops/cuda/multi_tensor.py launch_plan): chunk c is
//   elements [i * chunk, (i + 1) * chunk) of record r, the chunk walk
//   strided by the grid, so no block searches for its tensor;
// - 16-byte loads and stores (8 16-bit or 4 f32 values; a thread takes 8
//   elements a vector and UNROLL vectors at once, their loads started
//   together) where every address of the record is 16-byte aligned (the
//   record's flag: views need not be), the elements of a chunk past its
//   last whole vector, and unaligned records, by scalar accesses.
#include <stdint.h>
#include <type_traits>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace mt {

constexpr int THREADS = 256;
constexpr int VEC = 8;              // elements a vector
constexpr int UNROLL = 2;           // vectors a thread has in flight

struct Rec {                        // ops/cuda/multi_tensor.py _REC
  long long w, g, master, s1, s2, n;
  float lr, wd, a, b;               // Adam: a = lr_t; AdamW: a = 1/c1, b = 1/c2
  float rescale, lo, hi;
  float p0, p1, p2, p3, p4;         // SGD: mu | b1, 1-b1, b2, 1-b2, eps
  int clip, aligned;
};
struct Chunk {                      // ops/cuda/multi_tensor.py _CHUNK
  int rec, index;
};
struct Args {
  const Rec* recs;
  const Chunk* chunks;
  int nchunks;
  int chunk;                        // elements a chunk, a multiple of VEC
};

enum { SGD = 0, SGD_MOM = 1, ADAM = 2, ADAMW = 3 };

template <typename E> __device__ __forceinline__ float ld(long long p, long long i);
template <> __device__ __forceinline__ float ld<float>(long long p, long long i) {
  return reinterpret_cast<const float*>(p)[i];
}
template <> __device__ __forceinline__ float ld<__nv_bfloat16>(long long p, long long i) {
  return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i]);
}
template <> __device__ __forceinline__ float ld<__half>(long long p, long long i) {
  return __half2float(reinterpret_cast<const __half*>(p)[i]);
}

template <typename E> __device__ __forceinline__ void st(long long p, long long i, float v);
template <> __device__ __forceinline__ void st<float>(long long p, long long i, float v) {
  reinterpret_cast<float*>(p)[i] = v;
}
template <> __device__ __forceinline__ void st<__nv_bfloat16>(long long p, long long i, float v) {
  reinterpret_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ void st<__half>(long long p, long long i, float v) {
  reinterpret_cast<__half*>(p)[i] = __float2half_rn(v);
}

__device__ __forceinline__ float tof(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float tof(__half x) { return __half2float(x); }
template <typename E> __device__ __forceinline__ E fromf(float v);
template <> __device__ __forceinline__ __nv_bfloat16 fromf<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half fromf<__half>(float v) {
  return __float2half_rn(v);
}

// 8 elements from a 16-byte aligned address: one 16-byte access for a
// 16-bit dtype, two for f32
template <typename E> struct Raw {
  uint4 x;
  __device__ __forceinline__ void load(long long p, long long i) {
    x = *reinterpret_cast<const uint4*>(reinterpret_cast<const E*>(p) + i);
  }
  __device__ __forceinline__ void get(float* f) const {
    const E* e = reinterpret_cast<const E*>(&x);
#pragma unroll
    for (int k = 0; k < VEC; ++k) f[k] = tof(e[k]);
  }
  __device__ __forceinline__ void put(long long p, long long i, const float* f) {
    E* e = reinterpret_cast<E*>(&x);
#pragma unroll
    for (int k = 0; k < VEC; ++k) e[k] = fromf<E>(f[k]);
    *reinterpret_cast<uint4*>(reinterpret_cast<E*>(p) + i) = x;
  }
};
template <> struct Raw<float> {
  float4 x, y;
  __device__ __forceinline__ void load(long long p, long long i) {
    const float4* s = reinterpret_cast<const float4*>(reinterpret_cast<const float*>(p) + i);
    x = s[0];
    y = s[1];
  }
  __device__ __forceinline__ void get(float* f) const {
    f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
    f[4] = y.x; f[5] = y.y; f[6] = y.z; f[7] = y.w;
  }
  __device__ __forceinline__ void put(long long p, long long i, const float* f) {
    float4* d = reinterpret_cast<float4*>(reinterpret_cast<float*>(p) + i);
    d[0] = make_float4(f[0], f[1], f[2], f[3]);
    d[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
};

// a value the eager version holds in a tensor of dtype E: rounded to E
template <typename E> __device__ __forceinline__ float rnd(float v);
template <> __device__ __forceinline__ float rnd<float>(float v) { return v; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
template <> __device__ __forceinline__ float rnd<__half>(float v) {
  return __half2float(__float2half_rn(v));
}

// One element's update, in the eager version's order: gr the gradient as
// loaded, w the weight (or master), m and v the states; T the math dtype.
template <int OP, typename T>
__device__ __forceinline__ void elem(const Rec& r, float gr, float& w,
                                     float& m, float& v) {
  float g = rnd<T>(__fmul_rn(gr, r.rescale));
  if (r.clip && !isnan(g)) g = fminf(fmaxf(g, r.lo), r.hi);
  if (OP == SGD || OP == SGD_MOM || OP == ADAM)
    g = rnd<T>(__fadd_rn(g, rnd<T>(__fmul_rn(w, r.wd))));
  if (OP == SGD) {
    w = rnd<T>(__fsub_rn(w, rnd<T>(__fmul_rn(g, r.lr))));
  } else if (OP == SGD_MOM) {
    m = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(m, r.p0)), g));
    w = rnd<T>(__fsub_rn(w, rnd<T>(__fmul_rn(m, r.lr))));
  } else {
    m = __fadd_rn(__fmul_rn(m, r.p0), rnd<T>(__fmul_rn(g, r.p1)));
    const float sq = rnd<T>(__fmul_rn(g, g));
    v = __fadd_rn(__fmul_rn(v, r.p2), rnd<T>(__fmul_rn(sq, r.p3)));
    float u;
    if (OP == ADAM) {
      u = rnd<T>(__fdiv_rn(__fmul_rn(m, r.a), __fadd_rn(__fsqrt_rn(v), r.p4)));
    } else {
      const float q = __fdiv_rn(__fmul_rn(m, r.a),
                                __fadd_rn(__fsqrt_rn(__fmul_rn(v, r.b)), r.p4));
      u = rnd<T>(__fmul_rn(__fadd_rn(q, rnd<T>(__fmul_rn(w, r.wd))), r.lr));
    }
    w = rnd<T>(__fsub_rn(w, u));
  }
}

// OP: the optimizer; W: the weight's (and gradient's) dtype; M: an f32
// master beside a 16-bit weight. T, the dtype the eager math runs in, is
// f32 with a master, else W; S1 the first state's dtype.
template <int OP, typename W, bool M>
__global__ void __launch_bounds__(THREADS) update(const Args a) {
  using T = typename std::conditional<M, float, W>::type;
  using S1 = typename std::conditional<OP == SGD_MOM, T, float>::type;
  constexpr bool HAS_M = OP != SGD, HAS_V = OP == ADAM || OP == ADAMW;
  for (int c = blockIdx.x; c < a.nchunks; c += gridDim.x) {
    const Chunk ch = a.chunks[c];
    const Rec r = a.recs[ch.rec];
    const long long begin = static_cast<long long>(ch.index) * a.chunk;
    const long long end = begin + a.chunk < r.n ? begin + a.chunk : r.n;
    const long long wp = M ? r.master : r.w;
    // whole vectors of 8 where every address is 16-byte aligned
    const long long vend = r.aligned ? begin + (end - begin) / VEC * VEC : begin;
    for (long long i0 = begin + threadIdx.x * VEC; i0 < vend;
         i0 += THREADS * VEC * UNROLL) {
      Raw<W> rg[UNROLL];
      Raw<T> rw[UNROLL];
      Raw<S1> rm[UNROLL];
      Raw<float> rv[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long i = i0 + u * THREADS * VEC;
        if (i < vend) {
          rg[u].load(r.g, i);
          rw[u].load(wp, i);
          if (HAS_M) rm[u].load(r.s1, i);
          if (HAS_V) rv[u].load(r.s2, i);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long i = i0 + u * THREADS * VEC;
        if (i >= vend) continue;
        float g[VEC], w[VEC], m[VEC], v[VEC];
        rg[u].get(g);
        rw[u].get(w);
        if (HAS_M) rm[u].get(m);
        if (HAS_V) rv[u].get(v);
#pragma unroll
        for (int k = 0; k < VEC; ++k) elem<OP, T>(r, g[k], w[k], m[k], v[k]);
        rw[u].put(wp, i, w);
        if (M) rg[u].put(r.w, i, w);   // the weight, rounded to W
        if (HAS_M) rm[u].put(r.s1, i, m);
        if (HAS_V) rv[u].put(r.s2, i, v);
      }
    }
    // the rest of the chunk (all of it for an unaligned record), scalar
    for (long long i = vend + threadIdx.x; i < end; i += THREADS) {
      float w = ld<T>(wp, i);
      float m = HAS_M ? ld<S1>(r.s1, i) : 0.f;
      float v = HAS_V ? ld<float>(r.s2, i) : 0.f;
      elem<OP, T>(r, ld<W>(r.g, i), w, m, v);
      st<T>(wp, i, w);
      if (M) st<W>(r.w, i, w);
      if (HAS_M) st<S1>(r.s1, i, m);
      if (HAS_V) st<float>(r.s2, i, v);
    }
  }
}

template <int OP, typename W>
cudaError_t launch_w(int master, const Args& a, int blocks, cudaStream_t s) {
  if (master)
    update<OP, W, true><<<blocks, THREADS, 0, s>>>(a);
  else
    update<OP, W, false><<<blocks, THREADS, 0, s>>>(a);
  return cudaGetLastError();
}

template <int OP>
cudaError_t launch_op(int wdtype, int master, const Args& a, int blocks,
                      cudaStream_t s) {
  if (wdtype == 0) {
    update<OP, float, false><<<blocks, THREADS, 0, s>>>(a);
    return cudaGetLastError();
  }
  if (wdtype == 1) return launch_w<OP, __nv_bfloat16>(master, a, blocks, s);
  return launch_w<OP, __half>(master, a, blocks, s);
}

}  // namespace mt

// op: 0 SGD, 1 SGD with momentum, 2 Adam, 3 AdamW; wdtype: 0 f32, 1 bf16,
// 2 fp16; master: an f32 master beside a 16-bit weight. recs and chunks
// point into device memory (the records, and nchunks (record, index)
// pairs); chunk is the elements of a chunk (a multiple of 8); the grid is
// per_sm blocks an SM, at most one a chunk.
extern "C" int mxt_multi_tensor_update(int op, int wdtype, int master,
                                       const void* recs, const void* chunks,
                                       int nchunks, int chunk, int per_sm,
                                       void* stream) {
  if (op < 0 || op > 3 || wdtype < 0 || wdtype > 2 ||
      (master && wdtype == 0) || nchunks < 1 || chunk < mt::VEC ||
      chunk % mt::VEC || per_sm < 1 || !recs || !chunks)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long cap = static_cast<long long>(sms) * per_sm;
  const int blocks = static_cast<int>(nchunks < cap ? nchunks : cap);
  const mt::Args a{static_cast<const mt::Rec*>(recs),
                   static_cast<const mt::Chunk*>(chunks), nchunks, chunk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case mt::SGD: return static_cast<int>(mt::launch_op<mt::SGD>(wdtype, master, a, blocks, s));
    case mt::SGD_MOM: return static_cast<int>(mt::launch_op<mt::SGD_MOM>(wdtype, master, a, blocks, s));
    case mt::ADAM: return static_cast<int>(mt::launch_op<mt::ADAM>(wdtype, master, a, blocks, s));
    default: return static_cast<int>(mt::launch_op<mt::ADAMW>(wdtype, master, a, blocks, s));
  }
}
