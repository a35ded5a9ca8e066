// The trainer's multi-tensor optimizer update for Hopper (sm_90a), bound
// through a plain C entry: one launch updates a group of parameters.
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
// with lr, wd and the bias terms (lr_t, 1/c1, 1/c2) per tensor, rounded on
// the host as PyTorch rounds a Python scalar (to f32; a division by one runs
// as a multiplication by its f32 reciprocal). Every f32 operation is
// __f*_rn (never contracted into an FMA), and every result the eager version
// keeps in a 16-bit tensor is rounded to 16 bits (round to nearest even)
// where it does, so the kernel writes the plain version's bits.
//
// Weights: f32; bf16 or fp16 with an f32 master (the master is updated, then
// rounded to the weight); bf16 or fp16 alone (the math in 16-bit tensors, as
// the eager version runs it). The gradient has the weight's dtype. States:
// SGD's momentum in the math dtype (f32 with a master), Adam's m and v f32.
// Everything is written in place: no tensor moves.
//
// Bound: bytes. Each element's gradient is read once, its weight (or master)
// and states read and written once, and a master's 16-bit weight written:
// 28 bytes for bf16 AdamW with a master. Layout: a table of one record per
// tensor (addresses, size, first chunk) and one of per-tensor f32
// hyperparameters, both in one device buffer that the host fills with one
// copy a step. The grid is one block per chunk of elements across the
// group's tensors; a block finds its tensor by a binary search over the
// records' first chunks, and its threads walk the chunk with coalesced
// element accesses.
#include <stdint.h>
#include <type_traits>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace mt {

constexpr int THREADS = 256;

struct Rec {                        // ops/cuda/multi_tensor.py _REC
  long long w, g, master, s1, s2, n, chunk0;
};
struct Hyp {                        // ops/cuda/multi_tensor.py _HYP
  float lr, wd, a, b;               // Adam: a = lr_t; AdamW: a = 1/c1, b = 1/c2
};
struct Args {
  const Rec* recs;
  const Hyp* hyps;
  int ntensors;
  long long chunk;                  // elements a block: ops/cuda/multi_tensor.py CHUNK
  float rescale, lo, hi;
  int clip;
  float p0, p1, p2, p3, p4;         // SGD: mu | b1, 1-b1, b2, 1-b2, eps
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

// a value the eager version holds in a tensor of dtype E: rounded to E
template <typename E> __device__ __forceinline__ float rnd(float v);
template <> __device__ __forceinline__ float rnd<float>(float v) { return v; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
template <> __device__ __forceinline__ float rnd<__half>(float v) {
  return __half2float(__float2half_rn(v));
}

// OP: the optimizer; W: the weight's (and gradient's) dtype; M: an f32
// master beside a 16-bit weight. T, the dtype the eager math runs in, is
// f32 with a master, else W.
template <int OP, typename W, bool M>
__global__ void __launch_bounds__(THREADS) update(const Args a) {
  using T = typename std::conditional<M, float, W>::type;
  const long long c = blockIdx.x;
  int lo = 0, hi = a.ntensors - 1;
  while (lo < hi) {                 // the last record whose chunk0 <= c
    const int mid = (lo + hi + 1) >> 1;
    if (a.recs[mid].chunk0 <= c) lo = mid; else hi = mid - 1;
  }
  const Rec r = a.recs[lo];
  const Hyp h = a.hyps[lo];
  const long long begin = (c - r.chunk0) * a.chunk;
  const long long end = begin + a.chunk < r.n ? begin + a.chunk : r.n;
  const long long wp = M ? r.master : r.w;
#pragma unroll 4
  for (long long i = begin + threadIdx.x; i < end; i += THREADS) {
    float g = rnd<T>(__fmul_rn(ld<W>(r.g, i), a.rescale));
    if (a.clip && !isnan(g)) g = fminf(fmaxf(g, a.lo), a.hi);
    float w = ld<T>(wp, i);
    if (OP == SGD || OP == SGD_MOM || OP == ADAM)
      g = rnd<T>(__fadd_rn(g, rnd<T>(__fmul_rn(w, h.wd))));
    if (OP == SGD) {
      w = rnd<T>(__fsub_rn(w, rnd<T>(__fmul_rn(g, h.lr))));
    } else if (OP == SGD_MOM) {
      float m = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(ld<T>(r.s1, i), a.p0)), g));
      st<T>(r.s1, i, m);
      w = rnd<T>(__fsub_rn(w, rnd<T>(__fmul_rn(m, h.lr))));
    } else {
      const float m = __fadd_rn(__fmul_rn(ld<float>(r.s1, i), a.p0),
                                rnd<T>(__fmul_rn(g, a.p1)));
      const float sq = rnd<T>(__fmul_rn(g, g));
      const float v = __fadd_rn(__fmul_rn(ld<float>(r.s2, i), a.p2),
                                rnd<T>(__fmul_rn(sq, a.p3)));
      st<float>(r.s1, i, m);
      st<float>(r.s2, i, v);
      float u;
      if (OP == ADAM) {
        u = rnd<T>(__fdiv_rn(__fmul_rn(m, h.a),
                             __fadd_rn(__fsqrt_rn(v), a.p4)));
      } else {
        const float q = __fdiv_rn(__fmul_rn(m, h.a),
                                  __fadd_rn(__fsqrt_rn(__fmul_rn(v, h.b)), a.p4));
        u = rnd<T>(__fmul_rn(__fadd_rn(q, rnd<T>(__fmul_rn(w, h.wd))), h.lr));
      }
      w = rnd<T>(__fsub_rn(w, u));
    }
    st<T>(wp, i, w);
    if (M) st<W>(r.w, i, w);
  }
}

template <int OP, typename W>
cudaError_t launch_w(int master, const Args& a, long long chunks, cudaStream_t s) {
  if (master)
    update<OP, W, true><<<static_cast<unsigned>(chunks), THREADS, 0, s>>>(a);
  else
    update<OP, W, false><<<static_cast<unsigned>(chunks), THREADS, 0, s>>>(a);
  return cudaGetLastError();
}

template <int OP>
cudaError_t launch_op(int wdtype, int master, const Args& a, long long chunks,
                      cudaStream_t s) {
  if (wdtype == 0) {
    update<OP, float, false><<<static_cast<unsigned>(chunks), THREADS, 0, s>>>(a);
    return cudaGetLastError();
  }
  if (wdtype == 1) return launch_w<OP, __nv_bfloat16>(master, a, chunks, s);
  return launch_w<OP, __half>(master, a, chunks, s);
}

}  // namespace mt

// op: 0 SGD, 1 SGD with momentum, 2 Adam, 3 AdamW; wdtype: 0 f32, 1 bf16,
// 2 fp16; master: an f32 master beside a 16-bit weight. recs and hyps point
// into device memory (ntensors records each); chunks is the grid, chunk the
// elements a block.
extern "C" int mxt_multi_tensor_update(int op, int wdtype, int master,
                                       const void* recs, const void* hyps,
                                       int ntensors, long long chunks,
                                       int chunk, float rescale, float lo,
                                       float hi,
                                       int clip, float p0, float p1, float p2,
                                       float p3, float p4, void* stream) {
  if (op < 0 || op > 3 || wdtype < 0 || wdtype > 2 ||
      (master && wdtype == 0) || ntensors < 1 || chunks < 1 ||
      chunks > 0x7fffffffLL || chunk < 1 || !recs || !hyps)
    return static_cast<int>(cudaErrorInvalidValue);
  const mt::Args a{static_cast<const mt::Rec*>(recs),
                   static_cast<const mt::Hyp*>(hyps), ntensors, chunk,
                   rescale, lo, hi, clip, p0, p1, p2, p3, p4};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case mt::SGD: return static_cast<int>(mt::launch_op<mt::SGD>(wdtype, master, a, chunks, s));
    case mt::SGD_MOM: return static_cast<int>(mt::launch_op<mt::SGD_MOM>(wdtype, master, a, chunks, s));
    case mt::ADAM: return static_cast<int>(mt::launch_op<mt::ADAM>(wdtype, master, a, chunks, s));
    default: return static_cast<int>(mt::launch_op<mt::ADAMW>(wdtype, master, a, chunks, s));
  }
}
