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
// The elementwise kernels walk x one way. A block takes a group of cg
// channels of a split of the images. Where a channel's run is long (inner
// >= 256) a group is one channel, and the block's threads walk the (image,
// vector) pairs of its runs. Otherwise a group is as many whole runs as the
// block's threads hold at once (one image's cg*inner contiguous elements, up
// to 1024 or 2048), so short runs (M = 49, 196) and channel rows (NHWC) are
// read as long contiguous spans; each thread keeps its positions' sums (or
// its positions' per-channel coefficients) in registers across the images,
// each position with its own channel, and where a span is shorter than the
// block, the threads take several images at once (rows). Accesses are 16
// bytes where every vector starts 16-byte aligned (a run of one channel, or
// a span of several: there a vector may hold the end of one channel's run
// and the start of the next, so M = 196 and 49 take 16-byte loads too),
// else 8 bytes where every one starts 8-byte aligned, else one element
// (ops/cuda/batch_norm.py:bn_plan decides).
//
// The two reductions walk a group the same way, each block a contiguous
// share of it, four loads a thread in flight, and combine their blocks in
// one launch: a thread-block cluster of up to 8 blocks adds its blocks'
// per-channel sums through distributed shared memory in rank order, and
// only where a group's cluster cannot fill the card (few channels, large
// images) do several clusters a group add theirs through a workspace, in a
// fixed order, the last to finish (an integer counter it resets to 0; no
// float atomics) writing the results (ops/cuda/batch_norm.py:bn_reduce_plan
// decides). The sums are the same from run to run, to the bit: each thread
// adds its elements in a fixed order and every combine after it has a fixed
// tree.
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
//
// One launch. The grid is channel groups (x) by `cluster` * `splits` blocks
// (y), launched as thread-block clusters of `cluster` consecutive blocks
// along y (cudaLaunchAttributeClusterDimension; at most 8, the portable
// size). Block y takes the y-th share of the group's work in order: `per`
// images (grouped walk) or `per` vectors of the flat (image, vector) list
// (one channel a group). The block of rank q owns the group's channels q,
// q + cluster, ...: each block sums its share per channel and stores each
// sum into its owner's shared memory through distributed shared memory
// (Mailbox); after one cluster barrier each owner adds the cluster's sums
// of its channels in rank order (a cluster of 1 is a plain launch whose
// block owns every channel of its group). With one split (every shape whose
// clusters fill the card) the owners write the results: no workspace, no
// counter, no atomics.
// Otherwise (few channels, large images) each owner writes its cluster's
// sums to `ws` (splits, C) and takes a ticket on its (group, rank) counter;
// the last split's owner adds the splits' sums in a fixed order, writes the
// results and puts the counter back to 0, so it needs no memset.
// Both reductions are bound by bytes (x, and dy, read once; the outputs
// are a few floats a channel), and at small images (DCGAN's M = 16-64,
// ResNet-50's 49-196) by their fixed cost: so a block takes a whole share
// of the images with four loads a thread in flight, the grid one batch of
// loads a thread up to two to four blocks an SM, narrow groups before
// clusters (ops/cuda/batch_norm.py:bn_reduce_plan), and the combine
// is a cluster barrier and a few shared-memory stores, not a second pass
// through device memory.
constexpr int MAX_CG = MAX_SPAN / 2;   // channels a group (at inner 2)
constexpr int MAX_CLUSTER = 8;         // the portable cluster size
// vectors (one channel a group) or images (a group of runs) a thread loads
// at once (ops/cuda/batch_norm.py LOADS)
constexpr int NB = 4;

// the cluster's primitives (sm_90): this block's rank, the barrier of all
// its threads in two halves (an arrive that orders nothing, or the full
// release / acquire barrier), a store into a peer's shared memory
__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return static_cast<int>(r);
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n\t"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// v into block `rank`'s shared memory at the address of `p` in ours
__device__ __forceinline__ void st_peer(float* p, int rank, float v) {
  const unsigned local = static_cast<unsigned>(__cvta_generic_to_shared(p));
  unsigned remote;
  asm("mapa.shared::cluster.u32 %0, %1, %2;"
      : "=r"(remote) : "r"(local), "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;"
               :: "r"(remote), "f"(v) : "memory");
}

struct RArgs {
  const void* x;
  const void* dy;
  const float* p0;     // KIND 0: shift (null: 0); KIND 1: mean
  const float* p1;     // KIND 1: inv
  float* ws;           // splits > 1: (splits, C) float2 sums of each cluster
  int* count;          // splits > 1: a counter a (group, rank), 0 at launch
  float* o0;           // KIND 0: mean (null: not written); KIND 1: dg
  float* o1;           // KIND 0: var;  KIND 1: db
  float* o2;           // KIND 0: inv
  int outer, C, inner, cg, per, rows, cluster, splits;
  int centered;
  float eps, nf;
};

// Where a block's per-channel sums go. Channel jc of the group is owned by
// the block of rank jc % R, which keeps the cluster's sums of it in its own
// shared memory at box[.][r * slots + jc / R], r the sender's rank. Every
// block arrives on the cluster barrier as it starts and waits on it before
// its first store into a peer (open()), so no store finds a peer that has
// not started; a full barrier after the stores makes them visible, and no
// block reads a peer's memory, so each may leave when it is done.
struct Mailbox {
  float (*box)[MAX_CG + MAX_CLUSTER];
  int R, rank, slots;
  __device__ __forceinline__ void open() const {
    if (R > 1) cluster_wait();
  }
  __device__ __forceinline__ void put(int jc, float s1, float s2) const {
    const int i = rank * slots + jc / R;
    if (R == 1) {
      box[0][i] = s1;
      box[1][i] = s2;
    } else {
      st_peer(&box[0][i], jc % R, s1);
      st_peer(&box[1][i], jc % R, s2);
    }
  }
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

// channel c's results from its sums (k0: KIND 0's shift of c)
template <int KIND>
__device__ __forceinline__ void finish_channel(const RArgs& a, int c, float k0,
                                               float s1, float s2) {
  if (KIND == 0) {
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

// One channel (runs of inner >= 256): the block's share of the flat list of
// (image, vector) pairs, NB vectors a thread at once, then a warp tree and
// the warps in order. Its sums go to the channel's owner.
template <typename E, int V, int KIND>
__device__ __forceinline__ void block_sums_one(const RArgs& a, int c0,
                                               const Mailbox& mb) {
  const E* x = static_cast<const E*>(a.x);
  const E* dy = static_cast<const E*>(a.dy);
  const int t = threadIdx.x;
  float k0, k1;
  chan_consts<KIND>(a, c0, k0, k1);
  const unsigned vpr = a.inner / V;                 // vectors a run
  const long long total = static_cast<long long>(a.outer) * vpr;
  const long long i0 = static_cast<long long>(blockIdx.y) * a.per;
  const unsigned n = static_cast<unsigned>(
      max(0LL, min(total, i0 + a.per) - i0));
  auto off = [&](unsigned j) {
    const unsigned i = static_cast<unsigned>(i0) + j;
    const unsigned o = i / vpr;
    return (static_cast<size_t>(o) * a.C + c0) * a.inner + (i - o * vpr) * V;
  };
  float s1 = 0.f, s2 = 0.f;
  unsigned j = t;
  for (; j + (NB - 1) * T < n; j += NB * T) {
    float xv[NB][V], dv[NB][V];
#pragma unroll
    for (int u = 0; u < NB; ++u) {
      const size_t p = off(j + u * T);
      load<E, V>(x + p, xv[u]);
      if (KIND == 1) load<E, V>(dy + p, dv[u]);
    }
#pragma unroll
    for (int u = 0; u < NB; ++u)
#pragma unroll
      for (int q = 0; q < V; ++q)
        accumulate<KIND>(xv[u][q], KIND == 1 ? dv[u][q] : 0.f, k0, k1, s1, s2);
  }
  for (; j < n; j += T) {
    const size_t p = off(j);
    float xv[V], dv[V];
    load<E, V>(x + p, xv);
    if (KIND == 1) load<E, V>(dy + p, dv);
#pragma unroll
    for (int q = 0; q < V; ++q)
      accumulate<KIND>(xv[q], KIND == 1 ? dv[q] : 0.f, k0, k1, s1, s2);
  }
  __shared__ float red[2][WARPS];
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  if ((t & 31) == 0) {
    red[0][t >> 5] = s1;
    red[1][t >> 5] = s2;
  }
  __syncthreads();
  mb.open();
  if (t == 0) {
    float r1 = 0.f, r2 = 0.f;
#pragma unroll
    for (int i = 0; i < WARPS; ++i) {
      r1 += red[0][i];
      r2 += red[1][i];
    }
    mb.put(0, r1, r2);
  }
}

// A group of cn whole runs: each image's span of cn * inner contiguous
// elements, a thread's K slots of V positions fixed across the images, each
// position with its own channel, and `rows` images at once where the span
// has fewer vectors than the block has threads; NB images a thread at
// once.
// Each (row, position) sum goes to shared memory, then each channel's rows
// * inner sums are added by L lanes (each a strided run in order) and a
// shuffle tree over them. Its sums go to each channel's owner.
template <typename E, int V, int KIND>
__device__ __forceinline__ void block_sums_group(const RArgs& a, int c0,
                                                 int cn, const Mailbox& mb) {
  constexpr int K = Slots<V>::value;
  __shared__ float sh[2][MAX_SPAN];
  const E* x = static_cast<const E*>(a.x);
  const E* dy = static_cast<const E*>(a.dy);
  const int t = threadIdx.x;
  const int full = a.cg * a.inner;                  // a full group's span
  const int nsf = full / V;
  const int nsl = cn * a.inner / V;
  int r = 0, slot0 = t, step = T;
  if (a.rows > 1) {
    r = t / nsf;
    slot0 = t - r * nsf;
    step = nsf;                                     // one slot: the next is past the span
  }
  const bool active = r < a.rows;
  const long long b0 = static_cast<long long>(blockIdx.y) * a.per;
  const int o0 = static_cast<int>(min(static_cast<long long>(a.outer), b0));
  const int o1 = static_cast<int>(
      min(static_cast<long long>(a.outer), b0 + a.per));
  float s1[K][V], s2[K][V], k0[K][V], k1[K][V];
  bool ok[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = slot0 + k * step;
    ok[k] = active && s < nsl;
#pragma unroll
    for (int q = 0; q < V; ++q) {
      s1[k][q] = s2[k][q] = k0[k][q] = k1[k][q] = 0.f;
      if (ok[k])
        chan_consts<KIND>(a, c0 + (s * V + q) / a.inner, k0[k][q], k1[k][q]);
    }
  }
  auto off = [&](int o, int k) {
    return (static_cast<size_t>(o) * a.C + c0) * a.inner +
           (slot0 + k * step) * V;
  };
  if (active) {
    int o = o0 + r;
    for (; o + (NB - 1) * a.rows < o1; o += NB * a.rows) {
      float xv[NB][K][V], dv[NB][K][V];
#pragma unroll
      for (int u = 0; u < NB; ++u)
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (!ok[k]) continue;
          const size_t p = off(o + u * a.rows, k);
          load<E, V>(x + p, xv[u][k]);
          if (KIND == 1) load<E, V>(dy + p, dv[u][k]);
        }
#pragma unroll
      for (int u = 0; u < NB; ++u)
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (!ok[k]) continue;
#pragma unroll
          for (int q = 0; q < V; ++q)
            accumulate<KIND>(xv[u][k][q], KIND == 1 ? dv[u][k][q] : 0.f,
                             k0[k][q], k1[k][q], s1[k][q], s2[k][q]);
        }
    }
    for (; o < o1; o += a.rows) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (!ok[k]) continue;
        const size_t p = off(o, k);
        float xv[V], dv[V];
        load<E, V>(x + p, xv);
        if (KIND == 1) load<E, V>(dy + p, dv);
#pragma unroll
        for (int q = 0; q < V; ++q)
          accumulate<KIND>(xv[q], KIND == 1 ? dv[q] : 0.f, k0[k][q],
                           k1[k][q], s1[k][q], s2[k][q]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (!ok[k]) continue;
#pragma unroll
    for (int q = 0; q < V; ++q) {
      const int e = r * full + (slot0 + k * step) * V + q;
      sh[0][e] = s1[k][q];
      sh[1][e] = s2[k][q];
    }
  }
  __syncthreads();
  mb.open();
  // L lanes a channel (the largest power of two with cn * L <= T), every
  // thread through the same passes so each shuffle has the whole warp;
  // above 32 lanes a channel's warps add their sums in order
  __shared__ float wred[2][WARPS];
  int L = T;
  while (L > 1 && cn * L > T) L >>= 1;
  const int n_e = a.rows * a.inner;                 // sums a channel
  const int lane = t & (L - 1);
  for (int base = 0; base < cn; base += T / L) {
    const int jc = base + t / L;
    float r1 = 0.f, r2 = 0.f;
    if (jc < cn) {
      for (int m = lane; m < n_e; m += L) {
        const int rr = m / a.inner;
        const int e = rr * full + jc * a.inner + (m - rr * a.inner);
        r1 += sh[0][e];
        r2 += sh[1][e];
      }
    }
    for (int o = min(L, 32) >> 1; o > 0; o >>= 1) {
      r1 += __shfl_xor_sync(0xffffffffu, r1, o);
      r2 += __shfl_xor_sync(0xffffffffu, r2, o);
    }
    if (L <= 32) {
      if (jc < cn && lane == 0) mb.put(jc, r1, r2);
      continue;
    }
    if ((t & 31) == 0) {
      wred[0][t >> 5] = r1;
      wred[1][t >> 5] = r2;
    }
    __syncthreads();
    if (jc < cn && lane == 0) {
      float q1 = 0.f, q2 = 0.f;
      for (int w = 0; w < L / 32; ++w) {
        q1 += wred[0][(t >> 5) + w];
        q2 += wred[1][(t >> 5) + w];
      }
      mb.put(jc, q1, q2);
    }
    __syncthreads();
  }
}

// At least four blocks an SM for a group of runs (64 registers a thread)
// and six for one channel a group (40), so bn_reduce_plan's grids stay
// resident in one wave: given the room, ptxas takes 57-64 registers for
// the one-channel walk, whose clusters of 8 then no longer fit one wave
// (16 % slower at ResNet-50's C = 64).
template <typename E, int V, bool ONE, int KIND>
__global__ void __launch_bounds__(T, ONE ? 6 : 4) reduce_kernel(RArgs a) {
  __shared__ float box[2][MAX_CG + MAX_CLUSTER];
  const int t = threadIdx.x;
  const int R = a.cluster;
  if (R > 1) cluster_arrive_relaxed();              // this block has started
  const int rank = R > 1 ? cluster_rank() : 0;      // blockIdx.y % R
  const int split = blockIdx.y / R;
  const int c0 = blockIdx.x * a.cg;
  const int cn = min(a.cg, a.C - c0);
  const Mailbox mb{box, R, rank, (a.cg + R - 1) / R};
  // the shift of a thread's first owned channel, loaded early
  const int j0 = t, jc0 = rank + R * j0;
  float k0 = KIND == 0 && a.p0 && jc0 < cn ? a.p0[c0 + jc0] : 0.f;
  if constexpr (ONE) block_sums_one<E, V, KIND>(a, c0, mb);
  else block_sums_group<E, V, KIND>(a, c0, cn, mb);

  // the cluster's sums of each owned channel, added in rank order
  if (R > 1) cluster_sync();
  else __syncthreads();
  for (int j = j0; rank + R * j < cn; j += T) {
    const int jc = rank + R * j;
    if (KIND == 0 && a.p0 && j != j0) k0 = a.p0[c0 + jc];
    float s1 = box[0][j], s2 = box[1][j];
#pragma unroll
    for (int q = 1; q < MAX_CLUSTER; ++q) {
      if (q < R) {
        s1 += box[0][q * mb.slots + j];
        s2 += box[1][q * mb.slots + j];
      }
    }
    if (a.splits == 1)
      finish_channel<KIND>(a, c0 + jc, k0, s1, s2);
    else
      reinterpret_cast<float2*>(a.ws)[static_cast<size_t>(split) * a.C + c0 +
                                      jc] = make_float2(s1, s2);
  }
  if (a.splits == 1) return;

  // second level: the last split's owner adds the splits' sums in a fixed
  // order (a lane each split mod 32, then a fixed tree) and resets its
  // counter for the next launch
  __shared__ int last;
  __threadfence();
  __syncthreads();
  int* cnt = a.count + static_cast<size_t>(blockIdx.x) * R + rank;
  if (t == 0) last = atomicAdd(cnt, 1) == a.splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int lane = t & 31, warp = t >> 5;
  for (int jc = rank + R * warp; jc < cn; jc += R * WARPS) {
    const int c = c0 + jc;
    float s1 = 0.f, s2 = 0.f;
    for (int s = lane; s < a.splits; s += 32) {
      const float2 p = __ldcg(reinterpret_cast<const float2*>(a.ws) +
                              static_cast<size_t>(s) * a.C + c);
      s1 += p.x;
      s2 += p.y;
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0)
      finish_channel<KIND>(a, c, KIND == 0 && a.p0 ? a.p0[c] : 0.f, s1, s2);
  }
  if (t == 0) *cnt = 0;
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
template <typename E, int V, int KIND>
void launch_apply_v(const AArgs& a, int one, dim3 grid, cudaStream_t st) {
  if (one) apply_kernel<E, V, true, KIND><<<grid, T, 0, st>>>(a);
  else apply_kernel<E, V, false, KIND><<<grid, T, 0, st>>>(a);
}

template <typename E, int V, int KIND>
cudaError_t launch_reduce_v(const RArgs& a, int one, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.C + a.cg - 1) / a.cg, a.cluster * a.splits, 1);
  cfg.blockDim = dim3(T, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = a.cluster;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.cluster > 1 ? 1 : 0;             // a plain launch for 1
  const cudaError_t e =
      one ? cudaLaunchKernelEx(&cfg, reduce_kernel<E, V, true, KIND>, a)
          : cudaLaunchKernelEx(&cfg, reduce_kernel<E, V, false, KIND>, a);
  const cudaError_t last = cudaGetLastError();   // cleared either way
  return e != cudaSuccess ? e : last;
}

// the kernel of `dtype` at vector width `vec`: a reduction (Args RArgs) or
// an elementwise pass (AArgs, on `grid`)
template <typename E, int KIND, typename Args>
cudaError_t launch_t(const Args& a, int vec, int one, dim3 grid,
                     cudaStream_t st) {
  constexpr int VV = 16 / sizeof(E);
  if constexpr (std::is_same<Args, RArgs>::value) {
    if (vec == VV) return launch_reduce_v<E, VV, KIND>(a, one, st);
    if (vec == VV / 2) return launch_reduce_v<E, VV / 2, KIND>(a, one, st);
    return launch_reduce_v<E, 1, KIND>(a, one, st);
  } else {
    if (vec == VV) launch_apply_v<E, VV, KIND>(a, one, grid, st);
    else if (vec == VV / 2) launch_apply_v<E, VV / 2, KIND>(a, one, grid, st);
    else launch_apply_v<E, 1, KIND>(a, one, grid, st);
    return cudaGetLastError();
  }
}

template <int KIND, typename Args>
cudaError_t launch(int dtype, const Args& a, int vec, int one, dim3 grid,
                   cudaStream_t st) {
  if (dtype == 0) return launch_t<float, KIND>(a, vec, one, grid, st);
  if (dtype == 1) return launch_t<__nv_bfloat16, KIND>(a, vec, one, grid, st);
  if (dtype == 2) return launch_t<__half, KIND>(a, vec, one, grid, st);
  return cudaErrorInvalidValue;
}

// the plan's walk must fit the elementwise kernels
// (ops/cuda/batch_norm.py:bn_plan)
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

// the reduction plan must fit the reduction kernel
// (ops/cuda/batch_norm.py:bn_reduce_plan): a cluster of 1-8 blocks whose
// cluster * splits blocks cover the group's images (or vectors)
bool bad_reduce(int dtype, int outer, int C, int inner, int one, int vec,
                int cg, int per, int rows, int cluster, int splits) {
  if (dtype < 0 || dtype > 2 || outer < 1 || C < 1 || inner < 1 || cg < 1 ||
      per < 1 || rows < 1 || cluster < 1 || cluster > MAX_CLUSTER ||
      splits < 1 || splits > 65535 / cluster ||
      static_cast<long long>(outer) * inner >= (1LL << 31))
    return true;
  const int vv = dtype == 0 ? 4 : 8;
  if (vec != 1 && vec != vv && vec != vv / 2) return true;
  const long long blocks = static_cast<long long>(cluster) * splits;
  if (one)
    return cg != 1 || rows != 1 || inner % vec != 0 ||
           blocks * per < static_cast<long long>(outer) * (inner / vec);
  if (cg > MAX_CG || cg * inner > MAX_SPAN || (cg * inner) % vec != 0 ||
      (C % cg) * inner % vec != 0 || per % rows != 0 || blocks * per < outer)
    return true;
  const int slots = vec >= 4 ? 1 : 4 / vec;
  const int nsf = cg * inner / vec;
  if (rows == 1) return nsf > T * slots;
  return nsf * rows > T;
}

}  // namespace bn

extern "C" int mxt_bn_stats(int dtype, const void* x, const float* shift,
                            int centered, float eps, float* mean, float* var,
                            float* inv, float* ws, int* count, int outer,
                            int C, int inner, int one, int vec, int cg,
                            int per, int rows, int cluster, int splits,
                            void* stream) {
  if (bn::bad_reduce(dtype, outer, C, inner, one, vec, cg, per, rows, cluster,
                     splits) ||
      (centered && (!shift || mean)) || (splits > 1 && (!ws || !count)))
    return static_cast<int>(cudaErrorInvalidValue);
  bn::RArgs a{x, nullptr, shift, nullptr, ws, count, mean, var, inv,
              outer, C, inner, cg, per, rows, cluster, splits, centered, eps,
              static_cast<float>(static_cast<double>(outer) * inner)};
  return static_cast<int>(bn::launch<0>(dtype, a, vec, one, dim3(),
                                        static_cast<cudaStream_t>(stream)));
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
  return static_cast<int>(bn::launch<0>(
      dtype, a, vec, one, dim3((C + cg - 1) / cg, splits),
      static_cast<cudaStream_t>(stream)));
}

extern "C" int mxt_bn_bwd_reduce(int dtype, const void* x, const void* dy,
                                 const float* mean, const float* inv,
                                 float* dg, float* db, float* ws, int* count,
                                 int outer, int C, int inner, int one, int vec,
                                 int cg, int per, int rows, int cluster,
                                 int splits, void* stream) {
  if (bn::bad_reduce(dtype, outer, C, inner, one, vec, cg, per, rows, cluster,
                     splits) ||
      (splits > 1 && (!ws || !count)))
    return static_cast<int>(cudaErrorInvalidValue);
  bn::RArgs a{x, dy, mean, inv, ws, count, dg, db, nullptr,
              outer, C, inner, cg, per, rows, cluster, splits, 0, 0.f,
              static_cast<float>(static_cast<double>(outer) * inner)};
  return static_cast<int>(bn::launch<1>(dtype, a, vec, one, dim3(),
                                        static_cast<cudaStream_t>(stream)));
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
  return static_cast<int>(bn::launch<1>(
      dtype, a, vec, one, dim3((C + cg - 1) / cg, splits),
      static_cast<cudaStream_t>(stream)));
}
