// Flash attention at head dims above 256 for Hopper (sm_90a), tiled on
// wgmma and TMA, bound through plain C entries: the forward and the
// backward's dq kernel at every dtype, on the "wide_wg" route (16-bit, 256
// < D <= 512), the "wide_stream" route (16-bit, D > 512) and the
// "wide_f32" route (f32, D > 256) of ops/cuda/attention.py:head_dim_route,
// and the f32 dq at every D (the f32 pair of route "tiled" too).
//
// Replaces, at every D > 256: mxnet_tpu/ops/pallas/attention.py,
// _flash_fwd_kernel (launched at :317) and _flash_bwd_dq_kernel (launched
// at :740), which take any head dim, and the latter for f32 at D <= 256;
// flash_attention_wide_dkv.cu's kernels take 16-bit dk / dv, and
// flash_attention_bwd.cu's 3xTF32 ones the f32 dk / dv. It computes:
//   out = softmax(q k^T * scale + bias) v and lse = m + log(max(l, 1e-30)),
//     the denominator over the undropped probabilities, the kept ones
//     scaled by 1 / (1 - rate);
//   dq = (ds0 * scale) k from the forward's lse and delta = rowsum(dout *
//     out), p = exp(s - lse), dp = dout v^T (dropped out as the forward),
//     ds0 = p (dp - delta), and ds0 itself into an f32 (B, H, Tq, Tk)
//     tensor when the bias is learned;
// with the causal mask top-left (col <= row), keys past Tk and rows past Tq
// masked in the kernel, the additive f32 bias through its strides and the
// dropout keep bit of philox.cuh (the same pure function of (seed, batch,
// head, row, col) as every other kernel draws).
//
// What bounds it: the products, 4 T^2 D (forward) and 6 T^2 D (dq) flops a
// (batch, head) against ~8 T D bytes, ~T/2 flops a byte, far above the
// card's ~295 at T >= 1024: the tensor cores. Both kernels are built on the
// walk of flash_attention_fwd.cu: a block owns 64 query rows of one
// (batch, head); one producer warp loads its q (and, for dq, dout) once by
// TMA and streams 32-key tiles of K and V by TMA (128-byte swizzle, zero
// fill past Tk, Tq and D) into a ring of stages on mbarriers, each K tile
// with its key-padding bias row (or, for dq, each key's term of the
// exponent) staged beside it by the warp's 32 lanes; its warpgroup hands
// its registers to the consumers (setmaxnreg 24 / 240). The head dim is
// padded to DP in {320, 384, 448, 512}, 5 to 8 panels of 64 columns.
//
// The crux is the registers. A warpgroup that owned 64 rows and all DP
// output columns would hold DP / 2 f32 a thread (256 at DP = 512; the cap
// is 240), and dq needs s and dp beside them. So the output columns are
// split:
//  (a) two consumer warpgroups share the block's 64 rows (the forward at
//      every head dim, dq up to DP = 384). Forward: warpgroup 0 computes S
//      over the first ceil(P / 2) panels of the head dim and warpgroup 1
//      over the rest; each hands its f32 partial to the other through
//      shared memory (double-buffered by tile, one named barrier a tile)
//      and adds the other's (a + b = b + a: both hold the same bits), runs
//      the same online softmax, and keeps O for its own panels (the first
//      floor(P / 2), or the rest): every warpgroup does P panels of
//      products a tile, none twice. dq: warpgroup 0 computes s = q K^T,
//      warpgroup 1 dp = dout V^T, they swap the two through shared memory,
//      each forms the same ds, and each adds ds K into its own panels of dq.
//  (b) dq at DP = 448 and 512: a block owns one of two slices of dq's
//      panels and recomputes s and dp over the full head dim with a single
//      consumer warpgroup: 5 / 3 times (a)'s products, but no exchange.
// Measured on an H100 with both designs built for both kernels at every
// padded head dim (PERF.md section 6): a forward that owned column slices
// across blocks was never faster (a tie at DP = 320, up to 24 % slower
// above), so the forward is (a) alone; dq's (b) takes 1.65 times (a)'s
// time at DP = 320 and is 9-12 % faster at 448 and 512. There (a) holds q,
// dout, the exchange and one stage of K and V in shared memory, and ptxas
// gives a block of 384 threads 168 registers a thread whatever setmaxnreg
// hands the consumers: it spills and serializes its wgmma (C7512); (b)'s
// 256 threads get 240 (DP = 448) and 234 (DP = 512) registers with no
// spill (nvcc -Xptxas -v).
//
// Each consumer warpgroup computes its scores by wgmma (q and K both
// K-major from shared memory), the online softmax in registers with ex2
// and scale * log2(e) folded into one FMA, and O += P V (dq += ds K) by
// wgmma with P (ds) packed to 16 bits as the register A operand and V (K)
// as the MN-major B, one 64-column panel a wgmma. O (dq) stays in f32
// registers over the walk and leaves once, through the block's q panels
// (swizzled) to TMA stores that clip rows past Tq and columns past D: no
// atomics, so out, lse and dq are the same bits from run to run. Causal
// blocks stop at their last row's key tile, and the masks run only on
// tiles that cross the diagonal or Tk.
//
// Shared memory (227 KB a block): 32-key tiles, so that at DP = 512 the
// forward keeps q (64 KB) and two stages of K and V (128 KB) beside the
// exchange (32 KB), and dq q and dout (128 KB) beside one stage; the number
// of stages is the most that fits (Smem below).
//
// Above D = 512 q and dout no longer fit beside a ring: wide_fwd_st and
// wide_dq_st stream the head dim (the section "head dims above 512"). A
// block owns 64 rows and one slice of 3 or 4 output panels; each key tile
// streams 64-column panels of K (and of q, V, dout) through the ring to
// compute s (and dp) over the full head dim, then the slice's V (K) panels
// for O (dq). Shared memory does not grow with D; s and dp are recomputed
// once a slice, ceil(P / 4) + 1 products of P panels for the forward's 2.
// The forward keeps q resident while its P panels fit beside four slots.
//
// f32 heads take wide_fwd_tf32 at every D > 256 and wide_dq_tf32 at every
// D (the sections "f32 heads"): the same streamed walk in 32-column f32 panels,
// each product three TF32 wgmmas (3xTF32: f32-accurate products on the
// tensor cores, whatever torch.backends.cuda.matmul.allow_tf32 says), K
// and V split into TF32 halves (V, or for dq K, transposed, as wgmma's
// TF32 B must be K-major) by three producer warps between the TMA copy and
// the consumer.
#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "hopper.cuh"
#include "philox.cuh"
#include "tma_host.cuh"

namespace {
namespace wwg {

using mxt::Half;
using mxt::NEG_BIG;

constexpr int SPLIT_COLS = 0;   // design (a)
constexpr int SPLIT_BLOCKS = 1; // design (b)
// dq's design at each padded head dim: the faster of the two on an H100
constexpr int dq_mode(int DP) {
  return DP <= 384 ? SPLIT_COLS : SPLIT_BLOCKS;
}

constexpr int WG_ROWS = 64;      // query rows of a consumer warpgroup
constexpr int KEYS = 32;         // keys a K / V tile
constexpr int ROW_BYTES = 128;   // one swizzled row: 64 16-bit values
constexpr int TILE_PANEL = KEYS * ROW_BYTES;  // one 64-column panel of a tile
constexpr int Q_PANEL_BYTES = WG_ROWS * ROW_BYTES;  // ... of 64 rows
constexpr int NFRAG = KEYS / 2;  // f32 a thread of a 64 x KEYS accumulator
constexpr int SMEM_LIMIT = 232448;  // bytes of shared memory a block may use
constexpr int BAR_X = 3;         // the named barrier of the exchange
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float NEG2 = NEG_BIG * LOG2E;  // the masked score, base-2 units

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* bias;
  const float* lse;     // dq: the forward's (B, H, Tq) f32
  const float* delta;   // dq: (B, H, Tq) f32
  const int* seed;      // (2,) int32 Philox key on the device, or null
  void* o;              // forward: out; dq kernel: dq
  float* lse_out;       // forward: (B, H, Tq) f32
  float* ds;            // dq: (B, H, Tq, Tk) f32, or null
  int B, H, Tq, Tk, D;
  long long q_sb, q_sh, q_st;
  long long k_sb, k_sh, k_st;
  long long v_sb, v_sh, v_st;
  long long do_sb, do_sh, do_st;
  long long o_sb, o_sh, o_st;
  long long b_sb, b_sh, b_sq, b_sk;
  float scale;
  int causal;
  int dropout;
  uint32_t drop_threshold;
  float drop_scale;
};

// TMA descriptors, 4-d (d, t, h, b): q, k, v, dout (loads), out or dq
// (store)
struct Maps {
  CUtensorMap q, k, v, dout, out;
};

// The panels each consumer warpgroup works on, P = DP / 64 panels.
template <int NP, int MODE>
struct Split {
  static constexpr int P = NP;
  // (a): warpgroup 0 takes the scores over panels [0, SA) and the output
  // panels [0, OA), warpgroup 1 the rest of each
  static constexpr int SA = (P + 1) / 2;
  static constexpr int OA = P / 2;
  // (b): the output in NSLICE slices of at most 4 panels, one a block
  static constexpr int NSLICE = MODE == SPLIT_COLS ? 1 : (P + 3) / 4;
  __host__ __device__ static constexpr int slice(int s) {
    return s * P / NSLICE;
  }
  static_assert(NSLICE <= 2, "at most two slices");
};

constexpr int min_i(int a, int b) { return a < b ? a : b; }

// Shared memory of the forward, in bytes from a 1024-byte aligned base: q
// (P panels of 64 rows), the ring of K and V tiles (P panels each), the
// exchange (2 tiles x 2 warpgroups x 128 threads x NFRAG f32), the staged
// bias rows, mbarriers.
template <int DP>
struct FwdSmem {
  static constexpr int P = DP / 64;
  static constexpr int Q_PANEL = WG_ROWS * ROW_BYTES;
  static constexpr int Q_BYTES = P * Q_PANEL;
  static constexpr int K_BYTES = P * TILE_PANEL;
  static constexpr int V_BYTES = P * TILE_PANEL;
  static constexpr int X_BYTES = 2 * 2 * 128 * NFRAG * 4;
  static constexpr int PER_STAGE = K_BYTES + V_BYTES + KEYS * 4 + 3 * 8;
  static constexpr int FIXED = Q_BYTES + X_BYTES + 8 + 1024;
  static constexpr int STAGES = min_i(4, (SMEM_LIMIT - FIXED) / PER_STAGE);
  static constexpr int K = Q_BYTES;
  static constexpr int V = K + STAGES * K_BYTES;
  static constexpr int X = V + STAGES * V_BYTES;
  static constexpr int BIAS = X + X_BYTES;
  static constexpr int BAR = BIAS + STAGES * KEYS * 4;
  static constexpr int BYTES = BAR + (1 + 3 * STAGES) * 8;
  static constexpr int ALLOC = BYTES + 1024;  // room to align the base
  static_assert(STAGES >= 1 && ALLOC <= SMEM_LIMIT, "shared memory");
};

// Shared memory of the dq kernel: q and dout of the block's 64 rows (P
// panels each), the ring of K and V tiles (P panels each), the exchange
// (design (a): 2 tiles x {s, dp} x 128 threads x NFRAG f32), the ring's
// key terms, the mbarriers.
template <int DP, int MODE>
struct DqSmem {
  static constexpr int P = DP / 64;
  static constexpr int NC = MODE == SPLIT_COLS ? 2 : 1;  // consumer WGs
  static constexpr int Q_PANEL = WG_ROWS * ROW_BYTES;
  static constexpr int Q_BYTES = P * Q_PANEL;
  static constexpr int KV_BYTES = P * TILE_PANEL;
  static constexpr int X_BYTES = MODE == SPLIT_COLS ? 2 * 2 * 128 * NFRAG * 4
                                                    : 0;
  static constexpr int PER_STAGE = 2 * KV_BYTES + KEYS * 4 + 2 * 8;
  static constexpr int FIXED = 2 * Q_BYTES + X_BYTES + 8 + 1024;
  static constexpr int STAGES = min_i(4, (SMEM_LIMIT - FIXED) / PER_STAGE);
  static constexpr int Q = 0;
  static constexpr int O = Q_BYTES;
  static constexpr int K = 2 * Q_BYTES;
  static constexpr int V = K + STAGES * KV_BYTES;
  static constexpr int X = V + STAGES * KV_BYTES;
  static constexpr int KTERM = X + X_BYTES;
  static constexpr int BAR = KTERM + STAGES * KEYS * 4;
  static constexpr int BYTES = BAR + (1 + 2 * STAGES) * 8;
  static constexpr int ALLOC = BYTES + 1024;
  static_assert(STAGES >= 1 && ALLOC <= SMEM_LIMIT, "shared memory");
};

// What a consumer thread knows about its rows: the two query rows ra and
// rb = ra + 8 of its accumulator fragments (element i: row i & 2 ? rb : ra,
// key k0 + 8 (i / 4) + 2 t4 + (i & 1)), whether its lane holds the odd row
// of each Philox row pair.
struct Rows {
  int r0, ra, rb, t4, warp, g, b, h;
  bool odd;
};

__device__ __forceinline__ Rows rows_of(int r0) {
  Rows w;
  const int lane = threadIdx.x & 31;
  w.r0 = r0;
  w.warp = (threadIdx.x >> 5) & 3;
  w.g = lane >> 2;
  w.t4 = lane & 3;
  w.ra = r0 + w.warp * 16 + w.g;
  w.rb = w.ra + 8;
  w.b = blockIdx.z;
  w.h = blockIdx.y;
  w.odd = (w.g & 1) != 0;
  return w;
}

// acc (NFRAG f32) = / += A (64 rows) x B^T over panels [P0, P1) of two
// K-major operands: A's panels Q_PANEL bytes apart from a_base, B's (a
// KEYS-row tile) TILE_PANEL apart from b_base. Not committed.
template <typename T, int P0, int P1>
__device__ __forceinline__ void scores(float* acc, uint32_t a_base,
                                       int a_panel, uint32_t b_base) {
#pragma unroll
  for (int p = P0; p < P1; ++p)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hop::wgmma_ss<T, KEYS>(
          acc, hop::desc_kmajor_sw128(a_base + p * a_panel + kk * 32),
          hop::desc_kmajor_sw128(b_base + p * TILE_PANEL + kk * 32),
          (p > P0 || kk > 0) ? 1 : 0);
}

// acc[p] (32 f32 each) += A (registers: 16-bit fragments of KEYS keys) x
// the tile's panels [P0, P1) as the MN-major B, the first of them at
// b_base. Not committed.
template <typename T, int P0, int P1>
__device__ __forceinline__ void accumulate(float (*acc)[32],
                                           const uint32_t (*af)[4],
                                           uint32_t b_base) {
#pragma unroll
  for (int p = P0; p < P1; ++p)
#pragma unroll
    for (int kk = 0; kk < KEYS / 16; ++kk)
      hop::wgmma_rs<T, 64, 1>(
          acc[p - P0], af[kk],
          hop::desc_mnmajor_sw128(b_base + (p - P0) * TILE_PANEL +
                                      kk * 16 * ROW_BYTES,
                                  TILE_PANEL),
          1);
}

// Two 8-key chunks of an accumulator packed to 16 bits: the register A
// fragment of one k16 step
template <typename T>
__device__ __forceinline__ void pack_a(uint32_t (*af)[4], const float* x) {
#pragma unroll
  for (int kk = 0; kk < KEYS / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      af[kk][r] = Half<T>::pack(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

// The exchange of design (a): this thread's NFRAG values into its slot of
// `mine`, and, after the two warpgroups meet, the matching values of the
// other warpgroup's slot `theirs` into `out` (ADD: added to it, mine +
// theirs, so both warpgroups hold the same bits).
__device__ __forceinline__ void put(float4* mine, const float* x) {
  const int t = threadIdx.x & 127;
#pragma unroll
  for (int j = 0; j < NFRAG / 4; ++j)
    mine[j * 128 + t] =
        make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);
}
template <bool ADD>
__device__ __forceinline__ void get(const float4* theirs, float* out) {
  const int t = threadIdx.x & 127;
#pragma unroll
  for (int j = 0; j < NFRAG / 4; ++j) {
    const float4 y = theirs[j * 128 + t];
    out[4 * j] = ADD ? out[4 * j] + y.x : y.x;
    out[4 * j + 1] = ADD ? out[4 * j + 1] + y.y : y.y;
    out[4 * j + 2] = ADD ? out[4 * j + 2] + y.z : y.z;
    out[4 * j + 3] = ADD ? out[4 * j + 3] + y.w : y.w;
  }
}

__device__ __forceinline__ void release(uint64_t* empty) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) hop::mbar_arrive(empty);
}

// The online softmax of one tile of S (KEYS keys at k0): scale, bias (the
// staged row `sbias` or the full bias at bp) and masks (only when the tile
// crosses the diagonal or Tk) in base-2 units, the running row max m and
// sum l, and the probabilities (dropped out after l took them) left in sc.
// Returns each row's rescale of the output, 2^(m_old - m_new).
__device__ __forceinline__ float2 softmax_tile(
    float* sc, float* m, float* l, const Args& a, const Rows& w, int k0,
    const float* sbias, const float* bp, bool full_bias, uint2 key,
    float scale2) {
  if (sbias != nullptr) {
    const float* br = sbias + 2 * w.t4;
#pragma unroll
    for (int j = 0; j < KEYS / 8; ++j) {
      const float2 bb = *reinterpret_cast<const float2*>(br + 8 * j);
      sc[4 * j] = fmaf(sc[4 * j], scale2, bb.x);
      sc[4 * j + 1] = fmaf(sc[4 * j + 1], scale2, bb.y);
      sc[4 * j + 2] = fmaf(sc[4 * j + 2], scale2, bb.x);
      sc[4 * j + 3] = fmaf(sc[4 * j + 3], scale2, bb.y);
    }
  } else if (full_bias) {
#pragma unroll
    for (int i = 0; i < NFRAG; ++i) {
      const int r = (i & 2) ? w.rb : w.ra;
      const int col = k0 + (i >> 2) * 8 + 2 * w.t4 + (i & 1);
      const float bv = r < a.Tq && col < a.Tk
                           ? bp[r * a.b_sq + col * a.b_sk] * LOG2E : 0.f;
      sc[i] = fmaf(sc[i], scale2, bv);
    }
  } else {
#pragma unroll
    for (int i = 0; i < NFRAG; ++i) sc[i] *= scale2;
  }
  if ((a.causal && k0 + KEYS - 1 > w.r0) || k0 + KEYS > a.Tk) {
#pragma unroll
    for (int i = 0; i < NFRAG; ++i) {
      const int r = (i & 2) ? w.rb : w.ra;
      const int col = k0 + (i >> 2) * 8 + 2 * w.t4 + (i & 1);
      if (a.causal && col > r) sc[i] = NEG2;
      if (col >= a.Tk) sc[i] = -INFINITY;  // no such key
    }
  }
  float alpha[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float v = fmaxf(sc[2 * i], sc[2 * i + 1]);
#pragma unroll
    for (int j = 1; j < KEYS / 8; ++j)
      v = fmaxf(v, fmaxf(sc[4 * j + 2 * i], sc[4 * j + 2 * i + 1]));
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
    const float m_new = fmaxf(m[i], v);
    alpha[i] = hop::ex2(m[i] - m_new);
    m[i] = m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < KEYS / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[4 * j + e] = hop::ex2(sc[4 * j + e] - m[e >> 1]);
      sum[e >> 1] += sc[4 * j + e];
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = fmaf(l[i], alpha[i], sum[i]);
  if (a.dropout) {
    const uint32_t th = a.drop_threshold;
    const float ds = a.drop_scale;
#pragma unroll
    for (int j = 0; j < KEYS / 8; ++j) {
      uint32_t wd[4];
      mxt::dropout_row_pair(wd, key, w.b, w.h, w.ra, w.rb,
                            k0 + 8 * j + 2 * w.t4, w.odd);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[4 * j + e] = wd[e] >= th ? sc[4 * j + e] * ds : 0.f;
    }
  }
  return make_float2(alpha[0], alpha[1]);
}

// The output panels [O0, O1) of a warpgroup's 64 rows (acc, 32 f32 a
// panel, times mul[0] for row ra and mul[1] for rb) packed to 16 bits into
// panels [O0, O1) of the q region at `region` (panels `panel` bytes apart,
// the warpgroup's rows first), then stored by TMA by one thread as the
// output's panels [O0 + shift, O1 + shift). The caller has made sure
// nobody reads those panels any more.
template <typename T, int O0, int O1>
__device__ __forceinline__ void store_rows(const float (*acc)[32],
                                           const float* mul,
                                           unsigned char* region, int panel,
                                           const CUtensorMap* map,
                                           const Rows& w, int Tq, int wg,
                                           int shift = 0) {
  const int row = w.warp * 16 + w.g;
#pragma unroll
  for (int p = O0; p < O1; ++p) {
    unsigned char* pn = region + p * panel;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int chunk = (j ^ (row & 7)) * 16 + w.t4 * 4;
      const float* x = acc[p - O0] + 4 * j;
      *reinterpret_cast<uint32_t*>(pn + row * ROW_BYTES + chunk) =
          Half<T>::pack(x[0] * mul[0], x[1] * mul[0]);
      *reinterpret_cast<uint32_t*>(pn + (row + 8) * ROW_BYTES + chunk) =
          Half<T>::pack(x[2] * mul[1], x[3] * mul[1]);
    }
  }
  hop::fence_async_smem();
  hop::named_sync(1 + wg, 128);
  if ((threadIdx.x & 127) == 0 && w.r0 < Tq) {
#pragma unroll
    for (int p = O0; p < O1; ++p)
      hop::tma_store_4d(map, region + p * panel, (p + shift) * 64, w.r0,
                        w.h, w.b);
    hop::tma_store_commit_and_wait();
  }
}

// ------------------------------------------------------------ the forward
// One consumer warpgroup of the forward (design (a)): scores over panels
// [S0, S1) of the head dim, exchanged with the other warpgroup's, and the
// output over panels [O0, O1) of the block's 64 rows from r0.
template <typename T, int DP, int S0, int S1, int O0, int O1>
__device__ __forceinline__ void fwd_consumer(const Maps& maps, const Args& a,
                                             unsigned char* sm, int wg,
                                             int r0, bool write_lse,
                                             int n_tiles) {
  using L = FwdSmem<DP>;
  constexpr int STAGES = L::STAGES;
  constexpr int NO = O1 - O0;
  const Rows w = rows_of(r0);
  const uint2 key = a.dropout ? mxt::dropout_key(a.seed) : make_uint2(0, 0);
  const bool row_bias = a.bias != nullptr && a.b_sq == 0;
  const bool full_bias = a.bias != nullptr && a.b_sq != 0;
  const float* bp = a.bias ? a.bias + w.b * a.b_sb + w.h * a.b_sh : nullptr;
  const float scale2 = a.scale * LOG2E;
  const uint32_t base = hop::smem_u32(sm);
  uint64_t* full_q = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* full_k = full_q + 1;
  uint64_t* full_v = full_k + STAGES;
  uint64_t* empty = full_v + STAGES;
  float* s_bias = reinterpret_cast<float*>(sm + L::BIAS);
  float4* xch = reinterpret_cast<float4*>(sm + L::X);

  float o[NO][32];
#pragma unroll
  for (int p = 0; p < NO; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[p][i] = 0.f;
  float sc[NFRAG];
  float m[2] = {NEG2, NEG2};  // running row max, base-2 units
  float l[2] = {0.f, 0.f};    // per-thread partial row sums
  uint32_t pf[KEYS / 16][4];  // P, the A operand of P V

  hop::mbar_wait_or_trap(full_q, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % STAGES, k0 = it * KEYS;
    const uint32_t ph = (it / STAGES) & 1;
    const uint32_t k_tile = base + L::K + st * L::K_BYTES;
    const uint32_t v_tile = base + L::V + st * L::V_BYTES;
    hop::mbar_wait_or_trap(full_k + st, ph);
    hop::wgmma_fence();
    scores<T, S0, S1>(sc, base, L::Q_PANEL, k_tile);
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(sc, NFRAG);
    // hand this half of S over, take the other's: S = mine + theirs
    float4* slot = xch + (it & 1) * 2 * 4 * 128;
    put(slot + wg * 4 * 128, sc);
    hop::named_sync(BAR_X, 256);
    get<true>(slot + (wg ^ 1) * 4 * 128, sc);
    const float2 alpha = softmax_tile(
        sc, m, l, a, w, k0, row_bias ? s_bias + st * KEYS : nullptr, bp,
        full_bias, key, scale2);
#pragma unroll
    for (int p = 0; p < NO; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[p][i] *= (i & 2) ? alpha.y : alpha.x;
    pack_a<T>(pf, sc);
    hop::mbar_wait_or_trap(full_v + st, ph);
    hop::wgmma_fence();
    accumulate<T, O0, O1>(o, pf, v_tile + O0 * TILE_PANEL);
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
#pragma unroll
    for (int p = 0; p < NO; ++p) hop::fence_regs(o[p], 32);
    release(empty + st);
  }

  // ------------------------------------------------------------- epilogue
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const float denom = fmaxf(l[i], 1e-30f);
    inv[i] = 1.f / denom;
    const int r = i ? w.rb : w.ra;
    if (write_lse && w.t4 == 0 && r < a.Tq)
      a.lse_out[((long long)w.b * a.H + w.h) * a.Tq + r] =
          m[i] * LN2 + logf(denom);
  }
  // every read of q is done: the last exchange came after both
  // warpgroups' last S
  hop::named_sync(1 + wg, 128);
  store_rows<T, O0, O1>(o, inv, sm, L::Q_PANEL, &maps.out, w, a.Tq, wg);
}

template <typename T, int DP>
__global__ void __launch_bounds__(3 * 128, 1)
    wide_fwd_wg(const __grid_constant__ Maps maps, const Args a) {
  using L = FwdSmem<DP>;
  using S = Split<DP / 64, SPLIT_COLS>;
  constexpr int STAGES = L::STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = hop::smem_u32(smem_raw);
  unsigned char* sm = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  uint64_t* full_q = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* full_k = full_q + 1;       // [STAGES]: K tile and bias row
  uint64_t* full_v = full_k + STAGES;  // [STAGES]: V tile
  uint64_t* empty = full_v + STAGES;   // [STAGES]: the 8 consumer warps
  float* s_bias = reinterpret_cast<float*>(sm + L::BIAS);

  const int q0 = blockIdx.x * WG_ROWS;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31;
  int k_end = a.Tk;
  if (a.causal) k_end = min(k_end, q0 + WG_ROWS);  // later keys add nothing
  const int n_tiles = (k_end + KEYS - 1) / KEYS;

  if (tid == 0) {
    hop::mbar_init(full_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      hop::mbar_init(full_k + s, 32);
      hop::mbar_init(full_v + s, 1);
      hop::mbar_init(empty + s, 8);
    }
    hop::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 256) {
    // ------------------------------------------------------------ producer
    // one warp of the producer warpgroup works; all four give registers
    // to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid >= 288) return;
    const bool row_bias = a.bias != nullptr && a.b_sq == 0;
    const float* bp = row_bias ? a.bias + b * a.b_sb + h * a.b_sh : nullptr;
    if (lane == 0) {
      hop::mbar_expect(full_q, L::Q_BYTES);
      for (int p = 0; p < S::P; ++p)
        hop::tma_load_4d(sm + p * L::Q_PANEL, &maps.q, full_q, p * 64, q0, h,
                         b);
    }
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % STAGES, k0 = it * KEYS;
      if (it >= STAGES)
        hop::mbar_wait_or_trap(empty + st, ((it / STAGES) + 1) & 1);
      if (row_bias) {
        const int col = k0 + lane;
        s_bias[st * KEYS + lane] = col < a.Tk ? bp[col * a.b_sk] * LOG2E
                                              : 0.f;
      }
      if (lane != 0) {
        hop::mbar_arrive(full_k + st);
      } else {
        unsigned char* kt = sm + L::K + st * L::K_BYTES;
        unsigned char* vt = sm + L::V + st * L::V_BYTES;
        hop::mbar_expect(full_k + st, L::K_BYTES);
        for (int p = 0; p < S::P; ++p)
          hop::tma_load_4d(kt + p * TILE_PANEL, &maps.k, full_k + st, p * 64,
                           k0, h, b);
        hop::mbar_expect(full_v + st, L::V_BYTES);
        for (int p = 0; p < S::P; ++p)
          hop::tma_load_4d(vt + p * TILE_PANEL, &maps.v, full_v + st, p * 64,
                           k0, h, b);
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = tid >> 7;
  if (wg == 0)
    fwd_consumer<T, DP, 0, S::SA, 0, S::OA>(maps, a, sm, wg, q0, true,
                                            n_tiles);
  else
    fwd_consumer<T, DP, S::SA, S::P, S::OA, S::P>(maps, a, sm, wg, q0, false,
                                                  n_tiles);
}

// ------------------------------------------------------------ the dq kernel
// What a dq warpgroup computes of each tile's scores: design (a) splits s
// and dp between its two warpgroups, (b) computes both.
enum Role { ROLE_S = 1, ROLE_DP = 2, ROLE_BOTH = 3 };

// One tile of the streamed dq kernel, dq_consumer's arithmetic as a
// function: p = 2^(s scale log2(e) + key term + bias - lse) into sc (0
// above the diagonal and past Tk; each variant one straight run), ds0 = p
// (dp_d - delta) into dp with the dropout mask drawn as the forward draws
// it (the rows are queries), and ds0 into the rows of dsp (the learned
// bias's gradient, f32) when dsp is not null. kt: the tile's staged key
// terms. (dq_consumer keeps the code inline: called there, the same code
// made its DP = 512 kernel a third slower on an H100, 0.85 against 0.64 ms
// at (4, 8, 1024, 512).)
__device__ __forceinline__ void ds_tile(float* sc, float* dp, const Args& a,
                                        const Rows& w, int k0,
                                        const float* kt, const float* lse2,
                                        const float* dl, uint2 key,
                                        float scale2, bool full_bias,
                                        const float* bp, float* dsp) {
  if (!full_bias) {
#pragma unroll
    for (int j = 0; j < KEYS / 8; ++j) {
      const float2 k2 =
          *reinterpret_cast<const float2*>(kt + 8 * j + 2 * w.t4);
      sc[4 * j] = fmaf(sc[4 * j], scale2, k2.x) - lse2[0];
      sc[4 * j + 1] = fmaf(sc[4 * j + 1], scale2, k2.y) - lse2[0];
      sc[4 * j + 2] = fmaf(sc[4 * j + 2], scale2, k2.x) - lse2[1];
      sc[4 * j + 3] = fmaf(sc[4 * j + 3], scale2, k2.y) - lse2[1];
    }
  } else {
#pragma unroll
    for (int i = 0; i < NFRAG; ++i) {
      const int r = (i & 2) ? w.rb : w.ra;
      const int cl = 8 * (i >> 2) + 2 * w.t4 + (i & 1), col = k0 + cl;
      const float bv = r < a.Tq && col < a.Tk
                           ? bp[r * a.b_sq + col * a.b_sk] * LOG2E : 0.f;
      sc[i] = fmaf(sc[i], scale2, kt[cl] + bv) - lse2[(i >> 1) & 1];
    }
  }
  if (a.causal && k0 + KEYS - 1 > w.r0) {  // the tile crosses the diagonal
#pragma unroll
    for (int i = 0; i < NFRAG; ++i) {
      const int r = (i & 2) ? w.rb : w.ra;
      if (k0 + 8 * (i >> 2) + 2 * w.t4 + (i & 1) > r) sc[i] = -INFINITY;
    }
  }
#pragma unroll
  for (int i = 0; i < NFRAG; ++i) sc[i] = hop::ex2(sc[i]);

  if (a.dropout) {
    const uint32_t th = a.drop_threshold;
    const float dsc = a.drop_scale;
#pragma unroll
    for (int j = 0; j < KEYS / 8; ++j) {
      uint32_t wd[4];
      mxt::dropout_row_pair(wd, key, w.b, w.h, w.ra, w.rb,
                            k0 + 8 * j + 2 * w.t4, w.odd);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        const float dpd = wd[e] >= th ? dp[i] * dsc : 0.f;
        dp[i] = sc[i] * (dpd - dl[e >> 1]);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < NFRAG; ++i)
      dp[i] = sc[i] * (dp[i] - dl[(i >> 1) & 1]);
  }
  if (dsp != nullptr) {  // the learned bias's gradient, f32
#pragma unroll
    for (int i = 0; i < NFRAG; ++i) {
      const int r = (i & 2) ? w.rb : w.ra;
      const int col = k0 + 8 * (i >> 2) + 2 * w.t4 + (i & 1);
      if (r < a.Tq && col < a.Tk)
        dsp[r * static_cast<long long>(a.Tk) + col] = dp[i];
    }
  }
}

// One consumer warpgroup of the dq kernel: s and / or dp (ROLE), dq over
// panels [O0, O1); writes ds when write_ds and the caller asked for it.
template <typename T, int DP, int MODE, int ROLE, int O0, int O1>
__device__ __forceinline__ void dq_consumer(const Maps& maps, const Args& a,
                                            unsigned char* sm, int wg,
                                            int r0, bool write_ds,
                                            int n_tiles) {
  using L = DqSmem<DP, MODE>;
  constexpr int STAGES = L::STAGES;
  constexpr int P = L::P;
  constexpr int NO = O1 - O0;
  const Rows w = rows_of(r0);
  const long long bh = static_cast<long long>(w.b) * a.H + w.h;
  const uint2 key = a.dropout ? mxt::dropout_key(a.seed) : make_uint2(0, 0);
  const float scale2 = a.scale * LOG2E;
  const bool full_bias = a.bias != nullptr && a.b_sq != 0;
  const float* bp = a.bias ? a.bias + w.b * a.b_sb + w.h * a.b_sh : nullptr;
  // the rows' lse in base-2 units (+inf past Tq: p = 0 there) and delta
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = i ? w.rb : w.ra;
    lse2[i] = r < a.Tq ? a.lse[bh * a.Tq + r] * LOG2E : INFINITY;
    dl[i] = r < a.Tq ? a.delta[bh * a.Tq + r] : 0.f;
  }
  const uint32_t base = hop::smem_u32(sm);
  uint64_t* full_q = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* full = full_q + 1;
  uint64_t* empty = full + STAGES;
  const float* s_kterm = reinterpret_cast<const float*>(sm + L::KTERM);
  float4* xch = reinterpret_cast<float4*>(sm + L::X);
  float* dsp = write_ds && a.ds != nullptr
                   ? a.ds + bh * a.Tq * static_cast<long long>(a.Tk)
                   : nullptr;

  float dq[NO][32];
#pragma unroll
  for (int p = 0; p < NO; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[p][i] = 0.f;
  float sc[NFRAG], dp[NFRAG];  // s, dp: rows ra, rb; KEYS / 4 keys
  uint32_t pf[KEYS / 16][4];   // ds, the A operand of dq += ds K

  hop::mbar_wait_or_trap(full_q, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % STAGES, k0 = it * KEYS;
    const uint32_t k_tile = base + L::K + st * L::KV_BYTES;
    const uint32_t v_tile = base + L::V + st * L::KV_BYTES;
    const float* kt = s_kterm + st * KEYS;
    hop::mbar_wait_or_trap(full + st, (it / STAGES) & 1);
    hop::wgmma_fence();
    if constexpr ((ROLE & ROLE_S) != 0) {
      scores<T, 0, P>(sc, base + L::Q, L::Q_PANEL, k_tile);
      hop::wgmma_commit();
    }
    if constexpr ((ROLE & ROLE_DP) != 0) {
      scores<T, 0, P>(dp, base + L::O, L::Q_PANEL, v_tile);
      hop::wgmma_commit();
    }
    hop::wgmma_wait<0>();
    if constexpr ((ROLE & ROLE_S) != 0) hop::fence_regs(sc, NFRAG);
    if constexpr ((ROLE & ROLE_DP) != 0) hop::fence_regs(dp, NFRAG);
    if constexpr (ROLE != ROLE_BOTH) {
      // hand over what this warpgroup computed, take the other's
      float4* slot = xch + (it & 1) * 2 * 4 * 128;
      put(slot + (ROLE == ROLE_S ? 0 : 4 * 128), ROLE == ROLE_S ? sc : dp);
      hop::named_sync(BAR_X, 256);
      get<false>(slot + (ROLE == ROLE_S ? 4 * 128 : 0),
                 ROLE == ROLE_S ? dp : sc);
    }

    // p = 2^(s scale log2(e) + key term + bias - lse); each variant one
    // straight run
    if (!full_bias) {
#pragma unroll
      for (int j = 0; j < KEYS / 8; ++j) {
        const float2 k2 =
            *reinterpret_cast<const float2*>(kt + 8 * j + 2 * w.t4);
        sc[4 * j] = fmaf(sc[4 * j], scale2, k2.x) - lse2[0];
        sc[4 * j + 1] = fmaf(sc[4 * j + 1], scale2, k2.y) - lse2[0];
        sc[4 * j + 2] = fmaf(sc[4 * j + 2], scale2, k2.x) - lse2[1];
        sc[4 * j + 3] = fmaf(sc[4 * j + 3], scale2, k2.y) - lse2[1];
      }
    } else {
#pragma unroll
      for (int i = 0; i < NFRAG; ++i) {
        const int r = (i & 2) ? w.rb : w.ra;
        const int cl = 8 * (i >> 2) + 2 * w.t4 + (i & 1), col = k0 + cl;
        const float bv = r < a.Tq && col < a.Tk
                             ? bp[r * a.b_sq + col * a.b_sk] * LOG2E : 0.f;
        sc[i] = fmaf(sc[i], scale2, kt[cl] + bv) - lse2[(i >> 1) & 1];
      }
    }
    if (a.causal && k0 + KEYS - 1 > r0) {  // the tile crosses the diagonal
#pragma unroll
      for (int i = 0; i < NFRAG; ++i) {
        const int r = (i & 2) ? w.rb : w.ra;
        if (k0 + 8 * (i >> 2) + 2 * w.t4 + (i & 1) > r) sc[i] = -INFINITY;
      }
    }
#pragma unroll
    for (int i = 0; i < NFRAG; ++i) sc[i] = hop::ex2(sc[i]);

    // ds0 = p (dp_d - delta) into dp, the dropout mask drawn as the
    // forward draws it (the rows are queries)
    if (a.dropout) {
      const uint32_t th = a.drop_threshold;
      const float dsc = a.drop_scale;
#pragma unroll
      for (int j = 0; j < KEYS / 8; ++j) {
        uint32_t wd[4];
        mxt::dropout_row_pair(wd, key, w.b, w.h, w.ra, w.rb,
                              k0 + 8 * j + 2 * w.t4, w.odd);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          const float dpd = wd[e] >= th ? dp[i] * dsc : 0.f;
          dp[i] = sc[i] * (dpd - dl[e >> 1]);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < NFRAG; ++i)
        dp[i] = sc[i] * (dp[i] - dl[(i >> 1) & 1]);
    }
    if (dsp != nullptr) {  // the learned bias's gradient, f32
#pragma unroll
      for (int i = 0; i < NFRAG; ++i) {
        const int r = (i & 2) ? w.rb : w.ra;
        const int col = k0 + 8 * (i >> 2) + 2 * w.t4 + (i & 1);
        if (r < a.Tq && col < a.Tk)
          dsp[r * static_cast<long long>(a.Tk) + col] = dp[i];
      }
    }

    // dq += ds K: ds packed to 16 bits as the register A operand, K's
    // panels [O0, O1) as the MN-major B
    pack_a<T>(pf, dp);
    hop::wgmma_fence();
    accumulate<T, O0, O1>(dq, pf, k_tile + O0 * TILE_PANEL);
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
#pragma unroll
    for (int p = 0; p < NO; ++p) hop::fence_regs(dq[p], 32);
    release(empty + st);  // K, V, key terms used
  }

  // ------------------------------------------------------------- epilogue
  // dq * scale through the q panels [O0, O1) (every read of q is done:
  // design (a)'s last exchange came after warpgroup 0's last s)
  hop::named_sync(1 + wg, 128);
  const float mul[2] = {a.scale, a.scale};
  store_rows<T, O0, O1>(dq, mul, sm + L::Q, L::Q_PANEL, &maps.out, w, a.Tq,
                        wg);
}

template <typename T, int DP, int MODE>
__global__ void __launch_bounds__((DqSmem<DP, MODE>::NC + 1) * 128, 1)
    wide_dq_wg(const __grid_constant__ Maps maps, const Args a) {
  using L = DqSmem<DP, MODE>;
  using S = Split<DP / 64, MODE>;
  constexpr int STAGES = L::STAGES;
  constexpr int NC = L::NC;
  constexpr int P = S::P;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = hop::smem_u32(smem_raw);
  unsigned char* sm = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  uint64_t* full_q = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* full = full_q + 1;      // [STAGES]: K, V tile and key terms
  uint64_t* empty = full + STAGES;  // [STAGES]: the consumer warps done
  float* s_kterm = reinterpret_cast<float*>(sm + L::KTERM);

  const int sl = blockIdx.x % S::NSLICE;
  const int q0 = (blockIdx.x / S::NSLICE) * WG_ROWS;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31;
  int k_end = a.Tk;
  if (a.causal) k_end = min(k_end, q0 + WG_ROWS);
  const int n_tiles = (k_end + KEYS - 1) / KEYS;

  if (tid == 0) {
    hop::mbar_init(full_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      hop::mbar_init(full + s, 32);
      hop::mbar_init(empty + s, 4 * NC);
    }
    hop::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= NC * 128) {
    // ------------------------------------------------------------ producer
    // with two consumer warpgroups the producer's hands them its registers;
    // with one, 256 threads have 255 each and nothing is moved
    if constexpr (NC > 1)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid >= NC * 128 + 32) return;
    const bool row_bias = a.bias != nullptr && a.b_sq == 0;
    const float* bp = row_bias ? a.bias + b * a.b_sb + h * a.b_sh : nullptr;
    if (lane == 0) {
      hop::mbar_expect(full_q, 2 * L::Q_BYTES);
      for (int p = 0; p < P; ++p) {
        hop::tma_load_4d(sm + L::Q + p * L::Q_PANEL, &maps.q, full_q, p * 64,
                         q0, h, b);
        hop::tma_load_4d(sm + L::O + p * L::Q_PANEL, &maps.dout, full_q,
                         p * 64, q0, h, b);
      }
    }
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % STAGES, k0 = it * KEYS;
      if (it >= STAGES)
        hop::mbar_wait_or_trap(empty + st, ((it / STAGES) + 1) & 1);
      // each key's term of the exponent in base-2 units: the key-padding
      // bias (bias broadcast over Tq), -inf past Tk (p = 0 there)
      const int col = k0 + lane;
      s_kterm[st * KEYS + lane] = col >= a.Tk ? -INFINITY
                                  : bp != nullptr ? bp[col * a.b_sk] * LOG2E
                                                  : 0.f;
      if (lane != 0) {
        hop::mbar_arrive(full + st);
      } else {
        unsigned char* kt = sm + L::K + st * L::KV_BYTES;
        unsigned char* vt = sm + L::V + st * L::KV_BYTES;
        hop::mbar_expect(full + st, 2 * L::KV_BYTES);
        for (int p = 0; p < P; ++p) {
          hop::tma_load_4d(kt + p * TILE_PANEL, &maps.k, full + st, p * 64,
                           k0, h, b);
          hop::tma_load_4d(vt + p * TILE_PANEL, &maps.v, full + st, p * 64,
                           k0, h, b);
        }
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  if constexpr (NC > 1)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = tid >> 7;
  if constexpr (MODE == SPLIT_COLS) {
    if (wg == 0)
      dq_consumer<T, DP, MODE, ROLE_S, 0, S::OA>(maps, a, sm, wg, q0, true,
                                                 n_tiles);
    else
      dq_consumer<T, DP, MODE, ROLE_DP, S::OA, P>(maps, a, sm, wg, q0,
                                                  false, n_tiles);
  } else {
    if (sl == 0)
      dq_consumer<T, DP, MODE, ROLE_BOTH, 0, S::slice(1)>(maps, a, sm, wg,
                                                          q0, true, n_tiles);
    else
      dq_consumer<T, DP, MODE, ROLE_BOTH, S::slice(1), P>(
          maps, a, sm, wg, q0, false, n_tiles);
  }
}

// ------------------------------------ head dims above 512: the streamed walk
// q and dout of a block's 64 rows take 128 D bytes each (64 KB at D = 512,
// 128 KB at 1024): the head dim no longer fits shared memory beside a ring.
// So a block owns 64 query rows of one (batch, head) and one slice of 3 or
// 4 of the P output panels (the P panels split evenly into ceil(P / 4)
// slices, st_slices), with one consumer warpgroup and one producer warp
// (256 threads: up to 255 registers a thread, where 384 get 168). Each
// 32-key tile is a run of ring steps: ceil(P / G) score steps, each
// holding G 64-column panels of K (and of q, unless the forward keeps q
// resident) or, for dq, of K, V, q and dout, which the consumer adds into
// s (and dp) by wgmma, then one value step holding the slice's panels of V
// (dq: K), for O += P V (dq += ds K). A slot is one size whatever D is;
// only the number of steps a tile grows with it. Every wgmma group is
// straight-line code of a fixed size: a group in a loop of a run-time trip
// count, or under a run-time condition, is serialized by ptxas (C7520), so
// the panels of the last score step past P read a zeroed region instead.
// Few large steps: a step's handshake between the producer and the
// consumer costs more than its products (on an H100, one panel a step ran
// the forward at (4, 8, 1024, 1024) in 2.2 ms, 1.86 with its loads cut out
// and 2.04 with its products cut out; 4 panels a step in 1.15). Every
// slice computes s (and dp) over all P panels in the same order, so every
// slice holds the same bits of the row max, the denominator and p: slice 0
// alone writes lse (ds). The forward keeps q resident where it fits
// (fwd_q_resident): streaming q with K took 11-17 % longer on an H100.
//
// head-dim panels a score step: the forward's, 4 (a 16 KB slot, or 48 KB
// with q), and dq's, 3 (72 KB: 3 slots), 1-11 % faster on an H100 than 2
// (48 KB: 4 slots) and 20-28 % faster than 4 (2 slots)
constexpr int ST_G_FWD = 4;
constexpr int ST_G_DQ = 3;
constexpr int ST_MAX_SLOTS = 8;
constexpr int ST_THREADS = 256;  // a consumer warpgroup, a producer's
// score steps' wgmma groups in flight after a commit (2 ran the forward at
// (4, 8, 1024, 1024) in 1.36 against 1.15 ms)
constexpr int ST_PIPE = 1;

// The slices of P panels, each 3 or 4 panels for P > 8
__host__ __device__ inline int st_slices(int P) { return (P + 3) / 4; }

// The streamed kernels' shared memory, the same on the host and the
// device, in bytes from a 1024-byte aligned base: a zeroed panel of 64
// rows (the operands of the score steps' panels past P), q (a resident
// forward's P panels), the ring's SLOTS slots, a staged bias row (dq: key
// terms) a slot, indexed by tile, then the mbarriers: full and empty a
// slot, and the resident q's.
struct StreamSmem {
  int P, G, NS, SLOT, SLOTS, Q, RING, BIAS, BAR, ALLOC;
  __host__ __device__ StreamSmem(int D, bool dq, bool q_res) {
    P = (D + 63) / 64;
    G = dq ? ST_G_DQ : ST_G_FWD;
    NS = (P + G - 1) / G;
    Q = Q_PANEL_BYTES;  // after the zeroed panel at 0
    RING = Q + (q_res ? P * Q_PANEL_BYTES : 0);
    SLOT = dq ? G * 2 * (TILE_PANEL + Q_PANEL_BYTES)
              : G * (TILE_PANEL + (q_res ? 0 : Q_PANEL_BYTES));
    SLOTS = (SMEM_LIMIT - 1024 - 8 - RING) / (SLOT + KEYS * 4 + 2 * 8);
    if (SLOTS > ST_MAX_SLOTS) SLOTS = ST_MAX_SLOTS;
    BIAS = RING + SLOTS * SLOT;
    BAR = BIAS + SLOTS * KEYS * 4;
    ALLOC = BAR + (2 * SLOTS + 1) * 8 + 1024;
  }
};

// Whether the forward keeps its q panels resident (loaded once) rather than
// streaming them with every tile's K panels: where they fit beside a ring
// of 4 slots (D <= 1152), twice the steps the consumer holds at once.
__host__ __device__ inline bool fwd_q_resident(int P) {
  return StreamSmem(P * 64, false, true).SLOTS >= 2 * (ST_PIPE + 1);
}

__device__ __forceinline__ void st_advance(int& st, uint32_t& ph,
                                           int slots) {
  if (++st == slots) {
    st = 0;
    ph ^= 1;
  }
}

// The zeroed panel, written once by the consumer warpgroup before its
// first product
__device__ __forceinline__ void st_zero(unsigned char* sm) {
  float4* z = reinterpret_cast<float4*>(sm);
  for (int i = threadIdx.x & 127; i < Q_PANEL_BYTES / 16; i += 128)
    z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  hop::fence_async_smem();
  hop::named_sync(1, 128);
}

// acc (NFRAG f32) = (first) or += A (64 rows, one K-major panel at a) x
// B^T (a KEYS-row tile's K-major panel at b). Not committed.
template <typename T>
__device__ __forceinline__ void panel_scores(float* acc, uint32_t a,
                                             uint32_t b, bool first) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    hop::wgmma_ss<T, KEYS>(acc, hop::desc_kmajor_sw128(a + kk * 32),
                           hop::desc_kmajor_sw128(b + kk * 32),
                           first && kk == 0 ? 0 : 1);
}

// The NS score steps of a tile from the ring slot st on: issue(j, slot,
// first) adds step j's products into the accumulators (first: the tile's
// first step, which overwrites them). After each commit up to ST_PIPE
// groups stay in flight, so the tensor cores have the next step queued
// while one finishes; a step's slot is released once its group is done.
// The caller fences the accumulators.
template <typename Issue>
__device__ __forceinline__ void st_scores(const Issue& issue, uint32_t ring,
                                          const StreamSmem& L,
                                          uint64_t* full, uint64_t* empty,
                                          int& st, uint32_t& ph) {
  int rel = st;  // the oldest slot not yet released
#pragma unroll
  for (int j = 0; j < ST_PIPE; ++j) {  // NS > ST_PIPE
    hop::mbar_wait_or_trap(full + st, ph);
    hop::wgmma_fence();
    issue(j, ring + st * L.SLOT, j == 0);
    hop::wgmma_commit();
    st_advance(st, ph, L.SLOTS);
  }
  for (int j = ST_PIPE; j < L.NS; ++j) {
    hop::mbar_wait_or_trap(full + st, ph);
    hop::wgmma_fence();
    issue(j, ring + st * L.SLOT, false);
    hop::wgmma_commit();
    hop::wgmma_wait<ST_PIPE>();
    release(empty + rel);
    if (++rel == L.SLOTS) rel = 0;
    st_advance(st, ph, L.SLOTS);
  }
  hop::wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < ST_PIPE; ++i) {
    release(empty + rel);
    if (++rel == L.SLOTS) rel = 0;
  }
}

// acc[p] += A (registers: af) x panel p of the value step, the slice's NO
// panels of V or K in the ring slot st.
template <typename T, int NO>
__device__ __forceinline__ void st_values(float (*acc)[32],
                                          const uint32_t (*af)[4],
                                          uint32_t ring, const StreamSmem& L,
                                          uint64_t* full, uint64_t* empty,
                                          int& st, uint32_t& ph) {
  hop::mbar_wait_or_trap(full + st, ph);
  hop::wgmma_fence();
  accumulate<T, 0, NO>(acc, af, ring + st * L.SLOT);
  hop::wgmma_commit();
  hop::wgmma_wait<0>();
#pragma unroll
  for (int p = 0; p < NO; ++p) hop::fence_regs(acc[p], 32);
  release(empty + st);
  st_advance(st, ph, L.SLOTS);
}

// The consumer of the streamed forward: the scores over all P panels, the
// online softmax, and O over the slice's NO panels from ps.
template <typename T, int NO, bool QRES>
__device__ __forceinline__ void fwd_st_consumer(const Maps& maps,
                                                const Args& a,
                                                unsigned char* sm,
                                                const StreamSmem& L, int r0,
                                                int ps, int n_tiles) {
  const Rows w = rows_of(r0);
  const uint2 key = a.dropout ? mxt::dropout_key(a.seed) : make_uint2(0, 0);
  const bool row_bias = a.bias != nullptr && a.b_sq == 0;
  const bool full_bias = a.bias != nullptr && a.b_sq != 0;
  const float* bp = a.bias ? a.bias + w.b * a.b_sb + w.h * a.b_sh : nullptr;
  const float scale2 = a.scale * LOG2E;
  const uint32_t base = hop::smem_u32(sm);
  const uint32_t ring = base + L.RING;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L.BAR);
  uint64_t* empty = full + L.SLOTS;
  const float* s_bias = reinterpret_cast<const float*>(sm + L.BIAS);

  float o[NO][32];
#pragma unroll
  for (int p = 0; p < NO; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[p][i] = 0.f;
  float sc[NFRAG];
  float m[2] = {NEG2, NEG2};  // running row max, base-2 units
  float l[2] = {0.f, 0.f};    // per-thread partial row sums
  uint32_t pf[KEYS / 16][4];  // P, the A operand of P V

  st_zero(sm);
  if constexpr (QRES) hop::mbar_wait_or_trap(empty + L.SLOTS, 0);  // q
  int st = 0;
  uint32_t ph = 0;
  for (int it = 0; it < n_tiles; ++it) {
    // S = q K^T, ST_G_FWD panels a step: K's at the slot, q's resident or
    // behind K's; a panel past P reads the zeroed one (base)
    st_scores(
        [&](int j, uint32_t slot, bool first) {
#pragma unroll
          for (int g = 0; g < ST_G_FWD; ++g) {
            const int p = j * ST_G_FWD + g;
            const bool real = p < L.P;
            const uint32_t qa =
                !real ? base
                : QRES ? base + L.Q + p * Q_PANEL_BYTES
                       : slot + ST_G_FWD * TILE_PANEL + g * Q_PANEL_BYTES;
            panel_scores<T>(sc, qa, real ? slot + g * TILE_PANEL : base,
                            first && g == 0);
          }
        },
        ring, L, full, empty, st, ph);
    hop::fence_regs(sc, NFRAG);
    const float2 alpha = softmax_tile(
        sc, m, l, a, w, it * KEYS,
        row_bias ? s_bias + (it % L.SLOTS) * KEYS : nullptr, bp, full_bias,
        key, scale2);
#pragma unroll
    for (int p = 0; p < NO; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[p][i] *= (i & 2) ? alpha.y : alpha.x;
    pack_a<T>(pf, sc);
    st_values<T, NO>(o, pf, ring, L, full, empty, st, ph);  // O += P V
  }

  // ------------------------------------------------------------- epilogue
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const float denom = fmaxf(l[i], 1e-30f);
    inv[i] = 1.f / denom;
    const int r = i ? w.rb : w.ra;
    if (ps == 0 && w.t4 == 0 && r < a.Tq)
      a.lse_out[((long long)w.b * a.H + w.h) * a.Tq + r] =
          m[i] * LN2 + logf(denom);
  }
  // every warp is past its last product: the ring's first slots take the
  // output's panels
  hop::named_sync(1, 128);
  store_rows<T, 0, NO>(o, inv, sm + L.RING, Q_PANEL_BYTES, &maps.out, w,
                       a.Tq, 0, ps);
}

template <typename T, bool QRES>
__global__ void __launch_bounds__(ST_THREADS, 1)
    wide_fwd_st(const __grid_constant__ Maps maps, const Args a) {
  const StreamSmem L(a.D, false, QRES);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = hop::smem_u32(smem_raw);
  unsigned char* sm = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L.BAR);  // [SLOTS]
  uint64_t* empty = full + L.SLOTS;  // [SLOTS]: the 4 consumer warps done
  uint64_t* full_q = empty + L.SLOTS;  // the resident q
  float* s_bias = reinterpret_cast<float*>(sm + L.BIAS);

  const int nsl = st_slices(L.P);
  const int sl = blockIdx.x % nsl;
  const int q0 = (blockIdx.x / nsl) * WG_ROWS;
  const int ps = sl * L.P / nsl, no = (sl + 1) * L.P / nsl - ps;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31;
  int k_end = a.Tk;
  if (a.causal) k_end = min(k_end, q0 + WG_ROWS);  // later keys add nothing
  const int n_tiles = (k_end + KEYS - 1) / KEYS;

  if (tid == 0) {
    hop::mbar_init(full_q, 1);
    for (int s = 0; s < L.SLOTS; ++s) {
      hop::mbar_init(full + s, 32);
      hop::mbar_init(empty + s, 4);
    }
    hop::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 128) {
    // ------------------------------------------------------------ producer
    // one warp: lane 0 issues the copies; every lane stages a tile's bias
    // row with its first step and arrives on each step's barrier
    if (tid >= 160) return;
    const bool row_bias = a.bias != nullptr && a.b_sq == 0;
    const float* bp = row_bias ? a.bias + b * a.b_sb + h * a.b_sh : nullptr;
    if (QRES && lane == 0) {
      hop::mbar_expect(full_q, L.P * Q_PANEL_BYTES);
      for (int p = 0; p < L.P; ++p)
        hop::tma_load_4d(sm + L.Q + p * Q_PANEL_BYTES, &maps.q, full_q,
                         p * 64, q0, h, b);
    }
    int st = 0, step = 0;
    uint32_t ph = 0;
    for (int it = 0; it < n_tiles; ++it) {
      const int k0 = it * KEYS;
      for (int j = 0; j <= L.NS; ++j, ++step) {
        if (step >= L.SLOTS) hop::mbar_wait_or_trap(empty + st, ph ^ 1);
        if (j == 0 && row_bias) {
          const int col = k0 + lane;
          s_bias[(it % L.SLOTS) * KEYS + lane] =
              col < a.Tk ? bp[col * a.b_sk] * LOG2E : 0.f;
        }
        if (lane != 0) {
          hop::mbar_arrive(full + st);
        } else {
          unsigned char* slot = sm + L.RING + st * L.SLOT;
          if (j < L.NS) {  // a score step: K (and q) panels [p0, p0 + n)
            const int p0 = j * ST_G_FWD, n = min(ST_G_FWD, L.P - p0);
            hop::mbar_expect(full + st,
                             n * (TILE_PANEL + (QRES ? 0 : Q_PANEL_BYTES)));
            for (int g = 0; g < n; ++g) {
              hop::tma_load_4d(slot + g * TILE_PANEL, &maps.k, full + st,
                               (p0 + g) * 64, k0, h, b);
              if (!QRES)
                hop::tma_load_4d(
                    slot + ST_G_FWD * TILE_PANEL + g * Q_PANEL_BYTES,
                    &maps.q, full + st, (p0 + g) * 64, q0, h, b);
            }
          } else {  // the value step: the slice's V panels
            hop::mbar_expect(full + st, no * TILE_PANEL);
            for (int p = 0; p < no; ++p)
              hop::tma_load_4d(slot + p * TILE_PANEL, &maps.v, full + st,
                               (ps + p) * 64, k0, h, b);
          }
        }
        st_advance(st, ph, L.SLOTS);
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumer
  if (no == 4)
    fwd_st_consumer<T, 4, QRES>(maps, a, sm, L, q0, ps, n_tiles);
  else
    fwd_st_consumer<T, 3, QRES>(maps, a, sm, L, q0, ps, n_tiles);
}

// The consumer of the streamed dq kernel: s and dp over all P panels, ds,
// and dq over the slice's NO panels from ps; slice 0 writes ds.
template <typename T, int NO>
__device__ __forceinline__ void dq_st_consumer(const Maps& maps,
                                               const Args& a,
                                               unsigned char* sm,
                                               const StreamSmem& L, int r0,
                                               int ps, int n_tiles) {
  const Rows w = rows_of(r0);
  const long long bh = static_cast<long long>(w.b) * a.H + w.h;
  const uint2 key = a.dropout ? mxt::dropout_key(a.seed) : make_uint2(0, 0);
  const float scale2 = a.scale * LOG2E;
  const bool full_bias = a.bias != nullptr && a.b_sq != 0;
  const float* bp = a.bias ? a.bias + w.b * a.b_sb + w.h * a.b_sh : nullptr;
  // the rows' lse in base-2 units (+inf past Tq: p = 0 there) and delta
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = i ? w.rb : w.ra;
    lse2[i] = r < a.Tq ? a.lse[bh * a.Tq + r] * LOG2E : INFINITY;
    dl[i] = r < a.Tq ? a.delta[bh * a.Tq + r] : 0.f;
  }
  const uint32_t ring = hop::smem_u32(sm) + L.RING;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L.BAR);
  uint64_t* empty = full + L.SLOTS;
  const float* s_kterm = reinterpret_cast<const float*>(sm + L.BIAS);
  float* dsp = ps == 0 && a.ds != nullptr
                   ? a.ds + bh * a.Tq * static_cast<long long>(a.Tk)
                   : nullptr;

  float dq[NO][32];
#pragma unroll
  for (int p = 0; p < NO; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[p][i] = 0.f;
  float sc[NFRAG], dp[NFRAG];  // s, dp: rows ra, rb; KEYS / 4 keys
  uint32_t pf[KEYS / 16][4];   // ds, the A operand of dq += ds K

  st_zero(sm);
  const uint32_t zero = hop::smem_u32(sm);
  int st = 0;
  uint32_t ph = 0;
  for (int it = 0; it < n_tiles; ++it) {
    // s = q K^T and dp = dout V^T, ST_G_DQ panels a step: K's at the slot,
    // then V's, q's, dout's; a panel past P reads the zeroed one
    st_scores(
        [&](int j, uint32_t slot, bool first) {
          constexpr int G = ST_G_DQ;
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const bool real = j * G + g < L.P;
            const uint32_t qs = slot + 2 * G * TILE_PANEL;
            panel_scores<T>(sc, real ? qs + g * Q_PANEL_BYTES : zero,
                            real ? slot + g * TILE_PANEL : zero,
                            first && g == 0);
            panel_scores<T>(dp, real ? qs + (G + g) * Q_PANEL_BYTES : zero,
                            real ? slot + (G + g) * TILE_PANEL : zero,
                            first && g == 0);
          }
        },
        ring, L, full, empty, st, ph);
    hop::fence_regs(sc, NFRAG);
    hop::fence_regs(dp, NFRAG);
    ds_tile(sc, dp, a, w, it * KEYS, s_kterm + (it % L.SLOTS) * KEYS, lse2,
            dl, key, scale2, full_bias, bp, dsp);
    pack_a<T>(pf, dp);
    st_values<T, NO>(dq, pf, ring, L, full, empty, st, ph);  // dq += ds K
  }

  // ------------------------------------------------------------- epilogue
  hop::named_sync(1, 128);
  const float mul[2] = {a.scale, a.scale};
  store_rows<T, 0, NO>(dq, mul, sm + L.RING, Q_PANEL_BYTES, &maps.out, w,
                       a.Tq, 0, ps);
}

template <typename T>
__global__ void __launch_bounds__(ST_THREADS, 1)
    wide_dq_st(const __grid_constant__ Maps maps, const Args a) {
  const StreamSmem L(a.D, true, false);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = hop::smem_u32(smem_raw);
  unsigned char* sm = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L.BAR);  // [SLOTS]
  uint64_t* empty = full + L.SLOTS;  // [SLOTS]: the 4 consumer warps done
  float* s_kterm = reinterpret_cast<float*>(sm + L.BIAS);

  const int nsl = st_slices(L.P);
  const int sl = blockIdx.x % nsl;
  const int q0 = (blockIdx.x / nsl) * WG_ROWS;
  const int ps = sl * L.P / nsl, no = (sl + 1) * L.P / nsl - ps;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31;
  int k_end = a.Tk;
  if (a.causal) k_end = min(k_end, q0 + WG_ROWS);
  const int n_tiles = (k_end + KEYS - 1) / KEYS;

  if (tid == 0) {
    for (int s = 0; s < L.SLOTS; ++s) {
      hop::mbar_init(full + s, 32);
      hop::mbar_init(empty + s, 4);
    }
    hop::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 128) {
    // ------------------------------------------------------------ producer
    if (tid >= 160) return;
    const bool row_bias = a.bias != nullptr && a.b_sq == 0;
    const float* bp = row_bias ? a.bias + b * a.b_sb + h * a.b_sh : nullptr;
    int st = 0, step = 0;
    uint32_t ph = 0;
    for (int it = 0; it < n_tiles; ++it) {
      const int k0 = it * KEYS;
      for (int j = 0; j <= L.NS; ++j, ++step) {
        if (step >= L.SLOTS) hop::mbar_wait_or_trap(empty + st, ph ^ 1);
        if (j == 0) {
          // each key's term of the exponent in base-2 units: the
          // key-padding bias (bias broadcast over Tq), -inf past Tk
          const int col = k0 + lane;
          s_kterm[(it % L.SLOTS) * KEYS + lane] =
              col >= a.Tk     ? -INFINITY
              : bp != nullptr ? bp[col * a.b_sk] * LOG2E
                              : 0.f;
        }
        if (lane != 0) {
          hop::mbar_arrive(full + st);
        } else {
          unsigned char* slot = sm + L.RING + st * L.SLOT;
          if (j < L.NS) {  // a score step: K, V, q, dout panels [p0, p0 + n)
            constexpr int G = ST_G_DQ;
            const int p0 = j * G, n = min(G, L.P - p0);
            unsigned char* qs = slot + 2 * G * TILE_PANEL;
            hop::mbar_expect(full + st, n * 2 * (TILE_PANEL + Q_PANEL_BYTES));
            for (int g = 0; g < n; ++g) {
              const int c = (p0 + g) * 64;
              hop::tma_load_4d(slot + g * TILE_PANEL, &maps.k, full + st, c,
                               k0, h, b);
              hop::tma_load_4d(slot + (G + g) * TILE_PANEL, &maps.v,
                               full + st, c, k0, h, b);
              hop::tma_load_4d(qs + g * Q_PANEL_BYTES, &maps.q, full + st, c,
                               q0, h, b);
              hop::tma_load_4d(qs + (G + g) * Q_PANEL_BYTES, &maps.dout,
                               full + st, c, q0, h, b);
            }
          } else {  // the value step: the slice's K panels
            hop::mbar_expect(full + st, no * TILE_PANEL);
            for (int p = 0; p < no; ++p)
              hop::tma_load_4d(slot + p * TILE_PANEL, &maps.k, full + st,
                               (ps + p) * 64, k0, h, b);
          }
        }
        st_advance(st, ph, L.SLOTS);
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumer
  if (no == 4)
    dq_st_consumer<T, 4>(maps, a, sm, L, q0, ps, n_tiles);
  else
    dq_st_consumer<T, 3>(maps, a, sm, L, q0, ps, n_tiles);
}

// ------------------------------------- f32 heads: the forward on 3xTF32
// f32 q, k, v at every D > 256 (route "wide_f32"): the streamed walk above
// carried to f32. A 128-byte swizzled row holds 32 f32 values, so a panel
// is 32 columns (P = ceil(D / 32)), and wgmma reads f32 data only as TF32
// (10 mantissa bits), K-major on both sides. So each operand is split
// into TF32 halves, x = hi + lo, and each product taken as hi hi' + hi lo'
// + lo hi' (3xTF32, hopper.cuh): f32 to about 2^-21 relative, where TF32
// alone (2^-11) would miss the f32 tolerance. Both products take A from
// registers, B from shared memory:
//  - S = q K^T: the consumer loads its q fragments raw from shared memory
//    (q resident, loaded once, while its P panels leave a ring of 4 slots:
//    D <= 608; else streamed with K) and splits them in registers; K's
//    panels come TF_G a ring step, split in place (hi, lo TF_LO bytes on);
//  - O += P V: P is split in registers; V's panels come TF_G a step,
//    transposed in place into V^T (a row a column of the head dim, its 32
//    keys one 128-byte row: K-major B) with lo beside it, the keys of each
//    8-key group in the order P's register fragment takes them
//    (hop::tf32_key_pos), so P is the A operand with no shuffle;
//  - three producer warps, the splitters, split K and V between the TMA
//    copy and the consumer (one more barrier a slot, ready). Splitting q
//    there too, for every key tile, bounded an earlier build of this
//    kernel: 0.194 ms at (2, 4, 512, 320) (PERF.md section 6).
// A block owns 64 rows and a slice of up to TF_NO output panels (192
// columns: 96 f32 a thread), the slices recomputing S as the 16-bit
// streamed kernels do; three m64n32k8 wgmmas a k8 step and panel. Every
// sum runs in one order: out and lse are the same bits from run to run.
constexpr int TF_G = 2;       // head-dim panels a ring step
constexpr int TF_NO = 6;      // output panels a slice, at most
constexpr int TF_LO = TF_G * TILE_PANEL;  // lo's offset in a slot
constexpr int TF_SPLIT = 96;  // splitter threads: producer warps 1-3
constexpr int BAR_SPLIT = 2;  // the splitters' named barrier

// The slices of P f32 panels: 4 to 6 panels each for P >= 9 (P / ceil(P /
// 6) >= 4), the widths wide_fwd_tf32's consumer is built for; below, one
// slice of P up to 6 and two of 3 or 4 at P = 7, 8 (the f32 dq at D <= 256)
__host__ __device__ inline int tf_slices(int P) {
  return (P + TF_NO - 1) / TF_NO;
}
// whether every slice of P panels is 4 to 6 wide
__host__ __device__ inline bool tf_dq_wide(int P) {
  return P >= 4 && P != 7;
}
static_assert(TF_NO == 6, "wide_fwd_tf32 takes slices of 4 to 6 panels");

// The f32 forward's shared memory from a 1024-byte aligned base: a zeroed
// 64-row panel (the operands of score panels past P), q's P raw panels
// (q_res), the ring's SLOTS slots (K or V^T hi at 0, lo at TF_LO, a
// streamed q's raw panels at 2 TF_LO), a staged bias row a slot, indexed
// by tile, then the mbarriers: full (copied), ready (split) and empty
// (used) a slot, and the resident q's.
struct TfSmem {
  int P, NS, SLOT, SLOTS, RING, BIAS, BAR, ALLOC;
  __host__ __device__ TfSmem(int D, bool q_res) {
    P = (D + 31) / 32;
    NS = (P + TF_G - 1) / TF_G;
    RING = Q_PANEL_BYTES + (q_res ? P * Q_PANEL_BYTES : 0);
    SLOT = 2 * TF_LO + (q_res ? 0 : TF_G * Q_PANEL_BYTES);
    SLOTS = (SMEM_LIMIT - 1024 - 8 - RING) / (SLOT + KEYS * 4 + 3 * 8);
    if (SLOTS > ST_MAX_SLOTS) SLOTS = ST_MAX_SLOTS;
    BIAS = RING + SLOTS * SLOT;
    BAR = BIAS + SLOTS * KEYS * 4;
    ALLOC = BAR + (3 * SLOTS + 1) * 8 + 1024;
  }
};

// Whether the f32 forward keeps q's raw panels resident: where they leave
// a ring of 4 slots
__host__ __device__ inline bool tf_q_resident(int P) {
  return TfSmem(P * 32, true).SLOTS >= 4;
}

// A score step's n K panels split in place, lo TF_LO bytes on, by
// splitter t of TF_SPLIT (its loads all issued before the first split)
__device__ __forceinline__ void tf_split_keys(unsigned char* slot, int n,
                                              int t) {
  constexpr int K4 = TILE_PANEL / 16;  // float4s a panel
  constexpr int PER = (TF_G * K4 + TF_SPLIT - 1) / TF_SPLIT;
  uint4* hi = reinterpret_cast<uint4*>(slot);
  uint4* lo = reinterpret_cast<uint4*>(slot + TF_LO);
  float4 x[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int i = t + u * TF_SPLIT;
    if (i < n * K4) x[u] = reinterpret_cast<const float4*>(hi)[i];
  }
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int i = t + u * TF_SPLIT;
    if (i >= n * K4) break;
    uint4 h, l;
    hop::tf32_split(x[u].x, h.x, l.x);
    hop::tf32_split(x[u].y, h.y, l.y);
    hop::tf32_split(x[u].z, h.z, l.z);
    hop::tf32_split(x[u].w, h.w, l.w);
    hi[i] = h;
    lo[i] = l;
  }
}

// A value step's n V panels (32 keys x 32 columns each, swizzled as TMA
// wrote them) transposed in place into V^T (row c: column c of the step's
// panels, key r at hop::tf32_key_pos(r), swizzled) as hi, lo TF_LO bytes
// on, by splitter t: every splitter reads its share before any writes
__device__ __forceinline__ void tf_split_values(unsigned char* slot, int n,
                                                int t) {
  constexpr int K4 = TILE_PANEL / 16;
  constexpr int PER = (TF_G * K4 + TF_SPLIT - 1) / TF_SPLIT;  // float4s
  float4 buf[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    // unit i: panel i / K4, 16-byte chunk (i >> 5) & 7, key i & 31: a warp
    // takes one chunk of the 32 keys, so that each of its stores below
    // fills one row of V^T across 32 banks
    const int i = t + u * TF_SPLIT, r = i & 31, c = (i >> 5) & 7;
    if (i < n * K4)
      buf[u] = *reinterpret_cast<const float4*>(
          slot + (i / K4) * TILE_PANEL + r * ROW_BYTES + ((c ^ (r & 7)) << 4));
  }
  hop::named_sync(BAR_SPLIT, TF_SPLIT);
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int i = t + u * TF_SPLIT, s = hop::tf32_key_pos(i & 31);
    if (i >= n * K4) break;
    const float x[4] = {buf[u].x, buf[u].y, buf[u].z, buf[u].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = (i / K4) * 32 + ((i >> 5) & 7) * 4 + e;  // V^T's row
      const int off =
          row * ROW_BYTES + (((s >> 2) ^ (row & 7)) << 4) + (s & 3) * 4;
      uint32_t h, l;
      hop::tf32_split(x[e], h, l);
      *reinterpret_cast<uint32_t*>(slot + off) = h;
      *reinterpret_cast<uint32_t*>(slot + TF_LO + off) = l;
    }
  }
}

// The output panels [0, NO) of the consumer's 64 rows (acc, NFRAG f32 a
// 32-column panel, times mul[0] for row ra and mul[1] for rb) into f32
// panels of 64 rows at `region` (swizzled), then stored by TMA by one
// thread as the output's panels [shift, shift + NO)
template <int NO>
__device__ __forceinline__ void store_rows_f32(const float (*acc)[NFRAG],
                                               const float* mul,
                                               unsigned char* region,
                                               const CUtensorMap* map,
                                               const Rows& w, int Tq,
                                               int shift) {
  const int row = w.warp * 16 + w.g;
#pragma unroll
  for (int p = 0; p < NO; ++p) {
    unsigned char* pn = region + p * Q_PANEL_BYTES;
#pragma unroll
    for (int j = 0; j < NFRAG / 4; ++j) {
      const int at = (((2 * j + (w.t4 >> 1)) ^ (row & 7)) << 4) +
                     (w.t4 & 1) * 8;
      const float* x = acc[p] + 4 * j;
      *reinterpret_cast<float2*>(pn + row * ROW_BYTES + at) =
          make_float2(x[0] * mul[0], x[1] * mul[0]);
      *reinterpret_cast<float2*>(pn + (row + 8) * ROW_BYTES + at) =
          make_float2(x[2] * mul[1], x[3] * mul[1]);
    }
  }
  hop::fence_async_smem();
  hop::named_sync(1, 128);
  if ((threadIdx.x & 127) == 0 && w.r0 < Tq) {
#pragma unroll
    for (int p = 0; p < NO; ++p)
      hop::tma_store_4d(map, region + p * Q_PANEL_BYTES, (p + shift) * 32,
                        w.r0, w.h, w.b);
    hop::tma_store_commit_and_wait();
  }
}

// The consumer of the f32 forward: S over all P panels, the online
// softmax, and O over the slice's NO panels from ps.
template <int NO, bool QRES>
__device__ __forceinline__ void fwd_tf32_consumer(const Maps& maps,
                                                  const Args& a,
                                                  unsigned char* sm,
                                                  const TfSmem& L, int r0,
                                                  int ps, int n_tiles) {
  constexpr int NV = (NO + TF_G - 1) / TF_G;  // value steps a tile
  const Rows w = rows_of(r0);
  const uint2 key = a.dropout ? mxt::dropout_key(a.seed) : make_uint2(0, 0);
  const bool row_bias = a.bias != nullptr && a.b_sq == 0;
  const bool full_bias = a.bias != nullptr && a.b_sq != 0;
  const float* bp = a.bias ? a.bias + w.b * a.b_sb + w.h * a.b_sh : nullptr;
  const float scale2 = a.scale * LOG2E;
  const uint32_t zero = hop::smem_u32(sm);
  const uint32_t ring = zero + L.RING;
  uint64_t* ready = reinterpret_cast<uint64_t*>(sm + L.BAR) + L.SLOTS;
  uint64_t* empty = ready + L.SLOTS;
  const float* s_bias = reinterpret_cast<const float*>(sm + L.BIAS);
  // this thread's rows of a 64-row q panel: row, row + 8 (same swizzle)
  const int row = w.warp * 16 + w.g;
  const int qa = row * ROW_BYTES + w.t4 * 4, qb = qa + 8 * ROW_BYTES;

  float o[NO][NFRAG];
#pragma unroll
  for (int p = 0; p < NO; ++p)
#pragma unroll
    for (int i = 0; i < NFRAG; ++i) o[p][i] = 0.f;
  float sc[NFRAG];
  float m[2] = {NEG2, NEG2};  // running row max, base-2 units
  float l[2] = {0.f, 0.f};    // per-thread partial row sums
  // P's TF32 halves, the A operand of P V: k8 step j's fragment
  uint32_t phi[KEYS / 8][4], plo[KEYS / 8][4];
  // q's TF32 halves, the A operand of q K^T: panel g's k8 step kk
  uint32_t ah[TF_G][4][4], al[TF_G][4][4];

  st_zero(sm);
  if constexpr (QRES) hop::mbar_wait_or_trap(empty + L.SLOTS, 0);  // q
  int st = 0;
  uint32_t ph = 0;
  for (int it = 0; it < n_tiles; ++it) {
    // S = q K^T in 3xTF32, TF_G panels a step: q's fragments loaded raw
    // and split here, K's halves split in the slot; a panel past P reads
    // the zeroed one. Each panel is a wgmma group of its own, in flight as
    // the next panel's fragments are loaded (1-3 % faster on an H100 than
    // a group a step behind one wait)
    int prev = 0;  // the slot of the step before, in use until its last
                   // group is done
    for (int j = 0; j < L.NS; ++j) {
      hop::mbar_wait_or_trap(ready + st, ph);
      const uint32_t slot = ring + st * L.SLOT;
#pragma unroll
      for (int g = 0; g < TF_G; ++g) {
        // panel g's q fragments into set g, whose last reader (panel g of
        // the step before) is done: the wait after the group before
        const int p = j * TF_G + g;
        const unsigned char* qp =
            p >= L.P ? sm
            : QRES   ? sm + Q_PANEL_BYTES + p * Q_PANEL_BYTES
                     : sm + L.RING + st * L.SLOT + 2 * TF_LO +
                         g * Q_PANEL_BYTES;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          // columns 8 kk + t4 and + 4: 16-byte chunks 2 kk and 2 kk + 1
          const int c0 = ((2 * kk) ^ w.g) << 4, c1 = ((2 * kk + 1) ^ w.g) << 4;
          hop::tf32_split(*reinterpret_cast<const float*>(qp + qa + c0),
                          ah[g][kk][0], al[g][kk][0]);
          hop::tf32_split(*reinterpret_cast<const float*>(qp + qb + c0),
                          ah[g][kk][1], al[g][kk][1]);
          hop::tf32_split(*reinterpret_cast<const float*>(qp + qa + c1),
                          ah[g][kk][2], al[g][kk][2]);
          hop::tf32_split(*reinterpret_cast<const float*>(qp + qb + c1),
                          ah[g][kk][3], al[g][kk][3]);
        }
        hop::wgmma_fence();
        const uint32_t kh = p < L.P ? slot + g * TILE_PANEL : zero;
        const uint32_t kl = p < L.P ? kh + TF_LO : zero;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t dkh = hop::desc_kmajor_sw128(kh + kk * 32);
          hop::wgmma_tf32_rs32(sc, ah[g][kk], dkh,
                               j > 0 || g > 0 || kk > 0);
          hop::wgmma_tf32_rs32(sc, ah[g][kk],
                               hop::desc_kmajor_sw128(kl + kk * 32));
          hop::wgmma_tf32_rs32(sc, al[g][kk], dkh);
        }
        hop::wgmma_commit();
        hop::wgmma_wait<1>();  // the group before this one is done
        if (g == 0 && j > 0) release(empty + prev);
      }
      prev = st;
      st_advance(st, ph, L.SLOTS);
    }
    hop::wgmma_wait<0>();
    release(empty + prev);
    hop::fence_regs(sc, NFRAG);
    const float2 alpha = softmax_tile(
        sc, m, l, a, w, it * KEYS,
        row_bias ? s_bias + (it % L.SLOTS) * KEYS : nullptr, bp, full_bias,
        key, scale2);
#pragma unroll
    for (int p = 0; p < NO; ++p)
#pragma unroll
      for (int i = 0; i < NFRAG; ++i) o[p][i] *= (i & 2) ? alpha.y : alpha.x;
    // P's fragment of keys 8 j .. 8 j + 7: (row ra, key 2 t4), (rb, 2 t4),
    // (ra, 2 t4 + 1), (rb, 2 t4 + 1), V^T's keys stored to match
#pragma unroll
    for (int j = 0; j < KEYS / 8; ++j) {
      hop::tf32_split(sc[4 * j], phi[j][0], plo[j][0]);
      hop::tf32_split(sc[4 * j + 2], phi[j][1], plo[j][1]);
      hop::tf32_split(sc[4 * j + 1], phi[j][2], plo[j][2]);
      hop::tf32_split(sc[4 * j + 3], phi[j][3], plo[j][3]);
    }
    // O += P V in 3xTF32, TF_G of the slice's V^T panels a step (its own
    // output panels, so a step's group may run as the next is issued)
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      constexpr int LAST = NO - (NV - 1) * TF_G;  // the last step's panels
      hop::mbar_wait_or_trap(ready + st, ph);
      hop::wgmma_fence();
      const uint32_t vt = ring + st * L.SLOT;
#pragma unroll
      for (int j = 0; j < KEYS / 8; ++j)
#pragma unroll
        for (int g = 0; g < (v < NV - 1 ? TF_G : LAST); ++g) {
          const uint32_t b = vt + g * TILE_PANEL + j * 32;
          float* acc = o[v * TF_G + g];
          hop::wgmma_tf32_rs32(acc, phi[j], hop::desc_kmajor_sw128(b));
          hop::wgmma_tf32_rs32(acc, phi[j],
                               hop::desc_kmajor_sw128(b + TF_LO));
          hop::wgmma_tf32_rs32(acc, plo[j], hop::desc_kmajor_sw128(b));
        }
      hop::wgmma_commit();
      hop::wgmma_wait<1>();  // the step before is done
      if (v > 0) release(empty + prev);
      prev = st;
      st_advance(st, ph, L.SLOTS);
    }
    hop::wgmma_wait<0>();
    release(empty + prev);
#pragma unroll
    for (int p = 0; p < NO; ++p) hop::fence_regs(o[p], NFRAG);
  }

  // ------------------------------------------------------------- epilogue
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const float denom = fmaxf(l[i], 1e-30f);
    inv[i] = 1.f / denom;
    const int r = i ? w.rb : w.ra;
    if (ps == 0 && w.t4 == 0 && r < a.Tq)
      a.lse_out[((long long)w.b * a.H + w.h) * a.Tq + r] =
          m[i] * LN2 + logf(denom);
  }
  // every step is used and split: the ring's first slots take the output
  hop::named_sync(1, 128);
  store_rows_f32<NO>(o, inv, sm + L.RING, &maps.out, w, a.Tq, ps);
}

template <bool QRES>
__global__ void __launch_bounds__(ST_THREADS, 1)
    wide_fwd_tf32(const __grid_constant__ Maps maps, const Args a) {
  const TfSmem L(a.D, QRES);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = hop::smem_u32(smem_raw);
  unsigned char* sm = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L.BAR);  // [SLOTS]
  uint64_t* ready = full + L.SLOTS;   // [SLOTS]: the 3 splitter warps done
  uint64_t* empty = ready + L.SLOTS;  // [SLOTS]: the 4 consumer warps done
  uint64_t* full_q = empty + L.SLOTS;  // the resident q
  float* s_bias = reinterpret_cast<float*>(sm + L.BIAS);

  const int nsl = tf_slices(L.P);
  const int sl = blockIdx.x % nsl;
  const int q0 = (blockIdx.x / nsl) * WG_ROWS;
  const int ps = sl * L.P / nsl, no = (sl + 1) * L.P / nsl - ps;
  const int nv = (no + TF_G - 1) / TF_G;  // value steps a tile
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31;
  int k_end = a.Tk;
  if (a.causal) k_end = min(k_end, q0 + WG_ROWS);  // later keys add nothing
  const int n_tiles = (k_end + KEYS - 1) / KEYS;

  if (tid == 0) {
    hop::mbar_init(full_q, 1);
    for (int s = 0; s < L.SLOTS; ++s) {
      hop::mbar_init(full + s, 32);
      hop::mbar_init(ready + s, TF_SPLIT / 32);
      hop::mbar_init(empty + s, 4);
    }
    hop::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 160) {
    // ----------------------------------------------------------- splitters
    const int t = tid - 160;
    int st = 0;
    uint32_t ph = 0;
    for (int it = 0; it < n_tiles; ++it) {
      for (int j = 0; j < L.NS + nv; ++j) {
        hop::mbar_wait_or_trap(full + st, ph);
        unsigned char* slot = sm + L.RING + st * L.SLOT;
        if (j < L.NS)
          tf_split_keys(slot, min(TF_G, L.P - j * TF_G), t);
        else
          tf_split_values(slot, min(TF_G, no - (j - L.NS) * TF_G), t);
        hop::fence_async_smem();
        __syncwarp();
        if (lane == 0) hop::mbar_arrive(ready + st);
        st_advance(st, ph, L.SLOTS);
      }
    }
    return;
  }
  if (tid >= 128) {
    // ------------------------------------------------------------ producer
    // one warp: lane 0 issues the copies; every lane stages a tile's bias
    // row with its first step and arrives on each step's barrier
    const bool row_bias = a.bias != nullptr && a.b_sq == 0;
    const float* bp = row_bias ? a.bias + b * a.b_sb + h * a.b_sh : nullptr;
    if (QRES && lane == 0) {
      hop::mbar_expect(full_q, L.P * Q_PANEL_BYTES);
      for (int p = 0; p < L.P; ++p)
        hop::tma_load_4d(sm + Q_PANEL_BYTES + p * Q_PANEL_BYTES, &maps.q,
                         full_q, p * 32, q0, h, b);
    }
    int st = 0, step = 0;
    uint32_t ph = 0;
    for (int it = 0; it < n_tiles; ++it) {
      const int k0 = it * KEYS;
      for (int j = 0; j < L.NS + nv; ++j, ++step) {
        if (step >= L.SLOTS) hop::mbar_wait_or_trap(empty + st, ph ^ 1);
        if (j == 0 && row_bias) {
          const int col = k0 + lane;
          s_bias[(it % L.SLOTS) * KEYS + lane] =
              col < a.Tk ? bp[col * a.b_sk] * LOG2E : 0.f;
        }
        if (lane != 0) {
          hop::mbar_arrive(full + st);
        } else {
          unsigned char* slot = sm + L.RING + st * L.SLOT;
          if (j < L.NS) {  // a score step: K (and q) panels [p0, p0 + n)
            const int p0 = j * TF_G, n = min(TF_G, L.P - p0);
            hop::mbar_expect(full + st,
                             n * (TILE_PANEL + (QRES ? 0 : Q_PANEL_BYTES)));
            for (int g = 0; g < n; ++g) {
              hop::tma_load_4d(slot + g * TILE_PANEL, &maps.k, full + st,
                               (p0 + g) * 32, k0, h, b);
              if (!QRES)
                hop::tma_load_4d(slot + 2 * TF_LO + g * Q_PANEL_BYTES,
                                 &maps.q, full + st, (p0 + g) * 32, q0, h,
                                 b);
            }
          } else {  // a value step: V panels [p0, p0 + n) of the slice
            const int p0 = (j - L.NS) * TF_G, n = min(TF_G, no - p0);
            hop::mbar_expect(full + st, n * TILE_PANEL);
            for (int g = 0; g < n; ++g)
              hop::tma_load_4d(slot + g * TILE_PANEL, &maps.v, full + st,
                               (ps + p0 + g) * 32, k0, h, b);
          }
        }
        st_advance(st, ph, L.SLOTS);
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumer
  if (no == 6)
    fwd_tf32_consumer<6, QRES>(maps, a, sm, L, q0, ps, n_tiles);
  else if (no == 5)
    fwd_tf32_consumer<5, QRES>(maps, a, sm, L, q0, ps, n_tiles);
  else
    fwd_tf32_consumer<4, QRES>(maps, a, sm, L, q0, ps, n_tiles);
}

// ------------------------------------------ f32 heads: dq on 3xTF32
// f32 dq at every D (route "wide_f32" above 256, the f32 pair's dq of route
// "tiled" at D <= 256): wide_fwd_tf32's walk with q streamed, two products
// where the forward has one on each side:
//  - s = q K^T and dp = dout V^T: q's and dout's raw panels come with K's
//    and V's, TF_G of each a score step, q and dout split in the
//    consumer's registers as the A operand, K and V split in place by the
//    splitters (hi, lo TF_LO bytes on; V at 2 TF_LO) as the K-major B;
//  - dq += ds K (times scale once, at the store): ds, the dp accumulator,
//    split in registers as the A operand (as P in the forward, no
//    shuffle), K's panels of the slice transposed in place into K^T by the
//    splitters, the keys of each 8-key group at hop::tf32_key_pos (the
//    forward's V^T).
// A block owns 64 rows and a slice of up to TF_NO dq panels (tf_slices: one
// slice of all P panels up to D = 192, two of 3 or 4 at 193-256, 4 to 6
// above); the slices recompute s and dp. q and dout beside K and V take a
// 64 KB slot (three slots); keeping them resident (2 D 256 bytes: 160 KB
// at D = 320) would leave the ring too few. dq leaves once, times scale, by TMA store: no
// atomics, every sum in one order, so dq (and ds) are the same bits from
// run to run. Bound: operations, its three products (6 T^2 D flops a
// (batch, head), each as three TF32 ones); on an H100 it takes 5-6 times
// that bound (PERF.md section 6).
constexpr int TQ_SLOT = 4 * TF_LO + 2 * TF_G * Q_PANEL_BYTES;
constexpr int TQ_Q = 4 * TF_LO;  // q's raw panels in a score step's slot
constexpr int TQ_O = TQ_Q + TF_G * Q_PANEL_BYTES;  // ... dout's

// The f32 dq kernel's shared memory from a 1024-byte aligned base: a zeroed
// 64-row panel (the operands of score panels past P), the ring's SLOTS
// slots, a tile's key terms a slot (indexed by tile), then the mbarriers:
// full, ready and empty a slot.
struct TfDqSmem {
  int P, NS, SLOTS, RING, KTERM, BAR, ALLOC;
  __host__ __device__ explicit TfDqSmem(int D) {
    P = (D + 31) / 32;
    NS = (P + TF_G - 1) / TF_G;
    RING = Q_PANEL_BYTES;
    SLOTS = (SMEM_LIMIT - 1024 - RING) / (TQ_SLOT + KEYS * 4 + 3 * 8);
    if (SLOTS > ST_MAX_SLOTS) SLOTS = ST_MAX_SLOTS;
    KTERM = RING + SLOTS * TQ_SLOT;
    BAR = KTERM + SLOTS * KEYS * 4;
    ALLOC = BAR + 3 * SLOTS * 8 + 1024;
  }
};

// The consumer of the f32 dq kernel: s and dp over all P panels, ds, and
// dq over the slice's NO panels from ps; slice 0 writes ds.
template <int NO>
__device__ __forceinline__ void dq_tf32_consumer(const Maps& maps,
                                                 const Args& a,
                                                 unsigned char* sm,
                                                 const TfDqSmem& L, int r0,
                                                 int ps, int n_tiles) {
  constexpr int NV = (NO + TF_G - 1) / TF_G;  // value steps a tile
  const Rows w = rows_of(r0);
  const long long bh = static_cast<long long>(w.b) * a.H + w.h;
  const uint2 key = a.dropout ? mxt::dropout_key(a.seed) : make_uint2(0, 0);
  const float scale2 = a.scale * LOG2E;
  const bool full_bias = a.bias != nullptr && a.b_sq != 0;
  const float* bp = a.bias ? a.bias + w.b * a.b_sb + w.h * a.b_sh : nullptr;
  // the rows' lse in base-2 units (+inf past Tq: p = 0 there) and delta
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = i ? w.rb : w.ra;
    lse2[i] = r < a.Tq ? a.lse[bh * a.Tq + r] * LOG2E : INFINITY;
    dl[i] = r < a.Tq ? a.delta[bh * a.Tq + r] : 0.f;
  }
  const uint32_t zero = hop::smem_u32(sm);
  const uint32_t ring = zero + L.RING;
  uint64_t* ready = reinterpret_cast<uint64_t*>(sm + L.BAR) + L.SLOTS;
  uint64_t* empty = ready + L.SLOTS;
  const float* s_kterm = reinterpret_cast<const float*>(sm + L.KTERM);
  float* dsp = ps == 0 && a.ds != nullptr
                   ? a.ds + bh * a.Tq * static_cast<long long>(a.Tk)
                   : nullptr;
  // this thread's word of row w.warp * 16 + w.g of a 64-row panel
  const int qa = (w.warp * 16 + w.g) * ROW_BYTES + w.t4 * 4;

  float dq[NO][NFRAG];
#pragma unroll
  for (int p = 0; p < NO; ++p)
#pragma unroll
    for (int i = 0; i < NFRAG; ++i) dq[p][i] = 0.f;
  float sc[NFRAG], dp[NFRAG];  // s, dp: rows ra, rb; KEYS / 4 keys
  // two sets of an A operand's TF32 halves (hi, lo), k8 step kk: q's then
  // ds's, and dout's
  uint32_t h0[4][4], l0[4][4], h1[4][4], l1[4][4];

  st_zero(sm);
  int st = 0;
  uint32_t ph = 0;
  for (int it = 0; it < n_tiles; ++it) {
    // s = q K^T and dp = dout V^T in 3xTF32, a group each a panel: the
    // next panel's halves split while the group before runs; a panel past
    // P reads the zeroed one
    int prev = 0;  // the slot of the step before, in use until its groups
                   // are done
    for (int j = 0; j < L.NS; ++j) {
      hop::mbar_wait_or_trap(ready + st, ph);
      const uint32_t slot = ring + st * TQ_SLOT;
      const unsigned char* sp = sm + L.RING + st * TQ_SLOT;
#pragma unroll
      for (int g = 0; g < TF_G; ++g) {
        const int p = j * TF_G + g;
        const bool real = p < L.P;
        const bool first = j == 0 && g == 0;
        const uint32_t lo = real ? TF_LO : 0;  // lo's offset (0: the zeros)
        hop::wgmma_wait<1>();  // s's group before is done: h0, l0 free
        const unsigned char* qp = real ? sp + TQ_Q + g * Q_PANEL_BYTES : sm;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hop::tf32_rows_split(qp, qa, w.g, kk, h0[kk], l0[kk]);
        hop::wgmma_fence();
        const uint32_t kh = real ? slot + g * TILE_PANEL : zero;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hop::wgmma_tf32_3x(sc, h0[kk], l0[kk], kh + kk * 32, lo,
                             !first || kk > 0);
        hop::wgmma_commit();
        hop::wgmma_wait<1>();  // dp's group before is done: h1, l1 free
        if (g == 0 && j > 0) release(empty + prev);
        const unsigned char* op = real ? sp + TQ_O + g * Q_PANEL_BYTES : sm;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hop::tf32_rows_split(op, qa, w.g, kk, h1[kk], l1[kk]);
        hop::wgmma_fence();
        const uint32_t vh = real ? slot + 2 * TF_LO + g * TILE_PANEL : zero;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hop::wgmma_tf32_3x(dp, h1[kk], l1[kk], vh + kk * 32, lo,
                             !first || kk > 0);
        hop::wgmma_commit();
      }
      prev = st;
      st_advance(st, ph, L.SLOTS);
    }
    hop::wgmma_wait<0>();
    release(empty + prev);
    hop::fence_regs(sc, NFRAG);
    hop::fence_regs(dp, NFRAG);
    ds_tile(sc, dp, a, w, it * KEYS, s_kterm + (it % L.SLOTS) * KEYS, lse2,
            dl, key, scale2, full_bias, bp, dsp);
    // ds as the A operand of its 4 k8 steps over the keys, K^T's keys
    // stored to match
    hop::tf32_acc_split(dp, 1.f, h0, l0);
    // dq += ds K in 3xTF32, TF_G of the slice's K^T panels a step (its own
    // dq panels, so a step's group may run as the next is issued)
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      constexpr int LAST = NO - (NV - 1) * TF_G;  // the last step's panels
      hop::mbar_wait_or_trap(ready + st, ph);
      hop::wgmma_fence();
      const uint32_t kt = ring + st * TQ_SLOT;
#pragma unroll
      for (int j = 0; j < KEYS / 8; ++j)
#pragma unroll
        for (int g = 0; g < (v < NV - 1 ? TF_G : LAST); ++g)
          hop::wgmma_tf32_3x(dq[v * TF_G + g], h0[j], l0[j],
                             kt + g * TILE_PANEL + j * 32, TF_LO);
      hop::wgmma_commit();
      hop::wgmma_wait<1>();  // the step before is done
      if (v > 0) release(empty + prev);
      prev = st;
      st_advance(st, ph, L.SLOTS);
    }
    hop::wgmma_wait<0>();
    release(empty + prev);
#pragma unroll
    for (int p = 0; p < NO; ++p) hop::fence_regs(dq[p], NFRAG);
  }

  // ------------------------------------------------------------- epilogue
  // every step is used and split: the ring's first slots take dq * scale
  hop::named_sync(1, 128);
  const float mul[2] = {a.scale, a.scale};
  store_rows_f32<NO>(dq, mul, sm + L.RING, &maps.out, w, a.Tq, ps);
}

// NO_LO = 4: slices of 4 to 6 panels (tf_dq_wide); 1: of 1 to 4 (P <= 3 or
// 7), built apart so that the narrow widths add no registers to the wide
// ones
template <int NO_LO>
__global__ void __launch_bounds__(ST_THREADS, 1)
    wide_dq_tf32(const __grid_constant__ Maps maps, const Args a) {
  const TfDqSmem L(a.D);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = hop::smem_u32(smem_raw);
  unsigned char* sm = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L.BAR);  // [SLOTS]
  uint64_t* ready = full + L.SLOTS;   // [SLOTS]: the 3 splitter warps done
  uint64_t* empty = ready + L.SLOTS;  // [SLOTS]: the 4 consumer warps done
  float* s_kterm = reinterpret_cast<float*>(sm + L.KTERM);

  const int nsl = tf_slices(L.P);
  const int sl = blockIdx.x % nsl;
  const int q0 = (blockIdx.x / nsl) * WG_ROWS;
  const int ps = sl * L.P / nsl, no = (sl + 1) * L.P / nsl - ps;
  const int nv = (no + TF_G - 1) / TF_G;  // value steps a tile
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31;
  int k_end = a.Tk;
  if (a.causal) k_end = min(k_end, q0 + WG_ROWS);  // later keys add nothing
  const int n_tiles = (k_end + KEYS - 1) / KEYS;

  if (tid == 0) {
    for (int s = 0; s < L.SLOTS; ++s) {
      hop::mbar_init(full + s, 32);
      hop::mbar_init(ready + s, TF_SPLIT / 32);
      hop::mbar_init(empty + s, 4);
    }
    hop::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 160) {
    // ----------------------------------------------------------- splitters
    // a score step's K and V panels split in place, a value step's K
    // panels transposed into K^T
    const int t = tid - 160;
    int st = 0;
    uint32_t ph = 0;
    for (int it = 0; it < n_tiles; ++it) {
      for (int j = 0; j < L.NS + nv; ++j) {
        hop::mbar_wait_or_trap(full + st, ph);
        unsigned char* slot = sm + L.RING + st * TQ_SLOT;
        if (j < L.NS) {
          const int n = min(TF_G, L.P - j * TF_G);
          tf_split_keys(slot, n, t);
          tf_split_keys(slot + 2 * TF_LO, n, t);
        } else {
          tf_split_values(slot, min(TF_G, no - (j - L.NS) * TF_G), t);
        }
        hop::fence_async_smem();
        __syncwarp();
        if (lane == 0) hop::mbar_arrive(ready + st);
        st_advance(st, ph, L.SLOTS);
      }
    }
    return;
  }
  if (tid >= 128) {
    // ------------------------------------------------------------ producer
    // one warp: lane 0 issues the copies; every lane stages a tile's key
    // terms with its first step and arrives on each step's barrier
    const bool row_bias = a.bias != nullptr && a.b_sq == 0;
    const float* bp = row_bias ? a.bias + b * a.b_sb + h * a.b_sh : nullptr;
    int st = 0, step = 0;
    uint32_t ph = 0;
    for (int it = 0; it < n_tiles; ++it) {
      const int k0 = it * KEYS;
      for (int j = 0; j < L.NS + nv; ++j, ++step) {
        if (step >= L.SLOTS) hop::mbar_wait_or_trap(empty + st, ph ^ 1);
        if (j == 0) {
          // each key's term of the exponent in base-2 units: the
          // key-padding bias (bias broadcast over Tq), -inf past Tk
          const int col = k0 + lane;
          s_kterm[(it % L.SLOTS) * KEYS + lane] =
              col >= a.Tk     ? -INFINITY
              : bp != nullptr ? bp[col * a.b_sk] * LOG2E
                              : 0.f;
        }
        if (lane != 0) {
          hop::mbar_arrive(full + st);
        } else {
          unsigned char* slot = sm + L.RING + st * TQ_SLOT;
          if (j < L.NS) {  // a score step: K, V, q, dout panels [p0, p0 + n)
            const int p0 = j * TF_G, n = min(TF_G, L.P - p0);
            hop::mbar_expect(full + st,
                             n * 2 * (TILE_PANEL + Q_PANEL_BYTES));
            for (int g = 0; g < n; ++g) {
              const int c = (p0 + g) * 32;
              hop::tma_load_4d(slot + g * TILE_PANEL, &maps.k, full + st, c,
                               k0, h, b);
              hop::tma_load_4d(slot + 2 * TF_LO + g * TILE_PANEL, &maps.v,
                               full + st, c, k0, h, b);
              hop::tma_load_4d(slot + TQ_Q + g * Q_PANEL_BYTES, &maps.q,
                               full + st, c, q0, h, b);
              hop::tma_load_4d(slot + TQ_O + g * Q_PANEL_BYTES, &maps.dout,
                               full + st, c, q0, h, b);
            }
          } else {  // a value step: K panels [p0, p0 + n) of the slice
            const int p0 = (j - L.NS) * TF_G, n = min(TF_G, no - p0);
            hop::mbar_expect(full + st, n * TILE_PANEL);
            for (int g = 0; g < n; ++g)
              hop::tma_load_4d(slot + g * TILE_PANEL, &maps.k, full + st,
                               (ps + p0 + g) * 32, k0, h, b);
          }
        }
        st_advance(st, ph, L.SLOTS);
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumer
  if constexpr (NO_LO == 4) {
    if (no == 6)
      dq_tf32_consumer<6>(maps, a, sm, L, q0, ps, n_tiles);
    else if (no == 5)
      dq_tf32_consumer<5>(maps, a, sm, L, q0, ps, n_tiles);
    else
      dq_tf32_consumer<4>(maps, a, sm, L, q0, ps, n_tiles);
  } else {
    if (no == 4)
      dq_tf32_consumer<4>(maps, a, sm, L, q0, ps, n_tiles);
    else if (no == 3)
      dq_tf32_consumer<3>(maps, a, sm, L, q0, ps, n_tiles);
    else if (no == 2)
      dq_tf32_consumer<2>(maps, a, sm, L, q0, ps, n_tiles);
    else
      dq_tf32_consumer<1>(maps, a, sm, L, q0, ps, n_tiles);
  }
}

// ------------------------------------------------------------------- host
template <typename K>
cudaError_t launch(K kern, dim3 grid, int threads, size_t smem,
                   cudaStream_t stream, const Maps& maps, const Args& a) {
  cudaError_t e = mxt::set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<grid, threads, smem, stream>>>(maps, a);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_fwd(const Args& a, const Maps& maps, cudaStream_t st) {
  const dim3 grid((a.Tq + WG_ROWS - 1) / WG_ROWS, a.H, a.B);
  return launch(wide_fwd_wg<T, DP>, grid, 3 * 128, FwdSmem<DP>::ALLOC, st,
                maps, a);
}

// the streamed kernels (D > 512): a block a slice of a row block's output
template <typename T>
cudaError_t launch_fwd_st(const Args& a, const Maps& maps, cudaStream_t st) {
  const int P = (a.D + 63) / 64;
  const dim3 grid((a.Tq + WG_ROWS - 1) / WG_ROWS * st_slices(P), a.H, a.B);
  if (fwd_q_resident(P))
    return launch(wide_fwd_st<T, true>, grid, ST_THREADS,
                  StreamSmem(a.D, false, true).ALLOC, st, maps, a);
  return launch(wide_fwd_st<T, false>, grid, ST_THREADS,
                StreamSmem(a.D, false, false).ALLOC, st, maps, a);
}

template <typename T>
cudaError_t launch_dq_st(const Args& a, const Maps& maps, cudaStream_t st) {
  const int P = (a.D + 63) / 64;
  const dim3 grid((a.Tq + WG_ROWS - 1) / WG_ROWS * st_slices(P), a.H, a.B);
  return launch(wide_dq_st<T>, grid, ST_THREADS,
                StreamSmem(a.D, true, false).ALLOC, st, maps, a);
}

template <typename T, int DP, int MODE = dq_mode(DP)>
cudaError_t launch_dq(const Args& a, const Maps& maps, cudaStream_t st) {
  using L = DqSmem<DP, MODE>;
  const dim3 grid(
      (a.Tq + WG_ROWS - 1) / WG_ROWS * Split<DP / 64, MODE>::NSLICE, a.H,
      a.B);
  return launch(wide_dq_wg<T, DP, MODE>, grid, (L::NC + 1) * 128, L::ALLOC,
                st, maps, a);
}

// kind 0: the forward, 1: the dq kernel. q, k, v (and dout, for dq) read
// and out (dq) written by TMA.
template <typename T>
cudaError_t dispatch(int kind, const Args& a, cudaStream_t st) {
  const CUtensorMapDataType type = mxt::TmaType<T>::value;
  const int dp = a.D <= 320 ? 320 : a.D <= 384 ? 384 : a.D <= 448 ? 448 : 512;
  Maps maps;
  if (!mxt::make_map(&maps.q, type, a.q, a.D, a.Tq, a.H, a.B, a.q_st,
                     a.q_sh, a.q_sb, WG_ROWS) ||
      !mxt::make_map(&maps.k, type, a.k, a.D, a.Tk, a.H, a.B, a.k_st,
                     a.k_sh, a.k_sb, KEYS) ||
      !mxt::make_map(&maps.v, type, a.v, a.D, a.Tk, a.H, a.B, a.v_st,
                     a.v_sh, a.v_sb, KEYS) ||
      !mxt::make_map(&maps.out, type, a.o, a.D, a.Tq, a.H, a.B, a.o_st,
                     a.o_sh, a.o_sb, WG_ROWS))
    return cudaErrorInvalidValue;
  if (kind == 0) {
    maps.dout = maps.q;  // unused
    if (a.D > 512) return launch_fwd_st<T>(a, maps, st);
    if (dp == 320) return launch_fwd<T, 320>(a, maps, st);
    if (dp == 384) return launch_fwd<T, 384>(a, maps, st);
    if (dp == 448) return launch_fwd<T, 448>(a, maps, st);
    return launch_fwd<T, 512>(a, maps, st);
  }
  if (!mxt::make_map(&maps.dout, type, a.dout, a.D, a.Tq, a.H, a.B,
                     a.do_st, a.do_sh, a.do_sb, WG_ROWS))
    return cudaErrorInvalidValue;
  if (a.D > 512) return launch_dq_st<T>(a, maps, st);
  if (dp == 320) return launch_dq<T, 320>(a, maps, st);
  if (dp == 384) return launch_dq<T, 384>(a, maps, st);
  if (dp == 448) return launch_dq<T, 448>(a, maps, st);
  return launch_dq<T, 512>(a, maps, st);
}

// The f32 kernels (kind 0: the forward, 1: dq): q, k, v (and dout) read
// and out (dq) written by TMA in f32 boxes of 32 columns
cudaError_t dispatch_tf32(int kind, const Args& a, cudaStream_t st) {
  const CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  Maps maps;
  if (!mxt::make_map(&maps.q, type, a.q, a.D, a.Tq, a.H, a.B, a.q_st,
                     a.q_sh, a.q_sb, WG_ROWS, 4) ||
      !mxt::make_map(&maps.k, type, a.k, a.D, a.Tk, a.H, a.B, a.k_st,
                     a.k_sh, a.k_sb, KEYS, 4) ||
      !mxt::make_map(&maps.v, type, a.v, a.D, a.Tk, a.H, a.B, a.v_st,
                     a.v_sh, a.v_sb, KEYS, 4) ||
      !mxt::make_map(&maps.out, type, a.o, a.D, a.Tq, a.H, a.B, a.o_st,
                     a.o_sh, a.o_sb, WG_ROWS, 4))
    return cudaErrorInvalidValue;
  const int P = (a.D + 31) / 32;
  const dim3 grid((a.Tq + WG_ROWS - 1) / WG_ROWS * tf_slices(P), a.H, a.B);
  if (kind == 1) {
    if (!mxt::make_map(&maps.dout, type, a.dout, a.D, a.Tq, a.H, a.B,
                       a.do_st, a.do_sh, a.do_sb, WG_ROWS, 4))
      return cudaErrorInvalidValue;
    if (tf_dq_wide(P))
      return launch(wide_dq_tf32<4>, grid, ST_THREADS, TfDqSmem(a.D).ALLOC,
                    st, maps, a);
    return launch(wide_dq_tf32<1>, grid, ST_THREADS, TfDqSmem(a.D).ALLOC, st,
                  maps, a);
  }
  maps.dout = maps.q;  // unused
  if (tf_q_resident(P))
    return launch(wide_fwd_tf32<true>, grid, ST_THREADS,
                  TfSmem(a.D, true).ALLOC, st, maps, a);
  return launch(wide_fwd_tf32<false>, grid, ST_THREADS,
                TfSmem(a.D, false).ALLOC, st, maps, a);
}

// dtype 0 (f32), 1 (bf16) or 2 (fp16)
cudaError_t dispatch(int kind, int dtype, const Args& a, cudaStream_t st) {
  if (dtype == 0) return dispatch_tf32(kind, a, st);
  if (dtype == 1) return dispatch<__nv_bfloat16>(kind, a, st);
  return dispatch<__half>(kind, a, st);
}

// kind 0: the forward, 1: dq; every D > 256, and the f32 dq at every D
bool bad(int kind, int dtype, int B, int H, int Tq, int Tk, int D,
         int dropout, const int* seed) {
  const int least = dtype == 0 && kind == 1 ? 1 : 257;
  return dtype < 0 || dtype > 2 || D < least || B < 1 || H < 1 ||
         Tq < 1 || Tk < 1 || B > 65535 || H > 65535 || (dropout && !seed);
}

}  // namespace wwg
}  // namespace

// The forward, with mxt_flash_attention_fwd's arguments (strides of q, k,
// v, out as (batch, head, time) triples, then the bias's four), at D > 256
// for dtype 0 (f32: wide_fwd_tf32), 1 (bfloat16) or 2 (float16). q, k, v
// and out must be views TMA can address (16-byte aligned, strides of
// dimensions longer than 1 multiples of 16 bytes; the Python wrapper
// copies other operands). Returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int mxt_flash_wide_wg_fwd(int dtype, const void* q, const void* k,
                                     const void* v, const float* bias,
                                     void* out, float* lse, int B, int H,
                                     int Tq, int Tk, int D,
                                     const long long* strides, float scale,
                                     int causal, const int* seed, int dropout,
                                     unsigned int drop_threshold,
                                     float drop_scale, void* stream) {
  if (wwg::bad(0, dtype, B, H, Tq, Tk, D, dropout, seed) || !out || !lse)
    return static_cast<int>(cudaErrorInvalidValue);
  wwg::Args a{};
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
      wwg::dispatch(0, dtype, a, static_cast<cudaStream_t>(stream)));
}

// The dq kernel, with mxt_flash_wide_bwd's arguments (kind must be 1;
// strides of q, k, v, dout, dq, dk, dv as (batch, head, time) triples, then
// the bias's four; dk, dv unused), at D > 256 for dtype 0 (f32:
// wide_dq_tf32), 1 (bfloat16) or 2 (float16), q, k, v, dout and dq
// addressable by TMA. ds, when not null, is a (B, H, Tq, Tk) f32 buffer
// the kernel fills with p * (dp - delta).
extern "C" int mxt_flash_wide_wg_bwd(
    int kind, int dtype, const void* q, const void* k, const void* v,
    const void* dout, const float* bias, const float* lse, const float* delta,
    void* dq, void* dk, void* dv, float* ds, int B, int H, int Tq, int Tk,
    int D, const long long* strides, float scale, int causal,
    const int* seed, int dropout, unsigned int drop_threshold,
    float drop_scale, void* stream) {
  (void)dk;
  (void)dv;
  if (wwg::bad(1, dtype, B, H, Tq, Tk, D, dropout, seed) || kind != 1 || !lse ||
      !delta || !dq)
    return static_cast<int>(cudaErrorInvalidValue);
  wwg::Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.bias = bias; a.lse = lse;
  a.delta = delta; a.o = dq; a.ds = ds;
  a.B = B; a.H = H; a.Tq = Tq; a.Tk = Tk; a.D = D;
  a.q_sb = strides[0]; a.q_sh = strides[1]; a.q_st = strides[2];
  a.k_sb = strides[3]; a.k_sh = strides[4]; a.k_st = strides[5];
  a.v_sb = strides[6]; a.v_sh = strides[7]; a.v_st = strides[8];
  a.do_sb = strides[9]; a.do_sh = strides[10]; a.do_st = strides[11];
  a.o_sb = strides[12]; a.o_sh = strides[13]; a.o_st = strides[14];
  a.b_sb = strides[21]; a.b_sh = strides[22]; a.b_sq = strides[23];
  a.b_sk = strides[24];
  a.scale = scale; a.causal = causal; a.seed = seed; a.dropout = dropout != 0;
  a.drop_threshold = drop_threshold; a.drop_scale = drop_scale;
  return static_cast<int>(
      wwg::dispatch(1, dtype, a, static_cast<cudaStream_t>(stream)));
}
