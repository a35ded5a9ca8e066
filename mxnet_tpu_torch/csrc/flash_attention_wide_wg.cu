// Flash attention at 16-bit head dims 256 < D <= 512 for Hopper (sm_90a),
// tiled on wgmma and TMA, bound through plain C entries: the forward and
// the backward's dq kernel.
//
// Replaces, for bf16 / fp16 at 256 < D <= 512: mxnet_tpu/ops/pallas/
// attention.py, _flash_fwd_kernel (launched at :317) and
// _flash_bwd_dq_kernel (launched at :740), which take any head dim. It
// computes what flash_attention_wide.cu's wide_fwd and wide_dq compute (a
// warp a row on the FMA pipe; they keep f32 and D > 512, and wide_dkv):
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
// the warpgroup's rows first), then stored by TMA by one thread. The
// caller has made sure nobody reads those panels any more.
template <typename T, int O0, int O1>
__device__ __forceinline__ void store_rows(const float (*acc)[32],
                                           const float* mul,
                                           unsigned char* region, int panel,
                                           const CUtensorMap* map,
                                           const Rows& w, int Tq, int wg) {
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
      hop::tma_store_4d(map, region + p * panel, p * 64, w.r0, w.h, w.b);
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
    if (dp == 320) return launch_fwd<T, 320>(a, maps, st);
    if (dp == 384) return launch_fwd<T, 384>(a, maps, st);
    if (dp == 448) return launch_fwd<T, 448>(a, maps, st);
    return launch_fwd<T, 512>(a, maps, st);
  }
  if (!mxt::make_map(&maps.dout, type, a.dout, a.D, a.Tq, a.H, a.B,
                     a.do_st, a.do_sh, a.do_sb, WG_ROWS))
    return cudaErrorInvalidValue;
  if (dp == 320) return launch_dq<T, 320>(a, maps, st);
  if (dp == 384) return launch_dq<T, 384>(a, maps, st);
  if (dp == 448) return launch_dq<T, 448>(a, maps, st);
  return launch_dq<T, 512>(a, maps, st);
}

cudaError_t dispatch(int kind, int dtype, const Args& a, cudaStream_t st) {
  if (dtype == 1) return dispatch<__nv_bfloat16>(kind, a, st);
  return dispatch<__half>(kind, a, st);
}

bool bad(int dtype, int B, int H, int Tq, int Tk, int D, int dropout,
         const int* seed) {
  return dtype < 1 || dtype > 2 || D <= 256 || D > 512 || B < 1 || H < 1 ||
         Tq < 1 || Tk < 1 || B > 65535 || H > 65535 || (dropout && !seed);
}

}  // namespace wwg
}  // namespace

// The forward, with mxt_flash_wide_fwd's arguments (flash_attention_wide.cu:
// strides of q, k, v, out as (batch, head, time) triples, then the bias's
// four), for 16-bit data (dtype 1 = bfloat16, 2 = float16) at 256 < D <=
// 512. q, k, v and out must be views TMA can address (16-byte aligned,
// strides of dimensions longer than 1 multiples of 8 elements; the Python
// wrapper copies other operands). Returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int mxt_flash_wide_wg_fwd(int dtype, const void* q, const void* k,
                                     const void* v, const float* bias,
                                     void* out, float* lse, int B, int H,
                                     int Tq, int Tk, int D,
                                     const long long* strides, float scale,
                                     int causal, const int* seed, int dropout,
                                     unsigned int drop_threshold,
                                     float drop_scale, void* stream) {
  if (wwg::bad(dtype, B, H, Tq, Tk, D, dropout, seed) || !out || !lse)
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
// the bias's four; dk, dv unused), for 16-bit data at 256 < D <= 512, every
// 16-bit operand and dq addressable by TMA. ds, when not null, is a
// (B, H, Tq, Tk) f32 buffer the kernel fills with p * (dp - delta).
extern "C" int mxt_flash_wide_wg_bwd(
    int kind, int dtype, const void* q, const void* k, const void* v,
    const void* dout, const float* bias, const float* lse, const float* delta,
    void* dq, void* dk, void* dv, float* ds, int B, int H, int Tq, int Tk,
    int D, const long long* strides, float scale, int causal,
    const int* seed, int dropout, unsigned int drop_threshold,
    float drop_scale, void* stream) {
  (void)dk;
  (void)dv;
  if (wwg::bad(dtype, B, H, Tq, Tk, D, dropout, seed) || kind != 1 ||
      !lse || !delta || !dq)
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
