// Flash-attention backward for Hopper (sm_90a), bound through a plain C entry.
//
// Replaces: mxnet_tpu/ops/pallas/attention.py, the three kernels that
// _flash_backward launches through pl.pallas_call:
//   _flash_bwd_fused_kernel (single pass when Tk fits one k-block),
//   _flash_bwd_dq_kernel and _flash_bwd_dkv_kernel (the two-pass pair).
// All three compute, from q, k, v, dout, the forward's lse and
// delta = rowsum(dout * out) (f32, computed by the caller):
//   p   = exp(q k^T * scale + bias - lse), 0 where masked
//   p_d = keep ? p / (1 - rate) : 0          (probability dropout)
//   dp  = keep ? (dout v^T) / (1 - rate) : 0
//   ds0 = p * (dp - delta)                   (emitted in f32 when the bias
//                                             is learned, for its gradient)
//   dv  = p_d^T dout,  dk = (ds0 * scale)^T q,  dq = (ds0 * scale) k
// with the causal mask top-left (col <= row), keys past Tk and rows past Tq
// masked in the kernel (the caller pads nothing), the additive f32 bias
// broadcast through its strides, and the dropout keep bit of philox.cuh,
// the same pure function of (seed, batch, head, row, col) as the forward's.
// q, k, v, dout, dq, dk and dv are addressed through (batch, head, time)
// strides with a unit stride on the head dimension, so the q, k, v views of
// a fused QKV projection are read where they lie.
//
// What bounds it on an H100: the five products are 10*T*T*D flops against
// about 8*T*D*2 bytes per (batch, head) in 16 bits; at BERT shapes (T = 512,
// D = 64) that is ~320 flops a byte, near the card's ~295, so operations
// and bytes bound it about equally (PERF.md). Above that floor come the
// T*T exponentials on the special-function unit, dropout's Philox on the
// FMA pipe and the serial chain s -> p -> products inside each warpgroup.
// Every T x T quantity (s, p, dp, ds) stays in registers and shared memory,
// never in device memory unless the bias gradient asks for ds.
//
// 16-bit inputs (FlashAttention-3's backward on the design of
// flash_attention_fwd.cu): every operand is read and every 16-bit output
// written by TMA (128-byte swizzle, zero fill past Tk, Tq and D, stores
// clipped there); one producer warp issues the copies into rings of stages
// on mbarriers, and its warpgroup hands its registers to the consumer
// warpgroups (setmaxnreg).
//
// - The key-block walk (kv_walk): a block owns a block of keys of one
//   (batch, head). The producer loads their K and V once and streams tiles
//   of q and dout (64 rows in the fused pass, 32 in dkv), with their lse
//   (base 2, +inf past Tq so p = 0 there) and delta rows. Each consumer
//   warpgroup keeps its dk and dv in f32 registers over the walk. Per q
//   tile it computes s^T = K q^T and
//   dp^T = V dout^T by wgmma (K-major operands), p^T with ex2 and scale *
//   log2(e) folded into one FMA (the key-padding bias of its two keys read
//   once, in base-2 units), the dropout mask (one Philox call per 2 x 2
//   block, shared by the two lanes holding keys 2i and 2i+1 by shuffle),
//   and then dv += p_d^T dout and dk += ds^T q by wgmma with p_d^T and ds^T
//   as the register A operand and dout, q as the MN-major B. dk and dv
//   leave by TMA stores. Causal blocks start at the diagonal q tile. It is
//   two kernels:
//   * bwd_fused_wg (the single pass, D <= 128): 128 keys a block, 64 a
//     consumer warpgroup, DP = 64 or 128. ds^T also goes transposed
//     (stmatrix) into a swizzled ds [q][key] panel; dq = ds K over the
//     warpgroup's 64 keys is one more wgmma, whose f32 result goes through
//     a shared-memory staging buffer (two at DP = 64) to one bulk
//     reduce-add (cp.reduce.async.bulk .add.f32) into the caller's zeroed
//     f32 accumulator, laid out (B, H, Tq rounded up to 64, DP + 8) so that
//     a tile is one contiguous run. The order in which the key tiles'
//     partial sums reach dq changes from run to run, so its dq is not
//     bitwise reproducible (it agrees to rounding).
//   * bwd_dkv_wg (the pair's dk, dv): the same walk with the dq product
//     compiled out, over q tiles of 32 rows in a ring of four stages: s^T,
//     dp^T and their 16-bit fragments take half the registers, which dk and
//     dv need at DP = 128 (with 64-row tiles it spills ~1.3 KB and ptxas
//     serializes its wgmma, C7512; PERF.md section 6). At
//     DP <= 128 as above. At DP = 256 a warpgroup's dk and dv for 64 keys
//     would take 256 f32 registers a thread (the cap is 232), so the block
//     takes 64 keys and each warpgroup owns one 128-column half of dk and
//     dv (64 + 64 registers), computing s^T and dp^T for all 64 keys
//     itself: 1.5 times the products of a split-free kernel, in 192 KB of
//     shared memory (K, V and the ring of q and dout).
// - bwd_dq_wg (the pair's dq), on the forward's walk: a block owns 64 NC
//   query rows (NC = 2 consumer warpgroups, 1 at DP = 256, where q, dout
//   and a ring of 64-key K / V tiles would not fit twice). The producer
//   loads q and dout once and streams K and V tiles with each key's term of
//   the exponent (its key-padding bias in base 2, -inf past Tk). Per tile a
//   warpgroup computes s = q K^T and dp = dout V^T by wgmma, p with ex2
//   against its rows' lse, the dropout mask with the forward's pairing
//   (queries are the rows), ds = p (dp - delta) (stored in f32 when the
//   bias is learned), and dq += ds K with ds packed to 16 bits as the
//   register A operand and K as the MN-major B (the forward's P V with V
//   replaced by K). dq stays in f32 registers over the whole walk and
//   leaves once, scaled and in q's dtype, by TMA store: no accumulator, no
//   atomics, so the pair is bitwise deterministic. Causal blocks stop at
//   the diagonal key tile. (128-key tiles spill at DP = 64, and a third
//   consumer warpgroup was slower at T = 512; PERF.md section 6.)
//
// D <= 128 takes the fused pass when Tk fits one k-block (the caller's
// rule) and the pair otherwise; 128 < D <= 256 takes the pair at every Tk.
// Built with -DMXT_BWD_CUT=1 the key-block walk's Philox words are
// replaced by a hash, =2 the fused pass's ds store and dq product and add
// are cut, =3 the walk's exponentials are cut; the results are wrong and
// chip_smoke.py --probe-bwd times the fused pass so beside the full kernel.
//
// f32 inputs take FMA kernels with the same structure (D/16 threads per
// row, 16 columns each) and expf, so f32 stays at f32 accuracy; the fused
// one adds dq with scalar atomics.
#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "hopper.cuh"
#include "philox.cuh"
#include "tma_host.cuh"

#ifndef MXT_BWD_CUT
#define MXT_BWD_CUT 0
#endif

namespace {

using mxt::BM;
using mxt::BN;
using mxt::Half;

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* bias;
  const float* lse;    // (B, H, Tq) f32
  const float* delta;  // (B, H, Tq) f32
  const int* seed;     // (2,) int32 Philox key on the device, or null
  void* dq;            // q's dtype (dq kernel) or f32 accumulator (fused)
  void* dk;
  void* dv;
  float* ds;           // (B, H, Tq, Tk) f32, or null
  int B, H, Tq, Tk, D;
  long long q_sb, q_sh, q_st;
  long long k_sb, k_sh, k_st;
  long long v_sb, v_sh, v_st;
  long long o_sb, o_sh, o_st;  // dout
  long long dq_sb, dq_sh, dq_st;
  long long dk_sb, dk_sh, dk_st;
  long long dv_sb, dv_sh, dv_st;
  long long b_sb, b_sh, b_sq, b_sk;
  float scale;
  int causal;
  int dropout;
  uint32_t drop_threshold;
  float drop_scale;
};

// One score's share of the backward: p_d (for dv) and ds0 = p (dp - delta)
// (unscaled; for dk, dq and the bias gradient).
__device__ __forceinline__ void score_grad(const BwdArgs& a, const float* bp,
                                           float s, float dp, int row, int col,
                                           float lse, float delta, bool keep,
                                           float& pd, float& ds0) {
  float p = 0.f;
  if (row < a.Tq && col < a.Tk && !(a.causal && col > row)) {
    float x = s * a.scale;
    if (bp) x += bp[row * a.b_sq + col * a.b_sk];
    p = expf(x - lse);
  }
  pd = p;
  if (a.dropout) {
    pd = keep ? p * a.drop_scale : 0.f;
    dp = keep ? dp * a.drop_scale : 0.f;
  }
  ds0 = p * (dp - delta);
}

__device__ __forceinline__ float* ds_row(const BwdArgs& a, int b, int h,
                                         int row) {
  return a.ds + ((static_cast<long long>(b) * a.H + h) * a.Tq + row) *
                    static_cast<long long>(a.Tk);
}

// ------------------------------------------- 16-bit kernels (wgmma, TMA)
namespace wg {

constexpr int WG_ROWS = 64;    // rows of a wgmma tile: queries of a dq
                               // warpgroup, keys of a dk / dv warpgroup
constexpr int WG_KEYS = 64;
constexpr int ROW_BYTES = 128; // one swizzled row: 64 16-bit values
constexpr float LOG2E = 1.4426950408889634f;

// TMA descriptors, 4-d (d, t, h, b): q, dout, k, v (loads), dk, dv (stores)
struct Maps {
  CUtensorMap q, o, k, v, dk, dv;
};
// the dq kernel's: q, dout, k, v (loads), dq (store)
struct DqMaps {
  CUtensorMap q, o, k, v, dq;
};

// Shared memory of one block of the key-block walk, in bytes from a
// 1024-byte aligned base: K and V (DP / 64 panels of KEYS rows), the ring
// of Q and dout tiles (DP / 64 panels of BQ rows each), with the dq
// product each consumer warpgroup's ds panel (BQ queries x 64 keys) and
// DQ_BUFS f32 dq staging buffers (BQ rows of DQ_LD), the ring's lse and
// delta rows, the mbarriers. SPLIT (DP = 256): the NC = 2 warpgroups share
// 64 keys and each owns COLS = DP / 2 columns of dk and dv; otherwise each
// owns 64 keys and all DP columns. The dq product's M is the q tile, so
// the fused pass walks tiles of 64 queries; without it the walk takes 32,
// which halves s^T, dp^T and their fragments and leaves dk and dv the
// registers they need (at DP = 128 and 256, 64-row tiles spill ~1.3 KB and
// serialize the wgmma, ptxas C7512).
template <int DP, int NC, int STAGES, bool WITH_DQ>
struct Smem {
  static constexpr bool SPLIT = DP > 128;
  static_assert(!SPLIT || (NC == 2 && !WITH_DQ), "DP = 256: dk, dv only");
  static constexpr int BQ = WITH_DQ ? 64 : 32;
  static constexpr int KEYS = SPLIT ? WG_KEYS : NC * WG_KEYS;
  static constexpr int COLS = SPLIT ? DP / NC : DP;
  static constexpr int PANELS = DP / 64;
  static constexpr int KV_PANEL = KEYS * ROW_BYTES;
  static constexpr int KV_BYTES = PANELS * KV_PANEL;
  static constexpr int Q_PANEL = BQ * ROW_BYTES;
  static constexpr int Q_BYTES = PANELS * Q_PANEL;
  static constexpr int DQ_LD = DP + 8;  // floats from one dq row to the next
  static constexpr int DQ_BYTES = BQ * DQ_LD * 4;
  static constexpr int DQ_BUFS = !WITH_DQ ? 0 : DP == 64 ? 2 : 1;
  static constexpr int K = 0;
  static constexpr int V = K + KV_BYTES;
  static constexpr int Q = V + KV_BYTES;
  static constexpr int O = Q + STAGES * Q_BYTES;
  static constexpr int DS = O + STAGES * Q_BYTES;
  static constexpr int DQ = DS + (WITH_DQ ? NC * Q_PANEL : 0);
  static constexpr int LSE = DQ + NC * DQ_BUFS * DQ_BYTES;
  static constexpr int DELTA = LSE + STAGES * BQ * 4;
  static constexpr int BAR = DELTA + STAGES * BQ * 4;
  static constexpr int BYTES = BAR + (1 + 2 * STAGES) * 8;
  static constexpr int ALLOC = BYTES + 1024;  // room to align the base
};

// The Philox words of this thread's four scores of one 8-query chunk
// (keys ka and kb = ka + 8, queries qc and qc + 1), as w[e] for the
// accumulator's element order (ka, qc), (ka, qc + 1), (kb, qc), (kb, qc + 1).
// Keys are the rows here, so the two lanes holding keys 2i and 2i + 1 (lane
// and lane ^ 4) share a call: the even lane draws the block of its key ka,
// the odd lane that of its kb, and each swaps the two words the other needs.
__device__ __forceinline__ void dropout_chunk(uint32_t* w, uint2 key, int b,
                                              int h, int qc, int ka, int kb,
                                              bool odd) {
#if MXT_BWD_CUT == 1
  const uint4 x = make_uint4(qc * 0x9E3779B9u, ka * 0x85EBCA6Bu,
                             (qc ^ ka) * 0xC2B2AE35u, (qc + kb) * 0x27D4EB2Fu);
#else
  const uint4 x = mxt::dropout_words(key, b, h, qc, odd ? kb : ka);
#endif
  const uint32_t get0 = __shfl_xor_sync(0xffffffffu, odd ? x.x : x.y, 4);
  const uint32_t get1 = __shfl_xor_sync(0xffffffffu, odd ? x.z : x.w, 4);
  w[0] = odd ? get0 : x.x;
  w[1] = odd ? get1 : x.z;
  w[2] = odd ? x.y : get0;
  w[3] = odd ? x.w : get1;
}

template <typename T, int DP, int NC, int STAGES, bool WITH_DQ>
__device__ __forceinline__ void kv_walk(const Maps& maps, const BwdArgs& a) {
  using L = Smem<DP, NC, STAGES, WITH_DQ>;
  constexpr int BQ = L::BQ;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = hop::smem_u32(smem_raw);
  unsigned char* sm = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  uint64_t* full_kv = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* full = full_kv + 1;     // [STAGES]: Q, dout tile, lse, delta
  uint64_t* empty = full + STAGES;  // [STAGES]: the consumer warps done
  float* s_lse = reinterpret_cast<float*>(sm + L::LSE);
  float* s_delta = reinterpret_cast<float*>(sm + L::DELTA);

  const int k0 = blockIdx.x * L::KEYS, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31;
  const long long bh = static_cast<long long>(b) * a.H + h;
  // query tiles above the causal diagonal see none of these keys
  const int iq0 = a.causal ? k0 / BQ : 0;
  const int n_tiles = max(0, (a.Tq + BQ - 1) / BQ - iq0);

  if (tid == 0) {
    hop::mbar_init(full_kv, 1);
    for (int s = 0; s < STAGES; ++s) {
      hop::mbar_init(full + s, 32);
      hop::mbar_init(empty + s, 4 * NC);
    }
    hop::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= NC * 128) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 32;\n" ::: "memory");
    if (tid >= NC * 128 + 32) return;
    const float* lsep = a.lse + bh * a.Tq;
    const float* deltap = a.delta + bh * a.Tq;
    if (lane == 0) {
      hop::mbar_expect(full_kv, 2 * L::KV_BYTES);
      for (int p = 0; p < L::PANELS; ++p) {
        hop::tma_load_4d(sm + L::K + p * L::KV_PANEL, &maps.k, full_kv,
                         p * 64, k0, h, b);
        hop::tma_load_4d(sm + L::V + p * L::KV_PANEL, &maps.v, full_kv,
                         p * 64, k0, h, b);
      }
    }
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % STAGES, q0 = (iq0 + it) * BQ;
      if (it >= STAGES)
        hop::mbar_wait_or_trap(empty + s, ((it / STAGES) + 1) & 1);
      // lse in base-2 units, +inf past Tq (p = 0 there); delta 0 past Tq
      for (int j = lane; j < BQ; j += 32) {
        const int r = q0 + j;
        s_lse[s * BQ + j] = r < a.Tq ? lsep[r] * LOG2E : INFINITY;
        s_delta[s * BQ + j] = r < a.Tq ? deltap[r] : 0.f;
      }
      if (lane != 0) {
        hop::mbar_arrive(full + s);
      } else {
        unsigned char* qt = sm + L::Q + s * L::Q_BYTES;
        unsigned char* ot = sm + L::O + s * L::Q_BYTES;
        hop::mbar_expect(full + s, 2 * L::Q_BYTES);
        for (int p = 0; p < L::PANELS; ++p) {
          hop::tma_load_4d(qt + p * L::Q_PANEL, &maps.q, full + s, p * 64, q0,
                           h, b);
          hop::tma_load_4d(ot + p * L::Q_PANEL, &maps.o, full + s, p * 64, q0,
                           h, b);
        }
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  constexpr int COLS = L::COLS;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, g = lane >> 2, t4 = lane & 3;
  // the warpgroup's keys (its own 64, or the block's 64 when split) and,
  // when split, its half of the columns (panels cp0 ..)
  const int key_off = L::SPLIT ? 0 : wg * WG_KEYS;
  const int cp0 = L::SPLIT ? wg * (COLS / 64) : 0;
  const int kw = k0 + key_off;                     // the warpgroup's first key
  const int ka = kw + warp * 16 + g, kb = ka + 8;  // this thread's keys
  const bool odd = (g & 1) != 0;
  const uint2 key = a.dropout ? mxt::dropout_key(a.seed) : make_uint2(0, 0);
  const float scale2 = a.scale * LOG2E;
  const bool full_bias = a.bias != nullptr && a.b_sq != 0;
  const float* bp = a.bias ? a.bias + b * a.b_sb + h * a.b_sh : nullptr;
  // the key's term of the exponent in base-2 units, read once: the bias of
  // a key-padding row (bias broadcast over Tq), -inf past Tk (p = 0 there)
  float kterm[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kk = i ? kb : ka;
    kterm[i] = kk >= a.Tk ? -INFINITY
               : (bp != nullptr && !full_bias) ? bp[kk * a.b_sk] * LOG2E
                                               : 0.f;
  }
  const uint32_t base = hop::smem_u32(sm);
  const uint32_t k_slice = base + L::K + key_off * ROW_BYTES;
  const uint32_t v_slice = base + L::V + key_off * ROW_BYTES;
  const bool leader = (tid & 127) == 0;

  float dk[COLS / 2], dv[COLS / 2];
#pragma unroll
  for (int i = 0; i < COLS / 2; ++i) dk[i] = dv[i] = 0.f;
  float st[BQ / 2], dpt[BQ / 2];  // s^T, dp^T: rows ka, kb; BQ / 4 queries
#pragma unroll
  for (int i = 0; i < BQ / 2; ++i) st[i] = dpt[i] = 0.f;
  uint32_t pf[BQ / 16][4], df[BQ / 16][4];

  // with the dq product: the ds panel, the staging buffers and the
  // accumulator (dq_stage's padding columns add zeros to the accumulator's)
  [[maybe_unused]] uint32_t ds_panel = 0;
  [[maybe_unused]] float* dq_stage = nullptr;
  [[maybe_unused]] float* dq_base = nullptr;
  // stmatrix: lane l stores row l % 8 of transposed matrix l / 8, i.e. the
  // ds row of query 8 (2 kk + l / 16) + l % 8 at key chunk 2 warp + (l / 8) % 2
  [[maybe_unused]] const int st_row = ((lane >> 4) << 3) + (lane & 7);
  [[maybe_unused]] const int st_chunk = 2 * warp + ((lane >> 3) & 1);
  if constexpr (WITH_DQ) {
    ds_panel = base + L::DS + wg * L::Q_PANEL;
    dq_stage =
        reinterpret_cast<float*>(sm + L::DQ + wg * L::DQ_BUFS * L::DQ_BYTES);
    dq_base = static_cast<float*>(a.dq) + b * a.dq_sb + h * a.dq_sh;
    for (int i = tid & 127; i < L::DQ_BUFS * BQ; i += 128) {
      float4* pad = reinterpret_cast<float4*>(dq_stage + i * L::DQ_LD + DP);
      pad[0] = pad[1] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  hop::mbar_wait_or_trap(full_kv, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES, q0 = (iq0 + it) * BQ;
    const uint32_t q_tile = base + L::Q + s * L::Q_BYTES;
    const uint32_t o_tile = base + L::O + s * L::Q_BYTES;
    const float* lq = s_lse + s * BQ;
    const float* dl = s_delta + s * BQ;
    hop::mbar_wait_or_trap(full + s, (it / STAGES) & 1);

    // s^T = K Q^T and dp^T = V dout^T (K-major operands), a group each
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t off = (kk & 3) * 32;
      hop::wgmma_ss<T, BQ>(
          st, hop::desc_kmajor_sw128(k_slice + (kk >> 2) * L::KV_PANEL + off),
          hop::desc_kmajor_sw128(q_tile + (kk >> 2) * L::Q_PANEL + off),
          kk > 0);
    }
    hop::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t off = (kk & 3) * 32;
      hop::wgmma_ss<T, BQ>(
          dpt, hop::desc_kmajor_sw128(v_slice + (kk >> 2) * L::KV_PANEL + off),
          hop::desc_kmajor_sw128(o_tile + (kk >> 2) * L::Q_PANEL + off),
          kk > 0);
    }
    hop::wgmma_commit();
    hop::wgmma_wait<1>();
    hop::fence_regs(st, BQ / 2);

    // p = 2^(s scale log2(e) + bias - lse), element i: key i & 2 ? kb : ka,
    // query q0 + 8 (i / 4) + 2 t4 + (i & 1); each variant one straight run
    if (!full_bias) {
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(lq + 8 * j + 2 * t4);
        st[4 * j] = fmaf(st[4 * j], scale2, kterm[0]) - l2.x;
        st[4 * j + 1] = fmaf(st[4 * j + 1], scale2, kterm[0]) - l2.y;
        st[4 * j + 2] = fmaf(st[4 * j + 2], scale2, kterm[1]) - l2.x;
        st[4 * j + 3] = fmaf(st[4 * j + 3], scale2, kterm[1]) - l2.y;
      }
    } else {
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        const int r = q0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
        const int kk = (i & 2) ? kb : ka;
        const float bv = r < a.Tq && kk < a.Tk
                             ? bp[r * a.b_sq + kk * a.b_sk] * LOG2E : 0.f;
        st[i] = fmaf(st[i], scale2, kterm[(i >> 1) & 1] + bv) -
                lq[8 * (i >> 2) + 2 * t4 + (i & 1)];
      }
    }
    if (a.causal && q0 < kw + WG_KEYS - 1) {  // the tile crosses the diagonal
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        const int r = q0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
        if (((i & 2) ? kb : ka) > r) st[i] = -INFINITY;
      }
    }
#if MXT_BWD_CUT != 3
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) st[i] = hop::ex2(st[i]);
#endif

    // p_d (dropout) into st, ds0 = p (dp_d - delta) into dpt
    hop::wgmma_wait<0>();
    hop::fence_regs(dpt, BQ / 2);
    if (a.dropout) {
      const uint32_t th = a.drop_threshold;
      const float dsc = a.drop_scale;
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        uint32_t w[4];
        dropout_chunk(w, key, b, h, q0 + 8 * j + 2 * t4, ka, kb, odd);
        const float2 d2 = *reinterpret_cast<const float2*>(dl + 8 * j + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          const bool keep = w[e] >= th;
          const float p = st[i];
          const float dp = keep ? dpt[i] * dsc : 0.f;
          st[i] = keep ? p * dsc : 0.f;
          dpt[i] = p * (dp - ((e & 1) ? d2.y : d2.x));
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const float2 d2 = *reinterpret_cast<const float2*>(dl + 8 * j + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          dpt[i] = st[i] * (dpt[i] - ((e & 1) ? d2.y : d2.x));
        }
      }
    }
    if (WITH_DQ && a.ds != nullptr) {  // the learned bias's gradient, f32
      float* dsp = a.ds + bh * a.Tq * static_cast<long long>(a.Tk);
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        const int r = q0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
        const int kk = (i & 2) ? kb : ka;
        if (r < a.Tq && kk < a.Tk) dsp[r * static_cast<long long>(a.Tk) + kk] = dpt[i];
      }
    }

    // dv += p_d^T dout and dk += (ds0 scale)^T q over the warpgroup's
    // columns: p_d^T and ds^T as the register A operand, dout and Q as the
    // MN-major B operand
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pf[kk][r] = Half<T>::pack(st[8 * kk + 2 * r], st[8 * kk + 2 * r + 1]);
        df[kk][r] = Half<T>::pack(dpt[8 * kk + 2 * r] * a.scale,
                                  dpt[8 * kk + 2 * r + 1] * a.scale);
      }
#if MXT_BWD_CUT != 2
    if constexpr (WITH_DQ) {
      // ds as [query][key] into this warpgroup's swizzled panel: the
      // transposed 8 x 8 blocks of df by stmatrix, the K-major A operand of
      // dq = ds K below (the last product that read the panel is done)
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        const int row = 16 * kk + st_row;
        hop::stmatrix_x4_trans(
            ds_panel + row * ROW_BYTES + ((st_chunk ^ (row & 7)) << 4),
            df[kk]);
      }
    }
#endif
    const uint32_t col_off = cp0 * L::Q_PANEL;
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      hop::wgmma_rs<T, COLS, 1>(
          dv, pf[kk],
          hop::desc_mnmajor_sw128(o_tile + col_off + kk * 16 * ROW_BYTES,
                                  L::Q_PANEL),
          1);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      hop::wgmma_rs<T, COLS, 1>(
          dk, df[kk],
          hop::desc_mnmajor_sw128(q_tile + col_off + kk * 16 * ROW_BYTES,
                                  L::Q_PANEL),
          1);
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(dv, COLS / 2);
    hop::fence_regs(dk, COLS / 2);
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(empty + s);  // Q, dout, lse, delta used

#if MXT_BWD_CUT != 2
    if constexpr (WITH_DQ) {
      // dq of this warpgroup's 64 keys: ds (A, K-major) times its K slice
      // (B, MN-major), once every warp's ds rows are in the panel and the
      // bulk add that last read this tile's staging buffer is done reading
      if (leader) hop::bulk_wait_read<L::DQ_BUFS - 1>();
      hop::fence_async_smem();
      hop::named_sync(1 + wg, 128);
      float acc[DP / 2];
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WG_KEYS / 16; ++kk)
        hop::wgmma_ss<T, DP, 1>(
            acc, hop::desc_kmajor_sw128(ds_panel + kk * 32),
            hop::desc_mnmajor_sw128(k_slice + kk * 16 * ROW_BYTES, L::KV_PANEL),
            kk > 0);
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_regs(acc, DP / 2);
      // through shared memory to one bulk f32 add; the rows of the staging
      // buffer (and of the accumulator) are DQ_LD = DP + 8 floats apart,
      // which puts the 8 rows of a store on different banks
      float* stage = dq_stage + (it % L::DQ_BUFS) * (L::DQ_BYTES / 4);
      const int row = warp * 16 + g;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        *reinterpret_cast<float2*>(stage + row * L::DQ_LD + 8 * j + 2 * t4) =
            make_float2(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<float2*>(stage + (row + 8) * L::DQ_LD + 8 * j +
                                   2 * t4) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
      hop::fence_async_smem();
      hop::named_sync(1 + wg, 128);
      if (leader) {
        hop::bulk_reduce_add_f32(dq_base + q0 * a.dq_st, stage, L::DQ_BYTES);
        hop::bulk_commit();
      }
    }
#endif
  }

  // ------------------------------------------------------------- epilogue
  // dk and dv through the K and V tiles (every read of the rows written is
  // done: the warpgroup's own slice, or with split columns, once both
  // warpgroups are done), in the swizzled layout of the store's tensor
  // map; one thread stores each 64-wide panel
  hop::named_sync(L::SPLIT ? 3 : 1 + wg, L::SPLIT ? NC * 128 : 128);
  const int row = warp * 16 + g;
#pragma unroll
  for (int j = 0; j < COLS / 8; ++j) {
    const int off = (cp0 + (j >> 3)) * L::KV_PANEL + key_off * ROW_BYTES;
    const int chunk = ((j & 7) ^ (row & 7)) * 16 + t4 * 4;
    unsigned char* kp = sm + L::K + off;
    unsigned char* vp = sm + L::V + off;
    *reinterpret_cast<uint32_t*>(kp + row * ROW_BYTES + chunk) =
        Half<T>::pack(dk[4 * j], dk[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(kp + (row + 8) * ROW_BYTES + chunk) =
        Half<T>::pack(dk[4 * j + 2], dk[4 * j + 3]);
    *reinterpret_cast<uint32_t*>(vp + row * ROW_BYTES + chunk) =
        Half<T>::pack(dv[4 * j], dv[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(vp + (row + 8) * ROW_BYTES + chunk) =
        Half<T>::pack(dv[4 * j + 2], dv[4 * j + 3]);
  }
  hop::fence_async_smem();
  hop::named_sync(1 + wg, 128);
  if (leader) {
    if (kw < a.Tk) {
      for (int p = cp0; p < cp0 + COLS / 64; ++p) {
        const int off = p * L::KV_PANEL + key_off * ROW_BYTES;
        hop::tma_store_4d(&maps.dk, sm + L::K + off, p * 64, kw, h, b);
        hop::tma_store_4d(&maps.dv, sm + L::V + off, p * 64, kw, h, b);
      }
    }
    hop::tma_store_commit_and_wait();
    if constexpr (WITH_DQ) hop::bulk_wait<0>();  // every dq add has landed
  }
}

// the fused single pass and the pair's dk, dv: one walk, two names
template <typename T, int DP, int NC, int STAGES>
__global__ void __launch_bounds__((NC + 1) * 128, 1)
    bwd_fused_wg(const __grid_constant__ Maps maps, const BwdArgs a) {
  kv_walk<T, DP, NC, STAGES, true>(maps, a);
}
template <typename T, int DP, int NC, int STAGES>
__global__ void __launch_bounds__((NC + 1) * 128, 1)
    bwd_dkv_wg(const __grid_constant__ Maps maps, const BwdArgs a) {
  kv_walk<T, DP, NC, STAGES, false>(maps, a);
}

// Shared memory of one block of the dq kernel, in bytes from a 1024-byte
// aligned base: Q and dout of the block's ROWS query rows (DP / 64 panels
// each), the ring of K and V tiles (DP / 64 panels of WG_KEYS keys), the
// ring's key terms, the mbarriers.
template <int DP, int NC, int STAGES>
struct DqSmem {
  static constexpr int ROWS = NC * WG_ROWS;
  static constexpr int KEYS = WG_KEYS;
  static constexpr int PANELS = DP / 64;
  static constexpr int Q_PANEL = ROWS * ROW_BYTES;
  static constexpr int Q_BYTES = PANELS * Q_PANEL;
  static constexpr int KV_PANEL = KEYS * ROW_BYTES;
  static constexpr int KV_BYTES = PANELS * KV_PANEL;
  static constexpr int Q = 0;
  static constexpr int O = Q + Q_BYTES;
  static constexpr int K = O + Q_BYTES;
  static constexpr int V = K + STAGES * KV_BYTES;
  static constexpr int KTERM = V + STAGES * KV_BYTES;
  static constexpr int BAR = KTERM + STAGES * KEYS * 4;
  static constexpr int BYTES = BAR + (1 + 2 * STAGES) * 8;
  static constexpr int ALLOC = BYTES + 1024;  // room to align the base
};

template <typename T, int DP, int NC, int STAGES>
__global__ void __launch_bounds__((NC + 1) * 128, 1)
    bwd_dq_wg(const __grid_constant__ DqMaps maps, const BwdArgs a) {
  using L = DqSmem<DP, NC, STAGES>;
  constexpr int KEYS = L::KEYS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = hop::smem_u32(smem_raw);
  unsigned char* sm = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  uint64_t* full_q = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* full = full_q + 1;      // [STAGES]: K, V tile and key terms
  uint64_t* empty = full + STAGES;  // [STAGES]: the consumer warps done
  float* s_kterm = reinterpret_cast<float*>(sm + L::KTERM);

  const int q0 = blockIdx.x * L::ROWS, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31;
  const long long bh = static_cast<long long>(b) * a.H + h;
  int k_end = a.Tk;
  if (a.causal) k_end = min(k_end, q0 + L::ROWS);  // later keys add nothing
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
      for (int p = 0; p < L::PANELS; ++p) {
        hop::tma_load_4d(sm + L::Q + p * L::Q_PANEL, &maps.q, full_q, p * 64,
                         q0, h, b);
        hop::tma_load_4d(sm + L::O + p * L::Q_PANEL, &maps.o, full_q, p * 64,
                         q0, h, b);
      }
    }
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % STAGES, k0 = it * KEYS;
      if (it >= STAGES)
        hop::mbar_wait_or_trap(empty + s, ((it / STAGES) + 1) & 1);
      // each key's term of the exponent in base-2 units: the key-padding
      // bias (bias broadcast over Tq), -inf past Tk (p = 0 there)
      for (int j = lane; j < KEYS; j += 32) {
        const int col = k0 + j;
        s_kterm[s * KEYS + j] = col >= a.Tk ? -INFINITY
                                : bp != nullptr ? bp[col * a.b_sk] * LOG2E
                                                : 0.f;
      }
      if (lane != 0) {
        hop::mbar_arrive(full + s);
      } else {
        unsigned char* kt = sm + L::K + s * L::KV_BYTES;
        unsigned char* vt = sm + L::V + s * L::KV_BYTES;
        hop::mbar_expect(full + s, 2 * L::KV_BYTES);
        for (int p = 0; p < L::PANELS; ++p) {
          hop::tma_load_4d(kt + p * L::KV_PANEL, &maps.k, full + s, p * 64,
                           k0, h, b);
          hop::tma_load_4d(vt + p * L::KV_PANEL, &maps.v, full + s, p * 64,
                           k0, h, b);
        }
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  if constexpr (NC > 1)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = tid >> 7, warp = (tid >> 5) & 3, g = lane >> 2, t4 = lane & 3;
  const int r0 = q0 + wg * WG_ROWS;  // the warpgroup's first row
  const int ra = r0 + warp * 16 + g, rb = ra + 8;  // this thread's rows
  const bool odd = (g & 1) != 0;
  const uint2 key = a.dropout ? mxt::dropout_key(a.seed) : make_uint2(0, 0);
  const float scale2 = a.scale * LOG2E;
  const bool full_bias = a.bias != nullptr && a.b_sq != 0;
  const float* bp = a.bias ? a.bias + b * a.b_sb + h * a.b_sh : nullptr;
  // the rows' lse in base-2 units (+inf past Tq: p = 0 there) and delta
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = i ? rb : ra;
    lse2[i] = r < a.Tq ? a.lse[bh * a.Tq + r] * LOG2E : INFINITY;
    dl[i] = r < a.Tq ? a.delta[bh * a.Tq + r] : 0.f;
  }
  const uint32_t base = hop::smem_u32(sm);
  const uint32_t q_base = base + L::Q + wg * WG_ROWS * ROW_BYTES;
  const uint32_t o_base = base + L::O + wg * WG_ROWS * ROW_BYTES;
  float* dsp = a.ds != nullptr
                   ? a.ds + bh * a.Tq * static_cast<long long>(a.Tk)
                   : nullptr;

  float dq[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;
  float sc[KEYS / 2], dp[KEYS / 2];  // s, dp: rows ra, rb; KEYS / 4 keys
#pragma unroll
  for (int i = 0; i < KEYS / 2; ++i) sc[i] = dp[i] = 0.f;
  uint32_t pf[KEYS / 16][4];  // ds, the A operand of dq += ds K

  hop::mbar_wait_or_trap(full_q, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES, k0 = it * KEYS;
    const uint32_t k_tile = base + L::K + s * L::KV_BYTES;
    const uint32_t v_tile = base + L::V + s * L::KV_BYTES;
    const float* kt = s_kterm + s * KEYS;
    hop::mbar_wait_or_trap(full + s, (it / STAGES) & 1);
    // under the causal mask a tile past this warpgroup's last row adds
    // nothing (the other warpgroup's rows may need it)
    if (!a.causal || k0 < r0 + WG_ROWS) {
      // s = Q K^T and dp = dout V^T (K-major operands), a group each
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk & 3) * 32;
        hop::wgmma_ss<T, KEYS>(
            sc, hop::desc_kmajor_sw128(q_base + (kk >> 2) * L::Q_PANEL + off),
            hop::desc_kmajor_sw128(k_tile + (kk >> 2) * L::KV_PANEL + off),
            kk > 0);
      }
      hop::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk & 3) * 32;
        hop::wgmma_ss<T, KEYS>(
            dp, hop::desc_kmajor_sw128(o_base + (kk >> 2) * L::Q_PANEL + off),
            hop::desc_kmajor_sw128(v_tile + (kk >> 2) * L::KV_PANEL + off),
            kk > 0);
      }
      hop::wgmma_commit();
      hop::wgmma_wait<1>();
      hop::fence_regs(sc, KEYS / 2);

      // p = 2^(s scale log2(e) + key term + bias - lse), element i: row
      // i & 2 ? rb : ra, key k0 + 8 (i / 4) + 2 t4 + (i & 1); each variant
      // one straight run
      if (!full_bias) {
#pragma unroll
        for (int j = 0; j < KEYS / 8; ++j) {
          const float2 k2 =
              *reinterpret_cast<const float2*>(kt + 8 * j + 2 * t4);
          sc[4 * j] = fmaf(sc[4 * j], scale2, k2.x) - lse2[0];
          sc[4 * j + 1] = fmaf(sc[4 * j + 1], scale2, k2.y) - lse2[0];
          sc[4 * j + 2] = fmaf(sc[4 * j + 2], scale2, k2.x) - lse2[1];
          sc[4 * j + 3] = fmaf(sc[4 * j + 3], scale2, k2.y) - lse2[1];
        }
      } else {
#pragma unroll
        for (int i = 0; i < KEYS / 2; ++i) {
          const int r = (i & 2) ? rb : ra;
          const int cl = 8 * (i >> 2) + 2 * t4 + (i & 1), col = k0 + cl;
          const float bv = r < a.Tq && col < a.Tk
                               ? bp[r * a.b_sq + col * a.b_sk] * LOG2E : 0.f;
          sc[i] = fmaf(sc[i], scale2, kt[cl] + bv) - lse2[(i >> 1) & 1];
        }
      }
      if (a.causal && k0 + KEYS - 1 > r0) {  // the tile crosses the diagonal
#pragma unroll
        for (int i = 0; i < KEYS / 2; ++i) {
          const int r = (i & 2) ? rb : ra;
          if (k0 + 8 * (i >> 2) + 2 * t4 + (i & 1) > r) sc[i] = -INFINITY;
        }
      }
#pragma unroll
      for (int i = 0; i < KEYS / 2; ++i) sc[i] = hop::ex2(sc[i]);

      // ds0 = p (dp_d - delta) into dp, the dropout mask drawn as the
      // forward draws it (the rows are queries)
      hop::wgmma_wait<0>();
      hop::fence_regs(dp, KEYS / 2);
      if (a.dropout) {
        const uint32_t th = a.drop_threshold;
        const float dsc = a.drop_scale;
#pragma unroll
        for (int j = 0; j < KEYS / 8; ++j) {
          uint32_t w[4];
          mxt::dropout_row_pair(w, key, b, h, ra, rb, k0 + 8 * j + 2 * t4,
                                odd);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e;
            const float dpd = w[e] >= th ? dp[i] * dsc : 0.f;
            dp[i] = sc[i] * (dpd - dl[e >> 1]);
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < KEYS / 2; ++i)
          dp[i] = sc[i] * (dp[i] - dl[(i >> 1) & 1]);
      }
      if (dsp != nullptr) {  // the learned bias's gradient, f32
#pragma unroll
        for (int i = 0; i < KEYS / 2; ++i) {
          const int r = (i & 2) ? rb : ra;
          const int col = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
          if (r < a.Tq && col < a.Tk)
            dsp[r * static_cast<long long>(a.Tk) + col] = dp[i];
        }
      }

      // dq += ds K: ds packed to 16 bits as the register A operand (the
      // accumulator's layout is the A fragment's), K as the MN-major B
#pragma unroll
      for (int kk = 0; kk < KEYS / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pf[kk][r] = Half<T>::pack(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KEYS / 16; ++kk)
        hop::wgmma_rs<T, DP, 1>(
            dq, pf[kk],
            hop::desc_mnmajor_sw128(k_tile + kk * 16 * ROW_BYTES, L::KV_PANEL),
            1);
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_regs(dq, DP / 2);
    }
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(empty + s);  // K, V, key terms used
  }

  // ------------------------------------------------------------- epilogue
  // dq * scale through this warpgroup's Q slice (its last read of it is
  // done), in the swizzled layout of the store's tensor map; one thread
  // stores each 64-wide panel, rows past Tq clipped
  hop::named_sync(1 + wg, 128);
  unsigned char* os = sm + L::Q + wg * WG_ROWS * ROW_BYTES;
  const int row = warp * 16 + g;
  const float sc_out = a.scale;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    unsigned char* panel = os + (j >> 3) * L::Q_PANEL;
    const int chunk = ((j & 7) ^ (row & 7)) * 16 + t4 * 4;
    *reinterpret_cast<uint32_t*>(panel + row * ROW_BYTES + chunk) =
        Half<T>::pack(dq[4 * j] * sc_out, dq[4 * j + 1] * sc_out);
    *reinterpret_cast<uint32_t*>(panel + (row + 8) * ROW_BYTES + chunk) =
        Half<T>::pack(dq[4 * j + 2] * sc_out, dq[4 * j + 3] * sc_out);
  }
  hop::fence_async_smem();
  hop::named_sync(1 + wg, 128);
  if ((tid & 127) == 0 && r0 < a.Tq) {
    for (int p = 0; p < L::PANELS; ++p)
      hop::tma_store_4d(&maps.dq, os + p * L::Q_PANEL, p * 64, r0, h, b);
    hop::tma_store_commit_and_wait();
  }
}

}  // namespace wg

// ------------------------------------------------------------ dq (f32, FMA)
// DP / 16 threads per query row, 16 head columns each; K and V tiles in
// shared memory; one key at a time.
template <int DP>
__global__ void __launch_bounds__(BM * DP / 16) bwd_dq_f32(BwdArgs a) {
  constexpr int TPR = DP / 16, HD = 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);  // [BN][DP]
  float* sV = sK + BN * DP;

  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, part = tid % TPR;
  const int r = q0 + tid / TPR, d0 = part * HD;
  const uint2 key = a.dropout ? mxt::dropout_key(a.seed) : make_uint2(0, 0);

  const float* qp = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kp = static_cast<const float*>(a.k) + b * a.k_sb + h * a.k_sh;
  const float* vp = static_cast<const float*>(a.v) + b * a.v_sb + h * a.v_sh;
  const float* op = static_cast<const float*>(a.dout) + b * a.o_sb + h * a.o_sh;
  const float* bp = a.bias ? a.bias + b * a.b_sb + h * a.b_sh : nullptr;
  const long long bh = static_cast<long long>(b) * a.H + h;

  float qr[HD], orow[HD], acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    const bool in = r < a.Tq && d0 + d < a.D;
    qr[d] = in ? qp[r * a.q_st + d0 + d] : 0.f;
    orow[d] = in ? op[r * a.o_st + d0 + d] : 0.f;
    acc[d] = 0.f;
  }
  const float lse = r < a.Tq ? a.lse[bh * a.Tq + r] : 0.f;
  const float delta = r < a.Tq ? a.delta[bh * a.Tq + r] : 0.f;

  int k_end = a.Tk;
  if (a.causal) k_end = min(k_end, q0 + BM);
  for (int k0 = 0; k0 < k_end; k0 += BN) {
    __syncthreads();
    for (int i = tid; i < BN * DP; i += blockDim.x) {
      const int kr = i / DP, c = i % DP;
      const bool in = k0 + kr < a.Tk && c < a.D;
      sK[i] = in ? kp[(k0 + kr) * a.k_st + c] : 0.f;
      sV[i] = in ? vp[(k0 + kr) * a.v_st + c] : 0.f;
    }
    __syncthreads();
    const int n = min(BN, a.Tk - k0);
    for (int j = 0; j < n; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        s += qr[d] * sK[j * DP + d0 + d];
        dp += orow[d] * sV[j * DP + d0 + d];
      }
#pragma unroll
      for (int off = 1; off < TPR; off <<= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
        dp += __shfl_xor_sync(0xffffffffu, dp, off);
      }
      const int col = k0 + j;
      const bool keep =
          !a.dropout || mxt::dropout_keep(key, b, h, r, col, a.drop_threshold);
      float pd, ds0;
      score_grad(a, bp, s, dp, r, col, lse, delta, keep, pd, ds0);
      if (a.ds && part == 0 && r < a.Tq) ds_row(a, b, h, r)[col] = ds0;
      const float dsc = ds0 * a.scale;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] += dsc * sK[j * DP + d0 + d];
    }
  }
  if (r < a.Tq) {
    float* dqp = static_cast<float*>(a.dq) + b * a.dq_sb + h * a.dq_sh;
#pragma unroll
    for (int d = 0; d < HD; ++d)
      if (d0 + d < a.D) dqp[r * a.dq_st + d0 + d] = acc[d];
  }
}

// ---------------------------------------------- dk, dv (+ dq) (f32, FMA)
template <int DP, bool FUSED>
__global__ void __launch_bounds__(BN * DP / 16) bwd_dkv_f32(BwdArgs a) {
  constexpr int TPR = DP / 16, HD = 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);  // [BM][DP]
  float* sO = sQ + BM * DP;                        // [BM][DP]
  float* sL = sO + BM * DP;                        // [BM]
  float* sD = sL + BM;                             // [BM]
  float* sK = sD + BM;                             // [BN][DP], fused only
  float* sS = sK + (FUSED ? BN * DP : 0);          // [BM][BN], fused only

  const int k0 = blockIdx.x * BN, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, part = tid % TPR, kl = tid / TPR;
  const int kc = k0 + kl, d0 = part * HD;
  const uint2 key = a.dropout ? mxt::dropout_key(a.seed) : make_uint2(0, 0);

  const float* qp = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kp = static_cast<const float*>(a.k) + b * a.k_sb + h * a.k_sh;
  const float* vp = static_cast<const float*>(a.v) + b * a.v_sb + h * a.v_sh;
  const float* op = static_cast<const float*>(a.dout) + b * a.o_sb + h * a.o_sh;
  const float* bp = a.bias ? a.bias + b * a.b_sb + h * a.b_sh : nullptr;
  const long long bh = static_cast<long long>(b) * a.H + h;

  float kr[HD], vr[HD], dk[HD], dv[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    const bool in = kc < a.Tk && d0 + d < a.D;
    kr[d] = in ? kp[kc * a.k_st + d0 + d] : 0.f;
    vr[d] = in ? vp[kc * a.v_st + d0 + d] : 0.f;
    dk[d] = dv[d] = 0.f;
  }
  if (FUSED) {
    for (int i = tid; i < BN * DP; i += blockDim.x) {
      const int r = i / DP, c = i % DP;
      sK[i] = (k0 + r < a.Tk && c < a.D) ? kp[(k0 + r) * a.k_st + c] : 0.f;
    }
  }

  const int iq0 = a.causal ? k0 / BM : 0;
  for (int q0 = iq0 * BM; q0 < a.Tq; q0 += BM) {
    __syncthreads();
    for (int i = tid; i < BM * DP; i += blockDim.x) {
      const int r = i / DP, c = i % DP;
      const bool in = q0 + r < a.Tq && c < a.D;
      sQ[i] = in ? qp[(q0 + r) * a.q_st + c] : 0.f;
      sO[i] = in ? op[(q0 + r) * a.o_st + c] : 0.f;
    }
    for (int i = tid; i < BM; i += blockDim.x) {
      const bool in = q0 + i < a.Tq;
      sL[i] = in ? a.lse[bh * a.Tq + q0 + i] : 0.f;
      sD[i] = in ? a.delta[bh * a.Tq + q0 + i] : 0.f;
    }
    __syncthreads();
    const int n = min(BM, a.Tq - q0);
    for (int j = 0; j < n; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        s += kr[d] * sQ[j * DP + d0 + d];
        dp += vr[d] * sO[j * DP + d0 + d];
      }
#pragma unroll
      for (int off = 1; off < TPR; off <<= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
        dp += __shfl_xor_sync(0xffffffffu, dp, off);
      }
      const int qr = q0 + j;
      const bool keep =
          !a.dropout || mxt::dropout_keep(key, b, h, qr, kc, a.drop_threshold);
      float pd, ds0;
      score_grad(a, bp, s, dp, qr, kc, sL[j], sD[j], keep, pd, ds0);
      const float dsc = ds0 * a.scale;
      if (FUSED && part == 0) {
        sS[j * BN + kl] = dsc;
        if (a.ds && kc < a.Tk) ds_row(a, b, h, qr)[kc] = ds0;
      }
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        dv[d] += pd * sO[j * DP + d0 + d];
        dk[d] += dsc * sQ[j * DP + d0 + d];
      }
    }
    if (FUSED) {
      __syncthreads();
      // thread (row kl, part) adds ds[kl, :] k[:, d0:d0+16] into dq
      if (kl < n) {
        float c[HD];
#pragma unroll
        for (int d = 0; d < HD; ++d) c[d] = 0.f;
        for (int j = 0; j < BN; ++j) {
          const float x = sS[kl * BN + j];
#pragma unroll
          for (int d = 0; d < HD; ++d) c[d] += x * sK[j * DP + d0 + d];
        }
        float* dqp = static_cast<float*>(a.dq) + b * a.dq_sb + h * a.dq_sh +
                     (q0 + kl) * a.dq_st;
#pragma unroll
        for (int d = 0; d < HD; ++d)
          if (d0 + d < a.D) atomicAdd(dqp + d0 + d, c[d]);
      }
    }
  }
  if (kc < a.Tk) {
    float* dkp = static_cast<float*>(a.dk) + b * a.dk_sb + h * a.dk_sh;
    float* dvp = static_cast<float*>(a.dv) + b * a.dv_sb + h * a.dv_sh;
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      if (d0 + d < a.D) {
        dkp[kc * a.dk_st + d0 + d] = dk[d];
        dvp[kc * a.dv_st + d0 + d] = dv[d];
      }
    }
  }
}

// ------------------------------------------------------------------ launch
enum Kind { FUSED = 0, DQ = 1, DKV = 2 };

template <typename K, typename... Args>
cudaError_t launch(K kern, dim3 grid, int threads, size_t smem,
                   cudaStream_t stream, const Args&... args) {
  cudaError_t e = mxt::set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// The key-block walk: the fused pass (WITH_DQ) or the pair's dk, dv
template <typename T, int DP, int STAGES, bool WITH_DQ>
cudaError_t launch_kv(const BwdArgs& a, const wg::Maps& maps,
                      cudaStream_t stream) {
  using L = wg::Smem<DP, 2, STAGES, WITH_DQ>;
  dim3 grid((a.Tk + L::KEYS - 1) / L::KEYS, a.H, a.B);
  if constexpr (WITH_DQ)
    return launch(wg::bwd_fused_wg<T, DP, 2, STAGES>, grid, 3 * 128, L::ALLOC,
                  stream, maps, a);
  else
    return launch(wg::bwd_dkv_wg<T, DP, 2, STAGES>, grid, 3 * 128,
                  L::ALLOC, stream, maps, a);
}

// The fused single pass (D <= 128, dq added into the f32 accumulator
// (B, H, Tq rounded up to 64, DP + 8), contiguous, DP = 64 or 128) or the
// pair's dk, dv (D <= 256): q, dout, k, v read and dk, dv written by TMA
// (the caller passes views TMA can address).
template <typename T>
cudaError_t dispatch_kv(int kind, const BwdArgs& a, cudaStream_t st) {
  const bool fused = kind == FUSED;
  if (fused) {
    if (a.D > 128) return cudaErrorInvalidValue;
    const int ld = (a.D <= 64 ? 64 : 128) + 8;
    const long long rows = (a.Tq + wg::WG_ROWS - 1) / wg::WG_ROWS * wg::WG_ROWS;
    if (a.dq_st != ld || a.dq_sh != rows * ld || a.dq_sb != a.H * rows * ld)
      return cudaErrorInvalidValue;
  }
  const CUtensorMapDataType type = mxt::TmaType<T>::value;
  const int keys = a.D <= 128 ? 2 * wg::WG_KEYS : wg::WG_KEYS;
  const int bq = fused ? 64 : 32;                      // q rows a tile
  wg::Maps maps;
  if (!mxt::make_map(&maps.q, type, a.q, a.D, a.Tq, a.H, a.B, a.q_st,
                     a.q_sh, a.q_sb, bq) ||
      !mxt::make_map(&maps.o, type, a.dout, a.D, a.Tq, a.H, a.B, a.o_st,
                     a.o_sh, a.o_sb, bq) ||
      !mxt::make_map(&maps.k, type, a.k, a.D, a.Tk, a.H, a.B, a.k_st,
                     a.k_sh, a.k_sb, keys) ||
      !mxt::make_map(&maps.v, type, a.v, a.D, a.Tk, a.H, a.B, a.v_st,
                     a.v_sh, a.v_sb, keys) ||
      !mxt::make_map(&maps.dk, type, a.dk, a.D, a.Tk, a.H, a.B, a.dk_st,
                     a.dk_sh, a.dk_sb, wg::WG_KEYS) ||
      !mxt::make_map(&maps.dv, type, a.dv, a.D, a.Tk, a.H, a.B, a.dv_st,
                     a.dv_sh, a.dv_sb, wg::WG_KEYS))
    return cudaErrorInvalidValue;
  if (fused) {
    if (a.D <= 64) return launch_kv<T, 64, 3, true>(a, maps, st);
    return launch_kv<T, 128, 2, true>(a, maps, st);
  }
  if (a.D <= 64) return launch_kv<T, 64, 4, false>(a, maps, st);
  if (a.D <= 128) return launch_kv<T, 128, 4, false>(a, maps, st);
  return launch_kv<T, 256, 4, false>(a, maps, st);
}

template <typename T, int DP, int NC, int STAGES>
cudaError_t launch_dq(const BwdArgs& a, const wg::DqMaps& maps,
                      cudaStream_t stream) {
  using L = wg::DqSmem<DP, NC, STAGES>;
  dim3 grid((a.Tq + L::ROWS - 1) / L::ROWS, a.H, a.B);
  return launch(wg::bwd_dq_wg<T, DP, NC, STAGES>, grid, (NC + 1) * 128,
                L::ALLOC, stream, maps, a);
}

// The pair's dq (D <= 256): q, dout, k, v read and dq written by TMA.
template <typename T>
cudaError_t dispatch_dq(const BwdArgs& a, cudaStream_t st) {
  const CUtensorMapDataType type = mxt::TmaType<T>::value;
  const int rows = (a.D <= 128 ? 2 : 1) * wg::WG_ROWS;  // query rows a block
  wg::DqMaps maps;
  if (!mxt::make_map(&maps.q, type, a.q, a.D, a.Tq, a.H, a.B, a.q_st,
                     a.q_sh, a.q_sb, rows) ||
      !mxt::make_map(&maps.o, type, a.dout, a.D, a.Tq, a.H, a.B, a.o_st,
                     a.o_sh, a.o_sb, rows) ||
      !mxt::make_map(&maps.k, type, a.k, a.D, a.Tk, a.H, a.B, a.k_st,
                     a.k_sh, a.k_sb, wg::WG_KEYS) ||
      !mxt::make_map(&maps.v, type, a.v, a.D, a.Tk, a.H, a.B, a.v_st,
                     a.v_sh, a.v_sb, wg::WG_KEYS) ||
      !mxt::make_map(&maps.dq, type, a.dq, a.D, a.Tq, a.H, a.B, a.dq_st,
                     a.dq_sh, a.dq_sb, wg::WG_ROWS))
    return cudaErrorInvalidValue;
  if (a.D <= 64) return launch_dq<T, 64, 2, 4>(a, maps, st);
  if (a.D <= 128) return launch_dq<T, 128, 2, 3>(a, maps, st);
  return launch_dq<T, 256, 1, 2>(a, maps, st);
}

template <int DP>
cudaError_t launch_f32(int kind, const BwdArgs& a, cudaStream_t st) {
  constexpr int threads = BM * DP / 16;
  if (kind == DQ) {
    dim3 grid((a.Tq + BM - 1) / BM, a.H, a.B);
    return launch(bwd_dq_f32<DP>, grid, threads, 2 * BN * DP * sizeof(float),
                  st, a);
  }
  dim3 grid((a.Tk + BN - 1) / BN, a.H, a.B);
  const size_t base = (2 * BM * DP + 2 * BM) * sizeof(float);
  if (kind == FUSED) {
    if constexpr (DP > 128) return cudaErrorInvalidValue;  // the pair only
    else
      return launch(bwd_dkv_f32<DP, true>, grid, threads,
                    base + (BN * DP + BM * BN) * sizeof(float), st, a);
  }
  return launch(bwd_dkv_f32<DP, false>, grid, threads, base, st, a);
}

template <typename T>
cudaError_t dispatch_half(int kind, const BwdArgs& a, cudaStream_t st) {
  return kind == DQ ? dispatch_dq<T>(a, st) : dispatch_kv<T>(kind, a, st);
}

}  // namespace

// kind: 0 = fused single pass (dq into an f32 accumulator that the caller
// zeroes, dk, dv; D <= 128), 1 = dq of the two-pass pair (dq in q's dtype),
// 2 = dk, dv of the two-pass pair. dtype: 0 = float32, 1 = bfloat16, 2 =
// float16. strides (in elements): q, k, v, dout, dq, dk, dv as (b, h, t)
// each, then bias (b, h, q, k); the head dimension has unit stride
// everywhere. For 16-bit data q, k, v, dout and the 16-bit outputs (dk, dv;
// dq of kind 1) must be views TMA can address (16-byte aligned, strides of
// dimensions longer than 1 multiples of 8; the Python wrapper copies other
// operands), and dq of kind 0 the contiguous (B, H, Tq rounded up to 64,
// DP + 8) accumulator, DP = 64 for D <= 64, else 128. lse and delta are
// (B, H, Tq) contiguous f32. bias is f32 or null.
// ds, when not null, is a zeroed (B, H, Tq, Tk) f32 buffer that kernels 0
// and 1 fill with p * (dp - delta). seed/dropout/drop_threshold/drop_scale
// as in mxt_flash_attention_fwd. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments the kernels do not take.
extern "C" int mxt_flash_attention_bwd(
    int kind, int dtype, const void* q, const void* k, const void* v,
    const void* dout, const float* bias, const float* lse, const float* delta,
    void* dq, void* dk, void* dv, float* ds, int B, int H, int Tq, int Tk,
    int D, const long long* strides, float scale, int causal,
    const int* seed, int dropout, unsigned int drop_threshold,
    float drop_scale, void* stream) {
  if (D < 1 || D > 256 || B < 1 || H < 1 || Tq < 1 || Tk < 1 || B > 65535 ||
      H > 65535 || kind < 0 || kind > 2 || (dropout && !seed))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a;
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.bias = bias; a.lse = lse;
  a.delta = delta; a.seed = seed; a.dq = dq; a.dk = dk; a.dv = dv; a.ds = ds;
  a.B = B; a.H = H; a.Tq = Tq; a.Tk = Tk; a.D = D;
  long long* dst[25] = {&a.q_sb,  &a.q_sh,  &a.q_st,  &a.k_sb,  &a.k_sh,
                        &a.k_st,  &a.v_sb,  &a.v_sh,  &a.v_st,  &a.o_sb,
                        &a.o_sh,  &a.o_st,  &a.dq_sb, &a.dq_sh, &a.dq_st,
                        &a.dk_sb, &a.dk_sh, &a.dk_st, &a.dv_sb, &a.dv_sh,
                        &a.dv_st, &a.b_sb,  &a.b_sh,  &a.b_sq,  &a.b_sk};
  for (int i = 0; i < 25; ++i) *dst[i] = strides[i];
  a.scale = scale; a.causal = causal;
  a.dropout = dropout != 0;
  a.drop_threshold = drop_threshold; a.drop_scale = drop_scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      if (D <= 32) return static_cast<int>(launch_f32<32>(kind, a, st));
      if (D <= 64) return static_cast<int>(launch_f32<64>(kind, a, st));
      if (D <= 128) return static_cast<int>(launch_f32<128>(kind, a, st));
      return static_cast<int>(launch_f32<256>(kind, a, st));
    case 1:
      return static_cast<int>(dispatch_half<__nv_bfloat16>(kind, a, st));
    case 2:
      return static_cast<int>(dispatch_half<__half>(kind, a, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
