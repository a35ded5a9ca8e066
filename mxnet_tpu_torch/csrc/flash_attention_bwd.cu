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
// f32 inputs, on 3xTF32 wgmma (f32-accurate products on the tensor cores
// whatever torch.backends.cuda.matmul.allow_tf32 says; the sections
// below): the fused pass is tf::bwd_fused_tf32, the key-block walk, and
// the pair's dk, dv the same walk without dq (tf::bwd_dkv_tf32, D <= 128)
// or, at every D above 128, the walk streaming the head dim with dk and dv
// split across blocks (tf::bwd_dkv_tf32_st). The pair's f32 dq is
// flash_attention_wide_wg.cu's wide_dq_tf32 at every D.
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

// ------------------------------------ f32 fused pass (3xTF32 on wgmma, TMA)
// f32 q, k, v at D <= 128 (kind FUSED, and kind DKV without the dq^T
// product: bwd_dkv_tf32): the key-block walk above carried to f32 on the
// tensor cores. wgmma reads f32 only as TF32 (10 mantissa bits),
// and only K-major, so every operand is split into TF32 halves, x = hi + lo
// (hopper.cuh), and every product taken as hi hi' + hi lo' + lo hi'
// (3xTF32): an f32-accurate product (about 2^-21 relative), not a TF32
// one, whatever torch.backends.cuda.matmul.allow_tf32 says. A block owns
// 64 keys of one (batch, head) and walks their q tiles of 32 rows; one
// consumer warpgroup, one producer warp and three splitter warps (256
// threads, 255 registers a thread). The head dim is padded to DP in {32,
// 64, 96, 128}, DP / 32 panels of 32 f32 columns (one 128-byte swizzled
// row; TMA zero-fills past D). A register A operand can be split in
// registers; a shared-memory B operand needs its halves in shared memory.
// Per q tile, all five products on m64n32k8 TF32 wgmmas:
//  - s^T = K q^T and dp^T = V dout^T: K and V (raw, resident) split in the
//    consumer's registers, a panel at a time, as the A operand; q and dout
//    (hi in place of the TMA copy, lo beside it) as the K-major B;
//  - dv += p_d^T dout and dk += (ds scale)^T q: p_d^T and ds^T, the s^T and
//    dp^T accumulators, split in registers as the A operand; dout^T and
//    q^T as the B, which the splitter warps write transposed (a row a
//    column of the head dim, its 32 queries one 128-byte row, each 8-query
//    group in the order the accumulator's fragment takes them,
//    hop::tf32_key_pos), as the f32 wide forward writes V^T;
//  - dq^T = K^T (ds scale)^T, a 64-row M of the head dim at a time: K^T
//    read from raw K in registers as the A operand; ds as [query][key]
//    (hi, lo), written by the consumer, as the K-major B. dq^T leaves
//    through a staging buffer, transposed to [query][d], by one bulk f32
//    reduce-add a tile into the caller's zeroed accumulator (B, H, Tq
//    rounded up to 64, DP' + 8), DP' = 64 for D <= 64, else 128 (the 16-bit
//    pass's layout); the order of the key blocks' adds varies, so dq agrees
//    from run to run to rounding, dk and dv to the bit.
// Shared memory (227 KB a block): K and V raw (2 DP 256 bytes: 32 KB at
// DP = 64), a ring stage of q, dout, q^T, dout^T, hi and lo each (8 DP 128
// bytes: 64 KB), ds hi and lo (16 KB), the dq staging buffer (32 rows of
// DP' + 8 floats: 9 KB at DP' = 64), lse and delta rows: 4 stages at DP =
// 32, 2 at 64, 1 at 96 and 128 (TfSmem); without dq, 4 at 32, 3 at 64.
// Bound: operations, its five products (10 T^2 D flops a (batch, head),
// each as three TF32 ones). On an H100 it takes about 4 times that bound:
// the one consumer warpgroup issues each product group, waits for it and
// only then computes what the next one reads (cut builds, PERF.md section
// 6).
namespace tf {

constexpr int KEYS = 64;                 // keys a block: M of s^T, dk, dv
constexpr int BQ = 32;                   // queries a q tile
constexpr int ROW = 128;                 // one swizzled row: 32 f32
constexpr int PANEL_Q = BQ * ROW;        // 32 columns of a q tile
constexpr int PANEL_K = KEYS * ROW;      // ... of the key block
constexpr int SPLIT = 96;                // splitter threads: warps 5-7
constexpr int THREADS = 256;
constexpr int SMEM_LIMIT = 232448;       // bytes a block may use
constexpr float LOG2E = 1.4426950408889634f;

constexpr int imin(int x, int y) { return x < y ? x : y; }

struct Maps {
  CUtensorMap q, o, k, v;
};

// Shared memory from a 1024-byte aligned base: K, V (raw, NP panels of 64
// keys), ds [query][key] hi and lo (2 panels of 32 keys each), the dq
// staging buffer, the ring (a stage: q at Q, dout at O, each as hi, lo,
// transposed hi, transposed lo, T bytes apart), lse and delta rows a stage,
// the mbarriers: K and V's, then full (copied), ready (split), empty (used)
// a stage.
template <int DP, bool WITH_DQ>
struct TfSmem {
  static constexpr int NP = DP / 32;
  static constexpr int ACC_LD = (DP <= 64 ? 64 : 128) + 8;  // dq_accumulator
  static constexpr int T = NP * PANEL_Q;  // one quarter of q's share
  static constexpr int STAGE = 8 * T;
  static constexpr int K = 0;
  static constexpr int V = K + NP * PANEL_K;
  static constexpr int DS = V + NP * PANEL_K;
  static constexpr int DS_LO = 2 * PANEL_Q;
  static constexpr int DQ = DS + (WITH_DQ ? 2 * DS_LO : 0);
  static constexpr int RING = DQ + (WITH_DQ ? BQ * ACC_LD * 4 : 0);
  static constexpr int Q = 0, O = 4 * T;  // in a stage
  static constexpr int PER = STAGE + 2 * BQ * 4 + 3 * 8;
  static constexpr int STAGES =
      imin(4, (SMEM_LIMIT - 1024 - 8 - RING) / PER);
  static constexpr int LSE = RING + STAGES * STAGE;
  static constexpr int DELTA = LSE + STAGES * BQ * 4;
  static constexpr int BAR = DELTA + STAGES * BQ * 4;
  static constexpr int ALLOC = BAR + (1 + 3 * STAGES) * 8 + 1024;
  static_assert(RING % 1024 == 0 && STAGES >= 1 && ALLOC <= SMEM_LIMIT,
                "shared memory");
};

// One q or dout tile (NP panels of 32 rows, as TMA wrote them at x) split
// by splitter t: hi in place, lo T bytes on, and transposed (row c: column
// c, its 32 rows at hop::tf32_key_pos) as hi at 2 T, lo at 3 T. A warp
// takes one 16-byte chunk of the 32 rows, so that each transposed store
// fills one row across 32 banks.
template <int NP>
__device__ __forceinline__ void split_tile(unsigned char* x, int t) {
  constexpr int T = NP * PANEL_Q;
  constexpr int PER = (NP * 256 + SPLIT - 1) / SPLIT;  // float4s a splitter
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int i = t + u * SPLIT, p = i >> 8, c = (i >> 5) & 7, r = i & 31;
    if (i >= NP * 256) break;
    const int off = p * PANEL_Q + r * ROW + ((c ^ (r & 7)) << 4);
    const float4 v = *reinterpret_cast<const float4*>(x + off);
    const float e4[4] = {v.x, v.y, v.z, v.w};
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) hop::tf32_split(e4[e], hi[e], lo[e]);
    *reinterpret_cast<uint4*>(x + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(x + T + off) =
        make_uint4(lo[0], lo[1], lo[2], lo[3]);
    const int s = hop::tf32_key_pos(r);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = 4 * c + e;  // of the transposed panel p
      const int to = p * PANEL_Q + row * ROW + (((s >> 2) ^ (row & 7)) << 4) +
                     (s & 3) * 4;
      *reinterpret_cast<uint32_t*>(x + 2 * T + to) = hi[e];
      *reinterpret_cast<uint32_t*>(x + 3 * T + to) = lo[e];
    }
  }
}

// The TF32 halves of k8 steps 4 hf .. 4 hf + 3 of K^T's rows d, d + 8 (A
// of dq^T: keys along k), read from raw K (panel kp, d's 16-byte chunk dw
// and word dc of it), or 0 where the rows lie past DP (!in)
__device__ __forceinline__ void kt_split(const unsigned char* kp, int dw,
                                         int dc, int t4, int hf, bool in,
                                         uint32_t (*hi)[4],
                                         uint32_t (*lo)[4]) {
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // a[e]: row d + 8 (e & 1) (two chunks on), key 8 kk + t4 + 4 (e >> 1)
      const int kr = 8 * (4 * hf + u) + t4 + 4 * (e >> 1);
      const int ch = dw + 2 * (e & 1);
      const float x = in ? *reinterpret_cast<const float*>(
                               kp + kr * ROW + ((ch ^ (kr & 7)) << 4) + dc)
                         : 0.f;
      hop::tf32_split(x, hi[u][e], lo[u][e]);
    }
}

template <int DP, bool WITH_DQ>
__device__ __forceinline__ void kv_walk_tf32(const Maps& maps,
                                             const BwdArgs& a) {
  using L = TfSmem<DP, WITH_DQ>;
  constexpr int NP = L::NP, STAGES = L::STAGES, T = L::T;
  constexpr int MC = (DP + 63) / 64;  // 64-row M chunks of dq^T
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = hop::smem_u32(smem_raw);
  unsigned char* sm = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  uint64_t* full_kv = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* full = full_kv + 1;      // [STAGES]: q, dout, lse, delta copied
  uint64_t* ready = full + STAGES;   // [STAGES]: the 3 splitter warps done
  uint64_t* empty = ready + STAGES;  // [STAGES]: the 4 consumer warps done
  float* s_lse = reinterpret_cast<float*>(sm + L::LSE);
  float* s_delta = reinterpret_cast<float*>(sm + L::DELTA);

  const int k0 = blockIdx.x * KEYS, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31;
  const long long bh = static_cast<long long>(b) * a.H + h;
  // query tiles above the causal diagonal see none of these keys
  const int iq0 = a.causal ? k0 / BQ : 0;
  const int n_tiles = max(0, (a.Tq + BQ - 1) / BQ - iq0);

  if (tid == 0) {
    hop::mbar_init(full_kv, 1);
    for (int s = 0; s < STAGES; ++s) {
      hop::mbar_init(full + s, 32);
      hop::mbar_init(ready + s, SPLIT / 32);
      hop::mbar_init(empty + s, 4);
    }
    hop::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 160) {
    // ----------------------------------------------------------- splitters
    const int t = tid - 160;
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % STAGES;
      hop::mbar_wait_or_trap(full + s, (it / STAGES) & 1);
      unsigned char* st = sm + L::RING + s * L::STAGE;
      split_tile<NP>(st + L::Q, t);
      split_tile<NP>(st + L::O, t);
      hop::fence_async_smem();
      __syncwarp();
      if (lane == 0) hop::mbar_arrive(ready + s);
    }
    return;
  }
  if (tid >= 128) {
    // ------------------------------------------------------------ producer
    // lane 0 issues the copies; every lane stages one row's lse (base 2,
    // +inf past Tq: p = 0 there) and delta, and arrives on the stage
    const float* lsep = a.lse + bh * a.Tq;
    const float* deltap = a.delta + bh * a.Tq;
    if (lane == 0) {
      hop::mbar_expect(full_kv, 2 * NP * PANEL_K);
      for (int p = 0; p < NP; ++p) {
        hop::tma_load_4d(sm + L::K + p * PANEL_K, &maps.k, full_kv, p * 32,
                         k0, h, b);
        hop::tma_load_4d(sm + L::V + p * PANEL_K, &maps.v, full_kv, p * 32,
                         k0, h, b);
      }
    }
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % STAGES, q0 = (iq0 + it) * BQ;
      if (it >= STAGES)
        hop::mbar_wait_or_trap(empty + s, ((it / STAGES) + 1) & 1);
      const int r = q0 + lane;
      s_lse[s * BQ + lane] = r < a.Tq ? lsep[r] * LOG2E : INFINITY;
      s_delta[s * BQ + lane] = r < a.Tq ? deltap[r] : 0.f;
      if (lane != 0) {
        hop::mbar_arrive(full + s);
      } else {
        unsigned char* st = sm + L::RING + s * L::STAGE;
        hop::mbar_expect(full + s, 2 * T);
        for (int p = 0; p < NP; ++p) {
          hop::tma_load_4d(st + L::Q + p * PANEL_Q, &maps.q, full + s, p * 32,
                           q0, h, b);
          hop::tma_load_4d(st + L::O + p * PANEL_Q, &maps.o, full + s, p * 32,
                           q0, h, b);
        }
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumer
  const int warp = tid >> 5, g = lane >> 2, t4 = lane & 3;
  const int kl = warp * 16 + g;             // this thread's rows of K, V
  const int ka = k0 + kl, kb = ka + 8;      // ... its keys
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
  const int ao = kl * ROW + t4 * 4;  // this thread's word of row kl
  const bool leader = tid == 0;
  float* stage = reinterpret_cast<float*>(sm + L::DQ);
  float* dq_base = WITH_DQ ? static_cast<float*>(a.dq) + b * a.dq_sb +
                                 h * a.dq_sh
                           : nullptr;
  // ds for the learned bias's gradient: the fused pass writes it, the
  // pair's dq kernel does
  float* dsp = WITH_DQ && a.ds != nullptr
                   ? a.ds + bh * a.Tq * static_cast<long long>(a.Tk)
                   : nullptr;
  // the staging buffer's columns past 64 MC (padding) add zeros
  if constexpr (WITH_DQ)
    for (int i = tid; i < BQ * L::ACC_LD; i += 128) stage[i] = 0.f;

  float dk[NP][16], dv[NP][16];  // keys ka, kb x panel columns
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < 16; ++i) dk[p][i] = dv[p][i] = 0.f;
  float st[16], dpt[16];  // s^T, dp^T: keys ka, kb x 8 of the 32 queries
  // two sets of an A operand's TF32 halves (hi, lo), k8 step kk: K's then
  // p_d^T's, V's then ds^T's
  uint32_t h0[4][4], l0[4][4], h1[4][4], l1[4][4];

  hop::mbar_wait_or_trap(full_kv, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES, q0 = (iq0 + it) * BQ;
    const uint32_t qt = base + L::RING + s * L::STAGE + L::Q;
    const uint32_t ot = base + L::RING + s * L::STAGE + L::O;
    const float* lq = s_lse + s * BQ;
    const float* dl = s_delta + s * BQ;
    hop::mbar_wait_or_trap(ready + s, (it / STAGES) & 1);

    // s^T = K q^T and dp^T = V dout^T, a panel of the head dim a group
    // each: K's (V's) halves of the next panel split while the group
    // before runs
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      hop::wgmma_wait<1>();  // s^T's group of panel p - 1 done: h0, l0 free
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hop::tf32_rows_split(sm + L::K + p * PANEL_K, ao, g, kk, h0[kk],
                             l0[kk]);
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hop::wgmma_tf32_3x(st, h0[kk], l0[kk], qt + p * PANEL_Q + kk * 32, T,
                           p > 0 || kk > 0);
      hop::wgmma_commit();
      hop::wgmma_wait<1>();  // dp^T's group of panel p - 1 done
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hop::tf32_rows_split(sm + L::V + p * PANEL_K, ao, g, kk, h1[kk],
                             l1[kk]);
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hop::wgmma_tf32_3x(dpt, h1[kk], l1[kk], ot + p * PANEL_Q + kk * 32,
                           T, p > 0 || kk > 0);
      hop::wgmma_commit();
    }
    hop::wgmma_wait<0>();
    hop::fence_regs(st, 16);
    hop::fence_regs(dpt, 16);

    // p = 2^(s scale log2(e) + bias - lse), element i: key i & 2 ? kb : ka,
    // query q0 + 8 (i / 4) + 2 t4 + (i & 1); each variant one straight run
    if (!full_bias) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(lq + 8 * j + 2 * t4);
        st[4 * j] = fmaf(st[4 * j], scale2, kterm[0]) - l2.x;
        st[4 * j + 1] = fmaf(st[4 * j + 1], scale2, kterm[0]) - l2.y;
        st[4 * j + 2] = fmaf(st[4 * j + 2], scale2, kterm[1]) - l2.x;
        st[4 * j + 3] = fmaf(st[4 * j + 3], scale2, kterm[1]) - l2.y;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int r = q0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
        const int kk = (i & 2) ? kb : ka;
        const float bv = r < a.Tq && kk < a.Tk
                             ? bp[r * a.b_sq + kk * a.b_sk] * LOG2E : 0.f;
        st[i] = fmaf(st[i], scale2, kterm[(i >> 1) & 1] + bv) -
                lq[8 * (i >> 2) + 2 * t4 + (i & 1)];
      }
    }
    if (a.causal && q0 < k0 + KEYS - 1) {  // the tile crosses the diagonal
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int r = q0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
        if (((i & 2) ? kb : ka) > r) st[i] = -INFINITY;
      }
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) st[i] = hop::ex2(st[i]);

    // p_d (dropout) into st, ds0 = p (dp_d - delta) into dpt
    if (a.dropout) {
      const uint32_t th = a.drop_threshold;
      const float dsc = a.drop_scale;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t w[4];
        wg::dropout_chunk(w, key, b, h, q0 + 8 * j + 2 * t4, ka, kb, odd);
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
      for (int j = 0; j < 4; ++j) {
        const float2 d2 = *reinterpret_cast<const float2*>(dl + 8 * j + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          dpt[i] = st[i] * (dpt[i] - ((e & 1) ? d2.y : d2.x));
        }
      }
    }
    if (dsp != nullptr) {  // the learned bias's gradient, f32
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int r = q0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
        const int kk = (i & 2) ? kb : ka;
        if (r < a.Tq && kk < a.Tk)
          dsp[r * static_cast<long long>(a.Tk) + kk] = dpt[i];
      }
    }

    // p_d^T and (ds0 scale)^T as the A operand; with dq, ds (scaled) also
    // as [query][key] halves, dq^T's B (its last reader, the tile before's
    // dq^T, is done: its group was waited for before the staging barrier)
    hop::tf32_acc_split(st, 1.f, h0, l0);
    hop::tf32_acc_split(dpt, a.scale, h1, l1);
    if constexpr (WITH_DQ) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qr = 8 * j + 2 * t4 + (e & 1);        // the query
          const int kr = kl + ((e & 2) ? 8 : 0);          // the key
          const int c = (e & 1) ? 2 + (e >> 1) : e >> 1;  // the split's order
          const int off = (kr >> 5) * PANEL_Q + qr * ROW +
                          ((((kr & 31) >> 2) ^ (qr & 7)) << 4) + (kr & 3) * 4;
          *reinterpret_cast<uint32_t*>(sm + L::DS + off) = h1[j][c];
          *reinterpret_cast<uint32_t*>(sm + L::DS + L::DS_LO + off) =
              l1[j][c];
        }
    }

    // dv += p_d^T dout, dk += ds^T q over the panels: dout^T and q^T (hi at
    // 2 T, lo at 3 T) as the K-major B
    hop::wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        hop::wgmma_tf32_3x(dv[p], h0[j], l0[j],
                           ot + 2 * T + p * PANEL_Q + j * 32, T);
        hop::wgmma_tf32_3x(dk[p], h1[j], l1[j],
                           qt + 2 * T + p * PANEL_Q + j * 32, T);
      }
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      hop::fence_regs(dv[p], 16);
      hop::fence_regs(dk[p], 16);
    }
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(empty + s);  // the stage is used
    if constexpr (!WITH_DQ) continue;

    // dq^T = K^T (ds scale)^T: K^T's halves (rows d, keys along k) from raw
    // K in registers, ds from shared memory, once every warp's ds is there
    // and the bulk add before has read the staging buffer
    if (leader) hop::bulk_wait_read<0>();
    hop::fence_async_smem();
    hop::named_sync(1, 128);
#pragma unroll
    for (int c = 0; c < MC; ++c) {
      // two groups of 4 k8 steps (keys 0-31, 32-63), their A halves in the
      // two sets of registers, so the second's are split as the first runs
      float acc[16];
      const int d = 64 * c + kl;  // this thread's rows d, d + 8 of dq^T
      const bool in = 64 * c + 16 * warp < DP;
      const unsigned char* kp = sm + L::K + (d >> 5) * PANEL_K;
      const int dw = (d & 31) >> 2, dc = (d & 3) * 4;
      kt_split(kp, dw, dc, t4, 0, in, h0, l0);
      hop::wgmma_fence();
#pragma unroll
      for (int u = 0; u < 4; ++u)
        hop::wgmma_tf32_3x(acc, h0[u], l0[u], base + L::DS + u * 32,
                           L::DS_LO, u > 0);
      hop::wgmma_commit();
      kt_split(kp, dw, dc, t4, 1, in, h1, l1);
      hop::wgmma_fence();
#pragma unroll
      for (int u = 0; u < 4; ++u)
        hop::wgmma_tf32_3x(acc, h1[u], l1[u],
                           base + L::DS + PANEL_Q + u * 32, L::DS_LO);
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_regs(acc, 16);
      // dq^T's element i: row d + 8 ((i >> 1) & 1), query 8 (i / 4) + 2 t4
      // + (i & 1), into the staging buffer's [query][d]
#pragma unroll
      for (int i = 0; i < 16; ++i)
        stage[(8 * (i >> 2) + 2 * t4 + (i & 1)) * L::ACC_LD + d +
              ((i & 2) ? 8 : 0)] = acc[i];
    }
    hop::fence_async_smem();
    hop::named_sync(1, 128);
    if (leader) {
      hop::bulk_reduce_add_f32(dq_base + q0 * a.dq_st, stage,
                               BQ * L::ACC_LD * 4);
      hop::bulk_commit();
    }
  }

  // ------------------------------------------------------------- epilogue
  // dk and dv straight to global memory (once a block), rows past Tk and
  // columns past D not written
  float* dkp = static_cast<float*>(a.dk) + b * a.dk_sb + h * a.dk_sh;
  float* dvp = static_cast<float*>(a.dv) + b * a.dv_sb + h * a.dv_sh;
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int kr = (i & 2) ? kb : ka;
      const int col = 32 * p + 8 * (i >> 2) + 2 * t4 + (i & 1);
      if (kr < a.Tk && col < a.D) {
        dkp[kr * a.dk_st + col] = dk[p][i];
        dvp[kr * a.dv_st + col] = dv[p][i];
      }
    }
  if (WITH_DQ && leader) hop::bulk_wait<0>();  // every dq add has landed
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
    bwd_fused_tf32(const __grid_constant__ Maps maps, const BwdArgs a) {
  kv_walk_tf32<DP, true>(maps, a);
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
    bwd_dkv_tf32(const __grid_constant__ Maps maps, const BwdArgs a) {
  kv_walk_tf32<DP, false>(maps, a);
}

// ----------------------------- f32 dk / dv above D = 128: the streamed walk
// Above DP = 128 the walk above does not fit: a ring stage would hold 8 DP
// 128 bytes (256 KB at DP = 256, against 227 KB a block), and dk and dv of
// 64 keys over DP columns would take DP f32 registers a thread (the cap is
// 255). So, as flash_attention_wide_dkv.cu's wide_dkv_st does for 16 bits,
// the head dim streams through a ring and dk and dv are split across
// blocks by role: a key block's dv blocks compute s^T alone, its dk blocks
// s^T and dp^T, each over all P = ceil(D / 32) panels, and each owns dv
// or dk over a slice of 3 to 6 panels (st_slices: ceil(P / 6) slices, so
// 2 ceil(P / 6) blocks a key block). One consumer warpgroup, one producer
// warp, three splitter warps (256 threads). Each 32-row q tile is a run of
// ring steps (slots of 64 KB, 3 of them):
//  - ceil(P / SG) score steps, each SG panels of K and q (for dk also V and
//    dout): s^T = K q^T (dp^T = V dout^T) in 3xTF32, K (V) raw and split in
//    the consumer's registers as the A operand, a panel a group, q (dout)
//    split in place by the splitters (hi, lo S_LO bytes on) as the K-major
//    B; panels past P read a zeroed panel, so every wgmma group is
//    straight-line code;
//  - one value step, the slice's panels of dout (dv) or q (dk) transposed
//    in place by the splitters into dout^T (q^T) hi, lo V_LO bytes on (a
//    row a column of the head dim, its 32 queries one 128-byte row at
//    hop::tf32_key_pos), for dv += p_d^T dout (dk += (ds scale)^T q) with
//    p_d^T (ds^T) split in registers as the A operand.
// Every block of a key block computes s^T (dp^T) over all panels in the
// same order, so all hold the same bits of p and ds; dk and dv are stored
// once by the threads: no atomics, the same bits from run to run.
// Bound: operations, s^T, dp^T, dv, dk (8 T^2 D flops a (batch, head), each
// as three TF32 products); the roles compute (3 ceil(P / 6) + 2) / 4 times
// that (1.25 at D <= 192, 2 at 193-384).
constexpr int SG = 2;                        // head-dim panels a score step
constexpr int SNO = 6;                       // dk or dv panels a block, at most
constexpr int S_V = SG * PANEL_K;            // a score step: K raw at 0, V raw
constexpr int S_Q = 2 * SG * PANEL_K;        // ... q hi (lo S_LO bytes on)
constexpr int S_LO = SG * PANEL_Q;
constexpr int S_O = S_Q + 2 * S_LO;          // ... dout hi (lo S_LO on)
constexpr int S_SLOT = S_O + 2 * S_LO;       // 64 KB
constexpr int V_LO = SNO * PANEL_Q;          // a value step: lo^T from hi^T
constexpr int BAR_SPLIT = 2;                 // the splitters' named barrier
static_assert(2 * V_LO <= S_SLOT, "a value step fits a slot");

__host__ __device__ inline int st_slices(int P) { return (P + SNO - 1) / SNO; }

// The streamed walk's shared memory from a 1024-byte aligned base: a zeroed
// 64-row panel, the ring's SLOTS slots, each tile's lse and delta rows
// (indexed by tile), the mbarriers: full (copied), ready (split) and empty
// (used) a slot.
struct StSmem {
  int P, NS, SLOTS, AUX, BAR, ALLOC;
  static constexpr int RING = PANEL_K;  // after the zeroed panel at 0
  __host__ __device__ explicit StSmem(int D) {
    P = (D + 31) / 32;
    NS = (P + SG - 1) / SG;
    SLOTS = (SMEM_LIMIT - 1024 - RING) / (S_SLOT + 2 * BQ * 4 + 3 * 8);
    if (SLOTS > 8) SLOTS = 8;
    AUX = RING + SLOTS * S_SLOT;
    BAR = AUX + SLOTS * 2 * BQ * 4;
    ALLOC = BAR + 3 * SLOTS * 8 + 1024;
  }
};

__device__ __forceinline__ void st_advance(int& s, uint32_t& ph, int slots) {
  if (++s == slots) {
    s = 0;
    ph ^= 1;
  }
}

__device__ __forceinline__ void release(uint64_t* empty) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) hop::mbar_arrive(empty);
}

// n panels of a 32-row tile (as TMA wrote them at x) split in place by
// splitter t: hi at x, lo S_LO bytes on
__device__ __forceinline__ void split_rows(unsigned char* x, int n, int t) {
  constexpr int PER = (SG * 256 + SPLIT - 1) / SPLIT;  // float4s a splitter
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int i = t + u * SPLIT;
    if (i >= n * 256) break;
    const float4 v = reinterpret_cast<const float4*>(x)[i];
    uint4 hi, lo;
    hop::tf32_split(v.x, hi.x, lo.x);
    hop::tf32_split(v.y, hi.y, lo.y);
    hop::tf32_split(v.z, hi.z, lo.z);
    hop::tf32_split(v.w, hi.w, lo.w);
    reinterpret_cast<uint4*>(x)[i] = hi;
    reinterpret_cast<uint4*>(x + S_LO)[i] = lo;
  }
}

// n panels of a 32-row tile (as TMA wrote them at x) transposed in place by
// splitter t (row c: column c, its 32 rows at hop::tf32_key_pos): hi at x,
// lo V_LO bytes on. Every splitter reads its share before any writes; a
// warp takes one 16-byte chunk of the 32 rows, so that each transposed
// store fills one row across 32 banks.
__device__ __forceinline__ void split_cols(unsigned char* x, int n, int t) {
  constexpr int PER = (SNO * 256 + SPLIT - 1) / SPLIT;
  float4 buf[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int i = t + u * SPLIT, p = i >> 8, c = (i >> 5) & 7, r = i & 31;
    if (i < n * 256)
      buf[u] = *reinterpret_cast<const float4*>(x + p * PANEL_Q + r * ROW +
                                                ((c ^ (r & 7)) << 4));
  }
  hop::named_sync(BAR_SPLIT, SPLIT);
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int i = t + u * SPLIT, p = i >> 8, c = (i >> 5) & 7;
    if (i >= n * 256) break;
    const int s = hop::tf32_key_pos(i & 31);
    const float e4[4] = {buf[u].x, buf[u].y, buf[u].z, buf[u].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = 4 * c + e;  // of the transposed panel p
      const int to = p * PANEL_Q + row * ROW + (((s >> 2) ^ (row & 7)) << 4) +
                     (s & 3) * 4;
      uint32_t hi, lo;
      hop::tf32_split(e4[e], hi, lo);
      *reinterpret_cast<uint32_t*>(x + to) = hi;
      *reinterpret_cast<uint32_t*>(x + V_LO + to) = lo;
    }
  }
}

// One score panel's group: acc (= or +=) A x B^T in 3xTF32, A's halves
// split from the raw 64-row panel ap into hi, lo, B's halves at b and
// b + b_lo (K-major). Committed.
__device__ __forceinline__ void score_panel(float* acc, uint32_t (*hi)[4],
                                            uint32_t (*lo)[4],
                                            const unsigned char* ap, int ao,
                                            int g, uint32_t b, uint32_t b_lo,
                                            bool add) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    hop::tf32_rows_split(ap, ao, g, kk, hi[kk], lo[kk]);
  hop::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    hop::wgmma_tf32_3x(acc, hi[kk], lo[kk], b + kk * 32, b_lo, add || kk > 0);
  hop::wgmma_commit();
}

// The consumer of one block of the streamed walk: dk (DK) or dv of the keys
// [k0, k0 + 64) over the W panels from c0
template <bool DK, int W>
__device__ __forceinline__ void dkv_st_consumer(const BwdArgs& a,
                                                unsigned char* sm,
                                                const StSmem& L, int k0,
                                                int c0, int iq0,
                                                int n_tiles) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = tid >> 5, g = lane >> 2, t4 = lane & 3;
  const int kl = warp * 16 + g;             // this thread's rows of K, V
  const int ka = k0 + kl, kb = ka + 8;      // ... its keys
  const bool odd = (g & 1) != 0;
  const uint2 key = a.dropout ? mxt::dropout_key(a.seed) : make_uint2(0, 0);
  const float scale2 = a.scale * LOG2E;
  const bool full_bias = a.bias != nullptr && a.b_sq != 0;
  const float* bp = a.bias ? a.bias + b * a.b_sb + h * a.b_sh : nullptr;
  float kterm[2];  // the key's term of the exponent, as kv_walk_tf32 reads it
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kk = i ? kb : ka;
    kterm[i] = kk >= a.Tk ? -INFINITY
               : (bp != nullptr && !full_bias) ? bp[kk * a.b_sk] * LOG2E
                                               : 0.f;
  }
  uint64_t* ready = reinterpret_cast<uint64_t*>(sm + L.BAR) + L.SLOTS;
  uint64_t* empty = ready + L.SLOTS;
  const float* s_aux = reinterpret_cast<const float*>(sm + L.AUX);
  const uint32_t zero = hop::smem_u32(sm);
  const uint32_t ring = zero + StSmem::RING;
  const int ao = kl * ROW + t4 * 4;  // this thread's word of row kl
  {  // the zeroed panel, before the first product
    float4* z = reinterpret_cast<float4*>(sm);
    for (int i = tid; i < PANEL_K / 16; i += 128)
      z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    hop::fence_async_smem();
    hop::named_sync(1, 128);
  }

  float acc[W][16];  // dk or dv: keys ka, kb x the slice's panel columns
#pragma unroll
  for (int p = 0; p < W; ++p)
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[p][i] = 0.f;
  float st[16], dpt[DK ? 16 : 1];  // s^T, dp^T: keys ka, kb x 8 of 32 queries
  // two sets of an A operand's TF32 halves (hi, lo), k8 step kk: dk blocks
  // K's and V's, dv blocks K's of even and odd panels; then p_d^T's or
  // ds^T's in the first
  uint32_t h0[4][4], l0[4][4], h1[4][4], l1[4][4];

  int s = 0;
  uint32_t ph = 0;
  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = (iq0 + it) * BQ;
    // s^T = K q^T (and dp^T = V dout^T), a group a panel: a set of halves
    // is split again once the group before that read it is done, the step
    // before's slot released once all its groups are
    int prev = 0;
    for (int j = 0; j < L.NS; ++j) {
      hop::mbar_wait_or_trap(ready + s, ph);
      const unsigned char* sp = sm + StSmem::RING + s * S_SLOT;
      const uint32_t slot = ring + s * S_SLOT;
#pragma unroll
      for (int gg = 0; gg < SG; ++gg) {
        const bool real = j * SG + gg < L.P;
        const bool add = j > 0 || gg > 0;
        const uint32_t lo = real ? S_LO : 0;  // lo's offset (0: the zeros)
        hop::wgmma_wait<1>();
        if (!DK && gg == 1 && j > 0) release(empty + prev);
        const unsigned char* kp = real ? sp + gg * PANEL_K : sm;
        const uint32_t qh = real ? slot + S_Q + gg * PANEL_Q : zero;
        if (DK || gg == 0)
          score_panel(st, h0, l0, kp, ao, g, qh, lo, add);
        else
          score_panel(st, h1, l1, kp, ao, g, qh, lo, add);
        if constexpr (DK) {
          hop::wgmma_wait<1>();
          if (gg == 0 && j > 0) release(empty + prev);
          const unsigned char* vp = real ? sp + S_V + gg * PANEL_K : sm;
          const uint32_t oh = real ? slot + S_O + gg * PANEL_Q : zero;
          score_panel(dpt, h1, l1, vp, ao, g, oh, lo, add);
        }
      }
      prev = s;
      st_advance(s, ph, L.SLOTS);
    }
    hop::wgmma_wait<0>();
    release(empty + prev);
    hop::fence_regs(st, 16);
    if constexpr (DK) hop::fence_regs(dpt, 16);

    // p = 2^(s scale log2(e) + bias - lse), element i: key i & 2 ? kb : ka,
    // query q0 + 8 (i / 4) + 2 t4 + (i & 1)
    const float* lq = s_aux + (it % L.SLOTS) * 2 * BQ;
    const float* dl = lq + BQ;
    if (!full_bias) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(lq + 8 * j + 2 * t4);
        st[4 * j] = fmaf(st[4 * j], scale2, kterm[0]) - l2.x;
        st[4 * j + 1] = fmaf(st[4 * j + 1], scale2, kterm[0]) - l2.y;
        st[4 * j + 2] = fmaf(st[4 * j + 2], scale2, kterm[1]) - l2.x;
        st[4 * j + 3] = fmaf(st[4 * j + 3], scale2, kterm[1]) - l2.y;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int r = q0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
        const int kk = (i & 2) ? kb : ka;
        const float bv = r < a.Tq && kk < a.Tk
                             ? bp[r * a.b_sq + kk * a.b_sk] * LOG2E : 0.f;
        st[i] = fmaf(st[i], scale2, kterm[(i >> 1) & 1] + bv) -
                lq[8 * (i >> 2) + 2 * t4 + (i & 1)];
      }
    }
    if (a.causal && q0 < k0 + KEYS - 1) {  // the tile crosses the diagonal
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int r = q0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
        if (((i & 2) ? kb : ka) > r) st[i] = -INFINITY;
      }
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) st[i] = hop::ex2(st[i]);

    // dv blocks: p_d (dropout) into st; dk blocks: ds0 = p (dp_d - delta)
    // into dpt
    if (a.dropout) {
      const uint32_t th = a.drop_threshold;
      const float dsc = a.drop_scale;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t w[4];
        wg::dropout_chunk(w, key, b, h, q0 + 8 * j + 2 * t4, ka, kb, odd);
        [[maybe_unused]] const float2 d2 =
            DK ? *reinterpret_cast<const float2*>(dl + 8 * j + 2 * t4)
               : make_float2(0.f, 0.f);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          const bool keep = w[e] >= th;
          if constexpr (DK) {
            const float dp = keep ? dpt[i] * dsc : 0.f;
            dpt[i] = st[i] * (dp - ((e & 1) ? d2.y : d2.x));
          } else {
            st[i] = keep ? st[i] * dsc : 0.f;
          }
        }
      }
    } else if constexpr (DK) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 d2 = *reinterpret_cast<const float2*>(dl + 8 * j + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          dpt[i] = st[i] * (dpt[i] - ((e & 1) ? d2.y : d2.x));
        }
      }
    }

    // dv += p_d^T dout or dk += (ds0 scale)^T q over the slice's panels:
    // p_d^T or ds^T split as the A operand, the value step's transposed
    // panels (hi, lo V_LO bytes on) as the K-major B
    if constexpr (DK)
      hop::tf32_acc_split(dpt, a.scale, h0, l0);
    else
      hop::tf32_acc_split(st, 1.f, h0, l0);
    hop::mbar_wait_or_trap(ready + s, ph);
    hop::wgmma_fence();
    const uint32_t vt = ring + s * S_SLOT;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int p = 0; p < W; ++p)
        hop::wgmma_tf32_3x(acc[p], h0[j], l0[j], vt + p * PANEL_Q + j * 32,
                           V_LO);
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
#pragma unroll
    for (int p = 0; p < W; ++p) hop::fence_regs(acc[p], 16);
    release(empty + s);
    st_advance(s, ph, L.SLOTS);
  }

  // ------------------------------------------------------------- epilogue
  // dk or dv straight to global memory (once a block), rows past Tk and
  // columns past D not written
  float* out = static_cast<float*>(DK ? a.dk : a.dv) +
               b * (DK ? a.dk_sb : a.dv_sb) + h * (DK ? a.dk_sh : a.dv_sh);
  const long long ost = DK ? a.dk_st : a.dv_st;
#pragma unroll
  for (int p = 0; p < W; ++p)
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int kr = (i & 2) ? kb : ka;
      const int col = 32 * (c0 + p) + 8 * (i >> 2) + 2 * t4 + (i & 1);
      if (kr < a.Tk && col < a.D) out[kr * ost + col] = acc[p][i];
    }
}

// One block of the streamed walk: dk (DK) or dv of the keys [k0, k0 + 64)
// over the w panels from c0
template <bool DK>
__device__ __forceinline__ void dkv_st_block(const Maps& maps,
                                             const BwdArgs& a,
                                             unsigned char* sm,
                                             const StSmem& L, int k0, int c0,
                                             int w) {
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L.BAR);  // [SLOTS]
  uint64_t* ready = full + L.SLOTS;   // [SLOTS]: the 3 splitter warps done
  uint64_t* empty = ready + L.SLOTS;  // [SLOTS]: the 4 consumer warps done
  float* s_aux = reinterpret_cast<float*>(sm + L.AUX);
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31;
  const long long bh = static_cast<long long>(b) * a.H + h;
  // query tiles above the causal diagonal see none of these keys
  const int iq0 = a.causal ? k0 / BQ : 0;
  const int n_tiles = max(0, (a.Tq + BQ - 1) / BQ - iq0);

  if (tid >= 160) {
    // ----------------------------------------------------------- splitters
    // a score step's q (and dout) panels split in place, the value step's
    // dout (or q) panels transposed
    const int t = tid - 160;
    int s = 0;
    uint32_t ph = 0;
    for (int it = 0; it < n_tiles; ++it) {
      for (int j = 0; j <= L.NS; ++j) {
        hop::mbar_wait_or_trap(full + s, ph);
        unsigned char* slot = sm + StSmem::RING + s * S_SLOT;
        if (j < L.NS) {
          const int n = min(SG, L.P - j * SG);
          split_rows(slot + S_Q, n, t);
          if (DK) split_rows(slot + S_O, n, t);
        } else {
          split_cols(slot, w, t);
        }
        hop::fence_async_smem();
        __syncwarp();
        if (lane == 0) hop::mbar_arrive(ready + s);
        st_advance(s, ph, L.SLOTS);
      }
    }
    return;
  }
  if (tid >= 128) {
    // ------------------------------------------------------------ producer
    // one warp: lane 0 issues the copies; every lane stages a tile's lse
    // (base 2, +inf past Tq: p = 0 there) and delta rows with its first
    // step and arrives on each step's barrier
    const float* lsep = a.lse + bh * a.Tq;
    const float* deltap = a.delta + bh * a.Tq;
    int s = 0, step = 0;
    uint32_t ph = 0;
    for (int it = 0; it < n_tiles; ++it) {
      const int q0 = (iq0 + it) * BQ;
      for (int j = 0; j <= L.NS; ++j, ++step) {
        if (step >= L.SLOTS) hop::mbar_wait_or_trap(empty + s, ph ^ 1);
        if (j == 0) {
          const int r = q0 + lane;
          float* aux = s_aux + (it % L.SLOTS) * 2 * BQ;
          aux[lane] = r < a.Tq ? lsep[r] * LOG2E : INFINITY;
          aux[BQ + lane] = r < a.Tq ? deltap[r] : 0.f;
        }
        if (lane != 0) {
          hop::mbar_arrive(full + s);
        } else {
          unsigned char* slot = sm + StSmem::RING + s * S_SLOT;
          if (j < L.NS) {  // a score step: panels [p0, p0 + n)
            const int p0 = j * SG, n = min(SG, L.P - p0);
            hop::mbar_expect(full + s, n * (DK ? 2 : 1) * (PANEL_K + PANEL_Q));
            for (int gg = 0; gg < n; ++gg) {
              const int c = (p0 + gg) * 32;
              hop::tma_load_4d(slot + gg * PANEL_K, &maps.k, full + s, c, k0,
                               h, b);
              hop::tma_load_4d(slot + S_Q + gg * PANEL_Q, &maps.q, full + s,
                               c, q0, h, b);
              if (DK) {
                hop::tma_load_4d(slot + S_V + gg * PANEL_K, &maps.v, full + s,
                                 c, k0, h, b);
                hop::tma_load_4d(slot + S_O + gg * PANEL_Q, &maps.o, full + s,
                                 c, q0, h, b);
              }
            }
          } else {  // the value step: the slice's q (dk) or dout (dv)
            hop::mbar_expect(full + s, w * PANEL_Q);
            for (int p = 0; p < w; ++p)
              hop::tma_load_4d(slot + p * PANEL_Q, DK ? &maps.q : &maps.o,
                               full + s, (c0 + p) * 32, q0, h, b);
          }
        }
        st_advance(s, ph, L.SLOTS);
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumer
  if (w == 6)
    dkv_st_consumer<DK, 6>(a, sm, L, k0, c0, iq0, n_tiles);
  else if (w == 5)
    dkv_st_consumer<DK, 5>(a, sm, L, k0, c0, iq0, n_tiles);
  else if (w == 4)
    dkv_st_consumer<DK, 4>(a, sm, L, k0, c0, iq0, n_tiles);
  else
    dkv_st_consumer<DK, 3>(a, sm, L, k0, c0, iq0, n_tiles);
}

__global__ void __launch_bounds__(THREADS, 1)
    bwd_dkv_tf32_st(const __grid_constant__ Maps maps, const BwdArgs a) {
  const StSmem L(a.D);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = hop::smem_u32(smem_raw);
  unsigned char* sm = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L.BAR);
  uint64_t* ready = full + L.SLOTS;
  uint64_t* empty = ready + L.SLOTS;
  if (threadIdx.x == 0) {
    for (int s = 0; s < L.SLOTS; ++s) {
      hop::mbar_init(full + s, 32);
      hop::mbar_init(ready + s, SPLIT / 32);
      hop::mbar_init(empty + s, 4);
    }
    hop::mbar_init_fence();
  }
  __syncthreads();

  // blocks [0, nsl) of a key block own dv of slice j, [nsl, 2 nsl) dk
  const int nsl = st_slices(L.P);
  const int j = blockIdx.x % (2 * nsl), k0 = (blockIdx.x / (2 * nsl)) * KEYS;
  const int sl = j % nsl;
  const int c0 = sl * L.P / nsl, w = (sl + 1) * L.P / nsl - c0;
  if (j < nsl)
    dkv_st_block<false>(maps, a, sm, L, k0, c0, w);
  else
    dkv_st_block<true>(maps, a, sm, L, k0, c0, w);
}

}  // namespace tf

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

// The f32 kernels' maps: q, dout, k, v read by TMA in f32 boxes of 32
// columns (the caller passes views TMA can address)
bool tf_maps(tf::Maps& maps, const BwdArgs& a) {
  const CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  return mxt::make_map(&maps.q, type, a.q, a.D, a.Tq, a.H, a.B, a.q_st,
                       a.q_sh, a.q_sb, tf::BQ, 4) &&
         mxt::make_map(&maps.o, type, a.dout, a.D, a.Tq, a.H, a.B, a.o_st,
                       a.o_sh, a.o_sb, tf::BQ, 4) &&
         mxt::make_map(&maps.k, type, a.k, a.D, a.Tk, a.H, a.B, a.k_st,
                       a.k_sh, a.k_sb, tf::KEYS, 4) &&
         mxt::make_map(&maps.v, type, a.v, a.D, a.Tk, a.H, a.B, a.v_st,
                       a.v_sh, a.v_sb, tf::KEYS, 4);
}

// the key-block walk on 3xTF32: the fused pass (WITH_DQ) or the pair's dk,
// dv (D <= 128)
template <int DP, bool WITH_DQ>
cudaError_t launch_tf32(const BwdArgs& a, const tf::Maps& maps,
                        cudaStream_t st) {
  dim3 grid((a.Tk + tf::KEYS - 1) / tf::KEYS, a.H, a.B);
  if constexpr (WITH_DQ)
    return launch(tf::bwd_fused_tf32<DP>, grid, tf::THREADS,
                  tf::TfSmem<DP, true>::ALLOC, st, maps, a);
  else
    return launch(tf::bwd_dkv_tf32<DP>, grid, tf::THREADS,
                  tf::TfSmem<DP, false>::ALLOC, st, maps, a);
}

template <bool WITH_DQ>
cudaError_t dispatch_walk_f32(const BwdArgs& a, const tf::Maps& maps,
                              cudaStream_t st) {
  if (a.D <= 32) return launch_tf32<32, WITH_DQ>(a, maps, st);
  if (a.D <= 64) return launch_tf32<64, WITH_DQ>(a, maps, st);
  if (a.D <= 96) return launch_tf32<96, WITH_DQ>(a, maps, st);
  return launch_tf32<128, WITH_DQ>(a, maps, st);
}

// The f32 fused pass (D <= 128, dq added into the f32 accumulator (B, H,
// Tq rounded up to 64, DP' + 8), contiguous, DP' = 64 or 128); dk, dv
// written by the threads.
cudaError_t dispatch_fused_f32(const BwdArgs& a, cudaStream_t st) {
  if (a.D > 128) return cudaErrorInvalidValue;
  const int ld = (a.D <= 64 ? 64 : 128) + 8;
  const long long rows = (a.Tq + wg::WG_ROWS - 1) / wg::WG_ROWS * wg::WG_ROWS;
  if (a.dq_st != ld || a.dq_sh != rows * ld || a.dq_sb != a.H * rows * ld)
    return cudaErrorInvalidValue;
  tf::Maps maps;
  if (!tf_maps(maps, a)) return cudaErrorInvalidValue;
  return dispatch_walk_f32<true>(a, maps, st);
}

// The f32 pair's dk, dv at every D: the walk without dq up to 128, the
// streamed walk above; dk, dv written by the threads.
cudaError_t dispatch_dkv_f32(const BwdArgs& a, cudaStream_t st) {
  tf::Maps maps;
  if (!tf_maps(maps, a)) return cudaErrorInvalidValue;
  if (a.D <= 128) return dispatch_walk_f32<false>(a, maps, st);
  const tf::StSmem L(a.D);
  dim3 grid((a.Tk + tf::KEYS - 1) / tf::KEYS * 2 * tf::st_slices(L.P), a.H,
            a.B);
  return launch(tf::bwd_dkv_tf32_st, grid, tf::THREADS, L.ALLOC, st, maps, a);
}

template <typename T>
cudaError_t dispatch_half(int kind, const BwdArgs& a, cudaStream_t st) {
  return kind == DQ ? dispatch_dq<T>(a, st) : dispatch_kv<T>(kind, a, st);
}

}  // namespace

// kind: 0 = fused single pass (dq into an f32 accumulator that the caller
// zeroes, dk, dv; D <= 128), 1 = dq of the two-pass pair (dq in q's dtype;
// 16-bit only: the f32 dq is flash_attention_wide_wg.cu's wide_dq_tf32),
// 2 = dk, dv of the two-pass pair (D <= 256, f32 at every D). dtype: 0 =
// float32, 1 = bfloat16, 2 = float16. strides (in elements): q, k, v, dout,
// dq, dk, dv as (b, h, t) each, then bias (b, h, q, k); the head dimension
// has unit stride everywhere. For 16-bit data q, k, v, dout and the 16-bit
// outputs (dk, dv; dq of kind 1), and for f32 q, k, v and dout, must be
// views TMA can address (16-byte aligned, strides of dimensions longer than 1
// multiples of 16 bytes; the Python wrapper copies other operands), and dq
// of kind 0 the contiguous (B, H, Tq rounded up to 64, DP + 8)
// accumulator, DP = 64 for D <= 64, else 128. lse and delta are
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
  const bool any_d = dtype == 0 && kind == DKV;
  if (D < 1 || (D > 256 && !any_d) || B < 1 || H < 1 || Tq < 1 || Tk < 1 ||
      B > 65535 || H > 65535 || kind < 0 || kind > 2 || (dropout && !seed))
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
      if (kind == FUSED) return static_cast<int>(dispatch_fused_f32(a, st));
      if (kind == DKV) return static_cast<int>(dispatch_dkv_f32(a, st));
      return static_cast<int>(cudaErrorInvalidValue);
    case 1:
      return static_cast<int>(dispatch_half<__nv_bfloat16>(kind, a, st));
    case 2:
      return static_cast<int>(dispatch_half<__half>(kind, a, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
