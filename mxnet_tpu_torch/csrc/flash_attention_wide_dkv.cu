// Flash attention's dk / dv kernels at 16-bit head dims above 256 for
// Hopper (sm_90a), tiled on wgmma and TMA, bound through a plain C entry:
// wide_dkv_wg on the "wide_wg" route (256 < D <= 512) and wide_dkv_st,
// which streams the head dim, on the "wide_stream" route (D > 512) of
// ops/cuda/attention.py:head_dim_route.
//
// Replaces, for bf16 / fp16 at every D > 256: mxnet_tpu/ops/pallas/
// attention.py, _flash_bwd_dkv_kernel (launched at :778), which takes any
// head dim; flash_attention_wide.cu's wide_dkv (a warp a key row on the FMA
// pipe) keeps f32. From q, k, v, dout, the forward's lse and delta =
// rowsum(dout * out):
//   p = exp(s - lse), s = q k^T * scale + bias, 0 where masked;
//   p_d, dp_d: p and dp = dout v^T dropped out as the forward drops p;
//   dv = p_d^T dout,  dk = (p (dp_d - delta) * scale)^T q, ds rounded to
//   q's dtype before the product (the Pallas kernel's cast);
// with the causal mask top-left (col <= row, also at Tq != Tk), keys past
// Tk and rows past Tq masked in the kernel, the additive f32 bias through
// its strides and the dropout keep bit of philox.cuh (the same pure
// function of (seed, batch, head, row, col) as every other kernel draws).
// It writes no ds: the dq kernel does.
//
// What bounds it: the products, 8 T^2 D flops a (batch, head) (s, dp,
// p^T dout, ds^T q) against ~12 T D bytes, ~T / 1.5 flops a byte, far
// above the card's ~295 at T >= 1024: the tensor cores. It is the key-block
// walk of flash_attention_bwd.cu (kv_walk, bwd_dkv_wg) carried to wider
// heads: a block owns 64 keys of one (batch, head); one producer warp
// loads their K (and V) once by TMA (128-byte swizzle, DP / 64 panels of
// 64 columns, DP in {320, 384, 448, 512}, zero fill past Tk and D) and
// streams 32-row tiles of q and dout, each tile's lse row (base 2, +inf
// past Tq, so p = 0 there) and delta row staged beside it by the warp's 32
// lanes. Per tile the consumer warpgroup computes s^T = K q^T and dp^T =
// V dout^T by wgmma over all DP / 16 k-steps (both K-major from shared
// memory), p^T with ex2 and scale * log2(e) folded into one FMA (a key's
// padding bias read once), the dropout mask with keys as the rows (one
// Philox call per 2 x 2 block, shared by the lanes holding keys 2i and
// 2i + 1), ds, and then dv += p_d^T dout and dk += ds^T q by wgmma with
// p_d^T and ds^T packed to 16 bits as the register A operand and dout, q
// as the MN-major B. Causal blocks start at the q tile of the diagonal. dk
// and dv stay in f32 registers over the walk and leave once, through the
// K and V panels (swizzled), by TMA stores that clip past Tk and D: no
// atomics, so dk and dv are the same bits from run to run.
//
// The crux is the registers. A warpgroup that owned dk and dv for 64 keys
// and all DP columns would hold DP f32 a thread, 320 to 512; the cap is
// 255, and a block of 384 threads gets 168 whatever setmaxnreg hands out
// (flash_attention_wide_wg.cu). So a block has one consumer warpgroup (256
// threads, 255 registers each) and dk and dv are split by columns across
// blocks, each block recomputing s^T (and dp^T) over the full head dim:
//  (i) SLICES: ceil(P / 2) blocks a key block (P = DP / 64 panels), each
//      owning dk and dv over 2 panels (64 + 64 f32 a thread, beside 16 + 16
//      of s^T and dp^T): (ceil(P / 2) + 1) / 2 times the function's
//      products, 2 at DP = 320 and 384, 2.5 at 448 and 512;
//  (ii) ROLES: ceil(P / 4) dv blocks, which compute s^T alone (dv needs no
//      dp) and read only their slice of dout, and as many dk blocks, which
//      compute s^T and dp^T; each owns up to 4 panels (128 f32 a thread):
//      2 times the function's products at every DP.
// Measured on an H100 with both built at every padded head dim (PERF.md
// section 6): (i) is 9-17 % faster at DP = 320 and 384 (fewer blocks for
// the same products), (ii) 6-10 % faster at 448 and 512 (2 against 2.5
// times the products), so dkv_mode keeps each where it wins. ptxas gives
// (i) 226 and 234 registers a thread at DP = 320 and 384, (ii) 225 and 226
// at 448 and 512, no spills (nvcc -Xptxas -v). Each wgmma group issued
// after an mbarrier wait has its own wgmma fence: without it ptxas
// serialized every wgmma (C7520) and the kernel took 1.6 times as long.
//
// Shared memory (227 KB a block): K and V take 2 x 64 x DP x 2 bytes, 80
// KB at DP = 320 and 128 KB at 512; a 32-row tile of q or dout 64 DP bytes
// (20 to 32 KB). Each q and each dout tile is a slot of its own in the ring
// (Smem::NSLOT slots: 7, 5, 4 and 3 at DP = 320, 384, 448 and 512), so
// even at DP = 512 the next tile's q streams in while this tile's products
// run. Blocks are numbered key block by key block, all of one (batch,
// head) together, so that its q and dout (1.3 MB at T = 1024, DP = 320)
// are read from the 50 MB L2 by every block after the first.
//
// Above D = 512 K and V no longer fit beside a ring: wide_dkv_st streams
// K, V, q and dout panels through it, with design (ii)'s roles at every D
// (the section "head dims above 512").
#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "hopper.cuh"
#include "philox.cuh"
#include "tma_host.cuh"

namespace {
namespace wdkv {

using mxt::Half;

constexpr int KEYS = 64;         // keys a block: the wgmma M
constexpr int BQ = 32;           // query rows of a q or dout tile: a row
                                 // a lane of the producer warp
constexpr int ROW_BYTES = 128;   // one swizzled row: 64 16-bit values
constexpr int KV_PANEL = KEYS * ROW_BYTES;  // a 64-column panel of K or V
constexpr int Q_PANEL = BQ * ROW_BYTES;     // a 64-column panel of a tile
constexpr int SMEM_LIMIT = 232448;  // bytes of shared memory a block may use
constexpr float LOG2E = 1.4426950408889634f;

constexpr int SLICES = 0;  // design (i)
constexpr int ROLES = 1;   // design (ii)
// the design at each padded head dim: the faster of the two on an H100
constexpr int dkv_mode(int DP) { return DP <= 384 ? SLICES : ROLES; }

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* bias;
  const float* lse;     // the forward's (B, H, Tq) f32
  const float* delta;   // (B, H, Tq) f32
  const int* seed;      // (2,) int32 Philox key on the device, or null
  int B, H, Tq, Tk, D;
  long long b_sb, b_sh, b_sq, b_sk;
  float scale;
  int causal;
  int dropout;
  uint32_t drop_threshold;
  float drop_scale;
};

// TMA descriptors, 4-d (d, t, h, b): q, dout (32-row boxes), k, v (loads)
// and dk, dv (stores; 64-row boxes)
struct Maps {
  CUtensorMap q, dout, k, v, dk, dv;
};

__host__ __device__ constexpr int min_i(int a, int b) {
  return a < b ? a : b;
}

// The blocks of one key block, NB of them, and the panels each owns (P =
// DP / 64): NS slices, slice s panels [cut(s), cut(s + 1)). SLICES: block
// j owns dk and dv of slice j, 2 panels (the last 1 at odd P). ROLES:
// blocks [0, NS) own dv of slice j, blocks [NS, 2 NS) dk of slice j - NS,
// the panels split evenly; WA and WB are the slices' widths.
template <int DP, int MODE>
struct Plan {
  static constexpr int P = DP / 64;
  static constexpr int NS = MODE == SLICES ? (P + 1) / 2 : (P + 3) / 4;
  static constexpr int NB = MODE == SLICES ? NS : 2 * NS;
  __host__ __device__ static constexpr int cut(int s) {
    return MODE == SLICES ? min_i(2 * s, P) : s * P / NS;
  }
  static constexpr int WA = cut(1) - cut(0);
  static constexpr int WB = cut(NS) - cut(NS - 1);
};

// Shared memory, in bytes from a 1024-byte aligned base: K and V (P panels
// of 64 keys each), the ring of slots (one q or dout tile each, P panels of
// 32 rows), each slot's lse or delta row, the mbarriers.
template <int DP>
struct Smem {
  static constexpr int P = DP / 64;
  static constexpr int KV_BYTES = P * KV_PANEL;
  static constexpr int SLOT = P * Q_PANEL;
  static constexpr int PER_SLOT = SLOT + BQ * 4 + 2 * 8;
  static constexpr int FIXED = 2 * KV_BYTES + 8 + 1024;
  static constexpr int NSLOT = (SMEM_LIMIT - FIXED) / PER_SLOT;
  static constexpr int K = 0;
  static constexpr int V = KV_BYTES;
  static constexpr int SLOTS = 2 * KV_BYTES;
  static constexpr int AUX = SLOTS + NSLOT * SLOT;
  static constexpr int BAR = AUX + NSLOT * BQ * 4;
  static constexpr int BYTES = BAR + (1 + 2 * NSLOT) * 8;
  static constexpr int ALLOC = BYTES + 1024;  // room to align the base
  static_assert(NSLOT >= 2 && ALLOC <= SMEM_LIMIT, "shared memory");
};

// The Philox words of this thread's four scores of one 8-query chunk (keys
// ka and kb = ka + 8, queries qc and qc + 1), as w[e] for the accumulator's
// element order (ka, qc), (ka, qc + 1), (kb, qc), (kb, qc + 1): keys are
// the rows, so the two lanes holding keys 2i and 2i + 1 (lane and lane ^ 4)
// share a call, the pairing of flash_attention_bwd.cu's dropout_chunk.
__device__ __forceinline__ void dropout_chunk(uint32_t* w, uint2 key, int b,
                                              int h, int qc, int ka, int kb,
                                              bool odd) {
  const uint4 x = mxt::dropout_words(key, b, h, qc, odd ? kb : ka);
  const uint32_t get0 = __shfl_xor_sync(0xffffffffu, odd ? x.x : x.y, 4);
  const uint32_t get1 = __shfl_xor_sync(0xffffffffu, odd ? x.z : x.w, 4);
  w[0] = odd ? get0 : x.x;
  w[1] = odd ? get1 : x.z;
  w[2] = odd ? x.y : get0;
  w[3] = odd ? x.w : get1;
}

// acc (W * 32 f32) += A (registers: the 16-bit fragment of 16 queries) x
// W panels of a tile as the MN-major B, the first at b, in wgmmas of 256,
// 128 and 64 columns. Not committed.
template <typename T, int W>
__device__ __forceinline__ void mma_panels(float* acc, const uint32_t* af,
                                           uint32_t b) {
  if constexpr (W >= 4) {
    hop::wgmma_rs<T, 256, 1>(acc, af, hop::desc_mnmajor_sw128(b, Q_PANEL), 1);
    mma_panels<T, W - 4>(acc + 128, af, b + 4 * Q_PANEL);
  } else if constexpr (W >= 2) {
    hop::wgmma_rs<T, 128, 1>(acc, af, hop::desc_mnmajor_sw128(b, Q_PANEL), 1);
    mma_panels<T, W - 2>(acc + 64, af, b + 2 * Q_PANEL);
  } else if constexpr (W == 1) {
    hop::wgmma_rs<T, 64, 1>(acc, af, hop::desc_mnmajor_sw128(b, Q_PANEL), 1);
  }
}

// acc (BQ / 2 f32) = A (64 keys, K-major, panels KV_PANEL apart) x B^T (a
// 32-row tile, K-major, panels Q_PANEL apart) over all DP / 16 k-steps.
// Not committed.
template <typename T, int DP>
__device__ __forceinline__ void scores_t(float* acc, uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t off = (kk & 3) * 32;
    hop::wgmma_ss<T, BQ>(
        acc, hop::desc_kmajor_sw128(a + (kk >> 2) * KV_PANEL + off),
        hop::desc_kmajor_sw128(b + (kk >> 2) * Q_PANEL + off), kk > 0);
  }
}

// W panels of dk or dv (acc, 32 f32 a panel) packed to 16 bits into the
// swizzled panels from `region` (64 rows each, KV_PANEL apart)
template <typename T, int W>
__device__ __forceinline__ void stage_rows(const float* acc,
                                           unsigned char* region, int row,
                                           int t4) {
#pragma unroll
  for (int j = 0; j < W * 8; ++j) {
    unsigned char* pn = region + (j >> 3) * KV_PANEL;
    const int chunk = ((j & 7) ^ (row & 7)) * 16 + t4 * 4;
    *reinterpret_cast<uint32_t*>(pn + row * ROW_BYTES + chunk) =
        Half<T>::pack(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(pn + (row + 8) * ROW_BYTES + chunk) =
        Half<T>::pack(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// One block's walk over the q tiles: dk (DK) and / or dv (DV) of the keys
// [k0, k0 + 64) over the W panels from c0. dk needs s^T and dp^T, dv s^T
// alone (and only its slice of dout).
template <typename T, int DP, bool DK, bool DV, int W>
__device__ __forceinline__ void walk(const Maps& maps, const Args& a,
                                     unsigned char* sm, int k0, int c0,
                                     int h, int b) {
  using L = Smem<DP>;
  constexpr int P = L::P, NS = L::NSLOT;
  constexpr int DO_PANELS = DK ? P : W;  // dout panels a tile loads
  uint64_t* full_kv = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* full = full_kv + 1;   // [NS]: a slot's tile and its row
  uint64_t* empty = full + NS;    // [NS]: the consumer warps done with it
  float* s_aux = reinterpret_cast<float*>(sm + L::AUX);
  const int tid = threadIdx.x, lane = tid & 31;
  const long long bh = static_cast<long long>(b) * a.H + h;
  // query tiles above the causal diagonal see none of these keys
  const int iq0 = a.causal ? k0 / BQ : 0;
  const int n_tiles = max(0, (a.Tq + BQ - 1) / BQ - iq0);

  if (tid >= 128) {
    // ------------------------------------------------------------ producer
    // one warp: K (and V) once, then tile j / 2's q (even j) or dout (odd
    // j) into slot j % NS, with its lse or delta row
    if (tid >= 160) return;
    const float* lsep = a.lse + bh * a.Tq;
    const float* deltap = a.delta + bh * a.Tq;
    if (lane == 0) {
      hop::mbar_expect(full_kv, (DK ? 2 : 1) * L::KV_BYTES);
      for (int p = 0; p < P; ++p) {
        hop::tma_load_4d(sm + L::K + p * KV_PANEL, &maps.k, full_kv, p * 64,
                         k0, h, b);
        if (DK)
          hop::tma_load_4d(sm + L::V + p * KV_PANEL, &maps.v, full_kv,
                           p * 64, k0, h, b);
      }
    }
    for (int j = 0; j < 2 * n_tiles; ++j) {
      const int s = j % NS, q0 = (iq0 + (j >> 1)) * BQ;
      const bool is_q = (j & 1) == 0;
      if (j >= NS) hop::mbar_wait_or_trap(empty + s, ((j / NS) + 1) & 1);
      // lse in base-2 units, +inf past Tq (p = 0 there); delta 0 past Tq
      const int r = q0 + lane;
      s_aux[s * BQ + lane] = is_q ? (r < a.Tq ? lsep[r] * LOG2E : INFINITY)
                                  : (r < a.Tq ? deltap[r] : 0.f);
      if (lane != 0) {
        hop::mbar_arrive(full + s);
      } else {
        unsigned char* dst = sm + L::SLOTS + s * L::SLOT;
        const int np = is_q ? P : DO_PANELS;
        const int p0 = is_q || DK ? 0 : c0;
        hop::mbar_expect(full + s, np * Q_PANEL);
        for (int p = 0; p < np; ++p)
          hop::tma_load_4d(dst + p * Q_PANEL, is_q ? &maps.q : &maps.dout,
                           full + s, (p0 + p) * 64, q0, h, b);
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  const int warp = tid >> 5, g = lane >> 2, t4 = lane & 3;
  const int ka = k0 + warp * 16 + g, kb = ka + 8;  // this thread's keys
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

  float dk[DK ? W * 32 : 1], dv[DV ? W * 32 : 1];
#pragma unroll
  for (int i = 0; i < W * 32; ++i) {
    if constexpr (DK) dk[i] = 0.f;
    if constexpr (DV) dv[i] = 0.f;
  }
  float st[BQ / 2], dpt[DK ? BQ / 2 : 1];  // s^T, dp^T: rows ka, kb
  uint32_t pf[BQ / 16][4], df[BQ / 16][4];

  hop::mbar_wait_or_trap(full_kv, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int jq = 2 * it, jd = jq + 1;
    const int sq = jq % NS, sd = jd % NS;
    const int q0 = (iq0 + it) * BQ;
    const uint32_t q_tile = base + L::SLOTS + sq * L::SLOT;
    const uint32_t o_tile = base + L::SLOTS + sd * L::SLOT;
    const float* lq = s_aux + sq * BQ;
    const float* dl = s_aux + sd * BQ;

    // s^T = K q^T (and dp^T = V dout^T), a group each
    hop::mbar_wait_or_trap(full + sq, (jq / NS) & 1);
    hop::wgmma_fence();
    scores_t<T, DP>(st, base + L::K, q_tile);
    hop::wgmma_commit();
    if constexpr (DK) {
      hop::mbar_wait_or_trap(full + sd, (jd / NS) & 1);
      hop::wgmma_fence();  // after the wait: else ptxas serializes (C7520)
      scores_t<T, DP>(dpt, base + L::V, o_tile);
      hop::wgmma_commit();
      hop::wgmma_wait<1>();
    } else {
      hop::wgmma_wait<0>();
    }
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
    if (a.causal && q0 < k0 + KEYS - 1) {  // the tile crosses the diagonal
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        const int r = q0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
        if (((i & 2) ? kb : ka) > r) st[i] = -INFINITY;
      }
    }
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) st[i] = hop::ex2(st[i]);

    // p_d (dropout) into st and, for dk, ds0 = p (dp_d - delta) into dpt
    if constexpr (DK) {
      hop::wgmma_wait<0>();
      hop::fence_regs(dpt, BQ / 2);
    }
    if (a.dropout) {
      const uint32_t th = a.drop_threshold;
      const float dsc = a.drop_scale;
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        uint32_t w[4];
        dropout_chunk(w, key, b, h, q0 + 8 * j + 2 * t4, ka, kb, odd);
        [[maybe_unused]] const float2 d2 =
            DK ? *reinterpret_cast<const float2*>(dl + 8 * j + 2 * t4)
               : make_float2(0.f, 0.f);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          const bool keep = w[e] >= th;
          const float p = st[i];
          if constexpr (DK) {
            const float dp = keep ? dpt[i] * dsc : 0.f;
            dpt[i] = p * (dp - ((e & 1) ? d2.y : d2.x));
          }
          st[i] = keep ? p * dsc : 0.f;
        }
      }
    } else if constexpr (DK) {
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

    // dv += p_d^T dout and dk += (ds0 scale)^T q over the block's panels:
    // p_d^T and ds^T as the register A operand, dout and q as the MN-major B
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if constexpr (DV)
          pf[kk][r] = Half<T>::pack(st[8 * kk + 2 * r], st[8 * kk + 2 * r + 1]);
        if constexpr (DK)
          df[kk][r] = Half<T>::pack(dpt[8 * kk + 2 * r] * a.scale,
                                    dpt[8 * kk + 2 * r + 1] * a.scale);
      }
    if constexpr (!DK) hop::mbar_wait_or_trap(full + sd, (jd / NS) & 1);
    hop::wgmma_fence();
    if constexpr (DV) {
      // the slot holds all of dout's panels for a dk block, its slice alone
      // for a dv block
      const uint32_t o_cols = o_tile + (DK ? c0 * Q_PANEL : 0);
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        mma_panels<T, W>(dv, pf[kk], o_cols + kk * 16 * ROW_BYTES);
    }
    if constexpr (DK) {
      const uint32_t q_cols = q_tile + c0 * Q_PANEL;
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        mma_panels<T, W>(dk, df[kk], q_cols + kk * 16 * ROW_BYTES);
    }
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    if constexpr (DV) hop::fence_regs(dv, W * 32);
    if constexpr (DK) hop::fence_regs(dk, W * 32);
    __syncwarp();
    if (lane == 0) {  // the tile's q, dout and rows used
      hop::mbar_arrive(empty + sq);
      hop::mbar_arrive(empty + sd);
    }
  }

  // ------------------------------------------------------------- epilogue
  // dk through the K panels and dv through the V panels (every read of K
  // and V is done), in the swizzled layout of the stores' tensor maps; one
  // thread stores each 64-wide panel, keys past Tk and columns past D
  // clipped
  hop::named_sync(1, 128);
  const int row = warp * 16 + g;
  if constexpr (DK) stage_rows<T, W>(dk, sm + L::K, row, t4);
  if constexpr (DV) stage_rows<T, W>(dv, sm + L::V, row, t4);
  hop::fence_async_smem();
  hop::named_sync(1, 128);
  if (tid == 0 && k0 < a.Tk) {
    for (int p = 0; p < W; ++p) {
      if (DK)
        hop::tma_store_4d(&maps.dk, sm + L::K + p * KV_PANEL, (c0 + p) * 64,
                          k0, h, b);
      if (DV)
        hop::tma_store_4d(&maps.dv, sm + L::V + p * KV_PANEL, (c0 + p) * 64,
                          k0, h, b);
    }
    hop::tma_store_commit_and_wait();
  }
}

template <typename T, int DP, int MODE>
__global__ void __launch_bounds__(2 * 128, 1)
    wide_dkv_wg(const __grid_constant__ Maps maps, const Args a) {
  using L = Smem<DP>;
  using S = Plan<DP, MODE>;
  constexpr int NS = L::NSLOT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = hop::smem_u32(smem_raw);
  unsigned char* sm = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  uint64_t* full_kv = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* full = full_kv + 1;
  uint64_t* empty = full + NS;
  if (threadIdx.x == 0) {
    hop::mbar_init(full_kv, 1);
    for (int s = 0; s < NS; ++s) {
      hop::mbar_init(full + s, 32);
      hop::mbar_init(empty + s, 4);
    }
    hop::mbar_init_fence();
  }
  __syncthreads();

  const int j = blockIdx.x % S::NB, k0 = (blockIdx.x / S::NB) * KEYS;
  const int h = blockIdx.y, b = blockIdx.z;
  if constexpr (MODE == SLICES) {
    const int c0 = S::cut(j);
    if (S::cut(j + 1) - c0 == S::WA)
      walk<T, DP, true, true, S::WA>(maps, a, sm, k0, c0, h, b);
    else if constexpr (S::WB != S::WA)
      walk<T, DP, true, true, S::WB>(maps, a, sm, k0, c0, h, b);
  } else {
    const bool dv_block = j < S::NS;
    const int sl = dv_block ? j : j - S::NS;
    const int c0 = S::cut(sl);
    const bool wide_a = S::cut(sl + 1) - c0 == S::WA;
    if (dv_block) {
      if (wide_a)
        walk<T, DP, false, true, S::WA>(maps, a, sm, k0, c0, h, b);
      else if constexpr (S::WB != S::WA)
        walk<T, DP, false, true, S::WB>(maps, a, sm, k0, c0, h, b);
    } else {
      if (wide_a)
        walk<T, DP, true, false, S::WA>(maps, a, sm, k0, c0, h, b);
      else if constexpr (S::WB != S::WA)
        walk<T, DP, true, false, S::WB>(maps, a, sm, k0, c0, h, b);
    }
  }
}

// ------------------------------------ head dims above 512: the streamed walk
// K and V of a block's 64 keys take 256 D bytes (256 KB at D = 1024): they
// no longer fit beside a ring. So the walk streams the head dim too, as
// flash_attention_wide_wg.cu's wide_dq_st does: P = ceil(D / 64) panels in
// ceil(P / 4) slices of 3 or 4 (st_slices), a dv block and a dk block a
// slice (ROLES), one consumer warpgroup and one producer warp (256
// threads). Each 32-row q tile is a run of ring steps: ceil(P / ST_G)
// score steps, each holding ST_G panels of K and q (and, for dk, of V and
// dout), which the consumer adds into s^T (and dp^T) by wgmma, then one
// value step holding the slice's panels of dout (dv) or q (dk), for dv +=
// p_d^T dout (dk += ds^T q). A slot is one size whatever D is; the panels
// of the last score step past P read a zeroed region, so every wgmma group
// is straight-line code of a fixed size (a group in a loop of a run-time
// trip count is serialized by ptxas, C7520). Every block of a key block
// computes s^T (dp^T) over all P panels in the same order, so all hold the
// same bits of p and ds. dk and dv leave once, by TMA stores: no atomics.
// head-dim panels a score step: 3 (3 slots of 72 KB) was 7-8 % faster on
// an H100 than 2 (4 slots) at D = 576 and 1280, a tie at 1024, and 12-28 %
// faster than 4 (2 slots)
constexpr int ST_G = 3;
constexpr int ST_THREADS = 256;  // a consumer warpgroup, a producer's
constexpr int ST_MAX_SLOTS = 8;

__host__ __device__ inline int st_slices(int P) { return (P + 3) / 4; }

__device__ __forceinline__ void st_advance(int& st, uint32_t& ph,
                                           int slots) {
  if (++st == slots) {
    st = 0;
    ph ^= 1;
  }
}

// The streamed walk's shared memory from a 1024-byte aligned base: a zeroed
// 64-row panel, the ring's SLOTS slots (a score step: ST_G panels each of
// K, V, q, dout; a value step: the slice's panels of dout or q), each
// slot's lse and delta rows (indexed by tile), the mbarriers (full and
// empty a slot).
struct StSmem {
  int P, NS, SLOT, SLOTS, RING, AUX, BAR, ALLOC;
  __host__ __device__ explicit StSmem(int D) {
    P = (D + 63) / 64;
    NS = (P + ST_G - 1) / ST_G;
    SLOT = ST_G * 2 * (KV_PANEL + Q_PANEL);
    RING = KV_PANEL;  // after the zeroed panel at 0
    SLOTS = (SMEM_LIMIT - 1024 - RING) / (SLOT + 2 * BQ * 4 + 2 * 8);
    if (SLOTS > ST_MAX_SLOTS) SLOTS = ST_MAX_SLOTS;
    AUX = RING + SLOTS * SLOT;
    BAR = AUX + SLOTS * 2 * BQ * 4;
    ALLOC = BAR + 2 * SLOTS * 8 + 1024;
  }
};

// p^T and ds^T of one q tile from the accumulated s^T (st) and dp^T (dpt,
// dk blocks), walk's arithmetic: p = 2^(s scale log2(e) + key term + bias
// - lse) (0 where masked), the dropout mask with keys as the rows, p_d
// into st (dv blocks), ds0 = p (dp_d - delta) into dpt (dk blocks). lq,
// dl: the tile's staged lse (base 2) and delta rows. walk keeps its own
// copy inline, for its SLICES blocks that need both: on the card, moving
// such a tile's code of the tiled dq kernel into a helper made it a third
// slower (flash_attention_wide_wg.cu, ds_tile).
template <bool DK>
__device__ __forceinline__ void tile_grads(float* st, float* dpt,
                                           const Args& a, int q0, int k0,
                                           int ka, int kb, int t4, bool odd,
                                           const float* kterm,
                                           const float* lq, const float* dl,
                                           uint2 key, float scale2,
                                           bool full_bias, const float* bp,
                                           int b, int h) {
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
  if (a.causal && q0 < k0 + KEYS - 1) {  // the tile crosses the diagonal
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) {
      const int r = q0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
      if (((i & 2) ? kb : ka) > r) st[i] = -INFINITY;
    }
  }
#pragma unroll
  for (int i = 0; i < BQ / 2; ++i) st[i] = hop::ex2(st[i]);
  if (a.dropout) {
    const uint32_t th = a.drop_threshold;
    const float dsc = a.drop_scale;
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      uint32_t w[4];
      dropout_chunk(w, key, b, h, q0 + 8 * j + 2 * t4, ka, kb, odd);
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
    for (int j = 0; j < BQ / 8; ++j) {
      const float2 d2 = *reinterpret_cast<const float2*>(dl + 8 * j + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        dpt[i] = st[i] * (dpt[i] - ((e & 1) ? d2.y : d2.x));
      }
    }
  }
}

// One block of the streamed walk: dk (DK) or dv of the keys [k0, k0 + 64)
// over the W panels from c0.
template <typename T, bool DK, int W>
__device__ __forceinline__ void walk_st(const Maps& maps, const Args& a,
                                        unsigned char* sm, const StSmem& L,
                                        int k0, int c0, int h, int b) {
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L.BAR);  // [SLOTS]
  uint64_t* empty = full + L.SLOTS;  // [SLOTS]: the 4 consumer warps done
  float* s_aux = reinterpret_cast<float*>(sm + L.AUX);
  const int tid = threadIdx.x, lane = tid & 31;
  const long long bh = static_cast<long long>(b) * a.H + h;
  // query tiles above the causal diagonal see none of these keys
  const int iq0 = a.causal ? k0 / BQ : 0;
  const int n_tiles = max(0, (a.Tq + BQ - 1) / BQ - iq0);
  // a score step's operands: K's panels at 0, V's, q's, dout's behind
  constexpr int V_AT = ST_G * KV_PANEL, Q_AT = 2 * ST_G * KV_PANEL;
  constexpr int DO_AT = Q_AT + ST_G * Q_PANEL;

  if (tid >= 128) {
    // ------------------------------------------------------------ producer
    // one warp: lane 0 issues the copies; every lane stages a tile's lse
    // and delta rows with its first step and arrives on each step's barrier
    if (tid >= 160) return;
    const float* lsep = a.lse + bh * a.Tq;
    const float* deltap = a.delta + bh * a.Tq;
    int st = 0, step = 0;
    uint32_t ph = 0;
    for (int it = 0; it < n_tiles; ++it) {
      const int q0 = (iq0 + it) * BQ;
      for (int j = 0; j <= L.NS; ++j, ++step) {
        if (step >= L.SLOTS) hop::mbar_wait_or_trap(empty + st, ph ^ 1);
        if (j == 0) {
          // lse in base-2 units, +inf past Tq (p = 0 there); delta 0 there
          const int r = q0 + lane;
          float* aux = s_aux + (it % L.SLOTS) * 2 * BQ;
          aux[lane] = r < a.Tq ? lsep[r] * LOG2E : INFINITY;
          aux[BQ + lane] = r < a.Tq ? deltap[r] : 0.f;
        }
        if (lane != 0) {
          hop::mbar_arrive(full + st);
        } else {
          unsigned char* slot = sm + L.RING + st * L.SLOT;
          if (j < L.NS) {  // a score step: panels [p0, p0 + n)
            const int p0 = j * ST_G, n = min(ST_G, L.P - p0);
            hop::mbar_expect(full + st,
                             n * (DK ? 2 : 1) * (KV_PANEL + Q_PANEL));
            for (int g = 0; g < n; ++g) {
              const int c = (p0 + g) * 64;
              hop::tma_load_4d(slot + g * KV_PANEL, &maps.k, full + st, c,
                               k0, h, b);
              hop::tma_load_4d(slot + Q_AT + g * Q_PANEL, &maps.q, full + st,
                               c, q0, h, b);
              if (DK) {
                hop::tma_load_4d(slot + V_AT + g * KV_PANEL, &maps.v,
                                 full + st, c, k0, h, b);
                hop::tma_load_4d(slot + DO_AT + g * Q_PANEL, &maps.dout,
                                 full + st, c, q0, h, b);
              }
            }
          } else {  // the value step: the slice's q (dk) or dout (dv)
            hop::mbar_expect(full + st, W * Q_PANEL);
            for (int p = 0; p < W; ++p)
              hop::tma_load_4d(slot + p * Q_PANEL,
                               DK ? &maps.q : &maps.dout, full + st,
                               (c0 + p) * 64, q0, h, b);
          }
        }
        st_advance(st, ph, L.SLOTS);
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumer
  const int warp = tid >> 5, g8 = lane >> 2, t4 = lane & 3;
  const int ka = k0 + warp * 16 + g8, kb = ka + 8;  // this thread's keys
  const bool odd = (g8 & 1) != 0;
  const uint2 key = a.dropout ? mxt::dropout_key(a.seed) : make_uint2(0, 0);
  const float scale2 = a.scale * LOG2E;
  const bool full_bias = a.bias != nullptr && a.b_sq != 0;
  const float* bp = a.bias ? a.bias + b * a.b_sb + h * a.b_sh : nullptr;
  float kterm[2];  // the key's term of the exponent, as walk reads it
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kk = i ? kb : ka;
    kterm[i] = kk >= a.Tk ? -INFINITY
               : (bp != nullptr && !full_bias) ? bp[kk * a.b_sk] * LOG2E
                                               : 0.f;
  }
  const uint32_t zero = hop::smem_u32(sm);
  const uint32_t ring = zero + L.RING;
  {  // the zeroed panel, before the first product
    float4* z = reinterpret_cast<float4*>(sm);
    for (int i = tid; i < KV_PANEL / 16; i += 128)
      z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    hop::fence_async_smem();
    hop::named_sync(1, 128);
  }

  float acc[W * 32];  // dk or dv
#pragma unroll
  for (int i = 0; i < W * 32; ++i) acc[i] = 0.f;
  float st[BQ / 2], dpt[DK ? BQ / 2 : 1];  // s^T, dp^T: rows ka, kb
  uint32_t af[BQ / 16][4];

  int s = 0;
  uint32_t ph = 0;
  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = (iq0 + it) * BQ;
    // s^T = K q^T (and dp^T = V dout^T), ST_G panels a step; the step
    // before is still in flight when a step is issued, its slot released
    // once it is done
    int rel = s;
    for (int j = 0; j < L.NS; ++j) {
      hop::mbar_wait_or_trap(full + s, ph);
      hop::wgmma_fence();  // after the wait: else ptxas serializes (C7520)
      const uint32_t slot = ring + s * L.SLOT;
#pragma unroll
      for (int g = 0; g < ST_G; ++g) {
        const bool real = j * ST_G + g < L.P;
        const uint32_t kp = real ? slot + g * KV_PANEL : zero;
        const uint32_t qp = real ? slot + Q_AT + g * Q_PANEL : zero;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hop::wgmma_ss<T, BQ>(st, hop::desc_kmajor_sw128(kp + kk * 32),
                               hop::desc_kmajor_sw128(qp + kk * 32),
                               j > 0 || g > 0 || kk > 0);
        if constexpr (DK) {
          const uint32_t vp = real ? slot + V_AT + g * KV_PANEL : zero;
          const uint32_t op = real ? slot + DO_AT + g * Q_PANEL : zero;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            hop::wgmma_ss<T, BQ>(dpt, hop::desc_kmajor_sw128(vp + kk * 32),
                                 hop::desc_kmajor_sw128(op + kk * 32),
                                 j > 0 || g > 0 || kk > 0);
        }
      }
      hop::wgmma_commit();
      if (j > 0) {
        hop::wgmma_wait<1>();
        __syncwarp();
        if (lane == 0) hop::mbar_arrive(empty + rel);
        if (++rel == L.SLOTS) rel = 0;
      }
      st_advance(s, ph, L.SLOTS);
    }
    hop::wgmma_wait<0>();
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(empty + rel);
    hop::fence_regs(st, BQ / 2);
    if constexpr (DK) hop::fence_regs(dpt, BQ / 2);

    const float* lq = s_aux + (it % L.SLOTS) * 2 * BQ;
    tile_grads<DK>(st, dpt, a, q0, k0, ka, kb, t4, odd, kterm, lq, lq + BQ,
                   key, scale2, full_bias, bp, b, h);

    // dv += p_d^T dout or dk += (ds0 scale)^T q over the slice's panels:
    // p_d^T or ds^T packed to 16 bits as the register A operand, the value
    // step's panels as the MN-major B
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 8 * kk + 2 * r;
        if constexpr (DK)
          af[kk][r] = Half<T>::pack(dpt[i] * a.scale, dpt[i + 1] * a.scale);
        else
          af[kk][r] = Half<T>::pack(st[i], st[i + 1]);
      }
    hop::mbar_wait_or_trap(full + s, ph);
    hop::wgmma_fence();
    const uint32_t vals = ring + s * L.SLOT;
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      mma_panels<T, W>(acc, af[kk], vals + kk * 16 * ROW_BYTES);
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(acc, W * 32);
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(empty + s);
    st_advance(s, ph, L.SLOTS);
  }

  // ------------------------------------------------------------- epilogue
  // dk or dv through the ring's first panels (every step is used), in the
  // swizzled layout of the store's tensor map; one thread stores each
  // 64-wide panel, keys past Tk and columns past D clipped
  hop::named_sync(1, 128);
  stage_rows<T, W>(acc, sm + L.RING, warp * 16 + g8, t4);
  hop::fence_async_smem();
  hop::named_sync(1, 128);
  if (tid == 0 && k0 < a.Tk) {
    for (int p = 0; p < W; ++p)
      hop::tma_store_4d(DK ? &maps.dk : &maps.dv, sm + L.RING + p * KV_PANEL,
                        (c0 + p) * 64, k0, h, b);
    hop::tma_store_commit_and_wait();
  }
}

template <typename T>
__global__ void __launch_bounds__(ST_THREADS, 1)
    wide_dkv_st(const __grid_constant__ Maps maps, const Args a) {
  const StSmem L(a.D);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = hop::smem_u32(smem_raw);
  unsigned char* sm = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L.BAR);
  uint64_t* empty = full + L.SLOTS;
  if (threadIdx.x == 0) {
    for (int s = 0; s < L.SLOTS; ++s) {
      hop::mbar_init(full + s, 32);
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
  const int h = blockIdx.y, b = blockIdx.z;
  if (j < nsl) {
    if (w == 4)
      walk_st<T, false, 4>(maps, a, sm, L, k0, c0, h, b);
    else
      walk_st<T, false, 3>(maps, a, sm, L, k0, c0, h, b);
  } else {
    if (w == 4)
      walk_st<T, true, 4>(maps, a, sm, L, k0, c0, h, b);
    else
      walk_st<T, true, 3>(maps, a, sm, L, k0, c0, h, b);
  }
}

// ------------------------------------------------------------------- host
template <typename T, int DP, int MODE = dkv_mode(DP)>
cudaError_t launch(const Args& a, const Maps& maps, cudaStream_t st) {
  using L = Smem<DP>;
  auto kern = wide_dkv_wg<T, DP, MODE>;
  const dim3 grid((a.Tk + KEYS - 1) / KEYS * Plan<DP, MODE>::NB, a.H, a.B);
  cudaError_t e = mxt::set_smem(kern, L::ALLOC);
  if (e != cudaSuccess) return e;
  kern<<<grid, 2 * 128, L::ALLOC, st>>>(maps, a);
  return cudaGetLastError();
}

// the streamed walk (D > 512): 2 ceil(P / 4) blocks a key block
template <typename T>
cudaError_t launch_st(const Args& a, const Maps& maps, cudaStream_t st) {
  const StSmem L(a.D);
  auto kern = wide_dkv_st<T>;
  const dim3 grid((a.Tk + KEYS - 1) / KEYS * 2 * st_slices(L.P), a.H, a.B);
  cudaError_t e = mxt::set_smem(kern, L.ALLOC);
  if (e != cudaSuccess) return e;
  kern<<<grid, ST_THREADS, L.ALLOC, st>>>(maps, a);
  return cudaGetLastError();
}

// q, k, v, dout read and dk, dv written by TMA
template <typename T>
cudaError_t dispatch(const Args& a, const long long* s, void* dk, void* dv,
                     cudaStream_t st) {
  const CUtensorMapDataType type = mxt::TmaType<T>::value;
  Maps maps;
  if (!mxt::make_map(&maps.q, type, a.q, a.D, a.Tq, a.H, a.B, s[2], s[1],
                     s[0], BQ) ||
      !mxt::make_map(&maps.k, type, a.k, a.D, a.Tk, a.H, a.B, s[5], s[4],
                     s[3], KEYS) ||
      !mxt::make_map(&maps.v, type, a.v, a.D, a.Tk, a.H, a.B, s[8], s[7],
                     s[6], KEYS) ||
      !mxt::make_map(&maps.dout, type, a.dout, a.D, a.Tq, a.H, a.B, s[11],
                     s[10], s[9], BQ) ||
      !mxt::make_map(&maps.dk, type, dk, a.D, a.Tk, a.H, a.B, s[17], s[16],
                     s[15], KEYS) ||
      !mxt::make_map(&maps.dv, type, dv, a.D, a.Tk, a.H, a.B, s[20], s[19],
                     s[18], KEYS))
    return cudaErrorInvalidValue;
  if (a.D > 512) return launch_st<T>(a, maps, st);
  if (a.D <= 320) return launch<T, 320>(a, maps, st);
  if (a.D <= 384) return launch<T, 384>(a, maps, st);
  if (a.D <= 448) return launch<T, 448>(a, maps, st);
  return launch<T, 512>(a, maps, st);
}

}  // namespace wdkv
}  // namespace

// The dk / dv kernel, with mxt_flash_wide_bwd's arguments (kind must be 2;
// strides of q, k, v, dout, dq, dk, dv as (batch, head, time) triples, then
// the bias's four; dq and ds unused), for 16-bit data (dtype 1 = bfloat16,
// 2 = float16) at D > 256. q, k, v, dout, dk and dv must be views
// TMA can address (16-byte aligned, strides of dimensions longer than 1
// multiples of 8 elements; the Python wrapper copies other operands).
// Returns cudaGetLastError(), or cudaErrorInvalidValue for arguments the
// kernel does not take.
extern "C" int mxt_flash_wide_wg_dkv(
    int kind, int dtype, const void* q, const void* k, const void* v,
    const void* dout, const float* bias, const float* lse, const float* delta,
    void* dq, void* dk, void* dv, float* ds, int B, int H, int Tq, int Tk,
    int D, const long long* strides, float scale, int causal,
    const int* seed, int dropout, unsigned int drop_threshold,
    float drop_scale, void* stream) {
  (void)dq;
  (void)ds;
  if (kind != 2 || dtype < 1 || dtype > 2 || D <= 256 || B < 1 ||
      H < 1 || Tq < 1 || Tk < 1 || B > 65535 || H > 65535 || !lse ||
      !delta || !dk || !dv || (dropout && !seed))
    return static_cast<int>(cudaErrorInvalidValue);
  wdkv::Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.bias = bias; a.lse = lse;
  a.delta = delta; a.seed = seed;
  a.B = B; a.H = H; a.Tq = Tq; a.Tk = Tk; a.D = D;
  a.b_sb = strides[21]; a.b_sh = strides[22]; a.b_sq = strides[23];
  a.b_sk = strides[24];
  a.scale = scale; a.causal = causal; a.dropout = dropout != 0;
  a.drop_threshold = drop_threshold; a.drop_scale = drop_scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return static_cast<int>(
        wdkv::dispatch<__nv_bfloat16>(a, strides, dk, dv, st));
  return static_cast<int>(wdkv::dispatch<__half>(a, strides, dk, dv, st));
}
