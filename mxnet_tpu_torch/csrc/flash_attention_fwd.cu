// Flash-attention forward for Hopper (sm_90a), bound through a plain C entry.
//
// Replaces: mxnet_tpu/ops/pallas/attention.py, _flash_fwd_kernel (launched
// by _flash_forward through pl.pallas_call). It computes the same function:
//   out = softmax(q k^T * scale + bias, masked) v,  f32 accumulation,
//   lse = m + log(max(l, 1e-30)) per query row, in f32,
// with the causal mask top-left aligned (col <= row, masked scores set to
// -1e30 as the TPU kernel does), an additive f32 bias broadcast over
// (1|B, 1|H, 1|Tq, Tk) through its strides, and any Tq and Tk: keys past Tk
// are excluded in the kernel, rows past Tq are computed and not stored, so
// the caller pads nothing. q, k, v and out are addressed through (batch,
// head, time) strides with a unit stride on the head dimension, so the
// (B, T, H, D) layout of a fused QKV projection is read where it lies.
//
// What bounds it on an H100: at BERT shapes (T <= 512, D = 64) the work is
// 4*T*T*D flops against 4*T*D*2 bytes per (batch, head), about T/2 flops a
// byte, below the card's ~295 flops per byte, so the floor is moving q, k, v
// and out once through HBM. Above that floor come the T*T exponentials
// (the special-function unit does 16 a cycle per SM, an eighth of the FMA
// rate), the rest of the softmax on the FMA pipe, and in each warpgroup the
// chain S -> softmax -> P V, whose latency only the other warpgroup hides
// (chip_smoke.py --probe-fwd times the kernel with each part cut out). The
// T x T scores never leave registers.
//
// Design (16-bit inputs): a block of three warpgroups owns 128 query rows
// of one (batch, head): two consumer warpgroups of 64 rows each, and a
// producer warpgroup of which one warp works and all four hand their
// registers to the consumers (setmaxnreg: 24 against 240 a thread, so the
// 128-key tiles fit). The producer loads the block's Q once and then
// streams tiles of K and V (128 keys, 64 at D = 256) by TMA
// (cp.async.bulk.tensor with the 128-byte swizzle) into a ring of 2-3
// stages on mbarriers: one thread issues every copy, and TMA's zero fill
// covers keys past Tk, rows past Tq and head dims past D. A key-padding
// bias row (bias broadcast over Tq) is staged into shared memory by the
// producer's 32 lanes beside each K tile, already in base-2 units. Each
// consumer warpgroup computes S = Q K^T with wgmma (Q and K both K-major
// from shared memory), the online softmax on S in registers with exp2 and
// scale * log2(e) folded into one FMA, and O += P V with wgmma, P as the
// register A operand (the S accumulator's layout is the A fragment's once
// packed to 16 bits) and V as the MN-major B operand. The output goes
// through shared memory (the warpgroup's Q slice, swizzled) to a TMA
// store, which drops rows past Tq and columns past D. Head dims are padded
// to DP in {64, 128, 256} (D <= 256). f32 inputs take the 3xTF32 forward
// of flash_attention_wide_wg.cu (flash_fwd_tf32).
//
// Probability dropout (training): the running denominator l sums the
// undropped probabilities, and the kept ones are scaled by 1 / (1 - rate)
// before p v, as in the TPU kernel; the keep bit of score (row, col) comes
// from philox.cuh, a pure function of (seed, batch, head, row, col) that the
// backward kernels and the plain version draw identically. One Philox call
// covers a 2 x 2 block of scores; the two threads holding rows 2i and 2i+1
// of a column pair each make one call and swap the words the other needs
// (mxt::dropout_row_pair, which the backward's dq kernel shares).
//
// Experiments: built with -DMXT_FWD_CUT=1 the softmax is cut (P = S, no
// rescale), =2 the copies after the first ring of stages are cut (the
// consumers read stale tiles), =3 the P V product is cut. The results are
// wrong; chip_smoke.py --probe-fwd times each beside the full kernel.
#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "hopper.cuh"
#include "philox.cuh"
#include "tma_host.cuh"

#ifndef MXT_FWD_CUT
#define MXT_FWD_CUT 0
#endif

namespace {

using mxt::Half;
using mxt::NEG_BIG;

constexpr int WG_ROWS = 64;            // query rows per consumer warpgroup
constexpr int ROWS = 2 * WG_ROWS;      // query rows per block
constexpr int THREADS = 3 * 128;  // two consumer warpgroups, a producer
constexpr int ROW_BYTES = 128;         // one swizzled row: 64 16-bit values
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float NEG2 = NEG_BIG * LOG2E;  // the masked score, base-2 units

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;
  void* o;
  float* lse;
  const int* seed;  // (2,) int32 Philox key on the device, or null
  int B, H, Tq, Tk, D;
  long long q_sb, q_sh, q_st;
  long long k_sb, k_sh, k_st;
  long long v_sb, v_sh, v_st;
  long long o_sb, o_sh, o_st;
  long long b_sb, b_sh, b_sq, b_sk;
  float scale;
  int causal;
  int dropout;              // probability dropout on
  uint32_t drop_threshold;  // keep iff Philox word >= this
  float drop_scale;         // 1 / (1 - rate)
};

// TMA descriptors of q, k, v (loads) and out (store), 4-d (d, t, h, b)
struct Maps {
  CUtensorMap q, k, v, o;
};

// Shared memory of one block, in bytes from a 1024-byte aligned base: Q
// (DP / 64 panels of 128 rows), the ring of K and V tiles (DP / 64 panels
// of KEYS keys each), the staged bias rows, the mbarriers.
template <int DP, int STAGES, int KEYS>
struct Smem {
  static constexpr int PANELS = DP / 64;
  static constexpr int Q_PANEL = ROWS * ROW_BYTES;
  static constexpr int KV_PANEL = KEYS * ROW_BYTES;
  static constexpr int Q_BYTES = PANELS * Q_PANEL;
  static constexpr int KV_BYTES = PANELS * KV_PANEL;
  static constexpr int K = Q_BYTES;
  static constexpr int V = K + STAGES * KV_BYTES;
  static constexpr int BIAS = V + STAGES * KV_BYTES;
  static constexpr int BAR = BIAS + STAGES * KEYS * 4;
  static constexpr int BYTES = BAR + (1 + 3 * STAGES) * 8;
  static constexpr int ALLOC = BYTES + 1024;  // room to align the base
};

// What a consumer thread knows about its rows: the two query rows ra and
// rb = ra + 8 of its accumulator fragments, its column pair 2 t4 in each
// 8-key chunk, whether its lane holds the odd row of each Philox row pair.
struct Rows {
  int ra, rb, t4, b, h;
  bool odd;
};

// The online softmax of one tile of S (KEYS keys at k0; element i of the
// fragment is row i & 2 ? rb : ra, key k0 + 8 (i / 4) + 2 t4 + (i & 1)):
// scale, bias (the staged row `sbias` or the full bias at bp) and masks in
// base-2 units, the running row max m and sum l, and the probabilities
// (dropped out as the TPU kernel drops them, after l took them) left in
// sc. Returns each row's rescale of the output, 2^(m_old - m_new).
template <int KEYS>
__device__ __forceinline__ float2 softmax_tile(
    float* sc, float* m, float* l, const Args& a, const Rows& w, int k0,
    const float* sbias, const float* bp, bool full_bias, uint2 key,
    float scale2) {
  // each variant one straight run of code (no branch per element)
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
    for (int i = 0; i < KEYS / 2; ++i) {
      const int r = (i & 2) ? w.rb : w.ra;
      const int col = k0 + (i >> 2) * 8 + 2 * w.t4 + (i & 1);
      const float bv = r < a.Tq && col < a.Tk
                           ? bp[r * a.b_sq + col * a.b_sk] * LOG2E : 0.f;
      sc[i] = fmaf(sc[i], scale2, bv);
    }
  } else {
#pragma unroll
    for (int i = 0; i < KEYS / 2; ++i) sc[i] *= scale2;
  }
  if (a.causal || k0 + KEYS > a.Tk) {
#pragma unroll
    for (int i = 0; i < KEYS / 2; ++i) {
      const int r = (i & 2) ? w.rb : w.ra;
      const int col = k0 + (i >> 2) * 8 + 2 * w.t4 + (i & 1);
      if (a.causal && col > r) sc[i] = NEG2;
      if (col >= a.Tk) sc[i] = -INFINITY;  // no such key
    }
  }
  // row max: four running maxima per row over this thread's KEYS / 4
  // values (short chains, few live values), their tree, then the four
  // threads sharing the row
  float mx[2][4];
#pragma unroll
  for (int j = 0; j < KEYS / 8; ++j) {
    const float v0 = fmaxf(sc[4 * j], sc[4 * j + 1]);
    const float v1 = fmaxf(sc[4 * j + 2], sc[4 * j + 3]);
    mx[0][j & 3] = j < 4 ? v0 : fmaxf(mx[0][j & 3], v0);
    mx[1][j & 3] = j < 4 ? v1 : fmaxf(mx[1][j & 3], v1);
  }
  float alpha[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float v = fmaxf(fmaxf(mx[i][0], mx[i][1]), fmaxf(mx[i][2], mx[i][3]));
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
    const float m_new = fmaxf(m[i], v);
    alpha[i] = hop::ex2(m[i] - m_new);
    m[i] = m_new;
  }
  // p = 2^(x - m); the row sums the same way, added to l
  float sum[2][4];
#pragma unroll
  for (int j = 0; j < KEYS / 8; ++j) {
    sc[4 * j] = hop::ex2(sc[4 * j] - m[0]);
    sc[4 * j + 1] = hop::ex2(sc[4 * j + 1] - m[0]);
    sc[4 * j + 2] = hop::ex2(sc[4 * j + 2] - m[1]);
    sc[4 * j + 3] = hop::ex2(sc[4 * j + 3] - m[1]);
    const float v0 = sc[4 * j] + sc[4 * j + 1];
    const float v1 = sc[4 * j + 2] + sc[4 * j + 3];
    sum[0][j & 3] = j < 4 ? v0 : sum[0][j & 3] + v0;
    sum[1][j & 3] = j < 4 ? v1 : sum[1][j & 3] + v1;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
    l[i] = fmaf(l[i], alpha[i],
                (sum[i][0] + sum[i][1]) + (sum[i][2] + sum[i][3]));
  if (a.dropout) {
#pragma unroll
    for (int j = 0; j < KEYS / 8; ++j) {
      uint32_t wd[4];
      mxt::dropout_row_pair(wd, key, w.b, w.h, w.ra, w.rb,
                            k0 + 8 * j + 2 * w.t4, w.odd);
      const uint32_t th = a.drop_threshold;
      const float ds = a.drop_scale;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[4 * j + e] = wd[e] >= th ? sc[4 * j + e] * ds : 0.f;
    }
  }
  return make_float2(alpha[0], alpha[1]);
}

// S = Q K^T of one tile into sc, one commit group: DP / 16 k16 steps from
// the warpgroup's swizzled Q slice (q_base) and the tile's K (k_base)
template <typename T, int DP, int STAGES, int KEYS>
__device__ __forceinline__ void issue_s(float* sc, uint32_t q_base,
                                        uint32_t k_base) {
  using L = Smem<DP, STAGES, KEYS>;
  hop::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t off = (kk & 3) * 32;
    hop::wgmma_ss<T, KEYS>(
        sc, hop::desc_kmajor_sw128(q_base + (kk >> 2) * L::Q_PANEL + off),
        hop::desc_kmajor_sw128(k_base + (kk >> 2) * L::KV_PANEL + off),
        kk > 0);
  }
  hop::wgmma_commit();
}

// P of one tile as the register A operand of O += P V: two adjacent 8-key
// chunks of S packed to 16 bits make the fragment of one k16 step
template <typename T, int KEYS>
__device__ __forceinline__ void pack_p(uint32_t (*pf)[4], const float* sc) {
#pragma unroll
  for (int kk = 0; kk < KEYS / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pf[kk][r] = Half<T>::pack(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
  }
}

// O += P V of one tile, one commit group (empty with the product cut); V
// MN-major at v_base
template <typename T, int DP, int STAGES, int KEYS>
__device__ __forceinline__ void issue_pv(float* o, const uint32_t (*pf)[4],
                                         uint32_t v_base) {
  using L = Smem<DP, STAGES, KEYS>;
  hop::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KEYS / 16; ++kk) {
    if (MXT_FWD_CUT != 3) {
      hop::wgmma_rs<T, DP, 1>(
          o, pf[kk],
          hop::desc_mnmajor_sw128(v_base + kk * 16 * ROW_BYTES, L::KV_PANEL),
          1);
    } else {  // P stays live, so the softmax is not cut with it
      asm volatile("" ::"r"(pf[kk][0]), "r"(pf[kk][1]), "r"(pf[kk][2]),
                   "r"(pf[kk][3]));
    }
  }
  hop::wgmma_commit();
}

template <typename T, int DP, int STAGES, int KEYS>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_wgmma(const __grid_constant__ Maps maps, const Args a) {
  using L = Smem<DP, STAGES, KEYS>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = hop::smem_u32(smem_raw);
  unsigned char* sm = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  uint64_t* full_q = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* full_k = full_q + 1;  // [STAGES]: K tile (and bias row) landed
  uint64_t* full_v = full_k + STAGES;  // [STAGES]: V tile landed
  uint64_t* empty = full_v + STAGES;   // [STAGES]: the 8 consumer warps done
  float* s_bias = reinterpret_cast<float*>(sm + L::BIAS);

  const int q0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31;
  int k_end = a.Tk;
  if (a.causal) k_end = min(k_end, q0 + ROWS);  // later tiles add nothing
  const int n_tiles = (k_end + KEYS - 1) / KEYS;
  const bool row_bias = a.bias != nullptr && a.b_sq == 0;

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
    const float* bp =
        row_bias ? a.bias + b * a.b_sb + h * a.b_sh : nullptr;
    if (lane == 0) {
      hop::mbar_expect(full_q, L::Q_BYTES);
      for (int p = 0; p < L::PANELS; ++p)
        hop::tma_load_4d(sm + p * L::Q_PANEL, &maps.q, full_q, p * 64, q0, h,
                         b);
    }
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % STAGES, k0 = it * KEYS;
      if (it >= STAGES) hop::mbar_wait(empty + s, ((it / STAGES) + 1) & 1);
      if (row_bias) {
        for (int j = lane; j < KEYS; j += 32) {
          const int col = k0 + j;
          s_bias[s * KEYS + j] = col < a.Tk ? bp[col * a.b_sk] * LOG2E : 0.f;
        }
      }
      if (lane != 0) {
        hop::mbar_arrive(full_k + s);
      } else if (MXT_FWD_CUT == 2 && it >= STAGES) {
        hop::mbar_arrive(full_k + s);
        hop::mbar_arrive(full_v + s);
      } else {
        unsigned char* kt = sm + L::K + s * L::KV_BYTES;
        unsigned char* vt = sm + L::V + s * L::KV_BYTES;
        hop::mbar_expect(full_k + s, L::KV_BYTES);
        for (int p = 0; p < L::PANELS; ++p)
          hop::tma_load_4d(kt + p * L::KV_PANEL, &maps.k, full_k + s, p * 64,
                           k0, h, b);
        hop::mbar_expect(full_v + s, L::KV_BYTES);
        for (int p = 0; p < L::PANELS; ++p)
          hop::tma_load_4d(vt + p * L::KV_PANEL, &maps.v, full_v + s, p * 64,
                           k0, h, b);
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = tid >> 7, warp = (tid >> 5) & 3;
  const int g = lane >> 2;
  Rows w;
  w.ra = q0 + wg * WG_ROWS + warp * 16 + g;
  w.rb = w.ra + 8;
  w.t4 = lane & 3;
  w.b = b;
  w.h = h;
  w.odd = (g & 1) != 0;
  const int ra = w.ra, rb = w.rb, t4 = w.t4;
  const uint2 key = a.dropout ? mxt::dropout_key(a.seed) : make_uint2(0, 0);
  const bool full_bias = a.bias != nullptr && a.b_sq != 0;
  const float* bp = a.bias ? a.bias + b * a.b_sb + h * a.b_sh : nullptr;
  const float scale2 = a.scale * LOG2E;
  const uint32_t q_base = hop::smem_u32(sm) + wg * WG_ROWS * ROW_BYTES;
  auto k_tile = [&](int it) {
    return hop::smem_u32(sm + L::K + (it % STAGES) * L::KV_BYTES);
  };
  auto v_tile = [&](int it) {
    return hop::smem_u32(sm + L::V + (it % STAGES) * L::KV_BYTES);
  };
  auto bias_row = [&](int it) {
    return row_bias ? s_bias + (it % STAGES) * KEYS : nullptr;
  };
  auto release = [&](int it) {  // tile it's K, V and bias are consumed
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(empty + it % STAGES);
  };

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float sc[KEYS / 2];
#pragma unroll
  for (int i = 0; i < KEYS / 2; ++i) sc[i] = 0.f;
  float m[2] = {NEG2, NEG2};  // running row max, base-2 units
  float l[2] = {0.f, 0.f};    // per-thread partial row sums
  uint32_t pf[KEYS / 16][4];  // P, the A operand of P V

  hop::mbar_wait(full_q, 0);
  for (int it = 0; it < n_tiles; ++it) {
    hop::mbar_wait(full_k + it % STAGES, (it / STAGES) & 1);
    issue_s<T, DP, STAGES, KEYS>(sc, q_base, k_tile(it));
    hop::wgmma_wait<0>();
    hop::fence_regs(sc, KEYS / 2);
    float2 alpha = make_float2(1.f, 1.f);
    if (MXT_FWD_CUT != 1)
      alpha = softmax_tile<KEYS>(sc, m, l, a, w, it * KEYS, bias_row(it), bp,
                                 full_bias, key, scale2);
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] *= (i & 2) ? alpha.y : alpha.x;
    pack_p<T, KEYS>(pf, sc);
    hop::mbar_wait(full_v + it % STAGES, (it / STAGES) & 1);
    issue_pv<T, DP, STAGES, KEYS>(o, pf, v_tile(it));
    hop::wgmma_wait<0>();
    hop::fence_regs(o, DP / 2);
    release(it);
  }

  // ------------------------------------------------------------- epilogue
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const float denom = fmaxf(l[i], 1e-30f);
    inv[i] = 1.f / denom;
    const int r = i ? rb : ra;
    if (t4 == 0 && r < a.Tq)
      a.lse[((long long)b * a.H + h) * a.Tq + r] = m[i] * LN2 + logf(denom);
  }
  // out through this warpgroup's Q slice, in the swizzled layout of the
  // store's tensor map; then one thread stores each 64-wide panel
  hop::named_sync(1 + wg, 128);  // the warpgroup's last read of Q is done
  unsigned char* os = sm + wg * WG_ROWS * ROW_BYTES;
  const int row = warp * 16 + g;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    unsigned char* panel = os + (j >> 3) * L::Q_PANEL;
    const int chunk = ((j & 7) ^ (row & 7)) * 16 + t4 * 4;
    *reinterpret_cast<uint32_t*>(panel + row * ROW_BYTES + chunk) =
        Half<T>::pack(o[4 * j] * inv[0], o[4 * j + 1] * inv[0]);
    *reinterpret_cast<uint32_t*>(panel + (row + 8) * ROW_BYTES + chunk) =
        Half<T>::pack(o[4 * j + 2] * inv[1], o[4 * j + 3] * inv[1]);
  }
  hop::fence_async_smem();
  hop::named_sync(1 + wg, 128);
  const int r0 = q0 + wg * WG_ROWS;
  if ((tid & 127) == 0 && r0 < a.Tq) {
    for (int p = 0; p < L::PANELS; ++p)
      hop::tma_store_4d(&maps.o, os + p * L::Q_PANEL, p * 64, r0, h, b);
    hop::tma_store_commit_and_wait();
  }
}

// ------------------------------------------------------------------ host
template <typename T, int DP, int STAGES, int KEYS>
cudaError_t launch_wgmma(const Args& a, const Maps& maps,
                         cudaStream_t stream) {
  const size_t smem = Smem<DP, STAGES, KEYS>::ALLOC;
  auto kern = flash_fwd_wgmma<T, DP, STAGES, KEYS>;
  cudaError_t e = mxt::set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.Tq + ROWS - 1) / ROWS, a.H, a.B);
  kern<<<grid, THREADS, smem, stream>>>(maps, a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_half(const Args& a, cudaStream_t stream) {
  const CUtensorMapDataType type = mxt::TmaType<T>::value;
  const int keys = a.D <= 128 ? 128 : 64;  // keys per K / V tile
  Maps maps;
  if (!mxt::make_map(&maps.q, type, a.q, a.D, a.Tq, a.H, a.B, a.q_st,
                     a.q_sh, a.q_sb, ROWS) ||
      !mxt::make_map(&maps.k, type, a.k, a.D, a.Tk, a.H, a.B, a.k_st,
                     a.k_sh, a.k_sb, keys) ||
      !mxt::make_map(&maps.v, type, a.v, a.D, a.Tk, a.H, a.B, a.v_st,
                     a.v_sh, a.v_sb, keys) ||
      !mxt::make_map(&maps.o, type, a.o, a.D, a.Tq, a.H, a.B, a.o_st,
                     a.o_sh, a.o_sb, WG_ROWS))
    return cudaErrorInvalidValue;
  if (a.D <= 64) return launch_wgmma<T, 64, 3, 128>(a, maps, stream);
  if (a.D <= 128) return launch_wgmma<T, 128, 2, 128>(a, maps, stream);
  return launch_wgmma<T, 256, 2, 64>(a, maps, stream);
}

}  // namespace

// dtype: 1 = bfloat16, 2 = float16 (float32 takes mxt_flash_wide_wg_fwd,
// the 3xTF32 forward of flash_attention_wide_wg.cu). strides (in elements):
// q (b, h, t), k (b, h, t), v (b, h, t), out (b, h, t), bias (b, h, q, k);
// the head dimension has unit stride everywhere, and every
// pointer is 16-byte aligned and every stride of a dimension longer than 1
// a multiple of 8 (what TMA can describe; the Python wrapper copies other
// operands). lse is (B, H, Tq) contiguous f32. bias is f32 or null. seed is
// the (2,) int32 dropout key on the device, read only when dropout != 0
// (keep iff the score's Philox word >= drop_threshold; kept probabilities
// are scaled by drop_scale). Returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments the kernels do not take.
extern "C" int mxt_flash_attention_fwd(int dtype, const void* q, const void* k,
                                       const void* v, const float* bias,
                                       void* out, float* lse, int B, int H,
                                       int Tq, int Tk, int D,
                                       const long long* strides, float scale,
                                       int causal, const int* seed,
                                       int dropout, unsigned int drop_threshold,
                                       float drop_scale, void* stream) {
  if (D < 1 || D > 256 || B < 1 || H < 1 || Tq < 1 || Tk < 1 || B > 65535 ||
      H > 65535 || (dropout && !seed))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q; a.k = k; a.v = v; a.bias = bias; a.o = out; a.lse = lse;
  a.B = B; a.H = H; a.Tq = Tq; a.Tk = Tk; a.D = D;
  a.q_sb = strides[0]; a.q_sh = strides[1]; a.q_st = strides[2];
  a.k_sb = strides[3]; a.k_sh = strides[4]; a.k_st = strides[5];
  a.v_sb = strides[6]; a.v_sh = strides[7]; a.v_st = strides[8];
  a.o_sb = strides[9]; a.o_sh = strides[10]; a.o_st = strides[11];
  a.b_sb = strides[12]; a.b_sh = strides[13]; a.b_sq = strides[14];
  a.b_sk = strides[15];
  a.scale = scale; a.causal = causal;
  a.seed = seed; a.dropout = dropout != 0;
  a.drop_threshold = drop_threshold; a.drop_scale = drop_scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1:
      return static_cast<int>(dispatch_half<__nv_bfloat16>(a, st));
    case 2:
      return static_cast<int>(dispatch_half<__half>(a, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
