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
// and out once through HBM. The design keeps the T x T scores in registers
// (never in device memory): one block of 4 warps owns 64 query rows of one
// (batch, head); it walks over 64-key tiles of K and V, double-buffered in
// shared memory through cp.async so the next tile's loads overlap this
// tile's products; it holds the running row max and denominator in
// registers, and computes both products on the tensor cores with mma.sync
// m16n8k16 (bf16 or fp16 in, f32 accumulate). The probabilities go from the
// score accumulators straight into the A operand of the second product, and
// V's B operand comes out of its row-major tile through ldmatrix.trans.
// Causal blocks stop at the diagonal tile. f32 inputs take a plain FMA
// kernel with the same online-softmax recurrence. TMA, wgmma, warp
// specialisation and skipping fully masked key tiles are left for later.
//
// Probability dropout (training): the running denominator l sums the
// undropped probabilities, and the kept ones are scaled by 1 / (1 - rate)
// before p v, as in the TPU kernel; the keep bit of score (row, col) comes
// from philox.cuh, a pure function of (seed, batch, head, row, col) that the
// backward kernels and the plain version draw identically.
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "philox.cuh"

namespace {

using mxt::BM;
using mxt::BN;
using mxt::Half;
using mxt::NEG_BIG;
using mxt::PAD;

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
  int vec;  // 16-byte loads allowed (aligned pointers, strides % 8, D % 8)
  int dropout;              // probability dropout on
  uint32_t drop_threshold;  // keep iff Philox word >= this
  float drop_scale;         // 1 / (1 - rate)
};

template <typename T, int DP>
__global__ void __launch_bounds__(128) flash_fwd_mma(Args a) {
  constexpr int QS = DP + PAD;  // row stride of every tile
  constexpr int TILE = BN * QS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* sQ = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* sK = sQ + BM * QS;   // two K tiles
  uint16_t* sV = sK + 2 * TILE;  // two V tiles, row-major

  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const bool vec = a.vec != 0;
  const uint2 key = a.dropout ? mxt::dropout_key(a.seed) : make_uint2(0, 0);

  const uint16_t* qp = static_cast<const uint16_t*>(a.q) + b * a.q_sb + h * a.q_sh;
  const uint16_t* kp = static_cast<const uint16_t*>(a.k) + b * a.k_sb + h * a.k_sh;
  const uint16_t* vp = static_cast<const uint16_t*>(a.v) + b * a.v_sb + h * a.v_sh;
  const float* bp = a.bias ? a.bias + b * a.b_sb + h * a.b_sh : nullptr;

  int k_end = a.Tk;
  if (a.causal) k_end = min(k_end, q0 + BM);  // tiles past the diagonal add nothing
  const int n_tiles = (k_end + BN - 1) / BN;

  mxt::load_rows<BM, DP, QS>(sQ, qp, a.q_st, q0, a.Tq, a.D, vec);
  mxt::stage_rows<BN, DP, QS>(sK, kp, a.k_st, 0, a.Tk, a.D, vec);
  mxt::stage_rows<BN, DP, QS>(sV, vp, a.v_st, 0, a.Tk, a.D, vec);
  mxt::cp_async_commit();
  __syncthreads();

  // this warp's 16 query rows as mma A fragments, for every 16-wide d step
  const int wr = warp * 16;
  uint32_t qf[DP / 16][4];
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const int c = kk * 16 + t4 * 2;
    qf[kk][0] = *reinterpret_cast<const uint32_t*>(&sQ[(wr + g) * QS + c]);
    qf[kk][1] = *reinterpret_cast<const uint32_t*>(&sQ[(wr + g + 8) * QS + c]);
    qf[kk][2] = *reinterpret_cast<const uint32_t*>(&sQ[(wr + g) * QS + c + 8]);
    qf[kk][3] = *reinterpret_cast<const uint32_t*>(&sQ[(wr + g + 8) * QS + c + 8]);
  }

  const int row[2] = {q0 + wr + g, q0 + wr + g + 8};
  float m[2] = {NEG_BIG, NEG_BIG};
  float l[2] = {0.f, 0.f};  // per-thread partial row sums
  float o[DP / 8][4];
#pragma unroll
  for (int nd = 0; nd < DP / 8; ++nd)
    o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BN;
    const uint16_t* cK = sK + (it & 1) * TILE;
    const uint16_t* cV = sV + (it & 1) * TILE;
    // the next tile streams in while this one is computed
    if (it + 1 < n_tiles) {
      mxt::stage_rows<BN, DP, QS>(sK + ((it + 1) & 1) * TILE, kp, a.k_st,
                                  k0 + BN, a.Tk, a.D, vec);
      mxt::stage_rows<BN, DP, QS>(sV + ((it + 1) & 1) * TILE, vp, a.v_st,
                                  k0 + BN, a.Tk, a.D, vec);
    }
    mxt::cp_async_commit();
    mxt::cp_async_wait<1>();  // this thread's copies of tile `it` have landed
    __syncthreads();          // and everyone's

    float s[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        const uint16_t* kr = &cK[(nt * 8 + g) * QS + kk * 16 + t4 * 2];
        uint32_t bf[2] = {*reinterpret_cast<const uint32_t*>(kr),
                          *reinterpret_cast<const uint32_t*>(kr + 8)};
        Half<T>::mma(s[nt], qf[kk], bf);
      }
    }

    // scale, bias, masks; then the online-softmax update per row
    float mx[2] = {NEG_BIG, NEG_BIG};
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row[e >> 1];
        const int col = k0 + nt * 8 + t4 * 2 + (e & 1);
        float x = s[nt][e] * a.scale;
        if (col >= a.Tk) {
          x = -INFINITY;  // no such key
        } else {
          if (bp && r < a.Tq) x += bp[r * a.b_sq + col * a.b_sk];
          if (a.causal && col > r) x = NEG_BIG;
        }
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = __expf(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(s[nt][e] - m[e >> 1]);
        s[nt][e] = p;
        l[e >> 1] += p;
      }
    }
    // probability dropout after l took the undropped p, as the TPU kernel
    if (a.dropout) {
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        const int col = k0 + nt * 8 + t4 * 2;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const uint4 w = mxt::dropout_words(key, b, h, row[i], col);
          s[nt][2 * i] = mxt::dropout_word(w, row[i], col) >= a.drop_threshold
                             ? s[nt][2 * i] * a.drop_scale : 0.f;
          s[nt][2 * i + 1] =
              mxt::dropout_word(w, row[i], col + 1) >= a.drop_threshold
                  ? s[nt][2 * i + 1] * a.drop_scale : 0.f;
        }
      }
    }
#pragma unroll
    for (int nd = 0; nd < DP / 8; ++nd) {
      o[nd][0] *= alpha[0];
      o[nd][1] *= alpha[0];
      o[nd][2] *= alpha[1];
      o[nd][3] *= alpha[1];
    }

    // o += p v: the score accumulators of two adjacent 8-key tiles are the
    // A fragment of one 16-key step
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t pf[4] = {Half<T>::pack(s[2 * kk][0], s[2 * kk][1]),
                        Half<T>::pack(s[2 * kk][2], s[2 * kk][3]),
                        Half<T>::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                        Half<T>::pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      // B operands of two 8-wide d tiles at once, transposed out of the
      // row-major V tile
#pragma unroll
      for (int nd = 0; nd < DP / 8; nd += 2) {
        uint32_t bf[4];
        mxt::ldmatrix_b_trans<QS>(bf, cV, kk * 16, nd * 8, lane);
        Half<T>::mma(o[nd], pf, bf);
        Half<T>::mma(o[nd + 1], pf, bf + 2);
      }
    }
    __syncthreads();  // buffer it & 1 is refilled with tile it + 2
  }

  uint16_t* op = static_cast<uint16_t*>(a.o) + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const float denom = fmaxf(l[i], 1e-30f);
    const int r = row[i];
    if (r < a.Tq) {
      const float inv = 1.f / denom;
#pragma unroll
      for (int nd = 0; nd < DP / 8; ++nd) {
        const int c = nd * 8 + t4 * 2;
        const uint32_t pk = Half<T>::pack(o[nd][2 * i] * inv, o[nd][2 * i + 1] * inv);
        if (c < a.D) op[r * a.o_st + c] = static_cast<uint16_t>(pk & 0xffffu);
        if (c + 1 < a.D) op[r * a.o_st + c + 1] = static_cast<uint16_t>(pk >> 16);
      }
      if (t4 == 0)
        a.lse[((long long)b * a.H + h) * a.Tq + r] = m[i] + logf(denom);
    }
  }
}

// f32 inputs: two threads per query row, each owning half of the head
// dimension; K and V tiles staged in shared memory; one key at a time
// through the same online-softmax recurrence.
template <int DP>
__global__ void __launch_bounds__(2 * BM) flash_fwd_f32(Args a) {
  constexpr int HD = DP / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);  // [BN][DP]
  float* sV = sK + BN * DP;                        // [BN][DP]

  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, half = tid & 1;
  const int r = q0 + (tid >> 1);
  const int d0 = half * HD;
  const uint2 key = a.dropout ? mxt::dropout_key(a.seed) : make_uint2(0, 0);

  const float* qp = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kp = static_cast<const float*>(a.k) + b * a.k_sb + h * a.k_sh;
  const float* vp = static_cast<const float*>(a.v) + b * a.v_sb + h * a.v_sh;
  const float* bp = a.bias ? a.bias + b * a.b_sb + h * a.b_sh : nullptr;

  float qr[HD], acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    qr[d] = (r < a.Tq && d0 + d < a.D) ? qp[r * a.q_st + d0 + d] : 0.f;
    acc[d] = 0.f;
  }
  float m = NEG_BIG, l = 0.f;

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
      float part = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) part += qr[d] * sK[j * DP + d0 + d];
      float x = (part + __shfl_xor_sync(0xffffffffu, part, 1)) * a.scale;
      const int col = k0 + j;
      if (bp && r < a.Tq) x += bp[r * a.b_sq + col * a.b_sk];
      if (a.causal && col > r) x = NEG_BIG;
      const float m_new = fmaxf(m, x);
      const float alpha = expf(m - m_new);
      float p = expf(x - m_new);
      l = l * alpha + p;
      m = m_new;
      if (a.dropout)
        p = mxt::dropout_keep(key, b, h, r, col, a.drop_threshold)
                ? p * a.drop_scale : 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] = acc[d] * alpha + p * sV[j * DP + d0 + d];
    }
  }
  if (r < a.Tq) {
    const float denom = fmaxf(l, 1e-30f);
    float* op = static_cast<float*>(a.o) + b * a.o_sb + h * a.o_sh;
#pragma unroll
    for (int d = 0; d < HD; ++d)
      if (d0 + d < a.D) op[r * a.o_st + d0 + d] = acc[d] / denom;
    if (half == 0) a.lse[((long long)b * a.H + h) * a.Tq + r] = m + logf(denom);
  }
}

template <typename K>
cudaError_t launch(K kern, const Args& a, int threads, size_t smem,
                   cudaStream_t stream) {
  cudaError_t e = mxt::set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.Tq + BM - 1) / BM, a.H, a.B);
  kern<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_half(const Args& a, cudaStream_t stream) {
  const size_t smem = sizeof(uint16_t) * (BM + 4 * BN) * (DP + PAD);
  return launch(flash_fwd_mma<T, DP>, a, 128, smem, stream);
}

template <int DP>
cudaError_t launch_f32(const Args& a, cudaStream_t stream) {
  return launch(flash_fwd_f32<DP>, a, 2 * BM, sizeof(float) * 2 * BN * DP,
                stream);
}

template <typename T>
cudaError_t dispatch_half(const Args& a, cudaStream_t stream) {
  if (a.D <= 32) return launch_half<T, 32>(a, stream);
  if (a.D <= 64) return launch_half<T, 64>(a, stream);
  return launch_half<T, 128>(a, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. strides (in elements):
// q (b, h, t), k (b, h, t), v (b, h, t), out (b, h, t), bias (b, h, q, k);
// the head dimension has unit stride everywhere. lse is (B, H, Tq)
// contiguous f32. bias is f32 or null. seed is the (2,) int32 dropout key
// on the device, read only when dropout != 0 (keep iff the score's Philox
// word >= drop_threshold; kept probabilities are scaled by drop_scale).
// Returns cudaGetLastError().
extern "C" int mxt_flash_attention_fwd(int dtype, const void* q, const void* k,
                                       const void* v, const float* bias,
                                       void* out, float* lse, int B, int H,
                                       int Tq, int Tk, int D,
                                       const long long* strides, float scale,
                                       int causal, int vec, const int* seed,
                                       int dropout, unsigned int drop_threshold,
                                       float drop_scale, void* stream) {
  if (D < 1 || D > 128 || B < 1 || H < 1 || Tq < 1 || Tk < 1 || B > 65535 ||
      H > 65535)
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
  a.scale = scale; a.causal = causal; a.vec = vec;
  a.seed = seed; a.dropout = dropout != 0 && seed != nullptr;
  a.drop_threshold = drop_threshold; a.drop_scale = drop_scale;
  if (dropout && !seed) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      if (D <= 32) return static_cast<int>(launch_f32<32>(a, st));
      if (D <= 64) return static_cast<int>(launch_f32<64>(a, st));
      return static_cast<int>(launch_f32<128>(a, st));
    case 1:
      return static_cast<int>(dispatch_half<__nv_bfloat16>(a, st));
    case 2:
      return static_cast<int>(dispatch_half<__half>(a, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
