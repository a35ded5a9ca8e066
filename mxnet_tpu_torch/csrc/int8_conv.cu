// int8 x int8 -> int32 convolution (and fully connected layer) for Hopper
// (sm_90a), bound through a plain C entry: one implicit-GEMM kernel on the
// int8 tensor cores.
//
// Counterpart of mxnet_tpu/ops/quantization.py quantized_conv (:203-255)
// and quantized_fully_connected (:157-200), which hand int8 operands to
// lax.conv_general_dilated / lax.dot_general with preferred_element_type
// int32 so that XLA runs them on the TPU's int8 matrix unit. The JAX package
// writes no Pallas kernel for them, so none is replaced. PyTorch has no int8
// convolution on the card, and f32 arithmetic stops being exact once a sum
// passes 2^24 (ResNet-50's 3x3x512 convolution reaches 4608 * 127^2), so
// the port computes them here, exactly:
//   y[m, g*Og + n] = sum_k A[m, k] * Wt[g*Og + n, k]  (+ bias[g*Og + n])
// m an output position (image, od, oh, ow), k a tap and input channel of
// group g in the order (kd, kh, kw, c), int32 accumulation (as the JAX op,
// wrapping on overflow, which |acc| <= K * 127^2 < 2^31 rules out for
// K < 133144).
//
// Operands (ops/cuda/int8_conv.py prepares them): x channels-last (N, D, H,
// W, C) int8, contiguous (1-d and 2-d inputs have D = H = 1 or D = 1);
// the weight packed (O, Kp) int8, row o holding output channel o's K taps in
// the order above, zero-padded to Kp, a multiple of 16; bias int32 (O,) or
// none; y (M, O) int32, channels-last: the caller views it in its layout.
//
// Bound: operations at ResNet-50's shapes (2 M N K int8 operations against
// ~ (M K + N K + 4 M N) bytes), bytes for the FC layer at small batch. This
// first kernel is the simple, exact one: mma.sync m16n8k32 s8 tiles (not
// wgmma), fed by a 3-stage cp.async ring. A block computes a 128 x BN tile
// (BN 64 or 128 by the group's output channels) with 8 warps of 64 x BN/4;
// each stage holds a 128 x 64 slab of A (gathered from x, zero where a tap
// falls in the padding) and a BN x 64 slab of the weight, rows padded to 80
// bytes so the fragments' 32-bit reads hit 32 distinct banks. Where every
// 16 bytes of a k slab are 16 channels of one tap (Cg % 16 == 0 and x
// 16-byte aligned) A is copied by cp.async 16 bytes at a time; otherwise
// (conv1's C = 3, odd groups) byte by byte through registers. A thread
// keeps the tap of its next chunk and steps it along, so the main loop
// divides nothing. The bias is added in the epilogue. No host
// synchronization: a CUDA graph captures it.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace i8 {

constexpr int BM = 128;
constexpr int BK = 64;
constexpr int ROW = BK + 16;      // bytes a shared-memory row (80)
constexpr int STAGES = 3;
constexpr int THREADS = 256;

struct Params {
  const int8_t* x;
  const int8_t* w;
  const int* bias;
  int* y;
  int D, H, W, C;
  int OD, OH, OW, O;
  int KD, KH, KW;
  int sd, sh, sw, pd, ph, pw, dd, dh, dw;
  int Cg, Og, K, Kp;
  long long M;
};

template <int BN>
constexpr int smem_bytes() {
  return STAGES * (BM + BN) * ROW;
}

__device__ __forceinline__ void mma(int* c, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One A row of the thread (an output position): its image's base in x and
// the input coordinates of its (0, 0, 0) tap.
struct RowPos {
  const int8_t* img;
  int id0, ih0, iw0;
  bool ok;
};

__device__ __forceinline__ RowPos row_pos(const Params& p, long long m) {
  RowPos r;
  r.ok = m < p.M;
  if (!r.ok) m = 0;
  const int ow = static_cast<int>(m % p.OW);
  long long t = m / p.OW;
  const int oh = static_cast<int>(t % p.OH);
  t /= p.OH;
  const int od = static_cast<int>(t % p.OD);
  t /= p.OD;
  r.img = p.x + t * static_cast<long long>(p.D) * p.H * p.W * p.C;
  r.id0 = od * p.sd - p.pd;
  r.ih0 = oh * p.sh - p.ph;
  r.iw0 = ow * p.sw - p.pw;
  return r;
}

// The tap (kd, kh, kw) and channel c of reduction index k of a group.
struct Tap {
  int kd, kh, kw, c;
};

__device__ __forceinline__ Tap tap_of(const Params& p, int k) {
  Tap t;
  t.c = k % p.Cg;
  int r = k / p.Cg;
  t.kw = r % p.KW;
  r /= p.KW;
  t.kh = r % p.KH;
  t.kd = r / p.KH;
  return t;
}

// t moved on by n reduction indices (n >= 0), without a division
__device__ __forceinline__ void advance(const Params& p, Tap& t, int n) {
  t.c += n;
  while (t.c >= p.Cg) {
    t.c -= p.Cg;
    if (++t.kw == p.KW) {
      t.kw = 0;
      if (++t.kh == p.KH) {
        t.kh = 0;
        ++t.kd;
      }
    }
  }
}

// x's byte offset of row r's tap t in group g, or -1 in the padding
__device__ __forceinline__ long long x_offset(const Params& p,
                                              const RowPos& r, const Tap& t,
                                              int g) {
  const int id = r.id0 + t.kd * p.dd;
  const int ih = r.ih0 + t.kh * p.dh;
  const int iw = r.iw0 + t.kw * p.dw;
  if (!r.ok || id < 0 || id >= p.D || ih < 0 || ih >= p.H || iw < 0 ||
      iw >= p.W)
    return -1;
  return ((static_cast<long long>(id) * p.H + ih) * p.W + iw) * p.C +
         g * p.Cg + t.c;
}

// A's 16-byte chunk q of k tile k0 for the thread's two rows into stage
// buffer As (rows row0 and row0 + 64); tap: reduction index k0 + q * 16's.
template <bool VEC>
__device__ __forceinline__ void load_a(const Params& p, const RowPos* rows,
                                       int row0, int q, int k0, int g,
                                       const Tap& tap, uint8_t* As) {
  const int k = k0 + q * 16;
  if (VEC) {
    const bool kin = k < p.K;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const long long off = kin ? x_offset(p, rows[i], tap, g) : -1;
      hop::cp16(As + (row0 + i * 64) * ROW + q * 16,
                off >= 0 ? rows[i].img + off : p.x, off >= 0);
    }
  } else {
    uint32_t v[2][4] = {};
    if (k < p.K) {
      Tap t = tap;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (k + j >= p.K) break;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const long long off = x_offset(p, rows[i], t, g);
          if (off >= 0)
            v[i][j >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(
                                rows[i].img[off]))
                            << ((j & 3) * 8);
        }
        advance(p, t, 1);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<uint4*>(As + (row0 + i * 64) * ROW + q * 16) =
          make_uint4(v[i][0], v[i][1], v[i][2], v[i][3]);
  }
}

// The weight's 16-byte chunks of k tile k0 for output channels n0.. of
// group g into stage buffer Bs (zero past the group's channels).
template <int BN>
__device__ __forceinline__ void load_b(const Params& p, int n0, int k0,
                                       int g, uint8_t* Bs) {
#pragma unroll
  for (int i = 0; i < BN * 4 / THREADS; ++i) {
    const int c = threadIdx.x + i * THREADS;
    const int row = c >> 2, q = c & 3;
    const int n = n0 + row, k = k0 + q * 16;
    const bool ok = n < p.Og && k < p.Kp;
    hop::cp16(Bs + row * ROW + q * 16,
              ok ? p.w + static_cast<long long>(g * p.Og + n) * p.Kp + k
                 : p.w,
              ok);
  }
}

template <int BN, bool VEC>
__global__ void __launch_bounds__(THREADS) conv_s8(Params p) {
  constexpr int NT = BN / 32;     // n8 tiles a warp
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* As = smem;
  uint8_t* Bs = smem + STAGES * BM * ROW;
  const int g = blockIdx.z;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int gr = lane >> 2, tg = lane & 3;

  const int row0 = tid >> 2, q = tid & 3;
  RowPos rows[2] = {row_pos(p, m0 + row0), row_pos(p, m0 + row0 + 64)};
  Tap tap = tap_of(p, q * 16);     // of the next k tile the thread loads

  int acc[4][NT][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < NT; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0;

  const int KT = (p.K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) {
      load_a<VEC>(p, rows, row0, q, s * BK, g, tap, As + s * BM * ROW);
      load_b<BN>(p, n0, s * BK, g, Bs + s * BN * ROW);
      advance(p, tap, BK);
    }
    hop::cp_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    hop::cp_wait<STAGES - 2>();
    __syncthreads();
    const int nk = kt + STAGES - 1;
    if (nk < KT) {
      const int s = nk % STAGES;
      load_a<VEC>(p, rows, row0, q, nk * BK, g, tap, As + s * BM * ROW);
      load_b<BN>(p, n0, nk * BK, g, Bs + s * BN * ROW);
      advance(p, tap, BK);
    }
    hop::cp_commit();
    const uint8_t* a_s = As + (kt % STAGES) * BM * ROW;
    const uint8_t* b_s = Bs + (kt % STAGES) * BN * ROW;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[4][4], bf[NT][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const uint8_t* r = a_s + (wm * 64 + mt * 16 + gr) * ROW + kk + tg * 4;
        af[mt][0] = *reinterpret_cast<const uint32_t*>(r);
        af[mt][1] = *reinterpret_cast<const uint32_t*>(r + 8 * ROW);
        af[mt][2] = *reinterpret_cast<const uint32_t*>(r + 16);
        af[mt][3] = *reinterpret_cast<const uint32_t*>(r + 8 * ROW + 16);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint8_t* r =
            b_s + (wn * NT * 8 + nt * 8 + gr) * ROW + kk + tg * 4;
        bf[nt][0] = *reinterpret_cast<const uint32_t*>(r);
        bf[nt][1] = *reinterpret_cast<const uint32_t*>(r + 16);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma(acc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
    }
  }
  hop::cp_wait<0>();

  // a thread's two neighbouring outputs as one 8-byte store where they are
  // 8-byte aligned (O and Og even): a warp then writes whole 32-byte runs
  const bool pairs = ((p.O | p.Og) & 1) == 0;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long m = m0 + wm * 64 + mt * 16 + gr + h * 8;
      if (m >= p.M) continue;
      int* yr = p.y + m * p.O + g * p.Og;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = n0 + wn * NT * 8 + nt * 8 + tg * 2;
        uint32_t v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[e] = static_cast<uint32_t>(acc[mt][nt][h * 2 + e]);
          if (p.bias && n + e < p.Og)
            v[e] += static_cast<uint32_t>(p.bias[g * p.Og + n + e]);
        }
        if (pairs && n + 1 < p.Og) {
          *reinterpret_cast<int2*>(yr + n) =
              make_int2(static_cast<int>(v[0]), static_cast<int>(v[1]));
        } else {
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (n + e < p.Og) yr[n + e] = static_cast<int>(v[e]);
        }
      }
    }
  }
}

template <int BN, bool VEC>
cudaError_t launch(const Params& p, int G, cudaStream_t stream) {
  static bool sized = false;    // the attribute is set once a process
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv_s8<BN, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes<BN>());
    if (e != cudaSuccess) return e;
    sized = true;
  }
  const dim3 grid(static_cast<unsigned>((p.M + BM - 1) / BM),
                  (p.Og + BN - 1) / BN, G);
  conv_s8<BN, VEC><<<grid, THREADS, smem_bytes<BN>(), stream>>>(p);
  return cudaGetLastError();
}

}  // namespace i8

// x (N, D, H, W, C) int8; w (O, Kp) int8, K = KD * KH * KW * C / G taps a
// row, zero-padded to Kp (a multiple of 16, 16-byte aligned rows); bias
// (O,) int32 or null; y (N * OD * OH * OW, O) int32. vec: C / G is a
// multiple of 16 and x 16-byte aligned (A read 16 bytes at a time); bn: 64
// or 128 output channels a block. Returns cudaGetLastError() after the
// launch.
extern "C" int mxt_int8_conv(const void* x, const void* w, const void* bias,
                             void* y, int N, int D, int H, int W, int C,
                             int OD, int OH, int OW, int O, int KD, int KH,
                             int KW, int sd, int sh, int sw, int pd, int ph,
                             int pw, int dd, int dh, int dw, int G, int Kp,
                             int vec, int bn, void* stream) {
  if (!x || !w || !y || N < 1 || D < 1 || H < 1 || W < 1 || C < 1 ||
      OD < 1 || OH < 1 || OW < 1 || O < 1 || KD < 1 || KH < 1 || KW < 1 ||
      G < 1 || G > 65535 || C % G || O % G || Kp % 16 ||
      (bn != 64 && bn != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  i8::Params p{static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
               static_cast<const int*>(bias), static_cast<int*>(y),
               D, H, W, C, OD, OH, OW, O, KD, KH, KW, sd, sh, sw, pd, ph, pw,
               dd, dh, dw, C / G, O / G, KD * KH * KW * (C / G), Kp,
               static_cast<long long>(N) * OD * OH * OW};
  if (p.K > Kp || (vec && p.Cg % 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (bn == 64)
    e = vec ? i8::launch<64, true>(p, G, s) : i8::launch<64, false>(p, G, s);
  else
    e = vec ? i8::launch<128, true>(p, G, s) : i8::launch<128, false>(p, G, s);
  return static_cast<int>(e);
}
