// Prologue-fused 1x1 convolution for Hopper (sm_90a), bound through plain C
// entries.
//
// Replaces: mxnet_tpu/ops/pallas/conv_fused.py, _fwd_kernel, _dgrad_kernel and
// _wgrad_kernel (launched by _fwd, _dgrad and _wgrad through pl.pallas_call).
// Over NCHW data flattened to x (N, Ci, M), M = H*W the contiguous axis, with
// f(x) = relu(x * scale + shift) per input channel (the BatchNorm apply; the
// affine part is optional, and so is the ReLU), they compute the same functions:
//   fwd:   y[n]  = W @ f(x[n]) + bias                  (N, Co, M) in x's dtype
//   dgrad: da[n] = (W^T @ dy[n]) * [x*scale+shift > 0]  (N, Ci, M) in f32
//   wgrad: dW    = sum_n dy[n] @ f(x[n])^T              (Co, Ci) in W's dtype
// The activated tensor f(x) never exists in device memory: fwd and wgrad apply
// f to each x tile between its load and its store to shared memory, and dgrad
// recomputes the ReLU mask from x in its epilogue.
//
// What bounds them on an H100: at ResNet-50's junctions the work is 2*Co*Ci
// flops per (n, m) against (Ci + Co) * 2 bytes moved, fewer than 300 flops a
// byte for every shape of the network, so the floor is moving x, dy and y once
// through HBM; the kernels keep f(x) and the ReLU mask out of HBM for that
// reason. The design is a simple tiled GEMM: one block of 4 warps computes a
// 64 x 64 output tile, each warp 32 x 32 on mma.sync m16n8k16 (bf16 or fp16
// in, f32 accumulate), the operand tiles double-buffered in shared memory
// (cp.async for the tiles that need no prologue, a register stage for the x
// tiles that do). No transposes in memory: fwd reads the M-contiguous f(x)
// tile as its B operand through ldmatrix.trans; dgrad reads W^T out of W's
// rows through ldmatrix.trans; wgrad contracts over M, which is contiguous in
// both dy and x. Ragged edges (M = 49, 196; channels that do not fill a tile)
// are zero-filled on load and masked on store, so the caller pads nothing and
// no lane past the end of a row enters a sum. wgrad splits the N*M reduction
// over blocks (its output is small: 64 x 256 is four tiles for 132 SMs), each
// split writing f32 partial sums that a second pass adds in a fixed order, so
// dW is the same from run to run. f32 inputs take FMA kernels: exact f32
// products, no TF32, as the TPU kernels use Precision.HIGHEST for f32. wgmma,
// TMA and warp specialisation are left for later.
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using mxt::Half;
using mxt::PAD;

constexpr int TM = 64;       // output rows per block
constexpr int TN = 64;       // output columns per block
constexpr int THREADS = 128;  // 4 warps, each a 32 x 32 quarter of the tile
constexpr int BK16 = 32;     // contraction depth per step, 16-bit kernels
constexpr int BK32 = 16;     // contraction depth per step, f32 kernels

struct Args {
  const void* x;      // (N, Ci, M)
  const void* w;      // (Co, Ci)
  const void* dy;     // (N, Co, M)
  const float* scale;  // (Ci,) or null: no affine part
  const float* shift;  // (Ci,)
  const float* bias;   // (Co,) or null
  void* out;
  float* ws;           // wgrad: (splits, Co, Ci) f32 partial sums
  int N, Ci, Co, M;
  int relu;
  int vec_x;   // 16-byte loads of x rows: 16-bit, M % 8 == 0, aligned
  int vec_w;   // 16-byte loads of W rows: 16-bit, Ci % 8 == 0, aligned
  int vec_dy;  // 16-byte loads of dy rows: 16-bit, M % 8 == 0, aligned
  int splits;  // wgrad: blocks along the N*M reduction
  int per;     // wgrad: reduction steps per split
};

template <typename T> __device__ __forceinline__ float to_f32(uint16_t b);
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(uint16_t b) {
  return __uint_as_float(static_cast<uint32_t>(b) << 16);
}
template <> __device__ __forceinline__ float to_f32<__half>(uint16_t b) {
  return __half2float(__ushort_as_half(b));
}

// x * scale + shift, rounded after the product and after the sum (no fused
// multiply-add), as the plain version computes it, so the ReLU mask of dgrad
// agrees with it bit for bit
__device__ __forceinline__ float affine(float x, const float* scale,
                                        const float* shift, int c) {
  return scale ? __fadd_rn(__fmul_rn(x, scale[c]), shift[c]) : x;
}

// f(x): the affine part, then the ReLU (NaN passes through, as torch.relu)
__device__ __forceinline__ float prologue(float x, const float* scale,
                                          const float* shift, int c,
                                          bool relu) {
  const float a = affine(x, scale, shift, c);
  return (relu && a < 0.f) ? 0.f : a;
}

// An R x C tile of x (rows are channels, columns spatial, row stride M) held
// in registers between its load from device memory and its store, through
// f, to shared memory: with vec each of the 128 threads owns R*C/1024 chunks
// of 8 columns, otherwise R*C/128 single elements. Elements past nrows rows
// or past M columns read as 0 and are stored as 0 (not f(0)).
template <int R, int C>
struct XTile {
  static constexpr int CH = R * C / (8 * THREADS);
  static constexpr int EL = R * C / THREADS;
  uint4 q[CH];
  uint16_t s[EL];

  __device__ __forceinline__ void load(const uint16_t* x, long long M, int r0,
                                       int nrows, int c0, bool vec) {
    if (vec) {
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const int i = threadIdx.x + j * THREADS;
        const int r = i / (C / 8), c = (i % (C / 8)) * 8;
        q[j] = make_uint4(0, 0, 0, 0);
        if (r0 + r < nrows && c0 + c < M)
          q[j] = *reinterpret_cast<const uint4*>(x + (r0 + r) * M + c0 + c);
      }
    } else {
#pragma unroll
      for (int j = 0; j < EL; ++j) {
        const int e = threadIdx.x + j * THREADS;
        const int r = e / C, c = e % C;
        s[j] = (r0 + r < nrows && c0 + c < M) ? x[(r0 + r) * M + c0 + c] : 0;
      }
    }
  }

  template <typename T>
  __device__ __forceinline__ void store(uint16_t* dst, int S,
                                        const float* scale, const float* shift,
                                        bool relu, int r0, int nrows, int c0,
                                        long long M, bool vec) const {
    if (vec) {
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const int i = threadIdx.x + j * THREADS;
        const int r = i / (C / 8), c = (i % (C / 8)) * 8;
        const bool in = r0 + r < nrows && c0 + c < M;
        const uint32_t wi[4] = {q[j].x, q[j].y, q[j].z, q[j].w};
        uint32_t wo[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const float lo = prologue(to_f32<T>(wi[p] & 0xffffu), scale, shift,
                                    r0 + r, relu);
          const float hi = prologue(to_f32<T>(wi[p] >> 16), scale, shift,
                                    r0 + r, relu);
          wo[p] = in ? Half<T>::pack(lo, hi) : 0u;
        }
        *reinterpret_cast<uint4*>(dst + r * S + c) =
            make_uint4(wo[0], wo[1], wo[2], wo[3]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < EL; ++j) {
        const int e = threadIdx.x + j * THREADS;
        const int r = e / C, c = e % C;
        const bool in = r0 + r < nrows && c0 + c < M;
        dst[r * S + c] =
            in ? Half<T>::bits(prologue(to_f32<T>(s[j]), scale, shift, r0 + r,
                                        relu))
               : static_cast<uint16_t>(0);
      }
    }
  }
};

// A operand (16 x 16) of rows [m0, m0 + 16) and depth [k0, k0 + 16) out of a
// depth-major 16-bit tile T[k][m] (row stride S) through ldmatrix.trans:
// matrix q = lane >> 3 holds rows m0 + (q & 1) * 8 and depth k0 + (q >> 1) * 8.
template <int S>
__device__ __forceinline__ void ldmatrix_a_trans(uint32_t* a,
                                                 const uint16_t* tile, int k0,
                                                 int m0, int lane) {
  const int q = lane >> 3;
  const uint16_t* p = tile + (k0 + (lane & 7) + (q >> 1) * 8) * S + m0 +
                      (q & 1) * 8;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(mxt::smem_addr(p))
      : "memory");
}

template <typename T> __device__ __forceinline__ void put(void* out,
                                                          long long i, float v);
template <> __device__ __forceinline__ void put<float>(void* out, long long i,
                                                       float v) {
  static_cast<float*>(out)[i] = v;
}
template <> __device__ __forceinline__ void put<__nv_bfloat16>(void* out,
                                                               long long i,
                                                               float v) {
  static_cast<uint16_t*>(out)[i] = Half<__nv_bfloat16>::bits(v);
}
template <> __device__ __forceinline__ void put<__half>(void* out, long long i,
                                                        float v) {
  static_cast<uint16_t*>(out)[i] = Half<__half>::bits(v);
}

// ------------------------------------------------------------------- fwd
// grid (ceil(M / 64), ceil(Co / 64), N); block tile: 64 output channels x 64
// spatial positions, looping over Ci in steps of 32. W's tile (co x ci, ci
// contiguous) is the A operand and streams in by cp.async; the x tile goes
// through registers and f into shared memory and is the B operand.
template <typename T>
__global__ void __launch_bounds__(THREADS) fwd_mma(Args a) {
  constexpr int BK = BK16, WS = BK + PAD, XS = TN + PAD;
  __shared__ __align__(16) uint16_t sW[2][TM * WS];
  __shared__ __align__(16) uint16_t sX[2][BK * XS];
  const int m0 = blockIdx.x * TN, co0 = blockIdx.y * TM;
  const long long n = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const bool vx = a.vec_x, vw = a.vec_w, relu = a.relu;
  const uint16_t* w = static_cast<const uint16_t*>(a.w);
  const uint16_t* x = static_cast<const uint16_t*>(a.x) + n * a.Ci * a.M;
  const int n_k = (a.Ci + BK - 1) / BK;

  XTile<BK, TN> xt;
  mxt::stage_rows<TM, BK, WS>(sW[0], w, a.Ci, co0, a.Co, a.Ci, vw);
  mxt::cp_async_commit();
  xt.load(x, a.M, 0, a.Ci, m0, vx);
  xt.store<T>(sX[0], XS, a.scale, a.shift, relu, 0, a.Ci, m0, a.M, vx);
  mxt::cp_async_wait<0>();
  __syncthreads();

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  for (int kt = 0; kt < n_k; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < n_k;
    const int k1 = (kt + 1) * BK;
    // the next step's tiles stream in while this one is computed
    if (more) {
      mxt::stage_rows<TM, BK, WS>(sW[cur ^ 1], w + k1, a.Ci, co0, a.Co,
                                  a.Ci - k1, vw);
      mxt::cp_async_commit();
      xt.load(x, a.M, k1, a.Ci, m0, vx);
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        mxt::load_a<WS>(af[i], sW[cur], wm + i * 16, kk, g, t4);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t bf[4];
        mxt::ldmatrix_b_trans<XS>(bf, sX[cur], kk, wn + j * 16, lane);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          Half<T>::mma(acc[i][2 * j], af[i], bf);
          Half<T>::mma(acc[i][2 * j + 1], af[i], bf + 2);
        }
      }
    }
    if (more) {
      xt.store<T>(sX[cur ^ 1], XS, a.scale, a.shift, relu, k1, a.Ci, m0, a.M,
                  vx);
      mxt::cp_async_wait<0>();
    }
    __syncthreads();
  }

  uint16_t* y = static_cast<uint16_t*>(a.out) + n * a.Co * a.M;
  const bool pair = (a.M & 1) == 0;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int co = co0 + wm + i * 16 + g + h * 8;
      if (co >= a.Co) continue;
      const float b = a.bias ? a.bias[co] : 0.f;
      uint16_t* yr = y + (long long)co * a.M;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = m0 + wn + j * 8 + t4 * 2;
        const float v0 = acc[i][j][2 * h] + b, v1 = acc[i][j][2 * h + 1] + b;
        if (pair) {
          if (m < a.M)
            *reinterpret_cast<uint32_t*>(yr + m) = Half<T>::pack(v0, v1);
        } else {
          if (m < a.M) yr[m] = Half<T>::bits(v0);
          if (m + 1 < a.M) yr[m + 1] = Half<T>::bits(v1);
        }
      }
    }
}

// f32: 256 threads, each 4 x 4 outputs of the 64 x 64 tile (rows ty + 16 i,
// columns tx + 16 j), exact f32 FMA over Ci in steps of 16.
__global__ void __launch_bounds__(256) fwd_f32(Args a) {
  constexpr int BK = BK32;
  __shared__ float sA[BK][TM + 4];  // W^T: [ci][co]
  __shared__ float sB[BK][TN + 4];  // f(x): [ci][m]
  const int m0 = blockIdx.x * TN, co0 = blockIdx.y * TM;
  const long long n = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float* w = static_cast<const float*>(a.w);
  const float* x = static_cast<const float*>(a.x) + n * a.Ci * a.M;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < a.Ci; k0 += BK) {
    for (int e = tid; e < TM * BK; e += 256) {
      const int r = e / BK, c = e % BK;
      sA[c][r] = (co0 + r < a.Co && k0 + c < a.Ci)
                     ? w[(long long)(co0 + r) * a.Ci + k0 + c] : 0.f;
    }
    for (int e = tid; e < BK * TN; e += 256) {
      const int r = e / TN, c = e % TN;
      const bool in = k0 + r < a.Ci && m0 + c < a.M;
      sB[r][c] = in ? prologue(x[(long long)(k0 + r) * a.M + m0 + c], a.scale,
                               a.shift, k0 + r, a.relu)
                    : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = sA[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = sB[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* y = static_cast<float*>(a.out) + n * a.Co * a.M;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int co = co0 + ty + 16 * i;
    if (co >= a.Co) continue;
    const float b = a.bias ? a.bias[co] : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + tx + 16 * j;
      if (m < a.M) y[(long long)co * a.M + m] = acc[i][j] + b;
    }
  }
}

// ----------------------------------------------------------------- dgrad
// grid (ceil(M / 64), ceil(Ci / 64), N); block tile: 64 input channels x 64
// spatial positions, looping over Co in steps of 32. Both operand tiles are
// copied as they lie by cp.async: W's rows (co x ci) give the A operand W^T
// through ldmatrix.trans, dy's rows (co x m) the B operand. The epilogue
// zeroes da where x*scale+shift <= 0 (relu on) and writes f32.
template <typename T>
__global__ void __launch_bounds__(THREADS) dgrad_mma(Args a) {
  constexpr int BK = BK16, S = TN + PAD;
  __shared__ __align__(16) uint16_t sW[2][BK * S];
  __shared__ __align__(16) uint16_t sD[2][BK * S];
  const int m0 = blockIdx.x * TN, ci0 = blockIdx.y * TM;
  const long long n = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const bool vw = a.vec_w, vd = a.vec_dy;
  const uint16_t* w = static_cast<const uint16_t*>(a.w) + ci0;
  const uint16_t* dy = static_cast<const uint16_t*>(a.dy) + n * a.Co * a.M + m0;
  const int n_k = (a.Co + BK - 1) / BK;

  mxt::stage_rows<BK, TM, S>(sW[0], w, a.Ci, 0, a.Co, a.Ci - ci0, vw);
  mxt::stage_rows<BK, TN, S>(sD[0], dy, a.M, 0, a.Co, a.M - m0, vd);
  mxt::cp_async_commit();

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  for (int kt = 0; kt < n_k; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < n_k) {
      const int k1 = (kt + 1) * BK;
      mxt::stage_rows<BK, TM, S>(sW[cur ^ 1], w, a.Ci, k1, a.Co, a.Ci - ci0, vw);
      mxt::stage_rows<BK, TN, S>(sD[cur ^ 1], dy, a.M, k1, a.Co, a.M - m0, vd);
    }
    mxt::cp_async_commit();
    mxt::cp_async_wait<1>();  // this thread's copies of step kt have landed
    __syncthreads();          // and everyone's
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldmatrix_a_trans<S>(af[i], sW[cur], kk, wm + i * 16, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t bf[4];
        mxt::ldmatrix_b_trans<S>(bf, sD[cur], kk, wn + j * 16, lane);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          Half<T>::mma(acc[i][2 * j], af[i], bf);
          Half<T>::mma(acc[i][2 * j + 1], af[i], bf + 2);
        }
      }
    }
    __syncthreads();  // buffer cur is refilled with step kt + 2
  }

  const uint16_t* x = static_cast<const uint16_t*>(a.x) + n * a.Ci * a.M;
  float* da = static_cast<float*>(a.out) + n * a.Ci * a.M;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ci = ci0 + wm + i * 16 + g + h * 8;
      if (ci >= a.Ci) continue;
      const long long row = (long long)ci * a.M;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = m0 + wn + j * 8 + t4 * 2 + e;
          if (m >= a.M) continue;
          float v = acc[i][j][2 * h + e];
          if (a.relu &&
              !(affine(to_f32<T>(x[row + m]), a.scale, a.shift, ci) > 0.f))
            v = 0.f;
          da[row + m] = v;
        }
    }
}

__global__ void __launch_bounds__(256) dgrad_f32(Args a) {
  constexpr int BK = BK32;
  __shared__ float sA[BK][TM + 4];  // W: [co][ci]
  __shared__ float sB[BK][TN + 4];  // dy: [co][m]
  const int m0 = blockIdx.x * TN, ci0 = blockIdx.y * TM;
  const long long n = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float* w = static_cast<const float*>(a.w);
  const float* dy = static_cast<const float*>(a.dy) + n * a.Co * a.M;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < a.Co; k0 += BK) {
    for (int e = tid; e < BK * TM; e += 256) {
      const int r = e / TM, c = e % TM;
      sA[r][c] = (k0 + r < a.Co && ci0 + c < a.Ci)
                     ? w[(long long)(k0 + r) * a.Ci + ci0 + c] : 0.f;
    }
    for (int e = tid; e < BK * TN; e += 256) {
      const int r = e / TN, c = e % TN;
      sB[r][c] = (k0 + r < a.Co && m0 + c < a.M)
                     ? dy[(long long)(k0 + r) * a.M + m0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = sA[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = sB[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  const float* x = static_cast<const float*>(a.x) + n * a.Ci * a.M;
  float* da = static_cast<float*>(a.out) + n * a.Ci * a.M;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ci = ci0 + ty + 16 * i;
    if (ci >= a.Ci) continue;
    const long long row = (long long)ci * a.M;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + tx + 16 * j;
      if (m >= a.M) continue;
      float v = acc[i][j];
      if (a.relu && !(affine(x[row + m], a.scale, a.shift, ci) > 0.f)) v = 0.f;
      da[row + m] = v;
    }
  }
}

// ----------------------------------------------------------------- wgrad
// grid (ceil(Ci / 64), ceil(Co / 64), splits); block tile: 64 output channels
// x 64 input channels. The reduction runs over (n, m) steps of 32 spatial
// positions, numbered t = n * ceil(M / 32) + m / 32; split s takes steps
// [s * per, (s + 1) * per) and writes its f32 partial sums to ws[s]. dy's
// rows (co x m) are the A operand, copied by cp.async; f(x)'s rows (ci x m)
// are the B operand ("col" layout: m is contiguous), through registers and
// f. Both are zero past M, so no lane past a row's end enters the sum.
template <typename T>
__global__ void __launch_bounds__(THREADS) wgrad_mma(Args a) {
  constexpr int BK = BK16, S = BK + PAD;
  __shared__ __align__(16) uint16_t sD[2][TM * S];
  __shared__ __align__(16) uint16_t sX[2][TN * S];
  const int ci0 = blockIdx.x * TN, co0 = blockIdx.y * TM, split = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const bool vx = a.vec_x, vd = a.vec_dy, relu = a.relu;
  const uint16_t* xb = static_cast<const uint16_t*>(a.x);
  const uint16_t* dyb = static_cast<const uint16_t*>(a.dy);
  const int spn = (a.M + BK - 1) / BK;
  const long long total = (long long)a.N * spn;
  const long long t0 = (long long)split * a.per;
  const long long t1 = min(total, t0 + a.per);

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  XTile<TN, BK> xt;
  if (t0 < t1) {
    {
      const long long n = t0 / spn;
      const int mm = static_cast<int>(t0 % spn) * BK;
      mxt::stage_rows<TM, BK, S>(sD[0], dyb + n * a.Co * a.M + mm, a.M, co0,
                                 a.Co, a.M - mm, vd);
      mxt::cp_async_commit();
      xt.load(xb + n * a.Ci * a.M, a.M, ci0, a.Ci, mm, vx);
      xt.store<T>(sX[0], S, a.scale, a.shift, relu, ci0, a.Ci, mm, a.M, vx);
      mxt::cp_async_wait<0>();
      __syncthreads();
    }
    for (long long t = t0; t < t1; ++t) {
      const int cur = static_cast<int>(t - t0) & 1;
      const bool more = t + 1 < t1;
      const long long n1 = (t + 1) / spn;
      const int mm1 = static_cast<int>((t + 1) % spn) * BK;
      if (more) {
        mxt::stage_rows<TM, BK, S>(sD[cur ^ 1], dyb + n1 * a.Co * a.M + mm1,
                                   a.M, co0, a.Co, a.M - mm1, vd);
        mxt::cp_async_commit();
        xt.load(xb + n1 * a.Ci * a.M, a.M, ci0, a.Ci, mm1, vx);
      }
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t af[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          mxt::load_a<S>(af[i], sD[cur], wm + i * 16, kk, g, t4);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t bf[2];
          mxt::load_b<S>(bf, sX[cur], wn + j * 8, kk, g, t4);
#pragma unroll
          for (int i = 0; i < 2; ++i) Half<T>::mma(acc[i][j], af[i], bf);
        }
      }
      if (more) {
        xt.store<T>(sX[cur ^ 1], S, a.scale, a.shift, relu, ci0, a.Ci, mm1,
                    a.M, vx);
        mxt::cp_async_wait<0>();
      }
      __syncthreads();
    }
  }

  float* ws = a.ws + (long long)split * a.Co * a.Ci;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int co = co0 + wm + i * 16 + g + h * 8;
      if (co >= a.Co) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ci = ci0 + wn + j * 8 + t4 * 2 + e;
          if (ci < a.Ci) ws[(long long)co * a.Ci + ci] = acc[i][j][2 * h + e];
        }
    }
}

__global__ void __launch_bounds__(256) wgrad_f32(Args a) {
  constexpr int BK = BK32;
  __shared__ float sA[BK][TM + 4];  // dy: [m][co]
  __shared__ float sB[BK][TN + 4];  // f(x): [m][ci]
  const int ci0 = blockIdx.x * TN, co0 = blockIdx.y * TM, split = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float* xb = static_cast<const float*>(a.x);
  const float* dyb = static_cast<const float*>(a.dy);
  const int spn = (a.M + BK - 1) / BK;
  const long long total = (long long)a.N * spn;
  const long long t0 = (long long)split * a.per;
  const long long t1 = min(total, t0 + a.per);
  float acc[4][4] = {};
  for (long long t = t0; t < t1; ++t) {
    const long long n = t / spn;
    const int mm = static_cast<int>(t % spn) * BK;
    const float* dy = dyb + n * a.Co * a.M;
    const float* x = xb + n * a.Ci * a.M;
    for (int e = tid; e < TM * BK; e += 256) {
      const int r = e / BK, c = e % BK;
      sA[c][r] = (co0 + r < a.Co && mm + c < a.M)
                     ? dy[(long long)(co0 + r) * a.M + mm + c] : 0.f;
      sB[c][r] = (ci0 + r < a.Ci && mm + c < a.M)
                     ? prologue(x[(long long)(ci0 + r) * a.M + mm + c], a.scale,
                                a.shift, ci0 + r, a.relu)
                     : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = sA[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = sB[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* ws = a.ws + (long long)split * a.Co * a.Ci;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int co = co0 + ty + 16 * i;
    if (co >= a.Co) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ci = ci0 + tx + 16 * j;
      if (ci < a.Ci) ws[(long long)co * a.Ci + ci] = acc[i][j];
    }
  }
}

// dW = the splits' partial sums added in split order, in W's dtype
template <typename T>
__global__ void __launch_bounds__(256) wgrad_reduce(Args a) {
  const long long count = (long long)a.Co * a.Ci;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = 0.f;
  for (int k = 0; k < a.splits; ++k) s += a.ws[k * count + i];
  put<T>(a.out, i, s);
}

template <typename K>
cudaError_t launch(K kern, dim3 grid, int threads, const Args& a,
                   cudaStream_t stream) {
  kern<<<grid, threads, 0, stream>>>(a);
  return cudaGetLastError();
}

bool bad_sizes(int N, int Ci, int Co, int M) {
  return N < 1 || Ci < 1 || Co < 1 || M < 1 || N > 65535 ||
         (Co + TM - 1) / TM > 65535 || (Ci + TM - 1) / TM > 65535;
}

Args make_args(const void* x, const void* w, const void* dy, const float* scale,
               const float* shift, const float* bias, void* out, float* ws,
               int N, int Ci, int Co, int M, int relu) {
  Args a;
  a.x = x; a.w = w; a.dy = dy; a.scale = scale; a.shift = shift; a.bias = bias;
  a.out = out; a.ws = ws;
  a.N = N; a.Ci = Ci; a.Co = Co; a.M = M; a.relu = relu != 0;
  a.vec_x = a.vec_w = a.vec_dy = 0;
  a.splits = 1; a.per = 0;
  return a;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (x, w and dy share it).
// Every tensor is contiguous: x (N, Ci, M), w (Co, Ci), dy (N, Co, M); scale,
// shift (Ci,) f32 or both null (no affine part); bias (Co,) f32 or null.
// vec_* allow 16-byte loads of that tensor's rows (16-bit, rows a multiple of
// 8 elements, 16-byte aligned). Each returns cudaGetLastError().

// y (N, Co, M) in x's dtype
extern "C" int mxt_conv1x1_fwd(int dtype, const void* x, const void* w,
                               const float* scale, const float* shift,
                               const float* bias, void* y, int N, int Ci,
                               int Co, int M, int relu, int vec_x, int vec_w,
                               void* stream) {
  if (bad_sizes(N, Ci, Co, M)) return static_cast<int>(cudaErrorInvalidValue);
  Args a = make_args(x, w, nullptr, scale, shift, bias, y, nullptr, N, Ci, Co,
                     M, relu);
  a.vec_x = vec_x; a.vec_w = vec_w;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((M + TN - 1) / TN, (Co + TM - 1) / TM, N);
  switch (dtype) {
    case 0: return static_cast<int>(launch(fwd_f32, grid, 256, a, st));
    case 1: return static_cast<int>(launch(fwd_mma<__nv_bfloat16>, grid, THREADS, a, st));
    case 2: return static_cast<int>(launch(fwd_mma<__half>, grid, THREADS, a, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// da (N, Ci, M) in f32
extern "C" int mxt_conv1x1_dgrad(int dtype, const void* x, const void* w,
                                 const void* dy, const float* scale,
                                 const float* shift, float* da, int N, int Ci,
                                 int Co, int M, int relu, int vec_w,
                                 int vec_dy, void* stream) {
  if (bad_sizes(N, Ci, Co, M)) return static_cast<int>(cudaErrorInvalidValue);
  Args a = make_args(x, w, dy, scale, shift, nullptr, da, nullptr, N, Ci, Co,
                     M, relu);
  a.vec_w = vec_w; a.vec_dy = vec_dy;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((M + TN - 1) / TN, (Ci + TM - 1) / TM, N);
  switch (dtype) {
    case 0: return static_cast<int>(launch(dgrad_f32, grid, 256, a, st));
    case 1: return static_cast<int>(launch(dgrad_mma<__nv_bfloat16>, grid, THREADS, a, st));
    case 2: return static_cast<int>(launch(dgrad_mma<__half>, grid, THREADS, a, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dw (Co, Ci) in w's dtype (the same as x's); ws is (splits, Co, Ci) f32
// scratch, splits >= 1 blocks along the N*M reduction
extern "C" int mxt_conv1x1_wgrad(int dtype, const void* x, const void* dy,
                                 const float* scale, const float* shift,
                                 void* dw, float* ws, int N, int Ci, int Co,
                                 int M, int relu, int vec_x, int vec_dy,
                                 int splits, void* stream) {
  if (bad_sizes(N, Ci, Co, M) || splits < 1 || splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = make_args(x, nullptr, dy, scale, shift, nullptr, dw, ws, N, Ci, Co,
                     M, relu);
  a.vec_x = vec_x; a.vec_dy = vec_dy;
  const int bk = dtype == 0 ? BK32 : BK16;
  const long long steps = (long long)N * ((M + bk - 1) / bk);
  a.splits = splits;
  a.per = static_cast<int>((steps + splits - 1) / splits);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((Ci + TN - 1) / TN, (Co + TM - 1) / TM, splits);
  const long long count = (long long)Co * Ci;
  const dim3 rgrid(static_cast<unsigned>((count + 255) / 256));
  cudaError_t e;
  switch (dtype) {
    case 0:
      e = launch(wgrad_f32, grid, 256, a, st);
      if (e == cudaSuccess) e = launch(wgrad_reduce<float>, rgrid, 256, a, st);
      break;
    case 1:
      e = launch(wgrad_mma<__nv_bfloat16>, grid, THREADS, a, st);
      if (e == cudaSuccess)
        e = launch(wgrad_reduce<__nv_bfloat16>, rgrid, 256, a, st);
      break;
    case 2:
      e = launch(wgrad_mma<__half>, grid, THREADS, a, st);
      if (e == cudaSuccess) e = launch(wgrad_reduce<__half>, rgrid, 256, a, st);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
