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
// byte for every shape but the stage-4 wgrad (Ci*Co = 1M, bound by flops),
// so the floor is moving x, dy and y once through HBM; the kernels keep f(x)
// and the ReLU mask out of HBM for that reason.
//
// fwd (and the f32 kernels) are a simple tiled GEMM: one block of 4 warps
// computes a 64 x 64 output tile on mma.sync m16n8k16 (bf16 or fp16 in, f32
// accumulate), operand tiles double-buffered in shared memory (cp.async
// where no prologue applies, a register stage for the x tiles that take f).
// fwd reads the M-contiguous f(x) tile as its B operand through
// ldmatrix.trans. f32 inputs take FMA kernels: exact f32 products, no TF32,
// as the TPU kernels use Precision.HIGHEST for f32.
//
// The 16-bit dgrad and wgrad were held back at M = 196 and 49 by 2-byte
// global loads (rows of 392 and 98 bytes), by padding each image's M to the
// tile, by two barriers per 16 mma.sync and by mma.sync's rate. They are
// now 128 x 128 tiles of two warpgroups on wgmma m64n128k16, 64 deep a step,
// the operands in shared memory in wgmma's canonical layout (hopper.cuh):
// - copies are asynchronous and at least 8 bytes wide at every ResNet-50
//   shape: rows whose length is a multiple of 8 (or 4) elements go straight
//   into the operand layout by 16- (or 8-) byte cp.async, a ring of three
//   stages loaded two steps ahead, two blocks an SM; at M = 49, whose rows
//   are not even 4-byte aligned, an image's channel tile is one contiguous
//   16-byte aligned run, which cp.async.bulk brings in on an mbarrier and a
//   repack pass (shared -> registers -> shared) lays out. A general path of
//   element loads in the same kernels takes any other shape or alignment;
// - both kernels run along the flattened N*M axis: wgrad packs the images
//   of its split densely into 64-position steps and dgrad's output tile
//   spans images, so only the last step or tile is ragged;
// - wgrad computes dW = dy f(x)^T with both operands K-major as they lie
//   (f applied in shared memory between the copy and the wgmma); dgrad
//   reads W^T and dy MN-major ("transposed", which wgmma takes for 16-bit
//   types); no transposes in memory;
// - wgrad splits the reduction over whole images so that at least 132
//   blocks run at every junction; each split writes f32 partial sums that a
//   second pass adds in split order, so dW is the same from run to run.
// Zero-filled rows and positions never enter a sum, and f(0) is never
// written where x was absent.
#include <stdint.h>

#include "flash_common.cuh"
#include "hopper.cuh"

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
  int vec_x;   // fwd: 16-byte loads of x rows (16-bit, M % 8 == 0, aligned)
  int vec_w;   // fwd: 16-byte loads of W rows (16-bit, Ci % 8 == 0, aligned)
  int splits;  // wgrad: blocks along the N*M reduction
  int per;     // wgrad: reduction steps (f32) or images (16-bit) per split
  int vec;     // 16-bit dgrad / wgrad: elements per copy of x / dy rows:
               // 8, 4 (cp.async) or 1 (element loads)
  int wvec;    // the same for W's rows (dgrad)
  int slots;   // images in wgrad's ring (runs)
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
// f32: the 64 x 64 FMA tile of fwd_f32 over W^T and dy, the ReLU mask in
// the epilogue.
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
// f32: grid (ceil(Ci / 64), ceil(Co / 64), splits); the reduction runs over
// (n, m) steps of 16 positions, t = n * ceil(M / 16) + m / 16, split s
// taking steps [s * per, (s + 1) * per) into ws[s].
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

// ------------------------------------------------- dgrad and wgrad, 16-bit
// Two warpgroups compute a 128 x 128 output tile, 64 rows each, on wgmma
// m64n128k16 (f32 accumulators in registers), 64 deep a step. Operand tiles
// are 128 x 64 in hopper.cuh's layout. How they reach shared memory (the
// plan's mode, chosen by ops/cuda/conv_fused.py:conv1x1_plan):
//   rows (vec 8 or 4): each thread copies 16 or 8 bytes of a row straight
//     into the operand layout by cp.async, a ring of RING stages loaded
//     RING - 1 steps ahead (a step's wgmma ends before its slot refills:
//     copies, not products, bound these kernels); rows of M % 8 == 0 (or
//     M % 4 == 0) elements keep every such chunk inside one image;
//   runs: the tile's channels of one image are one contiguous run (R x M
//     elements, 16-byte aligned when C % 8 == 0): cp.async.bulk brings whole
//     runs in on mbarriers and a repack (shared -> registers -> shared)
//     writes the operand layout; for 8 <= M < 64 whose rows are not 8-byte
//     aligned (M = 49);
//   general (vec 1): element loads into the operand layout, any shape or
//     alignment.
namespace wg {

constexpr int ROWS = 128;          // output rows per block: two warpgroups
constexpr int COLS = 128;          // output columns per block
constexpr int BK = 64;             // contraction per step: four k16 wgmmas
constexpr int THREADS = 256;
constexpr int RING = 3;            // stages of the rows kernels' copy ring
constexpr int AHEAD = RING - 1;    // steps their copies run ahead
constexpr int RUNS_RING = 4;       // stages of dgrad_runs' ring
constexpr int TILE = ROWS * BK;    // elements of one 128 x 64 operand tile
constexpr int TILE_BYTES = TILE * 2;
constexpr int LBO = ROWS * 16;     // bytes from one k group to the next
constexpr int BARS = 256;          // bytes kept for mbarriers
constexpr int MAX_SLOTS = 16;      // images in wgrad's ring (runs)
constexpr int SMEM_MAX = 232448;

// A position p = n * M + m of the flattened (n, m) axis and how many
// positions from it come before the end pb (<= 0: none). Divided once;
// moving on by d costs a compare (no division in a kernel's loop).
struct Pos {
  unsigned n;
  int m, left;
  __device__ __forceinline__ Pos(unsigned p, unsigned pb, int M)
      : n(p / static_cast<unsigned>(M)),
        m(static_cast<int>(p - n * static_cast<unsigned>(M))),
        left(static_cast<int>(static_cast<long long>(pb) - p)) {}
  __device__ __forceinline__ void advance(int d, int M) {
    m += d;
    left -= d;
    while (m >= M) {
      m -= M;
      ++n;
    }
  }
};

// Elements (channel c, positions at .. at + 7) of a 16-bit (., C, M) tensor
// into the 16 bytes at dst, zero where c >= C or past the end. vec 8: one
// 16-byte cp.async (M % 8 == 0, at a multiple of 8, an aligned base); vec
// 4: two 8-byte ones (M % 4 == 0); vec 1: element loads.
__device__ __forceinline__ void load8(uint16_t* dst, const uint16_t* src,
                                      int C, int M, int c, const Pos& at,
                                      int vec) {
  const bool row = c < C;
  if (vec == 8) {
    const bool ok = row && at.left > 0;
    hop::cp16(dst, ok ? src + ((long long)at.n * C + c) * M + at.m : src, ok);
  } else if (vec == 4) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      unsigned n = at.n;
      int m = at.m + 4 * h;
      if (m >= M) {
        m -= M;
        ++n;
      }
      const bool ok = row && at.left > 4 * h;
      hop::cp8(dst + 4 * h, ok ? src + ((long long)n * C + c) * M + m : src,
               ok);
    }
  } else {
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    unsigned n = at.n;
    int m = at.m;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (row && e < at.left)
        w[e / 2] |= static_cast<uint32_t>(src[((long long)n * C + c) * M + m])
                    << (16 * (e & 1));
      if (++m == M) {
        m = 0;
        ++n;
      }
    }
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Thread tid's share of a 128 x 64 tile: groups i = tid + 256 j, j < 4.
// K-major (wgrad): group i is row r, k chunk kc, in 16-byte unit
// kc * 128 + r. Eight neighbouring threads take eight rows (distinct banks),
// a warp four chunks of each (64 contiguous bytes of a row).
__device__ __forceinline__ int k_row(int i) { return (i >> 6) * 8 + (i & 7); }
__device__ __forceinline__ int k_chunk(int i) { return (i >> 3) & 7; }
// MN-major (dgrad): group i is contraction row k, MN chunk mc, in unit
// (k >> 3) * 128 + mc * 8 + (k & 7).
__device__ __forceinline__ int mn_k(int i) { return (i >> 7) * 8 + (i & 7); }
__device__ __forceinline__ int mn_chunk(int i) { return (i >> 3) & 15; }
__device__ __forceinline__ int mn_unit(int k, int mc) {
  return (k >> 3) * ROWS + mc * 8 + (k & 7);
}

// the K-major tile of channels [c0, c0 + 128) and 64 positions; `at` is
// this thread's chunk, k_chunk(tid) (the same for its four groups)
__device__ __forceinline__ void load_k_tile(uint16_t* tile, const uint16_t* src,
                                            int C, int M, int c0,
                                            const Pos& at, int vec) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int r = k_row(i);
    load8(tile + (k_chunk(i) * ROWS + r) * 8, src, C, M, c0 + r, at, vec);
  }
}

// the MN-major tile of contraction rows (channels) [k0, k0 + 64) and 128
// positions; `at` is this thread's chunk, mn_chunk(tid)
__device__ __forceinline__ void load_mn_tile(uint16_t* tile,
                                             const uint16_t* src, int C, int M,
                                             int k0, const Pos& at, int vec) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int k = mn_k(i);
    load8(tile + mn_unit(k, mn_chunk(i)) * 8, src, C, M, k0 + k, at, vec);
  }
}

// wgrad's f(x) as two 16-bit terms, hi = T(f) and lo = T(f - hi), each
// multiplied by dy into the same f32 sums: for fp16, whose dy is exact in
// either product, this is the JAX kernel's f32 f(x) to about 2^-22; bf16
// rounds f(x) once, as the JAX kernel does (its cd is bf16)
template <typename T> struct SplitF { static constexpr bool value = false; };
template <> struct SplitF<__half> { static constexpr bool value = true; };

// f(x) for the four rows (channels c0 + k_row(tid + 256 j)) of a thread
template <typename T>
struct Prologue {
  float sc[4], sh[4];
  bool affine, relu;
  __device__ Prologue(const Args& a, int c0)
      : affine(a.scale != nullptr), relu(a.relu != 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + k_row(threadIdx.x + j * THREADS);
      sc[j] = (affine && c < a.Ci) ? a.scale[c] : 1.f;
      sh[j] = (affine && c < a.Ci) ? a.shift[c] : 0.f;
    }
  }
  // f of one 16-bit value of row j (the plain version's roundings:
  // __fmul_rn, __fadd_rn, then the ReLU; NaN passes)
  __device__ __forceinline__ float f(uint32_t bits, int j) const {
    float v = to_f32<T>(static_cast<uint16_t>(bits));
    if (affine) v = __fadd_rn(__fmul_rn(v, sc[j]), sh[j]);
    return (relu && v < 0.f) ? 0.f : v;
  }
  // f of the two 16-bit values of a word, packed back, and into *lo the
  // packed remainders f - hi (SplitF); the first `left` of them are real,
  // the rest stay 0 (not f(0))
  __device__ __forceinline__ uint32_t f2(uint32_t w, int j, int left,
                                         uint32_t* lo = nullptr) const {
    const float v0 = f(w & 0xffffu, j), v1 = f(w >> 16, j);
    const uint32_t keep = left >= 2 ? 0xffffffffu : left == 1 ? 0xffffu : 0u;
    const uint32_t o = Half<T>::pack(v0, v1);
    if (SplitF<T>::value && lo != nullptr)
      *lo = Half<T>::pack(v0 - to_f32<T>(o & 0xffffu),
                          v1 - to_f32<T>(o >> 16)) & keep;
    return o & keep;
  }
  // in place over the x tile of a rows-mode stage (with SplitF, the
  // remainders into lo_tile at the same places); `left` positions of this
  // thread's chunk are real, rows past C stay 0
  __device__ __forceinline__ void apply(uint16_t* tile, uint16_t* lo_tile,
                                        int c0, int C, int left) const {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = threadIdx.x + j * THREADS;
      const int r = k_row(i);
      const int at = (k_chunk(i) * ROWS + r) * 8;
      uint4* u = reinterpret_cast<uint4*>(tile + at);
      if (c0 + r >= C || left <= 0) {
        if (lo_tile) *reinterpret_cast<uint4*>(lo_tile + at) = *u;  // zeros
        continue;
      }
      const uint4 v = *u;
      uint4 l = make_uint4(0u, 0u, 0u, 0u);
      *u = make_uint4(f2(v.x, j, left, &l.x), f2(v.y, j, left - 2, &l.y),
                      f2(v.z, j, left - 4, &l.z), f2(v.w, j, left - 6, &l.w));
      if (lo_tile) *reinterpret_cast<uint4*>(lo_tile + at) = l;
    }
  }
};

// One step: this warpgroup's 64 rows of A (at a) times the 128-column B
// tile (at b), and with SPLIT times a second B tile (at b2) into the same
// sums; k16 wgmmas committed as one group.
template <typename T, int TR, bool SPLIT = false>
__device__ __forceinline__ void mma_step(float* acc, const uint16_t* a,
                                         const uint16_t* b,
                                         const uint16_t* b2 = nullptr) {
  const uint32_t sa = hop::smem_u32(a), sb = hop::smem_u32(b);
  hop::fence_regs(acc, 64);
  hop::wgmma_fence();
#pragma unroll
  for (int s = 0; s < BK / 16; ++s)
    hop::wgmma_128<T, TR, TR>(acc, hop::desc(sa + s * 2 * LBO, LBO),
                              hop::desc(sb + s * 2 * LBO, LBO));
  if (SPLIT) {
    const uint32_t sb2 = hop::smem_u32(b2);
#pragma unroll
    for (int s = 0; s < BK / 16; ++s)
      hop::wgmma_128<T, TR, TR>(acc, hop::desc(sa + s * 2 * LBO, LBO),
                                hop::desc(sb2 + s * 2 * LBO, LBO));
  }
  hop::wgmma_commit();
}

// waits for this warpgroup's wgmmas; nothing else touches the accumulators
// while one is in flight (ptxas serializes them otherwise). Copies, not
// products, bound these kernels, so a step's products end within the step.
__device__ __forceinline__ void mma_done(float* acc) {
  hop::wgmma_wait<0>();
  hop::fence_regs(acc, 64);
}

// -------------------------------------------------------------- wgrad
// grid (ceil(Ci / 128), ceil(Co / 128), splits). dW = dy f(x)^T: A is the
// dy tile (co x positions), B the f(x) tile (ci x positions), both K-major
// as they lie in memory (positions contiguous). Split s takes images
// [s * per, (s + 1) * per) and packs their positions densely, 64 a step,
// so only its last step is ragged; it writes f32 partial sums to ws[s].
__device__ __forceinline__ void wgrad_store(const Args& a, const float* acc,
                                            int split, int co0, int ci0) {
  const int tid = threadIdx.x, wgi = tid >> 7, warp = (tid >> 5) & 3;
  const int g = (tid & 31) >> 2, t4 = tid & 3;
  float* ws = a.ws + (long long)split * a.Co * a.Ci;
  const bool pair = (a.Ci & 1) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int co = co0 + wgi * 64 + warp * 16 + g + 8 * h;
    if (co >= a.Co) continue;
    float* row = ws + (long long)co * a.Ci;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int ci = ci0 + 8 * j + 2 * t4;
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (pair) {
        if (ci < a.Ci)
          *reinterpret_cast<float2*>(row + ci) = make_float2(v0, v1);
      } else {
        if (ci < a.Ci) row[ci] = v0;
        if (ci + 1 < a.Ci) row[ci + 1] = v1;
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2) wgrad_rows(Args a) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint16_t* ring = reinterpret_cast<uint16_t*>(smem);  // RING x (dy, x) tiles
  uint16_t* lo_tile = ring + RING * 2 * TILE;  // SplitF: f(x) - hi
  const int ci0 = blockIdx.x * COLS, co0 = blockIdx.y * ROWS;
  const int split = blockIdx.z, wgi = threadIdx.x >> 7;
  const uint16_t* x = static_cast<const uint16_t*>(a.x);
  const uint16_t* dy = static_cast<const uint16_t*>(a.dy);
  const int nA = split * a.per, nB = min(a.N, nA + a.per);
  const unsigned pa = static_cast<unsigned>(nA) * a.M;
  const unsigned pb = static_cast<unsigned>(nB) * a.M;
  const int steps = static_cast<int>((pb - pa + BK - 1) / BK);
  const Prologue<T> pro(a, ci0);
  // SplitF: always, so that every step writes its lo tile (zero when f is
  // the identity) and the second product is issued unconditionally
  const bool apply = pro.affine || pro.relu || SplitF<T>::value;
  uint16_t* lo = SplitF<T>::value ? lo_tile : nullptr;

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  // this thread's chunk of the next step to load, and of step 0
  const int kc = k_chunk(threadIdx.x);
  Pos ld(pa + kc * 8, pb, a.M);
  const int left0 = ld.left;
  auto load = [&](int s) {
    uint16_t* st = ring + (s % RING) * 2 * TILE;
    load_k_tile(st, dy, a.Co, a.M, co0, ld, a.vec);
    load_k_tile(st + TILE, x, a.Ci, a.M, ci0, ld, a.vec);
    ld.advance(BK, a.M);
  };
#pragma unroll
  for (int s = 0; s < AHEAD; ++s) {
    if (s < steps) load(s);
    hop::cp_commit();
  }
  for (int t = 0; t < steps; ++t) {
    hop::cp_wait<AHEAD - 1>();  // this thread's copies of step t landed
    hop::fence_async_smem();
    __syncthreads();            // everyone's; and wgmma t - 1 is done
    if (t + AHEAD < steps) load(t + AHEAD);  // into step t - 1's slot
    hop::cp_commit();
    uint16_t* st = ring + (t % RING) * 2 * TILE;
    if (apply) {
      pro.apply(st + TILE, lo, ci0, a.Ci, left0 - t * BK);
      hop::fence_async_smem();
      __syncthreads();
    }
    mma_step<T, 0, SplitF<T>::value>(acc, st + wgi * 64 * 8, st + TILE, lo);
    mma_done(acc);  // the slot is free for step t + 2's copies
  }
  wgrad_store(a, acc, split, co0, ci0);
}

// The K-major tile of one step out of the image ring: this thread's chunk
// starts at position `at` of the block's images (image at.n held in slot
// at.n % S); op is the offset of the x or the dy run in a slot. M >= 8, so
// a chunk of 8 positions spans at most two images.
template <typename T, bool PRO>
__device__ __forceinline__ void repack_k(uint16_t* tile, const uint16_t* slots,
                                         int slot_el, int op, int S, int M,
                                         int rows, const Pos& at,
                                         const Prologue<T>& pro,
                                         uint16_t* lo_tile = nullptr) {
  const uint16_t* run0 = slots + (at.n % S) * slot_el + op;
  const uint16_t* run1 = slots + ((at.n + 1) % S) * slot_el + op - M;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int r = k_row(i);
    uint32_t w[4] = {0u, 0u, 0u, 0u}, lo[4] = {0u, 0u, 0u, 0u};
    if (r < rows && at.left > 0) {
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        const int m0 = at.m + e, m1 = m0 + 1;
        if (e >= at.left) break;
        const uint32_t v0 = (m0 < M ? run0 : run1)[r * M + m0];
        const uint32_t v1 =
            e + 1 < at.left ? (m1 < M ? run0 : run1)[r * M + m1] : 0u;
        w[e / 2] = PRO ? pro.f2(v0 | (v1 << 16), j, at.left - e, &lo[e / 2])
                       : v0 | (v1 << 16);
      }
    }
    const int u = (k_chunk(i) * ROWS + r) * 8;
    *reinterpret_cast<uint4*>(tile + u) = make_uint4(w[0], w[1], w[2], w[3]);
    if (lo_tile)
      *reinterpret_cast<uint4*>(lo_tile + u) =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1) wgrad_runs(Args a) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);            // one a slot
  uint16_t* canon = reinterpret_cast<uint16_t*>(smem + BARS);  // dy, x tiles
  uint16_t* lo_tile = canon + 2 * TILE;  // SplitF: f(x) - hi
  // S x (x run, dy run), 128 x M each
  uint16_t* slots = canon + (2 + SplitF<T>::value) * TILE;
  const int ci0 = blockIdx.x * COLS, co0 = blockIdx.y * ROWS;
  const int split = blockIdx.z, wgi = threadIdx.x >> 7;
  const int M = a.M, S = a.slots, slot_el = 2 * ROWS * M;
  const uint16_t* x = static_cast<const uint16_t*>(a.x);
  const uint16_t* dy = static_cast<const uint16_t*>(a.dy);
  const int nA = split * a.per, nimg = min(a.N, nA + a.per) - nA;
  const unsigned P = static_cast<unsigned>(nimg) * M;
  const int steps = static_cast<int>((P + BK - 1) / BK);
  const int rows_x = min(ROWS, a.Ci - ci0), rows_dy = min(ROWS, a.Co - co0);
  const uint32_t bytes_x = rows_x * M * 2, bytes_dy = rows_dy * M * 2;
  const Prologue<T> pro(a, ci0);
  uint16_t* lo = SplitF<T>::value ? lo_tile : nullptr;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) hop::mbar_init(bar + s, 1);
    hop::mbar_init_fence();
  }
  __syncthreads();
  // thread 0: the runs of the block's image n into slot n % S
  auto issue = [&](int n) {
    uint16_t* sl = slots + (n % S) * slot_el;
    uint64_t* b = bar + n % S;
    hop::mbar_expect(b, bytes_x + bytes_dy);
    hop::bulk_g2s(sl, x + ((long long)(nA + n) * a.Ci + ci0) * M, bytes_x, b);
    hop::bulk_g2s(sl + ROWS * M, dy + ((long long)(nA + n) * a.Co + co0) * M,
                  bytes_dy, b);
  };
  int issued = min(S, nimg), waited = 0;
  if (threadIdx.x == 0)
    for (int n = 0; n < issued; ++n) issue(n);

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  Pos rp(k_chunk(threadIdx.x) * 8, P, M);  // this thread's chunk of step t
  for (int t = 0; t < steps; ++t) {
    const unsigned p0 = static_cast<unsigned>(t) * BK;
    const int hi = static_cast<int>(min(P - 1, p0 + BK - 1) / M);
    for (; waited <= hi; ++waited)  // the k-th use of a slot: parity k & 1
      hop::mbar_wait(bar + waited % S, (waited / S) & 1);
    __syncthreads();  // wgmma t - 1, which read the tiles, is done
    repack_k<T, false>(canon, slots, slot_el, ROWS * M, S, M, rows_dy, rp,
                       pro);
    repack_k<T, true>(canon + TILE, slots, slot_el, 0, S, M, rows_x, rp, pro,
                      lo);
    rp.advance(BK, M);
    hop::fence_async_smem();
    __syncthreads();  // the repack is done: images before step t + 1's go
    if (threadIdx.x == 0) {
      const int lo = static_cast<int>(min(P, p0 + BK) / M);
      for (; issued < nimg && issued < lo + S; ++issued) issue(issued);
    }
    mma_step<T, 0, SplitF<T>::value>(acc, canon + wgi * 64 * 8,
                                     canon + TILE, lo);
    mma_done(acc);
  }
  wgrad_store(a, acc, split, co0, ci0);
}

// -------------------------------------------------------------- dgrad
// grid (ceil(N * M / 128), ceil(Ci / 128)). da = W^T dy over the flattened
// (n, m) axis, so a tile spans image boundaries and only the last one is
// ragged: A is W^T (ci x co) read MN-major out of W's rows, B is dy (co x
// positions) MN-major as it lies. The epilogue zeroes da where
// x * scale + shift <= 0 (relu on) and writes f32.

// xs: the x runs of the tile's images in shared memory (runs), else null.
// Each of a thread's two rows reads its sixteen pairs of x first, all in
// flight together, and then masks and stores.
template <typename T>
__device__ __forceinline__ void dgrad_store(const Args& a, const float* acc,
                                            int ci0, unsigned q0,
                                            const uint16_t* xs,
                                            unsigned n_first) {
  const int tid = threadIdx.x, wgi = tid >> 7, warp = (tid >> 5) & 3;
  const int g = (tid & 31) >> 2, t4 = tid & 3;
  const int M = a.M;
  const unsigned NM = static_cast<unsigned>(a.N) * M;
  const uint16_t* x = static_cast<const uint16_t*>(a.x);
  float* da = static_cast<float*>(a.out);
  const bool even = (M & 1) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int ci = ci0 + wgi * 64 + warp * 16 + g + 8 * h;
    if (ci >= a.Ci) continue;
    uint32_t xw[16];  // x at this row's 16 pairs of columns, low half first
    if (a.relu) {
      Pos at(q0 + 2 * t4, NM, M);
#pragma unroll
      for (int j = 0; j < 16; ++j, at.advance(8, M)) {
        xw[j] = 0u;
        if (at.left <= 0) continue;
        const bool has1 = at.left > 1;
        const unsigned n1 = at.m + 1 == M ? at.n + 1 : at.n;
        const int m1 = at.m + 1 == M ? 0 : at.m + 1;
        if (xs) {
          const uint16_t* xr = xs + (ci - ci0) * M;
          xw[j] = xr[(at.n - n_first) * ROWS * M + at.m];
          if (has1) xw[j] |= static_cast<uint32_t>(
                                 xr[(n1 - n_first) * ROWS * M + m1]) << 16;
        } else if (a.vec >= 4) {  // M even: both in one image, 4-byte aligned
          xw[j] = *reinterpret_cast<const uint32_t*>(
              x + ((long long)at.n * a.Ci + ci) * M + at.m);
        } else {
          xw[j] = x[((long long)at.n * a.Ci + ci) * M + at.m];
          if (has1) xw[j] |= static_cast<uint32_t>(
                                 x[((long long)n1 * a.Ci + ci) * M + m1]) << 16;
        }
      }
    }
    const float sc = a.scale ? a.scale[ci] : 1.f;
    const float sh = a.scale ? a.shift[ci] : 0.f;
    Pos at(q0 + 2 * t4, NM, M);
#pragma unroll
    for (int j = 0; j < 16; ++j, at.advance(8, M)) {
      if (at.left <= 0) continue;
      const bool has1 = at.left > 1;
      float v[2] = {acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]};
      if (a.relu) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float xv = to_f32<T>(static_cast<uint16_t>(xw[j] >> (16 * e)));
          const float af = a.scale ? __fadd_rn(__fmul_rn(xv, sc), sh) : xv;
          if (!(af > 0.f)) v[e] = 0.f;
        }
      }
      float* out = da + ((long long)at.n * a.Ci + ci) * M + at.m;
      if (even && has1) {
        *reinterpret_cast<float2*>(out) = make_float2(v[0], v[1]);
      } else {
        *out = v[0];
        if (has1) {
          const unsigned n1 = at.m + 1 == M ? at.n + 1 : at.n;
          const int m1 = at.m + 1 == M ? 0 : at.m + 1;
          da[((long long)n1 * a.Ci + ci) * M + m1] = v[1];
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2) dgrad_rows(Args a) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint16_t* ring = reinterpret_cast<uint16_t*>(smem);  // RING x (W^T, dy)
  const unsigned q0 = blockIdx.x * COLS;
  const int ci0 = blockIdx.y * ROWS, wgi = threadIdx.x >> 7;
  const uint16_t* w = static_cast<const uint16_t*>(a.w);
  const uint16_t* dy = static_cast<const uint16_t*>(a.dy);
  const unsigned NM = static_cast<unsigned>(a.N) * a.M;
  const int steps = (a.Co + BK - 1) / BK;

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  // this thread's chunks, the same at every step: W as a (1, Co, Ci)
  // tensor (channel co, "positions" ci), dy along the flattened axis
  const int mc = mn_chunk(threadIdx.x);
  const Pos wp(ci0 + mc * 8, a.Ci, a.Ci), dp(q0 + mc * 8, NM, a.M);
  auto load = [&](int s) {
    uint16_t* st = ring + (s % RING) * 2 * TILE;
    load_mn_tile(st, w, a.Co, a.Ci, s * BK, wp, a.wvec);
    load_mn_tile(st + TILE, dy, a.Co, a.M, s * BK, dp, a.vec);
  };
#pragma unroll
  for (int s = 0; s < AHEAD; ++s) {
    if (s < steps) load(s);
    hop::cp_commit();
  }
  for (int t = 0; t < steps; ++t) {
    hop::cp_wait<AHEAD - 1>();
    hop::fence_async_smem();
    __syncthreads();
    if (t + AHEAD < steps) load(t + AHEAD);
    hop::cp_commit();
    uint16_t* st = ring + (t % RING) * 2 * TILE;
    mma_step<T, 1>(acc, st + wgi * 64 * 8, st + TILE);
    mma_done(acc);
  }
  dgrad_store<T>(a, acc, ci0, q0, nullptr, 0);
}

// The MN-major dy tile of one step out of the staged runs: group (k, mc)
// holds co row k and positions at .. at + 7 (this thread's chunk; M >= 8,
// so two images at most); image n's run (rows x M) sits at
// raw + (n - n_first) * 64 * M.
__device__ __forceinline__ void repack_mn(uint16_t* tile, const uint16_t* raw,
                                          int M, int rows, const Pos& at,
                                          unsigned n_first) {
  const uint16_t* run = raw + (at.n - n_first) * BK * M;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int k = mn_k(i), mc = mn_chunk(i);
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (k < rows && at.left > 0) {
      const uint16_t* rk = run + k * M;
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        // past this image's M positions lies the next image's run, whose
        // row k starts BK * M - M elements after this one's end
        const int m0 = at.m + e, m1 = m0 + 1;
        if (e >= at.left) break;  // past the last image: not staged
        const uint32_t v0 = rk[m0 < M ? m0 : m0 + (BK - 1) * M];
        const uint32_t v1 =
            e + 1 < at.left ? rk[m1 < M ? m1 : m1 + (BK - 1) * M] : 0u;
        w[e / 2] = v0 | (v1 << 16);
      }
    }
    *reinterpret_cast<uint4*>(tile + mn_unit(k, mc) * 8) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1) dgrad_runs(Args a) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);  // a stage's, epilogue
  uint16_t* aring = reinterpret_cast<uint16_t*>(smem + BARS);  // W^T tiles
  uint16_t* bt = aring + RUNS_RING * TILE;                      // dy tile
  uint16_t* raw = bt + TILE;  // RUNS_RING x img x (64 x M)
  const int M = a.M;
  const unsigned um = static_cast<unsigned>(M);
  const unsigned q0 = blockIdx.x * COLS;
  const int ci0 = blockIdx.y * ROWS, wgi = threadIdx.x >> 7;
  const uint16_t* x = static_cast<const uint16_t*>(a.x);
  const uint16_t* w = static_cast<const uint16_t*>(a.w);
  const uint16_t* dy = static_cast<const uint16_t*>(a.dy);
  const unsigned NM = static_cast<unsigned>(a.N) * um;
  const int steps = (a.Co + BK - 1) / BK;
  const int img = 1 + (COLS - 1 + M - 1) / M;  // most images a tile spans
  const unsigned n_first = q0 / um;
  const int imgs =
      static_cast<int>(min(NM - 1, q0 + COLS - 1) / um - n_first) + 1;
  const int stage_el = img * BK * M;

  if (threadIdx.x == 0) {
    for (int s = 0; s <= RUNS_RING; ++s) hop::mbar_init(bar + s, 1);
    hop::mbar_init_fence();
  }
  __syncthreads();

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  const int mc = mn_chunk(threadIdx.x);
  const Pos wp(ci0 + mc * 8, a.Ci, a.Ci), dp(q0 + mc * 8, NM, M);
  auto load = [&](int s) {
    load_mn_tile(aring + (s % RUNS_RING) * TILE, w, a.Co, a.Ci, s * BK, wp,
                 a.wvec);
    if (threadIdx.x == 0) {
      const int rows = min(BK, a.Co - s * BK);
      const uint32_t bytes = rows * M * 2;
      uint64_t* b = bar + s % RUNS_RING;
      hop::mbar_expect(b, bytes * imgs);
      for (int li = 0; li < imgs; ++li)
        hop::bulk_g2s(raw + (s % RUNS_RING) * stage_el + li * BK * M,
                      dy + ((long long)(n_first + li) * a.Co + s * BK) * M,
                      bytes, b);
    }
  };
#pragma unroll
  for (int s = 0; s < RUNS_RING - 2; ++s) {
    if (s < steps) load(s);
    hop::cp_commit();
  }
  for (int t = 0; t < steps; ++t) {
    hop::cp_wait<RUNS_RING - 3>();
    hop::mbar_wait(bar + t % RUNS_RING, (t / RUNS_RING) & 1);
    hop::fence_async_smem();
    __syncthreads();
    if (t + RUNS_RING - 2 < steps) load(t + RUNS_RING - 2);
    hop::cp_commit();
    repack_mn(bt, raw + (t % RUNS_RING) * stage_el, M,
              min(BK, a.Co - t * BK), dp, n_first);
    hop::fence_async_smem();
    __syncthreads();
    mma_step<T, 1>(acc, aring + (t % RUNS_RING) * TILE + wgi * 64 * 8, bt);
    mma_done(acc);
  }
  const uint16_t* xs = nullptr;
  if (a.relu) {  // the tile's x runs, for the ReLU mask
    __syncthreads();  // every repack read of raw is done
    if (threadIdx.x == 0) {
      const int rows = min(ROWS, a.Ci - ci0);
      const uint32_t bytes = rows * M * 2;
      hop::mbar_expect(bar + RUNS_RING, bytes * imgs);
      for (int li = 0; li < imgs; ++li)
        hop::bulk_g2s(raw + li * ROWS * M,
                      x + ((long long)(n_first + li) * a.Ci + ci0) * M, bytes,
                      bar + RUNS_RING);
    }
    hop::mbar_wait(bar + RUNS_RING, 0);
    xs = raw;
  }
  dgrad_store<T>(a, acc, ci0, q0, xs, n_first);
}

// dynamic shared memory of each kernel; the only copy of this sum
// (conv1x1_plan picks wgrad's slots, bad_plan checks that they fit). lo:
// the fp16 wgrad's tile of f(x) - hi.
int smem_bytes(bool wgrad, bool runs, int M, int slots, bool lo = false) {
  const int extra = wgrad && lo ? TILE_BYTES : 0;
  if (!runs) return RING * 2 * TILE_BYTES + extra;
  if (wgrad) return BARS + 2 * TILE_BYTES + extra + slots * 2 * ROWS * M * 2;
  const int img = 1 + (COLS - 1 + M - 1) / M;
  return BARS + (RUNS_RING + 1) * TILE_BYTES +
         RUNS_RING * img * BK * M * 2;
}

template <typename K>
cudaError_t launch_dyn(K kern, dim3 grid, int smem, const Args& a,
                       cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kern<<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace wg

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
  a.vec_x = a.vec_w = 0;
  a.splits = 1; a.per = 0;
  a.vec = a.wvec = 1; a.slots = 0;
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

// the 16-bit dgrad / wgrad plan's arguments: runs need the channel counts
// and M that make each run 16-byte aligned; vec is 8, 4 or 1
bool bad_plan(bool wgrad, int N, int Ci, int Co, int M, int runs, int vec,
              int wvec, int slots, bool lo = false) {
  if ((long long)N * M >= (1LL << 31) || (vec != 8 && vec != 4 && vec != 1) ||
      (wvec != 8 && wvec != 4 && wvec != 1) || (vec != 1 && M % vec) ||
      (wvec != 1 && Ci % wvec))
    return true;
  if (!runs) return false;
  if (Ci % 8 || Co % 8 || M < 8 || M >= 64) return true;
  if (wgrad && (slots < 1 || slots > wg::MAX_SLOTS ||
                slots < (wg::BK - 1 + M - 1) / M + 3))
    return true;
  return wg::smem_bytes(wgrad, true, M, slots, lo) > wg::SMEM_MAX;
}

// da (N, Ci, M) in f32. 16-bit: runs != 0 stages dy and x as whole runs
// (cp.async.bulk), otherwise rows of dy are copied vec elements at a time;
// W's rows wvec at a time (1: element loads); f32 ignores them.
extern "C" int mxt_conv1x1_dgrad(int dtype, const void* x, const void* w,
                                 const void* dy, const float* scale,
                                 const float* shift, float* da, int N, int Ci,
                                 int Co, int M, int relu, int runs, int vec,
                                 int wvec, void* stream) {
  if (bad_sizes(N, Ci, Co, M)) return static_cast<int>(cudaErrorInvalidValue);
  Args a = make_args(x, w, dy, scale, shift, nullptr, da, nullptr, N, Ci, Co,
                     M, relu);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const dim3 grid((M + TN - 1) / TN, (Ci + TM - 1) / TM, N);
    return static_cast<int>(launch(dgrad_f32, grid, 256, a, st));
  }
  if ((dtype != 1 && dtype != 2) ||
      bad_plan(false, N, Ci, Co, M, runs, vec, wvec, 0))
    return static_cast<int>(cudaErrorInvalidValue);
  a.vec = vec; a.wvec = wvec;
  const long long nm = (long long)N * M;
  const dim3 grid(static_cast<unsigned>((nm + wg::COLS - 1) / wg::COLS),
                  (Ci + wg::ROWS - 1) / wg::ROWS);
  const int smem = wg::smem_bytes(false, runs, M, 0);
  cudaError_t e;
  if (dtype == 1)
    e = runs ? wg::launch_dyn(wg::dgrad_runs<__nv_bfloat16>, grid, smem, a, st)
             : wg::launch_dyn(wg::dgrad_rows<__nv_bfloat16>, grid, smem, a, st);
  else
    e = runs ? wg::launch_dyn(wg::dgrad_runs<__half>, grid, smem, a, st)
             : wg::launch_dyn(wg::dgrad_rows<__half>, grid, smem, a, st);
  return static_cast<int>(e);
}

// dw (Co, Ci) in w's dtype (the same as x's); ws is (splits, Co, Ci) f32
// scratch, splits >= 1 blocks along the N*M reduction, each adding its
// partial sums there; a second kernel adds them in split order. f32: per is
// derived here (steps of 16 positions). 16-bit: split s takes images
// [s * per, (s + 1) * per); runs != 0 streams whole runs through a ring
// of `slots` images (cp.async.bulk), otherwise rows are copied vec
// elements at a time.
extern "C" int mxt_conv1x1_wgrad(int dtype, const void* x, const void* dy,
                                 const float* scale, const float* shift,
                                 void* dw, float* ws, int N, int Ci, int Co,
                                 int M, int relu, int runs, int vec,
                                 int splits, int per, int slots,
                                 void* stream) {
  if (bad_sizes(N, Ci, Co, M) || splits < 1 || splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = make_args(x, nullptr, dy, scale, shift, nullptr, dw, ws, N, Ci, Co,
                     M, relu);
  a.splits = splits;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long count = (long long)Co * Ci;
  const dim3 rgrid(static_cast<unsigned>((count + 255) / 256));
  cudaError_t e;
  if (dtype == 0) {
    const long long steps = (long long)N * ((M + BK32 - 1) / BK32);
    a.per = static_cast<int>((steps + splits - 1) / splits);
    const dim3 grid((Ci + TN - 1) / TN, (Co + TM - 1) / TM, splits);
    e = launch(wgrad_f32, grid, 256, a, st);
    if (e == cudaSuccess) e = launch(wgrad_reduce<float>, rgrid, 256, a, st);
    return static_cast<int>(e);
  }
  if ((dtype != 1 && dtype != 2) || per < 1 ||
      (long long)(splits - 1) * per >= N || (long long)splits * per < N ||
      bad_plan(true, N, Ci, Co, M, runs, vec, 1, slots, dtype == 2))
    return static_cast<int>(cudaErrorInvalidValue);
  a.per = per; a.vec = vec; a.slots = slots;
  const dim3 grid((Ci + wg::COLS - 1) / wg::COLS,
                  (Co + wg::ROWS - 1) / wg::ROWS, splits);
  const int smem = wg::smem_bytes(true, runs, M, slots, dtype == 2);
  if (dtype == 1) {
    e = runs ? wg::launch_dyn(wg::wgrad_runs<__nv_bfloat16>, grid, smem, a, st)
             : wg::launch_dyn(wg::wgrad_rows<__nv_bfloat16>, grid, smem, a, st);
    if (e == cudaSuccess)
      e = launch(wgrad_reduce<__nv_bfloat16>, rgrid, 256, a, st);
  } else {
    e = runs ? wg::launch_dyn(wg::wgrad_runs<__half>, grid, smem, a, st)
             : wg::launch_dyn(wg::wgrad_rows<__half>, grid, smem, a, st);
    if (e == cudaSuccess) e = launch(wgrad_reduce<__half>, rgrid, 256, a, st);
  }
  return static_cast<int>(e);
}
