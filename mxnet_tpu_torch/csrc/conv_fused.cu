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
// f to each x tile between its arrival in shared memory and the product, and
// dgrad recomputes the ReLU mask from x in its epilogue.
//
// What bounds them on an H100: at ResNet-50's junctions the work is 2*Co*Ci
// flops per (n, m) against (Ci + Co) * 2 bytes moved, fewer than 300 flops a
// byte for every shape but the stage-4 ones (Ci*Co = 1M, bound by flops),
// so the floor is moving x, dy and the output once through HBM; the kernels
// keep f(x) and the ReLU mask out of HBM for that reason.
//
// The 16-bit fwd and dgrad (namespace tc) share one copy path, shaped for
// that floor: a persistent block of three warpgroups walks output tiles; one
// thread of the producer warpgroup streams every operand tile into a ring
// of shared-memory slots on mbarriers, and the two consumer warpgroups only
// multiply (wgmma, A from registers, B from shared memory) and store. The
// ring runs on across tiles, so one tile's epilogue overlaps the next
// tile's loads however short the contraction (dgrad at Co = 64 has one
// step). Positions are cut into 64-wide panels of one image each. W comes
// by TMA (128-byte swizzle) at every shape. The activation comes by TMA
// where its rows are 16-byte multiples (M % 8 == 0: 3136, 784), and
// otherwise (M = 196, 49) as the whole 64-channel runs of the images a
// tile touches, one cp.async.bulk each: dgrad's consumers repack them into
// the swizzled B operand, fwd's build their A fragments from them.
// dgrad's ReLU mask comes from an x tile that the producer streams through
// the same ring after each tile's last step (rows), or from x read along
// the positions by the threads that store da (runs); fwd's f is applied to
// the A fragment in registers (f(x) rounded to 16 bits once, as the plain
// version). Outputs leave through shared memory: a TMA store (rows), else
// stores by the warpgroup's threads along the positions, 32 consecutive
// ones a warp. Other shapes (channels not multiples of 8, operands not
// 16-byte aligned, runs too long for two slots) take the general path:
// the FMA kernels below, one template for every dtype, exact f32 products
// (no TF32, as the TPU kernels' Precision.HIGHEST).
//
// The 16-bit wgrad (namespace wg) is 128 x 128 tiles of two warpgroups on
// wgmma m64n128k16 over the no-swizzle layout of hopper.cuh, operands by
// per-thread cp.async or cp.async.bulk runs (below); it splits the
// reduction over whole images so that at least 132 blocks run at every
// junction, and a second pass adds the splits' f32 partial sums in split
// order, so dW is the same from run to run.
// Zero-filled rows and positions never enter a sum, and f(0) is never
// written where x was absent.
//
// Experiments: built with -DMXT_CONV_CUT=1 the tc kernels' copies after the
// first ring of stages are cut (the consumers read stale tiles), =2 the
// products are cut, =3 the epilogue (mask, staging, stores) is cut. The
// results are wrong; chip_smoke.py --probe-conv times each beside the full
// kernel.
#include <stdint.h>

#include <algorithm>

#include "flash_common.cuh"
#include "hopper.cuh"
#include "tma_host.cuh"

#ifndef MXT_CONV_CUT
#define MXT_CONV_CUT 0
#endif

namespace {

using mxt::Half;

constexpr int TM = 64;       // output rows per FMA block
constexpr int TN = 64;       // output columns per FMA block
constexpr int BK32 = 16;     // contraction depth per FMA step

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
  int splits;  // wgrad: blocks along the N*M reduction
  int per;     // wgrad: reduction steps (f32) or images (16-bit) per split
  int vec;     // 16-bit wgrad: elements per copy of x / dy rows: 8, 4
               // (cp.async) or 1 (element loads)
  int slots;   // images in wgrad's ring (runs)
};

template <typename T> __device__ __forceinline__ float to_f32(uint16_t b);
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(uint16_t b) {
  return __uint_as_float(static_cast<uint32_t>(b) << 16);
}
template <> __device__ __forceinline__ float to_f32<__half>(uint16_t b) {
  return __half2float(__ushort_as_half(b));
}

// element i of a T tensor as f32; a value rounded to T and back (what the
// plain version's .to(w.dtype) does to f(x))
template <typename T> __device__ __forceinline__ float ld(const void* p,
                                                          long long i) {
  return to_f32<T>(static_cast<const uint16_t*>(p)[i]);
}
template <> __device__ __forceinline__ float ld<float>(const void* p,
                                                       long long i) {
  return static_cast<const float*>(p)[i];
}
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32<T>(Half<T>::bits(v));
}
template <> __device__ __forceinline__ float round_to<float>(float v) {
  return v;
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

// ------------------------------------------------------- general path
// fwd: grid (ceil(M / 64), ceil(Co / 64), N), 256 threads, each 4 x 4
// outputs of the 64 x 64 tile (rows ty + 16 i, columns tx + 16 j), exact
// f32 FMA over Ci in steps of 16; f(x) rounded to T first, the output
// rounded to T once. f32 inputs and the 16-bit shapes TMA cannot describe.
template <typename T>
__global__ void __launch_bounds__(256) fwd_fma(Args a) {
  constexpr int BK = BK32;
  __shared__ float sA[BK][TM + 4];  // W^T: [ci][co]
  __shared__ float sB[BK][TN + 4];  // f(x): [ci][m]
  const int m0 = blockIdx.x * TN, co0 = blockIdx.y * TM;
  const long long n = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long xoff = n * a.Ci * a.M;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < a.Ci; k0 += BK) {
    for (int e = tid; e < TM * BK; e += 256) {
      const int r = e / BK, c = e % BK;
      sA[c][r] = (co0 + r < a.Co && k0 + c < a.Ci)
                     ? ld<T>(a.w, (long long)(co0 + r) * a.Ci + k0 + c) : 0.f;
    }
    for (int e = tid; e < BK * TN; e += 256) {
      const int r = e / TN, c = e % TN;
      const bool in = k0 + r < a.Ci && m0 + c < a.M;
      sB[r][c] = in ? round_to<T>(prologue(
                          ld<T>(a.x, xoff + (long long)(k0 + r) * a.M + m0 + c),
                          a.scale, a.shift, k0 + r, a.relu))
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
  const long long yoff = n * a.Co * a.M;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int co = co0 + ty + 16 * i;
    if (co >= a.Co) continue;
    const float b = a.bias ? a.bias[co] : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + tx + 16 * j;
      if (m < a.M) put<T>(a.out, yoff + (long long)co * a.M + m, acc[i][j] + b);
    }
  }
}

// dgrad: the 64 x 64 FMA tile of fwd_fma over W^T and dy, the ReLU mask in
// the epilogue, f32 out
template <typename T>
__global__ void __launch_bounds__(256) dgrad_fma(Args a) {
  constexpr int BK = BK32;
  __shared__ float sA[BK][TM + 4];  // W: [co][ci]
  __shared__ float sB[BK][TN + 4];  // dy: [co][m]
  const int m0 = blockIdx.x * TN, ci0 = blockIdx.y * TM;
  const long long n = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long dyoff = n * a.Co * a.M;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < a.Co; k0 += BK) {
    for (int e = tid; e < BK * TM; e += 256) {
      const int r = e / TM, c = e % TM;
      sA[r][c] = (k0 + r < a.Co && ci0 + c < a.Ci)
                     ? ld<T>(a.w, (long long)(k0 + r) * a.Ci + ci0 + c) : 0.f;
    }
    for (int e = tid; e < BK * TN; e += 256) {
      const int r = e / TN, c = e % TN;
      sB[r][c] = (k0 + r < a.Co && m0 + c < a.M)
                     ? ld<T>(a.dy, dyoff + (long long)(k0 + r) * a.M + m0 + c)
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
  const long long xoff = n * a.Ci * a.M;
  float* da = static_cast<float*>(a.out) + xoff;
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
      if (a.relu && !(affine(ld<T>(a.x, xoff + row + m), a.scale, a.shift,
                             ci) > 0.f))
        v = 0.f;
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

// ------------------------------------------------------------ wgrad, 16-bit
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
template <typename T, bool SPLIT = false>
__device__ __forceinline__ void mma_step(float* acc, const uint16_t* a,
                                         const uint16_t* b,
                                         const uint16_t* b2 = nullptr) {
  const uint32_t sa = hop::smem_u32(a), sb = hop::smem_u32(b);
  hop::fence_regs(acc, 64);
  hop::wgmma_fence();
#pragma unroll
  for (int s = 0; s < BK / 16; ++s)
    hop::wgmma_128<T>(acc, hop::desc(sa + s * 2 * LBO, LBO),
                              hop::desc(sb + s * 2 * LBO, LBO));
  if (SPLIT) {
    const uint32_t sb2 = hop::smem_u32(b2);
#pragma unroll
    for (int s = 0; s < BK / 16; ++s)
      hop::wgmma_128<T>(acc, hop::desc(sa + s * 2 * LBO, LBO),
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
    mma_step<T, SplitF<T>::value>(acc, st + wgi * 64 * 8, st + TILE, lo);
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
    mma_step<T, SplitF<T>::value>(acc, canon + wgi * 64 * 8,
                                     canon + TILE, lo);
    mma_done(acc);
  }
  wgrad_store(a, acc, split, co0, ci0);
}

// dynamic shared memory of the wgrad kernels; the only copy of this sum
// (conv1x1_plan picks the slots, bad_plan checks that they fit). lo: the
// fp16 wgrad's tile of f(x) - hi.
int smem_bytes(bool runs, int M, int slots, bool lo = false) {
  const int extra = lo ? TILE_BYTES : 0;
  if (!runs) return RING * 2 * TILE_BYTES + extra;
  return BARS + 2 * TILE_BYTES + extra + slots * 2 * ROWS * M * 2;
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

// ------------------------------------------------- fwd and dgrad, 16-bit
// One copy path for both (the file's head says why): a persistent block of
// three warpgroups walks its tiles t = blockIdx.x, + gridDim.x, ...; the
// producer warpgroup's first thread fills a ring of `stages` slots, slot
// fill % stages for the fill-th copy of the block, announced on full[slot]
// (phase fill / stages) and freed by the eight consumer warps on
// empty[slot]. A tile's fills are its contraction steps (W and the
// activation, 64 deep) and, for dgrad with the ReLU on TMA rows, one more:
// the x tile of its mask. Positions come in panels of 64 of one image,
// P = n * ppi + pi (ppi = ceil(M / 64) a image), each panel in shared
// memory 64 rows of 128 swizzled bytes (8 KB). How the activation (dy for
// dgrad, x for fwd) arrives, by M:
//   rows (M % 8 == 0): a TMA box of 64 channels x 64 positions a panel;
//   runs (else): the 64 channels of one image are one contiguous run of
//     64 * M elements, 16-byte aligned (channels multiples of 8): one
//     cp.async.bulk an image the tile's panels touch. The consumers
//     repack the runs into swizzled panels (two buffers, one barrier a
//     step): dgrad's B, by both warpgroups; each fwd warpgroup its own
//     A panel, f applied there. TMA cannot take these rows: a box whose
//     first element is not 16-byte aligned faults (error 715).
namespace tc {

constexpr int THREADS = 384;         // two consumer warpgroups, a producer
constexpr int ROWB = 128;            // one swizzled row: 64 16-bit values
constexpr int PANEL = 64 * ROWB;     // 64 rows of one: 8 KB
constexpr int BK = 64;               // contraction per ring step
constexpr int MAX_STAGES = 6;
constexpr int BAR_BYTES = 256;
constexpr int SMEM_MAX = 232448;

struct Maps {
  CUtensorMap w;    // W (Co, Ci): boxes of 64 ci x (64 or CT) co rows
  CUtensorMap act;  // dgrad: dy, fwd: x (rows): 64 x 64 boxes
  CUtensorMap x;    // dgrad's mask (rows): x, as act
  CUtensorMap out;  // dgrad: da f32, 32 x 64 boxes; fwd: y, 64 x CT boxes
};

// A launch's shape, walk and shared-memory layout (byte offsets from the
// 1024-byte aligned base), derived by make_plan; conv1x1_plan in Python
// gives the same numbers.
struct Plan {
  int N, Ci, Co, M;
  int runs;       // the activation by runs (M % 8 != 0), else TMA rows
  int ppi;        // panels a image
  int panels;     // N * ppi
  int pb;         // panels a tile
  int nct;        // output-channel tiles: ci (dgrad) or co (fwd)
  int tiles;      // ceil(panels / pb) * nct
  int steps;      // contraction steps a tile
  int imgs;       // runs: most images the panels of one tile touch
  int slot, stages, bt_at, out_at, bar_at, smem;
  int store;      // STORE_TMA, STORE_BULK or STORE_THREADS
  int relu;
  const float* scale;  // (Ci,) or null
  const float* shift;
  const float* bias;   // fwd: (Co,) or null
  const void* act;     // dgrad: dy, fwd: x (the runs' source)
  const void* x;       // dgrad (runs): x, for the mask
  void* out;           // da or y, for the bulk and the threads' stores
};

// how a warpgroup's output tile leaves its staging: TMA boxes (rows of
// 16-byte multiples), one 1-D bulk copy a panel (a panel is a whole image,
// M <= 64: its channel rows are one contiguous run), or the threads'
// stores along the positions
constexpr int STORE_TMA = 0, STORE_BULK = 1, STORE_THREADS = 2;

// byte offset of 16-byte chunk c of row r in a 128-byte-swizzled tile
__device__ __forceinline__ int swz(int r, int c) {
  return r * ROWB + ((c ^ (r & 7)) << 4);
}

// image and first position of panel P
struct PanelAt {
  int n, p0;
  __device__ __forceinline__ PanelAt(int P, int ppi)
      : n(P / ppi), p0((P - (P / ppi) * ppi) * 64) {}
};

// This lane's address for ldsm_x4_trans of the A fragment (16 m x 16 k:
// m rows m0 .. m0 + 15, k16 step kk) out of a 64 x 64 MN-major panel (row
// k holds 64 m): matrix l / 8 covers m half (l / 8) & 1, k half (l / 8) >> 1
__device__ __forceinline__ uint32_t a_addr(uint32_t panel, int m0, int kk,
                                           int lane) {
  const int mi = lane >> 3;
  return panel + swz(16 * kk + ((mi >> 1) << 3) + (lane & 7),
                     (m0 >> 3) + (mi & 1));
}

// the ring's barriers and slot of the fill-th copy; a wait that does not
// end traps (a launch error, not a hung card)
struct Ring {
  uint8_t* base;
  uint64_t* full;
  uint64_t* empty;
  int slot_bytes, stages;
  __device__ __forceinline__ uint8_t* slot(int fill) const {
    return base + (fill % stages) * slot_bytes;
  }
  __device__ __forceinline__ uint64_t* bar(int fill) const {
    return full + fill % stages;
  }
  // producer: wait until the slot of this fill is free, then announce
  // `bytes`; false when the copies are cut (an arrival stands for them)
  __device__ __forceinline__ bool begin(int fill, uint32_t bytes) const {
    const int s = fill % stages;
    if (fill >= stages)
      hop::mbar_wait_or_trap(empty + s, ((fill / stages) + 1) & 1);
    if (MXT_CONV_CUT == 1 && fill >= stages) {
      hop::mbar_arrive(full + s);
      return false;
    }
    hop::mbar_expect(full + s, bytes);
    return true;
  }
  __device__ __forceinline__ void wait(int fill) const {
    hop::mbar_wait_or_trap(full + fill % stages, (fill / stages) & 1);
  }
  // consumer warp: done reading the slot
  __device__ __forceinline__ void release(int fill, int lane) const {
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(empty + fill % stages);
  }
};

// the 1024-byte aligned base of the dynamic shared memory and the ring's
// barriers there, initialized
__device__ __forceinline__ Ring make_ring(unsigned char* raw, const Plan& p,
                                          unsigned char** base) {
  const uint32_t a = hop::smem_u32(raw);
  unsigned char* sm = raw + (((a + 1023u) & ~1023u) - a);
  Ring r;
  r.base = sm;
  r.full = reinterpret_cast<uint64_t*>(sm + p.bar_at);
  r.empty = r.full + p.stages;
  r.slot_bytes = p.slot;
  r.stages = p.stages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      hop::mbar_init(r.full + s, 1);
      hop::mbar_init(r.empty + s, 8);
    }
    hop::mbar_init_fence();
  }
  __syncthreads();
  *base = sm;
  return r;
}

// The producer's copies of one contraction step: W's boxes by `load_w`,
// then the activation (K channels a image, channels k0 .. k0 + 63) of
// panels P0 .. P0 + pb - 1 at w_bytes: TMA boxes (rows) or the runs of the
// images they touch (runs; image n_first + i at i * 128 * M).
template <typename LoadW>
__device__ __forceinline__ void load_step(const Ring& ring, int fill,
                                          const Plan& p, const Maps& maps,
                                          const uint16_t* act, int K, int k0,
                                          int P0, int w_bytes, LoadW load_w) {
  const int n_first = P0 / p.ppi;
  int imgs = 0;
  uint32_t act_bytes = p.pb * PANEL;
  const int rows = min(BK, K - k0);
  if (p.runs) {
    imgs = min(p.panels - 1, P0 + p.pb - 1) / p.ppi - n_first + 1;
    act_bytes = imgs * rows * p.M * 2;
  }
  if (!ring.begin(fill, w_bytes + act_bytes)) return;
  uint8_t* st = ring.slot(fill);
  uint64_t* bar = ring.bar(fill);
  load_w(st, bar);
  if (p.runs) {
    for (int i = 0; i < imgs; ++i)
      hop::bulk_g2s(st + w_bytes + i * 128 * p.M,
                    act + ((long long)(n_first + i) * K + k0) * p.M,
                    rows * p.M * 2, bar);
  } else {
    for (int pp = 0; pp < p.pb; ++pp) {
      const PanelAt at(P0 + pp, p.ppi);
      hop::tma_load_4d(st + w_bytes + pp * PANEL, &maps.act, bar, at.p0, k0,
                       at.n, 0);
    }
  }
}

// ----------------------------------------------------------------- dgrad
// wgmma's M rows are ci (A = W^T, each warpgroup's 64 channels, from W's
// natural 64 x 64 panel by ldmatrix.trans: row co of the panel is k), its
// N columns 128 positions (B = dy, MN-major, two panels). A block's tile is
// CB channels x 256 / CB panels: at CB = 128 the two warpgroups split the
// channels and share dy, at CB = 64 (Ci <= 64) they split the panels and
// share W, so no warpgroup multiplies zero rows. Tiles run ci-tile
// fastest, so the blocks that read one dy panel run together (L2). Slot: W
// (CB / 64 panels of 64 co rows), then dy (panels, or runs); with TMA rows
// and the ReLU the mask's x tile (CB / 64 x 256 / CB panels of 64 ci rows)
// takes a slot of its own. Each warpgroup masks its 64 x 128 f32 tile
// while staging it (x from that fill, or for runs from device memory at
// the fragment's own positions): four 128-byte-swizzled 32-position boxes
// for a TMA store (M % 4 == 0) or the threads' stores, or dense rows of M
// for one bulk store a panel (M <= 64).
template <typename T, int CB>
__global__ void __launch_bounds__(THREADS, 1)
    dgrad_tma(const __grid_constant__ Maps maps, const Plan p) {
  constexpr int CBLK = CB / 64, PB = 256 / CB, W_BYTES = CBLK * PANEL;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm;
  const Ring ring = make_ring(smem_raw, p, &sm);
  const int tid = threadIdx.x;

  if (tid >= 256) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid != 256) return;
    const uint16_t* dy = static_cast<const uint16_t*>(p.act);
    int fill = 0;
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
      const int grp = t / p.nct, c0 = (t - grp * p.nct) * CB;
      for (int s = 0; s < p.steps; ++s, ++fill)
        load_step(ring, fill, p, maps, dy, p.Co, s * BK, grp * PB, W_BYTES,
                  [&](uint8_t* st, uint64_t* bar) {
                    for (int cb = 0; cb < CBLK; ++cb)
                      hop::tma_load_4d(st + cb * PANEL, &maps.w, bar,
                                       c0 + 64 * cb, s * BK, 0, 0);
                  });
      if (p.relu && !p.runs) {
        if (ring.begin(fill, CBLK * PB * PANEL)) {
          uint8_t* st = ring.slot(fill);
          for (int cb = 0; cb < CBLK; ++cb)
            for (int pp = 0; pp < PB; ++pp) {
              const PanelAt at(grp * PB + pp, p.ppi);
              hop::tma_load_4d(st + (cb * PB + pp) * PANEL, &maps.x,
                               ring.bar(fill), at.p0, c0 + 64 * cb, at.n, 0);
            }
        }
        ++fill;
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const bool lead = (tid & 127) == 0;
  const int wci = CB == 128 ? 64 * wg : 0;  // this warpgroup's channels
  const int wpp = CB == 128 ? 0 : 2 * wg;   // and its first panel
  float* stage = reinterpret_cast<float*>(sm + p.out_at) + wg * 64 * 128;
  int fill = 0;
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    const int grp = t / p.nct, c0 = (t - grp * p.nct) * CB;
    const int P0 = grp * PB, n_first = P0 / p.ppi, ci0 = c0 + wci;
    const PanelAt at0(P0 + wpp, p.ppi), at1(P0 + wpp + 1, p.ppi);
    const bool in0 = P0 + wpp < p.panels, in1 = P0 + wpp + 1 < p.panels;
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    // step s's operands from fill f: A (W^T, by ldmatrix) into a, and for
    // runs the B panels repacked into buffer f & 1 (rewritten two steps
    // on, once both warpgroups passed the next step's barrier, which
    // follows their product of this step); B's address. Runs free the
    // slot here, rows once the product has read B.
    auto operands = [&](uint32_t (&a)[4][4], int s, int f) -> uint32_t {
      ring.wait(f);
      const uint8_t* st = ring.slot(f);
      const uint8_t* b = st + W_BYTES + wpp * PANEL;
      if (p.runs) {
        uint8_t* bt = sm + p.bt_at + (f & 1) * PB * PANEL;
        const uint32_t runs = hop::smem_u32(st + W_BYTES);
        const int rows = min(BK, p.Co - s * BK);
        for (int id = tid; id < PB * 512; id += 256) {
          const int pp = id >> 9, k = (id >> 3) & 63, c = id & 7;
          uint32_t v[4] = {0u, 0u, 0u, 0u};
          if (P0 + pp < p.panels && k < rows) {
            const PanelAt at(P0 + pp, p.ppi);
            const uint32_t src =
                runs + 2 * (((at.n - n_first) * 64 + k) * p.M + at.p0 + 8 * c);
            const int left = p.M - at.p0 - 8 * c;
#pragma unroll
            for (int e = 0; e < 8; ++e)
              if (e < left)
                v[e >> 1] |= static_cast<uint32_t>(hop::lds_u16(src + 2 * e))
                             << (16 * (e & 1));
          }
          *reinterpret_cast<uint4*>(bt + pp * PANEL + swz(k, c)) =
              make_uint4(v[0], v[1], v[2], v[3]);
        }
        hop::fence_async_smem();
        b = bt + wpp * PANEL;
      }
      if (MXT_CONV_CUT != 2) {
        const uint32_t wp = hop::smem_u32(st + (wci >> 6) * PANEL);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hop::ldsm_x4_trans(a[kk], a_addr(wp, 16 * warp, kk, lane));
      }
      if (p.runs) ring.release(f, lane);
      return hop::smem_u32(b);
    };
    auto product = [&](const uint32_t (&a)[4][4], uint32_t b) {
      if (MXT_CONV_CUT == 2) return;
      hop::fence_regs(acc, 64);
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hop::wgmma_rs<T, 128, 1>(
            acc, a[kk], hop::desc_mnmajor_sw128(b + kk * 16 * ROWB, PANEL),
            1);
      hop::wgmma_commit();
    };
    auto finish = [&](int f) {
      hop::wgmma_wait<0>();
      hop::fence_regs(acc, 64);
      if (!p.runs) ring.release(f, lane);
    };
    for (int s = 0; s < p.steps; ++s) {
      uint32_t a[4][4];
      const uint32_t b = operands(a, s, fill);
      if (p.runs) hop::named_sync(3, 256);  // both warpgroups' repack
      product(a, b);
      finish(fill++);
    }

    // ------------------------------------------------------------ epilogue
    const bool x_fill = p.relu && !p.runs;
    const uint8_t* xs = nullptr;
    if (x_fill) {
      ring.wait(fill);
      xs = ring.slot(fill) + ((wci >> 6) * PB + wpp) * PANEL;
    }
    if (MXT_CONV_CUT == 3) {
#pragma unroll
      for (int i = 0; i < 64; ++i) asm volatile("" ::"f"(acc[i]));
    } else {
      // rows 16 warp + g8 (+ 8): scale, shift for the mask; for runs the
      // mask's x at this thread's positions 8 (j & 7) + 2 t4, + 1 of panel
      // j >> 3 from device memory, every load in flight together
      float sc[2], sh[2];
      const bool aff = p.relu && p.scale != nullptr;
      uint32_t xr[2][16];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ci = ci0 + 16 * warp + g8 + 8 * h;
        sc[h] = aff && ci < p.Ci ? __ldg(p.scale + ci) : 1.f;
        sh[h] = aff && ci < p.Ci ? __ldg(p.shift + ci) : 0.f;
        if (!(p.relu && p.runs)) continue;
        const uint16_t* x = static_cast<const uint16_t*>(p.x);
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const PanelAt& at = (j >> 3) ? at1 : at0;
          const bool in = ((j >> 3) ? in1 : in0) && ci < p.Ci;
          const int q = at.p0 + 8 * (j & 7) + 2 * t4;
          const uint16_t* e = x + ((long long)at.n * p.Ci + ci) * p.M + q;
          const uint32_t lo = in && q < p.M ? e[0] : 0u;
          const uint32_t hi = in && q + 1 < p.M ? e[1] : 0u;
          xr[h][j] = lo | (hi << 16);
        }
      }
      if (lead) hop::bulk_wait_read<0>();  // the last tile's stores read it
      hop::named_sync(1 + wg, 128);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * warp + g8 + 8 * h;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
          if (p.relu) {
            const uint32_t xw =
                xs ? *reinterpret_cast<const uint32_t*>(
                         xs + (j >> 3) * PANEL + swz(r, j & 7) + 4 * t4)
                   : xr[h][j];
            float x0 = to_f32<T>(static_cast<uint16_t>(xw));
            float x1 = to_f32<T>(static_cast<uint16_t>(xw >> 16));
            if (aff) {
              x0 = __fadd_rn(__fmul_rn(x0, sc[h]), sh[h]);
              x1 = __fadd_rn(__fmul_rn(x1, sc[h]), sh[h]);
            }
            if (!(x0 > 0.f)) v0 = 0.f;
            if (!(x1 > 0.f)) v1 = 0.f;
          }
          const int q = 8 * (j & 7) + 2 * t4;  // in panel j >> 3
          if (p.store == STORE_BULK) {  // dense: panel i's rows of M
            float* d = stage + (j >> 3) * 64 * p.M + r * p.M + q;
            if (q < p.M) d[0] = v0;
            if (q + 1 < p.M) d[1] = v1;
          } else {  // box 2 (j >> 3) + (q >> 5), 32 positions a row
            uint8_t* box = reinterpret_cast<uint8_t*>(
                stage + ((j >> 3) * 2 + (q >> 5)) * 2048);
            *reinterpret_cast<float2*>(box + swz(r, (q & 31) >> 2) +
                                       4 * (q & 3)) = make_float2(v0, v1);
          }
        }
      }
      hop::fence_async_smem();
      hop::named_sync(1 + wg, 128);
      const int rows = min(64, p.Ci - ci0);
      if (p.store == STORE_TMA) {
        if (lead && rows > 0) {
          for (int i = 0; i < 2 && P0 + wpp + i < p.panels; ++i) {
            const PanelAt at(P0 + wpp + i, p.ppi);
            for (int hb = 0; hb < 2 && at.p0 + 32 * hb < p.M; ++hb)
              hop::tma_store_4d(&maps.out, stage + (2 * i + hb) * 2048,
                                at.p0 + 32 * hb, ci0, at.n, 0);
          }
          hop::bulk_commit();
        }
      } else if (p.store == STORE_BULK) {  // a panel is a whole image
        if (lead && rows > 0) {
          float* da = static_cast<float*>(p.out);
          for (int i = 0; i < 2 && P0 + wpp + i < p.panels; ++i)
            hop::bulk_s2g(
                da + ((long long)PanelAt(P0 + wpp + i, p.ppi).n * p.Ci + ci0) *
                         p.M,
                stage + i * 64 * p.M, rows * p.M * 4);
          hop::bulk_commit();
        }
      } else {  // along the positions, 32 a warp
        float* da = static_cast<float*>(p.out);
        const uint32_t stage_s = hop::smem_u32(stage);
        for (int r = warp; r < rows; r += 4)
          for (int i = 0; i < 2 && P0 + wpp + i < p.panels; ++i) {
            const PanelAt at(P0 + wpp + i, p.ppi);
            float* row = da + ((long long)at.n * p.Ci + ci0 + r) * p.M + at.p0;
            for (int q = lane; q < 64 && at.p0 + q < p.M; q += 32)
              row[q] = hop::lds_f32(stage_s + (2 * i + (q >> 5)) * PANEL +
                                    swz(r, (q & 31) >> 2) + 4 * (q & 3));
          }
      }
    }
    if (x_fill) {
      ring.release(fill, lane);
      ++fill;
    }
  }
  if (lead) hop::bulk_wait<0>();
}

// ------------------------------------------------------------------- fwd
// y^T tiles: wgmma's M rows are 64 positions (one panel, each warpgroup its
// own; A = f(x)^T in registers by ldmatrix.trans: from the x panel with f
// applied in registers (rows), or from the panel the warpgroup repacked out
// of its image's run with f applied there (runs)), its N columns CT output
// channels (B = W's CT x 64 panel, K-major as W lies). So each x element
// is read and activated once per CT channels (128 where Co allows: at 256
// the 128 accumulators a thread spilled and ptxas serialized the wgmmas,
// C7512). A block's tile is 2 panels x CT channels, co-tile fastest. Slot:
// W (CT rows), then x (2 panels, or runs). Each warpgroup stages y, the
// sums started at the bias: a CT x 64 swizzled box for a TMA store (rows,
// M % 8 == 0) or the threads' stores, or dense rows of M for one bulk
// store (M <= 64).

// f of the two 16-bit values of a word (channels with scale s0 / s1, shift
// h0 / h1), rounded back to T: the plain version's __fmul_rn, __fadd_rn,
// ReLU (NaN passes), .to(T)
template <typename T>
__device__ __forceinline__ uint32_t f_word(uint32_t w, float s0, float h0,
                                           float s1, float h1, bool aff,
                                           bool relu) {
  float v0 = to_f32<T>(static_cast<uint16_t>(w));
  float v1 = to_f32<T>(static_cast<uint16_t>(w >> 16));
  if (aff) {
    v0 = __fadd_rn(__fmul_rn(v0, s0), h0);
    v1 = __fadd_rn(__fmul_rn(v1, s1), h1);
  }
  if (relu) {
    v0 = v0 < 0.f ? 0.f : v0;
    v1 = v1 < 0.f ? 0.f : v1;
  }
  return Half<T>::pack(v0, v1);
}

template <typename T, int CT>
__global__ void __launch_bounds__(THREADS, 1)
    fwd_tma(const __grid_constant__ Maps maps, const Plan p) {
  constexpr int W_BYTES = CT * ROWB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm;
  const Ring ring = make_ring(smem_raw, p, &sm);
  const int tid = threadIdx.x;

  if (tid >= 256) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid != 256) return;
    const uint16_t* x = static_cast<const uint16_t*>(p.act);
    int fill = 0;
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
      const int grp = t / p.nct, co0 = (t - grp * p.nct) * CT;
      for (int s = 0; s < p.steps; ++s, ++fill)
        load_step(ring, fill, p, maps, x, p.Ci, s * BK, grp * 2, W_BYTES,
                  [&](uint8_t* st, uint64_t* bar) {
                    hop::tma_load_4d(st, &maps.w, bar, s * BK, co0, 0, 0);
                  });
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const bool lead = (tid & 127) == 0;
  const bool aff = p.scale != nullptr, relu = p.relu != 0;
  uint8_t* stage = sm + p.out_at + wg * CT * ROWB;
  int fill = 0;
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    const int grp = t / p.nct, co0 = (t - grp * p.nct) * CT;
    const int P = grp * 2 + wg;               // this warpgroup's panel
    const bool has = P < p.panels;
    const PanelAt at(has ? P : 0, p.ppi);
    const int li = at.n - (grp * 2) / p.ppi;  // its image among the runs
    const int ma = 16 * warp + g8;  // positions ma, ma + 8 of the panel
    // the sums start at the bias (column 8 j + 2 t4 + e of element
    // 4 j + 2 h + e)
    float acc[CT / 2];
#pragma unroll
    for (int j = 0; j < CT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int co = co0 + 8 * j + 2 * t4 + e;
        const float b = p.bias && co < p.Co ? __ldg(p.bias + co) : 0.f;
        acc[4 * j + e] = acc[4 * j + 2 + e] = b;
      }
    // step s's A fragment from fill f into a, f applied; the slot is
    // released once the product has read W. Runs: this warpgroup's panel
    // is first repacked from its image's run into buffer f & 1 (a buffer
    // is rewritten two steps on, after the warpgroup's barrier that
    // follows its ldmatrix), f applied there, once an element.
    auto operands = [&](uint32_t (&a)[4][4], int s, int f) -> uint32_t {
      ring.wait(f);
      const uint8_t* st = ring.slot(f);
      if (MXT_CONV_CUT == 2) return hop::smem_u32(st);
      uint32_t xp = hop::smem_u32(st + W_BYTES + wg * PANEL);
      if (p.runs) {
        uint8_t* bt = sm + p.bt_at + ((f & 1) * 2 + wg) * PANEL;
        const uint32_t run = hop::smem_u32(st + W_BYTES + li * 128 * p.M);
        for (int id = tid & 127; id < 512; id += 128) {
          const int k = id >> 3, c = id & 7, ci = s * BK + k;
          const int q = at.p0 + 8 * c;  // positions q .. q + 7
          uint32_t v[4] = {0u, 0u, 0u, 0u};
          if (has && ci < p.Ci && q < p.M) {
            const bool in = aff && ci < p.Ci;
            const float sc = in ? __ldg(p.scale + ci) : 1.f;
            const float sh = in ? __ldg(p.shift + ci) : 0.f;
            const uint32_t src = run + 2 * (k * p.M + q);
#pragma unroll
            for (int e = 0; e < 8; e += 2) {
              const uint32_t lo =
                  q + e < p.M ? hop::lds_u16(src + 2 * e) : 0u;
              const uint32_t hi =
                  q + e + 1 < p.M ? hop::lds_u16(src + 2 * e + 2) : 0u;
              const uint32_t w = lo | (hi << 16);
              // absent positions stay 0, not f(0)
              const uint32_t keep = q + e + 1 < p.M ? 0xffffffffu
                                    : q + e < p.M   ? 0xffffu
                                                    : 0u;
              v[e >> 1] = (aff || relu)
                              ? f_word<T>(w, sc, sh, sc, sh, aff, relu) & keep
                              : w;
            }
          }
          *reinterpret_cast<uint4*>(bt + swz(k, c)) =
              make_uint4(v[0], v[1], v[2], v[3]);
        }
        hop::named_sync(1 + wg, 128);
        xp = hop::smem_u32(bt);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        hop::ldsm_x4_trans(a[kk], a_addr(xp, 16 * warp, kk, lane));
        if (p.runs || !(aff || relu)) continue;
        // a0, a1: channels c, c + 1 at positions ma, ma + 8; a2, a3:
        // channels c + 8, c + 9
        const int c = s * BK + 16 * kk + 2 * t4;
        float sc[4], sh[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int ci = c + (i & 1) + 8 * (i >> 1);
          const bool in = aff && ci < p.Ci;  // absent channels: f = 0
          sc[i] = in ? __ldg(p.scale + ci) : 0.f;
          sh[i] = in ? __ldg(p.shift + ci) : 0.f;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 2 * (r >> 1);
          a[kk][r] = f_word<T>(a[kk][r], sc[i], sh[i], sc[i + 1], sh[i + 1],
                               aff, relu);
        }
      }
      return hop::smem_u32(st);
    };
    auto product = [&](const uint32_t (&a)[4][4], uint32_t wb) {
      if (MXT_CONV_CUT == 2) return;
      hop::fence_regs(acc, CT / 2);
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hop::wgmma_rs<T, CT, 0>(acc, a[kk],
                                hop::desc_kmajor_sw128(wb + 32 * kk), 1);
      hop::wgmma_commit();
    };
    auto finish = [&](int f) {
      hop::wgmma_wait<0>();
      hop::fence_regs(acc, CT / 2);
      ring.release(f, lane);
    };
    for (int s = 0; s < p.steps; ++s) {
      uint32_t a[4][4];
      const uint32_t w = operands(a, s, fill);
      product(a, w);
      finish(fill++);
    }

    // ------------------------------------------------------------ epilogue
    if (MXT_CONV_CUT == 3) {
#pragma unroll
      for (int i = 0; i < CT / 2; ++i) asm volatile("" ::"f"(acc[i]));
      continue;
    }
    if (lead) hop::bulk_wait_read<0>();  // the last tile's store read it
    hop::named_sync(1 + wg, 128);
    const bool dense = p.store == STORE_BULK;  // rows of M: the image
#pragma unroll
    for (int j = 0; j < CT / 8; ++j) {
      const int c = 8 * j + 2 * t4;  // channels c, c + 1 of the tile
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = ma + 8 * h;  // position in the panel
        const uint16_t y0 = Half<T>::bits(acc[4 * j + 2 * h]);
        const uint16_t y1 = Half<T>::bits(acc[4 * j + 2 * h + 1]);
        if (dense) {
          uint16_t* d = reinterpret_cast<uint16_t*>(stage) + c * p.M + r;
          if (r < p.M) {
            d[0] = y0;
            d[p.M] = y1;
          }
        } else {
          const int off = (r & 7) * 2;
          *reinterpret_cast<uint16_t*>(stage + swz(c, r >> 3) + off) = y0;
          *reinterpret_cast<uint16_t*>(stage + swz(c + 1, r >> 3) + off) = y1;
        }
      }
    }
    hop::fence_async_smem();
    hop::named_sync(1 + wg, 128);
    if (!has) continue;
    if (p.store == STORE_TMA) {
      if (lead) {
        hop::tma_store_4d(&maps.out, stage, at.p0, co0, at.n, 0);
        hop::bulk_commit();
      }
    } else if (dense) {
      if (lead) {
        const int rows = min(CT, p.Co - co0);
        hop::bulk_s2g(static_cast<uint16_t*>(p.out) +
                          ((long long)at.n * p.Co + co0) * p.M,
                      stage, rows * p.M * 2);
        hop::bulk_commit();
      }
    } else {
      uint16_t* y = static_cast<uint16_t*>(p.out);
      const uint32_t stage_s = hop::smem_u32(stage);
      for (int c = warp; c < CT && co0 + c < p.Co; c += 4) {
        uint16_t* row = y + ((long long)at.n * p.Co + co0 + c) * p.M + at.p0;
        for (int q = lane; q < 64 && at.p0 + q < p.M; q += 32)
          row[q] = hop::lds_u16(stage_s + swz(c, q >> 3) + (q & 7) * 2);
      }
    }
  }
  if (lead) hop::bulk_wait<0>();
}

template <typename K>
cudaError_t launch(K kern, int blocks, const Maps& maps, const Plan& p,
                   cudaStream_t stream) {
  cudaError_t e = mxt::set_smem(kern, p.smem);
  if (e != cudaSuccess) return e;
  kern<<<blocks, THREADS, p.smem, stream>>>(maps, p);
  return cudaGetLastError();
}

// The walk and the layout of a launch (conv1x1_plan in Python mirrors
// it): `tile` output channels (dgrad: ci; fwd: co; 64 or 128) by 256 /
// tile (dgrad) or 2 (fwd) panels a tile; runs where M % 8 !=
// 0. false when the channels are not multiples of 8, the walk leaves int,
// or the ring takes fewer than two slots (runs of a large M).
bool make_plan(Plan* out, bool dgrad, int N, int Ci, int Co, int M, int tile,
               int relu) {
  if (N < 1 || Ci < 1 || Co < 1 || M < 1 || Ci % 8 || Co % 8 ||
      (long long)N * ((M + 63) / 64) * 64 >= (1LL << 31) ||
      (tile != 64 && tile != 128))
    return false;
  Plan p = {};
  p.N = N; p.Ci = Ci; p.Co = Co; p.M = M;
  p.runs = M % 8 != 0;
  p.ppi = (M + 63) / 64;
  p.panels = N * p.ppi;
  p.pb = dgrad ? 256 / tile : 2;
  p.nct = ((dgrad ? Ci : Co) + tile - 1) / tile;
  const int groups = (p.panels + p.pb - 1) / p.pb;
  p.tiles = groups * p.nct;
  p.steps = ((dgrad ? Co : Ci) + BK - 1) / BK;
  p.imgs = 0;
  if (p.runs)  // the start P0 % ppi repeats within ppi groups
    for (int grp = 0; grp < groups && grp < p.ppi; ++grp) {
      const int P0 = grp * p.pb;
      const int span =
          std::min(p.panels - 1, P0 + p.pb - 1) / p.ppi - P0 / p.ppi;
      p.imgs = std::max(p.imgs, span + 1);
    }
  const int w_bytes = dgrad ? tile / 64 * PANEL : tile * ROWB;
  const int act = p.runs ? (p.imgs * 128 * M + 1023) / 1024 * 1024
                         : p.pb * PANEL;
  p.slot = w_bytes + act;  // dgrad's x fill (rows) takes tile / 64 * pb
                           // panels: no more than W and dy's
  // runs: two buffers of repacked panels (dgrad's B, fwd's A)
  const int bt = p.runs ? 2 * p.pb * PANEL : 0;
  const int staging = dgrad ? 2 * 64 * 128 * 4 : 2 * tile * ROWB;
  const long long room = SMEM_MAX - 1024 - BAR_BYTES - bt - staging;
  p.stages =
      static_cast<int>(std::min<long long>(MAX_STAGES, room / p.slot));
  if (p.stages < 2) return false;
  p.bt_at = p.stages * p.slot;
  p.out_at = p.bt_at + bt;
  p.bar_at = p.out_at + staging;
  p.smem = p.bar_at + BAR_BYTES + 1024;
  p.store = (dgrad ? M % 4 : M % 8) == 0 ? STORE_TMA
             : p.ppi == 1                 ? STORE_BULK
                                          : STORE_THREADS;
  p.relu = relu != 0;
  *out = p;
  return true;
}

template <typename T>
cudaError_t dgrad(const void* x, const void* w, const void* dy,
                  const float* scale, const float* shift, float* da, int N,
                  int Ci, int Co, int M, int relu, int cb, int blocks,
                  cudaStream_t stream) {
  const CUtensorMapDataType type = mxt::TmaType<T>::value;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  Plan p;
  if (blocks < 1 || !make_plan(&p, true, N, Ci, Co, M, cb, relu) ||
      reinterpret_cast<uintptr_t>(dy) % 16)
    return cudaErrorInvalidValue;
  p.scale = scale; p.shift = shift; p.act = dy; p.x = x; p.out = da;
  Maps maps = {};
  if (!mxt::make_map_ncm(&maps.w, type, 2, w, 1, Co, Ci, 1, 64, 64, sw) ||
      (!p.runs &&
       (!mxt::make_map_ncm(&maps.act, type, 2, dy, N, Co, M, 1, 64, 64, sw) ||
        (relu && !mxt::make_map_ncm(&maps.x, type, 2, x, N, Ci, M, 1, 64, 64,
                                    sw)))) ||
      (p.store == STORE_TMA &&
       !mxt::make_map_ncm(&maps.out, mxt::TmaType<float>::value, 4, da, N, Ci,
                          M, 1, 32, 64, sw)))
    return cudaErrorInvalidValue;
  blocks = std::min(blocks, p.tiles);
  if (cb == 64) return launch(dgrad_tma<T, 64>, blocks, maps, p, stream);
  return launch(dgrad_tma<T, 128>, blocks, maps, p, stream);
}

template <typename T>
cudaError_t fwd(const void* x, const void* w, const float* scale,
                const float* shift, const float* bias, void* y, int N, int Ci,
                int Co, int M, int relu, int ct, int blocks,
                cudaStream_t stream) {
  const CUtensorMapDataType type = mxt::TmaType<T>::value;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  Plan p;
  if (blocks < 1 || !make_plan(&p, false, N, Ci, Co, M, ct, relu) ||
      reinterpret_cast<uintptr_t>(x) % 16)
    return cudaErrorInvalidValue;
  p.scale = scale; p.shift = shift; p.bias = bias; p.act = x; p.out = y;
  Maps maps = {};
  if (!mxt::make_map_ncm(&maps.w, type, 2, w, 1, Co, Ci, 1, 64, ct, sw) ||
      (!p.runs &&
       !mxt::make_map_ncm(&maps.act, type, 2, x, N, Ci, M, 1, 64, 64, sw)) ||
      (p.store == STORE_TMA &&
       !mxt::make_map_ncm(&maps.out, type, 2, y, N, Co, M, 1, 64, ct, sw)))
    return cudaErrorInvalidValue;
  blocks = std::min(blocks, p.tiles);
  if (ct == 128) return launch(fwd_tma<T, 128>, blocks, maps, p, stream);
  return launch(fwd_tma<T, 64>, blocks, maps, p, stream);
}

}  // namespace tc

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
  a.splits = 1; a.per = 0;
  a.vec = 1; a.slots = 0;
  return a;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (x, w and dy share it).
// Every tensor is contiguous: x (N, Ci, M), w (Co, Ci), dy (N, Co, M); scale,
// shift (Ci,) f32 or both null (no affine part); bias (Co,) f32 or null.
// Each returns cudaGetLastError(), or cudaErrorInvalidValue for arguments
// the kernels do not take.
//
// fwd and dgrad, 16-bit: tc != 0 takes the ring kernels of namespace tc
// (channels multiples of 8, every operand 16-byte aligned; TMA rows where
// M % 8 == 0, runs otherwise) with `tile` (64 or 128) output channels a
// block (dgrad: ci; fwd: co) and at most `blocks` persistent
// blocks; tc == 0, and f32, take the FMA kernels.

// y (N, Co, M) in x's dtype
extern "C" int mxt_conv1x1_fwd(int dtype, const void* x, const void* w,
                               const float* scale, const float* shift,
                               const float* bias, void* y, int N, int Ci,
                               int Co, int M, int relu, int tc, int tile,
                               int blocks, void* stream) {
  if (bad_sizes(N, Ci, Co, M)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tc) {
    if (dtype == 1)
      return static_cast<int>(tc::fwd<__nv_bfloat16>(
          x, w, scale, shift, bias, y, N, Ci, Co, M, relu, tile, blocks, st));
    if (dtype == 2)
      return static_cast<int>(tc::fwd<__half>(x, w, scale, shift, bias, y, N,
                                              Ci, Co, M, relu, tile, blocks,
                                              st));
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a = make_args(x, w, nullptr, scale, shift, bias, y, nullptr, N, Ci, Co,
                     M, relu);
  const dim3 grid((M + TN - 1) / TN, (Co + TM - 1) / TM, N);
  switch (dtype) {
    case 0: return static_cast<int>(launch(fwd_fma<float>, grid, 256, a, st));
    case 1: return static_cast<int>(launch(fwd_fma<__nv_bfloat16>, grid, 256, a, st));
    case 2: return static_cast<int>(launch(fwd_fma<__half>, grid, 256, a, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the 16-bit wgrad plan's arguments: runs need the channel counts and M
// that make each run 16-byte aligned; vec is 8, 4 or 1
bool bad_plan(int N, int Ci, int Co, int M, int runs, int vec, int slots,
              bool lo) {
  if ((long long)N * M >= (1LL << 31) || (vec != 8 && vec != 4 && vec != 1) ||
      (vec != 1 && M % vec))
    return true;
  if (!runs) return false;
  if (Ci % 8 || Co % 8 || M < 8 || M >= 64 || slots < 1 ||
      slots > wg::MAX_SLOTS || slots < (wg::BK - 1 + M - 1) / M + 3)
    return true;
  return wg::smem_bytes(true, M, slots, lo) > wg::SMEM_MAX;
}

// da (N, Ci, M) in f32
extern "C" int mxt_conv1x1_dgrad(int dtype, const void* x, const void* w,
                                 const void* dy, const float* scale,
                                 const float* shift, float* da, int N, int Ci,
                                 int Co, int M, int relu, int tc, int tile,
                                 int blocks, void* stream) {
  if (bad_sizes(N, Ci, Co, M)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tc) {
    if (dtype == 1)
      return static_cast<int>(tc::dgrad<__nv_bfloat16>(
          x, w, dy, scale, shift, da, N, Ci, Co, M, relu, tile, blocks, st));
    if (dtype == 2)
      return static_cast<int>(tc::dgrad<__half>(x, w, dy, scale, shift, da, N,
                                                Ci, Co, M, relu, tile, blocks,
                                                st));
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a = make_args(x, w, dy, scale, shift, nullptr, da, nullptr, N, Ci, Co,
                     M, relu);
  const dim3 grid((M + TN - 1) / TN, (Ci + TM - 1) / TM, N);
  switch (dtype) {
    case 0: return static_cast<int>(launch(dgrad_fma<float>, grid, 256, a, st));
    case 1: return static_cast<int>(launch(dgrad_fma<__nv_bfloat16>, grid, 256, a, st));
    case 2: return static_cast<int>(launch(dgrad_fma<__half>, grid, 256, a, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
      bad_plan(N, Ci, Co, M, runs, vec, slots, dtype == 2))
    return static_cast<int>(cudaErrorInvalidValue);
  a.per = per; a.vec = vec; a.slots = slots;
  const dim3 grid((Ci + wg::COLS - 1) / wg::COLS,
                  (Co + wg::ROWS - 1) / wg::ROWS, splits);
  const int smem = wg::smem_bytes(runs, M, slots, dtype == 2);
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
