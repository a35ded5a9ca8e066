// int8 convolution (and fully connected layer) for Hopper (sm_90a), bound
// through a plain C entry: one implicit-GEMM kernel on the int8 tensor
// cores (wgmma s8 x s8 -> s32), in two variants from one source:
//   int8 in, int32 out: the quantized operators' product;
//   f32 in, f32 out: a whole quantized layer, its input quantized as the
//     A tile is staged and its sums dequantized in the epilogue.
//
// Counterpart of mxnet_tpu/ops/quantization.py quantized_conv (:203-255)
// and quantized_fully_connected (:157-200), which hand int8 operands to
// lax.conv_general_dilated / lax.dot_general with preferred_element_type
// int32 so that XLA runs them on the TPU's int8 matrix unit, and of the
// chain mxnet_tpu/contrib/quantization.py QuantizedConv / QuantizedDense
// run around them (quantize_v2, the product, dequantize, the activation),
// which XLA fuses into one program. The JAX package writes no Pallas kernel
// for them, so none is replaced. PyTorch has no int8 convolution on the
// card, and f32 arithmetic stops being exact once a sum passes 2^24
// (ResNet-50's 3x3x512 convolution reaches 4608 * 127^2), so the port
// computes them here, exactly:
//   acc[m, g*Og + n] = sum_k A[m, k] * Wt[g*Og + n, k]  (+ bias[g*Og + n])
// m an output position (image, od, oh, ow), k a tap and input channel of
// group g, int32 accumulation (as the JAX op, wrapping on overflow, which
// |acc| <= K * 127^2 < 2^31 rules out for K < 133144). The f32 variant's
// A is q = clamp(rint(x * scale), -127, 127) and its output
// float(acc) * step, relu'd where the layer's activation is relu: the
// operators' own f32 operations (ops/quantization.py), each rounded alone
// (__fmul_rn, no contraction), so both variants give the bits of the
// unfused sequence. scale and step are device scalars read through a
// pointer: no host read, a CUDA graph captures the launch.
//
// Operands (ops/cuda/int8_conv.py prepares them and plans the launch,
// int8_plan): x (N, D, H, W, C) channels-last, or (N, C, D, H, W) for the
// reduction order (c, kd, kh, kw) (cf), int8 or f32, contiguous (1-d and
// 2-d inputs have D = H = 1 or D = 1); the weight packed (O, Kp) int8, row
// o holding output channel o's K taps in the reduction order, (kd, kh, kw,
// c) or (c, kd, kh, kw), zero-padded to Kp, a multiple of 16; bias int32
// (O,) or none; y (M, O) int32 or f32, channels-last: the caller views it
// in its layout.
//
// Bound: operations at ResNet-50's deep shapes in int8, the bytes of x and
// y at the others and in f32 (an f32 input is 4 bytes an element where the
// product does 2 Og operations with it; a 1x1 stride-2 layer reads a
// quarter of x). The design: a block of three
// warpgroups computes 128 x BN output tiles (BN 64 or 128) over a ring of
// shared-memory slots guarded by mbarriers. The producer warpgroup fills
// the ring: the weight's BN x 128 tile by TMA (128-byte swizzle), and A's
// 128 x 128 tile one of four ways (`route`): by TMA where A is a plain
// (M, C) matrix (a 1x1 stride-1 convolution, the FC layer); for f32 whose
// groups hold whole 32-channel pieces, a row's runs of one tap's channels
// by one 1-d bulk copy each (zeros written in the padding), laid out plain
// (the consumers read f32 A themselves); gathered in 16-byte cp.async
// pieces with zero-fill for the padding (other channels-last shapes whose
// groups hold whole pieces: 16 int8 or 4 f32 channels); or element by
// element (4-byte cp.async for f32, through registers for int8): conv1's
// 3 channels in the order (c, kh, kw), so a row's 7 taps are contiguous in
// the NCHW image and neither the image nor the weight is copied, and
// groups of a few channels. A gathering thread arrives on the slot's
// barrier when its copies land (cp.async's mbarrier arrival, or the bytes
// of its bulk copies announced), so it runs ahead by the whole ring. The
// two consumer warpgroups take 64 rows each and run wgmma m64nBNk32: int8
// A straight from shared memory, f32 A read from shared memory, quantized
// in registers and fed as wgmma's register operand. The epilogue stages
// each warpgroup's 64 x BN tile in shared memory and writes it by TMA
// stores, whole lines, while the next tile's products run. Unsplit, the
// grid is persistent (a block an SM walks the tiles) and the ring runs on
// across tiles, so one tile's epilogue overlaps the next tile's loads. A
// shape whose tiles leave SMs idle (the FC) splits its reduction over a
// thread-block cluster of up to 8 blocks: each block's partial sums go to
// its shared memory, and after a cluster barrier each block adds its share
// of the tile from all of them through distributed shared memory (integer
// sums: any order gives the same bits) and writes it. No atomics, no
// second pass, no host synchronization.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "flash_common.cuh"
#include "hopper.cuh"
#include "tma_host.cuh"

// experiments only (chip_smoke.py --probe-int8; wrong results, never
// checked): 1 cuts the products out, 2 the epilogue's stores, 3 A's
// copies; 5 the TMA stores (the staging, its fence and barrier kept), 6
// those and the proxy fence, 7 those and the staging writes (the fence
// and barrier kept)
#ifndef MXT_I8_CUT
#define MXT_I8_CUT 0
#endif

namespace i8 {

constexpr int THREADS = 384;       // two consumer warpgroups, a producer
constexpr int BM = 128;            // output positions a tile
constexpr int BK = 128;            // reduction a ring step: one 128-byte row
constexpr int BOX = BM * 128;      // a 128 x 128-byte swizzled box: 16 KB
constexpr int MAX_STAGES = 8;
constexpr int MAX_SPLIT = 8;       // the portable cluster size
constexpr int BAR_BYTES = 256;
constexpr int SMEM_MAX = 232448;
// how A reaches shared memory
constexpr int ROUTE_TMA = 0, ROUTE_CHUNK = 1, ROUTE_ELEM = 2, ROUTE_RUNS = 3;
// route RUNS (f32): a row of A, 128 f32 of one or more taps' channel runs,
// lies plain at RS bytes a row (16 bytes of padding spread the consumers'
// reads over the banks)
constexpr int RS = 128 * 4 + 16;

// the bytes of a ring slot's A tile for route and element size
__host__ __device__ constexpr int a_tile(int route, int esize) {
  return route == ROUTE_RUNS ? BM * RS : BOX * esize;
}

struct Params {
  const void* x;
  const int* bias;
  void* y;
  const float* scale;   // f32 in: the quantizing scale
  const float* step;    // f32 out: the dequantizing step
  int N, D, H, W, C;
  int OD, OH, OW, O;
  int KD, KH, KW;
  int sd, sh, sw, pd, ph, pw, dd, dh, dw;
  int G, Cg, Og, K, Kp;
  long long M;
  int cf;               // reduction order (c, kd, kh, kw) over NCDHW x
  int out_f32, relu;
  int split, steps;     // cluster size; ring steps of the whole reduction
  int n_tiles;
  int stages, slot;     // ring slots and their bytes
  int store;            // the output by TMA from a staging tile, else stores
  int stage_at, bar_at; // byte offsets of the staging tiles and barriers
};

struct Maps {
  CUtensorMap w;        // the packed weight (Kp, O): 128 x BN boxes
  CUtensorMap a;        // route TMA: x as (C, M): 128-byte x 128 boxes
  CUtensorMap y;        // store: y as (O, M) of 32-bit words: 32 x 64 boxes
};

// byte offset of 16-byte chunk c of row r in a 128-byte-swizzled box
__device__ __forceinline__ int swz(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// One A row (an output position): its image's first element in x and the
// input coordinates of its (0, 0, 0) tap; rows past M get coordinates
// outside every bound, so they read as zero.
struct RowPos {
  long long img;
  int id0, ih0, iw0;
};

__device__ __forceinline__ RowPos row_pos(const Params& p, long long m) {
  RowPos r;
  const bool ok = m < p.M;
  if (!ok) m = 0;
  const int ow = static_cast<int>(m % p.OW);
  long long t = m / p.OW;
  const int oh = static_cast<int>(t % p.OH);
  t /= p.OH;
  const int od = static_cast<int>(t % p.OD);
  t /= p.OD;
  r.img = t * static_cast<long long>(p.D) * p.H * p.W * p.C;
  r.id0 = ok ? od * p.sd - p.pd : -(1 << 29);
  r.ih0 = oh * p.sh - p.ph;
  r.iw0 = ow * p.sw - p.pw;
  return r;
}

// The tap (kd, kh, kw) and channel c of reduction index k of a group, in
// the order (kd, kh, kw, c) or, cf, (c, kd, kh, kw)
struct Tap {
  int kd, kh, kw, c;
};

__device__ __forceinline__ Tap tap_of(const Params& p, int k) {
  Tap t;
  if (p.cf) {
    t.kw = k % p.KW;
    k /= p.KW;
    t.kh = k % p.KH;
    k /= p.KH;
    t.kd = k % p.KD;
    t.c = k / p.KD;
  } else {
    t.c = k % p.Cg;
    k /= p.Cg;
    t.kw = k % p.KW;
    k /= p.KW;
    t.kh = k % p.KH;
    t.kd = k / p.KH;
  }
  return t;
}

// t moved on by n reduction indices (n >= 0), without a division
__device__ __forceinline__ void advance(const Params& p, Tap& t, int n) {
  if (p.cf) {
    t.kw += n;
    while (t.kw >= p.KW) {
      t.kw -= p.KW;
      if (++t.kh == p.KH) {
        t.kh = 0;
        if (++t.kd == p.KD) {
          t.kd = 0;
          ++t.c;
        }
      }
    }
  } else {
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
}

// x's element offset of row r's tap t in group g, or -1 in the padding
__device__ __forceinline__ long long x_offset(const Params& p,
                                              const RowPos& r, const Tap& t,
                                              int g) {
  const int id = r.id0 + t.kd * p.dd;
  const int ih = r.ih0 + t.kh * p.dh;
  const int iw = r.iw0 + t.kw * p.dw;
  if (id < 0 || id >= p.D || ih < 0 || ih >= p.H || iw < 0 || iw >= p.W)
    return -1;
  if (p.cf)
    return r.img +
           ((static_cast<long long>(g * p.Cg + t.c) * p.D + id) * p.H + ih) *
               p.W +
           iw;
  return r.img + ((static_cast<long long>(id) * p.H + ih) * p.W + iw) * p.C +
         g * p.Cg + t.c;
}

// the 4 int8 codes of a 16-byte chunk of f32: clamp(rint(v * scale),
// -127, 127), the product rounded alone, rint to the nearest integer with
// ties to even (cvt.rni; +-inf saturate), packed low k first
__device__ __forceinline__ uint32_t quant4(float4 v, float scale) {
  int q[4] = {__float2int_rn(__fmul_rn(v.x, scale)),
              __float2int_rn(__fmul_rn(v.y, scale)),
              __float2int_rn(__fmul_rn(v.z, scale)),
              __float2int_rn(__fmul_rn(v.w, scale))};
#pragma unroll
  for (int e = 0; e < 4; ++e) q[e] = max(-127, min(127, q[e]));
  return __byte_perm(__byte_perm(q[0], q[1], 0x0040),
                     __byte_perm(q[2], q[3], 0x0040), 0x5410);
}

// the cluster's primitives (sm_90): this block's rank, the barrier of all
// its threads (release / acquire), a peer's shared memory
__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return static_cast<int>(r);
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n\t"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}
// the generic address of `p`'s counterpart in block `rank`'s shared memory:
// plain loads through it, which the compiler can keep in flight together
__device__ __forceinline__ const int* peer(const int* p, int rank) {
  uint64_t q;
  asm volatile("mapa.u64 %0, %1, %2;"
               : "=l"(q) : "l"(reinterpret_cast<uint64_t>(p)), "r"(rank));
  return reinterpret_cast<const int*>(q);
}

// The ring: slot and barriers of the fill-th step; a wait that does not
// end traps (a launch error, not a hung card)
struct Ring {
  uint8_t* base;
  uint64_t* full;
  uint64_t* empty;
  int slot, stages;
  __device__ __forceinline__ uint8_t* at(int fill) const {
    return base + (fill % stages) * slot;
  }
  __device__ __forceinline__ uint64_t* bar(int fill) const {
    return full + fill % stages;
  }
  // producer: the slot of this fill is free
  __device__ __forceinline__ void wait_free(int fill) const {
    if (fill >= stages)
      hop::mbar_wait_or_trap(empty + fill % stages,
                             ((fill / stages) + 1) & 1);
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

// Route CHUNK: the producer warpgroup's 16-byte pieces of one ring step.
// Thread pt copies piece c8 = pt % 8 of each 128-byte box row of rows
// pt / 8 + 16 i (i < 8), for each of the sizeof(T) boxes of the step: 8
// consecutive threads copy one row's 128 bytes of a box. Pieces past the
// reduction are not copied: they meet the weight's zero padding, so
// whatever the slot held adds 0.
template <typename T>
struct ChunkGather {
  static constexpr int E = sizeof(T);
  static constexpr int PER = 16 / E;      // channels a piece
  RowPos rows[8];
  Tap taps[E];
  int c8, r0;

  __device__ __forceinline__ void init(const Params& p, long long m0,
                                       int pt, int k_first) {
    c8 = pt & 7;
    r0 = pt >> 3;
#pragma unroll
    for (int i = 0; i < 8; ++i) rows[i] = row_pos(p, m0 + r0 + 16 * i);
#pragma unroll
    for (int j = 0; j < E; ++j)
      taps[j] = tap_of(p, k_first + j * (BK / E) + c8 * PER);
  }

  __device__ __forceinline__ void issue(const Params& p, int g, int k0,
                                        uint8_t* a) {
    const T* x = static_cast<const T*>(p.x);
#pragma unroll
    for (int j = 0; j < E; ++j) {
      if (k0 + j * (BK / E) + c8 * PER < p.K) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const long long off = x_offset(p, rows[i], taps[j], g);
          hop::cp16(a + j * BOX + swz(r0 + 16 * i, c8),
                    off >= 0 ? x + off : x, off >= 0);
        }
      }
      advance(p, taps[j], BK);
    }
  }
};

// Route ELEM: thread pt stages row pt element by element, walking the
// reduction in runs: cf, (c, kd, kh) runs of KW taps dw apart in x; else
// (kd, kh, kw) runs of Cg contiguous channels. A run's first element and
// whether its depth and row (and column) lie inside x are computed once a
// run; an element then costs an add and, cf, its column's bounds.
struct Walk {
  Tap t;            // the run's outer indices
  int in;           // the element's place in its run
  long long base;   // x's offset of the run's element 0
  bool ok;
};

__device__ __forceinline__ void run_at(const Params& p, const RowPos& r,
                                       int g, Walk& w) {
  const int id = r.id0 + w.t.kd * p.dd, ih = r.ih0 + w.t.kh * p.dh;
  bool ok = id >= 0 && id < p.D && ih >= 0 && ih < p.H;
  if (p.cf) {
    w.base = r.img + ((static_cast<long long>(g * p.Cg + w.t.c) * p.D +
                       id) * p.H + ih) * p.W + r.iw0;
  } else {
    const int iw = r.iw0 + w.t.kw * p.dw;
    ok = ok && iw >= 0 && iw < p.W;
    w.base = r.img + ((static_cast<long long>(id) * p.H + ih) * p.W + iw) *
                         p.C + g * p.Cg;
  }
  w.ok = ok;
}

__device__ __forceinline__ Walk walk_at(const Params& p, const RowPos& r,
                                        int g, int k) {
  Walk w;
  w.t = tap_of(p, k);
  w.in = p.cf ? w.t.kw : w.t.c;
  run_at(p, r, g, w);
  return w;
}

// the element's offset in x, or -1 in the padding; then the walk steps on
__device__ __forceinline__ long long walk_next(const Params& p,
                                               const RowPos& r, int g,
                                               Walk& w) {
  long long off = -1;
  if (p.cf) {
    const int iw = r.iw0 + w.in * p.dw;
    if (w.ok && iw >= 0 && iw < p.W)
      off = w.base + static_cast<long long>(w.in) * p.dw;
    if (++w.in == p.KW) {
      w.in = 0;
      if (++w.t.kh == p.KH) {
        w.t.kh = 0;
        if (++w.t.kd == p.KD) {
          w.t.kd = 0;
          ++w.t.c;
        }
      }
      run_at(p, r, g, w);
    }
  } else {
    if (w.ok) off = w.base + w.in;
    if (++w.in == p.Cg) {
      w.in = 0;
      if (++w.t.kw == p.KW) {
        w.t.kw = 0;
        if (++w.t.kh == p.KH) {
          w.t.kh = 0;
          ++w.t.kd;
        }
      }
      run_at(p, r, g, w);
    }
  }
  return off;
}

// One ring step of row `row` from element k0 on: f32 by 4-byte cp.async
// (zero-filled in the padding; the caller arrives when they land), int8
// through registers, 32 loads issued before any is used, then two 16-byte
// stores. Elements past the reduction meet the weight's zero padding:
// they are written as 0 within a 16-byte piece, not at all past it.
template <typename T>
__device__ __forceinline__ void elem_gather(const Params& p, const RowPos& r,
                                            Walk& w, int g, int k0, int row,
                                            uint8_t* a) {
  const int n = min(BK, p.K - k0);
  if constexpr (sizeof(T) == 4) {
    const T* x = static_cast<const T*>(p.x);
    for (int q = 0; q < n; ++q) {
      const long long off = walk_next(p, r, g, w);
      hop::cp4(a + (q >> 5) * BOX + swz(row, (q & 31) >> 2) + 4 * (q & 3),
               off >= 0 ? x + off : x, off >= 0);
    }
  } else {
    const uint8_t* x = static_cast<const uint8_t*>(p.x);
    for (int q = 0; q < n; q += 32) {
      uint32_t v[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const long long off = q + e < n ? walk_next(p, r, g, w) : -1;
        v[e] = off >= 0 ? static_cast<uint32_t>(__ldg(x + off)) : 0u;
      }
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        if (q + 16 * c < n) {
          uint32_t word[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint32_t* b = v + 16 * c + 4 * i;
            word[i] = b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24);
          }
          *reinterpret_cast<uint4*>(a + swz(row, (q >> 4) + c)) =
              make_uint4(word[0], word[1], word[2], word[3]);
        }
      }
    }
  }
}

// Route RUNS: row r's elements k0 .. k0 + 127 (or to K) of a step, in
// the order (kd, kh, kw, c) with C / G a multiple of 32: runs of whole
// 32-channel pieces of one tap, contiguous in a channels-last x, each
// copied by one 1-d bulk copy to `a` (the row's place in the slot), or
// zeros written where the tap lies in the padding. t: the tap of k0,
// moved on to the next step's. Returns the bytes copied.
__device__ __forceinline__ uint32_t runs_gather(const Params& p,
                                                const RowPos& r, Tap& t,
                                                int g, int k0, uint8_t* a,
                                                uint64_t* bar) {
  const float* x = static_cast<const float*>(p.x);
  const int n = min(BK, p.K - k0);
  uint32_t bytes = 0;
  for (int done = 0; done < n;) {
    const int len = min(p.Cg - t.c, n - done);
    const long long off = x_offset(p, r, t, g);
    if (off >= 0) {
      hop::bulk_g2s(a + 4 * done, x + off, 4 * len, bar);
      bytes += 4 * len;
    } else {
      for (int i = 0; i < len; i += 4)
        *reinterpret_cast<uint4*>(a + 4 * (done + i)) =
            make_uint4(0u, 0u, 0u, 0u);
    }
    done += len;
    advance(p, t, len);
  }
  if (n < BK) advance(p, t, BK - n);
  return bytes;
}

// One unit of work: a 128 x BN tile of the output (group g, positions
// m0.., channels n0..) over reduction steps [s0, s1) of the group's K.
struct Unit {
  long long m0;
  int g, n0, s0, s1, split;
};

__device__ __forceinline__ Unit unit_of(const Params& p, long long u,
                                        int bn) {
  Unit w;
  w.split = static_cast<int>(u % p.split);   // split fastest, then the
  u /= p.split;                              // channel tile, group,
  const int nt = static_cast<int>(u % p.n_tiles);   // positions
  u /= p.n_tiles;
  w.g = static_cast<int>(u % p.G);
  w.m0 = (u / p.G) * BM;
  w.n0 = nt * bn;
  w.s0 = static_cast<int>(static_cast<long long>(p.steps) * w.split /
                          p.split);
  w.s1 = static_cast<int>(static_cast<long long>(p.steps) * (w.split + 1) /
                          p.split);
  return w;
}

// The kernel: T the input's element (int8_t or float). Unsplit, a
// persistent grid (a block an SM) walks the tiles and the ring runs on
// across them, so a tile's epilogue overlaps the next tile's loads; split,
// a block is one unit of a cluster.
template <int BN, typename T, int ROUTE>
__global__ void __launch_bounds__(THREADS, 1)
    conv_s8_wg(const __grid_constant__ Maps maps, const Params p) {
  // a ring slot: A's 128 x 128 elements of T, then B's BN rows of 128
  constexpr int A_BYTES = a_tile(ROUTE, static_cast<int>(sizeof(T)));
  constexpr int B_BYTES = BN * 128;
  constexpr int NA = BN / 2;                 // accumulators a thread
  constexpr bool F32 = sizeof(T) == 4;
  // the producer's arrivals a step: TMA, the one that announces the bytes;
  // otherwise also one from each gathering thread (f32 and the pieces
  // when their copies land, int8 element by element after its stores)
  constexpr bool ASYNC = ROUTE == ROUTE_CHUNK || (F32 && ROUTE != ROUTE_RUNS);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = hop::smem_u32(smem_raw);
  uint8_t* sm = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  Ring ring;
  ring.base = sm;
  ring.full = reinterpret_cast<uint64_t*>(sm + p.bar_at);
  ring.empty = ring.full + p.stages;
  ring.slot = p.slot;
  ring.stages = p.stages;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      hop::mbar_init(ring.full + s, ROUTE == ROUTE_TMA ? 1 : 129);
      hop::mbar_init(ring.empty + s, 8);
    }
    hop::mbar_init_fence();
  }
  __syncthreads();
  const long long units =
      (p.M + BM - 1) / BM * p.G * p.n_tiles * p.split;

  if (tid >= 256) {
    // ------------------------------------------------------------ producer
    const int pt = tid - 256;
    int fill = 0;
    for (long long u = blockIdx.x; u < units; u += gridDim.x) {
      const Unit w = unit_of(p, u, BN);
      const int wrow = w.g * p.Og + w.n0;     // the weight's first row
      if (ROUTE == ROUTE_TMA) {
        if (pt != 0) continue;
        for (int s = w.s0; s < w.s1; ++s, ++fill) {
          ring.wait_free(fill);
          uint8_t* st = ring.at(fill);
          uint64_t* bar = ring.bar(fill);
          // f32: the 32-wide boxes that hold part of the reduction (the
          // consumers take the others as zero)
          constexpr int KB = BK / static_cast<int>(sizeof(T));
          const int boxes = MXT_I8_CUT == 3
                                ? 0
                                : min(static_cast<int>(sizeof(T)),
                                      (p.K - s * BK + KB - 1) / KB);
          hop::mbar_expect(bar, boxes * BOX + B_BYTES);
          for (int j = 0; j < boxes; ++j)
            hop::tma_load_4d(st + j * BOX, &maps.a, bar,
                             w.g * p.Cg + s * BK + j * KB,
                             static_cast<int>(w.m0), 0, 0);
          hop::tma_load_4d(st + A_BYTES, &maps.w, bar, s * BK, wrow, 0, 0);
        }
        continue;
      }
      ChunkGather<T> chunks;
      RowPos r;
      Walk walk;
      if (ROUTE == ROUTE_CHUNK) {
        chunks.init(p, w.m0, pt, w.s0 * BK);
      } else {
        r = row_pos(p, w.m0 + pt);
        if (ROUTE == ROUTE_RUNS)
          walk.t = tap_of(p, w.s0 * BK);
        else
          walk = walk_at(p, r, w.g, w.s0 * BK);
      }
      for (int s = w.s0; s < w.s1; ++s, ++fill) {
        ring.wait_free(fill);
        uint8_t* st = ring.at(fill);
        uint64_t* bar = ring.bar(fill);
        if (pt == 0) {
          hop::mbar_expect(bar, B_BYTES);
          hop::tma_load_4d(st + A_BYTES, &maps.w, bar, s * BK, wrow, 0, 0);
        }
        if (ROUTE == ROUTE_RUNS) {
          // row pt's channel runs: a 1-d bulk copy each, zeros written in
          // the padding; the row's bytes announced with its arrival
          uint32_t bytes = 0;
          if (MXT_I8_CUT != 3)
            bytes = runs_gather(p, r, walk.t, w.g, s * BK, st + pt * RS, bar);
          hop::mbar_expect(bar, bytes);
          continue;
        }
        if (MXT_I8_CUT == 3) {
        } else if (ROUTE == ROUTE_CHUNK) {
          chunks.issue(p, w.g, s * BK, st);
        } else {
          elem_gather<T>(p, r, walk, w.g, s * BK, pt, st);
        }
        if (ASYNC) {
          hop::cp_async_mbar_arrive(bar);
        } else {
          hop::fence_async_smem();
          hop::mbar_arrive(bar);
        }
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    const int g8 = lane >> 2, t4 = lane & 3;
    const float scale = F32 ? __ldg(p.scale) : 0.f;
    const float step = p.out_f32 ? __ldg(p.step) : 0.f;
    const bool pairs = ((p.O | p.Og) & 1) == 0;
    const int ra = wg * 64 + warp * 16 + g8;   // rows ra, ra + 8 of the tile
    const bool lead = (tid & 127) == 0;
    const int S = p.split;
    int fill = 0;
    for (long long u = blockIdx.x; u < units; u += gridDim.x) {
      const Unit w = unit_of(p, u, BN);
      int acc[NA];
#pragma unroll
      for (int i = 0; i < NA; ++i) acc[i] = 0;
      for (int s = w.s0; s < w.s1; ++s, ++fill) {
        ring.wait(fill);
        uint8_t* st = ring.at(fill);
        const uint32_t b = hop::smem_u32(st + A_BYTES);
        if constexpr (F32) {
          // k32 step kk is box kk: a[0] row ra, k 4 t4 ..; a[1] row ra + 8;
          // a[2] row ra, k 16 + 4 t4 ..; a[3] row ra + 8
          // (boxes past the reduction hold no data: their codes are 0)
          uint32_t a[4][4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint8_t* box = st + kk * BOX;
            const bool in = s * BK + 32 * kk < p.K;
#pragma unroll
            for (int h = 0; h < 4; ++h) {
              const int row = ra + 8 * (h & 1), c4 = 4 * (h >> 1) + t4;
              const uint8_t* q =
                  ROUTE == ROUTE_RUNS ? st + row * RS + (8 * kk + c4) * 16
                                      : box + swz(row, c4);
              a[kk][h] = in ? quant4(*reinterpret_cast<const float4*>(q),
                                     scale)
                            : 0u;
            }
          }
          hop::fence_regs(acc, NA);
          hop::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            if (MXT_I8_CUT == 1) {
#pragma unroll
              for (int h = 0; h < 4; ++h) acc[h] ^= a[kk][h];
              continue;
            }
            hop::wgmma_s8_rs<BN>(acc, a[kk],
                                 hop::desc_kmajor_sw128(b + 32 * kk));
          }
          hop::wgmma_commit();
          // a is rewritten next step: this group is done first
          hop::wgmma_wait<0>();
          hop::fence_regs(acc, NA);
          ring.release(fill, lane);
        } else {
          // pieces copied by the threads (generic proxy) made visible to
          // wgmma's reads (async proxy)
          if (ROUTE != ROUTE_TMA) hop::fence_async_smem();
          const uint32_t a = hop::smem_u32(st + wg * 64 * 128);
          hop::fence_regs(acc, NA);
          hop::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            if (MXT_I8_CUT != 1)
              hop::wgmma_s8_ss<BN>(acc, hop::desc_kmajor_sw128(a + 32 * kk),
                                   hop::desc_kmajor_sw128(b + 32 * kk));
          hop::wgmma_commit();
          // one group in flight: the previous step's is done, its slot free
          hop::wgmma_wait<1>();
          hop::fence_regs(acc, NA);
          if (s > w.s0) ring.release(fill - 1, lane);
        }
      }
      if constexpr (!F32) {
        hop::wgmma_wait<0>();
        hop::fence_regs(acc, NA);
        ring.release(fill - 1, lane);
      }

      // split (a block is one unit, the ring drained): each block's
      // partial sums to its shared memory; after the cluster barrier,
      // block `rank` adds share `rank` of every thread's accumulators from
      // all blocks, in rank order
      int rank = 0;
      const int share = NA / S;
      if (S > 1) {
        hop::named_sync(1, 256);              // both warpgroups are done
        int* part = reinterpret_cast<int*>(sm);
#pragma unroll
        for (int i = 0; i < NA; ++i) part[i * 256 + tid] = acc[i];
        __syncwarp();
        cluster_sync();
        rank = cluster_rank();
#pragma unroll
        for (int i = 0; i < NA; ++i)
          if (i / share == rank) acc[i] = 0;
        for (int r = 0; r < S; ++r) {
          const int* q = peer(part, r);
#pragma unroll
          for (int i = 0; i < NA; ++i)
            if (i / share == rank) acc[i] += q[i * 256 + tid];
        }
      }

      // ---------------------------------------------------------- epilogue
      // element 4 j + 2 h + e: row ra + 8 h, channel n0 + 8 j + 2 t4 + e.
      // store: into this warpgroup's staging tile, BN / 32 128-byte-
      // swizzled boxes of its 64 rows x 32 channels, then one TMA store a
      // box (whole lines; rows and channels past the output clipped), the
      // staging rewritten only after the last tile's stores have read it;
      // else two neighbouring channels as one 8-byte store where O and Og
      // are even
      uint8_t* stage = sm + p.stage_at + wg * BN * 256;
      if (p.store) {
        if (lead) hop::bulk_wait_read<0>();
        hop::named_sync(2 + wg, 128);
      }
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        if ((4 * j) / share != rank) continue;  // a share is whole j's
        const int n = w.n0 + 8 * j + 2 * t4;
        uint32_t bias[2] = {0u, 0u};
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (p.bias && n + e < p.Og)
            bias[e] =
                static_cast<uint32_t>(__ldg(p.bias + w.g * p.Og + n + e));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * j + 2 * h;
          const long long m = w.m0 + ra + 8 * h;
          uint32_t v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            v[e] = static_cast<uint32_t>(acc[i + e]) + bias[e];
            if (p.out_f32) {
              float f =
                  __fmul_rn(__int2float_rn(static_cast<int>(v[e])), step);
              if (p.relu) f = f < 0.f ? 0.f : f;
              v[e] = __float_as_uint(f);
            }
          }
          if (MXT_I8_CUT == 2 || MXT_I8_CUT == 7) {
            asm volatile("" ::"r"(v[0]), "r"(v[1]));
          } else if (p.store) {
            const int c = 8 * j + 2 * t4, r = ra - wg * 64 + 8 * h;
            *reinterpret_cast<uint2*>(stage + (c >> 5) * 8192 +
                                      swz(r, (c & 31) >> 2) + (c & 3) * 4) =
                make_uint2(v[0], v[1]);
          } else if (m < p.M) {
            uint32_t* yr =
                static_cast<uint32_t*>(p.y) + m * p.O + w.g * p.Og;
            if (pairs && n + 1 < p.Og) {
              *reinterpret_cast<uint2*>(yr + n) = make_uint2(v[0], v[1]);
            } else {
#pragma unroll
              for (int e = 0; e < 2; ++e)
                if (n + e < p.Og) yr[n + e] = v[e];
            }
          }
        }
      }
      if (p.store && MXT_I8_CUT != 2) {
        if (MXT_I8_CUT != 6) hop::fence_async_smem();
        hop::named_sync(2 + wg, 128);
        const long long r0 = w.m0 + wg * 64;
        if (lead && r0 < p.M && MXT_I8_CUT < 5) {
          for (int b = 0; b < BN / 32 && w.n0 + 32 * b < p.O; ++b)
            hop::tma_store_4d(&maps.y, stage + b * 8192, w.n0 + 32 * b,
                              static_cast<int>(r0), 0, 0);
          hop::bulk_commit();
        }
      }
    }
    if (p.store && lead) hop::bulk_wait<0>();
  }
  // split: a block's shared memory outlives its peers' reads of it
  if (p.split > 1) {
    __syncwarp();
    if (tid >= 256) cluster_sync();           // the consumers' first one
    cluster_sync();
  }
}

template <int BN, typename T, int ROUTE>
cudaError_t launch(const Maps& maps, const Params& p, long long blocks,
                   int smem, cudaStream_t stream) {
  auto kern = conv_s8_wg<BN, T, ROUTE>;
  cudaError_t e = mxt::set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks), 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.split > 1 ? 1 : 0;        // a plain launch for 1
  e = cudaLaunchKernelEx(&cfg, kern, maps, p);
  const cudaError_t last = cudaGetLastError();
  return e != cudaSuccess ? e : last;
}

template <int BN, typename T>
cudaError_t launch_route(int route, const Maps& maps, const Params& p,
                         long long blocks, int smem, cudaStream_t stream) {
  if (route == ROUTE_TMA)
    return launch<BN, T, ROUTE_TMA>(maps, p, blocks, smem, stream);
  if (route == ROUTE_CHUNK)
    return launch<BN, T, ROUTE_CHUNK>(maps, p, blocks, smem, stream);
  if constexpr (sizeof(T) == 4)
    if (route == ROUTE_RUNS)
      return launch<BN, T, ROUTE_RUNS>(maps, p, blocks, smem, stream);
  return launch<BN, T, ROUTE_ELEM>(maps, p, blocks, smem, stream);
}

}  // namespace i8

// x (N, D, H, W, C), or (N, C, D, H, W) with cf, int8 or (in_f32) f32; w
// (O, Kp) int8, K = KD * KH * KW * C / G taps a row in the order (kd, kh,
// kw, c), or (c, kd, kh, kw) with cf, zero-padded to Kp (a multiple of 16,
// 16-byte aligned rows); bias (O,) int32 or null; y (N * OD * OH * OW, O)
// int32 or (out_f32) f32: float(acc + bias) * *step, relu'd with relu. An
// f32 x is quantized by *scale. route: 0 A by TMA (1x1, stride 1, no
// padding, C * esize a multiple of 16), 1 in 16-byte pieces (C / G a
// multiple of 16 / esize), 2 element by element; bn: 64 or 128 output
// channels a tile; split: 1, 2, 4 or 8 blocks a tile, a cluster, at most
// the reduction's 128-wide steps. Returns cudaGetLastError() after the
// launch.
extern "C" int mxt_int8_conv(const void* x, const void* w, const void* bias,
                             void* y, const void* scale, const void* step,
                             int N, int D, int H, int W, int C, int OD,
                             int OH, int OW, int O, int KD, int KH, int KW,
                             int sd, int sh, int sw, int pd, int ph, int pw,
                             int dd, int dh, int dw, int G, int Kp,
                             int in_f32, int out_f32, int relu, int route,
                             int cf, int bn, int split, void* stream) {
  const int esize = in_f32 ? 4 : 1;
  if (!x || !w || !y || N < 1 || D < 1 || H < 1 || W < 1 || C < 1 ||
      OD < 1 || OH < 1 || OW < 1 || O < 1 || KD < 1 || KH < 1 || KW < 1 ||
      G < 1 || C % G || O % G || Kp % 16 || (bn != 64 && bn != 128) ||
      split < 1 || split > i8::MAX_SPLIT || (split & (split - 1)) ||
      (in_f32 && !scale) || (out_f32 && !step) || route < 0 || route > 3 ||
      (cf && route != i8::ROUTE_ELEM) ||
      reinterpret_cast<uintptr_t>(w) % 16 ||
      (route != i8::ROUTE_ELEM && reinterpret_cast<uintptr_t>(x) % 16))
    return static_cast<int>(cudaErrorInvalidValue);
  i8::Params p = {};
  p.x = x; p.bias = static_cast<const int*>(bias); p.y = y;
  p.scale = static_cast<const float*>(scale);
  p.step = static_cast<const float*>(step);
  p.N = N; p.D = D; p.H = H; p.W = W; p.C = C;
  p.OD = OD; p.OH = OH; p.OW = OW; p.O = O;
  p.KD = KD; p.KH = KH; p.KW = KW;
  p.sd = sd; p.sh = sh; p.sw = sw; p.pd = pd; p.ph = ph; p.pw = pw;
  p.dd = dd; p.dh = dh; p.dw = dw;
  p.G = G; p.Cg = C / G; p.Og = O / G; p.K = KD * KH * KW * (C / G);
  p.Kp = Kp;
  p.M = static_cast<long long>(N) * OD * OH * OW;
  p.cf = cf; p.out_f32 = out_f32; p.relu = relu;
  p.split = split;
  p.steps = (p.K + i8::BK - 1) / i8::BK;
  p.n_tiles = (p.Og + bn - 1) / bn;
  const bool one = KD == 1 && KH == 1 && KW == 1 && sd == 1 && sh == 1 &&
                   sw == 1 && pd == 0 && ph == 0 && pw == 0;
  if (p.K > Kp || split > p.steps ||
      (route == i8::ROUTE_TMA &&
       (!one || (C * esize) % 16 || p.M >= (1LL << 31))) ||
      (route == i8::ROUTE_CHUNK && (p.Cg % (16 / esize) || cf)) ||
      (route == i8::ROUTE_RUNS && (!in_f32 || p.Cg % 32 || cf)))
    return static_cast<int>(cudaErrorInvalidValue);
  // the output by TMA stores from staging tiles (64 rows x bn a
  // warpgroup) where a tile's channels are its own (one group) and rows
  // are 16-byte multiples, unless a gathering route would lose ring slots
  // below 3 to them; split, each block stores its share itself
  p.slot = i8::a_tile(route, esize) + bn * 128;
  const int room = i8::SMEM_MAX - 1024 - i8::BAR_BYTES, tiles = 2 * bn * 256;
  const int direct = std::min(i8::MAX_STAGES, room / p.slot);
  const int staged = std::min(i8::MAX_STAGES, (room - tiles) / p.slot);
  p.store = split == 1 && G == 1 && O % 4 == 0 &&
            reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
            (route == i8::ROUTE_TMA || staged >= std::min(3, direct));
  const int staging = p.store ? tiles : 0;
  p.stages = p.store ? staged : direct;
  // split's partial sums (256 threads x bn / 2) in the drained ring
  if (p.stages < 2 || 256LL * bn / 2 * 4 > 1LL * p.stages * p.slot)
    return static_cast<int>(cudaErrorInvalidValue);
  p.stage_at = p.stages * p.slot;
  p.bar_at = p.stage_at + staging;
  const int smem = p.bar_at + i8::BAR_BYTES + 1024;
  i8::Maps maps = {};
  if (!mxt::make_map_rows(&maps.w, mxt::TmaType<int8_t>::value, 1, w, O, Kp,
                          Kp, 128, bn))
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == i8::ROUTE_TMA &&
      !(in_f32 ? mxt::make_map_rows(&maps.a, mxt::TmaType<float>::value, 4,
                                    x, p.M, C, C, 32, i8::BM)
               : mxt::make_map_rows(&maps.a, mxt::TmaType<int8_t>::value, 1,
                                    x, p.M, C, C, 128, i8::BM)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.store && !mxt::make_map_rows(&maps.y, mxt::TmaType<float>::value, 4,
                                     y, p.M, O, O, 32, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  // unsplit, a persistent grid of a block an SM; split, a block a unit
  long long blocks = (p.M + i8::BM - 1) / i8::BM * G * p.n_tiles * split;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  if (split == 1) {
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    blocks = std::min<long long>(blocks, sms);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (bn == 64)
    e = in_f32 ? i8::launch_route<64, float>(route, maps, p, blocks, smem, s)
               : i8::launch_route<64, int8_t>(route, maps, p, blocks, smem, s);
  else
    e = in_f32 ? i8::launch_route<128, float>(route, maps, p, blocks, smem, s)
               : i8::launch_route<128, int8_t>(route, maps, p, blocks, smem,
                                               s);
  return static_cast<int>(e);
}
