// Greedy non-maximum suppression's keep mask for Hopper (sm_90a), bound
// through a plain C entry: two passes over score-sorted boxes.
//
// Counterpart of the sweep in mxnet_tpu/ops/boxes.py box_nms (:65-133): the
// JAX package builds the (B, N, N) suppression matrix (iou > thresh, same
// class or force_suppress, j > i) and runs a lax.fori_loop over all N rows
// (:109-115), row i suppressing its later boxes when it is alive (valid and
// not suppressed). It is XLA in the JAX package, so no Pallas kernel is
// replaced; ported as written, SSD's decode (N = 8732 anchors) would be
// ~8732 sequential steps of several launches each.
//   pass 1 (mask): one block of 64 threads a (64-row, 64-column) tile of a
//     batch row's matrix; thread i writes the 64-bit word of row i: bit j
//     set when j > i, IoU(i, j) > thresh and the classes match (or force).
//     The IoU is the JAX formula (_pairwise_iou, :39-49) in the same order,
//     each f32 operation rounded as written (__f*_rn, no contraction), so
//     the bits equal the plain version's.
//   pass 2 (sweep): one block a batch row keeps the suppressed set as n/64
//     words in shared memory and walks the rows in 64-row chunks: one
//     thread decides the chunk's rows in order from the chunk's diagonal
//     words (staged in shared memory), then the block ORs each kept row's
//     words into the later chunks' words, a thread a word.
// keep[i] = valid[i] and not suppressed[i], 0 for rows n..N-1 (n = the
// rows the caller restricts the sweep to, its topk; no later row is valid).
// Bound: pass 1's IoUs (~N^2 / 2 of ~10 f32 operations each) and its
// N^2 / 8 bytes of mask; pass 2 is a chain of N / 64 dependent steps.
#include <cuda_runtime.h>
#include <stdint.h>

namespace nms {

constexpr int SWEEP_THREADS = 256;

__device__ __forceinline__ float iou(const float* a, const float* b) {
  const float iw = fmaxf(__fsub_rn(fminf(a[2], b[2]), fmaxf(a[0], b[0])),
                         0.0f);
  const float ih = fmaxf(__fsub_rn(fminf(a[3], b[3]), fmaxf(a[1], b[1])),
                         0.0f);
  const float inter = __fmul_rn(iw, ih);
  const float area_a = __fmul_rn(__fsub_rn(a[2], a[0]), __fsub_rn(a[3], a[1]));
  const float area_b = __fmul_rn(__fsub_rn(b[2], b[0]), __fsub_rn(b[3], b[1]));
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return uni > 0.0f ? __fdiv_rn(inter, uni) : 0.0f;
}

// boxes (B, n, 4) corner, cls (B, n); mask (B, n, nw) words
__global__ void __launch_bounds__(64) mask_kernel(
    const float* __restrict__ boxes, const float* __restrict__ cls,
    unsigned long long* __restrict__ mask, int n, int nw, float thresh,
    int force) {
  const int cb = blockIdx.x, rb = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x;
  if (cb < rb) return;      // left of the diagonal: never read
  __shared__ float cbox[64][4];
  __shared__ float ccls[64];
  const float* bb = boxes + static_cast<long long>(b) * n * 4;
  const float* cc = cls + static_cast<long long>(b) * n;
  const int j = cb * 64 + t;
  if (j < n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) cbox[t][e] = bb[j * 4 + e];
    ccls[t] = cc[j];
  }
  __syncthreads();
  const int i = rb * 64 + t;
  if (i >= n) return;
  unsigned long long bits = 0;
  const float a[4] = {bb[i * 4], bb[i * 4 + 1], bb[i * 4 + 2], bb[i * 4 + 3]};
  const float ci = cc[i];
  const int last = min(64, n - cb * 64);
  for (int jj = 0; jj < last; ++jj) {
    if (cb * 64 + jj <= i) continue;
    if (iou(a, cbox[jj]) > thresh && (force || ci == ccls[jj]))
      bits |= 1ull << jj;
  }
  mask[(static_cast<long long>(b) * n + i) * nw + cb] = bits;
}

// valid (B, N) uint8 (only the first n read); keep (B, N) uint8
__global__ void __launch_bounds__(SWEEP_THREADS) sweep_kernel(
    const unsigned long long* __restrict__ mask,
    const uint8_t* __restrict__ valid, uint8_t* __restrict__ keep, int N,
    int n, int nw) {
  extern __shared__ unsigned long long removed[];   // nw words
  __shared__ unsigned long long diag[64];
  __shared__ unsigned long long kept_s;
  __shared__ unsigned int valid_s[2];
  const int b = blockIdx.x, t = threadIdx.x;
  const unsigned long long* mb = mask + static_cast<long long>(b) * n * nw;
  const uint8_t* vb = valid + static_cast<long long>(b) * N;
  uint8_t* kb = keep + static_cast<long long>(b) * N;
  for (int w = t; w < nw; w += SWEEP_THREADS) removed[w] = 0;
  for (int i = n + t; i < N; i += SWEEP_THREADS) kb[i] = 0;
  for (int w = 0; w < nw; ++w) {
    const int i0 = w * 64, rows = min(64, n - i0);
    if (t < 64) {
      diag[t] = t < rows ? mb[static_cast<long long>(i0 + t) * nw + w] : 0;
      const unsigned long long vbit =
          __ballot_sync(0xffffffffu, t < rows && vb[i0 + t]);
      if ((t & 31) == 0) valid_s[t >> 5] = vbit;
    }
    __syncthreads();
    if (t == 0) {
      const unsigned long long vbits =
          valid_s[0] | static_cast<unsigned long long>(valid_s[1]) << 32;
      unsigned long long cur = removed[w], kept = 0;
      for (int r = 0; r < rows; ++r) {
        const unsigned long long bit = 1ull << r;
        if ((vbits & bit) && !(cur & bit)) {
          kept |= bit;
          cur |= diag[r];
        }
      }
      removed[w] = cur;
      kept_s = kept;
    }
    __syncthreads();
    const unsigned long long kept = kept_s;
    for (int w2 = w + 1 + t; w2 < nw; w2 += SWEEP_THREADS) {
      unsigned long long acc = removed[w2];
      for (unsigned long long k = kept; k; k &= k - 1) {
        const int r = __ffsll(static_cast<long long>(k)) - 1;
        acc |= mb[static_cast<long long>(i0 + r) * nw + w2];
      }
      removed[w2] = acc;
    }
    if (t < rows) kb[i0 + t] = static_cast<uint8_t>((kept >> t) & 1);
    __syncthreads();
  }
}

}  // namespace nms

// boxes (B, n, 4) f32 corner boxes and cls (B, n) f32 class ids, both
// score-sorted and contiguous; valid (B, N) uint8; mask a (B, n, ceil(n /
// 64)) uint64 workspace (pass 1 writes the words at and right of each
// 64-row block's diagonal, the only ones pass 2 reads); keep (B, N) uint8.
// Returns cudaGetLastError() after the two launches.
extern "C" int mxt_box_nms(const void* boxes, const void* cls,
                           const void* valid, void* mask, void* keep, int B,
                           int N, int n, float thresh, int force,
                           void* stream) {
  if (!boxes || !cls || !valid || !mask || !keep || B < 1 || B > 65535 ||
      n < 1 || n > N)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nw = (n + 63) / 64;
  const size_t smem = static_cast<size_t>(nw) * 8;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (smem > 48 * 1024) {
    static bool sized = false;
    if (!sized) {
      const cudaError_t e = cudaFuncSetAttribute(
          nms::sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          200 * 1024);
      if (e != cudaSuccess) return static_cast<int>(e);
      sized = true;
    }
  }
  nms::mask_kernel<<<dim3(nw, nw, B), 64, 0, s>>>(
      static_cast<const float*>(boxes), static_cast<const float*>(cls),
      static_cast<unsigned long long*>(mask), n, nw, thresh, force);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  nms::sweep_kernel<<<B, nms::SWEEP_THREADS, smem, s>>>(
      static_cast<const unsigned long long*>(mask),
      static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(keep), N, n,
      nw);
  return static_cast<int>(cudaGetLastError());
}
