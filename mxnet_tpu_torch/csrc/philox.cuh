// Counter-based dropout mask shared by the flash-attention kernels.
//
// Replaces: mxnet_tpu/ops/pallas/attention.py, _dropout_keep, which seeds
// the TPU's generator once per (q-block, k-block) tile. Here the keep bit of
// one attention probability is a pure function of (seed, batch, head, row,
// col) and of nothing else, so the forward kernel, the three backward
// kernels and the plain PyTorch version (dropout_keep_reference in
// ops/cuda/attention.py) draw the same mask bit for bit whatever their tile
// shapes.
//
// Generator: Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy
// as 1, 2, 3", SC'11), key = the two 32-bit words of the seed. One call
// covers a 2 x 2 block of scores:
//   counter = (col >> 1, row >> 1, head, batch)
//   word    = ((row & 1) << 1) | (col & 1)   of the call's four outputs
//   keep    = word >= threshold,  threshold = min(2^32 - 1, rate * 2^32)
// as the TPU kernel keeps (`bits >= threshold`). The 2 x 2 grouping lets a
// thread of an mma.sync fragment (two adjacent columns of one row, or two
// adjacent rows of one column in the transposed layout) use two words of
// each call.
#pragma once

#include <stdint.h>

namespace mxt {

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// The four words of the 2 x 2 block that holds score (row, col).
__device__ __forceinline__ uint4 dropout_words(uint2 key, int b, int h,
                                               int row, int col) {
  return philox4x32_10(
      make_uint4(static_cast<uint32_t>(col) >> 1,
                 static_cast<uint32_t>(row) >> 1, static_cast<uint32_t>(h),
                 static_cast<uint32_t>(b)),
      key);
}

// The word of score (row, col) out of its block's four.
__device__ __forceinline__ uint32_t dropout_word(uint4 w, int row, int col) {
  const int i = ((row & 1) << 1) | (col & 1);
  return (i & 2) ? ((i & 1) ? w.w : w.z) : ((i & 1) ? w.y : w.x);
}

__device__ __forceinline__ bool dropout_keep(uint2 key, int b, int h, int row,
                                             int col, uint32_t threshold) {
  return dropout_word(dropout_words(key, b, h, row, col), row, col) >=
         threshold;
}

// The words of one thread's four scores of an 8-column chunk of an mma
// accumulator whose rows are queries (the forward's S, the dq kernel's s):
// rows ra and rb = ra + 8, columns col and col + 1, as w[0..3] = (ra, col),
// (ra, col + 1), (rb, col), (rb, col + 1). The two lanes holding rows 2i
// and 2i + 1 (lane and lane ^ 4, `odd` on the second) share each call: the
// even lane draws the block of its ra, the odd lane that of its rb, and
// each swaps the two words the other needs.
__device__ __forceinline__ void dropout_row_pair(uint32_t* w, uint2 key,
                                                 int b, int h, int ra, int rb,
                                                 int col, bool odd) {
  const uint4 x = dropout_words(key, b, h, odd ? rb : ra, col);
  const uint32_t own0 = odd ? x.z : x.x, own1 = odd ? x.w : x.y;
  const uint32_t get0 = __shfl_xor_sync(0xffffffffu, odd ? x.x : x.z, 4);
  const uint32_t get1 = __shfl_xor_sync(0xffffffffu, odd ? x.y : x.w, 4);
  w[0] = odd ? get0 : own0;
  w[1] = odd ? get1 : own1;
  w[2] = odd ? own0 : get0;
  w[3] = odd ? own1 : get1;
}

// The seed tensor (2,) int32 on the device, as the Philox key.
__device__ __forceinline__ uint2 dropout_key(const int* seed) {
  return make_uint2(static_cast<uint32_t>(seed[0]),
                    static_cast<uint32_t>(seed[1]));
}

}  // namespace mxt
