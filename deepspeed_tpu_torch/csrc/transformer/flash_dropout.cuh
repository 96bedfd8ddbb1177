// In-kernel attention dropout for the flash kernels (B4).
//
// Replaces `_keep_mask` and `_dropout_thresh` of
// deepspeed_tpu/ops/transformer/flash_attention.py (:145, :131), which
// seed the TPU's hardware PRNG with (2-word seed, tile coordinates) so
// the backward kernels regenerate the forward mask.  That works on the
// TPU only because its forward and backward use the same blocks.  The
// Hopper kernels tile differently (B1 64x32, B2a 64x32, B2b 32x64, B3 the
// whole score matrix), so the counter here names the ELEMENT: Philox4x32-10
// keyed on the 2-word seed, with counter (b·h, q row, k col >> 2, 0), and
// its four outputs are the bits of columns 4g .. 4g+3.  Every kernel, and
// the plain version `philox_keep_mask` in ops/transformer/flash_attention.py,
// then draws the same bits for an element whatever its tiling.
//
// A key is dropped iff its 32 bits are below `thresh` = round(rate·2³²)
// clamped to [1, 2³²−1]; a kept P is scaled by 1 / (1 − thresh/2³²), the
// TPU's threshold and scale (`_dropout_thresh`).
//
// Bound.  One draw is 10 rounds of two 32-bit multiply-high, two
// multiply-low, four XOR and two key additions: about 100 integer
// operations for 4 elements, all in registers, with no bytes moved.

#pragma once

#include <stdint.h>

namespace ds_flash {

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// Keep bits of columns 4g .. 4g+3 of score row `row` of head `bh`: bit i
// is 1 iff column 4g+i is kept.
// (k0, k1) are the two seed words.
__device__ __forceinline__ uint32_t keep_bits4(uint32_t k0, uint32_t k1,
                                               uint32_t bh, uint32_t row,
                                               uint32_t g, uint32_t thresh) {
  const uint4 r = philox4x32_10(make_uint4(bh, row, g, 0u), k0, k1);
  return static_cast<uint32_t>(r.x >= thresh) |
         (static_cast<uint32_t>(r.y >= thresh) << 1) |
         (static_cast<uint32_t>(r.z >= thresh) << 2) |
         (static_cast<uint32_t>(r.w >= thresh) << 3);
}

}  // namespace ds_flash
