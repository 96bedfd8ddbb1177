// Attention-dropout keep mask for the flash kernels on NVIDIA Hopper
// (built for sm_90a): B4.
//
// Replaces `_keep_mask` and `_dropout_thresh` of
// deepspeed_tpu/ops/transformer/flash_attention.py (:145, :131), which
// seed the TPU's hardware PRNG with (2-word seed, tile coordinates) inside
// every attention kernel, so the backward kernels regenerate the forward
// mask.  The TPU keeps no mask because its kernels have no cheap place to
// keep one.  The H100 has: one bit per score element is 16 MiB at GPT-2's
// training attention (b=8, h=16, s=1024), about 5 µs to write and as much
// to read at 3.35 TB/s, against tens of µs of integer issue per draw.  So
// this kernel draws the keep mask of a whole call ONCE per forward into
// a packed bit mask, and B1, B2a, B2b and B3 (flash_attention_fwd.cu,
// flash_attention_bwd.cu) read it and draw nothing.
//
// The bits.  int32 words [b·h, s, ceil(kv_len/32)]: bit c of word w of
// row i of head bh is 1 iff (i, 32w + c) is kept.  The draw is
// Philox4x32-10 keyed on the two seed words with counter (b·total_heads +
// head_offset + j, row, col >> 2, 0); its four outputs are the bits of
// columns 4g .. 4g+3, and a column is dropped iff its 32 bits are below
// `thresh` = round(rate·2³²) clamped to [1, 2³²−1] (the TPU's threshold,
// `_dropout_thresh`; the attention kernels scale a kept P by 1 / (1 −
// thresh/2³²)).  The counter names the element, so the bits do not depend
// on any kernel's tiling, and a tensor-parallel rank's range of heads
// draws exactly the bits of those heads of the whole call.  Groups of 4
// columns that hold no visible element (causal rows past the diagonal,
// columns at or past kv_len) are not drawn and have 0 bits, and so have
// the columns at or past kv_len of the last group: a P there is 0
// whatever the bit.  The plain version is `philox_keep_bits` in
// ops/transformer/flash_attention.py.
//
// Design for the card.  The kernel is pure integer issue:
// - one warp per item, an item being 32 consecutive rows of one head
//   (lane = row), and under `causal` the pair of row blocks rb and
//   RB−1−rb, whose visible words add up to about one full row each: every
//   warp has the same work (also for a chunk whose first row is row0 >
//   0: each row sees row0 more), and a word is visible to every lane of
//   a 32-row block or to none (a row block starts at a multiple of 32,
//   and so does a chunk of a 32-row multiple), so warps do not diverge
//   on the skip;
// - each lane walks its row's words in order, draws the 8 groups of a
//   visible word (a word that crosses the diagonal or kv_len is drawn
//   whole and its invisible groups masked to 0: at most 7 extra draws a
//   row), writes 0 for an invisible one, and stores whole words, four at
//   a time as one 16-byte store where the row length allows;
// - the ten round keys are computed once a thread; the first round's
//   product of the constant counter word b·h is computed once a thread,
//   so round 1 costs one multiply and one XOR a draw; each product gives
//   hi and lo in one `IMAD.WIDE.U32` (a 64-bit product of two 32-bit
//   words), and each round's two three-input XORs are one `LOP3` each.
//
// Bound.  At GPT-2's training attention the groups of 4 that hold a
// visible element number 16.8 M, one draw each.  A draw's instructions
// are counted in this kernel's SASS (chip_smoke.py `keep_bits_sass`: the
// forward slice of the Philox multiplies in the word loop, over its 32
// draws; no loop control, addresses, stores or mask arithmetic).  With
// CUDA 12.8 that is 44.6 a draw: 18.6 on the FMA pipe (17.75
// IMAD.WIDE.U32, the packing's IMAD.SHL), 25.75 on the ALU pipe (19.6
// LOP3, 4 ISETP, the packing's SEL and P2R) and 0.25 on the uniform
// datapath (a round-1 multiply of a warp-uniform column group).  Each
// pipe takes 64 results a clock a SM and the schedulers issue 128
// (CUDA C++ Programming Guide, compute capability 9.0), so the ALU pipe
// bounds a draw at 25.75 slots: 0.026 ms over 132 SMs at the card's
// maximum SM clock of 1980 MHz, against 0.005 ms for the 16 MiB of
// words written once at 3.35 TB/s.  So it is bound by operations.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kMul0 = 0xD2511F53u;
constexpr uint32_t kMul1 = 0xCD9E8D57u;
constexpr uint32_t kWeyl0 = 0x9E3779B9u;
constexpr uint32_t kWeyl1 = 0xBB67AE85u;
constexpr int kRounds = 10;
constexpr int kWarps = 4;  // warps a block, one item each

// hi and lo words of the 64-bit product a·b: one IMAD.WIDE.U32
__device__ __forceinline__ void mul_wide(uint32_t a, uint32_t b,
                                         uint32_t& hi, uint32_t& lo) {
  const uint64_t p = static_cast<uint64_t>(a) * b;
  hi = static_cast<uint32_t>(p >> 32);
  lo = static_cast<uint32_t>(p);
}

// The per-thread constants of the draws: the round keys, and round 1's
// outputs that depend on the counter's head word alone.
struct Keys {
  uint32_t k0[kRounds], k1[kRounds];
  uint32_t z1, w1;  // c.z and c.w after round 1
};

// Keep bits of columns 4g .. 4g+3 of the row whose first round-1 word is
// `x0` = row ^ k0[0]: bit i is 1 iff column 4g+i is kept.  Round 1 of
// counter (bh, row, g, 0) gives (hi(M1·g) ^ row ^ k0, lo(M1·g), hi(M0·bh)
// ^ k1, lo(M0·bh)); rounds 2..10 as Philox4x32.
__device__ __forceinline__ uint32_t keep_bits4(const Keys& key, uint32_t x0,
                                               uint32_t g, uint32_t thresh) {
  uint32_t hi1, lo1;
  mul_wide(kMul1, g, hi1, lo1);
  uint32_t cx = hi1 ^ x0, cy = lo1, cz = key.z1, cw = key.w1;
#pragma unroll
  for (int r = 1; r < kRounds; ++r) {
    uint32_t hi0, lo0;
    mul_wide(kMul0, cx, hi0, lo0);
    mul_wide(kMul1, cz, hi1, lo1);
    const uint32_t nx = hi1 ^ cy ^ key.k0[r];
    const uint32_t nz = hi0 ^ cw ^ key.k1[r];
    cy = lo1;
    cw = lo0;
    cx = nx;
    cz = nz;
  }
  return static_cast<uint32_t>(cx >= thresh) |
         (static_cast<uint32_t>(cy >= thresh) << 1) |
         (static_cast<uint32_t>(cz >= thresh) << 2) |
         (static_cast<uint32_t>(cw >= thresh) << 3);
}

// Word w (columns 32w .. 32w+31) of a row that sees columns below `lim`
// (at most kv_len): 0 when none of them is visible, else the 8 groups'
// bits with the groups at or past `lim` and the columns at or past
// kv_len cleared.
__device__ __forceinline__ uint32_t keep_word(const Keys& key, uint32_t x0,
                                              int w, int lim, int kv_len,
                                              uint32_t thresh) {
  const int rem = lim - 32 * w;
  if (rem <= 0) return 0u;
  uint32_t word = 0u;
#pragma unroll
  for (int u = 0; u < 8; ++u)
    word |= keep_bits4(key, x0, static_cast<uint32_t>(8 * w + u), thresh)
            << (4 * u);
  // rem above 28 sees all 8 groups (and a shift by 32 is undefined)
  if (rem <= 28) word &= (1u << (4 * ((rem + 3) >> 2))) - 1u;
  const int cols = kv_len - 32 * w;
  if (cols < 32) word &= (1u << cols) - 1u;
  return word;
}

// V words at a time: V = 4 stores 16 bytes (the row length `words` a
// multiple of 4, so every row starts 16-byte aligned), V = 1 one word.
template <int V>
__global__ void __launch_bounds__(32 * kWarps)
    keep_bits_kernel(uint32_t* __restrict__ bits,
                     const int* __restrict__ seed, int heads, int s,
                     int kv_len, int words, int causal, uint32_t thresh,
                     int drop_h0, int drop_heads, int row0) {
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int row_blocks = (s + 31) / 32;
  const int items = causal ? (row_blocks + 1) / 2 : row_blocks;
  if (item >= items) return;
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  // the counter's head word: this head's place in the whole call's heads
  const uint32_t dbh = static_cast<uint32_t>(b * drop_heads + drop_h0 + h);

  Keys key;
  key.k0[0] = static_cast<uint32_t>(seed[0]);
  key.k1[0] = static_cast<uint32_t>(seed[1]);
#pragma unroll
  for (int r = 1; r < kRounds; ++r) {
    key.k0[r] = key.k0[r - 1] + kWeyl0;
    key.k1[r] = key.k1[r - 1] + kWeyl1;
  }
  uint32_t hi0, lo0;
  mul_wide(kMul0, dbh, hi0, lo0);
  key.z1 = hi0 ^ key.k1[0];
  key.w1 = lo0;

  const int second = row_blocks - 1 - item;
  const int n_blocks = causal && second != item ? 2 : 1;
  for (int blk = 0; blk < n_blocks; ++blk) {
    const int row = 32 * (blk ? second : item) + lane;
    if (row >= s) continue;
    // the counter's row word and the causal limit are the global row
    const int grow = row0 + row;
    const int lim = causal ? min(kv_len, grow + 1) : kv_len;
    const uint32_t x0 = static_cast<uint32_t>(grow) ^ key.k0[0];
    uint32_t* out = bits + ((int64_t)bh * s + row) * words;
    for (int w = 0; w < words; w += V) {
      if constexpr (V == 4) {
        uint4 v;
        v.x = keep_word(key, x0, w, lim, kv_len, thresh);
        v.y = keep_word(key, x0, w + 1, lim, kv_len, thresh);
        v.z = keep_word(key, x0, w + 2, lim, kv_len, thresh);
        v.w = keep_word(key, x0, w + 3, lim, kv_len, thresh);
        *reinterpret_cast<uint4*>(out + w) = v;
      } else {
        out[w] = keep_word(key, x0, w, lim, kv_len, thresh);
      }
    }
  }
}

}  // namespace

// Writes the keep bits of a [batch, s, heads, *] attention call with
// `kv_len` keys into `bits`, contiguous int32 [batch·heads, s,
// ceil(kv_len/32)] words (16-byte aligned).  `seed` is two int32 words in
// device memory, `thresh` the dropout threshold; the bits of head h of
// batch b are those of head b·drop_heads + drop_h0 + h of the Philox
// counter (drop_h0 = 0, drop_heads = heads for a whole call; a
// tensor-parallel rank passes its first head and the model's head count).
// Row i of `bits` is the global row row0 + i (0 for a whole call; a
// sequence-parallel rank passes its chunk's first row): the Philox
// counter's row word is row0 + i, and under `causal` the row sees columns
// 0 .. row0 + i, so a chunk's words are those rows of a whole call's.
// Launches on `stream`, does not synchronise, allocates nothing, and
// returns the CUDA error.
extern "C" int ds_flash_keep_bits(void* bits, const void* seed, int batch,
                                  int heads, int s, int kv_len, int causal,
                                  uint32_t thresh, int drop_h0,
                                  int drop_heads, int row0, void* stream) {
  if (batch <= 0 || heads <= 0 || s <= 0 || kv_len <= 0 || row0 < 0 ||
      batch * heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int words = (kv_len + 31) / 32;
  const int row_blocks = (s + 31) / 32;
  const int items = causal ? (row_blocks + 1) / 2 : row_blocks;
  const dim3 grid((items + kWarps - 1) / kWarps, batch * heads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint32_t* out = static_cast<uint32_t*>(bits);
  const int* sd = static_cast<const int*>(seed);
  if (words % 4 == 0)
    keep_bits_kernel<4><<<grid, 32 * kWarps, 0, st>>>(
        out, sd, heads, s, kv_len, words, causal, thresh, drop_h0,
        drop_heads, row0);
  else
    keep_bits_kernel<1><<<grid, 32 * kWarps, 0, st>>>(
        out, sd, heads, s, kv_len, words, causal, thresh, drop_h0,
        drop_heads, row0);
  return static_cast<int>(cudaGetLastError());
}
