// Warp-level tensor-core building blocks for the flash kernels on Hopper
// (sm_90a): the bf16 and fp16 B1 of flash_attention_fwd.cu, B2a, B2b and
// B3 of flash_attention_bwd.cu, and the bf16 B6a, B6b and B6c of
// ../sparse_attention/flash_block_sparse_agg.cu (which also run the bf16
// B5a and B5b, at G = 1) use them; the fp32 kernels keep their scalar
// designs.  Every helper that touches a 16-bit operand takes its element
// type T, `__nv_bfloat16` (the default) or `__half`: the two differ only
// in the `mma.sync` form and the fp32 -> operand rounding (`ldmatrix` and
// `cp.async` move 16-bit words either way).
//
// - PTX wrappers: `mma.sync` m16n8k16 (bf16 or fp16 operands, fp32
//   accumulators),
//   `ldmatrix` x4 and x4.trans, `ex2.approx`, `cp.async` of 16 bytes
//   (zero-filled past the end of a tensor) and of 4 bytes, and the commit
//   / wait steps of a cp.async pipeline.
// - The C-fragment -> A-fragment repack: the fp32 C fragments of two
//   m16n8 tiles are, rounded to bf16, the A fragment of one m16n8k16
//   product over those 16 columns, so a score tile goes from one product
//   into the next without a round trip through shared memory.
// - Padded tiles: a 64-row tile of D bf16 values a row sits in shared
//   memory with rows of D + 8 values (16 bytes of padding), so the 8 rows
//   an `ldmatrix` phase reads start in 8 different 16-byte bank groups
//   and the loads are free of bank conflicts; `ldsm_a`, `ldsm_b` and
//   `ldsm_bt` give each lane its fragment of such a tile, and `OwnRows`
//   holds a warp's A fragments of the 16 rows of a block-owned tile.
// - The keep-bit loader of the attention dropout: the 64x64 keep bits of
//   a score tile, read from B4's packed mask (flash_dropout.cu) into a
//   shared-memory bitmask by 4-byte cp.async, one word a thread.
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k16"), with
// g = lane / 4 and t = lane % 4:
//   A 16x16 (row-major), 4 registers of two bf16: a0 = A[g][2t..2t+1],
//     a1 = A[g+8][2t..2t+1], a2 = A[g][2t+8..2t+9], a3 = A[g+8][2t+8..];
//   B 16x8 (column-major), 2 registers: b0 = B[2t..2t+1][g],
//     b1 = B[2t+8..2t+9][g];
//   C 16x8 fp32, 4 values: c0, c1 = C[g][2t..2t+1], c2, c3 = C[g+8][2t..].

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

namespace ds_flash {

// ------------------------------------------------------------ PTX wrappers
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// d += a·b over one m16n8k16 step: bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the same with fp16 operands
__device__ __forceinline__ void mma_f16(float (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 matrices of 16-bit values; lane l gives the row address of matrix l / 8,
// row l % 8, and receives in r[i] its two values of matrix i
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// the same, each matrix transposed
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// 2^x on the special-function unit (max relative error 2^-22, denormal
// results flushed to zero): enough for a P that is rounded to bf16
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 16 bytes global -> shared, asynchronous; zeros when !valid (the source
// size operand 0 reads nothing, so `src` need only be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared, asynchronous; zero when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :
               : "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// ------------------------------------------------------ end of PTX wrappers

// d += a·b with operands of element type T
template <typename T>
__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __half>::value)
    mma_f16(d, a, b0, b1);
  else
    mma_bf16(d, a, b0, b1);
}

// two fp32 values as one register of two bf16 (round to nearest even),
// `lo` in the low half: the lower column of an A-fragment pair
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the same as two fp16 (round to nearest even; above 65504 in magnitude
// inf, as `.astype(float16)` rounds)
__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <typename T>
__device__ __forceinline__ uint32_t pack16(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value)
    return pack_f16(lo, hi);
  else
    return pack_bf16(lo, hi);
}

// A fragment of the 16 columns covered by the C fragments of two
// neighbouring m16n8 tiles (c0: columns 0-7, c1: columns 8-15), rounded
// to T
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack16<T>(c0[0], c0[1]);
  a[1] = pack16<T>(c0[2], c0[3]);
  a[2] = pack16<T>(c1[0], c1[1]);
  a[3] = pack16<T>(c1[2], c1[3]);
}

// ------------------------------------------------------------ padded tiles
constexpr int kMmaTileRows = 64;  // rows of a streamed or owned tile
constexpr int kMmaThreads = 128;  // 4 warps, 16 rows each

template <int D>
struct MmaTile {
  static constexpr int kRow = D + 8;  // padded row, 16-bit values
  static constexpr int kElems = kMmaTileRows * kRow;
  static constexpr int kChunks = D / 8;  // 16-byte chunks a row
};

// Rows row0 .. row0+63 of a [*, D] tensor of 16-bit T (row stride
// `stride` values, 16-byte aligned rows) into the padded tile `dst` by
// cp.async; rows at or past `lim` are zero.  All kMmaThreads threads take
// part.
template <int D, typename T>
__device__ __forceinline__ void load_tile_async(T* dst, const T* src,
                                                int64_t stride, int row0,
                                                int lim, int tid) {
  constexpr int CH = MmaTile<D>::kChunks;
#pragma unroll
  for (int it = 0; it < kMmaTileRows * CH / kMmaThreads; ++it) {
    const int e = tid + it * kMmaThreads;
    const int r = e / CH;
    const int ch = e - r * CH;
    const bool ok = row0 + r < lim;
    const T* g = src + (ok ? (int64_t)(row0 + r) * stride : 0);
    cp_async16(dst + r * MmaTile<D>::kRow + ch * 8, g + ch * 8, ok);
  }
}

// 64 consecutive fp32 values src[row0 ..] into dst by cp.async, zero at
// or past `lim`; threads 0-63 take part.
__device__ __forceinline__ void load_row_async(float* dst, const float* src,
                                               int row0, int lim, int tid) {
  if (tid < kMmaTileRows) {
    const bool ok = row0 + tid < lim;
    cp_async4(dst + tid, src + (ok ? row0 + tid : 0), ok);
  }
}

// A fragment of the 16x16 block of a padded tile at (row r0, column k0)
template <int D, typename T>
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[4], const T* tile, int r0,
                                       int k0, int lane) {
  ldmatrix_x4(a, tile + (r0 + (lane & 15)) * MmaTile<D>::kRow + k0 +
                     (lane >> 4) * 8);
}

// B fragments of two n8 tiles (n0 .. n0+15) and one k step (k0 .. k0+15)
// where the tile's ROWS are the n index and its columns the k index
// (B = tileᵀ, as K in Q·Kᵀ): b[0], b[1] for n0 .. n0+7, b[2], b[3] for
// n0+8 .. n0+15
template <int D, typename T>
__device__ __forceinline__ void ldsm_b(uint32_t (&b)[4], const T* tile, int n0,
                                       int k0, int lane) {
  ldmatrix_x4(b, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) *
                            MmaTile<D>::kRow +
                     k0 + ((lane >> 3) & 1) * 8);
}

// The same where the tile's rows are the k index and its columns the n
// index (B = tile, as V in P·V), read with ldmatrix.trans
template <int D, typename T>
__device__ __forceinline__ void ldsm_bt(uint32_t (&b)[4], const T* tile, int k0,
                                        int n0, int lane) {
  ldmatrix_x4_trans(b, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                  MmaTile<D>::kRow +
                           n0 + (lane >> 4) * 8);
}

// The A fragments of a warp's 16 rows of a block-owned padded tile:
// held in registers at head_dim 64, re-read by ldmatrix at every use at
// head_dim 128, where the registers go to the accumulators.
template <int D, typename T = __nv_bfloat16>
struct OwnRows {
  static constexpr bool kInRegs = D == 64;
  uint32_t r[kInRegs ? D / 16 : 1][4];
  const T* tile;
  int r0, lane;

  __device__ __forceinline__ void init(const T* t, int row0,
                                       int ln) {
    tile = t;
    r0 = row0;
    lane = ln;
    if constexpr (kInRegs) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldsm_a<D>(r[kk], tile, r0, 16 * kk, lane);
    }
  }

  __device__ __forceinline__ void get(uint32_t (&a)[4], int kk) const {
    if constexpr (kInRegs) {
#pragma unroll
      for (int x = 0; x < 4; ++x) a[x] = r[kk][x];
    } else {
      ldsm_a<D>(a, tile, r0, 16 * kk, lane);
    }
  }
};

// ------------------------------------------------------------ keep bits
// The keep bits of score rows row0 .. row0+63 and words word0, word0+1
// (keys 32·word0 .. 32·word0+63) of one head's part `head_bits` of B4's
// packed mask (flash_dropout.cu: `words` int32 words a row) into the
// shared-memory bitmask `bits` by cp.async: bits[2r + w] is word word0 +
// w of row row0 + r, 0 for a row at or past `rows` or a word at or past
// `words`.  One 4-byte copy a thread; threads 0-127 take part.
__device__ __forceinline__ void load_keep_tile_async(
    uint32_t* bits, const uint32_t* head_bits, int words, int row0,
    int rows, int word0, int tid) {
  if (tid < 2 * kMmaTileRows) {
    const int r = row0 + (tid >> 1);
    const int w = word0 + (tid & 1);
    const bool ok = r < rows && w < words;
    cp_async4(bits + tid, head_bits + (ok ? (int64_t)r * words + w : 0), ok);
  }
}

}  // namespace ds_flash
