// Flash-attention forward for NVIDIA Hopper (built for sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` of
// deepspeed_tpu/ops/transformer/flash_attention.py (:183, launched by
// `_flash_fwd` at :580).  It computes what that kernel computes: scaled
// Q·Kᵀ, causal and key-padding masking to NEG_INF, an online softmax with
// fp32 running max, sum and accumulator, the running max floored at
// MAX_FLOOR (a row whose every key is masked gives out = 0 and lse =
// MAX_FLOOR), P cast to the storage dtype before the P·V product, and out
// in the storage dtype plus an fp32 logsumexp.  Given B4's keep bits
// (flash_dropout.cu, drawn once per forward) it applies attention dropout:
// l sums the undropped P, and the P·V product takes the kept P scaled by
// 1/keep.
// The kernel reads q, k and v ([b, s, h, d], last dim contiguous) through
// their strides, so the caller's fused-QKV views need no transpose copy,
// and it masks ragged s and kv_len itself (no divisibility requirement).
//
// Bound.  At GPT-2-medium's training attention (b=8, h=16, s=1024, d=64,
// causal, bf16) q, k, v and out are 67 MB and lse 0.5 MB: 20 µs at
// 3.35 TB/s; the causal work is 4·d flops per visible pair, 17 GFLOP:
// 17 µs at 989 TFLOP/s.  At the largest prefill bucket (b=1, s=1024) the
// same is 8.4 MB (2.5 µs) against 2.2 GFLOP (2.2 µs).  So one launch is
// memory-bound, 0.020 ms at the training shape and 0.0025 ms at the
// serve shape, with the products close behind.
//
// Design of the bf16 kernel, flash_fwd_mma_kernel (tensor cores,
// flash_mma.cuh).  The TPU runs a grid (b·h, q blocks, k blocks) whose
// third dimension is sequential and carries m, l and acc in VMEM scratch.
// Here one block of 4 warps owns one (b·h, 64 query rows), each warp 16
// of them, and walks 64-key K/V tiles itself:
// - Q: the block's Q tile comes in by cp.async with the first K/V tile;
//   each warp reads its 16 rows once by ldmatrix as A fragments and keeps
//   them in registers for the whole key loop.
// - K/V: cp.async brings each 64-key tile into padded shared-memory tiles
//   two stages deep (tile j+1 in flight while tile j is computed), with
//   the tile's key mask beside it.  Under `causal` the loop stops at the
//   diagonal tile (the JAX `needed` test at :228), counted from the
//   rows' global position q_offset + i (a sequence-parallel chunk).
// - Scores: per tile each warp computes S = Q·Kᵀ as 16x64 fp32 C
//   fragments with `mma.sync.m16n8k16` (bf16 operands, fp32
//   accumulators), K read by ldmatrix.  The per-element causal, kv_len
//   and key-mask test runs only on the tiles that need it: the diagonal
//   tile, the tile that crosses kv_len, or every tile when a key mask is
//   given.
// - Softmax on the fragments: a thread holds 16 scores of two rows; a row
//   max is closed over the four lanes that share the row by two
//   `shfl.xor`.  The running max, in log2 units, is floored at MAX_FLOOR;
//   P = 2^(S·scale·log2 e − m) by `ex2.approx`; l sums the fp32 undropped
//   P per thread and the four lanes' sums are added once at the end; lse
//   goes back in natural-log units.
// - P·V: the kept P times 1/keep is rounded to bf16 and repacked from
//   the C fragments into the A fragments of the next product (c_to_a),
//   never through shared memory; O += P·V with V read by ldmatrix.trans.
// - Dropout: the keep bits of a tile (two 32-key words of each of its 64
//   rows, read from B4's packed mask) come in by 4-byte cp.async in the
//   same commit group as its K/V tile, into a two-stage shared bitmask;
//   the kernel draws nothing.
// - Epilogue: out = acc / l (l = 0 divides by 1) is staged in the warp's
//   own rows of the Q tile and written with 16-byte stores; lse is
//   m + log l, or exactly MAX_FLOOR for a row that saw no key.
// - Launch order: the last query tiles first, since under `causal` they
//   walk the most key tiles and the card starts blocks in grid order.
// - Shared memory: Q, two stages of K and V, the key mask and the keep
//   bits: 47,616 bytes at head_dim 64 and 88,576 at 128, dynamic above
//   48 KB.  A block owns its rows and no atomics touch a value, so two
//   runs are bitwise equal.
// - The kernel is instantiated with and without dropout, so a call
//   without keep bits loads and tests none.
// Registers and spills (nvcc -Xptxas -v, sm_90a, CUDA 12.8): at head_dim
// 64 160 a thread without dropout (three blocks an SM) and 128 with it
// (four blocks, 4 bytes spilled), at 128 212 and 219 (two blocks), no
// spill.
// `examples/profile_torch_b1.py` prints these counts and times the
// bound at other block counts side by side (PERF.md §6).
//
// fp16.  flash_fwd_mma_kernel is a template on its 16-bit element type;
// the fp16 instantiation is the same design with the `.f16` form of
// `mma.sync` and P and out rounded to fp16.  A non-finite score or value
// stays non-finite: the running max drops a NaN (fmaxf), but that
// element's P is ex2(NaN) = NaN, so l, out and lse are NaN, as the plain
// version's; a score of +inf gives m = inf and P = ex2(inf − inf) = NaN.
//
// The fp32 kernel keeps the earlier scalar design: the only tensor-core
// product for fp32 operands is TF32, which misses the fp32 forward
// tolerance (2e-5) the checks hold, and fp32 runs only in the parity and
// kernel checks.  There two threads share a query row, each holding half
// of head_dim for q and the accumulator in registers; the dot product is
// completed with one warp shuffle, so both threads see the same scores
// and keep identical m and l.  K/V tiles of 32 keys are converted to
// fp32 in shared memory, rows padded so the two halves sit in different
// banks.  Every multiply-add there is a scalar FMA on the CUDA cores.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

using ds_flash::from_float;
using ds_flash::kMaxFloor;
using ds_flash::kNegInf;
using ds_flash::to_float;

// ---------------------------------------------------------- B1, fp32
constexpr int kBlockQ = 64;          // query rows per thread block
constexpr int kBlockK = 32;          // keys per K/V tile
constexpr int kThreads = 2 * kBlockQ;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v,
                     const float* __restrict__ kv_mask, T* __restrict__ out,
                     float* __restrict__ lse, int heads, int s, int kv_len,
                     int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
                     int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
                     int64_t v_sh, float scale, int causal, int q_offset,
                     const uint32_t* __restrict__ keep_bits, int keep_words,
                     float inv_keep) {
  constexpr int DH = D / 2;       // head_dim elements each thread owns
  constexpr int HALF = DH + 4;    // padded half row: halves in other banks
  constexpr int ROW = 2 * HALF;   // padded K/V row in shared memory
  __shared__ __align__(16) float k_s[kBlockK * ROW];
  __shared__ __align__(16) float v_s[kBlockK * ROW];
  __shared__ float mask_s[kBlockK];

  const int tid = threadIdx.x;
  const int row = tid >> 1;
  const int half = tid & 1;
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int q0 = blockIdx.x * kBlockQ;
  const int qi = q0 + row;
  const bool q_valid = qi < s;
  // this row's words of B4's keep bits; none means every key is kept
  const uint32_t* keep_row =
      keep_bits ? keep_bits + ((int64_t)bh * s + (q_valid ? qi : 0)) *
                                  keep_words
                : nullptr;

  float qr[DH];
  float acc[DH];
  {
    const T* qrow = q + b * q_sb + (int64_t)(q_valid ? qi : 0) * q_ss +
                    h * q_sh + half * DH;
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      qr[d] = q_valid ? to_float(qrow[d]) : 0.f;
      acc[d] = 0.f;
    }
  }
  float m = kMaxFloor;
  float l = 0.f;

  const T* kbase = k + b * k_sb + h * k_sh;
  const T* vbase = v + b * v_sb + h * v_sh;
  const float* mrow = kv_mask ? kv_mask + (int64_t)b * kv_len : nullptr;
  // causal: rows q0 .. q0+kBlockQ-1 (global rows q_offset + q0 ..) see
  // no key past q_offset+q0+kBlockQ-1
  const int k_end = causal ? min(kv_len, q_offset + q0 + kBlockQ) : kv_len;

  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // every thread is done with the previous tile
    for (int e = tid; e < kBlockK * D; e += kThreads) {
      const int j = e / D;
      const int d = e - j * D;
      const int kj = k0 + j;
      const int dst = j * ROW + (d / DH) * HALF + (d % DH);
      float kx = 0.f, vx = 0.f;
      if (kj < kv_len) {
        kx = to_float(kbase[(int64_t)kj * k_ss + d]);
        vx = to_float(vbase[(int64_t)kj * v_ss + d]);
      }
      k_s[dst] = kx;
      v_s[dst] = vx;
    }
    if (tid < kBlockK) {
      // keys past kv_len (the ragged edge) are masked like padding
      const int kj = k0 + tid;
      mask_s[tid] = kj < kv_len ? (mrow ? mrow[kj] : 1.f) : 0.f;
    }
    __syncthreads();

    float sc[kBlockK];
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const float4* kr =
          reinterpret_cast<const float4*>(k_s + j * ROW + half * HALF);
      float part = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < DH / 4; ++d4) {
        const float4 kk = kr[d4];
        part = fmaf(qr[4 * d4 + 0], kk.x, part);
        part = fmaf(qr[4 * d4 + 1], kk.y, part);
        part = fmaf(qr[4 * d4 + 2], kk.z, part);
        part = fmaf(qr[4 * d4 + 3], kk.w, part);
      }
      // a + b == b + a exactly, so both threads of the row get one score
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      const bool visible =
          mask_s[j] > 0.f && (!causal || q_offset + qi >= k0 + j);
      const float x = visible ? part * scale : kNegInf;
      sc[j] = x;
      tile_max = fmaxf(tile_max, x);
    }

    // keep bits of this row's 32 keys: one word of B4's mask
    const uint32_t keep = keep_row ? keep_row[k0 >> 5] : 0xffffffffu;

    const float m_new = fmaxf(fmaxf(m, tile_max), kMaxFloor);
    const float corr = expf(m - m_new);
    float p_sum = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const float p = expf(sc[j] - m_new);
      p_sum += p;
      // l sums the fp32 undropped P; the P·V product takes the kept P,
      // scaled, in the storage dtype (inv_keep is 1 without dropout)
      const float pd = (keep >> j) & 1u ? p * inv_keep : 0.f;
      sc[j] = ds_flash::round_to<T>(pd);
    }
    l = l * corr + p_sum;
    m = m_new;
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] *= corr;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const float4* vr =
          reinterpret_cast<const float4*>(v_s + j * ROW + half * HALF);
      const float p = sc[j];
#pragma unroll
      for (int d4 = 0; d4 < DH / 4; ++d4) {
        const float4 vv = vr[d4];
        acc[4 * d4 + 0] = fmaf(p, vv.x, acc[4 * d4 + 0]);
        acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
        acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
        acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
      }
    }
  }

  if (q_valid) {
    const float l_safe = l == 0.f ? 1.f : l;
    T* orow = out + (((int64_t)b * s + qi) * heads + h) * D + half * DH;
#pragma unroll
    for (int d = 0; d < DH; ++d) orow[d] = from_float<T>(acc[d] / l_safe);
    if (half == 0) lse[(int64_t)bh * s + qi] = m + logf(l_safe);
  }
}


// ------------------------------------------------ B1, bf16 and fp16 (mma)
using bf16 = __nv_bfloat16;
using ds_flash::c_to_a;
using ds_flash::cp_async_commit;
using ds_flash::cp_async_wait;
using ds_flash::ex2_approx;
using ds_flash::kMmaThreads;
using ds_flash::kMmaTileRows;
using ds_flash::ldsm_a;
using ds_flash::ldsm_b;
using ds_flash::ldsm_bt;
using ds_flash::load_keep_tile_async;
using ds_flash::load_row_async;
using ds_flash::load_tile_async;
using ds_flash::mma16;
using ds_flash::MmaTile;
using ds_flash::pack16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kKeys = kMmaTileRows;       // keys per K/V tile
constexpr int kBitWords = 2 * kMmaTileRows;  // keep bits of a 64x64 tile

// the block's Q tile, two stages of K and of V, two stages of the key
// mask and two of the keep bits
template <int D>
constexpr int fwd_mma_smem_bytes() {
  return 5 * MmaTile<D>::kElems * static_cast<int>(sizeof(bf16)) +
         2 * kKeys * static_cast<int>(sizeof(float)) +
         2 * kBitWords * static_cast<int>(sizeof(uint32_t));
}

// Blocks an SM the launch bound asks for at head_dim 64, without and with
// dropout (two at 128).  With dropout (the keep bits read, no longer
// drawn) four blocks at 128 registers a thread still measured 1.5%
// faster than three at 162 on GPT-2's training attention; without, the
// products and exponentials run faster at 160 registers, three blocks
// (`examples/profile_torch_b1.py` times both at each count; PERF.md §6).
constexpr int kMinBlocks64 = 3;
constexpr int kMinBlocks64Dropout = 4;

// T: the 16-bit element type, bf16 or fp16 (the same design; only the
// `mma.sync` form and the roundings to T differ).  kDrop: dropout on (keep
// bits are given); without it the kernel loads and tests no keep bits.
template <typename T, int D, bool kDrop>
__global__ void __launch_bounds__(
    kMmaThreads, D == 64 ? (kDrop ? kMinBlocks64Dropout : kMinBlocks64) : 2)
    flash_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const float* __restrict__ kv_mask,
                         T* __restrict__ out, float* __restrict__ lse,
                         int heads, int s, int kv_len, int64_t q_sb,
                         int64_t q_ss, int64_t q_sh, int64_t k_sb,
                         int64_t k_ss, int64_t k_sh, int64_t v_sb,
                         int64_t v_ss, int64_t v_sh, float scale, int causal,
                         int q_offset,
                         const uint32_t* __restrict__ keep_bits,
                         int keep_words, float inv_keep) {
  using Tile = MmaTile<D>;
  extern __shared__ __align__(16) unsigned char fwd_smem[];
  T* q_s = reinterpret_cast<T*>(fwd_smem);
  T* k_s = q_s + Tile::kElems;      // two stages
  T* v_s = k_s + 2 * Tile::kElems;  // two stages
  float* mask_s = reinterpret_cast<float*>(v_s + 2 * Tile::kElems);
  uint32_t* bits_s = reinterpret_cast<uint32_t*>(mask_s + 2 * kKeys);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wr = (tid >> 5) * 16;  // the warp's first row in the block
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  // the last query tiles first: under `causal` they walk the most key
  // tiles, and the card starts blocks in grid order
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kMmaTileRows;
  const int wq0 = q0 + wr;  // the warp's first row
  const uint32_t* head_bits =
      kDrop ? keep_bits + (int64_t)bh * s * keep_words : nullptr;

  const T* kbase = k + b * k_sb + h * k_sh;
  const T* vbase = v + b * v_sb + h * v_sh;
  const float* mrow = kv_mask ? kv_mask + (int64_t)b * kv_len : nullptr;
  // causal: rows q0 .. q0+63 (global rows q_offset + q0 ..) see no key
  // past q_offset+q0+63
  const int k_end =
      causal ? min(kv_len, q_offset + q0 + kMmaTileRows) : kv_len;
  const int n_tiles = (k_end + kKeys - 1) / kKeys;

  auto issue = [&](int j) {
    const int stage = j & 1;
    const int kt = j * kKeys;
    load_tile_async<D>(k_s + stage * Tile::kElems, kbase, k_ss, kt, kv_len,
                       tid);
    load_tile_async<D>(v_s + stage * Tile::kElems, vbase, v_ss, kt, kv_len,
                       tid);
    // the tile's key mask, 0 past kv_len
    if (mrow) load_row_async(mask_s + stage * kKeys, mrow, kt, kv_len, tid);
    // the tile's keep bits: words 2j, 2j+1 of the block's rows
    if (kDrop)
      load_keep_tile_async(bits_s + stage * kBitWords, head_bits, keep_words,
                           q0, s, 2 * j, tid);
  };
  load_tile_async<D>(q_s, q + b * q_sb + h * q_sh, q_ss, q0, s, tid);
  issue(0);
  cp_async_commit();

  const float scale2 = scale * kLog2e;
  // the thread's rows are wq0 + g (hh = 0) and wq0 + g + 8 (hh = 1); m in
  // log2 units, l the thread's part of the row sum
  float m[2] = {kMaxFloor, kMaxFloor};
  float l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  uint32_t qa[D / 16][4];  // the warp's Q rows as A fragments

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) issue(j + 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile j (and at j = 0 the block's Q) is in
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldsm_a<D>(qa[kk], q_s, wr, 16 * kk, lane);
    }
    const T* kt_s = k_s + (j & 1) * Tile::kElems;
    const T* vt_s = v_s + (j & 1) * Tile::kElems;
    const int kt0 = j * kKeys;

    // S = Q·Kᵀ over the tile's 64 keys; the thread's keys are
    // kt0 + 8n + 2t + {0, 1}
    float sc[kKeys / 8][4];
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nn = 0; nn < kKeys / 16; ++nn) {
        uint32_t bk[4];
        ldsm_b<D>(bk, kt_s, 16 * nn, 16 * kk, lane);
        mma16<T>(sc[2 * nn], qa[kk], bk[0], bk[1]);
        mma16<T>(sc[2 * nn + 1], qa[kk], bk[2], bk[3]);
      }
    }
    // the element test only where the tile holds a key hidden from one of
    // the warp's rows: the diagonal tile, the tile that crosses kv_len,
    // every tile under a key mask
    if (mrow || kt0 + kKeys > kv_len ||
        (causal && kt0 + kKeys - 1 > q_offset + wq0)) {
      const float* mt = mask_s + (j & 1) * kKeys;
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kl = 8 * n + 2 * t + (e & 1);
          const int key = kt0 + kl;
          const int row = wq0 + g + 8 * (e >> 1);
          const bool vis = (mrow ? mt[kl] > 0.f : key < kv_len) &&
                           (!causal || q_offset + row >= key);
          if (!vis) sc[n][e] = kNegInf;
        }
      }
    }

    // the rows' new running max, over the four lanes that share a row
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
    float corr[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float m_new = fmaxf(fmaxf(m[hh], mx[hh] * scale2), kMaxFloor);
      corr[hh] = ex2_approx(m[hh] - m_new);
      m[hh] = m_new;
      l[hh] *= corr[hh];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }
    // keep bits of the thread's rows, one word per 32 keys, shifted so
    // that key 8n + 2t + x of a word is bit 8n + x
    uint32_t keep[2][2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int w = 0; w < 2; ++w)
        keep[hh][w] = kDrop ? bits_s[(j & 1) * kBitWords +
                                     2 * (wr + g + 8 * hh) + w] >>
                                  (2 * t)
                            : 0u;

    // P, l and O += P·V, 16 keys at a time: l sums the fp32 undropped P,
    // the product takes the kept P times 1/keep rounded to T
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
#pragma unroll
      for (int n = 2 * kk; n < 2 * kk + 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hh = e >> 1;
          const float p = ex2_approx(fmaf(sc[n][e], scale2, -m[hh]));
          l[hh] += p;
          if (kDrop)
            sc[n][e] = keep[hh][n >> 2] & (1u << (8 * (n & 3) + (e & 1)))
                           ? p * inv_keep
                           : 0.f;
          else
            sc[n][e] = p;
        }
      }
      uint32_t a[4];
      c_to_a<T>(a, sc[2 * kk], sc[2 * kk + 1]);
#pragma unroll
      for (int nd = 0; nd < D / 16; ++nd) {
        uint32_t bv[4];
        ldsm_bt<D>(bv, vt_s, 16 * kk, 16 * nd, lane);
        mma16<T>(acc[2 * nd], a, bv[0], bv[1]);
        mma16<T>(acc[2 * nd + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp is done with stage j & 1
  }
  cp_async_wait<0>();

  // out = acc / l into the warp's own 16 rows of the Q tile (only this
  // warp read them), then 16-byte stores of those rows
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    const float l_safe = l[hh] == 0.f ? 1.f : l[hh];
    const int r = wr + g + 8 * hh;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(q_s + r * Tile::kRow + 8 * n + 2 * t) =
          pack16<T>(acc[n][2 * hh] / l_safe, acc[n][2 * hh + 1] / l_safe);
    // a row that saw no key keeps m = MAX_FLOOR and l = 0
    if (t == 0 && q0 + r < s)
      lse[(int64_t)bh * s + q0 + r] =
          l[hh] == 0.f ? kMaxFloor : m[hh] * kLn2 + logf(l[hh]);
  }
  __syncwarp();
  constexpr int CH = Tile::kChunks;
#pragma unroll
  for (int e = lane; e < 16 * CH; e += 32) {
    const int r = e / CH;
    const int ch = e - r * CH;
    const int i = wq0 + r;
    if (i < s)
      *reinterpret_cast<uint4*>(out + (((int64_t)b * s + i) * heads + h) * D +
                                8 * ch) =
          *reinterpret_cast<const uint4*>(q_s + (wr + r) * Tile::kRow +
                                          8 * ch);
  }
}

// ----------------------------------------------------------- launchers
template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* kv_mask,
           void* out, void* lse, int batch, int heads, int s, int kv_len,
           int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
           int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
           int64_t v_sh, float scale, int causal, int q_offset,
           const uint32_t* keep_bits, int keep_words, float inv_keep,
           cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value ||
                std::is_same<T, __half>::value) {
    constexpr int kSmem = fwd_mma_smem_bytes<D>();
    auto kernel = keep_bits ? flash_fwd_mma_kernel<T, D, true>
                       : flash_fwd_mma_kernel<T, D, false>;
    const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const dim3 grid((s + kMmaTileRows - 1) / kMmaTileRows, batch * heads);
    kernel<<<grid, kMmaThreads, kSmem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const float*>(kv_mask),
        static_cast<T*>(out), static_cast<float*>(lse), heads, s, kv_len,
        q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale, causal,
        q_offset, keep_bits, keep_words, inv_keep);
  } else {
    // fp32: the scalar design
    const dim3 grid((s + kBlockQ - 1) / kBlockQ, batch * heads);
    flash_fwd_kernel<T, D><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const float*>(kv_mask),
        static_cast<T*>(out), static_cast<float*>(lse), heads, s, kv_len,
        q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale, causal,
        q_offset, keep_bits, keep_words, inv_keep);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  Strides are in elements;
// the last dimension of q, k and v must be contiguous, and in bf16 and
// fp16 each base
// 16-byte aligned with batch, seq and head strides multiples of 8 (the
// 16-byte cp.async copies).  kv_mask is [batch, kv_len]
// fp32 (1 keeps a key) or null; out is a contiguous [b, s, h, d] of the
// input dtype and lse a contiguous fp32 [b·h, s].  `keep_bits` is null (no
// dropout) or B4's packed keep mask (flash_dropout.cu), contiguous int32
// [b·h, s, keep_words] words with keep_words = ceil(kv_len/32), and
// `inv_keep` the dropout scale.  `q_offset` is the global row of q's row
// 0 (a sequence-parallel rank's chunk against the gathered keys): under
// `causal` row i sees keys 0 .. q_offset + i; 0 is a whole call.
// Launches on `stream`, does not synchronise, allocates nothing, and
// returns cudaGetLastError().
extern "C" int ds_flash_attention_fwd(
    int dtype, int head_dim, const void* q, const void* k, const void* v,
    const void* kv_mask, void* out, void* lse, int batch, int heads, int s,
    int kv_len, int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
    int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
    float scale, int causal, int q_offset, const void* keep_bits,
    int keep_words, float inv_keep, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DS_FLASH_LAUNCH(T, D)                                                 \
  return launch<T, D>(q, k, v, kv_mask, out, lse, batch, heads, s, kv_len,   \
                      q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,   \
                      scale, causal, q_offset,                                \
                      static_cast<const uint32_t*>(keep_bits), keep_words,    \
                      inv_keep, st)
  if (dtype == 0 && head_dim == 64) DS_FLASH_LAUNCH(float, 64);
  if (dtype == 0 && head_dim == 128) DS_FLASH_LAUNCH(float, 128);
  if (dtype == 1 && head_dim == 64) DS_FLASH_LAUNCH(__nv_bfloat16, 64);
  if (dtype == 1 && head_dim == 128) DS_FLASH_LAUNCH(__nv_bfloat16, 128);
  if (dtype == 2 && head_dim == 64) DS_FLASH_LAUNCH(__half, 64);
  if (dtype == 2 && head_dim == 128) DS_FLASH_LAUNCH(__half, 128);
#undef DS_FLASH_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
