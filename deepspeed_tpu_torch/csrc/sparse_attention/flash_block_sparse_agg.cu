// Block-sparse flash attention over G×G super-tiles for NVIDIA Hopper
// (built for sm_90a): forward, dq and dk/dv kernels.
//
// Replaces, in deepspeed_tpu/ops/sparse_attention/flash_block_sparse.py:
//   B6a `_fwd_kernel_agg`     (:333, launched at :598)
//       -> agg_fwd_mma_kernel (bf16, fp16), agg_fwd_kernel (fp32)
//   B6b `_bwd_dq_kernel_agg`  (:373, launched at :650)
//       -> agg_bwd_dq_mma_kernel (bf16, fp16), agg_bwd_dq_kernel (fp32)
//   B6c `_bwd_dkv_kernel_agg` (:402, launched at :682)
//       -> agg_bwd_dkv_mma_kernel (bf16, fp16), agg_bwd_dkv_kernel (fp32)
// and, at G = 1, the 16-bit halves of B5a `_fwd_kernel` (:213) and B5b
// `_bwd_fused_kernel` (:253): the 16-bit B5a wrapper launches
// agg_fwd_mma_kernel and the 16-bit B5b wrapper agg_bwd_dq_mma_kernel and
// agg_bwd_dkv_mma_kernel with the G = 1 tables, where a super-tile is one
// layout block with one mask bit and the lse rule below is B5's.
// They compute what those kernels compute.  A super-tile covers a G×G
// patch of [blk, blk] layout blocks, n = G·blk rows by n keys; its int32
// mask (build_super_luts) has bit row_g·G + col_g set where sub-block
// (row_g, col_g) is active, and element (r, c) of the tile is visible iff
// the bit of ((r mod n) / blk, (c mod n) / blk) is set and, under
// `causal`, the global row is at or past the global column.  Scores are
// the scaled Q·Kᵀ in fp32, masked ones NEG_INF; the online softmax floors
// the running max at MAX_FLOOR; l == 0 divides by 1; P is rounded to the
// storage type before P·V, and dS before dS·K and dSᵀ·Q; 1/√d is folded
// into dq and dk at the end; Δ = rowsum(dO∘O) comes in precomputed, as
// the JAX package computes it outside Pallas (:647-648).  The layout
// head is 0 for a shared layout, else the head.
//
// The lse of a row that sees no pair follows the TPU's super-tile rule,
// not B5's: every row of a super-row with an active super-tile passes the
// floored max, so its lse is MAX_FLOOR even where its own layout block
// has no active tile; a row of a super-row with none keeps NEG_INF.  Here
// the running max starts at MAX_FLOOR for the rows of a super-row with
// scnt > 0, which gives that rule whatever tiles are skipped below.
// Out and dq of such rows are exactly 0, and so are dk and dv of a key
// that no row sees.
//
// Design.  The TPU kernels run one (b·h, super-row) per grid row and
// stream its active super-tiles on a sequential grid axis, because the
// MXU wants 512-wide tiles.  On Hopper the reason for super-tiles is the
// block's rows: a layout block under 64 rows fills only part of a B5
// block (flash_block_sparse.cu), and a super-row of several layout
// blocks fills it.  Every kernel gives a block 64 output rows (or keys)
// of a super-tile row (or column), and each block owns them, so no
// atomic touches a value and two runs are bitwise equal.
// - The fp32 B6a, B6b and B6c keep the first, scalar design: one block
//   per (b·h, 64-row part of a super q-row) or (b·h, 64-key part of a
//   super key column, over the transposed tables stlut/stmask), walking
//   the other side in 32-wide tiles and skipping a tile whose mask bits
//   are all zero for its own rows; fp32 FMAs on the CUDA cores with the
//   shared steps of ../transformer/flash_common.cuh, plain loads and no
//   copy/compute overlap.  They serve the parity checks (TF32 would miss
//   their 2e-5 / 5e-4).
// - The bf16 and fp16 B6a, B6b and B6c run on the tensor cores (one
//   template on the 16-bit type T: the two differ only in the mma.sync
//   form and the fp32 -> T rounding of P, dS and the outputs, as B1-B3
//   do; scores, lse and Δ stay fp32 in both), in the shape of
//   B1, B2a and B2b (../transformer/flash_attention_fwd.cu and
//   flash_attention_bwd.cu, with ../transformer/flash_mma.cuh): 4 warps
//   of 16 rows (keys) hold Q (and dO; B6c K and V) as A fragments; the
//   other side streams in 64-wide tiles by cp.async, two stages deep
//   (zero-filled past the super-tile's end, so n = 72 at blk 24 is cut
//   64 + 8).  B6a: S = Q·Kᵀ on mma.sync m16n8k16 over the 64 keys, the
//   online softmax on the C fragments in log2 units (ex2), P repacked
//   C→A as T in registers, O += P·V with ldmatrix.trans, out staged
//   in the block's Q tile and stored in 16-byte chunks.  B6b and B6c: S
//   and dP (Sᵀ and dPᵀ) in 32-wide chunks; dS (and Pᵀ, dSᵀ) repacked
//   C→A; dq += dS·K (dv += Pᵀ·dO, dk += dSᵀ·Q).  No dropout: B6 has
//   none.
// - The mask, per 64×64 tile and for the whole block at once
//   (TileWalk): a tile with no visible element for the block's 64 is
//   skipped (exact, causal included); a *full* tile (every row group ×
//   column group bit set, 64 by 64 inside the super-tile and, under
//   `causal`, wholly below the diagonal) runs no per-element test; a
//   *partial* one tests each C-fragment element (row group, column
//   group, causal, the super-tile's end) before ex2, so a masked
//   element is 0 even in a row whose lse is MAX_FLOOR.  At the BERT
//   layout (blk 128) every visited tile is full; blk 16, 24, 32 and the
//   causal cases take the partial path.
// - Launch order.  A block's work is its visited tiles, which differ:
//   at the BERT layout a B6c block of a global key column walks 64, the
//   others 8 (mean 22; B6a's and B6b's walk 22 each); at the sparse
//   GPT-2 layout (G = 1, the bf16 B5a and B5b) a dk/dv block of a
//   global key column walks up to 52, the others 16 or fewer, and a
//   forward or dq block 1 to 28.  The wrapper passes an int32 order of
//   the blocks, the most tiles first (build_launch_order, counted on the
//   host by the same rule as TileWalk; B6a and B5a take the dq order),
//   and grid y is the rank in it, so the
//   card, which starts blocks in grid order, starts the longest first
//   and fills in behind them with the short ones.  The order changes
//   when a block runs, not what it writes.
//
// Bound.  At the BERT sparse training attention (b=2, h=16, s=4096,
// d=64, bf16, the layout above: 5.77e6 visible pairs a head) q, k, v and
// out are 67 MB (20 µs at 3.35 TB/s), against 1.85e8 pairs · 4·d flops =
// 47 GFLOP (48 µs at 989 TFLOP/s): bound by operations.  B6b does 6·d
// and B6c 8·d per pair (72 and 96 µs).  The bf16 kernels' mma.sync runs
// well below the wgmma peak that bound assumes, and the backward
// recomputes S and dP in both kernels; wgmma with TMA is the next step.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "transformer/flash_common.cuh"
#include "transformer/flash_mma.cuh"

namespace {

using ds_flash::from_float;
using ds_flash::kMaxFloor;
using ds_flash::kNegInf;
using ds_flash::kSpTile;
using ds_flash::load_row_stats;
using ds_flash::load_seg;
using ds_flash::load_tile_pair;
using ds_flash::SpTile;

constexpr int kRows = 64;  // output rows (queries, or keys) per block
constexpr int kEpt = 16;   // head_dim elements a backward thread owns

// element strides (batch, seq, head); the last dimension is contiguous
struct Strides {
  int64_t q[3], k[3], v[3], o[3], grad[3];
};

// one direction of the super-tile tables (int32, device memory): the
// active super key columns of each super q-row (slut/scnt/smask), or the
// active super q-rows of each super key column (stlut/stcnt/stmask)
struct SuperLayout {
  const int* lut;   // [H, ns, width]
  const int* cnt;   // [H, ns]
  const int* mask;  // [H, ns, width], G·G bits each
  int layout_heads, ns, G, blk, width;
  int n;      // G·blk, the rows (and keys) of a super-tile
  int parts;  // 64-row parts of one super-tile
};

// bits lo .. hi (inclusive) set
__device__ __forceinline__ uint32_t span(int lo, int hi) {
  return ((2u << hi) - 1u) & ~((1u << lo) - 1u);
}

// The column groups that any of row groups lo .. hi sees in a tile with
// mask `bits`, as a G-bit set.
__device__ __forceinline__ uint32_t cols_of_rows(uint32_t bits, int G,
                                                 int lo, int hi) {
  uint32_t cols = 0;
  for (int rg = lo; rg <= hi; ++rg) cols |= bits >> (rg * G);
  return cols & ((1u << G) - 1u);
}

// The row groups that see any of column groups lo .. hi, as a G-bit set.
__device__ __forceinline__ uint32_t rows_of_cols(uint32_t bits, int G,
                                                 int lo, int hi) {
  const uint32_t want = span(lo, hi);
  uint32_t rows = 0;
  for (int rg = 0; rg < G; ++rg)
    if ((bits >> (rg * G)) & want) rows |= 1u << rg;
  return rows;
}

// Where a block's 64 output rows lie: super-tile `tile` of the sequence,
// part `part`; rows r0 .. r_end-1, in row groups g_lo .. g_hi.
struct Part {
  int base, r0, r_end, g_lo, g_hi;
  __device__ Part(const SuperLayout& lay, int tile, int part) {
    base = tile * lay.n;
    r0 = base + part * kRows;
    r_end = min(r0 + kRows, base + lay.n);
    g_lo = (r0 - base) / lay.blk;
    g_hi = (r_end - 1 - base) / lay.blk;
  }
  // the same rows d further on (a chunk's rows at their global place)
  __device__ Part shifted(int d) const {
    Part r = *this;
    r.base += d;
    r.r0 += d;
    r.r_end += d;
    return r;
  }
};

// ----------------------------------------------------------------- B6a
template <typename T, int D>
__global__ void __launch_bounds__(2 * kRows)
    agg_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ out,
                   float* __restrict__ lse, SuperLayout lay, int heads, int s,
                   Strides st, float scale, int causal, int q_off) {
  constexpr int TPR = 2;         // threads per query row
  constexpr int SEG = D / TPR;   // head_dim elements each thread owns
  constexpr int THREADS = TPR * kRows;
  __shared__ __align__(16) float k_s[SpTile<TPR, SEG>::kFloats];
  __shared__ __align__(16) float v_s[SpTile<TPR, SEG>::kFloats];
  __shared__ int col_s[kSpTile];  // column group of each key (G: none)

  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int seg = tid % TPR;
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int lh = lay.layout_heads == 1 ? 0 : h;
  const int sq = blockIdx.x / lay.parts;
  const Part p(lay, sq, blockIdx.x - sq * lay.parts);
  const int qi = p.r0 + row;
  const bool q_valid = qi < p.r_end;
  const int my_g = q_valid ? (qi - p.base) / lay.blk : p.g_lo;

  float qr[SEG], acc[SEG];
  load_seg(qr, q + b * st.q[0] + (int64_t)(q_valid ? qi : 0) * st.q[1] +
                   h * st.q[2] + seg * SEG,
           q_valid);
#pragma unroll
  for (int d = 0; d < SEG; ++d) acc[d] = 0.f;
  const int64_t row_off = (int64_t)lh * lay.ns + sq;
  const int n_active = lay.cnt[row_off];
  // the TPU's rule: a super-row with an active super-tile floors every
  // one of its rows' max; one with none keeps NEG_INF
  float m = n_active > 0 ? kMaxFloor : kNegInf;
  float l = 0.f;

  const T* kbase = k + b * st.k[0] + h * st.k[2];
  const T* vbase = v + b * st.v[0] + h * st.v[2];
  const uint32_t g_mask = (1u << lay.G) - 1u;

  for (int t = 0; t < n_active; ++t) {
    const int c_base = lay.lut[row_off * lay.width + t] * lay.n;
    const uint32_t bits = lay.mask[row_off * lay.width + t];
    const uint32_t mine = (bits >> (my_g * lay.G)) & g_mask;
    const uint32_t block_cols = cols_of_rows(bits, lay.G, p.g_lo, p.g_hi);
    const int key_lim = c_base + lay.n;
    // causal: rows r0 .. r_end-1 (global q_off + r0 ..) see no key past
    // q_off+r_end-1
    const int k_end = causal ? min(key_lim, q_off + p.r_end) : key_lim;
    for (int k0 = c_base; k0 < k_end; k0 += kSpTile) {
      const int c_lo = (k0 - c_base) / lay.blk;
      const int c_hi = (min(k0 + kSpTile, key_lim) - 1 - c_base) / lay.blk;
      if (!(block_cols & span(c_lo, c_hi))) continue;  // uniform per block
      __syncthreads();  // every thread is done with the previous tile
      load_tile_pair<T, TPR, SEG>(k_s, v_s, kbase, st.k[1], vbase, st.v[1],
                                  k0, key_lim, tid, THREADS);
      if (tid < kSpTile) {
        const int kj = k0 + tid;
        col_s[tid] = kj < key_lim ? (kj - c_base) / lay.blk : lay.G;
      }
      __syncthreads();
      ds_flash::sparse_fwd_tile<T, TPR, SEG>(
          k_s, v_s, seg, qr, acc, m, l, scale, [&](int j) {
            return ((mine >> col_s[j]) & 1u) &&
                   (!causal || q_off + qi >= k0 + j);
          });
    }
  }

  if (q_valid) {
    const float l_safe = l == 0.f ? 1.f : l;
    T* orow = out + (((int64_t)b * s + qi) * heads + h) * D + seg * SEG;
#pragma unroll
    for (int d = 0; d < SEG; ++d) orow[d] = from_float<T>(acc[d] / l_safe);
    if (seg == 0) lse[(int64_t)bh * s + qi] = m + logf(l_safe);
  }
}

// ----------------------------------------------------------------- B6b
template <typename T, int D>
__global__ void __launch_bounds__(kRows * (D / kEpt))
    agg_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dq,
                      SuperLayout lay, int heads, int s, Strides st,
                      float scale, int causal, int q_off) {
  constexpr int TPR = D / kEpt;  // threads per query row
  constexpr int THREADS = kRows * TPR;
  __shared__ __align__(16) float k_s[SpTile<TPR, kEpt>::kFloats];
  __shared__ __align__(16) float v_s[SpTile<TPR, kEpt>::kFloats];
  __shared__ int col_s[kSpTile];

  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int part = tid % TPR;
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int lh = lay.layout_heads == 1 ? 0 : h;
  const int sq = blockIdx.x / lay.parts;
  const Part p(lay, sq, blockIdx.x - sq * lay.parts);
  const int qi = p.r0 + row;
  const bool q_valid = qi < p.r_end;
  const int qr_i = q_valid ? qi : 0;
  const int my_g = q_valid ? (qi - p.base) / lay.blk : p.g_lo;

  float qr[kEpt], dor[kEpt], acc[kEpt];
  load_seg(qr,
           q + b * st.q[0] + (int64_t)qr_i * st.q[1] + h * st.q[2] +
               part * kEpt,
           q_valid);
  load_seg(dor,
           dout + b * st.o[0] + (int64_t)qr_i * st.o[1] + h * st.o[2] +
               part * kEpt,
           q_valid);
#pragma unroll
  for (int e = 0; e < kEpt; ++e) acc[e] = 0.f;
  const float lse_i = q_valid ? lse[(int64_t)bh * s + qi] : 0.f;
  const float delta_i = q_valid ? delta[(int64_t)bh * s + qi] : 0.f;

  const int64_t row_off = (int64_t)lh * lay.ns + sq;
  const int n_active = lay.cnt[row_off];
  const T* kbase = k + b * st.k[0] + h * st.k[2];
  const T* vbase = v + b * st.v[0] + h * st.v[2];
  const uint32_t g_mask = (1u << lay.G) - 1u;

  for (int t = 0; t < n_active; ++t) {
    const int c_base = lay.lut[row_off * lay.width + t] * lay.n;
    const uint32_t bits = lay.mask[row_off * lay.width + t];
    const uint32_t mine = (bits >> (my_g * lay.G)) & g_mask;
    const uint32_t block_cols = cols_of_rows(bits, lay.G, p.g_lo, p.g_hi);
    const int key_lim = c_base + lay.n;
    const int k_end = causal ? min(key_lim, q_off + p.r_end) : key_lim;
    for (int k0 = c_base; k0 < k_end; k0 += kSpTile) {
      const int c_lo = (k0 - c_base) / lay.blk;
      const int c_hi = (min(k0 + kSpTile, key_lim) - 1 - c_base) / lay.blk;
      if (!(block_cols & span(c_lo, c_hi))) continue;  // uniform per block
      __syncthreads();  // every thread is done with the previous tile
      load_tile_pair<T, TPR, kEpt>(k_s, v_s, kbase, st.k[1], vbase,
                                   st.v[1], k0, key_lim, tid, THREADS);
      if (tid < kSpTile) {
        const int kj = k0 + tid;
        col_s[tid] = kj < key_lim ? (kj - c_base) / lay.blk : lay.G;
      }
      __syncthreads();
      ds_flash::sparse_dq_tile<T, TPR, kEpt>(
          k_s, v_s, part, qr, dor, acc, lse_i, delta_i, scale, [&](int j) {
            return ((mine >> col_s[j]) & 1u) &&
                   (!causal || q_off + qi >= k0 + j);
          });
    }
  }

  if (q_valid) {
    T* o = dq + b * st.grad[0] + (int64_t)qi * st.grad[1] +
           h * st.grad[2] + part * kEpt;
#pragma unroll
    for (int e = 0; e < kEpt; ++e) o[e] = from_float<T>(acc[e] * scale);
  }
}

// ----------------------------------------------------------------- B6c
template <typename T, int D>
__global__ void __launch_bounds__(kRows * (D / kEpt))
    agg_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, T* __restrict__ dk,
                       T* __restrict__ dv, SuperLayout lay, int heads, int s,
                       Strides st, float scale, int causal, int q_off) {
  constexpr int TPR = D / kEpt;  // threads per key
  constexpr int THREADS = kRows * TPR;
  __shared__ __align__(16) float q_s[SpTile<TPR, kEpt>::kFloats];
  __shared__ __align__(16) float o_s[SpTile<TPR, kEpt>::kFloats];
  __shared__ float lse_s[kSpTile];
  __shared__ float delta_s[kSpTile];
  __shared__ int row_s[kSpTile];  // row group of each query (G: none)

  const int tid = threadIdx.x;
  const int key = tid / TPR;
  const int part = tid % TPR;
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int lh = lay.layout_heads == 1 ? 0 : h;
  const int sk = blockIdx.x / lay.parts;
  const Part p(lay, sk, blockIdx.x - sk * lay.parts);
  const int kj = p.r0 + key;
  const bool k_valid = kj < p.r_end;
  const int kj_i = k_valid ? kj : 0;
  const int my_g = k_valid ? (kj - p.base) / lay.blk : p.g_lo;

  float kr[kEpt], vr[kEpt], dka[kEpt], dva[kEpt];
  load_seg(kr,
           k + b * st.k[0] + (int64_t)kj_i * st.k[1] + h * st.k[2] +
               part * kEpt,
           k_valid);
  load_seg(vr,
           v + b * st.v[0] + (int64_t)kj_i * st.v[1] + h * st.v[2] +
               part * kEpt,
           k_valid);
#pragma unroll
  for (int e = 0; e < kEpt; ++e) dka[e] = dva[e] = 0.f;

  const int64_t col_off = (int64_t)lh * lay.ns + sk;
  const int n_active = lay.cnt[col_off];
  const T* qbase = q + b * st.q[0] + h * st.q[2];
  const T* obase = dout + b * st.o[0] + h * st.o[2];

  for (int t = 0; t < n_active; ++t) {
    const int r_base = lay.lut[col_off * lay.width + t] * lay.n;
    const uint32_t bits = lay.mask[col_off * lay.width + t];
    const uint32_t mine = rows_of_cols(bits, lay.G, my_g, my_g);
    const uint32_t block_rows = rows_of_cols(bits, lay.G, p.g_lo, p.g_hi);
    const int i_end = r_base + lay.n;
    // causal: rows before global row r0 (local r0 - q_off) see none of
    // this block's keys
    const int i_begin = causal ? max(r_base, p.r0 - q_off) : r_base;
    for (int i0 = i_begin; i0 < i_end; i0 += kSpTile) {
      const int g_lo = (i0 - r_base) / lay.blk;
      const int g_hi = (min(i0 + kSpTile, i_end) - 1 - r_base) / lay.blk;
      if (!(block_rows & span(g_lo, g_hi))) continue;  // uniform per block
      __syncthreads();  // every thread is done with the previous tile
      load_tile_pair<T, TPR, kEpt>(q_s, o_s, qbase, st.q[1], obase, st.o[1],
                                   i0, i_end, tid, THREADS);
      load_row_stats(lse_s, delta_s, lse, delta, (int64_t)bh * s, i0, i_end,
                     tid);
      if (tid < kSpTile) {
        const int i = i0 + tid;
        row_s[tid] = i < i_end ? (i - r_base) / lay.blk : lay.G;
      }
      __syncthreads();
      ds_flash::sparse_dkv_tile<T, TPR, kEpt>(
          q_s, o_s, lse_s, delta_s, part, kr, vr, dka, dva, scale,
          [&](int r) {
            return k_valid && ((mine >> row_s[r]) & 1u) &&
                   (!causal || q_off + i0 + r >= kj);
          });
    }
  }

  if (k_valid) {
    const int64_t off = b * st.grad[0] + (int64_t)kj * st.grad[1] +
                        h * st.grad[2] + part * kEpt;
#pragma unroll
    for (int e = 0; e < kEpt; ++e) {
      dk[off + e] = from_float<T>(dka[e] * scale);
      dv[off + e] = from_float<T>(dva[e]);
    }
  }
}

// ------------------------- B6a, B6b and B6c, bf16 and fp16 (mma)
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
using ds_flash::load_row_async;
using ds_flash::load_tile_async;
using ds_flash::mma16;
using ds_flash::MmaTile;
using ds_flash::OwnRows;
using ds_flash::pack16;

static_assert(kRows == kMmaTileRows, "a part is one 64-row mma tile");
constexpr float kLog2e = 1.4426950408889634f;
// rows of the streamed tile computed at once, as in B2a and B2b: 32 keep
// the score fragments at 32 registers a thread
constexpr int kMmaChunk = 32;
// Blocks an SM the bf16 kernels ask for at head_dim 64 (at 128 the
// accumulators alone take 128 registers a thread, so one), chosen by
// examples/profile_torch_b6.py's side-by-side times at the BERT shape
// (PERF.md): B6b at four (128 registers, 72 bytes spilled) ran 12%
// faster than at three (168, 8 bytes); B6c at three (168, 148 bytes)
// 12% faster than at two (251, none) and 24% faster than at four (860
// bytes spilled).
constexpr int kAggMinBlocks64Dq = 4;
constexpr int kAggMinBlocks64Dkv = 3;
// The same for the bf16 B6a at head_dim 64 (two at 128, as B1): at four
// (128 registers, 36 bytes spilled) it ran 9% faster than at three (168,
// 16 bytes) and 20% faster than at two (179, none).
constexpr int kAggMinBlocks64Fwd = 4;

// shared memory of either backward kernel: six padded tiles (the block's
// own two, two stages of the streamed two) and four rows of 64 fp32
// values (B6c: lse and Δ of the streamed rows, two stages each)
template <int D>
constexpr int agg_mma_smem_bytes() {
  return 6 * MmaTile<D>::kElems * static_cast<int>(sizeof(bf16)) +
         4 * kMmaTileRows * static_cast<int>(sizeof(float));
}

// shared memory of the bf16 B6a: the block's Q tile and two stages of K
// and of V
template <int D>
constexpr int agg_fwd_mma_smem_bytes() {
  return 5 * MmaTile<D>::kElems * static_cast<int>(sizeof(bf16));
}

// The (b·h, super-tile, part) a block of the bf16 backward owns.  Grid y
// is the block's rank in the launch order `order`, whose entries are
// units lh·ns·parts + tile·parts + part, the most tiles first; grid x
// runs over the copies of one layout head: every b·h for a shared
// layout, every batch row for one layout per head.  The card starts
// blocks in grid order, x fastest, so the longest blocks start first.
struct Owner {
  int bh, lh, tile, part;
  __device__ Owner(const SuperLayout& lay, const int* order, int heads) {
    const int per_head = lay.ns * lay.parts;
    const int unit = order[blockIdx.y];
    lh = unit / per_head;
    const int u = unit - lh * per_head;
    tile = u / lay.parts;
    part = u - tile * lay.parts;
    bh = lay.layout_heads == 1 ? static_cast<int>(blockIdx.x)
                               : static_cast<int>(blockIdx.x) * heads + lh;
  }
};

// One 64-wide tile of the other side of an active super-tile: rows (B6c)
// or keys (B6b) x0 .. x0+63 of the super-tile that starts at `ob` and
// ends before `x_lim`, its G·G mask bits, and whether every element of
// the block's 64 by the tile's 64 is visible.
struct OtherTile {
  int x0, ob, x_lim;
  uint32_t bits;
  bool full;
};

// The tiles a block visits, in order: its row of the super-tile table
// (kDq: the active super key columns of its super q-row; else the active
// super q-rows of its super key column), each super-tile cut into
// 64-wide tiles from its first row or key, and of those only the tiles
// that hold a visible element for the block's own 64.  The rule is
// exact, causal included, and build_launch_order counts the same tiles
// on the host.  Every thread of the block walks alike.
template <bool kDq>
struct TileWalk {
  const int* lut;   // the block's row of slut (stlut)
  const int* mask;  // and of smask (stmask)
  int n_active;
  const SuperLayout& lay;
  Part p;      // the block's own rows (keys), at their global place
  int causal;
  int x_shift;  // what takes the other side's rows to their global place
  int t = 0, j = 0;  // the next candidate: super-tile t, tile j

  // Whether the tile [x0, x_end) of the super-tile at `ob` holds an
  // element visible to the block, and whether all of them are.  Bit
  // rg·G + cg of `bits` is (query group rg, key group cg); the block's
  // own groups are p.g_lo .. p.g_hi, the tile's o_lo .. o_hi.
  __device__ __forceinline__ bool classify(uint32_t bits, int ob, int x0,
                                           int x_end, bool& full) const {
    const int G = lay.G;
    const int blk = lay.blk;
    const uint32_t want = span((x0 - ob) / blk, (x_end - 1 - ob) / blk);
    bool vis = false;
    full = p.r_end - p.r0 == kMmaTileRows && x_end - x0 == kMmaTileRows &&
           (!causal || (kDq ? p.r0 >= x_end - 1 : x0 >= p.r_end - 1));
    for (int a = p.g_lo; a <= p.g_hi; ++a) {
      // the other side's groups that own group a pairs with
      const uint32_t pairs = kDq ? (bits >> (a * G)) & ((1u << G) - 1u)
                                 : rows_of_cols(bits, G, a, a);
      uint32_t hit = pairs & want;
      full = full && hit == want;
      if (causal && hit) {
        if (kDq) {
          // a key of group cg is visible to the group's last row
          const int own_hi = min(p.r_end, p.base + (a + 1) * blk) - 1;
          hit = own_hi < x0 ? 0u
                            : hit & span(0, min(G - 1, (own_hi - ob) / blk));
        } else {
          // a row of group cg sees the group's first key
          const int own_lo = max(p.r0, p.base + a * blk);
          const int c_min = own_lo > ob ? min(G, (own_lo - ob) / blk) : 0;
          hit = x_end - 1 < own_lo ? 0u : hit & ~((1u << c_min) - 1u);
        }
      }
      vis = vis || hit != 0u;
    }
    return vis;
  }

  __device__ __forceinline__ bool next(OtherTile& o) {
    for (; t < n_active; ++t, j = 0) {
      const int ob = lut[t] * lay.n;
      const uint32_t bits = static_cast<uint32_t>(mask[t]);
      for (; j < lay.parts; ++j) {
        const int x0 = ob + j * kMmaTileRows;
        const int x_end = min(x0 + kMmaTileRows, ob + lay.n);
        bool full;
        if (classify(bits, ob + x_shift, x0 + x_shift, x_end + x_shift,
                     full)) {
          o = OtherTile{x0, ob, ob + lay.n, bits, full};
          ++j;
          return true;
        }
      }
    }
    return false;
  }
};

// B6a: one block per (b·h, 64-row part of a super q-row), 4 warps of 16
// rows, its unit from B6b's launch order (the two visit the same tiles).
// Q is the warps' A fragments; the visited 64-key K/V tiles stream in by
// cp.async two stages deep; per tile S = Q·Kᵀ on mma.sync, the online
// softmax on the C fragments in log2 units, P repacked C→A as T and
// O += P·V.  The per-tile body is B1's (flash_attention_fwd.cu) without
// dropout and with the super-tile mask: a copy, as for B6b.
template <typename T, int D>
__global__ void __launch_bounds__(kMmaThreads,
                                  D == 64 ? kAggMinBlocks64Fwd : 2)
    agg_fwd_mma_kernel(const T* __restrict__ q,
                       const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       float* __restrict__ lse, SuperLayout lay,
                       const int* __restrict__ order, int heads, int s,
                       Strides st, float scale, int causal, int q_off) {
  using Tile = MmaTile<D>;
  constexpr int KN = kMmaTileRows;  // keys per streamed tile
  constexpr float kLn2 = 0.6931471805599453f;
  extern __shared__ __align__(16) unsigned char agg_smem[];
  T* q_s = reinterpret_cast<T*>(agg_smem);
  T* k_s = q_s + Tile::kElems;      // two stages
  T* v_s = k_s + 2 * Tile::kElems;  // two stages

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wr = (tid >> 5) * 16;  // the warp's first row in the block
  const Owner own(lay, order, heads);
  const int bh = own.bh;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const Part p(lay, own.tile, own.part);
  const int64_t row_off = (int64_t)own.lh * lay.ns + own.tile;
  const int n_active = lay.cnt[row_off];
  TileWalk<true> walk{lay.lut + row_off * lay.width,
                      lay.mask + row_off * lay.width, n_active, lay,
                      p.shifted(q_off), causal, 0};

  const T* kbase = k + b * st.k[0] + h * st.k[2];
  const T* vbase = v + b * st.v[0] + h * st.v[2];
  auto issue = [&](const OtherTile& o, int stage) {
    load_tile_async<D>(k_s + stage * Tile::kElems, kbase, st.k[1], o.x0,
                       o.x_lim, tid);
    load_tile_async<D>(v_s + stage * Tile::kElems, vbase, st.v[1], o.x0,
                       o.x_lim, tid);
  };
  OtherTile cur, nxt;
  bool have = walk.next(cur);
  if (have) {
    load_tile_async<D>(q_s, q + b * st.q[0] + h * st.q[2], st.q[1], p.r0,
                       p.r_end, tid);
    issue(cur, 0);
  }
  cp_async_commit();

  // the thread's rows g and g+8: index and row group (-1 past the part)
  int row[2], grp[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    row[hh] = p.r0 + wr + g + 8 * hh;
    grp[hh] = row[hh] < p.r_end ? (row[hh] - p.base) / lay.blk : -1;
  }
  const float scale2 = scale * kLog2e;
  const uint32_t g_mask = (1u << lay.G) - 1u;
  // m in log2 units, floored at MAX_FLOOR; l the thread's part of the
  // row sum
  float m[2] = {kMaxFloor, kMaxFloor};
  float l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  uint32_t qa[D / 16][4];  // the warp's Q rows as A fragments

  for (int stage = 0, first = 1; have; stage ^= 1, first = 0) {
    const bool more = walk.next(nxt);
    if (more) issue(nxt, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and the first time Q) is in
    __syncthreads();
    if (first) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldsm_a<D>(qa[kk], q_s, wr, 16 * kk, lane);
    }
    const T* kt_s = k_s + stage * Tile::kElems;
    const T* vt_s = v_s + stage * Tile::kElems;

    // S = Q·Kᵀ over the tile's 64 keys; the thread's keys are
    // x0 + 8n + 2t + {0, 1}
    float sc[KN / 8][4];
#pragma unroll
    for (int n = 0; n < KN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nn = 0; nn < KN / 16; ++nn) {
        uint32_t bk[4];
        ldsm_b<D>(bk, kt_s, 16 * nn, 16 * kk, lane);
        mma16<T>(sc[2 * nn], qa[kk], bk[0], bk[1]);
        mma16<T>(sc[2 * nn + 1], qa[kk], bk[2], bk[3]);
      }
    }
    // a partial tile: each element's row group, column group, causal
    // and the super-tile's end, before the max and ex2, so a masked
    // element is P = 0 even in a row whose max stays at MAX_FLOOR
    if (!cur.full) {
      uint32_t sel[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        sel[hh] =
            grp[hh] < 0 ? 0u : (cur.bits >> (grp[hh] * lay.G)) & g_mask;
#pragma unroll
      for (int n = 0; n < KN / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hh = e >> 1;
          const int x = cur.x0 + 8 * n + 2 * t + (e & 1);
          const bool vis =
              x < cur.x_lim && ((sel[hh] >> ((x - cur.ob) / lay.blk)) & 1u) &&
              (!causal || q_off + row[hh] >= x);
          if (!vis) sc[n][e] = kNegInf;
        }
      }
    }

    // the rows' new running max, over the four lanes that share a row
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < KN / 8; ++n)
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
    // P, l and O += P·V, 16 keys at a time: l sums the fp32 P, the
    // product takes P rounded to T
#pragma unroll
    for (int kk = 0; kk < KN / 16; ++kk) {
#pragma unroll
      for (int n = 2 * kk; n < 2 * kk + 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pr = ex2_approx(fmaf(sc[n][e], scale2, -m[e >> 1]));
          l[e >> 1] += pr;
          sc[n][e] = pr;
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
    __syncthreads();  // every warp is done with this stage
    cur = nxt;
    have = more;
  }
  cp_async_wait<0>();

  // out = acc / l into the warp's own 16 rows of the Q tile (only this
  // warp read them), then 16-byte stores of the part's rows.  A row
  // that saw no pair has l = 0: out 0, and lse exactly MAX_FLOOR in a
  // super-row with an active super-tile, NEG_INF in one without.
  const float lse_empty = n_active > 0 ? kMaxFloor : kNegInf;
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
    if (t == 0 && grp[hh] >= 0)
      lse[(int64_t)bh * s + row[hh]] =
          l[hh] == 0.f ? lse_empty : m[hh] * kLn2 + logf(l[hh]);
  }
  __syncwarp();
  constexpr int CH = Tile::kChunks;
#pragma unroll
  for (int e = lane; e < 16 * CH; e += 32) {
    const int r = e / CH;
    const int ch = e - r * CH;
    const int i = p.r0 + wr + r;
    if (i < p.r_end)
      *reinterpret_cast<uint4*>(out + (((int64_t)b * s + i) * heads + h) * D +
                                8 * ch) =
          *reinterpret_cast<const uint4*>(q_s + (wr + r) * Tile::kRow +
                                          8 * ch);
  }
}

// B6b: one block per (b·h, 64-row part of a super q-row), 4 warps of 16
// rows.  Q and dO are the warps' A fragments; the visited 64-key K/V
// tiles stream in by cp.async two stages deep; per tile S = Q·Kᵀ and
// dP = dO·Vᵀ on mma.sync in 32-key chunks, dS = P∘(dP − Δ) on the C
// fragments, repacked C→A as T, and dq += dS·K.  The per-tile body is
// B2a's (flash_attention_bwd.cu) without dropout and with the
// super-tile mask: a copy, not a shared function, so that B2a's code is
// left as it was measured.
template <typename T, int D>
__global__ void __launch_bounds__(kMmaThreads, D == 64 ? kAggMinBlocks64Dq : 1)
    agg_bwd_dq_mma_kernel(const T* __restrict__ q,
                          const T* __restrict__ k,
                          const T* __restrict__ v,
                          const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          T* __restrict__ dq, SuperLayout lay,
                          const int* __restrict__ order, int heads, int s,
                          Strides st, float scale, int causal, int q_off) {
  using Tile = MmaTile<D>;
  constexpr int KC = kMmaChunk;
  extern __shared__ __align__(16) unsigned char agg_smem[];
  T* q_s = reinterpret_cast<T*>(agg_smem);
  T* o_s = q_s + Tile::kElems;
  T* k_s = o_s + Tile::kElems;      // two stages
  T* v_s = k_s + 2 * Tile::kElems;  // two stages

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wr = (tid >> 5) * 16;  // the warp's first row in the block
  const Owner own(lay, order, heads);
  const int bh = own.bh;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const Part p(lay, own.tile, own.part);
  const int64_t row_off = (int64_t)own.lh * lay.ns + own.tile;
  TileWalk<true> walk{lay.lut + row_off * lay.width,
                      lay.mask + row_off * lay.width, lay.cnt[row_off], lay,
                      p.shifted(q_off), causal, 0};

  const T* kbase = k + b * st.k[0] + h * st.k[2];
  const T* vbase = v + b * st.v[0] + h * st.v[2];
  auto issue = [&](const OtherTile& o, int stage) {
    load_tile_async<D>(k_s + stage * Tile::kElems, kbase, st.k[1], o.x0,
                       o.x_lim, tid);
    load_tile_async<D>(v_s + stage * Tile::kElems, vbase, st.v[1], o.x0,
                       o.x_lim, tid);
  };
  OtherTile cur, nxt;
  bool have = walk.next(cur);
  if (have) {
    load_tile_async<D>(q_s, q + b * st.q[0] + h * st.q[2], st.q[1], p.r0,
                       p.r_end, tid);
    load_tile_async<D>(o_s, dout + b * st.o[0] + h * st.o[2], st.o[1],
                       p.r0, p.r_end, tid);
    issue(cur, 0);
  }
  cp_async_commit();

  // the thread's rows g and g+8: index, row group (-1 past the part),
  // lse in log2 units and Δ
  int row[2], grp[2];
  float lse2[2], dlt[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = p.r0 + wr + g + 8 * hh;
    const bool ok = i < p.r_end;
    row[hh] = i;
    grp[hh] = ok ? (i - p.base) / lay.blk : -1;
    lse2[hh] = ok ? lse[(int64_t)bh * s + i] * kLog2e : 0.f;
    dlt[hh] = ok ? delta[(int64_t)bh * s + i] : 0.f;
  }
  const float scale2 = scale * kLog2e;
  const uint32_t g_mask = (1u << lay.G) - 1u;

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  OwnRows<D, T> qf, of;

  for (int stage = 0, first = 1; have; stage ^= 1, first = 0) {
    const bool more = walk.next(nxt);
    if (more) issue(nxt, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and the first time Q, dO) is in
    __syncthreads();
    if (first) {
      qf.init(q_s, wr, lane);
      of.init(o_s, wr, lane);
    }
    const T* kt_s = k_s + stage * Tile::kElems;
    const T* vt_s = v_s + stage * Tile::kElems;
    // the key groups each of the thread's rows sees in this super-tile
    uint32_t sel[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      sel[hh] = grp[hh] < 0 ? 0u : (cur.bits >> (grp[hh] * lay.G)) & g_mask;

#pragma unroll
    for (int c = 0; c < kMmaTileRows; c += KC) {
      float sc[KC / 8][4], dp[KC / 8][4];
#pragma unroll
      for (int n = 0; n < KC / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.f;
      // S = Q·Kᵀ and dP = dO·Vᵀ over the chunk's KC keys
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t aq[4], ao[4];
        qf.get(aq, kk);
        of.get(ao, kk);
#pragma unroll
        for (int nn = 0; nn < KC / 16; ++nn) {
          uint32_t bk[4], bv[4];
          ldsm_b<D>(bk, kt_s, c + 16 * nn, 16 * kk, lane);
          ldsm_b<D>(bv, vt_s, c + 16 * nn, 16 * kk, lane);
          mma16<T>(sc[2 * nn], aq, bk[0], bk[1]);
          mma16<T>(sc[2 * nn + 1], aq, bk[2], bk[3]);
          mma16<T>(dp[2 * nn], ao, bv[0], bv[1]);
          mma16<T>(dp[2 * nn + 1], ao, bv[2], bv[3]);
        }
      }
      // dS = P∘(dP − Δ) in place of S; the thread's keys are
      // x0 + c + 8n + 2t + {0, 1}.  The mask is tested before ex2, so a
      // masked element is 0 even in a row whose lse is MAX_FLOOR.
#pragma unroll
      for (int n = 0; n < KC / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hh = e >> 1;
          const int x = cur.x0 + c + 8 * n + 2 * t + (e & 1);
          const bool vis =
              cur.full ||
              (x < cur.x_lim && ((sel[hh] >> ((x - cur.ob) / lay.blk)) & 1u) &&
               (!causal || q_off + row[hh] >= x));
          const float pr =
              vis ? ex2_approx(fmaf(sc[n][e], scale2, -lse2[hh])) : 0.f;
          sc[n][e] = pr * (dp[n][e] - dlt[hh]);
        }
      }
      // dq += dS·K, dS as T A fragments straight from the C fragments
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {
        uint32_t a[4];
        c_to_a<T>(a, sc[2 * kk], sc[2 * kk + 1]);
#pragma unroll
        for (int nd = 0; nd < D / 16; ++nd) {
          uint32_t bk[4];
          ldsm_bt<D>(bk, kt_s, c + 16 * kk, 16 * nd, lane);
          mma16<T>(acc[2 * nd], a, bk[0], bk[1]);
          mma16<T>(acc[2 * nd + 1], a, bk[2], bk[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
    cur = nxt;
    have = more;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (grp[hh] >= 0) {
      T* o = dq + b * st.grad[0] + (int64_t)row[hh] * st.grad[1] +
                h * st.grad[2];
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(o + 8 * n + 2 * t) = pack16<T>(
            acc[n][2 * hh] * scale, acc[n][2 * hh + 1] * scale);
    }
  }
}

// B6c: one block per (b·h, 64-key part of a super key column), 4 warps
// of 16 keys, over the transposed tables.  K and V are the warps' A
// fragments; the visited 64-row Q/dO tiles stream in with their lse and
// Δ; per tile Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, so Pᵀ and dSᵀ are A operands as
// they stand: dv += Pᵀ·dO and dk += dSᵀ·Q.  The per-tile body is B2b's
// without dropout and with the super-tile mask (a copy, as for B6b).
template <typename T, int D>
__global__ void __launch_bounds__(kMmaThreads, D == 64 ? kAggMinBlocks64Dkv : 1)
    agg_bwd_dkv_mma_kernel(const T* __restrict__ q,
                           const T* __restrict__ k,
                           const T* __restrict__ v,
                           const T* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           T* __restrict__ dk, T* __restrict__ dv,
                           SuperLayout lay, const int* __restrict__ order,
                           int heads, int s, Strides st, float scale,
                           int causal, int q_off) {
  using Tile = MmaTile<D>;
  constexpr int KC = kMmaChunk;
  extern __shared__ __align__(16) unsigned char agg_smem[];
  T* k_s = reinterpret_cast<T*>(agg_smem);
  T* v_s = k_s + Tile::kElems;
  T* q_s = v_s + Tile::kElems;      // two stages
  T* o_s = q_s + 2 * Tile::kElems;  // two stages
  float* lse_s = reinterpret_cast<float*>(o_s + 2 * Tile::kElems);
  float* dlt_s = lse_s + 2 * kMmaTileRows;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wk = (tid >> 5) * 16;  // the warp's first key in the block
  const Owner own(lay, order, heads);
  const int bh = own.bh;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const Part p(lay, own.tile, own.part);
  const int64_t col_off = (int64_t)own.lh * lay.ns + own.tile;
  TileWalk<false> walk{lay.lut + col_off * lay.width,
                       lay.mask + col_off * lay.width, lay.cnt[col_off], lay,
                       p, causal, q_off};

  const T* qbase = q + b * st.q[0] + h * st.q[2];
  const T* obase = dout + b * st.o[0] + h * st.o[2];
  const float* lrow = lse + (int64_t)bh * s;
  const float* drow = delta + (int64_t)bh * s;
  auto issue = [&](const OtherTile& o, int stage) {
    load_tile_async<D>(q_s + stage * Tile::kElems, qbase, st.q[1], o.x0,
                       o.x_lim, tid);
    load_tile_async<D>(o_s + stage * Tile::kElems, obase, st.o[1], o.x0,
                       o.x_lim, tid);
    load_row_async(lse_s + stage * kMmaTileRows, lrow, o.x0, o.x_lim, tid);
    load_row_async(dlt_s + stage * kMmaTileRows, drow, o.x0, o.x_lim, tid);
  };
  OtherTile cur, nxt;
  bool have = walk.next(cur);
  if (have) {
    load_tile_async<D>(k_s, k + b * st.k[0] + h * st.k[2], st.k[1], p.r0,
                       p.r_end, tid);
    load_tile_async<D>(v_s, v + b * st.v[0] + h * st.v[2], st.v[1], p.r0,
                       p.r_end, tid);
    issue(cur, 0);
  }
  cp_async_commit();

  // the thread's keys g and g+8: index and key group (-1 past the part)
  int key[2], grp[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    key[hh] = p.r0 + wk + g + 8 * hh;
    grp[hh] = key[hh] < p.r_end ? (key[hh] - p.base) / lay.blk : -1;
  }
  const float scale2 = scale * kLog2e;

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  OwnRows<D, T> kf, vf;

  for (int stage = 0, first = 1; have; stage ^= 1, first = 0) {
    const bool more = walk.next(nxt);
    if (more) issue(nxt, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and the first time K, V) is in
    __syncthreads();
    if (first) {
      kf.init(k_s, wk, lane);
      vf.init(v_s, wk, lane);
    }
    const T* qt_s = q_s + stage * Tile::kElems;
    const T* ot_s = o_s + stage * Tile::kElems;
    const float* lt = lse_s + stage * kMmaTileRows;
    const float* dt = dlt_s + stage * kMmaTileRows;
    // the row groups that see each of the thread's keys in this
    // super-tile
    uint32_t sel[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      sel[hh] = grp[hh] < 0 ? 0u
                            : rows_of_cols(cur.bits, lay.G, grp[hh], grp[hh]);

#pragma unroll
    for (int c = 0; c < kMmaTileRows; c += KC) {
      float sc[KC / 8][4], dp[KC / 8][4];
#pragma unroll
      for (int n = 0; n < KC / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.f;
      // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ over the chunk's KC query rows
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ak[4], av[4];
        kf.get(ak, kk);
        vf.get(av, kk);
#pragma unroll
        for (int nn = 0; nn < KC / 16; ++nn) {
          uint32_t bq[4], bo[4];
          ldsm_b<D>(bq, qt_s, c + 16 * nn, 16 * kk, lane);
          ldsm_b<D>(bo, ot_s, c + 16 * nn, 16 * kk, lane);
          mma16<T>(sc[2 * nn], ak, bq[0], bq[1]);
          mma16<T>(sc[2 * nn + 1], ak, bq[2], bq[3]);
          mma16<T>(dp[2 * nn], av, bo[0], bo[1]);
          mma16<T>(dp[2 * nn + 1], av, bo[2], bo[3]);
        }
      }
      // Pᵀ in place of Sᵀ, dSᵀ in place of dPᵀ; the thread's rows are
      // x0 + c + 8n + 2t + {0, 1}.  The mask is tested before ex2.
#pragma unroll
      for (int n = 0; n < KC / 8; ++n) {
        const int rl = c + 8 * n + 2 * t;  // row in the tile
        const float2 l2 = *reinterpret_cast<const float2*>(lt + rl);
        const float2 d2 = *reinterpret_cast<const float2*>(dt + rl);
        const float nl[2] = {-l2.x * kLog2e, -l2.y * kLog2e};
        const float dl[2] = {d2.x, d2.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hh = e >> 1;
          const int col = e & 1;
          const int x = cur.x0 + rl + col;
          const bool vis =
              cur.full ||
              (x < cur.x_lim && ((sel[hh] >> ((x - cur.ob) / lay.blk)) & 1u) &&
               (!causal || q_off + x >= key[hh]));
          const float pr =
              vis ? ex2_approx(fmaf(sc[n][e], scale2, nl[col])) : 0.f;
          sc[n][e] = pr;
          dp[n][e] = pr * (dp[n][e] - dl[col]);
        }
      }
      // dv += Pᵀ·dO and dk += dSᵀ·Q
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {
        uint32_t ap[4], as[4];
        c_to_a<T>(ap, sc[2 * kk], sc[2 * kk + 1]);
        c_to_a<T>(as, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int nd = 0; nd < D / 16; ++nd) {
          uint32_t bo[4], bq[4];
          ldsm_bt<D>(bo, ot_s, c + 16 * kk, 16 * nd, lane);
          mma16<T>(dva[2 * nd], ap, bo[0], bo[1]);
          mma16<T>(dva[2 * nd + 1], ap, bo[2], bo[3]);
          ldsm_bt<D>(bq, qt_s, c + 16 * kk, 16 * nd, lane);
          mma16<T>(dka[2 * nd], as, bq[0], bq[1]);
          mma16<T>(dka[2 * nd + 1], as, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
    cur = nxt;
    have = more;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (grp[hh] >= 0) {
      const int64_t off = b * st.grad[0] + (int64_t)key[hh] * st.grad[1] +
                          h * st.grad[2] + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<uint32_t*>(dk + off + 8 * n) = pack16<T>(
            dka[n][2 * hh] * scale, dka[n][2 * hh + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + off + 8 * n) =
            pack16<T>(dva[n][2 * hh], dva[n][2 * hh + 1]);
      }
    }
  }
}

// ------------------------------------------------------------ launchers
enum Kind { kFwd = 0, kDq = 1, kDkv = 2 };

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *out, *lse_out, *grad, *dv;
  const int* order;  // the 16-bit kernels' launch order
  SuperLayout lay;
  int batch, heads, s;
  int own;  // the length the tables' super-rows cut: s, or kv_len (B6c)
  Strides st;
  float scale;
  int causal, q_off;
  cudaStream_t stream;
};

// The bf16 and fp16 B6a, B6b and B6c, on the tensor cores: grid x the
// copies of a layout head, grid y the rank in the launch order (B6a takes
// B6b's).
template <typename T, int D>
int launch_mma(Kind kind, const Args& a) {
  const SuperLayout& l = a.lay;
  const int units = l.layout_heads * l.ns * l.parts;
  if (a.order == nullptr || units > 65535 ||
      (l.layout_heads != 1 && l.layout_heads != a.heads))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(l.layout_heads == 1 ? a.batch * a.heads : a.batch, units);
  constexpr int bytes = agg_mma_smem_bytes<D>();
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  cudaError_t err;
  if (kind == kFwd) {
    constexpr int fwd_bytes = agg_fwd_mma_smem_bytes<D>();
    err = cudaFuncSetAttribute(agg_fwd_mma_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               fwd_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    agg_fwd_mma_kernel<T, D><<<grid, kMmaThreads, fwd_bytes, a.stream>>>(
        q, k, v, static_cast<T*>(a.out), static_cast<float*>(a.lse_out),
        l, a.order, a.heads, a.s, a.st, a.scale, a.causal, a.q_off);
  } else if (kind == kDq) {
    err = cudaFuncSetAttribute(agg_bwd_dq_mma_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    agg_bwd_dq_mma_kernel<T, D><<<grid, kMmaThreads, bytes, a.stream>>>(
        q, k, v, dout, lse, delta, static_cast<T*>(a.grad), l, a.order,
        a.heads, a.s, a.st, a.scale, a.causal, a.q_off);
  } else {
    err = cudaFuncSetAttribute(agg_bwd_dkv_mma_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    agg_bwd_dkv_mma_kernel<T, D><<<grid, kMmaThreads, bytes, a.stream>>>(
        q, k, v, dout, lse, delta, static_cast<T*>(a.grad),
        static_cast<T*>(a.dv), l, a.order, a.heads, a.s, a.st, a.scale,
        a.causal, a.q_off);
  }
  return static_cast<int>(cudaGetLastError());
}

// fp32 B6a, B6b and B6c: the scalar design, grid order
template <int D>
int launch_scalar(Kind kind, const Args& a) {
  const dim3 grid(a.lay.ns * a.lay.parts, a.batch * a.heads);
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  if (kind == kFwd) {
    agg_fwd_kernel<float, D><<<grid, 2 * kRows, 0, a.stream>>>(
        q, k, v, static_cast<float*>(a.out), static_cast<float*>(a.lse_out),
        a.lay, a.heads, a.s, a.st, a.scale, a.causal, a.q_off);
  } else if (kind == kDq) {
    agg_bwd_dq_kernel<float, D><<<grid, kRows * (D / kEpt), 0, a.stream>>>(
        q, k, v, static_cast<const float*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<float*>(a.grad), a.lay, a.heads, a.s, a.st, a.scale,
        a.causal, a.q_off);
  } else {
    agg_bwd_dkv_kernel<float, D><<<grid, kRows * (D / kEpt), 0, a.stream>>>(
        q, k, v, static_cast<const float*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<float*>(a.grad), static_cast<float*>(a.dv), a.lay,
        a.heads, a.s, a.st, a.scale, a.causal, a.q_off);
  }
  return static_cast<int>(cudaGetLastError());
}

int dispatch(Kind kind, int dtype, int head_dim, const Args& a) {
  const SuperLayout& l = a.lay;
  if (l.G < 1 || l.G * l.G > 32 || l.blk <= 0 || l.ns <= 0 ||
      l.ns * l.n != a.own || a.q_off < 0 || a.q_off % l.n != 0 ||
      a.batch * a.heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  // Built twice (op_builder): without DS_AGG_FP16 the fp32 and bf16
  // kernels, with it the fp16 ones, so the two builds of the tensor-core
  // templates run side by side; each library refuses the other's types.
#ifndef DS_AGG_FP16
  if (dtype == 0 && head_dim == 64) return launch_scalar<64>(kind, a);
  if (dtype == 0 && head_dim == 128) return launch_scalar<128>(kind, a);
  if (dtype == 1 && head_dim == 64) return launch_mma<bf16, 64>(kind, a);
  if (dtype == 1 && head_dim == 128) return launch_mma<bf16, 128>(kind, a);
#else
  if (dtype == 2 && head_dim == 64) return launch_mma<__half, 64>(kind, a);
  if (dtype == 2 && head_dim == 128) return launch_mma<__half, 128>(kind, a);
#endif
  return static_cast<int>(cudaErrorInvalidValue);
}

Args make_args(const void* q, const void* k, const void* v, const void* lut,
               const void* cnt, const void* mask, int batch, int heads,
               int s, int ns, int layout_heads, int G, int width,
               const int64_t* strides, int n_strides, float scale,
               int causal, int own, int q_off, void* stream) {
  Args a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  SuperLayout& l = a.lay;
  l.lut = static_cast<const int*>(lut);
  l.cnt = static_cast<const int*>(cnt);
  l.mask = static_cast<const int*>(mask);
  l.layout_heads = layout_heads;
  l.ns = ns;
  l.G = G;
  l.blk = (ns > 0 && G > 0) ? own / (ns * G) : 0;
  l.width = width;
  l.n = G * l.blk;
  l.parts = (l.n + kRows - 1) / kRows;
  a.batch = batch;
  a.heads = heads;
  a.s = s;
  a.own = own;
  int64_t* dst[5] = {a.st.q, a.st.k, a.st.v, a.st.o, a.st.grad};
  for (int t = 0; t < n_strides / 3; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  a.scale = scale;
  a.causal = causal;
  a.q_off = q_off;
  a.stream = static_cast<cudaStream_t>(stream);
  return a;
}

}  // namespace

// B6a.  dtype: 0 = float32, 1 = bfloat16, 2 = float16.  q, k, v are
// [b, s, h, d] of that dtype with the last dim contiguous; `strides` points to 9 host
// int64 element strides: (batch, seq, head) of q, k and v.  out is a
// contiguous [b, s, h, d] of the input dtype and lse a contiguous fp32
// [b·h, s].  slut, scnt, smask are build_super_luts' [H, ns, tmax],
// [H, ns] and [H, ns, tmax] int32 tables in device memory; H =
// layout_heads is 1 or `heads`; s = ns·G·blk.  `order` is B6b's int32
// launch order in device memory (build_launch_order's dq order); the
// 16-bit kernels read it, the fp32 one launches in grid order.  16-bit rows
// must be 16-byte aligned with strides that are multiples of 8 elements
// (the wrapper checks).  A sequence-parallel rank's chunk passes its
// rows' tables (s = its rows, ns its super q-rows) against its gathered
// keys (k and v [b, kv_len, h, d], kv_len the tables' key columns) and
// its first global row q_off (a multiple of G·blk), which the causal
// tests count; a whole call passes q_off = 0.  Launches on `stream`, does not
// synchronise, allocates nothing, and returns cudaGetLastError().
extern "C" int ds_fbs_agg_fwd(int dtype, int head_dim, const void* q,
                              const void* k, const void* v, void* out,
                              void* lse, const void* slut, const void* scnt,
                              const void* smask, const void* order,
                              int batch, int heads, int s, int ns,
                              int layout_heads, int G, int tmax,
                              const int64_t* strides, float scale, int causal,
                              int q_off, void* stream) {
  Args a = make_args(q, k, v, slut, scnt, smask, batch, heads, s, ns,
                     layout_heads, G, tmax, strides, 9, scale, causal, s,
                     q_off, stream);
  a.order = static_cast<const int*>(order);
  a.out = out;
  a.lse_out = lse;
  return dispatch(kFwd, dtype, head_dim, a);
}

// B6b: dq [b, s, h, d] (last dim contiguous) from dout [b, s, h, d], lse
// and delta (contiguous fp32 [b·h, s]) over slut/scnt/smask; `strides`
// is 15 host int64 element strides: (batch, seq, head) of q, k, v, dout
// and dq.  `order` is the int32 launch order in device memory
// (build_launch_order: the H·ns·parts units, the most tiles first); the
// 16-bit kernels read it, the fp32 one launches in grid order.  16-bit rows
// must be 16-byte aligned with strides that are multiples of 8 elements
// (the wrapper checks).  Otherwise as ds_fbs_agg_fwd.
extern "C" int ds_fbs_agg_bwd_dq(int dtype, int head_dim, const void* q,
                                 const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq,
                                 const void* slut, const void* scnt,
                                 const void* smask, const void* order,
                                 int batch, int heads, int s, int ns,
                                 int layout_heads, int G, int tmax,
                                 const int64_t* strides, float scale,
                                 int causal, int q_off, void* stream) {
  Args a = make_args(q, k, v, slut, scnt, smask, batch, heads, s, ns,
                     layout_heads, G, tmax, strides, 15, scale, causal, s,
                     q_off, stream);
  a.order = static_cast<const int*>(order);
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.grad = dq;
  return dispatch(kDq, dtype, head_dim, a);
}

// B6c: dk and dv [b, kv_len, h, d] (sharing the strides given as the
// fifth triple; a chunk's partials; kv_len the keys the transposed
// tables' ns super key columns cut) over the transposed tables
// stlut/stcnt/stmask ([H, ns, qmax], [H, ns], [H, ns, qmax], ns the super
// key columns of kv_len) and their own launch order.  Otherwise as
// ds_fbs_agg_bwd_dq.
extern "C" int ds_fbs_agg_bwd_dkv(int dtype, int head_dim, const void* q,
                                  const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv,
                                  const void* stlut, const void* stcnt,
                                  const void* stmask, const void* order,
                                  int batch, int heads, int s, int ns,
                                  int layout_heads, int G, int qmax,
                                  const int64_t* strides, float scale,
                                  int causal, int kv_len, int q_off,
                                  void* stream) {
  Args a = make_args(q, k, v, stlut, stcnt, stmask, batch, heads, s, ns,
                     layout_heads, G, qmax, strides, 15, scale, causal,
                     kv_len, q_off, stream);
  a.order = static_cast<const int*>(order);
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.grad = dk;
  a.dv = dv;
  return dispatch(kDkv, dtype, head_dim, a);
}
