// Block-sparse flash attention over G×G super-tiles for NVIDIA Hopper
// (built for sm_90a): forward, dq and dk/dv kernels.
//
// Replaces, in deepspeed_tpu/ops/sparse_attention/flash_block_sparse.py:
//   B6a `_fwd_kernel_agg`     (:333, launched at :598) -> agg_fwd_kernel
//   B6b `_bwd_dq_kernel_agg`  (:373, launched at :650) -> agg_bwd_dq_kernel
//   B6c `_bwd_dkv_kernel_agg` (:402, launched at :682) -> agg_bwd_dkv_kernel
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
// Out and dq of such rows are exactly 0.
//
// Design.  The TPU kernels run one (b·h, super-row) per grid row and
// stream its active super-tiles on a sequential grid axis, because the
// MXU wants 512-wide tiles.  On Hopper the reason for super-tiles is the
// block's rows: a layout block under 64 rows fills only part of a B5
// block (flash_block_sparse.cu), and a super-row of several layout
// blocks fills it.  So:
// - B6a and B6b: one block per (b·h, super q-row, or a 64-row part of
//   one).  It reads scnt/slut/smask[lh, sq] itself and walks the active
//   super key columns in 32-key tiles.
// - B6c: one block per (b·h, super key column, or a 64-key part of
//   one), over the transposed tables stlut/stmask, in 32-row Q/dO tiles.
// Each block owns its output rows, so no atomic touches a value and two
// runs are bitwise equal.  A block skips a 32-wide tile whose mask bits
// are all zero for its own rows (or keys): exact, since masked scores
// never raise the floored max and add exp(NEG_INF − m) = 0.  That is
// where the Hopper kernels do less work than the TPU's, which compute
// every element of an active super-tile: at the BERT train layout (Fixed
// bidirectional, blk 128, G = 4, s = 4096) every super-tile is active and
// they cover 2.9× the layout's pairs, while at blk 128 a 64-row part and
// a 32-key tile each lie inside one layout block, so the skip leaves
// exactly the layout's pairs.  Inside a tile the arithmetic is B5's, from
// the shared steps in ../transformer/flash_common.cuh.
//
// Bound.  At the BERT sparse training attention (b=2, h=16, s=4096,
// d=64, bf16, the layout above: 5.77e6 visible pairs a head) q, k, v and
// out are 67 MB (20 µs at 3.35 TB/s), against 1.85e8 pairs · 4·d flops =
// 47 GFLOP (48 µs at 989 TFLOP/s): bound by operations.  B6b does 6·d
// and B6c 8·d per pair.  The kernels spend them as scalar fp32 FMAs on
// the CUDA cores, with plain loads and no copy/compute overlap, like B5;
// tensor cores and TMA are the work of a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "transformer/flash_common.cuh"

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
};

// ----------------------------------------------------------------- B6a
template <typename T, int D>
__global__ void __launch_bounds__(2 * kRows)
    agg_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ out,
                   float* __restrict__ lse, SuperLayout lay, int heads, int s,
                   Strides st, float scale, int causal) {
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
    // causal: rows r0 .. r_end-1 see no key past r_end-1
    const int k_end = causal ? min(key_lim, p.r_end) : key_lim;
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
            return ((mine >> col_s[j]) & 1u) && (!causal || qi >= k0 + j);
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
                      float scale, int causal) {
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
    const int k_end = causal ? min(key_lim, p.r_end) : key_lim;
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
            return ((mine >> col_s[j]) & 1u) && (!causal || qi >= k0 + j);
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
                       Strides st, float scale, int causal) {
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
    // causal: rows before r0 see none of this block's keys
    const int i_begin = causal ? max(r_base, p.r0) : r_base;
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
                   (!causal || i0 + r >= kj);
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

// ------------------------------------------------------------ launchers
enum Kind { kFwd = 0, kDq = 1, kDkv = 2 };

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *out, *lse_out, *grad, *dv;
  SuperLayout lay;
  int batch, heads, s;
  Strides st;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename T, int D>
int launch(Kind kind, const Args& a) {
  const dim3 grid(a.lay.ns * a.lay.parts, a.batch * a.heads);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  if (kind == kFwd) {
    agg_fwd_kernel<T, D><<<grid, 2 * kRows, 0, a.stream>>>(
        q, k, v, static_cast<T*>(a.out), static_cast<float*>(a.lse_out),
        a.lay, a.heads, a.s, a.st, a.scale, a.causal);
  } else if (kind == kDq) {
    agg_bwd_dq_kernel<T, D><<<grid, kRows * (D / kEpt), 0, a.stream>>>(
        q, k, v, static_cast<const T*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<T*>(a.grad), a.lay, a.heads, a.s, a.st, a.scale,
        a.causal);
  } else {
    agg_bwd_dkv_kernel<T, D><<<grid, kRows * (D / kEpt), 0, a.stream>>>(
        q, k, v, static_cast<const T*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<T*>(a.grad), static_cast<T*>(a.dv), a.lay, a.heads, a.s,
        a.st, a.scale, a.causal);
  }
  return static_cast<int>(cudaGetLastError());
}

int dispatch(Kind kind, int dtype, int head_dim, const Args& a) {
  const SuperLayout& l = a.lay;
  if (l.G < 1 || l.G * l.G > 32 || l.blk <= 0 || l.ns <= 0 ||
      l.ns * l.n != a.s || a.batch * a.heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0 && head_dim == 64) return launch<float, 64>(kind, a);
  if (dtype == 0 && head_dim == 128) return launch<float, 128>(kind, a);
  if (dtype == 1 && head_dim == 64) return launch<__nv_bfloat16, 64>(kind, a);
  if (dtype == 1 && head_dim == 128)
    return launch<__nv_bfloat16, 128>(kind, a);
  return static_cast<int>(cudaErrorInvalidValue);
}

Args make_args(const void* q, const void* k, const void* v, const void* lut,
               const void* cnt, const void* mask, int batch, int heads,
               int s, int ns, int layout_heads, int G, int width,
               const int64_t* strides, int n_strides, float scale,
               int causal, void* stream) {
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
  l.blk = (ns > 0 && G > 0) ? s / (ns * G) : 0;
  l.width = width;
  l.n = G * l.blk;
  l.parts = (l.n + kRows - 1) / kRows;
  a.batch = batch;
  a.heads = heads;
  a.s = s;
  int64_t* dst[5] = {a.st.q, a.st.k, a.st.v, a.st.o, a.st.grad};
  for (int t = 0; t < n_strides / 3; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  a.scale = scale;
  a.causal = causal;
  a.stream = static_cast<cudaStream_t>(stream);
  return a;
}

}  // namespace

// B6a.  dtype: 0 = float32, 1 = bfloat16.  q, k, v are [b, s, h, d] of
// that dtype with the last dim contiguous; `strides` points to 9 host
// int64 element strides: (batch, seq, head) of q, k and v.  out is a
// contiguous [b, s, h, d] of the input dtype and lse a contiguous fp32
// [b·h, s].  slut, scnt, smask are build_super_luts' [H, ns, tmax],
// [H, ns] and [H, ns, tmax] int32 tables in device memory; H =
// layout_heads is 1 or `heads`; s = ns·G·blk.  Launches on `stream`, does
// not synchronise, allocates nothing, and returns cudaGetLastError().
extern "C" int ds_fbs_agg_fwd(int dtype, int head_dim, const void* q,
                              const void* k, const void* v, void* out,
                              void* lse, const void* slut, const void* scnt,
                              const void* smask, int batch, int heads, int s,
                              int ns, int layout_heads, int G, int tmax,
                              const int64_t* strides, float scale, int causal,
                              void* stream) {
  Args a = make_args(q, k, v, slut, scnt, smask, batch, heads, s, ns,
                     layout_heads, G, tmax, strides, 9, scale, causal,
                     stream);
  a.out = out;
  a.lse_out = lse;
  return dispatch(kFwd, dtype, head_dim, a);
}

// B6b: dq [b, s, h, d] (last dim contiguous) from dout [b, s, h, d], lse
// and delta (contiguous fp32 [b·h, s]) over slut/scnt/smask; `strides`
// is 15 host int64 element strides: (batch, seq, head) of q, k, v, dout
// and dq.  Otherwise as ds_fbs_agg_fwd.
extern "C" int ds_fbs_agg_bwd_dq(int dtype, int head_dim, const void* q,
                                 const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq,
                                 const void* slut, const void* scnt,
                                 const void* smask, int batch, int heads,
                                 int s, int ns, int layout_heads, int G,
                                 int tmax, const int64_t* strides,
                                 float scale, int causal, void* stream) {
  Args a = make_args(q, k, v, slut, scnt, smask, batch, heads, s, ns,
                     layout_heads, G, tmax, strides, 15, scale, causal,
                     stream);
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.grad = dq;
  return dispatch(kDq, dtype, head_dim, a);
}

// B6c: dk and dv [b, s, h, d] (sharing the strides given as the fifth
// triple) over the transposed tables stlut/stcnt/stmask ([H, ns, qmax],
// [H, ns], [H, ns, qmax]).  Otherwise as ds_fbs_agg_bwd_dq.
extern "C" int ds_fbs_agg_bwd_dkv(int dtype, int head_dim, const void* q,
                                  const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv,
                                  const void* stlut, const void* stcnt,
                                  const void* stmask, int batch, int heads,
                                  int s, int ns, int layout_heads, int G,
                                  int qmax, const int64_t* strides,
                                  float scale, int causal, void* stream) {
  Args a = make_args(q, k, v, stlut, stcnt, stmask, batch, heads, s, ns,
                     layout_heads, G, qmax, strides, 15, scale, causal,
                     stream);
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.grad = dk;
  a.dv = dv;
  return dispatch(kDkv, dtype, head_dim, a);
}
