// Block-sparse flash attention for NVIDIA Hopper (built for sm_90a): the
// fp32 forward, and the fp32 backward as two kernels.
//
// Replaces, in deepspeed_tpu/ops/sparse_attention/flash_block_sparse.py:
//   B5a `_fwd_kernel`       (:213, launched at :478) -> fp32:
//       fbs_fwd_kernel; bf16: the tensor-core agg_fwd_mma_kernel of
//       flash_block_sparse_agg.cu at G = 1
//   B5b `_bwd_fused_kernel` (:253, launched at :538) -> fp32:
//       fbs_bwd_dq_kernel + fbs_bwd_dkv_kernel; bf16: the tensor-core
//       agg_bwd_dq_mma_kernel + agg_bwd_dkv_mma_kernel of
//       flash_block_sparse_agg.cu at G = 1
// (the wrappers launch the bf16 kernels; both C entries here refuse
// bf16)
// They compute what those kernels compute, over the ACTIVE [blk, blk]
// tiles of a [H, nb, nb] block layout (H is 1, shared, or the head count):
// scaled Q·Kᵀ, an optional causal mask inside tiles (masked scores are
// NEG_INF), an online softmax with fp32 running max, sum and accumulator,
// the running max floored at MAX_FLOOR so that a tile the causal mask
// empties adds exp(NEG_INF − m) = 0 and never NaN, l == 0 dividing by 1,
// P cast to the storage type before P·V, out in the storage type plus an
// fp32 logsumexp.  A query block with no active key block gives out = 0
// and lse = NEG_INF, and zero dq.  Backward: P = exp(S − lse), dP = dO·Vᵀ,
// dS = P∘(dP − Δ) cast to the storage type before dS·K and dSᵀ·Q, dv =
// Pᵀ·dO with P in the storage type, 1/√d folded into dq and dk at the end.
// Δ = rowsum(dO∘O) comes in precomputed, as the JAX package computes it
// outside Pallas (:531-532).  No dropout and no key mask, as on the TPU.
//
// Why the bf16 kernels live in the super-tile source: at G = 1 a
// super-tile is one layout block with one mask bit, and the super-tile
// lse rule is this one (MAX_FLOOR for a row of a block row with an active
// block, NEG_INF for one without), so the B6 kernels compute B5's
// function: the same visible pairs, rounding points and 1/√d folding.
// They also carry the launch order B5's unequal blocks need (a causal
// block row of the sparse GPT-2 layout walks 1 to 28 64-key tiles, a
// global key column 12 query blocks, the others 4).
//
// Design.  The TPU kernels walk one flattened list of (q block, k block)
// jobs per head on a sequential grid axis, open and close the softmax
// state on flag bits, and (backward) keep full-sequence fp32 dk and dv in
// VMEM: 2·s·d·4 bytes, which no Hopper block can hold.  Here blocks run
// in parallel and each owns its output rows, so nothing is shared and no
// atomic touches a value (two runs are bitwise equal):
// - B5a and the dq kernel: one block per (b·h, q layout block, or a
//   64-row part of one).  It reads cnt[lh, qb] and lut[lh, qb, :cnt]
//   (build_block_luts) itself and loops over its row's active key blocks,
//   each cut into 32-key tiles; under `causal` it stops a key block at
//   its own last row.
// - the dk/dv kernel: one block per (b·h, key layout block, or a 64-key
//   part of one), walking tlut[lh, kb, :tcnt], the transposed look-up
//   table, in 32-row Q/dO tiles.
// The layout head is lh = 0 for a shared layout, else the head index.
// Inside a tile the arithmetic is that of the dense kernels: the threads
// that share a row each hold a slice of head_dim in registers and close
// every dot product with warp shuffles; its steps are shared with the
// super-tile kernels B6 (flash_block_sparse_agg.cu) through
// ../transformer/flash_common.cuh.  Layout blocks of any size run; one
// under 64 rows leaves the rest of the block's threads idle (B6 fills
// them with a super-row of several layout blocks).
//
// Bound.  At the sparse training shape (b=2, h=16, s=4096, d=64, bf16,
// Fixed unidirectional layout of 256-row blocks: 3.7e6 visible pairs a
// head, 0.44 of the causal triangle) q, k, v and out are 67 MB: 20 µs at
// 3.35 TB/s, against 1.2e8 pairs · 4·d flops = 30 GFLOP: 30 µs at 989
// TFLOP/s.  The backward moves 118 MB (35 µs) and does 10·d per pair
// (76 µs).  So both are bound by operations.
//
// What this simple design leaves on the table: every multiply-add is an
// fp32 FMA on the CUDA cores (67 TFLOP/s peak), tiles come in by plain
// loads with no copy/compute overlap, and the backward recomputes S and
// dP in both of its kernels.  These kernels serve the fp32 parity checks
// (TF32 would miss their 2e-5 / 5e-4); bf16 runs on the tensor cores.

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

// element strides (batch, seq, head) of every tensor the kernels touch;
// the last dimension is contiguous
struct Strides {
  int64_t q[3], k[3], v[3], o[3], dq[3], dkv[3];
};

// the layout and its look-up tables (int32, device memory)
struct Layout {
  const int* lut;   // [H, nb, kmax] active key blocks of a q block
  const int* cnt;   // [H, nb]
  const int* tlut;  // [H, nbk, qmax] q blocks that attend a key block
  const int* tcnt;  // [H, nbk]
  int layout_heads, nb, blk, kmax, qmax;
  int nbk;    // key blocks (nb for a whole call; a chunk's rows see all)
  int parts;  // 64-row parts of one layout block
};

// ------------------------------------------------------------------ B5a
template <typename T, int D>
__global__ void __launch_bounds__(2 * kRows)
    fbs_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ out,
                   float* __restrict__ lse, Layout lay, int heads, int s,
                   Strides st, float scale, int causal, int q_off) {
  constexpr int TPR = 2;          // threads per query row
  constexpr int SEG = D / TPR;    // head_dim elements each thread owns
  constexpr int THREADS = TPR * kRows;
  __shared__ __align__(16) float k_s[SpTile<TPR, SEG>::kFloats];
  __shared__ __align__(16) float v_s[SpTile<TPR, SEG>::kFloats];

  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int seg = tid % TPR;
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int lh = lay.layout_heads == 1 ? 0 : h;
  const int qb = blockIdx.x / lay.parts;
  const int q0 = qb * lay.blk + (blockIdx.x - qb * lay.parts) * kRows;
  const int q_end = min(q0 + kRows, (qb + 1) * lay.blk);
  const int qi = q0 + row;
  const bool q_valid = qi < q_end;

  float qr[SEG], acc[SEG];
  load_seg(qr, q + b * st.q[0] + (int64_t)(q_valid ? qi : 0) * st.q[1] +
                   h * st.q[2] + seg * SEG,
           q_valid);
#pragma unroll
  for (int d = 0; d < SEG; ++d) acc[d] = 0.f;
  const int n_active = lay.cnt[lh * lay.nb + qb];
  const int* row_lut = lay.lut + ((int64_t)lh * lay.nb + qb) * lay.kmax;
  // a row with an active tile has its max floored (also when the causal
  // mask empties every tile); a row with none keeps NEG_INF
  float m = n_active > 0 ? kMaxFloor : kNegInf;
  float l = 0.f;

  const T* kbase = k + b * st.k[0] + h * st.k[2];
  const T* vbase = v + b * st.v[0] + h * st.v[2];

  for (int t = 0; t < n_active; ++t) {
    const int kb0 = row_lut[t] * lay.blk;
    const int key_lim = kb0 + lay.blk;
    // causal: rows q0 .. q_end-1 (global q_off + q0 ..) see no key past
    // q_off+q_end-1
    const int k_end = causal ? min(key_lim, q_off + q_end) : key_lim;
    for (int k0 = kb0; k0 < k_end; k0 += kSpTile) {
      __syncthreads();  // every thread is done with the previous tile
      load_tile_pair<T, TPR, SEG>(k_s, v_s, kbase, st.k[1], vbase, st.v[1],
                                  k0, key_lim, tid, THREADS);
      __syncthreads();
      // keys past the layout block's end belong to another tile
      ds_flash::sparse_fwd_tile<T, TPR, SEG>(
          k_s, v_s, seg, qr, acc, m, l, scale, [&](int j) {
            return k0 + j < key_lim && (!causal || q_off + qi >= k0 + j);
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

// ---------------------------------------------------------------- B5b: dq
template <typename T, int D>
__global__ void __launch_bounds__(kRows * (D / kEpt))
    fbs_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dq,
                      Layout lay, int heads, int s, Strides st, float scale,
                      int causal, int q_off) {
  constexpr int TPR = D / kEpt;  // threads per query row
  constexpr int THREADS = kRows * TPR;
  __shared__ __align__(16) float k_s[SpTile<TPR, kEpt>::kFloats];
  __shared__ __align__(16) float v_s[SpTile<TPR, kEpt>::kFloats];

  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int part = tid % TPR;
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int lh = lay.layout_heads == 1 ? 0 : h;
  const int qb = blockIdx.x / lay.parts;
  const int q0 = qb * lay.blk + (blockIdx.x - qb * lay.parts) * kRows;
  const int q_end = min(q0 + kRows, (qb + 1) * lay.blk);
  const int qi = q0 + row;
  const bool q_valid = qi < q_end;
  const int qr_i = q_valid ? qi : 0;

  float qr[kEpt], dor[kEpt], acc[kEpt];
  load_seg(qr, q + b * st.q[0] + qr_i * st.q[1] + h * st.q[2] + part * kEpt,
           q_valid);
  load_seg(dor,
           dout + b * st.o[0] + qr_i * st.o[1] + h * st.o[2] + part * kEpt,
           q_valid);
#pragma unroll
  for (int e = 0; e < kEpt; ++e) acc[e] = 0.f;
  const float lse_i = q_valid ? lse[(int64_t)bh * s + qi] : 0.f;
  const float delta_i = q_valid ? delta[(int64_t)bh * s + qi] : 0.f;

  const int n_active = lay.cnt[lh * lay.nb + qb];
  const int* row_lut = lay.lut + ((int64_t)lh * lay.nb + qb) * lay.kmax;
  const T* kbase = k + b * st.k[0] + h * st.k[2];
  const T* vbase = v + b * st.v[0] + h * st.v[2];

  for (int t = 0; t < n_active; ++t) {
    const int kb0 = row_lut[t] * lay.blk;
    const int key_lim = kb0 + lay.blk;
    const int k_end = causal ? min(key_lim, q_off + q_end) : key_lim;
    for (int k0 = kb0; k0 < k_end; k0 += kSpTile) {
      __syncthreads();  // every thread is done with the previous tile
      load_tile_pair<T, TPR, kEpt>(k_s, v_s, kbase, st.k[1], vbase,
                                   st.v[1], k0, key_lim, tid, THREADS);
      __syncthreads();
      ds_flash::sparse_dq_tile<T, TPR, kEpt>(
          k_s, v_s, part, qr, dor, acc, lse_i, delta_i, scale, [&](int j) {
            return k0 + j < key_lim && (!causal || q_off + qi >= k0 + j);
          });
    }
  }

  if (q_valid) {
    T* o = dq + b * st.dq[0] + qi * st.dq[1] + h * st.dq[2] + part * kEpt;
#pragma unroll
    for (int e = 0; e < kEpt; ++e) o[e] = from_float<T>(acc[e] * scale);
  }
}

// ------------------------------------------------------------ B5b: dk, dv
template <typename T, int D>
__global__ void __launch_bounds__(kRows * (D / kEpt))
    fbs_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, T* __restrict__ dk,
                       T* __restrict__ dv, Layout lay, int heads, int s,
                       Strides st, float scale, int causal, int q_off) {
  constexpr int TPR = D / kEpt;  // threads per key
  constexpr int THREADS = kRows * TPR;
  __shared__ __align__(16) float q_s[SpTile<TPR, kEpt>::kFloats];
  __shared__ __align__(16) float o_s[SpTile<TPR, kEpt>::kFloats];
  __shared__ float lse_s[kSpTile];
  __shared__ float delta_s[kSpTile];

  const int tid = threadIdx.x;
  const int key = tid / TPR;
  const int part = tid % TPR;
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int lh = lay.layout_heads == 1 ? 0 : h;
  const int kb = blockIdx.x / lay.parts;
  const int k0 = kb * lay.blk + (blockIdx.x - kb * lay.parts) * kRows;
  const int k_end = min(k0 + kRows, (kb + 1) * lay.blk);
  const int kj = k0 + key;
  const bool k_valid = kj < k_end;
  const int kj_i = k_valid ? kj : 0;

  float kr[kEpt], vr[kEpt], dka[kEpt], dva[kEpt];
  load_seg(kr, k + b * st.k[0] + kj_i * st.k[1] + h * st.k[2] + part * kEpt,
           k_valid);
  load_seg(vr, v + b * st.v[0] + kj_i * st.v[1] + h * st.v[2] + part * kEpt,
           k_valid);
#pragma unroll
  for (int e = 0; e < kEpt; ++e) dka[e] = dva[e] = 0.f;

  const int n_active = lay.tcnt[lh * lay.nbk + kb];
  const int* col_lut = lay.tlut + ((int64_t)lh * lay.nbk + kb) * lay.qmax;
  const T* qbase = q + b * st.q[0] + h * st.q[2];
  const T* obase = dout + b * st.o[0] + h * st.o[2];

  for (int t = 0; t < n_active; ++t) {
    const int qb0 = col_lut[t] * lay.blk;
    const int i_end = qb0 + lay.blk;
    // causal: rows before global row k0 (local k0 - q_off) see none of
    // this block's keys
    const int i_begin = causal ? max(qb0, k0 - q_off) : qb0;
    for (int i0 = i_begin; i0 < i_end; i0 += kSpTile) {
      __syncthreads();  // every thread is done with the previous tile
      load_tile_pair<T, TPR, kEpt>(q_s, o_s, qbase, st.q[1], obase, st.o[1],
                                   i0, i_end, tid, THREADS);
      load_row_stats(lse_s, delta_s, lse, delta, (int64_t)bh * s, i0, i_end,
                     tid);
      __syncthreads();
      ds_flash::sparse_dkv_tile<T, TPR, kEpt>(
          q_s, o_s, lse_s, delta_s, part, kr, vr, dka, dva, scale,
          [&](int r) {
            const int i = i0 + r;
            return k_valid && i < i_end && (!causal || q_off + i >= kj);
          });
    }
  }

  if (k_valid) {
    const int64_t off =
        b * st.dkv[0] + kj * st.dkv[1] + h * st.dkv[2] + part * kEpt;
#pragma unroll
    for (int e = 0; e < kEpt; ++e) {
      dk[off + e] = from_float<T>(dka[e] * scale);
      dv[off + e] = from_float<T>(dva[e]);
    }
  }
}

// ------------------------------------------------------------ launchers
struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *out, *lse_out, *dq, *dk, *dv;
  Layout lay;
  int batch, heads, s;
  Strides st;
  float scale;
  int causal, q_off;
  cudaStream_t stream;
};

template <typename T, int D>
int launch_fwd(const Args& a) {
  const dim3 grid(a.lay.nb * a.lay.parts, a.batch * a.heads);
  fbs_fwd_kernel<T, D><<<grid, 2 * kRows, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.out),
      static_cast<float*>(a.lse_out), a.lay, a.heads, a.s, a.st, a.scale,
      a.causal, a.q_off);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_bwd(const Args& a) {
  const dim3 grid(a.lay.nb * a.lay.parts, a.batch * a.heads);
  const int threads = kRows * (D / kEpt);
  fbs_bwd_dq_kernel<T, D><<<grid, threads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.dq), a.lay, a.heads, a.s, a.st, a.scale, a.causal,
      a.q_off);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const dim3 kv_grid(a.lay.nbk * a.lay.parts, a.batch * a.heads);
  fbs_bwd_dkv_kernel<T, D><<<kv_grid, threads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.lay, a.heads, a.s,
      a.st, a.scale, a.causal, a.q_off);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch(bool backward, const Args& a) {
  return backward ? launch_bwd<T, D>(a) : launch_fwd<T, D>(a);
}

// fp32 only: the bf16 B5a and B5b run on the tensor-core kernels of
// flash_block_sparse_agg.cu at G = 1, so bf16 here is refused
int dispatch(bool backward, int dtype, int head_dim, const Args& a) {
  if (a.lay.blk <= 0 || a.lay.nb <= 0 || a.lay.nb * a.lay.blk != a.s ||
      a.lay.nbk <= 0 || a.q_off < 0 || a.q_off % a.lay.blk != 0 ||
      a.batch * a.heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0 && head_dim == 64) return launch<float, 64>(backward, a);
  if (dtype == 0 && head_dim == 128) return launch<float, 128>(backward, a);
  return static_cast<int>(cudaErrorInvalidValue);
}

Layout make_layout(const void* lut, const void* cnt, const void* tlut,
                   const void* tcnt, int layout_heads, int nb, int s,
                   int kv_len, int kmax, int qmax) {
  Layout lay;
  lay.lut = static_cast<const int*>(lut);
  lay.cnt = static_cast<const int*>(cnt);
  lay.tlut = static_cast<const int*>(tlut);
  lay.tcnt = static_cast<const int*>(tcnt);
  lay.layout_heads = layout_heads;
  lay.nb = nb;
  lay.blk = nb > 0 ? s / nb : 0;
  lay.nbk = lay.blk > 0 ? kv_len / lay.blk : 0;
  lay.kmax = kmax;
  lay.qmax = qmax;
  lay.parts = (lay.blk + kRows - 1) / kRows;
  return lay;
}

}  // namespace

// B5a in fp32; a bf16 call (dtype 1) returns cudaErrorInvalidValue (it
// runs on ds_fbs_agg_fwd at G = 1).  dtype: 0 = float32.  q, k, v are
// [b, s, h, d] of that dtype with the last dim contiguous; `strides`
// points to 9 host int64 element strides: (batch, seq, head) of q, k and
// v.  out is a contiguous [b, s, h, d] of the input dtype and lse a
// contiguous fp32 [b·h, s].  lut [H, nb, kmax] and cnt [H, nb] are int32
// in device memory (build_block_luts); H = layout_heads is 1 or `heads`;
// s = nb·blk.  A sequence-parallel rank's chunk passes its nb block rows
// of the layout against `kv_len` gathered keys (k and v [b, kv_len, h,
// d]), its first global row `q_off` (a multiple of blk), which the
// causal test counts; a whole call passes kv_len = s and q_off = 0.
// Launches on `stream`, does not synchronise, allocates nothing, and
// returns cudaGetLastError().
extern "C" int ds_flash_block_sparse_fwd(
    int dtype, int head_dim, const void* q, const void* k, const void* v,
    void* out, void* lse, const void* lut, const void* cnt, int batch,
    int heads, int s, int nb, int layout_heads, int kmax,
    const int64_t* strides, float scale, int causal, int kv_len, int q_off,
    void* stream) {
  Args a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.lse_out = lse;
  a.lay = make_layout(lut, cnt, nullptr, nullptr, layout_heads, nb, s,
                      kv_len, kmax, 0);
  a.batch = batch;
  a.heads = heads;
  a.s = s;
  for (int i = 0; i < 3; ++i) {
    a.st.q[i] = strides[i];
    a.st.k[i] = strides[3 + i];
    a.st.v[i] = strides[6 + i];
  }
  a.scale = scale;
  a.causal = causal;
  a.q_off = q_off;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch(false, dtype, head_dim, a);
}

// B5b in fp32: the dq kernel, then the dk/dv kernel, on `stream`; a bf16
// call returns cudaErrorInvalidValue (it runs on ds_fbs_agg_bwd_dq and
// ds_fbs_agg_bwd_dkv at G = 1).  As above, with
// dout [b, s, h, d] (last dim contiguous), lse and delta contiguous fp32
// [b·h, s], tlut [H, kv_len/blk, qmax] and tcnt [H, kv_len/blk] the
// transposed look-up table (dk and dv [b, kv_len, h, d], a chunk's
// partials), and `strides` 18 host int64 element strides: (batch, seq, head)
// of q, k, v, dout, dq and of dk/dv (which share them).
extern "C" int ds_flash_block_sparse_bwd(
    int dtype, int head_dim, const void* q, const void* k, const void* v,
    const void* dout, const void* lse, const void* delta, void* dq, void* dk,
    void* dv, const void* lut, const void* cnt, const void* tlut,
    const void* tcnt, int batch, int heads, int s, int nb, int layout_heads,
    int kmax, int qmax, const int64_t* strides, float scale, int causal,
    int kv_len, int q_off, void* stream) {
  Args a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.lay = make_layout(lut, cnt, tlut, tcnt, layout_heads, nb, s, kv_len,
                      kmax, qmax);
  a.batch = batch;
  a.heads = heads;
  a.s = s;
  for (int i = 0; i < 3; ++i) {
    a.st.q[i] = strides[i];
    a.st.k[i] = strides[3 + i];
    a.st.v[i] = strides[6 + i];
    a.st.o[i] = strides[9 + i];
    a.st.dq[i] = strides[12 + i];
    a.st.dkv[i] = strides[15 + i];
  }
  a.scale = scale;
  a.causal = causal;
  a.q_off = q_off;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch(true, dtype, head_dim, a);
}
