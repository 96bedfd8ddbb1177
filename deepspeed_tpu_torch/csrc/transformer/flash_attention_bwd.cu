// Flash-attention backward for NVIDIA Hopper (built for sm_90a): three
// kernels, each applying attention dropout from B4's packed keep mask
// (flash_dropout.cu, drawn once by the forward).
//
// Replaces, in deepspeed_tpu/ops/transformer/flash_attention.py:
//   B2a `_bwd_dq_kernel`    (:263, launched at :691)
//       -> flash_bwd_dq_mma_kernel (bf16, fp16), flash_bwd_dq_kernel (fp32)
//   B2b `_bwd_dkv_kernel`   (:311, launched at :718)
//       -> flash_bwd_dkv_mma_kernel (bf16, fp16), flash_bwd_dkv_kernel
//          (fp32)
//   B3  `_bwd_fused_kernel` (:378, launched at :660)
//       -> flash_bwd_fused_mma_kernel (bf16, fp16), flash_bwd_fused_kernel
//          (fp32)
// They compute what those kernels compute: P = exp(S − lse) recomputed
// from the forward's logsumexp, with S scaled and masked to NEG_INF as in
// the forward (so masked keys and fully masked rows give P = 0 and
// exactly zero gradients); dP = dO·Vᵀ; under dropout the kept P and dP
// scaled by 1/keep and the dropped ones zero, with the forward's mask
// read from B4's bits; dS = P∘(dP − Δ) rounded to the storage dtype;
// dq = dS·K·(1/√d), dk = dSᵀ·Q·(1/√d), dv = P_keptᵀ·dO with P_kept
// rounded to the storage dtype.  Δ = rowsum(dO∘O) comes in precomputed,
// as the JAX package computes it outside Pallas (:638-639).  Accumulation
// is fp32; a block owns its output tile and no atomics touch a value, so
// two runs give bitwise-equal gradients (which is why dq and dk/dv are
// two kernels, as in the JAX package, and not one kernel adding dq
// atomically).
//
// fp16.  The tensor-core kernels are templates on their 16-bit element
// type: the fp16 instantiations run the bf16 design with the `.f16`
// form of `mma.sync` and round to fp16 where the bf16 ones round to bf16
// (P_kept, dS, the outputs).  Under a dynamic loss scale dO carries the
// scale, so dS = P∘(dP − Δ) can pass fp16's 65504 and round to inf, as
// the JAX kernel's `ds.astype(q.dtype)` does: that inf is the overflow
// the scaler skips.  Nothing here swallows a non-finite value: P of a
// visible score is ex2 of it (NaN and inf stay non-finite), masked P is
// exactly 0 and 0·inf = NaN as in the plain version, and no max or
// guard sits between dP and the products.
//
// Design of the bf16 B2a and B2b (tensor cores, flash_mma.cuh).  The TPU
// grids run their third axis in order and carry dq (or dk, dv) in VMEM
// scratch.  Here a block of 4 warps owns 64 output rows, each warp 16 of
// them, and walks 64-row tiles of the other side, which cp.async brings
// into padded shared-memory tiles two stages deep (tile j+1 in flight
// while tile j is computed); every product is a warp-level
// `mma.sync.m16n8k16` on bf16 operands with fp32 accumulators, its
// operands read by ldmatrix:
// - B2a: one block per (b·h, 64 query rows).  Each warp holds its Q and
//   dO rows as A fragments; per 64-key K/V tile (under `causal` only up
//   to the diagonal, the JAX `needed` test at :300) it computes S = Q·Kᵀ
//   and dP = dO·Vᵀ as 16x64 fp32 C fragments, applies scale, masks, exp,
//   dropout and dS = P∘(dP − Δ) on them in registers, repacks dS as bf16
//   A fragments (the C layout of two m16n8 tiles is the A layout of one
//   m16n8k16) and adds dS·K into its 16xD dq accumulators, K read by
//   ldmatrix.trans.
// - B2b: one block per (b·h, 64 keys); per 64-row Q/dO tile (under
//   `causal` from the first row that can see the block's first key, JAX
//   :363) each warp computes the transposes Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ
//   with its 16 keys as fragment rows, so P_keptᵀ and dSᵀ are A operands
//   as they stand: dv += P_keptᵀ·dO and dk += dSᵀ·Q, with dO and Q read
//   by ldmatrix.trans.  lse and Δ are per column here and come in with
//   the tile.
// - Dropout: the keep bits of a 64x64 tile (two 32-key words of each of
//   its 64 rows, read from B4's packed mask) come in by 4-byte cp.async
//   in the same commit group as the tile, into a two-stage shared
//   bitmask; each fragment element reads its bit (B2b transposed).  No
//   kernel here draws.
// - A tile is computed in two 32-row chunks; at head_dim 128 the block's
//   own A fragments are re-read from shared memory by ldmatrix for every
//   use, to keep the accumulators in registers.
// Registers and spills (nvcc -Xptxas -v, sm_90a, CUDA 12.8): B2a 168 a
// thread at d=64 with 8 bytes spilled (three blocks an SM), 244 at
// d=128 (no spill); B2b 168 at d=64 with 52 bytes spilled (bounded to
// three blocks an SM, which measured 5% faster than 251 registers
// without a spill), 255 at d=128 with 12 bytes spilled.
//
// The fp32 B2a and B2b keep the earlier scalar design: the only
// tensor-core product for fp32 operands is TF32, which misses the fp32
// gradient tolerance (5e-4) the checks hold.  fp32 runs only in the
// parity and kernel checks.  There D/16 neighbouring threads share a row
// (or key), 16 elements of head_dim each, and close every dot product
// with a butterfly of warp shuffles.
// - The fp32 B3: one block per b·h holds Q, dO, K, V and one [s, kv_len]
//   fp32 score tile in shared memory: P is computed once into the tile,
//   dv read off it, then dP once and dS written over P, then dq and dk
//   read off dS.
//
// Design of the bf16 B3 (tensor cores, flash_mma.cuh).  The TPU runs
// `_bwd_fused_kernel` where the whole sequence is one tile (BERT's s =
// 128), so S and dP are computed once, 10·d flops a pair where B2a and
// B2b spend 14·d.  Here one block of 8 warps (4 up to 64 query rows) per
// b·h holds the whole sequence, so no reduction leaves the block and no
// atomic touches a value:
// - Q, dO, K and V come in once by cp.async into padded bf16 tiles (rows
//   past s and kv_len zero), the key mask and, under dropout, the keep
//   bits of every (row, 32-key word) beside them (4-byte cp.async of B4's
//   words).
// - Score pass, warps owning 16 query rows each: S = Q·Kᵀ and dP = dO·Vᵀ
//   on mma.sync in 32-key chunks; on the C fragments the element test
//   (key mask, causal, the kv_len and s edges: P = 0 there, also in a
//   fully masked row), P = 2^(S·scale·log2e − lse·log2e), the keep bits,
//   dS = P∘(dP − Δ); dS repacked C→A as bf16 for dq += dS·K (K read by
//   ldmatrix.trans), and P_kept and dS stored to shared memory as bf16.
//   The warp stores its dq rows.
// - `__syncthreads`, then the key pass, warps owning 16 keys each: dv =
//   P_keptᵀ·dO and dk = dSᵀ·Q over every query row of the block in
//   order, P_kept and dS read transposed by ldmatrix.trans as A
//   fragments; dk and dv staged in the warp's own K and V rows (no warp
//   reads K or V after the score pass) and stored in 16-byte chunks.
// - Shared memory at s = kv_len = 128, d = 64: 142.5 KB, so one block an
//   SM; `fused_mma_smem_bytes` below counts it and the wrapper's fit rule
//   reads it through `ds_flash_attention_bwd_fused_smem`.
// Either B3 runs only where its tiles fit the 227 KB of shared memory a
// block can have, and where the wrapper's measured dispatch rule picks it.
//
// Bound.  At GPT-2-medium's training shape (b=8, h=16, s=1024, d=64,
// causal, bf16) B2a moves q, k, v, dO, dq (+ lse, Δ) = 84 MB (25 µs at
// 3.35 TB/s) and does 6·d flops per visible pair = 26 GFLOP (26 µs at
// 989 TFLOP/s); B2b moves 84 MB too and does 8·d per pair (35 µs).  Both
// kernels compute S and dP, so the pair costs 14·d flops in all, where a
// backward that computed them once would spend 10·d.  B3 at BERT's shape
// (b=64, h=16, s=128, d=64, bf16) moves q, k, v, dO in and dq, dk, dv out
// (+ lse, Δ, mask): 118 MB, 35 µs, against 10·d per pair = 10.7 GFLOP,
// 11 µs: bound by bytes.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

using ds_flash::from_float;
using ds_flash::kNegInf;
using ds_flash::lane_sum;
using ds_flash::round_to;
using ds_flash::to_float;

constexpr int kEpt = 16;        // head_dim elements each thread owns
constexpr int kSeg = kEpt + 4;  // padded segment: neighbours in other banks

// element strides (batch, seq, head) of every tensor the kernels touch;
// the last dimension is contiguous
struct Strides {
  int64_t q[3], k[3], v[3], o[3], dq[3], dkv[3];
};

// B4's keep bits of one head (null: no dropout), `words` int32 words a
// row, and the scale of a kept element
struct Dropout {
  const uint32_t* bits;
  int words;
  float inv_keep;
  bool on;
};

__device__ __forceinline__ Dropout read_dropout(const uint32_t* keep_bits,
                                                int keep_words, int bh,
                                                int s, float inv_keep) {
  Dropout dr;
  dr.on = keep_bits != nullptr;
  dr.bits = dr.on ? keep_bits + (int64_t)bh * s * keep_words : nullptr;
  dr.words = keep_words;
  dr.inv_keep = inv_keep;
  return dr;
}

template <typename T>
__device__ __forceinline__ void load_seg(float* dst, const T* src,
                                         bool valid) {
#pragma unroll
  for (int e = 0; e < kEpt; ++e) dst[e] = valid ? to_float(src[e]) : 0.f;
}

// ------------------------------------------------------------------ B2a
constexpr int kDqRows = 64;  // query rows per block
constexpr int kDqKeys = 32;  // keys per K/V tile

template <typename T, int D>
__global__ void __launch_bounds__(kDqRows * (D / kEpt))
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const float* __restrict__ kv_mask,
                        T* __restrict__ dq, int heads, int s, int kv_len,
                        Strides st, float scale, int causal, int q_offset,
                        const uint32_t* __restrict__ keep_bits,
                        int keep_words, float inv_keep) {
  constexpr int TPR = D / kEpt;  // threads per query row
  constexpr int THREADS = kDqRows * TPR;
  constexpr int ROW = TPR * kSeg;
  __shared__ __align__(16) float k_s[kDqKeys * ROW];
  __shared__ __align__(16) float v_s[kDqKeys * ROW];
  __shared__ float mask_s[kDqKeys];

  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int part = tid % TPR;
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int q0 = blockIdx.x * kDqRows;
  const int qi = q0 + row;
  const bool q_valid = qi < s;
  const int qr_i = q_valid ? qi : 0;
  const Dropout dr = read_dropout(keep_bits, keep_words, bh, s, inv_keep);

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

  const T* kbase = k + b * st.k[0] + h * st.k[2];
  const T* vbase = v + b * st.v[0] + h * st.v[2];
  const float* mrow = kv_mask ? kv_mask + (int64_t)b * kv_len : nullptr;
  // causal: rows q0 .. q0+kDqRows-1 (global rows q_offset + q0 ..) see
  // no key past q_offset+q0+kDqRows-1
  const int k_end = causal ? min(kv_len, q_offset + q0 + kDqRows) : kv_len;

  for (int k0 = 0; k0 < k_end; k0 += kDqKeys) {
    __syncthreads();  // every thread is done with the previous tile
    for (int e = tid; e < kDqKeys * D; e += THREADS) {
      const int j = e / D;
      const int d = e - j * D;
      const int kj = k0 + j;
      const int dst = j * ROW + (d / kEpt) * kSeg + (d % kEpt);
      float kx = 0.f, vx = 0.f;
      if (kj < kv_len) {
        kx = to_float(kbase[(int64_t)kj * st.k[1] + d]);
        vx = to_float(vbase[(int64_t)kj * st.v[1] + d]);
      }
      k_s[dst] = kx;
      v_s[dst] = vx;
    }
    if (tid < kDqKeys) {
      const int kj = k0 + tid;
      mask_s[tid] = kj < kv_len ? (mrow ? mrow[kj] : 1.f) : 0.f;
    }
    __syncthreads();

    // keep bits of this row's 32 keys: one word of B4's mask
    const uint32_t keep =
        dr.on ? dr.bits[(int64_t)qr_i * dr.words + (k0 >> 5)] : 0xffffffffu;

#pragma unroll 4
    for (int j = 0; j < kDqKeys; ++j) {
      const float4* kr =
          reinterpret_cast<const float4*>(k_s + j * ROW + part * kSeg);
      const float4* vr =
          reinterpret_cast<const float4*>(v_s + j * ROW + part * kSeg);
      float sp = 0.f, dp = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < kEpt / 4; ++d4) {
        const float4 kk = kr[d4];
        const float4 vv = vr[d4];
        sp = fmaf(qr[4 * d4 + 0], kk.x, sp);
        sp = fmaf(qr[4 * d4 + 1], kk.y, sp);
        sp = fmaf(qr[4 * d4 + 2], kk.z, sp);
        sp = fmaf(qr[4 * d4 + 3], kk.w, sp);
        dp = fmaf(dor[4 * d4 + 0], vv.x, dp);
        dp = fmaf(dor[4 * d4 + 1], vv.y, dp);
        dp = fmaf(dor[4 * d4 + 2], vv.z, dp);
        dp = fmaf(dor[4 * d4 + 3], vv.w, dp);
      }
      sp = lane_sum<TPR>(sp);
      dp = lane_sum<TPR>(dp);
      const bool visible =
          mask_s[j] > 0.f && (!causal || q_offset + qi >= k0 + j);
      const float p = expf((visible ? sp * scale : kNegInf) - lse_i);
      if (dr.on) dp = (keep >> j) & 1u ? dp * dr.inv_keep : 0.f;
      const float ds = round_to<T>(p * (dp - delta_i));
#pragma unroll
      for (int d4 = 0; d4 < kEpt / 4; ++d4) {
        const float4 kk = kr[d4];
        acc[4 * d4 + 0] = fmaf(ds, kk.x, acc[4 * d4 + 0]);
        acc[4 * d4 + 1] = fmaf(ds, kk.y, acc[4 * d4 + 1]);
        acc[4 * d4 + 2] = fmaf(ds, kk.z, acc[4 * d4 + 2]);
        acc[4 * d4 + 3] = fmaf(ds, kk.w, acc[4 * d4 + 3]);
      }
    }
  }

  if (q_valid) {
    T* out = dq + b * st.dq[0] + qi * st.dq[1] + h * st.dq[2] + part * kEpt;
#pragma unroll
    for (int e = 0; e < kEpt; ++e) out[e] = from_float<T>(acc[e] * scale);
  }
}

// ------------------------------------------------------------------ B2b
constexpr int kKvKeys = 64;  // keys per block
constexpr int kKvRows = 32;  // query rows per Q/dO tile
constexpr int kKvWords = kKvKeys / 32;

template <typename T, int D>
__global__ void __launch_bounds__(kKvKeys * (D / kEpt))
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const float* __restrict__ kv_mask,
                         T* __restrict__ dk, T* __restrict__ dv, int heads,
                         int s, int kv_len, Strides st, float scale,
                         int causal, int q_offset,
                         const uint32_t* __restrict__ keep_bits,
                         int keep_words, float inv_keep) {
  constexpr int TPR = D / kEpt;  // threads per key
  constexpr int THREADS = kKvKeys * TPR;
  constexpr int ROW = TPR * kSeg;
  __shared__ __align__(16) float q_s[kKvRows * ROW];
  __shared__ __align__(16) float o_s[kKvRows * ROW];
  __shared__ float lse_s[kKvRows];
  __shared__ float delta_s[kKvRows];
  __shared__ uint32_t keep_s[kKvRows * kKvWords];

  const int tid = threadIdx.x;
  const int key = tid / TPR;
  const int part = tid % TPR;
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int k0 = blockIdx.x * kKvKeys;
  const int kj = k0 + key;
  const bool k_valid = kj < kv_len;
  const int kj_i = k_valid ? kj : 0;
  const float* mrow = kv_mask ? kv_mask + (int64_t)b * kv_len : nullptr;
  const bool key_visible = k_valid && (!mrow || mrow[kj_i] > 0.f);
  const Dropout dr = read_dropout(keep_bits, keep_words, bh, s, inv_keep);

  float kr[kEpt], vr[kEpt], dka[kEpt], dva[kEpt];
  load_seg(kr, k + b * st.k[0] + kj_i * st.k[1] + h * st.k[2] + part * kEpt,
           k_valid);
  load_seg(vr, v + b * st.v[0] + kj_i * st.v[1] + h * st.v[2] + part * kEpt,
           k_valid);
#pragma unroll
  for (int e = 0; e < kEpt; ++e) dka[e] = dva[e] = 0.f;

  const T* qbase = q + b * st.q[0] + h * st.q[2];
  const T* obase = dout + b * st.o[0] + h * st.o[2];
  // causal: rows before global row k0 (local k0 - q_offset) see none of
  // this block's keys
  const int i_begin = causal ? min(max(k0 - q_offset, 0), s) : 0;

  for (int i0 = i_begin; i0 < s; i0 += kKvRows) {
    __syncthreads();  // every thread is done with the previous tile
    for (int e = tid; e < kKvRows * D; e += THREADS) {
      const int r = e / D;
      const int d = e - r * D;
      const int i = i0 + r;
      const int dst = r * ROW + (d / kEpt) * kSeg + (d % kEpt);
      float qx = 0.f, ox = 0.f;
      if (i < s) {
        qx = to_float(qbase[(int64_t)i * st.q[1] + d]);
        ox = to_float(obase[(int64_t)i * st.o[1] + d]);
      }
      q_s[dst] = qx;
      o_s[dst] = ox;
    }
    if (tid < kKvRows) {
      const int i = i0 + tid;
      lse_s[tid] = i < s ? lse[(int64_t)bh * s + i] : 0.f;
      delta_s[tid] = i < s ? delta[(int64_t)bh * s + i] : 0.f;
    }
    if (dr.on) {
      // the tile's keep bits: words of B4's mask, 0 past s and kv_len
      for (int e = tid; e < kKvRows * kKvWords; e += THREADS) {
        const int i = i0 + e / kKvWords;
        const int w = (k0 >> 5) + e % kKvWords;
        keep_s[e] = i < s && w < dr.words
                        ? dr.bits[(int64_t)i * dr.words + w]
                        : 0u;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int r = 0; r < kKvRows; ++r) {
      const int i = i0 + r;
      const float4* qv =
          reinterpret_cast<const float4*>(q_s + r * ROW + part * kSeg);
      const float4* ov =
          reinterpret_cast<const float4*>(o_s + r * ROW + part * kSeg);
      float sp = 0.f, dp = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < kEpt / 4; ++d4) {
        const float4 qq = qv[d4];
        const float4 oo = ov[d4];
        sp = fmaf(kr[4 * d4 + 0], qq.x, sp);
        sp = fmaf(kr[4 * d4 + 1], qq.y, sp);
        sp = fmaf(kr[4 * d4 + 2], qq.z, sp);
        sp = fmaf(kr[4 * d4 + 3], qq.w, sp);
        dp = fmaf(vr[4 * d4 + 0], oo.x, dp);
        dp = fmaf(vr[4 * d4 + 1], oo.y, dp);
        dp = fmaf(vr[4 * d4 + 2], oo.z, dp);
        dp = fmaf(vr[4 * d4 + 3], oo.w, dp);
      }
      sp = lane_sum<TPR>(sp);
      dp = lane_sum<TPR>(dp);
      const bool visible =
          key_visible && i < s && (!causal || q_offset + i >= kj);
      const float p = expf((visible ? sp * scale : kNegInf) - lse_s[r]);
      float pv = p;
      if (dr.on) {
        const bool kept = (keep_s[r * kKvWords + (key >> 5)] >> (key & 31)) & 1u;
        pv = kept ? p * dr.inv_keep : 0.f;
        dp = kept ? dp * dr.inv_keep : 0.f;
      }
      const float ds = round_to<T>(p * (dp - delta_s[r]));
      const float pvr = round_to<T>(pv);
#pragma unroll
      for (int d4 = 0; d4 < kEpt / 4; ++d4) {
        const float4 qq = qv[d4];
        const float4 oo = ov[d4];
        dka[4 * d4 + 0] = fmaf(ds, qq.x, dka[4 * d4 + 0]);
        dka[4 * d4 + 1] = fmaf(ds, qq.y, dka[4 * d4 + 1]);
        dka[4 * d4 + 2] = fmaf(ds, qq.z, dka[4 * d4 + 2]);
        dka[4 * d4 + 3] = fmaf(ds, qq.w, dka[4 * d4 + 3]);
        dva[4 * d4 + 0] = fmaf(pvr, oo.x, dva[4 * d4 + 0]);
        dva[4 * d4 + 1] = fmaf(pvr, oo.y, dva[4 * d4 + 1]);
        dva[4 * d4 + 2] = fmaf(pvr, oo.z, dva[4 * d4 + 2]);
        dva[4 * d4 + 3] = fmaf(pvr, oo.w, dva[4 * d4 + 3]);
      }
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

// ----------------------------------------- B2a and B2b, bf16 and fp16 (mma)
using bf16 = __nv_bfloat16;
using ds_flash::c_to_a;
using ds_flash::cp_async_commit;
using ds_flash::cp_async_wait;
using ds_flash::ex2_approx;
using ds_flash::kMmaThreads;
using ds_flash::kMmaTileRows;
using ds_flash::ldsm_b;
using ds_flash::ldsm_bt;
using ds_flash::load_keep_tile_async;
using ds_flash::load_row_async;
using ds_flash::load_tile_async;
using ds_flash::mma16;
using ds_flash::MmaTile;
using ds_flash::OwnRows;
using ds_flash::pack16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBitWords = 2 * kMmaTileRows;  // keep bits of a 64x64 tile
// rows of the streamed tile computed at once: 32 of the 64 keep the score
// fragments at 32 registers a thread (at 64 the dq kernel needs 232
// registers a thread, at 32 168, which lets three blocks share an SM)
constexpr int kMmaChunk = 32;
// Both kernels ask for three blocks an SM at head_dim 64 (168 registers a
// thread); at 128 the accumulators alone take 128 registers, so one.

// shared memory of either kernel: six padded tiles (the block's own two,
// two stages of the streamed two), four rows of 64 fp32 values (B2a: the
// key mask in two stages, B2b: lse and Δ in two stages each) and two
// stages of keep bits
template <int D>
constexpr int mma_smem_bytes() {
  return 6 * MmaTile<D>::kElems * static_cast<int>(sizeof(bf16)) +
         4 * kMmaTileRows * static_cast<int>(sizeof(float)) +
         2 * kBitWords * static_cast<int>(sizeof(uint32_t));
}

template <typename T, int D>
__global__ void __launch_bounds__(kMmaThreads, D == 64 ? 3 : 1)
    flash_bwd_dq_mma_kernel(const T* __restrict__ q,
                            const T* __restrict__ k,
                            const T* __restrict__ v,
                            const T* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            const float* __restrict__ kv_mask,
                            T* __restrict__ dq, int heads, int s,
                            int kv_len, Strides st, float scale, int causal,
                            int q_offset,
                            const uint32_t* __restrict__ keep_bits,
                            int keep_words, float inv_keep) {
  using Tile = MmaTile<D>;
  constexpr int KC = kMmaChunk;
  extern __shared__ __align__(16) unsigned char mma_smem[];
  T* q_s = reinterpret_cast<T*>(mma_smem);
  T* o_s = q_s + Tile::kElems;
  T* k_s = o_s + Tile::kElems;      // two stages
  T* v_s = k_s + 2 * Tile::kElems;  // two stages
  float* mask_s = reinterpret_cast<float*>(v_s + 2 * Tile::kElems);
  uint32_t* bits_s = reinterpret_cast<uint32_t*>(mask_s + 4 * kMmaTileRows);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wr = (tid >> 5) * 16;  // the warp's first row in the block
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  // the last query blocks first: under `causal` they walk the most
  // tiles, and the card starts blocks in grid order
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kMmaTileRows;
  const Dropout dr = read_dropout(keep_bits, keep_words, bh, s, inv_keep);

  const T* kbase = k + b * st.k[0] + h * st.k[2];
  const T* vbase = v + b * st.v[0] + h * st.v[2];
  const float* mrow = kv_mask ? kv_mask + (int64_t)b * kv_len : nullptr;
  // causal: rows q0 .. q0+63 (global rows q_offset + q0 ..) see no key
  // past q_offset+q0+63
  const int k_end =
      causal ? min(kv_len, q_offset + q0 + kMmaTileRows) : kv_len;
  const int n_tiles = (k_end + kMmaTileRows - 1) / kMmaTileRows;

  auto issue = [&](int j) {
    const int stage = j & 1;
    const int kt = j * kMmaTileRows;
    load_tile_async<D>(k_s + stage * Tile::kElems, kbase, st.k[1], kt,
                       kv_len, tid);
    load_tile_async<D>(v_s + stage * Tile::kElems, vbase, st.v[1], kt,
                       kv_len, tid);
    // the tile's key mask: 0 past kv_len, 1 where no mask is given
    if (mrow)
      load_row_async(mask_s + stage * kMmaTileRows, mrow, kt, kv_len, tid);
    else if (tid < kMmaTileRows)
      mask_s[stage * kMmaTileRows + tid] = kt + tid < kv_len ? 1.f : 0.f;
    // the tile's keep bits: words 2j, 2j+1 of the block's rows
    if (dr.on)
      load_keep_tile_async(bits_s + stage * kBitWords, dr.bits, dr.words, q0,
                           s, 2 * j, tid);
  };
  load_tile_async<D>(q_s, q + b * st.q[0] + h * st.q[2], st.q[1], q0, s,
                     tid);
  load_tile_async<D>(o_s, dout + b * st.o[0] + h * st.o[2], st.o[1], q0, s,
                     tid);
  issue(0);
  cp_async_commit();

  // lse (in log2 units) and Δ of the thread's rows g and g+8
  float lse2[2], dlt[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = q0 + wr + g + 8 * hh;
    lse2[hh] = i < s ? lse[(int64_t)bh * s + i] * kLog2e : 0.f;
    dlt[hh] = i < s ? delta[(int64_t)bh * s + i] : 0.f;
  }
  const float scale2 = scale * kLog2e;

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  OwnRows<D, T> qf, of;

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) issue(j + 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile j (and at j = 0 the block's Q, dO) is in
    __syncthreads();
    if (j == 0) {
      qf.init(q_s, wr, lane);
      of.init(o_s, wr, lane);
    }
    const T* kt_s = k_s + (j & 1) * Tile::kElems;
    const T* vt_s = v_s + (j & 1) * Tile::kElems;
    const float* mt = mask_s + (j & 1) * kMmaTileRows;
    const int kt0 = j * kMmaTileRows;
    // keep bits of the thread's rows g and g+8: one word per 32 keys
    uint32_t keep[2][2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int w = 0; w < 2; ++w)
        keep[hh][w] = dr.on ? bits_s[(j & 1) * kBitWords +
                                     2 * (wr + g + 8 * hh) + w]
                            : 0u;

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
      // kt0 + c + 8n + 2t + {0, 1}, its rows q0 + wr + g + {0, 8}
#pragma unroll
      for (int n = 0; n < KC / 8; ++n) {
        const int kl = c + 8 * n + 2 * t;  // key in the tile
        const float2 mk = *reinterpret_cast<const float2*>(mt + kl);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hh = e >> 1;
          const int jj = kt0 + kl + (e & 1);
          const bool vis = ((e & 1) ? mk.y : mk.x) > 0.f &&
                           (!causal || q_offset + q0 + wr + g + 8 * hh >= jj);
          const float p =
              vis ? ex2_approx(fmaf(sc[n][e], scale2, -lse2[hh])) : 0.f;
          float d = dp[n][e];
          if (dr.on)
            d = (keep[hh][(c + 8 * n) >> 5] >> ((kl + (e & 1)) & 31)) & 1u
                    ? d * dr.inv_keep
                    : 0.f;
          sc[n][e] = p * (d - dlt[hh]);
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
    __syncthreads();  // every warp is done with stage j & 1
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = q0 + wr + g + 8 * hh;
    if (i < s) {
      T* out = dq + b * st.dq[0] + (int64_t)i * st.dq[1] + h * st.dq[2];
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(out + 8 * n + 2 * t) = pack16<T>(
            acc[n][2 * hh] * scale, acc[n][2 * hh + 1] * scale);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kMmaThreads, D == 64 ? 3 : 1)
    flash_bwd_dkv_mma_kernel(const T* __restrict__ q,
                             const T* __restrict__ k,
                             const T* __restrict__ v,
                             const T* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             const float* __restrict__ kv_mask,
                             T* __restrict__ dk, T* __restrict__ dv,
                             int heads, int s, int kv_len, Strides st,
                             float scale, int causal, int q_offset,
                             const uint32_t* __restrict__ keep_bits,
                             int keep_words, float inv_keep) {
  using Tile = MmaTile<D>;
  constexpr int KC = kMmaChunk;
  extern __shared__ __align__(16) unsigned char mma_smem[];
  T* k_s = reinterpret_cast<T*>(mma_smem);
  T* v_s = k_s + Tile::kElems;
  T* q_s = v_s + Tile::kElems;      // two stages
  T* o_s = q_s + 2 * Tile::kElems;  // two stages
  float* lse_s = reinterpret_cast<float*>(o_s + 2 * Tile::kElems);
  float* dlt_s = lse_s + 2 * kMmaTileRows;
  uint32_t* bits_s = reinterpret_cast<uint32_t*>(dlt_s + 2 * kMmaTileRows);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wk = (tid >> 5) * 16;  // the warp's first key in the block
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int k0 = blockIdx.x * kMmaTileRows;
  const Dropout dr = read_dropout(keep_bits, keep_words, bh, s, inv_keep);

  const T* qbase = q + b * st.q[0] + h * st.q[2];
  const T* obase = dout + b * st.o[0] + h * st.o[2];
  const float* lrow = lse + (int64_t)bh * s;
  const float* drow = delta + (int64_t)bh * s;
  // causal: rows before global row k0 (local k0 - q_offset) see none of
  // this block's keys
  const int i_begin = causal ? min(max(k0 - q_offset, 0), s) : 0;
  const int n_tiles = (s - i_begin + kMmaTileRows - 1) / kMmaTileRows;

  auto issue = [&](int j) {
    const int stage = j & 1;
    const int i0 = i_begin + j * kMmaTileRows;
    load_tile_async<D>(q_s + stage * Tile::kElems, qbase, st.q[1], i0, s,
                       tid);
    load_tile_async<D>(o_s + stage * Tile::kElems, obase, st.o[1], i0, s,
                       tid);
    load_row_async(lse_s + stage * kMmaTileRows, lrow, i0, s, tid);
    load_row_async(dlt_s + stage * kMmaTileRows, drow, i0, s, tid);
    // the tile's keep bits: the block's two words of the tile's rows
    if (dr.on)
      load_keep_tile_async(bits_s + stage * kBitWords, dr.bits, dr.words, i0,
                           s, k0 >> 5, tid);
  };
  load_tile_async<D>(k_s, k + b * st.k[0] + h * st.k[2], st.k[1], k0, kv_len,
                     tid);
  load_tile_async<D>(v_s, v + b * st.v[0] + h * st.v[2], st.v[1], k0, kv_len,
                     tid);
  if (n_tiles > 0) issue(0);
  cp_async_commit();

  // whether the thread's keys g and g+8 are visible at all
  bool key_vis[2];
  const float* mrow = kv_mask ? kv_mask + (int64_t)b * kv_len : nullptr;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int j = k0 + wk + g + 8 * hh;
    key_vis[hh] = j < kv_len && (!mrow || mrow[j] > 0.f);
  }
  const float scale2 = scale * kLog2e;

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  OwnRows<D, T> kf, vf;

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) issue(j + 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile j (and at j = 0 the block's K, V) is in
    __syncthreads();
    if (j == 0) {
      kf.init(k_s, wk, lane);
      vf.init(v_s, wk, lane);
    }
    const T* qt_s = q_s + (j & 1) * Tile::kElems;
    const T* ot_s = o_s + (j & 1) * Tile::kElems;
    const float* lt = lse_s + (j & 1) * kMmaTileRows;
    const float* dt = dlt_s + (j & 1) * kMmaTileRows;
    const uint32_t* bt = bits_s + (j & 1) * kBitWords;
    const int i0 = i_begin + j * kMmaTileRows;

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
      // P_keptᵀ in place of Sᵀ, dSᵀ in place of dPᵀ; the thread's keys
      // are k0 + wk + g + {0, 8}, its rows i0 + c + 8n + 2t + {0, 1}
#pragma unroll
      for (int n = 0; n < KC / 8; ++n) {
        const int rl = c + 8 * n + 2 * t;  // row in the tile
        const float2 l2 = *reinterpret_cast<const float2*>(lt + rl);
        const float2 d2 = *reinterpret_cast<const float2*>(dt + rl);
        const float nl[2] = {-l2.x * kLog2e, -l2.y * kLog2e};
        const float dl[2] = {d2.x, d2.y};
        uint32_t keep[2] = {0u, 0u};
        if (dr.on) {
          keep[0] = bt[2 * rl + (wk >> 5)];
          keep[1] = bt[2 * (rl + 1) + (wk >> 5)];
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hh = e >> 1;
          const int col = e & 1;
          const int kl = wk + g + 8 * hh;  // key in the block
          const int i = i0 + rl + col;
          const bool vis =
              key_vis[hh] && i < s && (!causal || q_offset + i >= k0 + kl);
          const float p =
              vis ? ex2_approx(fmaf(sc[n][e], scale2, nl[col])) : 0.f;
          float d = dp[n][e];
          float pv = p;
          if (dr.on) {
            const bool kept = (keep[col] >> (kl & 31)) & 1u;
            pv = kept ? p * dr.inv_keep : 0.f;
            d = kept ? d * dr.inv_keep : 0.f;
          }
          sc[n][e] = pv;
          dp[n][e] = p * (d - dl[col]);
        }
      }
      // dv += P_keptᵀ·dO and dk += dSᵀ·Q
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
    __syncthreads();  // every warp is done with stage j & 1
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int j = k0 + wk + g + 8 * hh;
    if (j < kv_len) {
      const int64_t off = b * st.dkv[0] + (int64_t)j * st.dkv[1] +
                          h * st.dkv[2] + 2 * t;
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

// ------------------------------------------------------------- B3, fp32
constexpr int kFusedThreads = 1024;

// shared-memory floats of the fused kernel: Q and dO [s, D], K and V
// [kv_len, D+1] (padded rows), the [s, kv_len] score tile, lse and Δ [s],
// the key mask [kv_len] and the keep bits [s, ceil(kv_len/32)]
__host__ __device__ inline int64_t fused_smem_floats(int d, int s,
                                                     int kv_len) {
  const int64_t words = (kv_len + 31) / 32;
  return 2LL * s * d + 2LL * kv_len * (d + 1) + (int64_t)s * kv_len +
         2LL * s + kv_len + (int64_t)s * words;
}

template <typename T, int D>
__global__ void __launch_bounds__(kFusedThreads)
    flash_bwd_fused_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const T* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           const float* __restrict__ kv_mask,
                           T* __restrict__ dq, T* __restrict__ dk,
                           T* __restrict__ dv, int heads, int s, int kv_len,
                           Strides st, float scale, int causal, int q_offset,
                           const uint32_t* __restrict__ keep_bits,
                           int keep_words, float inv_keep) {
  constexpr int KROW = D + 1;  // padded: threads walking keys hit all banks
  extern __shared__ float smem[];
  float* q_s = smem;
  float* o_s = q_s + s * D;
  float* k_s = o_s + s * D;
  float* v_s = k_s + kv_len * KROW;
  float* t_s = v_s + kv_len * KROW;  // P, then dS
  float* lse_s = t_s + s * kv_len;
  float* delta_s = lse_s + s;
  float* mask_s = delta_s + s;
  uint32_t* keep_s = reinterpret_cast<uint32_t*>(mask_s + kv_len);
  const int words = (kv_len + 31) / 32;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const Dropout dr = read_dropout(keep_bits, keep_words, bh, s, inv_keep);
  const float* mrow = kv_mask ? kv_mask + (int64_t)b * kv_len : nullptr;

  for (int e = tid; e < s * D; e += kFusedThreads) {
    const int i = e / D;
    const int d = e - i * D;
    q_s[e] = to_float(q[b * st.q[0] + i * st.q[1] + h * st.q[2] + d]);
    o_s[e] = to_float(dout[b * st.o[0] + i * st.o[1] + h * st.o[2] + d]);
  }
  for (int e = tid; e < kv_len * D; e += kFusedThreads) {
    const int j = e / D;
    const int d = e - j * D;
    k_s[j * KROW + d] =
        to_float(k[b * st.k[0] + j * st.k[1] + h * st.k[2] + d]);
    v_s[j * KROW + d] =
        to_float(v[b * st.v[0] + j * st.v[1] + h * st.v[2] + d]);
  }
  for (int i = tid; i < s; i += kFusedThreads) {
    lse_s[i] = lse[(int64_t)bh * s + i];
    delta_s[i] = delta[(int64_t)bh * s + i];
  }
  for (int j = tid; j < kv_len; j += kFusedThreads)
    mask_s[j] = mrow ? mrow[j] : 1.f;
  // the head's keep bits: B4's words, [s, words] as they lie
  if (dr.on)
    for (int e = tid; e < s * words; e += kFusedThreads) keep_s[e] = dr.bits[e];
  __syncthreads();

  // pass 1: P = exp(S - lse) into the tile
  for (int e = tid; e < s * kv_len; e += kFusedThreads) {
    const int i = e / kv_len;
    const int j = e - i * kv_len;
    const float* qr = q_s + i * D;
    const float* kr = k_s + j * KROW;
    float sp = 0.f;
#pragma unroll 16
    for (int d = 0; d < D; ++d) sp = fmaf(qr[d], kr[d], sp);
    const bool visible = mask_s[j] > 0.f && (!causal || q_offset + i >= j);
    t_s[e] = expf((visible ? sp * scale : kNegInf) - lse_s[i]);
  }
  __syncthreads();

  // dv = P_keptᵀ·dO, P_kept in the storage dtype
  for (int e = tid; e < kv_len * D; e += kFusedThreads) {
    const int j = e / D;
    const int d = e - j * D;
    float acc = 0.f;
    for (int i = 0; i < s; ++i) {
      float p = t_s[i * kv_len + j];
      if (dr.on)
        p = (keep_s[i * words + (j >> 5)] >> (j & 31)) & 1u
                ? p * dr.inv_keep
                : 0.f;
      acc = fmaf(round_to<T>(p), o_s[i * D + d], acc);
    }
    dv[b * st.dkv[0] + j * st.dkv[1] + h * st.dkv[2] + d] = from_float<T>(acc);
  }
  __syncthreads();

  // pass 2: dS = P∘(dP − Δ) over the tile
  for (int e = tid; e < s * kv_len; e += kFusedThreads) {
    const int i = e / kv_len;
    const int j = e - i * kv_len;
    const float* orow = o_s + i * D;
    const float* vr = v_s + j * KROW;
    float dp = 0.f;
#pragma unroll 16
    for (int d = 0; d < D; ++d) dp = fmaf(orow[d], vr[d], dp);
    if (dr.on)
      dp = (keep_s[i * words + (j >> 5)] >> (j & 31)) & 1u ? dp * dr.inv_keep
                                                            : 0.f;
    t_s[e] = round_to<T>(t_s[e] * (dp - delta_s[i]));
  }
  __syncthreads();

  // dq = dS·K/√d and dk = dSᵀ·Q/√d
  for (int e = tid; e < s * D; e += kFusedThreads) {
    const int i = e / D;
    const int d = e - i * D;
    float acc = 0.f;
    for (int j = 0; j < kv_len; ++j)
      acc = fmaf(t_s[i * kv_len + j], k_s[j * KROW + d], acc);
    dq[b * st.dq[0] + i * st.dq[1] + h * st.dq[2] + d] =
        from_float<T>(acc * scale);
  }
  for (int e = tid; e < kv_len * D; e += kFusedThreads) {
    const int j = e / D;
    const int d = e - j * D;
    float acc = 0.f;
    for (int i = 0; i < s; ++i)
      acc = fmaf(t_s[i * kv_len + j], q_s[i * D + d], acc);
    dk[b * st.dkv[0] + j * st.dkv[1] + h * st.dkv[2] + d] =
        from_float<T>(acc * scale);
  }
}

// ----------------------------------------------------- B3, bf16 and fp16
// Warps of the bf16 (and fp16) B3: above kFusedNarrowRows query rows 8, which hold
// BERT's 128 rows (and keys) at 16 a warp, one block an SM (its 142.5 KB
// of shared memory leave no room for a second); at or below it 4, whose
// blocks are small enough for three an SM at head_dim 64 (registers and
// shared memory), where 8 warps of 172 registers allow one.  Chosen by
// examples/profile_torch_b3.py's times on an H100 (PERF.md): at b=64, 8
// warps against 4 took 0.119 / 0.164 ms at s=128, 0.084 / 0.050 at 21
// rows against 128 keys and 0.064 / 0.040 at s=64.
constexpr int kFusedNarrowRows = 64;

// The bf16 B3's tiles hold the query rows rounded up to 16 (a warp's
// rows) and the keys rounded up to 32 (a chunk of the score pass).
__host__ __device__ inline int fused_rows(int s) { return (s + 15) / 16 * 16; }
__host__ __device__ inline int fused_keys(int kv_len) {
  return (kv_len + 31) / 32 * 32;
}

// Shared-memory bytes of the bf16 or fp16 B3: Q and dO [rows, d+8] and K
// and V [keys, d+8], P_kept and dS [rows, keys+8], 16-bit (8 values of
// padding a row, as MmaTile), the key mask [keys] in fp32 and the keep
// bits [rows, keys/32].  Largest s = kv_len that fits 232,448 bytes: 160
// at d = 64, 128 at d = 128.
__host__ __device__ inline int64_t fused_mma_smem_bytes(int d, int s,
                                                        int kv_len) {
  const int64_t rows = fused_rows(s), keys = fused_keys(kv_len);
  return 2 * (2 * (rows + keys) * (d + 8) + 2 * rows * (keys + 8)) +
         4 * keys + 4 * rows * (keys / 32);
}

// A fragment of the 16x16 block (rows m0 .., columns k0 ..) of tileᵀ,
// where `tile` is a 16-bit tile with rows of `row` values whose rows are
// the k index and its columns the m index (P_kept and dS, whose rows are
// queries, as the A operand of a product over queries): ldmatrix.trans
template <typename T>
__device__ __forceinline__ void ldsm_at(uint32_t (&a)[4], const T* tile,
                                        int row, int k0, int m0, int lane) {
  ds_flash::ldmatrix_x4_trans(
      a, tile + (k0 + (lane & 7) + ((lane >> 4) << 3)) * row + m0 +
             ((lane >> 3) & 1) * 8);
}

// The design is described at the top of this file.  NW warps.
template <typename T, int D, int NW>
__global__ void __launch_bounds__(32 * NW, NW == 8 ? 1 : (D == 64 ? 3 : 2))
    flash_bwd_fused_mma_kernel(const T* __restrict__ q,
                               const T* __restrict__ k,
                               const T* __restrict__ v,
                               const T* __restrict__ dout,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               const float* __restrict__ kv_mask,
                               T* __restrict__ dq, T* __restrict__ dk,
                               T* __restrict__ dv, int heads, int s,
                               int kv_len, Strides st, float scale,
                               int causal, int q_offset,
                               const uint32_t* __restrict__ keep_bits,
                               int keep_words, float inv_keep) {
  constexpr int ROW = MmaTile<D>::kRow;
  constexpr int CH = MmaTile<D>::kChunks;
  constexpr int KC = kMmaChunk;
  constexpr int THREADS = 32 * NW;
  extern __shared__ __align__(16) unsigned char fused_smem[];
  const int rows = fused_rows(s);
  const int keys = fused_keys(kv_len);
  const int prow = keys + 8;  // padded row of P_kept and dS
  const int words = keys / 32;
  T* q_s = reinterpret_cast<T*>(fused_smem);
  T* o_s = q_s + rows * ROW;
  T* k_s = o_s + rows * ROW;
  T* v_s = k_s + keys * ROW;
  T* p_s = v_s + keys * ROW;    // P_kept
  T* ds_s = p_s + rows * prow;  // dS
  float* mask_s = reinterpret_cast<float*>(ds_s + rows * prow);
  uint32_t* bits_s = reinterpret_cast<uint32_t*>(mask_s + keys);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const Dropout dr = read_dropout(keep_bits, keep_words, bh, s, inv_keep);

  // Q, dO, K and V by cp.async, zero past s and kv_len
  auto load = [&](T* dst, const T* src, int64_t stride, int n,
                  int lim) {
    for (int e = tid; e < n * CH; e += THREADS) {
      const int r = e / CH;
      const int ch = e - r * CH;
      const bool ok = r < lim;
      ds_flash::cp_async16(dst + r * ROW + ch * 8,
                           src + (ok ? r * stride : 0) + ch * 8, ok);
    }
  };
  load(q_s, q + b * st.q[0] + h * st.q[2], st.q[1], rows, s);
  load(o_s, dout + b * st.o[0] + h * st.o[2], st.o[1], rows, s);
  load(k_s, k + b * st.k[0] + h * st.k[2], st.k[1], keys, kv_len);
  load(v_s, v + b * st.v[0] + h * st.v[2], st.v[1], keys, kv_len);
  // the head's keep bits: B4's words, [s, words] as they lie
  if (dr.on)
    for (int e = tid; e < s * words; e += THREADS)
      ds_flash::cp_async4(bits_s + e, dr.bits + e, true);
  cp_async_commit();
  const float* mrow = kv_mask ? kv_mask + (int64_t)b * kv_len : nullptr;
  for (int j = tid; j < keys; j += THREADS)
    mask_s[j] = j < kv_len ? (mrow ? mrow[j] : 1.f) : 0.f;
  cp_async_wait<0>();
  __syncthreads();

  // score pass: the warp's query rows r0 .. r0+15
  const float scale2 = scale * kLog2e;
  for (int r0 = 16 * warp; r0 < rows; r0 += 16 * NW) {
    int row[2];
    float lse2[2], dlt[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      row[hh] = r0 + g + 8 * hh;
      const bool ok = row[hh] < s;
      lse2[hh] = ok ? lse[(int64_t)bh * s + row[hh]] * kLog2e : 0.f;
      dlt[hh] = ok ? delta[(int64_t)bh * s + row[hh]] : 0.f;
    }
    OwnRows<D, T> qf, of;
    qf.init(q_s, r0, lane);
    of.init(o_s, r0, lane);
    float acc[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

    for (int c = 0; c < keys; c += KC) {
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
          ldsm_b<D>(bk, k_s, c + 16 * nn, 16 * kk, lane);
          ldsm_b<D>(bv, v_s, c + 16 * nn, 16 * kk, lane);
          mma16<T>(sc[2 * nn], aq, bk[0], bk[1]);
          mma16<T>(sc[2 * nn + 1], aq, bk[2], bk[3]);
          mma16<T>(dp[2 * nn], ao, bv[0], bv[1]);
          mma16<T>(dp[2 * nn + 1], ao, bv[2], bv[3]);
        }
      }
      // P_kept in place of S, dS in place of dP; the thread's keys are
      // c + 8n + 2t + {0, 1}, its rows r0 + g + {0, 8}
#pragma unroll
      for (int n = 0; n < KC / 8; ++n) {
        const int kl = c + 8 * n + 2 * t;
        const float2 mk = *reinterpret_cast<const float2*>(mask_s + kl);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hh = e >> 1;
          const int j = kl + (e & 1);
          const bool vis = ((e & 1) ? mk.y : mk.x) > 0.f && row[hh] < s &&
                           (!causal || q_offset + row[hh] >= j);
          const float p =
              vis ? ex2_approx(fmaf(sc[n][e], scale2, -lse2[hh])) : 0.f;
          float d = dp[n][e];
          float pk = p;
          if (dr.on) {
            const bool kept =
                vis && (bits_s[row[hh] * words + (j >> 5)] >> (j & 31)) & 1u;
            pk = kept ? p * dr.inv_keep : 0.f;
            d = kept ? d * dr.inv_keep : 0.f;
          }
          sc[n][e] = pk;
          dp[n][e] = p * (d - dlt[hh]);
        }
      }
      // P_kept and dS into shared memory as T
#pragma unroll
      for (int n = 0; n < KC / 8; ++n)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int off = (r0 + g + 8 * hh) * prow + c + 8 * n + 2 * t;
          *reinterpret_cast<uint32_t*>(p_s + off) =
              pack16<T>(sc[n][2 * hh], sc[n][2 * hh + 1]);
          *reinterpret_cast<uint32_t*>(ds_s + off) =
              pack16<T>(dp[n][2 * hh], dp[n][2 * hh + 1]);
        }
      // dq += dS·K, dS as T A fragments straight from the C fragments
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {
        uint32_t a[4];
        c_to_a<T>(a, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int nd = 0; nd < D / 16; ++nd) {
          uint32_t bk[4];
          ldsm_bt<D>(bk, k_s, c + 16 * kk, 16 * nd, lane);
          mma16<T>(acc[2 * nd], a, bk[0], bk[1]);
          mma16<T>(acc[2 * nd + 1], a, bk[2], bk[3]);
        }
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (row[hh] < s) {
        T* out =
            dq + b * st.dq[0] + (int64_t)row[hh] * st.dq[1] + h * st.dq[2];
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
          *reinterpret_cast<uint32_t*>(out + 8 * n + 2 * t) = pack16<T>(
              acc[n][2 * hh] * scale, acc[n][2 * hh + 1] * scale);
      }
    }
  }
  __syncthreads();  // every row's P_kept and dS is in

  // key pass: the warp's keys c0 .. c0+15, over every query row in order
  const int key_end = (kv_len + 15) / 16 * 16;
  for (int c0 = 16 * warp; c0 < key_end; c0 += 16 * NW) {
    float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
    for (int i0 = 0; i0 < rows; i0 += 16) {
      uint32_t ap[4], as[4];
      ldsm_at(ap, p_s, prow, i0, c0, lane);
      ldsm_at(as, ds_s, prow, i0, c0, lane);
#pragma unroll
      for (int nd = 0; nd < D / 16; ++nd) {
        uint32_t bo[4], bq[4];
        ldsm_bt<D>(bo, o_s, i0, 16 * nd, lane);
        mma16<T>(dva[2 * nd], ap, bo[0], bo[1]);
        mma16<T>(dva[2 * nd + 1], ap, bo[2], bo[3]);
        ldsm_bt<D>(bq, q_s, i0, 16 * nd, lane);
        mma16<T>(dka[2 * nd], as, bq[0], bq[1]);
        mma16<T>(dka[2 * nd + 1], as, bq[2], bq[3]);
      }
    }
    // dk and dv into the warp's own K and V rows, then 16-byte stores
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = c0 + g + 8 * hh;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<uint32_t*>(k_s + r * ROW + 8 * n + 2 * t) =
            pack16<T>(dka[n][2 * hh] * scale, dka[n][2 * hh + 1] * scale);
        *reinterpret_cast<uint32_t*>(v_s + r * ROW + 8 * n + 2 * t) =
            pack16<T>(dva[n][2 * hh], dva[n][2 * hh + 1]);
      }
    }
    __syncwarp();
    for (int e = lane; e < 16 * CH; e += 32) {
      const int j = c0 + e / CH;
      const int ch = e % CH;
      if (j < kv_len) {
        const int64_t off =
            b * st.dkv[0] + (int64_t)j * st.dkv[1] + h * st.dkv[2] + 8 * ch;
        *reinterpret_cast<uint4*>(dk + off) =
            *reinterpret_cast<const uint4*>(k_s + j * ROW + 8 * ch);
        *reinterpret_cast<uint4*>(dv + off) =
            *reinterpret_cast<const uint4*>(v_s + j * ROW + 8 * ch);
      }
    }
  }
}

// ------------------------------------------------------------ launchers
struct Args {
  const void *q, *k, *v, *dout, *lse, *delta, *kv_mask;
  void *dq, *dk, *dv;
  int batch, heads, s, kv_len;
  Strides st;
  float scale;
  int causal, q_offset;
  const uint32_t* keep_bits;
  int keep_words;
  float inv_keep;
  cudaStream_t stream;
};

// the 16-bit types the tensor-core kernels take
template <typename T>
constexpr bool kMmaType =
    std::is_same<T, bf16>::value || std::is_same<T, __half>::value;

template <int D, typename Kernel>
int set_mma_smem(Kernel kernel) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      mma_smem_bytes<D>()));
}

template <typename T, int D>
int launch_dq(const Args& a) {
  if constexpr (kMmaType<T>) {
    const dim3 grid((a.s + kMmaTileRows - 1) / kMmaTileRows,
                    a.batch * a.heads);
    const int err = set_mma_smem<D>(flash_bwd_dq_mma_kernel<T, D>);
    if (err != 0) return err;
    flash_bwd_dq_mma_kernel<T, D><<<grid, kMmaThreads, mma_smem_bytes<D>(),
                                 a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<const float*>(a.kv_mask), static_cast<T*>(a.dq),
        a.heads, a.s, a.kv_len, a.st, a.scale, a.causal, a.q_offset,
        a.keep_bits, a.keep_words, a.inv_keep);
    return static_cast<int>(cudaGetLastError());
  } else {
    // fp32: the scalar design
    const dim3 grid((a.s + kDqRows - 1) / kDqRows, a.batch * a.heads);
    flash_bwd_dq_kernel<T, D><<<grid, kDqRows * (D / kEpt), 0, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<const float*>(a.kv_mask), static_cast<T*>(a.dq),
        a.heads, a.s, a.kv_len, a.st, a.scale, a.causal, a.q_offset,
        a.keep_bits, a.keep_words, a.inv_keep);
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename T, int D>
int launch_dkv(const Args& a) {
  if constexpr (kMmaType<T>) {
    const dim3 grid((a.kv_len + kMmaTileRows - 1) / kMmaTileRows,
                    a.batch * a.heads);
    const int err = set_mma_smem<D>(flash_bwd_dkv_mma_kernel<T, D>);
    if (err != 0) return err;
    flash_bwd_dkv_mma_kernel<T, D><<<grid, kMmaThreads, mma_smem_bytes<D>(),
                                  a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<const float*>(a.kv_mask), static_cast<T*>(a.dk),
        static_cast<T*>(a.dv), a.heads, a.s, a.kv_len, a.st, a.scale,
        a.causal, a.q_offset, a.keep_bits, a.keep_words, a.inv_keep);
    return static_cast<int>(cudaGetLastError());
  } else {
    // fp32: the scalar design
    const dim3 grid((a.kv_len + kKvKeys - 1) / kKvKeys, a.batch * a.heads);
    flash_bwd_dkv_kernel<T, D><<<grid, kKvKeys * (D / kEpt), 0, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<const float*>(a.kv_mask), static_cast<T*>(a.dk),
        static_cast<T*>(a.dv), a.heads, a.s, a.kv_len, a.st, a.scale,
        a.causal, a.q_offset, a.keep_bits, a.keep_words, a.inv_keep);
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename T, int D, int NW>
int launch_fused_mma(const Args& a) {
  const int bytes = static_cast<int>(fused_mma_smem_bytes(D, a.s, a.kv_len));
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_fused_mma_kernel<T, D, NW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_fused_mma_kernel<T, D, NW><<<a.batch * a.heads, 32 * NW, bytes,
                                      a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<const float*>(a.kv_mask), static_cast<T*>(a.dq),
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.heads, a.s,
      a.kv_len, a.st, a.scale, a.causal, a.q_offset, a.keep_bits,
      a.keep_words,
      a.inv_keep);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_fused(const Args& a) {
  if constexpr (kMmaType<T>) {
    return fused_rows(a.s) > kFusedNarrowRows ? launch_fused_mma<T, D, 8>(a)
                                               : launch_fused_mma<T, D, 4>(a);
  } else {
    // fp32: the scalar design
    const size_t bytes = sizeof(float) * fused_smem_floats(D, a.s, a.kv_len);
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_fused_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_bwd_fused_kernel<T, D><<<a.batch * a.heads, kFusedThreads, bytes,
                                   a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<const float*>(a.kv_mask), static_cast<T*>(a.dq),
        static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.heads, a.s,
        a.kv_len, a.st, a.scale, a.causal, a.q_offset, a.keep_bits,
      a.keep_words,
      a.inv_keep);
    return static_cast<int>(cudaGetLastError());
  }
}

enum Which { kDq = 0, kDkv = 1, kFused = 2 };

template <typename T, int D>
int launch(int which, const Args& a) {
  if (which == kDq) return launch_dq<T, D>(a);
  if (which == kDkv) return launch_dkv<T, D>(a);
  return launch_fused<T, D>(a);
}

}  // namespace

// Shared memory (bytes) B3 needs for one b·h at these sizes, for dtype
// 0 = float32 (the scalar kernel), 1 = bfloat16 or 2 = float16 (the
// tensor-core one);
// the wrapper dispatches to B3 only when it is at most the 232,448 bytes
// a Hopper block may have.
extern "C" int64_t ds_flash_attention_bwd_fused_smem(int dtype, int head_dim,
                                                     int s, int kv_len) {
  if (dtype == 1 || dtype == 2)
    return fused_mma_smem_bytes(head_dim, s, kv_len);
  return static_cast<int64_t>(sizeof(float)) *
         fused_smem_floats(head_dim, s, kv_len);
}

// which: 0 = B2a (writes dq), 1 = B2b (writes dk, dv), 2 = B3 (all three).
// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  q, k, v, dout are
// [b, s|kv_len, h, d]
// of that dtype with the last dim contiguous; `strides` points to 18
// host int64 element strides: (batch, seq, head) of q, k, v, dout, dq and
// of dk/dv (which share them).  lse and delta are contiguous fp32
// [b·h, s]; kv_mask is [batch, kv_len] fp32 or null; `keep_bits` null (no
// dropout) or B4's packed keep mask of the forward (flash_dropout.cu),
// contiguous int32 [b·h, s, keep_words] words with keep_words =
// ceil(kv_len/32), and `inv_keep` the dropout scale.  `q_offset` is the
// global row of q's row 0 (a sequence-parallel chunk against the
// gathered keys, whose dk/dv are that chunk's partials): under `causal`
// row i sees keys 0 .. q_offset + i.  Launches on `stream`, does not
// synchronise, allocates nothing, and returns the CUDA error.
extern "C" int ds_flash_attention_bwd(
    int which, int dtype, int head_dim, const void* q, const void* k,
    const void* v, const void* dout, const void* lse, const void* delta,
    const void* kv_mask, void* dq, void* dk, void* dv, int batch, int heads,
    int s, int kv_len, const int64_t* strides, float scale, int causal,
    int q_offset, const void* keep_bits, int keep_words, float inv_keep,
    void* stream) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.kv_mask = kv_mask;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.batch = batch;
  a.heads = heads;
  a.s = s;
  a.kv_len = kv_len;
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
  a.q_offset = q_offset;
  a.keep_bits = static_cast<const uint32_t*>(keep_bits);
  a.keep_words = keep_words;
  a.inv_keep = inv_keep;
  a.stream = static_cast<cudaStream_t>(stream);
  if (which < kDq || which > kFused) return cudaErrorInvalidValue;
  if (dtype == 0 && head_dim == 64) return launch<float, 64>(which, a);
  if (dtype == 0 && head_dim == 128) return launch<float, 128>(which, a);
  if (dtype == 1 && head_dim == 64) return launch<__nv_bfloat16, 64>(which, a);
  if (dtype == 1 && head_dim == 128)
    return launch<__nv_bfloat16, 128>(which, a);
  if (dtype == 2 && head_dim == 64) return launch<__half, 64>(which, a);
  if (dtype == 2 && head_dim == 128) return launch<__half, 128>(which, a);
  return static_cast<int>(cudaErrorInvalidValue);
}
