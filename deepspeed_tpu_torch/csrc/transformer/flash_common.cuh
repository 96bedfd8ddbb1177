// Shared by the flash-attention kernels (B1 flash_attention_fwd.cu; B2a,
// B2b and B3 flash_attention_bwd.cu; B5 and B6 under sparse_attention/):
// storage-type conversions, the masking constants of
// deepspeed_tpu/ops/transformer/flash_attention.py, and the tile steps of
// the block-sparse kernels.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace ds_flash {

constexpr float kNegInf = -1e30f;    // masked score (NEG_INF on the TPU)
constexpr float kMaxFloor = -1e20f;  // running-max floor (MAX_FLOOR)

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
}

// x rounded through the storage type T (the TPU's `.astype(dtype)`)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// Sum over the N neighbouring lanes that share a row (N a power of two
// up to 32).  A butterfly: every lane ends with the same bits, since each
// step adds two equal partial sums in either order and IEEE addition
// commutes.
template <int N>
__device__ __forceinline__ float lane_sum(float x) {
#pragma unroll
  for (int m = 1; m < N; m <<= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

// ------------------------------------------------------------------------
// Tile steps of the block-sparse kernels (B5 sparse_attention/
// flash_block_sparse.cu, B6 sparse_attention/flash_block_sparse_agg.cu).
// A block owns 64 output rows (queries, or keys) and streams the other
// side in kSpTile-row tiles through shared memory, as fp32.  The TPR
// threads that share an output row each hold SEG consecutive values of
// head_dim in registers and close every dot product with lane_sum<TPR>.
// A tile row is TPR segments of SEG values, each padded by 4 floats so
// that neighbouring threads read other banks.  `vis(j)` says whether
// element j of the tile is visible to the thread's row; the kernels
// differ only in that predicate and in which tiles they walk.

constexpr int kSpTile = 32;

template <int TPR, int SEG>
struct SpTile {
  static constexpr int kRow = TPR * (SEG + 4);  // padded tile row, floats
  static constexpr int kFloats = kSpTile * kRow;
};

// N consecutive values of a row into registers as fp32 (zero when the
// row is past the end).
template <typename T, int N>
__device__ __forceinline__ void load_seg(float (&dst)[N], const T* src,
                                         bool valid) {
#pragma unroll
  for (int e = 0; e < N; ++e) dst[e] = valid ? to_float(src[e]) : 0.f;
}

// Rows r0 .. r0+kSpTile-1 of two [*, D] tensors (row strides a_row and
// b_row, elements) into a_s and b_s; rows at or past `lim` are zero.
template <typename T, int TPR, int SEG>
__device__ __forceinline__ void load_tile_pair(float* a_s, float* b_s,
                                               const T* a, int64_t a_row,
                                               const T* b, int64_t b_row,
                                               int r0, int lim, int tid,
                                               int threads) {
  constexpr int D = TPR * SEG;
  for (int e = tid; e < kSpTile * D; e += threads) {
    const int j = e / D;
    const int d = e - j * D;
    const int r = r0 + j;
    const int dst = j * SpTile<TPR, SEG>::kRow + (d / SEG) * (SEG + 4) +
                    (d % SEG);
    float x = 0.f, y = 0.f;
    if (r < lim) {
      x = to_float(a[(int64_t)r * a_row + d]);
      y = to_float(b[(int64_t)r * b_row + d]);
    }
    a_s[dst] = x;
    b_s[dst] = y;
  }
}

// Forward: one key tile of the online softmax for the thread's query
// row (q segment qr, accumulator acc, running max m and sum l).  Masked
// scores are NEG_INF and the max is floored at MAX_FLOOR, so a tile the
// row sees nothing of leaves m, l and acc as they were; P is rounded to
// the storage type before P·V.
template <typename T, int TPR, int SEG, typename Vis>
__device__ __forceinline__ void sparse_fwd_tile(const float* k_s,
                                                const float* v_s, int seg,
                                                const float (&qr)[SEG],
                                                float (&acc)[SEG], float& m,
                                                float& l, float scale,
                                                Vis vis) {
  constexpr int ROW = SpTile<TPR, SEG>::kRow;
  float sc[kSpTile];
  float tile_max = kNegInf;
#pragma unroll
  for (int j = 0; j < kSpTile; ++j) {
    const float4* kr =
        reinterpret_cast<const float4*>(k_s + j * ROW + seg * (SEG + 4));
    float part = 0.f;
#pragma unroll
    for (int d4 = 0; d4 < SEG / 4; ++d4) {
      const float4 kk = kr[d4];
      part = fmaf(qr[4 * d4 + 0], kk.x, part);
      part = fmaf(qr[4 * d4 + 1], kk.y, part);
      part = fmaf(qr[4 * d4 + 2], kk.z, part);
      part = fmaf(qr[4 * d4 + 3], kk.w, part);
    }
    part = lane_sum<TPR>(part);
    const float x = vis(j) ? part * scale : kNegInf;
    sc[j] = x;
    tile_max = fmaxf(tile_max, x);
  }
  const float m_new = fmaxf(fmaxf(m, tile_max), kMaxFloor);
  const float corr = expf(m - m_new);
  float p_sum = 0.f;
#pragma unroll
  for (int j = 0; j < kSpTile; ++j) {
    const float p = expf(sc[j] - m_new);
    p_sum += p;
    sc[j] = round_to<T>(p);  // P in the storage type for P·V
  }
  l = l * corr + p_sum;
  m = m_new;
#pragma unroll
  for (int d = 0; d < SEG; ++d) acc[d] *= corr;
#pragma unroll
  for (int j = 0; j < kSpTile; ++j) {
    const float4* vr =
        reinterpret_cast<const float4*>(v_s + j * ROW + seg * (SEG + 4));
    const float p = sc[j];
#pragma unroll
    for (int d4 = 0; d4 < SEG / 4; ++d4) {
      const float4 vv = vr[d4];
      acc[4 * d4 + 0] = fmaf(p, vv.x, acc[4 * d4 + 0]);
      acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
      acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
      acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
    }
  }
}

// dq: one key tile for the thread's query row.  P = exp(S − lse) over
// the visible keys, dS = P∘(dP − Δ) rounded to the storage type, dq +=
// dS·K (1/√d is applied at the end by the caller).
template <typename T, int TPR, int SEG, typename Vis>
__device__ __forceinline__ void sparse_dq_tile(
    const float* k_s, const float* v_s, int seg, const float (&qr)[SEG],
    const float (&dor)[SEG], float (&acc)[SEG], float lse_i, float delta_i,
    float scale, Vis vis) {
  constexpr int ROW = SpTile<TPR, SEG>::kRow;
#pragma unroll 4
  for (int j = 0; j < kSpTile; ++j) {
    const float4* kr =
        reinterpret_cast<const float4*>(k_s + j * ROW + seg * (SEG + 4));
    const float4* vr =
        reinterpret_cast<const float4*>(v_s + j * ROW + seg * (SEG + 4));
    float sp = 0.f, dp = 0.f;
#pragma unroll
    for (int d4 = 0; d4 < SEG / 4; ++d4) {
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
    const float p = expf((vis(j) ? sp * scale : kNegInf) - lse_i);
    const float ds = round_to<T>(p * (dp - delta_i));
#pragma unroll
    for (int d4 = 0; d4 < SEG / 4; ++d4) {
      const float4 kk = kr[d4];
      acc[4 * d4 + 0] = fmaf(ds, kk.x, acc[4 * d4 + 0]);
      acc[4 * d4 + 1] = fmaf(ds, kk.y, acc[4 * d4 + 1]);
      acc[4 * d4 + 2] = fmaf(ds, kk.z, acc[4 * d4 + 2]);
      acc[4 * d4 + 3] = fmaf(ds, kk.w, acc[4 * d4 + 3]);
    }
  }
}

// dk, dv: one query tile (Q, dO, and each row's lse and Δ) for the
// thread's key.  dk += dS·Q (1/√d by the caller), dv += P·dO with P
// rounded to the storage type.
template <typename T, int TPR, int SEG, typename Vis>
__device__ __forceinline__ void sparse_dkv_tile(
    const float* q_s, const float* o_s, const float* lse_s,
    const float* delta_s, int seg, const float (&kr)[SEG],
    const float (&vr)[SEG], float (&dka)[SEG], float (&dva)[SEG],
    float scale, Vis vis) {
  constexpr int ROW = SpTile<TPR, SEG>::kRow;
#pragma unroll 4
  for (int r = 0; r < kSpTile; ++r) {
    const float4* qv =
        reinterpret_cast<const float4*>(q_s + r * ROW + seg * (SEG + 4));
    const float4* ov =
        reinterpret_cast<const float4*>(o_s + r * ROW + seg * (SEG + 4));
    float sp = 0.f, dp = 0.f;
#pragma unroll
    for (int d4 = 0; d4 < SEG / 4; ++d4) {
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
    const float p = expf((vis(r) ? sp * scale : kNegInf) - lse_s[r]);
    const float ds = round_to<T>(p * (dp - delta_s[r]));
    const float pr = round_to<T>(p);
#pragma unroll
    for (int d4 = 0; d4 < SEG / 4; ++d4) {
      const float4 qq = qv[d4];
      const float4 oo = ov[d4];
      dka[4 * d4 + 0] = fmaf(ds, qq.x, dka[4 * d4 + 0]);
      dka[4 * d4 + 1] = fmaf(ds, qq.y, dka[4 * d4 + 1]);
      dka[4 * d4 + 2] = fmaf(ds, qq.z, dka[4 * d4 + 2]);
      dka[4 * d4 + 3] = fmaf(ds, qq.w, dka[4 * d4 + 3]);
      dva[4 * d4 + 0] = fmaf(pr, oo.x, dva[4 * d4 + 0]);
      dva[4 * d4 + 1] = fmaf(pr, oo.y, dva[4 * d4 + 1]);
      dva[4 * d4 + 2] = fmaf(pr, oo.z, dva[4 * d4 + 2]);
      dva[4 * d4 + 3] = fmaf(pr, oo.w, dva[4 * d4 + 3]);
    }
  }
}

// lse and Δ of query rows r0 .. r0+kSpTile-1 of batch·head bh into
// shared memory, zero past `lim`; threads 0 .. kSpTile-1 do it.
__device__ __forceinline__ void load_row_stats(float* lse_s, float* delta_s,
                                               const float* lse,
                                               const float* delta,
                                               int64_t row0, int r0, int lim,
                                               int tid) {
  if (tid < kSpTile) {
    const int i = r0 + tid;
    lse_s[tid] = i < lim ? lse[row0 + i] : 0.f;
    delta_s[tid] = i < lim ? delta[row0 + i] : 0.f;
  }
}

}  // namespace ds_flash
