// Flash-attention forward for NVIDIA Hopper (built for sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` of
// deepspeed_tpu/ops/transformer/flash_attention.py (:183, launched by
// `_flash_fwd` at :580).  It computes what that kernel computes, without
// dropout: scaled Q·Kᵀ, causal and key-padding masking to NEG_INF, an
// online softmax with fp32 running max, sum and accumulator, the running
// max floored at MAX_FLOOR (a row whose every key is masked gives out = 0
// and lse = MAX_FLOOR), P cast to the storage dtype before the P·V
// product, and out in the storage dtype plus an fp32 logsumexp.
//
// Design.  The TPU runs a grid (b·h, q blocks, k blocks) whose third
// dimension is sequential and carries m, l and acc in VMEM scratch.  Here
// one thread block owns one (b·h, 64-row q tile) and loops over 32-key K/V
// tiles itself; under `causal` the loop stops at the diagonal tile.  Two
// threads share a query row, each holding half of head_dim for q and the
// accumulator in registers; the dot product is completed with one warp
// shuffle, so both threads see the same scores and keep identical m and l.
// K/V tiles are converted to fp32 in shared memory, rows padded so the two
// halves sit in different banks.  The kernel reads q, k and v
// ([b, s, h, d], last dim contiguous) through their strides, so the
// caller's fused-QKV views need no transpose copy, and it masks ragged
// s and kv_len itself (no divisibility requirement).
//
// Bound.  At GPT-2-medium's largest prefill bucket (b=1, h=16, s=1024,
// d=64, causal, bf16) q, k, v and o are 8.4 MB: 2.5 us at 3.35 TB/s.  The
// causal work is 2.15 GFLOP: 2.2 us at 989 TFLOP/s (bf16 tensor cores).
// So one launch is memory-bound at about 2.5 us.
//
// What this simple design leaves on the table.  Every multiply-add runs
// as a scalar fp32 FMA on the CUDA cores (67 TFLOP/s peak, so at least
// 32 us for that shape, before shared-memory traffic), K/V come in by plain
// loads with no overlap of copy and compute, and with 128 threads a block
// the card holds few warps per SM.  Tensor cores (mma.sync, then wgmma),
// TMA or cp.async double buffering and a larger q tile per block are the
// work of a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;    // masked score (NEG_INF on the TPU)
constexpr float kMaxFloor = -1e20f;  // running-max floor (MAX_FLOOR)
constexpr int kBlockQ = 64;          // query rows per thread block
constexpr int kBlockK = 32;          // keys per K/V tile
constexpr int kThreads = 2 * kBlockQ;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v,
                     const float* __restrict__ kv_mask, T* __restrict__ out,
                     float* __restrict__ lse, int heads, int s, int kv_len,
                     int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
                     int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
                     int64_t v_sh, float scale, int causal) {
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
  // causal: rows q0 .. q0+kBlockQ-1 see no key past q0+kBlockQ-1
  const int k_end = causal ? min(kv_len, q0 + kBlockQ) : kv_len;

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
      const bool keep = mask_s[j] > 0.f && (!causal || qi >= k0 + j);
      const float x = keep ? part * scale : kNegInf;
      sc[j] = x;
      tile_max = fmaxf(tile_max, x);
    }

    const float m_new = fmaxf(fmaxf(m, tile_max), kMaxFloor);
    const float corr = expf(m - m_new);
    float p_sum = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const float p = expf(sc[j] - m_new);
      p_sum += p;
      // l sums the fp32 P; the P·V product takes P in the storage dtype
      sc[j] = to_float(from_float<T>(p));
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

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* kv_mask,
           void* out, void* lse, int batch, int heads, int s, int kv_len,
           int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
           int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
           int64_t v_sh, float scale, int causal, cudaStream_t stream) {
  const dim3 grid((s + kBlockQ - 1) / kBlockQ, batch * heads);
  flash_fwd_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(kv_mask),
      static_cast<T*>(out), static_cast<float*>(lse), heads, s, kv_len, q_sb,
      q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the last
// dimension of q, k and v must be contiguous.  kv_mask is [batch, kv_len]
// fp32 (1 keeps a key) or null; out is a contiguous [b, s, h, d] of the
// input dtype and lse a contiguous fp32 [b·h, s].  Launches on `stream`,
// does not synchronise, allocates nothing, and returns cudaGetLastError().
extern "C" int ds_flash_attention_fwd(
    int dtype, int head_dim, const void* q, const void* k, const void* v,
    const void* kv_mask, void* out, void* lse, int batch, int heads, int s,
    int kv_len, int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
    int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
    float scale, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DS_FLASH_LAUNCH(T, D)                                                 \
  return launch<T, D>(q, k, v, kv_mask, out, lse, batch, heads, s, kv_len,   \
                      q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,   \
                      scale, causal, st)
  if (dtype == 0 && head_dim == 64) DS_FLASH_LAUNCH(float, 64);
  if (dtype == 0 && head_dim == 128) DS_FLASH_LAUNCH(float, 128);
  if (dtype == 1 && head_dim == 64) DS_FLASH_LAUNCH(__nv_bfloat16, 64);
  if (dtype == 1 && head_dim == 128) DS_FLASH_LAUNCH(__nv_bfloat16, 128);
#undef DS_FLASH_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
