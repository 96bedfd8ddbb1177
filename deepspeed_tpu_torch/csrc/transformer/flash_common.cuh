// Shared by the flash-attention kernels (B1 flash_attention_fwd.cu; B2a,
// B2b and B3 flash_attention_bwd.cu): storage-type conversions and the
// masking constants of deepspeed_tpu/ops/transformer/flash_attention.py.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace ds_flash {

constexpr float kNegInf = -1e30f;    // masked score (NEG_INF on the TPU)
constexpr float kMaxFloor = -1e20f;  // running-max floor (MAX_FLOOR)

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

template <int N>
__device__ __forceinline__ uint32_t lane_or(uint32_t x) {
#pragma unroll
  for (int m = 1; m < N; m <<= 1) x |= __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

}  // namespace ds_flash
