// Pieces shared by the flash-attention kernels (forward, dq, dk/dv): one
// definition of the masking constant, the dtype conversions and the
// counter-hash dropout, so the three kernels drop bit-identical elements.
// Mirrors paddle_tpu/ops/pallas/flash_attention.py `_keep_mask` and
// paddle_tpu/core/random.py `fmix32`.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fa {

constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// x rounded to the dtype of the pointer's target (the reference's
// .astype(dtype) before a product); the pointer is only a type tag
__device__ __forceinline__ float round_like(float x, const float*) { return x; }
__device__ __forceinline__ float round_like(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// murmur3's 32-bit finalizer (paddle_tpu/core/random.py fmix32)
__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// the batch-head index folded into the seed by its own hash round
__device__ __forceinline__ uint32_t batch_seed(uint32_t seed, int bh) {
  uint32_t b = seed ^ ((uint32_t)bh * 0x85EBCA6Bu);
  b ^= b >> 13;
  return b * 0xC2B2AE35u;
}

// true where dropout keeps attention probability (row, col)
__device__ __forceinline__ bool keep(uint32_t bseed, int row, int col, int sk,
                                     uint32_t keep_thresh) {
  const uint32_t idx = (uint32_t)row * (uint32_t)sk + (uint32_t)col;
  return fmix32((idx * 0x9E3779B1u) ^ bseed) < keep_thresh;
}

}  // namespace fa
