// Pieces shared by the flash-attention kernels (forward, dq, dk/dv): one
// definition of the masking constant, the causal k-tile count and the
// counter-hash dropout, so the three kernels drop bit-identical elements.
// Mirrors paddle_tpu/ops/pallas/flash_attention.py `_keep_mask` and
// paddle_tpu/core/random.py `fmix32`.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fa {

constexpr float NEG_INF = -1e30f;

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

// the number of BK-key tiles a BQ-row q tile starting at q0 reads: causal
// tiles past the last key any of its rows attends to (bottom-right mask,
// row r sees keys <= r + sk - sq) are skipped
template <int BQ, int BK>
__device__ __forceinline__ int k_tiles(int q0, int sq, int sk, int causal) {
  int n_kt = (sk + BK - 1) / BK;
  if (causal) {
    const int last_col = q0 + BQ - 1 + (sk - sq);
    n_kt = min(n_kt, last_col < 0 ? 0 : last_col / BK + 1);
  }
  return n_kt;
}

// true where dropout keeps attention probability (row, col)
__device__ __forceinline__ bool keep(uint32_t bseed, int row, int col, int sk,
                                     uint32_t keep_thresh) {
  const uint32_t idx = (uint32_t)row * (uint32_t)sk + (uint32_t)col;
  return fmix32((idx * 0x9E3779B1u) ^ bseed) < keep_thresh;
}

}  // namespace fa
