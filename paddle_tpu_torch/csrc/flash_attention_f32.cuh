// The register-blocked f32 products of the kernels' f32 forms (K1 forward,
// K2 dQ, K3 dK/dV), on the CUDA cores as full f32 FMAs. 128 threads as
// ty = tid / 8 (16 row groups) x tx = tid % 8: a thread owns rows ty + 16 i
// (i < 4) of the result. Tiles are row-major in shared memory with rows
// padded by 4 floats, so every read is a float4 that the 8 lanes of a
// quarter-warp either share (A) or take from 8 distinct bank groups (B).
#pragma once

#include <cuda_runtime.h>

namespace fa {

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// st[i][j] = sum_{e < D} A[ty + 16 i][e] * B[tx + 8 j][e]  (A B^T, 4 x NJ a
// thread)
template <int D, int LDA, int LDB, int NJ>
__device__ __forceinline__ void rows_dot_rows(float (&st)[4][NJ], const float* A, const float* B,
                                              int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) st[i][j] = 0.f;
#pragma unroll 2
  for (int e = 0; e < D; e += 4) {
    float4 a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(&A[(ty + 16 * i) * LDA + e]);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float4 b = *reinterpret_cast<const float4*>(&B[(tx + 8 * j) * LDB + e]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        st[i][j] = fmaf(a[i].x, b.x, st[i][j]);
        st[i][j] = fmaf(a[i].y, b.y, st[i][j]);
        st[i][j] = fmaf(a[i].z, b.z, st[i][j]);
        st[i][j] = fmaf(a[i].w, b.w, st[i][j]);
      }
    }
  }
}

// acc[i][4 g + c] += sum_{r < R} A[ty + 16 i][r] * B[r][tx * 4 + 32 g + c]
// (A B, 4 rows x D / 8 columns a thread)
template <int R, int D, int LDA, int LDB>
__device__ __forceinline__ void rows_times_tile(float (&acc)[4][D / 8], const float* A,
                                                const float* B, int ty, int tx) {
#pragma unroll 2
  for (int r = 0; r < R; r += 4) {
    float4 a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(&A[(ty + 16 * i) * LDA + r]);
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const float* brow = B + (r + rr) * LDB + tx * 4;
#pragma unroll
      for (int g = 0; g < D / 32; ++g) {
        const float4 b = *reinterpret_cast<const float4*>(brow + 32 * g);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float x = lane_of(a[i], rr);
          acc[i][4 * g + 0] = fmaf(x, b.x, acc[i][4 * g + 0]);
          acc[i][4 * g + 1] = fmaf(x, b.y, acc[i][4 * g + 1]);
          acc[i][4 * g + 2] = fmaf(x, b.z, acc[i][4 * g + 2]);
          acc[i][4 * g + 3] = fmaf(x, b.w, acc[i][4 * g + 3]);
        }
      }
    }
  }
}

// the 4 x D/8 accumulator of rows_times_tile, times `scale`, stored as
// float4s at rows row0 + ty + 16 i (those below n_rows) of a [*, D] array
template <int D>
__device__ __forceinline__ void store_rows(float* out, const float (&acc)[4][D / 8], float scale,
                                           int row0, int n_rows, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row < n_rows) {
#pragma unroll
      for (int g = 0; g < D / 32; ++g)
        *reinterpret_cast<float4*>(&out[(size_t)row * D + tx * 4 + 32 * g]) =
            make_float4(acc[i][4 * g] * scale, acc[i][4 * g + 1] * scale,
                        acc[i][4 * g + 2] * scale, acc[i][4 * g + 3] * scale);
    }
  }
}

}  // namespace fa
