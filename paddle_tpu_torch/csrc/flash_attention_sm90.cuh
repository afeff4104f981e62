// Hopper building blocks of the redesigned flash-attention kernels (K1
// forward, K2 dQ, K3 dK/dV): 16- and 4-byte cp.async staging into shared
// memory, ldmatrix fragment loads and the m16n8k16 bf16 tensor-core product
// with f32 accumulators, as inline PTX for sm_90a.
//
// Fragment layouts of mma.sync.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major): a0 = (g, 2t..2t+1), a1 = (g + 8, 2t..),
//                           a2 = (g, 2t + 8..), a3 = (g + 8, 2t + 8..)
//   B (16 x 8, k x n):      b0 = (k 2t..2t+1, n g), b1 = (k 2t + 8.., n g)
//   C (16 x 8, f32):        c0, c1 = (g, 2t..2t+1), c2, c3 = (g + 8, 2t..)
// so a C fragment of two neighbouring n8 tiles, rounded to bf16 and packed
// in pairs, is the A fragment of the next product over those 16 columns.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fa {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; ok = false zero-fills them
// (src-size 0 reads nothing, so src only has to be some valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, asynchronous; ok = false zero-fills them
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// the same, each matrix transposed on the way into registers
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// d += a * b on the tensor cores: bf16 inputs, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// e^x as one ex2.approx of x * log2(e) (__expf): at most 2 + 1.16 |x| ulp
// from expf, so below 2e-6 relative wherever p = e^(s - m) is above
// e^-16, far inside the kernels' 1e-4 (f32) tolerance; accurate expf's
// range reduction sat on the softmax's critical path (PERF.md, PR 3)
__device__ __forceinline__ float fast_exp(float x) { return __expf(x); }

// call cudaFuncSetAttribute(kern, MaxDynamicSharedMemorySize) once per
// kernel instance (the static lives in the caller's template instance)
#define FA_OPT_IN_SMEM_ONCE(kern, bytes)                                            \
  do {                                                                              \
    static const cudaError_t fa_attr_err_ = cudaFuncSetAttribute(                   \
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)); \
    if (fa_attr_err_ != cudaSuccess) return fa_attr_err_;                           \
  } while (0)

}  // namespace fa
