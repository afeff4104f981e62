// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` / `_fwd` in
// paddle_tpu/ops/pallas/flash_attention.py. It computes the same thing:
// S = Q K^T * scale with f32 accumulation, an optional bottom-right causal
// mask (offset = sk - sq, masked entries NEG_INF = -1e30), the online
// softmax whose running sum l takes the UNDROPPED p while the output
// accumulator takes the counter-hash dropped and rescaled p, O = 0 for a
// fully masked row, and LSE = m + log(max(l, 1e-30)).
//
// What bounds it on an H100: the work is 4*sq*sk*d operations against
// (sq + 2*sk)*d elements of traffic per head, so at BERT-base serving shapes
// (d = 64, s = 128..512) the f32 form is bound by operations (67 TFLOP/s
// outside the tensor cores) and the bf16 form by bytes (3.35 TB/s).
// What the design does about it: S and P never leave the block (no S^2
// traffic), every Q/K/V element is read from device memory once per
// q-tile, and the FMA loops run out of padded shared memory so reads are
// free of bank conflicts. f32 runs in full f32 (no TF32), matching
// torch.backends.cuda.matmul.allow_tf32 = False; bf16 inputs are widened
// to f32, where a bf16 x bf16 product is exact, so it multiplies as bf16
// with f32 accumulation. Tensor-core (mma/wgmma) and TMA staging are left
// for a later change: this kernel runs on the CUDA cores.
//
// The TPU kernel's sequential k grid axis and VMEM scratch become a loop
// inside one block: one block per (batch*head, 64-row q tile), 256 threads
// as 16 x 16, each thread owning 4 rows x 4 key columns of S and 4 rows x
// d/16 columns of O. The running max and sum are kept per row in registers
// (each of the 16 threads of a row holds the same copy after a shuffle
// reduction). Ragged sequence lengths are masked here; causal k tiles past
// the last one a q tile needs are skipped.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;        // q rows per block
constexpr int BK = 64;        // keys per k tile
constexpr int THREADS = 256;  // 16 x 16
constexpr int RPT = BQ / 16;  // rows per thread
constexpr int CPT = BK / 16;  // S columns per thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// P is cast to V's dtype before the PV product, as the reference's
// p.astype(v.dtype) does
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

template <int D>
constexpr size_t smem_floats() {
  return (size_t)BQ * (D + 1) + (size_t)D * (BK + 1) + (size_t)BK * D + (size_t)BQ * (BK + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           T* __restrict__ o, float* __restrict__ lse, int sq, int sk, float scale,
           int causal, int dropout, uint32_t seed, uint32_t keep_thresh, float inv_keep) {
  extern __shared__ float smem[];
  constexpr int QS = D + 1;   // Q row stride (padding: two rows per warp hit two banks)
  constexpr int KS = BK + 1;  // K^T row stride (transposed store without conflicts)
  constexpr int PS = BK + 1;  // P row stride
  constexpr int DPT = D / 16; // O columns per thread
  float* Qs = smem;           // [BQ][QS]
  float* Kt = Qs + BQ * QS;   // [D][KS]
  float* Vs = Kt + D * KS;    // [BK][D]
  float* Ps = Vs + BK * D;    // [BQ][PS]

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const size_t qbase = (size_t)bh * sq * D;
  const size_t kbase = (size_t)bh * sk * D;
  const int offset = sk - sq;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    Qs[r * QS + c] = (q0 + r < sq) ? to_f32(q[qbase + (size_t)(q0 + r) * D + c]) : 0.f;
  }

  // per batch-head seed round of _keep_mask
  uint32_t bseed = seed ^ ((uint32_t)bh * 0x85EBCA6Bu);
  bseed ^= bseed >> 13;
  bseed *= 0xC2B2AE35u;

  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  int n_kt = (sk + BK - 1) / BK;
  if (causal) {
    // last key column any row of this tile attends to; later tiles are
    // fully masked for every row here and are skipped
    const int last_col = q0 + BQ - 1 + offset;
    n_kt = min(n_kt, last_col < 0 ? 0 : last_col / BK + 1);
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's reads of Kt/Vs/Ps are done
    for (int i = tid; i < BK * D; i += THREADS) {
      const int c = i / D, dd = i % D;
      const bool ok = k0 + c < sk;
      const size_t g = kbase + (size_t)(k0 + c) * D + dd;
      Kt[dd * KS + c] = ok ? to_f32(k[g]) : 0.f;
      Vs[c * D + dd] = ok ? to_f32(v[g]) : 0.f;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int e = 0; e < D; ++e) {
      float qa[RPT], kb[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qa[i] = Qs[(ty + 16 * i) * QS + e];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kb[j] = Kt[e * KS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (col >= sk || (causal && row + offset < col)) x = NEG_INF;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = k0 + tx + 16 * j;
        // masked entries give p = 0 even in a fully masked row, where
        // m_new is NEG_INF and exp(s - m_new) would be 1
        float p = (s[i][j] == NEG_INF) ? 0.f : expf(s[i][j] - m_new);
        psum += p;
        if (dropout) {
          const uint32_t idx = (uint32_t)row * (uint32_t)sk + (uint32_t)col;
          const uint32_t h = fmix32((idx * 0x9E3779B1u) ^ bseed);
          p = (h < keep_thresh) ? p * inv_keep : 0.f;
        }
        s[i][j] = round_like(p, v);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[i] = l[i] * alpha + psum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= alpha;
#pragma unroll
      for (int j = 0; j < CPT; ++j) Ps[(ty + 16 * i) * PS + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = Ps[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const float vv = Vs[c * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < sq) {
      const float ll = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int j = 0; j < DPT; ++j)
        store_out(&o[qbase + (size_t)row * D + tx + 16 * j], acc[i][j] / ll);
      if (tx == 0) lse[(size_t)bh * sq + row] = m[i] + logf(ll);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                   int sq, int sk, float scale, int causal, int dropout, uint32_t seed,
                   uint32_t keep_thresh, float inv_keep, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  auto kern = fwd_kernel<T, D>;
  // above 48 KB a block's shared memory has to be opted into
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (sq + BQ - 1) / BQ);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), sq, sk, scale, causal, dropout, seed,
      keep_thresh, inv_keep);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q [bh, sq, d], k/v [bh, sk, d] contiguous, dtype 0 = float32, 1 = bfloat16;
// o [bh, sq, d] in the input dtype, lse [bh, sq] float32. Returns the
// cudaError_t of the launch (0 = success); cudaErrorInvalidValue for a
// head_dim or dtype this kernel does not take.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                        int bh, int sq, int sk, int d, float scale, int causal, int dropout,
                        unsigned int seed, unsigned int keep_thresh, float inv_keep,
                        int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && d == 64)
    return launch<float, 64>(q, k, v, o, lse, bh, sq, sk, scale, causal, dropout, seed,
                             keep_thresh, inv_keep, st);
  if (dtype == 0 && d == 128)
    return launch<float, 128>(q, k, v, o, lse, bh, sq, sk, scale, causal, dropout, seed,
                              keep_thresh, inv_keep, st);
  if (dtype == 1 && d == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, lse, bh, sq, sk, scale, causal, dropout,
                                     seed, keep_thresh, inv_keep, st);
  if (dtype == 1 && d == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, lse, bh, sq, sk, scale, causal, dropout,
                                      seed, keep_thresh, inv_keep, st);
  return (int)cudaErrorInvalidValue;
}

// dynamic shared memory of one block for head_dim d (either dtype), or -1
int flash_attention_fwd_smem_bytes(int d) {
  if (d == 64) return (int)(smem_floats<64>() * sizeof(float));
  if (d == 128) return (int)(smem_floats<128>() * sizeof(float));
  return -1;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
