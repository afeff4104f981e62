// Flash-attention backward, dQ, for Hopper (sm_90a), plain C interface for
// ctypes.
//
// Replaces the Pallas TPU kernel `_bwd_dq_kernel` (pallas_call in `_bwd`) of
// paddle_tpu/ops/pallas/flash_attention.py. It computes the same thing from
// the forward's saved LSE and delta = rowsum(dO * O) (computed before the
// launch, as the reference does): S = Q K^T * scale with the bottom-right
// causal mask (offset = sk - sq, masked entries NEG_INF), P = exp(S - LSE)
// zeroed where S is masked (a fully masked row has LSE ~= NEG_INF),
// dP = dO V^T dropped and rescaled by the counter hash of the forward,
// dS = P * (dP - delta) rounded to the input dtype, dQ = scale * dS K.
//
// What bounds it on an H100: 6*sq*sk*d operations (three products) against
// (3*sq + 2*sk)*d elements plus 2*sq floats of traffic per head, so at the
// BERT-base training shape ([768, 128, 64]) the f32 form is bound by
// operations (67 TFLOP/s outside the tensor cores) and the bf16 form by
// bytes (3.35 TB/s). What the design does about it: S, P, dP and dS never
// leave the block, Q and dO are read once per block and K/V once per
// (block, k tile), and dQ has its own kernel so it is written once, without
// atomics: the result is the same run to run. Products run as f32 FMAs on
// the CUDA cores out of padded shared memory (no bank conflicts); bf16
// inputs are widened to f32, where their products are exact. Tensor cores
// and TMA are left for a later change.
//
// Layout: one block per (batch*head, 64-row q tile), 256 threads as 16 x 16.
// The TPU kernel's sequential k grid axis becomes a loop inside the block
// that stops at the last k tile a causal q tile needs (`_causal_last_kb`).
// Each thread owns 4 rows x 4 key columns of S/dP/dS and 4 rows x d/16
// columns of the f32 dQ accumulator, kept in registers and scaled once at
// the end. K and V are stored transposed ([d][64 + 1]): the same array
// serves S = Q K^T and dQ = dS K without conflicts.
#include "flash_attention_common.cuh"

namespace {

using fa::NEG_INF;
using fa::round_like;
using fa::store_out;
using fa::to_f32;

constexpr int BQ = 64;        // q rows per block
constexpr int BK = 64;        // keys per k tile
constexpr int THREADS = 256;  // 16 x 16
constexpr int RPT = BQ / 16;  // rows per thread
constexpr int CPT = BK / 16;  // key columns per thread

template <int D>
constexpr size_t smem_floats() {
  return 2 * (size_t)BQ * (D + 1)   // Q, dO rows
         + 2 * (size_t)D * (BK + 1) // K^T, V^T
         + (size_t)BQ * (BK + 1)    // dS
         + 2 * (size_t)BQ;          // LSE, delta
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, T* __restrict__ dq, int sq, int sk, float scale,
          int causal, int dropout, uint32_t seed, uint32_t keep_thresh, float inv_keep) {
  extern __shared__ float smem[];
  constexpr int QS = D + 1;    // Q / dO row stride
  constexpr int KS = BK + 1;   // K^T / V^T row stride
  constexpr int SS = BK + 1;   // dS row stride
  constexpr int DPT = D / 16;  // dQ columns per thread
  float* Qs = smem;            // [BQ][QS]
  float* dOs = Qs + BQ * QS;   // [BQ][QS]
  float* Kt = dOs + BQ * QS;   // [D][KS]
  float* Vt = Kt + D * KS;     // [D][KS]
  float* dSs = Vt + D * KS;    // [BQ][SS]
  float* lse_s = dSs + BQ * SS;
  float* delta_s = lse_s + BQ;

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
    const bool ok = q0 + r < sq;
    const size_t g = qbase + (size_t)(q0 + r) * D + c;
    Qs[r * QS + c] = ok ? to_f32(q[g]) : 0.f;
    dOs[r * QS + c] = ok ? to_f32(dout[g]) : 0.f;
  }
  if (tid < BQ) {
    const bool ok = q0 + tid < sq;
    lse_s[tid] = ok ? lse[(size_t)bh * sq + q0 + tid] : 0.f;
    delta_s[tid] = ok ? delta[(size_t)bh * sq + q0 + tid] : 0.f;
  }
  const uint32_t bseed = fa::batch_seed(seed, bh);

  float acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;

  int n_kt = (sk + BK - 1) / BK;
  if (causal) {
    const int last_col = q0 + BQ - 1 + offset;
    n_kt = min(n_kt, last_col < 0 ? 0 : last_col / BK + 1);
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's reads of Kt/Vt/dSs are done
    for (int i = tid; i < BK * D; i += THREADS) {
      const int c = i / D, dd = i % D;
      const bool ok = k0 + c < sk;
      const size_t g = kbase + (size_t)(k0 + c) * D + dd;
      Kt[dd * KS + c] = ok ? to_f32(k[g]) : 0.f;
      Vt[dd * KS + c] = ok ? to_f32(v[g]) : 0.f;
    }
    __syncthreads();

    float s[RPT][CPT], dp[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int e = 0; e < D; ++e) {
      float qa[RPT], da[RPT], kb[CPT], vb[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        qa[i] = Qs[(ty + 16 * i) * QS + e];
        da[i] = dOs[(ty + 16 * i) * QS + e];
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        kb[j] = Kt[e * KS + tx + 16 * j];
        vb[j] = Vt[e * KS + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
          dp[i][j] = fmaf(da[i], vb[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty + 16 * i;
      const int row = q0 + r;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (col >= sk || row >= sq || (causal && row + offset < col)) x = NEG_INF;
        const float p = (x == NEG_INF) ? 0.f : expf(x - lse_s[r]);
        float dpv = dp[i][j];
        if (dropout) dpv = fa::keep(bseed, row, col, sk, keep_thresh) ? dpv * inv_keep : 0.f;
        dSs[r * SS + tx + 16 * j] = round_like(p * (dpv - delta_s[r]), k);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float ds[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) ds[i] = dSs[(ty + 16 * i) * SS + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const float kv = Kt[(tx + 16 * j) * KS + c];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][j] = fmaf(ds[i], kv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < sq) {
#pragma unroll
      for (int j = 0; j < DPT; ++j)
        store_out(&dq[qbase + (size_t)row * D + tx + 16 * j], acc[i][j] * scale);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dq, int bh, int sq, int sk,
                   float scale, int causal, int dropout, uint32_t seed, uint32_t keep_thresh,
                   float inv_keep, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  auto kern = dq_kernel<T, D>;
  // above 48 KB a block's shared memory has to be opted into
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (sq + BQ - 1) / BQ);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), sq, sk, scale, causal, dropout,
      seed, keep_thresh, inv_keep);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q/dout/dq [bh, sq, d], k/v [bh, sk, d] contiguous in one dtype (0 =
// float32, 1 = bfloat16); lse and delta [bh, sq] float32. Returns the
// cudaError_t of the launch (0 = success); cudaErrorInvalidValue for a
// head_dim or dtype this kernel does not take.
int flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, void* dq, int bh, int sq,
                           int sk, int d, float scale, int causal, int dropout,
                           unsigned int seed, unsigned int keep_thresh, float inv_keep,
                           int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && d == 64)
    return launch<float, 64>(q, k, v, dout, lse, delta, dq, bh, sq, sk, scale, causal,
                             dropout, seed, keep_thresh, inv_keep, st);
  if (dtype == 0 && d == 128)
    return launch<float, 128>(q, k, v, dout, lse, delta, dq, bh, sq, sk, scale, causal,
                              dropout, seed, keep_thresh, inv_keep, st);
  if (dtype == 1 && d == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, dq, bh, sq, sk, scale,
                                     causal, dropout, seed, keep_thresh, inv_keep, st);
  if (dtype == 1 && d == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, dq, bh, sq, sk, scale,
                                      causal, dropout, seed, keep_thresh, inv_keep, st);
  return (int)cudaErrorInvalidValue;
}

// dynamic shared memory of one block for head_dim d (either dtype), or -1
int flash_attention_bwd_dq_smem_bytes(int d) {
  if (d == 64) return (int)(smem_floats<64>() * sizeof(float));
  if (d == 128) return (int)(smem_floats<128>() * sizeof(float));
  return -1;
}

const char* flash_attention_bwd_dq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
