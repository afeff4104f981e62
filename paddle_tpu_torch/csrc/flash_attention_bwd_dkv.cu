// Flash-attention backward, dK and dV, for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces the Pallas TPU kernel `_bwd_dkv_kernel` (pallas_call in `_bwd`)
// of paddle_tpu/ops/pallas/flash_attention.py. For one k tile it walks the
// q tiles and computes, from the forward's saved LSE and delta =
// rowsum(dO * O): P = exp(Q K^T * scale - LSE) under the bottom-right causal
// mask (offset = sk - sq; P = 0 where masked), P_dropped = P through the
// forward's counter-hash dropout and rescaled, dV = sum_q P_dropped^T dO
// (P_dropped rounded to dO's dtype first), dP = dO V^T dropped the same way,
// dS = P * (dP - delta) rounded to Q's dtype, dK = scale * sum_q dS^T Q.
// Causal k tiles start at the first q tile with an unmasked row
// (`_causal_first_qb`).
//
// What bounds it on an H100: 8*sq*sk*d operations (four products) against
// (2*sq + 4*sk)*d elements plus 2*sq floats of traffic per head, so at the
// BERT-base training shape ([768, 128, 64]) the f32 form is bound by
// operations (67 TFLOP/s outside the tensor cores) and the bf16 form by
// bytes (3.35 TB/s). What the design does about it: P, dP and dS never
// leave the block, K and V are read once per block and Q/dO once per
// (block, q tile), and the dK/dV accumulators are f32 registers written
// once at the end, without atomics. Products run as f32 FMAs on the CUDA
// cores out of padded shared memory; bf16 inputs are widened to f32, where
// their products are exact. Tensor cores and TMA are left for a later
// change.
//
// Layout: one block per (batch*head, 64-row k tile), 256 threads as 16 x
// 16. Each thread owns 4 key rows x 4 q columns of the transposed tiles
// S^T/dP^T and 4 key rows x d/16 columns of dK and dV. K and V rows stay
// in shared memory for the whole block; Q and dO are stored transposed
// ([d][64 + 1]) so the same arrays serve S^T = K Q^T and dK = dS^T Q. At
// head_dim 128 a block takes 166,400 bytes of shared memory: one block per
// SM, within the 227 KB a block may use.
#include "flash_attention_common.cuh"

namespace {

using fa::NEG_INF;
using fa::round_like;
using fa::store_out;
using fa::to_f32;

constexpr int BQ = 64;        // q rows per q tile
constexpr int BK = 64;        // key rows per block
constexpr int THREADS = 256;  // 16 x 16
constexpr int RPT = BK / 16;  // key rows per thread
constexpr int CPT = BQ / 16;  // q columns per thread

template <int D>
constexpr size_t smem_floats() {
  return 2 * (size_t)BK * (D + 1)    // K, V rows
         + 2 * (size_t)D * (BQ + 1)  // Q^T, dO^T
         + 2 * (size_t)BK * (BQ + 1) // P_dropped^T, dS^T
         + 2 * (size_t)BQ;           // LSE, delta of the q tile
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int sq,
           int sk, float scale, int causal, int dropout, uint32_t seed, uint32_t keep_thresh,
           float inv_keep) {
  extern __shared__ float smem[];
  constexpr int KS = D + 1;    // K / V row stride
  constexpr int TS = BQ + 1;   // Q^T / dO^T / P^T / dS^T row stride
  constexpr int DPT = D / 16;  // dK / dV columns per thread
  float* Ks = smem;            // [BK][KS]
  float* Vs = Ks + BK * KS;    // [BK][KS]
  float* Qt = Vs + BK * KS;    // [D][TS]
  float* dOt = Qt + D * TS;    // [D][TS]
  float* Pt = dOt + D * TS;    // [BK][TS]
  float* dSt = Pt + BK * TS;   // [BK][TS]
  float* lse_s = dSt + BK * TS;
  float* delta_s = lse_s + BQ;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BK;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const size_t qbase = (size_t)bh * sq * D;
  const size_t kbase = (size_t)bh * sk * D;
  const int offset = sk - sq;

  for (int i = tid; i < BK * D; i += THREADS) {
    const int r = i / D, c = i % D;
    const bool ok = k0 + r < sk;
    const size_t g = kbase + (size_t)(k0 + r) * D + c;
    Ks[r * KS + c] = ok ? to_f32(k[g]) : 0.f;
    Vs[r * KS + c] = ok ? to_f32(v[g]) : 0.f;
  }
  const uint32_t bseed = fa::batch_seed(seed, bh);

  float dk_acc[RPT][DPT], dv_acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const int n_qt = (sq + BQ - 1) / BQ;
  int first_qt = 0;
  if (causal) {
    // row r attends cols <= r + offset: q tiles before this one hold only
    // rows that see none of this k tile
    const int lo = k0 - offset;
    first_qt = lo <= 0 ? 0 : lo / BQ;
  }

  for (int qt = first_qt; qt < n_qt; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // the previous tile's reads of Qt/dOt/Pt/dSt are done
    for (int i = tid; i < BQ * D; i += THREADS) {
      const int r = i / D, e = i % D;
      const bool ok = q0 + r < sq;
      const size_t g = qbase + (size_t)(q0 + r) * D + e;
      Qt[e * TS + r] = ok ? to_f32(q[g]) : 0.f;
      dOt[e * TS + r] = ok ? to_f32(dout[g]) : 0.f;
    }
    if (tid < BQ) {
      const bool ok = q0 + tid < sq;
      lse_s[tid] = ok ? lse[(size_t)bh * sq + q0 + tid] : 0.f;
      delta_s[tid] = ok ? delta[(size_t)bh * sq + q0 + tid] : 0.f;
    }
    __syncthreads();

    float st[RPT][CPT], dpt[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
    for (int e = 0; e < D; ++e) {
      float ka[RPT], va[RPT], qb[CPT], db[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        ka[i] = Ks[(ty + 16 * i) * KS + e];
        va[i] = Vs[(ty + 16 * i) * KS + e];
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        qb[j] = Qt[e * TS + tx + 16 * j];
        db[j] = dOt[e * TS + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          st[i][j] = fmaf(ka[i], qb[j], st[i][j]);
          dpt[i][j] = fmaf(va[i], db[j], dpt[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int c = ty + 16 * i;
      const int col = k0 + c;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int r = tx + 16 * j;
        const int row = q0 + r;
        float x = st[i][j] * scale;
        if (col >= sk || row >= sq || (causal && row + offset < col)) x = NEG_INF;
        const float p = (x == NEG_INF) ? 0.f : expf(x - lse_s[r]);
        float pd = p, dpv = dpt[i][j];
        if (dropout) {
          const bool kept = fa::keep(bseed, row, col, sk, keep_thresh);
          pd = kept ? p * inv_keep : 0.f;
          dpv = kept ? dpv * inv_keep : 0.f;
        }
        Pt[c * TS + r] = round_like(pd, dout);
        dSt[c * TS + r] = round_like(p * (dpv - delta_s[r]), q);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int r = 0; r < BQ; ++r) {
      float pa[RPT], sa[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        pa[i] = Pt[(ty + 16 * i) * TS + r];
        sa[i] = dSt[(ty + 16 * i) * TS + r];
      }
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const float dob = dOt[(tx + 16 * j) * TS + r];
        const float qv = Qt[(tx + 16 * j) * TS + r];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          dv_acc[i][j] = fmaf(pa[i], dob, dv_acc[i][j]);
          dk_acc[i][j] = fmaf(sa[i], qv, dk_acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int col = k0 + ty + 16 * i;
    if (col < sk) {
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const size_t g = kbase + (size_t)col * D + tx + 16 * j;
        store_out(&dk[g], dk_acc[i][j] * scale);
        store_out(&dv[g], dv_acc[i][j]);
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dk, void* dv, int bh, int sq,
                   int sk, float scale, int causal, int dropout, uint32_t seed,
                   uint32_t keep_thresh, float inv_keep, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  auto kern = dkv_kernel<T, D>;
  // above 48 KB a block's shared memory has to be opted into
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (sk + BK - 1) / BK);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), sq, sk,
      scale, causal, dropout, seed, keep_thresh, inv_keep);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q/dout [bh, sq, d], k/v/dk/dv [bh, sk, d] contiguous in one dtype (0 =
// float32, 1 = bfloat16); lse and delta [bh, sq] float32. Returns the
// cudaError_t of the launch (0 = success); cudaErrorInvalidValue for a
// head_dim or dtype this kernel does not take.
int flash_attention_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dk, void* dv, int bh,
                            int sq, int sk, int d, float scale, int causal, int dropout,
                            unsigned int seed, unsigned int keep_thresh, float inv_keep,
                            int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && d == 64)
    return launch<float, 64>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, scale, causal,
                             dropout, seed, keep_thresh, inv_keep, st);
  if (dtype == 0 && d == 128)
    return launch<float, 128>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, scale, causal,
                              dropout, seed, keep_thresh, inv_keep, st);
  if (dtype == 1 && d == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, scale,
                                     causal, dropout, seed, keep_thresh, inv_keep, st);
  if (dtype == 1 && d == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, scale,
                                      causal, dropout, seed, keep_thresh, inv_keep, st);
  return (int)cudaErrorInvalidValue;
}

// dynamic shared memory of one block for head_dim d (either dtype), or -1
int flash_attention_bwd_dkv_smem_bytes(int d) {
  if (d == 64) return (int)(smem_floats<64>() * sizeof(float));
  if (d == 128) return (int)(smem_floats<128>() * sizeof(float));
  return -1;
}

const char* flash_attention_bwd_dkv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
