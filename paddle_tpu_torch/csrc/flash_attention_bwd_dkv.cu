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
// once at the end, without atomics. One block per (batch*head, 64-row k
// tile) in both forms.
//
// bf16 (`dkv_bf16_kernel`) runs on the tensor cores (mma.sync m16n8k16,
// f32 accumulators). Each warp owns 16 key rows and 64 columns of dK/dV:
// 4 warps at head_dim 64; 8 at head_dim 128, where the two warps of a row
// group split dK/dV's columns and both compute that group's S^T and dP^T
// (the byte bound affords the repeat; one warp holding all 128 columns
// would need 128 accumulator registers a thread before S and dP). K and V
// rows are loaded once and held as ldmatrix A fragments. Per q tile, Q and
// dO (bf16) arrive by 16-byte cp.async into a two-stage ring, LSE and
// delta by 4-byte cp.async beside them. For each 16 q columns, S^T = K Q^T
// and dP^T = V dO^T take their B fragments straight from Q's and dO's
// [q][d] rows; P_drop^T and dS^T are formed in the C fragments (where
// every element's key and q index is known), rounded to bf16 there, and
// feed dV += P_drop^T dO and dK += dS^T Q as A fragments, with B from
// ldmatrix.trans. Rows are padded by 8 elements so ldmatrix is free of bank
// conflicts. P's e^x is fa::fast_exp (one ex2.approx).
//
// f32 (`dkv_kernel`) runs as f32 FMAs on the CUDA cores, 256 threads as
// 16 x 16: each thread owns 4 key rows x 4 q columns of the transposed
// tiles S^T/dP^T and 4 key rows x d/16 columns of dK and dV. K and V rows
// stay in shared memory for the whole block; Q and dO are stored
// transposed ([d][64 + 1]) so the same arrays serve S^T = K Q^T and dK =
// dS^T Q. At head_dim 128 a block takes 166,400 bytes of shared memory.
#include "flash_attention_common.cuh"
#include "flash_attention_sm90.cuh"

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

template <int D>
struct Bf16Layout {
  static constexpr int THREADS = D / 64 * 128;  // 4 warps per 64 dK/dV columns
  static constexpr int LD = D + 8;              // row stride in bf16 (16-byte rows, 4-bank skew)
  // K, V rows; 2 stages x (Q, dO) rows; 2 stages x (LSE, delta)
  static constexpr size_t bytes =
      (2 * (size_t)BK * LD + 4 * (size_t)BQ * LD) * 2 + 4 * (size_t)BQ * sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(Bf16Layout<D>::THREADS)
dkv_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int sq, int sk,
                float scale, int causal, int dropout, uint32_t seed, uint32_t keep_thresh,
                float inv_keep) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int NTHREADS = Bf16Layout<D>::THREADS;
  constexpr int LD = Bf16Layout<D>::LD;
  constexpr int KSTEPS = D / 16;  // k steps of K Q^T and V dO^T
  constexpr int DT = 64 / 8;      // n8 tiles of this warp's 64 dK/dV columns
  constexpr int CH = D / 8;       // 16-byte chunks per row
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BK][LD]
  __nv_bfloat16* Vs = Ks + BK * LD;                                 // [BK][LD]
  __nv_bfloat16* ring = Vs + BK * LD;  // 2 stages x (Q [BQ][LD], dO [BQ][LD])
  float* stats = reinterpret_cast<float*>(ring + 4 * BQ * LD);  // 2 stages x (LSE, delta)

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BK;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int t = lane & 3;
  const int kw = (warp & 3) * 16;   // this warp's key rows within the tile
  const int c0 = (warp >> 2) * 64;  // this warp's first dK/dV column
  const int key_lo = k0 + kw + (lane >> 2);  // C-fragment rows: key_lo, key_lo + 8
  const __nv_bfloat16* qg = q + (size_t)bh * sq * D;
  const __nv_bfloat16* dog = dout + (size_t)bh * sq * D;
  const float* lseg = lse + (size_t)bh * sq;
  const float* deltag = delta + (size_t)bh * sq;
  const size_t kbase = (size_t)bh * sk * D;
  const int offset = sk - sq;
  // ldmatrix row/column of this lane inside a 16 x 16 block
  const int lm_r = (lane & 7) + ((lane >> 3) & 1) * 8;  // A / trans-B order
  const int lm_c = (lane >> 4) * 8;
  const int lb_r = (lane & 7) + (lane >> 4) * 8;        // B order (n half from lane bit 4)
  const int lb_c = ((lane >> 3) & 1) * 8;

  for (int i = tid; i < BK * CH; i += NTHREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool ok = k0 + r < sk;
    const size_t g = kbase + (size_t)(k0 + r) * D + c;
    fa::cp_async16(&Ks[r * LD + c], ok ? k + g : k, ok);
    fa::cp_async16(&Vs[r * LD + c], ok ? v + g : v, ok);
  }

  const int n_qt = (sq + BQ - 1) / BQ;
  int first_qt = 0;
  if (causal) {
    // row r attends cols <= r + offset: q tiles before this one hold only
    // rows that see none of this k tile
    const int lo = k0 - offset;
    first_qt = lo <= 0 ? 0 : lo / BQ;
  }
  auto load_q = [&](int qt) {
    __nv_bfloat16* Qs = ring + (qt & 1) * 2 * BQ * LD;
    __nv_bfloat16* dOs = Qs + BQ * LD;
    float* st = stats + (qt & 1) * 2 * BQ;
    const int q0 = qt * BQ;
    for (int i = tid; i < BQ * CH; i += NTHREADS) {
      const int r = i / CH, c = (i % CH) * 8;
      const bool ok = q0 + r < sq;
      const size_t g = (size_t)(q0 + r) * D + c;
      fa::cp_async16(&Qs[r * LD + c], ok ? qg + g : qg, ok);
      fa::cp_async16(&dOs[r * LD + c], ok ? dog + g : dog, ok);
    }
    for (int i = tid; i < 2 * BQ; i += NTHREADS) {
      const int r = i % BQ;
      const bool ok = q0 + r < sq;
      const float* src = i < BQ ? lseg : deltag;
      fa::cp_async4(&st[i], ok ? src + q0 + r : src, ok);
    }
  };
  if (first_qt < n_qt) load_q(first_qt);
  fa::cp_async_commit();

  const uint32_t bseed = fa::batch_seed(seed, bh);
  uint32_t kf[KSTEPS][4], vf[KSTEPS][4];
  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int qt = first_qt; qt < n_qt; ++qt) {
    if (qt + 1 < n_qt) {
      load_q(qt + 1);
      fa::cp_async_commit();
      fa::cp_async_wait<1>();
    } else {
      fa::cp_async_wait<0>();
    }
    __syncthreads();  // q tile qt (and K, V) visible to every thread
    if (qt == first_qt) {
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        fa::ldmatrix_x4(kf[ks], &Ks[(kw + lm_r) * LD + ks * 16 + lm_c]);
        fa::ldmatrix_x4(vf[ks], &Vs[(kw + lm_r) * LD + ks * 16 + lm_c]);
      }
    }
    const __nv_bfloat16* Qs = ring + (qt & 1) * 2 * BQ * LD;
    const __nv_bfloat16* dOs = Qs + BQ * LD;
    const float* lse_s = stats + (qt & 1) * 2 * BQ;
    const float* delta_s = lse_s + BQ;
    const int q0 = qt * BQ;

#pragma unroll 1
    for (int qc = 0; qc < BQ; qc += 16) {
      // S^T and dP^T for this warp's 16 keys x q columns qc..qc+15
      float st[2][4], dpt[2][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) st[0][e] = st[1][e] = dpt[0][e] = dpt[1][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        uint32_t b[4];
        fa::ldmatrix_x4(b, &Qs[(qc + lb_r) * LD + ks * 16 + lb_c]);
        fa::mma_bf16(st[0], kf[ks], b[0], b[1]);
        fa::mma_bf16(st[1], kf[ks], b[2], b[3]);
        fa::ldmatrix_x4(b, &dOs[(qc + lb_r) * LD + ks * 16 + lb_c]);
        fa::mma_bf16(dpt[0], vf[ks], b[0], b[1]);
        fa::mma_bf16(dpt[1], vf[ks], b[2], b[3]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key_lo + (e >> 1) * 8;
          const int ql = qc + nt * 8 + 2 * t + (e & 1);
          const int row = q0 + ql;
          float x = st[nt][e] * scale;
          if (key >= sk || row >= sq || (causal && row + offset < key)) x = NEG_INF;
          const float p = (x == NEG_INF) ? 0.f : fa::fast_exp(x - lse_s[ql]);
          float pd = p, dpv = dpt[nt][e];
          if (dropout) {
            const bool kept = fa::keep(bseed, row, key, sk, keep_thresh);
            pd = kept ? p * inv_keep : 0.f;
            dpv = kept ? dpv * inv_keep : 0.f;
          }
          st[nt][e] = pd;                         // P_drop^T
          dpt[nt][e] = p * (dpv - delta_s[ql]);  // dS^T
        }
      // rounded to bf16 (dO's and Q's dtype), the C fragments of the two
      // n8 tiles are the A fragment over these 16 q columns
      uint32_t pa[4], sa[4];
      pa[0] = fa::pack_bf16(st[0][0], st[0][1]);
      pa[1] = fa::pack_bf16(st[0][2], st[0][3]);
      pa[2] = fa::pack_bf16(st[1][0], st[1][1]);
      pa[3] = fa::pack_bf16(st[1][2], st[1][3]);
      sa[0] = fa::pack_bf16(dpt[0][0], dpt[0][1]);
      sa[1] = fa::pack_bf16(dpt[0][2], dpt[0][3]);
      sa[2] = fa::pack_bf16(dpt[1][0], dpt[1][1]);
      sa[3] = fa::pack_bf16(dpt[1][2], dpt[1][3]);
#pragma unroll
      for (int np = 0; np < DT / 2; ++np) {
        uint32_t b[4];
        fa::ldmatrix_x4_trans(b, &dOs[(qc + lm_r) * LD + c0 + np * 16 + lm_c]);
        fa::mma_bf16(dva[2 * np], pa, b[0], b[1]);
        fa::mma_bf16(dva[2 * np + 1], pa, b[2], b[3]);
        fa::ldmatrix_x4_trans(b, &Qs[(qc + lm_r) * LD + c0 + np * 16 + lm_c]);
        fa::mma_bf16(dka[2 * np], sa, b[0], b[1]);
        fa::mma_bf16(dka[2 * np + 1], sa, b[2], b[3]);
      }
    }
    __syncthreads();  // this stage is read before it is refilled
  }
  fa::cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key_lo + h * 8;
    if (key < sk) {
      const size_t g = kbase + (size_t)key * D + c0 + 2 * t;
      uint32_t* dkrow = reinterpret_cast<uint32_t*>(dk + g);
      uint32_t* dvrow = reinterpret_cast<uint32_t*>(dv + g);
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        dkrow[n * 4] = fa::pack_bf16(dka[n][2 * h] * scale, dka[n][2 * h + 1] * scale);
        dvrow[n * 4] = fa::pack_bf16(dva[n][2 * h], dva[n][2 * h + 1]);
      }
    }
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int bh, int sq,
                       int sk, float scale, int causal, int dropout, uint32_t seed,
                       uint32_t keep_thresh, float inv_keep, cudaStream_t stream) {
  constexpr size_t smem = smem_floats<D>() * sizeof(float);
  auto kern = dkv_kernel<float, D>;
  FA_OPT_IN_SMEM_ONCE(kern, smem);  // above 48 KB a block has to opt in
  const dim3 grid(bh, (sk + BK - 1) / BK);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk), static_cast<float*>(dv), sq,
      sk, scale, causal, dropout, seed, keep_thresh, inv_keep);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dk, void* dv, int bh, int sq,
                        int sk, float scale, int causal, int dropout, uint32_t seed,
                        uint32_t keep_thresh, float inv_keep, cudaStream_t stream) {
  constexpr size_t smem = Bf16Layout<D>::bytes;
  auto kern = dkv_bf16_kernel<D>;
  FA_OPT_IN_SMEM_ONCE(kern, smem);
  const dim3 grid(bh, (sk + BK - 1) / BK);
  using bf = __nv_bfloat16;
  kern<<<grid, Bf16Layout<D>::THREADS, smem, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
      static_cast<const bf*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf*>(dk), static_cast<bf*>(dv), sq, sk,
      scale, causal, dropout, seed, keep_thresh, inv_keep);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q/dout [bh, sq, d], k/v/dk/dv [bh, sk, d] contiguous in one dtype (0 =
// float32, 1 = bfloat16; bf16 pointers 16-byte aligned); lse and delta
// [bh, sq] float32. Returns the cudaError_t of the launch (0 = success);
// cudaErrorInvalidValue for a head_dim or dtype this kernel does not take.
int flash_attention_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dk, void* dv, int bh,
                            int sq, int sk, int d, float scale, int causal, int dropout,
                            unsigned int seed, unsigned int keep_thresh, float inv_keep,
                            int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && d == 64)
    return launch_f32<64>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, scale, causal,
                          dropout, seed, keep_thresh, inv_keep, st);
  if (dtype == 0 && d == 128)
    return launch_f32<128>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, scale, causal,
                           dropout, seed, keep_thresh, inv_keep, st);
  if (dtype == 1 && d == 64)
    return launch_bf16<64>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, scale, causal,
                           dropout, seed, keep_thresh, inv_keep, st);
  if (dtype == 1 && d == 128)
    return launch_bf16<128>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, scale, causal,
                            dropout, seed, keep_thresh, inv_keep, st);
  return (int)cudaErrorInvalidValue;
}

// dynamic shared memory of one block for head_dim d and dtype (0 = float32,
// 1 = bfloat16), or -1
int flash_attention_bwd_dkv_smem_bytes(int d, int dtype) {
  if (dtype == 0 && d == 64) return (int)(smem_floats<64>() * sizeof(float));
  if (dtype == 0 && d == 128) return (int)(smem_floats<128>() * sizeof(float));
  if (dtype == 1 && d == 64) return (int)Bf16Layout<64>::bytes;
  if (dtype == 1 && d == 128) return (int)Bf16Layout<128>::bytes;
  return -1;
}

const char* flash_attention_bwd_dkv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
