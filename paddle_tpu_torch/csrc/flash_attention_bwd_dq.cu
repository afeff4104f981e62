// Flash-attention backward, dQ, for Hopper (sm_90a), plain C interface for
// ctypes.
//
// Replaces the Pallas TPU kernel `_bwd_dq_kernel` (pallas_call in `_bwd`) of
// paddle_tpu/ops/pallas/flash_attention.py. It computes the same thing from
// the forward's saved LSE and delta = rowsum(dO * O) (computed before the
// launch, as the reference does): S = Q K^T * scale with the bottom-right
// causal mask (offset = sk - sq), P = exp(S - LSE) zeroed where S is masked
// (a fully masked row has LSE ~= NEG_INF), dP = dO V^T dropped and
// rescaled by the counter hash of the forward, dS = P * (dP - delta)
// rounded to the input dtype, dQ = scale * dS K. e^x is fa::fast_exp (one
// ex2.approx).
//
// What bounds it on an H100: 6*sq*sk*d operations (three products) against
// (3*sq + 2*sk)*d elements plus 2*sq floats of traffic per head, so at the
// BERT-base training shape ([768, 128, 64]) the f32 form is bound by
// operations (67 TFLOP/s outside the tensor cores; f32 stays full f32, no
// TF32) and the bf16 form by bytes (3.35 TB/s). Both forms keep S, P, dP
// and dS inside the block, read Q and dO once per block and K/V once per
// (block, k tile), stream K/V with 16-byte cp.async, skip causal k tiles
// past the last one a q tile needs, and write dQ once, without atomics: the
// result is the same run to run. One block per (batch*head, 64-row q
// tile), 128 threads.
//
// bf16 (`dq_bf16_kernel`) runs on the tensor cores (mma.sync m16n8k16, f32
// accumulators), built as K1's bf16 form: each warp owns 16 q rows and
// holds its Q and dO A fragments in registers for the whole block; K/V
// tiles stay bf16 in a two-stage ring, rows padded by 8 elements so
// ldmatrix is free of bank conflicts. Per 16 keys, S = Q K^T and dP = dO
// V^T take their B fragments straight from K's and V's rows (ldmatrix);
// the mask, P, the dropout and dS are formed in the C fragments, where each
// element's (row, key) follows from the lane; dS rounded to bf16 and packed
// in pairs is the A fragment of dQ += dS K over those 16 keys, with B from
// K's rows by ldmatrix.trans. Nothing passes through shared memory but the
// K/V tiles. LSE and delta of a lane's two rows live in registers.
//
// f32 (`dq_f32_kernel`) runs on the CUDA cores, register-blocked as K1's f32
// form: each thread owns 4 q rows (ty + 16 i) x 8 keys (tx + 8 j) of S and
// dP and the same 4 rows x D/8 columns (tx * 4 + 32 g, as float4) of dQ;
// every shared read is a float4 that the 8 lanes of a quarter-warp either
// share (Q, dO, dS) or take from 8 distinct bank groups (K, V). K and V
// have one buffer each; dS takes V's buffer once dP is done, so Q, dO, K
// and V rows, LSE and delta are all a block holds (70,144 bytes at
// head_dim 64, three blocks per SM).
#include "flash_attention_common.cuh"
#include "flash_attention_f32.cuh"
#include "flash_attention_sm90.cuh"

namespace {

constexpr int BQ = 64;        // q rows per block
constexpr int BK = 64;        // keys per k tile
constexpr int THREADS = 128;  // both forms: 4 warps

// f32: Q, dO, K, V rows, LSE and delta; dS [BQ][PS] lives in V's buffer
template <int D>
struct F32Layout {
  static constexpr int LD = D + 4;   // row stride in floats (16-byte rows, 4-bank skew)
  static constexpr int PS = BK + 4;  // dS row stride
  static_assert(BQ * PS <= BK * LD, "dS fits in V's buffer");
  static constexpr size_t bytes =
      (2 * (size_t)BQ * LD + 2 * (size_t)BK * LD + 2 * (size_t)BQ) * sizeof(float);
};

// bf16: Q, dO rows; 2 stages x (K, V) rows
template <int D>
struct Bf16Layout {
  static constexpr int LD = D + 8;  // row stride in bf16 (16-byte rows, 4-bank skew)
  static constexpr size_t bytes = (2 * (size_t)BQ * LD + 4 * (size_t)BK * LD) * 2;
};

// keys >= the result are masked in q row `row` (0 for a row past sq)
__device__ __forceinline__ int key_limit(int row, int sq, int sk, int causal) {
  if (row >= sq) return 0;
  return causal ? min(sk, row + (sk - sq) + 1) : sk;
}

// ------------------------------------------------------------------ f32
// three blocks per SM at head_dim 64 (69 KB of shared memory each)
template <int D>
__global__ void __launch_bounds__(THREADS, D == 64 ? 3 : 1)
dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, int sq, int sk, float scale, int causal, int dropout,
              uint32_t seed, uint32_t keep_thresh, float inv_keep) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int RPT = 4;       // q rows per thread
  constexpr int CPT = 8;       // S / dP keys per thread
  constexpr int LD = F32Layout<D>::LD;
  constexpr int PS = F32Layout<D>::PS;
  constexpr int CH = D / 4;    // 16-byte chunks per row
  float* Qs = reinterpret_cast<float*>(smem_raw);  // [BQ][LD]
  float* dOs = Qs + BQ * LD;                       // [BQ][LD]
  float* Ks = dOs + BQ * LD;                       // [BK][LD]
  float* Vs = Ks + BK * LD;                        // [BK][LD]
  float* dSs = Vs;                                 // [BQ][PS], once dP is done
  float* stats = Vs + BK * LD;                     // LSE [BQ], delta [BQ]

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int ty = tid >> 3;  // 0..15: the lanes of a quarter-warp share it
  const int tx = lane & 7;
  const float* qg = q + (size_t)bh * sq * D;
  const float* dog = dout + (size_t)bh * sq * D;
  const float* kg = k + (size_t)bh * sk * D;
  const float* vg = v + (size_t)bh * sk * D;
  const int n_kt = fa::k_tiles<BQ, BK>(q0, sq, sk, causal);

  // K and V each have one buffer, refilled once tile kt's dS K is done.
  // Groups, in commit order: {Q, dO, LSE, delta, K0}, {V0}, {K1}, {V1}, ...
  auto load_rows = [&](float* dst, const float* src, int r0, int rows, int n) {
    for (int i = tid; i < rows * CH; i += THREADS) {
      const int r = i / CH, c = (i % CH) * 4;
      const bool ok = r0 + r < n;
      fa::cp_async16(&dst[r * LD + c], ok ? src + (size_t)(r0 + r) * D + c : src, ok);
    }
  };
  load_rows(Qs, qg, q0, BQ, sq);
  load_rows(dOs, dog, q0, BQ, sq);
  for (int i = tid; i < 2 * BQ; i += THREADS) {
    const int r = i % BQ;
    const bool ok = q0 + r < sq;
    const float* src = (i < BQ ? lse : delta) + (size_t)bh * sq;
    fa::cp_async4(&stats[i], ok ? src + q0 + r : src, ok);
  }
  if (n_kt > 0) load_rows(Ks, kg, 0, BK, sk);
  fa::cp_async_commit();
  if (n_kt > 0) load_rows(Vs, vg, 0, BK, sk);
  fa::cp_async_commit();

  const uint32_t bseed = fa::batch_seed(seed, bh);
  float acc[RPT][D / 8];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < D / 8; ++j) acc[i][j] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    fa::cp_async_wait<1>();  // Q, dO and K(kt) have landed; V(kt) may be in flight
    __syncthreads();

    // S = Q K^T, then P = exp(S * scale - LSE) in place (0 where masked)
    float p[RPT][CPT], dp[RPT][CPT];
    fa::rows_dot_rows<D, LD, LD, CPT>(p, Qs, Ks, ty, tx);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int lim = key_limit(q0 + ty + 16 * i, sq, sk, causal);
      const float m = stats[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        p[i][j] = k0 + tx + 8 * j < lim ? fa::fast_exp(p[i][j] * scale - m) : 0.f;
    }

    fa::cp_async_wait<0>();  // V(kt) has landed
    __syncthreads();
    fa::rows_dot_rows<D, LD, LD, CPT>(dp, dOs, Vs, ty, tx);
    __syncthreads();  // every thread is done with V(kt): dS takes its buffer

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = k0 + tx + 8 * j;
        float dpv = dp[i][j];
        if (dropout) dpv = fa::keep(bseed, row, col, sk, keep_thresh) ? dpv * inv_keep : 0.f;
        dSs[(ty + 16 * i) * PS + tx + 8 * j] = p[i][j] * (dpv - stats[BQ + ty + 16 * i]);
      }
    }
    __syncthreads();  // dS is complete

    fa::rows_times_tile<BK, D, PS, LD>(acc, dSs, Ks, ty, tx);
    __syncthreads();  // every thread is done with K(kt) and dS
    if (kt + 1 < n_kt) load_rows(Ks, kg, k0 + BK, BK, sk);
    fa::cp_async_commit();
    if (kt + 1 < n_kt) load_rows(Vs, vg, k0 + BK, BK, sk);
    fa::cp_async_commit();
  }
  fa::cp_async_wait<0>();

  fa::store_rows<D>(dq + (size_t)bh * sq * D, acc, scale, q0, sq, ty, tx);
}

// ------------------------------------------------------------------ bf16
// four blocks per SM at head_dim 64 (55 KB of shared memory each); two at
// head_dim 128 (104 KB)
template <int D>
__global__ void __launch_bounds__(THREADS, D == 64 ? 4 : 2)
dq_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               __nv_bfloat16* __restrict__ dq, int sq, int sk, float scale, int causal,
               int dropout, uint32_t seed, uint32_t keep_thresh, float inv_keep) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LD = Bf16Layout<D>::LD;
  constexpr int KSTEPS = D / 16;  // k steps of Q K^T and dO V^T
  constexpr int DT = D / 8;       // n8 tiles of dQ
  constexpr int CH = D / 8;       // 16-byte chunks per row
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BQ][LD]
  __nv_bfloat16* dOs = Qs + BQ * LD;                                // [BQ][LD]
  __nv_bfloat16* KVs = dOs + BQ * LD;  // 2 stages x (K [BK][LD], V [BK][LD])

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int t = lane & 3;
  const int row_lo = q0 + warp * 16 + (lane >> 2);  // C-fragment rows: row_lo, row_lo + 8
  const __nv_bfloat16* qg = q + (size_t)bh * sq * D;
  const __nv_bfloat16* dog = dout + (size_t)bh * sq * D;
  const __nv_bfloat16* kg = k + (size_t)bh * sk * D;
  const __nv_bfloat16* vg = v + (size_t)bh * sk * D;
  const int n_kt = fa::k_tiles<BQ, BK>(q0, sq, sk, causal);
  // ldmatrix row/column of this lane inside a 16 x 16 block
  const int lm_r = (lane & 7) + ((lane >> 3) & 1) * 8;  // A / trans-B order
  const int lm_c = (lane >> 4) * 8;
  const int lb_r = (lane & 7) + (lane >> 4) * 8;        // B order: n half from lane bit 4
  const int lb_c = ((lane >> 3) & 1) * 8;

  for (int i = tid; i < BQ * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool ok = q0 + r < sq;
    const size_t g = (size_t)(q0 + r) * D + c;
    fa::cp_async16(&Qs[r * LD + c], ok ? qg + g : qg, ok);
    fa::cp_async16(&dOs[r * LD + c], ok ? dog + g : dog, ok);
  }
  auto load_kv = [&](int kt) {
    __nv_bfloat16* Ks = KVs + (kt & 1) * 2 * BK * LD;
    __nv_bfloat16* Vs = Ks + BK * LD;
    const int k0 = kt * BK;
    for (int i = tid; i < BK * CH; i += THREADS) {
      const int r = i / CH, c = (i % CH) * 8;
      const bool ok = k0 + r < sk;
      const size_t g = (size_t)(k0 + r) * D + c;
      fa::cp_async16(&Ks[r * LD + c], ok ? kg + g : kg, ok);
      fa::cp_async16(&Vs[r * LD + c], ok ? vg + g : vg, ok);
    }
  };
  if (n_kt > 0) load_kv(0);
  fa::cp_async_commit();

  const uint32_t bseed = fa::batch_seed(seed, bh);
  // LSE, delta and the key limit of rows row_lo + 8 h
  float lse_r[2], delta_r[2];
  int lim[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_lo + 8 * h;
    lim[h] = key_limit(row, sq, sk, causal);
    lse_r[h] = row < sq ? lse[(size_t)bh * sq + row] : 0.f;
    delta_r[h] = row < sq ? delta[(size_t)bh * sq + row] : 0.f;
  }
  uint32_t qf[KSTEPS][4], dof[KSTEPS][4];
  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) {
      load_kv(kt + 1);
      fa::cp_async_commit();
      fa::cp_async_wait<1>();
    } else {
      fa::cp_async_wait<0>();
    }
    __syncthreads();  // tile kt (and Q, dO) visible to every thread
    if (kt == 0) {
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        fa::ldmatrix_x4(qf[ks], &Qs[(warp * 16 + lm_r) * LD + ks * 16 + lm_c]);
        fa::ldmatrix_x4(dof[ks], &dOs[(warp * 16 + lm_r) * LD + ks * 16 + lm_c]);
      }
    }
    const __nv_bfloat16* Ks = KVs + (kt & 1) * 2 * BK * LD;
    const __nv_bfloat16* Vs = Ks + BK * LD;
    const int k0 = kt * BK;

#pragma unroll 1
    for (int kc = 0; kc < BK; kc += 16) {
      // S and dP for this warp's 16 rows x keys kc..kc+15
      float s[2][4], dp[2][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) s[0][e] = s[1][e] = dp[0][e] = dp[1][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        uint32_t b[4];
        fa::ldmatrix_x4(b, &Ks[(kc + lb_r) * LD + ks * 16 + lb_c]);
        fa::mma_bf16(s[0], qf[ks], b[0], b[1]);
        fa::mma_bf16(s[1], qf[ks], b[2], b[3]);
        fa::ldmatrix_x4(b, &Vs[(kc + lb_r) * LD + ks * 16 + lb_c]);
        fa::mma_bf16(dp[0], dof[ks], b[0], b[1]);
        fa::mma_bf16(dp[1], dof[ks], b[2], b[3]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const int key = k0 + kc + nt * 8 + 2 * t + (e & 1);
          float ds = 0.f;
          if (key < lim[h]) {
            const float p = fa::fast_exp(s[nt][e] * scale - lse_r[h]);
            float dpv = dp[nt][e];
            if (dropout)
              dpv = fa::keep(bseed, row_lo + 8 * h, key, sk, keep_thresh) ? dpv * inv_keep : 0.f;
            ds = p * (dpv - delta_r[h]);
          }
          s[nt][e] = ds;
        }
      // dS rounded to bf16 (Q's dtype): the C fragments of the two n8
      // tiles are the A fragment over these 16 keys
      uint32_t a[4];
      a[0] = fa::pack_bf16(s[0][0], s[0][1]);
      a[1] = fa::pack_bf16(s[0][2], s[0][3]);
      a[2] = fa::pack_bf16(s[1][0], s[1][1]);
      a[3] = fa::pack_bf16(s[1][2], s[1][3]);
#pragma unroll
      for (int np = 0; np < DT / 2; ++np) {
        uint32_t b[4];
        fa::ldmatrix_x4_trans(b, &Ks[(kc + lm_r) * LD + np * 16 + lm_c]);
        fa::mma_bf16(acc[2 * np], a, b[0], b[1]);
        fa::mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // this stage's K/V are read before they are refilled
  }
  fa::cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_lo + h * 8;
    if (row < sq) {
      uint32_t* drow = reinterpret_cast<uint32_t*>(dq + ((size_t)bh * sq + row) * D + 2 * t);
#pragma unroll
      for (int n = 0; n < DT; ++n)
        drow[n * 4] = fa::pack_bf16(acc[n][2 * h] * scale, acc[n][2 * h + 1] * scale);
    }
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dq, int bh, int sq, int sk,
                       float scale, int causal, int dropout, uint32_t seed, uint32_t keep_thresh,
                       float inv_keep, cudaStream_t stream) {
  constexpr size_t smem = F32Layout<D>::bytes;
  auto kern = dq_f32_kernel<D>;
  FA_OPT_IN_SMEM_ONCE(kern, smem);  // above 48 KB a block has to opt in
  const dim3 grid(bh, (sq + BQ - 1) / BQ);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq), sq, sk, scale, causal, dropout,
      seed, keep_thresh, inv_keep);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dq, int bh, int sq, int sk,
                        float scale, int causal, int dropout, uint32_t seed,
                        uint32_t keep_thresh, float inv_keep, cudaStream_t stream) {
  constexpr size_t smem = Bf16Layout<D>::bytes;
  auto kern = dq_bf16_kernel<D>;
  FA_OPT_IN_SMEM_ONCE(kern, smem);
  const dim3 grid(bh, (sq + BQ - 1) / BQ);
  using bf = __nv_bfloat16;
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
      static_cast<const bf*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf*>(dq), sq, sk, scale, causal, dropout,
      seed, keep_thresh, inv_keep);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q/dout/dq [bh, sq, d], k/v [bh, sk, d] contiguous and 16-byte aligned in
// one dtype (0 = float32, 1 = bfloat16); lse and delta [bh, sq] float32.
// Returns the cudaError_t of the launch (0 = success); cudaErrorInvalidValue
// for a head_dim or dtype this kernel does not take.
int flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, void* dq, int bh, int sq,
                           int sk, int d, float scale, int causal, int dropout,
                           unsigned int seed, unsigned int keep_thresh, float inv_keep,
                           int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && d == 64)
    return launch_f32<64>(q, k, v, dout, lse, delta, dq, bh, sq, sk, scale, causal, dropout,
                          seed, keep_thresh, inv_keep, st);
  if (dtype == 0 && d == 128)
    return launch_f32<128>(q, k, v, dout, lse, delta, dq, bh, sq, sk, scale, causal, dropout,
                           seed, keep_thresh, inv_keep, st);
  if (dtype == 1 && d == 64)
    return launch_bf16<64>(q, k, v, dout, lse, delta, dq, bh, sq, sk, scale, causal, dropout,
                           seed, keep_thresh, inv_keep, st);
  if (dtype == 1 && d == 128)
    return launch_bf16<128>(q, k, v, dout, lse, delta, dq, bh, sq, sk, scale, causal,
                            dropout, seed, keep_thresh, inv_keep, st);
  return (int)cudaErrorInvalidValue;
}

// dynamic shared memory of one block for head_dim d and dtype (0 = float32,
// 1 = bfloat16), or -1
int flash_attention_bwd_dq_smem_bytes(int d, int dtype) {
  if (dtype == 0 && d == 64) return (int)F32Layout<64>::bytes;
  if (dtype == 0 && d == 128) return (int)F32Layout<128>::bytes;
  if (dtype == 1 && d == 64) return (int)Bf16Layout<64>::bytes;
  if (dtype == 1 && d == 128) return (int)Bf16Layout<128>::bytes;
  return -1;
}

const char* flash_attention_bwd_dq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
