// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` / `_fwd` in
// paddle_tpu/ops/pallas/flash_attention.py. It computes the same thing:
// S = Q K^T * scale with f32 accumulation, an optional bottom-right causal
// mask (offset = sk - sq, masked entries NEG_INF = -1e30), the online
// softmax whose running sum l takes the UNDROPPED p while the output
// accumulator takes the counter-hash dropped and rescaled p (rounded to V's
// dtype before PV), O = 0 for a fully masked row, and LSE = m +
// log(max(l, 1e-30)). e^x is fa::fast_exp (one ex2.approx).
//
// What bounds it on an H100: the work is 4*sq*sk*d operations against
// (sq + 2*sk)*d elements of traffic per head, so at BERT-base shapes (d =
// 64, s = 128..512) the f32 form is bound by operations (67 TFLOP/s on
// the CUDA cores; f32 stays full f32, no TF32) and the bf16 form by bytes
// (3.35 TB/s). Both forms keep S and P inside the block, read every Q/K/V
// element from device memory once per q tile, stage tiles with 16-byte
// cp.async so the next tile's copy overlaps this tile's products, and skip
// causal k tiles past the last one a q tile needs. One block per
// (batch*head, 64-row q tile), 128 threads.
//
// bf16 runs on the tensor cores (mma.sync m16n8k16, f32 accumulators):
// each warp owns 16 q rows, holds its Q fragments in registers for the
// whole block, takes K's B fragments straight from K's [key][d] rows with
// ldmatrix and V's with ldmatrix.trans. S stays in the C fragments, where
// each element's (row, col) is known, so masks and dropout apply per
// element; the row max and sum reduce across the quad of lanes that share
// a row; P is rounded to bf16 in registers and its C fragments become the
// A fragments of P V. K/V tiles stay bf16 in a two-stage ring in shared
// memory, rows padded by 8 elements so ldmatrix reads are free of bank
// conflicts.
//
// f32 runs on the CUDA cores, register-blocked (the products are
// csrc/flash_attention_f32.cuh's): each thread owns 4 q rows
// (ty + 16 i) x 8 keys (tx + 8 j) of S and the same 4 rows x D/8 columns
// (tx * 4 + 32 g, as float4) of O, and every shared read is a float4 that
// the 8 lanes of a quarter-warp either share (Q, P) or take from 8
// distinct bank groups (K, V). P goes through shared memory once per tile
// (the rows a thread owns in P V need every key of the tile). K and V have
// one buffer each, refilled as soon as the tile's product that reads them
// is done, so 68 KB at head_dim 64 lets three blocks share an SM (a
// two-stage ring allowed two and measured slower, PERF.md).
#include "flash_attention_common.cuh"
#include "flash_attention_f32.cuh"
#include "flash_attention_sm90.cuh"

namespace {

using fa::NEG_INF;

constexpr int BQ = 64;       // q rows per block
constexpr int BK = 64;       // keys per k tile
constexpr int THREADS = 128; // both forms: 4 warps

// f32: one buffer each for K and V (see fwd_f32_kernel), and one for P
template <int D>
struct F32Layout {
  static constexpr int LD = D + 4;   // Q/K/V row stride in floats (16-byte rows, 4-bank skew)
  static constexpr int PS = BK + 4;  // P row stride
  static constexpr size_t bytes =
      ((size_t)BQ * LD + 2 * (size_t)BK * LD + (size_t)BQ * PS) * sizeof(float);
};

template <int D>
struct Bf16Layout {
  static constexpr int LD = D + 8;  // row stride in bf16 (16-byte rows, 4-bank skew)
  static constexpr size_t bytes = ((size_t)BQ * LD + 4 * (size_t)BK * LD) * 2;
};

// ------------------------------------------------------------------ f32
template <int D>
__global__ void __launch_bounds__(THREADS)
fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
               int sq, int sk, float scale, int causal, int dropout, uint32_t seed,
               uint32_t keep_thresh, float inv_keep) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int RPT = 4;       // q rows per thread
  constexpr int LD = F32Layout<D>::LD;
  constexpr int PS = F32Layout<D>::PS;
  constexpr int CPT = 8;       // S columns per thread
  constexpr int GPT = D / 32;  // float4 column groups of O per thread
  constexpr int CH = D / 4;    // 16-byte chunks per row
  float* Qs = reinterpret_cast<float*>(smem_raw);  // [BQ][LD]
  float* Ks = Qs + BQ * LD;                        // [BK][LD]
  float* Vs = Ks + BK * LD;                        // [BK][LD]
  float* Ps = Vs + BK * LD;                        // [BQ][PS]

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int ty = tid >> 3;  // 0..15: the lanes of a quarter-warp share it
  const int tx = lane & 7;
  const float* qg = q + (size_t)bh * sq * D;
  const float* kg = k + (size_t)bh * sk * D;
  const float* vg = v + (size_t)bh * sk * D;
  const int offset = sk - sq;
  const int n_kt = fa::k_tiles<BQ, BK>(q0, sq, sk, causal);

  // K and V each have one buffer; the copy of K(kt + 1) runs during
  // tile kt's softmax and P V, the copy of V(kt + 1) during tile kt+1's
  // Q K^T. Groups, in commit order: {Q, K0}, {V0}, {K1}, {V1}, ...
  auto load_rows = [&](float* dst, const float* src, int r0, int rows, int n) {
    for (int i = tid; i < rows * CH; i += THREADS) {
      const int r = i / CH, c = (i % CH) * 4;
      const bool ok = r0 + r < n;
      fa::cp_async16(&dst[r * LD + c], ok ? src + (size_t)(r0 + r) * D + c : src, ok);
    }
  };
  load_rows(Qs, qg, q0, BQ, sq);
  if (n_kt > 0) load_rows(Ks, kg, 0, BK, sk);
  fa::cp_async_commit();
  if (n_kt > 0) load_rows(Vs, vg, 0, BK, sk);
  fa::cp_async_commit();

  const uint32_t bseed = fa::batch_seed(seed, bh);
  float m[RPT], l[RPT], acc[RPT][D / 8];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) acc[i][j] = 0.f;
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    fa::cp_async_wait<1>();  // Q and K(kt) have landed; V(kt) may still be in flight
    __syncthreads();

    float s[RPT][CPT];
    fa::rows_dot_rows<D, LD, LD, CPT>(s, Qs, Ks, ty, tx);
    __syncthreads();  // every thread is done with K(kt)
    if (kt + 1 < n_kt) load_rows(Ks, kg, k0 + BK, BK, sk);
    fa::cp_async_commit();

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = q0 + ty + 16 * i;
      const int lim = causal ? min(sk, row + offset + 1) : sk;  // cols >= lim are masked
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = k0 + tx + 8 * j;
        float x = s[i][j] * scale;
        if (col >= lim) x = NEG_INF;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = fa::fast_exp(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = k0 + tx + 8 * j;
        // masked entries give p = 0 even in a fully masked row, where
        // m_new is NEG_INF and exp(s - m_new) would be 1
        float p = (s[i][j] == NEG_INF) ? 0.f : fa::fast_exp(s[i][j] - m_new);
        psum += p;
        if (dropout) p = fa::keep(bseed, row, col, sk, keep_thresh) ? p * inv_keep : 0.f;
        Ps[(ty + 16 * i) * PS + tx + 8 * j] = p;
      }
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[i] = l[i] * alpha + psum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) acc[i][j] *= alpha;
    }
    fa::cp_async_wait<1>();  // V(kt) has landed; K(kt + 1) may still be in flight
    __syncthreads();         // ... for every thread, and P is complete

    fa::rows_times_tile<BK, D, PS, LD>(acc, Ps, Vs, ty, tx);
    __syncthreads();  // every thread is done with V(kt) and P
    if (kt + 1 < n_kt) load_rows(Vs, vg, k0 + BK, BK, sk);
    fa::cp_async_commit();
  }
  fa::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < sq) {
      const float ll = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int g = 0; g < GPT; ++g) {
        const float4 out = make_float4(acc[i][4 * g] / ll, acc[i][4 * g + 1] / ll,
                                       acc[i][4 * g + 2] / ll, acc[i][4 * g + 3] / ll);
        *reinterpret_cast<float4*>(&o[((size_t)bh * sq + row) * D + tx * 4 + 32 * g]) = out;
      }
      if (tx == 0) lse[(size_t)bh * sq + row] = m[i] + logf(ll);
    }
  }
}

// ------------------------------------------------------------------ bf16
// three blocks per SM at head_dim 64 (ptxas otherwise picks 128
// registers there and spills); head_dim 128 needs ~200 registers
template <int D>
__global__ void __launch_bounds__(THREADS, D == 64 ? 3 : 1)
fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                float* __restrict__ lse, int sq, int sk, float scale, int causal, int dropout,
                uint32_t seed, uint32_t keep_thresh, float inv_keep) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LD = Bf16Layout<D>::LD;
  constexpr int KSTEPS = D / 16;  // k steps of Q K^T
  constexpr int NT = BK / 8;      // n8 tiles of S
  constexpr int DT = D / 8;       // n8 tiles of O
  constexpr int CH = D / 8;       // 16-byte chunks per row
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BQ][LD]
  __nv_bfloat16* KVs = Qs + BQ * LD;  // 2 stages x (K [BK][LD], V [BK][LD])

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int t = lane & 3;
  const int row_lo = q0 + warp * 16 + (lane >> 2);  // C-fragment rows: row_lo, row_lo + 8
  const __nv_bfloat16* qg = q + (size_t)bh * sq * D;
  const __nv_bfloat16* kg = k + (size_t)bh * sk * D;
  const __nv_bfloat16* vg = v + (size_t)bh * sk * D;
  const int offset = sk - sq;
  const int n_kt = fa::k_tiles<BQ, BK>(q0, sq, sk, causal);
  // ldmatrix row/column of this lane inside a 16 x 16 block
  const int lm_r = (lane & 7) + ((lane >> 3) & 1) * 8;  // A order: row half from lane bit 3
  const int lm_c = (lane >> 4) * 8;
  const int lb_r = (lane & 7) + (lane >> 4) * 8;        // B order: n half from lane bit 4
  const int lb_c = ((lane >> 3) & 1) * 8;

  for (int i = tid; i < BQ * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool ok = q0 + r < sq;
    fa::cp_async16(&Qs[r * LD + c], ok ? qg + (size_t)(q0 + r) * D + c : qg, ok);
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
  uint32_t qf[KSTEPS][4];
  float oacc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  // cols >= lim[h] are masked in row row_lo + 8 h
  int lim[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) lim[h] = causal ? min(sk, row_lo + 8 * h + offset + 1) : sk;

  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) {
      load_kv(kt + 1);
      fa::cp_async_commit();
      fa::cp_async_wait<1>();
    } else {
      fa::cp_async_wait<0>();
    }
    __syncthreads();  // tile kt (and Q) visible to every thread
    if (kt == 0) {
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks)
        fa::ldmatrix_x4(qf[ks], &Qs[(warp * 16 + lm_r) * LD + ks * 16 + lm_c]);
    }
    const __nv_bfloat16* Ks = KVs + (kt & 1) * 2 * BK * LD;
    const __nv_bfloat16* Vs = Ks + BK * LD;
    const int k0 = kt * BK;

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        fa::ldmatrix_x4(b, &Ks[(np * 16 + lb_r) * LD + ks * 16 + lb_c]);
        fa::mma_bf16(s[2 * np], qf[ks], b[0], b[1]);
        fa::mma_bf16(s[2 * np + 1], qf[ks], b[2], b[3]);
      }
    }

    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + 2 * t + (e & 1);
        float x = s[nt][e] * scale;
        if (col >= lim[e >> 1]) x = NEG_INF;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float m_new[2], alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      m_new[h] = fmaxf(m[h], mx[h]);
      alpha[h] = fa::fast_exp(m[h] - m_new[h]);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        // masked entries give p = 0 even in a fully masked row
        float p = (s[nt][e] == NEG_INF) ? 0.f : fa::fast_exp(s[nt][e] - m_new[h]);
        psum[h] += p;
        if (dropout) {
          const int row = row_lo + h * 8;
          const int col = k0 + nt * 8 + 2 * t + (e & 1);
          p = fa::keep(bseed, row, col, sk, keep_thresh) ? p * inv_keep : 0.f;
        }
        s[nt][e] = p;
      }
    // P rounded to bf16: the C fragments of S tiles 2j, 2j+1 are the A
    // fragment of keys 16j..16j+15
    uint32_t pf[NT / 2][4];
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      pf[j][0] = fa::pack_bf16(s[2 * j][0], s[2 * j][1]);
      pf[j][1] = fa::pack_bf16(s[2 * j][2], s[2 * j][3]);
      pf[j][2] = fa::pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
      pf[j][3] = fa::pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      psum[h] += __shfl_xor_sync(0xffffffffu, psum[h], 1);
      psum[h] += __shfl_xor_sync(0xffffffffu, psum[h], 2);
      l[h] = l[h] * alpha[h] + psum[h];
      m[h] = m_new[h];
    }
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      oacc[n][0] *= alpha[0];
      oacc[n][1] *= alpha[0];
      oacc[n][2] *= alpha[1];
      oacc[n][3] *= alpha[1];
    }
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
#pragma unroll
      for (int np = 0; np < DT / 2; ++np) {
        uint32_t b[4];
        fa::ldmatrix_x4_trans(b, &Vs[(j * 16 + lm_r) * LD + np * 16 + lm_c]);
        fa::mma_bf16(oacc[2 * np], pf[j], b[0], b[1]);
        fa::mma_bf16(oacc[2 * np + 1], pf[j], b[2], b[3]);
      }
    }
    __syncthreads();  // this stage's K/V are read before they are refilled
  }
  fa::cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_lo + h * 8;
    if (row < sq) {
      const float ll = fmaxf(l[h], 1e-30f);
      uint32_t* orow = reinterpret_cast<uint32_t*>(o + ((size_t)bh * sq + row) * D + 2 * t);
#pragma unroll
      for (int n = 0; n < DT; ++n)
        orow[n * 4] = fa::pack_bf16(oacc[n][2 * h] / ll, oacc[n][2 * h + 1] / ll);
      if (t == 0) lse[(size_t)bh * sq + row] = m[h] + logf(ll);
    }
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                       int sq, int sk, float scale, int causal, int dropout, uint32_t seed,
                       uint32_t keep_thresh, float inv_keep, cudaStream_t stream) {
  constexpr size_t smem = F32Layout<D>::bytes;
  auto kern = fwd_f32_kernel<D>;
  FA_OPT_IN_SMEM_ONCE(kern, smem);  // above 48 KB a block has to opt in
  const dim3 grid(bh, (sq + BQ - 1) / BQ);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), sq, sk, scale, causal, dropout, seed,
      keep_thresh, inv_keep);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                        int sq, int sk, float scale, int causal, int dropout, uint32_t seed,
                        uint32_t keep_thresh, float inv_keep, cudaStream_t stream) {
  constexpr size_t smem = Bf16Layout<D>::bytes;
  auto kern = fwd_bf16_kernel<D>;
  FA_OPT_IN_SMEM_ONCE(kern, smem);
  const dim3 grid(bh, (sq + BQ - 1) / BQ);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), sq, sk, scale, causal, dropout, seed, keep_thresh, inv_keep);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q [bh, sq, d], k/v [bh, sk, d] contiguous and 16-byte aligned, dtype 0 =
// float32, 1 = bfloat16; o [bh, sq, d] in the input dtype, lse [bh, sq]
// float32. Returns the cudaError_t of the launch (0 = success);
// cudaErrorInvalidValue for a head_dim or dtype this kernel does not take.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                        int bh, int sq, int sk, int d, float scale, int causal, int dropout,
                        unsigned int seed, unsigned int keep_thresh, float inv_keep,
                        int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && d == 64)
    return launch_f32<64>(q, k, v, o, lse, bh, sq, sk, scale, causal, dropout, seed,
                          keep_thresh, inv_keep, st);
  if (dtype == 0 && d == 128)
    return launch_f32<128>(q, k, v, o, lse, bh, sq, sk, scale, causal, dropout, seed,
                           keep_thresh, inv_keep, st);
  if (dtype == 1 && d == 64)
    return launch_bf16<64>(q, k, v, o, lse, bh, sq, sk, scale, causal, dropout, seed,
                           keep_thresh, inv_keep, st);
  if (dtype == 1 && d == 128)
    return launch_bf16<128>(q, k, v, o, lse, bh, sq, sk, scale, causal, dropout, seed,
                            keep_thresh, inv_keep, st);
  return (int)cudaErrorInvalidValue;
}

// dynamic shared memory of one block for head_dim d and dtype (0 = float32,
// 1 = bfloat16), or -1
int flash_attention_fwd_smem_bytes(int d, int dtype) {
  if (dtype == 0 && d == 64) return (int)F32Layout<64>::bytes;
  if (dtype == 0 && d == 128) return (int)F32Layout<128>::bytes;
  if (dtype == 1 && d == 64) return (int)Bf16Layout<64>::bytes;
  if (dtype == 1 && d == 128) return (int)Bf16Layout<128>::bytes;
  return -1;
}

const char* flash_attention_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
