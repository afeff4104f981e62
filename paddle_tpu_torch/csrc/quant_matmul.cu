// Weight-only dequantizing matrix product for Hopper (sm_90a), plain C
// interface for ctypes: out[M, N] f32 = x[M, K] f32 @ (w[K, N] -> f32 * scale[N]).
//
// No TPU kernel of the reference computes this: the reference's quantized
// serving (paddle_tpu/quantization/serving.py `quantize_decode_model`'s
// `unpack`, :213-222; post_training.py `Int8Linear.forward`, :48-52)
// dequantizes and multiplies in plain jnp, and XLA fuses the dequantize
// into the product's read of the weights. This kernel is the port's
// counterpart of that fusion. Two weight forms:
//   w8    int8 weights with one f32 scale per output column, each weight
//         dequantized as float(q) * scale[n] (one IEEE product, the
//         reference's `q.astype(f32) * s`);
//   bf16w bf16 weights widened to f32 (exact), no scale.
// Accumulation is f32 FMA on the CUDA cores (no TF32, which would change
// the reference's f32 arithmetic).
//
// What bounds it on an H100: at the decode step's M = 16 rows the work is
// 16 FMAs per weight read, so the f32 CUDA cores (67 TFLOP/s) bound it
// below the bytes of int8 weights (3.35 TB/s) and about level with bf16;
// at a fill's M = 128 the operations bound every form. So the design
// spends few instructions beside the FMAs: every weight is dequantized
// once per block and used for 16 rows, every x value staged in shared
// memory is used for 8 columns, and int8 becomes f32 without a conversion
// instruction (a byte permute into the mantissa of 2^23 + 128 + q, then
// one exact subtraction).
//
// Layout: one block of 128 threads per tile of 16 rows x 32 columns
// (grid: row tiles x column tiles, so neighbouring blocks share their
// weight tile in L2). Thread (cg, s) owns 8 columns (cg = tid % 4) of all
// 16 rows, 128 f32 accumulators, over k slice s (tid / 4, 32 slices): in
// every chunk of 256 k, slice s takes k = 8s .. 8s + 7 in order. Chunks of
// x rows (16 x 256 f32) and of the weight tile (256 x 32) are staged into
// shared memory by 16-byte cp.async in a two-stage ring, the next chunk's
// copy overlapping this chunk's products; the weight tile's slices are
// skewed by one row so that the lanes of a load read distinct banks.
// Ragged edges (rows past M, columns past N, k past K) are zero-filled in
// shared memory and never stored. The 32 slice partials of each output are
// then summed through shared memory in slice order, 0 to 31, with no
// atomics. So the order of every output's sum is fixed by K alone: a
// row's bits do not depend on M, on the other rows, or on the launch.
#include "flash_attention_sm90.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int ROWS = 16;            // x rows per block
constexpr int COLS = 8;             // columns per thread
constexpr int CG = 4;               // column groups per block
constexpr int NT = CG * COLS;       // 32 columns per block
constexpr int SLICES = THREADS / CG;  // 32 k slices
constexpr int U = 8;                // k per slice per chunk
constexpr int KC = SLICES * U;      // 256 k per chunk

// WB: bytes of one weight (1 int8, 2 bf16)
template <int WB>
struct Layout {
  static constexpr int ROW_BYTES = NT * WB;                  // one k row of the tile
  static constexpr int SLICE_BYTES = (U + 1) * ROW_BYTES;    // U rows + one row of skew
  static constexpr int X_BYTES = ROWS * KC * 4;              // x chunk [ROWS][KC] f32
  static constexpr int W_BYTES = SLICES * SLICE_BYTES;
  static constexpr int STAGE_BYTES = X_BYTES + W_BYTES;
  static constexpr int RED_BYTES = SLICES * ROWS * NT * 4;   // partials [SLICES][ROWS][NT]
  static constexpr int bytes =
      2 * STAGE_BYTES > RED_BYTES ? 2 * STAGE_BYTES : RED_BYTES;
};

// chunk c of x's row tile and of the weight tile into one stage
template <int WB>
__device__ __forceinline__ void stage_chunk(unsigned char* stage, const float* x,
                                            const unsigned char* w, int M, int N, int K,
                                            int row0, int n0, int k0, int tid) {
  using L = Layout<WB>;
  float* xs = reinterpret_cast<float*>(stage);
  unsigned char* ws = stage + L::X_BYTES;
  // x: ROWS x KC / 4 pieces of 16 bytes (K % 4 == 0, so a piece is all in
  // range or all out)
  constexpr int X_PIECES = ROWS * KC / 4;
#pragma unroll
  for (int i = 0; i < X_PIECES / THREADS; ++i) {
    const int p = tid + i * THREADS;
    const int r = p / (KC / 4), j = p % (KC / 4);
    const int row = row0 + r, k = k0 + 4 * j;
    const bool ok = row < M && k < K;
    fa::cp_async16(xs + r * KC + 4 * j, ok ? x + (size_t)row * K + k : x, ok);
  }
  // weights: KC rows of ROW_BYTES, 16 bytes a piece (N * WB % 16 == 0)
  constexpr int PPR = L::ROW_BYTES / 16;
  constexpr int W_PIECES = KC * PPR;
#pragma unroll
  for (int i = 0; i < W_PIECES / THREADS; ++i) {
    const int p = tid + i * THREADS;
    const int kr = p / PPR, j = p % PPR;
    const int k = k0 + kr;
    const int col = n0 + j * (16 / WB);
    const bool ok = k < K && col < N;
    unsigned char* dst = ws + (kr / U) * L::SLICE_BYTES + (kr % U) * L::ROW_BYTES + 16 * j;
    fa::cp_async16(dst, ok ? w + ((size_t)k * N + col) * WB : w, ok);
  }
}

// 8 int8 weights -> f32, each float(q) * scale exactly: the byte q ^ 0x80
// = q + 128 goes into the low mantissa bits of 2^23 (0x4B000000), and
// subtracting 2^23 + 128 leaves q (both steps exact)
__device__ __forceinline__ void dequant_w8(const unsigned char* p, const float (&sc)[COLS],
                                           float (&w)[COLS]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const uint32_t lo = v.x ^ 0x80808080u, hi = v.y ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float a = __uint_as_float(__byte_perm(lo, 0x4B000000u, 0x7440 + i));
    const float b = __uint_as_float(__byte_perm(hi, 0x4B000000u, 0x7440 + i));
    w[i] = __fmul_rn(__fsub_rn(a, 8388736.0f), sc[i]);
    w[4 + i] = __fmul_rn(__fsub_rn(b, 8388736.0f), sc[4 + i]);
  }
}

// 8 bf16 weights -> f32 (exact: the bf16 bits are the f32's upper half)
__device__ __forceinline__ void dequant_bf16(const unsigned char* p, float (&w)[COLS]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[2 * i] = __uint_as_float(u[i] << 16);
    w[2 * i + 1] = __uint_as_float(u[i] & 0xFFFF0000u);
  }
}

template <typename W>
__global__ void __launch_bounds__(THREADS)
    wq_matmul_kernel(const float* __restrict__ x, const unsigned char* __restrict__ w,
                     const float* __restrict__ scale, float* __restrict__ out, int M, int N,
                     int K) {
  constexpr int WB = sizeof(W);
  using L = Layout<WB>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int cg = tid % CG, s = tid / CG;
  const int row0 = blockIdx.x * ROWS, n0 = blockIdx.y * NT;
  const int col0 = n0 + cg * COLS;

  float sc[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c)
    sc[c] = (scale != nullptr && col0 + c < N) ? scale[col0 + c] : 1.0f;
  float acc[ROWS][COLS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[r][c] = 0.0f;

  const int chunks = (K + KC - 1) / KC;
  stage_chunk<WB>(smem, x, w, M, N, K, row0, n0, 0, tid);
  fa::cp_async_commit();
  for (int ch = 0; ch < chunks; ++ch) {
    if (ch + 1 < chunks)
      stage_chunk<WB>(smem + ((ch + 1) & 1) * L::STAGE_BYTES, x, w, M, N, K, row0, n0,
                      (ch + 1) * KC, tid);
    fa::cp_async_commit();
    fa::cp_async_wait<1>();  // chunk ch has landed
    __syncthreads();
    const unsigned char* stage = smem + (ch & 1) * L::STAGE_BYTES;
    const float* xs = reinterpret_cast<const float*>(stage) + s * U;
    const unsigned char* ws = stage + L::X_BYTES + s * L::SLICE_BYTES + cg * COLS * WB;
#pragma unroll
    for (int q = 0; q < U / 4; ++q) {
      // four k: their weights dequantized once, then one float4 of x a row
      float wv[4][COLS];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if constexpr (WB == 1)
          dequant_w8(ws + (4 * q + kk) * L::ROW_BYTES, sc, wv[kk]);
        else
          dequant_bf16(ws + (4 * q + kk) * L::ROW_BYTES, wv[kk]);
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 xv = *reinterpret_cast<const float4*>(xs + r * KC + 4 * q);
        const float xk[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int c = 0; c < COLS; ++c) acc[r][c] = __fmaf_rn(xk[kk], wv[kk][c], acc[r][c]);
      }
    }
    __syncthreads();  // this stage is read before chunk ch + 2 refills it
  }
  fa::cp_async_wait<0>();

  // the slices' partials, summed in slice order
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    float4* dst = reinterpret_cast<float4*>(red + (s * ROWS + r) * NT + cg * COLS);
    dst[0] = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    dst[1] = make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
  }
  __syncthreads();
  for (int o = tid; o < ROWS * NT; o += THREADS) {
    const int r = o / NT, n = o % NT;
    float v = red[r * NT + n];
#pragma unroll 8
    for (int sl = 1; sl < SLICES; ++sl) v = __fadd_rn(v, red[(sl * ROWS + r) * NT + n]);
    if (row0 + r < M && n0 + n < N) out[(size_t)(row0 + r) * N + n0 + n] = v;
  }
}

template <typename W>
cudaError_t launch(const void* x, const void* w, const void* scale, void* out, int M, int N,
                   int K, cudaStream_t stream) {
  constexpr size_t smem = Layout<sizeof(W)>::bytes;
  auto kern = wq_matmul_kernel<W>;
  FA_OPT_IN_SMEM_ONCE(kern, smem);  // above 48 KB a block has to opt in
  const dim3 grid((M + ROWS - 1) / ROWS, (N + NT - 1) / NT);
  kern<<<grid, THREADS, smem, stream>>>(static_cast<const float*>(x),
                                        static_cast<const unsigned char*>(w),
                                        static_cast<const float*>(scale),
                                        static_cast<float*>(out), M, N, K);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [M, K] f32 contiguous, K % 4 == 0; w [K, N] contiguous, int8 (wdtype
// 0, N % 16 == 0, with scale f32 [N]) or bf16 (wdtype 1, N % 8 == 0, scale
// null); out [M, N] f32. x and w start on 16-byte boundaries. Returns the
// cudaError_t of the launch (0 = success); cudaErrorInvalidValue for a
// form or shape this kernel does not take.
int quant_matmul(const void* x, const void* w, const void* scale, void* out, int M, int N,
                 int K, int wdtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 1 || N < 1 || K < 1 || K % 4 != 0) return (int)cudaErrorInvalidValue;
  if (wdtype == 0 && N % 16 == 0 && scale != nullptr)
    return launch<unsigned char>(x, w, scale, out, M, N, K, st);
  if (wdtype == 1 && N % 8 == 0 && scale == nullptr)
    return launch<__nv_bfloat16>(x, w, scale, out, M, N, K, st);
  return (int)cudaErrorInvalidValue;
}

// dynamic shared memory of one block for wdtype (0 int8, 1 bf16), or -1
int quant_matmul_smem_bytes(int wdtype) {
  if (wdtype == 0) return (int)Layout<1>::bytes;
  if (wdtype == 1) return (int)Layout<2>::bytes;
  return -1;
}

const char* quant_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
