// Weight-only dequantizing matrix product for Hopper (sm_90a), plain C
// interface for ctypes: out[M, N] f32 = x[M, K] f32 @ (w[K, N] -> f32 * scale[N]).
//
// No TPU kernel of the reference computes this: the reference's quantized
// serving (paddle_tpu/quantization/serving.py `quantize_decode_model`'s
// `unpack`, :213-222; post_training.py `Int8Linear.forward`, :48-52)
// dequantizes and multiplies in plain jnp, and XLA fuses the dequantize
// into the product's read of the weights. This kernel is the port's
// counterpart of that fusion. Two weight forms:
//   w8    int8 weights with one f32 scale per output column;
//   bf16w bf16 weights, no scale.
//
// The product runs on the bf16 tensor cores (mma.sync m16n8k16, f32
// accumulators) and keeps f32 accuracy, with no TF32:
//   - every weight is exact in bf16: an int8 q has at most 8 significant
//     bits, and a bf16w weight is bf16 already;
//   - x is split exactly into three bf16 pieces, hi = bf16_rn(x),
//     r = x - hi, mid = bf16_rn(r), lo = bf16_rn(r - mid). r and r - mid
//     are exact f32 differences: x has 24 significant bits, hi takes the
//     top 8, |r| is at most half an ulp of hi and so fits in 16 bits, mid
//     takes 8 of those and r - mid has at most 8 left, so lo is r - mid
//     exactly and hi + mid + lo == x (for |x| in [2^-103, bf16's largest],
//     where no piece is subnormal or overflows; ops/quant_matmul.py
//     `split_bf16` is the torch twin, held bitwise by the CPU tests);
//   - each piece times a weight is exact in the MMA's f32 product, so only
//     the accumulation rounds: per k-step of 16 the three passes add to one
//     accumulator, smallest piece first (lo, mid, hi);
//   - the w8 scale is applied in the epilogue, out = (sum of x q) * s,
//     where the reference rounds q * s per element first: the two differ
//     by about an ulp of each product, far inside the 1e-4 (of the
//     output's max) tolerance the kernel is held to.
//
// What bounds it on an H100: the least time for an f32-accurate product
// is max(bytes / 3.35 TB/s, 3 x 2 M K N / 989 TFLOP/s). At the decode
// step's M = 16 that is the weights' bytes at every shape of the path; at
// a fill's M = 128 the three passes' tensor-core operations. The weights
// never leave their [K, N] layout: int8 or bf16 tiles are staged as they
// lie and transposed by ldmatrix.trans on the way into registers.
//
// Layout: a block of 4 warps owns 32 rows of x (MT) by 128 columns (NT,
// 32 a warp) over one split of K. The operands are swapped (out^T =
// w^T x^T): the weight columns ride the MMA's 16-row side and the x rows
// its 8-wide side, four n8 tiles. The K loop is compiled twice, with the
// upper two tiles and without, and a block that holds no row past its
// first 16 (every block at M <= 16) runs the one without: no loads, split
// or MMAs for rows that are all past M. Chunks of 64 k of the weight tile
// are staged by 16-byte cp.async in a ring (4 stages of int8, 3 of bf16,
// so that three blocks fit on an SM), zero-filled past N and K. x runs
// two chunks ahead in registers (zero past M and K) and each chunk is
// split once into its three bf16 pieces in shared memory (double-
// buffered), read by every warp. Tiles are XOR-swizzled by row in 16-byte
// chunks so that ldmatrix reads distinct banks. int8 weights come into
// registers as 2 x 2 byte blocks (ldmatrix.trans of byte pairs) and are
// widened to bf16 pairs without a conversion instruction: q's low 7 bits
// go into the mantissa of 128 and one exact bf16x2 subtraction of 128 or
// 256 (by q's sign bit) leaves q.
//
// Split-K: K is cut into S splits, S a function of (K, N) only (`splits`
// below: enough blocks for two on each SM at M <= 32, at most 8 and at
// least 4 chunks a split). The S blocks of one output tile form a thread
// block cluster; each leaves its partial in its shared memory and the
// cluster sums them in split order, 0 to S - 1, through distributed shared
// memory, with no global scratch and no atomics. So the order of every
// output's sum (k-steps, passes, splits) is fixed by K and N: no tile
// size or split count depends on M, the two compiled K loops run the same
// MMAs in the same order on every row below M (the one without the upper
// tiles skips only rows past M, never stored), and an MMA's output depends
// only on its own row and column, so a row's bits do not depend on how
// many rows a call has or where in a tile the row lies.
#include <cooperative_groups.h>

#include <type_traits>

#include "flash_attention_sm90.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 128;
constexpr int MT = 32;               // x rows per block: four n8 tiles of the MMA
constexpr int NT = 128;              // weight columns per block, 32 a warp
constexpr int KC = 64;               // k per chunk (one stage of the weight ring)
constexpr int MAX_SPLITS = 8;        // the portable cluster size
constexpr int TARGET_BLOCKS = 264;   // two blocks on each of the H100's 132 SMs at M <= 32
constexpr int MIN_SPLIT_CHUNKS = 4;  // a split takes at least 4 chunks (256 k)
constexpr int RED_STRIDE = NT + 4;   // floats per row of the partial tile
constexpr int X_ITEMS = MT * KC / 4 / THREADS;  // float4s of an x chunk per thread
constexpr int HALVES = MT / 16;                 // 16-row halves of the block's x rows
constexpr int PIECE_BYTES = MT * KC * 2;        // one piece of an x chunk, [MT][KC] bf16
constexpr int PIECES_BYTES = 3 * PIECE_BYTES;   // lo, mid, hi of one chunk

// the split count of a (K, N) product
int splits(int K, int N) {
  const int chunks = (K + KC - 1) / KC, tiles = (N + NT - 1) / NT;
  int s = (TARGET_BLOCKS + tiles - 1) / tiles;
  s = s < MAX_SPLITS ? s : MAX_SPLITS;
  const int by_k = chunks / MIN_SPLIT_CHUNKS;
  s = s < by_k ? s : by_k;
  return s > 1 ? s : 1;
}

// WB: bytes of one weight (1 int8, 2 bf16)
template <int WB>
struct Layout {
  static constexpr int STAGES = WB == 1 ? 4 : 3;             // the weight ring
  static constexpr int ROW_BYTES = NT * WB;                  // one k row of the weight tile
  static constexpr int W_BYTES = KC * ROW_BYTES;             // weight chunk [KC][NT]
  static constexpr int RED_BYTES = MT * RED_STRIDE * 4;      // the block's partial, f32
  static_assert(RED_BYTES <= STAGES * W_BYTES, "the partial reuses the ring");
  static constexpr int bytes = STAGES * W_BYTES + 2 * PIECES_BYTES;
};

// 16-byte chunk c of row r of a tile, XOR-swizzled by the row's low 3 bits
__device__ __forceinline__ int swz(int r, int c) { return (c ^ (r & 7)) << 4; }

// weight chunk k0 .. k0 + KC of the block's columns into one stage: KC rows
// of ROW_BYTES in 16-byte chunks (N * WB % 16 == 0, so a chunk is all in
// range or all out), zero-filled past N and K
template <int WB>
__device__ __forceinline__ void stage_weights(unsigned char* ws, const unsigned char* w, int N,
                                              int K, int n0, int k0, int tid) {
  using L = Layout<WB>;
  constexpr int CPR = L::ROW_BYTES / 16;
#pragma unroll
  for (int i = 0; i < KC * CPR / THREADS; ++i) {
    const int p = tid + i * THREADS;
    const int kr = p / CPR, c = p % CPR;
    const int k = k0 + kr, col = n0 + c * (16 / WB);
    const bool ok = k < K && col < N;
    fa::cp_async16(ws + kr * L::ROW_BYTES + swz(kr, c),
                   ok ? w + ((size_t)k * N + col) * WB : w, ok);
  }
}

// x chunk k0 .. k0 + KC of the block's rows into registers, X_ITEMS runs of
// 4 k a thread; zero past M and K (K % 4 == 0, so a run is all in or out)
__device__ __forceinline__ void load_x(float4 (&v)[X_ITEMS], const float* x, int M, int K,
                                       int m0, int k0, int tid, bool upper) {
#pragma unroll
  for (int i = 0; i < X_ITEMS; ++i) {
    if (i >= X_ITEMS / HALVES && !upper) break;  // rows 16..31 are past M
    const int p = tid + i * THREADS;
    const int row = m0 + p / (KC / 4), k = k0 + 4 * (p % (KC / 4));
    v[i] = row < M && k < K ? *reinterpret_cast<const float4*>(x + (size_t)row * K + k)
                            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// the exact split of two x values, as bf16 pairs (the first value in the
// low half): hi = bf16_rn(x), mid = bf16_rn(x - hi), lo = bf16_rn(x - hi -
// mid); a bf16 pair's halves widen to f32 exactly by shifting
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi, uint32_t& mid,
                                           uint32_t& lo) {
  hi = fa::pack_bf16(x0, x1);
  const float r0 = __fsub_rn(x0, __uint_as_float(hi << 16));
  const float r1 = __fsub_rn(x1, __uint_as_float(hi & 0xFFFF0000u));
  mid = fa::pack_bf16(r0, r1);
  lo = fa::pack_bf16(__fsub_rn(r0, __uint_as_float(mid << 16)),
                     __fsub_rn(r1, __uint_as_float(mid & 0xFFFF0000u)));
}

// the x chunk held in registers -> its pieces lo, mid, hi [MT][KC] bf16 in
// shared memory, 16-byte chunks swizzled by row for ldmatrix
__device__ __forceinline__ void split_x(const float4 (&v)[X_ITEMS], unsigned char* pieces,
                                        int tid, bool upper) {
#pragma unroll
  for (int i = 0; i < X_ITEMS; ++i) {
    if (i >= X_ITEMS / HALVES && !upper) break;  // rows 16..31: no MMA reads them
    const int p = tid + i * THREADS;
    const int m = p / (KC / 4), q = p % (KC / 4);
    uint32_t hi[2], mid[2], lo[2];
    split_pair(v[i].x, v[i].y, hi[0], mid[0], lo[0]);
    split_pair(v[i].z, v[i].w, hi[1], mid[1], lo[1]);
    const int off = m * KC * 2 + swz(m, q >> 1) + (q & 1) * 8;
    *reinterpret_cast<uint2*>(pieces + off) = make_uint2(lo[0], lo[1]);
    *reinterpret_cast<uint2*>(pieces + PIECE_BYTES + off) = make_uint2(mid[0], mid[1]);
    *reinterpret_cast<uint2*>(pieces + 2 * PIECE_BYTES + off) = make_uint2(hi[0], hi[1]);
  }
}

// the int8 q in the low bytes of u's two 16-bit lanes -> a bf16 pair:
// with v = q's low 7 bits and b7 its sign bit, 0x4300 | v is the bf16 of
// 128 + v and 0x4300 | b7 << 7 that of 128 + 128 b7, and their difference
// is v - 128 b7 = q, exact in a bf16x2 subtraction
__device__ __forceinline__ uint32_t widen_pair(uint32_t u) {
  const uint32_t t = (u & 0x007F007Fu) | 0x43004300u, c = (u & 0x00800080u) | 0x43004300u;
  const __nv_bfloat162 d = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&t),
                                   *reinterpret_cast<const __nv_bfloat162*>(&c));
  return *reinterpret_cast<const uint32_t*>(&d);
}

// the warp's two A fragments (weight columns 32 w .. 32 w + 31, k-step kk
// of the staged chunk), bf16 in the m16n8k16 layout; see `col_of` for the
// columns their rows stand for
template <int WB>
__device__ __forceinline__ void load_a(uint32_t (&a)[2][4], const unsigned char* ws, int kk,
                                       int warp, int lane) {
  using L = Layout<WB>;
  const int i = lane >> 3, r = lane & 7;
  if constexpr (WB == 1) {
    // one ldmatrix.x4.trans of byte pairs: matrix i covers k rows
    // 16 kk + 8 (i & 1) + 0..7 and columns 32 w + 16 (i >> 1) + 0..15; lane
    // (g, t) gets q[k 2t, 2t + 1][n 2g, 2g + 1] of each
    const int k = 16 * kk + 8 * (i & 1) + r;
    uint32_t v[4];
    fa::ldmatrix_x4_trans(v, ws + k * L::ROW_BYTES + swz(k, 2 * warp + (i >> 1)));
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      const uint32_t u0 = v[2 * f], u1 = v[2 * f + 1];
      a[f][0] = widen_pair(u0);       // bytes 0, 2: row g, column 2g, k 2t, 2t + 1
      a[f][1] = widen_pair(u0 >> 8);  // bytes 1, 3: row g + 8, column 2g + 1
      a[f][2] = widen_pair(u1);       // k 2t + 8, 2t + 9
      a[f][3] = widen_pair(u1 >> 8);
    }
  } else {
    // one ldmatrix.x4.trans a fragment: matrix i covers k rows
    // 16 kk + 8 (i >> 1) + 0..7 and columns 32 w + 16 f + 8 (i & 1) + 0..7
    const int k = 16 * kk + 8 * (i >> 1) + r;
#pragma unroll
    for (int f = 0; f < 2; ++f)
      fa::ldmatrix_x4_trans(a[f], ws + k * L::ROW_BYTES + swz(k, 4 * warp + 2 * f + (i & 1)));
  }
}

// the column (within the warp's 32) of C fragment f's row g (c0, c1) and
// row g + 8 (c2, c3)
template <int WB>
__device__ __forceinline__ int col_of(int f, int g, bool upper) {
  if constexpr (WB == 1) return 16 * f + 2 * g + (upper ? 1 : 0);
  return 16 * f + g + (upper ? 8 : 0);
}

// one piece's k-step: both A fragments times the n8 tiles of x rows; the
// upper pair of tiles (rows 16..31 of the block) only where it holds a row
// below M
__device__ __forceinline__ void mma_piece(float (&acc)[2][2 * HALVES][4],
                                          const uint32_t (&a)[2][4], const unsigned char* piece,
                                          int kk, int lane, bool upper) {
#pragma unroll
  for (int h = 0; h < HALVES; ++h) {
    if (h == 1 && !upper) break;
    // matrix i: x rows 16 h + 8 (i >> 1) + 0..7, k 16 kk + 8 (i & 1) + 0..7;
    // b[2j], b[2j + 1] are n8 tile 2 h + j's two k halves
    const int i = lane >> 3, m = 16 * h + (lane & 7) + 8 * (i >> 1);
    uint32_t b[4];
    fa::ldmatrix_x4(b, piece + m * KC * 2 + swz(m, 2 * kk + (i & 1)));
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int j = 0; j < 2; ++j) fa::mma_bf16(acc[f][2 * h + j], a[f], b[2 * j], b[2 * j + 1]);
  }
}

template <typename W>
__global__ void __launch_bounds__(THREADS)
    wq_matmul_kernel(const float* __restrict__ x, const unsigned char* __restrict__ w,
                     const float* __restrict__ scale, float* __restrict__ out, int M, int N,
                     int K) {
  constexpr int WB = sizeof(W);
  using L = Layout<WB>;
  constexpr int STAGES = L::STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.block_rank(), nsplit = (int)cluster.num_blocks();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.y * NT, m0 = blockIdx.z * MT;
  const int chunks = (K + KC - 1) / KC;
  const int c0 = split * chunks / nsplit, nch = (split + 1) * chunks / nsplit - c0;
  unsigned char* pieces = smem + STAGES * L::W_BYTES;  // two buffers of PIECES_BYTES
  const int rows = M - m0 < MT ? M - m0 : MT;  // x rows of this block below M

  float acc[2][2 * HALVES][4];
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int j = 0; j < 2 * HALVES; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[f][j][e] = 0.0f;

  // the K loop, compiled twice: with the upper n8 tiles and without
  auto k_loop = [&](auto has_upper) {
    constexpr bool upper = decltype(has_upper)::value;
    // the weight ring runs STAGES - 1 chunks ahead. x runs two chunks ahead
    // in registers (xa, xb in turn): chunk ch + 1, loaded during chunk
    // ch - 1, is split into the other pieces buffer after chunk ch's MMAs
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nch) stage_weights<WB>(smem + s * L::W_BYTES, w, N, K, n0, (c0 + s) * KC, tid);
      fa::cp_async_commit();
    }
    float4 xa[X_ITEMS], xb[X_ITEMS];
    load_x(xa, x, M, K, m0, c0 * KC, tid, upper);
    split_x(xa, pieces, tid, upper);
    if (nch > 1) load_x(xa, x, M, K, m0, (c0 + 1) * KC, tid, upper);
    // one chunk: its MMAs, x of chunk ch + 2 loaded into xn, chunk ch + 1's
    // (in xs) split
    auto chunk = [&](int ch, float4 (&xs)[X_ITEMS], float4 (&xn)[X_ITEMS]) {
      fa::cp_async_wait<STAGES - 2>();  // weight chunk ch has landed
      // for every thread; so have chunk ch's pieces, and chunk ch - 1's stage
      // and pieces are free
      __syncthreads();
      const int next = ch + STAGES - 1;
      if (next < nch)
        stage_weights<WB>(smem + (next % STAGES) * L::W_BYTES, w, N, K, n0, (c0 + next) * KC,
                          tid);
      fa::cp_async_commit();
      if (ch + 2 < nch) load_x(xn, x, M, K, m0, (c0 + ch + 2) * KC, tid, upper);
      const unsigned char* ws = smem + (ch % STAGES) * L::W_BYTES;
      const unsigned char* pc = pieces + (ch & 1) * PIECES_BYTES;
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {
        uint32_t a[2][4];
        load_a<WB>(a, ws, kk, warp, lane);
        mma_piece(acc, a, pc, kk, lane, upper);                       // lo
        mma_piece(acc, a, pc + PIECE_BYTES, kk, lane, upper);      // mid
        mma_piece(acc, a, pc + 2 * PIECE_BYTES, kk, lane, upper);  // hi
      }
      if (ch + 1 < nch) split_x(xs, pieces + ((ch + 1) & 1) * PIECES_BYTES, tid, upper);
    };
    for (int ch = 0; ch < nch; ch += 2) {
      chunk(ch, xa, xb);
      if (ch + 1 < nch) chunk(ch + 1, xb, xa);
    }
  };
  if (rows > 16)
    k_loop(std::true_type{});
  else
    k_loop(std::false_type{});
  fa::cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring, which now holds the partial

  // the block's partial, [MT][RED_STRIDE] f32: C fragment (f, j) of lane
  // (g, t) holds x rows 8 j + 2 t, + 1 of its columns
  float* red = reinterpret_cast<float*>(smem);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int j = 0; j < 2 * HALVES; ++j) {
      const int m = 8 * j + 2 * t;
      const int na = 32 * warp + col_of<WB>(f, g, false), nb = 32 * warp + col_of<WB>(f, g, true);
      red[m * RED_STRIDE + na] = acc[f][j][0];
      red[(m + 1) * RED_STRIDE + na] = acc[f][j][1];
      red[m * RED_STRIDE + nb] = acc[f][j][2];
      red[(m + 1) * RED_STRIDE + nb] = acc[f][j][3];
    }
  cluster.sync();  // every split's partial is in its block's shared memory

  // the cluster's blocks share the tile's outputs; each output is the sum
  // of the splits' partials in split order, times its column's scale
  for (int e = split * THREADS + tid; e < rows * NT; e += nsplit * THREADS) {
    const int m = e / NT, n = e % NT;
    const int off = m * RED_STRIDE + n;
    float v = cluster.map_shared_rank(red, 0)[off];
    for (int s = 1; s < nsplit; ++s) v = __fadd_rn(v, cluster.map_shared_rank(red, s)[off]);
    if (n0 + n < N) {
      if (scale != nullptr) v = __fmul_rn(v, scale[n0 + n]);
      out[(size_t)(m0 + m) * N + n0 + n] = v;
    }
  }
  cluster.sync();  // no block leaves while another still reads its partial
}

template <typename W>
cudaError_t launch(const void* x, const void* w, const void* scale, void* out, int M, int N,
                   int K, cudaStream_t stream) {
  constexpr size_t smem = Layout<sizeof(W)>::bytes;
  auto kern = wq_matmul_kernel<W>;
  FA_OPT_IN_SMEM_ONCE(kern, smem);  // above 48 KB a block has to opt in
  const int s = splits(K, N);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(s, (N + NT - 1) / NT, (M + MT - 1) / MT);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = s;  // a cluster is one output tile's splits
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, static_cast<const float*>(x),
                            static_cast<const unsigned char*>(w),
                            static_cast<const float*>(scale), static_cast<float*>(out), M, N,
                            K);
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
  if (M < 1 || N < 1 || K < 1 || K % 4 != 0 || (M + MT - 1) / MT > 65535)
    return (int)cudaErrorInvalidValue;
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

// the split count (blocks of one output tile's cluster) of a K x N product
int quant_matmul_splits(int K, int N) { return splits(K, N); }

const char* quant_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
