// Grouped ragged-cohort base + LoRA matmul for Hopper (sm_90a), fp32 and
// bf16:
//
//     y_i = x_i @ W + s_i * (x_i @ A_i^T) @ B_i^T        for each group i
//
// x (M, K) holds the groups' rows concatenated in group order, contiguous;
// W (K, N) is the shared frozen base, N-contiguous (the forward's W) or
// K-contiguous (the backward's W^T view of a contiguous (N, K) tensor);
// A (G, r, K) and B (G, N, r) are the per-group adapters, each read by a
// group stride and any (row, column) strides, so the backward's transposed
// views B_i^T and A_i^T go in as they are; scales (G,) their scales;
// y (M, N) contiguous, in x's type; r <= 64.  All operands share one type:
// float (grouped_lora_f32) or bf16 (grouped_lora_bf16); the scales are f32.
//
// Replaces src/repro/kernels/grouped_lora.py:grouped_lora_matmul (the
// Pallas TPU kernel), both of its modes: "chunk" (body _kernel_chunk, K
// swept with f32 accumulators carried across the sweep) and "direct" (body
// _kernel_direct, one full-K pass).
//
// The group.  A block reads its group from a tile table built on the host,
// one (group, first row, rows) entry per tile, in which every group is
// tiled on its own.  So no tile straddles two groups, a group's last tile
// is simply short (its rows past the end are masked), and nothing is
// padded or copied; the Pallas wrapper padded every group to the block
// size and kept a tile -> group-id table instead.  The block reads g and
// s_g first and takes A_g and B_g by the group stride.
//
// Chunk mode (every launch on the cohort path) is lora_matmul's body,
// shared through tf32_lora_tile.cuh (fp32) and, in bf16, through
// bf16_wgmma_tile.cuh (wgmma fed by TMA, entry grouped_lora_bf16_tma: A_g by
// a 3-D tensor map or by pointer, B_g by pointer) where TMA can describe the
// operands and bf16_lora_tile.cuh (mma.sync.m16n8k16 on 128 x 128 tiles)
// elsewhere; both keep x @ A_g^T in f32.  In fp32: 3xTF32 mma.sync.m16n8k8 (about 22-bit
// operands; each k8 slice's products added to the f32 accumulator with
// round-to-nearest), one block of 256 threads per 128 x 96 tile of y, and
// a 4-stage cp.async ring of 32-deep K steps carrying x, W and A_g, A_g's
// rank rows riding as extra B-operand columns of each W stage; the
// epilogue adds s_g * (x @ A_g^T) @ B_g^T from shared memory.  Tiles are
// 128 rows high: at the cohort shape (two groups of 2048 rows, K = N = 768,
// r 16) that is 32 x 8 = 256 blocks, about two full waves on 132 SMs.
//
// Direct mode keeps a SIMT body: 64 x 64 tiles of 256 threads with 4 x 4
// FMA micro-tiles, staging the whole K slab of x, A_g and the W columns in
// shared memory at once (as f32, widened from bf16 on the way in, so both
// types take the same K), synchronising once, and running the full K loop
// from there.  It reads W, A and B by the same strides as chunk
// mode.  It needs (64+1 + RP+1 + 64) * K floats of shared memory, so
// grouped_lora_direct_max_k(r) is the largest K it takes (398 at r <= 16);
// the wrapper raises above it.  The tensor-core tile's whole-K slab would
// hold K <= 192 at r 16, below shapes the direct mode takes today.  No path
// launches direct mode (mode "auto" takes it only for K <= 128).
//
// What bounds it.  At the cohort shape one chunk launch does
// 2MKN + 2MKr + 2MNr = 5.03 GFLOP and must move about 28 MB: 75.1 us at
// the fp32 CUDA-core peak of 67 TFLOP/s (the bound chip_smoke.py reports),
// 30.5 us as 3 x 5.03 GFLOP of TF32 at 495 TFLOP/s, and 8 us of traffic at
// 3.35 TB/s.  Each N-tile recomputes its rows' x @ A_g^T, RP / 96 = 17 %
// more products at r 16.  In bf16 the products run at the bf16 tensor-core
// peak (989 TFLOP/s): at gemma-2b's q-projection over two groups of 4096
// rows (K = N 2048, r 16), 69 GFLOP in 70 us against 76 MB in 23 us.
// Measured times are in PERF.md.

#include "bf16_lora_tile.cuh"
#include "bf16_wgmma_tile.cuh"
#include "tf32_lora_tile.cuh"

namespace {

constexpr int MAX_TILES = 65535;   // grid.y

// ---------------------------------------------------------------- chunk mode

// RP: the rank rounded up to 16, 32 or 64.  WK: W is K-contiguous.
template <int RP, bool WK>
__global__ void __launch_bounds__(tc::THREADS, 1)
grouped_lora_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ a, const float* __restrict__ b,
                    const float* __restrict__ scales, const int* __restrict__ tiles,
                    float* __restrict__ y, int N, int K, int r, long long sw,
                    long long sag, long long saj, long long sak, long long sbg,
                    long long sbn, long long sbj, int vec) {
  extern __shared__ __align__(16) float sm[];
  const int* tile = tiles + 3 * blockIdx.y;
  const int g = tile[0], m0 = tile[1], rows = tile[2];
  tc::lora_tile<RP, WK>(sm, x, w, a + g * sag, b + g * sbg, y, m0, rows,
                        blockIdx.x * tc::BN, N, K, r, scales[g], K, sw, saj, sak, sbn,
                        sbj, vec != 0);
}

template <int RP, bool WK>
int launch_chunk(const float* x, const float* w, const float* a, const float* b,
                 const float* scales, const int* tiles, float* y, int n_tiles, int N, int K,
                 int r, long long sw, long long sag, long long saj, long long sak,
                 long long sbg, long long sbn, long long sbj, cudaStream_t s) {
  using L = tc::Smem<RP, WK>;
  auto kern = grouped_lora_kernel<RP, WK>;
  // the shared-memory opt-in acts on the current device only: made on
  // every launch, as in lora_matmul.cu
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::BYTES);
  if (err != cudaSuccess) return (int)err;
  const int vec = tc::vec_copies(x, w, K, sw, N, K);
  const dim3 grid((N + tc::BN - 1) / tc::BN, n_tiles);
  kern<<<grid, tc::THREADS, L::BYTES, s>>>(x, w, a, b, scales, tiles, y, N, K, r, sw, sag,
                                           saj, sak, sbg, sbn, sbj, vec);
  return (int)cudaGetLastError();
}

// the same on the bf16 tile
template <int RP, bool WK>
__global__ void __launch_bounds__(bc::THREADS, bc::min_blocks<RP>())
grouped_lora_bf16_kernel(const bc::half_t* __restrict__ x, const bc::half_t* __restrict__ w,
                         const bc::half_t* __restrict__ a, const bc::half_t* __restrict__ b,
                         const float* __restrict__ scales, const int* __restrict__ tiles,
                         bc::half_t* __restrict__ y, int N, int K, int r, long long sw,
                         long long sag, long long saj, long long sak, long long sbg,
                         long long sbn, long long sbj, int vec) {
  extern __shared__ __align__(16) unsigned char smb[];
  const int* tile = tiles + 3 * blockIdx.y;
  const int g = tile[0], m0 = tile[1], rows = tile[2];
  bc::lora_tile<RP, WK>(smb, x, w, a + g * sag, b + g * sbg, y, m0, rows,
                        blockIdx.x * bc::BN, N, K, r, scales[g], K, sw, saj, sak, sbn,
                        sbj, vec != 0);
}

template <int RP, bool WK>
int launch_chunk_bf16(const bc::half_t* x, const bc::half_t* w, const bc::half_t* a,
                      const bc::half_t* b, const float* scales, const int* tiles,
                      bc::half_t* y, int n_tiles, int N, int K, int r, long long sw,
                      long long sag, long long saj, long long sak, long long sbg,
                      long long sbn, long long sbj, cudaStream_t s) {
  using L = bc::Smem<RP, WK>;
  auto kern = grouped_lora_bf16_kernel<RP, WK>;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::BYTES);
  if (err != cudaSuccess) return (int)err;
  const int vec = bc::vec_copies(x, w, K, sw, N, K);
  const dim3 grid((N + bc::BN - 1) / bc::BN, n_tiles);
  kern<<<grid, bc::THREADS, L::BYTES, s>>>(x, w, a, b, scales, tiles, y, N, K, r, sw, sag,
                                           saj, sak, sbg, sbn, sbj, vec);
  return (int)cudaGetLastError();
}

// the same on the wgmma tile (bf16_wgmma_tile.cuh): the block's group, rows
// and scale from the tile table; A_g by the group's TMA coordinate (mode 0)
// or pointer (mode 1), B_g by pointer
template <int BN, int RP, bool WK>
__global__ void __launch_bounds__(wg::THREADS, 1)
grouped_lora_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                          const __grid_constant__ CUtensorMap tw,
                          const __grid_constant__ CUtensorMap ta, wg::Tile t,
                          const float* __restrict__ scales, const int* __restrict__ tiles,
                          long long sag, long long sbg) {
  extern __shared__ __align__(1024) unsigned char smw[];
  __shared__ __align__(8) uint64_t bars[2 * wg::STAGES];
  const int* tile = tiles + 3 * blockIdx.y;
  t.group = tile[0];
  t.m0 = tile[1];
  t.rows = tile[2];
  t.n0 = blockIdx.x * BN;
  t.scale = scales[t.group];
  t.a += t.group * sag;
  t.b += t.group * sbg;
  wg::lora_tile<BN, RP, WK>(smw, bars, &tx, &tw, &ta, t);
}

struct WgmmaCall {
  wg::Maps maps;
  wg::Tile t;
  const float* scales;
  const int* tiles;
  int n_tiles;
  long long sag, sbg;
};

template <int BN, int RP, bool WK>
int launch_wgmma(const WgmmaCall& c, cudaStream_t s) {
  using C = wg::Cfg<BN, RP>;
  auto kern = grouped_lora_wgmma_kernel<BN, RP, WK>;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((c.t.N + BN - 1) / BN, c.n_tiles);
  kern<<<grid, wg::THREADS, C::SMEM, s>>>(c.maps.tx, c.maps.tw, c.maps.ta, c.t, c.scales,
                                          c.tiles, c.sag, c.sbg);
  return (int)cudaGetLastError();
}

template <int BN, bool WK>
int wgmma_rank(const WgmmaCall& c, cudaStream_t s) {
  if (c.t.r <= 16) return launch_wgmma<BN, 16, WK>(c, s);
  if (c.t.r <= 32) return launch_wgmma<BN, 32, WK>(c, s);
  return launch_wgmma<BN, 64, WK>(c, s);
}

template <bool WK>
int wgmma_width(int bn, const WgmmaCall& c, cudaStream_t s) {
  if (bn == 256) return wgmma_rank<256, WK>(c, s);
  if (bn == 128) return wgmma_rank<128, WK>(c, s);
  return wgmma_rank<64, WK>(c, s);
}

// --------------------------------------------------------------- direct mode

namespace simt {

constexpr int BM = 64;          // rows of y per block (one tile)
constexpr int BN = 64;          // columns of y per block
constexpr int TM = 4;           // micro-tile rows per thread
constexpr int TN = 4;           // micro-tile columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);   // 256
constexpr int MAX_SMEM = 232448;   // bytes of shared memory a block may use

// floats of shared memory the whole-K stage needs: the staged x^T, A_g^T
// and W slabs, or the epilogue's x @ A_g^T and B_g tiles, which reuse the
// same space once the K loop is done
template <int RP>
constexpr size_t smem_floats(int k) {
  const size_t stage = (size_t)k * ((BM + 1) + (RP + 1) + BN);
  const size_t epilogue = (size_t)BM * (RP + 1) + (size_t)RP * (BN + 1);
  return stage > epilogue ? stage : epilogue;
}

template <int RP>
constexpr int direct_max_k() {
  return (MAX_SMEM / 4) / ((BM + 1) + (RP + 1) + BN);
}

// an element as f32, and back: bf16 widens exactly and rounds to nearest
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bc::half_t v) { return bc::widen(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bc::half_t from_f32<bc::half_t>(float v) {
  return bc::narrow(v);
}

}  // namespace simt

// T: float or bf16 (bc::half_t).  W element (k, n) at k * swk + n * swn;
// A_g element (j, k) at j * saj + k * sak; B_g element (n, j) at
// n * sbn + j * sbj.
template <typename T, int RP>
__global__ void __launch_bounds__(simt::THREADS)
grouped_lora_kernel_direct(const T* __restrict__ x, const T* __restrict__ w,
                           const T* __restrict__ a, const T* __restrict__ b,
                           const float* __restrict__ scales,
                           const int* __restrict__ tiles, T* __restrict__ y, int N,
                           int K, int r, long long swk, long long swn, long long sag,
                           long long saj, long long sak, long long sbg, long long sbn,
                           long long sbj) {
  using namespace simt;
  constexpr int XA = BM * RP / THREADS;   // down-projection entries per thread
  constexpr int XS = BM + 1;              // row strides of the staged tiles
  constexpr int AS = RP + 1;
  extern __shared__ float smem[];

  const int* tile = tiles + 3 * blockIdx.y;
  const int g = tile[0], m0 = tile[1], rows = tile[2];
  const T* __restrict__ ag = a + g * sag;
  const T* __restrict__ bg = b + g * sbg;
  const float scale = scales[g];

  float* xs = smem;                          // [K][XS]: x^T
  float* as_ = xs + (size_t)K * XS;          // [K][AS]: A_g^T
  float* ws = as_ + (size_t)K * AS;          // [K][BN]: W

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int n0 = blockIdx.x * BN;
  const int nxa = BM * r;            // live (row, j) pairs of x @ A_g^T

  int xa_row[XA], xa_col[XA];
#pragma unroll
  for (int q = 0; q < XA; ++q) {
    const int e = tid + q * THREADS;
    xa_row[q] = r > 0 ? e / r : 0;
    xa_col[q] = r > 0 ? e % r : 0;
  }

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  float xa[XA];
#pragma unroll
  for (int q = 0; q < XA; ++q) xa[q] = 0.f;

  for (int e = tid; e < BM * K; e += THREADS) {
    const int mm = e / K, kk = e % K;
    xs[kk * XS + mm] = (mm < rows) ? to_f32(x[(size_t)(m0 + mm) * K + kk]) : 0.f;
  }
  for (int e = tid; e < K * BN; e += THREADS) {
    const int kk = e / BN, nn = e % BN;
    const int gn = n0 + nn;
    ws[kk * BN + nn] = (gn < N) ? to_f32(w[kk * swk + gn * swn]) : 0.f;
  }
  for (int e = tid; e < r * K; e += THREADS) {
    const int j = e / K, kk = e % K;
    as_[kk * AS + j] = to_f32(ag[j * saj + kk * sak]);
  }
  __syncthreads();

#pragma unroll 4
  for (int kk = 0; kk < K; ++kk) {
    const float* xk = xs + kk * XS;
    const float* wk = ws + kk * BN;
    const float* ak = as_ + kk * AS;
    float xr[TM], wr[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) xr[i] = xk[ty * TM + i];
#pragma unroll
    for (int j = 0; j < TN; ++j) wr[j] = wk[tx * TN + j];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(xr[i], wr[j], acc[i][j]);
#pragma unroll
    for (int q = 0; q < XA; ++q) {
      if (tid + q * THREADS < nxa) xa[q] = fmaf(xk[xa_row[q]], ak[xa_col[q]], xa[q]);
    }
  }
  __syncthreads();

  // epilogue: y = acc + s_g * (x @ A_g^T) @ B_g^T over the tile; the
  // staged slabs are dead, so their space holds x @ A_g^T and B_g^T
  float* xas = smem;                 // [BM][AS]
  float* bs = smem + BM * AS;        // [RP][BN + 1]
#pragma unroll
  for (int q = 0; q < XA; ++q) {
    if (tid + q * THREADS < nxa) xas[xa_row[q] * AS + xa_col[q]] = xa[q];
  }
  for (int e = tid; e < BN * r; e += THREADS) {
    const int nn = e / r, j = e % r;
    const int gn = n0 + nn;
    bs[j * (BN + 1) + nn] = (gn < N) ? to_f32(bg[gn * sbn + j * sbj]) : 0.f;
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = ty * TM + i;
#pragma unroll
    for (int jn = 0; jn < TN; ++jn) {
      const int col = tx * TN + jn;
      const int gn = n0 + col;
      float up = 0.f;
      for (int j = 0; j < r; ++j) up = fmaf(xas[row * AS + j], bs[j * (BN + 1) + col], up);
      if (row < rows && gn < N)
        y[(size_t)(m0 + row) * N + gn] = from_f32<T>(acc[i][jn] + scale * up);
    }
  }
}

template <typename T, int RP>
int launch_direct(const T* x, const T* w, const T* a, const T* b,
                  const float* scales, const int* tiles, T* y, int n_tiles, int N, int K,
                  int r, long long swk, long long swn, long long sag, long long saj,
                  long long sak, long long sbg, long long sbn, long long sbj,
                  cudaStream_t s) {
  if (K > simt::direct_max_k<RP>()) return (int)cudaErrorInvalidValue;
  const size_t bytes = simt::smem_floats<RP>(K) * sizeof(float);
  auto kern = grouped_lora_kernel_direct<T, RP>;
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + simt::BN - 1) / simt::BN, n_tiles);
  kern<<<grid, simt::THREADS, bytes, s>>>(x, w, a, b, scales, tiles, y, N, K, r, swk, swn,
                                          sag, saj, sak, sbg, sbn, sbj);
  return (int)cudaGetLastError();
}

template <int RP>
int launch(const float* x, const float* w, const float* a, const float* b,
           const float* scales, const int* tiles, float* y, int n_tiles, int N, int K, int r,
           bool direct, long long sw, bool w_kmajor, long long sag, long long saj,
           long long sak, long long sbg, long long sbn, long long sbj, cudaStream_t s) {
  if (direct)
    return launch_direct<float, RP>(x, w, a, b, scales, tiles, y, n_tiles, N, K, r,
                                    w_kmajor ? 1 : sw, w_kmajor ? sw : 1, sag, saj, sak, sbg,
                                    sbn, sbj, s);
  if (w_kmajor)
    return launch_chunk<RP, true>(x, w, a, b, scales, tiles, y, n_tiles, N, K, r, sw, sag,
                                  saj, sak, sbg, sbn, sbj, s);
  return launch_chunk<RP, false>(x, w, a, b, scales, tiles, y, n_tiles, N, K, r, sw, sag,
                                 saj, sak, sbg, sbn, sbj, s);
}

template <int RP>
int launch(const bc::half_t* x, const bc::half_t* w, const bc::half_t* a,
           const bc::half_t* b, const float* scales, const int* tiles, bc::half_t* y,
           int n_tiles, int N, int K, int r, bool direct, long long sw, bool w_kmajor,
           long long sag, long long saj, long long sak, long long sbg, long long sbn,
           long long sbj, cudaStream_t s) {
  if (direct)
    return launch_direct<bc::half_t, RP>(x, w, a, b, scales, tiles, y, n_tiles, N, K, r,
                                         w_kmajor ? 1 : sw, w_kmajor ? sw : 1, sag, saj, sak,
                                         sbg, sbn, sbj, s);
  if (w_kmajor)
    return launch_chunk_bf16<RP, true>(x, w, a, b, scales, tiles, y, n_tiles, N, K, r, sw,
                                       sag, saj, sak, sbg, sbn, sbj, s);
  return launch_chunk_bf16<RP, false>(x, w, a, b, scales, tiles, y, n_tiles, N, K, r, sw,
                                      sag, saj, sak, sbg, sbn, sbj, s);
}

// either type, by the rank rounded up to 16, 32 or 64
template <typename T>
int launch_rank(const T* x, const T* w, const T* a, const T* b, const float* scales,
                const int* tiles, T* y, int n_tiles, int N, int K, int r, int direct,
                long long sw, int w_kmajor, long long sag, long long saj, long long sak,
                long long sbg, long long sbn, long long sbj, void* stream) {
  if (n_tiles <= 0 || n_tiles > MAX_TILES || N <= 0 || K < 0 || r < 0 ||
      r > tc::MAX_RANK)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool d = direct != 0, wk = w_kmajor != 0;
  if (r <= 16)
    return launch<16>(x, w, a, b, scales, tiles, y, n_tiles, N, K, r, d, sw, wk, sag, saj,
                      sak, sbg, sbn, sbj, s);
  if (r <= 32)
    return launch<32>(x, w, a, b, scales, tiles, y, n_tiles, N, K, r, d, sw, wk, sag, saj,
                      sak, sbg, sbn, sbj, s);
  return launch<64>(x, w, a, b, scales, tiles, y, n_tiles, N, K, r, d, sw, wk, sag, saj,
                    sak, sbg, sbn, sbj, s);
}

}  // namespace

extern "C" {

int grouped_lora_max_rank() { return tc::MAX_RANK; }

// the largest K the direct mode takes at rank r (0 for a rank it never takes)
int grouped_lora_direct_max_k(int r) {
  if (r < 0 || r > tc::MAX_RANK) return 0;
  if (r <= 16) return simt::direct_max_k<16>();
  if (r <= 32) return simt::direct_max_k<32>();
  return simt::direct_max_k<64>();
}

// tiles: (n_tiles, 3) int32 rows of (group, first row, rows), rows <= 128
// in chunk mode and <= 64 in direct mode, every row of y in exactly one
// tile.  x (M, K) contiguous; W (K, N): w_kmajor 0 -> element (k, n) at
// k * sw + n, 1 -> at n * sw + k; A element (g, j, k) at
// g * sag + j * saj + k * sak; B element (g, n, j) at
// g * sbg + n * sbn + j * sbj; y (M, N) contiguous.  Launches on ``stream``
// and returns cudaGetLastError() (0 on success).
int grouped_lora_f32(const float* x, const float* w, const float* a, const float* b,
                     const float* scales, const int* tiles, float* y, int n_tiles, int N,
                     int K, int r, int direct, long long sw, int w_kmajor, long long sag,
                     long long saj, long long sak, long long sbg, long long sbn,
                     long long sbj, void* stream) {
  return launch_rank(x, w, a, b, scales, tiles, y, n_tiles, N, K, r, direct, sw, w_kmajor,
                     sag, saj, sak, sbg, sbn, sbj, stream);
}

// the same in bf16 (raw 16-bit words; scales f32), y in bf16
int grouped_lora_bf16(const void* x, const void* w, const void* a, const void* b,
                      const float* scales, const int* tiles, void* y, int n_tiles, int N,
                      int K, int r, int direct, long long sw, int w_kmajor, long long sag,
                      long long saj, long long sak, long long sbg, long long sbn,
                      long long sbj, void* stream) {
  typedef const bc::half_t* P;
  return launch_rank(P(x), P(w), P(a), P(b), scales, tiles, static_cast<bc::half_t*>(y),
                     n_tiles, N, K, r, direct, sw, w_kmajor, sag, saj, sak, sbg, sbn, sbj,
                     stream);
}

// chunk mode in bf16 on the wgmma tile (bf16_wgmma_tile.cuh), for operands
// TMA can describe (wg::wgmma_ok; the wrapper's tma_ok): the arguments of
// grouped_lora_bf16 less ``direct``, with M (x's rows) and G (the groups A
// and B hold).  Returns cudaErrorInvalidValue for other operands, and when a
// tensor map does not encode
int grouped_lora_bf16_tma(const void* x, const void* w, const void* a, const void* b,
                          const float* scales, const int* tiles, void* y, int n_tiles, int M,
                          int N, int K, int r, int G, long long sw, int w_kmajor,
                          long long sag, long long saj, long long sak, long long sbg,
                          long long sbn, long long sbj, void* stream) {
  if (n_tiles <= 0 || n_tiles > MAX_TILES || M <= 0 || N <= 0 || G <= 0 ||
      r > wg::MAX_RANK || !wg::wgmma_ok(x, w, a, K, r, K, sw, saj, sak, sag))
    return (int)cudaErrorInvalidValue;
  const bool a_tma = wg::a_mode(a, r, saj, sak, sag) == 0;
  const int bn = wg::tile_width(N, n_tiles);
  WgmmaCall c;
  if (!wg::encode_maps(&c.maps, x, w, a, M, N, K, r, G, K, sw, w_kmajor != 0, saj, sag, bn,
                       wg::rank_tile(r), a_tma))
    return (int)cudaErrorInvalidValue;
  typedef const wg::half_t* P;
  c.t = {0, 0, 0, N, K, r, 0, 0.f, P(a), saj, sak, P(b), sbn, sbj,
         static_cast<wg::half_t*>(y), a_tma};
  c.scales = scales;
  c.tiles = tiles;
  c.n_tiles = n_tiles;
  c.sag = sag;
  c.sbg = sbg;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return w_kmajor ? wgmma_width<true>(bn, c, s) : wgmma_width<false>(bn, c, s);
}

}  // extern "C"
