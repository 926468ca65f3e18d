// Grouped ragged-cohort base + LoRA matmul for Hopper (sm_90a), fp32:
//
//     y_i = x_i @ W + s_i * (x_i @ A_i^T) @ B_i^T        for each group i
//
// x (M, K) holds the groups' rows concatenated in group order, W (K, N) is
// the shared frozen base, A (G, r, K) and B (G, N, r) are the per-group
// adapters, scales (G,) their scales, y (M, N); all row-major and
// contiguous, r <= 64.
//
// Replaces src/repro/kernels/grouped_lora.py:grouped_lora_matmul (the
// Pallas TPU kernel), both of its modes: "chunk" (body _kernel_chunk, K
// swept with f32 accumulators carried across the sweep) and "direct" (body
// _kernel_direct, one full-K pass).
//
// Design.  The structure is lora_matmul.cu's: one thread block owns a
// 64 x 64 tile of y and has 256 threads, each with a 4 x 4 micro-tile of
// x @ W in registers; the block's (64, r) slice of x @ A_g^T is spread over
// all 256 threads, and the up-projection is applied from shared memory in
// the epilogue.  What is new is the group: the block reads it from a tile
// table built on the host, one (group, first row, rows) entry per 64-row
// tile, in which every group is tiled on its own.  So no tile straddles
// two groups, a group's last tile is simply short (its rows past the end
// are masked), and nothing is padded or copied; the Pallas wrapper padded
// every group to the block size and kept a tile -> group-id table instead.
// The block takes A_g and B_g by offset and s_g from the (G,) scales.
//
// The two modes differ only in how much of K one stage holds in shared
// memory: "chunk" stages 16 columns of K at a time (x, W and A_g tiles) and
// synchronises between stages; "direct" stages the whole K slab of x, A_g
// and the W columns at once, synchronises once, and runs the full K loop
// from shared memory.  Direct needs (64+1 + RP+1 + 64) * K floats of
// shared memory, so grouped_lora_direct_max_k(r) is the largest K it takes
// (398 at r <= 16); the wrapper raises above it.
//
// What bounds it.  At the ragged server step's shape (two groups of
// 16 * 128 = 2048 rows, K = N = 768, r = 16) one launch does
// 2MKN + 2MKr + 2MNr = 5.03 GFLOP and must move about 28 MB: against the
// H100 data sheet's 67 TFLOP/s of fp32 and 3.35 TB/s it is bound by the
// arithmetic, at 75 us, not by the traffic (8 us).  As in lora_matmul, each
// N-tile recomputes its rows' x @ A_g^T (+25 % fp32 work at r = 16), and
// the tensor cores, TMA and double buffering are left for later work.
// Measured times are in PERF.md.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BM = 64;          // rows of y per block (one tile)
constexpr int BN = 64;          // columns of y per block
constexpr int BK = 16;          // depth of one K stage in chunk mode
constexpr int TM = 4;           // micro-tile rows per thread
constexpr int TN = 4;           // micro-tile columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);   // 256
constexpr int MAX_RANK = 64;
constexpr int MAX_SMEM = 232448;   // bytes of shared memory a block may use
constexpr int MAX_TILES = 65535;   // grid.y

// floats of shared memory one stage of depth `depth` needs: the staged
// x^T, A_g^T and W tiles, or the epilogue's x @ A_g^T and B_g tiles, which
// reuse the same space once the K loop is done
template <int RP>
__host__ __device__ constexpr size_t smem_floats(int depth) {
  const size_t stage = (size_t)depth * ((BM + 1) + (RP + 1) + BN);
  const size_t epilogue = (size_t)BM * (RP + 1) + (size_t)RP * (BN + 1);
  return stage > epilogue ? stage : epilogue;
}

template <int RP>
constexpr int direct_max_k() {
  return (MAX_SMEM / 4) / ((BM + 1) + (RP + 1) + BN);
}

// RP: the rank rounded up to 16, 32 or 64.  DEPTH: the K columns one stage
// holds, BK for chunk mode, 0 for direct mode (the whole of K).
template <int RP, int DEPTH>
__global__ void __launch_bounds__(THREADS)
grouped_lora_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ a, const float* __restrict__ b,
                    const float* __restrict__ scales,
                    const int* __restrict__ tiles, float* __restrict__ y,
                    int N, int K, int r) {
  constexpr int XA = BM * RP / THREADS;   // down-projection entries per thread
  constexpr int XS = BM + 1;              // row strides of the staged tiles
  constexpr int AS = RP + 1;
  extern __shared__ float smem[];

  const int* tile = tiles + 3 * blockIdx.y;
  const int g = tile[0], m0 = tile[1], rows = tile[2];
  const float* __restrict__ ag = a + (size_t)g * r * K;
  const float* __restrict__ bg = b + (size_t)g * N * r;
  const float scale = scales[g];

  const int depth = DEPTH > 0 ? DEPTH : K;
  float* xs = smem;                              // [depth][XS]: x^T
  float* as_ = xs + (size_t)depth * XS;          // [depth][AS]: A_g^T
  float* ws = as_ + (size_t)depth * AS;          // [depth][BN]: W

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

  for (int k0 = 0; k0 < K; k0 += depth) {
    for (int e = tid; e < BM * depth; e += THREADS) {
      const int mm = e / depth, kk = e % depth;
      const int gk = k0 + kk;
      xs[kk * XS + mm] = (mm < rows && gk < K) ? x[(size_t)(m0 + mm) * K + gk] : 0.f;
    }
    for (int e = tid; e < depth * BN; e += THREADS) {
      const int kk = e / BN, nn = e % BN;
      const int gk = k0 + kk, gn = n0 + nn;
      ws[kk * BN + nn] = (gk < K && gn < N) ? w[(size_t)gk * N + gn] : 0.f;
    }
    for (int e = tid; e < r * depth; e += THREADS) {
      const int j = e / depth, kk = e % depth;
      const int gk = k0 + kk;
      as_[kk * AS + j] = (gk < K) ? ag[(size_t)j * K + gk] : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < depth; ++kk) {
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
        if (tid + q * THREADS < nxa)
          xa[q] = fmaf(xk[xa_row[q]], ak[xa_col[q]], xa[q]);
      }
    }
    __syncthreads();
  }

  // epilogue: y = acc + s_g * (x @ A_g^T) @ B_g^T over the tile; the
  // staged tiles are dead, so their space holds x @ A_g^T and B_g^T
  float* xas = smem;                 // [BM][AS]
  float* bs = smem + BM * AS;        // [RP][BN + 1]
#pragma unroll
  for (int q = 0; q < XA; ++q) {
    if (tid + q * THREADS < nxa) xas[xa_row[q] * AS + xa_col[q]] = xa[q];
  }
  for (int e = tid; e < BN * r; e += THREADS) {
    const int nn = e / r, j = e % r;
    const int gn = n0 + nn;
    bs[j * (BN + 1) + nn] = (gn < N) ? bg[(size_t)gn * r + j] : 0.f;
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
      if (row < rows && gn < N) y[(size_t)(m0 + row) * N + gn] = acc[i][jn] + scale * up;
    }
  }
}

template <int RP>
int launch(const float* x, const float* w, const float* a, const float* b,
           const float* scales, const int* tiles, float* y, int n_tiles,
           int N, int K, int r, bool direct, cudaStream_t s) {
  const dim3 grid((N + BN - 1) / BN, n_tiles);
  const dim3 block(THREADS);
  if (!direct) {
    const size_t bytes = smem_floats<RP>(BK) * sizeof(float);
    grouped_lora_kernel<RP, BK><<<grid, block, bytes, s>>>(
        x, w, a, b, scales, tiles, y, N, K, r);
    return (int)cudaGetLastError();
  }
  if (K > direct_max_k<RP>()) return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_floats<RP>(K) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      grouped_lora_kernel<RP, 0>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return (int)e;
  grouped_lora_kernel<RP, 0><<<grid, block, bytes, s>>>(
      x, w, a, b, scales, tiles, y, N, K, r);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int grouped_lora_max_rank() { return MAX_RANK; }

// the largest K the direct mode takes at rank r (0 for a rank it never takes)
int grouped_lora_direct_max_k(int r) {
  if (r < 0 || r > MAX_RANK) return 0;
  if (r <= 16) return direct_max_k<16>();
  if (r <= 32) return direct_max_k<32>();
  return direct_max_k<64>();
}

// tiles: (n_tiles, 3) int32 rows of (group, first row, rows <= 64), every
// row of y in exactly one tile.  Launches on ``stream`` and returns
// cudaGetLastError() (0 on success).
int grouped_lora_f32(const float* x, const float* w, const float* a,
                     const float* b, const float* scales, const int* tiles,
                     float* y, int n_tiles, int N, int K, int r, int direct,
                     void* stream) {
  if (n_tiles <= 0 || n_tiles > MAX_TILES || N <= 0 || K < 0 || r < 0 ||
      r > MAX_RANK)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (r <= 16)
    return launch<16>(x, w, a, b, scales, tiles, y, n_tiles, N, K, r, direct, s);
  if (r <= 32)
    return launch<32>(x, w, a, b, scales, tiles, y, n_tiles, N, K, r, direct, s);
  return launch<64>(x, w, a, b, scales, tiles, y, n_tiles, N, K, r, direct, s);
}

}  // extern "C"
