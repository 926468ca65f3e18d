// Fused base + LoRA matmul for Hopper (sm_90a), fp32:
//
//     y = x @ W + scale * (x @ A^T) @ B^T
//
// x (M, K), W (K, N), A (r, K), B (N, r), y (M, N); all row-major and
// contiguous, r <= 64.
//
// Replaces src/repro/kernels/lora_matmul.py:lora_matmul (the Pallas TPU
// kernel, body _kernel).  Like it, the rank-r down-projection x @ A^T rides
// the same K sweep as the base product, so x is read once for both, and the
// (M, r) intermediate never goes to device memory: the up-projection is
// applied in the epilogue from shared memory.
//
// Design.  One thread block owns a 64 x 64 tile of y and has 256 threads.
// It walks K in steps of 16: the x, W and A tiles go to shared memory, each
// thread accumulates a 4 x 4 micro-tile of x @ W in registers, and the
// block's (64, r) slice of x @ A^T is spread over all 256 threads (a few
// register accumulators each), so no warp carries the rank-r work alone.
// In the epilogue the x @ A^T slice and the tile's rows of B go to shared
// memory, and each thread adds scale * (xa @ B^T) to its micro-tile.  Ragged
// M, N and K edges are masked in the loads and stores, so the caller pads
// nothing (the Pallas wrapper padded to block multiples).
//
// What bounds it.  At the main path's shape (M = 16 * 128 = 2048 tokens,
// K = N = 768, r = 16) one launch does 2MKN + 2MKr + 2MNr = 2.52 GFLOP and
// must move about 15 MB (x, W, A, B read once, y written once).  Against
// the H100 data sheet's peaks (67 TFLOP/s of fp32 on the CUDA cores,
// 3.35 TB/s of HBM) the arithmetic bounds it at 38 us and the traffic at
// 4.5 us: compute-bound.  Measured times are in PERF.md.
// Each N-tile recomputes its rows' x @ A^T, which adds r / 64 = 25% to the
// fp32 work at r = 16.
//
// What this simple design leaves on the table: the tensor cores (TF32 or
// bf16 through wgmma, which would change the numerics the fp32 reference
// pins), TMA loads into a multi-stage shared-memory ring, and double
// buffering; the K loop here loads and computes in turn.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BM = 64;          // rows of y per block
constexpr int BN = 64;          // columns of y per block
constexpr int BK = 16;          // depth of one K step
constexpr int TM = 4;           // micro-tile rows per thread
constexpr int TN = 4;           // micro-tile columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);   // 256
constexpr int MAX_RANK = 64;

// RP: the rank rounded up to 16, 32 or 64; it sizes the shared tiles and
// the per-thread down-projection accumulators.
template <int RP>
__global__ void __launch_bounds__(THREADS)
lora_matmul_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ a, const float* __restrict__ b,
                   float* __restrict__ y, int M, int N, int K, int r,
                   float scale) {
  constexpr int XA = BM * RP / THREADS;   // down-projection entries per thread

  __shared__ float xs[BK][BM + 1];   // x tile, transposed: xs[k][m]
  __shared__ float ws[BK][BN];       // W tile: ws[k][n]
  __shared__ float as_[BK][RP + 1];   // A tile, transposed: as_[k][j]
  __shared__ float xas[BM][RP + 1];  // the block's rows of x @ A^T
  __shared__ float bs[RP][BN + 1];   // B tile, transposed: bs[j][n]

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int nxa = BM * r;            // live (row, j) pairs of x @ A^T

  // which (row, j) of x @ A^T each of this thread's accumulators holds
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

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int mm = e / BK, kk = e % BK;
      const int gm = m0 + mm, gk = k0 + kk;
      xs[kk][mm] = (gm < M && gk < K) ? x[(size_t)gm * K + gk] : 0.f;
    }
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int kk = e / BN, nn = e % BN;
      const int gk = k0 + kk, gn = n0 + nn;
      ws[kk][nn] = (gk < K && gn < N) ? w[(size_t)gk * N + gn] : 0.f;
    }
    for (int e = tid; e < r * BK; e += THREADS) {
      const int j = e / BK, kk = e % BK;
      const int gk = k0 + kk;
      as_[kk][j] = (gk < K) ? a[(size_t)j * K + gk] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float xr[TM], wr[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) xr[i] = xs[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) wr[j] = ws[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(xr[i], wr[j], acc[i][j]);
#pragma unroll
      for (int q = 0; q < XA; ++q) {
        if (tid + q * THREADS < nxa)
          xa[q] = fmaf(xs[kk][xa_row[q]], as_[kk][xa_col[q]], xa[q]);
      }
    }
    __syncthreads();
  }

  // epilogue: y = acc + scale * (x @ A^T) @ B^T over the tile
#pragma unroll
  for (int q = 0; q < XA; ++q) {
    if (tid + q * THREADS < nxa) xas[xa_row[q]][xa_col[q]] = xa[q];
  }
  for (int e = tid; e < BN * r; e += THREADS) {
    const int nn = e / r, j = e % r;
    const int gn = n0 + nn;
    bs[j][nn] = (gn < N) ? b[(size_t)gn * r + j] : 0.f;
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = ty * TM + i;
    const int gm = m0 + row;
#pragma unroll
    for (int jn = 0; jn < TN; ++jn) {
      const int col = tx * TN + jn;
      const int gn = n0 + col;
      float up = 0.f;
      for (int j = 0; j < r; ++j) up = fmaf(xas[row][j], bs[j][col], up);
      if (gm < M && gn < N) y[(size_t)gm * N + gn] = acc[i][jn] + scale * up;
    }
  }
}

}  // namespace

extern "C" {

int lora_matmul_max_rank() { return MAX_RANK; }

// Launches on ``stream`` and returns cudaGetLastError() (0 on success).
int lora_matmul_f32(const float* x, const float* w, const float* a,
                    const float* b, float* y, int M, int N, int K, int r,
                    float scale, void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || r < 0 || r > MAX_RANK)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const dim3 block(THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (r <= 16)
    lora_matmul_kernel<16><<<grid, block, 0, s>>>(x, w, a, b, y, M, N, K, r, scale);
  else if (r <= 32)
    lora_matmul_kernel<32><<<grid, block, 0, s>>>(x, w, a, b, y, M, N, K, r, scale);
  else
    lora_matmul_kernel<64><<<grid, block, 0, s>>>(x, w, a, b, y, M, N, K, r, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
