// Fused base + LoRA matmul for Hopper (sm_90a), in fp32 through 3xTF32 and
// in bf16 on the bf16 tensor cores:
//
//     y = x @ W + scale * (x @ A^T) @ B^T
//
// x (M, K) row-major with row stride sx; W (K, N) either N-contiguous (the
// forward's W, row stride sw) or K-contiguous (the backward's W^T view of a
// contiguous (N, K) tensor, column stride sw); A (r, K) and B (N, r) by
// any strides (the backward passes the transposed views B^T and A^T);
// y (M, N) contiguous, in x's type; r <= 64.  All four operands share one
// type: float (lora_matmul_f32) or bf16 (lora_matmul_bf16).
//
// Replaces src/repro/kernels/lora_matmul.py:lora_matmul (the Pallas TPU
// kernel, body _kernel), which runs in either type with f32 accumulators and
// writes y in x's type.  Like it, the rank-r down-projection x @ A^T rides
// the same K sweep as the base product, so x is read once for both, and the
// (M, r) intermediate never goes to device memory: the up-projection is
// applied in the epilogue from shared memory, in f32.
//
// fp32 (tf32_lora_tile.cuh, the body this kernel shares with
// grouped_lora.cu's chunk mode): 3xTF32 mma.sync.m16n8k8 (about 22-bit
// operands; each k8 slice's products added to the f32 accumulator with
// round-to-nearest), one block of 256 threads per 128 x 96 tile of y, and a
// 4-stage cp.async ring of 32-deep K steps carrying x, W and A.  At the main
// path's shape (M 2048, K = N 768, r 16) the tiles make 16 x 8 = 128 blocks,
// one wave on the 132 SMs (64 x 64 tiles made 384 blocks, a 2.9-wave tail).
//
// bf16, two tiles shared the same way, chosen by the operands before the
// launch (the wrapper's tma_ok, wg::wgmma_ok here):
//   * bf16_wgmma_tile.cuh (entry lora_matmul_bf16_tma), wherever TMA can
//     describe x and W and A is K-contiguous or its ranks contiguous in
//     16-byte runs: every shape of the LM paths, the backward's views
//     included.  wgmma m64nBNk16 fed by a 4-stage TMA ring that a producer
//     warpgroup keeps in flight, two consumer warpgroups a 128 x BN tile
//     (BN 256, 128 or 64 by the grid), the up-projection on the tensor
//     cores from a three-term bf16 split of the f32 x @ A^T;
//   * bf16_lora_tile.cuh (entry lora_matmul_bf16) for the rest (K 130,
//     N 770, unaligned slices, the B^T view at r 5): mma.sync.m16n8k16 with
//     f32 accumulators fed by ldmatrix (.trans for the forward's
//     N-contiguous W), one block of 256 threads per 128 x 128 tile, two
//     blocks an SM up to r 32, a 4-stage ring of 32-deep K steps.
//
// What bounds it.  fp32, at the main path's shape one launch does
// 2MKN + 2MKr + 2MNr = 2.52 GFLOP and must move about 15 MB: 37.6 us at the
// fp32 CUDA-core peak of 67 TFLOP/s (the least time for fp32 products, the
// bound chip_smoke.py reports); 3 x 2.52 GFLOP of TF32 at 495 TFLOP/s is
// 15.3 us, and 15 MB at 3.35 TB/s 4.5 us.  Each N-tile recomputes its rows'
// x @ A^T, RP / 96 = 17 % more products at r 16.  bf16, at gemma-2b's
// q-projection (M 8192, K = N 2048, r 16): 69 GFLOP, 70 us at 989 TFLOP/s,
// against 76 MB, 23 us at 3.35 TB/s: bound by operations.  Measured times
// are in PERF.md.

#include "bf16_lora_tile.cuh"
#include "bf16_wgmma_tile.cuh"
#include "tf32_lora_tile.cuh"

namespace {

using namespace tc;

// RP: the rank rounded up to 16, 32 or 64.  WK: W is K-contiguous.
template <int RP, bool WK>
__global__ void __launch_bounds__(THREADS, 1)
lora_matmul_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ a, const float* __restrict__ b,
                   float* __restrict__ y, int M, int N, int K, int r, float scale,
                   long long sx, long long sw, long long saj, long long sak,
                   long long sbn, long long sbj, int vec) {
  extern __shared__ __align__(16) float sm[];
  const int m0 = blockIdx.y * BM;
  lora_tile<RP, WK>(sm, x, w, a, b, y, m0, min(BM, M - m0), blockIdx.x * BN, N, K, r,
                    scale, sx, sw, saj, sak, sbn, sbj, vec != 0);
}

template <int RP, bool WK>
int launch(const float* x, const float* w, const float* a, const float* b, float* y, int M,
           int N, int K, int r, float scale, long long sx, long long sw, long long saj,
           long long sak, long long sbn, long long sbj, int vec, cudaStream_t s) {
  auto kern = lora_matmul_kernel<RP, WK>;
  // the shared-memory opt-in acts on the current device only, so it is made
  // on every launch (a few microseconds): a launch on another card needs it too
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Smem<RP, WK>::BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kern<<<grid, THREADS, Smem<RP, WK>::BYTES, s>>>(x, w, a, b, y, M, N, K, r, scale, sx, sw,
                                                  saj, sak, sbn, sbj, vec);
  return (int)cudaGetLastError();
}

template <bool WK>
int dispatch_rank(const float* x, const float* w, const float* a, const float* b, float* y,
                  int M, int N, int K, int r, float scale, long long sx, long long sw,
                  long long saj, long long sak, long long sbn, long long sbj, int vec,
                  cudaStream_t s) {
  if (r <= 16)
    return launch<16, WK>(x, w, a, b, y, M, N, K, r, scale, sx, sw, saj, sak, sbn, sbj, vec, s);
  if (r <= 32)
    return launch<32, WK>(x, w, a, b, y, M, N, K, r, scale, sx, sw, saj, sak, sbn, sbj, vec, s);
  return launch<64, WK>(x, w, a, b, y, M, N, K, r, scale, sx, sw, saj, sak, sbn, sbj, vec, s);
}

// ------------------------------------------------------------------ bf16

template <int RP, bool WK>
__global__ void __launch_bounds__(bc::THREADS, bc::min_blocks<RP>())
lora_matmul_bf16_kernel(const bc::half_t* __restrict__ x, const bc::half_t* __restrict__ w,
                        const bc::half_t* __restrict__ a, const bc::half_t* __restrict__ b,
                        bc::half_t* __restrict__ y, int M, int N, int K, int r, float scale,
                        long long sx, long long sw, long long saj, long long sak,
                        long long sbn, long long sbj, int vec) {
  extern __shared__ __align__(16) unsigned char smb[];
  const int m0 = blockIdx.y * bc::BM;
  bc::lora_tile<RP, WK>(smb, x, w, a, b, y, m0, min(bc::BM, M - m0), blockIdx.x * bc::BN, N,
                        K, r, scale, sx, sw, saj, sak, sbn, sbj, vec != 0);
}

template <int RP, bool WK>
int launch_bf16(const bc::half_t* x, const bc::half_t* w, const bc::half_t* a,
                const bc::half_t* b, bc::half_t* y, int M, int N, int K, int r, float scale,
                long long sx, long long sw, long long saj, long long sak, long long sbn,
                long long sbj, int vec, cudaStream_t s) {
  using L = bc::Smem<RP, WK>;
  auto kern = lora_matmul_bf16_kernel<RP, WK>;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + bc::BN - 1) / bc::BN, (M + bc::BM - 1) / bc::BM);
  kern<<<grid, bc::THREADS, L::BYTES, s>>>(x, w, a, b, y, M, N, K, r, scale, sx, sw, saj, sak,
                                           sbn, sbj, vec);
  return (int)cudaGetLastError();
}

template <bool WK>
int dispatch_rank_bf16(const bc::half_t* x, const bc::half_t* w, const bc::half_t* a,
                       const bc::half_t* b, bc::half_t* y, int M, int N, int K, int r,
                       float scale, long long sx, long long sw, long long saj, long long sak,
                       long long sbn, long long sbj, int vec, cudaStream_t s) {
  if (r <= 16)
    return launch_bf16<16, WK>(x, w, a, b, y, M, N, K, r, scale, sx, sw, saj, sak, sbn, sbj,
                               vec, s);
  if (r <= 32)
    return launch_bf16<32, WK>(x, w, a, b, y, M, N, K, r, scale, sx, sw, saj, sak, sbn, sbj,
                               vec, s);
  return launch_bf16<64, WK>(x, w, a, b, y, M, N, K, r, scale, sx, sw, saj, sak, sbn, sbj,
                             vec, s);
}

// ------------------------------------------------------- bf16 on wgmma

// BN: the tile width (256, 128 or 64).  RP: the rank rounded up to 16, 32 or
// 64.  WK: W is K-contiguous.
template <int BN, int RP, bool WK>
__global__ void __launch_bounds__(wg::THREADS, 1)
lora_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                         const __grid_constant__ CUtensorMap tw,
                         const __grid_constant__ CUtensorMap ta, wg::Tile t, int M) {
  extern __shared__ __align__(1024) unsigned char smw[];
  __shared__ __align__(8) uint64_t bars[2 * wg::STAGES];
  t.m0 = blockIdx.y * wg::BM;
  t.rows = min(wg::BM, M - t.m0);
  t.n0 = blockIdx.x * BN;
  wg::lora_tile<BN, RP, WK>(smw, bars, &tx, &tw, &ta, t);
}

template <int BN, int RP, bool WK>
int launch_wgmma(const wg::Maps& maps, const wg::Tile& t, int M, cudaStream_t s) {
  using C = wg::Cfg<BN, RP>;
  auto kern = lora_matmul_wgmma_kernel<BN, RP, WK>;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((t.N + BN - 1) / BN, (M + wg::BM - 1) / wg::BM);
  kern<<<grid, wg::THREADS, C::SMEM, s>>>(maps.tx, maps.tw, maps.ta, t, M);
  return (int)cudaGetLastError();
}

template <int BN, bool WK>
int wgmma_rank(const wg::Maps& maps, const wg::Tile& t, int M, cudaStream_t s) {
  if (t.r <= 16) return launch_wgmma<BN, 16, WK>(maps, t, M, s);
  if (t.r <= 32) return launch_wgmma<BN, 32, WK>(maps, t, M, s);
  return launch_wgmma<BN, 64, WK>(maps, t, M, s);
}

template <bool WK>
int wgmma_width(int bn, const wg::Maps& maps, const wg::Tile& t, int M, cudaStream_t s) {
  if (bn == 256) return wgmma_rank<256, WK>(maps, t, M, s);
  if (bn == 128) return wgmma_rank<128, WK>(maps, t, M, s);
  return wgmma_rank<64, WK>(maps, t, M, s);
}

}  // namespace

extern "C" {

int lora_matmul_max_rank() { return MAX_RANK; }

// x (M, K) with row stride sx; W (K, N): w_kmajor 0 -> element (k, n) at
// k * sw + n, 1 -> at n * sw + k; A (r, K) element (j, k) at j * saj + k * sak;
// B (N, r) element (n, j) at n * sbn + j * sbj; y (M, N) contiguous.
// Launches on ``stream`` and returns cudaGetLastError() (0 on success).
int lora_matmul_f32(const float* x, const float* w, const float* a, const float* b, float* y,
                    int M, int N, int K, int r, float scale, long long sx, long long sw,
                    int w_kmajor, long long saj, long long sak, long long sbn, long long sbj,
                    void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || r < 0 || r > MAX_RANK) return (int)cudaErrorInvalidValue;
  const bool vec = vec_copies(x, w, sx, sw, N, K);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_kmajor)
    return dispatch_rank<true>(x, w, a, b, y, M, N, K, r, scale, sx, sw, saj, sak, sbn, sbj,
                               vec, s);
  return dispatch_rank<false>(x, w, a, b, y, M, N, K, r, scale, sx, sw, saj, sak, sbn, sbj,
                              vec, s);
}

// the same in bf16 (raw 16-bit words), y in bf16
int lora_matmul_bf16(const void* x, const void* w, const void* a, const void* b, void* y,
                     int M, int N, int K, int r, float scale, long long sx, long long sw,
                     int w_kmajor, long long saj, long long sak, long long sbn, long long sbj,
                     void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || r < 0 || r > MAX_RANK) return (int)cudaErrorInvalidValue;
  typedef const bc::half_t* P;
  const int vec = bc::vec_copies(x, w, sx, sw, N, K);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bc::half_t* yh = static_cast<bc::half_t*>(y);
  if (w_kmajor)
    return dispatch_rank_bf16<true>(P(x), P(w), P(a), P(b), yh, M, N, K, r, scale, sx, sw, saj,
                                    sak, sbn, sbj, vec, s);
  return dispatch_rank_bf16<false>(P(x), P(w), P(a), P(b), yh, M, N, K, r, scale, sx, sw, saj,
                                   sak, sbn, sbj, vec, s);
}

// the same on the wgmma tile (bf16_wgmma_tile.cuh), for operands TMA can
// describe (wg::wgmma_ok; the wrapper's tma_ok): returns
// cudaErrorInvalidValue for any other, and when a tensor map does not encode
int lora_matmul_bf16_tma(const void* x, const void* w, const void* a, const void* b, void* y,
                         int M, int N, int K, int r, float scale, long long sx, long long sw,
                         int w_kmajor, long long saj, long long sak, long long sbn,
                         long long sbj, void* stream) {
  if (M <= 0 || N <= 0 || r > wg::MAX_RANK ||
      !wg::wgmma_ok(x, w, a, K, r, sx, sw, saj, sak, 0))
    return (int)cudaErrorInvalidValue;
  const bool a_tma = wg::a_mode(a, r, saj, sak, 0) == 0;
  const int bn = wg::tile_width(N, (M + wg::BM - 1) / wg::BM);
  wg::Maps maps;
  if (!wg::encode_maps(&maps, x, w, a, M, N, K, r, 1, sx, sw, w_kmajor != 0, saj, 0, bn,
                       wg::rank_tile(r), a_tma))
    return (int)cudaErrorInvalidValue;
  typedef const wg::half_t* P;
  const wg::Tile t = {0, 0, 0, N, K, r, 0, scale, P(a), saj, sak, P(b), sbn, sbj,
                      static_cast<wg::half_t*>(y), a_tma};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return w_kmajor ? wgmma_width<true>(bn, maps, t, M, s) : wgmma_width<false>(bn, maps, t, M, s);
}

}  // extern "C"
