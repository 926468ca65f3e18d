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
// Direct mode (the reference's single full-K pass, which mode "auto" takes
// for K <= 128) runs on the tensor cores too, with 128-row tiles from the
// same tile table.  Where the K slab fits the resident form (K <= 128,
// grouped_lora_resident_max_k) it runs:
//   * fp32: the same 3xTF32 tile with the whole K slab copied in one step
//     and waited for once (tf32_lora_tile.cuh, WHOLE), no stage recycled;
//   * bf16, where TMA can describe the operands: the resident tile below
//     (namespace dm).  A block walks a contiguous, balanced share of the
//     launch's (row tile, N tile) pairs in row-tile order, one block an SM.
//     A producer warpgroup loads a row tile's x slab (128 x K) and A_g once
//     by TMA and streams W tiles (K x 128) through a 2-stage TMA ring; two
//     consumer warpgroups form x @ A_g^T once per row tile (wgmma
//     m64nRPk16) and keep its three-term bf16 split (scale folded in) in
//     registers, then per N tile issue wgmma m64n128k16 over the resident
//     x and the up-projection as register-A wgmma of that split, as the
//     chunk tile does, and write y through shared memory by TMA stores in
//     bulk groups, double-buffered, so a tile's store overlaps the next
//     tile's products: the store of y is what bounds a short-K call.
//     Tiles that end inside the next group, or an N that TMA cannot
//     describe (N % 8 != 0), are stored by ordinary masked stores.
// Otherwise (K > 128, or bf16 operands TMA cannot describe) the call runs
// the chunk tiles' K sweep: the same function on another schedule, which
// the wrapper chooses before the launch and counts apart.  So direct mode
// takes every K, as the reference's does.

// What bounds it.  At the cohort shape one chunk launch does
// 2MKN + 2MKr + 2MNr = 5.03 GFLOP and must move about 28 MB: 75.1 us at
// the fp32 CUDA-core peak of 67 TFLOP/s (the bound chip_smoke.py reports),
// 30.5 us as 3 x 5.03 GFLOP of TF32 at 495 TFLOP/s, and 8 us of traffic at
// 3.35 TB/s.  Each N-tile recomputes its rows' x @ A_g^T, RP / 96 = 17 %
// more products at r 16.  In bf16 the products run at the bf16 tensor-core
// peak (989 TFLOP/s): at gemma-2b's q-projection over two groups of 4096
// rows (K = N 2048, r 16), 69 GFLOP in 70 us against 76 MB in 23 us.
// Direct mode at K 128: over two groups of 2048 rows (N 768, r 16, fp32)
// 0.92 GFLOP, 13.8 us at 67 TFLOP/s (5.6 us as 3xTF32) against 15.2 MB in
// 4.5 us; in bf16 over two groups of 4096 rows (N 2048) 4.9 GFLOP in 4.9 us
// against 36.3 MB in 10.8 us, most of it the store of y: bound by bytes.
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

constexpr int RESIDENT_MAX_K = 4 * tc::BK;   // 128: the slab one resident stage holds

// fp32: the 3xTF32 tile with the whole K slab staged at once (K <= 128)
template <int RP, bool WK>
__global__ void __launch_bounds__(tc::THREADS, 1)
grouped_lora_direct_kernel(const float* __restrict__ x, const float* __restrict__ w,
                           const float* __restrict__ a, const float* __restrict__ b,
                           const float* __restrict__ scales, const int* __restrict__ tiles,
                           float* __restrict__ y, int N, int K, int r, long long sw,
                           long long sag, long long saj, long long sak, long long sbg,
                           long long sbn, long long sbj, int vec) {
  extern __shared__ __align__(16) float sm[];
  const int* tile = tiles + 3 * blockIdx.y;
  const int g = tile[0], m0 = tile[1], rows = tile[2];
  tc::lora_tile<RP, WK, true>(sm, x, w, a + g * sag, b + g * sbg, y, m0, rows,
                              blockIdx.x * tc::BN, N, K, r, scales[g], K, sw, saj, sak, sbn,
                              sbj, vec != 0);
}

template <int RP, bool WK>
int launch_direct(const float* x, const float* w, const float* a, const float* b,
                  const float* scales, const int* tiles, float* y, int n_tiles, int N, int K,
                  int r, long long sw, long long sag, long long saj, long long sak,
                  long long sbg, long long sbn, long long sbj, cudaStream_t s) {
  if (K > RESIDENT_MAX_K) return (int)cudaErrorInvalidValue;
  using L = tc::Smem<RP, WK>;
  auto kern = grouped_lora_direct_kernel<RP, WK>;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::BYTES);
  if (err != cudaSuccess) return (int)err;
  const int vec = tc::vec_copies(x, w, K, sw, N, K);
  const dim3 grid((N + tc::BN - 1) / tc::BN, n_tiles);
  kern<<<grid, tc::THREADS, L::BYTES, s>>>(x, w, a, b, scales, tiles, y, N, K, r, sw, sag,
                                           saj, sak, sbg, sbn, sbj, vec);
  return (int)cudaGetLastError();
}

// bf16: the resident tile
namespace dm {

constexpr int BM = wg::BM;              // 128 rows: two consumer warpgroups of 64
constexpr int BN = 128;                 // columns of y per N tile
constexpr int STAGES = 2;               // W ring depth (each stage the whole K)
constexpr int CONSUMERS = wg::CONSUMERS;
constexpr int LOADERS = wg::LOADERS;
static_assert(RESIDENT_MAX_K == 2 * wg::BK, "two 64-deep panels hold the resident slab");

// shared-memory layout of a block, KPAN 64-deep panels of K (1 or 2); every
// region a multiple of the 1024 bytes a 128-byte swizzle repeats
template <int KPAN, int RP> struct Cfg {
  static constexpr int KP = 64 * KPAN;
  static constexpr int X_BYTES = KPAN * BM * 128;     // x: per panel 128 rows x 128 B
  static constexpr int A_BYTES = KPAN * RP * 128;     // A_g: per panel RP rows x 128 B
  static constexpr int W_BYTES = KPAN * BN * 128;     // a W tile, KP x BN
  static constexpr int B_BYTES = BN * 128;            // B_g^T of the N tile, K-major
  static constexpr int Y_WG = (BN / 64) * 64 * 128;   // a warpgroup's 64 rows, 64-column panels
  static constexpr int A_OFF = X_BYTES;
  static constexpr int W_OFF = A_OFF + A_BYTES;
  static constexpr int B_OFF = W_OFF + STAGES * W_BYTES;
  static constexpr int Y_OFF = B_OFF + B_BYTES;       // two buffers per warpgroup
  static constexpr size_t SMEM = (size_t)Y_OFF + 4 * Y_WG + 1024;
  static_assert(SMEM <= 232448, "the resident tile fits one SM");
};

// What one launch multiplies: the tile table's row tiles, each by every N
// tile, walked in row-tile order; A_g by pointer when not a_tma, B_g by
// pointer always; y by TMA store when y_tma.
struct Direct {
  int M, N, K, r, n_tiles_n, total;
  const float* scales;
  const int* tiles;
  const wg::half_t* a;
  long long sag, saj, sak;
  const wg::half_t* b;
  long long sbg, sbn, sbj;
  wg::half_t* y;
  bool a_tma, y_tma;
};

__device__ __forceinline__ void named_bar(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

}  // namespace dm

// KPAN: 64-deep K panels (1: K <= 64, 2: K <= 128).  RP: the rank rounded up
// to 16, 32 or 64.  WK: W is K-contiguous (the dx call's W^T view).
template <int KPAN, int RP, bool WK>
__global__ void __launch_bounds__(wg::THREADS, 1)
grouped_lora_direct_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                                 const __grid_constant__ CUtensorMap tw,
                                 const __grid_constant__ CUtensorMap ta,
                                 const __grid_constant__ CUtensorMap ty, const dm::Direct p) {
  using C = dm::Cfg<KPAN, RP>;
  using namespace dm;
  extern __shared__ __align__(1024) unsigned char smd[];
  // bars[0]: x slab full; [1]: x slab empty; [2 + s]: W stage s full;
  // [2 + STAGES + s]: W stage s empty
  __shared__ __align__(8) uint64_t bars[2 + 2 * STAGES];
  const uint32_t base = (hp::smem_u32(smd) + 1023u) & ~1023u;
  unsigned char* sm = smd + (base - hp::smem_u32(smd));
  const uint32_t xfull = hp::smem_u32(&bars[0]), xempty = hp::smem_u32(&bars[1]);
  const uint32_t wfull0 = hp::smem_u32(&bars[2]), wempty0 = hp::smem_u32(&bars[2 + STAGES]);
  const int tid = threadIdx.x;
  // this block's share of the (row tile, N tile) pairs
  const int t0 = (int)((long long)p.total * blockIdx.x / gridDim.x);
  const int t1 = (int)((long long)p.total * (blockIdx.x + 1) / gridDim.x);

  if (tid == 0) {
    hp::mbar_init(xfull, p.a_tma ? 1 : 1 + LOADERS);
    hp::mbar_init(xempty, CONSUMERS);
    for (int s = 0; s < STAGES; ++s) {
      hp::mbar_init(wfull0 + 8 * s, 1);
      hp::mbar_init(wempty0 + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int pt = tid - CONSUMERS;
    if (pt == 0) {
      int cur = -1, xloads = 0;
      for (int t = t0; t < t1; ++t) {
        const int rt = t / p.n_tiles_n, n0 = (t - rt * p.n_tiles_n) * BN;
        if (rt != cur) {
          // a new row tile: its x slab and A_g, once the consumers are done
          // with the last one's
          if (xloads > 0) hp::mbar_wait(xempty, (xloads - 1) & 1);
          hp::mbar_expect_tx(xfull, C::X_BYTES + (p.a_tma ? C::A_BYTES : 0));
#pragma unroll
          for (int kp = 0; kp < KPAN; ++kp) {
            hp::tma_load_2d(base + kp * (BM * 128), &tx, kp * 64, p.tiles[3 * rt + 1], xfull);
            if (p.a_tma)
              hp::tma_load_3d(base + C::A_OFF + kp * (RP * 128), &ta, kp * 64, 0,
                              p.tiles[3 * rt], xfull);
          }
          cur = rt;
          ++xloads;
        }
        const int i = t - t0, s = i % STAGES;
        if (i >= STAGES) hp::mbar_wait(wempty0 + 8 * s, ((i / STAGES) - 1) & 1);
        const uint32_t ws = base + C::W_OFF + s * C::W_BYTES, bar = wfull0 + 8 * s;
        hp::mbar_expect_tx(bar, C::W_BYTES);
#pragma unroll
        for (int kp = 0; kp < KPAN; ++kp) {
          if (WK) {
            // W^T rows n, 64 of K a panel: box 64 x BN
            hp::tma_load_2d(ws + kp * (BN * 128), &tw, kp * 64, n0, bar);
          } else {
            // W rows k of 64 columns a panel, KP rows a panel: boxes 64 x 64
#pragma unroll
            for (int q = 0; q < BN / 64; ++q)
              hp::tma_load_2d(ws + q * (C::KP * 128) + kp * (64 * 128), &tw, n0 + 64 * q,
                              kp * 64, bar);
          }
        }
      }
    } else if (!p.a_tma && pt >= 128 - LOADERS) {
      // A_g by hand (the dx call's B^T view, ranks contiguous): 8 ranks of
      // one k as one 16-byte load, into the swizzled K-major panels; zeros
      // past r and K
      const int lt = pt - (128 - LOADERS);
      constexpr int VECS = (RP / 8) * C::KP;
      int cur = -1, xloads = 0;
      for (int t = t0; t < t1; ++t) {
        const int rt = t / p.n_tiles_n;
        if (rt == cur) continue;
        if (xloads > 0) hp::mbar_wait(xempty, (xloads - 1) & 1);
        const wg::half_t* ag = p.a + p.tiles[3 * rt] * p.sag;
        unsigned char* as = sm + C::A_OFF;
        for (int v = lt; v < VECS; v += LOADERS) {
          const int j0 = (v / C::KP) * 8, kk = v % C::KP;
          uint4 q = make_uint4(0, 0, 0, 0);
          if (j0 < p.r && kk < p.K)
            q = *reinterpret_cast<const uint4*>(ag + j0 * p.saj + (long long)kk * p.sak);
          const wg::half_t* h = reinterpret_cast<const wg::half_t*>(&q);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            *reinterpret_cast<wg::half_t*>(as + (kk / 64) * (RP * 128) +
                                           wg::swz(j0 + e, kk % 64)) = h[e];
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        hp::mbar_arrive(xfull);
        cur = rt;
        ++xloads;
      }
    }
    return;
  }

  // ------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int c = tid >> 7;                         // this warpgroup's 64 rows
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const bool leader = (tid & 127) == 0;
  constexpr int PAIRS = BN * RP / 2 / CONSUMERS;
  const uint32_t xs = base + c * 64 * 128, as = base + C::A_OFF;
  unsigned char* bsm = sm + C::B_OFF;

  float acc[BN / 2];
  uint32_t af[RP / 16][3][4];
  int cur = -1, xloads = 0, stores = 0, m0 = 0, rows = 0;
  const wg::half_t* bg = p.b;
  for (int t = t0; t < t1; ++t) {
    const int i = t - t0, s = i % STAGES;
    const int rt = t / p.n_tiles_n, n0 = (t - rt * p.n_tiles_n) * BN;
    const bool new_rows = rt != cur;
    float scale = 0.f;
    if (new_rows) {
      const int g = p.tiles[3 * rt];
      m0 = p.tiles[3 * rt + 1];
      rows = p.tiles[3 * rt + 2];
      scale = p.scales[g];
      bg = p.b + g * p.sbg;
    }
    // B_g^T of this N tile into registers first, so its latency hides behind
    // the products: bf16 pairs (j, j + 1) of row n, zero past r and N
    uint32_t bq[PAIRS];
#pragma unroll
    for (int e = 0; e < PAIRS; ++e) {
      const int q = tid + e * CONSUMERS, n = q / (RP / 2), j = 2 * (q % (RP / 2));
      const int gn = n0 + n;
      const wg::half_t* bp = bg + (long long)gn * p.sbn + (long long)j * p.sbj;
      const uint32_t lo = (gn < p.N && j < p.r) ? bp[0] : 0;
      const uint32_t hi = (gn < p.N && j + 1 < p.r) ? bp[p.sbj] : 0;
      bq[e] = lo | (hi << 16);
    }

    if (new_rows) {
      // the last row tile's x and A_g are no longer read: the slab may go
      if (xloads > 0) hp::mbar_arrive(xempty);
      hp::mbar_wait(xfull, xloads & 1);
      // scale * x @ A_g^T over the slab, once per row tile, split into three
      // bf16 terms in the A-fragment layout of a register-sourced wgmma
      float xacc[RP / 2];
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KPAN * 4; ++kk) {
        const uint32_t off = (kk / 4) * (BM * 128) + (kk % 4) * 32;
        hp::WgmmaSS<RP, 0>::run(xacc, hp::make_desc(xs + off, 16, 1024, 1),
                                hp::make_desc(as + (kk / 4) * (RP * 128) + (kk % 4) * 32, 16,
                                              1024, 1),
                                kk > 0);
      }
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::reg_fence(xacc);
#pragma unroll
      for (int kk = 0; kk < RP / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float2 v = make_float2(scale * xacc[8 * kk + 2 * e], scale * xacc[8 * kk + 2 * e + 1]);
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            const __nv_bfloat162 part = __floats2bfloat162_rn(v.x, v.y);
            const float2 pf = __bfloat1622float2(part);
            af[kk][q][e] = *reinterpret_cast<const uint32_t*>(&part);
            v = make_float2(v.x - pf.x, v.y - pf.y);      // exact in f32
          }
        }
      cur = rt;
      ++xloads;
    }

    // x @ W over the whole K of this N tile
    hp::mbar_wait(wfull0 + 8 * s, (i / STAGES) & 1);
    const uint32_t ws = base + C::W_OFF + s * C::W_BYTES;
    hp::reg_fence(acc);
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KPAN * 4; ++kk) {
      const uint64_t dx = hp::make_desc(xs + (kk / 4) * (BM * 128) + (kk % 4) * 32, 16, 1024, 1);
      // K-major W^T: panel kk / 4, 32 bytes along each row; N-major W: rows
      // 16 kk.. of every 64-column panel, panels KP * 128 bytes apart
      const uint64_t dw =
          WK ? hp::make_desc(ws + (kk / 4) * (BN * 128) + (kk % 4) * 32, 16, 1024, 1)
             : hp::make_desc(ws + kk * 16 * 128, C::KP * 128, 1024, 1);
      hp::WgmmaSS<BN, WK ? 0 : 1>::run(acc, dx, dw, kk > 0);
    }
    hp::wgmma_commit();
    // B_g^T into shared memory while the products run, once both warpgroups
    // are past the last tile's up-projection
    named_bar(1, CONSUMERS);
#pragma unroll
    for (int e = 0; e < PAIRS; ++e) {
      const int q = tid + e * CONSUMERS;
      *reinterpret_cast<uint32_t*>(bsm + wg::swz(q / (RP / 2), 2 * (q % (RP / 2)))) = bq[e];
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_bar(1, CONSUMERS);
    hp::wgmma_wait<0>();
    hp::reg_fence(acc);
    hp::mbar_arrive(wempty0 + 8 * s);           // the W stage may be refilled

    // acc += (scale * x @ A_g^T) @ B_g^T: three register-A products a k16
    // slice of ranks
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < RP / 16; ++kk) {
      const uint64_t db = hp::make_desc(hp::smem_u32(bsm) + kk * 32, 16, 1024, 1);
#pragma unroll
      for (int q = 0; q < 3; ++q) hp::WgmmaRS<BN, 0>::run(acc, af[kk][q], db);
    }
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::reg_fence(acc);

    // epilogue: y rounded to bf16 once
    const int wrow = warp * 16 + g8;              // rows wrow, wrow + 8 of the warpgroup's 64
    if (p.y_tma && (rows == BM || m0 + rows == p.M)) {
      // into this warpgroup's staging buffer (64-column panels, 128-byte
      // swizzled as TMA reads them), then one thread's TMA stores; the
      // buffer last stored two tiles ago must have been read first
      const int buf = stores & 1;
      ++stores;
      const uint32_t ys = base + C::Y_OFF + (2 * buf + c) * C::Y_WG;
      unsigned char* ysm = sm + C::Y_OFF + (2 * buf + c) * C::Y_WG;
      if (leader) hp::bulk_wait_read<1>();
      named_bar(2 + c, 128);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = 8 * j + 2 * t4;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t v = uint32_t(wg::narrow(acc[4 * j + 2 * h])) |
                             (uint32_t(wg::narrow(acc[4 * j + 2 * h + 1])) << 16);
          *reinterpret_cast<uint32_t*>(ysm + (col / 64) * (64 * 128) +
                                       wg::swz(wrow + 8 * h, col % 64)) = v;
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_bar(2 + c, 128);
      if (leader) {
#pragma unroll
        for (int q = 0; q < BN / 64; ++q)
          hp::tma_store_2d(&ty, ys + q * (64 * 128), n0 + 64 * q, m0 + 64 * c);
        hp::bulk_commit();
      }
    } else {
      const bool pairs = (p.N % 2) == 0;   // y's column pairs are 4-byte aligned
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = c * 64 + wrow + 8 * h;
        if (row >= rows) continue;
        wg::half_t* dst = p.y + (size_t)(m0 + row) * p.N;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int gn = n0 + 8 * j + 2 * t4;
          const wg::half_t v0 = wg::narrow(acc[4 * j + 2 * h]);
          const wg::half_t v1 = wg::narrow(acc[4 * j + 2 * h + 1]);
          if (pairs && gn + 1 < p.N) {
            *reinterpret_cast<uint32_t*>(dst + gn) = uint32_t(v0) | (uint32_t(v1) << 16);
          } else {
            if (gn < p.N) dst[gn] = v0;
            if (gn + 1 < p.N) dst[gn + 1] = v1;
          }
        }
      }
    }
  }
  if (leader) hp::bulk_wait_read<0>();            // every store has read its buffer
}

template <int KPAN, int RP, bool WK>
int launch_direct_wgmma(const wg::Maps& maps, const CUtensorMap& ty, const dm::Direct& p,
                        cudaStream_t s) {
  using C = dm::Cfg<KPAN, RP>;
  auto kern = grouped_lora_direct_wgmma_kernel<KPAN, RP, WK>;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int grid = p.total < sms ? p.total : sms;   // one block an SM
  kern<<<grid, wg::THREADS, C::SMEM, s>>>(maps.tx, maps.tw, maps.ta, ty, p);
  return (int)cudaGetLastError();
}

template <int KPAN, bool WK>
int direct_rank(const wg::Maps& maps, const CUtensorMap& ty, const dm::Direct& p,
                cudaStream_t s) {
  if (p.r <= 16) return launch_direct_wgmma<KPAN, 16, WK>(maps, ty, p, s);
  if (p.r <= 32) return launch_direct_wgmma<KPAN, 32, WK>(maps, ty, p, s);
  return launch_direct_wgmma<KPAN, 64, WK>(maps, ty, p, s);
}

template <bool WK>
int direct_depth(const wg::Maps& maps, const CUtensorMap& ty, const dm::Direct& p,
                 cudaStream_t s) {
  return p.K <= 64 ? direct_rank<1, WK>(maps, ty, p, s) : direct_rank<2, WK>(maps, ty, p, s);
}

template <int RP>
int launch(const float* x, const float* w, const float* a, const float* b,
           const float* scales, const int* tiles, float* y, int n_tiles, int N, int K, int r,
           bool direct, long long sw, bool w_kmajor, long long sag, long long saj,
           long long sak, long long sbg, long long sbn, long long sbj, cudaStream_t s) {
  if (direct && w_kmajor)
    return launch_direct<RP, true>(x, w, a, b, scales, tiles, y, n_tiles, N, K, r, sw, sag,
                                   saj, sak, sbg, sbn, sbj, s);
  if (direct)
    return launch_direct<RP, false>(x, w, a, b, scales, tiles, y, n_tiles, N, K, r, sw, sag,
                                    saj, sak, sbg, sbn, sbj, s);
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
  // the mma.sync tile sweeps K in both modes: bf16 direct mode's resident
  // tile is the wgmma one (grouped_lora_bf16_tma)
  (void)direct;
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

// the largest K a direct-mode call runs on a resident tile; above it the
// wrapper sends direct mode to the chunk tiles' K sweep
int grouped_lora_resident_max_k() { return RESIDENT_MAX_K; }

// tiles: (n_tiles, 3) int32 rows of (group, first row, rows), rows <= 128,
// every row of y in exactly one tile.  x (M, K) contiguous; W (K, N):
// w_kmajor 0 -> element (k, n) at k * sw + n, 1 -> at n * sw + k; A element
// (g, j, k) at g * sag + j * saj + k * sak; B element (g, n, j) at
// g * sbg + n * sbn + j * sbj; y (M, N) contiguous.  direct 1: the resident
// whole-slab tile (K <= grouped_lora_resident_max_k()), 0: the K sweep.
// Launches on ``stream`` and returns cudaGetLastError() (0 on success).
int grouped_lora_f32(const float* x, const float* w, const float* a, const float* b,
                     const float* scales, const int* tiles, float* y, int n_tiles, int N,
                     int K, int r, int direct, long long sw, int w_kmajor, long long sag,
                     long long saj, long long sak, long long sbg, long long sbn,
                     long long sbj, void* stream) {
  return launch_rank(x, w, a, b, scales, tiles, y, n_tiles, N, K, r, direct, sw, w_kmajor,
                     sag, saj, sak, sbg, sbn, sbj, stream);
}

// the K sweep in bf16 on the mma.sync tile (raw 16-bit words; scales f32),
// y in bf16: the arguments of grouped_lora_f32 less ``direct``
int grouped_lora_bf16(const void* x, const void* w, const void* a, const void* b,
                      const float* scales, const int* tiles, void* y, int n_tiles, int N,
                      int K, int r, long long sw, int w_kmajor, long long sag, long long saj,
                      long long sak, long long sbg, long long sbn, long long sbj,
                      void* stream) {
  typedef const bc::half_t* P;
  return launch_rank(P(x), P(w), P(a), P(b), scales, tiles, static_cast<bc::half_t*>(y),
                     n_tiles, N, K, r, 0, sw, w_kmajor, sag, saj, sak, sbg, sbn, sbj, stream);
}

// bf16 on the wgmma tiles, for operands TMA can describe (wg::wgmma_ok; the
// wrapper's tma_ok): the arguments of grouped_lora_f32 with M (x's rows) and
// G (the groups A and B hold).  direct 1: the resident tile (dm, K <=
// grouped_lora_resident_max_k()), 0: the K sweep (bf16_wgmma_tile.cuh).
// Returns cudaErrorInvalidValue for other operands, and when a tensor map
// does not encode
int grouped_lora_bf16_tma(const void* x, const void* w, const void* a, const void* b,
                          const float* scales, const int* tiles, void* y, int n_tiles, int M,
                          int N, int K, int r, int G, int direct, long long sw, int w_kmajor,
                          long long sag, long long saj, long long sak, long long sbg,
                          long long sbn, long long sbj, void* stream) {
  if (n_tiles <= 0 || n_tiles > MAX_TILES || M <= 0 || N <= 0 || G <= 0 ||
      r > wg::MAX_RANK || !wg::wgmma_ok(x, w, a, K, r, K, sw, saj, sak, sag) ||
      (direct && K > RESIDENT_MAX_K))
    return (int)cudaErrorInvalidValue;
  const bool a_tma = wg::a_mode(a, r, saj, sak, sag) == 0;
  typedef const wg::half_t* P;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (direct) {
    wg::Maps maps;
    if (!wg::encode_maps(&maps, x, w, a, M, N, K, r, G, K, sw, w_kmajor != 0, saj, sag,
                         dm::BN, wg::rank_tile(r), a_tma))
      return (int)cudaErrorInvalidValue;
    // y (M, N) by TMA store where its rows are 16-byte multiples: boxes of
    // 64 columns x 64 rows, one warpgroup's half of a 64-column panel
    CUtensorMap ty;
    memset(&ty, 0, sizeof(ty));
    const bool y_tma = N % 8 == 0;
    const long long yd[2] = {N, M}, ysd[1] = {N};
    const int yb[2] = {64, 64};
    if (y_tma && !wg::encode(&ty, y, 2, yd, ysd, yb)) return (int)cudaErrorInvalidValue;
    const int n_tiles_n = (N + dm::BN - 1) / dm::BN;
    const dm::Direct p = {M, N, K, r, n_tiles_n, n_tiles * n_tiles_n, scales, tiles,
                          P(a), sag, saj, sak, P(b), sbg, sbn, sbj,
                          static_cast<wg::half_t*>(y), a_tma, y_tma};
    return w_kmajor ? direct_depth<true>(maps, ty, p, s) : direct_depth<false>(maps, ty, p, s);
  }
  const int bn = wg::tile_width(N, n_tiles);
  WgmmaCall c;
  if (!wg::encode_maps(&c.maps, x, w, a, M, N, K, r, G, K, sw, w_kmajor != 0, saj, sag, bn,
                       wg::rank_tile(r), a_tma))
    return (int)cudaErrorInvalidValue;
  c.t = {0, 0, 0, N, K, r, 0, 0.f, P(a), saj, sak, P(b), sbn, sbj,
         static_cast<wg::half_t*>(y), a_tma};
  c.scales = scales;
  c.tiles = tiles;
  c.n_tiles = n_tiles;
  c.sag = sag;
  c.sbg = sbg;
  return w_kmajor ? wgmma_width<true>(bn, c, s) : wgmma_width<false>(bn, c, s);
}

}  // extern "C"
