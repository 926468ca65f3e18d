// One 128 x BN tile of the fused base + LoRA product in bf16 on Hopper's
// warpgroup tensor-core products (wgmma), fed by TMA:
//
//     y[m0 : m0+rows, n0 : n0+BN] = bf16( x @ W + scale * (x @ A^T) @ B^T )
//
// The bf16 body of lora_matmul.cu (one adapter, tiles in a grid) and of
// grouped_lora.cu's chunk mode (one adapter per group, tiles from the device
// tile table) wherever TMA can describe the operands (wgmma_ok below, and
// tma_ok in the Python wrappers); the mma.sync tile in
// bf16_lora_tile.cuh takes the rest.  Replaces, with it, the bf16 path of
// src/repro/kernels/lora_matmul.py:lora_matmul and of
// src/repro/kernels/grouped_lora.py:grouped_lora_matmul mode "chunk".
//
// What bounds it.  At gemma-2b's q-projection (M 8192, K = N 2048, r 16)
// one call is 69 GFLOP, 70 us at the bf16 tensor-core peak of 989 TFLOP/s,
// against 76 MB, 23 us at 3.35 TB/s: bound by operations.  At its k/v
// projection (N 256) 8.6 GFLOP (8.7 us) against 39 MB (11.6 us): bytes.
// The design serves the first: the tensor cores kept fed by an
// asynchronous ring, tiles wide enough that each x and W byte brought into
// shared memory feeds many products.  Measured times are in PERF.md.
//
// Block.  384 threads: two consumer warpgroups, each owning 64 rows of the
// tile, and one producer warpgroup that lowers its registers to 40 with
// setmaxnreg (the consumers raise theirs to 232 for the BN / 2 f32
// accumulators a thread).  The producer keeps a ring of STAGES stages in
// flight, each 64 deep in K: x (128 x 64) and W (64 x BN, or BN x 64 for
// the K-contiguous W^T view) by TMA into 128-byte-swizzled panels, and A
// (RP x 64) by TMA where it is K-contiguous or else by the producer's own
// 16-byte loads along r (the backward's B^T view), written into the same
// swizzled layout.  Each stage's arrival is an mbarrier ("full": the TMA
// transaction bytes, plus one arrival from each loading thread); each
// consumer thread hands a stage back on its "empty" mbarrier once the
// products that read it are done.
//
// Products.  Per k16 slice a consumer warpgroup issues
// wgmma.m64nBNk16 for x @ W and wgmma.m64nRPk16 for x @ A^T with the same
// x descriptor, so x is read once for both and A's rows ride along at
// RP / BN more products (6 % at r 16, BN 256).  W's major-ness is the
// transpose bit of the B descriptor: the forward's N-contiguous W is an
// N-major B (panels of 64 columns), the dx call's W^T view a K-major one.
// Each stage's products are committed as one group and the consumer waits
// for the previous stage's group only, so the tensor cores always hold the
// next stage's products.
//
// Numerics.  bf16 products summed in f32.  The rank-r intermediate
// x @ A^T stays in f32 through the K sweep, as the reference keeps it in an
// f32 scratch.  The up-projection runs on the tensor cores too: after the
// sweep, v = scale * (x @ A^T), whose accumulator layout is the A-fragment
// layout of a register-sourced wgmma, is split into three bf16 terms
// (hi = bf16(v), mid = bf16(v - hi), lo = bf16(v - hi - mid)), which hold v
// to about 2^-26 of itself, and each k16 slice of ranks adds their three
// products with B^T into the accumulators (B^T staged in the freed ring;
// B's bf16 values were fetched into registers at the tile's start).  So
// the adapter term carries no bf16 rounding of the intermediate.  Two terms
// (about 2^-17) were measured as well: their error against exact products
// was the plain version's, but they moved one ill-conditioned rwkv6-3b
// adapter gradient past the card's 5e-2 check, where three terms, like f32
// FMAs, do not (PERF.md).  One rounding to bf16 at the end.
//
// Tile width.  BN is the widest of 256, 128 and 64 whose grid of 128 x BN
// tiles covers at least 7/8 of the SMs: 256 at gemma-2b's q/o projection
// and rwkv6-3b's 2560 and 8960 columns over 8192 rows, 128 at gemma-2b's
// k/v projection (N 256: 128 tiles, one wave), where it beat 64-wide tiles
// (two waves, each x row read from L2 four times) and 256-wide ones (64
// tiles) on the H100.  BM stays 128, so grouped_lora.py's 128-row tile
// table serves every width.
//
// Edges.  TMA fills rows past M, columns past N and K with zeros, so the
// caller pads nothing; y is stored by masked ordinary stores (two bf16 a
// 32-bit store where N is even).  In the grouped chunk mode a tile's rows
// may end inside x where the next group begins: TMA loads those rows (a TMA
// load clips only at the tensor's edge) and their x @ A^T is computed with
// this group's A, but neither is stored: only the tile's own rows are.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

namespace {

namespace wg {

constexpr int BM = 128;          // rows of y per block: two warpgroups of 64
constexpr int BK = 64;           // K depth of a stage: one 128-byte bf16 row
constexpr int STAGES = 4;        // ring depth
constexpr int CONSUMERS = 256;   // two consumer warpgroups
constexpr int THREADS = 384;     // and the producer warpgroup
constexpr int LOADERS = 96;      // producer threads loading A by hand (warps 1-3)
constexpr int MAX_RANK = 64;
constexpr int WIDTHS[3] = {256, 128, 64};   // the tile widths, widest first

typedef uint16_t half_t;         // a bf16 as its raw bits

template <int BN, int RP> struct Cfg {
  static constexpr int X_BYTES = BM * BK * 2;      // 16 KB
  static constexpr int W_BYTES = BK * BN * 2;      // 32 KB at BN 256
  static constexpr int A_BYTES = RP * BK * 2;
  static constexpr int STAGE = X_BYTES + W_BYTES + A_BYTES;   // multiples of 1024
  static constexpr int RING = STAGES * STAGE;
  // the epilogue's B^T, BN rows of 128 bytes, reuses the ring
  static_assert(RING >= BN * 128, "the ring holds B^T");
  // and slack to align the base to the 1024 bytes a 128-byte swizzle repeats
  static constexpr size_t SMEM = (size_t)RING + 1024;
};

__device__ __forceinline__ half_t narrow(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// byte offset of element (row, k) in a K-major tile of 64-element rows,
// 128-byte swizzled as TMA writes it: the 16-byte chunk k / 8 of a row
// lands at chunk (k / 8) ^ (row % 8)
__device__ __forceinline__ uint32_t swz(int row, int k) {
  return row * 128 + ((((k >> 3) ^ row) & 7) << 4) + (k & 7) * 2;
}

// What one block multiplies.  tx: x (K, M) map, box 64 x 128; tw: W, either
// (N, K) N-contiguous with box 64 x 64 (WK false) or (K, N) K-contiguous
// with box 64 x BN (WK true); ta: A (K, r, G), box 64 x RP x 1, read when
// a_tma; otherwise A_g element (j, k) at a[j * saj + k * sak] (saj 1, r a
// multiple of 8, a and sak 16-byte multiples).  B_g element (n, j) at
// b[n * sbn + j * sbj]; y (., N) contiguous.
struct Tile {
  int m0, rows, n0, N, K, r, group;
  float scale;
  const half_t* a;
  long long saj, sak;
  const half_t* b;
  long long sbn, sbj;
  half_t* y;
  bool a_tma;
};

// The block's tile.  RP: the rank rounded up to 16, 32 or 64.  WK: W is
// K-contiguous.  Called once by every thread of a 384-thread block; the
// producer and consumer branches never join again.
template <int BN, int RP, bool WK>
__device__ __forceinline__ void lora_tile(unsigned char* smem_raw, uint64_t* bars,
                                          const CUtensorMap* tx, const CUtensorMap* tw,
                                          const CUtensorMap* ta, const Tile& t) {
  using C = Cfg<BN, RP>;
  const uint32_t base = (hp::smem_u32(smem_raw) + 1023u) & ~1023u;
  // bars[s]: stage s full; bars[STAGES + s]: stage s empty
  const uint32_t full0 = hp::smem_u32(&bars[0]), empty0 = hp::smem_u32(&bars[STAGES]);
  const int tid = threadIdx.x;
  const int nk = (t.K + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hp::mbar_init(full0 + 8 * s, t.a_tma ? 1 : 1 + LOADERS);
      hp::mbar_init(empty0 + 8 * s, CONSUMERS);
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
      const uint32_t bytes = C::X_BYTES + C::W_BYTES + (t.a_tma ? C::A_BYTES : 0);
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) hp::mbar_wait(empty0 + 8 * s, ((kt / STAGES) - 1) & 1);
        const uint32_t xs = base + s * C::STAGE, ws = xs + C::X_BYTES,
                       as = ws + C::W_BYTES, bar = full0 + 8 * s;
        hp::mbar_expect_tx(bar, bytes);
        hp::tma_load_2d(xs, tx, kt * BK, t.m0, bar);
        if (WK) {
          hp::tma_load_2d(ws, tw, kt * BK, t.n0, bar);
        } else {
#pragma unroll
          for (int p = 0; p < BN / 64; ++p)
            hp::tma_load_2d(ws + p * (BK * 128), tw, t.n0 + 64 * p, kt * BK, bar);
        }
        if (t.a_tma) hp::tma_load_3d(as, ta, kt * BK, 0, t.group, bar);
      }
    } else if (!t.a_tma && pt >= 128 - LOADERS) {
      // A by hand: 8 consecutive ranks of one k as one 16-byte load, each
      // to its row of the swizzled K-major tile; zeros past r and K
      const int lt = pt - (128 - LOADERS);
      constexpr int VECS = (RP / 8) * BK;
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) hp::mbar_wait(empty0 + 8 * s, ((kt / STAGES) - 1) & 1);
        unsigned char* as = smem_raw + (base - hp::smem_u32(smem_raw)) + s * C::STAGE +
                            C::X_BYTES + C::W_BYTES;
        for (int v = lt; v < VECS; v += LOADERS) {
          const int j0 = (v / BK) * 8, kk = v % BK, gk = kt * BK + kk;
          uint4 q = make_uint4(0, 0, 0, 0);
          if (j0 < t.r && gk < t.K)
            q = *reinterpret_cast<const uint4*>(t.a + j0 * t.saj + (long long)gk * t.sak);
          const half_t* h = reinterpret_cast<const half_t*>(&q);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            *reinterpret_cast<half_t*>(as + swz(j0 + e, kk)) = h[e];
        }
        // the stores reach the async proxy (wgmma) before the arrival
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        hp::mbar_arrive(full0 + 8 * s);
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int c = tid >> 7;                       // this warpgroup's 64 rows
    const int warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;

    float acc[BN / 2];
    float xacc[RP / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < RP / 2; ++i) xacc[i] = 0.f;

    // B^T for the epilogue, fetched now so that its latency hides behind
    // the K sweep: bf16 pairs (j, j + 1) of row n, zero past r and N
    constexpr int PAIRS = BN * RP / 2 / CONSUMERS;
    uint32_t bq[PAIRS];
#pragma unroll
    for (int i = 0; i < PAIRS; ++i) {
      const int q = tid + i * CONSUMERS, n = q / (RP / 2), j = 2 * (q % (RP / 2));
      const int gn = t.n0 + n;
      const half_t* bp = t.b + (long long)gn * t.sbn + (long long)j * t.sbj;
      const uint32_t lo = (gn < t.N && j < t.r) ? bp[0] : 0;
      const uint32_t hi = (gn < t.N && j + 1 < t.r) ? bp[t.sbj] : 0;
      bq[i] = lo | (hi << 16);
    }

    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % STAGES;
      hp::mbar_wait(full0 + 8 * s, (kt / STAGES) & 1);
      const uint32_t xs = base + s * C::STAGE + c * 64 * 128, ws = base + s * C::STAGE + C::X_BYTES,
                     as = ws + C::W_BYTES;
      hp::reg_fence(acc);
      hp::reg_fence(xacc);
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t dx = hp::make_desc(xs + kk * 32, 16, 1024, 1);
        // K-major W^T: the k16 slice is 32 bytes along each row; N-major W:
        // 16 rows of every 64-column panel, panels BK * 128 bytes apart
        const uint64_t dw = WK ? hp::make_desc(ws + kk * 32, 16, 1024, 1)
                               : hp::make_desc(ws + kk * 16 * 128, BK * 128, 1024, 1);
        hp::WgmmaSS<BN, WK ? 0 : 1>::run(acc, dx, dw, 1);
        hp::WgmmaSS<RP, 0>::run(xacc, dx, hp::make_desc(as + kk * 32, 16, 1024, 1), 1);
      }
      hp::wgmma_commit();
      // the previous stage's products are done: hand its stage back
      hp::wgmma_wait<1>();
      hp::reg_fence(acc);
      hp::reg_fence(xacc);
      if (kt > 0) hp::mbar_arrive(empty0 + 8 * ((kt - 1) % STAGES));
    }
    hp::wgmma_wait<0>();
    hp::reg_fence(acc);
    hp::reg_fence(xacc);

    // epilogue: once both warpgroups are done with the ring it holds B^T,
    // K-major (row n of BN, its ranks along the row) and 128-byte swizzled
    // like the tiles TMA writes
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
    unsigned char* bsm = smem_raw + (base - hp::smem_u32(smem_raw));
#pragma unroll
    for (int i = 0; i < PAIRS; ++i) {
      const int q = tid + i * CONSUMERS;
      *reinterpret_cast<uint32_t*>(bsm + swz(q / (RP / 2), 2 * (q % (RP / 2)))) = bq[i];
    }
    // the stores reach the async proxy before either warpgroup's products
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");

    // acc += (scale * x @ A^T) @ B^T on the tensor cores: scale * x @ A^T
    // (f32, in the accumulator layout that is the A-fragment layout) split
    // into three bf16 terms, v = hi + mid + lo to about 2^-26 of v, each k16
    // slice of ranks three products with A from registers
    uint32_t af[RP / 16][3][4];
#pragma unroll
    for (int kk = 0; kk < RP / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float2 v = make_float2(t.scale * xacc[8 * kk + 2 * e], t.scale * xacc[8 * kk + 2 * e + 1]);
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          const __nv_bfloat162 part = __floats2bfloat162_rn(v.x, v.y);
          const float2 pf = __bfloat1622float2(part);
          af[kk][p][e] = *reinterpret_cast<const uint32_t*>(&part);
          v = make_float2(v.x - pf.x, v.y - pf.y);      // exact in f32
        }
      }
    hp::reg_fence(acc);
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < RP / 16; ++kk) {
      const uint64_t db = hp::make_desc(hp::smem_u32(bsm) + kk * 32, 16, 1024, 1);
#pragma unroll
      for (int p = 0; p < 3; ++p) hp::WgmmaRS<BN, 0>::run(acc, af[kk][p], db);
    }
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::reg_fence(acc);

    const int row0 = c * 64 + warp * 16 + g;      // this thread's rows: row0, row0 + 8
    const bool pairs = (t.N % 2) == 0;   // y's column pairs are 4-byte aligned
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= t.rows) continue;
      half_t* dst = t.y + (size_t)(t.m0 + row) * t.N;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int gn = t.n0 + 8 * j + 2 * t4;
        const half_t v0 = narrow(acc[4 * j + 2 * h]), v1 = narrow(acc[4 * j + 2 * h + 1]);
        if (pairs && gn + 1 < t.N) {
          *reinterpret_cast<uint32_t*>(dst + gn) = uint32_t(v0) | (uint32_t(v1) << 16);
        } else {
          if (gn < t.N) dst[gn] = v0;
          if (gn + 1 < t.N) dst[gn + 1] = v1;
        }
      }
    }
  }
}

// ----------------------------------------------------------------- host

// how the tile loads A (r, K) or each A_g (group stride sag): 0 by TMA
// (K-contiguous), 1 by the producer's 16-byte loads along r (the
// backward's B^T view), -1 neither (the caller takes the mma.sync tile)
inline int a_mode(const void* a, int r, long long saj, long long sak, long long sag) {
  if (r < 1 || reinterpret_cast<uintptr_t>(a) % 16 != 0 || sag % 8 != 0) return -1;
  if (sak == 1 && saj % 8 == 0) return 0;
  if (saj == 1 && sak % 8 == 0 && r % 8 == 0) return 1;
  return -1;
}

// whether the tile takes these operands: x (., K) and W by TMA (16-byte
// aligned bases, K and W's stride multiples of 8 elements) and A by either
// mode.  The Python wrappers' tma_ok is the same test.
inline bool wgmma_ok(const void* x, const void* w, const void* a, int K, int r,
                     long long sx, long long sw, long long saj, long long sak, long long sag) {
  return K > 0 && K % 8 == 0 && sx % 8 == 0 && sw % 8 == 0 &&
         reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
         a_mode(a, r, saj, sak, sag) >= 0;
}

// a bf16 tensor map of rank 2 or 3, dims[0] contiguous, strides in
// elements for dims 1.., 128-byte swizzle, zeros outside the tensor
inline bool encode(CUtensorMap* map, const void* ptr, int rank, const long long* dims,
                   const long long* strides, const int* box) {
  hp::EncodeTiled fn = hp::encoder();
  if (!fn) return false;
  cuuint64_t d[3], st[2];
  cuuint32_t bx[3], el[3] = {1, 1, 1};
  for (int i = 0; i < rank; ++i) {
    d[i] = (cuuint64_t)dims[i];
    bx[i] = (cuuint32_t)box[i];
    // a dimension of extent 1 is never stepped over: give it a legal stride
    if (i > 0) st[i - 1] = (cuuint64_t)(2 * (dims[i] > 1 ? strides[i - 1] : 8));
  }
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), d, st, bx, el,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The maps of one call: x (M, K) row stride sx; W (K, N) N-contiguous (row
// stride sw) or K-contiguous (column stride sw); A_g (r, K) by (saj, sak)
// and group stride sag over G groups, mapped only in mode 0 (ta is then
// zeroed and unread).
struct Maps {
  CUtensorMap tx, tw, ta;
};

inline bool encode_maps(Maps* m, const void* x, const void* w, const void* a, int M, int N,
                        int K, int r, int G, long long sx, long long sw, bool w_kmajor,
                        long long saj, long long sag, int bn, int rp, bool a_tma) {
  const long long xd[2] = {K, M}, xs[1] = {sx};
  const int xb[2] = {BK, BM};
  if (!encode(&m->tx, x, 2, xd, xs, xb)) return false;
  if (w_kmajor) {
    const long long wd[2] = {K, N}, ws[1] = {sw};
    const int wb[2] = {BK, bn};
    if (!encode(&m->tw, w, 2, wd, ws, wb)) return false;
  } else {
    const long long wd[2] = {N, K}, ws[1] = {sw};
    const int wb[2] = {64, BK};
    if (!encode(&m->tw, w, 2, wd, ws, wb)) return false;
  }
  memset(&m->ta, 0, sizeof(m->ta));
  if (a_tma) {
    const long long ad[3] = {K, r, G}, as[2] = {saj, sag};
    const int ab[3] = {BK, rp, 1};
    if (!encode(&m->ta, a, 3, ad, as, ab)) return false;
  }
  return true;
}

// the widest tile whose grid covers 7/8 of the SMs, else the narrowest
inline int tile_width(int N, long long row_tiles) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  for (int bn : WIDTHS)
    if (8 * (long long)((N + bn - 1) / bn) * row_tiles >= 7LL * sms) return bn;
  return WIDTHS[2];
}

inline int rank_tile(int r) { return r <= 16 ? 16 : r <= 32 ? 32 : 64; }

}  // namespace wg

}  // namespace
