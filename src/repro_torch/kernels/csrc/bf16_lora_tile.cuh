// One 128 x 128 tile of the fused base + LoRA product on Hopper's bf16
// tensor cores:
//
//     y[m0 : m0+rows, n0 : n0+128] = bf16( x @ W + scale * (x @ A^T) @ B^T )
//
// The shared bf16 body of lora_matmul.cu (one adapter, tiles in a grid) and
// of grouped_lora.cu's chunk mode (one adapter per group, tiles from a
// table), beside the fp32 body in tf32_lora_tile.cuh.  Each .cu includes
// both headers and is built on its own; build.py hashes the headers with
// each source.
//
// Operands.  All bf16, read as raw 16-bit words.  x (rows, K) with row
// stride sx; W (K, N) either N-contiguous (the forward's W, row stride sw)
// or K-contiguous (the backward's W^T view of a contiguous (N, K) tensor,
// column stride sw), chosen by the template flag WK; A (r, K) and B (N, r)
// by any strides (the backward passes the transposed views B^T and A^T);
// y (., N) contiguous, bf16; r <= 64.
//
// Numerics.  bf16 products are exact in f32, so x @ W and x @ A^T go
// straight to mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 with f32
// accumulators and no operand split.  The rank-r intermediate x @ A^T stays
// in f32 (as the reference's VMEM scratch does): the epilogue stores it,
// times scale, in shared memory and adds (scale * x @ A^T) @ B^T into the
// accumulators with f32 FMAs against B widened to f32, so the adapter term
// carries no bf16 rounding of the intermediate.  At r 16 the FMAs are RP / (2K) of the main products (under
// 1 % at K 2048).  One rounding to bf16 at the end (__float2bfloat16_rn),
// as the plain version rounds its f32 result.
//
// Tile.  A block of 256 threads (8 warps, 4 along M x 2 along N) owns a
// 128 x 128 tile of y.  Each warp computes 32 x 64 of x @ W (2 x 8 m16n8
// tiles) and 32 rows of half of the RP rank columns of x @ A^T, so A's rows
// ride as extra B-operand columns of every stage and x is read once for
// both products.  K goes in steps of 32 through a 4-stage ring (x, W and A
// tiles).  Fragments come from shared memory by ldmatrix: x and the
// K-contiguous tiles (A, the backward's W) with ldmatrix, the forward's
// N-contiguous W with ldmatrix.trans, so either major-ness of W feeds the
// same mma.  Rows are padded (40 halves for K-contiguous tiles, 136 for the
// N-contiguous W) so the eight 16-byte rows of every ldmatrix land on
// distinct banks.
//
// Copies.  x and W go by 16-byte cp.async (8 halves) where both pointers
// are 16-byte aligned and K, N and both strides are multiples of 8, so no
// chunk straddles a row's end; otherwise (K 130, N 300, ...) every element
// is loaded on its own and stored to shared memory, zero past the edge.
// A is always loaded element by element (RP x 32 halves a stage), since the
// backward's A^T view has a K stride of r: into registers one iteration
// ahead of its store to shared memory, so the loads' latency hides behind
// a K step's products.  Ragged M, N and K edges are zero-filled and masked
// in the stores; the caller pads nothing.  Ranks below 16 run one k16 step
// of zero-filled rank columns.  y goes out two halves (one 32-bit store) at
// a time where N is even.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

namespace bc {

constexpr int BM = 128;         // rows of y per block
constexpr int BN = 128;         // columns of y per block
constexpr int BK = 32;          // depth of one K step (two k16 mma steps)
constexpr int STAGES = 4;       // ring depth
constexpr int THREADS = 256;
constexpr int WARPS_N = 2;
constexpr int WM = 32;          // rows per warp
constexpr int WN = BN / WARPS_N;   // 64 columns per warp
constexpr int MT = WM / 16;     // m16 tiles per warp
constexpr int NT = WN / 8;      // n8 tiles per warp
constexpr int KSTR = BK + 8;    // row pitch of K-contiguous tiles (halves, 80 bytes)
constexpr int NSTR = BN + 8;    // row pitch of the N-contiguous W tile (272 bytes)
constexpr int MAX_RANK = 64;

// blocks a multiprocessor holds at once, which caps registers at
// 65536 / (THREADS * blocks): two blocks (128 registers) up to RP 32, one at
// RP 64, where 128 registers spill.  Measured on the H100 at gemma-2b's
// q-projection: two blocks ran 1.5x faster than one at r 16, and 1.4x
// slower at r 64 (PERF.md)
template <int RP> constexpr int min_blocks() { return RP <= 32 ? 2 : 1; }

typedef uint16_t half_t;        // a bf16 as its raw bits

template <int RP, bool WK> struct Smem {
  static constexpr int X = BM * KSTR;                         // halves
  static constexpr int W = WK ? BN * KSTR : BK * NSTR;
  static constexpr int A = RP * KSTR;
  static constexpr int STAGE = X + W + A;
  static constexpr size_t RING = 2 * (size_t)STAGES * STAGE;  // bytes
  static constexpr size_t EPI = 4 * ((size_t)BM * (RP + 1) + (size_t)RP * (BN + 2));
  static constexpr size_t BYTES = RING > EPI ? RING : EPI;
};

__device__ __forceinline__ float widen(half_t h) {
  return __uint_as_float(static_cast<uint32_t>(h) << 16);
}

__device__ __forceinline__ half_t narrow(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16 bytes with zero fill: ``ok`` false copies no byte and
// writes zeros
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// eight consecutive halves of a row from ``base + off``: one 16-byte copy
// when aligned, else eight loads each masked on its own (c: the column of
// the first, lim: the row's length)
__device__ __forceinline__ void cp_chunk(half_t* dst, const half_t* base, long long off,
                                         bool row_ok, int c, int lim, bool vec) {
  if (vec) {
    const bool ok = row_ok && c < lim;
    cp16(dst, ok ? base + off : base, ok);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) dst[e] = (row_ok && c + e < lim) ? base[off + e] : half_t(0);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const half_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const half_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1, const half_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One block's tile: rows [m0, m0 + rows) of x and y (rows <= BM), columns
// [n0, n0 + BN) of y.  ``sm`` is the block's dynamic shared memory,
// Smem<RP, WK>::BYTES.  RP: the rank rounded up to 16, 32 or 64.  WK: W is
// K-contiguous.  vec: 16-byte copies of x and W (see the note above).
template <int RP, bool WK>
__device__ __forceinline__ void lora_tile(
    unsigned char* __restrict__ sm, const half_t* __restrict__ x,
    const half_t* __restrict__ w, const half_t* __restrict__ a,
    const half_t* __restrict__ b, half_t* __restrict__ y, int m0, int rows, int n0, int N,
    int K, int r, float scale, long long sx, long long sw, long long saj, long long sak,
    long long sbn, long long sbj, bool vec) {
  using L = Smem<RP, WK>;
  constexpr int XT = RP / 16;     // n8 tiles of x @ A^T per warp (half of RP)
  constexpr int AQ = RP * BK / THREADS;   // A elements per thread a stage
  half_t* ring = reinterpret_cast<half_t*>(sm);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;

  // x and W of one K step into a stage, by cp.async
  auto load = [&](int stage, int kt) {
    half_t* xs = ring + stage * L::STAGE;
    half_t* ws = xs + L::X;
    half_t* as = ws + L::W;
    const int k0 = kt * BK;
    for (int c = tid; c < BM * (BK / 8); c += THREADS) {
      const int row = c / (BK / 8), kc = (c % (BK / 8)) * 8;
      cp_chunk(xs + row * KSTR + kc, x, (long long)(m0 + row) * sx + k0 + kc, row < rows,
               k0 + kc, K, vec);
    }
    if (WK) {
      for (int c = tid; c < BN * (BK / 8); c += THREADS) {
        const int nn = c / (BK / 8), kc = (c % (BK / 8)) * 8;
        const int gn = n0 + nn;
        cp_chunk(ws + nn * KSTR + kc, w, (long long)gn * sw + k0 + kc, gn < N, k0 + kc, K,
                 vec);
      }
    } else {
      for (int c = tid; c < BK * (BN / 8); c += THREADS) {
        const int kk = c / (BN / 8), nc = (c % (BN / 8)) * 8;
        const int gk = k0 + kk;
        cp_chunk(ws + kk * NSTR + nc, w, (long long)gk * sw + n0 + nc, gk < K, n0 + nc, N,
                 vec);
      }
    }
  };
  // A of one K step: into registers, then (an iteration later) to its stage
  half_t areg[AQ];
  auto a_fetch = [&](int kt) {
    const int k0 = kt * BK;
#pragma unroll
    for (int q = 0; q < AQ; ++q) {
      const int e = tid + q * THREADS;
      const int j = e / BK, gk = k0 + e % BK;
      areg[q] = (j < r && gk < K) ? a[j * saj + gk * sak] : half_t(0);
    }
  };
  auto a_store = [&](int stage) {
    half_t* as = ring + stage * L::STAGE + L::X + L::W;
#pragma unroll
    for (int q = 0; q < AQ; ++q) {
      const int e = tid + q * THREADS;
      as[(e / BK) * KSTR + e % BK] = areg[q];
    }
  };

  float acc[MT][NT][4];
  float xacc[MT][XT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
#pragma unroll
    for (int j = 0; j < XT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) xacc[i][j][e] = 0.f;
  }

  const int nk = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) {
      load(s, s);
      a_fetch(s);
      a_store(s);
    }
    cp_commit();
  }

  // ldmatrix row addresses, per lane: the x tile's row and k offset; a
  // K-contiguous B tile's n row and k offset; the N-contiguous W tile's k
  // row and n offset (the transposed load)
  const int a_row = lane & 15, a_k = (lane >> 4) * 8;
  const int bk_n = (lane & 7) + (lane >> 4) * 8, bk_k = ((lane >> 3) & 1) * 8;
  const int bt_k = lane & 15, bt_n = (lane >> 4) * 8;
  const int x2_n = lane & 7, x2_k = ((lane >> 3) & 1) * 8;

  int a_pending = -1;        // the stage whose A waits in registers
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<STAGES - 2>();   // tile kt has landed
    __syncthreads();         // and every warp is done with tile kt - 1
    // A of tile kt + STAGES - 2, fetched last iteration; its stage was last
    // read for tile kt - 2, and it is read for its own tile two barriers on
    if (a_pending >= 0) a_store(a_pending);
    const int nxt = kt + STAGES - 1;
    a_pending = -1;
    if (nxt < nk) {
      load(nxt % STAGES, nxt);
      a_fetch(nxt);
      a_pending = nxt % STAGES;
    }
    cp_commit();

    const half_t* xs = ring + (kt % STAGES) * L::STAGE;
    const half_t* ws = xs + L::X;
    const half_t* as = ws + L::W;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldsm_x4(af[i], xs + (wm * WM + i * 16 + a_row) * KSTR + ks + a_k);
#pragma unroll
      for (int jj = 0; jj < NT / 2; ++jj) {
        uint32_t bf[4];
        const int nb = wn * WN + jj * 16;
        if (WK)
          ldsm_x4(bf, ws + (nb + bk_n) * KSTR + ks + bk_k);
        else
          ldsm_x4_t(bf, ws + (ks + bt_k) * NSTR + nb + bt_n);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_bf16(acc[i][2 * jj], af[i], bf[0], bf[1]);
          mma_bf16(acc[i][2 * jj + 1], af[i], bf[2], bf[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < XT; ++j) {
        uint32_t b0, b1;
        ldsm_x2(b0, b1, as + (wn * (RP / 2) + j * 8 + x2_n) * KSTR + ks + x2_k);
#pragma unroll
        for (int i = 0; i < MT; ++i) mma_bf16(xacc[i][j], af[i], b0, b1);
      }
    }
  }
  cp_wait<0>();
  __syncthreads();           // the ring is free for the epilogue

  // epilogue: y = acc + (scale * x @ A^T) @ B^T over the tile, in f32,
  // summed into the accumulators (no second tile of registers)
  float* xas = reinterpret_cast<float*>(sm);   // xas[row][j], pitch RP + 1
  float* bs = xas + BM * (RP + 1);             // bs[j][n],   pitch BN + 2
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < XT; ++j) {
      const int row = wm * WM + i * 16 + g;
      const int col = wn * (RP / 2) + j * 8 + 2 * t4;
      xas[row * (RP + 1) + col] = scale * xacc[i][j][0];
      xas[row * (RP + 1) + col + 1] = scale * xacc[i][j][1];
      xas[(row + 8) * (RP + 1) + col] = scale * xacc[i][j][2];
      xas[(row + 8) * (RP + 1) + col + 1] = scale * xacc[i][j][3];
    }
  for (int e = tid; e < RP * BN; e += THREADS) {
    const int j = e / BN, nn = e % BN;
    const int gn = n0 + nn;
    bs[j * (BN + 2) + nn] = (gn < N && j < r) ? widen(b[gn * sbn + j * sbj]) : 0.f;
  }
  __syncthreads();

#pragma unroll 4
  for (int jr = 0; jr < RP; ++jr) {
    float xv[MT][2], bv[NT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int row = wm * WM + i * 16 + g;
      xv[i][0] = xas[row * (RP + 1) + jr];
      xv[i][1] = xas[(row + 8) * (RP + 1) + jr];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = wn * WN + j * 8 + 2 * t4;
      bv[j][0] = bs[jr * (BN + 2) + col];
      bv[j][1] = bs[jr * (BN + 2) + col + 1];
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        acc[i][j][0] = fmaf(xv[i][0], bv[j][0], acc[i][j][0]);
        acc[i][j][1] = fmaf(xv[i][0], bv[j][1], acc[i][j][1]);
        acc[i][j][2] = fmaf(xv[i][1], bv[j][0], acc[i][j][2]);
        acc[i][j][3] = fmaf(xv[i][1], bv[j][1], acc[i][j][3]);
      }
  }

  const bool pairs = (N % 2) == 0;   // y's column pairs are 4-byte aligned
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wm * WM + i * 16 + g + h * 8;
        const int gn = n0 + wn * WN + j * 8 + 2 * t4;
        if (row >= rows) continue;
        const half_t v0 = narrow(acc[i][j][2 * h]);
        const half_t v1 = narrow(acc[i][j][2 * h + 1]);
        half_t* dst = y + (size_t)(m0 + row) * N + gn;
        if (pairs && gn + 1 < N) {
          *reinterpret_cast<uint32_t*>(dst) = uint32_t(v0) | (uint32_t(v1) << 16);
        } else {
          if (gn < N) dst[0] = v0;
          if (gn + 1 < N) dst[1] = v1;
        }
      }
}

// 16-byte copies of x and W only where every chunk of 8 halves is aligned
// and lies wholly inside or wholly outside its row
inline bool vec_copies(const void* x, const void* w, long long sx, long long sw, int N,
                       int K) {
  return (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
         (reinterpret_cast<uintptr_t>(w) % 16 == 0) && sx % 8 == 0 && sw % 8 == 0 &&
         K % 8 == 0 && N % 8 == 0;
}

}  // namespace bc

}  // namespace
