// One 128 x 96 tile of the fused base + LoRA product on Hopper's tensor
// cores, fp32 through 3xTF32:
//
//     y[m0 : m0+rows, n0 : n0+96] = x @ W + scale * (x @ A^T) @ B^T
//
// The shared body of lora_matmul.cu (one adapter, tiles in a grid) and of
// grouped_lora.cu's fp32 modes (one adapter per group, tiles from a table:
// chunk, and direct with the whole K slab staged at once), so the kernels
// cannot drift apart.  Each .cu includes this header and
// is built on its own; build.py hashes the header with each source.
//
// Operands.  x (rows, K) with row stride sx; W (K, N) either N-contiguous
// (the forward's W, row stride sw) or K-contiguous (the backward's W^T view
// of a contiguous (N, K) tensor, column stride sw), chosen by the template
// flag WK; A (r, K) and B (N, r) by any strides (the backward passes the
// transposed views B^T and A^T); y (., N) contiguous; r <= 64.
//
// Numerics.  TF32 is off on the main path, so each operand v is split into
// big = tf32(v) and small = tf32(v - big), about 22 significant bits in all
// (fp32 has 24), and small*big + big*small + big*big are taken with
// mma.sync m16n8k8 TF32 (CUTLASS's "fast accurate fp32"; the dropped
// small*small term is below 2**-22 of a product).  The three products of
// each k8 slice are summed by the tensor core from zero and then added to
// the f32 accumulator with round-to-nearest (mma_3xtf32): the tensor core's
// own accumulation, fed the accumulator across the whole K sweep, lost far
// more than the split does (PERF.md).  mma.sync and not wgmma: TF32 wgmma
// takes both operands K-major from shared memory, and the forward's W is
// N-major.
//
// Tile.  A block of 256 threads (8 warps, 4 along M x 2 along N) owns a
// 128 x 96 tile of y.  Each warp computes 32 x 48 of x @ W (2 x 6 m16n8
// tiles) and 32 rows of half of the RP rank columns of x @ A^T, so A's rows
// are RP extra B-operand columns of every W stage and x is read once for
// both products.  K goes in steps of 32 through a 4-stage cp.async ring
// (x, W and A tiles), so three stages of loads are in flight while one is
// multiplied.  Shared tiles are padded so every fragment read is free of
// bank conflicts: rows of 36 floats for the K-contiguous tiles (x, A, the
// backward's W), rows of 104 for the N-contiguous W.  Copies are 16 bytes
// where x and W are 16-byte aligned with row lengths and strides a multiple
// of 4 floats; otherwise (N 130, K 770, ...) every element is a 4-byte
// copy, so no copy reads past the end of a row.  Ragged M, N and K edges
// are zero-filled by the copies (src-size 0) and masked in the stores; the
// caller pads nothing.  A is always copied element by element (r x 32
// floats a stage).  The epilogue stores the block's (128, RP) slice of
// x @ A^T and B's rows for the tile in shared memory and adds
// scale * (x @ A^T) @ B^T in fp32 FMAs.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

namespace tc {

constexpr int BM = 128;         // rows of y per block
constexpr int BN = 96;          // columns of y per block
constexpr int BK = 32;          // depth of one K step
constexpr int STAGES = 4;       // cp.async ring depth
constexpr int THREADS = 256;
constexpr int WARPS_N = 2;
constexpr int WM = 32;          // rows per warp
constexpr int WN = BN / WARPS_N;   // 48 columns per warp
constexpr int MT = WM / 16;     // m16 tiles per warp
constexpr int NT = WN / 8;      // n8 tiles per warp
constexpr int KSTR = BK + 4;    // row pitch of K-contiguous tiles (floats)
constexpr int NSTR = BN + 8;    // row pitch of the N-contiguous W tile
constexpr int MAX_RANK = 64;

template <int RP, bool WK> struct Smem {
  static constexpr int X = BM * KSTR;
  static constexpr int W = WK ? BN * KSTR : BK * NSTR;
  static constexpr int A = RP * KSTR;
  static constexpr int STAGE = X + W + A;                     // floats
  static constexpr int EPI = BM * (RP + 1) + RP * (BN + 2);   // xa, B^T
  static constexpr size_t BYTES =
      4 * (size_t)(STAGES * STAGE > EPI ? STAGES * STAGE : EPI);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async with zero fill: ``ok`` false copies no byte and writes zeros
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four consecutive floats of a row: one 16-byte copy when aligned, else
// four 4-byte copies each masked on its own
__device__ __forceinline__ void cp_chunk(float* dst, const float* base, long long off,
                                         bool row_ok, int c, int lim, bool vec) {
  if (vec) {
    const bool ok = row_ok && c < lim;
    cp16(dst, ok ? base + off : base, ok);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok = row_ok && c + e < lim;
      cp4(dst + e, ok ? base + off + e : base, ok);
    }
  }
}

// v rounded to TF32's 10 mantissa bits, ties away from zero as
// cvt.rna.tf32.f32 rounds, by two integer operations (CUTLASS's
// round_half_ulp_truncate) in place of the conversion instruction: a warp
// splits 22 values for every 42 products of a k8 step
__device__ __forceinline__ uint32_t round_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  big = round_tf32(v);
  small = round_tf32(v - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b from ~22-bit operands: small*big + big*small + big*big of one
// k8 slice go through the tensor core into a zeroed t, and t is added to d
// in f32 with round-to-nearest.  The tensor core's f32 accumulation does
// not round to nearest when it aligns its addends: fed d itself across the
// whole K sweep (288 mma steps at K 768) it lost about 20x the plain fp32
// product's accuracy, over the three products of one slice little (PERF.md).
// The adds cost about 9 % of the kernel's time.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4], float b0, float b1) {
  uint32_t bb0, bs0, bb1, bs1;
  split_tf32(b0, bb0, bs0);
  split_tf32(b1, bb1, bs1);
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(t, as, bb0, bb1);
  mma_tf32(t, ab, bs0, bs1);
  mma_tf32(t, ab, bb0, bb1);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += t[e];
}

// One block's tile: rows [m0, m0 + rows) of x and y (rows <= BM), columns
// [n0, n0 + BN) of y.  ``sm`` is the block's dynamic shared memory,
// Smem<RP, WK>::BYTES.  RP: the rank rounded up to 16, 32 or 64.  WK: W is
// K-contiguous.  vec: 16-byte copies of x and W (see the note above).
// WHOLE (grouped_lora.cu's direct mode, K <= STAGES * BK): the whole K slab
// is copied in one step and waited for once, and no stage is recycled.
template <int RP, bool WK, bool WHOLE = false>
__device__ __forceinline__ void lora_tile(
    float* __restrict__ sm, const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ y,
    int m0, int rows, int n0, int N, int K, int r, float scale, long long sx,
    long long sw, long long saj, long long sak, long long sbn, long long sbj, bool vec) {
  using L = Smem<RP, WK>;
  constexpr int XT = RP / 16;     // n8 tiles of x @ A^T per warp (half of RP)

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;

  auto load = [&](int stage, int kt) {
    float* xs = sm + stage * L::STAGE;
    float* ws = xs + L::X;
    float* as = ws + L::W;
    const int k0 = kt * BK;
    for (int c = tid; c < BM * (BK / 4); c += THREADS) {
      const int row = c / (BK / 4), kc = (c % (BK / 4)) * 4;
      cp_chunk(xs + row * KSTR + kc, x, (long long)(m0 + row) * sx + k0 + kc, row < rows,
               k0 + kc, K, vec);
    }
    if (WK) {
      for (int c = tid; c < BN * (BK / 4); c += THREADS) {
        const int nn = c / (BK / 4), kc = (c % (BK / 4)) * 4;
        const int gn = n0 + nn;
        cp_chunk(ws + nn * KSTR + kc, w, (long long)gn * sw + k0 + kc, gn < N, k0 + kc, K,
                 vec);
      }
    } else {
      for (int c = tid; c < BK * (BN / 4); c += THREADS) {
        const int kk = c / (BN / 4), nc = (c % (BN / 4)) * 4;
        const int gk = k0 + kk;
        cp_chunk(ws + kk * NSTR + nc, w, (long long)gk * sw + n0 + nc, gk < K, n0 + nc, N,
                 vec);
      }
    }
    for (int e = tid; e < RP * BK; e += THREADS) {
      const int j = e / BK, kk = e % BK;
      const int gk = k0 + kk;
      const bool ok = j < r && gk < K;
      cp4(as + j * KSTR + kk, ok ? a + j * saj + gk * sak : a, ok);
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
  if (WHOLE) {
    for (int s = 0; s < nk; ++s) load(s, s);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
  } else {
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nk) load(s, s);
      cp_commit();
    }
  }

  for (int kt = 0; kt < nk; ++kt) {
    if (!WHOLE) {
      cp_wait<STAGES - 2>();   // tile kt has landed
      __syncthreads();         // and every warp is done with tile kt - 1
      const int nxt = kt + STAGES - 1;
      if (nxt < nk) load(nxt % STAGES, nxt);
      cp_commit();
    }

    const float* xs = sm + (kt % STAGES) * L::STAGE;
    const float* ws = xs + L::X;
    const float* as = ws + L::W;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 8) {
      uint32_t ab[MT][4], asm_[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float* xr = xs + (wm * WM + i * 16 + g) * KSTR + ks + t4;
        split_tf32(xr[0], ab[i][0], asm_[i][0]);
        split_tf32(xr[8 * KSTR], ab[i][1], asm_[i][1]);
        split_tf32(xr[4], ab[i][2], asm_[i][2]);
        split_tf32(xr[8 * KSTR + 4], ab[i][3], asm_[i][3]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = wn * WN + j * 8 + g;
        const float b0 = WK ? ws[col * KSTR + ks + t4] : ws[(ks + t4) * NSTR + col];
        const float b1 = WK ? ws[col * KSTR + ks + t4 + 4] : ws[(ks + t4 + 4) * NSTR + col];
#pragma unroll
        for (int i = 0; i < MT; ++i) mma_3xtf32(acc[i][j], ab[i], asm_[i], b0, b1);
      }
#pragma unroll
      for (int j = 0; j < XT; ++j) {
        const float* ar = as + (wn * (RP / 2) + j * 8 + g) * KSTR + ks + t4;
        const float b0 = ar[0], b1 = ar[4];
#pragma unroll
        for (int i = 0; i < MT; ++i) mma_3xtf32(xacc[i][j], ab[i], asm_[i], b0, b1);
      }
    }
  }
  cp_wait<0>();
  __syncthreads();           // the ring is free for the epilogue

  // epilogue: y = acc + scale * (x @ A^T) @ B^T over the tile
  float* xas = sm;                       // xas[row][j], pitch RP + 1
  float* bs = sm + BM * (RP + 1);        // bs[j][n],   pitch BN + 2
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < XT; ++j) {
      const int row = wm * WM + i * 16 + g;
      const int col = wn * (RP / 2) + j * 8 + 2 * t4;
      xas[row * (RP + 1) + col] = xacc[i][j][0];
      xas[row * (RP + 1) + col + 1] = xacc[i][j][1];
      xas[(row + 8) * (RP + 1) + col] = xacc[i][j][2];
      xas[(row + 8) * (RP + 1) + col + 1] = xacc[i][j][3];
    }
  for (int e = tid; e < RP * BN; e += THREADS) {
    const int j = e / BN, nn = e % BN;
    const int gn = n0 + nn;
    bs[j * (BN + 2) + nn] = (gn < N && j < r) ? b[gn * sbn + j * sbj] : 0.f;
  }
  __syncthreads();

  float up[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) up[i][j][e] = 0.f;
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
        up[i][j][0] = fmaf(xv[i][0], bv[j][0], up[i][j][0]);
        up[i][j][1] = fmaf(xv[i][0], bv[j][1], up[i][j][1]);
        up[i][j][2] = fmaf(xv[i][1], bv[j][0], up[i][j][2]);
        up[i][j][3] = fmaf(xv[i][1], bv[j][1], up[i][j][3]);
      }
  }

#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = wm * WM + i * 16 + g + (e >> 1) * 8;
        const int gn = n0 + wn * WN + j * 8 + 2 * t4 + (e & 1);
        if (row < rows && gn < N)
          y[(size_t)(m0 + row) * N + gn] = acc[i][j][e] + scale * up[i][j][e];
      }
}

// 16-byte copies of x and W only where every chunk of 4 floats is aligned
// and lies wholly inside or wholly outside its row
inline bool vec_copies(const float* x, const float* w, long long sx, long long sw, int N,
                       int K) {
  return (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
         (reinterpret_cast<uintptr_t>(w) % 16 == 0) && sx % 4 == 0 && sw % 4 == 0 &&
         K % 4 == 0 && N % 4 == 0;
}

}  // namespace tc

}  // namespace
