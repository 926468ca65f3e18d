// Online-softmax (flash) attention forward for Hopper (sm_90a):
//
//     out[b, s, h] = softmax_t(q[b, s, h] . k[b, t, h / G] * scale + mask) . v[b, t, h / G]
//
// q (B, S, H, D) and k, v (B, T, K, D) in the model's layout, read through
// their strides (the last dimension contiguous); G = H / K query heads
// share one key/value head (GQA, MQA at K = 1).  out (B, S, H, D),
// contiguous, in the input type.  Float32 or bfloat16; D in {32, 64, 112, 128, 256}.
//
// Replaces src/repro/kernels/flash_attention.py:flash_attention (the Pallas
// TPU kernel, body _kernel), which the port's attention_full(impl="chunked")
// runs on the prefill of the attention families (zamba2's shared block at
// D = 112, whisper's non-causal encoder included).  Both paths below keep its
// numerics:
//   * scores q.k in f32 times scale; masked scores are NEG_INF = -1e30 (not
//     -inf), masks: causal (q_pos >= k_pos), window (q_pos - k_pos < window)
//     and keys past T;
//   * f32 running max m, normalizer l and accumulator; per key tile
//     m_new = max(m, rowmax), p = exp(s - m_new), corr = exp(m - m_new),
//     l = l * corr + rowsum(p) (p in f32), acc = acc * corr + p . v with p
//     rounded to the value type first (bfloat16 inputs: bf16 p);
//   * out = acc / max(l, 1e-30), rounded to the input type.
// Each block visits only the key tiles that some row of its query tile can
// see.  A tile whose keys are all masked before the first visible key of a
// row adds p = 1 entries that the next visible tile's corr =
// exp(-1e30 - m) = 0 wipes exactly, as in the Pallas body; keys past a
// ragged T are not padded but skipped (p = 0).  A row that sees no key at
// all (window, q >= T - 1 + window) averages every key, as the plain
// version does, so then the whole key range runs.  The blocks of the last
// query tiles, which have the most key tiles under a causal mask, go first.
//
// bfloat16: the tensor cores (flash_bf16_kernel).  One block of two
// consumer warpgroups (256 threads) owns 128 query rows of one
// (batch, head), 64 rows a warpgroup.  Per key tile of 64:
//   S = Q K^T   wgmma m64n64k16, Q and K both K-major in shared memory;
//   O += P V    wgmma m64nDk16, P from registers (the S accumulator
//               rounded to bf16 pairs: exactly the A fragment wgmma takes),
//               V from shared memory as a transposed (N-major) B operand.
// The O accumulator (D / 2 f32 registers a thread, 128 at D = 256), m and
// l stay in registers for the whole key loop.  The Q tile and a ring of two
// K/V stages come by TMA (cp.async.bulk.tensor, 4-D tensor maps over the
// model layout, so strides and GQA heads are read in place) into 128- or
// 64-byte-swizzled panels of 64 (or 32) columns, the layouts wgmma's
// descriptors name; each stage's arrival is an mbarrier transaction count.
// One thread issues the next tile's loads before the block multiplies the
// current one, so the copy overlaps both products and the softmax; every
// thread hands a stage back by arriving on its "empty" mbarrier, which the
// loading thread waits on, and no block-wide barrier keeps the two
// warpgroups in step.  TMA's zero fill
// covers the ragged S and T edges, which the masks then exclude.  Shared
// memory: 128 x D Q plus two stages of 64 x D K and V in bf16, 192 KB at
// D = 256.  D = 112 (zamba2's shared attention) runs as the D = 128 tile
// with its last 16 columns zero: the tensor maps' inner extent is 112, so
// the second 64-column panel's box overhangs the row and TMA fills the
// overhang with zeros (and still counts the whole box on the mbarrier);
// Q K^T takes the 7 k16 slices that hold data, P V runs m64n128k16 over
// the zero-padded V, and only the 112 real columns of O are stored.  q, k
// and v are read in place: nothing is padded into a copy.
//
// float32: the CUDA cores (flash_f32_kernel), kept as it was first written:
// one block of 256 threads (16 x 16) per (query tile of 64 rows,
// batch * query head), fp32 FMAs from shared memory, no TF32.  No model of
// the port runs fp32 attention, and this body already beats PyTorch's fp32
// scaled_dot_product_attention at the gemma-2b prefill shape (PERF.md).
//
// What bounds it.  At the gemma-2b prefill shape (B 4, S = T 2048, H 8,
// K 1, D 256, bf16, causal) the work is 6.87e10 flop and 75.5 MB of
// traffic: 0.069 ms at 989 TFLOP/s on the tensor cores, 0.023 ms at
// 3.35 TB/s; in fp32 1.03 ms at the CUDA cores' 67 TFLOP/s.  Times are in
// PERF.md.

#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 256;

// the key range [k_lo, k_hi) that some row in [q0, q1] can see
__device__ __forceinline__ void key_range(int q0, int q1, int Tn, int causal, int window,
                                          int& k_lo, int& k_hi) {
  k_lo = 0;
  k_hi = Tn;
  if (causal) k_hi = min(Tn, q1 + 1);
  if (window > 0) k_lo = max(0, q0 - window + 1);
  if (window > 0 && q1 >= Tn - 1 + window) {
    k_lo = 0;
    k_hi = Tn;
  }
}

__device__ __forceinline__ bool visible(int qi, int kj, int Tn, int causal, int window) {
  return kj < Tn && (!causal || qi >= kj) && (window <= 0 || qi - kj < window);
}

// ---------------------------------------------------------------- fp32 --

namespace f32 {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int PSTR = BK + 1;

// row stride of the Q and K tiles: D plus one word
template <int D> struct Tile {
  static constexpr int QSTR = D + 1;
  static constexpr size_t smem() {
    return (size_t)(BQ * QSTR + BK * QSTR + BK * D + BQ * PSTR) * 4;
  }
};

// Thread (ty, tx) owns rows ty + 16a (a < 4): scores for keys tx + 16b
// (b < 4), reduced across the 16 lanes of its half-warp with shuffles, and
// output columns tx + 16c.  K and Q rows are padded by one word so the
// score loop reads shared memory without bank conflicts.
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int S, int Tn, int H,
                 int KH, long long qsb, long long qss, long long qsh, long long ksb,
                 long long kst, long long ksh, long long vsb, long long vst, long long vsh,
                 int causal, int window, float scale) {
  constexpr int QSTR = Tile<D>::QSTR;
  constexpr int NC = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = qs + BQ * QSTR;
  float* vs = ks + BK * QSTR;
  float* ps = vs + BK * D;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int nq = (S + BQ - 1) / BQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * BQ;
  const int b = (int)blockIdx.y / H, h = (int)blockIdx.y % H;
  const int kh = h / (H / KH);
  const float* __restrict__ qb = q + b * qsb + h * qsh;
  const float* __restrict__ kb = k + b * ksb + kh * ksh;
  const float* __restrict__ vb = v + b * vsb + kh * vsh;

  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int r = idx / D, c = idx % D;
    const int qi = q0 + r;
    qs[r * QSTR + c] = qi < S ? qb[qi * qss + c] : 0.f;
  }
  int k_lo, k_hi;
  key_range(q0, min(q0 + BQ, S) - 1, Tn, causal, window, k_lo, k_hi);

  float m_r[4], l_r[4], acc[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m_r[a] = NEG_INF;
    l_r[a] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[a][c] = 0.f;
  }

  for (int jt = k_lo / BK; jt < (k_hi + BK - 1) / BK; ++jt) {
    const int kbase = jt * BK;
    __syncthreads();               // the last tile's K, V and P reads are done
    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int r = idx / D, c = idx % D;
      const int kj = kbase + r;
      const bool in = kj < Tn;
      ks[r * QSTR + c] = in ? kb[kj * kst + c] : 0.f;
      vs[r * D + c] = in ? vb[kj * vst + c] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) s[a][bb] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qv[a] = qs[(ty + 16 * a) * QSTR + d];
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) kv[bb] = ks[(tx + 16 * bb) * QSTR + d];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) s[a][bb] = fmaf(qv[a], kv[bb], s[a][bb]);
    }

#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int qi = q0 + ty + 16 * a;
      float sv[4];
      float mx = NEG_INF;
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int kj = kbase + tx + 16 * bb;
        sv[bb] = visible(qi, kj, Tn, causal, window) ? s[a][bb] * scale : NEG_INF;
        mx = fmaxf(mx, sv[bb]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_r[a], mx);
      const float corr = expf(m_r[a] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int kj = kbase + tx + 16 * bb;
        const float p = kj < Tn ? expf(sv[bb] - m_new) : 0.f;
        rs += p;
        ps[(ty + 16 * a) * PSTR + tx + 16 * bb] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l_r[a] = l_r[a] * corr + rs;
      m_r[a] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[a][c] *= corr;
    }
    __syncwarp();                  // a row of P is written and read by one half-warp

    const int jn = min(BK, Tn - kbase);
    for (int j = 0; j < jn; ++j) {
      float vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = vs[j * D + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float p = ps[(ty + 16 * a) * PSTR + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[a][c] = fmaf(p, vv[c], acc[a][c]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int qi = q0 + ty + 16 * a;
    if (qi >= S) continue;
    const float den = fmaxf(l_r[a], 1e-30f);
    float* __restrict__ ob = o + (((long long)b * S + qi) * H + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) ob[tx + 16 * c] = acc[a][c] / den;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int Tn, int H,
           int KH, const long long* st, int causal, int window, float scale,
           cudaStream_t stream) {
  if (B * H > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = Tile<D>::smem();
  auto kern = flash_f32_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, Tn, H, KH, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace f32

// ---------------------------------------------------------------- bf16 --

namespace bf16 {

constexpr int BQ = 128;            // query rows per block, 64 per warpgroup
constexpr int BKV = 64;            // keys per tile

template <int D> struct Cfg {
  static constexpr int DP = D == 112 ? 128 : D;       // the tile's width: D, or 128 for 112
  static constexpr int PW = DP < 64 ? DP : 64;        // columns of one swizzled panel
  static constexpr int ROWB = PW * 2;                 // its row: 128 or 64 bytes
  static constexpr int NP = DP / PW;                  // panels across the tile
  static constexpr int SWIZZLE = ROWB;                // 128- or 64-byte swizzle
  static constexpr int LAYOUT = ROWB == 128 ? 1 : 2;  // wgmma descriptor code
  static constexpr int SBO = 8 * ROWB;                // bytes between 8-row groups
  static constexpr int Q_BYTES = BQ * DP * 2;
  static constexpr int KV_BYTES = BKV * DP * 2;       // one K or one V tile
  static constexpr int Q_PANEL = BQ * ROWB;
  static constexpr int KV_PANEL = BKV * ROWB;
  // Q, two stages of K and V, and slack to align the base to 1024 bytes
  static constexpr size_t SMEM = (size_t)Q_BYTES + 4 * KV_BYTES + 1024;
};

using namespace hp;

// S (+)= Q K^T over one k16 slice: m64n64k16, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// O += P V over one k16 slice of keys: m64nDk16, P (A) from registers as
// bf16 pairs, V (B) from shared memory N-major (imm-trans-b 1)
template <int D>
__device__ void wgmma_pv(float (&d)[D / 2], const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_pv<32>(float (&d)[16], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_pv<256>(float (&d)[128], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the K and V panels of key tile ``jt`` into stage ``st``
template <int D>
__device__ __forceinline__ void load_kv(uint32_t k_s, uint32_t v_s, uint32_t bar,
                                        const CUtensorMap* tk, const CUtensorMap* tv, int jt,
                                        int kh, int b) {
  using C = Cfg<D>;
  mbar_expect_tx(bar, 2 * C::KV_BYTES);
#pragma unroll
  for (int p = 0; p < C::NP; ++p) {
    tma_load_4d(k_s + p * C::KV_PANEL, tk, p * C::PW, jt * BKV, kh, b, bar);
    tma_load_4d(v_s + p * C::KV_PANEL, tv, p * C::PW, jt * BKV, kh, b, bar);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o, int S,
                  int Tn, int H, int KH, int causal, int window, float scale) {
  using C = Cfg<D>;
  constexpr int NO = C::DP / 2;    // O accumulators a thread
  extern __shared__ unsigned char smem_raw[];
  // Q; K/V stage 0 and 1 full (TMA bytes landed); stage 0 and 1 empty
  // (every thread of the block done reading it)
  __shared__ __align__(8) uint64_t bars[5];

  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t kv_s = base + C::Q_BYTES;    // stage st: K at + 2 st KV_BYTES, V after it
  const uint32_t bar0 = smem_u32(&bars[0]);

  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = (int)blockIdx.x / H, h = (int)blockIdx.x % H;
  const int kh = h / (H / KH);
  const int q0 = ((int)gridDim.y - 1 - (int)blockIdx.y) * BQ;
  int k_lo, k_hi;
  key_range(q0, min(q0 + BQ, S) - 1, Tn, causal, window, k_lo, k_hi);
  const int jt0 = k_lo / BKV;
  const int nt = (k_hi + BKV - 1) / BKV - jt0;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 5; ++i) mbar_init(bar0 + 8 * i, i < 3 ? 1 : THREADS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar0, C::Q_BYTES);
#pragma unroll
    for (int p = 0; p < C::NP; ++p)
      tma_load_4d(q_s + p * C::Q_PANEL, &tq, p * C::PW, q0, h, b, bar0);
    if (nt > 0) load_kv<D>(kv_s, kv_s + C::KV_BYTES, bar0 + 8, &tk, &tv, jt0, kh, b);
  }

  // this thread's rows: r0 and r0 + 8; its columns of a tile 8j + 2t4 + {0, 1}
  const int r0 = q0 + wg * 64 + warp * 16 + g, r1 = r0 + 8;
  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  const uint32_t q_wg = q_s + wg * 64 * C::ROWB;   // this warpgroup's 64 rows

  mbar_wait(bar0, 0);
  for (int it = 0; it < nt; ++it) {
    const int st = it & 1;
    const uint32_t k_s = kv_s + st * 2 * C::KV_BYTES, v_s = k_s + C::KV_BYTES;
    if (tid == 0 && it + 1 < nt) {
      // the other stage held tile it - 1: wait until every thread is done with it
      if (it > 0) mbar_wait(bar0 + 8 * (3 + (st ^ 1)), ((it - 1) >> 1) & 1);
      const uint32_t k_n = kv_s + (st ^ 1) * 2 * C::KV_BYTES;
      load_kv<D>(k_n, k_n + C::KV_BYTES, bar0 + 8 * (1 + (st ^ 1)), &tk, &tv, jt0 + it + 1,
                 kh, b);
    }
    mbar_wait(bar0 + 8 * (1 + st), (it >> 1) & 1);

    // S = Q K^T
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    reg_fence(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {   // the slices that hold data
      const int p = kk / (C::PW / 16), w = (kk % (C::PW / 16)) * 32;
      wgmma_qk(s, make_desc(q_wg + p * C::Q_PANEL + w, 16, C::SBO, C::LAYOUT),
               make_desc(k_s + p * C::KV_PANEL + w, 16, C::SBO, C::LAYOUT), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(s);

    // masks and the online softmax, rows r0 (s[4j], s[4j+1]) and r1 (s[4j+2], s[4j+3])
    const int kbase = (jt0 + it) * BKV;
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kj = kbase + 8 * j + 2 * t4 + c;
        s[4 * j + c] = visible(r0, kj, Tn, causal, window) ? s[4 * j + c] * scale : NEG_INF;
        s[4 * j + 2 + c] =
            visible(r1, kj, Tn, causal, window) ? s[4 * j + 2 + c] * scale : NEG_INF;
        mx0 = fmaxf(mx0, s[4 * j + c]);
        mx1 = fmaxf(mx1, s[4 * j + 2 + c]);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float corr0 = expf(m0 - mn0), corr1 = expf(m1 - mn1);
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const bool in = kbase + 8 * j + 2 * t4 + c < Tn;
        const float p0 = in ? expf(s[4 * j + c] - mn0) : 0.f;
        const float p1 = in ? expf(s[4 * j + 2 + c] - mn1) : 0.f;
        s[4 * j + c] = p0;
        s[4 * j + 2 + c] = p1;
        rs0 += p0;
        rs1 += p1;
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      rs0 += __shfl_xor_sync(0xffffffffu, rs0, off);
      rs1 += __shfl_xor_sync(0xffffffffu, rs1, off);
    }
    l0 = l0 * corr0 + rs0;
    l1 = l1 * corr1 + rs1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int j = 0; j < NO / 4; ++j) {
      acc[4 * j] *= corr0;
      acc[4 * j + 1] *= corr0;
      acc[4 * j + 2] *= corr1;
      acc[4 * j + 3] *= corr1;
    }

    // O += P V, P rounded to bf16 as the A fragment of each k16 slice; all
    // four fragments are packed before the fence, so no product waits on them
    uint32_t pa[BKV / 16][4];
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) pa[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
    reg_fence(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      wgmma_pv<C::DP>(acc, pa[kk],
                      make_desc(v_s + kk * 16 * C::ROWB, C::KV_PANEL, C::SBO, C::LAYOUT));
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(acc);
    // hand the stage back; no block-wide barrier, so the two warpgroups can
    // drift apart and one's softmax overlaps the other's products
    mbar_arrive(bar0 + 8 * (3 + st));
  }

  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = half ? r1 : r0;
    if (qi >= S) continue;
    const float den = half ? den1 : den0;
    __nv_bfloat16* __restrict__ ob = o + (((long long)b * S + qi) * H + h) * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < NO / 4; ++j) {
      if (8 * j >= D) break;         // the tile's zero columns past D
      const __nv_bfloat162 val = __floats2bfloat162_rn(acc[4 * j + 2 * half] / den,
                                                       acc[4 * j + 2 * half + 1] / den);
      *reinterpret_cast<__nv_bfloat162*>(ob + 8 * j) = val;
    }
  }
}

// a 4-D map over (D, rows, heads, batch) of a bf16 tensor in the model
// layout, boxes of one swizzled panel by ``box_rows`` rows (a box past D
// is zero-filled)
bool encode(CUtensorMap* map, const void* ptr, int D, int rows, int heads, int batch,
            long long s_row, long long s_head, long long s_batch, int pw, int box_rows,
            int swizzle) {
  EncodeTiled fn = encoder();
  if (!fn) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)rows, (cuuint64_t)heads,
                              (cuuint64_t)batch};
  // a dimension of extent 1 is never stepped over: give it a legal stride
  const long long row_bytes = 2LL * D;
  const cuuint64_t strides[3] = {(cuuint64_t)(rows > 1 ? 2 * s_row : row_bytes),
                                 (cuuint64_t)(heads > 1 ? 2 * s_head : row_bytes),
                                 (cuuint64_t)(batch > 1 ? 2 * s_batch : row_bytes)};
  const cuuint32_t box[4] = {(cuuint32_t)pw, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult rc = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                         dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         swizzle == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int Tn, int H,
           int KH, const long long* st, int causal, int window, float scale,
           cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap tq, tk, tv;
  if (!encode(&tq, q, D, S, H, B, st[1], st[2], st[0], C::PW, BQ, C::SWIZZLE) ||
      !encode(&tk, k, D, Tn, KH, B, st[4], st[5], st[3], C::PW, BKV, C::SWIZZLE) ||
      !encode(&tv, v, D, Tn, KH, B, st[7], st[8], st[6], C::PW, BKV, C::SWIZZLE))
    return (int)cudaErrorInvalidValue;
  auto kern = flash_bf16_kernel<D>;
  // the shared-memory opt-in acts on the current device only: made on every
  // launch, so a launch on another card has it too
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int nq = (S + BQ - 1) / BQ;
  if (nq > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(B * H, nq);      // y: the last query tiles first, over every head
  kern<<<grid, THREADS, C::SMEM, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o), S, Tn,
                                           H, KH, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace bf16

}  // namespace

extern "C" {

// dtype 0: float32, 1: bfloat16.  strides (elements): q (b, s, h),
// k (b, t, h), v (b, t, h).  window <= 0: none.  bfloat16 needs q, k, v
// 16-byte aligned with strides a multiple of 8 (TMA).  Launches on
// ``stream`` and returns cudaGetLastError() (0 on success).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int dtype, int B,
                        int S, int Tn, int H, int KH, int D, long long qsb, long long qss,
                        long long qsh, long long ksb, long long kst, long long ksh,
                        long long vsb, long long vst, long long vsh, int causal, int window,
                        float scale, void* stream) {
  if (B <= 0 || S <= 0 || Tn <= 0 || KH <= 0 || H % KH != 0) return (int)cudaErrorInvalidValue;
  const long long st[9] = {qsb, qss, qsh, ksb, kst, ksh, vsb, vst, vsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_CASE(NS, DD) \
  case DD:                 \
    return NS::launch<DD>(q, k, v, o, B, S, Tn, H, KH, st, causal, window, scale, s);
  if (dtype == 0) {
    switch (D) {
      FLASH_CASE(f32, 32)
      FLASH_CASE(f32, 64)
      FLASH_CASE(f32, 112)
      FLASH_CASE(f32, 128)
      FLASH_CASE(f32, 256)
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (dtype == 1) {
    switch (D) {
      FLASH_CASE(bf16, 32)
      FLASH_CASE(bf16, 64)
      FLASH_CASE(bf16, 112)
      FLASH_CASE(bf16, 128)
      FLASH_CASE(bf16, 256)
      default: return (int)cudaErrorInvalidValue;
    }
  }
#undef FLASH_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
