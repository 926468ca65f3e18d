// Online-softmax (flash) attention forward for Hopper (sm_90a):
//
//     out[b, s, h] = softmax_t(q[b, s, h] . k[b, t, h / G] * scale + mask) . v[b, t, h / G]
//
// q (B, S, H, D) and k, v (B, T, K, D) in the model's layout, read through
// their strides (the last dimension contiguous); G = H / K query heads
// share one key/value head (GQA, MQA at K = 1).  out (B, S, H, D),
// contiguous, in the input type.  Float32 or bfloat16; D in {32, 64, 128, 256}.
//
// Replaces src/repro/kernels/flash_attention.py:flash_attention (the Pallas
// TPU kernel, body _kernel), which the port's attention_full(impl="chunked")
// runs on the prefill of the dense family.  Its numerics are kept:
//   * scores q.k in f32 times scale; masked scores are NEG_INF = -1e30 (not
//     -inf), masks: causal (q_pos >= k_pos), window (q_pos - k_pos < window)
//     and keys past T;
//   * f32 running max m, normalizer l and accumulator; per key tile
//     m_new = max(m, rowmax), p = exp(s - m_new), corr = exp(m - m_new),
//     l = l * corr + rowsum(p) (p in f32), acc = acc * corr + p . v with p
//     rounded to the value type first (bfloat16 inputs: bf16 p);
//   * out = acc / max(l, 1e-30), rounded to the input type.
// A tile whose keys are all masked before the first visible key of a row
// adds p = 1 entries that the next visible tile's corr = exp(-1e30 - m) = 0
// wipes exactly, as in the Pallas body.  Padded keys of a ragged T are not
// padded here: they are skipped, p = 0.
//
// Design.  One block of 256 threads (16 x 16) per (query tile of 64 rows,
// batch * query head); the blocks of the last query tiles go first, as
// they have the most key tiles under a causal mask.  The block loops over
// the key tiles that some row of its query tile can see (under a causal or
// window mask the others are exact no-ops, see above), with the Q tile,
// one K and one V tile and the 64 x 64 probability tile in dynamic shared
// memory (up to 209 KB at D = 256 in f32).  Thread (ty, tx) owns rows
// ty + 16a (a < 4): scores for keys tx + 16b (b < 4), reduced across the
// 16 lanes of its half-warp with shuffles, and output columns tx + 16c.
// Products are fp32 FMAs on the CUDA cores, in both types (no TF32, no
// tensor cores): the bf16 products are exact in f32, the fp32 ones keep
// the port's fp32 numerics.  K and Q rows are padded by one 32-bit word
// so the score loop reads shared memory without bank conflicts.
//
// What bounds it.  At the gemma-2b prefill shape (B 4, S = T 2048, H 8,
// K 1, D 256, bf16, causal) the work is 6.87e10 flop and 75.5 MB of
// traffic: 0.069 ms at 989 TFLOP/s on the tensor cores, 0.023 ms at
// 3.35 TB/s.  This kernel runs on the CUDA cores, whose fp32 peak is
// 67 TFLOP/s, and reads its operands from shared memory once per FMA pair;
// its time is in PERF.md.  wgmma, TMA and pipelining are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int PSTR = BK + 1;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// row stride of the Q and K tiles: D plus one 32-bit word
template <typename T, int D> struct Tile {
  static constexpr int QSTR = D + 4 / (int)sizeof(T);
  static constexpr size_t smem() {
    return (size_t)(BQ * QSTR + BK * QSTR + BK * D) * sizeof(T) + (size_t)BQ * PSTR * 4;
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       int S, int Tn, int H, int KH,
                       long long qsb, long long qss, long long qsh,
                       long long ksb, long long kst, long long ksh,
                       long long vsb, long long vst, long long vsh,
                       int causal, int window, float scale) {
  constexpr int QSTR = Tile<T, D>::QSTR;
  constexpr int NC = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = qs + BQ * QSTR;
  T* vs = ks + BK * QSTR;
  float* ps = reinterpret_cast<float*>(vs + BK * D);

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int nq = (S + BQ - 1) / BQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * BQ;
  const int b = (int)blockIdx.y / H, h = (int)blockIdx.y % H;
  const int kh = h / (H / KH);
  const T* __restrict__ qb = q + b * qsb + h * qsh;
  const T* __restrict__ kb = k + b * ksb + kh * ksh;
  const T* __restrict__ vb = v + b * vsb + kh * vsh;
  const T zero = from_f<T>(0.f);

  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int r = idx / D, c = idx % D;
    const int qi = q0 + r;
    qs[r * QSTR + c] = qi < S ? qb[qi * qss + c] : zero;
  }

  // keys [k_lo, k_hi) that some row of this tile can see; a row that sees
  // none (window, q >= T - 1 + window) averages every key, as the plain
  // version does, so then the whole key range runs
  const int q1 = min(q0 + BQ, S) - 1;
  int k_lo = 0, k_hi = Tn;
  if (causal) k_hi = min(Tn, q1 + 1);
  if (window > 0) k_lo = max(0, q0 - window + 1);
  if (window > 0 && q1 >= Tn - 1 + window) { k_lo = 0; k_hi = Tn; }

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
      ks[r * QSTR + c] = in ? kb[kj * kst + c] : zero;
      vs[r * D + c] = in ? vb[kj * vst + c] : zero;
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
      for (int a = 0; a < 4; ++a) qv[a] = to_f(qs[(ty + 16 * a) * QSTR + d]);
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) kv[bb] = to_f(ks[(tx + 16 * bb) * QSTR + d]);
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
        const bool ok = kj < Tn && (!causal || qi >= kj) && (window <= 0 || qi - kj < window);
        sv[bb] = ok ? s[a][bb] * scale : NEG_INF;
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
        ps[(ty + 16 * a) * PSTR + tx + 16 * bb] = to_f(from_f<T>(p));
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
      for (int c = 0; c < NC; ++c) vv[c] = to_f(vs[j * D + tx + 16 * c]);
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
    T* __restrict__ ob = o + (((long long)b * S + qi) * H + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) ob[tx + 16 * c] = from_f<T>(acc[a][c] / den);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int Tn, int H, int KH, const long long* st, int causal, int window,
           float scale, cudaStream_t stream) {
  const size_t smem = Tile<T, D>::smem();
  auto kern = flash_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, Tn, H, KH, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* o, int B,
               int S, int Tn, int H, int KH, const long long* st, int causal,
               int window, float scale, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, o, B, S, Tn, H, KH, st, causal, window, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, S, Tn, H, KH, st, causal, window, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, S, Tn, H, KH, st, causal, window, scale, stream);
    case 256: return launch<T, 256>(q, k, v, o, B, S, Tn, H, KH, st, causal, window, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype 0: float32, 1: bfloat16.  strides (elements): q (b, s, h),
// k (b, t, h), v (b, t, h).  window <= 0: none.  Launches on ``stream``
// and returns cudaGetLastError() (0 on success).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int dtype, int B, int S, int Tn, int H, int KH, int D,
                        long long qsb, long long qss, long long qsh,
                        long long ksb, long long kst, long long ksh,
                        long long vsb, long long vst, long long vsh,
                        int causal, int window, float scale, void* stream) {
  if (B <= 0 || S <= 0 || Tn <= 0 || KH <= 0 || H % KH != 0 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const long long st[9] = {qsb, qss, qsh, ksb, kst, ksh, vsb, vst, vsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, o, B, S, Tn, H, KH, st, causal, window, scale, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, o, B, S, Tn, H, KH, st, causal, window,
                                     scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
