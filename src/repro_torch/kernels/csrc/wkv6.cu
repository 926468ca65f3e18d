// RWKV6 WKV recurrence from a zero state, for Hopper (sm_90a).  Per batch b
// and head h, with the state S in R^{D x D} (key index i, value index j):
//
//     out_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//     S[i][j]  = w_t[i] * S[i][j] + k_t[i] * v_t[j]
//
// r, k, v (B, T, H, D) in the model's type (float32 or bfloat16) and w
// (B, T, H, D) in float32 or in r's type, each read through its strides
// (the last dimension contiguous); u (H, D) float32, contiguous.
// out (B, T, H, D), contiguous, in r's type; the final state (B, H, D, D)
// float32, contiguous.  D in {16, 32, 64, 128}.
//
// Replaces src/repro/kernels/rwkv6_scan.py:wkv6 (the Pallas TPU kernel,
// body _kernel), which the port's wkv_apply(wkv_impl="chunked") runs on
// the prefill of the ssm family (rwkv6-3b).  Compute is f32, as there.
//
// What bounds it.  At the rwkv6-3b prefill shape (B 4, T 2048, H 40,
// D 64; bf16 r/k/v, f32 w) the work is 7 D^2 flop per step and head,
// 9.4e9 flop (0.14 ms at the 67 TFLOP/s fp32 peak), over 252 MB of
// traffic (0.075 ms at 3.35 TB/s).  The exact recurrence has no matrix
// product for the tensor cores (each step is a rank-1 update and a
// matrix-vector product), and its steps are strictly sequential, so the
// kernel is bound by instruction issue and latency: 160 heads x 2048 steps
// x 4 D^2 lane operations is about 1.7e8 warp instructions, which the
// 132 x 4 schedulers issue in about 0.18 ms if they are kept fed; the
// loads, the bf16 conversions and the reduction come on top.
//
// Design.  The state is split across lanes.  A (b, h) gets P threads for
// each group of JC state columns, and thread (group, q) keeps rows
// [q D/P, (q+1) D/P) of its JC columns in registers for all T steps, with
// its slice of u; the columns of a head are further split across S blocks
// (each re-reads r, k and w from L2).  At D = 64 the variant is
// (P, S, JC) = (8, 2, 2): 8 rows x 2 columns = 16 floats of state a
// thread, 128 threads a block, 320 blocks, about 2.4 warps per scheduler
// (a thread per column, one block of 64 threads a head, gave 160 blocks on
// 132 SMs, two blocks on 28 of them, and about 0.6 warps per scheduler);
// each r, k, w value a thread loads and converts serves its JC columns.  The P threads of a
// column group are neighbouring lanes of one warp, and their partial sums
// of out_t are reduced P steps at a time by one __shfl_xor_sync butterfly
// (P - 1 shuffles a column for P steps), at the end of which lane q holds
// step q's sums and stores them: no shared memory and no barrier per step,
// and the shuffles' latency falls once per P steps.  A thread keeps one
// partial-sum chain per column and step of the group (two per column
// where it holds 16 rows or more).  Chunks of CH steps of r, k, w and the
// block's columns of v are staged by cp.async into a two-buffer ring in
// shared memory, in their stored types, and converted to f32 at use: the
// next chunk's loads are in flight while this one is computed, and there
// is one __syncthreads per chunk.  A thread's slice of a staged step that
// spans an even number of 16-byte units is padded by 16 bytes, so the
// slices 8 lanes read with 16-byte loads fall on distinct banks.  Inputs
// are read in place, in the model's (B, T, H, D) layout and types: no
// transposed copy, no cast copy, no padding of a ragged T (the last
// chunk's missing steps are neither copied nor run).  Where a base or a
// stride is not a multiple of 16 bytes the staging takes plain element
// copies in place of cp.async.  Each D builds one variant; the D = 64
// variants measured against it are in PERF.md.
//
// Numerics.  The state update is per element the thread-per-column form's
// (kv = k v; s = fma(w, s, kv)), so the final state is the same; only the
// output's sum over i is reassociated (partial sums over each thread's rows,
// then the butterfly).  Measured times are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// N values of type T from shared memory aligned to their size, as f32:
// 16-byte loads, or one 8-byte load for 8 bytes
template <typename T, int N>
__device__ __forceinline__ void load_f(const unsigned char* p, float (&out)[N]) {
  constexpr int BYTES = N * (int)sizeof(T);
  static_assert(BYTES % 16 == 0 || BYTES == 8, "a thread's slice is 8 bytes or 16-byte loads");
  constexpr int WORDS = BYTES / 4;
  uint32_t wd[WORDS];
  if constexpr (BYTES == 8) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    wd[0] = q.x;
    wd[1] = q.y;
  } else {
#pragma unroll
    for (int c = 0; c < BYTES / 16; ++c) {
      const uint4 q = reinterpret_cast<const uint4*>(p)[c];
      wd[4 * c] = q.x;
      wd[4 * c + 1] = q.y;
      wd[4 * c + 2] = q.z;
      wd[4 * c + 3] = q.w;
    }
  }
#pragma unroll
  for (int e = 0; e < WORDS; ++e) {
    if constexpr (sizeof(T) == 4) {
      out[e] = __uint_as_float(wd[e]);
    } else {   // bf16: the low half of each word is the earlier value
      out[2 * e] = __uint_as_float(wd[e] << 16);
      out[2 * e + 1] = __uint_as_float(wd[e] & 0xffff0000u);
    }
  }
}

// The shapes of one variant.  P: threads per state column group; S:
// blocks per head (each owns D / S columns); JC: state columns per thread.
template <typename TR, typename TW, int D, int P, int S, int JC> struct Wkv {
  static constexpr int COLS = D / S;           // state columns per block
  static constexpr int THREADS = COLS / JC * P;
  static constexpr int ROWS = D / P;           // state rows per thread
  static constexpr int QR = ROWS * (int)sizeof(TR);   // bytes of a thread's r or k slice
  static constexpr int QW = ROWS * (int)sizeof(TW);
  // slices of an even number of 16-byte units are padded by 16 bytes, so
  // the P slices that 8 lanes read with 16-byte loads fall on distinct
  // banks; slices of 8 or 16 bytes (or an odd number of units) lie
  // contiguous, which is conflict-free already
  static constexpr int PADR = QR > 16 && (QR / 16) % 2 == 0 ? 16 : 0;
  static constexpr int PADW = QW > 16 && (QW / 16) % 2 == 0 ? 16 : 0;
  static constexpr int G = ROWS < 8 ? ROWS : 8;   // rows loaded at once
  static constexpr int NCH = ROWS >= 16 ? 2 : 1;  // partial-sum chains a column
  static constexpr int PR = P * (QR + PADR);   // pitch of a staged step of r or k
  static constexpr int PW = P * (QW + PADW);   // of w
  static constexpr int PV = COLS * (int)sizeof(TR);   // of the block's v
  static constexpr int STEP = 2 * PR + PW + PV;
  static constexpr int CH = 2 * 16 * STEP <= 48 * 1024 ? 16 : 8;   // steps a chunk
  static constexpr int BUF = CH * STEP;        // bytes of one ring buffer
  static_assert(ROWS % G == 0 && (QR % 16 == 0 || 16 % QR == 0) && PV % 16 == 0,
                "16-byte copies hold whole slices or whole groups of slices");
  static_assert(P == 1 || THREADS % 32 == 0, "the shuffles need whole warps");
  static_assert(CH % P == 0, "a chunk holds whole groups of P steps");
  static_assert(2 * BUF <= 48 * 1024, "the ring fits static shared memory");
};

// Stage steps [t0, t0 + n) of one tensor's rows (each `elems` values of T
// from `base`, step stride `st`) into `dst`, step pitch `pitch`, a pad of
// `pad` bytes after every `qbytes` bytes of a row.
template <typename T>
__device__ __forceinline__ void stage(unsigned char* dst, int pitch, int qbytes, int pad,
                                      const T* __restrict__ base, long long st, int elems,
                                      int t0, int n, bool vec, int tid, int nthreads) {
  const int per_row = elems * (int)sizeof(T) / 16;
  for (int u = tid; u < n * per_row; u += nthreads) {
    const int c = u / per_row, o = (u % per_row) * 16;
    unsigned char* d = dst + c * pitch + o + (o / qbytes) * pad;
    const T* s = base + (long long)(t0 + c) * st + o / (int)sizeof(T);
    if (vec) {
      cp16(d, s);
    } else {
#pragma unroll
      for (int e = 0; e < 16 / (int)sizeof(T); ++e) reinterpret_cast<T*>(d)[e] = s[e];
    }
  }
}

// JC consecutive values of type T from shared memory, as f32
template <typename T, int JC>
__device__ __forceinline__ void load_cols(const T* p, float (&out)[JC]) {
#pragma unroll
  for (int c = 0; c < JC; ++c) out[c] = to_f(p[c]);
}

template <typename TR, typename TW, int D, int P, int S, int JC>
__global__ void __launch_bounds__(Wkv<TR, TW, D, P, S, JC>::THREADS)
wkv6_kernel(const TR* __restrict__ r, const TR* __restrict__ k, const TR* __restrict__ v,
            const TW* __restrict__ w, const float* __restrict__ u, TR* __restrict__ out,
            float* __restrict__ sfin, int Tn, int H, long long rsb, long long rst,
            long long rsh, long long ksb, long long kst, long long ksh, long long vsb,
            long long vst, long long vsh, long long wsb, long long wst, long long wsh,
            int vec) {
  using C = Wkv<TR, TW, D, P, S, JC>;
  constexpr int CH = C::CH, ROWS = C::ROWS, COLS = C::COLS;
  __shared__ __align__(16) unsigned char ring[2][C::BUF];

  const int tid = threadIdx.x;
  const int grp = tid / P, q = tid % P;        // column group, row slice
  const int bh = (int)blockIdx.x / S, col0 = ((int)blockIdx.x % S) * COLS;
  const int b = bh / H, h = bh % H;
  const int j0 = col0 + grp * JC;              // the thread's first column
  const TR* __restrict__ rb = r + b * rsb + h * rsh;
  const TR* __restrict__ kb = k + b * ksb + h * ksh;
  const TR* __restrict__ vb = v + b * vsb + h * vsh + col0;
  const TW* __restrict__ wb = w + b * wsb + h * wsh;
  TR* __restrict__ ob = out + ((long long)b * Tn * H + h) * D + j0;
  const bool v16 = vec != 0;

  // ring buffer layout: r [CH][PR], k [CH][PR], w [CH][PW], v [CH][PV]
  constexpr int OK_ = CH * C::PR, OW = 2 * CH * C::PR, OV = OW + CH * C::PW;
  auto load = [&](int buf, int t0) {
    const int n = min(CH, Tn - t0);
    unsigned char* base = ring[buf];
    stage(base, C::PR, C::QR, C::PADR, rb, rst, D, t0, n, v16, tid, C::THREADS);
    stage(base + OK_, C::PR, C::QR, C::PADR, kb, kst, D, t0, n, v16, tid, C::THREADS);
    stage(base + OW, C::PW, C::QW, C::PADW, wb, wst, D, t0, n, v16, tid, C::THREADS);
    stage(base + OV, C::PV, C::PV, 0, vb, vst, COLS, t0, n, v16, tid, C::THREADS);
  };

  float uu[ROWS], st[ROWS][JC];
#pragma unroll
  for (int e = 0; e < ROWS; ++e) {
    uu[e] = u[h * D + q * ROWS + e];
#pragma unroll
    for (int c = 0; c < JC; ++c) st[e][c] = 0.f;
  }

  const int nch = (Tn + CH - 1) / CH;
  load(0, 0);
  cp_commit();
  for (int ch = 0; ch < nch; ++ch) {
    cp_wait_all();     // this thread's copies of chunk ch have landed
    __syncthreads();   // everyone's have, and everyone is done with chunk ch - 1
    if (ch + 1 < nch) load((ch + 1) & 1, (ch + 1) * CH);
    cp_commit();

    const unsigned char* base = ring[ch & 1];
    const int t0 = ch * CH, n = min(CH, Tn - t0);
    // P steps at a time: each thread's partial sums of the P steps' outputs
    // are reduced over the P lanes of its column group in one butterfly, at
    // the end of which lane q holds step q's full sums
    for (int c0 = 0; c0 < n; c0 += P) {
      constexpr int G = C::G, NCH = C::NCH;
      float y[P][JC][NCH];
#pragma unroll
      for (int i = 0; i < P; ++i) {
#pragma unroll
        for (int c = 0; c < JC; ++c)
#pragma unroll
          for (int e = 0; e < NCH; ++e) y[i][c][e] = 0.f;
        const int cs = c0 + i;
        if (cs >= n) continue;   // past a ragged T: not staged, not run
        const unsigned char* rs = base + cs * C::PR + q * (C::QR + C::PADR);
        const unsigned char* ks = rs + OK_;
        const unsigned char* ws = base + OW + cs * C::PW + q * (C::QW + C::PADW);
        float vj[JC];
        load_cols<TR, JC>(reinterpret_cast<const TR*>(base + OV + cs * C::PV) + grp * JC, vj);
        // the thread's rows in groups of G, so few values are live at once
#pragma unroll
        for (int g = 0; g < ROWS; g += G) {
          float rr[G], kk[G], ww[G];
          load_f<TR>(rs + g * sizeof(TR), rr);
          load_f<TR>(ks + g * sizeof(TR), kk);
          load_f<TW>(ws + g * sizeof(TW), ww);
#pragma unroll
          for (int e = 0; e < G; ++e)
#pragma unroll
            for (int c = 0; c < JC; ++c) {
              const float kv = kk[e] * vj[c];
              float& yc = y[i][c][e % NCH];
              yc = fmaf(rr[e], fmaf(uu[g + e], kv, st[g + e][c]), yc);
              st[g + e][c] = fmaf(ww[e], st[g + e][c], kv);
            }
        }
      }
      float yo[P][JC];
#pragma unroll
      for (int i = 0; i < P; ++i)
#pragma unroll
        for (int c = 0; c < JC; ++c) {
          yo[i][c] = y[i][c][0];
#pragma unroll
          for (int e = 1; e < NCH; ++e) yo[i][c] += y[i][c][e];
        }
#pragma unroll
      for (int o = P / 2; o >= 1; o >>= 1) {
        const bool hi = (q & o) != 0;
#pragma unroll
        for (int i = 0; i < o; ++i)
#pragma unroll
          for (int c = 0; c < JC; ++c) {
            const float send = hi ? yo[i][c] : yo[i + o][c];
            const float keep = hi ? yo[i + o][c] : yo[i][c];
            yo[i][c] = keep + __shfl_xor_sync(0xffffffffu, send, o);
          }
      }
      if (c0 + q < n) {
        TR* dst = ob + (long long)(t0 + c0 + q) * H * D;
#pragma unroll
        for (int c = 0; c < JC; ++c) dst[c] = from_f<TR>(yo[0][c]);
      }
    }
  }

  float* __restrict__ sb = sfin + (long long)bh * D * D + (long long)q * ROWS * D + j0;
#pragma unroll
  for (int e = 0; e < ROWS; ++e)
#pragma unroll
    for (int c = 0; c < JC; ++c) sb[e * D + c] = st[e][c];
}

template <typename TR, typename TW, int D, int P, int S, int JC>
int launch(const void* r, const void* k, const void* v, const void* w, const float* u,
           void* out, float* sfin, int B, int Tn, int H, const long long* st, int vec,
           cudaStream_t stream) {
  using C = Wkv<TR, TW, D, P, S, JC>;
  wkv6_kernel<TR, TW, D, P, S, JC><<<B * H * S, C::THREADS, 0, stream>>>(
      static_cast<const TR*>(r), static_cast<const TR*>(k), static_cast<const TR*>(v),
      static_cast<const TW*>(w), u, static_cast<TR*>(out), sfin, Tn, H, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], vec);
  return (int)cudaGetLastError();
}

// the variant (P, S, JC) of each D
template <typename TR, typename TW>
int dispatch(int D, const void* r, const void* k, const void* v, const void* w,
             const float* u, void* out, float* sfin, int B, int Tn, int H, const long long* st,
             int vec, cudaStream_t s) {
  switch (D) {
    case 16: return launch<TR, TW, 16, 1, 1, 1>(r, k, v, w, u, out, sfin, B, Tn, H, st, vec, s);
    case 32: return launch<TR, TW, 32, 2, 1, 1>(r, k, v, w, u, out, sfin, B, Tn, H, st, vec, s);
    case 64: return launch<TR, TW, 64, 8, 2, 2>(r, k, v, w, u, out, sfin, B, Tn, H, st, vec, s);
    case 128: return launch<TR, TW, 128, 4, 1, 1>(r, k, v, w, u, out, sfin, B, Tn, H, st, vec, s);
  }
  return (int)cudaErrorInvalidValue;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// rk_dtype: r/k/v and out, 0 float32 or 1 bfloat16; w_dtype: 0 float32 or
// 1 bfloat16 (then r's type too).  strides (elements): r, k, v, w, each
// (b, t, h).  Launches on ``stream`` and returns cudaGetLastError().
int wkv6_fwd(const void* r, const void* k, const void* v, const void* w, const float* u,
             void* out, float* sfin, int rk_dtype, int w_dtype, int B, int Tn, int H, int D,
             long long rsb, long long rst, long long rsh, long long ksb, long long kst,
             long long ksh, long long vsb, long long vst, long long vsh, long long wsb,
             long long wst, long long wsh, void* stream) {
  if (B <= 0 || Tn <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const long long st[12] = {rsb, rst, rsh, ksb, kst, ksh, vsb, vst, vsh, wsb, wst, wsh};
  // cp.async takes 16-byte copies: every base and every stride a multiple
  // of 16 bytes, else the staging copies element by element
  const long long rb = rk_dtype == 0 ? 4 : 2, wbytes = w_dtype == 0 ? 4 : 2;
  bool vec = aligned16(r) && aligned16(k) && aligned16(v) && aligned16(w);
  for (int i = 0; i < 12; ++i) vec = vec && (st[i] * (i < 9 ? rb : wbytes)) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rk_dtype == 0 && w_dtype == 0)
    return dispatch<float, float>(D, r, k, v, w, u, out, sfin, B, Tn, H, st, vec, s);
  if (rk_dtype == 1 && w_dtype == 0)
    return dispatch<__nv_bfloat16, float>(D, r, k, v, w, u, out, sfin, B, Tn, H, st, vec, s);
  if (rk_dtype == 1 && w_dtype == 1)
    return dispatch<__nv_bfloat16, __nv_bfloat16>(D, r, k, v, w, u, out, sfin, B, Tn, H, st,
                                                  vec, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
