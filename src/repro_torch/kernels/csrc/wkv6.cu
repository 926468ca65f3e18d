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
// Design.  One block per (b, h) of D threads; thread j owns column j of
// the state, D floats in registers for all T steps, so the state never
// leaves the chip until the end.  The steps are strictly sequential: the
// block stages CH steps of r, k, w (and v) in shared memory as f32, then
// each thread runs them, reading r, k, w and u for all i as broadcasts
// (float4), with the output's dot product split into four partial sums to
// shorten its dependency chain.  Inputs are read in place, in the model's
// (B, T, H, D) layout and types: no transposed copy, no cast copy of a
// bf16 r/k/v or an f32 decay, and no padding of a ragged T.
//
// What bounds it.  At the rwkv6-3b prefill shape (B 4, T 2048, H 40,
// D 64; bf16 r/k/v, f32 w) the work is 7 D^2 flop per step and head,
// 9.4e9 flop (0.14 ms at the 67 TFLOP/s fp32 peak), over 252 MB of
// traffic (0.075 ms at 3.35 TB/s).  But the recurrence is latency-bound:
// each step waits for the last, and 160 blocks of 64 threads leave most
// of each SM idle.  Its time is in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int D> struct Steps {
  static constexpr int CH = D <= 64 ? 32 : 16;   // 4 x CH x D floats <= 32 KB
};

template <typename TR, typename TW, int D>
__global__ void __launch_bounds__(D)
wkv6_kernel(const TR* __restrict__ r, const TR* __restrict__ k,
            const TR* __restrict__ v, const TW* __restrict__ w,
            const float* __restrict__ u, TR* __restrict__ out,
            float* __restrict__ sfin, int Tn, int H,
            long long rsb, long long rst, long long rsh,
            long long ksb, long long kst, long long ksh,
            long long vsb, long long vst, long long vsh,
            long long wsb, long long wst, long long wsh) {
  constexpr int CH = Steps<D>::CH;
  __shared__ __align__(16) float rs[CH][D];
  __shared__ __align__(16) float ks[CH][D];
  __shared__ __align__(16) float ws[CH][D];
  __shared__ float vs[CH][D];
  __shared__ __align__(16) float us[D];

  const int j = threadIdx.x;
  const int b = (int)blockIdx.x / H, h = (int)blockIdx.x % H;
  const TR* __restrict__ rb = r + b * rsb + h * rsh + j;
  const TR* __restrict__ kb = k + b * ksb + h * ksh + j;
  const TR* __restrict__ vb = v + b * vsb + h * vsh + j;
  const TW* __restrict__ wb = w + b * wsb + h * wsh + j;
  TR* __restrict__ ob = out + ((long long)b * Tn * H + h) * D + j;
  us[j] = u[h * D + j];

  float st[D];
#pragma unroll
  for (int i = 0; i < D; ++i) st[i] = 0.f;

  for (int t0 = 0; t0 < Tn; t0 += CH) {
    const int n = min(CH, Tn - t0);
    __syncthreads();               // the last chunk's reads are done
    for (int c = 0; c < n; ++c) {
      const long long t = t0 + c;
      rs[c][j] = to_f(rb[t * rst]);
      ks[c][j] = to_f(kb[t * kst]);
      vs[c][j] = to_f(vb[t * vst]);
      ws[c][j] = to_f(wb[t * wst]);
    }
    __syncthreads();
    for (int c = 0; c < n; ++c) {
      const float vj = vs[c][j];
      float y[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < D; i += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(&rs[c][i]);
        const float4 k4 = *reinterpret_cast<const float4*>(&ks[c][i]);
        const float4 w4 = *reinterpret_cast<const float4*>(&ws[c][i]);
        const float4 u4 = *reinterpret_cast<const float4*>(&us[i]);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
        const float uu[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float kv = kk[e] * vj;
          y[e] = fmaf(rr[e], fmaf(uu[e], kv, st[i + e]), y[e]);
          st[i + e] = fmaf(ww[e], st[i + e], kv);
        }
      }
      ob[(long long)(t0 + c) * H * D] = from_f<TR>((y[0] + y[1]) + (y[2] + y[3]));
    }
  }

  float* __restrict__ sb = sfin + (long long)blockIdx.x * D * D + j;
#pragma unroll
  for (int i = 0; i < D; ++i) sb[i * D] = st[i];
}

template <typename TR, typename TW, int D>
int launch(const void* r, const void* k, const void* v, const void* w,
           const float* u, void* out, float* sfin, int B, int Tn, int H,
           const long long* st, cudaStream_t stream) {
  wkv6_kernel<TR, TW, D><<<B * H, D, 0, stream>>>(
      static_cast<const TR*>(r), static_cast<const TR*>(k), static_cast<const TR*>(v),
      static_cast<const TW*>(w), u, static_cast<TR*>(out), sfin, Tn, H, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11]);
  return (int)cudaGetLastError();
}

template <typename TR, typename TW>
int dispatch_d(int D, const void* r, const void* k, const void* v, const void* w,
               const float* u, void* out, float* sfin, int B, int Tn, int H,
               const long long* st, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<TR, TW, 16>(r, k, v, w, u, out, sfin, B, Tn, H, st, stream);
    case 32: return launch<TR, TW, 32>(r, k, v, w, u, out, sfin, B, Tn, H, st, stream);
    case 64: return launch<TR, TW, 64>(r, k, v, w, u, out, sfin, B, Tn, H, st, stream);
    case 128: return launch<TR, TW, 128>(r, k, v, w, u, out, sfin, B, Tn, H, st, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// rk_dtype: r/k/v and out, 0 float32 or 1 bfloat16; w_dtype: 0 float32 or
// 1 bfloat16 (then r's type too).  strides (elements): r, k, v, w, each
// (b, t, h).  Launches on ``stream`` and returns cudaGetLastError().
int wkv6_fwd(const void* r, const void* k, const void* v, const void* w,
             const float* u, void* out, float* sfin, int rk_dtype, int w_dtype,
             int B, int Tn, int H, int D,
             long long rsb, long long rst, long long rsh,
             long long ksb, long long kst, long long ksh,
             long long vsb, long long vst, long long vsh,
             long long wsb, long long wst, long long wsh, void* stream) {
  if (B <= 0 || Tn <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const long long st[12] = {rsb, rst, rsh, ksb, kst, ksh, vsb, vst, vsh, wsb, wst, wsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rk_dtype == 0 && w_dtype == 0)
    return dispatch_d<float, float>(D, r, k, v, w, u, out, sfin, B, Tn, H, st, s);
  if (rk_dtype == 1 && w_dtype == 0)
    return dispatch_d<__nv_bfloat16, float>(D, r, k, v, w, u, out, sfin, B, Tn, H, st, s);
  if (rk_dtype == 1 && w_dtype == 1)
    return dispatch_d<__nv_bfloat16, __nv_bfloat16>(D, r, k, v, w, u, out, sfin, B, Tn, H,
                                                    st, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
