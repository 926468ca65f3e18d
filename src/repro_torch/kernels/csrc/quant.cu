// Per-row symmetric int8 quantization for Hopper (sm_90a):
//
//     scale = max(absmax(x_row) / 127, 1e-12)
//     q     = clip(round_half_to_even(x / scale), -127, 127)   as int8
//
// x (N, d) f32, row-major and contiguous; q (N, d) int8; scale (N,) f32.
//
// Replaces src/repro/kernels/quant.py:quantize_rows (the Pallas TPU kernel,
// body _kernel): the hot loop of the activation-transport compression,
// which quantizes every client's uplink activations and downlink gradient.
// Like it, one pass over a row yields both the int8 payload and the scale.
//
// Design.  One block of 256 threads per row.  Each thread takes a strided
// share of the row's columns for the absmax, the warps reduce with
// shuffles and the block through shared memory, and one thread forms the
// scale; then every thread quantizes its columns.  The row is read twice,
// the second time from L1/L2.  Any N and any d are taken: the columns are
// masked by the stride loop, and the TPU version's padding of N to a
// multiple of 256 rows goes away.
//
// Numerics.  The result must equal jnp.round / torch.round bit for bit, so
// the division is __fdiv_rn (IEEE round-to-nearest, also under fast-math
// flags) and the rounding is rintf, which rounds half to even as
// jnp.round does; roundf would round half away from zero.  The clamp runs
// on the float before the int8 conversion.
//
// What bounds it.  At the cohort path's shape (2048 rows of d = 768) one
// launch must read 6.3 MB and write 1.6 MB: about 2.4 us at the H100's
// 3.35 TB/s, with 5 operations per element far below any compute bound.
// Measured times are in PERF.md; at this size a launch costs more than
// the traffic.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
quantize_rows_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                     float* __restrict__ scale, int d) {
  const size_t row = blockIdx.x;
  const float* __restrict__ xr = x + row * d;
  int8_t* __restrict__ qr = q + row * d;
  __shared__ float warp_max[WARPS];
  __shared__ float row_scale;

  float m = 0.f;
  for (int j = threadIdx.x; j < d; j += THREADS) m = fmaxf(m, fabsf(xr[j]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    float mm = warp_max[0];
#pragma unroll
    for (int i = 1; i < WARPS; ++i) mm = fmaxf(mm, warp_max[i]);
    const float s = fmaxf(__fdiv_rn(mm, 127.0f), 1e-12f);
    row_scale = s;
    scale[row] = s;
  }
  __syncthreads();

  const float s = row_scale;
  for (int j = threadIdx.x; j < d; j += THREADS) {
    float v = rintf(__fdiv_rn(xr[j], s));
    v = fminf(fmaxf(v, -127.f), 127.f);
    qr[j] = (int8_t)v;
  }
}

}  // namespace

extern "C" {

// Launches on ``stream`` and returns cudaGetLastError() (0 on success).
int quantize_rows_f32(const float* x, int8_t* q, float* scale, int n, int d,
                      void* stream) {
  if (n <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  quantize_rows_kernel<<<n, THREADS, 0, s>>>(x, q, scale, d);
  return (int)cudaGetLastError();
}

}  // extern "C"
