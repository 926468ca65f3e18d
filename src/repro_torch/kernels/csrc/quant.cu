// Per-row symmetric int8 quantization for Hopper (sm_90a):
//
//     scale = max(absmax(x_row) / 127, 1e-12)
//     q     = clip(round_half_to_even(x / scale), -127, 127)   as int8
//
// x (N, d) f32 or bf16, row-major and contiguous; q (N, d) int8; scale (N,)
// f32.  x is read in its stored type and widened to f32 in registers, as
// the reference's kernel casts inside (``x_ref[...].astype(jnp.float32)``).
//
// Replaces src/repro/kernels/quant.py:quantize_rows (the Pallas TPU kernel,
// body _kernel): the hot loop of the activation-transport compression,
// which quantizes every client's uplink activations and downlink gradient.
// Like it, one pass over a row yields both the int8 payload and the scale.
//
// What bounds it.  Bytes: at the cohort path's shape (2048 rows of d = 768)
// an f32 launch must read 6.3 MB and write 1.6 MB, 2.35 us at the H100's
// 3.35 TB/s (bf16: 4.7 MB, 1.41 us); 5 operations an element are far below
// any compute bound.  So the design keeps many loads in flight, reads each
// row once, and issues nothing between the loads and the stores that waits
// on other warps.
//
// Resident body (quantize_rows_resident<T, V>).  One warp per row, ROWS
// rows a block, so the cohort shape is 2048 warps in one resident wave on
// 132 SMs.  A lane issues all of its V 16-byte loads (chunk lane + 32 i of
// the row: 4 f32 or 8 bf16 each, neighbouring lanes on neighbouring
// chunks) before it uses any, keeps the row's values in registers, reduces
// the absmax by warp shuffles (no shared memory, no barrier), forms the
// scale itself, and stores each chunk's codes packed: four in a 32-bit
// store (f32) or eight in a 64-bit one (bf16).  V = 1..MAX_LOADS covers
// rows whose byte length is a multiple of 16 up to 32 * MAX_LOADS chunks
// (d <= 2048 in f32, 4096 in bf16: every width the port's models use).
//
// Strided body (quantize_rows_strided<T>).  Any other row (d not a whole
// number of 16-byte chunks, an unaligned base, or a wider row): one block
// of 256 threads per row takes a strided share of the columns, reduces
// through shuffles and shared memory, and reads the row a second time
// (from L1/L2) to quantize it.  Any N and d are taken.
//
// The caller (kernels/quant.py: resident_loads) chooses the body before
// the launch by d, the type and x's alignment, and the entry refuses a
// resident launch the row does not fit.
//
// Numerics.  The result must equal jnp.round / torch.round bit for bit, so
// both divisions are __fdiv_rn (IEEE round-to-nearest, also under fast-math
// flags; a reciprocal multiply would move bits) and the rounding is half to
// even, as jnp.round does (roundf would round half away from zero): the
// quotient, clamped to [-127, 127] as a float, plus 1.5 * 2^23 in one
// round-to-nearest f32 add holds the code in its low byte.  That add and
// one byte permute per code replace rintf and a float-to-int conversion,
// which issue at a quarter of the FMA rate.
// Measured times are in PERF.md.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 8;          // rows (warps) per block of the resident body
constexpr int MAX_LOADS = 16;    // 16-byte loads a lane of the resident body holds
constexpr int THREADS = 256;     // threads per row of the strided body
constexpr int WARPS = THREADS / 32;

typedef uint16_t bf16_t;         // a bf16 as its raw bits

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16_t v) { return __uint_as_float((uint32_t)v << 16); }

// the code of one value at scale s, in the low byte: v / s clamped to
// [-127, 127] and rounded half to even by adding 1.5 * 2^23, which leaves
// the nearest integer (ties to even, the f32 add's own rounding) in the low
// mantissa bits; the clamp's integer bounds commute with the rounding.  A
// zero v (whose quotient is a zero, code 0) never reaches the division:
// __fdiv_rn takes its slow path for a zero dividend, and the warp holding
// a zero row would take it for every element.  It divides s4 = s / 4
// instead, whose quotient is exactly 0.25, code 0 as well
__device__ __forceinline__ uint32_t code(float v, float s, float s4) {
  const float t = fminf(fmaxf(__fdiv_rn(v == 0.f ? s4 : v, s), -127.f), 127.f);
  return __float_as_uint(__fadd_rn(t, 12582912.0f));
}

// the low bytes of four codes in one word, a's lowest
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// the row's scale; a zero row's (1e-12) without the division's slow path
__device__ __forceinline__ float row_scale(float absmax) {
  return absmax == 0.f ? 1e-12f : fmaxf(__fdiv_rn(absmax, 127.0f), 1e-12f);
}

// one 16-byte chunk: its E values widened to f32, and the store of its E codes
template <typename T> struct Chunk;

template <> struct Chunk<float> {
  static constexpr int E = 4;
  static __device__ __forceinline__ void load(const void* p, float (&v)[E]) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
  static __device__ __forceinline__ void store(int8_t* p, const float (&v)[E], float s,
                                               float s4) {
    *reinterpret_cast<uint32_t*>(p) =
        pack4(code(v[0], s, s4), code(v[1], s, s4), code(v[2], s, s4), code(v[3], s, s4));
  }
};

template <> struct Chunk<bf16_t> {
  static constexpr int E = 8;
  static __device__ __forceinline__ void load(const void* p, float (&v)[E]) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);             // the low half: element 2i
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);  // the high half: 2i + 1
    }
  }
  static __device__ __forceinline__ void store(int8_t* p, const float (&v)[E], float s,
                                               float s4) {
    uint2 out;
    out.x = pack4(code(v[0], s, s4), code(v[1], s, s4), code(v[2], s, s4), code(v[3], s, s4));
    out.y = pack4(code(v[4], s, s4), code(v[5], s, s4), code(v[6], s, s4), code(v[7], s, s4));
    *reinterpret_cast<uint2*>(p) = out;
  }
};

// T: float or bf16_t.  V: the 16-byte loads a lane holds, ceil(chunks / 32).
template <typename T, int V>
__global__ void __launch_bounds__(ROWS * 32)
quantize_rows_resident(const T* __restrict__ x, int8_t* __restrict__ q,
                       float* __restrict__ scale, int n, int d) {
  constexpr int E = Chunk<T>::E;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * ROWS + (threadIdx.x >> 5);
  if (row >= n) return;                  // the whole warp: no shuffle is left waiting
  const int chunks = d / E;
  const T* __restrict__ xr = x + row * d;

  float v[V][E];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = lane + 32 * i;
    if (c < chunks) {
      Chunk<T>::load(xr + (size_t)c * E, v[i]);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) v[i][e] = 0.f;
    }
  }
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i)
#pragma unroll
    for (int e = 0; e < E; ++e) m = fmaxf(m, fabsf(v[i][e]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  const float s = row_scale(m);
  if (lane == 0) scale[row] = s;

  const float s4 = 0.25f * s;            // exact: s >= 1e-12 is a normal float
  int8_t* __restrict__ qr = q + row * d;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = lane + 32 * i;
    if (c < chunks) Chunk<T>::store(qr + (size_t)c * E, v[i], s, s4);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
quantize_rows_strided(const T* __restrict__ x, int8_t* __restrict__ q,
                      float* __restrict__ scale, int d) {
  const size_t row = blockIdx.x;
  const T* __restrict__ xr = x + row * d;
  int8_t* __restrict__ qr = q + row * d;
  __shared__ float warp_max[WARPS];
  __shared__ float shared_scale;

  float m = 0.f;
  for (int j = threadIdx.x; j < d; j += THREADS) m = fmaxf(m, fabsf(widen(xr[j])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    float mm = warp_max[0];
#pragma unroll
    for (int i = 1; i < WARPS; ++i) mm = fmaxf(mm, warp_max[i]);
    const float s = row_scale(mm);
    shared_scale = s;
    scale[row] = s;
  }
  __syncthreads();

  const float s = shared_scale, s4 = 0.25f * s;
  for (int j = threadIdx.x; j < d; j += THREADS) qr[j] = (int8_t)code(widen(xr[j]), s, s4);
}

// the resident body with V = loads, found by recursion over 1..MAX_LOADS
template <typename T, int V>
int launch_resident(const T* x, int8_t* q, float* scale, int n, int d, int loads,
                    cudaStream_t s) {
  if constexpr (V < MAX_LOADS) {
    if (loads != V) return launch_resident<T, V + 1>(x, q, scale, n, d, loads, s);
  }
  quantize_rows_resident<T, V><<<(n + ROWS - 1) / ROWS, ROWS * 32, 0, s>>>(x, q, scale, n, d);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, int8_t* q, float* scale, int n, int d, int loads, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  if (loads == 0) {
    quantize_rows_strided<T><<<n, THREADS, 0, s>>>(xt, q, scale, d);
    return (int)cudaGetLastError();
  }
  // the resident body takes whole, aligned 16-byte chunks, ceil(chunks / 32) a lane
  const long long row_bytes = (long long)d * sizeof(T);
  const long long chunks = row_bytes / 16;
  if (row_bytes % 16 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      loads != (chunks + 31) / 32 || loads > MAX_LOADS)
    return (int)cudaErrorInvalidValue;
  return launch_resident<T, 1>(xt, q, scale, n, d, loads, s);
}

}  // namespace

extern "C" {

int quantize_rows_max_loads() { return MAX_LOADS; }

// x (n, d) contiguous, f32 (dtype 0) or bf16 (dtype 1, raw 16-bit words).
// loads: the resident body's 16-byte loads a lane (1..MAX_LOADS, which must
// be ceil(d * size / 16 / 32) with x 16-byte aligned and d * size a multiple
// of 16), or 0 for the strided body.  Launches on ``stream`` and returns
// cudaGetLastError() (0 on success).
int quantize_rows(const void* x, int8_t* q, float* scale, int n, int d, int dtype, int loads,
                  void* stream) {
  if (n <= 0 || d <= 0 || loads < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, q, scale, n, d, loads, s);
  if (dtype == 1) return launch<bf16_t>(x, q, scale, n, d, loads, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
