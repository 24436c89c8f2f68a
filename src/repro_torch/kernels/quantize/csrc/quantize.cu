// Block-scaled integer quantizers for Hopper, sm_90a: kernels B8 and B9.
//
// Replace the TPU Pallas bodies `quantize_nearest_kernel` (B8,
// src/repro/kernels/quantize/kernel.py:38) and `quantize_kernel` (B9, :25),
// both reached through `quantize_pallas` (:51). They compute the same
// function: the flat f32 input is cut into rows of 256 values; each row gets
// one scale, amax / maxq (1.0 for an all-zero row), with maxq = 2^(bits-1) - 1;
// each value y = x / scale is rounded half to even (B8) or stochastically,
// floor(y) + (u < y - floor(y)) with u the caller's uniform noise (B9), then
// clipped to [-maxq - 1, maxq] and stored as int8.
//
// Arithmetic. The scale is a true IEEE division amax / maxq, as
// `quantize_blocks_ref` and `core/compression.quantize_int` compute it (the
// Pallas kernel in interpret mode multiplies by 1/maxq, which differs by one
// ulp in about 1 row in 16), and so is x / scale; this file must not be
// built with --use_fast_math. maxq is a runtime argument, so bits 8 and 4
// share one build. The row maximum propagates NaN (max.NaN), as jnp.max and
// torch.amax do.
//
// Ragged length. The kernel takes the flat length n and reads zeros past
// it, so the wrapper makes no padded copy of a gradient leaf; the rows past
// n quantize as the reference's zero padding does. The noise operand covers
// every row in full, (rows, 256), as the reference draws it.
//
// Bound. One pass over memory: per value 4 bytes of x, 4 of noise (B9
// only), 1 of q, plus 4 bytes of scale per row, and ~10 flops: far below
// the card's flop/byte ratio, so the floor is the bytes over 3.35 TB/s
// (about 0.97 ms for B9 on the largest yi-9b gradient leaf, 360.7 M values).
//
// Design for that bound: one warp per row, 8 rows per 256-thread block,
// lane l owning values 8l..8l+7 of its row, loaded as two 16-byte vectors
// of x (and of noise) with streaming loads (read once); a shuffle max over
// the warp gives the row's amax; each lane stores its 8 int8 values as one
// 8-byte word, and lane 0 writes the row's scale. No shared memory.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 256;               // values per row, one scale each
constexpr int kPerLane = kBlock / 32;     // 8
constexpr int kWarps = 8;                 // rows per thread block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ void load8(const float* __restrict__ p, float v[8]) {
  const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
  const float4 b = __ldcs(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

template <bool kStochastic>
__global__ void __launch_bounds__(kWarps * 32)
quantize_rows_kernel(const float* __restrict__ x,
                     const float* __restrict__ noise,
                     int8_t* __restrict__ q, float* __restrict__ scales,
                     long long n, long long rows, float maxq) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const long long i0 = row * kBlock + lane * kPerLane;

  float v[kPerLane];
  if (i0 + kPerLane <= n) {
    load8(x + i0, v);
  } else {
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) v[j] = (i0 + j < n) ? x[i0 + j] : 0.0f;
  }
  float amax = 0.0f;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) amax = max_nan(amax, fabsf(v[j]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = max_nan(amax, __shfl_xor_sync(kFull, amax, off));
  const float scale = (amax == 0.0f) ? 1.0f : amax / maxq;

  float u[kPerLane];
  if (kStochastic) load8(noise + i0, u);
  const float lo_clip = -maxq - 1.0f;
  unsigned long long packed = 0;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const float y = v[j] / scale;
    float r;
    if (kStochastic) {
      const float lo = floorf(y);
      r = lo + ((u[j] < y - lo) ? 1.0f : 0.0f);
    } else {
      r = rintf(y);                          // half to even, as jnp.round
    }
    r = fminf(fmaxf(r, lo_clip), maxq);
    const auto byte = static_cast<uint8_t>(static_cast<int8_t>(
        static_cast<int>(r)));
    packed |= static_cast<unsigned long long>(byte) << (8 * j);
  }
  *reinterpret_cast<unsigned long long*>(q + i0) = packed;
  if (lane == 0) scales[row] = scale;
}

}  // namespace

// x: n f32 values; noise: (rows, 256) f32 uniform [0, 1), read only when
// stochastic != 0; q: (rows, 256) int8; scales: rows f32; rows = ceil(n/256).
// x, noise and q start on 16-byte boundaries. Launches on `stream` and
// returns the launch's CUDA error code (0 on success).
extern "C" int quantize_rows(const void* x, const void* noise, void* q,
                             void* scales, long long n, long long rows,
                             float maxq, int stochastic, void* stream) {
  if (rows == 0 && n == 0) return 0;
  if (n <= (rows - 1) * kBlock || n > rows * kBlock || !(maxq >= 1.0f) ||
      maxq > 127.0f || (stochastic && noise == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* uf = static_cast<const float*>(noise);
  int8_t* qi = static_cast<int8_t*>(q);
  float* sf = static_cast<float*>(scales);
  if (stochastic)
    quantize_rows_kernel<true><<<grid, kWarps * 32, 0, s>>>(xf, uf, qi, sf, n,
                                                            rows, maxq);
  else
    quantize_rows_kernel<false><<<grid, kWarps * 32, 0, s>>>(xf, uf, qi, sf,
                                                             n, rows, maxq);
  return static_cast<int>(cudaGetLastError());
}
