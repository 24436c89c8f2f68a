// Blocked GEMM for Hopper, sm_90a: c (M, N) = a (M, K) @ b (K, N) with an f32
// accumulator, the result cast once to c's type.
//
// Replaces the TPU Pallas body `matmul_kernel` in
// src/repro/kernels/matmul/kernel.py:21 (reached through `matmul_pallas`,
// :34): the same function, `jnp.dot(a, b, preferred_element_type=f32)` cast to
// `out_dtype`. In the port it computes the GEMM of the survey's im2col
// convolution (repro_torch/models/conv.py, `conv_im2col`).
//
// Layouts (all contiguous, row-major): a (M, K), b (K, N), c (M, N). Types: a
// and b both f32 or both bf16; c f32 or bf16. bf16 is converted to f32 as it
// is loaded, so every product and sum is an f32 FMA, as the reference's
// preferred_element_type=f32. f32 stays IEEE f32: no TF32, no tensor cores.
//
// Grid. The TPU grid (M/bm, N/bn, K/bk) runs in order on one core and carries
// the f32 accumulator in VMEM scratch across its k axis; its blocks must
// divide the dims. On Hopper blocks run in parallel and in no order, so one
// block owns one 128 x 64 output tile and loops itself over K in 16-deep
// tiles. Tiles are sized for the im2col shapes, where N (the output channels)
// is 64: a 256-wide tile would waste three quarters of its work. Blocks along
// M are consecutive, so the few B tiles stay in L2. Ragged edges: M, N and K
// need not divide any tile; rows, columns and k past the edge are loaded as
// zeros in BOTH operands (so no stale shared memory enters a sum) and never
// stored.
//
// Bound. At the im2col shapes the GEMM does 2 M N K flops on (M K + K N + M
// N) elements: for f32 on the CUDA cores the floor is the flops over the
// FP32 peak (67 TFLOP/s); in bf16 over the tensor cores' 989 TFLOP/s it is
// the bytes.
//
// Design for that bound, first version (simple and right; no cp.async, TMA,
// mma or wgmma yet, so bf16 also runs at the f32 FMA rate): 128 threads as a
// 16 x 8 grid, each thread owning an 8 x 8 register tile (rows 4ty..+3 and
// 64+4ty..+3, columns 4tx..+3 and 32+4tx..+3), so each k step reads four
// float4 from shared memory for 64 FMAs. A is stored k-major (transposed) in
// shared memory with rows padded by 4 floats, so the float4 reads stay
// aligned and the transposing stores meet at most two-way bank conflicts;
// two shared-memory buffers with a register prefetch: the next tile's global
// loads are in flight while the current tile is multiplied, one barrier a
// tile.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBM = 128;            // output rows per block
constexpr int kBN = 64;             // output columns per block
constexpr int kBK = 16;             // k per shared-memory tile
constexpr int kThreads = 128;       // 16 x 8 threads, 8 x 8 outputs each
constexpr int kLA = kBM + 4;        // A tile row stride (floats)
constexpr int kAPer = kBM * kBK / kThreads;   // A elements a thread loads: 16
constexpr int kBPer = kBK * kBN / kThreads;   // B elements a thread loads: 8

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads)
matmul_kernel(const Tin* __restrict__ a, const Tin* __restrict__ b,
              Tout* __restrict__ c, int M, int N, int K) {
  __shared__ __align__(16) float a_s[2][kBK][kLA];   // [k][m]
  __shared__ __align__(16) float b_s[2][kBK][kBN];   // [k][n]

  const int tid = threadIdx.x;
  const int tx = tid % 8;
  const int ty = tid / 8;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  // global loads, k fastest for A and n fastest for B (coalesced): A element
  // (a_row + 8r, a_col) and B element (b_row + 2r, b_col) of the tile
  const int a_col = tid % kBK;
  const int a_row = tid / kBK;
  const int b_col = tid % kBN;
  const int b_row = tid / kBN;
  float ra[kAPer], rb[kBPer];

  auto fetch = [&](int k0) {
    const int ka = k0 + a_col;
#pragma unroll
    for (int r = 0; r < kAPer; ++r) {
      const int row = m0 + a_row + 8 * r;
      ra[r] = row < M && ka < K
                  ? to_f32(a[static_cast<int64_t>(row) * K + ka]) : 0.f;
    }
    const int nb = n0 + b_col;
#pragma unroll
    for (int r = 0; r < kBPer; ++r) {
      const int kb = k0 + b_row + 2 * r;
      rb[r] = kb < K && nb < N
                  ? to_f32(b[static_cast<int64_t>(kb) * N + nb]) : 0.f;
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int r = 0; r < kAPer; ++r) a_s[buf][a_col][a_row + 8 * r] = ra[r];
#pragma unroll
    for (int r = 0; r < kBPer; ++r) b_s[buf][b_row + 2 * r][b_col] = rb[r];
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int n_k = (K + kBK - 1) / kBK;
  if (n_k > 0) {
    fetch(0);
    stash(0);
  }
  __syncthreads();
  for (int t = 0; t < n_k; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_k) fetch((t + 1) * kBK);     // in flight during the FMAs
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&a_s[buf][k][4 * ty]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&a_s[buf][k][64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&b_s[buf][k][4 * tx]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&b_s[buf][k][32 + 4 * tx]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    // the other buffer's last readers passed the previous barrier
    if (t + 1 < n_k) stash(buf ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (row >= M) continue;
    Tout* c_row = c + static_cast<int64_t>(row) * N;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + (j < 4 ? 4 * tx + j : 32 + 4 * tx + j - 4);
      if (col < N) store(c_row + col, acc[i][j]);
    }
  }
}

template <typename Tin, typename Tout>
int launch(const void* a, const void* b, void* c, int M, int N, int K,
           cudaStream_t stream) {
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  matmul_kernel<Tin, Tout><<<grid, kThreads, 0, stream>>>(
      static_cast<const Tin*>(a), static_cast<const Tin*>(b),
      static_cast<Tout*>(c), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tin>
int dispatch_out(const void* a, const void* b, void* c, int M, int N, int K,
                 int out_dtype, cudaStream_t s) {
  if (out_dtype == 0) return launch<Tin, float>(a, b, c, M, N, K, s);
  if (out_dtype == 1) return launch<Tin, __nv_bfloat16>(a, b, c, M, N, K, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// a (M, K), b (K, N), c (M, N), all contiguous and row-major. in_dtype (a and
// b) and out_dtype (c): 0 = f32, 1 = bf16. M and the tile counts fit the
// grid: M < 2^31, N <= 65535 * 64. Launches on `stream` and returns the
// launch's CUDA error code (0 = launched). K = 0 writes zeros.
extern "C" int matmul_f32acc(const void* a, const void* b, void* c,
                             long long M, long long N, long long K,
                             int in_dtype, int out_dtype, void* stream) {
  if (M == 0 || N == 0) return 0;
  if (M < 0 || N < 0 || K < 0 || M > INT32_MAX || K > INT32_MAX ||
      (N + kBN - 1) / kBN > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = static_cast<int>(M), n = static_cast<int>(N),
            k = static_cast<int>(K);
  if (in_dtype == 0) return dispatch_out<float>(a, b, c, m, n, k, out_dtype, s);
  if (in_dtype == 1)
    return dispatch_out<__nv_bfloat16>(a, b, c, m, n, k, out_dtype, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
