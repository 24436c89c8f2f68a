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
// and b both f32 or both bf16; c f32 or bf16. The entry point dispatches by
// the input type to one of two kernels.
//
// Grid (both kernels). The TPU grid (M/bm, N/bn, K/bk) runs in order on one
// core and carries the f32 accumulator in VMEM scratch across its k axis; its
// blocks must divide the dims. On Hopper blocks run in parallel and in no
// order, so one block owns one 128 x 64 output tile and loops itself over K.
// Tiles are sized for the im2col shapes, where N (the output channels) is 64:
// one block covers all of N, so each A row is read once, and a 256-wide tile
// would waste three quarters of its work. Blocks along M are consecutive, so
// the few B tiles stay in L2. Ragged edges: M, N and K need not divide any
// tile; rows, columns and k past the edge are loaded as zeros in BOTH
// operands (so no stale shared memory enters a sum) and never stored.
//
// Bound. At the im2col shapes the GEMM does 2 M N K flops on (M K + K N + M
// N) elements: for f32 on the CUDA cores the floor is the flops over the
// FP32 peak (67 TFLOP/s); in bf16 over the tensor cores' 989 TFLOP/s it is
// the bytes (A's M K elements, read once).
//
// bf16: `matmul_bf16_kernel`, on the tensor cores. Four warps, each owning 32
// rows x 64 columns of the tile (2 x 8 mma.sync.m16n8k16 accumulators: bf16
// in, f32 accumulate, 64 f32 registers a thread). A and B tiles 64 deep sit
// in a 4-stage ring in shared memory, filled with 16-byte cp.async (the
// zero-fill form past M, N and K): three stages are in flight while one is
// multiplied (72 KB a block, two blocks an SM), one barrier a tile. 64 deep
// gives each A row 128 contiguous bytes a stage (32 deep, 64 bytes, moved
// markedly fewer bytes a second from device memory). A fragments come from
// ldmatrix, B fragments from ldmatrix.trans (B is row-major, k along rows);
// rows are padded by 16 bytes (an odd multiple of 16 bytes a row), so the 8
// rows of every ldmatrix fall on distinct banks. Where K (for A) or N (for B)
// is not a multiple of 8, or the base is not 16-byte aligned, rows are not
// 16-byte aligned and that operand takes a masked scalar loader into the same
// ring. Numerics: products of bf16 values are exact in f32 and sums are f32,
// as preferred_element_type=f32; the sums run in another order than the f32
// plain version's.
//
// f32: `matmul_kernel`, on the CUDA cores, IEEE f32: no TF32 and no tensor
// cores, as the reference's f32 accumulator and the survey's §4.3 accuracy
// comparison need. 128 threads as a 16 x 8 grid (tx = tid % 8, ty = tid /
// 8), each thread owning an 8 x 8 register tile: rows 4ty..4ty+3 and
// 64+4ty..64+4ty+3, columns 4tx..4tx+3 and 32+4tx..32+4tx+3. A and B tiles
// 32 deep sit in a 4-stage ring in shared memory, filled with 16-byte
// cp.async (the zero-fill form past M, N and K): three stages are in
// flight while one is multiplied, one barrier a tile; no register staging,
// no transposing stores. Both tiles stay row-major: A (128 rows of 32
// floats, k fastest), B (32 rows of 64 floats). For each 4 k a thread
// reads its 8 A rows as one float4 each (A[row][k..k+3]) and the 4 B rows
// as two float4 each: 16 LDS.128 for 256 FMAs. Bank argument: a 128-bit
// shared load is served a quarter-warp (8 lanes) at a time, and the 8
// lanes of a quarter-warp share ty and run tx = 0..7. On A they read one
// address (the same row and k): a broadcast. On B they read 8 consecutive
// float4 of one row (columns 4tx, or 32 + 4tx): 128 contiguous bytes on 32
// distinct banks. So neither tile needs padding, and the cp.async stores,
// 8 consecutive 16-byte chunks a quarter-warp (one 128-byte A row, half a
// 256-byte B row), are conflict-free too. 96 KB of stages a block: two
// blocks an SM (ptxas gives 165 registers, room for three), so Table 6's
// 3x3 im2col GEMM (1458 tiles of 128 rows) runs in 5.5 waves on 132 SMs
// and its 13x13 one (968 tiles) in 3.7. (Timed on an H100: 16-deep stages,
// 3 or 6 stages, and a layout that pads A's rows and interleaves each
// thread's rows so a warp's four A rows fall on distinct banks were each
// as fast or slower at both shapes.) Where K (for A) or N (for B) is not a
// multiple of 4, or the base is not 16-byte aligned, rows are not 16-byte
// aligned and that operand takes a masked scalar loader into the same ring
// (the bf16 kernel's a_vec / b_vec). The sum keeps its order: each output
// is fmaf over k = 0, 1, ..., K - 1 ascending (plus fmaf(0, 0, acc) past
// K, which adds nothing), exactly as the register-staged kernel it
// replaced summed, so its output is the same bit for bit. The epilogue
// stores 4 columns at once where N % 4 == 0 and c is aligned.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "../../csrc/sm90_mma.cuh"

namespace {

constexpr int kBM = 128;            // output rows per block
constexpr int kBN = 64;             // output columns per block

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// ------------------------------------------------------------------ f32
constexpr int kBK = 32;             // k per stage
constexpr int kStages = 4;          // the cp.async ring
constexpr int kThreads = 128;       // 16 x 8 threads, 8 x 8 outputs each
constexpr int kStage = kBM * kBK + kBK * kBN;     // floats a stage: A | B
constexpr int kSmem = kStages * kStage * static_cast<int>(sizeof(float));

// four consecutive columns of a row, `p` aligned to four elements
__device__ __forceinline__ void store4(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&x)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x[0], x[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x[2], x[3]);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                 *reinterpret_cast<const uint32_t*>(&hi));
}

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// a_vec / b_vec: that operand's rows are 16-byte aligned (K, resp. N, a
// multiple of 4 and the base aligned), so it is loaded with cp.async; c_vec:
// N % 4 == 0 and c aligned to four elements.
template <typename Tout>
__global__ void __launch_bounds__(kThreads)
matmul_kernel(const float* __restrict__ a, const float* __restrict__ b,
              Tout* __restrict__ c, int M, int N, int K, int a_vec, int b_vec,
              int c_vec) {
  extern __shared__ uint4 smem_f32[];
  float* ring = reinterpret_cast<float*>(smem_f32);   // [stage][A | B]
  const int tid = threadIdx.x;
  const int tx = tid % 8;
  const int ty = tid / 8;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  // stage `st` <- A[m0.., k0..k0+kBK-1] and B[k0..k0+kBK-1, n0..]
  auto load = [&](int st, int k0) {
    float* a_s = ring + st * kStage;
    float* b_s = a_s + kBM * kBK;
    if (a_vec) {
#pragma unroll
      for (int it = 0; it < kBM * kBK / 4 / kThreads; ++it) {
        const int i = tid + it * kThreads;
        const int r = i / (kBK / 4), cc = (i % (kBK / 4)) * 4;
        const int row = m0 + r, kk = k0 + cc;
        const bool ok = row < M && kk < K;
        cp_async16(smem_u32(a_s + r * kBK + cc),
                   ok ? a + static_cast<int64_t>(row) * K + kk : a, ok);
      }
    } else {
      for (int i = tid; i < kBM * kBK; i += kThreads) {
        const int r = i / kBK, cc = i % kBK;
        const int row = m0 + r, kk = k0 + cc;
        a_s[r * kBK + cc] =
            row < M && kk < K ? a[static_cast<int64_t>(row) * K + kk] : 0.f;
      }
    }
    if (b_vec) {
#pragma unroll
      for (int it = 0; it < kBK * kBN / 4 / kThreads; ++it) {
        const int i = tid + it * kThreads;
        const int r = i / (kBN / 4), cc = (i % (kBN / 4)) * 4;
        const int kk = k0 + r, col = n0 + cc;
        const bool ok = kk < K && col < N;
        cp_async16(smem_u32(b_s + r * kBN + cc),
                   ok ? b + static_cast<int64_t>(kk) * N + col : b, ok);
      }
    } else {
      for (int i = tid; i < kBK * kBN; i += kThreads) {
        const int r = i / kBN, cc = i % kBN;
        const int kk = k0 + r, col = n0 + cc;
        b_s[r * kBN + cc] =
            kk < K && col < N ? b[static_cast<int64_t>(kk) * N + col] : 0.f;
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // the thread's A rows in the tile: 4ty.. and 64 + 4ty..
  const int a_off = 4 * ty * kBK;
  const int n_k = (K + kBK - 1) / kBK;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_k) load(st, st * kBK);
    cp_async_commit();
  }
  for (int t = 0; t < n_k; ++t) {
    // tile t has landed, and every thread is done with tile t - 1, whose
    // stage the next loads overwrite
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nt = t + kStages - 1;
    if (nt < n_k) load(nt % kStages, nt * kBK);
    cp_async_commit();

    const float* a_s = ring + (t % kStages) * kStage + a_off;
    const float* b_s = ring + (t % kStages) * kStage + kBM * kBK + 4 * tx;
#pragma unroll
    for (int k4 = 0; k4 < kBK; k4 += 4) {
      float4 av[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        av[i] = *reinterpret_cast<const float4*>(
            a_s + ((i / 4) * 64 + i % 4) * kBK + k4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* b_row = b_s + (k4 + kk) * kBN;
        const float4 b0 = *reinterpret_cast<const float4*>(b_row);
        const float4 b1 = *reinterpret_cast<const float4*>(b_row + 32);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float ai = lane_of(av[i], kk);
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ai, bv[j], acc[i][j]);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i / 4) * 64 + 4 * ty + i % 4;
    if (row >= M) continue;
    Tout* c_row = c + static_cast<int64_t>(row) * N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + 32 * h + 4 * tx;
      const float x[4] = {acc[i][4 * h], acc[i][4 * h + 1],
                          acc[i][4 * h + 2], acc[i][4 * h + 3]};
      if (c_vec) {
        if (col < N) store4(c_row + col, x);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < N) store(c_row + col + j, x[j]);
      }
    }
  }
}

// ----------------------------------------------------------------- bf16
using bf16 = __nv_bfloat16;

constexpr int kTcBK = 64;                   // k per stage
constexpr int kTcStages = 4;
constexpr int kTcThreads = 128;             // 4 warps, 32 rows each
constexpr int kTcLA = kTcBK + 8;            // A stage row stride (bf16): 144 B
constexpr int kTcLB = kBN + 8;              // B stage row stride: 144 B
constexpr int kTcStage = kBM * kTcLA + kTcBK * kTcLB;   // bf16 a stage
constexpr int kTcSmem = kTcStages * kTcStage * static_cast<int>(sizeof(bf16));

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// a_vec / b_vec: that operand's rows are 16-byte aligned (K, resp. N, a
// multiple of 8 and the base aligned), so it is loaded with cp.async.
template <typename Tout>
__global__ void __launch_bounds__(kTcThreads)
matmul_bf16_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
                   Tout* __restrict__ c, int M, int N, int K, int a_vec,
                   int b_vec) {
  extern __shared__ uint4 smem_tc[];
  bf16* ring = reinterpret_cast<bf16*>(smem_tc);   // [stage][A | B]
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;          // the fragment's row (and row + 8)
  const int tig = lane % 4;        // its column pair
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const bf16 zero = __float2bfloat16_rn(0.f);

  // stage `st` <- A[m0.., k0..k0+kTcBK-1] and B[k0..k0+kTcBK-1, n0..]
  auto load = [&](int st, int k0) {
    bf16* a_s = ring + st * kTcStage;
    bf16* b_s = a_s + kBM * kTcLA;
    if (a_vec) {
#pragma unroll
      for (int it = 0; it < kBM * kTcBK / 8 / kTcThreads; ++it) {
        const int i = tid + it * kTcThreads;
        const int r = i / (kTcBK / 8), cc = (i % (kTcBK / 8)) * 8;
        const int row = m0 + r, kk = k0 + cc;
        const bool ok = row < M && kk < K;
        cp_async16(smem_u32(a_s + r * kTcLA + cc),
                   ok ? a + static_cast<int64_t>(row) * K + kk : a, ok);
      }
    } else {
      for (int i = tid; i < kBM * kTcBK; i += kTcThreads) {
        const int r = i / kTcBK, cc = i % kTcBK;
        const int row = m0 + r, kk = k0 + cc;
        a_s[r * kTcLA + cc] =
            row < M && kk < K ? a[static_cast<int64_t>(row) * K + kk] : zero;
      }
    }
    if (b_vec) {
#pragma unroll
      for (int it = 0; it < kTcBK * kBN / 8 / kTcThreads; ++it) {
        const int i = tid + it * kTcThreads;
        const int r = i / (kBN / 8), cc = (i % (kBN / 8)) * 8;
        const int kk = k0 + r, col = n0 + cc;
        const bool ok = kk < K && col < N;
        cp_async16(smem_u32(b_s + r * kTcLB + cc),
                   ok ? b + static_cast<int64_t>(kk) * N + col : b, ok);
      }
    } else {
      for (int i = tid; i < kTcBK * kBN; i += kTcThreads) {
        const int r = i / kBN, cc = i % kBN;
        const int kk = k0 + r, col = n0 + cc;
        b_s[r * kTcLB + cc] =
            kk < K && col < N ? b[static_cast<int64_t>(kk) * N + col] : zero;
      }
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      acc[mi][j][0] = acc[mi][j][1] = acc[mi][j][2] = acc[mi][j][3] = 0.f;

  // per-lane ldmatrix offsets (bf16) within a stage's A and B tiles
  const int a_off = (32 * warp + lane % 16) * kTcLA + (lane / 16) * 8;
  const int b_off = (((lane / 8) % 2) * 8 + lane % 8) * kTcLB + (lane / 16) * 8;

  const int n_k = (K + kTcBK - 1) / kTcBK;
#pragma unroll
  for (int st = 0; st < kTcStages - 1; ++st) {
    if (st < n_k) load(st, st * kTcBK);
    cp_async_commit();
  }
  for (int t = 0; t < n_k; ++t) {
    // tile t has landed, and every warp is done with tile t - 1, whose
    // stage the next loads overwrite
    cp_async_wait<kTcStages - 2>();
    __syncthreads();
    const int nt = t + kTcStages - 1;
    if (nt < n_k) load(nt % kTcStages, nt * kTcBK);
    cp_async_commit();

    const bf16* a_s = ring + (t % kTcStages) * kTcStage;
    const uint32_t a_base = smem_u32(a_s + a_off);
    const uint32_t b_base = smem_u32(a_s + kBM * kTcLA + b_off);
#pragma unroll
    for (int ks = 0; ks < kTcBK / 16; ++ks) {
      uint32_t af[2][4], bfr[4][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_x4(af[mi], a_base + (16 * mi * kTcLA + 16 * ks) * 2);
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
        ldsm_x4_trans(bfr[nj], b_base + (16 * ks * kTcLB + 16 * nj) * 2);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
          mma_bf16(acc[mi][2 * nj], af[mi], bfr[nj][0], bfr[nj][1]);
          mma_bf16(acc[mi][2 * nj + 1], af[mi], bfr[nj][2], bfr[nj][3]);
        }
    }
  }
  cp_async_wait<0>();

  // accumulator (mi, j): rows 32 warp + 16 mi + g (+ 8), columns 8 j + 2 tig
  // (+ 1); column pairs are stored together where N is even (aligned)
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + 32 * warp + 16 * mi + g + 8 * r;
      if (row >= M) continue;
      Tout* c_row = c + static_cast<int64_t>(row) * N;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + 8 * j + 2 * tig;
        const float x = acc[mi][j][2 * r], y = acc[mi][j][2 * r + 1];
        if (N % 2 == 0 && col < N) {
          store2(c_row + col, x, y);
        } else {
          if (col < N) store(c_row + col, x);
          if (col + 1 < N) store(c_row + col + 1, y);
        }
      }
    }
}

template <typename Tout>
int launch_f32(const void* a, const void* b, void* c, int M, int N, int K,
               cudaStream_t stream) {
  auto kern = matmul_kernel<Tout>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int a_vec =
      K % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 ? 1 : 0;
  const int b_vec =
      N % 4 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0 ? 1 : 0;
  const int c_vec =
      N % 4 == 0 && reinterpret_cast<uintptr_t>(c) % (4 * sizeof(Tout)) == 0
          ? 1 : 0;
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  kern<<<grid, kThreads, kSmem, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<Tout*>(c), M, N, K, a_vec, b_vec, c_vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tout>
int launch_bf16(const void* a, const void* b, void* c, int M, int N, int K,
                cudaStream_t stream) {
  auto kern = matmul_bf16_kernel<Tout>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int a_vec =
      K % 8 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 ? 1 : 0;
  const int b_vec =
      N % 8 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0 ? 1 : 0;
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  kern<<<grid, kTcThreads, kTcSmem, stream>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b),
      static_cast<Tout*>(c), M, N, K, a_vec, b_vec);
  return static_cast<int>(cudaGetLastError());
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
      (N + kBN - 1) / kBN > 65535 || (in_dtype != 0 && in_dtype != 1) ||
      (out_dtype != 0 && out_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = static_cast<int>(M), n = static_cast<int>(N),
            k = static_cast<int>(K);
  if (in_dtype == 0)
    return out_dtype == 0 ? launch_f32<float>(a, b, c, m, n, k, s)
                          : launch_f32<bf16>(a, b, c, m, n, k, s);
  return out_dtype == 0 ? launch_bf16<float>(a, b, c, m, n, k, s)
                        : launch_bf16<bf16>(a, b, c, m, n, k, s);
}
