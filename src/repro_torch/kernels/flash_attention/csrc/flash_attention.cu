// Flash attention forward (causal, sliding window, GQA) for Hopper, sm_90a.
//
// Replaces the TPU Pallas body `flash_kernel` in
// src/repro/kernels/flash_attention/kernel.py:27 (reached through
// `flash_attention_pallas`, :81). It computes the same function: softmax
// attention of each query row over the keys its mask admits (causal: key
// position <= query position; with a window w also key position > query
// position - w), with the online softmax in f32 and a final division by
// max(l, 1e-30), so the (S x S) score matrix never exists in device memory.
// It also writes the row log-sum-exp, m + log(l), that the backward pass
// (ops.py, `attention_backward`) reads.
//
// Layouts (all contiguous, 16-byte aligned): q and out (B, S, H, hd); k and v
// (B, S, Hkv, hd); lse (B, H, S) f32. Head dims: any multiple of 8 up to 256
// (the paged kernels' rule); the true hd is passed at run time and columns
// past it are zero-filled on load (zeros add nothing to q.k, and their p.v
// columns are never stored). GQA: query head h reads kv head h / (H / Hkv)
// in place (the TPU wrapper repeats K/V in device memory first, ops.py:26-28;
// here nothing is copied). Types: f32 or bf16, one type for q/k/v/out; the
// entry point dispatches by type to one of two kernels.
//
// Grid (both kernels). The TPU grid (BH, S/bq, S/bk) runs in order on one
// core and carries (m, l, acc) in VMEM scratch across its innermost kv axis,
// skipping the tiles its `needed` test rules out. On Hopper blocks run in
// parallel and in no order, so one block owns one (batch, head, 64-row query
// tile) and loops itself over only the keys that tile needs: from
// max(0, q0 - w + 1) under a window (the window's reach) to the tile's last
// row under the causal mask (the diagonal), never a fully masked tile. Blocks
// are numbered so that the longest query tiles (the last ones under the
// causal mask) start first. Ragged edges: S need not divide by any tile; rows
// and keys at or past S are zero-filled on load, masked, and never written.
//
// Bound. Training attention does 4 * hd flops per admitted (query, key) pair
// (q.k and p.v) against hd * itemsize bytes per row read once, so at S = 4096
// it sits far above the card's flop/byte ratio: the floor is the operations
// over the tensor cores' peak (0.28 ms at B=2, H=32, hd=128, bf16, causal,
// against 0.05 ms for its ~152 MB).
//
// bf16: `flash_fwd_bf16`, an FA2-style forward on the tensor cores. Four
// warps, each owning 16 query rows (the M of mma.sync.m16n8k16: bf16 in, f32
// accumulate). K and V tiles of 32 keys are double-buffered in shared memory
// with 16-byte cp.async (the zero-fill form for rows past S and columns past
// hd), so the next tile's loads are in flight while the current one is
// multiplied; one barrier a tile. Rows are padded by 16 bytes (an odd
// multiple of 16 bytes a row), so the 8 rows of every ldmatrix fall on
// distinct banks. Q is read once with ldmatrix into A fragments held in
// registers, its tile sharing the second K/V stage (above hd 128 Q keeps a
// tile of its own and is re-read each tile, as O's accumulator then takes up
// to 128 registers a thread). S = Q.K^T accumulates in f32 fragments; the
// online softmax runs in registers on raw scores (row max over the 4 threads
// of a quad by two shuffles; p = 2^(s c - m c), c = scale log2(e), one FFMA
// and one ex2; the row sum is kept per thread and reduced once at the end);
// P is rounded to bf16 pairs in registers and fed straight back as the A
// operand of P.V (the m16n8k16 accumulator layout is the A layout), with V as
// the B operand through ldmatrix.trans. The mask is evaluated only on tiles
// that cut the diagonal, the window's edge or S, and masked keys get p = 0
// explicitly (a row whose first tile is fully masked has m = -1e30, where
// exp(s - m) would give 1). 32-key tiles keep S's accumulator at 16
// registers a thread, so up to hd 128 a thread fits in the 170 registers
// that let three blocks share an SM (64-key tiles needed more, fitting two
// blocks an SM, and ran slower at both training shapes).
// Numerics: products of bf16 values are exact in f32; the one rounding the
// f32 plain version lacks is P to bf16 before P.V (the reference's model
// path, attention.py:92, rounds its probabilities there too); l sums the f32
// p before that rounding. The kernel is instantiated only at the configs'
// head dims (kTcWidths: 64, 80, 128, 256; multiples of 16, the depth of one
// q.k step), each at its own width; any other hd runs at the next of these,
// its columns past hd zero-filled.
//
// f32: `flash_fwd_kernel`, on the CUDA cores (no TF32), so every product
// rounds as the f32 plain version's: the cuda-vs-cpu training parity holds
// losses within 1e-4 a step through it. 256 threads as a 16 x 16 grid;
// thread (ty, tx) owns query rows 4ty..4ty+3 of the tile, keys tx + 16j of
// each key tile and head dims 4tx + 64jj..+3 of the output; the tile width HD
// is hd padded to the next multiple of 64. Q and K rows are padded by 4
// floats so the float4 reads of 8 neighbouring key rows fall on 32 distinct
// banks. q.k and p.v are register-tiled float4 products; the tile's row max
// and sum are shuffle reductions over the 16 threads of a row; p goes
// through a shared-memory tile from the score layout to the p.v layout.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "../../csrc/sm90_mma.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// ------------------------------------------------------------------ f32
constexpr int kBQ = 64;             // query rows per block
constexpr int kThreads = 256;       // 16 x 16 threads

// 8 f32 from device memory into shared memory.
__device__ __forceinline__ void load8(float* dst, const float* src) {
  const float4* s = reinterpret_cast<const float4*>(src);
  float4* d = reinterpret_cast<float4*>(dst);
  d[0] = s[0];
  d[1] = s[1];
}

// Reductions over the 16 threads of one row: lanes (ty % 2) * 16 + tx, so
// xor offsets below 16 stay inside the row. Every lane ends with the same
// value (each pairwise step adds the same two numbers on both lanes).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Copies rows pos0 .. pos0 + ROWS - 1 of one head into an f32 tile of HD
// columns with row stride LD; `base` points at row 0 of that head and
// consecutive rows are `row_stride` elements apart. Rows at or past S and
// columns at or past hd (a multiple of 8) are zero-filled.
template <int HD, int ROWS, int LD>
__device__ __forceinline__ void load_tile(float* dst, const float* base,
                                          int pos0, int S, int64_t row_stride,
                                          int hd) {
  constexpr int kVecs = HD / 8;
  for (int i = threadIdx.x; i < ROWS * kVecs; i += kThreads) {
    const int r = i / kVecs;
    const int c = (i % kVecs) * 8;
    float* d = dst + r * LD + c;
    const int p = pos0 + r;
    if (p < S && c < hd) {
      load8(d, base + p * row_stride + c);
    } else {
      float4* d4 = reinterpret_cast<float4*>(d);
      d4[0] = make_float4(0.f, 0.f, 0.f, 0.f);
      d4[1] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

template <int HD, int BK>
constexpr int smem_floats() {
  return kBQ * (HD + 4) + BK * (HD + 4) + BK * HD + kBQ * (BK + 4);
}

// HD: the padded tile width (a multiple of 64, >= hd); BK: keys per
// shared-memory tile (a multiple of 16).
template <int HD, int BK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int S, int H, int Hkv, int hd,
                 int n_qt, float scale, int causal, int window) {
  constexpr int LQ = HD + 4;        // Q / K tile row stride (floats)
  constexpr int LP = BK + 4;        // P tile row stride
  constexpr int KJ = BK / 16;       // keys a thread scores per tile
  constexpr int DJ = HD / 64;       // float4 output columns a thread owns
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);     // [kBQ][LQ]
  float* k_s = q_s + kBQ * LQ;                      // [BK][LQ]
  float* v_s = k_s + BK * LQ;                       // [BK][HD]
  float* p_s = v_s + BK * HD;                       // [kBQ][LP]

  const int BH = gridDim.x / n_qt;
  const int bh = blockIdx.x % BH;
  const int qt = n_qt - 1 - blockIdx.x / BH;        // longest tiles first
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / Hkv);
  const int q0 = qt * kBQ;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  const int64_t q_stride = static_cast<int64_t>(H) * hd;
  const int64_t kv_stride = static_cast<int64_t>(Hkv) * hd;
  const float* q_base = q + static_cast<int64_t>(b) * S * q_stride +
                        static_cast<int64_t>(h) * hd;
  const int64_t kv_off = static_cast<int64_t>(b) * S * kv_stride +
                         static_cast<int64_t>(kvh) * hd;
  const float* k_base = k + kv_off;
  const float* v_base = v + kv_off;

  load_tile<HD, kBQ, LQ>(q_s, q_base, q0, S, q_stride, hd);

  // the keys this query tile needs: the window's reach to the diagonal
  const int q_last = min(q0 + kBQ, S) - 1;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_end = causal ? q_last + 1 : S;

  float m[4], l[4];
  float4 acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) acc[i][jj] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();                  // the last tile's readers are done
    load_tile<HD, BK, LQ>(k_s, k_base, k0, S, kv_stride, hd);
    load_tile<HD, BK, HD>(v_s, v_base, k0, S, kv_stride, hd);
    __syncthreads();

    float s[4][KJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv[KJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(q_s + (4 * ty + i) * LQ + d);
#pragma unroll
      for (int j = 0; j < KJ; ++j)
        kv[j] = *reinterpret_cast<const float4*>(k_s + (tx + 16 * j) * LQ + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // mask, online softmax, p into shared memory, rescale the accumulators
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + 4 * ty + i;
      bool ok[KJ];
      float tmax = kNegInf;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const int kp = k0 + tx + 16 * j;
        ok[j] = kp < S && (!causal || kp <= qp) &&
                (window <= 0 || kp > qp - window);
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
        tmax = fmaxf(tmax, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(tmax));
      const float corr = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        psum += p;
        p_s[(4 * ty + i) * LP + tx + 16 * j] = p;
      }
      l[i] = l[i] * corr + row_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) {
        acc[i][jj].x *= corr;
        acc[i][jj].y *= corr;
        acc[i][jj].z *= corr;
        acc[i][jj].w *= corr;
      }
    }
    __syncthreads();

    // acc += p . V
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(p_s + (4 * ty + i) * LP + kk);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) {
          const float4 vv = *reinterpret_cast<const float4*>(
              v_s + (kk + t) * HD + 4 * tx + 64 * jj);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = t == 0 ? pv[i].x
                          : t == 1 ? pv[i].y
                          : t == 2 ? pv[i].z : pv[i].w;
            acc[i][jj].x = fmaf(p, vv.x, acc[i][jj].x);
            acc[i][jj].y = fmaf(p, vv.y, acc[i][jj].y);
            acc[i][jj].z = fmaf(p, vv.z, acc[i][jj].z);
            acc[i][jj].w = fmaf(p, vv.w, acc[i][jj].w);
          }
        }
      }
    }
  }

  // out = acc / max(l, 1e-30); lse = m + log(l)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + 4 * ty + i;
    if (qp >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* o_row = out + (static_cast<int64_t>(b) * S + qp) * q_stride +
                   static_cast<int64_t>(h) * hd;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      if (4 * tx + 64 * jj >= hd) continue;   // a padding column
      const float4 a = acc[i][jj];
      *reinterpret_cast<float4*>(o_row + 4 * tx + 64 * jj) =
          make_float4(a.x / denom, a.y / denom, a.z / denom, a.w / denom);
    }
    if (tx == 0)
      lse[(static_cast<int64_t>(b) * H + h) * S + qp] = m[i] + logf(l[i]);
  }
}

template <int HD, int BK>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           int B, int S, int H, int Hkv, int hd, float scale, int causal,
           int window, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * smem_floats<HD, BK>();
  auto kern = flash_fwd_kernel<HD, BK>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_qt = (S + kBQ - 1) / kBQ;
  const dim3 grid(static_cast<unsigned>(n_qt) * B * H);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, S, H, Hkv,
      hd, n_qt, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

// Key tile per padded head dim: 64 keys at HD 64 (69 KB of shared memory),
// 32 at HD 128 (76 KB), 192 (109 KB) and 256 (142 KB); with 115-128
// registers a thread at HD 64-192 and 187 at 256 (ptxas) that is two, two,
// two and one block an SM.
int dispatch_f32(const void* q, const void* k, const void* v, void* out,
                 float* lse, int B, int S, int H, int Hkv, int hd, float scale,
                 int causal, int window, cudaStream_t s) {
  switch ((hd + 63) / 64) {
    case 1:
      return launch<64, 64>(q, k, v, out, lse, B, S, H, Hkv, hd, scale,
                            causal, window, s);
    case 2:
      return launch<128, 32>(q, k, v, out, lse, B, S, H, Hkv, hd, scale,
                             causal, window, s);
    case 3:
      return launch<192, 32>(q, k, v, out, lse, B, S, H, Hkv, hd, scale,
                             causal, window, s);
    default:
      return launch<256, 32>(q, k, v, out, lse, B, S, H, Hkv, hd, scale,
                             causal, window, s);
  }
}

// ----------------------------------------------------------------- bf16
using bf16 = __nv_bfloat16;

constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcBQ = 16 * kTcWarps;     // query rows per block: 16 a warp
constexpr int kTcBK = 32;                // keys per K/V tile
constexpr float kLog2e = 1.4426950408889634f;

// The widths the bf16 kernel is instantiated at, the configs' head dims;
// hd runs in the first one >= hd.
constexpr int kTcWidths[] = {64, 80, 128, 256};
constexpr int kNumTcWidths = sizeof(kTcWidths) / sizeof(kTcWidths[0]);

// cp.async of rows pos0 .. pos0 + ROWS - 1 of one head into a tile of row
// stride LD (bf16); rows at or past S and columns at or past hd (a multiple
// of 8, so a 16-byte chunk is all in or all out) are zero-filled.
template <int HD, int ROWS, int LD>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* base,
                                          int pos0, int S, int64_t row_stride,
                                          int hd) {
  constexpr int kChunks = HD / 8;
  constexpr int kPerThread = (ROWS * kChunks + kTcThreads - 1) / kTcThreads;
#pragma unroll
  for (int it = 0; it < kPerThread; ++it) {
    const int i = threadIdx.x + it * kTcThreads;
    if (ROWS * kChunks % kTcThreads != 0 && i >= ROWS * kChunks) break;
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    const int p = pos0 + r;
    const bool ok = p < S && c < hd;
    cp_async16(smem_u32(dst + r * LD + c),
               ok ? base + p * row_stride + c : base, ok);
  }
}

// Q's A fragments stay in registers up to width 128 (32 registers a thread
// there); above, O's accumulator takes up to 128 and Q is re-read from
// shared memory each tile.
template <int HD>
__host__ __device__ constexpr bool q_in_registers() { return HD <= 128; }

template <int HD>
constexpr int tc_smem_bytes() {
  // two K/V stages; Q's tile shares the second when Q moves to registers
  return (4 * kTcBK + (q_in_registers<HD>() ? 0 : kTcBQ)) *
         (HD + 8) * static_cast<int>(sizeof(bf16));
}

// HD: the instantiated width (a multiple of 16, >= hd).
template <int HD>
__global__ void __launch_bounds__(kTcThreads)
flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ out,
               float* __restrict__ lse, int S, int H, int Hkv, int hd,
               int n_qt, float scale, int causal, int window) {
  constexpr bool kQRegs = q_in_registers<HD>();
  constexpr int BK = kTcBK;
  constexpr int LD = HD + 8;      // tile row stride (bf16): 16-byte padding
  constexpr int KT = HD / 16;     // q.k depth steps
  constexpr int NB = BK / 8;      // 8-key column blocks of S
  constexpr int DB = HD / 8;      // 8-wide column blocks of O
  static_assert(HD % 16 == 0 && BK % 16 == 0, "mma tiles are 16 deep");
  static_assert(!kQRegs || kTcBQ <= 2 * BK, "Q's tile must fit in a stage");
  extern __shared__ uint4 smem_tc[];
  bf16* kv_s = reinterpret_cast<bf16*>(smem_tc);   // [stage][K, V][BK][LD]
  bf16* q_s = kv_s + (kQRegs ? 2 : 4) * BK * LD;
  const float scale_log2 = scale * kLog2e;

  const int BH = gridDim.x / n_qt;
  const int bh = blockIdx.x % BH;
  const int qt = n_qt - 1 - blockIdx.x / BH;        // longest tiles first
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / Hkv);
  const int q0 = qt * kTcBQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;          // the fragment's row (and row + 8)
  const int tig = lane % 4;        // its column pair
  const int qw = q0 + 16 * warp;   // the warp's first query row

  const int64_t q_stride = static_cast<int64_t>(H) * hd;
  const int64_t kv_stride = static_cast<int64_t>(Hkv) * hd;
  const bf16* q_base = q + static_cast<int64_t>(b) * S * q_stride +
                       static_cast<int64_t>(h) * hd;
  const int64_t kv_off = static_cast<int64_t>(b) * S * kv_stride +
                         static_cast<int64_t>(kvh) * hd;
  const bf16* k_base = k + kv_off;
  const bf16* v_base = v + kv_off;

  // the keys this query tile needs: the window's reach to the diagonal
  const int q_last = min(q0 + kTcBQ, S) - 1;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_end = causal ? q_last + 1 : S;
  const int n_tiles = (k_end - k_begin + BK - 1) / BK;

  auto load_kv = [&](int stage, int k0) {
    bf16* k_s = kv_s + 2 * stage * BK * LD;
    load_rows<HD, BK, LD>(k_s, k_base, k0, S, kv_stride, hd);
    load_rows<HD, BK, LD>(k_s + BK * LD, v_base, k0, S, kv_stride, hd);
  };

  load_rows<HD, kTcBQ, LD>(q_s, q_base, q0, S, q_stride, hd);
  load_kv(0, k_begin);
  cp_async_commit();

  // A fragments of the warp's 16 query rows (held when kQRegs)
  uint32_t qf[kQRegs ? KT : 1][4];
  const uint32_t q_frag = smem_u32(q_s + (16 * warp + lane % 16) * LD +
                                   (lane / 16) * 8);
  if constexpr (kQRegs) {
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) ldsm_x4(qf[kk], q_frag + 32 * kk);
  }

  float o[DB][4];
#pragma unroll
  for (int d = 0; d < DB; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};   // rows g and g + 8: running max score
  float l[2] = {0.f, 0.f};           // this thread's share of the row sums

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_begin + t * BK;
    // tile t has landed, and every warp is done with tile t - 1 (and Q's
    // tile), whose stage the next loads overwrite
    cp_async_wait<0>();
    __syncthreads();
    if (t + 1 < n_tiles) load_kv((t + 1) & 1, k0 + BK);
    cp_async_commit();
    const bf16* k_s = kv_s + 2 * (t & 1) * BK * LD;
    const bf16* v_s = k_s + BK * LD;

    // S = Q K^T: K rows are the B operand's columns, read as they lie
    float s[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    const uint32_t k_frag = smem_u32(k_s + ((lane / 16) * 8 + lane % 8) * LD +
                                     ((lane / 8) % 2) * 8);
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t a[4];
      if constexpr (kQRegs) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qf[kk][i];
      } else {
        ldsm_x4(a, q_frag + 32 * kk);
      }
#pragma unroll
      for (int j = 0; j < NB; j += 2) {
        uint32_t bk[4];
        ldsm_x4(bk, k_frag + (8 * j * LD + 16 * kk) * 2);
        mma_bf16(s[j], a, bk[0], bk[1]);
        mma_bf16(s[j + 1], a, bk[2], bk[3]);
      }
    }

    // mask only where the tile cuts the diagonal, the window's edge or S;
    // the max is taken on raw scores (scale > 0), p = 2^(s c - m c) with
    // c = scale * log2(e) is one FFMA and one ex2
    const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > qw) ||
                      (window > 0 && k0 <= qw + 15 - window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e];
        if (edge) {
          const int qp = qw + g + 8 * (e / 2);
          const int kp = k0 + 8 * j + 2 * tig + (e % 2);
          const bool ok = kp < S && (!causal || kp <= qp) &&
                          (window <= 0 || kp > qp - window);
          if (!ok) x = kNegInf;
        }
        s[j][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    float corr[2], mc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      corr[r] = fast_exp2((m[r] - mx[r]) * scale_log2);
      m[r] = mx[r];
      mc[r] = mx[r] * scale_log2;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int d = 0; d < DB; ++d) {
      o[d][0] *= corr[0];
      o[d][1] *= corr[0];
      o[d][2] *= corr[1];
      o[d][3] *= corr[1];
    }

    // O += P V: P's accumulator fragments become A fragments (bf16 pairs)
    // 16 keys at a time; V's rows are the B operand's k, read transposed
    const uint32_t v_frag = smem_u32(v_s + (((lane / 8) % 2) * 8 + lane % 8) *
                                     LD + (lane / 16) * 8);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      float p[2][4];
#pragma unroll
      for (int hb = 0; hb < 2; ++hb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = s[2 * kk + hb][e];
          const float pe = edge && x == kNegInf
                               ? 0.f
                               : fast_exp2(fmaf(x, scale_log2, -mc[e / 2]));
          l[e / 2] += pe;
          p[hb][e] = pe;
        }
      const uint32_t a[4] = {pack_bf16(p[0][0], p[0][1]),
                             pack_bf16(p[0][2], p[0][3]),
                             pack_bf16(p[1][0], p[1][1]),
                             pack_bf16(p[1][2], p[1][3])};
#pragma unroll
      for (int d = 0; d < DB; d += 2) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, v_frag + (16 * kk * LD + 8 * d) * 2);
        mma_bf16(o[d], a, bv[0], bv[1]);
        mma_bf16(o[d + 1], a, bv[2], bv[3]);
      }
    }
  }

  // out = O / max(l, 1e-30); lse = m scale + log(l)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
    const int qp = qw + g + 8 * r;
    if (qp >= S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    bf16* o_row = out + (static_cast<int64_t>(b) * S + qp) * q_stride +
                  static_cast<int64_t>(h) * hd;
#pragma unroll
    for (int d = 0; d < DB; ++d) {
      if (8 * d >= hd) break;       // a zero-filled column block
      *reinterpret_cast<uint32_t*>(o_row + 8 * d + 2 * tig) =
          pack_bf16(o[d][2 * r] / denom, o[d][2 * r + 1] / denom);
    }
    if (tig == 0)
      lse[(static_cast<int64_t>(b) * H + h) * S + qp] =
          m[r] * scale + logf(l[r]);
  }
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                float* lse, int B, int S, int H, int Hkv, int hd, float scale,
                int causal, int window, cudaStream_t stream) {
  constexpr int smem = tc_smem_bytes<HD>();
  auto kern = flash_fwd_bf16<HD>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_qt = (S + kTcBQ - 1) / kTcBQ;
  const dim3 grid(static_cast<unsigned>(n_qt) * B * H);
  kern<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, S, H, Hkv,
      hd, n_qt, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

// hd runs at kTcWidths[I] if it fits there, else at a wider one.
template <int I>
int dispatch_bf16(const void* q, const void* k, const void* v, void* out,
                  float* lse, int B, int S, int H, int Hkv, int hd,
                  float scale, int causal, int window, cudaStream_t s) {
  constexpr int W = kTcWidths[I];
  if constexpr (I + 1 < kNumTcWidths) {
    if (hd > W)
      return dispatch_bf16<I + 1>(q, k, v, out, lse, B, S, H, Hkv, hd, scale,
                                  causal, window, s);
  }
  return launch_bf16<W>(q, k, v, out, lse, B, S, H, Hkv, hd, scale, causal,
                        window, s);
}

}  // namespace

// q, out (B, S, H, hd); k, v (B, S, Hkv, hd); lse (B, H, S) f32; all
// contiguous, 16-byte aligned. dtype 0 = f32, 1 = bf16. causal 0/1; window
// 0 = none, else keys in (pos - window, pos]. hd a multiple of 8 up to 256.
// Launches on `stream` and returns the launch's CUDA error code (0 =
// launched).
extern "C" int flash_attention_forward(const void* q, const void* k,
                                       const void* v, void* out, void* lse,
                                       int B, int S, int H, int Hkv, int hd,
                                       float scale, int causal, int window,
                                       int dtype, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || window < 0 || hd % 8 != 0 || hd < 8 ||
      hd > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_f32(q, k, v, out, l, B, S, H, Hkv, hd, scale, causal,
                        window, s);
  if (dtype == 1)
    return dispatch_bf16<0>(q, k, v, out, l, B, S, H, Hkv, hd, scale, causal,
                            window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
