// Flash attention forward (causal, sliding window, GQA) for Hopper, sm_90a.
//
// Replaces the TPU Pallas body `flash_kernel` in
// src/repro/kernels/flash_attention/kernel.py:27 (reached through
// `flash_attention_pallas`, :81). It computes the same function: softmax
// attention of each query row over the keys its mask admits (causal: key
// position <= query position; with a window w also key position > query
// position - w), with the online softmax in f32 and a final division by
// max(l, 1e-30), so the (S x S) score matrix never exists in device memory.
// It also writes the row log-sum-exp, m + log(l), for the backward pass.
//
// Layouts (all contiguous): q and out (B, S, H, hd); k and v (B, S, Hkv, hd);
// lse (B, H, S) f32. Head dims: any multiple of 8 up to 256 (the paged
// kernels' rule). The kernel is instantiated at the padded tile width HD, the
// next multiple of 64 (64, 128, 192, 256), and takes the true hd at run time:
// rows are hd elements apart, columns hd .. HD - 1 of each tile are
// zero-filled on load (zeros add nothing to q.k, and their p.v columns are
// never stored), and the store skips them. At hd 80 that wastes 3/8 of the
// flops on zeros; a tensor-core redesign can cut tiles to hd's own width.
// GQA: query head h reads kv head h / (H / Hkv) in place (the TPU wrapper
// repeats K/V in device memory first, ops.py:26-28; here nothing is
// copied). Types: f32 or bf16 for q/k/v/out, one type for all.
//
// Grid. The TPU grid (BH, S/bq, S/bk) runs in order on one core and carries
// (m, l, acc) in VMEM scratch across its innermost kv axis, skipping the
// tiles its `needed` test rules out. On Hopper blocks run in parallel and in
// no order, so one block owns one (batch, head, 64-row query tile) and loops
// itself over only the keys that tile needs: from max(0, q0 - w + 1) under a
// window (the window's reach) to the tile's last row under the causal mask
// (the diagonal), never a fully masked tile. Blocks are numbered so that the
// longest query tiles (the last ones under the causal mask) start first.
// Ragged edges: S need not divide by any tile; rows and keys at or past S are
// zero-filled on load, masked, and never written.
//
// Bound. Training attention does 4 * hd flops per admitted (query, key)
// pair (q.k and p.v) against hd * itemsize bytes per row read once, so at
// S = 4096 it sits far above the card's flop/byte ratio: the floor is the
// operations over the tensor cores' peak (0.28 ms at B=2, H=32, hd=128, bf16,
// causal, against 0.05 ms for its ~152 MB).
//
// Design for that bound, first version (simple and right; no mma, wgmma, TMA
// or cp.async pipeline yet, so it stays on the CUDA cores' f32 FMA rate, 67
// TFLOP/s at most): 256 threads as a 16 x 16 grid; thread (ty, tx) owns
// query rows 4ty..4ty+3 of the tile, keys tx + 16j of each key tile and head
// dims 4tx + 64jj..+3 of the output. Q, K and V tiles are converted to f32
// as they are loaded into shared memory (16-byte vectors), so one code path
// serves f32 and bf16 and every product rounds as the f32 plain version's;
// Q and K rows are padded by 4 floats so the float4 reads of 8 neighbouring
// key rows fall on 32 distinct banks. q.k and p.v are register-tiled float4
// products (4 rows x BK/16 keys, 4 rows x hd/16 dims a thread); the tile's
// row max and sum are shuffle reductions over the 16 threads of a row; p
// goes through a shared-memory tile from the score layout to the p.v layout.
// Masked keys get p = 0, so a row that meets only masked keys in a tile
// keeps m, l and acc as they were.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBQ = 64;             // query rows per block
constexpr int kThreads = 256;       // 16 x 16 threads
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// 8 elements from device memory into 8 f32 in shared memory.
__device__ __forceinline__ void load8(float* dst, const float* src) {
  const float4* s = reinterpret_cast<const float4*>(src);
  float4* d = reinterpret_cast<float4*>(dst);
  d[0] = s[0];
  d[1] = s[1];
}
__device__ __forceinline__ void load8(float* dst, const __nv_bfloat16* src) {
  const uint4 x = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  const float2 c = __bfloat1622float2(h[2]);
  const float2 e = __bfloat1622float2(h[3]);
  float4* d = reinterpret_cast<float4*>(dst);
  d[0] = make_float4(a.x, a.y, b.x, b.y);
  d[1] = make_float4(c.x, c.y, e.x, e.y);
}

__device__ __forceinline__ void store4(float* dst, float4 v) {
  *reinterpret_cast<float4*>(dst) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = u;
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
template <typename T, int HD, int ROWS, int LD>
__device__ __forceinline__ void load_tile(float* dst, const T* base, int pos0,
                                          int S, int64_t row_stride, int hd) {
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
template <typename T, int HD, int BK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
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
  const T* q_base = q + static_cast<int64_t>(b) * S * q_stride +
                    static_cast<int64_t>(h) * hd;
  const int64_t kv_off = static_cast<int64_t>(b) * S * kv_stride +
                         static_cast<int64_t>(kvh) * hd;
  const T* k_base = k + kv_off;
  const T* v_base = v + kv_off;

  load_tile<T, HD, kBQ, LQ>(q_s, q_base, q0, S, q_stride, hd);

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
    load_tile<T, HD, BK, LQ>(k_s, k_base, k0, S, kv_stride, hd);
    load_tile<T, HD, BK, HD>(v_s, v_base, k0, S, kv_stride, hd);
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
    T* o_row = out + (static_cast<int64_t>(b) * S + qp) * q_stride +
               static_cast<int64_t>(h) * hd;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      if (4 * tx + 64 * jj >= hd) continue;   // a padding column
      const float4 a = acc[i][jj];
      store4(o_row + 4 * tx + 64 * jj,
             make_float4(a.x / denom, a.y / denom, a.z / denom, a.w / denom));
    }
    if (tx == 0)
      lse[(static_cast<int64_t>(b) * H + h) * S + qp] = m[i] + logf(l[i]);
  }
}

template <typename T, int HD, int BK>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           int B, int S, int H, int Hkv, int hd, float scale, int causal,
           int window, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * smem_floats<HD, BK>();
  auto kern = flash_fwd_kernel<T, HD, BK>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_qt = (S + kBQ - 1) / kBQ;
  const dim3 grid(static_cast<unsigned>(n_qt) * B * H);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, S, H, Hkv, hd,
      n_qt, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

// Key tile per padded head dim: 64 keys at HD 64 (69 KB of shared memory),
// 32 at HD 128 (76 KB), 192 (109 KB) and 256 (142 KB); with 115-128
// registers a thread at HD 64-192 and 187 at 256 (ptxas) that is two, two,
// two and one block an SM.
template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out,
             float* lse, int B, int S, int H, int Hkv, int hd, float scale,
             int causal, int window, cudaStream_t s) {
  if (hd % 8 != 0 || hd < 8 || hd > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  switch ((hd + 63) / 64) {
    case 1:
      return launch<T, 64, 64>(q, k, v, out, lse, B, S, H, Hkv, hd, scale,
                               causal, window, s);
    case 2:
      return launch<T, 128, 32>(q, k, v, out, lse, B, S, H, Hkv, hd, scale,
                                causal, window, s);
    case 3:
      return launch<T, 192, 32>(q, k, v, out, lse, B, S, H, Hkv, hd, scale,
                                causal, window, s);
    default:
      return launch<T, 256, 32>(q, k, v, out, lse, B, S, H, Hkv, hd, scale,
                                causal, window, s);
  }
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
  if (Hkv <= 0 || H % Hkv != 0 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, l, B, S, H, Hkv, hd, scale, causal,
                           window, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, l, B, S, H, Hkv, hd, scale,
                                   causal, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
