// Paged decode attention (full mode) for Hopper, sm_90a.
//
// Replaces the TPU Pallas body `paged_kernel` in
// src/repro/kernels/paged_attention/kernel.py:52 (reached through
// `paged_attention_pallas`). It computes the same function: one query token
// per sequence attends, GQA-grouped, over the KV that the sequence's block
// table scatters through the pool; online softmax in f32; keys at or past
// seq_len are never read; the output is acc / max(l, 1e-30), so an inactive
// slot (seq_len == 0) writes zeros.
//
// Layouts (all contiguous): q (B, H, hd); k_pool / v_pool (N, bs, Hkv, hd);
// tables (B, P) int32; lens (B,) int32; out (B, H, hd) in q's type.
// Query head h = kvh * groups + g, as the reference's reshape (Hkv, groups).
//
// int8 pools (B3, every kernel of this file). Replaces the dequant in the
// TPU helper `_load_kv` (src/repro/kernels/paged_attention/kernel.py:41),
// which the `quant=True` variants of all four Pallas bodies share. The pool
// element type KV is a template parameter of its own beside the q/out type
// T: with KV = int8_t the kernels take two f32 scale pools k_scale /
// v_scale (N, bs, Hkv), one scale per stored vector, and dequantize each K/V
// row while it is copied into shared memory, as `x = tile.astype(f32) *
// scale[..., None]` right after the load. The tile is then f32 (4 bytes an
// element, the f32 kernels' layout and padding), so everything after the
// load is the f32-pool code, and the product rounds exactly as the plain
// version's does. Rows are read in 8-byte vectors (8 values, so hd % 8 ==
// 0 stays exact). A zero-filled row (a key past t_end, a dead or stale ring
// slot) reads no scale and stays exactly 0. Bound: the int8 bytes plus 4
// bytes of scale per vector, about 0.52x of bf16 K/V at hd 128.
//
// Bound. Decoding reads every live key and value once and does 4·H·hd
// flops per key, far below the card's flop/byte ratio, so the floor is the
// bytes of K/V actually read: sum_b len_b · Hkv · hd · 2 · itemsize over
// 3.35 TB/s.
//
// Design for that bound (simple: no wgmma, TMA or cp.async pipeline yet):
//   * split-K: block (b, kvh, split) covers keys [split·S, split·S + S) of
//     one sequence and kv head (S = split_tokens, 256 on the main path), so
//     a batch of 8 still puts B·Hkv·splits blocks on the 132 SMs. Blocks
//     whose range starts at or past seq_len exit at once; only pages
//     p < ceil(len / bs) are ever read. A second small kernel merges the
//     splits' (m, l, acc) in f32.
//   * each K/V row is loaded from device memory once, by one block, in
//     16-byte vectors, into a 32-key shared-memory tile that all `groups`
//     query rows of the kv head share; keys >= len in the last tile are
//     zero-filled and masked, never read;
//   * warp w owns query row g0 + w: lane j scores key j of the tile (a
//     full hd-long dot product from shared memory, rows padded so the 32
//     lanes hit 32 banks), the tile's max and sum are two warp reductions,
//     and p·V runs with lanes owning head dims.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;           // query rows per pass, one per warp
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;           // keys per shared-memory tile, one per lane
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Row padding in elements: makes the row stride an odd number of 4-byte
// words, so lane j reading row j spreads over all 32 banks.
template <typename T>
__host__ __device__ constexpr int row_pad() { return sizeof(T) == 2 ? 2 : 1; }

// Copies one vector of a K or V row from the pool into a shared-memory tile
// row, or zero-fills it. S is the tile's element type: the pool's own for
// f32 and bf16 pools (16-byte vectors, copied as they are), f32 for int8
// pools (8-byte vectors, dequantized by the row's scale on the way in).
template <typename KV>
struct TileLoad {
  using S = KV;
  static constexpr int kVec = 16 / sizeof(KV);   // elements per vector
  __device__ static void copy(S* dst, const KV* src, float) {
    const uint4 x = *reinterpret_cast<const uint4*>(src);
    uint32_t* d = reinterpret_cast<uint32_t*>(dst);
    d[0] = x.x; d[1] = x.y; d[2] = x.z; d[3] = x.w;
  }
  __device__ static void zero(S* dst) {
    uint32_t* d = reinterpret_cast<uint32_t*>(dst);
    d[0] = 0u; d[1] = 0u; d[2] = 0u; d[3] = 0u;
  }
};

template <>
struct TileLoad<int8_t> {
  using S = float;
  static constexpr int kVec = 8;
  __device__ static void copy(S* dst, const int8_t* src, float scale) {
    const uint2 x = *reinterpret_cast<const uint2*>(src);
    const int8_t* v = reinterpret_cast<const int8_t*>(&x);
#pragma unroll
    for (int i = 0; i < kVec; ++i) dst[i] = static_cast<float>(v[i]) * scale;
  }
  __device__ static void zero(S* dst) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) dst[i] = 0.f;
  }
};

// The scale of the vector at flat (slot, head) index `i` of an int8 pool;
// unread (1) for the other pool types, whose scale pointers are null.
template <typename KV>
__device__ __forceinline__ float scale_at(const float* scales, int64_t i) {
  if constexpr (sizeof(KV) == 1) return scales[i];
  return 1.f;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

// Dot product of an f32 row (shared memory, broadcast) with a row of T.
__device__ __forceinline__ float dot_row(const float* q, const float* k,
                                         int hd) {
  float s = 0.f;
  for (int d = 0; d < hd; ++d) s += q[d] * k[d];
  return s;
}
__device__ __forceinline__ float dot_row(const float* q,
                                         const __nv_bfloat16* k, int hd) {
  const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(k);
  const float2* q2 = reinterpret_cast<const float2*>(q);
  float s = 0.f;
  for (int d = 0; d < hd / 2; ++d) {
    const float2 kf = __bfloat1622float2(k2[d]);
    const float2 qf = q2[d];
    s += qf.x * kf.x + qf.y * kf.y;
  }
  return s;
}

// DPL: head dims per lane in p·V, ceil(hd / 32) rounded up to 1, 2, 4 or 8.
// KV: the pools' element type (T, or int8_t with scale pools).
template <typename T, typename KV, int DPL>
__global__ void __launch_bounds__(kThreads)
paged_decode_split_kernel(const T* __restrict__ q,
                          const KV* __restrict__ k_pool,
                          const KV* __restrict__ v_pool,
                          const float* __restrict__ k_scale,
                          const float* __restrict__ v_scale,
                          const int* __restrict__ tables,
                          const int* __restrict__ lens,
                          float* __restrict__ part_m,
                          float* __restrict__ part_l,
                          float* __restrict__ part_acc, int H, int Hkv, int hd,
                          int bs, int P, int split_tokens, int n_splits,
                          float scale) {
  using Load = TileLoad<KV>;
  using S = typename Load::S;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = hd + row_pad<S>();
  S* k_s = reinterpret_cast<S*>(smem_raw);            // [kTile][ld]
  S* v_s = k_s + kTile * ld;                          // [kTile][ld]
  float* q_s = reinterpret_cast<float*>(v_s + kTile * ld);  // [kWarps][hd]

  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int split = blockIdx.z;
  const int len = lens[b];
  const int t_begin = split * split_tokens;
  if (t_begin >= len) return;                 // the merge skips this split
  const int t_end = min(len, t_begin + split_tokens);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int groups = H / Hkv;
  const int* table = tables + static_cast<int64_t>(b) * P;
  const int64_t token_stride = static_cast<int64_t>(Hkv) * hd;
  const int vec_per_row = hd / Load::kVec;    // hd % 8 == 0: exact

  for (int g0 = 0; g0 < groups; g0 += kWarps) {
    const int ng = min(kWarps, groups - g0);
    const int64_t q_row0 = static_cast<int64_t>(b) * H + kvh * groups + g0;
    for (int i = threadIdx.x; i < ng * hd; i += kThreads)
      q_s[i] = to_f32(q[q_row0 * hd + i]);
    const bool active = warp < ng;            // warp-uniform

    float m = kNegInf;
    float l = 0.f;
    float acc[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] = 0.f;

    for (int t0 = t_begin; t0 < t_end; t0 += kTile) {
      // cooperative tile load: rows t0 .. t0 + 31, zeros past t_end
      for (int i = threadIdx.x; i < kTile * vec_per_row; i += kThreads) {
        const int r = i / vec_per_row;
        const int c = (i % vec_per_row) * Load::kVec;
        const int t = t0 + r;
        S* kd = k_s + r * ld + c;
        S* vd = v_s + r * ld + c;
        if (t < t_end) {
          const int64_t slot = static_cast<int64_t>(table[t / bs]) * bs +
                               t % bs;
          const int64_t off = slot * token_stride +
                              static_cast<int64_t>(kvh) * hd + c;
          const int64_t si = slot * Hkv + kvh;
          Load::copy(kd, k_pool + off, scale_at<KV>(k_scale, si));
          Load::copy(vd, v_pool + off, scale_at<KV>(v_scale, si));
        } else {
          Load::zero(kd);
          Load::zero(vd);
        }
      }
      __syncthreads();

      if (active) {
        const bool valid = t0 + lane < t_end;
        const float s = valid
            ? dot_row(q_s + warp * hd, k_s + lane * ld, hd) * scale
            : kNegInf;
        const float m_new = fmaxf(m, warp_max(s));
        const float corr = expf(m - m_new);
        const float p = valid ? expf(s - m_new) : 0.f;
        l = l * corr + warp_sum(p);
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[i] *= corr;
        const int nt = min(kTile, t_end - t0);
        for (int j = 0; j < nt; ++j) {
          const float pj = __shfl_sync(kFull, p, j);
          const S* vr = v_s + j * ld;
#pragma unroll
          for (int i = 0; i < DPL; ++i) {
            const int d = lane + 32 * i;
            if (d < hd) acc[i] += pj * to_f32(vr[d]);
          }
        }
        m = m_new;
      }
      __syncthreads();                        // the tile is reloaded next
    }

    if (active) {
      const int64_t row = (q_row0 + warp) * n_splits + split;
      if (lane == 0) {
        part_m[row] = m;
        part_l[row] = l;
      }
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < hd) part_acc[row * hd + d] = acc[i];
      }
    }
  }
}

// One block per (b, h): merge the live splits' partial softmax states.
template <typename T>
__global__ void paged_decode_merge_kernel(const float* __restrict__ part_m,
                                          const float* __restrict__ part_l,
                                          const float* __restrict__ part_acc,
                                          const int* __restrict__ lens,
                                          T* __restrict__ out, int H, int hd,
                                          int split_tokens, int n_splits) {
  const int64_t bh = blockIdx.x;
  const int len = lens[bh / H];
  const int used = (len + split_tokens - 1) / split_tokens;
  const int64_t row0 = bh * n_splits;
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float m_all = kNegInf;
    for (int s = 0; s < used; ++s) m_all = fmaxf(m_all, part_m[row0 + s]);
    float l_all = 0.f;
    float a_all = 0.f;
    for (int s = 0; s < used; ++s) {
      const float c = expf(part_m[row0 + s] - m_all);
      l_all += part_l[row0 + s] * c;
      a_all += part_acc[(row0 + s) * hd + d] * c;
    }
    out[bh * hd + d] = from_f32<T>(a_all / fmaxf(l_all, 1e-30f));
  }
}

template <typename T, typename KV, int DPL>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const float* k_scale, const float* v_scale,
                   const int* tables, const int* lens, void* out,
                   float* workspace, int B, int H, int Hkv, int hd, int bs,
                   int P, int split_tokens, float scale, cudaStream_t stream) {
  using S = typename TileLoad<KV>::S;
  const int n_splits = (P * bs + split_tokens - 1) / split_tokens;
  const int64_t rows = static_cast<int64_t>(B) * H * n_splits;
  float* part_m = workspace;
  float* part_l = part_m + rows;
  float* part_acc = part_l + rows;
  const size_t smem = 2 * sizeof(S) * kTile * (hd + row_pad<S>()) +
                      sizeof(float) * kWarps * hd;
  auto split_kernel = paged_decode_split_kernel<T, KV, DPL>;
  cudaError_t err = cudaFuncSetAttribute(
      split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  split_kernel<<<dim3(B, Hkv, n_splits), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k_pool),
      static_cast<const KV*>(v_pool), k_scale, v_scale, tables, lens, part_m,
      part_l, part_acc, H, Hkv, hd, bs, P, split_tokens, n_splits, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int merge_threads = ((hd + 31) / 32) * 32;
  paged_decode_merge_kernel<T><<<B * H, merge_threads, 0, stream>>>(
      part_m, part_l, part_acc, lens, static_cast<T*>(out), H, hd,
      split_tokens, n_splits);
  return cudaGetLastError();
}

template <typename T, typename KV>
cudaError_t dispatch_hd(const void* q, const void* k_pool, const void* v_pool,
                        const float* k_scale, const float* v_scale,
                        const int* tables, const int* lens, void* out,
                        float* workspace, int B, int H, int Hkv, int hd,
                        int bs, int P, int split_tokens, float scale,
                        cudaStream_t stream) {
  if (hd <= 32)
    return launch<T, KV, 1>(q, k_pool, v_pool, k_scale, v_scale, tables, lens,
                            out, workspace, B, H, Hkv, hd, bs, P,
                            split_tokens, scale, stream);
  if (hd <= 64)
    return launch<T, KV, 2>(q, k_pool, v_pool, k_scale, v_scale, tables, lens,
                            out, workspace, B, H, Hkv, hd, bs, P,
                            split_tokens, scale, stream);
  if (hd <= 128)
    return launch<T, KV, 4>(q, k_pool, v_pool, k_scale, v_scale, tables, lens,
                            out, workspace, B, H, Hkv, hd, bs, P,
                            split_tokens, scale, stream);
  return launch<T, KV, 8>(q, k_pool, v_pool, k_scale, v_scale, tables, lens,
                          out, workspace, B, H, Hkv, hd, bs, P, split_tokens,
                          scale, stream);
}

// int8 pools when scale pools are given, else pools of T.
template <typename T>
cudaError_t dispatch_pool(const void* q, const void* k_pool,
                          const void* v_pool, const float* k_scale,
                          const float* v_scale, const int* tables,
                          const int* lens, void* out, float* workspace, int B,
                          int H, int Hkv, int hd, int bs, int P,
                          int split_tokens, float scale, cudaStream_t stream) {
  if (k_scale != nullptr)
    return dispatch_hd<T, int8_t>(q, k_pool, v_pool, k_scale, v_scale, tables,
                                  lens, out, workspace, B, H, Hkv, hd, bs, P,
                                  split_tokens, scale, stream);
  return dispatch_hd<T, T>(q, k_pool, v_pool, nullptr, nullptr, tables, lens,
                           out, workspace, B, H, Hkv, hd, bs, P, split_tokens,
                           scale, stream);
}

// ---------------------------------------------------------------------------
// Ring decode (B2), verify (B4) and ring verify (B5).
//
// Replace the TPU Pallas bodies `paged_ring_kernel` (kernel.py:238),
// `paged_verify_kernel` (:101) and `paged_ring_verify_kernel` (:167). One
// template covers the three: RING selects the ring layout at compile time,
// and n_q (1 for decode, K for verify) sets the query rows per kv head,
// rows = n_q · groups, row = j · groups + g as in the Pallas bodies.
//
//   * query row j sits at qpos_j = newest - (n_q - 1) + j, where newest is
//     positions[b] in ring mode and lens[b] - 1 in full mode; a key at
//     absolute position kpos counts for row j iff kpos <= qpos_j and, in
//     ring mode, kpos > qpos_j - window;
//   * full mode splits the absolute tokens [0, lens[b]); ring mode splits
//     the ring's R · bs slots, and slot t holds absolute position
//     page · bs + t % bs with page = q_cur - ((q_cur % R - t / bs) mod R),
//     q_cur = newest / bs (floor division and a non-negative mod: C++ `%`
//     truncates toward zero). A slot is read only if its key lies in the
//     union of the rows' windows, (newest - (n_q-1) - window, newest] with
//     page >= 0; never-written pages and stale previous-lap offsets are
//     zero-filled in the tile, never read;
//   * each 32-key K/V tile is loaded from device memory once per block and
//     serves all `rows` query rows (reading K/V once for K drafts is the
//     point of verify); warp w takes rows w, w + 8, ...; each row's online
//     softmax state (m, l, acc) lives in shared memory so any row count
//     fits one pass over the keys;
//   * a key masked for a row gets p = 0 explicitly, so a row with no key in
//     a split keeps m = -1e30, l = 0, acc = 0, and the merge weighs that
//     partial exp(-1e30 - m_all) = 0. Every block writes its partial (an
//     empty split writes that neutral one), and the merge reads all splits.
//
// Bound: as B1, the bytes of the live keys' K and V; verify adds K query
// rows per key read, so its flop count grows K-fold and its bytes do not.

constexpr int kDeadKey = -2147483647 - 1;

__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && (a < 0) != (b < 0)) ? q - 1 : q;
}
__device__ __forceinline__ int floor_mod(int a, int b) {
  const int r = a % b;
  return r < 0 ? r + b : r;
}

// Shared memory of the multi-row kernel, in bytes (the host checks it); S
// is the tile's element type (f32 for int8 pools).
template <typename S>
__host__ __device__ constexpr size_t multi_smem_bytes(int hd, int rows) {
  return 2 * sizeof(S) * kTile * (hd + row_pad<S>()) +
         sizeof(float) * (2 * static_cast<size_t>(rows) * hd + 2 * rows) +
         sizeof(int) * kTile;
}

template <typename T, typename KV, int DPL, bool RING>
__global__ void __launch_bounds__(kThreads)
paged_multi_split_kernel(const T* __restrict__ q,
                         const KV* __restrict__ k_pool,
                         const KV* __restrict__ v_pool,
                         const float* __restrict__ k_scale,
                         const float* __restrict__ v_scale,
                         const int* __restrict__ tables,
                         const int* __restrict__ lens,
                         const int* __restrict__ positions,
                         float* __restrict__ part_m,
                         float* __restrict__ part_l,
                         float* __restrict__ part_acc, int n_q, int H,
                         int Hkv, int hd, int bs, int P, int R, int window,
                         int split_tokens, int n_splits, float scale) {
  using Load = TileLoad<KV>;
  using S = typename Load::S;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = hd + row_pad<S>();
  const int groups = H / Hkv;
  const int rows = n_q * groups;
  S* k_s = reinterpret_cast<S*>(smem_raw);                   // [kTile][ld]
  S* v_s = k_s + kTile * ld;                                 // [kTile][ld]
  float* q_s = reinterpret_cast<float*>(v_s + kTile * ld);   // [rows][hd]
  float* acc_s = q_s + rows * hd;                            // [rows][hd]
  float* m_s = acc_s + rows * hd;                            // [rows]
  float* l_s = m_s + rows;                                   // [rows]
  int* kpos_s = reinterpret_cast<int*>(l_s + rows);          // [kTile]

  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int split = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int len = lens[b];
  const int newest = RING ? positions[b] : len - 1;
  const int oldest = newest - (n_q - 1);
  const int t_begin = split * split_tokens;
  const int t_stop = min(RING ? R * bs : len, t_begin + split_tokens);

  const int64_t q_b = static_cast<int64_t>(b) * n_q * H;
  for (int i = threadIdx.x; i < rows * hd; i += kThreads) {
    const int row = i / hd;
    const int head = kvh * groups + row % groups;
    q_s[i] = to_f32(q[(q_b + static_cast<int64_t>(row / groups) * H + head) *
                          hd + i % hd]);
    acc_s[i] = 0.f;
  }
  for (int i = threadIdx.x; i < rows; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }
  __syncthreads();

  if (len > 0 && t_begin < t_stop) {               // block-uniform
    const int q_cur = RING ? floor_div(newest, bs) : 0;
    const int r_cur = RING ? floor_mod(q_cur, R) : 0;
    const int* table = tables + static_cast<int64_t>(b) * P;
    const int64_t token_stride = static_cast<int64_t>(Hkv) * hd;
    const int vec_per_row = hd / Load::kVec;

    for (int t0 = t_begin; t0 < t_stop; t0 += kTile) {
      // cooperative tile load; keys outside every row's range stay zero
      int live = 0;
      for (int i = threadIdx.x; i < kTile * vec_per_row; i += kThreads) {
        const int r = i / vec_per_row;
        const int c = (i % vec_per_row) * Load::kVec;
        const int t = t0 + r;
        int kpos = kDeadKey;
        int64_t blk = 0;
        if (t < t_stop) {
          if (RING) {
            const int slot = t / bs;
            const int page = q_cur - floor_mod(r_cur - slot, R);
            const int kp = page * bs + t % bs;
            if (page >= 0 && kp <= newest && kp > oldest - window) {
              kpos = kp;
              blk = table[slot];
            }
          } else {
            kpos = t;
            blk = table[t / bs];
          }
        }
        S* kd = k_s + r * ld + c;
        S* vd = v_s + r * ld + c;
        if (kpos != kDeadKey) {
          const int64_t slot = blk * bs + t % bs;
          const int64_t off = slot * token_stride +
                              static_cast<int64_t>(kvh) * hd + c;
          const int64_t si = slot * Hkv + kvh;
          Load::copy(kd, k_pool + off, scale_at<KV>(k_scale, si));
          Load::copy(vd, v_pool + off, scale_at<KV>(v_scale, si));
          live = 1;
        } else {
          Load::zero(kd);
          Load::zero(vd);
        }
        if (c == 0) kpos_s[r] = kpos;
      }
      if (!__syncthreads_or(live)) continue;      // no live key in the tile

      const int kp = kpos_s[lane];
      for (int row = warp; row < rows; row += kWarps) {
        const int qpos = oldest + row / groups;
        const bool valid = kp != kDeadKey && kp <= qpos &&
                           (!RING || kp > qpos - window);
        if (!__any_sync(kFull, valid)) continue;  // state stays as it is
        const float s = valid
            ? dot_row(q_s + row * hd, k_s + lane * ld, hd) * scale
            : kNegInf;
        const float m_old = m_s[row];
        const float l_old = l_s[row];
        const float m_new = fmaxf(m_old, warp_max(s));
        const float corr = expf(m_old - m_new);
        const float p = valid ? expf(s - m_new) : 0.f;
        const float l_new = l_old * corr + warp_sum(p);
        float* arow = acc_s + row * hd;
        float acc[DPL];
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int d = lane + 32 * i;
          acc[i] = d < hd ? arow[d] * corr : 0.f;
        }
        for (int j = 0; j < kTile; ++j) {
          const float pj = __shfl_sync(kFull, p, j);
          if (pj == 0.f) continue;                // warp-uniform
          const S* vr = v_s + j * ld;
#pragma unroll
          for (int i = 0; i < DPL; ++i) {
            const int d = lane + 32 * i;
            if (d < hd) acc[i] += pj * to_f32(vr[d]);
          }
        }
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int d = lane + 32 * i;
          if (d < hd) arow[d] = acc[i];
        }
        __syncwarp();
        if (lane == 0) {
          m_s[row] = m_new;
          l_s[row] = l_new;
        }
      }
      __syncthreads();                            // the tile is reloaded next
    }
  }
  __syncthreads();

  const int64_t row0 = (static_cast<int64_t>(b) * Hkv + kvh) * rows;
  for (int i = threadIdx.x; i < rows * hd; i += kThreads)
    part_acc[((row0 + i / hd) * n_splits + split) * hd + i % hd] = acc_s[i];
  for (int i = threadIdx.x; i < rows; i += kThreads) {
    part_m[(row0 + i) * n_splits + split] = m_s[i];
    part_l[(row0 + i) * n_splits + split] = l_s[i];
  }
}

// One block per (b, kv head, row): merge all splits' partial softmax states
// and write query j, head kvh · groups + g of out (B, n_q, H, hd).
template <typename T>
__global__ void paged_multi_merge_kernel(const float* __restrict__ part_m,
                                         const float* __restrict__ part_l,
                                         const float* __restrict__ part_acc,
                                         T* __restrict__ out, int n_q, int H,
                                         int Hkv, int hd, int n_splits) {
  const int groups = H / Hkv;
  const int rows = n_q * groups;
  const int64_t prow = blockIdx.x;               // (b · Hkv + kvh) · rows + row
  const int row = static_cast<int>(prow % rows);
  const int64_t bk = prow / rows;
  const int kvh = static_cast<int>(bk % Hkv);
  const int64_t b = bk / Hkv;
  const int64_t orow = (b * n_q + row / groups) * H + kvh * groups +
                       row % groups;
  const int64_t r0 = prow * n_splits;
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float m_all = kNegInf;
    for (int s = 0; s < n_splits; ++s) m_all = fmaxf(m_all, part_m[r0 + s]);
    float l_all = 0.f;
    float a_all = 0.f;
    for (int s = 0; s < n_splits; ++s) {
      const float c = expf(part_m[r0 + s] - m_all);
      l_all += part_l[r0 + s] * c;
      a_all += part_acc[(r0 + s) * hd + d] * c;
    }
    out[orow * hd + d] = from_f32<T>(a_all / fmaxf(l_all, 1e-30f));
  }
}

template <typename T, typename KV, int DPL, bool RING>
cudaError_t launch_multi(const void* q, const void* k_pool, const void* v_pool,
                         const float* k_scale, const float* v_scale,
                         const int* tables, const int* lens,
                         const int* positions, void* out, float* workspace,
                         int B, int n_q, int H, int Hkv, int hd, int bs, int P,
                         int R, int window, int split_tokens, float scale,
                         cudaStream_t stream) {
  const int span = (RING ? R : P) * bs;
  const int n_splits = (span + split_tokens - 1) / split_tokens;
  const int rows = n_q * (H / Hkv);
  const int64_t parts = static_cast<int64_t>(B) * Hkv * rows * n_splits;
  float* part_m = workspace;
  float* part_l = part_m + parts;
  float* part_acc = part_l + parts;
  const size_t smem = multi_smem_bytes<typename TileLoad<KV>::S>(hd, rows);
  auto split_kernel = paged_multi_split_kernel<T, KV, DPL, RING>;
  cudaError_t err = cudaFuncSetAttribute(
      split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  split_kernel<<<dim3(B, Hkv, n_splits), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k_pool),
      static_cast<const KV*>(v_pool), k_scale, v_scale, tables, lens,
      positions, part_m, part_l, part_acc, n_q, H, Hkv, hd, bs, P, R, window,
      split_tokens, n_splits, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int merge_threads = ((hd + 31) / 32) * 32;
  paged_multi_merge_kernel<T>
      <<<static_cast<unsigned>(B * Hkv * rows), merge_threads, 0, stream>>>(
          part_m, part_l, part_acc, static_cast<T*>(out), n_q, H, Hkv, hd,
          n_splits);
  return cudaGetLastError();
}

template <typename T, typename KV, bool RING>
cudaError_t dispatch_multi_hd(const void* q, const void* k_pool,
                              const void* v_pool, const float* k_scale,
                              const float* v_scale, const int* tables,
                              const int* lens, const int* positions, void* out,
                              float* ws, int B, int n_q, int H, int Hkv,
                              int hd, int bs, int P, int R, int window,
                              int split_tokens, float scale,
                              cudaStream_t s) {
  if (hd <= 32)
    return launch_multi<T, KV, 1, RING>(
        q, k_pool, v_pool, k_scale, v_scale, tables, lens, positions, out, ws,
        B, n_q, H, Hkv, hd, bs, P, R, window, split_tokens, scale, s);
  if (hd <= 64)
    return launch_multi<T, KV, 2, RING>(
        q, k_pool, v_pool, k_scale, v_scale, tables, lens, positions, out, ws,
        B, n_q, H, Hkv, hd, bs, P, R, window, split_tokens, scale, s);
  if (hd <= 128)
    return launch_multi<T, KV, 4, RING>(
        q, k_pool, v_pool, k_scale, v_scale, tables, lens, positions, out, ws,
        B, n_q, H, Hkv, hd, bs, P, R, window, split_tokens, scale, s);
  return launch_multi<T, KV, 8, RING>(
      q, k_pool, v_pool, k_scale, v_scale, tables, lens, positions, out, ws,
      B, n_q, H, Hkv, hd, bs, P, R, window, split_tokens, scale, s);
}

template <typename T, typename KV>
cudaError_t dispatch_multi_ring(const void* q, const void* k_pool,
                                const void* v_pool, const float* k_scale,
                                const float* v_scale, const int* tables,
                                const int* lens, const int* positions,
                                void* out, float* ws, int B, int n_q, int H,
                                int Hkv, int hd, int bs, int P, int R,
                                int window, int split_tokens, float scale,
                                cudaStream_t s) {
  if (R > 0)
    return dispatch_multi_hd<T, KV, true>(
        q, k_pool, v_pool, k_scale, v_scale, tables, lens, positions, out, ws,
        B, n_q, H, Hkv, hd, bs, P, R, window, split_tokens, scale, s);
  return dispatch_multi_hd<T, KV, false>(
      q, k_pool, v_pool, k_scale, v_scale, tables, lens, positions, out, ws, B,
      n_q, H, Hkv, hd, bs, P, R, window, split_tokens, scale, s);
}

// int8 pools when scale pools are given, else pools of T.
template <typename T>
cudaError_t dispatch_multi(const void* q, const void* k_pool,
                           const void* v_pool, const float* k_scale,
                           const float* v_scale, const int* tables,
                           const int* lens, const int* positions, void* out,
                           float* ws, int B, int n_q, int H, int Hkv, int hd,
                           int bs, int P, int R, int window, int split_tokens,
                           float scale, cudaStream_t s) {
  if (k_scale != nullptr)
    return dispatch_multi_ring<T, int8_t>(
        q, k_pool, v_pool, k_scale, v_scale, tables, lens, positions, out, ws,
        B, n_q, H, Hkv, hd, bs, P, R, window, split_tokens, scale, s);
  return dispatch_multi_ring<T, T>(
      q, k_pool, v_pool, nullptr, nullptr, tables, lens, positions, out, ws, B,
      n_q, H, Hkv, hd, bs, P, R, window, split_tokens, scale, s);
}

}  // namespace

// dtype (of q and out): 0 = float32, 1 = bfloat16. The pools are of that
// type, or int8 when k_scale / v_scale (N, bs, Hkv) f32 are given (both non-
// null; null for pools of q's type). The Python wrapper has checked shapes,
// types, contiguity, 16-byte alignment, 8 <= hd <= 256 with hd % 8 == 0 and
// split_tokens % 32 == 0, and allocated `workspace`: B · H · n_splits ·
// (hd + 2) floats, n_splits = ceil(P · bs / split_tokens). Returns the
// launches' cudaError_t (0 on success).
extern "C" int paged_attention_decode(const void* q, const void* k_pool,
                                      const void* v_pool, const void* k_scale,
                                      const void* v_scale, const void* tables,
                                      const void* lens, void* out,
                                      void* workspace, int B, int H, int Hkv,
                                      int hd, int bs, int P, int split_tokens,
                                      float scale, int dtype, void* stream) {
  if (B == 0) return 0;
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  if ((ks == nullptr) != (vs == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int* tbl = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(lens);
  float* ws = static_cast<float*>(workspace);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_pool<float>(q, k_pool, v_pool, ks, vs, tbl, ln, out, ws, B,
                                H, Hkv, hd, bs, P, split_tokens, scale, s);
  if (dtype == 1)
    return dispatch_pool<__nv_bfloat16>(q, k_pool, v_pool, ks, vs, tbl, ln,
                                        out, ws, B, H, Hkv, hd, bs, P,
                                        split_tokens, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Ring decode (B2: ring_pages > 0, n_q == 1), verify (B4: ring_pages == 0)
// and ring verify (B5: ring_pages > 0, n_q > 1). q and out are (B, n_q, H,
// hd); `positions` (B,) int32 is read in ring mode only (the newest query's
// absolute position; the caller passes any int32 buffer in full mode).
// dtype and k_scale / v_scale as in paged_attention_decode. The Python
// wrapper has checked shapes, types, contiguity, alignment, ring_pages <= P,
// the shared-memory size and allocated `workspace`: B · n_q · H · n_splits ·
// (hd + 2) floats, n_splits = ceil((ring_pages or P) · bs / split_tokens).
// Returns the launches' cudaError_t (0 on success).
extern "C" int paged_attention_multi(const void* q, const void* k_pool,
                                     const void* v_pool, const void* k_scale,
                                     const void* v_scale, const void* tables,
                                     const void* lens, const void* positions,
                                     void* out, void* workspace, int B,
                                     int n_q, int H, int Hkv, int hd, int bs,
                                     int P, int ring_pages, int window,
                                     int split_tokens, float scale, int dtype,
                                     void* stream) {
  if (B == 0) return 0;
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  if ((ks == nullptr) != (vs == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int* tbl = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(lens);
  const int* pos = static_cast<const int*>(positions);
  float* ws = static_cast<float*>(workspace);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_multi<float>(q, k_pool, v_pool, ks, vs, tbl, ln, pos, out,
                                 ws, B, n_q, H, Hkv, hd, bs, P, ring_pages,
                                 window, split_tokens, scale, s);
  if (dtype == 1)
    return dispatch_multi<__nv_bfloat16>(q, k_pool, v_pool, ks, vs, tbl, ln,
                                         pos, out, ws, B, n_q, H, Hkv, hd, bs,
                                         P, ring_pages, window, split_tokens,
                                         scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
