// Paged attention for Hopper, sm_90a: one-query decode in full mode (B1)
// and ring mode (B2), and the K-query verify (B4, B5), each also on int8
// pools (B3).
//
// Two designs live here, chosen by the query's type:
//
//   query | B1 full decode | B2 ring decode | B4 verify | B5 ring verify
//   bf16  | paged_decode_tc, bf16 or int8 pools (n_q = 1, or K)
//   f32   | paged_decode_  | paged_multi_split_kernel, f32 or int8 pools
//         | split_kernel   |
//
// A bf16 query runs `paged_decode_tc` (the last section of this file:
// mma.sync on the tensor cores, keys split across warps, a cp.async ring
// through the block table) in all four modes, one-query decode and K-query
// verify alike. An f32 query runs the CUDA-core kernels of the first two
// sections, described next; they keep IEEE f32 for the 2e-5 parity that
// the f32 engine checks (cuda == cpu tokens, spec == plain) rest on.
//
// B1 in f32 replaces the TPU Pallas body `paged_kernel` in
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

#include "../../csrc/sm90_mma.cuh"

namespace {

constexpr int kWarps = 8;           // query rows per pass, one per warp
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;           // keys per shared-memory tile, one per lane
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// Row padding of the f32 tiles, in elements: makes the row stride (hd is a
// multiple of 8) an odd number of 4-byte words, so lane j reading row j
// spreads over all 32 banks.
constexpr int kRowPad = 1;

// Copies one vector of a K or V row from the pool into a shared-memory tile
// row, or zero-fills it. S is the tile's element type, f32: the pool's own
// for f32 pools (16-byte vectors, copied as they are), widened for int8
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

// Dot product of two f32 rows in shared memory (q broadcast).
__device__ __forceinline__ float dot_row(const float* q, const float* k,
                                         int hd) {
  float s = 0.f;
  for (int d = 0; d < hd; ++d) s += q[d] * k[d];
  return s;
}

// DPL: head dims per lane in p·V, ceil(hd / 32) rounded up to 1, 2, 4 or 8.
// KV: the pools' element type (T, or int8_t with scale pools).
template <typename KV, int DPL>
__global__ void __launch_bounds__(kThreads)
paged_decode_split_kernel(const float* __restrict__ q,
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
  const int ld = hd + kRowPad;
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
      q_s[i] = q[q_row0 * hd + i];
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
            if (d < hd) acc[i] += pj * vr[d];
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
__global__ void paged_decode_merge_kernel(const float* __restrict__ part_m,
                                          const float* __restrict__ part_l,
                                          const float* __restrict__ part_acc,
                                          const int* __restrict__ lens,
                                          float* __restrict__ out, int H,
                                          int hd,
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
    out[bh * hd + d] = a_all / fmaxf(l_all, 1e-30f);
  }
}

template <typename KV, int DPL>
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
  const size_t smem = 2 * sizeof(S) * kTile * (hd + kRowPad) +
                      sizeof(float) * kWarps * hd;
  auto split_kernel = paged_decode_split_kernel<KV, DPL>;
  cudaError_t err = cudaFuncSetAttribute(
      split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  split_kernel<<<dim3(B, Hkv, n_splits), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const KV*>(k_pool),
      static_cast<const KV*>(v_pool), k_scale, v_scale, tables, lens, part_m,
      part_l, part_acc, H, Hkv, hd, bs, P, split_tokens, n_splits, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int merge_threads = ((hd + 31) / 32) * 32;
  paged_decode_merge_kernel<<<B * H, merge_threads, 0, stream>>>(
      part_m, part_l, part_acc, lens, static_cast<float*>(out), H, hd,
      split_tokens, n_splits);
  return cudaGetLastError();
}

template <typename KV>
cudaError_t dispatch_hd(const void* q, const void* k_pool, const void* v_pool,
                        const float* k_scale, const float* v_scale,
                        const int* tables, const int* lens, void* out,
                        float* workspace, int B, int H, int Hkv, int hd,
                        int bs, int P, int split_tokens, float scale,
                        cudaStream_t stream) {
  if (hd <= 32)
    return launch<KV, 1>(q, k_pool, v_pool, k_scale, v_scale, tables, lens,
                            out, workspace, B, H, Hkv, hd, bs, P,
                            split_tokens, scale, stream);
  if (hd <= 64)
    return launch<KV, 2>(q, k_pool, v_pool, k_scale, v_scale, tables, lens,
                            out, workspace, B, H, Hkv, hd, bs, P,
                            split_tokens, scale, stream);
  if (hd <= 128)
    return launch<KV, 4>(q, k_pool, v_pool, k_scale, v_scale, tables, lens,
                            out, workspace, B, H, Hkv, hd, bs, P,
                            split_tokens, scale, stream);
  return launch<KV, 8>(q, k_pool, v_pool, k_scale, v_scale, tables, lens,
                          out, workspace, B, H, Hkv, hd, bs, P, split_tokens,
                          scale, stream);
}

// f32 q: int8 pools when scale pools are given, else f32 pools (a bf16
// query takes paged_decode_tc).
cudaError_t dispatch_pool_f32(const void* q, const void* k_pool,
                              const void* v_pool, const float* k_scale,
                              const float* v_scale, const int* tables,
                              const int* lens, void* out, float* workspace,
                              int B, int H, int Hkv, int hd, int bs, int P,
                              int split_tokens, float scale,
                              cudaStream_t stream) {
  if (k_scale != nullptr)
    return dispatch_hd<int8_t>(q, k_pool, v_pool, k_scale, v_scale,
                                      tables, lens, out, workspace, B, H, Hkv,
                                      hd, bs, P, split_tokens, scale, stream);
  return dispatch_hd<float>(q, k_pool, v_pool, nullptr, nullptr,
                                   tables, lens, out, workspace, B, H, Hkv, hd,
                                   bs, P, split_tokens, scale, stream);
}

// ---------------------------------------------------------------------------
// Ring decode (B2), verify (B4) and ring verify (B5) with an f32 query.
//
// Replace the TPU Pallas bodies `paged_ring_kernel` (kernel.py:238),
// `paged_verify_kernel` (:101) and `paged_ring_verify_kernel` (:167) for an
// f32 query (a bf16 query runs paged_decode_tc). One template covers the
// three: RING selects the ring layout at compile time, and n_q (1 for
// decode, K for verify) sets the query rows per kv head, rows = n_q ·
// groups, row = j · groups + g as in the Pallas bodies.
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
  return 2 * sizeof(S) * kTile * (hd + kRowPad) +
         sizeof(float) * (2 * static_cast<size_t>(rows) * hd + 2 * rows) +
         sizeof(int) * kTile;
}

template <typename KV, int DPL, bool RING>
__global__ void __launch_bounds__(kThreads)
paged_multi_split_kernel(const float* __restrict__ q,
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
  const int ld = hd + kRowPad;
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
    q_s[i] = q[(q_b + static_cast<int64_t>(row / groups) * H + head) * hd +
               i % hd];
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
            if (d < hd) acc[i] += pj * vr[d];
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
__global__ void paged_multi_merge_kernel(const float* __restrict__ part_m,
                                         const float* __restrict__ part_l,
                                         const float* __restrict__ part_acc,
                                         float* __restrict__ out, int n_q, int H,
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
    out[orow * hd + d] = a_all / fmaxf(l_all, 1e-30f);
  }
}

template <typename KV, int DPL, bool RING>
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
  auto split_kernel = paged_multi_split_kernel<KV, DPL, RING>;
  cudaError_t err = cudaFuncSetAttribute(
      split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  split_kernel<<<dim3(B, Hkv, n_splits), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const KV*>(k_pool),
      static_cast<const KV*>(v_pool), k_scale, v_scale, tables, lens,
      positions, part_m, part_l, part_acc, n_q, H, Hkv, hd, bs, P, R, window,
      split_tokens, n_splits, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int merge_threads = ((hd + 31) / 32) * 32;
  paged_multi_merge_kernel<<<static_cast<unsigned>(B * Hkv * rows),
                             merge_threads, 0, stream>>>(
      part_m, part_l, part_acc, static_cast<float*>(out), n_q, H, Hkv, hd,
      n_splits);
  return cudaGetLastError();
}

template <typename KV, bool RING>
cudaError_t dispatch_multi_hd(const void* q, const void* k_pool,
                              const void* v_pool, const float* k_scale,
                              const float* v_scale, const int* tables,
                              const int* lens, const int* positions, void* out,
                              float* ws, int B, int n_q, int H, int Hkv,
                              int hd, int bs, int P, int R, int window,
                              int split_tokens, float scale,
                              cudaStream_t s) {
  if (hd <= 32)
    return launch_multi<KV, 1, RING>(
        q, k_pool, v_pool, k_scale, v_scale, tables, lens, positions, out, ws,
        B, n_q, H, Hkv, hd, bs, P, R, window, split_tokens, scale, s);
  if (hd <= 64)
    return launch_multi<KV, 2, RING>(
        q, k_pool, v_pool, k_scale, v_scale, tables, lens, positions, out, ws,
        B, n_q, H, Hkv, hd, bs, P, R, window, split_tokens, scale, s);
  if (hd <= 128)
    return launch_multi<KV, 4, RING>(
        q, k_pool, v_pool, k_scale, v_scale, tables, lens, positions, out, ws,
        B, n_q, H, Hkv, hd, bs, P, R, window, split_tokens, scale, s);
  return launch_multi<KV, 8, RING>(
      q, k_pool, v_pool, k_scale, v_scale, tables, lens, positions, out, ws,
      B, n_q, H, Hkv, hd, bs, P, R, window, split_tokens, scale, s);
}

template <typename KV>
cudaError_t dispatch_multi_ring(const void* q, const void* k_pool,
                                const void* v_pool, const float* k_scale,
                                const float* v_scale, const int* tables,
                                const int* lens, const int* positions,
                                void* out, float* ws, int B, int n_q, int H,
                                int Hkv, int hd, int bs, int P, int R,
                                int window, int split_tokens, float scale,
                                cudaStream_t s) {
  if (R > 0)
    return dispatch_multi_hd<KV, true>(
        q, k_pool, v_pool, k_scale, v_scale, tables, lens, positions, out, ws,
        B, n_q, H, Hkv, hd, bs, P, R, window, split_tokens, scale, s);
  return dispatch_multi_hd<KV, false>(
      q, k_pool, v_pool, k_scale, v_scale, tables, lens, positions, out, ws, B,
      n_q, H, Hkv, hd, bs, P, R, window, split_tokens, scale, s);
}

// int8 pools when scale pools are given, else f32 pools.
cudaError_t dispatch_multi(const void* q, const void* k_pool,
                           const void* v_pool, const float* k_scale,
                           const float* v_scale, const int* tables,
                           const int* lens, const int* positions, void* out,
                           float* ws, int B, int n_q, int H, int Hkv, int hd,
                           int bs, int P, int R, int window, int split_tokens,
                           float scale, cudaStream_t s) {
  if (k_scale != nullptr)
    return dispatch_multi_ring<int8_t>(
        q, k_pool, v_pool, k_scale, v_scale, tables, lens, positions, out, ws,
        B, n_q, H, Hkv, hd, bs, P, R, window, split_tokens, scale, s);
  return dispatch_multi_ring<float>(
      q, k_pool, v_pool, nullptr, nullptr, tables, lens, positions, out, ws, B,
      n_q, H, Hkv, hd, bs, P, R, window, split_tokens, scale, s);
}

// ---------------------------------------------------------------------------
// B1, B2, B4 and B5 with a bf16 query, on bf16 or int8 pools (B3):
// paged_decode_tc.
//
// Replaces the TPU Pallas bodies `paged_kernel`
// (src/repro/kernels/paged_attention/kernel.py:52, full mode) and
// `paged_ring_kernel` (:238, ring mode) with n_q = 1, and
// `paged_verify_kernel` (:101, full mode) and `paged_ring_verify_kernel`
// (:167, ring mode) with n_q = K, each with the int8 load of the helper
// `_load_kv` (:41) when scale pools are given. It computes the same
// function as the CUDA-core kernels above: n_q query tokens per sequence,
// query j at oldest + j with oldest = newest - (n_q - 1) (newest =
// positions[b] in ring mode, lens[b] - 1 in full mode), attend over the
// keys their block table (full mode) or ring (ring mode, the
// slot-to-position map of paged_multi_split_kernel) holds, each up to its
// own position and, in ring mode, within its own window; an inactive slot
// (len == 0) writes zeros.
//
// Bound: unchanged, the bytes of the live keys' K and V read once over
// 3.35 TB/s, plus 4 bytes of scale per int8 vector; 4·H·hd flops per key
// are far below the card's flop/byte ratio.
//
// Design for that bound. The CUDA-core kernels above, which ran B1, B2,
// B4 and B5 in bf16 before this one, took 8x-22x their bound on an H100:
// one 32-key tile loaded at a time with nothing in flight, q·k a serial
// dot product per lane, warps given to query rows (6 of 8 idle at gemma3's
// 2 groups), int8 widened to f32 tiles, 256-key splits. Here:
//   * Grid (b, kv head × 16-row tile, split). All rows = n_q · groups
//     query rows of a kv head (row j · groups + g, the Pallas bodies'
//     order; groups 8 for yi-9b, 2 for gemma3, so a gemma3 verify of up to
//     8 queries fills one tile) form the M side of mma.sync.m16n8k16
//     tiles; rows past `rows` are zero. Each K/V stage read from device
//     memory serves every row of its tile: reading K/V once for K drafts
//     is the point of verify (more than 16 rows take more tiles on the
//     grid, which read the same stages again, mostly from L2). The host
//     picks split_tokens from B, Hkv, the row tiles, the span and the SM
//     count (kernel.py: about two waves of blocks, a power-of-two number
//     of 64-key stages), never from seq_lens.
//   * The block loads its split's slice of the block table together with
//     its length (one round trip), then maps each key to its pool slot in
//     shared memory, -1 for a key no row sees: past len, a never-written
//     ring page, a stale previous-lap offset or outside the union of the
//     rows' windows, (oldest - window, newest] (the ring's
//     slot-to-position map of paged_multi_split_kernel); a ring verify
//     also keeps each key's absolute position beside its slot. It keeps
//     kDecStages 64-key K/V stages in a cp.async ring; a dead key's row
//     (and scale) is zero-filled with source size 0 from the pool's base,
//     never from a table entry.
//   * Keys across warps: each of the 4 warps takes its own 16 keys of a
//     stage and keeps its own online softmax (m, l, O) in f32 registers:
//     S = Q·Kᵀ (two 8-key column blocks, even and odd depth steps in two
//     accumulators), P rounded to bf16 and reused as the A fragment of
//     P·V, with the FA2 fragments of flash_attention.cu (the cp.async,
//     ldmatrix and mma_bf16 of kernels/csrc/sm90_mma.cuh). O and l are
//     rescaled only when a row's max grew. At the end the warps' states
//     merge in shared memory (the stage buffers reused) and the block
//     writes one partial (m, l, acc) per query row; a small kernel merges
//     the splits, every split's (m, l) loaded at once. A split with no
//     live key writes l = 0 and no acc.
//     (Timed on an H100: 2 to 6 stages and 8 warps a block moved the time
//     by little; larger splits, fewer blocks, by more.)
//   * Scores carry scale·log2(e) (and the key's scale) before the max, so
//     any sign of `scale` is right; p = 2^(s - m) on the SFU. Masks act on
//     the stage that cuts len in full mode; ring mode reads each key's
//     liveness from the slot map on every stage (4 shared loads a thread),
//     and a warp whose 16 slots are all dead skips the stage. A key counts
//     for row j iff its position is <= qpos_j and, in ring mode, >
//     qpos_j - window: that per-row test runs only on a warp slice that
//     may hold a key some row must not see (full mode: a position past
//     the oldest query's, so only the last slices; ring verify: a live
//     key outside (newest - window, oldest], found by a vote over the
//     slice's positions), with each row's position read from its Q row's
//     padding. A masked key gets p = 0 explicitly, so a row with no live
//     key in a split writes the neutral partial (m = -1e30, l = 0).
//   * int8 pools stay int8 in shared memory (16-byte copies; 8-byte ones
//     when hd % 16 == 8, whose rows start 8-byte aligned). Each thread
//     builds its fragments with ld.shared and converts int8 to bf16
//     exactly (|x| <= 128 < 2^8): byte + 128 into an f32 mantissa under
//     2^23, minus 2^23 + 128, upper half (no ldmatrix: it moves 16-bit
//     elements). The key scale multiplies the f32 score after the product;
//     the value scale is folded into p before p rounds to bf16, and l sums
//     the unscaled f32 p. A dead key's scale is zero-filled, so it never
//     enters an operation (the smoke poisons it with NaN). K's fragments
//     take d in the order 4·tig .. 4·tig + 3 (one 32-bit load; Q's
//     fragments follow the same order), V's take d pairs 2·g, 2·g + 1
//     (16-bit loads of 4 keys): O's column blocks then hold d = 16·(j/2) +
//     2·c + j % 2, undone in the merge. Row strides are odd multiples of
//     16 bytes, so these loads and ldmatrix's are free of bank conflicts.
//   * Widths: the kernel is instantiated at kDecWidths, the configs' head
//     dims; another hd runs at the next width with its columns zero-filled.
//     With bf16 pools up to width 128 Q's fragments stay in registers; at
//     256 O's accumulator takes 128 registers a thread and Q is re-read
//     from shared memory each stage, as it is with int8 pools, whose
//     conversions need the registers (ptxas otherwise spills).

using bf16 = __nv_bfloat16;

constexpr int kDecWarps = 4;                       // key slices per stage
constexpr int kDecThreads = 32 * kDecWarps;
constexpr int kDecSliceKeys = 16;                  // keys per warp per stage
constexpr int kDecStageKeys = kDecWarps * kDecSliceKeys;
constexpr int kDecStages = 3;                      // the cp.async ring
constexpr int kDecRows = 16;                       // query rows per block
constexpr int kDecMaxSplit = 2048;                 // keys per block at most
constexpr float kLog2e = 1.4426950408889634f;

// The widths the kernel is instantiated at, the configs' head dims; hd
// runs in the first one >= hd.
constexpr int kDecWidths[] = {64, 80, 128, 256};
constexpr int kNumDecWidths = sizeof(kDecWidths) / sizeof(kDecWidths[0]);

// Byte I of `biased` (an int8 word XORed with 0x80808080, so each byte is
// x + 128) as the exact float x: 2^23 + x + 128 built in the mantissa.
template <int I>
__device__ __forceinline__ float s8_at(uint32_t biased) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540 | I)) -
         8388736.f;
}
// Two small integers held exactly in f32 as a bf16 pair (the upper halves:
// |x| <= 128 has at most 8 significant bits), `lo` in the low half.
__device__ __forceinline__ uint32_t pack_int_bf16(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// Bytes of one K or V row in a stage: hd values padded so the stride is
// an odd multiple of 16 bytes (conflict-free ldmatrix and fragment loads).
template <int HD, typename KV>
__host__ __device__ constexpr int dec_row_bytes() {
  return sizeof(KV) == 2 ? 2 * HD + 16
                         : ((HD / 16) % 2 == 0 ? HD + 16 : HD + 32);
}

template <int HD, typename KV>
__host__ __device__ constexpr int dec_stage_bytes() {
  return 2 * kDecStageKeys * dec_row_bytes<HD, KV>();        // K, then V
}

// Shared memory of a block: the stages, Q's tile (16 rows of HD + 8 bf16),
// the stages' K and V scales, and the split's slot map (split_tokens ints);
// a ring verify (kpos) also each key's absolute position (split_tokens ints).
template <int HD, typename KV>
__host__ __device__ constexpr size_t dec_smem_bytes(int split_tokens,
                                                    bool kpos) {
  return static_cast<size_t>(kDecStages) * dec_stage_bytes<HD, KV>() +
         kDecRows * (HD + 8) * sizeof(bf16) +
         2 * kDecStages * kDecStageKeys * sizeof(float) +
         static_cast<size_t>(split_tokens) * sizeof(int) * (kpos ? 2 : 1);
}

// Issues the cp.async copies of one 64-key stage: key i of the split at
// slot_s[i] (-1: dead, zero-filled from the pool's base), K rows then V
// rows, chunks past hd zero-filled; int8 pools also the keys' scales.
template <typename KV>
struct DecStage {
  unsigned char* tiles;
  const int* slot_s;
  float* ks_s;
  float* vs_s;
  const KV* k_pool;
  const KV* v_pool;
  const float* k_scale;
  const float* v_scale;
  int64_t token_bytes;     // one slot's row of all kv heads
  int64_t head_bytes;      // the kv head's offset in it
  int row_bytes;           // hd values
  int n_keys;
  int Hkv;
  int kvh;

  // CB bytes per cp.async: 16, or 8 for int8 rows of hd % 16 == 8 (they
  // start 8-byte aligned)
  template <int HD, int CB>
  __device__ __forceinline__ void copy_rows(int st) const {
    constexpr int SK = kDecStageKeys;
    constexpr int RB = dec_row_bytes<HD, KV>();
    constexpr int kChunks = HD * static_cast<int>(sizeof(KV)) / CB;
    unsigned char* k_t = tiles + (st % kDecStages) * dec_stage_bytes<HD, KV>();
    unsigned char* v_t = k_t + SK * RB;
    const unsigned char* k_src = reinterpret_cast<const unsigned char*>(k_pool);
    const unsigned char* v_src = reinterpret_cast<const unsigned char*>(v_pool);
    for (int i = threadIdx.x; i < SK * kChunks; i += kDecThreads) {
      const int r = i / kChunks;
      const int cb = (i % kChunks) * CB;
      const int key = st * SK + r;
      const int slot = key < n_keys ? slot_s[key] : -1;
      const bool ok = slot >= 0 && cb < row_bytes;
      const int64_t off = ok ? slot * token_bytes + head_bytes + cb : 0;
      if constexpr (CB == 16) {
        cp_async16(smem_u32(k_t + r * RB + cb), k_src + off, ok);
        cp_async16(smem_u32(v_t + r * RB + cb), v_src + off, ok);
      } else {
        cp_async8(smem_u32(k_t + r * RB + cb), k_src + off, ok);
        cp_async8(smem_u32(v_t + r * RB + cb), v_src + off, ok);
      }
    }
  }

  template <int HD>
  __device__ __forceinline__ void load(int st) const {
    constexpr bool kInt8 = sizeof(KV) == 1;
    constexpr int SK = kDecStageKeys;
    if (kInt8 && row_bytes % 16 != 0)
      copy_rows<HD, 8>(st);
    else
      copy_rows<HD, 16>(st);
    if constexpr (kInt8) {
      if (threadIdx.x < SK) {
        const int key = st * SK + threadIdx.x;
        const int slot = key < n_keys ? slot_s[key] : -1;
        const bool ok = slot >= 0;
        const int64_t si = ok ? static_cast<int64_t>(slot) * Hkv + kvh : 0;
        const int at = (st % kDecStages) * SK + threadIdx.x;
        cp_async4(smem_u32(ks_s + at), k_scale + si, ok);
        cp_async4(smem_u32(vs_s + at), v_scale + si, ok);
      }
    }
  }
};

// HD: the instantiated width (>= hd); KV: bf16 or int8_t (scale pools);
// RING: ring mode. n_q query tokens per sequence (1: decode, K: verify).
// Partial states go to part_* per output row ((b · n_q + j) · H + head) and
// split; m is kept in log2 units (scores times scale·log2 e).
template <int HD, typename KV, bool RING>
__global__ void __launch_bounds__(kDecThreads)
paged_decode_tc(const bf16* __restrict__ q, const KV* __restrict__ k_pool,
                const KV* __restrict__ v_pool,
                const float* __restrict__ k_scale,
                const float* __restrict__ v_scale,
                const int* __restrict__ tables, const int* __restrict__ lens,
                const int* __restrict__ positions, float* __restrict__ part_m,
                float* __restrict__ part_l, float* __restrict__ part_acc,
                int n_q, int H, int Hkv, int hd, int bs, int P, int R,
                int window, int split_tokens, int n_splits, float scale_log2) {
  constexpr bool kInt8 = sizeof(KV) == 1;
  constexpr int SK = kDecStageKeys;
  constexpr int RB = dec_row_bytes<HD, KV>();
  constexpr int STAGE = dec_stage_bytes<HD, KV>();
  constexpr int LDQ = HD + 8;          // Q tile row stride (bf16)
  constexpr int KT = HD / 16;          // q.k depth steps
  constexpr int DB = HD / 8;           // 8-wide column blocks of O
  // Q's fragments in registers up to width 128 with bf16 pools; int8
  // pools read them from shared memory (two 8-byte loads a depth step),
  // leaving the registers to the conversions
  constexpr bool kQRegs = HD <= 128 && !kInt8;
  static_assert(HD % 16 == 0, "mma tiles are 16 deep");
  static_assert(kDecWarps * kDecRows * (HD + 2) * 4 <= kDecStages * STAGE,
                "the warps' merge must fit in the stage buffers");
  static_assert((kDecMaxSplit + 1) * 4 <= STAGE,
                "a split's table slice must fit the first stage buffer");
  extern __shared__ uint4 smem_dec[];
  unsigned char* tiles = reinterpret_cast<unsigned char*>(smem_dec);
  bf16* q_s = reinterpret_cast<bf16*>(tiles + kDecStages * STAGE);
  float* ks_s = reinterpret_cast<float*>(q_s + kDecRows * LDQ);  // [stage][SK]
  float* vs_s = ks_s + kDecStages * SK;
  int* slot_s = reinterpret_cast<int*>(vs_s + kDecStages * SK);  // [keys]
  int* kpos_s = slot_s + split_tokens;           // [keys], ring verify only
  const bool kpos_map = RING && n_q > 1;

  const int b = blockIdx.x;
  const int groups = H / Hkv;
  const int rows = n_q * groups;                 // the kv head's query rows
  const int row_tiles = (rows + kDecRows - 1) / kDecRows;
  const int kvh = blockIdx.y / row_tiles;
  const int r0 = (blockIdx.y % row_tiles) * kDecRows;
  const int nr = min(kDecRows, rows - r0);       // the tile's rows
  const int split = blockIdx.z;
  const int t_begin = split * split_tokens;
  // row r of the tile is kv-head row r0 + r = j · groups + g: query j,
  // head kvh · groups + g, output row (b · n_q + j) · H + head
  auto out_row = [&](int r) {
    const int rr = r0 + r;
    return (static_cast<int64_t>(b) * n_q + rr / groups) * H + kvh * groups +
           rr % groups;
  };

  // the split's slice of the block table, into the first stage's buffer
  // (no copy has reached it yet), loaded with lens[b] in one round trip:
  // its pages up to the span, whatever the length
  int* tbl_s = reinterpret_cast<int*>(tiles);
  const int p0 = t_begin / bs;
  {
    const int span = RING ? R * bs : P * bs;
    const int* table = tables + static_cast<int64_t>(b) * P + p0;
    const int n_pages = (min(span, t_begin + split_tokens) - 1) / bs - p0 + 1;
    for (int i = threadIdx.x; i < n_pages; i += kDecThreads)
      tbl_s[i] = table[i];
  }
  const int len = lens[b];
  const int newest = RING ? positions[b] : len - 1;
  const int oldest = newest - (n_q - 1);         // query j at oldest + j
  const int t_stop = min(RING ? R * bs : min(len, P * bs),
                         t_begin + split_tokens);

  if (len <= 0 || t_begin >= t_stop) {          // block-uniform: no key
    for (int r = threadIdx.x; r < nr; r += kDecThreads) {
      part_m[out_row(r) * n_splits + split] = kNegInf;
      part_l[out_row(r) * n_splits + split] = 0.f;
    }
    return;
  }
  const int n_keys = t_stop - t_begin;
  const int n_stages = (n_keys + SK - 1) / SK;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;          // the fragment's row (and row + 8)
  const int tig = lane % 4;        // its column pair

  // Q's 16-row tile, zeros past the kv head's rows and past hd. Each row's
  // 16 bytes of padding (past HD, read by no fragment load) keep two ints:
  // the row's query position and its output row, read where they are
  // needed instead of held in registers across the key loop
  {
    constexpr int kQChunks = HD / 8;
    for (int i = threadIdx.x; i < kDecRows * kQChunks; i += kDecThreads) {
      const int r = i / kQChunks;
      const int c = (i % kQChunks) * 8;
      const bool ok = r < nr && c < hd;
      cp_async16(smem_u32(q_s + r * LDQ + c),
                 ok ? q + out_row(r) * hd + c : q, ok);
    }
    if (threadIdx.x < kDecRows) {
      int* pad = reinterpret_cast<int*>(q_s + threadIdx.x * LDQ + HD);
      pad[0] = oldest + (r0 + threadIdx.x) / groups;   // past nr: unread
      pad[1] = threadIdx.x < nr ? static_cast<int>(out_row(threadIdx.x)) : 0;
    }
  }
  // the slot map: each key's pool slot, -1 for a key no row sees (outside
  // the union of the rows' windows); a ring verify also keeps each key's
  // absolute position for the per-row test
  {
    const int q_cur = RING ? floor_div(newest, bs) : 0;
    const int r_cur = RING ? floor_mod(q_cur, R) : 0;
    __syncthreads();                            // the table slice landed
    for (int i = threadIdx.x; i < n_keys; i += kDecThreads) {
      const int t = t_begin + i;
      bool live = true;
      if (RING) {
        const int page = q_cur - floor_mod(r_cur - t / bs, R);
        const int kp = page * bs + t % bs;
        live = page >= 0 && kp <= newest && kp > oldest - window;
        if (kpos_map) kpos_s[i] = kp;
      }
      slot_s[i] = live ? tbl_s[t / bs - p0] * bs + t % bs : -1;
    }
  }
  __syncthreads();

  constexpr int kItem = sizeof(KV);
  const DecStage<KV> stage{tiles, slot_s, ks_s, vs_s, k_pool, v_pool,
                           k_scale, v_scale,
                           static_cast<int64_t>(Hkv) * hd * kItem,
                           static_cast<int64_t>(kvh) * hd * kItem,
                           hd * kItem, n_keys, Hkv, kvh};

  uint32_t qf[kQRegs ? KT : 1][4];
  // A fragment kk of Q: bf16 pools in the natural d order (ldmatrix), int8
  // pools in K's order (d 4·tig .. 4·tig + 3 of each 16)
  auto q_frag = [&](int kk, uint32_t (&a)[4]) {
    if constexpr (kInt8) {
      const bf16* r = q_s + g * LDQ + 16 * kk + 4 * tig;
      const uint2 lo = *reinterpret_cast<const uint2*>(r);
      const uint2 hi = *reinterpret_cast<const uint2*>(r + 8 * LDQ);
      a[0] = lo.x;
      a[1] = hi.x;
      a[2] = lo.y;
      a[3] = hi.y;
    } else {
      ldsm_x4(a, smem_u32(q_s + (lane % 16) * LDQ + (lane / 16) * 8) +
                     32 * kk);
    }
  };

  float o[DB][4];
#pragma unroll
  for (int d = 0; d < DB; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};   // rows g and g + 8, log2 units
  float l[2] = {0.f, 0.f};           // this thread's share of the row sums

  // iterations st < 0 only fill the ring (Q's tile lands with stage 0, in
  // one commit group); one call site of the loads keeps the code small
  for (int st = 1 - kDecStages; st < n_stages; ++st) {
    if (st >= 0) {
      // stage st has landed, and every warp is done with stage st - 1,
      // whose buffer the next loads overwrite
      cp_async_wait<kDecStages - 2>();
      __syncthreads();
    }
    if (st + kDecStages - 1 < n_stages)
      stage.template load<HD>(st + kDecStages - 1);
    cp_async_commit();
    if (st < 0) continue;
    if constexpr (kQRegs) {
      if (st == 0) {
#pragma unroll
        for (int kk = 0; kk < KT; ++kk) q_frag(kk, qf[kk]);
      }
    }
    const int key0 = st * SK + warp * kDecSliceKeys;   // the warp's slice
    if (key0 >= n_keys) continue;                      // warp-uniform
    // per_row: the slice may hold a key that some row must not see (full
    // mode: a position past the oldest query's; ring verify: a key outside
    // some row's window); the rows' masks are then applied one by one
    bool per_row = !RING && t_begin + key0 + kDecSliceKeys - 1 > oldest;
    if (RING) {                         // a slice of dead ring slots only
      const int key = key0 + lane % kDecSliceKeys;
      const bool live = key < n_keys && slot_s[key] >= 0;
      if (!__any_sync(kFull, live)) continue;
      if (kpos_map) {
        const int kp = live ? kpos_s[key] : 0;
        per_row = __any_sync(
            kFull, live && (kp > oldest || kp <= newest - window));
      }
    }
    const int buf = st % kDecStages;
    const unsigned char* k_t = tiles + buf * STAGE + warp * kDecSliceKeys * RB;
    const unsigned char* v_t = k_t + SK * RB;

    // S = Q K^T over the warp's 16 keys: column block j holds keys 8j..8j+7;
    // even and odd depth steps go to two accumulators (two mma chains)
    float s[2][4], s2[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = s2[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      float (&acc)[2][4] = kk % 2 ? s2 : s;
      uint32_t a[4];
      if constexpr (kQRegs) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qf[kk][i];
      } else {
        q_frag(kk, a);
      }
      if constexpr (kInt8) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const uint32_t w = *reinterpret_cast<const uint32_t*>(
                                 k_t + (8 * j + g) * RB + 16 * kk + 4 * tig) ^
                             0x80808080u;
          mma_bf16(acc[j], a, pack_int_bf16(s8_at<0>(w), s8_at<1>(w)),
                   pack_int_bf16(s8_at<2>(w), s8_at<3>(w)));
        }
      } else {
        uint32_t bk[4];
        ldsm_x4(bk, smem_u32(k_t + ((lane / 16) * 8 + lane % 8) * RB +
                             ((lane / 8) % 2) * 16 + 32 * kk));
        mma_bf16(acc[0], a, bk[0], bk[1]);
        mma_bf16(acc[1], a, bk[2], bk[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] += s2[j][e];

    // element (j, e) is key 8j + 2·tig + e % 2 of the slice, row g + 8(e/2)
    float kc[2][2], vc[2][2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int at = buf * SK + warp * kDecSliceKeys + 8 * j + 2 * tig + c;
        kc[j][c] = kInt8 ? ks_s[at] * scale_log2 : scale_log2;
        vc[j][c] = kInt8 ? vs_s[at] : 1.f;
      }
    const bool edge = RING || per_row || key0 + kDecSliceKeys > n_keys;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * kc[j][e % 2];
        if (edge) {
          const int key = key0 + 8 * j + 2 * tig + (e % 2);
          bool ok = key < n_keys && slot_s[key] >= 0;
          if (per_row && ok) {
            const int kp = RING ? kpos_s[key] : t_begin + key;
            const int qp = *reinterpret_cast<const int*>(
                q_s + (g + 8 * (e / 2)) * LDQ + HD);
            ok = kp <= qp && (!RING || kp > qp - window);
          }
          if (!ok) x = kNegInf;
        }
        s[j][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
    }
    // O and l are rescaled only when some row's max grew (warp-uniform)
    if (__any_sync(kFull, mx[0] > m[0] || mx[1] > m[1])) {
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        corr[r] = fast_exp2(m[r] - mx[r]);
        m[r] = mx[r];
        l[r] *= corr[r];
      }
#pragma unroll
      for (int d = 0; d < DB; ++d) {
        o[d][0] *= corr[0];
        o[d][1] *= corr[0];
        o[d][2] *= corr[1];
        o[d][3] *= corr[1];
      }
    }
    // P: f32 p into l, p (times the value's scale) rounded to bf16 as the
    // A fragment of P·V
    float p[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[j][e];
        const float pe = edge && x == kNegInf ? 0.f
                                              : fast_exp2(x - m[e / 2]);
        l[e / 2] += pe;
        p[j][e] = pe * vc[j][e % 2];
      }
    const uint32_t a[4] = {pack_bf16(p[0][0], p[0][1]),
                           pack_bf16(p[0][2], p[0][3]),
                           pack_bf16(p[1][0], p[1][1]),
                           pack_bf16(p[1][2], p[1][3])};

    // O += P V over the slice's 16 keys
    if constexpr (kInt8) {
      // column blocks 2i and 2i + 1 take d = 16i + 2g and 16i + 2g + 1 of
      // keys 2·tig, 2·tig + 1 (b0) and 2·tig + 8, 2·tig + 9 (b1)
      const unsigned char* vb = v_t + 2 * tig * RB + 2 * g;
#pragma unroll
      for (int i = 0; i < DB / 2; ++i) {
        const uint32_t w0 = *reinterpret_cast<const uint16_t*>(vb + 16 * i);
        const uint32_t w1 =
            *reinterpret_cast<const uint16_t*>(vb + RB + 16 * i);
        const uint32_t w8 =
            *reinterpret_cast<const uint16_t*>(vb + 8 * RB + 16 * i);
        const uint32_t w9 =
            *reinterpret_cast<const uint16_t*>(vb + 9 * RB + 16 * i);
        const uint32_t x01 = __byte_perm(w0, w1, 0x5410) ^ 0x80808080u;
        const uint32_t x89 = __byte_perm(w8, w9, 0x5410) ^ 0x80808080u;
        mma_bf16(o[2 * i], a, pack_int_bf16(s8_at<0>(x01), s8_at<2>(x01)),
                 pack_int_bf16(s8_at<0>(x89), s8_at<2>(x89)));
        mma_bf16(o[2 * i + 1], a,
                 pack_int_bf16(s8_at<1>(x01), s8_at<3>(x01)),
                 pack_int_bf16(s8_at<1>(x89), s8_at<3>(x89)));
      }
    } else {
      const uint32_t v_frag = smem_u32(
          v_t + (((lane / 8) % 2) * 8 + lane % 8) * RB + (lane / 16) * 16);
#pragma unroll
      for (int d = 0; d < DB; d += 2) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, v_frag + 16 * d);
        mma_bf16(o[d], a, bv[0], bv[1]);
        mma_bf16(o[d + 1], a, bv[2], bv[3]);
      }
    }
  }

  // merge the warps' states in shared memory (the stage buffers reused)
  cp_async_wait<0>();
  __syncthreads();
  float* red_o = reinterpret_cast<float*>(tiles);        // [warp][row][HD]
  float* red_m = red_o + kDecWarps * kDecRows * HD;      // [warp][row]
  float* red_l = red_m + kDecWarps * kDecRows;           // [warp][row]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
    if (tig == 0) {
      red_m[warp * kDecRows + g + 8 * r] = m[r];
      red_l[warp * kDecRows + g + 8 * r] = l[r];
    }
  }
#pragma unroll
  for (int d = 0; d < DB; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 2 * tig + (e % 2);
      const int col = kInt8 ? 16 * (d / 2) + 2 * c + d % 2 : 8 * d + c;
      red_o[(warp * kDecRows + g + 8 * (e / 2)) * HD + col] = o[d][e];
    }
  __syncthreads();
  for (int i = threadIdx.x; i < nr * hd; i += kDecThreads) {
    const int r = i / hd;
    const int d = i % hd;
    float m_all = kNegInf;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w)
      m_all = fmaxf(m_all, red_m[w * kDecRows + r]);
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w)
      acc += red_o[(w * kDecRows + r) * HD + d] *
             exp2f(red_m[w * kDecRows + r] - m_all);
    const int64_t prow =
        static_cast<int64_t>(
            reinterpret_cast<const int*>(q_s + r * LDQ + HD)[1]) *
            n_splits +
        split;
    part_acc[prow * hd + d] = acc;
    if (d == 0) {
      float l_all = 0.f;
#pragma unroll
      for (int w = 0; w < kDecWarps; ++w)
        l_all += red_l[w * kDecRows + r] *
                 exp2f(red_m[w * kDecRows + r] - m_all);
      part_m[prow] = m_all;
      part_l[prow] = l_all;
    }
  }
}

// One block per output row (b, query, head): merge the splits that saw a
// live key (l > 0);
// m in log2 units. The splits' weights are computed once, into shared
// memory (n_splits floats), with every split's (m, l) loaded at once.
__global__ void paged_decode_tc_merge(const float* __restrict__ part_m,
                                      const float* __restrict__ part_l,
                                      const float* __restrict__ part_acc,
                                      bf16* __restrict__ out, int hd,
                                      int n_splits) {
  extern __shared__ float w_s[];                 // [n_splits] weights
  __shared__ float red[32];
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * n_splits;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int n_warps = blockDim.x / 32;
  float mx = kNegInf;
  for (int s = threadIdx.x; s < n_splits; s += blockDim.x) {
    const float m = part_m[r0 + s];
    const float l = part_l[r0 + s];
    w_s[s] = l > 0.f ? m : kNegInf;
    mx = fmaxf(mx, w_s[s]);
  }
  mx = warp_max(mx);
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  float m_all = kNegInf;
  for (int w = 0; w < n_warps; ++w) m_all = fmaxf(m_all, red[w]);
  float l_part = 0.f;
  for (int s = threadIdx.x; s < n_splits; s += blockDim.x) {
    const float m = w_s[s];
    const float wgt = m == kNegInf ? 0.f : exp2f(m - m_all);
    w_s[s] = wgt;
    l_part += wgt * part_l[r0 + s];
  }
  l_part = warp_sum(l_part);
  __syncthreads();                               // red[] read, w_s written
  if (lane == 0) red[warp] = l_part;
  __syncthreads();
  float l_all = 0.f;
  for (int w = 0; w < n_warps; ++w) l_all += red[w];
  const float denom = fmaxf(l_all, 1e-30f);
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float a_all = 0.f;
#pragma unroll 4
    for (int s = 0; s < n_splits; ++s) {
      const float wgt = w_s[s];          // 0: no live key, acc unwritten
      if (wgt != 0.f) a_all += part_acc[(r0 + s) * hd + d] * wgt;
    }
    out[static_cast<int64_t>(blockIdx.x) * hd + d] =
        __float2bfloat16(a_all / denom);
  }
}

template <int HD, typename KV, bool RING>
cudaError_t launch_dec(const void* q, const void* k_pool, const void* v_pool,
                       const float* k_scale, const float* v_scale,
                       const int* tables, const int* lens,
                       const int* positions, void* out, float* workspace,
                       int B, int n_q, int H, int Hkv, int hd, int bs, int P,
                       int R, int window, int split_tokens, float scale,
                       cudaStream_t stream) {
  const int span = (RING ? R : P) * bs;
  const int n_splits = (span + split_tokens - 1) / split_tokens;
  const int64_t out_rows = static_cast<int64_t>(B) * n_q * H;
  const int64_t parts = out_rows * n_splits;
  float* part_m = workspace;
  float* part_l = part_m + parts;
  float* part_acc = part_l + parts;
  const size_t smem = dec_smem_bytes<HD, KV>(split_tokens, RING && n_q > 1);
  auto kern = paged_decode_tc<HD, KV, RING>;
  // the attribute is set once per device and size, not on every call
  static size_t configured[16] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 16 || smem > configured[dev]) {
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    if (dev < 16) configured[dev] = smem;
  }
  const int row_tiles = (n_q * (H / Hkv) + kDecRows - 1) / kDecRows;
  kern<<<dim3(B, Hkv * row_tiles, n_splits), kDecThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const KV*>(k_pool),
      static_cast<const KV*>(v_pool), k_scale, v_scale, tables, lens,
      positions, part_m, part_l, part_acc, n_q, H, Hkv, hd, bs, P, R, window,
      split_tokens, n_splits, scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int merge_threads = ((hd + 31) / 32) * 32;
  paged_decode_tc_merge<<<static_cast<unsigned>(out_rows), merge_threads,
                          n_splits * sizeof(float), stream>>>(
      part_m, part_l, part_acc, static_cast<bf16*>(out), hd, n_splits);
  return cudaGetLastError();
}

// hd runs at kDecWidths[I] if it fits there, else at a wider one.
template <int I, typename KV, bool RING>
cudaError_t dispatch_dec(const void* q, const void* k_pool, const void* v_pool,
                         const float* k_scale, const float* v_scale,
                         const int* tables, const int* lens,
                         const int* positions, void* out, float* ws, int B,
                         int n_q, int H, int Hkv, int hd, int bs, int P, int R,
                         int window, int split_tokens, float scale,
                         cudaStream_t s) {
  constexpr int W = kDecWidths[I];
  if constexpr (I + 1 < kNumDecWidths) {
    if (hd > W)
      return dispatch_dec<I + 1, KV, RING>(
          q, k_pool, v_pool, k_scale, v_scale, tables, lens, positions, out,
          ws, B, n_q, H, Hkv, hd, bs, P, R, window, split_tokens, scale, s);
  }
  return launch_dec<W, KV, RING>(q, k_pool, v_pool, k_scale, v_scale, tables,
                                 lens, positions, out, ws, B, n_q, H, Hkv, hd,
                                 bs, P, R, window, split_tokens, scale, s);
}

template <typename KV>
cudaError_t dispatch_dec_mode(const void* q, const void* k_pool,
                              const void* v_pool, const float* k_scale,
                              const float* v_scale, const int* tables,
                              const int* lens, const int* positions,
                              void* out, float* ws, int B, int n_q, int H,
                              int Hkv, int hd, int bs, int P, int R,
                              int window, int split_tokens, float scale,
                              cudaStream_t s) {
  if (R > 0)
    return dispatch_dec<0, KV, true>(q, k_pool, v_pool, k_scale, v_scale,
                                     tables, lens, positions, out, ws, B, n_q,
                                     H, Hkv, hd, bs, P, R, window,
                                     split_tokens, scale, s);
  return dispatch_dec<0, KV, false>(q, k_pool, v_pool, k_scale, v_scale,
                                    tables, lens, positions, out, ws, B, n_q,
                                    H, Hkv, hd, bs, P, R, window,
                                    split_tokens, scale, s);
}

}  // namespace

// Full-mode decode with an f32 q (B1 and B1 + B3 in f32): dtype must be 0
// (float32); a bf16 q runs paged_decode_bf16. The pools are f32, or int8
// when k_scale / v_scale (N, bs, Hkv) f32 are given (both non-null; null
// for f32 pools). The Python wrapper has checked shapes, types, contiguity,
// 16-byte alignment, 8 <= hd <= 256 with hd % 8 == 0 and split_tokens % 32
// == 0, and allocated `workspace`: B · H · n_splits · (hd + 2) floats,
// n_splits = ceil(P · bs / split_tokens). Returns the launches'
// cudaError_t (0 on success).
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
  if ((ks == nullptr) != (vs == nullptr) || dtype != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_pool_f32(q, k_pool, v_pool, ks, vs,
                           static_cast<const int*>(tables),
                           static_cast<const int*>(lens), out,
                           static_cast<float*>(workspace), B, H, Hkv, hd, bs,
                           P, split_tokens, scale,
                           static_cast<cudaStream_t>(stream));
}

// Ring decode (B2: ring_pages > 0, n_q == 1), verify (B4: ring_pages == 0)
// and ring verify (B5: ring_pages > 0, n_q > 1) with an f32 q; dtype must be
// 0 (float32): a bf16 q runs paged_decode_bf16. q and out are (B, n_q, H,
// hd); `positions` (B,) int32 is read in ring mode only (the newest query's
// absolute position; the caller passes any int32 buffer in full mode). The
// pools are f32, or int8 with k_scale / v_scale as in
// paged_attention_decode. The Python wrapper has checked shapes, types,
// contiguity, alignment, ring_pages <= P, the shared-memory size and
// allocated `workspace`: B · n_q · H · n_splits · (hd + 2) floats, n_splits
// = ceil((ring_pages or P) · bs / split_tokens). Returns the launches'
// cudaError_t (0 on success).
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
  if ((ks == nullptr) != (vs == nullptr) || dtype != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_multi(q, k_pool, v_pool, ks, vs,
                        static_cast<const int*>(tables),
                        static_cast<const int*>(lens),
                        static_cast<const int*>(positions), out,
                        static_cast<float*>(workspace), B, n_q, H, Hkv, hd,
                        bs, P, ring_pages, window, split_tokens, scale,
                        static_cast<cudaStream_t>(stream));
}

// Decode and verify with a bf16 q and out (B, n_q, H, hd) on the tensor
// cores: n_q == 1 is the one-query decode (B1: ring_pages == 0; B2:
// ring_pages > 0, keys in (positions[b] - window, positions[b]] through the
// first ring_pages table entries), n_q > 1 the verify (B4: ring_pages == 0,
// query j at lens[b] - n_q + j; B5: ring_pages > 0, query j at
// positions[b] - (n_q - 1) + j, each in its own window). Pools bf16, or
// int8 with f32 k_scale / v_scale (N, bs, Hkv) (both non-null; null for
// bf16 pools). `positions` (B,) int32 is read in ring mode only. The Python
// wrapper has checked shapes, types, contiguity, 16-byte alignment, 8 <= hd
// <= 256 with hd % 8 == 0, ring_pages <= P and window >= 1 in ring mode,
// chosen split_tokens (a multiple of the 64-key stage, at most 2048) and
// allocated `workspace`: B · n_q · H · n_splits · (hd + 2) floats, n_splits
// = ceil((ring_pages or P) · bs / split_tokens). Returns the launches'
// cudaError_t (0 on success).
extern "C" int paged_decode_bf16(const void* q, const void* k_pool,
                                 const void* v_pool, const void* k_scale,
                                 const void* v_scale, const void* tables,
                                 const void* lens, const void* positions,
                                 void* out, void* workspace, int B, int n_q,
                                 int H, int Hkv, int hd, int bs, int P,
                                 int ring_pages, int window, int split_tokens,
                                 float scale, void* stream) {
  if (B == 0) return 0;
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  if ((ks == nullptr) != (vs == nullptr) || n_q < 1 || Hkv <= 0 ||
      H % Hkv != 0 || hd % 8 != 0 || hd < 8 || hd > 256 || ring_pages < 0 ||
      split_tokens <= 0 || split_tokens % kDecStageKeys != 0 ||
      split_tokens > kDecMaxSplit)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* tbl = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(lens);
  const int* pos = static_cast<const int*>(positions);
  float* ws = static_cast<float*>(workspace);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ks != nullptr)
    return dispatch_dec_mode<int8_t>(q, k_pool, v_pool, ks, vs, tbl, ln, pos,
                                     out, ws, B, n_q, H, Hkv, hd, bs, P,
                                     ring_pages, window, split_tokens, scale,
                                     s);
  return dispatch_dec_mode<bf16>(q, k_pool, v_pool, nullptr, nullptr, tbl,
                                 ln, pos, out, ws, B, n_q, H, Hkv, hd, bs, P,
                                 ring_pages, window, split_tokens, scale, s);
}
