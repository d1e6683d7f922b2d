// Split-K flash-decode / flash-extend attention over a stored KV cache,
// for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of mlapi_tpu/ops/pallas/decode_attention.py:
//   mlapi_decode_attention        <- _decode_kernel (decode_attention, B1)
//   mlapi_extend_attention        <- _extend_kernel (extend_attention, B2)
//   mlapi_paged_decode_attention  <- _paged_kernel (paged_decode_attention,
//                                    B3, decode_attention.py:514)
//   mlapi_paged_extend_attention  <- _paged_extend_kernel
//                                    (paged_extend_attention, B4, :643)
// All four entry points share one templated body. They differ in the
// query height U (1 for a decode step, the span width for an extend) and
// in where key `key` of batch row b lives: row b of a contiguous
// [B, L, KVH, D] cache, or -- PAGED -- slot key % page of pool page
// table[b, key / page] of a [P, page, KVH, D] pool (the Pallas kernels'
// scalar-prefetched BlockSpec index map, done per key here).
//
// What it computes: for batch row b, KV head j and a range of cache keys
// (one split), the partial triple (acc, m, l) of softmax attention for
// every query row the head serves -- rows laid out [KVH, U, group]-flat,
// row r of head j being span position u = r / group and query head
// j * group + r % group. acc is the un-normalised f32 output, m the
// running max and l the normaliser. A second small kernel merges the
// splits with the log-sum-exp algebra of the JAX package's
// _splitk_merge_rows and writes [B, U, H, D] in q's dtype, so one call
// from Python costs one C call and two launches.
//
// What bounds it on the card: the cache read. A decode step does about
// one FLOP per byte of K/V (4*H*D FLOPs per key against 2*KVH*D stored
// elements), far below the ~295 FLOP/byte at which an H100 stops being
// memory-bound, so time is bytes / 3.35 TB/s at best. An extend span of
// U = 128 rows does 128x the FLOPs per byte; at tensor-core rates it
// would still be memory-bound, but this first version computes with
// CUDA-core f32 FMAs, which makes the extend case compute-bound.
//
// A paged call is bound by the same bytes: the K/V of the live pages
// (plus an int32 [B, NP] table, noise beside them). The page id is
// looked up per key, not per tile, so a 32-key tile may straddle pages
// of any size (8, 16, 64 tokens); the dead-tile test runs on virtual
// slots before any table or pool load, exactly as in the contiguous
// body. With the same virtual length, a paged call and a contiguous call
// over the same bytes do the same arithmetic in the same order, so their
// outputs are bit-identical. Page ids are trusted (as in Pallas): the
// plain PyTorch version is where an out-of-range id raises.
//
// What the design does about it:
//   * the grid is (splits, KVH * row-chunks, B), and the wrapper picks
//     the split count so that even B = 8 at KVH = 12 puts several
//     blocks on each of the 132 SMs;
//   * the stored format is what crosses device memory: K/V tiles load
//     with 16-byte vector loads in their stored type (bf16, f32, or
//     int8 + one f32 scale per token and head) and are dequantised in
//     registers with the JAX package's arithmetic, q.astype(dt) *
//     scale.astype(dt) computed in dt;
//   * a 32-key tile whose mask is zero for every row of the block skips
//     its LOAD as well as its math (the TPU kernel skipped only the
//     math), so a half-empty cache tier costs half the bytes;
//   * every query row of a KV head reads the same K/V tile from shared
//     memory, so GQA groups and U-row spans share one load.
//
// Numerics follow the Pallas kernels: f32 products and accumulation,
// scores = (q . k) * scale plus (1 - keep) * NEG with the finite
// NEG = -1e30, p = exp(s - m) * keep (so a fully masked row gives exact
// zeros), and p rounded to the value dtype before the PV product. The
// softmax inside a split runs online over its tiles instead of once per
// tile, which changes rounding only.
//
// C interface (for ctypes): every pointer is a device pointer, the
// stream is a cudaStream_t, and the return value is cudaGetLastError()
// after the launches (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTileKeys = 32;  // one key per lane of a warp
constexpr int kRowChunk = 32;  // query rows held per block
constexpr float kNeg = -1e30f;

struct Params {
  const void* q;        // [B, U, H, D] in T, strides below (last dim 1)
  const void* k;        // [B, L, KVH, D] in T, or int8 payload
  const void* v;
  const float* ks;      // [B, L, KVH] scales (int8 format only)
  const float* vs;
  const uint8_t* mask;  // [B, U, L] bool, nonzero = attend
  const int* table;     // [B, NP] pool page ids (paged entry points only)
  float* acc;           // [B, S, KVH * U * group, D]
  float* m;             // [B, S, KVH * U * group]
  float* l;
  void* out;            // [B, U, H, D] in T, contiguous
  long long q_sb, q_su, q_sh;
  int B, U, H, KVH, L, S, tiles_per_split, row_chunks;
  int page, NP;         // paged: L == NP * page
  float scale;
};

// Row (in units of D elements) of key `key`, head j, batch row b: the
// contiguous layout, or the pool row that the page table maps it to.
template <bool PAGED>
__device__ __forceinline__ size_t kv_row(const Params& p, int b, int key,
                                         int j) {
  if constexpr (PAGED) {
    const int pid = p.table[static_cast<size_t>(b) * p.NP + key / p.page];
    return (static_cast<size_t>(pid) * p.page + key % p.page) * p.KVH + j;
  } else {
    return (static_cast<size_t>(b) * p.L + key) * p.KVH + j;
  }
}

template <typename T> struct Ops;

template <> struct Ops<float> {
  static __device__ float load(const float* p) { return *p; }
  static __device__ float round(float x) { return x; }
  static __device__ float store(float x) { return x; }
  static __device__ float dequant(int8_t q, float s) {
    return static_cast<float>(q) * s;
  }
  static constexpr int kVec = 4;  // elements per 16-byte load
  static __device__ void unpack(const uint4& raw, float* out) {
    const float* f = reinterpret_cast<const float*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = f[i];
  }
};

template <> struct Ops<__nv_bfloat16> {
  static __device__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
  static __device__ __nv_bfloat16 store(float x) {
    return __float2bfloat16(x);
  }
  static __device__ float dequant(int8_t q, float s) {
    // bf16(q) * bf16(scale), rounded once to bf16: the JAX package's
    // q.astype(bf16) * scale.astype(bf16).
    return __bfloat162float(
        __hmul(__float2bfloat16(static_cast<float>(q)),
               __float2bfloat16(s)));
  }
  static constexpr int kVec = 8;
  static __device__ void unpack(const uint4& raw, float* out) {
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = __bfloat162float(h[i]);
  }
};

// Load one [kTileKeys, D] tile of K or V for head j into shared memory
// as f32 (dequantised for the int8 format). Keys at or past L load 0.
template <typename T, bool QUANT, bool PAGED, int D, int STRIDE>
__device__ void load_tile(const Params& p, const void* src,
                          const float* scales, int b, int j, int key0,
                          float (*dst)[STRIDE]) {
  if constexpr (QUANT) {
    constexpr int kPer = 16;  // int8 per 16-byte load
    constexpr int kVecs = D / kPer;
    for (int idx = threadIdx.x; idx < kTileKeys * kVecs; idx += kThreads) {
      int t = idx / kVecs, c = idx % kVecs, key = key0 + t;
      float vals[kPer];
      if (key < p.L) {
        const size_t off = kv_row<PAGED>(p, b, key, j);
        uint4 raw = *reinterpret_cast<const uint4*>(
            static_cast<const int8_t*>(src) + off * D + c * kPer);
        float s = scales[off];
        const int8_t* q8 = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
        for (int i = 0; i < kPer; ++i) vals[i] = Ops<T>::dequant(q8[i], s);
      } else {
#pragma unroll
        for (int i = 0; i < kPer; ++i) vals[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i) dst[t][c * kPer + i] = vals[i];
    }
  } else {
    constexpr int kPer = Ops<T>::kVec;
    constexpr int kVecs = D / kPer;
    for (int idx = threadIdx.x; idx < kTileKeys * kVecs; idx += kThreads) {
      int t = idx / kVecs, c = idx % kVecs, key = key0 + t;
      float vals[kPer];
      if (key < p.L) {
        const size_t off = kv_row<PAGED>(p, b, key, j);
        uint4 raw = *reinterpret_cast<const uint4*>(
            static_cast<const T*>(src) + off * D + c * kPer);
        Ops<T>::unpack(raw, vals);
      } else {
#pragma unroll
        for (int i = 0; i < kPer; ++i) vals[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i) dst[t][c * kPer + i] = vals[i];
    }
  }
}

__device__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, bool QUANT, bool PAGED, int D>
__global__ void __launch_bounds__(kThreads)
    splitk_attention_kernel(Params p) {
  constexpr int kPerLane = D / 32;  // output columns each lane owns
  __shared__ float q_s[kRowChunk][D];
  __shared__ float acc_s[kRowChunk][D];
  __shared__ float m_s[kRowChunk];
  __shared__ float l_s[kRowChunk];
  __shared__ float k_s[kTileKeys][D + 1];  // +1: conflict-free dot reads
  __shared__ float v_s[kTileKeys][D];

  const int split = blockIdx.x;
  const int j = blockIdx.y / p.row_chunks;
  const int chunk = blockIdx.y % p.row_chunks;
  const int b = blockIdx.z;
  const int group = p.H / p.KVH;
  const int rows = p.U * group;  // query rows served by head j
  const int r0 = chunk * kRowChunk;
  const int nr = min(kRowChunk, rows - r0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int idx = threadIdx.x; idx < nr * D; idx += kThreads) {
    int r = idx / D, d = idx % D, rr = r0 + r;
    int u = rr / group, h = j * group + rr % group;
    q_s[r][d] = Ops<T>::load(static_cast<const T*>(p.q) + b * p.q_sb +
                             u * p.q_su + h * p.q_sh + d);
    acc_s[r][d] = 0.f;
  }
  for (int r = threadIdx.x; r < nr; r += kThreads) {
    m_s[r] = kNeg;
    l_s[r] = 0.f;
  }

  const int u_lo = r0 / group, u_hi = (r0 + nr - 1) / group;
  const int n_tiles = (p.L + kTileKeys - 1) / kTileKeys;
  const int t_begin = split * p.tiles_per_split;
  const int t_end = min(n_tiles, t_begin + p.tiles_per_split);
  for (int tile = t_begin; tile < t_end; ++tile) {
    const int key0 = tile * kTileKeys;
    int live = 0;
    for (int idx = threadIdx.x; idx < (u_hi - u_lo + 1) * kTileKeys;
         idx += kThreads) {
      int u = u_lo + idx / kTileKeys, key = key0 + idx % kTileKeys;
      if (key < p.L && p.mask[(static_cast<size_t>(b) * p.U + u) * p.L + key])
        live = 1;
    }
    // Also the barrier that keeps the previous tile's readers ahead of
    // this tile's writers.
    if (!__syncthreads_or(live)) continue;  // dead tile: no load, no math
    load_tile<T, QUANT, PAGED, D, D + 1>(p, p.k, p.ks, b, j, key0, k_s);
    load_tile<T, QUANT, PAGED, D, D>(p, p.v, p.vs, b, j, key0, v_s);
    __syncthreads();

    const int key = key0 + lane;
    for (int r = warp; r < nr; r += kWarps) {
      const int u = (r0 + r) / group;
      const float keep =
          key < p.L && p.mask[(static_cast<size_t>(b) * p.U + u) * p.L + key]
              ? 1.f
              : 0.f;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) dot = fmaf(q_s[r][d], k_s[lane][d], dot);
      const float s = dot * p.scale + (1.f - keep) * kNeg;
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float pe = expf(s - m_new) * keep;
      const float l_tile = warp_sum(pe);
      const float alpha = expf(m_old - m_new);
      const float pv = Ops<T>::round(pe);  // p in the value dtype
      float a[kPerLane];
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) a[i] = acc_s[r][lane + 32 * i] * alpha;
#pragma unroll 8
      for (int t = 0; t < kTileKeys; ++t) {
        const float pt = __shfl_sync(0xffffffffu, pv, t);
#pragma unroll
        for (int i = 0; i < kPerLane; ++i)
          a[i] = fmaf(pt, v_s[t][lane + 32 * i], a[i]);
      }
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) acc_s[r][lane + 32 * i] = a[i];
      __syncwarp();
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + l_tile;
      }
      __syncwarp();
    }
  }
  __syncthreads();

  const size_t part_rows = static_cast<size_t>(p.KVH) * rows;
  const size_t base = (static_cast<size_t>(b) * p.S + split) * part_rows +
                      static_cast<size_t>(j) * rows + r0;
  for (int idx = threadIdx.x; idx < nr * D; idx += kThreads) {
    int r = idx / D, d = idx % D;
    p.acc[(base + r) * D + d] = acc_s[r][d];
  }
  for (int r = threadIdx.x; r < nr; r += kThreads) {
    p.m[base + r] = m_s[r];
    p.l[base + r] = l_s[r];
  }
}

// Split-K merge (the JAX package's _splitk_merge_rows, then the
// [KVH, U, group] -> [B, U, H, D] relayout): one block per (row, b), one
// thread per output column. alpha_s = exp(m_s - max m); rows whose l is
// 0 in every split (no valid key) come out exactly 0.
template <typename T>
__global__ void splitk_merge_kernel(Params p, int D) {
  const int ri = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int group = p.H / p.KVH;
  const int rows = p.U * group;
  const int j = ri / rows, rr = ri % rows;
  const int u = rr / group, h = j * group + rr % group;
  const size_t part_rows = static_cast<size_t>(p.KVH) * rows;
  const size_t row0 = static_cast<size_t>(b) * p.S * part_rows + ri;
  float m_max = kNeg;
  for (int s = 0; s < p.S; ++s) m_max = fmaxf(m_max, p.m[row0 + s * part_rows]);
  float l_tot = 0.f, acc = 0.f;
  for (int s = 0; s < p.S; ++s) {
    const size_t at = row0 + s * part_rows;
    const float alpha = expf(p.m[at] - m_max);
    l_tot += alpha * p.l[at];
    acc += alpha * p.acc[at * D + d];
  }
  const float o = acc / fmaxf(l_tot, 1e-30f);
  static_cast<T*>(p.out)[((static_cast<size_t>(b) * p.U + u) * p.H + h) * D +
                         d] = Ops<T>::store(o);
}

template <typename T, bool QUANT, bool PAGED>
int launch_d(const Params& p, int D, cudaStream_t stream) {
  dim3 grid(p.S, p.KVH * p.row_chunks, p.B);
  // The one head dim a served model has (GPT-2 small: 64). D = 128 would
  // need a dynamic-shared-memory variant, left for a later version.
  if (D != 64) return static_cast<int>(cudaErrorInvalidValue);
  splitk_attention_kernel<T, QUANT, PAGED, 64>
      <<<grid, kThreads, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 mgrid(p.KVH * p.U * (p.H / p.KVH), p.B);
  splitk_merge_kernel<T><<<mgrid, D, 0, stream>>>(p, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool PAGED>
int launch_t(const Params& p, int quant, int D, cudaStream_t s) {
  return quant ? launch_d<T, true, PAGED>(p, D, s)
               : launch_d<T, false, PAGED>(p, D, s);
}

// table == NULL: the contiguous layout, L keys per row. Otherwise the
// paged layout: L == NP * page virtual slots per row.
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* table, const void* mask,
           void* partials, void* out, long long q_sb, long long q_su,
           long long q_sh, int dtype, int quant, int B, int U, int H,
           int KVH, int L, int NP, int page, int D, int S,
           int tiles_per_split, int row_chunks, float scale, void* stream) {
  Params p;
  const size_t n_rows = static_cast<size_t>(B) * S * KVH * U * (H / KVH);
  p.q = q;
  p.k = k;
  p.v = v;
  p.ks = static_cast<const float*>(ks);
  p.vs = static_cast<const float*>(vs);
  p.mask = static_cast<const uint8_t*>(mask);
  p.table = static_cast<const int*>(table);
  // One scratch buffer: acc [n_rows, D], then m [n_rows], then l.
  p.acc = static_cast<float*>(partials);
  p.m = p.acc + n_rows * D;
  p.l = p.m + n_rows;
  p.out = out;
  p.q_sb = q_sb;
  p.q_su = q_su;
  p.q_sh = q_sh;
  p.B = B;
  p.U = U;
  p.H = H;
  p.KVH = KVH;
  p.L = L;
  p.S = S;
  p.tiles_per_split = tiles_per_split;
  p.row_chunks = row_chunks;
  p.page = page;
  p.NP = NP;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool paged = table != nullptr;
  if (paged && (page < 1 || NP < 1 || L != NP * page))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    return paged ? launch_t<float, true>(p, quant, D, s)
                 : launch_t<float, false>(p, quant, D, s);
  }
  if (dtype == 1) {
    return paged ? launch_t<__nv_bfloat16, true>(p, quant, D, s)
                 : launch_t<__nv_bfloat16, false>(p, quant, D, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Every entry point: q (strides q_sb, q_su, q_sh in elements, last dim
// contiguous), k, v (payloads), ks, vs (int8 scales or NULL), mask (bool
// [B, U, L]), partials (f32 scratch of B*S*H*U*(D+2) floats), out (the
// [B, U, H, D] result in q's dtype). dtype: 0 f32, 1 bf16. The paged
// entry points take k, v, ks, vs as pools [P, page, KVH, D | 1], the
// int32 page table [B, NP] and L = NP * page virtual slots.
extern "C" {

// B1: one query row per batch row (U = 1).
int mlapi_decode_attention(const void* q, const void* k, const void* v,
                           const void* ks, const void* vs, const void* mask,
                           void* partials, void* out, long long q_sb,
                           long long q_su, long long q_sh, int dtype,
                           int quant, int B, int U, int H, int KVH, int L,
                           int D, int S, int tiles_per_split, int row_chunks,
                           float scale, void* stream) {
  if (U != 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch(q, k, v, ks, vs, nullptr, mask, partials, out, q_sb, q_su,
                q_sh, dtype, quant, B, 1, H, KVH, L, 0, 0, D, S,
                tiles_per_split, row_chunks, scale, stream);
}

// B2: U query rows per batch row, the causal span structure in the mask.
int mlapi_extend_attention(const void* q, const void* k, const void* v,
                           const void* ks, const void* vs, const void* mask,
                           void* partials, void* out, long long q_sb,
                           long long q_su, long long q_sh, int dtype,
                           int quant, int B, int U, int H, int KVH, int L,
                           int D, int S, int tiles_per_split, int row_chunks,
                           float scale, void* stream) {
  return launch(q, k, v, ks, vs, nullptr, mask, partials, out, q_sb, q_su,
                q_sh, dtype, quant, B, U, H, KVH, L, 0, 0, D, S,
                tiles_per_split, row_chunks, scale, stream);
}

// B3: B1 over pool pages, through the page table.
int mlapi_paged_decode_attention(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* table, const void* mask, void* partials,
    void* out, long long q_sb, long long q_su, long long q_sh, int dtype,
    int quant, int B, int U, int H, int KVH, int NP, int page, int D, int S,
    int tiles_per_split, int row_chunks, float scale, void* stream) {
  if (U != 1 || table == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(q, k, v, ks, vs, table, mask, partials, out, q_sb, q_su,
                q_sh, dtype, quant, B, 1, H, KVH, NP * page, NP, page, D, S,
                tiles_per_split, row_chunks, scale, stream);
}

// B4: B2 over pool pages; a span may start mid-page and cross pages (the
// [B, U, NP * page] mask carries that).
int mlapi_paged_extend_attention(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* table, const void* mask, void* partials,
    void* out, long long q_sb, long long q_su, long long q_sh, int dtype,
    int quant, int B, int U, int H, int KVH, int NP, int page, int D, int S,
    int tiles_per_split, int row_chunks, float scale, void* stream) {
  if (table == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch(q, k, v, ks, vs, table, mask, partials, out, q_sb, q_su,
                q_sh, dtype, quant, B, U, H, KVH, NP * page, NP, page, D, S,
                tiles_per_split, row_chunks, scale, stream);
}

}  // extern "C"
