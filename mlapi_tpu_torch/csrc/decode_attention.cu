// Flash-decode / flash-extend attention over a stored KV cache, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of mlapi_tpu/ops/pallas/decode_attention.py:
//   mlapi_decode_attention        <- _decode_kernel (decode_attention, B1)
//   mlapi_extend_attention        <- _extend_kernel (extend_attention, B2)
//   mlapi_paged_decode_attention  <- _paged_kernel (paged_decode_attention,
//                                    B3, decode_attention.py:514)
//   mlapi_paged_extend_attention  <- _paged_extend_kernel
//                                    (paged_extend_attention, B4, :643)
//
// What every entry point computes: softmax(q . K^T * scale + (1 - keep) *
// NEG) . V for every query row, rows of query head h reading KV head
// h / (H / KVH) (grouped-query attention, no repeated K/V). Key `key` of
// batch row b lives in row b of a contiguous [B, L, KVH, d] cache, or --
// PAGED -- in slot key % page of pool page table[b, key / page] of a
// [P, page, KVH, d] pool (the Pallas kernels' scalar-prefetched BlockSpec
// index map, done per key row here), so a tile may straddle pages of any
// size. The result is [B, U, H, d] in q's dtype.
//
// Head dims: every d >= 1. The CUDA-core bodies are compiled for D in
// {16, 32, 64, 128, 256}, the tensor-core body for {16, 32, 64, 128} (at
// 256 its O accumulators alone would take 128 registers a thread and its
// ring 235 KB). A call with another d <= 256 (12, 48, 160, ...) runs a
// CUDA-core body at the next compiled D with the runtime d: loads and
// stores are guarded per element, and a cache row whose d elements are no
// whole number of the body's copy chunks is read element by element. A
// call with d > 256 runs splitk_attention_kernel at D = 256 in
// nd = ceil(d / 256) column chunks (below). The cache is never copied or
// padded.
//
// Three bodies, chosen by entry point, dtype and d (a dispatch, not a
// fallback: each call runs exactly one of them, and the wrapper's
// _geometry() mirrors the choice):
//
//   decode_kernel           every decode call (B1, B3) at d <= 256, f32
//                           or bf16 queries over a bf16, f32 or int8
//                           cache;
//   extend_mma_kernel       the extend entry points (B2, B4) with bf16
//                           queries, U > 1 and a compiled d <= 128;
//   splitk_attention_kernel every other call: extend with f32 queries
//                           (tensor cores would need TF32, which breaks
//                           the port's 1e-5 bound in f32; f32 is the
//                           card's correctness witness), U = 1, uncompiled
//                           d or d > 128, and every call with d > 256.
//
// What bounds them on the card: the cache read. A decode step does about
// one FLOP per byte of K/V (4*H*d FLOPs per key against 2*KVH*d stored
// elements), far below the ~295 FLOP/byte at which an H100 stops being
// memory-bound, so time is bytes / 3.35 TB/s at best. An extend span of
// U = 128 rows does 128x the FLOPs per byte -- still under the line on
// the tensor cores, but some 50x over it on CUDA-core f32 FMAs. So decode
// is a memory pipeline on the CUDA cores and extend runs on the tensor
// cores.
//
// decode_kernel (B1/B3): built to keep the card's memory system busy.
//   * One block (4 warps) serves every query head of one KV head (up to 8;
//     a larger group takes several blocks), so a GQA group reads each K/V
//     row once; q stays in registers.
//   * The splits of one (b, KV head) -- at most 8 -- are one thread-block
//     cluster. Each block walks its own key range; the blocks combine
//     (acc, m, l) through distributed shared memory and the cluster's
//     rank 0 writes the output. No merge launch, no partials in HBM.
//   * Every warp streams keys on its own: a lane owns one chunk of a key
//     row (16 bytes: 8 bf16 or 4 f32; 8 bytes of int8), so D / 8 lanes
//     cover a bf16 row and a warp instruction covers 256 / D keys (4 at
//     D = 64); partial dots reduce with __shfl_xor inside the lane group.
//     A warp takes every fourth tile of its block's range (a tile is 1 KB
//     of K and 1 KB of V: 8 keys of bf16 at D = 64), through a ring of
//     three tiles in shared memory filled by cp.async, so two tiles are in
//     flight while one computes -- with no block barrier in the key loop
//     (each lane reads back the chunks it copied; scales pass through a
//     __syncwarp). Rings of 24 KB leave room for as many blocks as the
//     registers allow (seven of one head, 28 warps, an SM). Each warp
//     keeps its own online softmax (base 2 on ex2 for bf16 queries); the
//     warps combine once, through shared memory, at the end. On an H100
//     this math (about 230 instructions per 8-key tile, with dependent
//     shuffles) takes about as long as the memory stream and overlaps it
//     only in part: ~37 % of the byte bound at B = 8, L = 1024 (PERF.md).
//   * The mask is read once, in the prologue, 16 bytes a thread, into bit
//     words in shared memory while q loads: it is the dead-tile test (a
//     tile whose keys are all masked is neither copied nor computed) and
//     the math's only mask read. Paged: the block's page ids load once
//     beside it, so that no copy waits on a table load.
//   * int8: payload chunks and per-key f32 scales are copied the same way
//     and dequantised in registers with the JAX arithmetic, bf16(q) *
//     bf16(scale) rounded once (Ops<bf16>::dequant).
//
// splitk_attention_kernel (f32 / U = 1 / uncompiled-d extend, d > 256):
// one block of 4 warps owns 32 query rows of one KV head and a split of
// 32-key tiles; one warp walks one query row at a time, a key per lane,
// with f32 FMAs from shared memory; a second small kernel merges the
// splits with the log-sum-exp algebra of the JAX package's
// _splitk_merge_rows.
//   * d > 256: grid x holds nd = ceil(d / 256) column chunks beside the
//     splits, and each block owns the 256 output columns of its chunk, so
//     its shared tiles and accumulators keep their D = 256 size. Its
//     scores sum over all chunks: each 256-wide chunk of q and K streams
//     through the same q and K tiles in turn, and then the block's own
//     chunk of V. The blocks of one (split, rows) compute the same scores
//     in the same order, so m and l are bit-identical across chunks; chunk
//     0 writes them. The score work grows nd-fold: no model the port runs
//     has d > 256, and this path is for correctness.
//
// extend_mma_kernel (B2/B4 in bf16 and int8): one block of 8 warps owns
// 64 query rows of one KV head and a split of at most 16 64-key tiles.
// Warp w takes rows 16 * (w % 4).. and key half w / 4 of every tile: two
// warps share a row, each with its own online softmax, and the halves
// combine once, through shared memory, at the end.
//   * Q is read once through its strides (a view of the fused QKV
//     projection works) and held in registers as mma A-fragments
//     (ldmatrix) for the whole key loop.
//   * The dead-tile test comes first: the mask rows of the split's tiles
//     and the block's span positions are read once, 16 bytes a thread,
//     and packed into one 64-bit word per (tile, span position) in shared
//     memory -- the math's only mask read. A tile whose words are all
//     zero is neither copied nor computed. Paged: the split's page ids
//     are read beside them, so that no copy waits on a table load.
//   * K/V tiles go through a ring in shared memory (3 stages for bf16,
//     4 of int8) with cp.async 16-byte copies, one address per key row --
//     for the paged layout that address is the page lookup, which is why
//     this is cp.async and not TMA: a page of 8 or 16 keys breaks a tile
//     into pieces one TMA box cannot address.
//   * int8: payload and f32 scales are copied the same way, then
//     dequantised into a bf16 shared tile with the JAX arithmetic.
//   * S = Q K^T and O += P V are mma.sync.m16n8k16 bf16 -> f32 (K by
//     ldmatrix, V by ldmatrix.trans); shared rows are padded by 16 bytes
//     so that the eight rows ldmatrix reads fall in distinct banks.
//     Softmax is online in FlashAttention-2's register layout, in base 2.
//   * With one split (the wrapper picks one whenever the row blocks alone
//     fill the card) the block normalises and writes the output itself,
//     and the merge kernel is not launched.
//
// A paged call is bound by the same bytes (plus an int32 [B, NP] table,
// noise beside them) and runs the same body with PAGED set, which changes
// only a key's row address: with the same virtual length, a paged call and
// a contiguous call over the same bytes do the same arithmetic in the same
// order and give bit-identical outputs. Page ids are trusted (as in
// Pallas): the plain PyTorch version is where an out-of-range id raises.
//
// Numerics follow the Pallas kernels: f32 accumulation, scores =
// (q . k) * scale plus (1 - keep) * NEG with the finite NEG = -1e30,
// p = exp(s - m) * keep (so a row with no valid key gives exact zeros),
// and p rounded to the value dtype before the PV product. Rounding
// differs from the plain version, which follows the Pallas tiling, in
// these places: the softmax runs online over a split's tiles instead of
// once per tile, and sums run in another order (lane groups, warps,
// splits; in the mma body the tensor cores, base-2 ex2 and 1 / l). All
// stay within 2e-2 in bf16 on live rows, 1e-5 in f32.
//
// Build: nvcc compiles this file once per compiled head dim
// (-DMLAPI_UNIT=16, 32, 64, 128, 256: the kernels of that D) and once for
// the C entry points (-DMLAPI_UNIT=0), all at once, and links the objects
// into one library; without MLAPI_UNIT it is one translation unit holding
// all. The cp.async, ldmatrix and mma.sync wrappers live in
// tile_primitives.cuh, shared with flash_attention.cu.
//
// C interface (for ctypes): every pointer is a device pointer, the
// stream is a cudaStream_t, and the return value is the first CUDA error
// of the attribute call and the launches (0 on success), or
// cudaErrorInvalidValue for a geometry the body does not take.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tile_primitives.cuh"

#ifndef MLAPI_UNIT
#define MLAPI_UNIT -1
#endif

namespace mlapi_decode {

constexpr int kThreads = 128;  // splitk: 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTileKeys = 32;  // splitk: one key per lane of a warp
constexpr int kRowChunk = 32;  // splitk: query rows held per block
constexpr float kNeg = -1e30f;

constexpr int kMmaRows = 64;           // query rows per block, 16 per row group
constexpr int kMmaKeys = 64;           // keys per tile
constexpr int kMaxSplitTiles = 16;     // tiles of one split (mask words held)
constexpr int kMmaThreads = 256;       // 8 warps: 4 row groups x 2 key halves

constexpr int kDecThreads = 128;       // decode: 4 warps
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kDecTileBytes = 1024;    // bytes of K (and of V) in a warp tile
constexpr int kDecStages = 3;          // tiles in a warp's ring
constexpr int kMaxCluster = 8;         // splits of one (b, KV head): one cluster

enum Body { kBodyFma = 0, kBodyMma = 1, kBodyDecode = 2 };

// The head dim a call compiles to: the least of {16, 32, 64, 128, 256}
// that holds d, and 256 past it (run in d_chunks(d) column chunks).
__host__ __device__ constexpr int compiled_d(int d) {
  return d <= 16    ? 16
         : d <= 32  ? 32
         : d <= 64  ? 64
         : d <= 128 ? 128
                    : 256;
}
__host__ __device__ constexpr int d_chunks(int d) { return (d + 255) / 256; }

// decode_kernel's geometry: elements in one lane's chunk of a key row (16
// bytes of f32 or bf16, 8 bytes of int8; 32 bytes of f32 at D = 256, so
// that a row still fits the 32 lanes of a warp); keys per warp tile (1 KB
// of K and 1 KB of V); query heads a block serves for a GQA group (the
// register arrays are sized by it).
__host__ __device__ constexpr int dec_chunk_elems(bool f32_cache, int d_c) {
  return f32_cache && d_c <= 128 ? 4 : 8;
}
__host__ __device__ constexpr int dec_tile_keys(int d_c, int itemsize) {
  return kDecTileBytes / (d_c * itemsize);
}
__host__ __device__ constexpr int dec_heads(int group) {
  return group == 1 ? 1 : group == 2 ? 2 : group <= 4 ? 4 : 8;
}

struct Params {
  const void* q;        // [B, U, H, d] in T, strides below (last dim 1)
  const void* k;        // [B, L, KVH, d] in T, or int8 payload
  const void* v;
  const float* ks;      // [B, L, KVH] scales (int8 format only)
  const float* vs;
  const uint8_t* mask;  // [B, U, L] bool, nonzero = attend
  const int* table;     // [B, NP] pool page ids (paged entry points only)
  float* acc;           // [B, S, KVH * U * group, d] (splitk, mma)
  float* m;             // [B, S, KVH * U * group]
  float* l;
  void* out;            // [B, U, H, d] in T, contiguous
  long long q_sb, q_su, q_sh;
  int B, U, H, KVH, L, S, tiles_per_split, row_chunks;
  int page, NP;         // paged: L == NP * page
  int d;                // the call's head dim (<= the compiled D * nd)
  int nd;               // splitk: column chunks of the compiled D
  float scale;
};

// The kernels of compiled head dim D (defined in unit D).
template <int D>
int launch_for_d(Body body, int dtype, bool quant, bool paged,
                 const Params& p, cudaStream_t stream);

}  // namespace mlapi_decode

#if MLAPI_UNIT != 0
namespace mlapi_decode {
namespace {

using namespace mlapi_tiles;

// Row (in units of d elements) of key `key`, head j, in pool page pid.
__device__ __forceinline__ size_t pool_row(const Params& p, int pid, int slot,
                                           int j) {
  return (static_cast<size_t>(pid) * p.page + slot) * p.KVH + j;
}

// Row (in units of d elements) of key `key`, head j, batch row b: the
// contiguous layout, or the pool row that the page table maps it to.
template <bool PAGED>
__device__ __forceinline__ size_t kv_row(const Params& p, int b, int key,
                                         int j) {
  if constexpr (PAGED) {
    return pool_row(p, p.table[static_cast<size_t>(b) * p.NP + key / p.page],
                    key % p.page, j);
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

// The unsigned integer of a stored element's width (copies move bits).
template <typename S>
using RawOf = typename std::conditional<
    sizeof(S) == 1, uint8_t,
    typename std::conditional<sizeof(S) == 2, uint16_t, uint32_t>::type>::type;

// Bit e of the result: byte e of the 16 is nonzero.
__device__ __forceinline__ uint32_t nonzero_bits16(const uint4& raw) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  uint32_t bits = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t ones = __vcmpne4(w[i], 0u) & 0x01010101u;
    bits |= ((ones * 0x01020408u) >> 24) << (4 * i);
  }
  return bits;
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

// -- decode_kernel: B1/B3 ------------------------------------------------

// Shared memory of a decode block: four warps' rings, then the mask words
// and page ids of the block's key range (sized by the launch).
template <typename S, bool QUANT, int D, int EV>
struct DecLayout {
  static constexpr int kTK = dec_tile_keys(D, static_cast<int>(sizeof(S)));
  static constexpr int kRow = D * static_cast<int>(sizeof(S));
  // K [TK][D], V [TK][D] (stored type), then int8 scales ks [TK], vs [TK].
  static constexpr int kStage = 2 * kTK * kRow + (QUANT ? 2 * kTK * 4 : 0);
  static constexpr int kRing = kDecWarps * kDecStages * kStage;
};

// Bytes before the mask words: the rings, or -- where it is larger (D = 256
// with 8 heads) -- the end-of-loop exchange that reuses them.
template <typename Lay, int D, int G>
__host__ __device__ constexpr int dec_front() {
  return Lay::kRing > G * (5 * D + 10) * 4 ? Lay::kRing : G * (5 * D + 10) * 4;
}

// Mask words and page ids a block of `tps` tiles holds (unit: 4 bytes).
__host__ __device__ inline int dec_words(int tps, int tk) {
  return tps * tk / 32 + 2;
}
__host__ __device__ inline int dec_pages(int tps, int tk, int page) {
  return tps * tk / page + 2;
}


// Block (split, KV head j and head chunk, b) of a cluster of S splits.
template <typename T, bool QUANT, bool PAGED, int D, int G>
__global__ void __launch_bounds__(kDecThreads) decode_kernel(Params p) {
  using S = typename std::conditional<QUANT, int8_t, T>::type;
  using Raw = RawOf<S>;
  constexpr int EV = dec_chunk_elems(std::is_same<S, float>::value, D);
  constexpr int LPK = D / EV;       // lanes per key row
  constexpr int KPW = 32 / LPK;     // keys per warp instruction
  using Lay = DecLayout<S, QUANT, D, EV>;
  constexpr int TK = Lay::kTK;      // keys per warp tile
  constexpr int KPI = TK / KPW;     // chunks of K (and of V) a lane copies
  static_assert(KPI * KPW == TK && KPI >= 1, "tile geometry");
  // bf16 queries: scores in base 2 (times log2 e) on the special-function
  // unit's ex2; f32 keeps expf for its 1e-5 bound.
  constexpr bool kBase2 = !std::is_same<T, float>::value;
  auto exp_ = [](float x) { return kBase2 ? ex2(x) : expf(x); };
  const float scale = kBase2 ? p.scale * 1.4426950408889634f : p.scale;
  // The end-of-loop exchange reuses the rings (dec_front covers it).
  constexpr int kFront = dec_front<Lay, D, G>();
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int split = blockIdx.x;
  const int j = blockIdx.y / p.row_chunks, hc = blockIdx.y % p.row_chunks;
  const int b = blockIdx.z;
  const int group = p.H / p.KVH;
  const int h0 = j * group + hc * G;           // first query head served
  const int ng = min(G, group - hc * G);       // heads served
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c = lane % LPK, kr = lane / LPK;   // chunk, key of an instruction

  const int n_tiles = (p.L + TK - 1) / TK;
  const int t_begin = split * p.tiles_per_split;
  const int t_end = min(n_tiles, t_begin + p.tiles_per_split);
  const int key_begin = t_begin * TK, key_end = min(p.L, t_end * TK);
  const int w0 = key_begin / 32;               // first mask word (absolute)
  const int nw = (t_end * TK + 31) / 32 - w0;
  uint32_t* bits = reinterpret_cast<uint32_t*>(smem_raw + kFront);
  int* page_of = reinterpret_cast<int*>(
      bits + dec_words(p.tiles_per_split, TK));

  // The mask of the block's keys -> bit words (bit k of word w: key
  // 32 w + k attends), 16 bytes a thread where the rows allow it.
  const uint8_t* mrow = p.mask + static_cast<size_t>(b) * p.L;
  if (p.L % 16 == 0 && reinterpret_cast<uintptr_t>(p.mask) % 16 == 0) {
    uint16_t* half = reinterpret_cast<uint16_t*>(bits);
    for (int i = tid; i < 2 * nw; i += kDecThreads) {
      const int key = 32 * w0 + 16 * i;
      const uint4 raw = key < p.L
                            ? __ldg(reinterpret_cast<const uint4*>(mrow + key))
                            : make_uint4(0u, 0u, 0u, 0u);
      half[i] = static_cast<uint16_t>(nonzero_bits16(raw));  // little-endian
    }
  } else {
    for (int i = tid; i < nw; i += kDecThreads) {
      const int k0 = 32 * (w0 + i);
      uint32_t w = 0u;
      for (int e = 0; e < 32; ++e)
        if (k0 + e < p.L && mrow[k0 + e]) w |= 1u << e;
      bits[i] = w;
    }
  }
  int first_page = 0, page_shift = 0;
  bool pow2 = false;
  if constexpr (PAGED) {
    first_page = key_begin / p.page;
    const int last_page = (key_end - 1) / p.page;
    for (int i = tid; i <= last_page - first_page; i += kDecThreads)
      page_of[i] = __ldg(p.table + static_cast<size_t>(b) * p.NP +
                         first_page + i);
    pow2 = (p.page & (p.page - 1)) == 0;
    page_shift = pow2 ? __ffs(p.page) - 1 : 0;
  }
  // This lane's columns of the block's query heads, in registers (zeros
  // past d and past the heads served), loaded while the mask lands.
  float qv[G][EV];
  {
    const T* qb = static_cast<const T*>(p.q) + b * p.q_sb;
#pragma unroll
    for (int h = 0; h < G; ++h)
#pragma unroll
      for (int e = 0; e < EV; ++e) {
        const int col = c * EV + e;
        qv[h][e] = h < ng && col < p.d
                       ? Ops<T>::load(qb + (h0 + h) * p.q_sh + col)
                       : 0.f;
      }
  }
  __syncthreads();

  auto bit = [&](int key) -> float {
    return (bits[(key >> 5) - w0] >> (key & 31)) & 1u ? 1.f : 0.f;
  };
  auto live = [&](int t) -> bool {
    const int k0 = t * TK;
    if constexpr (TK >= 32) {
      uint32_t any = 0u;
#pragma unroll
      for (int i = 0; i < TK / 32; ++i) any |= bits[(k0 >> 5) - w0 + i];
      return any != 0u;
    } else {
      return ((bits[(k0 >> 5) - w0] >> (k0 & 31)) & ((1u << TK) - 1u)) != 0u;
    }
  };
  // This warp's tiles are t_begin + warp, + 4, ...: the first live one at
  // or after t, or t_end.
  auto next_live = [&](int t) -> int {
    while (t < t_end && !live(t)) t += kDecWarps;
    return min(t, t_end);
  };
  // Row of key `key` (in units of d elements): the pool row through the
  // page ids in shared memory, or b's row of the contiguous cache.
  const size_t row0 = static_cast<size_t>(b) * p.L * p.KVH + j;
  auto row_of = [&](int key) -> size_t {
    if constexpr (PAGED) {
      const int pg = pow2 ? key >> page_shift : key / p.page;
      const int slot = pow2 ? key & (p.page - 1) : key % p.page;
      return pool_row(p, page_of[pg - first_page], slot, j);
    } else {
      return row0 + static_cast<size_t>(key) * p.KVH;
    }
  };

  unsigned char* ring = smem_raw + warp * kDecStages * Lay::kStage;
  auto stage_k = [&](int st) {
    return reinterpret_cast<Raw*>(ring + st * Lay::kStage);
  };
  auto stage_scales = [&](int st) {
    return reinterpret_cast<float*>(ring + st * Lay::kStage + 2 * TK * Lay::kRow);
  };
  const bool vec = p.d % EV == 0;   // whole chunks: cp.async; else elements
  const Raw* kg = static_cast<const Raw*>(p.k);
  const Raw* vg = static_cast<const Raw*>(p.v);

  // Tile t's K/V rows (and int8 scales) -> stage st: lane (c, kr) copies
  // chunk c of keys kr, kr + KPW, ...; keys at or past L are zero-filled.
  auto issue = [&](int t, int st) {
    Raw* kd0 = stage_k(st);
    Raw* vd0 = kd0 + TK * D;
#pragma unroll
    for (int i = 0; i < KPI; ++i) {
      const int r = i * KPW + kr, key = t * TK + r;
      const bool ok = key < p.L;
      const size_t row = ok ? row_of(key) : 0;
      const size_t src = row * p.d + c * EV;
      Raw* kd = kd0 + r * D + c * EV;
      Raw* vd = vd0 + r * D + c * EV;
      if (vec) {
        const bool on = ok && c * EV < p.d;
        if constexpr (EV * sizeof(S) == 16) {
          cp_async16(kd, kg + (on ? src : 0), on);
          cp_async16(vd, vg + (on ? src : 0), on);
        } else if constexpr (EV * sizeof(S) == 32) {
          cp_async16(kd, kg + (on ? src : 0), on);
          cp_async16(vd, vg + (on ? src : 0), on);
          cp_async16(kd + 4, kg + (on ? src + 4 : 0), on);
          cp_async16(vd + 4, vg + (on ? src + 4 : 0), on);
        } else {
          cp_async8(kd, kg + (on ? src : 0), on);
          cp_async8(vd, vg + (on ? src : 0), on);
        }
      } else {
#pragma unroll
        for (int e = 0; e < EV; ++e) {
          const bool on = ok && c * EV + e < p.d;
          kd[e] = on ? kg[src + e] : Raw(0);
          vd[e] = on ? vg[src + e] : Raw(0);
        }
      }
      if constexpr (QUANT) {
        if (c == 0) {
          cp_async4(stage_scales(st) + r, p.ks + row, ok);
          cp_async4(stage_scales(st) + TK + r, p.vs + row, ok);
        }
      }
    }
  };
  // One chunk (EV stored elements) from shared memory, as f32 (int8:
  // dequantised with the JAX arithmetic of Ops<T>::dequant).
  auto chunk = [&](const Raw* src, float sc, float (&out)[EV]) {
    if constexpr (QUANT) {
      const uint2 raw = *reinterpret_cast<const uint2*>(src);
      const int8_t* q8 = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
      for (int e = 0; e < EV; ++e) out[e] = Ops<T>::dequant(q8[e], sc);
    } else {
#pragma unroll
      for (int e = 0; e < EV; e += Ops<T>::kVec)
        Ops<T>::unpack(*reinterpret_cast<const uint4*>(src + e), out + e);
    }
  };

  float acc[G][EV], m_r[G], l_r[G];
#pragma unroll
  for (int h = 0; h < G; ++h) {
    m_r[h] = kNeg;
    l_r[h] = 0.f;
#pragma unroll
    for (int e = 0; e < EV; ++e) acc[h][e] = 0.f;
  }

  // The ring: this warp's first kDecStages - 1 live tiles in flight, one
  // commit group each (empty past the last live tile).
  int fetch = next_live(t_begin + warp);
#pragma unroll
  for (int s = 0; s < kDecStages - 1; ++s) {
    if (fetch < t_end) {
      issue(fetch, s);
      fetch = next_live(fetch + kDecWarps);
    }
    cp_async_commit();
  }
  int st = 0;
  for (int cur = next_live(t_begin + warp); cur < t_end;
       cur = next_live(cur + kDecWarps)) {
    cp_async_wait<kDecStages - 2>();   // tile cur has landed
    // Every lane's copies (and scales) visible; every lane is past tile
    // cur - 1, whose stage the next copy reuses.
    __syncwarp();
    if (fetch < t_end) {
      issue(fetch, (st + kDecStages - 1) % kDecStages);
      fetch = next_live(fetch + kDecWarps);
    }
    cp_async_commit();
    const Raw* kt = stage_k(st);
    const Raw* vt = kt + TK * D;
    const float* sc = stage_scales(st);

    // Scores of this lane group's keys for every head: the lane's partial
    // dot, reduced over the LPK lanes of the group.
    float s[KPI][G], keep[KPI];
#pragma unroll
    for (int i = 0; i < KPI; ++i) {
      const int r = i * KPW + kr, key = cur * TK + r;
      keep[i] = key < p.L ? bit(key) : 0.f;
      float kf[EV];
      chunk(kt + r * D + c * EV, QUANT ? sc[r] : 0.f, kf);
#pragma unroll
      for (int h = 0; h < G; ++h) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < EV; ++e) dot = fmaf(qv[h][e], kf[e], dot);
#pragma unroll
        for (int o = 1; o < LPK; o <<= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        s[i][h] = dot * scale + (1.f - keep[i]) * kNeg;
      }
    }
    // Online softmax per head over the warp's tile (max across the lane
    // groups); p rounded to the value dtype replaces the score.
#pragma unroll
    for (int h = 0; h < G; ++h) {
      float mx = s[0][h];
#pragma unroll
      for (int i = 1; i < KPI; ++i) mx = fmaxf(mx, s[i][h]);
#pragma unroll
      for (int o = LPK; o < 32; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_r[h], mx);
      const float alpha = exp_(m_r[h] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < KPI; ++i) {
        const float pe = exp_(s[i][h] - m_new) * keep[i];
        sum += pe;
        s[i][h] = Ops<T>::round(pe);   // p in the value dtype
      }
      l_r[h] = l_r[h] * alpha + sum;   // this lane group's keys
      m_r[h] = m_new;
#pragma unroll
      for (int e = 0; e < EV; ++e) acc[h][e] *= alpha;
    }
#pragma unroll
    for (int i = 0; i < KPI; ++i) {
      const int r = i * KPW + kr;
      float vf[EV];
      chunk(vt + r * D + c * EV, QUANT ? sc[TK + r] : 0.f, vf);
#pragma unroll
      for (int h = 0; h < G; ++h)
#pragma unroll
        for (int e = 0; e < EV; ++e) acc[h][e] = fmaf(s[i][h], vf[e], acc[h][e]);
    }
    st = (st + 1) % kDecStages;
  }
  cp_async_wait<0>();

  // The lane groups of the warp meet (same m, disjoint keys).
#pragma unroll
  for (int h = 0; h < G; ++h) {
#pragma unroll
    for (int o = LPK; o < 32; o <<= 1) {
      l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], o);
#pragma unroll
      for (int e = 0; e < EV; ++e)
        acc[h][e] += __shfl_xor_sync(0xffffffffu, acc[h][e], o);
    }
  }
  // The warps meet through the idle rings: wacc [warps][G][D], wml
  // [warps][G][2]; the block's (acc, m, l) goes to part [G][D], then m
  // [G] and l [G].
  __syncthreads();
  float* wacc = reinterpret_cast<float*>(smem_raw);
  float* wml = wacc + kDecWarps * G * D;
  float* part = wml + kDecWarps * G * 2;
  if (kr == 0) {
#pragma unroll
    for (int h = 0; h < G; ++h)
#pragma unroll
      for (int e = 0; e < EV; ++e)
        wacc[(warp * G + h) * D + c * EV + e] = acc[h][e];
  }
  if (lane == 0) {
#pragma unroll
    for (int h = 0; h < G; ++h) {
      wml[(warp * G + h) * 2] = m_r[h];
      wml[(warp * G + h) * 2 + 1] = l_r[h];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < G * D; idx += kDecThreads) {
    const int h = idx / D, col = idx % D;
    float mx = kNeg;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) mx = fmaxf(mx, wml[(w * G + h) * 2]);
    float a = 0.f, lsum = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) {
      const float al = exp_(wml[(w * G + h) * 2] - mx);
      a += al * wacc[(w * G + h) * D + col];
      lsum += al * wml[(w * G + h) * 2 + 1];
    }
    part[h * D + col] = a;
    if (col == 0) {
      part[G * D + h] = mx;
      part[G * D + G + h] = lsum;
    }
  }

  // The splits meet: rank 0 of the cluster reads every block's part
  // through distributed shared memory (the JAX package's
  // _splitk_merge_rows: alpha_s = exp(m_s - max m), rows whose l is 0
  // everywhere come out exactly 0) and writes the output.
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (cluster.block_rank() == 0) {
    const int ns = static_cast<int>(cluster.num_blocks());
    T* out = static_cast<T*>(p.out);
    for (int idx = tid; idx < ng * p.d; idx += kDecThreads) {
      const int h = idx / p.d, col = idx % p.d;
      float mx = kNeg;
      for (int r = 0; r < ns; ++r)
        mx = fmaxf(mx, cluster.map_shared_rank(part, r)[G * D + h]);
      float o = 0.f, lt = 0.f;
      for (int r = 0; r < ns; ++r) {
        const float* pr = cluster.map_shared_rank(part, r);
        const float al = exp_(pr[G * D + h] - mx);
        o += al * pr[h * D + col];
        lt += al * pr[G * D + G + h];
      }
      out[(static_cast<size_t>(b) * p.H + h0 + h) * p.d + col] =
          Ops<T>::store(o / fmaxf(lt, 1e-30f));
    }
  }
  cluster.sync();   // no block leaves while rank 0 reads its shared memory
}

// -- splitk_attention_kernel: f32, U = 1, uncompiled-d extend, d > 256 --

// Load columns [col0, col0 + D) of one [kTileKeys, d] tile of K or V for
// head j into shared memory as f32 (dequantised for the int8 format).
// Keys at or past L, and columns at or past d, load 0; rows of whole
// 16-byte pieces load 16 bytes a thread, others element by element.
template <typename T, bool QUANT, bool PAGED, int D>
__device__ void load_tile(const Params& p, const void* src,
                          const float* scales, int b, int j, int key0,
                          int col0, float* dst, int stride) {
  constexpr int kPer = QUANT ? 16 : Ops<T>::kVec;  // elements per 16 bytes
  constexpr int kVecs = D / kPer;
  const bool vec = p.d % kPer == 0;
  for (int idx = threadIdx.x; idx < kTileKeys * kVecs; idx += kThreads) {
    const int t = idx / kVecs, c = idx % kVecs, key = key0 + t;
    const int col = col0 + c * kPer;
    float vals[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) vals[i] = 0.f;
    if (key < p.L && col < p.d) {
      const size_t off = kv_row<PAGED>(p, b, key, j);
      const size_t at = off * p.d + col;
      if constexpr (QUANT) {
        const int8_t* s8 = static_cast<const int8_t*>(src);
        const float s = scales[off];
        if (vec) {
          uint4 raw = *reinterpret_cast<const uint4*>(s8 + at);
          const int8_t* q8 = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
          for (int i = 0; i < kPer; ++i) vals[i] = Ops<T>::dequant(q8[i], s);
        } else {
#pragma unroll
          for (int i = 0; i < kPer; ++i)
            if (col + i < p.d) vals[i] = Ops<T>::dequant(s8[at + i], s);
        }
      } else {
        const T* st = static_cast<const T*>(src);
        if (vec) {
          Ops<T>::unpack(*reinterpret_cast<const uint4*>(st + at), vals);
        } else {
#pragma unroll
          for (int i = 0; i < kPer; ++i)
            if (col + i < p.d) vals[i] = Ops<T>::load(st + at + i);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) dst[t * stride + c * kPer + i] = vals[i];
  }
}

// Shared memory of a splitk block (f32): q [32][D], acc [32][D], m [32],
// l [32], k [32][D + 1] (+1: conflict-free dot reads), v [32][D].
template <int D>
constexpr int splitk_smem_bytes() {
  return 4 * (kRowChunk * (2 * D + 2) + kTileKeys * (2 * D + 1));
}

// Block (split and column chunk, KV head j and row chunk, b).
template <typename T, bool QUANT, bool PAGED, int D>
__global__ void __launch_bounds__(kThreads)
    splitk_attention_kernel(Params p) {
  constexpr int kPerLane = (D + 31) / 32;  // output columns each lane owns
  constexpr int kRowsPerWarp = kRowChunk / kWarps;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);  // [kRowChunk][D]
  float* acc_s = q_s + kRowChunk * D;               // [kRowChunk][D]
  float* m_s = acc_s + kRowChunk * D;
  float* l_s = m_s + kRowChunk;
  float* k_s = l_s + kRowChunk;                     // [kTileKeys][D + 1]
  float* v_s = k_s + kTileKeys * (D + 1);           // [kTileKeys][D]

  const int split = blockIdx.x % p.S;
  const int col0 = (blockIdx.x / p.S) * D;  // this block's output columns
  const int j = blockIdx.y / p.row_chunks;
  const int chunk = blockIdx.y % p.row_chunks;
  const int b = blockIdx.z;
  const int group = p.H / p.KVH;
  const int rows = p.U * group;  // query rows served by head j
  const int r0 = chunk * kRowChunk;
  const int nr = min(kRowChunk, rows - r0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // Columns [c0, c0 + D) of the block's query rows -> q_s (0 past d).
  auto load_q = [&](int c0) {
    for (int idx = threadIdx.x; idx < nr * D; idx += kThreads) {
      int r = idx / D, d = idx % D, rr = r0 + r;
      int u = rr / group, h = j * group + rr % group;
      q_s[r * D + d] = c0 + d < p.d
                           ? Ops<T>::load(static_cast<const T*>(p.q) +
                                          b * p.q_sb + u * p.q_su +
                                          h * p.q_sh + c0 + d)
                           : 0.f;
    }
  };
  if (p.nd == 1) load_q(0);   // else streamed with K, chunk by chunk
  for (int idx = threadIdx.x; idx < nr * D; idx += kThreads)
    acc_s[idx] = 0.f;
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
    load_tile<T, QUANT, PAGED, D>(p, p.v, p.vs, b, j, key0, col0, v_s, D);
    // q . k of this lane's key for the warp's rows (r = warp + 4 i), one
    // D-wide column chunk after another.
    float dots[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) dots[i] = 0.f;
    for (int cc = 0; cc < p.nd; ++cc) {
      if (cc > 0) __syncthreads();  // the previous chunk's readers are done
      if (p.nd > 1) load_q(cc * D);
      load_tile<T, QUANT, PAGED, D>(p, p.k, p.ks, b, j, key0, cc * D, k_s,
                                    D + 1);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const int r = warp + kWarps * i;
        if (r < nr) {
          float dot = dots[i];
#pragma unroll 16
          for (int d = 0; d < D; ++d)
            dot = fmaf(q_s[r * D + d], k_s[lane * (D + 1) + d], dot);
          dots[i] = dot;
        }
      }
    }

    const int key = key0 + lane;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + kWarps * i;
      if (r >= nr) break;
      const int u = (r0 + r) / group;
      const float keep =
          key < p.L && p.mask[(static_cast<size_t>(b) * p.U + u) * p.L + key]
              ? 1.f
              : 0.f;
      const float s = dots[i] * p.scale + (1.f - keep) * kNeg;
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float pe = expf(s - m_new) * keep;
      const float l_tile = warp_sum(pe);
      const float alpha = expf(m_old - m_new);
      const float pv = Ops<T>::round(pe);  // p in the value dtype
      float a[kPerLane];
#pragma unroll
      for (int c = 0; c < kPerLane; ++c)
        a[c] = lane + 32 * c < D ? acc_s[r * D + lane + 32 * c] * alpha : 0.f;
#pragma unroll 8
      for (int t = 0; t < kTileKeys; ++t) {
        const float pt = __shfl_sync(0xffffffffu, pv, t);
#pragma unroll
        for (int c = 0; c < kPerLane; ++c)
          if (lane + 32 * c < D)
            a[c] = fmaf(pt, v_s[t * D + lane + 32 * c], a[c]);
      }
#pragma unroll
      for (int c = 0; c < kPerLane; ++c)
        if (lane + 32 * c < D) acc_s[r * D + lane + 32 * c] = a[c];
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
  const int width = min(D, p.d - col0);
  for (int idx = threadIdx.x; idx < nr * width; idx += kThreads) {
    int r = idx / width, d = idx % width;
    p.acc[(base + r) * p.d + col0 + d] = acc_s[r * D + d];
  }
  if (col0 == 0) {
    for (int r = threadIdx.x; r < nr; r += kThreads) {
      p.m[base + r] = m_s[r];
      p.l[base + r] = l_s[r];
    }
  }
}

// -- extend_mma_kernel: B2/B4 on the tensor cores ----------------------

// One stage of an int8 tile as it lands: payload rows and per-key scales.
template <int D>
struct alignas(16) Int8Stage {
  int8_t k[kMmaKeys][D];
  int8_t v[kMmaKeys][D];
  float ks[kMmaKeys];
  float vs[kMmaKeys];
};

struct NoStage {
  uint4 unused;
};

// Dynamic shared memory of one block. bf16: Q, a three-stage K/V ring,
// the split's mask words, live tiles and page ids. int8: a four-stage
// ring of int8 tiles, and one bf16 K/V tile that takes the dequantised
// current tile. Rows are padded by 8 bf16 (16 bytes). About 75 KB at
// D = 64, 134 KB at D = 128.
template <bool QUANT, int D>
struct MmaSmem {
  static constexpr int kPadRow = D + 8;
  static constexpr int kStages = QUANT ? 4 : 3;
  static constexpr int kBf16Stages = QUANT ? 1 : kStages;
  __nv_bfloat16 q[kMmaRows][kPadRow];
  __nv_bfloat16 k[kBf16Stages][kMmaKeys][kPadRow];
  __nv_bfloat16 v[kBf16Stages][kMmaKeys][kPadRow];
  // [tile of the split][span position - u_lo]: bit k = attend key k.
  unsigned long long mask[kMaxSplitTiles][kMmaRows];
  unsigned live;  // bit t: some row of the block attends tile t
  int page_of[kMaxSplitTiles * kMmaKeys];  // paged: the split's page ids
  typename std::conditional<QUANT, Int8Stage<D>, NoStage>::type i8[kStages];
};

// Signed byte e of `word` as a float, exactly, without an I2F: the
// biased byte e + 128 becomes the mantissa of 2^23 + (e + 128).
__device__ __forceinline__ float s8_to_float(uint32_t word, int e) {
  const uint32_t bits =
      __byte_perm(word ^ 0x80808080u, 0x4B000000u, 0x7440u | e);
  return __uint_as_float(bits) - 8388736.0f;  // 2^23 + 128
}

// Fragment layout of mma.m16n8k16: see tile_primitives.cuh. The scores
// of key tiles 2k and 2k + 1, rounded to bf16, are exactly the A fragment
// of P for keys 16k..16k + 15.
//
// Warp w owns rows 16 * (w % 4).. of the block and key half w / 4 (keys
// 32 * (w / 4).. of every tile): two warps share each row, each with its
// own online softmax, and the halves combine once, at the end.
template <bool QUANT, bool PAGED, int D>
__global__ void __launch_bounds__(kMmaThreads)
    extend_mma_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using Smem = MmaSmem<QUANT, D>;
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  using bf16 = __nv_bfloat16;
  constexpr int kStages = Smem::kStages;
  constexpr int KS = D / 16;   // 16-wide steps of d
  constexpr int DT = D / 8;    // 8-wide output column tiles
  // The end-of-loop exchange of (o, m, l) between key halves reuses k, v.
  static_assert(sizeof(Smem::k) + sizeof(Smem::v) >=
                    4 * 32 * (DT + 1) * sizeof(float4),
                "exchange does not fit");

  const int split = blockIdx.x;
  const int j = blockIdx.y / p.row_chunks;
  const int chunk = blockIdx.y % p.row_chunks;
  const int b = blockIdx.z;
  const int group = p.H / p.KVH;
  const int rows = p.U * group;  // query rows served by head j
  const int r0 = chunk * kMmaRows;
  const int nr = min(kMmaRows, rows - r0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wr = warp % 4, kh = warp / 4;  // row group, key half
  const int g = lane / 4, t4 = lane % 4;

  // Q of the block's rows -> shared, one cp.async group of its own
  // (zeros past the last row), in flight while the mask is read.
  for (int idx = tid; idx < kMmaRows * DT; idx += kMmaThreads) {
    const int r = idx / DT, c = idx % DT;
    const int rr = r0 + min(r, nr - 1), u = rr / group;
    const int h = j * group + rr % group;
    cp_async16(&sm.q[r][c * 8],
               static_cast<const bf16*>(p.q) + b * p.q_sb + u * p.q_su +
                   h * p.q_sh + c * 8,
               r < nr);
  }
  cp_async_commit();

  const int u_lo = r0 / group;
  const int nu = (r0 + nr - 1) / group - u_lo + 1;  // span positions, <= 64
  const int n_tiles = (p.L + kMmaKeys - 1) / kMmaKeys;
  const int t_begin = split * p.tiles_per_split;
  const int n_split = min(n_tiles, t_begin + p.tiles_per_split) - t_begin;

  // The dead-tile test, which is also the math's only mask read: every
  // (tile, span position) row of the split's mask, 64 bytes, becomes one
  // word in shared memory, the loads of a batch all in flight at once; a
  // tile whose words are all zero is neither copied nor computed. Live
  // bits gather in registers and meet in one shared word.
  if (tid == 0) sm.live = 0u;
  __syncthreads();
  const bool vec = p.L % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(p.mask) % 16 == 0;
  const int n_rows = n_split * nu;
  auto mask_row = [&](int idx) {  // 64 mask bytes of (tile, span position)
    return p.mask +
           (static_cast<size_t>(b) * p.U + u_lo + idx % nu) * p.L +
           (t_begin + idx / nu) * kMmaKeys;
  };
  unsigned live_bits = 0u;
  if (vec) {
    // One 16-byte piece per thread, four threads to a row, so that a warp
    // reads eight whole rows; each piece's 16 bits go straight into its
    // quarter of the row's word.
    constexpr int kBatch = 4;
    uint16_t* words = reinterpret_cast<uint16_t*>(sm.mask);
    for (int base = tid; base < 4 * n_rows; base += kBatch * kMmaThreads) {
      uint4 raw[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int piece = base + k * kMmaThreads, idx = piece / 4;
        const int key = (t_begin + idx / nu) * kMmaKeys + 16 * (piece % 4);
        raw[k] = piece < 4 * n_rows && key < p.L
                     ? __ldg(reinterpret_cast<const uint4*>(
                           mask_row(idx) + 16 * (piece % 4)))
                     : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int piece = base + k * kMmaThreads, idx = piece / 4;
        if (piece >= 4 * n_rows) break;
        const uint32_t bits = nonzero_bits16(raw[k]);
        // Little-endian: quarter q of the 64-bit word holds keys 16q...
        words[((idx / nu) * kMmaRows + idx % nu) * 4 + piece % 4] =
            static_cast<uint16_t>(bits);
        if (bits) live_bits |= 1u << (idx / nu);
      }
    }
  } else {
    for (int idx = tid; idx < n_rows; idx += kMmaThreads) {
      const int k0 = (t_begin + idx / nu) * kMmaKeys;
      const uint8_t* src = mask_row(idx);
      unsigned long long w = 0ull;
      for (int e = 0; e < kMmaKeys; ++e)
        if (k0 + e < p.L && src[e]) w |= 1ull << e;
      sm.mask[idx / nu][idx % nu] = w;
      if (w) live_bits |= 1u << (idx / nu);
    }
  }
  live_bits = __reduce_or_sync(0xffffffffu, live_bits);
  if (lane == 0 && live_bits) atomicOr(&sm.live, live_bits);
  // Paged: the table entries of the split's pages (at most 1024, for
  // 1-key pages), so that no copy waits on a table load.
  const int first_page = t_begin * kMmaKeys / max(p.page, 1);
  if constexpr (PAGED) {
    const int last_page =
        (min((t_begin + n_split) * kMmaKeys, p.L) - 1) / p.page;
    for (int i = tid; i <= last_page - first_page; i += kMmaThreads)
      sm.page_of[i] = __ldg(p.table + static_cast<size_t>(b) * p.NP +
                            first_page + i);
  }
  __syncthreads();
  const unsigned live_tiles = sm.live;
  // The first live tile of the split at or after t (relative), or n_split.
  auto next_live = [&](int t) -> int {
    const unsigned rest = live_tiles >> t;
    return rest ? t + __ffs(rest) - 1 : n_split;
  };

  // kv_row() with the page id from shared memory (and shifts for the
  // usual power-of-two page).
  const bool pow2 = (p.page & (p.page - 1)) == 0;
  const int page_shift = pow2 ? __ffs(p.page) - 1 : 0;
  auto mma_row = [&](int key) -> size_t {
    if constexpr (PAGED) {
      const int pg = pow2 ? key >> page_shift : key / p.page;
      const int slot = pow2 ? key & (p.page - 1) : key % p.page;
      return pool_row(p, sm.page_of[pg - first_page], slot, j);
    } else {
      return kv_row<false>(p, b, key, j);
    }
  };

  // Tile t's K/V rows (payload and scales for int8) -> stage st, as
  // cp.async copies; keys at or past L are zero-filled.
  auto issue = [&](int t, int st) {
    const int key0 = t * kMmaKeys;
    if constexpr (!QUANT) {
      const bf16* kp = static_cast<const bf16*>(p.k);
      const bf16* vp = static_cast<const bf16*>(p.v);
      for (int idx = tid; idx < kMmaKeys * DT; idx += kMmaThreads) {
        const int r = idx / DT, c = idx % DT;
        const int key = key0 + r;
        const bool ok = key < p.L;
        const size_t off = ok ? mma_row(key) * D : 0;
        cp_async16(&sm.k[st][r][c * 8], kp + off + c * 8, ok);
        cp_async16(&sm.v[st][r][c * 8], vp + off + c * 8, ok);
      }
    } else {
      const int8_t* kp = static_cast<const int8_t*>(p.k);
      const int8_t* vp = static_cast<const int8_t*>(p.v);
      Int8Stage<D>& s8 = sm.i8[st];
      for (int idx = tid; idx < kMmaKeys * KS; idx += kMmaThreads) {
        const int r = idx / KS, c = idx % KS;
        const int key = key0 + r;
        const bool ok = key < p.L;
        const size_t row = ok ? mma_row(key) : 0;
        cp_async16(&s8.k[r][c * 16], kp + row * D + c * 16, ok);
        cp_async16(&s8.v[r][c * 16], vp + row * D + c * 16, ok);
        if (c == 0) {
          cp_async4(&s8.ks[r], p.ks + row, ok);
          cp_async4(&s8.vs[r], p.vs + row, ok);
        }
      }
    }
  };

  // int8 stage st -> the bf16 tile: bf16(q) * bf16(scale), rounded once.
  auto dequant = [&](int st) {
    if constexpr (QUANT) {
      const Int8Stage<D>& s8 = sm.i8[st];
      for (int idx = tid; idx < 2 * kMmaKeys * KS; idx += kMmaThreads) {
        const int which = idx / (kMmaKeys * KS);
        const int rem = idx % (kMmaKeys * KS);
        const int r = rem / KS, c = rem % KS;
        const uint4 raw = *reinterpret_cast<const uint4*>(
            which ? &s8.v[r][c * 16] : &s8.k[r][c * 16]);
        const __nv_bfloat162 sc = __bfloat162bfloat162(
            __float2bfloat16(which ? s8.vs[r] : s8.ks[r]));
        const uint32_t in[4] = {raw.x, raw.y, raw.z, raw.w};
        uint32_t out[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          // Integers of 8 bits are exact in bf16; one rounding, in the
          // product, per element.
          __nv_bfloat162 pair = __hmul2(
              __floats2bfloat162_rn(s8_to_float(in[e / 2], 2 * (e % 2)),
                                    s8_to_float(in[e / 2], 2 * (e % 2) + 1)),
              sc);
          out[e] = *reinterpret_cast<uint32_t*>(&pair);
        }
        uint4* dst = reinterpret_cast<uint4*>(which ? &sm.v[0][r][c * 16]
                                                    : &sm.k[0][r][c * 16]);
        dst[0] = make_uint4(out[0], out[1], out[2], out[3]);
        dst[1] = make_uint4(out[4], out[5], out[6], out[7]);
      }
    }
  };

  // The ring: the first kStages - 1 live tiles in flight, one commit
  // group each (empty past the last live tile).
  int fetch = next_live(0);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (fetch < n_split) {
      issue(t_begin + fetch, s);
      fetch = next_live(fetch + 1);
    }
    cp_async_commit();
  }
  cp_async_wait<kStages - 1>();  // Q has landed
  __syncthreads();

  // This warp's Q rows as A fragments, d in 16-wide steps.
  uint32_t qa[KS][4];
  {
    const int r = wr * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      ldsm_x4(qa[kk], &sm.q[r][kk * 16 + (lane / 16) * 8]);
  }
  // This thread's two rows (g, g + 8 of the warp's 16): their span
  // position's mask word index, -1 past the last row.
  int mword[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = wr * 16 + g + 8 * e;
    mword[e] = r < nr ? (r0 + r) / group - u_lo : -1;
  }
  const bool warp_rows = wr * 16 < nr;

  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[dt][c] = 0.f;
  float m_r[2] = {kNeg, kNeg}, l_r[2] = {0.f, 0.f};
  const float scale2 = p.scale * 1.4426950408889634f;  // log2(e)

  int st = 0;
  for (int cur = next_live(0); cur < n_split; cur = next_live(cur + 1)) {
    cp_async_wait<kStages - 2>();  // tile cur has landed
    // Every warp is past tile cur - 1, whose stage the next copy reuses.
    __syncthreads();
    if (fetch < n_split) {
      issue(t_begin + fetch, (st + kStages - 1) % kStages);
      fetch = next_live(fetch + 1);
    }
    cp_async_commit();
    int kst = st;
    if constexpr (QUANT) {
      dequant(st);
      __syncthreads();
      kst = 0;
    }
    // This warp's mask bits: bit 8 * nt + c of half[e] is key
    // 32 * kh + 8 * nt + 2 * t4 + c of row e.
    uint32_t half[2];
#pragma unroll
    for (int e = 0; e < 2; ++e)
      half[e] = mword[e] < 0 ? 0u
                             : static_cast<uint32_t>(sm.mask[cur][mword[e]] >>
                                                     (32 * kh + 2 * t4));
    if (warp_rows && __any_sync(0xffffffffu, (half[0] | half[1]) != 0u)) {
      // S = Q K^T over the warp's 32 keys: key tiles 2np, 2np + 1 per
      // ldmatrix.x4 of K.
      float s[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[nt][c] = 0.f;
#pragma unroll
      for (int np = 0; np < 2; ++np) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          uint32_t kb[4];
          ldsm_x4(kb, &sm.k[kst][32 * kh + np * 16 + (lane % 8) +
                                 (lane / 16) * 8]
                           [kk * 16 + ((lane / 8) % 2) * 8]);
          mma_bf16(s[2 * np], qa[kk], kb[0], kb[1]);
          mma_bf16(s[2 * np + 1], qa[kk], kb[2], kb[3]);
        }
      }
      // Scale, mask, online softmax in base 2 (scores times scale *
      // log2(e); m in those units until the write-out); rows g (e = 0)
      // and g + 8 (e = 1). A masked score is NEG, as (q . k) * scale +
      // NEG rounds to in f32, and its p is 0.
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float mx = kNeg;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const bool keep = half[e] & (1u << (8 * nt + c));
            const float sv = keep ? s[nt][2 * e + c] * scale2 : kNeg;
            s[nt][2 * e + c] = sv;
            mx = fmaxf(mx, sv);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_r[e], mx);
        const float alpha = ex2(m_r[e] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const bool keep = half[e] & (1u << (8 * nt + c));
            const float pe = keep ? ex2(s[nt][2 * e + c] - m_new) : 0.f;
            s[nt][2 * e + c] = pe;
            sum += pe;
          }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l_r[e] = l_r[e] * alpha + sum;
        m_r[e] = m_new;
#pragma unroll
        for (int dt = 0; dt < DT; ++dt) {
          o[dt][2 * e] *= alpha;
          o[dt][2 * e + 1] *= alpha;
        }
      }
      // O += P V: P (bf16) straight from the score registers; V tiles
      // 2dp, 2dp + 1 per ldmatrix.x4.trans.
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint32_t pa[4] = {
            pack_bf16(s[2 * kk][0], s[2 * kk][1]),
            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]),
        };
#pragma unroll
        for (int dp = 0; dp < KS; ++dp) {
          uint32_t vb[4];
          ldsm_x4_trans(vb, &sm.v[kst][32 * kh + kk * 16 + (lane % 8) +
                                       ((lane / 8) % 2) * 8]
                                      [dp * 16 + (lane / 16) * 8]);
          mma_bf16(o[2 * dp], pa, vb[0], vb[1]);
          mma_bf16(o[2 * dp + 1], pa, vb[2], vb[3]);
        }
      }
    }
    st = (st + 1) % kStages;
  }

  // The two key halves of each row meet: the second half's warps hand
  // (o, m, l) over through the now idle ring, the first half's combine.
  cp_async_wait<0>();
  __syncthreads();
  float4* xch = reinterpret_cast<float4*>(sm.k) + (wr * 32 + lane) * (DT + 1);
  if (kh == 1) {
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      xch[dt] = make_float4(o[dt][0], o[dt][1], o[dt][2], o[dt][3]);
    xch[DT] = make_float4(m_r[0], m_r[1], l_r[0], l_r[1]);
  }
  __syncthreads();
  if (kh == 0) {
    const float4 ml = xch[DT];
    const float m_o[2] = {ml.x, ml.y}, l_o[2] = {ml.z, ml.w};
    float a_me[2], a_o[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float m_new = fmaxf(m_r[e], m_o[e]);
      a_me[e] = ex2(m_r[e] - m_new);
      a_o[e] = ex2(m_o[e] - m_new);
      l_r[e] = l_r[e] * a_me[e] + l_o[e] * a_o[e];
      m_r[e] = m_new;
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const float4 x = xch[dt];
      o[dt][0] = o[dt][0] * a_me[0] + x.x * a_o[0];
      o[dt][1] = o[dt][1] * a_me[0] + x.y * a_o[0];
      o[dt][2] = o[dt][2] * a_me[1] + x.z * a_o[1];
      o[dt][3] = o[dt][3] * a_me[1] + x.w * a_o[1];
    }
  }

  if (p.S == 1) {
    // One split: the merge is the identity (alpha = 1), so the block
    // writes acc / max(l, 1e-30) itself (times the reciprocal: within an
    // f32 ulp of the merge's quotient), staged in Q's idle shared rows
    // and stored as whole rows.
    if (kh == 0) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = wr * 16 + g + 8 * e;
        const float inv_l = 1.f / fmaxf(l_r[e], 1e-30f);
#pragma unroll
        for (int dt = 0; dt < DT; ++dt)
          *reinterpret_cast<__nv_bfloat162*>(&sm.q[r][dt * 8 + 2 * t4]) =
              __floats2bfloat162_rn(o[dt][2 * e] * inv_l,
                                    o[dt][2 * e + 1] * inv_l);
      }
    }
    __syncthreads();
    for (int idx = tid; idx < nr * DT; idx += kMmaThreads) {
      const int r = idx / DT, c = idx % DT;
      const int rr = r0 + r, u = rr / group, h = j * group + rr % group;
      *reinterpret_cast<uint4*>(
          static_cast<bf16*>(p.out) +
          ((static_cast<size_t>(b) * p.U + u) * p.H + h) * D + c * 8) =
          *reinterpret_cast<const uint4*>(&sm.q[r][c * 8]);
    }
    return;
  }
  if (kh == 1) return;
  const size_t part_rows = static_cast<size_t>(p.KVH) * rows;
  const size_t base = (static_cast<size_t>(b) * p.S + split) * part_rows +
                      static_cast<size_t>(j) * rows + r0;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = wr * 16 + g + 8 * e;
    if (r >= nr) continue;
    float* dst = p.acc + (base + r) * D;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<float2*>(dst + dt * 8 + 2 * t4) =
          make_float2(o[dt][2 * e], o[dt][2 * e + 1]);
    if (t4 == 0) {
      p.m[base + r] = m_r[e] * 0.6931471805599453f;  // natural-log units
      p.l[base + r] = l_r[e];
    }
  }
}

// Split-K merge (the JAX package's _splitk_merge_rows, then the
// [KVH, U, group] -> [B, U, H, d] relayout): one block per (row, b), one
// thread per output column (columns past 256 in a loop). alpha_s =
// exp(m_s - max m); rows whose l is 0 in every split (no valid key) come
// out exactly 0.
template <typename T>
__global__ void splitk_merge_kernel(Params p) {
  const int ri = blockIdx.x, b = blockIdx.y;
  const int D = p.d;
  const int group = p.H / p.KVH;
  const int rows = p.U * group;
  const int j = ri / rows, rr = ri % rows;
  const int u = rr / group, h = j * group + rr % group;
  const size_t part_rows = static_cast<size_t>(p.KVH) * rows;
  const size_t row0 = static_cast<size_t>(b) * p.S * part_rows + ri;
  float m_max = kNeg;
  for (int s = 0; s < p.S; ++s) m_max = fmaxf(m_max, p.m[row0 + s * part_rows]);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
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
}

template <typename T>
int launch_merge(const Params& p, cudaStream_t stream) {
  dim3 mgrid(p.KVH * p.U * (p.H / p.KVH), p.B);
  splitk_merge_kernel<T><<<mgrid, min(p.d, 256), 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Grant a kernel `bytes` of dynamic shared memory (once per size it grows
// to; the attribute call is checked).
template <typename K>
cudaError_t grant_smem(K kernel, int bytes, int* granted) {
  if (bytes <= *granted) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *granted = bytes;
  return err;
}

template <typename T, bool QUANT, bool PAGED, int D>
int launch_fma(const Params& p, cudaStream_t stream) {
  constexpr int smem = splitk_smem_bytes<D>();
  static int granted = 48 * 1024;
  auto kernel = splitk_attention_kernel<T, QUANT, PAGED, D>;
  cudaError_t err = grant_smem(kernel, smem, &granted);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(p.S * p.nd, p.KVH * p.row_chunks, p.B);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_merge<T>(p, stream);
}

template <bool QUANT, bool PAGED, int D>
int launch_mma(const Params& p, cudaStream_t stream) {
  if (p.d != D) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = static_cast<int>(sizeof(MmaSmem<QUANT, D>));
  static int granted = 48 * 1024;
  auto kernel = extend_mma_kernel<QUANT, PAGED, D>;
  cudaError_t err = grant_smem(kernel, smem, &granted);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(p.S, p.KVH * p.row_chunks, p.B);
  kernel<<<grid, kMmaThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.S == 1) return static_cast<int>(err);
  return launch_merge<__nv_bfloat16>(p, stream);
}

// One launch of the decode body: grid (S, KVH * row_chunks, B), clusters
// of the S splits of one (b, KV head, head chunk).
template <typename T, bool QUANT, bool PAGED, int D, int G>
int launch_decode_g(const Params& p, cudaStream_t stream) {
  using S = typename std::conditional<QUANT, int8_t, T>::type;
  using Lay = DecLayout<S, QUANT, D, dec_chunk_elems(std::is_same<S, float>::value, D)>;
  const int smem =
      dec_front<Lay, D, G>() + 4 * (dec_words(p.tiles_per_split, Lay::kTK) +
                        (PAGED ? dec_pages(p.tiles_per_split, Lay::kTK, p.page)
                               : 0));
  static int granted = 48 * 1024;
  auto kernel = decode_kernel<T, QUANT, PAGED, D, G>;
  cudaError_t err = grant_smem(kernel, smem, &granted);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.S, p.KVH * p.row_chunks, p.B);
  cfg.blockDim = dim3(kDecThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool QUANT, bool PAGED, int D>
int launch_decode(const Params& p, cudaStream_t stream) {
  switch (dec_heads(p.H / p.KVH)) {
    case 1: return launch_decode_g<T, QUANT, PAGED, D, 1>(p, stream);
    case 2: return launch_decode_g<T, QUANT, PAGED, D, 2>(p, stream);
    case 4: return launch_decode_g<T, QUANT, PAGED, D, 4>(p, stream);
    default: return launch_decode_g<T, QUANT, PAGED, D, 8>(p, stream);
  }
}

template <typename T, bool QUANT, bool PAGED, int D>
int launch_body(Body body, const Params& p, cudaStream_t s) {
  if (body == kBodyDecode) return launch_decode<T, QUANT, PAGED, D>(p, s);
  return launch_fma<T, QUANT, PAGED, D>(p, s);
}

}  // namespace

template <int D>
int launch_for_d(Body body, int dtype, bool quant, bool paged,
                 const Params& p, cudaStream_t s) {
  if (body == kBodyMma) {
    // The tensor-core body is compiled for D <= 128 only (takes_mma).
    if constexpr (D <= 128) {
      if (quant)
        return paged ? launch_mma<true, true, D>(p, s)
                     : launch_mma<true, false, D>(p, s);
      return paged ? launch_mma<false, true, D>(p, s)
                   : launch_mma<false, false, D>(p, s);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (dtype == 0) {
    if (quant)
      return paged ? launch_body<float, true, true, D>(body, p, s)
                   : launch_body<float, true, false, D>(body, p, s);
    return paged ? launch_body<float, false, true, D>(body, p, s)
                 : launch_body<float, false, false, D>(body, p, s);
  }
  if (quant)
    return paged ? launch_body<__nv_bfloat16, true, true, D>(body, p, s)
                 : launch_body<__nv_bfloat16, true, false, D>(body, p, s);
  return paged ? launch_body<__nv_bfloat16, false, true, D>(body, p, s)
               : launch_body<__nv_bfloat16, false, false, D>(body, p, s);
}

#if MLAPI_UNIT > 0
template int launch_for_d<MLAPI_UNIT>(Body, int, bool, bool, const Params&,
                                      cudaStream_t);
#endif

}  // namespace mlapi_decode
#endif  // MLAPI_UNIT != 0

#if MLAPI_UNIT <= 0
namespace mlapi_decode {
namespace {

// The tensor-core body takes an extend entry point with bf16 queries, more
// than one span position and a compiled head dim (mirrored by the
// wrapper's _geometry()).
bool takes_mma(bool extend, int dtype, int U, int D) {
  return extend && dtype == 1 && U > 1 && compiled_d(D) == D && D <= 128;
}

// A decode call at d <= 256 runs the decode body; an extend call the
// tensor-core body where it takes the call; every other call, and every
// call with d > 256, the CUDA-core split-K body.
Body body_of(bool extend, int dtype, int U, int D) {
  if (D > 256) return kBodyFma;
  if (!extend) return kBodyDecode;
  return takes_mma(extend, dtype, U, D) ? kBodyMma : kBodyFma;
}

// table == NULL: the contiguous layout, L keys per row. Otherwise the
// paged layout: L == NP * page virtual slots per row.
int launch(bool extend, const void* q, const void* k, const void* v,
           const void* ks, const void* vs, const void* table,
           const void* mask, void* partials, void* out, long long q_sb,
           long long q_su, long long q_sh, int dtype, int quant, int B,
           int U, int H, int KVH, int L, int NP, int page, int D, int S,
           int tiles_per_split, int row_chunks, float scale, void* stream) {
  if (B < 1 || U < 1 || KVH < 1 || H % KVH != 0 || L < 1 || D < 1 ||
      B > 65535 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Body body = body_of(extend, dtype, U, D);
  // The wrapper's geometry must cover every query row and every key tile
  // of the body that runs.
  const int group = H / KVH;
  const int rows = U * group;
  int chunk_rows = kRowChunk, tile = kTileKeys;
  if (body == kBodyMma) {
    chunk_rows = kMmaRows;
    tile = kMmaKeys;
  } else if (body == kBodyDecode) {
    chunk_rows = dec_heads(group);
    tile = dec_tile_keys(compiled_d(D), quant ? 1 : dtype == 0 ? 4 : 2);
  }
  const int n_tiles = (L + tile - 1) / tile;
  if (row_chunks != (rows + chunk_rows - 1) / chunk_rows || S < 1 ||
      tiles_per_split < 1 ||
      (body == kBodyMma && tiles_per_split > kMaxSplitTiles) ||
      (body == kBodyDecode &&
       (S > kMaxCluster || (S - 1) * tiles_per_split >= n_tiles)) ||
      static_cast<long long>(S) * tiles_per_split < n_tiles ||
      static_cast<long long>(KVH) * row_chunks > 65535 ||
      static_cast<long long>(S) * d_chunks(D) > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  const size_t n_rows = static_cast<size_t>(B) * S * KVH * rows;
  p.q = q;
  p.k = k;
  p.v = v;
  p.ks = static_cast<const float*>(ks);
  p.vs = static_cast<const float*>(vs);
  p.mask = static_cast<const uint8_t*>(mask);
  p.table = static_cast<const int*>(table);
  // One scratch buffer (splitk, multi-split mma): acc [n_rows, d], then m
  // [n_rows], then l. The decode body needs none.
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
  p.d = D;
  p.nd = d_chunks(D);
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool paged = table != nullptr;
  if (paged && (page < 1 || NP < 1 || L != NP * page))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (compiled_d(D)) {
    case 16: return launch_for_d<16>(body, dtype, quant, paged, p, s);
    case 32: return launch_for_d<32>(body, dtype, quant, paged, p, s);
    case 64: return launch_for_d<64>(body, dtype, quant, paged, p, s);
    case 128: return launch_for_d<128>(body, dtype, quant, paged, p, s);
    default: return launch_for_d<256>(body, dtype, quant, paged, p, s);
  }
}

}  // namespace
}  // namespace mlapi_decode

using mlapi_decode::launch;

// Every entry point: q (strides q_sb, q_su, q_sh in elements, last dim
// contiguous), k, v (payloads), ks, vs (int8 scales or NULL), mask (bool
// [B, U, L]), partials (f32 scratch of B*S*H*U*(D+2) floats; none for the
// decode body), out (the [B, U, H, D] result in q's dtype). dtype: 0 f32,
// 1 bf16. D: the head dim, any D >= 1. The paged entry points take k,
// v, ks, vs as pools [P, page, KVH, D | 1], the int32 page table [B, NP]
// and L = NP * page virtual slots.
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
  return launch(false, q, k, v, ks, vs, nullptr, mask, partials, out, q_sb,
                q_su, q_sh, dtype, quant, B, 1, H, KVH, L, 0, 0, D, S,
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
  return launch(true, q, k, v, ks, vs, nullptr, mask, partials, out, q_sb,
                q_su, q_sh, dtype, quant, B, U, H, KVH, L, 0, 0, D, S,
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
  return launch(false, q, k, v, ks, vs, table, mask, partials, out, q_sb,
                q_su, q_sh, dtype, quant, B, 1, H, KVH, NP * page, NP, page,
                D, S, tiles_per_split, row_chunks, scale, stream);
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
  return launch(true, q, k, v, ks, vs, table, mask, partials, out, q_sb,
                q_su, q_sh, dtype, quant, B, U, H, KVH, NP * page, NP, page,
                D, S, tiles_per_split, row_chunks, scale, stream);
}

}  // extern "C"
#endif  // MLAPI_UNIT <= 0
