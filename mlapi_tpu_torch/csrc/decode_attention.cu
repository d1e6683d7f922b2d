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
//
// What every entry point computes: for batch row b, KV head j and a range
// of cache keys (one split), the partial triple (acc, m, l) of softmax
// attention for every query row the head serves -- rows laid out
// [KVH, U, group]-flat, row r of head j being span position u = r / group
// and query head j * group + r % group, so a GQA group and a U-row span
// share every K/V tile they read. acc is the un-normalised f32 output, m
// the running max and l the normaliser. A second small kernel merges the
// splits with the log-sum-exp algebra of the JAX package's
// _splitk_merge_rows and writes [B, U, H, D] in q's dtype, so one call
// from Python costs one C call and two launches. Key `key` of batch row b
// lives in row b of a contiguous [B, L, KVH, D] cache, or -- PAGED -- in
// slot key % page of pool page table[b, key / page] of a [P, page, KVH, D]
// pool (the Pallas kernels' scalar-prefetched BlockSpec index map, done
// per key row here), so a tile may straddle pages of any size.
//
// Two bodies, chosen by dtype and entry point (a dispatch, not a
// fallback: each call runs exactly one of them, and the wrapper's
// _geometry() mirrors the choice):
//
//   extend_mma_kernel      the extend entry points (B2, B4) with bf16
//                          queries and U > 1, over a bf16 or an int8
//                          cache: the formats serving runs;
//   splitk_attention_kernel every decode call (B1, B3), and f32 queries
//                          on any entry point (tensor cores would need
//                          TF32, which breaks the port's 1e-5 bound in
//                          f32; f32 is the card's correctness witness).
//
// What bounds them on the card: the cache read. A decode step does about
// one FLOP per byte of K/V (4*H*D FLOPs per key against 2*KVH*D stored
// elements), far below the ~295 FLOP/byte at which an H100 stops being
// memory-bound, so time is bytes / 3.35 TB/s at best. An extend span of
// U = 128 rows does 128x the FLOPs per byte -- still under the line on
// the tensor cores (2.6 GFLOP against 25 MB at B = 8, L = 1024: 0.0065 ms
// at 400 TFLOP/s of mma.sync, under the 0.0075 ms byte bound), but some
// 50x over it on CUDA-core f32 FMAs. So decode keeps the FMA body and the
// extend body moves its two products onto the tensor cores.
//
// splitk_attention_kernel (decode, f32): one block of 4 warps owns 32
// query rows of one KV head and a split of 32-key tiles; one warp walks
// one query row at a time, a key per lane, with f32 FMAs from shared
// memory. The split count puts several blocks on each of the 132 SMs
// even at B = 8.
//
// extend_mma_kernel (B2/B4 in bf16 and int8): one block of 8 warps owns
// 64 query rows of one KV head and a split of at most 16 64-key tiles.
// Warp w takes rows 16 * (w % 4).. and key half w / 4 of every tile: two
// warps share a row, each with its own online softmax, and the halves
// combine once, through shared memory, at the end (twice the warps of
// one-warp-per-row at the same registers, 119-128 a thread, no spills).
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
//     into pieces one TMA box cannot address. The next tiles' copies are
//     in flight while a tile computes.
//   * int8: payload and f32 scales are copied the same way, then
//     dequantised into a bf16 shared tile with the JAX arithmetic,
//     bf16(q) * bf16(scale) rounded once (Ops<bf16>::dequant); from there
//     int8 takes the bf16 path.
//   * S = Q K^T and O += P V are mma.sync.m16n8k16 bf16 -> f32 (K by
//     ldmatrix, V by ldmatrix.trans); shared rows are padded to 144 bytes
//     so that the eight rows ldmatrix reads fall in distinct banks.
//     Softmax is online in FlashAttention-2's register layout, in base 2:
//     a row's max and sum reduce over the 4 lanes of a quad, and p,
//     rounded to bf16, is the A operand of P V without a trip through
//     shared memory. A warp whose 16 rows attend no key of a tile skips
//     its math (exact: the skipped update is the identity).
//   * With one split (the wrapper picks one whenever the row blocks alone
//     fill the card) the block normalises and writes the output itself,
//     and the merge kernel is not launched; otherwise it writes the
//     (acc, m, l) partials the merge kernel reads.
//
// A paged call is bound by the same bytes (plus an int32 [B, NP] table,
// noise beside them) and runs the same body with PAGED set, which changes
// only kv_row(): with the same virtual length, a paged call and a
// contiguous call over the same bytes do the same arithmetic in the same
// order and give bit-identical outputs. Page ids are trusted (as in
// Pallas): the plain PyTorch version is where an out-of-range id raises.
//
// Numerics follow the Pallas kernels: f32 accumulation, scores =
// (q . k) * scale plus (1 - keep) * NEG with the finite NEG = -1e30,
// p = exp(s - m) * keep (so a row with no valid key gives exact zeros),
// and p rounded to the value dtype before the PV product. Rounding
// differs from the plain version, which follows the Pallas tiling, in
// these places: the softmax inside a split runs online over its tiles
// instead of once per tile; and in the mma body the tensor cores sum a
// tile's products in their own order, the two key halves of a row merge
// once more, exp is the special-function unit's ex2 of a base-2 score,
// and a one-split output is acc times 1 / l. All stay within 2e-2 in
// bf16 on live rows.
//
// C interface (for ctypes): every pointer is a device pointer, the
// stream is a cudaStream_t, and the return value is the first CUDA error
// of the attribute call and the launches (0 on success), or
// cudaErrorInvalidValue for a geometry the body does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// Row (in units of D elements) of key `key`, head j, in pool page pid.
__device__ __forceinline__ size_t pool_row(const Params& p, int pid, int slot,
                                           int j) {
  return (static_cast<size_t>(pid) * p.page + slot) * p.KVH + j;
}

// Row (in units of D elements) of key `key`, head j, batch row b: the
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

// -- extend_mma_kernel: B2/B4 on the tensor cores ----------------------

constexpr int kMmaRows = 64;           // query rows per block, 16 per row group
constexpr int kMmaKeys = 64;           // keys per tile
constexpr int kMmaD = 64;              // the one head dim compiled
constexpr int kPadRow = kMmaD + 8;     // bf16 per shared row: 144 bytes
constexpr int kMaxSplitTiles = 16;     // tiles of one split (mask words held)
constexpr int kMmaThreads = 256;       // 8 warps: 4 row groups x 2 key halves

// One stage of an int8 tile as it lands: payload rows and per-key scales.
struct alignas(16) Int8Stage {
  int8_t k[kMmaKeys][kMmaD];
  int8_t v[kMmaKeys][kMmaD];
  float ks[kMmaKeys];
  float vs[kMmaKeys];
};

struct NoStage {
  uint4 unused;
};

// Dynamic shared memory of one block. bf16: Q, a three-stage K/V ring,
// the split's mask words, live tiles and page ids. int8: a four-stage
// ring of int8 tiles, and one bf16 K/V tile that takes the dequantised
// current tile. About 75 KB either way: two blocks fit on an SM, as many
// as their registers allow.
template <bool QUANT>
struct MmaSmem {
  static constexpr int kStages = QUANT ? 4 : 3;
  static constexpr int kBf16Stages = QUANT ? 1 : kStages;
  __nv_bfloat16 q[kMmaRows][kPadRow];
  __nv_bfloat16 k[kBf16Stages][kMmaKeys][kPadRow];
  __nv_bfloat16 v[kBf16Stages][kMmaKeys][kPadRow];
  // [tile of the split][span position - u_lo]: bit k = attend key k.
  unsigned long long mask[kMaxSplitTiles][kMmaRows];
  unsigned live;  // bit t: some row of the block attends tile t
  int page_of[kMaxSplitTiles * kMmaKeys];  // paged: the split's page ids
  typename std::conditional<QUANT, Int8Stage, NoStage>::type i8[kStages];
};
// The end-of-loop exchange of (o, m, l) between key halves reuses k and v.
static_assert(sizeof(MmaSmem<true>::k) + sizeof(MmaSmem<true>::v) >=
                  4 * 32 * 9 * sizeof(float4),
              "exchange does not fit");

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 bytes global -> shared, asynchronous; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(ptr)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(ptr)));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit; 0 for large negative x.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Signed byte e of `word` as a float, exactly, without an I2F: the
// biased byte e + 128 becomes the mantissa of 2^23 + (e + 128).
__device__ __forceinline__ float s8_to_float(uint32_t word, int e) {
  const uint32_t bits =
      __byte_perm(word ^ 0x80808080u, 0x4B000000u, 0x7440u | e);
  return __uint_as_float(bits) - 8388736.0f;  // 2^23 + 128
}

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Fragment layout of mma.m16n8k16 (lane = 4 * g + t): a C tile holds
// c[0..1] at row g, columns 2t, 2t+1 and c[2..3] at row g + 8; an A tile
// holds rows g / g + 8 at columns 2t.. and 2t + 8... So the scores of
// key tiles 2k and 2k + 1, rounded to bf16, are exactly the A fragment of
// P for keys 16k..16k + 15.
//
// Warp w owns rows 16 * (w % 4).. of the block and key half w / 4 (keys
// 32 * (w / 4).. of every tile): two warps share each row, each with its
// own online softmax, and the halves combine once, at the end.
template <bool QUANT, bool PAGED>
__global__ void __launch_bounds__(kMmaThreads)
    extend_mma_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  MmaSmem<QUANT>& sm = *reinterpret_cast<MmaSmem<QUANT>*>(smem_raw);
  using bf16 = __nv_bfloat16;
  constexpr int kStages = MmaSmem<QUANT>::kStages;

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
  for (int idx = tid; idx < kMmaRows * (kMmaD / 8); idx += kMmaThreads) {
    const int r = idx / (kMmaD / 8), c = idx % (kMmaD / 8);
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
    // quarter of the row's word. A batch's loads are in flight before any
    // of its bits is stored (a deeper batch costs registers and gains
    // nothing: all blocks of a batch row read the same mask lines).
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
      for (int idx = tid; idx < kMmaKeys * (kMmaD / 8); idx += kMmaThreads) {
        const int r = idx / (kMmaD / 8), c = idx % (kMmaD / 8);
        const int key = key0 + r;
        const bool ok = key < p.L;
        const size_t off = ok ? mma_row(key) * kMmaD : 0;
        cp_async16(&sm.k[st][r][c * 8], kp + off + c * 8, ok);
        cp_async16(&sm.v[st][r][c * 8], vp + off + c * 8, ok);
      }
    } else {
      const int8_t* kp = static_cast<const int8_t*>(p.k);
      const int8_t* vp = static_cast<const int8_t*>(p.v);
      Int8Stage& s8 = sm.i8[st];
      for (int idx = tid; idx < kMmaKeys * (kMmaD / 16);
           idx += kMmaThreads) {
        const int r = idx / (kMmaD / 16), c = idx % (kMmaD / 16);
        const int key = key0 + r;
        const bool ok = key < p.L;
        const size_t row = ok ? mma_row(key) : 0;
        cp_async16(&s8.k[r][c * 16], kp + row * kMmaD + c * 16, ok);
        cp_async16(&s8.v[r][c * 16], vp + row * kMmaD + c * 16, ok);
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
      const Int8Stage& s8 = sm.i8[st];
      for (int idx = tid; idx < 2 * kMmaKeys * (kMmaD / 16);
           idx += kMmaThreads) {
        const int which = idx / (kMmaKeys * (kMmaD / 16));
        const int rem = idx % (kMmaKeys * (kMmaD / 16));
        const int r = rem / (kMmaD / 16), c = rem % (kMmaD / 16);
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

  // This warp's Q rows as A fragments, d in four 16-wide steps.
  uint32_t qa[4][4];
  {
    const int r = wr * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
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

  float o[8][4];
#pragma unroll
  for (int dt = 0; dt < 8; ++dt)
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
        for (int kk = 0; kk < 4; ++kk) {
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
        for (int dt = 0; dt < 8; ++dt) {
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
        for (int dp = 0; dp < 4; ++dp) {
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
  float4* xch = reinterpret_cast<float4*>(sm.k) + (wr * 32 + lane) * 9;
  if (kh == 1) {
#pragma unroll
    for (int dt = 0; dt < 8; ++dt)
      xch[dt] = make_float4(o[dt][0], o[dt][1], o[dt][2], o[dt][3]);
    xch[8] = make_float4(m_r[0], m_r[1], l_r[0], l_r[1]);
  }
  __syncthreads();
  if (kh == 0) {
    const float4 ml = xch[8];
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
    for (int dt = 0; dt < 8; ++dt) {
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
    // and stored as whole 128-byte rows.
    if (kh == 0) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = wr * 16 + g + 8 * e;
        const float inv_l = 1.f / fmaxf(l_r[e], 1e-30f);
#pragma unroll
        for (int dt = 0; dt < 8; ++dt)
          *reinterpret_cast<__nv_bfloat162*>(&sm.q[r][dt * 8 + 2 * t4]) =
              __floats2bfloat162_rn(o[dt][2 * e] * inv_l,
                                    o[dt][2 * e + 1] * inv_l);
      }
    }
    __syncthreads();
    for (int idx = tid; idx < nr * (kMmaD / 8); idx += kMmaThreads) {
      const int r = idx / (kMmaD / 8), c = idx % (kMmaD / 8);
      const int rr = r0 + r, u = rr / group, h = j * group + rr % group;
      *reinterpret_cast<uint4*>(
          static_cast<bf16*>(p.out) +
          ((static_cast<size_t>(b) * p.U + u) * p.H + h) * kMmaD + c * 8) =
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
    float* dst = p.acc + (base + r) * kMmaD;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt)
      *reinterpret_cast<float2*>(dst + dt * 8 + 2 * t4) =
          make_float2(o[dt][2 * e], o[dt][2 * e + 1]);
    if (t4 == 0) {
      p.m[base + r] = m_r[e] * 0.6931471805599453f;  // natural-log units
      p.l[base + r] = l_r[e];
    }
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

template <typename T>
int launch_merge(const Params& p, int D, cudaStream_t stream) {
  dim3 mgrid(p.KVH * p.U * (p.H / p.KVH), p.B);
  splitk_merge_kernel<T><<<mgrid, D, 0, stream>>>(p, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool QUANT, bool PAGED>
int launch_fma(const Params& p, int D, cudaStream_t stream) {
  dim3 grid(p.S, p.KVH * p.row_chunks, p.B);
  // The one head dim a served model has (GPT-2 small: 64).
  if (D != 64) return static_cast<int>(cudaErrorInvalidValue);
  splitk_attention_kernel<T, QUANT, PAGED, 64>
      <<<grid, kThreads, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_merge<T>(p, D, stream);
}

template <bool QUANT, bool PAGED>
int launch_mma(const Params& p, int D, cudaStream_t stream) {
  if (D != kMmaD) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(sizeof(MmaSmem<QUANT>));
  cudaError_t err = cudaFuncSetAttribute(
      extend_mma_kernel<QUANT, PAGED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(p.S, p.KVH * p.row_chunks, p.B);
  extend_mma_kernel<QUANT, PAGED><<<grid, kMmaThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.S == 1) return static_cast<int>(err);
  return launch_merge<__nv_bfloat16>(p, D, stream);
}

// The body a call runs (mirrored by the wrapper's _geometry()): the
// tensor-core body for an extend entry point with bf16 queries and more
// than one span position, the FMA body otherwise.
bool takes_mma(bool extend, int dtype, int U) {
  return extend && dtype == 1 && U > 1;
}

// table == NULL: the contiguous layout, L keys per row. Otherwise the
// paged layout: L == NP * page virtual slots per row.
int launch(bool extend, const void* q, const void* k, const void* v,
           const void* ks, const void* vs, const void* table,
           const void* mask, void* partials, void* out, long long q_sb,
           long long q_su, long long q_sh, int dtype, int quant, int B,
           int U, int H, int KVH, int L, int NP, int page, int D, int S,
           int tiles_per_split, int row_chunks, float scale, void* stream) {
  const bool mma = takes_mma(extend, dtype, U);
  if (B < 1 || U < 1 || KVH < 1 || H % KVH != 0 || L < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  // The wrapper's geometry must cover every query row and every key tile
  // of the body that runs.
  const int rows = U * (H / KVH);
  const int chunk_rows = mma ? kMmaRows : kRowChunk;
  const int tile = mma ? kMmaKeys : kTileKeys;
  const int n_tiles = (L + tile - 1) / tile;
  if (row_chunks != (rows + chunk_rows - 1) / chunk_rows || S < 1 ||
      tiles_per_split < 1 || (mma && tiles_per_split > kMaxSplitTiles) ||
      static_cast<long long>(S) * tiles_per_split < n_tiles)
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
  if (mma) {
    if (quant)
      return paged ? launch_mma<true, true>(p, D, s)
                   : launch_mma<true, false>(p, D, s);
    return paged ? launch_mma<false, true>(p, D, s)
                 : launch_mma<false, false>(p, D, s);
  }
  if (dtype == 0) {
    if (quant)
      return paged ? launch_fma<float, true, true>(p, D, s)
                   : launch_fma<float, true, false>(p, D, s);
    return paged ? launch_fma<float, false, true>(p, D, s)
                 : launch_fma<float, false, false>(p, D, s);
  }
  if (dtype == 1) {
    if (quant)
      return paged ? launch_fma<__nv_bfloat16, true, true>(p, D, s)
                   : launch_fma<__nv_bfloat16, true, false>(p, D, s);
    return paged ? launch_fma<__nv_bfloat16, false, true>(p, D, s)
                 : launch_fma<__nv_bfloat16, false, false>(p, D, s);
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
