// Flash attention for training: the forward (B5) and both backward
// kernels (B6: dq, B7: dk/dv), for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of mlapi_tpu/ops/pallas/flash_attention.py:
//   mlapi_flash_forward       <- _fwd_kernel (via _fwd, B5, :130)
//   mlapi_flash_backward_dq   <- _bwd_dq_kernel (via _bwd, B6, :357)
//   mlapi_flash_backward_dkv  <- _bwd_dkv_kernel (via _bwd, B7, :423)
//
// What they compute, with the Pallas kernels' conventions: q [B, Lq, H, D],
// k/v [B, Lk, KVH, D] (query head h reads KV head h / (H / KVH): grouped-
// query attention with no repeated K/V), a binary key mask [B, Lk], and
// optionally causal masking with a sliding window (keep q_pos - k_pos <
// window). Scores are s = (q . k) * scale + (1 - keep) * NEG with the
// finite NEG = -1e30.
//   B5: online softmax over key tiles: out = softmax(s) . v in q's dtype,
//       and the per-row log-sum-exp lse = m + log(max(l, 1e-30)), f32
//       [B, H, Lq], in natural log. A row with no valid key gives out = 0
//       and lse = NEG.
//   B6: dq = sum over key tiles of ds . k, where p = exp(s - lse) * keep
//       is recomputed from the saved lse, dp = dO . v^T and
//       ds = p * (dp - delta) * scale; delta = rowsum(dO * O) minus any
//       lse cotangent comes from the caller (one torch op, as in JAX).
//   B7: per KV head and key tile, dv = sum p^T . dO and dk = sum ds^T . q
//       over every query head of the group and every query tile that can
//       see the keys: the whole group accumulates in registers of one
//       block, in a fixed order, so the sums are deterministic (no
//       atomics).
// The multiply-by-keep zeroes masked lanes, so a row with no valid key
// (lse ~ NEG) gives exact zeros in every gradient, never exp(NEG - NEG).
// Rounding follows the Pallas kernels: products of the stored dtype with
// f32 accumulation; p rounded to v's dtype before P.V (B5) and to dO's
// before P^T.dO (B7); ds rounded to k's dtype before ds.K (B6) and to q's
// before ds^T.Q (B7); softmax, lse and delta in f32.
//
// What bounds them on the card: at BERT-base training shapes (L = 128,
// D = 64) each call moves q, k, v, o (+ dO and the gradients) once and
// does 4 * D FLOPs per (query, key) pair per product pair -- about 64
// FLOPs per byte, below the ~295 FLOP/byte at which an H100's bf16
// tensor cores stop being memory-bound, so the bound is bytes at 3.35
// TB/s. At L = 1024 (GPT-2 causal) and at D = 128 the FLOPs dominate. On
// the CUDA cores (67 TFLOP/s in f32, 1/15 of the bf16 tensor cores) every
// one of these shapes is operations-bound; so bf16 runs on the tensor
// cores.
//
// Two bodies per kernel, chosen by dtype and head dim (a dispatch, not a
// fallback: each call runs exactly one, flash_body() below decides and
// reports it to the caller, and the wrapper's _body() mirrors it for the
// CPU tests):
//
//   mma  all three in bf16 at D in {16, 32, 64, 128}: mma.sync.m16n8k16
//        bf16 -> f32 (tile_primitives.cuh), flash-attention-2 shaped;
//   fma  f32 (kept exact f32: tensor cores would need TF32, three
//        decimal digits) and D >= 256: CUDA-core f32 FMAs over f32 tiles
//        in shared memory (in bf16 built at D = 256 only).
//
// flash_fwd_mma_kernel (B5): one block of 4 warps per (64 query rows,
// head, batch row); warp w owns rows 16w.. and walks every live 64-key
// tile.
//   * Q is read once through its strides (a view of the fused QKV
//     projection works) and held as A fragments (ldmatrix) for the whole
//     key loop.
//   * K/V tiles stream through a two-stage cp.async ring into rows padded
//     by 16 bytes (the eight rows an ldmatrix reads fall in distinct
//     banks); K is read by ldmatrix, V by ldmatrix.trans. Two stages: a
//     third measured no faster at D = 64 and would leave one block an SM
//     at D = 128.
//   * S = Q K^T stays in registers; the online softmax runs on the
//     accumulators in base 2 (ex2 on the special-function unit); P,
//     rounded to bf16, becomes the A fragment of P V without leaving the
//     registers. lse is written in natural log, m * ln 2 + log(l).
//   * Only tiles that hold an attendable (query, key) pair are walked
//     (causal, window); the block first reads its key range of the mask,
//     16 bytes a thread, into one live bit per tile, and a tile whose keys
//     are all masked for the batch row is neither copied nor computed.
//     Each tile's 64 mask bytes ride in its ring stage. A warp skips the
//     products of a tile none of its rows can see; the causal test runs
//     per element only on tiles the diagonal or the window cuts.
//   * The output goes through shared memory (Q's idle rows) to 16-byte
//     row stores; rows past Lq are not written.
//
// flash_bwd_dkv_mma_kernel (B7): one block of 4 warps per (64 keys, KV
// head, batch row); warp w owns keys 16w.., and its dk and dv
// accumulators for all D columns stay in registers for the whole block.
// For every query head of the group and every query tile that can see the
// keys, in a fixed order, Q, dO and the tile's lse and delta stream
// through a two-stage cp.async ring, and five steps run on the warp's
// keys: S^T = K Q^T (mma), P^T = exp(S^T scale + (1 - keep) NEG - lse) *
// keep, dV += P^T dO (mma, P^T rounded to bf16 in registers), dP^T = V
// dO^T (mma), dS^T = P^T (dP^T - delta) scale and dK += dS^T Q (mma, dS^T
// rounded to bf16). Q and dO are B operands: by ldmatrix for K Q^T and V
// dO^T, by ldmatrix.trans for P^T dO and dS^T Q.
//   * Registers decide the tiles. dk + dv for 16 keys are D / 2 f32
//     registers a thread each (64 + 64 at D = 128). At D <= 64 the warp
//     also holds K and V as A fragments and takes 64-query tiles; at
//     D = 128 it reads K and V fragments from shared memory for each
//     product (ldmatrix, 8 KB a query tile) and takes 32-query tiles, so
//     that S^T and dP^T (16 x BQ each) fit beside the accumulators
//     without a spill (ptxas -v, chip_smoke's build row).
//   * A block whose 64 keys are all masked writes zeros and stops.
//
// flash_bwd_dq_mma_kernel (B6): B5's grid and walk -- one block of 4
// warps per (64 query rows, head, batch row), warp w owns rows 16w..,
// only live tiles that hold an attendable pair, K/V tiles of 64 keys
// (and their mask bytes) through a two-stage cp.async ring. Per tile,
// all in registers: S = Q K^T (mma, K by ldmatrix), P = ex2(S scale
// log2(e) - lse log2(e)) * keep, dP = dO V^T (mma, V by ldmatrix),
// dS = P (dP - delta) scale packed to bf16 (k's dtype) as the A fragment
// of dQ += dS K (mma, K by ldmatrix.trans). lse (in base 2) and delta of
// the thread's two rows stay in registers.
//   * Registers decide the occupancy: the dq accumulator is D / 2 f32
//     registers a thread (32 at D = 64, 64 at 128) beside S and dP (32 +
//     32 at 64 keys). The warp reads its Q and dO fragments from shared
//     memory for each product (ldmatrix, 4 KB a key tile at D = 64) and
//     keeps 64-key tiles: 166 registers at D = 64, three blocks an SM (Q
//     and dO held as fragments took 238, two blocks, and 20 % longer at
//     sst2-bert and GPT-2 shapes), 240 at D = 128; no spill (ptxas -v,
//     chip_smoke's build row).
//   * No atomics: a block owns its dq rows; they go through shared
//     memory (Q's rows) to 16-byte row stores, rows past Lq unwritten.
//
// Head dims: every d >= 1. Every kernel is compiled for D in {16, 32, 64,
// 128, 256} (the tensor-core bodies for D <= 128, the CUDA-core bodies in
// bf16 at 256 only); the wrapper zero-pads any other d <= 256 to the next
// of them, and a d past 256 to a multiple of 256 (zero columns leave
// q . k unchanged and give zero output and gradient columns), and passes
// the scale of the original d. A padded D = 256 nd (nd > 1) runs the
// CUDA-core bodies at D = 256 in nd column chunks: grid x holds the
// chunks beside the row (B5, B6) or key (B7) tiles, each block owns the
// 256 columns of its chunk of out, dq or dk/dv, and its scores (q . k,
// and dO . v in the backward) sum over every chunk, each 256-wide chunk
// of Q, K (dO, V) streaming through the same f32 tiles in turn. Blocks
// of one tile compute the same scores in the same order, so m, l and p
// are bit-identical across chunks; chunk 0 writes lse. The score work
// grows nd-fold: no model the port runs has d > 256, and this path is
// for correctness.
//
// The CUDA-core bodies (fma) -- they compute the function, not the Pallas
// grid:
//   * one block of 128 threads per (query tile, head, batch row) for B5
//     (64 rows) and B6 (32 rows), and per (key tile, KV head, batch row)
//     for B7 (32 keys), times the column chunks past D = 256;
//   * tiles live in dynamic shared memory as f32 (rows padded to D + 1
//     floats, so the dot-product reads hit distinct banks; 42-75 KB a
//     block at D = 64-128, 136-141 KB at D = 256 and past it, granted by
//     a checked attribute call); each thread owns a micro-tile of the
//     score block (rows x strided columns) and of the output, in
//     registers; a row's 8 owners reduce max and sum with three shuffles;
//   * causal and windowed calls walk only the tiles that hold an
//     attendable (query, key) pair, and a key tile whose mask is zero for
//     the batch row is skipped before its load (exact: its p is 0), so
//     the padded tails of short sentences cost nothing;
//   * all math is CUDA-core f32 FMAs (so the f32 path is exact f32).
//
// Build: nvcc compiles this file once per compiled head dim
// (-DMLAPI_UNIT=16, 32, 64, 128, 256) and once for the C entry points
// (-DMLAPI_UNIT=0), all at once, and links one library; without
// MLAPI_UNIT it is one translation unit holding all.
//
// C interface (for ctypes): device pointers, a host pointer to 12 int64
// element strides (batch, row, head for q, k, v, dO; the last dim is
// contiguous and every row 16-byte aligned), the stream as a
// cudaStream_t, and a host pointer that receives the body the call runs;
// the return value is cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a call the kernels do not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tile_primitives.cuh"

#ifndef MLAPI_UNIT
#define MLAPI_UNIT -1
#endif

namespace mlapi_flash {

constexpr int kThreads = 128;  // fma: 16 row groups x 8 column lanes
constexpr float kNeg = -1e30f;

// The tensor-core bodies: 4 warps; B5 blocks of 64 query rows over 64-key
// tiles; B7 blocks of 64 keys over query tiles of dkv_q_rows(D).
constexpr int kMmaThreads = 128;
constexpr int kFwdRows = 64;
constexpr int kFwdKeys = 64;
constexpr int kDkvKeys = 64;
// B6: blocks of 64 query rows over 64-key tiles (B5's grid).
constexpr int kDqRows = 64;
constexpr int kDqKeys = 64;
// Stages of the tensor-core bodies' cp.async rings (see the note above).
constexpr int kMmaStages = 2;

__host__ __device__ constexpr int dkv_q_rows(int d) { return d <= 64 ? 64 : 32; }

struct Strides {
  long long b, l, h;  // elements
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  Strides sq, sk, sv, sdo;
  const uint8_t* mask;  // [B, Lk], nonzero = attend
  void* out;            // [B, Lq, H, D] contiguous (B5)
  float* lse;           // [B, H, Lq] (written by B5, read by B6/B7)
  const float* delta;   // [B, H, Lq] (B6/B7)
  void* dq;             // [B, Lq, H, D] contiguous (B6)
  void* dk;             // [B, Lk, KVH, D] contiguous (B7)
  void* dv;
  int B, Lq, Lk, H, KVH, causal, window;  // window 0: none
  int nd;               // fma: column chunks (rows are D * nd wide)
  float scale;
};

enum Which { kForward, kDq, kDkv };
enum Body { kBodyFma = 0, kBodyMma = 1 };

// The kernels of compiled head dim D (defined in unit D).
template <int D>
int launch_for_d(Which which, Body body, int dtype, const Params& p,
                 cudaStream_t s);

}  // namespace mlapi_flash

#if MLAPI_UNIT != 0
namespace mlapi_flash {
namespace {

using namespace mlapi_tiles;

template <typename T> struct Ops;

template <> struct Ops<float> {
  static constexpr int kVec = 4;  // elements per 16-byte load
  static __device__ float round(float x) { return x; }
  static __device__ float store(float x) { return x; }
  static __device__ void unpack(const uint4& raw, float* out) {
    const float* f = reinterpret_cast<const float*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = f[i];
  }
};

template <> struct Ops<__nv_bfloat16> {
  static constexpr int kVec = 8;
  static __device__ float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
  static __device__ __nv_bfloat16 store(float x) {
    return __float2bfloat16(x);
  }
  static __device__ void unpack(const uint4& raw, float* out) {
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = __bfloat162float(h[i]);
  }
};

// Columns [col0, col0 + D) of rows [row0, row0 + R) of head `head` of
// batch row b, from a [B, L, heads, D * nd] tensor with strides `st`, into
// dst as f32; rows at or past L load 0.
template <typename T, int R, int D>
__device__ void load_rows(const void* src, const Strides& st, int b,
                          int head, int row0, int col0, int L,
                          float (*dst)[D + 1]) {
  constexpr int kVec = Ops<T>::kVec;
  constexpr int kVecs = D / kVec;
  for (int idx = threadIdx.x; idx < R * kVecs; idx += kThreads) {
    const int r = idx / kVecs, c = idx % kVecs, row = row0 + r;
    float vals[kVec];
    if (row < L) {
      const T* at = static_cast<const T*>(src) + b * st.b + row * st.l +
                    head * st.h + col0 + c * kVec;
      Ops<T>::unpack(*reinterpret_cast<const uint4*>(at), vals);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) vals[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i) dst[r][c * kVec + i] = vals[i];
  }
}

// The key mask of keys [k0, k0 + N) into km (0 past Lk). Returns, to
// every thread, whether any of them is valid; also the barrier that
// orders the previous tile's readers before the next tile's writers.
template <int N>
__device__ bool load_key_mask(const Params& p, int b, int k0, float* km) {
  int live = 0;
  for (int t = threadIdx.x; t < N; t += kThreads) {
    const int kj = k0 + t;
    const bool on = kj < p.Lk && p.mask[static_cast<size_t>(b) * p.Lk + kj];
    km[t] = on ? 1.f : 0.f;
    live |= on;
  }
  return __syncthreads_or(live);
}

// keep(query qi, key kj) given the key's mask bit: the causal and window
// terms, and rows past Lq.
__device__ __forceinline__ float keep(const Params& p, int qi, int kj,
                                      float km) {
  if (qi >= p.Lq) return 0.f;
  if (p.causal && (kj > qi || (p.window > 0 && qi - kj >= p.window)))
    return 0.f;
  return km;
}

// Key tiles [*lo, *hi) of width BK that queries [q0, q0 + nq) can see.
__device__ void key_tiles(const Params& p, int q0, int nq, int bk, int* lo,
                          int* hi) {
  int k_lo = 0, k_hi = p.Lk;
  if (p.causal) {
    k_hi = min(p.Lk, q0 + nq);
    if (p.window > 0) k_lo = max(0, q0 - p.window + 1);
  }
  *lo = k_lo / bk;
  *hi = max(*lo, (k_hi + bk - 1) / bk);
}

// Query tiles [*lo, *hi) of width BQ that can see keys [k0, k0 + nk).
__device__ void query_tiles(const Params& p, int k0, int nk, int bq, int* lo,
                            int* hi) {
  int q_lo = 0, q_hi = p.Lq;
  if (p.causal) {
    q_lo = min(k0, p.Lq);
    if (p.window > 0) q_hi = min(p.Lq, k0 + nk - 1 + p.window);
  }
  *lo = q_lo / bq;
  *hi = max(*lo, (q_hi + bq - 1) / bq);
}

__device__ __forceinline__ float group8_max(float x) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float group8_sum(float x) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// B5. Thread (rg, cg) owns query rows rg * R + i and, of a score tile,
// key columns cg + 8 * c; of the output, columns cg + 8 * o.
// Dynamic shared memory of the three kernels (f32 tiles, rows of D + 1).
template <int D>
struct FwdSmem {
  float q[64][D + 1];
  float k[32][D + 1];
  float v[32][D + 1];
  float p[64][33];
  float km[32];
};

template <int D>
struct DqSmem {
  float q[32][D + 1];
  float dout[32][D + 1];
  float k[32][D + 1];
  float v[32][D + 1];
  float ds[32][33];
  float km[32];
};

template <int D>
struct DkvSmem {
  float k[32][D + 1];
  float v[32][D + 1];
  float q[32][D + 1];
  float dout[32][D + 1];
  float pt[32][33];
  float dst[32][33];
  float lse[32];
  float delta[32];
  float km[32];
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
  constexpr int BQ = 64, BK = 32, R = BQ / 16, CS = BK / 8, CO = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  FwdSmem<D>& sm = *reinterpret_cast<FwdSmem<D>*>(smem_raw);
  auto& q_s = sm.q;
  auto& k_s = sm.k;
  auto& v_s = sm.v;
  auto& p_s = sm.p;
  auto& km_s = sm.km;

  // Block (query tile and column chunk, head, batch row).
  const int n_qt = (p.Lq + BQ - 1) / BQ;
  const int q0 = (blockIdx.x % n_qt) * BQ, col0 = (blockIdx.x / n_qt) * D;
  const int h = blockIdx.y, b = blockIdx.z;
  const int j = h / (p.H / p.KVH);
  const int rg = threadIdx.x >> 3, cg = threadIdx.x & 7;

  // Q once; past D = 256 its chunks stream with K's, tile by tile.
  if (p.nd == 1) load_rows<T, BQ, D>(p.q, p.sq, b, h, q0, 0, p.Lq, q_s);
  float m[R], l[R], acc[R][CO];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int o = 0; o < CO; ++o) acc[i][o] = 0.f;
  }

  int t_lo, t_hi;
  key_tiles(p, q0, BQ, BK, &t_lo, &t_hi);
  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * BK;
    if (!load_key_mask<BK>(p, b, k0, km_s)) continue;  // no valid key
    load_rows<T, BK, D>(p.v, p.sv, b, j, k0, col0, p.Lk, v_s);
    float s[R][CS];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < CS; ++c) s[i][c] = 0.f;
    for (int cc = 0; cc < p.nd; ++cc) {
      if (cc > 0) __syncthreads();  // the previous chunk's readers are done
      if (p.nd > 1)
        load_rows<T, BQ, D>(p.q, p.sq, b, h, q0, cc * D, p.Lq, q_s);
      load_rows<T, BK, D>(p.k, p.sk, b, j, k0, cc * D, p.Lk, k_s);
      __syncthreads();
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        float qv[R], kv[CS];
#pragma unroll
        for (int i = 0; i < R; ++i) qv[i] = q_s[rg * R + i][d];
#pragma unroll
        for (int c = 0; c < CS; ++c) kv[c] = k_s[cg + 8 * c][d];
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int c = 0; c < CS; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qi = q0 + rg * R + i;
      float kp[CS];
      float mx = kNeg;
#pragma unroll
      for (int c = 0; c < CS; ++c) {
        kp[c] = keep(p, qi, k0 + cg + 8 * c, km_s[cg + 8 * c]);
        s[i][c] = s[i][c] * p.scale + (1.f - kp[c]) * kNeg;
        mx = c ? fmaxf(mx, s[i][c]) : s[i][c];
      }
      const float m_new = fmaxf(m[i], group8_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < CS; ++c) {
        const float pe = expf(s[i][c] - m_new) * kp[c];
        rs += pe;
        p_s[rg * R + i][cg + 8 * c] = Ops<T>::round(pe);  // v's dtype
      }
      l[i] = alpha * l[i] + group8_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int o = 0; o < CO; ++o) acc[i][o] *= alpha;
    }
    __syncthreads();
#pragma unroll 4
    for (int tt = 0; tt < BK; ++tt) {
      float vv[CO];
#pragma unroll
      for (int o = 0; o < CO; ++o) vv[o] = v_s[tt][cg + 8 * o];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float pv = p_s[rg * R + i][tt];
#pragma unroll
        for (int o = 0; o < CO; ++o) acc[i][o] = fmaf(pv, vv[o], acc[i][o]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qi = q0 + rg * R + i;
    if (qi >= p.Lq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* o_row = static_cast<T*>(p.out) +
               ((static_cast<size_t>(b) * p.Lq + qi) * p.H + h) * D * p.nd +
               col0;
#pragma unroll
    for (int o = 0; o < CO; ++o) o_row[cg + 8 * o] = Ops<T>::store(acc[i][o] / den);
    if (cg == 0 && col0 == 0)
      p.lse[(static_cast<size_t>(b) * p.H + h) * p.Lq + qi] = m[i] + logf(den);
  }
}

// B6. Thread (rg, cg) owns query rows rg * R + i; key columns cg + 8 * c
// of the score tile; dq columns cg + 8 * o.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Params p) {
  constexpr int BQ = 32, BK = 32, R = BQ / 16, CS = BK / 8, CO = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DqSmem<D>& sm = *reinterpret_cast<DqSmem<D>*>(smem_raw);
  auto& q_s = sm.q;
  auto& do_s = sm.dout;
  auto& k_s = sm.k;
  auto& v_s = sm.v;
  auto& ds_s = sm.ds;
  auto& km_s = sm.km;

  // Block (query tile and column chunk, head, batch row).
  const int n_qt = (p.Lq + BQ - 1) / BQ;
  const int q0 = (blockIdx.x % n_qt) * BQ, col0 = (blockIdx.x / n_qt) * D;
  const int h = blockIdx.y, b = blockIdx.z;
  const int j = h / (p.H / p.KVH);
  const int rg = threadIdx.x >> 3, cg = threadIdx.x & 7;

  if (p.nd == 1) {
    load_rows<T, BQ, D>(p.q, p.sq, b, h, q0, 0, p.Lq, q_s);
    load_rows<T, BQ, D>(p.dout, p.sdo, b, h, q0, 0, p.Lq, do_s);
  }
  float lse[R], delta[R], dq[R][CO];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qi = q0 + rg * R + i;
    const size_t at = (static_cast<size_t>(b) * p.H + h) * p.Lq + qi;
    lse[i] = qi < p.Lq ? p.lse[at] : 0.f;
    delta[i] = qi < p.Lq ? p.delta[at] : 0.f;
#pragma unroll
    for (int o = 0; o < CO; ++o) dq[i][o] = 0.f;
  }

  int t_lo, t_hi;
  key_tiles(p, q0, BQ, BK, &t_lo, &t_hi);
  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * BK;
    if (!load_key_mask<BK>(p, b, k0, km_s)) continue;
    float s[R][CS], dp[R][CS];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < CS; ++c) s[i][c] = dp[i][c] = 0.f;
    for (int cc = 0; cc < p.nd; ++cc) {
      if (cc > 0) __syncthreads();  // the previous chunk's readers are done
      if (p.nd > 1) {
        load_rows<T, BQ, D>(p.q, p.sq, b, h, q0, cc * D, p.Lq, q_s);
        load_rows<T, BQ, D>(p.dout, p.sdo, b, h, q0, cc * D, p.Lq, do_s);
      }
      load_rows<T, BK, D>(p.k, p.sk, b, j, k0, cc * D, p.Lk, k_s);
      load_rows<T, BK, D>(p.v, p.sv, b, j, k0, cc * D, p.Lk, v_s);
      __syncthreads();
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        float qv[R], dov[R], kv[CS], vv[CS];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          qv[i] = q_s[rg * R + i][d];
          dov[i] = do_s[rg * R + i][d];
        }
#pragma unroll
        for (int c = 0; c < CS; ++c) {
          kv[c] = k_s[cg + 8 * c][d];
          vv[c] = v_s[cg + 8 * c][d];
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int c = 0; c < CS; ++c) {
            s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
            dp[i][c] = fmaf(dov[i], vv[c], dp[i][c]);
          }
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qi = q0 + rg * R + i;
#pragma unroll
      for (int c = 0; c < CS; ++c) {
        const float kp = keep(p, qi, k0 + cg + 8 * c, km_s[cg + 8 * c]);
        const float sv = s[i][c] * p.scale + (1.f - kp) * kNeg;
        const float pe = expf(sv - lse[i]) * kp;
        const float ds = pe * (dp[i][c] - delta[i]) * p.scale;
        ds_s[rg * R + i][cg + 8 * c] = Ops<T>::round(ds);  // k's dtype
      }
    }
    if (col0 != (p.nd - 1) * D) {
      // k_s holds the last chunk; ds . K needs this block's.
      __syncthreads();
      load_rows<T, BK, D>(p.k, p.sk, b, j, k0, col0, p.Lk, k_s);
    }
    __syncthreads();
#pragma unroll 4
    for (int tt = 0; tt < BK; ++tt) {
      float kk[CO];
#pragma unroll
      for (int o = 0; o < CO; ++o) kk[o] = k_s[tt][cg + 8 * o];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float dsv = ds_s[rg * R + i][tt];
#pragma unroll
        for (int o = 0; o < CO; ++o) dq[i][o] = fmaf(dsv, kk[o], dq[i][o]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qi = q0 + rg * R + i;
    if (qi >= p.Lq) continue;
    T* row = static_cast<T*>(p.dq) +
             ((static_cast<size_t>(b) * p.Lq + qi) * p.H + h) * D * p.nd +
             col0;
#pragma unroll
    for (int o = 0; o < CO; ++o) row[cg + 8 * o] = Ops<T>::store(dq[i][o]);
  }
}

// B7. Thread (rg, cg) owns key rows rg * R + i; query columns cg + 8 * c
// of the transposed score tile; dk/dv columns cg + 8 * o.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(Params p) {
  constexpr int BK = 32, BQ = 32, R = BK / 16, CS = BQ / 8, CO = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DkvSmem<D>& sm = *reinterpret_cast<DkvSmem<D>*>(smem_raw);
  auto& k_s = sm.k;
  auto& v_s = sm.v;
  auto& q_s = sm.q;
  auto& do_s = sm.dout;
  auto& pt_s = sm.pt;
  auto& dst_s = sm.dst;
  auto& lse_s = sm.lse;
  auto& delta_s = sm.delta;
  auto& km_s = sm.km;

  // Block (key tile and column chunk, KV head, batch row).
  const int n_kt = (p.Lk + BK - 1) / BK;
  const int k0 = (blockIdx.x % n_kt) * BK, col0 = (blockIdx.x / n_kt) * D;
  const int j = blockIdx.y, b = blockIdx.z;
  const int group = p.H / p.KVH;
  const int rg = threadIdx.x >> 3, cg = threadIdx.x & 7;
  float dk[R][CO], dv[R][CO];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int o = 0; o < CO; ++o) dk[i][o] = dv[i][o] = 0.f;

  // A tile of keys that are all masked gets dk = dv = 0 (its p is 0).
  if (load_key_mask<BK>(p, b, k0, km_s)) {
    // K and V once; past D = 256 their chunks stream with Q's and dO's.
    if (p.nd == 1) {
      load_rows<T, BK, D>(p.k, p.sk, b, j, k0, 0, p.Lk, k_s);
      load_rows<T, BK, D>(p.v, p.sv, b, j, k0, 0, p.Lk, v_s);
    }
    int t_lo, t_hi;
    query_tiles(p, k0, BK, BQ, &t_lo, &t_hi);
    for (int g = 0; g < group; ++g) {
      const int h = j * group + g;
      for (int t = t_lo; t < t_hi; ++t) {
        const int q0 = t * BQ;
        float st[R][CS], dpt[R][CS];
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int c = 0; c < CS; ++c) st[i][c] = dpt[i][c] = 0.f;
        for (int cc = 0; cc < p.nd; ++cc) {
          __syncthreads();  // the previous step's readers are done
          if (p.nd > 1) {
            load_rows<T, BK, D>(p.k, p.sk, b, j, k0, cc * D, p.Lk, k_s);
            load_rows<T, BK, D>(p.v, p.sv, b, j, k0, cc * D, p.Lk, v_s);
          }
          load_rows<T, BQ, D>(p.q, p.sq, b, h, q0, cc * D, p.Lq, q_s);
          load_rows<T, BQ, D>(p.dout, p.sdo, b, h, q0, cc * D, p.Lq, do_s);
          if (cc == 0) {
            for (int r = threadIdx.x; r < BQ; r += kThreads) {
              const int qi = q0 + r;
              const size_t at =
                  (static_cast<size_t>(b) * p.H + h) * p.Lq + qi;
              lse_s[r] = qi < p.Lq ? p.lse[at] : 0.f;
              delta_s[r] = qi < p.Lq ? p.delta[at] : 0.f;
            }
          }
          __syncthreads();
#pragma unroll 8
          for (int d = 0; d < D; ++d) {
            float kv[R], vv[R], qv[CS], dov[CS];
#pragma unroll
            for (int i = 0; i < R; ++i) {
              kv[i] = k_s[rg * R + i][d];
              vv[i] = v_s[rg * R + i][d];
            }
#pragma unroll
            for (int c = 0; c < CS; ++c) {
              qv[c] = q_s[cg + 8 * c][d];
              dov[c] = do_s[cg + 8 * c][d];
            }
#pragma unroll
            for (int i = 0; i < R; ++i)
#pragma unroll
              for (int c = 0; c < CS; ++c) {
                st[i][c] = fmaf(kv[i], qv[c], st[i][c]);
                dpt[i][c] = fmaf(vv[i], dov[c], dpt[i][c]);
              }
          }
        }
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int kr = rg * R + i;
#pragma unroll
          for (int c = 0; c < CS; ++c) {
            const int qr = cg + 8 * c;
            const float kp = keep(p, q0 + qr, k0 + kr, km_s[kr]);
            const float sv = st[i][c] * p.scale + (1.f - kp) * kNeg;
            const float pe = expf(sv - lse_s[qr]) * kp;
            const float ds = pe * (dpt[i][c] - delta_s[qr]) * p.scale;
            pt_s[kr][qr] = Ops<T>::round(pe);   // dO's dtype
            dst_s[kr][qr] = Ops<T>::round(ds);  // q's dtype
          }
        }
        if (col0 != (p.nd - 1) * D) {
          // q_s and do_s hold the last chunk; the products need this
          // block's.
          __syncthreads();
          load_rows<T, BQ, D>(p.q, p.sq, b, h, q0, col0, p.Lq, q_s);
          load_rows<T, BQ, D>(p.dout, p.sdo, b, h, q0, col0, p.Lq, do_s);
        }
        __syncthreads();
#pragma unroll 4
        for (int rr = 0; rr < BQ; ++rr) {
          float dov[CO], qv[CO];
#pragma unroll
          for (int o = 0; o < CO; ++o) {
            dov[o] = do_s[rr][cg + 8 * o];
            qv[o] = q_s[rr][cg + 8 * o];
          }
#pragma unroll
          for (int i = 0; i < R; ++i) {
            const float pt = pt_s[rg * R + i][rr];
            const float dsv = dst_s[rg * R + i][rr];
#pragma unroll
            for (int o = 0; o < CO; ++o) {
              dv[i][o] = fmaf(pt, dov[o], dv[i][o]);
              dk[i][o] = fmaf(dsv, qv[o], dk[i][o]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int kj = k0 + rg * R + i;
    if (kj >= p.Lk) continue;
    const size_t row =
        ((static_cast<size_t>(b) * p.Lk + kj) * p.KVH + j) * D * p.nd + col0;
#pragma unroll
    for (int o = 0; o < CO; ++o) {
      static_cast<T*>(p.dk)[row + cg + 8 * o] = Ops<T>::store(dk[i][o]);
      static_cast<T*>(p.dv)[row + cg + 8 * o] = Ops<T>::store(dv[i][o]);
    }
  }
}


// -- the tensor-core bodies (bf16, D <= 128) ----------------------------

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Dynamic shared memory of a B5 block: Q (then the output tile), a
// two-stage K/V ring and each stage's 64 key-mask bytes; then (sized by
// the launch) one live bit per key tile of the block's range. Rows are
// padded by 8 bf16 (16 bytes). 46 KB at D = 64, 87 KB at D = 128.
template <int D>
struct FwdMmaSmem {
  static constexpr int kPadRow = D + 8;
  static constexpr int kStages = kMmaStages;
  __nv_bfloat16 q[kFwdRows][kPadRow];
  __nv_bfloat16 k[kStages][kFwdKeys][kPadRow];
  __nv_bfloat16 v[kStages][kFwdKeys][kPadRow];
  uint8_t mask[kStages][kFwdKeys];
};

// Live bits of the key tiles [t_lo, t_lo + n_t) of batch row b: bit t of
// live[] is set when some key of tile t_lo + t is valid. Every thread
// reads 16 mask bytes at a time where the rows allow it. Ends with a
// barrier.
__device__ void tile_live_bits(const Params& p, int b, int t_lo, int n_t,
                               int tile, uint32_t* live) {
  for (int i = threadIdx.x; i < (n_t + 31) / 32; i += kMmaThreads)
    live[i] = 0u;
  __syncthreads();
  const uint8_t* mrow = p.mask + static_cast<size_t>(b) * p.Lk;
  const int k_begin = t_lo * tile, k_end = min(p.Lk, (t_lo + n_t) * tile);
  if (p.Lk % 16 == 0 && reinterpret_cast<uintptr_t>(p.mask) % 16 == 0) {
    for (int key = k_begin + 16 * threadIdx.x; key < k_end;
         key += 16 * kMmaThreads) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(mrow + key));
      if (raw.x | raw.y | raw.z | raw.w) {
        const int t = key / tile - t_lo;   // a piece never straddles tiles
        atomicOr(&live[t >> 5], 1u << (t & 31));
      }
    }
  } else {
    for (int key = k_begin + threadIdx.x; key < k_end; key += kMmaThreads)
      if (mrow[key]) {
        const int t = key / tile - t_lo;
        atomicOr(&live[t >> 5], 1u << (t & 31));
      }
  }
  __syncthreads();
}

// The first live tile at or after t (relative), or n_t.
__device__ __forceinline__ int next_live_tile(const uint32_t* live, int t,
                                              int n_t) {
  while (t < n_t) {
    const uint32_t w = live[t >> 5] >> (t & 31);
    if (w) return min(n_t, t + __ffs(w) - 1);
    t = (t | 31) + 1;
  }
  return n_t;
}

// Whether query qi keeps key kj by the position terms (causal, window).
__device__ __forceinline__ bool pos_keep(const Params& p, int qi, int kj) {
  return kj <= qi && (p.window == 0 || qi - kj < p.window);
}

// B5 on the tensor cores. Block (query tile, head h, batch row b); warp w
// owns query rows q0 + 16w.. (rows g and g + 8 of its m16 tile in each
// thread, g = lane / 4). At most 170 registers a thread at D = 64 (the
// training path's head dim), so that three blocks share an SM; ptxas
// needs 168 and spills nothing there.
template <int D>
__global__ void __launch_bounds__(kMmaThreads, D == 64 ? 3 : 2)
    flash_fwd_mma_kernel(Params p) {
  using bf16 = __nv_bfloat16;
  using Smem = FwdMmaSmem<D>;
  constexpr int KS = D / 16;   // 16-wide steps of d
  constexpr int DT = D / 8;    // 8-wide output column tiles
  constexpr int NT = kFwdKeys / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  uint32_t* live = reinterpret_cast<uint32_t*>(smem_raw + sizeof(Smem));

  // The last query tiles first: under a causal mask they walk the most
  // key tiles, and would otherwise make the tail of the launch.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kFwdRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int j = h / (p.H / p.KVH);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;

  // Q rows -> shared, one cp.async group of its own (zeros past Lq), in
  // flight while the mask is read.
  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.sq.b + h * p.sq.h;
  for (int idx = tid; idx < kFwdRows * DT; idx += kMmaThreads) {
    const int r = idx / DT, c = idx % DT, qi = q0 + r;
    const bool ok = qi < p.Lq;
    cp_async16(&sm.q[r][c * 8], qg + (ok ? qi : 0) * p.sq.l + c * 8, ok);
  }
  cp_async_commit();

  int t_lo, t_hi;
  key_tiles(p, q0, kFwdRows, kFwdKeys, &t_lo, &t_hi);
  const int n_t = t_hi - t_lo;
  tile_live_bits(p, b, t_lo, n_t, kFwdKeys, live);

  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.sk.b + j * p.sk.h;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.sv.b + j * p.sv.h;
  const uint8_t* mrow = p.mask + static_cast<size_t>(b) * p.Lk;
  const bool mvec = p.Lk % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(p.mask) % 16 == 0;
  // Tile t's K/V rows and mask bytes -> stage st (zeros past Lk).
  auto issue = [&](int t, int st) {
    const int key0 = (t_lo + t) * kFwdKeys;
    for (int idx = tid; idx < kFwdKeys * DT; idx += kMmaThreads) {
      const int r = idx / DT, c = idx % DT, key = key0 + r;
      const bool ok = key < p.Lk;
      const int kk = ok ? key : 0;
      cp_async16(&sm.k[st][r][c * 8], kg + kk * p.sk.l + c * 8, ok);
      cp_async16(&sm.v[st][r][c * 8], vg + kk * p.sv.l + c * 8, ok);
    }
    if (mvec) {
      if (tid < kFwdKeys / 16) {
        const int key = key0 + 16 * tid;
        const bool ok = key < p.Lk;
        cp_async16(&sm.mask[st][16 * tid], mrow + (ok ? key : 0), ok);
      }
    } else if (tid < kFwdKeys) {
      const int key = key0 + tid;
      sm.mask[st][tid] = key < p.Lk ? mrow[key] : 0;
    }
  };

  // The ring: the first kStages - 1 live tiles in flight, one commit
  // group each (empty past the last live tile).
  constexpr int kStages = Smem::kStages;
  int fetch = next_live_tile(live, 0, n_t);
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (fetch < n_t) {
      issue(fetch, st);
      fetch = next_live_tile(live, fetch + 1, n_t);
    }
    cp_async_commit();
  }
  cp_async_wait<kStages - 1>();  // Q has landed
  __syncthreads();

  // This warp's Q rows as A fragments, d in 16-wide steps.
  uint32_t qa[KS][4];
  {
    const int r = warp * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      ldsm_x4(qa[kk], &sm.q[r][kk * 16 + (lane / 16) * 8]);
  }

  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[dt][c] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
  const float scale2 = p.scale * kLog2e;
  const int qw0 = q0 + warp * 16;   // this warp's first row

  int st = 0;
  for (int cur = next_live_tile(live, 0, n_t); cur < n_t;
       cur = next_live_tile(live, cur + 1, n_t)) {
    cp_async_wait<kStages - 2>();  // tile cur has landed
    // Every warp is past tile cur - 1, whose stage the next copy reuses.
    __syncthreads();
    if (fetch < n_t) {
      issue(fetch, (st + kStages - 1) % kStages);
      fetch = next_live_tile(live, fetch + 1, n_t);
    }
    cp_async_commit();

    const int key0 = (t_lo + cur) * kFwdKeys;
    // The tile's key mask: bit r = key key0 + r is valid.
    const unsigned long long kbits =
        (static_cast<unsigned long long>(
             __ballot_sync(0xffffffffu, sm.mask[st][32 + lane] != 0))
         << 32) |
        __ballot_sync(0xffffffffu, sm.mask[st][lane] != 0);
    // Some row of this warp sees some key of the tile by position; the
    // per-element position test only where the diagonal or window cuts.
    const bool seen =
        qw0 < p.Lq &&
        (!p.causal || (key0 <= qw0 + 15 &&
                       (p.window == 0 || qw0 - (key0 + kFwdKeys - 1) <
                                             p.window)));
    const bool cut =
        p.causal && (key0 + kFwdKeys - 1 > qw0 ||
                     (p.window > 0 && qw0 + 15 - key0 >= p.window));
    if (seen) {
      // S = Q K^T: key tiles 2np, 2np + 1 per ldmatrix.x4 of K.
      float s[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[nt][c] = 0.f;
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          uint32_t kb[4];
          ldsm_x4(kb, &sm.k[st][np * 16 + (lane % 8) + (lane / 16) * 8]
                               [kk * 16 + ((lane / 8) % 2) * 8]);
          mma_bf16(s[2 * np], qa[kk], kb[0], kb[1]);
          mma_bf16(s[2 * np + 1], qa[kk], kb[2], kb[3]);
        }
      }
      // Scale to base 2 (times scale * log2(e)); a masked score becomes
      // -inf, so that its p is exactly 0. Only a tile that holds a masked
      // key, or that the diagonal or the window cuts, pays for the mask.
      if (cut || kbits != ~0ull) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qi = qw0 + g + 8 * e;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int kr = 8 * nt + 2 * t4 + c;
              const bool kp = ((kbits >> kr) & 1ull) &&
                              (!cut || pos_keep(p, qi, key0 + kr));
              s[nt][2 * e + c] = kp ? s[nt][2 * e + c] * scale2 : -INFINITY;
            }
        }
      } else {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[nt][c] *= scale2;
      }
      // Online softmax of rows g (e = 0) and g + 8 (e = 1), m in base-2
      // units until the write-out. A row that has seen no valid key keeps
      // m = -inf and subtracts 0: its p and l stay exactly 0.
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float mx = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mx = fmaxf(mx, fmaxf(s[nt][2 * e], s[nt][2 * e + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_r[e], mx);
        const float m_sub = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = ex2(m_r[e] - m_sub);
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float pe = ex2(s[nt][2 * e + c] - m_sub);
            s[nt][2 * e + c] = pe;
            sum += pe;
          }
        // l stays per thread (its four lanes meet once, at the end).
        l_r[e] = l_r[e] * alpha + sum;
        m_r[e] = m_new;
#pragma unroll
        for (int dt = 0; dt < DT; ++dt) {
          o[dt][2 * e] *= alpha;
          o[dt][2 * e + 1] *= alpha;
        }
      }
      // O += P V: P (rounded to bf16, v's dtype) straight from the score
      // registers; V tiles 2dp, 2dp + 1 per ldmatrix.x4.trans.
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {
        const uint32_t pa[4] = {
            pack_bf16(s[2 * kk][0], s[2 * kk][1]),
            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]),
        };
#pragma unroll
        for (int dp = 0; dp < KS; ++dp) {
          uint32_t vb[4];
          ldsm_x4_trans(vb, &sm.v[st][kk * 16 + (lane % 8) +
                                      ((lane / 8) % 2) * 8]
                                     [dp * 16 + (lane / 16) * 8]);
          mma_bf16(o[2 * dp], pa, vb[0], vb[1]);
          mma_bf16(o[2 * dp + 1], pa, vb[2], vb[3]);
        }
      }
    }
    st = (st + 1) % kStages;
  }
  cp_async_wait<0>();
  __syncthreads();   // every warp is done with Q's rows and the ring

  // out = acc / max(l, 1e-30) (times the reciprocal), staged in Q's rows;
  // lse = m + log(max(l, 1e-30)) in natural log (m = NEG on a row that
  // saw no valid key, whose l and output are exactly 0).
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    l_r[e] += __shfl_xor_sync(0xffffffffu, l_r[e], 1);
    l_r[e] += __shfl_xor_sync(0xffffffffu, l_r[e], 2);
    const int r = warp * 16 + g + 8 * e, qi = q0 + r;
    const float den = fmaxf(l_r[e], 1e-30f);
    const float inv_l = 1.f / den;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(&sm.q[r][dt * 8 + 2 * t4]) =
          __floats2bfloat162_rn(o[dt][2 * e] * inv_l,
                                o[dt][2 * e + 1] * inv_l);
    if (t4 == 0 && qi < p.Lq)
      p.lse[(static_cast<size_t>(b) * p.H + h) * p.Lq + qi] =
          (l_r[e] > 0.f ? m_r[e] * kLn2 : kNeg) + logf(den);
  }
  __syncthreads();
  for (int idx = tid; idx < kFwdRows * DT; idx += kMmaThreads) {
    const int r = idx / DT, c = idx % DT, qi = q0 + r;
    if (qi >= p.Lq) continue;
    *reinterpret_cast<uint4*>(
        static_cast<bf16*>(p.out) +
        ((static_cast<size_t>(b) * p.Lq + qi) * p.H + h) * D + c * 8) =
        *reinterpret_cast<const uint4*>(&sm.q[r][c * 8]);
  }
}

// Dynamic shared memory of a B7 block: its K and V rows (then the dk/dv
// tiles), a two-stage ring of Q and dO tiles, and each stage's lse and
// delta. 56 KB at D = 64, 70 KB at D = 128.
template <int D>
struct DkvMmaSmem {
  static constexpr int kPadRow = D + 8;
  static constexpr int BQ = dkv_q_rows(D);
  static constexpr int kStages = kMmaStages;
  __nv_bfloat16 k[kDkvKeys][kPadRow];
  __nv_bfloat16 v[kDkvKeys][kPadRow];
  __nv_bfloat16 q[kStages][BQ][kPadRow];
  __nv_bfloat16 dout[kStages][BQ][kPadRow];
  float lse[kStages][BQ];
  float delta[kStages][BQ];
};

// B7 on the tensor cores. Block (key tile, KV head j, batch row b); warp w
// owns keys k0 + 16w.. (rows g and g + 8 of its m16 tile in each thread).
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_bwd_dkv_mma_kernel(Params p) {
  using bf16 = __nv_bfloat16;
  using Smem = DkvMmaSmem<D>;
  constexpr int BQ = Smem::BQ;
  constexpr int KS = D / 16;   // 16-wide steps of d
  constexpr int DT = D / 8;    // 8-wide dk/dv column tiles
  constexpr int NT = BQ / 8;   // 8-wide query column tiles of S^T
  constexpr bool kHoldKV = D <= 64;   // K, V A fragments in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int k0 = blockIdx.x * kDkvKeys, j = blockIdx.y, b = blockIdx.z;
  const int group = p.H / p.KVH;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int kw0 = k0 + warp * 16;   // this warp's first key

  // This thread's two keys (g, g + 8 of the warp's 16) and their mask;
  // a block whose keys are all masked gets dk = dv = 0 (its p is 0).
  bool km[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int kj = kw0 + g + 8 * e;
    km[e] = kj < p.Lk && p.mask[static_cast<size_t>(b) * p.Lk + kj];
  }
  const bool block_live = __syncthreads_or(km[0] || km[1]);

  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk[dt][c] = dv[dt][c] = 0.f;

  if (block_live) {
    // K and V rows of the block -> shared (zeros past Lk).
    const bf16* kg = static_cast<const bf16*>(p.k) + b * p.sk.b + j * p.sk.h;
    const bf16* vg = static_cast<const bf16*>(p.v) + b * p.sv.b + j * p.sv.h;
    for (int idx = tid; idx < kDkvKeys * DT; idx += kMmaThreads) {
      const int r = idx / DT, c = idx % DT, key = k0 + r;
      const bool ok = key < p.Lk;
      const int kk = ok ? key : 0;
      cp_async16(&sm.k[r][c * 8], kg + kk * p.sk.l + c * 8, ok);
      cp_async16(&sm.v[r][c * 8], vg + kk * p.sv.l + c * 8, ok);
    }
    int t_lo, t_hi;
    query_tiles(p, k0, kDkvKeys, BQ, &t_lo, &t_hi);
    const int n_t = t_hi - t_lo, n_items = group * n_t;
    // Item i: query head j * group + i / n_t, query tile t_lo + i % n_t.
    auto issue = [&](int i, int st) {
      const int h = j * group + i / n_t, q0 = (t_lo + i % n_t) * BQ;
      const bf16* qg =
          static_cast<const bf16*>(p.q) + b * p.sq.b + h * p.sq.h;
      const bf16* dg =
          static_cast<const bf16*>(p.dout) + b * p.sdo.b + h * p.sdo.h;
      for (int idx = tid; idx < BQ * DT; idx += kMmaThreads) {
        const int r = idx / DT, c = idx % DT, qi = q0 + r;
        const bool ok = qi < p.Lq;
        const int qq = ok ? qi : 0;
        cp_async16(&sm.q[st][r][c * 8], qg + qq * p.sq.l + c * 8, ok);
        cp_async16(&sm.dout[st][r][c * 8], dg + qq * p.sdo.l + c * 8, ok);
      }
      const size_t rows = (static_cast<size_t>(b) * p.H + h) * p.Lq;
      if (tid < 2 * BQ) {
        const int r = tid % BQ, qi = q0 + r;
        const bool ok = qi < p.Lq;
        const float* src = (tid < BQ ? p.lse : p.delta) + rows + (ok ? qi : 0);
        cp_async4(tid < BQ ? &sm.lse[st][r] : &sm.delta[st][r], src, ok);
      }
    };
    // The ring: items 0 .. kStages - 2 in flight (the first group also
    // holds K and V), one commit group each.
    constexpr int kStages = Smem::kStages;
    int fetch = 0;
#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) {
      if (fetch < n_items) issue(fetch++, st);
      cp_async_commit();
    }
    cp_async_wait<kStages - 2>();   // K, V and item 0 have landed
    __syncthreads();

    // This warp's K and V rows as A fragments (D <= 64: held for the
    // whole block; D = 128: read again for each product).
    const int ar = warp * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
    const int ac = (lane / 16) * 8;
    uint32_t ka[kHoldKV ? KS : 1][4], va[kHoldKV ? KS : 1][4];
    if constexpr (kHoldKV) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        ldsm_x4(ka[kk], &sm.k[ar][kk * 16 + ac]);
        ldsm_x4(va[kk], &sm.v[ar][kk * 16 + ac]);
      }
    }
    // C[nt] += A(rows of src) . B^T where B's rows are BQ query rows of
    // `rows` (x = K with Q, or V with dO): S^T or dP^T.
    auto rows_times = [&](float (&c)[NT][4], const bf16 (*arows)[Smem::kPadRow],
                          const uint32_t (&held)[kHoldKV ? KS : 1][4],
                          const bf16 (*brows)[Smem::kPadRow]) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int x = 0; x < 4; ++x) c[nt][x] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t a[4];
        if constexpr (kHoldKV) {
#pragma unroll
          for (int x = 0; x < 4; ++x) a[x] = held[kk][x];
        } else {
          ldsm_x4(a, &arows[ar][kk * 16 + ac]);
        }
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bb[4];
          ldsm_x4(bb, &brows[np * 16 + (lane % 8) + (lane / 16) * 8]
                            [kk * 16 + ((lane / 8) % 2) * 8]);
          mma_bf16(c[2 * np], a, bb[0], bb[1]);
          mma_bf16(c[2 * np + 1], a, bb[2], bb[3]);
        }
      }
    };
    // acc[dt] += A . rows, A = a 16 x BQ tile in C registers (rounded to
    // bf16 here), `rows` BQ query rows of D columns (ldmatrix.trans).
    auto times_rows = [&](float (&acc)[DT][4], const float (&c)[NT][4],
                          const bf16 (*rows)[Smem::kPadRow]) {
#pragma unroll
      for (int kq = 0; kq < NT / 2; ++kq) {
        const uint32_t a[4] = {
            pack_bf16(c[2 * kq][0], c[2 * kq][1]),
            pack_bf16(c[2 * kq][2], c[2 * kq][3]),
            pack_bf16(c[2 * kq + 1][0], c[2 * kq + 1][1]),
            pack_bf16(c[2 * kq + 1][2], c[2 * kq + 1][3]),
        };
#pragma unroll
        for (int dp = 0; dp < KS; ++dp) {
          uint32_t bb[4];
          ldsm_x4_trans(bb, &rows[kq * 16 + (lane % 8) + ((lane / 8) % 2) * 8]
                                 [dp * 16 + (lane / 16) * 8]);
          mma_bf16(acc[2 * dp], a, bb[0], bb[1]);
          mma_bf16(acc[2 * dp + 1], a, bb[2], bb[3]);
        }
      }
    };

    // Some key of this warp is valid.
    const bool warp_live = __any_sync(0xffffffffu, km[0] || km[1]);
    int st = 0;
    for (int i = 0; i < n_items; ++i) {
      if (i > 0) {
        cp_async_wait<kStages - 2>();  // item i has landed
        // Every warp is past item i - 1, whose stage the next copy reuses.
        __syncthreads();
      }
      if (fetch < n_items) issue(fetch++, (st + kStages - 1) % kStages);
      cp_async_commit();
      const int q0 = (t_lo + i % n_t) * BQ;
      // Some key of this warp is seen by some query of the tile (by
      // position: causal, window; rows past Lq are outside the range).
      const bool seen =
          warp_live &&
          (!p.causal ||
           (kw0 <= q0 + BQ - 1 &&
            (p.window == 0 || q0 - (kw0 + 15) < p.window)));
      // The position terms cut this warp's keys and the tile's queries.
      const bool cut =
          p.causal && (kw0 + 15 > q0 ||
                       (p.window > 0 && q0 + BQ - 1 - kw0 >= p.window));
      if (seen) {
        float sp[NT][4], dpt[NT][4];
        rows_times(sp, sm.k, ka, sm.q[st]);       // S^T = K Q^T
        rows_times(dpt, sm.v, va, sm.dout[st]);   // dP^T = V dO^T
        // P^T = exp(S^T scale + (1 - keep) NEG - lse) * keep (base 2 on
        // ex2); dS^T = P^T (dP^T - delta) scale. Element (nt, x): key row
        // g + 8 (x / 2), query column 8 nt + 2 t4 + x % 2. A query row
        // past Lq needs no test: its Q, dO, lse and delta load as zeros,
        // so its terms of dV and dK are exactly 0.
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int qc = 8 * nt + 2 * t4 + (x & 1), qi = q0 + qc;
            const int kj = kw0 + g + 8 * (x >> 1);
            const float kp =
                km[x >> 1] && (!cut || pos_keep(p, qi, kj)) ? 1.f : 0.f;
            const float sv = sp[nt][x] * p.scale + (1.f - kp) * kNeg -
                             sm.lse[st][qc];
            const float pe = ex2(sv * kLog2e) * kp;
            sp[nt][x] = pe;
            dpt[nt][x] = pe * (dpt[nt][x] - sm.delta[st][qc]) * p.scale;
          }
        times_rows(dv, sp, sm.dout[st]);   // dV += P^T dO
        times_rows(dk, dpt, sm.q[st]);     // dK += dS^T Q
      }
      st = (st + 1) % kStages;
    }
    cp_async_wait<0>();
    __syncthreads();   // every warp is done with K, V and the ring
  }

  // dk, dv -> the K/V rows in shared memory (bf16), then 16-byte row
  // stores; keys past Lk are not written.
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = warp * 16 + g + 8 * e;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      *reinterpret_cast<__nv_bfloat162*>(&sm.k[r][dt * 8 + 2 * t4]) =
          __floats2bfloat162_rn(dk[dt][2 * e], dk[dt][2 * e + 1]);
      *reinterpret_cast<__nv_bfloat162*>(&sm.v[r][dt * 8 + 2 * t4]) =
          __floats2bfloat162_rn(dv[dt][2 * e], dv[dt][2 * e + 1]);
    }
  }
  __syncthreads();
  for (int idx = tid; idx < kDkvKeys * DT; idx += kMmaThreads) {
    const int r = idx / DT, c = idx % DT, kj = k0 + r;
    if (kj >= p.Lk) continue;
    const size_t at = ((static_cast<size_t>(b) * p.Lk + kj) * p.KVH + j) * D +
                      c * 8;
    *reinterpret_cast<uint4*>(static_cast<bf16*>(p.dk) + at) =
        *reinterpret_cast<const uint4*>(&sm.k[r][c * 8]);
    *reinterpret_cast<uint4*>(static_cast<bf16*>(p.dv) + at) =
        *reinterpret_cast<const uint4*>(&sm.v[r][c * 8]);
  }
}

// Dynamic shared memory of a B6 block: Q (then the dq tile) and dO, a
// two-stage K/V ring and each stage's 64 key-mask bytes; then (sized by
// the launch) one live bit per key tile of the block's range. Rows are
// padded by 8 bf16 (16 bytes). 55 KB at D = 64, 104 KB at D = 128.
template <int D>
struct DqMmaSmem {
  static constexpr int kPadRow = D + 8;
  static constexpr int kStages = kMmaStages;
  __nv_bfloat16 q[kDqRows][kPadRow];
  __nv_bfloat16 dout[kDqRows][kPadRow];
  __nv_bfloat16 k[kStages][kDqKeys][kPadRow];
  __nv_bfloat16 v[kStages][kDqKeys][kPadRow];
  uint8_t mask[kStages][kDqKeys];
};

// B6 on the tensor cores. Block (query tile, head h, batch row b); warp w
// owns query rows q0 + 16w.. (rows g and g + 8 of its m16 tile in each
// thread, g = lane / 4).
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_bwd_dq_mma_kernel(Params p) {
  using bf16 = __nv_bfloat16;
  using Smem = DqMmaSmem<D>;
  constexpr int KS = D / 16;   // 16-wide steps of d
  constexpr int DT = D / 8;    // 8-wide dq column tiles
  constexpr int NT = kDqKeys / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  uint32_t* live = reinterpret_cast<uint32_t*>(smem_raw + sizeof(Smem));

  // The last query tiles first, as in B5: under a causal mask they walk
  // the most key tiles.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kDqRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int j = h / (p.H / p.KVH);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;

  // Q and dO rows -> shared, one cp.async group of their own (zeros past
  // Lq), in flight while the mask is read.
  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.sq.b + h * p.sq.h;
  const bf16* dg =
      static_cast<const bf16*>(p.dout) + b * p.sdo.b + h * p.sdo.h;
  for (int idx = tid; idx < kDqRows * DT; idx += kMmaThreads) {
    const int r = idx / DT, c = idx % DT, qi = q0 + r;
    const bool ok = qi < p.Lq;
    const int qq = ok ? qi : 0;
    cp_async16(&sm.q[r][c * 8], qg + qq * p.sq.l + c * 8, ok);
    cp_async16(&sm.dout[r][c * 8], dg + qq * p.sdo.l + c * 8, ok);
  }
  cp_async_commit();

  // lse (in base 2) and delta of this thread's rows g and g + 8; rows
  // past Lq read 0 (their dq is not written).
  const int qw0 = q0 + warp * 16;   // this warp's first row
  float lse2[2], dlt[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int qi = qw0 + g + 8 * e;
    const size_t at = (static_cast<size_t>(b) * p.H + h) * p.Lq + qi;
    lse2[e] = qi < p.Lq ? p.lse[at] * kLog2e : 0.f;
    dlt[e] = qi < p.Lq ? p.delta[at] : 0.f;
  }

  int t_lo, t_hi;
  key_tiles(p, q0, kDqRows, kDqKeys, &t_lo, &t_hi);
  const int n_t = t_hi - t_lo;
  tile_live_bits(p, b, t_lo, n_t, kDqKeys, live);

  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.sk.b + j * p.sk.h;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.sv.b + j * p.sv.h;
  const uint8_t* mrow = p.mask + static_cast<size_t>(b) * p.Lk;
  const bool mvec = p.Lk % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(p.mask) % 16 == 0;
  // Tile t's K/V rows and mask bytes -> stage st (zeros past Lk).
  auto issue = [&](int t, int st) {
    const int key0 = (t_lo + t) * kDqKeys;
    for (int idx = tid; idx < kDqKeys * DT; idx += kMmaThreads) {
      const int r = idx / DT, c = idx % DT, key = key0 + r;
      const bool ok = key < p.Lk;
      const int kk = ok ? key : 0;
      cp_async16(&sm.k[st][r][c * 8], kg + kk * p.sk.l + c * 8, ok);
      cp_async16(&sm.v[st][r][c * 8], vg + kk * p.sv.l + c * 8, ok);
    }
    if (mvec) {
      if (tid < kDqKeys / 16) {
        const int key = key0 + 16 * tid;
        const bool ok = key < p.Lk;
        cp_async16(&sm.mask[st][16 * tid], mrow + (ok ? key : 0), ok);
      }
    } else if (tid < kDqKeys) {
      const int key = key0 + tid;
      sm.mask[st][tid] = key < p.Lk ? mrow[key] : 0;
    }
  };

  // The ring: the first kStages - 1 live tiles in flight, one commit
  // group each (empty past the last live tile).
  constexpr int kStages = Smem::kStages;
  int fetch = next_live_tile(live, 0, n_t);
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (fetch < n_t) {
      issue(fetch, st);
      fetch = next_live_tile(live, fetch + 1, n_t);
    }
    cp_async_commit();
  }
  cp_async_wait<kStages - 1>();  // Q and dO have landed
  __syncthreads();
  // c[nt] = A . B^T over d: A this warp's 16 rows of `arows` (ldmatrix
  // for each product), B the 64 keys of `brows` (Q with K: S; dO with V:
  // dP).
  const int ar = warp * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
  const int ac = (lane / 16) * 8;
  auto rows_times = [&](float (&c)[NT][4], const bf16 (*arows)[Smem::kPadRow],
                        const bf16 (*brows)[Smem::kPadRow]) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int x = 0; x < 4; ++x) c[nt][x] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, &arows[ar][kk * 16 + ac]);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bb[4];
        ldsm_x4(bb, &brows[np * 16 + (lane % 8) + (lane / 16) * 8]
                          [kk * 16 + ((lane / 8) % 2) * 8]);
        mma_bf16(c[2 * np], a, bb[0], bb[1]);
        mma_bf16(c[2 * np + 1], a, bb[2], bb[3]);
      }
    }
  };

  float dq[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int c = 0; c < 4; ++c) dq[dt][c] = 0.f;
  const float scale2 = p.scale * kLog2e;

  int st = 0;
  for (int cur = next_live_tile(live, 0, n_t); cur < n_t;
       cur = next_live_tile(live, cur + 1, n_t)) {
    cp_async_wait<kStages - 2>();  // tile cur has landed
    // Every warp is past tile cur - 1, whose stage the next copy reuses.
    __syncthreads();
    if (fetch < n_t) {
      issue(fetch, (st + kStages - 1) % kStages);
      fetch = next_live_tile(live, fetch + 1, n_t);
    }
    cp_async_commit();

    const int key0 = (t_lo + cur) * kDqKeys;
    // The tile's key mask: bit r = key key0 + r is valid.
    const unsigned long long kbits =
        (static_cast<unsigned long long>(
             __ballot_sync(0xffffffffu, sm.mask[st][32 + lane] != 0))
         << 32) |
        __ballot_sync(0xffffffffu, sm.mask[st][lane] != 0);
    // Some row of this warp sees some key of the tile by position; the
    // per-element position test only where the diagonal or window cuts.
    const bool seen =
        qw0 < p.Lq &&
        (!p.causal || (key0 <= qw0 + 15 &&
                       (p.window == 0 || qw0 - (key0 + kDqKeys - 1) <
                                             p.window)));
    const bool cut =
        p.causal && (key0 + kDqKeys - 1 > qw0 ||
                     (p.window > 0 && qw0 + 15 - key0 >= p.window));
    if (seen) {
      float s[NT][4], dp[NT][4];
      rows_times(s, sm.q, sm.k[st]);      // S = Q K^T
      rows_times(dp, sm.dout, sm.v[st]);  // dP = dO V^T
      // P = exp(S scale - lse) * keep (base 2 on ex2; a masked score's p
      // is exactly 0) and dS = P (dP - delta) scale, into dp. Element
      // (nt, x): row g + 8 (x / 2), key 8 nt + 2 t4 + x % 2. Only a tile
      // that holds a masked key, or that the diagonal or the window cuts,
      // pays for the mask.
      if (cut || kbits != ~0ull) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int e = x >> 1, kr = 8 * nt + 2 * t4 + (x & 1);
            const bool kp = ((kbits >> kr) & 1ull) &&
                            (!cut || pos_keep(p, qw0 + g + 8 * e, key0 + kr));
            const float pe = kp ? ex2(fmaf(s[nt][x], scale2, -lse2[e])) : 0.f;
            dp[nt][x] = pe * (dp[nt][x] - dlt[e]) * p.scale;
          }
      } else {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int e = x >> 1;
            const float pe = ex2(fmaf(s[nt][x], scale2, -lse2[e]));
            dp[nt][x] = pe * (dp[nt][x] - dlt[e]) * p.scale;
          }
      }
      // dQ += dS K: dS (rounded to bf16, k's dtype) straight from the
      // registers; K tiles 2dp, 2dp + 1 per ldmatrix.x4.trans.
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {
        const uint32_t a[4] = {
            pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
            pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
            pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
            pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]),
        };
#pragma unroll
        for (int dc = 0; dc < KS; ++dc) {
          uint32_t kb[4];
          ldsm_x4_trans(kb, &sm.k[st][kk * 16 + (lane % 8) +
                                      ((lane / 8) % 2) * 8]
                                     [dc * 16 + (lane / 16) * 8]);
          mma_bf16(dq[2 * dc], a, kb[0], kb[1]);
          mma_bf16(dq[2 * dc + 1], a, kb[2], kb[3]);
        }
      }
    }
    st = (st + 1) % kStages;
  }
  cp_async_wait<0>();
  __syncthreads();   // every warp is done with Q's rows and the ring

  // dq -> Q's rows in shared memory (bf16), then 16-byte row stores; rows
  // past Lq are not written.
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = warp * 16 + g + 8 * e;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(&sm.q[r][dt * 8 + 2 * t4]) =
          __floats2bfloat162_rn(dq[dt][2 * e], dq[dt][2 * e + 1]);
  }
  __syncthreads();
  for (int idx = tid; idx < kDqRows * DT; idx += kMmaThreads) {
    const int r = idx / DT, c = idx % DT, qi = q0 + r;
    if (qi >= p.Lq) continue;
    *reinterpret_cast<uint4*>(
        static_cast<bf16*>(p.dq) +
        ((static_cast<size_t>(b) * p.Lq + qi) * p.H + h) * D + c * 8) =
        *reinterpret_cast<const uint4*>(&sm.q[r][c * 8]);
  }
}

// Grant a kernel `bytes` of dynamic shared memory (once per size it grows
// to; checked).
template <typename K>
cudaError_t grant_smem(K kernel, int bytes, int* granted) {
  if (bytes <= *granted) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *granted = bytes;
  return err;
}

// The CUDA-core bodies (f32 at every compiled D; bf16 at D = 256 only:
// below it every bf16 call runs a tensor-core body, flash_body). Grid x
// holds the row or key tiles times p.nd column chunks.
template <typename T, int D>
int launch_t(Which which, const Params& p, cudaStream_t s) {
  cudaError_t err = cudaSuccess;
  switch (which) {
    case kForward: {
      static int granted = 48 * 1024;
      constexpr int smem = sizeof(FwdSmem<D>);
      err = grant_smem(flash_fwd_kernel<T, D>, smem, &granted);
      if (err != cudaSuccess) break;
      flash_fwd_kernel<T, D><<<dim3((p.Lq + 63) / 64 * p.nd, p.H, p.B),
                               kThreads, smem, s>>>(p);
      break;
    }
    case kDq: {
      static int granted = 48 * 1024;
      constexpr int smem = sizeof(DqSmem<D>);
      err = grant_smem(flash_bwd_dq_kernel<T, D>, smem, &granted);
      if (err != cudaSuccess) break;
      flash_bwd_dq_kernel<T, D><<<dim3((p.Lq + 31) / 32 * p.nd, p.H, p.B),
                                  kThreads, smem, s>>>(p);
      break;
    }
    case kDkv: {
      static int granted = 48 * 1024;
      constexpr int smem = sizeof(DkvSmem<D>);
      err = grant_smem(flash_bwd_dkv_kernel<T, D>, smem, &granted);
      if (err != cudaSuccess) break;
      flash_bwd_dkv_kernel<T, D><<<dim3((p.Lk + 31) / 32 * p.nd, p.KVH,
                                        p.B),
                                   kThreads, smem, s>>>(p);
      break;
    }
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core bodies (bf16; D <= 128): B5, B6 and B7.
template <int D>
int launch_mma(Which which, const Params& p, cudaStream_t s) {
  cudaError_t err = cudaSuccess;
  if (which == kForward || which == kDq) {
    // The live bits of the longest key range a block walks (B5 and B6
    // share their tiles: kFwdKeys == kDqKeys).
    const int n_tiles = (p.Lk + kFwdKeys - 1) / kFwdKeys;
    const int bits = 4 * ((n_tiles + 31) / 32);
    if (which == kForward) {
      const int smem = static_cast<int>(sizeof(FwdMmaSmem<D>)) + bits;
      static int granted = 48 * 1024;
      err = grant_smem(flash_fwd_mma_kernel<D>, smem, &granted);
      if (err != cudaSuccess) return static_cast<int>(err);
      flash_fwd_mma_kernel<D><<<dim3((p.Lq + kFwdRows - 1) / kFwdRows, p.H,
                                     p.B),
                                kMmaThreads, smem, s>>>(p);
    } else {
      const int smem = static_cast<int>(sizeof(DqMmaSmem<D>)) + bits;
      static int granted = 48 * 1024;
      err = grant_smem(flash_bwd_dq_mma_kernel<D>, smem, &granted);
      if (err != cudaSuccess) return static_cast<int>(err);
      flash_bwd_dq_mma_kernel<D><<<dim3((p.Lq + kDqRows - 1) / kDqRows, p.H,
                                        p.B),
                                   kMmaThreads, smem, s>>>(p);
    }
  } else {
    constexpr int smem = sizeof(DkvMmaSmem<D>);
    static int granted = 48 * 1024;
    err = grant_smem(flash_bwd_dkv_mma_kernel<D>, smem, &granted);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_bwd_dkv_mma_kernel<D><<<dim3((p.Lk + kDkvKeys - 1) / kDkvKeys,
                                       p.KVH, p.B),
                                  kMmaThreads, smem, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

template <int D>
int launch_for_d(Which which, Body body, int dtype, const Params& p,
                 cudaStream_t s) {
  if (body == kBodyMma) {
    if constexpr (D <= 128) {
      return launch_mma<D>(which, p, s);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (dtype == 0) return launch_t<float, D>(which, p, s);
  if constexpr (D <= 128) {
    return static_cast<int>(cudaErrorInvalidValue);   // bf16 runs mma
  } else {
    return launch_t<__nv_bfloat16, D>(which, p, s);
  }
}

#if MLAPI_UNIT > 0
template int launch_for_d<MLAPI_UNIT>(Which, Body, int, const Params&,
                                      cudaStream_t);
#endif

}  // namespace mlapi_flash
#endif  // MLAPI_UNIT != 0

#if MLAPI_UNIT <= 0
namespace mlapi_flash {
namespace {

// The body of a call (mirrored by the wrapper's _body() for the CPU
// tests): bf16 at D <= 128 on the tensor cores; f32 and D >= 256 on the
// CUDA cores.
Body flash_body(int dtype, int D) {
  return dtype == 1 && D <= 128 ? kBodyMma : kBodyFma;
}

int launch(Which which, const void* q, const void* k, const void* v,
           const void* mask, const void* dout, void* out, void* lse,
           const void* delta, void* dq, void* dk, void* dv,
           const long long* strides, int dtype, int B, int Lq, int Lk, int H,
           int KVH, int D, int causal, int window, float scale, void* stream,
           int* body) {
  // D: a compiled head dim, or 256 nd (column chunks of the D = 256
  // bodies); grid x (tiles times nd) within its limit.
  const long long nd = D >= 256 ? D / 256 : 1;
  if ((D != 16 && D != 32 && D != 64 && D != 128 && D % 256 != 0) ||
      D < 1 || B < 1 || Lq < 1 || Lk < 1 || KVH < 1 || H % KVH ||
      window < 0 || B > 65535 || H > 65535 || (dtype != 0 && dtype != 1) ||
      (static_cast<long long>(Lq) + 31) / 32 * nd > 0x7fffffff ||
      (static_cast<long long>(Lk) + 31) / 32 * nd > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const Body b = flash_body(dtype, D);
  *body = b;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.sq = {strides[0], strides[1], strides[2]};
  p.sk = {strides[3], strides[4], strides[5]};
  p.sv = {strides[6], strides[7], strides[8]};
  p.sdo = {strides[9], strides[10], strides[11]};
  p.mask = static_cast<const uint8_t*>(mask);
  p.out = out;
  p.lse = static_cast<float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.B = B;
  p.Lq = Lq;
  p.Lk = Lk;
  p.H = H;
  p.KVH = KVH;
  p.causal = causal;
  p.window = window;
  p.nd = static_cast<int>(nd);
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_for_d<16>(which, b, dtype, p, s);
    case 32: return launch_for_d<32>(which, b, dtype, p, s);
    case 64: return launch_for_d<64>(which, b, dtype, p, s);
    case 128: return launch_for_d<128>(which, b, dtype, p, s);
    default: return launch_for_d<256>(which, b, dtype, p, s);
  }
}

}  // namespace
}  // namespace mlapi_flash

using mlapi_flash::launch;
using mlapi_flash::kForward;
using mlapi_flash::kDq;
using mlapi_flash::kDkv;

// dtype: 0 f32, 1 bf16 (q, k, v, dO and every output but lse share it).
// D: 16, 32, 64, 128 or a multiple of 256 (the wrapper pads to one).
// strides: q, k, v, dO, each (batch, row, head) in elements; the forward
// ignores dO's. mask: uint8 [B, Lk]. window: 0 for none (causal only).
// body (out): the body the call runs, 0 CUDA cores, 1 tensor cores.
extern "C" {

// B5: out [B, Lq, H, D] and lse f32 [B, H, Lq].
int mlapi_flash_forward(const void* q, const void* k, const void* v,
                        const void* mask, void* out, void* lse,
                        const long long* strides, int dtype, int B, int Lq,
                        int Lk, int H, int KVH, int D, int causal, int window,
                        float scale, void* stream, int* body) {
  return launch(kForward, q, k, v, mask, nullptr, out, lse, nullptr, nullptr,
                nullptr, nullptr, strides, dtype, B, Lq, Lk, H, KVH, D,
                causal, window, scale, stream, body);
}

// B6: dq [B, Lq, H, D] from dO, lse and delta (f32 [B, H, Lq]).
int mlapi_flash_backward_dq(const void* q, const void* k, const void* v,
                            const void* mask, const void* dout,
                            const void* lse, const void* delta, void* dq,
                            const long long* strides, int dtype, int B,
                            int Lq, int Lk, int H, int KVH, int D, int causal,
                            int window, float scale, void* stream,
                            int* body) {
  return launch(kDq, q, k, v, mask, dout, nullptr, const_cast<void*>(lse),
                delta, dq, nullptr, nullptr, strides, dtype, B, Lq, Lk, H,
                KVH, D, causal, window, scale, stream, body);
}

// B7: dk, dv [B, Lk, KVH, D] from dO, lse and delta.
int mlapi_flash_backward_dkv(const void* q, const void* k, const void* v,
                             const void* mask, const void* dout,
                             const void* lse, const void* delta, void* dk,
                             void* dv, const long long* strides, int dtype,
                             int B, int Lq, int Lk, int H, int KVH, int D,
                             int causal, int window, float scale,
                             void* stream, int* body) {
  return launch(kDkv, q, k, v, mask, dout, nullptr, const_cast<void*>(lse),
                delta, nullptr, dk, dv, strides, dtype, B, Lq, Lk, H, KVH, D,
                causal, window, scale, stream, body);
}

}  // extern "C"
#endif  // MLAPI_UNIT <= 0
