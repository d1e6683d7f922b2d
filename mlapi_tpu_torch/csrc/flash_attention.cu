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
//   B5: online softmax over 32-key tiles: out = softmax(s) . v in q's
//       dtype, and the per-row log-sum-exp lse = m + log(max(l, 1e-30)),
//       f32 [B, H, Lq]. A row with no valid key gives out = 0.
//   B6: dq = sum over key tiles of ds . k, where p = exp(s - lse) * keep
//       is recomputed from the saved lse, dp = dO . v^T and
//       ds = p * (dp - delta) * scale; delta = rowsum(dO * O) minus any
//       lse cotangent comes from the caller (one torch op, as in JAX).
//   B7: per KV head and 32-key tile, dv = sum p^T . dO and dk = sum
//       ds^T . q over every query head of the group and every query tile
//       that can see the keys: the whole group accumulates in registers of
//       one block, so the sums are deterministic (no atomics).
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
// TB/s. At L = 1024 (GPT-2 causal) the FLOPs dominate.
//
// Head dims: every kernel is compiled for D in {16, 32, 64, 128}; the
// wrapper zero-pads any other d <= 128 to the next of them (zero columns
// leave q . k unchanged and give zero output and gradient columns) and
// passes the scale of the original d.
//
// What this first version does about it -- it computes the function, not
// the Pallas grid, and leaves tensor cores (mma/wgmma) and TMA for later:
//   * one block of 128 threads per (query tile, head, batch row) for B5
//     (64 rows) and B6 (32 rows), and per (key tile, KV head, batch row)
//     for B7, so BERT-base at B = 32 puts 768 blocks on the 132 SMs;
//   * tiles live in dynamic shared memory as f32 (rows padded to D + 1
//     floats, so the dot-product reads hit distinct banks; 42-75 KB a
//     block at D = 64-128, granted by a checked attribute call); each
//     thread owns a micro-tile of the score block (rows x strided
//     columns) and of the output, in registers; a row's 8 owners reduce
//     max and sum with three shuffles;
//   * causal and windowed calls walk only the tiles that hold an
//     attendable (query, key) pair, and a key tile whose mask is zero for
//     the batch row is skipped before its load (exact: its p is 0), so
//     the padded tails of short sentences cost nothing;
//   * all math is CUDA-core f32 FMAs (so the f32 path is exact f32).
//
// Build: nvcc compiles this file once per compiled head dim
// (-DMLAPI_UNIT=16, 32, 64, 128) and once for the C entry points
// (-DMLAPI_UNIT=0), all at once, and links one library; without
// MLAPI_UNIT it is one translation unit holding all.
//
// C interface (for ctypes): device pointers, a host pointer to 12 int64
// element strides (batch, row, head for q, k, v, dO; the last dim is
// contiguous and every row 16-byte aligned), the stream as a
// cudaStream_t; the return value is cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef MLAPI_UNIT
#define MLAPI_UNIT -1
#endif

namespace mlapi_flash {

constexpr int kThreads = 128;  // 16 row groups x 8 column lanes
constexpr float kNeg = -1e30f;

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
  float scale;
};

enum Which { kForward, kDq, kDkv };

// The kernels of compiled head dim D (defined in unit D).
template <int D>
int launch_for_d(Which which, int dtype, const Params& p, cudaStream_t s);

}  // namespace mlapi_flash

#if MLAPI_UNIT != 0
namespace mlapi_flash {
namespace {

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

// Rows [row0, row0 + R) of head `head` of batch row b, from a
// [B, L, heads, D] tensor with strides `st`, into dst as f32; rows at or
// past L load 0.
template <typename T, int R, int D>
__device__ void load_rows(const void* src, const Strides& st, int b,
                          int head, int row0, int L, float (*dst)[D + 1]) {
  constexpr int kVec = Ops<T>::kVec;
  constexpr int kVecs = D / kVec;
  for (int idx = threadIdx.x; idx < R * kVecs; idx += kThreads) {
    const int r = idx / kVecs, c = idx % kVecs, row = row0 + r;
    float vals[kVec];
    if (row < L) {
      const T* at = static_cast<const T*>(src) + b * st.b + row * st.l +
                    head * st.h + c * kVec;
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

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int j = h / (p.H / p.KVH);
  const int rg = threadIdx.x >> 3, cg = threadIdx.x & 7;

  load_rows<T, BQ, D>(p.q, p.sq, b, h, q0, p.Lq, q_s);
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
    load_rows<T, BK, D>(p.k, p.sk, b, j, k0, p.Lk, k_s);
    load_rows<T, BK, D>(p.v, p.sv, b, j, k0, p.Lk, v_s);
    __syncthreads();

    float s[R][CS];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < CS; ++c) s[i][c] = 0.f;
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
               ((static_cast<size_t>(b) * p.Lq + qi) * p.H + h) * D;
#pragma unroll
    for (int o = 0; o < CO; ++o) o_row[cg + 8 * o] = Ops<T>::store(acc[i][o] / den);
    if (cg == 0)
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

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int j = h / (p.H / p.KVH);
  const int rg = threadIdx.x >> 3, cg = threadIdx.x & 7;

  load_rows<T, BQ, D>(p.q, p.sq, b, h, q0, p.Lq, q_s);
  load_rows<T, BQ, D>(p.dout, p.sdo, b, h, q0, p.Lq, do_s);
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
    load_rows<T, BK, D>(p.k, p.sk, b, j, k0, p.Lk, k_s);
    load_rows<T, BK, D>(p.v, p.sv, b, j, k0, p.Lk, v_s);
    __syncthreads();

    float s[R][CS], dp[R][CS];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < CS; ++c) s[i][c] = dp[i][c] = 0.f;
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
             ((static_cast<size_t>(b) * p.Lq + qi) * p.H + h) * D;
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

  const int k0 = blockIdx.x * BK, j = blockIdx.y, b = blockIdx.z;
  const int group = p.H / p.KVH;
  const int rg = threadIdx.x >> 3, cg = threadIdx.x & 7;
  float dk[R][CO], dv[R][CO];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int o = 0; o < CO; ++o) dk[i][o] = dv[i][o] = 0.f;

  // A tile of keys that are all masked gets dk = dv = 0 (its p is 0).
  if (load_key_mask<BK>(p, b, k0, km_s)) {
    load_rows<T, BK, D>(p.k, p.sk, b, j, k0, p.Lk, k_s);
    load_rows<T, BK, D>(p.v, p.sv, b, j, k0, p.Lk, v_s);
    int t_lo, t_hi;
    query_tiles(p, k0, BK, BQ, &t_lo, &t_hi);
    for (int g = 0; g < group; ++g) {
      const int h = j * group + g;
      for (int t = t_lo; t < t_hi; ++t) {
        const int q0 = t * BQ;
        __syncthreads();  // the previous step's readers are done
        load_rows<T, BQ, D>(p.q, p.sq, b, h, q0, p.Lq, q_s);
        load_rows<T, BQ, D>(p.dout, p.sdo, b, h, q0, p.Lq, do_s);
        for (int r = threadIdx.x; r < BQ; r += kThreads) {
          const int qi = q0 + r;
          const size_t at = (static_cast<size_t>(b) * p.H + h) * p.Lq + qi;
          lse_s[r] = qi < p.Lq ? p.lse[at] : 0.f;
          delta_s[r] = qi < p.Lq ? p.delta[at] : 0.f;
        }
        __syncthreads();

        float st[R][CS], dpt[R][CS];
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int c = 0; c < CS; ++c) st[i][c] = dpt[i][c] = 0.f;
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
    const size_t row = ((static_cast<size_t>(b) * p.Lk + kj) * p.KVH + j) * D;
#pragma unroll
    for (int o = 0; o < CO; ++o) {
      static_cast<T*>(p.dk)[row + cg + 8 * o] = Ops<T>::store(dk[i][o]);
      static_cast<T*>(p.dv)[row + cg + 8 * o] = Ops<T>::store(dv[i][o]);
    }
  }
}

// Grant a kernel `bytes` of dynamic shared memory (once; checked).
template <typename K>
cudaError_t grant_smem(K kernel, int bytes, int* granted) {
  if (bytes <= *granted) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *granted = bytes;
  return err;
}

template <typename T, int D>
int launch_t(Which which, const Params& p, cudaStream_t s) {
  cudaError_t err = cudaSuccess;
  switch (which) {
    case kForward: {
      static int granted = 48 * 1024;
      constexpr int smem = sizeof(FwdSmem<D>);
      err = grant_smem(flash_fwd_kernel<T, D>, smem, &granted);
      if (err != cudaSuccess) break;
      flash_fwd_kernel<T, D><<<dim3((p.Lq + 63) / 64, p.H, p.B), kThreads,
                               smem, s>>>(p);
      break;
    }
    case kDq: {
      static int granted = 48 * 1024;
      constexpr int smem = sizeof(DqSmem<D>);
      err = grant_smem(flash_bwd_dq_kernel<T, D>, smem, &granted);
      if (err != cudaSuccess) break;
      flash_bwd_dq_kernel<T, D><<<dim3((p.Lq + 31) / 32, p.H, p.B),
                                  kThreads, smem, s>>>(p);
      break;
    }
    case kDkv: {
      static int granted = 48 * 1024;
      constexpr int smem = sizeof(DkvSmem<D>);
      err = grant_smem(flash_bwd_dkv_kernel<T, D>, smem, &granted);
      if (err != cudaSuccess) break;
      flash_bwd_dkv_kernel<T, D><<<dim3((p.Lk + 31) / 32, p.KVH, p.B),
                                   kThreads, smem, s>>>(p);
      break;
    }
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

template <int D>
int launch_for_d(Which which, int dtype, const Params& p, cudaStream_t s) {
  if (dtype == 0) return launch_t<float, D>(which, p, s);
  return launch_t<__nv_bfloat16, D>(which, p, s);
}

#if MLAPI_UNIT > 0
template int launch_for_d<MLAPI_UNIT>(Which, int, const Params&,
                                      cudaStream_t);
#endif

}  // namespace mlapi_flash
#endif  // MLAPI_UNIT != 0

#if MLAPI_UNIT <= 0
namespace mlapi_flash {
namespace {

int launch(Which which, const void* q, const void* k, const void* v,
           const void* mask, const void* dout, void* out, void* lse,
           const void* delta, void* dq, void* dk, void* dv,
           const long long* strides, int dtype, int B, int Lq, int Lk, int H,
           int KVH, int D, int causal, int window, float scale,
           void* stream) {
  if ((D != 16 && D != 32 && D != 64 && D != 128) || B < 1 || Lq < 1 ||
      Lk < 1 || KVH < 1 || H % KVH || window < 0 || B > 65535 || H > 65535 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
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
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_for_d<16>(which, dtype, p, s);
    case 32: return launch_for_d<32>(which, dtype, p, s);
    case 64: return launch_for_d<64>(which, dtype, p, s);
    default: return launch_for_d<128>(which, dtype, p, s);
  }
}

}  // namespace
}  // namespace mlapi_flash

using mlapi_flash::launch;
using mlapi_flash::kForward;
using mlapi_flash::kDq;
using mlapi_flash::kDkv;

// dtype: 0 f32, 1 bf16 (q, k, v, dO and every output but lse share it).
// strides: q, k, v, dO, each (batch, row, head) in elements; the forward
// ignores dO's. mask: uint8 [B, Lk]. window: 0 for none (causal only).
extern "C" {

// B5: out [B, Lq, H, D] and lse f32 [B, H, Lq].
int mlapi_flash_forward(const void* q, const void* k, const void* v,
                        const void* mask, void* out, void* lse,
                        const long long* strides, int dtype, int B, int Lq,
                        int Lk, int H, int KVH, int D, int causal, int window,
                        float scale, void* stream) {
  return launch(kForward, q, k, v, mask, nullptr, out, lse, nullptr, nullptr,
                nullptr, nullptr, strides, dtype, B, Lq, Lk, H, KVH, D,
                causal, window, scale, stream);
}

// B6: dq [B, Lq, H, D] from dO, lse and delta (f32 [B, H, Lq]).
int mlapi_flash_backward_dq(const void* q, const void* k, const void* v,
                            const void* mask, const void* dout,
                            const void* lse, const void* delta, void* dq,
                            const long long* strides, int dtype, int B,
                            int Lq, int Lk, int H, int KVH, int D, int causal,
                            int window, float scale, void* stream) {
  return launch(kDq, q, k, v, mask, dout, nullptr, const_cast<void*>(lse),
                delta, dq, nullptr, nullptr, strides, dtype, B, Lq, Lk, H,
                KVH, D, causal, window, scale, stream);
}

// B7: dk, dv [B, Lk, KVH, D] from dO, lse and delta.
int mlapi_flash_backward_dkv(const void* q, const void* k, const void* v,
                             const void* mask, const void* dout,
                             const void* lse, const void* delta, void* dk,
                             void* dv, const long long* strides, int dtype,
                             int B, int Lq, int Lk, int H, int KVH, int D,
                             int causal, int window, float scale,
                             void* stream) {
  return launch(kDkv, q, k, v, mask, dout, nullptr, const_cast<void*>(lse),
                delta, nullptr, dk, dv, strides, dtype, B, Lq, Lk, H, KVH, D,
                causal, window, scale, stream);
}

}  // extern "C"
#endif  // MLAPI_UNIT <= 0
