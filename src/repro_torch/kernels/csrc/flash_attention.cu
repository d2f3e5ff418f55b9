// Flash attention for Hopper (sm_90a): forward (B2), backward dq (B3) and
// backward per-query-head dk / dv (B4), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/flash_attention.py:
//   fa_fwd      <- _fa_kernel          (flash_attention_fwd, :100 / :202)
//   fa_bwd_dq   <- _fa_bwd_dq_kernel   (flash_attention_bwd, :242 / :386)
//   fa_bwd_dkv  <- _fa_bwd_dkv_kernel  (flash_attention_bwd, :287 / :406)
//
// What they compute (q (B,Sq,Hq,hd), k/v (B,Sk,Hkv,hd), f32 or bf16, f32
// math; query head h reads KV head h / (Hq/Hkv); scale = hd^-0.5; a key is
// visible to a query when k_pos < Sk, k_pos <= q_pos if causal and
// k_pos > q_pos - window if window > 0):
//   fa_fwd     out = softmax(q k^T * scale) v by the online softmax, and
//              lse = m + log l per row (1e30 for a row that saw no key,
//              whose output is 0), plus the number of (q-tile, kv-tile)
//              pairs it executed, one int32 per block;
//   fa_bwd_dq  dq = sum over live kv tiles of ds k, with p = exp(s - lse),
//              dp = dO v^T, ds = p (dp - delta) * scale;
//   fa_bwd_dkv dk_h = sum over live q tiles of ds^T q, dv_h = p^T dO, per
//              QUERY head; the GQA group sum stays outside, in torch, in a
//              fixed order, as in the JAX package.
// delta = rowsum(dO * O) is computed outside (torch), as in the JAX package.
//
// Design.  One block of 256 threads (a 16 x 16 grid) per (q-tile, head,
// batch) for fa_fwd / fa_bwd_dq and per (kv-tile, head, batch) for
// fa_bwd_dkv; tiles are 64 x 64.  The block loops over the live tiles of
// the other axis: the TPU's pl.when(_tile_live) skip becomes the loop's
// bounds (lo / hi below, mirrored by _live_range in flash_attention.py and
// checked there against the predicate).  Operand tiles are staged in shared
// memory as f32 (row stride hd_pad + 1, so a column walk hits 16 distinct
// banks); each thread owns a 4 x 4 piece of the 64 x 64 score tile (rows
// ty + 16 i, columns tx + 16 j) and the same 4 rows of the accumulators
// (columns tx + 16 c), so a row's statistics (m, l) live in the registers of
// the 16 threads of one half-warp and are reduced with xor shuffles.
// Inputs are read in place through the (B, S, H, hd) layout: no transpose,
// no padding copy; the ragged edges (S not a multiple of 64, hd below its
// padded width 32 / 64 / 128) are masked in the kernel.
//
// Determinism: no atomics; every sum is taken in a fixed order, so two
// identical launches give identical bits (the engine's losslessness check
// is bitwise).
//
// Bound on an H100 SXM (the JAX package's roofline numerators,
// benchmarks/bench_kernels.py:66-74): forward 4 B Hq S^2 hd (x 1/2 causal)
// flops, the backward as a whole 2.5x that (five products: s and dp formed
// once, then dv, dk, dq); time bound = max(flops / 989 TFLOP/s (bf16 dense,
// tensor cores), bytes / 3.35 TB/s).  Split in two kernels as on the TPU,
// each must form s and dp itself: fa_bwd_dq alone does three products
// (1.5x the forward), fa_bwd_dkv four (2x), so the pair is held to 3.5x and
// the split costs 40 % over the backward's 2.5x.  chip_smoke.py reports
// each kernel against its own count and the pair against 2.5x.  At
// qwen2-0.5b's training shape (B 4, S 1024, Hq 14, hd 64, causal) the
// forward is 7.5 GFLOP, 7.6 us, operations-bound.  These kernels do not
// use the tensor cores (no wgmma, no TMA, no mma.sync): every product is an
// f32 FMA on the CUDA cores, whose peak is 67 TFLOP/s, and the 4 x 4
// register tiles read two shared memory words per FMA pair, so they run far
// from that bound.  That is the
// price of "simple and right first"; the time is written down in PERF.md.
// What the design does do about the bound: it skips dead tiles entirely
// (causal halves the work), never materialises the S x S matrices, reads
// each K / V tile once per q-tile (and each Q / dO tile once per kv-tile),
// and keeps every accumulator in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;       // query rows per tile
constexpr int BK = 64;       // key rows per tile
constexpr int NT = 256;      // threads per block, a 16 x 16 grid
constexpr float NEG = -1e30f;
constexpr float LSE_EMPTY = 1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Row `s` of head `h` of a contiguous (B, S, H, hd) tensor.
__device__ __forceinline__ int64_t row_off(int b, int s, int h, int S, int H,
                                           int hd) {
  return ((int64_t)b * S + s) * H * (int64_t)hd + (int64_t)h * hd;
}

// 64 rows [row0, row0 + 64) of head h into dst[64][HDP + 1] as f32; rows at
// or past S and columns at or past hd read as 0.
template <typename T, int HDP>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int b,
                                          int row0, int S, int H, int h,
                                          int hd) {
  for (int idx = threadIdx.x; idx < 64 * HDP; idx += NT) {
    const int r = idx / HDP, c = idx % HDP, s = row0 + r;
    float x = 0.f;
    if (s < S && c < hd) x = to_f(src[row_off(b, s, h, S, H, hd) + c]);
    dst[r * (HDP + 1) + c] = x;
  }
}

__device__ __forceinline__ bool visible(int q_pos, int k_pos, int Sk,
                                        int causal, int window) {
  bool ok = k_pos < Sk;
  if (causal) ok = ok && k_pos <= q_pos;
  if (window > 0) ok = ok && k_pos > q_pos - window;
  return ok;
}

// Sum / max over the 16 threads of a half-warp (fixed order).
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// Live kv tiles [lo, hi] of q-tile qi (fa_fwd, fa_bwd_dq).
__device__ __forceinline__ void kv_range(int qi, int nk, int causal,
                                         int window, int* lo, int* hi) {
  const int first_q = qi * BQ, last_q = first_q + BQ - 1;
  *hi = nk - 1;
  if (causal) *hi = min(*hi, last_q / BK);
  *lo = 0;
  if (window > 0) {
    const int x = first_q - window + 2 - BK;
    if (x > 0) *lo = (x + BK - 1) / BK;
  }
}

// Live q tiles [lo, hi] of kv-tile ki (fa_bwd_dkv).
__device__ __forceinline__ void q_range(int ki, int nq, int causal,
                                        int window, int* lo, int* hi) {
  const int first_k = ki * BK, last_k = first_k + BK - 1;
  *lo = 0;
  if (causal) {
    const int x = first_k - BQ + 1;
    if (x > 0) *lo = (x + BQ - 1) / BQ;
  }
  *hi = nq - 1;
  if (window > 0) *hi = min(*hi, (last_k + window - 1) / BQ);
}

// ------------------------------------------------------------------ B2
template <typename T, int HDP>
__global__ void __launch_bounds__(NT)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ out,
              float* __restrict__ lse, int* __restrict__ tiles, int Sq,
              int Sk, int Hq, int Hkv, int hd, int causal, int window,
              float scale) {
  constexpr int LD = HDP + 1, LDP = BK + 1, DC = HDP / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * LD;
  const int qi = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int first_q = qi * BQ;
  int lo, hi;
  kv_range(qi, (Sk + BK - 1) / BK, causal, window, &lo, &hi);

  load_tile<T, HDP>(Qs, q, b, first_q, Sq, Hq, h, hd);
  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int ki = lo; ki <= hi; ++ki) {
    __syncthreads();  // Qs written; last tile's Ks / Vs / Ps no longer read
    load_tile<T, HDP>(Ks, k, b, ki * BK, Sk, Hkv, hk, hd);
    load_tile<T, HDP>(Vs, v, b, ki * BK, Sk, Hkv, hk, hd);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < HDP; ++d) {
      float a[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], kb[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = first_q + ty + 16 * i;
      bool ok[4];
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ok[j] = visible(q_pos, ki * BK + tx + 16 * j, Sk, causal, window);
        s[i][j] *= scale;
        if (ok[j]) mx = fmaxf(mx, s[i][j]);
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        rs += p;
        Ps[(ty + 16 * i) * LDP + tx + 16 * j] = p;
      }
      rs = half_warp_sum(rs);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    for (int c = 0; c < BK; ++c) {
      float pv[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * LDP + c];
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) vv[cc] = Vs[c * LD + tx + 16 * cc];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int cc = 0; cc < DC; ++cc)
          acc[i][cc] = fmaf(pv[i], vv[cc], acc[i][cc]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = first_q + ty + 16 * i;
    if (row >= Sq) continue;
    const bool empty = l[i] == 0.f;
    T* o = out + row_off(b, row, h, Sq, Hq, hd);
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = tx + 16 * c;
      if (d < hd) o[d] = from_f<T>(empty ? 0.f : acc[i][c] / l[i]);
    }
    if (tx == 0)
      lse[((int64_t)b * Hq + h) * Sq + row] =
          empty ? LSE_EMPTY : m[i] + logf(l[i]);
  }
  if (threadIdx.x == 0)
    tiles[((int64_t)b * Hq + h) * gridDim.x + qi] = hi >= lo ? hi - lo + 1 : 0;
}

// ------------------------------------------------------------------ B3
template <typename T, int HDP>
__global__ void __launch_bounds__(NT)
fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dq, int Sq,
                 int Sk, int Hq, int Hkv, int hd, int causal, int window,
                 float scale) {
  constexpr int LD = HDP + 1, LDP = BK + 1, DC = HDP / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * LD;
  float* Ks = dOs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* DSs = Vs + BK * LD;
  const int qi = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int first_q = qi * BQ;
  int lo, hi;
  kv_range(qi, (Sk + BK - 1) / BK, causal, window, &lo, &hi);

  load_tile<T, HDP>(Qs, q, b, first_q, Sq, Hq, h, hd);
  load_tile<T, HDP>(dOs, dout, b, first_q, Sq, Hq, h, hd);
  float lse_r[4], delta_r[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = first_q + ty + 16 * i;
    const int64_t o = ((int64_t)b * Hq + h) * Sq + row;
    lse_r[i] = row < Sq ? lse[o] : LSE_EMPTY;
    delta_r[i] = row < Sq ? delta[o] : 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int ki = lo; ki <= hi; ++ki) {
    __syncthreads();
    load_tile<T, HDP>(Ks, k, b, ki * BK, Sk, Hkv, hk, hd);
    load_tile<T, HDP>(Vs, v, b, ki * BK, Sk, Hkv, hk, hd);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < HDP; ++d) {
      float a[4], o[4], kb[4], vb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = Qs[(ty + 16 * i) * LD + d];
        o[i] = dOs[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kb[j] = Ks[(tx + 16 * j) * LD + d];
        vb[j] = Vs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], kb[j], s[i][j]);
          dp[i][j] = fmaf(o[i], vb[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = first_q + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k_pos = ki * BK + tx + 16 * j;
        const bool ok = q_pos < Sq && visible(q_pos, k_pos, Sk, causal, window);
        const float p = ok ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        DSs[(ty + 16 * i) * LDP + tx + 16 * j] =
            p * (dp[i][j] - delta_r[i]) * scale;
      }
    }
    __syncthreads();

    for (int c = 0; c < BK; ++c) {
      float dsv[4], kv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = DSs[(ty + 16 * i) * LDP + c];
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) kv[cc] = Ks[c * LD + tx + 16 * cc];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int cc = 0; cc < DC; ++cc)
          acc[i][cc] = fmaf(dsv[i], kv[cc], acc[i][cc]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = first_q + ty + 16 * i;
    if (row >= Sq) continue;
    T* o = dq + row_off(b, row, h, Sq, Hq, hd);
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = tx + 16 * c;
      if (d < hd) o[d] = from_f<T>(acc[i][c]);
    }
  }
}

// ------------------------------------------------------------------ B4
template <typename T, int HDP>
__global__ void __launch_bounds__(NT)
fa_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dk_h,
                  T* __restrict__ dv_h, int Sq, int Sk, int Hq, int Hkv,
                  int hd, int causal, int window, float scale) {
  constexpr int LD = HDP + 1, LDT = BQ + 1, DC = HDP / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LD;
  float* dOs = Qs + BQ * LD;
  float* Pt = dOs + BQ * LD;
  float* DSt = Pt + BK * LDT;
  float* lse_s = DSt + BK * LDT;
  float* delta_s = lse_s + BQ;
  const int ki = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int first_k = ki * BK;
  int lo, hi;
  q_range(ki, (Sq + BQ - 1) / BQ, causal, window, &lo, &hi);

  load_tile<T, HDP>(Ks, k, b, first_k, Sk, Hkv, hk, hd);
  load_tile<T, HDP>(Vs, v, b, first_k, Sk, Hkv, hk, hd);
  float dk[4][DC], dv[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int qi = lo; qi <= hi; ++qi) {
    __syncthreads();
    load_tile<T, HDP>(Qs, q, b, qi * BQ, Sq, Hq, h, hd);
    load_tile<T, HDP>(dOs, dout, b, qi * BQ, Sq, Hq, h, hd);
    if (threadIdx.x < BQ) {
      const int row = qi * BQ + threadIdx.x;
      const int64_t o = ((int64_t)b * Hq + h) * Sq + row;
      lse_s[threadIdx.x] = row < Sq ? lse[o] : LSE_EMPTY;
      delta_s[threadIdx.x] = row < Sq ? delta[o] : 0.f;
    }
    __syncthreads();

    // transposed tile: rows are keys (ty + 16 i), columns queries (tx + 16 j)
    float st[4][4], dpt[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
    for (int d = 0; d < HDP; ++d) {
      float kb[4], vb[4], a[4], o[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kb[i] = Ks[(ty + 16 * i) * LD + d];
        vb[i] = Vs[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        a[j] = Qs[(tx + 16 * j) * LD + d];
        o[j] = dOs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          st[i][j] = fmaf(a[j], kb[i], st[i][j]);
          dpt[i][j] = fmaf(o[j], vb[i], dpt[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k_pos = first_k + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = tx + 16 * j, q_pos = qi * BQ + qc;
        const bool ok = q_pos < Sq && visible(q_pos, k_pos, Sk, causal, window);
        const float p = ok ? expf(st[i][j] * scale - lse_s[qc]) : 0.f;
        Pt[(ty + 16 * i) * LDT + qc] = p;
        DSt[(ty + 16 * i) * LDT + qc] = p * (dpt[i][j] - delta_s[qc]) * scale;
      }
    }
    __syncthreads();

    for (int c = 0; c < BQ; ++c) {
      float pv[4], dsv[4], ov[DC], qv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Pt[(ty + 16 * i) * LDT + c];
        dsv[i] = DSt[(ty + 16 * i) * LDT + c];
      }
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) {
        ov[cc] = dOs[c * LD + tx + 16 * cc];
        qv[cc] = Qs[c * LD + tx + 16 * cc];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int cc = 0; cc < DC; ++cc) {
          dv[i][cc] = fmaf(pv[i], ov[cc], dv[i][cc]);
          dk[i][cc] = fmaf(dsv[i], qv[cc], dk[i][cc]);
        }
    }
  }

  // per-query-head outputs, laid out (B, Sk, Hq, hd)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = first_k + ty + 16 * i;
    if (row >= Sk) continue;
    T* ok_ = dk_h + row_off(b, row, h, Sk, Hq, hd);
    T* ov_ = dv_h + row_off(b, row, h, Sk, Hq, hd);
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = tx + 16 * c;
      if (d < hd) {
        ok_[d] = from_f<T>(dk[i][c]);
        ov_[d] = from_f<T>(dv[i][c]);
      }
    }
  }
}

// ------------------------------------------------------------- launchers
template <int HDP>
constexpr size_t fwd_smem() {
  return sizeof(float) * ((BQ + 2 * BK) * (HDP + 1) + BQ * (BK + 1));
}
template <int HDP>
constexpr size_t dq_smem() {
  return sizeof(float) * ((2 * BQ + 2 * BK) * (HDP + 1) + BQ * (BK + 1));
}
template <int HDP>
constexpr size_t dkv_smem() {
  return sizeof(float) *
         ((2 * BK + 2 * BQ) * (HDP + 1) + 2 * BK * (BQ + 1) + 2 * BQ);
}

template <typename T, int HDP>
int launch_fwd(const void* q, const void* k, const void* v, void* out,
               void* lse, void* tiles, int B, int Sq, int Sk, int Hq,
               int Hkv, int hd, int causal, int window, float scale,
               cudaStream_t stream) {
  const size_t smem = fwd_smem<HDP>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_kernel<T, HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  fa_fwd_kernel<T, HDP><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, (float*)lse,
      (int*)tiles, Sq, Sk, Hq, Hkv, hd, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T, int HDP>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int Sq,
              int Sk, int Hq, int Hkv, int hd, int causal, int window,
              float scale, cudaStream_t stream) {
  const size_t smem = dq_smem<HDP>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_dq_kernel<T, HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  fa_bwd_dq_kernel<T, HDP><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dq, Sq, Sk, Hq, Hkv, hd,
      causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T, int HDP>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk_h, void* dv_h,
               int B, int Sq, int Sk, int Hq, int Hkv, int hd, int causal,
               int window, float scale, cudaStream_t stream) {
  const size_t smem = dkv_smem<HDP>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_dkv_kernel<T, HDP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sk + BK - 1) / BK, Hq, B);
  fa_bwd_dkv_kernel<T, HDP><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dk_h, (T*)dv_h, Sq, Sk, Hq,
      Hkv, hd, causal, window, scale);
  return (int)cudaGetLastError();
}

// hd <= 32 / 64 / 128 -> padded width 32 / 64 / 128; dtype 0 = f32, 1 = bf16
#define FA_DISPATCH(LAUNCH, ...)                                         \
  do {                                                                   \
    if (hd <= 0 || hd > 128 || (dtype != 0 && dtype != 1))               \
      return (int)cudaErrorInvalidValue;                                 \
    if (dtype == 0) {                                                    \
      if (hd <= 32) return LAUNCH<float, 32>(__VA_ARGS__);               \
      if (hd <= 64) return LAUNCH<float, 64>(__VA_ARGS__);               \
      return LAUNCH<float, 128>(__VA_ARGS__);                            \
    }                                                                    \
    if (hd <= 32) return LAUNCH<__nv_bfloat16, 32>(__VA_ARGS__);         \
    if (hd <= 64) return LAUNCH<__nv_bfloat16, 64>(__VA_ARGS__);         \
    return LAUNCH<__nv_bfloat16, 128>(__VA_ARGS__);                      \
  } while (0)

}  // namespace

extern "C" {

// Tile sizes, for the wrapper's tile accounting.
int fa_block_q() { return BQ; }
int fa_block_k() { return BK; }

// out (B,Sq,Hq,hd) in the input dtype, lse (B,Hq,Sq) f32, tiles
// (B,Hq,ceil(Sq/64)) int32.  Returns cudaGetLastError() after the launch.
int fa_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
           void* tiles, int dtype, int B, int Sq, int Sk, int Hq, int Hkv,
           int hd, int causal, int window, float scale, void* stream) {
  FA_DISPATCH(launch_fwd, q, k, v, out, lse, tiles, B, Sq, Sk, Hq, Hkv, hd,
              causal, window, scale, (cudaStream_t)stream);
}

// dq (B,Sq,Hq,hd) in the input dtype.
int fa_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int dtype, int B,
              int Sq, int Sk, int Hq, int Hkv, int hd, int causal, int window,
              float scale, void* stream) {
  FA_DISPATCH(launch_dq, q, k, v, dout, lse, delta, dq, B, Sq, Sk, Hq, Hkv,
              hd, causal, window, scale, (cudaStream_t)stream);
}

// dk_h, dv_h (B,Sk,Hq,hd) per query head, in the input dtype.
int fa_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk_h, void* dv_h,
               int dtype, int B, int Sq, int Sk, int Hq, int Hkv, int hd,
               int causal, int window, float scale, void* stream) {
  FA_DISPATCH(launch_dkv, q, k, v, dout, lse, delta, dk_h, dv_h, B, Sq, Sk,
              Hq, Hkv, hd, causal, window, scale, (cudaStream_t)stream);
}

}  // extern "C"
