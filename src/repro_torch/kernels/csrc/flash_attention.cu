// Flash attention for Hopper (sm_90a): forward (B2), backward dq (B3) and
// backward per-query-head dk / dv (B4), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/flash_attention.py:
//   fa_fwd_tc      <- _fa_kernel         (flash_attention_fwd, :100 / :202), bf16
//   fa_fwd         <- _fa_kernel         (the same function), f32
//   fa_bwd_dq_tc   <- _fa_bwd_dq_kernel  (flash_attention_bwd, :242 / :386), bf16
//   fa_bwd_dq      <- _fa_bwd_dq_kernel  (the same function), f32
//   fa_bwd_dkv_tc  <- _fa_bwd_dkv_kernel (flash_attention_bwd, :287 / :406), bf16
//   fa_bwd_dkv     <- _fa_bwd_dkv_kernel (the same function), f32
//
// What they compute (q (B,Sq,Hq,hd), k/v (B,Sk,Hkv,hd), f32 or bf16, f32
// math; query head h reads KV head h / (Hq/Hkv); scale = hd^-0.5; a key is
// visible to a query when k_pos < Sk, k_pos <= q_pos if causal and
// k_pos > q_pos - window if window > 0):
//   fa_fwd(_tc) out = softmax(q k^T * scale) v by the online softmax, and
//              lse = m + log l per row (1e30 for a row that saw no key,
//              whose output is 0), plus the number of (q-tile, kv-tile)
//              pairs it executed, one int32 per block; in bf16 the
//              probabilities are rounded to bf16 before p v (l sums the f32
//              probabilities), as the TPU's matrix unit and SDPA do;
//   fa_bwd_dq  dq = sum over live kv tiles of ds k, with p = exp(s - lse),
//              dp = dO v^T, ds = p (dp - delta) * scale;
//   fa_bwd_dkv dk_h = sum over live q tiles of ds^T q, dv_h = p^T dO, per
//              QUERY head; the GQA group sum stays outside, in torch, in a
//              fixed order, as in the JAX package.
//   In bf16 the backward (the _tc kernels) rounds p and ds to bf16 before
//   the products dv, dk and dq, as the library's flash backward does.
// delta = rowsum(dO * O) is computed outside (torch), as in the JAX package.
//
// Bound on an H100 SXM (the JAX package's roofline numerators,
// benchmarks/bench_kernels.py:66-74): forward 4 B Hq S^2 hd (x 1/2 causal)
// flops, the backward as a whole 2.5x that (five products: s and dp formed
// once, then dv, dk, dq); time bound = max(flops / 989 TFLOP/s (bf16 dense,
// tensor cores), bytes / 3.35 TB/s).  At qwen2-0.5b's training shape (B 4,
// S 1024, Hq 14, Hkv 2, hd 64, causal, bf16) the forward is 7.52 GFLOP over
// 989 TFLOP/s = 0.0076 ms, bound by operations: only the tensor cores can
// approach it.
//
// B2 in bf16, fa_fwd_tc_kernel: what the design does about that bound.
// One block per (q-tile of 128 rows, head, batch), two consumer warpgroups
// of 64 rows each, 256 threads; under causal masking the q-tiles are
// launched heaviest first (the q-tile is the grid's slowest axis, taken in
// reverse), so the short tiles of the causal tail fill the last wave.
// Q, K and V arrive by TMA, read in place from the (B, S, H, hd) layouts
// through 4-D tensor maps over (hd, H, S, B) with boxes (64, 1, rows, 1):
// 64 bf16 columns are one 128-byte swizzle row, so a tile is NCB = 1, 2 or
// 4 boxes (hd <= 64, <= 128, <= 256); TMA's zero fill covers S past its end
// and the columns past hd (hd 80: columns 80-127 of the second box), and
// the epilogues store no column at or past hd.  At hd 256 the tiles
// shrink to fit a block's 227 KB and the registers (see tc_bk below).  Q is loaded once; K / V tiles of 128 keys go through a
// ring of 2 stages with a full and an empty mbarrier each.  The loads are
// issued by one elected consumer thread (thread 0), not by a producer
// warp: with 256 threads each thread may hold 255 registers without
// setmaxnreg rebalancing, there is no role split to keep apart, and the
// next tile's loads are in flight while the current one is computed.
// S = Q K^T is a wgmma m64n128k16 (bf16 -> f32) per 16 columns of hd, both
// operands read from shared memory through 128-byte-swizzle descriptors.
// The online softmax runs on the accumulator fragment: the scale times
// log2(e) folded into one FMA before ex2.approx, masked only on tiles that
// cross the causal diagonal, the window's edge or Sk, the row max and row
// sum reduced with xor shuffles over the four threads of a quad that share
// a row, l summed from the f32 probabilities.  O += P V is a wgmma
// m64n64k16 per 16 keys and per 64 columns of hd, with P converted to bf16
// in registers as the A operand (the accumulator layout of S is the
// register layout of A) and V the B operand from shared memory, N-major,
// through the transpose bit; O is rescaled by alpha in registers.  Only
// out, lse and the tile count are written to device memory.
//
// B3 and B4 in bf16, fa_bwd_dq_tc_kernel / fa_bwd_dkv_tc_kernel: the split
// of the TPU kernels is kept (each block owns its output: no atomics, no
// partial dq summed across blocks), on B2's machinery: TMA maps over (hd,
// H, S, B), a 2-stage mbarrier ring, 128-byte-swizzle descriptors, two
// consumer warpgroups of 64 rows, loads issued by thread 0.  Each of the
// five products is one wgmma form: S = Q K^T and dP = dO V^T (B3), S^T =
// K Q^T and dP^T = V dO^T (B4) with both operands K-major in shared
// memory; dQ += dS K, dV += P^T dO and dK += dS^T Q with the A operand
// from registers (the accumulator layout of S / S^T is the A layout, so
// P and dS are packed to bf16 in place) and B N-major through the
// transpose bit, the same K / Q / dO tile read through a second
// descriptor.  B3 takes a q-tile of 128 rows and walks K / V tiles of 128
// keys (heaviest q-tiles first under causal masking), B4 a kv-tile of 128
// keys and walks Q / dO tiles of 64 rows (m64n64 products: four 128-row
// accumulators at hd 128 would not fit in 255 registers); P = 2^(s scale
// log2(e) - lse log2(e)) by one FMA, masked with -inf only on edge tiles,
// the rows' lse / delta (B3) or the columns' (B4, 16 per thread, guarded
// plain loads: TMA cannot map a ragged (B, Hq, Sq) f32 row) read into
// registers, a row past Sq read as LSE_EMPTY / 0.  scale multiplies dq
// and dk once, in the epilogue.  The products run in series (commit, then
// wait) within a warpgroup; the other warpgroup and the next tile's loads
// overlap them.  Split in two, the pair does 3.5x the forward's flops
// (s and dp formed in each) against the backward's 2.5x.
//
// B3, B4 and B2 in f32: one block of 256 threads (a 16 x 16 grid) per
// (q-tile, head, batch) for fa_fwd / fa_bwd_dq and per (kv-tile, head,
// batch) for fa_bwd_dkv; tiles are 64 x 64 (fa_bwd_dkv's query tiles 32
// rows above hd 128, and fa_bwd_dq's K and V share one buffer there: f32
// tiles of 256 columns would pass 227 KB); hd is padded to 32, 64, 128 or
// 256 columns.  The block loops over the live
// tiles of the other axis: the TPU's pl.when(_tile_live) skip becomes the
// loop's bounds (lo / hi below, mirrored by _live_range in
// flash_attention.py and checked there against the predicate).  Operand
// tiles are staged in shared memory as f32 (row stride hd_pad + 1, so a
// column walk hits 16 distinct banks); each thread owns a 4 x 4 piece of
// the 64 x 64 score tile (rows ty + 16 i, columns tx + 16 j) and the same 4
// rows of the accumulators (columns tx + 16 c), so a row's statistics (m,
// l) live in the registers of the 16 threads of one half-warp and are
// reduced with xor shuffles.  Inputs are read in place through the (B, S,
// H, hd) layout; the ragged edges are masked in the kernel.  These f32
// kernels do not use the tensor cores (no wgmma, no TMA, not even
// mma.sync): every product is an f32 FMA on the CUDA cores, whose peak is
// 67 TFLOP/s, and the 4 x 4 register tiles read two shared memory words
// per FMA pair, so they run far from the bound.  Split in two kernels as
// on the TPU, the backward must form s and dp in each: fa_bwd_dq alone
// does three products (1.5x the forward), fa_bwd_dkv four (2x), so the
// pair is held to 3.5x and the split costs 40 % over the backward's 2.5x.
// chip_smoke.py reports each kernel against its own count and the pair
// against 2.5x.  What every design here does about the bound: skip dead
// tiles entirely (causal halves the work), never materialise the S x S
// matrices, read each K / V tile once per q-tile (and each Q / dO tile
// once per kv-tile), and keep every accumulator in registers.
//
// Determinism: no atomics; every sum is taken in a fixed order, so two
// identical launches give identical bits (the engine's losslessness check
// is bitwise).

#include <cuda.h>  // CUtensorMap, the driver's enums: header only, no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;       // query rows per tile
constexpr int BK = 64;       // key rows per tile
constexpr int NT = 256;      // threads per block, a 16 x 16 grid
constexpr float NEG = -1e30f;
constexpr float LSE_EMPTY = 1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}

// Row `s` of head `h` of a contiguous (B, S, H, hd) tensor.
__device__ __forceinline__ int64_t row_off(int b, int s, int h, int S, int H,
                                           int hd) {
  return ((int64_t)b * S + s) * H * (int64_t)hd + (int64_t)h * hd;
}

// ROWS rows [row0, row0 + ROWS) of head h into dst[ROWS][HDP + 1] as f32;
// rows at or past S and columns at or past hd read as 0.
template <typename T, int HDP, int ROWS = 64>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int b,
                                          int row0, int S, int H, int h,
                                          int hd) {
  for (int idx = threadIdx.x; idx < ROWS * HDP; idx += NT) {
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

// Live kv tiles [lo, hi] of q-tile qi for TQ x TK tiles (fa_fwd,
// fa_bwd_dq: 64 x 64; fa_fwd_tc: 128 x 128).
template <int TQ = BQ, int TK = BK>
__device__ __forceinline__ void kv_range(int qi, int nk, int causal,
                                         int window, int* lo, int* hi) {
  const int first_q = qi * TQ, last_q = first_q + TQ - 1;
  *hi = nk - 1;
  if (causal) *hi = min(*hi, last_q / TK);
  *lo = 0;
  if (window > 0) {
    const int x = first_q - window + 2 - TK;
    if (x > 0) *lo = (x + TK - 1) / TK;
  }
}

// Live q tiles [lo, hi] of kv-tile ki for TQ x TK tiles (fa_bwd_dkv:
// 64 x 64; fa_bwd_dkv_tc: 64 x 128).
template <int TQ = BQ, int TK = BK>
__device__ __forceinline__ void q_range(int ki, int nq, int causal,
                                        int window, int* lo, int* hi) {
  const int first_k = ki * TK, last_k = first_k + TK - 1;
  *lo = 0;
  if (causal) {
    const int x = first_k - TQ + 1;
    if (x > 0) *lo = (x + TQ - 1) / TQ;
  }
  *hi = nq - 1;
  if (window > 0) *hi = min(*hi, (last_k + window - 1) / TQ);
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
  if (threadIdx.x == 0 && tiles != nullptr)
    tiles[((int64_t)b * Hq + h) * gridDim.x + qi] = hi >= lo ? hi - lo + 1 : 0;
}

// ------------------------------------------------- B2, bf16, tensor cores
constexpr int TC_BQ = 128;      // query rows per block: two warpgroups of 64
constexpr int TC_BK = 128;      // keys per K / V tile up to hd 128
constexpr int TC_BK_WIDE = 64;  // ... and at hd 256 (NCB 4)
constexpr int TC_STAGES = 2;    // tile ring depth (K / V; B4: Q / dO)
constexpr int TC_NT = 256;      // two consumer warpgroups
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// The tiles by NCB, the 64-column blocks of the padded head dim (hd <= 64:
// 1, <= 128: 2, <= 256: 4).  At NCB 4 a 128-key K / V tile is 64 KB and
// B2's O accumulator alone is 128 registers a thread, so:
//   B2 (fa_fwd_tc)     K / V tiles of 64 keys: Q 64 KB + a ring of 2 x
//                      (K + V) 128 KB; S is m64n64 (32 registers);
//   B3 (fa_bwd_dq_tc)  K / V tiles of 64 keys in a ring of one stage: Q +
//                      dO 128 KB + K + V 64 KB (two stages would need 256);
//   B4 (fa_bwd_dkv_tc) a block of 64 keys whose two warpgroups split the
//                      outputs: warpgroup 0 forms S^T, P^T and dV += P^T
//                      dO, warpgroup 1 S^T, dP^T, dS^T and dK += dS^T Q
//                      (either one holds a 64 x 256 accumulator, 128
//                      registers; both would need 256); K + V 64 KB, the
//                      Q / dO ring 128 KB.  S^T is formed twice.
// Each block still owns its outputs and sums in a fixed order.
__host__ __device__ constexpr int tc_bk(int ncb) {
  return ncb > 2 ? TC_BK_WIDE : TC_BK;
}
__host__ __device__ constexpr int dq_stages(int ncb) {
  return ncb > 2 ? 1 : TC_STAGES;
}
__host__ __device__ constexpr int dkv_keys(int ncb) {   // B4 keys per block
  return ncb > 2 ? 64 : TC_BK;
}

// The tile ring's barriers at bar_s: full[st] = bar_s + 8 st (one arrival,
// the expect_tx of the thread that loads the stage) and empty[st] = bar_s +
// 8 (STAGES + st) (all TC_NT threads), and `once` (one arrival) for the
// tiles loaded once.  Thread 0 initialises them; every thread returns after
// the block has synchronised.
template <int STAGES>
__device__ __forceinline__ void ring_init(uint32_t bar_s, uint32_t once) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(bar_s + 8 * st, 1);
      mbar_init(bar_s + 8 * (STAGES + st), TC_NT);
    }
    mbar_init(once, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// 2^x on the special-function unit (inputs below -126 give 0, -inf gives 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// S (64 x N keys, f32) += A B with both operands K-major in shared memory:
// m64n128 for 128-key tiles, m64n64 for 64-key ones (the same accumulator
// map over N columns)
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db) {
  wgmma_ss_n128(d, da, db);
}
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db) {
  wgmma_ss_n64(d, da, db);
}

template <int NCB>
__host__ __device__ constexpr int tc_q_bytes() { return NCB * TC_BQ * SW_ROW; }
template <int NCB, int ROWS>
__host__ __device__ constexpr int tc_tile_bytes() {  // one K, V, Q or dO tile
  return NCB * ROWS * SW_ROW;
}
template <int NCB>
constexpr size_t tc_fwd_smem() {   // + 1024 to align the tiles by hand
  return 1024 + tc_q_bytes<NCB>() +
         2 * TC_STAGES * tc_tile_bytes<NCB, tc_bk(NCB)>() +
         8 * (2 * TC_STAGES + 1);
}

template <int NCB>
__global__ void __launch_bounds__(TC_NT, 1)
fa_fwd_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                 int* __restrict__ tiles, int Sq, int Sk, int Hq, int Hkv,
                 int hd, int causal, int window, float scale_log2) {
  constexpr int BK = tc_bk(NCB);    // keys per K / V tile
  constexpr int QB = tc_q_bytes<NCB>(), KVB = tc_tile_bytes<NCB, BK>();
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: tiles start on it
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t q_s = raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t kv_s = q_s + QB;   // stage st: K at kv_s + 2 st KVB, V after
  const uint32_t bar_s = kv_s + 2 * TC_STAGES * KVB;
  // full[st] = bar_s + 8 st, empty[st] = bar_s + 8 (TC_STAGES + st)
  const uint32_t q_bar = bar_s + 16 * TC_STAGES;

  const int h = blockIdx.x, b = blockIdx.y, nq = gridDim.z;
  const int qi = causal ? nq - 1 - (int)blockIdx.z : (int)blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int first_q = qi * TC_BQ, wg_q = first_q + 64 * wg;
  int lo, hi;
  kv_range<TC_BQ, BK>(qi, (Sk + BK - 1) / BK, causal, window, &lo, &hi);
  const int n_tiles = hi >= lo ? hi - lo + 1 : 0;

  auto load_kv = [&](int i) {     // tile lo + i into stage i % TC_STAGES
    const int st = i % TC_STAGES, row0 = (lo + i) * BK;
    const uint32_t full = bar_s + 8 * st, k_dst = kv_s + 2 * st * KVB;
    mbar_expect_tx(full, 2 * KVB);
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb) {
      tma_load_4d(k_dst + cb * BK * SW_ROW, &tm_k, full, 64 * cb, hk, row0,
                  b);
      tma_load_4d(k_dst + KVB + cb * BK * SW_ROW, &tm_v, full, 64 * cb, hk,
                  row0, b);
    }
  };

  ring_init<TC_STAGES>(bar_s, q_bar);
  if (tid == 0) {
    mbar_expect_tx(q_bar, QB);
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb)
      tma_load_4d(q_s + cb * TC_BQ * SW_ROW, &tm_q, q_bar, 64 * cb, h,
                  first_q, b);
    for (int i = 0; i < TC_STAGES && i < n_tiles; ++i) load_kv(i);
  }

  // this thread's rows of the block: r0 and r0 + 8
  const int r0 = wg_q + 16 * warp + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  float o[NCB][32];
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[cb][i] = 0.f;
  float m_r[2] = {NEG, NEG}, l_r[2] = {0.f, 0.f};
  const uint32_t q_wg = q_s + wg * 64 * SW_ROW;

  mbar_wait(q_bar, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % TC_STAGES, ki = lo + i;
    const uint32_t phase = (i / TC_STAGES) & 1;
    const uint32_t k_t = kv_s + 2 * st * KVB, v_t = k_t + KVB;
    mbar_wait(bar_s + 8 * st, phase);

    // S = Q K^T over hd in steps of 16 (32 bytes of a swizzle row)
    float s[BK / 2];
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) s[j] = 0.f;
    wg_fence();
#pragma unroll
    for (int t = 0; t < 4 * NCB; ++t)
      wgmma_ss(s, sw128_desc(q_wg + (t >> 2) * TC_BQ * SW_ROW + (t & 3) * 32),
               sw128_desc(k_t + (t >> 2) * BK * SW_ROW + (t & 3) * 32));
    wg_commit();
    wg_wait_all();
    reg_fence(s);

    // online softmax on the fragment: m in log2 units (m = max(s) scale
    // log2(e), the scale positive), p = 2^(s scale log2(e) - m) by one FMA
    const int k0 = ki * BK;
    const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > wg_q) ||
                      (window > 0 && k0 <= wg_q + 63 - window);
    if (edge) {
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        const int r = r0 + 8 * ((j >> 1) & 1);
        const int c = k0 + 8 * (j >> 2) + c0 + (j & 1);
        if (!visible(r, c, Sk, causal, window))
          s[j] = __uint_as_float(0xff800000u);   // -inf
      }
    }
    float mx[2] = {__uint_as_float(0xff800000u), __uint_as_float(0xff800000u)};
#pragma unroll
    for (int j = 0; j < BK / 2; ++j)
      mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], s[j]);
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 1));
      mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 2));
      const float m_new = fmaxf(m_r[x], mx[x] * scale_log2);
      alpha[x] = ex2(m_r[x] - m_new);
      m_r[x] = m_new;
    }
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {   // masked: 2^-inf = 0
      s[j] = ex2(fmaf(s[j], scale_log2, -m_r[(j >> 1) & 1]));
      rs[(j >> 1) & 1] += s[j];
    }
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      rs[x] += __shfl_xor_sync(0xffffffffu, rs[x], 1);
      rs[x] += __shfl_xor_sync(0xffffffffu, rs[x], 2);
      l_r[x] = alpha[x] * l_r[x] + rs[x];
    }
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
      for (int j = 0; j < 32; ++j) o[cb][j] *= alpha[(j >> 1) & 1];

    // P as bf16 A fragments: keys 16 t .. 16 t + 15 are S's columns 8 (2t)
    // and 8 (2t + 1), registers 8 t .. 8 t + 7
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int t = 0; t < BK / 16; ++t)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        pa[t][x] = pack_bf16(s[8 * t + 2 * x], s[8 * t + 2 * x + 1]);

    // O += P V over the tile's keys in steps of 16 (16 swizzle rows)
    wg_fence();
#pragma unroll
    for (int t = 0; t < BK / 16; ++t)
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb)
        wgmma_rs_n64(o[cb], pa[t],
                     sw128_desc(v_t + cb * BK * SW_ROW + t * 16 * SW_ROW));
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb) reg_fence(o[cb]);

    // release the stage; thread 0 refills it once all 256 threads have
    mbar_arrive(bar_s + 8 * (TC_STAGES + st));
    if (tid == 0 && i + TC_STAGES < n_tiles) {
      mbar_wait(bar_s + 8 * (TC_STAGES + st), phase);
      load_kv(i + TC_STAGES);
    }
    __syncwarp();
  }

  // epilogue: out = O / l (0 for a row that saw no key), lse, tile count;
  // columns at or past hd (zero-filled by TMA) are not stored
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int row = r0 + 8 * x;
    if (row >= Sq) continue;
    const bool empty = l_r[x] == 0.f;
    __nv_bfloat16* o_row = out + row_off(b, row, h, Sq, Hq, hd);
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * cb + 8 * j + c0;
        if (col < hd) {
          const float a = empty ? 0.f : o[cb][4 * j + 2 * x] / l_r[x];
          const float c = empty ? 0.f : o[cb][4 * j + 2 * x + 1] / l_r[x];
          *reinterpret_cast<__nv_bfloat162*>(o_row + col) =
              __floats2bfloat162_rn(a, c);
        }
      }
    if ((lane & 3) == 0)
      lse[((int64_t)b * Hq + h) * Sq + row] =
          empty ? LSE_EMPTY : m_r[x] * LN2 + logf(l_r[x]);
  }
  if (tid == 0 && tiles != nullptr)
    tiles[((int64_t)b * Hq + h) * nq + qi] = n_tiles;
}

// ------------------------------------------ B3 and B4, bf16, tensor cores
constexpr int DKV_BQ = 64;      // fa_bwd_dkv_tc: query rows per Q / dO tile

template <int NCB>
constexpr size_t tc_dq_smem() {
  return 1024 + 2 * tc_q_bytes<NCB>() +
         2 * dq_stages(NCB) * tc_tile_bytes<NCB, tc_bk(NCB)>() +
         8 * (2 * dq_stages(NCB) + 1);
}
template <int NCB>
constexpr size_t tc_dkv_smem() {
  return 1024 + 2 * tc_tile_bytes<NCB, dkv_keys(NCB)>() +
         2 * TC_STAGES * tc_tile_bytes<NCB, DKV_BQ>() +
         8 * (2 * TC_STAGES + 1);
}

// B3: one block per (q-tile of 128 rows, head, batch), q-tiles heaviest
// first under causal masking; Q and dO by TMA once, K / V tiles of BK keys
// through the ring.  Per tile S = Q K^T and dP = dO V^T (both operands
// K-major), P = 2^(S scale log2(e) - lse log2(e)), dS = P (dP - delta),
// then dQ += dS K with dS packed to bf16 A fragments and K the N-major B
// operand (B2's V path).  dq = scale dQ.
template <int NCB>
__global__ void __launch_bounds__(TC_NT, 1)
fa_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int Sq, int Sk, int Hq,
                    int Hkv, int hd, int causal, int window, float scale,
                    float scale_log2) {
  constexpr int BK = tc_bk(NCB), STAGES = dq_stages(NCB);
  constexpr int QB = tc_q_bytes<NCB>(), KVB = tc_tile_bytes<NCB, BK>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t q_s = raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t do_s = q_s + QB;
  const uint32_t kv_s = do_s + QB;  // stage st: K at kv_s + 2 st KVB, V after
  const uint32_t bar_s = kv_s + 2 * STAGES * KVB;
  // full[st] = bar_s + 8 st, empty[st] = bar_s + 8 (STAGES + st)
  const uint32_t q_bar = bar_s + 16 * STAGES;

  const int h = blockIdx.x, b = blockIdx.y, nq = gridDim.z;
  const int qi = causal ? nq - 1 - (int)blockIdx.z : (int)blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int first_q = qi * TC_BQ, wg_q = first_q + 64 * wg;
  int lo, hi;
  kv_range<TC_BQ, BK>(qi, (Sk + BK - 1) / BK, causal, window, &lo, &hi);
  const int n_tiles = hi >= lo ? hi - lo + 1 : 0;

  auto load_kv = [&](int i) {     // tile lo + i into stage i % STAGES
    const int st = i % STAGES, row0 = (lo + i) * BK;
    const uint32_t full = bar_s + 8 * st, k_dst = kv_s + 2 * st * KVB;
    mbar_expect_tx(full, 2 * KVB);
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb) {
      tma_load_4d(k_dst + cb * BK * SW_ROW, &tm_k, full, 64 * cb, hk, row0,
                  b);
      tma_load_4d(k_dst + KVB + cb * BK * SW_ROW, &tm_v, full, 64 * cb, hk,
                  row0, b);
    }
  };

  ring_init<STAGES>(bar_s, q_bar);
  if (tid == 0) {
    mbar_expect_tx(q_bar, 2 * QB);
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb) {
      tma_load_4d(q_s + cb * TC_BQ * SW_ROW, &tm_q, q_bar, 64 * cb, h,
                  first_q, b);
      tma_load_4d(do_s + cb * TC_BQ * SW_ROW, &tm_do, q_bar, 64 * cb, h,
                  first_q, b);
    }
    for (int i = 0; i < STAGES && i < n_tiles; ++i) load_kv(i);
  }

  // this thread's rows r0 and r0 + 8: lse in log2 units and delta, read
  // once; a row past Sq reads as one that saw no key (2^-huge = 0)
  const int r0 = wg_q + 16 * warp + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  float lse2[2], dlt[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int row = r0 + 8 * x;
    const int64_t o = ((int64_t)b * Hq + h) * Sq + row;
    lse2[x] = (row < Sq ? lse[o] : LSE_EMPTY) * LOG2E;
    dlt[x] = row < Sq ? delta[o] : 0.f;
  }
  float acc[NCB][32];
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[cb][i] = 0.f;
  const uint32_t q_wg = q_s + wg * 64 * SW_ROW, do_wg = do_s + wg * 64 * SW_ROW;

  mbar_wait(q_bar, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % STAGES, ki = lo + i;
    const uint32_t phase = (i / STAGES) & 1;
    const uint32_t k_t = kv_s + 2 * st * KVB, v_t = k_t + KVB;
    mbar_wait(bar_s + 8 * st, phase);

    // S = Q K^T and dP = dO V^T over hd in steps of 16, one commit group
    float s[BK / 2], dp[BK / 2];
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) s[j] = dp[j] = 0.f;
    wg_fence();
#pragma unroll
    for (int t = 0; t < 4 * NCB; ++t)
      wgmma_ss(s, sw128_desc(q_wg + (t >> 2) * TC_BQ * SW_ROW + (t & 3) * 32),
               sw128_desc(k_t + (t >> 2) * BK * SW_ROW + (t & 3) * 32));
#pragma unroll
    for (int t = 0; t < 4 * NCB; ++t)
      wgmma_ss(dp,
               sw128_desc(do_wg + (t >> 2) * TC_BQ * SW_ROW + (t & 3) * 32),
               sw128_desc(v_t + (t >> 2) * BK * SW_ROW + (t & 3) * 32));
    wg_commit();
    wg_wait_all();
    reg_fence(s);
    reg_fence(dp);

    const int k0 = ki * BK;
    const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > wg_q) ||
                      (window > 0 && k0 <= wg_q + 63 - window);
    if (edge) {
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        const int r = r0 + 8 * ((j >> 1) & 1);
        const int c = k0 + 8 * (j >> 2) + c0 + (j & 1);
        if (!visible(r, c, Sk, causal, window))
          s[j] = __uint_as_float(0xff800000u);   // -inf
      }
    }
    // dS = P (dP - delta) with P = 2^(s scale log2(e) - lse log2(e)) by
    // one FMA (masked: 2^-inf = 0), packed as bf16 A fragments in place:
    // keys 16 t .. 16 t + 15 are registers 8 t .. 8 t + 7
    uint32_t da[BK / 16][4];
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const int x = (j >> 1) & 1;
      s[j] = ex2(fmaf(s[j], scale_log2, -lse2[x])) * (dp[j] - dlt[x]);
    }
#pragma unroll
    for (int t = 0; t < BK / 16; ++t)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        da[t][x] = pack_bf16(s[8 * t + 2 * x], s[8 * t + 2 * x + 1]);

    // dQ += dS K over the tile's keys in steps of 16: K N-major
    wg_fence();
#pragma unroll
    for (int t = 0; t < BK / 16; ++t)
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb)
        wgmma_rs_n64(acc[cb], da[t],
                     sw128_desc(k_t + cb * BK * SW_ROW + t * 16 * SW_ROW));
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb) reg_fence(acc[cb]);

    // release the stage; thread 0 refills it once all 256 threads have
    mbar_arrive(bar_s + 8 * (STAGES + st));
    if (tid == 0 && i + STAGES < n_tiles) {
      mbar_wait(bar_s + 8 * (STAGES + st), phase);
      load_kv(i + STAGES);
    }
    __syncwarp();
  }

#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int row = r0 + 8 * x;
    if (row >= Sq) continue;
    __nv_bfloat16* o_row = dq + row_off(b, row, h, Sq, Hq, hd);
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * cb + 8 * j + c0;
        if (col < hd)
          *reinterpret_cast<__nv_bfloat162*>(o_row + col) =
              __floats2bfloat162_rn(scale * acc[cb][4 * j + 2 * x],
                                    scale * acc[cb][4 * j + 2 * x + 1]);
      }
  }
}

// B4: one block per (kv-tile of TK keys, query head, batch); under causal
// masking the first kv-tiles are the heaviest and are launched first.  K
// and V by TMA once, Q / dO tiles of 64 rows through the ring.  The
// transposed form keeps every A operand in shared memory or registers:
// S^T = K Q^T and dP^T = V dO^T (m64n64, both K-major), P^T = 2^(S^T scale
// log2(e) - lse_col log2(e)), dS^T = P^T (dP^T - delta_col), dV += P^T dO
// and dK += dS^T Q with P^T / dS^T as bf16 A fragments and dO / Q the
// N-major B operand (the same dO and Q tiles as above, read through another
// descriptor).  dk_h = scale dK.  Up to hd 128 (TK 128) each warpgroup
// owns 64 keys and both of their outputs; at hd 256 (SPLIT, TK 64) both
// warpgroups take the block's 64 keys, warpgroup 0 forming dV and
// warpgroup 1 dK (see tc_bk above).
template <int NCB>
__global__ void __launch_bounds__(TC_NT, 1)
fa_bwd_dkv_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk_h,
                     __nv_bfloat16* __restrict__ dv_h, int Sq, int Sk,
                     int Hq, int Hkv, int hd, int causal, int window,
                     float scale, float scale_log2) {
  constexpr bool SPLIT = NCB > 2;
  constexpr int TK = dkv_keys(NCB);
  constexpr int KVB = tc_tile_bytes<NCB, TK>();
  constexpr int QTB = tc_tile_bytes<NCB, DKV_BQ>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t k_s = raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t v_s = k_s + KVB;
  const uint32_t ring = v_s + KVB;  // stage st: Q at ring + 2 st QTB, dO after
  const uint32_t bar_s = ring + 2 * TC_STAGES * QTB;
  // full[st] = bar_s + 8 st, empty[st] = bar_s + 8 (TC_STAGES + st)
  const uint32_t kv_bar = bar_s + 16 * TC_STAGES;

  const int h = blockIdx.x, b = blockIdx.y, ki = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int first_k = ki * TK, wg_k = first_k + (SPLIT ? 0 : 64 * wg);
  // which outputs this warpgroup forms
  const bool want_dv = !SPLIT || wg == 0, want_dk = !SPLIT || wg == 1;
  int lo, hi;
  q_range<DKV_BQ, TK>(ki, (Sq + DKV_BQ - 1) / DKV_BQ, causal, window, &lo,
                      &hi);
  const int n_tiles = hi >= lo ? hi - lo + 1 : 0;

  auto load_q = [&](int i) {      // q-tile lo + i into stage i % TC_STAGES
    const int st = i % TC_STAGES, row0 = (lo + i) * DKV_BQ;
    const uint32_t full = bar_s + 8 * st, q_dst = ring + 2 * st * QTB;
    mbar_expect_tx(full, 2 * QTB);
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb) {
      tma_load_4d(q_dst + cb * DKV_BQ * SW_ROW, &tm_q, full, 64 * cb, h,
                  row0, b);
      tma_load_4d(q_dst + QTB + cb * DKV_BQ * SW_ROW, &tm_do, full, 64 * cb,
                  h, row0, b);
    }
  };

  ring_init<TC_STAGES>(bar_s, kv_bar);
  if (tid == 0) {
    mbar_expect_tx(kv_bar, 2 * KVB);
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb) {
      tma_load_4d(k_s + cb * TK * SW_ROW, &tm_k, kv_bar, 64 * cb, hk,
                  first_k, b);
      tma_load_4d(v_s + cb * TK * SW_ROW, &tm_v, kv_bar, 64 * cb, hk,
                  first_k, b);
    }
    for (int i = 0; i < TC_STAGES && i < n_tiles; ++i) load_q(i);
  }

  // this thread's keys r0 and r0 + 8; its 16 query columns of a tile are
  // 8 (j / 2) + c0 + j % 2 (accumulator element i: j = 2 (i / 4) + i % 2)
  const int r0 = wg_k + 16 * warp + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  const float* lse_bh = lse + ((int64_t)b * Hq + h) * Sq;
  const float* delta_bh = delta + ((int64_t)b * Hq + h) * Sq;
  // dV and dK; at SPLIT one array, warpgroup 0's dV or warpgroup 1's dK
  constexpr int NACC = SPLIT ? 1 : 2;
  float acc[NACC][NCB][32];
#pragma unroll
  for (int a = 0; a < NACC; ++a)
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[a][cb][i] = 0.f;
  float(&dv)[NCB][32] = acc[0];
  float(&dk)[NCB][32] = acc[NACC - 1];
  const uint32_t k_wg = k_s + (wg_k - first_k) * SW_ROW;
  const uint32_t v_wg = v_s + (wg_k - first_k) * SW_ROW;

  mbar_wait(kv_bar, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % TC_STAGES, q0 = (lo + i) * DKV_BQ;
    const uint32_t phase = (i / TC_STAGES) & 1;
    const uint32_t q_t = ring + 2 * st * QTB, do_t = q_t + QTB;

    // the columns' lse (log2 units) and delta, guarded plain loads: a
    // query row past Sq reads as one that saw no key
    float lse2[16], dlt[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = q0 + 8 * (j >> 1) + c0 + (j & 1);
      const bool in = col < Sq;
      lse2[j] = (in ? lse_bh[col] : LSE_EMPTY) * LOG2E;
      dlt[j] = in ? delta_bh[col] : 0.f;
    }
    mbar_wait(bar_s + 8 * st, phase);

    // S^T = K Q^T and dP^T = V dO^T over hd in steps of 16
    float s[32], dp[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] = dp[j] = 0.f;
    wg_fence();
#pragma unroll
    for (int t = 0; t < 4 * NCB; ++t)
      wgmma_ss_n64(s,
                   sw128_desc(k_wg + (t >> 2) * TK * SW_ROW + (t & 3) * 32),
                   sw128_desc(q_t + (t >> 2) * DKV_BQ * SW_ROW + (t & 3) * 32));
    if (want_dk) {
#pragma unroll
      for (int t = 0; t < 4 * NCB; ++t)
        wgmma_ss_n64(
            dp, sw128_desc(v_wg + (t >> 2) * TK * SW_ROW + (t & 3) * 32),
            sw128_desc(do_t + (t >> 2) * DKV_BQ * SW_ROW + (t & 3) * 32));
    }
    wg_commit();
    wg_wait_all();
    reg_fence(s);
    reg_fence(dp);

    const bool edge = wg_k + 63 >= Sk || (causal && wg_k + 63 > q0) ||
                      (window > 0 && wg_k <= q0 + DKV_BQ - 1 - window);
    if (edge) {
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int key = r0 + 8 * ((j >> 1) & 1);
        const int col = q0 + 8 * (j >> 2) + c0 + (j & 1);
        if (!visible(col, key, Sk, causal, window))
          s[j] = __uint_as_float(0xff800000u);   // -inf
      }
    }
    // P^T and dS^T on the fragment, packed as bf16 A fragments: queries
    // 16 t .. 16 t + 15 are registers 8 t .. 8 t + 7
    uint32_t pa[DKV_BQ / 16][4], da[DKV_BQ / 16][4];
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = 2 * (j >> 2) + (j & 1);
      s[j] = ex2(fmaf(s[j], scale_log2, -lse2[c]));
      dp[j] = s[j] * (dp[j] - dlt[c]);
    }
#pragma unroll
    for (int t = 0; t < DKV_BQ / 16; ++t)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        pa[t][x] = pack_bf16(s[8 * t + 2 * x], s[8 * t + 2 * x + 1]);
        da[t][x] = pack_bf16(dp[8 * t + 2 * x], dp[8 * t + 2 * x + 1]);
      }

    // dV += P^T dO and dK += dS^T Q over the tile's queries in steps of 16
    wg_fence();
#pragma unroll
    for (int t = 0; t < DKV_BQ / 16; ++t)
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb) {
        if (want_dv)
          wgmma_rs_n64(dv[cb], pa[t],
                       sw128_desc(do_t + cb * DKV_BQ * SW_ROW +
                                  t * 16 * SW_ROW));
        if (want_dk)
          wgmma_rs_n64(dk[cb], da[t],
                       sw128_desc(q_t + cb * DKV_BQ * SW_ROW +
                                  t * 16 * SW_ROW));
      }
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int a = 0; a < NACC; ++a)
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb) reg_fence(acc[a][cb]);

    // release the stage; thread 0 refills it once all 256 threads have
    mbar_arrive(bar_s + 8 * (TC_STAGES + st));
    if (tid == 0 && i + TC_STAGES < n_tiles) {
      mbar_wait(bar_s + 8 * (TC_STAGES + st), phase);
      load_q(i + TC_STAGES);
    }
    __syncwarp();
  }

  // per-query-head outputs, laid out (B, Sk, Hq, hd)
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int row = r0 + 8 * x;
    if (row >= Sk) continue;
    __nv_bfloat16* k_row = dk_h + row_off(b, row, h, Sk, Hq, hd);
    __nv_bfloat16* v_row = dv_h + row_off(b, row, h, Sk, Hq, hd);
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * cb + 8 * j + c0;
        if (col >= hd) continue;
        if (want_dk)
          *reinterpret_cast<__nv_bfloat162*>(k_row + col) =
              __floats2bfloat162_rn(scale * dk[cb][4 * j + 2 * x],
                                    scale * dk[cb][4 * j + 2 * x + 1]);
        if (want_dv)
          *reinterpret_cast<__nv_bfloat162*>(v_row + col) =
              __floats2bfloat162_rn(dv[cb][4 * j + 2 * x],
                                    dv[cb][4 * j + 2 * x + 1]);
      }
  }
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
  // hd > 128: K and V take turns in one buffer (V for dP, then K for S and
  // dQ), or the five tiles would pass the 227 KB a block may hold
  constexpr bool SHARE = HDP > 128;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * LD;
  float* Ks = dOs + BQ * LD;
  float* Vs = SHARE ? Ks : Ks + BK * LD;
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
    if (!SHARE) load_tile<T, HDP>(Ks, k, b, ki * BK, Sk, Hkv, hk, hd);
    load_tile<T, HDP>(Vs, v, b, ki * BK, Sk, Hkv, hk, hd);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    if (SHARE) {
      // dP = dO V^T, then K replaces V, then S = Q K^T: each sum in the
      // order of the shared loop below
      for (int d = 0; d < HDP; ++d) {
        float o[4], vb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i] = dOs[(ty + 16 * i) * LD + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) vb[j] = Vs[(tx + 16 * j) * LD + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) dp[i][j] = fmaf(o[i], vb[j], dp[i][j]);
      }
      __syncthreads();
      load_tile<T, HDP>(Ks, k, b, ki * BK, Sk, Hkv, hk, hd);
      __syncthreads();
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
    } else {
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
// Query tiles of TQ rows: 64, and 32 at hd > 128, where four 64-row tiles
// of 256 f32 columns would pass the 227 KB a block may hold.
template <int HDP>
__host__ __device__ constexpr int dkv_tq() { return HDP > 128 ? 32 : BQ; }

template <typename T, int HDP>
__global__ void __launch_bounds__(NT)
fa_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dk_h,
                  T* __restrict__ dv_h, int Sq, int Sk, int Hq, int Hkv,
                  int hd, int causal, int window, float scale) {
  constexpr int TQ = dkv_tq<HDP>(), NJ = TQ / 16;
  constexpr int LD = HDP + 1, LDT = TQ + 1, DC = HDP / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LD;
  float* dOs = Qs + TQ * LD;
  float* Pt = dOs + TQ * LD;
  float* DSt = Pt + BK * LDT;
  float* lse_s = DSt + BK * LDT;
  float* delta_s = lse_s + TQ;
  const int ki = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int first_k = ki * BK;
  int lo, hi;
  q_range<TQ, BK>(ki, (Sq + TQ - 1) / TQ, causal, window, &lo, &hi);

  load_tile<T, HDP>(Ks, k, b, first_k, Sk, Hkv, hk, hd);
  load_tile<T, HDP>(Vs, v, b, first_k, Sk, Hkv, hk, hd);
  float dk[4][DC], dv[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int qi = lo; qi <= hi; ++qi) {
    __syncthreads();
    load_tile<T, HDP, TQ>(Qs, q, b, qi * TQ, Sq, Hq, h, hd);
    load_tile<T, HDP, TQ>(dOs, dout, b, qi * TQ, Sq, Hq, h, hd);
    if (threadIdx.x < TQ) {
      const int row = qi * TQ + threadIdx.x;
      const int64_t o = ((int64_t)b * Hq + h) * Sq + row;
      lse_s[threadIdx.x] = row < Sq ? lse[o] : LSE_EMPTY;
      delta_s[threadIdx.x] = row < Sq ? delta[o] : 0.f;
    }
    __syncthreads();

    // transposed tile: rows are keys (ty + 16 i), columns queries (tx + 16 j)
    float st[4][NJ], dpt[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) st[i][j] = dpt[i][j] = 0.f;
    for (int d = 0; d < HDP; ++d) {
      float kb[4], vb[4], a[NJ], o[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kb[i] = Ks[(ty + 16 * i) * LD + d];
        vb[i] = Vs[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        a[j] = Qs[(tx + 16 * j) * LD + d];
        o[j] = dOs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          st[i][j] = fmaf(a[j], kb[i], st[i][j]);
          dpt[i][j] = fmaf(o[j], vb[i], dpt[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k_pos = first_k + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int qc = tx + 16 * j, q_pos = qi * TQ + qc;
        const bool ok = q_pos < Sq && visible(q_pos, k_pos, Sk, causal, window);
        const float p = ok ? expf(st[i][j] * scale - lse_s[qc]) : 0.f;
        Pt[(ty + 16 * i) * LDT + qc] = p;
        DSt[(ty + 16 * i) * LDT + qc] = p * (dpt[i][j] - delta_s[qc]) * scale;
      }
    }
    __syncthreads();

    for (int c = 0; c < TQ; ++c) {
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
constexpr size_t dq_smem() {   // hd > 128: K and V share one buffer
  return sizeof(float) * ((2 * BQ + (HDP > 128 ? 1 : 2) * BK) * (HDP + 1) +
                          BQ * (BK + 1));
}
template <int HDP>
constexpr size_t dkv_smem() {
  constexpr int TQ = dkv_tq<HDP>();
  return sizeof(float) *
         ((2 * BK + 2 * TQ) * (HDP + 1) + 2 * BK * (TQ + 1) + 2 * TQ);
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

template <int NCB>
int launch_fwd_tc(const void* q, const void* k, const void* v, void* out,
                  void* lse, void* tiles, int B, int Sq, int Sk, int Hq,
                  int Hkv, int hd, int causal, int window, float scale,
                  cudaStream_t stream) {
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!encode_bshd(enc, &tm_q, q, B, Sq, Hq, hd, TC_BQ) ||
      !encode_bshd(enc, &tm_k, k, B, Sk, Hkv, hd, tc_bk(NCB)) ||
      !encode_bshd(enc, &tm_v, v, B, Sk, Hkv, hd, tc_bk(NCB)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = tc_fwd_smem<NCB>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_tc_kernel<NCB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Hq, B, (Sq + TC_BQ - 1) / TC_BQ);   // q-tiles slowest
  fa_fwd_tc_kernel<NCB><<<grid, TC_NT, smem, stream>>>(
      tm_q, tm_k, tm_v, (__nv_bfloat16*)out, (float*)lse, (int*)tiles, Sq,
      Sk, Hq, Hkv, hd, causal, window, scale * LOG2E);
  return (int)cudaGetLastError();
}

template <int NCB>
int launch_dq_tc(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dq, int B, int Sq, int Sk, int Hq, int Hkv, int hd,
                 int causal, int window, float scale, cudaStream_t stream) {
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  if (!encode_bshd(enc, &tm_q, q, B, Sq, Hq, hd, TC_BQ) ||
      !encode_bshd(enc, &tm_k, k, B, Sk, Hkv, hd, tc_bk(NCB)) ||
      !encode_bshd(enc, &tm_v, v, B, Sk, Hkv, hd, tc_bk(NCB)) ||
      !encode_bshd(enc, &tm_do, dout, B, Sq, Hq, hd, TC_BQ))
    return (int)cudaErrorInvalidValue;
  const size_t smem = tc_dq_smem<NCB>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_dq_tc_kernel<NCB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Hq, B, (Sq + TC_BQ - 1) / TC_BQ);   // q-tiles slowest
  fa_bwd_dq_tc_kernel<NCB><<<grid, TC_NT, smem, stream>>>(
      tm_q, tm_k, tm_v, tm_do, (const float*)lse, (const float*)delta,
      (__nv_bfloat16*)dq, Sq, Sk, Hq, Hkv, hd, causal, window, scale,
      scale * LOG2E);
  return (int)cudaGetLastError();
}

template <int NCB>
int launch_dkv_tc(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dk_h, void* dv_h, int B, int Sq, int Sk, int Hq,
                  int Hkv, int hd, int causal, int window, float scale,
                  cudaStream_t stream) {
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  if (!encode_bshd(enc, &tm_q, q, B, Sq, Hq, hd, DKV_BQ) ||
      !encode_bshd(enc, &tm_k, k, B, Sk, Hkv, hd, dkv_keys(NCB)) ||
      !encode_bshd(enc, &tm_v, v, B, Sk, Hkv, hd, dkv_keys(NCB)) ||
      !encode_bshd(enc, &tm_do, dout, B, Sq, Hq, hd, DKV_BQ))
    return (int)cudaErrorInvalidValue;
  const size_t smem = tc_dkv_smem<NCB>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_dkv_tc_kernel<NCB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Hq, B, (Sk + dkv_keys(NCB) - 1) / dkv_keys(NCB));  // kv-tiles
  fa_bwd_dkv_tc_kernel<NCB><<<grid, TC_NT, smem, stream>>>(
      tm_q, tm_k, tm_v, tm_do, (const float*)lse, (const float*)delta,
      (__nv_bfloat16*)dk_h, (__nv_bfloat16*)dv_h, Sq, Sk, Hq, Hkv, hd, causal,
      window, scale, scale * LOG2E);
  return (int)cudaGetLastError();
}

// f32 only (dtype 0); hd <= 32 / 64 / 128 / 256 -> padded width 32 / 64 /
// 128 / 256
#define FA_DISPATCH(LAUNCH, ...)                                         \
  do {                                                                   \
    if (hd <= 0 || hd > 256 || dtype != 0)                               \
      return (int)cudaErrorInvalidValue;                                 \
    if (hd <= 32) return LAUNCH<float, 32>(__VA_ARGS__);                 \
    if (hd <= 64) return LAUNCH<float, 64>(__VA_ARGS__);                 \
    if (hd <= 128) return LAUNCH<float, 128>(__VA_ARGS__);               \
    return LAUNCH<float, 256>(__VA_ARGS__);                              \
  } while (0)

// bf16 only (dtype 1), on the tensor cores: hd a multiple of 8 (TMA needs
// the row stride H hd 2 bytes to be a multiple of 16), at most 256, padded
// to NCB = 1, 2 or 4 blocks of 64 columns (TMA zero-fills the columns past
// hd); Sq, Sk > 0
#define FA_TC_DISPATCH(LAUNCH, ...)                                      \
  do {                                                                   \
    if (dtype != 1 || hd <= 0 || hd > 256 || hd % 8 != 0 || Sq <= 0 ||   \
        Sk <= 0)                                                         \
      return (int)cudaErrorInvalidValue;                                 \
    if (hd <= 64) return LAUNCH<1>(__VA_ARGS__);                         \
    if (hd <= 128) return LAUNCH<2>(__VA_ARGS__);                        \
    return LAUNCH<4>(__VA_ARGS__);                                       \
  } while (0)

}  // namespace

extern "C" {

// Tile sizes at head dim hd, for the wrapper's tile accounting: fa_fwd,
// fa_bwd_dq (f32) 64 x 64; fa_bwd_dkv (f32) 64 (hd <= 128) or 32 query
// rows x 64 keys; fa_fwd_tc and fa_bwd_dq_tc (bf16) 128 query rows x 128
// keys (hd <= 128) or 64; fa_bwd_dkv_tc (bf16) 64 query rows x 128 keys
// (hd <= 128) or 64.
static int ncb_of(int hd) { return hd <= 64 ? 1 : hd <= 128 ? 2 : 4; }
int fa_block_q(int hd) { return BQ; }
int fa_block_k(int hd) { return BK; }
int fa_fwd_block_q(int hd) { return TC_BQ; }
int fa_fwd_block_k(int hd) { return tc_bk(ncb_of(hd)); }
int fa_dq_tc_block_q(int hd) { return TC_BQ; }
int fa_dq_tc_block_k(int hd) { return tc_bk(ncb_of(hd)); }
int fa_dkv_tc_block_q(int hd) { return DKV_BQ; }
int fa_dkv_tc_block_k(int hd) { return dkv_keys(ncb_of(hd)); }

// f32 only (dtype 0): out (B,Sq,Hq,hd) f32, lse (B,Hq,Sq) f32, tiles
// (B,Hq,ceil(Sq/64)) int32 or null (not counted).  Returns
// cudaGetLastError() after the launch.
int fa_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
           void* tiles, int dtype, int B, int Sq, int Sk, int Hq, int Hkv,
           int hd, int causal, int window, float scale, void* stream) {
  FA_DISPATCH(launch_fwd, q, k, v, out, lse, tiles, B, Sq, Sk, Hq, Hkv, hd,
              causal, window, scale, (cudaStream_t)stream);
}

// bf16 only (dtype 1), on the tensor cores (FA_TC_DISPATCH); q, k, v
// 16-byte aligned.  out (B,Sq,Hq,hd) bf16, lse (B,Hq,Sq) f32, tiles
// (B,Hq,ceil(Sq/128)) int32 or null (not counted).  Returns
// cudaGetLastError() after the launch.
int fa_fwd_tc(const void* q, const void* k, const void* v, void* out,
              void* lse, void* tiles, int dtype, int B, int Sq, int Sk,
              int Hq, int Hkv, int hd, int causal, int window, float scale,
              void* stream) {
  FA_TC_DISPATCH(launch_fwd_tc, q, k, v, out, lse, tiles, B, Sq, Sk, Hq, Hkv,
                 hd, causal, window, scale, (cudaStream_t)stream);
}

// f32 only (dtype 0): dq (B,Sq,Hq,hd) f32.
int fa_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int dtype, int B,
              int Sq, int Sk, int Hq, int Hkv, int hd, int causal, int window,
              float scale, void* stream) {
  FA_DISPATCH(launch_dq, q, k, v, dout, lse, delta, dq, B, Sq, Sk, Hq, Hkv,
              hd, causal, window, scale, (cudaStream_t)stream);
}

// f32 only (dtype 0): dk_h, dv_h (B,Sk,Hq,hd) f32, per query head.
int fa_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk_h, void* dv_h,
               int dtype, int B, int Sq, int Sk, int Hq, int Hkv, int hd,
               int causal, int window, float scale, void* stream) {
  FA_DISPATCH(launch_dkv, q, k, v, dout, lse, delta, dk_h, dv_h, B, Sq, Sk,
              Hq, Hkv, hd, causal, window, scale, (cudaStream_t)stream);
}

// bf16 only (dtype 1), on the tensor cores (FA_TC_DISPATCH); q, k, v,
// dout 16-byte aligned.  dq (B,Sq,Hq,hd) bf16.
int fa_bwd_dq_tc(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dq, int dtype, int B, int Sq, int Sk, int Hq, int Hkv,
                 int hd, int causal, int window, float scale, void* stream) {
  FA_TC_DISPATCH(launch_dq_tc, q, k, v, dout, lse, delta, dq, B, Sq, Sk, Hq,
                 Hkv, hd, causal, window, scale, (cudaStream_t)stream);
}

// bf16 only, as fa_bwd_dq_tc: dk_h, dv_h (B,Sk,Hq,hd) bf16, per query head.
int fa_bwd_dkv_tc(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dk_h, void* dv_h, int dtype, int B, int Sq, int Sk,
                  int Hq, int Hkv, int hd, int causal, int window,
                  float scale, void* stream) {
  FA_TC_DISPATCH(launch_dkv_tc, q, k, v, dout, lse, delta, dk_h, dv_h, B, Sq,
                 Sk, Hq, Hkv, hd, causal, window, scale,
                 (cudaStream_t)stream);
}

}  // extern "C"
