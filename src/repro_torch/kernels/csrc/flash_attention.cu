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
// B2, B3 and B4 in f32, fa_fwd_kernel / fa_bwd_dq_kernel /
// fa_bwd_dkv_kernel: every product is an IEEE f32 FFMA on the CUDA cores
// (no TF32, no split-TF32, no mma / wgmma, no fast-math), so the bound is
// the SMs' FFMA peak, 67 TFLOP/s; the bytes bound is a tenth of it at the
// main path's shape.  Reaching that peak means an FFMA in nearly every
// issue slot, so the design is that of a CUDA-core GEMM:
//   - register blocking: one block of 128 threads, a 16 x 8 grid (ty =
//     tid / 8, tx = tid % 8).  Each block keeps a resident tile of f_out =
//     64 rows (32 at hd 256) - query rows for fa_fwd / fa_bwd_dq, keys for
//     fa_bwd_dkv - and streams tiles of f_in = 64 rows of the other side
//     (32 above hd 64).  A thread owns rows ty + 16 i of the resident tile
//     (R = 4 of them), rows tx + 8 j of the streamed one (8) and head-dim
//     columns 32 g + 4 tx + e, so at hd 64 every product it takes part in
//     is a 4 x 8 piece, and one row's softmax statistics live in the 8
//     lanes of a quarter-warp (xor shuffles 1, 2, 4);
//   - vector shared reads: the operand tiles sit in shared memory in their
//     global (row, hd) layout with each 16-byte chunk's index XORed with
//     the row % 8, so that a quarter-warp reading 8 rows at one chunk, or
//     one row at 8 chunks, meets 8 distinct bank groups; every operand is
//     read as float4.  The score products (S = Q K^T, dP = dO V^T and their
//     transposes) read 4 head-dim columns of 4 + 8 rows a step, 128 FFMAs
//     for 48 words; the accumulating products (P V, dS K, P^T dO, dS^T Q)
//     read 4 probabilities and 8 values a key or query, 32 FFMAs for 12
//     words: 2.7 FFMAs a word against the 2 of the 4 x 4 scalar design
//     this replaced.  (128-row resident tiles, with 8 x 4 and 8 x 8
//     pieces, measured slower: at S 1024 the causal grid has too few
//     blocks, and its heaviest set the time.)  P and dS go
//     through a padded buffer in the order the next product reads (one row
//     per key or query, each thread's R rows side by side), written and
//     read by the 8 lanes that own them, so a __syncwarp orders them, not
//     a block barrier;
//   - asynchronous, double-buffered loads: the streamed tiles (K / V for
//     fa_fwd and fa_bwd_dq, Q / dO for fa_bwd_dkv) move by 16-byte cp.async
//     (4-byte where hd % 4 or the alignment forbids it) into a ring of two
//     stages; the next tile is in flight while the current one is computed,
//     one block barrier a tile.  Rows past S and columns past hd are
//     zero-filled by the copies (src-size 0);
//   - tile shapes from the head dim (template on HDP, hd padded to 32, 64,
//     128 or 256): each accumulator stays at 64 registers or fewer, and at
//     hd <= 64 the shared memory (97 KB fa_fwd, 113 KB the backward) lets
//     two blocks share an SM; at hd 128 two of fa_fwd and one of the
//     backward fit, at hd 256 one;
//   - heaviest tiles first: the grid is (Hq, B, tiles), so the query heads
//     of one KV head are neighbours (their K / V tiles meet in L2), and
//     under causal masking fa_fwd / fa_bwd_dq take their q-tiles last to
//     first and fa_bwd_dkv its kv-tiles first to last: the blocks with the
//     most live partners start first and the short ones fill the tail.
// The block loops over the live tiles of the other axis only: the TPU's
// pl.when(_tile_live) skip becomes the loop's bounds (lo / hi below,
// mirrored by _live_range in flash_attention.py and checked there against
// the predicate); masks are applied per element only on tiles that cross
// the causal diagonal, the window's edge or S.  Split in two kernels as on
// the TPU, the backward forms s and dp in each: fa_bwd_dq does three
// products (1.5x the forward), fa_bwd_dkv four (2x).  A fused backward
// would do 2.5x but must sum dq across blocks (atomics, or a second pass);
// TF32 would raise the peak sevenfold but keep 10 bits of mantissa, and
// the training's reference is f32 with TF32 off: neither is taken.
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

constexpr float NEG = -1e30f;
constexpr float LSE_EMPTY = 1e30f;

// Row `s` of head `h` of a contiguous (B, S, H, hd) tensor.
__device__ __forceinline__ int64_t row_off(int b, int s, int h, int S, int H,
                                           int hd) {
  return ((int64_t)b * S + s) * H * (int64_t)hd + (int64_t)h * hd;
}

__device__ __forceinline__ bool visible(int q_pos, int k_pos, int Sk,
                                        int causal, int window) {
  bool ok = k_pos < Sk;
  if (causal) ok = ok && k_pos <= q_pos;
  if (window > 0) ok = ok && k_pos > q_pos - window;
  return ok;
}

// Live kv tiles [lo, hi] of q-tile qi for TQ x TK tiles (fa_fwd,
// fa_bwd_dq: f_out x f_in; fa_fwd_tc: 128 x 128).
template <int TQ, int TK>
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
// f_in x f_out; fa_bwd_dkv_tc: 64 x 128).
template <int TQ, int TK>
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

// ------------------------------------------ B2-B4, f32, on the CUDA cores
constexpr int F_NT = 128;       // threads a block: ty = tid / 8, tx = tid % 8

// Rows of the resident tile at padded head dim hdp: query rows (B2, B3) or
// keys (B4), 64 (32 at hd 256); a thread holds R = f_out / 16 of them (ty +
// 16 i).  Rows of a streamed tile: keys (B2, B3) or queries (B4), 64 up to
// hd 64 and 32 above (the ring must fit); a thread holds f_in / 8 of them
// (tx + 8 j).  At hd 64 every product a thread takes part in is a 4 x 8
// piece; its accumulators hold R x hdp / 8 floats.
__host__ __device__ constexpr int f_out(int hdp) {
  return hdp <= 128 ? 64 : 32;
}
__host__ __device__ constexpr int f_in(int hdp) { return hdp <= 64 ? 64 : 32; }
// Row stride of the P / dS buffer (f_in rows of f_out floats): + 4 so that
// the 4 row groups of a warp meet distinct bank groups.
__host__ __device__ constexpr int f_ldp(int hdp) { return f_out(hdp) + 4; }
// Shared memory: B2 Q + a ring of 2 x (K, V) + the P buffer; B3 Q + dO +
// the ring + the dS buffer; B4 K + V + a ring of 2 x (Q, dO) + the buffer.
__host__ __device__ constexpr size_t f_smem(int hdp, int resident) {
  return sizeof(float) * ((size_t)resident * f_out(hdp) * hdp +
                          4 * f_in(hdp) * hdp + f_in(hdp) * f_ldp(hdp));
}

// Offset of element (r, c) in a tile of W floats a row whose 16-byte chunk
// c / 4 is stored at chunk (c / 4) XOR (r % 8): a quarter-warp reading 8
// rows at one chunk, or one row at 8 chunks, meets 8 bank groups.
template <int W>
__device__ __forceinline__ int swz(int r, int c) {
  return r * W + (((c >> 2) ^ (r & 7)) << 2) + (c & 3);
}

// Asynchronous copies into shared memory (sm_80+): 16 or 4 bytes, the
// rest of the destination zero-filled when `in` is false (nothing read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ROWS rows [row0, row0 + ROWS) of head h of a (B, S, H, hd) f32 tensor
// into a swizzled tile of HDP columns, issued by all F_NT threads; rows at
// or past S and columns at or past hd are zero-filled.  `vec`: 16-byte
// copies (hd % 4 == 0, 16-byte-aligned tensors), else 4-byte ones.
template <int ROWS, int HDP>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int b, int row0, int S, int H,
                                          int h, int hd, bool vec) {
  const uint32_t d0 = smem_u32(dst);
  if (vec) {
    constexpr int CH = HDP / 4;
#pragma unroll 4
    for (int idx = threadIdx.x; idx < ROWS * CH; idx += F_NT) {
      const int r = idx / CH, c = 4 * (idx % CH), s = row0 + r;
      const bool in = s < S && c < hd;
      cp_async16(d0 + 4 * swz<HDP>(r, c),
                 in ? src + row_off(b, s, h, S, H, hd) + c : src, in);
    }
  } else {
    for (int idx = threadIdx.x; idx < ROWS * HDP; idx += F_NT) {
      const int r = idx / HDP, c = idx % HDP, s = row0 + r;
      const bool in = s < S && c < hd;
      cp_async4(d0 + 4 * swz<HDP>(r, c),
                in ? src + row_off(b, s, h, S, H, hd) + c : src, in);
    }
  }
}

// acc[i][j] += A row (ty + 16 i) . B row (tx + 8 j) over the HDP columns,
// in column order; A and B are swizzled tiles.  A quarter-warp reads one
// A row (a broadcast) and 8 B rows at 8 distinct bank groups; the warp's
// 4 A rows fall on 4 bank groups.
template <int R, int J, int HDP>
__device__ __forceinline__ void nt_product(float (&acc)[R][J],
                                           const float* __restrict__ A,
                                           const float* __restrict__ B,
                                           int ty, int tx) {
  const float* a0 = A + ty * HDP;
  const float* b0 = B + tx * HDP;
  const int ya = ty & 7;          // A rows' chunk swizzle; B rows' is tx
#pragma unroll 2
  for (int k = 0; k < HDP / 4; ++k) {
    float a[R][4], bv[J][4];
    const int ka = 4 * ((k & ~7) | ((k ^ ya) & 7));
    const int kb = 4 * ((k & ~7) | ((k ^ tx) & 7));
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float4 t =
          *reinterpret_cast<const float4*>(a0 + 16 * i * HDP + ka);
      a[i][0] = t.x, a[i][1] = t.y, a[i][2] = t.z, a[i][3] = t.w;
    }
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const float4 t =
          *reinterpret_cast<const float4*>(b0 + 8 * j * HDP + kb);
      bv[j][0] = t.x, bv[j][1] = t.y, bv[j][2] = t.z, bv[j][3] = t.w;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < J; ++j)
          acc[i][j] = fmaf(a[i][e], bv[j][e], acc[i][j]);
  }
}

// The thread's R values of buffer row r (its rows ty + 16 i, side by side).
template <int R, int LDP>
__device__ __forceinline__ void buf_row(float (&p)[R], const float* buf,
                                        int r, int ty) {
  const float* src = buf + r * LDP + R * ty;
  if constexpr (R == 2) {
    const float2 t = *reinterpret_cast<const float2*>(src);
    p[0] = t.x, p[1] = t.y;
  } else {
#pragma unroll
    for (int x = 0; x < R / 4; ++x) {
      const float4 t = *reinterpret_cast<const float4*>(src + 4 * x);
      p[4 * x] = t.x, p[4 * x + 1] = t.y, p[4 * x + 2] = t.z,
      p[4 * x + 3] = t.w;
    }
  }
}

// The thread's piece x[i][j] (resident row ty + 16 i, streamed row tx +
// 8 j) into the buffer at row tx + 8 j, column R ty + i; x_from_buf reads
// it back.  Only the 8 lanes of a quarter-warp read what one of them
// wrote, so a __syncwarp orders writes and reads.
template <int R, int J, int LDP>
__device__ __forceinline__ void x_to_buf(float* buf, const float (&x)[R][J],
                                         int ty, int tx) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    float* dst = buf + (tx + 8 * j) * LDP + R * ty;
    if constexpr (R == 2) {
      *reinterpret_cast<float2*>(dst) = make_float2(x[0][j], x[1][j]);
    } else {
#pragma unroll
      for (int c = 0; c < R / 4; ++c)
        *reinterpret_cast<float4*>(dst + 4 * c) =
            make_float4(x[4 * c][j], x[4 * c + 1][j], x[4 * c + 2][j],
                        x[4 * c + 3][j]);
    }
  }
}
template <int R, int J, int LDP>
__device__ __forceinline__ void x_from_buf(float (&x)[R][J],
                                           const float* buf, int ty,
                                           int tx) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    float p[R];
    buf_row<R, LDP>(p, buf, tx + 8 * j, ty);
#pragma unroll
    for (int i = 0; i < R; ++i) x[i][j] = p[i];
  }
}

// acc[i][4 g + e] += sum over the f_in buffer rows k of buf[k][R ty + i]
// times B[k][32 g + 4 tx + e], B a swizzled tile of HDP columns.
template <int R, int HDP, int LDP>
__device__ __forceinline__ void nn_product(float (&acc)[R][HDP / 8],
                                           const float* __restrict__ buf,
                                           const float* __restrict__ B,
                                           int ty, int tx) {
  constexpr int G = HDP / 32;
#pragma unroll 4
  for (int k = 0; k < f_in(HDP); ++k) {
    float p[R], v[G][4];
    buf_row<R, LDP>(p, buf, k, ty);
    const float* row = B + k * HDP + 4 * (tx ^ (k & 7));
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float4 t = *reinterpret_cast<const float4*>(row + 32 * g);
      v[g][0] = t.x, v[g][1] = t.y, v[g][2] = t.z, v[g][3] = t.w;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int g = 0; g < G; ++g)
          acc[i][4 * g + e] = fmaf(p[i], v[g][e], acc[i][4 * g + e]);
  }
}

// Accumulator row acc (columns 32 g + 4 tx + e) into `dst`, the row of a
// (B, S, H, hd) tensor; columns at or past hd are not stored.
template <int HDP>
__device__ __forceinline__ void store_row(float* dst,
                                          const float (&acc)[HDP / 8], int tx,
                                          int hd, bool vec) {
#pragma unroll
  for (int g = 0; g < HDP / 32; ++g) {
    const int col = 32 * g + 4 * tx;
    if (vec) {
      if (col < hd)
        *reinterpret_cast<float4*>(dst + col) = make_float4(
            acc[4 * g], acc[4 * g + 1], acc[4 * g + 2], acc[4 * g + 3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (col + e < hd) dst[col + e] = acc[4 * g + e];
    }
  }
}

// B2: one block per (head, batch, q-tile of f_out rows), q-tiles last to
// first under causal masking.  Q once, K / V tiles of f_in keys through the
// ring; S = Q K^T, the online softmax on the thread's R x J piece (m, and
// l summed per thread and reduced over the quarter-warp at the end), P
// through the buffer, O += P V.
template <int HDP>
__global__ void __launch_bounds__(F_NT)
fa_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out,
              float* __restrict__ lse, int* __restrict__ tiles, int Sq,
              int Sk, int Hq, int Hkv, int hd, int causal, int window,
              float scale, int vec) {
  constexpr int BQ = f_out(HDP), R = BQ / 16, DC = HDP / 8;
  constexpr int F_IN = f_in(HDP), J = F_IN / 8;
  constexpr int LDP = f_ldp(HDP), T = F_IN * HDP;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* ring = Qs + BQ * HDP;     // stage st: K at ring + 2 st T, V after
  float* Ps = ring + 4 * T;
  const int h = blockIdx.x, b = blockIdx.y, nq = gridDim.z;
  const int qi = causal ? nq - 1 - (int)blockIdx.z : (int)blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
  const int q0 = qi * BQ;
  int lo, hi;
  kv_range<BQ, F_IN>(qi, (Sk + F_IN - 1) / F_IN, causal, window, &lo, &hi);
  const int n = hi >= lo ? hi - lo + 1 : 0;
  auto load_kv = [&](int it) {    // tile lo + it into stage it % 2
    float* dst = ring + 2 * (it & 1) * T;
    load_tile<F_IN, HDP>(dst, k, b, (lo + it) * F_IN, Sk, Hkv, hk, hd, vec);
    load_tile<F_IN, HDP>(dst + T, v, b, (lo + it) * F_IN, Sk, Hkv, hk, hd,
                         vec);
  };

  load_tile<BQ, HDP>(Qs, q, b, q0, Sq, Hq, h, hd, vec);
  if (n > 0) load_kv(0);
  cp_async_commit();
  float m[R], l[R], o[R][DC];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) o[i][c] = 0.f;
  }

  for (int it = 0; it < n; ++it) {
    cp_async_wait_all();
    __syncthreads();    // tile it in place; every thread is past tile it - 1
    if (it + 1 < n) load_kv(it + 1);
    cp_async_commit();
    const float* Ks = ring + 2 * (it & 1) * T;
    const int k0 = (lo + it) * F_IN;

    float s[R][J];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j) s[i][j] = 0.f;
    nt_product<R, J, HDP>(s, Qs, Ks, ty, tx);

    const bool edge = k0 + F_IN > Sk || (causal && k0 + F_IN - 1 > q0) ||
                      (window > 0 && k0 <= q0 + BQ - 1 - window);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        s[i][j] *= scale;
        if (edge && !visible(q0 + ty + 16 * i, k0 + tx + 8 * j, Sk, causal,
                             window))
          s[i][j] = __uint_as_float(0xff800000u);   // -inf: exp 0
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
      l[i] = alpha * l[i] + rs;   // this thread's keys; summed at the end
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) o[i][c] *= alpha;
    }
    x_to_buf<R, J, LDP>(Ps, s, ty, tx);
    __syncwarp();
    nn_product<R, HDP, LDP>(o, Ps, Ks + T, ty, tx);
  }
  cp_async_wait_all();

#pragma unroll
  for (int i = 0; i < R; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 4);
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const bool empty = l[i] == 0.f;
    float inv[DC];
#pragma unroll
    for (int c = 0; c < DC; ++c) inv[c] = empty ? 0.f : o[i][c] / l[i];
    store_row<HDP>(out + row_off(b, row, h, Sq, Hq, hd), inv, tx, hd,
                   vec);
    if (tx == 0)
      lse[((int64_t)b * Hq + h) * Sq + row] =
          empty ? LSE_EMPTY : m[i] + logf(l[i]);
  }
  if (threadIdx.x == 0 && tiles != nullptr)
    tiles[((int64_t)b * Hq + h) * nq + qi] = n;
}

// B3: one block per (head, batch, q-tile of f_out rows), q-tiles last to
// first under causal masking.  Q and dO once, K / V tiles of f_in keys
// through the ring; S = Q K^T and dP = dO V^T, dS = P (dP - delta) scale
// with P = exp(S scale - lse), dS through the buffer, dQ += dS K.
template <int HDP>
__global__ void __launch_bounds__(F_NT)
fa_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq,
                 int Sq, int Sk, int Hq, int Hkv, int hd, int causal,
                 int window, float scale, int vec) {
  constexpr int BQ = f_out(HDP), R = BQ / 16, DC = HDP / 8;
  constexpr int F_IN = f_in(HDP), J = F_IN / 8;
  constexpr int LDP = f_ldp(HDP), T = F_IN * HDP;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * HDP;
  float* ring = dOs + BQ * HDP;    // stage st: K at ring + 2 st T, V after
  float* DSs = ring + 4 * T;
  const int h = blockIdx.x, b = blockIdx.y, nq = gridDim.z;
  const int qi = causal ? nq - 1 - (int)blockIdx.z : (int)blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
  const int q0 = qi * BQ;
  int lo, hi;
  kv_range<BQ, F_IN>(qi, (Sk + F_IN - 1) / F_IN, causal, window, &lo, &hi);
  const int n = hi >= lo ? hi - lo + 1 : 0;
  auto load_kv = [&](int it) {
    float* dst = ring + 2 * (it & 1) * T;
    load_tile<F_IN, HDP>(dst, k, b, (lo + it) * F_IN, Sk, Hkv, hk, hd, vec);
    load_tile<F_IN, HDP>(dst + T, v, b, (lo + it) * F_IN, Sk, Hkv, hk, hd,
                         vec);
  };

  load_tile<BQ, HDP>(Qs, q, b, q0, Sq, Hq, h, hd, vec);
  load_tile<BQ, HDP>(dOs, dout, b, q0, Sq, Hq, h, hd, vec);
  if (n > 0) load_kv(0);
  cp_async_commit();
  // the rows' lse and delta; a row past Sq reads as one that saw no key
  float lse_r[R], dl_r[R], acc[R][DC];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty + 16 * i;
    const int64_t o = ((int64_t)b * Hq + h) * Sq + row;
    lse_r[i] = row < Sq ? lse[o] : LSE_EMPTY;
    dl_r[i] = row < Sq ? delta[o] : 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int it = 0; it < n; ++it) {
    cp_async_wait_all();
    __syncthreads();
    if (it + 1 < n) load_kv(it + 1);
    cp_async_commit();
    const float* Ks = ring + 2 * (it & 1) * T;
    const int k0 = (lo + it) * F_IN;

    float s[R][J], dp[R][J];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j) s[i][j] = dp[i][j] = 0.f;
    nt_product<R, J, HDP>(s, Qs, Ks, ty, tx);
    nt_product<R, J, HDP>(dp, dOs, Ks + T, ty, tx);

    const bool edge = k0 + F_IN > Sk || (causal && k0 + F_IN - 1 > q0) ||
                      (window > 0 && k0 <= q0 + BQ - 1 - window);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const bool ok = !edge || visible(q0 + ty + 16 * i, k0 + tx + 8 * j,
                                         Sk, causal, window);
        const float p = ok ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        s[i][j] = p * (dp[i][j] - dl_r[i]) * scale;
      }
    x_to_buf<R, J, LDP>(DSs, s, ty, tx);
    __syncwarp();
    nn_product<R, HDP, LDP>(acc, DSs, Ks, ty, tx);
  }
  cp_async_wait_all();

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < Sq)
      store_row<HDP>(dq + row_off(b, row, h, Sq, Hq, hd), acc[i], tx,
                     hd, vec);
  }
}

// B4: one block per (query head, batch, kv-tile of f_out keys), kv-tiles
// first to last (under causal masking the first are the heaviest).  K and
// V once, Q / dO tiles of f_in rows through the ring.  Transposed: S^T =
// K Q^T, P^T = exp(S^T scale - lse_col) through the buffer, dV += P^T dO;
// dP^T = V dO^T, dS^T = P^T (dP^T - delta_col) scale through the same
// buffer, dK += dS^T Q.  Per query head; the GQA group sum stays outside.
template <int HDP>
__global__ void __launch_bounds__(F_NT)
fa_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dk_h,
                  float* __restrict__ dv_h, int Sq, int Sk, int Hq, int Hkv,
                  int hd, int causal, int window, float scale, int vec) {
  constexpr int BKV = f_out(HDP), R = BKV / 16, DC = HDP / 8;
  constexpr int F_IN = f_in(HDP), J = F_IN / 8;
  constexpr int LDP = f_ldp(HDP), T = F_IN * HDP;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + BKV * HDP;
  float* ring = Vs + BKV * HDP;    // stage st: Q at ring + 2 st T, dO after
  float* Buf = ring + 4 * T;
  const int h = blockIdx.x, b = blockIdx.y, ki = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
  const int k0 = ki * BKV;
  int lo, hi;
  q_range<F_IN, BKV>(ki, (Sq + F_IN - 1) / F_IN, causal, window, &lo, &hi);
  const int n = hi >= lo ? hi - lo + 1 : 0;
  auto load_qdo = [&](int it) {
    float* dst = ring + 2 * (it & 1) * T;
    load_tile<F_IN, HDP>(dst, q, b, (lo + it) * F_IN, Sq, Hq, h, hd, vec);
    load_tile<F_IN, HDP>(dst + T, dout, b, (lo + it) * F_IN, Sq, Hq, h, hd,
                         vec);
  };

  load_tile<BKV, HDP>(Ks, k, b, k0, Sk, Hkv, hk, hd, vec);
  load_tile<BKV, HDP>(Vs, v, b, k0, Sk, Hkv, hk, hd, vec);
  if (n > 0) load_qdo(0);
  cp_async_commit();
  const float* lse_bh = lse + ((int64_t)b * Hq + h) * Sq;
  const float* delta_bh = delta + ((int64_t)b * Hq + h) * Sq;
  float dk[R][DC], dv[R][DC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int it = 0; it < n; ++it) {
    const int q0 = (lo + it) * F_IN;
    // the columns' lse and delta; a query past Sq reads as one that saw no
    // key
    float lse_c[J], dl_c[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int col = q0 + tx + 8 * j;
      lse_c[j] = col < Sq ? lse_bh[col] : LSE_EMPTY;
      dl_c[j] = col < Sq ? delta_bh[col] : 0.f;
    }
    cp_async_wait_all();
    __syncthreads();
    if (it + 1 < n) load_qdo(it + 1);
    cp_async_commit();
    const float* Qt = ring + 2 * (it & 1) * T;
    const float* dOt = Qt + T;

    float s[R][J];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j) s[i][j] = 0.f;
    nt_product<R, J, HDP>(s, Ks, Qt, ty, tx);
    const bool edge = k0 + BKV > Sk || (causal && k0 + BKV - 1 > q0) ||
                      (window > 0 && k0 <= q0 + F_IN - 1 - window);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const bool ok = !edge || visible(q0 + tx + 8 * j, k0 + ty + 16 * i,
                                         Sk, causal, window);
        s[i][j] = ok ? expf(s[i][j] * scale - lse_c[j]) : 0.f;
      }
    x_to_buf<R, J, LDP>(Buf, s, ty, tx);
    __syncwarp();
    nn_product<R, HDP, LDP>(dv, Buf, dOt, ty, tx);     // dV += P^T dO

#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j) s[i][j] = 0.f;
    nt_product<R, J, HDP>(s, Vs, dOt, ty, tx);            // dP^T
    float p[R][J];
    x_from_buf<R, J, LDP>(p, Buf, ty, tx);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j)
        s[i][j] = p[i][j] * (s[i][j] - dl_c[j]) * scale;
    __syncwarp();       // the quarter-warp is done reading P
    x_to_buf<R, J, LDP>(Buf, s, ty, tx);
    __syncwarp();
    nn_product<R, HDP, LDP>(dk, Buf, Qt, ty, tx);      // dK += dS^T Q
  }
  cp_async_wait_all();

  // per-query-head outputs, laid out (B, Sk, Hq, hd)
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= Sk) continue;
    store_row<HDP>(dk_h + row_off(b, row, h, Sk, Hq, hd), dk[i], tx,
                   hd, vec);
    store_row<HDP>(dv_h + row_off(b, row, h, Sk, Hq, hd), dv[i], tx,
                   hd, vec);
  }
}

// ------------------------------------------------------------- launchers
// 16-byte copies need hd % 4 == 0 and 16-byte-aligned operands
static int f_vec(int hd, const void* a, const void* b, const void* c,
                 const void* d = nullptr) {
  auto al = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
  return hd % 4 == 0 && al(a) && al(b) && al(c) && (d == nullptr || al(d));
}

// The kernel's dynamic shared memory, with the carveout set to shared
// memory so that two blocks of the backward fit an SM at hd <= 64.
template <typename K>
static cudaError_t f_attrs(K kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <int HDP>
int launch_fwd(const void* q, const void* k, const void* v, void* out,
               void* lse, void* tiles, int B, int Sq, int Sk, int Hq,
               int Hkv, int hd, int causal, int window, float scale,
               cudaStream_t stream) {
  const size_t smem = f_smem(HDP, 1);
  cudaError_t err = f_attrs(fa_fwd_kernel<HDP>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Hq, B, (Sq + f_out(HDP) - 1) / f_out(HDP));   // q-tiles slowest
  fa_fwd_kernel<HDP><<<grid, F_NT, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out,
      (float*)lse, (int*)tiles, Sq, Sk, Hq, Hkv, hd, causal, window, scale,
      f_vec(hd, q, k, v, out));
  return (int)cudaGetLastError();
}

template <int HDP>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int Sq,
              int Sk, int Hq, int Hkv, int hd, int causal, int window,
              float scale, cudaStream_t stream) {
  const size_t smem = f_smem(HDP, 2);
  cudaError_t err = f_attrs(fa_bwd_dq_kernel<HDP>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Hq, B, (Sq + f_out(HDP) - 1) / f_out(HDP));   // q-tiles slowest
  fa_bwd_dq_kernel<HDP><<<grid, F_NT, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      (const float*)lse, (const float*)delta, (float*)dq, Sq, Sk, Hq, Hkv,
      hd, causal, window, scale,
      f_vec(hd, q, k, v, dout) && f_vec(hd, dq, dq, dq));
  return (int)cudaGetLastError();
}

template <int HDP>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk_h, void* dv_h,
               int B, int Sq, int Sk, int Hq, int Hkv, int hd, int causal,
               int window, float scale, cudaStream_t stream) {
  const size_t smem = f_smem(HDP, 2);
  cudaError_t err = f_attrs(fa_bwd_dkv_kernel<HDP>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Hq, B, (Sk + f_out(HDP) - 1) / f_out(HDP));   // kv-tiles slowest
  fa_bwd_dkv_kernel<HDP><<<grid, F_NT, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      (const float*)lse, (const float*)delta, (float*)dk_h, (float*)dv_h, Sq,
      Sk, Hq, Hkv, hd, causal, window, scale,
      f_vec(hd, q, k, v, dout) && f_vec(hd, dk_h, dv_h, dv_h));
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
    if (hd <= 32) return LAUNCH<32>(__VA_ARGS__);                        \
    if (hd <= 64) return LAUNCH<64>(__VA_ARGS__);                        \
    if (hd <= 128) return LAUNCH<128>(__VA_ARGS__);                      \
    return LAUNCH<256>(__VA_ARGS__);                                     \
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
// fa_bwd_dq (f32) f_out query rows (64; 32 at hd 256) x f_in keys (64 up
// to hd 64, 32 above), fa_bwd_dkv (f32) f_in query rows x f_out keys;
// fa_fwd_tc and fa_bwd_dq_tc (bf16) 128 query rows x 128 keys (hd <= 128)
// or 64; fa_bwd_dkv_tc (bf16) 64 query rows x 128 keys (hd <= 128) or 64.
static int ncb_of(int hd) { return hd <= 64 ? 1 : hd <= 128 ? 2 : 4; }
static int hdp_of(int hd) { return hd <= 32 ? 32 : 64 * ncb_of(hd); }
int fa_block_q(int hd) { return f_out(hdp_of(hd)); }
int fa_block_k(int hd) { return f_in(hdp_of(hd)); }
int fa_fwd_block_q(int hd) { return TC_BQ; }
int fa_fwd_block_k(int hd) { return tc_bk(ncb_of(hd)); }
int fa_dq_tc_block_q(int hd) { return TC_BQ; }
int fa_dq_tc_block_k(int hd) { return tc_bk(ncb_of(hd)); }
int fa_dkv_tc_block_q(int hd) { return DKV_BQ; }
int fa_dkv_tc_block_k(int hd) { return dkv_keys(ncb_of(hd)); }

// f32 only (dtype 0): out (B,Sq,Hq,hd) f32, lse (B,Hq,Sq) f32, tiles
// (B,Hq,ceil(Sq/fa_block_q(hd))) int32 or null (not counted).  Returns
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
