// SSD intra-chunk term for Hopper (sm_90a): forward (B5) and backward (B6),
// hand-written CUDA C++.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/ssd_scan.py:
//   ssd_fwd_tc  <- _ssd_kernel      (ssd_intra_pallas, :46 / :87),
//                  bf16 on the tensor cores
//   ssd_fwd     <- the same, f32 (and bf16 outside ssd_fwd_tc's shapes),
//                  on the CUDA cores
//   ssd_bwd_tc  <- _ssd_bwd_kernel  (ssd_intra_bwd_pallas, :111 / :189),
//                  bf16 on the tensor cores
//   ssd_bwd     <- the same, f32 (and bf16 outside ssd_bwd_tc's shapes),
//                  on the CUDA cores, with ssd_bwd_sum_kernel
//
// What they compute, per (batch * chunk, head) cell, x (B,nc,Q,H,P), dt
// (B,nc,Q,H) f32, cum = cumsum(ltT) (B,nc,H,Q) (taken outside, in torch:
// f64 for ssd_fwd / ssd_bwd, f32 for the _tc kernels), B / C (B,nc,Q,N)
// shared across heads; x, B, C and the cotangent g in one dtype (f32 or
// bf16), f32 math:
//   cb[i,j]   = C_i . B_j
//   decay     = exp(cum_i - cum_j) for j <= i, else 0
//   att       = cb * decay * dt_j
//   ssd_fwd   y = att x                                   (y in x's dtype)
//   ssd_bwd   datt = g x^T, dx = att^T g, dad = datt * decay,
//             ddt_j = sum_i dad * cb, dseg = dad * cb * dt_j,
//             dlt_t = sum of dseg over the pairs j < t <= i,
//             dcb = sum over heads of dad * dt_j, dB = dcb^T C, dC = dcb B
//             (dx in x's dtype, ddt and dlt f32, dB / dC in B's / C's).
//
// Precision of the f32 route.  A chunk's cumulative log-decay reaches about
// -1,000 at mamba2-2.7b's shape, where one f32 ulp is 6e-5: an exponent
// cum_i - cum_j formed in f32 carries that much absolute error, and so
// does every decay.  ssd_fwd and ssd_bwd read cum in f64 and round only
// the difference to f32.  In the backward, the gradient of lt_t is the sum
// of dseg over the pairs that span t (seg_ij = lt_{j+1} + ... + lt_i);
// taken as the suffix sum of rowsum - colsum it adds and takes away every
// pair on one side of t, the diagonal's large terms with them, and keeps
// the difference of sums far larger than itself.  ssd_bwd sums the
// spanning pairs alone: down each column from the bottom, then along each
// row over the columns j < t (below: in its reversed frame).
//
// The exponent is taken only where j <= i.  A chunk's cumulative log-decay
// reaches about -1,000 at mamba2-2.7b's shape, so above the diagonal
// cum_i - cum_j is far above 88 and expf overflows: the TPU kernel's
// where(tril, exp(seg), 0) selects the 0, but a product with a 0 / 1 mask
// would give inf * 0 = NaN.
//
// Determinism: no atomics; every sum is taken in a fixed order, so two
// identical launches give identical bits (the stage-vs-trial check of a
// study is bitwise), and a launch of members folded into the batch axis
// gives each member its own launch's bits (the head grouping is one
// member's).
//
// Bound on an H100 SXM: max(flops / peak, bytes / 3.35 TB/s).  Flops are
// those the function needs: its products and elementwise work over the
// Q(Q+1)/2 pairs j <= i, with cb formed once per cell (it depends on no
// head); bytes count each input read once and each output written once
// (hippo_bench/flops.py, ssd_work).  At mamba2-2.7b-f32's training shape
// (B 2, nc 8, Q 128, H 80, P 64, N 128, f32; the peak 67 TFLOP/s of the
// CUDA cores) the forward is 1.43 GFLOP and 87.3 MB: 26.1 us, bytes-bound;
// the backward 2.93 GFLOP and 132.6 MB: 43.8 us, bound by its operations.
// In bf16 (B 1, nc 16; 989 TFLOP/s on the tensor cores) 44.3 and 67.6 MB:
// 13.2 and 20.2 us, bytes-bound.
//
// ssd_fwd and ssd_bwd: the f32 route (and bf16 outside the tensor cores'
// shapes) on the CUDA cores.  Every product is an f32 FMA: no TF32, no
// split products, no tensor cores.  What the design does about the bound:
//   one block of 256 threads per (cell, group of G heads), G =
//   ssd_scan.py::simt_groups (head_groups up to Q 128: one wave of 128
//   blocks at mamba2's shape), so cb = C B^T, which depends on no head and
//   at Q 128 is two thirds of a head's forward products, is formed once per
//   block;
//   a block works through passes of a causal plane, live where column <=
//   row: rows in groups of 8, columns in strips of 32.  Up to Q 128 one pass
//   holds the chunk and the 8 warps take the row groups in pairs (g, ng -
//   1 - g), so each holds the same causal work; above Q 128 (G 1) a pass is
//   128 rows by 64 columns, cb formed anew for each;
//   each lane holds a 2 x 4 piece of its rows and a strip's columns: cb is
//   formed there once per pass (B and C staged 32 state columns at a time
//   through two buffers) and kept in the lane's own shared slots; B6 forms
//   datt = g x^T on the same pieces (float4 reads of XOR-swizzled tiles:
//   the rows a quarter-warp reads at one chunk meet distinct banks);
//   per head, in head order, its tiles arrive by 16-byte cp.async through a
//   ring of 2 or 3 stages (4-byte where P or N % 4 != 0 or a pointer is
//   not 16-byte aligned) while the last head computes;
//   per strip, the exponent cum_i - cum_j is formed in f64 and rounded
//   once, only where j <= i (elsewhere exp(-inf) = 0: no branch, so a
//   lane's 16 exponentials interleave), att goes to the warp's own buffer
//   (no block barrier), and y = att x (B5) or dx = att^T g (B6) runs on a
//   4 x 4 NPC register piece, 4 rows of the buffer a step;
//   B6 works in the reversed frame (row r = QR - 1 - j, column c = QR - 1 -
//   i): the live pairs i >= j then lie at c <= r, as B5's do, and a
//   column's sums from the bottom run left to right.  dlt sums the spanning
//   pairs: each row's dseg from its first column up (in the lane, over the
//   8 lanes of a strip by a shuffle scan, then the strips and passes
//   before), then over the rows r > c (j < t): the warp's rows by shuffles,
//   the warps in order at the next head's start.  dcb is summed over the
//   group's heads in registers, in head order, and written once per block
//   to a (B nc, ceil(H / G), Q, Q) scratch (8.4 MB at mamba2's shape);
//   ssd_bwd_sum_kernel, 256 blocks, sums it in group order into dB and dC.
// Registers are the limit (one block an SM): cb lives in shared memory, so
// that B6 keeps dcb and dx in registers; at P > 64 dx takes them, and B6
// runs one head a block and writes each pair's dcb as it forms it.
// The times, beside the bound, are in PERF.md.

// ssd_fwd_tc and ssd_bwd_tc (B5 and B6 in bf16; their design notes are
// above their kernels below) are the redesigns for bf16: one wave of
// blocks, each a cell and a group of heads (kernels/ssd_scan.py::
// head_groups, a function of the shape alone), cb formed once per block on
// the tensor cores, the x (and
// g) tiles by TMA, cb and the per-head products by wgmma.  ssd_fwd_tc
// keeps cb in registers, forms att on cb's accumulator, and spreads the
// causal work evenly over the warps.  ssd_bwd_tc partitions the dcb head sum: summed
// within the group in registers, in head order, written once per block to
// a (B nc, ceil(H / G), Q, Q) scratch (8.4 MB at the shape above) that a
// second kernel of 256 blocks sums in group order into dB and dC.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename E> __device__ __forceinline__ E from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename K>
int set_smem(K kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Asynchronous copies into shared memory (sm_80+) of 16, 8 or 4 bytes;
// where `in` is false nothing is read and the destination is zero-filled.
__device__ __forceinline__ void cpa16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cpa8(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 8 : 0)
               : "memory");
}
__device__ __forceinline__ void cpa4(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cpa_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cpa_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------ B5 and B6, f32, CUDA cores
// The pass geometry (the design note at the head of the file): a pass is
// rows [r0, r0 + R) against columns [c0, c0 + W) of a causal plane (live
// where column <= row), in groups of 8 rows and strips of 32 columns.
constexpr int NT = 256;          // threads a block: 8 warps
constexpr int SLAB = 128;        // rows of one pass at most
constexpr int QMAX = 256;        // chunk rows the route takes
constexpr int NC = 32;           // state columns staged at once to form cb
constexpr int BUF_LD = 20;       // floats a row of a warp's att buffer
constexpr int BUF = 32 * BUF_LD;  // floats of one warp's att buffer
constexpr int CB_SLOTS = 48;     // a lane's cb values: 2 x 8 (a), 4 x 8 (b)
constexpr int KEY_ROW = 0;       // a tile read by rows 2 ty + e (+ 8 g)
constexpr int KEY_COL = 1;       // a tile read by rows 4 tx + q (+ 32 s)

// Shared memory of a block: STAGES stages of the per-head tiles (B5: x;
// B6: x, then g) with the head's cum (f64) and dt, the staging of B and C
// for cb over the last stage, the 8 warps' att buffers, (B6) the dlt sums
// of two heads, and each lane's cb (its registers go to the products).
template <int NPC, bool BWD>
struct Simt {
  static constexpr int PW = 32 * NPC;               // P, padded
  static constexpr int STAGES = BWD ? (NPC > 2 ? 1 : 2) : (NPC > 2 ? 2 : 3);
  static constexpr size_t TILE = (size_t)SLAB * PW * 4;
  static constexpr size_t STAGE = (BWD ? 2 : 1) * TILE + 12 * QMAX;
  static constexpr size_t STAGING = 2 * 2 * SLAB * NC * 4;
  static constexpr size_t LAST = STAGE > STAGING ? STAGE : STAGING;
  static constexpr size_t BUFS = 8 * BUF * 4;
  static constexpr size_t RED = BWD ? 2 * 8 * QMAX * 4 : 0;
  static constexpr size_t CBS = (size_t)NT * CB_SLOTS * 4;
  static constexpr size_t SMEM =
      (STAGES - 1) * STAGE + LAST + BUFS + RED + CBS;

  __device__ static float* tile(unsigned char* s, int st, int which) {
    return reinterpret_cast<float*>(s + st * STAGE + which * TILE);
  }
  __device__ static double* cum(unsigned char* s, int st) {
    return reinterpret_cast<double*>(s + st * STAGE + (BWD ? 2 : 1) * TILE);
  }
  __device__ static float* dt(unsigned char* s, int st) {
    return reinterpret_cast<float*>(cum(s, st) + QMAX);
  }
  __device__ static float* staging(unsigned char* s) {
    return reinterpret_cast<float*>(s + (STAGES - 1) * STAGE);
  }
  __device__ static float* bufs(unsigned char* s) {
    return reinterpret_cast<float*>(s + (STAGES - 1) * STAGE + LAST);
  }
  __device__ static float* red(unsigned char* s) {
    return reinterpret_cast<float*>(s + (STAGES - 1) * STAGE + LAST + BUFS);
  }
  __device__ static float* cbs(unsigned char* s) {   // [8][CB_SLOTS][32]
    return red(s) + RED / 4;
  }
};

// A tile's row r stores its 16-byte chunk k at chunk k ^ tile_key(r): the
// 4 rows 2 ty + e of a row-keyed tile, or the 8 rows 4 tx + q of a
// column-keyed one, that a quarter-warp reads at one chunk meet distinct
// bank groups, and so do the 8 chunks 8 c + tx of one row.
template <int KEY>
__device__ __forceinline__ int tile_key(int r) {
  return KEY == KEY_ROW ? (r & 7) : ((r >> 2) & 7);
}

__device__ __forceinline__ float minus_inf() {   // expf(-inf) = 0
  return __int_as_float(0xff800000);
}
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float fma4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

// 4 floats into dst (16-byte aligned), `n` of them (0..4) from src, the
// rest 0: f32 by cp.async (one 16-byte copy where vec, n then 0 or 4, else
// four 4-byte ones); bf16 read and widened by the thread.
__device__ __forceinline__ void put4(float* dst, const float* src, int n,
                                     bool vec) {
  if (vec) {
    cpa16(dst, src, n > 0);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) cpa4(dst + e, src + (e < n ? e : 0), e < n);
  }
}
__device__ __forceinline__ void put4(float* dst, const __nv_bfloat16* src,
                                     int n, bool) {
  float v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = e < n ? __bfloat162float(src[e]) : 0.f;
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}

// Rows t < rows of a tile of W floats a row (W a multiple of 32, keyed by
// KEY): row t holds row q = first + dir t of a matrix whose row q starts at
// src + q ld, its columns [0, ncol); rows with q outside [0, Q) and the
// columns past ncol read 0.  Issued by all NT threads (cp.async for f32).
template <int KEY, typename E>
__device__ __forceinline__ void load_tile(float* dst, int W, int rows,
                                          const E* src, int64_t ld, int first,
                                          int dir, int Q, int ncol, bool vec) {
  const int CH = W >> 2;
  for (int idx = threadIdx.x; idx < rows * CH; idx += NT) {
    const int t = idx / CH, k = idx - t * CH, q = first + dir * t;
    const int n = q >= 0 && q < Q ? min(4, max(0, ncol - 4 * k)) : 0;
    put4(dst + t * W + ((k ^ tile_key<KEY>(t)) << 2),
         n > 0 ? src + q * ld + 4 * k : src, n, vec);
  }
}

// Head h's cum (f64) and dt at positions [0, Q rounded up to 32), 0 past Q.
__device__ __forceinline__ void load_vecs(double* scum, float* sdt,
                                          const double* cum, const float* dt,
                                          int64_t bc, int h, int Q, int H) {
  const int QP = (Q + 31) & ~31;
  for (int q = threadIdx.x; q < QP; q += NT) {
    const bool in = q < Q;
    cpa8(scum + q, in ? cum + (bc * H + h) * Q + q : cum, in);
    cpa4(sdt + q, in ? dt + (bc * Q + q) * H + h : dt, in);
  }
}

// p0[e][q] (p1[e][q]) += sum over the first nq 16-byte chunks k of A row
// a0 + e (a1 + e) times B row b0 + q, in chunk order: the lane's 2 x 4
// pieces of one or two row groups in one column strip.  A is row-keyed, B
// column-keyed; b0 is a multiple of 4.
template <int NG>
__device__ __forceinline__ void nt_piece(float (&p0)[2][4], float (&p1)[2][4],
                                         const float* __restrict__ A, int lda,
                                         int a0, int a1,
                                         const float* __restrict__ B, int ldb,
                                         int b0, int nq) {
  const int kb = tile_key<KEY_COL>(b0);
  const float* bp = B + b0 * ldb;
#pragma unroll 1
  for (int k = 0; k < nq; ++k) {
    float4 av[2][2], bv[4];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      av[0][e] = ld4(A + (a0 + e) * lda +
                     ((k ^ tile_key<KEY_ROW>(a0 + e)) << 2));
      if (NG == 2)
        av[1][e] = ld4(A + (a1 + e) * lda +
                       ((k ^ tile_key<KEY_ROW>(a1 + e)) << 2));
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) bv[q] = ld4(bp + q * ldb + ((k ^ kb) << 2));
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        p0[e][q] = fma4(av[0][e], bv[q], p0[e][q]);
        if (NG == 2) p1[e][q] = fma4(av[1][e], bv[q], p1[e][q]);
      }
  }
}

// The lane's 4 slots (4 ty .. 4 ty + 3) of row k of a warp's att buffer:
// rows of 5 chunks, a row's chunk ty at (ty ^ (k / 8) % 4), so that the
// 8 lanes 4 tx + q that write one chunk of 8 rows meet distinct banks.
__device__ __forceinline__ float* slots(float* wb, int k, int ty) {
  return wb + k * BUF_LD + ((ty ^ ((k >> 3) & 3)) << 2);
}
__device__ __forceinline__ const float* slots(const float* wb, int k,
                                              int ty) {
  return wb + k * BUF_LD + ((ty ^ ((k >> 3) & 3)) << 2);
}

// acc[n][4 c + e] += sum over the buffer's rows k < kB of the lane's slot n
// of row k (slots 0-3 for k < kA, 2-3 after) times row rb + k of the
// column-keyed tile B at column 32 c + 4 tx + e, in row order; U rows a
// step, their loads issued together.
template <int NPC, int U>
__device__ __forceinline__ void nn_strip(float (&acc)[4][4 * NPC],
                                         const float* __restrict__ wb,
                                         const float* __restrict__ B, int ldb,
                                         int rb, int kA, int kB, int ty,
                                         int tx) {
  static_assert(U == 1 || U == 2 || U == 4, "rows a step: one chunk key");
  // rows k .. k + n - 1 (n <= U, one chunk key) into the lane's slots n0..
  auto step = [&](int k, int n, int n0) {
    const float* ap = slots(wb, k, ty) + n0;
    const int kr = tile_key<KEY_COL>(rb + k);
    const float* bp = B + (rb + k) * ldb;
    float4 a[U], bv[U][NPC];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (u < n) {
        a[u] = n0 == 0 ? ld4(ap + u * BUF_LD)
                       : make_float4(ap[u * BUF_LD], ap[u * BUF_LD + 1], 0.f,
                                     0.f);
#pragma unroll
        for (int c = 0; c < NPC; ++c)
          bv[u][c] = ld4(bp + u * ldb + (((tx + 8 * c) ^ kr) << 2));
      }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (u < n)
#pragma unroll
        for (int c = 0; c < NPC; ++c) {
          const float b4[4] = {bv[u][c].x, bv[u][c].y, bv[u][c].z,
                               bv[u][c].w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (n0 == 0) {
              acc[0][4 * c + e] = fmaf(a[u].x, b4[e], acc[0][4 * c + e]);
              acc[1][4 * c + e] = fmaf(a[u].y, b4[e], acc[1][4 * c + e]);
              acc[2][4 * c + e] = fmaf(a[u].z, b4[e], acc[2][4 * c + e]);
              acc[3][4 * c + e] = fmaf(a[u].w, b4[e], acc[3][4 * c + e]);
            } else {
              acc[2][4 * c + e] = fmaf(a[u].x, b4[e], acc[2][4 * c + e]);
              acc[3][4 * c + e] = fmaf(a[u].y, b4[e], acc[3][4 * c + e]);
            }
          }
        }
  };
  int k = 0;
  for (; k + U <= kA; k += U) step(k, U, 0);
  for (; k < kA; ++k) step(k, 1, 0);
  for (; k < kB && (k & (U - 1)); ++k) step(k, 1, 2);
  for (; k + U <= kB; k += U) step(k, U, 2);
  for (; k < kB; ++k) step(k, 1, 2);
}

// The lane's 4 values of one buffer row (slots 4 ty .. 4 ty + 3).
__device__ __forceinline__ void put_slots(float* wb, int k, int ty,
                                          const float (&v)[4]) {
  *reinterpret_cast<float4*>(slots(wb, k, ty)) =
      make_float4(v[0], v[1], v[2], v[3]);
}

// The lane's columns 32 c + 4 tx + e (below P) of a row of y or dx.
template <int NPC>
__device__ __forceinline__ void store_row(float* dst,
                                          const float (&a)[4 * NPC], int tx,
                                          int P, bool vec) {
#pragma unroll
  for (int c = 0; c < NPC; ++c) {
    const int p = 32 * c + 4 * tx;
    if (vec) {
      if (p < P)
        *reinterpret_cast<float4*>(dst + p) = make_float4(
            a[4 * c], a[4 * c + 1], a[4 * c + 2], a[4 * c + 3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (p + e < P) dst[p + e] = a[4 * c + e];
    }
  }
}
template <int NPC>
__device__ __forceinline__ void store_row(__nv_bfloat16* dst,
                                          const float (&a)[4 * NPC], int tx,
                                          int P, bool) {
#pragma unroll
  for (int c = 0; c < NPC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = 32 * c + 4 * tx + e;
      if (p < P) dst[p] = __float2bfloat16_rn(a[4 * c + e]);
    }
}

// One warp's share of a pass: row groups ga (short) and gb (long) of 8 rows;
// the lane's rows ra + e and rb + e (e = 0, 1); the groups' column ends.
// One pass (Q <= 128): group g and ng - 1 - g, so every warp holds the same
// causal work; passes of 64 columns (Q > 128): groups w and w + 8.
struct Share {
  int ga, gb, ra, rb, endA, endB;
  bool va, vb;
  __device__ Share(int w, int ty, int r0, int R, int c0, int W, bool multi) {
    const int ng = (R + 7) >> 3;
    ga = w;
    gb = multi ? w + 8 : ng - 1 - w;
    va = multi ? ga < ng : ga <= gb;
    vb = multi ? gb < ng : gb > ga;
    ra = r0 + 8 * ga + 2 * ty;
    rb = r0 + 8 * gb + 2 * ty;
    endA = va ? min(c0 + W, r0 + 8 * ga + 8) : c0;
    endB = vb ? min(c0 + W, r0 + 8 * gb + 8) : c0;
  }
  // strip s (columns [c0 + 32 s, + 32)) holds live pairs of group a / b
  __device__ bool la(int c0, int s) const {
    return va && s < 2 && c0 + 32 * s < endA;
  }
  __device__ bool lb(int c0, int s) const { return vb && c0 + 32 * s < endB; }
  __device__ int row(int n) const { return (n < 2 ? ra : rb) + (n & 1); }
  __device__ bool valid(int n) const { return n < 2 ? va : vb; }
};

// cb over the pass's live pieces into the lane's registers (cbA: strips
// 0-1 of group a, cbB: strips 0-3 of group b): sum over N of A row (the
// pass's row r: matrix row rowA0 + rdir (r - r0)) times B row (column c:
// matrix row colB0 + cdir (c - c0)), staged NC columns at a time through
// two buffers.  B5: A = C, B = B; B6 (reversed frame): A = B, B = C.
template <typename E>
__device__ __forceinline__ void form_cb(float (&cbA)[2][2][4],
                                        float (&cbB)[4][2][4], float* stg,
                                        const E* Am, const E* Bm, int64_t bc,
                                        int Q, int N, int r0, int R,
                                        int rowA0, int c0, int W, int colB0,
                                        int dir, const Share& sh, int tx,
                                        bool vec) {
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int s = 0; s < 2; ++s) cbA[s][e][q] = 0.f;
#pragma unroll
      for (int s = 0; s < 4; ++s) cbB[s][e][q] = 0.f;
    }
  const int nch = (N + NC - 1) / NC;
  const E* Ab = Am + bc * Q * N;
  const E* Bb = Bm + bc * Q * N;
  auto stage = [&](int ch) {
    float* sa = stg + (ch & 1) * 2 * SLAB * NC;
    const int n0 = ch * NC;
    // every row a lane reads: the row groups' and the strips' (0 past Q)
    load_tile<KEY_ROW>(sa, NC, (R + 7) & ~7, Ab + n0, N, rowA0, dir, Q,
                       N - n0, vec);
    load_tile<KEY_COL>(sa + SLAB * NC, NC, (W + 31) & ~31, Bb + n0, N, colB0,
                       dir, Q, N - n0, vec);
    cpa_commit();
  };
  stage(0);
  for (int ch = 0; ch < nch; ++ch) {
    if (ch + 1 < nch) {
      stage(ch + 1);
      cpa_wait<1>();
    } else {
      cpa_wait<0>();
    }
    __syncthreads();
    const float* sa = stg + (ch & 1) * 2 * SLAB * NC;
    const float* sb = sa + SLAB * NC;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const bool la = sh.la(c0, s), lb = sh.lb(c0, s);
      const int b0 = 32 * s + 4 * tx;
      if (la && lb)
        nt_piece<2>(cbA[s & 1], cbB[s], sa, NC, sh.ra - r0, sh.rb - r0, sb,
                    NC, b0, NC / 4);
      else if (la)
        nt_piece<1>(cbA[s & 1], cbA[s & 1], sa, NC, sh.ra - r0, sh.ra - r0,
                    sb, NC, b0, NC / 4);
      else if (lb)
        nt_piece<1>(cbB[s], cbB[s], sa, NC, sh.rb - r0, sh.rb - r0, sb, NC,
                    b0, NC / 4);
    }
    __syncthreads();                 // the buffer is refilled two chunks on
  }
}

// The slot of the lane's cb value (strip s, row n, column q) in B6's
// shared copy: group a's 16, then group b's 32.
__device__ __forceinline__ int cb_slot(int s, int n, int q) {
  return n < 2 ? ((s & 1) * 2 + n) * 4 + q : 16 + (s * 2 + (n & 1)) * 4 + q;
}

__device__ __forceinline__ float& piece(float (&A)[2][2][4],
                                        float (&B)[4][2][4], int s, int n,
                                        int q) {
  return n < 2 ? A[s & 1][n & 1][q] : B[s][n & 1][q];
}

// The lane's cb values into its shared slots (a lane reads back only its
// own, so no barrier orders the two).
__device__ __forceinline__ void keep_cb(float* cbl, float (&cbA)[2][2][4],
                                        float (&cbB)[4][2][4]) {
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (n >= 2 || s < 2)
          cbl[cb_slot(s, n, q) * 32] = piece(cbA, cbB, s, n, q);
}

// ---------------------------------------------------------------- B5
// grid (ceil(H / G), B nc).  Writes y.
template <typename E, int NPC>
__global__ void __launch_bounds__(NT, 1)
ssd_fwd_simt_kernel(const E* __restrict__ x, const float* __restrict__ dt,
                    const double* __restrict__ cum, const E* __restrict__ Bm,
                    const E* __restrict__ Cm, E* __restrict__ y, int Q, int H,
                    int P, int N, int G, int vec) {
  using L = Simt<NPC, false>;
  constexpr int PW = L::PW;
  extern __shared__ __align__(16) unsigned char smem[];
  const int h0 = blockIdx.x * G, nh = min(G, H - h0);
  const int64_t bc = blockIdx.y;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ty = lane >> 3, tx = lane & 7;
  float* wb = L::bufs(smem) + w * BUF;
  float* cbl = L::cbs(smem) + w * CB_SLOTS * 32 + lane;  // cb[slot * 32]
  const bool multi = Q > SLAB;
  const int64_t ldx = (int64_t)H * P;
  const E* xb = x + bc * Q * ldx;
  E* yb = y + bc * Q * ldx;

  float acc[4][4 * NPC];
  for (int r0 = 0; r0 < Q; r0 += SLAB) {
    const int R = min(SLAB, Q - r0);
    const int n_half = multi ? (min(r0 + SLAB, Q) + 63) / 64 : 1;
    for (int hh = 0; hh < n_half; ++hh) {
      const int c0 = multi ? 64 * hh : 0, W = multi ? min(64, Q - c0) : Q;
      const Share sh(w, ty, r0, R, c0, W, multi);
      auto load_head = [&](int k, int st) {   // x rows c0 .. c0 + W - 1
        load_tile<KEY_COL>(L::tile(smem, st, 0), PW, W,
                           xb + (int64_t)(h0 + k) * P, ldx, c0, 1, Q, P,
                           vec & 1);
        load_vecs(L::cum(smem, st), L::dt(smem, st), cum, dt, bc, h0 + k, Q,
                  H);
        cpa_commit();
      };
      __syncthreads();               // the last pass's readers are done
      for (int k = 0; k < L::STAGES - 1 && k < nh; ++k) load_head(k, k);
      {                              // cb into the lane's shared slots
        float cbA[2][2][4], cbB[4][2][4];
        form_cb(cbA, cbB, L::staging(smem), Cm, Bm, bc, Q, N, r0, R, r0, c0,
                W, c0, 1, sh, tx, vec & 2);
        keep_cb(cbl, cbA, cbB);
      }

      for (int k = 0; k < nh; ++k) {
        const int st = k % L::STAGES;
        if (L::STAGES == 1) {
          __syncthreads();
          load_head(k, 0);
        }
        if (L::STAGES == 3 && k + 1 < nh)
          cpa_wait<1>();             // head k + 1 may stay in flight
        else
          if (L::STAGES == 3 && k + 1 < nh)
          cpa_wait<1>();             // head k + 1 may stay in flight
        else
          cpa_wait<0>();
        __syncthreads();             // head k in place, head k - 1 done
        if (L::STAGES > 1 && k + L::STAGES - 1 < nh)
          load_head(k + L::STAGES - 1, (k + L::STAGES - 1) % L::STAGES);
        const float* xt = L::tile(smem, st, 0);
        const double* sc = L::cum(smem, st);
        const float* sd = L::dt(smem, st);
        double ci[4];
#pragma unroll
        for (int n = 0; n < 4; ++n) ci[n] = sc[min(sh.row(n), QMAX - 1)];
        if (hh == 0) {
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int p = 0; p < 4 * NPC; ++p) acc[n][p] = 0.f;
        }
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int cs = c0 + 32 * s;
          const bool la = sh.la(c0, s), lb = sh.lb(c0, s);
          if (!la && !lb) continue;
          // att = cb exp(cum_i - cum_j) dt_j, the exponent formed in f64
          // and taken only where j <= i; into the buffer, row j - cs
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int j = cs + 4 * tx + q;
            const double cj = sc[j];
            const float dj = sd[j];
            float v[4];
#pragma unroll
            for (int n = 0; n < 4; ++n) {   // no branch: the 16 interleave
              const bool live = (n < 2 ? la : lb) && j <= sh.row(n);
              const float e = expf(live ? (float)(ci[n] - cj) : minus_inf());
              v[n] = cbl[cb_slot(s, n, q) * 32] * e * dj;
            }
            put_slots(wb, 4 * tx + q, ty, v);
          }
          __syncwarp();
          const int kA = la ? min(32, sh.endA - cs) : 0;
          const int kB = max(kA, lb ? min(32, sh.endB - cs) : 0);
          nn_strip<NPC, NPC <= 2 ? 4 : 2>(acc, wb, xt, PW, 32 * s, kA, kB, ty,
                                          tx);
          __syncwarp();              // the buffer is rewritten next strip
        }
        if (hh == n_half - 1) {
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const int i = sh.row(n);
            if (sh.valid(n) && i < r0 + R)
              store_row<NPC>(yb + (int64_t)i * ldx + (int64_t)(h0 + k) * P,
                             acc[n], tx, P, vec & 1);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------- B6
// grid (ceil(H / G), B nc).  Writes dx, ddt, dlt and the group's dcb^T,
// summed over its heads in head order, to part (B nc, ceil(H / G), Q, Q).
// It works in the reversed frame: row r is position j = QR - 1 - r, column
// c is i = QR - 1 - c (QR: Q rounded up to 32), so that the live pairs i >=
// j lie at c <= r as B5's do, and a column's sums from the bottom run
// left to right.
template <typename E, int NPC>
__global__ void __launch_bounds__(NT, 1)
ssd_bwd_simt_kernel(const E* __restrict__ x, const float* __restrict__ dt,
                    const double* __restrict__ cum, const E* __restrict__ Bm,
                    const E* __restrict__ Cm, const E* __restrict__ g,
                    E* __restrict__ dx, float* __restrict__ ddt,
                    float* __restrict__ dlt, float* __restrict__ part, int Q,
                    int H, int P, int N, int G, int vec) {
  using L = Simt<NPC, true>;
  constexpr int PW = L::PW;
  extern __shared__ __align__(16) unsigned char smem[];
  const int h0 = blockIdx.x * G, nh = min(G, H - h0);
  const int64_t bc = blockIdx.y;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ty = lane >> 3, tx = lane & 7;
  float* wb = L::bufs(smem) + w * BUF;
  float* red = L::red(smem);         // [2 heads][8 warps][QMAX]
  float* cbl = L::cbs(smem) + w * CB_SLOTS * 32 + lane;  // cb[slot * 32]
  const int QR = (Q + 31) & ~31, lo = QR - Q;   // columns below lo: i >= Q
  const bool multi = Q > SLAB;
  const int64_t ldx = (int64_t)H * P;
  const E* xb = x + bc * Q * ldx;
  const E* gb = g + bc * Q * ldx;
  E* dxb = dx + bc * Q * ldx;
  float* pb = part + ((int64_t)bc * gridDim.x + blockIdx.x) * Q * Q;
  const int nq = (P + 3) >> 2;

  for (int idx = threadIdx.x; idx < 2 * 8 * QMAX; idx += NT) red[idx] = 0.f;
  // dlt_t = the sum over the warps of red[w][QR - 1 - t], then red is 0
  auto flush = [&](int k) {
    float* rd = red + (k & 1) * 8 * QMAX;
    for (int c = threadIdx.x; c < QR; c += NT) {
      float s = 0.f;
#pragma unroll
      for (int ww = 0; ww < 8; ++ww) {
        s += rd[ww * QMAX + c];
        rd[ww * QMAX + c] = 0.f;
      }
      if (c >= lo) dlt[(bc * H + h0 + k) * Q + (QR - 1 - c)] = s;
    }
  };
  int pend = -1;                     // a head whose dlt waits in red

  float dxa[4][4 * NPC], ddp[4], carry[4];
  for (int r0 = 0; r0 < QR; r0 += SLAB) {
    const int R = min(SLAB, QR - r0);
    const int n_half = multi ? (min(r0 + SLAB, QR) + 63) / 64 : 1;
    for (int hh = 0; hh < n_half; ++hh) {
      const int c0 = multi ? 64 * hh : 0, W = multi ? min(64, QR - c0) : QR;
      const bool last = hh == n_half - 1 && r0 + SLAB >= QR;
      const Share sh(w, ty, r0, R, c0, W, multi);
      auto load_head = [&](int k, int st) {   // x rows j, g rows i
        const int64_t hp = (int64_t)(h0 + k) * P;
        load_tile<KEY_ROW>(L::tile(smem, st, 0), PW, R, xb + hp, ldx,
                           QR - 1 - r0, -1, Q, P, vec & 1);
        load_tile<KEY_COL>(L::tile(smem, st, 1), PW, W, gb + hp, ldx,
                           QR - 1 - c0, -1, Q, P, vec & 1);
        load_vecs(L::cum(smem, st), L::dt(smem, st), cum, dt, bc, h0 + k, Q,
                  H);
        cpa_commit();
      };
      __syncthreads();
      for (int k = 0; k < L::STAGES - 1 && k < nh; ++k) load_head(k, k);
      // dcb summed over the group's heads in registers; at P > 64 (G 1: dx
      // takes those registers) each pair's value goes straight to part
      constexpr bool GROUPED = NPC <= 2;
      float dcA[2][2][4], dcB[4][2][4];
      {                              // cb into the lane's shared slots
        float cbA[2][2][4], cbB[4][2][4];
        form_cb(cbA, cbB, L::staging(smem), Bm, Cm, bc, Q, N, r0, R,
                QR - 1 - r0, c0, W, QR - 1 - c0, -1, sh, tx, vec & 2);
        keep_cb(cbl, cbA, cbB);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int s = 0; s < 2; ++s) dcA[s][e][q] = 0.f;
#pragma unroll
          for (int s = 0; s < 4; ++s) dcB[s][e][q] = 0.f;
        }

      for (int k = 0; k < nh; ++k) {
        const int st = k % L::STAGES;
        const int h = h0 + k;
        if (L::STAGES == 1) {
          __syncthreads();
          load_head(k, 0);
        }
        cpa_wait<0>();
        __syncthreads();             // head k in place, head k - 1 done
        if (pend >= 0) {
          flush(pend);
          pend = -1;
        }
        if (L::STAGES > 1 && k + L::STAGES - 1 < nh)
          load_head(k + L::STAGES - 1, (k + L::STAGES - 1) % L::STAGES);
        const float* xt = L::tile(smem, st, 0);
        const float* gt = L::tile(smem, st, 1);
        const double* sc = L::cum(smem, st);
        const float* sd = L::dt(smem, st);
        float* rd = red + (k & 1) * 8 * QMAX + w * QMAX;
        int jr[4];                   // the rows' positions j (clamped)
        float dj[4];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          jr[n] = max(QR - 1 - sh.row(n), 0);
          dj[n] = sd[jr[n]];
        }
        if (hh == 0) {
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            ddp[n] = carry[n] = 0.f;
#pragma unroll
            for (int p = 0; p < 4 * NPC; ++p) dxa[n][p] = 0.f;
          }
        }
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int cs = c0 + 32 * s;
          const bool la = sh.la(c0, s), lb = sh.lb(c0, s);
          if (!la && !lb) continue;
          // datt^T = x g^T on the lane's pieces
          float pa[2][4], pbb[2][4];
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int q = 0; q < 4; ++q) pa[e][q] = pbb[e][q] = 0.f;
          const int b0 = 32 * s + 4 * tx;
          // (P > 64: one group at a time, so that dx keeps its registers)
          if (la && lb && NPC <= 2) {
            nt_piece<2>(pa, pbb, xt, PW, sh.ra - r0, sh.rb - r0, gt, PW, b0,
                        nq);
          } else {
            if (la)
              nt_piece<1>(pa, pa, xt, PW, sh.ra - r0, sh.ra - r0, gt, PW, b0,
                          nq);
            if (lb)
              nt_piece<1>(pbb, pbb, xt, PW, sh.rb - r0, sh.rb - r0, gt, PW,
                          b0, nq);
          }
          // decay (the exponent in f64, taken only where i >= j), att into
          // the buffer, dad, ddt's row sums, dseg, dcb summed over heads.
          // dlt: each row's dseg summed from its first column (the bottom
          // of a column of the (i, j) plane) up to c, over the rows r > c
          // (j < t), spanning pair by spanning pair: loc, the lane's own
          // columns so far; base, the row's columns left of the lane's (the
          // 8 lanes of the row group by a shuffle scan, and carry, the
          // strips and passes before)
          float loc[4] = {0.f, 0.f, 0.f, 0.f}, v[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int c = cs + 4 * tx + q;
            const double ci = sc[QR - 1 - c];
            float at[4];
            v[q] = 0.f;
#pragma unroll
            for (int n = 0; n < 4; ++n) {   // no branch: dead pairs add 0
              const bool live =
                  (n < 2 ? la : lb) && c <= sh.row(n) && c >= lo;
              const float cb = cbl[cb_slot(s, n, q) * 32];
              const float dec =
                  expf(live ? (float)(ci - sc[jr[n]]) : minus_inf());
              const float djn = dj[n];
              at[n] = cb * dec * djn;
              const float dad = (n < 2 ? pa : pbb)[n & 1][q] * dec;
              const float tq = dad * cb;
              ddp[n] += tq;
              loc[n] += tq * djn;
              if (GROUPED)
                piece(dcA, dcB, s, n, q) += dad * djn;
              else if (live)
                pb[(int64_t)jr[n] * Q + (QR - 1 - c)] = dad * djn;
              if (sh.valid(n) && sh.row(n) > c && c >= lo) v[q] += loc[n];
            }
            put_slots(wb, 4 * tx + q, ty, at);
          }
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            float inc = loc[n];
#pragma unroll
            for (int off = 1; off < 8; off <<= 1) {
              const float o = __shfl_up_sync(0xffffffffu, inc, off, 8);
              if (tx >= off) inc += o;
            }
            float ex = __shfl_up_sync(0xffffffffu, inc, 1, 8);
            if (tx == 0) ex = 0.f;
            const float base = carry[n] + ex;
            carry[n] += __shfl_sync(0xffffffffu, inc, 7, 8);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int c = cs + 4 * tx + q;
              if (sh.valid(n) && sh.row(n) > c && c >= lo) v[q] += base;
            }
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int c = cs + 4 * tx + q;
            float u = v[q];
            u += __shfl_xor_sync(0xffffffffu, u, 8);
            u += __shfl_xor_sync(0xffffffffu, u, 16);
            if (ty == 0 && c >= lo) rd[c] += u;
          }
          __syncwarp();
          // dx = att^T g over the strip's columns i
          const int kA = la ? min(32, sh.endA - cs) : 0;
          const int kB = max(kA, lb ? min(32, sh.endB - cs) : 0);
          nn_strip<NPC, NPC <= 2 ? 4 : NPC == 3 ? 2 : 1>(dxa, wb, gt, PW,
                                                       32 * s, kA, kB, ty,
                                                       tx);
          __syncwarp();
        }
        if (hh == n_half - 1) {      // the rows' dx and ddt are complete
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            float v = ddp[n];
            v += __shfl_xor_sync(0xffffffffu, v, 1);
            v += __shfl_xor_sync(0xffffffffu, v, 2);
            v += __shfl_xor_sync(0xffffffffu, v, 4);
            const int r = sh.row(n), j = QR - 1 - r;
            if (!sh.valid(n) || r >= r0 + R || j >= Q) continue;
            if (tx == 0) ddt[(bc * Q + j) * H + h] = v;
            store_row<NPC>(dxb + (int64_t)j * ldx + (int64_t)h * P, dxa[n],
                           tx, P, vec & 1);
          }
        }
        if (last) pend = k;
      }
      // the group's dcb^T on this pass's live pairs
#pragma unroll
      for (int s = 0; s < 4 && GROUPED; ++s) {
        const int cs = c0 + 32 * s;
        const bool la = sh.la(c0, s), lb = sh.lb(c0, s);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int c = cs + 4 * tx + q;
#pragma unroll
          for (int n = 0; n < 4; ++n)
            if ((n < 2 ? la : lb) && c <= sh.row(n) && c >= lo)
              pb[(int64_t)(QR - 1 - sh.row(n)) * Q + (QR - 1 - c)] =
                  piece(dcA, dcB, s, n, q);
        }
      }
    }
  }
  __syncthreads();
  if (pend >= 0) flush(pend);
}

// grid (ceil(Q / 16), 2, B nc).  which 0: dC rows i in [r0, r0 + 16),
// dC_i = sum_j dcb[i][j] B_j; which 1: dB rows j, dB_j = sum_i dcb[i][j]
// C_i; dcb = the sum of the n_grp partials (dcb^T, live where i >= j) in
// group order.  N in chunks of 128 columns.
constexpr int SUM_ROWS = 16;
constexpr int SUM_NCH = 128;

__host__ __device__ constexpr size_t sum_smem(int Q, int N) {
  return sizeof(float) * ((size_t)SUM_ROWS * ((Q + 3) & ~3) +
                          (size_t)((Q + 3) & ~3) *
                              (N < SUM_NCH ? N : SUM_NCH));
}

template <typename E>
__global__ void __launch_bounds__(NT)
ssd_bwd_sum_kernel(const float* __restrict__ part, const E* __restrict__ Bm,
                   const E* __restrict__ Cm, E* __restrict__ dB,
                   E* __restrict__ dC, int Q, int N, int n_grp) {
  extern __shared__ __align__(16) float hs_f[];
  const int QP = (Q + 3) & ~3, NCH = min(N, SUM_NCH);
  float* S = hs_f;                   // [SUM_ROWS][QP]  the rows' dcb slab
  float* M = S + SUM_ROWS * QP;      // [QP][NCH]  B (which 0) or C (which 1)
  const int which = blockIdx.y, r0 = blockIdx.x * SUM_ROWS;
  const int64_t bc = blockIdx.z;
  const int tid = threadIdx.x;
  const float* Pb = part + bc * n_grp * (int64_t)Q * Q;
  for (int idx = tid; idx < SUM_ROWS * QP; idx += NT) {
    int r, c;
    if (which) { r = idx / QP; c = idx % QP; }             // a row of dcb^T
    else { c = idx / SUM_ROWS; r = idx % SUM_ROWS; }       // a column
    const int row = r0 + r;
    float s = 0.f;
    // which 1: (j, i) = (row, c), live i >= j; which 0: (j, i) = (c, row)
    if (row < Q && c < Q && (which ? c >= row : c <= row)) {
      const int64_t off = which ? (int64_t)row * Q + c : (int64_t)c * Q + row;
#pragma unroll 8
      for (int gi = 0; gi < n_grp; ++gi) s += Pb[gi * (int64_t)Q * Q + off];
    }
    S[r * QP + c] = s;
  }
  const E* Mg = (which ? Cm : Bm) + bc * Q * N;
  E* out = (which ? dB : dC) + bc * Q * N;
  const int rg = (tid >> 7) * (SUM_ROWS / 2);
  for (int n0 = 0; n0 < N; n0 += NCH) {
    __syncthreads();                 // S written; M's last readers done
#pragma unroll 8
    for (int idx = tid; idx < QP * NCH; idx += NT) {
      const int c = idx / NCH, n = idx % NCH;
      M[idx] = c < Q && n0 + n < N ? to_f(Mg[(int64_t)c * N + n0 + n]) : 0.f;
    }
    __syncthreads();
    // out[r][n] = sum over c in order of S[r][c] M[c][n]: 8 rows a thread
    const int n = tid & 127;
    if (n >= NCH) continue;
    float o[SUM_ROWS / 2];
#pragma unroll
    for (int a = 0; a < SUM_ROWS / 2; ++a) o[a] = 0.f;
    for (int c = 0; c < QP; c += 4) {
      float mv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) mv[u] = M[(c + u) * NCH + n];
#pragma unroll
      for (int a = 0; a < SUM_ROWS / 2; ++a) {
        const float4 sv = ld4(S + (rg + a) * QP + c);
        o[a] = fmaf(sv.x, mv[0], o[a]);
        o[a] = fmaf(sv.y, mv[1], o[a]);
        o[a] = fmaf(sv.z, mv[2], o[a]);
        o[a] = fmaf(sv.w, mv[3], o[a]);
      }
    }
#pragma unroll
    for (int a = 0; a < SUM_ROWS / 2; ++a) {
      const int row = r0 + rg + a;
      if (row < Q && n0 + n < N)
        out[(int64_t)row * N + n0 + n] = from_f<E>(o[a]);
    }
  }
}

// The dynamic shared-memory limit of KERNEL, raised once per device.
template <auto KERNEL>
int raise_once(size_t smem) {
  static bool raised[64] = {};
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err != 0) return err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!raised[dev]) {
    err = set_smem(KERNEL, smem);
    if (err != 0) return err;
    raised[dev] = true;
  }
  return 0;
}

// bit 0: 16-byte copies and stores of the (Q, H, P) tensors (P % 4 == 0,
// every one 16-byte aligned); bit 1: of B and C (N % 4 == 0, aligned).
inline int vec_flags(int P, int N, const void* a, const void* b,
                     const void* c, const void* d, const void* B,
                     const void* C) {
  auto al = [](const void* p) { return p == nullptr || ((uintptr_t)p & 15) == 0; };
  return (P % 4 == 0 && al(a) && al(b) && al(c) && al(d) ? 1 : 0) |
         (N % 4 == 0 && al(B) && al(C) ? 2 : 0);
}

template <typename E, int NPC>
int launch_fwd(const void* x, const void* dt, const void* cum, const void* B,
               const void* C, void* y, int BC, int Q, int H, int P, int N,
               int G, cudaStream_t stream) {
  using L = Simt<NPC, false>;
  int err = raise_once<ssd_fwd_simt_kernel<E, NPC>>(L::SMEM);
  if (err != 0) return err;
  ssd_fwd_simt_kernel<E, NPC><<<dim3((H + G - 1) / G, BC), NT, L::SMEM,
                                stream>>>(
      (const E*)x, (const float*)dt, (const double*)cum, (const E*)B,
      (const E*)C, (E*)y, Q, H, P, N, G,
      vec_flags(P, N, x, y, nullptr, nullptr, B, C));
  return (int)cudaGetLastError();
}

template <typename E, int NPC>
int launch_bwd(const void* x, const void* dt, const void* cum, const void* B,
               const void* C, const void* g, void* dx, void* ddt, void* dlt,
               void* dB, void* dC, void* part, int BC, int Q, int H, int P,
               int N, int G, cudaStream_t stream) {
  using L = Simt<NPC, true>;
  int err = raise_once<ssd_bwd_simt_kernel<E, NPC>>(L::SMEM);
  if (err == 0)
    err = raise_once<ssd_bwd_sum_kernel<E>>(sum_smem(QMAX, SUM_NCH));
  if (err != 0) return err;
  const int n_grp = (H + G - 1) / G;
  ssd_bwd_simt_kernel<E, NPC><<<dim3(n_grp, BC), NT, L::SMEM, stream>>>(
      (const E*)x, (const float*)dt, (const double*)cum, (const E*)B,
      (const E*)C, (const E*)g, (E*)dx, (float*)ddt, (float*)dlt,
      (float*)part, Q, H, P, N, G, vec_flags(P, N, x, g, dx, nullptr, B, C));
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  ssd_bwd_sum_kernel<E><<<dim3((Q + SUM_ROWS - 1) / SUM_ROWS, 2, BC), NT,
                          sum_smem(Q, N), stream>>>(
      (const float*)part, (const E*)B, (const E*)C, (E*)dB, (E*)dC, Q, N,
      n_grp);
  return (int)cudaGetLastError();
}

// ------------------------------------------ B6, bf16, tensor cores
// Kernel 1, ssd_bwd_tc_kernel: one block per (cell, group of G heads), two
// warpgroups of 64 rows.  It works in the transposed frame T[j][i] (rows j,
// the key index; columns i, the query index; live where j <= i): then
// att^T is an accumulator whose layout is the A fragment of dx = att^T g.
//   cb^T = B C^T     wgmma m64n128k16, B and C rows K-major (loaded once by
//                    plain 16-byte loads into the 128-byte swizzle, since a
//                    (Q, N) row of N = 20 is no TMA box), kept in shared
//                    memory in fragment order: each thread reads back its
//                    own 64 values;
//   per head, in head order, x and g tiles (Q rows x 64 bf16, rows H P
//   apart) by TMA over 4-D maps (P, H, Q, B nc) through a 2-stage ring:
//   datt^T = x g^T   wgmma m64n128k16, both K-major;
//   the elementwise part on the accumulator: decay = exp(cum_i - cum_j)
//     only where j <= i, att = cb decay dt_j, dad = datt decay, ddt_j = sum_i
//     dad cb (a row of T: quad shuffles), dseg = dad cb dt_j, dcum = column
//     sums of T (xor-shuffle reduce-scatter, then 8 warps in order) minus
//     its row sums, and dltT, dcum's suffix sum, at once (the CUDA-core
//     route sums the spanning pairs instead), dcb^T += dad dt_j in
//     registers;
//   dx = att^T g     wgmma m64n64k16, A = att^T from registers as bf16 hi +
//                    lo (att - hi, rounded again: att to 2^-17 relative, the
//                    f32 products' accuracy), B = the same g tile N-major
//                    through the transpose bit;
//   at the end the group's dcb^T, summed over its heads in order, goes to a
//   (B nc, ceil(H / G), Q, Q) f32 scratch, once.
// Kernel 2, ssd_bwd_tc_headsum_kernel: one block per (16 rows, dB or dC,
// cell) sums the ceil(H / G) partials in group order into a slab of dcb
// and forms dB = dcb^T C or dC = dcb B in f32 FMAs (67 MFLOP at mamba2's
// shape: the CUDA cores serve).
constexpr int TC_Q = 128;       // chunk rows a block holds: two warpgroups
constexpr int TC_NT = 256;      // threads of kernel 1 and kernel 2
constexpr int TC_STAGES = 2;    // x / g tile ring depth
constexpr int TC_GMAX = 16;     // heads per block at most
constexpr int TILE_B = TC_Q * SW_ROW;   // one 128-row, 64-column bf16 tile
constexpr int HS_ROWS = 16;     // output rows per block of kernel 2

constexpr size_t bwd_tc_smem() {   // + 1024 to align the tiles by hand
  return 1024 + 8 * TILE_B +                       // B / C (then cb^T), ring
         sizeof(float) * (2 * TC_GMAX * TC_Q +     // cum, dt of the group
                          2 * 8 * TC_Q + 2 * TC_Q) +  // red, rowT (x 2)
         8 * 2 * TC_STAGES;                        // full, empty barriers
}

// Halve `n` values among the lanes that differ in `mask`: the lane with the
// mask bit keeps the upper half, its partner the lower, each summed with
// the other's copy (a fixed order).
template <int n>
__device__ __forceinline__ void halve(float (&v)[32], int lane, int mask) {
  const bool up = (lane & mask) != 0;
#pragma unroll
  for (int i = 0; i < n / 2; ++i) {
    const float keep = up ? v[n / 2 + i] : v[i];
    const float send = up ? v[i] : v[n / 2 + i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
  }
}

// grid (ceil(H / G), B nc).  Writes dx, ddt, dltT and the group's dcb^T.
__global__ void __launch_bounds__(TC_NT, 1)
ssd_bwd_tc_kernel(const __grid_constant__ CUtensorMap tm_x,
                  const __grid_constant__ CUtensorMap tm_g,
                  const float* __restrict__ dt, const float* __restrict__ cum,
                  const __nv_bfloat16* __restrict__ Bm,
                  const __nv_bfloat16* __restrict__ Cm,
                  __nv_bfloat16* __restrict__ dx, float* __restrict__ ddt,
                  float* __restrict__ dlt, float* __restrict__ part, int Q,
                  int H, int P, int N, int G, int vec_bc) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t bc_s = smem_u32(base);   // B panels 0-1, C panels 2-3
  const uint32_t ring_s = bc_s + 4 * TILE_B;  // stage st: x, then g
  const float* cbT = reinterpret_cast<const float*>(base);  // once formed
  float* cum_sm = reinterpret_cast<float*>(base + 8 * TILE_B);
  float* dt_sm = cum_sm + TC_GMAX * TC_Q;
  float* red = dt_sm + TC_GMAX * TC_Q;          // [2][8 warps][TC_Q]
  float* rowT = red + 2 * 8 * TC_Q;             // [2][TC_Q]
  const uint32_t bar_s = smem_u32(rowT + 2 * TC_Q);
  // full[st] = bar_s + 8 st, empty[st] = bar_s + 8 (TC_STAGES + st)

  const int grp = blockIdx.x, h0 = grp * G, nh = min(G, H - h0);
  const int64_t bc = blockIdx.y;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, gw = tid >> 5;
  const int r0 = 64 * wg + 16 * warp + (lane >> 2);  // rows j: r0, r0 + 8
  const int c0 = 2 * (lane & 3);    // columns i: 8 c + c0 + {0, 1}

  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < TC_STAGES; ++st) {
      mbar_init(bar_s + 8 * st, 1);
      mbar_init(bar_s + 8 * (TC_STAGES + st), TC_NT);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto load_head = [&](int k) {   // head h0 + k into stage k % TC_STAGES
    const int st = k % TC_STAGES;
    const uint32_t full = bar_s + 8 * st, x_dst = ring_s + 2 * st * TILE_B;
    mbar_expect_tx(full, 2 * TILE_B);
    tma_load_4d(x_dst, &tm_x, full, 0, h0 + k, 0, (int)bc);
    tma_load_4d(x_dst + TILE_B, &tm_g, full, 0, h0 + k, 0, (int)bc);
  };
  if (tid == 0)
    for (int k = 0; k < TC_STAGES && k < nh; ++k) load_head(k);

  // B and C rows into two 64-column panels each in the 128-byte swizzle
  // (rows past Q and columns past N read 0, so every product below runs
  // its full depth: no wgmma sits behind a branch); the group's cum and dt
  for (int idx = tid; idx < 4 * TC_Q * 8; idx += TC_NT) {
    const int which = idx / (2 * TC_Q * 8), rem = idx % (2 * TC_Q * 8);
    const int pan = rem / (TC_Q * 8), r = (rem / 8) % TC_Q, ch = rem % 8;
    const int n0 = 64 * pan + 8 * ch;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < Q && n0 < N) {
      const __nv_bfloat16* src = (which ? Cm : Bm) + (bc * Q + r) * N + n0;
      if (vec_bc) {
        v = *reinterpret_cast<const uint4*>(src);
      } else {
        uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (n0 + e < N)
            w[e / 2] |= (uint32_t)__bfloat16_as_ushort(src[e])
                        << (16 * (e % 2));
        v = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    *reinterpret_cast<uint4*>(base + (2 * which + pan) * TILE_B +
                              r * SW_ROW + ((ch ^ (r & 7)) << 4)) = v;
  }
  for (int idx = tid; idx < nh * TC_Q; idx += TC_NT) {
    const int k = idx / TC_Q, q = idx % TC_Q;
    cum_sm[idx] = q < Q ? cum[(bc * H + h0 + k) * Q + q] : 0.f;
  }
  for (int idx = tid; idx < nh * TC_Q; idx += TC_NT) {
    const int q = idx / nh, k = idx % nh;    // a row's heads side by side
    dt_sm[k * TC_Q + q] = q < Q ? dt[(bc * Q + q) * H + h0 + k] : 0.f;
  }
  // the threads' stores of B / C are read by wgmma (the async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  {   // cb^T = B C^T over N in steps of 16, then into fragment order
    float cb[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) cb[e] = 0.f;
    wg_fence();
#pragma unroll
    for (int t = 0; t < 8; ++t)
      wgmma_ss_n128(cb,
                    sw128_desc(bc_s + (t >> 2) * TILE_B + wg * 64 * SW_ROW +
                               (t & 3) * 32),
                    sw128_desc(bc_s + (2 + (t >> 2)) * TILE_B + (t & 3) * 32));
    wg_commit();
    wg_wait_all();
    reg_fence(cb);
    __syncthreads();               // both warpgroups are done with B and C
    float4* dst = reinterpret_cast<float4*>(base);
#pragma unroll
    for (int c = 0; c < 16; ++c)
      dst[c * TC_NT + tid] =
          make_float4(cb[4 * c], cb[4 * c + 1], cb[4 * c + 2], cb[4 * c + 3]);
  }

  float dcb[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) dcb[e] = 0.f;
  for (int k = 0; k < nh; ++k) {
    const int st = k % TC_STAGES, h = h0 + k, par = k & 1;
    const uint32_t phase = (k / TC_STAGES) & 1;
    const uint32_t x_t = ring_s + 2 * st * TILE_B, g_t = x_t + TILE_B;
    mbar_wait(bar_s + 8 * st, phase);

    // datt^T = x g^T over p in steps of 16
    float d[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) d[e] = 0.f;
    wg_fence();
#pragma unroll
    for (int t = 0; t < 4; ++t)      // p past P reads 0 (TMA's fill)
      wgmma_ss_n128(d, sw128_desc(x_t + wg * 64 * SW_ROW + t * 32),
                    sw128_desc(g_t + t * 32));
    wg_commit();
    wg_wait_all();
    reg_fence(d);

    // the elementwise part; d becomes att^T
    const float* cum_h = cum_sm + k * TC_Q;
    const float* dt_h = dt_sm + k * TC_Q;
    float cj[2], dtj[2], rs[2] = {0.f, 0.f}, ds[2] = {0.f, 0.f}, cs[32];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      cj[x] = cum_h[r0 + 8 * x];
      dtj[x] = dt_h[r0 + 8 * x];
    }
    const float4* cbq = reinterpret_cast<const float4*>(cbT);
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const float4 cb4 = cbq[c * TC_NT + tid];
      const float cbe[4] = {cb4.x, cb4.y, cb4.z, cb4.w};
      const float2 ci = *reinterpret_cast<const float2*>(cum_h + 8 * c + c0);
      cs[2 * c] = cs[2 * c + 1] = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int e = 4 * c + q, x = q >> 1, b = q & 1;
        const int j = r0 + 8 * x, i = 8 * c + c0 + b;
        float att = 0.f;
        if (i >= j && i < Q) {
          const float dec = expf((b ? ci.y : ci.x) - cj[x]);
          att = cbe[q] * dec * dtj[x];
          const float dad = d[e] * dec;
          const float tq = dad * cbe[q];
          ds[x] += tq;
          const float dseg = tq * dtj[x];
          rs[x] += dseg;
          cs[2 * c + b] += dseg;
          dcb[e] += dad * dtj[x];
        }
        d[e] = att;
      }
    }
    // rows of T: ddt_j and sum_i dseg over the quad; columns of T: the
    // 8 lanes of a column class, then the 8 warps (after the barrier)
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      float a = ds[x], r = rs[x];
      a += __shfl_xor_sync(0xffffffffu, a, 1);
      a += __shfl_xor_sync(0xffffffffu, a, 2);
      r += __shfl_xor_sync(0xffffffffu, r, 1);
      r += __shfl_xor_sync(0xffffffffu, r, 2);
      const int j = r0 + 8 * x;
      if ((lane & 3) == 0) {
        if (j < Q) ddt[(bc * Q + j) * H + h] = a;
        rowT[par * TC_Q + j] = r;
      }
    }
    halve<32>(cs, lane, 16);
    halve<16>(cs, lane, 8);
    halve<8>(cs, lane, 4);
#pragma unroll
    for (int q = 0; q < 4; ++q) {         // value index (lane & 28) + q
      const int vi = (lane & 28) + q;
      red[(par * 8 + gw) * TC_Q + 8 * (vi >> 1) + c0 + (vi & 1)] = cs[q];
    }

    // dx = att^T g over i in steps of 16: att as bf16 hi + lo A fragments
    uint32_t ah[8][4], al[8][4];
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float a0 = d[8 * t + 2 * x], a1 = d[8 * t + 2 * x + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(a0, a1);
        const float2 hf = __bfloat1622float2(hi);
        ah[t][x] = *reinterpret_cast<const uint32_t*>(&hi);
        al[t][x] = pack_bf16(a0 - hf.x, a1 - hf.y);
      }
    float acc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.f;
    wg_fence();
#pragma unroll
    for (int t = 0; t < 8; ++t) {    // att is 0 where i < j or i >= Q
      const uint64_t db = sw128_desc(g_t + t * 16 * SW_ROW);
      wgmma_rs_n64(acc, ah[t], db);
      wgmma_rs_n64(acc, al[t], db);
    }
    wg_commit();
    wg_wait_all();
    reg_fence(acc);

    // release the stage; thread 0 refills it once all 256 threads have
    mbar_arrive(bar_s + 8 * (TC_STAGES + st));
    if (tid == 0 && k + TC_STAGES < nh) {
      mbar_wait(bar_s + 8 * (TC_STAGES + st), phase);
      load_head(k + TC_STAGES);
    }
    __syncwarp();

#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int j = r0 + 8 * x;
      if (j >= Q) continue;
      __nv_bfloat16* o = dx + ((bc * Q + j) * H + h) * (int64_t)P;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int p = 8 * c + c0;
        if (p < P)
          *reinterpret_cast<__nv_bfloat162*>(o + p) = __floats2bfloat162_rn(
              acc[4 * c + 2 * x], acc[4 * c + 2 * x + 1]);
      }
    }

    // dcum = column sums of T (8 warps in order) - its row sums, and at
    // once dltT, its suffix sum (the transpose of cum = cumsum(ltT)): lane
    // l of warp 0 takes positions 4l .. 4l + 3, sums them from the end,
    // then adds the lanes above it (a shuffle scan; a fixed order)
    __syncthreads();
    if (tid < 32) {
      float d[4], s = 0.f;
#pragma unroll
      for (int u = 3; u >= 0; --u) {
        const int q = 4 * tid + u;
        float c = 0.f;
#pragma unroll
        for (int w = 0; w < 8; ++w) c += red[(par * 8 + w) * TC_Q + q];
        s += q < Q ? c - rowT[par * TC_Q + q] : 0.f;
        d[u] = s;
      }
      float above = s;               // lanes tid .. 31
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_down_sync(0xffffffffu, above, off);
        if (tid + off < 32) above += o;
      }
      above = __shfl_down_sync(0xffffffffu, above, 1);   // lanes tid + 1 ..
      if (tid == 31) above = 0.f;
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (4 * tid + u < Q) dlt[(bc * H + h) * Q + 4 * tid + u] = d[u] + above;
    }
  }

  // the group's dcb^T, summed over its heads in head order
  float* out = part + ((int64_t)bc * gridDim.x + grp) * Q * Q;
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int j = r0 + 8 * x;
    if (j >= Q) continue;
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const int i = 8 * c + c0;
      if (i < Q) out[(int64_t)j * Q + i] = dcb[4 * c + 2 * x];
      if (i + 1 < Q) out[(int64_t)j * Q + i + 1] = dcb[4 * c + 2 * x + 1];
    }
  }
}

// grid (ceil(Q / 16), 2, B nc).  which 0: dC rows i in [r0, r0 + 16),
// dC_i = sum_j dcb[i][j] B_j; which 1: dB rows j, dB_j = sum_i dcb[i][j]
// C_i; dcb = the sum of kernel 1's n_grp partials (dcb^T), in group order.
__global__ void __launch_bounds__(TC_NT)
ssd_bwd_tc_headsum_kernel(const float* __restrict__ part,
                          const __nv_bfloat16* __restrict__ Bm,
                          const __nv_bfloat16* __restrict__ Cm,
                          __nv_bfloat16* __restrict__ dB,
                          __nv_bfloat16* __restrict__ dC, int Q, int N,
                          int n_grp) {
  extern __shared__ float hs_sm[];
  const int QP = (Q + 3) & ~3;       // rows of 16-byte float4 reads
  float* S = hs_sm;                  // [HS_ROWS][QP]  the rows' dcb slab
  float* Mt = S + HS_ROWS * QP;      // [QP][N]  B (which 0) or C (which 1)
  const int which = blockIdx.y, r0 = blockIdx.x * HS_ROWS;
  const int64_t bc = blockIdx.z;
  const int tid = threadIdx.x;
  const float* Pb = part + bc * n_grp * (int64_t)Q * Q;
  for (int idx = tid; idx < HS_ROWS * QP; idx += TC_NT) {
    int r, c;
    if (which) { r = idx / QP; c = idx % QP; }             // a row of dcb^T
    else { c = idx / HS_ROWS; r = idx % HS_ROWS; }         // a column
    const int row = r0 + r;
    float s = 0.f;
    if (row < Q && c < Q) {
      const int64_t off = which ? (int64_t)row * Q + c : (int64_t)c * Q + row;
#pragma unroll 4
      for (int gi = 0; gi < n_grp; ++gi) s += Pb[gi * (int64_t)Q * Q + off];
    }
    S[r * QP + c] = s;
  }
  const __nv_bfloat16* Mg = (which ? Cm : Bm) + bc * Q * N;
  for (int idx = tid; idx < QP * N; idx += TC_NT)
    Mt[idx] = idx < Q * N ? __bfloat162float(Mg[idx]) : 0.f;
  __syncthreads();

  // out[r][n] = sum over c in order of S[r][c] Mt[c][n]: 8 rows a thread,
  // S read 4 columns at a time
  __nv_bfloat16* out = (which ? dB : dC) + bc * Q * N;
  const int rg = (tid >> 7) * (HS_ROWS / 2);
  for (int n0 = 0; n0 < N; n0 += 128) {
    const int n = n0 + (tid & 127);
    float o[HS_ROWS / 2];
#pragma unroll
    for (int a = 0; a < HS_ROWS / 2; ++a) o[a] = 0.f;
    if (n < N)
      for (int c = 0; c < QP; c += 4) {
        float mv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) mv[u] = Mt[(c + u) * N + n];
#pragma unroll
        for (int a = 0; a < HS_ROWS / 2; ++a) {
          const float4 sv =
              *reinterpret_cast<const float4*>(S + (rg + a) * QP + c);
          o[a] = fmaf(sv.x, mv[0], o[a]);
          o[a] = fmaf(sv.y, mv[1], o[a]);
          o[a] = fmaf(sv.z, mv[2], o[a]);
          o[a] = fmaf(sv.w, mv[3], o[a]);
        }
      }
#pragma unroll
    for (int a = 0; a < HS_ROWS / 2; ++a) {
      const int row = r0 + rg + a;
      if (row < Q && n < N) out[row * N + n] = __float2bfloat16_rn(o[a]);
    }
  }
}

int launch_bwd_tc(const void* x, const void* dt, const void* cum,
                  const void* B, const void* C, const void* g, void* dx,
                  void* ddt, void* dlt, void* dB, void* dC, void* part,
                  int BC, int Q, int H, int P, int N, int G,
                  cudaStream_t stream) {
  if (Q <= 0 || Q > TC_Q || P <= 0 || P > 64 || P % 8 != 0 || N <= 0 ||
      N > 128 || H <= 0 || G <= 0 || G > TC_GMAX ||
      ((uintptr_t)x | (uintptr_t)g) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tm_x, tm_g;
  if (!encode_bshd(enc, &tm_x, x, BC, Q, H, P, TC_Q) ||
      !encode_bshd(enc, &tm_g, g, BC, Q, H, P, TC_Q))
    return (int)cudaErrorInvalidValue;
  const int vec_bc =
      N % 8 == 0 && ((uintptr_t)B | (uintptr_t)C) % 16 == 0 ? 1 : 0;
  const int n_grp = (H + G - 1) / G;
  const size_t smem = bwd_tc_smem();
  const size_t QP = (Q + 3) & ~3;
  const size_t smem2 = sizeof(float) * (HS_ROWS * QP + QP * N);
  // the shared-memory limits, raised once per device to their largest
  // (a per-call cudaFuncSetAttribute costs the host time this launch
  // otherwise spends on its own)
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err != 0) return err;
  static bool raised[64] = {};
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!raised[dev]) {
    err = set_smem(ssd_bwd_tc_kernel, smem);
    if (err == 0)
      err = set_smem(ssd_bwd_tc_headsum_kernel,
                     sizeof(float) * ((size_t)HS_ROWS * TC_Q + TC_Q * 128));
    if (err != 0) return err;
    raised[dev] = true;
  }
  ssd_bwd_tc_kernel<<<dim3(n_grp, BC), TC_NT, smem, stream>>>(
      tm_x, tm_g, (const float*)dt, (const float*)cum,
      (const __nv_bfloat16*)B, (const __nv_bfloat16*)C, (__nv_bfloat16*)dx,
      (float*)ddt, (float*)dlt, (float*)part, Q, H, P, N, G, vec_bc);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  ssd_bwd_tc_headsum_kernel<<<dim3((Q + HS_ROWS - 1) / HS_ROWS, 2, BC),
                              TC_NT, smem2, stream>>>(
      (const float*)part, (const __nv_bfloat16*)B, (const __nv_bfloat16*)C,
      (__nv_bfloat16*)dB, (__nv_bfloat16*)dC, Q, N, n_grp);
  return (int)cudaGetLastError();
}

// ------------------------------------------ B5, bf16, tensor cores
// ssd_fwd_tc_kernel replaces _ssd_kernel (ssd_intra_pallas, :46 / :87) for
// bf16.  What bounds it: 44.3 MB of bytes at mamba2-2.7b's shape, 13.2 us
// at 3.35 TB/s (the 1.43 GFLOP it needs take 1.4 us on the tensor cores);
// the CUDA-core ssd_fwd ran at 36x that bound, forming cb again for every
// head (4.0 GFLOP of f32 FMAs a layer) from operands widened element by
// element.  What this design does about it:
//   one block per (cell, group of G heads), G = head_groups(B nc, H): one
//   wave of blocks (128 on 132 SMs at mamba2's shape);
//   cb = C B^T once per block on wgmma (m64n128k16 over N), B and C rows
//   stored by the threads in the 128-byte swizzle (16-byte loads, or
//   element loads where N % 8 != 0 or a row is not 16-byte aligned), cb
//   kept in registers (64 a thread) for the group's heads;
//   per head, in head order: the x tile (Q rows x 64 bf16, rows H P apart)
//   by TMA over the 4-D map B6 uses, through a ring of FWD_STAGES stages
//   (the next heads' loads overlap this head's work); att = cb exp(cum_i -
//   cum_j) dt_j formed on the accumulator, the exponent taken only where
//   j <= i (elsewhere its argument is -inf: exp2 gives 0, never inf * 0);
//   att packed into the A fragments of y = att x as bf16 hi + lo (att - hi,
//   rounded again: att to 2^-17 relative, the f32 products' accuracy), x
//   N-major through the transpose bit (wgmma m64n64k16 from registers);
//   y to bf16, staged per warp in shared memory (swizzled, no bank
//   conflicts) and written by 16-byte stores, with no block barrier in the
//   head loop.
// The causal triangle is balanced: the chunk's 16 row groups of 8 rows go
// to the 16 (warpgroup, warp, row half) slots so that every warp holds one
// group of the upper and one of the lower half of the chunk (warp w of
// warpgroup 0 groups w and 15 - w, of warpgroup 1 groups 7 - w and 8 + w):
// each warp forms the same 1,032 live elements of att a head (the 1 : 3
// imbalance of a split into two 64-row halves is gone), and the two warps
// on one SM sub-partition (warp w of each warpgroup) as well.  C's rows are
// stored in that slot order, so the cb product needs no other change.
// att goes 4 column groups of 8 at a time: a chunk entirely above a row
// group's diagonal is skipped by a warp-uniform branch, and a chunk has no
// branch inside (a select masks j > i), so its 8 exponentials interleave
// (a branch per column group left each chain's latency exposed); every
// wgmma runs its full depth.  The prologue starts every load of B, C, cum
// and dt before its first store: the block waits on device memory once.
// Deterministic: no atomics, every sum in a fixed order.
constexpr int FWD_STAGES = 4;             // x tile ring depth
constexpr int WARP_Y_B = 16 * SW_ROW;     // one warp's 16 rows of y, staged

constexpr size_t fwd_tc_smem() {   // + 1024 to align the tiles by hand
  return 1024 + (4 + FWD_STAGES) * TILE_B +        // B / C, ring
         8 * WARP_Y_B +                            // y staging, 8 warps
         sizeof(float) * 2 * TC_GMAX * TC_Q +      // cum, dt of the group
         8 * 2 * FWD_STAGES;                       // full, empty barriers
}

// Row group (8 rows: 8 g .. 8 g + 7) of row half x of warp w of
// warpgroup wg; fwd_slot is its inverse: slot 8 wg + 2 w + x, the place of
// the group's rows in C's panels and in the accumulators (m64 rows 16 w +
// 8 x + r of warpgroup wg).
__host__ __device__ constexpr int fwd_row_group(int wg, int w, int x) {
  return wg == 0 ? (x == 0 ? w : 15 - w) : (x == 0 ? 7 - w : 8 + w);
}
__host__ __device__ constexpr int fwd_slot(int g) {
  return g < 4 ? 2 * g : g < 8 ? 8 + 2 * (7 - g)
                       : g < 12 ? 9 + 2 * (g - 8) : 1 + 2 * (15 - g);
}

__device__ __forceinline__ float ex2(float x) {   // 2^x; ex2(-inf) = 0
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// grid (ceil(H / G), B nc).  Writes y.
__global__ void __launch_bounds__(TC_NT, 1)
ssd_fwd_tc_kernel(const __grid_constant__ CUtensorMap tm_x,
                  const float* __restrict__ dt, const float* __restrict__ cum,
                  const __nv_bfloat16* __restrict__ Bm,
                  const __nv_bfloat16* __restrict__ Cm,
                  __nv_bfloat16* __restrict__ y, int Q, int H, int P, int N,
                  int G, int vec_bc) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t bc_s = smem_u32(base);   // B panels 0-1, C panels 2-3
  const uint32_t ring_s = bc_s + 4 * TILE_B;  // stage st: x
  uint8_t* ystage = base + (4 + FWD_STAGES) * TILE_B;
  float* cum_sm = reinterpret_cast<float*>(ystage + 8 * WARP_Y_B);
  float* dt_sm = cum_sm + TC_GMAX * TC_Q;
  const uint32_t bar_s = smem_u32(dt_sm + TC_GMAX * TC_Q);
  // full[st] = bar_s + 8 st, empty[st] = bar_s + 8 (FWD_STAGES + st)

  const int grp = blockIdx.x, h0 = grp * G, nh = min(G, H - h0);
  const int64_t bc = blockIdx.y;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, gw = tid >> 5;
  const int c0 = 2 * (lane & 3);    // columns j (and p): 8 c + c0 + {0, 1}
  int rg[2], row[2];                // row halves x: rows i = 8 rg[x] + lane / 4
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    rg[x] = fwd_row_group(wg, warp, x);
    row[x] = 8 * rg[x] + (lane >> 2);
  }

  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < FWD_STAGES; ++st) {
      mbar_init(bar_s + 8 * st, 1);
      mbar_init(bar_s + 8 * (FWD_STAGES + st), TC_NT);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto load_head = [&](int k) {   // head h0 + k into stage k % FWD_STAGES
    const int st = k % FWD_STAGES;
    const uint32_t full = bar_s + 8 * st;
    mbar_expect_tx(full, TILE_B);
    tma_load_4d(ring_s + st * TILE_B, &tm_x, full, 0, h0 + k, 0, (int)bc);
  };
  if (tid == 0)
    for (int k = 0; k < FWD_STAGES && k < nh; ++k) load_head(k);

  // B rows j and C rows i (C's in slot order) into two 64-column panels
  // each in the 128-byte swizzle (rows past Q and columns past N read 0);
  // the group's cum and dt.  Every load starts before the first store,
  // so the block waits on device memory once, not once per load
  constexpr int BC_U = 4 * TC_Q * 8 / TC_NT, ROW_U = TC_GMAX * TC_Q / TC_NT;
  static_assert(BC_U * TC_NT == 4 * TC_Q * 8 && ROW_U * TC_NT ==
                TC_GMAX * TC_Q, "the prologue's loads divide evenly");
  uint4 bcv[BC_U];
  float cumv[ROW_U], dtv[ROW_U];
#pragma unroll
  for (int u = 0; u < BC_U; ++u) {
    const int idx = tid + u * TC_NT;
    const int which = idx / (2 * TC_Q * 8), rem = idx % (2 * TC_Q * 8);
    const int pan = rem / (TC_Q * 8), r = (rem / 8) % TC_Q, ch = rem % 8;
    const int n0 = 64 * pan + 8 * ch;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < Q && n0 < N) {
      const __nv_bfloat16* src = (which ? Cm : Bm) + (bc * Q + r) * N + n0;
      if (vec_bc) {
        v = *reinterpret_cast<const uint4*>(src);
      } else {
        uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (n0 + e < N)
            w[e / 2] |= (uint32_t)__bfloat16_as_ushort(src[e])
                        << (16 * (e % 2));
        v = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    bcv[u] = v;
  }
#pragma unroll
  for (int u = 0; u < ROW_U; ++u) {
    const int idx = tid + u * TC_NT;
    const int k = idx / TC_Q, q = idx % TC_Q;          // cum: (head, row)
    const int qd = idx / nh, kd = idx % nh;            // dt: a row's heads
    const bool live = idx < nh * TC_Q;
    cumv[u] = live && q < Q ? cum[(bc * H + h0 + k) * Q + q] : 0.f;
    dtv[u] = live && qd < Q ? dt[(bc * Q + qd) * H + h0 + kd] : 0.f;
  }
#pragma unroll
  for (int u = 0; u < BC_U; ++u) {
    const int idx = tid + u * TC_NT;
    const int which = idx / (2 * TC_Q * 8), rem = idx % (2 * TC_Q * 8);
    const int pan = rem / (TC_Q * 8), r = (rem / 8) % TC_Q, ch = rem % 8;
    const int sr = which ? 8 * fwd_slot(r >> 3) + (r & 7) : r;
    *reinterpret_cast<uint4*>(base + (2 * which + pan) * TILE_B +
                              sr * SW_ROW + ((ch ^ (sr & 7)) << 4)) = bcv[u];
  }
#pragma unroll
  for (int u = 0; u < ROW_U; ++u) {
    const int idx = tid + u * TC_NT;
    if (idx < nh * TC_Q) {
      cum_sm[idx] = cumv[u];
      dt_sm[(idx % nh) * TC_Q + idx / nh] = dtv[u];
    }
  }
  // the threads' stores of B / C are read by wgmma (the async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // cb = C B^T over N in steps of 16: this warpgroup's 64 slot rows of C
  // against all 128 rows j of B; kept in registers for every head
  float cb[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) cb[e] = 0.f;
  wg_fence();
#pragma unroll
  for (int t = 0; t < 8; ++t)
    wgmma_ss_n128(cb,
                  sw128_desc(bc_s + (2 + (t >> 2)) * TILE_B +
                             wg * 64 * SW_ROW + (t & 3) * 32),
                  sw128_desc(bc_s + (t >> 2) * TILE_B + (t & 3) * 32));
  wg_commit();
  wg_wait_all();
  reg_fence(cb);

  constexpr float LOG2E = 1.4426950408889634f;
  const float NEG_INF = __int_as_float((int)0xff800000u);
  uint8_t* ys = ystage + gw * WARP_Y_B;
  for (int k = 0; k < nh; ++k) {
    const int st = k % FWD_STAGES, h = h0 + k;
    // refill the stage head k - 1 read, once all 256 threads released it
    if (tid == 0 && k >= 1 && k - 1 + FWD_STAGES < nh) {
      mbar_wait(bar_s + 8 * (FWD_STAGES + (k - 1) % FWD_STAGES),
                ((k - 1) / FWD_STAGES) & 1);
      load_head(k - 1 + FWD_STAGES);
    }

    // att on cb's accumulator, packed into bf16 hi + lo A fragments: the
    // pair (c, x) is A register 2 (c & 1) + x of k-step c / 2.  Column
    // groups go 4 at a time behind one warp-uniform branch (a row group g
    // forms groups c <= g: 4 chunks at most, 5 a warp), with no branch
    // inside a chunk, so its 8 exponentials interleave
    const float* cum_h = cum_sm + k * TC_Q;
    const float* dt_h = dt_sm + k * TC_Q;
    float ci[2];
#pragma unroll
    for (int x = 0; x < 2; ++x)
      ci[x] = row[x] < Q ? cum_h[row[x]] : NEG_INF;
    uint32_t ah[8][4], al[8][4];
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        if (4 * cc <= rg[x]) {
#pragma unroll
          for (int c = 4 * cc; c < 4 * cc + 4; ++c) {
            const int j = 8 * c + c0;
            const float2 cj = *reinterpret_cast<const float2*>(cum_h + j);
            const float2 dj = *reinterpret_cast<const float2*>(dt_h + j);
            const float s0 = j <= row[x] ? ci[x] - cj.x : NEG_INF;
            const float s1 = j + 1 <= row[x] ? ci[x] - cj.y : NEG_INF;
            const float v0 = cb[4 * c + 2 * x] * ex2(s0 * LOG2E) * dj.x;
            const float v1 = cb[4 * c + 2 * x + 1] * ex2(s1 * LOG2E) * dj.y;
            const __nv_bfloat162 hi = __floats2bfloat162_rn(v0, v1);
            const float2 hf = __bfloat1622float2(hi);
            ah[c >> 1][2 * (c & 1) + x] =
                *reinterpret_cast<const uint32_t*>(&hi);
            al[c >> 1][2 * (c & 1) + x] = pack_bf16(v0 - hf.x, v1 - hf.y);
          }
        } else {                     // the 8 x 32 block lies above
#pragma unroll
          for (int c = 4 * cc; c < 4 * cc + 4; ++c)
            ah[c >> 1][2 * (c & 1) + x] = al[c >> 1][2 * (c & 1) + x] = 0u;
        }
      }

    // y = att x over j in steps of 16, x N-major (rows past Q: TMA's 0)
    mbar_wait(bar_s + 8 * st, (k / FWD_STAGES) & 1);
    const uint32_t x_t = ring_s + st * TILE_B;
    float acc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.f;
    wg_fence();
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const uint64_t db = sw128_desc(x_t + t * 16 * SW_ROW);
      wgmma_rs_n64(acc, ah[t], db);
      wgmma_rs_n64(acc, al[t], db);
    }
    wg_commit();
    wg_wait_all();
    reg_fence(acc);
    mbar_arrive(bar_s + 8 * (FWD_STAGES + st));

    // y: accumulator element 4 c + 2 x + b is (row half x, p = 8 c + c0 +
    // b); staged as the warp's 16 rows (8 x + lane / 4) in the 128-byte
    // swizzle, then read back as 16-byte chunks, 4 rows a store
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int lr = 8 * x + (lane >> 2);
        *reinterpret_cast<uint32_t*>(ys + lr * SW_ROW +
                                     ((c ^ (lr & 7)) << 4) +
                                     4 * (lane & 3)) =
            pack_bf16(acc[4 * c + 2 * x], acc[4 * c + 2 * x + 1]);
      }
    __syncwarp();
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int lr = 4 * it + (lane >> 3), ch = lane & 7;
      const int r = 8 * rg[it >> 1] + (lr & 7);
      if (r < Q && 8 * ch < P)
        *reinterpret_cast<uint4*>(y + ((bc * Q + r) * H + h) * (int64_t)P +
                                  8 * ch) =
            *reinterpret_cast<const uint4*>(ys + lr * SW_ROW +
                                            ((ch ^ (lr & 7)) << 4));
    }
    __syncwarp();                    // the reads are done before the next
  }
}

int launch_fwd_tc(const void* x, const void* dt, const void* cum,
                  const void* B, const void* C, void* y, int BC, int Q,
                  int H, int P, int N, int G, cudaStream_t stream) {
  if (Q <= 0 || Q > TC_Q || P <= 0 || P > 64 || P % 8 != 0 || N <= 0 ||
      N > 128 || H <= 0 || G <= 0 || G > TC_GMAX ||
      ((uintptr_t)x | (uintptr_t)y) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tm_x;
  if (!encode_bshd(enc, &tm_x, x, BC, Q, H, P, TC_Q))
    return (int)cudaErrorInvalidValue;
  const int vec_bc =
      N % 8 == 0 && ((uintptr_t)B | (uintptr_t)C) % 16 == 0 ? 1 : 0;
  const size_t smem = fwd_tc_smem();
  // the shared-memory limit, raised once per device (as launch_bwd_tc's)
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err != 0) return err;
  static bool raised[64] = {};
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!raised[dev]) {
    err = set_smem(ssd_fwd_tc_kernel, smem);
    if (err != 0) return err;
    raised[dev] = true;
  }
  ssd_fwd_tc_kernel<<<dim3((H + G - 1) / G, BC), TC_NT, smem, stream>>>(
      tm_x, (const float*)dt, (const float*)cum, (const __nv_bfloat16*)B,
      (const __nv_bfloat16*)C, (__nv_bfloat16*)y, Q, H, P, N, G, vec_bc);
  return (int)cudaGetLastError();
}

// P <= 32 / 64 / 96 / 128 -> NPC 1 / 2 / 3 / 4; dtype 0 = f32, 1 = bf16.
// A chunk longer than one pass (Q > 128), or P > 64, takes one head a block
// (G = 1).
#define SSD_DISPATCH(LAUNCH, ...)                                        \
  do {                                                                   \
    if (P <= 0 || P > 128 || Q <= 0 || Q > QMAX || N <= 0 || H <= 0 ||  \
        G <= 0 || ((Q > SLAB || P > 64) && G != 1) ||                   \
        (dtype != 0 && dtype != 1))                                      \
      return (int)cudaErrorInvalidValue;                                 \
    const int npc = (P + 31) / 32;                                       \
    if (dtype == 0) {                                                    \
      if (npc == 1) return LAUNCH<float, 1>(__VA_ARGS__);                \
      if (npc == 2) return LAUNCH<float, 2>(__VA_ARGS__);                \
      if (npc == 3) return LAUNCH<float, 3>(__VA_ARGS__);                \
      return LAUNCH<float, 4>(__VA_ARGS__);                              \
    }                                                                    \
    if (npc == 1) return LAUNCH<__nv_bfloat16, 1>(__VA_ARGS__);          \
    if (npc == 2) return LAUNCH<__nv_bfloat16, 2>(__VA_ARGS__);          \
    if (npc == 3) return LAUNCH<__nv_bfloat16, 3>(__VA_ARGS__);          \
    return LAUNCH<__nv_bfloat16, 4>(__VA_ARGS__);                        \
  } while (0)

}  // namespace

extern "C" {

// Rows of one pass of ssd_fwd / ssd_bwd, checked by the wrapper.
int ssd_tile() { return SLAB; }

// y (B,nc,Q,H,P) in x's dtype, cum (B,nc,H,Q) f64; G heads a block (1 if
// Q > 128).  Returns cudaGetLastError() after the launch.
int ssd_fwd(const void* x, const void* dt, const void* cum, const void* B,
            const void* C, void* y, int dtype, int BC, int Q, int H, int P,
            int N, int G, void* stream) {
  SSD_DISPATCH(launch_fwd, x, dt, cum, B, C, y, BC, Q, H, P, N, G,
               (cudaStream_t)stream);
}

// cum (B,nc,H,Q) f64; dx (B,nc,Q,H,P) in x's dtype, ddt (B,nc,Q,H) f32,
// dlt (B,nc,H,Q) f32, dB / dC (B,nc,Q,N) in their dtype; part is a
// (B*nc, ceil(H / G), Q, Q) f32 scratch.  Returns cudaGetLastError() after
// the launches.
int ssd_bwd(const void* x, const void* dt, const void* cum, const void* B,
            const void* C, const void* g, void* dx, void* ddt, void* dlt,
            void* dB, void* dC, void* part, int dtype, int BC, int Q, int H,
            int P, int N, int G, void* stream) {
  SSD_DISPATCH(launch_bwd, x, dt, cum, B, C, g, dx, ddt, dlt, dB, dC, part,
               BC, Q, H, P, N, G, (cudaStream_t)stream);
}

// bf16 only (dtype 1), on the tensor cores: Q <= 128, P a multiple of 8 and
// at most 64, N <= 128, 1 <= G <= 16 heads per block; x and g 16-byte
// aligned; cum f32.  Outputs as ssd_bwd's, dltT (B,nc,H,Q) f32 being the
// suffix sum of rowsum - colsum of dseg; part is a (B*nc, ceil(H / G), Q, Q) f32
// scratch.  Returns cudaGetLastError() after the launches.
int ssd_bwd_tc(const void* x, const void* dt, const void* cum, const void* B,
               const void* C, const void* g, void* dx, void* ddt, void* dlt,
               void* dB, void* dC, void* part, int dtype, int BC, int Q,
               int H, int P, int N, int G, void* stream) {
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  return launch_bwd_tc(x, dt, cum, B, C, g, dx, ddt, dlt, dB, dC, part, BC,
                       Q, H, P, N, G, (cudaStream_t)stream);
}

// bf16 only (dtype 1), on the tensor cores, y (B,nc,Q,H,P): the reach of
// ssd_bwd_tc (Q <= 128, P a multiple of 8 and at most 64, N <= 128, 1 <= G
// <= 16 heads per block); x and y 16-byte aligned.  Returns
// cudaGetLastError() after the launch.
int ssd_fwd_tc(const void* x, const void* dt, const void* cum, const void* B,
               const void* C, void* y, int dtype, int BC, int Q, int H,
               int P, int N, int G, void* stream) {
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  return launch_fwd_tc(x, dt, cum, B, C, y, BC, Q, H, P, N, G,
                       (cudaStream_t)stream);
}

// Heads per block at most and chunk rows at most of ssd_fwd_tc and
// ssd_bwd_tc: checked by the wrapper.
int ssd_tc_max_heads() { return TC_GMAX; }
int ssd_tc_max_q() { return TC_Q; }

}  // extern "C"
