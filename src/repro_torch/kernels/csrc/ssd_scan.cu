// SSD intra-chunk term for Hopper (sm_90a): forward (B5) and backward (B6),
// hand-written CUDA C++.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/ssd_scan.py:
//   ssd_fwd_tc  <- _ssd_kernel      (ssd_intra_pallas, :46 / :87),
//                  bf16 on the tensor cores
//   ssd_fwd     <- the same, f32 (and bf16 outside ssd_fwd_tc's shapes)
//   ssd_bwd_tc  <- _ssd_bwd_kernel  (ssd_intra_bwd_pallas, :111 / :189),
//                  bf16 on the tensor cores
//   ssd_bwd     <- the same, f32 (and bf16 outside ssd_bwd_tc's shapes)
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
// row over the columns j < t.
//
// The exponent is taken only where j <= i.  A chunk's cumulative log-decay
// reaches about -1,000 at mamba2-2.7b's shape, so above the diagonal
// cum_i - cum_j is far above 88 and expf overflows: the TPU kernel's
// where(tril, exp(seg), 0) selects the 0, but a product with a 0 / 1 mask
// would give inf * 0 = NaN.
//
// Design.  Tiles of 64 x 64 (TL), blocks of 256 threads (a 16 x 16 grid);
// each thread owns a 4 x 4 piece of the (i, j) tile (rows ty + 16 a, columns
// tx + 16 b) and the same rows of a 64 x P accumulator (columns tx + 16 c,
// P padded to 16 * PC).  Operand tiles are staged in shared memory as f32
// with odd row strides, so a walk down a column hits distinct banks.  Tiles
// above the diagonal (every j > i) are skipped.  Inputs are read in place
// through the JAX layouts: no head-major copy, no padding copy; ragged edges
// (Q not a multiple of 64, P below its padded width, any N) are masked.
//   ssd_fwd: one block per (64-row tile of i, head, cell); it loops over the
//     column tiles j <= i with y in registers.
//   ssd_bwd: the TPU kernel sums dcb over heads in a VMEM scratch along its
//     sequential head axis; blocks here run in no order.  So B6 is two
//     kernels: ssd_bwd_head_kernel, one block per (head, cell), loops over
//     column tiles j and, inside, row tiles i >= j from the last up, with
//     dx_j and the column sums in registers, each tile's dseg in shared
//     memory (summed down its columns by one thread a column, carrying the
//     tiles below, then along its rows into dlt), and writes its head's dcb
//     to a (B*nc, H, Q, Q) f32 scratch;
//     ssd_bwd_bc_kernel, one block per (64-row tile, dB or dC, cell), sums
//     dcb over the heads in head order and forms dB or dC.
//
// Determinism: no atomics; every sum is taken in a fixed order, so two
// identical launches give identical bits (the stage-vs-trial check of a
// study is bitwise).
//
// Bound on an H100 SXM: max(flops / 989 TFLOP/s (bf16 dense, tensor
// cores), bytes / 3.35 TB/s).  Flops are those the function needs: its
// products and elementwise work over the Q(Q+1)/2 pairs j <= i, with cb
// formed once per cell (it depends on no head); bytes count each input
// read once and each output written once (chip_smoke.py, ssd_work).  At
// mamba2-2.7b's training shape (B 1, nc 16, Q 128, H 80, P 64, N 128, bf16)
// the forward is 1.43 GFLOP and 44.3 MB: 13.2 us, bytes-bound; the backward
// 2.93 GFLOP and 67.6 MB: 20.2 us, bytes-bound.  ssd_fwd and ssd_bwd (the
// f32 route) do not use the tensor cores (no wgmma, no TMA, no mma.sync):
// every product is an f32 FMA on the CUDA cores (67 TFLOP/s peak), fed by
// one shared-memory word per two FMAs, so they run far from that bound;
// the times are in PERF.md.  What their design does about the bound: it
// skips the tiles above the diagonal (a quarter of the work at Q = 128),
// never writes att or cb to device memory, reads each operand tile once
// per tile pair, and keeps every accumulator in registers.  ssd_bwd's
// per-head dcb scratch (84 MB at the shape above) is the price of a
// deterministic head sum, and its head sum runs on 64 blocks at that shape.
//
// ssd_fwd_tc and ssd_bwd_tc (B5 and B6 in bf16; their design notes are
// above their kernels below) are the redesigns for bf16: one wave of
// blocks, each a cell and a group of heads (kernels/ssd_scan.py::
// head_groups, a function of the shape alone), cb formed once per block on
// the tensor cores instead of once per head on the CUDA cores, the x (and
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

constexpr int TL = 64;       // tile rows and columns
constexpr int NT = 256;      // threads per block, a 16 x 16 grid

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

// Odd row stride of at least n floats: a column walk hits distinct banks.
__host__ __device__ __forceinline__ int odd(int n) { return n | 1; }

// Sum over the 16 threads of a half-warp (fixed order).
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// 64 rows [r0, r0 + 64) of a (rows, N) matrix of cell bc into dst[64][ld];
// rows at or past Q read as 0.
template <typename E>
__device__ __forceinline__ void load_bc_rows(float* dst, int ld,
                                             const E* src, int64_t bc,
                                             int r0, int Q, int N) {
  for (int idx = threadIdx.x; idx < TL * N; idx += NT) {
    const int r = idx / N, k = idx % N, q = r0 + r;
    dst[r * ld + k] = q < Q ? to_f(src[(bc * Q + q) * N + k]) : 0.f;
  }
}

// 64 rows [r0, r0 + 64) of head h of a (B*nc, Q, H, P) tensor into
// dst[64][ld], ld >= PW; rows at or past Q and columns at or past P read 0.
template <typename E>
__device__ __forceinline__ void load_head_rows(float* dst, int ld, int PW,
                                               const E* src, int64_t bc,
                                               int r0, int Q, int H, int h,
                                               int P) {
  for (int idx = threadIdx.x; idx < TL * PW; idx += NT) {
    const int r = idx / PW, p = idx % PW, q = r0 + r;
    float v = 0.f;
    if (q < Q && p < P) v = to_f(src[((bc * Q + q) * H + h) * P + p]);
    dst[r * ld + p] = v;
  }
}

// s[a][b] = sum_k A[ty + 16 a][k] * Bt[tx + 16 b][k], k < K.
__device__ __forceinline__ void tile_product(float s[4][4], const float* A,
                                             const float* Bt, int ld, int K,
                                             int tx, int ty) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) s[a][b] = 0.f;
  for (int k = 0; k < K; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) av[a] = A[(ty + 16 * a) * ld + k];
#pragma unroll
    for (int b = 0; b < 4; ++b) bv[b] = Bt[(tx + 16 * b) * ld + k];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) s[a][b] = fmaf(av[a], bv[b], s[a][b]);
  }
}

template <int PC>
__host__ __device__ constexpr int fwd_ld_p() { return (16 * PC) | 1; }

template <int PC>
size_t fwd_smem(int N) {
  return sizeof(double) * 2 * TL +
         sizeof(float) * (2 * TL * odd(N) + TL * fwd_ld_p<PC>() +
                          TL * (TL + 1) + TL);
}

// ---------------------------------------------------------------- B5
// grid (ceil(Q / 64), H, B * nc)
template <typename E, int PC>
__global__ void __launch_bounds__(NT)
ssd_fwd_kernel(const E* __restrict__ x, const float* __restrict__ dt,
               const double* __restrict__ cum, const E* __restrict__ Bm,
               const E* __restrict__ Cm, E* __restrict__ y, int Q, int H,
               int P, int N) {
  extern __shared__ float sm[];
  constexpr int PW = 16 * PC, LDP = fwd_ld_p<PC>();
  const int ldn = odd(N);
  double* sCi = reinterpret_cast<double*>(sm);  // [TL]  cum, rows of tile i
  double* sCj = sCi + TL;                       // [TL]  cum, rows of tile j
  float* sC = reinterpret_cast<float*>(sCj + TL);  // [TL][ldn]  C, tile i
  float* sB = sC + TL * ldn;         // [TL][ldn]  B, rows of tile j
  float* sX = sB + TL * ldn;         // [TL][LDP]  x, rows of tile j
  float* sA = sX + TL * LDP;         // [TL][TL + 1]  att tile
  float* sDt = sA + TL * (TL + 1);   // [TL]  dt, rows of tile j

  const int it = blockIdx.x, h = blockIdx.y;
  const int64_t bc = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int i0 = it * TL;
  const double* cum_h = cum + (bc * H + h) * Q;

  load_bc_rows(sC, ldn, Cm, bc, i0, Q, N);
  for (int r = threadIdx.x; r < TL; r += NT)
    sCi[r] = i0 + r < Q ? cum_h[i0 + r] : 0.0;

  float acc[4][PC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < PC; ++c) acc[a][c] = 0.f;

  for (int jt = 0; jt <= it; ++jt) {
    const int j0 = jt * TL;
    __syncthreads();                 // the last tile's readers are done
    load_bc_rows(sB, ldn, Bm, bc, j0, Q, N);
    load_head_rows(sX, LDP, PW, x, bc, j0, Q, H, h, P);
    for (int r = threadIdx.x; r < TL; r += NT) {
      const int j = j0 + r;
      sCj[r] = j < Q ? cum_h[j] : 0.0;
      sDt[r] = j < Q ? dt[(bc * Q + j) * H + h] : 0.f;
    }
    __syncthreads();

    float s[4][4];
    tile_product(s, sC, sB, ldn, N, tx, ty);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int il = ty + 16 * a, i = i0 + il;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int jl = tx + 16 * b, j = j0 + jl;
        float v = 0.f;
        if (j <= i && i < Q)
          v = s[a][b] * expf((float)(sCi[il] - sCj[jl])) * sDt[jl];
        sA[il * (TL + 1) + jl] = v;
      }
    }
    __syncthreads();

    const int jn = min(TL, Q - j0);
    for (int jl = 0; jl < jn; ++jl) {
      float av[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) av[a] = sA[(ty + 16 * a) * (TL + 1) + jl];
#pragma unroll
      for (int c = 0; c < PC; ++c) {
        const float xv = sX[jl * LDP + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[a][c] = fmaf(av[a], xv, acc[a][c]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty + 16 * a;
#pragma unroll
    for (int c = 0; c < PC; ++c) {
      const int p = tx + 16 * c;
      if (i < Q && p < P)
        y[((bc * Q + i) * H + h) * P + p] = from_f<E>(acc[a][c]);
    }
  }
}

template <int PC>
size_t bwd_head_smem(int Q, int N) {
  const int qp = (Q + TL - 1) / TL * TL;
  return sizeof(double) * 2 * TL +
         sizeof(float) * (2 * TL * odd(N) + 2 * TL * fwd_ld_p<PC>() +
                          2 * TL * (TL + 1) + TL + qp);
}

// ---------------------------------------------------------------- B6, 1
// grid (H, B * nc).  Writes dx, ddt, dlt and this head's dcb.
template <typename E, int PC>
__global__ void __launch_bounds__(NT)
ssd_bwd_head_kernel(const E* __restrict__ x, const float* __restrict__ dt,
                    const double* __restrict__ cum, const E* __restrict__ Bm,
                    const E* __restrict__ Cm, const E* __restrict__ g,
                    E* __restrict__ dx, float* __restrict__ ddt,
                    float* __restrict__ dlt, float* __restrict__ dcb,
                    int Q, int H, int P, int N) {
  extern __shared__ float sm[];
  constexpr int PW = 16 * PC, LDP = fwd_ld_p<PC>();
  const int ldn = odd(N);
  const int nt = (Q + TL - 1) / TL;
  double* sCi = reinterpret_cast<double*>(sm);  // [TL]  cum, rows of tile i
  double* sCj = sCi + TL;                       // [TL]  cum, rows of tile j
  float* sC = reinterpret_cast<float*>(sCj + TL);  // [TL][ldn]  C, tile i
  float* sB = sC + TL * ldn;         // [TL][ldn]  B, rows of tile j
  float* sG = sB + TL * ldn;         // [TL][LDP]  g, rows of tile i
  float* sX = sG + TL * LDP;         // [TL][LDP]  x, rows of tile j
  float* sA = sX + TL * LDP;         // [TL][TL + 1]  att tile; then the
                                     // column reductions' scratch
  float* sS = sA + TL * (TL + 1);    // [TL][TL + 1]  dseg tile, then its
                                     // sums down each column
  float* sDt = sS + TL * (TL + 1);   // [TL]  dt, rows of tile j
  float* sDl = sDt + TL;             // [nt * TL]  dlt

  const int h = blockIdx.x;
  const int64_t bc = blockIdx.y;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const double* cum_h = cum + (bc * H + h) * Q;
  float* dcb_h = dcb + (bc * H + h) * (int64_t)Q * Q;

  for (int r = threadIdx.x; r < nt * TL; r += NT) sDl[r] = 0.f;

  for (int jt = 0; jt < nt; ++jt) {
    const int j0 = jt * TL;
    __syncthreads();                 // the last column's readers are done
    load_bc_rows(sB, ldn, Bm, bc, j0, Q, N);
    load_head_rows(sX, LDP, PW, x, bc, j0, Q, H, h, P);
    for (int r = threadIdx.x; r < TL; r += NT) {
      const int j = j0 + r;
      sCj[r] = j < Q ? cum_h[j] : 0.0;
      sDt[r] = j < Q ? dt[(bc * Q + j) * H + h] : 0.f;
    }

    float dxa[4][PC], dpart[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      dpart[a] = 0.f;
#pragma unroll
      for (int c = 0; c < PC; ++c) dxa[a][c] = 0.f;
    }
    // thread jl < TL: dseg of column j0 + jl summed over the rows below
    float down = 0.f;

    for (int it = nt - 1; it >= jt; --it) {
      const int i0 = it * TL;
      __syncthreads();               // sA / sS / sC / sG readers are done
      load_bc_rows(sC, ldn, Cm, bc, i0, Q, N);
      load_head_rows(sG, LDP, PW, g, bc, i0, Q, H, h, P);
      for (int r = threadIdx.x; r < TL; r += NT)
        sCi[r] = i0 + r < Q ? cum_h[i0 + r] : 0.0;
      __syncthreads();

      float s[4][4], d[4][4];
      tile_product(s, sC, sB, ldn, N, tx, ty);     // cb
      tile_product(d, sG, sX, LDP, P, tx, ty);     // datt = g x^T
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int il = ty + 16 * a, i = i0 + il;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int jl = tx + 16 * b, j = j0 + jl;
          float att = 0.f, dcbv = 0.f, dseg = 0.f;
          if (j <= i && i < Q) {
            const float dec = expf((float)(sCi[il] - sCj[jl]));
            const float dtj = sDt[jl];
            att = s[a][b] * dec * dtj;
            const float dad = d[a][b] * dec;
            dpart[b] += dad * s[a][b];
            dseg = dad * s[a][b] * dtj;
            dcbv = dad * dtj;
          }
          sA[il * (TL + 1) + jl] = att;
          sS[il * (TL + 1) + jl] = dseg;
          if (i < Q && j < Q) dcb_h[(int64_t)i * Q + j] = dcbv;
        }
      }
      __syncthreads();

      // down each column from the bottom: sS[r][jl] becomes the sum of
      // dseg over the rows i >= i0 + r
      if (threadIdx.x < TL) {
        const int jl = threadIdx.x;
        for (int r = TL - 1; r >= 0; --r) {
          down += sS[r * (TL + 1) + jl];
          sS[r * (TL + 1) + jl] = down;
        }
      }
      // dx_j += att^T g: rows j = ty + 16 a of the column tile
      const int in = min(TL, Q - i0);
      for (int il = 0; il < in; ++il) {
        float av[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) av[a] = sA[il * (TL + 1) + ty + 16 * a];
#pragma unroll
        for (int c = 0; c < PC; ++c) {
          const float gv = sG[il * LDP + tx + 16 * c];
#pragma unroll
          for (int a = 0; a < 4; ++a) dxa[a][c] = fmaf(av[a], gv, dxa[a][c]);
        }
      }
      __syncthreads();

      // dlt_t over the columns j < t of this tile: one thread a row t
      if (threadIdx.x < TL) {
        const int r = threadIdx.x, t = i0 + r;
        float acc = 0.f;
        for (int jl = 0; jl < TL; ++jl)
          if (j0 + jl < t) acc += sS[r * (TL + 1) + jl];
        if (t < Q) sDl[t] += acc;
      }
    }

    // column sums (ddt): over the 16 thread rows in order
    __syncthreads();
    float* red = sA;                 // [16][TL]
#pragma unroll
    for (int b = 0; b < 4; ++b) red[ty * TL + tx + 16 * b] = dpart[b];
    __syncthreads();
    if (threadIdx.x < TL) {
      const int jl = threadIdx.x, j = j0 + jl;
      float sd = 0.f;
      for (int t = 0; t < 16; ++t) sd += red[t * TL + jl];
      if (j < Q) ddt[(bc * Q + j) * H + h] = sd;
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int j = j0 + ty + 16 * a;
#pragma unroll
      for (int c = 0; c < PC; ++c) {
        const int p = tx + 16 * c;
        if (j < Q && p < P)
          dx[((bc * Q + j) * H + h) * P + p] = from_f<E>(dxa[a][c]);
      }
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < Q; k += NT)
    dlt[(bc * H + h) * Q + k] = sDl[k];
}

size_t bwd_bc_smem(int Q, int N) {
  const int qp = (Q + TL - 1) / TL * TL;
  return sizeof(float) * (TL * (qp + 1) + (size_t)qp * odd(N));
}

// ---------------------------------------------------------------- B6, 2
// grid (ceil(Q / 64), 2, B * nc).  which 0: dC rows [r0, r0 + 64),
// dC_i = sum_j dcb[i][j] B_j; which 1: dB rows, dB_j = sum_i dcb[i][j] C_i;
// dcb = sum over heads, in head order, of the per-head scratch (j <= i).
template <typename E>
__global__ void __launch_bounds__(NT)
ssd_bwd_bc_kernel(const float* __restrict__ dcb, const E* __restrict__ Bm,
                  const E* __restrict__ Cm, E* __restrict__ dB,
                  E* __restrict__ dC, int Q, int H, int N) {
  extern __shared__ float sm[];
  constexpr int U = 8;               // elements a thread sums at once
  const int qp = (Q + TL - 1) / TL * TL, lds = qp + 1, ldn = odd(N);
  float* sS = sm;                    // [TL][lds]  head-summed dcb slab
  float* sM = sS + TL * lds;         // [qp][ldn]  B (which 0) or C (which 1)

  const int which = blockIdx.y;
  const int r0 = blockIdx.x * TL;
  const int64_t bc = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* D = dcb + bc * H * (int64_t)Q * Q;

  // slab element e -> (r, c): r a row of this block's tile, c the other
  // index; consecutive threads walk consecutive j, the contiguous axis
  for (int e0 = threadIdx.x; e0 < TL * qp; e0 += NT * U) {
    float acc[U];
    int64_t off[U];
    bool live[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * NT;
      int r, c, i, j;
      if (which == 0) { r = e / qp; c = e % qp; i = r0 + r; j = c; }
      else            { c = e / TL; r = e % TL; j = r0 + r; i = c; }
      live[u] = e < TL * qp && i < Q && j <= i;
      off[u] = (int64_t)i * Q + j;
      acc[u] = 0.f;
    }
    for (int hh = 0; hh < H; ++hh) {
      const float* Dh = D + (int64_t)hh * Q * Q;
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (live[u]) acc[u] += Dh[off[u]];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * NT;
      if (e < TL * qp) {
        const int r = which == 0 ? e / qp : e % TL;
        const int c = which == 0 ? e % qp : e / TL;
        sS[r * lds + c] = acc[u];
      }
    }
  }
  const E* M = which == 0 ? Bm : Cm;
  for (int idx = threadIdx.x; idx < qp * N; idx += NT) {
    const int q = idx / N, k = idx % N;
    sM[q * ldn + k] = q < Q ? to_f(M[(bc * Q + q) * N + k]) : 0.f;
  }
  __syncthreads();

  E* out = which == 0 ? dC : dB;
  for (int n0 = 0; n0 < N; n0 += TL) {
    float o[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) o[a][b] = 0.f;
    for (int c = 0; c < qp; ++c) {
      float sv[4], mv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) sv[a] = sS[(ty + 16 * a) * lds + c];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int n = n0 + tx + 16 * b;
        mv[b] = n < N ? sM[c * ldn + n] : 0.f;
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) o[a][b] = fmaf(sv[a], mv[b], o[a][b]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = r0 + ty + 16 * a;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int n = n0 + tx + 16 * b;
        if (row < Q && n < N)
          out[(bc * Q + row) * N + n] = from_f<E>(o[a][b]);
      }
    }
  }
}

template <typename K>
int set_smem(K kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename E, int PC>
int launch_fwd(const void* x, const void* dt, const void* cum, const void* B,
               const void* C, void* y, int BC, int Q, int H, int P, int N,
               cudaStream_t stream) {
  const size_t smem = fwd_smem<PC>(N);
  int err = set_smem(ssd_fwd_kernel<E, PC>, smem);
  if (err != 0) return err;
  dim3 grid((Q + TL - 1) / TL, H, BC);
  ssd_fwd_kernel<E, PC><<<grid, NT, smem, stream>>>(
      (const E*)x, (const float*)dt, (const double*)cum, (const E*)B,
      (const E*)C, (E*)y, Q, H, P, N);
  return (int)cudaGetLastError();
}

template <typename E, int PC>
int launch_bwd(const void* x, const void* dt, const void* cum, const void* B,
               const void* C, const void* g, void* dx, void* ddt, void* dlt,
               void* dB, void* dC, void* dcb, int BC, int Q, int H, int P,
               int N, cudaStream_t stream) {
  const size_t smem = bwd_head_smem<PC>(Q, N);
  int err = set_smem(ssd_bwd_head_kernel<E, PC>, smem);
  if (err != 0) return err;
  ssd_bwd_head_kernel<E, PC><<<dim3(H, BC), NT, smem, stream>>>(
      (const E*)x, (const float*)dt, (const double*)cum, (const E*)B,
      (const E*)C, (const E*)g, (E*)dx, (float*)ddt, (float*)dlt,
      (float*)dcb, Q, H, P, N);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const size_t smem2 = bwd_bc_smem(Q, N);
  err = set_smem(ssd_bwd_bc_kernel<E>, smem2);
  if (err != 0) return err;
  ssd_bwd_bc_kernel<E><<<dim3((Q + TL - 1) / TL, 2, BC), NT, smem2,
                         stream>>>((const float*)dcb, (const E*)B,
                                   (const E*)C, (E*)dB, (E*)dC, Q, H, N);
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

// P <= 16 / 32 / 64 / 128 -> PC 1 / 2 / 4 / 8; dtype 0 = f32, 1 = bf16
#define SSD_DISPATCH(LAUNCH, ...)                                        \
  do {                                                                   \
    if (P <= 0 || P > 128 || Q <= 0 || N <= 0 || H <= 0 ||              \
        (dtype != 0 && dtype != 1))                                      \
      return (int)cudaErrorInvalidValue;                                 \
    if (dtype == 0) {                                                    \
      if (P <= 16) return LAUNCH<float, 1>(__VA_ARGS__);                 \
      if (P <= 32) return LAUNCH<float, 2>(__VA_ARGS__);                 \
      if (P <= 64) return LAUNCH<float, 4>(__VA_ARGS__);                 \
      return LAUNCH<float, 8>(__VA_ARGS__);                              \
    }                                                                    \
    if (P <= 16) return LAUNCH<__nv_bfloat16, 1>(__VA_ARGS__);           \
    if (P <= 32) return LAUNCH<__nv_bfloat16, 2>(__VA_ARGS__);           \
    if (P <= 64) return LAUNCH<__nv_bfloat16, 4>(__VA_ARGS__);           \
    return LAUNCH<__nv_bfloat16, 8>(__VA_ARGS__);                        \
  } while (0)

}  // namespace

extern "C" {

// Tile size, checked by the wrapper.
int ssd_tile() { return TL; }

// y (B,nc,Q,H,P) in x's dtype, cum (B,nc,H,Q) f64.  Returns
// cudaGetLastError() after the launch.
int ssd_fwd(const void* x, const void* dt, const void* cum, const void* B,
            const void* C, void* y, int dtype, int BC, int Q, int H, int P,
            int N, void* stream) {
  SSD_DISPATCH(launch_fwd, x, dt, cum, B, C, y, BC, Q, H, P, N,
               (cudaStream_t)stream);
}

// cum (B,nc,H,Q) f64; dx (B,nc,Q,H,P) in x's dtype, ddt (B,nc,Q,H) f32,
// dlt (B,nc,H,Q) f32, dB / dC (B,nc,Q,N) in their dtype; dcb is a
// (B*nc, H, Q, Q) f32 scratch.
int ssd_bwd(const void* x, const void* dt, const void* cum, const void* B,
            const void* C, const void* g, void* dx, void* ddt, void* dlt,
            void* dB, void* dC, void* dcb, int dtype, int BC, int Q, int H,
            int P, int N, void* stream) {
  SSD_DISPATCH(launch_bwd, x, dt, cum, B, C, g, dx, ddt, dlt, dB, dC, dcb,
               BC, Q, H, P, N, (cudaStream_t)stream);
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
