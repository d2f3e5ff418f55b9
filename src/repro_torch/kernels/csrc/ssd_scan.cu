// SSD intra-chunk term for Hopper (sm_90a): forward (B5) and backward (B6),
// hand-written CUDA C++.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/ssd_scan.py:
//   ssd_fwd  <- _ssd_kernel      (ssd_intra_pallas, :46 / :87)
//   ssd_bwd  <- _ssd_bwd_kernel  (ssd_intra_bwd_pallas, :111 / :189)
//
// What they compute, per (batch * chunk, head) cell, x (B,nc,Q,H,P), dt
// (B,nc,Q,H) f32, cum = cumsum(ltT) (B,nc,H,Q) f32 (taken outside, in
// torch), B / C (B,nc,Q,N) shared across heads; x, B, C and the cotangent g
// in one dtype (f32 or bf16), f32 math:
//   cb[i,j]   = C_i . B_j
//   decay     = exp(cum_i - cum_j) for j <= i, else 0
//   att       = cb * decay * dt_j
//   ssd_fwd   y = att x                                   (y in x's dtype)
//   ssd_bwd   datt = g x^T, dx = att^T g, dad = datt * decay,
//             ddt_j = sum_i dad * cb, dseg = dad * cb * dt_j,
//             dcum = rowsum(dseg) - colsum(dseg),
//             dcb = sum over heads of dad * dt_j, dB = dcb^T C, dC = dcb B
//             (dx in x's dtype, ddt and dcum f32, dB / dC in B's / C's).
// The dltT suffix sum of dcum stays outside, in torch, as in the JAX package.
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
//     column tiles j and, inside, row tiles i >= j, with dx_j and the
//     column sums in registers and the row sums of dseg in shared memory,
//     and writes its head's dcb to a (B*nc, H, Q, Q) f32 scratch;
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
// 2.93 GFLOP and 67.6 MB: 20.2 us, bytes-bound.  These kernels do not
// use the tensor cores (no wgmma, no TMA, no mma.sync): every product is an
// f32 FMA on the CUDA cores (67 TFLOP/s peak), fed by one shared-memory
// word per two FMAs, so they run far from that bound; the times are in
// PERF.md.  What the design does about the bound: it skips the tiles above
// the diagonal (a quarter of the work at Q = 128), never writes att or cb
// to device memory, reads each operand tile once per tile pair, and keeps
// every accumulator in registers.  B6's per-head dcb scratch (84 MB at the
// shape above) is the price of a deterministic head sum.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
  return sizeof(float) * (2 * TL * odd(N) + TL * fwd_ld_p<PC>() +
                          TL * (TL + 1) + 3 * TL);
}

// ---------------------------------------------------------------- B5
// grid (ceil(Q / 64), H, B * nc)
template <typename E, int PC>
__global__ void __launch_bounds__(NT)
ssd_fwd_kernel(const E* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ cum, const E* __restrict__ Bm,
               const E* __restrict__ Cm, E* __restrict__ y, int Q, int H,
               int P, int N) {
  extern __shared__ float sm[];
  constexpr int PW = 16 * PC, LDP = fwd_ld_p<PC>();
  const int ldn = odd(N);
  float* sC = sm;                    // [TL][ldn]  C, rows of tile i
  float* sB = sC + TL * ldn;         // [TL][ldn]  B, rows of tile j
  float* sX = sB + TL * ldn;         // [TL][LDP]  x, rows of tile j
  float* sA = sX + TL * LDP;         // [TL][TL + 1]  att tile
  float* sCi = sA + TL * (TL + 1);   // [TL]  cum, rows of tile i
  float* sCj = sCi + TL;             // [TL]  cum, rows of tile j
  float* sDt = sCj + TL;             // [TL]  dt, rows of tile j

  const int it = blockIdx.x, h = blockIdx.y;
  const int64_t bc = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int i0 = it * TL;
  const float* cum_h = cum + (bc * H + h) * Q;

  load_bc_rows(sC, ldn, Cm, bc, i0, Q, N);
  for (int r = threadIdx.x; r < TL; r += NT)
    sCi[r] = i0 + r < Q ? cum_h[i0 + r] : 0.f;

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
      sCj[r] = j < Q ? cum_h[j] : 0.f;
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
          v = s[a][b] * expf(sCi[il] - sCj[jl]) * sDt[jl];
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
  return sizeof(float) * (2 * TL * odd(N) + 2 * TL * fwd_ld_p<PC>() +
                          TL * (TL + 1) + 3 * TL + 2 * qp);
}

// ---------------------------------------------------------------- B6, 1
// grid (H, B * nc).  Writes dx, ddt, dcum and this head's dcb.
template <typename E, int PC>
__global__ void __launch_bounds__(NT)
ssd_bwd_head_kernel(const E* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ cum, const E* __restrict__ Bm,
                    const E* __restrict__ Cm, const E* __restrict__ g,
                    E* __restrict__ dx, float* __restrict__ ddt,
                    float* __restrict__ dcum, float* __restrict__ dcb,
                    int Q, int H, int P, int N) {
  extern __shared__ float sm[];
  constexpr int PW = 16 * PC, LDP = fwd_ld_p<PC>();
  const int ldn = odd(N);
  const int nt = (Q + TL - 1) / TL;
  float* sC = sm;                    // [TL][ldn]  C, rows of tile i
  float* sB = sC + TL * ldn;         // [TL][ldn]  B, rows of tile j
  float* sG = sB + TL * ldn;         // [TL][LDP]  g, rows of tile i
  float* sX = sG + TL * LDP;         // [TL][LDP]  x, rows of tile j
  float* sA = sX + TL * LDP;         // [TL][TL + 1]  att tile; then the
                                     // column reductions' scratch
  float* sCi = sA + TL * (TL + 1);   // [TL]  cum, rows of tile i
  float* sCj = sCi + TL;             // [TL]  cum, rows of tile j
  float* sDt = sCj + TL;             // [TL]  dt, rows of tile j
  float* sRow = sDt + TL;            // [nt * TL]  row sums of dseg
  float* sCol = sRow + nt * TL;      // [nt * TL]  column sums of dseg

  const int h = blockIdx.x;
  const int64_t bc = blockIdx.y;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* cum_h = cum + (bc * H + h) * Q;
  float* dcb_h = dcb + (bc * H + h) * (int64_t)Q * Q;

  for (int r = threadIdx.x; r < nt * TL; r += NT) sRow[r] = 0.f;

  for (int jt = 0; jt < nt; ++jt) {
    const int j0 = jt * TL;
    __syncthreads();                 // the last column's readers are done
    load_bc_rows(sB, ldn, Bm, bc, j0, Q, N);
    load_head_rows(sX, LDP, PW, x, bc, j0, Q, H, h, P);
    for (int r = threadIdx.x; r < TL; r += NT) {
      const int j = j0 + r;
      sCj[r] = j < Q ? cum_h[j] : 0.f;
      sDt[r] = j < Q ? dt[(bc * Q + j) * H + h] : 0.f;
    }

    float dxa[4][PC], dpart[4], cpart[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      dpart[a] = cpart[a] = 0.f;
#pragma unroll
      for (int c = 0; c < PC; ++c) dxa[a][c] = 0.f;
    }

    for (int it = jt; it < nt; ++it) {
      const int i0 = it * TL;
      __syncthreads();               // sA / sC / sG readers are done
      load_bc_rows(sC, ldn, Cm, bc, i0, Q, N);
      load_head_rows(sG, LDP, PW, g, bc, i0, Q, H, h, P);
      for (int r = threadIdx.x; r < TL; r += NT)
        sCi[r] = i0 + r < Q ? cum_h[i0 + r] : 0.f;
      __syncthreads();

      float s[4][4], d[4][4];
      tile_product(s, sC, sB, ldn, N, tx, ty);     // cb
      tile_product(d, sG, sX, LDP, P, tx, ty);     // datt = g x^T
      float rpart[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int il = ty + 16 * a, i = i0 + il;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int jl = tx + 16 * b, j = j0 + jl;
          float att = 0.f, dcbv = 0.f;
          if (j <= i && i < Q) {
            const float dec = expf(sCi[il] - sCj[jl]);
            const float dtj = sDt[jl];
            att = s[a][b] * dec * dtj;
            const float dad = d[a][b] * dec;
            dpart[b] += dad * s[a][b];
            const float dseg = dad * s[a][b] * dtj;
            rpart[a] += dseg;
            cpart[b] += dseg;
            dcbv = dad * dtj;
          }
          sA[il * (TL + 1) + jl] = att;
          if (i < Q && j < Q) dcb_h[(int64_t)i * Q + j] = dcbv;
        }
      }
      // row sums: over the half-warp's 16 threads, then across column
      // tiles in order (one thread per row per tile)
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float v = half_warp_sum(rpart[a]);
        if (tx == 0) sRow[i0 + ty + 16 * a] += v;
      }
      __syncthreads();

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
    }

    // column sums (ddt, colsum of dseg): over the 16 thread rows in order
    __syncthreads();
    float* red = sA;                 // [2][16][TL]
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      red[ty * TL + tx + 16 * b] = dpart[b];
      red[16 * TL + ty * TL + tx + 16 * b] = cpart[b];
    }
    __syncthreads();
    if (threadIdx.x < TL) {
      const int jl = threadIdx.x, j = j0 + jl;
      float sd = 0.f, sc = 0.f;
      for (int t = 0; t < 16; ++t) {
        sd += red[t * TL + jl];
        sc += red[16 * TL + t * TL + jl];
      }
      if (j < Q) {
        ddt[(bc * Q + j) * H + h] = sd;
        sCol[j] = sc;
      }
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
    dcum[(bc * H + h) * Q + k] = sRow[k] - sCol[k];
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
      (const E*)x, (const float*)dt, (const float*)cum, (const E*)B,
      (const E*)C, (E*)y, Q, H, P, N);
  return (int)cudaGetLastError();
}

template <typename E, int PC>
int launch_bwd(const void* x, const void* dt, const void* cum, const void* B,
               const void* C, const void* g, void* dx, void* ddt, void* dcum,
               void* dB, void* dC, void* dcb, int BC, int Q, int H, int P,
               int N, cudaStream_t stream) {
  const size_t smem = bwd_head_smem<PC>(Q, N);
  int err = set_smem(ssd_bwd_head_kernel<E, PC>, smem);
  if (err != 0) return err;
  ssd_bwd_head_kernel<E, PC><<<dim3(H, BC), NT, smem, stream>>>(
      (const E*)x, (const float*)dt, (const float*)cum, (const E*)B,
      (const E*)C, (const E*)g, (E*)dx, (float*)ddt, (float*)dcum,
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

// y (B,nc,Q,H,P) in x's dtype.  Returns cudaGetLastError() after the launch.
int ssd_fwd(const void* x, const void* dt, const void* cum, const void* B,
            const void* C, void* y, int dtype, int BC, int Q, int H, int P,
            int N, void* stream) {
  SSD_DISPATCH(launch_fwd, x, dt, cum, B, C, y, BC, Q, H, P, N,
               (cudaStream_t)stream);
}

// dx (B,nc,Q,H,P) in x's dtype, ddt (B,nc,Q,H) f32, dcum (B,nc,H,Q) f32,
// dB / dC (B,nc,Q,N) in their dtype; dcb is a (B*nc, H, Q, Q) f32 scratch.
int ssd_bwd(const void* x, const void* dt, const void* cum, const void* B,
            const void* C, const void* g, void* dx, void* ddt, void* dcum,
            void* dB, void* dC, void* dcb, int dtype, int BC, int Q, int H,
            int P, int N, void* stream) {
  SSD_DISPATCH(launch_bwd, x, dt, cum, B, C, g, dx, ddt, dcum, dB, dC, dcb,
               BC, Q, H, P, N, (cudaStream_t)stream);
}

}  // extern "C"
