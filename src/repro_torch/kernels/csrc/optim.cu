// Fused optimizer update of a whole parameter tree for Hopper (sm_90a): B1
// as one launch per tree, hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/optim.py:
//   tree_update <- _stacked_leaf_update (:102, pallas_call :130; bodies
//                  _sgd_kernel / _momentum_kernel / _adam_kernel :47-90)
// The TPU kernel updates one leaf for M stacked members per launch.  Here
// one launch updates every leaf of a tree (up to CAP leaves; a larger tree
// goes out as the fewest launches that hold it), for M members, each
// member with its own hyper-parameters: (M,) f32 device vectors, read by
// the member index, never immediates, so a new value recompiles nothing.
//
// What it computes, per element, in f32 and cast back to the leaf's dtype
// (f32 or bf16; one dtype per leaf, any mix of dtypes per tree):
//   sgd       p' = p - lr (g + wd p)
//   momentum  m' = mom m + g,                  p' = p - lr (m' + wd p)
//   adam(w)   m' = b1 m + (1 - b1) g,  v' = b2 v + (1 - b2) g g,
//             mh = m' / bc1,  vh = v' / bc2,  d = sqrt(vh) + eps,
//             adamw p' = p - lr (mh / d + wd p)
//             adam  p' = p - (lr mh) / d - (lr wd) p
// The expressions are written with explicit round-to-nearest intrinsics in
// the contractions the Triton per-leaf kernel (kernels/optim.py) compiles
// to (read from its PTX on the card): a product feeding a sum becomes one
// fma (where both terms are products, the second: (1 - b1) g and
// ((1 - b2) g) g), p - lr x becomes fma(-lr, x, p), / and sqrt are IEEE.
// So the two kernels give the same bits for the same inputs
// (chip_smoke.py holds them to torch.equal).
//
// Layout.  The leaf table rides in the kernel's parameter space, by value
// (`__grid_constant__`): 18 int64 per leaf, written by the wrapper —
// pointers of p, g, m, v and of the outputs p', m', v' (member 0), the
// elements per member n, the leaf's first block, flags (bf16; 16-byte
// vectors allowed; g read through strides), g's member stride, and for a
// strided g its strides and the sizes of dims 1..3 of the leaf's (<= 4-D)
// shape.  CUDA >= 12.1 on Hopper takes 32,764 bytes of parameters: 224
// leaves a launch.  p, m, v and the outputs are contiguous per member (the
// small leaves' outputs are 16-byte-aligned views of one fresh buffer per
// (output, dtype)); g may be any strided view — ResNet's weight gradient
// arrives as an HWIO view of an OIHW tensor — and is then gathered element
// by element through its strides instead of being copied first.
//
// Work: the flattened tree is cut into chunks of BLK = 2,048 consecutive
// elements of one member of one leaf, 8 per thread; a leaf's chunks start
// at its first block (a prefix sum held in the parameter space).  Grid
// (chunks, M members): a block takes one chunk and finds its leaf by a
// binary search over the first blocks.  A thread's 8 elements of an
// aligned bf16 leaf are one 16-byte vector per array, kept packed and
// opened two at a time; every other case (f32, ragged, unaligned, strided
// g) goes in two runs of 4 (16- or 8-byte vectors where aligned, else
// element by element), so that no path needs more registers than the
// packed one and more threads fit an SM: the update is a long chain of
// IEEE divides and square roots per element, and those threads hide it.
//
// Bound on an H100 SXM: bytes / 3.35 TB/s — sgd reads p, g and writes p;
// momentum reads p, g, m and writes p, m; adam reads p, g, m, v and writes
// p, m, v; a few flops per element, so device memory sets the least time.
// ResNet56's momentum tree moves 17 MB (5 us); what kept the per-leaf
// design from it was the host: 114 launches, 57 copies of strided
// gradients and 228 allocations per step.  One launch, no copy and one
// allocation per (output, dtype) are what this design does about it.
//
// Determinism: elementwise, no reduction, no atomics: the same inputs give
// the same bits on every launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;              // threads per block
constexpr int PER_THREAD = 8;        // consecutive elements per thread
constexpr int BLK = NT * PER_THREAD;  // elements of one member per chunk
constexpr int REC = 18;              // int64 fields per leaf record

// fields of a leaf record (kernels/optim.py writes them in this order)
enum {
  F_P, F_G, F_M, F_V, F_OP, F_OM, F_OV, F_N, F_BLOCK0, F_FLAGS, F_GMEMBER,
  F_GS0, F_GS1, F_GS2, F_GS3, F_S1, F_S2, F_S3
};
constexpr int64_t FLAG_BF16 = 1;     // every array of the leaf is bf16
constexpr int64_t FLAG_VEC = 2;      // p, m, v, outputs: 16-byte vectors
constexpr int64_t FLAG_GVEC = 4;     // g contiguous, 16-byte vectors
constexpr int64_t FLAG_GSTRIDED = 8;  // g read through its strides

enum { SGD = 0, MOMENTUM = 1, ADAM = 2, ADAMW = 3 };

#if CUDART_VERSION >= 12010
constexpr int CAP_BIG = 224;   // 64 + 224 * 144 = 32,320 of 32,764 bytes
#else
constexpr int CAP_BIG = 27;    // the 4,096 bytes of older toolkits
#endif
constexpr int CAP_SMALL = 16;  // small trees: a short parameter copy

template <int CAP>
struct Tree {
  const float* hp[7];  // (M,) f32: lr, wd, then mom | b1, b2, eps, bc1, bc2
  int32_t n_leaves;
  int32_t pad;
  int64_t leaf[CAP][REC];
};

struct Hp {
  float lr, wd, mom, b1, b2, eps, bc1, bc2, omb1, omb2;
};

// One 16- or 8-byte global store, written as PTX: nvcc split the plain
// vector assignments here into 4-byte stores (four store instructions a
// thread and array where one serves).
__device__ __forceinline__ void st_v4(void* p, uint32_t a, uint32_t b,
                                      uint32_t c, uint32_t d) {
  asm volatile("st.global.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"l"(p),
               "r"(a), "r"(b), "r"(c), "r"(d)
               : "memory");
}
__device__ __forceinline__ void st_v2(void* p, uint32_t a, uint32_t b) {
  asm volatile("st.global.v2.b32 [%0], {%1, %2};\n" ::"l"(p), "r"(a),
               "r"(b)
               : "memory");
}

// 4 consecutive elements (cnt of them, the rest 0): one 16-byte (f32) or
// 8-byte (bf16) vector where allowed, else element by element
__device__ __forceinline__ void load4(const float* a, int64_t off, int cnt,
                                      bool vec, float (&x)[4]) {
  if (vec && cnt == 4) {
    const float4 u = *reinterpret_cast<const float4*>(a + off);
    x[0] = u.x; x[1] = u.y; x[2] = u.z; x[3] = u.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) x[k] = k < cnt ? a[off + k] : 0.f;
  }
}

__device__ __forceinline__ void load4(const __nv_bfloat16* a, int64_t off,
                                      int cnt, bool vec, float (&x)[4]) {
  if (vec && cnt == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(a + off);
    x[0] = __uint_as_float(u.x << 16);               // the lower bf16
    x[1] = __uint_as_float(u.x & 0xffff0000u);
    x[2] = __uint_as_float(u.y << 16);
    x[3] = __uint_as_float(u.y & 0xffff0000u);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      x[k] = k < cnt ? __bfloat162float(a[off + k]) : 0.f;
  }
}

__device__ __forceinline__ void store4(float* a, int64_t off, int cnt,
                                       bool vec, const float (&x)[4]) {
  if (vec && cnt == 4) {
    st_v4(a + off, __float_as_uint(x[0]), __float_as_uint(x[1]),
          __float_as_uint(x[2]), __float_as_uint(x[3]));
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (k < cnt) a[off + k] = x[k];
  }
}

__device__ __forceinline__ void store4(__nv_bfloat16* a, int64_t off, int cnt,
                                       bool vec, const float (&x)[4]) {
  if (vec && cnt == 4) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(x[0], x[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(x[2], x[3]);
    st_v2(a + off, *reinterpret_cast<uint32_t*>(&lo),
          *reinterpret_cast<uint32_t*>(&hi));
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (k < cnt) a[off + k] = __float2bfloat16_rn(x[k]);
  }
}

// g's elements e0 .. e0 + cnt - 1 (cnt <= 4) of member `member`:
// contiguous (vectors where allowed) or gathered through the strides of a
// <= 4-D view.
template <typename E>
__device__ __forceinline__ void load_g(const int64_t* L, int member,
                                       int64_t e0, int cnt, float (&x)[4]) {
  const E* g = reinterpret_cast<const E*>(L[F_G]);
  const int64_t flags = L[F_FLAGS];
  const int64_t mo = (int64_t)member * L[F_GMEMBER];
  if (!(flags & FLAG_GSTRIDED)) {
    load4(g, mo + e0, cnt, (flags & FLAG_GVEC) != 0, x);
    return;
  }
  // 32-bit index arithmetic: the wrapper gathers only leaves of < 2^32
  // elements through strides
  const uint32_t s1 = (uint32_t)L[F_S1], s2 = (uint32_t)L[F_S2],
                 s3 = (uint32_t)L[F_S3];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float val = 0.f;
    if (k < cnt) {
      uint32_t i = (uint32_t)(e0 + k);
      const uint32_t i3 = i % s3;
      i /= s3;
      const uint32_t i2 = i % s2;
      i /= s2;
      const uint32_t i1 = i % s1;
      const uint32_t i0 = i / s1;
      const int64_t off = mo + i0 * L[F_GS0] + i1 * L[F_GS1] +
                          i2 * L[F_GS2] + i3 * L[F_GS3];
      if constexpr (sizeof(E) == 4)
        val = g[off];
      else
        val = __bfloat162float(g[off]);
    }
    x[k] = val;
  }
}

// One element's update, in the contractions of the Triton kernel.
template <int OPT>
__device__ __forceinline__ void update(float& p, float g, float& m, float& v,
                                       const Hp& h) {
  if (OPT == SGD) {
    const float t = __fmaf_rn(h.wd, p, g);                  // g + wd p
    p = __fmaf_rn(-h.lr, t, p);                             // p - lr t
  } else if (OPT == MOMENTUM) {
    m = __fmaf_rn(h.mom, m, g);                             // mom m + g
    const float t = __fmaf_rn(h.wd, p, m);                  // m' + wd p
    p = __fmaf_rn(-h.lr, t, p);
  } else {
    m = __fmaf_rn(h.omb1, g, __fmul_rn(h.b1, m));           // b1 m + (1-b1) g
    v = __fmaf_rn(__fmul_rn(h.omb2, g), g, __fmul_rn(h.b2, v));
    const float mh = __fdiv_rn(m, h.bc1);
    const float vh = __fdiv_rn(v, h.bc2);
    const float denom = __fadd_rn(__fsqrt_rn(vh), h.eps);
    if (OPT == ADAMW) {
      const float t = __fmaf_rn(h.wd, p, __fdiv_rn(mh, denom));
      p = __fmaf_rn(-h.lr, t, p);
    } else {                     // adam: wd folded into the gradient (L2)
      const float x = __fsub_rn(p, __fdiv_rn(__fmul_rn(h.lr, mh), denom));
      p = __fmaf_rn(-__fmul_rn(h.lr, h.wd), p, x);
    }
  }
}

// bf16, every operand 16-byte aligned and contiguous, 8 elements: the
// loads stay packed (4 registers an array) and are opened two elements at
// a time, so that few registers are live and many threads fit an SM
template <int OPT>
__device__ __forceinline__ void bf16_packed(const int64_t* L, int64_t off,
                                            int64_t goff, const Hp& h) {
  typedef const uint4* In;
  const uint4 P = *reinterpret_cast<In>(
      reinterpret_cast<const __nv_bfloat16*>(L[F_P]) + off);
  const uint4 G = *reinterpret_cast<In>(
      reinterpret_cast<const __nv_bfloat16*>(L[F_G]) + goff);
  uint4 Mw = make_uint4(0u, 0u, 0u, 0u), Vw = Mw;
  if (OPT != SGD)
    Mw = *reinterpret_cast<In>(
        reinterpret_cast<const __nv_bfloat16*>(L[F_M]) + off);
  if (OPT == ADAM || OPT == ADAMW)
    Vw = *reinterpret_cast<In>(
        reinterpret_cast<const __nv_bfloat16*>(L[F_V]) + off);
  const uint32_t pw[4] = {P.x, P.y, P.z, P.w}, gw[4] = {G.x, G.y, G.z, G.w};
  const uint32_t mw[4] = {Mw.x, Mw.y, Mw.z, Mw.w};
  const uint32_t vw[4] = {Vw.x, Vw.y, Vw.z, Vw.w};
  uint32_t po[4], mo[4], vo[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float p[2], m[2], v[2];
    const float g[2] = {__uint_as_float(gw[k] << 16),
                        __uint_as_float(gw[k] & 0xffff0000u)};
    p[0] = __uint_as_float(pw[k] << 16);
    p[1] = __uint_as_float(pw[k] & 0xffff0000u);
    m[0] = __uint_as_float(mw[k] << 16);
    m[1] = __uint_as_float(mw[k] & 0xffff0000u);
    v[0] = __uint_as_float(vw[k] << 16);
    v[1] = __uint_as_float(vw[k] & 0xffff0000u);
    update<OPT>(p[0], g[0], m[0], v[0], h);
    update<OPT>(p[1], g[1], m[1], v[1], h);
    __nv_bfloat162 t = __floats2bfloat162_rn(p[0], p[1]);
    po[k] = *reinterpret_cast<uint32_t*>(&t);
    t = __floats2bfloat162_rn(m[0], m[1]);
    mo[k] = *reinterpret_cast<uint32_t*>(&t);
    t = __floats2bfloat162_rn(v[0], v[1]);
    vo[k] = *reinterpret_cast<uint32_t*>(&t);
  }
  st_v4(reinterpret_cast<__nv_bfloat16*>(L[F_OP]) + off, po[0], po[1],
        po[2], po[3]);
  if (OPT != SGD)
    st_v4(reinterpret_cast<__nv_bfloat16*>(L[F_OM]) + off, mo[0], mo[1],
          mo[2], mo[3]);
  if (OPT == ADAM || OPT == ADAMW)
    st_v4(reinterpret_cast<__nv_bfloat16*>(L[F_OV]) + off, vo[0], vo[1],
          vo[2], vo[3]);
}

template <int OPT, typename E>
__device__ __forceinline__ void leaf_chunk(const int64_t* L, int member,
                                           int64_t e0, int64_t n,
                                           const Hp& h) {
  const int64_t flags = L[F_FLAGS];
  const bool vec = (flags & FLAG_VEC) != 0;
  const int64_t off = (int64_t)member * n + e0;
  const int cnt = (int)(n - e0 < PER_THREAD ? n - e0 : PER_THREAD);
  if constexpr (sizeof(E) == 2) {
    if (vec && (flags & FLAG_GVEC) && cnt == PER_THREAD) {
      bf16_packed<OPT>(L, off, (int64_t)member * L[F_GMEMBER] + e0, h);
      return;
    }
  }
  // every other case — f32, ragged, unaligned or strided — in two runs of
  // 4, so that this path needs no more registers than the packed one
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int e = 4 * half;
    const int c4 = cnt - e < 0 ? 0 : (cnt - e > 4 ? 4 : cnt - e);
    float p[4], g[4], m[4], v[4];
    load4(reinterpret_cast<const E*>(L[F_P]), off + e, c4, vec, p);
    load_g<E>(L, member, e0 + e, c4, g);
    if (OPT != SGD)
      load4(reinterpret_cast<const E*>(L[F_M]), off + e, c4, vec, m);
    if (OPT == ADAM || OPT == ADAMW)
      load4(reinterpret_cast<const E*>(L[F_V]), off + e, c4, vec, v);
#pragma unroll
    for (int k = 0; k < 4; ++k) update<OPT>(p[k], g[k], m[k], v[k], h);
    store4(reinterpret_cast<E*>(L[F_OP]), off + e, c4, vec, p);
    if (OPT != SGD) store4(reinterpret_cast<E*>(L[F_OM]), off + e, c4, vec, m);
    if (OPT == ADAM || OPT == ADAMW)
      store4(reinterpret_cast<E*>(L[F_OV]), off + e, c4, vec, v);
  }
}

// grid (the tree's chunks, M members): a block updates one chunk, as the
// per-leaf kernel's programs do one block of a leaf (a grid-stride loop
// over fewer, persistent blocks ran slower on the large trees)
template <int OPT, int CAP>
__global__ void __launch_bounds__(NT)
tree_update_kernel(const __grid_constant__ Tree<CAP> t) {
  const int64_t c = blockIdx.x;
  int lo = 0, hi = t.n_leaves - 1;   // the last leaf whose first chunk <= c
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.leaf[mid][F_BLOCK0] <= c) lo = mid;
    else hi = mid - 1;
  }
  const int64_t* L = t.leaf[lo];
  const int64_t n = L[F_N];
  const int64_t e0 = (c - L[F_BLOCK0]) * BLK + threadIdx.x * PER_THREAD;
  if (e0 >= n) return;
  const int member = blockIdx.y;
  Hp h;
  h.lr = t.hp[0][member];
  h.wd = t.hp[1][member];
  h.mom = h.b1 = h.b2 = h.eps = h.bc1 = h.bc2 = h.omb1 = h.omb2 = 0.f;
  if (OPT == MOMENTUM) h.mom = t.hp[2][member];
  if (OPT == ADAM || OPT == ADAMW) {
    h.b1 = t.hp[2][member];
    h.b2 = t.hp[3][member];
    h.eps = t.hp[4][member];
    h.bc1 = t.hp[5][member];
    h.bc2 = t.hp[6][member];
    h.omb1 = __fsub_rn(1.f, h.b1);
    h.omb2 = __fsub_rn(1.f, h.b2);
  }
  if (L[F_FLAGS] & FLAG_BF16)
    leaf_chunk<OPT, __nv_bfloat16>(L, member, e0, n, h);
  else
    leaf_chunk<OPT, float>(L, member, e0, n, h);
}

template <int OPT, int CAP>
int launch(const int64_t* table, int n_leaves, int blocks, int M,
           const float* const* hp, cudaStream_t stream) {
  Tree<CAP> t;
  for (int i = 0; i < 7; ++i) t.hp[i] = hp[i];
  t.n_leaves = n_leaves;
  t.pad = 0;
  for (int i = 0; i < n_leaves; ++i)
    for (int f = 0; f < REC; ++f) t.leaf[i][f] = table[i * REC + f];
  tree_update_kernel<OPT, CAP><<<dim3(blocks, M), NT, 0, stream>>>(t);
  return (int)cudaGetLastError();
}

template <int OPT>
int launch_opt(const int64_t* table, int n_leaves, int blocks, int M,
               const float* const* hp, cudaStream_t stream) {
  if (n_leaves <= CAP_SMALL)
    return launch<OPT, CAP_SMALL>(table, n_leaves, blocks, M, hp, stream);
  return launch<OPT, CAP_BIG>(table, n_leaves, blocks, M, hp, stream);
}

}  // namespace

extern "C" {

// Leaves per launch at most, elements per block, int64 fields per leaf
// record: checked by the wrapper.
int tree_capacity() { return CAP_BIG; }
int tree_block() { return BLK; }
int tree_record() { return REC; }

// One launch over `n_leaves` records (int64 [n_leaves][18], host memory)
// whose first blocks are relative to this launch and which cover `blocks`
// blocks, for M members; hp: 7 device pointers of (M,) f32 (unused ones
// may be null).  opt 0 sgd, 1 momentum, 2 adam, 3 adamw.  Returns
// cudaGetLastError() after the launch.
int tree_update(int opt, const void* table, int n_leaves, int blocks, int M,
                const void* hp, void* stream) {
  if (n_leaves <= 0 || n_leaves > CAP_BIG || blocks <= 0 || M <= 0 ||
      M > 65535)
    return (int)cudaErrorInvalidValue;
  const int64_t* tab = (const int64_t*)table;
  const float* const* h = (const float* const*)hp;
  cudaStream_t st = (cudaStream_t)stream;
  switch (opt) {
    case SGD: return launch_opt<SGD>(tab, n_leaves, blocks, M, h, st);
    case MOMENTUM: return launch_opt<MOMENTUM>(tab, n_leaves, blocks, M, h, st);
    case ADAM: return launch_opt<ADAM>(tab, n_leaves, blocks, M, h, st);
    case ADAMW: return launch_opt<ADAMW>(tab, n_leaves, blocks, M, h, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
