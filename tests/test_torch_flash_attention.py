"""Flash attention of the PyTorch package held against the JAX package.

On the CPU the wrappers take their plain versions (whole-matrix PyTorch);
the CUDA kernels themselves are held against the same plain versions on
the card by ``chip_smoke.py``.  Here, with numpy-seeded inputs fed to both
packages:

* the plain forward (``out``, ``lse``, executed-tile count) against
  ``flash_attention_fwd(..., interpret=True, return_lse=True,
  count_tiles=True)`` with the tiles of the port's kernel for the dtype
  and head dim (f32 ``simt_blocks``: 64 query rows × 64 keys at head dim
  64; bf16 128 × 128), and the plain forward's rounding of the
  probabilities to bf16 for a bf16 ``v`` (only then);
* the plain backward (dq, dk, dv) against ``flash_attention_bwd(...,
  interpret=True)``;
* the ``torch.autograd.Function`` binding's gradients against
  ``torch.autograd`` through ``attention_ref``;
* ``fa_tile_counts`` against the JAX package's, and the CUDA kernels' loop
  bounds (``_live_range``) against the tile predicate, at the f32 kernels'
  tiles of every padded head dim, at the bf16 forward's 128 × 128 and at
  the bf16 backward's tiles (B3 128 × 128, B4 64 query rows × 128 keys);
* the grid's block order (``launch_order``): every live tile walked once,
  the heaviest blocks first under causal masking, a KV head's query heads
  side by side;
* the forward's and the backward's routes by dtype and head dim
  (``fwd_route``, ``bwd_route``);
* the tensor-core kernels' register and shared-memory maps (``wgmma``
  fragments, TMA's 128-byte swizzle, the descriptors' offsets, the
  backward's per-row and per-column lse maps) mirrored in Python, held
  against plain products of one tile;
* the fallback on CPU tensors counted and warned once.

Grid and tolerances are those of ``tests/test_kernels.py``: forward f32
2e-5, bf16 2e-2; gradients atol 2e-4, rtol 2e-3 (f32).
"""

import warnings
from typing import Tuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import fa_tile_counts as jax_tile_counts
from repro.kernels.flash_attention import flash_attention_bwd as jax_bwd
from repro.kernels.flash_attention import flash_attention_fwd as jax_fwd
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import attention_ref

# the suite runs several worker processes side by side: one intra-op
# thread each, or the workers fight over the cores
torch.set_num_threads(1)

SHAPES = [
    (1, 128, 4, 4, 64),      # MHA
    (2, 128, 8, 2, 64),      # GQA 4:1
    (1, 256, 8, 1, 32),      # MQA
    (1, 96, 4, 2, 64),       # ragged (not a multiple of the tile)
    (2, 64, 2, 1, 128),      # large head dim
]
MASKS = [(True, 0), (False, 0), (True, 48)]
GRAD_TOL = dict(atol=2e-4, rtol=2e-3)


def tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" else \
        dict(atol=2e-5, rtol=2e-5)


def inputs(B, S, Hq, Hkv, hd, seed, n_extra=0):
    """q, k, v (and ``n_extra`` more q-shaped arrays) as f32 numpy."""
    rng = np.random.default_rng(seed)
    shapes = [(B, S, Hq, hd), (B, S, Hkv, hd), (B, S, Hkv, hd)]
    shapes += [(B, S, Hq, hd)] * n_extra
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def to_jax(x, dtype):
    return jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16"
                       else jnp.float32)


def to_torch(x, dtype):
    return torch.tensor(np.asarray(x, np.float32)).to(
        torch.bfloat16 if dtype == "bfloat16" else torch.float32)


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


FWD_CASES = [(dtype, s, m) for dtype in ("float32", "bfloat16")
             for s in SHAPES for m in MASKS]


@pytest.mark.parametrize("dtype,shape,mask", FWD_CASES)
def test_plain_forward_matches_jax_kernel(dtype, shape, mask):
    """The JAX kernel runs at the tiles of the port's kernel for the dtype
    (it clamps a tile to a shorter sequence; the count stays one tile)."""
    causal, window = mask
    q, k, v = inputs(*shape, seed=sum(shape))
    bq, bk = fa.fwd_blocks(to_torch(q[:0], dtype).dtype, shape[4])
    jo, jl, jt = jax_fwd(*(to_jax(a, dtype) for a in (q, k, v)),
                         causal=causal, window=window,
                         block_q=bq, block_k=bk,
                         return_lse=True, count_tiles=True, interpret=True)
    to, tl, tt = fa.flash_attention_fwd(
        *(to_torch(a, dtype) for a in (q, k, v)), causal=causal,
        window=window, return_lse=True, count_tiles=True)
    assert to.dtype == (torch.bfloat16 if dtype == "bfloat16"
                        else torch.float32)
    assert tuple(to.shape) == jo.shape and tuple(tl.shape) == jl.shape
    np.testing.assert_allclose(f32(to), f32(jo), **tol(dtype))
    np.testing.assert_allclose(f32(tl), f32(jl), **tol(dtype))
    assert tt == int(jt)


BWD_CASES = [
    ("float32", (1, 128, 4, 4, 64), True, 0),       # MHA causal
    ("float32", (2, 128, 8, 2, 64), True, 48),      # GQA 4:1 + window
    ("float32", (1, 96, 4, 2, 64), False, 0),       # ragged, non-causal
    ("bfloat16", (2, 128, 8, 2, 64), True, 0),      # GQA in bf16
]


@pytest.mark.parametrize("dtype,shape,causal,window", BWD_CASES)
def test_plain_backward_matches_jax_kernel(dtype, shape, causal, window):
    """Same residuals (the JAX forward's out and lse) into both backwards;
    bf16 keeps the per-query-head dk / dv rounding before the group sum."""
    q, k, v, do = inputs(*shape, seed=sum(shape) + 1, n_extra=1)
    jq, jk, jv, jdo = (to_jax(a, dtype) for a in (q, k, v, do))
    jo, jl = jax_fwd(jq, jk, jv, causal=causal, window=window,
                     return_lse=True, interpret=True)
    jg = jax_bwd(jq, jk, jv, jo, jl, jdo, causal=causal, window=window,
                 interpret=True)
    tg = fa.flash_attention_bwd(
        *(to_torch(a, dtype) for a in (q, k, v, jo)),
        torch.tensor(np.asarray(jl)), to_torch(do, dtype), causal=causal,
        window=window)
    t = GRAD_TOL if dtype == "float32" else tol(dtype)
    for a, b, name in zip(tg, jg, ("dq", "dk", "dv")):
        assert tuple(a.shape) == b.shape and a.dtype == to_torch(q, dtype).dtype
        np.testing.assert_allclose(f32(a), f32(b), err_msg=name, **t)


# head dims 80 (hubert-xlarge, MHA, non-causal) and 256 (recurrentgemma-2b,
# MQA, windowed): the bf16 kernels pad 80 to two 64-column blocks and take
# 256 in four, with 64-key tiles (``tc_blocks``)
WIDE_CASES = [(dtype, shape, mask) for dtype in ("float32", "bfloat16")
              for shape, mask in (((1, 96, 2, 2, 80), (False, 0)),
                                  ((1, 96, 2, 2, 80), (True, 48)),
                                  ((1, 160, 2, 1, 256), (True, 0)),
                                  ((1, 160, 2, 1, 256), (True, 48)))]


@pytest.mark.parametrize("dtype,shape,mask", WIDE_CASES)
def test_plain_forward_at_head_dims_80_and_256_matches_jax_kernel(
        dtype, shape, mask):
    """The plain forward against the Pallas kernel under ``interpret=True``
    at the tiles of the port's kernel for the dtype and head dim: out,
    lse and the executed-tile count."""
    causal, window = mask
    q, k, v = inputs(*shape, seed=sum(shape) + 5)
    bq, bk = fa.fwd_blocks(to_torch(q[:0], dtype).dtype, shape[4])
    jo, jl, jt = jax_fwd(*(to_jax(a, dtype) for a in (q, k, v)),
                         causal=causal, window=window, block_q=bq,
                         block_k=bk, return_lse=True, count_tiles=True,
                         interpret=True)
    to, tl, tt = fa.flash_attention_fwd(
        *(to_torch(a, dtype) for a in (q, k, v)), causal=causal,
        window=window, return_lse=True, count_tiles=True)
    np.testing.assert_allclose(f32(to), f32(jo), **tol(dtype))
    np.testing.assert_allclose(f32(tl), f32(jl), **tol(dtype))
    assert tt == int(jt) > 0


@pytest.mark.parametrize("dtype,shape,mask", WIDE_CASES)
def test_plain_backward_at_head_dims_80_and_256_matches_jax_kernel(
        dtype, shape, mask):
    """The plain backward (dq, dk, dv) against the Pallas backward under
    ``interpret=True`` on the JAX forward's residuals."""
    causal, window = mask
    q, k, v, do = inputs(*shape, seed=sum(shape) + 6, n_extra=1)
    jq, jk, jv, jdo = (to_jax(a, dtype) for a in (q, k, v, do))
    jo, jl = jax_fwd(jq, jk, jv, causal=causal, window=window,
                     return_lse=True, interpret=True)
    jg = jax_bwd(jq, jk, jv, jo, jl, jdo, causal=causal, window=window,
                 interpret=True)
    tg = fa.flash_attention_bwd(
        *(to_torch(a, dtype) for a in (q, k, v, jo)),
        torch.tensor(np.asarray(jl)), to_torch(do, dtype), causal=causal,
        window=window)
    t = GRAD_TOL if dtype == "float32" else tol(dtype)
    for a, b, name in zip(tg, jg, ("dq", "dk", "dv")):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(f32(a), f32(b), err_msg=name, **t)


@pytest.mark.parametrize("S", [64, 96, 130, 1024, 4096])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 1),
                                           (True, 48), (True, 127),
                                           (True, 2048), (False, 100)])
def test_wide_head_dim_loop_bounds_are_the_live_tiles(S, causal, window):
    """Above head dim 128 the kernels' loop bounds at their tiles — B2 /
    B3 ``kv_range<128, 64>``, B4 ``q_range<64, 64>`` (bf16) and the f32
    B2 / B3's ``kv_range<32, 32>`` and B4's ``q_range<32, 32>`` — cover
    exactly the live tiles, and the counts are the JAX package's at the
    same tiles."""
    tiles = [fa.tc_blocks("fwd", 256) + (True,),
             fa.tc_blocks("dq", 256) + (True,),
             fa.tc_blocks("dkv", 256) + (False,),
             fa.simt_blocks("fwd", 256) + (True,),
             fa.simt_blocks("dkv", 256) + (False,)]
    assert [t[:2] for t in tiles] == [(128, 64), (128, 64), (64, 64),
                                      (32, 32), (32, 32)]
    for bq, bk, kv_loop in tiles:
        nq, nk = -(-S // bq), -(-S // bk)
        live = {(qi, ki) for qi in range(nq) for ki in range(nk)
                if fa._tile_live(qi, ki, causal=causal, window=window, bq=bq,
                                 bk=bk, seq_k=S)}
        walked = set()
        for tile in range(nq if kv_loop else nk):
            lo, hi = fa._live_range(tile, nk if kv_loop else nq,
                                    kv_loop=kv_loop, causal=causal,
                                    window=window, bq=bq, bk=bk)
            walked |= {(tile, o) if kv_loop else (o, tile)
                       for o in range(lo, hi + 1)}
        assert walked == live, (bq, bk)
        assert fa.fa_tile_counts(S, S, bq, bk, causal, window) == \
            jax_tile_counts(S, S, bq, bk, causal, window)


@pytest.mark.parametrize("shape,causal,window", [
    ((1, 64, 4, 2, 32), True, 0),
    ((2, 96, 4, 1, 32), True, 48),
    ((1, 80, 2, 2, 16), False, 0),
])
def test_autograd_binding_grads_match_reference(shape, causal, window):
    q, k, v, w = inputs(*shape, seed=7, n_extra=1)
    weight = torch.tensor(w)

    def grads(fn):
        a = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
        out = fn(*a, causal=causal, window=window)
        torch.autograd.backward((out * weight).sum())
        return out.detach(), [x.grad for x in a]

    kops.reset_kernel_stats()       # warned once per process otherwise
    with pytest.warns(kops.KernelFallbackWarning):
        out_k, g_k = grads(kops.flash_attention)
    kops.reset_kernel_stats()
    out_r, g_r = grads(attention_ref)
    np.testing.assert_allclose(out_k.numpy(), out_r.numpy(), **tol("f32"))
    for a, b, name in zip(g_k, g_r, ("dq", "dk", "dv")):
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=name,
                                   **GRAD_TOL)


@pytest.mark.parametrize("Sq,Sk", [(256, 256), (96, 96), (1024, 1024),
                                   (64, 200)])
@pytest.mark.parametrize("blocks", [(64, 64), (128, 128), (64, 32)])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 48),
                                           (True, 64), (False, 100)])
def test_tile_counts_match_jax(Sq, Sk, blocks, causal, window):
    assert fa.fa_tile_counts(Sq, Sk, *blocks, causal, window) == \
        jax_tile_counts(Sq, Sk, *blocks, causal, window)


@pytest.mark.parametrize("hd", [20, 64, 128, 256])
@pytest.mark.parametrize("S", [64, 96, 130, 1024])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 1),
                                           (True, 48), (True, 64),
                                           (True, 200), (False, 100)])
def test_kernel_loop_bounds_are_the_live_tiles(S, causal, window, hd):
    """The f32 kernels' loop bounds (mirrored by ``_live_range``) cover
    exactly the tiles the JAX predicate keeps, from either side, at the
    tiles of each padded head dim: B2 / B3 walk the kv tiles of a q-tile,
    B4 the q tiles of a kv-tile (``simt_blocks``)."""
    for kernel, kv_loop in (("fwd", True), ("dkv", False)):
        bq, bk = fa.simt_blocks(kernel, hd)
        nq, nk = -(-S // bq), -(-S // bk)
        live = {(qi, ki) for qi in range(nq) for ki in range(nk)
                if fa._tile_live(qi, ki, causal=causal, window=window, bq=bq,
                                 bk=bk, seq_k=S)}
        walked = set()
        for tile in range(nq if kv_loop else nk):
            lo, hi = fa._live_range(tile, nk if kv_loop else nq,
                                    kv_loop=kv_loop, causal=causal,
                                    window=window, bq=bq, bk=bk)
            walked |= {(tile, o) if kv_loop else (o, tile)
                       for o in range(lo, hi + 1)}
        assert walked == live, (kernel, bq, bk)
        assert len(live) == fa.fa_tile_counts(S, S, bq, bk, causal,
                                              window)[0]
        assert fa.fa_tile_counts(S, S, bq, bk, causal, window) == \
            jax_tile_counts(S, S, bq, bk, causal, window)


@pytest.mark.parametrize("kernel,hd", [("fwd", 64), ("dq", 64), ("dkv", 64),
                                       ("fwd", 256), ("dkv", 128),
                                       ("tc_fwd", 64), ("tc_dkv", 128)])
@pytest.mark.parametrize("S", [96, 130, 1024])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 48), (False, 100)])
def test_launch_order_visits_each_live_tile_once(kernel, hd, S, causal,
                                                 window):
    """Walking the grid in ``launch_order`` and each block's loop bounds
    visits every live (q-tile, kv-tile) pair of every (batch, head)
    exactly once (held against ``_tile_live``); under causal masking each
    block has at least the live partners of the next one (heaviest first),
    and the query heads of one KV head are launched side by side."""
    B, Hq, group = 2, 14, 7
    tc = kernel.startswith("tc_")
    name = kernel[3:] if tc else kernel
    bq, bk = fa.tc_blocks(name, hd) if tc else fa.simt_blocks(name, hd)
    kv_loop = name != "dkv"
    nq, nk = -(-S // bq), -(-S // bk)
    order = fa.launch_order(name, B, Hq, nq if kv_loop else nk, causal)
    assert len(order) == len(set(order)) == B * Hq * (nq if kv_loop else nk)
    visits, work = [], []
    for tile, h, b in order:
        lo, hi = fa._live_range(tile, nk if kv_loop else nq,
                                kv_loop=kv_loop, causal=causal,
                                window=window, bq=bq, bk=bk)
        pairs = [(tile, o) if kv_loop else (o, tile)
                 for o in range(lo, hi + 1)]
        visits += [(b, h) + p for p in pairs]
        work.append(len(pairs))
    live = [(b, h, qi, ki) for b in range(B) for h in range(Hq)
            for qi in range(nq) for ki in range(nk)
            if fa._tile_live(qi, ki, causal=causal, window=window, bq=bq,
                             bk=bk, seq_k=S)]
    assert sorted(visits) == sorted(live)
    assert len(visits) == len(set(visits))
    if causal and not window:
        assert work == sorted(work, reverse=True)
    for x in range(0, len(order), group):     # one KV head's query heads
        assert len({h // group for _, h, _ in order[x:x + group]}) == 1


@pytest.mark.parametrize("S", [64, 96, 128, 130, 1024, 2048])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 1),
                                           (True, 48), (True, 127),
                                           (True, 128), (True, 300),
                                           (False, 100)])
def test_forward_loop_bounds_are_the_live_tiles(S, causal, window):
    """The bf16 forward's loop bounds (``kv_range<128, 128>``, mirrored by
    ``_live_range`` at ``fwd_blocks``) cover exactly the live tiles, and
    their count is the JAX package's at the same tiles."""
    bq, bk = fa.fwd_blocks(torch.bfloat16, 128)
    assert (bq, bk) == (fa.FWD_BLOCK_Q, fa.FWD_BLOCK_K) == (128, 128)
    nq, nk = -(-S // bq), -(-S // bk)
    live = {(qi, ki) for qi in range(nq) for ki in range(nk)
            if fa._tile_live(qi, ki, causal=causal, window=window, bq=bq,
                             bk=bk, seq_k=S)}
    by_q = set()
    for qi in range(nq):
        lo, hi = fa._live_range(qi, nk, kv_loop=True, causal=causal,
                                window=window, bq=bq, bk=bk)
        by_q |= {(qi, ki) for ki in range(lo, hi + 1)}
    assert by_q == live
    assert fa.fa_tile_counts(S, S, bq, bk, causal, window) == \
        jax_tile_counts(S, S, bq, bk, causal, window)
    assert len(live) == fa.fa_tile_counts(S, S, bq, bk, causal, window)[0]


@pytest.mark.parametrize("dtype,hd,route", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 80, "wgmma"), (torch.bfloat16, 32, "wgmma"),
    (torch.bfloat16, 8, "wgmma"), (torch.bfloat16, 256, "wgmma"),
    (torch.bfloat16, 136, "wgmma"), (torch.float32, 64, "simt"),
    (torch.float32, 20, "simt"), (torch.float32, 128, "simt"),
    (torch.float32, 256, "simt")])
def test_forward_routes_by_dtype(dtype, hd, route):
    """bf16 goes to the tensor-core kernel, whose key tiles are 128 up to
    head dim 128 and 64 above (its operands must fit a block's shared
    memory); f32 to the CUDA-core kernel's tiles: 64 query rows (32 at head
    dim 256) by 64 keys up to head dim 64 and 32 above."""
    assert fa.fwd_route(dtype, hd) == route
    want = ((128, 128 if hd <= 128 else 64) if route == "wgmma"
            else {20: (64, 64), 64: (64, 64), 128: (64, 32),
                  256: (32, 32)}[hd])
    assert fa.fwd_blocks(dtype, hd) == want == (
        fa.tc_blocks("fwd", hd) if route == "wgmma"
        else fa.simt_blocks("fwd", hd))


@pytest.mark.parametrize("hd,match", [(20, "multiple of 8"),
                                      (100, "multiple of 8"),
                                      (140, "multiple of 8"),
                                      (264, "outside")])
def test_forward_route_refuses_what_tma_cannot_address(hd, match):
    with pytest.raises(ValueError, match=match):
        fa.fwd_route(torch.bfloat16, hd)


@pytest.mark.parametrize("dtype,hd,route", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 80, "wgmma"), (torch.bfloat16, 32, "wgmma"),
    (torch.bfloat16, 8, "wgmma"), (torch.bfloat16, 256, "wgmma"),
    (torch.bfloat16, 136, "wgmma"), (torch.float32, 64, "simt"),
    (torch.float32, 20, "simt"), (torch.float32, 128, "simt"),
    (torch.float32, 256, "simt")])
def test_backward_routes_by_dtype(dtype, hd, route):
    """B3 takes the forward's tiles on either route; B4's f32 tile holds
    the streamed query rows and the resident keys the other way round."""
    assert fa.bwd_route(dtype, hd) == route
    if route == "wgmma":
        assert fa.tc_blocks("dq", hd) == (128, 128 if hd <= 128 else 64)
    else:
        rows, keys = fa.simt_blocks("fwd", hd)
        assert fa.simt_blocks("dq", hd) == (rows, keys)
        assert fa.simt_blocks("dkv", hd) == (keys, rows)


@pytest.mark.parametrize("hd,match", [(20, "multiple of 8"),
                                      (100, "multiple of 8"),
                                      (140, "multiple of 8"),
                                      (264, "outside")])
def test_backward_route_refuses_what_tma_cannot_address(hd, match):
    """A bf16 head dim the tensor-core backward cannot take raises; it is
    never handed to the CUDA-core kernels instead."""
    with pytest.raises(ValueError, match=f"flash_attention_bwd.*{match}"):
        fa.bwd_route(torch.bfloat16, hd)


@pytest.mark.parametrize("S", [64, 96, 128, 130, 1024, 2048])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 1),
                                           (True, 48), (True, 127),
                                           (True, 128), (True, 300),
                                           (False, 100)])
def test_backward_loop_bounds_are_the_live_tiles(S, causal, window):
    """The bf16 backward's loop bounds cover exactly the live tiles: B3's
    kv-loop (``kv_range<128, 128>``) and B4's q-loop (``q_range<64,
    128>``), mirrored by ``_live_range`` at ``DQ_BLOCK_*`` /
    ``DKV_BLOCK_*``; the counts are the JAX package's at the same tiles."""
    assert (fa.DQ_BLOCK_Q, fa.DQ_BLOCK_K) == (128, 128)
    assert (fa.DKV_BLOCK_Q, fa.DKV_BLOCK_K) == (64, 128)
    for bq, bk, kv_loop in ((fa.DQ_BLOCK_Q, fa.DQ_BLOCK_K, True),
                            (fa.DKV_BLOCK_Q, fa.DKV_BLOCK_K, False)):
        nq, nk = -(-S // bq), -(-S // bk)
        live = {(qi, ki) for qi in range(nq) for ki in range(nk)
                if fa._tile_live(qi, ki, causal=causal, window=window, bq=bq,
                                 bk=bk, seq_k=S)}
        walked = set()
        for tile in range(nq if kv_loop else nk):
            lo, hi = fa._live_range(tile, nk if kv_loop else nq,
                                    kv_loop=kv_loop, causal=causal,
                                    window=window, bq=bq, bk=bk)
            walked |= {(tile, o) if kv_loop else (o, tile)
                       for o in range(lo, hi + 1)}
        assert walked == live, (bq, bk)
        assert fa.fa_tile_counts(S, S, bq, bk, causal, window) == \
            jax_tile_counts(S, S, bq, bk, causal, window)
        assert len(live) == fa.fa_tile_counts(S, S, bq, bk, causal,
                                              window)[0]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plain_forward_rounds_probabilities_for_bf16_v_only(dtype):
    """For a bf16 ``v`` the plain forward rounds ``p`` to bf16 before
    ``p·v`` (as the tensor-core kernel does) and keeps ``l`` from the f32
    ``p``; for an f32 ``v`` it keeps ``p`` in f32."""
    q, k, v = (torch.tensor(a).to(dtype)
               for a in inputs(2, 96, 4, 2, 32, seed=11))
    out, lse, _ = fa.fwd_plain(q, k, v, causal=True)
    s = fa._scores(q, k, 32 ** -0.5)
    mask = fa.attention_mask(96, 96, True, 0, q.device)
    m = s.masked_fill(~mask, fa.NEG_INF).amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    vh = fa._heads(v, 2)
    ref = {rounded: (torch.matmul(p.to(torch.bfloat16).float() if rounded
                                  else p, vh) / l).permute(0, 2, 1, 3)
           for rounded in (True, False)}
    want = ref[dtype == torch.bfloat16].to(dtype)
    assert torch.equal(out, want)
    assert torch.equal(lse, (m + torch.log(l))[..., 0])
    # the rounding shows before the output's own rounding
    assert not torch.equal(ref[True], ref[False])


# The tensor-core kernel's maps: plain-Python mirrors of what
# fa_fwd_tc_kernel (csrc/flash_attention.cu) relies on, held against a
# plain product below.  A warpgroup is 128 threads; ``tid`` is the
# thread's index in it (warp tid // 32, lane tid % 32).
def wgmma_acc_coord(tid: int, i: int) -> Tuple[int, int]:
    """(row, column) of f32 accumulator register ``i`` of thread ``tid`` in
    a ``wgmma`` m64nN product."""
    warp, lane = tid // 32, tid % 32
    return (16 * warp + lane // 4 + 8 * ((i // 2) % 2),
            8 * (i // 4) + 2 * (lane % 4) + i % 2)


def wgmma_a_coord(tid: int, reg: int, half: int) -> Tuple[int, int]:
    """(row, k) of the bf16 in half ``half`` (0: the low 16 bits) of A
    register ``reg`` (0–3) of thread ``tid`` in a ``wgmma`` m64nNk16 that
    reads A from registers."""
    warp, lane = tid // 32, tid % 32
    return (16 * warp + lane // 4 + 8 * (reg % 2),
            8 * (reg // 2) + 2 * (lane % 4) + half)


def p_fragment_source(t: int, reg: int, half: int) -> int:
    """The S accumulator register that the kernel packs into half ``half``
    of A register ``reg`` for P·V's k-step ``t`` (keys 16t … 16t+15):
    ``pa[t][reg] = pack(s[8t + 2 reg], s[8t + 2 reg + 1])``."""
    return 8 * t + 2 * reg + half


def sw128_offset(byte: int) -> int:
    """The 128-byte swizzle of TMA and of ``wgmma``'s descriptors, on a byte
    offset from a 1024-aligned tile: the 16-byte chunk (bits 4–6) XOR the
    row within its 8-row group (bits 7–9)."""
    return byte ^ (((byte >> 7) & 7) << 4)


def tma_offset(row: int, col: int, rows: int) -> int:
    """Unswizzled byte offset at which the kernel's TMA boxes put element
    (``row``, ``col``) of a bf16 tile of ``rows`` rows: one box of 64
    columns (128-byte rows) after another."""
    return (col // 64) * rows * 128 + row * 128 + (col % 64) * 2


def desc_start(operand: str, t: int, *, wg: int = 0, cb: int = 0,
               bk: int = fa.FWD_BLOCK_K) -> int:
    """Start offset of the kernel's descriptor for k-step ``t``: ``"q"``
    (warpgroup ``wg``'s 64 rows, hd columns 16t …), ``"k"`` (all ``bk``
    keys, hd columns 16t …) or ``"v"`` (keys 16t …, columns 64cb …), with
    tiles of ``bk`` keys (128 up to head dim 128, 64 above)."""
    if operand == "q":
        return wg * 64 * 128 + (t // 4) * fa.FWD_BLOCK_Q * 128 + (t % 4) * 32
    if operand == "k":
        return (t // 4) * bk * 128 + (t % 4) * 32
    return cb * bk * 128 + t * 16 * 128


def desc_offset(start: int, mn: int, k: int, *, k_major: bool) -> int:
    """Unswizzled byte offset that a 128-byte-swizzle descriptor starting at
    ``start`` (8-row groups 1024 bytes apart) names for element (``mn``,
    ``k``) of one k16 step: K-major, row ``mn`` and its ``k``-th of 16
    elements; N-major (the transpose bit), row ``k`` and its ``mn``-th of
    64 columns."""
    if k_major:
        return start + (mn // 8) * 1024 + (mn % 8) * 128 + 2 * k
    return start + (k // 8) * 1024 + (k % 8) * 128 + 2 * mn


def _tma_tile(x, rows):
    """The bf16 slots of shared memory that the kernel's TMA boxes fill
    with tile ``x`` (``rows`` × 64·ncb), 128-byte swizzle applied."""
    r, c = np.meshgrid(np.arange(x.shape[0]), np.arange(x.shape[1]),
                       indexing="ij")
    off = np.vectorize(sw128_offset)(np.vectorize(tma_offset)(
        r, c, rows))
    slots = np.full(x.size, np.nan)
    slots[off // 2] = x
    assert not np.isnan(slots).any()          # every slot written once
    return slots


def _desc_read(slots, start, n_mn, k_major):
    """(n_mn, 16) matrix of a k16 step that a descriptor at ``start``
    names: element (mn, k)."""
    mn, kk = np.meshgrid(np.arange(n_mn), np.arange(16), indexing="ij")
    off = np.vectorize(desc_offset)(start, mn, kk, k_major=k_major)
    return slots[np.vectorize(sw128_offset)(off) // 2]


def _bf16_values(rng, shape):
    return torch.tensor(rng.normal(size=shape)).to(torch.bfloat16).double(
        ).numpy()


@pytest.mark.parametrize("ncb", [1, 2, 4])
def test_tensor_core_maps_reproduce_the_tile_products(ncb):
    """One tile of the bf16 forward, hd padded to 64·ncb (128 query rows ×
    128 keys, 64 keys at ncb 4, whose S is m64n64): Q, K, V placed as TMA
    leaves them, read back through the kernel's descriptors k-step by
    k-step, give Q·Kᵀ; an accumulator spread over the threads by the
    ``wgmma`` map and packed into A fragments as the kernel packs P gives
    back the same matrix, and its product with V read N-major gives P·V
    (bf16 values: every sum exact in f64)."""
    rng = np.random.default_rng(ncb)
    hdp = 64 * ncb
    bq, bk = fa.tc_blocks("fwd", hdp)
    assert bk == (64 if ncb == 4 else 128)
    Q, K, V = (_bf16_values(rng, (n, hdp)) for n in (bq, bk, bk))
    sq, sk, sv = _tma_tile(Q, bq), _tma_tile(K, bk), _tma_tile(V, bk)
    tid, reg = np.meshgrid(np.arange(128), np.arange(bk // 2), indexing="ij")
    rows, cols = np.vectorize(wgmma_acc_coord)(tid, reg)
    assert len(set(zip(rows.ravel(), cols.ravel()))) == 64 * bk
    for wg in (0, 1):
        S = sum(_desc_read(sq, desc_start("q", t, wg=wg), 64, True)
                @ _desc_read(sk, desc_start("k", t, bk=bk), bk, True).T
                for t in range(4 * ncb))
        np.testing.assert_array_equal(S, Q[64 * wg:64 * wg + 64] @ K.T)

        P = _bf16_values(rng, (64, bk))
        acc = P[rows, cols]                      # (thread, register)
        A = np.full((64, bk), np.nan)
        for t in range(bk // 16):
            for r in range(4):
                for half in range(2):
                    a_rows, a_k = np.vectorize(wgmma_a_coord)(
                        np.arange(128), r, half)
                    assert np.isnan(A[a_rows, 16 * t + a_k]).all()
                    A[a_rows, 16 * t + a_k] = acc[
                        :, p_fragment_source(t, r, half)]
        np.testing.assert_array_equal(A, P)
        O = np.zeros((64, hdp))
        for t in range(bk // 16):
            for cb in range(ncb):
                Bv = _desc_read(sv, desc_start("v", t, cb=cb, bk=bk), 64,
                                False)
                O[:, 64 * cb:64 * cb + 64] += A[:, 16 * t:16 * t + 16] @ Bv.T
        np.testing.assert_array_equal(O, P @ V)


# The tensor-core backward's maps: fa_bwd_dq_tc_kernel (B3) reads Q, dO,
# K, V as B2 reads Q, K (K-major) and V (N-major); fa_bwd_dkv_tc_kernel
# (B4) reads its 128-key K / V tile K-major per warpgroup and its 64-row
# Q / dO tiles both K-major and N-major.
def bwd_desc_start(operand: str, t: int, *, wg: int = 0, cb: int = 0,
                   tk: int = fa.DKV_BLOCK_K) -> int:
    """Start offset of B4's descriptor for k-step ``t``: ``"k"`` / ``"v"``
    (warpgroup ``wg``'s 64 keys, hd columns 16t …; with blocks of
    ``tk`` = 64 keys, above head dim 128, both warpgroups read the block's
    64), ``"q"`` / ``"do"`` (the tile's 64 query rows, hd columns 16t …)
    or ``"q_n"`` / ``"do_n"`` (query rows 16t …, columns 64cb …,
    N-major)."""
    if operand in ("k", "v"):
        first = 0 if tk == 64 else wg * 64
        return first * 128 + (t // 4) * tk * 128 + (t % 4) * 32
    if operand in ("q", "do"):
        return (t // 4) * fa.DKV_BLOCK_Q * 128 + (t % 4) * 32
    return cb * fa.DKV_BLOCK_Q * 128 + t * 16 * 128


def dq_lse_row(tid: int, x: int) -> int:
    """The row (of a warpgroup's 64) whose lse / delta B3 reads into
    register ``x`` of thread ``tid``: ``r0 + 8x``."""
    return 16 * (tid // 32) + (tid % 32) // 4 + 8 * x


def dkv_lse_reg(i: int) -> int:
    """The lse / delta register B4 reads for accumulator element ``i``:
    ``2 (i / 4) + i % 2``."""
    return 2 * (i // 4) + i % 2


def dkv_lse_col(tid: int, j: int) -> int:
    """The query column (of the tile's 64) that B4 loads into lse / delta
    register ``j`` of thread ``tid``: ``8 (j / 2) + c0 + j % 2``."""
    return 8 * (j // 2) + 2 * (tid % 32 % 4) + j % 2


def _pack_a(acc, n_k):
    """The (64, n_k) matrix that accumulator registers ``acc`` (thread,
    register) give when packed into A fragments as the kernels pack P and
    dS, read back through the A map; every slot written once."""
    A = np.full((64, n_k), np.nan)
    for t in range(n_k // 16):
        for r in range(4):
            for half in range(2):
                a_rows, a_k = np.vectorize(wgmma_a_coord)(
                    np.arange(128), r, half)
                assert np.isnan(A[a_rows, 16 * t + a_k]).all()
                A[a_rows, 16 * t + a_k] = acc[:, p_fragment_source(t, r,
                                                                    half)]
    assert not np.isnan(A).any()
    return A


@pytest.mark.parametrize("ncb", [1, 2, 4])
def test_backward_tensor_core_maps_reproduce_the_tile_products(ncb):
    """One tile of each bf16 backward kernel, hd padded to 64·ncb, operands
    placed as TMA leaves them.  B3: dS from the m64n128 accumulator (m64n64
    at ncb 4: 64-key tiles) packed as A fragments, times K read N-major,
    gives dS·K; each thread's lse rows are its accumulator rows.  B4: Sᵀ =
    K·Qᵀ through ``wgmma_ss_n64``'s K-major descriptors and accumulator
    map (at ncb 4 a block holds 64 keys and both warpgroups read them);
    Pᵀ and dSᵀ from that map packed as A fragments, times dO and Q read
    N-major from the same tiles, give Pᵀ·dO and dSᵀ·Q; each accumulator
    element's lse column is the column that its register was loaded
    from."""
    rng = np.random.default_rng(10 + ncb)
    hdp = 64 * ncb
    dq_bk = fa.tc_blocks("dq", hdp)[1]
    dkv_bq, tk = fa.tc_blocks("dkv", hdp)
    assert (dq_bk, dkv_bq, tk) == ((64, 64, 64) if ncb == 4
                                   else (128, 64, 128))
    tid, reg = np.meshgrid(np.arange(128), np.arange(dq_bk // 2),
                           indexing="ij")
    rows_dq, cols_dq = np.vectorize(wgmma_acc_coord)(tid, reg)
    tid32, reg32 = np.meshgrid(np.arange(128), np.arange(32), indexing="ij")
    rows64, cols64 = np.vectorize(wgmma_acc_coord)(tid32, reg32)
    assert len(set(zip(rows64.ravel(), cols64.ravel()))) == 64 * 64

    # B3: dQ += dS·K over one K tile (K N-major, B2's V path)
    K = _bf16_values(rng, (dq_bk, hdp))
    sk = _tma_tile(K, dq_bk)
    dS = _bf16_values(rng, (64, dq_bk))
    A = _pack_a(dS[rows_dq, cols_dq], dq_bk)
    np.testing.assert_array_equal(A, dS)
    dQ = np.zeros((64, hdp))
    for t in range(dq_bk // 16):
        for cb in range(ncb):
            Bk = _desc_read(sk, desc_start("v", t, cb=cb, bk=dq_bk), 64,
                            False)
            dQ[:, 64 * cb:64 * cb + 64] += A[:, 16 * t:16 * t + 16] @ Bk.T
    np.testing.assert_array_equal(dQ, dS @ K)
    # the kernel reads lse2[(j >> 1) & 1] for accumulator element j
    np.testing.assert_array_equal(
        np.vectorize(dq_lse_row)(tid, (reg // 2) % 2), rows_dq)

    # B4: one K / V block of tk keys against one 64-row Q / dO tile
    K, V = (_bf16_values(rng, (tk, hdp)) for _ in range(2))
    Q, dO = (_bf16_values(rng, (dkv_bq, hdp)) for _ in range(2))
    sk, sv = _tma_tile(K, tk), _tma_tile(V, tk)
    sq, sdo = _tma_tile(Q, dkv_bq), _tma_tile(dO, dkv_bq)
    for wg in (0, 1):
        keys = slice(0, 64) if tk == 64 else slice(64 * wg, 64 * wg + 64)
        for a_s, b_s, a_op, b_op, want in (
                (sk, sq, "k", "q", K[keys] @ Q.T),
                (sv, sdo, "v", "do", V[keys] @ dO.T)):
            ST = sum(_desc_read(a_s, bwd_desc_start(a_op, t, wg=wg, tk=tk),
                                64, True)
                     @ _desc_read(b_s, bwd_desc_start(b_op, t), 64, True).T
                     for t in range(4 * ncb))
            np.testing.assert_array_equal(ST, want)
    PT = _bf16_values(rng, (64, fa.DKV_BLOCK_Q))
    dST = _bf16_values(rng, (64, fa.DKV_BLOCK_Q))
    for M, tile, slots, op in ((PT, dO, sdo, "do_n"), (dST, Q, sq, "q_n")):
        A = _pack_a(M[rows64, cols64], fa.DKV_BLOCK_Q)
        np.testing.assert_array_equal(A, M)
        acc = np.zeros((64, hdp))
        for t in range(fa.DKV_BLOCK_Q // 16):
            for cb in range(ncb):
                Bn = _desc_read(slots, bwd_desc_start(op, t, cb=cb), 64,
                                False)
                acc[:, 64 * cb:64 * cb + 64] += A[:, 16 * t:16 * t + 16] \
                    @ Bn.T
        np.testing.assert_array_equal(acc, M @ tile)
    lse_cols = np.vectorize(dkv_lse_col)(tid32, np.vectorize(dkv_lse_reg)(
        reg32))
    np.testing.assert_array_equal(lse_cols, cols64)
    # 16 registers of each thread cover its 16 distinct columns once
    for t_ in range(128):
        assert sorted(dkv_lse_col(t_, j) for j in range(16)) == \
            sorted(set(cols64[t_]))


def test_rows_without_keys_give_zero_output_and_empty_lse():
    """A query with no visible key (here: past the window's reach of a
    shorter key sequence) gets output 0 and ``lse = LSE_EMPTY``."""
    rng = np.random.default_rng(3)
    q = torch.tensor(rng.normal(size=(1, 8, 2, 16)).astype(np.float32))
    k = torch.tensor(rng.normal(size=(1, 2, 1, 16)).astype(np.float32))
    out, lse = fa.flash_attention_fwd(q, k, k, causal=True, window=2,
                                      return_lse=True)
    assert torch.all(out[0, 3:] == 0) and torch.all(lse[0, :, 3:] == 1e30)
    assert torch.all(lse[0, :, :3] < 1e3)


def test_fallback_counted_and_warned_once():
    q, k, v = (torch.tensor(a) for a in inputs(1, 32, 2, 2, 16, seed=0))
    ref = attention_ref(q, k, v, causal=True)
    launches = (fa.flash_attention_fwd.launches,
                fa.flash_attention_bwd_dq.launches,
                fa.flash_attention_bwd_dkv.launches)
    kops.reset_kernel_stats()
    try:
        with pytest.warns(kops.KernelFallbackWarning,
                          match="flash_attention"):
            out = kops.flash_attention(q, k, v, causal=True)
        np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-6)
        # second call: counted again, but NOT warned again
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            kops.flash_attention(q, k, v, causal=True)
        assert kops.KERNEL_STATS.fallbacks == 2
        assert kops.KERNEL_STATS.calls == 0
        assert kops.KERNEL_STATS.reasons == {
            "flash_attention:device:cpu": 2}
        # no kernel was launched
        assert launches == (fa.flash_attention_fwd.launches,
                            fa.flash_attention_bwd_dq.launches,
                            fa.flash_attention_bwd_dkv.launches)
    finally:
        kops.reset_kernel_stats()


def test_non_cpu_tensor_never_takes_the_plain_version():
    """A tensor that is not on the CPU goes to the kernel path: on a
    device the kernels do not serve it raises instead of computing."""
    q = torch.empty((1, 64, 2, 16), device="meta")
    k = torch.empty((1, 64, 1, 16), device="meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        fa.flash_attention_fwd(q, k, k)
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention_fwd(q, torch.empty((1, 64, 3, 16),
                                              device="meta"),
                               torch.empty((1, 64, 3, 16), device="meta"))
    lse = torch.empty((1, 2, 64), device="meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        fa.flash_attention_bwd_dkv(q, k, k, q, lse, lse)
    with pytest.raises(ValueError, match="lse / delta"):
        fa.flash_attention_bwd_dq(q, k, k, q, lse[:, :, :32], lse)
    with pytest.raises(ValueError, match="dO"):
        fa.flash_attention_bwd_dq(q, k, k, q.to(torch.bfloat16), lse, lse)
