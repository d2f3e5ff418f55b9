"""Flash attention of the PyTorch package held against the JAX package.

On the CPU the wrappers take their plain versions (whole-matrix PyTorch);
the CUDA kernels themselves are held against the same plain versions on
the card by ``chip_smoke.py``.  Here, with numpy-seeded inputs fed to both
packages:

* the plain forward (``out``, ``lse``, executed-tile count) against
  ``flash_attention_fwd(..., interpret=True, return_lse=True,
  count_tiles=True)`` with the port's 64 × 64 tiles;
* the plain backward (dq, dk, dv) against ``flash_attention_bwd(...,
  interpret=True)``;
* the ``torch.autograd.Function`` binding's gradients against
  ``torch.autograd`` through ``attention_ref``;
* ``fa_tile_counts`` against the JAX package's, and the CUDA kernels' loop
  bounds (``_live_range``) against the tile predicate;
* the fallback on CPU tensors counted and warned once.

Grid and tolerances are those of ``tests/test_kernels.py``: forward f32
2e-5, bf16 2e-2; gradients atol 2e-4, rtol 2e-3 (f32).
"""

import warnings

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


FWD_CASES = [("float32", s, m) for s in SHAPES for m in MASKS] + \
            [("bfloat16", s, m) for s in SHAPES[1:4:2] for m in MASKS]


@pytest.mark.parametrize("dtype,shape,mask", FWD_CASES)
def test_plain_forward_matches_jax_kernel(dtype, shape, mask):
    causal, window = mask
    q, k, v = inputs(*shape, seed=sum(shape))
    jo, jl, jt = jax_fwd(*(to_jax(a, dtype) for a in (q, k, v)),
                         causal=causal, window=window,
                         block_q=fa.BLOCK_Q, block_k=fa.BLOCK_K,
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


@pytest.mark.parametrize("S", [64, 96, 130, 1024])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 1),
                                           (True, 48), (True, 64),
                                           (True, 200), (False, 100)])
def test_kernel_loop_bounds_are_the_live_tiles(S, causal, window):
    """The CUDA kernels' loop bounds (mirrored by ``_live_range``) cover
    exactly the tiles the JAX predicate keeps, from either side."""
    bq, bk = fa.BLOCK_Q, fa.BLOCK_K
    nq, nk = -(-S // bq), -(-S // bk)
    live = {(qi, ki) for qi in range(nq) for ki in range(nk)
            if fa._tile_live(qi, ki, causal=causal, window=window, bq=bq,
                             bk=bk, seq_k=S)}
    by_q = set()
    for qi in range(nq):
        lo, hi = fa._live_range(qi, nk, kv_loop=True, causal=causal,
                                window=window)
        by_q |= {(qi, ki) for ki in range(lo, hi + 1)}
    by_k = set()
    for ki in range(nk):
        lo, hi = fa._live_range(ki, nq, kv_loop=False, causal=causal,
                                window=window)
        by_k |= {(qi, ki) for qi in range(lo, hi + 1)}
    assert by_q == live == by_k
    assert len(live) == fa.fa_tile_counts(S, S, bq, bk, causal, window)[0]


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
