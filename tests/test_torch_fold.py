"""B7, the member-folding rules, held against the JAX package's.

A sibling group runs its step under ``torch.func.vmap``; the kernel
bindings of :mod:`repro_torch.kernels.ops` fold the member axis into the
kernels' batch axis, and :func:`repro_torch.kernels.optim.stacked_apply_update`
updates the member-stacked tree.  Here, on the CPU (the wrappers take their
plain versions), with numpy-seeded inputs fed to both packages — the JAX
side under ``jax.vmap``, its Pallas kernels in interpret mode as its own
tests run them (ports of ``tests/test_kernels.py``'s vmapped cases):

* vmapped flash attention, its ``vmap(grad)`` with an unbatched KV, the
  vmapped SSD intra-chunk term and a ``vmap(grad)`` SSD case;
* the member-stacked optimizer update with divergent per-member hps;
* one kernel-plane note and one wrapper call (at the folded shape) per
  group call, and no warning but the counted CPU fallback — above all no
  functorch "performance drop" warning, the sign of a hidden per-member
  loop;
* a wrapper handed a functorch wrapper raises instead of launching.

Tolerances are the reference's: 2e-5; gradients atol 2e-4, rtol 2e-3.
"""

import warnings
from contextlib import contextmanager

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import flash_attention as jax_flash_attention
from repro.kernels.ops import ssd_intra as jax_ssd_intra
from repro.kernels.optim import fused_apply_update as jax_fused_apply_update
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ssd_scan as ss
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.optim import stacked_apply_update
from repro_torch.train.optimizer import apply_update, apply_update_stacked
from repro_torch.utils.convert import tree_from_numpy, tree_to_numpy
from repro_torch.utils.tree import tree_leaves, tree_map

# the suite runs several worker processes side by side: one intra-op
# thread each, or the workers fight over the cores
torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=2e-4, rtol=2e-3)


@contextmanager
def one_group_call(monkeypatch, *wrappers):
    """Count kernel-plane notes and the calls of the named wrappers of
    :mod:`repro_torch.kernels.ops` (with the batch axis each saw) inside
    the block; record every warning, functorch's fallback warning on."""
    seen = {w: [] for w in wrappers}
    for w in wrappers:
        real = getattr(kops, w)

        def spy(*args, _real=real, _w=w, **kw):
            seen[_w].append(args[0].shape[0])
            return _real(*args, **kw)
        monkeypatch.setattr(kops, w, spy)
    kops.reset_kernel_stats()
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield seen
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)
    assert [w for w in caught
            if w.category is not kops.KernelFallbackWarning] == []
    assert not any("performance drop" in str(w.message) for w in caught)
    assert sum(kops.KERNEL_STATS.snapshot()) == 1
    kops.reset_kernel_stats()


def normal(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# --------------------------------------------------------- flash attention


def test_vmapped_flash_attention_matches_stacked_oracle(monkeypatch):
    M, B, S, Hq, Hkv, hd = 3, 2, 64, 4, 2, 32
    rng = np.random.default_rng(0)
    q, k, v = (normal(rng, (M, B, S, h, hd)) for h in (Hq, Hkv, Hkv))
    want = jax.vmap(lambda *a: jax_flash_attention(*a, causal=True))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    with one_group_call(monkeypatch, "flash_attention_fwd") as seen:
        got = torch.func.vmap(
            lambda *a: kops.flash_attention(*a, causal=True))(t(q), t(k),
                                                               t(v))
    assert seen == {"flash_attention_fwd": [M * B]}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_vmapped_flash_attention_grad_matches_stacked_oracle(monkeypatch):
    """vmap(grad(...)) — the batched-sibling training path — with a
    broadcast (unbatched) KV operand."""
    M, B, S, Hq, Hkv, hd = 3, 1, 64, 4, 2, 32
    rng = np.random.default_rng(1)
    q = normal(rng, (M, B, S, Hq, hd))
    k, v = normal(rng, (B, S, Hkv, hd)), normal(rng, (B, S, Hkv, hd))
    want = jax.vmap(jax.grad(
        lambda q_, k_, v_: jax_flash_attention(q_, k_, v_).sum(),
        argnums=(0, 1, 2)), in_axes=(0, None, None))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    with one_group_call(monkeypatch, "flash_attention_fwd",
                        "flash_attention_bwd") as seen:
        got = torch.func.vmap(torch.func.grad(
            lambda q_, k_, v_: kops.flash_attention(q_, k_, v_).sum(),
            argnums=(0, 1, 2)), in_dims=(0, None, None))(t(q), t(k), t(v))
    assert seen == {"flash_attention_fwd": [M * B],
                    "flash_attention_bwd": [M * B]}
    for a, b in zip(got, want):
        assert tuple(a.shape) == (M,) + tuple(b.shape[1:])
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)


# ---------------------------------------------------------------- ssd intra


def ssd_inputs(rng, lead, nc=2, Q=32, H=2, P=16, N=16):
    xr = normal(rng, lead + (nc, Q, H, P))
    dtr = np.log1p(np.exp(normal(rng, lead + (nc, Q, H))))
    ltT = (-np.abs(normal(rng, lead + (nc, H, Q))) * 0.1).astype(np.float32)
    Br, Cr = normal(rng, lead + (nc, Q, N)), normal(rng, lead + (nc, Q, N))
    return xr, dtr.astype(np.float32), ltT, Br, Cr


def test_vmapped_ssd_intra_matches_stacked_oracle(monkeypatch):
    M, B = 3, 1
    args = ssd_inputs(np.random.default_rng(2), (M, B))
    want = jax.vmap(jax_ssd_intra)(*map(jnp.asarray, args))
    with one_group_call(monkeypatch, "ssd_intra_fwd") as seen:
        got = torch.func.vmap(kops.ssd_intra)(*map(t, args))
    assert seen == {"ssd_intra_fwd": [M * B]}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_vmapped_ssd_intra_grad_matches_stacked_oracle(monkeypatch):
    """vmap(grad) through B5 / B6 with an unbatched B and C (the reference
    has no such case; its JAX side is vmap(grad) of its own binding)."""
    M, B = 3, 2
    rng = np.random.default_rng(3)
    xr, dtr, ltT, Br, Cr = ssd_inputs(rng, (M, B))
    Br, Cr = Br[0], Cr[0]
    w = normal(rng, xr.shape[1:])

    def jax_loss(*a):
        return (jax_ssd_intra(*a) * jnp.asarray(w)).sum()

    want = jax.vmap(jax.grad(jax_loss, argnums=(0, 1, 2, 3, 4)),
                    in_axes=(0, 0, 0, None, None))(
        *map(jnp.asarray, (xr, dtr, ltT, Br, Cr)))
    with one_group_call(monkeypatch, "ssd_intra_fwd",
                        "ssd_intra_bwd") as seen:
        got = torch.func.vmap(torch.func.grad(
            lambda *a: (kops.ssd_intra(*a) * t(w)).sum(),
            argnums=(0, 1, 2, 3, 4)), in_dims=(0, 0, 0, None, None))(
                *map(t, (xr, dtr, ltT, Br, Cr)))
    assert seen == {"ssd_intra_fwd": [M * B], "ssd_intra_bwd": [M * B]}
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)


def test_folded_head_grouping_is_one_members():
    """A folded B6 launch sums heads in one member's grouping: mamba2-2.7b
    (B 1, nc 16, H 80) keeps G 10 at M 2, where B 2 alone would pick 16."""
    x = torch.empty((2, 16, 1, 80, 1))
    assert ss.head_groups(ss._cells(x, 2), 80) == ss.head_groups(16, 80) == 10
    assert ss.head_groups(ss._cells(x, 1), 80) == 16
    with pytest.raises(ValueError, match="members"):
        ss._cells(x, 3)


def test_wrappers_refuse_functorch_wrappers():
    """A launch reads the memory behind a data pointer: a wrapper handed a
    BatchedTensor raises; it is reached through its folding rule."""
    q = torch.zeros((2, 1, 8, 2, 16))
    with pytest.raises(RuntimeError, match="functorch wrapper"):
        torch.func.vmap(lambda x: flash_attention_fwd(x, x[:, :, :1],
                                                      x[:, :, :1]))(q)
    args = [torch.zeros(s) for s in ((2, 1, 1, 4, 2, 8), (2, 1, 1, 4, 2),
                                     (2, 1, 1, 2, 4), (2, 1, 1, 4, 8),
                                     (2, 1, 1, 4, 8))]
    with pytest.raises(RuntimeError, match="functorch wrapper"):
        torch.func.vmap(ss.ssd_intra_fwd)(*args)


# ---------------------------------------------------------------- optimizer

OPT_HPS = {
    "sgd": {"lr": 0.1, "wd": 1e-4},
    "momentum": {"lr": 0.1, "wd": 1e-4, "momentum": 0.85},
    "adam": {"lr": 1e-3, "wd": 1e-4, "b1": 0.9, "b2": 0.999, "eps": 1e-8},
    "adamw": {"lr": 1e-3, "wd": 1e-2, "b1": 0.9, "b2": 0.999, "eps": 1e-8},
}
SLOTS = {"sgd": (), "momentum": ("m",), "adam": ("m", "v"),
         "adamw": ("m", "v")}
SHAPES = {"b": (7,), "s": (1,), "w": (37, 5)}   # awkward leaf shapes


def opt_problem(name, M, seed=4):
    rng = np.random.default_rng(seed)
    params = {k: normal(rng, (M,) + s) for k, s in SHAPES.items()}
    grads = {k: 0.1 * normal(rng, (M,) + s) for k, s in SHAPES.items()}
    state = {sk: {k: np.full((M,) + s, 0.01, np.float32)
                  for k, s in SHAPES.items()} for sk in SLOTS[name]}
    return params, grads, state


@pytest.mark.parametrize("name", ["sgd", "momentum", "adam", "adamw"])
def test_vmapped_fused_optimizer_divergent_hps(name, monkeypatch):
    """The member-stacked update with per-member hp vectors — the
    batched-sibling optimizer path — == the JAX update vmapped over the
    members, and each member's slice == the port's solo update, bit for
    bit."""
    M = 3
    params, grads, state = opt_problem(name, M)
    scale = 1.0 + 0.1 * np.arange(M, dtype=np.float32)
    hp = {k: np.float32(v) * scale for k, v in OPT_HPS[name].items()}
    step = np.arange(M, dtype=np.int32)
    want = jax.jit(jax.vmap(
        lambda p, g, s, h, st: jax_fused_apply_update(name, p, g, s, h,
                                                      st)))(
        *(jax.tree.map(jnp.asarray, x) for x in (params, grads, state, hp,
                                                  step)))
    tp, tg, ts = (tree_from_numpy(x, "cpu") for x in (params, grads, state))
    th = {k: t(v) for k, v in hp.items()}
    with one_group_call(monkeypatch) as _:
        got = stacked_apply_update(name, tp, tg, ts, th, t(step))
    a = tree_leaves(tree_to_numpy(got))
    b = [np.asarray(x) for x in jax.tree.leaves(want)]
    assert len(a) == len(b) == len(SHAPES) * (1 + len(SLOTS[name]))
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, y, atol=1e-6, rtol=1e-6)
    for i in range(M):
        solo = apply_update(
            name, tree_map(lambda x: x[i], tp), tree_map(lambda x: x[i], tg),
            tree_map(lambda x: x[i], ts), {k: v[i] for k, v in th.items()},
            torch.tensor(step[i]))
        for x, y in zip(tree_leaves(got), tree_leaves(solo)):
            # the reference's b2 scaled past 1 makes v < 0 and NaN: equal
            # NaNs are equal bits here
            torch.testing.assert_close(x[i], y, rtol=0, atol=0,
                                       equal_nan=True)
    plain = apply_update_stacked(name, tp, tg, ts, th, t(step))
    for x, y in zip(tree_leaves(got), tree_leaves(plain)):
        torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)
