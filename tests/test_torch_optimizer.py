"""Optimizers of the PyTorch package held against the JAX package.

Same numpy inputs go through ``repro.train.optimizer.apply_update``, through
the Pallas kernel path ``repro.kernels.optim.fused_apply_update`` (interpret
mode on the CPU, as ``tests/test_kernels.py`` runs it) and through
``repro_torch``'s ``apply_update`` / ``fused_apply_update`` /
``stacked_leaf_update`` (CPU tensors take the plain version).  Tolerance
atol 1e-6 / rtol 1e-6: the same f32 formulas in a different evaluation
order.  The first half ports the cases of ``tests/test_optimizer.py``.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.optim import fused_apply_update as jax_fused_apply_update
from repro.train.optimizer import apply_update as jax_apply_update
from repro_torch.kernels import ops as kops
from repro_torch.kernels.optim import fused_apply_update, stacked_leaf_update
from repro_torch.train.optimizer import (OPTIMIZERS, apply_update,
                                         init_opt_state)
from repro_torch.utils.convert import tree_from_numpy, tree_to_numpy
from repro_torch.utils.tree import tree_leaves

# the suite runs several worker processes side by side: one intra-op
# thread each, or the workers fight over the cores
torch.set_num_threads(1)

TOL = dict(atol=1e-6, rtol=1e-6)


def p0():
    return {"w": torch.tensor([1.0, -2.0]), "b": torch.tensor([0.5])}


def g0():
    return {"w": torch.tensor([0.1, 0.2]), "b": torch.tensor([-0.3])}


# ------------------------------------------------- ports of test_optimizer.py


def test_sgd():
    new, _ = apply_update("sgd", p0(), g0(), {}, {"lr": 0.1}, 0)
    np.testing.assert_allclose(new["w"], [1.0 - 0.01, -2.0 - 0.02], rtol=1e-6)


def test_sgd_weight_decay():
    new, _ = apply_update("sgd", p0(), g0(), {}, {"lr": 0.1, "wd": 0.01}, 0)
    np.testing.assert_allclose(new["w"][0], 1.0 - 0.1 * (0.1 + 0.01 * 1.0),
                               rtol=1e-6)


def test_momentum_two_steps():
    st = init_opt_state("momentum", p0())
    hp = {"lr": 0.1, "momentum": 0.9}
    p1, st = apply_update("momentum", p0(), g0(), st, hp, 0)
    p2, st = apply_update("momentum", p1, g0(), st, hp, 1)
    # v1 = g; v2 = 0.9 g + g = 1.9 g
    np.testing.assert_allclose(
        p2["w"], p0()["w"] - 0.1 * g0()["w"] - 0.1 * 1.9 * g0()["w"],
        rtol=1e-6)


def test_adam_bias_correction_first_step():
    st = init_opt_state("adam", p0())
    new, st = apply_update("adam", p0(), g0(), st, {"lr": 0.001}, 0)
    # after bias correction, first step ≈ -lr * sign-ish(g)
    expect = p0()["w"] - 0.001 * g0()["w"] / (g0()["w"].abs() + 1e-8)
    np.testing.assert_allclose(new["w"], expect, rtol=1e-4)


def test_adamw_decouples_wd():
    a, _ = apply_update("adamw", p0(), g0(), init_opt_state("adamw", p0()),
                        {"lr": 0.001, "wd": 0.0}, 0)
    b, _ = apply_update("adamw", p0(), g0(), init_opt_state("adamw", p0()),
                        {"lr": 0.001, "wd": 0.1}, 0)
    diff = (a["w"] - b["w"]).numpy()
    np.testing.assert_allclose(diff, 0.001 * 0.1 * p0()["w"].numpy(),
                               rtol=1e-3)  # f32 arithmetic


def test_lr_is_a_tensor_value():
    """hp values may be 0-d tensors (the trainer slices them off a device
    vector): same result as the Python float, nothing specialised on it."""
    for lr in (0.1, 0.01, 0.001, 0.37):
        a, _ = apply_update("sgd", p0(), g0(), {}, {"lr": lr}, 0)
        b, _ = apply_update("sgd", p0(), g0(), {},
                            {"lr": torch.tensor(lr)}, torch.tensor(0))
        for x, y in zip(tree_leaves(a), tree_leaves(b)):
            assert torch.equal(x, y)


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError):
        init_opt_state("lion", p0())


def test_update_is_out_of_place():
    params, grads = p0(), g0()
    st = init_opt_state("momentum", params)
    before = tree_to_numpy((params, st))
    apply_update("momentum", params, grads, st, {"lr": 0.1}, 0)
    for a, b in zip(tree_leaves(before), tree_leaves(tree_to_numpy((params, st)))):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------- against the JAX side

SHAPES = {"w": (33, 7), "b": (5,), "conv": (3, 3, 5, 7), "big": (40, 128)}
OPT_HPS = {
    "sgd": {"lr": 0.05, "wd": 0.01},
    "momentum": {"lr": 0.05, "wd": 0.01, "momentum": 0.9},
    "adam": {"lr": 1e-3, "wd": 0.01, "b1": 0.9, "b2": 0.999, "eps": 1e-8},
    "adamw": {"lr": 1e-3, "wd": 0.01, "b1": 0.9, "b2": 0.999, "eps": 1e-8},
}
SLOTS = {"sgd": (), "momentum": ("m",), "adam": ("m", "v"),
         "adamw": ("m", "v")}


def problem(name, stack=None, seed=0):
    """numpy params / grads / opt-state trees (ragged leaf included)."""
    rng = np.random.default_rng(seed)
    lead = () if stack is None else (stack,)
    params = {k: rng.normal(size=lead + s).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = {k: (0.1 * rng.normal(size=lead + s)).astype(np.float32)
             for k, s in SHAPES.items()}
    # slots bounded away from 0: adam divides by sqrt(v), and a v within
    # rounding of 0 would amplify one ulp of v into the tolerance
    state = {sk: {k: (0.01 + 0.01 * rng.uniform(size=lead + s)
                      ).astype(np.float32)
                  for k, s in SHAPES.items()} for sk in SLOTS[name]}
    return params, grads, state


def assert_trees_close(torch_tree, jax_tree):
    a = tree_leaves(tree_to_numpy(torch_tree))
    b = [np.asarray(x) for x in jax.tree.leaves(jax_tree)]
    # both sides hold dicts keyed alike; jax sorts keys, so sort ours too
    assert len(a) == len(b) and len(a) > 0
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, y, **TOL)


def sorted_tree(tree):
    """Dicts re-keyed in sorted order, the order ``jax.tree.leaves`` uses."""
    if isinstance(tree, dict):
        return {k: sorted_tree(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(sorted_tree(v) for v in tree)
    return tree


@pytest.mark.parametrize("jax_fn", [jax_apply_update, jax_fused_apply_update],
                         ids=["jax_plain", "jax_pallas_interpret"])
@pytest.mark.parametrize("torch_fn", [apply_update, fused_apply_update],
                         ids=["apply_update", "fused_apply_update"])
@pytest.mark.parametrize("name", OPTIMIZERS)
def test_solo_update_matches_jax(name, torch_fn, jax_fn):
    params, grads, state = problem(name)
    step = 3                       # non-trivial adam bias correction
    ref_p, ref_s = jax_fn(
        name, jax.tree.map(jnp.asarray, params),
        jax.tree.map(jnp.asarray, grads), jax.tree.map(jnp.asarray, state),
        {k: jnp.float32(v) for k, v in OPT_HPS[name].items()},
        jnp.int32(step))
    hp = {k: torch.tensor(v, dtype=torch.float32)
          for k, v in OPT_HPS[name].items()}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", kops.KernelFallbackWarning)
        new_p, new_s = torch_fn(
            name, tree_from_numpy(params, "cpu"),
            tree_from_numpy(grads, "cpu"), tree_from_numpy(state, "cpu"),
            hp, torch.tensor(step, dtype=torch.int32))
    assert_trees_close(sorted_tree((new_p, new_s)), (ref_p, ref_s))


@pytest.mark.parametrize("jax_fn", [jax_apply_update, jax_fused_apply_update],
                         ids=["jax_plain", "jax_pallas_interpret"])
@pytest.mark.parametrize("name", OPTIMIZERS)
def test_member_stacked_update_matches_jax(name, jax_fn):
    """M = 3 stacked members with divergent hps and steps: the port's
    ``stacked_leaf_update`` (explicit (M, ...) operands) == the JAX update
    vmapped over the member axis."""
    M = 3
    params, grads, state = problem(name, stack=M)
    scale = 1.0 + 0.1 * np.arange(M, dtype=np.float32)
    hp = {k: np.float32(v) * scale for k, v in OPT_HPS[name].items()}
    step = np.arange(M, dtype=np.int32)
    ref_p, ref_s = jax.vmap(
        lambda p, g, s, h, t: jax_fn(name, p, g, s, h, t))(
            jax.tree.map(jnp.asarray, params),
            jax.tree.map(jnp.asarray, grads),
            jax.tree.map(jnp.asarray, state),
            {k: jnp.asarray(v) for k, v in hp.items()}, jnp.asarray(step))

    th = {k: torch.tensor(v) for k, v in hp.items()}
    scal = [th["lr"], th["wd"]]
    if name == "momentum":
        scal.append(th["momentum"])
    elif name in ("adam", "adamw"):
        t = torch.tensor(step, dtype=torch.float32) + 1.0
        scal += [th["b1"], th["b2"], th["eps"],
                 1.0 - th["b1"] ** t, 1.0 - th["b2"] ** t]
    new_p, new_s = {}, {sk: {} for sk in SLOTS[name]}
    for k in sorted(SHAPES):
        arrs = [torch.tensor(params[k]), torch.tensor(grads[k])]
        arrs += [torch.tensor(state[sk][k]) for sk in SLOTS[name]]
        outs = stacked_leaf_update(name, *arrs, *scal)
        new_p[k] = outs[0]
        for sk, o in zip(SLOTS[name], outs[1:]):
            new_s[sk][k] = o
    assert_trees_close((new_p, new_s), (ref_p, ref_s))


# ------------------------------------------------------------ wrapper contract


def test_fused_on_cpu_counts_a_warned_once_fallback():
    kops.reset_kernel_stats()
    params, grads, state = problem("momentum")
    args = ("momentum", tree_from_numpy(params, "cpu"),
            tree_from_numpy(grads, "cpu"), tree_from_numpy(state, "cpu"),
            {"lr": 0.1}, 0)
    with pytest.warns(kops.KernelFallbackWarning):
        fused_apply_update(*args)
    with warnings.catch_warnings():
        warnings.simplefilter("error")      # second call must not warn
        fused_apply_update(*args)
    assert kops.KERNEL_STATS.fallbacks == 2
    assert kops.KERNEL_STATS.calls == 0
    assert kops.KERNEL_STATS.reasons["opt_update:device:cpu"] == 2
    assert stacked_leaf_update.launches == 0
    kops.reset_kernel_stats()


@pytest.mark.parametrize("bad", ["scalar_shape", "scalar_dtype",
                                 "array_shape", "scalar_count"])
def test_stacked_leaf_update_rejects_malformed_operands(bad):
    p = torch.zeros(2, 5)
    g = torch.zeros(2, 5)
    lr = torch.full((2,), 0.1)
    wd = torch.zeros(2)
    if bad == "scalar_shape":
        lr = torch.full((1,), 0.1)
    elif bad == "scalar_dtype":
        lr = lr.double()
    elif bad == "array_shape":
        g = torch.zeros(2, 4)
    args = (p, g, lr) if bad == "scalar_count" else (p, g, lr, wd)
    with pytest.raises(ValueError):
        stacked_leaf_update("sgd", *args)


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_bf16_leaves_keep_dtype_with_f32_math(name):
    """f32 math, cast back on store: the bf16 result is the rounded f32
    result, within one bf16 ulp of the f32 update."""
    params, grads, state = problem(name, stack=2)
    hp = OPT_HPS[name]
    f = lambda v: torch.full((2,), v, dtype=torch.float32)
    scal = [f(hp["lr"]), f(hp["wd"])]
    if name == "momentum":
        scal.append(f(hp["momentum"]))
    elif name in ("adam", "adamw"):
        scal += [f(hp["b1"]), f(hp["b2"]), f(hp["eps"]),
                 f(1 - hp["b1"] ** 4), f(1 - hp["b2"] ** 4)]
    arrs16 = [torch.tensor(params["conv"]).bfloat16(),
              torch.tensor(grads["conv"]).bfloat16()]
    arrs16 += [torch.tensor(state[sk]["conv"]).bfloat16()
               for sk in SLOTS[name]]
    outs16 = stacked_leaf_update(name, *arrs16, *scal)
    outs32 = stacked_leaf_update(name, *[a.float() for a in arrs16], *scal)
    for o16, o32 in zip(outs16, outs32):
        assert o16.dtype == torch.bfloat16
        assert torch.equal(o16, o32.bfloat16())
