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
from repro_torch.kernels import optim as ko
from repro_torch.kernels.optim import (fused_apply_update,
                                       stacked_leaf_update,
                                       stacked_tree_update)
from repro_torch.train.optimizer import (OPTIMIZERS, apply_update,
                                         init_opt_state, leaf_update)
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
    assert stacked_tree_update.launches == 0
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


# ----------------------------------------------- the tree kernel's leaf table
# ``stacked_tree_update`` launches ``tree_update`` of csrc/optim.cu over a
# leaf table (kernels/optim.py::TreePlan).  The table, and the kernel's
# block → (leaf, member, element) map over it, are held here on the CPU:
# the map is emulated in torch and must reproduce the plain update bit for
# bit, since it only decides which elements each block updates.

MIXED = [((3, 3, 5, 7), torch.float32), ((64,), torch.bfloat16),
         ((2, 0), torch.float32), ((33, 7), torch.bfloat16),
         ((5,), torch.float32), ((40, 128), torch.float32)]


def hwio_grad(shape, lead=()):
    """A gradient as the ResNet's convolution hands it over: an HWIO view
    of a contiguous OIHW tensor (``lead``: a member axis in front)."""
    kh, kw, ci, co = shape
    base = torch.randn(lead + (co, ci, kh, kw))
    k = len(lead)
    return base.permute(*range(k), k + 2, k + 3, k + 1, k)


def test_tree_plan_offsets_alignment_and_prefix_sums():
    shapes = tuple(s for s, _ in MIXED)
    dtypes = tuple(d for _, d in MIXED)
    M = 3
    plan = ko.TreePlan(M, False, shapes, dtypes,
                       tuple((_numel(s),) + contiguous_strides(s)
                             for s in shapes))
    live = [i for i, s in enumerate(shapes) if _numel(s)]
    assert plan.live.tolist() == live
    # small leaves share one buffer per dtype, in the order of first use
    assert [dt for dt, _ in plan.buffers] == [torch.float32, torch.bfloat16]
    # output offsets: 16-byte aligned, leaves of one dtype and shape side
    # by side, each leaf M · n elements long, disjoint, padded only to
    # alignment; each leaf's view starts there, row-major
    bufs = [torch.arange(t, dtype=torch.float64) for _, t in plan.buffers]
    views = plan.views(bufs)
    spans = {0: [], 1: []}
    for row, i in enumerate(live):
        esize = 4 if dtypes[i] == torch.float32 else 2
        d = int(plan.buf_index[row])
        assert plan.buffers[d][0] == dtypes[i]
        off = int(plan.out_off[row])
        assert off % 16 == 0
        spans[d].append((off, off + M * _numel(shapes[i]) * esize))
        v = views[i]
        assert v.shape == (M,) + shapes[i] and v.is_contiguous()
        assert int(v.flatten()[0]) * esize == off
        assert plan.table[row, ko.F_N] == _numel(shapes[i])
        assert (plan.table[row, ko.F_FLAGS] & ko.FLAG_BF16) == (
            dtypes[i] == torch.bfloat16)
    assert views[2].shape == (M, 2, 0)
    ends = {}
    for d, sp in spans.items():
        sp.sort()
        assert all(b <= c < b + 16 for (_, b), (c, _) in zip(sp, sp[1:]))
        ends[d] = sp[-1][1]
    conv, = [g for g in plan.groups if g[2] == (M, 3, 3, 5, 7)]
    assert conv[3] == [0]             # its size breaks the alignment
    for d, (dt, total) in enumerate(plan.buffers):
        esize = 2 if dt == torch.bfloat16 else 4
        assert total * esize >= ends[d]
    # first blocks: a prefix sum of ceil(n / TREE_BLOCK), one launch
    blocks = [-(-_numel(shapes[i]) // ko.TREE_BLOCK) for i in live]
    assert plan.table[:, ko.F_BLOCK0].tolist() == list(
        np.cumsum([0] + blocks[:-1]))
    assert plan.launches == [(0, len(live), sum(blocks))]
    # 16-byte vectors only where each member's slice stays aligned
    for row, i in enumerate(live):
        esize = 4 if dtypes[i] == torch.float32 else 2
        assert plan.vec_ok[row] == ((_numel(shapes[i]) * esize) % 16 == 0)


def test_tree_plan_reads_a_permuted_hwio_leaf_through_its_strides():
    g = hwio_grad((3, 3, 5, 7))
    assert not g.is_contiguous()
    plan = ko.TreePlan(1, True, (tuple(g.shape),), (torch.float32,),
                       (g.stride(),))
    rec = plan.table[0]
    assert rec[ko.F_FLAGS] & ko.FLAG_GSTRIDED
    sizes = (1,) + tuple(rec[ko.F_S1:ko.F_S3 + 1])
    strides = tuple(rec[ko.F_GS0:ko.F_GS3 + 1])
    # kh and kw merge into one dim of stride 1: (9, 5, 7) over (1, 9, 45)
    assert sizes == (1, 9, 5, 7) and strides == (0, 1, 9, 45)
    assert np.prod(sizes) == g.numel()
    np.testing.assert_array_equal(gather(g, sizes, strides), g.flatten())
    # a contiguous gradient is read as it lies, with 16-byte vectors
    c = ko.TreePlan(1, True, (tuple(g.shape),), (torch.float32,),
                    (g.contiguous().stride(),))
    assert not c.table[0, ko.F_FLAGS] & ko.FLAG_GSTRIDED and c.gvec_ok[0]


@pytest.mark.parametrize("shape, perm", [
    ((5, 7, 9), (2, 0, 1)), ((4, 6), (1, 0)), ((2, 3, 4, 5), (3, 1, 0, 2)),
    ((8, 1, 6), (2, 1, 0))])
def test_gather_dims_address_a_view_in_row_major_order(shape, perm):
    g = torch.randn(shape).permute(perm)
    sizes, strides = ko.gather_dims(g.shape, g.stride())
    assert len(sizes) == 4 and np.prod(sizes) == g.numel()
    np.testing.assert_array_equal(gather(g, sizes, strides), g.flatten())


def test_gather_dims_refuse_more_than_four_dims():
    g = torch.randn(2, 3, 2, 3, 2).permute(4, 2, 0, 3, 1)
    with pytest.raises(ValueError, match="at most 4"):
        ko.gather_dims(g.shape, g.stride())


def test_tree_plan_splits_into_the_fewest_launches_that_hold_it():
    n = 2 * ko.TREE_CAPACITY + 5
    shapes = tuple((3000 + i,) for i in range(n))
    plan = ko.TreePlan(1, True, shapes, (torch.float32,) * n,
                       tuple((1,) for _ in shapes))
    assert [(a, b) for a, b, _ in plan.launches] == [
        (0, ko.TREE_CAPACITY), (ko.TREE_CAPACITY, 2 * ko.TREE_CAPACITY),
        (2 * ko.TREE_CAPACITY, n)]
    for a, b, blocks in plan.launches:     # first blocks restart per launch
        nb = [-(-s[0] // ko.TREE_BLOCK) for s in shapes[a:b]]
        assert plan.table[a:b, ko.F_BLOCK0].tolist() == list(
            np.cumsum([0] + nb[:-1]))
        assert blocks == sum(nb)
    small = ko.TreePlan(1, True, shapes[:10], (torch.float32,) * 10,
                        tuple((1,) for _ in range(10)), capacity=4)
    assert [(a, b) for a, b, _ in small.launches] == [(0, 4), (4, 8),
                                                     (8, 10)]


def _numel(shape):
    return int(np.prod(shape)) if len(shape) else 1


def contiguous_strides(shape):
    return torch.empty(shape).stride() if _numel(shape) else (
        tuple(1 for _ in shape))


def gather(g, sizes, strides, member_offset=0):
    """The kernel's strided read of ``g``: element e of the leaf's
    row-major order at ``Σ i_d · stride_d`` from g's first element."""
    e = torch.arange(int(np.prod(sizes)))
    i3 = e % sizes[3]
    r = e // sizes[3]
    i2 = r % sizes[2]
    r = r // sizes[2]
    off = (r // sizes[1]) * strides[0] + (r % sizes[1]) * strides[1] + \
        i2 * strides[2] + i3 * strides[3] + member_offset
    mem = torch.as_strided(g, (int(off.max()) + 1,), (1,),
                           g.storage_offset())
    return mem[off]


def emulate_tree_kernel(name, M, solo, arrs, scals, capacity):
    """The CUDA kernel's work distribution on the CPU: per launch, per
    member, per block, the leaf found by a binary search over the first
    blocks, the block's 256 × 8 elements of that member, g read through
    the record (its strides or as it lies), the plain update on those
    elements, the results written at the record's output offsets of the
    dtype buffers; then the leaves viewed out as the wrapper does."""
    narr, snames, nout = ko._SPEC[name]
    ps, gs = arrs[0], arrs[1]
    shapes = tuple(tuple(p.shape) if solo else tuple(p.shape[1:])
                   for p in ps)
    plan = ko.TreePlan(M, solo, shapes, tuple(p.dtype for p in ps),
                       tuple(g.stride() for g in gs), capacity=capacity)
    bufs = [[torch.full((t,), float("nan"), dtype=d)
             for d, t in plan.buffers] for _ in range(nout)]
    lanes = torch.arange(256) * 8
    for a, b, blocks in plan.launches:
        first = plan.table[a:b, ko.F_BLOCK0]
        for member in range(M):
            for blk in range(blocks):
                row = a + int(np.searchsorted(first, blk, side="right")) - 1
                rec = plan.table[row]
                leaf = int(plan.live[row])
                n = int(rec[ko.F_N])
                e = ((blk - int(rec[ko.F_BLOCK0])) * ko.TREE_BLOCK + lanes
                     )[:, None] + torch.arange(8)
                e = e[e < n]
                if rec[ko.F_FLAGS] & ko.FLAG_GSTRIDED:
                    sizes = (1,) + tuple(int(x) for x in rec[ko.F_S1:])
                    strides = tuple(int(x) for x in
                                    rec[ko.F_GS0:ko.F_GS3 + 1])
                    gv = gather(gs[leaf], sizes, strides,
                                member * int(rec[ko.F_GMEMBER]))[e]
                else:
                    gv = gs[leaf].reshape(-1)[member * int(
                        rec[ko.F_GMEMBER] if not solo else 0) + e]
                vals = [arr[leaf].reshape(M, n)[member, e] for arr in
                        [arrs[0]] + list(arrs[2:])]
                outs = leaf_update(name, vals[0], gv, *vals[1:],
                                   **{k: s[member] for k, s in
                                      zip(snames, scals)})
                esize = 4 if ps[leaf].dtype == torch.float32 else 2
                base = int(plan.out_off[row]) // esize + member * n
                for o, val in zip(range(nout), outs):
                    bufs[o][int(plan.buf_index[row])][base + e] = val
    return tuple(plan.views(out) for out in bufs)


def tree_operands(name, M, seed, solo=False):
    """Leaves of MIXED (f32 and bf16, an empty one, a ragged one), the conv
    leaf's gradient an HWIO view; per-member scalars."""
    rng = np.random.default_rng(seed)
    narr, snames, _ = ko._SPEC[name]
    lead = () if solo else (M,)
    arrs = [[] for _ in range(narr)]
    for shape, dt in MIXED:
        full = lead + shape
        vals = [rng.normal(size=full), 0.1 * rng.normal(size=full)]
        vals += [0.01 + 0.01 * rng.uniform(size=full)
                 for _ in range(narr - 2)]
        for i, v in enumerate(vals):
            t = torch.tensor(v, dtype=torch.float32).to(dt)
            if i == 1 and len(shape) == 4:
                t = hwio_grad(shape, lead).copy_(t)
            arrs[i].append(t)
    hps = OPT_HPS[name]
    spread = 1.0 + 0.1 * np.arange(M, dtype=np.float32)
    vals = {"lr": hps["lr"] * spread, "wd": hps["wd"] * spread,
            "mom": hps.get("momentum", 0.9) * spread,
            "b1": 0.9 - 0.01 * np.arange(M), "b2": 0.999 - 1e-4 * np.arange(M),
            "eps": np.full(M, 1e-8)}
    t = np.arange(M) + 1.0
    vals["bc1"] = 1.0 - vals["b1"] ** t
    vals["bc2"] = 1.0 - vals["b2"] ** t
    return arrs, [torch.tensor(np.asarray(vals[k], np.float32))
                  for k in snames]


@pytest.mark.parametrize("capacity", [ko.TREE_CAPACITY, 2])
@pytest.mark.parametrize("M", [1, 3])
@pytest.mark.parametrize("name", OPTIMIZERS)
def test_kernel_block_map_reproduces_the_plain_update(name, M, capacity):
    solo = M == 1
    arrs, scals = tree_operands(name, M, seed=M, solo=solo)
    got = emulate_tree_kernel(name, M, solo, arrs, scals, capacity)
    want = stacked_tree_update(name, *[[t if not solo else t[None]
                                        for t in a] for a in arrs], *scals)
    for out_g, out_w in zip(got, want):
        for a, b, (shape, dt) in zip(out_g, out_w, MIXED):
            b = b[0] if solo else b
            assert a.dtype == dt and a.shape == b.shape
            assert torch.equal(a, b)                 # bit for bit, no NaN


@pytest.mark.parametrize("M", [1, 3])
@pytest.mark.parametrize("jax_fn", [jax_apply_update, jax_fused_apply_update],
                         ids=["jax_plain", "jax_pallas_interpret"])
@pytest.mark.parametrize("name", OPTIMIZERS)
def test_stacked_tree_update_matches_jax(name, jax_fn, M):
    """The whole tree at once, M members with divergent hps and steps
    (M = 1: one member, stacked), against the JAX update vmapped over the
    member axis."""
    params, grads, state = problem(name, stack=M, seed=20 + M)
    scale = 1.0 + 0.1 * np.arange(M, dtype=np.float32)
    hp = {k: np.float32(v) * scale for k, v in OPT_HPS[name].items()}
    step = np.arange(M, dtype=np.int32) + 2
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
    keys = sorted(SHAPES)
    trees = [[torch.tensor(params[k]) for k in keys],
             [torch.tensor(grads[k]) for k in keys]]
    trees += [[torch.tensor(state[sk][k]) for k in keys]
              for sk in SLOTS[name]]
    outs = stacked_tree_update(name, *trees, *scal)
    new_p = dict(zip(keys, outs[0]))
    new_s = {sk: dict(zip(keys, o)) for sk, o in zip(SLOTS[name], outs[1:])}
    assert_trees_close((new_p, new_s), (ref_p, ref_s))


@pytest.mark.parametrize("bad", ["scalar_shape", "scalar_count", "unstacked",
                                 "tree_length", "unknown"])
def test_stacked_tree_update_rejects_malformed_operands(bad):
    ps = [torch.zeros(2, 5), torch.zeros(2, 3)]
    gs = [torch.zeros(2, 5), torch.zeros(2, 3)]
    lr, wd = torch.full((2,), 0.1), torch.zeros(2)
    name, args = "sgd", [ps, gs, lr, wd]
    if bad == "scalar_shape":
        args[2] = torch.full((1,), 0.1)
    elif bad == "scalar_count":
        args = args[:3]
    elif bad == "unstacked":
        args[0] = [torch.zeros(2, 5), torch.zeros(3)]
    elif bad == "tree_length":
        args = [ps, gs[:1], lr, wd]
    else:
        name = "lion"
    with pytest.raises(ValueError):
        stacked_tree_update(name, *args)


def test_stacked_tree_update_on_cpu_launches_nothing():
    arrs, scals = tree_operands("adamw", 2, seed=5)
    n0 = (stacked_tree_update.launches, stacked_leaf_update.launches)
    outs = stacked_tree_update("adamw", *arrs, *scals)
    assert [len(o) for o in outs] == [len(MIXED)] * 3
    assert (stacked_tree_update.launches,
            stacked_leaf_update.launches) == n0


def test_tree_plan_refuses_a_strided_leaf_past_32_bit_indices():
    n = 2 ** 16
    with pytest.raises(ValueError, match="32-bit"):
        ko.TreePlan(1, True, ((n, n),), (torch.float32,), ((1, n),))
    # contiguous, the same leaf is read by 64-bit offsets
    plan = ko.TreePlan(1, True, ((n, n),), (torch.float32,), ((n, 1),))
    assert plan.table[0, ko.F_N] == n * n


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_leafwise_yardstick_matches_the_plain_update(name):
    """``leafwise_apply_update`` (the per-leaf design ``chip_smoke.py``
    holds the tree kernel bit-equal to on the card) computes the same
    update; on the CPU its leaves take the plain version."""
    params, grads, state = problem(name, seed=9)
    hp = {k: torch.tensor(v) for k, v in OPT_HPS[name].items()}
    args = (tree_from_numpy(params, "cpu"), tree_from_numpy(grads, "cpu"),
            tree_from_numpy(state, "cpu"), hp, torch.tensor(4))
    got = ko.leafwise_apply_update(name, *args)
    want = apply_update(name, *args)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def test_tree_plan_gives_a_large_leaf_a_buffer_of_its_own():
    """A leaf of SHARED_MAX bytes or more is allocated alone (a 2.7 B
    tree's outputs in one piece would need 5 GB of unbroken memory); the
    small leaves still share one buffer per dtype."""
    big = (ko.SHARED_MAX // 4 // 256, 256)            # exactly SHARED_MAX
    shapes = ((64,), big, (3, 3, 16, 16), big, (10,))
    plan = ko.TreePlan(1, True, shapes, (torch.float32,) * 5,
                       tuple(contiguous_strides(s) for s in shapes))
    assert len(plan.buffers) == 3
    own = [g for g in plan.groups if g[2] == big]
    assert len(own) == 2 and own[0][0] != own[1][0]
    assert all(g[1] == 0 and len(g[3]) == 1 for g in own)
    assert all(plan.buffers[g[0]][1] == ko.SHARED_MAX // 4 for g in own)
    shared = {g[0] for g in plan.groups if g[2] != big}
    assert len(shared) == 1
    views = plan.views([torch.arange(t, dtype=torch.float64)
                        for _, t in plan.buffers])
    assert [tuple(v.shape) for v in views] == [tuple(s) for s in shapes]
