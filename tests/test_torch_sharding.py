"""The sharding rules of the PyTorch package against the JAX package's.

For every architecture in ``configs/`` — full and reduced, on the
single-pod and multi-pod production meshes — the port's parameter,
optimizer-state, batch and decode-cache spec trees equal the reference's
``PartitionSpec`` trees entry for entry.  The shape trees are the JAX
package's ``eval_shape`` output carried over as ``torch.device("meta")``
tensors (nothing is allocated, and the port's LM, which does not build
every family yet, is not needed), and for decode the port's own
``LM.init_cache`` on the meta device.

The one departure: the port never names a mesh axis twice.  Where the
reference's spec does — roles that share an axis, as in
``ShardingRules(fsdp="data", tp="data")`` — the port names it once (the
later dimension replicates), and :func:`assert_specs_equal` says so.  A
seeded property test holds that no spec the port builds repeats an axis.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import repro.dist.sharding as RS
import repro_torch.dist.sharding as TS
from repro.configs import SHAPES as R_SHAPES
from repro.configs import config_for_shape as r_config_for_shape
from repro.configs import get_config as r_get_config
from repro.launch.specs import batch_struct as r_batch_struct
from repro.models import LM as RLM
from repro.train.optimizer import init_opt_state as r_init_opt_state
from repro_torch.configs import SHAPES, config_for_shape, get_config, \
    list_archs
from repro_torch.dist.sharding import (MESH_SIZES, P, ShardingRules,
                                       batch_specs, cache_specs,
                                       generic_param_specs, param_specs,
                                       seq_constrainer, spec_axes,
                                       spec_leaves)
from repro_torch.launch.specs import batch_struct, input_specs
from repro_torch.models.transformer import LM
from repro_torch.train.optimizer import init_opt_state

# the suite runs several worker processes side by side: one intra-op
# thread each, or the workers fight over the cores
torch.set_num_threads(1)

RULE_SETS = {
    "single-pod": lambda S: S.ShardingRules.for_mesh(False),
    "multi-pod": lambda S: S.ShardingRules.for_mesh(True),
    # roles that share an axis: the reference names "data" twice
    "shared-axis": lambda S: S.ShardingRules(fsdp="data", tp="data",
                                             dp=("data",)),
}


def to_meta(tree):
    """A JAX shape tree (dicts, lists, tuples of ``ShapeDtypeStruct``) as
    the same containers of meta tensors."""
    if isinstance(tree, dict):
        return {k: to_meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [to_meta(v) for v in tree]
        return out if isinstance(tree, list) else tuple(out)
    return torch.empty(tuple(tree.shape), device="meta")


@functools.lru_cache(maxsize=None)
def ref_param_shapes(arch, reduced):
    cfg = r_get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    return jax.eval_shape(RLM(cfg).init, jax.random.PRNGKey(0))


def dedup(entries):
    """The reference's spec entries with every later repeat of an axis
    replaced by ``None`` — what the port emits for it."""
    out, used = [], set()
    for e in entries:
        names = spec_axes(e)
        if e is None or used.intersection(names):
            out.append(None)
        else:
            used.update(names)
            out.append(e)
    return tuple(out)


def assert_specs_equal(ref, got, path=()):
    """Entry for entry, walking both trees; returns how many reference
    specs named an axis twice (where the port's names it once)."""
    if isinstance(ref, JP):
        assert isinstance(got, P), (path, got)
        entries = tuple(ref)
        names = [a for e in entries for a in spec_axes(e)]
        if len(names) != len(set(names)):
            assert tuple(got) == dedup(entries), (path, ref, got)
            return 1
        assert tuple(got) == entries, (path, ref, got)
        return 0
    if isinstance(ref, dict):
        assert isinstance(got, dict) and got.keys() == ref.keys(), path
        return sum(assert_specs_equal(ref[k], got[k], path + (k,))
                   for k in ref)
    assert isinstance(got, type(ref)) and len(got) == len(ref), path
    return sum(assert_specs_equal(r, g, path + (i,))
               for i, (r, g) in enumerate(zip(ref, got)))


@pytest.mark.parametrize("rules", sorted(RULE_SETS))
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", list_archs())
def test_param_and_optimizer_specs_equal_the_reference(arch, reduced, rules):
    """Parameters and their AdamW state (which mirrors the tree under
    ``m`` / ``v``) on the production meshes and on a one-device mesh."""
    shapes = ref_param_shapes(arch, reduced)
    meta = to_meta(shapes)
    r_rules, t_rules = RULE_SETS[rules](RS), RULE_SETS[rules](TS)
    ref_opt = jax.eval_shape(lambda p: r_init_opt_state("adamw", p), shapes)
    got_opt = init_opt_state("adamw", meta)
    dups = 0
    for sizes in (None, {"pod": 1, "data": 1, "model": 1}):
        dups += assert_specs_equal(RS.param_specs(shapes, r_rules, sizes),
                                   param_specs(meta, t_rules, sizes))
        dups += assert_specs_equal(RS.param_specs(ref_opt, r_rules, sizes),
                                   param_specs(got_opt, t_rules, sizes))
    # the shared-axis rules make the reference repeat "data" (the
    # embedding's (tp, fsdp) at least); the presets never do
    assert (dups > 0) == (rules == "shared-axis")


@pytest.mark.parametrize("multi_pod", [False, True], ids=["single", "multi"])
@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k"])
@pytest.mark.parametrize("arch", list_archs())
def test_batch_specs_equal_the_reference(arch, shape_name, multi_pod):
    cfg, shape = get_config(arch), SHAPES[shape_name]
    ref_batch = r_batch_struct(r_get_config(arch), shape.global_batch,
                               shape.seq_len)
    got_batch = batch_struct(cfg, shape.global_batch, shape.seq_len)
    assert {k: tuple(v.shape) for k, v in got_batch.items()} == \
        {k: tuple(v.shape) for k, v in ref_batch.items()}
    assert all(v.device.type == "meta" for v in got_batch.values())
    kind, kwargs = input_specs(cfg, shape)
    assert kind == shape.kind and list(kwargs) == ["batch"]
    assert {k: (tuple(v.shape), v.dtype) for k, v in kwargs["batch"].items()} \
        == {k: (tuple(v.shape), v.dtype) for k, v in got_batch.items()}
    assert assert_specs_equal(
        RS.batch_specs(r_get_config(arch), ref_batch,
                       RS.ShardingRules.for_mesh(multi_pod)),
        batch_specs(cfg, got_batch, ShardingRules.for_mesh(multi_pod))) == 0


@pytest.mark.parametrize("arch", ["yi-34b", "mamba2-2.7b",
                                  "recurrentgemma-2b", "grok-1-314b"])
@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
def test_cache_specs_equal_the_reference(arch, shape_name):
    """Decode caches: the port's own ``LM.init_cache`` tree (meta tensors)
    and the cache of ``input_specs``'s decode inputs have the reference's
    keys, nesting and shapes, and their specs equal the reference's (the
    RG-LRU family's stacked ``h`` / ``conv`` states and its local layer's
    KV ring too, since slice 12)."""
    shape = R_SHAPES[shape_name]
    cfg = r_config_for_shape(r_get_config(arch), shape)
    cache = jax.eval_shape(
        lambda: RLM(cfg).init_cache(shape.global_batch, shape.seq_len))
    tcfg = config_for_shape(get_config(arch), SHAPES[shape_name])
    ours = LM(tcfg).init_cache(shape.global_batch, shape.seq_len,
                               device="meta")
    kind, kwargs = input_specs(tcfg, SHAPES[shape_name])
    assert kind == "decode"
    assert jax.tree.structure(cache) == jax.tree.structure(
        jax.tree.map(lambda _: 0, kwargs["cache"])) == \
        jax.tree.structure(jax.tree.map(lambda _: 0, ours))
    for a, b, c in zip(jax.tree.leaves(cache),
                       jax.tree.leaves(kwargs["cache"]),
                       jax.tree.leaves(ours)):
        assert a.shape == tuple(b.shape) == tuple(c.shape)
        assert str(a.dtype) == str(c.dtype).split(".")[-1]
        assert b.device.type == c.device.type == "meta"
    for multi_pod in (False, True):
        assert assert_specs_equal(
            RS.cache_specs(cfg, cache, RS.ShardingRules.for_mesh(multi_pod),
                           shape.global_batch),
            cache_specs(tcfg, ours, ShardingRules.for_mesh(multi_pod),
                        shape.global_batch)) == 0


def test_no_spec_names_an_axis_twice():
    """Seeded property test: random role assignments over random meshes
    (roles sharing axes included) and random shapes — every spec the port
    builds names each axis at most once, passes the divisibility gate, and
    ``P`` itself refuses a repeat."""
    rng = np.random.default_rng(0)
    axes = ("pod", "data", "model")
    with pytest.raises(ValueError, match="twice"):
        P("data", None, "data")
    with pytest.raises(ValueError, match="twice"):
        P(("pod", "data"), "data")
    names = ["embed", "lm_head", "wq", "wo", "wi", "wg", "router", "in_x",
             "out_proj", "conv_x", "w_in", "k", "state", "tokens",
             "positions"]
    parents = ["attn", "ffn", "ssm", "rglru", "shared", "x"]
    seen = 0
    for _ in range(400):
        pick = lambda: (None if rng.random() < 0.2
                        else axes[rng.integers(3)])
        dp = tuple(axes[i] for i in sorted(set(rng.integers(0, 3, 2))))
        rules = ShardingRules(fsdp=pick(), tp=pick(), dp=dp, pod=pick())
        sizes = {a: int(rng.choice([1, 2, 4, 16])) for a in axes}
        tree = {"cycles": [{parents[rng.integers(len(parents))]: {
            names[rng.integers(len(names))]: torch.empty(
                tuple(int(rng.choice([1, 2, 8, 12, 64]))
                      for _ in range(rng.integers(1, 5))), device="meta")}}]}
        for fn in (lambda t: param_specs(t, rules, sizes),
                   lambda t: generic_param_specs(t, rules, sizes,
                                                 n_lead=int(rng.integers(2))),
                   lambda t: batch_specs(None, t, rules, sizes),
                   lambda t: cache_specs(None, t, rules, 8, sizes)):
            try:
                specs = fn(tree)
            except ValueError:
                continue                     # a role tuple longer than a leaf
            leaf = tree["cycles"][0]
            leaf = next(iter(next(iter(leaf.values())).values()))
            for spec in spec_leaves(specs):
                seen += 1
                used = [a for e in spec for a in spec_axes(e)]
                assert len(used) == len(set(used)), spec
                for dim, e in zip(leaf.shape, spec):
                    if e is not None:
                        n = int(np.prod([sizes[a] for a in spec_axes(e)]))
                        assert dim % n == 0, (leaf.shape, spec, sizes)
    assert seen > 500


@pytest.mark.parametrize("n_lead", [0, 1])
def test_generic_param_specs_equal_the_reference(n_lead):
    """The best-effort placement of arbitrary trees (a ResNet's, a member-
    stacked carry's) on worker meshes, against the reference's."""
    shapes = {"conv": jax.ShapeDtypeStruct((3, 3, 16, 32), "float32"),
              "fc": [jax.ShapeDtypeStruct((64, 10), "float32"),
                     jax.ShapeDtypeStruct((10,), "float32")],
              "odd": jax.ShapeDtypeStruct((3, 5), "float32")}
    for sizes in ({"data": 4}, {"data": 2, "model": 2}, {"data": 3},
                  {"data": 1}):
        r_rules = RS.ShardingRules.for_mesh(False)
        assert assert_specs_equal(
            RS.generic_param_specs(shapes, r_rules, sizes, n_lead),
            generic_param_specs(to_meta(shapes), ShardingRules.for_mesh(
                False), sizes, n_lead)) == 0


def test_presets_and_seq_constrainer():
    assert ShardingRules.for_mesh(True).dp_axis == ("pod", "data")
    assert ShardingRules.for_mesh(False).dp_axis == "data"
    assert MESH_SIZES == RS.MESH_SIZES
    assert seq_constrainer(ShardingRules.for_mesh(False)) is None
    seqpar = ShardingRules(fsdp="data", tp="model", dp=("data",),
                           seq="model")
    x = torch.ones(2, 3, 4)
    assert seq_constrainer(seqpar, {"data": 1, "model": 1})(x) is x
    # a sequence split over 16 devices needs the DTensor mesh to split on
    with pytest.raises(NotImplementedError,
                       match="16 devices.*pass the torch.distributed "
                             "DeviceMesh"):
        seq_constrainer(seqpar)              # model = 16 devices
