"""The dry run of the PyTorch package held against the JAX package's.

The reference's four launcher tests on the port's ``main`` (reduced
cases run on the CPU); every (arch, shape) pair's status, skip reason,
window and parameter counts equal to ``repro.configs``; the port's reduced
flops beside the JAX record's ``cost["flops"]`` (the flop counter counts
products only, XLA elementwise work too: 0.90-1.00); one full-size
production case's per-device argument bytes equal to the sum the JAX
package's spec trees give; one FSDP + TP product's collectives in closed
form; ``remat`` and ``constrain`` in ``LM`` against the reference's.
Every test leaves no process group behind.
"""

import dataclasses
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

# the production meshes of the JAX dry run want 512 placeholder devices
# only inside its main(); the reference cases below run reduced, on the
# real one-device topology, which is initialised here first
assert jax.devices()

from repro.configs import SHAPES as R_SHAPES  # noqa: E402
from repro.configs import config_for_shape as r_config_for_shape  # noqa: E402
from repro.configs import get_config as r_get_config  # noqa: E402
from repro.configs import shape_applicable as r_shape_applicable  # noqa: E402
from repro.dist import sharding as RS  # noqa: E402
from repro.launch import dryrun as r_dryrun  # noqa: E402
from repro.models.transformer import LM as RLM  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import (fake_process_group,  # noqa: E402
                                     make_production_mesh, mesh_axes,
                                     production_mesh)
from repro_torch.models.transformer import LM  # noqa: E402
from repro_torch.train.torch_trainer import value_and_grad  # noqa: E402
from repro_torch.utils.convert import tree_from_numpy, tree_to_numpy  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

# the suite runs several worker processes side by side: one intra-op
# thread each, or the workers fight over the cores
torch.set_num_threads(1)

SHAPE_NAMES = ["decode_32k", "long_500k", "prefill_32k", "train_4k"]


@pytest.fixture(autouse=True)
def no_process_group_left():
    assert not dist.is_initialized()
    yield
    leaked = dist.is_initialized()
    if leaked:
        dist.destroy_process_group()
    assert not leaked, "a test left a process group behind"


def _run_main(monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", argv)
    dryrun.main()


# ------------------------------------------- the reference's CLI tests
def test_launch_dryrun_reduced_train(monkeypatch, capsys):
    _run_main(monkeypatch, ["dryrun", "--reduced", "--device", "cpu",
                            "--arch", "qwen2-0.5b", "--shape", "train_4k"])
    out = capsys.readouterr().out
    assert "1 ok, 0 skipped" in out and "0 errors" in out


def test_launch_dryrun_reduced_decode(monkeypatch, capsys, tmp_path):
    out_file = tmp_path / "dryrun.jsonl"
    _run_main(monkeypatch, ["dryrun", "--reduced", "--device", "cpu",
                            "--arch", "mamba2-2.7b", "--shape", "decode_32k",
                            "--out", str(out_file)])
    out = capsys.readouterr().out
    assert "1 ok, 0 skipped" in out and "0 errors" in out
    assert out_file.exists()


def test_launch_dryrun_reduced_skips_encoder_decode(monkeypatch, capsys):
    _run_main(monkeypatch, ["dryrun", "--reduced", "--device", "cpu",
                            "--arch", "hubert-xlarge", "--shape",
                            "decode_32k"])
    out = capsys.readouterr().out
    assert "1 skipped (by design), 0 errors" in out


def test_dryrun_reduced_rejects_multipod(monkeypatch):
    with pytest.raises(SystemExit):
        _run_main(monkeypatch, ["dryrun", "--reduced", "--multi-pod"])


# ------------------------------------------------- every (arch, shape)
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("shape_name", SHAPE_NAMES)
@pytest.mark.parametrize("arch", list_archs())
def test_case_config_equals_the_reference(arch, shape_name, reduced):
    """Status, skip reason, window and parameter counts of all 40 pairs,
    without running a step."""
    rec, cfg, _, _ = dryrun.case_config(arch, shape_name, reduced=reduced)
    shape = R_SHAPES[shape_name]
    base = r_get_config(arch)
    if not r_shape_applicable(base, shape):
        assert rec["status"] == "skipped" and cfg is None
        assert rec["reason"] == "encoder-only: no decode step"
        return
    rcfg = r_config_for_shape(base, shape)
    if shape.kind == "train":
        rcfg = dataclasses.replace(rcfg, remat=True)
    if reduced:
        rcfg = rcfg.reduced()
    assert "status" not in rec and rec["layer_scan"] is False
    assert rec["sliding_window"] == rcfg.sliding_window
    assert rec["params"] == rcfg.param_count()
    assert rec["active_params"] == rcfg.active_param_count()
    assert cfg.remat == rcfg.remat


# --------------------------------------------------- flops side by side
@pytest.mark.parametrize("arch,shape_name", [
    ("qwen2-0.5b", "train_4k"), ("qwen2-0.5b", "prefill_32k"),
    ("mamba2-2.7b", "train_4k"), ("qwen2-moe-a2.7b", "train_4k"),
    ("recurrentgemma-2b", "train_4k")])
def test_reduced_flops_beside_the_jax_record(arch, shape_name):
    ref = r_dryrun.run_case(arch, shape_name, reduced=True, verbose=False)
    got = dryrun.run_case(arch, shape_name, reduced=True, device="cpu",
                          verbose=False)
    assert got["status"] == ref["status"] == "ok"
    ratio = got["cost"]["flops"] / ref["cost"]["flops"]
    assert 0.90 <= ratio <= 1.00, ratio
    assert got["collectives"]["total"] == 0.0
    assert got["launches"] == {k: 0 for k in dryrun.LAUNCH_COUNTERS}
    assert got["memory"]["argument_size_in_bytes"] > 0
    assert got["cost"]["bytes accessed"] > 0


# ------------------------------------------------ one production case
def _shard_bytes(shapes, specs, sizes):
    total = 0
    for leaf, spec in zip(jax.tree.leaves(shapes),
                          jax.tree.leaves(specs, is_leaf=lambda x: isinstance(
                              x, jax.sharding.PartitionSpec))):
        shards = math.prod(math.prod(sizes[a] for a in RS_axes(e))
                           for e in spec)
        n = math.prod(leaf.shape) * jnp.dtype(leaf.dtype).itemsize
        assert n % shards == 0
        total += n // shards
    return total


def RS_axes(entry):
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def test_production_decode_argument_bytes_equal_the_reference_specs():
    """qwen2-0.5b × decode_32k on the 16 × 16 mesh: rank 0's argument
    bytes are each parameter and cache leaf's bytes over its shard count
    under the JAX package's spec trees, plus the port's int64 tokens
    (sharded over ``data``) and position."""
    rec = dryrun.run_case("qwen2-0.5b", "decode_32k", verbose=False)
    assert rec["status"] == "ok" and "hlo_path" not in rec
    shape = R_SHAPES["decode_32k"]
    cfg = r_get_config("qwen2-0.5b")
    rules, sizes = RS.ShardingRules.for_mesh(False), RS.MESH_SIZES
    params = jax.eval_shape(RLM(cfg).init, jax.random.PRNGKey(0))
    cache = jax.eval_shape(
        lambda: RLM(cfg).init_cache(shape.global_batch, shape.seq_len))
    want = (_shard_bytes(params, RS.param_specs(params, rules, sizes), sizes)
            + _shard_bytes(cache, RS.cache_specs(
                cfg, cache, rules, shape.global_batch, sizes), sizes)
            + shape.global_batch // 16 * 8 + 8)
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] == want
    assert mem["output_size_in_bytes"] > 0 and mem["temp_size_in_bytes"] > 0
    assert "generated_code_size_in_bytes" not in mem
    coll = rec["collectives"]
    kinds = dryrun.COLLECTIVES
    assert all(coll[k] >= 0 for k in kinds)
    assert coll["total"] == sum(coll[k] for k in kinds)
    assert all((coll["counts"][k] > 0) == (coll[k] > 0) for k in kinds)
    assert coll["counts"]["all-gather"] > 0      # the FSDP gathers
    assert rec["cost"]["flops"] > 0 and rec["layer_scan"] is False


# --------------------------------------------- a hand-checkable collective
def test_fsdp_tp_linear_collectives_in_closed_form():
    """One FSDP + TP product on a fake (2, 2) mesh: the weight (D, F)
    rests sharded on ``data`` (rows) and ``model`` (columns); the gather
    is one all-gather of a (D, F/2) result, the backward one
    reduce-scatter of a (D, F/2) operand: D·F/2·4 bytes each; the
    products are rank 0's (B/2, D) × (D, F/2) and the weight's
    gradient."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.dist.sharding import ShardingRules
    B, D, F = 8, 16, 32
    with fake_process_group(4):
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        gather = dryrun.fsdp_gather(mesh, ShardingRules.for_mesh(False))
        with FakeTensorMode():
            w = distribute_tensor(torch.empty(D, F), mesh,
                                  [Shard(0), Shard(1)]).requires_grad_()
            x = distribute_tensor(torch.empty(B, D), mesh,
                                  [Shard(0), Replicate()])
            dy = distribute_tensor(torch.empty(B, F), mesh,
                                   [Shard(0), Shard(1)])
            rec = dryrun.OpRecorder()
            with rec:
                y = x @ gather(w)
                (g,) = torch.autograd.grad(y, [w], grad_outputs=dy)
        assert g.placements == w.placements
        coll = rec.record()["collectives"]
    assert coll["counts"] == {"all-gather": 1, "all-reduce": 0,
                              "reduce-scatter": 1, "all-to-all": 0,
                              "collective-permute": 0}
    assert coll["all-gather"] == coll["reduce-scatter"] == D * F // 2 * 4
    assert rec.flops == 2 * 2 * (B // 2) * D * (F // 2)   # y and dw


def test_only_ops_without_a_rule_run_replicated(monkeypatch):
    """``log_sigmoid`` (in ``NO_RULE``: DTensor has no rule for it) of an
    (R, C) tensor sharded on both dims of a fake (2, 2) mesh runs on its
    operand gathered whole, innermost dim first (all-gathers of R·C/2
    and R·C f32 values), and is counted in ``replicated``; out of
    ``NO_RULE`` the same refusal raises."""
    import torch.nn.functional as F
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    R, C = 8, 16
    with fake_process_group(4):
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        with FakeTensorMode():
            x = distribute_tensor(torch.empty(R, C), mesh,
                                  [Shard(0), Shard(1)])
            rec = dryrun.OpRecorder()
            with rec:
                y = F.logsigmoid(x)
            assert y.placements == (Replicate(), Replicate())
            assert dict(rec.replicated) == {"aten.log_sigmoid_forward": 1}
            coll = rec.record()["collectives"]
            assert coll["counts"]["all-gather"] == 2
            assert coll["all-gather"] == (R * C // 2 + R * C) * 4
            monkeypatch.setattr(dryrun, "NO_RULE", frozenset())
            with pytest.raises(NotImplementedError, match="log_sigmoid"):
                with dryrun.OpRecorder():
                    F.logsigmoid(x)


# ------------------------------------------------------- the meshes
def test_production_mesh_makes_and_destroys_its_fake_group():
    import repro_torch.launch.mesh  # noqa: F401 — importing touches nothing
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="production_mesh"):
        make_production_mesh()
    with production_mesh() as mesh:
        assert mesh.mesh_dim_names == mesh_axes() == ("data", "model")
        assert tuple(mesh.mesh.shape) == (16, 16)
        assert dist.get_rank() == 0 and dist.get_world_size() == 256
    assert not dist.is_initialized()
    with pytest.raises(ZeroDivisionError):
        with production_mesh(multi_pod=True) as mesh:
            assert mesh.mesh_dim_names == ("pod", "data", "model")
            assert dist.get_world_size() == 512
            1 / 0
    assert not dist.is_initialized()


def test_a_missing_fake_backend_raises_by_name(monkeypatch):
    """No fallback to another backend: the error names the module."""
    import torch.testing._internal.distributed as pkg
    monkeypatch.delattr(pkg, "fake_pg", raising=False)
    monkeypatch.setitem(sys.modules,
                        "torch.testing._internal.distributed.fake_pg", None)
    with pytest.raises(RuntimeError, match="distributed.fake_pg"):
        with production_mesh():
            pass
    assert not dist.is_initialized()


# ------------------------------------------------------------- remat
def _grads(cfg, params, batch):
    (loss, _), grads = value_and_grad(LM(cfg).loss, params, batch)
    return loss, tree_leaves(grads)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "recurrentgemma-2b"])
def test_remat_gives_bit_equal_gradients(arch):
    """recurrentgemma at 5 layers: one cycle of three under checkpoint,
    two trailing blocks outside it."""
    cfg = dataclasses.replace(get_config(arch).reduced(), num_layers=5)
    params = LM(cfg).init(0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 48),
                           generator=torch.Generator().manual_seed(1))
    l0, g0 = _grads(cfg, params, {"tokens": tokens})
    l1, g1 = _grads(dataclasses.replace(cfg, remat=True), params,
                    {"tokens": tokens})
    assert torch.equal(l0, l1)
    assert len(g0) == len(g1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_remat_matches_the_jax_lm_with_remat():
    jcfg = dataclasses.replace(r_get_config("qwen2-0.5b").reduced(),
                               remat=True)
    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(), remat=True)
    jparams = RLM(jcfg).init(jax.random.PRNGKey(0))
    batch = np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(2, 64)).astype(np.int32)
    (jloss, _), jgrads = jax.value_and_grad(RLM(jcfg).loss, has_aux=True)(
        jparams, {"tokens": jnp.asarray(batch)})
    tparams = tree_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    (tloss, _), tgrads = value_and_grad(LM(cfg).loss, tparams,
                                        {"tokens": torch.tensor(batch).long()})
    np.testing.assert_allclose(float(tloss), float(jloss), atol=1e-5)

    def flat(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in flat(tree[k])]
        if isinstance(tree, (list, tuple)):
            return [x for v in tree for x in flat(v)]
        return [tree]

    jl = [np.asarray(x) for x in jax.tree.leaves(jgrads)]
    tl = flat(tree_to_numpy(tgrads))
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)


# --------------------------------------------------------- constrain
def test_constrain_runs_after_cycle_blocks_only_as_in_the_reference():
    """recurrentgemma at 5 layers (one cycle of RG-LRU, RG-LRU, local
    attention, then two RG-LRU blocks): both packages constrain the
    residual stream three times, never after the trailing blocks."""
    cfg = dataclasses.replace(get_config("recurrentgemma-2b").reduced(),
                              num_layers=5)
    jcfg = dataclasses.replace(r_get_config("recurrentgemma-2b").reduced(),
                               num_layers=5)
    seen, jseen = [], []

    def f(x):
        seen.append(tuple(x.shape))
        return x

    def jf(x):
        jseen.append(tuple(x.shape))
        return x

    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 32))
    model = LM(cfg, constrain=f)
    model.loss(model.init(0), {"tokens": torch.tensor(tokens).long()})
    ref = RLM(jcfg, unroll=True, constrain=jf)
    ref.loss(ref.init(jax.random.PRNGKey(0)),
             {"tokens": jnp.asarray(tokens, jnp.int32)})
    assert seen == jseen == [(2, 32, cfg.d_model)] * 3
