"""The attention LM of the PyTorch package held against the JAX package.

On qwen2-0.5b's ``reduced()`` variant (2 layers, d_model 256, vocab 512,
f32), with weights initialised in JAX and carried across leaf for leaf:
the loss within atol 1e-5 and every gradient leaf within atol 1e-4, with
the attention on its plain path and on the kernel binding (JAX in
interpret mode; the port's CPU tensors take the kernels' plain versions);
three AdamW steps of ``JaxTrainer(use_kernel=True)`` against
``TorchTrainer(device="cpu", use_kernel=True)`` within 1e-4; and the
port's own study, stage-based against trial-based, bit for bit.  The
configuration registry is a copy of the JAX package's: same fields, same
``reduced()``, same parameter counts.
"""

import dataclasses
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import list_archs as jax_list_archs
from repro.core.trainer import StageContext as RefStageContext
from repro.data.pipeline import DataPipeline as RefDataPipeline
from repro.models import layers as jax_layers
from repro.models.transformer import LM as JaxLM
from repro.train.jax_trainer import JaxTrainer
from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.core import Constant, HpConfig
from repro_torch.core.searchplan import SearchPlan
from repro_torch.core.trainer import StageContext
from repro_torch.core.trial import Trial
from repro_torch.data import DataPipeline, synthetic_lm_dataset
from repro_torch.kernels import ops as kops
from repro_torch.models import layers
from repro_torch.models.transformer import LM
from repro_torch.train.torch_trainer import TorchTrainer, value_and_grad
from repro_torch.utils.convert import (state_from_numpy, tree_from_numpy,
                                       tree_to_numpy)
from repro_torch.utils.tree import tree_leaves

# the suite runs several worker processes side by side: one intra-op
# thread each, or the workers fight over the cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "qwen2-0.5b"
CFG = get_config(ARCH).reduced()
JCFG = jax_get_config(ARCH).reduced()


def flat(tree):
    """Leaves in ``jax.tree.leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in flat(v)]
    return [tree]


def jax_params(seed=0):
    """JAX-initialised weights with every bias and norm moved off its
    constant init, so each gradient path carries signal."""
    params = JaxLM(JCFG).init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 100)
    return jax.tree.map(
        lambda x: x + jnp.asarray(0.02 * rng.normal(size=x.shape), x.dtype),
        params)


def tokens(batch, seq, seed=1):
    return np.random.default_rng(seed).integers(
        0, CFG.vocab_size, size=(batch, seq)).astype(np.int32)


# -------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", jax_list_archs())
def test_config_registry_is_the_jax_packages(arch):
    assert list_archs() == jax_list_archs()
    for mine, ref in ((get_config(arch), jax_get_config(arch)),
                      (get_config(arch).reduced(),
                       jax_get_config(arch).reduced())):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert mine.param_count() == ref.param_count()
        assert mine.active_param_count() == ref.active_param_count()
    assert SHAPES["train_4k"].seq_len == 4096


def test_param_count_exact():
    params = LM(CFG).init(0)
    assert sum(x.numel() for x in tree_leaves(params)) == CFG.param_count()
    full = get_config(ARCH)
    assert (full.num_layers, full.d_model, full.num_heads, full.num_kv_heads,
            full.resolved_head_dim, full.vocab_size) == \
        (24, 896, 14, 2, 64, 151936)
    assert full.param_count() == jax_get_config(ARCH).param_count()


def test_init_tree_matches_jax_structure():
    """Same keys, nesting, shapes and dtypes as the JAX package's init
    (reduced f32 and a bf16 variant); the draws have the same scale, not
    the same bits."""
    for dtype in ("float32", "bfloat16"):
        jcfg = dataclasses.replace(JCFG, dtype=dtype)
        cfg = dataclasses.replace(CFG, dtype=dtype)
        jshapes = jax.eval_shape(lambda: JaxLM(jcfg).init(
            jax.random.PRNGKey(0)))
        mine = LM(cfg).init(0)
        assert jax.tree.structure(jshapes) == jax.tree.structure(
            jax.tree.map(lambda _: 0, tree_to_numpy(mine)))
        for a, b in zip(flat(mine), jax.tree.leaves(jshapes)):
            assert tuple(a.shape) == b.shape
            assert str(a.dtype).split(".")[-1] == str(b.dtype)
    again = LM(CFG).init(0)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(again),
                                                 tree_leaves(LM(CFG).init(0))))
    wq = again["cycles"][0]["attn"]["wq"]
    assert float(wq.abs().max()) <= 2.0 * CFG.d_model ** -0.5 + 1e-6


@pytest.mark.parametrize("arch,slice_no", [
    ("mamba2-2.7b", None), ("recurrentgemma-2b", "slice 12"),
    ("grok-1-314b", None), ("qwen2-moe-a2.7b", None),
    ("qwen2-vl-7b", "slice 11"), ("hubert-xlarge", "slice 11")])
def test_unported_families_register_but_do_not_build(arch, slice_no):
    """Every family the registry holds now builds (``slice_no``: the ROADMAP
    queue A slice that ported it last — 12 RG-LRU, 11 the frontends): the
    tree is the JAX package's, key for key and shape for shape, and counts
    ``param_count()`` parameters."""
    cfg = get_config(arch).reduced()
    jshapes = jax.eval_shape(lambda: JaxLM(jax_get_config(
        arch).reduced()).init(jax.random.PRNGKey(0)))
    mine = LM(cfg).init(0)
    assert jax.tree.structure(jshapes) == jax.tree.structure(
        jax.tree.map(lambda _: 0, tree_to_numpy(mine)))
    assert [tuple(a.shape) for a in flat(mine)] == \
        [b.shape for b in jax.tree.leaves(jshapes)]
    assert sum(x.numel() for x in tree_leaves(mine)) == cfg.param_count()
    if cfg.n_experts:
        assert mine["cycles"][0]["ffn"]["router"].dtype == torch.float32
    if slice_no is None and not cfg.n_experts:
        assert LM(cfg).pattern == ("ssm",)
    if slice_no == "slice 12":
        assert LM(cfg).pattern == ("rglru", "rglru", "local")
        assert mine["cycles"][0]["rglru"]["lam"].dtype == torch.float32
    if slice_no == "slice 11":
        assert tuple(mine["frontend_proj"].shape) == (cfg.frontend_dim,
                                                      cfg.d_model)


# ---------------------------------------------------------------- layers
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_and_rope_match_jax(dtype):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 16, 4, 32)).astype(np.float32)
    w = rng.normal(size=(32,)).astype(np.float32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jx, tx = jnp.asarray(x, jd), torch.tensor(x).to(td)
    tol = dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" else \
        dict(atol=1e-5, rtol=1e-5)

    got = layers.rms_norm(tx, torch.tensor(w).to(td), 1e-6)
    want = jax_layers.rms_norm(jx, jnp.asarray(w, jd), 1e-6)
    assert got.dtype == td
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)

    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16))
    cos, sin = layers.rope_angles(torch.tensor(pos), 32, 1e6)
    jcos, jsin = jax_layers.rope_angles(jnp.asarray(pos), 32, 1e6)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-5)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-5)
    got = layers.apply_rope(tx, cos, sin)
    want = jax_layers.apply_rope(jx, jcos, jsin)
    assert got.dtype == td
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)

    pos3 = np.stack([pos, pos // 2, pos % 3])          # (3, B, S) ids
    for a, b in zip(layers.mrope_angles(torch.tensor(pos3), 32, (8, 4, 4),
                                        1e6),
                    jax_layers.mrope_angles(jnp.asarray(pos3), 32, (8, 4, 4),
                                            1e6)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_bf16_leaves_carry_across_bit_for_bit():
    x = jnp.asarray(np.random.default_rng(4).normal(size=(7, 5)),
                    jnp.bfloat16)
    leaf = np.asarray(x)
    assert leaf.dtype.name == "bfloat16"
    got = tree_from_numpy({"w": leaf}, "cpu")["w"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(x).view(np.int16))
    assert tree_from_numpy({"w": leaf}, "cpu", torch.float32)["w"].dtype \
        == torch.float32


# ------------------------------------------------------- loss and grads
@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["plain_attention", "kernel_binding"])
def test_loss_and_grads_match_jax(use_kernel):
    jparams = jax_params()
    batch = tokens(2, 96)
    ref = JaxLM(JCFG, use_kernel=use_kernel)
    (jloss, jaux), jgrads = jax.value_and_grad(ref.loss, has_aux=True)(
        jparams, {"tokens": jnp.asarray(batch)})

    net = LM(CFG, use_kernel=use_kernel)
    tparams = tree_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    tbatch = {"tokens": torch.tensor(batch).long()}
    kops.reset_kernel_stats()
    if use_kernel:
        with pytest.warns(kops.KernelFallbackWarning,
                          match="flash_attention"):
            (tloss, taux), tgrads = value_and_grad(net.loss, tparams, tbatch)
        assert kops.KERNEL_STATS.fallbacks == CFG.num_layers
    else:
        (tloss, taux), tgrads = value_and_grad(net.loss, tparams, tbatch)
        assert kops.KERNEL_STATS.fallbacks == 0
    kops.reset_kernel_stats()

    np.testing.assert_allclose(float(tloss), float(jloss), atol=1e-5)
    np.testing.assert_allclose(float(taux["nll"]), float(jaux["nll"]),
                               atol=1e-5)
    jl = [np.asarray(x) for x in jax.tree.leaves(jgrads)]
    tl = flat(tree_to_numpy(tgrads))
    assert len(jl) == len(tl) == len(tree_leaves(tparams))
    for a, b in zip(tl, jl):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)
    # every gradient the update kernel reads arrives contiguous
    assert all(g.is_contiguous() for g in tree_leaves(tgrads))


def test_bf16_forward_close_to_jax():
    """The full model's working type: bf16 weights and activations, f32
    norms, softmax and logits, on carried-across weights."""
    jcfg = dataclasses.replace(JCFG, dtype="bfloat16")
    cfg = dataclasses.replace(CFG, dtype="bfloat16")
    jparams = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jax_params())
    batch = tokens(2, 64)
    jl, _ = JaxLM(jcfg).loss(jparams, {"tokens": jnp.asarray(batch)})
    tl, _ = LM(cfg).loss(tree_from_numpy(jax.tree.map(np.asarray, jparams),
                                         "cpu"),
                         {"tokens": torch.tensor(batch).long()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=2e-2)


# ------------------------------------------------------ trainer against JAX
def trial_stages(trial, steps):
    plan = SearchPlan("solo-" + trial.trial_id)
    node, _, _ = plan.submit(trial, steps)
    path = plan.path_to_root(node.node_id)
    return [StageContext(n.node_id, n.desc, n.start, n.start,
                         steps if i == len(path) - 1 else path[i + 1].start,
                         plan.path_key(n.node_id))
            for i, n in enumerate(path)]


def test_three_adamw_steps_match_jax_trainer():
    data = synthetic_lm_dataset(32, 64, CFG.vocab_size, seed=0)
    eval_data = synthetic_lm_dataset(2, 64, CFG.vocab_size, seed=5)
    ref = JaxTrainer(JaxLM(JCFG),
                     lambda: RefDataPipeline(data, batch_size=2, seed=3),
                     eval_data, default_optimizer="adamw", backend="cpu",
                     use_kernel=True)
    assert ref.task.use_kernel
    port = TorchTrainer(LM(CFG), lambda: DataPipeline(data, batch_size=2,
                                                      seed=3),
                        eval_data, default_optimizer="adamw", device="cpu",
                        use_kernel=True)
    assert port.task.use_kernel        # the trainer switched the LM over

    # the study's learning rate: Adam normalises each step, so a gradient
    # element that is float noise in both packages (here a k-bias) moves by
    # up to lr per step in either direction
    trial = Trial(HpConfig({"lr": Constant(3e-4), "bs": Constant(2)}), 3)
    (ctx,) = trial_stages(trial, 3)
    jstate = ref.init_state()
    tstate = state_from_numpy(
        {**jstate, "params": jax.tree.map(np.asarray, jstate["params"])},
        "cpu")
    jstate = ref.run_stage(jstate, RefStageContext(
        ctx.node_id, ctx.desc, ctx.node_start, ctx.start, ctx.stop,
        ctx.path_key))
    kops.reset_kernel_stats()
    with pytest.warns(kops.KernelFallbackWarning):
        tstate = port.run_stage(tstate, ctx)
    # per step: one update and one attention call per layer, all plain
    assert port.kernel_fallbacks == 3 * (1 + CFG.num_layers)
    kops.reset_kernel_stats()
    assert tstate["step"] == jstate["step"] == 3
    assert tstate["data"] == tuple(jstate["data"])

    jl = [np.asarray(x) for x in jax.tree.leaves(jstate["params"])]
    tl = flat(tree_to_numpy(tstate["params"]))
    init = flat(jax.tree.map(np.asarray, ref.init_state()["params"]))
    moved = 0.0
    for a, b, p0 in zip(tl, jl, init):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)
        moved = max(moved, float(np.abs(b - p0).max()))
    assert moved > 5e-4                 # training did move the weights


# ------------------------------------------------- stage vs trial, in port
def test_study_stage_based_equals_trial_based_bitwise(monkeypatch):
    monkeypatch.syspath_prepend(os.path.join(ROOT, "examples"))
    example = importlib.import_module("torch_hpo_lm")
    runs = {}
    for share in (True, False):
        backend = example.make_backend(reduced=True, seq_len=32, n_train=64,
                                       n_eval=4, device="cpu")
        stats, tuner, store, _ = example.run_study(backend, share)
        assert tuner.is_done() and stats.kernel_fallbacks == 0
        assert backend.evaluations > 0
        runs[share] = (stats, tuner)
    (s_stats, s_tuner), (t_stats, t_tuner) = runs[True], runs[False]
    assert s_stats.steps_run == 16 and t_stats.steps_run == 32
    assert s_tuner.history == t_tuner.history      # every metric, bit for bit
    assert s_tuner.best.trial_id == t_tuner.best.trial_id
    assert all(np.isfinite(m["loss"]) for m in s_tuner.history.values())
