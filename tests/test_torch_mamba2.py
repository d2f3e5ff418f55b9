"""The Mamba2 model of the PyTorch package held against the JAX package.

On the CPU, with numpy-seeded inputs fed to both packages: the chunked SSD
algorithm against the step-by-step recurrence (any chunking, 1e-4), its
kernel path against its plain path, ``ssd_chunked`` and ``ssm_forward``
against the JAX package's; then mamba2-2.7b's ``reduced()`` variant (2
layers, d_model 256, 8 SSD heads of 64, state 32, chunk 16, vocab 512,
f32) with weights initialised in JAX and carried across leaf for leaf —
the same tree (``A_log`` / ``dt_bias`` f32 in a bf16 tree too) and
``param_count``, the loss within atol 1e-5 and every gradient leaf within
atol 1e-4 on the plain and on the kernel path, a bf16 forward, three AdamW
steps of ``JaxTrainer(use_kernel=True)`` against
``TorchTrainer(device="cpu", use_kernel=True)`` within 1e-4 — and the
port's own study, stage-based against trial-based, bit for bit.
"""

import dataclasses
import importlib
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.trainer import StageContext as RefStageContext
from repro.data.pipeline import DataPipeline as RefDataPipeline
from repro.models import ssm as jax_ssm
from repro.models.transformer import LM as JaxLM
from repro.train.jax_trainer import JaxTrainer
from repro_torch.configs import get_config
from repro_torch.core import Constant, HpConfig
from repro_torch.core.searchplan import SearchPlan
from repro_torch.core.trainer import StageContext
from repro_torch.core.trial import Trial
from repro_torch.data import DataPipeline, synthetic_lm_dataset
from repro_torch.kernels import ops as kops
from repro_torch.models import ssm
from repro_torch.models.transformer import LM
from repro_torch.train.torch_trainer import TorchTrainer, value_and_grad
from repro_torch.utils.convert import (state_from_numpy, tree_from_numpy,
                                       tree_to_numpy)
from repro_torch.utils.tree import tree_leaves

# the suite runs several worker processes side by side: one intra-op
# thread each, or the workers fight over the cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "mamba2-2.7b"
CFG = get_config(ARCH).reduced()
JCFG = jax_get_config(ARCH).reduced()


def flat(tree):
    """Leaves in ``jax.tree.leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in flat(v)]
    return [tree]


def ssd_inputs(B, S, H, P, N, seed):
    """x, dt, A, Bm, Cm as f32 numpy (``tests/test_kernels.py``'s draws)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, H, P))
    dt = np.log1p(np.exp(rng.normal(size=(B, S, H))))
    A = -np.exp(rng.normal(size=(H,)) * 0.5)
    Bm = rng.normal(size=(B, S, N))
    Cm = rng.normal(size=(B, S, N))
    return [np.asarray(a, np.float32) for a in (x, dt, A, Bm, Cm)]


def quiet(fn, *args, **kw):
    """Run ``fn`` with the CPU fallback's warning silenced, then clear the
    kernel-plane counters."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", kops.KernelFallbackWarning)
        out = fn(*args, **kw)
    kops.reset_kernel_stats()
    return out


def jax_params(seed=0):
    """JAX-initialised weights with every bias, norm and decay moved off
    its constant init, so each gradient path carries signal."""
    params = JaxLM(JCFG).init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 100)
    return jax.tree.map(
        lambda x: x + jnp.asarray(0.02 * rng.normal(size=x.shape), x.dtype),
        params)


def tokens(batch, seq, seed=1):
    return np.random.default_rng(seed).integers(
        0, CFG.vocab_size, size=(batch, seq)).astype(np.int32)


# ------------------------------------------------------------ SSD core
@pytest.mark.parametrize("chunk", [8, 16, 32, 64])
def test_ssd_chunked_matches_sequential(chunk):
    """The chunked SSD algorithm == step-by-step recurrence, any chunking."""
    x, dt, A, Bm, Cm = (torch.tensor(a) for a in ssd_inputs(2, 64, 3, 8, 16,
                                                            seed=0))
    y1, s1 = ssm.ssd_chunked(x, dt, A, Bm, Cm, chunk)
    y2, s2 = ssm.ssd_sequential(x, dt, A, Bm, Cm)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), atol=1e-4)
    np.testing.assert_allclose(s1.numpy(), s2.numpy(), atol=1e-4)


def test_ssd_chunked_kernel_path_matches_plain_path():
    x, dt, A, Bm, Cm = (torch.tensor(a) for a in ssd_inputs(1, 64, 2, 16, 16,
                                                            seed=1))
    y1, s1 = ssm.ssd_chunked(x, dt, A, Bm, Cm, 16, use_kernel=False)
    y2, s2 = quiet(ssm.ssd_chunked, x, dt, A, Bm, Cm, 16, use_kernel=True)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), atol=1e-4)
    assert torch.equal(s1, s2)          # the state hand-off is shared code


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["plain_intra", "kernel_intra"])
def test_ssd_chunked_matches_jax(use_kernel):
    arrs = ssd_inputs(2, 64, 4, 16, 24, seed=2)
    jy, js = jax_ssm.ssd_chunked(*(jnp.asarray(a) for a in arrs), 16,
                                 use_kernel=use_kernel)
    ty, ts = quiet(ssm.ssd_chunked, *(torch.tensor(a) for a in arrs), 16,
                   use_kernel=use_kernel)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-4)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-4)


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["plain_intra", "kernel_intra"])
def test_ssm_forward_matches_jax(use_kernel):
    jp = jax.tree.map(lambda x: x + 0.05, jax_ssm.init_ssm(
        JCFG, jax.random.PRNGKey(3), jnp.float32))
    tp = tree_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.default_rng(4).normal(size=(2, 48, CFG.d_model)).astype(
        np.float32)
    want = jax_ssm.ssm_forward(jp, JCFG, jnp.asarray(x),
                               use_kernel=use_kernel)
    got = quiet(ssm.ssm_forward, tp, CFG, torch.tensor(x),
                use_kernel=use_kernel)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_decode_raises_naming_its_slice():
    """SSM decode is ported (slice 10): the cache has the reference's
    shapes and one step updates it in place; so is the RG-LRU family's
    (slice 12), whose cache tree is the reference's too.  The decodes
    themselves are held against the JAX package in
    ``tests/test_torch_decode.py`` and ``tests/test_torch_rglru.py``."""
    cache = ssm.init_ssm_cache(CFG, 1, torch.float32)
    want = jax_ssm.init_ssm_cache(JCFG, 1, jnp.float32)
    assert [tuple(a.shape) for a in flat(cache)] == \
        [b.shape for b in jax.tree.leaves(want)]
    params = LM(CFG).init(0)["cycles"][0]["ssm"]
    params = {k: v[0] for k, v in params.items()}
    out, same = ssm.ssm_decode(params, CFG, torch.ones((1, 1, CFG.d_model)),
                               cache)
    assert same is cache and out.shape == (1, 1, CFG.d_model)
    assert float(cache["state"].abs().max()) > 0
    rg = "recurrentgemma-2b"
    rcache = LM(get_config(rg).reduced()).init_cache(1, 8)
    rwant = jax.eval_shape(lambda: JaxLM(jax_get_config(rg).reduced())
                           .init_cache(1, 8))
    assert [tuple(a.shape) for a in flat(rcache)] == \
        [b.shape for b in jax.tree.leaves(rwant)]


# ------------------------------------------------------ config and tree
def test_config_param_count_and_tree_match_jax():
    """mamba2-2.7b's full and reduced configurations are the JAX
    package's; the parameter tree has the same keys, shapes and dtypes
    (``A_log`` / ``dt_bias`` f32 in a bf16 tree), 13 SSM leaves and 16 in
    all, and counts ``param_count()`` parameters."""
    full = get_config(ARCH)
    assert dataclasses.asdict(full) == dataclasses.asdict(
        jax_get_config(ARCH))
    assert full.param_count() == jax_get_config(ARCH).param_count() \
        == 2_702_235_136
    assert (full.num_layers, full.d_model, full.ssm_inner, full.ssm_heads,
            full.ssm_head_dim, full.ssm_state, full.ssm_chunk,
            full.ssm_conv, full.vocab_size) == (64, 2560, 5120, 80, 64, 128,
                                                128, 4, 50280)
    assert dataclasses.replace(full, num_layers=32).param_count() \
        == 1_415_477_248
    assert (CFG.num_layers, CFG.d_model, CFG.ssm_heads, CFG.ssm_state,
            CFG.ssm_chunk, CFG.dtype) == (2, 256, 8, 32, 16, "float32")
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
        assert len(tree_leaves(mine)) == 16
        assert len(mine["cycles"][0]["ssm"]) == 13
        assert mine["cycles"][0]["ssm"]["A_log"].dtype == torch.float32
        assert mine["cycles"][0]["ssm"]["dt_bias"].dtype == torch.float32
        assert sum(x.numel() for x in tree_leaves(mine)) == \
            cfg.param_count()


def test_carried_bf16_tree_keeps_its_f32_leaves():
    jcfg = dataclasses.replace(JCFG, dtype="bfloat16")
    jp = JaxLM(jcfg).init(jax.random.PRNGKey(0))
    tp = tree_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    for a, b in zip(flat(tp), jax.tree.leaves(jp)):
        assert str(a.dtype).split(".")[-1] == str(b.dtype)
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32))
    assert tp["cycles"][0]["ssm"]["A_log"].dtype == torch.float32


# ------------------------------------------------------- loss and grads
@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["plain_ssd", "kernel_binding"])
def test_loss_and_grads_match_jax(use_kernel):
    jparams = jax_params()
    batch = tokens(2, 64)
    ref = JaxLM(JCFG, use_kernel=use_kernel)
    (jloss, jaux), jgrads = jax.value_and_grad(ref.loss, has_aux=True)(
        jparams, {"tokens": jnp.asarray(batch)})

    net = LM(CFG, use_kernel=use_kernel)
    tparams = tree_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    tbatch = {"tokens": torch.tensor(batch).long()}
    kops.reset_kernel_stats()
    if use_kernel:
        with pytest.warns(kops.KernelFallbackWarning, match="ssd_intra"):
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
    assert len(jl) == len(tl) == len(tree_leaves(tparams)) == 16
    for a, b in zip(tl, jl):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)
    # every gradient the update kernel reads arrives contiguous
    assert all(g.is_contiguous() for g in tree_leaves(tgrads))


def test_bf16_forward_close_to_jax():
    """The full model's working type: bf16 weights and activations, f32
    decays, norms and logits, on carried-across weights."""
    jcfg = dataclasses.replace(JCFG, dtype="bfloat16")
    cfg = dataclasses.replace(CFG, dtype="bfloat16")
    # the bf16 tree's dtypes, leaf for leaf (A_log, dt_bias stay f32)
    jparams = jax.tree.map(lambda x, y: x.astype(y.dtype), jax_params(),
                           jax.eval_shape(lambda: JaxLM(jcfg).init(
                               jax.random.PRNGKey(0))))
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
    # per step: one update and one SSD call per layer, all plain
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
        backend = example.make_backend(arch=ARCH, reduced=True, seq_len=32,
                                       n_train=64, n_eval=4, device="cpu")
        assert backend.task.cfg.layer_pattern == ("ssm",)
        stats, tuner, store, _ = example.run_study(backend, share, name=ARCH)
        assert tuner.is_done() and stats.kernel_fallbacks == 0
        assert backend.evaluations > 0
        assert len(store) > 0
        example.drop_checkpoints(store)     # before the next run starts
        assert len(store) == 0 and not store.committed_ids()
        runs[share] = (stats, tuner)
    (s_stats, s_tuner), (t_stats, t_tuner) = runs[True], runs[False]
    assert s_stats.steps_run == 16 and t_stats.steps_run == 32
    assert s_tuner.history == t_tuner.history      # every metric, bit for bit
    assert s_tuner.best.trial_id == t_tuner.best.trial_id
    assert all(np.isfinite(m["loss"]) for m in s_tuner.history.values())


def test_make_backend_cuts_depth(monkeypatch):
    """``make_backend(layers=...)``: the model at that depth, every stacked
    leaf cut to it, drawn from the seed as ``LM(cut).init(0)`` draws it and
    counted by the cut configuration's ``param_count`` — the full-width
    study on the card runs at 32 of mamba2-2.7b's 64 layers."""
    monkeypatch.syspath_prepend(os.path.join(ROOT, "examples"))
    example = importlib.import_module("torch_hpo_lm")
    backend = example.make_backend(arch=ARCH, reduced=True, seq_len=32,
                                   n_train=8, n_eval=2, device="cpu",
                                   layers=3)
    cut = dataclasses.replace(CFG, num_layers=3)
    assert backend.task.cfg == cut
    p0 = backend.init_state()["params"]
    assert p0["cycles"][0]["ssm"]["in_x"].shape[0] == 3
    assert sum(t.numel() for t in tree_leaves(p0)) == cut.param_count()
    for a, b in zip(tree_leaves(p0), tree_leaves(LM(cut).init(0))):
        assert torch.equal(a, b)
