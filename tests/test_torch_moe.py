"""Mixture-of-Experts in the PyTorch package held against the JAX package.

On the CPU, f32, with numpy-seeded inputs fed to both packages and
JAX-initialised weights carried across leaf for leaf; every comparison
within 1e-4·max(1, |ref|) unless a case states otherwise:

* ``init_moe``: the reference's keys, shapes and dtypes (``router`` f32 in
  a bf16 tree), and the full configs' parameter counts;
* ``moe_forward`` and its aux loss, and their gradients against
  ``jax.grad``: qwen2-moe's shared experts drop-free, overflow drops at a
  small capacity factor, two dispatch groups (T = 8,192) and grok's
  routed-only layer;
* ``LM.loss`` with the router term ``router_aux_weight · moe_aux /
  num_layers``, its metrics and gradients, for qwen2-moe and grok;
* three AdamW steps of ``TorchTrainer(device="cpu")`` against
  ``JaxTrainer`` on the reduced qwen2-moe-a2.7b (the plain paths: the
  kernel bindings' chain is ``tests/test_torch_lm.py``'s), and the
  evaluation's ``nll`` / ``moe_aux`` passed through as the JAX trainer
  passes them;
* the vectorised group tier (the loss under ``vmap``) against the looped
  one, with functorch's fallback warning on and none raised (the one-hots
  are ``arange`` comparisons, not ``F.one_hot``);
* the port's own MoE study, stage-based against trial-based, bit for bit.
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
from repro.models import ffn as jax_ffn
from repro.models.transformer import LM as JaxLM
from repro.train.jax_trainer import JaxTrainer
from repro_torch.configs import get_config
from repro_torch.core import Constant, HpConfig
from repro_torch.core.searchplan import SearchPlan
from repro_torch.core.trainer import StageContext
from repro_torch.core.trial import Trial
from repro_torch.data import DataPipeline, synthetic_lm_dataset
from repro_torch.models import ffn
from repro_torch.models.transformer import LM
from repro_torch.train.torch_trainer import TorchTrainer, value_and_grad
from repro_torch.utils.convert import (state_from_numpy, tree_from_numpy,
                                       tree_to_numpy)
from repro_torch.utils.tree import tree_leaves

# the suite runs several worker processes side by side: one intra-op
# thread each, or the workers fight over the cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4            # across frameworks, relative to max(1, |ref|)
ARCH = "qwen2-moe-a2.7b"
CFG = get_config(ARCH).reduced()
JCFG = jax_get_config(ARCH).reduced()


def flat(tree):
    """Leaves in ``jax.tree.leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in flat(v)]
    return [tree]


def assert_close(got, ref, tol=TOL):
    """``|got − ref| ≤ tol · max(1, |ref|)``, ``|ref|`` the tensor's
    largest magnitude: an expert's output is a sum of thousands of terms
    of up to ~10³ (the reference's init scales ``wi`` / ``wg`` / ``wo`` by
    E^-½), so an element near 0 carries the rounding of its neighbours."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max(initial=0.0) / max(
        1.0, float(np.abs(ref).max(initial=0.0)))
    assert err <= tol, err


def pair(arch, **kw):
    """The reduced config of ``arch`` in both packages, with ``kw``."""
    d_model = kw.pop("d_model", 256)
    return (dataclasses.replace(jax_get_config(arch).reduced(
                d_model=d_model), **kw),
            dataclasses.replace(get_config(arch).reduced(d_model=d_model),
                                **kw))


# ------------------------------------------------------------------- init
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "grok-1-314b"])
def test_init_moe_tree_matches_jax(arch):
    for dtype, jd, td in (("float32", jnp.float32, torch.float32),
                          ("bfloat16", jnp.bfloat16, torch.bfloat16)):
        jcfg, cfg = pair(arch, dtype=dtype)
        want = jax.eval_shape(lambda: jax_ffn.init_moe(
            jcfg, jax.random.PRNGKey(0), jd))
        got = ffn.init_moe(cfg, torch.Generator().manual_seed(0), td)
        assert jax.tree.structure(want) == jax.tree.structure(
            jax.tree.map(lambda _: 0, tree_to_numpy(got)))
        for a, b in zip(flat(got), jax.tree.leaves(want)):
            assert tuple(a.shape) == b.shape
            assert str(a.dtype).split(".")[-1] == str(b.dtype)
        assert got["router"].dtype == torch.float32
        assert ("shared" in got) == bool(cfg.n_shared_experts)
    full, jfull = get_config(arch), jax_get_config(arch)
    assert full.param_count() == jfull.param_count()
    assert full.active_param_count() == jfull.active_param_count()


# ------------------------------------------------------------ moe_forward
MOE_CASES = {
    # name: (arch, config changes, batch, seq)
    "shared_drop_free": ("qwen2-moe-a2.7b", dict(capacity_factor=16.0), 2,
                         32),
    "overflow_drops": ("qwen2-moe-a2.7b", dict(capacity_factor=0.5), 2, 64),
    "two_groups": ("qwen2-moe-a2.7b", dict(capacity_factor=0.25,
                                           d_model=64), 2, 4096),
    "grok_no_shared": ("grok-1-314b", dict(capacity_factor=1.25), 2, 48),
}


def routed_dropped(cfg, params, x):
    """How many (token, k) choices overflow their expert's capacity."""
    B, S, D = x.shape
    T = B * S
    G = T // ffn._GROUP_TOKENS if T % ffn._GROUP_TOKENS == 0 else 1
    probs = torch.softmax(x.reshape(G, T // G, D) @ params["router"], -1)
    idx = torch.topk(probs, cfg.top_k, dim=-1)[1]
    cap = int(max(cfg.top_k, cfg.capacity_factor * (T // G) * cfg.top_k /
                  cfg.n_experts))
    counts = torch.stack([torch.bincount(idx[g].reshape(-1),
                                         minlength=cfg.n_experts)
                          for g in range(G)])
    return G, int((counts - cap).clamp(min=0).sum())


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_forward_aux_and_grads_match_jax(case):
    arch, kw, B, S = MOE_CASES[case]
    jcfg, cfg = pair(arch, **kw)
    jp = jax_ffn.init_moe(jcfg, jax.random.PRNGKey(1), jnp.float32)
    tp = tree_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(2)
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    w = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)

    groups, dropped = routed_dropped(cfg, tp, torch.tensor(x))
    assert groups == (2 if case == "two_groups" else 1)
    assert (dropped > 0) == (case in ("overflow_drops", "two_groups"))

    def jfn(p, x):
        out, aux = jax_ffn.moe_forward(p, jcfg, x)
        return jnp.sum(out * w) + 3.0 * aux, (out, aux)

    (jl, (jout, jaux)), (jgp, jgx) = jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    leaves = [p.requires_grad_(True) for p in tree_leaves(tp)]
    out, aux = ffn.moe_forward(tp, cfg, tx)
    loss = torch.sum(out * torch.tensor(w)) + 3.0 * aux
    grads = torch.autograd.grad(loss, leaves + [tx])
    assert aux.dtype == torch.float32 and aux.shape == ()
    assert_close(out.detach().numpy(), jout)
    assert_close(float(aux.detach()), float(jaux))
    assert_close(float(loss.detach()), float(jl))
    assert_close(grads[-1].numpy(), jgx)
    for a, b in zip(grads, jax.tree.leaves(jgp)):
        assert_close(a.numpy(), b)


# --------------------------------------------------------------- LM.loss
def jax_params(jcfg, seed=0):
    params = JaxLM(jcfg).init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 100)
    return jax.tree.map(
        lambda x: x + jnp.asarray(0.02 * rng.normal(size=x.shape), x.dtype),
        params)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "grok-1-314b"])
def test_lm_loss_with_router_term_matches_jax(arch):
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jparams = jax_params(jcfg)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                             size=(2, 48)).astype(np.int32)
    (jloss, jaux), jgrads = jax.value_and_grad(JaxLM(jcfg).loss,
                                               has_aux=True)(
        jparams, {"tokens": jnp.asarray(toks)})
    tparams = tree_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    (loss, aux), grads = value_and_grad(
        LM(cfg).loss, tparams, {"tokens": torch.from_numpy(toks).long()})
    assert sorted(aux) == sorted(jaux) == ["moe_aux", "nll"]
    for k in aux:
        assert_close(float(aux[k]), float(jaux[k]))
    assert_close(float(loss), float(jloss))
    # the router term, as the reference adds it
    router = cfg.router_aux_weight * float(aux["moe_aux"]) / cfg.num_layers
    assert float(aux["moe_aux"]) > 0
    np.testing.assert_allclose(float(loss), float(aux["nll"]) + router,
                               rtol=1e-6)
    jl = jax.tree.leaves(jgrads)
    tl = flat(tree_to_numpy(grads))
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl):
        assert_close(a, np.asarray(b))


# ------------------------------------------------------ trainer against JAX
def trial_stages(trial, steps):
    plan = SearchPlan("solo-" + trial.trial_id)
    node, _, _ = plan.submit(trial, steps)
    path = plan.path_to_root(node.node_id)
    return [StageContext(n.node_id, n.desc, n.start, n.start,
                         steps if i == len(path) - 1 else path[i + 1].start,
                         plan.path_key(n.node_id))
            for i, n in enumerate(path)]


def test_three_adamw_moe_steps_match_jax_trainer():
    data = synthetic_lm_dataset(32, 64, CFG.vocab_size, seed=0)
    eval_data = synthetic_lm_dataset(2, 64, CFG.vocab_size, seed=5)
    ref = JaxTrainer(JaxLM(JCFG),
                     lambda: RefDataPipeline(data, batch_size=2, seed=3),
                     eval_data, default_optimizer="adamw", backend="cpu",
                     use_kernel=False)
    port = TorchTrainer(LM(CFG), lambda: DataPipeline(data, batch_size=2,
                                                      seed=3),
                        eval_data, default_optimizer="adamw", device="cpu",
                        use_kernel=False)
    # Adam normalises each step, so a gradient element that is float noise
    # in both packages moves by up to lr a step either way (ROADMAP queue C
    # item 11): at 3e-4, one element of ``wq`` / ``wk``, behind experts
    # whose outputs reach ~10³, ends 1.9e-4 apart; at 1e-4, within 1e-4
    trial = Trial(HpConfig({"lr": Constant(1e-4), "bs": Constant(2)}), 3)
    (ctx,) = trial_stages(trial, 3)
    jstate = ref.init_state()
    tstate = state_from_numpy(
        {**jstate, "params": jax.tree.map(np.asarray, jstate["params"])},
        "cpu")
    rctx = RefStageContext(ctx.node_id, ctx.desc, ctx.node_start, ctx.start,
                           ctx.stop, ctx.path_key)
    jstate = ref.run_stage(jstate, rctx)
    tstate = port.run_stage(tstate, ctx)
    tmetrics = port.evaluate(tstate, ctx)
    assert port.kernel_calls == port.kernel_fallbacks == 0
    assert tstate["step"] == jstate["step"] == 3
    assert tstate["data"] == tuple(jstate["data"])
    jmetrics = ref.evaluate(jstate, rctx)
    assert sorted(tmetrics) == sorted(jmetrics) == \
        ["loss", "moe_aux", "nll", "val_acc"]
    for k in jmetrics:
        assert_close(tmetrics[k], jmetrics[k])
    init = flat(jax.tree.map(np.asarray, ref.init_state()["params"]))
    moved = 0.0
    for a, b, p0 in zip(flat(tree_to_numpy(tstate["params"])),
                        jax.tree.leaves(jstate["params"]), init):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)
        moved = max(moved, float(np.abs(b - p0).max()))
        moved = max(moved, float(np.abs(b - p0).max()))
    assert moved > 2e-4                 # training did move the weights


# ------------------------------------------------------------ group tiers
def test_vectorised_moe_group_matches_looped_without_fallback():
    """Two AdamW siblings of the reduced qwen2-moe-a2.7b, three steps: the
    vectorised tier within the group tests' ``rtol=1e-5, atol=1e-6`` of
    the looped tier (bit-equal to solo), and functorch's fallback warning,
    switched on, never raised (no hidden per-member loop)."""
    data = synthetic_lm_dataset(16, 32, CFG.vocab_size, seed=0)
    ev = synthetic_lm_dataset(2, 32, CFG.vocab_size, seed=5)

    def backend(vectorize):
        return TorchTrainer(LM(CFG), lambda: DataPipeline(data, batch_size=2,
                                                          seed=3),
                            ev, default_optimizer="adamw", device="cpu",
                            vectorize_groups=vectorize)

    ctxs = [StageContext(f"n{i}", {"hps": {"lr": {"kind": "const",
                                                  "value": lr}},
                                   "static": {}}, 0, 0, 3, f"pk{i}")
            for i, lr in enumerate((3e-4, 1e-4))]
    loop, vec = backend(False), backend(True)
    out_l = loop.run_stages_batched([loop.init_state() for _ in ctxs], ctxs)
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            out_v = vec.run_stages_batched([vec.init_state() for _ in ctxs],
                                           ctxs)
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)
    assert vec.exec_calls < loop.exec_calls
    for a, b, ctx in zip(out_v, out_l, ctxs):
        solo = loop.run_stage(loop.init_state(), ctx)
        for x, y, z in zip(tree_leaves((a["params"], a["opt"])),
                           tree_leaves((b["params"], b["opt"])),
                           tree_leaves((solo["params"], solo["opt"]))):
            torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6)
            assert torch.equal(y, z)


# ------------------------------------------------- stage vs trial, in port
def test_moe_study_stage_based_equals_trial_based_bitwise(monkeypatch):
    monkeypatch.syspath_prepend(os.path.join(ROOT, "examples"))
    example = importlib.import_module("torch_hpo_lm")
    runs = {}
    backend = example.make_backend(arch=ARCH, reduced=True, seq_len=32,
                                   n_train=64, n_eval=4, device="cpu")
    for share in (True, False):
        stats, tuner, store, _ = example.run_study(backend, share, name=ARCH)
        example.drop_checkpoints(store)
        assert tuner.is_done() and stats.kernel_fallbacks == 0
        runs[share] = (stats, tuner)
    (s_stats, s_tuner), (t_stats, t_tuner) = runs[True], runs[False]
    assert s_stats.steps_run == 16 and t_stats.steps_run == 32
    assert s_tuner.history == t_tuner.history      # every metric, bit for bit
    assert s_tuner.best.trial_id == t_tuner.best.trial_id
    for m in s_tuner.history.values():
        assert np.isfinite(m["loss"]) and m["moe_aux"] > 0
