"""The RG-LRU block and recurrentgemma of the PyTorch package held against
the JAX package.

On the CPU, with numpy-seeded inputs fed to both packages and
JAX-initialised weights carried across leaf for leaf
(``repro_torch/utils/convert.py``):

* ``rglru_forward`` and ``rglru_decode`` against the reference's, f32
  within 1e-5 · max(1, |ref|) and bf16 within 2e-2 · max(1, |ref|) (the
  recurrence runs in f32 in both; bf16 rounds the projections and the
  output);
* the log-depth scan against ``jax.lax.associative_scan`` at S 4096 and a
  narrow width, within 1e-5 relative: the two sum in different tree
  orders, and the port's order is the same on every call (bit-equal
  twice);
* decode after decode against the port's own forward (5e-5), the cache
  written in place (the buffers ``init_rglru_cache`` made);
* recurrentgemma-2b reduced at 5 layers (one (rglru, rglru, local) cycle
  plus the two trailing RG-LRU layers, as the full model's 26 = 8 × 3 + 2):
  the tree key for key, ``param_count`` exact, loss (1e-5) and every
  gradient (1e-4) against JAX on the plain and the kernel path, three
  AdamW steps of ``TorchTrainer`` against ``JaxTrainer`` (1e-4), and
  ``LM.decode_step`` against the reference's decode and the port's
  forward.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.trainer import StageContext as RefStageContext
from repro.data.pipeline import DataPipeline as RefDataPipeline
from repro.models import rglru as jax_rglru
from repro.models.transformer import LM as JaxLM
from repro.train.jax_trainer import JaxTrainer
from repro_torch.configs import get_config
from repro_torch.core import Constant, HpConfig
from repro_torch.core.searchplan import SearchPlan
from repro_torch.core.trainer import StageContext
from repro_torch.core.trial import Trial
from repro_torch.data import DataPipeline, synthetic_lm_dataset
from repro_torch.kernels import ops as kops
from repro_torch.models import rglru
from repro_torch.models.transformer import LM
from repro_torch.train.torch_trainer import TorchTrainer, value_and_grad
from repro_torch.utils.convert import (state_from_numpy, tree_from_numpy,
                                       tree_to_numpy)
from repro_torch.utils.tree import tree_leaves

# the suite runs several worker processes side by side: one intra-op
# thread each, or the workers fight over the cores
torch.set_num_threads(1)

ARCH = "recurrentgemma-2b"
LAYERS = 5                  # one cycle + the two trailing RG-LRU layers
CFG = get_config(ARCH).reduced(num_layers=LAYERS)
JCFG = jax_get_config(ARCH).reduced(num_layers=LAYERS)
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def flat(tree):
    """Leaves in ``jax.tree.leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in flat(v)]
    return [tree]


def assert_close(got, ref, tol):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref) / np.maximum(1.0, np.abs(ref))
    assert float(err.max(initial=0.0)) <= tol, float(err.max())


def block_params(dtype, seed=0):
    """One RG-LRU block's weights from the JAX init (bf16 where the model
    is), the gates moved off their constant init."""
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    p = jax_rglru.init_rglru(JCFG, jax.random.PRNGKey(seed), jdt)
    rng = np.random.default_rng(seed + 50)
    p["g_r"] = p["g_r"] + jnp.asarray(0.3 * rng.normal(size=p["g_r"].shape),
                                      jnp.float32)
    return p, tree_from_numpy(jax.tree.map(np.asarray, p), "cpu")


def to_torch(x, dtype):
    return torch.tensor(np.asarray(x, np.float32)).to(
        torch.bfloat16 if dtype == "bfloat16" else torch.float32)


def to_jax(x, dtype):
    return jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16"
                       else jnp.float32)


# ---------------------------------------------------------------- the block
def test_init_tree_matches_jax():
    """Same keys, shapes and dtypes (``lam`` / ``g_r`` f32 in a bf16
    block); ``σ(Λ)`` in (0.9, 0.999), as the reference draws it."""
    for dtype in (torch.float32, torch.bfloat16):
        mine = rglru.init_rglru(CFG, torch.Generator().manual_seed(0), dtype)
        ref = jax_rglru.init_rglru(JCFG, jax.random.PRNGKey(0),
                                   jnp.bfloat16 if dtype == torch.bfloat16
                                   else jnp.float32)
        assert sorted(mine) == sorted(ref)
        for k in ref:
            assert tuple(mine[k].shape) == ref[k].shape, k
            assert str(mine[k].dtype).split(".")[-1] == str(ref[k].dtype), k
        a = torch.sigmoid(mine["lam"])
        assert float(a.min()) > 0.9 - 1e-6 and float(a.max()) < 0.999 + 1e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(dtype):
    jp, tp = block_params(dtype)
    x = np.random.default_rng(1).normal(size=(2, 37, CFG.d_model))
    got = rglru.rglru_forward(tp, CFG, to_torch(x, dtype))
    want = jax_rglru.rglru_forward(jp, JCFG, to_jax(x, dtype))
    assert got.dtype == to_torch(x[:0], dtype).dtype
    assert_close(got.float().numpy(), np.asarray(want, np.float32),
                 TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_matches_jax(dtype):
    """Step by step from the zero cache: each output and the cache (``h``
    f32, the conv's left context in the model's dtype) after each step."""
    jp, tp = block_params(dtype, seed=2)
    tdt = to_torch(np.zeros(()), dtype).dtype
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    cache = rglru.init_rglru_cache(CFG, 3, tdt)
    jcache = jax_rglru.init_rglru_cache(JCFG, 3, jdt)
    assert [tuple(a.shape) for a in flat(cache)] == \
        [b.shape for b in jax.tree.leaves(jcache)]
    assert cache["h"].dtype == torch.float32 and cache["conv"].dtype == tdt
    xs = np.random.default_rng(3).normal(size=(3, 6, CFG.d_model))
    for t in range(6):
        out, same = rglru.rglru_decode(tp, CFG, to_torch(xs[:, t:t + 1],
                                                         dtype), cache)
        jout, jcache = jax_rglru.rglru_decode(jp, JCFG,
                                              to_jax(xs[:, t:t + 1], dtype),
                                              jcache)
        assert same is cache
        assert_close(out.float().numpy(), np.asarray(jout, np.float32),
                     TOL[dtype])
        for a, b in zip(flat(cache), jax.tree.leaves(jcache)):
            assert_close(a.float().numpy(), np.asarray(b, np.float32),
                         TOL[dtype])


def test_scan_matches_associative_scan_at_4096():
    """The log-depth scan against ``jax.lax.associative_scan`` at the
    study's sequence length, a narrow width, the model's decays; the
    port's own order twice bit-equal."""
    rng = np.random.default_rng(4)
    S, W = 4096, 8
    a = rng.uniform(0.85, 0.9999, size=(2, S, W)).astype(np.float32)
    b = rng.normal(size=(2, S, W)).astype(np.float32)
    got = rglru.linear_scan(torch.tensor(a), torch.tensor(b))
    again = rglru.linear_scan(torch.tensor(a), torch.tensor(b))
    want = jax_rglru._linear_scan(jnp.asarray(a), jnp.asarray(b))
    assert torch.equal(got, again)
    want = np.asarray(want)
    err = np.abs(got.numpy() - want) / np.maximum(1.0, np.abs(want))
    assert float(err.max()) <= 1e-5, float(err.max())
    # the first steps, by the recurrence itself
    h = np.zeros((2, W), np.float64)
    for t in range(64):
        h = a[:, t] * h + b[:, t]
        np.testing.assert_allclose(got[:, t].numpy(), h, rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("S", [1, 2, 3, 5, 8, 33])
def test_scan_short_and_ragged_lengths(S):
    """Every length, power of two or not, against the sequential loop."""
    rng = np.random.default_rng(S)
    a = rng.uniform(0.5, 1.0, size=(1, S, 3))
    b = rng.normal(size=(1, S, 3))
    got = rglru.linear_scan(torch.tensor(a), torch.tensor(b)).numpy()
    h, want = np.zeros((1, 3)), []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    np.testing.assert_allclose(got, np.stack(want, 1), rtol=1e-12,
                               atol=1e-12)


def test_decode_after_decode_matches_forward_and_writes_in_place():
    _, tp = block_params("float32", seed=5)
    x = torch.tensor(np.random.default_rng(6).normal(
        size=(2, 24, CFG.d_model)).astype(np.float32))
    full = rglru.rglru_forward(tp, CFG, x)
    cache = rglru.init_rglru_cache(CFG, 2, torch.float32)
    buffers = (cache["h"], cache["conv"])
    outs = []
    for t in range(24):
        out, same = rglru.rglru_decode(tp, CFG, x[:, t:t + 1], cache)
        assert same is cache
        outs.append(out[:, 0])
    assert cache["h"] is buffers[0] and cache["conv"] is buffers[1]
    assert float(cache["h"].abs().max()) > 0
    # the conv's left context is the last K - 1 inputs of the branch
    u = x[:, -(CFG.ssm_conv - 1):] @ tp["w_in"]
    assert torch.allclose(cache["conv"], u, atol=1e-6)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               atol=5e-5, rtol=0)


# ------------------------------------------------------------------ the model
def jax_params(seed=0):
    params = JaxLM(JCFG).init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 100)
    return jax.tree.map(
        lambda x: x + jnp.asarray(0.02 * rng.normal(size=x.shape), x.dtype),
        params)


def test_tree_and_param_count_match_jax():
    """The 5-layer tree key for key, shape for shape, dtype for dtype (a
    bf16 variant too: ``lam`` / ``g_r`` stay f32), ``param_count`` exact;
    the full configuration's count at 5 of 26 layers."""
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
        assert sum(x.numel() for x in tree_leaves(mine)) == \
            cfg.param_count() == jcfg.param_count()
    m = LM(CFG)
    assert (m.pattern, m.n_full, m.rest_kinds) == (
        ("rglru", "rglru", "local"), 1, ("rglru", "rglru"))
    full = dataclasses.replace(get_config(ARCH), num_layers=LAYERS)
    assert full.param_count() == 1_043_422_720


@pytest.mark.parametrize("use_kernel", [False, True])
def test_loss_and_grads_match_jax(use_kernel):
    jparams = jax_params()
    batch = np.random.default_rng(1).integers(
        0, CFG.vocab_size, size=(2, 80)).astype(np.int32)
    ref = JaxLM(JCFG, use_kernel=use_kernel)
    (jloss, _), jgrads = jax.value_and_grad(ref.loss, has_aux=True)(
        jparams, {"tokens": jnp.asarray(batch)})
    tparams = tree_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    kops.reset_kernel_stats()
    with (pytest.warns(kops.KernelFallbackWarning) if use_kernel
          else contextlib.nullcontext()):
        (tloss, _), tgrads = value_and_grad(
            LM(CFG, use_kernel=use_kernel).loss, tparams,
            {"tokens": torch.tensor(batch).long()})
    # one attention call (the local layer) per forward on the kernel path
    assert kops.KERNEL_STATS.fallbacks == (1 if use_kernel else 0)
    kops.reset_kernel_stats()
    np.testing.assert_allclose(float(tloss), float(jloss), atol=1e-5)
    jl = [np.asarray(x) for x in jax.tree.leaves(jgrads)]
    tl = flat(tree_to_numpy(tgrads))
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)
    assert all(g.is_contiguous() for g in tree_leaves(tgrads))


def test_three_adamw_steps_match_jax_trainer():
    data = synthetic_lm_dataset(16, 64, CFG.vocab_size, seed=0)
    eval_data = synthetic_lm_dataset(2, 64, CFG.vocab_size, seed=5)
    ref = JaxTrainer(JaxLM(JCFG),
                     lambda: RefDataPipeline(data, batch_size=2, seed=3),
                     eval_data, default_optimizer="adamw", backend="cpu",
                     use_kernel=True)
    port = TorchTrainer(LM(CFG), lambda: DataPipeline(data, batch_size=2,
                                                      seed=3),
                        eval_data, default_optimizer="adamw", device="cpu",
                        use_kernel=True)
    trial = Trial(HpConfig({"lr": Constant(3e-4), "bs": Constant(2)}), 3)
    plan = SearchPlan("solo-" + trial.trial_id)
    node, _, _ = plan.submit(trial, 3)
    ctx = StageContext(node.node_id, node.desc, 0, 0, 3,
                       plan.path_key(node.node_id))
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
    # per step: one update and the local layer's attention, all plain
    assert port.kernel_fallbacks == 3 * (1 + 1)
    kops.reset_kernel_stats()
    assert tstate["step"] == jstate["step"] == 3
    jl = [np.asarray(x) for x in jax.tree.leaves(jstate["params"])]
    tl = flat(tree_to_numpy(tstate["params"]))
    init = flat(jax.tree.map(np.asarray, ref.init_state()["params"]))
    moved = 0.0
    for a, b, p0 in zip(tl, jl, init):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)
        moved = max(moved, float(np.abs(b - p0).max()))
    assert moved > 5e-4


def test_lm_decode_matches_jax_and_own_forward():
    """``LM.decode_step`` over 24 tokens: logits and the whole cache tree
    (stacked RG-LRU states and the local layer's KV ring) against the
    reference's decode within 1e-4 · max(1, |ref|), the buffers
    ``init_cache`` made written in place; the decode against the port's
    forward within 5e-3 (``tests/test_models.py``'s tolerance)."""
    jparams = jax_params(3)
    params = tree_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    jm, m = JaxLM(JCFG), LM(CFG)
    toks = np.random.default_rng(8).integers(0, CFG.vocab_size,
                                             size=(2, 24)).astype(np.int32)
    jcache, cache = jm.init_cache(2, 32), m.init_cache(2, 32)
    buffers = flat(cache)
    outs = []
    with torch.no_grad():
        for i in range(24):
            jl, jcache = jm.decode_step(jparams, jcache,
                                        jnp.asarray(toks[:, i:i + 1]),
                                        jnp.int32(i))
            got, same = m.decode_step(params, cache,
                                      torch.tensor(toks[:, i:i + 1]).long(),
                                      i)
            assert same is cache
            assert_close(got.numpy(), np.asarray(jl), 1e-4)
            outs.append(got[:, 0])
        full, _ = m.forward(params, {"tokens": torch.tensor(toks).long()})
    assert all(a is b for a, b in zip(flat(cache), buffers))
    for a, b in zip(flat(cache), jax.tree.leaves(jcache)):
        assert_close(a.numpy(), np.asarray(b), 1e-4)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               atol=5e-3, rtol=0)
