"""The training launcher of the PyTorch package and the step functions
under it, against the JAX package's.

* ``build_train_step`` against the reference's on qwen2-0.5b's reduced
  variant (f32), weights carried over by ``repro_torch/utils/convert.py``:
  three AdamW steps, every loss within 1e-5 and every parameter within
  1e-4 (the tolerance of ``tests/test_torch_lm.py``'s AdamW steps: Adam
  normalises a gradient that is float noise in both packages, so such an
  entry moves by up to lr a step either way).
* The launcher's ``main`` on the CPU (the reference's own launcher fails
  on this JAX, ``DuplicateSpecError``; the port's is held to its own
  counters and to the reference's step), its refusals, and ``serve_studies
  --devices-per-worker`` over the simulator line for line the JAX
  package's launcher.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.transformer import LM as JaxLM
from repro.train.optimizer import init_opt_state as jax_init_opt_state
from repro.train.step import build_prefill_step as jax_build_prefill_step
from repro.train.step import build_serve_step as jax_build_serve_step
from repro.train.step import build_train_step as jax_build_train_step
from repro_torch.configs import get_config
from repro_torch.kernels import ops as kops
from repro_torch.launch import train as launcher
from repro_torch.models.transformer import LM
from repro_torch.train.optimizer import init_opt_state
from repro_torch.train.step import (build_prefill_step, build_serve_step,
                                    build_train_step, place, shardings_for)
from repro_torch.utils.convert import tree_from_numpy, tree_to_numpy

# the suite runs several worker processes side by side: one intra-op
# thread each, or the workers fight over the cores
torch.set_num_threads(1)

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


def batches(n, batch=2, seq=32, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab_size, size=(batch, seq)).astype(
        np.int32) for _ in range(n)]


def test_train_step_equals_the_reference():
    jmodel = JaxLM(JCFG)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    jopt = jax_init_opt_state("adamw", jparams)
    jstep = jax.jit(jax_build_train_step(jmodel))
    params = tree_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    opt = init_opt_state("adamw", params)
    step = build_train_step(LM(CFG))
    for i, toks in enumerate(batches(3)):
        jparams, jopt, jloss = jstep(jparams, jopt,
                                     {"tokens": jnp.asarray(toks)},
                                     jnp.float32(3e-4), jnp.int32(i))
        params, opt, loss = step(params, opt,
                                 {"tokens": torch.from_numpy(
                                     toks.astype(np.int64))}, 3e-4, i)
        np.testing.assert_allclose(float(loss), float(jloss), atol=1e-5,
                                   rtol=0)
    got = flat(tree_to_numpy(params))
    ref = [np.asarray(x) for x in jax.tree.leaves(jparams)]
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)
    for a, b in zip(flat(tree_to_numpy(opt["v"])),
                    jax.tree.leaves(jopt["v"])):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-6, rtol=1e-3)


def test_prefill_step_equals_the_reference_and_serve_step_waits():
    """The prefill step's last-position logits, and (decode is ported now)
    three serve steps: the next tokens equal, the cache written in place
    and within 1e-4 of the reference's."""
    jmodel = JaxLM(JCFG)
    jparams = jmodel.init(jax.random.PRNGKey(1))
    params = tree_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    (toks,) = batches(1, seed=4)
    want = jax_build_prefill_step(jmodel)(jparams,
                                          {"tokens": jnp.asarray(toks)})
    got = build_prefill_step(LM(CFG))(
        params, {"tokens": torch.from_numpy(toks.astype(np.int64))})
    assert got.shape == (2, CFG.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    jcache, cache = jmodel.init_cache(2, 8), LM(CFG).init_cache(2, 8)
    jserve, serve = jax_build_serve_step(jmodel), build_serve_step(LM(CFG))
    jtok = jnp.asarray(toks[:, :1])
    tok = torch.from_numpy(toks[:, :1].astype(np.int64))
    for i in range(3):
        jtok, jcache = jserve(jparams, jcache, jtok, jnp.int32(i))
        nxt, out = serve(params, cache, tok, torch.tensor(i))
        assert out is cache
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(jtok))
        jtok, tok = jtok[:, None], nxt[:, None]
    for a, b in zip(flat(tree_to_numpy(cache)), jax.tree.leaves(jcache)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-4, rtol=0)


def test_shardings_place_whole_leaves_on_one_device():
    from repro_torch.dist.sharding import ShardingRules, param_specs
    tree = {"embed": torch.zeros(8, 4), "rest": [{"w": torch.ones(2)}]}
    specs = param_specs(tree, ShardingRules.for_mesh(False),
                        {"data": 1, "model": 1})
    devs = shardings_for([torch.device("cpu")], specs)
    assert devs == {"embed": torch.device("cpu"),
                    "rest": [{"w": torch.device("cpu")}]}
    assert place(tree, devs)["rest"][0]["w"].device.type == "cpu"
    # over several devices: the trainer's at-rest layout, the embedding
    # split over the data axis (its fsdp dimension), the rest whole
    from repro_torch.dist.sharding import Shards, join_leaf
    sizes = {"data": 2, "model": 1}
    specs = param_specs(tree, ShardingRules.for_mesh(False), sizes)
    with pytest.raises(ValueError, match="axes"):
        shardings_for([torch.device("cpu")] * 2, specs)
    wide = shardings_for([torch.device("cpu")] * 2, specs,
                         axes=tuple(sizes.items()))
    tree = {"embed": torch.arange(32.0).reshape(8, 4),
            "rest": [{"w": torch.ones(2)}]}
    placed = place(tree, wide)
    emb = placed["embed"]
    assert isinstance(emb, Shards) and emb.spec == ("model", "data")
    assert [p.shape for p in emb.pieces] == [(8, 2), (8, 2)]
    assert torch.equal(join_leaf(emb, torch.device("cpu")), tree["embed"])
    assert placed["rest"][0]["w"] is tree["rest"][0]["w"]


def test_launcher_trains_on_the_cpu(capsys):
    """``main`` on the CPU: the reference launcher's lines, finite
    losses, no kernel launch and no fallback (the kernels are off by default
    off the card); the first step's loss is the port's own step's on the
    launcher's seed-0 weights and first batch."""
    out = launcher.main(["--arch", ARCH, "--reduced", "--steps", "3",
                         "--batch", "4", "--seq", "32", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "training qwen2-0.5b-smoke" in text and "done: 3 steps" in text
    assert "tokens/s" in text and "kernel plane: 0 calls, 0 fallbacks" \
        in text
    assert out["launches"] == {f"B{i}": 0 for i in range(1, 7)}
    assert out["kernel_fallbacks"] == 0 and len(out["losses"]) == 3
    assert all(np.isfinite(out["losses"])) and out["tokens_per_s"] > 0
    assert out["device"] == "cpu"

    from repro_torch.data import DataPipeline, synthetic_lm_dataset
    cfg = get_config(ARCH).reduced(d_model=256)
    model = LM(cfg)
    data = DataPipeline(synthetic_lm_dataset(4096, 32, cfg.vocab_size), 4)
    toks = torch.from_numpy(data.next_batch()["tokens"].astype(np.int64))
    loss, _ = model.loss(model.init(0), {"tokens": toks})
    assert out["losses"][0] == float(loss)


def test_launcher_with_kernels_on_the_cpu_counts_fallbacks():
    """``--use-kernel`` off the card takes every kernel's plain version,
    each counted as a fallback (one update and one attention call per
    layer per step), never a launch."""
    kops.reset_kernel_stats()
    with pytest.warns(kops.KernelFallbackWarning):
        out = launcher.main(["--arch", ARCH, "--reduced", "--steps", "2",
                             "--batch", "2", "--seq", "16", "--device",
                             "cpu", "--use-kernel"])
    kops.reset_kernel_stats()
    cfg = get_config(ARCH).reduced(d_model=256)
    assert out["kernel_fallbacks"] == 2 * (1 + cfg.num_layers)
    assert out["launches"] == {f"B{i}": 0 for i in range(1, 7)}


def test_launcher_refusals():
    with pytest.raises(SystemExit):
        launcher.main(["--arch", "qwen2-vl-7b", "--reduced", "--steps", "1",
                       "--device", "cpu"])
    if not torch.cuda.is_available():
        # the default device is the card: no silent CPU run
        with pytest.raises(RuntimeError, match="--device cpu"):
            launcher.main(["--arch", ARCH, "--reduced", "--steps", "1"])
    mesh, devices = launcher.local_mesh(torch.device("cpu"))
    assert mesh.sizes == {"data": 1, "model": 1}
    assert devices == [torch.device("cpu")]


def test_serve_studies_devices_per_worker_equals_the_reference(capsys):
    """``--devices-per-worker`` over the simulator: every worker slot a
    2-device mesh, the launcher's lines (its mesh-plane line included)
    those of the JAX package's launcher, byte for byte."""
    from repro.launch import serve_studies as ref_launcher
    from repro_torch.launch import serve_studies

    argv = ["--studies", "3", "--workers", "4", "--steps", "120",
            "--arrival-gap", "1800", "--devices-per-worker", "2",
            "--mesh-host", "rack7"]
    archive = serve_studies.main(argv)
    out = capsys.readouterr().out
    assert "mesh plane:" in out and "served:" in out
    (key, stats), = archive
    assert stats.mesh_placements > 0
    old = sys.argv
    sys.argv = ["serve_studies"] + argv
    try:
        ref_launcher.main()
    finally:
        sys.argv = old
    assert capsys.readouterr().out == out
