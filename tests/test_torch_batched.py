"""Sibling groups in the PyTorch package: ``TorchTrainer``'s batched tiers
and the dispatcher's group pass, held against the port's solo run and
against the JAX package's groups.

Ports of ``tests/test_dataplane.py``, ``tests/test_chainfusion.py``,
``tests/test_kernel_plane.py`` and ``tests/test_lossless.py``'s group
cases, on the CPU:

* the looped tier (the CPU's default) gives every member the bits of its
  solo run, through ``run_stages_batched``, ``run_chains_batched`` and an
  engine run;
* the vectorised tier (the loss under ``vmap`` over the member-stacked
  carry, one ``autograd.grad``) is within ``rtol=1e-5, atol=1e-6`` of the
  looped tier, and its gradients as close to
  ``vmap(grad_and_value(loss))``'s and to each member's solo ones — a stacked matrix product or a grouped convolution sums in
  another order, so it is not bitwise — and raises no functorch
  fallback warning on ResNet56 and on the reduced qwen2 and mamba2;
* groups of the reduced qwen2-0.5b and mamba2-2.7b against
  ``JaxTrainer.run_stages_batched(vectorize_groups=True)`` on the same
  weights carried across, within the solo comparison's 1e-4;
* the group pass over the simulator reproduces the sequential engine, and
  ``max_steps_per_chain`` caps every batched call.
"""

import warnings

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as jax_get_config
from repro.core.trainer import StageContext as RefStageContext
from repro.data.pipeline import DataPipeline as RefDataPipeline
from repro.models.transformer import LM as JaxLM
from repro.train.jax_trainer import JaxTrainer
from repro_torch.configs import get_config
from repro_torch.core import (Constant, HpConfig, MultiStep, SearchPlanDB,
                              Study)
from repro_torch.core.trainer import SimulatedTrainer, StageContext
from repro_torch.core.trial import Trial
from repro_torch.core.tuners import GridTuner
from repro_torch.data import DataPipeline, synthetic_cifar, synthetic_lm_dataset
from repro_torch.kernels import ops as kops
from repro_torch.models.resnet import ResNet
from repro_torch.models.transformer import LM
from repro_torch.train.torch_trainer import (TorchTrainer, _stack,
                                             group_value_and_grad,
                                             value_and_grad)
from repro_torch.utils.convert import state_from_numpy, tree_to_numpy
from repro_torch.utils.tree import tree_leaves
from test_torch_trainer import StepwiseTrainer

# the suite runs several worker processes side by side: one intra-op
# thread each, or the workers fight over the cores
torch.set_num_threads(1)

VEC_TOL = dict(rtol=1e-5, atol=1e-6)


class TinyTask:
    """Linear softmax classifier (the reference tests' tiny task)."""

    def init(self, gen):
        return {"w": 0.1 * torch.randn((16, 4), generator=gen),
                "b": torch.zeros((4,))}

    def loss(self, params, batch):
        logits = batch["x"] @ params["w"] + params["b"]
        logp = F.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, 1, batch["y"][:, None]).mean()
        acc = (torch.argmax(logits, -1) == batch["y"]).float().mean()
        return nll, {"acc": acc}


def tiny_dataset(n=128, seed=0):
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(0, 1, (n, 16)).astype(np.float32),
            "y": rng.integers(0, 4, n).astype(np.int32)}


def tiny_backend(**kw):
    data = tiny_dataset()
    return TorchTrainer(TinyTask(), lambda: DataPipeline(data, batch_size=8,
                                                         seed=3),
                        tiny_dataset(seed=1), default_optimizer="momentum",
                        device="cpu", **kw)


def assert_states_identical(a, b):
    assert a["step"] == b["step"] and a["opt_name"] == b["opt_name"]
    assert tuple(a["data"]) == tuple(b["data"])
    for ta, tb in ((a["params"], b["params"]), (a["opt"], b["opt"])):
        la, lb = tree_leaves(ta), tree_leaves(tb)
        assert len(la) == len(lb) > 0
        for x, y in zip(la, lb):
            assert torch.equal(x, y)


def assert_states_close(a, b, **tol):
    assert a["step"] == b["step"] and tuple(a["data"]) == tuple(b["data"])
    for x, y in zip(tree_leaves((a["params"], a["opt"])),
                    tree_leaves((b["params"], b["opt"]))):
        torch.testing.assert_close(x, y, **tol)


def const_ctx(start, stop, lr=0.05, nid="n0", pk="pk"):
    return StageContext(nid, {"hps": {"lr": {"kind": "const", "value": lr}},
                              "static": {}}, 0, start, stop, pk)


def lr_ctxs(lrs=(0.1, 0.05, 0.02), stop=10):
    return [const_ctx(0, stop, v, nid=f"n{i}", pk=f"pk{i}")
            for i, v in enumerate(lrs)]


# ------------------------------------------------------------ trainer tiers


def test_batched_group_equals_solo_fused():
    """run_stages_batched over divergent-lr siblings (looped tier) ==
    member-by-member fused execution, bit for bit."""
    backend = tiny_backend()
    assert backend.vectorize_groups is False and backend.supports_batched_stages
    ctxs = lr_ctxs()
    states = [backend.init_state() for _ in ctxs]
    batched = backend.run_stages_batched(states, ctxs)
    for ctx, got in zip(ctxs, batched):
        assert_states_identical(got, backend.run_stage(backend.init_state(),
                                                       ctx))


def test_vectorised_group_matches_looped():
    """The vectorised tier (the CUDA default, forced here) against the
    looped one: within float tolerance, each chunk one vmapped step per
    step and no functorch fallback."""
    ctxs = lr_ctxs()
    loop, vec = tiny_backend(), tiny_backend(vectorize_groups=True)
    out_l = loop.run_stages_batched([loop.init_state() for _ in ctxs], ctxs)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out_v = vec.run_stages_batched([vec.init_state() for _ in ctxs], ctxs)
    for a, b in zip(out_v, out_l):
        assert_states_close(a, b, **VEC_TOL)
    assert vec.exec_calls == 2 and loop.exec_calls == 2 * len(ctxs)  # 8 + 2


def test_run_chains_batched_equals_member_sequential():
    fused = tiny_backend()
    chains = [[const_ctx(0, 9, 0.05 - 0.01 * i, nid=f"n{i}", pk=f"pk{i}"),
               const_ctx(9, 20, 0.05 - 0.01 * i, nid=f"n{i}", pk=f"pk{i}")]
              for i in range(3)]
    states = [fused.init_state() for _ in range(3)]
    outs = fused.run_chains_batched(states, chains)
    solo = tiny_backend()
    for st, ch, out in zip(states, chains, outs):
        ref = solo.run_chain(st, ch)
        assert len(out) == len(ref) == 2
        for x, y in zip(out, ref):
            assert_states_identical(x, y)


def test_vectorised_chains_persist_the_stack_across_boundaries():
    """run_chains_batched on the vectorised tier: per-member boundary
    copies at each level, within tolerance of the looped tier, and not
    views of the live stack."""
    chains = [[const_ctx(0, 6, 0.05 - 0.01 * i, nid=f"n{i}", pk=f"pk{i}"),
               const_ctx(6, 12, 0.02, nid=f"n{i}", pk=f"pk{i}")]
              for i in range(2)]
    vec, loop = tiny_backend(vectorize_groups=True), tiny_backend()
    out_v = vec.run_chains_batched([vec.init_state() for _ in chains],
                                   chains)
    out_l = loop.run_chains_batched([loop.init_state() for _ in chains],
                                    chains)
    for mv, ml in zip(out_v, out_l):
        for a, b in zip(mv, ml):
            assert_states_close(a, b, **VEC_TOL)
    w = out_v[0][0]["params"]["w"]
    assert w.untyped_storage().nbytes() == w.numel() * w.element_size()


def test_run_chains_batched_rejects_ragged_depth():
    fused = tiny_backend()
    chains = [[const_ctx(0, 8, 0.05, nid="n0", pk="p0"),
               const_ctx(8, 16, 0.05, nid="n0", pk="p0")],
              [const_ctx(0, 8, 0.04, nid="n1", pk="p1")]]
    with pytest.raises(ValueError, match="depth"):
        fused.run_chains_batched([fused.init_state(), fused.init_state()],
                                 chains)


def test_group_refuses_divergent_static_hps_and_batch_sizes():
    fused = tiny_backend()
    a = const_ctx(0, 4, 0.05, nid="a", pk="a")
    b = StageContext("b", {"hps": {"lr": {"kind": "const", "value": 0.05}},
                           "static": {"optimizer": "sgd"}}, 0, 0, 4, "b")
    s0 = fused.init_state()
    with pytest.raises(ValueError, match="static"):
        fused.run_stages_batched([s0, fused.init_state()], [a, b])
    s1 = dict(fused.init_state(), data=(3, 0, 0, 16))
    with pytest.raises(ValueError, match="batch size"):
        fused.run_stages_batched([s0, s1], [a, const_ctx(0, 4, 0.04, "c")])


def test_vmapped_sibling_group_bitwise_with_momentum():
    """Divergent per-member lrs ride the stacked update as (M,) vectors;
    the kernel path (on the CPU: the plain version, counted) and the plain
    path give the same bits."""
    ctxs = lr_ctxs([0.05 * (1 + 0.1 * i) for i in range(3)], stop=5)
    kern = tiny_backend(use_kernel=True, vectorize_groups=True)
    orac = tiny_backend(use_kernel=False, vectorize_groups=True)
    with pytest.warns(kops.KernelFallbackWarning):
        outs_k = kern.run_stages_batched([kern.init_state() for _ in ctxs],
                                         ctxs)
    outs_o = orac.run_stages_batched([orac.init_state() for _ in ctxs], ctxs)
    for a, b in zip(outs_k, outs_o):
        assert_states_identical(a, b)
    assert kern.kernel_fallbacks == 5 and kern.kernel_calls == 0  # 1 a step
    kops.reset_kernel_stats()


# ------------------------------------------------------------ engine runs


def test_batched_siblings_equal_stepwise_bitwise():
    """An engine run over ResNet8 siblings: the group reproduces each
    member's straight-through per-step training exactly (looped tier)."""
    data, ev = synthetic_cifar(256, seed=0), synthetic_cifar(64, seed=1)
    mk = lambda trainer: trainer(
        ResNet(n=1, width=8), lambda: DataPipeline(data, batch_size=32,
                                                   seed=3),
        ev, default_optimizer="momentum", device="cpu")
    fused, stepwise = mk(TorchTrainer), mk(StepwiseTrainer)
    trials = [Trial(HpConfig({"lr": MultiStep(0.05, [12], values=[0.05, v]),
                              "bs": Constant(32)}), 24)
              for v in (0.02, 0.01, 0.005)]
    db = SearchPlanDB()
    study = Study.create(db, "resnet8", "synth", ("lr", "bs"))
    # one worker: the prefix chain carries one sibling tail with it; the
    # other two meet as ready resume stages and batch as one group
    eng = study.engine(fused, n_workers=1)
    assert eng.batch_siblings                 # the backend's default
    stats = eng.run([GridTuner(list(trials))])
    assert stats.batched_groups >= 1 and stats.batched_stages >= 2
    plan = db.get(study.key)
    for t in trials:
        leaf = plan.nodes[plan.trial_paths[t.trial_id][-1]]
        state = stepwise.init_state()
        path = plan.path_to_root(leaf.node_id)
        for i, n in enumerate(path):
            stop = 24 if i == len(path) - 1 else path[i + 1].start
            state = stepwise.run_stage_stepwise(state, StageContext(
                n.node_id, n.desc, n.start, n.start, stop,
                plan.path_key(n.node_id)))
        assert leaf.metrics[24] == stepwise.evaluate(state, None)
        assert_states_identical(eng.store.get(leaf.ckpts[24]), state)


class BatchedChainSim(SimulatedTrainer):
    supports_batched_stages = True
    supports_chain_fusion = True


def seq_trial(lr0, lr1, steps=20, boundary=10):
    return Trial(HpConfig({"lr": MultiStep(lr0, [boundary],
                                           values=[lr0, lr1])}), steps)


def test_batched_chain_group_matches_sequential_engine():
    """Forced batched multi-stage chains on the simulator reproduce the
    sequential engine's metrics exactly."""
    def run(backend, batch, fusion):
        db = SearchPlanDB()
        study = Study.create(db, "m", "d", ("lr",))
        trials = [seq_trial(0.1 - 0.02 * i, 0.01 - 0.002 * i)
                  for i in range(3)]
        eng = study.engine(backend, n_workers=1, batch_siblings=batch,
                           chain_fusion=fusion)
        return db.get(study.key), eng.run([GridTuner(trials)])

    plan_b, stats_b = run(BatchedChainSim(), batch=True, fusion=True)
    plan_s, stats_s = run(SimulatedTrainer(), batch=False, fusion=False)
    assert stats_b.batched_groups >= 1
    assert stats_b.batched_stages >= 4         # >=2 members x depth 2
    assert stats_b.chain_fused_stages >= 4
    assert set(plan_b.nodes) == set(plan_s.nodes)
    for nid, node in plan_b.nodes.items():
        assert node.metrics == plan_s.nodes[nid].metrics


def test_chain_groups_respect_max_steps_per_chain():
    """No batched call exceeds the per-dispatch work cap; the cut levels
    reschedule in later rounds."""
    class Recording(BatchedChainSim):
        def __init__(self):
            super().__init__()
            self.dispatch_steps = []

        def run_chain(self, state, ctxs):
            self.dispatch_steps.append(sum(c.stop - c.start for c in ctxs))
            return super().run_chain(state, ctxs)

        def run_stages_batched(self, states, ctxs):
            self.dispatch_steps.extend(c.stop - c.start for c in ctxs)
            return super().run_stages_batched(states, ctxs)

        def run_chains_batched(self, states, chains):
            self.dispatch_steps.extend(
                sum(c.stop - c.start for c in ch) for ch in chains)
            return super().run_chains_batched(states, chains)

    backend = Recording()
    study = Study.create(SearchPlanDB(), "m", "d", ("lr",))
    trials = [seq_trial(0.1 - 0.02 * i, 0.01 - 0.002 * i) for i in range(3)]
    stats = study.engine(backend, n_workers=1, batch_siblings=True,
                         chain_fusion=True, max_steps_per_chain=10).run(
        [GridTuner(trials)])
    assert backend.dispatch_steps and max(backend.dispatch_steps) <= 10
    assert stats.steps_run == 60                   # everything still ran


def test_value_error_falls_back_to_member_sequential():
    """A group the backend refuses mid-flight runs member by member,
    counted as not batched, with the same results."""
    class Refusing(BatchedChainSim):
        def run_stages_batched(self, states, ctxs):
            raise ValueError("refused")

        run_chains_batched = run_stages_batched

    def run(backend, batch):
        db = SearchPlanDB()
        study = Study.create(db, "m", "d", ("lr",))
        trials = [seq_trial(0.1 - 0.02 * i, 0.01 - 0.002 * i)
                  for i in range(3)]
        stats = study.engine(backend, n_workers=1,
                             batch_siblings=batch).run([GridTuner(trials)])
        return db.get(study.key), stats

    plan_r, stats_r = run(Refusing(), True)
    plan_s, stats_s = run(BatchedChainSim(), False)
    assert stats_r.batched_groups == 0 and stats_r.steps_run == 60
    for nid, node in plan_r.nodes.items():
        assert node.metrics == plan_s.nodes[nid].metrics


# ------------------------------------------- no hidden loop, against JAX


def no_fallback_step(task, batch, M=2):
    """One vectorised group step of ``task`` (``group_value_and_grad``, the
    trainer's), with functorch's fallback warning on: no warning at all
    (the CPU kernel fallback aside); its loss and gradients within the
    vectorised tier's tolerance of ``vmap(grad_and_value(loss))``'s and of
    each member's solo ones."""
    gens = [torch.Generator().manual_seed(s) for s in range(M)]
    solo = [task.init(g) for g in gens]
    params = _stack(solo)
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            (loss, _), grads = group_value_and_grad(task.loss, params, batch,
                                                    None)
            ref, _ = torch.func.vmap(torch.func.grad_and_value(
                task.loss, has_aux=True), in_dims=(0, None))(params, batch)
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)
    assert [str(w.message) for w in caught
            if w.category is not kops.KernelFallbackWarning] == []
    assert tuple(loss.shape) == (M,) and bool(loss.isfinite().all())
    for a, b in zip(tree_leaves(grads), tree_leaves(ref)):
        assert a.shape[0] == M
        torch.testing.assert_close(a, b, **VEC_TOL)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", kops.KernelFallbackWarning)
        for m, p in enumerate(solo):
            (l_m, _), g_m = value_and_grad(task.loss, p, batch)
            torch.testing.assert_close(loss[m], l_m, **VEC_TOL)
            for a, b in zip(tree_leaves(grads), tree_leaves(g_m)):
                torch.testing.assert_close(a[m], b, **VEC_TOL)
    kops.reset_kernel_stats()


def test_resnet56_group_step_has_no_functorch_fallback():
    data = synthetic_cifar(2, seed=0)
    no_fallback_step(ResNet(n=9), {"images": torch.from_numpy(data["images"]),
                                   "labels": torch.from_numpy(
                                       data["labels"]).long()})


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-2.7b"])
def test_reduced_lm_group_step_has_no_functorch_fallback(arch):
    lm = LM(get_config(arch).reduced())
    lm.use_kernel = True
    toks = np.random.default_rng(0).integers(
        0, lm.cfg.vocab_size, (2, 64)).astype(np.int64)
    no_fallback_step(lm, {"tokens": torch.from_numpy(toks)})


def flat(tree):
    """Leaves in ``jax.tree.leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in flat(v)]
    return [tree]


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-2.7b"])
def test_reduced_lm_group_matches_jax_group(arch):
    """Two AdamW siblings of the reduced LM, one vectorised group of three
    steps through the kernel bindings, against ``JaxTrainer`` 's vmapped
    group (its kernels in interpret mode) on the same weights: within the
    solo comparison's 1e-4."""
    cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
    data = synthetic_lm_dataset(32, 64, cfg.vocab_size, seed=0)
    ev = synthetic_lm_dataset(2, 64, cfg.vocab_size, seed=5)
    ref = JaxTrainer(JaxLM(jcfg), lambda: RefDataPipeline(data, batch_size=2,
                                                          seed=3),
                     ev, default_optimizer="adamw", backend="cpu",
                     use_kernel=True, vectorize_groups=True)
    port = TorchTrainer(LM(cfg), lambda: DataPipeline(data, batch_size=2,
                                                      seed=3),
                        ev, default_optimizer="adamw", device="cpu",
                        use_kernel=True, vectorize_groups=True)
    ctxs = [StageContext(f"n{i}", {"hps": {"lr": {"kind": "const",
                                                  "value": lr}},
                                   "static": {}}, 0, 0, 3, f"pk{i}")
            for i, lr in enumerate((3e-4, 1e-4))]
    j0 = ref.init_state()
    t0 = state_from_numpy({**j0, "params": jax.tree.map(np.asarray,
                                                        j0["params"])}, "cpu")
    jout = ref.run_stages_batched([j0, j0], [RefStageContext(
        c.node_id, c.desc, c.node_start, c.start, c.stop, c.path_key)
        for c in ctxs])
    kops.reset_kernel_stats()
    with pytest.warns(kops.KernelFallbackWarning):
        tout = port.run_stages_batched([t0, port.clone_state(t0)], ctxs)
    # per group step: one update and one kernel call per layer
    assert port.kernel_fallbacks == 3 * (1 + cfg.num_layers)
    kops.reset_kernel_stats()
    init = flat(jax.tree.map(np.asarray, j0["params"]))
    for js, ts in zip(jout, tout):
        assert ts["step"] == js["step"] == 3
        assert tuple(ts["data"]) == tuple(js["data"])
        moved = 0.0
        for a, b, p0 in zip(flat(tree_to_numpy(ts["params"])),
                            jax.tree.leaves(js["params"]), init):
            np.testing.assert_allclose(a, np.asarray(b), atol=1e-4, rtol=0)
            moved = max(moved, float(np.abs(np.asarray(b) - p0).max()))
        assert moved > 5e-5
    # the members diverged: their lrs differ
    assert not torch.equal(tree_leaves(tout[0]["params"])[0],
                           tree_leaves(tout[1]["params"])[0])
