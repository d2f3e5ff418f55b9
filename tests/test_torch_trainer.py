"""``TorchTrainer`` — lossless within the port, close to ``JaxTrainer``.

Within the PyTorch package, on the CPU, bit for bit (ports of
``tests/test_lossless.py``): whole-stage fused execution == the per-step
loop, a depth-4 fused chain == per-stage execution, and forking a shared
prefix's checkpoint == training every trial straight through.  Against
``JaxTrainer``: the same initial weights and the same data stream give
parameters within atol 1e-4 after 6 steps (f32 convolution sums in another
order, amplified over steps).
"""

import warnings

import jax
import numpy as np
import pytest
import torch

from repro.core.trainer import StageContext as RefStageContext
from repro.data.pipeline import DataPipeline as RefDataPipeline
from repro.models.resnet import ResNet as JaxResNet
from repro.train.jax_trainer import JaxTrainer
from repro_torch.core import (Constant, HpConfig, MultiStep, SearchPlanDB,
                              Study)
from repro_torch.core.searchplan import SearchPlan
from repro_torch.core.trainer import StageContext, TrainerBackend
from repro_torch.core.trial import Trial
from repro_torch.core.tuners import GridTuner
from repro_torch.data import DataPipeline, synthetic_cifar
from repro_torch.kernels import ops as kops
from repro_torch.kernels.optim import stacked_leaf_update, stacked_tree_update
from repro_torch.models.resnet import ResNet
from repro_torch.train.torch_trainer import TorchTrainer, chunk_lengths
from repro_torch.utils.convert import state_from_numpy, tree_to_numpy
from repro_torch.utils.tree import tree_leaves

# the suite runs several worker processes side by side: one intra-op
# thread each, or the workers fight over the cores
torch.set_num_threads(1)

DATA = synthetic_cifar(256, seed=0)
EVAL = synthetic_cifar(128, seed=1)


def pipe():
    return DataPipeline(DATA, batch_size=32, seed=3)


class StepwiseTrainer(TorchTrainer):
    """The per-step reference as a backend: every stage through
    ``run_stage_stepwise``, chains and groups through ``TrainerBackend``'s
    per-stage defaults, and neither capability claimed, so an engine over
    it runs stage by stage."""

    supports_batched_stages = False
    supports_chain_fusion = False
    run_stage = TorchTrainer.run_stage_stepwise
    run_stages_batched = TrainerBackend.run_stages_batched
    run_chain = TrainerBackend.run_chain
    run_chains_batched = TrainerBackend.run_chains_batched


def make(trainer=TorchTrainer, **kw):
    return trainer(ResNet(n=1, width=8), pipe, EVAL,
                   default_optimizer="momentum", device="cpu", **kw)


@pytest.fixture(scope="module")
def fused():
    return make()


@pytest.fixture(scope="module")
def stepwise():
    return make(StepwiseTrainer)


def trial_stages(trial, steps):
    """(ctx per stage) along the trial's own path, stage = one plan node."""
    plan = SearchPlan("solo-" + trial.trial_id)
    node, _, _ = plan.submit(trial, steps)
    path = plan.path_to_root(node.node_id)
    out = []
    for i, n in enumerate(path):
        stop = steps if i == len(path) - 1 else path[i + 1].start
        out.append(StageContext(n.node_id, n.desc, n.start, n.start, stop,
                                plan.path_key(n.node_id)))
    return out


def straight_through(backend, trial, steps):
    state = backend.init_state()
    for ctx in trial_stages(trial, steps):
        state = backend.run_stage(state, ctx)
    return state, backend.evaluate(state, None)


def assert_states_identical(a, b):
    assert a["step"] == b["step"] and a["opt_name"] == b["opt_name"]
    assert tuple(a["data"]) == tuple(b["data"])
    for ta, tb in ((a["params"], b["params"]), (a["opt"], b["opt"])):
        la, lb = tree_leaves(ta), tree_leaves(tb)
        assert len(la) == len(lb) and len(la) > 0
        for x, y in zip(la, lb):
            assert torch.equal(x, y)


# ------------------------------------------------------------------ lossless


@pytest.mark.parametrize("trial", [
    Trial(HpConfig({"lr": MultiStep(0.05, [7], values=[0.05, 0.01]),
                    "bs": Constant(32)}), 19),
    Trial(HpConfig({"lr": Constant(0.05),
                    "bs": MultiStep(32, [10], values=[32, 64])}), 16),
], ids=["lr_drop_mid_chunk", "bs_change_mid_chunk"])
def test_fused_equals_stepwise_bitwise(fused, stepwise, trial):
    assert fused.supports_chain_fusion and fused.chunk_steps == 8
    f_state, f_metrics = straight_through(fused, trial, trial.total_steps)
    s_state, s_metrics = straight_through(stepwise, trial, trial.total_steps)
    assert_states_identical(f_state, s_state)
    assert f_metrics == s_metrics


DEPTH4 = Trial(HpConfig({"lr": MultiStep(0.05, [8, 16],
                                         values=[0.05, 0.02, 0.01]),
                         "bs": MultiStep(32, [16], values=[32, 64])}), 24)


def test_run_chain_depth4_equals_per_stage_bitwise(fused, stepwise):
    """One fused ``run_chain`` call over 4 stages == ``run_stage`` per
    stage == the per-step loop, at every boundary."""
    ctxs = trial_stages(DEPTH4, 24)
    # split the middle node so the chain has 4 stages: [0,8)[8,12)[12,16)[16,24)
    mid = ctxs[1]
    ctxs = [ctxs[0],
            StageContext(mid.node_id, mid.desc, mid.node_start, 8, 12,
                         mid.path_key),
            StageContext(mid.node_id, mid.desc, mid.node_start, 12, 16,
                         mid.path_key),
            ctxs[2]]
    assert [(c.start, c.stop) for c in ctxs] == [(0, 8), (8, 12), (12, 16),
                                                 (16, 24)]
    boundaries = fused.run_chain(fused.init_state(), ctxs)
    assert len(boundaries) == 4
    state_f, state_s = fused.init_state(), stepwise.init_state()
    for ctx, b in zip(ctxs, boundaries):
        state_f = fused.run_stage(state_f, ctx)
        state_s = stepwise.run_stage_stepwise(state_s, ctx)
        assert_states_identical(b, state_f)
        assert_states_identical(b, state_s)
    assert boundaries[-1]["data"][3] == 64


def test_chain_fused_engine_run_equals_stepwise_bitwise(fused, stepwise):
    """Through the engine: one chain with a mid-chain report boundary
    (step 12) and a mid-chain batch-size change (step 16), boundary
    checkpoints written behind."""
    class MidChainReportTuner(GridTuner):
        def start(self, handle):
            self.handle = handle
            for t in self.trials:
                handle.submit(t, upto=12)
                handle.submit(t)

        def on_result(self, t, step, metrics):
            if step == t.total_steps:
                super().on_result(t, step, metrics)

    db = SearchPlanDB()
    study = Study.create(db, "resnet8", "synth", ("lr", "bs"))
    eng = study.engine(fused, n_workers=1)
    assert eng.chain_fusion
    stats = eng.run([MidChainReportTuner([DEPTH4])])
    assert stats.chain_fused_stages >= 4
    assert stats.ckpt_async_writes >= 4
    assert eng.store.pending_writes == 0       # shutdown flush barrier

    plan = db.get(study.key)
    leaf = plan.nodes[plan.trial_paths[DEPTH4.trial_id][-1]]
    merged = eng.store.get(leaf.ckpts[24])
    solo_state, solo_metrics = straight_through(stepwise, DEPTH4, 24)
    assert leaf.metrics[24] == solo_metrics
    assert_states_identical(merged, solo_state)
    mid = plan.nodes[plan.trial_paths[DEPTH4.trial_id][1]]
    _, mid_metrics = straight_through(stepwise, DEPTH4, 12)
    assert mid.metrics[12] == mid_metrics


def test_fork_from_checkpoint_equals_straight_through_bitwise(fused):
    trials = [
        Trial(HpConfig({"lr": Constant(0.05), "bs": Constant(32)}), 24),
        Trial(HpConfig({"lr": MultiStep(0.05, [12], values=[0.05, 0.005]),
                        "bs": Constant(32)}), 24),
        Trial(HpConfig({"lr": MultiStep(0.05, [12], values=[0.05, 0.01]),
                        "bs": MultiStep(32, [18], values=[32, 64])}), 24),
    ]
    db = SearchPlanDB()
    study = Study.create(db, "resnet8", "synth", ("lr", "bs"))
    eng = study.engine(fused, n_workers=2)
    stats = eng.run([GridTuner(list(trials))])
    assert stats.steps_run < 3 * 24             # the prefix trained once
    plan = db.get(study.key)
    for t in trials:
        leaf = plan.nodes[plan.trial_paths[t.trial_id][-1]]
        merged = eng.store.get(leaf.ckpts[24])
        solo_state, solo_metrics = straight_through(fused, t, 24)
        assert leaf.metrics[24] == solo_metrics, t
        assert_states_identical(merged, solo_state)


def test_shared_prefix_checkpoint_is_shared(fused):
    a = Trial(HpConfig({"lr": Constant(0.05), "bs": Constant(32)}), 20)
    b = Trial(HpConfig({"lr": MultiStep(0.05, [10], values=[0.05, 0.005]),
                        "bs": Constant(32)}), 20)
    study = Study.create(SearchPlanDB(), "resnet8", "synth", ("lr", "bs"))
    stats = study.engine(fused, n_workers=1).run([GridTuner([a, b])])
    assert stats.steps_run == 30       # shared prefix [0,10) trained once


def test_batch_size_change_resumes_pipeline_position(fused):
    t = Trial(HpConfig({"lr": Constant(0.05),
                        "bs": MultiStep(32, [8], values=[32, 64])}), 16)
    state, metrics = straight_through(fused, t, 16)
    assert state["step"] == 16
    assert state["data"][3] == 64              # final batch size
    assert np.isfinite(metrics["loss"])


def test_snapshots_are_not_mutated_by_later_steps(fused):
    """Updates write fresh tensors: a boundary state handed out stays what
    it was while the chain trains on."""
    ctxs = trial_stages(DEPTH4, 24)
    first = fused.run_chain(fused.init_state(), ctxs[:1])[0]
    frozen = tree_to_numpy((first["params"], first["opt"]))
    fused.run_chain(first, ctxs[1:])
    after = tree_to_numpy((first["params"], first["opt"]))
    for a, b in zip(tree_leaves(frozen), tree_leaves(after)):
        np.testing.assert_array_equal(a, b)
    clone = fused.clone_state(first)
    assert clone is not first and clone["params"] is not first["params"]
    assert_states_identical(clone, first)


def test_non_contiguous_chain_is_refused(fused):
    ctxs = trial_stages(DEPTH4, 24)
    with pytest.raises(ValueError, match="contiguous"):
        fused.run_chain(fused.init_state(), [ctxs[0], ctxs[2]])


@pytest.mark.parametrize("n,cap,want", [
    (19, 8, [8, 8, 2, 1]), (8, 8, [8]), (7, 8, [4, 2, 1]), (1, 8, [1]),
    (0, 8, []), (21, 4, [4, 4, 4, 4, 4, 1]), (5, 1, [1] * 5)])
def test_chunk_lengths(n, cap, want):
    assert chunk_lengths(n, cap) == want


def test_chunk_lengths_rejects_bad_cap():
    with pytest.raises(ValueError):
        chunk_lengths(4, 0)


# ------------------------------------------------------------- against JAX


@pytest.mark.parametrize("opt", ["momentum", "sgd", "adam"])
def test_six_steps_match_jax_trainer(opt):
    """Same initial weights (initialised in JAX, carried across), same data
    stream, 6 steps with an lr drop at step 4."""
    ref = JaxTrainer(JaxResNet(n=1, width=8),
                     lambda: RefDataPipeline(DATA, batch_size=32, seed=3),
                     EVAL, default_optimizer=opt, backend="cpu")
    port = TorchTrainer(ResNet(n=1, width=8), pipe, EVAL,
                        default_optimizer=opt, device="cpu")
    lr = 1e-3 if opt == "adam" else 0.05
    trial = Trial(HpConfig({"lr": MultiStep(lr, [4], values=[lr, lr / 5]),
                            "bs": Constant(32)}), 6)

    jstate = ref.init_state()
    tstate = state_from_numpy(
        {**jstate, "params": jax.tree.map(np.asarray, jstate["params"])},
        "cpu")
    assert tstate["data"] == tuple(jstate["data"])
    for ctx in trial_stages(trial, 6):
        jstate = ref.run_stage(jstate, RefStageContext(
            ctx.node_id, ctx.desc, ctx.node_start, ctx.start, ctx.stop,
            ctx.path_key))
        tstate = port.run_stage(tstate, ctx)
    assert tstate["step"] == jstate["step"] == 6
    assert tstate["data"] == tuple(jstate["data"])

    def flat(tree):      # jax.tree.leaves order: dict keys sorted
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in flat(tree[k])]
        if isinstance(tree, (list, tuple)):
            return [x for v in tree for x in flat(v)]
        return [tree]

    jl = [np.asarray(x) for x in jax.tree.leaves(jstate["params"])]
    tl = flat(tree_to_numpy(tstate["params"]))
    assert len(jl) == len(tl)
    moved = 0.0
    init = flat(jax.tree.map(np.asarray, ref.init_state()["params"]))
    for a, b, p0 in zip(tl, jl, init):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)
        moved = max(moved, float(np.abs(b - p0).max()))
    assert moved > 1e-3                 # training did move the weights
    jm, tm = ref.evaluate(jstate, None), port.evaluate(tstate, None)
    assert abs(jm["loss"] - tm["loss"]) < 1e-3


# ------------------------------------------------------------- kernel plane


def test_use_kernel_defaults_off_on_cpu(fused):
    assert fused.device.type == "cpu" and fused.use_kernel is False
    assert fused.kernel_calls == 0 and fused.kernel_fallbacks == 0


def test_use_kernel_on_cpu_counts_one_warned_once_fallback(stepwise):
    kops.reset_kernel_stats()
    launches0 = (stacked_leaf_update.launches, stacked_tree_update.launches)
    trainer = make(use_kernel=True)
    trial = Trial(HpConfig({"lr": Constant(0.05), "bs": Constant(32)}), 5)
    with pytest.warns(kops.KernelFallbackWarning) as caught:
        state, _ = straight_through(trainer, trial, 5)
    assert len([w for w in caught
                if w.category is kops.KernelFallbackWarning]) == 1
    assert trainer.kernel_fallbacks == 5 and trainer.kernel_calls == 0
    assert kops.KERNEL_STATS.reasons == {"opt_update:device:cpu": 5}
    assert (stacked_leaf_update.launches,
            stacked_tree_update.launches) == launches0
    # the plain version is what ran: same bits as use_kernel=False
    plain_state, _ = straight_through(stepwise, trial, 5)
    assert_states_identical(state, plain_state)
    # a trainer built afterwards starts from its own baseline
    assert make(use_kernel=True).kernel_fallbacks == 0
    kops.reset_kernel_stats()


def test_engine_mirrors_kernel_counters():
    kops.reset_kernel_stats()
    trainer = make(use_kernel=True)
    trial = Trial(HpConfig({"lr": Constant(0.05), "bs": Constant(32)}), 4)
    study = Study.create(SearchPlanDB(), "resnet8", "synth", ("lr", "bs"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", kops.KernelFallbackWarning)
        stats = study.run(GridTuner([trial]), trainer, n_workers=1)
    assert stats.kernel_fallbacks == 4 and stats.kernel_calls == 0
    kops.reset_kernel_stats()


def test_labels_become_int64_once_at_upload(fused):
    slab = fused._upload(pipe().next_batches(2))
    assert slab["labels"].dtype == torch.int64
    assert slab["images"].dtype == torch.float32
    assert tuple(slab["images"].shape) == (2, 32, 32, 32, 3)
    assert fused.eval_batch["labels"].dtype == torch.int64
