"""Fault plane of the PyTorch package: deterministic injection, the
dispatcher's retry / quarantine / degradation failure domains, and the
in-band retry check — ports of ``tests/test_faults.py``, and the same
schedules side by side with the JAX package.

The load-bearing property throughout: faults change *when* work runs,
never *what* it computes — every faulty run finishes with leaf
checkpoints bit-identical to the fault-free run's, the retry waste in
``wasted_gpu_seconds`` and out of the sharing studies' fair-share
charges.  Over ``SimulatedTrainer`` (pure Python in both packages) the
same seed, rates and plan give the same ``inj.log`` entry for entry and
``EngineStats`` equal field for field; over the real trainers with a
fixed virtual stage time, the same log and counts and leaves within the
side-by-side tolerance of ``tests/test_torch_trainer.py``.

The launcher's durability and fault surface
(``test_sigkill_then_restore_finishes_identically``,
``test_sigterm_graceful_shutdown_snapshot``,
``test_serve_studies_inject_faults``) drives
``repro_torch.launch.serve_studies`` and holds it to the JAX package's
launcher and service.
"""

import dataclasses
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import repro.core as R
import repro.core.tuners as RT
import repro_torch.core as T
import repro_torch.core.tuners as TT
from repro.core.faults import raw_store as ref_raw_store
from repro_torch.core import (FatalStageError, FaultInjector, SearchPlanDB,
                              StoreOutageError, StudyService, StudySpec,
                              TransientStageError, WorkerCrashed)
from repro_torch.core.faults import is_transient, raw_store
from repro_torch.core.hpseq import (Constant, Exponential, HpConfig,
                                    MultiStep, StepLR, Warmup)
from repro_torch.core.trainer import SimulatedTrainer
from repro_torch.core.trial import Trial
from repro_torch.core.tuners import GridSearchSpace, GridTuner
from repro_torch.data import DataPipeline
from repro_torch.dist.meshes import WorkerMesh
from repro_torch.train.torch_trainer import TorchTrainer
from repro_torch.utils.tree import tree_leaves

# the suite runs several worker processes side by side: one intra-op
# thread each, or the workers fight over the cores
torch.set_num_threads(1)

SPEC = StudySpec("m", "d", ("lr", "bs"))
WALL_CLOCK = ("ckpt_save_seconds", "ckpt_load_seconds")


def _space(n_lr: int = 3, C=T, space=GridSearchSpace) -> GridSearchSpace:
    lrs = [C.StepLR(0.1, 0.1, [30]), C.StepLR(0.1, 0.1, [40]),
           C.Warmup(5, 0.1, C.Exponential(0.1, 0.95))][:n_lr]
    return space(fns={"lr": lrs,
                      "bs": [C.Constant(64), C.Constant(128)]})


def det(stats):
    """Deterministic view (the reference's ``test_faults.det``): physical
    wall timers and physical-store counters vary run to run; everything
    else must replay exactly."""
    return dataclasses.replace(
        stats, ckpt_save_seconds=0.0, ckpt_load_seconds=0.0,
        ckpt_delta_bytes=0, ckpt_full_bytes=0, ckpt_logical_bytes=0,
        ckpt_bytes_written=0, ckpt_delta_commits=0, ckpt_delta_rebases=0,
        ckpt_mem_hits=0, ckpt_disk_hits=0, ckpt_remote_hits=0,
        ckpt_store_misses=0, ckpt_tier_promotions=0, ckpt_tier_demotions=0,
        ckpt_tmp_reclaimed=0, d2d_handoffs=0)


def fields(stats):
    """Every EngineStats field but the wall-clock timers, as a dict (the
    cross-package comparison of ``tests/test_torch_engine.py``)."""
    d = dataclasses.asdict(stats)
    for k in WALL_CLOCK:
        d.pop(k)
    return d


def run_session(injector=None, *, n_workers=4, steps=80, second_study=True,
                backend=None, C=T, tuners=TT, **engine_kw):
    """Two-study fair-share session of package ``C``; returns (stats,
    leaves, service)."""
    spec = C.StudySpec("m", "d", ("lr", "bs"))
    space = _space(C=C, space=tuners.GridSearchSpace)
    svc = C.StudyService(C.SearchPlanDB(),
                         backend or C.SimulatedTrainer(horizon=steps),
                         n_workers=n_workers, policy="fair_share",
                         fault_injector=injector, **engine_kw)
    svc.submit(spec, tuners.GridTuner(space.trials(steps)))
    if second_study:
        svc.submit(spec, tuners.GridTuner(space.trials(steps)[:4]),
                   at=200.0)
    stats = svc.close()
    eng = svc._engine
    store = (raw_store if C is T else ref_raw_store)(eng.store)
    leaves = {}
    for nid, node in eng.plan.nodes.items():
        for step, cid in node.ckpts.items():
            try:
                leaves[(nid, step)] = store.get(cid)
            except KeyError:
                pass                       # GC'd interior boundary
    return stats, leaves, svc


def _bits(x):
    if isinstance(x, torch.Tensor):
        return (str(x.dtype), tuple(x.shape),
                x.detach().contiguous().reshape(-1).view(torch.uint8)
                .numpy().tobytes())
    a = np.asarray(x)
    return (str(a.dtype), a.shape, a.tobytes())


def assert_leaves_equal(a, b):
    """Same checkpoints, every leaf the same bits."""
    assert set(a) == set(b)
    for k in a:
        la, lb = tree_leaves(a[k]), tree_leaves(b[k])
        assert len(la) == len(lb)
        for x, y in zip(la, lb):
            assert _bits(x) == _bits(y), k


# ---------------------------------------------------------------------------
# injector determinism
# ---------------------------------------------------------------------------

def _drain_schedule(inj, n=200):
    out = []
    for i in range(n):
        try:
            inj.before_execute(f"s{i}")
        except Exception as e:
            out.append(type(e).__name__)
    return out, list(inj.log)


def test_same_seed_same_schedule():
    a = FaultInjector(42, stage_fault_rate=0.2, crash_rate=0.1)
    b = FaultInjector(42, stage_fault_rate=0.2, crash_rate=0.1)
    sched_a, log_a = _drain_schedule(a)
    sched_b, log_b = _drain_schedule(b)
    assert sched_a == sched_b and log_a == log_b
    assert a.injected == b.injected > 0


def test_different_seed_different_schedule():
    a = FaultInjector(1, stage_fault_rate=0.2, crash_rate=0.1)
    b = FaultInjector(2, stage_fault_rate=0.2, crash_rate=0.1)
    assert _drain_schedule(a)[0] != _drain_schedule(b)[0]


def test_max_faults_bounds_schedule():
    inj = FaultInjector(0, stage_fault_rate=1.0, max_faults=3)
    fired, _ = _drain_schedule(inj, 50)
    assert len(fired) == 3 and inj.injected == 3


def test_outage_window_counts_once():
    inj = FaultInjector(0, outage_rate=1.0, outage_ops=3)
    for _ in range(3):                    # the fired op + 2 window ops
        with pytest.raises(StoreOutageError):
            inj.on_store_op("get", "cid")
    assert inj.injected == 1 and inj.by_kind == {"outage": 1}


def test_fault_taxonomy():
    assert is_transient(TransientStageError("x"))
    assert is_transient(WorkerCrashed("x"))
    assert not is_transient(FatalStageError("x"))
    assert not is_transient(ValueError("x"))
    # a PyTorch error is not a fault the plane retries
    assert not is_transient(torch.OutOfMemoryError("x"))
    # injected faults must NOT alias the dispatcher's fall-back signal
    assert not isinstance(TransientStageError("x"), ValueError)


@pytest.mark.parametrize("rates", [
    dict(stage_fault_rate=0.2, crash_rate=0.1),
    dict(outage_rate=0.3, outage_ops=2),
    dict(straggler_rate=0.5, admission_fault_rate=0.2),
    dict(stage_fault_rate=0.3, crash_rate=0.2, outage_rate=0.1,
         straggler_rate=0.1, max_faults=7)],
    ids=["stage_crash", "outage", "straggler_admission", "all_capped"])
def test_draws_equal_the_reference_draw_for_draw(rates):
    """Every injection site, driven in the same order: the same faults,
    the same log, the same stream state (snapshot_state round trip)."""
    def drive(cls, inj):
        out = []
        for i in range(120):
            for call in (lambda: inj.before_execute(f"stage:n{i}@{i}"),
                         lambda: inj.on_store_op("get", f"c{i}"),
                         lambda: out.append(inj.straggle(float(i), f"s{i}")),
                         lambda: out.append(inj.on_admission(f"a{i}"))):
                try:
                    call()
                except Exception as e:
                    out.append(type(e).__name__)
        return out

    ref, port = R.FaultInjector(5, **rates), FaultInjector(5, **rates)
    assert drive(R, ref) == drive(T, port)
    assert ref.log == port.log and ref.by_kind == port.by_kind
    assert ref.injected == port.injected > 0
    state = port.snapshot_state()
    assert state == ref.snapshot_state()
    again = FaultInjector(5, **rates)
    again.restore_state(state)
    assert drive(T, again) == drive(T, port)


# ---------------------------------------------------------------------------
# the acceptance run: faults injected, session completes bitwise-equal
# ---------------------------------------------------------------------------

def test_faulty_session_bitwise_equals_fault_free():
    """Seeded schedule of worker crashes + transient stage failures + a
    store outage: the multi-study session completes, retries happened,
    every final leaf is bit-equal to the fault-free run, and the retry
    waste never lands in the sharing studies' fair-share charges."""
    ref, leaves_ref, _ = run_session(None)
    inj = FaultInjector(11, stage_fault_rate=0.25, crash_rate=0.15,
                        outage_rate=0.02, outage_ops=2)
    got, leaves_got, _ = run_session(inj)

    assert inj.injected > 0 and got.faults_injected == inj.injected
    assert {"stage", "crash", "outage"} <= set(inj.by_kind)
    assert got.stage_retries > 0
    assert got.stage_failures >= got.stage_retries
    assert got.wasted_gpu_seconds > 0

    assert got.steps_run == ref.steps_run
    assert_leaves_equal(leaves_ref, leaves_got)

    total_ref = sum(s.gpu_seconds for s in ref.by_study.values())
    total_got = sum(s.gpu_seconds for s in got.by_study.values())
    assert total_got == pytest.approx(total_ref)
    assert got.gpu_seconds >= total_got


def test_crash_heavy_run_quarantines_and_completes():
    inj = FaultInjector(3, crash_rate=0.45, stage_fault_rate=0.1)
    got, leaves_got, _ = run_session(inj, n_workers=2, second_study=False)
    ref, leaves_ref, _ = run_session(None, n_workers=2, second_study=False)
    assert inj.by_kind.get("crash", 0) > 0
    assert got.workers_quarantined > 0
    assert got.steps_run == ref.steps_run
    assert_leaves_equal(leaves_ref, leaves_got)


def test_straggler_completes_but_slower():
    inj = FaultInjector(5, straggler_rate=1.0, straggler_factor=4.0)
    got, leaves_got, _ = run_session(inj, second_study=False)
    ref, leaves_ref, _ = run_session(None, second_study=False)
    assert inj.by_kind.get("straggler", 0) > 0
    assert got.stage_failures == 0            # performance fault only
    assert got.steps_run == ref.steps_run
    assert got.gpu_seconds > ref.gpu_seconds  # slowdown is real + accounted
    assert_leaves_equal(leaves_ref, leaves_got)


def test_fatal_fault_propagates():
    class FatalOnce(FaultInjector):
        def __init__(self):
            super().__init__(0)
            self._armed = True

        def before_execute(self, site):
            if self._armed:
                self._armed = False
                self._record("fatal", site)
                raise FatalStageError(f"injected fatal at {site}")

    svc = StudyService(SearchPlanDB(), SimulatedTrainer(horizon=80),
                       n_workers=2, fault_injector=FatalOnce())
    svc.submit(SPEC, GridTuner(_space(1).trials(80)))
    with pytest.raises(FatalStageError):
        svc.close()


def test_retry_budget_is_consecutive_not_cumulative():
    """``max_stage_retries`` bounds consecutive failures of one unit."""

    class EveryOtherAttempt(FaultInjector):
        def __init__(self):
            super().__init__(0)
            self._flip = False

        def before_execute(self, site):
            self._flip = not self._flip
            if self._flip:
                self._record("stage", site)
                raise TransientStageError(f"injected at {site}")

    got, leaves_got, svc = run_session(EveryOtherAttempt(), n_workers=2,
                                       second_study=False)
    ref, leaves_ref, _ = run_session(None, n_workers=2, second_study=False)
    disp = svc._engine.dispatcher
    assert got.stage_retries > disp.max_stage_retries
    assert got.steps_run >= ref.steps_run
    terminal = {k for k in leaves_ref if k[1] == 80}
    assert terminal and terminal <= set(leaves_got)
    assert_leaves_equal({k: leaves_ref[k] for k in terminal},
                        {k: leaves_got[k] for k in terminal})


def test_retry_exhaustion_propagates():
    inj = FaultInjector(0, stage_fault_rate=1.0)   # every attempt fails
    svc = StudyService(SearchPlanDB(), SimulatedTrainer(horizon=80),
                       n_workers=2, fault_injector=inj)
    svc.submit(SPEC, GridTuner(_space(1).trials(80)))
    with pytest.raises(TransientStageError):
        svc.close()


def test_store_outage_only_run_completes():
    inj = FaultInjector(9, outage_rate=0.15, outage_ops=2)
    got, leaves_got, _ = run_session(inj, second_study=False)
    ref, leaves_ref, _ = run_session(None, second_study=False)
    assert inj.by_kind.get("outage", 0) > 0
    assert got.stage_retries > 0
    assert got.steps_run == ref.steps_run
    assert_leaves_equal(leaves_ref, leaves_got)


def test_engine_wraps_backend_and_store_and_still_refuses_meshes():
    inj = FaultInjector(0)
    eng = T.Study.create(SearchPlanDB(), "m", "d", ("lr",)).engine(
        SimulatedTrainer(), n_workers=1, fault_injector=inj)
    assert isinstance(eng.backend, T.FaultyBackend)
    assert isinstance(eng.store, T.FaultyStore)
    assert eng.dispatcher._injector is inj and raw_store(eng.store) \
        is eng.store.inner
    # a wide worker mesh over the trainer is taken with the fault plane
    # on as without it, and a study runs on it (every shard a CPU
    # tensor); through the wrapper, the placement gate still rejects a
    # mesh that shards nothing (3 divides neither 16 x 4 nor 4)
    wide = [WorkerMesh.build([0, 1])]
    study = T.Study.create(SearchPlanDB(), "m", "d", ("lr",))
    eng = study.engine(tiny_backend(), n_workers=1, worker_meshes=wide,
                       fault_injector=inj)
    assert isinstance(eng.backend, T.FaultyBackend)
    assert eng.workers[0].devices == 2 and eng.dispatcher._d2d_enabled
    stats = eng.run([GridTuner([Trial(HpConfig({"lr": Constant(0.1)}),
                                      8)])])
    assert stats.mesh_placements > 0 and stats.steps_run == 8
    assert eng.backend.mesh_compatible(wide[0], [])
    assert not eng.backend.mesh_compatible(WorkerMesh.build([0, 1, 2]), [])
    eng = T.ExecutionEngine(T.SearchPlan("x"), SimulatedTrainer(),
                            worker_meshes=wide, fault_injector=inj)
    assert eng.workers[0].devices == 2 and eng.dispatcher._d2d_enabled


# ---------------------------------------------------------------------------
# sibling groups: a failed batched group degrades to solo runs
# ---------------------------------------------------------------------------

class BatchedChainSim(SimulatedTrainer):
    supports_batched_stages = True
    supports_chain_fusion = True


def seq_trial(lr0, lr1, steps=24, boundary=12, C=T):
    return C.Trial(C.HpConfig({"lr": C.MultiStep(lr0, [boundary],
                                                 values=[lr0, lr1])}), steps)


class GroupFault(FaultInjector):
    """Deterministically fail the first batched-group attempt."""

    def __init__(self):
        super().__init__(0)
        self._armed = True

    def before_execute(self, site):
        if self._armed and site.startswith(("group:", "group-chain:")):
            self._armed = False
            self._record("stage", site)
            raise TransientStageError(f"injected group fault at {site}")


def group_run(backend, inj, steps=48, boundary=24, n=4):
    svc = StudyService(SearchPlanDB(), backend, n_workers=1,
                       fault_injector=inj, batch_siblings=True)
    svc.submit(StudySpec("m", "d", ("lr",)),
               GridTuner([seq_trial(0.1 - 0.01 * i, 0.01, steps=steps,
                                    boundary=boundary) for i in range(n)]))
    stats = svc.close()
    eng = svc._engine
    store = raw_store(eng.store)
    leaves = {(nid, st): store.get(cid)
              for nid, node in eng.plan.nodes.items()
              for st, cid in node.ckpts.items() if store.contains(cid)}
    metrics = {nid: node.metrics for nid, node in eng.plan.nodes.items()}
    return stats, leaves, metrics


def test_batched_group_degrades_to_solo():
    """A transient fault inside a batched sibling-group call degrades the
    group to per-member solo execution instead of failing it wholesale."""
    ref, leaves_ref, _ = group_run(BatchedChainSim(horizon=48), None)
    assert ref.batched_groups > 0, "scenario never batched"
    inj = GroupFault()
    got, leaves_got, _ = group_run(BatchedChainSim(horizon=48), inj)
    assert inj.injected == 1
    assert got.groups_degraded == 1
    assert got.steps_run == ref.steps_run
    assert_leaves_equal(leaves_ref, leaves_got)


class TinyTask:
    """Linear softmax classifier (the reference tests' tiny task); with
    ``params0`` (numpy) it starts from those weights."""

    def __init__(self, params0=None):
        self.params0 = params0

    def init(self, gen):
        if self.params0 is not None:
            return {k: torch.from_numpy(np.array(v))
                    for k, v in self.params0.items()}
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


def tiny_backend(params0=None, **kw):
    data = tiny_dataset()
    return TorchTrainer(TinyTask(params0), lambda: DataPipeline(data, batch_size=8,
                                                       seed=3),
               tiny_dataset(seed=1), default_optimizer="momentum",
               device="cpu", **kw)


def test_batched_group_degrades_to_solo_on_the_trainer():
    """The same on ``TorchTrainer(device="cpu")``, whose group tier is the
    looped one: the degraded members' solo runs give the group's bits, and
    every metric is equal."""
    ref, leaves_ref, m_ref = group_run(tiny_backend(), None, steps=16,
                                       boundary=8, n=3)
    assert ref.batched_groups > 0
    inj = GroupFault()
    got, leaves_got, m_got = group_run(tiny_backend(), inj, steps=16,
                                       boundary=8, n=3)
    assert inj.injected == 1 and got.groups_degraded == 1
    assert got.stage_failures == 1 and got.steps_run == ref.steps_run
    assert_leaves_equal(leaves_ref, leaves_got)
    assert m_ref == m_got


# ---------------------------------------------------------------------------
# real training: a faulty run bit-equal to the fault-free one
# ---------------------------------------------------------------------------

def test_faulty_torch_run_bitwise_equals_fault_free():
    """test_lossless-style, on ``TorchTrainer(device="cpu")``: a faulty
    run's leaf states (params, optimizer, data cursor) are bit-identical
    to the fault-free run's — retry from the boundary checkpoint replays
    the exact same computation — and so is every reported metric."""
    def run(inj):
        db = SearchPlanDB()
        study = T.Study.create(db, "m", "d", ("lr",))
        trials = [Trial(HpConfig({"lr": MultiStep(0.1, [8],
                                                  values=[0.1, v])}), 16)
                  for v in (0.05, 0.02, 0.01)]
        eng = study.engine(tiny_backend(), n_workers=2, fault_injector=inj)
        stats = eng.run([GridTuner(trials)])
        return db.get(study.key), eng, stats, trials

    plan_ref, eng_ref, ref, trials = run(None)
    inj = FaultInjector(2, stage_fault_rate=0.3, crash_rate=0.2)
    plan_got, eng_got, got, _ = run(inj)
    assert inj.injected > 0, "seed drew no faults — pick another"
    assert got.stage_retries > 0
    assert got.steps_run >= ref.steps_run

    store_ref = raw_store(eng_ref.store)
    store_got = raw_store(eng_got.store)
    for t in trials:
        leaf_ref = plan_ref.trial_paths[t.trial_id][-1]
        leaf_got = plan_got.trial_paths[t.trial_id][-1]
        assert_leaves_equal(
            {0: store_ref.get(plan_ref.nodes[leaf_ref].ckpts[16])},
            {0: store_got.get(plan_got.nodes[leaf_got].ckpts[16])})
        assert (plan_ref.nodes[leaf_ref].metrics[16]
                == plan_got.nodes[leaf_got].metrics[16])


# ---------------------------------------------------------------------------
# retry-bitwise assertion (the in-band verifier)
# ---------------------------------------------------------------------------

def test_assert_retry_identical():
    """With an injector attached, every re-put of a committed checkpoint
    is compared bit for bit against the committed tree: identical trees
    count in ``retries_verified``; a divergent recompute is an engine bug
    and must raise."""
    inj = FaultInjector(0)
    svc = StudyService(SearchPlanDB(), SimulatedTrainer(horizon=40),
                       n_workers=1, fault_injector=inj)
    svc.submit(SPEC, GridTuner(_space(1).trials(40)[:1]))
    svc.close()
    eng = svc._engine
    disp = eng.dispatcher
    store = raw_store(eng.store)

    nid, node = next(iter(eng.plan.nodes.items()))
    step, cid = next(iter(node.ckpts.items()))
    committed = store.get(cid)
    path_key = eng.plan.path_key(nid)
    assert store.ckpt_id(path_key, step) == cid

    before = inj.retries_verified
    disp._assert_retry_identical(path_key, step, committed)
    assert inj.retries_verified == before + 1

    mutated = {k: (np.asarray(v) + 1 if np.issubdtype(
        np.asarray(v).dtype, np.number) else v)
        for k, v in committed.items()}
    with pytest.raises(RuntimeError, match="retry"):
        disp._assert_retry_identical(path_key, step, mutated)

    # unknown checkpoint: nothing committed yet, nothing to verify
    disp._assert_retry_identical("no-such-path", 999, committed)
    assert inj.retries_verified == before + 1


def test_assert_retry_identical_compares_bit_patterns():
    """On tensors the check is a byte view: ``-0.0`` is not ``0.0``, a NaN
    matches its own bits, a dtype or structure change is a difference —
    and nothing is compared at a tolerance."""
    inj = FaultInjector(0)
    eng = T.Study.create(SearchPlanDB(), "m", "d", ("lr",)).engine(
        SimulatedTrainer(), n_workers=1, fault_injector=inj)
    disp, store = eng.dispatcher, raw_store(eng.store)
    nan = torch.tensor([1.0, float("nan")])
    store.put("pk", 4, {"w": torch.tensor([0.0, 1.0]), "n": nan,
                        "h": torch.ones(3, dtype=torch.bfloat16),
                        "step": 4, "data": (3, 0, 8, 8)})

    def same(**change):
        tree = {"w": torch.tensor([0.0, 1.0]), "n": nan.clone(),
                "h": torch.ones(3, dtype=torch.bfloat16), "step": 4,
                "data": (3, 0, 8, 8)}
        tree.update(change)
        try:
            disp._assert_retry_identical("pk", 4, tree)
            return True
        except RuntimeError:
            return False

    assert same()
    assert inj.retries_verified == 1
    assert not same(w=torch.tensor([-0.0, 1.0]))
    assert not same(w=torch.tensor([0.0, 1.0 + 2 ** -23]))
    assert not same(h=torch.ones(3, dtype=torch.float16))
    assert not same(w=torch.tensor([[0.0, 1.0]]))
    assert not same(step=5)
    assert not same(data=[3, 0, 8, 8])
    assert not same(extra=torch.zeros(1))
    assert inj.retries_verified == 1


# ---------------------------------------------------------------------------
# side by side with the JAX package
# ---------------------------------------------------------------------------

SCHEDULES = {
    "stage": dict(stage_fault_rate=0.25),
    "crash": dict(crash_rate=0.3, stage_fault_rate=0.05),
    "outage": dict(outage_rate=0.1, outage_ops=2),
    "straggler": dict(straggler_rate=0.3),
    "all": dict(stage_fault_rate=0.2, crash_rate=0.1, outage_rate=0.02,
                straggler_rate=0.1, outage_ops=2),
}


class RefBatchedChainSim(R.SimulatedTrainer):
    supports_batched_stages = True
    supports_chain_fusion = True


def _side_run(C, tuners, sim, inj, groups):
    if groups:
        svc = C.StudyService(C.SearchPlanDB(), sim(horizon=48), n_workers=1,
                             fault_injector=inj, batch_siblings=True)
        svc.submit(C.StudySpec("m", "d", ("lr",)), tuners.GridTuner(
            [seq_trial(0.1 - 0.01 * i, 0.01, steps=48, boundary=24, C=C)
             for i in range(4)]))
        return svc.close()
    return run_session(inj, n_workers=3, C=C, tuners=tuners)[0]


@pytest.mark.parametrize("groups", [False, True], ids=["solo", "groups"])
@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_fault_log_and_stats_equal_the_reference(schedule, groups):
    """The same plan, seed and rates over each package's simulator: the
    fault log equal entry for entry, ``EngineStats`` field for field."""
    rates = SCHEDULES[schedule]
    r_inj, t_inj = R.FaultInjector(3, **rates), FaultInjector(3, **rates)
    ref = _side_run(R, RT, RefBatchedChainSim if groups
                    else R.SimulatedTrainer, r_inj, groups)
    got = _side_run(T, TT, BatchedChainSim if groups else SimulatedTrainer,
                    t_inj, groups)
    assert t_inj.injected > 0
    assert t_inj.log == r_inj.log
    assert t_inj.retries_verified == r_inj.retries_verified
    assert fields(got) == fields(ref)
    if groups:
        assert got.batched_groups + got.groups_degraded > 0


def test_group_degradation_equals_the_reference():
    """GroupFault on both packages: one degraded group, the same stats."""
    class RefGroupFault(R.FaultInjector):
        def __init__(self):
            super().__init__(0)
            self._armed = True

        def before_execute(self, site):
            if self._armed and site.startswith(("group:", "group-chain:")):
                self._armed = False
                self._record("stage", site)
                raise R.TransientStageError(f"injected at {site}")

    r_inj, t_inj = RefGroupFault(), GroupFault()
    ref = _side_run(R, RT, RefBatchedChainSim, r_inj, True)
    got = _side_run(T, TT, BatchedChainSim, t_inj, True)
    assert got.groups_degraded == ref.groups_degraded == 1
    assert t_inj.log == r_inj.log
    assert fields(got) == fields(ref)


def test_real_trainers_same_log_and_counts():
    """The reference's ``tiny_backend`` (JAX) against the port's CPU
    trainer on the same initial weights and data, each with a fixed
    virtual stage time so the schedule is the same: the same fault log
    and counts, and every leaf checkpoint within the side-by-side
    trainer tolerance (atol 1e-4)."""
    from test_dataplane import tiny_backend as ref_tiny_backend

    def steps(ctx):
        return float(ctx.stop - ctx.start)

    ref_backend = ref_tiny_backend()
    p0 = {k: np.asarray(v)
          for k, v in ref_backend.init_state()["params"].items()}
    port_backend = tiny_backend(p0)
    ref_backend.stage_seconds = port_backend.stage_seconds = steps

    def run(C, tuners, backend, inj, raw):
        db = C.SearchPlanDB()
        study = C.Study.create(db, "m", "d", ("lr",))
        trials = [C.Trial(C.HpConfig({"lr": C.MultiStep(
            0.1, [8], values=[0.1, v])}), 16) for v in (0.05, 0.02, 0.01)]
        eng = study.engine(backend, n_workers=2, fault_injector=inj)
        stats = eng.run([tuners.GridTuner(trials)])
        plan, store = db.get(study.key), raw(eng.store)
        leaves = {nid: store.get(n.ckpts[16]) for nid, n in
                  plan.nodes.items() if 16 in n.ckpts}
        return stats, leaves

    rates = dict(stage_fault_rate=0.3, crash_rate=0.2, outage_rate=0.05)
    r_inj, t_inj = R.FaultInjector(3, **rates), FaultInjector(3, **rates)
    ref, ref_leaves = run(R, RT, ref_backend, r_inj, ref_raw_store)
    got, got_leaves = run(T, TT, port_backend, t_inj, raw_store)
    assert t_inj.injected > 0 and t_inj.log == r_inj.log
    counts = ("steps_run", "stages_run", "evals_run", "ckpt_saves",
              "ckpt_loads", "ckpt_misses", "stage_failures", "stage_retries",
              "workers_quarantined", "groups_degraded", "faults_injected",
              "gpu_seconds", "wasted_gpu_seconds", "end_to_end")
    assert {k: getattr(got, k) for k in counts} == \
        {k: getattr(ref, k) for k in counts}
    assert set(got_leaves) == set(ref_leaves) and got_leaves
    for nid, tree in got_leaves.items():
        jt = ref_leaves[nid]
        assert tree["step"] == jt["step"] == 16
        assert tuple(tree["data"]) == tuple(jt["data"])
        for k in ("w", "b"):
            np.testing.assert_allclose(tree["params"][k].numpy(),
                                       np.asarray(jt["params"][k]),
                                       atol=1e-4, rtol=0)


def _first_get_outage(cls, outage):
    """An injector (of package ``cls``) whose first store ``get`` fails:
    in the group scenario that is a member's resume load in the group
    pass, so that member alone fails and retries."""

    class FirstGetOutage(cls):
        def __init__(self):
            super().__init__(0)
            self._armed = True

        def on_store_op(self, op, key):
            if self._armed and op == "get":
                self._armed = False
                self._record("outage", f"{op}:{key}")
                raise outage(f"injected store outage at {op} {key}")

    return FirstGetOutage()


def _forked_group_run(C, tuners, sim, inj, raw):
    """Four siblings forked from one shared prefix at step 24, one worker:
    the prefix runs alone, then the siblings resume from its checkpoint
    as one group.  Returns (stats, leaves)."""
    svc = C.StudyService(C.SearchPlanDB(), sim(horizon=48), n_workers=1,
                         fault_injector=inj, batch_siblings=True)
    svc.submit(C.StudySpec("m", "d", ("lr",)), tuners.GridTuner(
        [seq_trial(0.1, 0.01 * (i + 1), steps=48, boundary=24, C=C)
         for i in range(4)]))
    stats = svc.close()
    eng = svc._engine
    store = raw(eng.store)
    leaves = {(nid, st): store.get(cid)
              for nid, node in eng.plan.nodes.items()
              for st, cid in node.ckpts.items() if store.contains(cid)}
    return stats, leaves


def test_group_resume_load_outage_equals_the_reference():
    """The group pass's store-outage branch: one member's resume load
    fails and that member alone retries while its siblings run as a group
    — the same stats and log as the JAX package's, leaves bit-equal to
    the fault-free run's."""
    ref_inj = _first_get_outage(R.FaultInjector, R.StoreOutageError)
    inj = _first_get_outage(FaultInjector, StoreOutageError)
    ref, _ = _forked_group_run(R, RT, RefBatchedChainSim, ref_inj,
                               ref_raw_store)
    got, leaves_got = _forked_group_run(T, TT, BatchedChainSim, inj,
                                        raw_store)
    assert inj.log == ref_inj.log and inj.injected == 1
    assert inj.log[0]["site"].startswith("get:")
    assert fields(got) == fields(ref)
    assert got.stage_failures == got.stage_retries == 1
    assert got.batched_groups >= 1
    clean, leaves_clean = _forked_group_run(T, TT, BatchedChainSim, None,
                                            raw_store)
    assert clean.batched_groups >= 1 and clean.ckpt_loads >= 1
    assert_leaves_equal(leaves_clean, leaves_got)


# ---------------------------------------------------------------------------
# a retry that crosses the group tiers (vectorised group vs solo bits)
# ---------------------------------------------------------------------------

class OneUlpGroupSim(BatchedChainSim):
    """A vectorised tier in miniature: a batched call returns each member's
    solo states one ulp up (``np.nextafter``), as member-stacked products
    that sum in another order would; its tiers are not bitwise."""

    batched_bitwise_solo = False

    @staticmethod
    def _ulp(s):
        return dict(s, progress=float(np.nextafter(s["progress"], np.inf)))

    def run_stages_batched(self, states, ctxs):
        return [self._ulp(s) for s in super().run_stages_batched(states,
                                                                 ctxs)]

    def run_chains_batched(self, states, chains):
        return [[self._ulp(s) for s in out]
                for out in super().run_chains_batched(states, chains)]


class BoundaryOutage(FaultInjector):
    """From the first batched-group attempt on, fail the first ``n`` puts
    of a chain's second boundary (step 36) — each after that chain's first
    boundary (step 24) committed; with ``group_fault`` that first group
    attempt fails too, so the group degrades to solo runs first."""

    def __init__(self, n=1, group_fault=False):
        super().__init__(0)
        self._puts, self._group_fault, self._armed = n, group_fault, False

    def before_execute(self, site):
        if site.startswith(("group:", "group-chain:")) and not self._armed:
            self._armed = True
            if self._group_fault:
                self._record("stage", site)
                raise TransientStageError(f"injected group fault at {site}")

    def on_store_op(self, op, key):
        if self._armed and self._puts and op == "put" and key.endswith("@36"):
            self._puts -= 1
            self._record("outage", f"{op}:{key}")
            raise StoreOutageError(f"injected store outage at {op} {key}")


def cross_tier_run(inj):
    """Four siblings forked at step 12 whose chains run two stages, 12 →
    24 → 36, on one worker: the first chain takes the shared prefix and
    one sibling, the other three then run as one depth-2 group chain."""
    trials = [T.Trial(T.HpConfig({"lr": T.MultiStep(
        0.1, [12, 24], values=[0.1, v, 0.01])}), 36)
        for v in (0.05, 0.03, 0.02, 0.01)]
    svc = StudyService(SearchPlanDB(), OneUlpGroupSim(horizon=36),
                       n_workers=1, fault_injector=inj, batch_siblings=True)
    svc.submit(StudySpec("m", "d", ("lr",)), GridTuner(trials))
    stats = svc.close()
    store = raw_store(svc._engine.store)
    leaves = {(nid, st): store.get(cid)
              for nid, node in svc._engine.plan.nodes.items()
              for st, cid in node.ckpts.items() if store.contains(cid)}
    return stats, leaves


@pytest.mark.parametrize("case", ["group member retried solo",
                                  "degraded members retried as a group"])
def test_retry_across_group_tiers_keeps_the_bitwise_check(case):
    """A member of a depth-2 group chain fails alone at its second
    boundary's put, after its first boundary committed on one tier; its
    retry runs on the other tier (solo after a group, a group after a
    degraded solo run).  The committed boundary is taken back, so the
    retry commits afresh and ``_assert_retry_identical`` — bitwise, with no
    tolerance — never compares the two tiers' bits: the study finishes
    with every leaf and best result of the fault-free run's tier."""
    degraded = case.startswith("degraded")
    inj = BoundaryOutage(n=2 if degraded else 1, group_fault=degraded)
    got, leaves = cross_tier_run(inj)
    clean, clean_leaves = cross_tier_run(None)
    assert clean.batched_groups == 1 and clean.steps_run == 36 + 3 * 24
    assert inj.by_kind["outage"] == (2 if degraded else 1)
    assert got.groups_degraded == int(degraded)
    assert got.stage_retries == (2 if degraded else 1)
    assert got.stage_failures == got.stage_retries + int(degraded)
    assert got.batched_groups == 1 and got.steps_run == clean.steps_run
    assert inj.retries_verified == 0
    # the retried members computed on the other tier: a leaf differs
    # from the fault-free group's by its tier's ulp, never more
    assert leaves.keys() == clean_leaves.keys()
    for key, s in leaves.items():
        c = clean_leaves[key]["progress"]
        assert s["progress"] in (c, float(np.nextafter(c, -np.inf)),
                                 float(np.nextafter(c, np.inf))), key

# ---------------------------------------------------------------------------
# the launcher: kill / restore, graceful shutdown, fault injection
# ---------------------------------------------------------------------------

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_KILLED_SCRIPT = """
import os, signal, sys
sys.path.insert(0, {src!r})
from repro_torch.core import (Constant, Exponential, SearchPlanDB, StepLR,
                              StudyService, StudySpec, Warmup)
from repro_torch.core.trainer import SimulatedTrainer
from repro_torch.core.tuners import GridSearchSpace, GridTuner

space = GridSearchSpace(fns={{
    "lr": [StepLR(0.1, 0.1, [30]), StepLR(0.1, 0.1, [40]),
           Warmup(5, 0.1, Exponential(0.1, 0.95))],
    "bs": [Constant(64), Constant(128)]}})
spec = StudySpec("m", "d", ("lr", "bs"))
svc = StudyService(SearchPlanDB(), SimulatedTrainer(horizon=80),
                   n_workers=2, policy="fair_share")
svc.enable_auto_snapshot({base!r}, every=25.0, keep=3)
svc.submit(spec, GridTuner(space.trials(80)))
svc.submit(spec, GridTuner(space.trials(80)[:4]), at=200.0)
n = 0
while svc.step():
    n += 1
    if n == {kill_after}:
        os.kill(os.getpid(), signal.SIGKILL)   # no atexit, no flush
raise SystemExit("ran to completion before the kill point")
"""


def test_sigkill_then_restore_finishes_identically(tmp_path):
    """SIGKILL mid-drain (no graceful path at all), then restore from the
    newest readable rotation slot and finish: final EngineStats — by_study
    included — match an uninterrupted run, and the JAX package's."""
    from repro_torch.core.engine import session_rotation

    ref, _, _ = run_session(None, n_workers=2)
    base = str(tmp_path / "sess.snap")
    script = tmp_path / "killed.py"
    script.write_text(_KILLED_SCRIPT.format(
        src=os.path.join(REPO, "src"), base=base, kill_after=14))
    proc = subprocess.run([sys.executable, str(script)],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == -signal.SIGKILL, proc.stderr[-2000:]
    assert session_rotation(base), "no snapshot survived the kill"

    svc = StudyService.restore_latest(SearchPlanDB(), base,
                                      SimulatedTrainer(horizon=80))
    got = svc.close()
    assert det(got) == det(ref)
    assert {k: (v.gpu_seconds, v.steps_run, v.instant_results)
            for k, v in got.by_study.items()} == \
           {k: (v.gpu_seconds, v.steps_run, v.instant_results)
            for k, v in ref.by_study.items()}
    jax_ref, _, _ = run_session(None, n_workers=2, C=R, tuners=RT)
    assert fields(det(got)) == fields(det(jax_ref))


def _handles_sigterm(pid):
    """Has process ``pid`` installed a SIGTERM handler yet (Linux
    ``SigCgt``)?"""
    with open(f"/proc/{pid}/status") as f:
        for line in f:
            if line.startswith("SigCgt:"):
                return bool(int(line.split()[1], 16)
                            & (1 << (signal.SIGTERM - 1)))
    return False


def test_sigterm_graceful_shutdown_snapshot(tmp_path):
    """The launcher's SIGTERM handler takes a final gateway snapshot to
    --session before exiting; it resumes to the uninterrupted totals, the
    JAX package's service's too."""
    from repro_torch.frontdoor import StudyGateway
    from repro_torch.launch.serve_studies import _space as launcher_space

    sess = str(tmp_path / "term.snap")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    argv = [sys.executable, "-m", "repro_torch.launch.serve_studies",
            "--studies", "2", "--steps", "60", "--workers", "2",
            "--arrival-gap", "600", "--sec-per-step", "10",
            "--session", sess, "--throttle", "0.25"]
    proc = subprocess.Popen(argv, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        # the handler is installed after the imports: signal once it is
        deadline = time.monotonic() + 120
        while not _handles_sigterm(proc.pid):
            assert proc.poll() is None and time.monotonic() < deadline
            time.sleep(0.05)
        time.sleep(0.6)                    # a few throttled steps in
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        proc.kill()
    assert proc.returncode == 0, out[-2000:]
    assert "SIGTERM: final snapshot" in out
    assert os.path.exists(sess)

    gw = StudyGateway.restore(
        SearchPlanDB(), sess,
        SimulatedTrainer(base_seconds_per_step=10.0, horizon=60))
    gw.join()
    [(_, got)] = gw.close()

    def direct(C, tuners, space_fn):
        svc = C.StudyService(C.SearchPlanDB(), C.SimulatedTrainer(
            base_seconds_per_step=10.0, horizon=60), n_workers=2)
        spec = C.StudySpec("resnet20", "cifar10", ("lr", "bs"))
        for i in range(2):
            svc.submit(spec, tuners.GridTuner(space_fn(i, 60).trials(60)),
                       at=i * 600.0)
        return svc.close()

    from repro.launch.serve_studies import _space as ref_space
    assert det(got) == det(direct(T, TT, launcher_space))
    assert fields(det(got)) == fields(det(direct(R, RT, ref_space)))


SERVE_FAULTS = ["serve_studies", "--studies", "2", "--workers", "4",
                "--steps", "60", "--arrival-gap", "600",
                "--sec-per-step", "10", "--inject-faults", "7",
                "--fault-rates", "0.3,0.15,0.02"]


def test_serve_studies_inject_faults(monkeypatch, capsys):
    """The launcher's fault plane: it reports the faults it injected, and
    every line it prints is the JAX package's launcher's."""
    from repro.launch import serve_studies as ref_launcher
    from repro_torch.launch import serve_studies

    monkeypatch.setattr(sys, "argv", list(SERVE_FAULTS))
    serve_studies.main()
    out = capsys.readouterr().out
    assert "fault plane:" in out
    assert "served:" in out
    ref_launcher.main()
    assert capsys.readouterr().out == out


def test_serve_studies_refuses_devices_per_worker(monkeypatch):
    """Two devices a worker over the PyTorch trainer: the gateway is built
    with every slot a 2-device mesh and serves real training on them
    (every shard a CPU tensor); the trainer's placement gate rejects a
    mesh that shards nothing."""
    from repro_torch.launch import serve_studies

    built = []

    def backend():
        built.append(tiny_backend())
        return built[-1]

    def submit_one(gw, args, tenants):
        gw.submit(serve_studies.StudySpec("tiny", "d", ("lr",)),
                  GridTuner([Trial(HpConfig({"lr": Constant(0.1)}), 8)]),
                  tenant=tenants[0])

    monkeypatch.setattr(serve_studies, "_submit_all", submit_one)
    (_, stats), = serve_studies.main(
        ["--studies", "1", "--workers", "2", "--devices-per-worker", "2"],
        backend=backend)
    assert stats.mesh_placements > 0 and stats.steps_run == 8
    assert len(built) == 1 and built[0].exec_calls > 0
    assert built[0]._wmesh.n_devices == 2
    assert not built[0].mesh_compatible(WorkerMesh.build([0, 1, 2]), [])
