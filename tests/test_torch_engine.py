"""Execution engine of the PyTorch package held against the JAX package.

Over ``SimulatedTrainer`` (pure Python in both packages) the whole engine —
search plan, stage trees, scheduler, dispatcher, aggregator, tuners, study
service — must produce ``EngineStats`` equal **field for field**, per-study
breakdown included; only the wall-clock timers ``ckpt_save_seconds`` /
``ckpt_load_seconds`` are left out.  Over ``TorchTrainer(device="cpu")`` a
small SHA study runs end to end (ports of ``tests/test_system.py``), on
the memory tier and on the serialized tiers alike, and the option this
package does not have yet (``worker_meshes``) must raise, not be ignored.  The
sibling-group pass (``batch_siblings=True``, with chain fusion on and off)
and the ASHA / Hyperband / median-stopping / PBT tuners are held to the
reference field for field as well.
"""

import dataclasses
import os
import tempfile

import numpy as np
import pytest
import torch

import repro.core as R
import repro.core.tuners as RT
import repro_torch.core as T
import repro_torch.core.tuners as TT
from repro.core.trainer import SimulatedTrainer as RefSimulatedTrainer
from repro.train.checkpoint import CheckpointStore as RefCheckpointStore
from repro.train.checkpoint import DirectoryObjectStore as RefObjectStore
from repro_torch.core.trainer import SimulatedTrainer
from repro_torch.data import DataPipeline, synthetic_cifar
from repro_torch.dist.meshes import WorkerMesh
from repro_torch.models.resnet import ResNet
from repro_torch.train.checkpoint import CheckpointStore, DirectoryObjectStore
from repro_torch.train.torch_trainer import TorchTrainer
from repro_torch.utils.tree import tree_leaves

# the suite runs several worker processes side by side: one intra-op
# thread each, or the workers fight over the cores
torch.set_num_threads(1)

WALL_CLOCK = ("ckpt_save_seconds", "ckpt_load_seconds")


class Side:
    def __init__(self, core, tuners, sim, store, remote):
        self.core, self.tuners, self.sim, self.store = core, tuners, sim, store
        self.remote = remote


REF = Side(R, RT, RefSimulatedTrainer, RefCheckpointStore, RefObjectStore)
PORT = Side(T, TT, SimulatedTrainer, CheckpointStore, DirectoryObjectStore)


def det(stats):
    """Every EngineStats field but the wall-clock timers, by_study as dicts."""
    d = dataclasses.asdict(stats)
    for k in WALL_CLOCK:
        d.pop(k)
    return d


def engine_space(side):
    C = side.core
    return side.tuners.GridSearchSpace(
        fns={"lr": [C.Constant(0.1), C.StepLR(0.1, 0.1, [100, 150]),
                    C.Warmup(5, 0.1, C.StepLR(0.1, 0.1, [90, 135])),
                    C.Warmup(5, 0.1, C.Exponential(0.1, 0.95))],
             "bs": [C.Constant(128),
                    C.MultiStep(128, [70], values=[128, 256])]})


def quickstart_space(side):
    C = side.core
    return side.tuners.GridSearchSpace(
        fns={"lr": [C.StepLR(0.1, 0.1, [90, 135]),
                    C.StepLR(0.1, 0.1, [100, 150]),
                    C.Warmup(5, 0.1, C.StepLR(0.1, 0.1, [90, 135])),
                    C.Warmup(5, 0.1, C.Exponential(0.1, 0.95))],
             "bs": [C.Constant(128),
                    C.MultiStep(128, [70], values=[128, 256])]},
        static={"wd": [1e-4, 1e-3]})


def make_tuner(side, kind, trials, steps):
    if kind == "grid":
        return side.tuners.GridTuner(trials)
    return side.tuners.SHATuner(trials, min_steps=25, max_steps=steps, eta=2)


def tuner_outcome(tuner):
    best = getattr(tuner, "best", None)
    return (tuner.is_done(), getattr(best, "trial_id", None),
            getattr(tuner, "best_score", None))


# ------------------------------------------------------------------ scenarios


def single_study(side, kind, share, n_workers=8, steps=200, **kw):
    db = side.core.SearchPlanDB()
    st = side.core.Study.create(db, "m", "d", ("lr", "bs"))
    tuner = make_tuner(side, kind, engine_space(side).trials(steps), steps)
    stats = st.run(tuner, side.sim(), n_workers=n_workers, share=share, **kw)
    plan = db.get(st.key)
    return det(stats), tuner_outcome(tuner), sorted(plan.nodes), \
        plan.pending_requests()


def quickstart(side, share):
    C = side.core
    trials = quickstart_space(side).trials(200)
    spec = C.StudySpec("resnet56", "cifar10", ("lr", "bs", "wd"))
    svc = C.StudyService(C.SearchPlanDB(),
                         side.sim(base_seconds_per_step=60), n_workers=8,
                         share=share)
    fut = svc.submit(spec, side.tuners.GridTuner(list(trials)))
    stats = svc.close()
    return det(stats), fut.done(), C.merge_rate(trials)


def multi_study(side, share):
    C = side.core
    db = C.SearchPlanDB()
    studies = []
    # different horizons: distinct trial ids, shared prefixes
    for kind, steps in (("grid", 150), ("sha", 200)):
        st = C.Study.create(db, "m", "d", ("lr", "bs"))
        studies.append((st, make_tuner(side, kind,
                                       engine_space(side).trials(steps),
                                       steps)))
    stats = C.run_studies(studies, side.sim(), n_workers=6, share=share)
    return det(stats), [tuner_outcome(t) for _, t in studies]


def staggered_service(side, policy):
    C = side.core
    spec = C.StudySpec("m", "d", ("lr", "bs"))
    store = side.store()
    with C.StudyService(C.SearchPlanDB(), side.sim(), n_workers=4,
                        policy=policy, store=store) as svc:
        f1 = svc.submit(spec, make_tuner(side, "sha",
                                         engine_space(side).trials(160), 160))
        f2 = svc.submit(spec, make_tuner(side, "grid",
                                         engine_space(side).trials(120), 120),
                        at=900.0)
        svc.run_until(400.0)
        mid = (svc.time, f1.status, f2.status, det(svc.stats))
        f3 = svc.submit(spec, make_tuner(side, "grid",
                                         engine_space(side).trials(80), 80),
                        study_id="late")
        one = dataclasses.asdict(f1.result())
    return (mid, one, det(svc.stats), [f.status for f in (f1, f2, f3)],
            len(store), store.puts, store.gets, store.pending_writes)


def cancel_mid_run(side):
    C = side.core
    spec = C.StudySpec("m", "d", ("lr", "bs"))
    store = side.store()
    svc = C.StudyService(C.SearchPlanDB(), side.sim(), n_workers=3,
                         store=store)
    keep = svc.submit(spec, make_tuner(side, "grid",
                                       engine_space(side).trials(100)[:3],
                                       100))
    drop = svc.submit(spec, make_tuner(side, "grid",
                                       engine_space(side).trials(200), 200))
    svc.run_until(150.0)
    assert drop.cancel()
    stats = svc.close()
    return det(stats), keep.status, drop.status, len(store)


class _FusingSim:
    """Mixin: claim chain fusion so the dispatcher takes ``_run_chain_fused``
    (the default ``run_chain`` loop is semantically the per-stage path)."""
    supports_chain_fusion = True


def fused_over_simulator(side, share, store=None):
    sim = type("FusingSim", (_FusingSim, side.sim), {})
    C = side.core
    db = C.SearchPlanDB()
    st = C.Study.create(db, "m", "d", ("lr", "bs"))
    store = side.store() if store is None else store
    tuner = make_tuner(side, "sha", engine_space(side).trials(200), 200)
    stats = st.run(tuner, sim(), n_workers=4, share=share, store=store,
                   max_steps_per_chain=90)
    return det(stats), tuner_outcome(tuner), store.pending_writes, \
        store.async_puts


BYTE_FIELDS = {"full": "ckpt_full_bytes", "delta": "ckpt_delta_bytes"}


def on_directory(side, scenario, remote=False):
    """``scenario(store)`` over a directory store of ``side``'s package
    (with ``remote``: a remote tier below and room for one blob on the
    directory).  Write-behind commits land inside ``put_async`` (a flush
    after each), so which tier serves a read is deterministic.  The byte
    fields of ``EngineStats`` leave out each blob's tree section, the one
    part of a blob the packages write differently (``tree_len`` bytes, and
    its decimal digits in the header)."""
    with tempfile.TemporaryDirectory() as d:
        store = side.store(
            os.path.join(d, "disk"),
            remote=side.remote(os.path.join(d, "remote")) if remote else None,
            disk_capacity_bytes=1 if remote else None)
        framing = {"full": 0, "delta": 0}
        publish, put_async = store._publish_disk, store.put_async

        def tracked_publish(cid, staged):
            with open(staged.tmp, "rb") as f:
                hdr, _ = store._parse_header(f.read())
            framing[hdr["kind"]] += hdr["tree_len"] + len(str(hdr["tree_len"]))
            publish(cid, staged)

        def put_and_flush(*args, **kw):
            cid = put_async(*args, **kw)
            store.flush()
            return cid
        store._publish_disk, store.put_async = tracked_publish, put_and_flush
        out = scenario(store)
        stats = out[0]
        for kind, field in BYTE_FIELDS.items():
            stats[field] -= framing[kind]
        for field in ("ckpt_bytes_written", "ckpt_logical_bytes"):
            stats[field] -= sum(framing.values())
        assert stats["ckpt_bytes_written"] > 0
        if remote:
            assert stats["ckpt_tier_demotions"] > 0
        return out + (len(store), store.tier_promotions)


def batched_siblings(side, chain_fusion, kind="sha", n_workers=2, **kw):
    """``batch_siblings=True`` over the simulator (its batched calls run
    members in turn, so groups change only the dispatch) on a space whose
    siblings fork together at step 60, where SHA's first rung leaves their
    checkpoint: stats and every plan node's metrics."""
    sim = type("FusingSim", (_FusingSim, side.sim), {}) if chain_fusion \
        else side.sim
    C = side.core
    space = side.tuners.GridSearchSpace(fns={
        "lr": [C.MultiStep(0.1, [60], values=[0.1, v])
               for v in (0.05, 0.02, 0.01, 0.005)],
        "bs": [C.Constant(128), C.MultiStep(128, [120], values=[128, 256])]})
    db = C.SearchPlanDB()
    st = C.Study.create(db, "m", "d", ("lr", "bs"))
    trials = space.trials(240)
    tuner = side.tuners.GridTuner(trials) if kind == "grid" else \
        side.tuners.SHATuner(trials, min_steps=60, max_steps=240, eta=2)
    stats = st.run(tuner, sim(), n_workers=n_workers, batch_siblings=True,
                   chain_fusion=chain_fusion, **kw)
    plan = db.get(st.key)
    assert stats.batched_groups > 0 and stats.batched_stages > 0
    return det(stats), tuner_outcome(tuner), \
        {nid: n.metrics for nid, n in plan.nodes.items()}


def tuner_study(side, name):
    """Each of the four tuners ported with this slice, over the
    simulator."""
    C, TN = side.core, side.tuners
    db = C.SearchPlanDB()
    st = C.Study.create(db, "m", "d", ("lr", "bs"))
    trials = engine_space(side).trials(200)
    tuner = {
        "asha": lambda: TN.ASHATuner(trials, min_steps=25, max_steps=200,
                                     eta=2),
        "hyperband": lambda: TN.HyperbandTuner(trials, max_steps=200, eta=4),
        "median": lambda: TN.MedianStoppingTuner(
            trials, milestones=[50, 100, 200]),
        "pbt": lambda: TN.PBTTuner(
            [C.HpConfig({"lr": C.Constant(v), "bs": C.Constant(128)})
             for v in (0.2, 0.1, 0.05, 0.01)], interval=20, generations=4),
    }[name]()
    stats = st.run(tuner, side.sim(), n_workers=4)
    best = getattr(tuner, "best", None)
    plan = db.get(st.key)
    return det(stats), tuner.is_done(), getattr(best, "trial_id", None), \
        getattr(tuner, "best_score", None), sorted(plan.nodes)


SCENARIOS = {
    "grid-share": lambda s: single_study(s, "grid", True),
    "grid-trial": lambda s: single_study(s, "grid", False),
    "sha-share": lambda s: single_study(s, "sha", True),
    "sha-trial": lambda s: single_study(s, "sha", False),
    "sha-2workers-truncated": lambda s: single_study(
        s, "sha", True, n_workers=2, max_steps_per_chain=30),
    "grid-weighted-paths": lambda s: single_study(
        s, "grid", True, n_workers=3, weighted_paths=True),
    "quickstart-share": lambda s: quickstart(s, True),
    "quickstart-trial": lambda s: quickstart(s, False),
    "multi-study-share": lambda s: multi_study(s, True),
    "multi-study-trial": lambda s: multi_study(s, False),
    "cancel-mid-run": cancel_mid_run,
    "chain-fused-share": lambda s: fused_over_simulator(s, True),
    "chain-fused-trial": lambda s: fused_over_simulator(s, False),
}
SCENARIOS.update({
    "batched-siblings": lambda s: batched_siblings(s, False),
    "batched-siblings-chain-fused": lambda s: batched_siblings(s, True),
    "batched-siblings-grid-chain-fused": lambda s: batched_siblings(
        s, True, kind="grid", n_workers=1),
    "batched-siblings-chain-fused-truncated": lambda s: batched_siblings(
        s, True, max_steps_per_chain=30),
})
SCENARIOS.update({f"tuner-{t}": (lambda s, t=t: tuner_study(s, t))
                  for t in ("asha", "hyperband", "median", "pbt")})
SCENARIOS.update({
    "directory-sha-share": lambda s: on_directory(
        s, lambda store: single_study(s, "sha", True, store=store)),
    "directory-remote-sha-trial": lambda s: on_directory(
        s, lambda store: single_study(s, "sha", False, store=store),
        remote=True),
    "directory-chain-fused-share": lambda s: on_directory(
        s, lambda store: fused_over_simulator(s, True, store=store)),
})
SCENARIOS.update({f"service-staggered-{p}":
                  (lambda s, p=p: staggered_service(s, p))
                  for p in sorted(R.POLICIES)})


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_engine_stats_equal_field_for_field(name):
    ref = SCENARIOS[name](REF)
    port = SCENARIOS[name](PORT)
    assert port == ref
    first = port[0] if isinstance(port[0], dict) else port[0][3]
    assert first["steps_run"] > 0 and first["gpu_seconds"] > 0


def test_engine_stats_fields_are_the_reference_fields():
    """All fields kept, so later slices only fill them."""
    names = lambda cls: [f.name for f in dataclasses.fields(cls)]
    assert names(T.EngineStats) == names(R.EngineStats)
    assert names(T.StudyStats) == names(R.StudyStats)
    assert T.EngineStats().dedup_ratio == 1.0 and T.EngineStats().gpu_hours == 0


# --------------------------------------------------- real training on the CPU


@pytest.fixture(scope="module")
def backend():
    data = synthetic_cifar(256, seed=0)
    eval_data = synthetic_cifar(128, seed=1)
    return TorchTrainer(ResNet(n=1, width=8),
                        lambda: DataPipeline(data, batch_size=32, seed=3),
                        eval_data, default_optimizer="momentum", device="cpu")


def small_space():
    return TT.GridSearchSpace(fns={
        "lr": [T.Constant(0.05),
               T.MultiStep(0.05, [10], values=[0.05, 0.005]),
               T.MultiStep(0.05, [10], values=[0.05, 0.02]),
               T.MultiStep(0.05, [16], values=[0.05, 0.005])],
        "bs": [T.Constant(32)]})


def test_single_study_stage_vs_trial(backend):
    trials = small_space().trials(24)
    assert T.merge_rate(trials) > 1.5                 # the space does share
    st1 = T.Study.create(T.SearchPlanDB(), "resnet8", "synth", ("lr", "bs"))
    stage = st1.run(TT.GridTuner(small_space().trials(24)), backend,
                    n_workers=2)
    st2 = T.Study.create(T.SearchPlanDB(), "resnet8", "synth", ("lr", "bs"))
    trial = st2.run(TT.GridTuner(small_space().trials(24)), backend,
                    n_workers=2, share=False)
    assert stage.steps_run < trial.steps_run
    assert trial.steps_run == 4 * 24
    # one worker never re-derives a prefix to keep a second one busy (which
    # measured step times may make the critical path prefer): exactly the
    # unique steps — shared prefix [0,16) + per-trial tails
    st3 = T.Study.create(T.SearchPlanDB(), "resnet8", "synth", ("lr", "bs"))
    solo = st3.run(TT.GridTuner(small_space().trials(24)), backend,
                   n_workers=1)
    assert solo.steps_run == (24 + 14 + 14 + 8)
    assert solo.steps_run <= stage.steps_run


def test_multi_study_shares_across_studies(backend):
    db = T.SearchPlanDB()
    s1 = T.Study.create(db, "resnet8", "synth", ("lr", "bs"))
    s2 = T.Study.create(db, "resnet8", "synth", ("lr", "bs"))
    stats = T.run_studies(
        [(s1, TT.GridTuner(small_space().trials(24))),
         (s2, TT.GridTuner(small_space().trials(24)))],
        backend, n_workers=1)
    # study 2 is identical to study 1 → costs nothing extra in steps
    assert stats.steps_run == (24 + 14 + 14 + 8)
    assert stats.by_study["study-0"].steps_run == \
        stats.by_study["study-1"].steps_run == stats.steps_run


class RecordingSHA(TT.SHATuner):
    """SHA that keeps every (trial, step) -> metrics it was told."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.history = {}

    def on_result(self, trial, step, metrics):
        self.history[(trial.trial_id, step)] = dict(metrics)
        super().on_result(trial, step, metrics)


def test_sha_on_real_training_stage_vs_trial(backend):
    """A small SHA study finishes; chain fusion and write-behind
    checkpoints are live; stage-based trains fewer steps than trial-based,
    and — training being deterministic on one device — every metric either
    run reports is bit-equal in the other, so both pick the same best:
    accuracy over a finite eval set ties between different schedules, and
    the tuner breaks ties by position in the search space, not by the
    arrival order of a wall-clock backend."""
    out = {}
    for share in (True, False):
        db = T.SearchPlanDB()
        st = T.Study.create(db, "resnet8", "synth", ("lr", "bs"))
        tuner = RecordingSHA(small_space().trials(24), min_steps=6,
                             max_steps=24, eta=2)
        store = CheckpointStore()
        calls0 = backend.exec_calls
        stats = st.run(tuner, backend, n_workers=2, share=share, store=store)
        assert tuner.is_done() and tuner.best is not None
        assert np.isfinite(tuner.best_score)
        assert stats.chain_fused_stages > 0
        assert stats.ckpt_async_writes == stats.ckpt_saves > 0
        assert store.pending_writes == 0          # close() flushed
        assert stats.kernel_calls == 0 and stats.kernel_fallbacks == 0
        assert backend.exec_calls > calls0
        for cid in store.committed_ids():
            for leaf in tree_leaves(store.get(cid)["params"]):
                assert bool(leaf.isfinite().all())
        out[share] = (stats, tuner)
    assert out[True][0].steps_run < out[False][0].steps_run
    assert out[True][1].history == out[False][1].history
    assert out[True][1].best_score == out[False][1].best_score
    assert out[True][1].best.trial_id == out[False][1].best.trial_id


def recorded_puts(side, run):
    """``(cid, parent_cid)`` of every boundary put ``run(store)`` makes on
    a memory store of ``side``'s package, in order."""
    puts = []

    class Recording(side.store):
        def put(self, path_key, step, tree, parent_cid=None):
            puts.append((self.ckpt_id(path_key, step), parent_cid))
            return super().put(path_key, step, tree, parent_cid=parent_cid)

        def put_async(self, path_key, step, tree, parent_cid=None):
            puts.append((self.ckpt_id(path_key, step), parent_cid))
            return super().put_async(path_key, step, tree,
                                     parent_cid=parent_cid)
    run(Recording())
    return puts


PUT_RUNS = {
    "per-stage": lambda s, store: single_study(
        s, "sha", True, n_workers=2, store=store),
    "chain-fused": lambda s, store: fused_over_simulator(s, True,
                                                         store=store),
    "groups": lambda s, store: batched_siblings(s, False, store=store),
    "groups-chain-fused": lambda s, store: batched_siblings(
        s, True, store=store),
}


@pytest.mark.parametrize("name", sorted(PUT_RUNS))
def test_boundary_puts_carry_the_reference_parents(name):
    """The dispatcher threads ``parent_cid`` to every boundary put as the
    reference does: the fork point for a chain's first boundary, then each
    previous boundary, and each group member's own fork point."""
    ref = recorded_puts(REF, lambda st: PUT_RUNS[name](REF, st))
    port = recorded_puts(PORT, lambda st: PUT_RUNS[name](PORT, st))
    assert port == ref
    assert sum(p is not None for _, p in port) > 0


@pytest.mark.parametrize("share", [True, False], ids=["stage", "trial"])
def test_directory_store_study_equals_memory_tier(backend, share, tmp_path):
    """On the CPU trainer a study whose checkpoints live on a directory
    with a remote tier below (room for one blob) reports every metric bit
    for bit as the memory-tier study does, trains the same steps and picks
    the same best trial; its resumes read blobs back from the tiers."""
    out = {}
    for tier in ("memory", "directory"):
        store = CheckpointStore() if tier == "memory" else CheckpointStore(
            str(tmp_path / "disk"),
            remote=DirectoryObjectStore(str(tmp_path / "remote")),
            disk_capacity_bytes=1)
        tuner = RecordingSHA(small_space().trials(24), min_steps=6,
                             max_steps=24, eta=2)
        st = T.Study.create(T.SearchPlanDB(), "resnet8", "synth",
                            ("lr", "bs"))
        stats = st.run(tuner, backend, n_workers=1, share=share, store=store)
        out[tier] = (stats, tuner, store)
    (m_stats, m_tuner, _), (d_stats, d_tuner, d_store) = out.values()
    assert d_tuner.history == m_tuner.history
    assert d_stats.steps_run == m_stats.steps_run
    assert d_tuner.best.trial_id == m_tuner.best.trial_id
    assert d_stats.ckpt_bytes_written > 0 and d_store.tier_demotions > 0
    assert d_stats.ckpt_disk_hits + d_stats.ckpt_remote_hits > 0
    assert d_stats.ckpt_loads == m_stats.ckpt_loads > 0


def test_restored_tree_unchanged_by_resumed_stage(backend, tmp_path):
    """A tree restored from the directory (shared with the read cache) is
    not written by a stage resumed from it, on any entry: its bytes equal
    a fresh read of the blob afterwards, and the resumed stage equals the
    same stage run from the state that was saved."""
    store = CheckpointStore(str(tmp_path))
    desc = {"hps": {"lr": {"kind": "const", "value": 0.05}}, "static": {}}
    ctx = lambda s0, s1: T.StageContext("n", desc, 0, s0, s1, "n")
    saved = backend.run_stage(backend.init_state(), ctx(0, 4))
    cid = store.put("pk", 4, saved)
    store._read_cache.clear()
    restored = store.get(cid)
    assert all(not x.is_pinned() and x.device.type == "cpu"
               for x in tree_leaves(restored["params"]))
    outs = [backend.run_stage(restored, ctx(4, 8)),
            backend.run_chain(restored, [ctx(4, 6), ctx(6, 8)])[-1],
            backend.run_stage_stepwise(restored, ctx(4, 8)),
            backend.run_stages_batched([restored, restored],
                                       [ctx(4, 8), ctx(4, 8)])[0]]
    backend.evaluate(restored, ctx(4, 8))
    fresh = store._read_disk(cid)
    for a, b in zip(tree_leaves(restored), tree_leaves(fresh), strict=True):
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else a == b)
    expect = backend.run_stage(saved, ctx(4, 8))
    for out in outs:
        for a, b in zip(tree_leaves(out["params"]),
                        tree_leaves(expect["params"])):
            assert torch.equal(a, b)
    assert store.get(cid) is restored


def test_on_device_moves_restored_leaves_once(backend, monkeypatch):
    """``on_device`` moves every tensor leaf of a state to the trainer's
    device (``meta`` here: a device that is not the CPU), a leaf shared by
    two states once; Python leaves stay as they are; a state already there
    passes through as itself.  Every entry that takes a state calls it
    before training or evaluating."""
    meta = TorchTrainer(backend.task, backend.pipeline_factory,
                        synthetic_cifar(4, seed=1), device="meta")
    state = backend.init_state()
    clone = backend.clone_state(state)
    a, b = meta.on_device(state, clone)
    assert all(x.device.type == "meta" for x in tree_leaves(a["params"]))
    assert all(x is y for x, y in zip(tree_leaves(a["params"]),
                                      tree_leaves(b["params"])))
    assert a["data"] == state["data"] and a["step"] == 0
    assert meta.on_device(a)[0] is a
    assert backend.on_device(state)[0] is state      # the CPU's own state

    calls = []
    real = TorchTrainer.on_device

    def spy(self, *states):
        calls.append(len(states))
        return real(self, *states)
    monkeypatch.setattr(TorchTrainer, "on_device", spy)
    desc = {"hps": {"lr": {"kind": "const", "value": 0.05}}, "static": {}}
    ctx = lambda s0, s1: T.StageContext("n", desc, 0, s0, s1, "n")
    s0 = backend.init_state()
    entries = {
        "run_stage": lambda: backend.run_stage(s0, ctx(0, 2)),
        "run_chain": lambda: backend.run_chain(s0, [ctx(0, 1), ctx(1, 2)]),
        "run_stages_batched": lambda: backend.run_stages_batched(
            [s0, s0], [ctx(0, 2), ctx(0, 2)]),
        "run_chains_batched": lambda: backend.run_chains_batched(
            [s0, s0], [[ctx(0, 1), ctx(1, 2)]] * 2),
        "run_stage_stepwise": lambda: backend.run_stage_stepwise(
            s0, ctx(0, 2)),
        "evaluate": lambda: backend.evaluate(s0, ctx(0, 2))}
    for name, call in entries.items():
        calls.clear()
        call()
        assert calls and calls[0] == (2 if "batched" in name else 1), name


# ------------------------------------------------------- NotImplemented gates


@pytest.mark.parametrize("kw", [{"worker_meshes": [None]}],
                         ids=["worker_meshes"])
def test_engine_refuses_options_of_unported_planes(kw, backend):
    """No plane is left unported: a ``TorchTrainer`` engine takes a worker
    mesh wider than one device when it is built (on a CPU trainer every
    shard is a tensor on the CPU), a study runs on it with its stages
    placed on the mesh, and ``add_worker`` takes another; the placement
    gate rejects a mesh that shards nothing (7 devices divide no dimension
    of the ResNet); a one-device mesh and the simulator's wide meshes are
    accepted as before."""
    wide = {k: [WorkerMesh.build([0, 1])] for k in kw}
    plan = T.SearchPlan("gate")
    try:
        eng = T.ExecutionEngine(plan, backend, **wide)
        assert eng.workers[0].devices == 2
        st = T.Study.create(T.SearchPlanDB(), "m", "d", ("lr",))
        stats = st.run(TT.GridTuner([T.Trial(T.HpConfig(
            {"lr": T.Constant(0.05)}), 4)]), backend, **wide)
        assert stats.mesh_placements > 0 and stats.steps_run == 4
        assert backend._wmesh == WorkerMesh.build([0, 1])
        eng.add_worker(mesh=WorkerMesh.build([2, 3]))
        assert eng.workers[-1].mesh == WorkerMesh.build([2, 3])
        assert backend.mesh_compatible(WorkerMesh.build([0, 1]), [])
        assert not backend.mesh_compatible(WorkerMesh.build(range(7)), [])
    finally:
        backend.set_mesh(None)           # the fixture is the module's
    eng = T.ExecutionEngine(plan, backend,
                            **{k: [WorkerMesh.build([0])] for k in kw})
    assert eng.workers[0].mesh == WorkerMesh.build([0])
    eng = T.ExecutionEngine(plan, SimulatedTrainer(), **wide)
    assert eng.workers[0].devices == 2


def test_trainer_refuses_batched_tiers_and_missing_gpu(backend):
    """The batched tiers exist now and refuse only groups that cannot run
    as one (a ``ValueError``, which the dispatcher answers with
    member-sequential chains); no GPU still refuses ``device=None``."""
    assert backend.supports_batched_stages is True
    assert backend.supports_chain_fusion is True
    assert backend.vectorize_groups is False          # the CPU's tier
    desc = {"hps": {"lr": {"kind": "const", "value": 0.05}}, "static": {}}
    ctx = lambda s0, s1, n: T.StageContext(n, desc, 0, s0, s1, n)
    states = [backend.init_state(), backend.init_state()]
    with pytest.raises(ValueError, match="start, stop"):
        backend.run_stages_batched(states, [ctx(0, 4, "a"), ctx(0, 6, "b")])
    with pytest.raises(ValueError, match="depth"):
        backend.run_chains_batched(states, [[ctx(0, 4, "a"), ctx(4, 8, "a")],
                                            [ctx(0, 4, "b")]])
    if not torch.cuda.is_available():
        # device=None means "cuda": no silent CPU run
        with pytest.raises(RuntimeError, match="CUDA"):
            TorchTrainer(backend.task, backend.pipeline_factory,
                         synthetic_cifar(8, seed=1))


def test_service_key_mismatch_and_closed_session():
    svc = T.StudyService(T.SearchPlanDB(), SimulatedTrainer(), n_workers=2)
    a = T.StudySpec("m", "d", ("lr",))
    svc.submit(a, TT.GridTuner([T.Trial(T.HpConfig({"lr": T.Constant(0.1)}),
                                        10)]))
    with pytest.raises(T.PlanKeyMismatch) as ei:
        svc.submit(T.StudySpec("m2", "d", ("lr",)), TT.GridTuner([]))
    assert ei.value.session_key == a.key
    svc.close()
    with pytest.raises(RuntimeError):
        svc.submit(a, TT.GridTuner([]))
    with pytest.raises(ValueError):
        T.run_studies(
            [(T.Study.create(svc.db, "m", "d", ("lr",)), TT.GridTuner([])),
             (T.Study.create(svc.db, "x", "d", ("lr",)), TT.GridTuner([]))],
            SimulatedTrainer())


# ------------------------------------------------------- a leased fleet


def fleet(side):
    """Workers in a row: ``(wid, idle, draining, busy_until)``."""
    return [(w.wid, w.idle, w.draining, w.busy_until)
            for w in side.engine.workers]


def fleet_moves(side, n_workers):
    """One session under a fixed grant / revoke script (the front door's
    moves, made by hand): a grant that may not start before ``at``, a busy
    worker revoked (it drains to its chain boundary), an idle one removed
    at once, two more grants; returns the fleet after every move and the
    final stats."""
    C = side.core
    svc = C.StudyService(C.SearchPlanDB(), side.sim(), n_workers=n_workers)
    svc.submit(C.StudySpec("m", "d", ("lr", "bs")),
               side.tuners.GridTuner(engine_space(side).trials(200)))
    side.engine = eng = svc.engine
    trace = []
    for _ in range(3):
        svc.step()
    trace.append(("grant", eng.add_worker(at=eng.time + 10.0).wid,
                  fleet(side)))
    while all(w.idle for w in eng.workers) and svc.step():
        pass
    busy = [w.wid for w in eng.workers if not w.idle][0]
    trace.append(("revoke busy", eng.remove_worker(busy), fleet(side)))
    idle = [w.wid for w in eng.workers if w.idle and not w.draining]
    if idle:
        trace.append(("remove idle", eng.remove_worker(idle[-1]),
                      fleet(side)))
    while eng.worker(busy) is not None and svc.step():
        trace.append(("step", eng.time, fleet(side)))
    trace.append(("gone", eng.remove_worker(busy), fleet(side)))
    for _ in range(2):
        trace.append(("grant", eng.add_worker().wid, fleet(side)))
    return trace, det(svc.close())


@pytest.mark.parametrize("n_workers", [0, 1, 3])
def test_add_and_remove_workers_equal_the_reference(n_workers):
    """``add_worker`` / ``remove_worker`` / the ``wake`` event / draining:
    the same script gives the reference's fleet after every move and
    ``EngineStats`` equal field for field — from a session spawned with no
    worker (quiescent until the grant wakes it) too."""
    assert fleet_moves(PORT, n_workers) == fleet_moves(REF, n_workers)


def test_draining_worker_takes_no_new_work():
    """A draining worker is skipped by the dispatcher's pool even where it
    shows idle; the other workers take the waiting stages."""
    svc = T.StudyService(T.SearchPlanDB(), SimulatedTrainer(), n_workers=1)
    svc.submit(T.StudySpec("m", "d", ("lr", "bs")),
               TT.GridTuner(engine_space(PORT).trials(200)))
    eng = svc.engine
    svc.step()
    w = eng.workers[0]
    assert not w.idle and eng.remove_worker(w.wid) is False
    w.idle, until = True, w.busy_until
    assert eng.dispatcher.tree_builder.build().stages    # work is waiting
    eng.dispatcher.assign()
    assert w.idle and w.busy_until == until               # none of it here
    eng.workers.remove(w)
    eng.add_worker()
    svc.close()
    assert svc.futures[0].done()


def test_session_with_a_draining_lease_and_wid_gaps_restores(tmp_path):
    """A session captured with a draining worker and a gap in its worker
    ids (a leased fleet) saves, loads and restores as it was: each worker
    under its captured id, new ids past the largest, and the restored run
    finishes equal to the uninterrupted one."""
    from repro_torch.core.engine import (capture_session, load_session,
                                         save_session)

    def session():
        svc = T.StudyService(T.SearchPlanDB(), SimulatedTrainer(),
                             n_workers=3)
        svc.submit(T.StudySpec("m", "d", ("lr", "bs")),
                   TT.GridTuner(engine_space(PORT).trials(200)))
        eng = svc.engine
        eng.add_worker()
        assert eng.remove_worker(1)               # idle: leaves at once
        while all(w.idle for w in eng.workers):
            svc.step()
        busy = [w.wid for w in eng.workers if not w.idle][-1]
        assert eng.remove_worker(busy) is False   # busy: drains
        eng.add_worker(at=eng.time + 5.0)
        return svc, eng

    svc, eng = session()
    wids = [(w.wid, w.draining) for w in eng.workers]
    assert any(d for _, d in wids)
    assert [w for w, _ in wids] != list(range(len(wids)))   # a gap
    path = str(tmp_path / "s.snap")
    save_session(capture_session(eng, service={"futures": svc.futures}),
                 path)
    assert [row[7] for row in load_session(path).workers] == \
        [d for _, d in wids]
    ref = det(svc.close())
    back = T.StudyService.restore(T.SearchPlanDB(), path, SimulatedTrainer())
    assert [(w.wid, w.draining) for w in back.engine.workers] == wids
    assert back.engine._next_wid == eng._next_wid
    assert det(back.close()) == ref
