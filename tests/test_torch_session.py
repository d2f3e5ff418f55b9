"""Durable sessions of the PyTorch package: capture / restore, the v5
container, rotation — ports of the snapshot tests of
``tests/test_faults.py``, ``tests/test_service.py`` and
``tests/test_ckptplane.py``, a restored ``TorchTrainer`` study held bit
for bit to the uninterrupted one, and the container side by side with the
JAX package's (the same manifest, the same record names; a snapshot the
JAX package wrote is refused without importing it).
"""

import dataclasses
import os
import pickle
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import repro.core as R
import repro.core.tuners as RT
import repro_torch.core as T
import repro_torch.core.tuners as TT
from repro_torch.core import SearchPlanDB, StudyService, StudySpec
from repro_torch.core.engine import (capture_session, load_latest_session,
                                     load_session, migrate_session,
                                     restore_engine, save_session,
                                     save_session_rotated, session_rotation)
from repro_torch.core.faults import raw_store
from repro_torch.core.hpseq import (Constant, Exponential, MultiStep,
                                    StepLR, Warmup)
from repro_torch.core.trainer import SimulatedTrainer
from repro_torch.core.tuners import GridSearchSpace, GridTuner, SHATuner
from repro_torch.data import DataPipeline, synthetic_cifar
from repro_torch.dist.meshes import plan_worker_meshes
from repro_torch.frontdoor import decode_snapshot, encode_snapshot
from repro_torch.frontdoor.snapshot_v5 import _read_container
from repro_torch.kernels import ops as kops
from repro_torch.models.resnet import ResNet
from repro_torch.train.checkpoint import CheckpointStore, DirectoryObjectStore
from repro_torch.train.torch_trainer import TorchTrainer
from repro_torch.utils.tree import tree_leaves

# the suite runs several worker processes side by side: one intra-op
# thread each, or the workers fight over the cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = StudySpec("m", "d", ("lr", "bs"))
WALL_CLOCK = ("ckpt_save_seconds", "ckpt_load_seconds")


def det(stats):
    """Deterministic view of EngineStats (the reference's
    ``test_service.det``): wall-clock timers and the physical store's
    counters vary between an uninterrupted run and a restored one;
    everything else, by_study included, must replay exactly."""
    return dataclasses.replace(
        stats, ckpt_save_seconds=0.0, ckpt_load_seconds=0.0,
        ckpt_delta_bytes=0, ckpt_full_bytes=0, ckpt_logical_bytes=0,
        ckpt_bytes_written=0, ckpt_delta_commits=0, ckpt_delta_rebases=0,
        ckpt_mem_hits=0, ckpt_disk_hits=0, ckpt_remote_hits=0,
        ckpt_store_misses=0, ckpt_tier_promotions=0, ckpt_tier_demotions=0,
        ckpt_tmp_reclaimed=0, d2d_handoffs=0)


COUNTS = ("steps_run", "stages_run", "evals_run", "ckpt_saves",
          "ckpt_loads", "ckpt_misses", "ckpt_evictions", "stage_failures",
          "stage_retries", "workers_quarantined", "groups_degraded",
          "faults_injected", "kernel_calls", "kernel_fallbacks")


def counts(stats):
    """The count fields of EngineStats, per study too: a wall-clock
    trainer's seconds (and the virtual clock they drive) differ run to
    run, its counts do not with one worker."""
    return ({k: getattr(stats, k) for k in COUNTS},
            {sid: (s.steps_run, s.stages_run, s.trials)
             for sid, s in stats.by_study.items()})


def fault_space(n_lr: int = 3) -> GridSearchSpace:
    lrs = [StepLR(0.1, 0.1, [30]), StepLR(0.1, 0.1, [40]),
           Warmup(5, 0.1, Exponential(0.1, 0.95))][:n_lr]
    return GridSearchSpace(fns={"lr": lrs,
                                "bs": [Constant(64), Constant(128)]})


def service_space(C=T, tuners=TT):
    return tuners.GridSearchSpace(
        fns={"lr": [C.Constant(0.1), C.StepLR(0.1, 0.1, [100, 150]),
                    C.Warmup(5, 0.1, C.StepLR(0.1, 0.1, [90, 135])),
                    C.Warmup(5, 0.1, C.Exponential(0.1, 0.95))],
             "bs": [C.Constant(128),
                    C.MultiStep(128, [70], values=[128, 256])]})


# ---------------------------------------------------------------------------
# ports of tests/test_faults.py: unique tmp, migration, rotation + fallback
# ---------------------------------------------------------------------------

def _small_session():
    svc = StudyService(SearchPlanDB(), SimulatedTrainer(horizon=80),
                       n_workers=2)
    svc.submit(SPEC, GridTuner(fault_space(1).trials(80)))
    for _ in range(4):
        svc.step()
    return svc, capture_session(svc._engine)


def test_save_session_tmp_is_process_unique(tmp_path, monkeypatch):
    _, state = _small_session()
    seen = []
    real_replace = os.replace

    def spy(src, dst):
        seen.append(src)
        return real_replace(src, dst)

    monkeypatch.setattr(os, "replace", spy)
    save_session(state, str(tmp_path / "s.snap"))
    assert len(seen) == 1
    assert f".tmp.{os.getpid()}." in seen[0]


def test_save_session_cleans_tmp_on_failure(tmp_path, monkeypatch):
    _, state = _small_session()

    def boom(src, dst):
        raise OSError("disk full")

    monkeypatch.setattr(os, "replace", boom)
    with pytest.raises(OSError):
        save_session(state, str(tmp_path / "s.snap"))
    assert list(tmp_path.iterdir()) == []


def test_v2_and_v3_snapshots_migrate():
    svc, state = _small_session()
    # v2: 3-tuple worker rows, none of the newer stats fields
    state.version = 2
    state.workers = [(w[0], w[1], w[2]) for w in state.workers]
    for f in ("stage_failures", "stage_retries", "workers_quarantined",
              "groups_degraded", "faults_injected", "wasted_gpu_seconds"):
        delattr(state.stats, f)
    m = migrate_session(state)
    assert m.version >= 4
    assert all(len(row) == 8 for row in m.workers)
    assert m.workers[0][3] is None          # mesh backfilled
    assert m.workers[0][7] is False         # draining backfilled
    assert m.stats.stage_retries == 0 and m.stats.wasted_gpu_seconds == 0.0

    eng = restore_engine(m, SimulatedTrainer(horizon=80))
    assert [w.failures for w in eng.workers] == [0, 0]

    _, state3 = _small_session()
    state3.version = 3
    state3.workers = [w[:4] for w in state3.workers]
    m3 = migrate_session(state3)
    assert all(len(row) == 8 for row in m3.workers)

    _, state1 = _small_session()
    state1.version = 1
    with pytest.raises(ValueError):
        migrate_session(state1)


def test_rotation_keeps_n_and_falls_back_on_corruption(tmp_path):
    _, state = _small_session()
    base = str(tmp_path / "sess.snap")
    for _ in range(5):
        save_session_rotated(state, base, keep=3)
    slots = session_rotation(base)
    assert [seq for seq, _ in slots] == [5, 4, 3]     # newest first, keep=3

    newest = slots[0][1]
    with open(newest, "r+b") as f:
        f.truncate(64)
    loaded, path = load_latest_session(base)
    assert path == slots[1][1]
    assert loaded.version == state.version

    with open(newest, "wb") as f:
        f.write(b"not a pickle")
    with open(slots[1][1], "r+b") as f:
        f.truncate(10)
    loaded, path = load_latest_session(base)
    assert path == slots[2][1]

    with open(slots[2][1], "wb") as f:
        f.write(b"nope")
    with pytest.raises(FileNotFoundError):
        load_latest_session(base)


def run_fault_session(n_workers=2):
    svc = StudyService(SearchPlanDB(), SimulatedTrainer(horizon=80),
                       n_workers=n_workers, policy="fair_share")
    svc.submit(SPEC, GridTuner(fault_space().trials(80)))
    return svc.close()


def test_restore_latest_resumes_to_identical_stats(tmp_path):
    ref = run_fault_session()
    base = str(tmp_path / "sess.snap")
    svc = StudyService(SearchPlanDB(), SimulatedTrainer(horizon=80),
                       n_workers=2, policy="fair_share")
    svc.enable_auto_snapshot(base, every=25.0, keep=3)
    svc.submit(SPEC, GridTuner(fault_space().trials(80)))
    for _ in range(12):                    # interrupt mid-drain
        svc.step()
    assert session_rotation(base), "auto-snapshot never fired"
    del svc                                # the crash

    svc2 = StudyService.restore_latest(SearchPlanDB(), base,
                                       SimulatedTrainer(horizon=80))
    assert svc2._auto_snapshot == (base, 25.0, 3)
    got = svc2.close()
    assert det(got) == det(ref)


# ---------------------------------------------------------------------------
# ports of tests/test_service.py's snapshot tests
# ---------------------------------------------------------------------------

def build_session(db):
    svc = StudyService(db, SimulatedTrainer(), n_workers=4)
    svc.submit(SPEC, GridTuner(service_space().trials(200)))
    svc.submit(SPEC, GridTuner(service_space().trials(160)), at=80.0)
    return svc


def test_snapshot_restore_resumes_identically(tmp_path):
    """A half-finished session restored from a snapshot finishes with
    EngineStats (per-study gpu_seconds, steps_run included) identical to
    the uninterrupted run."""
    svc = build_session(SearchPlanDB())
    svc.run_until(150.0)          # half-finished; study-1 admitted at t=80
    assert not svc.quiescent
    path = str(tmp_path / "session.snap")
    svc.snapshot(path)
    reference = svc.close()       # the uninterrupted run

    svc2 = StudyService.restore(SearchPlanDB(), path, SimulatedTrainer())
    assert not svc2.quiescent
    assert [f.study_id for f in svc2.futures] == ["study-0", "study-1"]
    resumed = svc2.close()

    assert det(resumed) == det(reference)
    assert resumed.by_study["study-0"] == reference.by_study["study-0"]
    assert resumed.by_study["study-1"] == reference.by_study["study-1"]
    assert all(f.done() for f in svc2.futures)


def test_snapshot_restore_with_directory_store(tmp_path):
    """Directory-backed stores persist blobs themselves: the snapshot only
    records the committed index, and restore serves resumes from disk."""
    store = CheckpointStore(str(tmp_path / "ckpts"))
    svc = StudyService(SearchPlanDB(), SimulatedTrainer(), n_workers=4,
                       store=store)
    svc.submit(SPEC, GridTuner(service_space().trials(200)))
    svc.run_until(120.0)
    path = str(tmp_path / "session.snap")
    svc.snapshot(path)
    reference = svc.close()

    store2 = CheckpointStore(str(tmp_path / "ckpts"))
    svc2 = StudyService.restore(SearchPlanDB(), path, SimulatedTrainer(),
                                store=store2)
    resumed = svc2.close()
    assert det(resumed) == det(reference)
    assert resumed.ckpt_misses == reference.ckpt_misses


def test_restore_with_emptied_store_degrades_to_recompute(tmp_path):
    """A store that lost blobs since the snapshot costs recomputation, not
    a crash: stale plan entries are forgotten eagerly at restore."""
    svc = build_session(SearchPlanDB())
    svc.run_until(150.0)
    path = str(tmp_path / "session.snap")
    svc.snapshot(path)
    reference = svc.close()

    state = load_session(path)
    state.store_mem = None                     # simulate losing every blob
    state.store_cids = set()
    save_session(state, path)
    svc2 = StudyService.restore(SearchPlanDB(), path, SimulatedTrainer(),
                                store=CheckpointStore())
    resumed = svc2.close()
    assert all(f.done() for f in svc2.futures)
    assert resumed.steps_run >= reference.steps_run


def test_snapshot_requires_submission():
    svc = StudyService(SearchPlanDB(), SimulatedTrainer())
    with pytest.raises(RuntimeError, match="nothing submitted"):
        svc.snapshot("nowhere.snap")
    with pytest.raises(RuntimeError, match="enable_auto_snapshot"):
        svc.snapshot_rotated()
    with pytest.raises(ValueError, match="interval"):
        svc.enable_auto_snapshot("x", 0.0)


# ---------------------------------------------------------------------------
# port of tests/test_ckptplane.py::test_snapshot_restore_identity_with_tiered_store
# ---------------------------------------------------------------------------

def _tiered(tmp_path, capacity=40_000):
    return CheckpointStore(
        str(tmp_path / "disk"),
        remote=DirectoryObjectStore(str(tmp_path / "remote")),
        disk_capacity_bytes=capacity)


def test_snapshot_restore_identity_with_tiered_store(tmp_path):
    """Kill/restore over a *tiered* store: the restored session reuses
    blobs wherever they live (local or demoted to remote) and replays the
    identical logical run — stats equal modulo physical-store counters."""
    space = GridSearchSpace(
        fns={"lr": [Constant(0.1),
                    MultiStep(0.1, [60], values=[0.1, 0.01]),
                    MultiStep(0.1, [60], values=[0.1, 0.02])],
             "bs": [Constant(64)]})
    svc = StudyService(SearchPlanDB(), SimulatedTrainer(), n_workers=4,
                       store=_tiered(tmp_path))
    svc.submit(SPEC, GridTuner(space.trials(120)))
    svc.run_until(90.0)
    path = str(tmp_path / "session.snap")
    svc.snapshot(path)
    reference = svc.close()

    svc2 = StudyService.restore(SearchPlanDB(), path, SimulatedTrainer(),
                                store=_tiered(tmp_path))
    resumed = svc2.close()
    assert det(resumed) == det(reference)
    assert resumed.ckpt_misses == reference.ckpt_misses


# ---------------------------------------------------------------------------
# real training: a restored study bit-equal to the uninterrupted one
# ---------------------------------------------------------------------------

DATA = synthetic_cifar(256, seed=0)
EVAL = synthetic_cifar(128, seed=1)


def resnet_backend(**kw):
    return TorchTrainer(ResNet(n=1, width=8),
                        lambda: DataPipeline(DATA, batch_size=32, seed=3),
                        EVAL, default_optimizer="momentum", device="cpu",
                        **kw)


def resnet_trials():
    space = GridSearchSpace(fns={
        "lr": [MultiStep(0.05, [8], values=[0.05, v])
               for v in (0.02, 0.01, 0.005, 0.001)],
        "bs": [Constant(32)]})
    return space.trials(16)


def leaf_bits(svc):
    """Per trial: its leaf checkpoint's bytes by leaf, and every metric the
    plan recorded on its path."""
    eng = svc._engine
    plan, store = eng.plan, raw_store(eng.store)
    out = {}
    for tid, path in plan.trial_paths.items():
        node = plan.nodes[path[-1]]
        steps = sorted(node.ckpts)
        tree = store.get(node.ckpts[steps[-1]])
        out[tid] = ([(str(x.dtype), tuple(x.shape),
                      x.contiguous().reshape(-1).view(torch.uint8)
                      .numpy().tobytes()) if isinstance(x, torch.Tensor)
                     else x for x in tree_leaves(tree)],
                    {nid: plan.nodes[nid].metrics for nid in path})
    return out


@pytest.mark.parametrize("tier", ["memory", "directory"])
def test_restored_torch_study_is_bit_equal(tier, tmp_path):
    """A ResNet SHA study on ``TorchTrainer(device="cpu")``, one worker,
    snapshotted mid-study (some trials done, some mid-path) and restored
    against a fresh trainer and store: every trial's leaf checkpoint and
    every metric bit-equal to the uninterrupted run's, the same best
    trial, the count fields equal, and the kernel-plane counters of the
    two halves adding up to the uninterrupted run's."""
    def service(store):
        svc = StudyService(SearchPlanDB(), resnet_backend(use_kernel=True),
                           n_workers=1, store=store, batch_siblings=False)
        svc.submit(SPEC, SHATuner(resnet_trials(), min_steps=8,
                                  max_steps=16, eta=2))
        return svc

    def store_of(name):
        return (CheckpointStore(str(tmp_path / name)) if tier == "directory"
                else CheckpointStore())

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", kops.KernelFallbackWarning)
        svc = service(store_of("a"))
        tuner = svc.futures[0].tuner
        while tuner._rung == 0:         # until the first rung is decided:
            svc.step()                  # losers done, survivors mid-path
        assert tuner._pending and not svc.quiescent
        path = str(tmp_path / "s.snap")
        svc.snapshot(path)
        at_snapshot = svc.stats.kernel_fallbacks
        assert at_snapshot > 0
        if tier == "directory":
            import shutil
            shutil.copytree(tmp_path / "a", tmp_path / "b")
        reference = svc.close()
        ref_bits, ref_best = leaf_bits(svc), svc.futures[0].tuner.best

        svc2 = StudyService.restore(SearchPlanDB(), path,
                                    resnet_backend(use_kernel=True),
                                    store=store_of("b"))
        resumed = svc2.close()
    # the fallback warns once per process: let later tests see it again
    kops.reset_kernel_stats()
    assert counts(resumed) == counts(reference)
    assert resumed.kernel_fallbacks == reference.kernel_fallbacks > at_snapshot
    assert leaf_bits(svc2) == ref_bits
    assert svc2.futures[0].tuner.best.trial_id == ref_best.trial_id
    assert svc2.futures[0].done()


def test_snapshot_holds_host_tensors_and_no_tensor_metrics(tmp_path):
    """The memory tier's trees go into a snapshot as host copies, and no
    plan metric or tuner field is a tensor: the file decodes in a process
    with no CUDA device."""
    store = CheckpointStore()
    svc = StudyService(SearchPlanDB(), resnet_backend(), n_workers=1,
                       store=store, batch_siblings=False)
    svc.submit(SPEC, SHATuner(resnet_trials(), min_steps=8, max_steps=16,
                              eta=2))
    for _ in range(6):
        svc.step()
    state = capture_session(svc._engine, service={"futures": svc.futures})
    assert state.store_mem and set(state.store_mem) <= state.store_cids
    for tree in state.store_mem.values():
        for x in tree_leaves(tree):
            assert not isinstance(x, torch.Tensor) or x.device.type == "cpu"
    for node in state.plan.nodes.values():
        for m in node.metrics.values():
            assert all(type(v) is float for v in m.values())
    tuner = state.service["futures"][0].tuner
    assert not any(isinstance(v, torch.Tensor)
                   for v in vars(tuner).values())
    path = str(tmp_path / "s.snap")
    save_session(state, path)
    out = subprocess.run(
        [sys.executable, "-W", "error", "-c",
         "import sys; from repro_torch.core.engine import load_session; "
         "s = load_session(sys.argv[1]); print(len(s.store_mem))", path],
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
             "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) == len(state.store_mem)


def test_restore_two_workers_and_refuse_meshes_and_leases():
    """A two-worker session restores (the rows' meshes are all None, so
    the engine gets ``worker_meshes=None``); rows with 2-device meshes
    restore with them, over the simulator and over a CPU ``TorchTrainer``
    (whose placement gate rejects a mesh that shards nothing), and a
    CUDA trainer whose process does not see the mesh's cards refuses them
    before any work; a draining lease (the front door's) restores as
    draining, under its captured id."""
    svc, state = _small_session()
    eng = restore_engine(state, SimulatedTrainer(horizon=80))
    assert len(eng.workers) == 2
    _, meshed = _small_session()
    meshes = plan_worker_meshes(2, 2, host="hq")
    meshed.workers = [row[:3] + (m,) + row[4:]
                      for row, m in zip(meshed.workers, meshes)]
    eng = restore_engine(meshed, SimulatedTrainer(horizon=80))
    assert [w.mesh for w in eng.workers] == list(meshes)
    trainer = TorchTrainer(ResNet(n=1, width=4), lambda: None, {},
                           device="cpu")
    eng = restore_engine(meshed, trainer)
    assert [w.mesh for w in eng.workers] == list(meshes)
    assert trainer.mesh_compatible(meshes[0], [])
    assert not trainer.mesh_compatible(plan_worker_meshes(1, 7)[0], [])
    if torch.cuda.device_count() < 4:    # the meshes name cards 0-3
        trainer.device = torch.device("cuda")
        with pytest.raises(ValueError, match="visible CUDA devices"):
            restore_engine(meshed, trainer)
    _, leased = _small_session()
    leased.workers = [row[:7] + (True,) for row in leased.workers]
    eng = restore_engine(leased, SimulatedTrainer(horizon=80))
    assert [w.draining for w in eng.workers] == [True, True]
    assert [w.wid for w in eng.workers] == [row[0] for row in leased.workers]


def test_gateway_envelope_waits_for_the_front_door():
    """The container's gateway kind, now that the front door is here: a
    session encodes as ``session``, a gateway state as ``gateway`` and
    decodes back to a ``GatewayState``; anything else is a TypeError."""
    from repro_torch.frontdoor import GatewayState, StudyGateway

    _, state = _small_session()
    data = encode_snapshot(state)
    hdr, _ = _read_container(data)
    assert hdr["kind"] == "session"

    class NotAState:
        pass

    with pytest.raises(TypeError):
        encode_snapshot(NotAState())
    with pytest.raises(TypeError):
        encode_snapshot(object())
    gw = StudyGateway(SearchPlanDB(), SimulatedTrainer(horizon=80),
                      n_slots=2)
    gw.submit(SPEC, GridTuner(fault_space(1).trials(80)))
    gw.step()
    env = encode_snapshot(gw._capture())
    assert _read_container(env)[0]["kind"] == "gateway"
    back = decode_snapshot(env)
    assert isinstance(back, GatewayState)
    assert [k for k, _ in back.sessions] == [SPEC.key]
    gw.close()


def test_handles_and_futures_pickle_without_engine_or_service():
    svc, state = _small_session()
    h = svc._engine._handles[0]
    assert h.engine is svc._engine
    assert pickle.loads(pickle.dumps(h)).engine is None
    assert pickle.loads(pickle.dumps(svc.futures[0])).service is None
    assert h.engine is svc._engine


# ---------------------------------------------------------------------------
# side by side with the JAX package
# ---------------------------------------------------------------------------

def _captured(C, tuners, cls):
    svc = C.StudyService(C.SearchPlanDB(), cls(), n_workers=4)
    svc.submit(C.StudySpec("m", "d", ("lr", "bs")),
               tuners.GridTuner(service_space(C, tuners).trials(200)))
    svc.submit(C.StudySpec("m", "d", ("lr", "bs")),
               tuners.GridTuner(service_space(C, tuners).trials(160)),
               at=80.0)
    svc.run_until(150.0)
    return C.engine.capture_session(svc._engine,
                                    service={"futures": svc.futures})


def test_manifest_equals_the_reference_key_for_key():
    """One session captured in each package: the v5 header's manifest is
    equal JSON (plan key, knobs, stats but the wall-clock timers, worker
    rows, store_cids) and the records have the same names and kinds."""
    from repro.frontdoor.snapshot_v5 import (
        _read_container as ref_read_container, encode_snapshot as ref_encode)

    ref_state = _captured(R, RT, R.SimulatedTrainer)
    with warnings.catch_warnings():
        # the JAX package pickles itertools.count, which Python 3.12
        # deprecates; only this call of the reference is shielded
        warnings.simplefilter("ignore", DeprecationWarning)
        ref_hdr, ref_recs = ref_read_container(ref_encode(ref_state))
    hdr, recs = _read_container(encode_snapshot(
        _captured(T, TT, SimulatedTrainer)))
    for h in (hdr, ref_hdr):
        for k in WALL_CLOCK:
            h["manifest"]["stats"].pop(k)
    assert hdr["manifest"] == ref_hdr["manifest"]
    assert set(hdr["manifest"]) == {"plan_key", "knobs", "stats",
                                    "workers", "store_cids"}
    assert {k: hdr[k] for k in ("magic", "version", "kind")} == \
        {k: ref_hdr[k] for k in ("magic", "version", "kind")}
    assert [(m["name"], m["kind"]) for m in hdr["records"]] == \
        [(m["name"], m["kind"]) for m in ref_hdr["records"]]
    assert set(recs) == set(ref_recs) == {"graph", "worker_meshes"}


_READ_FOREIGN = r"""
import sys
from repro_torch.core.engine import load_session
try:
    load_session(sys.argv[1])
except ValueError as exc:
    print("REFUSED", "repro." in str(exc))
else:
    print("LOADED")
bad = sorted(m for m in sys.modules if m in ("repro", "jax")
             or m.startswith(("repro.", "jax.")))
print("BAD", bad)
"""


def test_jax_written_snapshot_is_refused_without_importing_it(tmp_path):
    """The JAX package's snapshot names ``repro.*`` classes in its graph:
    the port's reader raises ``ValueError`` and never imports ``repro``
    or ``jax``; the rotation reader counts it as an unreadable slot."""
    from repro.core.engine import save_session as ref_save

    ref_state = _captured(R, RT, R.SimulatedTrainer)
    path = str(tmp_path / "jax.snap.1")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ref_save(ref_state, path)
    out = subprocess.run(
        [sys.executable, "-W", "error", "-c", _READ_FOREIGN, path],
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
    assert out.returncode == 0, out.stderr
    lines = dict(l.split(" ", 1) for l in out.stdout.strip().splitlines())
    assert lines["REFUSED"] == "True" and lines["BAD"] == "[]"
    with pytest.raises(FileNotFoundError, match="ValueError"):
        load_latest_session(str(tmp_path / "jax.snap"))
