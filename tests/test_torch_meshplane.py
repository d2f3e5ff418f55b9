"""The mesh plane of the PyTorch package, side by side with the JAX
package's (ports of the single-device cases of ``tests/test_meshplane.py``).

A :class:`Worker` owns a device set (:class:`WorkerMesh`); placement
routes chains and sibling-chain groups through the scheduling policy's
hint and the backend's divisibility gate; boundary states hand off
device-to-device between same-host workers without a store round-trip.
Each scenario runs through both packages over their ``SimulatedTrainer``
and returns a record — ``EngineStats`` field for field, the plan's
metrics and checkpoints, the fleet — that must be equal.  The
``TorchTrainer`` cases (the divisibility gate, the d2d copy that no
producer aliases, a one-device-mesh fleet bit-equal to a thread fleet)
run the port on the CPU.  The reference's 4-device subprocess case (a
stage sharded over several devices) is ported in
``tests/test_torch_sharded_exec.py``.
"""

import dataclasses
import pickle
import warnings

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import repro.core as R
import repro.core.tuners as RT
import repro.dist.meshes as RD
import repro.train.checkpoint as RC
from repro.core.engine import dispatch as R_dispatch
from repro.core.engine.engine import EngineStats as R_EngineStats
from repro.core.engine.events import EventLoop as R_EventLoop
import repro_torch.core as T
import repro_torch.core.tuners as TT
import repro_torch.dist.meshes as TD
import repro_torch.train.checkpoint as TC
from repro_torch.core.engine import dispatch as T_dispatch
from repro_torch.core.engine.engine import EngineStats as T_EngineStats
from repro_torch.core.engine.events import EventLoop as T_EventLoop
from repro_torch.data import DataPipeline
from repro_torch.dist.meshes import WorkerMesh
from repro_torch.train.torch_trainer import TorchTrainer
from repro_torch.utils.tree import tree_leaves

# the suite runs several worker processes side by side: one intra-op
# thread each, or the workers fight over the cores
torch.set_num_threads(1)


class Pkg:
    """One package's mesh-plane surface, so a scenario runs unchanged
    through either."""

    def __init__(self, name):
        self.name = name
        if name == "jax":
            self.C, self.tuners, self.D, self.CK = R, RT, RD, RC
            self.disp, self.Stats, self.Loop = (R_dispatch, R_EngineStats,
                                                R_EventLoop)
        else:
            self.C, self.tuners, self.D, self.CK = T, TT, TD, TC
            self.disp, self.Stats, self.Loop = (T_dispatch, T_EngineStats,
                                                T_EventLoop)
        self.Worker = self.disp.Worker
        self.WorkerMesh = self.D.WorkerMesh
        sim = self.C.SimulatedTrainer

        class BatchedSim(sim):
            supports_batched_stages = True

        class PickySim(BatchedSim):
            """Accepts only thread workers / one-device meshes."""

            def mesh_compatible(self, mesh, ctxs):
                return mesh is None or mesh.n_devices == 1

        self.BatchedSim, self.PickySim = BatchedSim, PickySim

    def dispatcher(self, plan, backend, workers, store=None, **kw):
        return self.disp.Dispatcher(
            plan, backend, self.C.CriticalPathScheduler(),
            store if store is not None else self.CK.CheckpointStore(),
            self.Loop(), self.Stats(), workers, **kw)

    def sib_trial(self, tail_lr, total=40):
        C = self.C
        return C.Trial(C.HpConfig({"lr": C.MultiStep(
            0.1, [20], values=[0.1, tail_lr])}), total)

    def ctx(self, plan, nid, start, stop):
        node = plan.node(nid)
        return self.C.StageContext(node_id=nid, desc=node.desc,
                                   node_start=node.start, start=start,
                                   stop=stop, path_key=plan.path_key(nid))

    def seeded_sibling_plan(self, store, values=(0.05, 0.02, 0.01)):
        """Three sibling trials forking at step 20, the shared prefix
        trained and checkpointed in ``store``: the tails are a ready
        sibling group resuming from one cid."""
        backend = self.C.SimulatedTrainer()
        plan = self.C.SearchPlan()
        sibs = [self.sib_trial(v) for v in values]
        for t in sibs:
            plan.submit(t)
        shared = plan.trial_paths[sibs[0].trial_id][0]
        state = backend.run_stage(backend.init_state(),
                                  self.ctx(plan, shared, 0, 20))
        cid = store.put(plan.path_key(shared), 20, state)
        plan.record_result(shared, 20, cid, None)
        return plan, sibs, shared, cid, state

    def resume_plan(self, store, progress=7.5, seed_store=True):
        """One 40-step trial checkpointed at 20 → a single resume chain."""
        plan = self.C.SearchPlan()
        leaf, _, _ = plan.submit(self.C.Trial(self.C.HpConfig(
            {"lr": self.C.Constant(0.1)}), 40))
        state = {"progress": progress, "step": 20}
        cid = (store.put(plan.path_key(leaf.node_id), 20, state)
               if seed_store else "d2d-only@20")
        plan.record_result(leaf.node_id, 20, cid, None)
        return plan, leaf.node_id, cid, state


REF, PORT = Pkg("jax"), Pkg("torch")


def stats_of(stats):
    """``EngineStats`` field for field, but the wall-clock timers."""
    return dataclasses.asdict(dataclasses.replace(
        stats, ckpt_save_seconds=0.0, ckpt_load_seconds=0.0))


def drain_boundary_cids(disp):
    """{(node_id, stop): cid} for every stage event the dispatcher
    posted."""
    out = {}
    while disp.events:
        ev = disp.events.pop()
        if ev.kind == "stage":
            out[(ev.payload["node_id"], ev.payload["stop"])] = \
                ev.payload["cid"]
    return out


def plan_of(plan):
    return {nid: (node.metrics, node.ckpts)
            for nid, node in plan.nodes.items()}


# ---------------------------------------------------------------------------
# the descriptor
# ---------------------------------------------------------------------------


def _descriptor(P):
    m = P.WorkerMesh.build([0, 1, 2, 3])
    assert m.n_devices == 4 and m.axes == (("data", 4),)
    m2 = P.WorkerMesh.build([0, 1, 2, 3], axes=(("data", 2), ("model", 2)))
    assert m2.key != m.key
    for ids, axes in (([], None), ([0, 1, 2], (("data", 2),))):
        with pytest.raises(ValueError):
            P.WorkerMesh.build(ids, axes=axes)
    m3 = P.WorkerMesh.build([4, 5, 6, 7], axes=(("data", 2), ("model", 2)),
                            host="rack3")
    m4 = pickle.loads(pickle.dumps(m3))
    assert m4 == m3 and m4.key == m3.key
    rules = dataclasses.astuple(m.rules)
    return {"sizes": [m.sizes, m2.sizes], "keys": [m.key, m2.key, m3.key],
            "host": m.host, "rules": rules}


def _plan_meshes(P):
    meshes = P.D.plan_worker_meshes(3, 2, host="hq")
    assert P.D.plan_worker_meshes(2, 0) == (None, None)
    return [(m.device_ids, m.axes, m.host) for m in meshes]


def _width_accounting(P):
    w0 = P.Worker(0)
    w1 = P.Worker(1, mesh=P.WorkerMesh.build([0, 1], host="h9"))
    return [(w0.devices, w0.host), (w1.devices, w1.host)]


# ---------------------------------------------------------------------------
# placement: hints, the gate, degradation
# ---------------------------------------------------------------------------


def _solo_chain_widest(P):
    """A solo chain's default hint is "deep": devices go to sharding."""
    plan = P.C.SearchPlan()
    plan.submit(P.C.Trial(P.C.HpConfig({"lr": P.C.Constant(0.1)}), 30))
    narrow = P.Worker(0, mesh=P.WorkerMesh.build([0, 1]))
    wide = P.Worker(1, mesh=P.WorkerMesh.build([2, 3, 4, 5]))
    disp = P.dispatcher(plan, P.C.SimulatedTrainer(), [narrow, wide])
    disp.assign()
    assert not wide.idle and narrow.idle
    assert disp.stats.mesh_placements == 1
    # the mesh width is the accounting width: steps + save + eval
    assert disp.stats.gpu_seconds == pytest.approx(4 * (30 + 2.0 + 5.0))
    return stats_of(disp.stats)


def _sibling_group_narrowest(P):
    """A sibling group's default hint is "wide": it yields the big mesh."""
    store = P.CK.CheckpointStore()
    plan, *_ = P.seeded_sibling_plan(store)
    wide = P.Worker(0, mesh=P.WorkerMesh.build([0, 1, 2, 3]))
    narrow = P.Worker(1, mesh=P.WorkerMesh.build([4, 5]))
    disp = P.dispatcher(plan, P.BatchedSim(), [wide, narrow], store=store,
                        batch_siblings=True)
    disp.assign()
    assert not narrow.idle and wide.idle
    assert disp.stats.batched_groups == 1 and disp.stats.steps_run == 60
    assert disp.stats.mesh_placements == 1
    assert disp.stats.placement_rejections == 0
    return stats_of(disp.stats)


def _incompatible_redirected(P):
    """The divisibility gate routes work away from a mesh the backend
    cannot shard on, to the thread worker."""
    store = P.CK.CheckpointStore()
    plan, *_ = P.seeded_sibling_plan(store)
    meshy = P.Worker(0, mesh=P.WorkerMesh.build([0, 1, 2, 3]))
    thread = P.Worker(1)
    disp = P.dispatcher(plan, P.PickySim(), [meshy, thread], store=store,
                        batch_siblings=True)
    disp.assign()
    assert meshy.idle and not thread.idle
    assert disp.stats.batched_groups == 1
    assert disp.stats.placement_rejections >= 1
    assert disp.stats.mesh_placements == 0
    return stats_of(disp.stats)


def _all_rejected_degrades(P):
    """When EVERY candidate fails the gate the narrowest mesh hosts the
    work anyway: rejection redirects, it never wedges the plan."""
    store = P.CK.CheckpointStore()
    plan, *_ = P.seeded_sibling_plan(store)
    wide = P.Worker(0, mesh=P.WorkerMesh.build([0, 1, 2, 3]))
    narrow = P.Worker(1, mesh=P.WorkerMesh.build([4, 5]))
    disp = P.dispatcher(plan, P.PickySim(), [wide, narrow], store=store,
                        batch_siblings=True)
    disp.assign()
    assert disp.stats.steps_run == 60
    assert not narrow.idle and wide.idle
    assert disp.stats.placement_rejections == 2
    assert disp.stats.mesh_placements == 1
    return stats_of(disp.stats)


def _homogeneous_first_idle(P):
    """Ties resolve to the earliest candidate: a homogeneous mesh fleet
    places like the classic first-idle dispatcher."""
    plan = P.C.SearchPlan()
    plan.submit(P.C.Trial(P.C.HpConfig({"lr": P.C.Constant(0.1)}), 30))
    workers = [P.Worker(i, mesh=m)
               for i, m in enumerate(P.D.plan_worker_meshes(3, 2))]
    disp = P.dispatcher(plan, P.C.SimulatedTrainer(), workers)
    disp.assign()
    return [w.idle for w in workers], stats_of(disp.stats)


# ---------------------------------------------------------------------------
# dispatcher behaviour the plane relies on
# ---------------------------------------------------------------------------


def _deferred_chain_returns_worker(P):
    """A chain deferred because its parent was truncated away hands its
    worker back to the round; the refill extracts other ready work."""
    C = P.C
    plan = C.SearchPlan()
    t1 = C.Trial(C.HpConfig({"lr": C.MultiStep(
        0.1, [40, 80], values=[0.1, 0.05, 0.01])}), 120)
    t2 = C.Trial(C.HpConfig({"lr": C.MultiStep(
        0.1, [40, 80], values=[0.1, 0.05, 0.02])}), 120)
    l1, _, _ = plan.submit(t1)
    l2, _, _ = plan.submit(t2)
    plan.submit(C.Trial(C.HpConfig({"lr": C.Constant(0.3)}), 50))
    plan.record_profile(l1.node_id, 10.0)
    plan.record_profile(l2.node_id, 10.0)
    disp = P.dispatcher(plan, C.SimulatedTrainer(),
                        [P.Worker(0), P.Worker(1)], max_steps_per_chain=40)
    disp.assign()
    assert disp.stats.chains_deferred == 1
    assert disp.stats.steps_run == 90        # A (40) + the filler (50)
    assert all(not w.idle for w in disp.workers)
    return stats_of(disp.stats)


def _dedup_copies_before_fanout(P):
    """One resume load feeding several group members is copied per
    member: a backend that consumes its input in place would otherwise
    corrupt its siblings' carries."""

    class ClobberingSim(P.BatchedSim):
        def run_stages_batched(self, states, ctxs):
            outs = []
            for s, c in zip(states, ctxs):
                outs.append(self.run_stage(s, c))
                s.clear()                    # consume the input in place
            return outs

    store = P.CK.CheckpointStore()
    plan, sibs, shared, cid, fork_state = P.seeded_sibling_plan(store)
    fork_state = dict(fork_state)
    disp = P.dispatcher(plan, ClobberingSim(), [P.Worker(0)], store=store,
                        batch_siblings=True)
    disp.assign()
    assert disp.stats.batched_groups == 1
    cids = drain_boundary_cids(disp)
    ref = P.C.SimulatedTrainer()
    got = []
    for t in sibs:
        leaf = plan.trial_paths[t.trial_id][-1]
        want = ref.run_stage(dict(fork_state), P.ctx(plan, leaf, 20, 40))
        tree = store.get(cids[(leaf, 40)])
        assert tree["progress"] == want["progress"] and tree["step"] == 40
        got.append(tree["progress"])
    return got, stats_of(disp.stats)


# ---------------------------------------------------------------------------
# d2d handoff
# ---------------------------------------------------------------------------


def _d2d_same_host_hit(P):
    """A boundary state produced on the consumer's host is served from
    the device cache: the store is never asked (it does not even hold the
    cid), yet the clock and ``ckpt_loads`` are the store path's."""
    store = P.CK.CheckpointStore()
    plan, nid, cid, state = P.resume_plan(store, seed_store=False)
    worker = P.Worker(0, mesh=P.WorkerMesh.build([0], host="rack1"))
    disp = P.dispatcher(plan, P.C.SimulatedTrainer(), [worker], store=store)
    disp._d2d[cid] = (state, "rack1", 0)
    disp.assign()
    assert disp.stats.d2d_handoffs == 1 and disp.stats.ckpt_misses == 0
    assert disp.stats.ckpt_loads == 1
    cids = drain_boundary_cids(disp)
    want = P.C.SimulatedTrainer().run_stage(dict(state),
                                            P.ctx(plan, nid, 20, 40))
    assert store.get(cids[(nid, 40)])["progress"] == want["progress"]
    # the new boundary is retained for the next same-host consumer
    assert cids[(nid, 40)] in disp._d2d
    return want["progress"], stats_of(disp.stats)


def _d2d_cross_host(P):
    store = P.CK.CheckpointStore()
    plan, nid, cid, state = P.resume_plan(store)
    worker = P.Worker(0, mesh=P.WorkerMesh.build([0], host="rack2"))
    disp = P.dispatcher(plan, P.C.SimulatedTrainer(), [worker], store=store)
    disp._d2d[cid] = (state, "rack1", 0)     # produced elsewhere
    disp.assign()
    assert disp.stats.d2d_handoffs == 0 and disp.stats.ckpt_loads == 1
    return stats_of(disp.stats)


def _d2d_decline(P):
    class NoTransferSim(P.C.SimulatedTrainer):
        def device_transfer(self, state, mesh):
            return None

    store = P.CK.CheckpointStore()
    plan, nid, cid, state = P.resume_plan(store)
    worker = P.Worker(0, mesh=P.WorkerMesh.build([0], host="rack1"))
    disp = P.dispatcher(plan, NoTransferSim(), [worker], store=store)
    disp._d2d[cid] = (state, "rack1", 0)
    disp.assign()
    assert disp.stats.d2d_handoffs == 0 and disp.stats.ckpt_loads == 1
    return stats_of(disp.stats)


def _d2d_disabled_on_thread_fleets(P):
    store = P.CK.CheckpointStore()
    plan, *_ = P.resume_plan(store)
    disp = P.dispatcher(plan, P.C.SimulatedTrainer(), [P.Worker(0)],
                        store=store)
    disp.assign()
    assert len(disp._d2d) == 0 and disp.stats.d2d_handoffs == 0
    return stats_of(disp.stats)


def _d2d_lru(P):
    store = P.CK.CheckpointStore()
    plan, *_ = P.resume_plan(store)
    worker = P.Worker(0, mesh=P.WorkerMesh.build([0]))
    disp = P.dispatcher(plan, P.C.SimulatedTrainer(), [worker], store=store)
    for i in range(disp._d2d_cap + 5):
        disp._d2d_put(f"cid{i}", {"step": i}, worker)
    assert len(disp._d2d) == disp._d2d_cap == 16
    return list(disp._d2d)


def _d2d_crash_invalidates(P):
    """A crash of the producing worker drops the boundary states its
    devices held."""
    store = P.CK.CheckpointStore()
    plan, *_ = P.resume_plan(store)
    w0 = P.Worker(0, mesh=P.WorkerMesh.build([0]))
    w1 = P.Worker(1, mesh=P.WorkerMesh.build([1]))
    disp = P.dispatcher(plan, P.C.SimulatedTrainer(), [w0, w1], store=store)
    disp._d2d_put("a", {"step": 1}, w0)
    disp._d2d_put("b", {"step": 2}, w1)
    disp._crash_worker(w0, 0.0)
    return list(disp._d2d)


# ---------------------------------------------------------------------------
# fleet equivalences
# ---------------------------------------------------------------------------


def _det(stats):
    """Deterministic cross-fleet view: wall timers, physical store
    counters and the mesh-plane counters themselves."""
    return dataclasses.asdict(dataclasses.replace(
        stats, ckpt_save_seconds=0.0, ckpt_load_seconds=0.0,
        ckpt_delta_bytes=0, ckpt_full_bytes=0, ckpt_logical_bytes=0,
        ckpt_bytes_written=0, ckpt_delta_commits=0, ckpt_delta_rebases=0,
        ckpt_mem_hits=0, ckpt_disk_hits=0, ckpt_remote_hits=0,
        ckpt_store_misses=0, ckpt_tier_promotions=0, ckpt_tier_demotions=0,
        ckpt_tmp_reclaimed=0, d2d_handoffs=0, mesh_placements=0))


def _grid_run(P, worker_meshes):
    db = P.C.SearchPlanDB()
    study = P.C.Study.create(db, "m", "d", ("lr",))
    trials = ([P.sib_trial(v) for v in (0.05, 0.02, 0.01)]
              + [P.C.Trial(P.C.HpConfig({"lr": P.C.Constant(0.3)}), 60)])
    eng = study.engine(P.C.SimulatedTrainer(), n_workers=3,
                       batch_siblings=True, worker_meshes=worker_meshes)
    stats = eng.run([P.tuners.GridTuner(trials)])
    return db.get(study.key), stats


def _one_device_fleet_replays_threads(P):
    """Width-1 meshes change nothing but the mesh-plane counters: the
    virtual clock, per-study breakdown, metrics and checkpoints replay
    the thread fleet exactly."""
    plan_t, stats_t = _grid_run(P, None)
    plan_m, stats_m = _grid_run(P, P.D.plan_worker_meshes(3, 1))
    assert stats_m.mesh_placements > 0 and stats_t.mesh_placements == 0
    assert _det(stats_m) == _det(stats_t)
    assert plan_of(plan_m) == plan_of(plan_t)
    return stats_of(stats_m), plan_of(plan_m)


def _snapshot_round_trips_meshes(P, tmp_path):
    """Worker meshes survive snapshot / restore and the restored session
    finishes with the uninterrupted run's stats."""
    C = P.C
    meshes = P.D.plan_worker_meshes(2, 2, host="hq")
    spec = C.StudySpec("m", "d", ("lr",))
    trials = [P.sib_trial(v, total=60) for v in (0.05, 0.02)]

    def fresh():
        svc = C.StudyService(C.SearchPlanDB(), C.SimulatedTrainer(),
                             n_workers=2, worker_meshes=meshes)
        svc.submit(spec, P.tuners.GridTuner(list(trials)))
        return svc

    ref = fresh().close()
    svc = fresh()
    svc.run_until(30.0)
    with warnings.catch_warnings():
        # the reference pickles itertools.count (a 3.12 deprecation); the
        # port's snapshot is warning-clean and runs unshielded
        if P is REF:
            warnings.simplefilter("ignore", DeprecationWarning)
        path = svc.snapshot(str(tmp_path / f"{P.name}.snap"))
        svc2 = C.StudyService.restore(C.SearchPlanDB(), path,
                                      C.SimulatedTrainer())
    assert [w.mesh for w in svc2._engine.workers] == list(meshes)
    got = svc2.close()
    assert _det(got) == _det(ref)
    assert got.mesh_placements == ref.mesh_placements
    return stats_of(got)


SCENARIOS = [_descriptor, _plan_meshes, _width_accounting,
             _solo_chain_widest, _sibling_group_narrowest,
             _incompatible_redirected, _all_rejected_degrades,
             _homogeneous_first_idle, _deferred_chain_returns_worker,
             _dedup_copies_before_fanout, _d2d_same_host_hit,
             _d2d_cross_host, _d2d_decline, _d2d_disabled_on_thread_fleets,
             _d2d_lru, _d2d_crash_invalidates,
             _one_device_fleet_replays_threads]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[s.__name__.strip("_") for s in SCENARIOS])
def test_scenario_equals_the_reference(scenario):
    """Each scenario's record — ``EngineStats`` field for field, the
    plan's metrics and checkpoints, the fleet — is the JAX package's."""
    got = scenario(PORT)
    assert got == scenario(REF)


def test_session_snapshot_round_trips_meshes(tmp_path):
    assert (_snapshot_round_trips_meshes(PORT, tmp_path)
            == _snapshot_round_trips_meshes(REF, tmp_path))


def test_mesh_descriptor_touches_no_device_until_asked():
    """The descriptor is inert; ``torch_devices`` is the one call that asks
    the runtime, and it refuses ids that are not visible."""
    m = WorkerMesh.build([0, 1])
    assert m.sizes == {"data": 2}
    n = torch.cuda.device_count()
    if n >= 2:
        assert m.torch_devices() == [torch.device("cuda", 0),
                                     torch.device("cuda", 1)]
    else:
        with pytest.raises(ValueError, match="visible CUDA devices"):
            m.torch_devices()


# ---------------------------------------------------------------------------
# the PyTorch trainer
# ---------------------------------------------------------------------------


class TinyTask:
    """Linear softmax classifier (``tests/test_dataplane.py``'s shapes:
    w (16, 4), b (4,))."""

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


class FixedClockTrainer(TorchTrainer):
    """A fixed virtual stage time (one second a step), so two runs' clocks
    and accounting compare exactly."""

    def stage_seconds(self, ctx):
        return float(ctx.stop - ctx.start)


def tiny_backend():
    data = tiny_dataset()
    return FixedClockTrainer(TinyTask(), lambda: DataPipeline(
        data, batch_size=8, seed=3), tiny_dataset(seed=1),
        default_optimizer="momentum", device="cpu")


def test_torch_backend_divisibility_gate():
    """The placement gate is the divisibility rule over the task's
    parameter shapes, drawn on the host: the JAX trainer's verdicts for
    the same shapes, cached per mesh key."""
    from test_dataplane import tiny_backend as ref_tiny_backend

    tb, ref = tiny_backend(), ref_tiny_backend()
    four = WorkerMesh.build([0, 1, 2, 3])     # 16x4 / 4-vector shard on 4
    three = WorkerMesh.build([0, 1, 2], axes=(("data", 3),))
    one = WorkerMesh.build([0])
    for m in (four, three, one, None):
        rm = None if m is None else RD.WorkerMesh.build(
            m.device_ids, axes=m.axes)
        assert tb.mesh_compatible(m, []) is ref.mesh_compatible(rm, [])
    assert tb.mesh_compatible(four, []) is True
    assert tb.mesh_compatible(three, []) is False   # 3 divides nothing
    assert tb._mesh_ok == {four.key: True, three.key: False}
    # the gate drew on the host and left no device state behind
    assert tb._params0 is None


def test_d2d_handoff_is_never_aliased(tmp_path):
    """The d2d cache holds the trainer's own copy of a boundary state,
    and each hit hands out another: after the producer's tensors change
    in place (a chain that trains on from its carry), the served state is
    still bit-equal to the store's blob for the same cid, and changing the
    served state leaves the cache's copy alone."""
    backend = tiny_backend()
    store = TC.CheckpointStore(str(tmp_path / "ckpt"))
    plan = T.SearchPlan()
    leaf, _, _ = plan.submit(T.Trial(T.HpConfig({"lr": T.Constant(0.1)}),
                                     40))
    nid = leaf.node_id
    state = backend.run_stage(backend.init_state(), PORT.ctx(plan, nid, 0,
                                                             20))
    cid = store.put(plan.path_key(nid), 20, state)
    store.flush()
    plan.record_result(nid, 20, cid, None)
    worker = T_dispatch.Worker(0, mesh=WorkerMesh.build([0]))
    disp = PORT.dispatcher(plan, backend, [worker], store=store)
    disp._d2d_put(cid, state, worker)
    for x in tree_leaves(state["params"]):
        x.add_(1.0)                          # the producer trains on
    served, got_cid = disp._load_resume(nid, 20, worker)
    assert got_cid == cid and disp.stats.d2d_handoffs == 1
    blob = store.get(cid)
    for a, b in zip(tree_leaves(served["params"]),
                    tree_leaves(blob["params"])):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    for x in tree_leaves(served["params"]):
        x.mul_(3.0)                          # the consumer trains in place
    again, _ = disp._load_resume(nid, 20, worker)
    for a, b in zip(tree_leaves(again["params"]),
                    tree_leaves(blob["params"])):
        assert torch.equal(a, b)


def _torch_study(worker_meshes, store_dir=None, batch_siblings=False):
    db = T.SearchPlanDB()
    study = T.Study.create(db, "m", "d", ("lr",))
    trials = [T.Trial(T.HpConfig({"lr": T.MultiStep(
        0.1, [8], values=[0.1, v])}), 16) for v in (0.05, 0.02, 0.01)]
    store = TC.CheckpointStore(store_dir) if store_dir else None
    eng = study.engine(tiny_backend(), n_workers=1, store=store,
                       batch_siblings=batch_siblings,
                       worker_meshes=worker_meshes)
    stats = eng.run([TT.GridTuner(trials)])
    plan = db.get(study.key)
    leaves = {(nid, s): eng.store.get(c) for nid, n in plan.nodes.items()
              for s, c in n.ckpts.items()}
    return stats, plan_of(plan), leaves


@pytest.mark.parametrize("batch_siblings", [False, True],
                         ids=["solo", "groups"])
def test_one_device_mesh_fleet_on_the_trainer_is_bit_equal(batch_siblings,
                                                           tmp_path):
    """``TorchTrainer`` on a one-device-mesh fleet takes the default path:
    the same counts, metrics and held checkpoints, bit for bit, as a
    thread fleet on a directory store, with resumes served device to
    device (fewer store reads, the same ``ckpt_loads``)."""
    st_t, plan_t, leaves_t = _torch_study(
        None, str(tmp_path / "t"), batch_siblings)
    st_m, plan_m, leaves_m = _torch_study(
        [WorkerMesh.build([0])], str(tmp_path / "m"), batch_siblings)
    assert st_m.d2d_handoffs > 0 and st_m.mesh_placements > 0
    assert st_m.ckpt_loads == st_t.ckpt_loads
    assert (st_m.ckpt_disk_hits + st_m.ckpt_mem_hits + st_m.d2d_handoffs
            == st_t.ckpt_disk_hits + st_t.ckpt_mem_hits)
    assert _det(st_m) == _det(st_t)
    assert plan_m == plan_t
    assert leaves_m.keys() == leaves_t.keys()
    for k in leaves_t:
        for a, b in zip(tree_leaves(leaves_m[k]), tree_leaves(leaves_t[k])):
            if isinstance(a, torch.Tensor):
                assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
            else:
                assert a == b
