"""Front door of the PyTorch package: the multi-tenant gateway, admission
control, worker leases and the gateway half of the v5 snapshot — ports of
``tests/test_frontdoor.py``, each scenario run through both packages'
``SimulatedTrainer`` (pure Python in both) and held equal: ``EngineStats``
field for field (``det``), ``by_study``, the lease table, the admission
order, the futures' statuses and the tenant ledger.

Left out: the capacity gate's mesh case (``plan_worker_meshes(2, 2)`` and
``min_devices=4``, ``tests/test_frontdoor.py:150-152``).  It needs the mesh
plane (``dist/meshes.py``, ROADMAP queue A, slice 8); here a slot mesh is
refused with ``NotImplementedError`` and the gate is held on plain slots.

The JAX package's snapshot code pickles ``itertools.count``, which Python
3.12 deprecates: only the reference's snapshot calls are shielded
(:func:`shield`); the port's run under the suite's warning filters.
"""

import contextlib
import dataclasses
import json
import os
import pickle
import subprocess
import sys
import warnings

import pytest
import torch

import repro.core as R
import repro.core.tuners as RT
import repro.frontdoor as RF
from repro.dist.meshes import plan_worker_meshes as ref_plan_worker_meshes
import repro_torch.core as T
import repro_torch.core.tuners as TT
import repro_torch.frontdoor as TF
from repro_torch.core import SearchPlanDB, StudyService
from repro_torch.core.engine.session import load_latest_session, load_session
from repro_torch.core.scheduler import FairShareScheduler
from repro_torch.core.trainer import SimulatedTrainer
from repro_torch.dist.meshes import WorkerMesh, plan_worker_meshes
from repro_torch.train.torch_trainer import TorchTrainer
from repro_torch.frontdoor import (GatewayState, StudyGateway, TenantQuota,
                                   WorkerLeaseManager, decode_snapshot,
                                   encode_snapshot, is_v5_snapshot)
from repro_torch.frontdoor.snapshot_v5 import _read_container

# the suite runs several worker processes side by side: one intra-op
# thread each, or the workers fight over the cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"jax": (R, RT, RF), "torch": (T, TT, TF)}
PLANNERS = {"jax": ref_plan_worker_meshes, "torch": plan_worker_meshes}


class _TinyTask:
    """A parameter tree to gate meshes on; nothing trains it."""

    def init(self, gen):
        return {"w": torch.zeros((4, 2))}


def det(stats):
    """Deterministic view of EngineStats (the reference's
    ``test_frontdoor.det``), as a plain dict so two packages' classes
    compare field for field."""
    return dataclasses.asdict(dataclasses.replace(
        stats, ckpt_save_seconds=0.0, ckpt_load_seconds=0.0,
        ckpt_delta_bytes=0, ckpt_full_bytes=0, ckpt_logical_bytes=0,
        ckpt_bytes_written=0, ckpt_delta_commits=0, ckpt_delta_rebases=0,
        ckpt_mem_hits=0, ckpt_disk_hits=0, ckpt_remote_hits=0,
        ckpt_store_misses=0, ckpt_tier_promotions=0, ckpt_tier_demotions=0,
        ckpt_tmp_reclaimed=0, d2d_handoffs=0))


@contextlib.contextmanager
def shield(C):
    """Silence the reference's ``itertools.count`` pickling warning around
    one of its snapshot calls; the port's calls run unshielded."""
    if C is T:
        yield
        return
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        yield


class Pkg:
    """One package's front-door surface, so a scenario runs unchanged
    through either."""

    def __init__(self, name):
        self.name = name
        self.C, self.tuners, self.F = PKGS[name]
        self.A = self.C.StudySpec("m", "d", ("lr", "bs"))
        self.B = self.C.StudySpec("m2", "d", ("lr", "bs"))
        self.Cs = self.C.StudySpec("m3", "d", ("lr", "bs"))

    def space(self):
        C = self.C
        return self.tuners.GridSearchSpace(
            fns={"lr": [C.Constant(0.1), C.StepLR(0.1, 0.1, [100, 150]),
                        C.Warmup(5, 0.1, C.StepLR(0.1, 0.1, [90, 135])),
                        C.Warmup(5, 0.1, C.Exponential(0.1, 0.95))],
                 "bs": [C.Constant(128),
                        C.MultiStep(128, [70], values=[128, 256])]})

    def tuner(self, steps=150):
        return self.tuners.GridTuner(self.space().trials(steps))

    def gateway(self, **kw):
        return self.F.StudyGateway(self.C.SearchPlanDB(),
                                   self.C.SimulatedTrainer(), **kw)

    def quota(self, **kw):
        return self.F.TenantQuota(**kw)

    def plan_worker_meshes(self, *args, **kw):
        return PLANNERS[self.name](*args, **kw)

    def injector(self, seed, **kw):
        return self.C.FaultInjector(seed, **kw)

    def shield(self):
        return shield(self.C)


def leases(gw):
    return [(l.slot, l.key, l.wid, l.draining)
            for _, l in sorted(gw.leases.leases.items())]


def statuses(gw):
    return [f.status for f in gw.futures]


def archive(gw):
    """``close()``'s archive as ``[(key, det stats)]`` in retirement
    order, and the ledger."""
    out = [(k, det(s)) for k, s in gw.close()]
    return out, gw.tenant_ledger()


def both(scenario, *args):
    """Run ``scenario(pkg, *args)`` through the JAX package and the port;
    the two records must be equal."""
    ref = scenario(Pkg("jax"), *args)
    got = scenario(Pkg("torch"), *args)
    assert got == ref
    return got


# ---------------------------------------------------------------------------
# routing: per-key sessions, same-key merging
# ---------------------------------------------------------------------------


def _two_keys(P):
    gw = P.gateway(n_slots=4)
    f1 = gw.submit(P.A, P.tuner(), tenant="alice")
    f2 = gw.submit(P.A, P.tuner(), tenant="bob")       # same key: merges
    f3 = gw.submit(P.B, P.tuner(120), tenant="bob")    # other key: isolated
    rec = {"sessions": len(gw.sessions), "leases": leases(gw),
           "statuses": statuses(gw)}
    assert gw.leases.held(P.A.key) and gw.leases.held(P.B.key)
    gw.join()
    assert f1.done() and f2.done() and f3.done()
    rec["archive"], rec["ledger"] = archive(gw)
    a = dict(rec["archive"])[P.A.key]
    assert set(dict(rec["archive"])[P.B.key]["by_study"]) == {"study-2"}
    assert set(a["by_study"]) == {"study-0", "study-1"}
    assert a["by_study"]["study-1"]["instant_results"] > 0 or sum(
        s["steps_run"] for s in a["by_study"].values()) > a["steps_run"]
    return rec


def test_two_keys_run_concurrently_in_isolated_sessions():
    rec = both(_two_keys)
    assert rec["sessions"] == 2


def _service_vs_gateway(P):
    svc = P.C.StudyService(P.C.SearchPlanDB(), P.C.SimulatedTrainer(),
                           n_workers=4)
    svc.submit(P.A, P.tuner())
    svc.submit(P.A, P.tuner(120), at=80.0)
    via_service = det(svc.close())
    gw = P.gateway(n_slots=4)
    gw.submit(P.A, P.tuner())
    gw.submit(P.A, P.tuner(120), at=80.0)
    via_gateway = dict(gw.close())[P.A.key]
    assert det(via_gateway) == via_service
    return via_service


def test_same_key_same_stats_as_single_service():
    """Routing through the gateway adds no physical work, in either
    package."""
    both(_service_vs_gateway)


def _respawn(P):
    gw = P.gateway(n_slots=2)
    f1 = gw.submit(P.A, P.tuner(100))
    f1.result()
    gw.join()
    assert P.A.key not in gw.sessions          # drained forest retired
    f2 = gw.submit(P.A, P.tuner(100))
    assert P.A.key in gw.sessions              # fresh session spawned
    f2.result()
    assert f2.stats.instant_results == 8       # the plan survived in the db
    rec = {"stats": [dataclasses.asdict(f.stats) for f in gw.futures]}
    rec["archive"], rec["ledger"] = archive(gw)
    return rec


def test_retired_key_respawns_fresh_session():
    both(_respawn)


def _mismatch(P):
    svc = P.C.StudyService(P.C.SearchPlanDB(), P.C.SimulatedTrainer(),
                           n_workers=2)
    svc.submit(P.A, P.tuner(60))
    with pytest.raises(P.C.PlanKeyMismatch) as ei:
        svc.submit(P.B, P.tuner(60))
    assert ei.value.session_key == P.A.key
    assert ei.value.submitted_key == P.B.key
    assert isinstance(ei.value, ValueError)
    gw = P.gateway(n_slots=2)
    gw.submit(P.A, P.tuner(60))
    gw._sessions[P.B.key] = gw._sessions.pop(P.A.key)   # corruption
    fut = gw.submit(P.B, P.tuner(60))
    assert gw.sessions[P.A.key].key == P.A.key          # re-filed
    assert gw.sessions[P.B.key].key == P.B.key          # fresh, correct
    fut.result()
    gw.join()
    rec = {"statuses": statuses(gw)}
    rec["archive"], rec["ledger"] = archive(gw)
    return rec


def test_plan_key_mismatch_is_structured_and_gateway_reroutes():
    both(_mismatch)


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------


def _capacity(P):
    gw = P.gateway(n_slots=2)
    with pytest.raises(P.F.CapacityError, match="widest fleet slot has 1"):
        gw.submit(P.A, P.tuner(), min_devices=2)
    gw0 = P.gateway(n_slots=0)
    with pytest.raises(P.F.CapacityError, match="no worker slots"):
        gw0.submit(P.A, P.tuner())
    return {"seq": gw.admission.seq, "futures": len(gw.futures)}


def _capacity_meshes(P):
    """The reference's mesh case: two 2-device slots."""
    gw = P.gateway(slot_meshes=P.plan_worker_meshes(2, 2))
    with pytest.raises(P.F.CapacityError, match="widest fleet slot has 2"):
        gw.submit(P.A, P.tuner(), min_devices=4)
    return {"widths": gw.leases.slot_widths(), "seq": gw.admission.seq}


def test_capacity_gate_refuses_unplaceable_work():
    """The gate on plain slots and on mesh slots in both packages; over
    the PyTorch trainer 2-device slots are built (a CPU trainer's shards
    are CPU tensors), and its placement gate rejects a mesh that shards
    nothing."""
    both(_capacity)
    assert both(_capacity_meshes)["widths"] == [2, 2]
    trainer = TorchTrainer(_TinyTask(), lambda: None, {}, device="cpu")
    gw = StudyGateway(SearchPlanDB(), trainer,
                      slot_meshes=plan_worker_meshes(2, 2))
    assert gw.leases.slot_widths() == [2, 2]
    assert trainer.mesh_compatible(plan_worker_meshes(1, 2)[0], [])
    assert not trainer.mesh_compatible(plan_worker_meshes(1, 7)[0], [])
    gw = StudyGateway(SearchPlanDB(), trainer,
                      slot_meshes=plan_worker_meshes(2, 1))
    assert gw.leases.slot_widths() == [1, 1]


def _max_concurrent(P):
    gw = P.gateway(n_slots=2, max_concurrent=1)
    f1 = gw.submit(P.A, P.tuner(100))
    f2 = gw.submit(P.B, P.tuner(100))
    assert f1.status == "queued"
    assert f2.status == "queued_admission"
    assert len(gw.sessions) == 1
    rec = {"statuses": statuses(gw), "leases": leases(gw)}
    gw.join()
    assert f1.done() and f2.done()
    rec["archive"], rec["ledger"] = archive(gw)
    assert gw.admission.admission_faults == 0
    return rec


def test_max_concurrent_queues_at_the_door_and_drains():
    both(_max_concurrent)


def _bounded(P):
    gw = P.gateway(n_slots=2, max_concurrent=1,
                   quotas={"t": P.quota(max_queued=1)})
    gw.submit(P.A, P.tuner(100), tenant="t")
    gw.submit(P.B, P.tuner(100), tenant="t")
    with pytest.raises(P.F.AdmissionQueueFull,
                       match="admission queue is full"):
        gw.submit(P.Cs, P.tuner(100), tenant="t")
    rec = {"queue": [(s.tenant, s.seq, s.key) for s in gw.admission.queue]}
    gw.join()
    rec["archive"], rec["ledger"] = archive(gw)
    return rec


def test_bounded_queue_raises_admission_queue_full():
    both(_bounded)


def _starved(P):
    gw = P.gateway(n_slots=2, max_concurrent=1,
                   quotas={"greedy": P.quota(weight=1.0),
                           "starved": P.quota(weight=1.0)})
    first = gw.submit(P.A, P.tuner(100), tenant="greedy")
    g2 = gw.submit(P.B, P.tuner(100), tenant="greedy", priority=5)
    s1 = gw.submit(P.Cs, P.tuner(100), tenant="starved", priority=0)
    assert g2.status == s1.status == "queued_admission"
    first.result()
    gw._pump()
    assert s1.status in ("queued", "running", "done")
    assert g2.status == "queued_admission"
    rec = {"statuses": statuses(gw), "ledger_mid": gw.tenant_ledger()}
    gw.join()
    assert g2.done() and s1.done()
    rec["archive"], rec["ledger"] = archive(gw)
    return rec


def test_weighted_fair_share_admits_starved_tenant_first():
    both(_starved)


def test_quota_weight_scales_share_inside_shared_session():
    with pytest.raises(ValueError, match="weight must be > 0"):
        TenantQuota(weight=0.0)
    sched = FairShareScheduler()
    sched.set_study_weights({"s1": 2.0})
    sched.usage = {"s1": 100.0, "s2": 60.0}
    assert sched._weighted_usage("s1") == 50.0
    assert sched._weighted_usage("s2") == 60.0
    with pytest.raises(ValueError):
        sched.set_study_weights({"s1": -1.0})


def test_v4_unpickled_scheduler_lacks_weights_attr():
    sched = FairShareScheduler()
    del sched.weights
    revived = pickle.loads(pickle.dumps(sched))
    assert not hasattr(revived, "weights")
    assert revived._weighted_usage("s") == 0.0
    revived.set_study_weights({"s": 2.0})
    assert revived.weights == {"s": 2.0}


def _priority(P):
    gw = P.gateway(n_slots=2, max_concurrent=1)
    first = gw.submit(P.A, P.tuner(100), tenant="t")
    low = gw.submit(P.B, P.tuner(100), tenant="t", priority=0)
    high = gw.submit(P.Cs, P.tuner(100), tenant="t", priority=9)
    first.result()
    gw._pump()
    assert high.status != "queued_admission"
    assert low.status == "queued_admission"
    rec = {"statuses": statuses(gw)}
    gw.join()
    rec["archive"], rec["ledger"] = archive(gw)
    return rec


def test_priority_breaks_ties_within_equal_usage():
    both(_priority)


def _cancel_at_door(P):
    gw = P.gateway(n_slots=2, max_concurrent=1)
    f1 = gw.submit(P.A, P.tuner(100))
    f2 = gw.submit(P.B, P.tuner(100))
    assert f2.status == "queued_admission"
    assert f2.cancel()
    assert f2.cancelled() and f2.cancel()      # idempotent
    assert not gw.admission.queue
    gw.join()
    assert f1.done()
    rec = {"statuses": statuses(gw)}
    rec["archive"], rec["ledger"] = archive(gw)
    assert [k for k, _ in rec["archive"]] == [P.A.key]
    return rec


def test_cancel_queued_admission_withdraws_at_the_door():
    both(_cancel_at_door)


@pytest.mark.parametrize("seed", range(3))
def test_admission_order_equals_the_reference(seed):
    """The controller alone: one stream of offers, caps and usages gives
    the same admissions, in the same order, and the same queue."""
    import random

    def drive(F):
        rng = random.Random(seed)
        quotas = {t: F.TenantQuota(weight=w, max_queued=6, max_running=r)
                  for t, w, r in (("a", 1.0, None), ("b", 2.0, 2),
                                  ("c", 0.5, 1))}
        ctl = F.AdmissionController(quotas, max_concurrent=3)
        usage = {t: 0.0 for t in quotas}
        log = []
        for _ in range(60):
            tenant = rng.choice(sorted(quotas))
            sub = F.Submission(tenant, rng.randint(0, 3), ctl.next_seq(),
                               f"k{rng.randint(0, 2)}", None,
                               study_id=None)
            try:
                admitted = ctl.offer(sub)
            except F.AdmissionQueueFull:
                log.append(("full", sub.seq))
                continue
            if admitted:
                ctl.on_started(sub.key, f"s{sub.seq}", tenant)
                log.append(("now", sub.seq))
            if ctl.running and rng.random() < 0.5:
                key, sid = sorted(ctl.running)[0]
                usage[ctl.running[(key, sid)]] += rng.random() * 100
                ctl.on_finished(key, sid)
                nxt = ctl.pop_admissible(
                    lambda t: usage[t] / ctl.quota(t).weight)
                if nxt is not None:
                    ctl.on_started(nxt.key, f"s{nxt.seq}", nxt.tenant)
                    log.append(("popped", nxt.seq, nxt.tenant))
        return log, [(s.tenant, s.seq) for s in ctl.queue], ctl.seq

    assert drive(TF) == drive(RF)


# ---------------------------------------------------------------------------
# worker leases
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n, demands", [
    (10, {"a": 3, "b": 1}), (10, {"a": 100, "b": 1, "c": 1}),
    (10, {"a": 2, "b": 0}), (10, {"a": 0, "b": 0}),
    (3, {"a": 1, "b": 1, "c": 1, "d": 1}), (7, {"a": 5, "b": 3, "c": 2}),
    (1, {"a": 2, "b": 2})])
def test_lease_targets_largest_remainder_with_min_one(n, demands):
    got = WorkerLeaseManager([None] * n).targets(demands)
    assert got == RF.WorkerLeaseManager([None] * n).targets(demands)
    assert sum(got.values()) == (n if any(demands.values()) else 0)
    if n >= sum(1 for d in demands.values() if d):
        assert all(got[k] >= 1 for k, d in demands.items() if d)


def _rebalance(P):
    gw = P.gateway(n_slots=4)
    fa = gw.submit(P.A, P.tuner(100))
    fb = gw.submit(P.B, P.tuner(300))
    trace = [leases(gw)]
    assert len(gw.leases.held(P.A.key)) == 2
    assert len(gw.leases.held(P.B.key)) == 2
    fa.result()
    while P.A.key in gw.sessions and gw.step():
        trace.append(leases(gw))
    assert P.A.key not in gw.sessions
    peak = len(gw.leases.held(P.B.key))
    while not fb.done() and gw.step():
        peak = max(peak, len(gw.leases.held(P.B.key)))
        trace.append(leases(gw))
    assert peak == 4
    rec = {"trace": trace}
    rec["archive"], rec["ledger"] = archive(gw)
    return rec


def test_rebalance_moves_workers_as_forests_drain():
    """The lease table after every event is the reference's."""
    both(_rebalance)


def _drain_at_boundary(P):
    gw = P.gateway(n_slots=2)
    fut = gw.submit(P.A, P.tuner(200))
    eng = gw.sessions[P.A.key].engine
    while not any(not w.idle for w in eng.workers):
        gw.step()
    busy = [l for l in gw.leases.held(P.A.key)
            if not eng.worker(l.wid).idle][0]
    assert gw.leases.revoke(busy, eng) is False
    assert busy.draining and eng.worker(busy.wid).draining
    assert busy.slot in gw.leases.leases
    rec = {"revoked": (busy.slot, busy.wid), "before": leases(gw),
           "times": []}
    while eng.worker(busy.wid) is not None:
        gw.step()
        rec["times"].append(gw.time)
    gw._pump()
    assert not gw.leases.leases.get(busy.slot,
                                    P.F.Lease(0, "", 0)).draining
    rec["after"] = leases(gw)
    rec["wids"] = [w.wid for w in eng.workers]
    fut.result()
    rec["archive"], rec["ledger"] = archive(gw)
    return rec


def test_revoke_busy_worker_drains_at_chain_boundary():
    rec = both(_drain_at_boundary)
    assert rec["after"] != rec["before"]       # the slot was re-granted


def _not_in_past(P):
    gw = P.gateway(n_slots=2)
    gw.submit(P.A, P.tuner(200))
    gw.run_until(60.0)
    assert gw.time > 0
    gw.submit(P.B, P.tuner(100))
    while not gw.leases.held(P.B.key) and gw.step():
        pass
    moved = gw.leases.held(P.B.key)
    assert moved
    eng_b = gw.sessions[P.B.key].engine
    busy = [eng_b.worker(l.wid).busy_until for l in moved]
    assert all(b >= gw.time for b in busy)
    rec = {"busy_until": busy, "time": gw.time, "leases": leases(gw)}
    gw.join()
    rec["archive"], rec["ledger"] = archive(gw)
    return rec


def test_granted_worker_cannot_start_in_the_past():
    both(_not_in_past)


# ---------------------------------------------------------------------------
# the engine's side of a lease
# ---------------------------------------------------------------------------


def test_quiescent_zero_worker_session_wakes_on_a_grant():
    """A session spawned with no worker sits quiescent with its stages
    waiting; the grant's ``wake`` event starts them, not before ``at``."""
    svc = StudyService(SearchPlanDB(), SimulatedTrainer(), n_workers=0)
    fut = svc.submit(Pkg("torch").A, Pkg("torch").tuner(60))
    while svc.step():
        pass
    assert svc.stats.steps_run == 0 and not fut.done()
    w = svc.engine.add_worker(at=25.0)
    assert w.wid == 0 and w.busy_until == 25.0
    assert svc.engine.events.peek().kind == "wake"
    fut.result()
    assert svc.stats.steps_run > 0 and svc.time > 25.0
    w = svc.engine.add_worker(mesh=WorkerMesh.build([1], host="h1"))
    assert w.mesh.host == "h1" and svc.engine.dispatcher._d2d_enabled
    svc.close()


# ---------------------------------------------------------------------------
# v5 snapshots
# ---------------------------------------------------------------------------


def _mid_run(P):
    gw = P.gateway(n_slots=4, quotas={"alice": P.quota(weight=2.0),
                                      "bob": P.quota()})
    gw.submit(P.A, P.tuner(200), tenant="alice")
    gw.submit(P.A, P.tuner(160), tenant="bob", at=80.0)
    gw.submit(P.B, P.tuner(120), tenant="bob", at=40.0)
    gw.run_until(150.0)
    assert not gw.quiescent
    return gw


def _snapshot_restore(P, path):
    gw = _mid_run(P)
    with P.shield():
        gw.snapshot(path)
    gw.join()
    ref, ref_ledger = archive(gw)
    with P.shield():
        gw2 = P.F.StudyGateway.restore(P.C.SearchPlanDB(), path,
                                       P.C.SimulatedTrainer())
    assert len(gw2.sessions) == 2
    assert [f.status for f in gw2.futures] == ["running"] * 3
    rec = {"leases": leases(gw2), "time": gw2.time}
    gw2.join()
    got, got_ledger = archive(gw2)
    assert got == ref and got_ledger == ref_ledger
    rec.update(archive=got, ledger=got_ledger)
    return rec


def test_gateway_snapshot_restore_identical(tmp_path):
    """Every session restored from one v5 gateway envelope finishes with
    EngineStats (by_study included) and a tenant ledger identical to the
    uninterrupted run — in each package, and across them."""
    rec = {name: _snapshot_restore(Pkg(name), str(tmp_path / name))
           for name in PKGS}
    assert rec["torch"] == rec["jax"]


def _queued_kept(P, path):
    gw = P.gateway(n_slots=2, max_concurrent=1)
    gw.submit(P.A, P.tuner(100))
    queued = gw.submit(P.B, P.tuner(100), priority=3)
    assert queued.status == "queued_admission"
    gw.run_until(50.0)
    with P.shield():
        gw.snapshot(path)
        gw2 = P.F.StudyGateway.restore(P.C.SearchPlanDB(), path,
                                       P.C.SimulatedTrainer())
    q2 = [f for f in gw2.futures if f.status == "queued_admission"]
    assert len(q2) == 1
    assert q2[0].submission.priority == 3
    assert q2[0].submission.tuner is not None      # the tuner rode along
    rec = {"statuses": statuses(gw2), "seq": gw2.admission.seq}
    gw2.join()
    assert all(f.done() for f in gw2.futures)
    rec["archive"], rec["ledger"] = archive(gw2)
    return rec


def test_gateway_restore_preserves_queued_admissions(tmp_path):
    rec = {name: _queued_kept(Pkg(name), str(tmp_path / name))
           for name in PKGS}
    assert rec["torch"] == rec["jax"]


def test_v5_container_sniff_and_digest_detection(tmp_path):
    """A gateway envelope is the v5 container, not a bare pickle; one
    flipped payload byte is caught by its record digest (``ValueError``,
    so rotation readers fall back), in a session record nested in it
    too."""
    gw = _mid_run(Pkg("torch"))
    path = str(tmp_path / "gw.snap")
    gw.snapshot(path)
    data = (tmp_path / "gw.snap").read_bytes()
    assert is_v5_snapshot(data)
    assert not data.startswith(b"\x80")
    assert not is_v5_snapshot(b"\x80\x04whatever")
    hdr, _ = _read_container(data)
    first = [m for m in hdr["records"] if m["name"] == "session.0"][0]
    base = 8 + int.from_bytes(data[:8], "big")
    for at in (len(data) - 1, base + first["offset"] + first["length"] - 1):
        torn = bytearray(data)
        torn[at] ^= 0xFF
        with open(path, "wb") as f:
            f.write(bytes(torn))
        with pytest.raises(ValueError, match="digest|truncated"):
            load_session(path)
    with open(path, "wb") as f:
        f.write(data[:len(data) // 2])
    with pytest.raises(ValueError, match="digest|truncated"):
        load_session(path)
    gw.close()


def test_corrupt_newest_rotation_slot_falls_back(tmp_path):
    """Rotated gateway envelopes: a torn newest slot falls back to the
    one before it, and ``restore_latest`` revives the deployment with its
    snapshot cadence."""
    base = str(tmp_path / "rot.snap")
    gw = Pkg("torch").gateway(n_slots=2)
    gw.submit(Pkg("torch").A, Pkg("torch").tuner(100))
    gw.enable_auto_snapshot(base, every=40.0, keep=3)
    gw.run_until(130.0)
    slots = sorted(p for p in os.listdir(tmp_path) if ".tmp." not in p)
    assert len(slots) >= 2, slots
    newest = tmp_path / slots[-1]
    data = bytearray(newest.read_bytes())
    data[-1] ^= 0xFF
    newest.write_bytes(bytes(data))
    state, path = load_latest_session(base)
    assert isinstance(state, GatewayState)
    assert path.endswith(slots[-2][len("rot.snap"):])
    gw2 = StudyGateway.restore_latest(SearchPlanDB(), base,
                                      SimulatedTrainer())
    assert gw2._auto_snapshot == (base, 40.0, 3)
    gw2.join()
    gw2.close()
    gw.close()


def test_session_and_gateway_restores_reject_each_other(tmp_path):
    gw = _mid_run(Pkg("torch"))
    gpath = str(tmp_path / "gw.snap")
    gw.snapshot(gpath)
    with pytest.raises(ValueError, match="gateway envelope"):
        StudyService.restore(SearchPlanDB(), gpath, SimulatedTrainer())
    svc = StudyService(SearchPlanDB(), SimulatedTrainer(), n_workers=2)
    svc.submit(Pkg("torch").A, Pkg("torch").tuner(100))
    svc.run_until(50.0)
    spath = str(tmp_path / "s.snap")
    svc.snapshot(spath)
    with pytest.raises(ValueError, match="single session"):
        StudyGateway.restore(SearchPlanDB(), spath, SimulatedTrainer())
    gw.close()
    svc.close()


def test_encode_decode_roundtrip_types():
    gw = _mid_run(Pkg("torch"))
    state = gw._capture()
    back = decode_snapshot(encode_snapshot(state))
    assert isinstance(back, GatewayState)
    assert back.time == state.time
    assert back.quotas == state.quotas
    assert [k for k, _ in back.sessions] == [k for k, _ in state.sessions]
    assert back.leases == state.leases
    assert back.slot_meshes == [None] * 4
    with pytest.raises(TypeError, match="cannot snapshot"):
        encode_snapshot({"not": "a state"})
    gw.close()


def test_gateway_manifest_equals_the_reference_key_for_key():
    """One mid-run deployment captured in each package: the envelope's
    manifest is equal JSON (clock, quotas, tenants, leases, session keys,
    the queue's metadata), its records have the same names and kinds, and
    each nested session's manifest is equal but for the wall-clock
    timers."""
    from repro.frontdoor.snapshot_v5 import _read_container as ref_read

    def envelope(P, reader):
        gw = P.gateway(n_slots=3, max_concurrent=2,
                       quotas={"alice": P.quota(weight=2.0)})
        gw.submit(P.A, P.tuner(160), tenant="alice")
        gw.submit(P.B, P.tuner(120), tenant="bob", at=30.0)
        gw.submit(P.Cs, P.tuner(100), tenant="bob", priority=2)
        gw.run_until(120.0)
        with P.shield():
            data = P.F.encode_snapshot(gw._capture())
        hdr, recs = reader(data)
        nested = []
        for i in range(len(hdr["manifest"]["session_keys"])):
            shdr, _ = reader(recs[f"session.{i}"][1])
            for k in ("ckpt_save_seconds", "ckpt_load_seconds"):
                shdr["manifest"]["stats"].pop(k)
            nested.append(shdr["manifest"])
        names = [(m["name"], m["kind"]) for m in hdr["records"]]
        return hdr["manifest"], names, nested

    ref = envelope(Pkg("jax"), ref_read)
    got = envelope(Pkg("torch"), _read_container)
    assert json.dumps(got[0], sort_keys=True) == json.dumps(ref[0],
                                                            sort_keys=True)
    assert got[1] == ref[1]
    assert got[2] == ref[2]


def test_jax_written_gateway_envelope_is_refused_without_importing_it(
        tmp_path):
    """The reader admits only the port's, torch's, numpy's and the
    standard library's classes: a gateway envelope the JAX package wrote
    raises ``ValueError`` and never imports ``repro``."""
    P = Pkg("jax")
    gw = _mid_run(P)
    path = str(tmp_path / "jax_gw.snap")
    with P.shield():
        gw.snapshot(path)
    gw.close()
    out = subprocess.run(
        [sys.executable, "-W", "error", "-c",
         "import sys\n"
         "from repro_torch.core import SearchPlanDB, SimulatedTrainer\n"
         "from repro_torch.frontdoor import StudyGateway\n"
         "try:\n"
         "    StudyGateway.restore(SearchPlanDB(), sys.argv[1],"
         " SimulatedTrainer())\n"
         "except ValueError as exc:\n"
         "    print('REFUSED', 'repro.' in str(exc))\n"
         "print('IMPORTED', sorted(m for m in sys.modules"
         " if m == 'repro' or m.startswith('repro.')))\n", path],
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
    assert out.returncode == 0, out.stderr
    assert "REFUSED True" in out.stdout
    assert "IMPORTED []" in out.stdout


# ---------------------------------------------------------------------------
# faults + accounting reconciliation
# ---------------------------------------------------------------------------


def _ledger_under_faults(P):
    inj = P.injector(7, stage_fault_rate=0.05, crash_rate=0.02)
    gw = P.gateway(n_slots=4, quotas={"alice": P.quota(weight=2.0),
                                      "bob": P.quota()},
                   fault_injector=inj)
    fa = gw.submit(P.A, P.tuner(200), tenant="alice")
    fb = gw.submit(P.A, P.tuner(160), tenant="bob", at=40.0)
    fc = gw.submit(P.B, P.tuner(160), tenant="bob", at=40.0)
    gw.run_until(120.0)
    assert fb.cancel()
    gw.join()
    assert fa.done() and fc.done() and fb.cancelled()
    stats = dict(gw.close())
    assert inj.injected > 0
    assert sum(s.wasted_gpu_seconds for s in stats.values()) > 0
    ledger = gw.tenant_ledger()
    by_study_total = sum(ss.gpu_seconds for s in stats.values()
                         for ss in s.by_study.values())
    assert sum(e["gpu_seconds"] for e in ledger.values()) == \
        pytest.approx(by_study_total)
    for s in stats.values():
        assert sum(ss.gpu_seconds for ss in s.by_study.values()) \
            <= s.gpu_seconds + 1e-6
    return {"log": [list(e) for e in inj.log], "ledger": ledger,
            "archive": [(k, det(s)) for k, s in stats.items()]}


def test_ledger_reconciles_with_by_study_under_faults_and_cancel():
    both(_ledger_under_faults)


def _admission_faults(P):
    inj = P.injector(3, admission_fault_rate=1.0, max_faults=2)
    gw = P.gateway(n_slots=2, fault_injector=inj)
    futs = [gw.submit(P.A, P.tuner(100)), gw.submit(P.B, P.tuner(100))]
    assert gw.admission.admission_faults >= 1
    gw.join()
    assert all(f.done() for f in futs)
    assert inj.by_kind.get("admission", 0) >= 1
    rec = {"faults": gw.admission.admission_faults,
           "by_kind": dict(inj.by_kind)}
    rec["archive"], rec["ledger"] = archive(gw)
    return rec


def test_admission_faults_defer_but_never_lose_studies():
    both(_admission_faults)


def _faulty_restore(P, path):
    def build(inj):
        gw = P.gateway(n_slots=4, fault_injector=inj)
        gw.submit(P.A, P.tuner(200))
        gw.submit(P.B, P.tuner(160), at=40.0)
        return gw

    rates = dict(stage_fault_rate=0.05, crash_rate=0.02)
    gw = build(P.injector(11, **rates))
    gw.run_until(150.0)
    with P.shield():
        gw.snapshot(path)
    gw.join()
    ref = [(k, det(s)) for k, s in gw.close()]
    inj2 = P.injector(11, **rates)
    with P.shield():
        gw2 = P.F.StudyGateway.restore(P.C.SearchPlanDB(), path,
                                       P.C.SimulatedTrainer(),
                                       fault_injector=inj2)
    gw2.join()
    got = [(k, det(s)) for k, s in gw2.close()]
    assert got == ref
    return {"archive": got, "log": [list(e) for e in inj2.log]}


def test_faulty_gateway_snapshot_restore_identical(tmp_path):
    """A restored gateway continues the captured mid-run fault stream;
    the port's run and restore equal the reference's."""
    rec = {name: _faulty_restore(Pkg(name), str(tmp_path / name))
           for name in PKGS}
    assert rec["torch"] == rec["jax"]
