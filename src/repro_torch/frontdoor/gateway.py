"""Front door — the multi-tenant study gateway.

One :class:`~repro_torch.core.study.StudyService` drives ONE stage forest (one
search-plan key); production traffic is messier: many tenants submit
studies over many keys, continuously.  :class:`StudyGateway` is the
process front door over that traffic:

* **routing** — submissions are routed by plan key to a per-key session,
  spawned on demand and retired (closed, stats archived) once its forest
  drains; same-key submissions from *different tenants* merge into one
  forest exactly as before — the paper's cross-study sharing now happens
  across tenants, with each tenant split-charged for what it used.
* **admission control** (:mod:`repro_torch.frontdoor.admission`) — per-tenant
  weighted fair-share quotas with bounded queues; over-quota studies wait
  at the door (future status ``queued_admission``) and are admitted
  least-weighted-usage-first, priorities breaking ties; work the fleet
  can never place is refused outright.
* **worker leasing** (:mod:`repro_torch.frontdoor.leases`) — the gateway owns
  the worker fleet and continuously rebalances it across live sessions
  as forests drain or new keys arrive; revocation lands only at chain
  boundaries (where the fault plane guarantees committed boundary
  checkpoints), so moving a worker never loses work.
* **one global virtual clock** — the gateway always steps the session
  holding the globally-earliest pending event (creation order breaks
  ties), and stamps lease grants and admissions with the global time, so
  makespans across sessions are honestly comparable and a run is fully
  deterministic (and therefore snapshot/restorable mid-flight).

``snapshot()`` persists the *whole deployment* — every session plus the
gateway's own control state — in the schema'd v5 container
(:mod:`repro_torch.frontdoor.snapshot_v5`); :meth:`StudyGateway.restore`
revives all of it and continues the identical event stream, including
the mid-run fault schedule.

The port of the JAX package's ``repro.frontdoor.gateway`` over this
package's study service, sessions and checkpoint store.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple, Union

from repro_torch.core.db import SearchPlanDB
from repro_torch.core.engine import EngineStats, StudyStats, Tuner
from repro_torch.core.engine.engine import check_fleet
from repro_torch.core.engine.session import (SESSION_FORMAT_VERSION,
                                       capture_session, load_latest_session,
                                       load_session, save_session,
                                       save_session_rotated)
from repro_torch.core.study import (PlanKeyMismatch, Study, StudyFuture,
                              StudyService, StudySpec)
from repro_torch.core.trainer import TrainerBackend
from repro_torch.frontdoor.admission import (AdmissionController, Submission,
                                       TenantQuota)
from repro_torch.frontdoor.leases import Lease, WorkerLeaseManager
from repro_torch.frontdoor.snapshot_v5 import GatewayState

__all__ = ["StudyGateway", "GatewayFuture"]

DEFAULT_TENANT = "default"


@dataclass
class GatewayFuture:
    """Handle on one submission's life at the gateway.

    Status: ``queued_admission`` (waiting at the door for quota) →
    then the inner :class:`~repro_torch.core.study.StudyFuture`'s life cycle
    (``queued`` → ``running`` → ``done`` / ``cancelled``); cancelling
    while still at the door withdraws the submission without it ever
    touching a session.
    """

    gateway: "StudyGateway"
    tenant: str
    key: str
    inner: Optional[StudyFuture] = None        # set at admission
    submission: Optional[Submission] = None    # set while at the door
    _finished_recorded: bool = False           # admission slot released
    _cancelled_queued: bool = False            # withdrawn at the door

    # ------------------------------------------------------------ inspection
    @property
    def status(self) -> str:
        if self.inner is not None:
            return self.inner.status
        return "cancelled" if self._cancelled_queued else "queued_admission"

    @property
    def study_id(self) -> Optional[str]:
        if self.inner is not None:
            return self.inner.study_id
        return self.submission.study_id if self.submission else None

    def done(self) -> bool:
        return self.status == "done"

    def cancelled(self) -> bool:
        return self.status == "cancelled"

    @property
    def stats(self) -> StudyStats:
        """Per-study accounting slice — live while the session runs,
        served from the gateway's archive once it retires."""
        if self.inner is not None and self.inner.service is not None:
            return self.inner.stats
        return self.gateway._stats_of(self.key, self.study_id)

    # --------------------------------------------------------------- control
    def result(self) -> StudyStats:
        """Drive the whole gateway until this study completes."""
        while (self.status in ("queued_admission", "queued", "running")
               and self.gateway.step()):
            pass
        if self.status == "cancelled":
            raise RuntimeError(f"study {self.study_id!r} was cancelled")
        if self.status != "done":
            raise RuntimeError(
                f"gateway quiescent but study {self.study_id!r} is not done "
                "— it is starved by a quota cap no finishing study will "
                "ever release, or its tuner waits on an unsubmitted request")
        return self.stats

    def cancel(self) -> bool:
        """Cancel the study (False if it already finished).  At the door:
        the submission is withdrawn.  In a session: detached mid-run like
        any :meth:`StudyFuture.cancel`, and its admission slot freed."""
        if self.status == "done":
            return False
        if self.status == "cancelled":
            return True
        if self.inner is None:
            self.gateway._withdraw(self)
            self._cancelled_queued = True
            return True
        ok = self.inner.cancel()
        self.gateway._pump()
        return ok


class StudyGateway:
    """The front door: multi-tenant, multi-key study traffic over one
    worker fleet (see module docstring).

    ``slot_meshes`` defines the fleet — one entry per worker slot
    (``None`` = thread worker, or a
    :class:`~repro_torch.dist.meshes.WorkerMesh`; a mesh the backend can
    never run is refused here, before any work starts); ``n_slots`` is
    shorthand for ``[None] * n``.  Remaining keyword arguments are forwarded to each
    per-key :class:`StudyService` it spawns (policy, share,
    gpus_per_worker, ...).
    """

    def __init__(self, db: SearchPlanDB, backend: TrainerBackend,
                 n_slots: Optional[int] = None,
                 slot_meshes: Optional[List[Any]] = None,
                 quotas: Optional[Dict[str, TenantQuota]] = None,
                 default_quota: Optional[TenantQuota] = None,
                 max_concurrent: Optional[int] = None,
                 fault_injector=None, store_factory=None, **session_kw):
        if slot_meshes is None:
            slot_meshes = [None] * (4 if n_slots is None else n_slots)
        elif n_slots is not None and n_slots != len(slot_meshes):
            raise ValueError(
                f"n_slots={n_slots} but {len(slot_meshes)} slot meshes")
        check_fleet(backend, slot_meshes)
        self.db = db
        self.backend = backend
        self.fault_injector = fault_injector
        self.store_factory = store_factory       # plan key -> CheckpointStore
        self.session_kw = dict(session_kw)
        self.leases = WorkerLeaseManager(slot_meshes)
        self.admission = AdmissionController(quotas, max_concurrent,
                                             default_quota)
        # plan key -> live session; dict insertion IS creation order (the
        # global clock's tie-break and the snapshot's session order)
        self._sessions: Dict[str, StudyService] = {}
        # plan key -> {study id -> tenant}; never pruned on retirement —
        # study ids are globally unique (study-<seq>), so the archive and
        # any same-key successor session coexist in one map
        self._tenants: Dict[str, Dict[str, str]] = {}
        self._futures: List[GatewayFuture] = []
        self._queued: Dict[int, GatewayFuture] = {}   # submission seq -> fut
        # drained sessions' archive: (key, final EngineStats, futures)
        self._retired: List[Tuple[str, EngineStats, List[StudyFuture]]] = []
        self._time = 0.0                          # global virtual clock
        self._closed = False
        self._auto_snapshot: Optional[Tuple[str, float, int]] = None
        self._next_snapshot_due: Optional[float] = None

    # ------------------------------------------------------------ properties
    @property
    def time(self) -> float:
        """Global virtual clock: the time of the last event stepped in
        any session (monotonic across the whole deployment)."""
        return self._time

    @property
    def sessions(self) -> Dict[str, StudyService]:
        return dict(self._sessions)

    @property
    def futures(self) -> List[GatewayFuture]:
        return list(self._futures)

    @property
    def quiescent(self) -> bool:
        return self._earliest()[0] is None

    # -------------------------------------------------------------- admission
    def submit(self, study: Union[StudySpec, Study, str], tuner: Tuner,
               tenant: str = DEFAULT_TENANT, priority: int = 0,
               study_id: Optional[str] = None, at: Optional[float] = None,
               min_devices: int = 1) -> GatewayFuture:
        """Admit one study through the front door; returns its future.

        Raises :class:`~repro_torch.frontdoor.admission.CapacityError` for work
        the fleet can never place, and
        :class:`~repro_torch.frontdoor.admission.AdmissionQueueFull` when the
        tenant's bounded admission queue is full.  Otherwise the study is
        either admitted now (routed to its plan key's session, spawned on
        demand) or waits at the door (``queued_admission``) until the
        weighted fair-share dequeue picks it."""
        if self._closed:
            raise RuntimeError("gateway is closed — create a new one")
        key = StudyService._key_of(study)
        self.admission.check_capacity(min_devices, self.leases.slot_widths())
        sub = Submission(tenant, priority, self.admission.next_seq(), key,
                         tuner, study_id=study_id, min_devices=min_devices,
                         arrival=at)
        fut = GatewayFuture(self, tenant=tenant, key=key, submission=sub)
        deferred = (self.fault_injector is not None
                    and self.fault_injector.on_admission(f"submit:{key}"))
        if deferred:
            # injected control-plane fault: the admission decision was
            # lost this round; the study queues and the next pump retries
            self.admission.defer(sub)
            self._queued[sub.seq] = fut
        elif self.admission.offer(sub):        # may raise AdmissionQueueFull
            self._admit(sub, fut)
        else:
            self._queued[sub.seq] = fut
        self._futures.append(fut)
        self._pump()
        return fut

    def _admit(self, sub: Submission, fut: GatewayFuture) -> None:
        """Route one admitted submission into its per-key session."""
        svc = self._session_for(sub.key)
        sid = sub.study_id if sub.study_id is not None else f"study-{sub.seq}"
        at = self._time if sub.arrival is None else max(sub.arrival,
                                                        self._time)
        try:
            inner = svc.submit(sub.key, sub.tuner, study_id=sid, at=at)
        except PlanKeyMismatch as exc:
            # the routing table pointed at a session driving a different
            # forest (a hand-registered or mis-restored session): re-file
            # it under the key it actually serves — authoritative on the
            # structured error — and route this submission to a fresh
            # session for its own key
            misfiled = self._sessions.pop(sub.key)
            self._sessions.setdefault(exc.session_key, misfiled)
            inner = self._session_for(sub.key).submit(
                sub.key, sub.tuner, study_id=sid, at=at)
            svc = self._sessions[sub.key]
        fut.inner = inner
        fut.submission = None
        self._tenants.setdefault(sub.key, {})[sid] = sub.tenant
        self.admission.on_started(sub.key, sid, sub.tenant)
        # tenant quota weight flows into the session's fair-share policy,
        # so weighted shares also hold INSIDE a shared (multi-tenant) forest
        weight = self.admission.quota(sub.tenant).weight
        if hasattr(svc.scheduler, "set_study_weights"):
            svc.scheduler.set_study_weights({sid: weight})

    def _session_for(self, key: str) -> StudyService:
        svc = self._sessions.get(key)
        if svc is None:
            store = self.store_factory(key) if self.store_factory else None
            # sessions start with ZERO workers — every worker they ever
            # run arrives as a lease grant from the gateway's fleet
            svc = StudyService(self.db, self.backend, n_workers=0,
                               store=store,
                               fault_injector=self.fault_injector,
                               **self.session_kw)
            self._sessions[key] = svc
        return svc

    def _withdraw(self, fut: GatewayFuture) -> None:
        sub = fut.submission
        if sub is not None and sub in self.admission.queue:
            self.admission.queue.remove(sub)
        if sub is not None:
            self._queued.pop(sub.seq, None)

    # ------------------------------------------------------------- the pump
    def _weighted_usage(self, tenant: str) -> float:
        return (self._tenant_gpu_seconds(tenant)
                / self.admission.quota(tenant).weight)

    def _tenant_gpu_seconds(self, tenant: str) -> float:
        total = 0.0
        for key, stats, _ in self._retired:
            total += self._credit_of(key, stats, tenant)
        for key, svc in self._sessions.items():
            total += self._credit_of(key, svc.stats, tenant)
        return total

    def _credit_of(self, key: str, stats: EngineStats, tenant: str) -> float:
        tmap = self._tenants.get(key, {})
        return sum(ss.gpu_seconds for sid, ss in stats.by_study.items()
                   if tmap.get(sid, DEFAULT_TENANT) == tenant)

    def _demand(self, key: str) -> int:
        """A session's claim on the fleet: its unfinished studies."""
        return sum(1 for f in self._futures
                   if f.key == key and f.inner is not None
                   and f.inner.status in ("queued", "running"))

    def _pump(self) -> None:
        """Settle finished studies, retire drained sessions, admit queued
        submissions, and follow demand with the fleet.  Idempotent —
        called around every step and submission."""
        for fut in self._futures:
            if (fut.inner is not None and not fut._finished_recorded
                    and fut.inner.status in ("done", "cancelled")):
                self.admission.on_finished(fut.key, fut.inner.study_id)
                fut._finished_recorded = True
        self._retire_drained()
        while True:
            sub = self.admission.pop_admissible(self._weighted_usage)
            if sub is None:
                break
            self._admit(sub, self._queued.pop(sub.seq))
        demands = {key: self._demand(key) for key in self._sessions}
        engines = {key: svc.engine for key, svc in self._sessions.items()}
        self.leases.rebalance(demands, engines, at=self._time)

    def _retire_drained(self) -> None:
        """Close and archive sessions whose forest has fully drained and
        that no live or queued submission still targets."""
        for key in list(self._sessions):
            svc = self._sessions[key]
            if svc.engine is None or not svc.quiescent:
                continue
            if self._demand(key) > 0:
                continue
            if any(s.key == key for s in self.admission.queue):
                continue
            self.leases.release_key(key, svc.engine)
            stats = svc.close()
            self._retired.append((key, stats, svc.futures))
            del self._sessions[key]

    # ------------------------------------------------------------ the session
    def _earliest(self) -> Tuple[Optional[str], Optional[float]]:
        """The session holding the globally-earliest pending event
        (creation order breaks time ties)."""
        best_key, best_t = None, None
        for key, svc in self._sessions.items():
            eng = svc.engine
            if eng is None:
                continue
            ev = eng.events.peek()
            if ev is not None and (best_t is None or ev.time < best_t):
                best_key, best_t = key, ev.time
        return best_key, best_t

    def step(self) -> bool:
        """Advance the deployment by exactly one event: the globally
        earliest one across every session.  False at quiescence."""
        self._pump()
        key, t = self._earliest()
        if key is None:
            return False
        self._time = max(self._time, t)
        self._sessions[key].step()
        self._pump()
        self._maybe_auto_snapshot()
        return True

    def run_until(self, t: float) -> None:
        """Drive every event scheduled at or before global time ``t``."""
        while True:
            self._pump()
            key, nxt = self._earliest()
            if key is None or nxt > t:
                break
            self.step()

    def join(self) -> None:
        """Drive everything to completion; raises if any study can never
        finish (stuck at the door or inside a session)."""
        while self.step():
            pass
        stuck = [f.study_id or f"seq-{f.submission.seq}"
                 for f in self._futures
                 if f.status in ("queued_admission", "queued", "running")]
        if stuck:
            raise RuntimeError(
                f"gateway quiescent but studies not done: {stuck} — either "
                "starved by a quota cap nothing will release, or a tuner "
                "waits on a request that was never submitted")

    def close(self) -> List[Tuple[str, EngineStats]]:
        """Drain everything, close every session, return the archive:
        one ``(plan key, final EngineStats)`` per retired session, in
        retirement order."""
        if not self._closed:
            try:
                self.join()
            finally:
                self._closed = True
                for key in list(self._sessions):
                    # join() raised mid-drain: still run each session's
                    # durability barrier before abandoning it
                    svc = self._sessions.pop(key)
                    if svc.engine is not None:
                        svc._closed = True
                        svc.engine.finish()
                        self.db.checkpoint(key)
        return [(key, stats) for key, stats, _ in self._retired]

    def __enter__(self) -> "StudyGateway":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            if not self._closed:
                self.close()
        else:
            self._closed = True
            for svc in self._sessions.values():
                if svc.engine is not None:
                    svc._closed = True
                    svc.engine.finish()

    # -------------------------------------------------------------- reporting
    def _stats_of(self, key: str, study_id: Optional[str]) -> StudyStats:
        svc = self._sessions.get(key)
        if svc is not None and study_id in svc.stats.by_study:
            return svc.stats.by_study[study_id]
        for k, stats, _ in reversed(self._retired):
            if k == key and study_id in stats.by_study:
                return stats.by_study[study_id]
        return StudyStats()

    def tenant_ledger(self) -> Dict[str, Dict[str, float]]:
        """Per-tenant accounting across the whole deployment — live and
        retired sessions alike.  ``gpu_seconds`` is the tenant's
        split-charged share of every forest it ran in (the sum across
        tenants equals the sum of ``EngineStats.by_study`` shares);
        ``studies``/``running``/``queued`` count its submissions."""
        ledger: Dict[str, Dict[str, float]] = {}

        def entry(t: str) -> Dict[str, float]:
            return ledger.setdefault(t, {"gpu_seconds": 0.0, "studies": 0,
                                         "running": 0, "queued": 0})

        for tenant in self.admission.quotas:
            entry(tenant)
        seen = [(key, stats) for key, stats, _ in self._retired]
        seen += [(key, svc.stats) for key, svc in self._sessions.items()]
        for key, stats in seen:
            tmap = self._tenants.get(key, {})
            for sid, ss in stats.by_study.items():
                entry(tmap.get(sid, DEFAULT_TENANT))["gpu_seconds"] += \
                    ss.gpu_seconds
        for f in self._futures:
            e = entry(f.tenant)
            e["studies"] += 1
            if f.status == "queued_admission":
                e["queued"] += 1
            elif f.status in ("queued", "running"):
                e["running"] += 1
        return ledger

    # ------------------------------------------------------------ persistence
    def _capture(self) -> GatewayState:
        sessions = []
        for key, svc in self._sessions.items():
            if svc.engine is None:
                continue
            sessions.append((key, capture_session(
                svc.engine, service={"futures": svc._futures})))
        return GatewayState(
            version=SESSION_FORMAT_VERSION,
            time=self._time,
            max_concurrent=self.admission.max_concurrent,
            seq=self.admission.seq,
            quotas={t: q.to_json()
                    for t, q in self.admission.quotas.items()},
            default_quota=self.admission.default_quota.to_json(),
            tenants={k: dict(v) for k, v in self._tenants.items()},
            sessions=sessions,
            slot_meshes=list(self.leases.slot_meshes),
            leases=[(l.slot, l.key, l.wid, l.draining)
                    for _, l in sorted(self.leases.leases.items())],
            queued=list(self.admission.queue),
            retired=list(self._retired),
            injector_state=(self.fault_injector.snapshot_state()
                            if self.fault_injector is not None else None),
            service={"auto_snapshot": self._auto_snapshot,
                     "admission_faults": self.admission.admission_faults},
        )

    def snapshot(self, path: str) -> str:
        """Persist the whole deployment — every session plus the gateway
        control plane — as one v5 gateway envelope (flushes each
        session's write-behind store first)."""
        return save_session(self._capture(), path)

    def enable_auto_snapshot(self, base: str, every: float,
                             keep: int = 3) -> None:
        """Continuous durability at deployment scope: one rotated gateway
        envelope ``base.<seq>`` after the first event past each ``every``
        global virtual seconds (newest ``keep`` retained)."""
        if every <= 0:
            raise ValueError(f"snapshot interval must be > 0, got {every}")
        self._auto_snapshot = (base, float(every), int(keep))
        self._next_snapshot_due = None

    def _maybe_auto_snapshot(self) -> None:
        if self._auto_snapshot is None or not self._sessions:
            return
        base, every, keep = self._auto_snapshot
        if self._next_snapshot_due is None:
            self._next_snapshot_due = (self._time // every + 1) * every
        if self._time < self._next_snapshot_due:
            return
        self.snapshot_rotated()
        while self._next_snapshot_due <= self._time:
            self._next_snapshot_due += every

    def snapshot_rotated(self) -> str:
        if self._auto_snapshot is None:
            raise RuntimeError("call enable_auto_snapshot(base, every) first")
        base, every, keep = self._auto_snapshot
        return save_session_rotated(self._capture(), base, keep=keep)

    @classmethod
    def restore(cls, db: SearchPlanDB, path: str, backend: TrainerBackend,
                store_factory=None, fault_injector=None,
                **session_kw) -> "StudyGateway":
        """Revive a snapshotted deployment against a fresh backend: every
        session continues its exact event stream, the lease table and
        admission queue pick up where they were, and a supplied
        ``fault_injector`` resumes the captured mid-run fault schedule
        (continuing it, not replaying it from the seed)."""
        return cls._restore_state(db, load_session(path), backend,
                                  store_factory, fault_injector,
                                  **session_kw)

    @classmethod
    def restore_latest(cls, db: SearchPlanDB, base: str,
                       backend: TrainerBackend, store_factory=None,
                       fault_injector=None, **session_kw) -> "StudyGateway":
        """:meth:`restore` from the newest readable rotation slot of
        ``base``; re-enables the captured auto-snapshot cadence."""
        state, _ = load_latest_session(base)
        return cls._restore_state(db, state, backend, store_factory,
                                  fault_injector, **session_kw)

    @classmethod
    def _restore_state(cls, db, state, backend, store_factory,
                       fault_injector, **session_kw) -> "StudyGateway":
        if not isinstance(state, GatewayState):
            raise ValueError(
                "snapshot holds a single session, not a gateway envelope — "
                "restore it with repro_torch.core.study.StudyService.restore")
        gw = cls(db, backend,
                 slot_meshes=state.slot_meshes,
                 quotas={t: TenantQuota.from_json(q)
                         for t, q in state.quotas.items()},
                 default_quota=TenantQuota.from_json(state.default_quota),
                 max_concurrent=state.max_concurrent,
                 fault_injector=fault_injector,
                 store_factory=store_factory, **session_kw)
        if fault_injector is not None and state.injector_state is not None:
            fault_injector.restore_state(state.injector_state)
        gw._time = state.time
        gw.admission.seq = state.seq
        gw.admission.queue = list(state.queued)
        gw.admission.admission_faults = state.service.get(
            "admission_faults", 0)
        gw._tenants = {k: dict(v) for k, v in state.tenants.items()}
        gw._retired = list(state.retired)
        for key, sess in state.sessions:
            store = store_factory(key) if store_factory else None
            gw._sessions[key] = StudyService._restore_state(
                db, sess, backend, store, fault_injector)
        for slot, key, wid, draining in state.leases:
            gw.leases.leases[slot] = Lease(slot, key, wid, bool(draining))
        # rebuild the future table deterministically: retired archive
        # first, then live sessions in creation order, then the admission
        # queue (scheduler weights travel inside each session's pickled
        # policy; only admission slots re-register)
        for key, _, futs in gw._retired:
            tmap = gw._tenants.get(key, {})
            for inner in futs:
                gw._futures.append(GatewayFuture(
                    gw, tenant=tmap.get(inner.study_id, DEFAULT_TENANT),
                    key=key, inner=inner, _finished_recorded=True))
        for key, svc in gw._sessions.items():
            tmap = gw._tenants.get(key, {})
            for inner in svc._futures:
                tenant = tmap.get(inner.study_id, DEFAULT_TENANT)
                fut = GatewayFuture(gw, tenant=tenant, key=key, inner=inner)
                if inner.status in ("done", "cancelled"):
                    fut._finished_recorded = True
                else:
                    gw.admission.on_started(key, inner.study_id, tenant)
                gw._futures.append(fut)
        for sub in gw.admission.queue:
            fut = GatewayFuture(gw, tenant=sub.tenant, key=sub.key,
                                submission=sub)
            gw._queued[sub.seq] = fut
            gw._futures.append(fut)
        auto = state.service.get("auto_snapshot")
        if auto:
            gw.enable_auto_snapshot(*auto)
        return gw
