"""Study client API — specs, long-lived service sessions, futures.

Hippo §5.2's client facade, redesigned around the multi-study scenario of
§6.2: studies over the same (model, dataset, hp-set) arrive **over time**
and merge into one live stage forest.  The :class:`StudyService` is the
long-lived session a production deployment keeps open under continuous
traffic (PipeTune-style dynamic job arrival); :class:`Study.run` /
:func:`run_studies` remain as thin wrappers over a one-shot session, so
the batch world keeps working unchanged.

Typical service use::

    db = SearchPlanDB()
    svc = StudyService(db, SimulatedTrainer(), n_workers=40)
    spec = StudySpec("resnet56", "cifar10", ("lr", "bs"))
    fut1 = svc.submit(spec, SHATuner(space.trials(120), 15, 120, eta=4))
    fut2 = svc.submit(spec, GridTuner(more_trials), at=3600.0)  # arrives later
    fut1.result()                 # drive until study 1 finishes
    svc.snapshot("session.snap")  # durable point-in-time session state
    stats = svc.close()           # drain everything, flush, stamp end-to-end
    print(stats.by_study)

A study submitted while others are in flight is admitted as an event on
the virtual clock: the dispatcher wakes, its requests merge into the live
stage forest, and anything the plan already holds answers instantly
(``StudyStats.instant_results``).  ``snapshot()`` /
:meth:`StudyService.restore` persist and revive the whole session — plan
revisions, event heap, waiter table, per-study accounting, committed
checkpoint index — so a killed service resumes without recomputation
beyond write-behind puts that had not committed by the snapshot (see
:mod:`repro_torch.core.engine.session` for the format).
``fault_injector=`` runs the session under a seeded fault schedule
(:mod:`repro_torch.core.faults`).

Legacy one-shot use (mirrors the paper's Figure 11)::

    study = Study.create(db, model="resnet56", dataset="cifar10",
                         hp_set=("lr", "bs"))
    stats = study.run(tuner, backend=SimulatedTrainer(), n_workers=40)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

from repro_torch.core.db import SearchPlanDB, study_key
from repro_torch.core.engine import (EngineStats, ExecutionEngine, StudyStats,
                                     Tuner)
from repro_torch.core.engine.engine import check_fleet
from repro_torch.core.engine.session import (SessionState, capture_session,
                                             load_latest_session,
                                             load_session, restore_engine,
                                             save_session,
                                             save_session_rotated)
from repro_torch.core.scheduler import (CriticalPathScheduler,
                                        SchedulingPolicy, make_policy)
from repro_torch.core.trainer import TrainerBackend
from repro_torch.train.checkpoint import CheckpointStore

__all__ = ["Study", "StudySpec", "StudyFuture", "StudyService",
           "PlanKeyMismatch", "run_studies"]


class PlanKeyMismatch(ValueError):
    """A study was submitted to a session driving a different plan key.

    Structured (it carries both keys) so a router — the front-door
    :class:`~repro_torch.frontdoor.gateway.StudyGateway` — can catch it and
    re-route the submission to the right per-key session instead of
    string-matching an error message.  Subclasses ``ValueError`` for
    backward compatibility with callers that caught the old bare error.
    """

    def __init__(self, session_key: str, submitted_key: str):
        self.session_key = session_key
        self.submitted_key = submitted_key
        super().__init__(
            f"study key {submitted_key!r} differs from this session's "
            f"{session_key!r} — one StudyService drives one stage forest "
            "(same model/dataset/hp-set); start another service for a "
            "different key")


def _resolve_policy(policy: Union[str, SchedulingPolicy, None],
                    weighted_paths: bool) -> SchedulingPolicy:
    """Shared policy resolution for Study.engine and StudyService."""
    if policy is not None and weighted_paths:
        raise ValueError(
            "pass either policy=... or the legacy weighted_paths=True "
            "(= policy='weighted_fanout'), not both")
    if policy is None:
        return CriticalPathScheduler(weighted=weighted_paths)
    if isinstance(policy, str):
        return make_policy(policy)
    return policy


@dataclass(frozen=True)
class StudySpec:
    """Declarative study identity: what is being tuned, not how.

    Two specs with the same (model, dataset, hp-set) map to the same
    search-plan key — submitting them to one service merges their trials
    into one stage forest (§6.2).  ``name`` is display-only.
    """

    model: str
    dataset: str
    hp_set: Tuple[str, ...]
    name: str = ""

    def __post_init__(self):
        object.__setattr__(self, "hp_set", tuple(self.hp_set))

    @property
    def key(self) -> str:
        return study_key(self.model, self.dataset, self.hp_set)

    @property
    def display_name(self) -> str:
        return self.name or f"{self.model}/{self.dataset}"


class Study:
    def __init__(self, db: SearchPlanDB, key: str, name: str = ""):
        self.db = db
        self.key = key
        self.name = name or key

    @classmethod
    def create(cls, db: SearchPlanDB, model: str, dataset: str,
               hp_set: Sequence[str], name: str = "") -> "Study":
        return cls(db, study_key(model, dataset, tuple(hp_set)),
                   name or f"{model}/{dataset}")

    @classmethod
    def from_spec(cls, db: SearchPlanDB, spec: StudySpec) -> "Study":
        return cls(db, spec.key, spec.display_name)

    def engine(self, backend: TrainerBackend, n_workers: int = 4,
               gpus_per_worker: int = 1, share: bool = True,
               weighted_paths: bool = False,
               policy: Union[str, SchedulingPolicy, None] = None,
               store: Optional[CheckpointStore] = None,
               max_steps_per_chain: Optional[int] = None,
               batch_siblings: Optional[bool] = None,
               chain_fusion: Optional[bool] = None,
               worker_meshes: Optional[Sequence] = None,
               fault_injector=None) -> ExecutionEngine:
        """``policy`` selects the scheduling policy by name ("critical_path",
        "weighted_fanout", "fifo", "fair_share") or instance; the legacy
        ``weighted_paths`` flag is kept as a shorthand for the default.
        ``batch_siblings`` forces sibling-trial batching on/off and
        ``chain_fusion`` forces chain-fused execution (device-resident
        carries + write-behind boundary checkpoints) on/off (defaults:
        whatever the backend supports).  ``fault_injector`` (a
        :class:`repro_torch.core.faults.FaultInjector`) wraps the backend
        and store in the deterministic fault plane.  ``worker_meshes`` gives
        workers device sets (:class:`repro_torch.dist.meshes.WorkerMesh`;
        None entries = thread workers)."""
        return ExecutionEngine(
            self.db.get(self.key), backend, n_workers=n_workers,
            gpus_per_worker=gpus_per_worker,
            scheduler=_resolve_policy(policy, weighted_paths),
            store=store, share=share,
            max_steps_per_chain=max_steps_per_chain,
            batch_siblings=batch_siblings, chain_fusion=chain_fusion,
            worker_meshes=worker_meshes, fault_injector=fault_injector)

    def run(self, tuner: Tuner, backend: TrainerBackend, n_workers: int = 4,
            **kw) -> EngineStats:
        """One-shot wrapper over a :class:`StudyService` session."""
        svc = StudyService(self.db, backend, n_workers=n_workers, **kw)
        svc.submit(self, tuner)
        return svc.close()


# ---------------------------------------------------------------------------
# Service plane
# ---------------------------------------------------------------------------


@dataclass
class StudyFuture:
    """Handle on one submitted study's progress within a service session.

    Life cycle: ``queued`` (admission scheduled on the virtual clock) →
    ``running`` (tuner started, merged into the stage forest) → ``done``
    (tuner reports complete) or ``cancelled`` (detached; nodes no other
    study references released into checkpoint GC).
    """

    service: "StudyService"
    study_id: str
    plan_key: str
    tuner: Tuner
    arrival: float
    status: str = "queued"

    # ------------------------------------------------------------ inspection
    def done(self) -> bool:
        return self.status == "done"

    def cancelled(self) -> bool:
        return self.status == "cancelled"

    @property
    def stats(self) -> StudyStats:
        """Per-study accounting slice (live — updates as the session runs)."""
        return self.service.stats.study(self.study_id)

    # --------------------------------------------------------------- control
    def result(self) -> StudyStats:
        """Drive the session until this study completes; returns its stats
        slice (the tuner's best trial lives on ``self.tuner``)."""
        while self.status in ("queued", "running") and self.service.step():
            pass
        if self.status == "cancelled":
            raise RuntimeError(f"study {self.study_id!r} was cancelled")
        if self.status != "done":
            raise RuntimeError(
                f"service quiescent but study {self.study_id!r} is not done "
                "— its tuner waits on a request that was never submitted")
        return self.stats

    def cancel(self) -> bool:
        """Detach the study mid-run (False if it already finished): its
        waiters are dropped and every trial no other live study shares is
        killed — releasing plan nodes into checkpoint GC."""
        if self.status in ("done", "cancelled"):
            return self.status == "cancelled"
        self.status = "cancelled"
        self.service._engine.cancel_study(self.study_id)
        return True

    def __getstate__(self):
        # snapshots re-wire the owning service on restore
        d = self.__dict__.copy()
        d["service"] = None
        return d


class StudyService:
    """A long-lived engine session serving studies as they arrive.

    One service drives ONE stage forest (one search-plan key): every
    submitted study must share the same (model, dataset, hp-set) — the
    paper's multi-study setting.  A different key raises; run a second
    service for it.  The session is single-threaded and deterministic:
    callers drive it via :meth:`step` / :meth:`run_until` /
    ``future.result()`` / :meth:`join`, and late submissions are admission
    *events* on the virtual clock, so arrival order is replayable.

    ``snapshot()`` persists the complete session; :meth:`restore` revives
    it against a fresh backend/store and continues the identical event
    stream.
    """

    def __init__(self, db: SearchPlanDB, backend: TrainerBackend,
                 n_workers: int = 4, gpus_per_worker: int = 1,
                 share: bool = True, weighted_paths: bool = False,
                 policy: Union[str, SchedulingPolicy, None] = None,
                 store: Optional[CheckpointStore] = None,
                 max_steps_per_chain: Optional[int] = None,
                 batch_siblings: Optional[bool] = None,
                 chain_fusion: Optional[bool] = None,
                 worker_meshes: Optional[Sequence] = None,
                 fault_injector=None):
        self.db = db
        self.backend = backend
        self.n_workers = n_workers
        self.gpus_per_worker = gpus_per_worker
        self.share = share
        self.scheduler = _resolve_policy(policy, weighted_paths)
        self.store = store
        self.max_steps_per_chain = max_steps_per_chain
        self.batch_siblings = batch_siblings
        self.chain_fusion = chain_fusion
        self.worker_meshes = worker_meshes
        check_fleet(backend, worker_meshes or [])
        self.fault_injector = fault_injector
        self._engine: Optional[ExecutionEngine] = None
        self._key: Optional[str] = None
        self._futures: List[StudyFuture] = []
        self._closed = False
        # continuous durability (enable_auto_snapshot): (base, every, keep)
        self._auto_snapshot: Optional[Tuple[str, float, int]] = None
        self._next_snapshot_due: Optional[float] = None

    # ------------------------------------------------------------ properties
    @property
    def time(self) -> float:
        return self._engine.time if self._engine is not None else 0.0

    @property
    def stats(self) -> EngineStats:
        if self._engine is None:
            return EngineStats()
        return self._engine.stats

    @property
    def futures(self) -> List[StudyFuture]:
        return list(self._futures)

    @property
    def quiescent(self) -> bool:
        return self._engine is None or self._engine.quiescent

    @property
    def engine(self) -> Optional[ExecutionEngine]:
        """The live engine (None until the first submission) — the
        front-door lease manager grows/shrinks its worker fleet."""
        return self._engine

    @property
    def key(self) -> Optional[str]:
        """The plan key this session drives (None until first submit)."""
        return self._key

    # ------------------------------------------------------------- admission
    @staticmethod
    def _key_of(study: Union[StudySpec, Study, str]) -> str:
        if isinstance(study, StudySpec):
            return study.key
        if isinstance(study, Study):
            return study.key
        if isinstance(study, str):
            return study
        raise TypeError(
            f"submit() takes a StudySpec, Study or plan key, not {study!r}")

    def _ensure_engine(self, key: str) -> ExecutionEngine:
        if self._closed:
            raise RuntimeError("service is closed — create a new one")
        if self._engine is None:
            self._key = key
            self._engine = ExecutionEngine(
                self.db.get(key), self.backend, n_workers=self.n_workers,
                gpus_per_worker=self.gpus_per_worker,
                scheduler=self.scheduler, store=self.store, share=self.share,
                max_steps_per_chain=self.max_steps_per_chain,
                batch_siblings=self.batch_siblings,
                chain_fusion=self.chain_fusion,
                worker_meshes=self.worker_meshes,
                fault_injector=self.fault_injector)
        elif key != self._key:
            raise PlanKeyMismatch(self._key, key)
        return self._engine

    def submit(self, study: Union[StudySpec, Study, str], tuner: Tuner,
               study_id: Optional[str] = None,
               at: Optional[float] = None) -> StudyFuture:
        """Admit a study into the live session; returns its future.

        ``at`` schedules the arrival on the virtual clock (default: now).
        A study admitted while others are mid-flight merges into the
        in-flight stage forest — the admission event wakes the dispatcher;
        no fresh ``run()`` is needed, and results the plan already holds
        answer instantly."""
        eng = self._ensure_engine(self._key_of(study))
        taken = {f.study_id for f in self._futures}
        if study_id is None:
            n = len(self._futures)
            while f"study-{n}" in taken:   # skip explicitly-supplied ids
                n += 1
            sid = f"study-{n}"
        elif study_id in taken:
            raise ValueError(f"study id {study_id!r} already submitted")
        else:
            sid = study_id
        h = eng.admit(tuner, sid, at=at)
        fut = StudyFuture(self, sid, self._key, tuner,
                          arrival=at if at is not None else eng.time)
        self._futures.append(fut)
        return fut

    # ------------------------------------------------------------ the session
    def step(self) -> bool:
        """Advance the session by one event (False at quiescence)."""
        if self._engine is None or not self._engine.step():
            return False
        self._refresh_futures()
        self._maybe_auto_snapshot()
        return True

    def run_until(self, t: float) -> None:
        """Drive every event scheduled at or before virtual time ``t``."""
        while self._engine is not None:
            nxt = self._engine.events.peek()
            if nxt is None or nxt.time > t:
                break
            self.step()

    def join(self) -> EngineStats:
        """Drive the session to quiescence; every non-cancelled study must
        be done (otherwise a tuner waits on a request that was never
        submitted — the session is stuck, not slow)."""
        while self.step():
            pass
        stuck = [f.study_id for f in self._futures
                 if f.status in ("queued", "running")]
        if stuck:
            raise RuntimeError(
                f"service quiescent but studies not done: {stuck} — a tuner "
                "is waiting on a request that was never submitted")
        return self.stats

    def close(self) -> EngineStats:
        """Drain, then terminate: flush the write-behind store, stamp
        ``end_to_end``, journal the plan.  Flushing happens even when the
        drain errors (the durability barrier of ``ExecutionEngine.run``)."""
        try:
            self.join()
        finally:
            self._closed = True
            if self._engine is not None:
                self._engine.finish()
                self.db.checkpoint(self._key)
        return self.stats

    def __enter__(self) -> "StudyService":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            if not self._closed:
                self.close()
        elif self._engine is not None:   # error exit: barrier, don't drain
            self._closed = True
            self._engine.finish()

    def _refresh_futures(self) -> None:
        eng = self._engine
        for fut in self._futures:
            if fut.status == "queued" and fut.study_id in eng._started:
                fut.status = "running"
            if fut.status == "running" and fut.tuner.is_done():
                fut.status = "done"

    # ----------------------------------------------------------- persistence
    def enable_auto_snapshot(self, base: str, every: float,
                             keep: int = 3) -> None:
        """Continuous durability: after the first event past each
        ``every`` virtual seconds, write an atomic rotated snapshot
        ``base.<seq>`` keeping the newest ``keep`` (see
        :func:`~repro_torch.core.engine.session.save_session_rotated`).
        With :meth:`restore_latest` on startup, a SIGKILL at any instant
        loses at most one interval of progress."""
        if every <= 0:
            raise ValueError(f"snapshot interval must be > 0, got {every}")
        self._auto_snapshot = (base, float(every), int(keep))
        self._next_snapshot_due = None   # first step() aligns to the clock

    def _maybe_auto_snapshot(self) -> None:
        if self._auto_snapshot is None or self._engine is None:
            return
        base, every, keep = self._auto_snapshot
        if self._next_snapshot_due is None:
            # align the schedule to interval boundaries so a restored
            # session continues the same cadence its snapshot recorded
            self._next_snapshot_due = (self.time // every + 1) * every
        if self.time < self._next_snapshot_due:
            return
        self.snapshot_rotated()
        while self._next_snapshot_due <= self.time:
            self._next_snapshot_due += every

    def snapshot_rotated(self) -> str:
        """One rotated snapshot now (the timer path calls this; callers
        may too, e.g. a graceful-shutdown handler).  Requires
        :meth:`enable_auto_snapshot`."""
        if self._auto_snapshot is None:
            raise RuntimeError("call enable_auto_snapshot(base, every) first")
        if self._engine is None:
            raise RuntimeError("nothing submitted yet — snapshot is empty")
        base, every, keep = self._auto_snapshot
        state = capture_session(
            self._engine, service={"futures": self._futures,
                                   "auto_snapshot": self._auto_snapshot})
        return save_session_rotated(state, base, keep=keep)

    def snapshot(self, path: str) -> str:
        """Persist the complete session (durable point-in-time state; see
        :mod:`repro_torch.core.engine.session` for the format).  Flushes
        the write-behind store first, so everything the plan records is
        committed on disk/in the snapshot at the moment of capture."""
        if self._engine is None:
            raise RuntimeError("nothing submitted yet — snapshot is empty")
        state = capture_session(self._engine,
                                service={"futures": self._futures})
        return save_session(state, path)

    @classmethod
    def restore(cls, db: SearchPlanDB, path: str, backend: TrainerBackend,
                store: Optional[CheckpointStore] = None,
                fault_injector=None) -> "StudyService":
        """Revive a snapshotted session against a fresh backend/store.

        The restored session continues the exact event stream captured by
        :meth:`snapshot` — final stats (including the per-study breakdown)
        match an uninterrupted run.  Plan checkpoints the supplied store
        cannot serve (writes after the snapshot's flush barrier, external
        evictions) are forgotten eagerly and recomputed on demand.  Older
        snapshot formats are migrated forward on the fly."""
        return cls._restore_state(db, load_session(path), backend, store,
                                  fault_injector)

    @classmethod
    def restore_latest(cls, db: SearchPlanDB, base: str,
                       backend: TrainerBackend,
                       store: Optional[CheckpointStore] = None,
                       fault_injector=None) -> "StudyService":
        """:meth:`restore` from the newest *readable* rotation slot of
        ``base`` (``enable_auto_snapshot``'s output), falling back through
        corrupt/truncated slots; re-enables the captured auto-snapshot
        cadence.  Raises ``FileNotFoundError`` when no slot is readable."""
        state, _ = load_latest_session(base)
        return cls._restore_state(db, state, backend, store, fault_injector)

    @classmethod
    def _restore_state(cls, db: SearchPlanDB, state: SessionState,
                       backend: TrainerBackend,
                       store: Optional[CheckpointStore],
                       fault_injector) -> "StudyService":
        if not isinstance(state, SessionState):
            raise ValueError(
                "snapshot holds a gateway envelope (multiple sessions) — "
                "restore it with repro_torch.frontdoor.StudyGateway.restore, "
                "not StudyService.restore")
        eng = restore_engine(state, backend, store,
                             fault_injector=fault_injector)
        db.put(state.plan_key, state.plan)
        svc = cls(db, backend, n_workers=state.n_workers,
                  gpus_per_worker=state.gpus_per_worker, share=state.share,
                  policy=state.scheduler, store=eng.store,
                  max_steps_per_chain=state.max_steps_per_chain,
                  batch_siblings=state.batch_siblings,
                  chain_fusion=state.chain_fusion,
                  worker_meshes=[row[3] for row in state.workers],
                  fault_injector=fault_injector)
        svc._engine = eng
        svc._key = state.plan_key
        svc._futures = list(state.service.get("futures", []))
        for fut in svc._futures:
            fut.service = svc
        auto = state.service.get("auto_snapshot")
        if auto:
            svc.enable_auto_snapshot(*auto)
        return svc


def run_studies(studies: List[Tuple[Study, Tuner]], backend: TrainerBackend,
                n_workers: int = 4, share: bool = True,
                **kw) -> EngineStats:
    """Run several studies concurrently on one session (multi-study, §6.2).

    All studies must share the same key (same model/dataset/hp-set) — the
    paper's setting; their trials merge into one plan.  A thin wrapper
    over an upfront-submission :class:`StudyService` session.
    """
    keys = {s.key for s, _ in studies}
    if len(keys) != 1:
        raise ValueError(
            "multi-study merging requires a common study key (same model/"
            f"dataset/hp-set); got {len(keys)} distinct keys — run separate "
            "studies, or a StudyService per key")
    svc = StudyService(studies[0][0].db, backend, n_workers=n_workers,
                       share=share, **kw)
    for st, tuner in studies:
        svc.submit(st, tuner)
    return svc.close()
