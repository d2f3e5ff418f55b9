"""Public execution-engine facade — Hippo's scheduler/worker/aggregator loop.

This is the system of §4 run as a deterministic discrete-event simulation
over ``n_workers`` virtual workers (a *worker* is one GPU server slot in
the paper; one GPU here).  The facade wires the real components:

* the **search plan** is the single source of truth (stateless scheduling),
* every scheduling round obtains a **stage tree** (Algorithm 1) from the
  incremental :class:`~repro_torch.core.stagetree.StageTreeBuilder` — identical
  trees to a from-scratch build, O(changed requests) per round — and the
  scheduling policy extracts whole chains for idle workers
  (:mod:`repro_torch.core.engine.dispatch`),
* chains execute through a :class:`~repro_torch.core.trainer.TrainerBackend` —
  either real PyTorch training (wall-clock measured) or the analytic simulator
  (virtual durations) — and deposit checkpoints/metrics through the
  **aggregator** (:mod:`repro_torch.core.engine.aggregator`) at their virtual
  completion times.  Chain-capable backends run whole chains **fused**
  (device-resident carry across stage boundaries) with **write-behind**
  boundary checkpoints (``CheckpointStore.put_async``; ``run()`` flushes
  the store before returning) — per-stage events, metrics and the virtual
  clock are unchanged,
* **tuners** observe metrics and submit/kill trials, closing the HPO loop,
* the **fault plane** (``fault_injector=``, :mod:`repro_torch.core.faults`)
  wraps the backend and the store in a seeded fault schedule that the
  dispatcher's failure domains absorb: retries from the boundary
  checkpoint on the virtual clock, quarantine of repeat crashers, solo
  runs of a failed group's members.

Session model (service plane): the engine is a **long-lived session**, not
a batch call.  :meth:`step` processes exactly one event and re-runs the
dispatcher — the re-entrant unit the :class:`~repro_torch.core.study.StudyService`
drives.  *Quiescence* (``quiescent``: the event heap is empty — nothing
running, nothing scheduled) is distinct from *termination* (:meth:`finish`:
the write-behind store flushed, ``end_to_end`` stamped): a quiescent
session stays open for late arrivals.  :meth:`admit` schedules a tuner's
arrival as an ``admit`` event on the virtual clock, so a study submitted
mid-drain wakes the dispatcher and merges into the in-flight stage forest
instead of requiring a fresh ``run()``.  Consecutive admissions at the
same virtual time start together before the next scheduling round —
upfront submission through the session is event-for-event identical to the
legacy batch ``run(tuners)``.  :meth:`cancel_study` detaches a study
mid-run: its waiters are dropped, and trials no other live study shares
are killed, releasing their plan nodes into checkpoint GC.

Accounting matches the paper's two measurements: ``gpu_seconds`` (sum of
busy time × GPUs per worker) and ``end-to-end`` time (virtual clock at
completion), plus ``ckpt_evictions`` for the beyond-paper checkpoint GC.
``EngineStats.by_study`` breaks execution down per study: a shared stage's
cost is split evenly across the studies it serves (reuse is free capacity),
while ``steps_run`` counts every step advanced *on behalf of* the study —
so the per-study step sums exceed the physical ``steps_run`` exactly when
stages are shared.

``share=False`` turns the engine into the **trial-based baseline**
(Ray Tune / "Hippo-trial"): every submitted trial is salted so its plan
nodes never merge with other trials' — identical scheduling machinery,
zero cross-trial reuse.  A trial still reuses *its own* checkpoints when a
tuner promotes it to a longer step budget, exactly like a paused/resumed
Ray Tune trial.

Session snapshots (:mod:`repro_torch.core.engine.session`) capture a live
engine between two :meth:`step` calls and rebuild it against a fresh
backend and store.  The worker fleet is dynamic: the front door's lease
manager grows it (:meth:`add_worker`, a ``wake`` event that cannot fire
before the grant's time) and shrinks it (:meth:`remove_worker`: an idle
worker leaves at once, a busy one drains to its chain boundary), so
workers are keyed by id, never by list position.  A worker may own a
device set (``worker_meshes=``, ``add_worker(mesh=...)``: a
:class:`~repro_torch.dist.meshes.WorkerMesh`); the backend refuses a mesh
it can never run (:meth:`TrainerBackend.check_mesh`) before the worker
joins.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set

from repro_torch.core.hpseq import HpConfig
from repro_torch.core.scheduler import CriticalPathScheduler, SchedulingPolicy
from repro_torch.core.searchplan import SearchPlan
from repro_torch.core.stagetree import StageTreeBuilder
from repro_torch.core.engine.aggregator import Aggregator
from repro_torch.core.engine.dispatch import Dispatcher, Worker
from repro_torch.core.engine.events import EventLoop
from repro_torch.core.faults import FaultyBackend, FaultyStore
from repro_torch.core.trainer import TrainerBackend
from repro_torch.core.trial import Trial
from repro_torch.train.checkpoint import CheckpointStore
from repro_torch.utils import tracing

__all__ = ["ExecutionEngine", "Tuner", "StudyHandle", "EngineStats",
           "check_fleet",
           "StudyStats"]


class Tuner:
    """Base class for HPO algorithms (client-library tuners, §5.2)."""

    objective: str = "val_acc"
    mode: str = "max"  # or "min"

    def start(self, handle: "StudyHandle") -> None:
        raise NotImplementedError

    def on_result(self, trial: Trial, step: int, metrics: Dict[str, float]) -> None:
        pass

    def is_done(self) -> bool:
        raise NotImplementedError

    # ------------------------------------------------------------- helpers
    def score(self, metrics: Dict[str, float]) -> float:
        v = metrics[self.objective]
        return v if self.mode == "max" else -v


@dataclass
class StudyHandle:
    """The submission interface a tuner sees (the client library's view)."""

    engine: "ExecutionEngine"
    tuner: Tuner
    study_id: str = "study-0"

    def submit(self, trial: Trial, upto: Optional[int] = None) -> None:
        self.engine._submit(self, trial, upto)

    def kill(self, trial: Trial) -> None:
        self.engine._kill(self, trial)

    def __getstate__(self):
        # session snapshots never capture the engine (it holds the backend
        # and the store's writer thread); StudyService.restore re-wires it
        d = self.__dict__.copy()
        d["engine"] = None
        return d


@dataclass
class StudyStats:
    """Per-study slice of the engine accounting.

    ``gpu_seconds`` is the study's *split share* of stage execution time
    (a stage serving k studies charges each 1/k — reuse shows up as each
    study paying less), excluding resume-load overheads.  ``steps_run`` /
    ``stages_run`` count work advanced **on behalf of** the study in full,
    so their sum across studies exceeds the engine totals exactly when
    stages are shared.  ``instant_results`` counts requests answered
    straight from already-present plan metrics (§3.2's immediate response
    — the purest form of cross-study reuse a late arrival sees).
    """

    gpu_seconds: float = 0.0
    steps_run: int = 0
    stages_run: int = 0
    trials: int = 0
    instant_results: int = 0


@dataclass
class EngineStats:
    gpu_seconds: float = 0.0
    end_to_end: float = 0.0
    stages_run: int = 0
    steps_run: int = 0
    evals_run: int = 0
    ckpt_loads: int = 0
    ckpt_saves: int = 0
    ckpt_evictions: int = 0
    rounds: int = 0
    chains_deferred: int = 0  # chains whose in-round input was truncated away
    batched_groups: int = 0   # sibling groups executed as one backend call
    batched_stages: int = 0   # stages covered by those groups
    ckpt_misses: int = 0      # vanished resume ckpts degraded to recompute
    chain_fused_stages: int = 0   # stages advanced via backend.run_chain(s)
    ckpt_async_writes: int = 0    # write-behind boundary checkpoints
    kernel_calls: int = 0         # kernel-plane calls (backend-cumulative;
                                  # see TorchTrainer.kernel_calls)
    kernel_fallbacks: int = 0     # kernel→plain-version fallbacks
    ckpt_save_seconds: float = 0.0  # synchronous slice of store puts
    ckpt_load_seconds: float = 0.0  # store gets (resume loads)
    # ---- distribution plane v2 (mesh workers; see dispatch.py) ----
    d2d_handoffs: int = 0           # resumes served device-to-device (no
                                    # store round-trip; same-host producer)
    mesh_placements: int = 0        # chains/groups executed on mesh workers
    placement_rejections: int = 0   # idle mesh workers skipped for a work
                                    # unit (backend divisibility gate)
    # ---- checkpoint plane v2 (mirrored from CheckpointStore as growth
    # deltas per attached dispatcher; see Dispatcher._sync_store_stats) ----
    ckpt_delta_bytes: int = 0       # file bytes of delta-encoded commits
    ckpt_full_bytes: int = 0        # file bytes of full-snapshot commits
    ckpt_logical_bytes: int = 0     # full-serialization-equivalent bytes
    ckpt_bytes_written: int = 0     # physical bytes committed (delta+full)
    ckpt_delta_commits: int = 0
    ckpt_delta_rebases: int = 0     # depth-bound chains rebased to full
    ckpt_mem_hits: int = 0          # gets served from pending/memory/LRU
    ckpt_disk_hits: int = 0         # gets served from the local disk tier
    ckpt_remote_hits: int = 0       # gets served from the remote tier
    ckpt_store_misses: int = 0      # gets no tier could serve (KeyError)
    ckpt_tier_promotions: int = 0   # remote blobs rehydrated onto disk
    ckpt_tier_demotions: int = 0    # LRU disk blobs pushed to remote
    ckpt_tmp_reclaimed: int = 0     # stale temp files swept at store init
    # ---- fault plane (see core/faults.py + the dispatcher failure
    # domains).  wasted_gpu_seconds is charged separately from
    # gpu_seconds and NEVER split-charged into by_study — a retry is the
    # engine's waste, not the sharing studies' bill. ----
    stage_failures: int = 0         # failed execution attempts absorbed
    stage_retries: int = 0          # retries scheduled (transient faults)
    workers_quarantined: int = 0    # quarantine entries (repeat crashers)
    groups_degraded: int = 0        # batched groups degraded to solo runs
    faults_injected: int = 0        # injector faults fired (delta-mirrored
                                    # like the store counters)
    wasted_gpu_seconds: float = 0.0  # GPU time burned by failed attempts
    by_study: Dict[str, StudyStats] = field(default_factory=dict)

    @property
    def gpu_hours(self) -> float:
        return self.gpu_seconds / 3600.0

    @property
    def dedup_ratio(self) -> float:
        """Full-serialization bytes per physical byte this engine wrote
        (>1 ⇔ delta encoding is saving storage)."""
        return (self.ckpt_logical_bytes / self.ckpt_bytes_written
                if self.ckpt_bytes_written else 1.0)

    def study(self, study_id: str) -> StudyStats:
        return self.by_study.setdefault(study_id, StudyStats())


def check_fleet(backend: TrainerBackend, meshes: Sequence) -> None:
    """Refuse, before any work starts, a fleet whose meshes ``backend``
    can never run (:meth:`TrainerBackend.check_mesh`; ``None`` is a thread
    worker)."""
    for m in meshes:
        if m is not None:
            backend.check_mesh(m)


class ExecutionEngine:
    def __init__(self, plan: SearchPlan, backend: TrainerBackend,
                 n_workers: int = 4, gpus_per_worker: int = 1,
                 scheduler: Optional[SchedulingPolicy] = None,
                 store: Optional[CheckpointStore] = None,
                 share: bool = True,
                 max_steps_per_chain: Optional[int] = None,
                 batch_siblings: Optional[bool] = None,
                 chain_fusion: Optional[bool] = None,
                 worker_meshes: Optional[Sequence] = None,
                 fault_injector=None):
        # worker_meshes: per-worker WorkerMesh descriptors (None entries =
        # thread workers); shorter lists pad with None
        meshes = list(worker_meshes or [])
        if len(meshes) > n_workers:
            raise ValueError(
                f"{len(meshes)} worker meshes for {n_workers} workers")
        meshes += [None] * (n_workers - len(meshes))
        check_fleet(backend, meshes)
        # fault plane: wrap backend and store in the injector's fault
        # surface BEFORE anything reads capability flags or touches the
        # store — the whole engine then sees the faulty views, and the
        # dispatcher discovers the injector via backend.fault_injector
        if fault_injector is not None:
            backend = FaultyBackend(backend, fault_injector)
        self.fault_injector = fault_injector
        self.plan = plan
        self.backend = backend
        self.workers = [Worker(i, mesh=m) for i, m in enumerate(meshes)]
        self._next_wid = n_workers    # ids are never reused (dynamic fleets)
        self.gpus_per_worker = gpus_per_worker
        self.scheduler = scheduler or CriticalPathScheduler()
        # NOT `store or ...`: an empty CheckpointStore is falsy (__len__ == 0)
        # and would be silently replaced, orphaning the caller's store
        self.store = CheckpointStore() if store is None else store
        if fault_injector is not None and not isinstance(self.store,
                                                         FaultyStore):
            self.store = FaultyStore(self.store, fault_injector)
        self.share = share
        self.max_steps_per_chain = max_steps_per_chain
        # sibling-trial batching defaults to whatever the backend supports
        # (one batched call per ready sibling group; see dispatch.py)
        if batch_siblings is None:
            batch_siblings = bool(getattr(backend, "supports_batched_stages",
                                          False))
        self.batch_siblings = batch_siblings
        # chain fusion (device-resident carries across stage boundaries +
        # write-behind boundary checkpoints) defaults to backend support;
        # unlike batch_siblings, forcing True cannot override a backend
        # without run_chain support — there is no correct way to fuse it
        supported = bool(getattr(backend, "supports_chain_fusion", False))
        self.chain_fusion = (supported if chain_fusion is None
                             else chain_fusion and supported)
        self.stats = EngineStats()
        self.events = EventLoop()
        self.tree_builder = StageTreeBuilder(plan)
        self.dispatcher = Dispatcher(
            plan, backend, self.scheduler, self.store, self.events,
            self.stats, self.workers, gpus_per_worker=gpus_per_worker,
            max_steps_per_chain=max_steps_per_chain,
            tree_builder=self.tree_builder,
            batch_siblings=batch_siblings, chain_fusion=self.chain_fusion)
        self.aggregator = Aggregator(plan, self.store, self.stats, self.events)
        self._trials: Dict[str, Trial] = {}
        self._handles: List[StudyHandle] = []
        self._study_trials: Dict[str, Set[str]] = {}
        self._started: Set[str] = set()      # study ids whose tuner ran start()
        self._cancelled: Set[str] = set()    # study ids detached by cancel

    # ------------------------------------------------------------ properties
    @property
    def time(self) -> float:
        """Virtual clock (owned by the event loop)."""
        return self.events.time

    @property
    def quiescent(self) -> bool:
        """True when nothing is running or scheduled (the event heap is
        empty).  Quiescence is NOT termination: a quiescent session stays
        open — a later :meth:`admit` wakes it again."""
        return not self.events

    # ----------------------------------------------------------- worker fleet
    def worker(self, wid: int) -> Optional[Worker]:
        """The live worker with id ``wid`` (None once removed).  Workers
        are keyed by id, not list position — dynamic fleets (front-door
        leases) remove workers mid-session, so positions shift."""
        for w in self.workers:
            if w.wid == wid:
                return w
        return None

    def add_worker(self, mesh=None, at: Optional[float] = None) -> Worker:
        """Grow the fleet by one worker (front-door lease grant).

        The worker is idle immediately but cannot *start* work before
        ``at`` (default: now) — ``busy_until`` gates its first chain, so a
        worker leased over from another session at global time T does not
        retroactively compute in the past.  A mesh the backend can never
        run is refused before the worker joins."""
        check_fleet(self.backend, [mesh])
        t = self.events.time if at is None else max(at, self.events.time)
        w = Worker(self._next_wid, busy_until=t, mesh=mesh)
        self._next_wid += 1
        self.workers.append(w)     # the dispatcher shares this list object
        if mesh is not None:
            self.dispatcher._d2d_enabled = True
        # a session that drained its event queue while starved of workers
        # has nothing left to trigger a dispatcher round — the grant itself
        # must be schedulable, or waiting stages would never start
        self.events.push(t, "wake", w.wid)
        return w

    def remove_worker(self, wid: int) -> bool:
        """Shrink the fleet (front-door lease revocation).  An idle worker
        leaves immediately (True); a busy one is marked draining and leaves
        when its current chain's idle event fires (False) — revocation
        only ever lands at a chain boundary, where every boundary
        checkpoint is already committed, so no work is lost."""
        w = self.worker(wid)
        if w is None:
            return True
        if w.idle:
            self.workers.remove(w)
            return True
        w.draining = True
        return False

    # ------------------------------------------------------------------ API
    def handle(self, tuner: Tuner, study_id: Optional[str] = None) -> StudyHandle:
        h = StudyHandle(self, tuner, study_id or f"study-{len(self._handles)}")
        self._handles.append(h)
        return h

    def admit(self, tuner: Tuner, study_id: Optional[str] = None,
              at: Optional[float] = None) -> StudyHandle:
        """Schedule a study's arrival on the virtual clock (service plane).

        The tuner starts when the ``admit`` event fires — at ``max(at,
        now)`` — and the dispatcher immediately merges its requests into
        the in-flight stage forest.  Admissions landing at the same
        virtual time start together before the next scheduling round, so
        a batch admitted at the current time is indistinguishable from a
        legacy ``run([tuners])``."""
        h = self.handle(tuner, study_id)
        t = self.events.time if at is None else max(at, self.events.time)
        self.events.push(t, "admit", h)
        return h

    def run(self, tuners: List[Tuner]) -> EngineStats:
        """One-shot session: run tuners to completion; returns stats."""
        handles = [self.handle(t) for t in tuners]
        for h in handles:
            self._start_handle(h)
        try:
            self.drain()
            not_done = [h.tuner for h in handles
                        if h.study_id not in self._cancelled
                        and not h.tuner.is_done()]
            if not_done:
                raise RuntimeError(
                    f"engine drained but {len(not_done)} tuner(s) not done — "
                    "a tuner is waiting on a request that was never submitted")
        finally:
            self.finish()
        return self.stats

    # ------------------------------------------------------------- internal
    def _salted(self, trial: Trial, study_id: str) -> Trial:
        """Trial-based baseline: make the plan treat every (study, trial)
        pair as unshareable — the salt must include the study id, or two
        identical studies would still dedup across each other."""
        if self.share:
            return trial
        cfg = trial.hp_config
        static = dict(cfg.static)
        static["_trial_salt"] = f"{study_id}/{trial.trial_id}"
        return Trial(HpConfig(dict(cfg.fns), static), trial.total_steps,
                     trial_id=trial.trial_id, meta=dict(trial.meta))

    def _submit(self, handle: StudyHandle, trial: Trial,
                upto: Optional[int]) -> None:
        trial = self._salted(trial, handle.study_id)
        self._trials[trial.trial_id] = trial
        owned = self._study_trials.setdefault(handle.study_id, set())
        if trial.trial_id not in owned:
            owned.add(trial.trial_id)
            self.stats.study(handle.study_id).trials += 1
        node, step, satisfied = self.plan.submit(trial, upto,
                                                 study=handle.study_id)
        if satisfied:
            # §3.2: results already present → respond immediately (still an
            # event so tuner callbacks observe a consistent clock).
            self.stats.study(handle.study_id).instant_results += 1
            metrics = self.plan.metrics_for(node.node_id, step)
            self.events.push(self.events.time, "reply",
                             (handle, trial, step, metrics))
            return
        self.aggregator.add_waiter(node.node_id, step, handle, trial)

    def _kill(self, handle: StudyHandle, trial: Trial) -> None:
        """A tuner stops a trial: the study lets go of it, and the trial
        dies only when no other live study holds it — the check
        :meth:`cancel_study` makes.  Two studies whose tuners submit the
        same schedule share one trial id; the JAX package kills the trial
        for both, and the study that promoted it then waits forever."""
        tid = trial.trial_id
        if (self.plan.studies_of_trial(tid) - self._cancelled
                - {handle.study_id}):
            self.plan.detach_study(tid, handle.study_id)
            self.aggregator.release(handle.study_id, tid)
        else:
            self.aggregator.kill(tid)

    # ----------------------------------------------------------- cancellation
    def cancel_study(self, study_id: str) -> None:
        """Detach a study mid-run: drop its waiters, and kill every trial
        no other live study shares — releasing their plan nodes into
        checkpoint GC.  Nodes (and trials) another study still references
        are untouched; in-flight stages keep running, and results landing
        on nodes the cancel left unreferenced are evicted on arrival."""
        if study_id in self._cancelled:
            return
        self._cancelled.add(study_id)
        self.aggregator.detach_study(study_id)
        for tid in sorted(self._study_trials.get(study_id, ())):
            self.plan.detach_study(tid, study_id)
            if not self.plan.studies_of_trial(tid) - self._cancelled:
                self.aggregator.kill(tid)

    # ------------------------------------------------------------ main loop
    @tracing.traced("engine.step")
    def step(self) -> bool:
        """Process exactly one event, then re-run the dispatcher.  The
        re-entrant unit of the session loop — returns False at quiescence
        (nothing left to do until the next admission)."""
        if not self.events:
            return False
        ev = self.events.pop()
        if ev.kind == "stage":
            self.aggregator.on_stage_done(ev.payload)
        elif ev.kind == "reply":
            handle, trial, step, metrics = ev.payload
            if (trial.trial_id not in self.aggregator.killed
                    and handle.study_id not in self._cancelled
                    and handle.study_id
                    in self.plan.studies_of_trial(trial.trial_id)):
                handle.tuner.on_result(trial, step, metrics)
        elif ev.kind == "idle":
            # keyed by wid, not list index: dynamic fleets (front-door
            # leases) remove workers mid-session, so positions shift and
            # an event may outlive its worker
            w = self.worker(ev.payload)
            if w is not None:
                if w.draining:
                    # revoked lease: the chain boundary has been reached —
                    # the worker departs instead of rejoining the pool
                    self.workers.remove(w)
                else:
                    w.idle = True
        elif ev.kind == "wake":
            # lease grant landed: nothing to mutate — the dispatcher round
            # below hands the new worker any stages that were waiting for
            # capacity
            pass
        elif ev.kind == "retry":
            # backoff expired: release the failed stages' running marks so
            # Algorithm 1 re-derives them from the last boundary checkpoint
            # in the dispatcher round below
            self.dispatcher.on_retry(ev.payload)
        elif ev.kind == "admit":
            # start every admission landing at this instant before the next
            # scheduling round: same-time arrivals merge as one batch,
            # making upfront service submission identical to run(tuners)
            self._start_handle(ev.payload)
            while self.events:
                nxt = self.events.peek()
                if nxt.kind != "admit" or nxt.time > self.events.time:
                    break
                self._start_handle(self.events.pop().payload)
        self.dispatcher.assign()
        return True

    def drain(self) -> None:
        """Run to quiescence (the legacy ``_drain`` loop, re-entrant)."""
        with tracing.span("engine.step"):
            self.dispatcher.assign()
        while self.step():
            pass

    def finish(self) -> EngineStats:
        """Terminate the session: barrier the write-behind store (every
        pending boundary checkpoint durably committed, writer failures
        surfaced) and stamp ``end_to_end``.  Idempotent."""
        self.store.flush()
        # pick up counter growth from the flushed write-behind commits
        self.dispatcher._sync_store_stats()
        self.dispatcher._sync_fault_stats()
        self.stats.end_to_end = self.events.time
        return self.stats

    def _start_handle(self, h: StudyHandle) -> None:
        if h.study_id in self._cancelled or h.study_id in self._started:
            return
        self._started.add(h.study_id)
        h.tuner.start(h)
