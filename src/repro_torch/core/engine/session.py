"""Durable engine sessions — snapshot/restore for the service plane.

A :class:`SessionState` is the complete picklable state of one live
:class:`~repro_torch.core.engine.engine.ExecutionEngine` session at an
event boundary: the search plan (with revision map, pending index and
running marks), the event heap and virtual clock, the waiter table,
per-study accounting, the scheduling policy (with its fair-share usage
memory), the worker states, and the committed-checkpoint index.  What it
deliberately does NOT contain:

* the **backend** (a real trainer holds a device and its kernels) —
  re-supplied at restore,
* the **store object** (its write-behind writer thread is unpicklable) —
  the snapshot records the committed cid index instead, plus the raw
  cid→tree map when the store is memory-backed (host copies: a snapshot
  written on a CUDA device holds no CUDA storage and loads in a process
  without one; the trainer moves a restored tree to its device at every
  entry), so a restored in-memory session resumes with every checkpoint
  it had; directory stores are already durable on disk,
* transient scheduling state — the incremental stage tree is a pure memo
  over the plan and is made again cold (identical trees, Algorithm 1 is a
  pure function of the plan).

``capture_session`` flushes the write-behind store first, so the snapshot
is a durability barrier: everything the plan records is committed at the
moment of capture (the flush waits for the pending pinned host copies of
a CUDA state too: a pending entry leaves the store only once its copy has
landed and committed).  On restore, plan checkpoint entries whose blob
the (possibly different) store cannot serve are forgotten up front —
exactly the recompute-on-miss degradation, applied eagerly — so a killed
service recomputes nothing beyond the write-behind puts that had not
committed by the last snapshot.

Snapshots must be taken at an event boundary (between ``engine.step()``
calls — the :class:`~repro_torch.core.study.StudyService` enforces this):
at that point no dispatchable work is in limbo, so the event heap plus the
plan are the whole truth.  Restoring replays the identical event stream —
final :class:`~repro_torch.core.engine.engine.EngineStats` (including the
per-study breakdown) are equal to an uninterrupted run's.

The on-disk format is the v5 container of
:mod:`repro_torch.frontdoor.snapshot_v5` (a JSON manifest + digested
records; ``SESSION_FORMAT_VERSION``); tuners and trials therefore must be
picklable, and their classes must live in ``repro_torch`` (the reader
admits no other package's classes: a snapshot the JAX package wrote never
imports it).  ``StudyHandle`` / ``StudyFuture`` drop their engine/service
references when pickled and are re-wired on restore.  The worker rows keep
the JAX package's eight columns — the mesh a
:class:`~repro_torch.dist.meshes.WorkerMesh` or ``None`` —, and a worker
row carries its captured id and the front door's ``draining`` flag, so a leased fleet with gaps in its ids and a lease
being revoked restore as they were.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set, Tuple

from repro_torch.core.engine.events import EventLoop
from repro_torch.core.scheduler import SchedulingPolicy
from repro_torch.core.searchplan import SearchPlan
from repro_torch.core.trainer import TrainerBackend
from repro_torch.train.checkpoint import CheckpointStore

__all__ = ["SessionState", "SESSION_FORMAT_VERSION", "capture_session",
           "restore_engine", "migrate_session", "save_session",
           "load_session", "save_session_rotated", "load_latest_session",
           "session_rotation", "sweep_session_tmps"]

# v2: EngineStats grew the checkpoint-plane v2 counters; v3: worker tuples
# carry the mesh descriptor; v4: worker tuples carry the fault-plane crash
# record (failures, times_quarantined, quarantined_until) and EngineStats
# grew the fault counters; v5: the on-disk envelope is the schema'd
# container of :mod:`repro_torch.frontdoor.snapshot_v5` and worker tuples
# carry the front door's ``draining`` flag.  States of v2-v4 are MIGRATED
# forward on restore (missing mesh -> thread worker, missing fault fields
# -> clean record, missing stats fields -> dataclass defaults).  v1
# predates the versioned stats migration and stays rejected.
SESSION_FORMAT_VERSION = 5


@dataclass
class SessionState:
    """Picklable engine-session state (see module docstring for scope)."""

    version: int
    plan_key: str
    # ---- engine construction knobs ----
    n_workers: int
    gpus_per_worker: int
    share: bool
    max_steps_per_chain: Optional[int]
    batch_siblings: bool
    chain_fusion: bool
    # ---- live session state ----
    plan: SearchPlan
    events: EventLoop
    scheduler: SchedulingPolicy
    stats: Any                                   # EngineStats
    workers: List[Tuple]                         # (wid, busy_until, idle,
                                                 #  mesh (None),
                                                 #  failures, times_quar.,
                                                 #  quarantined_until,
                                                 #  draining)
    waiters: Dict[Tuple[str, int], List[Tuple[Any, Any]]]
    killed: Set[str]
    trials: Dict[str, Any]
    handles: List[Any]                           # StudyHandle (engine=None)
    study_trials: Dict[str, Set[str]]
    started: Set[str]
    cancelled: Set[str]
    # ---- committed-checkpoint index ----
    store_cids: Set[str] = field(default_factory=set)
    store_mem: Optional[Dict[str, Any]] = None   # memory-backed stores only
    # ---- service plane (opaque to the engine) ----
    service: Dict[str, Any] = field(default_factory=dict)


def capture_session(engine, service: Optional[Dict[str, Any]] = None
                    ) -> SessionState:
    """Freeze a live engine into a :class:`SessionState`.  Flushes the
    write-behind store (durability barrier) before indexing it."""
    engine.store.flush()
    return SessionState(
        version=SESSION_FORMAT_VERSION,
        plan_key=engine.plan.key,
        n_workers=len(engine.workers),
        gpus_per_worker=engine.gpus_per_worker,
        share=engine.share,
        max_steps_per_chain=engine.max_steps_per_chain,
        batch_siblings=engine.batch_siblings,
        chain_fusion=engine.chain_fusion,
        plan=engine.plan,
        events=engine.events,
        scheduler=engine.scheduler,
        stats=engine.stats,
        workers=[(w.wid, w.busy_until, w.idle, w.mesh, w.failures,
                  w.times_quarantined, w.quarantined_until, w.draining)
                 for w in engine.workers],
        waiters=engine.aggregator.waiters,
        killed=engine.aggregator.killed,
        trials=engine._trials,
        handles=engine._handles,
        study_trials=engine._study_trials,
        started=engine._started,
        cancelled=engine._cancelled,
        store_cids=engine.store.committed_ids(),
        store_mem=engine.store.snapshot_trees(),
        service=dict(service or {}),
    )


def migrate_session(state: SessionState) -> SessionState:
    """Upgrade an older readable snapshot to the current format in place.

    * v2 worker rows ``(wid, busy, idle)`` gain ``mesh=None`` (thread
      workers — the only kind v2 could express),
    * v3 rows ``(wid, busy, idle, mesh)`` gain a clean fault record,
    * v4 rows gain ``draining=False`` (no lease was being revoked),
    * a pickled ``EngineStats``/``StudyStats`` restores ``__dict__``
      as-was, so fields added since the snapshot are simply absent —
      fill every missing field with its dataclass default.

    v1 predates versioned stats migration and stays rejected."""
    from repro_torch.core.engine.engine import EngineStats, StudyStats

    if state.version not in (2, 3, 4, SESSION_FORMAT_VERSION):
        raise ValueError(
            f"session format v{state.version} is not migratable to "
            f"v{SESSION_FORMAT_VERSION} — re-snapshot with a matching "
            "repro_torch version")
    rows = []
    for row in state.workers:
        row = tuple(row)
        if len(row) == 3:                      # v2: (wid, busy, idle)
            row += (None,)
        if len(row) == 4:                      # v3: ... + mesh
            row += (0, 0, 0.0)
        if len(row) == 7:                      # v4: ... + fault record
            row += (False,)
        rows.append(row)
    state.workers = rows
    defaults = EngineStats()
    for f in defaults.__dataclass_fields__:
        if not hasattr(state.stats, f):
            setattr(state.stats, f, getattr(defaults, f))
    sdefaults = StudyStats()
    for ss in state.stats.by_study.values():
        for f in sdefaults.__dataclass_fields__:
            if not hasattr(ss, f):
                setattr(ss, f, getattr(sdefaults, f))
    state.version = SESSION_FORMAT_VERSION
    return state


def restore_engine(state: SessionState, backend: TrainerBackend,
                   store: Optional[CheckpointStore] = None,
                   fault_injector=None):
    """Rebuild a live engine from ``state`` + a fresh backend/store.

    The restored engine continues the exact event stream of the captured
    one: same plan object graph, same heap, same clock, same accounting.
    Plan checkpoint entries the supplied store cannot serve are forgotten
    eagerly (recompute-on-miss, applied up front), so a store that lost
    blobs since the snapshot degrades to recomputation instead of
    KeyErrors.  Older snapshot formats are migrated forward (see
    :func:`migrate_session`).  Each worker is rebuilt under its captured
    id, draining or not (a leased fleet has gaps in its ids), and new ids
    continue past the largest, each with its captured mesh."""
    from repro_torch.core.engine.engine import ExecutionEngine

    migrate_session(state)
    if store is None:
        store = CheckpointStore()
    if state.store_mem is not None and not store.directory:
        store.load_trees(state.store_mem)

    meshes = [row[3] for row in state.workers]
    eng = ExecutionEngine(
        state.plan, backend, n_workers=state.n_workers,
        gpus_per_worker=state.gpus_per_worker, scheduler=state.scheduler,
        store=store, share=state.share,
        max_steps_per_chain=state.max_steps_per_chain,
        batch_siblings=state.batch_siblings, chain_fusion=state.chain_fusion,
        worker_meshes=None if all(m is None for m in meshes) else meshes,
        fault_injector=fault_injector)

    # splice the captured session state into the freshly wired components —
    # the dispatcher/aggregator hold references, so patch both sides
    eng.events = state.events
    eng.stats = state.stats
    eng.dispatcher.events = state.events
    eng.dispatcher.stats = state.stats
    eng.aggregator.events = state.events
    eng.aggregator.stats = state.stats
    eng.aggregator.waiters = state.waiters
    eng.aggregator.killed = state.killed
    for w, (wid, busy_until, idle, _, fails, quars, quntil,
            draining) in zip(eng.workers, state.workers):
        w.wid, w.busy_until, w.idle = wid, busy_until, idle
        w.failures, w.times_quarantined = fails, quars
        w.quarantined_until = quntil
        w.draining = bool(draining)
    # ids keep growing where the captured fleet left off — a restored
    # session's next lease grant must not collide with a live wid
    eng._next_wid = 1 + max((row[0] for row in state.workers), default=-1)
    eng._trials = state.trials
    eng._handles = state.handles
    eng._study_trials = state.study_trials
    eng._started = state.started
    eng._cancelled = state.cancelled
    for h in state.handles:
        h.engine = eng

    # eager recompute-on-miss: forget plan checkpoints the store lost
    # (anything written after the snapshot's flush barrier, or an external
    # eviction between snapshot and restore)
    for nid, node in state.plan.nodes.items():
        for step, cid in list(node.ckpts.items()):
            if cid not in state.store_cids or not store.contains(cid):
                state.plan.forget_ckpt(nid, step)
    return eng


# ---------------------------------------------------------------- file I/O
def save_session(state: SessionState, path: str) -> str:
    """Atomically write ``state`` to ``path`` (tmp + rename) in the v5
    schema'd container format (:mod:`repro_torch.frontdoor.snapshot_v5` —
    JSON manifest + digest-verified records).

    The tmp name is pid/thread-unique (like the checkpoint store's):
    overlapping snapshotters — a rolling restart where old and new
    processes both snapshot the same path — each write their own tmp and
    the rename race resolves to one complete snapshot instead of
    interleaved writes publishing a corrupt one."""
    # the codec lives with the front door (the JAX package's also encodes
    # gateway envelopes); imported lazily to keep the engine import-light
    from repro_torch.frontdoor.snapshot_v5 import encode_snapshot

    data = encode_snapshot(state)
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def load_session(path: str):
    """Read a session (or gateway) snapshot — the v5 schema'd container,
    or a legacy v2-v4 session pickle (sniffed by its first bytes) migrated
    forward on restore.  Both are read by the restricted unpickler of
    :mod:`repro_torch.frontdoor.snapshot_v5`.  Digest mismatches, classes
    from outside ``repro_torch`` / ``torch`` / ``numpy`` / the standard
    library, and a legacy pickle that is not a session raise
    ``ValueError`` so the rotation reader falls back to the previous
    slot."""
    from repro_torch.frontdoor.snapshot_v5 import (decode_snapshot,
                                                   is_v5_snapshot,
                                                   restricted_loads)

    with open(path, "rb") as f:
        data = f.read()
    if is_v5_snapshot(data):
        return decode_snapshot(data)
    state = restricted_loads(data)             # legacy: versioned pickle
    if not isinstance(state, SessionState):
        raise ValueError(f"{path!r} is not a repro_torch session snapshot")
    return state


# ----------------------------------------------------- rotated snapshots
def _pid_alive(pid: int) -> bool:
    if pid == os.getpid():
        return True
    try:
        os.kill(pid, 0)                # signal 0: existence probe only
        return True
    except ProcessLookupError:
        return False
    except OSError:
        return True                    # EPERM etc: exists, not ours


def session_rotation(base: str) -> List[Tuple[int, str]]:
    """Existing rotation slots ``base.<seq>``, newest (highest seq) first."""
    d = os.path.dirname(os.path.abspath(base))
    prefix = os.path.basename(base) + "."
    out = []
    try:
        names = os.listdir(d)
    except OSError:
        return []
    for name in names:
        suffix = name[len(prefix):] if name.startswith(prefix) else ""
        if suffix.isdigit():
            out.append((int(suffix), os.path.join(d, name)))
    return sorted(out, reverse=True)


def sweep_session_tmps(base: str) -> int:
    """Sweep orphaned snapshot tmps of DEAD writers across *every*
    rotation slot of ``base`` (and the base path itself); returns the
    count removed.  The tmp name embeds the writer's pid, so a live
    concurrent writer keeps its in-flight tmp and its os.replace still
    lands.  Called after each rotated write AND at startup
    (:func:`load_latest_session`) — a writer that crashed mid-write into a
    slot no later writer touches would otherwise leak its tmp forever."""
    d = os.path.dirname(os.path.abspath(base))
    prefix = os.path.basename(base) + "."
    swept = 0
    try:
        names = os.listdir(d)
    except OSError:
        return 0
    for name in names:
        if not (name.startswith(prefix) and ".tmp." in name):
            continue
        pid_s = name.rsplit(".tmp.", 1)[1].split(".", 1)[0]
        if pid_s.isdigit() and _pid_alive(int(pid_s)):
            continue
        try:
            os.unlink(os.path.join(d, name))
            swept += 1
        except OSError:
            pass
    return swept


def save_session_rotated(state: SessionState, base: str,
                         keep: int = 3) -> str:
    """Write the next rotation slot ``base.<seq>`` atomically and prune
    slots beyond the newest ``keep`` — the continuous-durability sink of
    ``StudyService.enable_auto_snapshot``.  Readers
    (:func:`load_latest_session`) fall back through the rotation, so a
    crash mid-write (torn tmp, or a SIGKILL between write and rename)
    costs one slot, never the session."""
    slots = session_rotation(base)
    seq = (slots[0][0] + 1) if slots else 1
    path = save_session(state, f"{base}.{seq}")
    for _, stale in slots[max(0, keep - 1):]:
        try:
            os.unlink(stale)
        except OSError:
            pass
    sweep_session_tmps(base)
    return path


def load_latest_session(base: str) -> Tuple[SessionState, str]:
    """(state, path) from the newest *readable* rotation slot of ``base``.

    A truncated, corrupt or non-snapshot newest slot (the process died
    mid-publish, disk lost a tail) falls back to the previous slot —
    restore loses at most one snapshot interval.  Raises
    ``FileNotFoundError`` when no slot is readable."""
    # startup sweep: reclaim tmps a crashed writer left in ANY slot —
    # including slots the new process will never write again
    sweep_session_tmps(base)
    failures = []
    for _, path in session_rotation(base):
        try:
            return load_session(path), path
        except Exception as exc:  # truncation, bad pickle, foreign file
            failures.append(f"{path}: {type(exc).__name__}: {exc}")
    detail = ("; unreadable: " + "; ".join(failures)) if failures else ""
    raise FileNotFoundError(
        f"no readable session snapshot in rotation {base!r}.N{detail}")
