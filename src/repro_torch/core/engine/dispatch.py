"""Chain dispatch — scheduling rounds and worker-side chain execution.

Each round the dispatcher asks the :class:`~repro_torch.core.stagetree.StageTreeBuilder`
for the current stage tree (incrementally maintained — O(changed requests),
not O(plan)), hands it to the scheduling policy, and executes the extracted
chains on idle virtual workers.

Chain-fused execution (``chain_fusion``, default on for capable backends):
a whole scheduler-extracted chain runs through ``backend.run_chain`` — the
state carry stays on device across stage boundaries, with no
``store.get``/``store.put`` round-trip and no re-dispatch between
consecutive stages — and every boundary checkpoint is deposited
**write-behind** (``store.put_async``: pending cache + background commit),
so the worker never stalls on checkpoint I/O.  The virtual clock keeps
stage granularity: the measured chain wall is apportioned over the stages
by step count (simulated backends keep exact per-stage durations), and a
``stage`` event still lands per boundary, so aggregation, tuner callbacks,
kills and GC observe exactly the per-stage event stream of the unfused
loop.  A kill that lands mid-chain therefore behaves as before: the
completed prefix's checkpoints are already recorded (pending writes are
served to readers and cancelled by eviction), the dead suffix is evicted
on arrival.

Checkpoint-plane accounting: ``ckpt_save_seconds`` / ``ckpt_load_seconds``
time every store interaction, and the synchronous slice of in-window saves
is subtracted from measured stage walls — profiles and the virtual clock
stay execution-only.

Spans (:mod:`repro_torch.utils.tracing`): ``ckpt.get`` around the store
read of a resume checkpoint, ``ckpt.put`` around each boundary deposit;
every work unit — a chain, a group, a degraded group's member — runs
inside ``tracing.unit`` of its :meth:`Dispatcher._unit_key`, so all of
its spans, the trainer's included, carry that key.

Recompute-on-miss: a resume checkpoint the plan still lists but the store
has dropped (external eviction) does not raise — the dispatcher counts a
``ckpt_miss``, tells the plan to forget the stale entry, refunds the
scheduler, and re-runs the round: Algorithm 1 re-derives the request from
whatever remains (an earlier checkpoint, an ancestor, or a fresh model).

Sibling-group pass (``batch_siblings``): before the chain pass, each
round gathers ready sibling stages that train the same ``[start, stop)``
with the same static hps, hp names and batch-size schedule
(:func:`~repro_torch.core.stagetree.sibling_groups`; under chain fusion
:func:`~repro_torch.core.stagetree.sibling_chain_groups`, extended down
parallel chains and cut by ``max_steps_per_chain``) and executes each group
on one idle worker as batched backend calls — ``run_stages_batched`` for
depth 1, ``run_chains_batched`` otherwise — over deduplicated,
copy-on-fanout resume loads.  A group with fewer than two surviving
members is refunded to the chain pass; a ``ValueError`` from the backend
(an in-flight incompatibility) falls back to member-sequential chains,
counted as not batched.  Each member's boundary checkpoints are written
behind with its own ``parent_cid`` thread, and stages are credited level
by level (``batched_groups``, ``batched_stages``).

Failure domains (the fault plane, :mod:`repro_torch.core.faults`): every
work unit — a chain, a batched group, one member of a degraded group —
runs inside a ``try``.  A failed unit is absorbed by :meth:`_fail_unit`:
its cost goes to ``wasted_gpu_seconds`` only, the scheduler is refunded,
its requests stay marked running (Algorithm 1 defers them) until a
``retry`` event at ``t_fail + backoff`` on the virtual clock clears them,
and the next round re-executes them from the last committed boundary.  A
:class:`~repro_torch.core.faults.WorkerCrashed` feeds the worker's crash
record (quarantine after ``quarantine_after`` crashes, probation doubling
up to 8×); a transient failure of a batched group degrades the group to
solo runs of its members (``run_chain`` each); fatal or retry-exhausted
faults propagate after the books are balanced.  With an injector
attached, every re-put of a committed boundary is held bit for bit
against the committed tree (:meth:`_assert_retry_identical`, read through
the raw store, so it draws nothing from the fault schedule).

Cross-tier retries: on a backend whose group tier does not give solo
bits (``batched_bitwise_solo`` false: TorchTrainer's vectorised tier), a
unit that fails after some of its boundary puts committed takes those
puts back (evicted; no event ever announced them), so its retry commits
afresh on whichever tier runs it instead of re-putting a boundary the
other tier committed — the retry check stays bitwise.

Mesh workers: a worker may own a device set
(:class:`~repro_torch.dist.meshes.WorkerMesh`).  Placement then goes
through :meth:`Dispatcher._place`: workers whose mesh the backend rejects
for the work (``backend.mesh_compatible`` — the divisibility gate) are
skipped (``placement_rejections``), and among the compatible ones the
scheduling policy's ``placement_hint`` picks narrow ("wide": sibling
groups batch trials) or wide ("deep": solo chains shard the model).
Boundary states of finished chains additionally populate a small
host-local **d2d cache**: a resume whose producer ran on the same host is
served by ``backend.device_transfer`` (``d2d_handoffs``; no store
round-trip, same virtual-clock and ``ckpt_loads`` accounting), falling
back to the store across hosts, after eviction, or when the backend
declines.  An entry is the backend's own copy of the boundary state (a
producing chain trains on from its carry), so a hit never hands out
tensors another holder can change.
"""

from __future__ import annotations

import time as _time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.scheduler import SchedulingPolicy
from repro_torch.core.searchplan import Request, SearchPlan
from repro_torch.core.stagetree import (Stage, StageTreeBuilder,
                                        sibling_chain_groups, sibling_groups)
from repro_torch.core.engine.events import EventLoop
from repro_torch.core.faults import (TransientStageError, WorkerCrashed,
                                     is_transient, raw_store)
from repro_torch.core.trainer import (ChainNotFusable, StageContext,
                                      TrainerBackend)
from repro_torch.train.checkpoint import CheckpointStore
from repro_torch.utils import tracing
from repro_torch.utils.tree import tree_leaves, tree_map

__all__ = ["Worker", "Dispatcher"]


@dataclass
class Worker:
    """One worker: a thread on the local device slot, or the owner of a
    device set (``mesh``)."""

    wid: int
    busy_until: float = 0.0
    idle: bool = True
    #: device set this worker owns (None = classic 1-slot thread worker)
    mesh: Optional[Any] = None
    # ---- fault plane: crash record feeding quarantine (see
    # Dispatcher._crash_worker).  A quarantined worker simply stays
    # non-idle until its probation "idle" event fires — no placement-path
    # filtering needed, and quarantine always expires. ----
    failures: int = 0               # crashes since the last success
    times_quarantined: int = 0      # consecutive quarantines (backoff exp)
    quarantined_until: float = 0.0  # virtual time probation starts
    # ---- front door (lease revocation; see repro_torch.frontdoor.leases).
    # A draining worker finishes its current chain but is never offered
    # new work; the engine removes it when its idle event fires —
    # revocation lands exactly at a chain boundary, where the retry
    # machinery guarantees every boundary checkpoint is committed. ----
    draining: bool = False

    @property
    def host(self) -> str:
        return self.mesh.host if self.mesh is not None else "host0"

    @property
    def devices(self) -> int:
        return self.mesh.n_devices if self.mesh is not None else 1


class Dispatcher:
    def __init__(self, plan: SearchPlan, backend: TrainerBackend,
                 scheduler: SchedulingPolicy, store: CheckpointStore,
                 events: EventLoop, stats, workers: List[Worker],
                 gpus_per_worker: int = 1,
                 max_steps_per_chain: Optional[int] = None,
                 tree_builder: Optional[StageTreeBuilder] = None,
                 batch_siblings: bool = False,
                 chain_fusion: bool = False):
        self.plan = plan
        self.backend = backend
        self.scheduler = scheduler
        self.store = store
        self.events = events
        self.stats = stats
        self.workers = workers
        self.gpus_per_worker = gpus_per_worker
        self.max_steps_per_chain = max_steps_per_chain
        self.tree_builder = tree_builder or StageTreeBuilder(plan)
        self.batch_siblings = batch_siblings
        self.chain_fusion = chain_fusion
        # store and kernel counters at attach time: EngineStats mirrors
        # *deltas* over these baselines, so an engine attached to a store
        # (or a backend) that already served another session accumulates
        # only its own growth, and a restored session accumulates onto its
        # snapshot totals instead of clobbering them
        self._store_base = self._seed_store_base()
        self._kernel_base = self._kernel_counters()
        # d2d handoff cache: boundary cid -> (state, producing host,
        # producing wid); the wid lets a worker crash invalidate the
        # boundary states its devices held.  Only active on mesh fleets, so
        # thread-worker runs keep their store-counter behaviour bit for
        # bit; transient by design (not snapshotted — a restored session
        # falls back to the store).
        self._d2d_enabled = any(w.mesh is not None for w in workers)
        self._d2d: "OrderedDict[str, Tuple[Any, str, int]]" = OrderedDict()
        self._d2d_cap = 16
        # ---- fault plane (failure domains; see core/faults.py) ----
        # Retry backoff runs on the VIRTUAL clock: a failed work unit keeps
        # its requests marked running (Algorithm 1 defers them), and a
        # "retry" event at t_fail + backoff clears the marks so the next
        # round re-derives the work from the boundary checkpoint.
        self.retry_backoff_base = 2.0
        self.retry_backoff_cap = 60.0
        self.max_stage_retries = 8       # per work unit; beyond -> fatal
        self.quarantine_after = 2        # crashes before quarantine
        self.quarantine_seconds = 120.0  # base probation (doubles, capped 8x)
        self._retry_attempts: Dict[str, int] = {}
        self._injector = getattr(backend, "fault_injector", None)
        self._fault_base = self._injector.injected if self._injector else 0

    # ------------------------------------------------------------ scheduling
    def assign(self) -> None:
        # a checkpoint miss mutates the plan (the stale entry is forgotten)
        # and leaves its requests pending with the worker still idle: re-run
        # the round so Algorithm 1 re-derives them.  Each retry forgets at
        # least one stale checkpoint entry, so the loop terminates.
        while self._assign_round():
            pass
        self._sync_kernel_stats()
        self._sync_store_stats()
        self._sync_fault_stats()

    def _kernel_counters(self) -> Optional[Tuple[int, int]]:
        calls = getattr(self.backend, "kernel_calls", None)
        if calls is None:
            return None
        return calls, self.backend.kernel_fallbacks

    def _sync_kernel_stats(self) -> None:
        """Mirror the backend's kernel-plane counters (call / fallback
        counts) into ``EngineStats`` as growth since this dispatcher
        attached: a restored session runs a fresh backend, and its totals
        continue the snapshot's."""
        now = self._kernel_counters()
        if now is None:
            return
        self.stats.kernel_calls += now[0] - self._kernel_base[0]
        self.stats.kernel_fallbacks += now[1] - self._kernel_base[1]
        self._kernel_base = now

    # EngineStats field <- CheckpointStore counter (mirrored as deltas)
    _STORE_MIRROR = {
        "ckpt_delta_bytes": "delta_bytes",
        "ckpt_full_bytes": "full_bytes",
        "ckpt_logical_bytes": "logical_bytes",
        "ckpt_bytes_written": "bytes_written",
        "ckpt_delta_commits": "delta_commits",
        "ckpt_delta_rebases": "delta_rebases",
        "ckpt_mem_hits": "mem_hits",
        "ckpt_disk_hits": "disk_hits",
        "ckpt_remote_hits": "remote_hits",
        "ckpt_store_misses": "store_misses",
        "ckpt_tier_promotions": "tier_promotions",
        "ckpt_tier_demotions": "tier_demotions",
        "ckpt_tmp_reclaimed": "tmp_reclaimed",
    }

    def _store_counters(self) -> Dict[str, int]:
        return {f: getattr(self.store, a, 0)
                for f, a in self._STORE_MIRROR.items()}

    def _seed_store_base(self) -> Dict[str, int]:
        base = self._store_counters()
        # the init-time temp sweep happened before any dispatcher could
        # attach; zero its baseline so the first sync surfaces the count
        base["ckpt_tmp_reclaimed"] = 0
        return base

    def _sync_store_stats(self) -> None:
        """Mirror the checkpoint-plane counters into ``EngineStats``.

        The store outlives engines (service sessions share one store
        across studies), so each dispatcher accumulates only the counter
        *growth since it attached*."""
        now = self._store_counters()
        for field in self._STORE_MIRROR:
            grown = now[field] - self._store_base[field]
            if grown:
                setattr(self.stats, field,
                        getattr(self.stats, field) + grown)
        self._store_base = now

    def _sync_fault_stats(self) -> None:
        """Mirror the injector's fired-fault count into ``EngineStats`` as
        growth deltas (like the store counters: a restored session keeps
        its snapshot total and accumulates from there)."""
        if self._injector is None:
            return
        grown = self._injector.injected - self._fault_base
        if grown:
            self.stats.faults_injected += grown
            self._fault_base = self._injector.injected

    def _assign_round(self) -> bool:
        """One scheduling round; True when a checkpoint miss warrants a
        retry (idle workers remain and requests were re-derived)."""
        idle = [w for w in self.workers if w.idle and not w.draining]
        if not idle:
            return False
        tree = self.tree_builder.build()
        if not tree.stages:
            return False
        self.stats.rounds += 1
        missed = False
        # stage_id -> (state, finish_time, cid) for cross-chain chaining
        # this round
        produced: Dict[str, Tuple[Any, float, Optional[str]]] = {}
        taken: set = set()

        if self.batch_siblings:
            idle, missed = self._group_pass(tree, idle, produced, taken)

        # chain pass over an explicit in-round pool: a deferred chain's
        # worker returns to the pool and is offered another path, and a
        # refill asks the scheduler for more chains when deferrals freed
        # capacity
        pool = list(idle)
        pending: List[List[Stage]] = []
        exhausted = False

        def refill() -> None:
            nonlocal exhausted
            if exhausted or not pool:
                return
            got = self.scheduler.assign(self.plan, tree, len(pool),
                                        taken=taken)
            if len(got) < len(pool):
                exhausted = True
            pending.extend(got)

        refill()
        while pool and pending:
            path = pending.pop(0)
            if self.max_steps_per_chain:
                full = path
                path = self._truncate(full)
                if len(path) < len(full):
                    # refund the cut tail: it reschedules in a later round
                    self.scheduler.on_stages_unassigned(
                        self.plan, full[len(path):])
            worker = self._place(pool, [path])
            if worker is None:
                # every compatible worker is busy — refund; the stages stay
                # taken this round and re-extract in a later one
                self.scheduler.on_stages_unassigned(self.plan, path)
            else:
                pool.remove(worker)
                with tracing.unit(self._unit_key(path)):
                    status = self._execute_chain(path, worker, produced)
                if status == "miss":
                    missed = True
                elif status in ("deferred", "failed"):
                    # "failed": the unit failed before claiming the worker
                    # (resume-load outage) — the retry is scheduled and the
                    # worker can still host other work this round
                    pool.append(worker)
            if not pending:
                refill()
        return missed and any(w.idle and not w.draining
                              for w in self.workers)

    def _group_pass(self, tree, idle: List[Worker],
                    produced: Dict[str, Tuple[Any, float, Optional[str]]],
                    taken: set) -> Tuple[List[Worker], bool]:
        """Execute the round's sibling groups, each on the worker
        :meth:`_place` picks; returns the workers still idle and whether a
        resume checkpoint was missed."""
        if self.chain_fusion:
            # groups extend down parallel chains with identical per-stage
            # signatures; the per-dispatch work cap applies to them like
            # any chain: members share per-level step counts, so one
            # member's truncation depth bounds the whole group, and cut
            # levels were never claimed (they reschedule in a later round)
            groups = sibling_chain_groups(self.plan, tree)
            if self.max_steps_per_chain:
                groups = [[c[:len(self._truncate(g[0]))] for c in g]
                          for g in groups]
        else:
            groups = [[[st] for st in g]
                      for g in sibling_groups(self.plan, tree)]
        idle = list(idle)
        missed = False
        for group in groups:
            if not idle:
                break
            worker = self._place(idle, group)
            if worker is None:
                # no compatible idle worker: the stages were never claimed
                # and fall through to the chain pass / a later round
                continue
            with tracing.unit(self._unit_key(group[0])):
                ran, miss = self._execute_group(group, worker, produced,
                                                taken)
            missed |= miss
            if ran:
                idle.remove(worker)
        return idle, missed

    # -------------------------------------------------------------- placement
    def _place(self, candidates: List[Worker],
               chains: List[List[Stage]]) -> Optional[Worker]:
        """Pick a worker for one work unit (a chain, or a sibling-chain
        group) from ``candidates``: drop mesh workers the backend rejects
        for this work (``placement_rejections``), then let the scheduling
        policy's placement hint trade batch width against shard width.
        Ties resolve to the earliest candidate, so a homogeneous fleet
        places exactly like the classic first-idle dispatcher.

        Rejection redirects work when an alternative exists; when EVERY
        candidate is rejected the narrowest one hosts the work anyway
        (replicated on a mesh it cannot shard over) — an all-incompatible
        fleet must degrade, not starve the plan."""
        ctxs = [self._ctx_for(st) for chain in chains for st in chain]
        eligible = []
        for w in candidates:
            if w.mesh is not None and not self.backend.mesh_compatible(
                    w.mesh, ctxs):
                self.stats.placement_rejections += 1
                continue
            eligible.append(w)
        if not eligible:
            return min(candidates, key=lambda w: w.devices)
        hint = self.scheduler.placement_hint(self.plan, chains, eligible)
        if hint == "wide":
            return min(eligible, key=lambda w: w.devices)
        if hint == "deep":
            return max(eligible, key=lambda w: w.devices)
        return eligible[0]

    def _worker_gpus(self, worker: Worker) -> int:
        """Accounting width of a worker: its mesh size, or the engine-wide
        ``gpus_per_worker`` for thread workers."""
        return (worker.mesh.n_devices if worker.mesh is not None
                else self.gpus_per_worker)

    def _bind(self, worker: Worker) -> None:
        """Claim ``worker`` for a unit and bind the backend to its mesh."""
        worker.idle = False
        self.backend.set_mesh(worker.mesh)
        if worker.mesh is not None:
            self.stats.mesh_placements += 1

    def _truncate(self, path: List[Stage]) -> List[Stage]:
        out, steps = [], 0
        for st in path:
            out.append(st)
            steps += st.steps
            if steps >= self.max_steps_per_chain:
                break
        return out

    # ---------------------------------------------------------- resume input
    def _load_resume(self, nid: str, step: int,
                     worker: Optional[Worker] = None
                     ) -> Optional[Tuple[Any, str]]:
        """(state, cid) of checkpoint (node, step), or None after degrading
        a vanished checkpoint to recompute: count the miss and make the
        plan forget the stale entry so the next round re-derives the
        request.  A checkpoint the plan no longer lists (already forgotten
        earlier this round) is not a fresh miss — one eviction counts once.
        The cid rides along as the fork-point parent of the chain's first
        boundary checkpoint.

        On mesh fleets, a boundary state produced on ``worker``'s host is
        served device-to-device (``backend.device_transfer``) with no
        store round-trip; the virtual-clock and ``ckpt_loads`` accounting
        is the caller's and stays identical either way."""
        cid = self.plan.node(nid).ckpts.get(step)
        if cid is None:
            return None
        if self._d2d_enabled and worker is not None:
            entry = self._d2d.get(cid)
            if entry is not None and entry[1] == worker.host:
                moved = self.backend.device_transfer(entry[0], worker.mesh)
                if moved is not None:
                    self._d2d.move_to_end(cid)
                    self.stats.d2d_handoffs += 1
                    return moved, cid
        t0 = _time.perf_counter()
        try:
            with tracing.span("ckpt.get"):
                return self.store.get(cid), cid
        except KeyError:
            pass
        finally:
            self.stats.ckpt_load_seconds += _time.perf_counter() - t0
        self.stats.ckpt_misses += 1
        self.plan.forget_ckpt(nid, step)
        return None

    def _d2d_put(self, cid: str, state: Any, worker: Worker) -> None:
        """Retain a copy of a boundary state for host-local handoff
        (LRU-bounded; content addressing keeps a stale entry harmless —
        the plan simply stops asking for its cid).  The copy is the
        backend's ``device_transfer`` to the producing worker's mesh; a
        backend that declines caches nothing."""
        if not self._d2d_enabled:
            return
        copy = self.backend.device_transfer(state, worker.mesh)
        if copy is None:
            return
        self._d2d[cid] = (copy, worker.host, worker.wid)
        self._d2d.move_to_end(cid)
        while len(self._d2d) > self._d2d_cap:
            self._d2d.popitem(last=False)

    def _take_back(self, cids: List[str]) -> None:
        """A failed unit's committed but unannounced boundary puts, on a
        backend whose group and solo tiers differ in bits: evict them (and
        their d2d copies), so the retry — on either tier — commits afresh
        instead of re-putting a boundary the other tier committed.  On a
        bitwise backend the re-put stays, and is verified."""
        if self.backend.batched_bitwise_solo:
            return
        for cid in cids:
            self.store.evict(cid)
            self._d2d.pop(cid, None)

    @tracing.traced("ckpt.put")
    def _put_boundary(self, path_key: str, stop: int, state: Any,
                      parent_cid: Optional[str] = None) -> str:
        """Deposit one stage-boundary checkpoint — write-behind under chain
        fusion (enqueue only; the commit overlaps the next stage's
        compute), synchronous otherwise.  The synchronous slice is timed
        into ``ckpt_save_seconds`` either way."""
        if self._injector is not None:
            self._assert_retry_identical(path_key, stop, state)
        t0 = _time.perf_counter()
        if self.chain_fusion:
            cid = self.store.put_async(path_key, stop, state,
                                       parent_cid=parent_cid)
            self.stats.ckpt_async_writes += 1
        else:
            cid = self.store.put(path_key, stop, state,
                                 parent_cid=parent_cid)
        self.stats.ckpt_save_seconds += _time.perf_counter() - t0
        self.stats.ckpt_saves += 1
        return cid

    def _assert_retry_identical(self, path_key: str, stop: int,
                                state: Any) -> None:
        """Retry determinism assertion (fault schedules only): a re-put of
        an already-committed boundary cid means the stage was recomputed —
        after a retry or a recompute-on-miss — and content addressing
        demands the recomputed state be bit-identical to the committed
        one.  Bit patterns, not values (``-0.0`` and ``0.0`` differ, a NaN
        equals its own bits), with no tolerance.  Verified against the raw
        store (no outage draws) so the check never perturbs the fault
        schedule."""
        store = raw_store(self.store)
        cid = store.ckpt_id(path_key, stop)
        try:
            prior = store.get(cid)
        except KeyError:
            return
        same = (tree_map(_no_leaf, prior) == tree_map(_no_leaf, state)
                and all(_same_bits(a, b) for a, b in
                        zip(tree_leaves(prior), tree_leaves(state))))
        if not same:
            raise RuntimeError(
                f"retry produced a different state for committed boundary "
                f"{cid} ({path_key}@{stop}) — stage execution is not "
                "deterministic, content addressing is violated")
        self._injector.retries_verified += 1

    # --------------------------------------------------------- failure domain
    def _unit_key(self, stages: List[Stage]) -> str:
        return f"{stages[0].node_id}:{stages[0].stop}"

    def _fail_unit(self, worker: Worker, stages: List[Stage],
                   exc: BaseException, t_fail: float, waste: float,
                   release_worker: bool) -> float:
        """Absorb one failed work unit (a chain, a batched group, or one
        member of a degraded group).

        The attempt's cost goes to ``wasted_gpu_seconds`` only — never
        ``gpu_seconds`` and never the sharing studies' fair-share split.
        The scheduler is refunded, the failed stages' requests stay marked
        running (Algorithm 1 defers them — the backoff), and a ``retry``
        event at ``t_fail + backoff`` clears the marks so the next round
        re-executes from the boundary checkpoint.  A crash additionally
        feeds the worker's quarantine record.  ``release_worker`` pushes
        the idle event for callers that consumed the worker (a quarantined
        worker returns when probation starts).  Fatal or retry-exhausted
        faults re-raise after the books are balanced.  Returns the
        worker's rejoin time (``t_fail``, or probation start after a
        quarantining crash)."""
        self.stats.stage_failures += 1
        if waste > 0:
            self.stats.wasted_gpu_seconds += waste
        self.scheduler.on_stages_unassigned(self.plan, stages)
        reqs = [Request(st.node_id, st.stop) for st in stages]
        back_at = t_fail
        if isinstance(exc, WorkerCrashed):
            back_at = self._crash_worker(worker, t_fail)
        if release_worker:
            worker.busy_until = back_at
            self.events.push(back_at, "idle", worker.wid)
        key = self._unit_key(stages)
        attempts = self._retry_attempts.get(key, 0) + 1
        self._retry_attempts[key] = attempts
        if not is_transient(exc) or attempts > self.max_stage_retries:
            # release the running marks so a supervisor restart (session
            # restore) can re-derive the work, then propagate
            self.plan.clear_running(reqs)
            raise exc
        self.stats.stage_retries += 1
        backoff = min(self.retry_backoff_cap,
                      self.retry_backoff_base * 2 ** (attempts - 1))
        self.plan.mark_running(reqs)
        self.events.push(t_fail + backoff, "retry",
                         [(st.node_id, st.stop) for st in stages])
        return back_at

    def _crash_worker(self, worker: Worker, t_fail: float) -> float:
        """Record one crash; returns the virtual time the worker rejoins
        the pool.  Repeat crashers are quarantined with exponentially
        growing (capped) probation; any boundary states their devices held
        in the d2d cache are invalidated.  Quarantine is just a delayed
        idle event, so it always expires — probation re-admission is the
        default, and a worker that then succeeds clears its record."""
        worker.failures += 1
        for cid in [c for c, e in self._d2d.items() if e[2] == worker.wid]:
            del self._d2d[cid]
        if worker.failures < self.quarantine_after:
            return t_fail
        worker.times_quarantined += 1
        dur = self.quarantine_seconds * min(
            8.0, 2.0 ** (worker.times_quarantined - 1))
        worker.quarantined_until = t_fail + dur
        self.stats.workers_quarantined += 1
        return worker.quarantined_until

    def _worker_recovered(self, worker: Worker) -> None:
        """A unit completed on ``worker``: probation over, record cleared."""
        worker.failures = 0
        worker.times_quarantined = 0

    def _unit_succeeded(self, stages: List[Stage]) -> None:
        """A unit completed: reset its retry budget.  ``max_stage_retries``
        bounds *consecutive* failures of one unit — without the reset, a
        unit that fails, recovers, and fails again across a long session
        accrues attempts across unrelated incidents until a perfectly
        recoverable fault is misclassified as exhausted."""
        self._retry_attempts.pop(self._unit_key(stages), None)

    def on_retry(self, reqs: List[Tuple[str, int]]) -> None:
        """A retry backoff expired (engine ``retry`` event): clear the
        running marks so the dispatcher round that follows re-derives the
        requests — Algorithm 1 resumes them from the last boundary
        checkpoint that actually committed."""
        self.plan.clear_running([Request(nid, stop) for nid, stop in reqs])

    def _waste_of(self, stages: List[Stage], wall: float,
                  gpus: int) -> float:
        """GPU-seconds burned by a failed attempt over ``stages``:
        simulated durations when the backend provides them (virtual-clock
        backends), else the measured wall."""
        total = 0.0
        for st in stages:
            sim = self.backend.stage_seconds(self._ctx_for(st))
            total += sim if sim is not None else wall / max(1, len(stages))
        return total * gpus

    # ------------------------------------------------------ study accounting
    def _credit_stage(self, st: Stage, dur: float, gpus: int) -> None:
        """Per-study breakdown (``EngineStats.by_study``): split the
        stage's execution seconds evenly across the studies it serves
        (reuse is free capacity — each sharing study pays 1/k), but count
        ``steps_run``/``stages_run`` in full per serving study, so the
        per-study step sums exceed the physical total exactly when stages
        are shared.  ``gpus`` is the executing worker's device width.
        Work with no study attribution (direct ``plan.submit`` without
        ``study=``) is left out of the breakdown."""
        studies = set()
        for tid in self.plan.node(st.node_id).trials:
            studies |= self.plan.studies_of_trial(tid)
        if not studies:
            return
        share = dur * gpus / len(studies)
        for s in sorted(studies):
            ss = self.stats.study(s)
            ss.gpu_seconds += share
            ss.stages_run += 1
            ss.steps_run += st.steps

    def _ctx_for(self, st: Stage) -> StageContext:
        node = self.plan.node(st.node_id)
        return StageContext(
            node_id=st.node_id, desc=node.desc, node_start=node.start,
            start=st.start, stop=st.stop,
            path_key=self.plan.path_key(st.node_id))

    def _adjusted_wall(self, wall0: float, save0: float) -> float:
        """Measured wall minus the synchronous slice of in-window
        checkpoint saves: write-behind saves overlap the next stage, so
        they may not pollute seconds/step profiles or the virtual
        clock."""
        wall = _time.perf_counter() - wall0
        save = self.stats.ckpt_save_seconds - save0
        return max(0.0, wall - save)

    # ------------------------------------------------------- chain execution
    def _execute_chain(self, path: List[Stage], worker: Worker,
                       produced: Dict[str, Tuple[Any, float,
                                                 Optional[str]]]) -> str:
        """Execute one chain on ``worker``.  Returns ``"ran"``, ``"miss"``
        (checkpoint vanished — the caller retries the round),
        ``"deferred"`` (in-round input truncated away — the caller returns
        the worker to the round's pool) or ``"failed"`` (the resume load
        failed before the worker was claimed — the retry is scheduled and
        the worker returns to the pool).  A failure mid-execution returns
        ``"ran"``: the worker burned time on the attempt and its idle
        event is scheduled by the failure domain."""
        head = path[0]
        t = max(self.events.time, worker.busy_until)
        load_s, save_s = self.backend.overheads()
        gpus = self._worker_gpus(worker)

        # ------- input state (parent_cid = the fork-point checkpoint of
        # the chain's first boundary)
        if head.resume is not None:
            nid, step = head.resume
            try:
                loaded = self._load_resume(nid, step, worker)
            except Exception as exc:
                # store outage (or kin) on the resume load: the worker was
                # never claimed — refund, schedule the retry, keep the
                # worker in the round's pool
                self._fail_unit(worker, path, exc, t, 0.0,
                                release_worker=False)
                return "failed"
            if loaded is None:
                # resume checkpoint externally dropped — leave the requests
                # pending; the retried round re-derives them from the plan
                self.scheduler.on_stages_unassigned(self.plan, path)
                return "miss"
            state, parent_cid = loaded
            t += load_s
            self.stats.gpu_seconds += load_s * gpus
            self.stats.ckpt_loads += 1
        elif head.parent is not None:
            if head.parent not in produced:
                # parent chain was truncated before producing our input —
                # leave the requests pending; a later round reschedules them
                worker.idle = True
                self.stats.chains_deferred += 1
                self.scheduler.on_stages_unassigned(self.plan, path)
                return "deferred"
            # produced by another chain in this same round
            state, parent_done, parent_cid = produced[head.parent]
            t = max(t, parent_done) + load_s
            self.stats.gpu_seconds += load_s * gpus
            self.stats.ckpt_loads += 1
        else:
            state = self.backend.init_state()
            parent_cid = None

        self._bind(worker)
        if self.chain_fusion:
            self._run_chain_fused(path, worker, state, t, produced,
                                  parent_cid)
            return "ran"

        for i, st in enumerate(path):
            ctx = self._ctx_for(st)
            self.plan.mark_running([Request(st.node_id, st.stop)])

            wall0 = _time.perf_counter()
            try:
                if st.steps > 0:
                    state = self.backend.run_stage(state, ctx)
                metrics = (self.backend.evaluate(state, ctx) if st.report
                           else None)
                wall = self._adjusted_wall(wall0,
                                           self.stats.ckpt_save_seconds)
                sim = self.backend.stage_seconds(ctx)
                # commit the boundary BEFORE any accounting: a failed put
                # leaves this stage entirely un-happened (no stats, no
                # event) and the whole suffix retries from the last
                # committed boundary
                cid = self._put_boundary(ctx.path_key, st.stop, state,
                                         parent_cid=parent_cid)
            except Exception as exc:
                waste = self._waste_of([st],
                                       _time.perf_counter() - wall0, gpus)
                self._fail_unit(worker, path[i:], exc, t, waste,
                                release_worker=True)
                return "ran"   # worker consumed; idle event is scheduled

            dur = sim if sim is not None else wall
            if st.report:
                dur += getattr(self.backend, "eval_seconds", 0.0)
                self.stats.evals_run += 1
            dur += save_s  # checkpoint at every stage boundary
            t += dur
            self.stats.gpu_seconds += dur * gpus
            self.stats.stages_run += 1
            self.stats.steps_run += st.steps
            self._credit_stage(st, dur, gpus)

            if st.steps > 0:
                self.plan.record_profile(
                    st.node_id, (sim if sim is not None else wall) / st.steps)
            parent_cid = cid
            self._d2d_put(cid, state, worker)
            produced[st.stage_id] = (state, t, cid)
            self.events.push(t, "stage", {
                "node_id": st.node_id, "stop": st.stop, "cid": cid,
                "metrics": metrics, "worker": worker.wid,
                "last": st is path[-1]})
        worker.busy_until = t
        self._worker_recovered(worker)
        self._unit_succeeded(path)
        return "ran"

    # ------------------------------------------------- fused chain execution
    def _stages_of(self, path: List[Stage], ctxs: List[StageContext],
                   state: Any) -> Tuple[List[Any], bool]:
        """Boundary states of ``path`` run as one fused chain, or — when
        the backend refuses the chain as a whole (its stages do not fuse)
        — by the per-stage loop (same semantics, no fusion credit)."""
        try:
            return self.backend.run_chain(state, ctxs), True
        except ChainNotFusable:
            out = []
            for st, ctx in zip(path, ctxs):
                if st.steps > 0:
                    state = self.backend.run_stage(state, ctx)
                out.append(state)
            return out, False

    def _run_chain_fused(self, path: List[Stage], worker: Worker,
                         state: Any, t: float,
                         produced: Dict[str, Tuple[Any, float,
                                                   Optional[str]]],
                         parent_cid: Optional[str] = None) -> None:
        """Execute the whole chain through ``backend.run_chain``: one fused
        call, device-resident carry across boundaries, write-behind
        checkpoints — with per-stage events, profiles and virtual durations
        identical in structure to the unfused loop."""
        _, save_s = self.backend.overheads()
        gpus = self._worker_gpus(worker)
        ctxs = [self._ctx_for(st) for st in path]
        self.plan.mark_running([Request(st.node_id, st.stop) for st in path])

        save0 = self.stats.ckpt_save_seconds
        wall0 = _time.perf_counter()
        cids: List[str] = []
        try:
            bstates, fused = self._stages_of(path, ctxs, state)
            # boundary checkpoints enter the pending cache here
            # (write-behind); the enqueue slice is measured and subtracted
            # from the wall below
            for st, ctx, s in zip(path, ctxs, bstates):
                cid = self._put_boundary(ctx.path_key, st.stop, s,
                                         parent_cid=parent_cid)
                self._d2d_put(cid, s, worker)
                cids.append(cid)
                parent_cid = cid
            metrics_l = [self.backend.evaluate(s, ctx) if st.report else None
                         for st, ctx, s in zip(path, ctxs, bstates)]
        except Exception as exc:
            # whole-chain failure domain: the attempt (and any boundary
            # that did commit — content addressing makes the re-put a
            # verified no-op, or it is taken back) retries from the
            # chain's fork point
            self._take_back(cids)
            waste = self._waste_of(path, _time.perf_counter() - wall0, gpus)
            self._fail_unit(worker, path, exc, t, waste,
                            release_worker=True)
            return
        wall = self._adjusted_wall(wall0, save0)

        sims = [self.backend.stage_seconds(c) for c in ctxs]
        total_steps = sum(st.steps for st in path)
        for st, s, cid, metrics, sim in zip(path, bstates, cids, metrics_l,
                                            sims):
            share = (wall * st.steps / total_steps if total_steps
                     else wall / len(path))
            exec_dur = sim if sim is not None else share
            if st.steps > 0:
                self.plan.record_profile(st.node_id, exec_dur / st.steps)
            dur = exec_dur
            if st.report:
                dur += getattr(self.backend, "eval_seconds", 0.0)
                self.stats.evals_run += 1
            dur += save_s  # checkpoint at every stage boundary
            t += dur
            self.stats.gpu_seconds += dur * gpus
            self.stats.stages_run += 1
            self.stats.steps_run += st.steps
            self._credit_stage(st, dur, gpus)
            if fused:
                self.stats.chain_fused_stages += 1
            produced[st.stage_id] = (s, t, cid)
            self.events.push(t, "stage", {
                "node_id": st.node_id, "stop": st.stop, "cid": cid,
                "metrics": metrics, "worker": worker.wid,
                "last": st is path[-1]})
        worker.busy_until = t
        self._worker_recovered(worker)
        self._unit_succeeded(path)

    # ------------------------------------------------------- group execution
    def _execute_group(self, group: List[List[Stage]], worker: Worker,
                       produced: Dict[str, Tuple[Any, float,
                                                 Optional[str]]],
                       taken: set) -> Tuple[bool, bool]:
        """Execute a sibling-chain group as batched backend calls on
        ``worker`` (one call per stage level; depth 1 is the classic
        sibling-stage group).

        Returns ``(ran, missed)``.  Members whose resume checkpoint
        vanished are refunded to the scheduler and left pending
        (recompute-on-miss), and a member whose resume load fails (a store
        outage) is failed alone; if fewer than two members survive, the
        whole group is refunded and its stages fall through to the chain
        pass this round.  A transient failure of the batched call degrades
        the group to solo runs of its members (:meth:`_run_group_degraded`);
        a crash or a fatal fault fails it whole."""
        t = max(self.events.time, worker.busy_until)
        load_s, save_s = self.backend.overheads()
        gpus = self._worker_gpus(worker)
        missed = False
        members: List[List[Stage]] = []
        states: List[Any] = []
        # per-member fork-point cid: the parent of each member's first
        # boundary checkpoint (siblings share it)
        parents: List[Optional[str]] = []
        loaded: Dict[str, Any] = {}   # resume cid -> state (dedup loads)
        for chain in group:
            head = chain[0]
            self.scheduler.on_path_assigned(self.plan, chain)
            if head.resume is not None:
                nid, step = head.resume
                cid = self.plan.node(nid).ckpts.get(step)
                if cid is not None and cid in loaded:
                    # copy-on-fanout: one load never hands the SAME tree
                    # object to two members
                    state = self.backend.clone_state(loaded[cid])
                else:
                    try:
                        got = self._load_resume(nid, step, worker)
                    except Exception as exc:
                        # store outage on one member's resume load: fail
                        # that member alone (refund + retry); the group
                        # continues with the survivors
                        self._fail_unit(worker, chain, exc, t, 0.0,
                                        release_worker=False)
                        continue
                    if got is None:
                        missed = True
                        self.scheduler.on_stages_unassigned(self.plan, chain)
                        continue
                    state, cid = got
                    loaded[cid] = state
            else:
                state = self.backend.init_state()
                cid = None
            members.append(chain)
            states.append(state)
            parents.append(cid)
        if len(members) < 2:
            # the group fell apart: refund the survivors; the chain pass
            # picks them up (they are not marked taken)
            for chain in members:
                self.scheduler.on_stages_unassigned(self.plan, chain)
            return False, missed

        n_loads = len(loaded)
        t += load_s * n_loads
        self.stats.gpu_seconds += load_s * n_loads * gpus
        self.stats.ckpt_loads += n_loads

        depth = len(members[0])
        ctx_chains = [[self._ctx_for(st) for st in chain]
                      for chain in members]
        for chain in members:
            for st in chain:
                taken.add(st.stage_id)
        self.plan.mark_running([Request(st.node_id, st.stop)
                                for chain in members for st in chain])
        self._bind(worker)

        save0 = self.stats.ckpt_save_seconds
        wall0 = _time.perf_counter()
        crash_rejoin: Optional[float] = None
        try:
            try:
                if depth == 1:
                    outs = [[s] for s in self.backend.run_stages_batched(
                        states, [ctxs[0] for ctxs in ctx_chains])]
                else:
                    outs = self.backend.run_chains_batched(states,
                                                           ctx_chains)
                batched = True
            except ValueError:
                # in-flight incompatibility (divergent restored batch
                # sizes, say): member-sequential execution — same
                # semantics, no batching credit
                outs = [self.backend.run_chain(s, ctxs)
                        for s, ctxs in zip(states, ctx_chains)]
                batched = False
        except Exception as exc:
            flat = [st for chain in members for st in chain]
            waste = self._waste_of(flat, _time.perf_counter() - wall0, gpus)
            t_fail = t + waste / gpus   # the attempt burns virtual time
            if isinstance(exc, WorkerCrashed) or not is_transient(exc):
                # the worker died under the whole group (or the fault is
                # fatal): fail the group wholesale as one retry unit
                self._fail_unit(worker, flat, exc, t_fail, waste,
                                release_worker=True)
                return True, missed
            # transient batched-call failure: degrade gracefully — the
            # batched attempt is waste; members re-run solo and fail (or
            # succeed) independently
            self.stats.groups_degraded += 1
            self.stats.stage_failures += 1
            self.stats.wasted_gpu_seconds += waste
            t = t_fail
            (members, states, parents, ctx_chains, outs,
             crash_rejoin) = self._run_group_degraded(
                members, states, parents, ctx_chains, worker, t)
            batched = False
            if not members:
                # no member survived solo either; every retry is scheduled
                # — release the worker (a crash delays it to probation)
                back_at = crash_rejoin if crash_rejoin is not None else t
                worker.busy_until = back_at
                self.events.push(back_at, "idle", worker.wid)
                return True, missed
            depth = len(members[0])
        # write-behind boundary checkpoints for every (member, stage); each
        # member threads its own parent down its chain, so every sibling
        # deltas against the shared fork point and then its own boundary.
        # A member whose put fails (store outage) is failed alone — its
        # computed state is waste, the survivors keep their results; the
        # member's earlier puts are taken back where the tiers differ.
        ok: List[int] = []
        cids: List[List[str]] = []
        metrics_l: List[List[Any]] = []
        for i, (chain, ctxs, out, pcid) in enumerate(
                zip(members, ctx_chains, outs, parents)):
            member_cids: List[str] = []
            try:
                for st, ctx, s in zip(chain, ctxs, out):
                    pcid = self._put_boundary(ctx.path_key, st.stop, s,
                                              parent_cid=pcid)
                    self._d2d_put(pcid, s, worker)
                    member_cids.append(pcid)
                member_metrics = [
                    self.backend.evaluate(s, ctx) if st.report else None
                    for st, ctx, s in zip(chain, ctxs, out)]
            except Exception as exc:
                self._take_back(member_cids)
                self._fail_unit(worker, chain, exc, t,
                                self._waste_of(chain, 0.0, gpus),
                                release_worker=False)
                continue
            ok.append(i)
            cids.append(member_cids)
            metrics_l.append(member_metrics)
        if len(ok) < len(members):
            members = [members[i] for i in ok]
            ctx_chains = [ctx_chains[i] for i in ok]
            outs = [outs[i] for i in ok]
            if not members:
                back_at = crash_rejoin if crash_rejoin is not None else t
                worker.busy_until = back_at
                self.events.push(back_at, "idle", worker.wid)
                return True, missed
        wall = self._adjusted_wall(wall0, save0)

        sims = [[self.backend.stage_seconds(c) for c in ctxs]
                for ctxs in ctx_chains]
        total_steps = sum(st.steps for st in members[0])
        fused_chain = depth > 1 and self.chain_fusion
        for j in range(depth):
            level = [chain[j] for chain in members]
            lvl_sims = [s[j] for s in sims]
            lvl_wall = (wall * level[0].steps / total_steps if total_steps
                        else wall / depth)
            dur = (lvl_wall if any(s is None for s in lvl_sims)
                   else sum(lvl_sims))
            for m, st in enumerate(level):
                member_dur = (lvl_sims[m] if lvl_sims[m] is not None
                              else lvl_wall / len(members))
                exec_dur = member_dur
                if st.report:
                    dur += getattr(self.backend, "eval_seconds", 0.0)
                    member_dur += getattr(self.backend, "eval_seconds", 0.0)
                    self.stats.evals_run += 1
                dur += save_s  # checkpoint per member at the boundary
                member_dur += save_s
                self.stats.stages_run += 1
                self.stats.steps_run += st.steps
                self._credit_stage(st, member_dur, gpus)
                if fused_chain:
                    self.stats.chain_fused_stages += 1
                if st.steps > 0:
                    self.plan.record_profile(st.node_id, exec_dur / st.steps)
            t += dur
            self.stats.gpu_seconds += dur * gpus
            for m, st in enumerate(level):
                produced[st.stage_id] = (outs[m][j], t, cids[m][j])
                self.events.push(t, "stage", {
                    "node_id": st.node_id, "stop": st.stop,
                    "cid": cids[m][j], "metrics": metrics_l[m][j],
                    "worker": worker.wid,
                    # a crash during degradation delays the idle event to
                    # probation (pushed below) instead of the last stage
                    "last": crash_rejoin is None and j == depth - 1
                            and m == len(members) - 1})
        if batched:
            self.stats.batched_groups += 1
            self.stats.batched_stages += len(members) * depth
        for chain in members:          # surviving members completed
            self._unit_succeeded(chain)
        if crash_rejoin is not None:
            worker.busy_until = max(t, crash_rejoin)
            self.events.push(worker.busy_until, "idle", worker.wid)
        else:
            worker.busy_until = t
            self._worker_recovered(worker)
        return True, missed

    def _run_group_degraded(self, members, states, parents, ctx_chains,
                            worker: Worker, t: float):
        """Graceful degradation of a failed batched group: re-run each
        member solo (``backend.run_chain`` over a cloned carry — the
        batched attempt may have aliased the originals).  Members that
        fail solo are failed independently (refund + retry); a member that
        crashes the worker fails, the not-yet-run members are failed as
        transient no-shows (no extra crash accrual — one incident, one
        crash), and the survivors computed before the crash keep their
        results.  Returns the surviving ``(members, states, parents,
        ctx_chains, outs, crash_rejoin)``; ``crash_rejoin`` is the
        worker's probation rejoin time when it crashed mid-degradation
        (None otherwise).

        A solo run is the looped tier's computation: bit-equal to the
        group on the looped tier, not in general on the vectorised one
        (a member-stacked product sums in another order)."""
        gpus = self._worker_gpus(worker)
        ok_m, ok_s, ok_p, ok_c, ok_o = [], [], [], [], []
        crash_rejoin: Optional[float] = None
        for chain, s, pcid, ctxs in zip(members, states, parents,
                                        ctx_chains):
            if crash_rejoin is not None:
                self._fail_unit(
                    worker, chain,
                    TransientStageError("worker crashed earlier in the "
                                        "degraded group"),
                    t, 0.0, release_worker=False)
                continue
            wall0 = _time.perf_counter()
            try:
                with tracing.unit(self._unit_key(chain)):
                    out, _ = self._stages_of(chain, ctxs,
                                             self.backend.clone_state(s))
            except Exception as exc:
                back = self._fail_unit(
                    worker, chain, exc, t,
                    self._waste_of(chain, _time.perf_counter() - wall0,
                                   gpus),
                    release_worker=False)
                if isinstance(exc, WorkerCrashed):
                    crash_rejoin = back
                continue
            ok_m.append(chain)
            ok_s.append(s)
            ok_p.append(pcid)
            ok_c.append(ctxs)
            ok_o.append(out)
        return ok_m, ok_s, ok_p, ok_c, ok_o, crash_rejoin


def _no_leaf(x: Any) -> None:
    """The structure of a tree: every leaf mapped to ``None``."""
    return None


def _same_bits(a: Any, b: Any) -> bool:
    """Do two checkpoint leaves hold the same bits?  Tensors compare dtype,
    shape and a byte view on one device (``torch.equal`` on floats would
    take ``-0.0`` for ``0.0`` and a NaN for unequal to itself); other
    leaves compare their numpy dtype, shape and bytes, as the JAX package
    compares every leaf."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        if not (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)):
            return False
        if a.dtype != b.dtype or a.shape != b.shape:
            return False
        a = a.detach().contiguous().reshape(-1)
        b = b.detach().to(a.device).contiguous().reshape(-1)
        if a.dtype == torch.bool:
            return torch.equal(a, b)
        return torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())
