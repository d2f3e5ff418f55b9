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
is subtracted from measured stage walls exactly like ``compile_seconds`` —
profiles and the virtual clock stay execution-only.

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

Not in this package yet (the engine facade refuses the options that would
need them): mesh workers with device-to-device handoff, and the failure
domains of the fault plane.  Any other exception raised by the backend or
the store therefore propagates out of the round unchanged.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.scheduler import SchedulingPolicy
from repro_torch.core.searchplan import Request, SearchPlan
from repro_torch.core.stagetree import (Stage, StageTreeBuilder,
                                        sibling_chain_groups, sibling_groups)
from repro_torch.core.engine.events import EventLoop
from repro_torch.core.trainer import (ChainNotFusable, StageContext,
                                      TrainerBackend)
from repro_torch.train.checkpoint import CheckpointStore

__all__ = ["Worker", "Dispatcher"]


@dataclass
class Worker:
    """One thread worker: a single device slot on the local host."""

    wid: int
    busy_until: float = 0.0
    idle: bool = True


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
        # store counters at attach time: EngineStats mirrors *deltas* over
        # this baseline, so an engine attached to a store that already
        # served another session accumulates only its own growth
        self._store_base = self._seed_store_base()

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

    def _sync_kernel_stats(self) -> None:
        """Mirror the backend's kernel-plane counters (call / fallback
        counts, cumulative per backend) into ``EngineStats``."""
        calls = getattr(self.backend, "kernel_calls", None)
        if calls is not None:
            self.stats.kernel_calls = calls
            self.stats.kernel_fallbacks = self.backend.kernel_fallbacks

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

    def _assign_round(self) -> bool:
        """One scheduling round; True when a checkpoint miss warrants a
        retry (idle workers remain and requests were re-derived)."""
        idle = [w for w in self.workers if w.idle]
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
            # thread workers are interchangeable: first idle one
            worker = pool.pop(0)
            status = self._execute_chain(path, worker, produced)
            if status == "miss":
                missed = True
            elif status == "deferred":
                pool.append(worker)
            if not pending:
                refill()
        return missed and any(w.idle for w in self.workers)

    def _group_pass(self, tree, idle: List[Worker],
                    produced: Dict[str, Tuple[Any, float, Optional[str]]],
                    taken: set) -> Tuple[List[Worker], bool]:
        """Execute the round's sibling groups, each on the first idle
        worker; returns the workers still idle and whether a resume
        checkpoint was missed."""
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
            worker = idle[0]
            ran, miss = self._execute_group(group, worker, produced, taken)
            missed |= miss
            if ran:
                idle.remove(worker)
        return idle, missed

    def _truncate(self, path: List[Stage]) -> List[Stage]:
        out, steps = [], 0
        for st in path:
            out.append(st)
            steps += st.steps
            if steps >= self.max_steps_per_chain:
                break
        return out

    # ---------------------------------------------------------- resume input
    def _load_resume(self, nid: str, step: int
                     ) -> Optional[Tuple[Any, str]]:
        """(state, cid) of checkpoint (node, step), or None after degrading
        a vanished checkpoint to recompute: count the miss and make the
        plan forget the stale entry so the next round re-derives the
        request.  A checkpoint the plan no longer lists (already forgotten
        earlier this round) is not a fresh miss — one eviction counts once.
        The cid rides along as the fork-point parent of the chain's first
        boundary checkpoint."""
        cid = self.plan.node(nid).ckpts.get(step)
        if cid is None:
            return None
        t0 = _time.perf_counter()
        try:
            return self.store.get(cid), cid
        except KeyError:
            pass
        finally:
            self.stats.ckpt_load_seconds += _time.perf_counter() - t0
        self.stats.ckpt_misses += 1
        self.plan.forget_ckpt(nid, step)
        return None

    def _put_boundary(self, path_key: str, stop: int, state: Any,
                      parent_cid: Optional[str] = None) -> str:
        """Deposit one stage-boundary checkpoint — write-behind under chain
        fusion (enqueue only; the commit overlaps the next stage's
        compute), synchronous otherwise.  The synchronous slice is timed
        into ``ckpt_save_seconds`` either way."""
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

    def _adjusted_wall(self, wall0: float, comp0: float,
                       save0: float) -> float:
        """Measured wall minus the backend's compile-time delta and the
        synchronous slice of in-window checkpoint saves: one-time
        compilation amortizes across the study and write-behind saves
        overlap the next stage, so neither may pollute seconds/step
        profiles or the virtual clock."""
        wall = _time.perf_counter() - wall0
        comp = getattr(self.backend, "compile_seconds", 0.0) - comp0
        save = self.stats.ckpt_save_seconds - save0
        return max(0.0, wall - comp - save)

    def _compile_adjusted_wall(self, wall0: float, comp0: float) -> float:
        return self._adjusted_wall(wall0, comp0, self.stats.ckpt_save_seconds)

    # ------------------------------------------------------- chain execution
    def _execute_chain(self, path: List[Stage], worker: Worker,
                       produced: Dict[str, Tuple[Any, float,
                                                 Optional[str]]]) -> str:
        """Execute one chain on ``worker``.  Returns ``"ran"``, ``"miss"``
        (checkpoint vanished — the caller retries the round) or
        ``"deferred"`` (in-round input truncated away — the caller returns
        the worker to the round's pool)."""
        head = path[0]
        t = max(self.events.time, worker.busy_until)
        load_s, save_s = self.backend.overheads()
        gpus = self.gpus_per_worker

        # ------- input state (parent_cid = the fork-point checkpoint of
        # the chain's first boundary)
        if head.resume is not None:
            nid, step = head.resume
            loaded = self._load_resume(nid, step)
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

        worker.idle = False
        if self.chain_fusion:
            self._run_chain_fused(path, worker, state, t, produced,
                                  parent_cid)
            return "ran"

        for st in path:
            ctx = self._ctx_for(st)
            self.plan.mark_running([Request(st.node_id, st.stop)])

            comp0 = getattr(self.backend, "compile_seconds", 0.0)
            wall0 = _time.perf_counter()
            if st.steps > 0:
                state = self.backend.run_stage(state, ctx)
            metrics = (self.backend.evaluate(state, ctx) if st.report
                       else None)
            wall = self._compile_adjusted_wall(wall0, comp0)
            sim = self.backend.stage_seconds(ctx)
            cid = self._put_boundary(ctx.path_key, st.stop, state,
                                     parent_cid=parent_cid)

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
            produced[st.stage_id] = (state, t, cid)
            self.events.push(t, "stage", {
                "node_id": st.node_id, "stop": st.stop, "cid": cid,
                "metrics": metrics, "worker": worker.wid,
                "last": st is path[-1]})
        worker.busy_until = t
        return "ran"

    # ------------------------------------------------- fused chain execution
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
        gpus = self.gpus_per_worker
        ctxs = [self._ctx_for(st) for st in path]
        self.plan.mark_running([Request(st.node_id, st.stop) for st in path])

        comp0 = getattr(self.backend, "compile_seconds", 0.0)
        save0 = self.stats.ckpt_save_seconds
        wall0 = _time.perf_counter()
        try:
            bstates = self.backend.run_chain(state, ctxs)
            fused = True
        except ChainNotFusable:
            # the backend refused the chain as a whole (its stages do not
            # fuse): per-stage loop, same semantics, no fusion credit
            fused = False
            bstates = []
            for st, ctx in zip(path, ctxs):
                if st.steps > 0:
                    state = self.backend.run_stage(state, ctx)
                bstates.append(state)
        # boundary checkpoints enter the pending cache here (write-behind);
        # the enqueue slice is measured and subtracted from the wall below
        cids = []
        for st, ctx, s in zip(path, ctxs, bstates):
            cid = self._put_boundary(ctx.path_key, st.stop, s,
                                     parent_cid=parent_cid)
            cids.append(cid)
            parent_cid = cid
        metrics_l = [self.backend.evaluate(s, ctx) if st.report else None
                     for st, ctx, s in zip(path, ctxs, bstates)]
        wall = self._adjusted_wall(wall0, comp0, save0)

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
        (recompute-on-miss); if fewer than two members survive, the whole
        group is refunded and its stages fall through to the chain pass
        this round."""
        t = max(self.events.time, worker.busy_until)
        load_s, save_s = self.backend.overheads()
        gpus = self.gpus_per_worker
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
                    got = self._load_resume(nid, step)
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
        worker.idle = False

        comp0 = getattr(self.backend, "compile_seconds", 0.0)
        save0 = self.stats.ckpt_save_seconds
        wall0 = _time.perf_counter()
        try:
            if depth == 1:
                outs = [[s] for s in self.backend.run_stages_batched(
                    states, [ctxs[0] for ctxs in ctx_chains])]
            else:
                outs = self.backend.run_chains_batched(states, ctx_chains)
            batched = True
        except ValueError:
            # in-flight incompatibility (divergent restored batch sizes,
            # say): member-sequential execution — same semantics, no
            # batching credit
            outs = [self.backend.run_chain(s, ctxs)
                    for s, ctxs in zip(states, ctx_chains)]
            batched = False
        # write-behind boundary checkpoints for every (member, stage); each
        # member threads its own parent down its chain, so every sibling
        # deltas against the shared fork point and then its own boundary
        cids: List[List[str]] = []
        for chain, ctxs, out, pcid in zip(members, ctx_chains, outs,
                                          parents):
            member_cids = []
            for st, ctx, s in zip(chain, ctxs, out):
                pcid = self._put_boundary(ctx.path_key, st.stop, s,
                                          parent_cid=pcid)
                member_cids.append(pcid)
            cids.append(member_cids)
        metrics_l = [[self.backend.evaluate(s, ctx) if st.report else None
                      for st, ctx, s in zip(chain, ctxs, out)]
                     for chain, ctxs, out in zip(members, ctx_chains, outs)]
        wall = self._adjusted_wall(wall0, comp0, save0)

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
                    "last": j == depth - 1 and m == len(members) - 1})
        if batched:
            self.stats.batched_groups += 1
            self.stats.batched_stages += len(members) * depth
        worker.busy_until = t
        return True, missed
