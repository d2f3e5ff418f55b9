"""Aggregator — result recording, waiter wakeup, and checkpoint GC.

The aggregator consumes ``stage`` events: it records checkpoints/metrics
into the search plan (the single source of truth), wakes every tuner
waiting on the satisfied (node, step) request, and frees the worker.

It also owns the beyond-paper checkpoint GC: when a kill releases the last
trial referencing a plan node (``refcount`` hits 0 — counted across *all*
studies sharing the plan, so a node another study still uses is never
touched), the node's checkpoints are evicted from the store and forgotten
by the plan, so Algorithm 1 stops resolving resumes to them.  Results that
arrive for already-dead nodes (a kill raced a running stage) are evicted on
arrival for the same reason.

Chain fusion changes none of this: a fused chain still posts one ``stage``
event per boundary, so a kill that lands mid-chain sees the completed
prefix recorded stage by stage and the dead suffix evicted on arrival.
Under the write-behind checkpoint plane those suffix evictions may hit
checkpoints whose host commit is still in flight — ``store.evict`` cancels
the pending write (the bytes are never materialized), which is exactly the
GC-correct outcome.
"""

from __future__ import annotations

from typing import Any, Dict, List, Set, Tuple

from repro_torch.core.searchplan import SearchPlan
from repro_torch.core.engine.events import EventLoop
from repro_torch.train.checkpoint import CheckpointStore

__all__ = ["Aggregator"]


class Aggregator:
    def __init__(self, plan: SearchPlan, store: CheckpointStore,
                 stats, events: EventLoop):
        self.plan = plan
        self.store = store
        self.stats = stats
        self.events = events
        # (node_id, step) -> list of (handle, trial) waiting on the result
        self.waiters: Dict[Tuple[str, int], List[Tuple[Any, Any]]] = {}
        self.killed: Set[str] = set()

    # -------------------------------------------------------------- waiters
    def add_waiter(self, node_id: str, step: int, handle, trial) -> None:
        self.waiters.setdefault((node_id, step), []).append((handle, trial))

    # ----------------------------------------------------------- aggregation
    def on_stage_done(self, p: Dict[str, Any]) -> None:
        self.plan.record_result(p["node_id"], p["stop"], p["cid"], p["metrics"])
        if p["metrics"] is not None:
            key = (p["node_id"], p["stop"])
            for handle, trial in self.waiters.pop(key, []):
                if trial.trial_id not in self.killed:
                    handle.tuner.on_result(trial, p["stop"], p["metrics"])
        if self.plan.nodes[p["node_id"]].refcount <= 0:
            # result for a node killed while running — nothing will resume
            # from it, reclaim the checkpoint immediately
            self._evict_node(p["node_id"])
        if p["last"]:
            self.events.push(self.events.time, "idle", p["worker"])

    def detach_study(self, study_id: str) -> None:
        """Cancel path: drop every waiter belonging to ``study_id`` and
        withdraw the pending requests no other study's waiter still wants
        (running and satisfied steps are left alone — in-flight work
        completes and records normally).  Trials the study shares with
        live studies survive; the engine kills the rest separately."""
        for key in list(self.waiters):
            ws = self.waiters[key]
            ws[:] = [(h, t) for (h, t) in ws if h.study_id != study_id]
            if not ws:
                del self.waiters[key]
                nid, step = key
                node = self.plan.nodes[nid]
                if (step in node.requests and step not in node.running
                        and step not in node.metrics):
                    self.plan.drop_request(nid, step)

    # ------------------------------------------------------------------ kill
    def kill(self, trial_id: str) -> None:
        """Release a trial: drop its refs, cancel requests nobody else
        wants, and evict checkpoints of nodes left unreferenced."""
        if trial_id in self.killed:
            return
        self.killed.add(trial_id)
        path = list(self.plan.trial_paths.get(trial_id, []))
        dead = self.plan.release_trial(trial_id)
        self._drop_waiters(path, lambda h, t: t.trial_id == trial_id)
        for nid in dead:
            self._evict_node(nid)

    def release(self, study_id: str, trial_id: str) -> None:
        """One study lets go of a trial another live study still holds:
        drop that study's waiters on the trial and the pending requests
        nobody else wants; the trial and its nodes live on."""
        self._drop_waiters(
            list(self.plan.trial_paths.get(trial_id, [])),
            lambda h, t: t.trial_id == trial_id and h.study_id == study_id)

    def _drop_waiters(self, path, drop) -> None:
        """Remove the waiters ``drop(handle, trial)`` selects from the
        requests along ``path``, and withdraw each request left with no
        waiter that is neither running nor satisfied."""
        for nid in path:
            node = self.plan.nodes[nid]
            for s in sorted(node.requests):
                key = (nid, s)
                ws = self.waiters.get(key)
                if ws:
                    ws[:] = [(h, t) for (h, t) in ws if not drop(h, t)]
                if not ws and s not in node.running and s not in node.metrics:
                    self.plan.drop_request(nid, s)
                    self.waiters.pop(key, None)

    # -------------------------------------------------------------- ckpt GC
    def _evict_node(self, nid: str) -> None:
        for cid in self.plan.evict_ckpts(nid):
            if self.store.evict(cid):
                self.stats.ckpt_evictions += 1
