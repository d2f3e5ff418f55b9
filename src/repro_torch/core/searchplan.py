"""Search plan — Hippo's persistent study representation (§3.2, Figure 6).

The search plan is a tree of *plan nodes*.  Each node represents "a
hyper-parameter configuration starting from a certain training step": the
node's ``desc`` is the offset-normalized functional-piece descriptor (one
piece per hyper-parameter) and ``start`` is the global step at which the
configuration takes over (= the integer annotation on the edge from its
parent).  Node identity is therefore ``(parent, start, desc)`` — two trials
whose hyper-parameter values coincide on ``[0, s)`` traverse exactly the
same nodes up to step ``s``, which is what makes prefix sharing automatic.

Nodes are **never removed** when new trials arrive (§3.2): a trial that
needs a shorter stage than previously materialized simply adds another
integer to an existing node's ``requests`` field.  Stage trees are
generated transiently from the plan (see :mod:`repro_torch.core.stagetree`).

Per-node fields mirror Figure 6:

* ``desc``      — canonical hp-piece descriptors (hp_config of the node),
* ``ckpts``     — {global step: checkpoint key} trained under this path,
* ``metrics``   — {global step: metrics dict},
* ``requests``  — set of global steps requested (train + report metrics),
* ``running``   — subset of requests currently executing on a worker,
* ``refcount`` / ``trials`` — bookkeeping for GC and multi-study sharing,
* ``profile``   — measured seconds/step under this configuration (used by
  the critical-path scheduler).

Incremental control plane (beyond-paper, semantics-preserving): the plan
keeps a monotonic ``revision`` counter plus a **per-node revision map** —
for each node, the revision of its last stage-tree-relevant mutation
(checkpoints, metrics, running marks), kept in recency order so
``changes_since(rev)`` walks only the nodes touched after ``rev``.  Unlike
the earlier append-only change log this is bounded: at most one entry per
node ever touched, however long the plan lives.  The plan also maintains a
**pending-request index** so ``pending_requests()`` is O(pending) instead
of a full node scan.  Consumers like
:class:`~repro_torch.core.stagetree.StageTreeBuilder` keep their own frontier
revision and pass it to ``changes_since`` to memoize Algorithm-1
resolutions across scheduling rounds.  All mutations must therefore go
through the plan's methods (``submit`` / ``record_result`` /
``mark_running`` / ``clear_running`` / ``drop_request`` /
``release_trial`` / ``evict_ckpts`` / ``forget_ckpt``) — never poke node
fields directly.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, NamedTuple, Optional, Set, Tuple

from repro_torch.core.trial import Trial
from repro_torch.utils import stable_hash

__all__ = ["PlanNode", "SearchPlan", "Request"]

ROOT = "ROOT"  # virtual root id; real roots are children of this sentinel.


@dataclass
class PlanNode:
    node_id: str
    parent: Optional[str]           # parent node id (ROOT children have parent=None)
    start: int                      # global step where this config takes over
    desc: Dict[str, Any]            # canonical piece descriptor
    ckpts: Dict[int, str] = field(default_factory=dict)
    metrics: Dict[int, Dict[str, float]] = field(default_factory=dict)
    requests: Set[int] = field(default_factory=set)
    running: Set[int] = field(default_factory=set)
    refcount: int = 0
    trials: Set[str] = field(default_factory=set)
    profile: Optional[float] = None  # seconds / step (None = unprofiled)
    meta: Dict[str, Any] = field(default_factory=dict)

    def desc_hash(self) -> str:
        return stable_hash(self.desc)

    def latest_ckpt_at_or_before(self, step: int) -> Optional[int]:
        """Largest checkpointed step s with node.start <= s <= step."""
        cands = [s for s in self.ckpts if self.start <= s <= step]
        return max(cands) if cands else None

    def to_json(self) -> Dict[str, Any]:
        return {
            "node_id": self.node_id, "parent": self.parent, "start": self.start,
            "desc": self.desc,
            "ckpts": {str(k): v for k, v in self.ckpts.items()},
            "metrics": {str(k): v for k, v in self.metrics.items()},
            "requests": sorted(self.requests),
            "refcount": self.refcount,
            "trials": sorted(self.trials),
            "profile": self.profile,
            "meta": self.meta,
        }

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "PlanNode":
        return cls(
            node_id=d["node_id"], parent=d["parent"], start=d["start"],
            desc=d["desc"],
            ckpts={int(k): v for k, v in d["ckpts"].items()},
            metrics={int(k): v for k, v in d["metrics"].items()},
            requests=set(d["requests"]),
            refcount=d.get("refcount", 0),
            trials=set(d.get("trials", [])),
            profile=d.get("profile"),
            meta=d.get("meta") or {},
        )


class Request(NamedTuple):
    """A pending unit of work: train the path of ``node`` up to ``step``.

    A NamedTuple (not a dataclass): requests are hashed millions of times as
    memo keys in the incremental StageTreeBuilder, and tuple hashing is
    several times faster than dataclass field hashing.
    """

    node_id: str
    step: int


class SearchPlan:
    """The search-plan database entry for one (model, dataset, hp-set) key.

    Multiple studies over the same key share one SearchPlan — that is the
    entire multi-study merging mechanism (§2.2 "sharing computations across
    studies"): their trials land in the same node tree.
    """

    def __init__(self, key: str = "default"):
        self.key = key
        self.nodes: Dict[str, PlanNode] = {}
        self.children: Dict[Optional[str], List[str]] = {None: []}
        # (parent, start, desc_hash) -> node_id
        self._index: Dict[Tuple[Optional[str], int, str], str] = {}
        self._counter = 0
        # trial_id -> (leaf node id, total steps)  for each submitted request
        self.trial_paths: Dict[str, List[str]] = {}
        self.default_profile: float = 1.0  # seconds/step fallback
        # trial_id -> study ids that submitted it (fair-share scheduling)
        self.trial_studies: Dict[str, Set[str]] = {}
        # ---- incremental control plane ----
        self.revision = 0                       # bumps on every mutation
        # node id -> revision of its last resolution-relevant change, kept in
        # recency order (most recent last); bounded at one entry per node
        self._node_rev: "OrderedDict[str, int]" = OrderedDict()
        self._pending: Dict[str, Set[int]] = {}  # node_id -> pending steps
        self._order: Dict[str, int] = {}        # node_id -> creation seq
        self._depth: Dict[str, int] = {}        # node_id -> path length
        self._path_keys: Dict[str, str] = {}    # node_id -> cached path_key
        self._static_hashes: Dict[str, str] = {}  # node_id -> static-hp hash

    # -------------------------------------------------------- change tracking
    def _touch(self, node_id: Optional[str] = None) -> None:
        """Bump ``revision``; record ``node_id`` when the mutation can change
        Algorithm-1 resolutions (checkpoints / running marks / metrics)."""
        self.revision += 1
        if node_id is not None:
            self._node_rev[node_id] = self.revision
            self._node_rev.move_to_end(node_id)

    def changes_since(self, rev: int) -> Tuple[int, Set[str]]:
        """(current revision, node ids with resolution-relevant mutations
        after revision ``rev``) — O(changed) via the recency-ordered map;
        callers (StageTreeBuilder) keep ``rev`` as their frontier."""
        dirty: Set[str] = set()
        for nid, r in reversed(self._node_rev.items()):
            if r <= rev:
                break
            dirty.add(nid)
        return self.revision, dirty

    def _refresh_pending(self, node: PlanNode, step: int) -> None:
        """Re-derive the pending-index membership of one (node, step)."""
        if (step in node.requests and step not in node.metrics
                and step not in node.running):
            self._pending.setdefault(node.node_id, set()).add(step)
        else:
            steps = self._pending.get(node.node_id)
            if steps is not None:
                steps.discard(step)
                if not steps:
                    del self._pending[node.node_id]

    # ------------------------------------------------------------- structure
    def _new_node(self, parent: Optional[str], start: int, desc: Dict[str, Any]) -> PlanNode:
        nid = f"H{self._counter}"
        self._counter += 1
        node = PlanNode(nid, parent, start, desc)
        self.nodes[nid] = node
        self.children.setdefault(parent, []).append(nid)
        self.children.setdefault(nid, [])
        self._index[(parent, start, stable_hash(desc))] = nid
        self._order[nid] = len(self._order)
        self._depth[nid] = 1 if parent is None else self.depth_of(parent) + 1
        return node

    def get_or_create(self, parent: Optional[str], start: int, desc: Dict[str, Any]) -> PlanNode:
        key = (parent, start, stable_hash(desc))
        nid = self._index.get(key)
        if nid is not None:
            return self.nodes[nid]
        return self._new_node(parent, start, desc)

    def node(self, node_id: str) -> PlanNode:
        return self.nodes[node_id]

    def parent_of(self, node: PlanNode) -> Optional[PlanNode]:
        return self.nodes[node.parent] if node.parent is not None else None

    def path_to_root(self, node_id: str) -> List[PlanNode]:
        """Nodes from root to ``node_id`` inclusive."""
        out = []
        cur: Optional[str] = node_id
        while cur is not None:
            n = self.nodes[cur]
            out.append(n)
            cur = n.parent
        return list(reversed(out))

    def path_key(self, node_id: str) -> str:
        """Content hash identifying the value trajectory of a node's path.

        Checkpoints are addressed by (path_key, step): any two trials whose
        hp values coincide up to ``step`` share the path and therefore the
        checkpoint — across studies too.  A node's path is immutable, so the
        key is computed once (O(depth)) and cached forever.
        """
        key = self._path_keys.get(node_id)
        if key is None:
            path = [(n.start, n.desc) for n in self.path_to_root(node_id)]
            key = stable_hash({"plan_key": self.key, "path": path})
            self._path_keys[node_id] = key
        return key

    def static_hash(self, node_id: str) -> str:
        """Content hash of a node's static hps.  Descriptors are immutable,
        so the hash is computed once and cached — the sibling-grouping pass
        reads it every scheduling round."""
        h = self._static_hashes.get(node_id)
        if h is None:
            h = stable_hash(self.nodes[node_id].desc.get("static") or {})
            self._static_hashes[node_id] = h
        return h

    def depth_of(self, node_id: str) -> int:
        """Path length root→node (cached; equals len(path_to_root))."""
        d = self._depth.get(node_id)
        if d is None:
            n = self.nodes[node_id]
            d = 1 if n.parent is None else self.depth_of(n.parent) + 1
            self._depth[node_id] = d
        return d

    # ------------------------------------------------------------ insertion
    def submit(self, trial: Trial, upto: Optional[int] = None,
               study: Optional[str] = None) -> Tuple[PlanNode, int, bool]:
        """Insert (or match) a trial's prefix up to ``upto`` steps and record
        a request.  Returns (leaf node, step, satisfied) where satisfied is
        True iff metrics for that exact step are already present (§3.2 "in
        case metrics and checkpoints ... already present, a response is
        returned immediately")."""
        step = trial.total_steps if upto is None else min(upto, trial.total_steps)
        segs = trial.segments(step)
        parent: Optional[str] = None
        node: Optional[PlanNode] = None
        for seg in segs:
            node = self.get_or_create(parent, seg.start, seg.desc)
            if trial.trial_id not in node.trials:
                node.trials.add(trial.trial_id)
                node.refcount += 1
            parent = node.node_id
        assert node is not None, "trial with zero steps"
        self.trial_paths.setdefault(trial.trial_id, [])
        path_ids = [n.node_id for n in self.path_to_root(node.node_id)]
        self.trial_paths[trial.trial_id] = path_ids
        if study is not None:
            self.trial_studies.setdefault(trial.trial_id, set()).add(study)
        self._touch()  # new nodes / requests invalidate cached stage trees
        if step in node.metrics:
            return node, step, True
        node.requests.add(step)
        self._refresh_pending(node, step)
        return node, step, False

    # ------------------------------------------------------------- requests
    def pending_requests(self) -> List[Request]:
        """Requests with no metrics yet and not currently running.

        Served from the maintained index — O(pending), not O(plan) — in the
        same (node creation, step) order the full scan produces.
        """
        out = []
        for nid in sorted(self._pending, key=self._order.__getitem__):
            for s in sorted(self._pending[nid]):
                out.append(Request(nid, s))
        return out

    def pending_requests_scan(self) -> List[Request]:
        """Reference full scan of every node (the pre-index implementation).
        Kept for equivalence tests and control-plane benchmarks."""
        out = []
        for n in self.nodes.values():
            for s in sorted(n.requests):
                if s in n.metrics or s in n.running:
                    continue
                out.append(Request(n.node_id, s))
        return out

    def mark_running(self, reqs: Iterable[Request]) -> None:
        for r in reqs:
            n = self.nodes[r.node_id]
            n.running.add(r.step)
            self._refresh_pending(n, r.step)
            self._touch(r.node_id)

    def clear_running(self, reqs: Iterable[Request]) -> None:
        for r in reqs:
            n = self.nodes[r.node_id]
            n.running.discard(r.step)
            self._refresh_pending(n, r.step)
            self._touch(r.node_id)

    def drop_request(self, node_id: str, step: int) -> None:
        """Withdraw a pending request (kill path) — index-safe removal."""
        n = self.nodes[node_id]
        n.requests.discard(step)
        self._refresh_pending(n, step)
        self._touch()

    def is_satisfied(self, node_id: str, step: int) -> bool:
        return step in self.nodes[node_id].metrics

    # ------------------------------------------------------------ aggregation
    def record_result(self, node_id: str, step: int, ckpt: Optional[str],
                      metrics: Optional[Dict[str, float]]) -> None:
        n = self.nodes[node_id]
        if ckpt is not None:
            n.ckpts[step] = ckpt
        if metrics is not None:
            n.metrics[step] = dict(metrics)
        n.running.discard(step)
        self._refresh_pending(n, step)
        self._touch(node_id)

    def record_profile(self, node_id: str, seconds_per_step: float) -> None:
        n = self.nodes[node_id]
        if n.profile is None:
            n.profile = seconds_per_step
        else:  # exponential moving average keeps the estimate current
            n.profile = 0.7 * n.profile + 0.3 * seconds_per_step

    def profile_of(self, node_id: str) -> float:
        p = self.nodes[node_id].profile
        return self.default_profile if p is None else p

    # -------------------------------------------------------------- ckpt GC
    def release_trial(self, trial_id: str) -> List[str]:
        """Drop a trial's references; return node ids whose refcount hit 0
        (their checkpoints are GC candidates — beyond-paper eviction)."""
        dead = []
        for nid in self.trial_paths.pop(trial_id, []):
            n = self.nodes[nid]
            if trial_id in n.trials:
                n.trials.discard(trial_id)
                n.refcount -= 1
                if n.refcount <= 0:
                    dead.append(nid)
        self.trial_studies.pop(trial_id, None)
        return dead

    def evict_ckpts(self, node_id: str) -> List[str]:
        """Forget a node's checkpoints (store eviction upstream); returns the
        checkpoint ids so the caller can drop them from the store.  Logged as
        a resolution-relevant change: Algorithm 1 must stop resuming here."""
        n = self.nodes[node_id]
        cids = list(n.ckpts.values())
        if cids:
            n.ckpts.clear()
            self._touch(node_id)
        return cids

    def forget_ckpt(self, node_id: str, step: int) -> Optional[str]:
        """Drop a single checkpoint entry whose blob vanished from the store
        (external eviction, discovered by the dispatcher at load time):
        Algorithm 1 must stop resuming there so the request re-derives from
        whatever remains — an earlier checkpoint, an ancestor, or a fresh
        model.  Returns the forgotten checkpoint id (None if absent)."""
        n = self.nodes[node_id]
        cid = n.ckpts.pop(step, None)
        if cid is not None:
            self._touch(node_id)
        return cid

    def detach_study(self, trial_id: str, study: str) -> None:
        """Remove one study's attribution from a trial (service-plane
        cancel).  The trial itself survives if other studies submitted it;
        fair-share and per-study accounting stop crediting the detached
        study from here on."""
        studies = self.trial_studies.get(trial_id)
        if studies is not None:
            studies.discard(study)
            if not studies:
                del self.trial_studies[trial_id]

    def studies_of_trial(self, trial_id: str) -> Set[str]:
        return self.trial_studies.get(trial_id, set())

    # ------------------------------------------------------------- metrics
    def metrics_for(self, node_id: str, step: int) -> Optional[Dict[str, float]]:
        return self.nodes[node_id].metrics.get(step)

    # ---------------------------------------------------------------- stats
    def total_requested_steps(self) -> int:
        """Sum over trials of their max requested step (trial-based cost)."""
        total = 0
        for tid, path in self.trial_paths.items():
            leaf = self.nodes[path[-1]]
            reqs = [s for s in leaf.requests | set(leaf.metrics)]
            total += max(reqs) if reqs else 0
        return total

    def to_json(self) -> Dict[str, Any]:
        return {
            "key": self.key,
            "counter": self._counter,
            "nodes": {nid: n.to_json() for nid, n in self.nodes.items()},
            "trial_paths": self.trial_paths,
            "default_profile": self.default_profile,
            "trial_studies": {t: sorted(s) for t, s in self.trial_studies.items()},
        }

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "SearchPlan":
        plan = cls(d["key"])
        plan._counter = d["counter"]
        plan.default_profile = d.get("default_profile", 1.0)
        for nid, nd in d["nodes"].items():
            node = PlanNode.from_json(nd)
            plan.nodes[nid] = node
            plan.children.setdefault(node.parent, []).append(nid)
            plan.children.setdefault(nid, [])
            plan._index[(node.parent, node.start, stable_hash(node.desc))] = nid
            plan._order[nid] = len(plan._order)
            for s in node.requests:
                plan._refresh_pending(node, s)
        plan.trial_paths = {k: list(v) for k, v in d["trial_paths"].items()}
        plan.trial_studies = {t: set(s)
                              for t, s in d.get("trial_studies", {}).items()}
        plan._touch()
        return plan
