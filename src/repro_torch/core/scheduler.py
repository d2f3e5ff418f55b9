"""Pluggable stateless scheduling policies (Hippo §4.3, beyond-paper).

Every policy receives a transient stage tree, estimates each stage's
execution time as ``steps × profiled seconds-per-step`` (profile stored in
the search plan, §4.3), and extracts whole root-to-leaf *chains* ("batch of
stages") for idle workers — scheduling whole paths instead of single stages
avoids checkpoint save/load transitions.

The policies keep **no execution state about stages**: callers re-generate
a fresh stage tree from the search plan every scheduling round, and stages
already covered by running work simply never appear in the new tree (they
are deferred by Algorithm 1's running check).  ``FairShareScheduler`` does
carry *accounting* state (GPU-seconds charged per study) — that is policy
memory, not execution state, and the paper's stateless-stage-tree property
is untouched.

Policies:

* :class:`CriticalPathScheduler` — the paper's policy: repeatedly extract
  the root-to-leaf path with the longest remaining estimated time.
* :class:`WeightedFanoutScheduler` — beyond-paper: weight each path by the
  number of pending report-leaves it unblocks divided by its length; shared
  prefixes with high fan-out get scheduled first, improving end-to-end time
  at equal GPU-hours (see EXPERIMENTS.md §Perf).
* :class:`FIFOScheduler` — chains in stage-creation (= request arrival)
  order; the Ray-Tune-like baseline, useful to quantify what critical-path
  ordering buys.
* :class:`FairShareScheduler` — multi-study scenario (§6.2): prefer chains
  serving the study with the least GPU-time charged so far, so one study
  with many long trials cannot starve a small concurrent study.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Set

from repro_torch.core.searchplan import SearchPlan
from repro_torch.core.stagetree import Stage, StageTree

__all__ = ["SchedulingPolicy", "CriticalPathScheduler",
           "WeightedFanoutScheduler", "FIFOScheduler", "FairShareScheduler",
           "POLICIES", "make_policy"]


class SchedulingPolicy:
    """Interface the execution engine drives each scheduling round."""

    name = "base"

    def next_path(self, plan: SearchPlan, tree: StageTree,
                  taken: set) -> Optional[List[Stage]]:
        """The next chain of unscheduled stages, or None when exhausted.

        A chain starts at a stage whose parent is either absent or already
        taken and extends downward through children; implementations must
        add every returned stage id to ``taken``.
        """
        raise NotImplementedError

    def on_path_assigned(self, plan: SearchPlan, path: List[Stage]) -> None:
        """Hook invoked once per extracted chain (accounting policies)."""

    def on_stages_unassigned(self, plan: SearchPlan,
                             stages: List[Stage]) -> None:
        """Hook invoked by the dispatcher for extracted stages that did NOT
        execute this round (chain truncation, deferred input, a sibling
        group that fell apart, a vanished resume checkpoint) — accounting
        policies refund them here; they will be re-extracted later."""

    def on_round_start(self, plan: SearchPlan, tree: StageTree) -> None:
        """Hook invoked once per scheduling round before extraction
        (per-round caches of accounting policies)."""

    def placement_hint(self, plan: SearchPlan, chains: List[List[Stage]],
                       workers: List[Any]) -> str:
        """Which of the mesh-compatible idle ``workers`` should host this
        work unit (``chains``: one chain, or a sibling-chain group)?

        Returns ``"wide"`` (narrowest mesh — spend devices on batching
        more trials elsewhere), ``"deep"`` (widest mesh — spend devices
        on sharding this chain), or ``"any"`` (first compatible).  The
        default trades the two parallelism axes per unit: sibling groups
        already parallelize *across trials*, so they take the narrowest
        compatible worker, while solo chains take the widest mesh and
        parallelize *within the model*.  With a homogeneous fleet every
        hint degenerates to the first idle worker."""
        return "wide" if len(chains) > 1 else "deep"

    def assign(self, plan: SearchPlan, tree: StageTree, n_paths: int,
               taken: Optional[set] = None) -> List[List[Stage]]:
        """Extract up to ``n_paths`` disjoint chains for idle workers.

        ``taken`` pre-seeds stages the dispatcher already placed this round
        (batched sibling groups): they are never re-extracted, and their
        children qualify as chain heads — chaining off the in-round states
        the groups produce."""
        taken = set() if taken is None else taken
        self.on_round_start(plan, tree)
        out = []
        for _ in range(n_paths):
            p = self.next_path(plan, tree, taken)
            if p is None:
                break
            self.on_path_assigned(plan, p)
            out.append(p)
        return out

    # ------------------------------------------------------------- estimates
    def stage_time(self, plan: SearchPlan, stage: Stage) -> float:
        return stage.steps * plan.profile_of(stage.node_id)


class CriticalPathScheduler(SchedulingPolicy):
    """The paper's critical-path extraction (§4.3).

    ``weighted=True`` is a compatibility alias for
    :class:`WeightedFanoutScheduler` priorities.
    """

    name = "critical_path"

    def __init__(self, weighted: bool = False):
        self.weighted = weighted

    # ------------------------------------------------------------ scheduling
    def _head_priority(self, stage: Stage, remaining: Dict[str, float],
                       fanout: Dict[str, int]):
        """Priority of a candidate chain head; subclass hook."""
        t = remaining[stage.stage_id]
        if self.weighted:
            return fanout[stage.stage_id] / max(t, 1e-9)
        return t

    def next_path(self, plan: SearchPlan, tree: StageTree,
                  taken: set) -> Optional[List[Stage]]:
        """The highest-priority maximal chain of unscheduled stages.

        A chain starts at a stage whose parent is either absent or already
        taken, and extends through the child subtree maximizing remaining
        time (critical path).  Returns None when every stage is taken.
        """
        # remaining[s] = est time of the heaviest downward path from s
        remaining: Dict[str, float] = {}
        fanout: Dict[str, int] = {}

        def walk(sid: str) -> float:
            st = tree.stages[sid]
            best_child = 0.0
            fo = 1 if st.report else 0
            for c in st.children:
                best_child = max(best_child, walk(c))
                fo += fanout[c]
            t = (0.0 if sid in taken else self.stage_time(plan, st)) + best_child
            remaining[sid] = t
            fanout[sid] = fo
            return t

        for r in tree.roots:
            walk(r)

        # candidate chain heads: unscheduled stages whose parent is taken/None
        heads = [
            s for s in tree.stages.values()
            if s.stage_id not in taken
            and (s.parent is None or s.parent in taken)
        ]
        if not heads:
            return None

        head = max(heads, key=lambda s: self._head_priority(s, remaining,
                                                            fanout))

        # extend the chain downward along the heaviest child
        path, cur = [], head
        while True:
            path.append(cur)
            taken.add(cur.stage_id)
            nxt = None
            for c in cur.children:
                if c in taken:
                    continue
                if nxt is None or remaining[c] > remaining[nxt.stage_id]:
                    nxt = tree.stages[c]
            if nxt is None:
                return path
            cur = nxt


class WeightedFanoutScheduler(CriticalPathScheduler):
    """Fan-out-per-second priority: unblock many report leaves early."""

    name = "weighted_fanout"

    def __init__(self):
        super().__init__(weighted=True)


class FIFOScheduler(SchedulingPolicy):
    """Chains in stage-creation order — request arrival order, since stage
    numbering follows pending-request order.  No time estimates used."""

    name = "fifo"

    def next_path(self, plan: SearchPlan, tree: StageTree,
                  taken: set) -> Optional[List[Stage]]:
        head = next(
            (s for s in tree.stages.values()
             if s.stage_id not in taken
             and (s.parent is None or s.parent in taken)), None)
        if head is None:
            return None
        path, cur = [], head
        while True:
            path.append(cur)
            taken.add(cur.stage_id)
            nxt = next((c for c in cur.children if c not in taken), None)
            if nxt is None:
                return path
            cur = tree.stages[nxt]


class FairShareScheduler(CriticalPathScheduler):
    """Per-study fair share for concurrent studies on one plan (§6.2).

    Each extracted stage's estimated GPU-seconds are **split** across the
    studies whose trials it serves — a stage shared by k studies charges
    each of them 1/k, so reuse shows up as every sharing study paying
    less, and a study that merges heavily cannot be priced out of the
    cluster by costs it never caused.  Candidate heads are ranked by the
    *least-served* study they would serve, with critical-path remaining
    time as tie-break.  Stages the dispatcher could not actually run this
    round (truncated tails, deferred chains, collapsed sibling groups)
    are refunded via ``on_stages_unassigned`` with the same split, so
    rescheduling never double-charges.

    Tenant quotas (front door): :meth:`set_study_weights` assigns each
    study a fair-share *weight* — ranking divides charged usage by it, so
    a study with weight 2 is served as if it had paid half, i.e. receives
    twice the share before the policy considers it "served".  A
    multi-tenant gateway maps per-tenant quota weights onto the study
    ids it admits.  The default weight is 1.0, so
    sessions without a front door schedule exactly as before.
    """

    name = "fair_share"

    def __init__(self):
        super().__init__()
        self.usage: Dict[str, float] = {}   # study id -> charged GPU-seconds
        self.weights: Dict[str, float] = {}  # study id -> fair-share weight
        self._plan_studies: Dict[str, frozenset] = {}

    def set_study_weights(self, weights: Dict[str, float]) -> None:
        """Assign fair-share weights (> 0) per study id; missing studies
        keep weight 1.0.  Snapshot-safe: the policy object is captured
        whole, so restored sessions keep their quota weights."""
        if not hasattr(self, "weights"):   # unpickled from a v4 snapshot
            self.weights = {}
        for sid, w in weights.items():
            if w <= 0:
                raise ValueError(f"fair-share weight for {sid!r} must be "
                                 f"> 0, got {w}")
            self.weights[sid] = float(w)

    def _weighted_usage(self, study: str) -> float:
        # getattr: policy objects unpickled from pre-weight snapshots
        # have no ``weights`` dict — they keep the default weight 1.0
        weights = getattr(self, "weights", None) or {}
        return self.usage.get(study, 0.0) / weights.get(study, 1.0)

    def _studies_of(self, plan: SearchPlan, stage: Stage) -> Set[str]:
        studies: Set[str] = set()
        for tid in plan.node(stage.node_id).trials:
            studies |= plan.studies_of_trial(tid)
        return studies

    def _head_priority(self, stage, remaining, fanout):
        studies = self._plan_studies.get(stage.stage_id, frozenset())
        if studies:
            least = min(self._weighted_usage(s) for s in studies)
        else:
            # no study attribution (submit() without study=): rank as the
            # most-served so unattributed work never starves real studies
            least = max(self.usage.values(), default=0.0)
        # smaller charged usage → higher priority; remaining time tie-break
        return (-least, remaining[stage.stage_id])

    def on_round_start(self, plan, tree):
        # cache stage → studies once per round; every extraction on the same
        # tree reuses it (rebuilt each round even when the dispatcher seeds
        # ``taken`` with batched groups)
        self._plan_studies = {sid: frozenset(self._studies_of(plan, st))
                              for sid, st in tree.stages.items()}

    def _charge(self, plan: SearchPlan, stages: List[Stage],
                sign: float) -> None:
        for st in stages:
            studies = self._studies_of(plan, st)
            if not studies:
                continue
            # split-charge: a chain shared by k studies costs each 1/k —
            # refunds (sign=-1) recompute the same split, so a stage
            # charged and refunded within one round nets to exactly zero
            cost = sign * self.stage_time(plan, st) / len(studies)
            for s in studies:
                self.usage[s] = self.usage.get(s, 0.0) + cost

    def on_path_assigned(self, plan: SearchPlan, path: List[Stage]) -> None:
        self._charge(plan, path, 1.0)

    def on_stages_unassigned(self, plan: SearchPlan,
                             stages: List[Stage]) -> None:
        self._charge(plan, stages, -1.0)


POLICIES: Dict[str, Callable[[], SchedulingPolicy]] = {
    "critical_path": CriticalPathScheduler,
    "weighted_fanout": WeightedFanoutScheduler,
    "fifo": FIFOScheduler,
    "fair_share": FairShareScheduler,
}


def make_policy(name: str) -> SchedulingPolicy:
    try:
        return POLICIES[name]()
    except KeyError:
        raise ValueError(
            f"unknown scheduling policy {name!r}; one of {sorted(POLICIES)}")
