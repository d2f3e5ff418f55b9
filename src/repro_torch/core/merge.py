"""Merge rates (Hippo §6, "Merge rate").

``p  = total training iterations / unique training iterations`` for one
study; ``q`` is the k-wise analogue over several studies' trial sets
combined.  *Total* counts every trial trained independently to its maximum
budget; *unique* is the step count after prefix merging — computed exactly
by inserting all trials into a fresh search plan and summing the per-node
unique step ranges.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence

from repro_torch.core.searchplan import SearchPlan
from repro_torch.core.trial import Trial

__all__ = ["unique_steps", "total_steps", "merge_rate", "k_wise_merge_rate"]


def total_steps(trials: Iterable[Trial]) -> int:
    return sum(t.total_steps for t in trials)


def unique_steps(trials: Iterable[Trial]) -> int:
    """Steps needed with zero redundant computation (merged stage count)."""
    plan = SearchPlan("merge-rate")
    per_node_max: dict = {}
    for t in trials:
        node, step, _ = plan.submit(t)
        # the full path up to `step` is required: each node on the path is
        # needed up to the child's start (or `step` for the leaf)
    unique = 0
    for nid, node in plan.nodes.items():
        # the range a node must be trained for = max over (requests on the
        # node, children starts)
        tops = set(node.requests)
        for cid in plan.children.get(nid, []):
            tops.add(plan.nodes[cid].start)
        if tops:
            unique += max(tops) - node.start
    return unique


def merge_rate(trials: Sequence[Trial]) -> float:
    u = unique_steps(trials)
    return total_steps(trials) / u if u else float("inf")


def k_wise_merge_rate(studies: Sequence[Sequence[Trial]]) -> float:
    """q over k studies: totals add up; uniqueness is computed jointly."""
    all_trials: List[Trial] = [t for s in studies for t in s]
    u = unique_steps(all_trials)
    return total_steps(all_trials) / u if u else float("inf")
