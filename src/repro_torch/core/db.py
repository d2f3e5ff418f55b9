"""Search-plan database (Hippo §4.2) — the MySQL analogue.

Holds one :class:`SearchPlan` per study *key* — the (model, dataset,
hyper-parameter set) triple of §5.2.  Studies submitting under the same key
share a plan, which is the entire multi-study merging mechanism.  An
optional JSON journal persists plans across processes (swap-in point for a
real database in deployment).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

from repro_torch.core.searchplan import SearchPlan
from repro_torch.utils import stable_hash

__all__ = ["SearchPlanDB", "study_key"]


def study_key(model: str, dataset: str, hp_set: Tuple[str, ...]) -> str:
    """Canonical study key: same (model, dataset, hp types) → same plan."""
    return stable_hash({"model": model, "dataset": dataset,
                        "hp_set": sorted(hp_set)})[:16]


class SearchPlanDB:
    def __init__(self, journal_dir: Optional[str] = None):
        self.journal_dir = journal_dir
        if journal_dir:
            os.makedirs(journal_dir, exist_ok=True)
        self._plans: Dict[str, SearchPlan] = {}

    def get(self, key: str) -> SearchPlan:
        if key not in self._plans:
            path = self._path(key)
            if path and os.path.exists(path):
                with open(path) as f:
                    self._plans[key] = SearchPlan.from_json(json.load(f))
            else:
                self._plans[key] = SearchPlan(key)
        return self._plans[key]

    def put(self, key: str, plan: SearchPlan) -> None:
        """Install a live plan under ``key`` (session restore: the revived
        plan object — revision map, pending index, running marks — replaces
        whatever a journal reload would have produced)."""
        self._plans[key] = plan

    def checkpoint(self, key: str) -> None:
        """Journal a plan to disk (called by the aggregator after updates)."""
        path = self._path(key)
        if not path:
            return
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._plans[key].to_json(), f)
        os.replace(tmp, path)

    def keys(self):
        return list(self._plans)

    def _path(self, key: str) -> Optional[str]:
        if not self.journal_dir:
            return None
        return os.path.join(self.journal_dir, f"plan-{key}.json")
