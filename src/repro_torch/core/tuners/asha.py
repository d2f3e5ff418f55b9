"""Asynchronous Successive Halving (ASHA, Li et al. 2020).

Unlike synchronous SHA, promotion decisions are made *immediately* as each
result arrives: a trial reporting at rung ``r`` is promoted to rung
``r+1`` iff its score is within the top ``1/eta`` of all rung-``r`` results
seen *so far*.  No barrier → no stragglers, but (as the paper observes in
§6.1) fewer trials end up promoted than synchronous SHA, so Hippo-trial
under ASHA already beats Ray Tune's synchronous behaviour.

Re-implemented per the original paper (the Hippo authors likewise
re-implemented ASHA on Ray Tune "as the implementation provided by Ray
Tune was different from the original paper").
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Set

from repro_torch.core.engine import StudyHandle, Tuner
from repro_torch.core.trial import Trial
from repro_torch.core.tuners.sha import sha_rungs

__all__ = ["ASHATuner"]


class ASHATuner(Tuner):
    def __init__(self, trials: List[Trial], min_steps: int, max_steps: int,
                 eta: int = 4, objective: str = "val_acc", mode: str = "max"):
        self.all_trials = list(trials)
        self.eta = eta
        self.rungs = sha_rungs(min_steps, max_steps, eta)
        self.objective, self.mode = objective, mode
        # rung index -> {trial_id: score}
        self._rung_results: List[Dict[str, float]] = [dict() for _ in self.rungs]
        # rung index -> promoted trial ids
        self._promoted: List[Set[str]] = [set() for _ in self.rungs]
        self._trial_rung: Dict[str, int] = {}
        self._outstanding: Set[str] = set()
        self._finished: Set[str] = set()
        self._handle: Optional[StudyHandle] = None
        self.best: Optional[Trial] = None
        self.best_score: float = -math.inf

    def start(self, handle: StudyHandle) -> None:
        self._handle = handle
        for t in self.all_trials:
            self._trial_rung[t.trial_id] = 0
            self._outstanding.add(t.trial_id)
            handle.submit(t, upto=min(self.rungs[0], t.total_steps))

    def _top_k_cut(self, rung: int) -> float:
        scores = sorted(self._rung_results[rung].values(), reverse=True)
        k = len(scores) // self.eta
        if k == 0:
            return math.inf  # not enough results yet to justify promotion
        return scores[k - 1]

    def on_result(self, trial: Trial, step: int, metrics: Dict[str, float]) -> None:
        tid = trial.trial_id
        if tid not in self._outstanding:
            return
        rung = self._trial_rung[tid]
        expect = min(self.rungs[rung], trial.total_steps)
        if step != expect:
            return
        self._outstanding.discard(tid)
        s = self.score(metrics)
        self._rung_results[rung][tid] = s
        if s > self.best_score:
            self.best_score, self.best = s, trial
        if rung == len(self.rungs) - 1 or expect >= trial.total_steps:
            self._finished.add(tid)
        # try to promote any promotable trial at any rung (newly arrived
        # results can make older trials promotable)
        self._promote_all()
        if not self._outstanding and not self._promotable_exists():
            # everything left would never be promoted — mark finished
            for r, results in enumerate(self._rung_results[:-1]):
                for t in results:
                    self._finished.add(t)
            for t in self._rung_results[-1]:
                self._finished.add(t)

    def _promotable_exists(self) -> bool:
        for r in range(len(self.rungs) - 1):
            cut = self._top_k_cut(r)
            for tid, s in self._rung_results[r].items():
                if tid not in self._promoted[r] and s >= cut:
                    return True
        return False

    def _promote_all(self) -> None:
        for r in range(len(self.rungs) - 1):
            cut = self._top_k_cut(r)
            for tid, s in sorted(self._rung_results[r].items(),
                                 key=lambda kv: -kv[1]):
                if tid in self._promoted[r] or s < cut:
                    continue
                trial = next(t for t in self.all_trials if t.trial_id == tid)
                if self.rungs[r] >= trial.total_steps:
                    continue
                self._promoted[r].add(tid)
                self._trial_rung[tid] = r + 1
                self._outstanding.add(tid)
                self._finished.discard(tid)
                self._handle.submit(
                    trial, upto=min(self.rungs[r + 1], trial.total_steps))

    def is_done(self) -> bool:
        return not self._outstanding
