"""Median stopping rule (Google Vizier, Golovin et al. 2017).

Trials report at fixed milestones; a trial is killed at milestone ``m`` if
its best score so far is strictly worse than the *median of the running
averages* of all other trials' scores up to ``m``.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional

from repro_torch.core.engine import StudyHandle, Tuner
from repro_torch.core.trial import Trial

__all__ = ["MedianStoppingTuner"]


class MedianStoppingTuner(Tuner):
    def __init__(self, trials: List[Trial], milestones: List[int],
                 grace_milestones: int = 1, objective: str = "val_acc",
                 mode: str = "max"):
        self.all_trials = list(trials)
        self.milestones = sorted(milestones)
        self.grace = grace_milestones
        self.objective, self.mode = objective, mode
        self._idx: Dict[str, int] = {}            # trial -> milestone index
        self._history: Dict[str, List[float]] = {}
        self._alive: set = {t.trial_id for t in trials}
        self._outstanding: set = set()
        self._handle: Optional[StudyHandle] = None
        self.best: Optional[Trial] = None
        self.best_score = float("-inf")

    def start(self, handle: StudyHandle) -> None:
        self._handle = handle
        for t in self.all_trials:
            self._idx[t.trial_id] = 0
            self._history[t.trial_id] = []
            self._outstanding.add(t.trial_id)
            handle.submit(t, upto=min(self.milestones[0], t.total_steps))

    def on_result(self, trial: Trial, step: int, metrics: Dict[str, float]) -> None:
        tid = trial.trial_id
        if tid not in self._outstanding:
            return
        i = self._idx[tid]
        if step != min(self.milestones[i], trial.total_steps):
            return
        self._outstanding.discard(tid)
        s = self.score(metrics)
        self._history[tid].append(s)
        if s > self.best_score:
            self.best_score, self.best = s, trial

        last = (i == len(self.milestones) - 1
                or self.milestones[i] >= trial.total_steps)
        if last:
            return
        if i + 1 > self.grace:
            others = [statistics.fmean(h[:i + 1])
                      for t, h in self._history.items()
                      if t != tid and len(h) >= i + 1]
            if others and max(self._history[tid]) < statistics.median(others):
                self._alive.discard(tid)
                self._handle.kill(trial)
                return
        self._idx[tid] = i + 1
        self._outstanding.add(tid)
        self._handle.submit(trial,
                            upto=min(self.milestones[i + 1], trial.total_steps))

    def is_done(self) -> bool:
        return not self._outstanding
