"""Grid search: every configuration trained to the full step budget.

Paper §6.1 runs grid search for MobileNetV2 and BERT-Base; its GPU-hour
saving under stage-based execution matches the search space's merge rate
``p`` almost exactly (3.15x vs p=3.144), which is the headline sanity check
for the faithful reproduction.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.core.engine import StudyHandle, Tuner
from repro_torch.core.trial import Trial

__all__ = ["GridTuner"]


class GridTuner(Tuner):
    def __init__(self, trials: List[Trial], objective: str = "val_acc",
                 mode: str = "max", extra_steps_for_best: int = 0):
        self.trials = list(trials)
        self.objective, self.mode = objective, mode
        self.extra_steps_for_best = extra_steps_for_best
        self._pending = {t.trial_id for t in trials}
        self._results: Dict[str, float] = {}
        self._handle: Optional[StudyHandle] = None
        self._extra_pending: Optional[str] = None
        self.best: Optional[Trial] = None
        self.best_metrics: Optional[Dict[str, float]] = None
        self.best_score: float = float("-inf")

    def start(self, handle: StudyHandle) -> None:
        self._handle = handle
        for t in self.trials:
            handle.submit(t)

    def on_result(self, trial: Trial, step: int, metrics: Dict[str, float]) -> None:
        if self._extra_pending == trial.trial_id:
            self._extra_pending = None
            self.best_metrics = metrics
            return
        if trial.trial_id not in self._pending:
            return
        self._pending.discard(trial.trial_id)
        s = self.score(metrics)
        self._results[trial.trial_id] = s
        if s > self.best_score:
            self.best_score = s
        if not self._pending:
            best_id = max(self._results, key=self._results.get)
            self.best = next(t for t in self.trials if t.trial_id == best_id)
            self.best_metrics = metrics if best_id == trial.trial_id else None
            if self.extra_steps_for_best:
                # §6.1: "Only the trial with the highest accuracy is trained
                # for 100 additional epochs."
                extended = Trial(self.best.hp_config,
                                 self.best.total_steps + self.extra_steps_for_best,
                                 trial_id=self.best.trial_id + "-extra")
                self._extra_pending = extended.trial_id
                self._handle.submit(extended)

    def is_done(self) -> bool:
        return not self._pending and self._extra_pending is None
