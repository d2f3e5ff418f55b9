"""Successive Halving (SHA, Jamieson & Talwalkar 2016) — synchronous rungs.

Rung ``r`` trains ``n / eta^r`` configurations to ``min_steps * eta^r``
steps; when *all* of a rung's results are in, the top ``1/eta`` fraction is
promoted to the next rung.  Promotion re-submits the same trial with a
larger step budget — the search plan resumes it from its own rung
checkpoint, and (under stage sharing) from *any* trial's checkpoint with
the same hp prefix.

Ties are broken by a trial's position in the list the tuner was given, at
promotion (a stable sort of the rung) and for ``best`` alike — never by the
order in which results arrive, which a wall-clock backend does not
reproduce.  Two runs that report the same metrics pick the same ``best``.

Paper policy for ResNet56: ``reduction=4, min=15, max=120`` (Table 1).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

from repro_torch.core.engine import StudyHandle, Tuner
from repro_torch.core.trial import Trial

__all__ = ["SHATuner", "sha_rungs"]


def sha_rungs(min_steps: int, max_steps: int, eta: int) -> List[int]:
    rungs = []
    s = min_steps
    while s < max_steps:
        rungs.append(s)
        s *= eta
    rungs.append(max_steps)
    return rungs


class SHATuner(Tuner):
    def __init__(self, trials: List[Trial], min_steps: int, max_steps: int,
                 eta: int = 4, objective: str = "val_acc", mode: str = "max"):
        self.all_trials = list(trials)
        self._order = {t.trial_id: i for i, t in enumerate(self.all_trials)}
        self.eta = eta
        self.rungs = sha_rungs(min_steps, max_steps, eta)
        self.objective, self.mode = objective, mode
        self._rung = 0
        self._active: List[Trial] = list(trials)
        self._scores: Dict[str, float] = {}
        self._pending: set = set()
        self._handle: Optional[StudyHandle] = None
        self._done = False
        self.best: Optional[Trial] = None
        self.best_score: float = -math.inf

    def start(self, handle: StudyHandle) -> None:
        self._handle = handle
        self._launch_rung()

    def _launch_rung(self) -> None:
        step = self.rungs[self._rung]
        self._scores.clear()
        self._pending = {t.trial_id for t in self._active}
        for t in self._active:
            self._handle.submit(t, upto=min(step, t.total_steps))

    def on_result(self, trial: Trial, step: int, metrics: Dict[str, float]) -> None:
        if trial.trial_id not in self._pending:
            return
        rung_step = min(self.rungs[self._rung], trial.total_steps)
        if step != rung_step:
            return
        self._pending.discard(trial.trial_id)
        s = self.score(metrics)
        self._scores[trial.trial_id] = s
        if s > self.best_score or (
                s == self.best_score and self.best is not None
                and self._order[trial.trial_id]
                < self._order[self.best.trial_id]):
            self.best_score, self.best = s, trial
        if self._pending:
            return
        # rung complete — promote top 1/eta
        if self._rung == len(self.rungs) - 1:
            self._done = True
            return
        k = max(1, len(self._active) // self.eta)
        ranked = sorted(self._active, key=lambda t: self._scores[t.trial_id],
                        reverse=True)
        survivors, dropped = ranked[:k], ranked[k:]
        for t in dropped:
            self._handle.kill(t)
        self._active = survivors
        self._rung += 1
        self._launch_rung()

    def is_done(self) -> bool:
        return self._done
