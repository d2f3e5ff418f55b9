"""Hyperband (Li et al. 2017): brackets of Successive Halving.

Bracket ``s`` starts ``n_s`` configurations at ``max_steps / eta^s`` and
runs SHA on them; brackets trade breadth for per-trial budget.  Because
every bracket's trials land in the same search plan, stage sharing applies
*across brackets* too — a beyond-paper corollary of the multi-study
mechanism.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

from repro_torch.core.engine import StudyHandle, Tuner
from repro_torch.core.trial import Trial
from repro_torch.core.tuners.sha import SHATuner

__all__ = ["HyperbandTuner"]


class HyperbandTuner(Tuner):
    def __init__(self, trials: List[Trial], max_steps: int, eta: int = 4,
                 objective: str = "val_acc", mode: str = "max"):
        self.objective, self.mode = objective, mode
        s_max = int(math.floor(math.log(max_steps, eta)))
        self.brackets: List[SHATuner] = []
        i = 0
        for s in range(s_max, -1, -1):
            n = max(1, int(math.ceil((s_max + 1) / (s + 1) * eta ** s)))
            chunk = trials[i:i + n]
            i += n
            if not chunk:
                break
            min_steps = max(1, max_steps // (eta ** s))
            self.brackets.append(SHATuner(
                chunk, min_steps=min_steps, max_steps=max_steps, eta=eta,
                objective=objective, mode=mode))

    def start(self, handle: StudyHandle) -> None:
        for b in self.brackets:
            b.start(handle)

    def on_result(self, trial: Trial, step: int, metrics: Dict[str, float]) -> None:
        for b in self.brackets:
            b.on_result(trial, step, metrics)

    def is_done(self) -> bool:
        return all(b.is_done() for b in self.brackets)

    @property
    def best(self) -> Optional[Trial]:
        done = [b for b in self.brackets if b.best is not None]
        if not done:
            return None
        return max(done, key=lambda b: b.best_score).best
