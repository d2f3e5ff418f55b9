"""Population Based Training (Jaderberg et al. 2017) on stage sharing.

PBT is the algorithm most naturally served by Hippo's representation: an
*exploit* copies a winner's weights and perturbs its hyper-parameters —
i.e. the loser's new configuration is, by construction, a trial whose
hyper-parameter sequence shares the winner's entire prefix.  Expressed as
``Seq((winner_fn, t), (Constant(perturbed), ...))`` the search plan
dedups the copy automatically: the exploited member resumes from the
winner's checkpoint without any weight-copy plumbing.

Decisions are deterministic (hash-seeded) so runs are journal-replayable.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

from repro_torch.core.engine import StudyHandle, Tuner
from repro_torch.core.hpseq import Constant, HpConfig, Seq
from repro_torch.core.trial import Trial
from repro_torch.utils import stable_hash

__all__ = ["PBTTuner", "extend_config"]


def extend_config(cfg: HpConfig, at: int, new_values: Dict[str, float]) -> HpConfig:
    """cfg's values on [0, at), then constant ``new_values[k]`` afterwards."""
    fns = {}
    for name, fn in cfg.fns.items():
        if name in new_values:
            fns[name] = Seq((fn, at), (Constant(new_values[name]), None))
        else:
            fns[name] = fn
    return HpConfig(fns, dict(cfg.static))


class _Member:
    def __init__(self, idx: int, cfg: HpConfig):
        self.idx = idx
        self.cfg = cfg
        self.score: float = -math.inf


class PBTTuner(Tuner):
    def __init__(self, configs: List[HpConfig], interval: int,
                 generations: int, mutable: Optional[List[str]] = None,
                 quantile: float = 0.25, factors=(0.8, 1.25),
                 objective: str = "val_acc", mode: str = "max"):
        self.members = [_Member(i, c) for i, c in enumerate(configs)]
        self.interval = interval
        self.generations = generations
        self.mutable = mutable  # None = all sequence hps
        self.quantile = quantile
        self.factors = factors
        self.objective, self.mode = objective, mode
        self._gen = 0
        self._pending: Dict[str, _Member] = {}
        self._handle: Optional[StudyHandle] = None
        self._done = False
        self.best_score = -math.inf
        self.best_cfg: Optional[HpConfig] = None

    # ---------------------------------------------------------------- rounds
    def start(self, handle: StudyHandle) -> None:
        self._handle = handle
        self._launch()

    def _launch(self) -> None:
        step = (self._gen + 1) * self.interval
        self._pending.clear()
        for m in self.members:
            t = Trial(m.cfg, step)
            self._pending[t.trial_id] = m
            self._handle.submit(t)

    def on_result(self, trial: Trial, step: int, metrics: Dict[str, float]) -> None:
        m = self._pending.pop(trial.trial_id, None)
        if m is None:
            return
        m.score = self.score(metrics)
        if m.score > self.best_score:
            self.best_score, self.best_cfg = m.score, m.cfg
        if self._pending:
            return
        self._gen += 1
        if self._gen >= self.generations:
            self._done = True
            return
        self._exploit_explore()
        self._launch()

    # ------------------------------------------------------ exploit/explore
    def _pick(self, seed_obj, options: List):
        h = int(stable_hash(seed_obj)[:8], 16)
        return options[h % len(options)]

    def _exploit_explore(self) -> None:
        t = self._gen * self.interval
        ranked = sorted(self.members, key=lambda m: m.score, reverse=True)
        k = max(1, int(len(ranked) * self.quantile))
        top, bottom = ranked[:k], ranked[-k:]
        for loser in bottom:
            winner = self._pick(("exploit", self._gen, loser.idx),
                                [m.idx for m in top])
            wcfg = self.members[winner].cfg
            new_vals = {}
            names = self.mutable if self.mutable is not None else list(wcfg.fns)
            for name in names:
                cur = wcfg.fns[name].value(t)
                f = self._pick(("explore", self._gen, loser.idx, name),
                               list(self.factors))
                new_vals[name] = cur * f
            loser.cfg = extend_config(wcfg, t, new_vals)

    def is_done(self) -> bool:
        return self._done
