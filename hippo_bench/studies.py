"""The traffic generator: a mix file → rounds of SHA studies on the port.

A mix (``traffic/<name>.json``) lists, for each study of a round, its
trials as learning-rate schedules: an initial value, the steps at which
it decays and the factor (``StepLR``), and a static weight decay.  This
module turns them into ``repro_torch`` trials and tuners and runs one
round: every study of the mix submitted upfront to one
``StudyService(share=True)`` on one worker, over a fresh search-plan
database and a fresh memory-tier checkpoint store, which is emptied once
the round has closed.  The rewrite of ``benchmarks/spaces.py``'s high- and
low-merge pattern on ``repro_torch.core.hpseq``.

A tuner's ``trial_steps`` is the benchmark's own count of what a round
delivered: for every request a tuner made, the steps from the trial's
previous rung to the requested one.  That is what trial-based execution
of the same trials, each resuming from its own rung checkpoint, would
have had to train.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))


def load_mix(name: str) -> Dict[str, Any]:
    with open(os.path.join(HERE, "traffic", name + ".json")) as f:
        return json.load(f)


def lr_at(spec: Dict[str, Any], step: int) -> float:
    """A trial's learning rate at ``step``: decayed by ``gamma`` at each
    milestone reached."""
    n = sum(1 for m in spec["milestones"] if step >= m)
    return spec["lr"] * spec["gamma"] ** n


def schedule(spec: Dict[str, Any], steps: int) -> List[Tuple[float, float]]:
    """``(lr, wd)`` of each step ``0 .. steps - 1``."""
    return [(lr_at(spec, s), float(spec["wd"])) for s in range(steps)]


def make_trials(study: List[Dict[str, Any]], max_steps: int):
    from repro_torch.core.hpseq import HpConfig, StepLR
    from repro_torch.core.trial import Trial
    return [Trial(HpConfig({"lr": StepLR(t["lr"], t["gamma"],
                                         t["milestones"])},
                           {"wd": float(t["wd"])}), max_steps)
            for t in study]


class _CountingHandle:
    """The tuner's study handle, counting each request's new steps."""

    def __init__(self, handle, tuner):
        self._handle = handle
        self._tuner = tuner

    def submit(self, trial, upto, *args, **kw):
        reached = self._tuner.reached
        self._tuner.trial_steps += upto - reached.get(trial.trial_id, 0)
        reached[trial.trial_id] = max(upto, reached.get(trial.trial_id, 0))
        return self._handle.submit(trial, upto, *args, **kw)

    def __getattr__(self, name):
        return getattr(self._handle, name)


def make_tuner(trials, tuner_spec: Dict[str, Any]):
    """An SHA tuner that keeps every ``(trial_id, step) -> metrics`` it was
    told and counts the trial-equivalent steps it asked for."""
    from repro_torch.core.tuners.sha import SHATuner
    if tuner_spec["kind"] != "sha":
        raise ValueError(f"unknown tuner {tuner_spec['kind']!r}")

    class RecordingSHATuner(SHATuner):
        def __init__(self):
            super().__init__(trials, tuner_spec["min_steps"],
                             tuner_spec["max_steps"], eta=tuner_spec["eta"])
            self.history: Dict[Tuple[str, int], Dict[str, float]] = {}
            self.reached: Dict[str, int] = {}
            self.trial_steps = 0

        def start(self, handle):
            super().start(_CountingHandle(handle, self))

        def on_result(self, trial, step, metrics):
            self.history[(trial.trial_id, step)] = dict(metrics)
            super().on_result(trial, step, metrics)

    return RecordingSHATuner()


def run_round(backend, mix: Dict[str, Any], model: str, round_index: int = 0,
              store=None):
    """One round of ``mix`` on ``backend``: returns ``(stats, tuners,
    trials, store)``, the store emptied."""
    from repro_torch.core import SearchPlanDB
    from repro_torch.core.study import StudyService, StudySpec
    from repro_torch.train.checkpoint import CheckpointStore
    tspec = mix["tuner"]
    store = CheckpointStore() if store is None else store
    svc = StudyService(SearchPlanDB(), backend, n_workers=1, share=True,
                       store=store)
    spec = StudySpec(model, "synthetic-lm", ("lr",))
    trials = [make_trials(study, tspec["max_steps"])
              for study in mix["studies"]]
    tuners = [make_tuner(ts, tspec) for ts in trials]
    for i, tuner in enumerate(tuners):
        svc.submit(spec, tuner, study_id=f"round{round_index}-study{i}")
    stats = svc.close()
    empty(store)
    return stats, tuners, trials, store


def empty(store) -> None:
    """Evict every checkpoint a finished round left in ``store``."""
    for cid in list(store.committed_ids()):
        store.evict(cid)
