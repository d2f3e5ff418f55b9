"""Trials and their canonical segment decomposition (Hippo §3.1).

A *trial* is a pair ``(hp_config, total_steps)`` — exactly the "trial
request" of §4.1: "a pair of a hyper-parameter sequence configuration and
the number of training steps".

A trial is canonically decomposed into *segments*: maximal step intervals
on which every hyper-parameter function stays within a single functional
piece.  Segment descriptors are offset-normalized (see
``HpFunction.piece_descriptor``) so that two trials produce *equal
descriptors* on a step range iff their hyper-parameter values coincide
there structurally — this is the prefix-matching relation the search plan
uses to merge trials into shared nodes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from repro_torch.core.hpseq import HpConfig
from repro_torch.utils import stable_hash

__all__ = ["Segment", "Trial"]


@dataclass(frozen=True)
class Segment:
    """A maximal step interval of a trial under one functional piece."""

    start: int
    stop: int
    desc: Any  # canonical descriptor: {"hps": {...}, "static": {...}}

    @property
    def steps(self) -> int:
        return self.stop - self.start

    def desc_hash(self) -> str:
        return stable_hash(self.desc)


@dataclass
class Trial:
    """A trial request: hyper-parameter sequences + total training steps.

    ``eval_steps`` optionally lists intermediate steps at which the trial
    wants metrics reported (tuner rungs add these dynamically as separate
    requests instead).
    """

    hp_config: HpConfig
    total_steps: int
    trial_id: Optional[str] = None
    meta: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        if self.trial_id is None:
            self.trial_id = "trial-" + stable_hash(
                {"hp": self.hp_config.to_json(), "steps": self.total_steps})[:12]

    # -------------------------------------------------------------- segments
    def segments(self, upto: Optional[int] = None) -> List[Segment]:
        """Canonical decomposition of [0, upto) into functional segments."""
        total = self.total_steps if upto is None else min(upto, self.total_steps)
        cuts = [0] + self.hp_config.boundaries(total) + [total]
        segs: List[Segment] = []
        for a, b in zip(cuts[:-1], cuts[1:]):
            if b <= a:
                continue
            desc = {
                "hps": {k: fn.piece_descriptor(a, b)
                        for k, fn in self.hp_config.fns.items()},
                "static": self.hp_config.static,
            }
            segs.append(Segment(a, b, desc))
        return segs

    # ------------------------------------------------------------- hp values
    def hp_at(self, step: int) -> Dict[str, Any]:
        return self.hp_config.values_dict(step)

    def to_json(self):
        return {"trial_id": self.trial_id,
                "hp_config": self.hp_config.to_json(),
                "total_steps": self.total_steps,
                "meta": self.meta}

    @classmethod
    def from_json(cls, d) -> "Trial":
        return cls(HpConfig.from_json(d["hp_config"]), d["total_steps"],
                   trial_id=d.get("trial_id"), meta=d.get("meta") or {})

    def __repr__(self):
        return f"Trial({self.trial_id}, steps={self.total_steps})"
