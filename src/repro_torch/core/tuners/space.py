"""Search-space definition (Hippo Figure 10).

Users express each hyper-parameter directly as a list of *sequence
functions*; the grid product of the per-hp choices (optionally filtered)
yields the trial configurations.  Static (non-sequential) hyper-parameters
— optimizer choice, weight decay in the paper's Tables 2-4 — are given as
plain value lists and land in ``HpConfig.static``.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, List, Optional, Sequence

from repro_torch.core.hpseq import HpConfig, HpFunction
from repro_torch.core.trial import Trial

__all__ = ["GridSearchSpace"]


class GridSearchSpace:
    def __init__(self, fns: Dict[str, Sequence[HpFunction]],
                 static: Optional[Dict[str, Sequence[Any]]] = None,
                 filter_fn: Optional[Callable[[HpConfig], bool]] = None):
        self.fns = {k: list(v) for k, v in sorted(fns.items())}
        self.static = {k: list(v) for k, v in sorted((static or {}).items())}
        self.filter_fn = filter_fn

    def configs(self) -> List[HpConfig]:
        fn_names = list(self.fns)
        st_names = list(self.static)
        out: List[HpConfig] = []
        for fn_choice in itertools.product(*(self.fns[k] for k in fn_names)):
            for st_choice in itertools.product(*(self.static[k] for k in st_names)):
                cfg = HpConfig(dict(zip(fn_names, fn_choice)),
                               dict(zip(st_names, st_choice)))
                if self.filter_fn is None or self.filter_fn(cfg):
                    out.append(cfg)
        return out

    def trials(self, total_steps: int) -> List[Trial]:
        return [Trial(cfg, total_steps) for cfg in self.configs()]

    def __len__(self) -> int:
        n = 1
        for v in self.fns.values():
            n *= len(v)
        for v in self.static.values():
            n *= len(v)
        if self.filter_fn is not None:
            return len(self.configs())
        return n
