"""HPO algorithms provided by the client library (Hippo §5.2).

All tuners run on top of the stage-sharing execution engine — they submit
trial requests ``(hp_config, steps)`` and react to metric reports; the
engine/search-plan layer transparently dedups whatever computation their
trials share.
"""

from repro_torch.core.tuners.space import GridSearchSpace
from repro_torch.core.tuners.grid import GridTuner
from repro_torch.core.tuners.sha import SHATuner
from repro_torch.core.tuners.asha import ASHATuner
from repro_torch.core.tuners.hyperband import HyperbandTuner
from repro_torch.core.tuners.median import MedianStoppingTuner
from repro_torch.core.tuners.pbt import PBTTuner

__all__ = [
    "GridSearchSpace", "GridTuner", "SHATuner", "ASHATuner",
    "HyperbandTuner", "MedianStoppingTuner", "PBTTuner",
]
