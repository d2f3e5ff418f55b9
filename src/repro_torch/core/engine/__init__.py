"""Event-driven execution engine package.

* :mod:`~repro_torch.core.engine.events`     — event heap + virtual clock,
* :mod:`~repro_torch.core.engine.dispatch`   — scheduling rounds, chain
  assignment/truncation, worker-side execution,
* :mod:`~repro_torch.core.engine.aggregator` — result recording, waiter
  wakeup, checkpoint GC,
* :mod:`~repro_torch.core.engine.engine`     — the public
  :class:`ExecutionEngine` facade (``run()``, ``handle()``) plus the
  re-entrant session loop (``step`` / ``drain`` / ``admit`` /
  ``cancel_study`` / ``finish``) the service plane drives.
"""

from repro_torch.core.engine.engine import (EngineStats, ExecutionEngine,
                                            StudyHandle, StudyStats, Tuner)
from repro_torch.core.engine.events import Event, EventLoop
from repro_torch.core.engine.dispatch import Dispatcher, Worker
from repro_torch.core.engine.aggregator import Aggregator

__all__ = ["ExecutionEngine", "Tuner", "StudyHandle", "EngineStats",
           "StudyStats", "Event", "EventLoop", "Dispatcher", "Worker",
           "Aggregator"]
