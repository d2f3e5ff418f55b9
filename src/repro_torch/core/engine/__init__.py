"""Event-driven execution engine package.

* :mod:`~repro_torch.core.engine.events`     — event heap + virtual clock,
* :mod:`~repro_torch.core.engine.dispatch`   — scheduling rounds, chain
  assignment/truncation, worker-side execution,
* :mod:`~repro_torch.core.engine.aggregator` — result recording, waiter
  wakeup, checkpoint GC,
* :mod:`~repro_torch.core.engine.engine`     — the public
  :class:`ExecutionEngine` facade (``run()``, ``handle()``) plus the
  re-entrant session loop (``step`` / ``drain`` / ``admit`` /
  ``cancel_study`` / ``finish``) the service plane drives,
* :mod:`~repro_torch.core.engine.session`    — durable session snapshots
  (:class:`SessionState`, capture/restore) behind
  ``StudyService.snapshot`` / ``StudyService.restore``.
"""

from repro_torch.core.engine.engine import (EngineStats, ExecutionEngine,
                                            StudyHandle, StudyStats, Tuner)
from repro_torch.core.engine.events import Event, EventLoop
from repro_torch.core.engine.dispatch import Dispatcher, Worker
from repro_torch.core.engine.aggregator import Aggregator
from repro_torch.core.engine.session import (SessionState, capture_session,
                                             load_latest_session,
                                             load_session, migrate_session,
                                             restore_engine, save_session,
                                             save_session_rotated,
                                             session_rotation,
                                             sweep_session_tmps)

__all__ = ["ExecutionEngine", "Tuner", "StudyHandle", "EngineStats",
           "StudyStats", "Event", "EventLoop", "Dispatcher", "Worker",
           "Aggregator", "SessionState", "capture_session", "restore_engine",
           "migrate_session", "save_session", "load_session",
           "save_session_rotated", "load_latest_session", "session_rotation",
           "sweep_session_tmps"]
