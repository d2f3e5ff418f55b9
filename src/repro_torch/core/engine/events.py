"""Event heap and virtual clock for the discrete-event engine.

The engine is a deterministic discrete-event simulation: every state change
(stage completion, tuner reply, worker going idle) is an :class:`Event` on
one monotonic heap, ordered by (time, insertion seq) so simultaneous events
replay in submission order — the property that makes runs byte-reproducible.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Any, List, Optional

__all__ = ["Event", "EventLoop"]


@dataclass(order=True)
class Event:
    time: float
    seq: int
    kind: str = field(compare=False)
    payload: Any = field(compare=False)


class EventLoop:
    """Min-heap of events plus the virtual clock they advance."""

    def __init__(self):
        self.time = 0.0
        self._events: List[Event] = []
        # a plain int (not itertools.count) so the loop pickles cleanly
        self._seq = 0

    def push(self, t: float, kind: str, payload: Any) -> None:
        heapq.heappush(self._events, Event(t, self._seq, kind, payload))
        self._seq += 1

    def pop(self) -> Event:
        """Pop the earliest event and advance the clock to it."""
        ev = heapq.heappop(self._events)
        assert ev.time >= self.time - 1e-9
        self.time = max(self.time, ev.time)
        return ev

    def peek(self) -> Optional[Event]:
        """The earliest event without popping it (None when empty)."""
        return self._events[0] if self._events else None

    def __bool__(self) -> bool:
        return bool(self._events)

    def __len__(self) -> int:
        return len(self._events)
