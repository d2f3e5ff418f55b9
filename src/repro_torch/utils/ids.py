"""Deterministic id generation (no wall-clock / randomness: journal-safe)."""

from __future__ import annotations


class IdGen:
    """Monotonic id generator with a string prefix, e.g. ``stage-17``."""

    def __init__(self, prefix: str, start: int = 0):
        self.prefix = prefix
        # a plain int (not itertools.count) so an IdGen pickles cleanly
        self._next = start

    def __call__(self) -> str:
        n = self._next
        self._next = n + 1
        return f"{self.prefix}-{n}"
