"""Spans of the port's own work: one tracer for every layer boundary.

A span is a named host interval on ``time.perf_counter`` with its parent,
its work unit, its thread and attributes.  A span given a CUDA ``device``
also records a pair of ``torch.cuda.Event`` s on that device's current
stream; :meth:`Record.device_s` reads the time between them after the
fact, so nothing synchronises while the span runs.

Recording is on while a ``torch.profiler`` session is active in the
process (the profiler's own flag in ``torch.autograd.profiler``) or inside
a :func:`recording` block.  Off, :func:`span`, :func:`unit` and
:func:`traced` check two flags and do nothing else: no record, no clock
read, no CUDA call.  Records go to one bounded in-memory buffer of
:data:`CAPACITY` records; once it is full, later spans are not kept and
:func:`dropped` counts them.  Spans nest per thread (a span's parent is
the innermost span open on its thread when it opens), and :func:`unit`
names the work unit — the dispatcher's ``node_id:stop`` key of a chain or
a group — that the spans opened inside it belong to.

The spans, from the root down:

* ``engine.step`` — :meth:`ExecutionEngine.step` (and ``drain``'s first
  dispatcher round): one event and the dispatcher round after it;
* ``ckpt.get`` — the store read of a resume checkpoint; ``ckpt.put`` —
  one boundary checkpoint deposited;
* ``train.chain`` — a chain (or a stage) run by ``TorchTrainer``;
  ``train.group`` — a sibling group; ``train.evaluate`` — an evaluation,
  its read-back included;
* ``train.chunk`` — device-timed: one chunk's steps, attributes ``steps``
  (member-steps: members × steps) and ``members`` (the group's width);
* ``train.ssd_scan`` — one SSD layer's chunked scan in a forward
  (``models/ssm.py``: the B5 call, the chunks' state hand-off, the
  inter-chunk output), inside a chunk or an evaluation;
* ``data.slab`` — the data slab drawn on the host; ``data.upload`` — the
  slab, the per-step hyper-parameter rows, the step indices and the
  static scalars sent to the device.
"""

from __future__ import annotations

import functools
import itertools
import threading
import time
from typing import Any, Dict, List, Optional

import torch
from torch.autograd import profiler as _profiler

__all__ = ["CAPACITY", "Record", "span", "traced", "unit", "recording",
           "active", "records", "dropped", "clear"]

CAPACITY = 1 << 16

_clock = time.perf_counter
_forced = 0                        # open recording() blocks
_records: List["Record"] = []
_dropped = 0
_ids = itertools.count(1)
_lock = threading.Lock()
_local = threading.local()         # .top: innermost open span; .unit


def active() -> bool:
    """Is recording on: a ``torch.profiler`` session active in the
    process, or a :func:`recording` block open?"""
    return bool(_forced or _profiler._is_profiler_enabled)


class Record:
    """One span: ``id``, ``parent`` (the id of the span it opened in, or
    None), ``unit``, ``name``, ``thread``, ``start`` / ``end`` in
    ``time.perf_counter`` seconds (``end`` None while open) and
    ``attrs``."""

    __slots__ = ("id", "parent", "unit", "name", "thread", "start", "end",
                 "attrs", "_events", "_device_s")

    def __init__(self, id, parent, unit, name, thread, start, attrs):
        self.id, self.parent, self.unit = id, parent, unit
        self.name, self.thread, self.start = name, thread, start
        self.end: Optional[float] = None
        self.attrs: Dict[str, Any] = attrs
        self._events = None
        self._device_s: Optional[float] = None

    def device_s(self) -> Optional[float]:
        """Seconds between the span's two CUDA events (None for a host
        span).  Waits for the end event to complete: read it after the
        work, not inside it."""
        if self._events is not None:
            start, end = self._events
            end.synchronize()
            self._device_s = start.elapsed_time(end) / 1e3
            self._events = None
        return self._device_s


class _Off:
    """The context of a span while recording is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "device", "attrs", "rec", "up")

    def __init__(self, name, device, attrs):
        self.name, self.device, self.attrs = name, device, attrs
        self.rec: Optional[Record] = None

    def __enter__(self) -> Optional[Record]:
        global _dropped
        with _lock:
            if len(_records) >= CAPACITY:
                _dropped += 1
                return None
            up = getattr(_local, "top", None)
            rec = Record(next(_ids), None if up is None else up.id,
                         getattr(_local, "unit", None), self.name,
                         threading.get_ident(), 0.0, self.attrs)
            _records.append(rec)
        self.rec, self.up = rec, up
        _local.top = rec
        if self.device is not None and self.device.type == "cuda":
            rec._events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            rec._events[0].record(torch.cuda.current_stream(self.device))
        rec.start = _clock()
        return rec

    def __exit__(self, *exc) -> bool:
        rec = self.rec
        if rec is None:
            return False
        rec.end = _clock()
        if rec._events is not None:
            rec._events[1].record(torch.cuda.current_stream(self.device))
        _local.top = self.up
        return False


def span(name: str, device: Optional[torch.device] = None, **attrs):
    """A context manager recording one span named ``name`` with
    ``attrs``; a CUDA ``device`` makes it device-timed on that device's
    current stream (another device is ignored).  Entered, it gives its
    :class:`Record` (None while recording is off)."""
    if not (_forced or _profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, device, attrs)


def traced(name: str):
    """Decorator: each call of the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kw):
            if not (_forced or _profiler._is_profiler_enabled):
                return fn(*args, **kw)
            with _Span(name, None, {}):
                return fn(*args, **kw)
        return inner
    return wrap


class _Unit:
    __slots__ = ("key", "before")

    def __init__(self, key):
        self.key = key

    def __enter__(self):
        self.before = getattr(_local, "unit", None)
        _local.unit = self.key

    def __exit__(self, *exc) -> bool:
        _local.unit = self.before
        return False


def unit(key: str):
    """A context in which every span opened on this thread belongs to the
    work unit ``key``."""
    if not (_forced or _profiler._is_profiler_enabled):
        return _OFF
    return _Unit(key)


class recording:
    """Recording on for the block's extent, with or without a profiler
    (nests)."""

    def __enter__(self) -> "recording":
        global _forced
        _forced += 1
        return self

    def __exit__(self, *exc) -> bool:
        global _forced
        _forced -= 1
        return False


def records() -> List[Record]:
    """Every record the buffer holds, in the order the spans opened."""
    with _lock:
        return list(_records)


def dropped() -> int:
    """Spans not kept because the buffer was full."""
    return _dropped


def clear() -> None:
    """Empty the buffer and its drop count."""
    global _dropped
    with _lock:
        _records.clear()
        _dropped = 0
