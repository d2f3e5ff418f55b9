"""Spans and the device trace of a traced round.

Spans come from wrappers that the benchmark sets on the trainer's and
the store's *instances* for the traced round only: each records its
host interval and, on the card, synchronises before it closes, so a
trainer call's span holds its device work.  The device's activity
(kernels, copies, sets) comes from ``torch.profiler``'s CUDA trace, read
from the raw kineto events.  Busy time is the union of those intervals,
so work that overlaps (the checkpoint side stream) counts once.  The two
clocks are aligned by a marker kernel launched right after a
synchronise.
"""

from __future__ import annotations

import bisect
import re
import time
from typing import Dict, List, Tuple

import torch

TRAINER = {"run_chain": "train.chain", "run_stage": "train.stage",
           "run_stages_batched": "train.group",
           "run_chains_batched": "train.group", "evaluate": "train.evaluate",
           "init_state": "train.init", "device_transfer": "train.transfer"}
STORE = {"put": "ckpt.put", "put_async": "ckpt.put", "get": "ckpt.get"}


class Spans:
    """Host spans ``(name, start, end)`` in ``time.perf_counter`` seconds."""

    def __init__(self, sync: bool):
        self.sync = sync
        self.records: List[Tuple[str, float, float]] = []
        self._wrapped: List[Tuple[object, str, object]] = []
        self._sorted: List[Tuple[str, float, float]] = []
        self._starts: List[float] = []

    def wrap(self, obj, names: Dict[str, str]) -> None:
        for method, span in names.items():
            fn = getattr(obj, method, None)
            if fn is None:
                continue

            def wrapped(*args, _fn=fn, _span=span, **kw):
                t0 = time.perf_counter()
                try:
                    return _fn(*args, **kw)
                finally:
                    if self.sync:
                        torch.cuda.synchronize()
                    self.records.append((_span, t0, time.perf_counter()))
            self._wrapped.append((obj, method, vars(obj).get(method)))
            setattr(obj, method, wrapped)

    def unwrap(self) -> None:
        for obj, method, before in reversed(self._wrapped):
            if before is None:
                delattr(obj, method)
            else:
                setattr(obj, method, before)
        self._wrapped.clear()

    def total(self, prefix: str) -> float:
        return sum(b - a for n, a, b in self.records if n.startswith(prefix))

    def at(self, t: float) -> str:
        """What the host was doing at ``t``: the span holding it, or the
        engine (the control plane's own code).  Spans do not nest."""
        if len(self._starts) != len(self.records):
            self._sorted = sorted(self.records, key=lambda r: r[1])
            self._starts = [r[1] for r in self._sorted]
        i = bisect.bisect_right(self._starts, t) - 1
        if i >= 0 and t <= self._sorted[i][2]:
            return self._sorted[i][0]
        return "engine"


def _ns(ev, what: str) -> int:
    fn = getattr(ev, what + "_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(ev, what + "_us")() * 1000)


def device_events(prof) -> List[Tuple[str, int, int]]:
    """``(name, start_ns, end_ns)`` of every device activity."""
    from torch.autograd import DeviceType
    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA:
            continue
        start = _ns(ev, "start")
        out.append((ev.name(), start, start + _ns(ev, "duration")))
    return out


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def short(name: str) -> str:
    """A kernel's name without its return type, arguments or template."""
    name = re.sub(r"^void\s+", "", name.replace("(anonymous namespace)::", ""))
    name = re.split(r"[<(]", name, 1)[0]
    return name.strip()[:96]


class Trace:
    """One traced round: the host window, spans and device intervals, all
    on the host clock in seconds."""

    def __init__(self, t0: float, t1: float, spans: Spans,
                 events: List[Tuple[str, float, float]]):
        self.t0, self.t1 = t0, t1
        self.spans = spans
        self.events = [(n, max(a, t0), min(b, t1)) for n, a, b in events
                       if b > t0 and a < t1]
        self.busy = union([(a, b) for _, a, b in self.events])

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy)

    def device_seconds(self, pattern: str) -> float:
        """Device time of the activities whose name matches ``pattern``."""
        rx = re.compile(pattern)
        return sum(b - a for n, a, b in self.events if rx.search(n))

    def top_ops(self, k: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for n, a, b in self.events:
            by[short(n)] = by.get(short(n), 0.0) + (b - a)
        return [[n, s] for n, s in sorted(by.items(), key=lambda x: -x[1])[:k]]

    def idle_by_host(self, k: int = 10) -> List[List]:
        """The device's idle time, summed by what the host was doing at
        the middle of each gap."""
        gaps, t = [], self.t0
        for a, b in self.busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.t1 > t:
            gaps.append((t, self.t1))
        by: Dict[str, float] = {}
        for a, b in gaps:
            lab = self.spans.at((a + b) / 2)
            by[lab] = by.get(lab, 0.0) + (b - a)
        return [[n, s] for n, s in sorted(by.items(), key=lambda x: -x[1])[:k]]


def traced_round(cell, store) -> Tuple[object, Trace]:
    """One round under the profiler with spans on; ``(round, trace)``."""
    from torch.profiler import ProfilerActivity, profile
    spans = Spans(sync=cell.device.type == "cuda")
    spans.wrap(cell.backend, TRAINER)
    spans.wrap(store, STORE)
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            torch.cuda._sleep(1000)
            rnd = cell.round(store=store)
            t1 = time.perf_counter()
    finally:
        spans.unwrap()
    raw = device_events(prof)
    marker = min((e for e in raw if "spin" in e[0].lower()),
                 key=lambda e: e[1], default=None)
    zero = marker[1] if marker is not None else min(e[1] for e in raw)
    events = [(n, t0 + (a - zero) / 1e9, t0 + (b - zero) / 1e9)
              for n, a, b in raw]
    return rnd, Trace(t0, t1, spans, events)
