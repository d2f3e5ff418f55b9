"""The port's own spans (``repro_torch.utils.tracing``) laid over a traced
round's device trace, for the readers of the in-program metrics.

The port records its spans while a profiler is active, so the traced
round's are in the tracer's buffer when the readers run; a program
without the tracer gives ``None`` to every reader here.  Each instant of
the window belongs to the innermost port span open then (on the thread of
the engine's loop), and that span's name gives its layer:

* ``engine`` — ``engine.step``'s self time: the control plane;
* ``ckpt`` — ``ckpt.put`` / ``ckpt.get``;
* ``data`` — ``data.slab`` / ``data.upload``;
* ``eval`` — ``train.evaluate``;
* ``train`` — the self time of ``train.chain`` / ``train.group`` /
  ``train.chunk``: issuing kernels, boundary snapshots.

The benchmark's own work inside its wrappers of the trainer's calls
(:mod:`hippo_bench.trace`: the closing synchronise, the rung recorder's
norms) lies outside the port's spans of that call and is not the
engine's: it is cut out of every layer, and its instants count as
outside the port, like those of no span at all.  The device's idle time
(the window less the union of its activities) is then split across the
layers by overlap, and what no layer holds is the idle outside the port:
the layers' idle plus that remainder is ``device.idle``'s time.
"""

from __future__ import annotations

import bisect
import sys
from typing import Dict, List, Optional, Sequence, Tuple

LAYERS = ("engine", "ckpt", "data", "eval", "train")
WRAPPED = ("train.chain", "train.stage", "train.group", "train.evaluate")

Interval = Tuple[float, float]


def layer_of(name: str) -> Optional[str]:
    """The layer of a port span's name (None for a name of no layer)."""
    if name == "train.evaluate":
        return "eval"
    head = name.split(".", 1)[0]
    return head if head in LAYERS else None


def in_window(records: Sequence, t0: float, t1: float) -> Optional[List]:
    """The closed records inside ``[t0, t1]`` on the thread of the first
    of them, or None: none there, or one astride an edge of the window
    (the clocks would then disagree)."""
    inside = []
    for r in records:
        if r.end is None or r.end <= t0 or r.start >= t1:
            continue
        if r.start < t0 or r.end > t1:
            return None
        inside.append(r)
    if not inside:
        return None
    thread = inside[0].thread
    return [r for r in inside if r.thread == thread]


def subtract(spans: Sequence[Interval], cut: Sequence[Interval]
             ) -> List[Interval]:
    """``spans`` less ``cut`` (both sorted, each disjoint)."""
    out, starts = [], [a for a, _ in cut]
    for a, b in spans:
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while a < b and i < len(cut):
            ca, cb = cut[i]
            if ca >= b:
                break
            if cb > a:
                if ca > a:
                    out.append((a, ca))
                a = max(a, cb)
            i += 1
        if a < b:
            out.append((a, b))
    return out


def union(intervals: Sequence[Interval]) -> List[Interval]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


class Layout:
    """Port spans over one traced round: the self-time segments of each
    span name and the device's idle time inside them, by layer.

    ``records``: the port's records in the window (``id``, ``parent``,
    ``name``, ``start``, ``end``); ``busy``: the device's busy intervals,
    sorted and disjoint; ``own``: the benchmark's own intervals, cut out
    of every layer."""

    def __init__(self, records: Sequence, t0: float, t1: float,
                 busy: Sequence[Interval], own: Sequence[Interval] = ()):
        self.records, self.t0, self.t1 = list(records), t0, t1
        ids = {r.id for r in self.records}
        kids: Dict[object, List] = {}
        for r in self.records:
            kids.setdefault(r.parent if r.parent in ids else None,
                            []).append(r)
        own = union(own)
        self.segments: Dict[str, List[Interval]] = {}
        for r in self.records:
            if layer_of(r.name) is None:
                continue
            t, selfs = r.start, []
            for c in sorted(kids.get(r.id, []), key=lambda c: c.start):
                if c.start > t:
                    selfs.append((t, c.start))
                t = max(t, c.end)
            if r.end > t:
                selfs.append((t, r.end))
            self.segments.setdefault(r.name, []).extend(
                subtract(selfs, own))
        gaps, t = [], t0
        for a, b in busy:
            if a > t:
                gaps.append((t, min(a, t1)))
            t = max(t, b)
            if t >= t1:
                break
        if t1 > t:
            gaps.append((t, t1))
        self._gap_starts = [a for a, _ in gaps]
        self._gaps = gaps
        self._before = [0.0]
        for a, b in gaps:
            self._before.append(self._before[-1] + (b - a))
        self.idle_s = self._before[-1]

    def _idle_upto(self, t: float) -> float:
        """Idle seconds of the window before ``t``."""
        i = bisect.bisect_right(self._gap_starts, t) - 1
        if i < 0:
            return 0.0
        a, b = self._gaps[i]
        return self._before[i] + min(t, b) - a

    def _of(self, layer: str) -> List[Interval]:
        return [seg for name, segs in self.segments.items()
                if layer_of(name) == layer for seg in segs]

    def seconds(self, layer: str) -> float:
        """Host seconds of the layer's self time."""
        return sum(b - a for a, b in self._of(layer))

    def _idle_in(self, segs: Sequence[Interval]) -> float:
        return sum(self._idle_upto(b) - self._idle_upto(a) for a, b in segs)

    def idle(self, layer: str) -> float:
        """Seconds of the device's idle time inside the layer's self
        time."""
        return self._idle_in(self._of(layer))

    def idle_by_name(self) -> Dict[str, float]:
        """The same, inside the self time of each span name."""
        return {n: self._idle_in(segs) for n, segs in self.segments.items()}

    @property
    def idle_outside(self) -> float:
        """Idle seconds in no layer: outside the port's spans, or in the
        benchmark's own work."""
        return self.idle_s - sum(self.idle(k) for k in LAYERS)


def own_work(wrappers: Sequence[Tuple[str, float, float]],
             records: Sequence) -> List[Interval]:
    """The benchmark's own intervals: its wrappers of the trainer's calls
    (``(name, start, end)``) less the port's spans inside each."""
    starts = sorted((r.start, r.end) for r in records
                    if r.name.startswith("train."))
    keys = [a for a, _ in starts]
    out: List[Interval] = []
    for name, a, b in wrappers:
        if name not in WRAPPED:
            continue
        i = bisect.bisect_left(keys, a)
        inner = []
        while i < len(starts) and starts[i][0] < b:
            if starts[i][1] <= b:
                inner.append(starts[i])
            i += 1
        out += subtract([(a, b)], union(inner))
    return out


def layout(run) -> Optional[Layout]:
    """The traced round's :class:`Layout` (kept on ``run``), or None: no
    trace, no tracer in the program, or no port span in the window."""
    if run.trace is None:
        return None
    if not hasattr(run, "port_layout"):
        run.port_layout = None
        records = port_records(run)
        if records is not None:
            tr = run.trace
            run.port_layout = Layout(records, tr.t0, tr.t1, tr.busy,
                                     own_work(tr.spans.records, records))
            report(run, run.port_layout)
    return run.port_layout


def port_records(run) -> Optional[List]:
    """The port's records inside the traced round, or None."""
    if run.trace is None:
        return None
    try:
        from repro_torch.utils import tracing
    except ImportError:
        return None
    return in_window(tracing.records(), run.trace.t0, run.trace.t1)


def report(run, lay: Layout) -> None:
    """One line on standard error: the partition beside ``device.idle``,
    and the chunks' member-steps beside the round's ``steps_run``."""
    window = lay.t1 - lay.t0
    parts = ", ".join(f"{k} {100 * lay.idle(k) / window:.4f}"
                      for k in LAYERS)
    names = ", ".join(f"{n} {100 * s / window:.4f}"
                      for n, s in sorted(lay.idle_by_name().items()))
    steps = sum(r.attrs.get("steps", 0) for r in lay.records
                if r.name == "train.chunk")
    print(f"port spans: {len(lay.records)} records; idle % of the window "
          f"by layer: {parts}, outside {100 * lay.idle_outside / window:.4f}"
          f" ({names}); sum {100 * lay.idle_s / window:.4f}, device.idle "
          f"{100 * (1 - run.trace.busy_s / window):.4f}; chunk member-steps "
          f"{steps}, steps_run {run.traced.stats.steps_run}",
          file=sys.stderr, flush=True)
