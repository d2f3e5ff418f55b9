"""The readers of the port's own spans on synthetic spans and device
intervals: self time, the idle split by overlap over nested spans, the
benchmark's own work cut out, the partition's sum, and ``None`` where
there is nothing to read."""

import itertools
from types import SimpleNamespace

import pytest

from hippo_bench import port_spans, run as bench_run
from hippo_bench.trace import Spans, Trace

IDLE = {"engine.idle": "engine", "ckpt.idle": "ckpt", "data.idle": "data",
        "train.eval_idle": "eval", "train.host_idle": "train"}
NEW = sorted(IDLE) + ["engine.self_share", "train.step_device_ms"]


def rec(i, parent, name, start, end, thread=1, device_s=None, **attrs):
    return SimpleNamespace(id=i, parent=parent, name=name, start=start,
                           end=end, thread=thread, attrs=attrs,
                           device_s=lambda: device_s)


# one engine step: a resume load, a chain of two chunks, two puts and an
# evaluation; one more step with no child; times in seconds
TREE = [rec(1, None, "engine.step", 0.0, 10.0),
        rec(2, 1, "ckpt.get", 0.5, 1.0),
        rec(3, 1, "train.chain", 2.0, 7.0),
        rec(4, 3, "data.slab", 2.0, 2.25),
        rec(5, 3, "data.upload", 2.25, 3.0),
        rec(6, 3, "train.chunk", 3.0, 4.5, device_s=1.25, steps=4,
            members=1),
        rec(7, 3, "data.upload", 4.75, 5.0),
        rec(8, 3, "train.chunk", 5.0, 6.5, device_s=2.5, steps=8,
            members=2),
        rec(9, 1, "ckpt.put", 7.5, 7.75),
        rec(10, 1, "ckpt.put", 7.75, 8.0),
        rec(11, 1, "train.evaluate", 8.0, 9.0),
        rec(12, None, "engine.step", 10.5, 11.0)]
WINDOW = (-1.0, 12.0)
BUSY = [(0.2, 0.7), (1.5, 2.1), (2.2, 2.6), (2.9, 6.8), (7.6, 7.9),
        (8.5, 8.6), (10.0, 10.6)]
# the benchmark's wrappers: the chain call with its closing synchronise,
# and the evaluation with its own
WRAPPERS = [("train.init", -0.5, -0.25), ("train.chain", 1.9, 7.25),
            ("ckpt.put", 7.5, 7.6), ("train.evaluate", 8.0, 9.25)]


def innermost(records, t):
    """The deepest record holding ``t``, by brute force."""
    depth = {}
    for r in records:
        depth[r.id] = 0 if r.parent is None else depth[r.parent] + 1
    holding = [r for r in records if r.start <= t < r.end]
    return max(holding, key=lambda r: depth[r.id], default=None)


def brute(records, busy, own):
    """Idle and host seconds per layer over the elementary intervals of
    every edge: an independent reading of the partition."""
    edges = sorted(set(itertools.chain(
        WINDOW, *[(r.start, r.end) for r in records], *busy, *own)))
    idle = {k: 0.0 for k in port_spans.LAYERS + ("outside",)}
    host = dict(idle)
    for a, b in zip(edges, edges[1:]):
        if a < WINDOW[0] or b > WINDOW[1]:
            continue
        mid = (a + b) / 2
        r = innermost(records, mid)
        lay = "outside" if r is None or any(
            x <= mid < y for x, y in own) else port_spans.layer_of(r.name)
        host[lay] += b - a
        if not any(x <= mid < y for x, y in busy):
            idle[lay] += b - a
    return idle, host


def test_layers_of_the_span_names():
    assert [port_spans.layer_of(n) for n in (
        "engine.step", "ckpt.put", "ckpt.get", "data.slab", "data.upload",
        "train.evaluate", "train.chain", "train.group", "train.chunk")] == [
        "engine", "ckpt", "ckpt", "data", "data", "eval", "train", "train",
        "train"]


def test_own_work_is_the_wrappers_less_the_port_spans():
    own = port_spans.own_work(WRAPPERS, TREE)
    assert own == [(1.9, 2.0), (7.0, 7.25), (9.0, 9.25)]


@pytest.mark.parametrize("own", [[], [(1.9, 2.0), (7.0, 7.25),
                                      (9.0, 9.25)]])
def test_split_by_overlap_equals_brute_force(own):
    lay = port_spans.Layout(TREE, *WINDOW, BUSY, own)
    idle, host = brute(TREE, BUSY, own)
    for k in port_spans.LAYERS:
        assert lay.idle(k) == pytest.approx(idle[k], abs=1e-12), k
        assert lay.seconds(k) == pytest.approx(host[k], abs=1e-12), k
    assert lay.idle_outside == pytest.approx(idle["outside"], abs=1e-12)


def test_self_time_and_split_by_hand():
    lay = port_spans.Layout(TREE, *WINDOW, BUSY)
    # engine.step 10 s less its children (0.5 + 5 + 0.25 + 0.25 + 1), and
    # the second step's 0.5 s
    assert lay.seconds("engine") == pytest.approx(3.5)
    # the chain's self time: 4.5..4.75 and 6.5..7.0
    assert lay.seconds("train") == pytest.approx(0.75 + 3.0)
    # gaps 2.1..2.2 in the slab and 2.6..2.9 in the first upload; the
    # gap 6.8..7.6 split: chain 6.8..7.0, engine 7.0..7.5, put 7.5..7.6;
    # the gap 7.9..8.5: put 7.9..8.0, evaluation 8.0..8.5
    assert lay.idle("data") == pytest.approx(0.1 + 0.3)
    assert lay.idle("ckpt") == pytest.approx(0.3 + 0.1 + 0.1)
    assert lay.idle("train") == pytest.approx(0.2)
    assert lay.idle("eval") == pytest.approx(0.5 + 0.4)
    assert lay.idle("engine") == pytest.approx(0.2 + 0.5 + 0.5 + 1.0 + 0.4)
    # before the first step -1..0, after the last 11..12
    assert lay.idle_outside == pytest.approx(1.0 + 1.0)
    assert lay.idle_s == pytest.approx(0.4 + 0.5 + 0.2 + 0.9 + 2.6 + 2.0)
    by_name = lay.idle_by_name()
    assert by_name["train.chunk"] == 0.0
    assert by_name["data.slab"] + by_name["data.upload"] == pytest.approx(
        lay.idle("data"))
    assert by_name["data.upload"] == pytest.approx(0.3)


def test_partition_plus_outside_is_device_idle():
    tr = Trace(*WINDOW, Spans(sync=False), [("k", a, b) for a, b in BUSY])
    lay = port_spans.Layout(TREE, *WINDOW, tr.busy,
                            port_spans.own_work(WRAPPERS, TREE))
    window = WINDOW[1] - WINDOW[0]
    device_idle = 1 - tr.busy_s / window
    parts = sum(lay.idle(k) for k in port_spans.LAYERS) / window
    assert parts + lay.idle_outside / window == pytest.approx(
        device_idle, abs=1e-9)
    assert 0 < lay.idle_outside < lay.idle_s


def traced_run(monkeypatch, records, wrappers=WRAPPERS, steps_run=12):
    from repro_torch.utils import tracing
    monkeypatch.setattr(tracing, "records", lambda: list(records))
    spans = Spans(sync=False)
    spans.records = list(wrappers)
    return SimpleNamespace(
        trace=Trace(*WINDOW, spans, [("k", a, b) for a, b in BUSY]),
        traced=SimpleNamespace(stats=SimpleNamespace(steps_run=steps_run)))


def test_readers_on_a_traced_run(monkeypatch):
    run = traced_run(monkeypatch, TREE)
    window = WINDOW[1] - WINDOW[0]
    got = {n: bench_run.reader(n)(run) for n in NEW}
    idle, host = brute(TREE, BUSY, port_spans.own_work(WRAPPERS, TREE))
    for name, layer in IDLE.items():
        assert got[name] == pytest.approx(100 * idle[layer] / window)
    assert got["engine.self_share"] == pytest.approx(
        100 * host["engine"] / window)
    assert got["engine.self_share"] == pytest.approx(
        100 * (3.5 - 0.1 - 0.25 - 0.25) / window)
    assert got["train.step_device_ms"] == pytest.approx(1e3 * 3.75 / 12)
    device_idle = bench_run.reader("device.idle")(run)
    assert sum(got[n] for n in IDLE) + 100 * run.port_layout.idle_outside \
        / window == pytest.approx(device_idle, abs=1e-9)


@pytest.mark.parametrize("case", ["no trace", "no records",
                                  "outside the window", "astride an edge",
                                  "no device times"])
def test_readers_read_nothing_where_there_is_nothing(monkeypatch, case):
    records = {"no records": [],
               "outside the window": [rec(1, None, "engine.step", 13, 14)],
               "astride an edge": TREE + [rec(13, None, "engine.step",
                                              11.5, 12.5)],
               }.get(case, TREE)
    if case == "no device times":
        records = [rec(r.id, r.parent, r.name, r.start, r.end, **r.attrs)
                   if r.name == "train.chunk" else r for r in TREE]
    run = traced_run(monkeypatch, records)
    if case == "no trace":
        run.trace = None
    got = {n: bench_run.reader(n)(run) for n in NEW}
    if case == "no device times":
        assert got.pop("train.step_device_ms") is None
        assert all(v is not None for v in got.values())
    else:
        assert all(v is None for v in got.values()), got


def test_readers_without_the_tracer(monkeypatch):
    """The parent program has no tracer: every reader gives None."""
    import sys
    import repro_torch.utils
    run = traced_run(monkeypatch, TREE)
    monkeypatch.delattr(repro_torch.utils, "tracing")
    monkeypatch.setitem(sys.modules, "repro_torch.utils.tracing", None)
    assert all(bench_run.reader(n)(run) is None for n in NEW)


def test_spans_of_other_threads_are_left_out():
    other = rec(20, None, "engine.step", 1.0, 2.0, thread=2)
    assert port_spans.in_window(TREE + [other], *WINDOW) == TREE
