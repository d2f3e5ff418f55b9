"""``train.ssd_idle`` on synthetic spans: the device's idle time inside
the self time of the port's ``train.ssd_scan`` spans, nested in chunks
and evaluations, against a brute-force reading; part of
``train.host_idle``; None where the program records no scan span."""

import pytest

from hippo_bench import port_spans, run as bench_run
from hippo_bench.tests.test_bench_port_spans import (
    BUSY, TREE, WINDOW, WRAPPERS, brute, rec, traced_run)

# scans in both chunks of the chain and in the evaluation
SCANS = [rec(20, 6, "train.ssd_scan", 3.25, 3.5),
         rec(21, 6, "train.ssd_scan", 3.75, 4.0),
         rec(22, 8, "train.ssd_scan", 5.5, 6.0),
         rec(23, 11, "train.ssd_scan", 8.2, 8.75)]
# the device is busy through the chunks; idle in the evaluation's scan
# 8.2..8.5 and 8.6..8.75
BY_HAND = 0.3 + 0.15


def idle_in_scans(records, busy, own):
    """Idle seconds at instants whose innermost span is a scan."""
    edges = sorted({*WINDOW, *[t for r in records for t in (r.start, r.end)],
                    *[t for ab in busy for t in ab],
                    *[t for ab in own for t in ab]})
    total = 0.0
    for a, b in zip(edges, edges[1:]):
        mid = (a + b) / 2
        inner = [r for r in records if r.start <= mid < r.end]
        if not inner or any(x <= mid < y for x, y in own):
            continue
        deepest = min(inner, key=lambda r: r.end - r.start)
        if deepest.name == "train.ssd_scan" and not any(
                x <= mid < y for x, y in busy):
            total += b - a
    return total


def test_scan_spans_are_in_the_train_layer():
    assert port_spans.layer_of("train.ssd_scan") == "train"


@pytest.mark.parametrize("own", [[], WRAPPERS])
def test_ssd_idle_against_brute_force(monkeypatch, own):
    run = traced_run(monkeypatch, TREE + SCANS,
                     wrappers=own if own else [])
    window = WINDOW[1] - WINDOW[0]
    cut = port_spans.own_work(own, TREE + SCANS)
    got = bench_run.reader("train.ssd_idle")(run)
    assert got == pytest.approx(
        100 * idle_in_scans(TREE + SCANS, BUSY, cut) / window, abs=1e-12)
    assert got == pytest.approx(100 * BY_HAND / window)
    # a share of the train layer's idle, which holds the scans
    idle, _ = brute(TREE + SCANS, BUSY, cut)
    assert got <= 100 * idle["train"] / window + 1e-12
    assert bench_run.reader("train.host_idle")(run) == pytest.approx(
        100 * idle["train"] / window)


@pytest.mark.parametrize("case", ["no scan spans", "no trace", "no tracer"])
def test_ssd_idle_reads_nothing_where_there_is_nothing(monkeypatch, case):
    import sys
    import repro_torch.utils
    run = traced_run(monkeypatch, TREE if case == "no scan spans"
                     else TREE + SCANS)
    if case == "no trace":
        run.trace = None
    if case == "no tracer":
        monkeypatch.delattr(repro_torch.utils, "tracing")
        monkeypatch.setitem(sys.modules, "repro_torch.utils.tracing", None)
    assert bench_run.reader("train.ssd_idle")(run) is None

