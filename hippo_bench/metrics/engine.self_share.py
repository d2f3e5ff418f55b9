"""Self time of the port's ``engine.step`` spans in the traced round
(their time less their child spans' and the benchmark's own work) over
the window: the control plane's own host time, measured inside the
program (core/engine/engine.py, core/engine/dispatch.py)."""

from hippo_bench import port_spans


def read(run):
    lay = port_spans.layout(run)
    if lay is None:
        return None
    return 100.0 * lay.seconds("engine") / (lay.t1 - lay.t0)
