"""Share of the traced round in which the device was idle while the host
put or got a checkpoint (``ckpt.put``, ``ckpt.get``: core/engine/dispatch.py,
train/checkpoint.py): the idle time split over the port's innermost
spans by overlap (hippo_bench/port_spans.py)."""

from hippo_bench import port_spans


def read(run):
    lay = port_spans.layout(run)
    if lay is None:
        return None
    return 100.0 * lay.idle("ckpt") / (lay.t1 - lay.t0)
