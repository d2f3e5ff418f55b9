"""Share of the traced round in which the device was idle while the host
drew a data slab or uploaded it, the hp rows, the step indices or the
static scalars (``data.slab``, ``data.upload``: data/pipeline.py,
train/torch_trainer.py): the idle time split over the port's innermost
spans by overlap (hippo_bench/port_spans.py)."""

from hippo_bench import port_spans


def read(run):
    lay = port_spans.layout(run)
    if lay is None:
        return None
    return 100.0 * lay.idle("data") / (lay.t1 - lay.t0)
