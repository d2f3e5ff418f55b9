"""Share of the traced round in which the device was idle while the host
did the trainer's own work: issuing a chunk's kernels, boundary
snapshots (the self time of ``train.chain``, ``train.group`` and
``train.chunk``: train/torch_trainer.py): the idle time split over the
port's innermost spans by overlap (hippo_bench/port_spans.py)."""

from hippo_bench import port_spans


def read(run):
    lay = port_spans.layout(run)
    if lay is None:
        return None
    return 100.0 * lay.idle("train") / (lay.t1 - lay.t0)
