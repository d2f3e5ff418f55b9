"""CUDA-event time of the port's ``train.chunk`` spans in the traced
round over their member-steps (data plane: train/torch_trainer.py): a
step's time on the device's stream, with no synchronise in the round."""

from hippo_bench import port_spans


def read(run):
    records = port_spans.port_records(run)
    if records is None:
        return None
    chunks = [r for r in records if r.name == "train.chunk"]
    steps = sum(r.attrs.get("steps", 0) for r in chunks)
    times = [r.device_s() for r in chunks]
    if not steps or None in times:
        return None
    return 1e3 * sum(times) / steps
