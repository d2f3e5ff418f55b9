"""All time inside the trainer's chain and group calls of the traced
round over all the steps it ran (data plane: train/torch_trainer.py,
models/, data/)."""


def read(run):
    if run.trace is None or not run.traced.stats.steps_run:
        return None
    spans = run.trace.spans
    inside = sum(spans.total(p) for p in ("train.chain", "train.stage",
                                          "train.group"))
    return 1e3 * inside / run.traced.stats.steps_run
