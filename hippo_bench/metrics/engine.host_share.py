"""Share of the traced round spent outside the trainer's calls: the
control plane's own time (the spans are the trainer's methods the
dispatcher calls, each closed by a device synchronise)."""


def read(run):
    if run.trace is None:
        return None
    inside = run.trace.spans.total("train.")
    return 100.0 * (1.0 - inside / run.trace.window_s)
