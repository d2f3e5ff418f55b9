"""Share of the traced round in which nothing ran on the device: one
minus the union of its activities' intervals over the window."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
