"""B1's least time over its device time in the traced round
(kernels/optim.py, csrc/optim.cu): one AdamW update of the whole tree
per step, bytes-bound."""


def read(run):
    t = run.trace
    if t is None:
        return None
    spent = t.device_seconds(r"tree_update")
    if not spent:
        return None
    per = run.flops.update_bytes(run.update_leaves, "adamw")
    return 100.0 * run.traced.stats.steps_run * run.flops.bound_s(0, per) / spent
