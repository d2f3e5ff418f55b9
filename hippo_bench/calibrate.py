"""Readings that the limits of ``correct`` are set from, many seeds in
one process (set-up is long next to a round):

    python3 -m hippo_bench.calibrate --workload qwen2-0.5b-f32.high_merge \
        --seeds 11,12,13 --control 11,12,13 --faults unchanged,answer

For each seed: the cell's inputs drawn from it, one round of its
traffic on the port (with a fault planted, for each fault asked), then
the numbers ``hippo_bench.check`` compares — the port against the
reference, and for the seeds in ``--control`` the control (the
reference with float8 products) against the reference.  One JSON line
per reading on standard output.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from hippo_bench import run as harness


def leaf_detail(cell, rnd):
    """Per leaf, for the first sampled prefix: both gaps and the
    reference's norms, to see which leaf a worst-leaf number reads."""
    from hippo_bench import check
    from hippo_bench.reference import lm as ref
    s, picks = check.sample([rnd], cell.mix, cell.seed)
    picks = {i: [cell.mix["tuner"]["min_steps"]] for i in list(picks)[:1]}
    _, want = check.reference_run(ref.ReferenceLM(cell.cfg), cell, s, picks)
    names = ["/".join(map(str, p)) for p in cell.params_ref]
    out = {}
    for k, w in want.items():
        got = rnd.rung_states.get(k)
        if got is None:
            continue
        for name in ("update", "grad_rms"):
            g = check.leaf_gaps(got[name].to(w[name].device), w[name])
            out[name] = {n: [float(a), float(b)] for n, a, b in
                         zip(names, g, w[name])}
    return out


def reading(workload, seed, fault=None, control=False, device="cuda",
            cfg=None):
    import torch
    from hippo_bench import cells, check, faults
    from hippo_bench.reference import lm as ref
    t0 = time.perf_counter()
    cell = cells.Cell(workload, seed, device=device, cfg=cfg)
    if fault:
        faults.plant(cell, fault)
    rnd = cell.round()
    cell.params_ref = {p: v.float() for p, v in ref.flat(cell.params).items()}
    cell.release()
    gc.collect()
    if cell.device.type == "cuda":
        torch.cuda.empty_cache()
    out = check.run_check(cell, [rnd], control=control)
    out["leaves"] = leaf_detail(cell, rnd)
    out.update(workload=workload, seed=seed, fault=fault,
               round_s=rnd.seconds, seconds=time.perf_counter() - t0,
               steps_run=rnd.stats.steps_run,
               groups=rnd.stats.batched_groups)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", default="")
    ap.add_argument("--faults", default="")
    args = ap.parse_args(argv)
    harness.use_checkout()
    ints = lambda s: [int(x) for x in s.split(",") if x]
    control = set(ints(args.control))
    for seed in ints(args.seeds):
        for fault in [None] + [f for f in args.faults.split(",") if f]:
            out = reading(args.workload, seed, fault,
                          control=fault is None and seed in control)
            print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
