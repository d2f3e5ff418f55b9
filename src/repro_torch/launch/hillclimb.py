"""Perf hill-climbing driver: run a dry-run case again under variant
sharding / config rules and compare its roofline terms with the baseline.

    python -m repro_torch.launch.hillclimb --arch grok-1-314b \
        --shape train_4k --variant no-fsdp seqpar --out hillclimb.jsonl

The variants are the JAX package's, by name and override; each runs
through the port's :func:`repro_torch.launch.dryrun.run_case`: ``seqpar``
through the DTensor case of
:func:`repro_torch.dist.sharding.seq_constrainer` (the residual stream
sharded on the sequence over ``model`` after every cycle block),
``no-remat`` through the model's ``remat`` (each cycle under
``torch.utils.checkpoint`` or not), ``cap-1.0`` and ``f32`` through the
config.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

from repro_torch.analysis.roofline import roofline_terms
from repro_torch.dist.sharding import ShardingRules
from repro_torch.launch.dryrun import run_case

__all__ = ["VARIANTS", "run_variant", "main"]

# name → (rules overrides, cfg overrides)
VARIANTS = {
    "baseline": ({}, {}),
    # drop FSDP: weights replicated over `data` — no per-layer all-gather,
    # at the cost of per-device weight memory
    "no-fsdp": ({"fsdp": None}, {}),
    # sequence parallelism: residual stream sharded over `model` between
    # blocks — activation memory / HBM traffic ÷16
    "seqpar": ({"seq": "model"}, {}),
    # pure data parallel (tp off): no tensor collectives, replicated weights
    "dp-only": ({"tp": None, "fsdp": None}, {}),
    # no activation checkpointing: recompute off → compute term down,
    # activation memory up
    "no-remat": ({}, {"remat": False}),
    # MoE: tighter capacity → smaller dispatch buffers / all-to-all
    "cap-1.0": ({}, {"capacity_factor": 1.0}),
    # bf16 → f32 master activations comparison
    "f32": ({}, {"dtype": "float32"}),
}


def run_variant(arch, shape, variant, multi_pod=False):
    r_over, c_over = VARIANTS[variant]
    rules = dataclasses.replace(ShardingRules.for_mesh(multi_pod), **r_over)
    rec = run_case(arch, shape, multi_pod=multi_pod, rules=rules,
                   cfg_overrides=c_over or None, tag=variant, verbose=True)
    if rec["status"] == "ok":
        rec["roofline"] = roofline_terms(rec, 512 if multi_pod else 256)
    rec["variant"] = variant
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", nargs="+", default=["baseline"],
                    choices=sorted(VARIANTS))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="results/hillclimb.jsonl")
    args = ap.parse_args(argv)

    for v in args.variant:
        rec = run_variant(args.arch, args.shape, v, args.multi_pod)
        t = rec.get("roofline", {})
        print(f"{args.arch} × {args.shape} [{v}]: "
              f"compute {t.get('compute_s', float('nan')):.4g}s  "
              f"memory {t.get('memory_s', float('nan')):.4g}s  "
              f"collective {t.get('collective_s', float('nan')):.4g}s  "
              f"dominant={t.get('dominant')}")
        if os.path.dirname(args.out):
            os.makedirs(os.path.dirname(args.out), exist_ok=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    main()
