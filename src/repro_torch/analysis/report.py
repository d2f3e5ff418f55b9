"""Render the dry run's tables (§Dry-run, §Roofline) from its JSONL.

    PYTHONPATH=src python -m repro_torch.analysis.report results.jsonl

The column the JAX package heads "HLO flops/dev" is "flops/dev" here: the
port's per-device flops, counted on rank 0's local ops
(:mod:`repro_torch.launch.dryrun`).  The roofline table's last column,
which the JAX package's lacks, names the ops that ran on replicated
operands (``dryrun.NO_RULE``) and how often: their gathers inflate that
row's collective term.
"""

from __future__ import annotations

import json
import sys
from typing import Any, Dict, List

from repro_torch.analysis.roofline import model_flops, roofline_terms
from repro_torch.configs import SHAPES

__all__ = ["load", "dryrun_table", "roofline_table"]


def load(path: str) -> List[Dict[str, Any]]:
    out = []
    with open(path) as f:
        for line in f:
            out.append(json.loads(line))
    # keep the latest record per (arch, shape, mesh)
    dedup: Dict = {}
    for r in out:
        dedup[(r["arch"], r["shape"], r.get("multi_pod", False))] = r
    return list(dedup.values())


def _chips(rec) -> int:
    return 512 if rec.get("multi_pod") else 256


def _tokens(rec) -> int:
    shape = SHAPES[rec["shape"]]
    if shape.kind == "decode":
        return shape.global_batch          # one new token per request
    return shape.global_batch * shape.seq_len


def _fmt(x, unit="", nd=2):
    if x is None:
        return "—"
    if x == 0:
        return "0"
    for scale, suff in ((1e12, "T"), (1e9, "G"), (1e6, "M"), (1e3, "k")):
        if abs(x) >= scale:
            return f"{x/scale:.{nd}f}{suff}{unit}"
    return f"{x:.{nd}g}{unit}"


def dryrun_table(recs: List[Dict]) -> str:
    rows = ["| arch | shape | mesh | status | lower s | compile s | "
            "flops/dev | bytes/dev | collective B/dev (AG/AR/RS/A2A/CP) |",
            "|---|---|---|---|---|---|---|---|---|"]
    for r in sorted(recs, key=lambda r: (r["shape"], r["arch"],
                                         r.get("multi_pod", False))):
        mesh = "2×16×16" if r.get("multi_pod") else "16×16"
        if r["status"] != "ok":
            rows.append(f"| {r['arch']} | {r['shape']} | {mesh} | "
                        f"{r['status']}: {r.get('reason', r.get('error',''))[:40]} "
                        f"| | | | | |")
            continue
        c = r.get("cost", {})
        col = r.get("collectives", {})
        parts = "/".join(_fmt(col.get(k, 0), nd=1) for k in (
            "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
            "collective-permute"))
        rows.append(
            f"| {r['arch']} | {r['shape']} | {mesh} | ok | {r['lower_s']} | "
            f"{r['compile_s']} | {_fmt(c.get('flops'))} | "
            f"{_fmt(c.get('bytes accessed'))} | {parts} |")
    return "\n".join(rows)


def roofline_table(recs: List[Dict], single_pod_only: bool = True) -> str:
    rows = ["| arch | shape | compute s | memory s | collective s | "
            "dominant | MODEL_FLOPS | useful/counted | bound step s | "
            "replicated ops |",
            "|---|---|---|---|---|---|---|---|---|---|"]
    for r in sorted(recs, key=lambda r: (r["shape"], r["arch"])):
        if single_pod_only and r.get("multi_pod"):
            continue
        if r["status"] != "ok":
            if r["status"] == "skipped":
                rows.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                            f"skip: {r.get('reason','')[:32]} | — | — | — | "
                            f"— |")
            continue
        chips = _chips(r)
        t = roofline_terms(r, chips)
        shape = SHAPES[r["shape"]]
        mf = model_flops(r, _tokens(r), shape.kind)
        useful = mf / max(1e-9, t["hlo_flops_global"])
        rows.append(
            f"| {r['arch']} | {r['shape']} | {t['compute_s']:.4g} | "
            f"{t['memory_s']:.4g} | {t['collective_s']:.4g} | "
            f"**{t['dominant']}** | {_fmt(mf)} | {useful:.2f} | "
            f"{t['bound_step_s']:.4g} | {_replicated(r)} |")
    return "\n".join(rows)


def _replicated(rec) -> str:
    """``view 64, argmax 1``: the ops a case ran replicated, or "0"."""
    ops = rec.get("replicated", {})
    return ", ".join(f"{k.removeprefix('aten.')} {n}"
                     for k, n in ops.items()) or "0"


def main():
    path = sys.argv[1] if len(sys.argv) > 1 else \
        "results/dryrun_singlepod.jsonl"
    recs = load(path)
    print("## §Dry-run\n")
    print(dryrun_table(recs))
    print("\n## §Roofline (single-pod 16×16, per-device terms)\n")
    print(roofline_table(recs))


if __name__ == "__main__":
    main()
