"""Roofline analysis from the dry run's records (no card needed).

Three terms per (arch × shape × mesh), in seconds:

    compute    = flops            / (chips × 989 TFLOP/s bf16)
    memory     = bytes            / (chips × 3.35 TB/s HBM3)
    collective = collective_bytes / (chips × 450 GB/s NVLink)

The dry run counts flops, bytes and collective bytes *per device* (rank
0's local ops), so ``chips`` scales them to the global numerators and the
division cancels: the terms are per-device times, which is what a
roofline wants.  The collective bytes come from the functional
collectives the dry run ran (its ``collectives`` dict); the JAX package
scans compiled HLO for them (``collective_bytes_from_hlo``), which has no
counterpart here because there is no HLO.

``HW`` is one NVIDIA H100 SXM5's data-sheet figures: 989e12 bf16 dense
FLOP/s, 3.35e12 B/s of HBM3, 450e9 B/s of NVLink 4 in one direction.  The
one-link term is optimistic for the production mesh: a 16-wide axis spans
more than one 8-card NVLink node, and between nodes InfiniBand gives each
card about 50 GB/s.

Also reported: MODEL_FLOPS = 6·N·D (6·N_active·D for MoE; 2·N·D for a
forward-only pass) and the ratio MODEL_FLOPS / counted flops — how much of
the counted compute is "useful" (remat and replicated work lower it).
"""

from __future__ import annotations

from typing import Any, Dict

__all__ = ["roofline_terms", "model_flops", "HW"]

HW = {
    "peak_flops": 989e12,     # bf16 dense per card (H100 SXM5 data sheet)
    "hbm_bw": 3.35e12,        # bytes/s per card (data sheet)
    "link_bw": 450e9,         # bytes/s per card, NVLink 4, one direction
}


def roofline_terms(record: Dict[str, Any], chips: int) -> Dict[str, Any]:
    """Derive the three terms (seconds) from a dry-run record."""
    cost = record.get("cost", {})
    flops_dev = cost.get("flops", 0.0)
    bytes_dev = cost.get("bytes accessed", 0.0)
    coll = record.get("collectives", {})
    coll_dev = coll.get("total", 0.0)

    t_compute = flops_dev / HW["peak_flops"]
    t_memory = bytes_dev / HW["hbm_bw"]
    t_coll = coll_dev / HW["link_bw"]

    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    dominant = max(terms, key=terms.get)
    total = max(terms.values())

    out = dict(terms)
    out["dominant"] = dominant.replace("_s", "")
    out["hlo_flops_per_device"] = flops_dev
    out["hlo_bytes_per_device"] = bytes_dev
    out["collective_bytes_per_device"] = coll_dev
    out["hlo_flops_global"] = flops_dev * chips
    out["bound_step_s"] = total
    return out


def model_flops(record: Dict[str, Any], tokens: int, kind: str) -> float:
    """6·N·D rule (N = active params, D = tokens); forward-only passes
    (prefill/decode) use 2·N·D."""
    n = record.get("active_params") or record.get("params") or 0
    mult = 6.0 if kind == "train" else 2.0
    return mult * n * tokens
