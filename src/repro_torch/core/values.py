"""Evaluate hyper-parameter values from canonical piece descriptors.

Search-plan nodes store offset-normalized *descriptors* of functional
pieces (see ``HpFunction.piece_descriptor``), not the original functions —
that is what makes structurally identical trajectories collide into one
node.  Workers, however, need concrete per-step values to train with.
``desc_values`` reconstructs them:

* ``{"kind": "const", "value": v}``            — v at every step,
* ``{"kind": k, "fn": j, "offset": o}``        — ``from_json(j).value(local)``
  where ``local = step - node_start + o`` (the piece saw local step ``o`` at
  the node's global ``start``).
"""

from __future__ import annotations

from typing import Any, Dict, List

from repro_torch.core.hpseq import from_json

__all__ = ["desc_value_at", "desc_values", "desc_static"]


def _piece_value(piece: Dict[str, Any], node_start: int, step: int) -> float:
    if piece["kind"] == "const":
        return piece["value"]
    fn = from_json(piece["fn"])
    return fn.value(step - node_start + piece.get("offset", node_start))


def desc_value_at(desc: Dict[str, Any], node_start: int, step: int) -> Dict[str, float]:
    """Hyper-parameter values of a node's configuration at a global step."""
    return {name: _piece_value(p, node_start, step)
            for name, p in desc["hps"].items()}


def desc_values(desc: Dict[str, Any], node_start: int, start: int,
                stop: int) -> Dict[str, List[float]]:
    """Per-step value arrays on ``[start, stop)`` (one list per hp)."""
    out: Dict[str, List[float]] = {}
    for name, p in desc["hps"].items():
        if p["kind"] == "const":
            out[name] = [p["value"]] * (stop - start)
        else:
            fn = from_json(p["fn"])
            off = p.get("offset", node_start)
            out[name] = [fn.value(s - node_start + off) for s in range(start, stop)]
    return out


def desc_static(desc: Dict[str, Any]) -> Dict[str, Any]:
    return dict(desc.get("static") or {})
