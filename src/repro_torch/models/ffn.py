"""Feed-forward blocks: SwiGLU / GeLU MLP (``repro/models/ffn.py:35-51``).

The Mixture-of-Experts layer is not ported yet: :func:`init_moe` and
:func:`moe_forward` raise ``NotImplementedError`` naming its slice.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init

__all__ = ["init_mlp", "mlp_forward", "init_moe", "moe_forward"]

MOE_SLICE = "ROADMAP queue A, slice 11"


def init_mlp(d_model: int, d_ff: int, gen: torch.Generator,
             dtype: torch.dtype, gated: bool = True) -> Dict[str, Any]:
    p = {"wi": dense_init(gen, (d_model, d_ff), dtype=dtype),      # up
         "wo": dense_init(gen, (d_ff, d_model), dtype=dtype)}
    if gated:
        p["wg"] = dense_init(gen, (d_model, d_ff), dtype=dtype)   # gate
    return p


def mlp_forward(params, x: torch.Tensor) -> torch.Tensor:
    if "wg" in params:
        return (F.silu(x @ params["wg"]) * (x @ params["wi"])) @ params["wo"]
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x @ params["wi"], approximate="tanh") @ params["wo"]


def init_moe(*args, **kw):
    raise NotImplementedError(f"Mixture-of-Experts is not in repro_torch "
                              f"yet ({MOE_SLICE})")


def moe_forward(*args, **kw):
    raise NotImplementedError(f"Mixture-of-Experts is not in repro_torch "
                              f"yet ({MOE_SLICE})")
