"""Feed-forward blocks: SwiGLU / GeLU MLP and Mixture-of-Experts
(``repro/models/ffn.py``).

The MoE layer covers both MoE architectures of the registry: grok-1-314b
(8 routed experts, top-2, no shared experts) and qwen2-moe-a2.7b (60 routed
experts of d_ff 1408, top-4, plus 4 shared experts as one always-on SwiGLU
of hidden ``shared_d_ff``).  The reference's capacity-based formulation,
step for step: tokens split into groups of :data:`_GROUP_TOKENS`, per-group
expert capacity ``int(max(K, cf·Tg·K/E))``, dispatch and combine one-hots,
overflow dropped, and the load-balancing loss ``E·Σ f_e·p_e`` returned
beside the output.  The one-hots are comparisons with an ``arange``, not
``F.one_hot``, which checks its input's range with a host read: that
fails under ``torch.func.vmap`` (the vectorised group tier) and would
sync the card at every call.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init

__all__ = ["init_mlp", "mlp_forward", "init_moe", "moe_forward"]


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


def init_moe(cfg: ModelConfig, gen: torch.Generator,
             dtype: torch.dtype) -> Dict[str, Any]:
    """``router (D,E)`` in f32; ``wi`` / ``wg (E,D,F)`` and ``wo (E,F,D)``
    in the model dtype, scaled as the reference scales them (``dense_init``
    takes a 3-D shape's first dimension, ``E``, as its fan-in); ``shared``
    a SwiGLU of hidden ``shared_d_ff``."""
    E, D, Fd = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    p = {"router": dense_init(gen, (D, E), scale=D ** -0.5,
                              dtype=torch.float32),
         "wi": dense_init(gen, (E, D, Fd), dtype=dtype),
         "wg": dense_init(gen, (E, D, Fd), dtype=dtype),
         "wo": dense_init(gen, (E, Fd, D), dtype=dtype)}
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(D, cfg.shared_d_ff, gen, dtype)
    return p


_GROUP_TOKENS = 4096  # dispatch-group size (MaxText-style token groups)


def _one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """``(..., n)`` one-hot of ``idx``; an index outside ``[0, n)`` gives a
    row of zeros, as ``jax.nn.one_hot`` does."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def moe_forward(params, cfg: ModelConfig, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) → (out (B, S, D), aux loss (f32 scalar)).

    Token-grouped top-k routing: ``G = T // 4096`` groups when 4096
    divides ``T = B·S``, else one; each group has its own capacity
    ``C = int(max(K, cf·Tg·K/E))`` and (G, Tg, E, C) dispatch one-hots.
    A token's k-th choice past its expert's capacity is dropped."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    G = T // _GROUP_TOKENS if T % _GROUP_TOKENS == 0 else 1
    Tg = T // G
    xt = x.reshape(G, Tg, D)

    logits = xt.float() @ params["router"]                          # (G,Tg,E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, K, dim=-1)            # (G,Tg,K)
    gate_vals = gate_vals / torch.sum(gate_vals, -1, keepdim=True)

    # ---- aux load-balance loss: E * sum_e f_e * p_e (global means)
    me = torch.mean(probs, dim=(0, 1))                              # (E,)
    ce = torch.mean(_one_hot(expert_idx[..., 0], E, torch.float32),
                    dim=(0, 1))
    aux = E * torch.sum(me * ce)

    capacity = int(max(K, cfg.capacity_factor * Tg * K / E))
    # position of each (token, k) within its expert's per-group buffer
    flat = _one_hot(expert_idx, E, torch.int32).reshape(G, Tg * K, E)
    pos_in_expert = torch.cumsum(flat, dim=1) * flat - 1
    pos = pos_in_expert.reshape(G, Tg, K, E).amax(-1)               # (G,Tg,K)
    keep = pos < capacity

    # dispatch / combine one-hots; overflow maps to the out-of-range slot
    # ``capacity``, whose one-hot is all zeros
    e_onehot = _one_hot(expert_idx, E, xt.dtype)                    # (G,Tg,K,E)
    c_onehot = _one_hot(torch.where(keep, pos, capacity), capacity,
                        xt.dtype)                                   # (G,Tg,K,C)
    disp = torch.einsum("gtke,gtkc->gtec", e_onehot, c_onehot)      # (G,Tg,E,C)
    buf = torch.einsum("gtd,gtec->gecd", xt, disp)                  # (G,E,C,D)

    h = F.silu(torch.einsum("gecd,edf->gecf", buf, params["wg"]))
    h = h * torch.einsum("gecd,edf->gecf", buf, params["wi"])
    out_buf = torch.einsum("gecf,efd->gecd", h, params["wo"])       # (G,E,C,D)

    comb = torch.einsum("gtke,gtkc,gtk->gtec", e_onehot, c_onehot,
                        (gate_vals * keep).to(xt.dtype))            # (G,Tg,E,C)
    out = torch.einsum("gecd,gtec->gtd", out_buf, comb)

    if cfg.n_shared_experts:
        out = out + mlp_forward(params["shared"], xt)
    return out.reshape(B, S, D), aux.float()
