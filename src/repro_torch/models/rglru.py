"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).

The counterpart of ``repro/models/rglru.py``: the same parameter tree
(``w_in``, ``w_gate`` (D, W), ``w_out`` (W, D), ``conv_w`` (K, W) in the
model's dtype; ``lam`` and ``g_r`` (W,) f32), the same gates and the same
dtype rules.  The real-gated linear recurrent unit::

    r_t = σ(g_r ⊙ u_t)                       (recurrence gate, per channel)
    a_t = exp(c · r_t · log σ(Λ))            (gated per-channel decay, c=8)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 − a_t²) ⊙ u_t

inside the Griffin block: input and gate branches, a depthwise temporal
conv of K taps on the recurrent branch (K shifted products, as in the
reference), GeLU gating (tanh approximation, ``jax.nn.gelu``'s default)
and an output projection.

The reference runs the recurrence as ``jax.lax.associative_scan``, which
has no Pallas kernel; nor has the port.  :func:`linear_scan` is plain
PyTorch and log-depth, not a loop over the sequence: Hillis–Steele over
``(a, b)`` pairs, ⌈log₂ S⌉ levels of one shifted multiply-add each on
``(B, S, W)`` f32 tensors, the same order on every call (so a step is
bit-reproducible), summed in another order than JAX's tree (the tests
state a tolerance).

Decode (:func:`init_rglru_cache`, :func:`rglru_decode`) is the reference's
O(1) update of ``h`` (f32) and of the conv's left context, both written
into the cache it was given (``copy_``): ``LM.decode_step`` holds views of
stacked buffers.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init

__all__ = ["init_rglru", "rglru_forward", "rglru_decode", "init_rglru_cache",
           "linear_scan"]

_C = 8.0  # Griffin's fixed gate sharpness


def init_rglru(cfg: ModelConfig, gen: torch.Generator,
               dtype: torch.dtype) -> Dict[str, Any]:
    D = cfg.d_model
    W = cfg.rglru_width or D
    # Λ so that σ(Λ) ∈ (0.9, 0.999): long memories (Griffin §2.4)
    u = 0.9 + 0.099 * torch.rand((W,), generator=gen)
    conv = torch.randn((cfg.ssm_conv, W), generator=gen) * cfg.ssm_conv ** -0.5
    return {
        "w_in": dense_init(gen, (D, W), dtype=dtype),
        "w_gate": dense_init(gen, (D, W), dtype=dtype),
        "w_out": dense_init(gen, (W, D), dtype=dtype),
        "conv_w": conv.to(dtype),
        "lam": torch.log(u / (1 - u)),
        "g_r": torch.ones((W,), dtype=torch.float32),
    }


def _gates(params, u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-step decay ``a_t`` and input scale from the branch activations
    (f32)."""
    r = torch.sigmoid(u.float() * params["g_r"])
    log_a = _C * r * F.logsigmoid(params["lam"])           # (B,S,W) ≤ 0
    a = torch.exp(log_a)
    scale = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, scale


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``h_t = a_t h_{t-1} + b_t`` along dim 1 (h_{-1} = 0), log-depth:
    after the level of shift ``d`` each position holds the composition of
    the ``2d`` steps ending there, ``(a, b) ∘ (a', b') = (a a', a b' +
    b)`` with the earlier pair on the right."""
    S = a.shape[1]
    d = 1
    while d < S:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        if 2 * d < S:              # the last level needs no decays
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def _conv(x: torch.Tensor, w: torch.Tensor,
          state: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Depthwise causal conv over dim 1: ``y_t = Σ_i w_i x_{t-K+1+i}``, the
    K − 1 steps before the first from ``state`` (zeros without one).
    Returns (y, the last K − 1 steps as the next state)."""
    K, S = w.shape[0], x.shape[1]
    pad = (torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                       device=x.device)
           if state is None else state.to(x.dtype))
    xp = torch.cat([pad, x], dim=1)
    y = xp[:, 0:S] * w[0]
    for i in range(1, K):
        y = y + xp[:, i:i + S] * w[i]
    return y, (xp[:, -(K - 1):] if K > 1 else None)


def rglru_forward(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """x: (B,S,D) → (B,S,D)."""
    u = x @ params["w_in"]
    u, _ = _conv(u, params["conv_w"])
    a, scale = _gates(params, u)
    h = linear_scan(a, scale * u.float()).to(x.dtype)
    gate = F.gelu(x @ params["w_gate"], approximate="tanh")
    return (h * gate) @ params["w_out"]


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def init_rglru_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device=None) -> Dict[str, torch.Tensor]:
    W = cfg.rglru_width or cfg.d_model
    return {"h": torch.zeros((batch, W), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv - 1, W), dtype=dtype,
                                device=device)}


def rglru_decode(params, cfg: ModelConfig, x: torch.Tensor, cache
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode: x (B,1,D) → (B,1,D); O(1) update of ``h`` and of
    the conv state, written into ``cache`` in place.  Returns (out,
    ``cache``)."""
    u = x @ params["w_in"]
    u, conv_state = _conv(u, params["conv_w"], cache["conv"])
    a, scale = _gates(params, u)                             # (B,1,W)
    h = a[:, 0] * cache["h"] + (scale * u.float())[:, 0]
    gate = F.gelu(x @ params["w_gate"], approximate="tanh")
    out = (h[:, None].to(x.dtype) * gate) @ params["w_out"]
    cache["h"].copy_(h)
    cache["conv"].copy_(conv_state)
    return out, cache
