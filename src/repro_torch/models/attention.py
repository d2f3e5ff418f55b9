"""Grouped-query attention with RoPE / M-RoPE, qk-norm, QKV bias, windowing.

The training / prefill half of ``repro/models/attention.py``: the same
parameter tree (projection weights with an explicit head axis,
``wq (D,H,hd)``, ``wo (H,hd,D)``), the same masks and the same dtype rules.
The projections are one matrix product each over the flattened head axis,
so ``q``, ``k`` and ``v`` come out contiguous in ``(B,S,H,hd)`` — the layout
the attention kernels read in place — and the weight gradients come back
contiguous.

``use_kernel=True`` routes attention through
:func:`repro_torch.kernels.ops.flash_attention` (kernels B2, B3 and B4);
the plain path :func:`_sdpa` is the reference.

Decode (:func:`init_kv_cache`, :func:`attention_decode`) keeps the
reference's ring buffer of ``window`` slots (sliding window) or
``max_len`` and its ``(B, L, n_kv, hd)`` layout, and writes the new key
and value in place (``index_copy_`` at slot ``index % L``): ``index`` may
be a 0-d device tensor, so a step reads nothing back to the host.  The
reference's einsum softmax has no Pallas kernel; nor has the port's.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import attention_mask
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (apply_rope, dense_init, init_rms,
                                       mrope_angles, rms_norm, rope_angles)

__all__ = ["init_attention", "attention_forward", "attention_decode",
           "init_kv_cache", "make_mask"]


def init_attention(cfg: ModelConfig, gen: torch.Generator,
                   dtype: torch.dtype) -> Dict[str, Any]:
    hd = cfg.resolved_head_dim
    D, H, Hkv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    p = {
        "wq": dense_init(gen, (D, H * hd), dtype=dtype).reshape(D, H, hd),
        "wk": dense_init(gen, (D, Hkv * hd), dtype=dtype).reshape(D, Hkv, hd),
        "wv": dense_init(gen, (D, Hkv * hd), dtype=dtype).reshape(D, Hkv, hd),
        "wo": dense_init(gen, (H * hd, D), dtype=dtype).reshape(H, hd, D),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H, hd), dtype=dtype)
        p["bk"] = torch.zeros((Hkv, hd), dtype=dtype)
        p["bv"] = torch.zeros((Hkv, hd), dtype=dtype)
    if cfg.qk_norm:
        p["q_norm"] = init_rms(hd, dtype)
        p["k_norm"] = init_rms(hd, dtype)
    return p


def _head_proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B,S,D) · w (D,H,hd) → (B,S,H,hd), contiguous."""
    D, H, hd = w.shape
    return (x @ w.reshape(D, H * hd)).view(*x.shape[:-1], H, hd)


def _project_qkv(params, cfg: ModelConfig, x):
    """x (B,S,D) → q (B,S,Hq,hd), k/v (B,S,Hkv,hd), head axis explicit."""
    q = _head_proj(x, params["wq"])
    k = _head_proj(x, params["wk"])
    v = _head_proj(x, params["wv"])
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    return q, k, v


def make_mask(q_len: int, kv_len: int, *, causal: bool, window: int = 0,
              device=None) -> Optional[torch.Tensor]:
    """Boolean (q_len, kv_len) mask, True = attend, or None when nothing is
    masked.  ``window > 0`` keeps only keys within ``window`` positions
    behind the query."""
    if not causal and window <= 0:
        return None
    return attention_mask(q_len, kv_len, causal, window, device)


def _qk_rope(cfg: ModelConfig, q, k, positions):
    hd = cfg.resolved_head_dim
    if cfg.mrope_sections:
        cos, sin = mrope_angles(positions, hd, cfg.mrope_sections,
                                cfg.rope_theta)
    else:
        cos, sin = rope_angles(positions, hd, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin)


def _sdpa(q, k, v, mask, n_kv: int):
    """(B,S,Hq,hd) x (B,T,Hkv,hd) grouped attention, f32 softmax: scores
    in the input dtype, then f32; probabilities cast to v's dtype."""
    B, S, Hq, hd = q.shape
    group = Hq // n_kv
    q = q.reshape(B, S, n_kv, group, hd)
    scores = torch.einsum("bsngh,btnh->bngst", q, k).float()
    scores = scores * hd ** -0.5
    if mask is not None:
        scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bngst,btnh->bsngh", probs, v)
    return out.reshape(B, S, Hq, hd)


def attention_forward(params, cfg: ModelConfig, x: torch.Tensor,
                      positions: torch.Tensor, *, window: int = 0,
                      use_kernel: bool = False) -> torch.Tensor:
    """Full-sequence attention (training / prefill).

    x: (B, S, D); positions: (B, S) or (3, B, S) for M-RoPE.
    ``window``: 0 = per-config full/causal; >0 overrides with that window.
    """
    B, S, D = x.shape
    q, k, v = _project_qkv(params, cfg, x)
    q, k = _qk_rope(cfg, q, k, positions)
    if use_kernel:
        out = kops.flash_attention(q, k, v, causal=cfg.causal, window=window)
    else:
        mask = make_mask(S, S, causal=cfg.causal, window=window,
                         device=x.device)
        out = _sdpa(q, k, v, mask, cfg.num_kv_heads)
    H, hd, _ = params["wo"].shape
    return out.reshape(B, S, H * hd) @ params["wo"].reshape(H * hd, D)


# ---------------------------------------------------------------------------
# decode (one new token against a KV cache)
# ---------------------------------------------------------------------------


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, window: int,
                  dtype: torch.dtype, device=None) -> Dict[str, torch.Tensor]:
    """Ring-buffer cache of ``window`` slots if sliding, else ``max_len``:
    the window bound is what makes ``long_500k`` decode O(window)."""
    L = window if window > 0 else max_len
    shape = (batch, L, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attention_decode(params, cfg: ModelConfig, x: torch.Tensor,
                     cache: Dict[str, torch.Tensor],
                     index: Union[int, torch.Tensor], *, window: int = 0
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode.  x: (B, 1, D); ``index``: the new token's absolute
    position (an int or a 0-d integer tensor).  Writes the token's key and
    value into ``cache`` in place and returns (out (B, 1, D), ``cache``)."""
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    L = cache["k"].shape[1]
    index = torch.as_tensor(index, device=x.device)

    q, k, v = _project_qkv(params, cfg, x)
    pos = index.expand(B, 1)
    if cfg.mrope_sections:
        pos = pos[None].expand(3, B, 1)
    q, k = _qk_rope(cfg, q, k, pos)

    slot = torch.remainder(index, L).reshape(1).long()
    ck = cache["k"].index_copy_(1, slot, k)
    cv = cache["v"].index_copy_(1, slot, v)

    # slot s holds the newest of the positions ≡ s (mod L): before the ring
    # wraps only slots ≤ index are filled; after, all are live, and a key
    # past the window was overwritten
    live = torch.arange(L, device=x.device) <= index            # (L,)

    n_kv = cfg.num_kv_heads
    qh = q.reshape(B, 1, n_kv, cfg.num_heads // n_kv, hd)
    scores = torch.einsum("bsngh,btnh->bngst", qh, ck).float()
    scores = scores * hd ** -0.5
    scores = torch.where(live, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(cv.dtype)
    out = torch.einsum("bngst,btnh->bsngh", probs, cv)
    H, _, D = params["wo"].shape
    out = out.reshape(B, 1, H * hd) @ params["wo"].reshape(H * hd, D)
    return out, cache
