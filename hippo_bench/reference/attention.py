"""A Qwen2 decoder block: RMSNorm, grouped-query causal attention with
RoPE and q / k / v biases, RMSNorm, a SwiGLU MLP; pre-norm residual.

Keys read from the configuration file: ``hidden_size``,
``num_attention_heads``, ``num_key_value_heads``, ``rope_theta``,
``rms_norm_eps``.  RoPE rotates the two halves of each head (the
Hugging Face convention).  Parameters: ``norm1``, ``attn/{wq, wk, wv}``
(D, heads, head_dim), ``attn/{bq, bk, bv}``, ``attn/wo`` (heads,
head_dim, D), ``norm2``, ``ffn/{wg, wi}`` (D, F), ``ffn/wo`` (F, D).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from hippo_bench.reference.lm import rms_norm


def norm_eps(cfg) -> float:
    return float(cfg["rms_norm_eps"])


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, hd): rotate the halves by each position's angles."""
    S, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freq = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                        device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freq
    c, s = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def forward(p, x: torch.Tensor, cfg, mm) -> torch.Tensor:
    B, S, D = x.shape
    H, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd, G = D // H, H // KV
    eps = norm_eps(cfg)
    a = p["attn"]
    h = rms_norm(x, p["norm1"], eps)
    q = mm(h, a["wq"].reshape(D, H * hd)).view(B, S, H, hd) + a["bq"]
    k = mm(h, a["wk"].reshape(D, KV * hd)).view(B, S, KV, hd) + a["bk"]
    v = mm(h, a["wv"].reshape(D, KV * hd)).view(B, S, KV, hd) + a["bv"]
    q, k = _rope(q, cfg["rope_theta"]), _rope(k, cfg["rope_theta"])
    q = q.view(B, S, KV, G, hd).permute(0, 2, 3, 1, 4)       # B KV G S hd
    k = k.permute(0, 2, 1, 3)[:, :, None]                    # B KV 1 S hd
    v = v.permute(0, 2, 1, 3)[:, :, None]
    scores = mm(q, k.transpose(-1, -2)) * hd ** -0.5         # B KV G S S
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    o = mm(probs, v).permute(0, 3, 1, 2, 4).reshape(B, S, H * hd)
    x = x + mm(o, a["wo"].reshape(H * hd, D))
    f = p["ffn"]
    h = rms_norm(x, p["norm2"], eps)
    return x + mm(F.silu(mm(h, f["wg"])) * mm(h, f["wi"]), f["wo"])
