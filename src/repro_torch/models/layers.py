"""Shared neural building blocks: norms, embeddings, RoPE / M-RoPE.

The counterparts of ``repro/models/layers.py``, with the same dtype rules:
``rms_norm`` computes in f32 and casts back; ``apply_rope`` multiplies the
(bf16 or f32) activations by f32 tables, which promotes to f32, and casts
back.  Initialisers draw from a CPU ``torch.Generator`` in f32 and then
cast — the JAX package's distributions, not its bits.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

__all__ = ["rms_norm", "init_rms", "embed_init", "rope_angles", "apply_rope",
           "mrope_angles", "dense_init"]


def dense_init(gen: torch.Generator, shape, scale: Optional[float] = None,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Truncated-normal (±2σ) fan-in init (what llama-family checkpoints
    use)."""
    fan_in = shape[0] if len(shape) > 1 else shape[-1]
    s = scale if scale is not None else fan_in ** -0.5
    t = torch.empty(tuple(shape), dtype=torch.float32)
    torch.nn.init.trunc_normal_(t, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                generator=gen)
    return (t * s).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    t = torch.randn((vocab, d), generator=gen, dtype=torch.float32)
    return (t * 0.02).to(dtype)


def init_rms(d: int, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return torch.ones((d,), dtype=dtype)


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * w.float()).to(dt)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def _freq(half: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float = 1e4
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for plain RoPE.  positions: (..., S) int →
    (..., S, head_dim/2) each, f32."""
    half = head_dim // 2
    ang = positions.float()[..., None] * _freq(half, theta, positions.device)
    return torch.cos(ang), torch.sin(ang)


def mrope_angles(positions: torch.Tensor, head_dim: int,
                 sections: Sequence[int], theta: float = 1e4
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multimodal RoPE (Qwen2-VL §2): the frequency axis is partitioned into
    (temporal, height, width) sections, each rotated by its own position id.
    positions: (3, ..., S); sections sum to head_dim/2.  Returns cos/sin of
    shape (..., S, head_dim/2)."""
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to "
                         f"{half}")
    freq = _freq(half, theta, positions.device)
    parts, off = [], 0
    for i, sec in enumerate(sections):
        parts.append(positions[i].float()[..., None] * freq[off:off + sec])
        off += sec
    ang = torch.cat(parts, dim=-1)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, n_heads, head_dim); cos/sin: (..., S, head_dim/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]          # broadcast over heads
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)
