"""Naive oracle of the attention kernels (the allclose target).

The counterpart of ``repro/kernels/ref.py::attention_ref``: softmax
attention with GQA on whole matrices, f32 inside, cast back to q's dtype.
The model's ``use_kernel=False`` path is held against it, and the tests
take gradients of the kernel binding against ``torch.autograd`` through it.
"""

from __future__ import annotations

import torch

__all__ = ["attention_ref", "attention_mask"]


def attention_mask(Sq: int, Sk: int, causal: bool, window: int,
                   device=None) -> torch.Tensor:
    """Boolean (Sq, Sk) mask from absolute positions; True = attend."""
    q_pos = torch.arange(Sq, device=device)[:, None]
    k_pos = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    return mask


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """Naive softmax attention with GQA; q (B,Sq,Hq,hd), k/v (B,Sk,Hkv,hd)."""
    B, Sq, Hq, hd = q.shape
    _, Sk, Hkv, _ = k.shape
    group = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, group, hd)
    s = torch.einsum("bsngh,btnh->bngst", qg.float(), k.float()) * hd ** -0.5
    s = torch.where(attention_mask(Sq, Sk, causal, window, q.device), s,
                    -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bngst,btnh->bsngh", p, v.float())
    return out.reshape(B, Sq, Hq, hd).to(q.dtype)
