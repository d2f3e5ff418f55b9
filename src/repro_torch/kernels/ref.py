"""Naive oracles of the attention and SSD kernels (the allclose targets).

The counterparts of ``repro/kernels/ref.py``: :func:`attention_ref`,
softmax attention with GQA on whole matrices, and :func:`ssd_intra_ref`,
the intra-chunk SSD term in its masked-decay attention form; both f32
inside, cast back to the input's dtype.  The models' ``use_kernel=False``
paths are held against them, and the tests take gradients of the kernel
bindings against ``torch.autograd`` through them.
"""

from __future__ import annotations

import torch

__all__ = ["attention_ref", "attention_mask", "ssd_intra_ref"]


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


def ssd_intra_ref(xr: torch.Tensor, dtr: torch.Tensor, ltT: torch.Tensor,
                  Br: torch.Tensor, Cr: torch.Tensor) -> torch.Tensor:
    """Naive intra-chunk SSD: ``att[i,j] = (C_i·B_j)·exp(cum_i − cum_j)·dt_j``
    for ``j ≤ i``, ``y = att·x``.  Shapes as
    :func:`repro_torch.kernels.ssd_scan.ssd_intra_fwd`.

    The exponent is masked before ``exp`` (``-inf`` above the diagonal), not
    after as in the JAX oracle: with a chunk's cumulative log-decay near
    −1,000, ``exp(cum_i − cum_j)`` above the diagonal overflows to ``inf``,
    which the forward's ``where`` hides but whose autograd backward turns
    into ``inf · 0 = NaN``.  The forward values are the same.  The cumsum
    and the exponents are taken in float64 and rounded once, as the port's
    float32 route does (near −1,000 one float32 ulp of ``cum`` moves
    ``exp`` by 6e-5 relative).
    """
    Q = xr.shape[2]
    cum = torch.cumsum(ltT.double(), dim=-1)                 # (B,nc,H,Q)
    seg = (cum[..., :, None] - cum[..., None, :]).float()    # (B,nc,H,Q,Q)
    tril = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xr.device))
    decay = torch.exp(torch.where(tril, seg, float("-inf")))
    cb = torch.einsum("bcin,bcjn->bcij", Cr.float(), Br.float())
    att = cb[:, :, None] * decay * dtr.float().movedim(-1, -2)[..., None, :]
    y = torch.einsum("bchij,bcjhp->bcihp", att, xr.float())
    return y.to(xr.dtype)
