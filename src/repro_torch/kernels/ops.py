"""Kernel-plane accounting and the differentiable kernel bindings.

Every kernel wrapper of this package reports here.  ``KERNEL_STATS.calls``
counts kernel-plane **calls** — one per ``fused_apply_update`` that went
through its kernel (one per training step), one per
:func:`flash_attention` call (one per attention layer per forward) and one
per :func:`ssd_intra` call (one per SSD layer per forward) — and
``KERNEL_STATS.fallbacks`` counts calls that took the plain PyTorch
version instead, tagged with a reason and warned once per (kernel,
reason).  The only reason a wrapper may fall back is that its tensors lie
on the CPU; on a CUDA tensor it launches its kernel or raises.

(The JAX package counts at trace time, once per compilation; this package
runs eagerly, so its counts move per call.  ``kernel_calls > 0`` and
``kernel_fallbacks == 0`` mean the same thing in both.)  Surfaced via
``TorchTrainer.kernel_calls`` / ``EngineStats.kernel_fallbacks``.  Each
wrapper additionally keeps its own plain integer ``launches`` counter of
kernel launches (for the optimizer: one per parameter leaf per step; for
attention: one forward launch per call, one dq and one dk/dv launch per
backward; for SSD: one B5 launch per call, one B6 launch per backward).

:func:`flash_attention` is the counterpart of the JAX package's
``custom_vjp`` binding (``repro/kernels/ops.py:161-189``): a
``torch.autograd.Function`` whose forward is B2 (with the lse residual)
and whose backward is B3 + B4.  :func:`ssd_intra` is the counterpart of
``repro/kernels/ops.py:193-240``: forward B5, backward B6.  The
member-folding ``vmap`` rules of the JAX bindings belong to the batched
tiers (ROADMAP queue A).
"""

from __future__ import annotations

import warnings
from collections import Counter
from dataclasses import dataclass, field
from typing import Tuple

import torch

from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                 flash_attention_fwd)
from repro_torch.kernels.ssd_scan import ssd_intra_bwd, ssd_intra_fwd

__all__ = ["KernelFallbackWarning", "KernelStats", "KERNEL_STATS",
           "reset_kernel_stats", "note_call", "note_fallback",
           "flash_attention", "ssd_intra"]


class KernelFallbackWarning(UserWarning):
    """A kernel-plane call took the plain PyTorch version."""


@dataclass
class KernelStats:
    """Module-global kernel-plane accounting."""
    calls: int = 0
    fallbacks: int = 0
    reasons: Counter = field(default_factory=Counter)

    def snapshot(self) -> Tuple[int, int]:
        return (self.calls, self.fallbacks)


KERNEL_STATS = KernelStats()
_WARNED: set = set()


def reset_kernel_stats() -> None:
    KERNEL_STATS.calls = 0
    KERNEL_STATS.fallbacks = 0
    KERNEL_STATS.reasons.clear()
    _WARNED.clear()


def note_call(kernel: str) -> None:
    KERNEL_STATS.calls += 1


def note_fallback(kernel: str, reason: str) -> None:
    KERNEL_STATS.fallbacks += 1
    KERNEL_STATS.reasons[f"{kernel}:{reason}"] += 1
    if (kernel, reason) not in _WARNED:
        _WARNED.add((kernel, reason))
        warnings.warn(
            f"kernel {kernel!r} took its plain PyTorch version "
            f"({reason}); the kernel plane is inactive for these calls",
            KernelFallbackWarning, stacklevel=3)


# ------------------------------------------------------- flash attention
class _FlashAttention(torch.autograd.Function):
    """Forward B2 (keeping ``out`` and ``lse`` as residuals), backward
    B3 + B4 — or, for CPU tensors, their plain versions inside the same
    function."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                       return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do.contiguous(),
                                         causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """(B,S,Hq,hd) GQA flash attention, differentiable through the
    backward kernels.  CPU tensors take the plain versions, counted as a
    fallback ``flash_attention:device:cpu`` and warned once."""
    if q.device.type == "cpu":
        note_fallback("flash_attention", "device:cpu")
    else:
        note_call("flash_attention")
    return _FlashAttention.apply(q, k, v, causal, int(window))


# ------------------------------------------------------------ ssd intra
class _SSDIntra(torch.autograd.Function):
    """Forward B5 (keeping the inputs as residuals), backward B6 — or, for
    CPU tensors, their plain versions inside the same function."""

    @staticmethod
    def forward(ctx, xr, dtr, ltT, Br, Cr):
        xr, dtr, ltT, Br, Cr = (t.contiguous() for t in (xr, dtr, ltT, Br,
                                                         Cr))
        ctx.save_for_backward(xr, dtr, ltT, Br, Cr)
        return ssd_intra_fwd(xr, dtr, ltT, Br, Cr)

    @staticmethod
    def backward(ctx, g):
        return ssd_intra_bwd(*ctx.saved_tensors, g.contiguous())


def ssd_intra(xr: torch.Tensor, dtr: torch.Tensor, ltT: torch.Tensor,
              Br: torch.Tensor, Cr: torch.Tensor) -> torch.Tensor:
    """Intra-chunk SSD term (``xr (B,nc,Q,H,P)``, ``dtr (B,nc,Q,H)``,
    ``ltT (B,nc,H,Q)``, ``Br / Cr (B,nc,Q,N)`` → ``y (B,nc,Q,H,P)``),
    differentiable through the backward kernel.  CPU tensors take the plain
    versions, counted as a fallback ``ssd_intra:device:cpu`` and warned
    once."""
    if xr.device.type == "cpu":
        note_fallback("ssd_intra", "device:cpu")
    else:
        note_call("ssd_intra")
    return _SSDIntra.apply(xr, dtr, ltT, Br, Cr)
