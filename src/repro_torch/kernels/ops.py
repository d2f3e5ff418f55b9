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
``custom_vjp`` binding over ``custom_vmap`` launchers
(``repro/kernels/ops.py:107-232``), in the same two layers.  The raw
launchers — ``_FaFwd`` (B2, with the lse residual), ``_FaBwd`` (B3 + B4),
``_SSDFwd`` (B5), ``_SSDBwd`` (B6) — are ``torch.autograd.Function``
classes with a ``vmap`` rule each: it moves the member axis to the front,
broadcasts an unbatched operand, folds ``(M, B, ...) → (M·B, ...)``
(contiguous, 16-byte aligned), calls the kernel wrapper **once** for the
whole sibling group and unfolds.  Every block of B2–B6 works within one
batch index, so a folded launch gives each member the bits of its own
launch.  The differentiable bindings (``_FlashAttention``, ``_SSDIntra``)
sit on top with a generated vmap rule: under ``vmap(grad(loss))`` their
forward and backward run under vmap and reach the launchers' rules — the
backward has its own, since it runs while vmap is still active.  A kernel
wrapper handed a functorch wrapper raises; it never launches on one.  One
group call is one ``note_call`` and one launch per kernel.
"""

from __future__ import annotations

import warnings
from collections import Counter
from dataclasses import dataclass, field
from typing import List, Tuple

import torch

from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                 flash_attention_fwd)
from repro_torch.kernels.ssd_scan import ssd_intra_bwd, ssd_intra_fwd

_is_wrapped = torch._C._functorch.is_functorch_wrapped_tensor

__all__ = ["KernelFallbackWarning", "KernelStats", "KERNEL_STATS",
           "reset_kernel_stats", "note_call", "note_fallback",
           "flash_attention", "ssd_intra", "LOCAL_HEAD_SHARDS"]

#: The ROADMAP item that B2–B6 inside a step over several ranks wait for.
LOCAL_HEAD_SHARDS = "kernels on local head shards (ROADMAP queue A item 6)"


def _refuse_dtensor(name: str, *tensors) -> None:
    """B2–B6 take whole tensors on one device: a DTensor (a step sharded
    over several ranks) is refused by name, never run on the plain
    version instead."""
    if not torch.distributed.is_available():
        return
    from torch.distributed.tensor import DTensor
    if any(isinstance(t, DTensor) for t in tensors):
        raise NotImplementedError(
            f"{name} on a DTensor (a step over several ranks) needs "
            f"{LOCAL_HEAD_SHARDS}; train the ranks with --no-use-kernel")


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


# ------------------------------------------------------------ member fold
def _wrapped(args) -> bool:
    return any(isinstance(a, torch.Tensor) and _is_wrapped(a) for a in args)


def _run(op, *args):
    """Call a raw launcher: through its ``autograd.Function`` (and so its
    batching rule) when an operand is a functorch wrapper, straight to the
    wrapper otherwise — eager solo calls pay no second ``apply``."""
    if _wrapped(args):
        return op.apply(*args)
    return op.forward(*args)


def _fold(m: int, in_dims, *args) -> List[torch.Tensor]:
    """Move each operand's member axis to the front — broadcasting an
    unbatched one (the shared KV, the shared slab) to all ``m`` members —
    and fold it into the batch axis: ``(m, B, ...) → (m·B, ...)``,
    contiguous and 16-byte aligned, as the kernels' TMA maps read them."""
    out = []
    for a, d in zip(args, in_dims):
        a = a.expand((m,) + a.shape) if d is None else a.movedim(d, 0)
        a = a.reshape((m * a.shape[1],) + a.shape[2:]).contiguous()
        out.append(a.clone() if a.data_ptr() % 16 else a)
    return out


def _unfold(m: int, x: torch.Tensor) -> torch.Tensor:
    return x.view((m, x.shape[0] // m) + x.shape[1:])


# ------------------------------------------------------- flash attention
class _FaFwd(torch.autograd.Function):
    """The raw B2 launch ``(out, lse)``; its batching rule folds the member
    axis into the batch axis and launches once for the whole group."""

    @staticmethod
    def forward(q, k, v, causal, window):
        return flash_attention_fwd(q, k, v, causal=causal, window=window,
                                   return_lse=True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, window):
        m = info.batch_size
        out, lse = flash_attention_fwd(*_fold(m, in_dims[:3], q, k, v),
                                       causal=causal, window=window,
                                       return_lse=True)
        return (_unfold(m, out), _unfold(m, lse)), (0, 0)


class _FaBwd(torch.autograd.Function):
    """The raw backward (B3 + B4) with the same folding rule: under
    ``vmap(grad(...))`` the backward runs while vmap is still active."""

    @staticmethod
    def forward(q, k, v, out, lse, do, causal, window):
        return flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                                   window=window)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, q, k, v, out, lse, do, causal, window):
        m = info.batch_size
        grads = flash_attention_bwd(
            *_fold(m, in_dims[:6], q, k, v, out, lse, do), causal=causal,
            window=window)
        return tuple(_unfold(m, g) for g in grads), (0, 0, 0)


class _FlashAttention(torch.autograd.Function):
    """Forward B2 (``out`` and ``lse`` kept as residuals), backward B3 +
    B4 — or, for CPU tensors, their plain versions.  Its vmap rule is
    generated: the forward and backward run under vmap and reach the raw
    launchers' folding rules."""

    generate_vmap_rule = True

    @staticmethod
    def forward(q, k, v, causal, window):
        return _run(_FaFwd, q, k, v, causal, window)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window = inputs
        out, lse = output
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _run(_FaBwd, q, k, v, out, lse, do.contiguous(),
                          ctx.causal, ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """(B,S,Hq,hd) GQA flash attention, differentiable through the
    backward kernels and vmap-aware (a sibling group's member axis folds
    into the kernels' batch axis: one launch per group).  CPU tensors take
    the plain versions, counted as a fallback ``flash_attention:device:cpu``
    and warned once.  A DTensor is refused (:data:`LOCAL_HEAD_SHARDS`)."""
    _refuse_dtensor("flash_attention", q, k, v)
    if q.device.type == "cpu":
        note_fallback("flash_attention", "device:cpu")
    else:
        note_call("flash_attention")
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), causal, int(window))[0]


# ------------------------------------------------------------ ssd intra
class _SSDFwd(torch.autograd.Function):
    """The raw B5 launch with its member-folding rule; the folded launch
    groups heads as one member's launch does (``members``), so it gives
    every member the bits of its own launch."""

    @staticmethod
    def forward(xr, dtr, ltT, Br, Cr):
        return ssd_intra_fwd(xr, dtr, ltT, Br, Cr)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, *args):
        m = info.batch_size
        y = ssd_intra_fwd(*_fold(m, in_dims, *args), members=m)
        return _unfold(m, y), 0


class _SSDBwd(torch.autograd.Function):
    """The raw B6 launch with the same folding rule."""

    @staticmethod
    def forward(xr, dtr, ltT, Br, Cr, g):
        return ssd_intra_bwd(xr, dtr, ltT, Br, Cr, g)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, *args):
        m = info.batch_size
        grads = ssd_intra_bwd(*_fold(m, in_dims, *args), members=m)
        return tuple(_unfold(m, g) for g in grads), (0,) * 5


class _SSDIntra(torch.autograd.Function):
    """Forward B5 (the inputs kept as residuals), backward B6 — or, for
    CPU tensors, their plain versions; vmap rule generated as for
    :class:`_FlashAttention`."""

    generate_vmap_rule = True

    @staticmethod
    def forward(xr, dtr, ltT, Br, Cr):
        return _run(_SSDFwd, xr, dtr, ltT, Br, Cr)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        return _run(_SSDBwd, *ctx.saved_tensors, g.contiguous())


def ssd_intra(xr: torch.Tensor, dtr: torch.Tensor, ltT: torch.Tensor,
              Br: torch.Tensor, Cr: torch.Tensor) -> torch.Tensor:
    """Intra-chunk SSD term (``xr (B,nc,Q,H,P)``, ``dtr (B,nc,Q,H)``,
    ``ltT (B,nc,H,Q)``, ``Br / Cr (B,nc,Q,N)`` → ``y (B,nc,Q,H,P)``),
    differentiable through the backward kernel and vmap-aware (one launch
    per group).  CPU tensors take the plain versions, counted as a
    fallback ``ssd_intra:device:cpu`` and warned once.  A DTensor is
    refused (:data:`LOCAL_HEAD_SHARDS`)."""
    _refuse_dtensor("ssd_intra", xr, dtr, ltT, Br, Cr)
    if xr.device.type == "cpu":
        note_fallback("ssd_intra", "device:cpu")
    else:
        note_call("ssd_intra")
    return _SSDIntra.apply(*(t.contiguous() for t in (xr, dtr, ltT, Br,
                                                      Cr)))
