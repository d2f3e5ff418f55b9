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

Handed DTensors (a step over several ranks), :func:`flash_attention` and
:func:`ssd_intra` run the same bindings on each rank's local tensors, by
a :class:`LocalPlan` made from the operands' placements
(:func:`attention_plan`, :func:`ssd_plan`): the batch stays split where
it is split; heads stay split where each rank's q heads are whole GQA
groups, or lie inside one kv group (the rank then takes that kv head, a
local slice, and its ``dk`` / ``dv`` come back as a ``Partial`` sum);
SSD heads stay split with B and C whole, their gradients ``Partial``;
anything else is gathered whole first, counted in
``KERNEL_STATS.heads_gathered``.  The outputs come back as DTensors.
Sibling groups never meet DTensors, so the member fold is unchanged.
"""

from __future__ import annotations

import warnings
from collections import Counter
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import torch

from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                 flash_attention_fwd)
from repro_torch.kernels.ssd_scan import ssd_intra_bwd, ssd_intra_fwd

_is_wrapped = torch._C._functorch.is_functorch_wrapped_tensor

__all__ = ["KernelFallbackWarning", "KernelStats", "KERNEL_STATS",
           "reset_kernel_stats", "note_call", "note_fallback",
           "flash_attention", "ssd_intra", "LocalPlan", "attention_plan",
           "ssd_plan"]


class KernelFallbackWarning(UserWarning):
    """A kernel-plane call took the plain PyTorch version."""


@dataclass
class KernelStats:
    """Module-global kernel-plane accounting."""
    calls: int = 0
    fallbacks: int = 0
    #: DTensor calls that ran every head on some mesh dimension of more
    #: than one rank (:func:`attention_plan`'s case 3)
    heads_gathered: int = 0
    reasons: Counter = field(default_factory=Counter)

    def snapshot(self) -> Tuple[int, int]:
        return (self.calls, self.fallbacks)


KERNEL_STATS = KernelStats()
_WARNED: set = set()


def reset_kernel_stats() -> None:
    KERNEL_STATS.calls = 0
    KERNEL_STATS.fallbacks = 0
    KERNEL_STATS.heads_gathered = 0
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
    and warned once.  DTensors (a step over several ranks) run on each
    rank's local batch and heads by :func:`attention_plan`."""
    if _dtensors(q, k, v):
        plan = attention_plan(_placements(q, k, v), q.shape[2], k.shape[2],
                              _mesh_shape(q))
        mesh, (q_, k_, v_) = _to_local(plan, q, k, v)
        if plan.kv_heads is not None:             # case 2: the group's head
            d, heads = plan.kv_heads
            h = heads[mesh.get_local_rank(d)]
            k_, v_ = k_.narrow(2, h, 1), v_.narrow(2, h, 1)
        out = flash_attention(q_, k_, v_, causal=causal, window=window)
        return _from_local(out, mesh, plan.output, q.shape)
    if q.device.type == "cpu":
        note_fallback("flash_attention", "device:cpu")
    else:
        note_call("flash_attention")
    return _FlashAttention.apply(_aligned(q), _aligned(k), _aligned(v),
                                 causal, int(window))[0]


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
    fallback ``ssd_intra:device:cpu`` and warned once.  DTensors run on
    each rank's local batch and heads by :func:`ssd_plan`."""
    if _dtensors(xr, dtr, ltT, Br, Cr):
        plan = ssd_plan(_placements(xr, dtr, ltT, Br, Cr), xr.shape[3],
                        _mesh_shape(xr))
        mesh, local = _to_local(plan, xr, dtr, ltT, Br, Cr)
        return _from_local(ssd_intra(*local), mesh, plan.output, xr.shape)
    if xr.device.type == "cpu":
        note_fallback("ssd_intra", "device:cpu")
    else:
        note_call("ssd_intra")
    return _SSDIntra.apply(*(_aligned(t) for t in (xr, dtr, ltT, Br, Cr)))


# ------------------------------------------------- DTensors: local heads
def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned, as the kernels' TMA maps read
    it (a rank's batch slice of a replica is contiguous, but need not
    start on 16 bytes)."""
    t = t.contiguous()
    if t.device.type != "cuda" or _is_wrapped(t):   # vmap: ``_fold`` aligns
        return t
    return t.clone() if t.data_ptr() % 16 else t


@dataclass(frozen=True)
class LocalPlan:
    """How one :func:`flash_attention` / :func:`ssd_intra` call runs on
    DTensors.  Operand ``i`` is redistributed to ``inputs[i]`` (where a
    mesh dimension only narrows it, ``Replicate → Shard``, that is the
    rank's own slice: no communication), its local tensor goes to the
    whole-tensor binding with its gradient declared ``grads[i]``, and the
    output is wrapped with ``output``.  ``cases`` names what each mesh
    dimension does: ``"batch"``, ``"heads"`` (case 1), ``"kv_group"``
    (case 2), ``"gathered"`` (case 3); ``kv_heads`` is case 2's ``(mesh
    dimension, the kv head each coordinate on it reads)``; ``gathered``
    is whether some dimension of more than one rank ran every head."""
    inputs: Tuple[tuple, ...]
    grads: Tuple[tuple, ...]
    output: tuple
    cases: Tuple[str, ...]
    kv_heads: Optional[Tuple[int, Tuple[int, ...]]] = None
    gathered: bool = False


def _split(p) -> Optional[int]:
    """The tensor dimension a ``Shard`` splits; None for a replica; -1 for
    anything else (a partial sum, a strided shard)."""
    from torch.distributed.tensor import Shard
    if p.is_replicate():
        return None
    return p.dim if type(p) is Shard else -1


def attention_plan(placements, hq: int, hkv: int, mesh_shape) -> LocalPlan:
    """The plan of a :func:`flash_attention` call on DTensors: q
    ``(B, S, hq, hd)``, k / v ``(B, S, hkv, hd)`` placed ``placements``
    (q's, k's, v's, one entry per mesh dimension) on a mesh of
    ``mesh_shape``.  On each mesh dimension of m ranks:

    * an operand split on the batch: every operand, the output and every
      gradient keep the batch split (``"batch"``);
    * case 1, q split on heads, k / v split on heads or whole, each
      rank's q heads whole GQA groups (``hq / m`` a multiple of
      ``hq / hkv``): the kernel runs on the local q and kv heads, and the
      output and the gradients are split alike (``"heads"``);
    * case 2, q split on heads, k / v whole, each rank's q heads inside
      one kv group (``hq / hkv`` a multiple of ``hq / m``): the kernel
      takes the local q heads and the kv head they read, a local slice;
      the local ``dk`` / ``dv`` are the rank's share of a sum over the
      ranks, so their gradients are ``Partial`` (``"kv_group"``; on one
      dimension only);
    * case 3, anything else (q heads straddling kv groups, q whole): every
      operand gathered whole there, the kernel on all heads of the local
      batch, the output a replica, as GSPMD places the operands around
      the reference's kernel call (``"gathered"``)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    group = hq // hkv
    ins, grads = [[], [], []], [[], [], []]
    out, cases, kv_heads, split, gathered = [], [], None, 1, False
    for d, m in enumerate(mesh_shape):
        sq, sk, sv = (_split(p[d]) for p in placements)
        local = hq // (split * m) if hq % (split * m) == 0 else 0
        if 0 in (sq, sk, sv):
            case, want = "batch", (Shard(0),) * 3
        elif sq == 2 and local and kv_heads is None and \
                local % group == 0 and {sk, sv} <= {2, None}:
            case, want = "heads", (Shard(2),) * 3
        elif sq == 2 and local and kv_heads is None and split == 1 and \
                group % local == 0 and sk is None and sv is None:
            case, want = "kv_group", (Shard(2), Replicate(), Replicate())
            kv_heads = (d, tuple(c * local // group for c in range(m)))
        else:
            case, want = "gathered", (Replicate(),) * 3
            gathered = gathered or m > 1
        if case in ("heads", "kv_group"):
            split *= m
        for i in range(3):
            ins[i].append(want[i])
            grads[i].append(Partial() if case == "kv_group" and i else
                            want[i])
        out.append(want[0])
        cases.append(case)
    return LocalPlan(tuple(map(tuple, ins)), tuple(map(tuple, grads)),
                     tuple(out), tuple(cases), kv_heads, gathered)


#: the head axis of each :func:`ssd_intra` operand (B and C have none)
_SSD_HEAD_AXES = (3, 3, 2, None, None)


def ssd_plan(placements, heads: int, mesh_shape) -> LocalPlan:
    """The plan of an :func:`ssd_intra` call on DTensors (``placements``:
    xr's, dtr's, ltT's, Br's, Cr's) of ``heads`` SSD heads on a mesh of
    ``mesh_shape``.  On each mesh dimension: an operand split on the batch
    keeps every operand split on it (``"batch"``); xr split on heads takes
    dtr and ltT on the same heads (a local slice where they are whole)
    while B and C stay whole, every head reading them, so their gradients
    are partial sums over the head shards, ``Partial`` (``"heads"``);
    anything else gathers every operand whole (``"gathered"``)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    n = len(_SSD_HEAD_AXES)
    ins, grads = [[] for _ in range(n)], [[] for _ in range(n)]
    out, cases, split, gathered = [], [], 1, False
    for d, m in enumerate(mesh_shape):
        s = [_split(p[d]) for p in placements]
        if 0 in s:
            case, want = "batch", (Shard(0),) * n
        elif s[0] == 3 and heads % (split * m) == 0 and all(
                x in (a, None) for x, a in zip(s, _SSD_HEAD_AXES)):
            case = "heads"
            want = tuple(Replicate() if a is None else Shard(a)
                         for a in _SSD_HEAD_AXES)
            split *= m
        else:
            case, want = "gathered", (Replicate(),) * n
            gathered = gathered or m > 1
        for i, a in enumerate(_SSD_HEAD_AXES):
            ins[i].append(want[i])
            grads[i].append(Partial() if case == "heads" and a is None
                            else want[i])
        out.append(want[0])
        cases.append(case)
    return LocalPlan(tuple(map(tuple, ins)), tuple(map(tuple, grads)),
                     tuple(out), tuple(cases), None, gathered)


def _dtensors(*args) -> bool:
    """Whether the operands are DTensors (all of them, on one mesh)."""
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor
    n = sum(isinstance(a, DTensor) for a in args)
    if n and (n < len(args) or len({a.device_mesh for a in args}) > 1):
        raise TypeError("the kernels take DTensors only all on one mesh")
    return n > 0


def _placements(*args):
    return tuple(tuple(a.placements) for a in args)


def _mesh_shape(x) -> Tuple[int, ...]:
    return tuple(x.device_mesh.mesh.shape)


def _to_local(plan: LocalPlan, *args):
    """``(mesh, local tensors)`` of ``args`` by ``plan``, differentiable:
    each gradient comes back as the plan declares it."""
    mesh = args[0].device_mesh
    local = []
    for x, want, grad in zip(args, plan.inputs, plan.grads):
        if tuple(x.placements) != want:
            x = x.redistribute(mesh, want)
        local.append(x.to_local(grad_placements=grad))
    if plan.gathered:
        KERNEL_STATS.heads_gathered += 1
    return mesh, local


def _from_local(t, mesh, placements, shape):
    from torch.distributed.tensor import DTensor
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(t, mesh, placements, run_check=False,
                              shape=shape, stride=stride)
