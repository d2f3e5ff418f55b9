"""Fused member-stacked optimizer-update kernel for Hopper (Triton).

Replaces ``repro/kernels/optim.py::_stacked_leaf_update`` (the Pallas TPU
kernel bodies ``_sgd_kernel`` / ``_momentum_kernel`` / ``_adam_kernel``).
One launch updates one parameter leaf for all ``M`` stacked sibling
members: the leaf is flattened to ``(M, L)``, program ``(block, member)``
handles ``BLOCK`` consecutive elements of one member, and the divergent
per-member hyper-parameters (lr, wd, momentum | b1, b2, eps, bias
corrections) are **loaded inside the kernel from ``(M,)`` f32 device
tensors** indexed by the member program id.  They are never Python floats
or ``constexpr`` arguments, so a new learning rate recompiles and
re-specialises nothing — Hippo's requirement that hp values are data.

What bounds it on an H100: device-memory bytes.  It is a pure elementwise
pass with no reuse — sgd reads p, g and writes p; momentum reads p, g, m
and writes p, m; adam reads p, g, m, v and writes p, m, v — so the least
time is bytes moved / 3.35 TB/s.  The design is accordingly plain:
contiguous per-thread runs of 8 elements (two 16-byte accesses for f32),
neighbouring threads on neighbouring addresses, a masked ragged tail
instead of the TPU version's padded ``(R, 128)`` lane copies, f32 math
with a cast back to the leaf dtype on store, and round-to-nearest ``sqrt``
and ``/`` so results track the plain version closely.  ``BLOCK`` and
``num_warps`` are fixed constants, not autotuned: results are run-to-run
bit-identical.  The block index rides grid axis 0 and the member index
axis 1, because CUDA caps grid axes 1 and 2 at 65535.

Known cost, written down and not fixed here: ResNet56 has 114 leaves and
~0.85 M parameters, so one momentum step moves ~17 MB (about 5 µs of
bandwidth) in 114 launches — launch overhead, not bandwidth, sets the
time of an update.  One launch per tree (a pointer table over leaves) is
the follow-up.

Outputs are fresh tensors (``torch.empty_like``), never in place: a
boundary snapshot handed to the checkpoint store aliases the live carry,
and the store keeps device tensors.

:func:`fused_apply_update` is a drop-in for
:func:`repro_torch.train.optimizer.apply_update` (solo: ``M = 1``);
:func:`stacked_leaf_update` takes explicit ``(M, ...)`` operands.  The
plain version (:func:`repro_torch.train.optimizer.leaf_update`) is taken
only for tensors that lie on the CPU; for a CUDA tensor the kernel is
launched, or the failure to import, compile or launch it is raised.

Counters: ``stacked_leaf_update.launches`` is a plain integer that counts
kernel **launches** (one per leaf per step); ``KERNEL_STATS.calls`` (see
:mod:`repro_torch.kernels.ops`) counts ``fused_apply_update`` **calls**
that went through the kernel (one per step).

``triton`` is imported inside the launching path only, so this module
imports on a machine without it.
"""

from __future__ import annotations

import functools
import os
from typing import Any, Dict, Tuple

import torch

from repro_torch.kernels import ops as kops
from repro_torch.train.optimizer import apply_update, leaf_update
from repro_torch.utils.tree import tree_leaves, tree_map

__all__ = ["fused_apply_update", "stacked_leaf_update"]

BLOCK = 1024      # elements per program: 8 per thread at 4 warps
NUM_WARPS = 4

# per optimizer: (#array operands, names of the per-member scalars, #outputs)
_SPEC = {
    "sgd": (2, ("lr", "wd"), 1),
    "momentum": (3, ("lr", "wd", "mom"), 2),
    "adam": (4, ("lr", "wd", "b1", "b2", "eps", "bc1", "bc2"), 3),
    "adamw": (4, ("lr", "wd", "b1", "b2", "eps", "bc1", "bc2"), 3),
}


# ---------------------------------------------------------------------------
# kernel bodies — compiled by ``triton.jit`` at first launch (see _jitted);
# ``tl`` is bound to ``triton.language`` there.
# ---------------------------------------------------------------------------


def _sgd_kernel(p_ptr, g_ptr, op_ptr, lr_ptr, wd_ptr, L,
                BLOCK: tl.constexpr):
    member = tl.program_id(1)
    offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < L
    idx = member.to(tl.int64) * L + offs
    lr = tl.load(lr_ptr + member)
    wd = tl.load(wd_ptr + member)
    p = tl.load(p_ptr + idx, mask=mask, other=0.0).to(tl.float32)
    g = tl.load(g_ptr + idx, mask=mask, other=0.0).to(tl.float32)
    new = p - lr * (g + wd * p)
    tl.store(op_ptr + idx, new.to(op_ptr.dtype.element_ty), mask=mask)


def _momentum_kernel(p_ptr, g_ptr, m_ptr, op_ptr, om_ptr,
                     lr_ptr, wd_ptr, mom_ptr, L, BLOCK: tl.constexpr):
    member = tl.program_id(1)
    offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < L
    idx = member.to(tl.int64) * L + offs
    lr = tl.load(lr_ptr + member)
    wd = tl.load(wd_ptr + member)
    mom = tl.load(mom_ptr + member)
    p = tl.load(p_ptr + idx, mask=mask, other=0.0).to(tl.float32)
    g = tl.load(g_ptr + idx, mask=mask, other=0.0).to(tl.float32)
    m = tl.load(m_ptr + idx, mask=mask, other=0.0).to(tl.float32)
    m2 = mom * m + g
    new = p - lr * (m2 + wd * p)
    tl.store(om_ptr + idx, m2.to(om_ptr.dtype.element_ty), mask=mask)
    tl.store(op_ptr + idx, new.to(op_ptr.dtype.element_ty), mask=mask)


def _adam_kernel(p_ptr, g_ptr, m_ptr, v_ptr, op_ptr, om_ptr, ov_ptr,
                 lr_ptr, wd_ptr, b1_ptr, b2_ptr, eps_ptr, bc1_ptr, bc2_ptr,
                 L, DECOUPLED: tl.constexpr, BLOCK: tl.constexpr):
    member = tl.program_id(1)
    offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < L
    idx = member.to(tl.int64) * L + offs
    lr = tl.load(lr_ptr + member)
    wd = tl.load(wd_ptr + member)
    b1 = tl.load(b1_ptr + member)
    b2 = tl.load(b2_ptr + member)
    eps = tl.load(eps_ptr + member)
    bc1 = tl.load(bc1_ptr + member)
    bc2 = tl.load(bc2_ptr + member)
    p = tl.load(p_ptr + idx, mask=mask, other=0.0).to(tl.float32)
    g = tl.load(g_ptr + idx, mask=mask, other=0.0).to(tl.float32)
    m = tl.load(m_ptr + idx, mask=mask, other=0.0).to(tl.float32)
    v = tl.load(v_ptr + idx, mask=mask, other=0.0).to(tl.float32)
    m2 = b1 * m + (1.0 - b1) * g
    v2 = b2 * v + (1.0 - b2) * g * g
    mh = tl.div_rn(m2, bc1)
    vh = tl.div_rn(v2, bc2)
    denom = tl.sqrt_rn(vh) + eps
    if DECOUPLED:   # adamw
        new = p - lr * (tl.div_rn(mh, denom) + wd * p)
    else:           # adam: wd folded into the gradient (L2)
        new = p - tl.div_rn(lr * mh, denom) - lr * wd * p
    tl.store(om_ptr + idx, m2.to(om_ptr.dtype.element_ty), mask=mask)
    tl.store(ov_ptr + idx, v2.to(ov_ptr.dtype.element_ty), mask=mask)
    tl.store(op_ptr + idx, new.to(op_ptr.dtype.element_ty), mask=mask)


@functools.lru_cache(maxsize=None)
def _jitted(name: str):
    """The ``triton.jit`` kernel for optimizer ``name``.  Imports triton —
    raising where it is missing — and points its compile cache at a
    ``build/triton`` directory beside ``src/`` unless the caller chose one."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    os.environ.setdefault("TRITON_CACHE_DIR",
                          os.path.join(root, "build", "triton"))
    import triton
    import triton.language as tl
    globals()["tl"] = tl   # the kernel bodies above resolve ``tl`` here
    body = {"sgd": _sgd_kernel, "momentum": _momentum_kernel,
            "adam": _adam_kernel, "adamw": _adam_kernel}[name]
    return triton.jit(body)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def stacked_leaf_update(name: str, *args):
    """One member-stacked leaf update: ``args`` are the array operands of
    shape ``(M, *leaf)`` — ``p, g`` for sgd, ``p, g, m`` for momentum,
    ``p, g, m, v`` for adam / adamw — followed by the per-member ``(M,)``
    f32 scalars ``lr, wd`` (sgd), ``lr, wd, mom`` (momentum) or
    ``lr, wd, b1, b2, eps, bc1, bc2`` (adam / adamw, with the bias
    corrections ``bc = 1 - b**(t+1)`` precomputed).  Returns a tuple of
    fresh tensors ``(p,)``, ``(p, m)`` or ``(p, m, v)``.

    CPU operands take the plain version; CUDA operands launch the kernel
    (and count in ``stacked_leaf_update.launches``) or raise."""
    narr, snames, nout = _SPEC[name]
    arrs, scals = args[:narr], args[narr:]
    if len(scals) != len(snames):
        raise ValueError(f"{name}: expected scalars {snames}, "
                         f"got {len(scals)}")
    p = arrs[0]
    M = p.shape[0]
    for a in arrs:
        if a.shape != p.shape or a.device != p.device:
            raise ValueError(f"{name}: array operands must share shape and "
                             f"device, got {tuple(a.shape)} on {a.device} "
                             f"vs {tuple(p.shape)} on {p.device}")
    for s_name, s in zip(snames, scals):
        if (s.shape != (M,) or s.dtype != torch.float32
                or s.device != p.device):
            raise ValueError(f"{name}: scalar {s_name!r} must be a ({M},) "
                             f"float32 tensor on {p.device}")

    if p.device.type == "cpu":
        bshape = (M,) + (1,) * (p.dim() - 1)
        kw = {k: s.reshape(bshape) for k, s in zip(snames, scals)}
        return leaf_update(name, *arrs, **kw)
    if p.device.type != "cuda":
        raise RuntimeError(f"optimizer kernel: unsupported device {p.device}")

    if M > 65535:
        raise ValueError(f"{name}: at most 65535 stacked members, got {M}")
    for a in arrs:
        if not a.is_contiguous():
            raise ValueError(f"{name}: array operands must be contiguous")
    outs = tuple(torch.empty_like(arrs[i if i == 0 else i + 1])
                 for i in range(nout))
    L = p.numel() // max(M, 1)
    if L == 0:
        return outs
    kernel = _jitted(name)
    grid = (-(-L // BLOCK), M)
    extra = {"DECOUPLED": name == "adamw"} if narr == 4 else {}
    with torch.cuda.device(p.device):
        kernel[grid](*arrs, *outs, *scals, L, BLOCK=BLOCK,
                     num_warps=NUM_WARPS, **extra)
    stacked_leaf_update.launches += 1
    return outs


stacked_leaf_update.launches = 0


@functools.lru_cache(maxsize=64)
def _const_vec(value: float, device: torch.device) -> torch.Tensor:
    return torch.full((1,), value, dtype=torch.float32, device=device)


def _vec(x: Any, device: torch.device) -> torch.Tensor:
    """A hyper-parameter value as a ``(1,)`` f32 tensor on ``device``:
    tensors are viewed (no host round-trip), Python numbers come from a
    small cache of constants."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32).reshape(1)
    return _const_vec(float(x), device)


def fused_apply_update(name: str, params: Any, grads: Any,
                       state: Dict[str, Any], hp: Dict[str, Any],
                       step: Any) -> Tuple[Any, Dict[str, Any]]:
    """Drop-in for :func:`repro_torch.train.optimizer.apply_update` running
    each leaf's update as one fused kernel launch (``M = 1``).

    Parameters on the CPU take the plain version, counted as a fallback
    ``opt_update:device:cpu`` and warned once; parameters on a CUDA device
    go through the kernel or raise."""
    ps = tree_leaves(params)
    device = ps[0].device
    if device.type == "cpu":
        kops.note_fallback("opt_update", "device:cpu")
        return apply_update(name, params, grads, state, hp, step)
    if name not in _SPEC:
        raise ValueError(name)

    gs = [g if g.is_contiguous() else g.contiguous()
          for g in tree_leaves(grads)]
    scal = [_vec(hp["lr"], device), _vec(hp.get("wd", 0.0), device)]
    slots = []
    if name == "momentum":
        scal.append(_vec(hp.get("momentum", 0.9), device))
        slots = [tree_leaves(state["m"])]
    elif name in ("adam", "adamw"):
        b1 = _vec(hp.get("b1", 0.9), device)
        b2 = _vec(hp.get("b2", 0.999), device)
        eps = _vec(hp.get("eps", 1e-8), device)
        # bias corrections on (M,) device vectors, outside the kernel
        t = _vec(step, device) + 1.0
        scal += [b1, b2, eps, 1.0 - b1 ** t, 1.0 - b2 ** t]
        slots = [tree_leaves(state["m"]), tree_leaves(state["v"])]

    # solo = one member: every leaf goes up as a (1, ...) view
    outs = [stacked_leaf_update(name, *(a[None] for a in leaf), *scal)
            for leaf in zip(ps, gs, *slots)]
    kops.note_call("opt_update")

    def pick(i: int) -> Any:
        it = iter(outs)
        return tree_map(lambda _: next(it)[i][0], params)

    if name == "sgd":
        return pick(0), state
    if name == "momentum":
        return pick(0), {"m": pick(1)}
    return pick(0), {"m": pick(1), "v": pick(2)}
