"""Fused member-stacked optimizer update (B1) on Hopper.

Replaces ``repro/kernels/optim.py::_stacked_leaf_update`` (the Pallas TPU
kernel bodies ``_sgd_kernel`` / ``_momentum_kernel`` / ``_adam_kernel``),
one launch of which updates one leaf for ``M`` stacked sibling members.
Here one launch updates a **whole tree**: :func:`stacked_tree_update`
takes every leaf of ``p, g`` (and ``m``, ``v``) as ``(M, ...)`` operands
and launches ``tree_update`` of ``kernels/csrc/optim.cu`` (its header note
says what it computes, what bounds it on an H100 and what its design does
about that), built by ``nvcc`` at first use and called through ``ctypes``
(:mod:`repro_torch.kernels._cuda`).  The leaf table — pointers, sizes,
dtypes, the strides of a strided ``g``, each leaf's first block — goes to
the kernel by value in its parameter space; a tree of more leaves than one
launch holds (``tree_capacity()``, 224) goes out as the fewest launches
that hold it, each counted.  The table's static part (sizes, strides,
dtypes, block prefix sums, output offsets) is cached by the tree's
structure; a call packs only the pointers.

The divergent per-member hyper-parameters (lr, wd, momentum | b1, b2, eps,
bias corrections) are ``(M,)`` f32 device tensors read inside the kernel
by the member index, never Python floats: a new learning rate recompiles
and re-specialises nothing — Hippo's requirement that hp values are data.
The bias corrections ``1 - b**(t+1)`` are computed outside the kernel, on
those vectors, as the JAX package computes them in XLA.

Outputs are out of place — the checkpoint store keeps device tensors, and
a boundary snapshot aliases the live carry.  The leaves under 32 MB share
**one fresh buffer per (output, dtype)**, each a 16-byte-aligned view of
it (ResNet56's whole tree: one allocation an output, where the per-leaf
design made one per leaf); a larger leaf has its own.  A strided
gradient (ResNet's HWIO view of an OIHW weight gradient) is read through
its strides, not copied first.

:func:`fused_apply_update` is a drop-in for
:func:`repro_torch.train.optimizer.apply_update` (solo: ``M = 1``) on top
of it, and :func:`stacked_apply_update` for
:func:`~repro_torch.train.optimizer.apply_update_stacked`: a sibling
group's ``(M, ...)`` trees with per-member ``(M,)`` hyper-parameters, one
launch per tree per group step.  The update stays outside the group's
``vmap`` (the JAX package puts it inside, under a ``custom_vmap`` rule
that folds the member axis into the same kernel): the result is the same.  The plain version (:func:`repro_torch.train.optimizer.leaf_update`)
is taken only for tensors that lie on the CPU; for a CUDA tensor the kernel
is launched, or the failure to build or launch it is raised.

The per-leaf Triton kernel of the first port (:func:`stacked_leaf_update`,
one launch per leaf; :func:`leafwise_apply_update` drives it over a tree,
copying strided gradients as that design did) stays as the record of the
old design, off the main path: ``chip_smoke.py`` times it and holds the
tree kernel bit-equal to it.  Both kernels evaluate the same f32 formulas
in the same contractions.

Counters: ``stacked_tree_update.launches`` counts tree-kernel launches
(one per step for every tree of the port's models);
``stacked_leaf_update.launches`` those of the per-leaf kernel;
``KERNEL_STATS.calls`` (see :mod:`repro_torch.kernels.ops`) counts
``fused_apply_update`` and ``stacked_apply_update`` **calls** that went
through the kernel (one per step, solo or group).

``triton`` is imported, and ``csrc/optim.cu`` built, inside the launching
paths only, so this module imports on a machine without either.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels import ops as kops
from repro_torch.train.optimizer import (apply_update, apply_update_stacked,
                                         leaf_update)
from repro_torch.utils.tree import tree_leaves, tree_unflatten

__all__ = ["fused_apply_update", "stacked_apply_update",
           "stacked_tree_update", "tree_plan", "stacked_leaf_update",
           "leafwise_apply_update"]

BLOCK = 1024      # Triton: elements per program, 8 per thread at 4 warps
NUM_WARPS = 4
TREE_BLOCK = 2048  # CUDA: elements of one member per block (BLK in optim.cu)
TREE_CAPACITY = 224  # leaves per launch (CAP_BIG in optim.cu, CUDA >= 12.1)
ALIGN = 16         # bytes: each output leaf's offset in its buffer
SHARED_MAX = 32 << 20  # bytes: a leaf this large has a buffer of its own

# per optimizer: (#array operands, names of the per-member scalars, #outputs)
_SPEC = {
    "sgd": (2, ("lr", "wd"), 1),
    "momentum": (3, ("lr", "wd", "mom"), 2),
    "adam": (4, ("lr", "wd", "b1", "b2", "eps", "bc1", "bc2"), 3),
    "adamw": (4, ("lr", "wd", "b1", "b2", "eps", "bc1", "bc2"), 3),
}
_OPT = {"sgd": 0, "momentum": 1, "adam": 2, "adamw": 3}


# ---------------------------------------------------------------------------
# the tree kernel (CUDA C++, csrc/optim.cu)
# ---------------------------------------------------------------------------

# a leaf record: 18 int64 fields, in the order of the enum in optim.cu
(F_P, F_G, F_M, F_V, F_OP, F_OM, F_OV, F_N, F_BLOCK0, F_FLAGS, F_GMEMBER,
 F_GS0, F_GS1, F_GS2, F_GS3, F_S1, F_S2, F_S3) = range(18)
REC = 18
FLAG_BF16, FLAG_VEC, FLAG_GVEC, FLAG_GSTRIDED = 1, 2, 4, 8
_DTYPE_TAG = {torch.float32: 0, torch.bfloat16: FLAG_BF16}
_ESIZE = {torch.float32: 4, torch.bfloat16: 2}


@functools.lru_cache(maxsize=None)
def _lib():
    """The built ``optim`` library with its C signature declared (built at
    first use; raises where it cannot be)."""
    lib = _cuda.load("optim")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.tree_update.argtypes = [I, P, I, I, I, P, P]
    for fn in (lib.tree_update, lib.tree_capacity, lib.tree_block,
               lib.tree_record):
        fn.restype = I
    if (lib.tree_block(), lib.tree_record()) != (TREE_BLOCK, REC):
        raise RuntimeError("csrc/optim.cu block or record size differs "
                           "from TREE_BLOCK / REC")
    if lib.tree_capacity() != TREE_CAPACITY:
        raise RuntimeError(f"csrc/optim.cu holds {lib.tree_capacity()} "
                           f"leaves a launch, not {TREE_CAPACITY}: this "
                           f"CUDA toolkit passes fewer parameter bytes")
    return lib


def gather_dims(shape: Sequence[int], strides: Sequence[int]
                ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """``(sizes, strides)`` of at most 4 dims that address the same
    elements in the same row-major order as a view of ``shape`` with
    ``strides``: dims of size 1 dropped, neighbours that step as one merged,
    padded in front to 4 with size-1 dims.  Raises ``ValueError`` for a
    view that needs more than 4."""
    dims = [(n, s) for n, s in zip(shape, strides) if n != 1]
    merged: List[Tuple[int, int]] = []
    for n, s in dims:
        if merged and merged[-1][1] == n * s:
            merged[-1] = (merged[-1][0] * n, s)
        else:
            merged.append((n, s))
    if len(merged) > 4:
        raise ValueError(f"a strided gradient of shape {tuple(shape)} and "
                         f"strides {tuple(strides)} needs {len(merged)} "
                         f"dims; the tree kernel gathers through at most 4")
    merged = [(1, 0)] * (4 - len(merged)) + merged
    return tuple(n for n, _ in merged), tuple(s for _, s in merged)


class TreePlan:
    """The static part of a tree's launches, cached by structure (see
    :func:`tree_plan`): the leaf table with every pointer 0, the launches
    as ``(first leaf, end leaf, blocks)``, the output buffers' dtypes and
    sizes, and how each leaf is viewed out of its buffer.

    A leaf of ``SHARED_MAX`` bytes or more has a buffer of its own: one
    buffer of a whole 2.7 B-parameter tree would need 5 GB in one piece,
    which a fragmented cache near the card's capacity may not hold.  The
    smaller leaves share one buffer per dtype, where leaves of one shape lie
    side by side, so that one ``split`` gives all their views (a view
    costs the host a few microseconds, and a ResNet step makes 228 of
    them); every leaf's offset is 16-byte aligned.  ``buffers`` lists
    ``(dtype, elements)``, ``groups`` ``(buffer, first element, full shape,
    leaves)``, ``order`` the leaves in the order the groups give them."""

    def __init__(self, M: int, solo: bool, shapes, dtypes, g_strides,
                 capacity: int = TREE_CAPACITY):
        lead = () if solo else (M,)
        live = [i for i, sh in enumerate(shapes) if _numel(sh) > 0]
        row_of = {i: r for r, i in enumerate(live)}
        self.live = np.asarray(live, dtype=np.int64)
        self.table = np.zeros((len(live), REC), dtype=np.int64)
        self.vec_ok = np.zeros(len(live), dtype=bool)   # member offsets
        self.gvec_ok = np.zeros(len(live), dtype=bool)
        self.buf_index = np.zeros(len(live), dtype=np.int64)
        self.out_off = np.zeros(len(live), dtype=np.int64)   # bytes
        for i, dt in enumerate(dtypes):
            if dt not in _DTYPE_TAG:
                raise ValueError(f"tree kernel: leaf {i} is {dt}; it takes "
                                 f"float32 and bfloat16")
        # the layout: a leaf of SHARED_MAX bytes or more alone; the others
        # in groups of one dtype and full shape whose size keeps the next
        # one 16-byte aligned; every other leaf (empty, 0-d, or of a ragged
        # size) a group of its own
        keyed: Dict[Any, List[int]] = {}
        for i, (sh, dt) in enumerate(zip(shapes, dtypes)):
            esize, full = _ESIZE[dt], lead + tuple(sh)
            nbytes = _numel(full) * esize
            side_by_side = (len(full) > 0 and 0 < nbytes < SHARED_MAX
                            and nbytes % ALIGN == 0)
            keyed.setdefault((dt, full) if side_by_side else i,
                             []).append(i)
        self.buffers: List[List[Any]] = []      # [dtype, elements]
        shared: Dict[torch.dtype, int] = {}
        self.groups: List[Tuple[int, int, Tuple[int, ...], List[int]]] = []
        for leaves in keyed.values():
            dt = dtypes[leaves[0]]
            esize, full = _ESIZE[dt], lead + tuple(shapes[leaves[0]])
            if _numel(full) * esize >= SHARED_MAX:
                buf = len(self.buffers)
                self.buffers.append([dt, 0])
            else:
                if dt not in shared:
                    shared[dt] = len(self.buffers)
                    self.buffers.append([dt, 0])
                buf = shared[dt]
                self.buffers[buf][1] += -self.buffers[buf][1] % (
                    ALIGN // esize)                      # 16-byte start
            start = self.buffers[buf][1]
            self.groups.append((buf, start, full, leaves))
            for i in leaves:
                if i in row_of:
                    self.buf_index[row_of[i]] = buf
                    self.out_off[row_of[i]] = self.buffers[buf][1] * esize
                self.buffers[buf][1] += _numel(full)
        self.order = [i for *_, leaves in self.groups for i in leaves]
        for row, i in enumerate(live):
            sh, dt = shapes[i], dtypes[i]
            esize, n = _ESIZE[dt], _numel(sh)
            rec = self.table[row]
            rec[F_N] = n
            rec[F_FLAGS] = _DTYPE_TAG[dt]
            self.vec_ok[row] = M == 1 or (n * esize) % ALIGN == 0
            st = tuple(g_strides[i])
            member, per = (0, st) if solo else (st[0], st[1:])
            rec[F_GMEMBER] = member
            if _is_row_major(sh, per):
                self.gvec_ok[row] = M == 1 or (member * esize) % ALIGN == 0
            else:
                if n >= 2 ** 32:
                    raise ValueError(f"tree kernel: leaf {i} of {n} "
                                     f"elements; a strided gradient is "
                                     f"gathered with 32-bit indices")
                sizes, strides = gather_dims(sh, per)
                rec[F_FLAGS] |= FLAG_GSTRIDED
                rec[F_GS0:F_GS3 + 1] = strides
                rec[F_S1:F_S3 + 1] = sizes[1:]
        self.all_live = len(live) == len(shapes)
        # launches of at most `capacity` leaves; first blocks per launch
        blocks = -(-self.table[:, F_N] // TREE_BLOCK)
        self.launches: List[Tuple[int, int, int]] = []
        for a in range(0, len(live), capacity):
            b = min(a + capacity, len(live))
            first = np.concatenate([[0], np.cumsum(blocks[a:b])])
            self.table[a:b, F_BLOCK0] = first[:-1]
            self.launches.append((a, b, int(first[-1])))

    def views(self, bufs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Every leaf's view of ``bufs`` (allocated as ``buffers`` says), in
        leaf order."""
        got: List[torch.Tensor] = []
        for d, start, full, leaves in self.groups:
            n = _numel(full)
            if len(full) == 0 or n == 0:
                got.append(bufs[d].as_strided(full, _row_major_strides(full),
                                              start))
            else:
                seg = bufs[d][start:start + len(leaves) * n]
                got += seg.view((len(leaves) * full[0],) + full[1:]
                                ).split_with_sizes([full[0]] * len(leaves))
        out: List[torch.Tensor] = [None] * len(got)   # type: ignore
        for i, v in zip(self.order, got):
            out[i] = v
        return out


def _row_major_strides(shape) -> Tuple[int, ...]:
    out, step = [], 1
    for n in reversed(shape):
        out.append(step)
        step *= max(int(n), 1)
    return tuple(reversed(out))


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _is_row_major(shape, strides) -> bool:
    """Does a view of ``shape`` with ``strides`` lie contiguous, in
    row-major order (dims of size 1 ignored)?"""
    want = 1
    for n, s in zip(reversed(tuple(shape)), reversed(tuple(strides))):
        if n != 1 and s != want:
            return False
        want *= n
    return True


@functools.lru_cache(maxsize=64)
def tree_plan(M: int, solo: bool, shapes, dtypes, g_strides) -> TreePlan:
    """The cached :class:`TreePlan` of a tree: ``shapes`` of its leaves
    (per member), their ``dtypes``, and ``g_strides`` of its gradients (with
    the member stride first unless ``solo``)."""
    return TreePlan(M, solo, shapes, dtypes, g_strides)


def _tree_update(name: str, M: int, solo: bool, arrs, scals
                 ) -> Tuple[List[torch.Tensor], ...]:
    """Launch the tree kernel over ``arrs`` (lists of leaves: p, g, then m,
    v) of ``M`` members (``solo``: no member axis, ``M == 1``) with the
    per-member ``(M,)`` f32 ``scals``; returns one list of fresh leaves per
    output.  Runs every step: its host time is the update's (one launch of
    a few microseconds), so the checks and the packing go by lists and
    numpy, and the views by one ``split`` per group of like leaves."""
    narr, _, nout = _SPEC[name]
    ps = arrs[0]
    shapes = [p.shape for p in ps]
    dtypes = [p.dtype for p in ps]
    for a in arrs[1:]:
        if [t.shape for t in a] != shapes or [t.dtype for t in a] != dtypes:
            raise ValueError(f"{name}: every operand tree must match the "
                             f"parameters' shapes and dtypes")
    if not all([t.is_cuda for a in arrs for t in a]):
        raise ValueError(f"{name}: operands on more than one device")
    if not all([t.is_contiguous() for a in [ps] + arrs[2:] for t in a]):
        raise ValueError(f"{name}: p, m and v leaves must be contiguous")
    plan = tree_plan(M, solo, tuple(shapes) if solo else
                     tuple(s[1:] for s in shapes), tuple(dtypes),
                     tuple([g.stride() for g in arrs[1]]))
    device = ps[0].device
    bufs = [[torch.empty(total, dtype=dt, device=device)
             for dt, total in plan.buffers] for _ in range(nout)]
    if len(plan.live):
        tab = plan.table.copy()
        for col, a in zip((F_P, F_G, F_M, F_V), arrs):
            if not plan.all_live:
                a = [a[i] for i in plan.live.tolist()]
            tab[:, col] = [t.data_ptr() for t in a]
        for col, out in zip((F_OP, F_OM, F_OV), bufs):
            base = np.asarray([b.data_ptr() for b in out], dtype=np.int64)
            tab[:, col] = base[plan.buf_index] + plan.out_off
        ptrs = tab[:, [F_P] + [F_M, F_V][:narr - 2]]
        vec = plan.vec_ok & (ptrs % ALIGN == 0).all(axis=1)
        gvec = plan.gvec_ok & (tab[:, F_G] % ALIGN == 0)
        tab[:, F_FLAGS] |= vec * FLAG_VEC | gvec * FLAG_GVEC
        hp = np.zeros(7, dtype=np.int64)
        hp[:len(scals)] = [s.data_ptr() for s in scals]
        stream = torch.cuda.current_stream(device).cuda_stream
        lib = _lib()
        with _cuda.on(device):
            for a, b, blocks in plan.launches:
                rows = np.ascontiguousarray(tab[a:b])
                _cuda.call(lib.tree_update, _OPT[name], rows.ctypes.data,
                           b - a, blocks, M, hp.ctypes.data, stream)
                stacked_tree_update.launches += 1
    return tuple(plan.views(out) for out in bufs)


def stacked_tree_update(name: str, *args) -> Tuple[List[torch.Tensor], ...]:
    """One member-stacked update of a whole tree: ``args`` are lists of
    leaves of shape ``(M, *leaf)`` — ``ps, gs`` for sgd, ``ps, gs, ms`` for
    momentum, ``ps, gs, ms, vs`` for adam / adamw — followed by the
    per-member ``(M,)`` f32 scalars ``lr, wd`` (sgd), ``lr, wd, mom``
    (momentum) or ``lr, wd, b1, b2, eps, bc1, bc2`` (adam / adamw, the bias
    corrections ``bc = 1 - b**(t+1)`` precomputed).  Leaves may mix float32
    and bfloat16 (one dtype per leaf across its operands); ``ps``, ``ms``,
    ``vs`` are contiguous, ``gs`` any strided views.  Returns one list of
    fresh leaves per output: ``(ps',)``, ``(ps', ms')`` or
    ``(ps', ms', vs')``.

    CPU operands take the plain version, leaf by leaf; CUDA operands
    launch the tree kernel (counted in ``stacked_tree_update.launches``)
    or raise."""
    if name not in _SPEC:
        raise ValueError(name)
    narr, snames, nout = _SPEC[name]
    arrs, scals = [list(a) for a in args[:narr]], args[narr:]
    if len(arrs) != narr or len(scals) != len(snames):
        raise ValueError(f"{name}: expected {narr} trees and scalars "
                         f"{snames}, got {len(args)} arguments")
    if any(len(a) != len(arrs[0]) for a in arrs):
        raise ValueError(f"{name}: trees of {[len(a) for a in arrs]} leaves")
    if not arrs[0]:
        return tuple([] for _ in range(nout))
    p0 = arrs[0][0]
    M = p0.shape[0]
    for s_name, s in zip(snames, scals):
        if (s.shape != (M,) or s.dtype != torch.float32
                or s.device != p0.device):
            raise ValueError(f"{name}: scalar {s_name!r} must be a ({M},) "
                             f"float32 tensor on {p0.device}")
    if any(p.dim() == 0 or p.shape[0] != M for p in arrs[0]):
        raise ValueError(f"{name}: every leaf must be stacked ({M}, ...)")
    if p0.device.type == "cpu":
        outs = []
        for leaf in zip(*arrs):
            bshape = (M,) + (1,) * (leaf[0].dim() - 1)
            kw = {k: s.reshape(bshape) for k, s in zip(snames, scals)}
            outs.append(leaf_update(name, *leaf, **kw))
        return tuple([o[i] for o in outs] for i in range(nout))
    if p0.device.type != "cuda":
        raise RuntimeError(f"optimizer kernel: unsupported device "
                           f"{p0.device}")
    if M > 65535:
        raise ValueError(f"{name}: at most 65535 stacked members, got {M}")
    return _tree_update(name, M, False, arrs, scals)


stacked_tree_update.launches = 0

# ---------------------------------------------------------------------------
# the per-leaf kernel (Triton), the record of the first port's design.
# Kernel bodies — compiled by ``triton.jit`` at first launch (see _jitted);
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


def _member_vec(x: Any, M: int, device: torch.device) -> torch.Tensor:
    """A hyper-parameter as the ``(M,)`` f32 vector the kernel reads by
    member index: tensors are viewed (no host round-trip), an ``(M,)`` one
    as it is; a number (from a small cache of constants) or a one-element
    tensor repeated, materialised (the kernel reads through a pointer)."""
    t = x.to(device=device, dtype=torch.float32).reshape(-1) \
        if isinstance(x, torch.Tensor) else _const_vec(float(x), device)
    if t.shape[0] == M:
        return t if t.is_contiguous() else t.contiguous()
    if t.shape[0] != 1:
        raise ValueError(f"a hyper-parameter of {t.shape[0]} values for "
                         f"{M} members")
    return t.expand(M).contiguous()


def _operands(name: str, M: int, params: Any, grads: Any,
              state: Dict[str, Any], hp: Dict[str, Any], step: Any):
    """The leaf lists and ``(M,)`` scalars of an update of ``M`` members
    (solo: 1): the bias corrections formed on device vectors, outside the
    kernel, as the JAX package forms them in XLA."""
    device = tree_leaves(params)[0].device
    vec = lambda x: _member_vec(x, M, device)
    scal = [vec(hp["lr"]), vec(hp.get("wd", 0.0))]
    slots = []
    if name == "momentum":
        scal.append(vec(hp.get("momentum", 0.9)))
        slots = [tree_leaves(state["m"])]
    elif name in ("adam", "adamw"):
        b1, b2 = vec(hp.get("b1", 0.9)), vec(hp.get("b2", 0.999))
        t = vec(step) + 1.0
        scal += [b1, b2, vec(hp.get("eps", 1e-8)), 1.0 - b1 ** t,
                 1.0 - b2 ** t]
        slots = [tree_leaves(state["m"]), tree_leaves(state["v"])]
    return [tree_leaves(params), tree_leaves(grads)] + slots, scal


def _rebuild(name: str, params: Any, outs, state: Dict[str, Any]):
    """``(params', state')`` from the output leaf lists."""
    trees = [tree_unflatten(params, o) for o in outs]
    if name == "sgd":
        return trees[0], state
    if name == "momentum":
        return trees[0], {"m": trees[1]}
    return trees[0], {"m": trees[1], "v": trees[2]}


def fused_apply_update(name: str, params: Any, grads: Any,
                       state: Dict[str, Any], hp: Dict[str, Any],
                       step: Any) -> Tuple[Any, Dict[str, Any]]:
    """Drop-in for :func:`repro_torch.train.optimizer.apply_update`: the
    whole tree in one launch of the tree kernel (``M = 1``).

    Parameters on the CPU take the plain version, counted as a fallback
    ``opt_update:device:cpu`` and warned once; parameters on a CUDA device
    go through the kernel or raise."""
    device = tree_leaves(params)[0].device
    if device.type == "cpu":
        kops.note_fallback("opt_update", "device:cpu")
        return apply_update(name, params, grads, state, hp, step)
    if name not in _SPEC:
        raise ValueError(name)
    if device.type != "cuda":
        raise RuntimeError(f"optimizer kernel: unsupported device {device}")
    arrs, scal = _operands(name, 1, params, grads, state, hp, step)
    outs = _tree_update(name, 1, True, arrs, scal)
    kops.note_call("opt_update")
    return _rebuild(name, params, outs, state)


def leafwise_apply_update(name: str, params: Any, grads: Any,
                          state: Dict[str, Any], hp: Dict[str, Any],
                          step: Any) -> Tuple[Any, Dict[str, Any]]:
    """The per-leaf design of the first port, kept as the yardstick of
    the tree kernel (off the main path): each CUDA leaf a ``(1, ...)``
    launch of :func:`stacked_leaf_update`, strided gradients copied first.
    Same result, bit for bit, as :func:`fused_apply_update`."""
    if name not in _SPEC:
        raise ValueError(name)
    arrs, scal = _operands(name, 1, params, grads, state, hp, step)
    arrs[1] = [g if g.is_contiguous() else g.contiguous() for g in arrs[1]]
    outs = [stacked_leaf_update(name, *(a[None] for a in leaf), *scal)
            for leaf in zip(*arrs)]
    return _rebuild(name, params, [[o[i][0] for o in outs]
                                   for i in range(_SPEC[name][2])], state)


def stacked_apply_update(name: str, params: Any, grads: Any,
                         state: Dict[str, Any], hp: Dict[str, Any],
                         step: Any) -> Tuple[Any, Dict[str, Any]]:
    """Drop-in for
    :func:`repro_torch.train.optimizer.apply_update_stacked`: a sibling
    group's member-stacked trees (every leaf ``(M, ...)``, ``hp`` values
    ``(M,)`` f32 tensors or numbers) in one launch of the tree kernel per
    tree — :func:`stacked_tree_update` with the bias corrections formed on
    the ``(M,)`` vectors, as :func:`fused_apply_update` forms them on
    ``(1,)`` ones, so each member gets the bits of its solo update.

    Parameters on the CPU take the plain version, counted as a fallback
    ``opt_update:device:cpu`` and warned once; parameters on a CUDA device
    go through the kernel or raise."""
    device = tree_leaves(params)[0].device
    if device.type == "cpu":
        kops.note_fallback("opt_update", "device:cpu")
        return apply_update_stacked(name, params, grads, state, hp, step)
    if name not in _SPEC:
        raise ValueError(name)
    if device.type != "cuda":
        raise RuntimeError(f"optimizer kernel: unsupported device {device}")
    M = tree_leaves(params)[0].shape[0]
    arrs, scal = _operands(name, M, params, grads, state, hp, step)
    outs = stacked_tree_update(name, *arrs, *scal)
    kops.note_call("opt_update")
    return _rebuild(name, params, outs, state)
