"""SSD intra-chunk forward (B5) and backward (B6) on Hopper.

Replaces ``repro/kernels/ssd_scan.py``: the Pallas TPU kernels
``_ssd_kernel`` (B5, launched by ``ssd_intra_pallas``) and
``_ssd_bwd_kernel`` (B6, launched by ``ssd_intra_bwd_pallas``) become the
hand-written CUDA C++ kernels of ``kernels/csrc/ssd_scan.cu`` (its header
note says what they compute, what bounds them on an H100 and what the
design does about it), built with ``nvcc`` at first use and called through
``ctypes`` (:mod:`repro_torch.kernels._cuda`).

Within a chunk of ``Q`` steps, per (batch, chunk, head)::

    att[i, j] = (C_i · B_j) · exp(cum_i − cum_j) · dt_j     (j ≤ i, else 0)
    y[i]      = Σ_j att[i, j] · x_j

Two wrappers with the JAX functions' layouts — ``xr (B,nc,Q,H,P)``,
``dtr (B,nc,Q,H)`` f32, ``ltT (B,nc,H,Q)`` f32, ``Br / Cr (B,nc,Q,N)``
shared across heads — and a plain integer ``launches`` counter each:

* :func:`ssd_intra_fwd` (B5) — ``y (B,nc,Q,H,P)`` in x's dtype;
* :func:`ssd_intra_bwd` (B6) — ``(dxr, ddtr, dltT, dBr, dCr)`` in the
  input layouts and dtypes.

Both route by dtype and shape (:func:`fwd_route`, :func:`bwd_route`, one
rule): bf16 with ``Q <= 128``, ``P`` a multiple of 8 up to 64 and ``N <=
128`` (mamba2-2.7b's Q 128, P 64, N 128) goes to the tensor-core kernels
``ssd_fwd_tc`` / ``ssd_bwd_tc`` (``wgmma`` over TMA-fed x tiles; counted
also in ``launches_tc``); f32, and bf16 outside that reach, to ``ssd_fwd``
/ ``ssd_bwd`` on the CUDA cores.  Both routes run a block per cell and
group of heads (:func:`simt_groups` on the CUDA cores, :func:`head_groups`
on the tensor cores), form ``cb`` once per block and partition the
backward's head sum (:func:`bwd_scratch_shape`).  ``route="simt"`` forces
the CUDA-core kernels (to hold one route against the other).

``cum = cumsum(ltT)`` is computed here, in torch, as the JAX functions do,
and handed to the kernel or to its plain version, so both see the same
``cum``.  A chunk's sum reaches about −1,000 at mamba2-2.7b's shape, where
one float32 ulp moves ``exp(cum_i − cum_j)`` by ~6e-5 relative, so the
CUDA-core kernels (the float32 route) take ``cum`` in float64 and form each
exponent ``cum_i − cum_j`` in float64 before rounding it to float32; the
tensor-core kernels keep the float32 ``cum`` they were built on.  The
backward's ``dltT``, the gradient through ``seg_ij = Σ_{j<t≤i} lt_t``, is
formed in both kernels: the CUDA-core kernel sums ``dseg_ij`` over the
pairs ``j < t ≤ i`` alone (:func:`span_sums`); the tensor-core kernel
takes the suffix sum of ``rowsum − colsum`` of ``dseg`` (the JAX
package's way, :func:`dlt_from_dcum`), which adds and cancels in float32
every pair on one side of ``t``.

Beside each kernel is its plain PyTorch version, the kernel's formulas on
whole ``(Q, Q)`` tiles in f32 (:func:`fwd_plain`, :func:`bwd_plain`).  Both
take the exponent only where ``j ≤ i``: above the diagonal ``cum_i − cum_j``
reaches hundreds and ``exp`` would overflow to ``inf``.  The backward is
written out, as the TPU kernel's is, not taken from autograd.  A wrapper
takes the plain version only for tensors that lie on the CPU; on a CUDA
tensor it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _cuda

__all__ = ["ssd_intra_fwd", "ssd_intra_bwd", "fwd_plain", "bwd_plain",
           "dlt_from_dcum", "span_sums", "fwd_route", "bwd_route",
           "head_groups", "simt_groups", "bwd_scratch_shape"]

TILE = 128            # rows of one pass of ssd_fwd / ssd_bwd: SLAB in the .cu
MAX_Q = 256           # chunk rows the CUDA-core kernels take (QMAX)
SIMT_MAX_P = 64       # the widest head the CUDA-core B6 groups
MAX_HEAD_DIM = 128    # P: the widest register tile the kernels are built for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# ssd_fwd_tc / ssd_bwd_tc (bf16, tensor cores): what they hold, as in
# csrc/ssd_scan.cu
TC_MAX_Q = 128        # chunk rows: one block's two warpgroups of 64
TC_MAX_P = 64         # head dim: one 128-byte swizzle row of bf16
TC_MAX_N = 128        # state: two 64-column panels
TC_MAX_HEADS = 16     # heads per block (TC_GMAX)
# The H100 SXM's 132 SMs, a fixed constant and never the card's own count:
# the grouping, and with it the order of the head sum and every bit of dB
# and dC, is a function of the shape alone.
WAVE = 132


def head_groups(BC: int, H: int) -> int:
    """Heads per block of ``ssd_fwd_tc`` / ``ssd_bwd_tc`` for ``BC = B·nc``
    cells of ``H`` heads: the fewest that keep ``BC · ceil(H / G)`` blocks
    within one wave of 132, at most 16.  A pure function of the shape (mamba2-2.7b at 1 ×
    2,048 tokens: BC 16, H 80 → G 10, 128 blocks)."""
    if BC < 1 or H < 1:
        raise ValueError(f"head_groups: BC {BC}, H {H}")
    per_cell = max(1, WAVE // BC)          # groups per cell in one wave
    return min(-(-H // min(H, per_cell)), TC_MAX_HEADS)


def simt_groups(BC: int, H: int, Q: int, P: int) -> int:
    """Heads per block of the CUDA-core ``ssd_fwd`` / ``ssd_bwd``:
    :func:`head_groups` where a chunk is one pass (``Q <= 128``) and the
    backward's registers hold the group's dcb beside dx (``P <= 64``), else
    1 (a longer chunk forms cb anew for each pass of 128 rows by 64
    columns; a wider head writes dcb per head).  A pure function of the
    shape."""
    return head_groups(BC, H) if Q <= TILE and P <= SIMT_MAX_P else 1


def bwd_route(dtype: torch.dtype, Q: int, P: int, N: int) -> str:
    """Which B6 kernels serve a CUDA call: ``"wgmma"`` (``ssd_bwd_tc``, bf16
    on the tensor cores) for bf16 with ``Q <= 128``, ``P % 8 == 0``, ``P <=
    64`` and ``N <= 128``, else ``"simt"`` (``ssd_bwd``, CUDA cores)."""
    if (dtype == torch.bfloat16 and 0 < Q <= TC_MAX_Q and P % 8 == 0
            and 0 < P <= TC_MAX_P and 0 < N <= TC_MAX_N):
        return "wgmma"
    return "simt"


def fwd_route(dtype: torch.dtype, Q: int, P: int, N: int) -> str:
    """Which B5 kernel serves a CUDA call, by B6's rule: ``"wgmma"``
    (``ssd_fwd_tc``, bf16 on the tensor cores) or ``"simt"`` (``ssd_fwd``,
    CUDA cores)."""
    return bwd_route(dtype, Q, P, N)


# ----------------------------------------------------------- plain versions
def _tile_terms(dtr, cum, Br, Cr):
    """f32 ``cb (B,nc,1,Q,Q)``, ``decay (B,nc,H,Q,Q)`` — ``exp(cum_i −
    cum_j)`` where ``j ≤ i``, 0 elsewhere, the exponent formed in ``cum``'s
    dtype and never taken above the diagonal — and ``dt`` as a row
    ``(B,nc,H,1,Q)``."""
    Q = cum.shape[-1]
    tril = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                 device=cum.device))
    seg = (cum[..., :, None] - cum[..., None, :]).float()      # cum_i - cum_j
    decay = torch.where(tril, torch.exp(torch.where(tril, seg, 0.0)), 0.0)
    cb = torch.matmul(Cr.float(), Br.float().transpose(-1, -2))
    return cb[:, :, None], decay, dtr.float().movedim(-1, -2)[..., None, :]


def fwd_plain(xr, dtr, cum, Br, Cr):
    """B5's plain version: ``y (B,nc,Q,H,P)`` in x's dtype from ``cum =
    cumsum(ltT)`` ``(B,nc,H,Q)`` (float64 for the CUDA-core kernel's
    formula, float32 for the tensor-core kernel's)."""
    cb, decay, dt = _tile_terms(dtr, cum, Br, Cr)
    att = cb * decay * dt                                      # (B,nc,H,Q,Q)
    y = torch.matmul(att, xr.float().movedim(3, 2))            # (B,nc,H,Q,P)
    return y.movedim(2, 3).to(xr.dtype).contiguous()


def bwd_plain(xr, dtr, cum, Br, Cr, g):
    """B6's plain version for the cotangent ``g`` (shaped like ``y``):
    ``(dx, ddt, dltT, dB, dC)`` with ``dx`` in x's layout and dtype, ``ddt``
    in dt's, ``dltT (B,nc,H,Q)`` f32 and ``dB / dC`` in B's / C's.  dltT
    is formed as the kernel of ``cum``'s route forms it: from a float64
    ``cum`` (the CUDA-core kernel) by :func:`span_sums`, from a float32 one
    (the tensor-core kernel) by :func:`dlt_from_dcum`."""
    cb, decay, dt = _tile_terms(dtr, cum, Br, Cr)
    att = cb * decay * dt
    xh, gh = xr.float().movedim(3, 2), g.float().movedim(3, 2)
    datt = torch.matmul(gh, xh.transpose(-1, -2))              # g xᵀ
    dx = torch.matmul(att.transpose(-1, -2), gh)               # attᵀ g
    dad = datt * decay
    ddt = (dad * cb).sum(-2)                                   # over i
    dseg = dad * cb * dt                                       # through exp
    dlt = span_sums(dseg) if cum.dtype == torch.float64 else \
        dlt_from_dcum(dseg.sum(-1) - dseg.sum(-2), torch.float32)
    dcb = (dad * dt).sum(2)                                    # over heads
    dB = torch.matmul(dcb.transpose(-1, -2), Cr.float())
    dC = torch.matmul(dcb, Br.float())
    return (dx.movedim(2, 3).to(xr.dtype).contiguous(),
            ddt.movedim(-1, -2).to(dtr.dtype).contiguous(), dlt,
            dB.to(Br.dtype), dC.to(Cr.dtype))


def dlt_from_dcum(dcum: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``cum = cumsum(ltT)`` ⇒ ``dltT`` is the suffix sum (the reversed
    cumsum) of ``dcum`` (``dseg``'s row sums less its column sums)."""
    return torch.flip(torch.cumsum(torch.flip(dcum, [-1]), -1),
                      [-1]).to(dtype)


def span_sums(dseg: torch.Tensor) -> torch.Tensor:
    """``dltT (..., Q)`` from ``dseg (..., Q, Q)``, the gradient of each
    ``seg_ij = Σ_{j<t≤i} lt_t`` (``i ≥ j``; 0 above the diagonal): ``dlt_t
    = Σ_{j<t≤i} dseg_ij``, per column the suffix sums down the rows, then
    per row ``t`` the columns ``j < t``.  The pairs that do not span ``t``
    never enter, so nothing cancels (``rowsum − colsum`` of ``dseg``, summed
    from the end, adds and takes away the same pairs)."""
    Q = dseg.shape[-1]
    below = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                  device=dseg.device), -1)     # j < t
    down = torch.flip(torch.cumsum(torch.flip(dseg, [-2]), -2), [-2])
    return torch.where(below, down, 0.0).sum(-1)


# ------------------------------------------------------------------ wrappers
@functools.lru_cache(maxsize=None)
def _lib():
    """The built library with its C signatures declared (built at first
    use; raises where it cannot be)."""
    lib = _cuda.load("ssd_scan")
    P, I = ctypes.c_void_p, ctypes.c_int
    shape = [I] * 6 + [P]          # dtype, B·nc, Q, H, P, N, stream
    grouped = shape[:-1] + [I, P]  # ..., G, stream
    lib.ssd_fwd.argtypes = lib.ssd_fwd_tc.argtypes = [P] * 6 + grouped
    lib.ssd_bwd.argtypes = lib.ssd_bwd_tc.argtypes = [P] * 12 + grouped
    for fn in (lib.ssd_fwd, lib.ssd_fwd_tc, lib.ssd_bwd, lib.ssd_bwd_tc,
               lib.ssd_tile, lib.ssd_tc_max_heads, lib.ssd_tc_max_q):
        fn.restype = I
    if lib.ssd_tile() != TILE:
        raise RuntimeError("csrc/ssd_scan.cu tile size differs from TILE")
    if (lib.ssd_tc_max_heads(), lib.ssd_tc_max_q()) != (TC_MAX_HEADS,
                                                        TC_MAX_Q):
        raise RuntimeError("csrc/ssd_scan.cu ssd_fwd_tc / ssd_bwd_tc limits "
                           "differ from TC_MAX_HEADS / TC_MAX_Q")
    return lib


def _check(name, xr, dtr, ltT, Br, Cr, g=None):
    """Validate CUDA operands: one device, x / B / C (/ g) of one dtype in
    f32 or bf16, dt and ltT f32, the JAX layouts, contiguous, P <= 128, Q
    <= 256."""
    if xr.dim() != 5:
        raise ValueError(f"{name}: xr must be (B,nc,Q,H,P), got "
                         f"{tuple(xr.shape)}")
    B, nc, Q, H, P = xr.shape
    N = Br.shape[-1]
    want = {"dtr": (dtr, (B, nc, Q, H)), "ltT": (ltT, (B, nc, H, Q)),
            "Br": (Br, (B, nc, Q, N)), "Cr": (Cr, (B, nc, Q, N))}
    if g is not None:
        want["g"] = (g, (B, nc, Q, H, P))
    for key, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {key} must be {shape}, got "
                             f"{tuple(t.shape)}")
    if not 0 < P <= MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {P} outside (0, {MAX_HEAD_DIM}]")
    if not 0 < Q <= MAX_Q:
        raise ValueError(f"{name}: chunk of {Q} outside (0, {MAX_Q}]")
    model = [xr, Br, Cr] + ([g] if g is not None else [])
    if xr.dtype not in _DTYPES or any(t.dtype != xr.dtype for t in model):
        raise ValueError(f"{name}: x, B, C (and g) must share a dtype in "
                         f"{sorted(map(str, _DTYPES))}, got "
                         f"{[str(t.dtype) for t in model]}")
    if dtr.dtype != torch.float32 or ltT.dtype != torch.float32:
        raise ValueError(f"{name}: dt and ltT must be float32, got "
                         f"{dtr.dtype}, {ltT.dtype}")
    for t in model + [dtr, ltT]:
        if t.device != xr.device:
            raise ValueError(f"{name}: operands on {t.device} and "
                             f"{xr.device}")
        if t is not ltT and not t.is_contiguous():   # cum is made so
            raise ValueError(f"{name}: operands must be contiguous")
    if xr.device.type != "cuda":
        raise RuntimeError(f"{name}: unsupported device {xr.device}")


def _shape_args(xr, Br):
    B, nc, Q, H, P = xr.shape
    return (_DTYPES[xr.dtype], B * nc, Q, H, P, Br.shape[-1],
            torch.cuda.current_stream(xr.device).cuda_stream)


def _cumsum(ltT: torch.Tensor, route: str) -> torch.Tensor:
    """``cum = cumsum(ltT)``: float64 for the CUDA-core kernels (``route``
    ``"simt"``), float32 for the tensor-core ones."""
    return torch.cumsum(ltT.double() if route == "simt" else ltT,
                        dim=-1).contiguous()


def _route(name, route_of, xr, Br, route):
    """The route a CUDA call takes: ``route_of``'s, or ``route`` where one
    is asked for (``"simt"`` always; ``"wgmma"`` only within its reach)."""
    B, nc, Q, H, P = xr.shape
    N = Br.shape[-1]
    want = route_of(xr.dtype, Q, P, N)
    route = want if route is None else route
    if route not in ("wgmma", "simt") or (route == "wgmma"
                                          and want != "wgmma"):
        raise ValueError(f"{name}: route {route!r} does not take "
                         f"{xr.dtype} at Q {Q}, P {P}, N {N}")
    return route


def _cells(xr, members: int) -> int:
    """The ``B·nc`` cells of one member: the head grouping, and with it
    the order of B6's head sum, is that of one member's launch, so a
    launch of ``members`` siblings folded into the batch axis gives each
    the bits of its own launch (mamba2-2.7b: G 10 at B 1, where the
    folded B 2 alone would pick 16)."""
    if members < 1 or xr.shape[0] % members:
        raise ValueError(f"ssd: {members} members do not divide the batch "
                         f"axis of {tuple(xr.shape)}")
    return max(1, xr.shape[0] // members * xr.shape[1])


def _groups(xr, members: int, route: str) -> int:
    """Heads per block on ``route`` for one member's cells."""
    _, _, Q, H, P = xr.shape
    cells = _cells(xr, members)
    return head_groups(cells, H) if route == "wgmma" else \
        simt_groups(cells, H, Q, P)


def bwd_scratch_shape(xr, members: int = 1, route: str = "simt"
                      ) -> Tuple[int, int, int, int]:
    """B6's head-sum scratch on ``route``: ``(B·nc, ceil(H / G), Q, Q)``
    f32, the group's dcb summed over its heads in head order, then summed
    over the groups in group order by the second kernel (no float atomics:
    every launch is bit-reproducible).  mamba2-2.7b-f32 (B 2, nc 8, H 80, Q
    128): G 10, 8.4 MB."""
    B, nc, Q, H, _ = xr.shape
    return (B * nc, -(-H // _groups(xr, members, route)), Q, Q)


def ssd_intra_fwd(xr, dtr, ltT, Br, Cr, route=None, members: int = 1):
    """B5, the counterpart of ``repro.kernels.ssd_scan.ssd_intra_pallas``.

    xr (B,nc,Q,H,P), dtr (B,nc,Q,H) f32, ltT (B,nc,H,Q) f32 per-step
    log-decay, Br / Cr (B,nc,Q,N) → y (B,nc,Q,H,P) in x's dtype.  On the
    route :func:`fwd_route` picks (or ``route``, ``"wgmma"`` / ``"simt"``,
    to hold one against the other): ``ssd_fwd_tc`` (on the tensor cores)
    or ``ssd_fwd`` (on the CUDA cores), each a block per cell and group of
    heads.  ``members``: the batch axis holds that many sibling members
    folded together; both kernels group heads as one member's launch would
    (see :func:`_cells`)."""
    _cuda.plain("ssd_intra_fwd", xr, dtr, ltT, Br, Cr)
    if xr.device.type == "cpu":
        route = _route("ssd_intra_fwd", fwd_route, xr, Br, route)
        return fwd_plain(xr, dtr, _cumsum(ltT, route), Br, Cr)
    _check("ssd_intra_fwd", xr, dtr, ltT, Br, Cr)
    route = _route("ssd_intra_fwd", fwd_route, xr, Br, route)
    cum = _cumsum(ltT, route)
    tc = route == "wgmma"
    if tc and xr.data_ptr() % 16:
        raise ValueError("ssd_intra_fwd: the bf16 kernel reads x by TMA, "
                         "which needs a 16-byte-aligned tensor")
    y = torch.empty_like(xr)
    if y.numel():
        args = (xr.data_ptr(), dtr.data_ptr(), cum.data_ptr(),
                Br.data_ptr(), Cr.data_ptr(), y.data_ptr())
        shape = _shape_args(xr, Br)
        G = _groups(xr, members, route)
        with _cuda.on(xr.device):
            _cuda.call(_lib().ssd_fwd_tc if tc else _lib().ssd_fwd, *args,
                       *shape[:-1], G, shape[-1])
        ssd_intra_fwd.launches += 1
        ssd_intra_fwd.launches_tc += tc
    return y


ssd_intra_fwd.launches = 0        # every launch of B5
ssd_intra_fwd.launches_tc = 0     # those on the tensor cores (ssd_fwd_tc)


def ssd_intra_bwd(xr, dtr, ltT, Br, Cr, g, route=None, members: int = 1
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor, torch.Tensor]:
    """B6, the counterpart of
    ``repro.kernels.ssd_scan.ssd_intra_bwd_pallas``: the backward of
    :func:`ssd_intra_fwd` for the cotangent ``g`` (shaped like ``y``).
    Returns ``(dxr, ddtr, dltT, dBr, dCr)`` in the input layouts and
    dtypes.  One B6 launch is a pair of kernels: on the route
    :func:`bwd_route` picks (or ``route``, ``"wgmma"`` / ``"simt"``, to hold
    one against the other), ``ssd_bwd_tc`` (dltT the suffix sum of dcum)
    or ``ssd_bwd`` (dltT summed over the spanning pairs, :func:`span_sums`),
    each per group of heads, then the partitioned head sum into dB / dC
    (:func:`bwd_scratch_shape`).  ``members`` as for
    :func:`ssd_intra_fwd`."""
    _cuda.plain("ssd_intra_bwd", xr, dtr, ltT, Br, Cr, g)
    if xr.device.type == "cpu":
        route = _route("ssd_intra_bwd", bwd_route, xr, Br, route)
        return bwd_plain(xr, dtr, _cumsum(ltT, route), Br, Cr, g)
    _check("ssd_intra_bwd", xr, dtr, ltT, Br, Cr, g)
    B, nc, Q, H, P = xr.shape
    route = _route("ssd_intra_bwd", bwd_route, xr, Br, route)
    cum = _cumsum(ltT, route)
    tc = route == "wgmma"
    if tc and (xr.data_ptr() % 16 or g.data_ptr() % 16):
        raise ValueError("ssd_intra_bwd: the bf16 kernel reads x and g by "
                         "TMA, which needs 16-byte-aligned tensors")
    dx, ddt = torch.empty_like(xr), torch.empty_like(dtr)
    dl = torch.empty((B, nc, H, Q), dtype=torch.float32, device=xr.device)
    dB, dC = torch.empty_like(Br), torch.empty_like(Cr)
    G = _groups(xr, members, route)
    dcb = torch.empty(bwd_scratch_shape(xr, members, route),
                      dtype=torch.float32, device=xr.device)
    if dx.numel():
        args = (xr.data_ptr(), dtr.data_ptr(), cum.data_ptr(),
                Br.data_ptr(), Cr.data_ptr(), g.data_ptr(), dx.data_ptr(),
                ddt.data_ptr(), dl.data_ptr(), dB.data_ptr(), dC.data_ptr(),
                dcb.data_ptr())
        shape = _shape_args(xr, Br)
        with _cuda.on(xr.device):
            _cuda.call(_lib().ssd_bwd_tc if tc else _lib().ssd_bwd, *args,
                       *shape[:-1], G, shape[-1])
        ssd_intra_bwd.launches += 1
        ssd_intra_bwd.launches_tc += tc
        ssd_intra_bwd.scratch_bytes = dcb.numel() * dcb.element_size()
    else:
        dl.zero_()
    return dx, ddt, dl, dB, dC


ssd_intra_bwd.launches = 0        # every launch of B6
ssd_intra_bwd.launches_tc = 0     # those on the tensor cores (ssd_bwd_tc)
ssd_intra_bwd.scratch_bytes = 0   # the last launch's head-sum scratch
