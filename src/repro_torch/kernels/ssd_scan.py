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
  input layouts and dtypes.  It routes by dtype and shape
  (:func:`bwd_route`): bf16 with ``Q <= 128``, ``P`` a multiple of 8 up to
  64 and ``N <= 128`` (mamba2-2.7b's Q 128, P 64, N 128) goes to
  ``ssd_bwd_tc``, the tensor-core kernels (``wgmma``: ``cb`` once per
  cell, a block per cell and group of :func:`head_groups` heads, a
  partitioned head sum; counted also in ``ssd_intra_bwd.launches_tc``);
  f32, and bf16 outside that reach, to ``ssd_bwd`` on the CUDA cores.

``cum = cumsum(ltT)`` is computed here, in torch, as the JAX functions do,
and handed to the kernel or to its plain version, so both see the same f32
``cum`` (near −1,000 at the end of a mamba2-2.7b chunk, where another
summation order would move ``exp`` by ~1e-4 relative).  The backward's
``dltT`` — the suffix sum of the kernel's ``dcum``, the transpose of the
cumsum — is taken here too (:func:`dlt_from_dcum`).

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
           "dlt_from_dcum", "bwd_route", "head_groups"]

TILE = 64             # must equal TL in csrc/ssd_scan.cu
MAX_HEAD_DIM = 128    # P: the widest register tile the kernels are built for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# ssd_bwd_tc (bf16, tensor cores): what it holds, as in csrc/ssd_scan.cu
TC_MAX_Q = 128        # chunk rows: one block's two warpgroups of 64
TC_MAX_P = 64         # head dim: one 128-byte swizzle row of bf16
TC_MAX_N = 128        # state: two 64-column panels
TC_MAX_HEADS = 16     # heads per block (TC_GMAX)
# The H100 SXM's 132 SMs, a fixed constant and never the card's own count:
# the grouping, and with it the order of the head sum and every bit of dB
# and dC, is a function of the shape alone.
WAVE = 132


def head_groups(BC: int, H: int) -> int:
    """Heads per block of ``ssd_bwd_tc`` for ``BC = B·nc`` cells of ``H``
    heads: the fewest that keep ``BC · ceil(H / G)`` blocks within one wave
    of 132, at most 16.  A pure function of the shape (mamba2-2.7b at 1 ×
    2,048 tokens: BC 16, H 80 → G 10, 128 blocks)."""
    if BC < 1 or H < 1:
        raise ValueError(f"head_groups: BC {BC}, H {H}")
    per_cell = max(1, WAVE // BC)          # groups per cell in one wave
    return min(-(-H // min(H, per_cell)), TC_MAX_HEADS)


def bwd_route(dtype: torch.dtype, Q: int, P: int, N: int) -> str:
    """Which B6 kernels serve a CUDA call: ``"wgmma"`` (``ssd_bwd_tc``, bf16
    on the tensor cores) for bf16 with ``Q <= 128``, ``P % 8 == 0``, ``P <=
    64`` and ``N <= 128``, else ``"simt"`` (``ssd_bwd``, CUDA cores)."""
    if (dtype == torch.bfloat16 and 0 < Q <= TC_MAX_Q and P % 8 == 0
            and 0 < P <= TC_MAX_P and 0 < N <= TC_MAX_N):
        return "wgmma"
    return "simt"


# ----------------------------------------------------------- plain versions
def _tile_terms(dtr, cum, Br, Cr):
    """f32 ``cb (B,nc,1,Q,Q)``, ``decay (B,nc,H,Q,Q)`` — ``exp(cum_i −
    cum_j)`` where ``j ≤ i``, 0 elsewhere, the exponent never taken above
    the diagonal — and ``dt`` as a row ``(B,nc,H,1,Q)``."""
    Q = cum.shape[-1]
    tril = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                 device=cum.device))
    seg = cum[..., :, None] - cum[..., None, :]                # cum_i - cum_j
    decay = torch.where(tril, torch.exp(torch.where(tril, seg, 0.0)), 0.0)
    cb = torch.matmul(Cr.float(), Br.float().transpose(-1, -2))
    return cb[:, :, None], decay, dtr.float().movedim(-1, -2)[..., None, :]


def fwd_plain(xr, dtr, cum, Br, Cr):
    """B5's plain version: ``y (B,nc,Q,H,P)`` in x's dtype from the f32
    ``cum = cumsum(ltT)`` ``(B,nc,H,Q)``."""
    cb, decay, dt = _tile_terms(dtr, cum, Br, Cr)
    att = cb * decay * dt                                      # (B,nc,H,Q,Q)
    y = torch.matmul(att, xr.float().movedim(3, 2))            # (B,nc,H,Q,P)
    return y.movedim(2, 3).to(xr.dtype).contiguous()


def bwd_plain(xr, dtr, cum, Br, Cr, g):
    """B6's plain version for the cotangent ``g`` (shaped like ``y``):
    ``(dx, ddt, dcum, dB, dC)`` with ``dx`` in x's layout and dtype, ``ddt``
    in dt's, ``dcum (B,nc,H,Q)`` f32 and ``dB / dC`` in B's / C's."""
    cb, decay, dt = _tile_terms(dtr, cum, Br, Cr)
    att = cb * decay * dt
    xh, gh = xr.float().movedim(3, 2), g.float().movedim(3, 2)
    datt = torch.matmul(gh, xh.transpose(-1, -2))              # g xᵀ
    dx = torch.matmul(att.transpose(-1, -2), gh)               # attᵀ g
    dad = datt * decay
    ddt = (dad * cb).sum(-2)                                   # over i
    dseg = dad * cb * dt                                       # through exp
    dcum = dseg.sum(-1) - dseg.sum(-2)                         # row - column
    dcb = (dad * dt).sum(2)                                    # over heads
    dB = torch.matmul(dcb.transpose(-1, -2), Cr.float())
    dC = torch.matmul(dcb, Br.float())
    return (dx.movedim(2, 3).to(xr.dtype).contiguous(),
            ddt.movedim(-1, -2).to(dtr.dtype).contiguous(), dcum,
            dB.to(Br.dtype), dC.to(Cr.dtype))


def dlt_from_dcum(dcum: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``cum = cumsum(ltT)`` ⇒ ``dltT`` is the suffix sum (the reversed
    cumsum) of ``dcum``."""
    return torch.flip(torch.cumsum(torch.flip(dcum, [-1]), -1),
                      [-1]).to(dtype)


# ------------------------------------------------------------------ wrappers
@functools.lru_cache(maxsize=None)
def _lib():
    """The built library with its C signatures declared (built at first
    use; raises where it cannot be)."""
    lib = _cuda.load("ssd_scan")
    P, I = ctypes.c_void_p, ctypes.c_int
    shape = [I] * 6 + [P]          # dtype, B·nc, Q, H, P, N, stream
    lib.ssd_fwd.argtypes = [P] * 6 + shape
    lib.ssd_bwd.argtypes = [P] * 12 + shape
    lib.ssd_bwd_tc.argtypes = [P] * 12 + shape[:-1] + [I, P]   # ..., G
    for fn in (lib.ssd_fwd, lib.ssd_bwd, lib.ssd_bwd_tc, lib.ssd_tile,
               lib.ssd_tc_max_heads, lib.ssd_tc_max_q):
        fn.restype = I
    if lib.ssd_tile() != TILE:
        raise RuntimeError("csrc/ssd_scan.cu tile size differs from TILE")
    if (lib.ssd_tc_max_heads(), lib.ssd_tc_max_q()) != (TC_MAX_HEADS,
                                                        TC_MAX_Q):
        raise RuntimeError("csrc/ssd_scan.cu ssd_bwd_tc limits differ from "
                           "TC_MAX_HEADS / TC_MAX_Q")
    return lib


def _check(name, xr, dtr, cum, Br, Cr, g=None):
    """Validate CUDA operands: one device, x / B / C (/ g) of one dtype in
    f32 or bf16, dt and cum f32, the JAX layouts, contiguous, P <= 128."""
    if xr.dim() != 5:
        raise ValueError(f"{name}: xr must be (B,nc,Q,H,P), got "
                         f"{tuple(xr.shape)}")
    B, nc, Q, H, P = xr.shape
    N = Br.shape[-1]
    want = {"dtr": (dtr, (B, nc, Q, H)), "ltT": (cum, (B, nc, H, Q)),
            "Br": (Br, (B, nc, Q, N)), "Cr": (Cr, (B, nc, Q, N))}
    if g is not None:
        want["g"] = (g, (B, nc, Q, H, P))
    for key, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {key} must be {shape}, got "
                             f"{tuple(t.shape)}")
    if not 0 < P <= MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {P} outside (0, {MAX_HEAD_DIM}]")
    model = [xr, Br, Cr] + ([g] if g is not None else [])
    if xr.dtype not in _DTYPES or any(t.dtype != xr.dtype for t in model):
        raise ValueError(f"{name}: x, B, C (and g) must share a dtype in "
                         f"{sorted(map(str, _DTYPES))}, got "
                         f"{[str(t.dtype) for t in model]}")
    if dtr.dtype != torch.float32 or cum.dtype != torch.float32:
        raise ValueError(f"{name}: dt and ltT must be float32, got "
                         f"{dtr.dtype}, {cum.dtype}")
    for t in model + [dtr, cum]:
        if t.device != xr.device:
            raise ValueError(f"{name}: operands on {t.device} and "
                             f"{xr.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    if xr.device.type != "cuda":
        raise RuntimeError(f"{name}: unsupported device {xr.device}")


def _shape_args(xr, Br):
    B, nc, Q, H, P = xr.shape
    return (_DTYPES[xr.dtype], B * nc, Q, H, P, Br.shape[-1],
            torch.cuda.current_stream(xr.device).cuda_stream)


def _cumsum(ltT: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(ltT, dim=-1).contiguous()


def ssd_intra_fwd(xr, dtr, ltT, Br, Cr):
    """B5, the counterpart of ``repro.kernels.ssd_scan.ssd_intra_pallas``.

    xr (B,nc,Q,H,P), dtr (B,nc,Q,H) f32, ltT (B,nc,H,Q) f32 per-step
    log-decay, Br / Cr (B,nc,Q,N) → y (B,nc,Q,H,P) in x's dtype."""
    cum = _cumsum(ltT)
    if xr.device.type == "cpu":
        return fwd_plain(xr, dtr, cum, Br, Cr)
    _check("ssd_intra_fwd", xr, dtr, cum, Br, Cr)
    y = torch.empty_like(xr)
    if y.numel():
        with torch.cuda.device(xr.device):
            _cuda.call(_lib().ssd_fwd, xr.data_ptr(), dtr.data_ptr(),
                       cum.data_ptr(), Br.data_ptr(), Cr.data_ptr(),
                       y.data_ptr(), *_shape_args(xr, Br))
        ssd_intra_fwd.launches += 1
    return y


ssd_intra_fwd.launches = 0


def ssd_intra_bwd(xr, dtr, ltT, Br, Cr, g, route=None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor, torch.Tensor]:
    """B6, the counterpart of
    ``repro.kernels.ssd_scan.ssd_intra_bwd_pallas``: the backward of
    :func:`ssd_intra_fwd` for the cotangent ``g`` (shaped like ``y``).
    Returns ``(dxr, ddtr, dltT, dBr, dCr)`` in the input layouts and
    dtypes.  One B6 launch is a pair of kernels: on the route
    :func:`bwd_route` picks (or ``route``, ``"wgmma"`` / ``"simt"``, to hold
    one against the other), ``ssd_bwd_tc`` (per group of heads, with
    dltT, the suffix sum of dcum, formed in the kernel; then the
    partitioned head sum into dB / dC) or ``ssd_bwd`` (per head, then the
    head sum; dltT taken here by :func:`dlt_from_dcum`)."""
    cum = _cumsum(ltT)
    if xr.device.type == "cpu":
        dx, ddt, dcum, dB, dC = bwd_plain(xr, dtr, cum, Br, Cr, g)
        return dx, ddt, dlt_from_dcum(dcum, ltT.dtype), dB, dC
    _check("ssd_intra_bwd", xr, dtr, cum, Br, Cr, g)
    B, nc, Q, H, P = xr.shape
    N = Br.shape[-1]
    want = bwd_route(xr.dtype, Q, P, N)
    route = want if route is None else route
    if route not in ("wgmma", "simt") or (route == "wgmma"
                                          and want != "wgmma"):
        raise ValueError(f"ssd_intra_bwd: route {route!r} does not take "
                         f"{xr.dtype} at Q {Q}, P {P}, N {N}")
    tc = route == "wgmma"
    if tc and (xr.data_ptr() % 16 or g.data_ptr() % 16):
        raise ValueError("ssd_intra_bwd: the bf16 kernel reads x and g by "
                         "TMA, which needs 16-byte-aligned tensors")
    dx, ddt = torch.empty_like(xr), torch.empty_like(dtr)
    # dcum on the CUDA cores, dltT itself on the tensor cores
    dl = torch.empty((B, nc, H, Q), dtype=torch.float32, device=xr.device)
    dB, dC = torch.empty_like(Br), torch.empty_like(Cr)
    # the head sum's scratch, summed in a fixed order by the second kernel
    # (no float atomics: every launch is bit-reproducible): per group of G
    # heads on the tensor cores, per head on the CUDA cores
    G = head_groups(B * nc, H) if tc else 1
    dcb = torch.empty((B * nc, -(-H // G), Q, Q), dtype=torch.float32,
                      device=xr.device)
    if dx.numel():
        args = (xr.data_ptr(), dtr.data_ptr(), cum.data_ptr(),
                Br.data_ptr(), Cr.data_ptr(), g.data_ptr(), dx.data_ptr(),
                ddt.data_ptr(), dl.data_ptr(), dB.data_ptr(), dC.data_ptr(),
                dcb.data_ptr())
        shape = _shape_args(xr, Br)
        with _cuda.on(xr.device):
            if tc:
                _cuda.call(_lib().ssd_bwd_tc, *args, *shape[:-1], G,
                           shape[-1])
            else:
                _cuda.call(_lib().ssd_bwd, *args, *shape)
        ssd_intra_bwd.launches += 1
        ssd_intra_bwd.launches_tc += tc
        ssd_intra_bwd.scratch_bytes = dcb.numel() * dcb.element_size()
    elif tc:
        dl.zero_()
    return dx, ddt, dl if tc else dlt_from_dcum(dl, ltT.dtype), dB, dC


ssd_intra_bwd.launches = 0        # every launch of B6
ssd_intra_bwd.launches_tc = 0     # those on the tensor cores (ssd_bwd_tc)
ssd_intra_bwd.scratch_bytes = 0   # the last launch's head-sum scratch
