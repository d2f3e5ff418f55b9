"""Flash attention (forward, backward dq, backward dk/dv) on Hopper.

Replaces ``repro/kernels/flash_attention.py``: the Pallas TPU kernels
``_fa_kernel`` (B2), ``_fa_bwd_dq_kernel`` (B3) and ``_fa_bwd_dkv_kernel``
(B4) become the hand-written CUDA C++ kernels of
``kernels/csrc/flash_attention.cu`` (its header note says what they compute,
what bounds them on an H100 and what the design does about it), built with
``nvcc`` at first use and called through ``ctypes``
(:mod:`repro_torch.kernels._cuda`).

Three wrappers, one per TPU kernel, each with the JAX package's layouts
(``q (B,Sq,Hq,hd)``, ``k/v (B,Sk,Hkv,hd)``, ``lse``/``delta`` ``(B,Hq,Sq)``
f32) and a plain integer ``launches`` counter:

* :func:`flash_attention_fwd` (B2) — ``out``, optionally ``lse`` and the
  executed-tile count.  It routes by dtype (:func:`fwd_route`): bf16 goes
  to ``fa_fwd_tc``, the tensor-core kernel (``wgmma`` over TMA-fed tiles of
  128 × 128, counted also in ``flash_attention_fwd.launches_tc``), f32 to
  ``fa_fwd``, the CUDA-core kernel of 64 × 64 tiles;
* :func:`flash_attention_bwd_dq` (B3) — ``dq``;
* :func:`flash_attention_bwd_dkv` (B4) — per-query-head ``dk_h, dv_h``
  ``(B,Sk,Hq,hd)`` in the k / v dtype.

B3 and B4 route by dtype too (:func:`bwd_route`): bf16 goes to
``fa_bwd_dq_tc`` / ``fa_bwd_dkv_tc``, tensor-core kernels (``wgmma`` over
TMA-fed tiles: B3 128 query rows × 128 keys, B4 128 keys × 64 query rows,
counted also in ``launches_tc``), f32 to ``fa_bwd_dq`` / ``fa_bwd_dkv`` on
the CUDA cores.  The tensor-core backward rounds ``P`` (for dv) and ``dS``
(for dk, dq) to bf16 before its products, as the library's flash backward
does; the plain versions keep them in f32.

:func:`flash_attention_bwd` is the JAX function's counterpart: ``delta =
rowsum(dO·O)`` in torch, B3, B4, then the GQA group sum in torch.  Beside
each kernel is its plain PyTorch version on whole matrices
(:func:`fwd_plain`, :func:`bwd_dq_plain`, :func:`bwd_dkv_plain`).  A wrapper
takes the plain version only for tensors that lie on the CPU; on a CUDA
tensor it launches its kernel or raises.

Tiles are 64 × 64 (``BLOCK_Q``, ``BLOCK_K``) on the CUDA cores; the bf16
kernels' are ``FWD_BLOCK_*`` (:func:`fwd_blocks`), ``DQ_BLOCK_*`` (B3)
and ``DKV_BLOCK_*`` (B4).  The TPU kernel's
``pl.when(_tile_live)`` skip becomes loop bounds in the CUDA kernels;
:func:`_live_range` mirrors those bounds here, and the tests hold
them against :func:`_tile_live`.  The executed-tile count is one int32 per
block, summed on demand (``count_tiles=True``); the plain version reports
the same count from :func:`fa_tile_counts` at the tile sizes of the kernel
its dtype routes to, so the result does not depend on the device.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.ref import attention_mask

__all__ = ["flash_attention_fwd", "flash_attention_bwd",
           "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
           "fwd_plain", "bwd_dq_plain", "bwd_dkv_plain", "fa_tile_counts",
           "fwd_route", "fwd_blocks", "bwd_route", "BLOCK_Q", "BLOCK_K", "FWD_BLOCK_Q", "FWD_BLOCK_K", "DQ_BLOCK_Q",
           "DQ_BLOCK_K", "DKV_BLOCK_Q", "DKV_BLOCK_K", "NEG_INF",
           "LSE_EMPTY"]

NEG_INF = -1e30
# LSE filler for rows that saw no valid key (and for padded Q rows in the
# backward): exp(s - BIG) == 0 for any finite tile score s.
LSE_EMPTY = 1e30
BLOCK_Q = 64          # must equal BQ / BK in csrc/flash_attention.cu
BLOCK_K = 64
FWD_BLOCK_Q = 128     # bf16 forward: must equal TC_BQ / TC_BK there
FWD_BLOCK_K = 128
DQ_BLOCK_Q = 128      # bf16 B3 (fa_bwd_dq_tc): query rows x keys
DQ_BLOCK_K = 128
DKV_BLOCK_Q = 64      # bf16 B4 (fa_bwd_dkv_tc): DKV_BQ x TC_BK there
DKV_BLOCK_K = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# ------------------------------------------------------------ tile liveness
def _tile_live(qi: int, ki: int, *, causal: bool, window: int, bq: int,
               bk: int, seq_k: int) -> bool:
    """Does tile (qi, ki) contain any unmasked entry?  (The JAX package's
    predicate, on plain integers.)"""
    first_q = qi * bq
    last_q = first_q + bq - 1
    first_k = ki * bk
    last_k = first_k + bk - 1
    dead = first_k >= seq_k
    if causal:
        dead = dead or first_k > last_q
    if window > 0:
        dead = dead or last_k <= first_q - window
    return not dead


def fa_tile_counts(Sq: int, Sk: int, bq: int, bk: int, causal: bool,
                   window: int) -> Tuple[int, int]:
    """Analytic (executed, skipped) tile counts per (batch, head) for the
    skip predicate — the oracle of the executed-tile count."""
    nq = -(-Sq // bq)
    nk = -(-Sk // bk)
    executed = sum(_tile_live(qi, ki, causal=causal, window=window, bq=bq,
                              bk=bk, seq_k=Sk)
                   for qi in range(nq) for ki in range(nk))
    return executed, nq * nk - executed


def _live_range(tile: int, n_other: int, *, kv_loop: bool, causal: bool,
                window: int, bq: int = BLOCK_Q, bk: int = BLOCK_K
                ) -> Tuple[int, int]:
    """Loop bounds ``[lo, hi]`` of the CUDA kernels: the live kv tiles of
    q-tile ``tile`` (``kv_loop``: forward, dq) or the live q tiles of
    kv-tile ``tile`` (dk/dv).  Mirrors ``kv_range`` / ``q_range`` in
    ``csrc/flash_attention.cu`` line for line."""
    lo, hi = 0, n_other - 1
    if kv_loop:
        first_q = tile * bq
        if causal:
            hi = min(hi, (first_q + bq - 1) // bk)
        if window > 0:
            x = first_q - window + 2 - bk
            if x > 0:
                lo = (x + bk - 1) // bk
    else:
        first_k = tile * bk
        if causal:
            x = first_k - bq + 1
            if x > 0:
                lo = (x + bq - 1) // bq
        if window > 0:
            hi = min(hi, (first_k + bk - 1 + window - 1) // bq)
    return lo, hi


def _route(name: str, dtype: torch.dtype, hd: int) -> str:
    if dtype == torch.bfloat16:
        if hd % 8:
            raise ValueError(f"{name}: bf16 head dim {hd} is not a multiple "
                             f"of 8, so TMA cannot address its rows (their "
                             f"stride H*hd*2 bytes must be a multiple of 16)")
        if not 0 < hd <= 128:
            raise ValueError(f"{name}: bf16 head dim {hd} outside (0, 128]")
        return "wgmma"
    return "simt"


def fwd_route(dtype: torch.dtype, hd: int) -> str:
    """Which B2 kernel serves a CUDA call: ``"wgmma"`` (``fa_fwd_tc``, bf16
    on the tensor cores) or ``"simt"`` (``fa_fwd``, f32 on the CUDA cores).
    Raises ``ValueError`` for a bf16 head dim that TMA cannot address
    (``hd % 8``: the row stride ``H·hd·2`` bytes must be a multiple of 16) or
    that the kernel does not hold (``hd > 128``)."""
    return _route("flash_attention_fwd", dtype, hd)


def bwd_route(dtype: torch.dtype, hd: int) -> str:
    """Which B3 / B4 kernels serve a CUDA call: ``"wgmma"``
    (``fa_bwd_dq_tc`` / ``fa_bwd_dkv_tc``, bf16 on the tensor cores) or
    ``"simt"`` (``fa_bwd_dq`` / ``fa_bwd_dkv``, f32 on the CUDA cores); it
    refuses what :func:`fwd_route` refuses, never dropping a bf16 call to
    the CUDA-core kernels."""
    return _route("flash_attention_bwd", dtype, hd)


def fwd_blocks(dtype: torch.dtype) -> Tuple[int, int]:
    """(query, key) tile sizes of the B2 kernel that ``dtype`` routes to."""
    if dtype == torch.bfloat16:
        return FWD_BLOCK_Q, FWD_BLOCK_K
    return BLOCK_Q, BLOCK_K


# ----------------------------------------------------------- plain versions
def _heads(x, group=1):
    """(B,S,H,hd) -> f32 (B,H·group,S,hd), each head repeated ``group``
    times (query head h reads KV head h // group)."""
    return x.float().permute(0, 2, 1, 3).repeat_interleave(group, dim=1)


def _scores(q, k, scale):
    """f32 scores (B,Hq,Sq,Sk) of q (B,Sq,Hq,hd) against k (B,Sk,Hkv,hd)."""
    kh = _heads(k, q.shape[2] // k.shape[2])
    return torch.matmul(_heads(q), kh.transpose(-1, -2)) * scale


def fwd_plain(q, k, v, *, causal: bool = True, window: int = 0):
    """B2's plain version on whole matrices: ``(out, lse, tiles)`` with
    ``tiles`` the count of executed tiles (Python int) at the tile sizes of
    the kernel that q's dtype routes to (:func:`fwd_blocks`).  For a bf16
    ``v`` the probabilities are rounded to bf16 before the product with v,
    as the tensor-core kernel does; ``l`` sums the f32 probabilities."""
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    s = _scores(q, k, hd ** -0.5)
    mask = attention_mask(Sq, Sk, causal, window, q.device)
    m = s.masked_fill(~mask, NEG_INF).amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    empty = l == 0.0
    pv = p.to(torch.bfloat16).float() if v.dtype == torch.bfloat16 else p
    acc = torch.matmul(pv, _heads(v, Hq // Hkv))
    out = torch.where(empty, 0.0, acc / torch.where(empty, 1.0, l))
    lse = torch.where(empty, LSE_EMPTY,
                      m + torch.log(torch.where(empty, 1.0, l)))[..., 0]
    tiles = B * Hq * fa_tile_counts(Sq, Sk, *fwd_blocks(q.dtype), causal,
                                    window)[0]
    return out.permute(0, 2, 1, 3).to(q.dtype).contiguous(), lse, tiles


def _probs_and_ds(q, k, v, lse, delta, do, causal, window):
    """The FA2 recompute on whole matrices: ``p = exp(s - lse)`` (0 where
    masked) and ``ds = p (dO·vᵀ - delta) scale``, f32 (B,Hq,Sq,Sk)."""
    Sq, Hq, hd = q.shape[1], q.shape[2], q.shape[3]
    Sk, Hkv = k.shape[1], k.shape[2]
    scale = hd ** -0.5
    s = _scores(q, k, scale)
    mask = attention_mask(Sq, Sk, causal, window, q.device)
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.matmul(_heads(do), _heads(v, Hq // Hkv).transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * scale
    return p, ds


def bwd_dq_plain(q, k, v, do, lse, delta, *, causal: bool = True,
                 window: int = 0):
    """B3's plain version: ``dq (B,Sq,Hq,hd)`` in q's dtype."""
    _, ds = _probs_and_ds(q, k, v, lse, delta, do, causal, window)
    dq = torch.matmul(ds, _heads(k, q.shape[2] // k.shape[2]))
    return dq.permute(0, 2, 1, 3).to(q.dtype).contiguous()


def bwd_dkv_plain(q, k, v, do, lse, delta, *, causal: bool = True,
                  window: int = 0):
    """B4's plain version: per-query-head ``dk_h, dv_h (B,Sk,Hq,hd)`` in
    the k / v dtypes."""
    p, ds = _probs_and_ds(q, k, v, lse, delta, do, causal, window)
    dv_h = torch.matmul(p.transpose(-1, -2), _heads(do))
    dk_h = torch.matmul(ds.transpose(-1, -2), _heads(q))
    return (dk_h.permute(0, 2, 1, 3).to(k.dtype).contiguous(),
            dv_h.permute(0, 2, 1, 3).to(v.dtype).contiguous())


# ------------------------------------------------------------------ wrappers
@functools.lru_cache(maxsize=None)
def _lib():
    """The built library with its C signatures declared (built at first
    use; raises where it cannot be)."""
    lib = _cuda.load("flash_attention")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # dtype, B, Sq, Sk, Hq, Hkv, hd, causal, window, scale, stream
    shape = [I] * 9 + [F, P]
    lib.fa_fwd.argtypes = [P] * 6 + shape
    lib.fa_fwd_tc.argtypes = [P] * 6 + shape
    lib.fa_bwd_dq.argtypes = [P] * 7 + shape
    lib.fa_bwd_dq_tc.argtypes = [P] * 7 + shape
    lib.fa_bwd_dkv.argtypes = [P] * 8 + shape
    lib.fa_bwd_dkv_tc.argtypes = [P] * 8 + shape
    tiles = {("fa_block_q", "fa_block_k"): (BLOCK_Q, BLOCK_K),
             ("fa_fwd_block_q", "fa_fwd_block_k"): (FWD_BLOCK_Q, FWD_BLOCK_K),
             ("fa_dq_tc_block_q", "fa_dq_tc_block_k"): (DQ_BLOCK_Q,
                                                        DQ_BLOCK_K),
             ("fa_dkv_tc_block_q", "fa_dkv_tc_block_k"): (DKV_BLOCK_Q,
                                                          DKV_BLOCK_K)}
    for fn in (lib.fa_fwd, lib.fa_fwd_tc, lib.fa_bwd_dq, lib.fa_bwd_dq_tc,
               lib.fa_bwd_dkv, lib.fa_bwd_dkv_tc):
        fn.restype = I
    for names, want in tiles.items():
        for n in names:
            getattr(lib, n).argtypes, getattr(lib, n).restype = [], I
        got = tuple(getattr(lib, n)() for n in names)
        if got != want:
            raise RuntimeError(f"csrc/flash_attention.cu tile sizes {names} "
                               f"= {got} differ from the module's {want}")
    return lib


def _check(name, q, k, v, do=None, lse=None, delta=None):
    """Validate CUDA operands: one device, f32 or bf16, contiguous
    (B,S,H,hd) layouts, hd <= 128, Hq a multiple of Hkv; for the backward
    also dO shaped and typed like q, lse and delta (B,Hq,Sq) f32."""
    B, Sq, Hq, hd = q.shape
    if k.dim() != 4 or v.shape != k.shape or k.shape[0] != B \
            or k.shape[3] != hd:
        raise ValueError(f"{name}: k/v must be (B,Sk,Hkv,{hd}), got "
                         f"{tuple(k.shape)} / {tuple(v.shape)}")
    if Hq % k.shape[2]:
        raise ValueError(f"{name}: Hq={Hq} is not a multiple of "
                         f"Hkv={k.shape[2]}")
    if not 0 < hd <= 128:
        raise ValueError(f"{name}: head dim {hd} outside (0, 128]")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: q, k, v must share a dtype in "
                         f"{sorted(map(str, _DTYPES))}, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    rest = [t for t in (do, lse, delta) if t is not None]
    if do is not None and (do.shape != q.shape or do.dtype != q.dtype):
        raise ValueError(f"{name}: dO must match q's shape and dtype")
    for t in rest[1:]:
        if t.shape != (B, Hq, Sq) or t.dtype != torch.float32:
            raise ValueError(f"{name}: lse / delta must be ({B},{Hq},{Sq}) "
                             f"float32, got {tuple(t.shape)} {t.dtype}")
    for t in [q, k, v] + rest:
        if t.device != q.device:
            raise ValueError(f"{name}: operands on {t.device} and {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    if q.device.type != "cuda":
        raise RuntimeError(f"{name}: unsupported device {q.device}")


def _shape_args(q, k, causal, window):
    B, Sq, Hq, hd = q.shape
    # the current stream's handle, without building a Stream object
    return (_DTYPES[q.dtype], B, Sq, k.shape[1], Hq, k.shape[2], hd,
            int(bool(causal)), int(window), hd ** -0.5,
            torch._C._cuda_getCurrentRawStream(q.device.index))


def _tma_check(name, q, k, *tensors):
    """The tensor-core kernels read their operands by TMA, which needs a
    non-empty sequence on each side and 16-byte-aligned tensors."""
    if q.shape[1] == 0 or k.shape[1] == 0 or any(
            t.data_ptr() % 16 for t in (q, k) + tensors):
        raise ValueError(f"{name}: the bf16 kernel reads its operands by "
                         f"TMA, which needs Sq, Sk > 0 and 16-byte-aligned "
                         f"tensors")


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0,
                        return_lse: bool = False, count_tiles: bool = False):
    """B2.  q: (B, Sq, Hq, hd); k, v: (B, Sk, Hkv, hd) → out (B, Sq, Hq, hd)
    in q's dtype; with ``return_lse`` also ``lse`` (B, Hq, Sq) f32; with
    ``count_tiles`` also the number of executed tiles (an int; reading it
    waits for the kernel).  On a CUDA tensor bf16 launches the tensor-core
    kernel and f32 the CUDA-core one (:func:`fwd_route`)."""
    if q.device.type == "cpu":
        out, lse, tiles = fwd_plain(q, k, v, causal=causal, window=window)
    else:
        _check("flash_attention_fwd", q, k, v)
        B, Sq, Hq, hd = q.shape
        tc = fwd_route(q.dtype, hd) == "wgmma"
        out = torch.empty_like(q)
        lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
        slots = torch.empty((B, Hq, -(-Sq // fwd_blocks(q.dtype)[0])),
                            dtype=torch.int32, device=q.device) \
            if count_tiles else None       # the kernel counts only if asked
        if out.numel():
            if tc:
                _tma_check("flash_attention_fwd", q, k, v)
            fn = _lib().fa_fwd_tc if tc else _lib().fa_fwd
            with _cuda.on(q.device):
                _cuda.call(fn, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           out.data_ptr(), lse.data_ptr(),
                           slots.data_ptr() if count_tiles else None,
                           *_shape_args(q, k, causal, window))
            flash_attention_fwd.launches += 1
            flash_attention_fwd.launches_tc += tc
        tiles = int(slots.sum(dtype=torch.int64)) if count_tiles else None
    res = (out,)
    if return_lse:
        res += (lse,)
    if count_tiles:
        res += (tiles,)
    return res if len(res) > 1 else out


flash_attention_fwd.launches = 0      # every launch of B2
flash_attention_fwd.launches_tc = 0   # those of the tensor-core kernel


def flash_attention_bwd_dq(q, k, v, do, lse, delta, *, causal: bool = True,
                           window: int = 0):
    """B3: dq (B, Sq, Hq, hd) in q's dtype, from the forward's ``lse`` and
    ``delta = rowsum(dO·O)`` (both (B, Hq, Sq) f32).  On a CUDA tensor bf16
    launches the tensor-core kernel and f32 the CUDA-core one
    (:func:`bwd_route`)."""
    if q.device.type == "cpu":
        return bwd_dq_plain(q, k, v, do, lse, delta, causal=causal,
                            window=window)
    _check("flash_attention_bwd_dq", q, k, v, do, lse, delta)
    tc = bwd_route(q.dtype, q.shape[3]) == "wgmma"
    dq = torch.empty_like(q)
    if dq.numel():
        if tc:
            _tma_check("flash_attention_bwd_dq", q, k, v, do)
        fn = _lib().fa_bwd_dq_tc if tc else _lib().fa_bwd_dq
        with _cuda.on(q.device):
            _cuda.call(fn, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                       dq.data_ptr(), *_shape_args(q, k, causal, window))
        flash_attention_bwd_dq.launches += 1
        flash_attention_bwd_dq.launches_tc += tc
    return dq


flash_attention_bwd_dq.launches = 0      # every launch of B3
flash_attention_bwd_dq.launches_tc = 0   # those of the tensor-core kernel


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool = True,
                            window: int = 0):
    """B4: per-query-head dk_h, dv_h (B, Sk, Hq, hd) in the k / v dtype;
    the caller sums each GQA group onto its KV head.  Routed as B3."""
    if q.device.type == "cpu":
        return bwd_dkv_plain(q, k, v, do, lse, delta, causal=causal,
                             window=window)
    _check("flash_attention_bwd_dkv", q, k, v, do, lse, delta)
    B, Sk, Hq, hd = k.shape[0], k.shape[1], q.shape[2], q.shape[3]
    tc = bwd_route(q.dtype, hd) == "wgmma"
    dk_h = torch.empty((B, Sk, Hq, hd), dtype=k.dtype, device=k.device)
    dv_h = torch.empty_like(dk_h)
    if dk_h.numel():
        if tc:
            _tma_check("flash_attention_bwd_dkv", q, k, v, do)
        fn = _lib().fa_bwd_dkv_tc if tc else _lib().fa_bwd_dkv
        with _cuda.on(q.device):
            _cuda.call(fn, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                       dk_h.data_ptr(), dv_h.data_ptr(),
                       *_shape_args(q, k, causal, window))
        flash_attention_bwd_dkv.launches += 1
        flash_attention_bwd_dkv.launches_tc += tc
    return dk_h, dv_h


flash_attention_bwd_dkv.launches = 0      # every launch of B4
flash_attention_bwd_dkv.launches_tc = 0   # those of the tensor-core kernel


def flash_attention_bwd(q, k, v, out, lse, do, *, causal: bool = True,
                        window: int = 0):
    """FA2 recompute backward.  Residuals: ``out`` (B, Sq, Hq, hd) and
    ``lse`` (B, Hq, Sq) from the forward.  Returns (dq, dk, dv) in the
    input layouts and dtypes: ``delta`` in torch, B3, B4, then each GQA
    group's per-query-head dk / dv — rounded to the input dtype first, as
    in the JAX package — summed onto its KV head."""
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=causal,
                                window=window)
    dk_h, dv_h = flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                         causal=causal, window=window)
    group = Hq // Hkv
    dk = dk_h.view(B, Sk, Hkv, group, hd).sum(3).to(k.dtype)
    dv = dv_h.view(B, Sk, Hkv, group, hd).sum(3).to(v.dtype)
    return dq, dk, dv
