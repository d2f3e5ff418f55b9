"""Mamba2 — the state-space duality (SSD) layer (Dao & Gu, arXiv:2405.21060).

The training half of ``repro/models/ssm.py``: the same parameter tree,
the same chunked algorithm and the same dtype rules.  Per head ``h`` with
scalar decay ``A_h < 0``::

    state_t = exp(dt_t A) state_{t-1} + dt_t · B_t ⊗ x_t      (N×P state)
    y_t     = C_t · state_t + D ⊙ x_t

computed in chunks of ``Q`` steps: a quadratic, attention-like
intra-chunk term (``use_kernel=True`` routes it through
:func:`repro_torch.kernels.ops.ssd_intra`, kernels B5 and B6) and a
rank-1 state hand-off between chunks.  A float32 model's cumulative
log-decays are summed in float64: a chunk's sum reaches about −1,000 at
mamba2-2.7b's shapes, where a float32 ulp is 6e-5, so every exponent
``cum_i − cum_j`` formed from float32 sums is off by that much, and the
gradients of the log-decays, differences of such sums, lose most of their
bits.  Each exponent is formed in float64 and rounded once; the rest
stays in the model's dtype.  A bfloat16 model keeps its float32 sums,
which its own rounding hides.  The JAX ``lax.scan`` over chunks
becomes a Python loop over the ``nc`` chunks, plain torch as in the
reference; the depthwise causal conv stays a sum of shifted products, as
in the reference (no kernel there either).  B and C are shared across
heads (``ngroups=1``).

Decode (``init_ssm_cache`` / ``ssm_decode``) is the reference's O(1)
recurrence: the state updated in f32 and stored back in the cache's dtype,
the conv's left context carried; both are written into the cache in
place.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, init_rms, rms_norm
from repro_torch.utils import tracing

__all__ = ["init_ssm", "ssm_forward", "ssm_decode", "init_ssm_cache",
           "ssd_chunked", "ssd_sequential"]


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------


def _segsum(lt: torch.Tensor) -> torch.Tensor:
    """lt: (..., Q) per-step log-decays → (..., Q, Q) matrix
    ``M[i, j] = sum(lt[j+1..i])`` for j ≤ i, -inf above the diagonal."""
    Q = lt.shape[-1]
    cs = torch.cumsum(lt, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]          # cum_i - cum_j
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=lt.device))
    return torch.where(mask, diff, float("-inf"))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None,
                use_kernel: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    x  (B,S,H,P)   dt (B,S,H)   A (H,)   Bm,Cm (B,S,N)  (shared over heads)
    Returns (y (B,S,H,P), final_state (B,H,P,N)).
    """
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    if S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"chunk {chunk}")
    nc, Q = S // chunk, chunk

    xr = x.reshape(Bsz, nc, Q, H, P)
    dtr = dt.reshape(Bsz, nc, Q, H)
    Br = Bm.reshape(Bsz, nc, Q, N)
    Cr = Cm.reshape(Bsz, nc, Q, N)

    lt = dtr * A                                         # (B,nc,Q,H) log-decay
    ltT = lt.movedim(-1, -2)                             # (B,nc,H,Q)
    wide = ltT.double() if x.dtype == torch.float32 else ltT
    cum = torch.cumsum(wide, dim=-1)                     # (B,nc,H,Q)
    dtT = dtr.movedim(-1, -2)                            # (B,nc,H,Q)

    if use_kernel:
        from repro_torch.kernels import ops as kops
        y_intra = kops.ssd_intra(xr, dtr, ltT, Br, Cr)
    else:
        # ---- intra-chunk (quadratic in Q): att[i,j] = (C_i·B_j)·exp(seg)·dt_j
        seg = _segsum(wide).to(ltT.dtype)                # (B,nc,H,Q,Q)
        cb = torch.einsum("bcin,bcjn->bcij", Cr, Br)     # (B,nc,Q,Q)
        att = cb[:, :, None] * torch.exp(seg) * dtT[..., None, :]
        y_intra = torch.einsum("bchij,bcjhp->bcihp", att.to(x.dtype), xr)

    # ---- per-chunk end state: sum_j exp(cum_Q - cum_j) dt_j B_j ⊗ x_j
    decay_to_end = torch.exp((cum[..., -1:] - cum).to(ltT.dtype))
    w = dtT * decay_to_end                               # (B,nc,H,Q)
    chunk_states = torch.einsum("bchq,bcqn,bcqhp->bchpn",
                                w.to(x.dtype), Br, xr)   # (B,nc,H,P,N)
    total_decay = torch.exp(cum[..., -1].to(ltT.dtype))  # (B,nc,H)

    # ---- inter-chunk recurrence over nc chunks
    s = (torch.zeros((Bsz, H, P, N), dtype=x.dtype, device=x.device)
         if init_state is None else init_state.to(x.dtype))
    prev = []
    for c in range(nc):
        prev.append(s)
        s = s * total_decay[:, c, :, None, None].to(x.dtype) \
            + chunk_states[:, c]
    prev_states = torch.stack(prev, dim=1)               # (B,nc,H,P,N)

    # ---- inter-chunk output: y_inter[i] = exp(cum_i) · C_i @ S_prev
    dec_in = torch.exp(cum.to(ltT.dtype))                # (B,nc,H,Q)
    y_inter = torch.einsum("bcqn,bchpn,bchq->bcqhp", Cr, prev_states,
                           dec_in.to(x.dtype))
    y = (y_intra + y_inter).reshape(Bsz, S, H, P)
    return y, s


def ssd_sequential(x, dt, A, Bm, Cm, init_state=None):
    """Step-by-step oracle for tests (O(S) sequential scan, f32)."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    h = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    ys = []
    for t in range(S):
        x_t, dt_t = x[:, t].float(), dt[:, t]            # (B,H,P), (B,H)
        B_t, C_t = Bm[:, t].float(), Cm[:, t].float()    # (B,N)
        dA = torch.exp(dt_t * A)                         # (B,H)
        h = h * dA[..., None, None] + torch.einsum(
            "bhp,bn->bhpn", x_t * dt_t[..., None], B_t)
        ys.append(torch.einsum("bhpn,bn->bhp", h, C_t))
    return torch.stack(ys, dim=1).to(x.dtype), h.to(x.dtype)


# ---------------------------------------------------------------------------
# full block
# ---------------------------------------------------------------------------


def init_ssm(cfg: ModelConfig, gen: torch.Generator,
             dtype: torch.dtype) -> Dict[str, Any]:
    """The reference's tree: separate projections (z, x, B, C, dt) and a
    depthwise conv per stream; ``A_log`` and ``dt_bias`` stay f32 whatever
    the model dtype.  The JAX package's distributions, not its bits."""
    D, inner, N, H = cfg.d_model, cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads
    K = cfg.ssm_conv

    def conv(width):
        t = torch.randn((K, width), generator=gen, dtype=torch.float32)
        return (t * K ** -0.5).to(dtype)

    in_z = dense_init(gen, (D, inner), dtype=dtype)
    in_x = dense_init(gen, (D, inner), dtype=dtype)
    in_B = dense_init(gen, (D, N), dtype=dtype)
    in_C = dense_init(gen, (D, N), dtype=dtype)
    in_dt = dense_init(gen, (D, H), dtype=dtype)
    return {
        "in_z": in_z, "in_x": in_x, "in_B": in_B, "in_C": in_C,
        "in_dt": in_dt,
        "conv_x": conv(inner), "conv_B": conv(N), "conv_C": conv(N),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H)).float(),
        "D": torch.ones((H,), dtype=dtype),
        "dt_bias": torch.zeros((H,), dtype=torch.float32),
        "gate_norm": init_rms(inner, dtype),
        "out_proj": dense_init(gen, (inner, D), dtype=dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv. x (B,S,C), w (K,C).  ``state`` (B,K-1,C) is the
    carried left context; returns (y, new_state)."""
    K = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                      # (B,S+K-1,C)
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(K))
    new_state = xp[:, -(K - 1):] if K > 1 else None
    return y, new_state


def _ssm_project(params, cfg: ModelConfig, x: torch.Tensor,
                 conv_state=None):
    """Project and run the causal conv per stream; returns
    (z, xs, Bm, Cm, dt_raw, new_conv_state)."""
    z = x @ params["in_z"]
    xs = x @ params["in_x"]
    Bm = x @ params["in_B"]
    Cm = x @ params["in_C"]
    dt_raw = x @ params["in_dt"]
    cs = conv_state or {}
    xs, s_x = _causal_conv(xs, params["conv_x"], cs.get("x"))
    Bm, s_B = _causal_conv(Bm, params["conv_B"], cs.get("B"))
    Cm, s_C = _causal_conv(Cm, params["conv_C"], cs.get("C"))
    xs, Bm, Cm = F.silu(xs), F.silu(Bm), F.silu(Cm)
    return z, xs, Bm, Cm, dt_raw, {"x": s_x, "B": s_B, "C": s_C}


def _ssm_post(params, cfg: ModelConfig, y, z, x_in):
    H, P = cfg.ssm_heads, cfg.ssm_head_dim
    y = y + x_in * params["D"][None, None, :, None].to(y.dtype)
    y = y.reshape(*y.shape[:-2], H * P)
    y = rms_norm(y * F.silu(z), params["gate_norm"], cfg.norm_eps)
    return y @ params["out_proj"]


def ssm_forward(params, cfg: ModelConfig, x: torch.Tensor,
                use_kernel: bool = False) -> torch.Tensor:
    """x: (B,S,D) → (B,S,D)."""
    B, S, _ = x.shape
    H, P = cfg.ssm_heads, cfg.ssm_head_dim
    z, xs, Bm, Cm, dt_raw, _ = _ssm_project(params, cfg, x)
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    xh = xs.reshape(B, S, H, P)
    with tracing.span("train.ssd_scan"):
        y, _ = ssd_chunked(xh, dt, A, Bm, Cm, cfg.ssm_chunk,
                           use_kernel=use_kernel)
    return _ssm_post(params, cfg, y, z, xh)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                   device=None) -> Dict[str, Any]:
    inner, N, K = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_conv
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    return {"state": zeros(batch, cfg.ssm_heads, cfg.ssm_head_dim, N),
            "conv": {"x": zeros(batch, K - 1, inner),
                     "B": zeros(batch, K - 1, N),
                     "C": zeros(batch, K - 1, N)}}


def ssm_decode(params, cfg: ModelConfig, x: torch.Tensor, cache
               ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One-token decode: x (B,1,D) → (B,1,D); O(1) state update, written
    into ``cache`` in place.  Returns (out, ``cache``)."""
    B = x.shape[0]
    H, P = cfg.ssm_heads, cfg.ssm_head_dim
    z, xs, Bm, Cm, dt_raw, conv_state = _ssm_project(params, cfg, x,
                                                     cache["conv"])
    dt = F.softplus(dt_raw.float() + params["dt_bias"])         # (B,1,H)
    A = -torch.exp(params["A_log"])
    xh = xs.reshape(B, 1, H, P)

    dA = torch.exp(dt[:, 0] * A)                                # (B,H)
    state = cache["state"].float()
    state = (state * dA[..., None, None]
             + torch.einsum("bhp,bn->bhpn",
                            (xh[:, 0] * dt[:, 0, :, None]).float(),
                            Bm[:, 0].float()))
    y = torch.einsum("bhpn,bn->bhp", state, Cm[:, 0].float())
    y = y[:, None].to(x.dtype)                                  # (B,1,H,P)
    out = _ssm_post(params, cfg, y, z, xh)
    cache["state"].copy_(state)
    for k, v in conv_state.items():
        cache["conv"][k].copy_(v)
    return out, cache
