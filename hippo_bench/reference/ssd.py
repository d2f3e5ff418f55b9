"""A Mamba-2 block (arXiv:2405.21060): RMSNorm, then the SSD mixer —
separate projections to z, x, B, C and dt, a depthwise causal
convolution and SiLU on x, B and C, dt = softplus(dt_raw + dt_bias),
A = -exp(A_log), the state-space recurrence per head

    h_t = exp(dt_t A) h_{t-1} + dt_t B_t ⊗ x_t,    y_t = C_t · h_t + D x_t

(B and C shared by the heads), y gated by SiLU(z) and RMS-normed, then
the output projection; residual.  The recurrence is computed exactly by
its chunked form: a quadratic term inside each chunk and the state
handed from chunk to chunk.

Keys read: ``d_model``, ``expand``, ``headdim``, ``d_state``,
``chunk_size``, ``norm_eps``.  Parameters: ``norm1``, ``ssm/{in_z, in_x}``
(D, inner), ``ssm/{in_B, in_C}`` (D, N), ``ssm/in_dt`` (D, heads),
``ssm/conv_{x, B, C}`` (K, width), ``ssm/{A_log, D, dt_bias}`` (heads),
``ssm/gate_norm`` (inner), ``ssm/out_proj`` (inner, D).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from hippo_bench.reference.lm import rms_norm


def norm_eps(cfg) -> float:
    return float(cfg["norm_eps"])


def _conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution: x (B, S, C), w (K, C)."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    return sum(xp[:, i:i + S] * w[i] for i in range(K))


def ssd(x, dt, A, Bm, Cm, Q: int, mm):
    """y (B, S, H, P) of the recurrence with zero initial state; x (B, S,
    H, P), dt (B, S, H), A (H,), Bm / Cm (B, S, N)."""
    Bsz, S, H, P = x.shape
    N, nc = Bm.shape[-1], S // Q
    xc = x.view(Bsz, nc, Q, H, P).permute(0, 1, 3, 2, 4)      # b c h q p
    dtc = dt.view(Bsz, nc, Q, H).permute(0, 1, 3, 2)           # b c h q
    Bc, Cc = Bm.view(Bsz, nc, Q, N), Cm.view(Bsz, nc, Q, N)
    cum = torch.cumsum(dtc * A[:, None], dim=-1)               # b c h q
    # inside a chunk: att[i, j] = (C_i . B_j) exp(cum_i - cum_j) dt_j, j <= i
    cb = mm(Cc, Bc.transpose(-1, -2))[:, :, None]              # b c 1 q q
    seg = cum[..., :, None] - cum[..., None, :]
    keep = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(seg.masked_fill(~keep, float("-inf")))
    y = mm(cb * decay * dtc[..., None, :], xc)                 # b c h q p
    # each chunk's end state, then the states handed between chunks
    w = (torch.exp(cum[..., -1:] - cum) * dtc)[..., None] * Bc[:, :, None]
    states = mm(xc.transpose(-1, -2), w)                       # b c h p n
    s = torch.zeros(Bsz, H, P, N, dtype=x.dtype, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(s)
        s = s * torch.exp(cum[:, c, :, -1])[..., None, None] + states[:, c]
    prev = torch.stack(prev, dim=1)                            # b c h p n
    y = y + torch.exp(cum)[..., None] * mm(Cc[:, :, None],
                                           prev.transpose(-1, -2))
    return y.permute(0, 1, 3, 2, 4).reshape(Bsz, S, H, P)


def forward(p, x: torch.Tensor, cfg, mm) -> torch.Tensor:
    B, S, D = x.shape
    s = p["ssm"]
    P = cfg["headdim"]
    H = cfg["expand"] * cfg["d_model"] // P
    eps = norm_eps(cfg)
    h = rms_norm(x, p["norm1"], eps)
    z = mm(h, s["in_z"])
    xs = F.silu(_conv(mm(h, s["in_x"]), s["conv_x"]))
    Bm = F.silu(_conv(mm(h, s["in_B"]), s["conv_B"]))
    Cm = F.silu(_conv(mm(h, s["in_C"]), s["conv_C"]))
    dt = F.softplus(mm(h, s["in_dt"]) + s["dt_bias"])
    xh = xs.view(B, S, H, P)
    y = ssd(xh, dt, -torch.exp(s["A_log"]), Bm, Cm, cfg["chunk_size"], mm)
    y = (y + xh * s["D"][:, None]).reshape(B, S, H * P)
    y = rms_norm(y * F.silu(z), s["gate_norm"], eps)
    return x + mm(y, s["out_proj"])
