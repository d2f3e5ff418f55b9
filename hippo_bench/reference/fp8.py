"""The control: the reference computed in float8 where the
configurations state bfloat16 — the step below them.  Every product's
operands are rounded to float8 (forward operands e4m3, the backward's
incoming gradient e5m2), and the parameters and AdamW's moments are kept
in e4m3 between steps, each tensor scaled by its largest magnitude (the
usual float8 recipe).  Products accumulate, and the elementwise work
runs, in float32, as the port's bfloat16 path does.
"""

from __future__ import annotations

import torch

E4M3, E5M2 = torch.float8_e4m3fn, torch.float8_e5m2
E4M3_MAX, E5M2_MAX = 448.0, 57344.0


def _round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    scale = top / x.detach().abs().amax().clamp(min=1e-30)
    return (x * scale).to(dtype).to(torch.float32) / scale


def _sum_to(g: torch.Tensor, shape) -> torch.Tensor:
    """``g`` summed over the axes that broadcasting added to ``shape``."""
    while g.dim() > len(shape):
        g = g.sum(0)
    for i, n in enumerate(shape):
        if n == 1 and g.shape[i] != 1:
            g = g.sum(i, keepdim=True)
    return g


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        aq, bq = _round(a, E4M3, E4M3_MAX), _round(b, E4M3, E4M3_MAX)
        ctx.save_for_backward(aq, bq)
        return aq @ bq

    @staticmethod
    def backward(ctx, g):
        aq, bq = ctx.saved_tensors
        gq = _round(g, E5M2, E5M2_MAX)
        return (_sum_to(gq @ bq.transpose(-1, -2), aq.shape),
                _sum_to(aq.transpose(-1, -2) @ gq, bq.shape))


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _Fp8Matmul.apply(a, b)


def store(tree):
    """Parameters or a moment as kept between steps: each tensor in e4m3."""
    return {k: _round(v, E4M3, E4M3_MAX) for k, v in tree.items()}
