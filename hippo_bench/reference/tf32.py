"""The control for a float32 configuration: the reference with every
product's operands rounded to TF32 (10 explicit mantissa bits, to
nearest), as the card's tensor cores take float32 operands when TF32 is
on — the step below float32 with TF32 off.  Products accumulate, and
parameters and moments are kept, in float32.
"""

from __future__ import annotations

import torch

from hippo_bench.reference.fp8 import _sum_to


def _round(x: torch.Tensor) -> torch.Tensor:
    bits = x.detach().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _Tf32Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        aq, bq = _round(a), _round(b)
        ctx.save_for_backward(aq, bq)
        return aq @ bq

    @staticmethod
    def backward(ctx, g):
        aq, bq = ctx.saved_tensors
        gq = _round(g)
        return (_sum_to(gq @ bq.transpose(-1, -2), aq.shape),
                _sum_to(aq.transpose(-1, -2) @ gq, bq.shape))


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _Tf32Matmul.apply(a, b)


def store(tree):
    """TF32 is a way of multiplying: what is kept stays float32."""
    return tree
