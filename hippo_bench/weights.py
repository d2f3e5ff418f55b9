"""Weights and token data made from ``--seed`` on the device.

The benchmark, not the port, draws the inputs, so the program under test
and the plain reference start from the same bits.  The parameter tree has
the port's layout (read once from ``LM.init`` on the meta device, which
allocates nothing); each leaf is filled by the rule its name gives, from
a few large draws of a ``torch.Generator`` on the device, in the dtype
the model is served in:

* matrices: a truncated normal (±2σ) scaled by the fan-in's inverse
  square root (the fan-in is ``d_model`` for a projection out of the
  residual stream, else the product of the leaf's leading dimensions);
* ``embed``: N(0, 0.02); a depthwise ``conv_*``: N(0, 1/K);
* norms and ``D``: 1; biases and ``dt_bias``: 0; ``A_log``: log(1..16).

Tokens are a Markov stream (each token the previous plus a drift in
[0, 7), modulo the vocabulary), learnable, so a schedule's choice shows in
its loss.
"""

from __future__ import annotations

import hashlib
import math
from typing import Any, Dict, Tuple

import torch

from hippo_bench.reference.lm import flat

ONES = ("norm1", "norm2", "final_norm", "gate_norm", "q_norm", "k_norm", "D")
ZEROS = ("bq", "bk", "bv", "dt_bias")


def derive(seed: int, purpose: str) -> int:
    """A 63-bit seed for one purpose, from any whole-number ``seed``."""
    h = hashlib.sha256(f"{int(seed)}:{purpose}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def rebuild(like: Any, values: Dict[Tuple, torch.Tensor], path=()) -> Any:
    """A tree shaped like ``like`` whose leaves are ``values[path]``."""
    if isinstance(like, dict):
        return {k: rebuild(v, values, path + (k,)) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(rebuild(v, values, path + (i,))
                          for i, v in enumerate(like))
    return values[path]


def _per_layer(path: Tuple, shape) -> Tuple[int, ...]:
    """A stacked leaf (under ``cycles``) without its layer axis."""
    return tuple(shape[1:]) if path[0] == "cycles" else tuple(shape)


def _fan_in(shape: Tuple[int, ...], d_model: int) -> int:
    if shape[0] == d_model or len(shape) == 1:
        return shape[0]
    return math.prod(shape[:-1])


def make_params(skeleton: Any, d_model: int, seed: int, device) -> Any:
    """The port's parameter tree, drawn on ``device`` from ``seed``.
    ``skeleton`` is the tree of meta tensors ``LM.init`` gives."""
    gen = torch.Generator(device=device).manual_seed(derive(seed, "weights"))
    items = list(flat(skeleton).items())
    normal, trunc = [], []
    for path, leaf in items:
        name = path[-1]
        if name in ONES or name in ZEROS or name == "A_log":
            continue
        (normal if name == "embed" or str(name).startswith("conv_")
         else trunc).append((path, leaf))
    out: Dict[Tuple, torch.Tensor] = {}
    for group, draw in ((normal, "normal"), (trunc, "trunc")):
        total = sum(leaf.numel() for _, leaf in group)
        if not total:
            continue
        buf = torch.empty(total, dtype=torch.float32, device=device)
        if draw == "normal":
            buf.normal_(generator=gen)
        else:
            torch.nn.init.trunc_normal_(buf, a=-2.0, b=2.0, generator=gen)
        off = 0
        for path, leaf in group:
            n = leaf.numel()
            x = buf[off:off + n].view(leaf.shape)
            off += n
            name = path[-1]
            shape = _per_layer(path, leaf.shape)
            if name == "embed":
                scale = 0.02
            elif str(name).startswith("conv_"):
                scale = shape[0] ** -0.5
            else:
                scale = _fan_in(shape, d_model) ** -0.5
            out[path] = (x * scale).to(leaf.dtype)
        del buf
    for path, leaf in items:
        name = path[-1]
        if name in ONES:
            out[path] = torch.ones(leaf.shape, dtype=leaf.dtype, device=device)
        elif name in ZEROS:
            out[path] = torch.zeros(leaf.shape, dtype=leaf.dtype,
                                    device=device)
        elif name == "A_log":
            h = leaf.shape[-1]
            row = torch.log(torch.linspace(1.0, 16.0, h, device=device))
            out[path] = row.expand(leaf.shape).to(leaf.dtype).contiguous()
    return rebuild(skeleton, out)


def make_tokens(n: int, seq_len: int, vocab: int, seed: int, device
                ) -> torch.Tensor:
    """``(n, seq_len)`` int32 tokens of the Markov stream, on ``device``."""
    gen = torch.Generator(device=device).manual_seed(derive(seed, "tokens"))
    base = torch.randint(0, vocab, (n, 1), generator=gen, device=device)
    drift = torch.randint(0, 7, (n, seq_len), generator=gen, device=device)
    return ((base + torch.cumsum(drift, dim=1)) % vocab).to(torch.int32)


def batch_rows(pipe_seed: int, n: int, batch: int, step: int):
    """The training rows of ``step``: the data pipeline's order (a numpy
    permutation of the ``n`` rows per epoch, seeded by ``(pipe_seed,
    epoch)``, walked ``batch`` rows a step, a ragged tail dropped)."""
    import numpy as np
    per_epoch = n // batch
    epoch, k = divmod(step, per_epoch)
    perm = np.random.default_rng((pipe_seed, epoch)).permutation(n)
    return perm[k * batch:(k + 1) * batch]
