"""Canonical step functions (train / prefill / serve) and their placement.

Used by the launcher.  The train step is the full update: loss, gradients,
AdamW — every hyper-parameter a value of the call (the Hippo requirement),
parameters and optimizer state placed per :mod:`repro_torch.dist.sharding`.
With ``use_kernel`` (the default on a CUDA device) the update is B1
(:func:`repro_torch.kernels.optim.fused_apply_update`, a drop-in for
:func:`repro_torch.train.optimizer.apply_update`) and the LM's attention
runs B2–B4.

Placement: :func:`shardings_for` maps a spec tree onto a mesh's devices.
One device holds every leaf whole, whatever its spec; a tree split over
several devices is :data:`~repro_torch.dist.sharding.SHARDED_EXECUTION`
and raises.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch

from repro_torch.dist.sharding import SHARDED_EXECUTION, map_specs
from repro_torch.kernels.optim import fused_apply_update
from repro_torch.models.transformer import LM
from repro_torch.train.optimizer import apply_update
from repro_torch.train.torch_trainer import value_and_grad
from repro_torch.utils.tree import tree_map

__all__ = ["build_train_step", "build_prefill_step", "build_serve_step",
           "shardings_for", "place"]


def shardings_for(devices: Sequence[Any], tree_of_specs: Any) -> Any:
    """Spec tree → a tree of the device each leaf is placed on, over a
    mesh's ``devices`` (``WorkerMesh.torch_devices()``, or ``[cpu]``).  On
    one device every leaf lives there whole."""
    if len(devices) != 1:
        raise NotImplementedError(
            f"placing a tree over {len(devices)} devices needs "
            f"{SHARDED_EXECUTION}")
    dev = torch.device(devices[0])
    return map_specs(lambda _spec: dev, tree_of_specs)


def place(tree: Any, shardings: Any) -> Any:
    """``tree`` with every tensor leaf on the device :func:`shardings_for`
    gave it."""
    return tree_map(lambda x, dev: x.to(dev), tree, shardings)


def build_train_step(model: LM, optimizer: str = "adamw",
                     use_kernel: Optional[bool] = None):
    """``(params, opt, batch, lr, step) → (params, opt, loss)`` with wd 0.1,
    b1 0.9, b2 0.95; ``lr`` and ``step`` are values of the call (numbers
    or 0-d tensors), so one step function serves every stage.
    ``use_kernel`` (default: the model's) routes the update through B1."""
    use_kernel = model.use_kernel if use_kernel is None else use_kernel
    update = fused_apply_update if use_kernel else apply_update

    def train_step(params, opt, batch, lr, step):
        (loss, _), grads = value_and_grad(model.loss, params, batch)
        hp = {"lr": lr, "wd": 0.1, "b1": 0.9, "b2": 0.95}
        params, opt = update(optimizer, params, grads, opt, hp, step)
        return params, opt, loss

    return train_step


def build_prefill_step(model: LM):
    def prefill_step(params, batch):
        with torch.no_grad():
            logits, _ = model.forward(params, batch)
        # serving returns only the last-position logits (next-token)
        return logits[:, -1]

    return prefill_step


def build_serve_step(model: LM):
    """``(params, cache, tokens (B, 1), index) → (next tokens (B,) int32,
    cache)``: one greedy decode step, the cache written in place and
    returned.  With ``index`` a 0-d tensor on the card the step reads
    nothing back to the host."""

    def serve_step(params, cache, tokens, index):
        with torch.no_grad():
            logits, cache = model.decode_step(params, cache, tokens, index)
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok, cache

    return serve_step
