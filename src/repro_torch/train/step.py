"""Canonical step functions (train / prefill / serve) and their placement.

Used by the launcher.  The train step is the full update: loss, gradients,
AdamW — every hyper-parameter a value of the call (the Hippo requirement),
parameters and optimizer state placed per :mod:`repro_torch.dist.sharding`.
With ``use_kernel`` (the default on a CUDA device) the update is B1
(:func:`repro_torch.kernels.optim.fused_apply_update`, a drop-in for
:func:`repro_torch.train.optimizer.apply_update`) and the LM's attention
runs B2–B4.

Placement: :func:`shardings_for` maps a spec tree onto a mesh's devices.
One device holds every leaf whole, whatever its spec; over several
devices a leaf rests as the trainer's carry does on a worker mesh
(:func:`repro_torch.dist.sharding.split_leaf`: a shard on each device in
mesh order, whole on the first where its spec splits nothing).  A step
over several ranks places its trees as DTensors instead
(:func:`repro_torch.dist.sharding.distribute_tree`, the launcher's).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence, Tuple

import torch

from repro_torch.dist.sharding import P, map_specs, split_leaf
from repro_torch.kernels.optim import fused_apply_update
from repro_torch.models.transformer import LM
from repro_torch.train.optimizer import apply_update
from repro_torch.train.torch_trainer import value_and_grad
from repro_torch.utils.tree import tree_map

__all__ = ["build_train_step", "build_prefill_step", "build_serve_step",
           "shardings_for", "place", "Placement"]


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a leaf rests over several devices: its spec on the mesh
    ``axes`` over ``devices`` (row-major)."""

    spec: P
    axes: Tuple[Tuple[str, int], ...]
    devices: Tuple[torch.device, ...]


def shardings_for(devices: Sequence[Any], tree_of_specs: Any,
                  axes: Optional[Sequence[Tuple[str, int]]] = None) -> Any:
    """Spec tree → a tree of where each leaf is placed, over a mesh's
    ``devices`` (``WorkerMesh.torch_devices()``, or ``[cpu]``).  On one
    device every leaf lives there whole (the tree's leaves are that
    device); over several, a :class:`Placement` per leaf, which needs the
    mesh's ``axes`` (``WorkerMesh.axes``)."""
    devs = tuple(torch.device(d) for d in devices)
    if len(devs) == 1:
        return map_specs(lambda _spec: devs[0], tree_of_specs)
    if axes is None:
        raise ValueError(f"placing a tree over {len(devs)} devices needs "
                         "the mesh's axes")
    axes = tuple((str(a), int(n)) for a, n in axes)
    return map_specs(lambda spec: Placement(spec, axes, devs), tree_of_specs)


def place(tree: Any, shardings: Any) -> Any:
    """``tree`` with every tensor leaf where :func:`shardings_for` put it:
    on its device, or at rest over a :class:`Placement`'s devices (a
    :class:`~repro_torch.dist.sharding.Shards`, or whole on the first)."""
    def one(x, where):
        if isinstance(where, Placement):
            return split_leaf(x, where.spec, where.axes, where.devices)
        return x.to(where)
    return tree_map(one, tree, shardings)


def build_train_step(model: LM, optimizer: str = "adamw",
                     use_kernel: Optional[bool] = None,
                     update: Optional[Callable] = None):
    """``(params, opt, batch, lr, step) → (params, opt, loss)`` with wd 0.1,
    b1 0.9, b2 0.95; ``lr`` and ``step`` are values of the call (numbers
    or 0-d tensors), so one step function serves every stage.
    ``use_kernel`` (default: the model's) routes the update through B1;
    ``update`` (``apply_update``'s signature) replaces it outright (the
    launcher's, over DTensors on several ranks)."""
    use_kernel = model.use_kernel if use_kernel is None else use_kernel
    if update is None:
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
