"""Faults planted under a cell's timed path, to show that ``correct``
catches them: each patches the port's objects of one ``Cell`` in place.

* ``unchanged``: every optimizer update returns its state unchanged;
* ``half_batch``: each training loss leaves out half of the batch's
  rows and takes the mean over the rest;
* ``answer``: every evaluation's loss reported 1 % high.

The exchange between chips has no fault here: every cell runs on one.
"""

from __future__ import annotations

import torch

FAULTS = ("unchanged", "half_batch", "answer")


def plant(cell, fault: str) -> None:
    backend = cell.backend
    if fault == "unchanged":
        backend._update = lambda name, params, grads, opt, hp, step: (
            params, opt)
        backend._group_update = backend._update
    elif fault == "half_batch":
        task, loss = backend.task, backend.task.loss

        def half(params, batch):
            if not torch.is_grad_enabled():
                return loss(params, batch)
            rows = batch["tokens"].shape[0] // 2
            return loss(params, {k: v[:rows] for k, v in batch.items()})
        task.loss = half
    elif fault == "answer":
        evaluate = backend.evaluate

        def altered(state, ctx):
            out = dict(evaluate(state, ctx))
            out["loss"] *= 1.01
            out["val_acc"] = -out["loss"]
            return out
        backend.evaluate = altered
    else:
        raise ValueError(f"unknown fault {fault!r}; choose from {FAULTS}")
