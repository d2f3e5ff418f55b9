"""Launcher: plain training of one assigned architecture on the local mesh.

On the card it trains the full-width model on a ``(data=1, model=1)``
mesh; ``--device cpu`` with ``--reduced`` trains the smoke-scale variant
on the CPU.  Parameters and optimizer state are placed per
:mod:`repro_torch.dist.sharding`.

Over several ranks (``WORLD_SIZE`` > 1, as ``torchrun`` sets it), each
rank joins the process group (``gloo`` on the CPU, ``nccl`` on cards, one
card a rank), builds a ``(data, model)`` ``DeviceMesh`` over the ranks —
the model axis the largest of 16, 8, 4, 2, 1 dividing their number —
and places the parameters, the AdamW state and each batch as DTensors by
``param_specs`` / ``batch_specs``
(:func:`~repro_torch.dist.sharding.distribute_tree`), as the JAX
launcher shards its step with GSPMD over its local mesh.  The step is the
dry run's formulation (:class:`~repro_torch.launch.dryrun.ShardedLM`:
weights gathered over ``data`` before the arithmetic reads them, the
vocabulary-parallel cross-entropy; its local rules under
:class:`~repro_torch.launch.dryrun.OpRecorder`) and the plain update, as
the JAX launcher's step updates through ``apply_update``.  With
``--use-kernel`` (the default on cards) attention (B2–B4) and the SSD
term (B5–B6) run on each rank's local batch and heads
(:func:`repro_torch.kernels.ops.attention_plan` /
:func:`~repro_torch.kernels.ops.ssd_plan`): where a rank's q heads are
whole kv groups, or lie inside one, the kernel takes its own heads and
the kv head they read; elsewhere the heads are gathered first, as GSPMD
places the operands around the reference's kernel call, and such calls
are counted (``heads_gathered``).  On cards every call launches its
kernel or raises.  Several cards visible to a process started without
``torchrun`` are refused with how to launch.

    python -m repro_torch.launch.train --arch qwen2-0.5b --steps 20 \\
        --batch 4 --seq 1024
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --reduced --steps 5 --batch 4 --seq 32 --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch qwen2-0.5b --reduced --steps 3 --batch 4 --seq 32 \\
        --device cpu --use-kernel
    torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch qwen2-0.5b --steps 20 --batch 8 --seq 1024 --use-kernel

``--use-kernel`` defaults to on for a CUDA device (the LM's attention runs
B2–B4, its SSD B5–B6, and the one-process update B1) and off on the CPU,
where the kernels' calls take their plain versions, counted as fallbacks,
as ``TorchTrainer`` does.  The launcher prints the loss, per-step
seconds, tokens/s and the kernel counters (launches of B1–B6, those on
the tensor cores, calls, fallbacks and calls that gathered heads);
:func:`main` returns them (on several ranks, every rank returns its own,
with its parameters' local shard shapes in tree order; rank 0 prints).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import statistics
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.data import DataPipeline, synthetic_lm_dataset
from repro_torch.dist.meshes import WorkerMesh
from repro_torch.dist.sharding import (ShardingRules, batch_specs,
                                       distribute_tree, param_specs)
from repro_torch.kernels import ops as kops
from repro_torch.launch.dryrun import LAUNCH_COUNTERS, _launches
from repro_torch.launch.specs import batch_struct
from repro_torch.models import LM
from repro_torch.train.optimizer import apply_update, init_opt_state
from repro_torch.train.step import build_train_step, place, shardings_for
from repro_torch.utils.tree import tree_leaves, tree_map

__all__ = ["local_mesh", "model_axis", "rank_mesh", "parse", "main"]

RULES = ShardingRules(fsdp="data", tp="model", dp=("data",))


def model_axis(n: int) -> int:
    """The model axis of ``n`` devices: the largest of 16, 8, 4, 2, 1
    dividing ``n`` (the JAX launcher's rule)."""
    return next(m for m in (16, 8, 4, 2, 1) if n % m == 0)


def local_mesh(device: torch.device) -> Tuple[WorkerMesh, List[torch.device]]:
    """The one-process mesh and its device: one visible card (``(1, 1)``)
    or the CPU.  Several visible cards are refused with how to train over
    them: one rank a card, under ``torchrun``."""
    n = torch.cuda.device_count() if device.type == "cuda" else 1
    if n < 1:
        raise RuntimeError("no CUDA device is visible; pass --device cpu "
                           "to train on the CPU")
    if n > 1:
        raise RuntimeError(
            f"{n} CUDA devices are visible to one process: train over them "
            f"with a rank a card, `torchrun --nproc-per-node {n} -m "
            "repro_torch.launch.train ...` (a (data, model) mesh of "
            f"{n // model_axis(n)} x {model_axis(n)}), or make one visible "
            "(CUDA_VISIBLE_DEVICES=0)")
    mesh = WorkerMesh.build([0], axes=(("data", 1), ("model", 1)))
    devices = mesh.torch_devices() if device.type == "cuda" else [device]
    return mesh, devices


def rank_mesh(device: torch.device, world: int):
    """The ``(data, model)`` ``DeviceMesh`` over ``world`` ranks of an
    initialised process group, the model axis by :func:`model_axis`."""
    from torch.distributed.device_mesh import init_device_mesh
    model = model_axis(world)
    return init_device_mesh(device.type, (world // model, model),
                            mesh_dim_names=("data", "model"))


def _launches_tc() -> Dict[str, int]:
    """B2–B6's launches on the tensor cores."""
    return {k: fn.launches_tc for k, fn in LAUNCH_COUNTERS.items()
            if k != "B1"}


def _sharded_update(name, params, grads, opt, hp, step):
    """``apply_update`` over DTensor trees, each gradient first placed as
    its parameter: the backward may leave it otherwise (``Replicate``
    where a spec shards over a one-device axis), and the parameters'
    placements should not hang on how a DTensor release propagates a
    mixed pair."""

    def like(x, ref):
        if tuple(x.placements) == tuple(ref.placements):
            return x
        return x.redistribute(ref.device_mesh, ref.placements)

    grads = tree_map(like, grads, params)
    return apply_update(name, params, grads, opt, hp, step)


def parse(argv: Optional[Sequence[str]] = None):
    """The launcher's arguments: ``(args, cfg, device, use_kernel)``."""
    ap = argparse.ArgumentParser(
        description="plain training of one architecture on the local mesh")
    ap.add_argument("--arch", default="qwen2-0.5b", choices=list_archs())
    ap.add_argument("--reduced", action="store_true",
                    help="train the smoke-scale variant (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--use-kernel", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="route attention (B2-B4), SSD (B5-B6) and, in "
                         "one process, the update (B1) through the kernels "
                         "(default: on for a CUDA device, off on the CPU)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a visible card) or "
                         "cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(d_model=256)
    if cfg.frontend != "none":
        raise SystemExit(f"{args.arch} needs frontend embeddings, which "
                         "the launcher does not feed")
    device = torch.device(args.device)
    use_kernel = (device.type == "cuda") if args.use_kernel is None \
        else args.use_kernel
    return args, cfg, device, use_kernel


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args, cfg, device, use_kernel = parse(argv)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1:
        return _train_ranks(args, cfg, device, use_kernel, world)

    mesh, devices = local_mesh(device)
    model = LM(cfg, use_kernel=use_kernel)
    print(f"training {cfg.name} ({cfg.param_count()/1e6:.1f}M params) on "
          f"mesh {mesh.sizes} ({devices[0]})")

    params = model.init(0)
    opt = init_opt_state("adamw", params)
    data = DataPipeline(
        synthetic_lm_dataset(4096, args.seq, cfg.vocab_size), args.batch)

    sizes = mesh.sizes          # gate divisibility on the live mesh
    params = place(params, shardings_for(devices, param_specs(params, RULES,
                                                              sizes)))
    opt = place(opt, shardings_for(devices, param_specs(opt, RULES, sizes)))
    bshard = shardings_for(devices, batch_specs(
        cfg, batch_struct(cfg, args.batch, args.seq), RULES, sizes))
    place_batch = lambda b: place(b, bshard)
    step_fn = build_train_step(model, use_kernel=use_kernel)
    return _loop(args, cfg, device, devices[0], step_fn, params, opt, data,
                 place_batch, contextlib.nullcontext, float)[0]


def _loop(args, cfg, device, home, step_fn, params, opt, data, place_batch,
          context, read_loss, verbose=True):
    """The training loop and its report, on one device or one rank:
    ``(report, the last parameters)``."""
    lr = torch.tensor(args.lr, dtype=torch.float32, device=home)
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    say = print if verbose else (lambda *a: None)
    launches0, tc0 = _launches(), _launches_tc()
    stats0 = kops.KERNEL_STATS.snapshot()
    gathered0 = kops.KERNEL_STATS.heads_gathered
    losses, seconds = [], []
    t0 = time.perf_counter()
    for i in range(args.steps):
        t = time.perf_counter()
        batch = place_batch({k: torch.from_numpy(v.astype(np.int64))
                             for k, v in data.next_batch().items()})
        with context():
            params, opt, loss = step_fn(params, opt, batch, lr, i)
        loss = read_loss(loss)                   # waits for the step
        losses.append(loss)
        sync()
        seconds.append(time.perf_counter() - t)
        if i % 10 == 0 or i == args.steps - 1:
            say(f"step {i:4d}  loss {loss:.4f}  "
                f"({(time.perf_counter() - t0) / (i + 1):.2f}s/step)")
    total = time.perf_counter() - t0
    # the first step builds the kernels and warms the caches: the steady
    # rate is the median of the others
    steady = statistics.median(seconds[1:] or seconds)
    launches = {k: v - launches0[k] for k, v in _launches().items()}
    launches_tc = {k: v - tc0[k] for k, v in _launches_tc().items()}
    calls = kops.KERNEL_STATS.calls - stats0[0]
    fallbacks = kops.KERNEL_STATS.fallbacks - stats0[1]
    gathered = kops.KERNEL_STATS.heads_gathered - gathered0
    tokens_per_s = args.batch * args.seq / steady
    say(f"done: {args.steps} steps in {total:.1f}s; "
        f"final loss {losses[-1]:.4f}")
    say(f"steady: {steady:.4f} s/step, {tokens_per_s:.0f} tokens/s")
    say(f"kernel plane: {calls} calls, {fallbacks} fallbacks, {gathered} "
        "with heads gathered; launches "
        + ", ".join(f"{k} {v}" for k, v in launches.items())
        + " (tensor cores " + ", ".join(f"{k} {v}" for k, v in
                                        launches_tc.items()) + ")")
    return {"arch": cfg.name, "losses": losses, "step_seconds": seconds,
            "seconds_per_step": steady, "tokens_per_s": tokens_per_s,
            "launches": launches, "launches_tc": launches_tc,
            "kernel_calls": calls, "kernel_fallbacks": fallbacks,
            "heads_gathered": gathered, "device": str(home)}, params


def _train_ranks(args, cfg, device, use_kernel, world) -> Dict[str, Any]:
    """One rank of a launch over ``world`` ranks (see the module
    docstring); the process group is left as it was found."""
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.dryrun import (OpRecorder, ShardedLM, _quiet,
                                           fsdp_gather)

    rank = int(os.environ.get("RANK", "0"))
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank} wants card {local} of "
                               f"{torch.cuda.device_count()} visible")
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    started = not dist.is_initialized()
    if started:
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                rank=rank, world_size=world)
    try:
        mesh = rank_mesh(device, world)
        sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
        model = ShardedLM(cfg, mesh, use_kernel=use_kernel,
                          gather=fsdp_gather(mesh, RULES))
        verbose = rank == 0
        if verbose:
            print(f"training {cfg.name} ({cfg.param_count()/1e6:.1f}M "
                  f"params) on {world} ranks, mesh {sizes} ({device.type})")
        params = model.init(0, device=device)
        opt = init_opt_state("adamw", params)
        params = distribute_tree(params, param_specs(params, RULES, sizes),
                                 mesh)
        opt = distribute_tree(opt, param_specs(opt, RULES, sizes), mesh)
        data = DataPipeline(
            synthetic_lm_dataset(4096, args.seq, cfg.vocab_size), args.batch)
        bspecs = batch_specs(cfg, batch_struct(cfg, args.batch, args.seq),
                             RULES, sizes)
        place_batch = lambda b: distribute_tree(
            {k: v.to(device) for k, v in b.items()}, bspecs, mesh)
        step_fn = build_train_step(model, update=_sharded_update)

        @contextlib.contextmanager
        def context():
            with _quiet(), implicit_replication(), OpRecorder():
                yield

        out, params = _loop(args, cfg, device, device, step_fn, params,
                            opt, data, place_batch, context,
                            lambda x: float(x.full_tensor()), verbose)
        out.update(rank=rank, world=world, mesh=sizes,
                   local_shapes=[tuple(x.to_local().shape)
                                 for x in tree_leaves(params)])
        return out
    finally:
        if started:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
