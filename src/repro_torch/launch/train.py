"""Launcher: plain training of one assigned architecture on the local mesh.

On the card it trains the full-width model (the driver's machine has one
H100: a ``(data=1, model=1)`` mesh); ``--device cpu`` with ``--reduced``
trains the smoke-scale variant on the CPU.  Parameters and optimizer
state are placed per :mod:`repro_torch.dist.sharding`; a local mesh of
several cards is refused (sharded stage execution over several cards is
not in this package).

    python -m repro_torch.launch.train --arch qwen2-0.5b --steps 20 \\
        --batch 4 --seq 1024
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --reduced --steps 5 --batch 4 --seq 32 --device cpu

``--use-kernel`` defaults to on for a CUDA device (the LM's attention runs
B2–B4 and the update B1) and off on the CPU, as ``TorchTrainer`` does.
The launcher prints the loss, per-step seconds, tokens/s and the kernel
counters (launches of B1–B4, calls and fallbacks of the kernel plane);
:func:`main` returns them.
"""

from __future__ import annotations

import argparse
import statistics
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.data import DataPipeline, synthetic_lm_dataset
from repro_torch.dist.meshes import WorkerMesh
from repro_torch.dist.sharding import (SHARDED_EXECUTION, ShardingRules,
                                       batch_specs, param_specs)
from repro_torch.kernels import ops as kops
from repro_torch.kernels.flash_attention import (flash_attention_bwd_dkv,
                                                 flash_attention_bwd_dq,
                                                 flash_attention_fwd)
from repro_torch.kernels.optim import stacked_tree_update
from repro_torch.launch.specs import batch_struct
from repro_torch.models import LM
from repro_torch.train.optimizer import init_opt_state
from repro_torch.train.step import build_train_step, place, shardings_for

__all__ = ["local_mesh", "main"]

# the launch counters of the kernels a training step of an attention LM
# runs: B1 (the update), B2 (attention forward), B3 / B4 (its backward)
_LAUNCH_COUNTERS = {"B1": stacked_tree_update, "B2": flash_attention_fwd,
                    "B3": flash_attention_bwd_dq,
                    "B4": flash_attention_bwd_dkv}


def local_mesh(device: torch.device) -> Tuple[WorkerMesh, List[torch.device]]:
    """The local ``(data, model)`` mesh and its devices: every visible CUDA
    device, the model axis the largest of 16, 8, 4, 2, 1 dividing their
    count (one card: ``(1, 1)``); the CPU is one device.  A mesh of more
    than one device is refused."""
    n = torch.cuda.device_count() if device.type == "cuda" else 1
    if n < 1:
        raise RuntimeError("no CUDA device is visible; pass --device cpu "
                           "to train on the CPU")
    model = next(m for m in (16, 8, 4, 2, 1) if n % m == 0)
    mesh = WorkerMesh.build(range(n), axes=(("data", n // model),
                                            ("model", model)))
    if n > 1:
        raise NotImplementedError(
            f"the local mesh has {n} devices; training over them needs "
            f"{SHARDED_EXECUTION}")
    devices = mesh.torch_devices() if device.type == "cuda" else [device]
    return mesh, devices


def _launches() -> Dict[str, int]:
    return {k: fn.launches for k, fn in _LAUNCH_COUNTERS.items()}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
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
                    help="route attention (B2-B4) and the update (B1) "
                         "through the kernels (default: on for a CUDA "
                         "device, off on the CPU)")
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

    mesh, devices = local_mesh(device)
    rules = ShardingRules(fsdp="data", tp="model", dp=("data",))
    model = LM(cfg, use_kernel=use_kernel)
    print(f"training {cfg.name} ({cfg.param_count()/1e6:.1f}M params) on "
          f"mesh {mesh.sizes} ({devices[0]})")

    params = model.init(0)
    opt = init_opt_state("adamw", params)
    data = DataPipeline(
        synthetic_lm_dataset(4096, args.seq, cfg.vocab_size), args.batch)

    sizes = mesh.sizes          # gate divisibility on the live mesh
    params = place(params, shardings_for(devices, param_specs(params, rules,
                                                              sizes)))
    opt = place(opt, shardings_for(devices, param_specs(opt, rules, sizes)))
    bshard = shardings_for(devices, batch_specs(
        cfg, batch_struct(cfg, args.batch, args.seq), rules, sizes))

    step_fn = build_train_step(model, use_kernel=use_kernel)
    lr = torch.tensor(args.lr, dtype=torch.float32, device=devices[0])
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    launches0, stats0 = _launches(), kops.KERNEL_STATS.snapshot()
    losses, seconds = [], []
    t0 = time.perf_counter()
    for i in range(args.steps):
        t = time.perf_counter()
        batch = place({k: torch.from_numpy(v.astype(np.int64))
                       for k, v in data.next_batch().items()}, bshard)
        params, opt, loss = step_fn(params, opt, batch, lr, i)
        losses.append(loss)
        sync()
        seconds.append(time.perf_counter() - t)
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {float(loss):.4f}  "
                  f"({(time.perf_counter() - t0) / (i + 1):.2f}s/step)")
    total = time.perf_counter() - t0
    # the first step builds the kernels and warms the caches: the steady
    # rate is the median of the others
    steady = statistics.median(seconds[1:] or seconds)
    losses = [float(x) for x in losses]
    launches = {k: v - launches0[k] for k, v in _launches().items()}
    calls = kops.KERNEL_STATS.calls - stats0[0]
    fallbacks = kops.KERNEL_STATS.fallbacks - stats0[1]
    tokens_per_s = args.batch * args.seq / steady
    print(f"done: {args.steps} steps in {total:.1f}s; "
          f"final loss {losses[-1]:.4f}")
    print(f"steady: {steady:.4f} s/step, {tokens_per_s:.0f} tokens/s")
    print(f"kernel plane: {calls} calls, {fallbacks} fallbacks; launches "
          + ", ".join(f"{k} {v}" for k, v in launches.items()))
    return {"arch": cfg.name, "losses": losses, "step_seconds": seconds,
            "seconds_per_step": steady, "tokens_per_s": tokens_per_s,
            "launches": launches, "kernel_calls": calls,
            "kernel_fallbacks": fallbacks, "device": str(devices[0])}


if __name__ == "__main__":
    main()
