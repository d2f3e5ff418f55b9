"""Sibling groups on the card: what a group of M members costs.

    python3 tools/group_probe.py memory   # qwen2-0.5b: peak memory by M
    python3 tools/group_probe.py memory mamba2-2.7b 32   # mamba2, 32 layers
    python3 tools/group_probe.py conv     # ResNet56's convolutions, vmapped

``memory``: one training step of qwen2-0.5b at full width (24 layers, bf16,
4 × 1024 tokens, AdamW, kernels on) — or of mamba2-2.7b at full width and
the given depth (bf16, 1 × 2048 tokens, AdamW, M = 1, 2 only) — solo
(``value_and_grad`` and the fused update) and as one vectorised group step
of M = 1, 2, 3, 4 members
(``TorchTrainer._run_group_chunk``: the loss under ``vmap`` over the
member-stacked carry, the slab shared, and one ``autograd.grad``), and,
for M = 1, 2, the same step with ``torch.func.vmap(torch.func.grad_and_value
(loss))`` in its place: ``max_memory_allocated`` of each, or, where a
group does not fit on the card, the allocator's out-of-memory error.

``conv``: each distinct convolution of ResNet56 at batch 128 (NHWC,
HWIO, ``"SAME"`` padding, through ``models.resnet._conv``), forward and
backward, under ``torch.func.vmap`` over M members' weights and
activations (cuDNN's grouped convolution, ``cudnn.deterministic``)
against M plain convolutions; CUDA-event and profiler device times.

Each mode prints one JSON line per measurement, beside the card's name and
power limit.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), os.path.join(ROOT, "examples"),
                ROOT]
import torch                                              # noqa: E402

import chip_smoke as cs                                   # noqa: E402


def emit(obj):
    print(json.dumps(obj), flush=True)


def gib(b):
    return b / 2 ** 30


def memory(arch="qwen2-0.5b", layers=None):
    import torch_hpo_lm as example
    from repro_torch.kernels.optim import (fused_apply_update,
                                           stacked_apply_update)
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.torch_trainer import _stack, value_and_grad
    from repro_torch.utils.tree import tree_leaves
    qwen = arch == "qwen2-0.5b"
    shape = cs.LM_FULL if qwen else dict(cs.MAMBA_STUDY, layers=int(layers))
    backend = example.make_backend(arch=arch, use_kernel=True, **shape)
    p0 = backend.init_state()["params"]
    emit({"mode": "model", "arch": arch,
          "layers": backend.task.cfg.num_layers,
          "state_gib": gib(3 * sum(p.numel() * p.element_size()
                                   for p in tree_leaves(p0)))})
    slab = backend._upload(backend.pipeline_factory().next_batches(1))
    step = torch.zeros((1,), dtype=torch.int32, device=cs.DEV)

    def backend_step(carry, hp):
        carry = list(carry)
        backend._run_group_chunk("adamw", carry, {}, hp, slab, step, True)
        return carry
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    opt = init_opt_state("adamw", p0)
    _, grads = value_and_grad(backend.task.loss, p0,
                              {k: v[0] for k, v in slab.items()})
    out = fused_apply_update("adamw", p0, grads, opt, {"lr": 3e-4}, step[0])
    torch.cuda.synchronize()
    emit({"mode": "solo", "members": 1,
          "peak_gib": gib(torch.cuda.max_memory_allocated()),
          "peak_over_start_gib": gib(torch.cuda.max_memory_allocated()
                                     - base)})
    del opt, grads, out
    cs.free()
    def func_grad_step(carry, hp):       # the form the trainer avoids
        grads, _ = torch.func.vmap(torch.func.grad_and_value(
            backend.task.loss, has_aux=True), in_dims=(0, None))(
                carry[0], {k: v[0] for k, v in slab.items()})
        return stacked_apply_update("adamw", carry[0], grads, carry[1],
                                    {k: v[0] for k, v in hp.items()},
                                    step[0])

    runs = [("group", M, backend_step) for M in (1, 2, 3, 4)] + [
        ("group, vmap(grad_and_value)", M, func_grad_step) for M in (1, 2)]
    if not qwen:
        runs = runs[:2]
    for mode, M, run in runs:
        torch.cuda.reset_peak_memory_stats()
        row = {"mode": mode, "members": M}
        try:
            ps = _stack([p0] * M)
            carry = (ps, init_opt_state("adamw", ps))
            del ps
            hp = {"lr": torch.full((1, M), 3e-4, device=cs.DEV)}
            carry = run(carry, hp)
            torch.cuda.synchronize()
            row.update(fits=True)
        except torch.OutOfMemoryError as exc:   # the finding, not a fault
            row.update(fits=False, error=str(exc).splitlines()[0][:200],
                       allocated_at_failure_gib=gib(
                           torch.cuda.memory_allocated()))
        carry = None
        row.update(peak_gib=gib(torch.cuda.max_memory_allocated()),
                   peak_over_start_gib=gib(torch.cuda.max_memory_allocated()
                                           - base))
        emit(row)
        cs.free()


def conv():
    from repro_torch.models.resnet import _conv
    gen = torch.Generator().manual_seed(0)
    rnd = lambda *s: torch.randn(s, generator=gen).to(cs.DEV)
    torch.backends.cudnn.deterministic = True     # as TorchTrainer sets
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    # (H = W, cin, cout, kernel, stride) of ResNet56's convolutions
    shapes = [(32, 16, 16, 3, 1), (32, 16, 32, 3, 2), (16, 32, 32, 3, 1),
              (16, 32, 64, 3, 2), (8, 64, 64, 3, 1), (32, 16, 32, 1, 2)]
    for hw, cin, cout, k, stride in shapes:
        for M in (2, 4):
            x, w = rnd(M, 128, hw, hw, cin), rnd(M, k, k, cin, cout)
            g = rnd(M, 128, -(-hw // stride), -(-hw // stride), cout)

            def fwd_bwd(x_, w_, g_):
                x_ = x_.detach().requires_grad_(True)
                w_ = w_.detach().requires_grad_(True)
                y = _conv(x_, w_, stride)
                return torch.autograd.grad(y, (x_, w_), g_)

            grouped = lambda: torch.func.vmap(
                lambda a, b, c: torch.func.vjp(
                    lambda a_, b_: _conv(a_, b_, stride), a, b)[1](c))(
                        x, w, g)
            plain = lambda: [fwd_bwd(x[m], w[m], g[m]) for m in range(M)]
            for a, b in zip(grouped(), zip(*plain())):
                err = float((a - torch.stack(b)).abs().max())
                assert err <= 1e-3 * float(torch.stack(b).abs().max()), err
            emit({"mode": "conv", "hw": hw, "cin": cin, "cout": cout,
                  "kernel": k, "stride": stride, "batch": 128, "members": M,
                  "grouped_ms": cs.time_ms(grouped, reps=10, warm=2),
                  "grouped_device_ms": cs.device_ms(grouped, reps=5),
                  "plain_ms": cs.time_ms(plain, reps=10, warm=2),
                  "plain_device_ms": cs.device_ms(plain, reps=5),
                  "bit_equal": all(torch.equal(a, torch.stack(b)) for a, b
                                   in zip(grouped(), zip(*plain())))})


def main():
    mode = sys.argv[1] if len(sys.argv) > 1 else ""
    if mode not in ("memory", "conv"):
        sys.exit("group_probe: memory | conv")
    if not torch.cuda.is_available():
        sys.exit("group_probe: no CUDA device available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    emit({"mode": mode, "card": smi})
    t0 = time.perf_counter()
    join = cs.start_builds()
    for name in cs.CUDA_SOURCES:
        join(name)
    {"memory": memory, "conv": conv}[mode](*sys.argv[2:])
    emit({"mode": mode, "seconds": time.perf_counter() - t0})


if __name__ == "__main__":
    main()
