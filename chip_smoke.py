#!/usr/bin/env python3
"""Smoke check of the PyTorch / CUDA package on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the package's main path once — a whole hyper-parameter study through
``Study.run`` → engine → ``TorchTrainer`` → the fused optimizer kernel — at
the full width of the paper's ResNet56 (``ResNet(n=9, width=16)``, batch
128, random weights from a seed), and holds every kernel of that path
against its plain PyTorch version on the card.  Needs one CUDA device and no
network; fails (non-zero exit, no result line) without a GPU or outside a
checkout of the repository.  Imports nothing of JAX and nothing of the JAX
package.  Phases, each printing one JSON line:

1. ``device``   — the card, as ``nvidia-smi`` names it, with its power limit.
2. ``kernels``  — the Triton kernel is compiled from
   ``src/repro_torch/kernels/optim.py`` at first launch; sgd / momentum /
   adam / adamw × M ∈ {1, 4} members with divergent hyper-parameters × f32
   and bf16 leaves × ResNet56 leaf shapes and a ragged one are compared with
   the plain version (f32: atol 1e-6 + rtol 1e-6, the same f32 formulas with
   other contractions; bf16: one bf16 ulp, f32 math rounded once), run twice
   and required bit-equal; the whole-tree update is timed at the main
   path's shapes and strides (gradients taken from the loss's backward at
   ResNet56) beside the plain version, a ``torch._foreach_*`` yardstick
   (used nowhere in the package) and the bytes / 3.35 TB/s bound.
3. ``small``    — ResNet8 on the card: kernel update vs plain update after 6
   steps (atol 1e-4), fused chain vs per-step loop bit for bit.
4. ``study``    — the SHA study of ``examples/torch_hpo_resnet.py`` at full
   width, stage-based and trial-based; launch counts are zeroed just before
   and read just after, and must equal steps × 114 leaves (``main_path``).
5. ``step`` / ``profile`` — where a step's time goes (host clock), and the
   device's busy and idle share over one 8-step chunk (profiler trace).
6. last lines   — the card and its power limit, the ``kernels`` line, and
   ``{"ok": true, "device": {...}}``.

Any failed check raises; nothing is caught and passed over.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device-memory rate (data sheet)
KERNEL_SOURCE = "src/repro_torch/kernels/optim.py"
KERNEL_REPLACES = "src/repro/kernels/optim.py:130"

SHAPES = [(3, 3, 64, 64), (64,), (64, 10), (3, 3, 5, 7)]   # last one ragged
HPS = {"lr": 0.05, "wd": 0.01, "mom": 0.9, "b1": 0.9, "b2": 0.999,
       "eps": 1e-8}
ADAM_HPS = dict(HPS, lr=1e-3)


def emit(obj):
    print(json.dumps(obj), flush=True)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path[:0] = [os.path.join(ROOT, "src"), os.path.join(ROOT, "examples")]
    import numpy as np
    import torch_hpo_resnet as example
    from repro_torch.core import Constant, HpConfig, MultiStep
    from repro_torch.core.searchplan import SearchPlan
    from repro_torch.core.trainer import StageContext
    from repro_torch.core.trial import Trial
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.optim import (_SPEC, fused_apply_update,
                                           stacked_leaf_update)
    from repro_torch.models.resnet import ResNet
    from repro_torch.train.optimizer import (OPTIMIZERS, apply_update,
                                             init_opt_state, leaf_update)
    from repro_torch.train.torch_trainer import value_and_grad
    from repro_torch.utils.tree import tree_leaves, tree_map

    dev = torch.device("cuda")

    def time_ms(fn, reps=30, warm=5):
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps

    # ------------------------------------------------------------ 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # ------------------------------------------- 2. kernel vs plain version
    def operands(name, M, shape, dtype, seed):
        rng = np.random.default_rng(seed)
        narr, snames, _ = _SPEC[name]
        full = (M,) + shape
        arrs = [rng.normal(size=full), 0.1 * rng.normal(size=full)]
        arrs += [0.01 + 0.01 * rng.uniform(size=full)
                 for _ in range(narr - 2)]
        arrs = [torch.tensor(a, dtype=torch.float32, device=dev).to(dtype)
                for a in arrs]
        base = ADAM_HPS if narr == 4 else HPS
        spread = 1.0 + 0.1 * np.arange(M)          # divergent per member
        vals = {k: np.asarray(base[k] * spread, np.float32)
                for k in ("lr", "wd", "mom")}
        # decay rates stay below 1 while still diverging per member
        vals["b1"] = np.asarray(base["b1"] - 0.01 * np.arange(M), np.float32)
        vals["b2"] = np.asarray(base["b2"] - 1e-4 * np.arange(M), np.float32)
        vals["eps"] = np.full(M, base["eps"], np.float32)
        t = np.arange(M, dtype=np.float32) + 1.0
        vals["bc1"] = (1.0 - vals["b1"] ** t).astype(np.float32)
        vals["bc2"] = (1.0 - vals["b2"] ** t).astype(np.float32)
        scal = [torch.tensor(vals[k], device=dev) for k in snames]
        return arrs, scal, snames

    def plain(name, arrs, scal, snames):
        bshape = (arrs[0].shape[0],) + (1,) * (arrs[0].dim() - 1)
        return leaf_update(name, *arrs, **{k: s.reshape(bshape)
                                           for k, s in zip(snames, scal)})

    t0 = time.perf_counter()
    for name in OPTIMIZERS:                         # build: JIT at 1st launch
        arrs, scal, _ = operands(name, 1, (64,), torch.float32, 0)
        stacked_leaf_update(name, *arrs, *scal)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0

    variants = []
    worst_f32 = 0.0
    for name in OPTIMIZERS:
        err_f32, ulp_bf16, cases = 0.0, 0.0, 0
        for M in (1, 4):
            for dtype in (torch.float32, torch.bfloat16):
                for si, shape in enumerate(SHAPES):
                    arrs, scal, snames = operands(name, M, shape, dtype,
                                                  100 * M + si)
                    got = stacked_leaf_update(name, *arrs, *scal)
                    again = stacked_leaf_update(name, *arrs, *scal)
                    want = plain(name, arrs, scal, snames)
                    torch.cuda.synchronize()
                    assert len(got) == len(want) == _SPEC[name][2]
                    for a, b, c in zip(got, again, want):
                        assert a.shape == c.shape and a.dtype == c.dtype
                        assert bool(a.isfinite().all())
                        assert torch.equal(a, b), (
                            f"{name}: two runs differ", M, dtype, shape)
                        if dtype == torch.float32:
                            diff = (a - c).abs()
                            err_f32 = max(err_f32, float(diff.max()))
                            bad = diff > 1e-6 + 1e-6 * c.abs()
                        else:
                            # one bf16 ulp at the value's magnitude, on
                            # top of the f32 slack (a sum that cancels can
                            # land on either side of 0 in f32)
                            af, cf = a.float(), c.float()
                            diff = (af - cf).abs()
                            _, exp = torch.frexp(torch.maximum(af.abs(),
                                                               cf.abs()))
                            ulp = torch.ldexp(torch.ones_like(cf), exp - 8)
                            ulp_bf16 = max(ulp_bf16, float(
                                ((diff - 1e-6).clamp(min=0) / ulp).max()))
                            bad = diff > ulp + 1e-6
                        assert not bool(bad.any()), (
                            f"{name}: kernel disagrees with plain version",
                            M, dtype, shape, float((a.float()
                                                    - c.float()).abs().max()))
                    cases += 1
        # time one launch at the widest ResNet56 leaf, 1 and 4 members
        timing = {}
        for M in (1, 4):
            arrs, scal, snames = operands(name, M, SHAPES[0], torch.float32,
                                          7)
            n_in, n_out = _SPEC[name][0], _SPEC[name][2]
            nbytes = (n_in + n_out) * arrs[0].numel() * 4
            timing[f"M{M}"] = {
                "ms": time_ms(lambda: stacked_leaf_update(name, *arrs, *scal)),
                "plain_ms": time_ms(lambda: plain(name, arrs, scal, snames)),
                "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
        worst_f32 = max(worst_f32, err_f32)
        variants.append({"name": name, "cases": cases,
                         "max_abs_err_f32": err_f32,
                         "max_err_bf16_in_ulps": ulp_bf16, "bit_equal_twice": True,
                         "leaf_3x3x64x64": timing})

    # the whole-tree update at the main path's shapes and strides:
    # ResNet56, momentum, gradients as the loss's backward hands them over
    # (convolution weights' come as non-contiguous HWIO views, which the
    # wrapper copies before the launch — that copy is part of its time)
    full = dict(n=9, width=16, n_train=8192, n_eval=512, batch=128)
    backend56 = example.make_backend(use_kernel=True, **full)
    params = ResNet(n=9, width=16).init(0, device=dev)
    batch0 = {k: v[0] for k, v in backend56._upload(
        backend56.pipeline_factory().next_batches(1)).items()}
    _, grads = value_and_grad(backend56.task.loss, params, batch0)
    n_strided = sum(not g.is_contiguous() for g in tree_leaves(grads))
    assert n_strided > 0, "expected strided weight gradients on this path"
    gen = torch.Generator(device="cuda").manual_seed(1)
    state = tree_map(lambda p: 0.01 * torch.rand(p.shape, device=dev,
                                                 generator=gen),
                     {"m": params})
    n_leaves = len(tree_leaves(params))
    n_params = sum(p.numel() for p in tree_leaves(params))
    assert n_leaves == 114, n_leaves
    hp = {"lr": torch.tensor(0.05, device=dev)}
    step = torch.tensor(3, dtype=torch.int32, device=dev)
    ps, gs, ms = (tree_leaves(params), tree_leaves(grads),
                  tree_leaves(state["m"]))

    def library():       # yardstick only — the package never calls this
        m2 = torch._foreach_mul(ms, 0.9)
        torch._foreach_add_(m2, gs)
        return torch._foreach_add(ps, m2, alpha=-0.05), m2

    new_k, st_k = fused_apply_update("momentum", params, grads, state, hp,
                                     step)
    new_p, st_p = apply_update("momentum", params, grads, state, hp, step)
    lib_p, lib_m = library()
    torch.cuda.synchronize()
    tree_err = 0.0
    for a, b in zip(tree_leaves((new_k, st_k)), tree_leaves((new_p, st_p))):
        diff = (a - b).abs()
        tree_err = max(tree_err, float(diff.max()))
        assert not bool((diff > 1e-6 + 1e-6 * b.abs()).any())
    for a, b in zip(tree_leaves((new_p, st_p["m"])), list(lib_p) + list(lib_m)):
        assert float((a - b).abs().max()) <= 1e-5     # yardstick is the same fn
    tree_bytes = 5 * n_params * 4          # read p, g, m; write p, m (f32)
    kernel_row = {
        "name": "opt_update", "route": "triton", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": None,
        "max_abs_err": max(worst_f32, tree_err),
        "ms": time_ms(lambda: fused_apply_update(
            "momentum", params, grads, state, hp, step)),
        "plain_ms": time_ms(lambda: apply_update(
            "momentum", params, grads, state, hp, step)),
        "bound_ms": tree_bytes / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": time_ms(library),
        "shape": f"ResNet56 tree, momentum: {n_leaves} leaves, "
                 f"{n_params} f32 parameters, one launch per leaf; "
                 f"{n_strided} gradient leaves strided, from backward",
        "launches_per_call": n_leaves, "build_seconds": build_s,
        "variants": variants}
    emit({"phase": "kernels", "build_seconds": build_s,
          "variants_ok": [v["name"] for v in variants],
          "max_abs_err_f32": kernel_row["max_abs_err"],
          "tree_update_ms": kernel_row["ms"],
          "tree_update_plain_ms": kernel_row["plain_ms"],
          "tree_update_library_ms": kernel_row["library_ms"],
          "tree_update_bound_ms": kernel_row["bound_ms"]})

    # ------------------------------------- 3. small input, agreement on card
    def stages_of(trial, steps):
        plan = SearchPlan("solo-" + trial.trial_id)
        node, _, _ = plan.submit(trial, steps)
        path = plan.path_to_root(node.node_id)
        return [StageContext(n.node_id, n.desc, n.start, n.start,
                             steps if i == len(path) - 1
                             else path[i + 1].start,
                             plan.path_key(n.node_id))
                for i, n in enumerate(path)]

    small = dict(n=1, width=8, n_train=256, n_eval=128, batch=32)
    t_kernel = example.make_backend(use_kernel=True, **small)
    t_plain = example.make_backend(use_kernel=False, **small)
    assert t_kernel.device.type == "cuda" and t_kernel.use_kernel
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    trial = Trial(HpConfig({"lr": MultiStep(0.05, [4], values=[0.05, 0.01]),
                            "bs": Constant(32)}), 6)
    ctxs = stages_of(trial, 6)
    chain = t_kernel.run_chain(t_kernel.init_state(), ctxs)[-1]
    s_step, s_plain = t_kernel.init_state(), t_plain.init_state()
    for ctx in ctxs:
        s_step = t_kernel.run_stage_stepwise(s_step, ctx)
        s_plain = t_plain.run_stage(s_plain, ctx)
    torch.cuda.synchronize()
    small_err, bitwise = 0.0, True
    for a, b, c in zip(tree_leaves((chain["params"], chain["opt"])),
                       tree_leaves((s_step["params"], s_step["opt"])),
                       tree_leaves((s_plain["params"], s_plain["opt"]))):
        assert bool(a.isfinite().all())
        bitwise = bitwise and torch.equal(a, b)
        small_err = max(small_err, float((a - c).abs().max()))
    assert small_err <= 1e-4, small_err
    assert bitwise, "fused chain and per-step loop differ on the card"
    emit({"phase": "small", "model": "ResNet(n=1, width=8)", "steps": 6,
          "kernel_vs_plain_max_abs_err": small_err, "atol": 1e-4,
          "fused_chain_equals_stepwise_bitwise": bitwise})

    # ------------------------------------------ 4. main path at full width
    kops.reset_kernel_stats()
    stacked_leaf_update.launches = 0            # counts to 0 just before
    runs = {}
    for share in (True, False):
        backend = example.make_backend(use_kernel=True, **full)
        stats, tuner, store, wall = example.run_study(
            backend, share, batch=full["batch"], name="resnet56")
        torch.cuda.synchronize()
        runs[share] = (stats, tuner, store, wall, backend)
    launches = stacked_leaf_update.launches     # ... and read just after
    calls, fallbacks = kops.KERNEL_STATS.snapshot()

    total_steps = 0
    for share, (stats, tuner, store, wall, backend) in runs.items():
        assert tuner.is_done() and tuner.best is not None
        assert stats.kernel_calls > 0 and stats.kernel_fallbacks == 0
        assert stats.kernel_calls == stats.steps_run, (
            stats.kernel_calls, stats.steps_run)
        assert stats.chain_fused_stages > 0
        assert stats.ckpt_async_writes == stats.ckpt_saves > 0
        assert store.pending_writes == 0
        n_ckpts = 0
        for cid in store.committed_ids():
            leaves = tree_leaves(store.get(cid)["params"])
            assert len(leaves) == n_leaves
            assert all(l.is_cuda and bool(l.isfinite().all()) for l in leaves)
            n_ckpts += 1
        assert n_ckpts > 0
        total_steps += stats.steps_run
        emit({"phase": "study", "mode": "stage" if share else "trial",
              "model": "ResNet(n=9, width=16)", "batch": full["batch"],
              "steps_run": stats.steps_run, "stages_run": stats.stages_run,
              "chain_fused_stages": stats.chain_fused_stages,
              "ckpt_saves": stats.ckpt_saves,
              "ckpt_async_writes": stats.ckpt_async_writes,
              "ckpt_loads": stats.ckpt_loads,
              "kernel_calls": stats.kernel_calls,
              "kernel_fallbacks": stats.kernel_fallbacks,
              "checkpoints_held": n_ckpts, "wall_seconds": wall,
              "steps_per_second": stats.steps_run / wall,
              "best_trial": tuner.best.trial_id,
              "best_val_acc": tuner.best_score})
    assert fallbacks == 0 and calls == total_steps, (calls, fallbacks)
    assert launches == total_steps * n_leaves, (launches, total_steps)
    (s_stats, s_tuner), (t_stats, t_tuner) = runs[True][:2], runs[False][:2]
    assert s_stats.steps_run < t_stats.steps_run
    assert set(s_tuner.history) == set(t_tuner.history)
    worst = max(abs(m["loss"] - t_tuner.history[k]["loss"])
                for k, m in s_tuner.history.items())
    assert worst <= 1e-4, worst
    same_best = s_tuner.best.trial_id == t_tuner.best.trial_id
    assert same_best, (s_tuner.best.trial_id, t_tuner.best.trial_id)
    assert abs(s_tuner.best_score - t_tuner.best_score) <= 1e-4

    # where a step's time goes (host clock around work that ends in a sync)
    backend = runs[True][4]
    st = backend.init_state()
    carry = (st["params"], init_opt_state("momentum", st["params"]))
    slab = backend._upload(backend.pipeline_factory().next_batches(8))
    steps8 = torch.arange(8, dtype=torch.int32, device=dev)
    hp_xs = {"lr": torch.full((8,), 0.05, device=dev)}
    batch0 = {k: v[0] for k, v in slab.items()}

    def host_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    step_ms = host_ms(lambda: backend._run_chunk(
        "momentum", carry, {}, hp_xs, slab, steps8), 3) / 8
    grad_ms = host_ms(lambda: value_and_grad(
        backend.task.loss, carry[0], batch0), 16)
    _, g0 = value_and_grad(backend.task.loss, carry[0], batch0)
    upd_ms = host_ms(lambda: fused_apply_update(
        "momentum", carry[0], g0, carry[1], {"lr": hp_xs["lr"][0]},
        steps8[0]), 16)
    emit({"phase": "step", "model": "ResNet(n=9, width=16)", "batch": 128,
          "step_ms": step_ms, "seconds_per_step": step_ms / 1e3,
          "steps_per_second": 1e3 / step_ms, "loss_fwd_bwd_ms": grad_ms,
          "optimizer_update_ms": upd_ms,
          "optimizer_update_share_of_step": upd_ms / step_ms,
          "clock": "host, synchronised at both ends"})
    # device busy share over one 8-step chunk: device time of the CUDA
    # kernels in the profiler's trace (the profiler slows the host, not the
    # kernels) against the chunk's wall time measured above without it
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        backend._run_chunk("momentum", carry, {}, hp_xs, slab, steps8)
        torch.cuda.synchronize()
    dev_time = lambda e: getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0.0))
    rows = sorted(((dev_time(e), e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and dev_time(e) > 0),
                  reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    chunk_ms = step_ms * 8
    emit({"phase": "profile", "window": "one 8-step chunk",
          "chunk_ms_without_profiler": chunk_ms,
          "device_busy_ms": busy_ms if rows else "not measured",
          "device_idle_share": (1.0 - busy_ms / chunk_ms) if rows
          else "not measured",
          "device_kernel_launches": sum(r[1] for r in rows),
          "device_kernel_launches_per_step": sum(r[1] for r in rows) / 8,
          "top_device_time": [{"ms": r[0] / 1e3, "count": r[1],
                               "name": r[2][:80]} for r in rows[:6]]})

    kernel_row["launches"] = launches
    emit({"phase": "main_path", "ok": True, "launches": launches,
          "kernel_calls": calls, "kernel_fallbacks": fallbacks,
          "steps_run": {"stage": s_stats.steps_run,
                        "trial": t_stats.steps_run},
          "launches_per_step": n_leaves,
          "same_best_trial": same_best,
          "best_trial": s_tuner.best.trial_id,
          "best_scores_bit_equal":
              s_tuner.best_score == t_tuner.best_score,
          "all_reported_losses_bit_equal": worst == 0.0,
          "all_reported_metrics_bit_equal":
              s_tuner.history == t_tuner.history,
          "max_reported_loss_difference": worst})

    # ------------------------------------------------------------ last lines
    print(smi, flush=True)
    emit({"kernels": [kernel_row]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
