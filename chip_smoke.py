#!/usr/bin/env python3
"""Smoke check of the PyTorch / CUDA package on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the package's main paths once — whole hyper-parameter studies
through ``Study.run`` → engine → ``TorchTrainer`` → the kernels — at full
width: the paper's ResNet56 (``ResNet(n=9, width=16)``, batch 128,
momentum) and qwen2-0.5b (24 layers, d_model 896, 14 / 2 heads, vocab
151,936, bf16, batch 4 × 1024 tokens, AdamW), random weights from a seed,
and holds every kernel of those paths against its plain PyTorch version on
the card.  Needs one CUDA device and no network; fails (non-zero exit, no
result line) without a GPU or outside a checkout of the repository.
Imports nothing of JAX and nothing of the JAX package.  Phases, each
printing one JSON line:

1. ``device``   — the card, as ``nvidia-smi`` names it, with its power limit;
   the CUDA kernels' ``nvcc`` build starts here, in the background.
2. ``kernels``  — the Triton update kernel (B1) is compiled from
   ``src/repro_torch/kernels/optim.py`` at first launch; sgd / momentum /
   adam / adamw × M ∈ {1, 4} members with divergent hyper-parameters × f32
   and bf16 leaves × ResNet56 leaf shapes and a ragged one are compared with
   the plain version (f32: atol 1e-6 + rtol 1e-6, the same f32 formulas with
   other contractions; bf16: one bf16 ulp, f32 math rounded once), run twice
   and required bit-equal; the whole-tree momentum update is timed at
   ResNet56's shapes and strides beside the plain version, a
   ``torch._foreach_*`` yardstick (used nowhere in the package) and the
   bytes / 3.35 TB/s bound.
3. ``small``    — ResNet8 on the card: kernel update vs plain update after 6
   steps (atol 1e-4), fused chain vs per-step loop bit for bit.
4. ``study``    — the SHA study of ``examples/torch_hpo_resnet.py`` at full
   width, stage-based and trial-based; launch counts are zeroed just before
   and read just after, and must equal steps × 114 leaves (``main_path``).
5. ``step`` / ``profile`` — where a ResNet56 step's time goes (host clock),
   and the device's busy and idle share over one 8-step chunk.
6. ``attention_kernels`` — the flash-attention kernels B2 (forward), B3
   (dq) and B4 (per-query-head dk / dv), built by ``nvcc`` from
   ``src/repro_torch/kernels/csrc/flash_attention.cu``, against their plain
   versions over MHA / GQA 4:1 / MQA / ragged 96 / head dim 128 × causal,
   non-causal, window 48 × f32 and bf16 (forward f32 2e-5, bf16 2e-2;
   gradients f32 atol 2e-4 + rtol 2e-3, bf16 2e-2), each run twice and
   required bit-equal, executed tiles equal to ``fa_tile_counts``; then at
   the main path's own shape, qwen2-0.5b's (B 4, S 1024, Hq 14, Hkv 2, hd
   64, causal, bf16): again against the plain versions on the same inputs
   (bf16 outputs within one bf16 ulp beyond 2^-16 of the tensor's largest
   value, lse atol 2e-5 + rtol 2e-5), twice bit-equal, tiles counted; timed
   there beside the plain versions, each kernel's bound, the backward's
   bound as a whole, and the library's flash forward and flash backward
   (yardsticks the package never calls).  ``lm_small``: qwen2-0.5b reduced
   (f32) on the card, loss and gradients through the kernels against the
   plain attention path (atol 1e-5 / 1e-4).
7. ``lm_study`` — the SHA study of ``examples/torch_hpo_lm.py`` at full
   width, stage-based then trial-based (the first run's checkpoints are
   dropped before the second starts); every launch count is zeroed just
   before and read just after: B2 = 24 × (steps + evaluations), B3 = B4 =
   24 × steps, B1 = 14 leaves × steps, no fallback, fewer steps stage-based,
   the same best trial and every reported metric bit-equal across modes.
8. ``lm_update`` / ``lm_step`` / ``lm_profile`` — the AdamW update of the
   whole bf16 tree against its plain version and a ``torch._fused_adamw_``
   yardstick; where a qwen2-0.5b step's time goes; the device's busy and
   idle share over one 4-step chunk.
9. last lines   — the card and its power limit, the ``kernels`` line (B1–B4)
   and ``{"ok": true, "device": {...}}``.

Any failed check raises; nothing is caught and passed over.
"""

import json
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device-memory rate (data sheet)
BF16_FLOP_PER_S = 989e12           # H100 SXM dense bf16 tensor-core peak
KERNEL_SOURCE = "src/repro_torch/kernels/optim.py"
KERNEL_REPLACES = "src/repro/kernels/optim.py:130"
FA_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
FA_REPLACES = {"B2": "src/repro/kernels/flash_attention.py:202",
               "B3": "src/repro/kernels/flash_attention.py:386",
               "B4": "src/repro/kernels/flash_attention.py:406"}
# the attention grid of tests/test_kernels.py: (B, S, Hq, Hkv, hd)
FA_SHAPES = [(1, 128, 4, 4, 64), (2, 128, 8, 2, 64), (1, 256, 8, 1, 32),
             (1, 96, 4, 2, 64), (2, 64, 2, 1, 128)]
FA_MASKS = [(True, 0), (False, 0), (True, 48)]
QWEN = dict(B=4, S=1024, Hq=14, Hkv=2, hd=64)     # qwen2-0.5b's attention
LM_FULL = dict(batch=4, seq_len=1024, n_train=256, n_eval=8)

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

    # the CUDA kernels build (one nvcc) while the Triton phases run; a
    # failed build is raised where the attention phase joins it
    from repro_torch.kernels import _cuda
    build = {}

    def build_cuda():
        t0 = time.perf_counter()
        try:
            _cuda.load("flash_attention")
        except BaseException as exc:          # re-raised after join()
            build["error"] = exc
        build["seconds"] = time.perf_counter() - t0

    builder = threading.Thread(target=build_cuda)
    builder.start()

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

    def bf16_ulps(a, c, slack=1e-6):
        """|a - c| in bf16 ulps at the larger magnitude, beyond an f32
        slack (a sum that cancels can land on either side of 0)."""
        af, cf = a.float(), c.float()
        diff = (af - cf).abs()
        _, exp = torch.frexp(torch.maximum(af.abs(), cf.abs()))
        ulp = torch.ldexp(torch.ones_like(cf), exp - 8)
        return (diff - slack).clamp(min=0) / ulp

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
                            # one bf16 ulp at the value's magnitude
                            ulps = bf16_ulps(a, c)
                            ulp_bf16 = max(ulp_bf16, float(ulps.max()))
                            bad = ulps > 1.0
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

    # ------------------------------- 6. attention kernels vs plain version
    from repro_torch.kernels import flash_attention as fa
    builder.join()
    if "error" in build:
        raise build["error"]
    fa._lib()                                   # load, check tile sizes
    gen = torch.Generator().manual_seed(12)

    def fa_inputs(B, S, Hq, Hkv, hd, dtype):
        return [torch.randn(shape, generator=gen).to(dev, dtype)
                for shape in ((B, S, Hq, hd), (B, S, Hkv, hd),
                              (B, S, Hkv, hd), (B, S, Hq, hd))]

    def within(a, b, atol, rtol):
        a, b = a.float(), b.float()
        assert bool(a.isfinite().all()) and bool(b.isfinite().all())
        return float((a - b).abs().max()), bool(
            ((a - b).abs() <= atol + rtol * b.abs()).all())

    fa_err = {k: {"float32": 0.0, "bfloat16": 0.0}
              for k in ("B2", "B3", "B4")}
    fa_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        f32 = dtype == torch.float32
        fwd_tol = (2e-5, 2e-5) if f32 else (2e-2, 2e-2)
        grad_tol = (2e-4, 2e-3) if f32 else (2e-2, 2e-2)
        for B, S, Hq, Hkv, hd in FA_SHAPES:
            for causal, window in FA_MASKS:
                q, k, v, do = fa_inputs(B, S, Hq, Hkv, hd, dtype)
                mk = dict(causal=causal, window=window)
                runs = [fa.flash_attention_fwd(q, k, v, return_lse=True,
                                               count_tiles=True, **mk)
                        for _ in range(2)]
                out, lse, tiles = runs[0]
                p_out, p_lse, p_tiles = fa.fwd_plain(q, k, v, **mk)
                delta = (do.float() * out.float()).sum(-1).transpose(
                    1, 2).contiguous()
                dqs = [fa.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                                 **mk) for _ in range(2)]
                dkvs = [fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                   **mk) for _ in range(2)]
                p_dq = fa.bwd_dq_plain(q, k, v, do, lse, delta, **mk)
                p_dk, p_dv = fa.bwd_dkv_plain(q, k, v, do, lse, delta, **mk)
                torch.cuda.synchronize()
                case = (dname, B, S, Hq, Hkv, hd, causal, window)
                for a, b in zip(runs[0][:2] + (dqs[0],) + dkvs[0],
                                runs[1][:2] + (dqs[1],) + dkvs[1]):
                    assert torch.equal(a, b), ("two launches differ", case)
                want = B * Hq * fa.fa_tile_counts(S, S, fa.BLOCK_Q,
                                                  fa.BLOCK_K, causal,
                                                  window)[0]
                assert int(tiles) == int(runs[1][2]) == p_tiles == want, (
                    "executed tiles", case, int(tiles), want)
                assert float(dqs[0].float().abs().max()) > 0
                for key, pairs, (atol, rtol) in (
                        ("B2", ((out, p_out), (lse, p_lse)), fwd_tol),
                        ("B3", ((dqs[0], p_dq),), grad_tol),
                        ("B4", ((dkvs[0][0], p_dk), (dkvs[0][1], p_dv)),
                         grad_tol)):
                    for a, b in pairs:
                        assert a.shape == b.shape and a.dtype == b.dtype
                        err, ok = within(a, b, atol, rtol)
                        fa_err[key][dname] = max(fa_err[key][dname], err)
                        assert ok, (f"{key} disagrees with its plain "
                                    f"version", case, err)
                fa_cases += 1

    # the main path's own shape: qwen2-0.5b's training attention (GQA 7,
    # 16 × 16 tiles, causal, bf16).  Each kernel against its plain version
    # on the same inputs: bf16 outputs within one bf16 ulp of the value
    # beyond an f32 slack of 2^-16 of the tensor's largest value (both sides
    # do f32 math and round once; the sums only run in another order), the
    # f32 lse within the grid's forward f32 tolerance
    B, S, Hq, Hkv, hd = (QWEN[x] for x in ("B", "S", "Hq", "Hkv", "hd"))
    shape_s = f"B {B}, S {S}, Hq {Hq}, Hkv {Hkv}, hd {hd}, causal, bf16"
    q, k, v, do = fa_inputs(B, S, Hq, Hkv, hd, torch.bfloat16)
    out, lse, tiles = fa.flash_attention_fwd(q, k, v, return_lse=True,
                                             count_tiles=True)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta)
    dk_h, dv_h = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta)
    again = (fa.flash_attention_fwd(q, k, v, return_lse=True, count_tiles=True)
             + (fa.flash_attention_bwd_dq(q, k, v, do, lse, delta),)
             + fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta))
    p_out, p_lse, _ = fa.fwd_plain(q, k, v)
    p_dq = fa.bwd_dq_plain(q, k, v, do, lse, delta)
    p_dk, p_dv = fa.bwd_dkv_plain(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    for a, b in zip((out, lse, dq, dk_h, dv_h), again[:2] + again[3:]):
        assert torch.equal(a, b), ("two launches differ", shape_s)
    want = B * Hq * fa.fa_tile_counts(S, S, fa.BLOCK_Q, fa.BLOCK_K, True,
                                      0)[0]
    assert int(tiles) == int(again[2]) == want, (int(tiles), want)
    main_err = {}
    for key, name, a, b in (("B2", "out", out, p_out),
                            ("B2", "lse", lse, p_lse),
                            ("B3", "dq", dq, p_dq),
                            ("B4", "dk_h", dk_h, p_dk),
                            ("B4", "dv_h", dv_h, p_dv)):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert bool(a.isfinite().all()) and bool(b.isfinite().all())
        diff = (a.float() - b.float()).abs()
        scale = float(b.float().abs().max())
        assert scale > 0, (key, name)
        row = {"max_abs_err": float(diff.max()), "scale": scale,
               "err_over_scale": float(diff.max()) / scale}
        if a.dtype == torch.float32:
            ok = bool((diff <= 2e-5 + 2e-5 * b.abs()).all())
            row["tolerance"] = "atol 2e-5 + rtol 2e-5"
        else:
            ulps = float(bf16_ulps(a, b, slack=scale * 2 ** -16).max())
            ok = ulps <= 1.0
            row.update(max_err_bf16_in_ulps=ulps,
                       tolerance="1 bf16 ulp beyond 2^-16 x scale")
        main_err.setdefault(key, {})[name] = row
        assert ok, (f"{key} disagrees with its plain version at the main "
                    f"path's shape", name, row)
    del again, p_out, p_lse, p_dq, p_dk, p_dv

    import torch.nn.functional as F
    # yardsticks only — the package never calls these.  The forward is
    # SDPA with GQA.  The backward is the library's flash backward alone,
    # on its own forward's residuals, over K / V repeated onto the query
    # heads: one call that computes what B3 and B4 compute together (dq and
    # the per-query-head dk_h, dv_h)
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    ke, ve = (x.repeat_interleave(Hq // Hkv, dim=1) for x in (kt, vt))

    def sdpa_fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    res = torch.ops.aten._scaled_dot_product_flash_attention(
        qt, ke, ve, 0.0, True, False)

    def sdpa_bwd():
        return torch.ops.aten._scaled_dot_product_flash_attention_backward(
            dot, qt, ke, ve, res[0], res[1], res[2], res[3], res[4], res[5],
            0.0, True, res[6], res[7])

    lib_err = {}     # the yardsticks compute the same functions (bf16 P, dS)
    for name, a, b in zip(("out", "dq", "dk_h", "dv_h"),
                          (sdpa_fwd(),) + tuple(sdpa_bwd()),
                          (out, dq, dk_h, dv_h)):
        a = a.transpose(1, 2)
        assert a.shape == b.shape, (name, a.shape, b.shape)
        lib_err[name] = float((a.float() - b.float()).abs().max()) / float(
            b.float().abs().max())
        assert lib_err[name] <= 2e-2, ("yardstick differs", name, lib_err)

    e_bf16, e_f32 = 2, 4
    n_q, n_kv, n_row = B * S * Hq * hd, B * S * Hkv * hd, B * Hq * S
    fwd_flops = 4.0 * B * Hq * S * S * hd * 0.5          # causal
    # (flops, bytes) of each kernel's function: each input read once, each
    # output written once.  Alone, B3 must recompute s and dp and form ds·K
    # (three products of the forward's two: 1.5x); B4 must recompute them
    # and form dsᵀ·Q and pᵀ·dO (2x).
    work = {
        "B2": (fwd_flops, e_bf16 * (2 * n_q + 2 * n_kv) + e_f32 * n_row),
        "B3": (1.5 * fwd_flops,
               e_bf16 * (3 * n_q + 2 * n_kv) + e_f32 * 2 * n_row),
        "B4": (2.0 * fwd_flops,
               e_bf16 * (4 * n_q + 2 * n_kv) + e_f32 * 2 * n_row)}
    # the backward as a whole (the repo's numerator,
    # benchmarks/bench_kernels.py:68-74): five products, s and dp formed
    # once, 2.5x the forward's flops and bytes
    bwd_flops = 2.5 * fwd_flops
    bwd_bytes = 2.5 * e_bf16 * (2 * n_q + 2 * n_kv)
    bwd_bound_ms = max(bwd_flops / BF16_FLOP_PER_S,
                       bwd_bytes / HBM_BYTES_PER_S) * 1e3
    fa_fn = {
        "B2": (lambda: fa.flash_attention_fwd(q, k, v, return_lse=True),
               lambda: fa.fwd_plain(q, k, v)),
        "B3": (lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta),
               lambda: fa.bwd_dq_plain(q, k, v, do, lse, delta)),
        "B4": (lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta),
               lambda: fa.bwd_dkv_plain(q, k, v, do, lse, delta))}
    lib_fwd_ms = time_ms(sdpa_fwd, reps=20, warm=3)
    lib_bwd_ms = time_ms(sdpa_bwd, reps=20, warm=3)
    fa_wrappers = {"B2": fa.flash_attention_fwd,
                   "B3": fa.flash_attention_bwd_dq,
                   "B4": fa.flash_attention_bwd_dkv}
    fa_rows = {}
    for key, (kern, plain_fn) in fa_fn.items():
        flops, nbytes = work[key]
        t_ops, t_bytes = flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
        fa_rows[key] = {
            "name": fa_wrappers[key].__name__, "route": "cuda",
            "source": FA_SOURCE,
            "replaces": FA_REPLACES[key], "launches": None,
            "max_abs_err": max(list(fa_err[key].values())
                               + [r["max_abs_err"]
                                  for r in main_err[key].values()]),
            "ms": time_ms(kern, reps=20, warm=3),
            "plain_ms": time_ms(plain_fn, reps=5, warm=1),
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            # no one library call computes dq alone or dk_h / dv_h alone:
            # the library's backward is held against B3 + B4 together in
            # the attention_kernels line
            "library_ms": lib_fwd_ms if key == "B2" else None,
            "library": ("F.scaled_dot_product_attention(enable_gqa=True)"
                        if key == "B2" else None),
            "shape": shape_s, "flops": flops, "bytes": nbytes,
            "max_abs_err_by_dtype": fa_err[key], "cases": fa_cases,
            "main_shape_vs_plain": main_err[key]}
    backward = {"ms": fa_rows["B3"]["ms"] + fa_rows["B4"]["ms"],
                "bound_ms": bwd_bound_ms, "bound_by": "operations"
                if bwd_flops / BF16_FLOP_PER_S >= bwd_bytes / HBM_BYTES_PER_S
                else "bytes",
                "flops": bwd_flops, "bytes": bwd_bytes,
                "per_kernel_bound_ms": fa_rows["B3"]["bound_ms"]
                + fa_rows["B4"]["bound_ms"],
                "library_ms": lib_bwd_ms,
                "library": "aten._scaled_dot_product_flash_attention_backward"
                           " over K / V repeated onto the query heads"}
    emit({"phase": "attention_kernels",
          "build_seconds": build["seconds"], "cases": fa_cases,
          "bit_equal_twice": True, "tiles_equal_fa_tile_counts": True,
          "max_abs_err": fa_err, "shape": shape_s,
          "main_shape_vs_plain": main_err,
          "library_vs_kernel_err_over_scale": lib_err,
          "timing": {key: {x: r[x] for x in ("ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms")}
                     for key, r in fa_rows.items()},
          "backward_b3_plus_b4": backward})
    del q, k, v, do, out, lse, delta, dq, dk_h, dv_h, qt, kt, vt, dot, ke, \
        ve, res

    # the LM on the card through the autograd binding of B2–B4, against its
    # plain attention path: qwen2-0.5b reduced (2 layers, f32), a ragged
    # sequence, loss and every gradient leaf (the CPU tests' tolerances
    # against the JAX package)
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import LM
    small_cfg = get_config("qwen2-0.5b").reduced()
    small_params = LM(small_cfg).init(0, device=dev)
    small_batch = {"tokens": torch.randint(
        0, small_cfg.vocab_size, (2, 200),
        generator=torch.Generator().manual_seed(4)).to(dev)}
    lm_small = {}
    for use_kernel in (True, False):
        (loss, _), grads = value_and_grad(
            LM(small_cfg, use_kernel=use_kernel).loss, small_params,
            small_batch)
        lm_small[use_kernel] = (loss, tree_leaves(grads))
    loss_err = abs(float(lm_small[True][0]) - float(lm_small[False][0]))
    grad_err = max(float((a - b).abs().max())
                   for a, b in zip(lm_small[True][1], lm_small[False][1]))
    assert all(bool(g.isfinite().all()) for g in lm_small[True][1])
    assert loss_err <= 1e-5 and grad_err <= 1e-4, (loss_err, grad_err)
    emit({"phase": "lm_small", "model": "qwen2-0.5b reduced",
          "layers": small_cfg.num_layers, "dtype": small_cfg.dtype,
          "tokens": [2, 200], "loss": float(lm_small[True][0]),
          "kernel_vs_plain_loss_err": loss_err, "loss_atol": 1e-5,
          "kernel_vs_plain_grad_max_abs_err": grad_err, "grad_atol": 1e-4})
    del small_params, lm_small, grads

    # --------------------------- 7. qwen2-0.5b study: the LM's main path
    import torch_hpo_lm as lm_example
    counters = (stacked_leaf_update, *fa_wrappers.values())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kops.reset_kernel_stats()
    for c in counters:                          # counts to 0 just before
        c.launches = 0
    # one trainer for both modes: its initial parameters are drawn once,
    # here, outside the timed runs (the draw launches no kernel)
    lm_backend = lm_example.make_backend(use_kernel=True, **LM_FULL)
    lm_cfg = lm_backend.task.cfg
    assert lm_backend.task.use_kernel and lm_cfg.dtype == "bfloat16"
    assert (lm_cfg.num_layers, lm_cfg.d_model, lm_cfg.num_heads,
            lm_cfg.num_kv_heads, lm_cfg.vocab_size) == (24, 896, 14, 2,
                                                        151936)
    t0 = time.perf_counter()
    lm_params0 = lm_backend.init_state()["params"]
    lm_init_s = time.perf_counter() - t0
    lm_leaves = len(tree_leaves(lm_params0))
    lm_n_params = sum(p.numel() for p in tree_leaves(lm_params0))
    assert lm_n_params == lm_cfg.param_count(), lm_n_params
    n_layers = lm_cfg.num_layers
    lm_runs = {}
    for share in (True, False):
        evals0 = lm_backend.evaluations
        calls0 = kops.KERNEL_STATS.calls
        stats, tuner, store, wall = lm_example.run_study(
            lm_backend, share, batch=LM_FULL["batch"])
        torch.cuda.synchronize()
        assert tuner.is_done() and tuner.best is not None
        assert stats.kernel_fallbacks == 0 and stats.kernel_calls > 0
        assert stats.chain_fused_stages > 0
        assert stats.ckpt_async_writes == stats.ckpt_saves > 0
        assert store.pending_writes == 0
        n_ckpts = 0
        for cid in store.committed_ids():
            leaves = tree_leaves(store.get(cid)["params"])
            assert len(leaves) == lm_leaves
            assert all(l.is_cuda and bool(l.isfinite().all())
                       for l in leaves)
            n_ckpts += 1
        assert n_ckpts > 0
        lm_runs[share] = dict(stats=stats, tuner=tuner, wall=wall,
                              ckpts=n_ckpts,
                              evals=lm_backend.evaluations - evals0,
                              calls=kops.KERNEL_STATS.calls - calls0)
        del store       # this run's checkpoints go before the next run
        torch.cuda.empty_cache()
    lm_launches = {c.__name__: c.launches for c in counters}  # just after
    lm_calls, lm_fallbacks = kops.KERNEL_STATS.snapshot()
    lm_peak = torch.cuda.max_memory_allocated()

    lm_steps = sum(r["stats"].steps_run for r in lm_runs.values())
    lm_evals = sum(r["evals"] for r in lm_runs.values())
    assert lm_fallbacks == 0, kops.KERNEL_STATS.reasons
    assert lm_launches["flash_attention_fwd"] == \
        n_layers * (lm_steps + lm_evals), (lm_launches, lm_steps, lm_evals)
    assert lm_launches["flash_attention_bwd_dq"] == n_layers * lm_steps
    assert lm_launches["flash_attention_bwd_dkv"] == n_layers * lm_steps
    assert lm_launches["stacked_leaf_update"] == lm_leaves * lm_steps
    assert lm_calls == lm_steps + n_layers * (lm_steps + lm_evals)
    s_run, t_run = lm_runs[True], lm_runs[False]
    assert s_run["stats"].steps_run < t_run["stats"].steps_run
    s_hist, t_hist = s_run["tuner"].history, t_run["tuner"].history
    assert s_hist == t_hist, "a reported metric differs across modes"
    assert all(m["loss"] == m["loss"] for m in s_hist.values())  # no NaN
    lm_best = s_run["tuner"].best.trial_id
    assert lm_best == t_run["tuner"].best.trial_id
    assert s_run["tuner"].best_score == t_run["tuner"].best_score
    emit({"phase": "lm_study", "model": "qwen2-0.5b", "dtype": "bfloat16",
          "layers": n_layers, "d_model": lm_cfg.d_model,
          "heads": [lm_cfg.num_heads, lm_cfg.num_kv_heads],
          "vocab": lm_cfg.vocab_size, "parameters": lm_n_params,
          "leaves": lm_leaves, "init_draw_seconds": lm_init_s,
          "batch": LM_FULL["batch"],
          "seq_len": LM_FULL["seq_len"], "optimizer": "adamw",
          "modes": {("stage" if share else "trial"): {
              "steps_run": r["stats"].steps_run,
              "stages_run": r["stats"].stages_run,
              "evaluations": r["evals"],
              "chain_fused_stages": r["stats"].chain_fused_stages,
              "ckpt_saves": r["stats"].ckpt_saves,
              "checkpoints_held": r["ckpts"],
              "kernel_calls": r["calls"],
              "wall_seconds": r["wall"],
              "steps_per_second": r["stats"].steps_run / r["wall"]}
              for share, r in lm_runs.items()},
          "launches": lm_launches, "kernel_calls": lm_calls,
          "kernel_fallbacks": lm_fallbacks,
          "expected": {
              "flash_attention_fwd": f"{n_layers} x (steps + evaluations)",
              "flash_attention_bwd_dq": f"{n_layers} x steps",
              "flash_attention_bwd_dkv": f"{n_layers} x steps",
              "stacked_leaf_update": f"{lm_leaves} x steps"},
          "best_trial": lm_best, "same_best_trial": True,
          "best_val_acc": s_run["tuner"].best_score,
          "all_reported_metrics_bit_equal": True,
          "reported_results": len(s_hist),
          "peak_device_memory_bytes": lm_peak,
          "peak_device_memory_gib": lm_peak / 2 ** 30})

    # ------------------- 8. the LM's AdamW update, step and device profile
    lm_slab = lm_backend._upload(lm_backend.pipeline_factory().next_batches(4))
    lm_batch0 = {k: v[0] for k, v in lm_slab.items()}
    (_, _), lm_grads = value_and_grad(lm_backend.task.loss, lm_params0,
                                      lm_batch0)
    lm_strided = sum(not g.is_contiguous() for g in tree_leaves(lm_grads))
    gen_s = torch.Generator(device="cuda").manual_seed(2)
    lm_opt = {slot: tree_map(lambda p: (1e-3 * torch.rand(
        p.shape, device=dev, generator=gen_s)).to(p.dtype), lm_params0)
        for slot in ("m", "v")}
    lm_hp = {"lr": torch.tensor(3e-4, device=dev)}
    lm_step_t = torch.tensor(3, dtype=torch.int32, device=dev)
    new_k, st_k = fused_apply_update("adamw", lm_params0, lm_grads, lm_opt,
                                     lm_hp, lm_step_t)
    new_p, st_p = apply_update("adamw", lm_params0, lm_grads, lm_opt, lm_hp,
                               lm_step_t)
    torch.cuda.synchronize()
    upd_ulps, upd_err = 0.0, 0.0
    for a, c in zip(tree_leaves((new_k, st_k)), tree_leaves((new_p, st_p))):
        assert a.dtype == c.dtype == torch.bfloat16
        upd_ulps = max(upd_ulps, float(bf16_ulps(a, c).max()))
        upd_err = max(upd_err, float((a.float() - c.float()).abs().max()))
    assert upd_ulps <= 1.0, upd_ulps
    del new_k, st_k, new_p, st_p
    lib_lists = [[t.clone() for t in tree_leaves(x)]
                 for x in (lm_params0, lm_grads, lm_opt["m"], lm_opt["v"])]
    lib_steps = [torch.tensor(4.0, device=dev) for _ in lib_lists[0]]

    def fused_adamw():   # yardstick only — the package never calls this
        torch._fused_adamw_(*lib_lists, [], lib_steps, lr=3e-4, beta1=0.9,
                            beta2=0.999, weight_decay=0.0, eps=1e-8,
                            amsgrad=False, maximize=False)

    ref_p, _ = apply_update("adamw", lm_params0, lm_grads, lm_opt, lm_hp,
                            lm_step_t)
    fused_adamw()
    torch.cuda.synchronize()
    lib_ulps = max(float(bf16_ulps(a, c).max())
                   for a, c in zip(lib_lists[0], tree_leaves(ref_p)))
    assert lib_ulps <= 1.0, lib_ulps               # the same function
    del ref_p
    tree_bytes = 7 * lm_n_params * 2     # read p, g, m, v; write p, m, v
    b1_row = {
        "name": "opt_update", "route": "triton", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": lm_launches["stacked_leaf_update"],
        "launches_resnet56_study": launches,
        "max_abs_err": upd_err,
        "ms": time_ms(lambda: fused_apply_update(
            "adamw", lm_params0, lm_grads, lm_opt, lm_hp, lm_step_t),
            reps=10, warm=2),
        "plain_ms": time_ms(lambda: apply_update(
            "adamw", lm_params0, lm_grads, lm_opt, lm_hp, lm_step_t),
            reps=10, warm=2),
        "bound_ms": tree_bytes / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": time_ms(fused_adamw, reps=10, warm=2),
        "library": "torch._fused_adamw_",
        "shape": f"qwen2-0.5b tree, adamw, bf16: {lm_leaves} leaves "
                 f"(12 stacked (24, ...)), {lm_n_params} parameters, one "
                 f"launch per leaf; {lm_strided} gradient leaves strided",
        "max_err_bf16_in_ulps": upd_ulps,
        "resnet56_momentum_f32": {x: kernel_row[x] for x in (
            "ms", "plain_ms", "bound_ms", "library_ms", "max_abs_err",
            "shape")},
        "variants": kernel_row["variants"]}
    del lib_lists
    emit({"phase": "lm_update", "optimizer": "adamw", "dtype": "bfloat16",
          "leaves": lm_leaves, "parameters": lm_n_params,
          "strided_gradient_leaves": lm_strided,
          "max_err_bf16_in_ulps": upd_ulps,
          "library_max_err_bf16_in_ulps": lib_ulps,
          **{x: b1_row[x] for x in ("ms", "plain_ms", "bound_ms",
                                    "library_ms")}})

    lm_carry = (lm_params0, lm_opt)
    lm_steps4 = torch.arange(4, dtype=torch.int32, device=dev)
    lm_hp_xs = {"lr": torch.full((4,), 3e-4, device=dev)}
    lm_step_ms = host_ms(lambda: lm_backend._run_chunk(
        "adamw", lm_carry, {}, lm_hp_xs, lm_slab, lm_steps4), 2) / 4
    lm_grad_ms = host_ms(lambda: value_and_grad(
        lm_backend.task.loss, lm_params0, lm_batch0), 3)
    lm_upd_ms = host_ms(lambda: fused_apply_update(
        "adamw", lm_params0, lm_grads, lm_opt, lm_hp, lm_step_t), 3)
    attn_fwd_ms = n_layers * fa_rows["B2"]["ms"]
    attn_bwd_ms = n_layers * (fa_rows["B3"]["ms"] + fa_rows["B4"]["ms"])
    emit({"phase": "lm_step", "model": "qwen2-0.5b",
          "batch": LM_FULL["batch"], "seq_len": LM_FULL["seq_len"],
          "step_ms": lm_step_ms, "steps_per_second": 1e3 / lm_step_ms,
          "tokens_per_second": LM_FULL["batch"] * LM_FULL["seq_len"]
          * 1e3 / lm_step_ms,
          "loss_fwd_bwd_ms": lm_grad_ms,
          "attention_fwd_ms": attn_fwd_ms, "attention_bwd_ms": attn_bwd_ms,
          "attention_share_of_step": (attn_fwd_ms + attn_bwd_ms)
          / lm_step_ms,
          "optimizer_update_ms": lm_upd_ms,
          "optimizer_update_share_of_step": lm_upd_ms / lm_step_ms,
          "clock": "host, synchronised at both ends; attention = 24 x the "
                   "kernels' CUDA-event times of phase attention_kernels"})
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        lm_backend._run_chunk("adamw", lm_carry, {}, lm_hp_xs, lm_slab,
                              lm_steps4)
        torch.cuda.synchronize()
    rows = sorted(((dev_time(e), e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and dev_time(e) > 0),
                  reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    chunk_ms = lm_step_ms * 4
    emit({"phase": "lm_profile", "window": "one 4-step chunk",
          "chunk_ms_without_profiler": chunk_ms,
          "device_busy_ms": busy_ms if rows else "not measured",
          "device_idle_share": (1.0 - busy_ms / chunk_ms) if rows
          else "not measured",
          "device_kernel_launches_per_step": sum(r[1] for r in rows) / 4,
          "top_device_time": [{"ms": r[0] / 1e3, "count": r[1],
                               "name": r[2][:80]} for r in rows[:8]]})
    for key, c in fa_wrappers.items():
        fa_rows[key]["launches"] = lm_launches[c.__name__]

    # ------------------------------------------------------------ last lines
    print(smi, flush=True)
    emit({"kernels": [b1_row, fa_rows["B2"], fa_rows["B3"], fa_rows["B4"]]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
