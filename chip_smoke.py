#!/usr/bin/env python3
"""Smoke check of the PyTorch / CUDA package on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the package's main paths once — whole hyper-parameter studies
through ``Study.run`` → engine → ``TorchTrainer`` → the kernels — at full
width: the paper's ResNet56 (``ResNet(n=9, width=16)``, batch 128,
momentum), qwen2-0.5b (24 layers, d_model 896, 14 / 2 heads, vocab
151,936, bf16, batch 4 × 1024 tokens, AdamW) and mamba2-2.7b (d_model
2560, 80 SSD heads of 64, state 128, chunk 128, vocab 50,280, bf16, batch
1 × 2048 tokens, AdamW; the study at 32 of its 64 layers, the steps at
all 64), random weights from a seed, and holds every kernel of those paths
against its plain PyTorch version on the card.  Needs one CUDA device and
no network; fails (non-zero exit, no result line) without a GPU or outside
a checkout of the repository.
Imports nothing of JAX and nothing of the JAX package.  Each phase is a
function, so the device tensors it made are freed when it returns.
Phases, each printing one JSON line:

1. ``device``   — the card, as ``nvidia-smi`` names it, with its power limit;
   the CUDA kernels' ``nvcc`` build starts here, in the background.
2. ``kernels``  — B1.  The per-leaf Triton kernel of the first port
   (``src/repro_torch/kernels/optim.py``, compiled at first launch):
   sgd / momentum / adam / adamw × M ∈ {1, 4} members with divergent
   hyper-parameters × f32 and bf16 leaves × ResNet56 leaf shapes and a
   ragged one against the plain version (f32: atol 1e-6 + rtol 1e-6, the
   same f32 formulas with other contractions; bf16: one bf16 ulp, f32 math
   rounded once), run twice and required bit-equal.  The tree kernel
   (``csrc/optim.cu``, one launch per tree) bit-equal (``torch.equal``) to
   the per-leaf kernel over the same grid as one-leaf trees and as trees of
   all four shapes, contiguous and with HWIO-strided gradients, and a tree
   of f32 and bf16 leaves; then on ResNet56's tree at its shapes and
   strides (twice each, bit-equal; against the plain version), timed by
   CUDA events and by the profiler beside the per-leaf kernel, the plain
   version, a ``torch._foreach_*`` yardstick (used nowhere in the package)
   and the bytes / 3.35 TB/s bound.
3. ``small``    — ResNet8 on the card: kernel update vs plain update after 6
   steps (atol 1e-4), fused chain vs per-step loop bit for bit.
4. ``study``    — the SHA study of ``examples/torch_hpo_resnet.py`` at full
   width, stage-based and trial-based; launch counts are zeroed just before
   and read just after: one tree-kernel launch per step, no per-leaf
   launch (``main_path``).
5. ``step`` / ``profile`` — where a ResNet56 step's time goes, and the
   device's busy and idle share over one 8-step chunk.
6. ``attention_kernels`` — the flash-attention kernels B2 (forward), B3
   (dq) and B4 (per-query-head dk / dv), built by ``nvcc`` from
   ``src/repro_torch/kernels/csrc/flash_attention.cu``: bf16 on the tensor
   cores (``fa_fwd_tc``, ``fa_bwd_dq_tc``, ``fa_bwd_dkv_tc``), f32 on the
   CUDA cores (``fa_fwd``, ``fa_bwd_dq``, ``fa_bwd_dkv``).  Against their
   plain versions over MHA / GQA 4:1 / MQA / ragged 96 / head dim 32, 64,
   128 × causal, non-causal, window 48 × f32 and bf16 (forward f32 2e-5;
   bf16 ``out``, ``dq``, ``dk_h``, ``dv_h`` by ``rounding_rule`` against
   the plain version on the inputs cast to f32 — one bf16 ulp + 2^-16 ×
   scale + what rounding p or dS to bf16 before a product can move, 2^-8
   × (p/l)|v|, |dS||K|, |dS|ᵀ|Q|, pᵀ|dO| —, lse atol 2e-5 + rtol 2e-5;
   gradients also f32 atol 2e-4 + rtol 2e-3, bf16 2e-2), each run twice
   and required bit-equal, executed tiles equal to ``fa_tile_counts`` at
   the tiles of the kernel the dtype routes to (every bf16 case on the
   tensor-core kernels, every f32 one on the others, counted); then at the
   main path's own shape, qwen2-0.5b's (B 4, S 1024, Hq 14, Hkv 2, hd 64,
   causal, bf16), and at qwen3-8b's hd-128 attention (B 1, S 2048, Hq 32,
   Hkv 8, causal): again against the plain versions on the same inputs by
   the same rules, twice bit-equal, tiles counted, and the backward within
   2e-2 of the library's; timed there beside the plain versions, each
   kernel's bound, the backward's bound as a whole, and the library's flash
   forward and flash backward (yardsticks the package never calls), the
   earlier CUDA-core kernels' times beside, marked as figures from the
   record.  ``lm_small``: qwen2-0.5b reduced (f32) on the card, loss and
   gradients through the kernels against the plain attention path (atol
   1e-5 / 1e-4), B2–B4 on the CUDA-core kernels only.
7. ``lm_study`` — the SHA study of ``examples/torch_hpo_lm.py`` at full
   width, stage-based then trial-based (the first run's checkpoints are
   dropped before the second starts); every launch count is zeroed just
   before and read just after: B2 = 24 × (steps + evaluations) = 1,392,
   B3 = B4 = 24 × steps = 1,152, every one on the tensor-core kernels, B1
   = one tree-kernel launch per step, no per-leaf or SSD launch, no
   fallback, fewer
   steps stage-based, the same best trial and every reported metric
   bit-equal across modes.
8. ``lm_update`` / ``lm_step`` / ``lm_profile`` — the AdamW update of the
   whole bf16 tree by the tree kernel against its plain version, bit-equal
   to the per-leaf kernel, timed beside it and a ``torch._fused_adamw_``
   yardstick; where a qwen2-0.5b step's time goes; the device's busy and
   idle share over one 4-step chunk.
9. ``ssd_kernels`` — the SSD kernels B5 (forward) and B6 (backward),
   built by ``nvcc`` from ``src/repro_torch/kernels/csrc/ssd_scan.cu``
   (beside the attention kernels' build), against their plain versions on
   the SSD grid of ``tests/test_kernels.py`` plus a ragged case with the
   model's decays × f32 and bf16 (forward f32 2e-5, bf16 2e-2; gradients
   2e-3, 2e-2 where rounded to bf16), then at the main path's own shape,
   one mamba2-2.7b layer (B 1, nc 16, Q 128, H 80, P 64, N 128): bf16 with
   the model's decays, so that ``cum`` falls to about −1,000 and ``exp``
   above the diagonal would overflow, and bf16 and f32 with the JAX tests'
   small decays, so that the tiles far off the diagonal carry weight (bf16
   outputs within one bf16 ulp beyond 2^-16 of the tensor's largest value,
   f32 outputs within 1e-5 of it); every output finite, each kernel run
   twice and bit-equal; timed beside the plain versions and the bound.  B6
   in bf16 runs on the tensor cores (``ssd_bwd_tc``, counted in
   ``launches_tc``) and is also held against, and timed beside, the
   CUDA-core kernels it replaces (``ssd_bwd``, which f32 keeps), within the
   grid's 2e-2; its head-sum scratch's bytes are printed.
   ``mamba2_small``: mamba2-2.7b reduced (f32), loss and gradients through
   the kernels against the plain SSD path (atol 1e-5 / 1e-4).
10. ``mamba2_study`` — the SHA study of ``examples/torch_hpo_lm.py`` with
   mamba2-2.7b at full width and 32 layers, stage-based then trial-based
   (the first run's checkpoints are dropped before the second starts);
   every launch count is zeroed just before and read just after: B5 = 32 ×
   (steps + evaluations), B6 = 32 × steps (every one on the tensor cores),
   B1 = one tree-kernel launch per step, no attention launch, no fallback,
   fewer steps stage-based, the same best
   trial and every reported metric bit-equal across modes; the peak device
   memory.
11. ``mamba2_step`` / ``mamba2_profile`` — the full 64-layer model: step
   time, tokens/s, the share of B5 + B6 in a step, the AdamW update alone,
   peak memory; the device's busy and idle share over one 2-step chunk and
   its top device time by kernel name.  ``mamba2_update``: B1 on the
   64-layer tree (bf16 and f32 leaves, one launch) bit-equal to the
   per-leaf kernel, timed beside it, its bound and ``torch._fused_adamw_``.
12. last lines  — the card and its power limit, the ``kernels`` line
   (B1's tree kernel, B2–B6) and ``{"ok": true, "device": {...}}``.

Any failed check raises; nothing is caught and passed over.
"""

import gc
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
DEV = torch.device("cuda")
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device-memory rate (data sheet)
BF16_FLOP_PER_S = 989e12           # H100 SXM dense bf16 tensor-core peak
KERNEL_SOURCE = "src/repro_torch/kernels/optim.py"     # the per-leaf kernel
B1_SOURCE = "src/repro_torch/kernels/csrc/optim.cu"    # the tree kernel
KERNEL_REPLACES = "src/repro/kernels/optim.py:130"
CUDA_SOURCES = ("flash_attention", "ssd_scan", "optim")
FA_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
FA_REPLACES = {"B2": "src/repro/kernels/flash_attention.py:202",
               "B3": "src/repro/kernels/flash_attention.py:386",
               "B4": "src/repro/kernels/flash_attention.py:406"}
# the attention grid of tests/test_kernels.py: (B, S, Hq, Hkv, hd)
FA_SHAPES = [(1, 128, 4, 4, 64), (2, 128, 8, 2, 64), (1, 256, 8, 1, 32),
             (1, 96, 4, 2, 64), (2, 64, 2, 1, 128)]
FA_MASKS = [(True, 0), (False, 0), (True, 48)]
QWEN = dict(B=4, S=1024, Hq=14, Hkv=2, hd=64)     # qwen2-0.5b's attention
QWEN3 = dict(B=1, S=2048, Hq=32, Hkv=8, hd=128)   # qwen3-8b's, at hd 128
# B2 at qwen2-0.5b's shape before the tensor-core kernel: the CUDA-core
# kernel's bf16 instantiation, median of four runs on an NVIDIA H100 80GB
# HBM3, 700.00 W (PERF.md, kernel table).  A figure from the record,
# printed as such in the attention_kernels line and never in the kernels
# line; it cannot be measured here, since that instantiation is gone.
B2_CUDA_CORE_MS = 0.615
# B3 and B4 at the same shape before the tensor-core kernels: the CUDA-core
# kernels' bf16 instantiations, medians of five runs on an NVIDIA H100 80GB
# HBM3, 700.00 W (PERF.md, kernel table); figures from the record, printed
# as such, as B2's above.
B3_CUDA_CORE_MS = 0.746
B4_CUDA_CORE_MS = 0.971
LM_FULL = dict(batch=4, seq_len=1024, n_train=256, n_eval=8)
SSD_SOURCE = "src/repro_torch/kernels/csrc/ssd_scan.cu"
SSD_REPLACES = {"B5": "src/repro/kernels/ssd_scan.py:87",
                "B6": "src/repro/kernels/ssd_scan.py:189"}
# the SSD grid of tests/test_kernels.py: (B, nc, Q, H, P, N)
SSD_SHAPES = [(1, 2, 16, 2, 16, 16), (2, 3, 32, 4, 16, 24),
              (1, 1, 64, 1, 32, 32), (1, 4, 8, 8, 8, 8)]
SSD_RAGGED = (1, 2, 96, 2, 40, 20)     # ragged tiles, the model's decays
MAMBA = dict(B=1, nc=16, Q=128, H=80, P=64, N=128)   # mamba2-2.7b's SSD
MAMBA_STUDY = dict(batch=1, seq_len=2048, n_train=64, n_eval=2, layers=32)
RESNET_FULL = dict(n=9, width=16, n_train=8192, n_eval=512, batch=128)
RESNET_LEAVES = 114

SHAPES = [(3, 3, 64, 64), (64,), (64, 10), (3, 3, 5, 7)]   # last one ragged
HPS = {"lr": 0.05, "wd": 0.01, "mom": 0.9, "b1": 0.9, "b2": 0.999,
       "eps": 1e-8}
ADAM_HPS = dict(HPS, lr=1e-3)


def emit(obj):
    print(json.dumps(obj), flush=True)


def free():
    """Give back to the card what the phase that returned left behind."""
    gc.collect()
    torch.cuda.empty_cache()


def time_ms(fn, reps=30, warm=5, windows=3):
    """Milliseconds of ``fn`` on CUDA events: the mean over ``reps``
    back-to-back calls, the median of ``windows`` such windows (one stall
    of the host — a collection, a page fault — in one window then moves
    nothing)."""
    for _ in range(warm):
        fn()
    got = []
    for _ in range(windows):
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        got.append(e0.elapsed_time(e1) / reps)
    return sorted(got)[len(got) // 2]


def device_ms(fn, reps=20, expect=None):
    """Device time of the CUDA kernels one call of ``fn`` launches, from
    the profiler's trace: unlike ``time_ms`` it leaves out the host's time
    between launches, which a kernel of tens of microseconds can wait on.
    ``expect``: a kernel name fragment that one call launches once; the
    trace is then divided by the calls it holds of that kernel (the
    profiler has been seen to drop whole calls' records of a long run), and
    none is "not measured"."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    us = sum(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0)) for e in rows)
    if expect is not None:
        reps = sum(e.count for e in rows if expect in e.key)
    return us / 1e3 / reps if us > 0 and reps > 0 else "not measured"


def launch_us(fn, reps=200):
    """Host microseconds per call of ``fn`` while the device keeps up: the
    calls are not synchronised, so this is the wrapper's own time (checks,
    allocation, the launch) that a kernel can wait on between launches."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def host_ms(fn, reps):
    """Mean milliseconds of ``fn`` on the host clock, synchronised at both
    ends, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def bf16_ulps(a, c, slack=1e-6):
    """|a - c| in bf16 ulps at the larger magnitude, beyond an f32 slack
    (a sum that cancels can land on either side of 0)."""
    af, cf = a.float(), c.float()
    diff = (af - cf).abs()
    _, exp = torch.frexp(torch.maximum(af.abs(), cf.abs()))
    ulp = torch.ldexp(torch.ones_like(cf), exp - 8)
    return (diff - slack).clamp(min=0) / ulp


def within(a, b, atol, rtol):
    """(max |a - b|, whether every element is within atol + rtol |b|)."""
    a, b = a.float(), b.float()
    assert bool(a.isfinite().all()) and bool(b.isfinite().all())
    return float((a - b).abs().max()), bool(
        ((a - b).abs() <= atol + rtol * b.abs()).all())


def at_scale(a, b, f32_rule):
    """One output of a kernel against its plain version on the same inputs
    at the main path's shape: a bf16 output within one bf16 ulp of the
    value beyond an f32 slack of 2^-16 of the tensor's largest value (both
    sides do f32 math and round once; the sums only run in another order);
    an f32 output by ``f32_rule`` = (its text, ok(diff, b, scale)).
    Returns (the row to print, whether it holds)."""
    assert a.shape == b.shape and a.dtype == b.dtype
    assert bool(a.isfinite().all()) and bool(b.isfinite().all())
    diff = (a.float() - b.float()).abs()
    scale = float(b.float().abs().max())
    assert scale > 0
    row = {"max_abs_err": float(diff.max()), "scale": scale,
           "err_over_scale": float(diff.max()) / scale}
    if a.dtype == torch.float32:
        row["tolerance"], ok_fn = f32_rule
        return row, ok_fn(diff, b, scale)
    ulps = float(bf16_ulps(a, b, slack=scale * 2 ** -16).max())
    row.update(max_err_bf16_in_ulps=ulps,
               tolerance="1 bf16 ulp beyond 2^-16 x scale")
    return row, ulps <= 1.0


def rounding_rule(a, ref, env, reference, env_text):
    """A bf16 output of a tensor-core kernel against its plain version on
    the inputs cast to f32 (``ref``, f32).  The kernel rounds an
    intermediate to bf16 before a product: B2 every probability before
    p·v (``env = (p/l)·|v|``), B3 / B4 dS before dS·K and dSᵀ·Q (``env``
    = |dS|·|K|, |dS|ᵀ·|Q|) and p before pᵀ·dO (``env = pᵀ·|dO|``), as the
    library's kernels do.  Each rounded value moves by at most half a bf16
    ulp, 2^-8 of itself, so an output moves by at most 2^-8 · ``env``, the
    same product on absolute values, in f32.  Allowed per element: that,
    plus one bf16 ulp of the value (the output's own rounding) and 2^-16
    of the tensor's largest value (f32 sums in another order).  The
    reference is the unrounded one, not a plain version that rounds too,
    because the two would round on different grids: their f32
    intermediates differ in the last bits (sums in other orders; exp2 of
    log2-scaled scores), and, in a row that spans more than one key tile,
    B2 rounds p against the running max and then rescales its accumulator
    by a factor that is not a power of 2, so most of that row's
    probabilities round to another neighbour.
    Returns (the row to print, whether it holds)."""
    assert a.shape == ref.shape == env.shape
    assert a.dtype == torch.bfloat16 and ref.dtype == torch.float32
    assert bool(a.isfinite().all()) and bool(ref.isfinite().all())
    diff = (a.float() - ref).abs()
    scale = float(ref.abs().max())
    _, exp = torch.frexp(torch.maximum(a.float().abs(), ref.abs()))
    ulp = torch.ldexp(torch.ones_like(diff), exp - 8)
    ratio = float((diff / (scale * 2 ** -16 + ulp + 2 ** -8 * env)).max())
    return ({"max_abs_err": float(diff.max()), "scale": scale,
             "err_over_scale": float(diff.max()) / scale,
             "max_err_over_allowed": ratio, "reference": reference,
             "tolerance": f"1 bf16 ulp + 2^-16 x scale + 2^-8 x {env_text}"},
            ratio <= 1.0)


def p_rounding_rule(a, ref, env):
    """B2's bf16 ``out`` by :func:`rounding_rule` against ``fwd_plain``
    with f32 probabilities, ``env = (p/l)·|v|``."""
    return rounding_rule(a, ref, env,
                         "fwd_plain on the inputs cast to f32 (f32 p)",
                         "(p/l)|v|")


def ds_rounding_rule(fa, q, k, v, do, lse, delta, got, mk):
    """B3's dq and B4's dk_h, dv_h (``got``, bf16) by :func:`rounding_rule`
    against the plain backward on the inputs cast to f32 (f32 p and dS),
    with ``env`` = |dS|·|K|, |dS|ᵀ·|Q| and pᵀ·|dO|.  Returns {name: row}
    and whether all three hold."""
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    p, ds = fa._probs_and_ds(qf, kf, vf, lse, delta, dof, mk["causal"],
                             mk["window"])
    group = q.shape[2] // k.shape[2]
    kh, qh, doh = fa._heads(kf, group), fa._heads(qf), fa._heads(dof)
    del qf, kf, vf, dof
    pt, dst = p.transpose(-1, -2), ds.transpose(-1, -2)
    parts = {"dq": (lambda: ds @ kh, lambda: ds.abs() @ kh.abs(),
                    "|dS||K|"),
             "dk_h": (lambda: dst @ qh, lambda: dst.abs() @ qh.abs(),
                      "|dS|^T|Q|"),
             "dv_h": (lambda: pt @ doh, lambda: pt @ doh.abs(),
                      "P^T|dO|")}
    rows, ok_all = {}, True
    for name, a in zip(("dq", "dk_h", "dv_h"), got):
        ref_fn, env_fn, env_text = parts[name]
        row, ok = rounding_rule(
            a, ref_fn().transpose(1, 2), env_fn().transpose(1, 2),
            "the plain backward on the inputs cast to f32 (f32 p, dS)",
            env_text)
        rows[name], ok_all = row, ok_all and ok
    return rows, ok_all


def device_profile(fn, n_steps, chunk_ms, match=None, top=8):
    """The device's busy and idle share while ``fn`` runs one
    ``n_steps``-step chunk: device time of the CUDA kernels in the
    profiler's trace (the profiler slows the host, not the kernels) against
    ``chunk_ms``, the chunk's wall time measured without it.  ``match``
    picks the package's own kernels out by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev_time = lambda e: getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0.0))
    rows = sorted(((dev_time(e), e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and dev_time(e) > 0),
                  reverse=True)
    seen = lambda x: x if rows else "not measured"
    busy_ms = sum(r[0] for r in rows) / 1e3
    out = {"window": f"one {n_steps}-step chunk",
           "chunk_ms_without_profiler": chunk_ms,
           "device_busy_ms": seen(busy_ms),
           "device_idle_share": seen(1.0 - busy_ms / chunk_ms),
           "device_kernel_launches_per_step": sum(r[1] for r in rows)
           / n_steps}
    if match is not None:
        mine_ms = sum(r[0] for r in rows if match in r[2]) / 1e3
        out.update(port_kernels=match, port_kernels_device_ms=seen(mine_ms),
                   port_kernels_share_of_busy=seen(mine_ms / max(busy_ms,
                                                                 1e-9)))
    out["top_device_time"] = [{"ms": r[0] / 1e3, "count": r[1],
                               "name": r[2][:80]} for r in rows[:top]]
    return out


def held_checkpoints(store, n_leaves):
    """How many checkpoints a finished study's store holds; each one's
    parameters on the card, finite, ``n_leaves`` leaves."""
    from repro_torch.utils.tree import tree_leaves
    n = 0
    for cid in store.committed_ids():
        leaves = tree_leaves(store.get(cid)["params"])
        assert len(leaves) == n_leaves
        assert all(l.is_cuda and bool(l.isfinite().all()) for l in leaves)
        n += 1
    assert n > 0
    return n


def start_builds():
    """Build every CUDA source in the background, one ``nvcc`` each, all
    at once; returns ``join(name)`` → the seconds the build of
    ``csrc/<name>.cu`` took, raising its failure."""
    from repro_torch.kernels import _cuda
    builds = {}

    def build(name):
        t0 = time.perf_counter()
        try:
            _cuda.load(name)
        except BaseException as exc:          # re-raised by join()
            builds[name] = exc
            return
        builds[name] = time.perf_counter() - t0

    threads = {name: threading.Thread(target=build, args=(name,))
               for name in CUDA_SOURCES}
    for thread in threads.values():
        thread.start()

    def join(name):
        threads[name].join()
        if isinstance(builds[name], BaseException):
            raise builds[name]
        return builds[name]
    return join


# ------------------------------------------------------------------ 1. device
def device_phase():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi, kind


# ---------------------------------------------- 2. B1 against its plain version
def b1_operands(name, M, shapes, dtypes, seed, strided=False):
    """A tree of ``(M, *shape)`` leaves for optimizer ``name`` on the card
    — p, g (and m, v) — and its per-member ``(M,)`` f32 scalars, divergent
    per member.  ``strided``: every 4-D leaf's gradient an HWIO view of an
    OIHW tensor, as the ResNet's convolution hands it over."""
    from repro_torch.kernels.optim import _SPEC
    rng = np.random.default_rng(seed)
    narr, snames, _ = _SPEC[name]
    trees = [[] for _ in range(narr)]
    for shape, dtype in zip(shapes, dtypes):
        full = (M,) + shape
        vals = [rng.normal(size=full), 0.1 * rng.normal(size=full)]
        vals += [0.01 + 0.01 * rng.uniform(size=full)
                 for _ in range(narr - 2)]
        for i, v in enumerate(vals):
            t = torch.tensor(v, dtype=torch.float32, device=DEV).to(dtype)
            if i == 1 and strided and len(shape) == 4:
                t = t.permute(0, 4, 3, 1, 2).contiguous().permute(
                    0, 3, 4, 2, 1)
                assert not t.is_contiguous()
            trees[i].append(t)
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
    return trees, [torch.tensor(vals[k], device=DEV) for k in snames]


def b1_tree_vs_leaf(name, trees, scal):
    """The tree kernel twice and the per-leaf Triton kernel (the first
    port's design, strided gradients copied first) on the same operands:
    one launch a call, every output leaf ``torch.equal`` across the three.
    Returns the tree kernel's outputs."""
    from repro_torch.kernels.optim import (stacked_leaf_update,
                                           stacked_tree_update)
    n0 = stacked_tree_update.launches
    got = stacked_tree_update(name, *trees, *scal)
    again = stacked_tree_update(name, *trees, *scal)
    assert stacked_tree_update.launches - n0 == 2, "one launch a tree"
    leaf = [stacked_leaf_update(name, *(t.contiguous() for t in lf), *scal)
            for lf in zip(*trees)]
    torch.cuda.synchronize()
    for o, outs in enumerate(got):
        for i, a in enumerate(outs):
            assert torch.equal(a, again[o][i]), (name, "two runs differ", o,
                                                 i)
            assert torch.equal(a, leaf[i][o]), (
                name, "tree kernel differs from the per-leaf kernel", o, i,
                float((a.float() - leaf[i][o].float()).abs().max()))
    return got


def b1_tree_row(name, params, grads, state, hp, step, n_bytes, library,
                plain=True, reps=30, warm=5, keep=False):
    """The whole tree's update by ``fused_apply_update`` (one launch of the
    tree kernel) twice and by ``leafwise_apply_update`` (the per-leaf
    Triton kernel) twice, all four bit-equal (compared two at a time: the
    64-layer mamba2 tree's outputs are 16 GB); timed by CUDA events and by
    the profiler beside the per-leaf kernel, the plain version (``plain``),
    ``library`` (a yardstick the package never calls) and the bound
    (``n_bytes`` / 3.35 TB/s).  Returns (the row, the tree kernel's
    outputs if ``keep``)."""
    from repro_torch.kernels.optim import (fused_apply_update,
                                           leafwise_apply_update,
                                           stacked_leaf_update,
                                           stacked_tree_update)
    from repro_torch.train.optimizer import apply_update
    from repro_torch.utils.tree import tree_leaves
    args = (name, params, grads, state, hp, step)
    n_leaves = len(tree_leaves(params))
    t0, l0 = stacked_tree_update.launches, stacked_leaf_update.launches
    out = fused_apply_update(*args)
    for fn in (fused_apply_update, leafwise_apply_update,
               leafwise_apply_update):
        other = fn(*args)
        torch.cuda.synchronize()
        for a, b in zip(tree_leaves(out), tree_leaves(other)):
            assert torch.equal(a, b), (name, "tree kernel differs from the "
                                       "per-leaf kernel or from itself")
        del other
    assert stacked_tree_update.launches - t0 == 2, "one launch a step"
    assert stacked_leaf_update.launches - l0 == 2 * n_leaves
    if not keep:
        out = None
    kern = lambda: fused_apply_update(*args)
    ms = time_ms(kern, reps=reps, warm=warm)
    bound = n_bytes / HBM_BYTES_PER_S * 1e3
    row = {"ms": ms, "device_ms": device_ms(kern, reps=max(reps // 3, 3),
                                            expect="tree_update_kernel"),
           "wrapper_host_us": launch_us(kern, reps=max(reps, 20)),
           "per_leaf_triton_ms": time_ms(lambda: leafwise_apply_update(
               *args), reps=reps, warm=warm),
           "plain_ms": time_ms(lambda: apply_update(*args), reps=reps,
                               warm=warm) if plain else None,
           "library_ms": time_ms(library, reps=reps, warm=warm),
           "bound_ms": bound, "bound_by": "bytes", "bytes": n_bytes,
           "launches_per_call": 1, "leaves": n_leaves,
           "bit_equal_to_per_leaf_kernel_twice": True}
    dev = row["device_ms"]
    row["bound_share_of_device_ms"] = (bound / dev if isinstance(dev, float)
                                       else "not measured")
    row["bound_share_of_ms"] = bound / ms
    return row, out


def b1_phase(join_build):
    """B1: the per-leaf Triton kernel (the first port's) against the plain
    version over the optimizer × members × dtype × shape grid, then the
    tree kernel (CUDA, ``csrc/optim.cu``) bit-equal to it over the same
    grid as trees, strided, of mixed dtypes, and on the ResNet56 tree at
    its shapes and strides; returns B1's row for the ResNet56 tree."""
    import torch_hpo_resnet as example
    from repro_torch.kernels import optim as ko
    from repro_torch.kernels.optim import _SPEC, stacked_leaf_update
    from repro_torch.models.resnet import ResNet
    from repro_torch.train.optimizer import (OPTIMIZERS, apply_update,
                                             leaf_update)
    from repro_torch.train.torch_trainer import value_and_grad
    from repro_torch.utils.tree import tree_leaves, tree_map

    def plain(name, arrs, scal, snames):
        bshape = (arrs[0].shape[0],) + (1,) * (arrs[0].dim() - 1)
        return leaf_update(name, *arrs, **{k: s.reshape(bshape)
                                           for k, s in zip(snames, scal)})

    t0 = time.perf_counter()
    for name in OPTIMIZERS:                         # build: JIT at 1st launch
        trees, scal = b1_operands(name, 1, [(64,)], [torch.float32], 0)
        stacked_leaf_update(name, *(t[0] for t in trees), *scal)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    tree_build_s = join_build("optim")
    ko._lib()                                   # load, check its constants

    variants = []
    worst_f32 = 0.0
    for name in OPTIMIZERS:
        err_f32, ulp_bf16, cases, tree_cases = 0.0, 0.0, 0, 0
        snames = _SPEC[name][1]
        for M in (1, 4):
            for dtype in (torch.float32, torch.bfloat16):
                for strided in (False, True):
                    # the grid's shapes as one tree: tree kernel twice and
                    # per-leaf kernel, bit for bit
                    trees, scal = b1_operands(name, M, SHAPES,
                                              [dtype] * len(SHAPES),
                                              100 * M + 2 * strided + (
                                                  dtype == torch.bfloat16),
                                              strided)
                    b1_tree_vs_leaf(name, trees, scal)
                    tree_cases += 1
                for si, shape in enumerate(SHAPES):
                    trees, scal = b1_operands(name, M, [shape], [dtype],
                                              100 * M + si)
                    arrs = [t[0] for t in trees]
                    b1_tree_vs_leaf(name, trees, scal)  # a one-leaf tree
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
        # f32 and bf16 leaves in one tree, 4 members
        trees, scal = b1_operands(name, 4, SHAPES, [
            torch.float32, torch.bfloat16, torch.bfloat16, torch.float32], 7,
            strided=True)
        b1_tree_vs_leaf(name, trees, scal)
        tree_cases += 1
        # time one launch at the widest ResNet56 leaf, 1 and 4 members
        timing = {}
        for M in (1, 4):
            trees, scal = b1_operands(name, M, [SHAPES[0]], [torch.float32],
                                      7)
            arrs = [t[0] for t in trees]
            n_in, n_out = _SPEC[name][0], _SPEC[name][2]
            nbytes = (n_in + n_out) * arrs[0].numel() * 4
            timing[f"M{M}"] = {
                "ms": time_ms(lambda: stacked_leaf_update(name, *arrs, *scal)),
                "tree_kernel_ms": time_ms(lambda: ko.stacked_tree_update(
                    name, *trees, *scal)),
                "plain_ms": time_ms(lambda: plain(name, arrs, scal, snames)),
                "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
        worst_f32 = max(worst_f32, err_f32)
        variants.append({"name": name, "cases": cases,
                         "tree_cases_bit_equal_to_per_leaf": tree_cases,
                         "max_abs_err_f32": err_f32,
                         "max_err_bf16_in_ulps": ulp_bf16,
                         "bit_equal_twice": True,
                         "leaf_3x3x64x64": timing})

    # the whole-tree update at the main path's shapes and strides:
    # ResNet56, momentum, gradients as the loss's backward hands them over
    # (convolution weights' come as non-contiguous HWIO views: the tree
    # kernel reads them through their strides, the per-leaf design copied)
    backend = example.make_backend(use_kernel=True, **RESNET_FULL)
    params = ResNet(n=9, width=16).init(0, device=DEV)
    batch0 = {k: v[0] for k, v in backend._upload(
        backend.pipeline_factory().next_batches(1)).items()}
    _, grads = value_and_grad(backend.task.loss, params, batch0)
    n_strided = sum(not g.is_contiguous() for g in tree_leaves(grads))
    assert n_strided > 0, "expected strided weight gradients on this path"
    gen = torch.Generator(device="cuda").manual_seed(1)
    state = tree_map(lambda p: 0.01 * torch.rand(p.shape, device=DEV,
                                                 generator=gen),
                     {"m": params})
    n_leaves = len(tree_leaves(params))
    n_params = sum(p.numel() for p in tree_leaves(params))
    assert n_leaves == RESNET_LEAVES, n_leaves
    hp = {"lr": torch.tensor(0.05, device=DEV)}
    step = torch.tensor(3, dtype=torch.int32, device=DEV)
    ps, gs, ms = (tree_leaves(params), tree_leaves(grads),
                  tree_leaves(state["m"]))

    def library():       # yardstick only — the package never calls this
        m2 = torch._foreach_mul(ms, 0.9)
        torch._foreach_add_(m2, gs)
        return torch._foreach_add(ps, m2, alpha=-0.05), m2

    tree_bytes = 5 * n_params * 4          # read p, g, m; write p, m (f32)
    timing, (new_k, st_k) = b1_tree_row("momentum", params, grads, state, hp,
                                        step, tree_bytes, library, keep=True)
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
    row = {
        "name": "stacked_tree_update", "route": "cuda", "source": B1_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": None,
        "max_abs_err": max(worst_f32, tree_err), **timing,
        "library": "torch._foreach_mul / _foreach_add_ / _foreach_add",
        "shape": f"ResNet56 tree, momentum: {n_leaves} leaves, "
                 f"{n_params} f32 parameters, one launch; {n_strided} "
                 f"gradient leaves strided, read through their strides",
        # the tree kernel's performance targets (PERF.md §6), printed and
        # not asserted: a time is no check of correctness
        "targets_met": {
            "ms_le_0.85": timing["ms"] <= 0.85,
            "ms_le_library_ms": timing["ms"] <= timing["library_ms"]},
        "per_leaf_kernel": {"source": KERNEL_SOURCE, "route": "triton",
                            "build_seconds": build_s,
                            "launches_per_call": n_leaves},
        "build_seconds": tree_build_s, "variants": variants}
    emit({"phase": "kernels", "build_seconds": build_s,
          "tree_kernel_build_seconds": tree_build_s,
          "variants_ok": [v["name"] for v in variants],
          "tree_kernel_bit_equal_to_per_leaf": True,
          "max_abs_err_f32": row["max_abs_err"],
          "tree_update": {k: row[k] for k in (
              "ms", "device_ms", "wrapper_host_us", "per_leaf_triton_ms",
              "plain_ms", "library_ms", "bound_ms",
              "bound_share_of_device_ms", "targets_met")}})
    return row


# -------------------------------------------- 3. small input, agreement on card
def small_phase():
    import torch_hpo_resnet as example
    from repro_torch.core import Constant, HpConfig, MultiStep
    from repro_torch.core.searchplan import SearchPlan
    from repro_torch.core.trainer import StageContext
    from repro_torch.core.trial import Trial
    from repro_torch.utils.tree import tree_leaves

    small = dict(n=1, width=8, n_train=256, n_eval=128, batch=32)
    t_kernel = example.make_backend(use_kernel=True, **small)
    t_plain = example.make_backend(use_kernel=False, **small)
    assert t_kernel.device.type == "cuda" and t_kernel.use_kernel
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    trial = Trial(HpConfig({"lr": MultiStep(0.05, [4], values=[0.05, 0.01]),
                            "bs": Constant(32)}), 6)
    plan = SearchPlan("solo-" + trial.trial_id)
    node, _, _ = plan.submit(trial, 6)
    path = plan.path_to_root(node.node_id)
    ctxs = [StageContext(n.node_id, n.desc, n.start, n.start,
                         6 if i == len(path) - 1 else path[i + 1].start,
                         plan.path_key(n.node_id))
            for i, n in enumerate(path)]
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


# ------------------------------------------------- 4-5. ResNet56 main path
def resnet_study_phase():
    """Both modes of the ResNet56 study; returns the tree kernel's
    launches in them."""
    import torch_hpo_resnet as example
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.optim import (stacked_leaf_update,
                                           stacked_tree_update)

    kops.reset_kernel_stats()
    stacked_tree_update.launches = 0            # counts to 0 just before
    stacked_leaf_update.launches = 0
    runs = {}
    for share in (True, False):
        backend = example.make_backend(use_kernel=True, **RESNET_FULL)
        stats, tuner, store, wall = example.run_study(
            backend, share, batch=RESNET_FULL["batch"], name="resnet56")
        torch.cuda.synchronize()
        runs[share] = (stats, tuner, store, wall)
    launches = stacked_tree_update.launches     # ... and read just after
    leaf_launches = stacked_leaf_update.launches
    calls, fallbacks = kops.KERNEL_STATS.snapshot()

    total_steps = 0
    for share, (stats, tuner, store, wall) in runs.items():
        assert tuner.is_done() and tuner.best is not None
        assert stats.kernel_calls > 0 and stats.kernel_fallbacks == 0
        assert stats.kernel_calls == stats.steps_run, (
            stats.kernel_calls, stats.steps_run)
        assert stats.chain_fused_stages > 0
        assert stats.ckpt_async_writes == stats.ckpt_saves > 0
        assert store.pending_writes == 0
        n_ckpts = held_checkpoints(store, RESNET_LEAVES)
        total_steps += stats.steps_run
        emit({"phase": "study", "mode": "stage" if share else "trial",
              "model": "ResNet(n=9, width=16)", "batch": RESNET_FULL["batch"],
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
    # one launch of the tree kernel per step, the per-leaf kernel never
    assert launches == total_steps and leaf_launches == 0, (
        launches, leaf_launches, total_steps)
    (s_stats, s_tuner), (t_stats, t_tuner) = runs[True][:2], runs[False][:2]
    assert s_stats.steps_run < t_stats.steps_run
    assert set(s_tuner.history) == set(t_tuner.history)
    worst = max(abs(m["loss"] - t_tuner.history[k]["loss"])
                for k, m in s_tuner.history.items())
    assert worst <= 1e-4, worst
    same_best = s_tuner.best.trial_id == t_tuner.best.trial_id
    assert same_best, (s_tuner.best.trial_id, t_tuner.best.trial_id)
    assert abs(s_tuner.best_score - t_tuner.best_score) <= 1e-4
    emit({"phase": "main_path", "ok": True, "launches": launches,
          "kernel_calls": calls, "kernel_fallbacks": fallbacks,
          "steps_run": {"stage": s_stats.steps_run,
                        "trial": t_stats.steps_run},
          "launches_per_step": 1, "per_leaf_kernel_launches": leaf_launches,
          "same_best_trial": same_best,
          "best_trial": s_tuner.best.trial_id,
          "best_scores_bit_equal":
              s_tuner.best_score == t_tuner.best_score,
          "all_reported_losses_bit_equal": worst == 0.0,
          "all_reported_metrics_bit_equal":
              s_tuner.history == t_tuner.history,
          "max_reported_loss_difference": worst})
    return launches


def step_profile(prefix, model, backend, opt, lr, n_chunk, profile_steps,
                 tokens=None, port=None):
    """Where one training step's time goes — a chunk of ``n_chunk`` steps
    and the loss's forward + backward alone (host clock, synchronised at
    both ends, mean of two runs), the update alone on CUDA events against
    its bound, ``port`` = (label, ms per step, kernel-name match) for the
    package's own kernels, the peak device memory — then the device's busy
    and idle share over one ``profile_steps``-step chunk.  Prints phases
    ``<prefix>step`` and ``<prefix>profile``."""
    from repro_torch.kernels.optim import fused_apply_update
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.torch_trainer import value_and_grad
    from repro_torch.utils.tree import tree_leaves

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params0 = backend.init_state()["params"]
    draw_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params0))
    param_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(params0))
    # the carry advances chunk by chunk, so that no step keeps an older
    # training state alive beside the current one
    carry = [(params0, init_opt_state(opt, params0))]
    n_slots = len(carry[0][1])
    del params0
    slab = backend._upload(backend.pipeline_factory().next_batches(n_chunk))
    steps = torch.arange(n_chunk, dtype=torch.int32, device=DEV)
    lrs = torch.full((n_chunk,), lr, device=DEV)

    def chunk(n):
        carry[0] = backend._run_chunk(
            opt, carry[0], {}, {"lr": lrs[:n]},
            {k: v[:n] for k, v in slab.items()}, steps[:n])

    step_ms = host_ms(lambda: chunk(n_chunk), 2) / n_chunk
    batch0 = {k: v[0] for k, v in slab.items()}
    grad_ms = host_ms(lambda: value_and_grad(
        backend.task.loss, carry[0][0], batch0), 2)
    _, grads = value_and_grad(backend.task.loss, carry[0][0], batch0)
    upd_ms = time_ms(lambda: fused_apply_update(
        opt, carry[0][0], grads, carry[0][1], {"lr": lrs[0]}, steps[-1]),
        reps=5, warm=1)
    del grads
    # read p, g and each state slot; write p and each slot: leaf dtypes
    upd_bytes = (2 * n_slots + 3) * param_bytes
    peak = torch.cuda.max_memory_allocated()
    row = {"phase": prefix + "step", "model": model, "parameters": n_params,
           "init_draw_seconds": draw_s, "step_ms": step_ms,
           "steps_per_second": 1e3 / step_ms}
    if tokens is not None:
        row["tokens_per_second"] = tokens * 1e3 / step_ms
    row["loss_fwd_bwd_ms"] = grad_ms
    if port is not None:
        label, port_ms, _ = port
        row.update({f"{label}_ms": port_ms,
                    f"{label}_share_of_step": port_ms / step_ms})
    row.update(optimizer_update_ms=upd_ms,
               optimizer_update_share_of_step=upd_ms / step_ms,
               optimizer_update_bound_ms=upd_bytes / HBM_BYTES_PER_S * 1e3,
               peak_device_memory_bytes=peak,
               peak_device_memory_gib=peak / 2 ** 30,
               clock="step and forward + backward: host, synchronised at "
                     "both ends; the update alone: CUDA events"
                     + ("" if port is None else
                        f"; {label}: the layers x the kernels' CUDA-event "
                        f"times at the main path's shape"))
    emit(row)
    emit({"phase": prefix + "profile",
          **device_profile(lambda: chunk(profile_steps), profile_steps,
                           step_ms * profile_steps,
                           match=None if port is None else port[2])})


def resnet_step_phase():
    import torch_hpo_resnet as example
    backend = example.make_backend(use_kernel=True, **RESNET_FULL)
    step_profile("", "ResNet(n=9, width=16)", backend, "momentum", 0.05,
                 n_chunk=8, profile_steps=8)


# ------------------------------- 6. attention kernels vs plain version
def b2_case(fa, q, k, v, lse_rule, label):
    """B2 in bf16 at a main path's shape (causal): two launches bit-equal,
    executed tiles equal to ``fa_tile_counts``, ``out`` by
    ``p_rounding_rule`` and ``lse`` by ``lse_rule`` against the plain
    version on the same inputs; timed by CUDA events and by the profiler
    beside SDPA (a yardstick the package never calls), with its bound.
    Returns (out, lse, row)."""
    import torch.nn.functional as F
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    runs = [fa.flash_attention_fwd(q, k, v, return_lse=True,
                                   count_tiles=True) for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(runs[0][:2], runs[1][:2])), (
        "two launches differ", label)
    want = B * Hq * fa.fa_tile_counts(S, S, *fa.fwd_blocks(torch.bfloat16),
                                      True, 0)[0]
    assert int(runs[0][2]) == int(runs[1][2]) == want, (
        "executed tiles", label, int(runs[0][2]), want)
    out, lse = runs[0][:2]
    del runs
    qf, kf, vf = q.float(), k.float(), v.float()
    out_row, ok = p_rounding_rule(out, fa.fwd_plain(qf, kf, vf)[0],
                                  fa.fwd_plain(qf, kf, vf.abs())[0])
    assert ok, ("B2 disagrees with its plain version", label, out_row)
    del qf, kf, vf
    lse_row, ok = at_scale(lse, fa.fwd_plain(q, k, v)[1], lse_rule)
    assert ok, ("B2 lse disagrees with its plain version", label, lse_row)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    kern = lambda: fa.flash_attention_fwd(q, k, v, return_lse=True)
    lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                 enable_gqa=True)
    lib_err = float((lib().transpose(1, 2).float() - out.float()).abs().max()
                    ) / float(out.float().abs().max())
    assert lib_err <= 2e-2, ("yardstick differs", label, lib_err)
    ms, lib_ms = time_ms(kern, reps=20, warm=3), time_ms(lib, reps=20, warm=3)
    flops = 4.0 * B * Hq * S * S * hd * 0.5                 # causal
    # each input read once, each output written once
    nbytes = 2 * 2 * B * S * (Hq + Hkv) * hd + 4 * B * Hq * S
    t_ops, t_bytes = flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    return out, lse, {
        "shape": label, "ms": ms,
        "plain_ms": time_ms(lambda: fa.fwd_plain(q, k, v), reps=5, warm=1),
        "library_ms": lib_ms, "ms_over_library_ms": ms / lib_ms,
        "device_ms": device_ms(kern), "library_device_ms": device_ms(lib),
        "wrapper_host_us": launch_us(kern), "library_host_us": launch_us(lib),
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "flops": flops, "bytes": nbytes, "tiles": want,
        "vs_plain": {"out": out_row, "lse": lse_row},
        "library_vs_kernel_err_over_scale": lib_err}


def bwd_case(fa, q, k, v, do, out, lse, label):
    """B3 and B4 in bf16 at a main path's shape (causal), fed B2's ``lse``:
    two launches of each bit-equal, every one on the tensor-core kernels;
    dq, dk_h, dv_h by ``ds_rounding_rule`` against the plain versions and
    within 2e-2 of the largest value of the library's flash backward (a
    yardstick the package never calls); each kernel timed by CUDA events
    and by the profiler beside its plain version and its bound, the pair
    beside the library's backward and the backward's bound as a whole.
    Returns ({"B3": row, "B4": row}, the pair's row)."""
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    kern = {"B3": lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta),
            "B4": lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse,
                                                     delta)}
    plain = {"B3": lambda: fa.bwd_dq_plain(q, k, v, do, lse, delta),
             "B4": lambda: fa.bwd_dkv_plain(q, k, v, do, lse, delta)}
    wrappers = (fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
    tc0 = [w.launches_tc for w in wrappers]
    got = (kern["B3"](),) + kern["B4"]()
    again = (kern["B3"](),) + kern["B4"]()
    torch.cuda.synchronize()
    assert [w.launches_tc - t for w, t in zip(wrappers, tc0)] == [2, 2], label
    for a, b in zip(got, again):
        assert torch.equal(a, b), ("two launches differ", label)
    del again
    vs_plain, ok = ds_rounding_rule(fa, q, k, v, do, lse, delta, got,
                                    dict(causal=True, window=0))
    assert ok, ("B3 / B4 disagree with their plain versions", label,
                vs_plain)

    # yardstick only — the package never calls it: the library's flash
    # backward alone, on its own forward's residuals, over K / V repeated
    # onto the query heads: one call that computes what B3 and B4 compute
    # together (dq and the per-query-head dk_h, dv_h; bf16 P and dS)
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    ke, ve = (x.repeat_interleave(Hq // Hkv, dim=1) for x in (kt, vt))
    res = torch.ops.aten._scaled_dot_product_flash_attention(
        qt, ke, ve, 0.0, True, False)

    def sdpa_bwd():
        return torch.ops.aten._scaled_dot_product_flash_attention_backward(
            dot, qt, ke, ve, res[0], res[1], res[2], res[3], res[4], res[5],
            0.0, True, res[6], res[7])

    lib_err = {}
    for name, a, b in zip(("dq", "dk_h", "dv_h"), sdpa_bwd(), got):
        a = a.transpose(1, 2)
        assert a.shape == b.shape, (name, a.shape, b.shape)
        lib_err[name] = float((a.float() - b.float()).abs().max()) / float(
            b.float().abs().max())
        assert lib_err[name] <= 2e-2, ("yardstick differs", name, lib_err)
    del got

    e_bf16, e_f32 = 2, 4
    n_q, n_kv, n_row = B * S * Hq * hd, B * S * Hkv * hd, B * Hq * S
    fwd_flops = 4.0 * B * Hq * S * S * hd * 0.5                 # causal
    # (flops, bytes) of each backward kernel's function: each input read
    # once, each output written once.  Alone, B3 must recompute s and dp
    # and form ds·K (three products of the forward's two: 1.5x); B4 must
    # recompute them and form dsᵀ·Q and pᵀ·dO (2x).
    work = {"B3": (1.5 * fwd_flops,
                   e_bf16 * (3 * n_q + 2 * n_kv) + e_f32 * 2 * n_row),
            "B4": (2.0 * fwd_flops,
                   e_bf16 * (4 * n_q + 2 * n_kv) + e_f32 * 2 * n_row)}
    rows = {}
    for key, (flops, nbytes) in work.items():
        t_ops, t_bytes = flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
        rows[key] = {
            "ms": time_ms(kern[key], reps=20, warm=3),
            "device_ms": device_ms(kern[key]),
            "wrapper_host_us": launch_us(kern[key]),
            "plain_ms": time_ms(plain[key], reps=5, warm=1),
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}
    # the backward as a whole (the repo's numerator,
    # benchmarks/bench_kernels.py:68-74): five products, s and dp formed
    # once, 2.5x the forward's flops and bytes
    bwd_flops = 2.5 * fwd_flops
    bwd_bytes = 2.5 * e_bf16 * (2 * n_q + 2 * n_kv)
    t_ops, t_bytes = bwd_flops / BF16_FLOP_PER_S, bwd_bytes / HBM_BYTES_PER_S
    pair_ms = rows["B3"]["ms"] + rows["B4"]["ms"]
    lib_ms = time_ms(sdpa_bwd, reps=20, warm=3)
    dev = [rows[key]["device_ms"] for key in ("B3", "B4")]
    pair = {"shape": label, "ms": pair_ms,
            "device_ms": sum(dev) if all(isinstance(x, float) for x in dev)
            else "not measured",
            "library_ms": lib_ms, "library_device_ms": device_ms(sdpa_bwd),
            "ms_over_library_ms": pair_ms / lib_ms,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": bwd_flops, "bytes": bwd_bytes,
            "per_kernel_bound_ms": rows["B3"]["bound_ms"]
            + rows["B4"]["bound_ms"],
            "library": "aten._scaled_dot_product_flash_attention_backward"
                       " over K / V repeated onto the query heads",
            "vs_plain": vs_plain, "library_vs_kernel_err_over_scale": lib_err}
    return rows, pair


def attention_phase(join_build):
    """B2–B4 on the grid and at qwen2-0.5b's and qwen3-8b's shapes;
    returns their rows."""
    from repro_torch.kernels import flash_attention as fa
    build_s = join_build("flash_attention")
    fa._lib()                                   # load, check tile sizes
    gen = torch.Generator().manual_seed(12)
    lse_rule = ("atol 2e-5 + rtol 2e-5",
                lambda diff, b, scale: bool((diff <= 2e-5 + 2e-5
                                             * b.abs()).all()))

    def fa_inputs(B, S, Hq, Hkv, hd, dtype):
        return [torch.randn(shape, generator=gen).to(DEV, dtype)
                for shape in ((B, S, Hq, hd), (B, S, Hkv, hd),
                              (B, S, Hkv, hd), (B, S, Hq, hd))]

    fa_err = {k: {"float32": 0.0, "bfloat16": 0.0}
              for k in ("B2", "B3", "B4")}
    fa_cases = 0
    grid_b2_bf16 = {"max_err_over_allowed": 0.0, "lse_max_abs_err": 0.0}
    grid_bwd_bf16 = {"dq": 0.0, "dk_h": 0.0, "dv_h": 0.0}
    wrappers = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
                fa.flash_attention_bwd_dkv)
    n0 = [(w.launches, w.launches_tc) for w in wrappers]
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        f32 = dtype == torch.float32
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
                want = B * Hq * fa.fa_tile_counts(S, S, *fa.fwd_blocks(dtype),
                                                  causal, window)[0]
                assert int(tiles) == int(runs[1][2]) == p_tiles == want, (
                    "executed tiles", case, int(tiles), want)
                assert float(dqs[0].float().abs().max()) > 0
                if f32:       # B2 in f32: the CUDA-core kernel, f32 p
                    b2_pairs = (("B2", ((out, p_out), (lse, p_lse)),
                                 (2e-5, 2e-5)),)
                else:         # B2 in bf16: the tensor-core kernel, bf16 p
                    qf, kf, vf = q.float(), k.float(), v.float()
                    row, ok = p_rounding_rule(
                        out, fa.fwd_plain(qf, kf, vf, **mk)[0],
                        fa.fwd_plain(qf, kf, vf.abs(), **mk)[0])
                    assert ok, ("B2 disagrees with its plain version", case,
                                row)
                    lse_err, ok = within(lse, p_lse, 2e-5, 2e-5)
                    assert ok, ("B2 lse disagrees", case, lse_err)
                    fa_err["B2"][dname] = max(fa_err["B2"][dname],
                                              row["max_abs_err"])
                    for x, y in (("max_err_over_allowed",
                                  row["max_err_over_allowed"]),
                                 ("lse_max_abs_err", lse_err)):
                        grid_b2_bf16[x] = max(grid_b2_bf16[x], y)
                    b2_pairs = ()
                    # B3 / B4 in bf16: the tensor-core kernels, bf16 p, dS
                    rows, ok = ds_rounding_rule(fa, q, k, v, do, lse, delta,
                                                (dqs[0],) + dkvs[0], mk)
                    assert ok, ("B3 / B4 disagree with their plain "
                                "versions", case, rows)
                    for name, row in rows.items():
                        grid_bwd_bf16[name] = max(
                            grid_bwd_bf16[name], row["max_err_over_allowed"])
                for key, pairs, (atol, rtol) in b2_pairs + (
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
    n_grid = len(FA_SHAPES) * len(FA_MASKS)
    # each case launches B2, B3 and B4 twice each: f32 on the CUDA-core
    # kernels, bf16 on the tensor-core ones
    for w, (all0, tc0) in zip(wrappers, n0):
        assert w.launches - all0 == 4 * n_grid, w.__name__
        assert w.launches_tc - tc0 == 2 * n_grid, w.__name__

    # the main path's own shapes, bf16, causal: qwen2-0.5b's training
    # attention (GQA 7), then qwen3-8b's at hd 128; B3 / B4 fed B2's lse
    B, S, Hq, Hkv, hd = (QWEN[x] for x in ("B", "S", "Hq", "Hkv", "hd"))
    shape_s = f"B {B}, S {S}, Hq {Hq}, Hkv {Hkv}, hd {hd}, causal, bf16"
    q, k, v, do = fa_inputs(B, S, Hq, Hkv, hd, torch.bfloat16)
    out, lse, b2_main = b2_case(fa, q, k, v, lse_rule, shape_s)
    bwd_rows, pair = bwd_case(fa, q, k, v, do, out, lse, shape_s)
    main_err = {"B2": b2_main["vs_plain"],
                "B3": {"dq": pair["vs_plain"]["dq"]},
                "B4": {x: pair["vs_plain"][x] for x in ("dk_h", "dv_h")}}
    del q, k, v, do, out, lse
    free()
    shape3 = ("B {B}, S {S}, Hq {Hq}, Hkv {Hkv}, hd {hd}, causal, bf16 "
              "(qwen3-8b)".format(**QWEN3))
    q3 = fa_inputs(*(QWEN3[x] for x in ("B", "S", "Hq", "Hkv", "hd")),
                   torch.bfloat16)
    out3, lse3, hd128 = b2_case(fa, *q3[:3], lse_rule, shape3)
    bwd3_rows, pair3 = bwd_case(fa, *q3, out3, lse3, shape3)
    del q3, out3, lse3

    def kernel_row(key, name):
        return {"name": name, "route": "cuda", "source": FA_SOURCE,
                "replaces": FA_REPLACES[key], "launches": None,
                "max_abs_err": max(list(fa_err[key].values())
                                   + [r["max_abs_err"]
                                      for r in main_err[key].values()]),
                "shape": shape_s, "max_abs_err_by_dtype": fa_err[key],
                "cases": fa_cases, "main_shape_vs_plain": main_err[key]}

    rows = {"B2": dict(
        kernel_row("B2", fa.flash_attention_fwd.__name__),
        **{x: b2_main[x] for x in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "ms_over_library_ms", "device_ms", "library_device_ms",
            "wrapper_host_us", "library_host_us", "flops", "bytes")},
        library="F.scaled_dot_product_attention(enable_gqa=True)",
        route_bf16="wgmma (fa_fwd_tc)", route_f32="simt (fa_fwd)",
        grid_bf16=grid_b2_bf16, qwen3_8b_hd128=hd128)}
    for key, wrapper, route in (
            ("B3", fa.flash_attention_bwd_dq, "fa_bwd_dq"),
            ("B4", fa.flash_attention_bwd_dkv, "fa_bwd_dkv")):
        rows[key] = dict(
            kernel_row(key, wrapper.__name__), **bwd_rows[key],
            # no one library call computes dq alone or dk_h / dv_h alone:
            # the library's backward is held against B3 + B4 together in
            # the attention_kernels line
            library_ms=None, library=None,
            route_bf16=f"wgmma ({route}_tc)", route_f32=f"simt ({route})",
            grid_bf16_max_err_over_allowed={
                x: grid_bwd_bf16[x] for x in (
                    ("dq",) if key == "B3" else ("dk_h", "dv_h"))},
            qwen3_8b_hd128=dict(bwd3_rows[key], shape=shape3))
    emit({"phase": "attention_kernels",
          "build_seconds": build_s, "cases": fa_cases,
          "bit_equal_twice": True, "tiles_equal_fa_tile_counts": True,
          "bf16_on_tensor_cores": ["B2", "B3", "B4"],
          "max_abs_err": fa_err, "shape": shape_s,
          "grid_bf16_max_err_over_allowed": dict(
              grid_bwd_bf16, out=grid_b2_bf16["max_err_over_allowed"]),
          "main_shape_vs_plain": main_err,
          "library_vs_kernel_err_over_scale": dict(
              pair["library_vs_kernel_err_over_scale"],
              out=b2_main["library_vs_kernel_err_over_scale"]),
          "timing": {key: {x: r[x] for x in ("ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms")}
                     for key, r in rows.items()},
          "b2": dict({x: rows["B2"][x] for x in (
              "ms", "library_ms", "ms_over_library_ms", "device_ms",
              "library_device_ms", "wrapper_host_us", "library_host_us",
              "grid_bf16", "qwen3_8b_hd128")},
              cuda_core_ms_not_from_this_run={
                  "ms": B2_CUDA_CORE_MS,
                  "what": "the CUDA-core kernel's bf16 instantiation "
                          "at this shape, median of four runs (PERF.md); "
                          "not measured here, it is gone"}),
          "backward_b3_plus_b4": dict(
              {x: y for x, y in pair.items() if x != "vs_plain"},
              device_ms_by_kernel={key: bwd_rows[key]["device_ms"]
                                   for key in ("B3", "B4")},
              cuda_core_ms_not_from_this_run={
                  "B3": B3_CUDA_CORE_MS, "B4": B4_CUDA_CORE_MS,
                  "B3_plus_B4": B3_CUDA_CORE_MS + B4_CUDA_CORE_MS,
                  "what": "the CUDA-core kernels' bf16 instantiations at "
                          "this shape, medians of five runs (PERF.md); "
                          "not measured here, they are gone"}),
          "backward_b3_plus_b4_qwen3_8b_hd128": dict(
              {x: y for x, y in pair3.items() if x != "vs_plain"},
              vs_plain=pair3["vs_plain"],
              cuda_core_ms_not_from_this_run="none in the record")})
    return rows


def lm_small_phase(phase, arch, tokens, seed, attention):
    """A reduced LM (f32) on the card through the kernels' autograd
    bindings against its plain path: loss and every gradient leaf, at the
    CPU tests' tolerances against the JAX package.  With ``attention``, B2,
    B3 and B4 must have run, in f32 on the CUDA-core kernels only."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssk
    from repro_torch.models.transformer import LM
    from repro_torch.train.torch_trainer import value_and_grad
    from repro_torch.utils.tree import tree_leaves
    cfg = get_config(arch).reduced()
    params = LM(cfg).init(0, device=DEV)
    batch = {"tokens": torch.randint(
        0, cfg.vocab_size, tokens,
        generator=torch.Generator().manual_seed(seed)).to(DEV)}
    got = {}
    wrappers = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
                fa.flash_attention_bwd_dkv)
    n0 = [(w.launches, w.launches_tc) for w in wrappers]
    ssd0 = (ssk.ssd_intra_bwd.launches, ssk.ssd_intra_bwd.launches_tc)
    for use_kernel in (True, False):
        (loss, _), grads = value_and_grad(
            LM(cfg, use_kernel=use_kernel).loss, params, batch)
        got[use_kernel] = (loss, tree_leaves(grads))
    loss_err = abs(float(got[True][0]) - float(got[False][0]))
    grad_err = max(float((a - b).abs().max())
                   for a, b in zip(got[True][1], got[False][1]))
    assert all(bool(g.isfinite().all()) for g in got[True][1])
    assert loss_err <= 1e-5 and grad_err <= 1e-4, (loss_err, grad_err)
    f32_launches = {w.__name__: w.launches - all0
                    for w, (all0, _) in zip(wrappers, n0)}
    for w, (_, tc0) in zip(wrappers, n0):       # never the bf16 kernels
        assert w.launches_tc == tc0, w.__name__
    assert all((n > 0) == attention for n in f32_launches.values()), \
        f32_launches
    # the f32 SSD backward stays on the CUDA-core kernels
    ssd_bwd = ssk.ssd_intra_bwd.launches - ssd0[0]
    assert (ssd_bwd > 0) != attention, ssd_bwd
    assert ssk.ssd_intra_bwd.launches_tc == ssd0[1]
    emit({"phase": phase, "model": f"{arch} reduced",
          "attention_launches": f32_launches,
          "attention_tensor_core_launches": 0,
          "ssd_bwd_launches": ssd_bwd, "ssd_bwd_tensor_core_launches": 0,
          "layers": cfg.num_layers, "dtype": cfg.dtype,
          "tokens": list(tokens), "loss": float(got[True][0]),
          "kernel_vs_plain_loss_err": loss_err, "loss_atol": 1e-5,
          "kernel_vs_plain_grad_max_abs_err": grad_err, "grad_atol": 1e-4})


# --------------------------------------------------- an LM study, both modes
def lm_study(phase, make_backend, batch, seq_len, fwd, bwd, model_fields):
    """Both modes of the SHA study of ``examples/torch_hpo_lm.py`` on one
    trainer, made by ``make_backend()`` after the kernel-plane accounting is
    reset (a trainer counts its calls and fallbacks from its construction);
    its initial parameters are drawn once, first, outside the timed runs
    (the draw launches no kernel).  Every launch count is zeroed just
    before and read just after: each of the ``fwd`` kernels = layers ×
    (steps + evaluations), each of the ``bwd`` kernels = layers × steps
    (the bf16 attention and SSD backward ones all on the tensor cores), B1's
    tree kernel = steps, the per-leaf kernel and every other kernel 0; no
    fallback; fewer steps
    stage-based; the same best trial and every reported metric bit-equal.
    The first run's checkpoints are dropped before the second starts.
    Returns the launch counts and the trainer."""
    import torch_hpo_lm as lm_example
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ssd_scan as ssk
    from repro_torch.kernels.optim import (stacked_leaf_update,
                                           stacked_tree_update)
    from repro_torch.utils.tree import tree_leaves

    kops.reset_kernel_stats()
    backend = make_backend()
    cfg = backend.task.cfg
    assert backend.task.use_kernel and cfg.dtype == "bfloat16"
    t0 = time.perf_counter()
    params0 = backend.init_state()["params"]
    draw_s = time.perf_counter() - t0
    n_leaves = len(tree_leaves(params0))
    n_params = sum(p.numel() for p in tree_leaves(params0))
    assert n_params == cfg.param_count(), n_params
    del params0
    counters = (stacked_tree_update, stacked_leaf_update,
                fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
                fa.flash_attention_bwd_dkv, ssk.ssd_intra_fwd,
                ssk.ssd_intra_bwd)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tc_counters = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
                   fa.flash_attention_bwd_dkv, ssk.ssd_intra_bwd)
    for c in counters:                          # counts to 0 just before
        c.launches = 0
    for c in tc_counters:
        c.launches_tc = 0
    runs = {}
    for share in (True, False):
        evals0 = backend.evaluations
        calls0 = kops.KERNEL_STATS.calls
        stats, tuner, store, wall = lm_example.run_study(
            backend, share, batch=batch, name=cfg.name)
        torch.cuda.synchronize()
        assert tuner.is_done() and tuner.best is not None
        assert stats.kernel_fallbacks == 0 and stats.kernel_calls > 0
        assert stats.chain_fused_stages > 0
        assert stats.ckpt_async_writes == stats.ckpt_saves > 0
        assert store.pending_writes == 0
        runs[share] = dict(stats=stats, history=tuner.history,
                           best=tuner.best.trial_id,
                           best_score=tuner.best_score, wall=wall,
                           ckpts=held_checkpoints(store, n_leaves),
                           evals=backend.evaluations - evals0,
                           calls=kops.KERNEL_STATS.calls - calls0,
                           peak=torch.cuda.max_memory_allocated())
        lm_example.drop_checkpoints(store)  # this run's go before the next
        assert len(store) == 0
        del store, tuner
        free()
        torch.cuda.reset_peak_memory_stats()
    launches = {c.__name__: c.launches for c in counters}   # just after
    launches_tc = {c.__name__: c.launches_tc for c in tc_counters}
    calls, fallbacks = kops.KERNEL_STATS.snapshot()
    peak = max(r["peak"] for r in runs.values())

    L = cfg.num_layers
    steps = sum(r["stats"].steps_run for r in runs.values())
    evals = sum(r["evals"] for r in runs.values())
    expected = {name: 0 for name in launches}
    expected.update({name: L * (steps + evals) for name in fwd})
    expected.update({name: L * steps for name in bwd})
    expected["stacked_tree_update"] = steps     # the whole tree, one launch
    assert fallbacks == 0, kops.KERNEL_STATS.reasons
    assert launches == expected, (launches, expected, steps, evals)
    # a bf16 model's attention and SSD backward all went through the
    # tensor-core kernels
    assert launches_tc == {name: launches[name] for name in launches_tc}, (
        launches_tc, launches)
    assert calls == steps + L * (steps + evals), (calls, steps, evals)
    s_run, t_run = runs[True], runs[False]
    assert s_run["stats"].steps_run < t_run["stats"].steps_run
    assert s_run["history"] == t_run["history"], \
        "a reported metric differs across modes"
    assert all(m["loss"] == m["loss"]                          # no NaN
               for m in s_run["history"].values())
    assert s_run["best"] == t_run["best"]
    assert s_run["best_score"] == t_run["best_score"]
    text = {name: "0" for name in launches}
    text.update({name: f"{L} x (steps + evaluations)" for name in fwd})
    text.update({name: f"{L} x steps" for name in bwd})
    text["stacked_tree_update"] = "steps (one launch per step)"
    emit({"phase": phase, "model": cfg.name, "dtype": cfg.dtype,
          "layers": L, **model_fields, "parameters": n_params,
          "leaves": n_leaves, "init_draw_seconds": draw_s, "batch": batch,
          "seq_len": seq_len, "optimizer": "adamw",
          "modes": {("stage" if share else "trial"): {
              "steps_run": r["stats"].steps_run,
              "stages_run": r["stats"].stages_run,
              "evaluations": r["evals"],
              "chain_fused_stages": r["stats"].chain_fused_stages,
              "ckpt_saves": r["stats"].ckpt_saves,
              "checkpoints_held": r["ckpts"],
              "kernel_calls": r["calls"],
              "wall_seconds": r["wall"],
              "steps_per_second": r["stats"].steps_run / r["wall"],
              "peak_device_memory_gib": r["peak"] / 2 ** 30}
              for share, r in runs.items()},
          "launches": launches, "tensor_core_launches": launches_tc,
          "kernel_calls": calls,
          "kernel_fallbacks": fallbacks, "expected": text,
          "best_trial": s_run["best"], "same_best_trial": True,
          "best_val_acc": s_run["best_score"],
          "all_reported_metrics_bit_equal": True,
          "reported_results": len(s_run["history"]),
          "peak_device_memory_bytes": peak,
          "peak_device_memory_gib": peak / 2 ** 30})
    return launches, backend


# ------------------------------------------- 7-8. qwen2-0.5b: the LM's path
def lm_update_phase(backend, b1_resnet):
    """B1 on the whole qwen2-0.5b AdamW bf16 tree: the tree kernel against
    its plain version, bit-equal to the per-leaf kernel, beside a
    ``torch._fused_adamw_`` yardstick; returns B1's row."""
    from repro_torch.kernels.optim import fused_apply_update
    from repro_torch.train.optimizer import apply_update
    from repro_torch.train.torch_trainer import value_and_grad
    from repro_torch.utils.tree import tree_leaves, tree_map

    params0 = backend.init_state()["params"]
    n_leaves = len(tree_leaves(params0))
    n_params = sum(p.numel() for p in tree_leaves(params0))
    slab = backend._upload(backend.pipeline_factory().next_batches(1))
    batch0 = {k: v[0] for k, v in slab.items()}
    _, grads = value_and_grad(backend.task.loss, params0, batch0)
    n_strided = sum(not g.is_contiguous() for g in tree_leaves(grads))
    gen = torch.Generator(device="cuda").manual_seed(2)
    opt = {slot: tree_map(lambda p: (1e-3 * torch.rand(
        p.shape, device=DEV, generator=gen)).to(p.dtype), params0)
        for slot in ("m", "v")}
    hp = {"lr": torch.tensor(3e-4, device=DEV)}
    step = torch.tensor(3, dtype=torch.int32, device=DEV)
    new_k, st_k = fused_apply_update("adamw", params0, grads, opt, hp, step)
    new_p, st_p = apply_update("adamw", params0, grads, opt, hp, step)
    torch.cuda.synchronize()
    upd_ulps, upd_err = 0.0, 0.0
    for a, c in zip(tree_leaves((new_k, st_k)), tree_leaves((new_p, st_p))):
        assert a.dtype == c.dtype == torch.bfloat16
        upd_ulps = max(upd_ulps, float(bf16_ulps(a, c).max()))
        upd_err = max(upd_err, float((a.float() - c.float()).abs().max()))
    assert upd_ulps <= 1.0, upd_ulps
    del new_k, st_k, st_p
    lib_lists = [[t.clone() for t in tree_leaves(x)]
                 for x in (params0, grads, opt["m"], opt["v"])]
    lib_steps = [torch.tensor(4.0, device=DEV) for _ in lib_lists[0]]

    def fused_adamw():   # yardstick only — the package never calls this
        torch._fused_adamw_(*lib_lists, [], lib_steps, lr=3e-4, beta1=0.9,
                            beta2=0.999, weight_decay=0.0, eps=1e-8,
                            amsgrad=False, maximize=False)

    fused_adamw()
    torch.cuda.synchronize()
    lib_ulps = max(float(bf16_ulps(a, c).max())
                   for a, c in zip(lib_lists[0], tree_leaves(new_p)))
    assert lib_ulps <= 1.0, lib_ulps               # the same function
    del new_p
    tree_bytes = 7 * n_params * 2        # read p, g, m, v; write p, m, v
    timing, _ = b1_tree_row("adamw", params0, grads, opt, hp, step,
                            tree_bytes, fused_adamw, reps=10, warm=2)
    row = dict(b1_resnet)
    row.update(timing)
    row.update({
        "max_abs_err": max(upd_err, b1_resnet["max_abs_err"]),
        "library": "torch._fused_adamw_",
        "shape": f"qwen2-0.5b tree, adamw, bf16: {n_leaves} leaves "
                 f"(12 stacked (24, ...)), {n_params} parameters, one "
                 f"launch; {n_strided} gradient leaves strided",
        "max_err_bf16_in_ulps": upd_ulps,
        "targets_met": {"ms_le_per_leaf_ms_plus_5pct": timing["ms"]
                                <= 1.05 * timing["per_leaf_triton_ms"]},
        "resnet56_momentum_f32": {x: b1_resnet[x] for x in (
            "ms", "device_ms", "wrapper_host_us", "per_leaf_triton_ms",
            "plain_ms", "bound_ms", "bound_share_of_device_ms",
            "library_ms", "library", "max_abs_err", "shape",
            "targets_met")},
        "launches_resnet56_study": b1_resnet["launches"]})
    emit({"phase": "lm_update", "optimizer": "adamw", "dtype": "bfloat16",
          "leaves": n_leaves, "parameters": n_params,
          "strided_gradient_leaves": n_strided,
          "max_err_bf16_in_ulps": upd_ulps,
          "library_max_err_bf16_in_ulps": lib_ulps,
          **{x: row[x] for x in ("ms", "device_ms", "wrapper_host_us",
                                 "per_leaf_triton_ms", "plain_ms",
                                 "bound_ms", "library_ms",
                                 "targets_met")}})
    return row


def mamba2_update_phase(backend):
    """B1 on the full 64-layer mamba2-2.7b AdamW tree (bf16 leaves beside
    f32 ``A_log`` / ``dt_bias``, one launch): bit-equal to the per-leaf
    kernel, timed beside it, its bound and ``torch._fused_adamw_`` (one
    call per dtype: a yardstick the package never calls).  The gradients
    and moments are drawn on the card (the update's values do not move its
    time); the plain version is not run (its f32 temporaries of the
    1.7 G-element stacked leaf do not fit beside the tree).  Returns the
    row."""
    from repro_torch.kernels.optim import fused_apply_update
    from repro_torch.utils.tree import tree_leaves, tree_map
    params0 = backend.init_state()["params"]      # drawn once, cached
    ps = tree_leaves(params0)
    dtypes = sorted({str(p.dtype) for p in ps})
    n_params = sum(p.numel() for p in ps)
    param_bytes = sum(p.numel() * p.element_size() for p in ps)
    gen = torch.Generator(device="cuda").manual_seed(3)
    rand = lambda scale: tree_map(lambda p: (scale * torch.rand(
        p.shape, device=DEV, generator=gen)).to(p.dtype), params0)
    grads = rand(1e-2)
    opt = {"m": rand(1e-3), "v": rand(1e-3)}
    hp = {"lr": torch.tensor(3e-4, device=DEV)}
    step = torch.tensor(3, dtype=torch.int32, device=DEV)
    groups = {}      # the yardstick's copies, made at its first (warm-up)
    # call, after the tree's outputs are compared and freed

    def fused_adamw():   # yardstick only — the package never calls this
        if not groups:
            for p, g, m, v in zip(ps, tree_leaves(grads),
                                  tree_leaves(opt["m"]),
                                  tree_leaves(opt["v"])):
                lists = groups.setdefault(p.dtype, [[], [], [], [], []])
                for lst, t in zip(lists, (p.clone(), g, m.clone(),
                                          v.clone(), torch.tensor(
                                              4.0, device=DEV))):
                    lst.append(t)
        for lists in groups.values():
            torch._fused_adamw_(*lists[:4], [], lists[4], lr=3e-4,
                                beta1=0.9, beta2=0.999, weight_decay=0.0,
                                eps=1e-8, amsgrad=False, maximize=False)

    row, _ = b1_tree_row("adamw", params0, grads, opt, hp, step,
                         7 * param_bytes, fused_adamw, plain=False, reps=5,
                         warm=1)
    row.update(shape=f"mamba2-2.7b, 64 layers, adamw: {len(ps)} leaves, "
                     f"{n_params} parameters, dtypes {dtypes}, one launch",
               library="torch._fused_adamw_, one call per dtype",
               targets_met={
                   "bound_share_ge_0.85": row["bound_share_of_ms"] >= 0.85})
    emit({"phase": "mamba2_update", **row})
    return row


def qwen2_phase(fa_rows, b1_resnet):
    """The qwen2-0.5b study, B1 on its tree, its step and profile; returns
    B1's row and the study's launch counts."""
    import torch_hpo_lm as lm_example
    from repro_torch.configs import get_config
    cfg = get_config("qwen2-0.5b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.vocab_size) == (24, 896, 14, 2, 151936)
    launches, backend = lm_study(
        "lm_study", lambda: lm_example.make_backend(use_kernel=True,
                                                    **LM_FULL),
        LM_FULL["batch"], LM_FULL["seq_len"],
        fwd=("flash_attention_fwd",),
        bwd=("flash_attention_bwd_dq", "flash_attention_bwd_dkv"),
        model_fields={"d_model": cfg.d_model,
                      "heads": [cfg.num_heads, cfg.num_kv_heads],
                      "vocab": cfg.vocab_size})
    assert backend.task.cfg == cfg
    # 24 layers x (48 steps + 10 evaluations) forwards, 24 x 48 backwards,
    # all on the tensor cores (lm_study holds launches_tc to these)
    assert launches["flash_attention_fwd"] == 1392, launches
    assert launches["flash_attention_bwd_dq"] == 1152, launches
    assert launches["flash_attention_bwd_dkv"] == 1152, launches
    b1_row = lm_update_phase(backend, b1_resnet)
    b1_row["launches"] = launches["stacked_tree_update"]
    attn_ms = cfg.num_layers * sum(fa_rows[k]["ms"]
                                   for k in ("B2", "B3", "B4"))
    step_profile("lm_", cfg.name, backend, "adamw", 3e-4, n_chunk=4,
                 profile_steps=4,
                 tokens=LM_FULL["batch"] * LM_FULL["seq_len"],
                 port=("attention_kernels", attn_ms, "::fa_"))
    return b1_row, launches


# ------------------------------------------ 9. SSD kernels vs plain version
def ssd_work(B, nc, Q, H, P, N, e_x):
    """(flops, bytes) of B5 and B6 at one shape.  Flops: the products and
    the elementwise work each function needs, over the Q(Q+1)/2 pairs
    j <= i (above the diagonal everything is 0); cb = C·Bᵀ depends on no
    head, so it is formed once per cell.  B5 per cell: cb, 2TN; per head
    y = att·x, 2TP, and seg, exp, ·dt, ·cb, 4T.  B6 per cell: cb, 2TN, and
    dB = dcbᵀ·C, dC = dcb·B, 4TN; per head datt = g·xᵀ and dx = attᵀ·g,
    4TP, and seg, exp, att (2), dad, ddt (2), dseg, its row and column sums
    (2), the head sum of dcb (2), 12T.  Bytes at the tensors' dtypes, each
    input read once and each output written once."""
    T, cells = Q * (Q + 1) // 2, B * nc
    n_x, n_row, n_bc = cells * Q * H * P, cells * Q * H, cells * Q * N
    return {"B5": (cells * (2 * T * N + H * (2 * T * P + 4 * T)),
                   e_x * (2 * n_x + 2 * n_bc) + 4 * 2 * n_row),
            "B6": (cells * (6 * T * N + H * (4 * T * P + 12 * T)),
                   e_x * (3 * n_x + 4 * n_bc) + 4 * 4 * n_row)}


def ssd_phase(join_build):
    """B5 and B6 on the grid and at mamba2-2.7b's shape; returns their
    rows."""
    import torch.nn.functional as F
    from repro_torch.kernels import ssd_scan as ssk
    build_s = join_build("ssd_scan")
    ssk._lib()                                  # load, check the tile size
    names = ("y", "dx", "ddt", "dlt", "dB", "dC")

    def inputs(B, nc, Q, H, P, N, dtype, model_decay, seed):
        """x, dt, ltT, B, C and a cotangent g on the card.  The JAX tests'
        small decays (|lt| <= 0.1 |N(0,1)|), or the model's at init: dt =
        softplus(N(0,1)), A = -exp(A_log) = -linspace(1, 16, H), so that
        cum falls to about -1,000 within a chunk of 128 and exp(cum_i -
        cum_j) above the diagonal overflows."""
        gen = torch.Generator().manual_seed(seed)
        rnd = lambda *shape: torch.randn(shape, generator=gen)
        x, g = rnd(B, nc, Q, H, P), rnd(B, nc, Q, H, P)
        Bm, Cm = rnd(B, nc, Q, N), rnd(B, nc, Q, N)
        dt = F.softplus(rnd(B, nc, Q, H))
        lt = (dt * -torch.linspace(1.0, 16.0, H)).movedim(-1, -2) \
            if model_decay else -rnd(B, nc, H, Q).abs() * 0.1
        return (x.to(DEV, dtype), dt.to(DEV), lt.contiguous().to(DEV),
                Bm.to(DEV, dtype), Cm.to(DEV, dtype), g.to(DEV, dtype))

    def plain(x, dt, lt, Bm, Cm, g=None):
        """What the wrappers compute, through the plain versions: the same
        cumsum in torch, the same suffix sum for dltT."""
        cum = torch.cumsum(lt, -1).contiguous()
        if g is None:
            return ssk.fwd_plain(x, dt, cum, Bm, Cm)
        dx, ddt, dcum, dB, dC = ssk.bwd_plain(x, dt, cum, Bm, Cm, g)
        return dx, ddt, ssk.dlt_from_dcum(dcum, lt.dtype), dB, dC

    def run(x, dt, lt, Bm, Cm, g):
        """B5 + B6 twice (required bit-equal; B6 in bf16 on the tensor
        cores, counted in ``launches_tc``, in f32 on the CUDA cores), and
        the plain versions on the same inputs; every output finite, shaped
        and typed alike.  A bf16 B6 is also run on the CUDA-core kernels it
        replaces: returns its outputs too (None in f32)."""
        tc0 = ssk.ssd_intra_bwd.launches_tc
        runs = [(ssk.ssd_intra_fwd(x, dt, lt, Bm, Cm),)
                + ssk.ssd_intra_bwd(x, dt, lt, Bm, Cm, g) for _ in range(2)]
        bf16 = x.dtype == torch.bfloat16
        assert ssk.ssd_intra_bwd.launches_tc - tc0 == 2 * bf16, (
            "B6 took the wrong route", x.dtype)
        run.scratch_bytes = ssk.ssd_intra_bwd.scratch_bytes
        old = ssk.ssd_intra_bwd(x, dt, lt, Bm, Cm, g, route="simt") \
            if bf16 else None
        want = (plain(x, dt, lt, Bm, Cm),) + plain(x, dt, lt, Bm, Cm, g)
        torch.cuda.synchronize()
        for name, a, b, c in zip(names, runs[0], runs[1], want):
            assert torch.equal(a, b), ("two launches differ", name)
            assert a.shape == c.shape and a.dtype == c.dtype, name
            assert bool(a.isfinite().all()) and bool(c.isfinite().all()), (
                "not finite", name)
        return runs[0], want, old

    def vs_replaced(outs, old, tol):
        """The tensor-core B6 against the CUDA-core B6 it replaces: both
        are held to the plain version, so they agree within the same
        tolerance; returns the largest difference over the largest value."""
        worst = 0.0
        for name, a, b in zip(names[1:], outs[1:], old):
            e, ok = within(a, b, tol, tol)
            assert ok, ("tensor-core B6 disagrees with the CUDA-core B6",
                        name, e)
            worst = max(worst, e / float(b.float().abs().max()))
        return worst

    err = {n: {"float32": 0.0, "bfloat16": 0.0} for n in names}
    cases, grid_vs_replaced = 0, 0.0
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for shape in SSD_SHAPES + [SSD_RAGGED]:
            outs, want, old = run(*inputs(*shape, dtype, shape == SSD_RAGGED,
                                          seed=cases))
            if old is not None:
                grid_vs_replaced = max(grid_vs_replaced,
                                       vs_replaced(outs, old, 2e-2))
            for name, a, b in zip(names, outs, want):
                # the JAX tests' tolerances: forward f32 2e-5, bf16 2e-2;
                # gradients 2e-3, and 2e-2 for a gradient rounded to bf16
                if name == "y":
                    tol = 2e-5 if dtype == torch.float32 else 2e-2
                else:
                    tol = 2e-3 if a.dtype == torch.float32 else 2e-2
                e, ok = within(a, b, tol, tol)
                err[name][dname] = max(err[name][dname], e)
                assert ok, ("SSD kernel disagrees with its plain version",
                            name, dname, shape, e)
            cases += 1

    # the main path's shape: one mamba2-2.7b layer's SSD at 1 x 2048 tokens
    # (16 chunks x 80 heads).  bf16 with the model's decays, which the
    # study runs and which would overflow above the diagonal; bf16 and f32
    # with the JAX tests' small decays, under which the 64 x 64 tile below
    # the diagonal tile carries weight to its far corner (every element of
    # B6's cross-tile sums counts).  bf16 outputs within one bf16 ulp
    # beyond 2^-16 of the tensor's largest value; f32 outputs within 1e-5
    # of it
    Bs, nc, Q, H, P, N = (MAMBA[k] for k in ("B", "nc", "Q", "H", "P", "N"))
    shape_s = f"B {Bs}, nc {nc}, Q {Q}, H {H}, P {P}, N {N}"
    f32_rule = ("1e-5 x scale",
                lambda diff, b, scale: float(diff.max()) <= 1e-5 * scale)
    main, cum_min, far_decay = {}, {}, {}
    main_vs_replaced, scratch = {}, {}
    for case, dtype, model_decay, seed in (
            ("bf16, model decays", torch.bfloat16, True, 99),
            ("bf16, small decays", torch.bfloat16, False, 98),
            ("f32, small decays", torch.float32, False, 97)):
        x, dt, lt, Bm, Cm, g = inputs(Bs, nc, Q, H, P, N, dtype,
                                      model_decay, seed)
        cum = torch.cumsum(lt, -1)
        cum_min[case] = float(cum.min())
        # the decay from a chunk's first position to its last, per (cell,
        # head): its smallest and its median
        far = torch.exp(cum[..., -1] - cum[..., 0]).flatten()
        far_decay[case] = {"min": float(far.min()),
                           "median": float(far.median())}
        outs, want, old = run(x, dt, lt, Bm, Cm, g)
        for name, a, b in zip(names, outs, want):
            row, ok = at_scale(a, b, f32_rule)
            main.setdefault(name, {})[case] = row
            assert ok, ("SSD kernel disagrees with its plain version at the "
                        "main path's shape", case, name, row)
        if old is not None:
            main_vs_replaced[case] = vs_replaced(outs, old, 2e-2)
            scratch[case] = run.scratch_bytes
        del outs, want, old
    assert cum_min["bf16, model decays"] < -500.0, cum_min  # overflow in reach
    assert far_decay["f32, small decays"]["median"] > 2 ** -16, far_decay

    # timed on the study's own inputs: bf16, the model's decays
    x, dt, lt, Bm, Cm, g = inputs(Bs, nc, Q, H, P, N, torch.bfloat16, True,
                                  99)
    repo_fwd_flops = Bs * nc * H * (2 * Q * Q * (N + P) + 6 * Q * Q)
    work = ssd_work(Bs, nc, Q, H, P, N, x.element_size())
    fns = {
        "B5": (ssk.ssd_intra_fwd,
               lambda: ssk.ssd_intra_fwd(x, dt, lt, Bm, Cm),
               lambda: plain(x, dt, lt, Bm, Cm), repo_fwd_flops),
        "B6": (ssk.ssd_intra_bwd,
               lambda: ssk.ssd_intra_bwd(x, dt, lt, Bm, Cm, g),
               lambda: plain(x, dt, lt, Bm, Cm, g), 3 * repo_fwd_flops)}
    rows = {}
    for key, (wrapper, kern, plain_fn, repo_flops) in fns.items():
        flops, nbytes = work[key]
        t_ops, t_bytes = flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
        outs_of = names[:1] if key == "B5" else names[1:]
        rows[key] = {
            "name": wrapper.__name__, "route": "cuda", "source": SSD_SOURCE,
            "replaces": SSD_REPLACES[key], "launches": None,
            "max_abs_err": max([err[n][d] for n in outs_of for d in err[n]]
                               + [r["max_abs_err"] for n in outs_of
                                  for r in main[n].values()]),
            "ms": time_ms(kern, reps=20, warm=3),
            "plain_ms": time_ms(plain_fn, reps=10, warm=2),
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None,
            "library": "none: no single PyTorch call computes this function",
            "shape": shape_s + ", bf16, the model's decays",
            "flops": flops, "bytes": nbytes,
            # benchmarks/bench_kernels.py:77-85: B·nc·H·(2Q²(N+P) + 6Q²)
            # forward, 3x backward — whole (Q, Q) tiles, cb per head
            "flops_repo_numerator": repo_flops,
            "max_abs_err_by_dtype": {n: err[n] for n in outs_of},
            "cases": cases,
            "main_shape_vs_plain": {n: main[n] for n in outs_of}}
    # B6 in bf16 runs on the tensor cores (ssd_bwd_tc); the CUDA-core
    # kernels it replaces (ssd_bwd) are timed beside it in this run
    replaced = lambda: ssk.ssd_intra_bwd(x, dt, lt, Bm, Cm, g, route="simt")
    b6_dev = device_ms(fns["B6"][1], expect="ssd_bwd_tc_kernel")
    rows["B6"].update(
        route_bf16="wgmma (ssd_bwd_tc)", route_f32="simt (ssd_bwd)",
        device_ms=b6_dev,
        wrapper_host_us=launch_us(fns["B6"][1]),
        replaced_cuda_core_ms=time_ms(replaced, reps=10, warm=2),
        replaced_cuda_core_device_ms=device_ms(replaced, reps=5),
        heads_per_block=ssk.head_groups(Bs * nc, H),
        scratch_bytes=scratch["bf16, model decays"],
        replaced_scratch_bytes=Bs * nc * H * Q * Q * 4,
        grid_vs_replaced_err_over_scale=grid_vs_replaced,
        main_shape_vs_replaced_err_over_scale=main_vs_replaced,
        targets_met={"ms_le_0.15": rows["B6"]["ms"] <= 0.15,
                             "scratch_le_10.5MB":
                                 scratch["bf16, model decays"] <= 10.5e6})
    emit({"phase": "ssd_kernels", "build_seconds": build_s,
          "cases": cases, "bit_equal_twice": True, "all_finite": True,
          "max_abs_err": err, "shape": shape_s, "cum_min": cum_min,
          "far_corner_decay_min": far_decay, "main_shape_vs_plain": main,
          "b6_tensor_cores": {k: rows["B6"][k] for k in (
              "device_ms", "wrapper_host_us", "replaced_cuda_core_ms",
              "replaced_cuda_core_device_ms", "heads_per_block",
              "scratch_bytes", "replaced_scratch_bytes",
              "grid_vs_replaced_err_over_scale",
              "main_shape_vs_replaced_err_over_scale",
              "targets_met")},
          "timing": {key: {k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms",
                                             "flops", "bytes")}
                     for key, r in rows.items()}})
    return rows


# -------------------------------------------- 10-11. mamba2-2.7b: the SSD path
def mamba2_study_phase():
    """The mamba2-2.7b study at full width and 32 layers (a study at full
    depth holds more checkpoints than the card has room for); returns its
    launch counts."""
    import torch_hpo_lm as lm_example
    from repro_torch.configs import get_config
    cfg = get_config("mamba2-2.7b")
    assert (cfg.num_layers, cfg.d_model, cfg.ssm_inner, cfg.ssm_heads,
            cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk, cfg.vocab_size,
            cfg.dtype, cfg.param_count()) == (
        64, 2560, 5120, 80, 64, 128, 128, 50280, "bfloat16", 2_702_235_136)
    launches, backend = lm_study(
        "mamba2_study", lambda: lm_example.make_backend(
            arch="mamba2-2.7b", use_kernel=True, **MAMBA_STUDY),
        MAMBA_STUDY["batch"], MAMBA_STUDY["seq_len"],
        fwd=("ssd_intra_fwd",), bwd=("ssd_intra_bwd",),
        model_fields={"published_layers": cfg.num_layers,
                      "published_parameters": cfg.param_count(),
                      "d_model": cfg.d_model, "ssd_heads": cfg.ssm_heads,
                      "state": cfg.ssm_state, "chunk": cfg.ssm_chunk,
                      "vocab": cfg.vocab_size})
    assert backend.task.cfg.num_layers == MAMBA_STUDY["layers"]
    return launches


def mamba2_step_phase(ssd_rows):
    """The full 64-layer mamba2-2.7b: step, update and profile, then B1 on
    its tree; returns B1's row there."""
    import torch_hpo_lm as lm_example
    backend = lm_example.make_backend(arch="mamba2-2.7b", use_kernel=True,
                                      batch=1, seq_len=2048, n_train=8,
                                      n_eval=1)
    cfg = backend.task.cfg
    assert cfg.num_layers == 64 and cfg.param_count() == 2_702_235_136
    ssd_ms = cfg.num_layers * (ssd_rows["B5"]["ms"] + ssd_rows["B6"]["ms"])
    step_profile("mamba2_", cfg.name, backend, "adamw", 3e-4, n_chunk=4,
                 profile_steps=2, tokens=2048,
                 port=("ssd_kernels", ssd_ms, "::ssd_"))
    free()
    return mamba2_update_phase(backend)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path[:0] = [os.path.join(ROOT, "src"), os.path.join(ROOT, "examples")]
    import repro_torch      # noqa: F401 — outside a checkout, fail here
    import torch_hpo_lm     # noqa: F401
    import torch_hpo_resnet  # noqa: F401

    smi, kind = device_phase()                                   # 1
    # the CUDA kernels build while the Triton phases run; a failed build
    # is raised where its phase joins it
    join_build = start_builds()
    b1_resnet = b1_phase(join_build)                             # 2
    small_phase()                                                # 3
    free()
    b1_resnet["launches"] = resnet_study_phase()                 # 4
    free()
    resnet_step_phase()                                          # 5
    free()
    fa_rows = attention_phase(join_build)                        # 6
    free()
    lm_small_phase("lm_small", "qwen2-0.5b", (2, 200), seed=4,
                   attention=True)
    free()
    b1_row, lm_launches = qwen2_phase(fa_rows, b1_resnet)        # 7, 8
    for key in ("B2", "B3", "B4"):
        fa_rows[key]["launches"] = lm_launches[fa_rows[key]["name"]]
    free()
    emit({"phase": "free", "device_memory_allocated_bytes":
          torch.cuda.memory_allocated()})
    ssd_rows = ssd_phase(join_build)                             # 9
    free()
    lm_small_phase("mamba2_small", "mamba2-2.7b", (2, 192), seed=5,
                   attention=False)
    free()
    m_launches = mamba2_study_phase()                            # 10
    for key in ("B5", "B6"):
        ssd_rows[key]["launches"] = m_launches[ssd_rows[key]["name"]]
    b1_row["launches_mamba2_study"] = m_launches["stacked_tree_update"]
    free()
    b1_row["mamba2_64_layers_adamw"] = mamba2_step_phase(ssd_rows)  # 11
    free()

    # ------------------------------------------------------------ last lines
    print(smi, flush=True)
    emit({"kernels": [b1_row, fa_rows["B2"], fa_rows["B3"], fa_rows["B4"],
                      ssd_rows["B5"], ssd_rows["B6"]]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
