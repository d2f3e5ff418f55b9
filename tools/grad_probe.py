"""hubert-xlarge's step-0 gradients on the kernels against the plain path.

    python3 tools/grad_probe.py [--layers 24 48] [--steps 3] [--out F]

On one GPU.  hubert-xlarge's train step (``train/step.py``'s
``build_train_step`` and the loss it differentiates, ``value_and_grad``
of ``LM.loss``) on the batch ``chip_smoke.py``'s ``frontends`` phase
draws: 4 × 1024 audio frames (seed 31), head dim 80, 16 / 16 heads,
non-causal.  At each depth the per-leaf gradients of step 0, before any
update, are taken four times from the same parameters (``LM.init(0)``):

* ``bf16`` — the model's dtype; the kernels' path runs B2–B4 on the
  tensor cores (``fa_*_tc``);
* ``f32`` — the same parameters and frames cast to f32 (exact); the
  kernels' path runs the f32 kernels (``fa_fwd`` / ``fa_bwd_*``);

each with ``use_kernel`` on and off.  The plain f32 gradients are the
reference, as the plain version on the inputs cast to f32 is
``chip_smoke.py::rounding_rule``'s.  Per leaf class (the leaf's path;
the layer stack is one leaf) it prints:

* ``rule_kernel`` / ``rule_plain`` — max over elements of
  |g − g_ref| / (2^-16 · scale + 1 bf16 ulp of the value + 2^-8 · |g_ref|),
  ``rounding_rule``'s allowance with the envelope the reference's own
  magnitude (each rounded value moves by at most 2^-8 of itself);
* ``rel_kernel`` / ``rel_plain`` — ‖g − g_ref‖ / ‖g_ref‖;
* ``rel_kernel_vs_plain`` — ‖g_kernel − g_plain‖ / ‖g_plain‖ within a
  route.

On the f32 route the kernels' gradients are held against the plain
ones by ``rel_kernel_vs_plain`` alone.  Then ``--steps`` AdamW steps
(lr 3e-4, as ``frontends``) from the same parameters on each of the four
paths, and each path's losses against the plain bf16 path's by the
``LAUNCH_LOSS_RTOL`` (2^-8) ratio that ``frontend_train`` asserts.

Prints one JSON object per depth and, last, a summary line; with
``--out``, writes everything, the per-leaf rows included, to that JSON
file as well.  Exits non-zero without a CUDA device.
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
from repro_torch.configs import get_config                 # noqa: E402
from repro_torch.kernels import flash_attention as fa      # noqa: E402
from repro_torch.models.transformer import LM              # noqa: E402
from repro_torch.train.optimizer import init_opt_state     # noqa: E402
from repro_torch.train.step import build_train_step        # noqa: E402
from repro_torch.train.torch_trainer import value_and_grad  # noqa: E402
from repro_torch.utils.tree import tree_map                # noqa: E402

DEV = torch.device("cuda")
LAUNCH_LOSS_RTOL = 2.0 ** -8         # chip_smoke.py's frontend_train check
BATCH, FRAMES = 4, 1024              # chip_smoke.py's HUBERT_TRAIN


def leaves_with_paths(tree, path=""):
    """``[(path, tensor)]`` of a dict / list tree, list indices kept."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in leaves_with_paths(v, f"{path}.{k}" if path else k)]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in leaves_with_paths(v, f"{path}[{i}]")]
    return [(path, tree)]


def rule(g, ref):
    """max |g − ref| / (2^-16 scale + 1 bf16 ulp + 2^-8 |ref|)."""
    g = g.float()
    diff = (g - ref).abs()
    scale = float(ref.abs().max())
    _, e = torch.frexp(torch.maximum(g.abs(), ref.abs()))
    ulp = torch.ldexp(torch.ones_like(diff), e - 8)
    return float((diff / (scale * 2 ** -16 + ulp + 2 ** -8 * ref.abs()))
                 .max())


def rel(a, b):
    """‖a − b‖ / ‖b‖ (0 where b is all zeros and a equals it)."""
    a, b = a.float(), b.float()
    nb = float(b.norm())
    d = float((a - b).norm())
    return d / nb if nb > 0 else d


def grads(cfg, params, batch, use_kernel):
    model = LM(cfg, use_kernel=use_kernel)
    n0 = [w.launches for w in (fa.flash_attention_fwd,
                               fa.flash_attention_bwd_dq,
                               fa.flash_attention_bwd_dkv)]
    (loss, _), g = value_and_grad(model.loss, params, batch)
    torch.cuda.synchronize()
    launched = [w.launches - n for w, n in zip(
        (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
         fa.flash_attention_bwd_dkv), n0)]
    want = [cfg.num_layers] * 3 if use_kernel else [0] * 3
    assert launched == want, (launched, want)
    return float(loss), g


def losses(cfg, params, batch, use_kernel, steps):
    step_fn = build_train_step(LM(cfg, use_kernel=use_kernel), "adamw")
    opt = init_opt_state("adamw", params)
    out = []
    for i in range(steps):
        params, opt, loss = step_fn(params, opt, batch, 3e-4, i)
        out.append(float(loss))
    return out


def depth(hub, layers, steps):
    cfg = dataclasses.replace(hub, num_layers=layers)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    gen = torch.Generator().manual_seed(31)
    batch = {"features": torch.randn((BATCH, FRAMES, hub.frontend_dim),
                                     generator=gen).to(DEV, torch.bfloat16),
             "labels": torch.randint(0, hub.vocab_size, (BATCH, FRAMES),
                                     generator=gen).to(DEV)}
    batch32 = dict(batch, features=batch["features"].float())
    params = LM(cfg).init(0, device=DEV)
    params32 = tree_map(lambda x: x.float(), params)
    assert fa.fwd_route(torch.bfloat16, 80) == "wgmma"
    assert fa.fwd_route(torch.float32, 80) == "simt"

    t0 = time.perf_counter()
    loss, g = {}, {}
    for route, c, p, b in (("f32", cfg32, params32, batch32),
                           ("bf16", cfg, params, batch)):
        for path, k in (("kernels", True), ("plain", False)):
            loss[route, path], g[route, path] = grads(c, p, b, k)
    ref = dict(leaves_with_paths(g["f32", "plain"]))
    classes = {}
    for name, gk in leaves_with_paths(g["bf16", "kernels"]):
        gp = dict(leaves_with_paths(g["bf16", "plain"]))[name]
        gk32 = dict(leaves_with_paths(g["f32", "kernels"]))[name]
        r = ref[name]
        if float(r.abs().max()) == 0.0:      # a leaf the loss never reads
            assert float(gk.abs().max()) == float(gp.abs().max()) == 0.0
            continue
        classes[name] = {
            "shape": list(r.shape), "scale": float(r.abs().max()),
            "bf16": {"rule_kernel": rule(gk, r), "rule_plain": rule(gp, r),
                     "rel_kernel": rel(gk, r), "rel_plain": rel(gp, r),
                     "rel_kernel_vs_plain": rel(gk, gp)},
            "f32": {"rule_kernel": rule(gk32, r),
                    "rel_kernel_vs_plain": rel(gk32, r)}}
    grad_s = time.perf_counter() - t0
    del g, ref
    torch.cuda.empty_cache()

    run = {}
    for route, c, p, b in (("bf16", cfg, params, batch),
                           ("f32", cfg32, params32, batch32)):
        for path, k in (("kernels", True), ("plain", False)):
            run[f"{route}_{path}"] = losses(c, p, b, k, steps)
    base = run["bf16_plain"]
    ratios = {key: [abs(a - b) / (LAUNCH_LOSS_RTOL * abs(b))
                    for a, b in zip(v, base)]
              for key, v in run.items() if key != "bf16_plain"}
    ratios["f32_kernels_vs_f32_plain"] = [
        abs(a - b) / (LAUNCH_LOSS_RTOL * abs(b))
        for a, b in zip(run["f32_kernels"], run["f32_plain"])]

    worst = lambda route, key: max(v[route][key] for v in classes.values())
    summary = {
        "bf16_rule_kernel_max": worst("bf16", "rule_kernel"),
        "bf16_rule_plain_max": worst("bf16", "rule_plain"),
        "bf16_rel_kernel_max": worst("bf16", "rel_kernel"),
        "bf16_rel_plain_max": worst("bf16", "rel_plain"),
        "bf16_rel_kernel_over_plain_max": max(
            v["bf16"]["rel_kernel"] / v["bf16"]["rel_plain"]
            for v in classes.values()),
        "f32_rel_kernel_vs_plain_max": worst("f32", "rel_kernel_vs_plain"),
        "f32_rule_kernel_max": worst("f32", "rule_kernel")}
    return {"layers": layers, "step0_loss": {
        f"{r}_{p}": v for (r, p), v in loss.items()},
        "grad_seconds": grad_s, "summary": summary,
        "loss_steps": run, "loss_ratio_over_rtol": ratios,
        "leaf_classes": classes}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, nargs="+", default=[24, 48])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default=None,
                    help="also write every row, per leaf, to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("grad_probe: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    print(card, flush=True)
    hub = get_config("hubert-xlarge")
    rows = []
    for L in args.layers:
        row = depth(hub, L, args.steps)
        rows.append(row)
        print(json.dumps({k: v for k, v in row.items()
                          if k != "leaf_classes"}), flush=True)
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "torch": torch.__version__,
                       "rows": rows}, f, indent=1)
    print(json.dumps({"card": card, "summaries": {
        r["layers"]: r["summary"] for r in rows}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
