"""Split the float32 SSD path's error against float64, on one GPU.

    python3 tools/ssd_f32_probe.py [--seed N] [--tag NAME] [--parts ...]
    python3 tools/ssd_f32_probe.py --small --device cpu   # a CPU rehearsal
    python3 tools/ssd_f32_probe.py --parts layer,timing   # the kernels

Every number is a distance from a float64 plain computation on the same
device, ``‖got − f64‖ / ‖f64‖`` unless said otherwise.  Three parts, at
the shapes of the benchmark's ``mamba2-2.7b-f32`` configuration (B 2, S
1,024, Q 128, H 80, P 64, N 128, float32) under its ``high_merge``
traffic, with weights and tokens drawn by the benchmark's rules
(``hippo_bench/weights.py``) from ``--seed``:

* ``layer``: one SSD scan (``models/ssm.py::ssd_chunked``), forward and
  backward — y, dx, ddt, dA_log (through the log-decays), dB, dC — on
  the inputs a one-layer model's projections give, by the port's kernel
  route (B5 / B6), its plain route, the plain route with TF32 products
  (the precision below float32, for scale) and the benchmark's reference
  (``hippo_bench/reference/ssd.py``);
* ``intra``: B5 and B6 alone, and their plain versions, against the
  intra-chunk term in float64: y, dx, ddt, dlt, dB, dC;
* ``step``: the configuration's 8-layer model.  One step's gradients,
  leaf by leaf, then the first rung's AdamW steps of the mix's first
  schedule: each leaf's update and second-moment norms read as
  ``hippo_bench/check.py`` reads them (the gap over max(f64's norm, the
  median leaf's)), the evaluation loss after each step, and the share of
  each leaf's first update whose sign differs from float64's (AdamW's
  first step moves every element by about the learning rate whatever its
  gradient's size, so a gradient near 0 takes its sign from rounding);
  for the port with kernels on (B1-B6), with kernels off, the reference
  and the TF32 control; and, to show how far two float32 computations of
  the same steps part, the reference with each batch's rows in one pass
  (``reference_batched``, ``f64_batched``) against itself row by row;
* ``timing``: B5 and B6 on the CUDA cores (``ssd_fwd`` / ``ssd_bwd``) at
  the configuration's shape, on the layer's inputs: ``ptxas`` registers
  and spills of each kernel, each kernel's device time (the profiler) and
  each launch's time by CUDA events beside its bound (float32 at 67
  TFLOP/s, 3.35 TB/s; ``hippo_bench/flops.py``) and the share of it, the
  launches and the scratch the head sum took, whether two identical
  launches give identical bits, and whether a launch of two members
  folded into the batch axis gives each member the bits of its own
  launch.

One JSON line a part on standard output; the whole is also written to
``chiprun_out/ssd_f32_probe_<tag>.json``.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
from hippo_bench import cells, check, studies, weights      # noqa: E402
from hippo_bench.reference import lm as ref                 # noqa: E402
from hippo_bench.reference import ssd as ref_ssd            # noqa: E402
from hippo_bench.reference import tf32                      # noqa: E402
from repro_torch.kernels import ssd_scan                    # noqa: E402
from repro_torch.models.layers import rms_norm              # noqa: E402
from repro_torch.models.ssm import (_segsum, _ssm_project,  # noqa: E402
                                    ssd_chunked)
from repro_torch.models.transformer import LM               # noqa: E402

CONFIG = "mamba2-2.7b-f32"
SMALL = {"d_model": 64, "d_state": 16, "chunk_size": 16, "n_layer": 2,
         "vocab_size": 256, "seq_len": 64}


def rel(got, want):
    want = want.double()
    return float((got.double() - want).norm() / want.norm())


def precise(on=True):
    torch.backends.cuda.matmul.allow_tf32 = not on
    torch.backends.cudnn.allow_tf32 = not on


def model(cfg, device, seed, layers=None):
    """(port config, parameter tree) drawn from ``seed``."""
    cfg = dict(cfg, n_layer=layers or cfg["n_layer"])
    mc = cells.port_config(cfg)
    with torch.device("meta"):
        skeleton = LM(mc).init(torch.Generator())
    return cfg, mc, weights.make_params(skeleton, mc.d_model, seed, device)


def scan_inputs(cfg, device, seed):
    """The SSD scan's inputs from a one-layer model's first block: x, dt,
    A_log, B, C and a cotangent for y."""
    cfg, mc, params = model(cfg, device, seed, layers=1)
    B, S = cfg["batch"], cfg["seq_len"]
    tokens = weights.make_tokens(B, S, cfg["vocab_size"], seed, device)
    p = ref.flat(params)
    block = {k[-1]: v[0] for k, v in p.items() if k[0] == "cycles"}
    with torch.no_grad():
        h = rms_norm(F.embedding(tokens.long(), p[("embed",)]),
                     block["norm1"], mc.norm_eps)
        _, xs, Bm, Cm, dt_raw, _ = _ssm_project(block, mc, h)
        dt = F.softplus(dt_raw.float() + block["dt_bias"])
    H, P = mc.ssm_heads, mc.ssm_head_dim
    gen = torch.Generator(device=device).manual_seed(
        weights.derive(seed, "cotangent"))
    g = torch.randn((B, S, H, P), generator=gen, device=device)
    return (xs.reshape(B, S, H, P), dt, block["A_log"], Bm, Cm, g,
            mc.ssm_chunk)


def scan(route, x, dt, A_log, Bm, Cm, g, Q, dtype=torch.float32):
    """y and the gradients of <y, g> by one route."""
    leaves = [t.detach().to(dtype).requires_grad_(True)
              for t in (x, dt, A_log, Bm, Cm)]
    xl, dtl, al, Bl, Cl = leaves
    A = -torch.exp(al)
    precise(route != "plain_tf32")
    if route == "reference":
        y = ref_ssd.ssd(xl, dtl, A, Bl, Cl, Q, torch.matmul)
    else:
        y, _ = ssd_chunked(xl, dtl, A, Bl, Cl, Q,
                           use_kernel=route == "kernel")
    grads = torch.autograd.grad(y, leaves, g.to(dtype))
    precise()
    return [y.detach()] + list(grads)


def layer_part(cfg, device, seed):
    x, dt, A_log, Bm, Cm, g, Q = scan_inputs(cfg, device, seed)
    names = ["y", "dx", "ddt", "dA_log", "dB", "dC"]
    truth = scan("plain", x, dt, A_log, Bm, Cm, g, Q, torch.float64)
    out = {"shape": list(x.shape) + [Bm.shape[-1], Q]}
    for route in ("kernel", "plain", "plain_tf32", "reference"):
        got = scan(route, x, dt, A_log, Bm, Cm, g, Q)
        out[route] = {n: rel(a, b) for n, a, b in zip(names, got, truth)}
    got = scan("reference", x, dt, A_log, Bm, Cm, g, Q, torch.float64)
    out["reference_f64"] = {n: rel(a, b) for n, a, b in
                            zip(names, got, truth)}
    return out


def intra_part(cfg, device, seed):
    """B5 / B6 and their plain versions against the intra-chunk term in
    float64 (the plain route's formula, under autograd)."""
    x, dt, A_log, Bm, Cm, g, Q = scan_inputs(cfg, device, seed)
    Bsz, S, H, P = x.shape
    nc, N = S // Q, Bm.shape[-1]
    xr = x.reshape(Bsz, nc, Q, H, P).contiguous()
    dtr = dt.reshape(Bsz, nc, Q, H).contiguous()
    ltT = (dtr * -torch.exp(A_log)).movedim(-1, -2).contiguous()
    Br = Bm.reshape(Bsz, nc, Q, N).contiguous()
    Cr = Cm.reshape(Bsz, nc, Q, N).contiguous()
    gr = g.reshape(Bsz, nc, Q, H, P).contiguous()
    leaves = [t.double().requires_grad_(True) for t in (xr, dtr, ltT, Br,
                                                        Cr)]
    xl, dtl, ll, Bl, Cl = leaves
    cb = torch.einsum("bcin,bcjn->bcij", Cl, Bl)
    att = cb[:, :, None] * \
        torch.exp(_segsum(ll)) * \
        dtl.movedim(-1, -2)[..., None, :]
    y = torch.einsum("bchij,bcjhp->bcihp", att, xl)
    truth = [y.detach()] + list(torch.autograd.grad(y, leaves, gr.double()))
    names = ["y", "dx", "ddt", "dlt", "dB", "dC"]
    cum = torch.cumsum(ltT.double(), -1)
    plain = [ssd_scan.fwd_plain(xr, dtr, cum, Br, Cr)] + list(
        ssd_scan.bwd_plain(xr, dtr, cum, Br, Cr, gr))
    kernel = [ssd_scan.ssd_intra_fwd(xr, dtr, ltT, Br, Cr)] + list(
        ssd_scan.ssd_intra_bwd(xr, dtr, ltT, Br, Cr, gr))
    return {"kernel": {n: rel(a, b) for n, a, b in zip(names, kernel,
                                                          truth)},
            "plain_version": {n: rel(a, b) for n, a, b in
                              zip(names, plain, truth)}}


# ------------------------------------------------------------- the step
class Side:
    """One way of taking the first rung: gradients and updates."""

    def __init__(self, name, cfg, mc, params, device):
        self.name = name
        self.batched = name.endswith("_batched")
        if name in ("kernel", "plain"):
            from repro_torch.kernels.optim import fused_apply_update
            from repro_torch.train.optimizer import (apply_update,
                                                     init_opt_state)
            self.lm = LM(mc, use_kernel=name == "kernel")
            self.params = params
            self.opt = init_opt_state("adamw", params)
            self.update = (fused_apply_update if name == "kernel"
                           else apply_update)
        else:
            dtype = (torch.float64 if name.startswith("f64")
                     else torch.float32)
            self.model = ref.ReferenceLM(
                cfg, tf32.matmul if name == "control" else torch.matmul)
            self.params = {k: v.to(dtype) for k, v in
                           ref.flat(params).items()}
            zero = {k: torch.zeros_like(v) for k, v in self.params.items()}
            self.opt = {"m": zero, "v": dict(zero)}
        self.p0 = {k: v.clone() for k, v in self.flat().items()}

    def flat(self):
        """The parameters, ``{path: leaf}``."""
        return ref.flat(self.params) if hasattr(self, "lm") else self.params

    def grads(self, tokens):
        if hasattr(self, "lm"):
            from repro_torch.train.torch_trainer import value_and_grad
            (loss, _), g = value_and_grad(self.lm.loss, self.params,
                                          {"tokens": tokens.long()})
            return float(loss), ref.flat(g)
        if self.batched:
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in self.params.items()}
            loss = self.model.nll(leaves, tokens)
            g = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True, materialize_grads=True)
            return float(loss.detach()), dict(zip(leaves, g))
        return self.model.loss_and_grads(self.params, tokens)

    def step(self, grads, lr, wd, step):
        if hasattr(self, "lm"):
            self.params, self.opt = self.update(
                "adamw", self.params, grads, self.opt,
                {"lr": lr, "wd": wd}, step)
        else:
            self.params, self.opt = ref.adamw(self.params, grads, self.opt,
                                              lr, wd, step)

    def evaluate(self, tokens):
        with torch.no_grad():
            if hasattr(self, "lm"):
                return float(self.lm.loss(self.params,
                                          {"tokens": tokens.long()})[0])
            return self.model.evaluate(self.params, tokens)

    def norms(self):
        p = self.flat()
        v = ref.flat(self.opt["v"]) if hasattr(self, "lm") else self.opt["v"]
        norm = torch.linalg.vector_norm
        return {"update": torch.stack([norm((p[k] - p0).double())
                                       for k, p0 in self.p0.items()]),
                "grad_rms": torch.stack([v[k].double().sum().sqrt()
                                         for k in self.p0])}


def step_part(cfg, device, seed):
    mix = studies.load_mix("high_merge")
    steps = mix["tuner"]["min_steps"]
    cfg, mc, params = model(cfg, device, seed)
    n, B = cfg["n_train"], cfg["batch"]
    tokens = weights.make_tokens(n + cfg["n_eval"], cfg["seq_len"],
                                 cfg["vocab_size"], seed, device)
    pipe_seed = weights.derive(seed, "pipeline") % 2 ** 32

    def batch(step):
        rows = weights.batch_rows(pipe_seed, n, B, step)
        return tokens[torch.as_tensor(rows, device=device)]

    sched = studies.schedule(mix["studies"][0][0], steps)
    names = ["/".join(map(str, k)) for k in ref.flat(params)]

    def gaps(got, want):
        """The check's numbers of ``got`` against ``want``: eval gap, and
        the worst leaf's update and second-moment gaps."""
        keep = want["grad_rms"] >= 1e-3 * want["grad_rms"].median()
        out = {"eval_gap": abs(got["eval"] - want["eval"])}
        for what in ("update", "grad_rms"):
            g = check.leaf_gaps(got[what], want[what])
            g = {nm: float(x) for nm, x, k in zip(names, g, keep) if k}
            out[what + "_gap"] = max(g.items(), key=lambda kv: kv[1])
            out[what + "_gaps"] = g
        return out

    out, truth, kept = {"steps": steps, "schedule": sched}, None, {}
    for name in ("f64", "kernel", "plain", "reference", "control",
                 "reference_batched", "f64_batched"):
        t0 = time.perf_counter()
        side = Side(name, cfg, mc, params, device)
        row = {"eval_by_step": []}
        for s, (lr, wd) in enumerate(sched):
            loss, g = side.grads(batch(s))
            if s == 0:
                row["loss0"] = loss
                if truth is None:
                    truth = {k: v.clone() for k, v in g.items()}
                else:
                    errs = {nm: rel(g[k], truth[k])
                            for nm, k in zip(names, g)}
                    row["grad_rel"] = errs
                    row["grad_rel_worst"] = max(errs.items(),
                                                key=lambda kv: kv[1])
            side.step(g if hasattr(side, "model") else
                      weights.rebuild(params, g), lr, wd, s)
            del g
            if s == 0:
                p1 = side.flat()
                signs = {k: torch.sign(p1[k] - p0).to(torch.int8)
                         for k, p0 in side.p0.items()}
                if name == "f64":
                    truth_signs = signs
                else:
                    flips = {nm: float((signs[k] != truth_signs[k]).double()
                                       .mean())
                             for nm, k in zip(names, signs)}
                    row["sign_flips"] = flips
                    row["sign_flips_worst"] = max(flips.items(),
                                                  key=lambda kv: kv[1])
                del p1, signs
            row["eval_by_step"].append(side.evaluate(tokens[n:]))
        kept[name] = dict(side.norms(), eval=row["eval_by_step"][-1])
        row["eval"] = kept[name]["eval"]
        if name != "f64":
            row.update(gaps(kept[name], kept["f64"]))
        row["seconds"] = time.perf_counter() - t0
        out[name] = row
        print(json.dumps({"side": name, **{
            k: v for k, v in row.items()
            if k not in ("grad_rel", "update_gaps", "grad_rms_gaps",
                         "sign_flips")}}),
            flush=True)
        del side
        if device.type == "cuda":
            torch.cuda.empty_cache()
    for a, b in (("reference_batched", "reference"), ("f64_batched", "f64")):
        row = gaps(kept[a], kept[b])
        out[f"{a} vs {b}"] = row
        print(json.dumps({"pair": f"{a} vs {b}", **{
            k: v for k, v in row.items() if not k.endswith("_gaps")}}),
            flush=True)
    return out


def kernel_ms(fn, names, reps=20):
    """``{name: milliseconds}``: each named kernel's device time a launch
    over ``reps`` calls of ``fn``, from the profiler's trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for name in names:
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and name in e.key]
        us = sum(getattr(e, "self_device_time_total", 0.0) for e in rows)
        n = sum(e.count for e in rows)
        out[name] = us / 1e3 / n if n else 0.0
    return out


def timing_part(cfg, device, seed):
    """B5 / B6 on the CUDA cores at the configuration's shape."""
    import chip_smoke as cs
    from hippo_bench import flops
    from repro_torch.kernels import _cuda
    x, dt, A_log, Bm, Cm, g, Q = scan_inputs(cfg, device, seed)
    Bsz, S, H, P = x.shape
    nc, N = S // Q, Bm.shape[-1]
    xr = x.reshape(Bsz, nc, Q, H, P).contiguous()
    dtr = dt.reshape(Bsz, nc, Q, H).contiguous()
    ltT = (dtr * -torch.exp(A_log)).movedim(-1, -2).contiguous()
    Br = Bm.reshape(Bsz, nc, Q, N).contiguous()
    Cr = Cm.reshape(Bsz, nc, Q, N).contiguous()
    gr = g.reshape(Bsz, nc, Q, H, P).contiguous()
    args = (xr, dtr, ltT, Br, Cr)
    fwd = lambda: ssd_scan.ssd_intra_fwd(*args)
    bwd = lambda: ssd_scan.ssd_intra_bwd(*args, gr)
    out = {"shape": dict(B=Bsz, nc=nc, Q=Q, H=H, P=P, N=N, dtype="float32"),
           "ptxas": _cuda.ptxas_report("ssd_scan", "simt"),
           "heads_per_block": ssd_scan.simt_groups(Bsz * nc, H, Q, P)}
    out["ptxas"].update(_cuda.ptxas_report("ssd_scan", "sum_kernel"))
    launches = (ssd_scan.ssd_intra_fwd.launches,
                ssd_scan.ssd_intra_bwd.launches)
    one = [fwd()] + list(bwd())
    two = [fwd()] + list(bwd())
    out["launches"] = [ssd_scan.ssd_intra_fwd.launches - launches[0],
                       ssd_scan.ssd_intra_bwd.launches - launches[1]]
    out["tensor_core_launches"] = [ssd_scan.ssd_intra_fwd.launches_tc,
                                   ssd_scan.ssd_intra_bwd.launches_tc]
    out["scratch_bytes"] = ssd_scan.ssd_intra_bwd.scratch_bytes
    names = ["y", "dx", "ddt", "dlt", "dB", "dC"]
    out["bit_equal_twice"] = {n: torch.equal(a, b)
                              for n, a, b in zip(names, one, two)}
    # two members folded into the batch axis against each one alone
    other = [t.roll(1, dims=1).contiguous() for t in (*args, gr)]
    fold = [torch.cat([a, b]) for a, b in zip((*args, gr), other)]
    both = [ssd_scan.ssd_intra_fwd(*fold[:5], members=2)] + list(
        ssd_scan.ssd_intra_bwd(*fold, members=2))
    alone = [[ssd_scan.ssd_intra_fwd(*m[:5])] + list(
        ssd_scan.ssd_intra_bwd(*m)) for m in ((*args, gr), other)]
    out["folded_bits_equal"] = {
        n: all(torch.equal(both[i][k * Bsz:(k + 1) * Bsz], alone[k][i])
               for k in range(2)) for i, n in enumerate(names)}
    work = flops.ssd_work(Bsz, nc, Q, H, P, N, 4)
    rows = {}
    for key, fn, kernels in (
            ("B5", fwd, ["ssd_fwd_simt_kernel"]),
            ("B6", bwd, ["ssd_bwd_simt_kernel", "ssd_bwd_sum_kernel"])):
        bound = flops.bound_s(*work[key], "float32") * 1e3
        dev = kernel_ms(fn, kernels)
        total = sum(dev.values())
        rows[key] = {"events_ms": [cs.time_ms(fn) for _ in range(2)],
                     "device_ms": dev, "device_ms_total": total,
                     "bound_ms": bound,
                     "bound_by": ("operations" if work[key][0] / 67e12 >=
                                  work[key][1] / 3.35e12 else "bytes"),
                     "flops": work[key][0], "bytes": work[key][1],
                     "bound_share_pct": 100 * bound / total if total else
                     None}
    out["kernels"] = rows
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=3141592653)
    ap.add_argument("--tag", default="probe")
    ap.add_argument("--parts", default="layer,intra,step")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true",
                    help="the configuration at a CPU test's widths")
    args = ap.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("ssd_f32_probe: no CUDA device available", file=sys.stderr)
        return 1
    precise()
    cfg = dict(cells.load_config(CONFIG))
    if args.small:
        cfg.update(SMALL)
    card = "cpu"
    if device.type == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip()
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          card, flush=True)
    summary = dict(tag=args.tag, card=card, torch=torch.__version__,
                   seed=args.seed)
    parts = {"layer": lambda: layer_part(cfg, device, args.seed),
             "intra": lambda: intra_part(cfg, device, args.seed),
             "step": lambda: step_part(cfg, device, args.seed),
             "timing": lambda: timing_part(cfg, device, args.seed)}
    for part in args.parts.split(","):
        t0 = time.perf_counter()
        summary[part] = parts[part]()
        summary[part]["seconds"] = time.perf_counter() - t0
        if part != "step":
            print(json.dumps({"part": part, **summary[part]}), flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out",
                           f"ssd_f32_probe_{args.tag}.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
