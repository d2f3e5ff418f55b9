"""Check and time the f32 flash-attention kernels (B2–B4) on one GPU.

    python3 tools/fa_f32_probe.py [--tag NAME]

Builds ``src/repro_torch/kernels/csrc/flash_attention.cu`` (``ptxas -v``
runs with the build) and prints the f32 kernels' registers and spills;
then runs ``fa_fwd`` / ``fa_bwd_dq`` / ``fa_bwd_dkv`` on f32 shapes — the
benchmark cells' (B 2, S 1024, Hq 14, Hkv 2, hd 64, causal) and the odd
ones of ``chip_smoke.py``'s grid (head dims 20, 32, 80, 128, 256, windowed,
non-causal, GQA 1:1 and 7:1, S 130 and 160, a misaligned operand) — each
kernel twice (bit-equal), against the plain versions at ``chip_smoke.py``'s
f32 tolerances (forward atol 2e-5 + rtol 2e-5; gradients atol 2e-4 + rtol
2e-3), with the executed tiles equal to ``fa_tile_counts`` and every launch
on the CUDA-core route.  At the cells' shape it times each kernel by CUDA
events and by the profiler's device time, beside its bound (f32 FFMA peak,
67 TFLOP/s: forward 4·B·Hq·hd·(live pairs), dq 1.5×, dk / dv 2×), the
plain versions and SDPA in f32 (a yardstick; the package never calls it).  One
JSON line a case; the summary is also written to
``chiprun_out/fa_f32_probe_<tag>.json``.  Exits non-zero if a case fails.
"""
import argparse
import json
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
from repro_torch.kernels import _cuda                      # noqa: E402
from repro_torch.kernels import flash_attention as fa      # noqa: E402

F32_FLOP_PER_S = 67e12
CELL = (2, 1024, 14, 2, 64, True, 0)
CASES = [CELL,
         (1, 130, 4, 4, 64, True, 0),      # GQA 1:1, ragged
         (1, 130, 14, 2, 64, False, 0),    # GQA 7:1, non-causal
         (1, 130, 14, 2, 64, True, 48),    # window
         (2, 160, 4, 1, 20, True, 48),     # hd 20, MQA
         (1, 96, 8, 1, 32, True, 0),       # hd 32
         (2, 160, 4, 4, 80, False, 0),     # hd 80 (hubert's)
         (1, 130, 4, 2, 128, True, 48),    # hd 128
         (1, 160, 4, 1, 256, True, 0),     # hd 256 (recurrentgemma's)
         (1, 130, 2, 1, 256, False, 48)]
MISALIGNED = (1, 130, 4, 2, 64, True, 0)   # q one float off 16 bytes


def live_pairs(S, causal, window):
    q = torch.arange(S)[:, None]
    k = torch.arange(S)[None, :]
    ok = torch.ones(S, S, dtype=torch.bool)
    if causal:
        ok &= k <= q
    if window > 0:
        ok &= k > q - window
    return int(ok.sum())


def within(a, b, atol, rtol):
    d = (a.float() - b.float()).abs()
    return (float(d.max()) if d.numel() else 0.0,
            bool((d <= atol + rtol * b.float().abs()).all())
            and bool(a.isfinite().all()))


def events_ms(f, reps=20):
    for _ in range(3):
        f()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(True), torch.cuda.Event(True)
    e0.record()
    for _ in range(reps):
        f()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def device_ms(fns, reps=10):
    """{kernel name: device ms a launch} over ``reps`` calls of each of
    ``fns`` under the profiler."""
    from torch.profiler import ProfilerActivity, profile
    for f in fns:
        f()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for f in fns:
            for _ in range(reps):
                f()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        m = re.search(r"(fa_\w+?_kernel)\b", ev.key)
        if m and "_tc_" not in ev.key:
            t = getattr(ev, "device_time_total", None)
            if t is None:
                t = ev.cuda_time_total
            out[m.group(1)] = t / 1e3 / ev.count
    return out


def inputs(B, S, Hq, Hkv, hd, gen, misaligned=False):
    dev = torch.device("cuda")
    shapes = ((B, S, Hq, hd), (B, S, Hkv, hd), (B, S, Hkv, hd),
              (B, S, Hq, hd))
    xs = [torch.randn(s, generator=gen).to(dev) for s in shapes]
    if misaligned:
        n = xs[0].numel()
        buf = torch.empty(n + 1, device=dev)
        buf[1:] = xs[0].reshape(-1)
        xs[0] = buf[1:].view(shapes[0])
    return xs


def run_case(case, gen, misaligned=False):
    B, S, Hq, Hkv, hd, causal, window = case
    mk = dict(causal=causal, window=window)
    q, k, v, do = inputs(B, S, Hq, Hkv, hd, gen, misaligned)
    wr = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
          fa.flash_attention_bwd_dkv)
    n0 = [(w.launches, w.launches_tc) for w in wr]
    fwd = [fa.flash_attention_fwd(q, k, v, return_lse=True,
                                  count_tiles=True, **mk) for _ in range(2)]
    out, lse, tiles = fwd[0]
    delta = (do * out).sum(-1).transpose(1, 2).contiguous()
    dqs = [fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **mk)
           for _ in range(2)]
    dkvs = [fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **mk)
            for _ in range(2)]
    torch.cuda.synchronize()
    row = dict(shape=[B, S, Hq, Hkv, hd], causal=causal, window=window,
               misaligned=misaligned)
    row["f32_launches"] = [(w.launches - a) - (w.launches_tc - t)
                           for w, (a, t) in zip(wr, n0)]
    row["tc_launches"] = [w.launches_tc - t for w, (_, t) in zip(wr, n0)]
    row["bit_equal"] = all(torch.equal(a, b) for a, b in zip(
        fwd[0][:2] + (dqs[0],) + dkvs[0], fwd[1][:2] + (dqs[1],) + dkvs[1]))
    want = B * Hq * fa.fa_tile_counts(S, S, *fa.fwd_blocks(torch.float32,
                                                           hd),
                                      causal, window)[0]
    row["tiles"] = [int(tiles), int(fwd[1][2]), want]
    p_out, p_lse, _ = fa.fwd_plain(q, k, v, **mk)
    p_dq = fa.bwd_dq_plain(q, k, v, do, lse, delta, **mk)
    p_dk, p_dv = fa.bwd_dkv_plain(q, k, v, do, lse, delta, **mk)
    ok = row["bit_equal"] and row["f32_launches"] == [2, 2, 2] \
        and row["tc_launches"] == [0, 0, 0] \
        and row["tiles"][0] == row["tiles"][1] == want
    for name, a, b, tol in (("out", out, p_out, (2e-5, 2e-5)),
                            ("lse", lse, p_lse, (2e-5, 2e-5)),
                            ("dq", dqs[0], p_dq, (2e-4, 2e-3)),
                            ("dk_h", dkvs[0][0], p_dk, (2e-4, 2e-3)),
                            ("dv_h", dkvs[0][1], p_dv, (2e-4, 2e-3))):
        err, good = within(a, b, *tol)
        row[name] = dict(max_abs_err=err, ok=good,
                         scale=float(b.float().abs().max()))
        ok = ok and good
    row["ok"] = ok
    if case == CELL and not misaligned:
        row["timing"] = timing(q, k, v, do, out, lse, delta, mk)
    return row


def timing(q, k, v, do, out, lse, delta, mk):
    import torch.nn.functional as F
    B, S, Hq, hd = q.shape
    pairs = live_pairs(S, mk["causal"], mk["window"])
    f2 = 4.0 * B * Hq * hd * pairs
    bound = {"B2": f2 / F32_FLOP_PER_S * 1e3,
             "B3": 1.5 * f2 / F32_FLOP_PER_S * 1e3,
             "B4": 2.0 * f2 / F32_FLOP_PER_S * 1e3}
    kern = {"B2": lambda: fa.flash_attention_fwd(q, k, v, return_lse=True,
                                                 **mk),
            "B3": lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                                    **mk),
            "B4": lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse,
                                                     delta, **mk)}
    plain = {"B2": lambda: fa.fwd_plain(q, k, v, **mk),
             "B3": lambda: fa.bwd_dq_plain(q, k, v, do, lse, delta, **mk),
             "B4": lambda: fa.bwd_dkv_plain(q, k, v, do, lse, delta, **mk)}
    res = {}
    for key in ("B2", "B3", "B4"):
        ms = [events_ms(kern[key]), events_ms(kern[key])]
        res[key] = dict(ms=ms, bound_ms=bound[key],
                        roofline_pct=100 * bound[key] / min(ms),
                        plain_ms=events_ms(plain[key], reps=3))
    dev = device_ms([kern["B2"], kern["B3"], kern["B4"]])
    for key, name in (("B2", "fa_fwd_kernel"), ("B3", "fa_bwd_dq_kernel"),
                      ("B4", "fa_bwd_dkv_kernel")):
        d = dev.get(name)
        res[key]["device_ms"] = d
        res[key]["device_roofline_pct"] = (100 * bound[key] / d if d
                                           else None)
    # SDPA in f32 on (B, H, S, hd) views: a yardstick only
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    g = Hq // k.shape[2]
    ke, ve = (x.repeat_interleave(g, dim=1) for x in (kt, vt))
    lib_f = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, ke, ve, is_causal=mk["causal"])
    qg, kg, vg = (x.detach().clone().requires_grad_(True)
                  for x in (qt, ke, ve))

    def lib_fb():
        o = F.scaled_dot_product_attention(qg, kg, vg,
                                           is_causal=mk["causal"])
        torch.autograd.grad(o, (qg, kg, vg), dot)

    lf, lfb = events_ms(lib_f), events_ms(lib_fb)
    res["library"] = dict(fwd_ms=lf, fwd_bwd_ms=lfb, bwd_ms=lfb - lf,
                          what="F.scaled_dot_product_attention, f32, the "
                               "KV heads repeated; backward = fwd+bwd - fwd")
    tot = sum(res[x]["bound_ms"] for x in ("B2", "B3", "B4"))
    dtot = [res[x]["device_ms"] for x in ("B2", "B3", "B4")]
    res["step_roofline_pct"] = (100 * tot / sum(dtot)
                                if all(dtot) else None)
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", default="change")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fa_f32_probe: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          card, flush=True)
    fa._lib()
    regs = {k: v for k, v in _cuda.ptxas_report("flash_attention").items()
            if k.startswith("fa_") and "_tc" not in k}
    print("ptxas", json.dumps(regs), flush=True)
    gen = torch.Generator().manual_seed(31)
    rows, bad = [], 0
    for case in CASES:
        row = run_case(case, gen)
        rows.append(row)
        bad += not row["ok"]
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    row = run_case(MISALIGNED, gen, misaligned=True)
    rows.append(row)
    bad += not row["ok"]
    print(json.dumps(row), flush=True)
    summary = dict(tag=args.tag, card=card, torch=torch.__version__,
                   ptxas=regs, rows=rows, bad=bad)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out",
                           f"fa_f32_probe_{args.tag}.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print("BAD", bad, flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
