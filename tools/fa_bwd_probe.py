"""Quick check of the bf16 flash-attention backward on one GPU.

    python3 tools/fa_bwd_probe.py

Builds ``src/repro_torch/kernels/csrc/flash_attention.cu`` with ``nvcc
-Xptxas -v`` and prints each tensor-core kernel's registers and spills,
then runs B3 / B4 (``fa_bwd_dq_tc`` / ``fa_bwd_dkv_tc``) on a few bf16
shapes — the attention grid's, ragged and odd head dims, qwen2-0.5b's and
qwen3-8b's training attention — each twice (bit-equal), against the plain
versions by the rounding rule of ``chip_smoke.py`` (``max_err_over_allowed``
≤ 1) and within 2e-2, and times them at the two main shapes beside the
library's flash backward (CUDA events, two readings each).  A shorter
first check than ``chip_smoke.py`` for a change to these kernels; exits
non-zero if a case fails.
"""
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))
from repro_torch.kernels import _cuda                      # noqa: E402
from repro_torch.kernels import flash_attention as fa      # noqa: E402

CASES = [((1, 128, 4, 4, 64), True, 0), ((2, 128, 8, 2, 64), False, 0),
         ((1, 256, 8, 1, 32), True, 48), ((1, 96, 4, 2, 64), True, 0),
         ((1, 96, 4, 2, 64), False, 0), ((2, 64, 2, 1, 128), True, 48),
         ((1, 200, 2, 2, 80), False, 0), ((1, 300, 4, 2, 128), True, 100),
         ((4, 1024, 14, 2, 64), True, 0), ((1, 2048, 32, 8, 128), True, 0)]


def rule(a, ref, env):
    """max |a - ref| / (2^-16 scale + 1 bf16 ulp + 2^-8 env)."""
    diff = (a.float() - ref).abs()
    scale = float(ref.abs().max())
    _, e = torch.frexp(torch.maximum(a.float().abs(), ref.abs()))
    ulp = torch.ldexp(torch.ones_like(diff), e - 8)
    return float((diff / (scale * 2 ** -16 + ulp + 2 ** -8 * env)).max())


def refs(q, k, v, do, lse, delta, mk):
    """{name: (the f32 plain output, env)} on the inputs cast to f32."""
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    p, ds = fa._probs_and_ds(qf, kf, vf, lse, delta, dof, mk["causal"],
                             mk["window"])
    g = q.shape[2] // k.shape[2]
    kh, qh, doh = fa._heads(kf, g), fa._heads(qf), fa._heads(dof)
    perm = lambda x: x.permute(0, 2, 1, 3)
    return {"dq": (perm(ds @ kh), perm(ds.abs() @ kh.abs())),
            "dk_h": (perm(ds.transpose(-1, -2) @ qh),
                     perm(ds.abs().transpose(-1, -2) @ qh.abs())),
            "dv_h": (perm(p.transpose(-1, -2) @ doh),
                     perm(p.transpose(-1, -2) @ doh.abs()))}


def tms(f, reps=30):
    for _ in range(5):
        f()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(True), torch.cuda.Event(True)
    e0.record()
    for _ in range(reps):
        f()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def main():
    if not torch.cuda.is_available():
        print("fa_bwd_probe: no CUDA device available", file=sys.stderr)
        return 1
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    t0 = time.time()
    out_so = os.path.join(_cuda.BUILD_DIR, "fa_bwd_probe.so")
    os.makedirs(_cuda.BUILD_DIR, exist_ok=True)
    r = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-Xptxas", "-v",
                        "-o", out_so,
                        os.path.join(_cuda.CSRC, "flash_attention.cu")],
                       capture_output=True, text=True)
    print("nvcc rc", r.returncode, "s", round(time.time() - t0, 1))
    lines = r.stderr.splitlines()
    for i, line in enumerate(lines):
        if "error" in line.lower() or "warning" in line.lower() or any(
                "_tc_" in x for x in lines[max(0, i - 2):i + 1]):
            print(line[:300])
    if r.returncode:
        print(r.stderr[-6000:])
        return 1
    fa._lib()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    bad = 0
    for (B, S, Hq, Hkv, hd), causal, window in CASES:
        q, k, v, do = (torch.randn(s, generator=gen).to(dev, torch.bfloat16)
                       for s in ((B, S, Hq, hd), (B, S, Hkv, hd),
                                 (B, S, Hkv, hd), (B, S, Hq, hd)))
        mk = dict(causal=causal, window=window)
        out, lse = fa.flash_attention_fwd(q, k, v, return_lse=True, **mk)
        delta = (do.float() * out.float()).sum(-1).transpose(
            1, 2).contiguous()
        wrappers = (fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
        n0 = [w.launches_tc for w in wrappers]
        got = [(fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **mk),)
               + fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **mk)
               for _ in range(2)]
        torch.cuda.synchronize()
        row = dict(shape=[B, S, Hq, Hkv, hd], causal=causal, window=window,
                   tc=[w.launches_tc - n for w, n in zip(wrappers, n0)],
                   bit_equal=all(torch.equal(a, b) for a, b in zip(*got)))
        plain = {"dq": fa.bwd_dq_plain(q, k, v, do, lse, delta, **mk)}
        plain["dk_h"], plain["dv_h"] = fa.bwd_dkv_plain(q, k, v, do, lse,
                                                        delta, **mk)
        ref = refs(q, k, v, do, lse, delta, mk)
        for name, a in zip(("dq", "dk_h", "dv_h"), got[0]):
            b = plain[name]
            ok2 = bool(((a.float() - b.float()).abs()
                        <= 2e-2 + 2e-2 * b.float().abs()).all())
            row[name] = dict(rule=round(rule(a, *ref[name]), 4),
                             err=float((a.float() - ref[name][0]).abs().max()),
                             scale=float(ref[name][0].abs().max()),
                             ok2e2=ok2, finite=bool(a.isfinite().all()))
            bad += not (row[name]["rule"] <= 1 and ok2
                        and row[name]["finite"])
        bad += not row["bit_equal"] or row["tc"] != [2, 2]
        del ref, plain
        if S >= 1024:
            qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
            ke, ve = (x.repeat_interleave(Hq // Hkv, dim=1) for x in (kt, vt))
            res = torch.ops.aten._scaled_dot_product_flash_attention(
                qt, ke, ve, 0.0, True, False)
            lib = lambda: \
                torch.ops.aten._scaled_dot_product_flash_attention_backward(
                    dot, qt, ke, ve, res[0], res[1], res[2], res[3], res[4],
                    res[5], 0.0, True, res[6], res[7])
            fdq = lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                                    **mk)
            fdkv = lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse,
                                                      delta, **mk)
            row["ms"] = dict(dq=[tms(fdq), tms(fdq)],
                             dkv=[tms(fdkv), tms(fdkv)],
                             lib=[tms(lib), tms(lib)])
        print(row, flush=True)
    print("BAD", bad)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
