"""Quick check of the bf16 SSD forward (B5) on one GPU.

    python3 tools/ssd_fwd_probe.py

Builds ``src/repro_torch/kernels/csrc/ssd_scan.cu`` with ``nvcc -Xptxas
-v`` and prints each kernel's registers, shared memory and spills, then
runs B5 (``ssd_intra_fwd``) in bf16 on the SSD grid of
``tests/test_kernels.py``, a ragged case and mamba2-2.7b's shape (B 1, nc
16, Q 128, H 80, P 64, N 128) with the model's and with small decays, each
twice (bit-equal), on the tensor cores (``launches_tc``), against the plain
version by the rule of ``chip_smoke.py`` (one bf16 ulp beyond 2^-16 of the
largest value; ``ulps`` <= 1) and within 2e-2, and against the CUDA-core
kernel it replaces (``route="simt"``) within 2e-2; times both routes at
mamba2's shape by CUDA events and by the profiler's device time.  A
shorter first check than ``chip_smoke.py`` for a change to this kernel;
exits non-zero if a case fails.

    python3 tools/ssd_fwd_probe.py --timeline

also builds a copy of the source with ``clock64`` stamps in the kernel
(its text patched in memory at the phases' comments; the stamped library
goes to ``build/cuda/``, the package's own is untouched) and prints, for
the block of the first cell and head group at mamba2's shape, each warp's
cycles (lane 0's) at: the start, the end of the prologue (B, C, cum, dt
in shared memory), cb formed, and per head att formed, x arrived, y =
att·x done, y stored.  The att stamp comes after the warp's registers of
att are pinned, so the compiler cannot move that work across it.
"""
import ctypes
import os
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
import chip_smoke as cs                                    # noqa: E402
from repro_torch.kernels import _cuda                      # noqa: E402
from repro_torch.kernels import ssd_scan as ssk            # noqa: E402

CASES = cs.SSD_SHAPES + [cs.SSD_RAGGED, (1, 2, 128, 12, 64, 128)]
MAMBA = tuple(cs.MAMBA[k] for k in ("B", "nc", "Q", "H", "P", "N"))


def inputs(B, nc, Q, H, P, N, model_decay, seed):
    """x, dt, ltT, B, C on the card as ``chip_smoke.ssd_phase`` draws them
    (bf16; the model's decays or the JAX tests' small ones)."""
    gen = torch.Generator().manual_seed(seed)
    rnd = lambda *shape: torch.randn(shape, generator=gen)
    x, Bm, Cm = rnd(B, nc, Q, H, P), rnd(B, nc, Q, N), rnd(B, nc, Q, N)
    dt = F.softplus(rnd(B, nc, Q, H))
    lt = (dt * -torch.linspace(1.0, 16.0, H)).movedim(-1, -2) \
        if model_decay else -rnd(B, nc, H, Q).abs() * 0.1
    dev, bf = cs.DEV, torch.bfloat16
    return (x.to(dev, bf), dt.to(dev), lt.contiguous().to(dev),
            Bm.to(dev, bf), Cm.to(dev, bf))


def check(args):
    """The case's row: tensor-core launches, bit-equality, finiteness, the
    rule against the plain version and 2e-2 against it and the replaced
    kernel; ``ok`` whether all hold."""
    tc0 = ssk.ssd_intra_fwd.launches_tc
    a, b = (ssk.ssd_intra_fwd(*args) for _ in range(2))
    old = ssk.ssd_intra_fwd(*args, route="simt")
    cum = torch.cumsum(args[2], -1).contiguous()
    want = ssk.fwd_plain(args[0], args[1], cum, args[3], args[4])
    torch.cuda.synchronize()
    ulps = float(cs.bf16_ulps(a, want, float(want.float().abs().max())
                              * 2 ** -16).max())
    e_plain, ok_plain = cs.within(a, want, 2e-2, 2e-2)
    e_old, ok_old = cs.within(a, old, 2e-2, 2e-2)
    row = dict(tc=ssk.ssd_intra_fwd.launches_tc - tc0,
               bit_equal=torch.equal(a, b),
               finite=bool(a.isfinite().all()), ulps=round(ulps, 4),
               err_plain=e_plain, err_simt=e_old,
               scale=float(want.float().abs().max()))
    row["ok"] = (row["tc"] == 2 and row["bit_equal"] and row["finite"]
                 and ulps <= 1.0 and ok_plain and ok_old)
    return row


STAMPS = {   # the kernel's text -> the same with a stamp (at the phase)
    "  extern __shared__ uint8_t smem_raw[];\n":
        "  extern __shared__ uint8_t smem_raw[];\n  STAMP(0);\n",
    "  // cb = C B^T over N in steps of 16":
        "  STAMP(1);\n  // cb = C B^T over N in steps of 16",
    "  reg_fence(cb);\n":
        "  reg_fence(cb);\n  STAMP(2);\n",
    "    // y = att x over j in steps of 16":
        "    for (int t_ = 0; t_ < 8; ++t_)\n"
        "      for (int q_ = 0; q_ < 4; ++q_)\n"
        "        asm volatile(\"\" : \"+r\"(ah[t_][q_]), \"+r\"(al[t_][q_]));\n"
        "    STAMP(3 + 4 * k);\n    // y = att x over j in steps of 16",
    "    const uint32_t x_t = ring_s + st * TILE_B;":
        "    STAMP(4 + 4 * k);\n    const uint32_t x_t = ring_s + st * TILE_B;",
    "    mbar_arrive(bar_s + 8 * (FWD_STAGES + st));":
        "    STAMP(5 + 4 * k);\n    mbar_arrive(bar_s + 8 * (FWD_STAGES + st));",
    "    __syncwarp();                    // the reads are done before the next":
        "    __syncwarp();                    // the reads are done before the next\n"
        "    STAMP(6 + 4 * k);",
}
STAMP_DEF = """
__device__ long long g_stamps[8 * 64];
#define STAMP(n) do { if (blockIdx.x == 0 && blockIdx.y == 0 && \\
    (threadIdx.x & 31) == 0 && (n) < 64) { long long c_; \\
    asm volatile("mov.u64 %0, %%clock64;" : "=l"(c_) :: "memory"); \\
    g_stamps[(threadIdx.x >> 5) * 64 + (n)] = c_; } } while (0)
"""
STAMP_GET = """
extern "C" int ssd_fwd_stamps(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps));
}
"""


def stamped_library():
    """The library built from ssd_scan.cu with STAMPS applied to
    ``ssd_fwd_tc_kernel``'s text (each pattern found once there)."""
    src = open(os.path.join(_cuda.CSRC, "ssd_scan.cu")).read()
    cut = src.index("ssd_fwd_tc_kernel(const __grid_constant__")
    end = src.index("int launch_fwd_tc(")
    body = src[cut:end]
    for old, new in STAMPS.items():
        assert body.count(old) == 1, old
        body = body.replace(old, new)
    head = src[:cut]
    at = head.rindex("constexpr int FWD_STAGES")
    text = head[:at] + STAMP_DEF + head[at:] + body + src[end:] + STAMP_GET
    d = os.path.join(_cuda.BUILD_DIR, "ssd_fwd_stamped")
    os.makedirs(d, exist_ok=True)
    for name in os.listdir(_cuda.CSRC):
        if name.endswith(".cuh"):
            with open(os.path.join(_cuda.CSRC, name)) as f, \
                    open(os.path.join(d, name), "w") as g:
                g.write(f.read())
    with open(os.path.join(d, "ssd_scan.cu"), "w") as f:
        f.write(text)
    so = os.path.join(d, "libssd_scan_stamped.so")
    r = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", so,
                        os.path.join(d, "ssd_scan.cu")],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(r.stderr[-4000:])
    return ctypes.CDLL(so)


def timeline(args):
    """Print each warp's stamps (cycles from the block's first stamp) of
    one launch of the stamped kernel on ``args``."""
    lib = stamped_library()
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    lib.ssd_fwd_tc.argtypes = [P_] * 6 + [I_] * 6 + [I_, P_]
    lib.ssd_fwd_tc.restype = I_
    lib.ssd_fwd_stamps.argtypes = [P_]
    lib.ssd_fwd_stamps.restype = I_
    x, dt, lt, Bm, Cm = args
    cum = torch.cumsum(lt, -1).contiguous()
    y = torch.empty_like(x)
    B, nc, Q, H, P = x.shape
    G = ssk.head_groups(B * nc, H)
    for _ in range(2):                       # the second launch is read
        _cuda.call(lib.ssd_fwd_tc, x.data_ptr(), dt.data_ptr(),
                   cum.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(),
                   1, B * nc, Q, H, P, Bm.shape[-1], G,
                   torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert torch.equal(y, ssk.ssd_intra_fwd(*args))
    buf = (ctypes.c_longlong * (8 * 64))()
    assert lib.ssd_fwd_stamps(buf) == 0
    n = min(64, 3 + 4 * G)
    t0 = min(buf[w * 64] for w in range(8))
    print(dict(timeline="cycles: [start, prologue done, cb formed] + per "
                        "head [att formed, x arrived, y = att x done, y "
                        "stored]", heads=G))
    for w in range(8):
        print(dict(warp=w, cycles=[buf[w * 64 + i] - t0 for i in range(n)]),
              flush=True)


def main():
    if not torch.cuda.is_available():
        print("ssd_fwd_probe: no CUDA device available", file=sys.stderr)
        return 1
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    t0 = time.time()
    out_so = os.path.join(_cuda.BUILD_DIR, "ssd_fwd_probe.so")
    os.makedirs(_cuda.BUILD_DIR, exist_ok=True)
    r = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-Xptxas", "-v",
                        "-o", out_so, os.path.join(_cuda.CSRC,
                                                   "ssd_scan.cu")],
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
    ssk._lib()
    bad = 0
    for n, shape in enumerate(CASES + [MAMBA, MAMBA]):
        model_decay = shape == cs.SSD_RAGGED or n == len(CASES)
        row = check(inputs(*shape, model_decay, seed=n))
        print(dict(shape=list(shape), model_decay=model_decay, **row),
              flush=True)
        bad += not row["ok"]
    args = inputs(*MAMBA, True, seed=99)
    kern = lambda: ssk.ssd_intra_fwd(*args)
    old = lambda: ssk.ssd_intra_fwd(*args, route="simt")
    print(dict(ms=[cs.time_ms(kern), cs.time_ms(kern)],
               device_ms=cs.device_ms(kern, expect="ssd_fwd_tc_kernel"),
               wrapper_host_us=cs.launch_us(kern),
               simt_ms=cs.time_ms(old, reps=10),
               simt_device_ms=cs.device_ms(old, reps=5,
                                           expect="ssd_fwd_simt_kernel")),
          flush=True)
    if "--timeline" in sys.argv[1:]:
        timeline(args)
    print("BAD", bad)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
