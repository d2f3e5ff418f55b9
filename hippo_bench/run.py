"""Run one cell of the port's benchmark; print its result as the last line.

    python3 -m hippo_bench.run --workload qwen2-0.5b-f32.high_merge \
        --seed 7 --seconds 30 --trace 0

From the root of a checkout on a machine with an NVIDIA card.  Set-up
builds the port's kernels (into ``build/`` in the checkout, once), draws
the weights and tokens from ``--seed`` on the card and runs one warm-up
round.  The window then runs rounds of the cell's traffic back to back
— each round the mix's studies submitted upfront to one
``StudyService`` — and closes at the end of the first round that ends
``--seconds`` or more after it opened; its rate is taken over those whole
rounds.  With ``--trace 1`` one more round runs under the profiler, with
spans, after the window, and the per-layer metrics are read from it and
from the window's counters.  Last, the port's answers are held against
the plain reference (:mod:`hippo_bench.check`).

Exits non-zero, printing no result, without a CUDA device, outside a
checkout holding ``src/repro_torch``, or when JAX or the JAX package is
loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "hippo_bench")
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def use_checkout() -> None:
    """The port from this checkout, and every cache of it inside it."""
    src = os.path.join(ROOT, "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(ROOT, "build", "nv")


def benchmark_entry(workload: str):
    """``(cell entry, end-to-end metrics, per-layer metrics)`` of
    ``workload`` in ``BENCHMARK.json``."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = next((w for w in bench["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")

    def mine(ms):
        return [m for m in ms if workload in m.get("workloads", [workload])]
    return cell, mine(bench["end_to_end"]), mine(bench["per_layer"])


def reader(name: str):
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "hippo_bench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run(workload: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", cfg=None, mix=None, limits=None,
        end_to_end=None, per_layer=None, t_start: float = None,
        log=None, fault=None):
    """One run of a cell; returns the result line's object.  ``cfg``,
    ``mix`` and ``limits`` default to the cell's files; ``end_to_end``
    names the end-to-end metrics to report and ``per_layer`` maps the
    per-layer ones to their units (default: all there are).  ``fault``
    plants one of :data:`hippo_bench.faults.FAULTS` under the timed path
    (the benchmark's own tests)."""
    import torch
    from hippo_bench import cells, check, flops, trace as tracing
    from hippo_bench.reference import lm as ref
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    t_start = time.perf_counter() if t_start is None else t_start
    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    t_cell = time.perf_counter()
    cell = cells.Cell(workload, seed, device=device, cfg=cfg, mix=mix)
    log(f"set-up: imports and device {t_cell - t_start:.3f} s, inputs and "
        f"trainer {time.perf_counter() - t_cell:.3f} s")
    if fault is not None:
        from hippo_bench import faults
        faults.plant(cell, fault)
    limits = cells.load_limits(workload) if limits is None else limits
    warm = cell.round()                       # builds kernels, warms up
    sync()
    setup_s = time.perf_counter() - t_start
    log(f"setup {setup_s:.3f} s (warm-up round {warm.seconds:.3f} s, "
        f"{warm.stats.steps_run} steps, {warm.stats.evals_run} evaluations)")

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    rounds, t0 = [], time.perf_counter()
    while True:
        rounds.append(cell.round())
        if time.perf_counter() - t0 >= seconds:
            break
    sync()
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    trial_steps = sum(r.trial_steps for r in rounds)
    log(f"window {window_s:.3f} s: {len(rounds)} rounds, {trial_steps} "
        f"trial-equivalent steps, {sum(r.stats.steps_run for r in rounds)} "
        f"steps run, rounds {[round(r.seconds, 3) for r in rounds]}")

    run_ns = SimpleNamespace(cfg=cell.cfg, mix=cell.mix, rounds=rounds,
                             window_s=window_s, traced=None, trace=None,
                             flops=flops, update_leaves=[
                                 (p.numel(), p.element_size())
                                 for _, p in ref.flat(cell.params).items()])
    if trace:
        from repro_torch.train.checkpoint import CheckpointStore
        run_ns.traced, run_ns.trace = tracing.traced_round(
            cell, CheckpointStore())
        log(f"traced round {run_ns.trace.window_s:.3f} s, device busy "
            f"{run_ns.trace.busy_s:.3f} s, {len(run_ns.trace.events)} "
            f"device activities")
    from repro_torch.kernels.ops import KERNEL_STATS
    log(f"kernel plane: calls {KERNEL_STATS.calls}, fallbacks "
        f"{KERNEL_STATS.fallbacks}")

    # the port's state goes before the reference runs on the card
    cell.params_ref = {p: v.float() for p, v in ref.flat(cell.params).items()}
    cell.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    verdict = check.run_check(cell, rounds)
    correct, shown = check.judge(verdict["numbers"], limits)
    log(f"check: study {verdict['study']}, {verdict['answers']} answers, "
        f"{time.perf_counter() - t_check:.3f} s")

    e2e = {"trial_steps_per_s": (trial_steps / window_s, "steps/s"),
           "peak_mem_gib": (peak / 2 ** 30, "GiB"),
           "setup_s": (setup_s, "s")}
    metrics = {}
    if trace:
        if per_layer is None:
            per_layer = {f[:-3]: "" for f in sorted(os.listdir(
                os.path.join(HERE, "metrics")))
                if f.endswith(".py") and f != "__init__.py"}
        for name, unit in per_layer.items():
            value = reader(name)(run_ns)
            if value is not None:
                metrics[name] = {"value": value, "unit": unit}
    else:
        for name in (end_to_end if end_to_end is not None else e2e):
            value, unit = e2e[name]
            metrics[name] = {"value": value, "unit": unit}
    studies_run = [t for r in rounds for t in r.tuners]
    out = {"correct": correct, "attempted": len(studies_run),
           "failed": sum(not t.is_done() for t in studies_run),
           "metrics": metrics,
           "device": {"platform": "gpu" if on_card else "cpu",
                      "kind": torch.cuda.get_device_name() if on_card
                      else "cpu",
                      "count": 1, "memory_peak_bytes": int(peak)}}
    if trace:
        out["device"].update(busy_s=run_ns.trace.busy_s,
                             window_s=run_ns.trace.window_s)
        out["breakdown"] = {"device_ops": run_ns.trace.top_ops(),
                            "idle_gaps": run_ns.trace.idle_by_host()}
    for name, s in shown.items():
        log(f"check {name}: {s['value']!r} limit {s['limit']!r}")
    out["checks"] = shown
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    use_checkout()
    import torch
    entry, e2e, layers = benchmark_entry(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    print(f"card: {smi[0] if smi else 'nvidia-smi gave nothing'}; torch "
          f"{torch.__version__}", file=sys.stderr)
    out = run(args.workload, args.seed, args.seconds, bool(args.trace),
              end_to_end=[m["name"] for m in e2e],
              per_layer={m["name"]: m["unit"] for m in layers},
              t_start=T_START)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)} (the benchmark "
              f"runs the port alone)", file=sys.stderr)
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
