"""Multi-study merging under continuous traffic (§6.2, service plane), in
the PyTorch package.

Teams submit near-identical ResNet20 studies to ONE long-lived
:class:`StudyService` — not upfront, but staggered over (virtual) time, the
way studies arrive at a production cluster.  Late arrivals merge into the
in-flight stage forest; Hippo dedups across them.  Compare against the
same studies run trial-based (salted, zero cross-study reuse).  The
simulator runs no model, so no device is needed.

    PYTHONPATH=src python examples/torch_multi_study.py \
        [--studies 4] [--steps 160] [--workers 40] [--arrival-gap 3600]
"""

import argparse

from repro_torch.core import (Constant, MultiStep, SearchPlanDB,
                              SimulatedTrainer, StepLR, StudyService,
                              StudySpec, Warmup, k_wise_merge_rate)
from repro_torch.core.tuners import GridSearchSpace, GridTuner

SPEC = StudySpec("resnet20", "cifar10", ("lr", "bs"))


def resnet20_space_high_merge(seed: int = 0) -> GridSearchSpace:
    """§6.2 space 1: high intra/inter-study merge — few initial values,
    milestone variations behind long shared prefixes.  A copy of the JAX
    package's ``benchmarks/spaces.py`` space, which imports that
    package."""
    lr = [StepLR(init, 0.1, ms) for init in (0.1, 0.05)
          for ms in ([80, 120], [90, 130], [100, 140])]
    lr += [Warmup(5 + seed % 3, 0.1, StepLR(0.1, 0.1, [80, 120]))]
    bs = [Constant(128), MultiStep(128, [60 + 10 * (seed % 2)],
                                   values=[128, 256])]
    return GridSearchSpace(fns={"lr": lr, "bs": bs},
                           static={"wd": [1e-4, 1e-3, 5e-4]})


def run(share: bool, studies: int, steps: int, workers: int,
        arrival_gap: float):
    db = SearchPlanDB()
    backend = SimulatedTrainer(base_seconds_per_step=60, horizon=steps)
    svc = StudyService(db, backend, n_workers=workers, share=share,
                       policy="fair_share")
    futs = [svc.submit(SPEC, GridTuner(
                resnet20_space_high_merge(seed=i).trials(steps)),
                at=i * arrival_gap)
            for i in range(studies)]
    stats = svc.close()
    assert all(f.done() for f in futs)
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--studies", type=int, default=4)
    ap.add_argument("--steps", type=int, default=160,
                    help="steps each trial trains")
    ap.add_argument("--workers", type=int, default=40,
                    help="simulated GPUs")
    ap.add_argument("--arrival-gap", type=float, default=3600.0,
                    help="virtual seconds between two studies' arrivals")
    args = ap.parse_args(argv)
    S, gap = args.studies, args.arrival_gap
    size = dict(studies=S, steps=args.steps, workers=args.workers,
                arrival_gap=gap)
    sets = [resnet20_space_high_merge(seed=i).trials(args.steps)
            for i in range(S)]
    print(f"{S} studies arriving {gap / 3600:.0f}h apart, "
          f"{sum(map(len, sets))} trials total, "
          f"k-wise merge rate q = {k_wise_merge_rate(sets):.2f}")
    trial = run(share=False, **size)
    stage = run(share=True, **size)
    print(f"trial-based: {trial.gpu_hours:8.1f} GPU-h   "
          f"e2e {trial.end_to_end/3600:6.2f} h")
    print(f"stage-based: {stage.gpu_hours:8.1f} GPU-h   "
          f"e2e {stage.end_to_end/3600:6.2f} h")
    print(f"savings: {trial.gpu_seconds/stage.gpu_seconds:.2f}x GPU-hours, "
          f"{trial.end_to_end/stage.end_to_end:.2f}x end-to-end")
    print("\nper-study split-credited execution (stage-based):")
    for sid, ss in sorted(stage.by_study.items()):
        print(f"  {sid}: {ss.gpu_seconds/3600:7.1f} GPU-h  "
              f"{ss.steps_run:6d} steps served  "
              f"{ss.instant_results:3d} instant results")


if __name__ == "__main__":
    main()
