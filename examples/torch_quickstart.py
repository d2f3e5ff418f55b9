"""Quickstart: a Hippo study in a few lines (simulated cluster), in the
PyTorch package.

Defines a search space of learning-rate *sequences* (Figure 10 style) and
submits it to a :class:`StudyService` session on a simulated cluster twice
— trial-based (the Ray Tune baseline) and stage-based (Hippo) — and prints
the savings.  The service is the long-lived entry point; a one-shot study
is a session with a single submission.  The simulator runs no model, so
no device is needed.

    PYTHONPATH=src python examples/torch_quickstart.py [--steps 200] [--workers 8]
"""

import argparse

from repro_torch.core import (Constant, Exponential, MultiStep, SearchPlanDB,
                              SimulatedTrainer, StepLR, StudyService,
                              StudySpec, Warmup, merge_rate)
from repro_torch.core.tuners import GridSearchSpace, GridTuner


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200,
                    help="steps each trial trains")
    ap.add_argument("--workers", type=int, default=8,
                    help="simulated GPUs")
    args = ap.parse_args(argv)
    space = GridSearchSpace(
        fns={
            "lr": [StepLR(0.1, 0.1, [90, 135]),
                   StepLR(0.1, 0.1, [100, 150]),
                   Warmup(5, 0.1, StepLR(0.1, 0.1, [90, 135])),
                   Warmup(5, 0.1, Exponential(0.1, 0.95))],
            "bs": [Constant(128), MultiStep(128, [70], values=[128, 256])],
        },
        static={"wd": [1e-4, 1e-3]},
    )
    trials = space.trials(args.steps)
    print(f"{len(trials)} trials, merge rate p = {merge_rate(trials):.3f}")

    spec = StudySpec("resnet56", "cifar10", ("lr", "bs", "wd"))
    for share, label in ((False, "trial-based (Ray Tune analogue)"),
                         (True, "stage-based (Hippo)")):
        db = SearchPlanDB()
        svc = StudyService(db, SimulatedTrainer(base_seconds_per_step=60),
                           n_workers=args.workers, share=share)
        fut = svc.submit(spec, GridTuner(list(trials)))
        stats = svc.close()
        assert fut.done()
        print(f"{label:35s} GPU-hours {stats.gpu_hours:7.2f}   "
              f"end-to-end {stats.end_to_end / 3600:5.2f} h   "
              f"steps trained {stats.steps_run}")


if __name__ == "__main__":
    main()
