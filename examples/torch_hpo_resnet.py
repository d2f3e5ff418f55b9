"""End-to-end example: a REAL hyper-parameter optimization study, in PyTorch.

The counterpart of ``examples/hpo_resnet.py`` on the ``repro_torch``
package: trains a CIFAR-shaped ResNet through the full Hippo stack — search
plan, stage tree, critical-path scheduler, chain-fused execution with
write-behind checkpoints, SHA tuner — once stage-based and once trial-based,
and compares the steps each had to train.

Runs on a CUDA device (the optimizer update goes through the fused
update kernel); ``--device cpu`` asks for the CPU and the plain update.
``--groups`` runs the study over :func:`group_space`, whose SHA survivors
resume together and train as sibling groups — one batched call per group,
vectorised over the members on a CUDA device.

    PYTHONPATH=src python examples/torch_hpo_resnet.py            # ResNet8
    PYTHONPATH=src python examples/torch_hpo_resnet.py --full     # ResNet56

Training is deterministic on one device and the tuner breaks ties by a
trial's position in the search space, so stage-based and trial-based
execution report the same metrics bit for bit and pick the same best trial.
"""

import argparse
import time

from repro_torch.core import (Constant, MultiStep, SearchPlanDB, Study,
                              merge_rate)
from repro_torch.core.tuners import GridSearchSpace, SHATuner
from repro_torch.data import DataPipeline, synthetic_cifar
from repro_torch.models.resnet import ResNet
from repro_torch.train.checkpoint import CheckpointStore
from repro_torch.train.torch_trainer import TorchTrainer

STEPS = 100


def space(batch=64):
    return GridSearchSpace(fns={
        "lr": [Constant(0.05),
               MultiStep(0.05, [40], values=[0.05, 0.005]),
               MultiStep(0.05, [40], values=[0.05, 0.02]),
               MultiStep(0.05, [60], values=[0.05, 0.005]),
               MultiStep(0.05, [60, 80], values=[0.05, 0.02, 0.002]),
               MultiStep(0.05, [80], values=[0.05, 0.01])],
        "bs": [Constant(batch)]})


def group_space(batch=64):
    """Six learning rates that part at step 25, SHA's first rung: the
    survivors of each rung resume together from checkpoints and train as
    one sibling group (``batch_siblings``)."""
    return GridSearchSpace(fns={
        "lr": [MultiStep(0.05, [25], values=[0.05, v])
               for v in (0.1, 0.03, 0.02, 0.01, 0.005, 0.002)],
        "bs": [Constant(batch)]})


def make_backend(n=1, width=16, n_train=2048, n_eval=512, batch=64,
                 device=None, use_kernel=None):
    # one draw, split: a second seed would draw other class prototypes,
    # and the eval set would measure chance
    full = synthetic_cifar(n_train + n_eval, seed=0)
    data = {k: v[:n_train] for k, v in full.items()}
    eval_data = {k: v[n_train:] for k, v in full.items()}
    return TorchTrainer(ResNet(n=n, width=width),
                        lambda: DataPipeline(data, batch_size=batch, seed=3),
                        eval_data, default_optimizer="momentum",
                        device=device, use_kernel=use_kernel)


class RecordingSHATuner(SHATuner):
    """SHA that keeps every ``(trial_id, step) -> metrics`` it was told, so
    two runs of one study can be compared result for result."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.history = {}

    def on_result(self, trial, step, metrics):
        self.history[(trial.trial_id, step)] = dict(metrics)
        super().on_result(trial, step, metrics)


def run_study(backend, share, batch=64, n_workers=2, name="resnet8",
              batch_siblings=None, space_fn=space, store=None,
              fault_injector=None):
    """One SHA study over ``space_fn`` (:func:`space` or
    :func:`group_space`); ``batch_siblings`` as the engine takes it (None:
    the backend's default, on for a CUDA trainer); ``store`` the
    checkpoint store (None: a fresh memory-tier one); ``fault_injector``
    a :class:`repro_torch.core.faults.FaultInjector` to run it under.
    Returns ``(stats, tuner, store, wall seconds)``."""
    db = SearchPlanDB()
    study = Study.create(db, name, "synthetic-cifar", ("lr", "bs"))
    tuner = RecordingSHATuner(space_fn(batch).trials(STEPS), min_steps=25,
                              max_steps=STEPS, eta=2)
    store = CheckpointStore() if store is None else store
    t0 = time.perf_counter()
    stats = study.run(tuner, backend, n_workers=n_workers, share=share,
                      store=store, batch_siblings=batch_siblings,
                      fault_injector=fault_injector)
    return stats, tuner, store, time.perf_counter() - t0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true",
                    help="the paper's ResNet56 = ResNet(n=9, width=16), "
                         "8192 samples, batch 128")
    ap.add_argument("--device", default=None,
                    help="'cpu' to ask for the CPU (default: cuda)")
    ap.add_argument("--groups", action="store_true",
                    help="the study over group_space, whose SHA survivors "
                         "train as sibling groups")
    args = ap.parse_args()
    cfg = (dict(n=9, n_train=8192, batch=128) if args.full
           else dict(n=1, n_train=2048, batch=64))
    name = "resnet56" if args.full else "resnet8"
    space_fn = group_space if args.groups else space

    trials = space_fn(cfg["batch"]).trials(STEPS)
    print(f"{len(trials)} trials × {STEPS} steps, "
          f"p = {merge_rate(trials):.2f}")
    results = {}
    for share, label in ((True, "stage"), (False, "trial")):
        backend = make_backend(device=args.device, **cfg)
        stats, tuner, _, wall = run_study(backend, share, cfg["batch"],
                                          name=name, space_fn=space_fn)
        results[label] = (stats, tuner)
        print(f"{label}-based: best val_acc {tuner.best_score:.4f}  "
              f"steps trained {stats.steps_run}  wall {wall:.1f}s  "
              f"sibling groups {stats.batched_groups}  "
              f"kernel calls {stats.kernel_calls}  "
              f"fallbacks {stats.kernel_fallbacks}")
    s, t = results["stage"], results["trial"]
    print(f"\nstage-based trained {t[0].steps_run / s[0].steps_run:.2f}x "
          f"fewer steps for the same search; same best trial: "
          f"{s[1].best.trial_id == t[1].best.trial_id}")


if __name__ == "__main__":
    main()
