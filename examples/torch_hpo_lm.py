"""End-to-end example: a hyper-parameter study of a language model, in PyTorch.

Trains qwen2-0.5b (``repro_torch.configs``) on a synthetic token stream
through the full Hippo stack — search plan, stage tree, scheduler,
chain-fused execution with write-behind checkpoints, SHA tuner — once
stage-based and once trial-based, over four AdamW learning-rate schedules
that share their first eight steps.  On a CUDA device every attention call
goes through the flash-attention kernels (forward, backward dq, backward
dk/dv) and every optimizer update through the fused update kernel.

    PYTHONPATH=src python examples/torch_hpo_lm.py --full         # GPU, full width
    PYTHONPATH=src python examples/torch_hpo_lm.py                # GPU, reduced
    PYTHONPATH=src python examples/torch_hpo_lm.py --device cpu   # CPU, reduced

``--full`` is qwen2-0.5b at its published width and depth (24 layers, d_model
896, 14 / 2 heads, vocab 151,936, bf16), batch 4 × 1024 tokens; the default
is its ``reduced()`` variant (2 layers, d_model 256, vocab 512, f32), batch
4 × 128.  With one worker, stage-based and trial-based execution report the
same metrics bit for bit and pick the same best trial.
"""

import argparse
import time

from torch_hpo_resnet import RecordingSHATuner

from repro_torch.configs import get_config
from repro_torch.core import Constant, MultiStep, SearchPlanDB, Study
from repro_torch.core.tuners import GridSearchSpace
from repro_torch.data import DataPipeline, synthetic_lm_dataset
from repro_torch.models.transformer import LM
from repro_torch.train.checkpoint import CheckpointStore
from repro_torch.train.torch_trainer import TorchTrainer

MIN_STEPS, MAX_STEPS, ETA = 4, 16, 2


def space(batch=4):
    return GridSearchSpace(fns={
        "lr": [Constant(3e-4),
               MultiStep(3e-4, [8], values=[3e-4, 1e-4]),
               MultiStep(3e-4, [8], values=[3e-4, 3e-5]),
               MultiStep(3e-4, [12], values=[3e-4, 1e-4])],
        "bs": [Constant(batch)]})


def make_backend(arch="qwen2-0.5b", reduced=False, batch=4, seq_len=1024,
                 n_train=256, n_eval=8, device=None, use_kernel=None):
    """A ``TorchTrainer`` over ``LM(arch)`` with AdamW.  One draw of the
    synthetic corpus, split into train and eval."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    full = synthetic_lm_dataset(n_train + n_eval, seq_len, cfg.vocab_size,
                                seed=0)
    data = {k: v[:n_train] for k, v in full.items()}
    eval_data = {k: v[n_train:] for k, v in full.items()}
    return TorchTrainer(LM(cfg), lambda: DataPipeline(data, batch_size=batch,
                                                      seed=3),
                        eval_data, default_optimizer="adamw", device=device,
                        use_kernel=use_kernel)


def run_study(backend, share, batch=4, name="qwen2-0.5b"):
    """One SHA study over :func:`space` on one worker (exact ``steps_run``
    needs one); returns ``(stats, tuner, store, wall seconds)``."""
    db = SearchPlanDB()
    study = Study.create(db, name, "synthetic-lm", ("lr", "bs"))
    tuner = RecordingSHATuner(space(batch).trials(MAX_STEPS),
                              min_steps=MIN_STEPS, max_steps=MAX_STEPS,
                              eta=ETA)
    store = CheckpointStore()
    t0 = time.perf_counter()
    stats = study.run(tuner, backend, n_workers=1, share=share, store=store)
    return stats, tuner, store, time.perf_counter() - t0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true",
                    help="qwen2-0.5b at its published size, batch 4 x 1024")
    ap.add_argument("--device", default=None,
                    help="'cpu' to ask for the CPU (default: cuda)")
    args = ap.parse_args()
    cfg = dict(reduced=not args.full, seq_len=1024 if args.full else 128)
    results = {}
    for share, label in ((True, "stage"), (False, "trial")):
        backend = make_backend(device=args.device, **cfg)
        stats, tuner, store, wall = run_study(backend, share)
        del store        # drop one run's checkpoints before the next starts
        results[label] = (stats, tuner)
        print(f"{label}-based: best val_acc (-loss) {tuner.best_score:.4f}  "
              f"steps trained {stats.steps_run}  wall {wall:.1f}s  "
              f"kernel calls {stats.kernel_calls}  "
              f"fallbacks {stats.kernel_fallbacks}")
    s, t = results["stage"], results["trial"]
    print(f"\nstage-based trained {t[0].steps_run / s[0].steps_run:.2f}x "
          f"fewer steps for the same search; same best trial: "
          f"{s[1].best.trial_id == t[1].best.trial_id}; every reported "
          f"metric bit-equal: {s[1].history == t[1].history}")


if __name__ == "__main__":
    main()
