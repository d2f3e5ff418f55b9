"""End-to-end example: a hyper-parameter study of a language model, in PyTorch.

Trains qwen2-0.5b, mamba2-2.7b or recurrentgemma-2b
(``repro_torch.configs``) on a synthetic token stream through the full
Hippo stack — search plan, stage tree,
scheduler, chain-fused execution with write-behind checkpoints, SHA tuner
— once stage-based and once trial-based, over four AdamW learning-rate
schedules that share their first eight steps.  On a CUDA device every
attention call goes through the flash-attention kernels (forward, backward
dq, backward dk/dv), every SSD layer through the SSD kernels (forward,
backward) and every optimizer update through the fused update kernel.

    PYTHONPATH=src python examples/torch_hpo_lm.py --full         # GPU, full width
    PYTHONPATH=src python examples/torch_hpo_lm.py                # GPU, reduced
    PYTHONPATH=src python examples/torch_hpo_lm.py --device cpu   # CPU, reduced
    PYTHONPATH=src python examples/torch_hpo_lm.py --arch mamba2-2.7b \
        --full --layers 32                                        # GPU
    PYTHONPATH=src python examples/torch_hpo_lm.py \
        --arch recurrentgemma-2b --full --layers 5                # GPU

``--full`` is the model at its published width and depth — qwen2-0.5b: 24
layers, d_model 896, 14 / 2 heads, vocab 151,936, bf16, batch 4 × 1024
tokens; mamba2-2.7b: 64 layers, d_model 2560, 80 SSD heads of 64, state
128, chunk 128, vocab 50,280, bf16, batch 1 × 2048 tokens;
recurrentgemma-2b: 26 layers, (RG-LRU, RG-LRU, local attention) × 8 + 2
RG-LRU, d_model and RG-LRU width 2560, 10 / 1 heads of 256, window 2048,
d_ff 7680, vocab 256,000, tied, bf16, batch 1 × 4096 tokens (train_4k's
length, so the window bites) — and ``--layers`` cuts its depth (5 keeps
one cycle and recurrentgemma's two trailing RG-LRU layers); the default
is the ``reduced()`` variant (d_model 256, vocab 512, f32; 2 layers, 3
for recurrentgemma's cycle), batch 4 × 128.  With one worker,
stage-based and trial-based execution report the same metrics bit for bit
and pick the same best trial.  ``--groups`` runs the study over
:func:`group_space`, whose SHA survivors resume together and train as
sibling groups.
"""

import argparse
import dataclasses
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
# (batch, sequence length) of a full-width study
FULL_SHAPE = {"qwen2-0.5b": (4, 1024), "mamba2-2.7b": (1, 2048),
              "recurrentgemma-2b": (1, 4096)}


def space(batch=4):
    return GridSearchSpace(fns={
        "lr": [Constant(3e-4),
               MultiStep(3e-4, [8], values=[3e-4, 1e-4]),
               MultiStep(3e-4, [8], values=[3e-4, 3e-5]),
               MultiStep(3e-4, [12], values=[3e-4, 1e-4])],
        "bs": [Constant(batch)]})


def group_space(batch=4):
    """Four learning rates that part at step 4, SHA's first rung: the
    survivors of each rung resume together from checkpoints and train as
    one sibling group (``batch_siblings``)."""
    return GridSearchSpace(fns={
        "lr": [MultiStep(3e-4, [MIN_STEPS], values=[3e-4, v])
               for v in (6e-4, 1e-4, 3e-5, 1e-5)],
        "bs": [Constant(batch)]})


def make_backend(arch="qwen2-0.5b", reduced=False, batch=4, seq_len=1024,
                 n_train=256, n_eval=8, device=None, use_kernel=None,
                 layers=None):
    """A ``TorchTrainer`` over ``LM(arch)`` with AdamW, ``layers`` deep
    when given.  One draw of the synthetic corpus, split into train and
    eval."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    full = synthetic_lm_dataset(n_train + n_eval, seq_len, cfg.vocab_size,
                                seed=0)
    data = {k: v[:n_train] for k, v in full.items()}
    eval_data = {k: v[n_train:] for k, v in full.items()}
    return TorchTrainer(LM(cfg), lambda: DataPipeline(data, batch_size=batch,
                                                      seed=3),
                        eval_data, default_optimizer="adamw", device=device,
                        use_kernel=use_kernel)


def run_study(backend, share, batch=4, name="qwen2-0.5b",
              batch_siblings=None, space_fn=space, store=None,
              fault_injector=None):
    """One SHA study over ``space_fn`` (:func:`space` or
    :func:`group_space`) on one worker (exact ``steps_run`` needs one);
    ``batch_siblings`` as the engine takes it (None: the backend's
    default, on for a CUDA trainer); ``store`` the checkpoint store (None:
    a fresh memory-tier one); ``fault_injector`` a
    :class:`repro_torch.core.faults.FaultInjector` to run it under.
    Returns ``(stats, tuner, store, wall seconds)``."""
    db = SearchPlanDB()
    study = Study.create(db, name, "synthetic-lm", ("lr", "bs"))
    tuner = RecordingSHATuner(space_fn(batch).trials(MAX_STEPS),
                              min_steps=MIN_STEPS, max_steps=MAX_STEPS,
                              eta=ETA)
    store = CheckpointStore() if store is None else store
    t0 = time.perf_counter()
    stats = study.run(tuner, backend, n_workers=1, share=share, store=store,
                      batch_siblings=batch_siblings,
                      fault_injector=fault_injector)
    return stats, tuner, store, time.perf_counter() - t0


def drop_checkpoints(store):
    """Evict the checkpoints a finished study left in ``store``, so that
    the next run starts without them.  Dropping the name is not enough:
    the tuner's study handle keeps the engine, and with it the store,
    alive, and so does the store's write-behind thread until it retires."""
    for cid in list(store.committed_ids()):
        store.evict(cid)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2-0.5b", choices=sorted(FULL_SHAPE))
    ap.add_argument("--full", action="store_true",
                    help="the published size: qwen2-0.5b batch 4 x 1024, "
                         "mamba2-2.7b batch 1 x 2048, recurrentgemma-2b "
                         "batch 1 x 4096")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the model to this many layers")
    ap.add_argument("--device", default=None,
                    help="'cpu' to ask for the CPU (default: cuda)")
    ap.add_argument("--groups", action="store_true",
                    help="the study over group_space, whose SHA survivors "
                         "train as sibling groups")
    args = ap.parse_args(argv)
    space_fn = group_space if args.groups else space
    batch, seq_len = FULL_SHAPE[args.arch] if args.full else (4, 128)
    cfg = dict(arch=args.arch, reduced=not args.full, batch=batch,
               seq_len=seq_len, layers=args.layers)
    backend = make_backend(device=args.device, **cfg)   # one initial draw
    results = {}
    for share, label in ((True, "stage"), (False, "trial")):
        stats, tuner, store, wall = run_study(backend, share, batch=batch,
                                              name=args.arch,
                                              space_fn=space_fn)
        drop_checkpoints(store)
        results[label] = (stats, tuner.best.trial_id, tuner.history)
        print(f"{label}-based: best val_acc (-loss) {tuner.best_score:.4f}  "
              f"steps trained {stats.steps_run}  wall {wall:.1f}s  "
              f"sibling groups {stats.batched_groups}  "
              f"kernel calls {stats.kernel_calls}  "
              f"fallbacks {stats.kernel_fallbacks}")
        del store, tuner
    s, t = results["stage"], results["trial"]
    print(f"\nstage-based trained {t[0].steps_run / s[0].steps_run:.2f}x "
          f"fewer steps for the same search; same best trial: "
          f"{s[1] == t[1]}; every reported metric bit-equal: {s[2] == t[2]}")
    return results


if __name__ == "__main__":
    main()
