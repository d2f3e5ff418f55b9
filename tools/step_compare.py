"""One model's training step and device profile for one tree of the repo.

    python3 tools/step_compare.py <tree> <label> <resnet56|mamba2>

Runs ``chip_smoke.step_profile`` of the checkout at ``<tree>`` (its own
``src/``, ``examples/`` and ``chip_smoke.py``, its own kernel builds) on
ResNet56 (``ResNet(n=9, width=16)``, batch 128, momentum, an 8-step chunk)
or on the full 64-layer mamba2-2.7b (1 × 2048 tokens, AdamW, a 4-step
chunk): the step by the host clock, the loss's forward + backward alone,
the optimizer update alone on CUDA events, the peak device memory, and the
device's busy and idle share over one chunk (8 steps for ResNet56, 2 for
mamba2) with its launches per step and top device time by kernel name (the
SSD kernels' share for mamba2: names with ``::ssd_``).  Prints phases
``<label>_step`` and ``<label>_profile``.  To compare two commits on one
card, unpack the other one into a git-ignored directory (``git archive``)
and run both in one call, parent, change, change, parent::

    for m in resnet56 mamba2; do
      for t in "build/parent parent_a" ". change_a" ". change_b" \\
               "build/parent parent_b"; do
        set -- $t; python3 tools/step_compare.py $1 ${m}_$2 $m; done; done
"""
import json
import os
import sys
import time

tree, label, model = os.path.abspath(sys.argv[1]), sys.argv[2], sys.argv[3]
if model not in ("resnet56", "mamba2"):
    sys.exit(f"step_compare: unknown model {model!r} (resnet56 | mamba2)")
sys.path[:0] = [os.path.join(tree, "src"), os.path.join(tree, "examples"),
                tree]
import chip_smoke as cs                                   # noqa: E402

assert os.path.dirname(os.path.abspath(cs.__file__)) == tree, cs.__file__
print(json.dumps({"tree": label, "path": tree, "model": model}), flush=True)
t0 = time.perf_counter()
join = cs.start_builds()
for name in cs.CUDA_SOURCES:
    join(name)
print(json.dumps({"tree": label, "build_s": time.perf_counter() - t0}),
      flush=True)
if model == "resnet56":
    import torch_hpo_resnet as example                    # noqa: E402
    backend = example.make_backend(use_kernel=True, **cs.RESNET_FULL)
    cs.step_profile(f"{label}_", "ResNet(n=9, width=16)", backend,
                    "momentum", 0.05, n_chunk=8, profile_steps=8)
else:
    import torch_hpo_lm as lm_example                     # noqa: E402
    backend = lm_example.make_backend(arch="mamba2-2.7b", use_kernel=True,
                                      batch=1, seq_len=2048, n_train=8,
                                      n_eval=1)
    assert backend.task.cfg.num_layers == 64
    cs.step_profile(f"{label}_", backend.task.cfg.name, backend, "adamw",
                    3e-4, n_chunk=4, profile_steps=2, tokens=2048,
                    # the profile picks the SSD kernels out by name; their
                    # per-step time by events is not measured here (0.0)
                    port=("ssd_not_timed_here", 0.0, "::ssd_"))
