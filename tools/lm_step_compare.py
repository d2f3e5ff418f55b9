"""qwen2-0.5b's training step and device profile for one tree of the repo.

    python3 tools/lm_step_compare.py <tree> <label>

Runs ``chip_smoke.step_profile`` of the checkout at ``<tree>`` (its own
``src/``, ``examples/`` and ``chip_smoke.py``, its own kernel build) on
qwen2-0.5b at full width, batch 4 × 1024 tokens, AdamW: the step by the
host clock over a 4-step chunk, the loss's forward + backward alone, the
update alone, and the device's busy and idle share over one 4-step chunk
with the top device time by kernel name and the attention kernels' device
time (names with ``::fa_``).  Prints phases ``<label>_lm_step`` and
``<label>_lm_profile``.  To compare two commits on one card, unpack the
other one into a git-ignored directory (``git archive``) and run both in
one call, parent, change, change, parent::

    for t in "build/parent parent_a" ". change_a" ". change_b" \\
             "build/parent parent_b"; do
        set -- $t; python3 tools/lm_step_compare.py $1 $2; done
"""
import json
import os
import sys
import time

tree, label = os.path.abspath(sys.argv[1]), sys.argv[2]
sys.path[:0] = [os.path.join(tree, "src"), os.path.join(tree, "examples"),
                tree]
import chip_smoke as cs                                   # noqa: E402
import torch_hpo_lm as lm_example                         # noqa: E402
from repro_torch.configs import get_config                # noqa: E402

assert os.path.dirname(os.path.abspath(cs.__file__)) == tree, cs.__file__
print(json.dumps({"tree": label, "path": tree}), flush=True)
t0 = time.perf_counter()
cs.start_builds()("flash_attention")
print(json.dumps({"tree": label, "build_s": time.perf_counter() - t0}),
      flush=True)
backend = lm_example.make_backend(use_kernel=True, **cs.LM_FULL)
cs.step_profile(f"{label}_lm_", get_config("qwen2-0.5b").name, backend,
                "adamw", 3e-4, n_chunk=4, profile_steps=4,
                tokens=cs.LM_FULL["batch"] * cs.LM_FULL["seq_len"],
                # the profile picks the attention kernels out by name; their
                # per-step time by events is not measured here (0.0)
                port=("attention_not_timed_here", 0.0, "::fa_"))
