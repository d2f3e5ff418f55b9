"""Cells cut to a size a CPU test run holds: the files' widths shrunk,
float32, short sequences.  Used by the benchmark's own tests only."""

from __future__ import annotations

from hippo_bench import cells

SMALL = {
    "attention": {"hidden_size": 128, "num_attention_heads": 2,
                  "num_key_value_heads": 1, "intermediate_size": 256,
                  "num_hidden_layers": 2, "vocab_size": 256},
    "ssd": {"d_model": 64, "d_state": 16, "chunk_size": 16, "n_layer": 2,
            "vocab_size": 256},
}


def small_config(name: str, seq_len: int = 32, batch: int = 2):
    """``configs/<name>.json`` at small widths, in float32."""
    cfg = dict(cells.load_config(name))
    cfg.update(SMALL[cfg["block"]], torch_dtype="float32", seq_len=seq_len,
               batch=batch, n_train=16 * batch, n_eval=batch)
    return cfg


# limits at this size, in float32, ~10x what the port reads off the
# reference (eval 5e-7 nats, update 1.5e-5, grad_rms 5e-6 of a leaf's
# norm); the TF32 control reads 1.5e-5, 6e-4 and 1.2e-4 and more, the
# faults 1e-2 and more
SMALL_LIMITS = {"eval_loss_gap": {"limit": 5e-6}, "best_gap": {"limit": 5e-6},
                "update_gap": {"limit": 2e-4}, "grad_rms_gap": {"limit": 5e-5}}
