"""Stand-ins for every model input: ``torch.device("meta")`` tensors.

``input_specs`` mirrors what the data pipeline / serving frontend would
feed each step: token ids for LM training, patch/frame embeddings for the
vision / audio frontends, (cache, token, index) for decode.  Meta tensors
carry a shape and a dtype and allocate nothing, so the sharding rules
(:mod:`repro_torch.dist.sharding`) read them as they read real batches.
Token ids and the decode index are int64, the dtype the port's pipelines
upload (the reference's are int32).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs import InputShape
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import LM

__all__ = ["input_specs", "batch_struct"]


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_struct(cfg: ModelConfig, batch: int, seq: int) -> Dict[str, Any]:
    """Training/prefill batch for one global step."""
    act = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    if cfg.frontend == "audio":
        return {"features": _meta((batch, seq, cfg.frontend_dim), act),
                "labels": _meta((batch, seq), torch.int64)}
    if cfg.frontend == "vision":
        P = cfg.frontend_tokens
        if seq <= P:
            raise ValueError(f"seq {seq} leaves no text after {P} patches")
        return {"tokens": _meta((batch, seq - P), torch.int64),
                "patches": _meta((batch, P, cfg.frontend_dim), act),
                "positions": _meta((3, batch, seq), torch.int64)}
    return {"tokens": _meta((batch, seq), torch.int64)}


def input_specs(cfg: ModelConfig, shape: InputShape
                ) -> Tuple[str, Dict[str, Any]]:
    """Returns (step kind, kwargs structs) for the shape's step.

    * train_4k              → ``train_step(params, opt, batch, lr, step)``
    * prefill_32k           → ``prefill_step(params, batch)``
    * decode_32k / long_500k → ``serve_step(params, cache, tokens, index)``,
      the cache ``LM.init_cache``'s tree (an encoder-only model's too, as
      the reference gives; ``shape_applicable`` rules that shape out)."""
    if shape.kind in ("train", "prefill"):
        return shape.kind, {
            "batch": batch_struct(cfg, shape.global_batch, shape.seq_len)}
    cache = LM(cfg).init_cache(shape.global_batch, shape.seq_len,
                               device="meta")
    return "decode", {"cache": cache,
                      "tokens": _meta((shape.global_batch, 1), torch.int64),
                      "index": _meta((), torch.int64)}
