"""Assigned-architecture registry: ``--arch <id>`` → ModelConfig.

Ten architectures spanning six families (see each module's citation), plus
the four assignment input shapes.  ``long_500k`` policy per DESIGN.md §4:
sub-quadratic archs run it natively; dense/VLM archs run a sliding-window
variant (window 8192); encoder-only (hubert) has no decode at all.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.models.config import ModelConfig

from repro_torch.configs import (granite_34b, grok_1_314b, hubert_xlarge,
                           mamba2_2p7b, qwen2_0p5b, qwen2_moe_a2p7b,
                           qwen2_vl_7b, qwen3_8b, recurrentgemma_2b, yi_34b)

__all__ = ["ARCHS", "SHAPES", "get_config", "list_archs", "shape_applicable",
           "config_for_shape", "InputShape"]

ARCHS: Dict[str, ModelConfig] = {
    c.name: c for c in [
        mamba2_2p7b.CONFIG, yi_34b.CONFIG, recurrentgemma_2b.CONFIG,
        qwen2_vl_7b.CONFIG, grok_1_314b.CONFIG, hubert_xlarge.CONFIG,
        qwen2_0p5b.CONFIG, qwen2_moe_a2p7b.CONFIG, qwen3_8b.CONFIG,
        granite_34b.CONFIG,
    ]
}


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


SHAPES: Dict[str, InputShape] = {
    "train_4k":    InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k":  InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k":   InputShape("long_500k", 524_288, 1, "decode"),
}

_SLIDING_WINDOW_500K = 8_192


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; choose from {sorted(ARCHS)}")
    return ARCHS[arch]


def list_archs() -> List[str]:
    return sorted(ARCHS)


def shape_applicable(cfg: ModelConfig, shape: InputShape) -> bool:
    """Assignment rules: encoder-only archs skip decode; long_500k runs
    only sub-quadratically (natively or via the sliding-window variant)."""
    if shape.kind == "decode" and cfg.is_encoder_only:
        return False
    return True


def config_for_shape(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """The config actually lowered for a shape — applies the sliding-window
    variant that makes ``long_500k`` legitimate for full-attention archs."""
    if (shape.name == "long_500k" and not cfg.subquadratic):
        return dataclasses.replace(cfg, sliding_window=_SLIDING_WINDOW_500K)
    return cfg
