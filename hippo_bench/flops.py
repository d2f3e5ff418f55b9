"""The yardstick's arithmetic: model FLOPs for ``train.step_mfu`` and the
operations and bytes of kernels B1–B6 for their rooflines.

The kernels' counts are copied from ``chip_smoke.py``'s bound formulas
(PERF.md's kernel table, "bound" column): each input read once and each
output written once, operations as the function needs them, bytes at the
operands' element size.  The peaks are NVIDIA's data sheet for one H100
SXM: dense bf16 on the tensor cores, float32 on the CUDA cores (the
port's float32 routes, TF32 off), HBM3; a share is stated against them
with the card's power limit beside it.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

BF16_FLOP_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12
FLOP_PER_S = {"bfloat16": BF16_FLOP_PER_S, "float32": 67e12}
ELEMENT = {"bfloat16": 2, "float32": 4}


def bound_s(flops: float, nbytes: float, dtype: str = "bfloat16") -> float:
    """The least time the chip could take: operations or bytes."""
    return max(flops / FLOP_PER_S[dtype], nbytes / HBM_BYTES_PER_S)


# ----------------------------------------------------------- B2, B3, B4
def live_pairs(S: int, causal: bool = True, window: int = 0) -> int:
    """The (query, key) pairs a mask keeps over S positions."""
    total = 0
    for q in range(S):
        hi = q if causal else S - 1
        lo = max(0, q - window + 1) if window > 0 else 0
        total += max(0, hi - lo + 1)
    return total


def attention_work(B: int, S: int, Hq: int, Hkv: int, hd: int,
                   causal: bool = True, window: int = 0, e: int = 2
                   ) -> Dict[str, Tuple[float, float]]:
    """``{"B2" | "B3" | "B4": (flops, bytes)}`` of one call, q / k / v /
    out and their cotangents ``e`` bytes an element (the lse and the row
    sums in f32).  B3 alone recomputes s and dp and forms ds·K (1.5 × the
    forward's products); B4 recomputes them and forms dsᵀ·Q and pᵀ·dO
    (2 ×)."""
    fwd = 4.0 * B * Hq * hd * live_pairs(S, causal, window)
    n_q, n_kv, n_row = B * S * Hq * hd, B * S * Hkv * hd, B * Hq * S
    return {"B2": (fwd, e * 2 * B * S * (Hq + Hkv) * hd + 4 * n_row),
            "B3": (1.5 * fwd, e * (3 * n_q + 2 * n_kv) + 4 * 2 * n_row),
            "B4": (2.0 * fwd, e * (4 * n_q + 2 * n_kv) + 4 * 2 * n_row)}


# ------------------------------------------------------------- B5, B6
def ssd_work(B: int, nc: int, Q: int, H: int, P: int, N: int, e_x: int = 2
             ) -> Dict[str, Tuple[float, float]]:
    """``{"B5" | "B6": (flops, bytes)}`` of one call over ``B * nc``
    chunks.  Flops over the Q(Q+1)/2 pairs j <= i; cb = C·Bᵀ formed once
    per chunk.  B5 per chunk: cb, 2TN; per head y = att·x, 2TP, and seg,
    exp, ·dt, ·cb, 4T.  B6 per chunk: cb, 2TN, and dB, dC, 4TN; per head
    datt and dx, 4TP, and 12T of elementwise work.  Bytes at the tensors'
    dtypes (``e_x`` for x, B, C and their cotangents, 4 for the rows)."""
    T, cells = Q * (Q + 1) // 2, B * nc
    n_x, n_row, n_bc = cells * Q * H * P, cells * Q * H, cells * Q * N
    return {"B5": (cells * (2 * T * N + H * (2 * T * P + 4 * T)),
                   e_x * (2 * n_x + 2 * n_bc) + 4 * 2 * n_row),
            "B6": (cells * (6 * T * N + H * (4 * T * P + 12 * T)),
                   e_x * (3 * n_x + 4 * n_bc) + 4 * 4 * n_row)}


# ------------------------------------------------------------------ B1
SLOTS = {"sgd": 0, "momentum": 1, "adam": 2, "adamw": 2}


def update_bytes(leaves, optimizer: str = "adamw") -> int:
    """Bytes of one optimizer update over a tree: each leaf's parameter,
    gradient and slots read, its parameter and slots written, at the
    leaf's dtype.  ``leaves`` are ``(numel, itemsize)`` pairs."""
    k = SLOTS[optimizer]
    return sum((2 + k + 1 + k) * n * size for n, size in leaves)


# --------------------------------------------------------- model FLOPs
def _layers(cfg: Dict[str, Any]) -> int:
    return int(cfg.get("num_hidden_layers", cfg.get("n_layer")))


def matrix_params(cfg: Dict[str, Any]) -> int:
    """Parameters that a token multiplies: every layer's matrices and the
    tied output head (the embedding's gather is no product)."""
    L = _layers(cfg)
    if cfg["block"] == "attention":
        D, H, KV = (cfg["hidden_size"], cfg["num_attention_heads"],
                    cfg["num_key_value_heads"])
        hd, F = D // H, cfg["intermediate_size"]
        per = D * H * hd + 2 * D * KV * hd + H * hd * D + 3 * D * F
    elif cfg["block"] == "ssd":
        D, N = cfg["d_model"], cfg["d_state"]
        inner = cfg["expand"] * D
        H = inner // cfg["headdim"]
        per = D * (2 * inner + 2 * N + H) + inner * D
    else:
        raise ValueError(f"unknown block {cfg['block']!r}")
    return L * per + cfg["vocab_size"] * D


def mixer_flops_per_token(cfg: Dict[str, Any], seq_len: int) -> float:
    """Forward products per token beyond the matrices: causal attention's
    q·kᵀ and p·v (2 · d_attn · S/2 each), or SSD's chunked scan (C·Bᵀ and
    att·x over the pairs of a chunk, the chunk states and the inter-chunk
    output)."""
    L = _layers(cfg)
    if cfg["block"] == "attention":
        d_attn = cfg["hidden_size"]
        return L * 4.0 * d_attn * seq_len / 2
    D, N, P, Q = cfg["d_model"], cfg["d_state"], cfg["headdim"], \
        cfg["chunk_size"]
    H = cfg["expand"] * D // P
    T = Q * (Q + 1) // 2
    return L * ((2 * T * N + H * 2 * T * P) / Q + 4 * H * P * N)


def train_flops(cfg: Dict[str, Any], batch: int, seq_len: int) -> float:
    """Model FLOPs of one training step: forward and backward, 3 × the
    forward's 2 · N · tokens and the mixer's products."""
    tokens = batch * seq_len
    return 3.0 * tokens * (2.0 * matrix_params(cfg)
                           + mixer_flops_per_token(cfg, seq_len))


def eval_flops(cfg: Dict[str, Any], batch: int, seq_len: int) -> float:
    """Model FLOPs of one evaluation: the forward third of a step."""
    return train_flops(cfg, batch, seq_len) / 3.0


def n_chunks(seq_len: int, chunk: int) -> int:
    return math.ceil(seq_len / chunk)
