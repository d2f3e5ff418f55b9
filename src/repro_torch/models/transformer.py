"""Decoder LM assembly for the attention and SSM families (``attn`` /
``local`` / ``ssm`` blocks).

The counterpart of ``repro/models/transformer.py:141-269`` for dense
attention models and Mamba2: the parameter tree is the JAX package's —
``{"embed", "final_norm", ["lm_head"], "cycles": [one dict of
(n_full, ...) stacked leaves per pattern slot], "rest": [per-layer dicts]}``
— so weights carry across leaf for leaf.  Blocks are pre-norm residual:
``x += mixer(norm1(x)); x += mlp(norm2(x))``, the mixer being attention or
the SSD layer (SSD blocks carry no FFN, matching Mamba2).

The JAX layer ``scan`` becomes a Python loop.  Each stacked leaf is split
once per forward with ``torch.unbind`` (whose backward is one ``stack``),
not indexed per layer (whose backward would allocate a full-size zero
tensor per layer per leaf).  The embedding lookup is ``F.embedding`` and
the loss ``log_softmax`` + ``gather``: neither backward needs float
atomics with colliding indices on the GPU, so a training step is
bit-reproducible there.  The tied output head is ``F.linear(x, embed)``,
whose weight gradient comes back contiguous.

Not here yet, each raising ``NotImplementedError`` naming its ROADMAP
queue A slice: RG-LRU blocks, Mixture-of-Experts, vision / audio
frontends, decode with caches.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.models.attention import attention_forward, init_attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.ffn import MOE_SLICE, init_mlp, mlp_forward
from repro_torch.models.layers import (dense_init, embed_init, init_rms,
                                       rms_norm)
from repro_torch.models.ssm import init_ssm, ssm_forward
from repro_torch.utils.tree import tree_leaves, tree_map

__all__ = ["LM"]

RGLRU_SLICE = "ROADMAP queue A, slice 12"
DECODE_SLICE = "ROADMAP queue A, slice 10"


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]


def _has_ffn(cfg: ModelConfig, kind: str) -> bool:
    """SSD blocks carry no FFN (Mamba2); MoE blocks are not built here."""
    return kind != "ssm" and cfg.d_ff > 0


def _init_block(cfg: ModelConfig, kind: str, gen: torch.Generator,
                dtype: torch.dtype) -> Dict[str, Any]:
    p: Dict[str, Any] = {"norm1": init_rms(cfg.d_model, dtype)}
    if kind == "ssm":
        p["ssm"] = init_ssm(cfg, gen, dtype)
    else:
        p["attn"] = init_attention(cfg, gen, dtype)
    if _has_ffn(cfg, kind):
        p["norm2"] = init_rms(cfg.d_model, dtype)
        p["ffn"] = init_mlp(cfg.d_model, cfg.d_ff, gen, dtype,
                            gated=cfg.mlp_gated)
    return p


def _block_forward(cfg: ModelConfig, kind: str, p, x, positions,
                   use_kernel: bool) -> torch.Tensor:
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if kind == "ssm":
        h = ssm_forward(p["ssm"], cfg, h, use_kernel=use_kernel)
    else:
        window = cfg.sliding_window if kind == "attn" else cfg.local_window
        h = attention_forward(p["attn"], cfg, h, positions, window=window,
                              use_kernel=use_kernel)
    x = x + h
    if _has_ffn(cfg, kind):
        x = x + mlp_forward(p["ffn"], rms_norm(x, p["norm2"], cfg.norm_eps))
    return x


def _stack(trees: List[Any]) -> Any:
    it = [iter(tree_leaves(t)) for t in trees]
    return tree_map(lambda _: torch.stack([next(i) for i in it]), trees[0])


def _unstack(tree: Any, n: int) -> List[Any]:
    """The ``n`` per-layer trees of a stacked tree, one ``unbind`` per
    leaf."""
    parts = [leaf.unbind(0) for leaf in tree_leaves(tree)]
    out = []
    for i in range(n):
        it = iter([p[i] for p in parts])
        out.append(tree_map(lambda _: next(it), tree))
    return out


class LM:
    """Decoder LM / encoder (``causal=False``) over ``attn`` / ``local`` /
    ``ssm`` layer patterns."""

    def __init__(self, cfg: ModelConfig, use_kernel: bool = False):
        kinds = set(cfg.layer_kinds()) - {"attn", "local", "ssm"}
        if kinds:
            raise NotImplementedError(
                f"{cfg.name}: {sorted(kinds)} blocks are not in repro_torch "
                f"yet ({RGLRU_SLICE})")
        if cfg.n_experts:
            raise NotImplementedError(f"{cfg.name}: Mixture-of-Experts is "
                                      f"not in repro_torch yet ({MOE_SLICE})")
        if cfg.frontend != "none":
            raise NotImplementedError(f"{cfg.name}: the {cfg.frontend} "
                                      f"frontend is not in repro_torch yet "
                                      f"({MOE_SLICE})")
        self.cfg = cfg
        self.use_kernel = use_kernel
        self.pattern = cfg.layer_pattern
        self.n_cycle = len(self.pattern)
        self.n_full = cfg.num_layers // self.n_cycle
        self.rest_kinds = cfg.layer_kinds()[self.n_full * self.n_cycle:]

    # ------------------------------------------------------------------ init
    def init(self, rng: Union[int, torch.Generator],
             device: Union[str, torch.device, None] = None) -> Dict[str, Any]:
        """Fresh parameters in the config's dtype, drawn from ``rng`` (a
        seed or a CPU ``torch.Generator``) on the host, so a seed gives the
        same bits wherever they end up; ``device`` moves them there."""
        cfg = self.cfg
        dt = _dtype(cfg)
        gen = rng if isinstance(rng, torch.Generator) else \
            torch.Generator().manual_seed(int(rng))
        params: Dict[str, Any] = {
            "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dt),
            "final_norm": init_rms(cfg.d_model, dt),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                           dtype=dt)
        params["cycles"] = [
            _stack([_init_block(cfg, kind, gen, dt)
                    for _ in range(self.n_full)])
            for kind in self.pattern]
        params["rest"] = [_init_block(cfg, kind, gen, dt)
                          for kind in self.rest_kinds]
        if device is not None:
            params = tree_map(lambda x: x.to(device), params)
        return params

    # --------------------------------------------------------------- forward
    def forward(self, params, batch) -> Tuple[torch.Tensor,
                                              Dict[str, torch.Tensor]]:
        """``batch["tokens"]`` (B, S) int64 → f32 logits (B, S, V)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        x = F.embedding(tokens, params["embed"])
        B, S = tokens.shape
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
        layers = [_unstack(c, self.n_full) for c in params["cycles"]]
        for i in range(self.n_full):
            for s, kind in enumerate(self.pattern):
                x = _block_forward(cfg, kind, layers[s][i], x, positions,
                                   self.use_kernel)
        for p, kind in zip(params["rest"], self.rest_kinds):
            x = _block_forward(cfg, kind, p, x, positions, self.use_kernel)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        if cfg.tie_embeddings:
            logits = F.linear(x, params["embed"])
        else:
            logits = x @ params["lm_head"]
        return logits.float(), {"moe_aux": torch.zeros((), device=x.device)}

    # ------------------------------------------------------------------ loss
    def loss(self, params, batch) -> Tuple[torch.Tensor,
                                           Dict[str, torch.Tensor]]:
        """Mean next-token NLL (framewise for an encoder), with metrics
        ``nll`` and ``moe_aux`` as in the JAX package."""
        logits, aux = self.forward(params, batch)
        if self.cfg.is_encoder_only:
            lg, lb = logits, batch["labels"]
        else:
            lg, lb = logits[:, :-1], batch["tokens"][:, 1:]
        logp = F.log_softmax(lg, dim=-1)
        nll = -torch.gather(logp, -1, lb[..., None])[..., 0]
        loss = torch.mean(nll)
        return loss, {"nll": loss.detach(), "moe_aux": aux["moe_aux"]}

    def decode_step(self, *args, **kw):
        raise NotImplementedError(f"decode with a KV cache is not in "
                                  f"repro_torch yet ({DECODE_SLICE})")
