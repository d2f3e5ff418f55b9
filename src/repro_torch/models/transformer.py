"""Model assembly for all six architecture families: ``attn`` / ``local``
/ ``rglru`` / ``ssm`` blocks, dense or MoE FFNs, and the vision and audio
frontends.

The counterpart of ``repro/models/transformer.py``: the parameter tree is
the JAX package's — ``{"embed", "final_norm", ["lm_head"], "cycles": [one
dict of (n_full, ...) stacked leaves per pattern slot], "rest": [per-layer
dicts]}`` — so weights carry across leaf for leaf, and so is the decode
cache's (``init_cache``: ``{"cycles": [...], "rest": [...]}`` of KV ring
buffers, RG-LRU and SSD states).  Blocks are pre-norm residual: ``x +=
mixer(norm1(x)); x += ffn(norm2(x))``, the mixer being attention, the
RG-LRU recurrence or the SSD layer (SSD blocks carry no FFN, matching
Mamba2), the FFN a SwiGLU or the MoE layer, whose load-balancing loss is
summed over layers.  Layers that do not fill a whole cycle (26 = 8 × 3 + 2
for recurrentgemma) run after the cycles.

The frontends are the reference's stubs: an audio model (hubert,
encoder-only) embeds ``batch["features"] @ frontend_proj`` with 1-D
positions; a vision model (qwen2-vl) puts ``batch["patches"] @
frontend_proj`` before the embedded text tokens and takes
``batch["positions"]`` (3, B, S) as M-RoPE ids, and its loss reads the
text's logits after the patch prefix.  Features and patches come in the
config's dtype; another dtype raises (the reference would promote).

The JAX layer ``scan`` becomes a Python loop: eager PyTorch has no layer
scan, so the port always runs unrolled (the reference's ``unroll=False``
scan counts a scanned body's flops once in XLA's cost analysis; every
count of the port is per layer).  Under ``cfg.remat`` each cycle's blocks
run inside ``torch.utils.checkpoint`` (non-reentrant), as the reference
wraps its cycle body in ``jax.checkpoint``; the trailing ``rest`` blocks
stay outside, and recomputation gives the gradients of a run without it
bit for bit.  ``constrain`` (the reference's activation constraint, the
identity by default) is applied to the residual stream after every block
of a cycle, not after the ``rest`` blocks.  ``gather`` (the identity by
default) maps each weight tree just before the arithmetic reads it: one
block's tree, the embedding table, the head, the final norm and the
frontend projection; the dry run (:mod:`repro_torch.launch.dryrun`) passes
one that gathers a weight's FSDP shards.  The embedding table is asked for
``whole=True`` before the lookup: there the dry run gathers its vocab
shards too, since DTensor cannot reduce a vocab-sharded lookup's masked
partial sums.  Each stacked leaf is split once per forward with
``torch.unbind`` (whose backward is one ``stack``),
not indexed per layer (whose backward would allocate a full-size zero
tensor per layer per leaf).  The embedding lookup is ``F.embedding`` and
the loss ``log_softmax`` + ``gather``: neither backward needs float
atomics with colliding indices on the GPU, so a training step is
bit-reproducible there.  The tied output head is ``F.linear(x, embed)``,
whose weight gradient comes back contiguous.  ``decode_step`` writes each
layer's cache in place through views of the stacked buffers, so a step
allocates no cache and returns the one it was given.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.attention import (attention_decode,
                                          attention_forward, init_attention,
                                          init_kv_cache)
from repro_torch.models.config import ModelConfig
from repro_torch.models.ffn import (init_mlp, init_moe, mlp_forward,
                                    moe_forward)
from repro_torch.models.layers import (dense_init, embed_init, init_rms,
                                       rms_norm)
from repro_torch.models.rglru import (init_rglru, init_rglru_cache,
                                      rglru_decode, rglru_forward)
from repro_torch.models.ssm import (init_ssm, init_ssm_cache, ssm_decode,
                                    ssm_forward)
from repro_torch.utils.tree import tree_leaves, tree_map

__all__ = ["LM"]


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]


def _has_ffn(cfg: ModelConfig, kind: str) -> bool:
    """SSD blocks carry no FFN (Mamba2)."""
    return kind != "ssm" and (cfg.d_ff > 0 or cfg.n_experts > 0)


def _window(cfg: ModelConfig, kind: str) -> int:
    return cfg.sliding_window if kind == "attn" else cfg.local_window


def _init_block(cfg: ModelConfig, kind: str, gen: torch.Generator,
                dtype: torch.dtype) -> Dict[str, Any]:
    p: Dict[str, Any] = {"norm1": init_rms(cfg.d_model, dtype)}
    if kind == "ssm":
        p["ssm"] = init_ssm(cfg, gen, dtype)
    elif kind == "rglru":
        p["rglru"] = init_rglru(cfg, gen, dtype)
    else:
        p["attn"] = init_attention(cfg, gen, dtype)
    if _has_ffn(cfg, kind):
        p["norm2"] = init_rms(cfg.d_model, dtype)
        p["ffn"] = (init_moe(cfg, gen, dtype) if cfg.n_experts
                    else init_mlp(cfg.d_model, cfg.d_ff, gen, dtype,
                                  gated=cfg.mlp_gated))
    return p


def _ffn(cfg: ModelConfig, p, x) -> Tuple[torch.Tensor, Any]:
    """``x + ffn(norm2(x))`` and the MoE aux loss (None for a dense
    FFN)."""
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    if cfg.n_experts:
        h, aux = moe_forward(p["ffn"], cfg, h)
        return x + h, aux
    return x + mlp_forward(p["ffn"], h), None


def _block_forward(cfg: ModelConfig, kind: str, p, x, positions,
                   use_kernel: bool) -> Tuple[torch.Tensor, Any]:
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if kind == "ssm":
        h = ssm_forward(p["ssm"], cfg, h, use_kernel=use_kernel)
    elif kind == "rglru":
        h = rglru_forward(p["rglru"], cfg, h)
    else:
        h = attention_forward(p["attn"], cfg, h, positions,
                              window=_window(cfg, kind),
                              use_kernel=use_kernel)
    x = x + h
    if _has_ffn(cfg, kind):
        return _ffn(cfg, p, x)
    return x, None


def _block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                 dtype: torch.dtype, device) -> Dict[str, Any]:
    if kind == "ssm":
        return init_ssm_cache(cfg, batch, dtype, device)
    if kind == "rglru":
        return init_rglru_cache(cfg, batch, dtype, device)
    return init_kv_cache(cfg, batch, max_len, _window(cfg, kind), dtype,
                         device)


def _block_decode(cfg: ModelConfig, kind: str, p, x, cache, index
                  ) -> torch.Tensor:
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if kind == "ssm":
        h, _ = ssm_decode(p["ssm"], cfg, h, cache)
    elif kind == "rglru":
        h, _ = rglru_decode(p["rglru"], cfg, h, cache)
    else:
        h, _ = attention_decode(p["attn"], cfg, h, cache, index,
                                window=_window(cfg, kind))
    x = x + h
    if _has_ffn(cfg, kind):
        x, _ = _ffn(cfg, p, x)
    return x


def _identity(x, whole: bool = False):
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
    """Decoder LM / encoder (``causal=False``) over any layer pattern of
    ``attn`` / ``local`` / ``rglru`` / ``ssm`` blocks, dense or MoE, with
    an optional vision or audio frontend."""

    def __init__(self, cfg: ModelConfig, use_kernel: bool = False,
                 constrain: Optional[Callable[[torch.Tensor],
                                              torch.Tensor]] = None,
                 gather: Optional[Callable[[Any], Any]] = None):
        kinds = set(cfg.layer_kinds()) - {"attn", "local", "rglru", "ssm"}
        if kinds:
            raise ValueError(f"{cfg.name}: unknown block kinds "
                             f"{sorted(kinds)}")
        self.cfg = cfg
        self.use_kernel = use_kernel
        self.constrain = constrain or _identity
        self.gather = gather or _identity
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
        if cfg.frontend_dim:
            params["frontend_proj"] = dense_init(
                gen, (cfg.frontend_dim, cfg.d_model), dtype=dt)
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
    def _layers(self, tree) -> List[Tuple[str, Any]]:
        """``(kind, per-layer tree)`` in depth order: the stacked cycles,
        one ``unbind`` per leaf (views, which a decode step writes in
        place), then the rest."""
        cycles = [_unstack(c, self.n_full) for c in tree["cycles"]]
        out = [(kind, cycles[s][i]) for i in range(self.n_full)
               for s, kind in enumerate(self.pattern)]
        return out + list(zip(self.rest_kinds, tree["rest"]))

    def _head(self, params, x) -> torch.Tensor:
        x = rms_norm(x, self.gather(params["final_norm"]), self.cfg.norm_eps)
        if self.cfg.tie_embeddings:
            return F.linear(x, self.gather(params["embed"])).float()
        return (x @ self.gather(params["lm_head"])).float()

    def _frontend_input(self, batch, key: str) -> torch.Tensor:
        """``batch[key]`` (features or patches), which must come in the
        model's dtype: the reference would promote an input of another
        dtype, and the port does not cast behind the caller's back."""
        x = batch[key]
        want = _dtype(self.cfg)
        if x.dtype != want:
            raise ValueError(f"{self.cfg.name}: batch[{key!r}] is {x.dtype}; "
                             f"the {self.cfg.frontend} frontend takes {want} "
                             f"(the model's dtype)")
        return x

    def _embed(self, params, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """(hidden (B, S, D), positions): (B, S) ids, or for the vision
        frontend ``batch["positions"]`` (3, B, S) as M-RoPE ids."""
        cfg = self.cfg
        if cfg.frontend == "audio":
            x = self._frontend_input(batch, "features") @ \
                self.gather(params["frontend_proj"])
        else:
            x = F.embedding(batch["tokens"],
                            self.gather(params["embed"], whole=True))
            if cfg.frontend == "vision":
                patches = self._frontend_input(batch, "patches") @ \
                    self.gather(params["frontend_proj"])
                return torch.cat([patches, x], dim=1), batch["positions"]
        B, S = x.shape[:2]
        return x, torch.arange(S, device=x.device)[None].expand(B, S)

    def forward(self, params, batch) -> Tuple[torch.Tensor,
                                              Dict[str, torch.Tensor]]:
        """``batch["tokens"]`` (B, S) int64 (audio: ``features`` (B, S,
        frontend_dim); vision: ``tokens``, ``patches`` (B, P, frontend_dim)
        and ``positions`` (3, B, P + S)) → f32 logits (B, S, V) and
        ``{"moe_aux"}``, the MoE loss summed over layers (0 without
        experts)."""
        x, positions = self._embed(params, batch)
        aux = torch.zeros((), device=x.device)
        layers = self._layers(params)
        n = self.n_full * self.n_cycle
        for i in range(0, n, self.n_cycle):
            cycle = layers[i:i + self.n_cycle]
            if self.cfg.remat and torch.is_grad_enabled():
                x, aux = checkpoint(self._cycle, cycle, x, aux, positions,
                                    use_reentrant=False)
            else:
                x, aux = self._cycle(cycle, x, aux, positions)
        for kind, p in layers[n:]:
            x, aux = self._block(kind, p, x, aux, positions)
        return self._head(params, x), {"moe_aux": aux}

    def _block(self, kind, p, x, aux, positions):
        x, a = _block_forward(self.cfg, kind, self.gather(p), x, positions,
                              self.use_kernel)
        return x, aux if a is None else aux + a

    def _cycle(self, cycle, x, aux, positions):
        """One cycle's blocks, the residual stream constrained after
        each."""
        for kind, p in cycle:
            x, aux = self._block(kind, p, x, aux, positions)
            x = self.constrain(x)
        return x, aux

    # ------------------------------------------------------------------ loss
    def loss(self, params, batch) -> Tuple[torch.Tensor,
                                           Dict[str, torch.Tensor]]:
        """Mean next-token NLL (framewise for an encoder; over the text after
        the patch prefix for the vision frontend), plus
        ``router_aux_weight · moe_aux / num_layers`` with experts; metrics
        ``nll`` and ``moe_aux`` as in the JAX package."""
        cfg = self.cfg
        logits, aux = self.forward(params, batch)
        if cfg.is_encoder_only:
            lg, lb = logits, batch["labels"]
        elif cfg.frontend == "vision":
            # text tokens sit after the patch prefix: logits[:, P + i]
            # predicts text token i + 1
            P, n_text = batch["patches"].shape[1], batch["tokens"].shape[1]
            lg, lb = logits[:, P:P + n_text - 1], batch["tokens"][:, 1:]
        else:
            lg, lb = logits[:, :-1], batch["tokens"][:, 1:]
        nll = self._nll(lg, lb)
        loss = nll
        if cfg.n_experts:
            loss = loss + cfg.router_aux_weight * aux["moe_aux"] / max(
                1, cfg.num_layers)
        return loss, {"nll": nll.detach(),
                      "moe_aux": aux["moe_aux"].detach()}

    @staticmethod
    def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """Mean negative log-likelihood of ``labels`` under ``logits``."""
        logp = F.log_softmax(logits, dim=-1)
        return torch.mean(-torch.gather(logp, -1, labels[..., None])[..., 0])

    # ---------------------------------------------------------------- decode
    def init_cache(self, batch: int, max_len: int,
                   device: Union[str, torch.device, None] = None
                   ) -> Dict[str, Any]:
        """Zeroed decode caches in the reference's tree: ``{"cycles": [one
        dict of (n_full, ...) stacked buffers per pattern slot], "rest":
        [per-layer dicts]}``; a KV buffer holds ``window`` slots for a
        sliding-window layer, else ``max_len``."""
        cfg, dt = self.cfg, _dtype(self.cfg)

        def stacked(kind):
            one = _block_cache(cfg, kind, batch, max_len, dt, "meta")
            return tree_map(lambda a: torch.zeros(
                (self.n_full, *a.shape), dtype=a.dtype, device=device), one)

        return {"cycles": [stacked(kind) for kind in self.pattern],
                "rest": [_block_cache(cfg, kind, batch, max_len, dt, device)
                         for kind in self.rest_kinds]}

    def decode_step(self, params, cache, tokens: torch.Tensor,
                    index: Union[int, torch.Tensor]
                    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """tokens: (B, 1) ids; ``index``: their absolute position (an int
        or a 0-d integer tensor on the tokens' device).  Returns (f32
        logits (B, 1, V), ``cache``), the cache written in place."""
        cfg = self.cfg
        if cfg.is_encoder_only:
            raise ValueError(f"{cfg.name}: an encoder-only model has no "
                             f"decode")
        x = F.embedding(tokens, self.gather(params["embed"], whole=True))
        for (kind, p), (_, c) in zip(self._layers(params),
                                     self._layers(cache)):
            x = _block_decode(cfg, kind, self.gather(p), x, c, index)
        return self._head(params, x), cache
