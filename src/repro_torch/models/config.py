"""Model configuration — one frozen dataclass covers all six arch families.

Every assigned architecture (see ``repro_torch/configs/``) instantiates this with
its exact published shape; smoke tests use ``reduced()`` variants of the
same family (2 layers, d_model ≤ 512, ≤ 4 experts).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

__all__ = ["ModelConfig", "LayerKind"]

LayerKind = str  # "attn" | "local" | "rglru" | "ssm"


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    vocab_size: int
    # ----- attention (unused for pure-SSM layers)
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e4
    mrope_sections: Tuple[int, ...] = ()    # qwen2-vl M-RoPE (t, h, w) splits
    sliding_window: int = 0                 # >0: sliding-window attention
    causal: bool = True                     # False → encoder-only
    # ----- ffn
    d_ff: int = 0
    mlp_gated: bool = True                  # False → 2-matrix GeLU MLP (GPTBigCode)
    # ----- moe
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                       # per-expert hidden (routed experts)
    shared_d_ff: int = 0                    # shared-experts hidden
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # ----- ssm (mamba2 / SSD)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 64
    ssm_conv: int = 4
    # ----- hybrid layer pattern (cycled); homogeneous archs leave default
    layer_pattern: Tuple[LayerKind, ...] = ("attn",)
    local_window: int = 2048                # window for "local" layers
    rglru_width: Optional[int] = None       # recurrence width (default d_model)
    # ----- modality frontend stubs
    frontend: str = "none"                  # none | vision | audio
    frontend_dim: int = 0                   # embedding dim supplied by the stub
    frontend_tokens: int = 0                # prefix tokens supplied by the stub
    # ----- misc
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    remat: bool = False                     # activation checkpointing per layer

    # ------------------------------------------------------------- derived
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(1, self.num_heads)

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def layer_kinds(self) -> Tuple[LayerKind, ...]:
        """Per-layer kind, cycling ``layer_pattern``."""
        pat = self.layer_pattern
        return tuple(pat[i % len(pat)] for i in range(self.num_layers))

    @property
    def uses_attention(self) -> bool:
        return any(k in ("attn", "local") for k in self.layer_kinds())

    @property
    def is_encoder_only(self) -> bool:
        return not self.causal

    @property
    def subquadratic(self) -> bool:
        """True iff no layer does full-sequence quadratic attention (the
        requirement for the ``long_500k`` shape)."""
        kinds = set(self.layer_kinds())
        if "attn" in kinds and self.sliding_window <= 0:
            return False
        return True

    # ------------------------------------------------------------- variants
    def reduced(self, num_layers: int = 2, d_model: int = 256,
                vocab_size: int = 512) -> "ModelConfig":
        """Smoke-test variant of the same family."""
        ratio = d_model / self.d_model
        scale = lambda x, lo=1: max(lo, int(round(x * ratio)))
        head_dim = 32
        n_heads = max(1, d_model // 64) if self.num_heads else 0
        n_kv = max(1, min(n_heads, max(1, int(round(
            n_heads * self.num_kv_heads / max(1, self.num_heads)))))) if self.num_kv_heads else 0
        pat = self.layer_pattern
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=num_layers if len(pat) == 1 else max(num_layers, len(pat)),
            d_model=d_model,
            vocab_size=vocab_size,
            num_heads=n_heads,
            num_kv_heads=n_kv,
            head_dim=head_dim if self.num_heads else None,
            d_ff=scale(self.d_ff) if self.d_ff else 0,
            n_experts=min(4, self.n_experts),
            n_shared_experts=min(1, self.n_shared_experts),
            top_k=min(2, self.top_k),
            moe_d_ff=scale(self.moe_d_ff) if self.moe_d_ff else 0,
            shared_d_ff=scale(self.shared_d_ff) if self.shared_d_ff else 0,
            ssm_state=min(32, self.ssm_state),
            ssm_heads=max(1, d_model * self.ssm_expand // 64) if self.ssm_heads else 0,
            ssm_head_dim=64 if self.ssm_heads else self.ssm_head_dim,
            ssm_chunk=16 if self.ssm_heads else self.ssm_chunk,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            local_window=min(self.local_window, 64),
            mrope_sections=(8, 4, 4) if self.mrope_sections else (),
            frontend_dim=min(self.frontend_dim, 128) if self.frontend_dim else 0,
            frontend_tokens=min(self.frontend_tokens, 16) if self.frontend_tokens else 0,
            rglru_width=None,
            dtype="float32",
            remat=False,
        )

    # --------------------------------------------------------------- counts
    def param_count(self) -> int:
        """Exact parameter count of this configuration."""
        D, V = self.d_model, self.vocab_size
        total = V * D                                   # embedding
        if not self.tie_embeddings and not self.is_encoder_only:
            total += D * V                              # lm head
        if self.is_encoder_only:
            total += D * V                              # classifier head
        if self.frontend_dim:
            total += self.frontend_dim * D              # frontend projector
        hd = self.resolved_head_dim
        for kind in self.layer_kinds():
            # pre-norm per mixer + per ffn (SSD blocks carry no FFN)
            total += D if kind == "ssm" else 2 * D
            if kind in ("attn", "local"):
                q = D * self.num_heads * hd
                kv = 2 * D * self.num_kv_heads * hd
                o = self.num_heads * hd * D
                total += q + kv + o
                if self.qkv_bias:
                    total += (self.num_heads + 2 * self.num_kv_heads) * hd
                if self.qk_norm:
                    total += 2 * hd
            elif kind == "rglru":
                W = self.rglru_width or D
                total += 2 * D * W + W * D              # in (x,gate branches), out
                total += 2 * W                          # recurrence gates a, input gate
                total += W * self.ssm_conv              # temporal conv
            elif kind == "ssm":
                inner = self.ssm_inner
                nh, hd_s = self.ssm_heads, self.ssm_head_dim
                total += D * (2 * inner + 2 * self.ssm_state + nh)  # in_proj(z,x,B,C,dt)
                total += self.ssm_conv * (inner + 2 * self.ssm_state)
                total += nh * 3                          # A_log, D, dt_bias
                total += inner                           # gating norm
                total += inner * D                       # out proj
            # ffn
            if kind in ("attn", "local", "rglru") or self.arch_type != "ssm":
                if self.n_experts:
                    total += D * self.n_experts          # router
                    total += self.n_experts * 3 * D * self.moe_d_ff
                    if self.n_shared_experts:
                        total += 3 * D * self.shared_d_ff
                elif self.d_ff:
                    nmat = 3 if self.mlp_gated else 2
                    total += nmat * D * self.d_ff        # swiglu / gelu mlp
        total += D                                       # final norm
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: routed top-k + shared only)."""
        if not self.n_experts:
            return self.param_count()
        full = self.param_count()
        routed_all = 0
        routed_active = 0
        for kind in self.layer_kinds():
            routed_all += self.n_experts * 3 * self.d_model * self.moe_d_ff
            routed_active += self.top_k * 3 * self.d_model * self.moe_d_ff
        return full - routed_all + routed_active
