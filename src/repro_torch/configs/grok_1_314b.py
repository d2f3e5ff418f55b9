"""grok-1-314b — 8-expert top-2 MoE [hf:xai-org/grok-1].

64 layers, d_model 6144, 48 heads / 8 KV (head_dim 128), expert d_ff 32768,
vocab 131072.  The largest dry-run case: ~314B parameters, fits 512 chips
only with expert-parallel + FSDP sharding.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", arch_type="moe",
    num_layers=64, d_model=6144, vocab_size=131072,
    num_heads=48, num_kv_heads=8, head_dim=128,
    n_experts=8, top_k=2, moe_d_ff=32768,
    capacity_factor=1.25,
    norm_eps=1e-5,
)
