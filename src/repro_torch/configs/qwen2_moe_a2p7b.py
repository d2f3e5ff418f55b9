"""qwen2-moe-a2.7b — 60 routed experts top-4 + 4 shared experts
[hf:Qwen/Qwen1.5-MoE-A2.7B].

24 layers, d_model 2048, 16 heads (MHA kv=16, head_dim 128), routed expert
d_ff 1408, shared-expert hidden 4×1408 = 5632, vocab 151936.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", arch_type="moe",
    num_layers=24, d_model=2048, vocab_size=151936,
    num_heads=16, num_kv_heads=16, head_dim=128,
    n_experts=60, top_k=4, moe_d_ff=1408,
    n_shared_experts=4, shared_d_ff=5632,
    qkv_bias=True, capacity_factor=1.25,
    norm_eps=1e-6,
)
