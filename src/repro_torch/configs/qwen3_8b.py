"""qwen3-8b — dense GQA with per-head qk-norm [hf:Qwen/Qwen3-8B].

36 layers, d_model 4096, 32 heads / 8 KV (head_dim 128), d_ff 12288,
vocab 151936.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b", arch_type="dense",
    num_layers=36, d_model=4096, vocab_size=151936,
    num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=12288, qk_norm=True, rope_theta=1e6,
    norm_eps=1e-6,
)
