"""qwen2-0.5b — small dense GQA with QKV bias [arXiv:2407.10671].

24 layers, d_model 896, 14 heads / 2 KV (head_dim 64), d_ff 4864,
vocab 151936, tied embeddings.  Drives the ~100M-scale end-to-end example.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b", arch_type="dense",
    num_layers=24, d_model=896, vocab_size=151936,
    num_heads=14, num_kv_heads=2, head_dim=64,
    d_ff=4864, qkv_bias=True, rope_theta=1e6,
    tie_embeddings=True,
    norm_eps=1e-6,
)
