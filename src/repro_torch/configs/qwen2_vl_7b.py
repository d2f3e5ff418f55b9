"""qwen2-vl-7b — VLM decoder with M-RoPE + dynamic resolution
[arXiv:2409.12191].

28 layers, d_model 3584, 28 heads / 4 KV (head_dim 128), d_ff 18944,
vocab 152064, QKV bias, M-RoPE sections (16, 24, 24).  The ViT/projector
frontend is a stub per the assignment carve-out: ``input_specs`` supplies
1024 precomputed patch embeddings (dim 1280) per sample.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b", arch_type="vlm",
    num_layers=28, d_model=3584, vocab_size=152064,
    num_heads=28, num_kv_heads=4, head_dim=128,
    d_ff=18944, qkv_bias=True,
    mrope_sections=(16, 24, 24), rope_theta=1e6,
    frontend="vision", frontend_dim=1280, frontend_tokens=1024,
    norm_eps=1e-6,
)
