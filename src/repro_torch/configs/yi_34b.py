"""yi-34b — llama-architecture dense with GQA [arXiv:2403.04652].

60 layers, d_model 7168, 56 heads / 8 KV heads (head_dim 128), d_ff 20480,
vocab 64000.  ``long_500k`` runs via the sliding-window variant (DESIGN §4).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b", arch_type="dense",
    num_layers=60, d_model=7168, vocab_size=64000,
    num_heads=56, num_kv_heads=8, head_dim=128,
    d_ff=20480, rope_theta=5e6,
    norm_eps=1e-5,
)
