"""mamba2-2.7b — SSD (state-space duality), attention-free [arXiv:2405.21060].

64 layers, d_model 2560, vocab 50280, ssm_state 128; expand 2 → inner 5120,
head_dim 64 → 80 SSD heads.  No FFN (the Mamba2 block is the whole layer).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", arch_type="ssm",
    num_layers=64, d_model=2560, vocab_size=50280,
    d_ff=0, num_heads=0, num_kv_heads=0,
    ssm_state=128, ssm_heads=80, ssm_head_dim=64, ssm_expand=2,
    ssm_chunk=128, ssm_conv=4,
    layer_pattern=("ssm",),
    tie_embeddings=True,
    norm_eps=1e-5,
)
