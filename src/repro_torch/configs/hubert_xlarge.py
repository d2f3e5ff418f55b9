"""hubert-xlarge — encoder-only audio transformer [arXiv:2106.07447].

48 layers, d_model 1280, 16 heads (MHA kv=16, head_dim 80), d_ff 5120,
vocab 504 (framewise cluster targets).  The conv waveform feature extractor
is a stub per the carve-out: ``input_specs`` supplies frame embeddings
(dim 512).  Encoder-only → no decode shapes (DESIGN §4).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", arch_type="audio",
    num_layers=48, d_model=1280, vocab_size=504,
    num_heads=16, num_kv_heads=16, head_dim=80,
    d_ff=5120, causal=False,
    frontend="audio", frontend_dim=512,
    norm_eps=1e-5,
)
