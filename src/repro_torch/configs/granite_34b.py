"""granite-34b — llama-architecture code model, deep-narrow MQA
[arXiv:2405.04324].

88 layers, d_model 6144, 48 heads / 1 KV (MQA, head_dim 128), d_ff 24576,
vocab 49152 (2-matrix GPTBigCode MLP).  Deepest assigned arch — the layer-scan keeps its HLO small.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b", arch_type="dense",
    num_layers=88, d_model=6144, vocab_size=49152,
    num_heads=48, num_kv_heads=1, head_dim=128,
    d_ff=24576, mlp_gated=False,
    norm_eps=1e-5,
)
