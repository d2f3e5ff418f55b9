"""recurrentgemma-2b — Griffin hybrid: RG-LRU + local attention, 1:2
[arXiv:2402.19427].

26 layers, d_model 2560, 10 heads (MQA kv=1, head_dim 256), d_ff 7680,
vocab 256000.  Pattern (rglru, rglru, local) × 8 + 2 trailing rglru;
local window 2048.  ``long_500k`` is native (O(1) recurrent state +
window-bounded local KV).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", arch_type="hybrid",
    num_layers=26, d_model=2560, vocab_size=256000,
    num_heads=10, num_kv_heads=1, head_dim=256,
    d_ff=7680,
    layer_pattern=("rglru", "rglru", "local"),
    local_window=2048, rglru_width=2560, ssm_conv=4,
    tie_embeddings=True,
    norm_eps=1e-6,
)
