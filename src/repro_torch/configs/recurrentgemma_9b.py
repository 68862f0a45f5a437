"""recurrentgemma-9b [hybrid]: Griffin architecture, 38 layers in a
(RG-LRU, RG-LRU, local-attention) 2:1 pattern, d_model=4096,
16H MQA (kv=1, head_dim=256), d_ff=12288, local window 2048,
vocab=256000 [arXiv:2402.19427]. 38 = 12 periods + 2 remainder RG-LRU.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", arch_type="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256,
    d_ff=12288, vocab_size=256000,
    layer_pattern=("rglru", "rglru", "attn_local"), window=2048,
    act="gelu", tie_embeddings=True,
)
