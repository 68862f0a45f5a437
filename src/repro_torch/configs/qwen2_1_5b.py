"""qwen2-1.5b [dense]: 28L, d_model=1536, 12H GQA kv=2, d_ff=8960,
vocab=151936, QKV bias, tied embeddings [arXiv:2407.10671].
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b", arch_type="dense",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
    d_ff=8960, vocab_size=151936,
    layer_pattern=("attn",),
    qkv_bias=True, rope_theta=1_000_000.0, tie_embeddings=True,
)
