"""chatglm3-6b [dense]: 28L, d_model=4096, 32H GQA kv=2, d_ff=13696,
vocab=65024, 2d-RoPE (rotary on half of each head's dims,
rope_fraction=0.5), QKV bias [arXiv:2406.12793].
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b", arch_type="dense",
    n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2,
    d_ff=13696, vocab_size=65024,
    layer_pattern=("attn",),
    qkv_bias=True, rope_fraction=0.5,
)
