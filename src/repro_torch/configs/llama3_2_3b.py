"""llama3.2-3b [dense]: 28L, d_model=3072, 24H GQA kv=8, d_ff=8192,
vocab=128256, RoPE theta 500k, tied embeddings [hf:meta-llama/Llama-3.2].
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b", arch_type="dense",
    n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=8192, vocab_size=128256,
    layer_pattern=("attn",),
    rope_theta=500_000.0, tie_embeddings=True,
)
