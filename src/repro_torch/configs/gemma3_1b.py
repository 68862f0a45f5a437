"""gemma3-1b [dense]: 26L, d_model=1152, 4H GQA kv=1 (head_dim=256),
d_ff=6912, vocab=262144, 5:1 local:global attention (window 512),
RoPE theta 10k local / 1M global, tied embeddings
[hf:google/gemma-3-1b-pt]. 26 = 4 periods of 6 + 2 remainder locals.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b", arch_type="dense",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, head_dim=256,
    d_ff=6912, vocab_size=262144,
    layer_pattern=("attn_local",) * 5 + ("attn",), window=512,
    rope_theta=10_000.0, rope_theta_global=1_000_000.0,
    act="gelu", tie_embeddings=True,
)
