"""xlstm-350m [ssm]: 24 xLSTM blocks, d_model=1024, 4 heads, no separate
MLP (d_ff=0; the blocks embed their own projections), vocab=50304
[arXiv:2405.04517]. Block ratio mLSTM:sLSTM = 7:1 (the paper's xLSTM[7:1]),
24 = 3 periods of 8.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m", arch_type="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304,
    layer_pattern=("mlstm",) * 7 + ("slstm",),
    act="gelu",
)
