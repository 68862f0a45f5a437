"""seamless-m4t-medium [audio]: enc-dec speech/text transformer backbone.
12 encoder + 12 decoder layers, d_model=1024, 16 heads (MHA), d_ff=4096,
vocab=256206 [arXiv:2308.11596]. The mel-spectrogram + conformer frontend
is the allowed stub: the serve and train CLIs draw (B, S, 1024) frame
embeddings.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", arch_type="audio",
    n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab_size=256206,
    layer_pattern=("attn",),
    n_encoder_layers=12,
    frontend="audio", frontend_dim=1024,
    act="gelu",
)
