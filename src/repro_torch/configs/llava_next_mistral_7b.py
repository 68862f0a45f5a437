"""llava-next-mistral-7b [vlm]: Mistral-7B decoder backbone, 32L,
d_model=4096, 32H GQA kv=8, d_ff=14336, vocab=32000
[hf:llava-hf/llava-v1.6-mistral-7b-hf]. The SigLIP/CLIP ViT + anyres
tiling frontend is the allowed stub: the serve and train CLIs draw
(B, 2880, 1024) patch embeddings (anyres 4+1 tiles x 576); the 2-layer MLP projector IS
implemented (it belongs to the LM side).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", arch_type="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=32000,
    layer_pattern=("attn",),
    frontend="vision", frontend_dim=1024, frontend_tokens=2880,
    rope_theta=1_000_000.0,
)
