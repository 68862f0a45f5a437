"""qwen2-moe-a2.7b [moe]: 24L, d_model=2048, 16H MHA, vocab=151936,
MoE: 60 routed experts top-4 + 4 shared experts, expert d_ff=1408
[hf:Qwen/Qwen1.5-MoE-A2.7B]. QKV bias per Qwen1.5.
"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", arch_type="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=0, vocab_size=151936,
    layer_pattern=("attn",),
    moe=MoEConfig(n_experts=60, top_k=4, d_ff_expert=1408,
                  n_shared_experts=4),
    qkv_bias=True, rope_theta=1_000_000.0,
)
