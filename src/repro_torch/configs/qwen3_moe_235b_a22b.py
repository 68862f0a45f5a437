"""qwen3-moe-235b-a22b [moe]: 94L, d_model=4096, 64H GQA kv=4
(head_dim=128), vocab=151936, MoE: 128 routed experts top-8 (no shared),
expert d_ff=1536 [hf:Qwen/Qwen3 family]. The largest assigned config —
only ever lowered via the dry-run.
"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", arch_type="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
    d_ff=0, vocab_size=151936,
    layer_pattern=("attn",),
    moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=1536),
    rope_theta=1_000_000.0,
)
