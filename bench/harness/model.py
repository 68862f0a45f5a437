"""The port's model configuration for a configuration file of
``bench/configs``: the registry entry it names, with every size the
file states put in its place, so the program runs the sizes the file
holds."""
from __future__ import annotations

from dataclasses import replace
from typing import Dict


def port_config(doc: Dict):
    """The port's ``ModelConfig`` of ``doc``."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import MoEConfig
    base = get_config(doc["registry"])
    kw = dict(
        n_layers=doc["num_hidden_layers"], d_model=doc["hidden_size"],
        n_heads=doc["num_attention_heads"],
        n_kv_heads=doc["num_key_value_heads"], head_dim=doc.get("head_dim"),
        vocab_size=doc["vocab_size"], qkv_bias=bool(doc.get("qkv_bias")),
        rope_theta=float(doc["rope_theta"]),
        tie_embeddings=bool(doc.get("tie_word_embeddings")),
        norm_eps=float(doc["rms_norm_eps"]), act=doc["hidden_act"],
        dtype=doc["torch_dtype"], layer_pattern=("attn",))
    if doc.get("num_experts"):
        f = doc["moe_intermediate_size"]
        kw.update(d_ff=0, moe=MoEConfig(
            n_experts=doc["num_experts"], top_k=doc["num_experts_per_tok"],
            d_ff_expert=f,
            n_shared_experts=doc.get("shared_expert_intermediate_size",
                                     0) // f,
            capacity_factor=float(doc["capacity_factor"]),
            router_aux_weight=float(doc.get("router_aux_loss_coef",
                                            base.moe.router_aux_weight))))
    else:
        kw.update(d_ff=doc["intermediate_size"], moe=None)
    return replace(base, **kw)
