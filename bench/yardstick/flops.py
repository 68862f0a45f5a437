"""The model-operation count of a configuration, from its published
sizes (a configuration file of ``bench/configs``).

A token that passes through the model costs 2 operations per matrix
parameter it is multiplied with (the attention projections, the MLP or
the router, the shared experts and the ``num_experts_per_tok`` routed
experts it is sent to, and the LM head), plus 4 x head_dim x heads
operations per layer for each (query, key) pair it attends over. A
prefill needs the LM head at its last position alone (the first token
is drawn from it), so a prompt counts the head once. The count leaves
out recomputation, padding and the empty capacity slots of
a mixture of experts, so that removing wasted work never moves it. A
training step costs 3 times its tokens' forward count (the forward and
a backward of twice its operations).
"""
from __future__ import annotations

from typing import Dict


def _moe(cfg: Dict) -> bool:
    return bool(cfg.get("num_experts"))


def head_dim(cfg: Dict) -> int:
    return cfg.get("head_dim") or cfg["hidden_size"] // cfg["num_attention_heads"]


def matmul_params_per_token(cfg: Dict) -> int:
    """Matrix parameters one token is multiplied with, the LM head
    included."""
    d, hd = cfg["hidden_size"], head_dim(cfg)
    h, hk = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    attn = d * (h + 2 * hk) * hd + h * hd * d
    if _moe(cfg):
        f = cfg["moe_intermediate_size"]
        ffn = 3 * d * f * cfg["num_experts_per_tok"] \
            + 3 * d * cfg.get("shared_expert_intermediate_size", 0) \
            + d * cfg["num_experts"]
    else:
        ffn = 3 * d * cfg["intermediate_size"]
    return cfg["num_hidden_layers"] * (attn + ffn) + head_params(cfg)


def attention_flops_per_pair(cfg: Dict) -> int:
    """Operations of one (query, key) pair over every layer: QK^T and
    PV, 2 x 2 x head_dim a head."""
    return 4 * head_dim(cfg) * cfg["num_attention_heads"] \
        * cfg["num_hidden_layers"]


def forward_flops(cfg: Dict, tokens: int, pairs: int) -> int:
    """Forward operations of ``tokens`` tokens that attend over
    ``pairs`` live (query, key) pairs in all."""
    return 2 * matmul_params_per_token(cfg) * tokens \
        + attention_flops_per_pair(cfg) * pairs


def head_params(cfg: Dict) -> int:
    """The LM head's matrix parameters."""
    return cfg["hidden_size"] * cfg["vocab_size"]


def prefill_flops(cfg: Dict, prompt: int) -> int:
    """A one-shot causal prefill of ``prompt`` tokens, with the LM head
    at its last position only."""
    return forward_flops(cfg, prompt, prompt * (prompt + 1) // 2) \
        - 2 * head_params(cfg) * (prompt - 1)


def decode_flops(cfg: Dict, context: int) -> int:
    """One decoded token whose query attends over ``context`` rows (the
    cache and itself)."""
    return forward_flops(cfg, 1, context)


def train_step_flops(cfg: Dict, sequences: int, seq_len: int) -> int:
    """One training step over ``sequences`` causal sequences of
    ``seq_len`` tokens: 3 x the forward."""
    return 3 * sequences * forward_flops(
        cfg, seq_len, seq_len * (seq_len + 1) // 2)
