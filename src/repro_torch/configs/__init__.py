"""Architecture registry of the port: ``--arch <id>`` lookup.

The port carries every architecture of the reference registry, in its
order, each served and trained: the encoder-decoder (seamless-m4t-medium,
an audio frontend's frames through an encoder and cross-attention), the
dense all-global-attention decoders (qwen2-1.5b, llama3.2-3b,
chatglm3-6b) and the vision-language decoder (llava-next-mistral-7b,
projected patch rows ahead of the prompt), gemma3-1b's 5:1
local:global attention, RecurrentGemma's hybrid of RG-LRU and local
attention, the MoE decoders (qwen2-moe-a2.7b, qwen3-moe-235b-a22b) and
xLSTM's mLSTM/sLSTM stack (xlstm-350m).
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

ARCH_IDS: List[str] = ["seamless_m4t_medium", "qwen2_moe_a2_7b",
                       "llava_next_mistral_7b", "recurrentgemma_9b",
                       "gemma3_1b", "llama3_2_3b", "qwen3_moe_235b_a22b",
                       "qwen2_1_5b", "xlstm_350m", "chatglm3_6b"]

_ALIASES = {"seamless-m4t-medium": "seamless_m4t_medium",
            "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
            "llava-next-mistral-7b": "llava_next_mistral_7b",
            "recurrentgemma-9b": "recurrentgemma_9b",
            "gemma3-1b": "gemma3_1b",
            "llama3.2-3b": "llama3_2_3b",
            "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
            "qwen2-1.5b": "qwen2_1_5b",
            "xlstm-350m": "xlstm_350m",
            "chatglm3-6b": "chatglm3_6b"}


def canonical(name: str) -> str:
    return _ALIASES.get(name, name.replace("-", "_").replace(".", "_"))


def get_config(name: str) -> ModelConfig:
    arch = canonical(name)
    if arch not in ARCH_IDS:
        raise ValueError(f"unknown architecture {name!r}; the port runs "
                         f"{ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{arch}").CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
