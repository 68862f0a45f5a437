"""Architecture registry of the port: ``--arch <id>`` lookup.

The port carries the configs its slices can run, each served and
trained: the dense all-global-attention decoders (qwen2-1.5b,
llama3.2-3b, chatglm3-6b), gemma3-1b's 5:1 local:global attention, and
RecurrentGemma's hybrid of RG-LRU and local attention. The other
architectures of ``repro.configs`` (MoE, xLSTM, the encoder-decoder and
the frontends) come with the slices that port their block kinds.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

ARCH_IDS: List[str] = ["recurrentgemma_9b", "gemma3_1b", "llama3_2_3b",
                       "qwen2_1_5b", "chatglm3_6b"]

_ALIASES = {"recurrentgemma-9b": "recurrentgemma_9b",
            "gemma3-1b": "gemma3_1b",
            "llama3.2-3b": "llama3_2_3b",
            "qwen2-1.5b": "qwen2_1_5b",
            "chatglm3-6b": "chatglm3_6b"}


def canonical(name: str) -> str:
    return _ALIASES.get(name, name.replace("-", "_").replace(".", "_"))


def get_config(name: str) -> ModelConfig:
    arch = canonical(name)
    if arch not in ARCH_IDS:
        raise ValueError(f"architecture {name!r} is not ported yet; the "
                         f"port runs {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{arch}").CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
