"""Architecture registry of the port: ``--arch <id>`` lookup.

The port carries the configs its slices can run: the dense all-global-
attention decoders (served and trained) and RecurrentGemma's hybrid of
RG-LRU and local attention (trained; its serving path is a later
slice). The other architectures of ``repro.configs`` come with the
slices that port their block kinds.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

ARCH_IDS: List[str] = ["qwen2_1_5b", "recurrentgemma_9b"]

_ALIASES = {"qwen2-1.5b": "qwen2_1_5b",
            "recurrentgemma-9b": "recurrentgemma_9b"}


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
