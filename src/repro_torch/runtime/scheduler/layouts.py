"""KV-cache layouts of the port's scheduler.

Counterpart of ``repro.runtime.scheduler.layouts``; this slice ports the
slotted layout. The paged block pool comes with a later slice (queue 1,
item 6).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.runtime.scheduler.types import SchedulerConfig

__all__ = ["SlottedLayout"]


class SlottedLayout:
    """Dense per-slot KV rows: slot ``i`` owns rows ``[i, :max_len]`` of
    every layer's cache, so admission needs no reservation and release
    frees nothing (a reused slot's rows are overwritten at insert)."""

    def __init__(self, cfg: ModelConfig, s: SchedulerConfig, max_len: int,
                 model: T.Transformer):
        self.max_len = max_len
        self.model = model
        self.cache = T.init_cache(cfg, s.max_slots, max_len,
                                  device=model.device)

    def insert(self, req_cache: T.Cache, slot: int) -> None:
        """Copy a batch=1 prefill cache into slot ``slot`` of the shared
        cache, in place."""
        for big, small in zip(self.cache, req_cache):
            big["k"][slot].copy_(small["k"][0])
            big["v"][slot].copy_(small["v"][0])

    def decode(self, tokens: torch.Tensor,
               cache_len: torch.Tensor) -> torch.Tensor:
        """One decode step over every slot; the cache updates in place."""
        logits, _, _ = T.decode_step(self.model, tokens, self.cache,
                                     cache_len)
        return logits

    def kv_stats(self, s: SchedulerConfig,
                 cfg: ModelConfig) -> Dict[str, float]:
        row = T.kv_row_bytes(cfg)
        return {"slotted_kv_reserved_bytes":
                float(s.max_slots * s.max_len * row)}
