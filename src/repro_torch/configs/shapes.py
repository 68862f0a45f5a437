"""The four assigned input shapes and per-(arch, shape) input specs: the
counterpart of ``repro.configs.shapes``.

``input_specs`` returns tensors on ``torch.device("meta")`` for every
model input (shapes and dtypes, no memory, no device), which is what the
port's dry run (``repro_torch.launch.dryrun``) counts a step against.

Shape semantics:
  train_4k     seq 4096,   global_batch 256 — the train step
  prefill_32k  seq 32768,  global_batch 32  — prefill (prompt pass)
  decode_32k   seq 32768,  global_batch 128 — decode_step (1 token, full cache)
  long_500k    seq 524288, global_batch 1   — decode_step, sub-quadratic only

long_500k eligibility: archs with at least one non-global-attention
mechanism (recurrent state or sliding window) run it; pure
full-attention archs are skipped, as in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Union

import torch

from repro_torch.models.config import ModelConfig


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def supports_long_context(cfg: ModelConfig) -> bool:
    return any(k != "attn" for k in cfg.layer_kinds)


def shape_applicable(cfg: ModelConfig, shape: str) -> bool:
    if shape == "long_500k":
        return supports_long_context(cfg)
    return True


def resolve(shape: Union[str, InputShape]) -> InputShape:
    """A shape by name from ``SHAPES``, or an ``InputShape`` as given
    (another serving or training geometry)."""
    return SHAPES[shape] if isinstance(shape, str) else shape


def _meta(dtype, *shape) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: Union[str, InputShape],
                batch_override: Optional[int] = None
                ) -> Dict[str, torch.Tensor]:
    """Model inputs of (arch, shape) as meta tensors.

    train/prefill return the batch dict ``forward`` / ``prefill`` read
    (int32 tokens and labels, fp32 ``embeds`` for a vision or audio
    frontend); decode returns {"token", "cache_len"}: the cache is state,
    not input, and comes from ``init_cache(..., device="meta")`` at
    ``decode_context``'s geometry."""
    s = resolve(shape)
    b = batch_override or s.global_batch
    seq = s.seq_len
    i32, f32 = torch.int32, torch.float32

    if s.kind in ("train", "prefill"):
        specs: Dict[str, torch.Tensor] = {}
        if cfg.arch_type == "vlm":
            ft = cfg.frontend_tokens
            specs["embeds"] = _meta(f32, b, ft, cfg.frontend_dim)
            specs["tokens"] = _meta(i32, b, seq - ft)
        elif cfg.arch_type == "audio":
            # encoder consumes seq frames; decoder consumes seq tokens
            specs["embeds"] = _meta(f32, b, seq, cfg.frontend_dim)
            specs["tokens"] = _meta(i32, b, seq)
        else:
            specs["tokens"] = _meta(i32, b, seq)
        if s.kind == "train":
            specs["labels"] = _meta(i32, b, seq)
        return specs

    return {"token": _meta(i32, b), "cache_len": _meta(i32, b)}


def decode_context(cfg: ModelConfig, shape: Union[str, InputShape]
                   ) -> Dict[str, int]:
    """Cache geometry for decode shapes: max context + encoder src length."""
    s = resolve(shape)
    src = s.seq_len if cfg.arch_type == "audio" else 0
    return {"batch": s.global_batch, "max_len": s.seq_len, "src_len": src}
