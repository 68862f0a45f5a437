"""Meshes and the card's constants for the port's accounting: the
counterpart of ``repro.launch.mesh``.

A mesh here is an ordered mapping from axis name to size; nothing is
placed on it. The port runs on one H100, so the production meshes are
abstract, for the dry run's per-device bytes only:

Single pod: (data=16, model=16) = 256 devices.
Multi-pod:  (pod=2, data=16, model=16) = 512 devices.

The hardware constants are one NVIDIA H100 SXM's published peaks
(NVIDIA's data sheet; dense rates, no sparsity, at the full 700 W power
limit). They bound a step from below; they are never a measured time.
There is no interconnect constant: the port computes no collective term.
"""
from __future__ import annotations

from typing import Dict

import torch

PEAK_FLOPS_BF16 = 989e12        # FLOP/s, bf16 and fp16, tensor cores
PEAK_FLOPS_FP32 = 67e12         # FLOP/s, fp32 outside the tensor cores
PEAK_FLOPS = {"bfloat16": PEAK_FLOPS_BF16, "float16": PEAK_FLOPS_BF16,
              "float32": PEAK_FLOPS_FP32}
HBM_BW = 3.35e12                # bytes/s
CHIP_HBM_BYTES = 80e9           # bytes


def make_production_mesh(*, multi_pod: bool = False) -> Dict[str, int]:
    """The reference's production mesh as axis sizes, for accounting."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def make_debug_mesh(data: int = 1, model: int = 1) -> Dict[str, int]:
    """A (data, model) mesh over real cards: raises when fewer than
    ``data * model`` CUDA devices exist (one card: (1, 1))."""
    have = torch.cuda.device_count()
    if have < data * model:
        raise RuntimeError(f"need {data * model} CUDA devices for a "
                           f"({data}, {model}) mesh, found {have}")
    return {"data": data, "model": model}
