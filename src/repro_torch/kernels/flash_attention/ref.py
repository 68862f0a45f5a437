"""Plain PyTorch version of prefill flash attention: naive full-matrix
softmax, mirroring ``repro.kernels.flash_attention.ref.attention_ref``.
O(S^2) memory. The CPU path of ``ops.flash_attention`` and the yardstick
the CUDA kernel is held against on the card."""
from __future__ import annotations

import math

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  scale=None) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Sk, Hk, D) with Hk | H (GQA)."""
    b, sq, h, d = q.shape
    _, sk, hk, _ = k.shape
    g = h // hk
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.reshape(b, sq, hk, g, d).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    qp = torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp >= kp
    if window > 0:
        mask &= qp - kp < window
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(b, sq, h, d).to(q.dtype)
