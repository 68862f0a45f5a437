"""Plain PyTorch version of prefill flash attention: naive full-matrix
softmax, mirroring ``repro.kernels.flash_attention.ref.attention_ref``
and, with ``q_offset`` / ``kv_len``, the ragged branch of ``_fa_mask``
in ``repro.models.layers``. O(S^2) memory. The CPU path of
``ops.flash_attention`` and the yardstick the CUDA kernel is held
against on the card."""
from __future__ import annotations

import math
from typing import Optional

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0, scale=None,
                  q_offset: Optional[torch.Tensor] = None,
                  kv_len: Optional[torch.Tensor] = None,
                  return_lse: bool = False):
    """q: (B, Sq, H, D); k, v: (B, Sk, Hk, D) with Hk | H (GQA).
    ``q_offset`` (B,): absolute position of q's row 0 (default 0);
    ``kv_len`` (B,): keys at or past it are masked (default Sk).
    ``return_lse`` also returns the fp32 log-sum-exp of each row's
    scaled, masked scores, (B, H, Sq): ``(o, lse)``."""
    b, sq, h, d = q.shape
    _, sk, hk, _ = k.shape
    g = h // hk
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.reshape(b, sq, hk, g, d).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    qp = torch.arange(sq, device=q.device)[None, :, None]       # (1, Sq, 1)
    if q_offset is not None:
        qp = qp + q_offset.to(q.device).long()[:, None, None]
    kp = torch.arange(sk, device=q.device)[None, None, :]       # (1, 1, Sk)
    mask = torch.ones((1, sq, sk), dtype=torch.bool, device=q.device)
    if kv_len is not None:
        mask = mask & (kp < kv_len.to(q.device).long()[:, None, None])
    if causal:
        mask = mask & (qp >= kp)
    if window > 0:
        mask = mask & (qp - kp < window)
    s = torch.where(mask[:, None, None], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    o = o.reshape(b, sq, h, d).to(q.dtype)
    if not return_lse:
        return o
    return o, torch.logsumexp(s, dim=-1).reshape(b, h, sq)
