"""Plain PyTorch versions of decode attention, mirroring
``repro.kernels.decode_attention.ref``: ``decode_attention_ref`` over a
slotted cache and ``paged_decode_attention_ref`` over a paged pool. The
CPU paths of ``ops.decode_attention`` / ``ops.paged_decode_attention``
and the yardsticks the CUDA kernels are held against on the card.

One difference from the JAX oracle, shared with the kernels: a sequence
with ``lengths[b] == 0`` attends to nothing and gets zeros (the online
softmax's ``acc / max(l, 1e-30)`` with ``l = 0``), where a dense softmax
over an all-masked row would average the whole cache. For every
``lengths[b] >= 1`` the two agree."""
from __future__ import annotations

import math

import torch


def paged_decode_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor,
                               block_tables: torch.Tensor,
                               lengths: torch.Tensor, *,
                               scale=None) -> torch.Tensor:
    """Gather each sequence's pages into a contiguous view, then run the
    dense plain version. q: (B, H, D); pools: (N, bs, Hk, D);
    block_tables: (B, nb) physical block per logical page; lengths: (B,)
    valid rows (rows past a sequence's length, whole null or repeated
    pages included, are masked)."""
    b, nb = block_tables.shape
    _, bs, hk, d = k_pool.shape
    tables = block_tables.long()
    k = k_pool[tables].reshape(b, nb * bs, hk, d)
    v = v_pool[tables].reshape(b, nb * bs, hk, d)
    return decode_attention_ref(q, k, v, lengths, scale=scale)


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, lengths: torch.Tensor, *,
                         scale=None, return_lse: bool = False):
    """q: (B, H, D); caches: (B, S, Hk, D); lengths: (B,). With
    ``return_lse`` (o in fp32, unrounded; lse (B, H) fp32, -inf where a
    sequence has no live row), as ``ops.decode_attention``."""
    b, h, d = q.shape
    _, s, hk, _ = k_cache.shape
    g = h // hk
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.reshape(b, hk, g, d).float()
    logits = torch.einsum("bhgd,bshd->bhgs", qg, k_cache.float()) * scale
    lengths = lengths.to(q.device)
    mask = torch.arange(s, device=q.device)[None] < lengths[:, None]
    logits = torch.where(mask[:, None, None], logits,
                         torch.full_like(logits, -1e30))
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", p, v_cache.float())
    live = (lengths > 0)[:, None, None]
    o = o * live.to(o.dtype)[..., None]
    if not return_lse:
        return o.reshape(b, h, d).to(q.dtype)
    lse = torch.where(live, torch.logsumexp(logits, dim=-1),
                      torch.full_like(logits[..., 0], -math.inf))
    return o.reshape(b, h, d), lse.reshape(b, h)
