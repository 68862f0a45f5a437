"""Checked wrapper of the slotted decode-attention kernel
(``repro_torch/csrc/decode_attention.cu``).

CPU tensors take the plain version (``ref.decode_attention_ref``); CUDA
tensors launch the kernel or raise — there is no fallback from the card.
``decode_attention.launches`` counts wrapper launches (each is the
split-KV pass plus its combine pass).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
MAX_GROUP = 16          # query heads per KV head held by one CTA
TILE = 32               # KV rows per shared-memory tile


def split_rows(b: int, hk: int, s: int, sms: int) -> int:
    """Rows of the KV axis each CTA walks: enough splits that the
    B*Hk*nsplit CTAs fill the card about twice, in whole tiles."""
    tiles = -(-s // TILE)
    nsplit = max(1, min(tiles, -(-2 * sms // (b * hk))))
    return -(-tiles // nsplit) * TILE


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     scale=None) -> torch.Tensor:
    """q: (B, H, D); caches: (B, S, Hk, D); lengths: (B,) int32 valid rows
    per sequence. Returns (B, H, D) in q's dtype."""
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"decode_attention: want q (B,H,D) and caches "
                         f"(B,S,Hk,D), got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    b, h, d = q.shape
    _, s, hk, dk = k_cache.shape
    if k_cache.shape[0] != b or dk != d or hk == 0 or h % hk:
        raise ValueError(f"decode_attention: shapes {tuple(q.shape)} and "
                         f"{tuple(k_cache.shape)} do not form GQA attention")
    if lengths.shape != (b,) or lengths.dtype != torch.int32:
        raise TypeError(f"decode_attention: lengths must be ({b},) int32, got "
                        f"{tuple(lengths.shape)} {lengths.dtype}")
    if not (q.dtype == k_cache.dtype == v_cache.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"decode_attention: want one dtype of {list(_DTYPES)}, "
                        f"got {q.dtype}, {k_cache.dtype}, {v_cache.dtype}")
    if not (q.device == k_cache.device == v_cache.device == lengths.device):
        raise ValueError("decode_attention: tensors on different devices")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, lengths, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for {q.device}")
    if not all(t.is_contiguous() for t in (q, k_cache, v_cache, lengths)):
        raise ValueError("decode_attention: tensors must be contiguous")
    if d > MAX_HEAD_DIM or h // hk > MAX_GROUP or 0 in (b, s):
        raise ValueError(f"decode_attention: kernel takes head_dim <= "
                         f"{MAX_HEAD_DIM}, H/Hk <= {MAX_GROUP} and non-empty "
                         f"caches, got D={d}, H/Hk={h // hk}, B={b}, S={s}")
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    chunk = split_rows(b, hk, s, sms)
    nsplit = -(-s // chunk)
    g = h // hk
    f32 = dict(dtype=torch.float32, device=q.device)
    pm = torch.empty((b, hk, nsplit, g), **f32)
    pl = torch.empty((b, hk, nsplit, g), **f32)
    pacc = torch.empty((b, hk, nsplit, g, d), **f32)
    o = torch.empty_like(q)
    fn = _build.entry("decode_attention_fwd")
    with torch.cuda.device(q.device):     # launches go to q's card
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                  lengths.data_ptr(), pm.data_ptr(), pl.data_ptr(),
                  pacc.data_ptr(), o.data_ptr(), b, s, h, hk, d, chunk,
                  float(scale), _DTYPES[q.dtype], stream)
    _build.check(code, "decode_attention")
    decode_attention.launches += 1
    return o


decode_attention.launches = 0
