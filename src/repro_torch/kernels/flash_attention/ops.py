"""Checked wrapper of the prefill flash-attention kernel
(``repro_torch/csrc/flash_attention.cu``).

CPU tensors take the plain version (``ref.attention_ref``); CUDA tensors
launch the kernel or raise — there is no fallback from the card.
``flash_attention.launches`` counts kernel launches. The kernel takes
head dims up to 256 (instantiated for 128 and 256) and optionally
returns the rows' log-sum-exp, which the training backward reads. bf16
runs its tensor-core body (any number of query heads per KV head), fp32
its FMA body (at most ``MAX_GROUP_FP32`` query heads per KV head).
Meta tensors launch nothing: the wrapper returns empty outputs and adds
``flash_attention_cost`` to the active ``kernels.cost.KernelCount``.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.cost import Cost, count_meta_call, live_pairs
from repro_torch.kernels.flash_attention.ref import attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
MAX_GROUP_FP32 = 64     # query heads per KV head in one fp32 q-tile


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, scale=None,
                    q_offset: Optional[torch.Tensor] = None,
                    kv_len: Optional[torch.Tensor] = None,
                    return_lse: bool = False):
    """q: (B, Sq, H, D); k, v: (B, Sk, Hk, D) with Hk | H. Returns
    (B, Sq, H, D) in q's dtype. Ragged lengths are fine: no block size
    has to divide Sq or Sk. ``q_offset`` (B,) int32 puts q's row i of
    sequence b at absolute position ``q_offset[b] + i``; ``kv_len`` (B,)
    int32 masks keys at or past ``kv_len[b]`` (chunked prefill and
    prefix resume extend a cache this way). Absent, they are 0 and Sk.
    ``return_lse`` also returns the fp32 log-sum-exp of each row's
    scaled, masked scores, (B, H, Sq): ``(o, lse)``."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: want q (B,Sq,H,D) and k, v "
                         f"(B,Sk,Hk,D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, d = q.shape
    _, sk, hk, dk = k.shape
    if k.shape[0] != b or dk != d or hk == 0 or h % hk:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)} and "
                         f"{tuple(k.shape)} do not form GQA attention")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: want one dtype of "
                        f"{list(_DTYPES)}, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k and v on different devices")
    for name, t in (("q_offset", q_offset), ("kv_len", kv_len)):
        if t is not None and (t.shape != (b,) or t.dtype != torch.int32
                              or t.device != q.device):
            raise TypeError(f"flash_attention: {name} must be ({b},) int32 "
                            f"on {q.device}, got {tuple(t.shape)} {t.dtype} "
                            f"on {t.device}")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             scale=scale, q_offset=q_offset, kv_len=kv_len,
                             return_lse=return_lse)
    if q.device.type == "meta":
        if q_offset is not None or kv_len is not None:
            raise ValueError("flash_attention: meta q_offset / kv_len hold "
                             "no lengths to count the live pairs by")
        count_meta_call("flash_attention", flash_attention_cost(
            q.shape, k.shape, causal=causal, window=window,
            return_lse=return_lse, itemsize=q.element_size()))
        o = torch.empty_like(q)
        lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
        return (o, lse) if return_lse else o
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    if not all(t.is_contiguous() for t in (q, k, v, q_offset, kv_len)
               if t is not None):
        raise ValueError("flash_attention: tensors must be contiguous")
    fp32_group = q.dtype == torch.float32 and h // hk > MAX_GROUP_FP32
    if d > MAX_HEAD_DIM or fp32_group or 0 in (b, sq, sk):
        raise ValueError(f"flash_attention: kernel takes head_dim <= "
                         f"{MAX_HEAD_DIM}, in fp32 H/Hk <= {MAX_GROUP_FP32}, "
                         f"and non-empty sequences, got D={d}, "
                         f"H/Hk={h // hk}, {q.dtype}, Sq={sq}, Sk={sk}")
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    fn = _build.entry("flash_attention_fwd")
    with torch.cuda.device(q.device):     # launches go to q's card
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  _ptr(q_offset), _ptr(kv_len), _ptr(lse), b, sq, sk, h, hk,
                  d, int(causal), int(window), float(scale),
                  _DTYPES[q.dtype], stream)
    _build.check(code, "flash_attention")
    _build.count_launch(flash_attention)
    return (o, lse) if return_lse else o


flash_attention.launches = 0


def flash_attention_cost(q_shape, k_shape, *, causal: bool = True,
                         window: int = 0,
                         q_offset: Optional[Sequence[int]] = None,
                         kv_len: Optional[Sequence[int]] = None,
                         return_lse: bool = False, itemsize: int = 2
                         ) -> Cost:
    """One ``flash_attention`` call's least work. q (B, Sq, H, D), k and
    v (B, Sk, Hk, D) of ``itemsize`` bytes; ``q_offset`` / ``kv_len``
    the values of the per-sequence tensors, if any. Operations: 4 D H a
    live (query, key) pair (QK^T and P V). Bytes: q read and o written,
    the K and V rows below each ``kv_len`` read, each int32 length
    vector read, and the fp32 lse written when asked for."""
    b, sq, h, d = q_shape
    _, sk, hk, _ = k_shape
    pairs = live_pairs(sq, sk, causal=causal, window=window,
                       q_offset=q_offset, kv_len=kv_len, batch=b)
    kv_rows = sum(min(n, sk) for n in kv_len) if kv_len is not None \
        else b * sk
    nbytes = itemsize * (2 * b * sq * h * d + 2 * kv_rows * hk * d)
    nbytes += 4 * b * ((q_offset is not None) + (kv_len is not None))
    if return_lse:
        nbytes += 4 * b * h * sq
    return Cost(4 * d * h * pairs, nbytes)


def _ptr(t: Optional[torch.Tensor]):
    """Device pointer of an optional argument; None passes a null."""
    return None if t is None else t.data_ptr()
