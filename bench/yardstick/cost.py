"""Operations and least bytes of one call of the port's attention
kernels, counted from its shapes.

A frozen copy of ``live_pairs`` (``repro_torch/kernels/cost.py``),
``flash_attention_cost`` (``kernels/flash_attention/ops.py``) and
``decode_attention_cost`` (``kernels/decode_attention/ops.py``) as the
port had them when the benchmark was defined, so that the roofline
shares do not move when the program's copies change. Counted as a
roofline counts: each input byte read once and each output byte written
once, whatever a kernel reads again; live operations only, so a causal
mask counts the (query, key) pairs it keeps.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence


@dataclass(frozen=True)
class Cost:
    """One call's operations and bytes."""
    flops: int
    bytes: int


def live_pairs(sq: int, sk: int, *, causal: bool, window: int = 0,
               q_offset: Optional[Sequence[int]] = None,
               kv_len: Optional[Sequence[int]] = None, batch: int = 1
               ) -> int:
    """(query, key) pairs the flash mask keeps, summed over the batch.
    Query row i of sequence b sits at position ``q_offset[b] + i``; key
    k is live when k < ``kv_len[b]``, with ``causal`` k <= the query's
    position, and with ``window`` > 0 position - k < ``window``."""
    offs = list(q_offset) if q_offset is not None else [0] * batch
    lens = list(kv_len) if kv_len is not None else [sk] * batch
    if len(offs) != len(lens):
        raise ValueError(f"live_pairs: {len(offs)} offsets for "
                         f"{len(lens)} lengths")
    total = 0
    for off, n in zip(offs, lens):
        n = min(n, sk)
        for i in range(sq):
            pos = off + i
            hi = min(pos + 1, n) if causal else n
            lo = max(pos - window + 1, 0) if window > 0 else 0
            total += max(hi - lo, 0)
    return total


def causal_pairs(s: int) -> int:
    """Live pairs of one causal sequence of ``s`` rows from position 0:
    ``live_pairs(s, s, causal=True)`` in closed form."""
    return s * (s + 1) // 2


def flash_attention_cost(q_shape, k_shape, *, causal: bool = True,
                         window: int = 0,
                         q_offset: Optional[Sequence[int]] = None,
                         kv_len: Optional[Sequence[int]] = None,
                         return_lse: bool = False, itemsize: int = 2
                         ) -> Cost:
    """One flash-attention call's least work. q (B, Sq, H, D), k and v
    (B, Sk, Hk, D) of ``itemsize`` bytes. Operations: 4 D H a live
    (query, key) pair (QK^T and PV). Bytes: q read and o written, the K
    and V rows below each ``kv_len`` read, each int32 length vector
    read, and the fp32 lse written when asked for."""
    b, sq, h, d = q_shape
    _, sk, hk, _ = k_shape
    if q_offset is None and kv_len is None and causal and not window \
            and sq == sk:
        pairs = b * causal_pairs(sq)
    else:
        pairs = live_pairs(sq, sk, causal=causal, window=window,
                           q_offset=q_offset, kv_len=kv_len, batch=b)
    kv_rows = sum(min(n, sk) for n in kv_len) if kv_len is not None \
        else b * sk
    nbytes = itemsize * (2 * b * sq * h * d + 2 * kv_rows * hk * d)
    nbytes += 4 * b * ((q_offset is not None) + (kv_len is not None))
    if return_lse:
        nbytes += 4 * b * h * sq
    return Cost(4 * d * h * pairs, nbytes)


def decode_attention_cost(b: int, h: int, hk: int, d: int, *,
                          live_rows: int, itemsize: int = 2,
                          pages: int = 0, return_lse: bool = False) -> Cost:
    """One decode call's least work over ``live_rows`` cache rows in all
    (the sum of the lengths): 4 D H operations a live row; bytes: the
    live K and V rows (Hk D each) and q read, o written, the int32
    lengths read, and with ``pages`` > 0 the (B, pages) int32 block
    tables read. With ``return_lse`` o is written in fp32 and the (B, H)
    fp32 log-sum-exp besides."""
    out = (4 * b * h * d + 4 * b * h) if return_lse else itemsize * b * h * d
    nbytes = itemsize * (2 * live_rows * hk * d + b * h * d) + out \
        + 4 * b + 4 * b * pages
    return Cost(4 * d * live_rows * h, nbytes)
