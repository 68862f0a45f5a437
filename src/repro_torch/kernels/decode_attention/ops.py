"""Checked wrappers of the decode-attention kernels
(``repro_torch/csrc/decode_attention.cu``): ``decode_attention`` over a
slotted (B, S, Hk, D) cache and ``paged_decode_attention`` over a shared
(N, bs, Hk, D) pool addressed by block tables.

CPU tensors take the plain versions (``ref.py``); CUDA tensors launch
the kernel or raise — there is no fallback from the card. Each wrapper's
``.launches`` counts its launches (each is the split-KV pass plus its
combine pass); ``decode_attention.lse_launches`` counts those of them
with ``return_lse``. Meta tensors launch nothing: each wrapper returns an
empty output and adds its cost function's count to the active
``kernels.cost.KernelCount``; meta lengths hold no values, so such a call
counts every row of the cache (or of each table's pages) as live, as a
full cache holds them.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.cost import Cost, count_meta_call
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref, paged_decode_attention_ref)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256     # the kernel's classes: head_dim <= 128, and 129 .. 256
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
                     scale=None, return_lse: bool = False):
    """q: (B, H, D); caches: (B, S, Hk, D); lengths: (B,) int32 valid rows
    per sequence. Returns (B, H, D) in q's dtype; with ``return_lse``
    (o, lse): o (B, H, D) in fp32, unrounded, and lse (B, H) fp32, each
    head's log-sum-exp of its scaled scores over the live rows, -inf
    where a sequence has none (there o is zeros): a partial over a range
    of rows, for ``sharding.rules.combine_partials``."""
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
        return decode_attention_ref(q, k_cache, v_cache, lengths, scale=scale,
                                    return_lse=return_lse)
    if q.device.type == "meta":
        count_meta_call("decode_attention", decode_attention_cost(
            b, h, hk, d, live_rows=b * s, itemsize=q.element_size(),
            return_lse=return_lse))
        if return_lse:
            return (torch.empty(q.shape, dtype=torch.float32, device="meta"),
                    torch.empty((b, h), dtype=torch.float32, device="meta"))
        return torch.empty_like(q)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for {q.device}")
    if not all(t.is_contiguous() for t in (q, k_cache, v_cache, lengths)):
        raise ValueError("decode_attention: tensors must be contiguous")
    if d > MAX_HEAD_DIM or h // hk > MAX_GROUP or 0 in (b, s):
        raise ValueError(f"decode_attention: kernel takes head_dim <= "
                         f"{MAX_HEAD_DIM}, H/Hk <= {MAX_GROUP} and non-empty "
                         f"caches, got D={d}, H/Hk={h // hk}, B={b}, S={s}")
    o, parts, chunk = _split_scratch(q, hk, s)
    o32 = lse = None
    if return_lse:
        o32 = torch.empty(q.shape, dtype=torch.float32, device=q.device)
        lse = torch.empty((b, h), dtype=torch.float32, device=q.device)
    fn = _build.entry("decode_attention_fwd")
    with torch.cuda.device(q.device):     # launches go to q's card
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                  lengths.data_ptr(), *(t.data_ptr() for t in parts),
                  o.data_ptr(), None if o32 is None else o32.data_ptr(),
                  None if lse is None else lse.data_ptr(), b, s, h, hk, d,
                  chunk, float(scale), _DTYPES[q.dtype], stream)
    _build.check(code, "decode_attention")
    _build.count_launch(decode_attention,
                        "lse_launches" if return_lse else "")
    return (o32, lse) if return_lse else o


decode_attention.launches = 0
decode_attention.lse_launches = 0


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tables: torch.Tensor,
                           lengths: torch.Tensor, *,
                           scale=None) -> torch.Tensor:
    """q: (B, H, D); pools: (N, bs, Hk, D); block_tables: (B, nb) int32
    physical block per logical page (block 0 is the null block);
    lengths: (B,) int32 valid rows. Returns (B, H, D) in q's dtype.
    Pages at or past ``lengths[b]`` are never read. The KV axis splits
    as the slotted wrapper's does over ``nb * bs`` rows, so a sequence
    gets the same result here as from a slotted cache holding the same
    rows."""
    if q.dim() != 3 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"paged_decode_attention: want q (B,H,D) and pools "
                         f"(N,bs,Hk,D), got {tuple(q.shape)}, "
                         f"{tuple(k_pool.shape)}, {tuple(v_pool.shape)}")
    b, h, d = q.shape
    _, bs, hk, dk = k_pool.shape
    if dk != d or hk == 0 or h % hk:
        raise ValueError(f"paged_decode_attention: shapes {tuple(q.shape)} "
                         f"and {tuple(k_pool.shape)} do not form GQA "
                         f"attention")
    if block_tables.dim() != 2 or block_tables.shape[0] != b \
            or block_tables.dtype != torch.int32:
        raise TypeError(f"paged_decode_attention: block_tables must be "
                        f"({b}, nb) int32, got {tuple(block_tables.shape)} "
                        f"{block_tables.dtype}")
    if lengths.shape != (b,) or lengths.dtype != torch.int32:
        raise TypeError(f"paged_decode_attention: lengths must be ({b},) "
                        f"int32, got {tuple(lengths.shape)} {lengths.dtype}")
    if not (q.dtype == k_pool.dtype == v_pool.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"paged_decode_attention: want one dtype of "
                        f"{list(_DTYPES)}, got {q.dtype}, {k_pool.dtype}, "
                        f"{v_pool.dtype}")
    if not (q.device == k_pool.device == v_pool.device == block_tables.device
            == lengths.device):
        raise ValueError("paged_decode_attention: tensors on different "
                         "devices")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pool, v_pool, block_tables,
                                          lengths, scale=scale)
    if q.device.type == "meta":
        nb = block_tables.shape[1]
        count_meta_call("paged_decode_attention", decode_attention_cost(
            b, h, hk, d, live_rows=b * nb * bs, itemsize=q.element_size(),
            pages=nb))
        return torch.empty_like(q)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: no kernel for {q.device}")
    if not all(t.is_contiguous()
               for t in (q, k_pool, v_pool, block_tables, lengths)):
        raise ValueError("paged_decode_attention: tensors must be contiguous")
    nb = block_tables.shape[1]
    if d > MAX_HEAD_DIM or h // hk > MAX_GROUP or 0 in (b, nb, bs):
        raise ValueError(f"paged_decode_attention: kernel takes head_dim <= "
                         f"{MAX_HEAD_DIM}, H/Hk <= {MAX_GROUP} and non-empty "
                         f"tables, got D={d}, H/Hk={h // hk}, B={b}, "
                         f"nb={nb}, bs={bs}")
    o, parts, chunk = _split_scratch(q, hk, nb * bs)
    fn = _build.entry("paged_decode_attention_fwd")
    with torch.cuda.device(q.device):     # launches go to q's card
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                  block_tables.data_ptr(), lengths.data_ptr(),
                  *(t.data_ptr() for t in parts), o.data_ptr(), b, nb, bs,
                  h, hk, d, chunk, float(scale), _DTYPES[q.dtype], stream)
    _build.check(code, "paged_decode_attention")
    _build.count_launch(paged_decode_attention)
    return o


paged_decode_attention.launches = 0


def decode_attention_cost(b: int, h: int, hk: int, d: int, *,
                          live_rows: int, itemsize: int = 2,
                          pages: int = 0, return_lse: bool = False) -> Cost:
    """One decode call's least work over ``live_rows`` cache rows in all
    (the sum of the lengths): 4 D H operations a live row (q.k and p v);
    bytes: the live K and V rows (Hk D each) and q read, o written, the
    int32 lengths read, and with ``pages`` > 0 (the paged entry) the
    (B, pages) int32 block tables read. With ``return_lse`` o is written
    in fp32 and the (B, H) fp32 log-sum-exp besides."""
    out = (4 * b * h * d + 4 * b * h) if return_lse else itemsize * b * h * d
    nbytes = itemsize * (2 * live_rows * hk * d + b * h * d) + out \
        + 4 * b + 4 * b * pages
    return Cost(4 * d * live_rows * h, nbytes)


def _split_scratch(q: torch.Tensor, hk: int, s: int):
    """The output, the fp32 split partials (m, l, acc), and the rows
    each split walks, for ``s`` addressable rows a sequence."""
    b, h, d = q.shape
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    chunk = split_rows(b, hk, s, sms)
    nsplit = -(-s // chunk)
    g = h // hk
    f32 = dict(dtype=torch.float32, device=q.device)
    pm = torch.empty((b, hk, nsplit, g), **f32)
    pl = torch.empty((b, hk, nsplit, g), **f32)
    pacc = torch.empty((b, hk, nsplit, g, d), **f32)
    return torch.empty_like(q), (pm, pl, pacc), chunk
