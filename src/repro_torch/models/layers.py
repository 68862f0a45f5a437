"""Transformer building blocks of the port: norms, RoPE, GQA attention, MLP.

Counterpart of ``repro.models.layers`` for the ``attn`` and
``attn_local`` block kinds. The
functions keep the reference's layouts — activations (B, S, D), heads
(B, S, H, hd), ``wq`` (d, h, hd), ``wo`` (h, hd, d) — so the parity tests
compare like with like. Attention goes through the port's kernel
wrappers (``repro_torch.kernels``): on the card the hand-written CUDA
kernels, on the CPU their plain versions. Where the reference returns an
updated cache, the port writes its cache (a slotted cache, a scratch
cache or a paged pool) in place.

Training (``attn_apply``, the encoder's ``attn_encoder_apply`` and the
decoder's ``cross_attn_apply``) differentiates through the flash kernel
with ``FlashAttention``, a ``torch.autograd.Function`` whose backward is
a port of the reference's custom-VJP backward ``_fa_bwd`` in torch ops:
blockwise recompute of P from (q, k, lse), the reference's XLA code.
The encoder and cross-attention attend over every key (``causal=False``,
cross-attention with Sq != Sk); at decode a layer's cached cross K/V go
through the slotted decode kernel (``cross_attn_decode``).
"""
from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.decode_attention.ops import (decode_attention,
                                                      paged_decode_attention)
from repro_torch.kernels.flash_attention.ops import flash_attention

# ---------------------------------------------------------------------------
# norms / activations
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with the variance in fp32 but the elementwise math in
    x.dtype, as the reference computes it."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * (1.0 + scale).to(x.dtype)


def act_fn(name: str):
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, rot_dim: int, theta: float,
               device=None) -> torch.Tensor:
    """Inverse frequencies for the first ``rot_dim`` dims of a head."""
    exps = torch.arange(0, rot_dim, 2, dtype=torch.float32,
                        device=device) / rot_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               rope_fraction: float = 1.0) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int. Rotates the first
    ``rope_fraction * D`` dims as two halves (NeoX style), in fp32."""
    d = x.shape[-1]
    rot = int(d * rope_fraction)
    rot -= rot % 2
    inv = rope_freqs(d, rot, theta, device=x.device)        # (rot/2,)
    ang = positions.float()[..., None] * inv                # (B, S, rot/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :rot].float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return torch.cat([out.to(x.dtype), x[..., rot:]], dim=-1)


# ---------------------------------------------------------------------------
# the flash backward (training)
# ---------------------------------------------------------------------------

def _ceil_to(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _fa_mask(qp: torch.Tensor, kp: torch.Tensor, causal: bool, window: int,
             sk_valid: int) -> torch.Tensor:
    """(bq, bk) mask of one (q-block, k-block) tile: the static path of
    the reference's ``_fa_mask`` (no ragged ``kv_len``), with the
    zero-padded kv tail at or past ``sk_valid`` masked."""
    mask = (kp[None, :] < sk_valid).expand(qp.shape[0], kp.shape[0])
    if causal:
        mask = mask & (qp[:, None] >= kp[None, :])
    if window > 0:
        mask = mask & (qp[:, None] - kp[None, :] < window)
    return mask


def _pad_seq(x: torch.Tensor, n: int) -> torch.Tensor:
    """Zero-pad dim 1 by ``n`` rows."""
    if not n:
        return x
    return torch.cat([x, x.new_zeros((x.shape[0], n) + x.shape[2:])], dim=1)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool, window: int, chunk: int,
                        scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flash-attention backward, a port of the reference's ``_fa_bwd``:
    P is recomputed blockwise from (q, k, lse) in fp32, with bq = bk =
    ``min(chunk, ceil8(S))``, O(bq * bk) live score memory (on the meta
    device, one block of the padded lengths). q, o, do:
    (B, Sq, H, D); k, v: (B, Sk, Hk, D); lse: (B, H, Sq) fp32 from the
    forward. Returns (dq, dk, dv) in the inputs' dtypes."""
    b, sq, h, d = q.shape
    _, sk, hk, _ = k.shape
    g = h // hk
    dev = q.device
    bq = min(chunk, _ceil_to(sq, 8))
    bk = min(chunk, _ceil_to(sk, 8))
    nq, nk = -(-sq // bq), -(-sk // bk)
    if q.device.type == "meta":
        # no value flows between blocks on the meta device: one block of
        # the padded lengths does every block's operations (the dry run)
        bq, nq, bk, nk = nq * bq, 1, nk * bk, 1
    pq, pk = nq * bq - sq, nk * bk - sk
    f32 = torch.float32
    qf = _pad_seq(q, pq).reshape(b, nq, bq, hk, g, d)
    dof = _pad_seq(do.to(f32), pq).reshape(b, nq, bq, hk, g, d)
    # delta = rowsum(dout * out)  (B, Hk, g, nq, bq)
    delta = torch.einsum("bshd,bshd->bhs", do.to(f32), o.to(f32))
    delta = _pad_seq(delta.transpose(1, 2), pq).transpose(1, 2) \
        .reshape(b, hk, g, nq, bq)
    lsef = _pad_seq(lse.reshape(b, h, sq).transpose(1, 2), pq) \
        .transpose(1, 2).reshape(b, hk, g, nq, bq)
    kf = _pad_seq(k, pk).reshape(b, nk, bk, hk, d)
    vf = _pad_seq(v, pk).reshape(b, nk, bk, hk, d)
    q_pos = torch.arange(nq * bq, device=dev).reshape(nq, bq)
    k_pos = torch.arange(nk * bk, device=dev).reshape(nk, bk)
    dk = torch.zeros((b, nk * bk, hk, d), dtype=f32, device=dev)
    dv = torch.zeros((b, nk * bk, hk, d), dtype=f32, device=dev)
    dqs = []
    for i in range(nq):
        qb, dob = qf[:, i].to(f32), dof[:, i]
        dl, ls = delta[..., i, :], lsef[..., i, :]
        dq = torch.zeros((b, bq, hk, g, d), dtype=f32, device=dev)
        dk_blks, dv_blks = [], []
        for j in range(nk):
            kb, vb = kf[:, j].to(f32), vf[:, j].to(f32)
            s = torch.einsum("bqhgd,bkhd->bhgqk", qb, kb) * scale
            mask = _fa_mask(q_pos[i], k_pos[j], causal, window, sk)
            s = torch.where(mask, s, torch.full_like(s, -1e30))
            p = torch.exp(s - ls[..., None])                # (B,Hk,g,bq,bk)
            dv_blks.append(torch.einsum("bhgqk,bqhgd->bkhd", p, dob))
            dp = torch.einsum("bqhgd,bkhd->bhgqk", dob, vb)
            ds = p * (dp - dl[..., None]) * scale
            dq = dq + torch.einsum("bhgqk,bkhd->bqhgd", ds, kb)
            dk_blks.append(torch.einsum("bhgqk,bqhgd->bkhd", ds, qb))
        dk = dk + torch.cat(dk_blks, dim=1)
        dv = dv + torch.cat(dv_blks, dim=1)
        dqs.append(dq)
    dq = torch.stack(dqs, dim=1).reshape(b, nq * bq, h, d)
    return (dq[:, :sq].to(q.dtype), dk[:, :sk].to(k.dtype),
            dv[:, :sk].to(v.dtype))


class FlashAttention(torch.autograd.Function):
    """GQA attention for training, causal (optionally windowed) or, with
    ``causal=False``, over every key (the encoder's self-attention, and
    cross-attention, where Sq and Sk differ): forward the flash kernel
    (``flash_attention`` with its log-sum-exp), backward
    ``flash_attention_bwd``. ``flash_attention`` is looked up when
    called, so a caller may put the plain version in its place."""

    @staticmethod
    def forward(ctx, q, k, v, window: int, chunk: int, scale: float,
                causal: bool = True):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = flash_attention(q, k, v, causal=causal, window=window,
                                 scale=scale, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (window, chunk, scale, causal)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        window, chunk, scale, causal = ctx.args
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                         window=window, chunk=chunk,
                                         scale=scale)
        return dq, dk, dv, None, None, None, None


# ---------------------------------------------------------------------------
# attention block
# ---------------------------------------------------------------------------

def _proj_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


def _out_proj(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("...hk,hkd->...d") as one matmul."""
    h, k, d = wo.shape
    return o.reshape(*o.shape[:-2], h * k) @ wo.reshape(h * k, d)


def _qkv(p, x: torch.Tensor, cfg):
    q = _proj_heads(x, p.wq)
    k = _proj_heads(x, p.wk)
    v = _proj_heads(x, p.wv)
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    return q, k, v


def _theta_for(cfg, kind: str) -> float:
    if kind == "attn" and cfg.rope_theta_global is not None:
        return cfg.rope_theta_global
    return cfg.rope_theta


def _local_heads(p, cfg, ctx):
    """Under a ``ctx`` whose "model" axis cuts the query heads: ``p``
    with this rank's kv heads, those of its query heads. A kv leaf the
    axis cuts too holds them already; a kv leaf every rank holds whole
    (fewer kv heads than ranks) is sliced (``ctx.tp_slice``), and where
    the rank's query heads do not map onto its kv heads as the kernel
    maps them (head j on kv head j // (H / Hk)), the kv heads are
    repeated to one a query head."""
    if ctx.split(p, "wk"):
        return p
    lo, hi, idx = _kv_of_local_heads(cfg, ctx, p.wq.shape[1])
    out = SimpleNamespace(**vars(p))
    for name, dim in (("wk", 1), ("wv", 1), ("bk", 0), ("bv", 0)):
        t = getattr(p, name, None)
        if t is None:
            continue
        t = ctx.tp_slice(t, dim, lo, hi)
        if idx is not None:
            t = t.index_select(dim, torch.tensor(idx, device=t.device))
        setattr(out, name, t)
    return out


def _kv_of_local_heads(cfg, ctx, hl: int):
    """The kv heads of this rank's ``hl`` query heads (head j on kv head
    j // (H / Hk)): (lo, hi, idx), the range ``[lo, hi)`` that holds
    them and, where they do not map onto it as the kernel maps heads,
    the index into it of each query head's kv head (else None)."""
    g = cfg.n_heads // cfg.n_kv_heads
    first = ctx.tp_index * hl
    want = [(first + j) // g for j in range(hl)]
    lo, hi = want[0], want[-1] + 1
    idx = [w - lo for w in want]
    uniform = hl % (hi - lo) == 0 and all(
        i == j // (hl // (hi - lo)) for j, i in enumerate(idx))
    return lo, hi, None if uniform else idx


def attn_apply(p, x: torch.Tensor, cfg, *, kind: str,
               positions: torch.Tensor, ctx=None) -> torch.Tensor:
    """Full-sequence (train) attention sublayer with residual: causal,
    with the sliding window for ``attn_local``, differentiable through
    the flash kernel (``FlashAttention``). Under a ``ctx`` whose "model"
    axis cuts the query heads (``ShardCtx.split``), the rank's heads
    only: q, k, v column-parallel, the output row-parallel and summed
    over "model"."""
    split = ctx is not None and ctx.split(p, "wq")
    h = rms_norm(x, p.ln, cfg.norm_eps)
    if split:
        p = _local_heads(p, cfg, ctx)
        h = ctx.tp_in(h)
    q, k, v = _qkv(p, h, cfg)
    theta = _theta_for(cfg, kind)
    q = apply_rope(q, positions, theta, cfg.rope_fraction)
    k = apply_rope(k, positions, theta, cfg.rope_fraction)
    window = cfg.window if kind == "attn_local" else 0
    o = FlashAttention.apply(q, k, v, window, cfg.attn_chunk,
                             1.0 / math.sqrt(q.shape[-1]))
    out = _out_proj(o, p.wo)
    return x + (ctx.tp_out(out) if split else out)


def attn_encoder_apply(p, x: torch.Tensor, cfg, *,
                       positions: torch.Tensor, ctx=None) -> torch.Tensor:
    """Bidirectional (encoder) self-attention sublayer with residual:
    RoPE on q and k, then every key (``causal=False``). Under a ``ctx``
    whose "model" axis cuts the query heads, the rank's heads, as
    ``attn_apply``."""
    split = ctx is not None and ctx.split(p, "wq")
    h = rms_norm(x, p.ln, cfg.norm_eps)
    if split:
        p = _local_heads(p, cfg, ctx)
        h = ctx.tp_in(h)
    q, k, v = _qkv(p, h, cfg)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    o = FlashAttention.apply(q, k, v, 0, cfg.attn_chunk,
                             1.0 / math.sqrt(q.shape[-1]), False)
    out = _out_proj(o, p.wo)
    return x + (ctx.tp_out(out) if split else out)


def cross_kv(p, enc_out: torch.Tensor, cfg, ctx=None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cross-attention K and V (B, S_src, Hk, hd) of the encoder
    output, no RoPE, the bias when ``qkv_bias``: what a decoder layer
    attends to, and caches at prefill so that decode never reads the
    encoder output again. Under a ``ctx`` whose "model" axis cuts the
    query heads, the kv heads of the rank's query heads
    (``_local_heads``), the encoder output's gradient summed over
    "model"."""
    if ctx is not None and ctx.split(p, "wq"):
        p = _local_heads(p, cfg, ctx)
        enc_out = ctx.tp_in(enc_out)
    k = _proj_heads(enc_out, p.wk)
    v = _proj_heads(enc_out, p.wv)
    if cfg.qkv_bias:
        k, v = k + p.bk, v + p.bv
    return k, v


def _cross_q(p, x: torch.Tensor, cfg, ctx=None) -> torch.Tensor:
    h = rms_norm(x, p.ln, cfg.norm_eps)
    if ctx is not None:
        h = ctx.tp_in(h)
    q = _proj_heads(h, p.wq)
    return q + p.bq if cfg.qkv_bias else q


def cross_attn_apply(p, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     cfg, ctx=None) -> torch.Tensor:
    """Decoder cross-attention with residual: queries from x (B, S, D)
    over the source's K and V (``cross_kv``), every source row
    (``causal=False``, Sq != Sk). Under a ``ctx`` whose "model" axis
    cuts the query heads, the rank's heads over ``cross_kv``'s, the
    output summed over "model"."""
    split = ctx is not None and ctx.split(p, "wq")
    q = _cross_q(p, x, cfg, ctx if split else None)
    o = FlashAttention.apply(q, k, v, 0, cfg.attn_chunk,
                             1.0 / math.sqrt(q.shape[-1]), False)
    out = _out_proj(o, p.wo)
    return x + (ctx.tp_out(out) if split else out)


def cross_cache_held(p, enc_out: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, cfg, max_len: int, ctx
                     ) -> Dict[str, torch.Tensor]:
    """A sharded prefill's cross cache: {"cross_k", "cross_v"} of
    ``max_len`` rows, the source's K and V in the first, placed as
    ``cache_spec`` says (the rank's kv heads, ``cross_kv``'s where
    "model" cuts ``wk``, or its rows of every kv head, the flash-decode
    layout), and ``cross_len`` (B,) the source rows."""
    from repro_torch.sharding import comm
    from repro_torch.sharding.rules import held, seq_rows
    split = ctx.split(p, "wq")
    kv_split = split and ctx.split(p, "wk")
    b, src = enc_out.shape[:2]
    spec = ctx.cache_spec("cross_k", (b, max_len, cfg.n_kv_heads,
                                      cfg.resolved_head_dim))
    if split and not kv_split:
        k, v = cross_kv(p, enc_out, cfg)        # every kv head
    elif kv_split and spec[2:3] != ("model",):
        k = comm.gather_dim(k, ctx.mesh, "model", 2)
        v = comm.gather_dim(v, ctx.mesh, "model", 2)
    lo, hi = seq_rows(spec, max_len, ctx.mesh)
    return {"cross_k": held(_ring_rows(k, max_len, lo, hi), spec),
            "cross_v": held(_ring_rows(v, max_len, lo, hi), spec),
            "cross_len": held(torch.full((b,), src, dtype=torch.int32,
                                         device=k.device),
                              ctx.cache_spec("cross_len", (b,)))}


def _attend_cache(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                  valid: torch.Tensor, ctx, split: bool) -> torch.Tensor:
    """One query token (B, H_rank, hd) over a slotted cache's ``valid``
    rows (of the whole sequence) through the decode kernel: the output
    of the rank's heads (every head without a ``ctx``). Under a ``ctx``
    the cache holds the rank's kv heads (the heads layout), or every kv
    head, when q is gathered over "model" first; where it holds a range
    of the rows, the kernel reads the rank's rows up to ``clamp(valid -
    lo, 0, rows)`` and returns its fp32 partial and log-sum-exp, which
    ``ctx.combine`` merges."""
    from repro_torch.sharding import comm
    from repro_torch.sharding.rules import seq_axes, seq_rows
    spec = kc.shard_spec if ctx is not None else ()
    heads = split and spec[2:3] == ("model",)
    hl = q.shape[1]
    if split and not heads:
        q = comm.gather_dim(q, ctx.mesh, "model", 1)
    axes = seq_axes(spec)
    n = ctx.mesh.size(axes) if ctx is not None else 1
    rows_l = kc.shape[1]
    if n == 1:
        o = decode_attention(q.contiguous(), kc, vc, valid)
    else:
        lo, _ = seq_rows(spec, rows_l * n, ctx.mesh)
        o, lse = decode_attention(
            q.contiguous(), kc, vc,
            (valid - lo).clamp(0, rows_l).to(torch.int32), return_lse=True)
        o = ctx.combine(o, lse, axes).to(q.dtype)
    if split and not heads:
        o = o[:, ctx.tp_index * hl:(ctx.tp_index + 1) * hl]
    return o


def cross_attn_decode(p, x: torch.Tensor, cfg,
                      cache: Dict[str, torch.Tensor], ctx=None
                      ) -> torch.Tensor:
    """One-token cross-attention over a layer's cached source: x (B, 1,
    D); ``cache`` {"cross_k", "cross_v"} (B, S_cross, Hk, hd) with
    ``cross_len`` (B,) int32 source rows per sequence (rows past it, a
    slot's stale or zero rows, are never read), through the slotted
    decode kernel. Returns the residual output. Under a ``ctx`` the
    rank's heads over the leaves as placed (``_attend_cache``: the
    log-sum-exp combine where the source rows are cut), the output
    summed over "model"."""
    split = ctx is not None and ctx.split(p, "wq")
    q = _cross_q(p, x, cfg, ctx if split else None)
    o = _attend_cache(q[:, 0], cache["cross_k"], cache["cross_v"],
                      cache["cross_len"], ctx, split)
    out = _out_proj(o, p.wo)[:, None]
    return x + (ctx.tp_out(out) if split else out)


def attn_prefill_cache(p, x: torch.Tensor, cfg, *, kind: str,
                       positions: torch.Tensor, cache_size: int, ctx=None
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence prefill that also materializes the decode cache:
    returns (residual output, {"k", "v"} of ``cache_size`` rows). Rows
    keep the last ``cache_size`` positions at their ring slots
    (slot = position % cache_size), matching ``attn_decode``.

    Under a ``ctx`` (a sharded serving step), the rank's batch rows and,
    where the "model" axis cuts the query heads, its heads: q
    column-parallel, the flash kernel on the rank's heads, the output
    row-parallel and summed over "model". K and V are computed for the
    rank's kv heads where the axis cuts ``wk``, else for every kv head
    (each rank holds ``wk`` whole then), and the rank's query heads read
    theirs. The cache leaves are placed as ``cache_spec`` says: the
    rank's kv heads (the heads layout), or its rows of the ring of every
    kv head (the sequence, flash-decode, layout; kv heads that "model"
    cuts gathered over it through ``comm``)."""
    from repro_torch.sharding import comm
    from repro_torch.sharding.rules import held, seq_rows
    split = ctx is not None and ctx.split(p, "wq")
    kv_split = split and ctx.split(p, "wk")
    h = rms_norm(x, p.ln, cfg.norm_eps)
    if split:
        h = ctx.tp_in(h)
    q, k, v = _qkv(p, h, cfg)
    theta = _theta_for(cfg, kind)
    q = apply_rope(q, positions, theta, cfg.rope_fraction)
    k = apply_rope(k, positions, theta, cfg.rope_fraction)
    kf, vf = k, v
    if split and not kv_split:
        lo, hi, idx = _kv_of_local_heads(cfg, ctx, q.shape[2])
        kf, vf = k[:, :, lo:hi], v[:, :, lo:hi]
        if idx is not None:
            sel = torch.tensor(idx, device=k.device)
            kf, vf = kf.index_select(2, sel), vf.index_select(2, sel)
    window = cfg.window if kind == "attn_local" else 0
    o = flash_attention(q, kf.contiguous(), vf.contiguous(), causal=True,
                        window=window)
    out = _out_proj(o, p.wo)
    out = x + (ctx.tp_out(out) if split else out)
    if ctx is None:
        return out, {"k": _ring_rows(k, cache_size, 0, cache_size),
                     "v": _ring_rows(v, cache_size, 0, cache_size)}
    spec = ctx.cache_spec("k", (x.shape[0], cache_size, cfg.n_kv_heads,
                                cfg.resolved_head_dim))
    if kv_split and spec[2:3] != ("model",):
        k = comm.gather_dim(k, ctx.mesh, "model", 2)
        v = comm.gather_dim(v, ctx.mesh, "model", 2)
    lo, hi = seq_rows(spec, cache_size, ctx.mesh)
    return out, {"k": held(_ring_rows(k, cache_size, lo, hi), spec),
                 "v": held(_ring_rows(v, cache_size, lo, hi), spec)}


def _ring_rows(k: torch.Tensor, size: int, lo: int, hi: int
               ) -> torch.Tensor:
    """Slots ``[lo, hi)`` of a ring of ``size`` rows filled from a
    prompt's (B, S, Hk, hd) rows: the last ``size`` positions at
    slot = position % size, zeros past the prompt."""
    s = k.shape[1]
    if size >= s:
        out = k.new_zeros((k.shape[0], hi - lo) + k.shape[2:])
        n = max(0, min(hi, s) - lo)
        out[:, :n] = k[:, lo:lo + n]
        return out
    first = s - size
    slot = torch.arange(lo, hi, device=k.device)
    return k[:, first + (slot - first) % size].contiguous()


def attn_decode(p, x: torch.Tensor, cfg, *, kind: str,
                cache: Dict[str, torch.Tensor], cache_len: torch.Tensor,
                ctx=None) -> torch.Tensor:
    """One-token decode. x: (B, 1, D); cache {"k","v"}: (B, S_cache, Hk,
    hd); cache_len: (B,) int32. The new K/V row is written at
    ``cache_len % S_cache`` IN PLACE in ``cache`` before attending over
    ``min(cache_len + 1, S_cache)`` rows. Returns the residual output.
    No window mask: a ring holds only the window.

    Under a ``ctx`` (a sharded serving step), the rank's batch rows and
    shards, the cache placed as its leaves' ``shard_spec`` says. The
    heads layout: the rank's query heads over its kv heads, as
    unsharded. Otherwise the cache holds every kv head, so the rank's q
    (and K, V where "model" cuts ``wk``) are gathered to every head over
    "model"; where the sequence is cut over ranks, the new row goes to
    the rank that holds slot ``cache_len % S`` of the ring, the kernel
    reads the rank's rows up to ``clamp(valid - lo, 0, rows)`` and
    returns its fp32 partial and log-sum-exp, which ``ctx.combine``
    merges across them. The rank's heads of the result go through its
    rows of ``wo``, summed over "model"."""
    from repro_torch.sharding import comm
    from repro_torch.sharding.rules import seq_axes, seq_rows
    split = ctx is not None and ctx.split(p, "wq")
    kv_split = split and ctx.split(p, "wk")
    h = rms_norm(x, p.ln, cfg.norm_eps)
    if split:
        h = ctx.tp_in(h)
    positions = cache_len[:, None]
    q, k, v = _qkv(p, h, cfg)
    theta = _theta_for(cfg, kind)
    q = apply_rope(q, positions, theta, cfg.rope_fraction)
    k = apply_rope(k, positions, theta, cfg.rope_fraction)
    kc, vc = cache["k"], cache["v"]
    spec = kc.shard_spec if ctx is not None else ()
    if kv_split and spec[2:3] != ("model",):
        k = comm.gather_dim(k, ctx.mesh, "model", 2)
        v = comm.gather_dim(v, ctx.mesh, "model", 2)
    axes = seq_axes(spec)
    n = ctx.mesh.size(axes) if ctx is not None else 1
    rows_l = kc.shape[1]
    size = rows_l * n
    idx = (cache_len % size).long()
    rows = torch.arange(kc.shape[0], device=kc.device)
    valid = torch.clamp(cache_len + 1, max=size).to(torch.int32)
    if n == 1:
        kc[rows, idx] = k[:, 0]         # in-place cache write
        vc[rows, idx] = v[:, 0]
    else:
        lo, _ = seq_rows(spec, size, ctx.mesh)
        local = idx - lo
        mine = ((local >= 0) & (local < rows_l))[:, None, None]
        local = local.clamp(0, rows_l - 1)
        kc[rows, local] = torch.where(mine, k[:, 0], kc[rows, local])
        vc[rows, local] = torch.where(mine, v[:, 0], vc[rows, local])
    o = _attend_cache(q[:, 0], kc, vc, valid, ctx, split)
    out = _out_proj(o, p.wo)[:, None]
    return x + (ctx.tp_out(out) if split else out)


def attn_extend(p, x: torch.Tensor, cfg, *, kind: str,
                cache: Dict[str, torch.Tensor], cache_len: torch.Tensor
                ) -> torch.Tensor:
    """Chunked-prefill extension: a (B, C) chunk attends over the cache
    plus itself (causal within the chunk). Its K/V rows are written IN
    PLACE at absolute positions ``[cache_len, cache_len + C)`` of
    ``cache`` {"k","v"} (B, S, Hk, hd), then the flash kernel runs with
    ``q_offset = cache_len`` and ``kv_len = cache_len + C``.
    Global attention only (the cache is position-indexed). Padded rows
    at the end of a chunk sit at later positions, so causal masking
    keeps every real row independent of them. Returns the residual
    output."""
    assert kind == "attn", "chunked prefill pages global attention only"
    h = rms_norm(x, p.ln, cfg.norm_eps)
    c = x.shape[1]
    positions = cache_len[:, None] + torch.arange(
        c, dtype=torch.int32, device=x.device)[None]
    q, k, v = _qkv(p, h, cfg)
    theta = _theta_for(cfg, kind)
    q = apply_rope(q, positions, theta, cfg.rope_fraction)
    k = apply_rope(k, positions, theta, cfg.rope_fraction)
    kc, vc = cache["k"], cache["v"]
    rows = torch.arange(kc.shape[0], device=kc.device)[:, None]
    kc[rows, positions.long()] = k          # in-place cache write
    vc[rows, positions.long()] = v
    o = flash_attention(q, kc, vc, causal=True, q_offset=cache_len,
                        kv_len=(cache_len + c).to(torch.int32))
    return x + _out_proj(o, p.wo)


def paged_gather(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """Per-sequence contiguous K/V views of a block pool. pool: (N, bs,
    Hk, D); tables: (B, nb) physical block per logical page. Returns
    (B, nb * bs, Hk, D): row i is what a slotted cache would hold at
    position i."""
    b, nb = tables.shape
    _, bs, hk, d = pool.shape
    return pool[tables.long()].reshape(b, nb * bs, hk, d)


def attn_decode_paged(p, x: torch.Tensor, cfg, *, k_pool: torch.Tensor,
                      v_pool: torch.Tensor, tables: torch.Tensor,
                      cache_len: torch.Tensor) -> torch.Tensor:
    """One-token decode against a paged pool (global attention). x: (B,
    1, D); pools (N, bs, Hk, hd); tables (B, nb) int32 with physical
    block 0 the null block (free slots and unallocated pages point
    there, so their masked, never-read writes collide harmlessly). The
    new K/V row is written IN PLACE at block ``tables[b, cache_len //
    bs]``, offset ``cache_len % bs`` (the scheduler allocates that block
    before the step); then the paged kernel reads the slot's pages
    through the table. Returns the residual output."""
    h = rms_norm(x, p.ln, cfg.norm_eps)
    positions = cache_len[:, None]
    q, k, v = _qkv(p, h, cfg)
    theta = _theta_for(cfg, "attn")
    q = apply_rope(q, positions, theta, cfg.rope_fraction)
    k = apply_rope(k, positions, theta, cfg.rope_fraction)
    bs = k_pool.shape[1]
    clen = cache_len.long()
    blk = tables.long().gather(1, (clen // bs)[:, None])[:, 0]
    off = clen % bs
    k_pool[blk, off] = k[:, 0]              # in-place pool write
    v_pool[blk, off] = v[:, 0]
    o = paged_decode_attention(q[:, 0].contiguous(), k_pool, v_pool, tables,
                               cache_len + 1)
    return x + _out_proj(o, p.wo)[:, None]


# ---------------------------------------------------------------------------
# gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------

def mlp_apply(p, x: torch.Tensor, cfg, ctx=None) -> torch.Tensor:
    """Gated MLP with residual. Under a ``ctx`` whose "model" axis cuts
    the ff dim: w_gate and w_up column-parallel, w_down row-parallel,
    the output summed over "model"."""
    h = rms_norm(x, p.ln, cfg.norm_eps)
    split = ctx is not None and ctx.split(p, "w_gate")
    if split:
        h = ctx.tp_in(h)
    g = act_fn(cfg.act)(h @ p.w_gate) * (h @ p.w_up)
    out = g @ p.w_down
    return x + (ctx.tp_out(out) if split else out)


def dense_init(gen: torch.Generator, in_dim: int, out_shape, dtype,
               device) -> torch.Tensor:
    """The reference's ``dense_init`` scale: N(0, 1) / sqrt(in_dim)."""
    w = torch.randn((in_dim,) + tuple(out_shape), generator=gen,
                    dtype=torch.float32, device=device)
    return (w / math.sqrt(in_dim)).to(dtype)
