"""Decoder stack of the port: an ``nn.Module`` plus prefill / decode.

Counterpart of ``repro.models.transformer`` for dense decoders whose
every layer is global attention (``layer_pattern`` of ``"attn"``), with
scan-plus-remainder depth and tied or untied embeddings. The reference
stacks each period's params under ``lax.scan``; here the decoder layers
sit in one ``nn.ModuleList`` in ``cfg.layer_kinds`` order (scanned
periods first, then the remainder), and ``repro_torch.weights`` maps one
layout onto the other. Parameters keep the reference's names and
shapes; they are held in the compute dtype (``cast_params_for_compute``
applied once, where the reference casts at every step).

The decode cache is a list with one ``{"k", "v"}`` dict per layer, each
(B, S_cache, Hk, hd), or with the paged layout (``init_paged_cache``)
each a shared (N, bs, Hk, hd) pool addressed through block tables.
``decode_step``, ``prefill_extend`` and the paged helpers
(``paged_insert``, ``paged_seed``, ``paged_copy_block``) update caches
in place where the reference returns new ones.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}

# gate / router / state-decay leaves stay fp32 for numerical stability
_KEEP_F32 = ("lam", "router", "b_if", "w_if", "b")

Cache = List[Dict[str, torch.Tensor]]


def _dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. ``"cuda"`` is the default of
    every entry point; without a card it raises rather than carrying on
    on the CPU, which only an explicit ``device="cpu"`` selects."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port's "
            "plain PyTorch path on the CPU")
    return dev


def check_supported(cfg: ModelConfig) -> None:
    """The configs this slice of the port runs."""
    if any(k != "attn" for k in cfg.layer_kinds):
        raise ValueError(f"{cfg.name}: the port runs all-'attn' decoders; "
                         f"{sorted(set(cfg.layer_kinds))} come with later "
                         f"slices (queue 1, item 10)")
    if cfg.moe is not None or cfg.frontend or cfg.n_encoder_layers:
        raise ValueError(f"{cfg.name}: MoE, frontends and encoders come "
                         f"with later slices (queue 1, item 10)")


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device),
                        requires_grad=False)


class Attention(nn.Module):
    """``attn`` block params: wq (d,h,hd), wk/wv (d,hk,hd), wo (h,hd,d),
    ln (d,), and bq/bk/bv when ``qkv_bias``."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, hd = cfg.d_model, cfg.resolved_head_dim
        h, hk = cfg.n_heads, cfg.n_kv_heads
        self.wq = _param((d, h, hd), dtype, device)
        self.wk = _param((d, hk, hd), dtype, device)
        self.wv = _param((d, hk, hd), dtype, device)
        self.wo = _param((h, hd, d), dtype, device)
        self.ln = _param((d,), dtype, device)
        if cfg.qkv_bias:
            self.bq = _param((h, hd), dtype, device)
            self.bk = _param((hk, hd), dtype, device)
            self.bv = _param((hk, hd), dtype, device)


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.w_gate = _param((d, f), dtype, device)
        self.w_up = _param((d, f), dtype, device)
        self.w_down = _param((f, d), dtype, device)
        self.ln = _param((d,), dtype, device)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, kind: str, dtype, device):
        super().__init__()
        self.kind = kind
        self.block = Attention(cfg, dtype, device)
        self.mlp = MLP(cfg, dtype, device) if cfg.d_ff else None


class Transformer(nn.Module):
    """The decoder: ``embed`` (Vp, d), ``layers`` (``nn.ModuleList`` in
    ``cfg.layer_kinds`` order), ``final_norm`` (d,), and ``lm_head``
    (d, Vp) unless embeddings are tied. Built zeroed in ``dtype``
    (default: the config's compute dtype); fill it with ``init_params``
    or ``repro_torch.weights.from_jax_params``."""

    def __init__(self, cfg: ModelConfig, *, device="cuda", dtype=None):
        super().__init__()
        check_supported(cfg)
        dev = resolve_device(device)
        dtype = dtype or _dtype(cfg.dtype)
        self.cfg = cfg
        d, vp = cfg.d_model, cfg.padded_vocab_size
        self.embed = _param((vp, d), dtype, dev)
        self.final_norm = _param((d,), dtype, dev)
        self.lm_head = None if cfg.tie_embeddings else \
            _param((d, vp), dtype, dev)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, kind, dtype, dev) for kind in cfg.layer_kinds)

    @property
    def device(self) -> torch.device:
        return self.embed.device


def cast_params_for_compute(model: Transformer, cfg: ModelConfig
                            ) -> Transformer:
    """Master params -> compute dtype, in place: every floating leaf but
    the ``_KEEP_F32`` names (none of which an all-'attn' decoder has)."""
    ct = _dtype(cfg.dtype)
    for name, p in model.named_parameters():
        if name.rsplit(".", 1)[-1] not in _KEEP_F32 and p.is_floating_point():
            p.data = p.data.to(ct)
    return model


def init_params(cfg: ModelConfig, seed: int = 0, *, device="cuda",
                dtype=None) -> Transformer:
    """Random weights with the reference ``init_params``' shapes and
    scales — embed N(0,1)*0.02, dense N(0,1)/sqrt(in_dim), norms and
    biases zero — drawn from a ``torch.Generator`` seeded with ``seed``
    on the target device. The numbers differ from JAX's PRNG; parity
    tests carry JAX's weights across with ``from_jax_params`` instead."""
    model = Transformer(cfg, device=device, dtype=dtype)
    dev, dt = model.device, model.embed.dtype
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.resolved_head_dim
    with torch.no_grad():
        model.embed.copy_(torch.randn(model.embed.shape, generator=gen,
                                      device=dev) * 0.02)
        if model.lm_head is not None:
            model.lm_head.copy_(L.dense_init(gen, d, (cfg.padded_vocab_size,),
                                             dt, dev))
        for layer in model.layers:
            a = layer.block
            a.wq.copy_(L.dense_init(gen, d, a.wq.shape[1:], dt, dev))
            a.wk.copy_(L.dense_init(gen, d, a.wk.shape[1:], dt, dev))
            a.wv.copy_(L.dense_init(gen, d, a.wv.shape[1:], dt, dev))
            a.wo.copy_(L.dense_init(gen, h * hd, (d,), dt, dev)
                       .reshape(a.wo.shape))
            if layer.mlp is not None:
                m = layer.mlp
                m.w_gate.copy_(L.dense_init(gen, d, (cfg.d_ff,), dt, dev))
                m.w_up.copy_(L.dense_init(gen, d, (cfg.d_ff,), dt, dev))
                m.w_down.copy_(L.dense_init(gen, cfg.d_ff, (d,), dt, dev))
    return model


# ---------------------------------------------------------------------------
# embed / head
# ---------------------------------------------------------------------------

def _embed_inputs(model: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    """Table in the compute dtype, gather, then scale by sqrt(d_model)."""
    return model.embed[tokens.long()] * math.sqrt(model.cfg.d_model)


def _head_logits(x: torch.Tensor, model: Transformer) -> torch.Tensor:
    """LM head in x.dtype with the padded vocabulary masked to -1e30.
    x: (..., D) -> (..., padded_vocab)."""
    cfg = model.cfg
    if cfg.tie_embeddings:
        logits = x @ model.embed.to(x.dtype).t()
    else:
        logits = x @ model.lm_head.to(x.dtype)
    if cfg.padded_vocab_size != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab_size,
                           device=x.device) >= cfg.vocab_size
        logits = torch.where(pad, torch.full_like(logits.float(), -1e30),
                             logits.float()).to(logits.dtype)
    return logits


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def _cache_size_for(kind: str, cfg: ModelConfig, max_len: int) -> int:
    if kind == "attn_local":
        return min(cfg.window, max_len)
    if kind == "attn":
        return cfg.max_cache_len or max_len
    return 0


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device) -> Cache:
    """Zeroed decode cache: one {"k", "v"} (batch, S_cache, Hk, hd) dict
    per layer, in ``cfg.layer_kinds`` order."""
    dtype = _dtype(cfg.dtype)
    hk, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    out = []
    for kind in cfg.layer_kinds:
        s = _cache_size_for(kind, cfg, max_len)
        out.append({"k": torch.zeros((batch, s, hk, hd), dtype=dtype,
                                     device=device),
                    "v": torch.zeros((batch, s, hk, hd), dtype=dtype,
                                     device=device)})
    return out


def supports_chunked_prefill(cfg: ModelConfig) -> bool:
    """Chunked prefill (and prefix resume) extends a position-indexed
    global-attention cache chunk by chunk, so it needs no
    ``max_cache_len`` ring cap. (The reference also needs every layer
    ``attn`` and no encoder; ``check_supported`` already refuses the
    rest here.)"""
    return not cfg.max_cache_len


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     max_slots: int, *, max_len: int, device) -> Cache:
    """Paged counterpart of ``init_cache``: each layer's global-attention
    K/V live in one shared pool of ``num_blocks`` blocks of
    ``block_size`` rows, {"k", "v"} (N, bs, Hk, hd), addressed through
    per-slot block tables. Physical block 0 is the null block. The
    port's configs are all-``attn``, so there are no slot-indexed leaves
    (``max_slots`` and ``max_len`` size those in the reference)."""
    dtype = _dtype(cfg.dtype)
    hk, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    shape = (num_blocks, block_size, hk, hd)
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in cfg.layer_kinds]


def kv_row_bytes(cfg: ModelConfig) -> int:
    """Bytes of global-attention K+V cached per token row."""
    n_global = sum(1 for k in cfg.layer_kinds if k == "attn")
    nbytes = 2 if cfg.dtype in ("bfloat16", "float16") else 4
    return n_global * 2 * cfg.n_kv_heads * cfg.resolved_head_dim * nbytes


# ---------------------------------------------------------------------------
# prefill / decode
# ---------------------------------------------------------------------------

@torch.no_grad()
def prefill(model: Transformer, tokens: torch.Tensor, *, max_len: int
            ) -> Tuple[torch.Tensor, Cache, torch.Tensor]:
    """Run the prompt (B, S) through the model, materializing the decode
    cache. Returns (last-position logits (B, Vp), cache, cache_len (B,)
    int32)."""
    cfg = model.cfg
    x = _embed_inputs(model, tokens)
    b, s = x.shape[:2]
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    cache: Cache = []
    for layer in model.layers:
        x, c = L.attn_prefill_cache(
            layer.block, x, cfg, kind=layer.kind, positions=positions,
            cache_size=_cache_size_for(layer.kind, cfg, max_len))
        if layer.mlp is not None:
            x = L.mlp_apply(layer.mlp, x, cfg)
        cache.append(c)
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    logits = _head_logits(x[:, -1], model)
    return logits, cache, torch.full((b,), s, dtype=torch.int32,
                                     device=x.device)


@torch.no_grad()
def decode_step(model: Transformer, token: torch.Tensor, cache: Cache,
                cache_len: torch.Tensor, *,
                block_tables: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Cache, torch.Tensor]:
    """One serving step: next-token logits for one new token per
    sequence. token: (B,) int; cache_len: (B,) int32 current context
    length. ``block_tables`` (B, nb) int32 switches the layers to the
    paged layout (``init_paged_cache``): each reads only the pages its
    table names. ``cache`` is updated in place (and returned, like the
    reference's functional step)."""
    cfg = model.cfg
    x = _embed_inputs(model, token)[:, None]
    for layer, c in zip(model.layers, cache):
        if block_tables is None:
            x = L.attn_decode(layer.block, x, cfg, kind=layer.kind, cache=c,
                              cache_len=cache_len)
        else:
            x = L.attn_decode_paged(layer.block, x, cfg, k_pool=c["k"],
                                    v_pool=c["v"], tables=block_tables,
                                    cache_len=cache_len)
        if layer.mlp is not None:
            x = L.mlp_apply(layer.mlp, x, cfg)
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    return _head_logits(x[:, 0], model), cache, cache_len + 1


@torch.no_grad()
def prefill_extend(model: Transformer, tokens: torch.Tensor, cache: Cache,
                   cache_len: torch.Tensor
                   ) -> Tuple[torch.Tensor, Cache, torch.Tensor]:
    """Chunked prefill: run a (B, C) chunk through the model against an
    existing slotted (or scratch) cache, writing its K/V rows in place
    at positions ``[cache_len, cache_len + C)``. Requires
    ``supports_chunked_prefill(cfg)``. Returns per-position logits (B,
    C, Vp) (the caller samples at the last real position), the cache
    and ``cache_len + C``."""
    cfg = model.cfg
    assert supports_chunked_prefill(cfg), cfg.name
    x = _embed_inputs(model, tokens)
    c = x.shape[1]
    for layer, lc in zip(model.layers, cache):
        x = L.attn_extend(layer.block, x, cfg, kind=layer.kind, cache=lc,
                          cache_len=cache_len)
        if layer.mlp is not None:
            x = L.mlp_apply(layer.mlp, x, cfg)
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    return _head_logits(x, model), cache, cache_len + c


# ---------------------------------------------------------------------------
# paged-pool surgery (all in place)
# ---------------------------------------------------------------------------

def _ids(block_ids, device) -> torch.Tensor:
    return torch.as_tensor(block_ids, dtype=torch.int64, device=device)


@torch.no_grad()
def paged_insert(cfg: ModelConfig, cache: Cache, req_cache: Cache,
                 block_ids, slot: int, *, block_size: int) -> Cache:
    """Write a batch=1 prefill (or scratch) cache into the paged pools:
    each layer's K/V rows go page-wise into the physical blocks named by
    ``block_ids`` (one per logical page; 0 = the null block, for pages
    past the allocation or pages shared with another request). Rows of
    ``req_cache`` past the slot's page span (a chunk-rounded scratch
    cache is longer) are dropped: they lie beyond ``max_len``. ``slot``
    indexes slot-held leaves in the reference; an all-``attn`` config
    has none."""
    for big, small in zip(cache, req_cache):
        ids = _ids(block_ids, big["k"].device)
        sg = ids.shape[0] * block_size
        for key in ("k", "v"):
            rows = small[key][0, :sg]
            big[key][ids] = rows.reshape(ids.shape[0], block_size,
                                         *rows.shape[1:])
    return cache


@torch.no_grad()
def paged_seed(cfg: ModelConfig, scratch: Cache, cache: Cache,
               block_ids) -> Cache:
    """Inverse of ``paged_insert`` for a shared prompt prefix: copy the
    K/V rows of the pool blocks ``block_ids`` (in page order) into the
    head of a batch=1 scratch cache, so ``prefill_extend`` can resume
    mid-prompt. Whole pages are copied; rows past the match are either
    recomputed by the extend or lie beyond the prompt."""
    for sc, c in zip(scratch, cache):
        ids = _ids(block_ids, c["k"].device)
        for key in ("k", "v"):
            pool = c[key]
            rows = pool[ids].reshape(ids.shape[0] * pool.shape[1],
                                     *pool.shape[2:])
            sc[key][0, :rows.shape[0]] = rows
    return scratch


@torch.no_grad()
def paged_copy_block(cfg: ModelConfig, cache: Cache, src: int,
                     dst: int) -> Cache:
    """Copy one physical block's K/V rows to another: the device half of
    copy-on-write."""
    for c in cache:
        for key in ("k", "v"):
            c[key][dst] = c[key][src]
    return cache


__all__ = ["Transformer", "init_params", "cast_params_for_compute",
           "init_cache", "init_paged_cache", "kv_row_bytes", "prefill",
           "decode_step", "prefill_extend", "supports_chunked_prefill",
           "paged_insert", "paged_seed", "paged_copy_block",
           "resolve_device", "Cache"]
