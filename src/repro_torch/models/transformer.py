"""Decoder stack of the port: an ``nn.Module``, the training forward and
loss, and prefill / decode.

Counterpart of ``repro.models.transformer`` with scan-plus-remainder
depth and tied or untied embeddings. The reference stacks each period's
params under ``lax.scan``; here the decoder layers sit in one
``nn.ModuleList`` in ``cfg.layer_kinds`` order (scanned periods first,
then the remainder), and ``repro_torch.weights`` maps one layout onto
the other. Parameters keep the reference's names and shapes.

A layer is its kind's block (``attn`` / ``attn_local`` attention,
``rglru`` from ``models.rglru``, ``mlstm`` / ``slstm`` from
``models.ssm``) and, on the kinds of ``_HAS_MLP`` only, an MLP or, when
``cfg.moe``, a mixture of experts (``models.moe``); xLSTM blocks carry
their own projections. With ``cfg.frontend`` a two-layer projector
(``frontend_proj``) maps the frontend's embeddings (a stub's, given as
``embeds``) to the model width: a decoder-only config (the vision
frontend) puts the projected rows ahead of the prompt's, and with
``cfg.n_encoder_layers`` (the audio encoder-decoder) they feed the
encoder (``encode``: bidirectional attention layers and ``enc_norm``)
whose output every decoder layer attends to through its ``cross``
attention. Two uses, two checks. ``forward`` / ``loss_fn``
(training) run every config (``check_trainable``) on fp32 master
parameters:
``cast_params_for_compute`` makes the compute-dtype copy out of place at
every call, as the reference casts at every step, and autograd carries
the gradients back to the masters. ``forward`` returns the MoE layers'
aux loss summed over the depth, and ``loss_fn`` adds
``router_aux_weight`` x that to the cross-entropy of an MoE config.
When ``cfg.remat`` is set each scanned period and each encoder layer
runs under ``torch.utils.checkpoint``, as the reference wraps its scan
body and its encoder layers in ``jax.checkpoint``. Serving
(``prefill``, ``decode_step``, ``prefill_extend``) runs the same
configs (``check_servable``) on
parameters held in the compute dtype (``to_compute_dtype_``, once);
``prefill_extend`` only all-``attn`` decoders
(``supports_chunked_prefill``), MoE ones among them.

``to_actor_graph`` exports the decoder as a VR-PRUNE actor graph
(Input, Embed, one actor per group of layers, Head) whose fire functions
run ``forward``'s layers on a compute copy cast once, for Edge-PRUNE's
partitioned prefill (``runtime.serving.PartitionedServeEngine``); it
refuses a frontend or an encoder, which the reference's export drops.

The decode cache is a list with one dict per layer, by kind: ``{"k",
"v"}`` (B, S_cache, Hk, hd) for attention (a ring of ``min(window,
max_len)`` rows for ``attn_local``, slot = position % rows), ``{"h",
"conv"}`` for ``rglru`` (``models.rglru``), ``{"C", "n", "m", "conv"}``
for ``mlstm`` and ``{"c", "n", "m", "h"}`` for ``slstm``
(``models.ssm``). An encoder-decoder's attention layers also cache
the cross-attention K/V of their source, ``{"cross_k", "cross_v"}``
(B, max_len, Hk, hd) with its length ``cross_len`` (B,) int32 (rows
past it are never read). With the paged layout
(``init_paged_cache``) each ``attn`` layer's K/V is a shared (N, bs,
Hk, hd) pool addressed through block tables, and every other leaf (the
cross K/V among them) stays slot-indexed.
``decode_step``, ``decode_step_staged``, ``prefill_extend`` and the
paged helpers (``paged_insert``, ``paged_seed``, ``paged_copy_block``)
update caches in place where the reference returns new ones.
"""
from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import rglru as R
from repro_torch.models import ssm as S
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


# the block kinds that carry an MLP (or the MoE), as the reference lists
# them: xLSTM blocks embed their own projections
_HAS_MLP = ("attn", "attn_local", "rglru")


def check_trainable(cfg: ModelConfig) -> None:
    """The configs the port builds and trains: decoders of any block kind
    (``attn``, ``attn_local``, ``rglru``, ``mlstm``, ``slstm``), dense or
    MoE, with or without a frontend, and encoder-decoders. An encoder
    reads the frontend's projected embeddings, and its decoder layers
    cache the cross K/V beside their attention K/V, so an encoder needs a
    frontend and a decoder of attention layers, as in the reference."""
    if cfg.frontend and cfg.frontend_dim <= 0:
        raise ValueError(f"{cfg.name}: a frontend needs frontend_dim > 0")
    if cfg.n_encoder_layers and not cfg.frontend:
        raise ValueError(f"{cfg.name}: an encoder reads frontend "
                         f"embeddings; set frontend and frontend_dim")
    if cfg.n_encoder_layers and any(k not in ("attn", "attn_local")
                                    for k in cfg.layer_kinds):
        raise ValueError(f"{cfg.name}: cross-attention K/V are cached in "
                         f"attention layers; an encoder-decoder's decoder "
                         f"layers must be attn or attn_local")


def check_servable(cfg: ModelConfig) -> None:
    """The configs the port serves (prefill, decode, the ``Engine``):
    the ones it trains. An alias of ``check_trainable`` on purpose: the
    serving entry points name the rule they apply, and it may part from
    training's in a later slice."""
    check_trainable(cfg)


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
    """Gated MLP params: w_gate / w_up (d, f), w_down (f, d), ln (d,);
    ``f`` is ``cfg.d_ff`` unless given (the MoE's shared experts)."""

    def __init__(self, cfg: ModelConfig, dtype, device,
                 width: Optional[int] = None):
        super().__init__()
        d, f = cfg.d_model, width or cfg.d_ff
        self.w_gate = _param((d, f), dtype, device)
        self.w_up = _param((d, f), dtype, device)
        self.w_down = _param((f, d), dtype, device)
        self.ln = _param((d,), dtype, device)


class FrontendProj(nn.Module):
    """The frontend's two-layer projector: w1 (frontend_dim, d), w2 (d,
    d), gelu between."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.w1 = _param((cfg.frontend_dim, cfg.d_model), dtype, device)
        self.w2 = _param((cfg.d_model, cfg.d_model), dtype, device)


class EncoderLayer(nn.Module):
    """One encoder layer: bidirectional ``Attention`` and the MLP."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.block = Attention(cfg, dtype, device)
        self.mlp = MLP(cfg, dtype, device)


_BLOCKS = {"rglru": R.RGLRUBlock, "mlstm": S.MLSTMBlock,
           "slstm": S.SLSTMBlock}


class DecoderLayer(nn.Module):
    """One decoder layer: its ``kind``'s block (``Attention`` for
    ``attn`` / ``attn_local``, ``RGLRUBlock`` for ``rglru``,
    ``MLSTMBlock`` / ``SLSTMBlock`` for ``mlstm`` / ``slstm``), the
    ``cross`` attention of an encoder-decoder, and, on the kinds of
    ``_HAS_MLP``, the ``moe`` when ``cfg.moe``, else the ``mlp`` when
    ``d_ff``."""

    def __init__(self, cfg: ModelConfig, kind: str, dtype, device):
        super().__init__()
        self.kind = kind
        self.block = _BLOCKS[kind](cfg, dtype, device, _param) \
            if kind in _BLOCKS else Attention(cfg, dtype, device)
        mlp = moe = None
        if kind in _HAS_MLP and cfg.moe is not None:
            m = cfg.moe
            moe = M.MoE(cfg, dtype, device, _param, MLP(
                cfg, dtype, device, m.d_ff_expert * m.n_shared_experts)
                if m.n_shared_experts else None)
        elif kind in _HAS_MLP and cfg.d_ff:
            mlp = MLP(cfg, dtype, device)
        self.register_module("mlp", mlp)
        self.register_module("moe", moe)
        self.register_module("cross", Attention(cfg, dtype, device)
                             if cfg.n_encoder_layers else None)


class Transformer(nn.Module):
    """The model: ``embed`` (Vp, d), ``layers`` (the decoder, an
    ``nn.ModuleList`` in ``cfg.layer_kinds`` order), ``final_norm``
    (d,), ``lm_head`` (d, Vp) unless embeddings are tied, and with a
    frontend its ``frontend_proj``, with an encoder ``encoder`` (an
    ``nn.ModuleList`` of ``EncoderLayer``) and ``enc_norm`` (d,). Built
    zeroed in ``dtype`` (default: the config's compute dtype); fill it
    with ``init_params`` or ``repro_torch.weights.from_jax_params``."""

    def __init__(self, cfg: ModelConfig, *, device="cuda", dtype=None):
        super().__init__()
        check_trainable(cfg)
        dev = resolve_device(device)
        dtype = dtype or _dtype(cfg.dtype)
        self.cfg = cfg
        d, vp = cfg.d_model, cfg.padded_vocab_size
        self.embed = _param((vp, d), dtype, dev)
        self.final_norm = _param((d,), dtype, dev)
        self.register_parameter("lm_head", None if cfg.tie_embeddings else
                                _param((d, vp), dtype, dev))
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, kind, dtype, dev) for kind in cfg.layer_kinds)
        self.register_module("frontend_proj", FrontendProj(cfg, dtype, dev)
                             if cfg.frontend else None)
        enc = cfg.n_encoder_layers
        self.register_module("encoder", nn.ModuleList(
            EncoderLayer(cfg, dtype, dev) for _ in range(enc))
            if enc else None)
        self.register_parameter("enc_norm", _param((d,), dtype, dev)
                                if enc else None)

    @property
    def device(self) -> torch.device:
        return self.embed.device


def _keeps_f32(name: str, p: torch.Tensor) -> bool:
    return name in _KEEP_F32 or not p.is_floating_point()


def to_compute_dtype_(model: Transformer, cfg: ModelConfig) -> Transformer:
    """Params -> compute dtype, in place, for serving: every floating
    leaf but the ``_KEEP_F32`` names (``lam`` among them)."""
    ct = _dtype(cfg.dtype)
    for name, p in model.named_parameters():
        if not _keeps_f32(name.rsplit(".", 1)[-1], p):
            p.data = p.data.to(ct)
    return model


def cast_params_for_compute(model: Transformer, cfg: ModelConfig):
    """Master params (fp32) -> the compute copy, out of place: a tree of
    namespaces shaped like ``model`` (``.embed``, ``.layers[i].block.wq``,
    ``.layers[i].kind`` ...) whose floating leaves but the ``_KEEP_F32``
    names are ``.to(compute dtype)`` of the masters. The casts are
    differentiable, so gradients reach the masters, as through the
    reference's ``astype``. The leaves of a sharded model
    (``sharding.shard_params``) are its shards, and each namespace lists
    their specs in ``_specs`` for ``ShardCtx`` (and in ``_halves`` the
    leaves cut by halves)."""
    ct = _dtype(cfg.dtype)

    def view(mod):
        if isinstance(mod, nn.ModuleList):
            return [view(m) for m in mod]
        out = SimpleNamespace()
        specs = {}
        halves = set()
        for name, p in mod._parameters.items():
            if p is not None and hasattr(p, "shard_spec"):
                specs[name] = p.shard_spec
                if p.shard_halves:
                    halves.add(name)
            if p is not None and not _keeps_f32(name, p):
                p = p.to(ct)
            setattr(out, name, p)
        if specs:
            out._specs = specs
        if halves:
            out._halves = halves
        for name, child in mod._modules.items():
            setattr(out, name, None if child is None else view(child))
        for name in ("kind", "cfg"):
            if hasattr(mod, name):
                setattr(out, name, getattr(mod, name))
        return out
    return view(model)


def _attn_init(a: "Attention", cfg: ModelConfig, gen: torch.Generator
               ) -> None:
    d, dt, dev = cfg.d_model, a.wq.dtype, a.wq.device
    a.wq.copy_(L.dense_init(gen, d, a.wq.shape[1:], dt, dev))
    a.wk.copy_(L.dense_init(gen, d, a.wk.shape[1:], dt, dev))
    a.wv.copy_(L.dense_init(gen, d, a.wv.shape[1:], dt, dev))
    h, hd = a.wo.shape[:2]
    a.wo.copy_(L.dense_init(gen, h * hd, (d,), dt, dev).reshape(a.wo.shape))


def _mlp_init(m: "MLP", cfg: ModelConfig, gen: torch.Generator) -> None:
    d, f, dt, dev = cfg.d_model, m.w_gate.shape[1], m.w_gate.dtype, \
        m.w_gate.device
    m.w_gate.copy_(L.dense_init(gen, d, (f,), dt, dev))
    m.w_up.copy_(L.dense_init(gen, d, (f,), dt, dev))
    m.w_down.copy_(L.dense_init(gen, f, (d,), dt, dev))


def init_params(cfg: ModelConfig, seed: int = 0, *, device="cuda",
                dtype=None) -> Transformer:
    """Random weights with the reference ``init_params``' shapes and
    scales — embed N(0,1)*0.02, dense N(0,1)/sqrt(in_dim) (the
    projector, the encoder and the cross-attention among them), norms
    and biases zero — drawn from a ``torch.Generator`` seeded with
    ``seed`` on the target device. The numbers differ from JAX's PRNG;
    parity tests carry JAX's weights across with ``from_jax_params``
    instead."""
    model = Transformer(cfg, device=device, dtype=dtype)
    dev, dt = model.device, model.embed.dtype
    gen = torch.Generator(device=dev).manual_seed(seed)
    d = cfg.d_model
    with torch.no_grad():
        model.embed.copy_(torch.randn(model.embed.shape, generator=gen,
                                      device=dev) * 0.02)
        if model.lm_head is not None:
            model.lm_head.copy_(L.dense_init(gen, d, (cfg.padded_vocab_size,),
                                             dt, dev))
        for layer in model.layers:
            a = layer.block
            if layer.kind == "rglru":
                R.rglru_init(a, cfg, gen)
            elif layer.kind == "mlstm":
                S.mlstm_init(a, cfg, gen)
            elif layer.kind == "slstm":
                S.slstm_init(a, cfg, gen)
            else:
                _attn_init(a, cfg, gen)
            mlps = [layer.mlp]
            if layer.moe is not None:
                M.moe_init(layer.moe, cfg, gen)
                mlps.append(layer.moe.shared)
            for m in mlps:
                if m is not None:
                    _mlp_init(m, cfg, gen)
            if layer.cross is not None:
                _attn_init(layer.cross, cfg, gen)
        fp = model.frontend_proj
        if fp is not None:
            fp.w1.copy_(L.dense_init(gen, cfg.frontend_dim, (d,), dt, dev))
            fp.w2.copy_(L.dense_init(gen, d, (d,), dt, dev))
        for enc in model.encoder or ():
            _attn_init(enc.block, cfg, gen)
            _mlp_init(enc.mlp, cfg, gen)
    return model


# ---------------------------------------------------------------------------
# embed / head
# ---------------------------------------------------------------------------

def _embed_inputs(model: Transformer, tokens: Optional[torch.Tensor],
                  embeds: Optional[torch.Tensor] = None, ctx=None
                  ) -> torch.Tensor:
    """Table in the compute dtype, gather, then scale by sqrt(d_model).
    With ``embeds`` (B, F, frontend_dim) and a frontend but no encoder
    (the vision frontend) the projected rows come first, the prompt's
    after them, as the reference's ``_embed_inputs``. Under a ``ctx``
    whose "model" axis cuts the table's rows, each rank looks up the
    tokens its rows hold, zeros elsewhere, and the ranks sum."""
    cfg = model.cfg
    parts = []
    if embeds is not None and cfg.frontend and cfg.n_encoder_layers == 0:
        parts.append(_project(model, embeds, ctx))
    if tokens is not None:
        if ctx is not None and ctx.split(model, "embed"):
            parts.append(_embed_split(model.embed, tokens, ctx)
                         * math.sqrt(cfg.d_model))
        else:
            parts.append(model.embed[tokens.long()] * math.sqrt(cfg.d_model))
    return torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]


def _embed_split(table: torch.Tensor, tokens: torch.Tensor, ctx
                 ) -> torch.Tensor:
    """Vocabulary-parallel lookup: this rank's rows of the table are
    ``[off, off + rows)``; a token outside them gives zeros, and the
    "model" ranks' rows sum to the token's row."""
    rows = table.shape[0]
    local = tokens.long() - ctx.tp_index * rows
    hit = (local >= 0) & (local < rows)
    x = table[local.clamp(0, rows - 1)] * hit[..., None].to(table.dtype)
    return ctx.tp_out(x)


def _project(model: Transformer, embeds: torch.Tensor, ctx=None
             ) -> torch.Tensor:
    """The frontend projector: gelu(embeds @ w1) @ w2 in the compute
    dtype (gelu's tanh form, the reference's ``jax.nn.gelu``). Under a
    ``ctx`` whose "model" axis cuts w1's columns and w2's rows, the
    rank's columns, the partial outputs summed over "model"; any other
    cut gathered whole (``ShardCtx.whole``)."""
    fp = model.frontend_proj
    split = ctx is not None and ctx.split(fp, "w1") and ctx.split(fp, "w2")
    if ctx is not None and not split:
        fp = ctx.whole(fp)
    e = embeds.to(device=fp.w1.device, dtype=_dtype(model.cfg.dtype))
    out = L.act_fn("gelu")(e @ fp.w1) @ fp.w2
    return ctx.tp_out(out) if split else out


def frontend_prefix(cfg: ModelConfig) -> int:
    """Rows a decoder-only frontend config puts ahead of every prompt
    (``frontend_tokens``): ``frontend_rows`` of its ``embeds``, known from
    the config alone."""
    return cfg.frontend_tokens if cfg.frontend and not cfg.n_encoder_layers \
        else 0


def frontend_rows(cfg: ModelConfig, embeds) -> int:
    """Rows a request's ``embeds`` put ahead of its prompt in the
    decoder's cache: the frontend's rows for a decoder-only frontend
    config, none for an encoder-decoder (its frames feed the encoder) or
    a config without a frontend."""
    if embeds is None or not cfg.frontend or cfg.n_encoder_layers:
        return 0
    return int(embeds.shape[-2])


def _lm_head(x: torch.Tensor, model: Transformer) -> torch.Tensor:
    """LM head in x.dtype, the padded vocabulary left unmasked.
    x: (..., D) -> (..., padded_vocab)."""
    if model.cfg.tie_embeddings:
        return x @ model.embed.to(x.dtype).t()
    return x @ model.lm_head.to(x.dtype)


def _head_logits(x: torch.Tensor, model: Transformer, ctx=None
                 ) -> torch.Tensor:
    """LM head in x.dtype with the padded vocabulary masked to -1e30.
    x: (..., D) -> (..., padded_vocab). Under a ``ctx`` whose "model"
    axis cuts the head's vocabulary, this rank's columns only, (...,
    padded_vocab / model), the padding masked at the rank's offset."""
    cfg = model.cfg
    off = 0
    if ctx is not None and ctx.split(
            model, "embed" if cfg.tie_embeddings else "lm_head"):
        x = ctx.tp_in(x)
        off = ctx.tp_index * (cfg.padded_vocab_size // ctx.tp)
    logits = _lm_head(x, model)
    if cfg.padded_vocab_size != cfg.vocab_size:
        pad = torch.arange(off, off + logits.shape[-1],
                           device=x.device) >= cfg.vocab_size
        logits = torch.where(pad, torch.full_like(logits.float(), -1e30),
                             logits.float()).to(logits.dtype)
    return logits


# ---------------------------------------------------------------------------
# forward (train / no-cache)
# ---------------------------------------------------------------------------

def _ffn(layer, x: torch.Tensor, cfg: ModelConfig, ctx=None
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """A layer's MoE or MLP after its block: (x, the MoE's aux loss or
    None), on the rank's cut under a ``ctx``."""
    if layer.moe is not None:
        return M.moe_apply(layer.moe, x, cfg, ctx)
    if layer.mlp is not None:
        x = L.mlp_apply(layer.mlp, x, cfg, ctx=ctx)
    return x, None


def _layer_apply(layer, x: torch.Tensor, cfg: ModelConfig, *,
                 positions: torch.Tensor,
                 enc_out: Optional[torch.Tensor] = None, ctx=None
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One layer of ``forward``: (x, its aux loss or None). Under a
    ``ctx`` the layer's compute copy is gathered first (``ctx.layer``)
    and its block and MLP run on the rank's shards."""
    if ctx is not None:
        layer = ctx.layer(layer)
    if layer.kind == "rglru":
        x = R.rglru_apply(layer.block, x, cfg, ctx=ctx)
    elif layer.kind == "mlstm":
        x = S.mlstm_apply(layer.block, x, cfg, ctx=ctx)
    elif layer.kind == "slstm":
        x = S.slstm_apply(layer.block, x, cfg, ctx=ctx)
    else:
        x = L.attn_apply(layer.block, x, cfg, kind=layer.kind,
                         positions=positions, ctx=ctx)
    if layer.cross is not None and enc_out is not None:
        x = L.cross_attn_apply(
            layer.cross, x, *L.cross_kv(layer.cross, enc_out, cfg, ctx), cfg,
            ctx=ctx)
    return _ffn(layer, x, cfg, ctx)


def _run_stack(params, x: torch.Tensor, cfg: ModelConfig, *,
               positions: torch.Tensor, enc_out=None, train: bool = True,
               ctx=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The decoder layers in ``layer_kinds`` order: (x, the aux losses
    summed over the layers, in layer order). With ``cfg.remat and
    train`` each scanned period runs under ``torch.utils.checkpoint``
    (its activations recomputed in the backward, as the reference's
    ``jax.checkpoint`` of the scan body); the remainder layers do not.
    Under a ``ctx`` each layer's compute copy is gathered inside that
    span (``ctx.layer``), so the backward gathers it again, and each
    period's output passes ``ctx.act``."""
    period = len(cfg.layer_pattern)

    def run_layers(x, aux, first, last):
        for layer in params.layers[first:last]:
            x, a = _layer_apply(layer, x, cfg, positions=positions,
                                enc_out=enc_out, ctx=ctx)
            if a is not None:
                aux = aux + a
        return x, aux

    aux = torch.zeros((), device=x.device)
    for p in range(cfg.n_periods):
        span = (p * period, (p + 1) * period)
        if cfg.remat and train:
            x, aux = checkpoint(run_layers, x, aux, *span,
                                use_reentrant=False)
        else:
            x, aux = run_layers(x, aux, *span)
        if ctx is not None:
            x = ctx.act(x)
    return run_layers(x, aux, cfg.n_periods * period, len(params.layers))


def _positions(x: torch.Tensor) -> torch.Tensor:
    b, s = x.shape[:2]
    return torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)


def encode(params, cfg: ModelConfig, embeds: torch.Tensor, *,
           train: bool = False, ctx=None) -> torch.Tensor:
    """The encoder stack over frontend embeddings (B, S_src,
    frontend_dim): the projector, then each encoder layer (RoPE'd
    bidirectional attention, the MLP), then ``enc_norm``; (B, S_src, d).
    With ``cfg.remat and train`` each layer runs under
    ``torch.utils.checkpoint``, as the reference wraps its encoder
    layers in ``jax.checkpoint``."""
    if embeds is None:
        raise ValueError(f"{cfg.name}: the encoder needs embeds")
    x = _project(params, embeds, ctx)
    positions = _positions(x)

    def enc_layer(x, lp):
        if ctx is not None:
            lp = ctx.layer(lp)
        x = L.attn_encoder_apply(lp.block, x, cfg, positions=positions,
                                 ctx=ctx)
        return L.mlp_apply(lp.mlp, x, cfg, ctx=ctx)
    for lp in params.encoder:
        if cfg.remat and train:
            x = checkpoint(enc_layer, x, lp, use_reentrant=False)
        else:
            x = enc_layer(x, lp)
    return L.rms_norm(x, params.enc_norm, cfg.norm_eps)


def _inputs(params, cfg: ModelConfig, tokens, embeds, train: bool,
            ctx=None):
    """The decoder's input rows and the encoder's output (None without
    an encoder): an encoder-decoder encodes ``embeds`` and embeds the
    tokens alone; a frontend decoder puts the projected rows first."""
    if cfg.n_encoder_layers:
        return (_embed_inputs(params, tokens, ctx=ctx),
                encode(params, cfg, embeds, train=train, ctx=ctx))
    return _embed_inputs(params, tokens, embeds, ctx=ctx), None


def _prepare(model: Transformer, cfg: ModelConfig, ctx=None):
    """The compute copy (``cast_params_for_compute``) and, under a
    ``ctx``, its leaves outside the layers gathered to their compute
    layout (the reference's ``_prepare``); the layers are gathered one
    at a time inside the stack (``ctx.layer``)."""
    params = cast_params_for_compute(model, cfg)
    return params if ctx is None else ctx.prepare(params)


def forward(model: Transformer, cfg: ModelConfig, batch: Dict, *,
            train: bool = True, ctx=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """batch: {"tokens": (B, S) int, and with a frontend "embeds": (B,
    F, frontend_dim)}. Returns (logits (B, S_total, Vp) in the compute
    dtype, S_total = F + S for a decoder-only frontend config, else S;
    the MoE layers' aux loss summed, 0.0 without MoE). The compute copy
    is cast from ``model``'s params at every call. Under a ``ctx``
    (``sharding.ShardCtx``) ``model`` holds this rank's shards, the batch
    is this rank's rows, and the logits are this rank's vocabulary
    columns where the "model" axis cuts the head."""
    params = _prepare(model, cfg, ctx)
    x, enc_out = _inputs(params, cfg, batch.get("tokens"),
                         batch.get("embeds"), train, ctx)
    x, aux = _run_stack(params, x, cfg, positions=_positions(x),
                        enc_out=enc_out, train=train, ctx=ctx)
    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    if ctx is not None:
        x = ctx.batch_only(x)
    return _head_logits(x, params, ctx), aux


def loss_fn(model: Transformer, cfg: ModelConfig, batch: Dict, ctx=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy in fp32, as the reference computes it:
    logits[:, :-1] against ``labels[:, 1:]`` (B, S_total), with -1 =
    masked (a vision frontend's rows among them).
    The picked logit is a gather (the reference's one-hot contraction is
    the same sum). An MoE config's loss adds ``router_aux_weight`` x the
    aux loss; ``ce`` is the cross-entropy alone. Returns (loss, {"ce",
    "aux"}).

    Under a ``ctx`` the batch is this rank's rows: the token count is
    summed over the batch axes, and the loss too, whose backward leaves
    each rank the gradient of its own rows; the aux loss is averaged
    over the batch ranks alike. Where the "model" axis cuts
    the vocabulary, the log-sum-exp is reduced across the shards (the
    largest logit, then the sum of exponentials) and the picked logit is
    the shard's that holds the target."""
    logits, aux = forward(model, cfg, batch, train=True, ctx=ctx)
    logits = logits[:, :-1].float()
    targets = batch["labels"][:, 1:].long()
    mask = (targets >= 0).float()
    if ctx is not None and logits.shape[-1] != cfg.padded_vocab_size:
        lse, picked = _split_lse_picked(logits, targets, ctx)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        picked = logits.gather(-1, targets.clamp(min=0)[..., None])[..., 0]
    nll = (lse - picked) * mask
    count = mask.sum()
    if ctx is not None:
        from repro_torch.sharding import comm
        count = comm.all_reduce_(count, ctx.mesh, ctx.batch)
    ce = nll.sum() / torch.clamp(count, min=1.0)
    if ctx is not None:
        ce = comm.all_reduce(ce, ctx.mesh, ctx.batch)
        if cfg.moe is not None:
            # each rank's aux is its rows' mean (the same on every
            # "model" rank): the batch's is the mean over the batch
            # ranks, each rank's gradient that of its own share
            aux = comm.all_reduce(aux / ctx.mesh.size(ctx.batch), ctx.mesh,
                                  ctx.batch)
    loss = ce if cfg.moe is None else ce + cfg.moe.router_aux_weight * aux
    return loss, {"ce": ce.detach(), "aux": aux.detach()}


def _split_lse_picked(logits: torch.Tensor, targets: torch.Tensor, ctx):
    """Log-sum-exp and the target's logit over vocabulary shards: the
    rank holds columns ``[off, off + V / model)`` of (B, S, V)."""
    from repro_torch.sharding import comm
    cols = logits.shape[-1]
    top = comm.all_reduce_(logits.detach().amax(dim=-1), ctx.mesh, "model",
                           op="max")
    sumexp = torch.exp(logits - top[..., None]).sum(dim=-1)
    lse = top + torch.log(ctx.tp_out(sumexp))
    local = targets - ctx.tp_index * cols
    hit = (local >= 0) & (local < cols)
    picked = logits.gather(-1, local.clamp(0, cols - 1)[..., None])[..., 0]
    return lse, ctx.tp_out(picked * hit.float())


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def _cache_size_for(kind: str, cfg: ModelConfig, max_len: int) -> int:
    if kind == "attn_local":
        return min(cfg.window, max_len)
    if kind == "attn":
        return cfg.max_cache_len or max_len
    return 0


def _cross_cache(cfg: ModelConfig, batch: int, max_len: int,
                 device) -> Dict[str, torch.Tensor]:
    """An encoder-decoder attention layer's zeroed cross cache:
    {"cross_k", "cross_v"} (batch, max_len, Hk, hd) and ``cross_len``
    (batch,) int32, the source rows each sequence holds; {} without an
    encoder."""
    if not cfg.n_encoder_layers:
        return {}
    shape = (batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    dtype = _dtype(cfg.dtype)
    return {"cross_k": torch.zeros(shape, dtype=dtype, device=device),
            "cross_v": torch.zeros(shape, dtype=dtype, device=device),
            "cross_len": torch.zeros((batch,), dtype=torch.int32,
                                     device=device)}


def _layer_cache(kind: str, cfg: ModelConfig, batch: int, max_len: int,
                 device) -> Dict[str, torch.Tensor]:
    """One layer's zeroed decode cache: {"k", "v"} (batch, S_cache, Hk,
    hd) for attention (S_cache ``min(window, max_len)`` for
    ``attn_local``) and an encoder-decoder's ``_cross_cache``, {"h":
    (batch, d) fp32, "conv": (batch, W - 1, d)} for ``rglru``, and
    ``ssm.state_shapes``' leaves for ``mlstm`` (C, n zero and m = -1e30
    in fp32, the conv tail in the compute dtype) and ``slstm`` (c = 0,
    n = 1, m = -1e30, h = 0 in fp32)."""
    dtype = _dtype(cfg.dtype)
    state = S.state_shapes(kind, cfg, batch)
    if state is not None:
        return {k: torch.full(shape, fill, device=device,
                              dtype=dtype if compute else torch.float32)
                for k, (shape, fill, compute) in state.items()}
    if kind == "rglru":
        d = cfg.d_model
        return {"h": torch.zeros((batch, d), device=device),
                "conv": torch.zeros((batch, cfg.rglru_conv_width - 1, d),
                                    dtype=dtype, device=device)}
    shape = (batch, _cache_size_for(kind, cfg, max_len), cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            **_cross_cache(cfg, batch, max_len, device)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device) -> Cache:
    """Zeroed decode cache, one ``_layer_cache`` per layer in
    ``cfg.layer_kinds`` order, as the reference's ``init_cache`` (whose
    cross K/V take ``src_len`` rows; here ``max_len``, with the source
    length a sequence holds in ``cross_len``)."""
    return [_layer_cache(kind, cfg, batch, max_len, device)
            for kind in cfg.layer_kinds]


def supports_chunked_prefill(cfg: ModelConfig) -> bool:
    """Chunked prefill (and prefix resume) extends a position-indexed
    global-attention cache chunk by chunk. Ring caches (``attn_local``
    windows, ``max_cache_len`` caps), recurrent state (whose prefill
    starts from the zero state, not a carried one) and encoders are
    served by the one-shot path instead, as in the reference."""
    return (all(k == "attn" for k in cfg.layer_kinds)
            and cfg.n_encoder_layers == 0 and not cfg.max_cache_len)


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     max_slots: int, *, max_len: int, device) -> Cache:
    """Paged counterpart of ``init_cache``: each ``attn`` layer's K/V
    live in one shared pool of ``num_blocks`` blocks of ``block_size``
    rows, {"k", "v"} (N, bs, Hk, hd), addressed through per-slot block
    tables; physical block 0 is the null block. Every other leaf (a
    local window's ring, a recurrent state, an encoder-decoder's cross
    K/V) keeps ``init_cache``'s shape at ``max_slots`` rows,
    slot-indexed, as in the reference."""
    dtype = _dtype(cfg.dtype)
    shape = (num_blocks, block_size, cfg.n_kv_heads, cfg.resolved_head_dim)
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device),
             **_cross_cache(cfg, max_slots, max_len, device)}
            if kind == "attn" else
            _layer_cache(kind, cfg, max_slots, max_len, device)
            for kind in cfg.layer_kinds]


def kv_row_bytes(cfg: ModelConfig) -> int:
    """Bytes of global-attention K+V cached per token row."""
    n_global = sum(1 for k in cfg.layer_kinds if k == "attn")
    nbytes = 2 if cfg.dtype in ("bfloat16", "float16") else 4
    return n_global * 2 * cfg.n_kv_heads * cfg.resolved_head_dim * nbytes


# ---------------------------------------------------------------------------
# prefill / decode
# ---------------------------------------------------------------------------

def _prefill_layer(layer, x: torch.Tensor, cfg: ModelConfig, *,
                   positions: torch.Tensor, max_len: int,
                   enc_out: Optional[torch.Tensor] = None, ctx=None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decoder layer of a prefill, by kind: (its output, its decode
    cache), as the reference's ``_layer_prefill``. An encoder-decoder's
    layer attends to ``enc_out`` and caches its cross K/V in the first
    rows of ``max_len``, with their count in ``cross_len``. Under a
    ``ctx`` the layer's compute copy is gathered first (``ctx.layer``)
    and its block and MLP run on the rank's shards."""
    if ctx is not None:
        layer = ctx.layer(layer)
    if layer.kind == "rglru":
        x, c = R.rglru_prefill_cache(layer.block, x, cfg, ctx=ctx)
    elif layer.kind == "mlstm":
        x, c = S.mlstm_prefill_cache(layer.block, x, cfg, ctx=ctx)
    elif layer.kind == "slstm":
        x, c = S.slstm_prefill_cache(layer.block, x, cfg, ctx=ctx)
    else:
        x, c = L.attn_prefill_cache(
            layer.block, x, cfg, kind=layer.kind, positions=positions,
            cache_size=_cache_size_for(layer.kind, cfg, max_len), ctx=ctx)
    if layer.cross is not None and enc_out is not None:
        ck, cv = L.cross_kv(layer.cross, enc_out, cfg, ctx)
        x = L.cross_attn_apply(layer.cross, x, ck, cv, cfg, ctx=ctx)
        if ctx is not None:
            c.update(L.cross_cache_held(layer.cross, enc_out, ck, cv, cfg,
                                        max_len, ctx))
        else:
            b, src = enc_out.shape[:2]
            c.update(_cross_cache(cfg, b, max_len, x.device))
            c["cross_k"][:, :src] = ck
            c["cross_v"][:, :src] = cv
            c["cross_len"].fill_(src)
    return _ffn(layer, x, cfg, ctx)[0], c


def _serving_head(params, x: torch.Tensor, cfg: ModelConfig, ctx
                  ) -> torch.Tensor:
    """Logits (B, Vp) of the last position of ``x`` (B, S, D), the
    final norm included; under a ``ctx`` the head's vocabulary shards
    gathered over "model"."""
    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)[:, -1]
    if ctx is None:
        return _head_logits(x, params)
    logits = _head_logits(ctx.batch_only(x), params, ctx)
    return ctx.full_vocab(logits, cfg.padded_vocab_size)


@torch.no_grad()
def prefill(model: Transformer, tokens: torch.Tensor, *, max_len: int,
            embeds: Optional[torch.Tensor] = None, ctx=None
            ) -> Tuple[torch.Tensor, Cache, torch.Tensor]:
    """Run the prompt (B, S) through the model, materializing the decode
    cache. ``embeds`` (B, F, frontend_dim): a vision frontend's rows,
    prefilled ahead of the prompt (the cache then holds F + S rows), or
    an encoder-decoder's source frames, encoded once and cached as each
    layer's cross K/V (F <= ``max_len``). Returns (last-position logits
    (B, Vp), cache, cache_len (B,) int32).

    Under a ``ctx`` (``sharding.ShardCtx`` of a sharded serving step,
    ``runtime.trainstep.make_prefill_step``) ``model`` holds this rank's
    fp32 master shards and ``tokens`` are its batch rows: the compute
    copy is cast at the call, its leaves outside the layers gathered
    first and each layer's just before it (ZeRO-3, as training), the
    layers run tensor parallel over "model", the logits are the rank's
    rows over the whole vocabulary and each cache leaf is this rank's
    shard under ``cache_spec`` (marked ``shard_spec``)."""
    cfg = model.cfg
    check_servable(cfg)
    if cfg.n_encoder_layers and embeds is not None \
            and embeds.shape[1] > max_len:
        raise ValueError(f"{cfg.name}: a source of {embeds.shape[1]} rows "
                         f"exceeds the cross cache's max_len {max_len}")
    params = model if ctx is None else _prepare(model, cfg, ctx)
    x, enc_out = _inputs(params, cfg, tokens, embeds, False, ctx)
    positions = _positions(x)
    cache: Cache = []
    for layer in params.layers:
        x, c = _prefill_layer(layer, x, cfg, positions=positions,
                              max_len=max_len, enc_out=enc_out, ctx=ctx)
        cache.append(c)
    logits = _serving_head(params, x, cfg, ctx)
    b, s = x.shape[:2]
    return logits, cache, torch.full((b,), s, dtype=torch.int32,
                                     device=x.device)


def _decode_layers(model: Transformer, x: torch.Tensor, cache: Cache,
                   cache_len: torch.Tensor, block_tables, lo: int, hi: int,
                   ctx=None) -> torch.Tensor:
    """Decoder layers ``lo .. hi - 1`` of one decode step. With
    ``block_tables`` the ``attn`` layers read their pool through the
    tables; ring and recurrent layers decode their slot-indexed leaves
    either way, and an encoder-decoder's layers attend to their cached
    cross K/V through the slotted kernel on both layouts. Under a
    ``ctx`` ``model`` is the compute copy (``_prepare``), each layer
    gathered just before it, and the layers run on the rank's shards of
    the weights and the cache."""
    cfg = model.cfg
    for layer, c in zip(model.layers[lo:hi], cache[lo:hi]):
        if ctx is not None:
            layer = ctx.layer(layer)
        if layer.kind == "rglru":
            x = R.rglru_decode(layer.block, x, cfg, cache=c, ctx=ctx)
        elif layer.kind == "mlstm":
            x = S.mlstm_decode(layer.block, x, cfg, cache=c, ctx=ctx)
        elif layer.kind == "slstm":
            x = S.slstm_decode(layer.block, x, cfg, cache=c, ctx=ctx)
        elif layer.kind == "attn" and block_tables is not None:
            x = L.attn_decode_paged(layer.block, x, cfg, k_pool=c["k"],
                                    v_pool=c["v"], tables=block_tables,
                                    cache_len=cache_len)
        else:
            x = L.attn_decode(layer.block, x, cfg, kind=layer.kind, cache=c,
                              cache_len=cache_len, ctx=ctx)
        if layer.cross is not None:
            x = L.cross_attn_decode(layer.cross, x, cfg, c, ctx=ctx)
        x = _ffn(layer, x, cfg, ctx)[0]
    return x


@torch.no_grad()
def decode_step(model: Transformer, token: torch.Tensor, cache: Cache,
                cache_len: torch.Tensor, *,
                block_tables: Optional[torch.Tensor] = None, ctx=None
                ) -> Tuple[torch.Tensor, Cache, torch.Tensor]:
    """One serving step: next-token logits for one new token per
    sequence. token: (B,) int; cache_len: (B,) int32 current context
    length. ``block_tables`` (B, nb) int32 switches the layers to the
    paged layout (``init_paged_cache``): each reads only the pages its
    table names. ``cache`` is updated in place (and returned, like the
    reference's functional step). Under a ``ctx`` (a sharded serving
    step, ``runtime.trainstep.make_serve_step``), as ``prefill``'s:
    ``model`` holds the rank's master shards, ``token`` and
    ``cache_len`` are its batch rows, ``cache`` its shards (their
    ``shard_spec`` says how each is placed), and the logits its rows over
    the whole vocabulary; the slotted layout only."""
    cfg = model.cfg
    check_servable(cfg)
    if ctx is not None and block_tables is not None:
        raise ValueError("a sharded serve step runs the slotted cache only")
    params = model if ctx is None else _prepare(model, cfg, ctx)
    x = _embed_inputs(params, token, ctx=ctx)[:, None]
    x = _decode_layers(params, x, cache, cache_len, block_tables, 0,
                       len(params.layers), ctx)
    return _serving_head(params, x, cfg, ctx), cache, cache_len + 1


def decode_stage_bounds(cfg: ModelConfig, num_stages: int) -> list:
    """Contiguous near-even partition of the decode depth (scan periods
    first, then remainder layers) into ``num_stages`` groups: returns
    ``num_stages + 1`` monotone boundaries over
    ``n_periods + len(remainder_kinds)`` depth units, as the reference's
    ``decode_stage_bounds``. A stage may be empty when there are more
    stages than depth units."""
    total = cfg.n_periods + len(cfg.remainder_kinds)
    return [s * total // num_stages for s in range(num_stages + 1)]


def _unit_layer(cfg: ModelConfig, unit: int) -> int:
    """First decoder layer of depth unit ``unit`` (a scanned period is
    one unit of ``len(layer_pattern)`` layers, a remainder layer one)."""
    per = len(cfg.layer_pattern)
    if unit <= cfg.n_periods:
        return unit * per
    return cfg.n_periods * per + (unit - cfg.n_periods)


@torch.no_grad()
def decode_step_staged(model: Transformer, token: torch.Tensor,
                       cache: Cache, cache_len: torch.Tensor, *,
                       num_stages: int,
                       block_tables: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, Cache, torch.Tensor]:
    """``decode_step`` with the layer stack partitioned into
    ``num_stages`` contiguous depth groups (``decode_stage_bounds``),
    the stage-partitioned step behind pipelined decode: the execution
    core models stage k of one microbatch overlapping stage k-1 of the
    next, and this is the matching split of the computation. The embed
    feeds the first stage and the head reads the last; each layer runs
    the same kernels on the same values in the same order as in
    ``decode_step``, so logits and cache are bit-identical to it."""
    if num_stages <= 1:
        return decode_step(model, token, cache, cache_len,
                           block_tables=block_tables)
    cfg = model.cfg
    check_servable(cfg)
    x = _embed_inputs(model, token)[:, None]
    cuts = decode_stage_bounds(cfg, num_stages)
    for lo, hi in zip(cuts, cuts[1:]):
        x = _decode_layers(model, x, cache, cache_len, block_tables,
                           _unit_layer(cfg, lo), _unit_layer(cfg, hi))
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
    check_servable(cfg)
    assert supports_chunked_prefill(cfg), cfg.name
    x = _embed_inputs(model, tokens)
    c = x.shape[1]
    for layer, lc in zip(model.layers, cache):
        x = L.attn_extend(layer.block, x, cfg, kind=layer.kind, cache=lc,
                          cache_len=cache_len)
        x = _ffn(layer, x, cfg)[0]
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
    """Write a batch=1 prefill (or scratch) cache into the paged cache:
    each ``attn`` layer's K/V rows go page-wise into the physical blocks
    named by ``block_ids`` (one per logical page; 0 = the null block, for
    pages past the allocation or pages shared with another request), and
    every other leaf (a ring, a recurrent state, the cross K/V) is
    written at ``slot``,
    as the reference's ``ins_slot`` does. Rows of ``req_cache`` past the
    slot's page span (a chunk-rounded scratch cache is longer) are
    dropped: they lie beyond ``max_len``."""
    for kind, big, small in zip(cfg.layer_kinds, cache, req_cache):
        pooled = ("k", "v") if kind == "attn" else ()
        for key, leaf in big.items():
            if key not in pooled:
                leaf[slot] = small[key][0]
        if pooled:
            ids = _ids(block_ids, big["k"].device)
            sg = ids.shape[0] * block_size
            for key in pooled:
                rows = small[key][0, :sg]
                big[key][ids] = rows.reshape(ids.shape[0], block_size,
                                             *rows.shape[1:])
    return cache


@torch.no_grad()
def paged_seed(cfg: ModelConfig, scratch: Cache, cache: Cache,
               block_ids) -> Cache:
    """Inverse of ``paged_insert`` for a shared prompt prefix: copy the
    ``attn`` layers' K/V rows of the pool blocks ``block_ids`` (in page
    order) into the head of a batch=1 scratch cache, so
    ``prefill_extend`` can resume mid-prompt. Whole pages are copied;
    rows past the match are either recomputed by the extend or lie
    beyond the prompt. Only ``supports_chunked_prefill`` configs get
    here, whose every layer is ``attn``."""
    for kind, sc, c in zip(cfg.layer_kinds, scratch, cache):
        if kind != "attn":
            continue
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
    """Copy one physical block's rows to another in every ``attn``
    layer's pool: the device half of copy-on-write."""
    for kind, c in zip(cfg.layer_kinds, cache):
        if kind == "attn":
            for key in ("k", "v"):
                c[key][dst] = c[key][src]
    return cache


# ---------------------------------------------------------------------------
# VR-PRUNE actor-graph export (the Edge-PRUNE integration)
# ---------------------------------------------------------------------------

def to_actor_graph(cfg: ModelConfig, model: Optional[Transformer] = None,
                   *, batch: int = 1, seq: int = 8, group_size: int = 1):
    """Export the model as a VR-PRUNE dataflow graph: one actor per group
    of ``group_size`` layers (plus Input / Embed / Head actors), each edge
    annotated with its real token size, as the reference's
    ``to_actor_graph`` does: the same actor names, token shapes, dtypes
    and ``cost_flops``. With ``model`` the actors carry fire functions
    that run the layers of ``forward`` (``_layer_apply``: the flash
    kernel for every attention layer, the scan's forward kernel for every
    ``rglru`` layer, the MoE, mLSTM and sLSTM layers in plain PyTorch)
    on the compute copy of the weights, cast once here; without it the
    graph carries costs only.

    The Head applies the final norm and the head without masking a
    padded vocabulary, and its sink result is the logits tensor itself,
    as in the reference. A frontend or an encoder is refused: the
    reference's export embeds the tokens alone and fires the layers
    without the encoder's output, so its graph would drop them."""
    from repro_torch.core.graph import Actor, ActorType, Graph, Port, PortDir

    if cfg.frontend or cfg.n_encoder_layers:
        raise ValueError(f"{cfg.name}: the actor-graph export carries "
                         f"tokens only; a frontend's embeddings and an "
                         f"encoder have no actor in it")

    g = Graph(cfg.name)
    d = cfg.d_model
    tok_shape = (batch, seq, d)
    hd = cfg.resolved_head_dim
    qkv_out = (cfg.n_heads + 2 * cfg.n_kv_heads) * hd

    def block_flops(kind):
        f = 0.0
        if kind in ("attn", "attn_local"):
            ctx = min(seq, cfg.window) if kind == "attn_local" else seq
            f = 2.0 * seq * d * (qkv_out + cfg.n_heads * hd) \
                + 4.0 * seq * ctx * cfg.n_heads * hd
        elif kind == "rglru":
            f = 2.0 * seq * d * (2 * d + 2 * d + d) + 10.0 * seq * d
        elif kind == "mlstm":
            dm = int(cfg.mlstm_proj_factor * d)
            f = 2.0 * seq * d * 2 * dm + 2.0 * seq * dm * d \
                + 4.0 * seq * min(seq, 256) * dm
        elif kind == "slstm":
            ds = int(cfg.slstm_proj_factor * d)
            f = 2.0 * seq * d * (4 * d + 2 * ds) + 2.0 * seq * 4 * d * (d // max(cfg.n_heads, 1))
        if kind in _HAS_MLP:
            if cfg.moe:
                f += 2.0 * seq * d * 3 * cfg.moe.d_ff_expert \
                    * (cfg.moe.top_k + cfg.moe.n_shared_experts)
            else:
                f += 2.0 * seq * d * 3 * cfg.d_ff
        return batch * f

    kinds = cfg.layer_kinds
    groups = [list(range(i, min(i + group_size, len(kinds))))
              for i in range(0, len(kinds), group_size)]
    if model is not None:
        with torch.no_grad():
            params = cast_params_for_compute(model, cfg)
        # the ports fix the token shape, so every Layers actor takes the
        # same positions: made once here, as ``forward`` makes them a call
        positions = torch.arange(seq, dtype=torch.int32,
                                 device=model.device).expand(batch, seq)

    def fires(fn):
        """``fn`` without autograd, or no fire function without weights."""
        if model is None:
            return None

        def fire(inputs, st, atr):
            with torch.no_grad():
                return fn(inputs, st, atr)
        return fire

    # Input -> Embed -> LayerGroup_i ... -> Head
    inp = Actor("Input", ActorType.SPA,
                [], [Port("out", PortDir.OUT, token_shape=(batch, seq),
                          token_dtype="int32")],
                fire_fn=lambda inputs, st, atr: (
                    {"out": [inputs["__feed__"][0]]}, st))
    g.add_actor(inp)

    def embed_fire(inputs, st, atr):
        (tok,) = inputs["in"]
        return {"out": [_embed_inputs(params, tok)]}, st

    emb = Actor("Embed", ActorType.SPA,
                [Port("in", PortDir.IN, token_shape=(batch, seq),
                      token_dtype="int32")],
                [Port("out", PortDir.OUT, token_shape=tok_shape,
                      token_dtype=cfg.dtype)],
                fire_fn=fires(embed_fire),
                cost_flops=2.0 * batch * seq * d)
    g.add_actor(emb)
    g.connect(inp.port("out"), emb.port("in"))

    prev = emb
    for idxs in groups:
        def make_fire(idxs):
            def fire(inputs, st, atr):
                (x,) = inputs["in"]
                for li in idxs:
                    x = _layer_apply(params.layers[li], x, cfg,
                                     positions=positions)[0]
                return {"out": [x]}, st
            return fire

        a = Actor(f"Layers{idxs[0]}-{idxs[-1]}", ActorType.SPA,
                  [Port("in", PortDir.IN, token_shape=tok_shape,
                        token_dtype=cfg.dtype)],
                  [Port("out", PortDir.OUT, token_shape=tok_shape,
                        token_dtype=cfg.dtype)],
                  fire_fn=fires(make_fire(idxs)),
                  cost_flops=sum(block_flops(kinds[li]) for li in idxs),
                  meta={"layers": idxs})
        g.add_actor(a)
        g.connect(prev.port("out"), a.port("in"))
        prev = a

    def head_fire(inputs, st, atr):
        (x,) = inputs["in"]
        x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
        return {"result": _lm_head(x, params)}, st

    head = Actor("Head", ActorType.SPA,
                 [Port("in", PortDir.IN, token_shape=tok_shape,
                       token_dtype=cfg.dtype)], [],
                 fire_fn=fires(head_fire),
                 cost_flops=2.0 * batch * seq * d * cfg.vocab_size)
    g.add_actor(head)
    g.connect(prev.port("out"), head.port("in"))
    return g


__all__ = ["Transformer", "init_params", "cast_params_for_compute",
           "to_compute_dtype_", "check_trainable", "check_servable",
           "forward", "loss_fn", "encode", "frontend_prefix", "frontend_rows",
           "init_cache", "init_paged_cache", "kv_row_bytes", "prefill",
           "decode_step", "decode_step_staged", "decode_stage_bounds",
           "prefill_extend", "supports_chunked_prefill",
           "paged_insert", "paged_seed", "paged_copy_block",
           "resolve_device", "to_actor_graph", "Cache"]
