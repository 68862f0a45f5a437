"""The step functions of the port: the counterparts of
``repro.runtime.trainstep``'s ``make_train_step``, ``make_prefill_step``
and ``make_serve_step``, on one device or over a mesh.

The model holds fp32 master parameters with ``requires_grad``; each
forward casts the compute copy from them (``cast_params_for_compute``),
and the backward accumulates fp32 gradients into the masters' ``.grad``.

With a mesh (``launch.mesh.make_debug_mesh``) the step is the
reference's ZeRO-3 discipline: the model holds this rank's fp32 master
shards (``sharding.shard_params``), sharded over "data" x "model" by
``params_shardings``, and so do its gradients and AdamW moments; the
forward gathers each layer's compute copy over "data" just before the
layer (``ShardCtx.layer``; the leaves outside the layers first, in
``transformer._prepare``), the backward reduce-scatters the gradients
back onto the shards, and the layers run tensor parallel over "model".
Every rank passes the same global batch; each takes its rows. The
sharded step trains every family: an MoE layer's experts go by expert
over "model" where their count divides it, else every expert by its ff
columns (``models.moe``); an xLSTM block runs on the rank's heads where
"model" divides them, the sLSTM's time loop with no collective inside,
else whole on every rank (``models.ssm``); an encoder's layers, the
decoder's cross attention and a frontend's projector run tensor
parallel like the decoder's (``models.layers``, ``transformer._project``).

The serving steps run the same program forward only: the model holds
this rank's fp32 master shards, each call casts the compute copy and
gathers it over "data" a layer at a time, and the layers run tensor
parallel over "model". The decode cache is placed by the cache rules
(``sharding.cache_spec``): a KV leaf by batch x kv heads where the kv
heads divide "model", else by batch x sequence over "model" (the
flash-decode layout: each rank attends over its rows of every
sequence, and the partial outputs are combined across ranks through
their log-sum-exp), and, where the batch does not divide the batch
axes (``long_500k``'s single sequence), by sequence over ("data",
"model"); an encoder-decoder's cross K/V like the K/V; RG-LRU states by
batch, their conv tail and, for a batch that does not divide, ``h`` cut
over "model" as the channels are; the mLSTM's ``C`` by heads over
"model" and its conv tail by channel where they divide. The global
batch's rows are cut over the batch axes where they divide, else every
rank runs all of them. ``make_prefill_step`` returns each rank's rows'
logits over the whole vocabulary, its cache shards (``shard_spec`` on
each leaf) and their ``cache_len``; ``make_serve_step`` takes those
shards (or ``sharding.shard_cache`` of a whole cache) with the global
batch's tokens and lengths. The same families as training, slotted
caches only (the reference's serve step passes no block tables).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.runtime import optim
from repro_torch.sharding.rules import ShardCtx, shard_batch

def _as_tensors(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _check_model(model, mesh, what: str) -> None:
    if getattr(model, "mesh", None) is not mesh:
        raise ValueError(f"{what} over {mesh} got a model sharded for "
                         f"{getattr(model, 'mesh', None)} "
                         f"(sharding.shard_params cuts one)")


def make_train_step(cfg: ModelConfig, opt_cfg: optim.AdamWConfig,
                    mesh=None, *, microbatches: int = 1):
    """train_step(model, opt_state, batch) -> (model, opt, metrics).

    ``batch``: {"tokens", "labels"} (B, S) arrays or tensors. With
    ``microbatches > 1`` the batch is split on its leading dim and the
    gradients accumulated, as the reference does it: the microbatches'
    gradients summed, then scaled by 1 / microbatches; the loss and the
    metrics averaged. The model's parameters are updated in place.
    Metrics: ``loss``, ``ce``, ``aux`` (the MoE layers' summed aux loss,
    averaged over the microbatches like the others), ``grad_norm`` and
    ``lr``, 0-d tensors on the model's device. A parameter the loss
    never reads gets a zero gradient, as ``jax.grad`` gives it.

    With ``mesh``, ``model`` must hold the shards ``shard_params`` cut
    for that mesh; ``batch`` is the global batch, every rank the same,
    split into microbatches first and each cut over the batch axes; the
    metrics are the global batch's, equal on every rank."""
    ctx = ShardCtx(mesh) if mesh is not None else None

    def train_step(model: T.Transformer, opt_state: Dict[str, Any],
                   batch: Dict[str, Any]
                   ) -> Tuple[T.Transformer, Dict[str, Any],
                              Dict[str, torch.Tensor]]:
        params = list(model.parameters())
        if any(p.dtype != torch.float32 or not p.requires_grad
               for p in params):
            raise ValueError("train_step wants fp32 master parameters with "
                             "requires_grad (init_params(..., dtype="
                             "torch.float32).requires_grad_(True))")
        _check_model(model, mesh, "train_step")
        batch = _as_tensors(batch, model.device)
        lead = batch["tokens"].shape[0]
        if lead % microbatches:
            raise ValueError(f"batch {lead} does not split into "
                             f"{microbatches} microbatches")
        for p in params:
            p.grad = None
        loss, metrics = None, None
        for one in zip(*(v.chunk(microbatches) for v in batch.values())):
            one = dict(zip(batch, one))
            if mesh is not None:
                one = shard_batch(one, mesh)
            l, m = T.loss_fn(model, cfg, one, ctx=ctx)
            l.backward()
            l = l.detach()
            if loss is None:
                loss, metrics = l, m
            else:
                loss = loss + l
                metrics = {k: metrics[k] + m[k] for k in metrics}
        for p in params:
            # a leaf the loss never reads (the shared experts' ln): the
            # zero gradient that jax.grad gives it
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if microbatches > 1:
            scale = 1.0 / microbatches
            with torch.no_grad():
                for p in params:
                    p.grad.mul_(scale)
            loss = loss * scale
            metrics = {k: v * scale for k, v in metrics.items()}
        model, opt_state, om = optim.apply(opt_cfg, model, opt_state)
        return model, opt_state, {"loss": loss, **metrics, **om}

    return train_step


def make_prefill_step(cfg: ModelConfig, *, max_len: int, mesh=None):
    """prefill_step(model, batch) -> (logits, cache, cache_len).

    ``batch``: {"tokens": (B, S)} and, with a frontend, "embeds" (arrays
    or tensors). Without a mesh, ``transformer.prefill`` on the model as
    it is held (a serving model holds its compute copy). With ``mesh``,
    ``model`` must hold the shards ``shard_params`` cut for it and every
    rank passes the same global batch: the logits (B_rank, Vp) are this
    rank's rows over the whole vocabulary, the cache its shards and
    ``cache_len`` its rows'."""

    def prefill_step(model: T.Transformer, batch: Dict[str, Any]):
        _check_model(model, mesh, "prefill_step")
        batch = _as_tensors(batch, model.device)
        tokens, embeds = batch["tokens"], batch.get("embeds")
        if mesh is None:
            return T.prefill(model, tokens, max_len=max_len, embeds=embeds)
        ctx = ShardCtx(mesh, batch=tokens.shape[0])
        return T.prefill(model, ctx.rows(tokens), max_len=max_len,
                         embeds=ctx.rows(embeds), ctx=ctx)

    return prefill_step


def make_serve_step(cfg: ModelConfig, mesh=None):
    """serve_step(model, cache, token, cache_len) -> (logits, cache,
    cache_len): one decode step, the cache updated in place.

    ``token`` and ``cache_len``: (B,) of the global batch, every rank the
    same. Without a mesh, ``transformer.decode_step``. With ``mesh``,
    ``model`` holds the rank's master shards and ``cache`` its shards
    (``make_prefill_step``'s, or ``sharding.shard_cache`` of a whole
    cache): the logits (B_rank, Vp) are its rows over the whole
    vocabulary and ``cache_len`` its rows' plus one."""

    def serve_step(model: T.Transformer, cache, token, cache_len):
        _check_model(model, mesh, "serve_step")
        token = torch.as_tensor(token, device=model.device)
        cache_len = torch.as_tensor(cache_len, dtype=torch.int32,
                                    device=model.device)
        if mesh is None:
            return T.decode_step(model, token, cache, cache_len)
        if any(not hasattr(t, "shard_spec") for c in cache
               for t in c.values()):
            raise ValueError("serve_step over a mesh wants the cache's shards "
                             "(make_prefill_step's, or sharding.shard_cache)")
        ctx = ShardCtx(mesh, batch=token.shape[0])
        return T.decode_step(model, ctx.rows(token), cache,
                             ctx.rows(cache_len), ctx=ctx)

    return serve_step
