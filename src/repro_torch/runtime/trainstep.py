"""The training step of the port: the counterpart of
``repro.runtime.trainstep.make_train_step``, on one device or over a
mesh.

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
sharded step trains the dense and hybrid families (``attn``,
``attn_local``, ``rglru``); under a mesh of more than one rank it refuses
the MoE, xLSTM, encoder-decoder and frontend families, which a later
slice shards.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.runtime import optim
from repro_torch.sharding.rules import ShardCtx, shard_batch

LATER = "the MoE, xLSTM, encoder-decoder and frontend families under a mesh"


def check_shardable(cfg: ModelConfig, mesh) -> None:
    """Raise unless the sharded step runs ``cfg`` on ``mesh``: a mesh of
    one rank runs every config; more ranks run the decoders of
    ``attn``, ``attn_local`` and ``rglru`` layers without MoE, encoder
    or frontend."""
    if mesh is None or mesh.n_ranks == 1:
        return
    why = []
    if cfg.moe is not None:
        why.append("MoE (expert parallelism through expert_tensor)")
    kinds = sorted(set(cfg.layer_kinds) - {"attn", "attn_local", "rglru"})
    if kinds:
        why.append(f"{'/'.join(kinds)} layers")
    if cfg.n_encoder_layers:
        why.append("an encoder")
    if cfg.frontend:
        why.append("a frontend")
    if why:
        raise ValueError(f"{cfg.name}: the sharded train step does not yet "
                         f"shard {', '.join(why)} over a "
                         f"{'x'.join(map(str, mesh.shape.values()))} mesh; "
                         f"{LATER} come in a later slice (ROADMAP Queue 4)")


def _as_tensors(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


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
    check_shardable(cfg, mesh)
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
        if getattr(model, "mesh", None) is not mesh:
            raise ValueError(f"train_step over {mesh} got a model sharded "
                             f"for {getattr(model, 'mesh', None)} "
                             f"(sharding.shard_params cuts one)")
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
