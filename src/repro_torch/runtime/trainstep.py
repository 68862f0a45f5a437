"""The training step of the port: the counterpart of
``repro.runtime.trainstep.make_train_step`` on one device (there is no
mesh).

The model holds fp32 master parameters with ``requires_grad``; each
forward casts the compute copy from them (``cast_params_for_compute``),
and the backward accumulates fp32 gradients into the masters' ``.grad``.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.runtime import optim


def _as_tensors(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, opt_cfg: optim.AdamWConfig, *,
                    microbatches: int = 1):
    """train_step(model, opt_state, batch) -> (model, opt, metrics).

    ``batch``: {"tokens", "labels"} (B, S) arrays or tensors. With
    ``microbatches > 1`` the batch is split on its leading dim and the
    gradients accumulated, as the reference does it: the microbatches'
    gradients summed, then scaled by 1 / microbatches; the loss and the
    metrics averaged. The model's parameters are updated in place.
    Metrics: ``loss``, ``ce``, ``aux`` (the MoE layers' summed aux loss,
    averaged over the microbatches like the others), ``grad_norm`` and
    ``lr``, 0-d tensors on the model's device. A parameter the loss
    never reads gets a zero gradient, as ``jax.grad`` gives it."""

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
        batch = _as_tensors(batch, model.device)
        lead = batch["tokens"].shape[0]
        if lead % microbatches:
            raise ValueError(f"batch {lead} does not split into "
                             f"{microbatches} microbatches")
        for p in params:
            p.grad = None
        loss, metrics = None, None
        for one in zip(*(v.chunk(microbatches) for v in batch.values())):
            l, m = T.loss_fn(model, cfg, dict(zip(batch, one)))
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
