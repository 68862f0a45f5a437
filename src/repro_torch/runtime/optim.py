"""AdamW + gradient clipping + a warmup-cosine schedule, over the port's
fp32 master parameters: the counterpart of ``repro.runtime.optim``.

The state mirrors the parameters: fp32 first and second moments per
parameter and an integer step. The update is the reference's: the
global gradient norm summed over the leaves in the reference's flatten
order (``repro_torch.weights.reference_leaves``), clipping to
``grad_clip``, bias correction, and decoupled weight decay. Scalars
(step, schedule, bias corrections) are fp32 tensors, as in the
reference. Parameters are updated in place (the reference returns new
ones); ``apply`` returns the same model.

A sharded model (``sharding.shard_params``) holds this rank's shards of
the parameters, the moments are shards alike, and the update is the
same on them. The gradient norm sums each leaf's local squares once over
the ranks that hold a copy of it (the ranks at index 0 of every axis its
spec does not cut) and sums those across the mesh.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Iterable, Optional, Sequence, Tuple

import torch

from repro_torch.sharding.rules import spec_axes
from repro_torch.weights import reference_leaves


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_ratio * lr, in fp32."""
    step = step.float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) \
        * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init(model) -> Dict[str, Any]:
    """Zero fp32 moments for every parameter and step 0."""
    params = list(model.parameters())
    dev = params[0].device
    return {"m": [torch.zeros_like(p, dtype=torch.float32) for p in params],
            "v": [torch.zeros_like(p, dtype=torch.float32) for p in params],
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(leaves: Iterable[Iterable[torch.Tensor]], mesh=None,
                specs: Optional[Sequence] = None) -> torch.Tensor:
    """sqrt of the sum of squares, one term per reference leaf (a leaf
    stacked over periods sums its period tensors together), added in
    the order given. With ``mesh``, the leaves are this rank's shards
    under ``specs`` (one a leaf): a leaf's term is added on the ranks
    that own it (``owns``) and the sums are summed across the mesh."""
    sq = None
    for i, parts in enumerate(leaves):
        parts = list(parts)
        if mesh is not None and not owns(mesh, specs[i]):
            continue
        x = parts[0].float() if len(parts) == 1 else \
            torch.stack([t.float() for t in parts])
        term = torch.sum(torch.square(x))
        sq = term if sq is None else sq + term
    if mesh is not None:
        from repro_torch.sharding import comm
        if sq is None:
            sq = torch.zeros((), device=mesh.device)
        sq = comm.all_reduce_(sq, mesh, tuple(mesh.shape))
    return torch.sqrt(sq)


def owns(mesh, spec) -> bool:
    """Whether this rank counts a leaf of ``spec`` in a sum over the
    mesh: it is at index 0 of every axis the spec does not cut, so that
    each distinct shard is counted once."""
    held = spec_axes(spec)
    return all(mesh.coords[a] == 0 for a in mesh.shape if a not in held)


@torch.no_grad()
def apply(cfg: AdamWConfig, model, opt: Dict[str, Any]
          ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step from the gradients in each parameter's ``.grad``
    (of a sharded model, its shards'). Returns (model, opt,
    {"grad_norm", "lr"})."""
    mesh = getattr(model, "mesh", None)
    step = opt["step"] + 1
    leaves = reference_leaves(model).values()
    gnorm = global_norm(([p.grad for p in parts] for parts in leaves), mesh,
                        [parts[0].shard_spec for parts in leaves]
                        if mesh is not None else None)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, step)
    stepf = step.float()
    bc1 = 1 - torch.pow(torch.tensor(cfg.b1, device=stepf.device), stepf)
    bc2 = 1 - torch.pow(torch.tensor(cfg.b2, device=stepf.device), stepf)
    for p, m, v in zip(model.parameters(), opt["m"], opt["v"]):
        g = p.grad.float() * scale
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
        u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        u = u + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * u).to(p.dtype))
    return model, {"m": opt["m"], "v": opt["v"], "step": step}, \
        {"grad_norm": gnorm, "lr": lr}
