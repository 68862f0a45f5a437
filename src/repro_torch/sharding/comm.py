"""The port's collectives: the only place one is issued.

Each collective runs over one axis of a ``launch.mesh.Mesh``, or a tuple
of its axes, and counts its call and its bytes on the mesh's
``CommCount`` by kind, as the reference's dry run reads them out of the
HLO (``repro.launch.dryrun.collective_bytes``): the bytes of the result
one device holds, an all-gather's whole result, a reduce-scatter's
piece, an all-reduce's tensor. A collective over axes of one rank issues
nothing and counts nothing, as XLA elides it.

Two backends behind one call. On a real mesh the collective goes over
the mesh's ``torch.distributed`` group (NCCL or gloo). On an abstract
mesh (the dry run's rank 0, meta tensors) it returns an empty tensor of
the result's shape and counts it, as ``kernels.cost.KernelCount`` counts
a kernel on meta.

The differentiable ones pair as Megatron-LM pairs them:

* ``all_gather`` gathers a dim; its backward reduce-scatters the
  gradient (sums the ranks' partial gradients and keeps this rank's
  piece). ZeRO-3's weight gather over "data" is this.
* ``all_reduce`` sums across the ranks; its backward is the identity:
  every rank goes on with the same sum, and each is responsible for its
  own addend (a row-parallel product's partial output, a shard's share
  of the softmax denominator).
* ``reduce_grad`` is the identity forward; its backward sums the
  gradient across the ranks (the input of a column-parallel product,
  whose ranks each see part of the gradient).
* ``all_gather_replicated`` gathers a dim for a computation that every
  rank then repeats whole; its backward keeps this rank's piece of the
  gradient, which every rank holds whole and alike.

``all_reduce_`` sums a tensor in place with no gradient (a norm, a
count).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import torch

KINDS = ("all-gather", "reduce-scatter", "all-reduce")


@dataclass
class CommCount:
    """Calls and result bytes by collective kind, and bytes by the axes
    they crossed (``"data"``, ``"model"``, ``"pod,data"``...)."""
    calls: Dict[str, int] = field(default_factory=dict)
    bytes: Dict[str, int] = field(default_factory=dict)
    axis_bytes: Dict[str, int] = field(default_factory=dict)

    def add(self, kind: str, axes, nbytes: int) -> None:
        self.calls[kind] = self.calls.get(kind, 0) + 1
        self.bytes[kind] = self.bytes.get(kind, 0) + nbytes
        key = ",".join(axes)
        self.axis_bytes[key] = self.axis_bytes.get(key, 0) + nbytes

    def reset(self) -> None:
        self.calls.clear()
        self.bytes.clear()
        self.axis_bytes.clear()

    @property
    def total(self) -> int:
        return sum(self.bytes.values())

    def record(self) -> Dict:
        """The dry run's ``collectives``: bytes and calls by kind,
        ``total`` and ``count``, as the reference's record keys them."""
        out = {k: self.bytes.get(k, 0) for k in KINDS}
        out["calls"] = {k: self.calls.get(k, 0) for k in KINDS}
        out["by_axes"] = dict(self.axis_bytes)
        out["count"] = sum(self.calls.values())
        out["total"] = self.total
        return out

    def seconds(self, link_bw: Dict[str, float]) -> float:
        """Each axis set's bytes over its slowest link's rate: a bound,
        not a time."""
        return sum(n / min(link_bw[a] for a in key.split(","))
                   for key, n in self.axis_bytes.items())


def _axes(mesh, axes):
    """The axes of ``axes`` that hold more than one rank, in mesh
    order."""
    names = axes if isinstance(axes, (tuple, list)) else (axes,)
    return tuple(a for a in mesh.shape if a in names and mesh.shape[a] > 1)


def _nbytes(shape, dtype) -> int:
    n = torch.empty((), dtype=dtype).element_size()
    for d in shape:
        n *= d
    return n


def _check(mesh, x: torch.Tensor) -> None:
    if mesh.abstract and x.device.type != "meta":
        raise ValueError("an abstract mesh takes meta tensors only")
    if not mesh.abstract and x.device.type == "meta":
        raise ValueError("a real mesh's collective got a meta tensor")


def _gather(mesh, axes, x: torch.Tensor, dim: int) -> torch.Tensor:
    n = mesh.size(axes)
    shape = list(x.shape)
    shape[dim] *= n
    mesh.counts.add("all-gather", axes, _nbytes(shape, x.dtype))
    if mesh.abstract:
        return x.new_empty(shape)
    import torch.distributed as dist
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((n * xt.shape[0],) + xt.shape[1:])
    dist.all_gather_into_tensor(out, xt, group=mesh.group(axes))
    return out.movedim(0, dim)


def _scatter(mesh, axes, x: torch.Tensor, dim: int) -> torch.Tensor:
    n = mesh.size(axes)
    shape = list(x.shape)
    if shape[dim] % n:
        raise ValueError(f"reduce-scatter of {shape[dim]} rows over {n}")
    shape[dim] //= n
    mesh.counts.add("reduce-scatter", axes, _nbytes(shape, x.dtype))
    if mesh.abstract:
        return x.new_empty(shape)
    import torch.distributed as dist
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((xt.shape[0] // n,) + xt.shape[1:])
    dist.reduce_scatter_tensor(out, xt, op=dist.ReduceOp.SUM,
                               group=mesh.group(axes))
    return out.movedim(0, dim)


def _reduce(mesh, axes, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    mesh.counts.add("all-reduce", axes, _nbytes(x.shape, x.dtype))
    if mesh.abstract:
        return x.new_empty(x.shape)
    import torch.distributed as dist
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.SUM, group=mesh.group(axes))
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return _gather(mesh, axes, x, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim = ctx.args
        return _scatter(mesh, axes, g, dim), None, None, None


class _AllGatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return _gather(mesh, axes, x, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim = ctx.args
        n = g.shape[dim] // mesh.size(axes)
        return g.narrow(dim, mesh.index(axes) * n, n), None, None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return _reduce(mesh, axes, x)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _ReduceGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.args = (mesh, axes)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, axes = ctx.args
        return _reduce(mesh, axes, g), None, None


def all_gather(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """Concatenate the ranks' ``x`` along ``dim`` in rank order;
    backward: reduce-scatter."""
    axes = _axes(mesh, axes)
    if not axes:
        return x
    _check(mesh, x)
    return _AllGather.apply(x, mesh, axes, dim % x.dim())


def all_gather_replicated(x: torch.Tensor, mesh, axes, dim: int
                          ) -> torch.Tensor:
    """Concatenate the ranks' ``x`` along ``dim`` in rank order, for a
    computation each rank repeats on the whole; backward: this rank's
    piece of the gradient, no collective."""
    axes = _axes(mesh, axes)
    if not axes:
        return x
    _check(mesh, x)
    return _AllGatherReplicated.apply(x, mesh, axes, dim % x.dim())


def all_reduce(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Sum across the ranks; backward: the identity."""
    axes = _axes(mesh, axes)
    if not axes:
        return x
    _check(mesh, x)
    return _AllReduce.apply(x, mesh, axes)


def reduce_grad(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The identity; backward: sum the gradient across the ranks."""
    axes = _axes(mesh, axes)
    if not axes or not x.requires_grad:
        return x
    _check(mesh, x)
    return _ReduceGrad.apply(x, mesh, axes)


def all_reduce_(x: torch.Tensor, mesh, axes, op: str = "sum"
                ) -> torch.Tensor:
    """Sum (or, with ``op="max"``, the largest) across the ranks, no
    gradient: a new tensor, or ``x`` itself over one rank."""
    axes = _axes(mesh, axes)
    if not axes:
        return x
    _check(mesh, x)
    with torch.no_grad():
        return _reduce(mesh, axes, x.detach(), op)


@torch.no_grad()
def gather_dim(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """``all_gather`` with no gradient (checkpoints, ``gather_params``)."""
    axes = _axes(mesh, axes)
    if not axes:
        return x
    _check(mesh, x)
    return _gather(mesh, axes, x, dim % x.dim())
