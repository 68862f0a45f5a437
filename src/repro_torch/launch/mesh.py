"""Meshes and the card's constants: the counterpart of
``repro.launch.mesh``.

A ``Mesh`` lays ranks out over named axes, ``("data", "model")`` or
(abstract meshes only) ``("pod", "data", "model")``, the last axis
fastest: rank = d * model + m. A real mesh (``make_debug_mesh``) holds one
``torch.distributed`` process group for every set of its axes of more
than one rank, NCCL on the card and gloo on the CPU; every collective of
the port goes over those groups through ``repro_torch.sharding.comm``.
An abstract mesh (``abstract_mesh``) holds no group: it is rank 0 of the
given axes, for the dry run's per-device program on the meta device,
whose collectives return shapes and are counted, never issued.

The production meshes, as axis sizes:

Single pod: (data=16, model=16) = 256 cards.
Multi-pod:  (pod=2, data=16, model=16) = 512 cards.

The hardware constants are one NVIDIA H100 SXM's published peaks
(NVIDIA's data sheet; dense rates, no sparsity, at the full 700 W power
limit). They bound a step from below; they are never a measured time.
The link rates bound a collective's time the same way: NVLink 4 moves
at most 450 GB/s each way per card (900 GB/s both ways), which holds
inside a pod of up to 256 cards joined by the NVLink Switch System; the
"pod" axis crosses nodes over one 400 Gb/s InfiniBand NDR adapter per
card, 50 GB/s each way.
"""
from __future__ import annotations

import itertools
import math
import os
from typing import Dict, Iterable, Tuple

import torch

PEAK_FLOPS_BF16 = 989e12        # FLOP/s, bf16 and fp16, tensor cores
PEAK_FLOPS_FP32 = 67e12         # FLOP/s, fp32 outside the tensor cores
PEAK_FLOPS = {"bfloat16": PEAK_FLOPS_BF16, "float16": PEAK_FLOPS_BF16,
              "float32": PEAK_FLOPS_FP32}
HBM_BW = 3.35e12                # bytes/s
CHIP_HBM_BYTES = 80e9           # bytes
NVLINK_PEAK_BW = 450e9          # bytes/s each way per card, NVLink 4
POD_PEAK_BW = 50e9              # bytes/s each way per card, IB NDR 400 Gb/s
LINK_PEAK_BW = {"pod": POD_PEAK_BW, "data": NVLINK_PEAK_BW,
                "model": NVLINK_PEAK_BW}

AXES = ("pod", "data", "model")


class Mesh:
    """Ranks over named axes. ``shape``: axis -> size in mesh order;
    ``coords``: this rank's index on each axis; ``groups``: a tuple of
    axes (in mesh order, more than one rank) -> its process group, empty
    for an abstract mesh. ``device`` is where this rank's tensors live;
    ``counts`` (``repro_torch.sharding.comm.CommCount``) what its
    collectives moved."""

    def __init__(self, shape: Dict[str, int], coords: Dict[str, int],
                 groups: Dict[Tuple[str, ...], object], device,
                 abstract: bool):
        from repro_torch.sharding.comm import CommCount
        if [a for a in shape] != [a for a in AXES if a in shape] \
                or "model" not in shape or "data" not in shape:
            raise ValueError(f"mesh axes {tuple(shape)}: want (data, model) "
                             f"or (pod, data, model)")
        self.shape = dict(shape)
        self.coords = dict(coords)
        self.groups = groups
        self.device = torch.device(device)
        self.abstract = abstract
        self.counts = CommCount()

    @property
    def n_ranks(self) -> int:
        return math.prod(self.shape.values())

    def size(self, axes) -> int:
        """Ranks along one axis name or a tuple of them (absent: 1)."""
        return math.prod(self.shape.get(a, 1) for a in _names(axes))

    def index(self, axes) -> int:
        """This rank's index along ``axes``, the first axis major."""
        i = 0
        for a in _names(axes):
            i = i * self.shape.get(a, 1) + self.coords.get(a, 0)
        return i

    def group(self, axes):
        """The process group over ``axes`` (a real mesh; None for one
        rank)."""
        key = tuple(a for a in self.shape if a in _names(axes)
                    and self.shape[a] > 1)
        return self.groups.get(key)

    def __repr__(self) -> str:
        kind = "abstract" if self.abstract else self.device.type
        return (f"Mesh({'x'.join(str(v) for v in self.shape.values())} "
                f"{tuple(self.shape)}, {kind}, at {self.coords})")


def _names(axes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    return tuple(axes) if isinstance(axes, (tuple, list)) else (axes,)


def make_production_mesh(*, multi_pod: bool = False) -> Dict[str, int]:
    """The reference's production mesh as axis sizes, for accounting."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def parse_mesh(name: str) -> Dict[str, int]:
    """``"DxM"`` -> {"data": D, "model": M}; ``"PxDxM"`` adds "pod"."""
    sizes = [int(v) for v in name.split("x")]
    if len(sizes) not in (2, 3) or min(sizes) < 1:
        raise ValueError(f"mesh {name!r}: want DxM or PxDxM")
    return dict(zip(AXES[3 - len(sizes):], sizes))


def abstract_mesh(shape: Dict[str, int], device="meta") -> Mesh:
    """Rank 0 of ``shape`` with no process group: the dry run's
    per-device program, whose collectives are counted, not issued."""
    return Mesh(shape, {a: 0 for a in shape}, {}, device, abstract=True)


def init_world(rank: int, world: int, store_path: str, *,
               device="cuda") -> None:
    """Start the default process group of ``world`` ranks through a
    ``FileStore`` at ``store_path`` (no port to choose or collide on):
    NCCL for ``device="cuda"``, gloo for the CPU."""
    import torch.distributed as dist
    store = dist.FileStore(store_path, world)
    dist.init_process_group("nccl" if torch.device(device).type == "cuda"
                            else "gloo", store=store, rank=rank,
                            world_size=world)


def init_world_from_env(*, device="cuda") -> None:
    """Start the default process group from the variables ``torchrun``
    sets (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``)."""
    import torch.distributed as dist
    dist.init_process_group("nccl" if torch.device(device).type == "cuda"
                            else "gloo", init_method="env://")


def _subsets(shape: Dict[str, int]) -> Iterable[Tuple[str, ...]]:
    axes = [a for a in shape if shape[a] > 1]
    for r in range(1, len(axes) + 1):
        yield from itertools.combinations(axes, r)


def make_debug_mesh(data: int = 1, model: int = 1, *, device="cuda"
                    ) -> Mesh:
    """A real (data, model) mesh over the default process group, whose
    world must hold ``data * model`` ranks (a world of one rank with
    nothing started is started here, over a ``FileStore`` in a private
    temporary directory). ``device="cuda"`` (the default) needs that many
    CUDA devices and puts each rank on card ``LOCAL_RANK`` (else its
    rank) of its node; a CPU mesh exists
    only when the caller asks for ``device="cpu"``. Every rank calls this
    at once: the groups are made collectively."""
    import tempfile

    import torch.distributed as dist
    dev = torch.device(device)
    shape = {"data": data, "model": model}
    n = math.prod(shape.values())
    if dev.type == "cuda":
        have = torch.cuda.device_count()
        if have < n:
            raise RuntimeError(f"need {n} CUDA devices for a "
                               f"{'x'.join(map(str, shape.values()))} mesh, "
                               f"found {have}")
    elif dev.type != "cpu":
        raise ValueError(f"a mesh lives on cuda or cpu, not {dev.type}")
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(f"a {n}-rank mesh needs a started world of "
                               f"{n} ranks (init_world or torchrun)")
        init_world(0, 1, os.path.join(tempfile.mkdtemp(prefix="mesh"),
                                      "store"), device=dev)
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != n:
        raise RuntimeError(f"a {n}-rank mesh over a world of {world} ranks")
    want = "nccl" if dev.type == "cuda" else "gloo"
    if dist.get_backend() != want:
        raise RuntimeError(f"a {dev.type} mesh needs a {want} world, not "
                           f"{dist.get_backend()}")
    coords, rest = {}, rank
    for a in reversed(list(shape)):
        coords[a] = rest % shape[a]
        rest //= shape[a]
    coords = {a: coords[a] for a in shape}
    groups = {}
    for axes in _subsets(shape):
        # every rank makes every group, in one order; it keeps its own
        others = [a for a in shape if a not in axes]
        for fixed in itertools.product(*(range(shape[a]) for a in others)):
            members = [r for r in range(n)
                       if all(_coord(r, shape, a) == v
                              for a, v in zip(others, fixed))]
            g = dist.new_group(members)
            if rank in members:
                groups[axes] = g
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return Mesh(shape, coords, groups, dev, abstract=False)


def _coord(rank: int, shape: Dict[str, int], axis: str) -> int:
    stride = math.prod(shape[a] for a in list(shape)[list(shape).index(axis)
                                                     + 1:])
    return rank // stride % shape[axis]
