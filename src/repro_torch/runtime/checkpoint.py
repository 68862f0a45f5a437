"""Checkpoints in the reference's format: one path-flattened ``.npz``
(keys such as ``scan/0/block/wq``, scan leaves stacked over periods)
plus a sidecar ``<path>.meta.json``, the counterpart of
``repro.runtime.checkpoint``. A checkpoint written by either package
restores in the other.

``save`` takes the port's model (written through
``repro_torch.weights.to_flat``, fp32) or a plain dict of arrays; a
sharded model (``sharding.shard_params``) is gathered first
(``gather_params``, a collective every rank of its mesh calls) and
written by the mesh's rank 0 alone, the same file an unsharded model of
those values writes;
``restore`` fills a model in place from a file; ``load_flat`` and
``load_meta`` read a file back as written, with no template.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.weights import flatten, load_flat_, to_flat


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save(path: str, tree: Any, *, meta: Optional[Dict] = None) -> None:
    """Write ``tree`` (a ``Transformer``, or nested dicts/lists of
    arrays) to ``path`` (``np.savez`` adds ``.npz``) and ``meta`` to
    ``path + ".meta.json"``."""
    mesh = getattr(tree, "mesh", None)
    if mesh is not None:
        from repro_torch.sharding.rules import gather_params
        tree = gather_params(tree)
        if any(mesh.coords.values()):
            return
    flat = to_flat(tree) if isinstance(tree, torch.nn.Module) else \
        flatten(tree)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **flat)
    with open(path + ".meta.json", "w") as fh:
        json.dump(meta or {}, fh)


def restore(path: str, model):
    """Fill ``model``'s parameters in place from a checkpoint (the
    template): every leaf must be there with the leaf's shape. Returns
    the model."""
    return load_flat_(model, load_flat(path))


def load_flat(path: str) -> Dict[str, np.ndarray]:
    """Load a ``save``d file as the flat ``{path: array}`` dict it was
    written from, without a template."""
    data = np.load(_npz(path))
    return {k: data[k] for k in data.files}


def load_meta(path: str) -> Dict:
    with open(path + ".meta.json") as fh:
        return json.load(fh)
