"""Carry the reference's parameters into the port.

``from_jax_params`` takes the ``repro`` params pytree as numpy arrays —
``jax.tree.map(np.asarray, T.init_params(cfg, key))`` — or the flat
path-keyed dict that ``repro.runtime.checkpoint`` saves (keys such as
``scan/0/block/wq``), and fills a ``repro_torch`` ``Transformer``:

* ``scan[i]`` holds period slot ``i`` stacked over ``n_periods`` on a
  leading axis; period ``p``'s slot ``i`` is decoder layer
  ``p * len(layer_pattern) + i``;
* ``rem[j]`` is decoder layer ``n_periods * len(layer_pattern) + j``;
* ``embed``, ``final_norm`` and, unless embeddings are tied,
  ``lm_head`` map by name.

Every leaf is cast to the compute dtype, as the reference's
``cast_params_for_compute`` does at each step.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (Transformer,
                                            cast_params_for_compute)


def flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts/lists of arrays -> ``{"a/0/b": array}``, the key
    format of ``repro.runtime.checkpoint``. ``None`` leaves vanish, as
    they do in a JAX pytree."""
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        items: Iterator[Tuple[Any, Any]] = iter(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    elif tree is None:
        return out
    else:
        return {prefix: np.asarray(tree)}
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def layer_sources(cfg: ModelConfig) -> Iterator[Tuple[int, str, int]]:
    """For each decoder layer in ``layer_kinds`` order: (layer index,
    flat-key prefix in the reference tree, index on the stacked axis or
    -1 for an unstacked remainder layer)."""
    period = len(cfg.layer_pattern)
    for p in range(cfg.n_periods):
        for i in range(period):
            yield p * period + i, f"scan/{i}", p
    base = cfg.n_periods * period
    for j in range(len(cfg.remainder_kinds)):
        yield base + j, f"rem/{j}", -1


def from_jax_params(tree: Any, cfg: ModelConfig, device="cuda",
                    dtype=None) -> Transformer:
    """Build the port's model from reference params (pytree of numpy
    arrays, or the flat checkpoint dict). Raises on a missing, extra or
    misshapen leaf."""
    flat = tree if (isinstance(tree, dict) and any("/" in k for k in tree)) \
        else flatten(tree)
    model = Transformer(cfg, device=device, dtype=torch.float32)
    used = set()

    def put(param: torch.Tensor, key: str, index: int = -1) -> None:
        if key not in flat:
            raise KeyError(f"reference params lack {key!r}")
        arr = np.asarray(flat[key], dtype=np.float32)
        if index >= 0:
            arr = arr[index]
        if tuple(arr.shape) != tuple(param.shape):
            raise ValueError(f"{key}: shape {arr.shape} vs port "
                             f"{tuple(param.shape)}")
        param.copy_(torch.from_numpy(np.array(arr, np.float32)))
        used.add(key)

    with torch.no_grad():
        put(model.embed, "embed")
        put(model.final_norm, "final_norm")
        if model.lm_head is not None:
            put(model.lm_head, "lm_head")
        for li, prefix, idx in layer_sources(cfg):
            layer = model.layers[li]
            for name, param in layer.named_parameters():
                put(param, f"{prefix}/{name.replace('.', '/')}", idx)
    extra = sorted(set(flat) - used)
    if extra:
        raise ValueError(f"reference params the port does not take: {extra}")
    if dtype is None:
        return cast_params_for_compute(model, cfg)
    return model.to(dtype)
