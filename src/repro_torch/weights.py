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
  ``lm_head`` map by name, as do a frontend's ``frontend_proj/w1`` and
  ``w2`` and an encoder's ``enc_norm``;
* ``encoder`` is a list, not stacked: ``encoder/<i>/block/*`` and
  ``encoder/<i>/mlp/*`` are encoder layer ``i``'s.

A layer's leaves map by name whatever its kind (``block/wq`` of an
``attn`` or ``attn_local`` layer, ``block/w_in`` or ``block/lam`` of an
``rglru`` one, ``block/w_if`` of an ``mlstm`` and ``block/r`` of an
``slstm`` one, ``mlp/w_gate``, ``moe/router``, ``moe/w_down``,
``moe/shared/w_up``, an encoder-decoder's ``cross/wq``). By default
every leaf but the ``_KEEP_F32`` ones is cast to the compute dtype for
serving, as the
reference's ``cast_params_for_compute`` does at each step; training
asks for ``dtype=torch.float32`` masters.

``to_flat`` is the inverse: the port's model as the reference's flat
checkpoint dict, scan leaves stacked over periods again, for
checkpoints and tests. ``reference_leaves`` lists the port's tensors
behind each reference leaf in the reference's flatten order (the order
in which the optimizer sums the gradient norm); ``reference_cache``
does the same for a decode cache, and ``reference_shapes`` gives either
listing's stacked shapes and dtypes alone, reading no values, so that a
meta-device model or cache serves (the dry run's sharding accounting).
``seeded_flat`` draws a config's weights in that layout from a numpy
seed, the same numbers on any machine, so that a fixture can name its
weights by a seed.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, Tuple

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (Cache, Transformer, _dtype,
                                            to_compute_dtype_)


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
    model = load_flat_(Transformer(cfg, device=device, dtype=torch.float32),
                       flat)
    if dtype is None:
        return to_compute_dtype_(model, cfg)
    return model.to(dtype)


def _tree_order(key: str):
    """Sort key of a flat key in ``jax.tree`` flatten order: dict keys
    sorted as strings at each level, list indices in numeric order."""
    return tuple((0, int(p), "") if p.isdigit() else (1, 0, p)
                 for p in key.split("/"))


def reference_leaves(model: Transformer) -> Dict[str, List[torch.Tensor]]:
    """Reference flat key -> the port's parameters that make that leaf:
    one for an unstacked leaf, one per period (in period order) for a
    ``scan/...`` leaf. Keys in the reference's flatten order."""
    out: Dict[str, List[torch.Tensor]] = {
        "embed": [model.embed], "final_norm": [model.final_norm]}
    if model.lm_head is not None:
        out["lm_head"] = [model.lm_head]
    if model.frontend_proj is not None:
        out["frontend_proj/w1"] = [model.frontend_proj.w1]
        out["frontend_proj/w2"] = [model.frontend_proj.w2]
    if model.encoder is not None:
        out["enc_norm"] = [model.enc_norm]
        for i, enc in enumerate(model.encoder):
            for name, param in enc.named_parameters():
                out[f"encoder/{i}/{name.replace('.', '/')}"] = [param]
    for li, prefix, _ in layer_sources(model.cfg):
        for name, param in model.layers[li].named_parameters():
            out.setdefault(f"{prefix}/{name.replace('.', '/')}",
                           []).append(param)
    return dict(sorted(out.items(), key=lambda kv: _tree_order(kv[0])))


def reference_cache(cfg: ModelConfig, cache: Cache
                    ) -> Dict[str, List[torch.Tensor]]:
    """Reference flat key -> the port's cache tensors behind that leaf,
    as ``reference_leaves`` for parameters: ``scan/<i>/<leaf>`` one per
    period, ``rem/<j>/<leaf>`` one. The port's own leaves (an
    encoder-decoder's ``cross_len``) are listed like the others."""
    out: Dict[str, List[torch.Tensor]] = {}
    for li, prefix, _ in layer_sources(cfg):
        for name, t in cache[li].items():
            out.setdefault(f"{prefix}/{name}", []).append(t)
    return dict(sorted(out.items(), key=lambda kv: _tree_order(kv[0])))


def reference_shapes(leaves: Any) -> Dict[str, Tuple[Tuple[int, ...],
                                                     torch.dtype]]:
    """Flat key -> (shape, dtype) of each reference leaf, ``scan/...``
    leaves stacked over periods on a leading axis. ``leaves`` is a
    ``reference_leaves`` / ``reference_cache`` listing, a model, or a
    config (built on the meta device in its ``param_dtype``, the dtype
    of the reference's parameter tree)."""
    if isinstance(leaves, ModelConfig):
        leaves = Transformer(leaves, device="meta",
                             dtype=_dtype(leaves.param_dtype))
    if isinstance(leaves, Transformer):
        leaves = reference_leaves(leaves)
    return {key: (((len(ts),) if key.startswith("scan/") else ())
                  + tuple(ts[0].shape), ts[0].dtype)
            for key, ts in leaves.items()}


def to_flat(model: Transformer, *, grad: bool = False
            ) -> Dict[str, np.ndarray]:
    """The model's parameters (or, with ``grad``, their ``.grad``) as the
    reference's flat checkpoint dict of fp32 numpy arrays, ``scan/...``
    leaves stacked over periods on a leading axis."""
    out = {}
    for key, params in reference_leaves(model).items():
        arrs = [(p.grad if grad else p).detach().float().cpu().numpy()
                for p in params]
        out[key] = np.stack(arrs) if key.startswith("scan/") else arrs[0]
    return out


def seeded_flat(cfg: ModelConfig, seed: int, scale: float = 0.05
                ) -> Dict[str, np.ndarray]:
    """``cfg``'s weights as the reference's flat dict, drawn from a seed:
    every leaf, norms and biases included, N(0, ``scale``^2) from
    ``np.random.RandomState(seed)`` in the reference's flatten order,
    rounded to the nearest bf16 value and held in fp32."""
    rng = np.random.RandomState(seed)
    model = Transformer(cfg, device="meta", dtype=torch.float32)
    out = {}
    for key, params in reference_leaves(model).items():
        shape = ((len(params),) if key.startswith("scan/") else ()) \
            + tuple(params[0].shape)
        w = rng.standard_normal(shape).astype(np.float32) * scale
        out[key] = torch.from_numpy(w).to(torch.bfloat16).float().numpy()
    return out


@torch.no_grad()
def load_flat_(model: Transformer, flat: Dict[str, Any]) -> Transformer:
    """Copy reference params in the flat checkpoint keys into ``model``
    in place (each ``scan/...`` leaf split over its periods). Raises on
    a missing, extra or misshapen leaf. Returns the model."""
    leaves = reference_leaves(model)
    extra = sorted(set(flat) - set(leaves))
    if extra:
        raise ValueError(f"reference params the port does not take: {extra}")
    for key, params in leaves.items():
        if key not in flat:
            raise KeyError(f"reference params lack {key!r}")
        arr = np.asarray(flat[key], dtype=np.float32)
        stacked = key.startswith("scan/")
        want = ((len(params),) if stacked else ()) + tuple(params[0].shape)
        if arr.shape != want:
            raise ValueError(f"{key}: shape {arr.shape} vs port {want}")
        for i, param in enumerate(params):
            param.copy_(torch.from_numpy(np.array(arr[i] if stacked
                                                  else arr)))
    return model
