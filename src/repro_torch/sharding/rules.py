"""Role-based partition specs with divisibility fallback: the pure spec
logic of ``repro.sharding.rules``, for accounting.

Every parameter / cache / batch leaf gets a *candidate list* of specs
derived from its flat path (its role) and rank; the first candidate
whose named axes all divide the corresponding dims (and use each mesh
axis at most once) wins, otherwise the leaf falls back down the list and
ultimately to replication. One rule set serves all 10 architectures on
both the (data=16, model=16) pod mesh and the (pod=2, data=16, model=16)
multi-pod mesh:

* qwen3-moe: 128 experts % 16 == 0 -> expert-parallel over "model".
* qwen2-moe: 60 experts % 16 != 0 -> per-expert tensor parallelism
  (d_ff_expert over "model").
* MQA (kv=1): wk/wv head dim unshardable -> d_model over "data".
* long_500k (batch=1): KV cache batch unshardable -> sequence sharding
  over ("data", "model").

The port runs on one card, so nothing here places a tensor: the dry run
(``repro_torch.launch.dryrun``) reads the specs to count the bytes each
device of a pod mesh would hold. A mesh is an ordered mapping from axis
name to size (``repro_torch.launch.mesh``); a spec is a tuple with one
entry a dim, each an axis name, a tuple of names or None, and ``()``
replicates. Leaves are named by the reference's flat paths
(``scan/<i>/block/wq`` stacked over periods, ``rem/<j>/...``,
``encoder/<i>/...``; ``repro_torch.weights.reference_shapes`` and
``reference_cache``), so the same regexes apply unchanged.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

Axis = Optional[object]   # axis name, tuple of names, or None
Spec = Tuple[Axis, ...]
Mesh = Mapping[str, int]


def _axis_size(mesh: Mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        out = 1
        for a in axis:
            out *= mesh[a]
        return out
    return mesh[axis]


def _fits(spec: Sequence[Axis], shape: Tuple[int, ...], mesh: Mesh) -> bool:
    if len(spec) != len(shape):
        return False
    used: List[str] = []
    for axis, dim in zip(spec, shape):
        if axis is None:
            continue
        names = axis if isinstance(axis, tuple) else (axis,)
        for n in names:
            if n not in mesh or n in used:
                return False
            used.append(n)
        if dim % _axis_size(mesh, axis):
            return False
    return True


def _spec(axes: Sequence[Axis]) -> Spec:
    """A spec as ``PartitionSpec`` normalises one: a tuple of one axis
    name is that name."""
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                 for a in axes)


def _resolve(cands: List[Spec], shape: Tuple[int, ...], mesh: Mesh) -> Spec:
    for c in cands:
        if _fits(c, shape, mesh):
            return _spec(c)
    return ()   # replicate


def batch_axes(mesh: Mesh):
    """The meta-axis the global batch shards over."""
    return ("pod", "data") if "pod" in mesh else ("data",)


# ---------------------------------------------------------------------------
# parameter rules (matched against the flat path string)
# ---------------------------------------------------------------------------

_PARAM_RULES: List[Tuple[str, List[Spec]]] = [
    # --- MoE expert banks (E, D, F) / (E, F, D): expert-parallel first,
    # then per-expert TP on the ff dim, then FSDP-only.
    (r"moe.*w_(gate|up)$", [("model", "data", None), (None, "data", "model"),
                            (None, None, "model"), (None, "data", None)]),
    (r"moe.*w_down$", [("model", None, "data"), (None, "model", "data"),
                       (None, "model", None), (None, None, "data")]),
    (r"moe.*router$", [("data", None), (None, None)]),
    # shared experts are ordinary MLPs (matched by the generic mlp rules)
    # --- attention projections
    (r"w[qkv]$", [("data", "model", None), (None, "model", None),
                  ("data", None, None)]),
    (r"wo$", [("model", None, "data"), ("model", None, None),
              (None, None, "data")]),
    (r"b[qkv]$", [("model", None), (None, None)]),
    # --- gated MLP
    (r"w_(gate|up)$", [("data", "model"), (None, "model"), ("data", None)]),
    (r"w_down$", [("model", "data"), ("model", None), (None, "data")]),
    # --- rglru / mlstm / slstm
    (r"w_in$", [("data", "model"), (None, "model"), ("data", None)]),
    (r"w_gates$", [("data", "model"), (None, "model"), ("data", None)]),
    (r"w_out$", [("model", "data"), ("model", None), (None, "data")]),
    (r"conv_w$", [(None, "model"), (None, None)]),
    (r"lam$", [("model",), (None,)]),
    (r"w_up$", [("data", "model"), (None, "model"), ("data", None)]),
    (r"\br$", [(None, "model", None, None), (None, None, None, None)]),
    (r"\bw$", [("data", None, "model", None), ("data", None, None, None)]),
    (r"w_if$", [("data", None), (None, None)]),
    # --- embeddings / head / projector
    (r"embed$", [("model", "data"), ("model", None), (None, "data")]),
    (r"lm_head$", [("data", "model"), (None, "model"), ("data", None)]),
    (r"frontend_proj.*w1$", [("data", "model"), (None, "model")]),
    (r"frontend_proj.*w2$", [("model", "data"), (None, "data")]),
]


def _shape(leaf) -> Tuple[int, ...]:
    """A leaf's shape: a tensor's, a (shape, dtype) pair's, or a shape."""
    if hasattr(leaf, "shape"):
        return tuple(leaf.shape)
    if len(leaf) == 2 and isinstance(leaf[0], tuple):
        return leaf[0]
    return tuple(leaf)


def _stacked(path: str) -> bool:
    return "scan" in path.split("/")


def spec_for(path_str: str, shape: Tuple[int, ...], mesh: Mesh,
             *, stacked: bool = False) -> Spec:
    """Spec for one param leaf. ``stacked``: leading scan-period dim."""
    core_shape = tuple(shape[1:] if stacked else shape)
    cands: List[Spec] = []
    for pat, cs in _PARAM_RULES:
        if re.search(pat, path_str):
            cands.extend(cs)           # later-matching rules are fallbacks
    if not cands and core_shape:
        # generic fallback: FSDP the largest dim over "data" if divisible
        big = max(range(len(core_shape)), key=lambda i: core_shape[i])
        c: List[Axis] = [None] * len(core_shape)
        c[big] = "data"
        cands.append(tuple(c))
    spec = _resolve(cands, core_shape, mesh)
    if stacked:
        spec = (None,) + spec
    return spec


def params_shardings(leaves: Mapping[str, Any], mesh: Mesh
                     ) -> Dict[str, Spec]:
    """Path -> spec for a flat params (or optimizer-state) listing whose
    values are tensors, (shape, dtype) pairs or shapes."""
    return {path: spec_for(path, _shape(leaf), mesh, stacked=_stacked(path))
            for path, leaf in leaves.items()}


# ---------------------------------------------------------------------------
# batch / cache rules
# ---------------------------------------------------------------------------

def batch_shardings(leaves: Mapping[str, Any], mesh: Mesh
                    ) -> Dict[str, Spec]:
    """Inputs: shard dim 0 (global batch) over ("pod","data") with
    divisibility fallback (long_500k batch=1 -> replicated)."""
    ba = batch_axes(mesh)

    def one(leaf):
        shape = _shape(leaf)
        cands = [(ba,) + (None,) * (len(shape) - 1)]
        if len(ba) > 1:
            cands.append((ba[-1],) + (None,) * (len(shape) - 1))
        return _resolve(cands, shape, mesh)
    return {path: one(leaf) for path, leaf in leaves.items()}


def cache_shardings(leaves: Mapping[str, Any], mesh: Mesh
                    ) -> Dict[str, Spec]:
    """Decode caches. KV tensors (B, S, Hk, hd): batch x kv-head sharding
    when divisible, else sequence sharding (the long-context path).
    Recurrent states (B, ...): batch sharding, falling back to feature
    sharding for batch=1."""
    ba = batch_axes(mesh)

    def one(path, leaf):
        stacked = _stacked(path)
        full = _shape(leaf)
        shape = full[1:] if stacked else full
        last = path.split("/")[-1]
        if last in ("k", "v", "cross_k", "cross_v"):
            # batch x kv-heads when heads divide; otherwise batch x
            # sequence over "model" (the flash-decode layout)
            cands = [
                (ba, None, "model", None),
                (ba, "model", None, None),
                (ba, None, None, None),
                (None, ("data", "model"), None, None),
                (None, "data", None, None),
                (None, "model", None, None),
            ]
        elif last == "C":      # mlstm matrix memory (B, nh, dh, dh)
            cands = [(ba, "model", None, None), (ba, None, None, None),
                     (None, "model", None, None)]
        elif last == "conv":   # (B, W-1, D)
            cands = [(ba, None, "model"), (ba, None, None),
                     (None, None, "model")]
        elif len(shape) >= 2:  # other recurrent states (B, ...)
            cands = [(ba,) + (None,) * (len(shape) - 1),
                     (None, "model") + (None,) * (len(shape) - 2)]
        else:
            cands = [(ba,)]
        spec = _resolve(cands, shape, mesh)
        if stacked:
            spec = (None,) + spec
        return spec
    return {path: one(path, leaf) for path, leaf in leaves.items()}


def replicated(leaves: Mapping[str, Any], mesh: Mesh) -> Dict[str, Spec]:
    return {path: () for path in leaves}


def compute_params_shardings(leaves: Mapping[str, Any], mesh: Mesh
                             ) -> Dict[str, Spec]:
    """Specs of the bf16 compute copy of the weights: the storage spec
    with every axis except "model" dropped (ZeRO-3: masters and
    optimizer state fully sharded, the compute copy gathered over
    "data" right before use)."""
    return {path: tuple(a if a == "model" else None for a in spec)
            for path, spec in params_shardings(leaves, mesh).items()}


def activation_spec(mesh: Mesh) -> Spec:
    """(B, S, D) activations: batch over ("pod","data"), features over
    "model"."""
    return _spec((batch_axes(mesh), None, "model"))


def logits_spec(mesh: Mesh) -> Spec:
    return _spec((batch_axes(mesh), None, "model"))


def device_bytes(shape: Tuple[int, ...], itemsize: int, spec: Spec,
                 mesh: Mesh) -> int:
    """Bytes of one leaf that each device holds under ``spec``: the
    leaf's bytes over the product of its sharded axes' sizes (the
    reference dry run's ``leaf_device_bytes``)."""
    n = itemsize
    for dim in shape:
        n *= dim
    div = 1
    for axis in spec:
        div *= _axis_size(mesh, axis)
    return n // div
