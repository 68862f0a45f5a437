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

The dry run (``repro_torch.launch.dryrun``) reads the specs to count the
bytes each device of a pod mesh would hold. A mesh here is an ordered
mapping from axis name to size (a ``launch.mesh.Mesh``'s ``shape``); a
spec is a tuple with one entry a dim, each an axis name, a tuple of
names or None, and ``()`` replicates.

The sharded training step places tensors by the same specs
(``shard_params`` cuts full masters into each rank's shards,
``gather_params`` puts them back) and runs the model under ``ShardCtx``,
the reference's four methods over ``sharding.comm``'s collectives:
ZeRO-3 over "data" (``layer`` gathers one layer's compute copy, whose
backward reduce-scatters the gradient) and Megatron-style tensor
parallelism over "model" (the layers in ``models`` run on the rank's
heads, channels, ff columns, experts and vocabulary rows). The sharded prefill
and serve steps run the same program forward over a decode cache cut
by ``cache_spec`` (``shard_cache`` / ``gather_cache``); where a KV leaf
is cut by sequence, each rank's decode partials are merged across the
ranks (``ShardCtx.combine``, ``combine_partials``).

Leaves are named by the reference's flat paths (``scan/<i>/block/wq``
stacked over periods, ``rem/<j>/...``, ``encoder/<i>/...``;
``repro_torch.weights.reference_shapes`` and ``reference_cache``), so
the same regexes apply unchanged.
"""
from __future__ import annotations

import re
from types import SimpleNamespace
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

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


def cache_spec(name: str, shape: Tuple[int, ...], mesh: Mesh) -> Spec:
    """Spec of one layer's decode-cache leaf ``name`` (its last path
    component) of ``shape`` (the global shape, no period dim). KV
    tensors (B, S, Hk, hd): batch x kv-head sharding when divisible,
    else sequence sharding (the long-context path). Recurrent states
    (B, ...): batch sharding, falling back to feature sharding for
    batch=1."""
    ba = batch_axes(mesh)
    if name in ("k", "v", "cross_k", "cross_v"):
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
    elif name == "C":      # mlstm matrix memory (B, nh, dh, dh)
        cands = [(ba, "model", None, None), (ba, None, None, None),
                 (None, "model", None, None)]
    elif name == "conv":   # (B, W-1, D)
        cands = [(ba, None, "model"), (ba, None, None),
                 (None, None, "model")]
    elif len(shape) >= 2:  # other recurrent states (B, ...)
        cands = [(ba,) + (None,) * (len(shape) - 1),
                 (None, "model") + (None,) * (len(shape) - 2)]
    else:
        cands = [(ba,)]
    return _resolve(cands, tuple(shape), mesh)


def cache_shardings(leaves: Mapping[str, Any], mesh: Mesh
                    ) -> Dict[str, Spec]:
    """Decode caches by flat path (``scan/<i>/<leaf>`` stacked over
    periods, ``rem/<j>/<leaf>``): each leaf's ``cache_spec``, a stacked
    leaf's with a leading None for its period dim."""
    def one(path, leaf):
        stacked = _stacked(path)
        full = _shape(leaf)
        spec = cache_spec(path.split("/")[-1], full[1:] if stacked else full,
                          mesh)
        return (None,) + spec if stacked else spec
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


# ---------------------------------------------------------------------------
# placement: full masters <-> each rank's shards
# ---------------------------------------------------------------------------

# leaves laid out as two halves on their last dim ([gate | rec] of the
# RG-LRU's w_in, [r | i] of its w_gates, [x | z] of the mLSTM's w_up,
# [a | g] of the sLSTM's): a rank's shard of that dim holds its slice of
# each half, so that its gate, rec, r and i (x and z, a and g) are of its
# own channels
_HALVES = {"rglru": re.compile(r"block/w_(in|gates)$"),
           "mlstm": re.compile(r"block/w_up$"),
           "slstm": re.compile(r"block/w_up$")}


def _chunk(t: torch.Tensor, dim: int, n: int, i: int,
           halves: bool) -> torch.Tensor:
    if not halves:
        return t.narrow(dim, i * (t.shape[dim] // n), t.shape[dim] // n)
    a, b = t.chunk(2, dim)
    return torch.cat([_chunk(a, dim, n, i, False),
                      _chunk(b, dim, n, i, False)], dim)


def local_shard(t: torch.Tensor, spec: Spec, mesh, *,
                halves: bool = False) -> torch.Tensor:
    """This rank's piece of the full tensor ``t`` under ``spec`` on
    ``mesh`` (a ``launch.mesh.Mesh``): each sharded dim cut into equal
    chunks, the chunk the rank's index on the dim's axes (the first axis
    major). ``halves``: the last dim is two halves, each cut alike."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            t = _chunk(t, dim, mesh.size(axis), mesh.index(axis),
                       halves and dim == t.dim() - 1)
    return t


def _gather_full(t: torch.Tensor, spec: Spec, mesh, halves: bool
                 ) -> torch.Tensor:
    from repro_torch.sharding import comm
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n = mesh.size(axis)
        g = comm.gather_dim(t, mesh, axis, dim)
        if halves and dim == t.dim() - 1 and n > 1:
            # rank order (n, 2, w) -> (2, n, w)
            shp = g.shape[:-1]
            g = g.reshape(*shp, n, 2, -1).transpose(-3, -2).reshape(*shp, -1)
        t = g
    return t


def _param_specs(model, axes) -> Dict[str, Tuple[Spec, bool]]:
    """Port parameter name -> (its spec under ``axes``, halves): each
    reference leaf's spec (``params_shardings`` on the full stacked
    shapes), a stacked leaf's without its period dim."""
    from repro_torch.weights import reference_leaves, reference_shapes
    leaves = reference_leaves(model)
    specs = params_shardings(reference_shapes(leaves), axes)
    names = {id(p): n for n, p in model.named_parameters()}
    out = {}
    for key, params in leaves.items():
        spec = specs[key]
        if spec and _stacked(key):
            spec = spec[1:]
        kinds = {model.layers[int(names[id(p)].split(".")[1])].kind
                 for p in params if names[id(p)].startswith("layers.")}
        # each half cut alike, where the last dim's cut divides a half
        cut = _axis_size(axes, spec[-1]) if spec else 1
        halves = (params[0].shape[-1] // 2) % cut == 0 and any(
            k in _HALVES and _HALVES[k].search(key) for k in kinds)
        for p in params:
            out[names[id(p)]] = (tuple(spec), halves)
    return out


def _set_param(model, name: str, value: torch.nn.Parameter) -> None:
    *path, leaf = name.split(".")
    mod = model
    for part in path:
        mod = mod[int(part)] if part.isdigit() else getattr(mod, part)
    setattr(mod, leaf, value)


@torch.no_grad()
def shard_params(model, mesh):
    """A model of the same config holding this rank's shards of
    ``model``'s parameters under ``params_shardings`` on ``mesh``, on the
    mesh's device: each parameter a new ``nn.Parameter`` (its
    ``requires_grad`` kept) with its spec (``shard_spec``) and whether it
    is cut by halves (``shard_halves``); the model's ``mesh`` is
    ``mesh``. ``model`` is left as it was."""
    from repro_torch.models.transformer import Transformer
    specs = _param_specs(model, mesh.shape)
    local = Transformer(model.cfg, device="meta", dtype=torch.float32)
    for name, p in model.named_parameters():
        spec, halves = specs[name]
        t = local_shard(p.detach(), spec, mesh, halves=halves)
        new = torch.nn.Parameter(t.to(mesh.device, copy=True)
                                 .contiguous(),
                                 requires_grad=p.requires_grad)
        new.shard_spec, new.shard_halves = spec, halves
        _set_param(local, name, new)
    local.mesh = mesh
    return local


@torch.no_grad()
def gather_params(model, *, grad: bool = False):
    """The full model back from a sharded one (``shard_params``), on
    every rank: each shard (with ``grad``, each shard's ``.grad``)
    gathered over its spec's axes (a collective: every rank of the mesh
    calls this at once). An unsharded model is returned as it is."""
    mesh = getattr(model, "mesh", None)
    if mesh is None:
        return model
    from repro_torch.models.transformer import Transformer
    full = Transformer(model.cfg, device="meta", dtype=torch.float32)
    for name, p in model.named_parameters():
        t = _gather_full((p.grad if grad else p).detach(), p.shard_spec,
                         mesh, p.shard_halves)
        _set_param(full, name, torch.nn.Parameter(
            t.contiguous().clone(), requires_grad=p.requires_grad))
    return full


@torch.no_grad()
def shard_cache(cache, mesh):
    """This rank's shard of every leaf of a decode cache (a list of
    per-layer dicts, ``transformer.init_cache``, global shapes) under
    ``cache_shardings`` on ``mesh``, on the mesh's device. A per-layer
    leaf's spec is its reference leaf's (``scan/<i>/<leaf>`` or
    ``rem/<j>/<leaf>``) without the period dim, so it is read from the
    leaf's name and shape alone; each shard carries it as
    ``shard_spec``, which the serving steps and ``gather_cache`` read."""
    out = []
    for layer in cache:
        shards = {}
        for name, t in layer.items():
            spec = cache_spec(name, tuple(t.shape), mesh.shape)
            shards[name] = held(local_shard(t, spec, mesh).to(
                mesh.device, copy=True).contiguous(), spec)
        out.append(shards)
    return out


@torch.no_grad()
def gather_cache(cache, mesh):
    """The whole cache back from this rank's shards (``shard_cache`` or a
    sharded serving step's), on every rank: each leaf gathered over its
    ``shard_spec``'s axes (a collective: every rank of the mesh calls
    this at once)."""
    if mesh is None:
        return cache
    out = []
    for layer in cache:
        whole = {}
        for name, t in layer.items():
            spec = getattr(t, "shard_spec", None)
            if spec is None:
                raise ValueError(f"cache leaf {name!r} carries no shard_spec "
                                 f"(sharding.shard_cache cuts one)")
            whole[name] = _gather_full(t, spec, mesh, False).contiguous()
        out.append(whole)
    return out


def held(t: torch.Tensor, spec: Spec) -> torch.Tensor:
    """``t``, marked as this rank's shard of a cache leaf under
    ``spec``."""
    t.shard_spec = tuple(spec)
    return t


def seq_axes(spec: Spec) -> Tuple[str, ...]:
    """The axes a KV leaf's (B, S, Hk, hd) spec cuts its sequence over:
    the flash-decode layout's."""
    return tuple(spec_axes(spec[1:2])) if len(spec) > 1 else ()


def seq_rows(spec: Spec, size: int, mesh) -> Tuple[int, int]:
    """The rows ``[lo, hi)`` of a KV leaf of ``size`` sequence rows that
    this rank holds under ``spec`` on ``mesh`` (all of them where the
    sequence is not cut)."""
    axes = seq_axes(spec)
    n = mesh.size(axes)
    if size % n:
        raise ValueError(f"{size} cache rows do not split over {n} ranks")
    rows = size // n
    lo = mesh.index(axes) * rows
    return lo, lo + rows


def _combine(o: torch.Tensor, lse: torch.Tensor, rmax, rsum
             ) -> torch.Tensor:
    """Partial attention outputs over disjoint row ranges into one, in
    fp32: weights exp(lse - m) with m the largest lse (0 where every
    part is empty: no -inf - -inf), the weighted outputs and weights
    summed in one reduction, divided once. ``rmax`` / ``rsum`` reduce
    over the parts."""
    m = rmax(lse)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w = torch.exp(lse - m)[..., None]
    sums = rsum(torch.cat([w * o.float(), w], dim=-1))
    return sums[..., :-1] / sums[..., -1:].clamp(min=1e-30)


def combine_partials(o_parts: torch.Tensor, lse_parts: torch.Tensor
                     ) -> torch.Tensor:
    """One attention output (B, H, D) fp32 from R partial ones over
    disjoint row ranges of the same sequences: ``o_parts`` (R, B, H, D)
    and ``lse_parts`` (R, B, H), as ``decode_attention(...,
    return_lse=True)`` gives each range (an empty range's lse is -inf:
    it weighs 0). ``ShardCtx.combine`` is the same over ranks."""
    return _combine(o_parts, lse_parts, lambda t: t.amax(0),
                    lambda t: t.sum(0))


def shard_batch(batch: Dict[str, torch.Tensor], mesh
                ) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch: dim 0 cut over the batch axes
    (``batch_axes``), rank order. Raises where the rows do not split
    (the reference replicates such a batch; the port refuses it)."""
    axes = batch_axes(mesh.shape)
    n, i = mesh.size(axes), mesh.index(axes)
    out = {}
    for k, v in batch.items():
        if v.shape[0] % n:
            raise ValueError(f"a global batch of {v.shape[0]} rows does not "
                             f"split over {n} data ranks")
        out[k] = _chunk(v, 0, n, i, False)
    return out


# ---------------------------------------------------------------------------
# the sharding context threaded through the model
# ---------------------------------------------------------------------------

def spec_axes(spec: Spec) -> List[str]:
    """The axis names a spec cuts over."""
    out: List[str] = []
    for a in spec:
        if a is not None:
            out.extend(a if isinstance(a, tuple) else (a,))
    return out


class ShardCtx:
    """Sharding context threaded through the model functions, over a
    ``launch.mesh.Mesh``.

    * ``layer(p)``: one layer's compute copy (a namespace whose leaves
      are the rank's master shards cast to the compute dtype, with their
      specs in ``_specs``) gathered over every axis but "model": ZeRO-3's
      per-layer weight all-gather, whose backward is the gradient's
      reduce-scatter. A leaf the batch axes do not shard gets its
      gradient summed over them instead (``comm.reduce_grad``). Called
      inside the remat span, so the backward gathers again.
    * ``act(x)``: the layout at layer boundaries: (B / data, S, D), the
      features whole on every "model" rank (Megatron's; the reference
      shards them over "model"). Nothing to move.
    * ``batch_only(x)``: the final-norm output before the head, the same
      layout; the vocabulary-parallel head takes its gradient sum.
    * ``experts(p, n)``: the routed experts an MoE layer's compute copy
      holds on this rank: E / model of them where its banks are cut by
      expert, else all n (each over F / model columns where the banks
      are cut by column, the per-expert tensor-parallel fallback). It
      takes the place of the reference's ``expert_tensor``, which pins
      the (G, T, E, C) routing tensors and (G, E, C, D) buffers for
      GSPMD: here each rank builds its experts' columns of them alone
      (``models.moe``), so there is no tensor to pin.

    ``split(p, name)`` says whether leaf ``name`` of a compute namespace
    is cut over "model" (and "model" has more than one rank): the
    layers run on local shards where it is. ``tp_in`` / ``tp_out`` are
    the column-parallel input (gradient summed over "model") and the
    row-parallel output (summed over "model").

    The serving steps give ``batch``, the global batch's rows. Their
    rows are cut over the batch axes where they divide, else every rank
    runs all of them (``rows``), as ``cache_spec`` places the cache's
    batch dim; ``cache_spec`` places each leaf the layers write;
    ``combine`` merges the flash-decode layout's partial outputs across
    the ranks that hold a sequence's rows; ``channels`` / ``to_held``
    move a recurrent state's channels between the layer's compute cut
    and the leaf's placement; ``full_vocab`` gathers the head's
    vocabulary shards."""

    def __init__(self, mesh, batch: Optional[int] = None):
        self.mesh = mesh
        self.global_batch = batch

    @property
    def tp(self) -> int:
        return self.mesh.size("model")

    @property
    def tp_index(self) -> int:
        return self.mesh.index("model")

    @property
    def batch(self):
        return batch_axes(self.mesh.shape)

    def _leaf(self, x: torch.Tensor, spec: Spec) -> torch.Tensor:
        from repro_torch.sharding import comm
        held = spec_axes(spec)
        x = comm.reduce_grad(x, self.mesh,
                             tuple(a for a in self.batch if a not in held))
        for dim, axis in enumerate(spec):
            names = [a for a in ((axis,) if isinstance(axis, str)
                                 else axis or ()) if a != "model"]
            if names and len(names) != len(spec_axes((axis,))):
                raise ValueError(f"spec {spec}: a dim over 'model' and "
                                 f"another axis")
            if names:
                x = comm.all_gather(x, self.mesh, tuple(names), dim)
        return x

    def _gather(self, ns):
        if isinstance(ns, list):
            return [self._gather(m) for m in ns]
        if not isinstance(ns, SimpleNamespace):
            return ns
        specs = getattr(ns, "_specs", {})
        out = SimpleNamespace()
        for name, v in vars(ns).items():
            if name in ("_specs", "_halves"):
                setattr(out, name, v)
                continue
            if isinstance(v, torch.Tensor) and name in specs:
                v = self._leaf(v, specs[name])
            elif isinstance(v, (SimpleNamespace, list)):
                v = self._gather(v)
            setattr(out, name, v)
        out._specs = {k: tuple(a if a == "model" else None for a in s)
                      for k, s in specs.items()}
        return out

    def layer(self, layer_params):
        return self._gather(layer_params)

    def prepare(self, params):
        """The compute copy's leaves outside the layers (embed, head,
        norms, projector) gathered as ``layer`` gathers a layer's; the
        decoder and encoder layers are left to ``layer``."""
        out = SimpleNamespace(**vars(params))
        gathered = self._gather(SimpleNamespace(**{
            k: v for k, v in vars(params).items()
            if k not in ("layers", "encoder")}))
        for k, v in vars(gathered).items():
            setattr(out, k, v)
        return out

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def batch_only(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def experts(self, p, n: int) -> Tuple[int, int]:
        """The routed experts [lo, hi) of the MoE compute copy ``p``
        (``n`` in all) this rank computes."""
        spec = getattr(p, "_specs", {}).get("w_gate", ())
        if self.tp > 1 and spec[:1] == ("model",):
            local = n // self.tp
            return self.tp_index * local, (self.tp_index + 1) * local
        return 0, n

    def split(self, p, name: str) -> bool:
        spec = getattr(p, "_specs", {}).get(name)
        return self.tp > 1 and spec is not None and "model" in spec

    def whole(self, p, names: Optional[Sequence[str]] = None):
        """The compute namespace ``p`` (a layer's block, or the
        projector) with every leaf "model" cuts (of ``names``, if given)
        gathered over it, for a layer whose heads the axis does not
        divide, run whole on every "model" rank
        (``comm.all_gather_replicated``: each rank's gradient of the
        gathered leaf is the whole one, and its shard keeps its piece).
        A leaf cut by halves is put back in order."""
        from repro_torch.sharding import comm
        specs = getattr(p, "_specs", {})
        cut = [k for k in specs if self.split(p, k)
               and (names is None or k in names)]
        if not cut:
            return p
        out = SimpleNamespace(**vars(p))
        for name in cut:
            t = getattr(p, name)
            dim = list(specs[name]).index("model")
            g = comm.all_gather_replicated(t, self.mesh, "model", dim)
            if name in getattr(p, "_halves", ()) and dim == t.dim() - 1:
                shp = g.shape[:-1]
                g = g.reshape(*shp, self.tp, 2, -1).transpose(-3, -2) \
                    .reshape(*shp, -1)
            setattr(out, name, g)
        out._specs = {k: (() if k in cut else v) for k, v in specs.items()}
        return out

    def heads(self, n: int) -> Tuple[int, int]:
        """The heads ``[lo, hi)`` of ``n`` this rank computes where
        "model" cuts them."""
        local = n // self.tp
        return self.tp_index * local, (self.tp_index + 1) * local

    def tp_in(self, x: torch.Tensor) -> torch.Tensor:
        from repro_torch.sharding import comm
        return comm.reduce_grad(x, self.mesh, "model")

    def tp_out(self, x: torch.Tensor) -> torch.Tensor:
        from repro_torch.sharding import comm
        return comm.all_reduce(x, self.mesh, "model")

    def tp_slice(self, x: torch.Tensor, dim: int, lo: int, hi: int
                 ) -> torch.Tensor:
        """Rows ``lo:hi`` of dim ``dim`` of a leaf every "model" rank
        holds whole, for this rank's share of the work: its gradient
        summed over "model" (each rank's is partial)."""
        return self.tp_in(x).narrow(dim, lo, hi - lo)

    # -- serving ------------------------------------------------------------

    def rows(self, x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """This rank's rows of a global (B, ...) input: cut over the batch
        axes where they divide the global batch, else all of them."""
        n = self.mesh.size(self.batch)
        if x is None or self.global_batch % n:
            return x
        return _chunk(x, 0, n, self.mesh.index(self.batch), False)

    def cache_spec(self, name: str, shape: Tuple[int, ...]) -> Spec:
        """``cache_spec`` of a leaf whose rank-local shape is ``shape``
        but for the batch dim, the global batch's."""
        return cache_spec(name, (self.global_batch,) + tuple(shape[1:]),
                          self.mesh.shape)

    def combine(self, o: torch.Tensor, lse: torch.Tensor, axes
                ) -> torch.Tensor:
        """The flash-decode combine across the ranks of ``axes`` that
        hold one sequence's row ranges: ``o`` (B, H, D) fp32 and ``lse``
        (B, H) this rank's partial (``decode_attention(...,
        return_lse=True)`` over its rows). The largest lse through
        ``comm.all_reduce_(op="max")``, then one sum of the weighted
        outputs and weights, divided in fp32: ``combine_partials`` over
        ranks."""
        from repro_torch.sharding import comm
        return _combine(
            o, lse, lambda t: comm.all_reduce_(t, self.mesh, axes, op="max"),
            lambda t: comm.all_reduce_(t, self.mesh, axes))

    def _cut(self, spec: Spec, dim: int) -> bool:
        return self.tp > 1 and len(spec) > 0 and "model" in spec_axes(
            (tuple(spec)[dim],))

    def channels(self, state: torch.Tensor, split: bool, dim: int = -1
                 ) -> torch.Tensor:
        """A recurrent state leaf's channels (or heads: dim ``dim``) as a
        layer whose channels are ``split`` over "model" computes on them:
        this rank's where the leaf is held whole; every rank's, gathered
        over "model", where the leaf is cut and the layer runs whole."""
        from repro_torch.sharding import comm
        cut = self._cut(state.shard_spec, dim)
        if split and not cut:
            n = state.shape[dim] // self.tp
            return state.narrow(dim, self.tp_index * n, n)
        if cut and not split:
            return comm.gather_dim(state, self.mesh, "model", dim)
        return state

    def to_held(self, x: torch.Tensor, spec: Spec, split: bool,
                dim: int = -1) -> torch.Tensor:
        """``x``, a recurrent state over the layer's channels (or heads:
        dim ``dim``; ``split`` over "model" or whole), in the placement
        ``spec``: gathered over "model" where the leaf is held whole and
        the channels are split, this rank's where the leaf is cut and
        the layer ran whole."""
        from repro_torch.sharding import comm
        cut = self._cut(spec, dim)
        if split and not cut:
            return comm.gather_dim(x, self.mesh, "model", dim)
        if cut and not split:
            n = x.shape[dim] // self.tp
            return x.narrow(dim, self.tp_index * n, n)
        return x

    def full_vocab(self, logits: torch.Tensor, vocab: int) -> torch.Tensor:
        """Logits over the whole (padded) vocabulary: the head's "model"
        shards gathered where it is cut."""
        from repro_torch.sharding import comm
        if logits.shape[-1] == vocab:
            return logits
        return comm.gather_dim(logits, self.mesh, "model", -1)


class NoopShardCtx:
    """The reference's no-op context (no ``expert_tensor``: see
    ``ShardCtx.experts``). The unsharded path passes no context."""

    def layer(self, p):
        return p

    def act(self, x):
        return x

    def batch_only(self, x):
        return x
