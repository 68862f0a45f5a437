"""Dry run of the port: every arch x shape counted on the meta device.

The counterpart of ``repro.launch.dryrun`` for one H100. The reference
lowers and compiles each combination against 512 placeholder TPU
devices and reads XLA's cost analysis. The port builds the model and the
shape's inputs on the meta device (shapes and dtypes, no memory, no
card) and runs its own step on them: ``make_train_step``'s forward,
backward and AdamW update, ``prefill`` or ``decode_step``. It counts
under ``torch.utils.flop_counter.FlopCounterMode`` (the products) and
the kernels' ``KernelCount`` (each kernel wrapper's cost function, from
its meta branch, which launches nothing), and records per combination:

* ``flops``: what the port computes, products and kernels;
  ``model_flops`` the reference's useful count, 6 (train) or 2 x active
  params x tokens, and ``useful_flops_ratio`` the one over the other;
* ``bytes``: the step's least traffic: weights in the dtype the port
  holds them, the cache, inputs and logits, each once; for training the
  fp32 masters, gradients and both moments read and written once;
* ``resident_bytes``: what the port keeps on the card (weights as it
  casts them, ``_KEEP_F32`` leaves in fp32; fp32 masters, gradients and
  moments for training; the cache for decode), and ``fits_80gb``;
* ``t_compute_s`` / ``t_memory_s`` / ``bottleneck``: ``flops`` over the
  compute dtype's peak and ``bytes`` over HBM's rate, bounds from
  published H100 peaks (``launch.mesh``), never times;
* ``param_bytes_per_device`` (and ``cache_bytes_per_device`` for decode)
  under the sharding rules (``repro_torch.sharding``) on the mesh;
* ``collective_bytes_per_device``, ``collectives`` (bytes and calls by
  kind, bytes by the axes crossed) and ``t_collective_s``: the
  counterpart of the reference's ``collective_bytes``. Rank 0's
  per-device program of the shape's step
  (``make_train_step(cfg, opt, mesh)``, ``make_prefill_step`` or
  ``make_serve_step``, the last over ``shard_cache`` of the shape's
  cache) runs on the meta device over an abstract mesh
  (``count_sharded``), whose collectives are counted as the reference's
  parser counts them (each result's bytes on one device), not issued;
  ``t_collective_s`` is each axis set's bytes over its link's published
  peak (NVLink 4 inside a pod, InfiniBand across pods; ``launch.mesh``),
  a bound. ``resident_bytes_per_device`` is that program's fp32 master
  shards (with their gradients and moments for training) and the cache
  shards a serving step leaves. A training shape whose global batch
  does not split over the data ranks records why in
  ``collective_note``, and ``None`` for the four.

Meshes: ``h100`` (one card), ``pod`` (16 x 16) and ``multipod`` (2 x 16 x
16), abstract, or any ``DxM`` / ``PxDxM`` (``2x2`` for the tests and the
card): a mesh's time terms split the one-card counts evenly over its
chips.

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A] \\
        [--shape S] [--mesh h100|pod|multipod|DxM|all] \\
        [--outdir build/dryrun]

needs no device and writes one JSON per combination.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
from dataclasses import replace
from typing import Dict, List, Optional, Union

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.shapes import (SHAPES, InputShape, decode_context,
                                        input_specs, resolve,
                                        shape_applicable)
from repro_torch.kernels.cost import KernelCount
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.runtime import optim
from repro_torch.runtime.trainstep import (make_prefill_step,
                                           make_serve_step, make_train_step)
from repro_torch.sharding.comm import CommCount
from repro_torch.sharding import (cache_shardings, device_bytes,
                                  params_shardings)
from repro_torch.sharding.rules import batch_axes, shard_cache, shard_params
from repro_torch.weights import reference_cache, reference_shapes

OUTDIR = os.path.join("build", "dryrun")
META = torch.device("meta")
MESHES = {"h100": ("h100", {}),
          "pod": ("16x16", mesh_lib.make_production_mesh()),
          "multipod": ("2x16x16",
                       mesh_lib.make_production_mesh(multi_pod=True))}


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _cache_tensors(cache: T.Cache) -> List[torch.Tensor]:
    return [t for layer in cache for t in layer.values()]


def count_step(cfg: ModelConfig, shape: Union[str, InputShape], *,
               microbatches: int = 1,
               batch_override: Optional[int] = None) -> Dict:
    """Run the shape's step on the meta device under the counters:
    returns the counts of one step (see the module docstring) and, for
    decode, the meta cache the step ran on."""
    s = resolve(shape)
    specs = input_specs(cfg, s, batch_override)
    b = next(iter(specs.values())).shape[0]
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as fc, KernelCount() as kc:
        if s.kind == "train":
            model = T.Transformer(cfg, device=META, dtype=torch.float32)
            model.requires_grad_(True)
            opt = optim.init(model)
            step = make_train_step(cfg, optim.AdamWConfig(),
                                   microbatches=microbatches)
            step(model, opt, specs)
            cache = None
        else:
            model = T.Transformer(cfg, device=META)
            if s.kind == "prefill":
                logits, cache, _ = T.prefill(model, specs["tokens"],
                                             max_len=s.seq_len,
                                             embeds=specs.get("embeds"))
            else:
                ctx = decode_context(cfg, s)
                cache = T.init_cache(cfg, b, ctx["max_len"], device=META)
                logits, cache, _ = T.decode_step(model, specs["token"],
                                                 cache, specs["cache_len"])
    count_s = time.perf_counter() - t0
    params = list(model.parameters())
    n_tree = sum(p.numel() for p in params)
    inputs = _nbytes(specs.values())
    if s.kind == "train":
        compute = T._dtype(cfg.dtype)
        logits_bytes = b * s.seq_len * cfg.padded_vocab_size \
            * _itemsize(compute)
        # fp32 masters, gradients, m and v: each read and written once
        nbytes = 8 * 4 * n_tree + inputs + logits_bytes
        resident = 4 * 4 * n_tree
    else:
        weights = _nbytes(params)
        cache_bytes = _nbytes(_cache_tensors(cache))
        nbytes = weights + cache_bytes + inputs + _nbytes([logits])
        resident = weights + (cache_bytes if s.kind == "decode" else 0)
    return {"shape": s, "batch": b, "microbatches": microbatches,
            "kernel": kc,
            "flops": fc.get_total_flops() + kc.flops,
            "bytes": nbytes, "resident_bytes": resident,
            "tree_param_count": n_tree,
            "cache": cache if s.kind == "decode" else None,
            "count_s": count_s}


def count_sharded(cfg: ModelConfig, shape: Union[str, InputShape],
                  axes: Dict[str, int], *, microbatches: int = 1,
                  batch_override: Optional[int] = None,
                  max_len: Optional[int] = None) -> Dict:
    """The collectives of rank 0's program of the shape's sharded step
    (``make_train_step``, ``make_prefill_step`` or ``make_serve_step``)
    on ``axes``, run on the meta device over an abstract mesh; a prefill
    writes a cache of ``max_len`` rows (default: the shape's length), a
    decode step starts from ``shard_cache`` of ``init_cache`` at
    ``decode_context``'s geometry. Returns {"collectives"
    (``CommCount.record``), "collective_bytes_per_device",
    "t_collective_s", "resident_bytes_per_device"}: the last is the fp32
    master shards (with their gradients and moments for training) and,
    for prefill and decode, the cache shards the step leaves, each leaf's
    bytes under its spec (``device_bytes``). The four are None, with
    "collective_note", where a training batch does not split over the
    data ranks.

    The scanned periods run one program each, the same shapes through
    the same collectives, as the reference's scan lowers one body: a
    config of more than two periods is run at one and at two periods
    (its remainder layers kept), and every count and cache byte of the
    other periods is the difference of the two, once a period
    (``_by_periods``); the master shards are the whole config's."""
    s = resolve(shape)
    mesh = mesh_lib.abstract_mesh(axes)
    specs = input_specs(cfg, s, batch_override)
    b = next(iter(specs.values())).shape[0]
    if s.kind == "train" and b % (mesh.size(batch_axes(axes))
                                  * microbatches):
        return {"collectives": None, "collective_bytes_per_device": None,
                "t_collective_s": None, "resident_bytes_per_device": None,
                "collective_note": (
                    f"a global batch of {b} in {microbatches} microbatches "
                    f"does not split over {mesh.size(batch_axes(axes))} "
                    f"data ranks")}
    args = (s, axes, specs, microbatches, max_len)
    if cfg.n_periods > 2:
        counts, held = _by_periods(*(_run_sharded(_depth(cfg, k), *args)
                                     for k in (1, 2)), cfg.n_periods)
    else:
        counts, held = _run_sharded(cfg, *args)
    model = shard_params(T.Transformer(cfg, device=META, dtype=torch.float32),
                         mesh)
    n_local = sum(p.numel() for p in model.parameters())
    per_param = 16 if s.kind == "train" else 4
    return {"collectives": counts.record(),
            "collective_bytes_per_device": counts.total,
            "t_collective_s": counts.seconds(mesh_lib.LINK_PEAK_BW),
            "resident_bytes_per_device": per_param * n_local + held}


def _depth(cfg: ModelConfig, periods: int) -> ModelConfig:
    """``cfg`` cut to ``periods`` scanned periods, its remainder kept."""
    return replace(cfg, n_layers=periods * len(cfg.layer_pattern)
                   + len(cfg.remainder_kinds))


def _run_sharded(cfg: ModelConfig, s: InputShape, axes, specs,
                 microbatches: int, max_len: Optional[int]):
    """Rank 0's program of the sharded step on meta: (its collectives
    (``CommCount``), the bytes of the cache shards it leaves)."""
    mesh = mesh_lib.abstract_mesh(axes)
    b = next(iter(specs.values())).shape[0]
    cache = []
    with KernelCount():
        full = T.Transformer(cfg, device=META, dtype=torch.float32)
        model = shard_params(full, mesh)
        if s.kind == "train":
            model.requires_grad_(True)
            step = make_train_step(cfg, optim.AdamWConfig(), mesh,
                                   microbatches=microbatches)
            step(model, optim.init(model), specs)
        elif s.kind == "prefill":
            step = make_prefill_step(cfg, max_len=max_len or s.seq_len,
                                     mesh=mesh)
            _, cache, _ = step(model, specs)
        else:
            ctx = decode_context(cfg, s)
            cache = shard_cache(T.init_cache(cfg, b, ctx["max_len"],
                                             device=META), mesh)
            step = make_serve_step(cfg, mesh)
            step(model, cache, specs["token"], specs["cache_len"])
    # a shard's bytes: its leaf's ``device_bytes`` under its spec
    return mesh.counts, _nbytes(_cache_tensors(cache))


def _by_periods(one, two, periods: int):
    """The counts and cache bytes of ``periods`` periods from those of
    one and of two: one's, and two's less one's for each other period."""
    (c1, h1), (c2, h2) = one, two
    out = CommCount()
    for name in ("calls", "bytes", "axis_bytes"):
        a, b = getattr(c1, name), getattr(c2, name)
        getattr(out, name).update(
            {k: a.get(k, 0) + (periods - 1) * (b.get(k, 0) - a.get(k, 0))
             for k in set(a) | set(b)})
    return out, h1 + (periods - 1) * (h2 - h1)


def mesh_axes(mesh: str):
    """(record name, axes) of a mesh key of ``MESHES`` or a ``DxM`` /
    ``PxDxM`` name."""
    if mesh in MESHES:
        return MESHES[mesh]
    return mesh, mesh_lib.parse_mesh(mesh)


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def param_bytes_per_device(cfg: ModelConfig, axes) -> int:
    """Parameter bytes each device of ``axes`` holds under the sharding
    rules, every leaf in the config's ``param_dtype`` (the reference's
    tree)."""
    leaves = reference_shapes(cfg)
    specs = params_shardings(leaves, axes)
    item = _itemsize(T._dtype(cfg.param_dtype))
    return sum(device_bytes(shape, item, specs[k], axes)
               for k, (shape, _) in leaves.items())


def cache_bytes_per_device(cfg: ModelConfig, cache: T.Cache, axes) -> int:
    """Decode-cache bytes each device of ``axes`` holds under the cache
    rules, each leaf in its own dtype."""
    shapes = reference_shapes(reference_cache(cfg, cache))
    specs = cache_shardings(shapes, axes)
    return sum(device_bytes(shape, _itemsize(dt), specs[k], axes)
               for k, (shape, dt) in shapes.items())


def _notes(cfg: ModelConfig, s: InputShape, mesh: str) -> List[str]:
    notes = ["t_compute_s and t_memory_s are bounds from published H100 "
             "SXM peaks (989e12 FLOP/s bf16, 67e12 fp32, 3.35e12 B/s), "
             "never times",
             "resident_bytes counts weights (fp32 masters, gradients and "
             "AdamW moments for training) and the decode cache, no "
             "activations"]
    if mesh != "h100":
        notes.append("a mesh's time terms split the one-card counts "
                     "evenly over its chips; the collective term is rank "
                     "0's program of the shape's sharded step, bytes over "
                     "the links' published peaks")
    if s.kind == "train" and any(k.startswith("attn") for k in
                                 cfg.layer_kinds):
        notes.append("flops count the flash backward as the port runs it, "
                     "torch ops over every block, masked pairs included")
    if s.kind == "decode":
        notes.append("the decode kernels count every cache row as live: the "
                     "shape's cache is full")
    if {"slstm", "mlstm"} & set(cfg.layer_kinds) and s.kind != "decode":
        notes.append("the sLSTM and mLSTM loops run as batches over their "
                     "positions and chunks on meta: the loops' operations "
                     "in a few cells' ops")
    return notes


def record(arch: str, cfg: ModelConfig, counted: Dict,
           mesh: str = "h100") -> Dict:
    """One mesh's record of a counted step (``count_step``)."""
    s = counted["shape"]
    mesh_name, axes = mesh_axes(mesh)
    chips = math.prod(axes.values())
    tokens = counted["batch"] * (1 if s.kind == "decode" else s.seq_len)
    model_flops = (6 if s.kind == "train" else 2) \
        * cfg.active_param_count() * tokens
    flops, nbytes = counted["flops"], counted["bytes"]
    kc = counted["kernel"]
    res = {
        "arch": arch, "shape": s.name, "kind": s.kind,
        "batch": counted["batch"], "seq_len": s.seq_len,
        "microbatches": counted["microbatches"], "mesh": mesh_name,
        "chips": chips,
        "compute_dtype": cfg.dtype,
        "param_count": cfg.param_count(),
        "active_param_count": cfg.active_param_count(),
        "tree_param_count": counted["tree_param_count"],
        "model_flops": model_flops, "flops": flops,
        "kernel_flops": kc.flops, "kernel_bytes": kc.bytes,
        "kernel_calls": dict(kc.calls),
        "useful_flops_ratio": model_flops / flops if flops else None,
        "bytes": nbytes, "resident_bytes": counted["resident_bytes"],
        "fits_80gb": counted["resident_bytes"] <= mesh_lib.CHIP_HBM_BYTES,
        "param_bytes_per_device": param_bytes_per_device(cfg, axes),
        "t_compute_s": flops / mesh_lib.PEAK_FLOPS[cfg.dtype] / chips,
        "t_memory_s": nbytes / mesh_lib.HBM_BW / chips,
        "count_s": counted["count_s"],
        "notes": _notes(cfg, s, mesh),
    }
    if counted["cache"] is not None:
        res["cache_bytes_per_device"] = cache_bytes_per_device(
            cfg, counted["cache"], axes)
    if chips == 1:
        res.update(collectives=None, collective_bytes_per_device=0,
                   t_collective_s=0.0,
                   resident_bytes_per_device=counted["resident_bytes"],
                   collective_note="one card: no collective")
    else:
        res.update(count_sharded(cfg, s, axes,
                                 microbatches=counted["microbatches"],
                                 batch_override=counted["batch"]))
    terms = {k: res[k] for k in ("t_compute_s", "t_memory_s")}
    res["bottleneck"] = max(terms, key=terms.get)
    return res


def lower_combo(arch: str, shape: Union[str, InputShape], *,
                mesh: str = "h100", cfg_override: Optional[ModelConfig] = None,
                microbatches: int = 1,
                batch_override: Optional[int] = None) -> Dict:
    """The record of (arch, shape) on ``mesh``: ``h100``, ``pod`` or
    ``multipod``. ``shape`` names one of ``SHAPES`` or is an
    ``InputShape`` of another geometry."""
    cfg = cfg_override or get_config(arch)
    counted = count_step(cfg, shape, microbatches=microbatches,
                         batch_override=batch_override)
    return record(arch, cfg, counted, mesh)


def record_path(outdir: str, arch: str, shape: str, mesh: str) -> str:
    return os.path.join(outdir, f"{arch}__{shape}__{mesh}.json")


def write_record(outdir: str, rec: Dict, mesh: str) -> None:
    os.makedirs(outdir, exist_ok=True)
    with open(record_path(outdir, rec["arch"], rec["shape"], mesh),
              "w") as fh:
        json.dump(rec, fh, indent=1)


def run_combo(arch: str, shape: str, meshes=("h100",),
              microbatches: int = 1) -> Dict[str, Dict]:
    """Count (arch, shape) once and return its record on each of
    ``meshes``, by mesh key."""
    cfg = get_config(arch)
    counted = count_step(cfg, shape, microbatches=microbatches)
    return {m: record(arch, cfg, counted, m) for m in meshes}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, help="arch id (default: all)")
    ap.add_argument("--shape", default=None, choices=list(SHAPES),
                    help="input shape (default: all)")
    ap.add_argument("--mesh", default="h100",
                    help="h100, pod, multipod, DxM, PxDxM or all")
    ap.add_argument("--force", action="store_true",
                    help="count again where a record exists")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--outdir", default=OUTDIR)
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = list(MESHES) if args.mesh == "all" else [args.mesh]
    failures = []
    for arch in archs:
        cfg = get_config(arch)
        for shape in shapes:
            if not shape_applicable(cfg, shape):
                for mesh in meshes:
                    print(f"SKIP {arch} x {shape} x {mesh_axes(mesh)[0]} "
                          f"(long-context not applicable)")
                continue
            counted = None
            for mesh in meshes:
                tag = f"{arch} x {shape} x {mesh_axes(mesh)[0]}"
                path = record_path(args.outdir, arch, shape, mesh)
                try:
                    t0 = time.perf_counter()
                    if os.path.exists(path) and not args.force:
                        with open(path) as fh:
                            r = json.load(fh)
                    else:
                        if counted is None:
                            counted = count_step(
                                cfg, shape, microbatches=args.microbatches)
                        r = record(arch, cfg, counted, mesh)
                        write_record(args.outdir, r, mesh)
                    print(f"OK   {tag}: flops={r['flops']:.3e} "
                          f"bytes={r['bytes']:.3e} "
                          f"resident={r['resident_bytes'] / 1e9:.2f} GB "
                          f"param/dev={r['param_bytes_per_device']:.3e} "
                          f"bottleneck={r['bottleneck']} "
                          f"[{time.perf_counter() - t0:.1f}s]")
                except Exception as e:    # noqa: BLE001 — report, go on
                    failures.append((tag, repr(e)))
                    print(f"FAIL {tag}: {e!r}")
    if failures:
        raise SystemExit(f"{len(failures)} dry-run failures: {failures}")


if __name__ == "__main__":
    main()
