"""The port's dry run, shapes, sharding rules and kernel cost functions
against the reference (CPU; counts only, no times).

* ``configs/shapes.py``: the shapes, ``input_specs`` (as meta tensors)
  and ``decode_context`` equal the reference's for every arch x shape;
* ``sharding/rules.py``: ``spec_for``, ``batch_shardings`` and
  ``cache_shardings`` equal the reference's on the draws of
  ``tests/test_sharding_props.py``'s strategies (the reference on
  ``jax.sharding.AbstractMesh``, the port on its axis mapping); for all
  ten full-size configs on 16x16 and 2x16x16 every parameter leaf's
  spec and the per-device parameter bytes equal the reference's
  ``params_shardings(eval_shape(init_params))`` with its dry run's
  ``leaf_device_bytes`` arithmetic, and decode_32k's cache specs equal
  leaf by leaf, the bytes parting only by the port's ``cross_len``;
* the ten parameter trees count as the reference's;
* the dry run of every smoke config over every applicable shape finishes
  on the meta device; a dense config's counted operations equal the
  closed form (2 M N K a product plus the flash kernel's cost), the
  train step's products 3x the forward's; it touches no CUDA and moves
  no launch counter;
* the meta paths (sLSTM and mLSTM loops, the flash backward's blocks)
  count what the CPU loops count;
* the kernels' cost functions give ``PERF.md``'s bound column;
* the collective term: rank 0's program of the sharded train step on a
  1x1 mesh issues and counts no collective; every full config the
  sharded steps run gets finite collective bytes and ``t_collective_s``
  at train_4k, prefill_32k, decode_32k and long_500k on 16x16 (the
  decode shapes' KV leaves sequence-sharded), and every other one
  records why it has none (the count of the smoke steps on 2x2, 1x4 and
  4x1 is held against the bytes a gloo run moved in
  ``test_torch_sharded.py`` and ``test_torch_sharded_serve.py``, beside
  the worlds they read).
"""
from __future__ import annotations

import math
from dataclasses import replace
from functools import lru_cache, partial

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from jax.sharding import AbstractMesh
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_config as ref_get_config
from repro.configs import shapes as ref_shapes
from repro.models import transformer as RT
from repro.sharding import rules as ref_rules
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs import shapes
from repro_torch.configs.shapes import InputShape
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rglru_scan import ops as scan_ops
from repro_torch.launch import dryrun, mesh as mesh_lib, roofline
from repro_torch.models import layers as L
from repro_torch.models import ssm
from repro_torch.models import transformer as T
from repro_torch.sharding import rules
from repro_torch.weights import reference_cache, reference_shapes

MESHES = {"16x16": (None, 16, 16), "2x16x16": (2, 16, 16)}


def ref_mesh(pod, data, model):
    if pod:
        return AbstractMesh((pod, data, model), ("pod", "data", "model"))
    return AbstractMesh((data, model), ("data", "model"))


def port_mesh(pod, data, model):
    return ({"pod": pod} if pod else {}) | {"data": data, "model": model}


def flat(tree, prefix=""):
    """A JAX pytree of dicts and lists -> {"a/0/b": leaf}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flat(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


@lru_cache(maxsize=None)
def ref_params(arch):
    return jax.eval_shape(partial(RT.init_params, ref_get_config(arch)),
                          jax.random.PRNGKey(0))


def leaf_device_bytes(leaf, spec, mesh):
    """The reference dry run's per-device bytes of one leaf."""
    n = int(np.prod(leaf.shape)) * leaf.dtype.itemsize
    div = 1
    for a in spec:
        if a is not None:
            div *= int(np.prod([mesh.shape[x] for x in
                                (a if isinstance(a, tuple) else (a,))]))
    return n // div


# ---------------------------------------------------------------------------
# shapes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_and_decode_context_match_reference(arch):
    assert {k: (v.seq_len, v.global_batch, v.kind)
            for k, v in shapes.SHAPES.items()} == {
        k: (v.seq_len, v.global_batch, v.kind)
        for k, v in ref_shapes.SHAPES.items()}
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    for shape in shapes.SHAPES:
        assert shapes.shape_applicable(cfg, shape) \
            == ref_shapes.shape_applicable(rcfg, shape)
        got = shapes.input_specs(cfg, shape)
        want = ref_shapes.input_specs(rcfg, shape)
        assert list(got) == list(want)
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(want[k].shape)
            assert str(t.dtype).removeprefix("torch.") == str(want[k].dtype)
        assert shapes.input_specs(cfg, shape, batch_override=3)[
            next(iter(got))].shape[0] == 3
        if shapes.SHAPES[shape].kind == "decode":
            assert shapes.decode_context(cfg, shape) \
                == ref_shapes.decode_context(rcfg, shape)


# ---------------------------------------------------------------------------
# sharding rules: the property tests' draws
# ---------------------------------------------------------------------------

PATHS = ["scan/0/block/wq", "scan/1/moe/w_gate", "rem/0/mlp/w_down",
         "embed", "lm_head", "scan/0/block/w_in", "encoder/0/block/wk",
         "scan/0/moe/router", "scan/0/block/conv_w", "frontend_proj/w1",
         "scan/0/block/w_up", "rem/1/block/wo", "opaque/leaf"]


@settings(max_examples=200, deadline=None)
@given(
    path=st.sampled_from(PATHS),
    rank=st.integers(1, 4),
    dims=st.lists(st.sampled_from([1, 2, 3, 4, 5, 8, 12, 16, 60, 128, 1152]),
                  min_size=4, max_size=4),
    pod=st.sampled_from([None, 2]),
    data=st.sampled_from([2, 4, 16]),
    model=st.sampled_from([2, 4, 16]),
)
def test_spec_for_matches_reference(path, rank, dims, pod, data, model):
    stacked = path.startswith("scan")
    shape = ((7,) if stacked else ()) + tuple(dims[:rank])
    want = ref_rules.spec_for(path, shape, ref_mesh(pod, data, model),
                              stacked=stacked)
    got = rules.spec_for(path, shape, port_mesh(pod, data, model),
                         stacked=stacked)
    assert got == tuple(want)


@settings(max_examples=100, deadline=None)
@given(
    b=st.sampled_from([1, 2, 8, 32, 128, 256]),
    extra=st.lists(st.integers(1, 64), min_size=0, max_size=2),
    pod=st.sampled_from([None, 2]),
)
def test_batch_shardings_match_reference(b, extra, pod):
    shape = (b,) + tuple(extra)
    want = ref_rules.batch_shardings(
        {"x": jax.ShapeDtypeStruct(shape, np.float32)}, ref_mesh(pod, 4, 4))
    got = rules.batch_shardings({"x": shape}, port_mesh(pod, 4, 4))
    assert got["x"] == tuple(want["x"].spec)


@settings(max_examples=60, deadline=None)
@given(
    b=st.sampled_from([1, 4, 32, 128]),
    s=st.sampled_from([512, 2048, 32768, 524288]),
    hk=st.sampled_from([1, 2, 4, 8]),
    hd=st.sampled_from([64, 128, 256]),
    leaf=st.sampled_from(["k", "cross_v", "C", "conv", "h"]),
)
def test_cache_shardings_match_reference(b, s, hk, hd, leaf):
    shape = {"k": (3, b, s, hk, hd), "cross_v": (3, b, s, hk, hd),
             "C": (3, b, hk, hd, hd), "conv": (3, b, 3, hd),
             "h": (3, b, hd)}[leaf]
    want = ref_rules.cache_shardings(
        {"scan": [{leaf: jax.ShapeDtypeStruct(shape, np.float32)}]},
        ref_mesh(None, 4, 4))
    got = rules.cache_shardings({f"scan/0/{leaf}": shape},
                                port_mesh(None, 4, 4))
    assert got[f"scan/0/{leaf}"] == tuple(want["scan"][0][leaf].spec)


# ---------------------------------------------------------------------------
# the ten full-size configs on the pod meshes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_and_bytes_match_reference(arch, mesh):
    rmesh, pmesh = ref_mesh(*MESHES[mesh]), port_mesh(*MESHES[mesh])
    tree = ref_params(arch)
    ref_sh = flat(ref_rules.params_shardings(tree, rmesh))
    ref_leaves = flat(tree)
    cfg = get_config(arch)
    leaves = reference_shapes(cfg)
    assert list(leaves) == list(ref_leaves)
    got = rules.params_shardings(leaves, pmesh)
    for k, leaf in ref_leaves.items():
        assert leaves[k][0] == tuple(leaf.shape), k
        assert got[k] == tuple(ref_sh[k].spec), k
    want_bytes = sum(leaf_device_bytes(leaf, ref_sh[k].spec, rmesh)
                     for k, leaf in ref_leaves.items())
    assert dryrun.param_bytes_per_device(cfg, pmesh) == want_bytes


@pytest.mark.parametrize("mesh", list(MESHES))
def test_compute_and_activation_specs_match_reference(mesh):
    rmesh, pmesh = ref_mesh(*MESHES[mesh]), port_mesh(*MESHES[mesh])
    for arch in ("qwen3_moe_235b_a22b", "recurrentgemma_9b"):
        want = flat(ref_rules.compute_params_shardings(ref_params(arch),
                                                       rmesh))
        got = rules.compute_params_shardings(
            reference_shapes(get_config(arch)), pmesh)
        assert got == {k: tuple(v.spec) for k, v in want.items()}
    assert rules.activation_spec(pmesh) \
        == tuple(ref_rules.activation_spec(rmesh))
    assert rules.logits_spec(pmesh) == tuple(ref_rules.logits_spec(rmesh))
    assert rules.replicated({"a": (2, 3)}, pmesh) == {"a": ()}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_cache_specs_match_reference(arch):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    ctx = shapes.decode_context(cfg, "decode_32k")
    ref_cache = flat(jax.eval_shape(partial(
        RT.init_cache, rcfg, ctx["batch"], ctx["max_len"],
        src_len=ctx["src_len"])))
    cache = T.init_cache(cfg, ctx["batch"], ctx["max_len"], device="meta")
    leaves = reference_shapes(reference_cache(cfg, cache))
    own = sorted(set(leaves) - set(ref_cache))
    assert all(k.endswith("/cross_len") for k in own)
    assert bool(own) == bool(cfg.n_encoder_layers)
    assert not set(ref_cache) - set(leaves)
    for mesh, axes in MESHES.items():
        rmesh, pmesh = ref_mesh(*axes), port_mesh(*axes)
        ref_sh = flat(ref_rules.cache_shardings(
            jax.eval_shape(partial(RT.init_cache, rcfg, ctx["batch"],
                                   ctx["max_len"], src_len=ctx["src_len"])),
            rmesh))
        got = rules.cache_shardings(leaves, pmesh)
        for k, leaf in ref_cache.items():
            assert leaves[k][0] == tuple(leaf.shape), (k, mesh)
            assert got[k] == tuple(ref_sh[k].spec), (k, mesh)
        own_bytes = sum(rules.device_bytes(leaves[k][0], 4, got[k], pmesh)
                        for k in own)
        assert dryrun.cache_bytes_per_device(cfg, cache, pmesh) == own_bytes \
            + sum(leaf_device_bytes(leaf, ref_sh[k].spec, rmesh)
                  for k, leaf in ref_cache.items())


def test_tree_counts_match_reference():
    counts = {}
    for arch in ARCH_IDS:
        want = sum(int(np.prod(l.shape)) for l in flat(ref_params(arch))
                   .values())
        got = sum(int(np.prod(s)) for s, _ in
                  reference_shapes(get_config(arch)).values())
        assert got == want, arch
        counts[arch] = got
    assert counts["qwen2_1_5b"] == 1_543_714_304
    assert counts["qwen3_moe_235b_a22b"] == 235_093_610_496
    assert counts["xlstm_350m"] == 528_336_040


# ---------------------------------------------------------------------------
# the dry run on meta
# ---------------------------------------------------------------------------

def _launches():
    return (fa_ops.flash_attention.launches, da_ops.decode_attention.launches,
            da_ops.paged_decode_attention.launches,
            scan_ops.rglru_scan_fwd.launches, scan_ops.rglru_scan_bwd.launches)


@pytest.fixture
def no_cuda(monkeypatch):
    """Any reach for the card during the test fails it."""
    def boom(*a, **k):
        raise AssertionError("the dry run reached for CUDA")
    for name in ("is_available", "device_count", "current_stream",
                 "synchronize", "get_device_properties", "device"):
        monkeypatch.setattr(torch.cuda, name, boom)
    before = _launches()
    yield
    assert _launches() == before


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_dry_run_every_shape(arch, no_cuda):
    cfg = get_config(arch).smoke()
    ref_tree = jax.eval_shape(partial(RT.init_params,
                                      ref_get_config(arch).smoke()),
                              jax.random.PRNGKey(0))
    tree_count = sum(int(np.prod(l.shape)) for l in flat(ref_tree).values())
    for shape in shapes.SHAPES:
        if not shapes.shape_applicable(cfg, shape):
            continue
        s = shapes.SHAPES[shape]
        recs = {m: dryrun.record(arch, cfg, counted, m)
                for counted in [dryrun.count_step(cfg, shape,
                                                  batch_override=2)]
                for m in dryrun.MESHES}
        r = recs["h100"]
        assert r["tree_param_count"] == tree_count
        assert r["flops"] >= r["kernel_flops"] >= 0 and r["flops"] > 0
        assert r["bytes"] > 0 and r["resident_bytes"] > 0 and r["fits_80gb"]
        assert r["bottleneck"] in ("t_compute_s", "t_memory_s")
        assert r["chips"] == 1 and recs["pod"]["chips"] == 256
        assert recs["multipod"]["t_compute_s"] * 512 == pytest.approx(
            r["t_compute_s"])
        if s.kind == "decode":
            assert recs["pod"]["cache_bytes_per_device"] \
                <= r["cache_bytes_per_device"]
        attn = sum(k.startswith("attn") for k in cfg.layer_kinds) \
            + cfg.n_encoder_layers + (cfg.n_layers if cfg.n_encoder_layers
                                      else 0)
        if s.kind != "decode":
            assert r["kernel_calls"].get("flash_attention", 0) == attn
            assert r["kernel_calls"].get("rglru_scan_fwd", 0) \
                == cfg.layer_kinds.count("rglru")
            assert r["kernel_calls"].get("rglru_scan_bwd", 0) == (
                cfg.layer_kinds.count("rglru") if s.kind == "train" else 0)


def _dense_products(cfg, b, s, logit_rows):
    """2 M N K of each product a dense GQA decoder's forward makes."""
    d, h, hk, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.resolved_head_dim, cfg.d_ff)
    per_token = 2 * d * hd * (2 * h + 2 * hk) + 2 * 3 * d * f
    return cfg.n_layers * b * s * per_token \
        + 2 * logit_rows * d * cfg.padded_vocab_size


def test_dense_counts_equal_the_closed_form(no_cuda):
    cfg = get_config("qwen2_1_5b").smoke()
    b, s = 2, 64
    h, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    fa = fa_ops.flash_attention_cost((b, s, h, hd), (b, s, hk, hd),
                                     itemsize=4)
    pre = dryrun.lower_combo("qwen2_1_5b", InputShape("p", s, b, "prefill"),
                             cfg_override=cfg)
    assert pre["kernel_flops"] == cfg.n_layers * fa.flops
    assert pre["flops"] == _dense_products(cfg, b, s, b) \
        + cfg.n_layers * fa.flops
    fa_lse = fa_ops.flash_attention_cost((b, s, h, hd), (b, s, hk, hd),
                                         itemsize=4, return_lse=True)
    tr = dryrun.lower_combo("qwen2_1_5b", InputShape("t", s, b, "train"),
                            cfg_override=cfg)
    # the flash backward in torch ops: five (Sq x Sk) products a layer
    # and the rowsum of dO * O
    fa_bwd = 10 * b * s * s * h * hd + 2 * b * s * h * hd
    products = tr["flops"] - cfg.n_layers * (fa_lse.flops + fa_bwd)
    assert tr["kernel_flops"] == cfg.n_layers * fa_lse.flops
    assert products == 3 * _dense_products(cfg, b, s, b * s)
    assert tr["model_flops"] == 6 * cfg.active_param_count() * b * s
    assert tr["resident_bytes"] == 16 * tr["tree_param_count"]


def test_cli_and_roofline_table(tmp_path, capsys):
    dryrun.main(["--arch", "gemma3_1b", "--shape", "long_500k", "--mesh",
                 "all", "--outdir", str(tmp_path)])
    assert "OK   gemma3_1b x long_500k x 2x16x16" in capsys.readouterr().out
    data = roofline.load_all(str(tmp_path))
    assert set(data) == {("gemma3_1b", "long_500k", m)
                         for m in ("h100", "16x16", "2x16x16")}
    roofline.main(["--dir", str(tmp_path)])
    table = capsys.readouterr().out.splitlines()
    assert len(table) == 3 and table[2].startswith("| gemma3_1b | long_500k")
    assert table[2].count("|") == 11
    with pytest.raises(SystemExit, match="1 dry-run failures"):
        dryrun.main(["--arch", "gemma3_1b", "--shape", "train_4k",
                     "--outdir", str(tmp_path), "--microbatches", "3"])
    assert "FAIL gemma3_1b x train_4k x h100" in capsys.readouterr().out


def test_one_rank_mesh_counts_no_collective(no_cuda):
    rec = dryrun.count_sharded(get_config("recurrentgemma_9b").smoke(),
                               InputShape("t", 32, 4, "train"),
                               {"data": 1, "model": 1})
    assert rec["collective_bytes_per_device"] == 0
    assert rec["t_collective_s"] == 0
    assert rec["collectives"]["count"] == 0
    assert rec["resident_bytes_per_device"] == 16 * sum(
        int(np.prod(s)) for s, _ in reference_shapes(
            T.Transformer(get_config("recurrentgemma_9b").smoke(),
                          device="meta")).values())


# train_4k keeps the arch as its id; the serving shapes are cases of
# the same test
POD_CASES = [pytest.param(a, "train_4k", id=a) for a in ARCH_IDS] + [
    pytest.param(a, s, id=f"{a}-{s}")
    for s in ("prefill_32k", "decode_32k", "long_500k") for a in ARCH_IDS
    if shapes.shape_applicable(get_config(a), s)]


# the xLSTM's and the encoder-decoder's train_4k programs take seconds a
# mesh on the meta device: counted on 16 x 16, their 2 x 16 x 16 terms
# at the serving shapes
POD_ONLY = {("xlstm_350m", "train_4k"), ("seamless_m4t_medium", "train_4k")}


@pytest.mark.parametrize("arch,shape", POD_CASES)
def test_collective_term_on_the_pod(arch, shape, no_cuda):
    """On 16 x 16 and 2 x 16 x 16 (``POD_ONLY``: 16 x 16)."""
    meshes = ("pod",) if (arch, shape) in POD_ONLY else ("pod", "multipod")
    for mesh in meshes:
        _pod_term(arch, shape, dryrun.MESHES[mesh][1])


def _pod_term(arch, shape, pod):
    rec = dryrun.count_sharded(get_config(arch), shape, pod)
    assert "collective_note" not in rec
    c = rec["collectives"]
    assert math.isfinite(rec["t_collective_s"]) and rec["t_collective_s"] > 0
    assert rec["collective_bytes_per_device"] == c["total"] == sum(
        c[k] for k in ("all-gather", "reduce-scatter", "all-reduce"))
    assert rec["t_collective_s"] == pytest.approx(sum(
        n / min(mesh_lib.LINK_PEAK_BW[a] for a in key.split(","))
        for key, n in c["by_axes"].items()))
    if shape == "train_4k":
        # ZeRO-3: a gather of each layer's compute copy over "data" in the
        # forward and again in the remat recompute of the scanned periods,
        # and one reduce-scatter of its gradient, per sharded leaf
        assert c["calls"]["all-gather"] > c["calls"]["reduce-scatter"] > 0
        return
    # serving: ZeRO-3's gathers over "data", the "model" sums, no
    # gradient to reduce-scatter
    assert c["calls"]["reduce-scatter"] == 0
    assert c["by_axes"]["data"] > 0 and c["by_axes"]["model"] > 0
    assert rec["resident_bytes_per_device"] > 0
    if shape == "prefill_32k":
        return
    # decode_32k's KV leaves go by kv heads where they divide 16
    # (qwen2-moe's 16), else by sequence over "model"; long_500k's single
    # sequence by sequence over ("data", "model"), whose partials the
    # decode step combines there
    cfg = get_config(arch)
    ctx = shapes.decode_context(cfg, shape)
    cache = T.init_cache(cfg, ctx["batch"], ctx["max_len"], device="meta")
    specs = rules.cache_shardings(reference_shapes(reference_cache(
        cfg, cache)), pod)
    kv = [spec for key, spec in specs.items()
          if key.split("/")[-1] in ("k", "v")]
    if not kv:
        # an xLSTM caches no K/V: its 4 heads do not divide 16, so the
        # mLSTM's C is held whole over "model", its conv tail by channel
        mem = [spec for key, spec in specs.items() if key.endswith("/C")]
        conv = [spec for key, spec in specs.items()
                if key.endswith("/conv")]
        assert mem and all("model" not in rules.spec_axes(sp) for sp in mem)
        assert conv and all(sp[-1] == "model" for sp in conv)
        return
    assert kv
    if shape == "decode_32k" and cfg.n_kv_heads % pod["model"] == 0:
        assert all(spec[-2] == "model" for spec in kv)
    else:
        seq = "model" if shape == "decode_32k" else ("data", "model")
        assert all(spec[-3] == seq for spec in kv)
    if shape == "long_500k":
        assert c["by_axes"]["data,model"] > 0


@pytest.mark.parametrize("mesh", ["pod", "multipod"])
def test_moe_banks_take_the_reference_cut(mesh):
    """qwen3-moe's 128 experts divide "model": its banks go by expert;
    qwen2-moe's 60 do not: every expert by its ff columns."""
    axes = dryrun.MESHES[mesh][1]
    want = {"qwen3_moe_235b_a22b": ((None, "model", "data", None),
                                    (None, "model", None, "data")),
            "qwen2_moe_a2_7b": ((None, None, "data", "model"),
                                (None, None, "model", "data"))}
    for arch, (up, down) in want.items():
        specs = rules.params_shardings(reference_shapes(get_config(arch)),
                                       axes)
        banks = {k: v for k, v in specs.items() if "/moe/w_" in k}
        assert banks and all(v == (down if k.endswith("w_down") else up)
                             for k, v in banks.items())


@pytest.mark.parametrize("arch", ["qwen3_moe_235b_a22b", "recurrentgemma_9b",
                                  "gemma3_1b"])
def test_periods_counted_by_difference(arch, no_cuda):
    """A config of more than two periods is counted at one and two: the
    same counts and bytes as the whole program run on meta."""
    cfg = replace(get_config(arch).smoke(), n_layers=7)
    for shape in (InputShape("t", 32, 4, "train"),
                  InputShape("p", 16, 4, "prefill"),
                  InputShape("d", 32, 4, "decode")):
        axes = {"data": 2, "model": 2}
        rec = dryrun.count_sharded(cfg, shape, axes)
        counts, held = dryrun._run_sharded(
            cfg, shape, axes, shapes.input_specs(cfg, shape), 1, None)
        n = sum(p.numel() for p in rules.shard_params(T.Transformer(
            cfg, device="meta", dtype=torch.float32),
            mesh_lib.abstract_mesh(axes)).parameters())
        assert cfg.n_periods > 2
        assert rec["collectives"] == counts.record()
        assert rec["resident_bytes_per_device"] == (
            16 if shape.kind == "train" else 4) * n + held


def test_mesh_constants_and_debug_mesh():
    assert mesh_lib.make_production_mesh() == {"data": 16, "model": 16}
    assert list(mesh_lib.make_production_mesh(multi_pod=True)) == [
        "pod", "data", "model"]
    assert mesh_lib.PEAK_FLOPS["bfloat16"] == 989e12
    assert mesh_lib.HBM_BW == 3.35e12
    assert mesh_lib.NVLINK_PEAK_BW == 450e9
    assert mesh_lib.parse_mesh("2x16x16") == {"pod": 2, "data": 16,
                                              "model": 16}
    if torch.cuda.device_count() == 0:
        with pytest.raises(RuntimeError, match="need 1 CUDA"):
            mesh_lib.make_debug_mesh()


# ---------------------------------------------------------------------------
# the meta paths count what the loops count
# ---------------------------------------------------------------------------

def _flops(fn):
    with FlopCounterMode(display=False) as fc:
        out = fn()
    return fc.get_total_flops(), out


@pytest.mark.parametrize("grad", [False, True])
def test_meta_loops_count_as_the_cpu_loops(grad):
    def mlstm(dev):
        g = torch.Generator().manual_seed(0)

        def mk(*shape):
            return torch.randn(shape, generator=g).to(dev).requires_grad_(grad)
        q, k, v = mk(2, 70, 3, 8), mk(2, 70, 3, 8), mk(2, 70, 3, 8)
        out, st = ssm.mlstm_chunkwise(q, k, v, mk(2, 70, 3), mk(2, 70, 3),
                                      chunk=16)
        if grad:
            out.sum().backward()
        return out.shape, [t.shape for t in st]

    def slstm(dev):
        g = torch.Generator().manual_seed(0)
        p = ssm.SLSTMBlock.__new__(ssm.SLSTMBlock)
        torch.nn.Module.__init__(p)
        p.r = torch.randn(4, 2, 4, 4, generator=g).to(dev).requires_grad_(grad)
        p.b = torch.randn(4, 2, 4, generator=g).to(dev)
        wx = torch.randn(2, 9, 4, 2, 4, generator=g).to(dev) \
            .requires_grad_(grad)
        hs, st = ssm.slstm_scan(p, wx, ssm._slstm_zero_state(2, 2, 4, dev))
        if grad:
            hs.sum().backward()
        return hs.shape, [t.shape for t in st]

    def flash_bwd(dev):
        g = torch.Generator().manual_seed(0)

        def r(*shape):
            return torch.randn(shape, generator=g).to(dev)
        out = L.flash_attention_bwd(
            r(2, 70, 4, 8), r(2, 50, 2, 8), r(2, 50, 2, 8), r(2, 70, 4, 8),
            r(2, 4, 70), r(2, 70, 4, 8), causal=False, window=0, chunk=16,
            scale=0.3)
        return [t.shape for t in out]

    for fn in (mlstm, slstm, flash_bwd):
        assert _flops(lambda: fn("meta")) == _flops(lambda: fn("cpu"))


def test_meta_flash_refuses_lengths_it_cannot_count():
    q = torch.empty(1, 4, 2, 8, device="meta")
    k = torch.empty(1, 6, 1, 8, device="meta")
    lens = torch.empty(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no lengths"):
        fa_ops.flash_attention(q, k, k, kv_len=lens)


# ---------------------------------------------------------------------------
# the cost functions give PERF.md's bound column
# ---------------------------------------------------------------------------

FIFO_LENS = [1, 513, 518, 523, 528, 533, 538, 544]
LL_LENS = [1] + [3392 + 1 + 5 * i for i in range(7)]


def _fa(b, sq, sk, h, hk, d, **kw):
    return fa_ops.flash_attention_cost((b, sq, h, d), (b, sk, hk, d), **kw)


def _dec(lens, h, hk, d, pages=0):
    return da_ops.decode_attention_cost(len(lens), h, hk, d,
                                        live_rows=sum(lens), pages=pages)


# (row of PERF.md section 6's table, cost, dtype, bound ms, bound by)
PERF_BOUNDS = [
    ("qwen2 fifo prefill", _fa(1, 512, 512, 12, 2, 128), "bfloat16",
     "0.0011", "bytes"),
    ("prefix resume", _fa(1, 256, 560, 12, 2, 128, q_offset=[256],
                          kv_len=[512]), "bfloat16", "0.0006", "bytes"),
    ("training shape", _fa(1, 4096, 4096, 16, 1, 256, window=2048,
                           return_lse=True), "bfloat16", "0.1042",
     "operations"),
    ("gemma3 local", _fa(1, 1024, 1024, 4, 1, 256, window=512), "bfloat16",
     "0.0016", "operations"),
    ("gemma3 global", _fa(1, 1024, 1024, 4, 1, 256), "bfloat16", "0.0022",
     "operations"),
    ("recurrentgemma local", _fa(1, 512, 512, 16, 1, 256, window=2048),
     "bfloat16", "0.0027", "bytes"),
    ("recurrentgemma 2,080", _fa(1, 2080, 2080, 16, 1, 256, window=2048),
     "bfloat16", "0.0358", "operations"),
    ("qwen2-moe prefill", _fa(1, 512, 512, 16, 16, 128), "bfloat16",
     "0.0025", "bytes"),
    ("qwen3-moe prefill", _fa(1, 256, 256, 64, 4, 128), "bfloat16",
     "0.0027", "bytes"),
    ("qwen2-moe training", _fa(1, 2048, 2048, 16, 16, 128, return_lse=True),
     "bfloat16", "0.0174", "operations"),
    ("seamless encoder", _fa(1, 512, 512, 16, 16, 64, causal=False),
     "bfloat16", "0.0013", "bytes"),
    ("cross 300 over 512", _fa(1, 300, 512, 16, 16, 64, causal=False),
     "bfloat16", "0.0010", "bytes"),
    ("seamless decoder", _fa(1, 512, 512, 16, 16, 64), "bfloat16", "0.0013",
     "bytes"),
    ("llava prefill", _fa(1, 3392, 3392, 32, 8, 128), "bfloat16", "0.0953",
     "operations"),
    # phase 16's shapes on the 1 x 1 sharded steps
    ("seamless16 encoder", _fa(8, 512, 512, 16, 16, 64, causal=False),
     "bfloat16", "0.0100", "bytes"),
    ("seamless16 decoder", _fa(8, 512, 512, 16, 16, 64), "bfloat16",
     "0.0100", "bytes"),
    ("llava16 prefill", _fa(4, 3136, 3136, 32, 8, 128), "bfloat16",
     "0.3259", "operations"),
    ("qwen2 fifo decode", _dec(FIFO_LENS, 12, 2, 128), "bfloat16", "0.0011",
     "bytes"),
    ("gemma3 rings", _dec([512] * 8, 4, 1, 256), "bfloat16", "0.0013",
     "bytes"),
    ("gemma3 global decode", _dec([1040] * 8, 4, 1, 256), "bfloat16",
     "0.0026", "bytes"),
    ("recurrentgemma rings", _dec([528] * 6 + [2048] * 2, 16, 1, 256),
     "bfloat16", "0.0023", "bytes"),
    ("qwen2-moe decode", _dec(FIFO_LENS, 16, 16, 128), "bfloat16", "0.0091",
     "bytes"),
    ("qwen3-moe decode", _dec([257 + 2 * i for i in range(8)], 64, 4, 128),
     "bfloat16", "0.0014", "bytes"),
    ("seamless self", _dec(FIFO_LENS, 16, 16, 64), "bfloat16", "0.0045",
     "bytes"),
    ("seamless cross", _dec([0] + [512] * 7, 16, 16, 64), "bfloat16",
     "0.0044", "bytes"),
    ("llava decode", _dec(LL_LENS, 32, 8, 128), "bfloat16", "0.0292",
     "bytes"),
    ("seamless16 self", _dec([516] * 8, 16, 16, 64), "bfloat16", "0.0051",
     "bytes"),
    ("seamless16 cross", _dec([512] * 8, 16, 16, 64), "bfloat16", "0.0050",
     "bytes"),
    ("llava16 decode", _dec([3140] * 4, 32, 8, 128), "bfloat16", "0.0154",
     "bytes"),
    ("qwen2 paged", _dec(FIFO_LENS, 12, 2, 128, pages=35), "bfloat16",
     "0.0011", "bytes"),
    ("gemma3 global paged", _dec([1040] * 8, 4, 1, 256, pages=67),
     "bfloat16", "0.0026", "bytes"),
    ("llava paged", _dec(LL_LENS, 32, 8, 128, pages=215), "bfloat16",
     "0.0292", "bytes"),
    ("scan training", scan_ops.rglru_scan_cost(1, 4096, 4096), "float32",
     "0.0601", "bytes"),
    ("scan prefill 512", scan_ops.rglru_scan_cost(1, 512, 4096), "float32",
     "0.0075", "bytes"),
    ("scan prefill 2,080", scan_ops.rglru_scan_cost(1, 2080, 4096),
     "float32", "0.0305", "bytes"),
    ("scan reverse", scan_ops.rglru_scan_cost(1, 4096, 4096, reverse=True),
     "float32", "0.1002", "bytes"),
]


@pytest.mark.parametrize("row,cost,dtn,want,by", PERF_BOUNDS,
                         ids=[r[0] for r in PERF_BOUNDS])
def test_cost_functions_give_the_bound_column(row, cost, dtn, want, by):
    t_ops = cost.flops / mesh_lib.PEAK_FLOPS[dtn]
    t_bytes = cost.bytes / mesh_lib.HBM_BW
    assert f"{max(t_ops, t_bytes) * 1e3:.4f}" == want
    assert ("operations" if t_ops > t_bytes else "bytes") == by
