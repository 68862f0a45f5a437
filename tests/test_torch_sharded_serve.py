"""The sharded prefill and serve steps of the port on CPU ranks over
gloo, fp32, and the decode kernel's log-sum-exp partials.

One world of 4 ranks (separate processes started once for the module,
joined through a ``FileStore`` under the test's temporary directory)
runs the meshes 2x2, 1x4 and 4x1 in turn: ``make_prefill_step`` on a
16-token prompt (``max_len`` 32), then 6 steps of ``make_serve_step``,
on ``qwen2_1_5b.smoke()`` (4 query heads over 2 kv heads: the heads
layout on 2x2, the sequence layout over "model" on 1x4) and on
``recurrentgemma_9b.smoke()`` (rglru + attn_local over 1 kv head: the
sequence layout; its ring of 8 rows wraps during the run), at batch 4
and at batch 1, where the 2x2 mesh cuts the sequence over ("data",
"model") as ``long_500k`` does; and on the MoE smoke configs of
qwen2-moe and qwen3-moe (4 query heads over 4 kv heads, 4 routed
experts by expert over "model"); and on one mesh each (``ONE_MESH``
of ``test_torch_sharded.py``), xlstm-350m's (C by heads over "model" on
2x2, and a 2-head variant whose blocks run whole on 1x4),
seamless-m4t-medium's (a source of 16 frames, the cross K/V placed
like the K/V, on 2x2) and llava-next-mistral-7b's (8 patch rows ahead
of 8 tokens, on 2x2), the ``embeds`` N(0, 1) from a numpy seed
(``frontend_embeds``). The sLSTM configs also prefill 8 tokens: the
same collectives, call for call, as 16 (no collective inside the time
loop). The weights are ``weights.seeded_flat``
(seed 0) carried in by ``from_jax_params``, cut by ``shard_params``.
Every step feeds the greedy tokens of the port's unsharded run. Held
against:

* the port's unsharded ``prefill`` / ``decode_step`` on the same
  weights: each rank's logits within 1e-5 of the largest logit, its
  greedy tokens identical, every leaf of ``gather_cache`` after the
  last step within 1e-5 absolute [measured: 3.9e-7 and 1.9e-6];
* the reference's ``make_prefill_step`` / ``make_serve_step`` with
  ``mesh=None`` (the dense and hybrid configs) and, for recurrentgemma,
  qwen2-moe and the three later families, on a 1x1 mesh of
  ``AxisType.Auto`` axes (the
  reference's own ``make_debug_mesh`` makes Explicit axes): logits
  within 1e-4 of the largest, tokens identical;

and, on each mesh: ``shard_cache`` then ``gather_cache`` of the
unsharded prefill's cache is exact, and each rank's collectives of the
prefill and of every decode step equal, kind by kind, the dry run's
count of the same step (``dryrun.count_sharded``, rank 0's program on
the meta device), and the decode kernel is called with ``return_lse``
exactly where the sequence is cut over more than one rank. A world of
one rank gives the unsharded steps bit for bit; every family builds
and is counted. ``decode_attention(...,
return_lse=True)``'s plain version split over 2 and 4 row ranges (some
empty) and merged by ``combine_partials`` gives the unsplit result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.shapes import InputShape
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.launch import dryrun, mesh as mesh_lib
from repro_torch.models import transformer as PT
from repro_torch.runtime.trainstep import make_prefill_step, make_serve_step
from repro_torch.sharding import combine_partials
from repro_torch.sharding.rules import shard_params
from repro_torch.weights import from_jax_params, seeded_flat
from test_torch_sharded import (_env, archs_on, frontend_embeds, mesh_id,
                                smoke)

ARCHS = ("qwen2_1_5b", "recurrentgemma_9b", "qwen2_moe_a2_7b",
         "qwen3_moe_235b_a22b", "xlstm_350m", "xlstm_350m:h2",
         "seamless_m4t_medium", "llava_next_mistral_7b")
MESHES = ((2, 2), (1, 4), (4, 1))
# geometry: (batch, prompt length, max_len)
GEOMS = {"b4": (4, 16, 32), "b1": (1, 16, 32)}
STEPS = 6
WORLD = 4
TOL = 1e-5
TOL_JAX = 1e-4
TOL_CACHE = 1e-5
TOL_SPLIT = 2e-6
JAX_RUNS = (("recurrentgemma_9b", "none"), ("recurrentgemma_9b", "1x1"),
            ("qwen2_1_5b", "none"), ("qwen2_moe_a2_7b", "1x1"),
            ("xlstm_350m", "1x1"), ("seamless_m4t_medium", "1x1"),
            ("llava_next_mistral_7b", "1x1"))
SHORT = 8       # the sLSTM configs' second prefill length
CELLS = [pytest.param(m, a, id=f"{mesh_id(m)}-{a}")
         for m in MESHES for a in archs_on(m, ARCHS)]

# one rank of the world: every mesh, config and geometry; each rank
# writes its rows' logits and its counts, rank 0 the gathered caches
RANK = textwrap.dedent('''
    import json, sys
    import numpy as np, torch
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import transformer as T
    from repro_torch.runtime.trainstep import (make_prefill_step,
                                               make_serve_step)
    from repro_torch.sharding.rules import (ShardCtx, gather_cache,
                                            shard_cache, shard_params)
    from repro_torch.weights import from_jax_params
    from repro_torch.models import layers as L

    from test_torch_sharded import smoke

    # the attention layers' decode-kernel calls, by output
    calls = {"default": 0, "lse": 0}
    kernel = L.decode_attention

    def counted(*a, **kw):
        calls["lse" if kw.get("return_lse") else "default"] += 1
        return kernel(*a, **kw)
    L.decode_attention = counted

    rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    spec = json.load(open(f"{tmp}/spec.json"))
    torch.set_num_threads(1)
    mesh_lib.init_world(rank, world, f"{tmp}/store", device="cpu")
    out = {}
    for data, model, archs in spec["cells"]:
        mesh = mesh_lib.make_debug_mesh(data, model, device="cpu")
        for arch in archs:
            cfg = smoke(arch)
            inp = np.load(f"{tmp}/{arch}.npz")
            flat = {k[2:]: inp[k] for k in inp.files if k.startswith("p|")}
            full = from_jax_params(flat, cfg, device="cpu",
                                   dtype=torch.float32)
            local = shard_params(full, mesh)
            for geom, (b, s, max_len) in spec["geoms"].items():
                tag = f"{data}x{model}/{arch}/{geom}"
                prompt = torch.from_numpy(inp[f"{geom}|prompt"])
                embeds = torch.from_numpy(inp[f"{geom}|embeds"]) \
                    if f"{geom}|embeds" in inp.files else None
                batch = {"tokens": prompt} if embeds is None else \
                    {"tokens": prompt, "embeds": embeds}
                fed = inp[f"{geom}|fed"]
                _, whole, _ = T.prefill(full, prompt, max_len=max_len,
                                        embeds=embeds)
                back = gather_cache(shard_cache(whole, mesh), mesh)
                out[f"{tag}/exact"] = all(
                    torch.equal(back[i][k], whole[i][k])
                    for i in range(len(whole)) for k in whole[i])
                rows = ShardCtx(mesh, batch=b).rows(torch.arange(b))
                prefill = make_prefill_step(cfg, max_len=max_len, mesh=mesh)
                if "slstm" in cfg.layer_kinds:
                    # the time loop at another length: the same calls
                    mesh.counts.reset()
                    prefill(local, {"tokens": prompt[:, :spec["short"]]})
                    out[f"{tag}/counts_short"] = mesh.counts.record()
                mesh.counts.reset()
                logits, cache, clen = prefill(local, batch)
                counts = [mesh.counts.record()]
                got = [logits.numpy()]
                step = make_serve_step(cfg, mesh)
                calls.update(default=0, lse=0)
                for i in range(len(fed)):
                    mesh.counts.reset()
                    logits, cache, clen = step(
                        local, cache, fed[i], np.full((b,), s + i, np.int32))
                    counts.append(mesh.counts.record())
                    got.append(logits.numpy())
                out[f"{tag}/counts"] = counts
                out[f"{tag}/calls"] = dict(calls)
                out[f"{tag}/specs"] = {
                    f"{i}/{k}": list(map(str, t.shard_spec))
                    for i, c in enumerate(cache) for k, t in c.items()}
                out[f"{tag}/clen"] = clen.tolist()
                np.savez(f"{tmp}/r{rank}_{tag.replace('/', '_')}.npz",
                         rows=rows.numpy(), logits=np.stack(got))
                whole = gather_cache(cache, mesh)
                if rank == 0:
                    np.savez(f"{tmp}/cache_{tag.replace('/', '_')}.npz",
                             **{f"{i}/{k}": t.numpy()
                                for i, c in enumerate(whole)
                                for k, t in c.items()})
    torch.distributed.destroy_process_group()
    json.dump(out, open(f"{tmp}/out{rank}.json", "w"))
''')


def embeds_of(cfg, geom):
    """The geometry's ``frontend_embeds`` (None without a frontend)."""
    b, s, _ = GEOMS[geom]
    return frontend_embeds(cfg, b, s, 2 + b)


def prompt_of(cfg, geom):
    """The geometry's prompt: a vision frontend's rows take the place of
    as many tokens, as the dry run's ``input_specs`` has it."""
    b, s, _ = GEOMS[geom]
    rng = np.random.RandomState(1 + b)
    s -= PT.frontend_rows(cfg, embeds_of(cfg, geom))
    return rng.randint(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _cache_arrays(cache):
    return {f"{i}/{k}": t.numpy() for i, c in enumerate(cache)
            for k, t in c.items()}


def unsharded_run(model, cfg, prompt, max_len, steps=STEPS, embeds=None):
    """The port's unsharded prefill and greedy decode steps: (the fed
    tokens (steps, B), logits (steps + 1, B, V), the last cache)."""
    logits, cache, clen = PT.prefill(
        model, torch.from_numpy(prompt), max_len=max_len,
        embeds=None if embeds is None else torch.from_numpy(embeds))
    fed, out = [], [logits.numpy()]
    for _ in range(steps):
        tok = logits.argmax(-1).to(torch.int32)
        fed.append(tok.numpy())
        logits, cache, clen = PT.decode_step(model, tok, cache, clen)
        out.append(logits.numpy())
    return np.stack(fed), np.stack(out), cache


@pytest.fixture(scope="module")
def unsharded():
    """Per (arch, geometry): the weights, prompt and unsharded run."""
    out = {}
    for arch in ARCHS:
        cfg = smoke(arch)
        flat = seeded_flat(cfg, 0)
        model = from_jax_params(flat, cfg, device="cpu", dtype=torch.float32)
        for geom, (_, _, max_len) in GEOMS.items():
            prompt, embeds = prompt_of(cfg, geom), embeds_of(cfg, geom)
            fed, logits, cache = unsharded_run(model, cfg, prompt, max_len,
                                               embeds=embeds)
            out[(arch, geom)] = {"flat": flat, "prompt": prompt, "fed": fed,
                                 "embeds": embeds, "logits": logits,
                                 "cache": _cache_arrays(cache)}
    return out


@pytest.fixture(scope="module")
def world(unsharded, tmp_path_factory):
    """Run the 4-rank world once, and the reference's steps here while it
    runs: the world's records by rank and the reference's logits."""
    tmp = tmp_path_factory.mktemp("world")
    for arch in ARCHS:
        arrays = {f"p|{k}": v
                  for k, v in unsharded[(arch, "b4")]["flat"].items()}
        for geom in GEOMS:
            run = unsharded[(arch, geom)]
            arrays[f"{geom}|prompt"] = run["prompt"]
            arrays[f"{geom}|fed"] = run["fed"]
            if run["embeds"] is not None:
                arrays[f"{geom}|embeds"] = run["embeds"]
        np.savez(tmp / f"{arch}.npz", **arrays)
    (tmp / "spec.json").write_text(json.dumps(
        {"cells": [m + (archs_on(m, ARCHS),) for m in MESHES],
         "geoms": GEOMS, "short": SHORT}))
    procs = [subprocess.Popen([sys.executable, "-c", RANK, str(r),
                               str(WORLD), str(tmp)], env=_env(),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    logs = []
    try:
        jax_out = _jax_results(unsharded)
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]
    out = [json.loads((tmp / f"out{r}.json").read_text())
           for r in range(WORLD)]
    return {"out": out, "tmp": tmp, "jax": jax_out}


def _rank_logits(world, tag):
    """(rows, logits (steps + 1, B_rank, V)) of each rank."""
    name = tag.replace("/", "_")
    for r in range(WORLD):
        got = np.load(world["tmp"] / f"r{r}_{name}.npz")
        yield got["rows"], got["logits"]


def _scaled_err(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("geom", GEOMS)
@pytest.mark.parametrize("mesh,arch", CELLS)
def test_sharded_serving_matches_unsharded(world, unsharded, mesh, arch,
                                           geom):
    tag = f"{mesh[0]}x{mesh[1]}/{arch}/{geom}"
    run = unsharded[(arch, geom)]
    b = GEOMS[geom][0]
    seen = set()
    for rows, logits in _rank_logits(world, tag):
        want = run["logits"][:, rows]
        assert _scaled_err(logits, want) < TOL, tag
        # the greedy choice of every step after the prefill's is the token
        # fed at the next step
        assert np.array_equal(logits[:-1].argmax(-1), run["fed"][:, rows])
        assert np.array_equal(logits[-1].argmax(-1),
                              want[-1].argmax(-1))
        seen.update(rows.tolist())
    assert seen == set(range(b))
    got = dict(np.load(world["tmp"] / f"cache_{tag.replace('/', '_')}.npz"))
    assert set(got) == set(run["cache"])
    for k, w in run["cache"].items():
        assert got[k].shape == w.shape
        assert float(np.max(np.abs(got[k] - w))) < TOL_CACHE, k
    for r, out in enumerate(world["out"]):
        assert out[f"{tag}/exact"]
        assert out[f"{tag}/clen"] == [GEOMS[geom][1] + STEPS] * len(
            np.load(world["tmp"] / f"r{r}_{tag.replace('/', '_')}.npz")[
                "rows"])
    # the layouts the cache rules give, and the collectives they cost
    specs = world["out"][0][f"{tag}/specs"]
    kv = [v for k, v in specs.items() if k.split("/")[-1] in (
        "k", "cross_k")]
    if b % mesh[0]:
        assert all(v[1] == "('data', 'model')" for v in kv)
    elif smoke(arch).n_kv_heads % mesh[1] == 0:
        assert all(v[2] == "model" for v in kv)
    else:
        assert all(v[1] == "model" for v in kv)
    # the mLSTM's matrix memory by heads over "model" where they divide,
    # its conv tail by channel
    cfg = smoke(arch)
    for k, v in specs.items():
        if k.endswith("/C") and mesh[1] > 1:
            assert (v[1] == "model") == (cfg.n_heads % mesh[1] == 0), k
        if k.endswith("/conv") and "mlstm" in cfg.layer_kinds:
            assert v[-1] == "model" or mesh[1] == 1, k
    counts = world["out"][0][f"{tag}/counts"]
    assert all(c["total"] > 0 for c in counts)
    if mesh[1] > 1:
        assert all(c["by_axes"].get("model", 0) > 0 for c in counts)
    assert all((c["by_axes"].get("data", 0) > 0) == (mesh[0] > 1)
               for c in counts)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_flash_decode_calls_follow_the_layout(world, mesh):
    """Each rank's decode steps call the kernel with ``return_lse`` once
    per attention layer a step where the cache rules cut the sequence
    over more than one rank (the batch does not divide "data": over
    ("data", "model"); else the kv heads do not divide "model": over
    "model"), and the default output otherwise."""
    data, model = mesh
    for arch in archs_on(mesh, ARCHS):
        cfg = smoke(arch)
        att = sum(k in ("attn", "attn_local") for k in cfg.layer_kinds) \
            * (2 if cfg.n_encoder_layers else 1)     # self and cross
        for geom, (b, _, _) in GEOMS.items():
            cut = data * model if b % data else \
                1 if cfg.n_kv_heads % model == 0 else model
            want = {"default": 0, "lse": att * STEPS} if cut > 1 else \
                {"default": att * STEPS, "lse": 0}
            for out in world["out"]:
                assert out[f"{data}x{model}/{arch}/{geom}/calls"] == want, \
                    (arch, geom)


@pytest.mark.parametrize("mesh,arch", [
    c for c in CELLS if "slstm" in smoke(c.values[1]).layer_kinds])
def test_slstm_loop_issues_no_collective_per_position(world, mesh, arch):
    """The sLSTM runs its time loop on the rank's heads (or, where
    "model" does not divide them, on the whole block): a prefill of
    ``SHORT`` positions issues the collectives of one of 16, call for
    call."""
    tag = f"{mesh_id(mesh)}/{arch}"
    for geom in GEOMS:
        for out in world["out"]:
            short = out[f"{tag}/{geom}/counts_short"]
            assert short["calls"] == out[f"{tag}/{geom}/counts"][0]["calls"]
            assert short["count"] > 0


def _jax_results(unsharded):
    """The reference's prefill and serve steps without a mesh and, for
    recurrentgemma, on a 1x1 mesh of Auto axes, fed the port's greedy
    tokens: {(arch, mesh, geometry): logits (steps + 1, B, V)}."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType

    from repro.configs import get_config as ref_get_config
    from repro.runtime.trainstep import make_prefill_step as jprefill
    from repro.runtime.trainstep import make_serve_step as jserve
    from test_torch_families import fast_jit
    from test_torch_golden import unflatten
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    out = {}
    for arch, name in JAX_RUNS:
        cfg = ref_get_config(arch).smoke()
        m = mesh if name == "1x1" else None
        serve = fast_jit(jserve(cfg, m))
        for geom, (_, s, max_len) in GEOMS.items():
            run = unsharded[(arch, geom)]
            params = unflatten(run["flat"])
            prefill = fast_jit(jprefill(cfg, max_len=max_len, mesh=m))
            batch = {"tokens": jnp.asarray(run["prompt"])}
            if run["embeds"] is not None:
                batch["embeds"] = jnp.asarray(run["embeds"])
            logits, cache, clen = prefill(params, batch)
            got = [np.asarray(logits)]
            for tok in run["fed"]:
                logits, cache, clen = serve(params, cache, jnp.asarray(tok),
                                            clen)
                got.append(np.asarray(logits))
            out[(arch, name, geom)] = np.stack(got)
    return out


@pytest.mark.parametrize("geom", GEOMS)
@pytest.mark.parametrize("arch,ref_mesh", JAX_RUNS)
def test_sharded_serving_matches_jax(world, unsharded, arch, ref_mesh,
                                     geom):
    want = world["jax"][(arch, ref_mesh, geom)]
    fed = unsharded[(arch, geom)]["fed"]
    assert np.array_equal(want[:-1].argmax(-1), fed)
    for mesh in (m for m in MESHES if arch in archs_on(m, ARCHS)):
        tag = f"{mesh[0]}x{mesh[1]}/{arch}/{geom}"
        for rows, logits in _rank_logits(world, tag):
            assert _scaled_err(logits, want[:, rows]) < TOL_JAX, tag
            assert np.array_equal(logits.argmax(-1), want[:, rows].argmax(-1))


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_dry_run_counts_equal_the_gloo_run(world, mesh):
    axes = {"data": mesh[0], "model": mesh[1]}
    for arch in archs_on(mesh, ARCHS):
        cfg = smoke(arch)
        for geom, (b, s, max_len) in GEOMS.items():
            pre = dryrun.count_sharded(cfg, InputShape("p", s, b, "prefill"),
                                       axes)
            dec = dryrun.count_sharded(
                cfg, InputShape("d", max_len, b, "decode"), axes)
            tag = f"{mesh[0]}x{mesh[1]}/{arch}/{geom}"
            for out in world["out"]:
                counts = out[f"{tag}/counts"]
                assert counts[0] == pre["collectives"], tag
                assert all(c == dec["collectives"] for c in counts[1:]), tag


def test_one_rank_world_is_bit_for_bit(unsharded, tmp_path):
    mesh_lib.init_world(0, 1, str(tmp_path / "store"), device="cpu")
    det = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        mesh = mesh_lib.make_debug_mesh(1, 1, device="cpu")
        for (arch, geom), run in unsharded.items():
            cfg = smoke(arch)
            b, s, max_len = GEOMS[geom]
            full = from_jax_params(run["flat"], cfg, device="cpu",
                                   dtype=torch.float32)
            want = unsharded_run(full, cfg, run["prompt"], max_len,
                                 embeds=run["embeds"])
            local = shard_params(full, mesh)
            batch = {"tokens": run["prompt"]}
            if run["embeds"] is not None:
                batch["embeds"] = run["embeds"]
            logits, cache, clen = make_prefill_step(
                cfg, max_len=max_len, mesh=mesh)(local, batch)
            got = [logits.numpy()]
            step = make_serve_step(cfg, mesh)
            for tok in want[0]:
                logits, cache, clen = step(local, cache, tok, clen)
                got.append(logits.numpy())
            assert np.array_equal(np.stack(got), want[1]), (arch, geom)
            whole = _cache_arrays(want[2])
            assert all(np.array_equal(t.numpy(), whole[f"{i}/{k}"])
                       for i, c in enumerate(cache) for k, t in c.items())
            assert mesh.counts.total == 0 and not mesh.counts.calls
    finally:
        torch.use_deterministic_algorithms(det)
        torch.distributed.destroy_process_group()


def test_refusals():
    mesh = mesh_lib.abstract_mesh({"data": 2, "model": 2})
    # every family builds over the mesh, and the dry run counts it: MoE,
    # xLSTM, the encoder-decoder and the vision frontend
    for arch in ("qwen2_moe_a2_7b", "qwen3_moe_235b_a22b", "xlstm_350m",
                 "seamless_m4t_medium", "llava_next_mistral_7b"):
        cfg = smoke(arch)
        make_prefill_step(cfg, max_len=8, mesh=mesh)
        make_serve_step(cfg, mesh)
        rec = dryrun.count_sharded(cfg, "decode_32k", mesh.shape)
        assert rec["collectives"]["total"] > 0
        assert "collective_note" not in rec
    # one rank runs every family
    make_serve_step(get_config("xlstm_350m").smoke(),
                    mesh_lib.abstract_mesh({"data": 1, "model": 1}))
    # a model cut for another mesh, or none, is refused; so is a cache
    # that is not the mesh's shards
    cfg = get_config("qwen2_1_5b").smoke()
    model = PT.Transformer(cfg, device="meta", dtype=torch.float32)
    with pytest.raises(ValueError, match="sharded for None"):
        make_prefill_step(cfg, max_len=8, mesh=mesh)(model, {"tokens": []})
    local = shard_params(model, mesh)
    cache = PT.init_cache(cfg, 2, 8, device="meta")
    with pytest.raises(ValueError, match="shard_cache"):
        make_serve_step(cfg, mesh)(local, cache, torch.zeros(2),
                                   torch.zeros(2))


def _ragged(gen, b, s, hk, d, lens, dtype=torch.float32):
    q = torch.randn((b, 4 * hk, d), generator=gen, dtype=dtype)
    k = torch.randn((b, s, hk, d), generator=gen, dtype=dtype)
    v = torch.randn((b, s, hk, d), generator=gen, dtype=dtype)
    return q, k, v, torch.tensor(lens, dtype=torch.int32)


@pytest.mark.parametrize("parts", [2, 4])
def test_split_rows_combine_to_the_whole(parts):
    """Row ranges of one cache, each through the plain version with its
    log-sum-exp (a range past a sequence's length gets a local length of
    0, zeros and -inf), merged by ``combine_partials``."""
    gen = torch.Generator().manual_seed(parts)
    s = 64
    lens = [0, 1, 15, 16, 17, 40, 63, 64]
    q, k, v, lengths = _ragged(gen, len(lens), s, 2, 32, lens)
    o_w, lse_w = decode_attention_ref(q, k, v, lengths, return_lse=True)
    assert torch.equal(o_w, decode_attention_ref(q, k, v, lengths))
    assert torch.isinf(lse_w[0]).all() and (lse_w[0] < 0).all()
    assert torch.isfinite(lse_w[1:]).all()
    rows = s // parts
    o_parts, lse_parts = [], []
    for r in range(parts):
        local = (lengths - r * rows).clamp(0, rows).to(torch.int32)
        o, lse = decode_attention_ref(q, k[:, r * rows:(r + 1) * rows],
                                      v[:, r * rows:(r + 1) * rows], local,
                                      return_lse=True)
        o_parts.append(o)
        lse_parts.append(lse)
    got = combine_partials(torch.stack(o_parts), torch.stack(lse_parts))
    assert not torch.isnan(got).any()
    assert float((got - o_w).abs().max()) < TOL_SPLIT
    # the whole cache's log-sum-exp is the ranges' log-sum-exp
    lse = torch.logsumexp(torch.stack(lse_parts), dim=0)
    assert torch.equal(torch.isinf(lse), torch.isinf(lse_w))
    assert float((lse - lse_w)[1:].abs().max()) < TOL_SPLIT


def test_decode_lse_on_meta_and_cpu():
    """The wrapper's lse option on the CPU is the plain version's, in
    fp32 whatever the input's type; on meta it counts the fp32 output
    and the lse written."""
    gen = torch.Generator().manual_seed(0)
    q, k, v, lengths = _ragged(gen, 3, 16, 1, 8, [0, 5, 16],
                               dtype=torch.bfloat16)
    o, lse = da_ops.decode_attention(q, k, v, lengths, return_lse=True)
    assert o.dtype == lse.dtype == torch.float32 and lse.shape == (3, 4)
    assert torch.equal(o.to(torch.bfloat16),
                       da_ops.decode_attention(q, k, v, lengths))
    from repro_torch.kernels.cost import KernelCount
    with KernelCount() as kc:
        o, lse = da_ops.decode_attention(q.to("meta"), k.to("meta"),
                                         v.to("meta"), lengths.to("meta"),
                                         return_lse=True)
    assert o.device.type == "meta" and o.dtype == torch.float32
    plain = da_ops.decode_attention_cost(3, 4, 1, 8, live_rows=48)
    assert kc.bytes == plain.bytes - 2 * 3 * 4 * 8 + 4 * 3 * 4 * 8 + 4 * 3 * 4
    assert kc.flops == plain.flops
