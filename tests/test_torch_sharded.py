"""The sharded training step of the port on CPU ranks over gloo, fp32.

One world of 4 ranks (separate processes started once for the module,
joined through a ``FileStore`` under the test's temporary directory, so
no port is chosen) runs the meshes 2x2, 1x4 and 4x1 in turn: 2 steps
of ``make_train_step(cfg, opt, mesh)`` on ``recurrentgemma_9b.smoke()``
(rglru + attn_local, 4 query heads over 1 kv head, d_model 256), on
``qwen2_1_5b.smoke()`` (attn x 2, 4 over 2 kv heads, qkv biases) and on
the MoE smoke configs of qwen2-moe and qwen3-moe (4 routed experts
top-2, qwen2-moe's with a shared expert; the experts go by expert over
"model" on every mesh), batch 4 x 32 from ``lm_batches``; and on one
mesh each (``ONE_MESH``), xlstm-350m's (an mLSTM and an sLSTM block of
4 heads, by heads over "model" on 2x2; and a 2-head variant, ``smoke``'s
``xlstm_350m:h2``, whose blocks run whole on 1x4), seamless-m4t-medium's
(2 encoder + 2 decoder layers, a source of one frame a token, on 2x2)
and llava-next-mistral-7b's (8 patch rows ahead of 24 tokens, on 2x2),
the frontends' ``embeds`` N(0, 1) from a numpy seed
(``frontend_embeds``). The weights
are the reference's flat parameter dict drawn from a numpy seed
(``weights.seeded_flat``: every leaf N(0, 0.05^2), norms and Lambda
among them), carried in by ``from_jax_params`` and cut by
``shard_params``; the reference's step takes the same dict. Held
against:

* the loss, ce, aux and gradient norm of each step to 1e-5 relative;
* every step-1 gradient leaf (gathered by ``gather_params(grad=True)``)
  to 1e-5 of the leaf's largest magnitude [measured 2.2e-6];
* every master after the second AdamW update (gathered by
  ``gather_params``) to 2.5e-4 absolute, a quarter of lr = 1e-3
  [measured: 8.8e-5 against the port's unsharded step, 1.2e-4 against
  the reference's, whose own unsharded masters part from the port's by
  6.1e-5]: AdamW moves an element by lr x m / (sqrt(v) + eps), so where
  the gradient is of the order of eps = 1e-8, or is a sum of larger
  terms that cancel (the key bias's), the rounding of a reduction in
  another order moves the update by a fraction of lr
  (``test_torch_train.py`` holds the port's masters against the
  reference's at lr / 10 for this reason); 1e-5 of the leaf's largest
  magnitude holds for all but 7 to 156 of a config's ~0.4 M elements;

against

* the port's unsharded ``make_train_step`` on the same masters and
  batches;
* the reference's ``make_train_step`` with ``mesh=None`` (the dense
  and hybrid configs) and, for recurrentgemma, qwen2-moe and the
  xLSTM, encoder-decoder and vision configs, on a 1x1 mesh of
  ``AxisType.Auto`` axes built here (the reference's own
  ``make_debug_mesh`` makes Explicit axes, which its step refuses),
  each compiled once at XLA's lowest optimisation level
  (``fast_jit``);

and, on each mesh: ``shard_params`` then ``gather_params`` is exact, a
sharded checkpoint equals the unsharded ``.npz``, and the collective
bytes that the comm counters recorded equal, kind by kind, the dry run's
abstract count of the same step (rank 0's program on the meta device).
A world of one rank gives the unsharded step bit for bit (with
``torch.use_deterministic_algorithms``: the CPU's threaded embedding
backward adds in a varying order). Every family builds over a mesh,
and a mesh larger than the cards present raises. ``launch/train.py
--data 2 --model 1 --device cpu`` runs under ``torch.distributed.run``,
and an MoE config and the encoder-decoder with ``--data 2 --model 2``.
``tests/test_torch_sharded_moe.py`` holds both dispatches, the
per-expert tensor-parallel fallback and capacity drops.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.shapes import InputShape, input_specs
from repro_torch.launch import dryrun, mesh as mesh_lib, train
from repro_torch.models import transformer as PT
from repro_torch.runtime import checkpoint as pckpt
from repro_torch.runtime import data as pdata
from repro_torch.runtime import optim as poptim
from repro_torch.runtime.trainstep import make_train_step
from repro_torch.sharding.rules import (gather_params, shard_params)
from repro_torch.weights import from_jax_params, seeded_flat, to_flat

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("recurrentgemma_9b", "qwen2_1_5b", "qwen2_moe_a2_7b",
         "qwen3_moe_235b_a22b", "xlstm_350m", "xlstm_350m:h2",
         "seamless_m4t_medium", "llava_next_mistral_7b")
MESHES = ((2, 2), (1, 4), (4, 1))
# the later families on one mesh each: the xLSTM's 4 heads by heads on
# 2x2, its 2-head variant whole on 1x4, the encoder-decoder and the
# vision frontend on 2x2; the others on every mesh
ONE_MESH = {"xlstm_350m": (2, 2), "xlstm_350m:h2": (1, 4),
            "seamless_m4t_medium": (2, 2), "llava_next_mistral_7b": (2, 2)}
WORLD = 4
BATCH, SEQ, STEPS = 4, 32, 2
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=STEPS)
TOL = 1e-5
TOL_MASTERS = OPT["lr"] / 4
METRICS = ("loss", "ce", "aux", "grad_norm")
JAX_RUNS = (("recurrentgemma_9b", "none"), ("recurrentgemma_9b", "1x1"),
            ("qwen2_1_5b", "none"), ("qwen2_moe_a2_7b", "1x1"),
            ("xlstm_350m", "1x1"), ("seamless_m4t_medium", "1x1"),
            ("llava_next_mistral_7b", "1x1"))

def smoke(arch):
    """``arch``'s smoke config; ``<arch>:h<N>`` gives it N heads (an
    xLSTM whose heads "model" does not divide runs each block whole)."""
    name, _, heads = arch.partition(":h")
    cfg = get_config(name).smoke()
    if not heads:
        return cfg
    h = int(heads)
    return replace(cfg, n_heads=h, n_kv_heads=h, head_dim=cfg.d_model // h)


def archs_on(mesh, archs=ARCHS):
    """The configs of ``archs`` that run on ``mesh`` (``ONE_MESH``)."""
    return [a for a in archs if ONE_MESH.get(a, tuple(mesh)) == tuple(mesh)]


def mesh_id(mesh):
    return f"{mesh[0]}x{mesh[1]}"


CELLS = [pytest.param(m, a, id=f"{mesh_id(m)}-{a}")
         for m in MESHES for a in archs_on(m)]


# one rank of the world: every mesh, every config, the step and its
# counters, the round trip and the checkpoint; rank 0 writes the results
RANK = textwrap.dedent('''
    import json, sys
    import numpy as np, torch
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.runtime import checkpoint, optim
    from repro_torch.runtime.trainstep import make_train_step
    from repro_torch.sharding.rules import gather_params, shard_params
    from repro_torch.weights import from_jax_params, seeded_flat, to_flat
    from test_torch_sharded import smoke

    rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    spec = json.load(open(f"{tmp}/spec.json"))
    torch.set_num_threads(1)
    mesh_lib.init_world(rank, world, f"{tmp}/store", device="cpu")
    oc = optim.AdamWConfig(**spec["opt"])
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
            back = to_flat(gather_params(local))
            exact = all(np.array_equal(back[k], v) for k, v in flat.items())
            local.requires_grad_(True)
            opt = optim.init(local)
            step = make_train_step(cfg, oc, mesh)
            tag = f"{data}x{model}/{arch}"
            for i in range(spec["steps"]):
                batch = {k.split("|")[1]: inp[k] for k in inp.files
                         if k.startswith(f"b{i}|")}
                mesh.counts.reset()
                local, opt, m = step(local, opt, batch)
                for k, v in m.items():
                    out[f"{tag}/m{i}/{k}"] = float(v)
                out[f"{tag}/counts{i}"] = mesh.counts.record()
                if i == 0:
                    grads = to_flat(gather_params(local, grad=True))
                    if rank == 0:
                        np.savez(f"{tmp}/grads_{data}x{model}_{arch}.npz",
                                 **grads)
            flat_after = to_flat(gather_params(local))
            checkpoint.save(f"{tmp}/ckpt_{data}x{model}_{arch}", local)
            if rank == 0:
                np.savez(f"{tmp}/after_{data}x{model}_{arch}.npz",
                         **flat_after)
            out[f"{tag}/exact"] = exact
    torch.distributed.destroy_process_group()
    if rank == 0:
        json.dump(out, open(f"{tmp}/out.json", "w"))
''')


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                               else []))
    env["OMP_NUM_THREADS"] = "1"
    return env


def frontend_embeds(cfg, b, s, seed):
    """A frontend config's ``embeds`` for ``b`` prompts of ``s``
    positions as the dry run's ``input_specs`` shapes them (a vision
    frontend's rows among the ``s``, an audio source of one frame a
    token), N(0, 1) from a numpy seed; None without a frontend."""
    spec = input_specs(cfg, InputShape("embeds", s, b, "prefill")).get(
        "embeds")
    return None if spec is None else np.random.RandomState(
        seed).standard_normal(tuple(spec.shape)).astype(np.float32)


def with_embeds(cfg, batch, seed):
    """A token batch with ``frontend_embeds``: a vision frontend's rows
    take the place of as many tokens (their labels -1)."""
    b, s = batch["tokens"].shape
    embeds = frontend_embeds(cfg, b, s, seed)
    if embeds is None:
        return batch
    f = PT.frontend_rows(cfg, embeds)
    return {"tokens": batch["tokens"][:, :s - f],
            "labels": np.concatenate([np.full((b, f), -1, np.int32),
                                      batch["labels"][:, :s - f]], 1),
            "embeds": embeds}


def ref_params(arch):
    """The reference's flat parameter dict of ``arch``'s smoke config,
    drawn from seed 0, and the two batches."""
    cfg = smoke(arch)
    flat = seeded_flat(cfg, 0)
    gen = pdata.lm_batches(BATCH, SEQ, cfg.vocab_size, seed=0)
    return flat, [with_embeds(cfg, next(gen), i) for i in range(STEPS)]


@pytest.fixture(scope="module")
def inputs():
    return {arch: ref_params(arch) for arch in ARCHS}


@pytest.fixture(scope="module")
def world(inputs, tmp_path_factory):
    """Run the 4-rank world once, and the unsharded and reference steps
    here while it runs: the world's results by mesh and config, the
    port's unsharded step's and the reference's."""
    tmp = tmp_path_factory.mktemp("world")
    for arch, (flat, batches) in inputs.items():
        arrays = {f"p|{k}": v for k, v in flat.items()}
        for i, b in enumerate(batches):
            arrays.update({f"b{i}|{k}": v for k, v in b.items()})
        np.savez(tmp / f"{arch}.npz", **arrays)
    (tmp / "spec.json").write_text(json.dumps(
        {"cells": [m + (archs_on(m),) for m in MESHES], "opt": OPT,
         "steps": STEPS}))
    procs = [subprocess.Popen([sys.executable, "-c", RANK, str(r),
                               str(WORLD), str(tmp)], env=_env(),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    logs = []
    try:
        here = {"unsharded": _unsharded_all(inputs),
                "jax": _jax_results(inputs)}
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]
    out = json.loads((tmp / "out.json").read_text())
    return {"out": out, "tmp": tmp, **here}


def _unsharded(cfg, flat, batches, mesh=None):
    """The port's step, unsharded (or over ``mesh``), from ``flat``:
    (metrics per step, the masters after the last step)."""
    full = from_jax_params(flat, cfg, device="cpu", dtype=torch.float32)
    model = full if mesh is None else shard_params(full, mesh)
    model.requires_grad_(True)
    opt = poptim.init(model)
    step = make_train_step(cfg, poptim.AdamWConfig(**OPT), mesh)
    hist = []
    for i, b in enumerate(batches):
        model, opt, m = step(model, opt, b)
        hist.append({k: v.clone() for k, v in m.items()})
        if i == 0:
            grads = to_flat(gather_params(model, grad=True),
                            grad=mesh is None)
    return hist, to_flat(gather_params(model)), grads


def _unsharded_all(inputs):
    # deterministic: the CPU's threaded embedding backward otherwise adds
    # in a varying order
    det = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        return {arch: _unsharded(smoke(arch), *inputs[arch])
                for arch in ARCHS}
    finally:
        torch.use_deterministic_algorithms(det)


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def _leaf_err(got, want):
    """Largest |got - want| over each leaf's largest |want|."""
    return max(float(np.max(np.abs(got[k] - w)) / max(np.max(np.abs(w)),
                                                      1e-30))
               for k, w in want.items())


def _abs_err(got, want):
    return max(float(np.max(np.abs(got[k] - w))) for k, w in want.items())


@pytest.mark.parametrize("mesh,arch", CELLS)
def test_sharded_step_matches_unsharded(world, unsharded, mesh, arch):
    out, tmp = world["out"], world["tmp"]
    tag = f"{mesh[0]}x{mesh[1]}/{arch}"
    hist, after, grads = unsharded[arch]
    for i, m in enumerate(hist):
        for k in METRICS:
            assert _rel(out[f"{tag}/m{i}/{k}"], float(m[k])) < TOL, (i, k)
    got = dict(np.load(tmp / f"grads_{mesh[0]}x{mesh[1]}_{arch}.npz"))
    assert set(got) == set(grads)
    assert _leaf_err(got, grads) < TOL
    got = dict(np.load(tmp / f"after_{mesh[0]}x{mesh[1]}_{arch}.npz"))
    assert set(got) == set(after)
    assert _abs_err(got, after) < TOL_MASTERS
    # the step went through the collectives: ZeRO-3's gathers and
    # reduce-scatters over "data", the sums over "model" and the norm's
    counts = out[f"{tag}/counts0"]
    assert counts["total"] > 0 and counts["all-reduce"] > 0
    assert (counts["by_axes"].get("data", 0) > 0) == (mesh[0] > 1)
    assert (counts["by_axes"].get("model", 0) > 0) == (mesh[1] > 1)


@pytest.fixture(scope="module")
def unsharded(world):
    return world["unsharded"]


@pytest.fixture(scope="module")
def jax_results(world):
    return world["jax"]


def _jax_results(inputs):
    """The reference's step, without a mesh and on a 1x1 mesh of Auto
    axes: per config, {mesh: (metrics per step, masters after)}."""
    import jax
    from jax.sharding import AxisType

    from repro.configs import get_config as ref_get_config
    from repro.runtime import optim as joptim
    from repro.runtime.trainstep import make_train_step as jstep
    from test_torch_families import fast_jit
    from test_torch_golden import flat_params, unflatten
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    out = {}
    for arch, name in JAX_RUNS:
        cfg = ref_get_config(arch).smoke()
        flat, batches = inputs[arch]
        for m in [mesh if name == "1x1" else None]:
            step = fast_jit(jstep(cfg, joptim.AdamWConfig(**OPT), m))
            params = unflatten(flat)
            opt = joptim.init(params)
            hist = []
            for b in batches:
                params, opt, met = step(params, opt, b)
                hist.append({k: float(v) for k, v in met.items()})
            out[(arch, name)] = (hist, flat_params(params))
    return out


@pytest.mark.parametrize("arch,ref_mesh", JAX_RUNS)
def test_sharded_step_matches_jax(world, jax_results, ref_mesh, arch):
    hist, after = jax_results[(arch, ref_mesh)]
    for mesh in (m for m in MESHES if arch in archs_on(m)):
        tag = f"{mesh[0]}x{mesh[1]}/{arch}"
        for i, m in enumerate(hist):
            for k in METRICS:
                assert _rel(world["out"][f"{tag}/m{i}/{k}"], m[k]) < TOL, \
                    (mesh, i, k)
        got = dict(np.load(world["tmp"]
                           / f"after_{mesh[0]}x{mesh[1]}_{arch}.npz"))
        assert _abs_err(got, after) < TOL_MASTERS, mesh


def test_one_rank_world_is_bit_for_bit(inputs, unsharded, tmp_path):
    mesh_lib.init_world(0, 1, str(tmp_path / "store"), device="cpu")
    det = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        mesh = mesh_lib.make_debug_mesh(1, 1, device="cpu")
        for arch in ARCHS:
            cfg = smoke(arch)
            want = _unsharded(cfg, *inputs[arch])
            got = _unsharded(cfg, *inputs[arch], mesh=mesh)
            for a, b in zip(got[0], want[0]):
                assert all(torch.equal(a[k], b[k]) for k in b)
            for g, w in zip(got[1:], want[1:]):
                assert all(np.array_equal(g[k], v) for k, v in w.items())
            assert mesh.counts.total == 0 and not mesh.counts.calls
    finally:
        torch.use_deterministic_algorithms(det)
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_round_trip_and_checkpoint(world, unsharded, inputs, mesh,
                                   tmp_path):
    tag = f"{mesh[0]}x{mesh[1]}"
    for arch in archs_on(mesh):
        assert world["out"][f"{tag}/{arch}/exact"]
        got = pckpt.load_flat(str(world["tmp"] / f"ckpt_{tag}_{arch}"))
        want = dict(np.load(world["tmp"] / f"after_{tag}_{arch}.npz"))
        assert set(got) == set(want)
        assert all(np.array_equal(got[k], v) for k, v in want.items())
        # the unsharded model saves the same keys and shapes
        path = str(tmp_path / arch)
        full = from_jax_params(inputs[arch][0], smoke(arch),
                               device="cpu", dtype=torch.float32)
        pckpt.save(path, full)
        plain = pckpt.load_flat(path)
        assert {k: v.shape for k, v in plain.items()} == {
            k: v.shape for k, v in got.items()}


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_dry_run_counts_equal_the_gloo_run(world, mesh):
    for arch in archs_on(mesh):
        cfg = smoke(arch)
        rec = dryrun.count_sharded(cfg, dryrun.InputShape(
            "t", SEQ, BATCH, "train"), {"data": mesh[0], "model": mesh[1]})
        gloo = world["out"][f"{mesh[0]}x{mesh[1]}/{arch}/counts0"]
        assert rec["collectives"] == gloo, arch


def test_refusals():
    mesh = mesh_lib.abstract_mesh({"data": 2, "model": 2})
    # every family builds over the mesh: MoE, xLSTM, the encoder-decoder
    # and the vision frontend
    for arch in ("qwen2_moe_a2_7b", "qwen3_moe_235b_a22b", "xlstm_350m",
                 "seamless_m4t_medium", "llava_next_mistral_7b"):
        make_train_step(smoke(arch), poptim.AdamWConfig(), mesh)
    # one rank runs every family
    make_train_step(get_config("xlstm_350m").smoke(), poptim.AdamWConfig(),
                    mesh_lib.abstract_mesh({"data": 1, "model": 1}))
    if torch.cuda.device_count() < 4:
        with pytest.raises(RuntimeError, match="need 4 CUDA devices"):
            mesh_lib.make_debug_mesh(2, 2)
    with pytest.raises(RuntimeError, match="world of 4 ranks"):
        mesh_lib.make_debug_mesh(2, 2, device="cpu")
    # a model cut for another mesh, or none, is refused by the step
    cfg = get_config("qwen2_1_5b").smoke()
    step = make_train_step(cfg, poptim.AdamWConfig(), mesh)
    model = PT.Transformer(cfg, device="meta", dtype=torch.float32)
    model.requires_grad_(True)
    with pytest.raises(ValueError, match="sharded for None"):
        step(model, {}, {})


def test_train_cli_under_torchrun(tmp_path):
    _cli_under_torchrun(tmp_path, "qwen2_1_5b", 2, 1)


def test_moe_train_cli_under_torchrun(tmp_path):
    """An MoE config over a 2x2 mesh: its 4 experts by expert."""
    _cli_under_torchrun(tmp_path, "qwen3_moe_235b_a22b", 2, 2)


def test_encdec_train_cli_under_torchrun(tmp_path):
    """The encoder-decoder over a 2x2 mesh, with the CLI's stub source."""
    _cli_under_torchrun(tmp_path, "seamless_m4t_medium", 2, 2)


def _cli_under_torchrun(tmp_path, arch, data, model):
    args = ["--arch", arch, "--smoke", "--device", "cpu",
            "--steps", "2", "--batch", "4", "--seq", "16", "--log-every",
            "1"]
    env = _env()
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(data * model), "-m",
         "repro_torch.launch.train", *args, "--data", str(data), "--model",
         str(model)], env=env, cwd=tmp_path,
        capture_output=True, text=True, timeout=180)
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-2000:]
    steps = [ln.split()[1:6] for ln in run.stdout.splitlines()
             if ln.startswith("step ")]
    assert len(steps) == 2, run.stdout
    want = [[str(i), "loss", f"{m['loss']:.4f}", "gnorm",
             f"{m['grad_norm']:.3f}"]
            for i, m in enumerate(train.main(args)["metrics"])]
    # loss and gradient norm as the reference prints them (4 and 3
    # digits) equal the one-process run's
    assert steps == want
