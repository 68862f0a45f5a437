"""Package rules of the PyTorch port.

* every ``repro_torch`` module imports without loading ``jax`` or any
  module of ``repro``;
* entry points (the serve and train CLIs, the HTTP server's CLI, the
  model and the ``Engine``) default to ``"cuda"`` and raise without a
  card unless the caller passes ``device="cpu"``;
* the ``EngineConfig`` fields run by the slices so far are accepted and
  build an engine (``step_delay_s``, the endpoint tier's handicap,
  leaves the tokens as they are), and every model family, MoE, xLSTM,
  the frontends and the encoder-decoder among them, builds and serves;
* ``chip_smoke.py`` fails, printing no result, without a card or outside
  a checkout.
"""
from __future__ import annotations

import json
import os
import pkgutil
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.launch import serve, train
from repro_torch.models import transformer as PT
from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.runtime import server
from repro_torch.runtime.engine import Engine, EngineConfig

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(name="pkg", arch_type="dense", n_layers=2, d_model=32,
            n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=64,
            dtype="float32", param_dtype="float32")


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_every_module_imports_without_jax_or_repro():
    mods = _modules()
    assert len(mods) >= 20
    assert {"repro_torch.runtime.observability", "repro_torch.runtime.server",
            "repro_torch.runtime.scheduler.prefix_pool",
            "repro_torch.serving", "repro_torch.runtime.serving",
            "repro_torch.models.cnn", "repro_torch.runtime.resilience",
            "repro_torch.runtime.escalation_queue",
            "repro_torch.runtime.escalation", "repro_torch.configs.shapes",
            "repro_torch.launch.dryrun", "repro_torch.launch.mesh",
            "repro_torch.launch.roofline", "repro_torch.sharding",
            "repro_torch.sharding.rules", "repro_torch.kernels.cost"} | {
        f"repro_torch.core.{m}" for m in (
            "graph", "analyzer", "mapping", "calibration", "synthesis",
            "simulator", "explorer", "clocks")} <= set(mods)
    code = ("import importlib, json, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "print(json.dumps(sorted(k for k in sys.modules if k == 'jax' or "
            "k.startswith('jax.') or k == 'repro' or "
            "k.startswith('repro.'))))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ,
                              "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")


def test_entry_points_default_to_cuda_and_raise_without_it():
    _no_cuda()
    cfg = ModelConfig(**TINY)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PT.Transformer(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PT.init_params(cfg)
    model = PT.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(cfg, model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "qwen2_1_5b"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        server.main(["--arch", "qwen2_1_5b", "--probe"])
    Engine(cfg, model, device="cpu")        # the explicit opt-in works


@pytest.mark.parametrize("name", ["torch_quickstart", "torch_train_small"])
def test_examples_default_to_cuda_and_raise_without_it(name):
    """The last two examples' entry points run on the card unless asked
    for the CPU (their CPU runs: tests/test_torch_partitioned.py)."""
    _no_cuda()
    import runpy
    main = runpy.run_path(str(ROOT / "examples" / f"{name}.py"),
                          run_name="example")["main"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main([])


def test_step_delay_is_accepted_and_leaves_tokens_unchanged():
    """``step_delay_s`` (the endpoint tier's handicap) sleeps after every
    non-idle scheduler step: the same requests give the same tokens, and
    the run takes at least steps x delay longer on the wall clock."""
    from repro_torch.runtime.scheduler import Request
    cfg = ModelConfig(**TINY)
    model = PT.init_params(cfg, device="cpu")
    prompts = np.random.RandomState(0).randint(0, 64, (3, 5)).astype(np.int32)
    runs = {}
    for delay in (0.0, 0.01):
        c = EngineConfig(max_len=32, max_slots=2, step_delay_s=delay)
        assert c.step_delay_s == delay
        eng = Engine(cfg, model, c, device="cpu")
        assert eng.scheduler.sched.step_delay_s == delay
        t0 = time.perf_counter()
        comps = eng.generate([Request(i, p, max_new_tokens=4)
                              for i, p in enumerate(prompts)])
        runs[delay] = ([c.tokens for c in comps], eng.stats()["steps"],
                       time.perf_counter() - t0)
    (toks0, steps, wall0), (toks1, steps1, wall1) = runs[0.0], runs[0.01]
    assert toks1 == toks0 and steps1 == steps > 0
    assert wall1 >= steps * 0.01


# each field with what it needs beside it (prefix sharing and the victim
# cache the paged pool, two decode stages two decode units)
NEEDS = {"prefix_cache": dict(kv_layout="paged"),
         "victim_cache": dict(kv_layout="paged", prefix_cache=True),
         "prefix_cache_tenants": dict(kv_layout="paged", prefix_cache=True),
         "decode_stages": dict(units=2)}


@pytest.mark.parametrize("field,value", [
    ("kv_layout", "paged"), ("prefill_chunk", 4), ("prefix_cache", True),
    ("victim_cache", True), ("prefix_cache_tenants", {"a": 1 << 20}),
    ("enforce_deadlines", True), ("decode_stages", 2),
    ("observability", True)])
def test_this_slice_fields_are_accepted(field, value):
    """The paged layout, chunked prefill, prefix sharing with its victim
    cache and tenant quotas, deadline shedding, the stage-partitioned
    decode and observability run: ``EngineConfig`` takes each, and an
    engine builds on it."""
    c = EngineConfig(max_len=32, **{field: value}, **NEEDS.get(field, {}))
    assert getattr(c, field) == value
    cfg = ModelConfig(**TINY)
    eng = Engine(cfg, PT.init_params(cfg, device="cpu"), c, device="cpu")
    assert eng.scheduler.layout.paged == (c.kv_layout == "paged")
    assert eng.scheduler.sched.decode_stages == c.decode_stages
    assert (eng.scheduler.obs is not None) == c.observability


def test_train_entry_points_default_to_cuda_and_raise_without_it():
    _no_cuda()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "recurrentgemma_9b", "--smoke"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.run(ModelConfig(**TINY), steps=1, batch=2, seq=8)


@pytest.mark.parametrize("change", [
    dict(moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=16)),
    dict(layer_pattern=("mlstm", "slstm"), d_ff=0),
    dict(arch_type="audio", frontend="audio", frontend_dim=8),
    dict(arch_type="audio", n_encoder_layers=2, frontend="audio",
         frontend_dim=8),
    dict(arch_type="vlm", frontend="vision", frontend_dim=8,
         frontend_tokens=3)])
def test_this_slice_families_are_built_and_served(change):
    """MoE and xLSTM's blocks (tests/test_torch_families.py holds them
    to the reference), an audio frontend's projector, an encoder-decoder
    and a vision frontend (tests/test_torch_encdec.py and
    tests/test_torch_vlm.py): the model builds, the serving check passes
    and an ``Engine`` serves a request, with the stub ``embeds`` the
    serve CLI draws for a frontend config."""
    from repro_torch.runtime.scheduler import Request
    cfg = ModelConfig(**{**TINY, **change})
    PT.check_servable(cfg)
    model = PT.init_params(cfg, device="cpu")
    eng = Engine(cfg, model, EngineConfig(max_len=16, max_slots=2),
                 device="cpu")
    embeds = serve.stub_embeds(cfg, np.random.RandomState(0), 5)
    assert (embeds is None) == (cfg.frontend is None)
    out = eng.generate([Request(0, np.arange(5, dtype=np.int32),
                                max_new_tokens=3, embeds=embeds)])
    assert len(out[0].tokens) == 3


def test_chip_smoke_fails_without_card_or_checkout(tmp_path):
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    runs = [(alone, tmp_path)]
    if not torch.cuda.is_available():
        runs.append((ROOT / "chip_smoke.py", ROOT))
    for script, cwd in runs:
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
