"""The port's Edge-PRUNE LLM path against the reference's on the CPU: the
actor-graph export (``to_actor_graph``), ``PartitionedServeEngine``
(``infer``, ``infer_pipelined``, ``comm_bytes``), the serve CLI's
``--partition``, and the deprecated ``ServeEngine`` shim.

Weights are the reference's, carried by ``weights.from_jax_params``; the
configs use a vocabulary that needs no padding, since the actor graph's
Head (as the reference's) does not mask padded logits. Limits: the
partitioned logits within 1e-4 of the JAX ``PartitionedServeEngine``'s
(fp32; two frameworks' products and softmax summed in other orders) and
equal to the port's own monolithic ``forward`` bit for bit (the same
code on the same tensors); boundary bytes, costs and modeled schedules
exactly equal.
"""
from __future__ import annotations

import dataclasses
import warnings
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

import repro.configs as RCFG
from repro.core import Mapping as RefMapping
from repro.core import PlatformModel as RefPlatformModel
from repro.core import synthesize as ref_synthesize
from repro.core import paper_platform as ref_paper_platform
from repro.models import transformer as RT
from repro.models.config import ModelConfig as RefConfig
from repro.runtime.serving import PartitionedServeEngine as RefPSE
from repro_torch import configs as TCFG
from repro_torch.core import (Mapping, PlatformModel, paper_platform,
                              synthesize)
from repro_torch.launch import serve
from repro_torch.models import transformer as PT
from repro_torch.models.config import ModelConfig
from repro_torch.runtime.engine import Engine, EngineConfig
from repro_torch.runtime.policies import BatchAdmission, FifoAdmission
from repro_torch.runtime.scheduler import Request
from repro_torch.runtime.serving import PartitionedServeEngine, ServeEngine
from repro_torch.weights import from_jax_params

TOL = 1e-4
SEQ = 12
TINY = dict(name="tiny", arch_type="dense", n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=128,
            dtype="float32", param_dtype="float32", attn_chunk=16,
            remat=False)


def _hybrid(pkg_configs):
    """RecurrentGemma's smoke variant (rglru + attn_local) in fp32 with a
    128-entry vocabulary."""
    base = pkg_configs.get_config("recurrentgemma_9b").smoke()
    return replace(base, vocab_size=128, dtype="float32",
                   param_dtype="float32", remat=False)


CONFIGS = {"tiny": (RefConfig(**TINY), ModelConfig(**TINY)),
           "hybrid": (_hybrid(RCFG), _hybrid(TCFG))}


@pytest.fixture(scope="module", params=list(CONFIGS))
def models(request):
    rcfg, tcfg = CONFIGS[request.param]
    assert tcfg.padded_vocab_size == tcfg.vocab_size
    params = RT.init_params(rcfg, jax.random.PRNGKey(0))
    model = from_jax_params(jax.device_get(params), tcfg, device="cpu")
    return rcfg, params, tcfg, model


def _names(cfg, group_size):
    return list(PT.to_actor_graph(cfg, batch=1, seq=SEQ,
                                  group_size=group_size).actors)


def _split(names, pp):
    return {n: ("endpoint" if i < pp else "server")
            for i, n in enumerate(names)}


def _tokens(cfg, seed=0, n=1):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, cfg.vocab_size, (1, SEQ)).astype(np.int32)
            for _ in range(n)]


@pytest.mark.parametrize("group_size", [1, 2])
def test_partitioned_logits_match_jax_and_monolithic(models, group_size):
    """At every partition point: the port's partitioned logits equal its
    monolithic ``forward``'s bit for bit and lie within 1e-4 of the JAX
    engine's at a cut through the layers (the reference's partitioned
    logits are one computation whatever the cut); the boundary bytes
    equal the reference graph's at the same cut."""
    rcfg, params, tcfg, model = models
    (tokens,) = _tokens(tcfg)
    with torch.no_grad():
        mono, _ = PT.forward(model, tcfg, {"tokens": torch.from_numpy(tokens)},
                             train=False)
    names = _names(tcfg, group_size)
    ref_g = RT.to_actor_graph(rcfg, None, batch=1, seq=SEQ,
                              group_size=group_size)
    want = np.asarray(RefPSE(rcfg, params, RefMapping("m", _split(names, 3)),
                             batch=1, seq=SEQ, group_size=group_size)
                      .infer(tokens))
    for pp in range(1, len(names) + 1):
        a = _split(names, pp)
        pse = PartitionedServeEngine(tcfg, model, Mapping("m", a), batch=1,
                                     seq=SEQ, group_size=group_size)
        got = pse.infer(tokens)
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL,
                                   err_msg=f"pp={pp}")
        assert torch.equal(got, mono), f"pp={pp}"
        assert pse.comm_bytes() == ref_synthesize(
            ref_g, RefMapping("m", a)).comm_bytes_per_iteration(), f"pp={pp}"


def test_pipelined_frames_and_schedule_match_jax(models):
    rcfg, params, tcfg, model = models
    names = _names(tcfg, 1)
    a = _split(names, 3)
    ref = RefPSE(rcfg, params, RefMapping("m", a), batch=1, seq=SEQ)
    pse = PartitionedServeEngine(tcfg, model, Mapping("m", a), batch=1,
                                 seq=SEQ)
    frames = _tokens(tcfg, seed=1, n=3)
    arrivals = [0.0, 1e-3, 2e-3]
    got, sched = pse.infer_pipelined(
        frames, platform=PlatformModel(paper_platform("N2", "wifi")),
        arrivals=arrivals)
    want, rsched = ref.infer_pipelined(
        frames, platform=RefPlatformModel(ref_paper_platform("N2", "wifi")),
        arrivals=arrivals)
    for f, g_, w in zip(frames, got, want):
        assert torch.equal(g_, pse.infer(f))
        np.testing.assert_allclose(g_.numpy(), np.asarray(w), atol=TOL,
                                   rtol=TOL)
    assert [dataclasses.astuple(e) for e in sched.entries] == \
        [dataclasses.astuple(e) for e in rsched.entries]
    assert (sched.makespan_s, sched.sequential_s, sched.frame_done_s,
            sched.unit_busy_s) == (rsched.makespan_s, rsched.sequential_s,
                                   rsched.frame_done_s, rsched.unit_busy_s)


def _graph_rows(g):
    return [(a.name, a.actor_type.name, a.cost_flops, a.meta,
             [(p.name, tuple(p.token_shape), p.token_dtype, p.token_bytes)
              for p in a.in_ports + a.out_ports])
            for a in g.actors.values()]


@pytest.mark.parametrize("arch,seq,group_size", [
    ("qwen2_1_5b", 512, 1), ("qwen2_1_5b", 64, 4),
    ("recurrentgemma_9b", 4096, 1), ("recurrentgemma_9b", 256, 3)])
def test_full_size_export_matches_jax(arch, seq, group_size):
    """Costs only (no weights): actor names, token shapes, dtypes and
    bytes, ``cost_flops`` and the layer groups exactly as the
    reference's, and the boundary bytes of the phase-7 cuts."""
    kw = dict(batch=1, seq=seq, group_size=group_size)
    rcfg, tcfg = RCFG.get_config(arch), TCFG.get_config(arch)
    ref_g = RT.to_actor_graph(rcfg, None, **kw)
    g = PT.to_actor_graph(tcfg, **kw)
    assert _graph_rows(g) == _graph_rows(ref_g)
    assert all(a.fire_fn is None for a in g.actors.values()
               if a.name != "Input")
    names = list(g.actors)
    for pp in (1, 15, len(names) - 1):
        a = _split(names, pp)
        assert synthesize(g, Mapping("m", a)).comm_bytes_per_iteration() \
            == ref_synthesize(ref_g, RefMapping("m", a)) \
            .comm_bytes_per_iteration()
    if arch == "qwen2_1_5b" and seq == 512:
        bytes_at = {pp: synthesize(g, Mapping("m", _split(names, pp)))
                    .comm_bytes_per_iteration() for pp in (1, 15, 30)}
        assert bytes_at == {1: 2048, 15: 1572864, 30: 1572864}


def test_serve_cli_partition_on_cpu():
    out = serve.main(["--arch", "qwen2_1_5b", "--device", "cpu",
                      "--requests", "2", "--prompt-len", "16", "--max-new",
                      "2", "--partition", "3"])
    part = out["partition"]
    cfg = TCFG.get_config("qwen2_1_5b").smoke()
    assert part["pp"] == 3
    assert part["boundary_bytes"] == 16 * cfg.d_model * 4     # fp32 smoke
    model = PT.init_params(cfg, 0, device="cpu")
    names = _names(cfg, 1)
    pse = PartitionedServeEngine(cfg, model, Mapping("m", _split(names, 3)),
                                 batch=1, seq=16)
    prompt = serve.synthetic_requests(cfg, 2, 16, 2, 0)[0].prompt
    assert part["argmax"] == int(pse.infer(prompt[None])[0, -1].argmax())
    clamped = serve.main(["--arch", "qwen2_1_5b", "--device", "cpu",
                          "--requests", "1", "--prompt-len", "16",
                          "--max-new", "1", "--partition", "99"])
    assert clamped["partition"]["pp"] == len(_names(cfg, 1))
    assert clamped["partition"]["boundary_bytes"] == 0


# ---------------------------------------------------------------------------
# the deprecated ServeEngine shim, as tests/test_serving_shim.py holds the
# reference's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    cfg = ModelConfig(**TINY)
    return cfg, PT.init_params(cfg, 0, device="cpu")


def _reqs(cfg, specs, seed=0):
    rng = np.random.RandomState(seed)
    return [Request(i, rng.randint(0, cfg.vocab_size, p).astype(np.int32),
                    max_new_tokens=m) for i, (p, m) in enumerate(specs)]


SPECS = [(8, 6), (12, 4), (8, 9), (5, 1)]


def test_shim_warns_exactly_once_with_migration_pointer(tiny):
    cfg, model = tiny
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ServeEngine(cfg, model, max_len=64, device="cpu")
    deps = [w for w in caught if issubclass(w.category, DeprecationWarning)]
    assert len(deps) == 1
    msg = str(deps[0].message)
    for needle in ("ServeEngine is deprecated", "EngineConfig",
                   "admission='batch'", "admission='fifo'",
                   "kv_layout='paged'"):
        assert needle in msg, needle
    assert deps[0].filename == __file__


@pytest.mark.parametrize("legacy_kw,expect", [
    (dict(), dict(admission_cls=BatchAdmission, kv_layout="slotted")),
    (dict(mode="continuous", max_slots=3),
     dict(admission_cls=FifoAdmission, max_slots=3)),
    (dict(mode="continuous", paged=True, block_size=8, num_blocks=20,
          watermark=2),
     dict(kv_layout="paged", block_size=8, num_blocks=20, watermark=2)),
    (dict(mode="continuous", prefill_chunk=4), dict(prefill_chunk=4)),
    (dict(greedy=False, temperature=0.7, seed=5),
     dict(greedy=False, temperature=0.7, seed=5)),
], ids=["default", "continuous", "paged", "chunked", "sampling"])
def test_shim_kwargs_map_onto_engine_config(tiny, legacy_kw, expect):
    cfg, model = tiny
    with pytest.warns(DeprecationWarning):
        shim = ServeEngine(cfg, model, max_len=48, device="cpu", **legacy_kw)
    ec = shim.engine.config
    assert ec.max_len == 48
    for key, val in expect.items():
        if key == "admission_cls":
            assert isinstance(shim.engine.admission, val)
        else:
            assert getattr(ec, key) == val, key
    assert shim.cfg is cfg and shim.model is model
    assert shim.scheduler is shim.engine.scheduler


def test_shim_output_matches_engine_and_keeps_legacy_errors(tiny):
    cfg, model = tiny
    reqs = _reqs(cfg, SPECS)
    ref = Engine(cfg, model, EngineConfig(max_len=64, admission="batch"),
                 device="cpu").generate(reqs)
    with pytest.warns(DeprecationWarning):
        static = ServeEngine(cfg, model, max_len=64, device="cpu")
    with pytest.warns(DeprecationWarning):
        paged = ServeEngine(cfg, model, max_len=64, mode="continuous",
                            max_slots=2, paged=True, block_size=8,
                            device="cpu")
    assert [c.tokens for c in static.generate(reqs)] == \
        [c.tokens for c in ref]
    assert [c.tokens for c in paged.generate(reqs)] == \
        [c.tokens for c in ref]
    with pytest.raises(ValueError, match="mode 'bogus' not in"):
        with pytest.warns(DeprecationWarning):
            ServeEngine(cfg, model, mode="bogus", device="cpu")
    for kw in (dict(paged=True), dict(prefill_chunk=4)):
        with pytest.raises(ValueError, match="require .*mode='continuous'"):
            with pytest.warns(DeprecationWarning):
                ServeEngine(cfg, model, device="cpu", **kw)
    with pytest.raises(ValueError, match="arrivals requires "
                                         "mode='continuous'"):
        static.generate(reqs[:2], arrivals=[0.0, 0.0])
    with pytest.raises(ValueError, match="on_completion requires "
                                         "mode='continuous'"):
        static.generate(reqs[:2], on_completion=lambda c: None)
    with pytest.warns(DeprecationWarning):
        cont = ServeEngine(cfg, model, max_len=64, mode="continuous",
                           max_slots=2, device="cpu")
    seen = []
    outs = cont.generate(reqs[:2], arrivals=[0.0, 0.0],
                         on_completion=seen.append)
    assert len(outs) == 2 and len(seen) == 2


def _quickstart_as_reference(out):
    """torch_quickstart's Explorer records and chosen cut are the
    reference quickstart's (pure modeled numbers: exactly equal)."""
    from repro.core import Explorer as RefExplorer
    from repro.models.cnn import vehicle_graph as ref_vehicle_graph
    res = RefExplorer(ref_vehicle_graph(),
                      ref_paper_platform("N2", "ethernet")).evaluate_modeled()
    assert out["records"] == [(r.pp, r.endpoint_time_s, r.boundary_bytes)
                              for r in res.records]
    assert out["best_pp"] == res.best(privacy=True).pp == 3
    assert len(out["tokens"]) == 8 and out["finish_reason"] == "length"
    assert np.isclose(out["probs"].sum(), 1.0, atol=1e-5)


def _train_small_round_trip(out):
    """torch_train_small at a tiny size: finite losses, the checkpoint
    restored bit for bit, 12 sampled tokens."""
    assert np.isfinite([out["first"], out["last"]]).all()
    assert out["restored_exact"]
    assert len(out["tokens"]) == 12 and out["finish_reason"] == "length"


@pytest.mark.parametrize("name,argv,check", [
    pytest.param("torch_distributed_serving", [], None,
                 id="torch_distributed_serving"),
    pytest.param("torch_partition_explorer", [], None,
                 id="torch_partition_explorer"),
    pytest.param("torch_quickstart", [], _quickstart_as_reference,
                 id="torch_quickstart"),
    pytest.param("torch_train_small",
                 ["--steps", "8", "--d-model", "32", "--layers", "2",
                  "--batch", "4", "--seq", "16"], _train_small_round_trip,
                 id="torch_train_small"),
])
def test_examples_run_on_cpu(name, argv, check, capsys, monkeypatch,
                             tmp_path):
    """The examples' own checks (partitioned logits equal monolithic bit
    for bit, pipelined frames equal run_local, the explorer's chosen cut
    executed) pass on the CPU, and the last two examples' results hold;
    artifacts and checkpoints go to tmp_path."""
    import runpy
    import tempfile
    from pathlib import Path
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    path = Path(__file__).resolve().parents[1] / "examples" / f"{name}.py"
    out = runpy.run_path(str(path), run_name="example")["main"](
        argv + ["--device", "cpu"])
    if check is None:
        assert "bit for bit: True" in capsys.readouterr().out
    else:
        check(out)
