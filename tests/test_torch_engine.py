"""The port's ``Engine`` on the CPU against the reference's batch oracle.

The conformance workload (tests/test_conformance_matrix.py ``_workload``)
runs through ``repro_torch``'s ``Engine(device="cpu")`` on the reference's
``cm-scan`` and ``cm-rem`` weights under fifo, priority, edf and batch
admission. Tokens and finish reasons must equal the reference's
static-bucket oracle, which the golden fixture holds and
tests/test_torch_golden.py holds against JAX. Also: the lifecycle hooks
(streaming, cancellation, failure re-queue) and temperature sampling by
its distribution.
"""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.runtime.engine import Engine, EngineConfig
from repro_torch.runtime.policies import Sampler
from repro_torch.runtime.scheduler import Request, SlotFailure
from repro_torch.weights import from_jax_params
from test_torch_golden import (CONFIG_KW, ENGINE_MAX_LEN, load_golden,
                               requests, workload_specs)


@pytest.fixture(scope="module")
def zoo():
    golden = load_golden()
    out = {}
    for name, kw in CONFIG_KW.items():
        cfg = ModelConfig(**kw)
        n = len(f"{name}|params|")
        flat = {k[n:]: v for k, v in golden.items()
                if k.startswith(f"{name}|params|")}
        out[name] = (cfg, from_jax_params(flat, cfg, device="cpu"),
                     json.loads(str(golden[f"{name}|oracle_tokens"])),
                     json.loads(str(golden[f"{name}|oracle_reasons"])))
    return out


def _engine(cfg, model, admission, **kw):
    return Engine(cfg, model, EngineConfig(
        max_len=ENGINE_MAX_LEN, max_slots=3, admission=admission,
        debug=admission != "batch", **kw), device="cpu")


@pytest.mark.parametrize("admission", ["fifo", "priority", "edf", "batch"])
@pytest.mark.parametrize("name", sorted(CONFIG_KW))
def test_engine_matches_jax_batch_oracle(zoo, name, admission):
    cfg, model, tokens, reasons = zoo[name]
    eng = _engine(cfg, model, admission)
    outs = eng.generate(requests(workload_specs(cfg.vocab_size), Request))
    assert [c.id for c in outs] == list(range(len(tokens)))
    assert [c.tokens for c in outs] == tokens
    assert [c.finish_reason for c in outs] == reasons
    if admission != "batch":
        st = eng.stats()
        assert st["admissions"] == len(tokens)
        assert st["tokens_generated"] == sum(map(len, tokens))
        assert not eng.scheduler.cache_len.any()


def test_eos_stops_agree_with_batch(zoo):
    cfg, model, tokens, _ = zoo["cm-scan"]
    eos = tokens[2][3]                   # occurs mid-stream for request 2
    specs = workload_specs(cfg.vocab_size)
    runs = []
    for admission in ("batch", "priority"):
        reqs = requests(specs, Request)
        for r in reqs:
            r.eos = eos
        runs.append(_engine(cfg, model, admission).generate(reqs))
    assert [c.tokens for c in runs[0]] == [c.tokens for c in runs[1]]
    assert [c.finish_reason for c in runs[0]] == \
        [c.finish_reason for c in runs[1]]
    assert "eos" in {c.finish_reason for c in runs[0]}


def test_stream_cancel_and_failure_requeue(zoo):
    cfg, model, tokens, _ = zoo["cm-rem"]
    specs = workload_specs(cfg.vocab_size)
    eng = Engine(cfg, model, EngineConfig(max_len=ENGINE_MAX_LEN,
                                          max_slots=3), device="cpu",
                 failures=[SlotFailure(step=2)])
    reqs = requests(specs, Request)
    handles = [eng.submit(r) for r in reqs]
    assert list(handles[2].stream()) == tokens[2]
    handles[10].cancel()
    eng.run()
    by_id = {h.request.id: h.result() for h in handles}
    assert handles[2].result().tokens == tokens[2]
    assert by_id[10].finish_reason == "cancelled"
    for i, want in enumerate(tokens):
        if i not in (2, 10):
            assert by_id[i].tokens == want, i
    assert eng.stats()["slot_failures"] > 0
    assert eng.stats()["cancellations"] == 1


def test_temperature_sampling_by_distribution():
    """Temperature sampling cannot replay JAX's PRNG: hold it to the
    softmax distribution instead."""
    logits = torch.log(torch.tensor([[0.1, 0.2, 0.3, 0.4]])).repeat(4000, 1)
    toks = Sampler(greedy=False, temperature=1.0, seed=3)(logits)
    freq = np.bincount(toks.numpy(), minlength=4) / toks.numel()
    np.testing.assert_allclose(freq, [0.1, 0.2, 0.3, 0.4], atol=0.03)
    hot = Sampler(greedy=False, temperature=0.25, seed=3)(logits)
    assert (hot == 3).float().mean() > 0.5
    greedy = Sampler(greedy=True)(torch.tensor([[1.0, 3.0, 3.0, 0.0]]))
    assert greedy.tolist() == [1]        # ties take the first index
