"""The port's stage-partitioned decode step and multi-unit engine surface.

tests/test_multi_unit.py's computation and engine-integration halves in
the port, on the ``cm-rem`` weights of the golden fixture (the shapes of
that file's ``mu`` config: 3 layers, a period of two ``attn`` layers and
one remainder layer, tied embeddings):

* ``decode_step_staged`` equals ``decode_step`` bit for bit (logits,
  every cache leaf, lengths) at 1 to 4 stages, on the slotted cache and
  on the paged pool, and JAX's ``decode_step_staged`` within 1e-5;
* ``decode_stage_bounds`` is the reference's partition;
* an engine with a prefill unit and two decode stages emits the batch
  oracle's tokens and reports its units in ``snapshot()``; with
  observability on, the units' modeled-clock tracks sit in a ``"units"``
  process (one thread per unit) and a single-unit engine opens none;
* the CLI flags round-trip and batch admission refuses the multi-unit
  core.
"""
from __future__ import annotations

import argparse

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as JT
from repro_torch.models import transformer as PT
from repro_torch.models.config import ModelConfig
from repro_torch.runtime.engine import Engine, EngineConfig
from repro_torch.runtime.observability import validate_chrome_trace
from repro_torch.runtime.scheduler import Request
from repro_torch.weights import from_jax_params
from test_torch_golden import CONFIG_KW, load_golden, params_from

NAME = "cm-rem"
CFG = ModelConfig(**CONFIG_KW[NAME])
PROMPT = np.arange(12, dtype=np.int32).reshape(2, 6) * 7 % CFG.vocab_size


@pytest.fixture(scope="module")
def models():
    g = load_golden()
    n = len(f"{NAME}|params|")
    flat = {k[n:]: v for k, v in g.items() if k.startswith(f"{NAME}|params|")}
    return from_jax_params(flat, CFG, device="cpu"), params_from(g)(NAME, CFG)


def _prefilled(model):
    logits, cache, clen = PT.prefill(model, torch.as_tensor(PROMPT),
                                     max_len=32)
    return logits.argmax(-1).to(torch.int32), cache, clen


def _clone(cache):
    return [{k: v.clone() for k, v in c.items()} for c in cache]


@pytest.mark.parametrize("stages", [1, 2, 3, 4])
def test_staged_decode_bit_identical_slotted(models, stages):
    model, _ = models
    tok, cache, clen = _prefilled(model)
    l0, c0, n0 = PT.decode_step(model, tok, _clone(cache), clen)
    l1, c1, n1 = PT.decode_step_staged(model, tok, _clone(cache), clen,
                                       num_stages=stages)
    assert torch.equal(l0, l1) and torch.equal(n0, n1)
    for a, b in zip(c0, c1):
        assert torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"])


@pytest.mark.parametrize("stages", [1, 2, 3, 4])
def test_staged_decode_bit_identical_paged(models, stages):
    """The same over a block pool: the prefilled rows inserted through
    block tables that name scattered blocks."""
    model, _ = models
    tok, cache, clen = _prefilled(model)
    bs, pages = 4, 4
    pool = PT.init_paged_cache(CFG, 2 * pages + 3, bs, 2, max_len=16,
                               device="cpu")
    tables = torch.tensor([[3, 5, 7, 9], [10, 2, 4, 6]], dtype=torch.int32)
    for b in range(2):
        PT.paged_insert(CFG, pool, [{k: v[b:b + 1] for k, v in c.items()}
                                    for c in cache],
                        tables[b].numpy(), b, block_size=bs)
    l0, c0, _ = PT.decode_step(model, tok, _clone(pool), clen,
                               block_tables=tables)
    l1, c1, _ = PT.decode_step_staged(model, tok, _clone(pool), clen,
                                      num_stages=stages, block_tables=tables)
    assert torch.equal(l0, l1)
    for a, b in zip(c0, c1):
        assert torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"])
    lr, _, _ = PT.decode_step(model, tok, _clone(cache), clen)
    torch.testing.assert_close(l0, lr, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("stages", [1, 2, 3, 4])
def test_staged_decode_matches_jax(models, stages):
    """Against the reference's ``decode_step_staged`` on the same
    weights and prompt: logits within 1e-5."""
    model, params = models
    tok, cache, clen = _prefilled(model)
    logits, _, _ = PT.decode_step_staged(model, tok, cache, clen,
                                         num_stages=stages)
    jl, jc, jn = JT.prefill(params, CFG, {"tokens": jnp.asarray(PROMPT)},
                            max_len=32)
    jtok = jnp.argmax(jl, -1).astype(jnp.int32)
    assert np.array_equal(np.asarray(jtok), tok.numpy())
    want, _, _ = JT.decode_step_staged(params, CFG, jtok, jc, jn,
                                       num_stages=stages)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_stage_bounds_match_the_reference():
    total = CFG.n_periods + len(CFG.remainder_kinds)
    for k in range(1, 6):
        cuts = PT.decode_stage_bounds(CFG, k)
        assert cuts == JT.decode_stage_bounds(CFG, k)
        assert cuts[0] == 0 and cuts[-1] == total and cuts == sorted(cuts)


def _reqs(n=4, max_new=4):
    return [Request(i, (np.arange(4 + i) % CFG.vocab_size).astype(np.int32),
                    max_new_tokens=max_new) for i in range(n)]


def test_unit_stats_in_snapshot_and_identity(models):
    model, _ = models
    ref = Engine(CFG, model, EngineConfig(max_len=32, admission="batch"),
                 device="cpu").generate(_reqs())
    eng = Engine(CFG, model, EngineConfig(
        max_len=32, max_slots=2, units=3, prefill_units=1, decode_stages=2,
        placement="least-loaded"), device="cpu")
    outs = eng.generate(_reqs())
    assert [c.tokens for c in outs] == [c.tokens for c in ref]
    units = eng.snapshot()["units"]
    assert units["kv_handoffs"] == 4
    assert units["modeled_makespan_s"] > 0
    assert {u["name"] for u in units["units"]} == \
        {"decode0", "decode1", "prefill0"}


def test_unit_trace_tracks_modeled_clock_only(models):
    model, _ = models
    eng = Engine(CFG, model, EngineConfig(
        max_len=32, max_slots=2, units=3, prefill_units=1, decode_stages=2,
        observability=True), device="cpu")
    eng.generate(_reqs(3, 3))
    trace = eng.trace_json()
    assert validate_chrome_trace(trace) > 0
    meta = [m for m in trace["traceEvents"] if m.get("ph") == "M"]
    pids = {m["pid"]: m["args"]["name"] for m in meta
            if m["name"] == "process_name"}
    unit_pids = {p for p, n in pids.items() if n == "units"}
    assert unit_pids, "no per-unit trace process"
    threads = {m["args"]["name"] for m in meta
               if m["name"] == "thread_name" and m["pid"] in unit_pids}
    assert threads == {"prefill0", "decode0", "decode1"}
    ev = [e for e in trace["traceEvents"]
          if e.get("pid") in unit_pids and e.get("ph") != "M"]
    assert ev and {e["cat"] for e in ev} == {"modeled"}
    names = {e["name"] for e in ev}
    assert any(n.startswith("prefill") for n in names)
    assert "kv-handoff" in names
    single = Engine(CFG, model, EngineConfig(max_len=32, max_slots=2,
                                             observability=True),
                    device="cpu")
    single.generate(_reqs(1, 3))
    assert not [m for m in single.trace_json()["traceEvents"]
                if m.get("ph") == "M" and m.get("name") == "process_name"
                and m["args"]["name"] == "units"]


def test_batch_admission_rejects_multi_unit(models):
    model, _ = models
    for kw in (dict(units=2), dict(decode_stages=2, units=2)):
        with pytest.raises(ValueError, match="multi-unit"):
            Engine(CFG, model, EngineConfig(admission="batch", **kw),
                   device="cpu")


def test_cli_flags_round_trip():
    ap = argparse.ArgumentParser()
    EngineConfig.add_cli_args(ap)
    args = ap.parse_args(["--units", "3", "--prefill-units", "1",
                          "--decode-stages", "2", "--placement",
                          "least-loaded", "--victim-cache",
                          "--enforce-deadlines", "--observability"])
    c = EngineConfig.from_args(args, max_len=64)
    assert (c.units, c.prefill_units, c.decode_stages) == (3, 1, 2)
    assert c.placement == "least-loaded"
    assert (c.kv_layout, c.prefix_cache, c.victim_cache) == \
        ("paged", True, True)
    assert c.enforce_deadlines and c.observability and c.max_len == 64
