"""The port's ``Engine`` on the CPU against the reference's batch oracle.

The conformance workload (tests/test_conformance_matrix.py ``_workload``)
runs through ``repro_torch``'s ``Engine(device="cpu")`` on the reference's
``cm-scan`` and ``cm-rem`` weights under fifo, priority, edf and batch
admission, and over the conformance matrix's layouts (slotted, chunked
prefill, the paged pool, prefix sharing, the victim cache, prefill/decode
disaggregation, pipelined decode, and their combinations) on a diagonal
of policies. Tokens and finish reasons must equal the
reference's static-bucket oracle, which the golden fixture holds and
tests/test_torch_golden.py holds against JAX; the paged pool must come
home whole (less the victim cache's parked chains); the paged fifo cells,
and a tight pool without and with an admission watermark, must count
what JAX's engine counts. Also: the
watermark's refusals word for word, the lifecycle hooks (streaming,
cancellation, failure re-queue, growth preemption) and temperature
sampling by its distribution.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.runtime.engine import Engine, EngineConfig
from repro_torch.runtime.policies import Sampler
from repro_torch.runtime.scheduler import Request, SlotFailure
from repro_torch.weights import from_jax_params
from test_torch_golden import (CONFIG_KW, COUNTERS, ENGINE_MAX_LEN,
                               LAYOUTS, load_golden, params_from, requests,
                               unflatten, workload_specs)


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
                     json.loads(str(golden[f"{name}|oracle_reasons"])),
                     json.loads(str(golden[f"{name}|counters"])))
    return out


def _engine(cfg, model, admission, **kw):
    return Engine(cfg, model, EngineConfig(
        max_len=ENGINE_MAX_LEN, max_slots=3, admission=admission,
        debug=admission != "batch", **kw), device="cpu")


@pytest.mark.parametrize("admission", ["fifo", "priority", "edf", "batch"])
@pytest.mark.parametrize("name", sorted(CONFIG_KW))
def test_engine_matches_jax_batch_oracle(zoo, name, admission):
    cfg, model, tokens, reasons, _ = zoo[name]
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


# tests/test_conformance_matrix.py FAST, the rows of this slice's layouts:
# every layout on both configs, fifo / priority / edf and both preemption
# policies each at least once
DIAGONAL = [
    ("cm-scan", "slotted-chunked", "fifo", "evict-latest"),
    ("cm-rem", "slotted-chunked", "edf", "evict-latest"),
    ("cm-scan", "paged", "priority", "lowest-priority"),
    ("cm-rem", "paged", "fifo", "evict-latest"),
    ("cm-scan", "paged-chunked", "fifo", "evict-latest"),
    ("cm-scan", "paged-chunked", "edf", "evict-latest"),
    ("cm-rem", "paged-chunked", "priority", "lowest-priority"),
    ("cm-scan", "paged-prefix", "fifo", "evict-latest"),
    ("cm-rem", "paged-prefix", "fifo", "evict-latest"),
    ("cm-rem", "paged-prefix", "edf", "lowest-priority"),
    ("cm-scan", "paged-chunked-prefix", "fifo", "evict-latest"),
    ("cm-rem", "paged-chunked-prefix", "fifo", "evict-latest"),
    ("cm-scan", "paged-chunked-prefix", "edf", "lowest-priority"),
    ("cm-scan", "paged-tight", "fifo", "evict-latest"),
    ("cm-rem", "paged-tight", "fifo", "evict-latest"),
    ("cm-scan", "paged-tight-watermark", "fifo", "evict-latest"),
    ("cm-rem", "paged-tight-watermark", "fifo", "evict-latest"),
    ("cm-scan", "paged-prefix-victim", "fifo", "evict-latest"),
    ("cm-rem", "paged-prefix-victim", "priority", "lowest-priority"),
    ("cm-rem", "paged-prefix-victim", "fifo", "evict-latest"),
    ("cm-scan", "disagg", "fifo", "evict-latest"),
    ("cm-rem", "disagg", "priority", "lowest-priority"),
    ("cm-rem", "disagg", "fifo", "evict-latest"),
    ("cm-scan", "pipelined-decode", "fifo", "evict-latest"),
    ("cm-rem", "pipelined-decode", "edf", "evict-latest"),
    ("cm-rem", "pipelined-decode", "fifo", "evict-latest"),
]


def _check_pool_home(eng, kw):
    """At drain every block is back, except the victim cache's parked
    chains, whose books balance against the parked population."""
    sched = eng.scheduler
    if kw.get("kv_layout") == "paged":
        parked = len(sched.layout.victim or ())
        assert parked == 0 or kw.get("victim_cache")
        assert sched.alloc.in_use == parked
        assert sched.alloc.available == sched.alloc.capacity - parked
        assert not sched.block_tables.any()
        sched.layout.check(set(), sched.sched.max_slots)
    assert not sched.cache_len.any() and not sched.tokens.any()


@pytest.mark.parametrize("name,layout,admission,preemption", DIAGONAL)
def test_layout_cell_matches_jax_batch_oracle(zoo, name, layout, admission,
                                              preemption):
    cfg, model, tokens, reasons, counters = zoo[name]
    kw = LAYOUTS[layout]
    eng = _engine(cfg, model, admission, preemption=preemption, **kw)
    outs = eng.generate(requests(workload_specs(cfg.vocab_size), Request))
    assert [c.tokens for c in outs] == tokens
    assert [c.finish_reason for c in outs] == reasons
    st = eng.stats()
    assert st["admissions"] >= len(tokens)
    _check_pool_home(eng, kw)
    if kw.get("prefix_cache"):
        assert st["prefix_hits"] > 0, "shared-prefix workload never shared"
        assert st["prefill_tokens_saved"] > 0
        pc = eng.scheduler.layout.prefix_cache_stats()
        assert {k: pc[k] for k in ("enabled", "victim_cache", "prefix_hits",
                                   "victim_hits", "victim_evictions")} == {
            "enabled": True, "victim_cache": bool(kw.get("victim_cache")),
            "prefix_hits": st["prefix_hits"],
            "victim_hits": st["victim_hits"],
            "victim_evictions": st["victim_evictions"]}
    if kw.get("units", 1) > 1:
        units = eng.snapshot()["units"]
        assert units["kv_handoffs"] == st["admissions"]
        assert units["decode_stages"] == kw["decode_stages"]
    if layout in counters and admission == "fifo" \
            and preemption == "evict-latest":   # JAX counted this cell
        assert {k: st[k] for k in COUNTERS} == counters[layout]


@pytest.mark.parametrize("preemption", ["evict-latest", "lowest-priority"])
def test_tight_pool_preempts_and_keeps_tokens(zoo, preemption):
    """A pool of 6 usable blocks cannot hold three growing requests:
    growth preempts (and re-queues) under either policy, and the tokens
    stay the oracle's."""
    cfg, model, tokens, reasons, _ = zoo["cm-scan"]
    kw = dict(kv_layout="paged", block_size=8, num_blocks=7,
              prefill_chunk=4, prefix_cache=True)
    eng = _engine(cfg, model, "priority", preemption=preemption, **kw)
    outs = eng.generate(requests(workload_specs(cfg.vocab_size), Request))
    assert [c.tokens for c in outs] == tokens
    assert [c.finish_reason for c in outs] == reasons
    assert eng.stats()["preemptions"] > 0
    assert sum(c.restarts for c in outs) == eng.stats()["preemptions"]
    _check_pool_home(eng, kw)


def test_structural_errors(zoo):
    """tests/test_conformance_matrix.py ``test_invalid_cells_are_rejected``
    in the port: batch admission refuses paged layouts and chunked
    prefill, prefix sharing refuses the slotted layout, and the victim
    cache refuses to run without prefix sharing, as the reference's
    ``Engine`` refuses them."""
    cfg, model, *_ = zoo["cm-scan"]
    with pytest.raises(ValueError, match="batch admission"):
        Engine(cfg, model, EngineConfig(admission="batch",
                                        kv_layout="paged"), device="cpu")
    with pytest.raises(ValueError, match="batch admission"):
        Engine(cfg, model, EngineConfig(admission="batch", prefill_chunk=4),
               device="cpu")
    with pytest.raises(ValueError, match="prefix_cache"):
        Engine(cfg, model, EngineConfig(kv_layout="slotted",
                                        prefix_cache=True), device="cpu")
    with pytest.raises(ValueError, match="victim_cache"):
        Engine(cfg, model, EngineConfig(kv_layout="paged",
                                        victim_cache=True), device="cpu")
    with pytest.raises(ValueError, match="kv_layout"):
        Engine(cfg, model, EngineConfig(kv_layout="ring"), device="cpu")
    with pytest.raises(ValueError, match="blocks worst-case"):
        _engine(cfg, model, "fifo", kv_layout="paged", block_size=8,
                num_blocks=3).submit(Request(0, np.zeros(20, np.int32),
                                             max_new_tokens=8))


@pytest.mark.parametrize("kw", [dict(prefill_chunk=4),
                                dict(kv_layout="paged", prefix_cache=True)])
def test_ring_capped_cache_refuses_extend_paths(kw):
    """A ring cache has no position-indexed cache to extend, so chunked
    prefill and prefix sharing are not refused: they serve one-shot, as
    the reference serves them, with its engine's tokens, no extend call
    and no prefix hit. Chunked prefill on a ``max_cache_len`` ring cap
    (slotted); prefix sharing on a local-attention ring (the paged
    layout refuses a cap in both packages). Four requests share a
    12-token preamble; the cap wraps during decode."""
    from repro.models.config import ModelConfig as JConfig
    from repro.runtime.engine import Engine as JEngine
    from repro.runtime.engine import EngineConfig as JEngineConfig
    from repro.runtime.scheduler import Request as JRequest
    from repro_torch.models import transformer as PT
    golden = load_golden()
    ring = dict(layer_pattern=("attn", "attn_local"), window=8) \
        if "prefix_cache" in kw else dict(max_cache_len=16)
    jcfg = JConfig(**{**CONFIG_KW["cm-scan"], **ring})
    cfg = ModelConfig(**{**CONFIG_KW["cm-scan"], **ring})
    assert not PT.supports_chunked_prefill(cfg)
    flat = {k[len("cm-scan|params|"):]: v for k, v in golden.items()
            if k.startswith("cm-scan|params|")}
    if "prefix_cache" in kw:
        # cm-scan's two stacked layers as one period of (attn, attn_local)
        flat = {k.replace("scan/0/", f"scan/{i}/"): v[i:i + 1]
                for k, v in flat.items() if k.startswith("scan/0/")
                for i in range(2)} | {k: v for k, v in flat.items()
                                      if not k.startswith("scan/")}
    params = unflatten(flat)
    model = from_jax_params(flat, cfg, device="cpu")
    rng = np.random.RandomState(3)
    head = rng.randint(0, cfg.vocab_size, 12)
    prompts = [np.concatenate([head, rng.randint(0, cfg.vocab_size, 2)])
               .astype(np.int32) for _ in range(3)]
    prompts.append(prompts[0].copy())
    want = JEngine(jcfg, params, JEngineConfig(
        max_len=ENGINE_MAX_LEN, max_slots=3, admission="fifo", **kw)
    ).generate([JRequest(i, p, max_new_tokens=6)
                for i, p in enumerate(prompts)])
    calls = {"extend": 0}
    extend = PT.prefill_extend

    def counted(*a, **k):
        calls["extend"] += 1
        return extend(*a, **k)
    eng = _engine(cfg, model, "fifo", **kw)
    PT.prefill_extend = counted
    try:
        got = eng.generate([Request(i, p, max_new_tokens=6)
                            for i, p in enumerate(prompts)])
    finally:
        PT.prefill_extend = extend
    assert [c.tokens for c in got] == [c.tokens for c in want]
    assert calls["extend"] == 0
    assert eng.stats()["prefix_hits"] == 0
    assert eng.scheduler._chunk == 0 and not eng.scheduler._prefix


def test_watermark_admission_and_refusals_match_jax(zoo):
    """tests/test_engine_lifecycle.py ``test_watermark_never_blocks_a_
    servable_request`` in the port. With 7 usable blocks of 4 rows and
    5 held back, a 2-block prompt that grows to 3 blocks is served (growth
    bypasses the watermark) with the oracle's tokens; a 3-block prompt
    can never clear admission, a worst case beyond the pool is refused,
    and a watermark of the whole pool admits nothing. Each refusal is
    the reference engine's, word for word."""
    from repro.runtime.engine import Engine as JaxEngine
    from repro.runtime.engine import EngineConfig as JaxEngineConfig
    from repro.runtime.scheduler import Request as JaxRequest

    cfg, model, tokens, reasons, _ = zoo["cm-scan"]
    params = params_from(load_golden())("cm-scan", cfg)
    kw = dict(max_len=32, max_slots=2, kv_layout="paged", block_size=4,
              num_blocks=8, watermark=5)
    eng = Engine(cfg, model, EngineConfig(debug=True, **kw), device="cpu")
    jax_eng = JaxEngine(cfg, params, JaxEngineConfig(**kw))
    (spec,) = workload_specs(cfg.vocab_size)[:1]   # 5 prompt + 6 new rows
    (out,) = eng.generate(requests([spec], Request))
    assert out.tokens == tokens[0] and out.finish_reason == reasons[0]
    assert eng.scheduler.alloc.in_use == 0
    assert eng.scheduler.alloc.hwm == 3

    def refusal(engine, request_cls, n_prompt, max_new):
        with pytest.raises(ValueError) as err:
            engine.submit(request_cls(1, np.zeros(n_prompt, np.int32),
                                      max_new_tokens=max_new))
        return str(err.value)
    for n_prompt, max_new, word in ((12, 2, "watermark"),
                                    (8, 24, "worst-case")):
        got = refusal(eng, Request, n_prompt, max_new)
        assert word in got
        assert got == refusal(jax_eng, JaxRequest, n_prompt, max_new)
    kw["watermark"] = 7
    with pytest.raises(ValueError, match="watermark") as got:
        Engine(cfg, model, EngineConfig(**kw), device="cpu")
    with pytest.raises(ValueError) as want:
        JaxEngine(cfg, params, JaxEngineConfig(**kw))
    assert str(got.value) == str(want.value)


def test_eos_stops_agree_with_batch(zoo):
    cfg, model, tokens, *_ = zoo["cm-scan"]
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


@pytest.mark.parametrize("layout", ["slotted", "paged-chunked-prefix"])
def test_stream_cancel_and_failure_requeue(zoo, layout):
    cfg, model, tokens, *_ = zoo["cm-rem"]
    specs = workload_specs(cfg.vocab_size)
    eng = Engine(cfg, model, EngineConfig(max_len=ENGINE_MAX_LEN,
                                          max_slots=3, debug=True,
                                          **LAYOUTS[layout]), device="cpu",
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
    _check_pool_home(eng, LAYOUTS[layout])


def test_temperature_sampling_by_distribution():
    """Temperature sampling cannot replay JAX's PRNG: hold it to the
    softmax distribution instead."""
    logits = torch.log(torch.tensor([[0.1, 0.2, 0.3, 0.4]])).repeat(4000, 1)
    toks = Sampler(greedy=False, temperature=1.0, seed=3,
                   device="cpu")(logits)
    freq = np.bincount(toks.numpy(), minlength=4) / toks.numel()
    np.testing.assert_allclose(freq, [0.1, 0.2, 0.3, 0.4], atol=0.03)
    hot = Sampler(greedy=False, temperature=0.25, seed=3,
                  device="cpu")(logits)
    assert (hot == 3).float().mean() > 0.5
    greedy = Sampler(greedy=True, device="cpu")(
        torch.tensor([[1.0, 3.0, 3.0, 0.0]]))
    assert greedy.tolist() == [1]        # ties take the first index
