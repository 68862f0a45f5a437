"""Wall-clock deadline shedding in the port's scheduler.

tests/test_deadline_shedding.py in the port, on the ``cm-scan`` weights
of the golden fixture (the shapes of that file's tiny config):
``enforce_deadlines=True`` sheds a request whose due instant passes with
``finish_reason="timeout"`` — at submit, while queued, mid-decode, or
mid-chunked-prefill on the paged pool, leaking no block — while the
survivors keep the static-bucket oracle's tokens; off, deadlines only
order.
"""
from __future__ import annotations

import time

import numpy as np
import pytest

from repro_torch.models.config import ModelConfig
from repro_torch.runtime.engine import Engine, EngineConfig
from repro_torch.runtime.scheduler import Request
from repro_torch.weights import from_jax_params
from test_torch_golden import CONFIG_KW, load_golden

NAME = "cm-scan"
CFG = ModelConfig(**CONFIG_KW[NAME])


@pytest.fixture(scope="module")
def model():
    g = load_golden()
    n = len(f"{NAME}|params|")
    return from_jax_params({k[n:]: v for k, v in g.items()
                            if k.startswith(f"{NAME}|params|")}, CFG,
                           device="cpu")


def _req(i, plen=8, max_new=6, seed=0, **kw):
    rng = np.random.RandomState(seed + i)
    return Request(i, rng.randint(0, CFG.vocab_size, plen).astype(np.int32),
                   max_new_tokens=max_new, **kw)


def _engine(model, **kw):
    kw.setdefault("max_len", 64)
    kw.setdefault("max_slots", 1)
    kw.setdefault("admission", "edf")
    kw.setdefault("enforce_deadlines", True)
    return Engine(CFG, model, EngineConfig(**kw), device="cpu")


def test_already_expired_at_submit(model):
    eng = _engine(model)
    h = eng.submit(_req(0, deadline_s=0.0))
    (c,) = eng.run()
    assert c.finish_reason == "timeout"
    assert c.tokens == [] and h.tokens == []
    assert eng.stats()["sheds"] == 1
    assert eng.stats()["admissions"] == 0, "shed before prefill"


def test_expired_while_queued(model):
    """One slot held by a long request; a tight-deadline request queued
    behind it expires waiting and never touches a slot."""
    eng = _engine(model)
    long = eng.submit(_req(0, max_new=24))
    while not eng.scheduler.active:
        eng.step()
    tight = eng.submit(_req(1, deadline_s=1e-4))
    time.sleep(2e-3)
    outs = {c.id: c for c in eng.run()}
    assert outs[0].finish_reason == "length" and len(outs[0].tokens) == 24
    assert outs[1].finish_reason == "timeout" and outs[1].tokens == []
    assert tight.tokens == []
    assert 1 not in [e.request_id for e in eng.scheduler.events
                     if e.kind == "admit"]
    assert long.finish_reason == "length"


def test_expired_mid_decode(model):
    """A deadline shorter than the decode: the request emits some tokens,
    then sheds with its stream frozen and its slot released."""
    eng = _engine(model, max_len=512)
    eng.generate([_req(99)])
    h = eng.submit(_req(0, max_new=400, deadline_s=0.05))
    (c,) = eng.run()
    assert c.finish_reason == "timeout"
    assert 0 < len(c.tokens) < 400
    assert h.tokens == c.tokens, "token emitted after the shed"
    sched = eng.scheduler
    assert sched.done and sorted(sched.free) == [0], "slot leak"
    shed = [e for e in sched.events if e.kind == "shed" and e.request_id == 0]
    assert len(shed) == 1 and shed[0].slot == 0


@pytest.mark.parametrize("prefill_chunk", [0, 4])
def test_paged_shed_releases_blocks(model, prefill_chunk):
    eng = _engine(model, max_len=512, max_slots=2, kv_layout="paged",
                  block_size=8, num_blocks=70, prefill_chunk=prefill_chunk,
                  debug=True)
    eng.generate([_req(99)])
    hs = [eng.submit(_req(0, max_new=400, deadline_s=0.04)),
          eng.submit(_req(1, deadline_s=0.0)),
          eng.submit(_req(2, max_new=4))]
    outs = {c.id: c for c in eng.run()}
    assert outs[0].finish_reason == "timeout"
    assert outs[1].finish_reason == "timeout" and outs[1].tokens == []
    assert outs[2].finish_reason == "length"
    assert eng.scheduler.alloc.in_use == 0, "shed leaked blocks"
    assert not eng.scheduler.block_tables.any()
    assert hs[0].tokens == outs[0].tokens


def test_survivors_match_static_oracle(model):
    """A contended EDF run sheds its tight-deadline cohort as "timeout";
    every survivor's tokens equal the static oracle's on the survivors."""
    eng = _engine(model, max_slots=2)
    eng.generate([_req(99)])
    reqs = [_req(i, plen=8 + 2 * (i % 3), max_new=6,
                 deadline_s=1e-4 if i % 3 == 2 else None) for i in range(8)]
    outs = {c.id: c for c in eng.generate(reqs)}
    shed = {i for i, c in outs.items() if c.finish_reason == "timeout"}
    assert shed == {2, 5}
    for i in shed:
        assert len(outs[i].tokens) < reqs[i].max_new_tokens
    survivors = [r for r in reqs if r.id not in shed]
    oracle = Engine(CFG, model, EngineConfig(max_len=64, admission="batch"),
                    device="cpu")
    for c in oracle.generate(survivors):
        assert outs[c.id].tokens == c.tokens
        assert outs[c.id].finish_reason == c.finish_reason


def test_enforcement_off_never_sheds(model):
    eng = _engine(model, enforce_deadlines=False)
    outs = eng.generate([_req(0, deadline_s=0.0),
                         _req(1, deadline_s=1e-5, max_new=4)])
    assert [c.finish_reason for c in outs] == ["length", "length"]
    assert eng.stats()["sheds"] == 0


def test_batch_mode_rejects_enforcement(model):
    with pytest.raises(ValueError, match="enforce_deadlines"):
        Engine(CFG, model, EngineConfig(admission="batch",
                                        enforce_deadlines=True),
               device="cpu")
