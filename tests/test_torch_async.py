"""The port's background-drained, thread-safe and asyncio engine surface.

tests/test_async_engine.py in the port, on the ``cm-scan`` weights of
the golden fixture: after ``Engine.start()`` handles resolve without the
caller pumping (``result()``, ``stream()``, token callbacks); tokens
equal a caller-pumped run's; concurrent submitters all complete; a
cancel from another thread freezes the stream; ``asubmit()`` /
``astream()`` / ``aresult()`` run on an event loop; ``step()`` /
``run()`` are refused while the drain owns the loop and work again after
``shutdown()``; a submission mid-epoch carries its wall-clock arrival.
Every wait has a timeout and every thread is joined with one.
"""
from __future__ import annotations

import asyncio
import threading
import time

import numpy as np
import pytest

from repro_torch.models.config import ModelConfig
from repro_torch.serving import Engine, EngineConfig, Request
from repro_torch.weights import from_jax_params
from test_torch_golden import CONFIG_KW, load_golden

NAME = "cm-scan"
CFG = ModelConfig(**CONFIG_KW[NAME])
WAIT_S = 60


@pytest.fixture(scope="module")
def model():
    g = load_golden()
    n = len(f"{NAME}|params|")
    return from_jax_params({k[n:]: v for k, v in g.items()
                            if k.startswith(f"{NAME}|params|")}, CFG,
                           device="cpu")


def _engine(model, **kw):
    return Engine(CFG, model, EngineConfig(**kw), device="cpu")


def _req(i, plen=8, max_new=6, seed=0, **kw):
    rng = np.random.RandomState(seed + i)
    return Request(i, rng.randint(0, CFG.vocab_size, plen).astype(np.int32),
                   max_new_tokens=max_new, **kw)


def _join(threads):
    for t in threads:
        t.join(timeout=WAIT_S)
    assert not any(t.is_alive() for t in threads), "a client thread hung"


def test_background_result_and_stream(model):
    with _engine(model, max_len=64, max_slots=2).start() as eng:
        assert eng.running
        c = eng.submit(_req(0)).result(timeout=WAIT_S)
        assert c.finish_reason == "length" and len(c.tokens) == 6
        seen = []
        h2 = eng.submit(_req(1))
        h2.on_token(seen.append)
        assert list(h2.stream()) == h2.tokens == seen
        assert h2.finish_reason == "length"
    assert not eng.running


def test_background_tokens_match_caller_pumped(model):
    reqs = [_req(i, plen=(8, 12)[i % 2], max_new=4 + i % 3)
            for i in range(6)]
    expect = {c.id: c.tokens for c in
              _engine(model, max_len=64, max_slots=2).generate(reqs)}
    with _engine(model, max_len=64, max_slots=2).start() as eng:
        handles = [eng.submit(r) for r in reqs]
        for r, h in zip(reqs, handles):
            assert h.result(timeout=WAIT_S).tokens == expect[r.id]


def test_concurrent_submitters(model):
    out, errs = [], []
    with _engine(model, max_len=64, max_slots=3).start() as eng:
        def client(base):
            try:
                for k in range(3):
                    h = eng.submit(_req(base * 10 + k, seed=base))
                    out.append(h.result(timeout=WAIT_S))
            except Exception as e:      # noqa: BLE001 — surfaced below
                errs.append(e)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        _join(threads)
    assert not errs
    assert len(out) == 12 and len({c.id for c in out}) == 12
    assert all(c.finish_reason == "length" and len(c.tokens) == 6
               for c in out)


def test_cross_thread_cancel(model):
    with _engine(model, max_len=512, max_slots=1).start() as eng:
        eng.submit(_req(99)).result(timeout=WAIT_S)
        h = eng.submit(_req(0, max_new=400))
        deadline = time.monotonic() + WAIT_S
        while not h.tokens and time.monotonic() < deadline:
            time.sleep(0.002)
        h.cancel()
        frozen = list(h.tokens)
        c = h.result(timeout=WAIT_S)
        assert c.finish_reason == "cancelled"
        assert len(c.tokens) <= len(frozen) + 1 and len(c.tokens) < 400


def test_step_refused_while_draining(model):
    eng = _engine(model, max_len=64).start()
    try:
        with pytest.raises(RuntimeError, match="drain thread"):
            eng.step()
        with pytest.raises(RuntimeError, match="drain thread"):
            eng.run()
    finally:
        eng.shutdown()
    assert not eng.running
    assert eng.submit(_req(0)).result().finish_reason == "length"


def test_batch_mode_cannot_start(model):
    eng = _engine(model, max_len=64, admission="batch")
    with pytest.raises(ValueError, match="batch"):
        eng.start()


def test_wall_clock_arrival_stamping(model):
    """A submission against a mid-epoch drain carries its elapsed
    arrival instant, so its TTFT measures queueing from submission."""
    with _engine(model, max_len=512, max_slots=1).start() as eng:
        eng.submit(_req(99)).result(timeout=WAIT_S)
        first = eng.submit(_req(0, max_new=200))
        deadline = time.monotonic() + WAIT_S
        while not first.tokens and time.monotonic() < deadline:
            time.sleep(0.002)
        time.sleep(0.05)
        late = eng.submit(_req(1, max_new=2))
        c1 = late.result(timeout=WAIT_S)
        c0 = first.result(timeout=WAIT_S)
        assert c1.arrival_s >= 0.05
        assert c1.first_token_s >= c1.arrival_s
        assert c1.ttft_s <= c0.finish_s


def test_asyncio_surface(model):
    eng = _engine(model, max_len=64, max_slots=2).start()

    async def scenario():
        h = await eng.asubmit(_req(0))
        c = await asyncio.wait_for(h.aresult(), WAIT_S)
        assert c.finish_reason == "length" and len(c.tokens) == 6

        async def collect(r):
            return [t async for t in eng.astream(r)]
        assert len(await asyncio.wait_for(collect(_req(1)), WAIT_S)) == 6
        a, b = await asyncio.wait_for(asyncio.gather(
            collect(_req(2)), collect(_req(3, plen=12))), WAIT_S)
        assert len(a) == 6 and len(b) == 6

    try:
        asyncio.run(scenario())
    finally:
        eng.shutdown()


def test_asubmit_requires_drain(model):
    eng = _engine(model, max_len=64)

    async def go():
        with pytest.raises(RuntimeError, match="start"):
            await eng.asubmit(_req(0))

    asyncio.run(go())
