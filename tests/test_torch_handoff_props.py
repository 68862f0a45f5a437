"""Paged growth preemption drains in the port's scheduler.

Two requests that each fit the pool alone can evict each other without
end: the last victim is re-admitted on its prompt's blocks, and its
growth evicts the other, older request, which comes back in turn. The
reference's scheduler keeps that cycle. The port makes the reference's
choices until a growth preemption meets a state seen before since the
last completion, and from there until the next completion breaks the
cycle (``ContinuousScheduler._grow_blocks``). Each run here is driven
one step at a time under a step cap, so a livelock fails instead of
hanging:

* the two-request case (prompt 8 + 5 new tokens, prompt 12 + 6, a pool
  of 7 blocks of 4) under both preemption policies, one-shot and with
  a chunked prefill in flight;
* the strategy of the reference's ``test_property_handoff_books_balance``
  (2-6 requests, prompts of 4/6/8/12, 1-6 new tokens, 6-14 blocks, chunk
  0 or 4, 0-3 ``SlotFailure``s) on its 3-unit topology, derandomised;
  each draw is also run without the cycle check (the reference's
  choices): where that run drains it is the port's, admission for
  admission and token for token, and where the port broke a cycle it
  does not drain;
* the reference's own scheduler on the same weights: the pair, and
  three workloads of that strategy from numpy seeds, two that the
  reference drains through a request evicting the one that evicted it
  (the port equals it there), one that it never drains.

Each drain balances the allocator's books, counts one handoff an
admission and gives every request the tokens of its run alone.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.runtime.scheduler import (ContinuousScheduler, Request,
                                           SchedulerConfig, SlotFailure)

CFG = ModelConfig(
    name="handoff-props", arch_type="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=64, dtype="float32",
    param_dtype="float32", attn_chunk=16, remat=False)
MODEL = T.init_params(CFG, 0, device="cpu")
PROMPT_LENS = (4, 6, 8, 12)
STEP_CAP = 2000
# a run without the cycle check, or the reference's, that has not
# drained in this many steps is taken to cycle (the drains here take
# under 60)
CYCLE_CAP = 100
_ALONE: dict = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """A 2-layer d64 model is faster on one thread, and keeps the file to
    seconds beside other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _steps(sched, cap: int):
    """Step ``sched`` until it drains or ``cap`` steps: its completions
    by id, or None."""
    out = []
    for _ in range(cap):
        if sched.done:
            return sorted(out, key=lambda c: c.id)
        out.extend(sched.step_once())
    return sorted(out, key=lambda c: c.id) if sched.done else None


def _drain(sched: ContinuousScheduler, cap: int = STEP_CAP):
    out = _steps(sched, cap)
    if out is None:
        s = sched.stats()
        raise AssertionError(f"not drained in {cap} steps: "
                             f"{s['admissions']} admissions, "
                             f"{s['preemptions']} preemptions")
    return out


def _record(sched, outs) -> tuple:
    """What the port must share with the reference's choices."""
    s = sched.stats()
    return (s["admissions"], s["preemptions"], s["steps"],
            {o.id: o.tokens for o in outs})


def _unchecked(sched: ContinuousScheduler) -> ContinuousScheduler:
    """``sched`` without the cycle check: the reference's choices."""
    sched._breaking_cycle = lambda grower: False
    return sched


def _alone(req: Request) -> list:
    """The request's greedy tokens served by itself in a roomy pool."""
    key = (req.prompt.tobytes(), req.max_new_tokens)
    if key not in _ALONE:
        sched = ContinuousScheduler(CFG, MODEL, SchedulerConfig(
            max_slots=1, max_len=24, paged=True, block_size=4,
            num_blocks=8))
        sched.submit(Request(req.id, req.prompt.copy(),
                             max_new_tokens=req.max_new_tokens))
        _ALONE[key] = _drain(sched)[0].tokens
    return _ALONE[key]


def _check(sched: ContinuousScheduler, outs, reqs) -> None:
    assert [o.id for o in outs] == [r.id for r in reqs]
    for o, r in zip(outs, reqs):
        assert o.finish_reason == "length"
        assert o.tokens == _alone(r), f"request {r.id}"
    sched.alloc.check()
    assert sched.alloc.in_use == 0
    assert not sched.block_tables.any()
    assert sched.core.handoffs == sched.stats()["admissions"]
    assert sched.core.slot_ready == {}


def _pair():
    rng = np.random.RandomState(0)
    return [Request(0, rng.randint(0, CFG.vocab_size, 8).astype(np.int32),
                    max_new_tokens=5),
            Request(1, rng.randint(0, CFG.vocab_size, 12).astype(np.int32),
                    max_new_tokens=6)]


@pytest.mark.parametrize("chunk", [0, 4])
@pytest.mark.parametrize("policy", ["evict-latest", "lowest-priority"])
def test_two_requests_that_evict_each_other_drain(policy, chunk):
    """Each fits the 7-block pool alone; together the reference cycles
    (201 admissions and 200 preemptions in 200 steps)."""
    reqs = _pair()
    sched = ContinuousScheduler(
        CFG, MODEL, SchedulerConfig(max_slots=3, max_len=24, paged=True,
                                    block_size=4, num_blocks=7,
                                    prefill_chunk=chunk, debug=True),
        preemption=policy)
    for r in reqs:
        sched.submit(r)
    outs = _drain(sched, cap=200)
    _check(sched, outs, reqs)
    s = sched.stats()
    assert s["preemptions"] >= 1 and s["steps"] < 40, s


def test_eight_blocks_drain_without_preemption():
    """The control: one more block and the pair never meets."""
    reqs = _pair()
    sched = ContinuousScheduler(CFG, MODEL, SchedulerConfig(
        max_slots=3, max_len=24, paged=True, block_size=4, num_blocks=8))
    for r in reqs:
        sched.submit(r)
    outs = _drain(sched, cap=200)
    _check(sched, outs, reqs)
    assert sched.stats()["preemptions"] == 0


@settings(max_examples=150, deadline=None)
@given(data=st.data())
def test_property_handoff_books_balance_drains(data):
    """The reference property test's workloads on the port: a tight
    paged pool, failures, a prefill unit and two decode stages."""
    rng = np.random.RandomState(data.draw(st.integers(0, 2 ** 16),
                                          label="seed"))
    n_req = data.draw(st.integers(2, 6), label="n_req")
    chunk = data.draw(st.sampled_from([0, 4]), label="prefill_chunk")
    num_blocks = data.draw(st.integers(6, 14), label="num_blocks")
    placement = data.draw(st.sampled_from(["round-robin", "least-loaded"]),
                          label="placement")
    policy = data.draw(st.sampled_from(["evict-latest", "lowest-priority"]),
                       label="policy")
    reqs = [Request(i, rng.randint(0, CFG.vocab_size,
                                   PROMPT_LENS[i % len(PROMPT_LENS)]
                                   ).astype(np.int32),
                    max_new_tokens=int(rng.randint(1, 7)),
                    priority=int(rng.randint(0, 2)))
            for i in range(n_req)]
    n_fail = data.draw(st.integers(0, 3), label="n_fail")
    failures = [SlotFailure(step=data.draw(st.integers(0, 20),
                                           label=f"fail_step{i}"),
                            slots=data.draw(st.sampled_from(
                                [None, (0,), (0, 1)]), label=f"fail_slots{i}"))
                for i in range(n_fail)]
    def make():
        sched = ContinuousScheduler(
            CFG, MODEL, SchedulerConfig(
                max_slots=3, max_len=24, paged=True, block_size=4,
                num_blocks=num_blocks, prefill_chunk=chunk, debug=True,
                units=3, prefill_units=1, decode_stages=2,
                placement=placement),
            failures=failures, preemption=policy)
        for r in reqs:
            sched.submit(Request(r.id, r.prompt.copy(),
                                 max_new_tokens=r.max_new_tokens,
                                 priority=r.priority))
        return sched
    sched = make()
    outs = _drain(sched)
    _check(sched, outs, reqs)
    summary = sched.core.summary()
    assert summary["kv_handoffs"] == sched.core.handoffs
    assert summary["modeled_makespan_s"] <= \
        summary["modeled_sequential_s"] + 1e-9
    # the port parts from the reference's choices only where they cycle
    plain = _unchecked(make())
    plain_outs = _steps(plain, CYCLE_CAP)
    if sched.cycles_broken:
        assert plain_outs is None
    else:
        assert _record(plain, plain_outs) == _record(sched, outs)


def _seeded(seed: int):
    """A workload of the property test's strategy from a numpy seed: the
    scheduler's settings, the preemption policy, the requests and the
    failures."""
    rng = np.random.RandomState(seed)
    n_req = rng.randint(2, 7)
    kw = dict(num_blocks=int(rng.randint(6, 15)),
              prefill_chunk=int(rng.choice([0, 4])),
              placement=str(rng.choice(["round-robin", "least-loaded"])))
    policy = str(rng.choice(["evict-latest", "lowest-priority"]))
    reqs = [(rng.randint(0, CFG.vocab_size, PROMPT_LENS[i % 4]
                         ).astype(np.int32), int(rng.randint(1, 7)),
             int(rng.randint(0, 2))) for i in range(n_req)]
    fails = [(int(rng.randint(0, 21)), [None, (0,), (0, 1)][rng.randint(3)])
             for _ in range(rng.randint(0, 4))]
    return kw, policy, reqs, fails


def _pair_workload(_):
    return (dict(num_blocks=7, prefill_chunk=0, placement="round-robin"),
            "evict-latest", [(r.prompt, r.max_new_tokens, 0)
                             for r in _pair()], [])


@pytest.fixture(scope="module")
def both_models():
    """The reference's config and parameters (``weights.seeded_flat``,
    seed 0) and the port's model carrying the same dict."""
    from repro.models.config import ModelConfig as JConfig
    from repro_torch.weights import from_jax_params, seeded_flat
    from test_torch_golden import unflatten
    jcfg = JConfig(**{k: getattr(CFG, k) for k in (
        "name", "arch_type", "n_layers", "d_model", "n_heads", "n_kv_heads",
        "d_ff", "vocab_size", "dtype", "param_dtype", "attn_chunk",
        "remat")})
    flat = seeded_flat(CFG, 0)
    return jcfg, unflatten(flat), from_jax_params(flat, CFG, device="cpu")


def _run(mod, cfg, params, workload, cap):
    kw, policy, reqs, fails = workload
    sched = mod.ContinuousScheduler(
        cfg, params, mod.SchedulerConfig(
            max_slots=3, max_len=24, paged=True, block_size=4, debug=True,
            units=3, prefill_units=1, decode_stages=2, **kw),
        failures=[mod.SlotFailure(step=s, slots=sl) for s, sl in fails],
        preemption=policy)
    for i, (prompt, n, prio) in enumerate(reqs):
        sched.submit(mod.Request(i, prompt.copy(), max_new_tokens=n,
                                 priority=prio))
    return sched, _steps(sched, cap)


@pytest.mark.parametrize("make,seed,drains", [
    (_pair_workload, None, False), (_seeded, 56, True),
    (_seeded, 139, True), (_seeded, 22, False)],
    ids=["pair", "seed56", "seed139", "seed22"])
def test_equal_to_the_reference_wherever_it_drains(both_models, make, seed,
                                                   drains):
    """Where the reference's scheduler drains (seeds 56 and 139 get there
    through a request evicting the one whose growth evicted it) the port
    makes its choices; where it never drains the port breaks the cycle
    and drains."""
    from repro.runtime import scheduler as JS
    from repro_torch.runtime import scheduler as PS
    jcfg, params, model = both_models
    workload = make(seed)
    ref, ref_outs = _run(JS, jcfg, params, workload, CYCLE_CAP)
    port, outs = _run(PS, CFG, model, workload, STEP_CAP)
    assert (ref_outs is not None) == drains
    assert outs is not None
    if drains:
        assert port.cycles_broken == 0
        assert _record(port, outs) == _record(ref, ref_outs)
    else:
        assert port.cycles_broken >= 1
