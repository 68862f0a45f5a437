"""The port's prefix-cache service against the reference's.

tests/test_prefix_cache_service.py in the port, on the ``cm-scan``
weights of the golden fixture (the shapes of that file's tiny config):

* a parked chain outlives its request and is re-hit by a cold admission
  in a later drain; under allocation pressure a parked chain is
  evicted and no live request is preempted; a tenant over its byte
  quota evicts only its own chains; one prompt under two tenants never
  shares blocks. Tokens and counters (``prefix_hits``,
  ``prefill_tokens_saved``, ``victim_hits``, ``victim_evictions``, the
  parked bytes per tenant) must be JAX's, as the fixture holds them
  (tests/test_torch_golden.py holds the fixture to JAX);
* eviction order (weighted-LRU and LRU) and the policy registry, on the
  port's copy of ``VictimCache``;
* save and restore round-trip bit for bit; the JAX-saved
  ``golden_prefix.npz`` restores into a torch engine and a torch-saved
  file into a JAX engine, each replaying JAX's next-run tokens; a file
  of another geometry is refused as the reference refuses it.
"""
from __future__ import annotations

import json
import os

import pytest

from repro_torch.models.config import ModelConfig
from repro_torch.runtime.engine import Engine, EngineConfig
from repro_torch.runtime.policies import (LruEviction, WeightedLruEviction,
                                          make_victim_eviction)
from repro_torch.runtime.scheduler import Request, VictimCache
from repro_torch.runtime.scheduler.prefix_pool import gather_block_rows
from repro_torch.weights import from_jax_params
from test_torch_golden import (CONFIG_KW, GOLDEN_PREFIX, SERVICE,
                               SERVICE_CONFIG, SERVICE_ENGINE,
                               SERVICE_RESTORE, load_golden, params_from,
                               run_restore, run_service, service_prompt,
                               service_wave)

NAME = SERVICE_CONFIG
CFG = ModelConfig(**CONFIG_KW[NAME])
MAX_SLOTS = SERVICE_ENGINE["max_slots"]


@pytest.fixture(scope="module")
def golden():
    g = load_golden()
    n = len(f"{NAME}|params|")
    flat = {k[n:]: v for k, v in g.items() if k.startswith(f"{NAME}|params|")}
    return (from_jax_params(flat, CFG, device="cpu"),
            json.loads(str(g[f"{NAME}|service"])), g)


def _make(model):
    def make(override):
        return Engine(CFG, model, EngineConfig(**{**SERVICE_ENGINE,
                                                  **override}),
                      device="cpu")
    return make


def _prompt(seed, n=20):
    return service_prompt(seed, n, CFG.vocab_size)


def _run(eng, prompts, tenants=None, max_new=8):
    tenants = tenants or [""] * len(prompts)
    outs = eng.generate([Request(i, p, max_new_tokens=max_new, tenant=t)
                         for i, (p, t) in enumerate(zip(prompts, tenants))])
    return [c.tokens for c in sorted(outs, key=lambda c: c.id)]


# -- the reference's scenarios, held to JAX's tokens and counters ----------

def test_victim_chain_survives_completion_and_rehits(golden):
    """Wave 1 drains fully; wave 2 re-sends the prompt and resumes from
    the parked chain: JAX's tokens and counters, victim_hits > 0, the
    same tokens as an engine without a victim cache."""
    model, want, _ = golden
    make = _make(model)
    got = run_service(make, Request, CFG.vocab_size, "rehit")
    assert got == want["rehit"]
    assert got["victim_hits"] > 0 and got["prefill_tokens_saved"] > 0
    assert got["tokens"][0] == got["tokens"][1]
    cold = _run(make({"victim_cache": False}), [_prompt(1)])
    assert cold[0] == got["tokens"][1][0]


def test_victim_off_is_structural_zero(golden):
    """With the victim cache off the same two waves show no cross-drain
    hit, the pool drains to zero and the index dies with its blocks."""
    model, _, _ = golden
    eng = _make(model)({"victim_cache": False})
    p = _prompt(2)
    _run(eng, [p])
    assert eng.scheduler.alloc.in_use == 0
    assert not eng.scheduler.layout._prefix_full
    _run(eng, [p])
    snap = eng.snapshot()["prefix_cache"]
    assert snap["victim_hits"] == 0
    assert "victim_blocks" not in snap


def test_prefix_index_follows_block_lifetime(golden):
    """Entries outlive their drain exactly as long as their blocks: alive
    while parked, gone once evicted under pressure (JAX's counters)."""
    model, want, _ = golden
    eng = _make(model)({"num_blocks": 10})
    override, waves = SERVICE["pressure"]
    assert override == {"num_blocks": 10}
    lay = eng.scheduler.layout
    eng.generate(service_wave(waves[0], CFG.vocab_size, Request))
    parked = set(lay.victim.blocks)
    assert parked and all(b in lay._block_keys for b in parked)
    eng.generate(service_wave(waves[1], CFG.vocab_size, Request))
    assert lay.victim_evictions == want["pressure"]["victim_evictions"] > 0
    assert set(lay._block_keys) == set(lay.victim.blocks)
    assert eng.scheduler.alloc.in_use == len(lay.victim)
    lay.check(set(), MAX_SLOTS)


def test_victim_never_preempts_live_request(golden):
    """A pool where wave 2 fits only if wave 1's parked chain goes:
    eviction, no preemption, JAX's tokens and counters."""
    model, want, _ = golden
    got = run_service(_make(model), Request, CFG.vocab_size, "pressure")
    assert got == want["pressure"]
    assert got["victim_evictions"] > 0 and got["preemptions"] == 0


def test_quota_breach_evicts_only_breaching_tenant(golden):
    """Tenant a's budget covers one block: parking its 3-block chain
    trims a to budget while b's parked chain stays; JAX's numbers."""
    model, want, _ = golden
    got = run_service(_make(model), Request, CFG.vocab_size, "quota")
    assert got == want["quota"]
    quotas = SERVICE["quota"][0]["prefix_cache_tenants"]
    assert got["per_tenant_bytes"]["a"] <= quotas["a"]
    assert got["per_tenant_bytes"]["b"] == 3 * quotas["a"]
    assert got["victim_evictions"] == 2


def test_identical_prompts_never_share_across_tenants(golden):
    """One token sequence under two tenants resolves to disjoint blocks;
    within a tenant it shares. Same tokens, JAX's counters."""
    model, want, _ = golden
    got = run_service(_make(model), Request, CFG.vocab_size, "tenants")
    assert got == want["tenants"]
    assert got["tokens"][0] == got["tokens"][1]
    eng = _make(model)({})
    p = _prompt(13)
    _run(eng, [p], ["a"])
    lay = eng.scheduler.layout
    a_blocks = set(lay.victim.blocks)
    assert lay.match_prefix(p, tenant="b") == ([], 0)
    blks, _ = lay.match_prefix(p, tenant="a")
    assert blks and set(blks) <= a_blocks
    _run(eng, [p], ["b"])
    assert {lay._block_tenant[b] for b in lay.victim.blocks} == {"a", "b"}
    lay.check(set(), MAX_SLOTS)


def test_victim_requires_prefix_cache(golden):
    model, _, _ = golden
    with pytest.raises(ValueError, match="prefix_cache"):
        Engine(CFG, model, EngineConfig(
            max_slots=2, max_len=64, kv_layout="paged", block_size=8,
            num_blocks=16, prefix_cache=False, victim_cache=True),
            device="cpu")


# -- eviction order ---------------------------------------------------------

def _seed_pool(policy):
    """A parked, then revived and re-parked with one hit (stamp 3); B
    parked in between (stamp 2), never hit."""
    vc = VictimCache(block_bytes=64, policy=policy)
    vc.admit([("", 0, 11)])
    vc.admit([("", 0, 22)])
    vc.record_match([11])
    vc.revive(11)
    vc.admit([("", 0, 11)])
    return vc


def test_weighted_lru_keeps_hot_chain():
    assert _seed_pool(WeightedLruEviction()).pick(1, exclude=()) == [22]
    assert _seed_pool(LruEviction()).pick(1, exclude=()) == [22]
    for policy, expect in ((WeightedLruEviction(), 22), (LruEviction(), 11)):
        vc = _seed_pool(policy)
        vc.revive(22)
        vc.admit([("", 0, 22)])          # B newest, still no hit
        assert vc.pick(1, exclude=()) == [expect], policy.name


def test_deeper_pages_evict_first_within_a_chain():
    vc = VictimCache(block_bytes=64)
    vc.admit([("", 0, 5), ("", 1, 6), ("", 2, 7)])
    assert vc.pick(2, exclude=()) == [7, 6]


def test_make_victim_eviction_registry():
    assert isinstance(make_victim_eviction("lru"), LruEviction)
    assert isinstance(make_victim_eviction("weighted-lru"),
                      WeightedLruEviction)
    custom = LruEviction()
    assert make_victim_eviction(custom) is custom
    with pytest.raises(ValueError, match="not in"):
        make_victim_eviction("nope")


# -- persistence --------------------------------------------------------------

def test_save_restore_round_trip_bit_identical(golden, tmp_path):
    """Warm pool -> file -> fresh engine: every parked chain's rows come
    back bit for bit, the tenants' bytes and the books balance, and the
    replay hits the restored blocks with the warm run's tokens."""
    model, _, _ = golden
    make = _make(model)
    e1 = make({})
    prompts = [_prompt(6), _prompt(7, n=24)]
    warm = _run(e1, prompts, ["a", "b"])
    path = os.fspath(tmp_path / "pc.npz")
    assert e1.save_prefix_cache(path) == 2
    assert os.path.exists(path) and os.path.exists(path + ".meta.json")
    e2 = make({})
    assert e2.restore_prefix_cache(path) == len(e1.scheduler.layout.victim)
    l1, l2 = e1.scheduler.layout, e2.scheduler.layout
    assert l2.victim.per_tenant_bytes() == l1.victim.per_tenant_bytes()

    def chains(lay):
        """Every parked block's tenant, page, stamp and rows (bytes)."""
        return sorted(
            (lay._block_tenant[b], e.page, e.stamp,
             tuple(sorted((k, v.tobytes()) for k, v in
                          gather_block_rows(CFG, lay.cache, b).items())))
            for b, e in lay.victim.blocks.items())
    assert chains(l2) == chains(l1)
    l2.check(set(), MAX_SLOTS)
    replay = _run(e2, prompts, ["a", "b"])
    assert e2.snapshot()["prefix_cache"]["victim_hits"] > 0
    assert replay == warm


def test_jax_saved_file_restores_into_torch(golden):
    """The committed file a JAX engine saved, restored into a torch
    engine: the blocks, the replay's tokens and every counter are what
    the JAX engine restored from the same file gave."""
    model, want, _ = golden
    got = run_restore(_make(model), Request, CFG.vocab_size,
                      str(GOLDEN_PREFIX))
    assert got == want["restore"]
    assert got["victim_hits"] > 0


def test_torch_saved_file_restores_into_jax(golden, tmp_path):
    """A torch engine warmed on the restore wave saves; a JAX engine
    restores that file and replays JAX's tokens and counters."""
    from repro.runtime.engine import Engine as JaxEngine
    from repro.runtime.engine import EngineConfig as JaxEngineConfig
    from repro.runtime.scheduler import Request as JaxRequest

    model, want, g = golden
    warm = _make(model)({})
    warm.generate(service_wave(SERVICE_RESTORE, CFG.vocab_size, Request))
    path = os.fspath(tmp_path / "torch_pc.npz")
    warm.save_prefix_cache(path)
    params = params_from(g)(NAME, CFG)

    def make_jax(override):
        return JaxEngine(CFG, params, JaxEngineConfig(**{**SERVICE_ENGINE,
                                                        **override}))
    got = run_restore(make_jax, JaxRequest, CFG.vocab_size, path)
    assert got == want["restore"]


def test_restore_rejects_mismatched_geometry(golden, tmp_path):
    """A file of another block geometry is refused before it touches the
    pool, with the reference's words."""
    from repro.runtime.engine import Engine as JaxEngine
    from repro.runtime.engine import EngineConfig as JaxEngineConfig

    model, _, g = golden
    e1 = _make(model)({})
    _run(e1, [_prompt(8)])
    path = os.fspath(tmp_path / "pc.npz")
    e1.save_prefix_cache(path)
    kw = dict(SERVICE_ENGINE, block_size=4, num_blocks=48)
    e2 = Engine(CFG, model, EngineConfig(**kw), device="cpu")
    with pytest.raises(ValueError, match="block_size") as got:
        e2.restore_prefix_cache(path)
    assert e2.scheduler.alloc.in_use == 0
    jax_eng = JaxEngine(CFG, params_from(g)(NAME, CFG), JaxEngineConfig(**kw))
    with pytest.raises(ValueError) as want:
        jax_eng.restore_prefix_cache(path)
    assert str(got.value) == str(want.value)


def test_restore_into_small_pool_degrades_gracefully(golden, tmp_path):
    """A pool too small for the file loads what fits and stays
    consistent, and still serves."""
    model, _, _ = golden
    e1 = _make(model)({})
    _run(e1, [_prompt(9), _prompt(10, n=32)], ["a", "b"])
    path = os.fspath(tmp_path / "pc.npz")
    e1.save_prefix_cache(path)
    e2 = _make(model)({"num_blocks": 6})        # 5 usable blocks
    e2.restore_prefix_cache(path)
    lay = e2.scheduler.layout
    assert 0 < len(lay.victim) <= 5
    lay.check(set(), MAX_SLOTS)
    _run(e2, [_prompt(9)], ["a"])
    lay.check(set(), MAX_SLOTS)
