"""JAX golden fixture for the PyTorch port: written here, checked here,
replayed on the GPU by ``chip_smoke.py``.

``src/repro_torch/testdata/golden_cm.npz`` holds, for the conformance
configs ``cm-scan`` and ``cm-rem`` (tests/test_conformance_matrix.py):
the reference's params (``repro.runtime.checkpoint`` flat keys), the
conformance workload, the reference's static-bucket (batch) oracle
tokens and finish reasons on it, the prefill + 4 decode-step logits of
a small batch, the per-position logits of the same prompt prefilled 5
tokens and then extended by 4 (``prefill_extend``), and the counters
(prefix hits, prompt tokens saved, preemptions) of the reference's
engine on the paged fifo cells of the conformance matrix (the victim
cache, prefill/decode disaggregation and pipelined decode among them)
and on a tight pool without and with an admission watermark; and, for
``cm-scan``, the tokens and counters of the reference's prefix-cache
service scenarios (``SERVICE``: a parked chain re-hit, eviction under
pressure, a tenant quota breach, one prompt under two tenants) and of a
JAX engine restored from ``golden_prefix.npz``, a ``prefix-victim-v1``
file a JAX engine saved (``SERVICE_RESTORE``). The card has no JAX;
these files are its only view of JAX's own numbers. Regenerate both
with::

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_golden.py
"""
from __future__ import annotations

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from repro.models import transformer as T
from repro.models.config import ModelConfig
from repro.runtime.engine import Engine, EngineConfig
from repro.runtime.scheduler import Request

GOLDEN = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "testdata" / "golden_cm.npz")
# the prefix-victim-v1 file a JAX engine saved (with its .meta.json)
GOLDEN_PREFIX = GOLDEN.with_name("golden_prefix.npz")
KEY = jax.random.PRNGKey(0)
ENGINE_MAX_LEN = 48
LOGITS_MAX_LEN = 16
DECODE_STEPS = 4
EXTEND_SPLIT = 5            # prompt tokens prefilled before the extend
# tests/test_conformance_matrix.py LAYOUTS, plus a pool of 7 usable
# blocks without and with an admission watermark
# (tests/test_engine_lifecycle.py's watermark cases on this workload):
# growth preempts in the first; the watermark delays admissions, and the
# second preempts less
LAYOUTS = {
    "slotted": dict(kv_layout="slotted"),
    "slotted-chunked": dict(kv_layout="slotted", prefill_chunk=4),
    "paged": dict(kv_layout="paged", block_size=8, num_blocks=18),
    "paged-chunked": dict(kv_layout="paged", block_size=8, num_blocks=18,
                          prefill_chunk=4),
    "paged-prefix": dict(kv_layout="paged", block_size=8, num_blocks=18,
                         prefix_cache=True),
    "paged-chunked-prefix": dict(kv_layout="paged", block_size=8,
                                 num_blocks=18, prefill_chunk=4,
                                 prefix_cache=True),
    "paged-tight": dict(kv_layout="paged", block_size=8, num_blocks=8),
    "paged-tight-watermark": dict(kv_layout="paged", block_size=8,
                                  num_blocks=8, watermark=2),
    "paged-prefix-victim": dict(kv_layout="paged", block_size=8,
                                num_blocks=18, prefix_cache=True,
                                victim_cache=True),
    "disagg": dict(kv_layout="paged", block_size=8, num_blocks=18,
                   prefill_chunk=4, units=3, prefill_units=1,
                   decode_stages=2, placement="least-loaded"),
    "pipelined-decode": dict(kv_layout="slotted", units=2,
                             prefill_units=0, decode_stages=2),
}
# the cells whose counters the fixture holds (fifo, evict-latest), and
# the one the golden test recomputes through a JAX engine run
COUNTER_CELLS = ("paged", "paged-chunked", "paged-prefix",
                 "paged-chunked-prefix", "paged-tight",
                 "paged-tight-watermark", "paged-prefix-victim", "disagg",
                 "pipelined-decode")
COUNTER_CELL = "paged-chunked-prefix"
COUNTERS = ("prefix_hits", "prefill_tokens_saved", "preemptions",
            "victim_hits", "victim_evictions")

# tests/test_conformance_matrix.py CONFIGS, as constructor kwargs
CONFIG_KW = {
    "cm-scan": dict(
        name="cm-scan", arch_type="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=64, dtype="float32",
        param_dtype="float32", attn_chunk=16, remat=False),
    "cm-rem": dict(
        name="cm-rem", arch_type="dense", n_layers=3, d_model=48,
        n_heads=4, n_kv_heads=2, d_ff=96, vocab_size=96, dtype="float32",
        param_dtype="float32", attn_chunk=16, remat=False,
        layer_pattern=("attn", "attn"), tie_embeddings=True),
}


# tests/test_prefix_cache_service.py's engine and scenarios on cm-scan
# (the same shapes as its tiny-pc config): each scenario is an engine
# override and waves of (prompt seed, prompt length, tenant, max_new),
# each wave drained before the next
SERVICE_CONFIG = "cm-scan"
SERVICE_BLOCK = 8
SERVICE_ENGINE = dict(max_slots=4, max_len=64, kv_layout="paged",
                      block_size=SERVICE_BLOCK, num_blocks=24,
                      prefix_cache=True, victim_cache=True, debug=True)


def _service_scenarios():
    cfg = ModelConfig(**CONFIG_KW[SERVICE_CONFIG])
    block_bytes = SERVICE_BLOCK * T.kv_row_bytes(cfg)
    return {
        "rehit": ({}, [[(1, 20, "", 8)], [(1, 20, "", 8)]]),
        "pressure": ({"num_blocks": 10},
                     [[(4, 20, "", 8)], [(5, 40, "", 16)]]),
        "quota": ({"prefix_cache_tenants": {"a": block_bytes,
                                            "b": 10 * block_bytes}},
                  [[(11, 24, "b", 8)], [(12, 24, "a", 8)]]),
        "tenants": ({}, [[(13, 20, "a", 8)], [(13, 20, "b", 8)]]),
    }


SERVICE = _service_scenarios()
# warm one engine with this wave, save its prefix cache, restore it into
# a fresh engine and replay the wave
SERVICE_RESTORE = [(6, 20, "a", 8), (7, 24, "b", 8)]


def service_prompt(seed: int, n: int, vocab_size: int) -> np.ndarray:
    """tests/test_prefix_cache_service.py ``_prompt``."""
    return ((np.arange(n, dtype=np.int32) * (seed + 3) + seed)
            % vocab_size).astype(np.int32)


def service_wave(wave, vocab_size: int, request_cls):
    return [request_cls(i, service_prompt(seed, n, vocab_size),
                        max_new_tokens=m, tenant=t)
            for i, (seed, n, t, m) in enumerate(wave)]


def service_record(eng) -> dict:
    """The counters and victim-pool occupancy a scenario is held to."""
    st = eng.stats()
    pc = eng.snapshot()["prefix_cache"]
    return {**{k: int(st[k]) for k in COUNTERS},
            "victim_blocks": int(pc["victim_blocks"]),
            "per_tenant_bytes": {k: int(v) for k, v in
                                 sorted(pc["per_tenant_bytes"].items())}}


def run_service(make_engine, request_cls, vocab_size: int, name: str):
    """One ``SERVICE`` scenario through ``make_engine(overrides)``:
    tokens per wave, then ``service_record``."""
    override, waves = SERVICE[name]
    eng = make_engine(override)
    tokens = [[[int(t) for t in c.tokens] for c in eng.generate(
        service_wave(w, vocab_size, request_cls))] for w in waves]
    return {"tokens": tokens, **service_record(eng)}


def run_restore(make_engine, request_cls, vocab_size: int, path: str):
    """Restore ``path`` into a fresh engine and replay
    ``SERVICE_RESTORE``: blocks restored, replay tokens and record."""
    eng = make_engine({})
    blocks = eng.restore_prefix_cache(path)
    outs = eng.generate(service_wave(SERVICE_RESTORE, vocab_size,
                                     request_cls))
    return {"blocks": int(blocks),
            "tokens": [[int(t) for t in c.tokens] for c in outs],
            **service_record(eng)}


def workload_specs(vocab_size: int):
    """tests/test_conformance_matrix.py ``_workload`` as plain dicts:
    a shared 12-token preamble on most prompts, one single-token budget,
    scrambled priorities and deadlines, and an exact duplicate prompt."""
    rng = np.random.RandomState(7)
    shared = rng.randint(0, vocab_size, 12).astype(np.int32)
    specs = [(5, 6), (12, 4), (8, 9), (16, 5), (7, 1), (9, 8), (12, 7),
             (16, 2), (8, 6), (14, 5)]
    out = []
    for i, (plen, mnew) in enumerate(specs):
        if i % 3 == 0:
            prompt = rng.randint(0, vocab_size, plen).astype(np.int32)
        else:
            tail = rng.randint(0, vocab_size,
                               max(plen - 12, 1)).astype(np.int32)
            prompt = np.concatenate([shared, tail])
        out.append({"prompt": prompt.tolist(), "max_new": mnew,
                    "priority": (i * 7) % 3,
                    "deadline_s": None if i % 4 == 0
                    else 0.01 * ((i * 5) % 4)})
    out.append({"prompt": list(out[1]["prompt"]), "max_new": 3,
                "priority": 0, "deadline_s": None})
    return out


def requests(specs, request_cls):
    return [request_cls(i, np.asarray(s["prompt"], np.int32),
                        max_new_tokens=s["max_new"], priority=s["priority"],
                        deadline_s=s["deadline_s"])
            for i, s in enumerate(specs)]


def flat_params(params):
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        flat[key] = np.asarray(leaf)
    return flat


def logits_run(params, cfg):
    """Prefill a (2, 9) prompt, then 4 greedy decode steps."""
    rng = np.random.RandomState(11)
    prompt = rng.randint(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    logits, cache, clen = jax.jit(lambda p, t: T.prefill(
        p, cfg, {"tokens": t}, max_len=LOGITS_MAX_LEN))(
            params, jnp.asarray(prompt))
    decode = jax.jit(lambda p, t, c, n: T.decode_step(p, cfg, t, c, n))
    steps, fed = [np.asarray(logits)], []
    for _ in range(DECODE_STEPS):
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        fed.append(np.asarray(tok))
        logits, cache, clen = decode(params, tok, cache, clen)
        steps.append(np.asarray(logits))
    return prompt, np.stack(fed), np.stack(steps)


def extend_logits(params, cfg):
    """The ``logits_run`` prompt prefilled ``EXTEND_SPLIT`` tokens, then
    extended by the rest: per-position logits (2, 4, Vp)."""
    rng = np.random.RandomState(11)
    prompt = rng.randint(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    _, cache, clen = jax.jit(lambda p, t: T.prefill(
        p, cfg, {"tokens": t}, max_len=LOGITS_MAX_LEN))(
            params, jnp.asarray(prompt[:, :EXTEND_SPLIT]))
    logits, _, _ = jax.jit(lambda p, t, c, n: T.prefill_extend(
        p, cfg, t, c, n))(params, jnp.asarray(prompt[:, EXTEND_SPLIT:]),
                          cache, clen)
    return np.asarray(logits)


def cell_counters(params, cfg, layout=COUNTER_CELL):
    """The reference engine's counters on the ``layout`` fifo cell of
    the conformance workload."""
    eng = Engine(cfg, params, EngineConfig(
        max_len=ENGINE_MAX_LEN, max_slots=3, admission="fifo",
        **LAYOUTS[layout]))
    eng.generate(requests(workload_specs(cfg.vocab_size), Request))
    st = eng.stats()
    return {k: int(st[k]) for k in COUNTERS}


def jax_service_engine(params, cfg):
    def make(override):
        return Engine(cfg, params, EngineConfig(**{**SERVICE_ENGINE,
                                                   **override}))
    return make


def build_service(params, cfg, prefix_path: Path):
    """JAX's service scenarios, and its save-then-restore replay: writes
    the saved file to ``prefix_path``."""
    make = jax_service_engine(params, cfg)
    out = {name: run_service(make, Request, cfg.vocab_size, name)
           for name in SERVICE}
    warm = make({})
    warm.generate(service_wave(SERVICE_RESTORE, cfg.vocab_size, Request))
    warm.save_prefix_cache(str(prefix_path))
    out["restore"] = run_restore(make, Request, cfg.vocab_size,
                                 str(prefix_path))
    return out


def unflatten(flat):
    """Inverse of ``flat_params`` for dict/list pytrees: numeric path
    components are list indices."""
    tree = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = tree
        for part, nxt in zip(parts, parts[1:]):
            node = node.setdefault(part, {})
        node[parts[-1]] = jnp.asarray(value)

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [fix(node[str(i)]) for i in range(len(node))]
        return {k: fix(v) for k, v in node.items()}
    return fix(tree)


def build_golden(params_of=None, prefix_path: Path = GOLDEN_PREFIX):
    """Everything the fixture holds; writes the JAX-saved prefix-cache
    file to ``prefix_path``. ``params_of(name, cfg)`` supplies each
    config's params (default: ``init_params`` under ``KEY``)."""
    arrays = {}
    meta = {"configs": {}, "workload": {}, "engine_max_len": ENGINE_MAX_LEN,
            "logits_max_len": LOGITS_MAX_LEN, "extend_split": EXTEND_SPLIT,
            "counter_cells": {lay: LAYOUTS[lay] for lay in COUNTER_CELLS}}
    for name, kw in CONFIG_KW.items():
        cfg = ModelConfig(**kw)
        params = params_of(name, cfg) if params_of else \
            T.init_params(cfg, KEY)
        for k, v in flat_params(params).items():
            arrays[f"{name}|params|{k}"] = v
        prompt, fed, logits = logits_run(params, cfg)
        arrays[f"{name}|logits_prompt"] = prompt
        arrays[f"{name}|logits_fed"] = fed
        arrays[f"{name}|logits"] = logits
        arrays[f"{name}|extend_logits"] = extend_logits(params, cfg)
        arrays[f"{name}|counters"] = np.asarray(json.dumps(
            {lay: cell_counters(params, cfg, lay) for lay in COUNTER_CELLS}))
        specs = workload_specs(cfg.vocab_size)
        oracle = Engine(cfg, params, EngineConfig(
            max_len=ENGINE_MAX_LEN, admission="batch")).generate(
                requests(specs, Request))
        arrays[f"{name}|oracle_tokens"] = np.asarray(
            json.dumps([c.tokens for c in oracle]))
        arrays[f"{name}|oracle_reasons"] = np.asarray(
            json.dumps([c.finish_reason for c in oracle]))
        if name == SERVICE_CONFIG:
            arrays[f"{name}|service"] = np.asarray(json.dumps(
                build_service(params, cfg, prefix_path)))
        meta["configs"][name] = {**kw, "layer_pattern": list(
            kw.get("layer_pattern", ("attn",)))}
        meta["workload"][name] = specs
    meta["service"] = {"config": SERVICE_CONFIG, "engine": SERVICE_ENGINE,
                       "scenarios": SERVICE, "restore_wave": SERVICE_RESTORE}
    arrays["meta"] = np.asarray(json.dumps(meta))
    return arrays


def load_golden():
    data = np.load(GOLDEN)
    return {k: data[k] for k in data.files}


def params_from(golden):
    def params_of(name, cfg):
        n = len(f"{name}|params|")
        return unflatten({k[n:]: v for k, v in golden.items()
                          if k.startswith(f"{name}|params|")})
    return params_of


def teacher_forced_argmax(params, cfg, specs, tokens):
    """JAX's greedy choice at every generated position, from one
    ``T.forward`` over each prompt followed by its recorded tokens (the
    batch right-padded: causal attention keeps the padding out of every
    earlier position). Returns, per request, the argmax after the prompt
    and after each recorded token but the last."""
    seqs = [list(s["prompt"]) + t[:-1] for s, t in zip(specs, tokens)]
    width = max(map(len, seqs))
    batch = np.zeros((len(seqs), width), np.int32)
    for i, seq in enumerate(seqs):
        batch[i, :len(seq)] = seq
    logits, _ = jax.jit(lambda p, t: T.forward(p, cfg, {"tokens": t},
                                               train=False))(
        params, jnp.asarray(batch))
    picks = np.asarray(jnp.argmax(logits, axis=-1))
    return [picks[i, len(s["prompt"]) - 1:len(seq)].tolist()
            for i, (s, seq) in enumerate(zip(specs, seqs))]


def test_golden_fixture_matches_jax():
    """The committed fixture is what the reference computes on the
    fixture's params (drawn by ``init_params`` under ``KEY`` when it was
    written): the prefill + decode logits, recomputed, to 1e-6 (XLA's
    CPU code may round the last bit differently on another CPU); the
    workload exactly; and the oracle's tokens are JAX's greedy tokens,
    checked teacher-forced through one ``T.forward`` per config rather
    than by re-running the static-bucket executor (one compile instead
    of one per bucket), with every request run to its full budget."""
    got = load_golden()
    params_of = params_from(got)
    meta = json.loads(str(got["meta"]))
    assert meta["extend_split"] == EXTEND_SPLIT
    assert meta["service"] == json.loads(json.dumps(
        {"config": SERVICE_CONFIG, "engine": SERVICE_ENGINE,
         "scenarios": SERVICE, "restore_wave": SERVICE_RESTORE}))
    assert meta["counter_cells"] == {lay: LAYOUTS[lay]
                                     for lay in COUNTER_CELLS}
    for name, kw in CONFIG_KW.items():
        cfg = ModelConfig(**kw)
        params = params_of(name, cfg)
        specs = workload_specs(cfg.vocab_size)
        assert meta["workload"][name] == specs
        prompt, fed, logits = logits_run(params, cfg)
        np.testing.assert_array_equal(got[f"{name}|logits_prompt"], prompt)
        np.testing.assert_array_equal(got[f"{name}|logits_fed"], fed)
        np.testing.assert_allclose(got[f"{name}|logits"], logits, rtol=1e-6,
                                   atol=1e-6)
        tokens = json.loads(str(got[f"{name}|oracle_tokens"]))
        reasons = json.loads(str(got[f"{name}|oracle_reasons"]))
        assert [len(t) for t in tokens] == [s["max_new"] for s in specs]
        assert reasons == ["length"] * len(specs)
        assert teacher_forced_argmax(params, cfg, specs, tokens) == tokens
        np.testing.assert_allclose(got[f"{name}|extend_logits"],
                                   extend_logits(params, cfg), rtol=1e-6,
                                   atol=1e-6)
    assert GOLDEN.stat().st_size < 1 << 20


def test_golden_counters_match_one_jax_engine_run():
    """The fixture's engine counters are what the reference's engine
    counts on the paged-chunked-prefix fifo cell, for cm-scan (one
    engine run; cm-rem's counters come from the same code)."""
    got = load_golden()
    name = "cm-scan"
    cfg = ModelConfig(**CONFIG_KW[name])
    counters = json.loads(str(got[f"{name}|counters"]))
    assert sorted(counters) == sorted(COUNTER_CELLS)
    want = counters[COUNTER_CELL]
    assert want == cell_counters(params_from(got)(name, cfg), cfg)
    assert want["prefix_hits"] > 0
    assert want["prefill_tokens_saved"] > 0
    for cfg_counters in (counters, json.loads(str(got["cm-rem|counters"]))):
        # the tight pool preempts on growth; its watermark damps that
        assert 0 < cfg_counters["paged-tight-watermark"]["preemptions"] \
            < cfg_counters["paged-tight"]["preemptions"]
        assert cfg_counters["paged-prefix-victim"]["prefix_hits"] > 0


def test_golden_service_matches_jax():
    """The fixture's service numbers are JAX's: the committed
    ``golden_prefix.npz`` restored into a fresh JAX engine replays the
    recorded tokens and counters (one engine run; the scenarios' numbers
    come from the same code)."""
    got = load_golden()
    name = SERVICE_CONFIG
    cfg = ModelConfig(**CONFIG_KW[name])
    want = json.loads(str(got[f"{name}|service"]))
    make = jax_service_engine(params_from(got)(name, cfg), cfg)
    assert run_restore(make, Request, cfg.vocab_size,
                       str(GOLDEN_PREFIX)) == want["restore"]
    assert sorted(want) == sorted([*SERVICE, "restore"])
    assert want["restore"]["victim_hits"] > 0
    assert want["rehit"]["victim_hits"] > 0
    assert want["pressure"]["victim_evictions"] > 0
    assert want["pressure"]["preemptions"] == 0
    assert GOLDEN_PREFIX.stat().st_size < 1 << 19


if __name__ == "__main__":
    GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(GOLDEN, **build_golden())
    print(f"wrote {GOLDEN} ({GOLDEN.stat().st_size} bytes) and "
          f"{GOLDEN_PREFIX} ({GOLDEN_PREFIX.stat().st_size} bytes)")
