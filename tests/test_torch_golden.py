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
engine on the paged fifo cells of the conformance matrix and on a tight
pool without and with an admission watermark. The card has no JAX; this
file is its only view of JAX's own numbers. Regenerate with::

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
KEY = jax.random.PRNGKey(0)
ENGINE_MAX_LEN = 48
LOGITS_MAX_LEN = 16
DECODE_STEPS = 4
EXTEND_SPLIT = 5            # prompt tokens prefilled before the extend
# tests/test_conformance_matrix.py LAYOUTS, less the victim-cache and
# multi-unit columns (later slices), plus a pool of 7 usable blocks
# without and with an admission watermark (tests/test_engine_lifecycle.py's
# watermark cases on this workload): growth preempts in the first; the
# watermark delays admissions, and the second preempts less
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
}
# the cells whose counters the fixture holds (fifo, evict-latest), and
# the one the golden test recomputes through a JAX engine run
COUNTER_CELLS = ("paged", "paged-chunked", "paged-prefix",
                 "paged-chunked-prefix", "paged-tight",
                 "paged-tight-watermark")
COUNTER_CELL = "paged-chunked-prefix"
COUNTERS = ("prefix_hits", "prefill_tokens_saved", "preemptions")

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


def build_golden(params_of=None):
    """Everything the fixture holds. ``params_of(name, cfg)`` supplies
    each config's params (default: ``init_params`` under ``KEY``)."""
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
        meta["configs"][name] = {**kw, "layer_pattern": list(
            kw.get("layer_pattern", ("attn",)))}
        meta["workload"][name] = specs
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


if __name__ == "__main__":
    GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(GOLDEN, **build_golden())
    print(f"wrote {GOLDEN} ({GOLDEN.stat().st_size} bytes)")
