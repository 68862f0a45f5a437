"""JAX golden fixture for the PyTorch port: written here, checked here,
replayed on the GPU by ``chip_smoke.py``.

``src/repro_torch/testdata/golden_cm.npz`` holds, for the conformance
configs ``cm-scan`` and ``cm-rem`` (tests/test_conformance_matrix.py):
the reference's params (``repro.runtime.checkpoint`` flat keys), the
conformance workload, the reference's static-bucket (batch) oracle
tokens and finish reasons on it, and the prefill + 4 decode-step logits
of a small batch. The card has no JAX; this file is its only view of
JAX's own numbers. Regenerate with::

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
            "logits_max_len": LOGITS_MAX_LEN}
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
    assert GOLDEN.stat().st_size < 1 << 20


if __name__ == "__main__":
    GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(GOLDEN, **build_golden())
    print(f"wrote {GOLDEN} ({GOLDEN.stat().st_size} bytes)")
