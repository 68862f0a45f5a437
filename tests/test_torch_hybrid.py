"""The hybrid families on the port against the reference, on the CPU:
gemma3-1b (5:1 local:global attention, ring caches) and recurrentgemma-9b
(RG-LRU state and local attention), at their smoke sizes in fp32.

(a) Prefill logits, 4 decode steps and every cache leaf (ring rows,
``h``, ``conv``) within 1e-5 of ``T.prefill`` / ``T.decode_step``, for
both smoke configs and for gemma3's with 5 layers (two periods and a
remainder), whose weights (``init_params``' pytree) cross over through
the reference's checkpoint file; and 24 tokens decoded through a window
of 8, step by step.
(b) Prompts of 1 and 2 tokens on recurrentgemma (shorter than the conv's
state, which the reference's decode path does not take) against the
reference's ``forward`` and its greedy loop.
(c) The port's ``Engine`` on the conformance workload against what the
reference's ``Engine`` did, as the fixture records it: tokens, finish
reasons, counters and ``kv_stats`` under fifo and batch, slotted and
paged (gemma3), chunked prefill and prefix sharing (served one-shot,
no hits), 2 decode stages, a ``SlotFailure`` and a pool that preempts;
recurrentgemma refused by the paged layout with the reference's words.
(f) The fixture ``src/repro_torch/testdata/golden_hybrid.npz``, which
``chip_smoke.py`` replays on the card: the two smoke configs' params
(drawn by ``init_params``, zero leaves filled, rounded to bf16 values so
that the file holds 2 bytes a weight; both sides compute in fp32), a
logits run, the conformance workload and JAX's engine records. Written
and checked here; regenerate with::

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/test_torch_hybrid.py
"""
from __future__ import annotations

import dataclasses
import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import transformer as T
from repro.runtime import checkpoint as jax_checkpoint
from repro.runtime.engine import Engine as JEngine
from repro.runtime.engine import EngineConfig as JEngineConfig
from repro.runtime.scheduler import Request as JRequest
from repro.runtime.scheduler import SlotFailure as JSlotFailure
from repro_torch.configs import get_config
from repro_torch.models import transformer as PT
from repro_torch.runtime import checkpoint
from repro_torch.runtime.engine import Engine, EngineConfig
from repro_torch.runtime.scheduler import Request, SlotFailure
from repro_torch.weights import from_jax_params, layer_sources
from test_torch_golden import (flat_params, requests, unflatten,
                               workload_specs)

GOLDEN = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "testdata" / "golden_hybrid.npz")
KEY = jax.random.PRNGKey(3)
ARCHS = {"gemma3": "gemma3_1b", "recurrentgemma": "recurrentgemma_9b"}
TOL = 1e-5
MAX_LEN = 24
PROMPT = (2, 13)                # longer than the smoke window of 8
DECODE_STEPS = 4
ENGINE_MAX_LEN = 48
# the engine cells, as EngineConfig overrides; the paged ones only where
# the config has a global-attention layer. Chunked prefill and prefix
# sharing fall back to one-shot prefill on both configs.
CELLS = {
    "slotted": {},
    "slotted-chunked": dict(prefill_chunk=4),
    "pipelined-decode": dict(units=2, decode_stages=2),
    "slot-failure": {},
    "paged": dict(kv_layout="paged", block_size=8, num_blocks=18),
    "paged-prefix": dict(kv_layout="paged", block_size=8, num_blocks=18,
                         prefix_cache=True),
    "paged-chunked": dict(kv_layout="paged", block_size=8, num_blocks=18,
                          prefill_chunk=4),
    "paged-tight": dict(kv_layout="paged", block_size=8, num_blocks=8),
}
FAILURE = dict(step=3)      # the slot-failure cell's: every active slot
# the cell whose record the fixture test recomputes through one JAX run
CHECKED_CELL = "paged-tight"


def configs(name: str):
    """(reference config, port config) of a smoke family, equal field
    for field; ``gemma3-5l`` is gemma3's with 5 layers."""
    arch = ARCHS[name.split("-")[0]]
    jc, pc = jax_config(arch).smoke(), get_config(arch).smoke()
    if name.endswith("-5l"):
        jc = dataclasses.replace(jc, n_layers=5)
        pc = dataclasses.replace(pc, n_layers=5)
    assert dataclasses.asdict(jc) == dataclasses.asdict(pc)
    return jc, pc


def cells_of(cfg):
    """The cells a config is served in: paged only with an ``attn``
    layer, as the reference's paged layout requires."""
    has_global = any(k == "attn" for k in cfg.layer_kinds)
    return [c for c in CELLS if has_global or not c.startswith("paged")]


def to_bf16_bits(a: np.ndarray) -> np.ndarray:
    """fp32 -> the bf16 bit pattern nearest (round to nearest even)."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def from_bf16_bits(u: np.ndarray) -> np.ndarray:
    return (u.astype(np.uint32) << 16).view(np.float32)


def fixture_params(cfg, key):
    """``init_params`` with every all-zero leaf (norms, biases) filled,
    rounded to bf16 values: a flat dict of fp32 arrays."""
    flat = flat_params(T.init_params(cfg, key))
    rng = np.random.RandomState(0)
    for k, v in sorted(flat.items()):
        if not v.any():
            v = rng.standard_normal(v.shape).astype(np.float32) * 0.1
        flat[k] = from_bf16_bits(to_bf16_bits(v))
    return flat


@functools.lru_cache(maxsize=None)
def jitted(cfg):
    """The reference's prefill (at ``MAX_LEN``), decode step and forward
    for ``cfg``, jitted once for the module."""
    return (jax.jit(lambda p, t: T.prefill(p, cfg, {"tokens": t},
                                           max_len=MAX_LEN)),
            jax.jit(lambda p, t, c, n: T.decode_step(p, cfg, t, c, n)),
            jax.jit(lambda p, t: T.forward(p, cfg, {"tokens": t},
                                           train=False)[0]))


def shaped_params(cfg, seed: int = 0):
    """A pytree shaped as ``init_params(cfg, key)`` (its structure from
    ``jax.eval_shape``, no compile), every leaf N(0, 0.05^2) from numpy
    (about the dense leaves' 1 / sqrt(d_model) at the smoke width), norms
    and biases included."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(lambda k: T.init_params(cfg, k), KEY)
    return jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.05
                                   ).astype(np.float32), shapes)


def jax_logits_run(params, cfg, prompt, steps=DECODE_STEPS):
    """Prefill ``prompt``, then ``steps`` greedy decode steps: (fed tokens,
    logits per step, caches per step as the port's per-layer lists)."""
    prefill, decode, _ = jitted(cfg)
    logits, cache, clen = prefill(params, jnp.asarray(prompt))
    fed, out, caches = [], [np.asarray(logits)], [jax_cache_layers(cfg, cache)]
    for _ in range(steps):
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        fed.append(np.asarray(tok))
        logits, cache, clen = decode(params, tok, cache, clen)
        out.append(np.asarray(logits))
        caches.append(jax_cache_layers(cfg, cache))
    return np.stack(fed), np.stack(out), caches


def jax_cache_layers(cfg, cache):
    """The reference's cache pytree as the port's per-layer list."""
    out = [None] * cfg.n_layers
    for li, prefix, idx in layer_sources(cfg):
        kind, i = prefix.split("/")
        c = cache[kind][int(i)]
        out[li] = {k: np.asarray(v[idx] if idx >= 0 else v)
                   for k, v in c.items()}
    return out


def port_logits_run(model, prompt, fed):
    logits, cache, clen = PT.prefill(model, torch.from_numpy(prompt),
                                     max_len=MAX_LEN)
    out, caches = [logits.numpy()], [_leaves(cache)]
    for tok in fed:
        logits, cache, clen = PT.decode_step(model, torch.from_numpy(tok),
                                             cache, clen)
        out.append(logits.numpy())
        caches.append(_leaves(cache))
    return np.stack(out), caches


def _leaves(cache):
    return [{k: v.clone().numpy() for k, v in c.items()} for c in cache]


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=msg)


def engine_record(eng, outs):
    """What a cell is held to: tokens, finish reasons, every counter and
    the layout's ``kv_stats``."""
    return {"tokens": [[int(t) for t in c.tokens] for c in outs],
            "reasons": [c.finish_reason for c in outs],
            "stats": {k: int(v) for k, v in eng.stats().items()},
            "kv_stats": {k: float(v) for k, v in eng.kv_stats().items()}}


def jax_cell(params, cfg, cell):
    eng = JEngine(cfg, params, JEngineConfig(
        max_len=ENGINE_MAX_LEN, max_slots=3, admission="fifo",
        **CELLS[cell]),
        failures=[JSlotFailure(**FAILURE)] if cell == "slot-failure"
        else None)
    return engine_record(eng, eng.generate(
        requests(workload_specs(cfg.vocab_size), JRequest)))


def port_cell(model, cfg, cell, admission="fifo"):
    eng = Engine(cfg, model, EngineConfig(
        max_len=ENGINE_MAX_LEN, max_slots=3, admission=admission,
        debug=admission != "batch", **CELLS[cell]),
        failures=[SlotFailure(**FAILURE)] if cell == "slot-failure"
        else None, device="cpu")
    return engine_record(eng, eng.generate(
        requests(workload_specs(cfg.vocab_size), Request)))


def build_golden():
    arrays = {}
    meta = {"configs": {}, "workload": {}, "cells": {}, "failure": FAILURE,
            "engine_max_len": ENGINE_MAX_LEN, "max_len": MAX_LEN}
    for i, name in enumerate(ARCHS):
        jc, _ = configs(name)
        flat = fixture_params(jc, jax.random.fold_in(KEY, i))
        params = unflatten(flat)
        for k, v in flat.items():
            arrays[f"{name}|params|{k}"] = to_bf16_bits(v)
        prompt = np.random.RandomState(11 + i).randint(
            0, jc.vocab_size, PROMPT).astype(np.int32)
        fed, logits, _ = jax_logits_run(params, jc, prompt)
        arrays[f"{name}|logits_prompt"] = prompt
        arrays[f"{name}|logits_fed"] = fed
        arrays[f"{name}|logits"] = logits
        specs = workload_specs(jc.vocab_size)
        oracle = JEngine(jc, params, JEngineConfig(
            max_len=ENGINE_MAX_LEN, admission="batch")).generate(
                requests(specs, JRequest))
        cells = {"batch": {"tokens": [[int(t) for t in c.tokens]
                                      for c in oracle],
                           "reasons": [c.finish_reason for c in oracle]}}
        for cell in cells_of(jc):
            cells[cell] = jax_cell(params, jc, cell)
        arrays[f"{name}|cells"] = np.asarray(json.dumps(cells))
        meta["configs"][name] = {**dataclasses.asdict(jc), "layer_pattern":
                                 list(jc.layer_pattern)}
        meta["workload"][name] = specs
        meta["cells"][name] = {c: CELLS[c] for c in cells_of(jc)}
    arrays["meta"] = np.asarray(json.dumps(meta))
    return arrays


def load_golden():
    data = np.load(GOLDEN)
    return {k: data[k] for k in data.files}


def golden_params(golden, name):
    n = len(f"{name}|params|")
    return {k[n:]: from_bf16_bits(v) for k, v in golden.items()
            if k.startswith(f"{name}|params|")}


@pytest.fixture(scope="module")
def golden():
    return load_golden()


@pytest.fixture(scope="module")
def zoo(golden):
    """name -> (reference config, port config, flat params, port model,
    the fixture's engine records)."""
    out = {}
    for name in ARCHS:
        jc, pc = configs(name)
        flat = golden_params(golden, name)
        out[name] = (jc, pc, flat, from_jax_params(flat, pc, device="cpu"),
                     json.loads(str(golden[f"{name}|cells"])))
    return out


# ---------------------------------------------------------------------------
# (a) prefill, decode and the cache leaves against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["gemma3", "recurrentgemma", "gemma3-5l"])
def test_prefill_decode_and_cache_leaves_match_jax(golden, zoo, name,
                                                   tmp_path):
    """On the fixture's params and prompt (whose logits run is JAX's, to
    1e-6: the fixture's first check), and for gemma3 with 5 layers on
    the reference's ``init_params`` written by its checkpoint module and
    read by the port's."""
    if name in zoo:
        jc, pc, flat, model, _ = zoo[name]
        prompt = golden[f"{name}|logits_prompt"]
    else:
        jc, pc = configs(name)
        path = str(tmp_path / "ckpt")
        jax_checkpoint.save(path, shaped_params(jc))
        flat = checkpoint.load_flat(path)
        assert pc.n_periods == 2 and len(pc.remainder_kinds) == 1
        model = from_jax_params(flat, pc, device="cpu")
        prompt = np.random.RandomState(5).randint(
            0, jc.vocab_size, PROMPT).astype(np.int32)
    fed, want, want_caches = jax_logits_run(unflatten(flat), jc, prompt)
    if name in zoo:
        np.testing.assert_array_equal(golden[f"{name}|logits_fed"], fed)
        np.testing.assert_allclose(golden[f"{name}|logits"], want,
                                   rtol=1e-6, atol=1e-6)
    got, got_caches = port_logits_run(model, prompt, fed)
    _close(got, want)
    for step, (gc, wc) in enumerate(zip(got_caches, want_caches)):
        for li, (g, w) in enumerate(zip(gc, wc)):
            assert sorted(g) == sorted(w), (li, sorted(g), sorted(w))
            for k in g:
                assert g[k].shape == w[k].shape and g[k].dtype == w[k].dtype
                _close(g[k], w[k], msg=f"step {step} layer {li} {k}")


def test_ring_cache_wraps_through_decode_as_in_jax(zoo):
    """tests/test_arch_smoke.py's ring test in the port: 4 prompt tokens,
    then 20 decoded through a window of 8 (twice around the ring); each
    step's logits equal the reference's decode step and, to that test's
    limit, its quadratic forward."""
    jc, pc, flat, model, _ = zoo["gemma3"]
    params = unflatten(flat)
    prefill, decode, forward = jitted(jc)
    assert pc.window == 8
    tokens = np.random.RandomState(9).randint(
        0, jc.vocab_size, (PROMPT[0], 24)).astype(np.int32)
    full = np.asarray(forward(params, tokens))
    jl, jcache, jlen = prefill(params, tokens[:, :4])
    tl, tcache, tlen = PT.prefill(model, torch.from_numpy(tokens[:, :4]),
                                  max_len=MAX_LEN)
    for t in range(4, 24):
        _close(tl.numpy(), np.asarray(jl), msg=f"t={t}")
        _close(tl.numpy(), full[:, t - 1], tol=5e-3, msg=f"t={t}")
        tok = tokens[:, t]
        jl, jcache, jlen = decode(params, jnp.asarray(tok), jcache, jlen)
        tl, tcache, tlen = PT.decode_step(model, torch.from_numpy(tok),
                                          tcache, tlen)
    assert tcache[0]["k"].shape[1] == 8


# ---------------------------------------------------------------------------
# (b) short prompts on the recurrent state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2])
def test_short_rglru_prompts_match_forward_and_greedy_loop(zoo, n):
    """A prompt shorter than the conv's W - 1 = 3 rows of state: the
    port pads the tail with the zeros the conv assumes before a
    sequence. Its prefill and 4 decode steps give the logits of the
    reference's ``forward`` over the growing sequence (one call on the
    sequence right-padded to 8 tokens: the model is causal), and its
    greedy tokens those of a greedy loop over ``forward``."""
    jc, pc, flat, model, _ = zoo["recurrentgemma"]
    params = unflatten(flat)
    forward = jitted(jc)[2]
    seq = list(np.random.RandomState(n).randint(0, jc.vocab_size, n))
    logits, cache, clen = PT.prefill(
        model, torch.tensor([seq], dtype=torch.int32), max_len=8)
    assert cache[0]["conv"].shape[1] == pc.rglru_conv_width - 1
    for _ in range(4):
        padded = np.zeros((1, 8), np.int32)
        padded[0, :len(seq)] = seq
        want = np.asarray(forward(params, padded))[0, len(seq) - 1]
        _close(logits[0].numpy(), want)
        nxt = int(np.argmax(want))
        assert int(logits[0].argmax()) == nxt
        seq.append(nxt)
        logits, cache, clen = PT.decode_step(
            model, torch.tensor([nxt], dtype=torch.int32), cache, clen)


# ---------------------------------------------------------------------------
# (c) the Engine against the reference engine's records
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(ARCHS))
def test_engine_cells_match_the_reference_engine(zoo, name):
    """Every cell of the config gives the reference engine's tokens,
    finish reasons, counters and ``kv_stats``; the tokens are the batch
    oracle's (also run here under batch admission). Chunked prefill and
    prefix sharing serve one-shot: no extend call, no prefix hit."""
    jc, pc, flat, model, cells = zoo[name]
    assert sorted(cells) == sorted(["batch"] + cells_of(pc))
    got = port_cell(model, pc, "slotted", admission="batch")
    assert got["tokens"] == cells["batch"]["tokens"]
    assert got["reasons"] == cells["batch"]["reasons"]
    for cell in cells_of(pc):
        got = port_cell(model, pc, cell)
        assert got == cells[cell], cell
        assert got["tokens"] == cells["batch"]["tokens"], cell
        assert got["stats"]["prefix_hits"] == 0
    assert cells["slot-failure"]["stats"]["slot_failures"] > 0
    if "paged-tight" in cells:
        assert cells["paged-tight"]["stats"]["preemptions"] > 0


def test_paged_layout_refuses_a_config_without_global_attention(zoo):
    """recurrentgemma has no ``attn`` layer: the paged layout refuses it
    in the reference's words, and it is served slotted."""
    jc, pc, flat, model, _ = zoo["recurrentgemma"]
    kw = dict(max_len=ENGINE_MAX_LEN, max_slots=3, admission="fifo",
              kv_layout="paged")
    with pytest.raises(ValueError) as want:
        JEngine(jc, unflatten(flat), JEngineConfig(**kw))
    with pytest.raises(ValueError) as got:
        Engine(pc, model, EngineConfig(**kw), device="cpu")
    assert str(got.value) == str(want.value)
    assert "use the slotted layout" in str(got.value)


def test_reused_slot_state_is_overwritten(zoo):
    """tests/test_scheduler.py's ``test_evicted_slot_state_is_zeroed``
    shape on the recurrent state: one slot serves requests in turn, a
    failure re-queues one mid-decode, and every request's tokens equal
    its run alone on a fresh engine; at drain the host mirrors are
    zero."""
    jc, pc, flat, model, _ = zoo["recurrentgemma"]
    specs = workload_specs(pc.vocab_size)[:4]

    def run(reqs, failures=None):
        eng = Engine(pc, model, EngineConfig(max_len=ENGINE_MAX_LEN,
                                             max_slots=1, admission="fifo",
                                             debug=True),
                     failures=failures, device="cpu")
        return eng, [c.tokens for c in eng.generate(reqs)]
    eng, together = run(requests(specs, Request),
                        [SlotFailure(step=2, slots=(0,))])
    alone = [run(requests([s], Request))[1][0] for s in specs]
    assert together == alone
    sched = eng.scheduler
    assert sched.stats()["slot_failures"] == 1
    assert not sched.cache_len.any() and not sched.tokens.any()


# ---------------------------------------------------------------------------
# (f) the fixture
# ---------------------------------------------------------------------------

def test_golden_hybrid_fixture_matches_jax(golden):
    """The fixture is what the reference computes on its params (its
    logits run is checked in the first test): the workload exactly, the
    oracle's tokens JAX's greedy tokens (teacher-forced through one
    ``forward``), and one cell's record recomputed through a JAX engine
    run."""
    from test_torch_golden import teacher_forced_argmax
    meta = json.loads(str(golden["meta"]))
    assert meta["failure"] == json.loads(json.dumps(FAILURE))
    for name in ARCHS:
        jc, _ = configs(name)
        params = unflatten(golden_params(golden, name))
        specs = workload_specs(jc.vocab_size)
        assert meta["workload"][name] == specs
        assert meta["cells"][name] == json.loads(json.dumps(
            {c: CELLS[c] for c in cells_of(jc)}))
        cells = json.loads(str(golden[f"{name}|cells"]))
        tokens = cells["batch"]["tokens"]
        assert [len(t) for t in tokens] == [s["max_new"] for s in specs]
        assert teacher_forced_argmax(params, jc, specs, tokens) == tokens
        if CHECKED_CELL in cells:
            assert jax_cell(params, jc, CHECKED_CELL) == cells[CHECKED_CELL]
    assert GOLDEN.stat().st_size < 6 << 20


if __name__ == "__main__":
    GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(GOLDEN, **build_golden())
    print(f"wrote {GOLDEN} ({GOLDEN.stat().st_size} bytes)")
