"""The MoE and xLSTM families on the port against the reference, on the
CPU, in fp32: qwen2-moe-a2.7b's, qwen3-moe-235b-a22b's and xlstm-350m's
smoke configs.

(a) Whole models on weights drawn with numpy: ``forward``'s logits and
aux loss, prefill and 4 decode-step logits with every cache leaf, and
``loss_fn``'s loss, ce, aux and every gradient leaf, within 1e-4 of the
reference's (xlstm-350m's in tests/test_torch_xlstm.py, which shares
``check_smoke_model``). The reference's functions are compiled by XLA
at its lowest optimisation level (``fast_jit``).
(b) ``to_actor_graph``: the partitioned logits at every cut equal the
port's ``forward`` bit for bit, on the MoE and the xLSTM smoke configs.
(c) The serve and train CLIs take ``--arch qwen2_moe_a2_7b`` and
``--arch xlstm_350m``.
(d) The fixture ``src/repro_torch/testdata/golden_moe_xlstm.npz``, which
``chip_smoke.py`` replays on the card, replayed through the port on the
CPU: three configs (qwen2-moe's smoke config; a tight-capacity variant
of it, capacity factor 0.25 over 128-token prompts, whose prefills drop
choices past the 32-slot floor; xlstm-350m's smoke config), each with
``forward`` logits and aux, prefill and decode logits, and JAX's
``Engine`` records: tokens, finish reasons and counters under batch and
fifo, and for MoE the paged pool, prefix sharing and chunked prefill
(for xLSTM the paged layout's refusal, in the reference's words); its
training part is one step of the tight variant: loss, ce, aux and every
gradient leaf. The weights are named by a numpy seed
(``weights.seeded_flat``; a checksum per leaf in the file): as bf16 bit
patterns the two configs' weights alone would take 6.6 MB. The
gradients are JAX's rounded to 16 significant bits (a relative error
below 8e-6), which the replay's limit takes off its 1e-4. The file is
written, and checked against a fresh JAX computation, only when this
file runs as a script::

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/test_torch_families.py
"""
from __future__ import annotations

import dataclasses
import functools
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import transformer as JT
from repro.runtime.engine import Engine as JEngine
from repro.runtime.engine import EngineConfig as JEngineConfig
from repro.runtime.scheduler import Request as JRequest
from repro_torch.configs import get_config
from repro_torch.core import Mapping
from repro_torch.launch import serve, train
from repro_torch.models import transformer as PT
from repro_torch.runtime.engine import Engine, EngineConfig
from repro_torch.runtime.scheduler import Request
from repro_torch.runtime.serving import PartitionedServeEngine
from repro_torch.weights import flatten, from_jax_params, seeded_flat, to_flat
from test_torch_golden import requests, unflatten, workload_specs
from test_torch_hybrid import engine_record, jax_cache_layers, shaped_params

GOLDEN = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "testdata" / "golden_moe_xlstm.npz")
TOL = 1e-4
DECODE_STEPS = 4
# the fixture's configs: (arch, MoE overrides), the seed of the weights
CONFIGS = {"qwen2-moe": ("qwen2_moe_a2_7b", {}),
           "qwen2-moe-tight": ("qwen2_moe_a2_7b",
                               dict(capacity_factor=0.25)),
           "xlstm": ("xlstm_350m", None)}
SEEDS = {"qwen2-moe": 1, "qwen2-moe-tight": 1, "xlstm": 2}
# the logits run's prompt (B, S): the tight variant's 128 tokens exceed
# the 32-slot floor of capacity (4 experts, top-2, factor 0.25)
PROMPTS = {"qwen2-moe": (2, 13), "qwen2-moe-tight": (1, 128),
           "xlstm": (2, 13)}
# the engine cells, as EngineConfig overrides (3 slots)
MOE_CELLS = {"slotted": {},
             "paged": dict(kv_layout="paged", block_size=8),
             "paged-prefix": dict(kv_layout="paged", block_size=8,
                                  prefix_cache=True),
             "slotted-chunked": dict(prefill_chunk=4)}
TIGHT_CELLS = {"slotted": {},
               "paged": dict(kv_layout="paged", block_size=16),
               "paged-prefix": dict(kv_layout="paged", block_size=16,
                                    prefix_cache=True),
               "slotted-chunked": dict(prefill_chunk=32)}
CELLS = {"qwen2-moe": MOE_CELLS, "qwen2-moe-tight": TIGHT_CELLS,
         "xlstm": {"slotted": {}}}
ENGINE_MAX_LEN = {"qwen2-moe": 48, "qwen2-moe-tight": 144, "xlstm": 48}
TRAIN = dict(config="qwen2-moe-tight", batch=(2, 128), seed=5)
# the fixture's gradients keep 16 significant bits
GRAD_BITS = 16


def configs(name: str):
    """(reference config, port config) of a fixture config."""
    arch, moe = CONFIGS[name]
    jc, pc = jax_config(arch).smoke(), get_config(arch).smoke()
    if moe:
        jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe, **moe))
        pc = dataclasses.replace(pc, moe=dataclasses.replace(pc.moe, **moe))
    assert dataclasses.asdict(jc) == dataclasses.asdict(pc)
    return jc, pc


def tight_specs(vocab_size: int):
    """The tight variant's workload: 4 prompts of 128 tokens, the first
    three sharing a 64-token preamble, 4 new tokens each."""
    rng = np.random.RandomState(13)
    shared = rng.randint(0, vocab_size, 64)
    out = []
    for i in range(4):
        prompt = rng.randint(0, vocab_size, 128)
        if i < 3:
            prompt[:64] = shared
        out.append({"prompt": prompt.tolist(), "max_new": 4, "priority": 0,
                    "deadline_s": None})
    return out


def specs_of(name: str, vocab_size: int):
    if name == "qwen2-moe-tight":
        return tight_specs(vocab_size)
    return workload_specs(vocab_size)


def checksums(flat) -> dict:
    return {k: float(np.asarray(v, np.float64).sum()) for k, v in flat.items()}


def round_bits(a: np.ndarray, bits: int = GRAD_BITS) -> np.ndarray:
    """fp32 rounded (to nearest even) to ``bits`` significant bits."""
    drop = 24 - bits
    u = np.ascontiguousarray(a, np.float32).view(np.uint32).astype(np.uint64)
    half = (1 << (drop - 1)) - 1
    u = (u + half + ((u >> drop) & 1)) >> drop << drop
    return u.astype(np.uint32).view(np.float32)


def train_batch(vocab_size: int):
    b, s = TRAIN["batch"]
    tokens = np.random.RandomState(TRAIN["seed"]).randint(
        0, vocab_size, (b, s)).astype(np.int32)
    labels = tokens.copy()
    labels[0, :3] = -1
    return {"tokens": tokens, "labels": labels}


# ---------------------------------------------------------------------------
# the reference's side
# ---------------------------------------------------------------------------

# XLA's CPU backend at its lowest optimisation level: these functions
# run a few times on the smoke shapes, so compiling is most of their cost
# (the whole smoke model's gradient: 4.8 s against 11.6 s)
FAST_XLA = {"xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True}


def fast_jit(fn):
    """``jax.jit(fn)`` compiled with ``FAST_XLA``, once per argument
    structure, shapes and dtypes."""
    jitted, compiled = jax.jit(fn), {}

    def call(*args):
        leaves, tree = jax.tree.flatten(args)
        key = (tree, tuple((np.shape(a), str(np.asarray(a).dtype))
                           for a in leaves))
        if key not in compiled:
            compiled[key] = jitted.lower(*args).compile(
                compiler_options=FAST_XLA)
        return compiled[key](*args)
    return call


@functools.lru_cache(maxsize=None)
def jitted(cfg, max_len: int):
    """The reference's prefill, decode step, forward and loss gradient
    for ``cfg``, jitted once (``fast_jit``)."""
    return (fast_jit(lambda p, t: JT.prefill(p, cfg, {"tokens": t},
                                             max_len=max_len)),
            fast_jit(lambda p, t, c, n: JT.decode_step(p, cfg, t, c, n)),
            fast_jit(lambda p, t: JT.forward(p, cfg, {"tokens": t},
                                             train=False)),
            fast_jit(jax.value_and_grad(lambda p, b: JT.loss_fn(p, cfg, b),
                                        has_aux=True)))


def jax_logits_run(params, cfg, prompt, steps=DECODE_STEPS):
    """Prefill ``prompt``, then greedy decode steps: (fed tokens, logits
    per step (steps + 1, B, V), the last cache as per-layer dicts)."""
    prefill, decode, _, _ = jitted(cfg, prompt.shape[1] + steps + 3)
    logits, cache, clen = prefill(params, jnp.asarray(prompt))
    fed, out = [], [np.asarray(logits)]
    for _ in range(steps):
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        fed.append(np.asarray(tok))
        logits, cache, clen = decode(params, tok, cache, clen)
        out.append(np.asarray(logits))
    return np.stack(fed), np.stack(out), jax_cache_layers(cfg, cache)


def jax_cells(params, cfg, name):
    """JAX's engine records of every cell of ``name``, the batch oracle's
    tokens, and for xLSTM the paged layout's refusal."""
    specs = specs_of(name, cfg.vocab_size)
    max_len = ENGINE_MAX_LEN[name]
    oracle = JEngine(cfg, params, JEngineConfig(
        max_len=max_len, admission="batch")).generate(
            requests(specs, JRequest))
    out = {"batch": {"tokens": [[int(t) for t in c.tokens] for c in oracle],
                     "reasons": [c.finish_reason for c in oracle]}}
    for cell, kw in CELLS[name].items():
        eng = JEngine(cfg, params, JEngineConfig(
            max_len=max_len, max_slots=3, admission="fifo", **kw))
        out[cell] = engine_record(eng, eng.generate(
            requests(specs, JRequest)))
    if cfg.moe is None:
        try:
            JEngine(cfg, params, JEngineConfig(
                max_len=max_len, max_slots=3, admission="fifo",
                kv_layout="paged"))
        except ValueError as exc:
            out["paged"] = {"refused": str(exc)}
    return out


def build_golden():
    arrays = {}
    meta = {"configs": {}, "seeds": SEEDS, "checksums": {}, "cells": {},
            "workload": {}, "engine_max_len": ENGINE_MAX_LEN,
            "decode_steps": DECODE_STEPS, "train": TRAIN,
            "grad_bits": GRAD_BITS}
    for name in CONFIGS:
        jc, pc = configs(name)
        flat = seeded_flat(pc, SEEDS[name])
        params = unflatten(flat)
        prompt = np.random.RandomState(11).randint(
            0, jc.vocab_size, PROMPTS[name]).astype(np.int32)
        fed, logits, _ = jax_logits_run(params, jc, prompt)
        fwd, aux = jitted(jc, 0)[2](params, jnp.asarray(prompt))
        arrays.update({f"{name}|logits_prompt": prompt,
                       f"{name}|logits_fed": fed, f"{name}|logits": logits,
                       f"{name}|forward_logits": np.asarray(fwd),
                       f"{name}|forward_aux": np.asarray(aux)})
        arrays[f"{name}|cells"] = np.asarray(json.dumps(
            jax_cells(params, jc, name)))
        meta["configs"][name] = dataclasses.asdict(jc)
        meta["checksums"][name] = checksums(flat)
        meta["workload"][name] = specs_of(name, jc.vocab_size)
        meta["cells"][name] = CELLS[name]
        if name == TRAIN["config"]:
            (loss, m), grads = jitted(jc, 0)[3](params,
                                                train_batch(jc.vocab_size))
            arrays.update({"train|loss": np.asarray(loss),
                           "train|ce": np.asarray(m["ce"]),
                           "train|aux": np.asarray(m["aux"])})
            for k, g in flatten(jax.tree.map(np.asarray, grads)).items():
                arrays[f"train|grads|{k}"] = round_bits(g)
    arrays["meta"] = np.asarray(json.dumps(meta))
    return arrays


# ---------------------------------------------------------------------------
# the port's side
# ---------------------------------------------------------------------------

def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=msg)


def port_logits_run(model, prompt, fed):
    """The port's prefill and decode steps on the reference's fed
    tokens: (logits (steps + 1, B, V), the last cache)."""
    logits, cache, clen = PT.prefill(model, torch.from_numpy(prompt),
                                     max_len=prompt.shape[1] + len(fed) + 3)
    out = [logits.numpy()]
    for tok in fed:
        logits, cache, clen = PT.decode_step(model, torch.from_numpy(tok),
                                             cache, clen)
        out.append(logits.numpy())
    return np.stack(out), cache


def port_cells(model, cfg, name, specs):
    """The port's records of the fixture's cells, as ``jax_cells``."""
    max_len = ENGINE_MAX_LEN[name]
    eng = Engine(cfg, model, EngineConfig(max_len=max_len,
                                          admission="batch"), device="cpu")
    oracle = eng.generate(requests(specs, Request))
    out = {"batch": {"tokens": [[int(t) for t in c.tokens] for c in oracle],
                     "reasons": [c.finish_reason for c in oracle]}}
    for cell, kw in CELLS[name].items():
        eng = Engine(cfg, model, EngineConfig(
            max_len=max_len, max_slots=3, admission="fifo", debug=True,
            **kw), device="cpu")
        out[cell] = engine_record(eng, eng.generate(requests(specs,
                                                             Request)))
    if cfg.moe is None:
        with pytest.raises(ValueError) as exc:
            Engine(cfg, model, EngineConfig(max_len=max_len, max_slots=3,
                                            kv_layout="paged"), device="cpu")
        out["paged"] = {"refused": str(exc.value)}
    return out


@pytest.fixture(scope="module")
def golden():
    data = np.load(GOLDEN)
    return {k: data[k] for k in data.files}


def check_smoke_model(arch: str) -> None:
    """(a): ``forward`` (logits, aux), prefill + 4 decode steps (logits,
    every cache leaf) and ``loss_fn`` (loss, ce, aux, every gradient
    leaf) of ``arch``'s smoke config on one set of weights."""
    jc, pc = jax_config(arch).smoke(), get_config(arch).smoke()
    params = shaped_params(jc, seed=1)
    model = from_jax_params(flatten(params), pc, device="cpu",
                            dtype=torch.float32).requires_grad_(True)
    prompt = np.random.RandomState(2).randint(
        0, jc.vocab_size, (2, 13)).astype(np.int32)
    _, _, forward, grad = jitted(jc, 0)
    jl, jaux = forward(params, jnp.asarray(prompt))
    with torch.no_grad():
        pl, paux = PT.forward(model, pc, {"tokens": torch.from_numpy(prompt)},
                              train=False)
    _close(pl, jl)
    _close(paux, jaux)
    if pc.moe is not None:
        assert float(paux) > 0
    fed, want, want_cache = jax_logits_run(params, jc, prompt)
    got, cache = port_logits_run(model, prompt, fed)
    _close(got, want)
    for li, (g, w) in enumerate(zip(cache, want_cache)):
        assert sorted(g) == sorted(w)
        for k in g:
            assert g[k].dtype == torch.float32 and g[k].shape == w[k].shape
            _close(g[k].detach(), w[k], msg=f"layer {li} {k}")
    batch = train_batch(jc.vocab_size)
    (jloss, jm), jgrads = grad(params, batch)
    loss, m = PT.loss_fn(model, pc, {k: torch.from_numpy(v)
                                     for k, v in batch.items()})
    loss.backward()
    for g, w in ((loss.detach(), jloss), (m["ce"], jm["ce"]),
                 (m["aux"], jm["aux"])):
        _close(g, w)
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    got_g = to_flat(model, grad=True)
    want_g = flatten(jax.tree.map(np.asarray, jgrads))
    assert sorted(got_g) == sorted(want_g)
    for k in want_g:
        _close(got_g[k], want_g[k], msg=k)


@pytest.mark.parametrize("arch", ["qwen2_moe_a2_7b", "qwen3_moe_235b_a22b"])
def test_smoke_model_matches_jax(arch):
    """(a) for the MoE configs; tests/test_torch_xlstm.py runs it for
    xlstm-350m."""
    check_smoke_model(arch)


@pytest.mark.parametrize("arch", ["qwen2_moe_a2_7b", "xlstm_350m"])
def test_partitioned_output_equals_forward(arch):
    """(b): the actor graph cut after every actor gives ``forward``'s
    logits bit for bit (MoE routes per batch row, so a cut changes no
    group)."""
    cfg = get_config(arch).smoke()
    assert cfg.padded_vocab_size == cfg.vocab_size
    model = PT.init_params(cfg, 0, device="cpu")
    tokens = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (1, 12)).astype(np.int32)
    with torch.no_grad():
        mono, _ = PT.forward(model, cfg, {"tokens": torch.from_numpy(tokens)},
                             train=False)
    names = list(PT.to_actor_graph(cfg, batch=1, seq=12).actors)
    for pp in range(1, len(names) + 1):
        mapping = Mapping("m", {n: ("endpoint" if i < pp else "server")
                                for i, n in enumerate(names)})
        got = PartitionedServeEngine(cfg, model, mapping, batch=1,
                                     seq=12).infer(tokens)
        assert torch.equal(got, mono), f"pp={pp}"


@pytest.mark.parametrize("arch", ["qwen2_moe_a2_7b", "xlstm_350m"])
def test_serve_and_train_clis_take_the_families(arch):
    """(c): the serve CLI serves the smoke config (fifo, and for MoE the
    paged pool with prefix sharing and chunks), and the train CLI takes
    steps with finite loss, ce and aux (aux > 0 on MoE)."""
    argv = ["--arch", arch, "--device", "cpu", "--requests", "3",
            "--prompt-len", "12", "--max-new", "3", "--slots", "2",
            "--policy", "fifo"]
    if arch.startswith("qwen2_moe"):
        argv += ["--prefix-cache", "--block-size", "4", "--prefill-chunk", "4"]
    out = serve.main(argv)
    assert [len(c.tokens) for c in out["completions"]] == [3, 3, 3]
    assert all(c.finish_reason == "length" for c in out["completions"])
    if arch.startswith("qwen2_moe"):
        assert out["stats"]["prefix_hits"] > 0
    run = train.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--steps", "2", "--batch", "2", "--seq", "16",
                      "--microbatches", "2", "--log-every", "1"])
    for m in run["metrics"]:
        assert all(np.isfinite(m[k]) for k in ("loss", "ce", "aux"))
        assert (m["aux"] > 0) == arch.startswith("qwen2_moe")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_golden_fixture_replays_through_the_port(golden, name):
    """(d): the port on the fixture's weights (their checksums the
    fixture's) gives JAX's logits (forward, prefill, decode) and aux
    within 1e-4 and JAX's engine records in every cell."""
    meta = json.loads(str(golden["meta"]))
    assert sorted(meta["configs"]) == sorted(CONFIGS)
    jc, pc = configs(name)
    assert meta["configs"][name] == json.loads(json.dumps(
        dataclasses.asdict(pc)))
    flat = seeded_flat(pc, meta["seeds"][name])
    assert checksums(flat) == meta["checksums"][name]
    model = from_jax_params(flat, pc, device="cpu")
    prompt = golden[f"{name}|logits_prompt"]
    with torch.no_grad():
        fwd, aux = PT.forward(model, pc, {"tokens": torch.from_numpy(prompt)},
                              train=False)
    _close(fwd, golden[f"{name}|forward_logits"])
    _close(aux, golden[f"{name}|forward_aux"])
    got, _ = port_logits_run(model, prompt, golden[f"{name}|logits_fed"])
    _close(got, golden[f"{name}|logits"])
    specs = meta["workload"][name]
    assert specs == specs_of(name, pc.vocab_size)
    assert port_cells(model, pc, name, specs) == json.loads(
        str(golden[f"{name}|cells"]))
    if name == "qwen2-moe-tight":           # its prefills drop choices
        roomy = dataclasses.replace(pc, moe=configs("qwen2-moe")[1].moe)
        with torch.no_grad():
            slack = PT.forward(model, roomy, {"tokens": torch.from_numpy(
                prompt)}, train=False)[0]
        assert (slack - fwd).abs().max() > 1e-2


def test_golden_training_part_replays_through_the_port(golden):
    """(d): one step of the tight variant: JAX's loss, ce and aux, and
    every gradient leaf within 1e-4 less the fixture's rounding."""
    meta = json.loads(str(golden["meta"]))
    assert meta["train"] == json.loads(json.dumps(TRAIN))
    _, pc = configs(TRAIN["config"])
    model = from_jax_params(seeded_flat(pc, meta["seeds"][TRAIN["config"]]),
                            pc, device="cpu", dtype=torch.float32)
    model.requires_grad_(True)
    loss, m = PT.loss_fn(model, pc, {k: torch.from_numpy(v) for k, v in
                                     train_batch(pc.vocab_size).items()})
    loss.backward()
    for g, k in ((loss.detach(), "loss"), (m["ce"], "ce"), (m["aux"], "aux")):
        _close(g, golden[f"train|{k}"], msg=k)
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    got_g = to_flat(model, grad=True)
    want_g = {k[len("train|grads|"):]: v for k, v in golden.items()
              if k.startswith("train|grads|")}
    assert sorted(got_g) == sorted(want_g)
    for k, w in want_g.items():
        slack = np.abs(w).max() * 2.0 ** -GRAD_BITS
        assert np.abs(got_g[k] - w).max() <= TOL - slack, k


def recheck(path: Path = GOLDEN) -> None:
    """The file against a fresh JAX computation: equal arrays."""
    data, fresh = np.load(path), build_golden()
    assert sorted(data.files) == sorted(fresh), "the fixture's keys differ"
    for k in fresh:
        if fresh[k].dtype.kind in "fc":
            np.testing.assert_allclose(data[k], fresh[k], rtol=1e-6,
                                       atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(data[k], fresh[k], err_msg=k)


if __name__ == "__main__":
    if "--check" in sys.argv:
        recheck()
        print(f"{GOLDEN} equals a fresh JAX computation")
    else:
        GOLDEN.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(GOLDEN, **build_golden())
        print(f"wrote {GOLDEN} ({GOLDEN.stat().st_size} bytes)")
