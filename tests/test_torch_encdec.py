"""The encoder-decoder and the vision frontend on the port against the
reference, on the CPU, in fp32: seamless-m4t-medium's and
llava-next-mistral-7b's smoke configs.

(a) Whole models on weights drawn with numpy, the frontend's embeds
given: ``forward``'s logits, prefill and 4 decode-step logits with every
cache leaf (seamless's ``cross_k`` and ``cross_v``, held in the first
``cross_len`` of ``max_len`` rows, against the reference's rows of
source length), and ``loss_fn``'s loss and every gradient leaf (the
projector's, the encoder's and the cross-attention's among them) within
1e-4 of the reference's; the reference's functions compiled at XLA's
lowest optimisation level (``fast_jit``).
(b) Admission: a vision request whose frontend + prompt + new rows
exceed ``max_len`` is refused, and so is a frontend request without
``embeds`` or an encoder-decoder source longer than ``max_len``;
``to_actor_graph`` refuses both configs (the reference's export drops
the frontend and the encoder).
(c) The serve and train CLIs take both ``--arch`` names with ``--smoke``.
(d) The fixture ``src/repro_torch/testdata/golden_encdec.npz``, which
``chip_smoke.py`` replays on the card, replayed through the port: per
config the weights named by a numpy seed (``weights.seeded_flat``, a
checksum per leaf in the file), ``forward`` logits, prefill and decode
logits, the greedy tokens of the reference's ``forward`` loop and its
``Engine``'s batch records on a workload the file holds (for llava also
its slotted fifo record, at a ``max_len`` that holds frontend, prompt
and new tokens); the port's batch, slotted fifo, paged fifo and 2-stage
decode tokens equal them (llava's slotted fifo record whole, its paged
tokens its slotted ones), and one training step of a narrow variant of
each config on a batch the file holds: loss and every gradient leaf.
The reference's slotted fifo on seamless and its paged fifo on llava
are not held: its layouts build no cross cache and reserve blocks for
the prompt alone. This file runs seamless-m4t-medium's cases and
tests/test_torch_vlm.py llava-next-mistral-7b's, through the
``check_*`` functions here, so that each file stays quick on one core.
The fixture (both configs) is written, and checked against a fresh JAX
computation, only when this file runs as a script::

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/test_torch_encdec.py
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
from repro_torch.launch import serve, train
from repro_torch.models import transformer as PT
from repro_torch.runtime.engine import Engine, EngineConfig
from repro_torch.runtime.scheduler import Request
from repro_torch.weights import flatten, from_jax_params, seeded_flat, to_flat
from test_torch_families import checksums, fast_jit, round_bits
from test_torch_golden import unflatten
from test_torch_hybrid import engine_record, jax_cache_layers, shaped_params

GOLDEN = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "testdata" / "golden_encdec.npz")
TOL = 1e-4
DECODE_STEPS = 4
ARCHS = {"seamless": "seamless_m4t_medium", "llava": "llava_next_mistral_7b"}
SEEDS = {"seamless": 1, "llava": 2}
PROMPT = (2, 13)
SOURCE = 11                 # seamless's source rows: Sq != Sk in cross
# the engine workload: (prompt length, seamless's source rows, new
# tokens); requests 0 and 3 share a batch bucket
SPECS = [(16, 16, 5), (12, 20, 5), (9, 11, 5), (16, 16, 4)]
ENGINE_MAX_LEN = 32         # llava: 8 frontend + 16 prompt + 5 new fit
BLOCK = 4                   # the paged runs' block size
# the training part's narrow variants of the smoke configs
NARROW = dict(d_model=32, n_heads=4, head_dim=8, d_ff=64, vocab_size=64,
              frontend_dim=16)
NARROW_KV = {"seamless": 4, "llava": 2}
TRAIN_SEED = 5
GRAD_BITS = 16              # the fixture's gradients keep 16 bits


def configs(name: str, narrow: bool = False):
    """(reference config, port config) of ``name``'s smoke config, or of
    its narrow variant (the fixture's training part)."""
    jc, pc = jax_config(ARCHS[name]).smoke(), get_config(ARCHS[name]).smoke()
    if narrow:
        kw = dict(NARROW, n_kv_heads=NARROW_KV[name])
        jc, pc = dataclasses.replace(jc, **kw), dataclasses.replace(pc, **kw)
    assert dataclasses.asdict(jc) == dataclasses.asdict(pc)
    return jc, pc


def source_rows(cfg, prompt_len: int, src: int) -> int:
    return cfg.frontend_tokens if cfg.arch_type == "vlm" else src


def model_inputs(cfg, seed: int = 2):
    """The logits run's prompt (B, S) and embeds (B, F, frontend_dim):
    llava's 8 patch rows, seamless's ``SOURCE`` frames."""
    rng = np.random.RandomState(seed)
    prompt = rng.randint(0, cfg.vocab_size, PROMPT).astype(np.int32)
    f = source_rows(cfg, PROMPT[1], SOURCE)
    embeds = rng.standard_normal((PROMPT[0], f, cfg.frontend_dim)) \
        .astype(np.float32)
    return prompt, embeds


def train_batch(cfg, seed: int = TRAIN_SEED):
    """tokens (2, 13), embeds, and labels with -1 on llava's frontend
    rows and on a few prompt positions."""
    prompt, embeds = model_inputs(cfg, seed)
    labels = prompt.copy()
    labels[0, :3] = -1
    if cfg.arch_type == "vlm":
        labels = np.concatenate([np.full((PROMPT[0], cfg.frontend_tokens),
                                         -1, np.int32), labels], axis=1)
    return {"tokens": prompt, "embeds": embeds, "labels": labels}


def specs(cfg):
    """The engine workload as plain dicts, embeds drawn from a seed."""
    rng = np.random.RandomState(7)
    out = []
    for plen, src, new in SPECS:
        prompt = rng.randint(0, cfg.vocab_size, plen)
        embeds = rng.standard_normal(
            (source_rows(cfg, plen, src), cfg.frontend_dim))
        out.append({"prompt": prompt.tolist(), "max_new": new,
                    "embeds": embeds.astype(np.float32)})
    return out


def requests(spec, request_cls):
    return [request_cls(i, np.asarray(s["prompt"], np.int32),
                        max_new_tokens=s["max_new"], embeds=s["embeds"])
            for i, s in enumerate(spec)]


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=msg)


# ---------------------------------------------------------------------------
# the reference's side
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def jitted(cfg, max_len: int):
    """The reference's prefill, decode step, forward and loss gradient
    for ``cfg``, each taking the embeds (``fast_jit``)."""
    return (fast_jit(lambda p, t, e: JT.prefill(
                p, cfg, {"tokens": t, "embeds": e}, max_len=max_len)),
            fast_jit(lambda p, t, c, n: JT.decode_step(p, cfg, t, c, n)),
            fast_jit(lambda p, t, e: JT.forward(
                p, cfg, {"tokens": t, "embeds": e}, train=False)[0]),
            fast_jit(jax.value_and_grad(lambda p, b: JT.loss_fn(p, cfg, b),
                                        has_aux=True)))


def max_len_of(cfg) -> int:
    return PROMPT[1] + cfg.frontend_tokens + DECODE_STEPS + 3


def jax_logits_run(params, cfg, prompt, embeds):
    """Prefill, then greedy decode steps: (fed tokens, logits per step
    (steps + 1, B, V), the last cache as per-layer dicts)."""
    prefill, decode, _, _ = jitted(cfg, max_len_of(cfg))
    logits, cache, clen = prefill(params, jnp.asarray(prompt),
                                  jnp.asarray(embeds))
    fed, out = [], [np.asarray(logits)]
    for _ in range(DECODE_STEPS):
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        fed.append(np.asarray(tok))
        logits, cache, clen = decode(params, tok, cache, clen)
        out.append(np.asarray(logits))
    return np.stack(fed), np.stack(out), jax_cache_layers(cfg, cache)


def jax_forward_greedy(params, cfg, spec):
    """Each request's greedy tokens from the reference's ``forward`` over
    its prompt and the tokens so far (no cache)."""
    fwd = jitted(cfg, 0)[2]
    out = []
    for s in spec:
        toks = list(s["prompt"])
        for _ in range(s["max_new"]):
            logits = fwd(params, jnp.asarray([toks], jnp.int32),
                         jnp.asarray(s["embeds"][None]))
            toks.append(int(jnp.argmax(logits[0, -1])))
        out.append(toks[len(s["prompt"]):])
    return out


def jax_records(params, cfg, name):
    """The reference's records: its ``forward`` loop's greedy tokens, its
    Engine's batch tokens and finish reasons, and for llava its slotted
    fifo record."""
    spec = specs(cfg)
    batch = JEngine(cfg, params, JEngineConfig(
        max_len=ENGINE_MAX_LEN, admission="batch")).generate(
            requests(spec, JRequest))
    out = {"forward": {"tokens": jax_forward_greedy(params, cfg, spec)},
           "batch": {"tokens": [[int(t) for t in c.tokens] for c in batch],
                     "reasons": [c.finish_reason for c in batch]}}
    if name == "llava":
        eng = JEngine(cfg, params, JEngineConfig(
            max_len=ENGINE_MAX_LEN, max_slots=3, admission="fifo"))
        out["slotted"] = engine_record(eng, eng.generate(
            requests(spec, JRequest)))
    return out


def build_golden():
    arrays = {}
    meta = {"configs": {}, "narrow": {}, "seeds": SEEDS, "checksums": {},
            "workload": {},
            "narrow_checksums": {}, "decode_steps": DECODE_STEPS,
            "engine_max_len": ENGINE_MAX_LEN, "block_size": BLOCK,
            "train_seed": TRAIN_SEED, "grad_bits": GRAD_BITS}
    for name in ARCHS:
        jc, pc = configs(name)
        flat = seeded_flat(pc, SEEDS[name])
        params = unflatten(flat)
        prompt, embeds = model_inputs(jc)
        fed, logits, _ = jax_logits_run(params, jc, prompt, embeds)
        fwd = jitted(jc, 0)[2](params, jnp.asarray(prompt),
                               jnp.asarray(embeds))
        arrays.update({f"{name}|prompt": prompt, f"{name}|embeds": embeds,
                       f"{name}|fed": fed, f"{name}|logits": logits,
                       f"{name}|forward_logits": np.asarray(fwd),
                       f"{name}|records": np.asarray(json.dumps(
                           jax_records(params, jc, name)))})
        spec = specs(jc)
        meta["workload"][name] = [{"prompt": s["prompt"],
                                   "max_new": s["max_new"]} for s in spec]
        for i, s in enumerate(spec):
            arrays[f"{name}|workload|embeds|{i}"] = s["embeds"]
        meta["configs"][name] = dataclasses.asdict(jc)
        meta["checksums"][name] = checksums(flat)
        jn, pn = configs(name, narrow=True)
        nflat = seeded_flat(pn, SEEDS[name])
        batch = train_batch(jn)
        (loss, _), grads = jitted(jn, 0)[3](unflatten(nflat), batch)
        for k, v in batch.items():
            arrays[f"{name}|train|batch|{k}"] = v
        arrays[f"{name}|train|loss"] = np.asarray(loss)
        for k, g in flatten(jax.tree.map(np.asarray, grads)).items():
            arrays[f"{name}|train|grads|{k}"] = round_bits(g, GRAD_BITS)
        meta["narrow"][name] = dataclasses.asdict(jn)
        meta["narrow_checksums"][name] = checksums(nflat)
    arrays["meta"] = np.asarray(json.dumps(meta))
    return arrays


# ---------------------------------------------------------------------------
# the port's side
# ---------------------------------------------------------------------------

def port_logits_run(model, prompt, embeds, fed, max_len):
    """The port's prefill and decode steps on the reference's fed
    tokens: (logits (steps + 1, B, V), the last cache)."""
    logits, cache, clen = PT.prefill(model, torch.from_numpy(prompt),
                                     max_len=max_len,
                                     embeds=torch.from_numpy(embeds))
    out = [logits.numpy()]
    for tok in fed:
        logits, cache, clen = PT.decode_step(model, torch.from_numpy(tok),
                                             cache, clen)
        out.append(logits.numpy())
    return np.stack(out), cache


def port_records(model, cfg, name):
    """The port's batch, slotted fifo, paged fifo and 2-stage decode
    runs of ``specs``: {run: engine_record} (batch: tokens and finish
    reasons)."""
    spec = specs(cfg)
    out = {}
    batch = Engine(cfg, model, EngineConfig(
        max_len=ENGINE_MAX_LEN, admission="batch"), device="cpu").generate(
            requests(spec, Request))
    out["batch"] = {"tokens": [[int(t) for t in c.tokens] for c in batch],
                    "reasons": [c.finish_reason for c in batch]}
    for run, kw in (("slotted", {}),
                    ("paged", dict(kv_layout="paged", block_size=BLOCK)),
                    ("staged", dict(units=2, decode_stages=2))):
        eng = Engine(cfg, model, EngineConfig(
            max_len=ENGINE_MAX_LEN, max_slots=3, admission="fifo",
            debug=True, **kw), device="cpu")
        out[run] = engine_record(eng, eng.generate(requests(spec, Request)))
    return out


def narrow_grads(cfg, flat):
    """One ``loss_fn`` gradient of the narrow variant: (loss, flat
    gradients)."""
    model = from_jax_params(flat, cfg, device="cpu", dtype=torch.float32)
    model.requires_grad_(True)
    loss, _ = PT.loss_fn(model, cfg, {k: torch.from_numpy(v) for k, v in
                                      train_batch(cfg).items()})
    loss.backward()
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    return loss.detach(), to_flat(model, grad=True)


def load_golden():
    data = np.load(GOLDEN)
    return {k: data[k] for k in data.files}


def check_smoke_model(name):
    """(a): forward, prefill + 4 decode steps with every cache leaf, and
    the loss with every gradient leaf, within 1e-4 of the reference."""
    jc, pc = configs(name)
    params = shaped_params(jc, seed=1)
    model = from_jax_params(flatten(params), pc, device="cpu",
                            dtype=torch.float32).requires_grad_(True)
    prompt, embeds = model_inputs(jc)
    _, _, forward, grad = jitted(jc, max_len_of(jc))
    with torch.no_grad():
        got, _ = PT.forward(model, pc, {"tokens": torch.from_numpy(prompt),
                                        "embeds": torch.from_numpy(embeds)},
                            train=False)
    want = forward(params, jnp.asarray(prompt), jnp.asarray(embeds))
    assert got.shape == want.shape
    _close(got, want)
    fed, want, want_cache = jax_logits_run(params, jc, prompt, embeds)
    got, cache = port_logits_run(model, prompt, embeds, fed, max_len_of(jc))
    _close(got, want)
    src = embeds.shape[1]
    for li, (g, w) in enumerate(zip(cache, want_cache)):
        cross = sorted(k for k in w if k.startswith("cross"))
        assert cross == (["cross_k", "cross_v"] if jc.n_encoder_layers
                         else [])
        assert sorted(g) == sorted([*w, *(["cross_len"] if cross else [])])
        for k in w:
            rows = g[k].detach()
            if k in cross:
                assert not rows[:, src:].any(), f"layer {li} {k}"
                assert torch.equal(g["cross_len"],
                                   torch.full((PROMPT[0],), src,
                                              dtype=torch.int32))
                rows = rows[:, :src]
            assert rows.shape == w[k].shape
            _close(rows, w[k], msg=f"layer {li} {k}")
    batch = train_batch(jc)
    (jloss, _), jgrads = grad(params, batch)
    loss, _ = PT.loss_fn(model, pc, {k: torch.from_numpy(v)
                                     for k, v in batch.items()})
    loss.backward()
    _close(loss.detach(), jloss)
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    got_g = to_flat(model, grad=True)
    want_g = flatten(jax.tree.map(np.asarray, jgrads))
    assert sorted(got_g) == sorted(want_g)
    assert any(k.startswith("frontend_proj/") for k in want_g)
    if jc.n_encoder_layers:
        assert any(k.startswith("encoder/") for k in want_g)
        assert any("/cross/" in k for k in want_g)
    for k in want_g:
        _close(got_g[k], want_g[k], msg=k)


def _smoke(name):
    cfg = get_config(ARCHS[name]).smoke()
    return cfg, PT.init_params(cfg, 0, device="cpu")


def test_encoder_source_must_fit_the_cross_cache():
    """(b): a seamless source longer than ``max_len`` is refused, by the
    engine and by ``prefill``; without embeds the request is refused."""
    cfg, model = _smoke("seamless")
    eng = Engine(cfg, model, EngineConfig(max_len=20, admission="fifo"),
                 device="cpu")
    with pytest.raises(ValueError, match="exceeds the cross cache"):
        eng.generate([Request(0, np.arange(5, dtype=np.int32),
                              max_new_tokens=2,
                              embeds=np.zeros((21, cfg.frontend_dim)))])
    with pytest.raises(ValueError, match="carries none"):
        eng.generate([Request(1, np.arange(5, dtype=np.int32),
                              max_new_tokens=2)])
    with pytest.raises(ValueError, match="exceeds the cross cache"):
        PT.prefill(model, torch.zeros((1, 5), dtype=torch.int64), max_len=20,
                   embeds=torch.zeros((1, 21, cfg.frontend_dim)))


def check_graph_refusal(name):
    """(b): ``to_actor_graph`` refuses the config, with and without
    weights."""
    cfg, model = _smoke(name)
    for m in (None, model):
        with pytest.raises(ValueError, match="actor-graph export"):
            PT.to_actor_graph(cfg, m, batch=1, seq=8)


def check_clis(name):
    """(c): the serve CLI serves the smoke config (batch, and fifo on the
    paged pool), its ``max_len`` counting the frontend rows; the train
    CLI takes steps with a finite loss."""
    cfg = get_config(ARCHS[name]).smoke()
    argv = ["--arch", ARCHS[name], "--smoke", "--device", "cpu",
            "--requests", "3", "--prompt-len", "12", "--max-new", "3",
            "--slots", "2"]
    for extra in (["--policy", "batch"],
                  ["--policy", "fifo", "--paged", "--block-size", "4"]):
        out = serve.main(argv + extra)
        assert [len(c.tokens) for c in out["completions"]] == [3, 3, 3]
        assert all(c.finish_reason == "length" for c in out["completions"])
    rows = 12 + (cfg.frontend_tokens if cfg.arch_type == "vlm" else 0)
    assert out["kv_stats"]["slotted_kv_reserved_bytes"] == \
        2 * (rows + 3 + 8) * PT.kv_row_bytes(cfg)
    run = train.main(["--arch", ARCHS[name].replace("_", "-"), "--smoke",
                      "--device", "cpu", "--steps", "2", "--batch", "2",
                      "--seq", "16", "--microbatches", "2"])
    assert all(np.isfinite(m["loss"]) for m in run["metrics"])


def check_golden(golden, name):
    """(d): the fixture's weights (their checksums the fixture's) give
    JAX's logits within 1e-4; batch, slotted fifo and paged fifo give
    JAX's greedy tokens (its forward loop's and its batch engine's);
    llava's slotted fifo record is JAX's whole, its paged tokens the
    slotted ones; the narrow variant's loss and gradients are JAX's
    within 1e-4 less the fixture's rounding."""
    meta = json.loads(str(golden["meta"]))
    jc, pc = configs(name)
    assert meta["configs"][name] == json.loads(json.dumps(
        dataclasses.asdict(pc)))
    flat = seeded_flat(pc, meta["seeds"][name])
    assert checksums(flat) == meta["checksums"][name]
    model = from_jax_params(flat, pc, device="cpu")
    prompt, embeds = golden[f"{name}|prompt"], golden[f"{name}|embeds"]
    with torch.no_grad():
        fwd, _ = PT.forward(model, pc, {"tokens": torch.from_numpy(prompt),
                                        "embeds": torch.from_numpy(embeds)},
                            train=False)
    _close(fwd, golden[f"{name}|forward_logits"])
    got, _ = port_logits_run(model, prompt, embeds, golden[f"{name}|fed"],
                             max_len_of(pc))
    _close(got, golden[f"{name}|logits"])
    spec = specs(pc)
    assert meta["workload"][name] == [{"prompt": s["prompt"],
                                       "max_new": s["max_new"]} for s in spec]
    for i, s in enumerate(spec):
        np.testing.assert_array_equal(golden[f"{name}|workload|embeds|{i}"],
                                      s["embeds"])
    want = json.loads(str(golden[f"{name}|records"]))
    got = port_records(model, pc, name)
    assert want["batch"]["tokens"] == want["forward"]["tokens"]
    assert got["batch"] == want["batch"]
    for run in ("slotted", "paged", "staged"):
        assert [r == "length" for r in got[run]["reasons"]] == [True] * 4
        assert got[run]["tokens"] == want["forward"]["tokens"], run
    if name == "llava":
        assert got["slotted"] == want["slotted"]
    jn, pn = configs(name, narrow=True)
    nflat = seeded_flat(pn, meta["seeds"][name])
    assert checksums(nflat) == meta["narrow_checksums"][name]
    for k, v in train_batch(pn).items():
        np.testing.assert_array_equal(golden[f"{name}|train|batch|{k}"], v)
    loss, grads = narrow_grads(pn, nflat)
    _close(loss, golden[f"{name}|train|loss"])
    pre = f"{name}|train|grads|"
    want_g = {k[len(pre):]: v for k, v in golden.items() if k.startswith(pre)}
    assert sorted(grads) == sorted(want_g)
    for k, w in want_g.items():
        slack = np.abs(w).max() * 2.0 ** -GRAD_BITS
        assert np.abs(grads[k] - w).max() <= TOL - slack, k


# ---------------------------------------------------------------------------
# seamless-m4t-medium (llava-next-mistral-7b's: tests/test_torch_vlm.py)
# ---------------------------------------------------------------------------

def test_smoke_model_matches_jax():
    check_smoke_model("seamless")


def test_actor_graph_export_refuses_the_encoder():
    check_graph_refusal("seamless")


def test_serve_and_train_clis_take_the_config():
    check_clis("seamless")


def test_golden_fixture_replays_through_the_port():
    check_golden(load_golden(), "seamless")


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
