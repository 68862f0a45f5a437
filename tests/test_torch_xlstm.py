"""The port's xLSTM blocks (``repro_torch.models.ssm``) against the
reference's (``repro.models.ssm``) on the CPU, in fp32.

Inputs and params come from numpy seeds; the blocks' params are the
xlstm-350m smoke model's layers (one mLSTM, one sLSTM), carried from
the reference's pytree by ``weights.from_jax_params``. Held to 1e-5:
``mlstm_chunkwise`` at S < chunk, at S > chunk with a padded tail, and
from a given state (output and the (C, n, m) state); the port's
chunkwise prompt against its step-by-step ``mlstm_decode``; ``slstm_scan``
from the zero and a given state; each block's prefill (output and
decode state) and decode steps (output and the state advanced in
place). Then 1- and 2-token prompts (shorter than mLSTM's 3-row conv
state, which the reference's decode does not take) on the whole smoke
model against the reference's ``forward`` and its greedy loop, and the
whole smoke model at 1e-4 (``test_torch_families.check_smoke_model``).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.models import ssm as S
from repro_torch.models import transformer as PT
from repro_torch.weights import flatten, from_jax_params
from test_torch_families import check_smoke_model, fast_jit
from test_torch_hybrid import shaped_params

TOL = 1e-5


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=msg)


def _r(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def smoke():
    """(reference config, port config, reference params, port model) of
    xlstm-350m's smoke variant (layers: mlstm, slstm) in fp32."""
    jc, pc = jax_config("xlstm_350m").smoke(), get_config("xlstm_350m").smoke()
    assert pc.layer_kinds == ("mlstm", "slstm")
    params = shaped_params(jc, seed=4)
    return jc, pc, params, from_jax_params(flatten(params), pc, device="cpu")


def block(i: int):
    """Layer ``i``'s block: (reference leaves, the port's module)."""
    jc, pc, params, model = smoke()
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), params["scan"][i]["block"])
    return jp, model.layers[i].block


def _mlstm_inputs(rng, b, s, nh, dh, state):
    q, k, v = (_r(rng, b, s, nh, dh) for _ in range(3))
    log_i = _r(rng, b, s, nh)
    log_f = -np.logaddexp(0, -(_r(rng, b, s, nh) + 2)).astype(np.float32)
    st = None
    if state:
        st = (_r(rng, b, nh, dh, dh), np.abs(_r(rng, b, nh, dh)),
              _r(rng, b, nh))
    return (q, k, v, log_i, log_f), st


@pytest.mark.parametrize("s,chunk,state", [
    (5, 8, False),      # S < chunk: one short chunk
    (21, 8, False),     # S > chunk: 3 chunks, the last padded by 3
    (21, 8, True),      # the same from a given (C, n, m)
    (16, 16, True)])
def test_mlstm_chunkwise_matches_jax(s, chunk, state):
    rng = np.random.RandomState(s + chunk)
    ins, st = _mlstm_inputs(rng, 2, s, 3, 16, state)
    jo, jst = JS.mlstm_chunkwise(
        *map(jnp.asarray, ins),
        None if st is None else tuple(map(jnp.asarray, st)), chunk=chunk)
    po, pst = S.mlstm_chunkwise(
        *map(torch.from_numpy, ins),
        None if st is None else tuple(map(torch.from_numpy, st)),
        chunk=chunk)
    _close(po, jo)
    for name, g, w in zip("Cnm", pst, jst):
        _close(g, w, msg=name)


def _prefill_then_decode(kind, p, x, n_prompt, cfg):
    """Prefill ``x[:, :n_prompt]`` through the block, then decode the
    rest a token at a time: (outputs (B, S, D), the final state)."""
    prefill = {"mlstm": S.mlstm_prefill_cache,
               "slstm": S.slstm_prefill_cache}[kind]
    decode = {"mlstm": S.mlstm_decode, "slstm": S.slstm_decode}[kind]
    out, cache = prefill(p, x[:, :n_prompt], cfg)
    outs = [out]
    for t in range(n_prompt, x.shape[1]):
        outs.append(decode(p, x[:, t:t + 1], cfg, cache=cache))
    return torch.cat(outs, dim=1), cache


@pytest.mark.parametrize("kind,i", [("mlstm", 0), ("slstm", 1)])
def test_block_prefill_and_decode_match_jax(kind, i):
    """A 13-token prompt prefilled, then 6 tokens decoded: each output
    and the decode state (in place on the port) against the reference's
    ``*_prefill_cache`` and ``*_decode``; and the port's prompt run
    chunkwise against its decode steps over the same 19 tokens."""
    jc, pc, _, _ = smoke()
    jp, p = block(i)
    x = _r(np.random.RandomState(i), 2, 19, pc.d_model)
    pre = {"mlstm": JS.mlstm_prefill_cache,
           "slstm": JS.slstm_prefill_cache}[kind]
    dec = {"mlstm": JS.mlstm_decode, "slstm": JS.slstm_decode}[kind]
    jpre = fast_jit(lambda p, x: pre(p, x, jc))
    jdec = fast_jit(lambda p, x, c: dec(p, x, jc, cache=c))
    jout, jcache = jpre(jp, jnp.asarray(x[:, :13]))
    jouts = [jout]
    for t in range(13, 19):
        o, jcache = jdec(jp, jnp.asarray(x[:, t:t + 1]), jcache)
        jouts.append(o)
    got, cache = _prefill_then_decode(kind, p, torch.from_numpy(x), 13, pc)
    _close(got, jnp.concatenate(jouts, axis=1))
    assert sorted(cache) == sorted(jcache)
    for k in cache:
        _close(cache[k], jcache[k], msg=k)
    whole = {"mlstm": S.mlstm_apply, "slstm": S.slstm_apply}[kind](
        p, torch.from_numpy(x), pc)
    _close(got, whole)


@pytest.mark.parametrize("given", [False, True])
def test_slstm_scan_matches_jax(given):
    jp, p = block(1)
    nh, dh = p.gn.shape
    rng = np.random.RandomState(7)
    wx = _r(rng, 2, 17, 4, nh, dh)
    if given:
        st = (_r(rng, 2, nh, dh), np.abs(_r(rng, 2, nh, dh)) + 0.5,
              _r(rng, 2, nh, dh), _r(rng, 2, nh, dh))
    else:
        st = tuple(np.asarray(a) for a in JS._slstm_zero_state(2, nh, dh))
    jh, jst = JS.slstm_scan(jp, jnp.asarray(wx), tuple(map(jnp.asarray, st)))
    ph, pst = S.slstm_scan(p, torch.from_numpy(wx),
                           tuple(torch.from_numpy(np.array(a)) for a in st))
    _close(ph, jh)
    for name, g, w in zip("cnmh", pst, jst):
        _close(g, w, msg=name)


@pytest.mark.parametrize("n", [1, 2])
def test_short_prompts_match_forward_and_greedy_loop(n):
    """A prompt of 1 or 2 tokens leaves mLSTM's conv tail padded with
    leading zeros. Prefill and 4 decode steps give the logits of the
    reference's ``forward`` over the growing sequence (one call on it
    right-padded to 8 tokens: the model is causal), and greedy tokens
    those of a greedy loop over ``forward``."""
    jc, pc, params, model = smoke()
    forward = fast_jit(lambda p, t: JT.forward(p, jc, {"tokens": t},
                                               train=False)[0])
    seq = list(np.random.RandomState(n).randint(0, jc.vocab_size, n))
    logits, cache, clen = PT.prefill(
        model, torch.tensor([seq], dtype=torch.int32), max_len=8)
    assert cache[0]["conv"].shape[1] == S.CONV_WIDTH - 1
    for _ in range(4):
        padded = np.zeros((1, 8), np.int32)
        padded[0, :len(seq)] = seq
        want = np.asarray(forward(params, padded))[0, len(seq) - 1]
        _close(logits[0].numpy(), want, tol=1e-4)
        nxt = int(np.argmax(want))
        assert int(logits[0].argmax()) == nxt
        seq.append(nxt)
        logits, cache, clen = PT.decode_step(
            model, torch.tensor([nxt], dtype=torch.int32), cache, clen)


def test_whole_smoke_model_matches_jax():
    """xlstm-350m's smoke model whole: ``forward``, prefill and decode
    with every state leaf, and ``loss_fn`` with every gradient leaf,
    within 1e-4 of the reference's (tests/test_torch_families.py)."""
    check_smoke_model("xlstm_350m")
