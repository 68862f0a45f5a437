"""Parity of the port's decoder (``repro_torch.models.transformer``) with
``repro.models.transformer``: the weight bridge round-trips every leaf,
and prefill logits and caches, then 4 decode steps, match to 1e-4 on the
conformance configs ``cm-scan`` (scan-only depth, untied head) and
``cm-rem`` (scan + remainder, tied), and on ``cm-bias`` (QKV bias, a
vocabulary of 100 that pads to 128, one KV head). Weights are drawn with
numpy in the reference's pytree layout and carried across; norms and
biases are nonzero so that every leaf matters.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as T
from repro.models.config import ModelConfig as JConfig
from repro_torch.models import transformer as PT
from repro_torch.models.config import ModelConfig as PConfig
from repro_torch.weights import flatten, from_jax_params, layer_sources
from test_torch_golden import CONFIG_KW

CONFIGS = dict(CONFIG_KW)
CONFIGS["cm-bias"] = dict(
    name="cm-bias", arch_type="dense", n_layers=3, d_model=32, n_heads=4,
    n_kv_heads=1, d_ff=64, vocab_size=100, dtype="float32",
    param_dtype="float32", attn_chunk=16, remat=False, qkv_bias=True,
    layer_pattern=("attn", "attn"))
MAX_LEN = 16


def np_params(cfg: JConfig, seed: int = 0):
    """Reference-layout params from numpy: per-period stacks under
    ``scan``, the remainder under ``rem``."""
    rng = np.random.RandomState(seed)
    d, h, hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, \
        cfg.resolved_head_dim
    f, vp = cfg.d_ff, cfg.padded_vocab_size

    def n(shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def layer():
        blk = {"wq": n((d, h, hd), d ** -0.5), "wk": n((d, hk, hd), d ** -0.5),
               "wv": n((d, hk, hd), d ** -0.5),
               "wo": n((h, hd, d), (h * hd) ** -0.5), "ln": n((d,), 0.1)}
        if cfg.qkv_bias:
            blk.update(bq=n((h, hd), 0.1), bk=n((hk, hd), 0.1),
                       bv=n((hk, hd), 0.1))
        return {"block": blk,
                "mlp": {"w_gate": n((d, f), d ** -0.5),
                        "w_up": n((d, f), d ** -0.5),
                        "w_down": n((f, d), f ** -0.5), "ln": n((d,), 0.1)}}

    def stacked():
        layers = [layer() for _ in range(cfg.n_periods)]
        return jax.tree.map(lambda *xs: np.stack(xs), *layers)

    params = {"embed": n((vp, d), 0.5), "final_norm": n((d,), 0.1),
              "scan": [stacked() for _ in cfg.layer_pattern],
              "rem": [layer() for _ in cfg.remainder_kinds]}
    if not cfg.tie_embeddings:
        params["lm_head"] = n((d, vp), d ** -0.5)
    return params


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def setup(request):
    kw = CONFIGS[request.param]
    jc, pc = JConfig(**kw), PConfig(**kw)
    params = np_params(jc)
    want = jax.eval_shape(lambda k: T.init_params(jc, k),
                          jax.random.PRNGKey(0))
    assert jax.tree.structure(want) == jax.tree.structure(params)
    assert [x.shape for x in jax.tree.leaves(want)] == \
        [x.shape for x in jax.tree.leaves(params)]
    return jc, pc, params


def _layer_leaf(params, prefix, idx, name):
    node = params
    for part in prefix.split("/") + name.split("."):
        node = node[int(part)] if part.isdigit() else node[part]
    return node[idx] if idx >= 0 else node


@pytest.mark.parametrize("form", ["tree", "flat"])
def test_from_jax_params_round_trips_every_leaf(setup, form):
    jc, pc, params = setup
    src = params if form == "tree" else flatten(params)
    model = from_jax_params(src, pc, device="cpu")
    for li, prefix, idx in layer_sources(pc):
        for name, p in model.layers[li].named_parameters():
            np.testing.assert_array_equal(
                p.numpy(), _layer_leaf(params, prefix, idx, name))
    np.testing.assert_array_equal(model.embed.numpy(), params["embed"])
    np.testing.assert_array_equal(model.final_norm.numpy(),
                                  params["final_norm"])
    if not pc.tie_embeddings:
        np.testing.assert_array_equal(model.lm_head.numpy(),
                                      params["lm_head"])
    assert sum(p.numel() for p in model.parameters()) == \
        sum(x.size for x in jax.tree.leaves(params))


def _jax_cache_layers(cfg, cache):
    """The reference cache pytree as the port's per-layer list."""
    out = [None] * cfg.n_layers
    for li, prefix, idx in layer_sources(cfg):
        kind, i = prefix.split("/")
        c = cache[kind][int(i)]
        out[li] = {k: np.asarray(v[idx] if idx >= 0 else v)
                   for k, v in c.items()}
    return out


def _close(a, b, tol=1e-4):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=tol, atol=tol)


def test_prefill_then_decode_match_jax(setup):
    jc, pc, params = setup
    model = from_jax_params(params, pc, device="cpu")
    rng = np.random.RandomState(5)
    prompt = rng.randint(0, jc.vocab_size, (2, 9)).astype(np.int32)
    jparams = jax.tree.map(jnp.asarray, params)
    jl, jcache, jlen = jax.jit(lambda p, t: T.prefill(
        p, jc, {"tokens": t}, max_len=MAX_LEN))(jparams, jnp.asarray(prompt))
    tl, tcache, tlen = PT.prefill(model, torch.from_numpy(prompt),
                                  max_len=MAX_LEN)
    _close(jl, tl)
    assert np.array_equal(np.asarray(jlen), tlen.numpy())
    for want, got in zip(_jax_cache_layers(pc, jcache), tcache):
        _close(want["k"], got["k"])
        _close(want["v"], got["v"])
    decode = jax.jit(lambda p, t, c, n: T.decode_step(p, jc, t, c, n))
    for _ in range(4):
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        jl, jcache, jlen = decode(jparams, jnp.asarray(tok), jcache, jlen)
        tl, tcache, tlen = PT.decode_step(model, torch.from_numpy(tok),
                                          tcache, tlen)
        _close(jl, tl)
    assert np.array_equal(np.asarray(jlen), tlen.numpy())
    for want, got in zip(_jax_cache_layers(pc, jcache), tcache):
        _close(want["k"], got["k"])
        _close(want["v"], got["v"])
    if pc.padded_vocab_size != pc.vocab_size:
        assert (tl[:, pc.vocab_size:] == -1e30).all()


def test_port_init_params_shapes_and_scales():
    cfg = PConfig(**{**CONFIGS["cm-bias"], "d_model": 64, "d_ff": 256})
    model = PT.init_params(cfg, seed=1, device="cpu")
    again = PT.init_params(cfg, seed=1, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                 again.parameters()))
    assert abs(model.embed.std().item() - 0.02) < 0.002
    blk, mlp = model.layers[0].block, model.layers[0].mlp
    assert abs(blk.wq.std().item() - 64 ** -0.5) < 0.1 * 64 ** -0.5
    assert abs(blk.wo.std().item() - 64 ** -0.5) < 0.1 * 64 ** -0.5
    assert abs(mlp.w_down.std().item() - 256 ** -0.5) < 0.1 * 256 ** -0.5
    assert not blk.bq.any() and not blk.ln.any() and not mlp.ln.any()
    assert model.lm_head.shape == (64, 128)
    assert math.isclose(model.lm_head.std().item(), 0.125, rel_tol=0.1)


def test_compute_cast_keeps_the_config_dtype():
    """bf16 compute: every leaf, the QKV biases included, is held in
    bf16, as the reference's ``cast_params_for_compute`` casts them."""
    kw = {**CONFIGS["cm-bias"], "dtype": "bfloat16"}
    params = np_params(JConfig(**kw))
    model = from_jax_params(params, PConfig(**kw), device="cpu")
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    want = T.cast_params_for_compute(jax.tree.map(jnp.asarray, params),
                                     JConfig(**kw))
    assert {x.dtype for x in jax.tree.leaves(want)} == \
        {jnp.dtype(jnp.bfloat16)}
