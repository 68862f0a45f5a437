"""Parity of the port's decoder (``repro_torch.models.transformer``) with
``repro.models.transformer``: the weight bridge round-trips every leaf,
and prefill logits and caches, then 4 decode steps, match to 1e-4 on the
conformance configs ``cm-scan`` (scan-only depth, untied head) and
``cm-rem`` (scan + remainder, tied), and on ``cm-bias`` (QKV bias, a
vocabulary of 100 that pads to 128, one KV head). So do the paged
layout's operations (``paged_insert``, ``decode_step`` with block
tables, ``paged_seed`` then ``prefill_extend``, ``paged_copy_block``),
and a prompt prefilled 5 tokens then extended by 4 equals its one-shot
prefill. Weights are drawn with numpy in the reference's pytree layout
and carried across; norms and biases are nonzero so that every leaf
matters.
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
from test_torch_golden import CONFIG_KW, EXTEND_SPLIT, load_golden

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


# the paged cases: blocks of 4 rows, 4 pages a slot (max_len 16), a pool
# of 11 blocks with block 0 the null block; slot 1's last page is
# unallocated (null) and grows before the decode that writes it
BS, POOL = 4, 11
TABLES = np.array([[7, 2, 9, 4], [5, 10, 0, 0]], np.int32)


def _pools_equal(jc, pc, jcache, tcache, tol=1e-4):
    for want, got in zip(_jax_cache_layers(pc, jcache), tcache):
        _close(want["k"][1:], got["k"][1:], tol)   # block 0 takes junk
        _close(want["v"][1:], got["v"][1:], tol)


@pytest.mark.parametrize("name", sorted(CONFIG_KW))
def test_paged_ops_match_jax(name):
    """Two prompts prefilled and inserted page-wise into a shared pool,
    3 decode steps through block tables (with growth into a fresh block),
    a scratch seeded from slot 0's pages and extended by 4 tokens, and a
    copy-on-write block copy: logits, pools and scratch against JAX, on
    the conformance configs."""
    jc, pc = JConfig(**CONFIGS[name]), PConfig(**CONFIGS[name])
    params = np_params(jc)
    model = from_jax_params(params, pc, device="cpu")
    jparams = jax.tree.map(jnp.asarray, params)
    rng = np.random.RandomState(6)
    prompts = [rng.randint(0, jc.vocab_size, (1, n)).astype(np.int32)
               for n in (9, 6)]
    tcache = PT.init_paged_cache(pc, POOL, BS, 2, max_len=MAX_LEN,
                                 device="cpu")
    jcache = T.init_paged_cache(jc, POOL, BS, 2, max_len=MAX_LEN)
    insert = jax.jit(lambda c, rc, ids, slot: T.paged_insert(
        jc, c, rc, ids, slot, block_size=BS))
    prefill = jax.jit(lambda p, t: T.prefill(p, jc, {"tokens": t},
                                             max_len=MAX_LEN))
    first = []
    for slot, prompt in enumerate(prompts):
        ids = TABLES[slot]
        jl, jrc, _ = prefill(jparams, jnp.asarray(prompt))
        tl, trc, _ = PT.prefill(model, torch.from_numpy(prompt),
                                max_len=MAX_LEN)
        jcache = insert(jcache, jrc, jnp.asarray(ids), jnp.int32(slot))
        PT.paged_insert(pc, tcache, trc, ids, slot, block_size=BS)
        first.append(int(np.argmax(np.asarray(jl)[0])))
    _pools_equal(jc, pc, jcache, tcache)
    tables = TABLES.copy()
    clen = np.array([9, 6], np.int32)
    tok = np.array(first, np.int32)
    decode = jax.jit(lambda p, t, c, n, tb: T.decode_step(
        p, jc, t, c, n, block_tables=tb))
    for step in range(3):
        if step == 2:
            tables[1, 2] = 3        # slot 1 grows into page 2 (row 8)
        jl, jcache, _ = decode(jparams, jnp.asarray(tok), jcache,
                               jnp.asarray(clen), jnp.asarray(tables))
        tl, tcache, tlen = PT.decode_step(
            model, torch.from_numpy(tok), tcache, torch.from_numpy(clen),
            block_tables=torch.from_numpy(tables))
        _close(jl, tl)
        assert tlen.tolist() == (clen + 1).tolist()
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        clen = clen + 1
    _pools_equal(jc, pc, jcache, tcache)
    # prefix resume: slot 0's first two pages seed a scratch, which a
    # 4-token extend continues at row 8
    seed_ids = TABLES[0, :2]
    jscratch = jax.jit(lambda c, ids: T.paged_seed(
        jc, T.init_cache(jc, 1, MAX_LEN), c, ids))(jcache,
                                                   jnp.asarray(seed_ids))
    tscratch = PT.paged_seed(pc, PT.init_cache(pc, 1, MAX_LEN, device="cpu"),
                             tcache, seed_ids)
    for want, got in zip(_jax_cache_layers(pc, jscratch), tscratch):
        _close(want["k"], got["k"])
        _close(want["v"], got["v"])
    chunk = prompts[0][:, 5:9]
    start = np.array([8], np.int32)
    jl, jscratch, jlen = jax.jit(lambda p, t, c, n: T.prefill_extend(
        p, jc, t, c, n))(jparams, jnp.asarray(chunk), jscratch,
                         jnp.asarray(start))
    tl, tscratch, tlen = PT.prefill_extend(model, torch.from_numpy(chunk),
                                           tscratch, torch.from_numpy(start))
    _close(jl, tl)
    assert tlen.tolist() == np.asarray(jlen).tolist() == [12]
    for want, got in zip(_jax_cache_layers(pc, jscratch), tscratch):
        _close(want["k"], got["k"])
        _close(want["v"], got["v"])
    # copy-on-write: slot 0's page 1 into the free block 8
    jcache = jax.jit(lambda c: T.paged_copy_block(
        jc, c, jnp.int32(2), jnp.int32(8)))(jcache)
    PT.paged_copy_block(pc, tcache, 2, 8)
    _pools_equal(jc, pc, jcache, tcache)
    assert all(torch.equal(c["k"][8], c["k"][2]) for c in tcache)


def test_prefill_then_extend_equals_one_shot(setup):
    """A prompt prefilled 5 tokens and then extended by 4 gives the
    one-shot prefill's last logits (1e-5, fp32) and caches."""
    _, pc, params = setup
    model = from_jax_params(params, pc, device="cpu")
    rng = np.random.RandomState(11)
    prompt = torch.from_numpy(rng.randint(0, pc.vocab_size, (2, 9))
                              .astype(np.int32))
    one, one_cache, _ = PT.prefill(model, prompt, max_len=MAX_LEN)
    _, cache, clen = PT.prefill(model, prompt[:, :EXTEND_SPLIT],
                                max_len=MAX_LEN)
    ext, cache, clen = PT.prefill_extend(model, prompt[:, EXTEND_SPLIT:],
                                         cache, clen)
    assert clen.tolist() == [9, 9]
    _close(one.numpy(), ext[:, -1], 1e-5)
    for a, b in zip(one_cache, cache):
        _close(a["k"].numpy(), b["k"], 1e-5)
        _close(a["v"].numpy(), b["v"], 1e-5)


@pytest.mark.parametrize("name", sorted(CONFIG_KW))
def test_extend_logits_match_the_golden_fixture(name):
    """The port's 5 + 4 prefill-then-extend logits on the fixture's
    weights against JAX's, as the fixture holds them."""
    golden = load_golden()
    pc = PConfig(**CONFIG_KW[name])
    n = len(f"{name}|params|")
    model = from_jax_params({k[n:]: v for k, v in golden.items()
                             if k.startswith(f"{name}|params|")}, pc,
                            device="cpu")
    prompt = torch.from_numpy(golden[f"{name}|logits_prompt"])
    _, cache, clen = PT.prefill(model, prompt[:, :EXTEND_SPLIT],
                                max_len=MAX_LEN)
    ext, _, _ = PT.prefill_extend(model, prompt[:, EXTEND_SPLIT:], cache,
                                  clen)
    _close(golden[f"{name}|extend_logits"], ext)
