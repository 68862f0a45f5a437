"""Parity of the port's layer functions with ``repro.models.layers``.

Inputs are drawn with numpy from a fixed seed and handed to both the
JAX function and its ``repro_torch`` counterpart. fp32 is held to 1e-5;
the bf16 case to 2e-2 (the frameworks round bf16 at other places).
"""
from __future__ import annotations

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro.models.config import ModelConfig as JConfig
from repro_torch.models import layers as PL
from repro_torch.models.config import ModelConfig as PConfig

RNG_SEED = 3


def _cfgs(**kw):
    base = dict(name="lay", arch_type="dense", n_layers=2, d_model=48,
                n_heads=4, n_kv_heads=2, d_ff=96, vocab_size=100,
                dtype="float32", param_dtype="float32")
    base.update(kw)
    return JConfig(**base), PConfig(**base)


def _np(shape, rng, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(jax_out, torch_out, tol):
    np.testing.assert_allclose(np.asarray(jax_out, np.float32),
                               torch_out.float().numpy(), rtol=tol, atol=tol)


@pytest.mark.parametrize("shape", [(2, 5, 48), (1, 37, 64)])
def test_rms_norm_fp32(shape):
    rng = np.random.RandomState(RNG_SEED)
    x, s = _np(shape, rng), _np(shape[-1:], rng, 0.1)
    _close(JL.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-6),
           PL.rms_norm(torch.from_numpy(x), torch.from_numpy(s), 1e-6), 1e-5)


def test_rms_norm_bf16():
    rng = np.random.RandomState(RNG_SEED)
    x, s = _np((2, 7, 64), rng), _np((64,), rng, 0.1)
    out_j = JL.rms_norm(jnp.asarray(x, jnp.bfloat16),
                        jnp.asarray(s, jnp.bfloat16))
    out_t = PL.rms_norm(torch.from_numpy(x).bfloat16(),
                        torch.from_numpy(s).bfloat16())
    assert out_t.dtype == torch.bfloat16
    _close(out_j, out_t, 2e-2)


@pytest.mark.parametrize("theta,fraction,d", [(1e6, 1.0, 16), (1e4, 1.0, 12),
                                              (1e4, 0.5, 16)])
def test_apply_rope(theta, fraction, d):
    rng = np.random.RandomState(RNG_SEED)
    x = _np((2, 9, 4, d), rng)
    pos = rng.randint(0, 300, (2, 9)).astype(np.int32)
    _close(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta, fraction),
           PL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta,
                         fraction), 1e-5)


def _attn_params(cfg, rng):
    d, h, hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, \
        cfg.resolved_head_dim
    p = {"wq": _np((d, h, hd), rng, 0.1), "wk": _np((d, hk, hd), rng, 0.1),
         "wv": _np((d, hk, hd), rng, 0.1), "wo": _np((h, hd, d), rng, 0.1),
         "ln": _np((d,), rng, 0.1)}
    if cfg.qkv_bias:
        p.update(bq=_np((h, hd), rng), bk=_np((hk, hd), rng),
                 bv=_np((hk, hd), rng))
    return p


def _both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            SimpleNamespace(**{k: torch.from_numpy(v) for k, v in p.items()}))


@pytest.mark.parametrize("bias", [False, True])
def test_qkv(bias):
    jc, pc = _cfgs(qkv_bias=bias)
    rng = np.random.RandomState(RNG_SEED)
    pj, pt = _both(_attn_params(jc, rng))
    x = _np((2, 6, jc.d_model), rng)
    for a, b in zip(JL._qkv(pj, jnp.asarray(x), jc),
                    PL._qkv(pt, torch.from_numpy(x), pc)):
        _close(a, b, 1e-5)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_apply(act):
    jc, pc = _cfgs(act=act)
    rng = np.random.RandomState(RNG_SEED)
    d, f = jc.d_model, jc.d_ff
    pj, pt = _both({"w_gate": _np((d, f), rng, 0.1),
                    "w_up": _np((d, f), rng, 0.1),
                    "w_down": _np((f, d), rng, 0.1),
                    "ln": _np((d,), rng, 0.1)})
    x = _np((2, 5, d), rng)
    _close(JL.mlp_apply(pj, jnp.asarray(x), jc),
           PL.mlp_apply(pt, torch.from_numpy(x), pc), 1e-5)


def test_attn_prefill_cache_and_decode():
    """The attention sublayer end to end: prefill with its cache, then
    one decode step writing in place at cache_len, against the XLA
    path."""
    jc, pc = _cfgs(qkv_bias=True)
    rng = np.random.RandomState(RNG_SEED)
    pj, pt = _both(_attn_params(jc, rng))
    x = _np((2, 7, jc.d_model), rng)
    pos = np.broadcast_to(np.arange(7, dtype=np.int32), (2, 7))
    oj, cj = jax.jit(lambda p, a, ps: JL.attn_prefill_cache(
        p, a, jc, kind="attn", positions=ps, cache_size=12))(
            pj, jnp.asarray(x), jnp.asarray(pos))
    ot, ct = PL.attn_prefill_cache(pt, torch.from_numpy(x), pc, kind="attn",
                                   positions=torch.from_numpy(pos.copy()),
                                   cache_size=12)
    _close(oj, ot, 1e-5)
    _close(cj["k"], ct["k"], 1e-5)
    _close(cj["v"], ct["v"], 1e-5)
    xd = _np((2, 1, jc.d_model), rng)
    clen = np.array([7, 3], np.int32)
    dj, nj = jax.jit(lambda p, a, c, n: JL.attn_decode(
        p, a, jc, kind="attn", cache=c, cache_len=n))(
            pj, jnp.asarray(xd), cj, jnp.asarray(clen))
    dt = PL.attn_decode(pt, torch.from_numpy(xd), pc, kind="attn", cache=ct,
                        cache_len=torch.from_numpy(clen))
    _close(dj, dt, 1e-5)
    _close(nj["k"], ct["k"], 1e-5)       # the port wrote its cache in place
    _close(nj["v"], ct["v"], 1e-5)


def test_attn_extend_writes_rows_and_attends_with_offsets():
    """A chunk extends a cache at per-sequence offsets (B=2, different
    lengths): the output and the cache rows written in place match the
    reference's functional update."""
    jc, pc = _cfgs(qkv_bias=True)
    rng = np.random.RandomState(RNG_SEED)
    pj, pt = _both(_attn_params(jc, rng))
    hk, hd = jc.n_kv_heads, jc.resolved_head_dim
    cache = {"k": _np((2, 16, hk, hd), rng), "v": _np((2, 16, hk, hd), rng)}
    x = _np((2, 4, jc.d_model), rng)
    clen = np.array([3, 9], np.int32)
    oj, cj = jax.jit(lambda p, a, c, n: JL.attn_extend(
        p, a, jc, kind="attn", cache=c, cache_len=n))(
            pj, jnp.asarray(x), {k: jnp.asarray(v) for k, v in cache.items()},
            jnp.asarray(clen))
    ct = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    ot = PL.attn_extend(pt, torch.from_numpy(x), pc, kind="attn", cache=ct,
                        cache_len=torch.from_numpy(clen))
    _close(oj, ot, 1e-5)
    _close(cj["k"], ct["k"], 1e-5)
    _close(cj["v"], ct["v"], 1e-5)


def _pool_case(rng, cfg, n=7, bs=4, b=3, nb=3):
    hk, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    pools = {"k": _np((n, bs, hk, hd), rng), "v": _np((n, bs, hk, hd), rng)}
    # slot 0 free (null block, length 0); slot 1 repeats block 2 past
    # its length; slot 2 writes into its last page
    tables = np.array([[0, 0, 0], [3, 2, 2], [5, 1, 6]], np.int32)[:b, :nb]
    clen = np.array([0, 5, 10], np.int32)[:b]
    return pools, tables, clen


def test_paged_gather_matches_jax():
    jc, _ = _cfgs()
    rng = np.random.RandomState(RNG_SEED)
    pools, tables, _ = _pool_case(rng, jc)
    want = JL.paged_gather(jnp.asarray(pools["k"]), jnp.asarray(tables))
    got = PL.paged_gather(torch.from_numpy(pools["k"]),
                          torch.from_numpy(tables))
    assert got.shape == want.shape
    _close(want, got, 0.0)


def test_attn_decode_paged_matches_jax():
    """One decode step over a pool with null and repeated blocks: the
    output, and the new rows written in place at tables[b, len // bs],
    offset len % bs."""
    jc, pc = _cfgs(qkv_bias=True)
    rng = np.random.RandomState(RNG_SEED)
    pj, pt = _both(_attn_params(jc, rng))
    pools, tables, clen = _pool_case(rng, jc)
    x = _np((3, 1, jc.d_model), rng)
    oj, kj, vj = jax.jit(lambda p, a, kp, vp, t, n: JL.attn_decode_paged(
        p, a, jc, k_pool=kp, v_pool=vp, tables=t, cache_len=n))(
            pj, jnp.asarray(x), jnp.asarray(pools["k"]),
            jnp.asarray(pools["v"]), jnp.asarray(tables), jnp.asarray(clen))
    kt, vt = (torch.from_numpy(pools[k].copy()) for k in "kv")
    ot = PL.attn_decode_paged(pt, torch.from_numpy(x), pc, k_pool=kt,
                              v_pool=vt, tables=torch.from_numpy(tables),
                              cache_len=torch.from_numpy(clen))
    _close(oj[1:], ot[1:], 1e-5)          # slot 0 is free: its row is junk
    # every block but the null block 0 holds what the reference wrote
    _close(kj[1:], kt[1:], 1e-5)
    _close(vj[1:], vt[1:], 1e-5)
