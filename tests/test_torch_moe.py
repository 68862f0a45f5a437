"""The port's MoE layer (``repro_torch.models.moe``) against the
reference's (``repro.models.moe``) on the CPU, in fp32.

Both sides take the same numbers: the reference's ``moe_init`` leaves
(and router logits drawn with numpy) carried to the port as numpy
arrays. Held to 1e-5: ``_capacity``; ``route`` (dispatch exactly,
combine and aux) and ``route_indices`` (expert ids, queue positions and
the keep mask exactly; probabilities and aux) on random, all-tie and
capacity-dropping logits; ``moe_apply`` through the einsum and the
gather dispatch and the dense oracle, with and without shared experts
and with capacity that drops tokens. Then the five semantic tests of
tests/test_moe.py, mirrored on the port, and the top-k tie order.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as JM
from repro.models.config import ModelConfig as JConfig
from repro.models.config import MoEConfig as JMoE
from repro_torch.models import moe as M
from repro_torch.models import transformer as PT
from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.weights import flatten

KEY = jax.random.PRNGKey(11)
TOL = 1e-5


def _cfgs(n_experts=4, top_k=2, cf=8.0, shared=0, impl="einsum"):
    """(reference config, port config) of tests/test_moe.py's ``_cfg``."""
    kw = dict(name="moe-test", arch_type="moe", n_layers=2, d_model=64,
              n_heads=4, n_kv_heads=4, d_ff=0, vocab_size=128,
              dtype="float32", param_dtype="float32", moe_impl=impl)
    moe = dict(n_experts=n_experts, top_k=top_k, d_ff_expert=32,
               n_shared_experts=shared, capacity_factor=cf)
    return (JConfig(**kw, moe=JMoE(**moe)),
            ModelConfig(**kw, moe=MoEConfig(**moe)))


def _cfg(**kw):
    return _cfgs(**kw)[1]


def _params(cfg, key=KEY):
    """The reference's ``moe_init`` leaves (norm filled from numpy, so
    that it matters) as (JAX pytree, the port's ``MoE`` module)."""
    jp = jax.tree.map(np.asarray, JM.moe_init(key, cfg, jnp.float32))
    jp["ln"] = np.random.RandomState(1).standard_normal(
        jp["ln"].shape).astype(np.float32) * 0.1
    m = cfg.moe
    shared = PT.MLP(cfg, torch.float32, "cpu",
                    m.d_ff_expert * m.n_shared_experts) \
        if m.n_shared_experts else None
    mod = M.MoE(cfg, torch.float32, "cpu", PT._param, shared)
    flat = flatten(jp)
    with torch.no_grad():
        for name, p in mod.named_parameters():
            key = name.replace(".", "/")
            p.copy_(torch.from_numpy(np.array(flat[key])))
    assert sorted(n.replace(".", "/") for n, _ in mod.named_parameters()) \
        == sorted(flat)
    return jax.tree.map(jnp.asarray, jp), mod


def _x(shape, seed=0):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# logits (G, T, E): random; all tied; one expert favoured (its queue
# overflows a 32-slot capacity, so choices drop)
LOGITS = {"random": lambda g, t, e: _x((g, t, e), 3) * 2.0,
          "all-tie": lambda g, t, e: np.zeros((g, t, e), np.float32),
          "drops": lambda g, t, e: np.concatenate(
              [np.full((g, t, 1), 4.0, np.float32), _x((g, t, e - 1), 4)],
              -1)}


@pytest.mark.parametrize("tokens,cf,experts,top_k", [
    (1, 1.25, 60, 4), (512, 1.25, 60, 4), (128, 1.25, 60, 4),
    (256, 1.25, 128, 8), (2048, 1.25, 60, 4), (128, 0.25, 4, 2),
    (16, 4.0, 4, 2), (4096, 2.0, 8, 2)])
def test_capacity_matches_jax(tokens, cf, experts, top_k):
    jc, pc = _cfgs(n_experts=experts, top_k=top_k, cf=cf)
    assert M._capacity(tokens, pc) == JM._capacity(tokens, jc)
    assert M._capacity(tokens, pc) % 32 == 0


@pytest.mark.parametrize("kind", sorted(LOGITS))
@pytest.mark.parametrize("top_k", [1, 2])
def test_route_and_route_indices_match_jax(kind, top_k):
    jc, pc = _cfgs(n_experts=4, top_k=top_k)
    logits = LOGITS[kind](2, 96, 4)
    cap = 32
    jd, jcomb, jaux = JM.route(jnp.asarray(logits), jc, cap)
    pd, pcomb, paux = M.route(torch.from_numpy(logits), pc, cap)
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
    _close(pcomb, jcomb)
    _close(paux, jaux)
    want = JM.route_indices(jnp.asarray(logits), jc, cap)
    got = M.route_indices(torch.from_numpy(logits), pc, cap)
    for name, g, w in zip(("top_idx", "pos", "keep"), got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    _close(got[3], want[3])
    _close(got[4], want[4])
    if kind == "drops":
        assert not np.asarray(want[2]).all()


@pytest.mark.parametrize("impl", ["einsum", "gather", "oracle"])
@pytest.mark.parametrize("shared,cf", [(0, 8.0), (1, 8.0), (1, 0.25)])
def test_moe_apply_matches_jax(impl, shared, cf):
    """(B=2, S=80) tokens through each dispatch: output and aux; at
    capacity factor 0.25 the 32-slot floor is exceeded and choices drop
    (the oracle ignores capacity)."""
    jc, pc = _cfgs(shared=shared, cf=cf, impl=impl)
    jp, mod = _params(pc)
    x = _x((2, 80, pc.d_model), 5)
    if impl == "oracle":
        jy, jaux = JM.moe_apply_dense_oracle(jp, jnp.asarray(x), jc)
        py, paux = M.moe_apply_dense_oracle(mod, torch.from_numpy(x), pc)
    else:
        jy, jaux = JM.moe_apply(jp, jnp.asarray(x), jc)
        py, paux = M.moe_apply(mod, torch.from_numpy(x), pc)
    _close(py.detach(), jy)
    _close(paux.detach(), jaux)
    if cf < 1:
        h = JM.rms_norm(jnp.asarray(x), jp["ln"], jc.norm_eps)
        keep = JM.route_indices((h @ jp["router"]).astype(jnp.float32), jc,
                                JM._capacity(80, jc))[2]
        assert not np.asarray(keep).all()


def test_einsum_and_gather_dispatch_agree_on_the_port():
    pc = _cfg(shared=1, cf=0.25)
    _, mod = _params(pc)
    x = torch.from_numpy(_x((3, 100, pc.d_model), 6))
    ye, ae = M.moe_apply_einsum(mod, x, pc)
    yg, ag = M.moe_apply_gather(mod, x, pc)
    _close(ye.detach(), yg.detach())
    assert float(ae) == float(ag)
    assert M.moe_apply(mod, x, dataclasses.replace(
        pc, moe_impl="gather"))[0].equal(yg)


def test_top_k_breaks_ties_as_jax():
    """``torch.topk`` orders tied values arbitrarily; the port's top-k
    gives ``jax.lax.top_k``'s lowest indices first."""
    probs = torch.zeros(3, 64)
    probs[1, 10:20] = 0.5
    probs[2, ::7] = 1.0
    vals, idx = M._top_k(probs, 4)
    jv, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    assert idx[0].tolist() == [0, 1, 2, 3]


# ---------------------------------------------------------------------------
# tests/test_moe.py on the port
# ---------------------------------------------------------------------------

def _x_like(key_shape):
    return torch.from_numpy(np.array(jax.random.normal(KEY, key_shape)))


def test_moe_matches_dense_oracle_with_slack_capacity():
    cfg = _cfg(cf=8.0)
    _, p = _params(cfg)
    x = _x_like((2, 16, cfg.d_model))
    y, aux = M.moe_apply(p, x, cfg)
    y_ref, aux_ref = M.moe_apply_dense_oracle(p, x, cfg)
    np.testing.assert_allclose(y.detach().numpy(), y_ref.detach().numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(aux), float(aux_ref), rtol=1e-3,
                               atol=1e-2)


def test_moe_shared_experts_added():
    cfg = _cfg(shared=2)
    _, p = _params(cfg)
    x = _x_like((2, 16, cfg.d_model))
    y, _ = M.moe_apply(p, x, cfg)
    y_ref, _ = M.moe_apply_dense_oracle(p, x, cfg)
    np.testing.assert_allclose(y.detach().numpy(), y_ref.detach().numpy(),
                               rtol=1e-4, atol=1e-4)
    p.shared = None
    y_routed, _ = M.moe_apply(p, x, cfg)
    assert not torch.allclose(y, y_routed)


def test_moe_tight_capacity_drops_but_keeps_residual():
    """With capacity at its floor most choices drop: less expert mass
    reaches the output than at a slack capacity."""
    cfg = _cfg(cf=1e-6)
    _, p = _params(cfg)
    x = _x_like((1, 64, cfg.d_model))
    y, _ = M.moe_apply(p, x, cfg)
    delta = (y - x).abs().mean().item()
    y_big, _ = M.moe_apply(p, x, _cfg(cf=8.0))
    assert delta < (y_big - x).abs().mean().item()


def test_load_balance_loss_minimal_when_uniform():
    """Uniform routing probs -> aux ~ 1 (its minimum); concentrated
    routing -> aux >> 1."""
    cfg = _cfg(n_experts=4, top_k=1)
    g, t, e = 1, 256, 4
    _, _, aux_u = M.route(torch.zeros((g, t, e)), cfg, capacity=256)
    skew = torch.cat([torch.full((g, t, 1), 10.0), torch.zeros((g, t, e - 1))],
                     -1)
    _, _, aux_s = M.route(skew, cfg, capacity=256)
    assert float(aux_s) > float(aux_u)
    np.testing.assert_allclose(float(aux_u), 1.0, rtol=0.1)


def test_capacity_priority_is_first_choice_first():
    """1st-choice assignments win capacity slots over 2nd choices."""
    cfg = _cfg(n_experts=2, top_k=2, cf=1e-6)
    g, t = 1, 16
    logits = torch.stack([torch.full((g, t), 5.0), torch.zeros((g, t))], -1)
    disp, _, _ = M.route(logits, cfg, capacity=4)
    d = disp.numpy()
    assert d[0, :4, 0].any(axis=-1).all()
    assert not d[0, 4:, 0].any()
