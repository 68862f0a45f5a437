"""Parity of the port's RG-LRU scan (``repro_torch.kernels.rglru_scan``,
its plain versions on the CPU) and block (``repro_torch.models.rglru``)
with the reference.

* The forward scan against the Pallas kernel in interpret mode and the
  sequential oracle ``rglru_scan_seq_ref``, on ``SCAN_CASES``
  (tests/test_kernels.py, with its S=17/100 and D=40/96 tails), at its
  tolerance 1e-5.
* The reverse pass, through the ``autograd.Function``, against
  ``jax.grad`` of the reference's associative scan ``rglru_scan_ref``
  (the path the reference trains on; its Pallas kernel has no
  gradient): 1e-5 of each gradient's largest magnitude, since the two
  sum the decayed terms in other orders.
* ``rglru_apply`` (conv, gates, scan, gating, residual) and its
  gradients against the reference's, fp32, at 2e-5 (the forward) and
  1e-5 of each gradient's largest magnitude.

* The CUDA kernel's order of operations (chunked pairs, carries
  composed in chunk order, rescans from the carries), emulated in plain
  torch at the kernel's tiles, against both references.

On CPU tensors the wrappers reach their plain versions and leave their
launch counters alone; the card runs the CUDA kernel
(tests/test_torch_cuda.py, marked ``cuda``).
"""
from __future__ import annotations

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.recurrentgemma_9b import CONFIG as JRG
from repro.kernels.rglru_scan.ops import rglru_scan as rglru_scan_pallas
from repro.kernels.rglru_scan.ref import rglru_scan_seq_ref
from repro.models import rglru as JR
from repro_torch.configs.recurrentgemma_9b import CONFIG as PRG
from repro_torch.kernels.cost import KernelCount
from repro_torch.kernels.rglru_scan import ops, ref
from repro_torch.models import rglru as PR
from repro_torch.models import transformer as PT

SCAN_CASES = [(2, 64, 128), (3, 100, 96), (1, 256, 512), (2, 17, 40)]
TOL = 1e-5
# the CUDA kernel's tiles, (rows a thread walks, warps a CTA), forward and
# reverse: FWD_ROWS/FWD_WARPS and BWD_ROWS/BWD_WARPS in csrc/rglru_scan.cu
FWD_TILE, BWD_TILE = (16, 4), (16, 4)
# the edges of the chunked body, held on the card: several chunks with a
# partial last one and B > 1, D not a multiple of 4, S = 1
CARD_CASES = [(2, 1000, 512), (2, 300, 37), (3, 1, 64)]
SMALL = dict(d_model=64, n_heads=4, n_kv_heads=1, head_dim=16, window=8)


def _scan_inputs(B, S, D, seed=0):
    rng = np.random.RandomState(seed + S + D)
    return (rng.uniform(0.5, 0.999, (B, S, D)).astype(np.float32),
            (rng.standard_normal((B, S, D)) * 0.1).astype(np.float32),
            rng.standard_normal((B, D)).astype(np.float32),
            rng.standard_normal((B, S, D)).astype(np.float32))


def _rel_close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, err


@pytest.mark.parametrize("B,S,D", SCAN_CASES)
def test_scan_plain_vs_pallas_and_seq_ref(B, S, D):
    a, b, h0, _ = _scan_inputs(B, S, D)
    before = ops.rglru_scan_fwd.launches
    y = ops.rglru_scan_fwd(*map(torch.from_numpy, (a, b, h0))).numpy()
    assert ops.rglru_scan_fwd.launches == before
    ja, jb, jh = map(jnp.asarray, (a, b, h0))
    np.testing.assert_allclose(y, rglru_scan_seq_ref(ja, jb, jh), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(y, rglru_scan_pallas(ja, jb, jh, bs=32, bd=64),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("B,S,D", SCAN_CASES)
def test_scan_reverse_vs_jax_grad(B, S, D):
    """d(sum(y * dy)) / d(a, b, h0) through ``ops.rglru_scan`` (forward
    then the reverse pass) against ``jax.grad`` of the associative
    scan."""
    a, b, h0, dy = _scan_inputs(B, S, D)
    ta, tb, th = (torch.from_numpy(x).requires_grad_(True)
                  for x in (a, b, h0))
    before = ops.rglru_scan_bwd.launches
    (ops.rglru_scan(ta, tb, th) * torch.from_numpy(dy)).sum().backward()
    assert ops.rglru_scan_bwd.launches == before
    want = jax.jit(jax.grad(
        lambda x, y, z, w: jnp.sum(JR.rglru_scan_ref(x, y, z) * w),
        argnums=(0, 1, 2)))(*map(jnp.asarray, (a, b, h0, dy)))
    for got, w in zip((ta.grad, tb.grad, th.grad), want):
        _rel_close(got.numpy(), w, TOL)


def test_reverse_ref_is_the_gradient_of_the_seq_ref():
    """The plain reverse pass equals autograd through the plain forward
    scan: db = g, da_t = g_t y_{t-1}, dh0 = a_0 g_0."""
    a, b, h0, dy = map(torch.from_numpy, _scan_inputs(2, 17, 40, seed=3))
    a, b, h0 = (x.requires_grad_(True) for x in (a, b, h0))
    y = ref.rglru_scan_seq_ref(a, b, h0)
    (y * dy).sum().backward()
    da, db, dh0 = ref.rglru_scan_reverse_ref(a.detach(), dy, y.detach(),
                                             h0.detach())
    for got, want in ((da, a.grad), (db, b.grad), (dh0, h0.grad)):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_scan_wrappers_refuse_what_no_kernel_takes():
    a = torch.zeros((1, 4, 8))
    with pytest.raises(TypeError, match="float32"):
        ops.rglru_scan_fwd(a.double(), a.double(), a[:, 0].double())
    with pytest.raises(ValueError, match="states"):
        ops.rglru_scan_fwd(a, a, a[0])
    # meta tensors launch nothing: an empty output and the call's cost
    # on the active counter (the dry run's branch), no launch counted
    launches = ops.rglru_scan_fwd.launches
    with KernelCount() as kc:
        y = ops.rglru_scan_fwd(a.to("meta"), a.to("meta"), a[:, 0].to("meta"))
    assert y.device.type == "meta" and y.shape == a.shape
    assert kc.calls == {"rglru_scan_fwd": 1}
    assert ops.rglru_scan_fwd.launches == launches
    with pytest.raises(ValueError, match="one shape"):
        ops.rglru_scan_bwd(a, a, a[:, :3], a[:, 0])


def _fma(x, h, c):
    """fmaf: x*h + c rounded once (the float64 product is exact)."""
    return (x.double() * h.double() + c.double()).float()


def _tiles(x, rows, warps, fill):
    """(B, S, D) -> (B, chunks, warps, rows, D), the last chunk padded."""
    bsz, s, d = x.shape
    n = -(-s // (rows * warps))
    pad = x.new_full((bsz, n * rows * warps - s, d), fill)
    return torch.cat([x, pad], 1).reshape(bsz, n, warps, rows, d)


def _carries(pa, py, start, reverse):
    """The kernel's carries from the warps' pairs (B, N, W, D): each
    chunk's aggregate (its warps composed in scan order), the chain over
    the chunks' pairs from ``start``, and each warp's carry-in."""
    n, w = pa.shape[1], pa.shape[2]
    worder = range(w - 1, -1, -1) if reverse else range(w)
    first, *rest = worder
    ca, cy = pa[:, :, first], py[:, :, first]
    for k in rest:
        ca, cy = ca * pa[:, :, k], _fma(pa[:, :, k], cy, py[:, :, k])
    h, chunk_in = start, [None] * n
    for c in (range(n - 1, -1, -1) if reverse else range(n)):
        chunk_in[c] = h
        h = _fma(ca[:, c], h, cy[:, c])
    h, warp_in = torch.stack(chunk_in, 1), [None] * w
    for k in worder:
        warp_in[k] = h
        h = _fma(pa[:, :, k], h, py[:, :, k])
    return torch.stack(warp_in, 2)


def _chunked_fwd(a, b, h0, rows, warps):
    """The forward kernel's order of operations in plain torch: per-warp
    pairs (A, Y) over ``rows`` rows, carries composed in chunk order,
    each warp's rows rescanned from its carry."""
    s = a.shape[1]
    a4, b4 = _tiles(a, rows, warps, 1.0), _tiles(b, rows, warps, 0.0)
    pa, py = torch.ones_like(a4[:, :, :, 0]), torch.zeros_like(a4[:, :, :, 0])
    for r in range(rows):
        py, pa = _fma(a4[:, :, :, r], py, b4[:, :, :, r]), pa * a4[:, :, :, r]
    h, ys = _carries(pa, py, h0, reverse=False), []
    for r in range(rows):
        h = _fma(a4[:, :, :, r], h, b4[:, :, :, r])
        ys.append(h)
    return torch.stack(ys, 3).reshape(a.shape[0], -1, a.shape[2])[:, :s]


def _chunked_bwd(a, dy, y, h0, rows, warps):
    """The reverse kernel's order of operations: chunks and warps from
    the last to the first, a shifted by one row (0 from t = S-1 on).
    Returns (da, db, dh0)."""
    bsz, s, d = a.shape
    an = _tiles(torch.cat([a[:, 1:], a.new_zeros((bsz, 1, d))], 1), rows,
                warps, 0.0)
    gv = _tiles(dy, rows, warps, 0.0)
    yp = _tiles(torch.cat([h0[:, None], y[:, :-1]], 1), rows, warps, 0.0)
    pa, py = torch.ones_like(an[:, :, :, 0]), torch.zeros_like(an[:, :, :, 0])
    for r in range(rows - 1, -1, -1):
        py, pa = _fma(an[:, :, :, r], py, gv[:, :, :, r]), pa * an[:, :, :, r]
    g = _carries(pa, py, torch.zeros_like(h0), reverse=True)
    dbs, das = [None] * rows, [None] * rows
    for r in range(rows - 1, -1, -1):
        g = _fma(an[:, :, :, r], g, gv[:, :, :, r])
        dbs[r], das[r] = g, g * yp[:, :, :, r]
    db, da = (torch.stack(x, 3).reshape(bsz, -1, d)[:, :s] for x in (dbs, das))
    return da, db, a[:, 0] * db[:, 0]


@pytest.mark.parametrize("B,S,D", [(1, 4096, 64), *SCAN_CASES, *CARD_CASES])
def test_chunked_order_of_operations_vs_jax(B, S, D):
    """The CUDA kernel's arithmetic, emulated on the CPU at its tiles
    (chunks of 64 rows of 128 channels, 4 warps of 16 rows each way): the
    forward against ``rglru_scan_seq_ref`` at 1e-5 (largest error seen
    1.2e-7, at (2, 1000, 512)), the reverse against ``jax.grad`` of the
    associative scan at 1e-5 of each gradient's largest magnitude
    (largest seen 2.3e-7, at (1, 256, 512))."""
    a, b, h0, dy = map(torch.from_numpy, _scan_inputs(B, S, D))
    y = _chunked_fwd(a, b, h0, *FWD_TILE)
    ja, jb, jh = map(jnp.asarray, (a.numpy(), b.numpy(), h0.numpy()))
    np.testing.assert_allclose(y.numpy(), rglru_scan_seq_ref(ja, jb, jh),
                               rtol=TOL, atol=TOL)
    got = _chunked_bwd(a, dy, y, h0, *BWD_TILE)
    want = jax.jit(jax.grad(
        lambda x, z, u, w: jnp.sum(JR.rglru_scan_ref(x, z, u) * w),
        argnums=(0, 1, 2)))(ja, jb, jh, jnp.asarray(dy.numpy()))
    for g, w in zip(got, want):
        _rel_close(g.numpy(), w, TOL)


def _block_params(cfg, seed=1):
    """Reference-layout rglru params with nonzero norms and biases."""
    p = JR.rglru_init(jax.random.PRNGKey(seed), cfg, jnp.float32)
    rng = np.random.RandomState(seed)
    for name in ("ln", "conv_b", "b_gates"):
        p[name] = jnp.asarray(rng.standard_normal(p[name].shape) * 0.1,
                              jnp.float32)
    return {k: np.asarray(v) for k, v in p.items()}


def _port_block(cfg, params):
    block = PR.RGLRUBlock(cfg, torch.float32, torch.device("cpu"),
                          PT._param)
    with torch.no_grad():
        for name, p in block.named_parameters():
            p.copy_(torch.from_numpy(np.array(params[name])))
    return block.requires_grad_(True)


def test_rglru_apply_and_its_gradients_match_jax():
    """The block forward against both reference paths (associative scan,
    and the Pallas kernel in interpret mode), and the gradients of every
    leaf and of x against ``jax.grad`` of the associative-scan path."""
    jcfg = replace(JRG, **SMALL, dtype="float32")
    pcfg = replace(PRG, **SMALL, dtype="float32")
    params = _block_params(jcfg)
    rng = np.random.RandomState(2)
    x = rng.standard_normal((2, 16, 64)).astype(np.float32)
    dy = rng.standard_normal((2, 16, 64)).astype(np.float32)
    block = _port_block(pcfg, params)
    tx = torch.from_numpy(x).requires_grad_(True)
    out = PR.rglru_apply(block, tx, pcfg)
    (out * torch.from_numpy(dy)).sum().backward()
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    pallas = JR.rglru_apply(jp, jnp.asarray(x),
                            replace(jcfg, attn_impl="pallas"))

    def f(p, xx):
        y = JR.rglru_apply(p, xx, jcfg)
        return jnp.sum(y * dy), y
    (_, xla), (gp, gx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
    for want in (xla, pallas):
        np.testing.assert_allclose(out.detach().numpy(), want, rtol=2e-5,
                                   atol=2e-5)
    _rel_close(tx.grad.numpy(), gx, TOL)
    for name, p in block.named_parameters():
        _rel_close(p.grad.numpy(), gp[name], TOL)


def test_conv_and_gates_match_jax():
    jcfg = replace(JRG, **SMALL, dtype="float32")
    pcfg = replace(PRG, **SMALL, dtype="float32")
    params = _block_params(jcfg, seed=4)
    xc = np.random.RandomState(5).standard_normal((2, 9, 64)).astype(
        np.float32)
    block = _port_block(pcfg, params)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    got = PR._causal_conv(torch.from_numpy(xc), block.conv_w, block.conv_b)
    np.testing.assert_allclose(got.detach().numpy(), JR._causal_conv(
        jnp.asarray(xc), jp["conv_w"], jp["conv_b"]), rtol=1e-6, atol=1e-6)
    for g, w in zip(PR._gates(block, torch.from_numpy(xc)),
                    JR._gates(jp, jnp.asarray(xc))):
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=1e-6,
                                   atol=1e-6)
