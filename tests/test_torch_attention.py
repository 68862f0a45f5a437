"""Parity of the port's attention (the kernel wrappers' plain versions on
the CPU) with the reference's four attention paths: the ``ref.py``
oracles, the XLA production functions, and the Pallas kernels in
interpret mode. fp32, tolerance 2e-5 as in tests/test_kernels.py; bf16
3e-2 (the frameworks round bf16 at other places). Covered: prefill
flash attention (also with a per-sequence ``q_offset`` / ``kv_len``, the
ragged path chunked prefill and prefix resume take), slotted decode,
and paged decode over a block pool, the decodes also at head_dim 256
with 4 and 16 query heads a KV head. For training: the flash wrapper's
log-sum-exp at head_dim 64 and 256 against the reference's
``_fa_forward``, and the port of the flash backward ``_fa_bwd``
(through the ``FlashAttention`` autograd function) against ``jax.grad``
of ``flash_attention_xla`` with a window and GQA, at head_dim 64 and
256, within 2e-5 of each gradient's largest magnitude.

On a CPU tensor a wrapper must reach its plain version and leave its
launch counter at 0; on the card it launches the CUDA kernel
(tests/test_torch_cuda.py, marked ``cuda``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.kernel import decode_attention_pallas
from repro.kernels.decode_attention.ops import \
    paged_decode_attention as paged_decode_attention_jax
from repro.kernels.decode_attention.ref import (decode_attention_ref,
                                                paged_decode_attention_ref)
from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.flash_attention.ref import attention_ref
from repro.models.layers import (_fa_forward, decode_attention_xla,
                                 flash_attention_xla)
from repro_torch.kernels.cost import KernelCount
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention import ref as da_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.models import layers as PL

TOL = 2e-5

FA_SHAPES = [
    # (b, sq, sk, h, hk, d, causal, window)
    (2, 37, 37, 4, 2, 16, True, 0),
    (2, 64, 64, 4, 1, 32, True, 24),
    (2, 20, 45, 4, 2, 12, False, 0),
    (1, 33, 33, 6, 2, 16, True, 5),
]
# tests/test_kernels.py PAGED_CASES: (b, h, hk, d, num_blocks, block_size,
# pages, dtype); tables drawn over [0, N) name the null block 0 and
# repeat blocks
PAGED_CASES = [
    (2, 4, 2, 32, 9, 8, 4, "float32"),
    (3, 8, 1, 64, 5, 16, 2, "float32"),
    (1, 4, 4, 128, 17, 8, 8, "bfloat16"),
    (4, 8, 2, 64, 13, 16, 3, "float32"),
    # head_dim 256: gemma3's 4 query heads a KV head, RecurrentGemma's 16
    (2, 4, 1, 256, 9, 16, 3, "float32"),
    (2, 16, 1, 256, 7, 16, 2, "bfloat16"),
]
PAGED_TOL = {"float32": TOL, "bfloat16": 3e-2}
# (b, sq, sk, h, hk, d, q_offset, kv_len): Sq != Sk with kv_len < Sk, a
# chunk padded past kv_len (its last rows' keys are live but lie above
# every real row), and B=2 at different offsets
OFFSET_CASES = [
    (1, 8, 24, 4, 2, 16, [5], [13]),
    (1, 4, 16, 4, 1, 32, [8], [12]),
    (2, 6, 20, 6, 2, 16, [3, 11], [9, 17]),
    (2, 5, 40, 4, 2, 12, [0, 21], [5, 26]),
]
# (b, s, h, hk, d, window, chunk): training attention, causal with a
# window, GQA; blocks of 16 over a ragged 37 rows, and head_dim 256
FA_BWD_CASES = [
    (2, 37, 4, 1, 64, 8, 16),
    (1, 24, 4, 2, 256, 8, 8),
]
DEC_SHAPES = [
    # (h, hk, d, s, lengths)
    (4, 2, 16, 40, [1, 17, 40]),
    (8, 2, 12, 33, [1, 33]),
    (6, 1, 32, 64, [64, 1, 2, 50]),
    # head_dim 256 over rings: g = 4 (gemma3) and 16 (RecurrentGemma)
    (4, 1, 256, 48, [1, 31, 33, 48]),
    (16, 1, 256, 40, [40, 2, 17]),
]


def _qkv(rng, b, sq, sk, h, hk, d):
    return (rng.standard_normal((b, sq, h, d)).astype(np.float32),
            rng.standard_normal((b, sk, hk, d)).astype(np.float32),
            rng.standard_normal((b, sk, hk, d)).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("b,sq,sk,h,hk,d,causal,window", FA_SHAPES)
def test_flash_plain_vs_jax(b, sq, sk, h, hk, d, causal, window):
    q, k, v = _qkv(np.random.RandomState(sq + d), b, sq, sk, h, hk, d)
    before = fa_ops.flash_attention.launches
    out = fa_ops.flash_attention(*_t(q, k, v), causal=causal,
                                 window=window).numpy()
    assert fa_ops.flash_attention.launches == before
    _close(out, attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, window=window))


@pytest.mark.parametrize("b,sq,sk,h,hk,d,causal,window", FA_SHAPES[::2])
def test_flash_plain_vs_xla(b, sq, sk, h, hk, d, causal, window):
    q, k, v = _qkv(np.random.RandomState(sq + d), b, sq, sk, h, hk, d)
    out = fa_ref.attention_ref(*_t(q, k, v), causal=causal,
                               window=window).numpy()
    _close(out, flash_attention_xla(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal,
                                    window=window, chunk=16))


@pytest.mark.parametrize("sq,h,hk,d,window", [(32, 4, 2, 16, 0),
                                              (24, 2, 1, 8, 10)])
def test_flash_plain_vs_pallas_interpret(sq, h, hk, d, window):
    q, k, v = _qkv(np.random.RandomState(sq), 1, sq, sq, h, hk, d)
    out = fa_ref.attention_ref(*_t(q, k, v), window=window).numpy()
    _close(out, flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), window=window,
                                       bq=8, bk=8, interpret=True))


def _dec(rng, h, hk, d, s, lengths):
    b = len(lengths)
    return (rng.standard_normal((b, h, d)).astype(np.float32),
            rng.standard_normal((b, s, hk, d)).astype(np.float32),
            rng.standard_normal((b, s, hk, d)).astype(np.float32),
            np.asarray(lengths, np.int32))


@pytest.mark.parametrize("h,hk,d,s,lengths", DEC_SHAPES)
def test_decode_plain_vs_jax(h, hk, d, s, lengths):
    q, kc, vc, lens = _dec(np.random.RandomState(s), h, hk, d, s, lengths)
    before = da_ops.decode_attention.launches
    out = da_ops.decode_attention(*_t(q, kc, vc, lens)).numpy()
    assert da_ops.decode_attention.launches == before
    j = [jnp.asarray(a) for a in (q, kc, vc, lens)]
    _close(out, decode_attention_ref(*j))
    _close(out, decode_attention_xla(*j))


@pytest.mark.parametrize("h,hk,d,s,lengths", DEC_SHAPES[::2])
def test_decode_plain_vs_pallas_interpret(h, hk, d, s, lengths):
    q, kc, vc, lens = _dec(np.random.RandomState(s), h, hk, d, s, lengths)
    out = da_ref.decode_attention_ref(*_t(q, kc, vc, lens)).numpy()
    _close(out, decode_attention_pallas(*[jnp.asarray(a) for a in
                                          (q, kc, vc, lens)],
                                        bk=8, interpret=True))


def test_decode_zero_length_gives_zeros():
    """A sequence with no valid rows attends to nothing: zeros, as the
    online softmax's acc / max(l, 1e-30) gives, never NaN."""
    q, kc, vc, lens = _dec(np.random.RandomState(0), 4, 2, 16, 8, [0, 3])
    out = da_ops.decode_attention(*_t(q, kc, vc, lens))
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    _close(out[1:].numpy(), decode_attention_ref(
        *[jnp.asarray(a[1:]) for a in (q, kc, vc, lens)]))


def _paged(rng, b, h, hk, d, n, bs, nb, dtype):
    np_dt = np.float32
    q = rng.standard_normal((b, h, d)).astype(np_dt)
    kp = rng.standard_normal((n, bs, hk, d)).astype(np_dt)
    vp = rng.standard_normal((n, bs, hk, d)).astype(np_dt)
    tables = rng.randint(0, n, (b, nb)).astype(np.int32)
    lens = rng.randint(1, nb * bs + 1, (b,)).astype(np.int32)
    if dtype == "bfloat16":         # the values both sides see
        q, kp, vp = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                     for a in (q, kp, vp))
    return q, kp, vp, tables, lens


@pytest.mark.parametrize("b,h,hk,d,n,bs,nb,dtype", PAGED_CASES)
def test_paged_decode_plain_vs_jax_and_pallas(b, h, hk, d, n, bs, nb, dtype):
    """The paged plain version (through the wrapper, on the CPU) against
    JAX's paged oracle and the Pallas paged kernel in interpret mode."""
    q, kp, vp, tables, lens = _paged(np.random.RandomState(n * bs + d),
                                     b, h, hk, d, n, bs, nb, dtype)
    assert (tables == 0).any() or len(np.unique(tables)) < tables.size
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    before = da_ops.paged_decode_attention.launches
    out = da_ops.paged_decode_attention(
        *[torch.from_numpy(a).to(tdt) for a in (q, kp, vp)],
        torch.from_numpy(tables), torch.from_numpy(lens))
    assert da_ops.paged_decode_attention.launches == before
    assert out.dtype == tdt
    j = [jnp.asarray(a, jdt) for a in (q, kp, vp)] + \
        [jnp.asarray(tables), jnp.asarray(lens)]
    tol = PAGED_TOL[dtype]
    np.testing.assert_allclose(out.float().numpy(), np.asarray(
        paged_decode_attention_ref(*j), np.float32), rtol=tol, atol=tol)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(
        paged_decode_attention_jax(*j), np.float32), rtol=tol, atol=tol)


def test_paged_decode_equals_slotted_over_gathered_pages():
    """The paged plain version is the slotted one over the gathered
    pages; a zero length gives zeros."""
    q, kp, vp, tables, lens = _paged(np.random.RandomState(1), 3, 4, 2, 16,
                                     7, 4, 3, "float32")
    lens[1] = 0
    qt, kt, vt, tt, lt = _t(q, kp, vp, tables, lens)
    out = da_ops.paged_decode_attention(qt, kt, vt, tt, lt)
    gk = kt[tt.long()].reshape(3, 12, 2, 16)
    gv = vt[tt.long()].reshape(3, 12, 2, 16)
    assert torch.equal(out, da_ref.decode_attention_ref(qt, gk, gv, lt))
    assert torch.equal(out[1], torch.zeros_like(out[1]))


@pytest.mark.parametrize("b,sq,sk,h,hk,d,q_offset,kv_len", OFFSET_CASES)
def test_flash_offset_ragged_plain_vs_xla(b, sq, sk, h, hk, d, q_offset,
                                          kv_len):
    """Flash attention with a per-sequence query offset and valid KV
    length, against the reference's ragged XLA path."""
    q, k, v = _qkv(np.random.RandomState(sk + d), b, sq, sk, h, hk, d)
    qo, kl = np.asarray(q_offset, np.int32), np.asarray(kv_len, np.int32)
    before = fa_ops.flash_attention.launches
    out = fa_ops.flash_attention(*_t(q, k, v), q_offset=torch.from_numpy(qo),
                                 kv_len=torch.from_numpy(kl)).numpy()
    assert fa_ops.flash_attention.launches == before
    _close(out, flash_attention_xla(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        q_offset=jnp.asarray(qo), kv_len=jnp.asarray(kl), chunk=8))


def test_flash_offset_matches_the_rows_of_a_full_prefill():
    """A query block at offset o with kv_len o + Sq gives the rows
    o .. o + Sq - 1 of the full causal prefill over the same keys."""
    q, k, v = _qkv(np.random.RandomState(4), 1, 20, 20, 4, 2, 16)
    full = fa_ref.attention_ref(*_t(q, k, v))
    part = fa_ref.attention_ref(*_t(q[:, 12:17], k, v),
                                q_offset=torch.tensor([12], dtype=torch.int32),
                                kv_len=torch.tensor([17], dtype=torch.int32))
    _close(part.numpy(), full[:, 12:17].numpy())


def test_wrappers_refuse_what_no_kernel_takes():
    q = torch.zeros((1, 4, 2, 16))
    k = torch.zeros((1, 4, 1, 16))
    with pytest.raises(TypeError):
        fa_ops.flash_attention(q.double(), k.double(), k.double())
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q, k, k[:, :3])
    # meta tensors launch nothing: an empty output and the call's cost
    # on the active counter (the dry run's branch), no launch counted
    launches = (fa_ops.flash_attention.launches,
                da_ops.decode_attention.launches,
                da_ops.paged_decode_attention.launches)
    with KernelCount() as kc:
        o = fa_ops.flash_attention(q.to("meta"), k.to("meta"), k.to("meta"))
    assert o.device.type == "meta" and o.shape == q.shape
    assert kc.calls == {"flash_attention": 1} and kc.flops > 0
    qd, kc = torch.zeros((2, 4, 16)), torch.zeros((2, 8, 2, 16))
    with pytest.raises(TypeError, match="int32"):
        da_ops.decode_attention(qd, kc, kc, torch.ones(2, dtype=torch.int64))
    with KernelCount() as count:
        o = da_ops.decode_attention(qd.to("meta"), kc.to("meta"),
                                    kc.to("meta"),
                                    torch.ones(2, dtype=torch.int32,
                                               device="meta"))
    assert o.device.type == "meta" and o.shape == qd.shape
    assert count.calls == {"decode_attention": 1}
    with pytest.raises(TypeError, match="q_offset"):
        fa_ops.flash_attention(q, k, k, q_offset=torch.zeros(1))
    with pytest.raises(TypeError, match="kv_len"):
        fa_ops.flash_attention(q, k, k, kv_len=torch.zeros(2,
                                                           dtype=torch.int32))
    tables, lens = torch.zeros((2, 3), dtype=torch.int32), \
        torch.ones(2, dtype=torch.int32)
    with pytest.raises(TypeError, match="block_tables"):
        da_ops.paged_decode_attention(qd, kc, kc, tables.long(), lens)
    with pytest.raises(TypeError, match="lengths"):
        da_ops.paged_decode_attention(qd, kc, kc, tables, lens.long())
    with KernelCount() as count:
        o = da_ops.paged_decode_attention(*(t.to("meta") for t in
                                            (qd, kc, kc, tables, lens)))
    assert o.device.type == "meta" and o.shape == qd.shape
    assert count.calls == {"paged_decode_attention": 1}
    assert launches == (fa_ops.flash_attention.launches,
                        da_ops.decode_attention.launches,
                        da_ops.paged_decode_attention.launches)


@pytest.mark.parametrize("b,s,h,hk,d,window,chunk", FA_BWD_CASES)
def test_flash_lse_plain_vs_jax(b, s, h, hk, d, window, chunk):
    """The wrapper's output and log-sum-exp (B, H, S) against the
    reference's blocked forward, whose lse is (B, Hk, g, S)."""
    q, k, v = _qkv(np.random.RandomState(s + d), b, s, s, h, hk, d)
    before = fa_ops.flash_attention.launches
    o, lse = fa_ops.flash_attention(*_t(q, k, v), window=window,
                                    return_lse=True)
    assert fa_ops.flash_attention.launches == before
    want_o, want_lse = _fa_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, None, True,
        window, chunk, 1.0 / np.sqrt(d))
    _close(o.numpy(), want_o)
    _close(lse.numpy(), np.asarray(want_lse).reshape(b, h, s))


@pytest.mark.parametrize("b,s,h,hk,d,window,chunk", FA_BWD_CASES)
def test_flash_backward_vs_jax_grad(b, s, h, hk, d, window, chunk):
    """d(sum(o * do)) / d(q, k, v) through ``FlashAttention`` (the plain
    forward with its lse, then the ported ``_fa_bwd``) against
    ``jax.grad`` of ``flash_attention_xla`` (its custom-VJP backward)."""
    rng = np.random.RandomState(s * d)
    q, k, v = _qkv(rng, b, s, s, h, hk, d)
    do = rng.standard_normal((b, s, h, d)).astype(np.float32)
    tq, tk, tv = (t.requires_grad_(True) for t in _t(q, k, v))
    o = PL.FlashAttention.apply(tq, tk, tv, window, chunk, 1.0 / np.sqrt(d))
    (o * torch.from_numpy(do)).sum().backward()
    want = jax.jit(jax.grad(
        lambda x, y, z, w: jnp.sum(flash_attention_xla(
            x, y, z, causal=True, window=window, chunk=chunk) * w),
        argnums=(0, 1, 2)))(*map(jnp.asarray, (q, k, v, do)))
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        w = np.asarray(w)
        err = np.abs(got.numpy() - w).max() / np.abs(w).max()
        assert err <= TOL, err


# the tensor-core flash body's numerics on the CPU: (b, sq, sk, h, hk, d,
# window, q_offset, kv_len, KV rows a tile, tol); the tolerances are
# chip_smoke.py's bf16 limits for the prefill (2e-2), the q_offset /
# kv_len extends (5e-3) and head_dim 256 (2e-2)
TC_CASES = [
    (1, 128, 128, 12, 2, 128, 0, None, None, 64, 2e-2),
    (1, 64, 160, 12, 2, 128, 0, [64], [128], 64, 5e-3),
    (2, 48, 150, 6, 2, 128, 0, [30, 100], [78, 148], 64, 5e-3),
    (1, 160, 160, 16, 1, 256, 48, None, None, 32, 2e-2),
]


def _flash_tc_emulation(q, k, v, window, q_offset, kv_len, bk, bq=64):
    """The bf16 tensor-core body's arithmetic in torch: fp32 scores of
    bf16 inputs, masked with -1e30, an online softmax over KV tiles of
    ``bk`` rows with m, l and O in fp32, l summing the unrounded P, and
    P V taken as hi V + lo V with hi = bf16(P) and lo = bf16(P - hi),
    as the kernel issues it; the output rounded to bf16."""
    b, sq, h, d = q.shape
    _, sk, hk, _ = k.shape
    g, scale = h // hk, 1.0 / np.sqrt(d)
    qf = q.float().permute(0, 2, 1, 3)                           # (B,H,Sq,D)
    kf = k.float().repeat_interleave(g, 2).permute(0, 2, 1, 3)   # (B,H,Sk,D)
    vf = v.float().repeat_interleave(g, 2).permute(0, 2, 1, 3)
    qo = torch.zeros(b, dtype=torch.long) if q_offset is None \
        else torch.tensor(q_offset)
    kl = torch.full((b,), sk) if kv_len is None else torch.tensor(kv_len)
    out = torch.empty(b, h, sq, d)
    for q0 in range(0, sq, bq):
        qp = qo[:, None] + torch.arange(q0, min(q0 + bq, sq))[None]
        m = torch.full((b, h, qp.shape[1], 1), -1e30)
        l = torch.zeros_like(m)
        acc = torch.zeros(b, h, qp.shape[1], d)
        for k0 in range(0, sk, bk):
            kp = torch.arange(k0, min(k0 + bk, sk))
            s = qf[:, :, q0:q0 + bq] @ kf[:, :, k0:k0 + bk].transpose(-1, -2)
            ok = (kp[None, None] < kl[:, None, None]) & \
                (qp[:, :, None] >= kp[None, None])
            if window > 0:
                ok = ok & (qp[:, :, None] - kp[None, None] < window)
            s = torch.where(ok[:, None], s * scale, torch.tensor(-1e30))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            hi = p.to(torch.bfloat16).float()
            lo = (p - hi).to(torch.bfloat16).float()
            vt = vf[:, :, k0:k0 + bk]
            acc = acc * corr + hi @ vt + lo @ vt
            m = m_new
        out[:, :, q0:q0 + bq] = acc / l.clamp_min(1e-30)
    return out.permute(0, 2, 1, 3).to(torch.bfloat16)


@pytest.mark.parametrize("b,sq,sk,h,hk,d,window,q_offset,kv_len,bk,tol",
                         TC_CASES)
def test_flash_bf16_rounding_stays_within_the_chip_limits(
        b, sq, sk, h, hk, d, window, q_offset, kv_len, bk, tol):
    """P V with P split into two bf16 halves (the tensor-core body; m, l
    and O in fp32) keeps the output within the limits chip_smoke.py
    holds the kernel to, against the plain version on the same bf16
    inputs."""
    rng = np.random.RandomState(sq + sk + d)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(rng, b, sq, sk, h, hk, d))
    kw = {} if q_offset is None else dict(
        q_offset=torch.tensor(q_offset, dtype=torch.int32),
        kv_len=torch.tensor(kv_len, dtype=torch.int32))
    got = _flash_tc_emulation(q, k, v, window, q_offset, kv_len, bk).float()
    want = fa_ref.attention_ref(q, k, v, window=window, **kw).float()
    unrounded = (got - want).abs().max().item()
    assert unrounded > 0.0                # the rounding shows
    assert ((got - want).abs() <= tol + tol * want.abs()).all(), unrounded
