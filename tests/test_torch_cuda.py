"""The port's CUDA kernels against their plain versions, on the card.

The tests marked ``cuda``, gathered here so that this module imports
neither JAX nor the reference package: the card's machine has neither,
and the oracles are the port's own plain versions. Run them there with::

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Without a card they skip; ``python3 chip_smoke.py`` holds the same
kernels at the serving and training shapes. Covered: flash attention
(fp32 ragged, with ``q_offset`` / ``kv_len``, and the bf16 tensor-core
body's edges), slotted and paged decode (lengths 0 and 1, null and
repeated blocks, the bf16 edges, head_dim 256 at g = 1, 4 and 16), and the RG-LRU scan forward and
reverse (the chunked body's edges, a bitwise repeat at the training
shape, back-to-back calls on rotated inputs).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention import ref as da_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.rglru_scan import ops, ref

TOL = 2e-5
# (b, sq, sk, h, hk, d, q_offset, kv_len): Sq != Sk with kv_len < Sk, a
# chunk padded past kv_len, and B=2 at different offsets
OFFSET_CASES = [
    (1, 8, 24, 4, 2, 16, [5], [13]),
    (1, 4, 16, 4, 1, 32, [8], [12]),
    (2, 6, 20, 6, 2, 16, [3, 11], [9, 17]),
    (2, 5, 40, 4, 2, 12, [0, 21], [5, 26]),
]
SCAN_CASES = [(2, 64, 128), (3, 100, 96), (1, 256, 512), (2, 17, 40)]
SCAN_TOL = 1e-5
# the edges of the chunked body: several chunks with a partial last one
# and B > 1, D not a multiple of 4, S = 1
CARD_CASES = [(2, 1000, 512), (2, 300, 37), (3, 1, 64)]


def _qkv(rng, b, sq, sk, h, hk, d):
    return (rng.standard_normal((b, sq, h, d)).astype(np.float32),
            rng.standard_normal((b, sk, hk, d)).astype(np.float32),
            rng.standard_normal((b, sk, hk, d)).astype(np.float32))


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=TOL, atol=TOL)


def _dec(rng, h, hk, d, s, lengths):
    b = len(lengths)
    return (rng.standard_normal((b, h, d)).astype(np.float32),
            rng.standard_normal((b, s, hk, d)).astype(np.float32),
            rng.standard_normal((b, s, hk, d)).astype(np.float32),
            np.asarray(lengths, np.int32))


def _paged(rng, b, h, hk, d, n, bs, nb):
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kp = rng.standard_normal((n, bs, hk, d)).astype(np.float32)
    vp = rng.standard_normal((n, bs, hk, d)).astype(np.float32)
    tables = rng.randint(0, n, (b, nb)).astype(np.int32)
    lens = rng.randint(1, nb * bs + 1, (b,)).astype(np.int32)
    return q, kp, vp, tables, lens


def _scan_inputs(B, S, D, seed=0):
    rng = np.random.RandomState(seed + S + D)
    return (rng.uniform(0.5, 0.999, (B, S, D)).astype(np.float32),
            (rng.standard_normal((B, S, D)) * 0.1).astype(np.float32),
            rng.standard_normal((B, D)).astype(np.float32),
            rng.standard_normal((B, S, D)).astype(np.float32))


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """The CUDA kernels against their plain versions on the card, at a
    ragged prefill and a ragged decode shape in fp32."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run: python3 chip_smoke.py")
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(a).cuda()
               for a in _qkv(rng, 2, 37, 37, 4, 2, 16))
    before = fa_ops.flash_attention.launches
    out = fa_ops.flash_attention(q, k, v)
    assert fa_ops.flash_attention.launches == before + 1
    _close(out.cpu(), fa_ref.attention_ref(q, k, v).cpu())
    qd, kc, vc, lens = (torch.from_numpy(a).cuda()
                        for a in _dec(rng, 8, 2, 12, 33, [0, 1, 33]))
    out = da_ops.decode_attention(qd, kc, vc, lens)
    _close(out.cpu(), da_ref.decode_attention_ref(qd, kc, vc, lens).cpu())


@pytest.mark.cuda
def test_paged_and_offset_kernels_match_plain_on_card():
    """The paged decode kernel (null and repeated blocks, lengths 0 and
    1) and the flash kernel with ``q_offset`` / ``kv_len`` against their
    plain versions on the card, fp32."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run: python3 chip_smoke.py")
    rng = np.random.RandomState(0)
    q, kp, vp, tables, lens = _paged(rng, 4, 8, 2, 64, 13, 16, 3)
    lens[:2] = [0, 1]
    args = [torch.from_numpy(a).cuda() for a in (q, kp, vp, tables, lens)]
    before = da_ops.paged_decode_attention.launches
    out = da_ops.paged_decode_attention(*args)
    assert da_ops.paged_decode_attention.launches == before + 1
    _close(out.cpu(), da_ref.paged_decode_attention_ref(*args).cpu())
    for b, sq, sk, h, hk, d, qo, kl in OFFSET_CASES:
        q, k, v = (torch.from_numpy(a).cuda()
                   for a in _qkv(rng, b, sq, sk, h, hk, d))
        kw = dict(q_offset=torch.tensor(qo, dtype=torch.int32).cuda(),
                  kv_len=torch.tensor(kl, dtype=torch.int32).cuda())
        _close(fa_ops.flash_attention(q, k, v, **kw).cpu(),
               fa_ref.attention_ref(q, k, v, **kw).cpu())


@pytest.mark.cuda
def test_bf16_kernel_edges_match_plain_on_card():
    """The bf16 bodies at their edges against the plain versions on the
    card, at chip_smoke.py's bf16 limits: flash at head dims 12 to 256,
    ragged tiles, g = 1, 16 and 128, a window and kv_len ending mid-tile,
    and a batch whose rows equal their B=1 runs bit for bit; slotted and
    paged decode at lengths 0, 1, 31, 33, 80 and the full cache, block
    sizes 8 and 16, and 24-byte rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run: python3 chip_smoke.py")
    rng = np.random.RandomState(0)
    bf = torch.bfloat16

    def dev(*arrays):
        return [torch.from_numpy(a).cuda().to(bf) for a in arrays]

    def close(got, want, tol):
        got, want = got.float().cpu(), want.float().cpu()
        assert torch.isfinite(got).all()
        assert ((got - want).abs() <= tol + tol * want.abs()).all(), \
            (got - want).abs().max().item()

    for b, sq, sk, h, hk, d, causal, window in [
            (2, 100, 100, 4, 2, 16, True, 0), (1, 130, 130, 8, 2, 64, True, 0),
            (2, 77, 77, 6, 3, 96, True, 40), (1, 150, 150, 4, 1, 192, True, 0),
            (2, 37, 37, 4, 2, 12, True, 0), (1, 70, 133, 4, 2, 128, False, 0),
            (2, 90, 90, 4, 4, 128, True, 0), (1, 200, 200, 16, 1, 128, True, 0),
            (1, 40, 40, 128, 1, 64, True, 0), (1, 300, 300, 16, 1, 256, True, 50)]:
        q, k, v = dev(*_qkv(rng, b, sq, sk, h, hk, d))
        before = fa_ops.flash_attention.launches
        out = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
        assert fa_ops.flash_attention.launches == before + 1
        close(out, fa_ref.attention_ref(q, k, v, causal=causal,
                                        window=window), 2e-2)
    q, k, v = dev(*_qkv(rng, 3, 70, 200, 8, 2, 128))
    kw = dict(q_offset=torch.tensor([0, 30, 100], dtype=torch.int32).cuda(),
              kv_len=torch.tensor([70, 100, 170], dtype=torch.int32).cuda())
    out = fa_ops.flash_attention(q, k, v, **kw)
    close(out, fa_ref.attention_ref(q, k, v, **kw), 5e-3)
    for i in range(3):
        one = fa_ops.flash_attention(
            q[i:i + 1], k[i:i + 1], v[i:i + 1],
            **{n: t[i:i + 1] for n, t in kw.items()})
        assert torch.equal(out[i:i + 1], one)
    lens = np.asarray([0, 1, 31, 33, 80, 300, 551, 552], np.int32)
    for d in (128, 12):
        qd, kc, vc, _ = _dec(rng, 12, 2, d, 552, lens)
        qd, kc, vc = dev(qd, kc, vc)
        lt = torch.from_numpy(lens).cuda()
        out = da_ops.decode_attention(qd, kc, vc, lt)
        close(out, da_ref.decode_attention_ref(qd, kc, vc, lt), 3e-2)
        assert out[0].abs().max().item() == 0.0
    for n, bs, nb in ((100, 8, 69), (60, 16, 35)):
        q, kp, vp, tables, _ = _paged(rng, 8, 12, 2, 128, n, bs, nb)
        args = dev(q, kp, vp) + [torch.from_numpy(tables).cuda(),
                                 torch.from_numpy(lens).cuda()]
        out = da_ops.paged_decode_attention(*args)
        close(out, da_ref.paged_decode_attention_ref(*args), 2e-3)
        assert out[0].abs().max().item() == 0.0


@pytest.mark.cuda
def test_head_dim_256_decode_matches_plain_on_card():
    """Slotted and paged decode at head_dim 256 (the kernel's second
    head-dim class) against the plain versions on the card, bf16 and
    fp32, g = 1, 4 and 16, over ring-sized caches of 512 and 2,048 rows
    and lengths 0, 1, 31, 33, 511, 512 and 2,048, blocks of 16: fp32
    within 2e-5, bf16 within chip_smoke.py's limits (3e-2 slotted, 2e-3
    paged)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run: python3 chip_smoke.py")
    rng = np.random.RandomState(0)
    tol = {("slotted", torch.float32): TOL, ("paged", torch.float32): TOL,
           ("slotted", torch.bfloat16): 3e-2,
           ("paged", torch.bfloat16): 2e-3}
    for dt in (torch.float32, torch.bfloat16):
        for h, s, lens in ((1, 2048, [0, 1, 31, 33, 511, 512, 2048]),
                           (4, 512, [0, 1, 31, 33, 511, 512]),
                           (16, 2048, [0, 1, 31, 33, 511, 512, 2048])):
            q, kc, vc, ln = _dec(rng, h, 1, 256, s, lens)
            args = [torch.from_numpy(a).cuda().to(dt) for a in (q, kc, vc)]
            ln = torch.from_numpy(ln).cuda()
            got = da_ops.decode_attention(*args, ln).float().cpu()
            want = da_ref.decode_attention_ref(*args, ln).float().cpu()
            t = tol[("slotted", dt)]
            np.testing.assert_allclose(got, want, rtol=t, atol=t)
            assert not got[0].any()
            q, kp, vp, tables, _ = _paged(rng, len(lens), h, 1, 256, 300,
                                          16, s // 16)
            args = [torch.from_numpy(a).cuda().to(dt) for a in (q, kp, vp)]
            tables = torch.from_numpy(tables).cuda()
            got = da_ops.paged_decode_attention(*args, tables, ln)
            want = da_ref.paged_decode_attention_ref(*args, tables, ln)
            t = tol[("paged", dt)]
            np.testing.assert_allclose(got.float().cpu(), want.float().cpu(),
                                       rtol=t, atol=t)


@pytest.mark.cuda
def test_scan_kernel_matches_plain_on_card():
    """The CUDA scan, forward and reverse, against the plain versions on
    the card, on ``SCAN_CASES`` and the chunked body's edges
    (``CARD_CASES``); two calls at the training shape bitwise equal; and
    calls back to back on rotated inputs, each against its plain
    version (no flag of one call is read by the next)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run: python3 chip_smoke.py")

    def inputs(B, S, D, seed=0):
        return tuple(torch.from_numpy(x).cuda()
                     for x in _scan_inputs(B, S, D, seed))

    def both(a, b, h0, dy):
        y = ops.rglru_scan_fwd(a, b, h0)
        return (y,) + ops.rglru_scan_bwd(a, dy, y, h0)

    def check(a, b, h0, dy, got):
        torch.testing.assert_close(got[0], ref.rglru_scan_seq_ref(a, b, h0),
                                   rtol=SCAN_TOL, atol=SCAN_TOL)
        for g, w in zip(got[1:], ref.rglru_scan_reverse_ref(a, dy, got[0],
                                                           h0)):
            torch.testing.assert_close(g, w, rtol=SCAN_TOL, atol=SCAN_TOL)

    for B, S, D in SCAN_CASES + CARD_CASES:
        args = inputs(B, S, D)
        f0, r0 = ops.rglru_scan_fwd.launches, ops.rglru_scan_bwd.launches
        got = both(*args)
        assert (ops.rglru_scan_fwd.launches, ops.rglru_scan_bwd.launches) \
            == (f0 + 1, r0 + 1)
        check(*args, got)
    train = inputs(1, 4096, 4096)
    for x, z in zip(both(*train), both(*train)):
        assert torch.equal(x, z)
    rotated = [inputs(2, 1000, 512, seed) for seed in range(3)]
    outs = [both(*args) for args in rotated * 2]
    for args, got in zip(rotated * 2, outs):
        check(*args, got)
