"""Parity of the port's attention (the kernel wrappers' plain versions on
the CPU) with the reference's four attention paths: the ``ref.py``
oracles, the XLA production functions, and the Pallas kernels in
interpret mode. fp32, tolerance 2e-5 as in tests/test_kernels.py.

On a CPU tensor a wrapper must reach its plain version and leave its
launch counter at 0; on the card it launches the CUDA kernel
(``test_kernels_match_plain_on_card``, marked ``cuda``).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.kernel import decode_attention_pallas
from repro.kernels.decode_attention.ref import decode_attention_ref
from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.flash_attention.ref import attention_ref
from repro.models.layers import decode_attention_xla, flash_attention_xla
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention import ref as da_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref

TOL = 2e-5

FA_SHAPES = [
    # (b, sq, sk, h, hk, d, causal, window)
    (2, 37, 37, 4, 2, 16, True, 0),
    (2, 64, 64, 4, 1, 32, True, 24),
    (2, 20, 45, 4, 2, 12, False, 0),
    (1, 33, 33, 6, 2, 16, True, 5),
]
DEC_SHAPES = [
    # (h, hk, d, s, lengths)
    (4, 2, 16, 40, [1, 17, 40]),
    (8, 2, 12, 33, [1, 33]),
    (6, 1, 32, 64, [64, 1, 2, 50]),
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


def test_wrappers_refuse_what_no_kernel_takes():
    q = torch.zeros((1, 4, 2, 16))
    k = torch.zeros((1, 4, 1, 16))
    with pytest.raises(TypeError):
        fa_ops.flash_attention(q.double(), k.double(), k.double())
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q, k, k[:, :3])
    with pytest.raises(ValueError, match="no kernel"):
        fa_ops.flash_attention(q.to("meta"), k.to("meta"), k.to("meta"))
    qd, kc = torch.zeros((2, 4, 16)), torch.zeros((2, 8, 2, 16))
    with pytest.raises(TypeError, match="int32"):
        da_ops.decode_attention(qd, kc, kc, torch.ones(2, dtype=torch.int64))
    with pytest.raises(ValueError, match="no kernel"):
        da_ops.decode_attention(qd.to("meta"), kc.to("meta"), kc.to("meta"),
                                torch.ones(2, dtype=torch.int32,
                                           device="meta"))


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
