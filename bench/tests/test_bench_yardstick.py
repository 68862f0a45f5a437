"""The frozen yardstick against hand-worked values at the cells' shapes,
and once against the port's own cost functions as they stand."""
from __future__ import annotations

import json

import pytest

from conftest import ROOT

from bench.yardstick import cost as C
from bench.yardstick import flops as Y
from bench.yardstick import peaks


def _cfg(name):
    return json.loads((ROOT / "bench" / "configs" / f"{name}.json")
                      .read_text())


def test_flash_cost_by_hand():
    # one 2,048-token causal prefill of qwen2-1.5b: 12 heads of 128
    c = C.flash_attention_cost((1, 2048, 12, 128), (1, 2048, 2, 128))
    assert c.flops == 4 * 128 * 12 * (2048 * 2049 // 2)
    assert c.bytes == 2 * (2 * 2048 * 12 * 128 + 2 * 2048 * 2 * 128)


def test_decode_cost_by_hand():
    # 64 slots of 1,000 live rows each, 12 heads over 2 kv heads
    c = C.decode_attention_cost(64, 12, 2, 128, live_rows=64_000)
    assert c.flops == 4 * 128 * 64_000 * 12
    assert c.bytes == 2 * (2 * 64_000 * 2 * 128 + 64 * 12 * 128) \
        + 2 * 64 * 12 * 128 + 4 * 64


def test_live_pairs_closed_form():
    assert C.live_pairs(300, 300, causal=True) == C.causal_pairs(300)
    assert C.live_pairs(4, 10, causal=True, q_offset=[6], kv_len=[10]) \
        == 7 + 8 + 9 + 10


def test_model_operations_by_hand():
    q = _cfg("qwen2-1.5b")
    attn = 1536 * (12 + 4) * 128 + 12 * 128 * 1536
    mlp = 3 * 1536 * 8960
    assert Y.matmul_params_per_token(q) == 28 * (attn + mlp) \
        + 1536 * 151936
    assert 1.5e9 < Y.matmul_params_per_token(q) < 1.6e9
    body = 28 * (attn + mlp)
    m = _cfg("qwen2-moe-a2.7b")
    attn = 4 * 2048 * 2048
    ffn = 3 * 2048 * 1408 * 4 + 3 * 2048 * 5632 + 2048 * 60
    assert Y.matmul_params_per_token(m) == 24 * (attn + ffn) \
        + 2048 * 151936
    assert 2.3e9 < Y.matmul_params_per_token(m) < 2.5e9
    # a prefill: the LM head at the last of its 10 positions alone
    assert Y.prefill_flops(q, 10) == 2 * body * 10 + 2 * 1536 * 151936 \
        + 4 * 128 * 12 * 28 * 55
    assert Y.decode_flops(q, 10) == 2 * Y.matmul_params_per_token(q) \
        + 4 * 128 * 12 * 28 * 10
    # training: the head at every position, forward and backward
    assert Y.train_step_flops(q, 8, 4096) == 3 * 8 * (
        2 * Y.matmul_params_per_token(q) * 4096
        + 4 * 128 * 12 * 28 * (4096 * 4097 // 2))


def test_peaks():
    assert peaks.bound_s(989e12, 0) == pytest.approx(1.0)
    assert peaks.bound_s(0, 3.35e12) == pytest.approx(1.0)


@pytest.mark.parametrize("shape", [
    ((1, 2048, 12, 128), (1, 2048, 2, 128)),
    ((1, 7168, 12, 128), (1, 7168, 2, 128)),
    ((1, 1024, 16, 128), (1, 1024, 16, 128)),
    ((2, 4096, 12, 128), (2, 4096, 2, 128))])
def test_agrees_with_the_port_as_it_stands(shape):
    from repro_torch.kernels.decode_attention.ops import decode_attention_cost
    from repro_torch.kernels.flash_attention.ops import flash_attention_cost
    assert C.flash_attention_cost(*shape, return_lse=True) == \
        C.Cost(*vars(flash_attention_cost(*shape, return_lse=True))
               .values())
    b, _, h, d = shape[0]
    assert C.decode_attention_cost(b * 32, h, shape[1][2], d,
                                   live_rows=77_777) == \
        C.Cost(*vars(decode_attention_cost(b * 32, h, shape[1][2], d,
                                           live_rows=77_777)).values())
