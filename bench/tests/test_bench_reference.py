"""The plain reference against the port's plain path at a tiny size on
the CPU: prefill and decode through the cache against the reference's
whole-sequence forward (the MoE's capacity and drops included), and a
training step's loss and gradients."""
from __future__ import annotations

import dataclasses

import pytest
import torch

from conftest import TINY_DENSE, TINY_MOE

from bench.harness import weights
from bench.harness.manifest import as_run
from bench.harness.model import port_config
from bench.reference import qwen2 as R


def _port_fp32(doc, seed):
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(port_config(doc), dtype="float32")
    m = T.Transformer(cfg, device="cpu", dtype=torch.float32)
    weights.load_program(m, doc, seed, masters=True)
    return cfg, m


MOE = as_run(TINY_MOE)


@pytest.mark.parametrize("doc,prompt", [(TINY_DENSE, 100), (MOE, 200),
                                        (MOE, 40)])
def test_serving_agrees_with_the_port_in_fp32(doc, prompt):
    from repro_torch.models import transformer as T
    seed, n = 5, 6
    _, m = _port_fp32(doc, seed)
    g = torch.Generator().manual_seed(prompt)
    p = torch.randint(0, doc["vocab_size"], (1, prompt), generator=g)
    lg, cache, clen = T.prefill(m, p, max_len=prompt + n)
    outs, toks = [lg[0]], [int(lg[0].argmax())]
    for _ in range(n - 1):
        lg, cache, clen = T.decode_step(m, torch.tensor([toks[-1]]), cache,
                                        clen)
        outs.append(lg[0])
        toks.append(int(lg[0].argmax()))
    seq = torch.cat([p[0], torch.tensor(toks[:-1])])
    ref = R.served_logits(doc, weights.ReferenceSource(doc, seed, "cpu"),
                          [seq], [prompt])[None][0]
    assert torch.allclose(torch.stack(outs), ref, atol=2e-5, rtol=1e-5)


def test_moe_drops_past_capacity():
    cfg = dict(MOE)
    logits = torch.zeros(100, 8)
    logits[:, 3] = 5.0                    # every token's first choice: 3
    ids, wts = R.route(cfg, logits, [(0, 100)])
    cap = R.capacity(cfg, 100)            # ceil(100 * 2 * 1.25 / 8) -> 32
    assert cap == 32
    first = (ids[:, 0] == 3) & (wts[:, 0] > 0)
    assert int(first.sum()) == cap and bool(first[:cap].all())


def test_training_step_agrees_with_the_port_in_fp32():
    from repro_torch.models import transformer as T
    seed = 9
    cfg, m = _port_fp32(TINY_DENSE, seed)
    m.requires_grad_(True)
    g = torch.Generator().manual_seed(1)
    tok = torch.randint(0, 512, (2, 48), generator=g)
    loss, _ = T.loss_fn(m, cfg, {"tokens": tok, "labels": tok})
    loss.backward()
    src = weights.ReferenceSource(TINY_DENSE, seed, "cpu")
    layers = [{k: v.requires_grad_(True) for k, v in src.layer(i).items()}
              for i in range(2)]
    params = {"embed": src.embed().requires_grad_(True),
              "final_norm": src.final_norm().requires_grad_(True),
              "head": None, "layers": layers}
    total = sum(R.sequence_loss(TINY_DENSE, params, row) for row in tok) \
        / (2 * 47)
    total.backward()
    assert float(total.detach()) == pytest.approx(float(loss.detach()), rel=1e-5)
    assert torch.allclose(params["embed"].grad, m.embed.grad, atol=1e-6)
    assert torch.allclose(layers[1]["w_down"].grad,
                          m.layers[1].mlp.w_down.grad, atol=1e-6)
    assert torch.allclose(layers[0]["wq"].grad,
                          m.layers[0].block.wq.grad.reshape(64, -1),
                          atol=1e-6)


def test_fake_fp8_is_coarser_than_bf16():
    x = torch.randn(64, 256, generator=torch.Generator().manual_seed(0))
    e8 = (R.fake_fp8(x, -1) - x).abs().max()
    e16 = (x.to(torch.bfloat16).float() - x).abs().max()
    assert e8 > 8 * e16
