"""A run with the timed path broken underneath comes out not correct:
the harness's look for a card skipped, the rest of a run driven on the
CPU at a tiny size, once for each fault the cell can have."""
from __future__ import annotations

import pytest
import torch

from conftest import execute


def _altered_token(monkeypatch):
    from repro_torch.runtime import policies
    orig = policies.sample_tokens

    def altered(gen, logits, **kw):
        t = orig(gen, logits, **kw)
        return (t + 1) % logits.shape[-1]
    monkeypatch.setattr(policies, "sample_tokens", altered)


def _cache_unchanged(monkeypatch):
    from repro_torch.models import transformer as T
    orig = T.decode_step

    def unchanged(model, token, cache, cache_len, **kw):
        scratch = [{k: v.clone() for k, v in c.items()} for c in cache]
        logits, _, clen = orig(model, token, scratch, cache_len, **kw)
        return logits, cache, clen
    monkeypatch.setattr(T, "decode_step", unchanged)


def _update_skipped(monkeypatch):
    from repro_torch.runtime import optim
    orig = optim.apply

    def skipped(cfg, model, opt):
        saved = [p.detach().clone() for p in model.parameters()]
        model, opt, m = orig(cfg, model, opt)
        with torch.no_grad():
            for p, s in zip(model.parameters(), saved):
                p.copy_(s)
        return model, opt, m
    monkeypatch.setattr(optim, "apply", skipped)


def _half_batch(monkeypatch):
    from repro_torch.models import transformer as T
    orig = T.loss_fn

    def half(model, cfg, batch, ctx=None):
        n = batch["tokens"].shape[0] // 2
        return orig(model, cfg, {k: v[:n] for k, v in batch.items()}, ctx)
    monkeypatch.setattr(T, "loss_fn", half)


@pytest.mark.parametrize("cell,fault", [
    ("tiny-dense.serve", _altered_token),
    ("tiny-dense.serve", _cache_unchanged),
    ("tiny-moe.serve", _altered_token),
    ("tiny-moe.serve", _cache_unchanged),
    ("tiny-dense.train", _update_skipped),
    ("tiny-dense.train", _half_batch)])
def test_a_broken_path_is_not_correct(tiny_root, monkeypatch, cell, fault):
    sound, _ = execute(tiny_root, cell)
    assert sound["correct"] is True, sound["checks"]
    fault(monkeypatch)
    broken, _ = execute(tiny_root, cell)
    assert broken["correct"] is False, broken["checks"]
