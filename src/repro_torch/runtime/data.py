"""Synthetic data pipeline: deterministic, infinite, host-side.

A verbatim numpy copy of ``repro.runtime.data`` (no JAX in it), kept in
the port so that ``repro_torch`` imports nothing from ``repro``: with the
same seed both packages see the same batches.

Two generators:
* ``lm_batches`` — zipf-distributed token stream with local bigram
  structure, so a real model shows decreasing loss (used by the training
  examples and integration tests).
* ``copy_task_batches`` — the classic learnability probe: the model must
  copy a prefix after a separator; loss -> ~0 proves the training loop
  optimizes end-to-end.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


def lm_batches(batch: int, seq: int, vocab: int, *, seed: int = 0
               ) -> Iterator[Dict[str, np.ndarray]]:
    rng = np.random.RandomState(seed)
    # fixed random bigram transition table over a zipf-ish marginal
    marg = 1.0 / np.arange(1, vocab + 1) ** 1.1
    marg /= marg.sum()
    n_ctx = min(vocab, 512)
    trans = rng.dirichlet(0.05 * vocab * marg, size=n_ctx)
    while True:
        toks = np.empty((batch, seq + 1), np.int64)
        toks[:, 0] = rng.choice(vocab, size=batch, p=marg)
        for t in range(1, seq + 1):
            rows = trans[toks[:, t - 1] % n_ctx]
            cum = rows.cumsum(1)
            u = rng.rand(batch, 1)
            toks[:, t] = (u < cum).argmax(1)
        yield {"tokens": toks[:, :-1].astype(np.int32),
               "labels": toks[:, 1:].astype(np.int32)}


def copy_task_batches(batch: int, seq: int, vocab: int, *, seed: int = 0
                      ) -> Iterator[Dict[str, np.ndarray]]:
    assert seq % 2 == 0
    half = seq // 2
    sep = vocab - 1
    rng = np.random.RandomState(seed)
    while True:
        prefix = rng.randint(1, vocab - 1, size=(batch, half))
        toks = np.concatenate(
            [prefix, np.full((batch, 1), sep), prefix[:, :half - 1]], axis=1)
        labels = np.concatenate(
            [np.full((batch, half), -1), prefix], axis=1)
        yield {"tokens": toks.astype(np.int32),
               "labels": labels.astype(np.int32)}
