"""The one traffic generator: a mix file of ``bench/traffic`` -> the
requests a run offers, the same for the same seed.

Lengths follow the mix's distribution at quantiles taken along a
low-discrepancy sequence, ``(offset + i * step) mod 1`` with an
irrational step (one for prompts, another for outputs) and offsets
drawn from the seed: every run of consecutive requests, however long,
holds lengths spread evenly over the distribution, so a window that
completes some hundreds of requests meets the same work on every seed,
in another order. Prompt ids are uniform over the vocabulary, drawn from
the seed.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List

import numpy as np


@dataclass
class Offer:
    """One request the traffic offers: its prompt ids and how many
    tokens it asks for."""
    index: int
    prompt: np.ndarray
    max_new: int


STEPS = {"prompt": (5 ** 0.5 - 1) / 2, "output": 2 ** 0.5 - 1}
# requests in a run's pool: four times and more what a closed loop
# submits in the longest window (``run_seconds`` is at most 51)
POOL = 2048


def lengths(dist: Dict, u: np.ndarray) -> np.ndarray:
    """The lengths of ``dist`` ({"dist": "uniform" | "loguniform",
    "lo", "hi"}) at quantiles ``u``, whole numbers in [lo, hi]."""
    lo, hi = float(dist["lo"]), float(dist["hi"])
    if dist["dist"] == "loguniform":
        x = lo * (hi / lo) ** u
    elif dist["dist"] == "uniform":
        x = lo + (hi - lo) * u
    else:
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    return np.clip(np.rint(x), lo, hi).astype(np.int64)


def spread(n: int, step: float, offset: float) -> np.ndarray:
    """``n`` quantiles ``(offset + i * step) mod 1``."""
    return np.mod(offset + step * np.arange(n), 1.0)


def seed_rng(seed: int, stream: str) -> np.random.Generator:
    """A numpy generator for one named stream of a run's seed."""
    return np.random.default_rng([seed % (1 << 63), seed >> 63,
                                  sum(map(ord, stream)), len(stream)])


def serve_offers(mix: Dict, vocab: int, seed: int) -> List[Offer]:
    """The mix's pool of ``POOL`` requests for ``seed``, in the order a
    closed loop submits them."""
    n = POOL
    rng = seed_rng(seed, "traffic")
    prompts = lengths(mix["prompt"], spread(n, STEPS["prompt"], rng.random()))
    outputs = lengths(mix["output"], spread(n, STEPS["output"], rng.random()))
    ids = rng.integers(0, vocab, size=int(prompts.sum()), dtype=np.int64)
    offs = np.concatenate([[0], np.cumsum(prompts)])
    return [Offer(i, ids[offs[i]:offs[i + 1]].astype(np.int32),
                  int(outputs[i])) for i in range(n)]


def staggered(offers: List[Offer], clients: int) -> List[Offer]:
    """The first ``clients`` offers with their output lengths cut to
    ``ceil(len * (i + 1) / clients)``: a closed loop that starts with
    every client at once would finish its first requests together; cut
    so, they finish spread over one request's lifetime, as a loop in
    its steady state does."""
    out = []
    for i, o in enumerate(offers[:clients]):
        out.append(Offer(o.index, o.prompt,
                         max(1, math.ceil(o.max_new * (i + 1) / clients))))
    return out + offers[clients:]
