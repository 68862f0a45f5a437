"""The traffic generator: the same seed gives the same traffic, and
every seed the same lengths in another order."""
from __future__ import annotations

import numpy as np

from conftest import ROOT

from bench.harness import manifest, traffic


def _offers(seed):
    mix = manifest.load_cell(ROOT, "qwen2-1.5b.chat64").mix
    return traffic.serve_offers(mix, 151936, seed), mix


def test_same_seed_same_traffic():
    a, _ = _offers(2**31 + 99)
    b, _ = _offers(2**31 + 99)
    assert all(np.array_equal(x.prompt, y.prompt) and x.max_new == y.max_new
               for x, y in zip(a, b))


def test_every_seed_meets_the_same_work():
    a, mix = _offers(3_000_000_001)
    b, _ = _offers(3_000_000_002)
    for n in (64, 200, 333):
        for key in (lambda o: len(o.prompt), lambda o: o.max_new):
            ma = np.mean([key(o) for o in a[:n]])
            mb = np.mean([key(o) for o in b[:n]])
            assert abs(ma - mb) / ma < 0.03, (n, ma, mb)
    assert [len(o.prompt) for o in a[:8]] != [len(o.prompt) for o in b[:8]]
    assert not np.array_equal(a[0].prompt[:16], b[0].prompt[:16])


def test_lengths_follow_the_mix():
    a, mix = _offers(1)
    assert len(a) == traffic.POOL
    for key, n in ((lambda o: len(o.prompt), "prompt"),
                   (lambda o: o.max_new, "output")):
        lo, hi = mix[n]["lo"], mix[n]["hi"]
        x = np.array([key(o) for o in a])
        assert x.min() >= lo and x.max() <= hi
        assert abs(np.median(np.log(x)) - np.log(np.sqrt(lo * hi))) < 0.05
    u = traffic.spread(1000, traffic.STEPS["prompt"], 0.3)
    assert abs(np.sort(u) - (np.arange(1000) + 0.5) / 1000).max() < 0.01


def test_stagger_spreads_the_first_requests():
    a, mix = _offers(5)
    s = traffic.staggered(a, mix["clients"])
    assert s[0].max_new <= a[0].max_new and s[63].max_new == a[63].max_new
    assert s[64:] == a[64:]
