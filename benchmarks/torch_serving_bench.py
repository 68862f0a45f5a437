"""Serving benchmark on the port: static-bucket vs continuous vs
continuous+pipelined.

``benchmarks/serving_bench.py`` run on ``repro_torch``: the same
sections, flags, configurations and assertions, every engine on
``--device`` (default ``cuda``; ``cpu`` runs without a card). The rows
are written to ``benchmarks/results/torch_serving.json`` unless
``--out`` says where. "Compile" below is the first call's kernel build
and allocator warmup on the port.

Workload: Poisson request arrivals with mixed prompt lengths (the
open-loop serving regime). All engine configurations are the same
policy-based ``Engine`` under different ``EngineConfig``s:

* ``batch``        — the seed static-bucket executor: per-(batch,
  prompt_len) buckets, each bucket decoded to completion serially;
* ``fifo``         — the slot-based continuous-batching scheduler:
  per-step admission/eviction into a shared decode batch;
* ``priority``     — same scheduler, priority admission: measured on the
  same Poisson trace with a contended slot budget, asserting that
  high-priority requests beat their FIFO TTFT p99 (they jump the queue);
* ``disaggregated`` — the multi-unit execution core: the same
  closed-loop trace through a single-unit, a 2-unit prefill/decode
  split, and a 3-unit pipelined-decode topology on modeled per-unit
  clocks, asserting bit-identical tokens and a >= 1.3x modeled-makespan
  improvement for the 2-unit split;
* ``continuous+pipelined`` — the Edge-PRUNE angle: prefill partitioned
  across two processing units via a StagedProgram, frames streamed
  through the stage pipeline with modeled per-unit clocks (paper
  platform, Sec III.B), reported as modeled makespan vs the sequential
  execution of the same stages.

``--paged`` additionally measures the paged-KV + chunked-prefill engine
against the slotted continuous baseline on the same Poisson trace:
pool/high-water KV bytes vs the dense slotted reservation, TTFT p50/p99
for both, and the growth-preemption count under the admission
``--watermark`` (0 = no headroom reserved).

``--prefix-cache`` measures paged prefix sharing on a *shared-prefix*
Poisson trace (every prompt opens with the same preamble — the
edge-serving pattern where many endpoint clients reuse one task header):
the same trace runs with sharing off and on, asserting identical greedy
tokens, >= 30% of prompt tokens skipping prefill, and a lower pool
high-water mark; reports prefill tokens saved, pool high-water and TTFT
p50/p99 for both.

    PYTHONPATH=src:. python benchmarks/torch_serving_bench.py --tiny --device cpu [--paged --prefix-cache]
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path
from typing import List, Optional

import numpy as np

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmarks.common import HEADER, Row, emit  # noqa: E402
from repro_torch.core import (Explorer, Mapping, PlatformModel,  # noqa: E402
                              paper_platform, tpu_pod_platform)
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.runtime import engine as _engine  # noqa: E402
from repro_torch.runtime.engine import EngineConfig  # noqa: E402
from repro_torch.runtime.observability import pipeline_trace  # noqa: E402
from repro_torch.runtime.serving import (  # noqa: E402
    PartitionedServeEngine, Request)


def Engine(cfg, model, config=None) -> "_engine.Engine":
    """The port's ``Engine`` on the model's device."""
    return _engine.Engine(cfg, model, config, device=model.device)

PROMPT_LENS = (32, 48, 64, 96)


def _cfg(tiny: bool = False) -> ModelConfig:
    if tiny:
        return ModelConfig(
            name="bench-tiny", arch_type="dense", n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
            dtype="float32", param_dtype="float32", attn_chunk=32,
            remat=False)
    return ModelConfig(
        name="bench-120m", arch_type="dense", n_layers=4, d_model=256,
        n_heads=8, n_kv_heads=4, d_ff=1024, vocab_size=2048,
        dtype="float32", param_dtype="float32", attn_chunk=64, remat=False)


def _requests(cfg: ModelConfig, n: int, max_new: int, *,
              lens=PROMPT_LENS, seed: int = 0) -> List[Request]:
    rng = np.random.RandomState(seed)
    return [Request(i, rng.randint(0, cfg.vocab_size,
                                   lens[i % len(lens)]).astype(np.int32),
                    max_new_tokens=max_new) for i in range(n)]


def _poisson_arrivals(n: int, rate_per_s: float, seed: int = 0) -> List[float]:
    rng = np.random.RandomState(seed)
    return list(np.cumsum(rng.exponential(1.0 / rate_per_s, size=n)))


def _measure(eng: "_engine.Engine", reqs: List[Request],
             arrivals: Optional[List[float]]) -> dict:
    t0 = time.perf_counter()
    outs = eng.generate(reqs, arrivals=arrivals) \
        if not eng.batch_mode else eng.generate(reqs)
    wall = time.perf_counter() - t0
    toks = sum(len(o.tokens) for o in outs)
    lat = [o.latency_s for o in outs if o.finish_s > 0.0]
    return {
        "throughput": toks / wall,
        "wall_s": wall,
        "mean_latency_s": float(np.mean(lat)) if lat else wall,
        "p95_latency_s": float(np.percentile(lat, 95)) if lat else wall,
        "outs": outs,
    }


def _priority_rows(cfg, params, reqs, arrivals, *, max_len: int) -> List[Row]:
    """Priority admission vs FIFO on the same Poisson trace under a
    contended slot budget (2 slots): the last quarter of arrivals is
    marked high-priority, so under FIFO they queue behind everything
    already waiting while priority admission jumps them to the head.
    Asserts the headline property: priority scheduling improves the
    high-priority cohort's TTFT p99."""
    hi = max(1, len(reqs) // 4)
    hi_ids = {r.id for r in reqs[-hi:]}
    prio_reqs = [Request(r.id, r.prompt, max_new_tokens=r.max_new_tokens,
                         eos=r.eos, embeds=r.embeds,
                         priority=5 if r.id in hi_ids else 0) for r in reqs]
    ttft_p99 = {}
    for name in ("fifo", "priority"):
        eng = Engine(cfg, params, EngineConfig(
            max_len=max_len, max_slots=2, admission=name))
        eng.generate(prio_reqs)             # warmup (kernel builds), closed loop
        # best-of-2 damps wall-clock hiccups (the hi cohort is small, so
        # its p99 is ~a max — a single descheduling pause would dominate)
        p99s = []
        for _ in range(2):
            o = _measure(eng, prio_reqs, arrivals)
            ttfts = [x.ttft_s for x in o["outs"] if x.id in hi_ids]
            p99s.append(float(np.percentile(ttfts, 99)))
        ttft_p99[name] = min(p99s)
    # wall-clock comparative gate (the headline property): the
    # structural gap under contention is ~3x, so a 15%-relative + 1ms
    # margin tolerates runner jitter while still failing if priority
    # scheduling stops helping the high-priority cohort at all
    assert ttft_p99["priority"] <= ttft_p99["fifo"] \
        + max(1e-3, 0.15 * ttft_p99["fifo"]), \
        (f"priority admission must not worsen high-priority TTFT p99: "
         f"{ttft_p99['priority']:.4f}s vs fifo {ttft_p99['fifo']:.4f}s")
    return [
        Row("serving", "fifo_hi_ttft_p99_ms", ttft_p99["fifo"] * 1e3, "ms"),
        Row("serving", "priority_hi_ttft_p99_ms",
            ttft_p99["priority"] * 1e3, "ms"),
    ]


def _paged_rows(cfg, params, reqs, arrivals, *, max_len: int, slots: int,
                watermark: int, slotted_outs) -> List[Row]:
    """Paged + chunked-prefill engine vs the slotted baseline on the same
    Poisson trace: KV memory (pool + high-water mark vs the dense slotted
    reservation), TTFT p50/p99, and growth preemptions under the
    admission watermark."""
    pag = Engine(cfg, params, EngineConfig(
        max_len=max_len, max_slots=slots, kv_layout="paged", block_size=16,
        prefill_chunk=16, watermark=watermark))
    pag.generate(reqs)                  # warmup (kernel builds)
    # the closed-loop warmup saturates the pool; report the high-water
    # mark of the measured Poisson run only
    pag.scheduler.alloc.reset_hwm()
    pre_warmup = pag.stats()["preemptions"]
    o = _measure(pag, reqs, arrivals)
    stats = pag.kv_stats()
    preemptions = pag.stats()["preemptions"] - pre_warmup
    ttft_p = [x.ttft_s for x in o["outs"]]
    ttft_s = [x.ttft_s for x in slotted_outs]
    return [
        Row("serving", "paged_tokens_per_s", o["throughput"], "tok/s"),
        Row("serving", "slotted_kv_reserved_bytes",
            stats["slotted_kv_reserved_bytes"], "B"),
        Row("serving", "paged_kv_pool_bytes", stats["paged_kv_pool_bytes"],
            "B"),
        Row("serving", "paged_kv_hwm_bytes", stats["paged_kv_hwm_bytes"],
            "B"),
        Row("serving", "paged_watermark_blocks", float(watermark), "blk"),
        Row("serving", "paged_poisson_preemptions", float(preemptions),
            "req"),
        Row("serving", "paged_poisson_ttft_p50_ms",
            float(np.percentile(ttft_p, 50)) * 1e3, "ms"),
        Row("serving", "paged_poisson_ttft_p99_ms",
            float(np.percentile(ttft_p, 99)) * 1e3, "ms"),
        Row("serving", "slotted_poisson_ttft_p50_ms",
            float(np.percentile(ttft_s, 50)) * 1e3, "ms"),
        Row("serving", "slotted_poisson_ttft_p99_ms",
            float(np.percentile(ttft_s, 99)) * 1e3, "ms"),
    ]


def _shared_prefix_requests(cfg: ModelConfig, n: int, max_new: int, *,
                            prefix_len: int, seed: int = 3) -> List[Request]:
    """The edge-serving traffic shape: every prompt opens with the same
    ``prefix_len``-token preamble (task instructions / few-shot header),
    followed by a per-request tail of varying length."""
    rng = np.random.RandomState(seed)
    shared = rng.randint(0, cfg.vocab_size, prefix_len).astype(np.int32)
    tails = (8, 16, 24, 32)
    return [Request(i, np.concatenate([
                shared, rng.randint(0, cfg.vocab_size,
                                    tails[i % len(tails)]).astype(np.int32)]),
                    max_new_tokens=max_new) for i in range(n)]


def _prefix_rows(cfg, params, *, max_len: int, slots: int, n: int,
                 max_new: int, rate: float, seed: int) -> List[Row]:
    """Prefix sharing on vs off over the same shared-prefix Poisson
    trace. Asserts the headline properties: identical greedy tokens,
    >= 30% of prompt tokens skipping prefill, and a lower paged-pool
    high-water mark (shared chains are resident once, not per slot)."""
    prefix_len = 48
    reqs = _shared_prefix_requests(cfg, n, max_new, prefix_len=prefix_len)
    # arrive fast relative to service so shared chains stay resident
    arrivals = _poisson_arrivals(n, rate_per_s=max(rate, 200.0), seed=seed)
    runs = {}
    for on in (False, True):
        eng = Engine(cfg, params, EngineConfig(
            max_len=max_len, max_slots=slots, kv_layout="paged",
            block_size=16, prefix_cache=on))
        eng.generate(reqs)              # warmup (kernel builds), closed loop
        eng.scheduler.alloc.reset_hwm()
        base = eng.stats()
        o = _measure(eng, reqs, arrivals)
        st = eng.stats()
        runs[on] = {
            "outs": o["outs"],
            "hwm": eng.kv_stats()["paged_kv_hwm_blocks"],
            "saved": st["prefill_tokens_saved"] - base["prefill_tokens_saved"],
            "total": st["prefill_tokens_total"] - base["prefill_tokens_total"],
            "hits": st["prefix_hits"] - base["prefix_hits"],
            "ttft": [x.ttft_s for x in o["outs"]],
        }
    assert [c.tokens for c in runs[True]["outs"]] == \
        [c.tokens for c in runs[False]["outs"]], \
        "prefix sharing changed greedy tokens"
    saved_frac = runs[True]["saved"] / max(runs[True]["total"], 1)
    assert saved_frac >= 0.30, \
        (f"shared-prefix trace must skip >= 30% of prefill tokens, got "
         f"{saved_frac:.1%} ({runs[True]['saved']}/{runs[True]['total']})")
    assert runs[True]["hwm"] < runs[False]["hwm"], \
        (f"prefix sharing must lower the pool high-water mark: "
         f"{runs[True]['hwm']:.0f} vs {runs[False]['hwm']:.0f} blocks")
    return [
        Row("serving", "prefix_shared_prompt_tokens", float(prefix_len),
            "tok"),
        Row("serving", "prefix_prefill_tokens_saved",
            float(runs[True]["saved"]), "tok"),
        Row("serving", "prefix_prefill_tokens_saved_frac", saved_frac, "x"),
        Row("serving", "prefix_hits", float(runs[True]["hits"]), "req"),
        Row("serving", "prefix_on_kv_hwm_blocks", runs[True]["hwm"], "blk"),
        Row("serving", "prefix_off_kv_hwm_blocks", runs[False]["hwm"], "blk"),
        Row("serving", "prefix_on_ttft_p50_ms",
            float(np.percentile(runs[True]["ttft"], 50)) * 1e3, "ms"),
        Row("serving", "prefix_on_ttft_p99_ms",
            float(np.percentile(runs[True]["ttft"], 99)) * 1e3, "ms"),
        Row("serving", "prefix_off_ttft_p50_ms",
            float(np.percentile(runs[False]["ttft"], 50)) * 1e3, "ms"),
        Row("serving", "prefix_off_ttft_p99_ms",
            float(np.percentile(runs[False]["ttft"], 99)) * 1e3, "ms"),
    ]


def _victim_rows(cfg, params, *, max_len: int, slots: int, n: int,
                 max_new: int, tenants: int) -> List[Row]:
    """The prefix-cache *service* section: a two-wave multi-tenant
    shared-prefix trace, victim cache on vs off. Wave 1 drains fully
    (every chain hits refcount 0); wave 2 re-sends the same per-tenant
    prompts as cold admissions. With the victim cache on those must
    resume from parked chains (``victim_hits`` counts exactly the
    cross-request hits — it is structurally zero with the cache off),
    and retention must never change the greedy tokens."""
    tenants = max(tenants, 1)
    prefix_len = 32
    rng = np.random.RandomState(5)
    names = [f"tenant{t}" for t in range(tenants)]
    preamble = {t: rng.randint(0, cfg.vocab_size, prefix_len)
                .astype(np.int32) for t in names}
    per = max(n // tenants, 2)
    prompts = [(t, np.concatenate(
        [preamble[t], rng.randint(0, cfg.vocab_size,
                                  8 + 4 * (i % 3)).astype(np.int32)]))
        for t in names for i in range(per)]

    def wave_reqs(base: int) -> List[Request]:
        return [Request(base + i, p.copy(), max_new_tokens=max_new,
                        tenant=t) for i, (t, p) in enumerate(prompts)]

    runs = {}
    for on in (False, True):
        eng = Engine(cfg, params, EngineConfig(
            max_len=max_len, max_slots=slots, kv_layout="paged",
            block_size=16, prefix_cache=True, victim_cache=on))
        w1 = eng.generate(wave_reqs(0))         # also the kernel-build warmup
        base = eng.stats()
        w2 = eng.generate(wave_reqs(10_000))    # cold cross-drain replay
        st = eng.stats()
        runs[on] = {
            "w1": w1, "w2": w2,
            "victim_hits": st["victim_hits"] - base["victim_hits"],
            "saved": st["prefill_tokens_saved"]
            - base["prefill_tokens_saved"],
            "total": st["prefill_tokens_total"]
            - base["prefill_tokens_total"],
            "snap": eng.snapshot().get("prefix_cache", {}),
        }
    for w in ("w1", "w2"):
        assert [c.tokens for c in runs[True][w]] == \
            [c.tokens for c in runs[False][w]], \
            f"victim cache changed greedy tokens (wave {w})"
    assert runs[False]["victim_hits"] == 0, \
        "victim_hits must be structurally zero with the cache off"
    assert runs[True]["victim_hits"] > 0, \
        "cold replay never resumed from a parked chain"
    snap = runs[True]["snap"]
    assert len(snap.get("per_tenant_bytes", {})) == tenants, \
        "victim pool is missing a tenant's namespace"
    hit_rate = runs[True]["victim_hits"] / len(prompts)
    saved_frac = runs[True]["saved"] / max(runs[True]["total"], 1)
    return [
        Row("serving", "victim_tenants", float(tenants), "n"),
        Row("serving", "victim_cross_request_hit_rate", hit_rate, "x"),
        Row("serving", "victim_hits", float(runs[True]["victim_hits"]),
            "req"),
        Row("serving", "victim_prefill_tokens_saved_frac", saved_frac, "x"),
        Row("serving", "victim_bytes_saved",
            float(runs[True]["saved"] * T.kv_row_bytes(cfg)), "B"),
        Row("serving", "victim_pool_blocks",
            float(snap.get("victim_blocks", 0)), "blk"),
        Row("serving", "victim_evictions",
            float(snap.get("victim_evictions", 0)), "n"),
    ]


def _disagg_rows(cfg, params, *, tiny: bool) -> List[Row]:
    """Prefill/decode disaggregation on the multi-unit execution core:
    one closed-loop trace through three unit topologies — single unit
    (the degenerate case: modeled makespan == the sequential work sum),
    a 2-unit prefill/decode split, and a 3-unit split with 2 pipelined
    decode stages. Tokens must be bit-identical across all three (unit
    topologies move modeled time, never content); the headline gate is
    the 2-unit split beating single-unit modeled makespan by >= 1.3x.
    The workload balances prompt and decode work and keeps the slot
    batch small, so the dedicated prefill unit runs ahead on the next
    admissions while the decode unit drains the current batch."""
    n, plen, new = (6, 16, 16) if tiny else (8, 48, 48)
    rng = np.random.RandomState(5)
    reqs = [Request(i, rng.randint(0, cfg.vocab_size, plen).astype(np.int32),
                    max_new_tokens=new) for i in range(n)]
    topos = {
        "single": dict(),
        "disagg": dict(units=2, prefill_units=1),
        "disagg_pipelined": dict(units=3, prefill_units=1, decode_stages=2),
    }
    outs, summ = {}, {}
    for name, kw in topos.items():
        eng = Engine(cfg, params, EngineConfig(
            max_len=plen + new + 8, max_slots=2, **kw))
        outs[name] = eng.generate(reqs)
        summ[name] = eng.scheduler.core.summary()
    for name in ("disagg", "disagg_pipelined"):
        assert [c.tokens for c in outs[name]] == \
            [c.tokens for c in outs["single"]], \
            f"unit topology {name} changed greedy tokens"
        assert summ[name]["kv_handoffs"] == n
        # same requests -> same total modeled work on every topology
        assert abs(summ[name]["modeled_sequential_s"]
                   - summ["single"]["modeled_sequential_s"]) < 1e-9
    mk = {k: v["modeled_makespan_s"] for k, v in summ.items()}
    # single unit is the degenerate case: nothing overlaps
    assert abs(mk["single"] - summ["single"]["modeled_sequential_s"]) < 1e-9
    speedup = mk["single"] / mk["disagg"]
    assert speedup >= 1.3, \
        (f"2-unit prefill/decode split must improve modeled makespan "
         f">= 1.3x over single-unit, got {speedup:.2f}x "
         f"({mk['disagg']:.4f}s vs {mk['single']:.4f}s)")
    return [
        Row("serving", "single_unit_modeled_makespan_s", mk["single"], "s"),
        Row("serving", "disagg_modeled_makespan_s", mk["disagg"], "s"),
        Row("serving", "disagg_modeled_speedup", speedup, "x"),
        Row("serving", "disagg_pipelined_modeled_makespan_s",
            mk["disagg_pipelined"], "s"),
        Row("serving", "disagg_pipelined_modeled_speedup",
            mk["single"] / mk["disagg_pipelined"], "x"),
        Row("serving", "disagg_kv_handoffs",
            float(summ["disagg"]["kv_handoffs"]), "req"),
    ]


def _observability_rows(cfg, params, reqs, arrivals, *, max_len: int,
                        slots: int):
    """The same open-loop Poisson trace through an observability-enabled
    continuous engine: the engine's own histogram summaries (TTFT, queue
    wait, step duration) become bench rows; the engine's
    ``Observability`` rides back so ``run`` can append the pipelined
    section's modeled timeline before writing ``--trace-out``."""
    eng = Engine(cfg, params, EngineConfig(
        max_len=max_len, max_slots=slots, observability=True))
    eng.generate(reqs)                  # warmup (kernel builds), closed loop
    # scope the summaries to the measured window: the warmup's
    # build-inflated TTFTs would otherwise dominate every percentile
    eng.obs.registry.reset_histograms()
    _measure(eng, reqs, arrivals)
    h = eng.snapshot()["metrics"]["histograms"]

    def p(name: str, q: str) -> float:
        return float(h.get(name, {}).get(q, 0.0)) * 1e3

    rows = [
        Row("serving", "obs_ttft_p50_ms", p("repro_ttft_seconds", "p50"),
            "ms"),
        Row("serving", "obs_ttft_p99_ms", p("repro_ttft_seconds", "p99"),
            "ms"),
        Row("serving", "obs_queue_wait_p50_ms",
            p("repro_queue_wait_seconds", "p50"), "ms"),
        Row("serving", "obs_step_duration_p50_ms",
            p("repro_step_duration_seconds", "p50"), "ms"),
        Row("serving", "obs_inter_token_p50_ms",
            p("repro_inter_token_seconds", "p50"), "ms"),
    ]
    return rows, eng.obs


def run(*, tiny: bool = False, n_requests: Optional[int] = None,
        max_new: Optional[int] = None, rate: float = 200.0,
        seed: int = 1, paged: bool = False, watermark: int = 0,
        prefix_cache: bool = False, victim_cache: bool = False,
        tenants: int = 0, trace_out: Optional[str] = None,
        device="cuda") -> List[Row]:
    cfg = _cfg(tiny)
    n = n_requests or (8 if tiny else 16)
    new = max_new or (8 if tiny else 32)
    max_len = max(PROMPT_LENS) + new + 8
    slots = min(n, 8)
    params = T.init_params(cfg, 0, device=device)
    reqs = _requests(cfg, n, new)
    arrivals = _poisson_arrivals(n, rate_per_s=rate, seed=seed)

    static = Engine(cfg, params, EngineConfig(max_len=max_len,
                                              admission="batch"))
    cont = Engine(cfg, params, EngineConfig(max_len=max_len,
                                            max_slots=slots))
    # warmup both paths so kernel builds don't pollute the comparison
    static.generate(reqs)
    cont.generate(reqs)

    # Closed-loop throughput: both modes get every request at t=0, so the
    # comparison isolates scheduling (shared decode batch vs per-bucket
    # loops), not arrival waiting. Best-of-2 damps CI noise.
    s = max((_measure(static, reqs, None) for _ in range(2)),
            key=lambda m: m["throughput"])
    c = max((_measure(cont, reqs, None) for _ in range(2)),
            key=lambda m: m["throughput"])
    # Open-loop latency under Poisson arrivals (continuous only: the
    # static engine has no admission queue to feed mid-flight).
    o = _measure(cont, reqs, arrivals)
    rows = [
        Row("serving", "static_bucket_tokens_per_s", s["throughput"], "tok/s"),
        Row("serving", "continuous_tokens_per_s", c["throughput"], "tok/s"),
        Row("serving", "continuous_vs_static_speedup",
            c["throughput"] / s["throughput"], "x"),
        Row("serving", "poisson_mean_latency_ms",
            o["mean_latency_s"] * 1e3, "ms"),
        Row("serving", "poisson_p95_latency_ms",
            o["p95_latency_s"] * 1e3, "ms"),
        Row("serving", "poisson_mean_ttft_ms",
            float(np.mean([x.ttft_s for x in o["outs"]])) * 1e3, "ms"),
    ]
    rows += _priority_rows(cfg, params, reqs, arrivals, max_len=max_len)
    obs_rows, obs = _observability_rows(cfg, params, reqs, arrivals,
                                        max_len=max_len, slots=slots)
    rows += obs_rows
    if paged:
        rows += _paged_rows(cfg, params, reqs, arrivals, max_len=max_len,
                            slots=slots, watermark=watermark,
                            slotted_outs=o["outs"])
    if prefix_cache:
        rows += _prefix_rows(cfg, params, max_len=max_len, slots=slots,
                             n=n, max_new=new, rate=rate, seed=seed)
    if victim_cache:
        rows += _victim_rows(cfg, params, max_len=max_len, slots=slots,
                             n=n, max_new=new, tenants=tenants or 4)
    rows += _disagg_rows(cfg, params, tiny=tiny)

    # continuous+pipelined: prefill stream through a 2-unit StagedProgram
    # on the paper's N2/i7 WiFi platform (overlapping link), modeled clocks.
    seq_len = PROMPT_LENS[0]
    g = T.to_actor_graph(cfg, params, batch=1, seq=seq_len, group_size=2)
    names = list(g.actors)
    mapping = Mapping("half", {nm: ("endpoint" if i < len(names) // 2
                                    else "server")
                               for i, nm in enumerate(names)})
    pse = PartitionedServeEngine(cfg, params, mapping, batch=1, seq=seq_len,
                                 group_size=2)
    pm = PlatformModel(paper_platform("N2", "wifi"))
    rng = np.random.RandomState(2)
    frames = [rng.randint(0, cfg.vocab_size, (1, seq_len)).astype(np.int32)
              for _ in range(n)]
    _, sched = pse.infer_pipelined(frames, platform=pm)
    rows += [
        Row("serving", "pipelined_modeled_makespan_s", sched.makespan_s, "s"),
        Row("serving", "pipelined_modeled_sequential_s", sched.sequential_s,
            "s"),
        Row("serving", "pipelined_modeled_speedup", sched.speedup, "x"),
        Row("serving", "partitioned_comm_bytes", pse.comm_bytes(), "B"),
    ]
    assert sched.makespan_s < sched.sequential_s, \
        "pipelined execution must beat sequential stage execution"
    if trace_out:
        # wall-clock engine tracks + the pipelined section's modeled
        # unit tracks in one file (separate processes, separate clocks)
        pipeline_trace(obs.tracer, sched)
        n_ev = obs.write_trace(trace_out)
        print(f"wrote {trace_out} ({n_ev} trace events)")

    if not tiny:
        # explorer over the LLM actor graph on the TPU pod platform model:
        # the paper's partition-point methodology applied to pod boundaries
        res = Explorer(T.to_actor_graph(cfg, batch=1, seq=64),
                       tpu_pod_platform(2)).evaluate_modeled()
        rows.append(Row("serving", "pod_explorer_best_pp",
                        res.best(privacy=True).pp, "pp"))
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    # shared engine-policy flags (same registration as launch/serve.py,
    # load_bench.py and runtime/server.py — no per-entry-point drift);
    # this bench reads --paged / --watermark / --prefix-cache as "also
    # measure that engine configuration on the same trace"
    EngineConfig.add_cli_args(ap)
    ap.add_argument("--tiny", action="store_true",
                    help="CI smoke config (small model, few requests)")
    ap.add_argument("--requests", type=int, default=None)
    ap.add_argument("--max-new", type=int, default=None)
    ap.add_argument("--rate", type=float, default=200.0,
                    help="Poisson arrival rate (requests/s) for the "
                         "open-loop workload")
    ap.add_argument("--seed", type=int, default=1,
                    help="arrival-process RNG seed (reproducible sweeps)")
    ap.add_argument("--tenants", type=int, default=0,
                    help="tenant count for the victim-cache section "
                         "(with --victim-cache; 0 = default of 4)")
    ap.add_argument("--device", default="cuda",
                    help="where the engines run (cpu runs without a card)")
    ap.add_argument("--out", default="benchmarks/results/torch_serving.json",
                    help="write rows as JSON to this path")
    ap.add_argument("--trace-out", default=None,
                    help="write the observability run's Chrome trace "
                         "here (load into Perfetto / chrome://tracing)")
    args = ap.parse_args(argv)
    rows = run(tiny=args.tiny, n_requests=args.requests,
               max_new=args.max_new, rate=args.rate, seed=args.seed,
               paged=args.paged, watermark=args.watermark,
               prefix_cache=args.prefix_cache,
               victim_cache=getattr(args, "victim_cache", False),
               tenants=args.tenants, trace_out=args.trace_out,
               device=args.device)
    print(HEADER)
    emit(rows, out_path=args.out)


if __name__ == "__main__":
    main()
