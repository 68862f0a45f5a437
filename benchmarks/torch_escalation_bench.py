"""Hierarchical-serving benchmark on the port: endpoint-alone vs
always-offload vs confidence-gated escalation, plus link-cut recovery.

``benchmarks/escalation_bench.py`` run on ``repro_torch``: the same
sections, flags, configuration and assertions, on ``--device`` (default
``cuda``; ``cpu`` runs without a card). The result goes to
``benchmarks/results/torch_escalation.json`` by default, and
``--merge-bench BENCH_serving_torch.json`` folds it under that file's
``"escalation"`` key.

The paper's collaborative-inference claim, measured on the serving
path: a small endpoint engine (1 decode slot — the low-resource device)
fronts a bigger server engine (8 slots) through ``runtime.escalation``,
and the same Poisson trace is driven through three configurations.
Both tiers share one host, so the endpoint's slower silicon is modeled
with a per-step wall-clock handicap (``--endpoint-step-delay-ms`` ->
``EngineConfig.step_delay_s``); token content is bit-identical, only
the endpoint's real elapsed time stretches — without it a tiny model
on one CPU gives the 8-slot tier no true capacity advantage and every
routing mode converges to the same wall latency.

* ``local-only`` — the ``never`` policy: the endpoint answers
  everything itself (the paper's endpoint-alone baseline, and the
  privacy-maximal configuration);
* ``always-escalate`` — every request ships to the server tier
  (the always-offload baseline);
* ``confidence-gated`` — ``confidence`` + ``overload``: the endpoint
  keeps what it is sure about and its queue can absorb, escalates the
  hard residue.

Reported per mode: answered-within-deadline rate (the serving-side
quality metric), mean/percentile latency, and the **escalated
fraction** — how much traffic ever left the device, the privacy metric
of the partitioning papers. The bench asserts the acceptance criteria:
confidence-gated must beat local-only on answered-within-deadline rate
while escalating strictly less than 100% of traffic.

The second phase cuts the endpoint<->server link with an injected
``resilience.FailureTrace`` while deadline-free requests are in flight:
they wait durably in the on-disk escalation journal, and on revival the
journal replays in order with **zero lost requests**; the bench measures
``recovery_s`` (revival -> journal drained) and asserts it lands within
the recovery window, and that the fail-back was counted.

``--tiny`` is the CI fast-lane configuration; ``--out`` writes the
result JSON.

    PYTHONPATH=src:. python benchmarks/torch_escalation_bench.py --tiny --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Any, Dict

import numpy as np


def _device(device: str) -> Dict[str, Any]:
    """Where the run happened: on a card, its name and power limit."""
    import torch
    if torch.device(device).type != "cuda":
        return {"platform": "cpu"}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "nvidia_smi": smi.strip()}



def _build(args):
    from repro_torch.models import transformer as T
    from repro_torch.models.config import ModelConfig

    cfg = ModelConfig(
        name="esc-tiny", arch_type="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256, dtype="float32",
        param_dtype="float32", attn_chunk=16, remat=False)
    # one model for both tiers: escalated completions stay bit-identical
    # to local ones, so the quality axis is isolated to *where* requests
    # run (capacity), which is what this bench measures
    return cfg, T.init_params(cfg, 0, device=args.device)


def _trace(n: int, *, vocab: int, max_new: int, deadline_s: float,
           seed: int, rate: float):
    rng = np.random.RandomState(seed)
    lens = (6, 8, 10, 12)
    arrivals = np.cumsum(rng.exponential(1.0 / rate, size=n))
    reqs = []
    for i in range(n):
        reqs.append({"prompt": rng.randint(1, vocab, lens[i % len(lens)])
                     .astype(np.int32),
                     "max_new_tokens": max_new, "deadline_s": deadline_s})
    return list(zip(arrivals, reqs))


def _drive(tiered, trace, *, deadline_s: float) -> Dict[str, Any]:
    """Submit the trace open-loop on its arrival schedule, wait for
    everything, and score answered-within-deadline on wall latency."""
    from repro_torch.serving import Request

    t0 = time.perf_counter()
    handles = []
    for at_s, spec in trace:
        delay = t0 + at_s - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        h = tiered.submit(Request(
            id=len(handles), prompt=spec["prompt"],
            max_new_tokens=spec["max_new_tokens"],
            deadline_s=spec["deadline_s"]))
        handles.append((time.perf_counter(), h))
    lat, in_deadline, escalated, fallbacks = [], 0, 0, 0
    for sent_at, h in handles:
        c = h.result(120)
        wall = time.perf_counter() - sent_at if c.finish_reason != "timeout" \
            else float("inf")
        lat.append(min(wall, 1e9))
        answered = c.finish_reason in ("eos", "length", "local_fallback")
        if answered and wall <= deadline_s:
            in_deadline += 1
        if h.tier not in (None, tiered.config.tier):
            escalated += 1
        if c.finish_reason == "local_fallback":
            fallbacks += 1
    finite = [x for x in lat if x != float("inf")]
    n = len(handles)
    return {
        "requests": n,
        "answered_within_deadline": in_deadline,
        "answered_within_deadline_rate": in_deadline / n,
        "escalated": escalated,
        "escalated_fraction": escalated / n,
        "local_fallbacks": fallbacks,
        "latency_mean_s": float(np.mean(finite)) if finite else 0.0,
        "latency_p99_s": float(np.percentile(finite, 99)) if finite else 0.0,
    }


def _make_tiered(cfg, params, *, policies, journal_dir, transport_wrap=None,
                 endpoint_slots: int, server_slots: int, max_len: int,
                 endpoint_step_delay_s: float = 0.0):
    from repro_torch.runtime.escalation import (InProcessTransport,
                                                TieredConfig, TieredEngine)
    from repro_torch.serving import Engine, EngineConfig

    # the endpoint is the paper's low-resource device; both tiers share
    # one host here, so its slower silicon is emulated with a per-step
    # wall-clock handicap (content-neutral — tokens stay bit-identical)
    local = Engine(cfg, params, EngineConfig(
        max_slots=endpoint_slots, max_len=max_len, observability=True,
        step_delay_s=endpoint_step_delay_s), device=params.device)
    server = Engine(cfg, params, EngineConfig(
        max_slots=server_slots, max_len=max_len),
        device=params.device).start()
    transport = InProcessTransport(server)
    if transport_wrap is not None:
        transport = transport_wrap(transport)
    # replay window = server slots: a send blocks until its completion,
    # so the window is the server tier's effective concurrency — leave
    # it below the slot count and the bench throttles the big tier's
    # batching advantage to the window
    tiered = TieredEngine(local, transport, TieredConfig(
        policies=policies, journal_dir=journal_dir,
        replay_window=server_slots,
        max_sends_per_pump=2 * server_slots)).start()
    return tiered, server


def _calibrate_threshold(cfg, params, trace, *, max_len: int) -> float:
    """Median next-token confidence over the trace's prompts: the
    operating point where roughly half the traffic is 'hard residue'.
    A real deployment tunes this against a quality target; the bench
    just needs a gate that splits the traffic, whatever the model."""
    import torch

    from repro_torch.models import transformer as T

    def probe(prompt):
        tokens = torch.as_tensor(prompt[None, :], device=params.device)
        with torch.inference_mode():
            logits, _, _ = T.prefill(params, tokens, max_len=max_len)
            return float(torch.softmax(logits[0].float(), dim=-1).max())

    confs = sorted(probe(spec["prompt"]) for _, spec in trace)
    return confs[len(confs) // 2]


def _mode(name, cfg, params, trace, *, policies, deadline_s, root,
          endpoint_slots, server_slots, max_len,
          endpoint_step_delay_s) -> Dict[str, Any]:
    tiered, server = _make_tiered(
        cfg, params, policies=policies, journal_dir=f"{root}/{name}",
        endpoint_slots=endpoint_slots, server_slots=server_slots,
        max_len=max_len, endpoint_step_delay_s=endpoint_step_delay_s)
    try:
        # warm BOTH tiers (+ the confidence probe) outside the timed
        # window, submitting to each engine DIRECTLY — warming through
        # tiered.submit() routes by policy, and a confidence gate can
        # escalate every warmup prompt, leaving the local tier to pay
        # its first kernel builds mid-run: latency differences must come
        # from capacity, not from who paid the build
        from repro_torch.serving import Request
        for L in {len(spec["prompt"]) for _, spec in trace}:
            tiered.local.submit(Request(
                id=-L, prompt=np.ones(L, np.int32),
                max_new_tokens=2)).result(120)
            server.submit(Request(id=-1000 - L, prompt=np.ones(L, np.int32),
                                  max_new_tokens=2)).result(120)
            tiered._confidence(Request(id=-2000 - L,
                                       prompt=np.ones(L, np.int32),
                                       max_new_tokens=2))
        tiered.local.obs.registry.reset_histograms()
        out = _drive(tiered, trace, deadline_s=deadline_s)
        out["policies"] = [getattr(p, "name", str(p))
                           for p in tiered.policies]
        out["escalation_stats"] = tiered.escalation_stats()
        from repro_torch.serving import parse_prometheus
        m = parse_prometheus(tiered.metrics_text())
        out["metrics"] = {
            "escalated_total": m["counters"]["repro_escalated_total"],
            "local_fallback_total":
                m["counters"]["repro_local_fallback_total"],
            "failback_total": m["counters"]["repro_failback_total"],
            "escalation_queue_depth":
                m["gauges"]["repro_escalation_queue_depth"],
        }
        return out
    finally:
        tiered.shutdown()
        server.shutdown()


def _link_cut_phase(cfg, params, *, root, n: int, cut_after_s: float,
                    down_s: float, recovery_window_s: float,
                    endpoint_slots, server_slots, max_len) -> Dict[str, Any]:
    """Escalate deadline-free requests straight into a link cut; measure
    journal drain after revival."""
    from repro_torch.runtime.escalation import FlakyTransport
    from repro_torch.runtime.resilience import FailureTrace
    from repro_torch.serving import Request

    cut = FailureTrace()                # scheduled after warmup, below
    tiered, server = _make_tiered(
        cfg, params, policies=("always",), journal_dir=f"{root}/linkcut",
        transport_wrap=lambda t: FlakyTransport(t, cut),
        endpoint_slots=endpoint_slots, server_slots=server_slots,
        max_len=max_len)
    try:
        # warm the server tier before the cut so post-revival replay
        # measures protocol recovery, not the first kernel builds
        tiered.submit(Request(id=-1, prompt=np.ones(6, np.int32),
                              max_new_tokens=2)).result(120)
        # schedule the cut relative to the warmed clock (build time
        # varies run to run; the trace is absolute)
        kill_at = tiered.now() + cut_after_s
        revive_at = kill_at + down_s
        cut.kill_link("endpoint", "server", at=kill_at) \
           .revive_link("endpoint", "server", at=revive_at)
        while tiered.now() < kill_at:
            time.sleep(0.005)
        # the link is now down: these journal durably (no deadlines)
        rng = np.random.RandomState(3)
        handles = [tiered.submit(Request(
            id=i, prompt=rng.randint(1, 256, 6).astype(np.int32),
            max_new_tokens=4)) for i in range(n)]
        stranded = tiered.journal.depth
        while tiered.now() < revive_at:
            time.sleep(0.005)
        results = [h.result(60 + recovery_window_s) for h in handles]
        drained_at = tiered.now()
        stats = tiered.escalation_stats()
        lost = [h.request.id for h, c in zip(handles, results)
                if c.finish_reason not in ("eos", "length")]
        return {
            "requests": n,
            "stranded_in_journal": stranded,
            "lost": lost,
            "recovery_s": max(drained_at - revive_at, 0.0),
            "recovery_window_s": recovery_window_s,
            "failback_total": stats["failback"],
            "queue_depth_after": stats["queue_depth"],
        }
    finally:
        tiered.shutdown()
        server.shutdown()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--tiny", action="store_true",
                    help="CI-sized run (fast lane)")
    ap.add_argument("--requests", type=int, default=None)
    ap.add_argument("--rate", type=float, default=None,
                    help="Poisson arrival rate, requests/s")
    ap.add_argument("--max-new", type=int, default=None)
    ap.add_argument("--deadline-s", type=float, default=None)
    ap.add_argument("--endpoint-slots", type=int, default=1)
    ap.add_argument("--server-slots", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--endpoint-step-delay-ms", type=float, default=None,
                    help="per-step wall-clock handicap on the endpoint "
                         "engine — models the slow edge device when both "
                         "tiers share one host (default: 15ms tiny, "
                         "8ms full)")
    ap.add_argument("--confidence-threshold", type=float, default=None,
                    help="override the confidence gate (default: policy "
                         "default)")
    ap.add_argument("--recovery-window-s", type=float, default=10.0,
                    help="link-cut phase must drain the journal within "
                         "this many seconds of revival")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default="cuda",
                    help="where both tiers run (cpu runs without a card)")
    ap.add_argument("--out", default="benchmarks/results/"
                                     "torch_escalation.json")
    ap.add_argument("--merge-bench", default=None, metavar="BENCH.json",
                    help="also fold the result under this JSON's "
                         "'escalation' key (top-level keys the nightly "
                         "gate reads are untouched)")
    args = ap.parse_args(argv)

    n = args.requests or (18 if args.tiny else 96)
    rate = args.rate or (24.0 if args.tiny else 40.0)
    max_new = args.max_new or (6 if args.tiny else 16)
    deadline_s = args.deadline_s or (0.6 if args.tiny else 1.5)
    delay_ms = args.endpoint_step_delay_ms
    if delay_ms is None:
        delay_ms = 15.0 if args.tiny else 8.0
    endpoint_step_delay_s = delay_ms / 1e3

    import tempfile
    root = tempfile.mkdtemp(prefix="esc-bench-")
    cfg, params = _build(args)
    trace = _trace(n, vocab=256, max_new=max_new, deadline_s=deadline_s,
                   seed=args.seed, rate=rate)

    from repro_torch.runtime.policies import (ConfidenceEscalation,
                                              LocalOverloadEscalation)
    threshold = args.confidence_threshold
    if threshold is None:
        threshold = _calibrate_threshold(cfg, params, trace,
                                         max_len=args.max_len)
        print(f"calibrated confidence threshold: {threshold:.4f} "
              f"(trace median)", flush=True)
    gate = [ConfidenceEscalation(threshold),
            LocalOverloadEscalation(max_queue_depth=1)]

    print(f"escalation_bench: {n} requests @ {rate}/s, max_new={max_new}, "
          f"deadline={deadline_s}s, endpoint={args.endpoint_slots} slot(s) "
          f"@ +{delay_ms:.0f}ms/step vs server={args.server_slots}",
          flush=True)
    modes = {}
    for name, policies in (("local_only", ("never",)),
                           ("always_escalate", ("always",)),
                           ("confidence_gated", gate)):
        modes[name] = _mode(
            name, cfg, params, trace, policies=policies,
            deadline_s=deadline_s, root=root,
            endpoint_slots=args.endpoint_slots,
            server_slots=args.server_slots, max_len=args.max_len,
            endpoint_step_delay_s=endpoint_step_delay_s)
        m = modes[name]
        print(f"  {name:18s}: answered-in-deadline "
              f"{m['answered_within_deadline']}/{n} "
              f"({m['answered_within_deadline_rate']:.0%}), escalated "
              f"{m['escalated_fraction']:.0%}, mean latency "
              f"{m['latency_mean_s'] * 1e3:.0f} ms", flush=True)

    linkcut = _link_cut_phase(
        cfg, params, root=root, n=min(n, 8), cut_after_s=0.3, down_s=1.0,
        recovery_window_s=args.recovery_window_s,
        endpoint_slots=args.endpoint_slots,
        server_slots=args.server_slots, max_len=args.max_len)
    print(f"  link cut: {linkcut['stranded_in_journal']} stranded, "
          f"{len(linkcut['lost'])} lost, recovery "
          f"{linkcut['recovery_s']:.2f}s "
          f"(window {linkcut['recovery_window_s']:.0f}s), failbacks "
          f"{linkcut['failback_total']}", flush=True)

    local, gated = modes["local_only"], modes["confidence_gated"]
    speedup = (local["latency_mean_s"] / gated["latency_mean_s"]
               if gated["latency_mean_s"] else 0.0)
    out = {
        "requests": n, "rate_per_s": rate, "max_new_tokens": max_new,
        "deadline_s": deadline_s,
        "endpoint_slots": args.endpoint_slots,
        "server_slots": args.server_slots,
        "endpoint_step_delay_ms": delay_ms,
        "modes": modes,
        "endpoint_speedup_vs_local_only": speedup,
        "privacy_fraction_local": 1.0 - gated["escalated_fraction"],
        "link_cut": linkcut,
    }
    print(f"  gated vs local-only: {speedup:.2f}x mean-latency speedup, "
          f"{out['privacy_fraction_local']:.0%} of traffic stayed "
          f"on-device", flush=True)

    rc = 0
    # acceptance: gated beats local-only on answered-within-deadline
    # while escalating strictly less than everything
    if gated["answered_within_deadline"] \
            <= local["answered_within_deadline"] \
            and gated["answered_within_deadline"] < n:
        print("FAIL: confidence-gated did not beat local-only on "
              "answered-within-deadline "
              f"({gated['answered_within_deadline']} vs "
              f"{local['answered_within_deadline']})", file=sys.stderr)
        rc = 1
    if not gated["escalated_fraction"] < 1.0:
        print("FAIL: confidence-gated escalated 100% of traffic "
              "(no privacy benefit over always-escalate)", file=sys.stderr)
        rc = 1
    if local["escalated"] != 0:
        print("FAIL: local-only escalated traffic", file=sys.stderr)
        rc = 1
    # acceptance: zero lost across the link cut, bounded recovery,
    # fail-back observed
    if linkcut["lost"]:
        print(f"FAIL: requests lost across the link cut: "
              f"{linkcut['lost']}", file=sys.stderr)
        rc = 1
    if linkcut["recovery_s"] > linkcut["recovery_window_s"]:
        print(f"FAIL: journal recovery took {linkcut['recovery_s']:.2f}s "
              f"> window {linkcut['recovery_window_s']:.0f}s",
              file=sys.stderr)
        rc = 1
    if linkcut["failback_total"] < 1:
        print("FAIL: no fail-back counted after link revival",
              file=sys.stderr)
        rc = 1

    out["device"] = _device(args.device)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"wrote {args.out}")
    if args.merge_bench:
        with open(args.merge_bench) as f:
            bench = json.load(f)
        bench["escalation"] = out
        with open(args.merge_bench, "w") as f:
            json.dump(bench, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"merged under 'escalation' in {args.merge_bench}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
