"""Concurrent wall-clock load generator for the port's HTTP serving
front end.

``benchmarks/load_bench.py`` run on ``repro_torch``: the same sections,
flags, configuration and gates, the self-hosted server's engine on
``--device`` (default ``cuda``; ``cpu`` runs without a card). The result
is persisted as ``BENCH_serving_torch.json`` with the device it ran on
(on a card, its name and power limit); ``BENCH_serving.json`` stays the
reference's.

Where ``serving_bench.py`` measures the engine in-process on modeled
arrival clocks, this bench drives the *whole serving stack* — HTTP
parse, bounded admission, background drain thread, chunked streaming —
from real concurrent connections at Poisson arrival rates, and records
the numbers that matter to a serving operator:

* **TTFT p50/p99** — wall-clock time from sending the request to the
  first streamed token line arriving on the socket;
* **inter-token p50/p99** — steady-state gaps between successive token
  lines. The token1->token2 gap is reported separately (``first_gap_s``)
  because it absorbs stream-setup stalls that say nothing about decode
  cadence. The remaining tail is *real*: under continuous batching a
  mid-stream admission's prefill chunks stall decode for everyone in
  the batch — load the ``--trace-out`` file into Perfetto and the p99
  gaps line up with ``prefill chunk`` slices on the neighbouring slot;
* **throughput** — generated tokens per wall-clock second across the
  whole run;
* **shed rate** — the fraction of requests the server refused (429
  backpressure) or expired (``finish_reason="timeout"`` under
  ``--enforce-deadlines``) instead of serving late.

``--sweep R1,R2,...`` additionally re-drives the same trace at each
Poisson rate against the same live server (deadline-free) and persists
the per-rate (rate, TTFT p99, throughput) points plus the saturation
knee — the highest rate whose TTFT p99 stays within 3x of the sweep's
floor — under ``rate_sweep`` in the result JSON.

The result is persisted as JSON so the serving perf trajectory is
recorded in-repo and regression-gated: ``--baseline``
compares TTFT p99 against a committed run and exits non-zero past
``--max-regression``, and — when both runs carry a ``rate_sweep`` — the
saturation-knee *rate* against ``--max-knee-regression`` (the capacity
gate next to the latency gate; both run in CI nightly). ``--tenants N``
adds the prefix-cache service section: a two-wave multi-tenant
shared-prefix trace whose cross-request hit-rate and replay bytes-saved
land under ``prefix_cache`` and are gated by
``--max-prefix-regression`` when both runs carry the section.

By default the bench self-hosts an ``EngineServer`` on a tiny model and
an ephemeral port (so it runs anywhere, CI included); ``--url`` points
it at an external live server instead.

    PYTHONPATH=src:. python benchmarks/torch_load_bench.py --tiny --device cpu

A fraction of the tiny trace carries tight deadlines
on purpose: the recorded run demonstrates timeout shedding under
contention, while every *non-shed* request must complete cleanly (the
bench exits non-zero otherwise).
"""
from __future__ import annotations

import argparse
import http.client
import json
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List
from urllib.parse import urlparse

import numpy as np


def _percentiles(xs: List[float]) -> Dict[str, float]:
    if not xs:
        return {"p50": 0.0, "p99": 0.0}
    return {"p50": float(np.percentile(xs, 50)),
            "p99": float(np.percentile(xs, 99))}


class _Result:
    __slots__ = ("id", "status", "ttft_s", "first_gap_s", "gaps_s",
                 "n_tokens", "finish_reason", "error")

    def __init__(self, id):
        self.id = id
        self.status = 0
        self.ttft_s = None
        self.first_gap_s = None
        self.gaps_s: List[float] = []
        self.n_tokens = 0
        self.finish_reason = None
        self.error = None


def _run_one(host: str, port: int, body: Dict[str, Any],
             res: _Result) -> None:
    """One streamed /generate over a fresh connection; fills ``res``
    with per-line wall-clock timings (HTTPResponse decodes the chunked
    framing transparently, so readline() returns one NDJSON line per
    token the moment its chunk lands)."""
    conn = http.client.HTTPConnection(host, port, timeout=120)
    try:
        t_send = time.perf_counter()
        conn.request("POST", "/generate", json.dumps(body),
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        res.status = r.status
        if r.status != 200:
            r.read()
            return
        prev = None
        while True:
            line = r.readline()
            if not line:
                break
            line = line.strip()
            if not line:
                continue
            now = time.perf_counter()
            obj = json.loads(line)
            if "token" in obj:
                if res.ttft_s is None:
                    res.ttft_s = now - t_send
                elif res.first_gap_s is None:
                    # token1->token2 absorbs stream-setup / chunked-
                    # prefill stalls; keep it out of the steady-state
                    # inter-token series
                    res.first_gap_s = now - prev
                else:
                    res.gaps_s.append(now - prev)
                prev = now
                res.n_tokens += 1
            if obj.get("done"):
                res.finish_reason = obj["finish_reason"]
    except Exception as e:               # noqa: BLE001 — recorded, not fatal
        res.error = f"{type(e).__name__}: {e}"
    finally:
        conn.close()


def _worker(host: str, port: int, jobs: List[tuple], t0: float,
            results: List[_Result]) -> None:
    """Serve this worker's slice of the global Poisson schedule: sleep
    until each arrival instant, fire, stream to completion. A worker
    that falls behind fires late (open-loop degradation under overload —
    exactly what the deadline shed path is for)."""
    for at_s, rid, body in jobs:
        delay = t0 + at_s - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        res = _Result(rid)
        _run_one(host, port, body, res)
        results.append(res)


def _prefix_cache_trace(host: str, port: int, *, tenants: int,
                        max_new: int, vocab: int,
                        seed: int) -> Dict[str, Any]:
    """Prefix-cache service section: a two-wave multi-tenant
    shared-prefix HTTP trace. Wave 1 warms the pool and drains; wave 2
    replays the same per-tenant prompts as cold admissions, so its
    ``victim_hits`` delta (scraped from /status) is exactly the
    cross-request hit count. Returns {} when the server runs without
    the prefix cache."""
    rng = np.random.RandomState(seed)
    names = [f"tenant{t}" for t in range(max(tenants, 1))]
    bodies = []
    for t in names:
        pre = [int(x) for x in rng.randint(1, vocab, 24)]
        for i in range(2):
            tail = [int(x) for x in rng.randint(1, vocab, 6 + 4 * i)]
            bodies.append({"prompt": pre + tail, "max_new_tokens": max_new,
                           "stream": True, "tenant": t})

    def scrape() -> Dict[str, Any]:
        status, raw = _http_get(host, port, "/status")
        if status != 200:
            return {}
        return json.loads(raw).get("prefix_cache") or {}

    prev = scrape()
    if not prev.get("enabled"):
        return {}
    waves = []
    for wave in range(2):
        for i, body in enumerate(bodies):
            res = _Result(f"pc-{wave}-{i}")
            _run_one(host, port, dict(body), res)
            if res.status != 200 or res.error:
                raise RuntimeError(
                    f"prefix-cache trace request failed: status="
                    f"{res.status} error={res.error}")
        cur = scrape()
        waves.append({k: cur.get(k, 0) - prev.get(k, 0)
                      for k in ("victim_hits", "prefix_hits",
                                "prefill_tokens_saved", "bytes_saved")})
        waves[-1]["requests"] = len(bodies)
        prev = cur
    replay = waves[1]
    return {
        "tenants": len(names),
        "victim_cache": bool(prev.get("victim_cache")),
        "waves": waves,
        "cross_request_hit_rate":
            replay["victim_hits"] / max(replay["requests"], 1),
        "replay_bytes_saved": replay["bytes_saved"],
        "per_tenant_bytes": prev.get("per_tenant_bytes", {}),
        "pool": {k: prev.get(k, 0) for k in
                 ("victim_blocks", "victim_bytes", "victim_evictions")},
    }


def _http_get(host: str, port: int, path: str) -> tuple:
    conn = http.client.HTTPConnection(host, port, timeout=30)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def _sweep_knee(points: List[Dict[str, Any]]) -> Dict[str, Any]:
    """The TTFT-p99-vs-throughput knee of a rate sweep: the highest
    offered rate whose TTFT p99 stays within 3x of the best (lowest)
    p99 observed across the sweep — past that point queueing delay
    dominates and p99 departs the service-time floor. Falls back to the
    lowest-rate point when every rate is already past saturation."""
    pts = sorted(points, key=lambda p: p["rate_per_s"])
    floor = min(p["ttft_p99_s"] for p in pts) or 1e-9
    ok = [p for p in pts if p["ttft_p99_s"] <= 3.0 * floor]
    return dict(ok[-1] if ok else pts[0],
                criterion="highest rate with ttft_p99 <= 3x sweep floor")


def _run_sweep(host: str, port: int, rates: List[float], *, n: int,
               max_new: int, workers: int, vocab: int,
               seed: int) -> Dict[str, Any]:
    """Drive the same trace at each Poisson rate against the same live
    server (deadline-free: the sweep charts the pure latency/throughput
    curve, not the shed path) and locate the saturation knee."""
    points = []
    for rate in rates:
        o = run_load(host, port, n=n, rate=rate, max_new=max_new,
                     workers=workers, deadline_s=0.0, deadline_every=0,
                     vocab=vocab, seed=seed)
        pt = {"rate_per_s": rate,
              "ttft_p50_s": o["ttft_s"]["p50"],
              "ttft_p99_s": o["ttft_s"]["p99"],
              "throughput_tok_per_s": o["throughput_tok_per_s"],
              "completed": o["completed"],
              "failed": o["failed"]}
        points.append(pt)
        print(f"sweep @ {rate:g}/s: ttft p99 {pt['ttft_p99_s'] * 1e3:.1f} ms"
              f", {pt['throughput_tok_per_s']:.0f} tok/s", flush=True)
    return {"points": points, "knee": _sweep_knee(points)}


def _poisson_schedule(n: int, rate_per_s: float, seed: int) -> List[float]:
    rng = np.random.RandomState(seed)
    return list(np.cumsum(rng.exponential(1.0 / rate_per_s, size=n)))


def _make_bodies(n: int, *, vocab: int, max_new: int, deadline_s: float,
                 deadline_every: int, seed: int) -> List[Dict[str, Any]]:
    """Mixed-length prompts; every ``deadline_every``-th request carries
    a tight deadline so a contended trace sheds visibly."""
    rng = np.random.RandomState(seed)
    lens = (12, 16, 24, 32)
    bodies = []
    for i in range(n):
        b = {"prompt": [int(t) for t in
                        rng.randint(1, vocab, lens[i % len(lens)])],
             "max_new_tokens": max_new, "stream": True}
        if deadline_every and i % deadline_every == deadline_every - 1:
            b["deadline_s"] = deadline_s
        bodies.append(b)
    return bodies


def run_load(host: str, port: int, *, n: int, rate: float, max_new: int,
             workers: int, deadline_s: float, deadline_every: int,
             vocab: int, seed: int) -> Dict[str, Any]:
    bodies = _make_bodies(n, vocab=vocab, max_new=max_new,
                          deadline_s=deadline_s,
                          deadline_every=deadline_every, seed=seed)
    schedule = _poisson_schedule(n, rate, seed)
    # round-robin the global schedule across workers: each worker's
    # sub-schedule is increasing, so per-worker sequential dispatch
    # preserves every arrival instant
    slices: List[List[tuple]] = [[] for _ in range(workers)]
    for i, (at, body) in enumerate(zip(schedule, bodies)):
        slices[i % workers].append((at, i, body))
    results: List[_Result] = []
    t0 = time.perf_counter()
    threads = [threading.Thread(target=_worker,
                                args=(host, port, jobs, t0, results),
                                daemon=True)
               for jobs in slices if jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0

    ok = [r for r in results if r.status == 200
          and r.finish_reason in ("eos", "length")]
    timeouts = [r for r in results if r.finish_reason == "timeout"]
    rejected = [r for r in results if r.status == 429]
    failed = [r for r in results
              if r not in ok and r not in timeouts and r not in rejected]
    ttfts = [r.ttft_s for r in ok if r.ttft_s is not None]
    first_gaps = [r.first_gap_s for r in ok if r.first_gap_s is not None]
    gaps = [g for r in ok for g in r.gaps_s]
    toks = sum(r.n_tokens for r in results)
    return {
        "requests": n,
        "rate_per_s": rate,
        "max_new_tokens": max_new,
        "workers": workers,
        "wall_s": wall,
        "completed": len(ok),
        "shed_timeout": len(timeouts),
        "rejected_429": len(rejected),
        "failed": len(failed),
        "failed_detail": [
            {"id": r.id, "status": r.status, "finish_reason": r.finish_reason,
             "error": r.error} for r in failed],
        "shed_rate": (len(timeouts) + len(rejected)) / max(n, 1),
        "throughput_tok_per_s": toks / wall,
        "ttft_s": _percentiles(ttfts),
        "first_gap_s": _percentiles(first_gaps),
        "inter_token_s": _percentiles(gaps),
    }


# ---------------------------------------------------------------------------
# self-hosted server (default) / external --url
# ---------------------------------------------------------------------------


def _self_hosted(args):
    """Build the tiny EngineServer this bench drives when no --url is
    given. Deadline enforcement is always on here (the recorded
    trajectory is supposed to show the shed path working) and so is
    observability, so the recorded run carries server-side histogram
    summaries next to the client-side percentiles."""
    from repro_torch.models import transformer as T
    from repro_torch.models.config import ModelConfig
    from repro_torch.runtime.engine import Engine, EngineConfig
    from repro_torch.runtime.server import EngineServer, ServerConfig

    cfg = ModelConfig(
        name="load-tiny", arch_type="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256, dtype="float32",
        param_dtype="float32", attn_chunk=16, remat=False)
    model = T.init_params(cfg, 0, device=args.device)
    ec = EngineConfig.from_args(
        args, max_len=args.max_len,
        admission=args.policy or "edf", enforce_deadlines=True,
        max_slots=args.slots if args.slots != 8 else 2,
        observability=True)
    engine = Engine(cfg, model, ec, device=args.device)
    return EngineServer(engine, ServerConfig(
        port=0, max_inflight=args.max_inflight, max_new_cap=args.max_new))


def _device(device: str) -> Dict[str, Any]:
    """Where the self-hosted server ran: on a card, its name and power
    limit."""
    import torch
    if torch.device(device).type != "cuda":
        return {"platform": "cpu"}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "nvidia_smi": smi.strip()}


def main(argv=None) -> int:
    from repro_torch.runtime.engine import EngineConfig

    ap = argparse.ArgumentParser(description=__doc__)
    EngineConfig.add_cli_args(ap)
    ap.add_argument("--tiny", action="store_true",
                    help="CI-sized run: small trace against the built-in "
                         "tiny self-hosted server")
    ap.add_argument("--url", default=None,
                    help="drive an external live server instead of "
                         "self-hosting (http://host:port)")
    ap.add_argument("--requests", type=int, default=None)
    ap.add_argument("--rate", type=float, default=None,
                    help="Poisson arrival rate, requests/s")
    ap.add_argument("--max-new", type=int, default=None)
    ap.add_argument("--workers", type=int, default=None,
                    help="concurrent client connections")
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--max-inflight", type=int, default=16,
                    help="self-hosted server admission bound (429 past it)")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="deadline carried by every N-th request (see "
                         "--deadline-every); tight by default so the "
                         "contended trace sheds visibly")
    ap.add_argument("--deadline-every", type=int, default=4,
                    help="every N-th request carries --deadline-s "
                         "(0 = no deadlines)")
    ap.add_argument("--sweep", default=None, metavar="R1,R2,...",
                    help="comma-separated Poisson rates (req/s): after "
                         "the main run, drive the same trace at each "
                         "rate against the same server and persist the "
                         "per-rate (rate, TTFT p99, throughput) points "
                         "plus the saturation knee under 'rate_sweep' "
                         "in the result JSON")
    ap.add_argument("--tenants", type=int, default=0,
                    help="run the prefix-cache service section: a "
                         "two-wave multi-tenant shared-prefix trace "
                         "whose cross-request hit-rate and bytes-saved "
                         "land under 'prefix_cache' in the result JSON "
                         "(needs a server with --prefix-cache; pair "
                         "with --victim-cache for cross-drain hits)")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default="cuda",
                    help="where the self-hosted server's engine runs (cpu "
                         "runs without a card)")
    ap.add_argument("--out", default="BENCH_serving_torch.json",
                    help="write the result JSON here")
    ap.add_argument("--trace-out", default=None,
                    help="fetch the server's Chrome trace (GET /trace) "
                         "after the run, validate it, and write it here "
                         "(load into Perfetto / chrome://tracing)")
    ap.add_argument("--baseline", default=None,
                    help="committed BENCH_serving_torch.json to "
                         "regression-gate TTFT p99 against")
    ap.add_argument("--max-regression", type=float, default=0.20,
                    help="fail if TTFT p99 exceeds baseline by more than "
                         "this fraction")
    ap.add_argument("--max-knee-regression", type=float, default=0.25,
                    help="with --baseline and --sweep: fail if the "
                         "saturation-knee rate drops below the baseline "
                         "knee by more than this fraction (the capacity "
                         "gate next to the latency gate)")
    ap.add_argument("--max-prefix-regression", type=float, default=0.25,
                    help="with --baseline and --tenants: fail if the "
                         "prefix-cache cross-request hit-rate or replay "
                         "bytes-saved drop below the baseline by more "
                         "than this fraction")
    args = ap.parse_args(argv)

    n = args.requests or (24 if args.tiny else 200)
    rate = args.rate or (30.0 if args.tiny else 50.0)
    max_new = args.max_new or (8 if args.tiny else 32)
    workers = args.workers or min(n, 12 if args.tiny else 64)
    deadline_s = args.deadline_s if args.deadline_s is not None \
        else (0.15 if args.tiny else 0.5)

    if args.url:
        u = urlparse(args.url)
        host, port = u.hostname, u.port
        srv = None
    else:
        srv = _self_hosted(args)
        srv.start()
        host, port = srv.config.host, srv.port

    try:
        print(f"load_bench: {n} requests @ {rate}/s, {workers} workers, "
              f"max_new={max_new}, deadline={deadline_s}s every "
              f"{args.deadline_every} -> {host}:{port}", flush=True)
        out = run_load(host, port, n=n, rate=rate, max_new=max_new,
                       workers=workers, deadline_s=deadline_s,
                       deadline_every=args.deadline_every,
                       vocab=256, seed=args.seed)
        if srv is not None:
            out["server_status"] = srv.status()
            out["device"] = _device(args.device)
        # server-side view of the same run: scrape /metrics while the
        # server is still up and keep the histogram summaries next to
        # the client-side percentiles (TTFT should agree to within the
        # HTTP/streaming overhead)
        from repro_torch.serving import (parse_prometheus,
                                         validate_chrome_trace)
        m_status, m_body = _http_get(host, port, "/metrics")
        if m_status == 200:
            parsed = parse_prometheus(m_body.decode())
            out["server_metrics"] = {
                "counters": parsed["counters"],
                "histograms": {
                    name: {"count": h["count"], "sum": h["sum"]}
                    for name, h in parsed["histograms"].items()},
            }
            hists = out.get("server_status", {}).get(
                "metrics", {}).get("histograms", {})
            ttft = hists.get("repro_ttft_seconds")
            if ttft and ttft.get("count"):
                out["server_metrics"]["ttft_s"] = {
                    "p50": ttft["p50"], "p99": ttft["p99"]}
                print(f"server-side TTFT p50={ttft['p50'] * 1e3:.1f} ms "
                      f"p99={ttft['p99'] * 1e3:.1f} ms "
                      f"(client-side p50="
                      f"{out['ttft_s']['p50'] * 1e3:.1f} ms "
                      f"p99={out['ttft_s']['p99'] * 1e3:.1f} ms)")
        if args.trace_out:
            t_status, t_body = _http_get(host, port, "/trace")
            if t_status != 200:
                print(f"FAIL: GET /trace -> {t_status}", file=sys.stderr)
                return 1
            trace = json.loads(t_body)
            n_ev = validate_chrome_trace(trace)
            with open(args.trace_out, "w") as f:
                json.dump(trace, f)
                f.write("\n")
            print(f"wrote {args.trace_out} ({n_ev} trace events)")
        if args.sweep:
            rates = [float(r) for r in args.sweep.split(",") if r.strip()]
            out["rate_sweep"] = _run_sweep(
                host, port, rates, n=n, max_new=max_new, workers=workers,
                vocab=256, seed=args.seed)
            k = out["rate_sweep"]["knee"]
            print(f"sweep knee: {k['rate_per_s']:g}/s "
                  f"(ttft p99 {k['ttft_p99_s'] * 1e3:.1f} ms, "
                  f"{k['throughput_tok_per_s']:.0f} tok/s)")
        if args.tenants:
            pc = _prefix_cache_trace(host, port, tenants=args.tenants,
                                     max_new=max_new, vocab=256,
                                     seed=args.seed + 1)
            if pc:
                out["prefix_cache"] = pc
                print(f"prefix cache: {pc['tenants']} tenants, "
                      f"cross-request hit-rate "
                      f"{pc['cross_request_hit_rate']:.2f}, replay saved "
                      f"{pc['replay_bytes_saved']} B "
                      f"(victim={'on' if pc['victim_cache'] else 'off'})")
            else:
                print("prefix cache: server runs without the prefix "
                      "cache; section skipped", file=sys.stderr)
    finally:
        if srv is not None:
            srv.close()

    print(json.dumps({k: v for k, v in out.items()
                      if k not in ("failed_detail", "server_status")},
                     indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"wrote {args.out}")

    rc = 0
    if out["failed"]:
        print(f"FAIL: {out['failed']} non-shed requests failed: "
              f"{out['failed_detail']}", file=sys.stderr)
        rc = 1
    if args.baseline:
        with open(args.baseline) as f:
            base = json.load(f)
        base_p99 = base["ttft_s"]["p99"]
        cur_p99 = out["ttft_s"]["p99"]
        limit = base_p99 * (1.0 + args.max_regression)
        print(f"TTFT p99: {cur_p99 * 1e3:.1f} ms vs baseline "
              f"{base_p99 * 1e3:.1f} ms (limit {limit * 1e3:.1f} ms)")
        if cur_p99 > limit:
            print(f"FAIL: TTFT p99 regressed past "
                  f"{args.max_regression:.0%}", file=sys.stderr)
            rc = 1
        # capacity gate: the saturation knee (highest rate the server
        # absorbs before TTFT p99 departs the service-time floor) must
        # not slide down vs. the committed run
        base_knee = base.get("rate_sweep", {}).get("knee")
        cur_knee = out.get("rate_sweep", {}).get("knee")
        if base_knee and cur_knee:
            floor = base_knee["rate_per_s"] * (1.0 - args.max_knee_regression)
            print(f"sweep knee: {cur_knee['rate_per_s']:g}/s vs baseline "
                  f"{base_knee['rate_per_s']:g}/s (floor {floor:g}/s)")
            if cur_knee["rate_per_s"] < floor:
                print(f"FAIL: saturation knee regressed past "
                      f"{args.max_knee_regression:.0%} "
                      f"({cur_knee['rate_per_s']:g}/s < {floor:g}/s)",
                      file=sys.stderr)
                rc = 1
        elif base_knee and not cur_knee:
            print("FAIL: baseline has a rate_sweep knee but this run "
                  "was not driven with --sweep", file=sys.stderr)
            rc = 1
        # cache-effectiveness gate: the prefix-cache service's
        # cross-request hit-rate and replay bytes-saved must not slide
        # down vs. the committed run
        base_pc = base.get("prefix_cache")
        cur_pc = out.get("prefix_cache")
        if base_pc and cur_pc:
            for key in ("cross_request_hit_rate", "replay_bytes_saved"):
                floor = base_pc[key] * (1.0 - args.max_prefix_regression)
                print(f"prefix {key}: {cur_pc[key]:g} vs baseline "
                      f"{base_pc[key]:g} (floor {floor:g})")
                if cur_pc[key] < floor:
                    print(f"FAIL: prefix-cache {key} regressed past "
                          f"{args.max_prefix_regression:.0%} "
                          f"({cur_pc[key]:g} < {floor:g})",
                          file=sys.stderr)
                    rc = 1
        elif base_pc and not cur_pc:
            print("FAIL: baseline has a prefix_cache section but this "
                  "run was not driven with --tenants against a "
                  "prefix-cache server", file=sys.stderr)
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
