"""The serving window: the port's ``Engine`` driven in a closed loop.

Set-up builds the model from the seed's weights, starts the engine's
background drain (``Engine.start()``) and submits one request per
client (``traffic.staggered``); it ends when every one of them has its
first token, so the first prefills of a cold start fall in set-up. The
window then runs for ``seconds``: each request's completion submits
the next one from its token callback, on the drain thread, through the
engine's lock-free submission handoff, so no client thread competes
with the drain for the interpreter lock. Every token is stamped on the
benchmark's side (``RequestHandle.on_token``).

At the window's close no request is submitted any more, the requests
still in flight are cancelled, and the engine is shut down. The
comparison then takes a sample, drawn from the seed, of the requests
that finished in the window, the longest among them, and runs the
reference over each prompt with its served tokens (``compare``).
"""
from __future__ import annotations

import gc
import math
import random
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from bench.harness import traffic, weights
from bench.harness.model import port_config
from bench.yardstick import flops as Y


@dataclass
class Req:
    offer: traffic.Offer
    sub_t: float = 0.0
    tok_t: List[float] = field(default_factory=list)
    handle: object = None
    tokens: List[int] = field(default_factory=list)
    reason: str = ""


class ClosedLoop:
    """Keeps ``clients`` requests in flight: a request's last token
    submits the next offer, until ``close()``."""

    def __init__(self, engine, offers: List[traffic.Offer], clients: int):
        self.engine, self.offers, self.clients = engine, offers, clients
        self.reqs: List[Req] = []
        self.next = 0
        self.closed = False
        self.exhausted = False

    def submit_next(self) -> None:
        from repro_torch.runtime.scheduler import Request
        if self.closed:
            return
        if self.next >= len(self.offers):
            self.exhausted = True
            return
        o = self.offers[self.next]
        self.next += 1
        r = Req(o)
        self.reqs.append(r)

        def on_token(_tok, r=r):
            r.tok_t.append(time.perf_counter())
            if len(r.tok_t) == r.offer.max_new:
                self.submit_next()
        r.sub_t = time.perf_counter()
        h = self.engine.submit(Request(o.index, o.prompt,
                                       max_new_tokens=o.max_new))
        h.on_token(on_token)
        r.handle = h

    def start(self) -> None:
        """Submit one request per client, then start the drain: the
        callbacks are in place before any token can come."""
        for _ in range(self.clients):
            self.submit_next()
        self.engine.start()

    def release(self) -> None:
        """Keep each request's tokens and finish reason, and let go of
        the handles, and through them of the engine and its model."""
        for r in self.reqs:
            r.tokens = list(r.handle.tokens)
            r.reason = r.handle.finish_reason or ""
            r.handle = None
        self.engine = None

    def close(self) -> List[Req]:
        """Stop submitting; cancel what is in flight; return the
        requests cancelled so."""
        self.closed = True
        cut = [r for r in self.reqs if not r.handle.done]
        for r in cut:
            r.handle.cancel()
        return cut


def p95(values: List[float]) -> float:
    """The 95th percentile, nearest rank."""
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]


def window_metrics(reqs: List[Req], t0: float, t1: float) -> Dict:
    """End-to-end numbers of the window [t0, t1] from the stamps."""
    tokens, gaps, ttft = 0, [], []
    for r in reqs:
        for j, t in enumerate(r.tok_t):
            if t0 <= t <= t1:
                tokens += 1
                if j:
                    gaps.append(r.tok_t[j] - r.tok_t[j - 1])
        if t0 <= r.sub_t < t1:
            first = r.tok_t[0] if r.tok_t and r.tok_t[0] <= t1 else t1
            ttft.append(first - r.sub_t)
    return {"tokens": tokens, "gaps": gaps, "ttft": ttft,
            "output_tok_s": tokens / (t1 - t0),
            "itl_p95_ms": 1e3 * p95(gaps) if gaps else None,
            "ttft_p95_ms": 1e3 * p95(ttft) if ttft else None}


def window_flops(cfg: Dict, reqs: List[Req], t0: float, t1: float) -> int:
    """Model operations of the prompts prefilled and the tokens decoded
    in the window: a prompt counts when its first token came in it, a
    decoded token j >= 1 at its context ``len(prompt) + j``."""
    total = 0
    for r in reqs:
        p = len(r.offer.prompt)
        for j, t in enumerate(r.tok_t):
            if t0 <= t <= t1:
                total += Y.prefill_flops(cfg, p) if j == 0 \
                    else Y.decode_flops(cfg, p + j)
    return total


def sample(reqs: List[Req], t1: float, want_tokens: int, seed: int
           ) -> List[Req]:
    """The requests the comparison checks: drawn from the seed among
    those that finished by the close with every token they asked for,
    the longest (prompt and served tokens) first, until ``want_tokens``
    served tokens are in."""
    done = [r for r in reqs if len(r.tok_t) == r.offer.max_new
            and r.tok_t[-1] <= t1]
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r.offer.prompt) + r.offer.max_new,
                                       r.offer.index))
    rest = [r for r in done if r is not longest]
    random.Random(seed).shuffle(rest)
    out, n = [longest], longest.offer.max_new
    for r in rest:
        if n >= want_tokens:
            break
        out.append(r)
        n += r.offer.max_new
    return out


def gap_stats(gaps) -> Dict[str, float]:
    """The numbers a served sample's per-token logit gaps (one tensor a
    request) can be compared by: the widest (``logit_gap``), the mean,
    the 90th percentile, the share of tokens that are not the
    reference's first choice, the shares whose gap passes 0.25, 0.5 and
    1 (the logits' standard deviation is ~1.5), and the median over the
    requests of each request's mean gap."""
    import torch
    g = torch.cat(gaps).float()
    per_request = torch.stack([x.float().mean() for x in gaps])
    return {"logit_gap": float(g.max()), "mean_logit_gap": float(g.mean()),
            "p90_logit_gap": float(torch.quantile(g, 0.9)),
            "moved_share": float((g > 0).float().mean()),
            "over_quarter_share": float((g > 0.25).float().mean()),
            "over_half_share": float((g > 0.5).float().mean()),
            "over_one_share": float((g > 1.0).float().mean()),
            "request_median_gap": float(per_request.median())}


def compare(cfg: Dict, seed: int, picked: List[Req], device,
            quants=(None,)) -> Dict:
    """The reference over each picked prompt with its served tokens:
    the gap by which each served token's fp32 reference logit lies below
    the fp32 reference's best, summarised by ``gap_stats`` (``logit_gap``
    the widest, ``mean_logit_gap`` the mean, ...). For each further
    precision of ``quants`` (``reference.qwen2.mm``'s: "fp8" the
    control, "bf16" a witness), the same numbers of the tokens that
    reference ranks first at each position of the same sequences,
    prefixed ``<quant>_``. ``gaps`` holds every variant's per-token gaps,
    a list a request."""
    import torch

    from bench.reference import qwen2 as R
    R.plain_fp32()
    seqs, plens, served = [], [], []
    for r in picked:
        toks = r.tokens
        seqs.append(torch.as_tensor(
            list(r.offer.prompt) + toks[:-1], dtype=torch.long,
            device=device))
        plens.append(len(r.offer.prompt))
        served.append(torch.as_tensor(toks, dtype=torch.long, device=device))
    src = weights.ReferenceSource(cfg, seed, device)
    variants = tuple(dict.fromkeys((None, *quants)))
    outs = R.served_logits(cfg, src, seqs, plens, quants=variants)
    ref = outs[None]
    res: Dict = {"gaps": {}}
    for q in variants:
        gaps = []
        for i, lg in enumerate(ref):
            pick = served[i] if q is None else outs[q][i].argmax(-1)
            gaps.append(lg.max(-1).values
                        - lg.gather(-1, pick[:, None])[:, 0])
        pre = "" if q is None else f"{q}_"
        res.update({pre + k: v for k, v in gap_stats(gaps).items()})
        res["gaps"][q or "program"] = [[round(float(x), 5) for x in g]
                                       for g in gaps]
    res["tokens"] = int(sum(len(s) for s in served))
    res["requests"] = len(picked)
    return res


@dataclass
class ServeRun:
    """What a serving run leaves for the result line and the metric
    readers."""
    setup_s: float
    window_s: float
    e2e: Dict
    attempted: int
    failed: int
    flops: int
    memory_peak: int
    hist: Dict = field(default_factory=dict)
    trace: Optional[object] = None
    check: Dict = field(default_factory=dict)
    kind: str = "serve"


# the traced run profiles the window's last seconds: a whole window holds
# over a million kernel events
TRACE_SECONDS = 3.0
HISTS = ("repro_step_decode_seconds", "repro_step_prefill_seconds",
         "repro_prefill_chunk_tokens")


def _hist(engine) -> Dict:
    reg = engine.obs.registry
    out = {}
    for name in HISTS:
        h = reg.histogram(name)
        out[name] = (h.count, h.sum)
    return out


def _profile(probes, device: str, until: float):
    """A profile from now to ``until``, the probes recording in it."""
    from bench.harness import trace as TR
    prof = TR.Profile(device)
    prof.start()
    probes.on = True
    time.sleep(max(0.0, until - time.perf_counter()))
    probes.on = False
    prof.stop()
    return prof


def _window(engine, loop: ClosedLoop, seconds: float, trace: bool, probes,
            device: str, log):
    """Set-up's end (every client's first request has its first token
    and a decode step behind it, or is done), the window, and its
    close: (t0, t1, profile, the requests cancelled at the close,
    histograms at t0 and t1). A traced run profiles the window's last
    ``TRACE_SECONDS``, and where that profile holds no kernel, the
    next ones at the same load, before the close."""
    from bench.harness import trace as TR
    loop.start()
    first = list(loop.reqs)
    while not all(len(r.tok_t) >= min(2, r.offer.max_new) for r in first):
        if not engine.running:
            raise RuntimeError("the engine's drain thread stopped in set-up")
        time.sleep(0.002)
    t0 = time.perf_counter()
    h0 = _hist(engine) if trace else {}
    t1 = t0 + seconds
    prof, h1 = None, {}
    if trace:
        time.sleep(max(0.0, t1 - TRACE_SECONDS - time.perf_counter()))
        prof = _profile(probes, device, t1)
        h1 = _hist(engine)
        for _ in range(TR.PROFILE_TRIES - 1):
            if prof.kernels_seen():
                break
            log("trace: the profile holds no kernel; profiling the next "
                f"{TRACE_SECONDS} s at the same load")
            prof = _profile(probes, device,
                            time.perf_counter() + TRACE_SECONDS)
    else:
        time.sleep(max(0.0, t1 - time.perf_counter()))
    cut = loop.close()
    deadline = time.perf_counter() + 120
    while any(not r.handle.done for r in loop.reqs):
        if time.perf_counter() > deadline or not engine.running:
            raise RuntimeError("requests still in flight after the window "
                               "closed")
        time.sleep(0.005)
    return t0, t1, prof, cut, h0, h1


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        t_proc: float, log, quants=(None,)) -> ServeRun:
    """One serving run of ``cell``; ``t_proc`` is the process's start on
    the ``time.perf_counter`` clock."""
    import torch

    from bench.harness import trace as TR
    from repro_torch.models import transformer as T
    from repro_torch.runtime.engine import Engine, EngineConfig
    cfg, mix = cell.config, cell.mix
    pcfg = port_config(cfg)
    if device == "cuda":
        from repro_torch.kernels import _build
        _build.build_all()
    model = T.Transformer(pcfg, device=device)
    weights.load_program(model, cfg, seed)
    engine = Engine(pcfg, model, EngineConfig(
        max_slots=int(mix["max_slots"]), max_len=int(mix["max_len"]),
        observability=trace), device=device)
    probes = None
    if trace:
        TR.Profile.warm(device)
        probes = TR.Probes()
        probes.install_kernels()
        probes.install_engine(engine.scheduler)
    offers = traffic.staggered(
        traffic.serve_offers(mix, cfg["vocab_size"], seed),
        int(mix["clients"]))
    loop = ClosedLoop(engine, offers, int(mix["clients"]))
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    try:
        t0, t1, prof, cut, h0, h1 = _window(engine, loop, seconds, trace,
                                            probes, device, log)
    finally:
        engine.shutdown()
        if probes is not None:
            probes.remove()
    setup_s = t0 - t_proc
    loop.release()
    if loop.exhausted:
        log("warning: the traffic pool ran out inside the window")
    in_window = [r for r in loop.reqs if t0 <= r.sub_t < t1]
    cut_ids = {id(r) for r in cut}
    failed = sum(1 for r in in_window if id(r) not in cut_ids
                 and r.reason != "length")
    e2e = window_metrics(loop.reqs, t0, t1)
    out = ServeRun(setup_s, t1 - t0, e2e, len(in_window), failed,
                   window_flops(cfg, loop.reqs, t0, t1),
                   torch.cuda.max_memory_allocated()
                   if device == "cuda" else 0)
    if trace:
        out.hist = {k: (h1[k][0] - h0[k][0], h1[k][1] - h0[k][1])
                    for k in HISTS}
        out.trace = TR.reduce(prof, probes)
        log(f"trace: {len(probes.calls)} kernel calls probed, "
            f"{out.trace.linked} kernels linked to them, busy "
            f"{out.trace.busy_s:.4f} s of {out.trace.window_s:.4f} s")
        del prof
    picked = sample(loop.reqs, t1, cell.sample_tokens, seed)
    del engine, model
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    if picked:
        t = time.perf_counter()
        out.check = compare(cfg, seed, picked, device, quants)
        log(f"reference: {out.check['requests']} requests, "
            f"{out.check['tokens']} served tokens in "
            f"{time.perf_counter() - t:.1f} s")
    return out
