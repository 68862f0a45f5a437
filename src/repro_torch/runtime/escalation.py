"""Hierarchical edge<->server serving on the port: tiered engines with
a durable escalation queue.

Counterpart of ``repro.runtime.escalation``. A ``TieredEngine`` fronts a
small local (endpoint) ``Engine`` and a remote (server) tier, and
decides per request whether to answer locally or escalate. The decision
is a policy list (``runtime.policies``: ``confidence`` gates on the
local model's next-token certainty, ``deadline-risk`` escalates work
the local queue cannot finish in time, ``overload`` escalates under
local queue or KV pressure, ``always`` / ``never`` are the paper's
always-offload and endpoint-alone baselines). The fraction of traffic
that leaves the device is a run-time quantity, reported by
``benchmarks/torch_escalation_bench.py`` and countable from
``/metrics``.

The durable escalation queue lives in ``runtime.escalation_queue`` and
is re-exported here: ``EscalationJournal`` (a bounded on-disk FIFO in
the reference's record format), ``JournalReplayer`` (in-order,
at-least-once replay with ack-side de-dup) and the transports
(``InProcessTransport``, ``HttpTransport``, ``FlakyTransport``).

Degraded modes close the loop: while the link is down, a journaled
request whose deadline cannot wait is answered by the local engine with
``finish_reason="local_fallback"``; one whose deadline has already
passed is shed as ``"timeout"``. When the link revives, the journal
fails back (replays in order to the server tier) and the transition is
counted (``repro_failback_total``) and traced.

The confidence probe runs the port's ``transformer.prefill`` under
``torch.inference_mode()`` on the caller's thread, in a scratch cache of
its own: it touches neither engine's caches, and on the card its flash
launches (one a layer) show on the kernels' thread-safe counters. The
reference jits one probe per prompt length; here there is nothing to
compile, so every length runs the same call. The probe and both tiers'
drain threads take the device's step lock (``scheduler.device_step_lock``)
in turns, a step or a probe at a time.

The ``TieredEngine`` duck-types the ``Engine`` surface the HTTP front
end drives (``submit``/``snapshot``/``metrics_text``/``trace_json``/
``start``/``shutdown``), so ``runtime.server.EngineServer`` can front a
tiered endpoint unchanged: ``/generate`` escalates transparently,
``/status`` reports the tier identity and escalation state, and
``/metrics`` exposes ``repro_escalated_total``,
``repro_local_fallback_total``, ``repro_failback_total`` and the
``repro_escalation_queue_depth`` gauge.
"""
from __future__ import annotations

import tempfile
import threading
import time
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import transformer as T
from repro_torch.runtime.engine import Engine
from repro_torch.runtime.escalation_queue import (  # noqa: F401 (re-export)
    EscalationJournal, FlakyTransport, HttpTransport, InProcessTransport,
    JournalEntry, JournalFull, JournalReplayer, LinkDown, TransportError)
from repro_torch.runtime.observability import TIME_BUCKETS_S
from repro_torch.runtime.policies import make_escalation
from repro_torch.runtime.scheduler import (Completion, Request,
                                           validate_request_fits)

__all__ = [
    "LinkDown", "TransportError", "JournalFull",
    "EscalationJournal", "JournalEntry", "JournalReplayer",
    "InProcessTransport", "HttpTransport", "FlakyTransport",
    "EscalationContext", "TieredConfig", "TieredHandle", "TieredEngine",
]

# ---------------------------------------------------------------------------
# tiered engine
# ---------------------------------------------------------------------------


@dataclass
class EscalationContext:
    """What an escalation policy sees (see ``runtime.policies``).
    Both ``snapshot`` and ``confidence()`` are lazy and cached: each is
    computed only if some policy asks, and at most once per request —
    submit() sits on the caller's latency path, so the context must cost
    nothing for policies that never look."""

    req: Request
    now_s: float
    snapshot_fn: Optional[Callable[[], Dict[str, Any]]] = None
    confidence_fn: Optional[Callable[[], float]] = None
    _snap: Optional[Dict[str, Any]] = field(default=None, repr=False)
    _cached: Optional[float] = field(default=None, repr=False)

    @property
    def snapshot(self) -> Dict[str, Any]:
        if self._snap is None:
            self._snap = (self.snapshot_fn()
                          if self.snapshot_fn is not None else {})
        return self._snap

    def confidence(self) -> float:
        if self._cached is None:
            self._cached = (self.confidence_fn()
                            if self.confidence_fn is not None else 1.0)
        return self._cached


@dataclass
class TieredConfig:
    """Escalation knobs for one ``TieredEngine``."""

    # policy list (names from policies.ESCALATION_POLICIES or
    # instances); ORed — the first reason to escalate wins
    policies: Any = ("confidence",)
    # durable queue: directory (None = fresh tempdir) + capacity bound
    journal_dir: Optional[str] = None
    journal_capacity: int = 256
    # this engine's tier identity (reported in /status and snapshots)
    tier: str = "endpoint"
    # link down: a journaled request whose deadline slack falls below
    # this is answered locally as finish_reason="local_fallback"; one
    # whose deadline already passed is shed as "timeout". Requests
    # without deadlines wait for the link — that is what durable means.
    fallback_slack_s: float = 0.25
    # pump cadence while idle / link-down backoff
    poll_interval_s: float = 0.02
    # replay fairness: sends attempted per pump round
    max_sends_per_pump: int = 8
    # concurrent in-flight sends per replay round: the server tier
    # batches the window across its decode slots (1 = fully serial).
    # Completion *surfacing* stays in sequence order either way.
    replay_window: int = 4


class TieredHandle:
    """The caller's end of one tiered request. Mirrors the
    ``RequestHandle`` surface the HTTP front end uses (``stream()``,
    ``result()``, ``cancel()``, ``.completion``); adds the tier verdict:
    ``escalated`` (did it leave the device), ``reason`` (which policy
    fired), ``tier`` (who answered), ``seq`` (journal sequence when
    escalated)."""

    def __init__(self, engine: "TieredEngine", request: Request):
        self.request = request
        self.completion: Optional[Completion] = None
        self.escalated = False
        self.reason: Optional[str] = None
        self.tier: Optional[str] = None
        self.seq: Optional[int] = None
        self.arrival_s = 0.0
        self._engine = engine
        self._inner = None              # local RequestHandle, when local
        self._cancelled = False
        self._done = threading.Event()

    @property
    def done(self) -> bool:
        return self.completion is not None

    @property
    def finish_reason(self) -> Optional[str]:
        return self.completion.finish_reason if self.completion else None

    @property
    def tokens(self) -> List[int]:
        if self.completion is not None:
            return list(self.completion.tokens)
        inner = self._inner
        return list(inner.tokens) if inner is not None else []

    def cancel(self) -> None:
        """Cancel: a local request cancels through its engine handle; a
        journaled one is retired by the pump before its next send."""
        self._cancelled = True
        inner = self._inner
        if inner is not None:
            inner.cancel()

    def result(self, timeout: Optional[float] = None) -> Completion:
        inner = self._inner
        if inner is not None and self.completion is None:
            # finalize from the waiting thread: local completions must
            # not queue behind the pump, which can be blocked inside a
            # (serial, possibly slow) escalation send
            inner.result(timeout)
            self._engine._finalize_if_pending(self)
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"request {self.request.id} did not complete within "
                f"{timeout}s")
        return self.completion

    def stream(self) -> Iterator[int]:
        """Yield tokens as they exist. Locally-served requests stream
        live through the inner engine handle; escalated ones burst when
        the server's completion lands (the transport returns whole
        completions). Never returns before ``completion`` is set."""
        while True:
            inner = self._inner
            if inner is not None:
                for tok in inner.stream():
                    yield tok
                self._engine._finalize_if_pending(self)
                self._done.wait()
                # a fallback rewrite never changes tokens, only reason
                return
            if self._done.wait(0.05):
                for tok in self.completion.tokens:
                    yield tok
                return

    # engine-side
    def _complete(self, c: Completion, tier: str) -> None:
        if self.completion is not None:
            return
        self.tier = tier
        self.completion = c
        self._done.set()


class TieredEngine:
    """Policy-gated front over a local (endpoint) ``Engine`` and a
    remote (server) tier reached through a transport.

    ``submit()`` consults the escalation policies; local requests flow
    straight into the endpoint engine (token streams and greedy content
    are *bit-identical* to running that engine alone — escalation moves
    requests, never content), escalated ones are journaled durably and
    replayed in order to the server tier by a background pump, with
    deadline-aware local fallback while the link is down and fail-back
    on revival. Background-only: ``start()`` (which also starts the
    local engine's drain) before ``submit()``."""

    def __init__(self, local: Engine, transport: Any,
                 config: Optional[TieredConfig] = None):
        if local.batch_mode:
            raise ValueError(
                "the tiered engine pumps the local engine's background "
                "drain; batch admission has no step loop — use a "
                "continuous admission policy (fifo | priority | edf)")
        self.local = local
        self.transport = transport
        self.config = cfg = config or TieredConfig()
        self.policies = make_escalation(cfg.policies)
        root = cfg.journal_dir or tempfile.mkdtemp(prefix="esc-journal-")
        self.journal = EscalationJournal(root, cfg.journal_capacity)
        self.replayer = JournalReplayer(
            self.journal, transport,
            on_complete=self._on_delivered,
            on_permanent_error=self._on_permanent_error,
            window=cfg.replay_window)
        self.obs = local.obs            # one registry/tracer: /metrics and
        #                                 /trace stay single-source
        self._lock = threading.Lock()
        self._handles: Dict[int, TieredHandle] = {}
        self._local_pending: List[Tuple[TieredHandle, bool]] = []
        self._failbacks_seen = 0
        self._pump: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._work = threading.Event()
        self._t0 = time.perf_counter()
        r = self.obs.registry
        self._c_escalated = r.counter(
            "repro_escalated_total",
            help="requests answered by the server tier")
        self._c_fallback = r.counter(
            "repro_local_fallback_total",
            help="escalations answered locally because the link was down "
                 "and the deadline could not wait")
        self._c_failback = r.counter(
            "repro_failback_total",
            help="link revivals that resumed journal replay to the "
                 "server tier")
        self._c_sheds = r.counter(
            "repro_escalation_sheds_total",
            help="journaled requests shed as timeout while the link was "
                 "down")
        self._g_depth = r.gauge(
            "repro_escalation_queue_depth",
            help="escalated requests pending in the durable journal")
        self._h_ttft = {
            "local": r.histogram(
                "repro_tier_local_ttft_seconds", TIME_BUCKETS_S,
                help="TTFT of requests answered on the endpoint tier"),
            transport.tier: r.histogram(
                f"repro_tier_{transport.tier}_ttft_seconds", TIME_BUCKETS_S,
                help=f"submit-to-completion wall latency of requests "
                     f"escalated to the {transport.tier} tier"),
        }

    # -- engine-surface plumbing (what EngineServer drives) -----------------

    batch_mode = False

    @property
    def tier(self) -> str:
        return self.config.tier

    @property
    def max_len(self) -> int:
        return self.local.max_len

    @property
    def cfg(self):
        return self.local.cfg

    @property
    def running(self) -> bool:
        t = self._pump
        return t is not None and t.is_alive()

    def now(self) -> float:
        """Seconds on the tiered engine's clock (since ``start()``) —
        the clock arrival stamps, deadlines, and the failure trace for
        a ``FlakyTransport`` all share."""
        return time.perf_counter() - self._t0

    def start(self) -> "TieredEngine":
        if self.running:
            return self
        self._t0 = time.perf_counter()
        if hasattr(self.transport, "bind_clock"):
            self.transport.bind_clock(self.now)
        self.local.start()
        self._stop.clear()
        self._pump = threading.Thread(
            target=self._pump_loop, name="tiered-pump", daemon=True)
        self._pump.start()
        return self

    def shutdown(self, wait: bool = True) -> None:
        self._stop.set()
        self._work.set()
        t = self._pump
        if wait and t is not None and t is not threading.current_thread():
            t.join()
        self._pump = None
        self.local.shutdown(wait=wait)

    def __enter__(self) -> "TieredEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # -- submission ---------------------------------------------------------

    def submit(self, req: Request, arrival_s: float = 0.0) -> TieredHandle:
        """Decide (escalate or answer locally) and enqueue. Thread-safe,
        like the engine surface it fronts."""
        if not self.running:
            raise RuntimeError(
                "TieredEngine is background-only: call start() first")
        validate_request_fits(self.local.cfg, req, self.local.max_len)
        handle = TieredHandle(self, req)
        handle.arrival_s = arrival_s or self.now()
        ctx = EscalationContext(
            req=req, now_s=handle.arrival_s,
            snapshot_fn=self._load_view,
            confidence_fn=lambda: self._confidence(req))
        reason = None
        for policy in self.policies:
            reason = policy.decide(ctx)
            if reason:
                break
        if reason is None:
            self._submit_local(handle, fallback=False)
            return handle
        handle.escalated = True
        handle.reason = reason
        try:
            seq = self.journal.append(req, arrival_s=handle.arrival_s,
                                      source=self.config.tier)
        except JournalFull:
            # bounded durability: degrade to a local answer rather than
            # queueing without bound (reported as local_fallback)
            self._submit_local(handle, fallback=True)
            return handle
        handle.seq = seq
        with self._lock:
            self._handles[seq] = handle
        if self.obs.enabled:
            self.obs.tracer.async_begin(
                "tiered", "escalation", "escalate", seq, handle.arrival_s,
                args={"request": req.id, "reason": reason})
        self._g_depth.set(self.journal.depth)
        self._work.set()
        return handle

    def _submit_local(self, handle: TieredHandle, *, fallback: bool) -> None:
        handle._inner = self.local.submit(handle.request)
        with self._lock:
            self._local_pending.append((handle, fallback))
        self._work.set()

    def _finalize_if_pending(self, handle: TieredHandle) -> None:
        """Finalize a locally-served handle whose engine completion is
        ready — callable from the waiting caller *or* the pump; whoever
        removes the pending entry under the lock does the work, so the
        race is idempotent."""
        if handle._inner is None or not handle._inner.done:
            return
        with self._lock:
            entry = next((p for p in self._local_pending
                          if p[0] is handle), None)
            if entry is None:
                return
            self._local_pending.remove(entry)
        self._finalize_local(handle, entry[1])

    def _load_view(self) -> Dict[str, Any]:
        """Cheap local-load view for escalation policies — deliberately
        NOT ``Engine.snapshot()``. The snapshot takes the engine lock,
        which the background drain holds across every scheduler step and
        reacquires immediately in a tight loop: a submit-path caller can
        convoy behind it for the length of the whole local backlog.
        Policies want a load *heuristic*, not a consistent snapshot, so
        this reads the counters lock-free (atomic int reads; at worst
        one step stale) and treats KV stats as best-effort."""
        s = self.local.scheduler
        if s is None:
            return {"queue_depth": 0, "active_slots": 0, "kv": {}}
        depth = max(0, s._waiting()) + len(self.local._inbox)
        view: Dict[str, Any] = {"queue_depth": depth,
                                "active_slots": len(s.active)}
        try:
            view["kv"] = s.kv_stats()
        except Exception:
            view["kv"] = {}         # racing a layout mutation: skip, don't block
        return view

    # -- confidence probe ---------------------------------------------------

    def _confidence(self, req: Request) -> float:
        """Local-model certainty about ``req``: max softmax probability
        (fp32) of the next-token prediction after prefilling the prompt
        into a scratch cache of the probe's own, the LLM analogue of the
        shallow-head gate in ``examples/torch_early_exit_offload.py``."""
        model = self.local.model
        tokens = torch.as_tensor(np.asarray(req.prompt, np.int32)[None, :],
                                 device=model.device)
        # between two steps of the engines on the device, not inside one
        with self.local.scheduler.step_lock, torch.inference_mode():
            logits, _, _ = T.prefill(model, tokens, max_len=self.local.max_len)
            return float(torch.softmax(logits[0].float(), dim=-1).max())

    # -- pump ---------------------------------------------------------------

    def _pump_loop(self) -> None:
        while not self._stop.is_set():
            progressed = self._pump_once()
            if not progressed:
                self._work.wait(self.config.poll_interval_s)
                self._work.clear()

    def _pump_once(self) -> bool:
        did = False
        # 1. finalize local submissions whose engine handle completed
        #    (waiting callers race us through _finalize_if_pending; the
        #    pump sweep covers handles nobody is waiting on)
        with self._lock:
            pairs = list(self._local_pending)
        for handle, fallback in pairs:
            if handle._inner.done:
                before = handle.done
                self._finalize_if_pending(handle)
                did |= not before
        # 2. link state / fail-back detection
        up = self.replayer.probe()
        if self.replayer.failbacks > self._failbacks_seen:
            self._c_failback.inc(
                self.replayer.failbacks - self._failbacks_seen)
            self._failbacks_seen = self.replayer.failbacks
            if self.obs.enabled:
                self.obs.tracer.instant(
                    "tiered", "escalation", "failback", self.now(),
                    args={"pending": self.journal.depth})
        # 3. triage journaled requests: cancellations always; deadline
        #    pressure only while the link is down (when it is up, replay
        #    below is the fastest path to an answer)
        did |= self._triage(link_up=up)
        # 4. replay toward the server tier
        if up:
            did |= self.replayer.step(
                max_sends=self.config.max_sends_per_pump) > 0
        self._g_depth.set(self.journal.depth)
        return did

    def _triage(self, *, link_up: bool) -> bool:
        did = False
        now = self.now()
        for entry in self.journal.pending():
            if entry.seq in self.replayer.delivered:
                continue
            with self._lock:
                handle = self._handles.get(entry.seq)
            if handle is None:
                continue        # crash-restart orphan: replay-only
            if handle._cancelled:
                self._retire(entry.seq, handle, Completion(
                    entry.req.id, [], 0.0, 0.0, arrival_s=handle.arrival_s,
                    finish_reason="cancelled"), tier=self.config.tier)
                did = True
                continue
            if link_up or entry.req.deadline_s is None:
                continue
            due = handle.arrival_s + entry.req.deadline_s
            if due <= now:
                # escalated-timeout shed: consistent with the engine's
                # wall-clock deadline enforcement
                self._c_sheds.inc()
                self._retire(entry.seq, handle, Completion(
                    entry.req.id, [], 0.0, 0.0, arrival_s=handle.arrival_s,
                    finish_s=now, finish_reason="timeout"),
                    tier=self.config.tier)
                did = True
            elif due - now <= self.config.fallback_slack_s:
                # degraded local answering: the deadline can't wait for
                # the link — answer on-device, marked local_fallback
                self.replayer.delivered.add(entry.seq)
                self.journal.ack(entry.seq)
                with self._lock:
                    self._handles.pop(entry.seq, None)
                if self.obs.enabled:
                    self.obs.tracer.async_end(
                        "tiered", "escalation", entry.seq, now,
                        args={"outcome": "local_fallback"})
                self._submit_local(handle, fallback=True)
                did = True
        return did

    def _retire(self, seq: int, handle: TieredHandle, c: Completion, *,
                tier: str) -> None:
        """Complete a journaled request without sending it."""
        self.replayer.delivered.add(seq)
        self.journal.ack(seq)
        with self._lock:
            self._handles.pop(seq, None)
        if self.obs.enabled:
            self.obs.tracer.async_end(
                "tiered", "escalation", seq, self.now(),
                args={"outcome": c.finish_reason})
        handle._complete(c, tier)

    # -- completion paths ---------------------------------------------------

    def _finalize_local(self, handle: TieredHandle, fallback: bool) -> None:
        c = handle._inner.completion
        if fallback and c.finish_reason in ("eos", "length"):
            c = replace(c, finish_reason="local_fallback")
        if fallback:
            self._c_fallback.inc()
        if self.obs.enabled:
            self._h_ttft["local"].observe(max(c.ttft_s, 0.0))
        handle._complete(c, self.config.tier)

    def _on_delivered(self, entry: JournalEntry, c: Completion) -> None:
        with self._lock:
            handle = self._handles.pop(entry.seq, None)
        self._c_escalated.inc()
        now = self.now()
        if self.obs.enabled and handle is not None:
            # (handle None = crash-restart orphan: replayed for
            # durability, but no span was opened in this process)
            self.obs.tracer.async_end(
                "tiered", "escalation", entry.seq, now,
                args={"outcome": "escalated", "tier": self.transport.tier})
            self._h_ttft[self.transport.tier].observe(
                max(now - handle.arrival_s, 0.0))
        if handle is not None:
            handle._complete(c, self.transport.tier)

    def _on_permanent_error(self, entry: JournalEntry, e: Exception) -> None:
        with self._lock:
            handle = self._handles.pop(entry.seq, None)
        if self.obs.enabled and handle is not None:
            self.obs.tracer.async_end(
                "tiered", "escalation", entry.seq, self.now(),
                args={"outcome": "failed", "error": str(e)})
        if handle is not None:
            handle._complete(Completion(
                entry.req.id, [], 0.0, 0.0, arrival_s=handle.arrival_s,
                finish_reason="failed"), self.transport.tier)

    # -- introspection ------------------------------------------------------

    def escalation_stats(self) -> Dict[str, Any]:
        return {
            "queue_depth": self.journal.depth,
            "link_up": self.replayer.link_up,
            "escalated": int(self._c_escalated.value),
            "local_fallback": int(self._c_fallback.value),
            "failback": int(self._c_failback.value),
            "sheds": int(self._c_sheds.value),
            "tiers": ["local", self.transport.tier],
        }

    def snapshot(self) -> Dict[str, Any]:
        snap = self.local.snapshot()
        snap["tier"] = self.config.tier
        snap["escalation"] = self.escalation_stats()
        return snap

    def stats(self) -> Dict[str, int]:
        return self.local.stats()

    def kv_stats(self) -> Dict[str, float]:
        return self.local.kv_stats()

    def metrics_text(self,
                     extra_gauges: Optional[Dict[str, float]] = None) -> str:
        """One Prometheus exposition for the whole tier: the local
        engine's counters/gauges/histograms plus the escalation metrics
        (they share the registry, so this is the engine's own render
        with the queue-depth gauge freshly stamped)."""
        self._g_depth.set(self.journal.depth)
        return self.local.metrics_text(extra_gauges=extra_gauges)

    def trace_json(self) -> Dict[str, Any]:
        return self.local.trace_json()
