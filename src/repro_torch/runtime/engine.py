"""Unified serving facade of the port: one ``Engine``, policy-configured.

Counterpart of ``repro.runtime.engine`` with its ``EngineConfig``.
``admission`` picks the policy: ``"fifo"`` | ``"priority"`` | ``"edf"``
stream through the continuous scheduler; ``"batch"`` runs
the static-bucket executor (closed batches grouped by prompt length),
the oracle every other policy's greedy tokens must equal. Under a
continuous policy:

* ``kv_layout`` — ``"slotted"`` (dense per-slot rows) | ``"paged"``
  (a shared block pool of ``num_blocks`` blocks of ``block_size`` rows,
  an admission ``watermark``, and growth preemption whose victims the
  ``preemption`` policy picks);
* ``prefix_cache`` (paged only) — admissions share the resident blocks
  of a common prompt prefix copy-on-write and prefill only the rest;
  ``victim_cache`` parks completed requests' chains in a reclaimable
  pool (``victim_eviction`` order) under per-tenant byte budgets
  (``prefix_cache_tenants``), and ``save_prefix_cache`` /
  ``restore_prefix_cache`` carry that pool across a restart;
* ``prefill_chunk`` — prompts are prefilled that many tokens per
  scheduler step, interleaved with decode steps;
* ``enforce_deadlines`` — requests whose wall-clock deadline passes are
  shed with ``finish_reason="timeout"``;
* ``units`` / ``prefill_units`` / ``decode_stages`` / ``placement`` —
  the multi-unit execution core's modeled clocks; ``decode_stages > 1``
  decodes through the stage-partitioned step;
* ``observability`` — histograms, per-step phases and a Chrome trace,
  served by ``metrics_text()`` and ``trace_json()``.

The engine serves callers on two clocks: caller-pumped (``run()`` /
``step()`` / ``RequestHandle.stream()`` advance the scheduler from the
calling thread) and background-drained (``start()`` spawns one drain
thread, the only thread that runs the model, while ``submit()`` /
``cancel()`` are thread-safe, handles wait on condition variables, and
``asubmit()`` / ``astream()`` give asyncio callers the same surface).
``runtime.server`` builds the HTTP front end on the second.

The engine runs on ``device`` (default ``"cuda"``); there prefill (and
its chunked or prefix-resumed extension) runs the port's flash kernel
and decode runs the slotted or the paged decode kernel. It raises
without a card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import asyncio
import collections
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import (Any, AsyncIterator, Callable, Dict, Iterator, List,
                    Optional, Tuple)

import numpy as np
import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.runtime.observability import Observability
from repro_torch.runtime.policies import (BatchAdmission, Sampler,
                                          make_admission, make_preemption)
from repro_torch.runtime.scheduler import (COUNTER_KEYS, Completion,
                                           ContinuousScheduler, Request,
                                           SchedulerConfig, SlotFailure,
                                           validate_request_fits)
from repro_torch.runtime.scheduler.prefix_pool import (restore_victim_cache,
                                                       save_victim_cache)

__all__ = ["Engine", "EngineConfig", "RequestHandle"]

KV_LAYOUTS = ("slotted", "paged")


@dataclass
class EngineConfig:
    """Structured engine configuration: the reference's fields."""

    max_slots: int = 8          # decode batch width (continuous policies)
    max_len: int = 512          # KV rows per slot
    # cache shape: "slotted" dense rows | "paged" shared block pool
    kv_layout: str = "slotted"
    block_size: int = 16        # KV rows per paged block
    num_blocks: int = 0         # 0 = slotted parity + reserved null block
    # paged admission watermark: keep this many blocks free beyond the
    # prompt's need when admitting, as growth headroom for running
    # requests
    watermark: int = 0
    prefill_chunk: int = 0      # chunked prefill (0 = one-shot)
    # prefix sharing (paged only): admission matches new prompts against
    # resident block chains and maps shared blocks into the request's
    # table copy-on-write, skipping prefill for the matched region
    prefix_cache: bool = False
    # victim cache (requires prefix_cache): released refcount-1 prefix
    # blocks park in a reclaimable pool (K/V resident, index alive), so
    # cold admissions hit completed requests' chains across drain
    # epochs; evicted (victim_eviction order) under allocation pressure
    victim_cache: bool = False
    victim_eviction: Any = "weighted-lru"   # | "lru" (policies registry)
    # per-tenant victim-pool byte budgets ({Request.tenant: bytes}); an
    # over-budget tenant evicts only its own chains. Tenant namespaces
    # isolate the prefix index whenever prefix_cache is on.
    prefix_cache_tenants: Optional[Dict[str, int]] = None
    admission: Any = "fifo"     # "fifo" | "priority" | "edf" | "batch"
    # who loses their blocks under paged pool pressure
    preemption: Any = "evict-latest"    # | "lowest-priority"
    # wall-clock deadline enforcement: shed requests whose
    # arrival_s + deadline_s instant passes (finish_reason="timeout")
    # instead of only ordering by deadline (EDF). Continuous only.
    enforce_deadlines: bool = False
    # multi-unit execution core (continuous only): model the drain on
    # `units` per-unit clocks, `prefill_units` of them dedicated to
    # prompt prefill (0 = colocated) and the rest pipelining decode
    # across `decode_stages` stage-partitioned groups. Token content is
    # identical for every topology; only the modeled timeline moves.
    units: int = 1
    prefill_units: int = 0
    decode_stages: int = 1
    placement: Any = "round-robin"      # | "least-loaded" (prefill units)
    greedy: bool = True
    temperature: float = 1.0
    seed: int = 0
    # wall-clock device-speed handicap: sleep this long after every
    # non-idle scheduler step, emulating a slower device (the edge
    # endpoint tier of a TieredEngine when both tiers share one host).
    # Content-neutral: tokens are bit-identical at any value.
    step_delay_s: float = 0.0
    debug: bool = False         # step-boundary invariant checks
    # metrics + lifecycle tracing (runtime.observability): histograms,
    # per-request spans, per-step phase breakdown, /trace export. Off by
    # default; the disabled hot path pays one `is None` test per hook.
    observability: bool = False

    # -- shared CLI construction (launch/serve.py and runtime/server.py
    #    register the same flags, so the policy surface can't drift
    #    between entry points) ------------------------------------------

    @staticmethod
    def add_cli_args(ap) -> None:
        """Register the engine-policy flags on an argparse parser."""
        ap.add_argument("--policy", default=None,
                        choices=("batch", "fifo", "priority", "edf"),
                        help="admission policy: 'batch' = static buckets "
                             "(closed batch, the seed path); fifo/priority/"
                             "edf stream through the continuous scheduler")
        ap.add_argument("--preemption", default="evict-latest",
                        choices=("evict-latest", "lowest-priority"),
                        help="paged-pool preemption victim policy")
        ap.add_argument("--slots", type=int, default=8,
                        help="decode batch width (continuous policies)")
        ap.add_argument("--paged", action="store_true",
                        help="paged KV cache: global-attn K/V in a shared "
                             "block pool with per-slot block tables")
        ap.add_argument("--prefix-cache", action="store_true",
                        help="share paged KV blocks between requests with a "
                             "common prompt prefix (copy-on-write; implies "
                             "--paged): matched prompts skip prefill for "
                             "the resident region")
        ap.add_argument("--victim-cache", action="store_true",
                        help="retain completed requests' prefix chains in "
                             "a reclaimable victim pool (implies "
                             "--prefix-cache); evicted weighted-LRU only "
                             "under allocation pressure")
        ap.add_argument("--block-size", type=int, default=16,
                        help="KV rows per paged block")
        ap.add_argument("--num-blocks", type=int, default=0,
                        help="paged pool size in blocks (0 = parity with "
                             "the slotted cache + the reserved null block)")
        ap.add_argument("--watermark", type=int, default=0,
                        help="paged admission watermark: keep this many "
                             "blocks free beyond the prompt's need when "
                             "admitting (growth headroom; damps preemption "
                             "thrash)")
        ap.add_argument("--prefill-chunk", type=int, default=0,
                        help="admit prompts this many tokens at a time, "
                             "interleaved with decode steps (0 = one-shot "
                             "prefill)")
        ap.add_argument("--units", type=int, default=1,
                        help="modeled processing units for the execution "
                             "core (1 = the classic single-unit timeline)")
        ap.add_argument("--prefill-units", type=int, default=0,
                        help="units dedicated to prompt prefill "
                             "(prefill/decode disaggregation; 0 = "
                             "colocated with decode)")
        ap.add_argument("--decode-stages", type=int, default=1,
                        help="decode pipeline stages across the decode "
                             "units (stage-partitioned decode step)")
        ap.add_argument("--placement", default="round-robin",
                        choices=("round-robin", "least-loaded"),
                        help="prefill-unit placement policy")
        ap.add_argument("--enforce-deadlines", action="store_true",
                        help="shed requests whose wall-clock deadline_s "
                             "passes (finish_reason='timeout') instead of "
                             "only ordering by deadline")
        ap.add_argument("--observability", action="store_true",
                        help="record lifecycle spans + latency histograms "
                             "(served at /metrics and /trace)")

    @classmethod
    def from_args(cls, args, **overrides) -> "EngineConfig":
        """Build an ``EngineConfig`` from ``add_cli_args`` flags.
        ``overrides`` (e.g. ``max_len=...``, or a forced ``admission``)
        win over the parsed flags."""
        victim = getattr(args, "victim_cache", False)
        prefix = args.prefix_cache or victim
        paged = args.paged or prefix
        kw = dict(
            max_slots=args.slots,
            kv_layout="paged" if paged else "slotted",
            block_size=args.block_size, num_blocks=args.num_blocks,
            watermark=args.watermark, prefill_chunk=args.prefill_chunk,
            prefix_cache=prefix, victim_cache=victim,
            admission=args.policy or "fifo", preemption=args.preemption,
            enforce_deadlines=args.enforce_deadlines,
            units=getattr(args, "units", 1),
            prefill_units=getattr(args, "prefill_units", 0),
            decode_stages=getattr(args, "decode_stages", 1),
            placement=getattr(args, "placement", "round-robin"),
            observability=getattr(args, "observability", False))
        kw.update(overrides)
        return cls(**kw)


class RequestHandle:
    """The caller's end of one submitted request.

    * ``tokens`` — every token streamed so far. Under greedy sampling a
      failure re-queue re-decodes the identical prefix and the handle
      dedups by index, so the stream is a stable prefix of the final
      ``Completion.tokens``; under stochastic sampling a re-queue
      *restarts* the stream (the PRNG advanced, the prefix can't replay
      bit-identically), so streaming consumers there should prefer
      ``result().tokens``;
    * ``on_token(cb)`` — per-token callback, fired the moment a token is
      emitted, before the engine moves on;
    * ``stream()`` — pull iterator: yields tokens as they are produced,
      driving ``Engine.step()`` under the hood while the request lives;
    * ``cancel()`` — after it returns, not one more token is emitted;
      the request completes with ``finish_reason="cancelled"`` (queued
      requests complete immediately with no tokens);
    * ``result()`` — block until this request finishes and return its
      ``Completion`` (caller-pumped engines are driven step by step;
      background-drained engines are waited on).

    With a background drain thread running (``Engine.start()``) every
    accessor is thread-safe: tokens/completion are published under a
    condition variable, ``stream()``/``result()`` wait instead of
    pumping, and ``aresult()``/``astream()`` expose the same waits as
    coroutines for asyncio callers.
    """

    def __init__(self, engine: "Engine", request: Request):
        self.request = request
        self.tokens: List[int] = []
        self.completion: Optional[Completion] = None
        self._engine = engine
        self._callbacks: List[Callable[[int], None]] = []
        self._cancelled = False
        self._ticket = None         # continuous path only
        self._cond = threading.Condition()
        self._done_evt = threading.Event()

    @property
    def done(self) -> bool:
        return self.completion is not None

    @property
    def finish_reason(self) -> Optional[str]:
        return self.completion.finish_reason if self.completion else None

    def cancel(self) -> None:
        """Flag the request for cancellation. Safe to call from inside a
        token callback (the flag is checked before every emission), from
        any thread while the engine drains in the background, and
        idempotent; a no-op once the request has completed."""
        if self.completion is not None:
            return
        self._cancelled = True
        if self._ticket is not None:
            with self._engine._entry_lock():
                self._engine.scheduler.request_cancel(self._ticket)

    def on_token(self, cb: Callable[[int], None]) -> Callable[[int], None]:
        """Register a per-token callback; returns it (decorator-friendly)."""
        self._callbacks.append(cb)
        return cb

    def _wait_progress(self, start: int, timeout: Optional[float] = None
                       ) -> Tuple[List[int], bool]:
        """Block until more than ``start`` tokens exist or the request
        completed; returns (tokens past ``start``, done). Against a
        background-drained engine this is a condition wait; against a
        caller-pumped one it advances the engine a step instead."""
        if self._engine.running:
            def ready():
                return len(self.tokens) > start or self.completion is not None
            with self._cond:
                if timeout is not None:
                    self._cond.wait_for(ready, timeout)
                else:
                    # bounded waits so a shutdown() mid-request degrades
                    # to caller-pumping on the next call, not a hang
                    while not ready() and self._engine.running:
                        self._cond.wait(0.1)
                return list(self.tokens[start:]), self.completion is not None
        if len(self.tokens) <= start and self.completion is None:
            self._engine.step()
        return list(self.tokens[start:]), self.completion is not None

    def stream(self) -> Iterator[int]:
        """Yield tokens as the engine produces them, until this request
        finishes. Caller-pumped engines are advanced step by step
        (serving every other in-flight request along the way); with a
        background drain thread the iterator just waits for tokens.
        Batch admission runs whole buckets per step, so there the
        iterator yields each bucket's tokens in bursts."""
        i = 0
        while True:
            toks, done = self._wait_progress(i)
            for t in toks:
                yield t
            i += len(toks)
            if done and i >= len(self.tokens):
                return

    def result(self, timeout: Optional[float] = None) -> Completion:
        """Block until this request completes and return its
        ``Completion`` (driving the engine if nothing else does).
        ``timeout`` (background mode) raises ``TimeoutError`` rather
        than waiting forever on a stopped engine."""
        if self._engine.running:
            if timeout is not None:
                if not self._done_evt.wait(timeout):
                    raise TimeoutError(
                        f"request {self.request.id} did not complete within "
                        f"{timeout}s")
                return self.completion
            while self._engine.running and not self._done_evt.wait(0.1):
                pass                # engine stopped mid-wait -> pump below
            if self.completion is not None:
                return self.completion
        while self.completion is None:
            self._engine.step()
        return self.completion

    async def aresult(self) -> Completion:
        """Asyncio variant of ``result()``: waits off the event loop."""
        return await asyncio.get_running_loop().run_in_executor(
            None, self.result)

    async def astream(self) -> AsyncIterator[int]:
        """Asyncio variant of ``stream()``: yields tokens as they are
        produced without blocking the event loop."""
        loop = asyncio.get_running_loop()
        i = 0
        while True:
            toks, done = await loop.run_in_executor(
                None, lambda: self._wait_progress(i, timeout=0.1))
            for t in toks:
                yield t
            i += len(toks)
            if done and i >= len(self.tokens):
                return

    # -- engine-side hooks --------------------------------------------------

    def _emit(self, index: int, tok: int) -> None:
        with self._cond:
            if index < len(self.tokens):
                return          # failure-requeue replay of a streamed prefix
            self.tokens.append(tok)
            self._cond.notify_all()
        for cb in self._callbacks:
            cb(tok)

    def _restart(self) -> None:
        """Failure re-queue under stochastic sampling: the re-decode
        resamples, so the streamed prefix is void — token callbacks fire
        again from index 0 for the new attempt."""
        with self._cond:
            self.tokens = []

    def _complete(self, c: Completion) -> None:
        with self._cond:
            self.completion = c
            self._cond.notify_all()
        self._done_evt.set()


class Engine:
    """Policy-based serving engine over one model on one device.

    ``model`` is the port's ``Transformer`` (``repro_torch.weights.
    from_jax_params`` or ``models.transformer.init_params``), already on
    ``device``. ``submit()`` / ``step()`` / ``run()`` is the caller-pumped
    lifecycle API; ``generate()`` submits everything and drains. With a
    continuous admission policy requests flow through the
    ``ContinuousScheduler``; with ``admission="batch"`` the engine runs
    the static-bucket executor: same facade, same handles, same
    ``finish_reason``.

    ``start()`` switches the engine to background-drained mode: a drain
    thread (the only thread that runs the model) pumps the scheduler
    whenever work exists, ``submit()`` / ``cancel()`` become thread-safe
    and stamp wall-clock arrival instants, and handles wait on condition
    variables instead of stepping. ``asubmit()`` / ``astream()`` wrap the
    same surface for asyncio callers. ``shutdown()`` (or leaving the
    engine's ``with`` block) stops the thread."""

    def __init__(self, cfg: ModelConfig, model: T.Transformer,
                 config: Optional[EngineConfig] = None, *,
                 failures: Optional[List[SlotFailure]] = None,
                 device="cuda"):
        self.device = T.resolve_device(device)
        T.check_servable(cfg)
        if model.device.type != self.device.type or (
                self.device.index is not None
                and model.device != self.device):
            raise ValueError(f"model lives on {model.device}, the engine "
                             f"runs on {self.device}")
        self.cfg = cfg
        self.model = model
        self.config = c = config or EngineConfig()
        if c.kv_layout not in KV_LAYOUTS:
            raise ValueError(f"kv_layout {c.kv_layout!r} not in {KV_LAYOUTS}")
        if c.prefix_cache and c.kv_layout != "paged":
            raise ValueError(
                "prefix_cache shares paged KV blocks between requests; "
                "it needs kv_layout='paged'")
        if (c.victim_cache or c.prefix_cache_tenants) and not c.prefix_cache:
            raise ValueError(
                "victim_cache / prefix_cache_tenants extend the prefix "
                "cache; they need prefix_cache=True")
        self.admission = make_admission(c.admission)
        self.preemption = make_preemption(c.preemption)
        self.batch_mode = isinstance(self.admission, BatchAdmission)
        self.max_len = c.max_len
        # one lock serializes submit/cancel/step against the drain
        # thread; re-entrant so a cancel() fired from inside a token
        # callback (already under the lock, inside a step) doesn't
        # deadlock. Lock order is engine._lock -> handle._cond, never
        # the inverse: handles wait on _cond without the engine lock.
        self._lock = threading.RLock()
        # anti-convoy turnstile: the drain loop releases _lock between
        # steps but takes it again at once, and a submit or snapshot
        # caller can lose that race for a whole backlog. Callers enter
        # through _gate; the drain loop passes through it once per
        # iteration, so a waiter holding _gate gets the very next
        # critical section: its worst-case wait is one scheduler step.
        self._gate = threading.Lock()
        # lock-free submission handoff: while the background drain runs,
        # submit() appends here (deque ops are atomic) and the drain
        # ingests at its next step boundary, so submit never waits out a
        # step (an admission burst of prefills can be long)
        self._inbox: "collections.deque" = collections.deque()
        self._drain_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._work = threading.Event()      # set on submit, wakes the drain
        # the registry/tracer pair always exists (so /metrics renders for
        # every policy); the scheduler only records into it when the
        # knob is on: counters are mirrored from stats() at snapshot
        # time either way, histograms and spans need enabled=True
        self.obs = Observability(enabled=c.observability)
        if self.batch_mode:
            if c.kv_layout != "slotted" or c.prefill_chunk:
                raise ValueError(
                    "batch admission runs the static-bucket executor; the "
                    "paged KV layout / chunked prefill need a continuous "
                    "admission policy (fifo | priority | edf)")
            if failures:
                raise ValueError(
                    "SlotFailure injection needs the continuous scheduler "
                    "(the static-bucket executor has no decode slots)")
            if c.enforce_deadlines:
                raise ValueError(
                    "enforce_deadlines sheds on a wall clock the "
                    "static-bucket executor doesn't run; it needs a "
                    "continuous admission policy (fifo | priority | edf)")
            if c.units != 1 or c.prefill_units or c.decode_stages != 1:
                raise ValueError(
                    "the multi-unit execution core charges the continuous "
                    "scheduler's steps; batch admission runs closed "
                    "buckets — use a continuous admission policy "
                    "(fifo | priority | edf)")
            self.scheduler = None
            self.sampler = Sampler(greedy=c.greedy, temperature=c.temperature,
                                   seed=c.seed, device=model.device)
            self._pending: List[RequestHandle] = []
        else:
            self.scheduler = ContinuousScheduler(
                cfg, model, SchedulerConfig(
                    max_slots=c.max_slots, max_len=c.max_len, greedy=c.greedy,
                    temperature=c.temperature, seed=c.seed,
                    paged=c.kv_layout == "paged", block_size=c.block_size,
                    num_blocks=c.num_blocks, watermark=c.watermark,
                    prefill_chunk=c.prefill_chunk,
                    prefix_cache=c.prefix_cache,
                    victim_cache=c.victim_cache,
                    victim_eviction=c.victim_eviction,
                    prefix_cache_tenants=c.prefix_cache_tenants,
                    enforce_deadlines=c.enforce_deadlines,
                    units=c.units, prefill_units=c.prefill_units,
                    decode_stages=c.decode_stages, placement=c.placement,
                    step_delay_s=c.step_delay_s, debug=c.debug),
                failures=failures, admission=self.admission,
                preemption=self.preemption,
                obs=self.obs if c.observability else None)
            self.sampler = self.scheduler.sampler

    # -- background drain ---------------------------------------------------

    @property
    def running(self) -> bool:
        """True while the background drain thread is alive."""
        t = self._drain_thread
        return t is not None and t.is_alive()

    def start(self) -> "Engine":
        """Spawn the background drain thread (continuous policies only).
        After this, callers never pump: ``submit()`` wakes the drain,
        handles wait for their tokens. Idempotent; returns self so
        ``with Engine(...).start() as eng:`` reads naturally."""
        if self.batch_mode:
            raise ValueError(
                "background draining steps the continuous scheduler; batch "
                "admission runs closed buckets — call run() instead")
        if self.running:
            return self
        self._stop.clear()
        self._drain_thread = threading.Thread(
            target=self._drain_loop, name="engine-drain", daemon=True)
        self._drain_thread.start()
        return self

    def shutdown(self, wait: bool = True) -> None:
        """Stop the drain thread. In-flight requests stay resident in
        the scheduler and resume on the next ``start()`` / ``run()``;
        ``wait=True`` joins the thread before returning."""
        self._stop.set()
        self._work.set()                    # unblock an idle drain loop
        t = self._drain_thread
        if wait and t is not None and t is not threading.current_thread():
            t.join()
        self._drain_thread = None

    def __enter__(self) -> "Engine":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    @contextmanager
    def _entry_lock(self):
        """Take the engine lock fairly: non-drain threads pass through
        the turnstile first, so the drain loop cannot starve them (see
        ``_gate``). The drain thread itself skips the gate — a cancel()
        or submit() fired from inside a token callback already holds
        ``_lock`` re-entrantly, and parking it on the gate while a
        caller waits for ``_lock`` would deadlock both."""
        if threading.current_thread() is self._drain_thread:
            with self._lock:
                yield
            return
        with self._gate:
            with self._lock:
                yield

    def _ingest_inbox(self) -> None:
        """Move handed-off submissions into the scheduler (caller holds
        ``_lock``). Stamps wall-clock arrivals from the *submit* instant
        — ingestion lag must not shift a request's arrival time — and
        honours a cancel() that raced the handoff."""
        while self._inbox:
            handle, req, arrival_s, t_sub = self._inbox.popleft()
            s = self.scheduler
            if not arrival_s and s._t0 is not None and not s.done:
                arrival_s = max(0.0, t_sub - s._t0)
            handle._ticket = s.submit(req, arrival_s)
            handle._ticket.handle = handle
            if handle._cancelled:
                s.request_cancel(handle._ticket)

    def _drain_loop(self) -> None:
        while not self._stop.is_set():
            # turnstile pass: if a snapshot/cancel caller is parked in
            # _entry_lock, block here until it has taken (and released)
            # the engine lock — fairness over throughput
            self._gate.acquire()
            self._gate.release()
            with self._lock:
                self._ingest_inbox()
                idle = self.scheduler.done
                if not idle:
                    self._work.clear()
                    self.scheduler.step_once()
            if idle:
                # nothing live: sleep until a submit wakes us (the
                # timeout keeps shutdown() prompt even if the set races)
                self._work.wait(timeout=0.05)
                self._work.clear()

    # -- lifecycle API ------------------------------------------------------

    def submit(self, req: Request, arrival_s: float = 0.0) -> RequestHandle:
        """Register a request (admitted at ``arrival_s`` seconds from
        drain start under continuous policies) and return its handle.
        Thread-safe; while the background drain runs, ``arrival_s=0``
        submissions are stamped with the wall-clock *now* on the
        scheduler's clock, so waiting-time metrics and deadlines measure
        real elapsed time, not time since the server booted."""
        handle = RequestHandle(self, req)
        if self.batch_mode:
            if arrival_s:
                raise ValueError(
                    "batch admission serves closed batches — arrivals need "
                    "a continuous admission policy (fifo | priority | edf)")
            validate_request_fits(self.cfg, req, self.max_len)
            self._pending.append(handle)
            return handle
        if self.running:
            # lock-free handoff: validate here (errors must surface on
            # the caller, not kill the drain thread), then hand the
            # request to the drain loop — submit never waits out a
            # scheduler step (an admission burst of prefills, or a first
            # kernel build, can hold the engine lock for a long time)
            validate_request_fits(self.cfg, req, self.max_len)
            self.scheduler.layout.validate(req)
            self._inbox.append((handle, req, arrival_s, time.perf_counter()))
            self._work.set()
            return handle
        with self._entry_lock():
            self._ingest_inbox()        # shutdown raced an earlier handoff
            handle._ticket = self.scheduler.submit(req, arrival_s)
            handle._ticket.handle = handle
        self._work.set()
        return handle

    def step(self) -> List[Completion]:
        """Advance the engine: one scheduler iteration (continuous), or
        a full drain of the pending buckets (batch admission — buckets
        are closed, there is no smaller step). Returns the completions
        this step produced. Not available while the background drain
        owns the scheduler — wait on handles instead."""
        if self.batch_mode:
            return self._run_static(None)
        if self.running and threading.current_thread() is not self._drain_thread:
            raise RuntimeError(
                "the background drain thread owns the step loop; wait on "
                "RequestHandle.result()/stream() or shutdown() first")
        with self._entry_lock():
            self._ingest_inbox()        # handoffs left by a shutdown()
            if self.scheduler.done:
                return []
            return self.scheduler.step_once()

    def run(self, on_completion: Optional[Callable[[Completion], None]] = None
            ) -> List[Completion]:
        """Drain every submitted request; completions sorted by id.
        ``on_completion`` streams each completion the moment its request
        finishes. Not available while the background drain runs."""
        if self.batch_mode:
            return self._run_static(on_completion)
        if self.running:
            raise RuntimeError(
                "the background drain thread owns the step loop; wait on "
                "RequestHandle.result()/stream() or shutdown() first")
        with self._lock:
            self._ingest_inbox()        # handoffs left by a shutdown()
        return self.scheduler.run(on_completion)

    # -- asyncio surface ----------------------------------------------------

    async def asubmit(self, req: Request) -> RequestHandle:
        """Asyncio submit: runs the (lock-taking, possibly briefly
        contended) submission off the event loop. Requires the
        background drain (``start()``) — an asyncio caller has no way
        to pump a caller-driven engine without blocking the loop."""
        if not self.running:
            raise RuntimeError("asubmit() needs the background drain "
                               "thread — call Engine.start() first")
        return await asyncio.get_running_loop().run_in_executor(
            None, self.submit, req)

    async def astream(self, req: Request) -> AsyncIterator[int]:
        """Submit + stream in one call: yields this request's tokens as
        they are produced, without blocking the event loop."""
        handle = await self.asubmit(req)
        async for tok in handle.astream():
            yield tok

    def generate(self, requests: List[Request], *,
                 arrivals: Optional[List[float]] = None,
                 on_completion: Optional[Callable[[Completion], None]] = None
                 ) -> List[Completion]:
        """Batch convenience: submit ``requests`` (each at its
        ``arrivals`` instant — an open-loop workload) and drain."""
        if arrivals is not None:
            if self.batch_mode:
                raise ValueError(
                    "arrivals require a continuous admission policy — "
                    "batch admission has no admission queue")
            if len(arrivals) != len(requests):
                raise ValueError(
                    f"arrivals has {len(arrivals)} entries for "
                    f"{len(requests)} requests")
        for i, r in enumerate(requests):
            self.submit(r, arrivals[i] if arrivals else 0.0)
        return self.run(on_completion)

    # -- introspection ------------------------------------------------------

    def kv_stats(self) -> Dict[str, float]:
        """Layout KV occupancy. Batch admission has no persistent cache,
        so it reports an empty (but typed) dict rather than raising —
        /status and /metrics must work for every policy."""
        if self.scheduler is None:
            return {}
        return self.scheduler.kv_stats()

    def stats(self) -> Dict[str, int]:
        """Lifecycle event counters. Batch admission reports all-zero
        counters (no continuous scheduler events) rather than raising."""
        if self.scheduler is None:
            return dict.fromkeys(COUNTER_KEYS, 0)
        return self.scheduler.stats()

    def snapshot(self) -> Dict[str, Any]:
        """One consistent view of the engine under its own lock: queue
        depth, active slots, KV occupancy, lifecycle counters, and (when
        observability is on) histogram summaries. The only sanctioned
        way for other threads — the HTTP server above all — to read
        engine state."""
        with self._entry_lock():
            if self.scheduler is None:
                snap: Dict[str, Any] = {
                    "queue_depth": len(self._pending),
                    "active_slots": 0,
                    "kv": {},
                    "counters": dict.fromkeys(COUNTER_KEYS, 0),
                }
            else:
                s = self.scheduler
                snap = {
                    "queue_depth": s._waiting() + len(self._inbox),
                    "active_slots": len(s.active),
                    "kv": s.kv_stats(),
                    "counters": s.stats(),
                    "units": s.unit_stats(),
                }
                if getattr(s.layout, "prefix_cache", False):
                    pc = s.layout.prefix_cache_stats()
                    pc["prefill_tokens_saved"] = s.prefill_tokens_saved
                    pc["bytes_saved"] = (s.prefill_tokens_saved
                                         * T.kv_row_bytes(self.cfg))
                    snap["prefix_cache"] = pc
        snap["observability"] = self.config.observability
        snap["metrics"] = self.obs.snapshot()
        return snap

    # -- prefix-cache persistence (victim cache across restarts) ------------

    def save_prefix_cache(self, path: str) -> int:
        """Serialize the resident prefix index + victim pool to a
        ``runtime.checkpoint`` artifact (see scheduler.prefix_pool for
        the chain format). Returns the number of chains saved."""
        with self._entry_lock():
            return save_victim_cache(path, self._cache_layout(), self.cfg)

    def restore_prefix_cache(self, path: str) -> int:
        """Load a ``save_prefix_cache`` artifact into this engine's
        pool and victim cache (tenants, LRU stamps, hit counts): a
        restarted engine starts warm. Returns blocks restored."""
        with self._entry_lock():
            return restore_victim_cache(path, self._cache_layout(), self.cfg)

    def _cache_layout(self):
        if self.scheduler is None:
            raise ValueError("prefix-cache persistence needs a "
                             "continuous scheduler (admission != 'batch')")
        return self.scheduler.layout

    def metrics_text(self,
                     extra_gauges: Optional[Dict[str, float]] = None) -> str:
        """Prometheus text exposition. Counters are mirrored from the
        scheduler's event log into the registry here (monotone ``sync``,
        so it composes with live increments), gauges are stamped with
        the snapshot values, and whatever histograms the scheduler
        recorded ride along."""
        snap = self.snapshot()
        reg = self.obs.registry
        for k, v in snap["counters"].items():
            name = f"repro_{k}" if k.endswith("_total") else f"repro_{k}_total"
            reg.counter(name, help=f"engine lifecycle counter: {k}").sync(v)
        reg.gauge("repro_queue_depth",
                  help="requests waiting for a slot").set(snap["queue_depth"])
        reg.gauge("repro_active_slots",
                  help="slots decoding right now").set(snap["active_slots"])
        for k, v in snap["kv"].items():
            reg.gauge(f"repro_{k}", help="KV layout stat").set(v)
        for k, v in (extra_gauges or {}).items():
            reg.gauge(k).set(v)
        return reg.render()

    def trace_json(self) -> Dict[str, Any]:
        """Chrome trace-event snapshot (empty but valid when
        observability is off)."""
        return self.obs.tracer.chrome_trace()

    # -- static-bucket executor (BatchAdmission) ----------------------------

    def _run_static(self, on_completion) -> List[Completion]:
        out: List[Completion] = []
        handles, self._pending = self._pending, []
        for h in [h for h in handles if h._cancelled]:
            c = Completion(h.request.id, h.tokens, 0.0, 0.0,
                           finish_reason="cancelled")
            h._complete(c)
            out.append(c)
        live = [h for h in handles if not h._cancelled]
        for _, hs in self.admission.buckets(
                live, prompt_of=lambda h: h.request.prompt):
            out.extend(self._run_bucket(hs))
        if on_completion is not None:
            for c in out:
                on_completion(c)
        return sorted(out, key=lambda c: c.id)

    def _run_bucket(self, handles: List[RequestHandle]) -> List[Completion]:
        """One (batch, prompt_len) prefill, the requests' ``embeds``
        stacked, then greedy decode of the whole bucket to completion,
        with the lifecycle hooks."""
        reqs = [h.request for h in handles]
        b = len(reqs)
        tokens = torch.as_tensor(np.stack([r.prompt for r in reqs]),
                                 dtype=torch.int64, device=self.device)
        embeds = None if reqs[0].embeds is None else torch.as_tensor(
            np.stack([r.embeds for r in reqs]).astype(np.float32),
            device=self.device)
        t0 = time.perf_counter()
        logits, cache, clen = T.prefill(self.model, tokens,
                                        max_len=self.max_len, embeds=embeds)
        toks = self.sampler(logits)
        host = toks.cpu().numpy()           # waits for the device
        t1 = time.perf_counter()
        max_new = max(r.max_new_tokens for r in reqs)
        done = np.zeros(b, bool)
        reasons = ["length"] * b
        for i, t in enumerate(host):
            if handles[i]._cancelled:
                done[i] = True
                reasons[i] = "cancelled"
            else:
                handles[i]._emit(0, int(t))
        for _ in range(max_new - 1):
            if done.all():
                break
            logits, cache, clen = T.decode_step(self.model, toks, cache, clen)
            toks = self.sampler(logits)
            for i, t in enumerate(toks.cpu().numpy()):
                if done[i]:
                    continue
                r = reqs[i]
                if len(handles[i].tokens) >= r.max_new_tokens:
                    done[i] = True
                    continue
                if handles[i]._cancelled:
                    done[i] = True
                    reasons[i] = "cancelled"
                    continue
                if r.eos is not None and t == r.eos:
                    done[i] = True
                    reasons[i] = "eos"
                else:
                    handles[i]._emit(len(handles[i].tokens), int(t))
        t2 = time.perf_counter()
        out = []
        for i, h in enumerate(handles):
            reason = reasons[i]
            if not done[i] and h._cancelled \
                    and len(h.tokens) < reqs[i].max_new_tokens:
                reason = "cancelled"
            c = Completion(reqs[i].id, h.tokens, t1 - t0, t2 - t1,
                           finish_reason=reason)
            h._complete(c)
            out.append(c)
        return out
