"""Continuous-batching core loop: mechanism under pluggable policies.

Counterpart of ``repro.runtime.scheduler.core`` over the slotted and
paged KV layouts:

* the decode loop — one decode step over all ``max_slots`` slots; requests
  join and leave the running batch between steps;
* the waiting set — *which* request is admitted next, *who* is
  preempted under pool pressure and *how* logits become tokens are the
  injected policies' calls;
* admission — one-shot prefill, prefix-resumed prefill on a prefix-cache
  hit, or chunked prefill (one chunk per scheduler step, interleaved
  with decode steps);
* the request lifecycle — per-token streaming to a ``RequestHandle``,
  cancellation, injected ``SlotFailure`` re-queue/terminate, paged
  growth preemption, wall-clock deadline shedding, and a
  ``finish_reason`` on every ``Completion``;
* the execution core (``units.ExecutionCore``): every prompt burst, K/V
  handoff and decode step is also charged to modeled per-unit clocks;
* observability (``obs``, None when off): latency and size histograms,
  per-step phase times, and request, slot and step spans in a Chrome
  trace.

The reference's ``jax.jit`` sites are plain calls here: PyTorch runs
eagerly. Host-side mirrors (``cache_len``, ``tokens``) become tensors on
the model's device once per decode step.
"""
from __future__ import annotations

import heapq
import threading
import time
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.runtime.observability import (SIZE_BUCKETS, TIME_BUCKETS_S,
                                               Observability)
from repro_torch.runtime.policies import (BatchAdmission, EvictLatest,
                                          FifoAdmission, Sampler,
                                          make_admission, make_preemption,
                                          request_due_s)
from repro_torch.runtime.scheduler import prefill as _prefill
from repro_torch.runtime.scheduler.allocator import BlockAllocator
from repro_torch.runtime.scheduler.layouts import PagedLayout, SlottedLayout
from repro_torch.runtime.scheduler.types import (Completion, Request,
                                                 SchedEvent, SchedulerConfig,
                                                 SlotFailure, _ChunkedPrefill,
                                                 _Ticket,
                                                 validate_request_fits)
from repro_torch.runtime.scheduler.units import ExecutionCore

__all__ = ["ContinuousScheduler"]


# one step lock per device, shared by every engine of the process on it
_STEP_LOCKS: Dict[str, threading.RLock] = {}
_STEP_LOCKS_GUARD = threading.Lock()


def device_step_lock(device) -> threading.RLock:
    """The lock that model steps on ``device`` take in this process. A
    step dispatches thousands of small operations from Python, and two
    threads dispatching at once (two engines' drain threads, or a drain
    thread and a tiered engine's confidence probe) hand the interpreter
    lock back and forth at every operation, which on the card made both
    several times slower than taking turns. So the schedulers on one
    device take turns a step's model work at a time; tokens are
    unchanged. It is the innermost lock of a step (taken under the
    engine's own, released before the step's sleep and its completion
    callbacks), so a token callback, which runs under it, must not wait
    on another engine."""
    key = str(torch.device(device))
    with _STEP_LOCKS_GUARD:
        return _STEP_LOCKS.setdefault(key, threading.RLock())


class ContinuousScheduler:
    """Admission queue + shared decode batch over a slotted or paged KV
    cache.

    Policies are injected (``admission``, ``preemption``, ``sampler``) —
    names or instances from ``runtime.policies``; the defaults are FIFO,
    evict-latest and greedy. ``model`` is the port's ``Transformer``;
    the scheduler runs on its device."""

    def __init__(self, cfg: ModelConfig, model: T.Transformer,
                 sched: Optional[SchedulerConfig] = None, *,
                 failures: Optional[List[SlotFailure]] = None,
                 admission: Any = None, preemption: Any = None,
                 sampler: Optional[Sampler] = None,
                 obs: Optional[Observability] = None):
        self.cfg = cfg
        self.model = model
        self.device = model.device
        # held over each step's model work, never over its sleep or its
        # delivery (see device_step_lock)
        self.step_lock = device_step_lock(self.device)
        self.sched = s = sched or SchedulerConfig()
        self.admission = make_admission(admission) if admission is not None \
            else FifoAdmission()
        if isinstance(self.admission, BatchAdmission):
            raise ValueError(
                "batch admission is the Engine's static-bucket path; the "
                "continuous scheduler needs an ordering policy "
                "(fifo | priority | edf)")
        self.preemption = make_preemption(preemption) \
            if preemption is not None else EvictLatest()
        self.sampler = sampler or Sampler(greedy=s.greedy,
                                          temperature=s.temperature,
                                          seed=s.seed, device=self.device)
        # injected slot failures, applied at decode-step boundaries; a
        # cursor keeps run() re-entrant
        self.failures = sorted(failures or [], key=lambda f: f.step)
        self._failure_pos = 0
        # paged mode wants a whole number of blocks per slot
        self.max_len = s.max_len if not s.paged else \
            -(-s.max_len // s.block_size) * s.block_size
        # chunked prefill extends a position-indexed cache: a config
        # outside supports_chunked_prefill (a ring, a recurrent state) is
        # served one-shot, as in the reference
        self._chunk = s.prefill_chunk \
            if T.supports_chunked_prefill(cfg) else 0
        self._scratch_len = -(-self.max_len // self._chunk) * self._chunk \
            if self._chunk else self.max_len
        self._chunking: Optional[_ChunkedPrefill] = None
        layout_cls = PagedLayout if s.paged else SlottedLayout
        self.layout = layout_cls(cfg, s, self.max_len, model)
        # prefix sharing resumes prefill mid-prompt through the extend
        # path
        self._prefix = getattr(self.layout, "prefix_cache", False)
        # prompt tokens admitted vs prompt tokens whose K/V came from a
        # shared prefix
        self.prefill_tokens_total = 0
        self.prefill_tokens_saved = 0
        # host-side slot state; free slots keep cache_len == 0
        self.cache_len = np.zeros((s.max_slots,), np.int32)
        self.tokens = np.zeros((s.max_slots,), np.int32)
        self.free: List[int] = list(range(s.max_slots))[::-1]  # pop() -> 0,1,..
        self.active: Dict[int, _Ticket] = {}
        # waiting set: a heap keyed by the admission policy's key;
        # cancelled entries are retired in place and skipped lazily
        self.queue: List[tuple] = []
        self._queue_stale = 0
        self.backlog: List[_Ticket] = []  # submitted, not yet "arrived"
        self._backlog_pos = 0
        self._backlog_dirty = False
        self._admit_seq = 0
        self._submit_seq = 0
        self.events: List[SchedEvent] = []
        self.step_count = 0
        self._t0: Optional[float] = None
        self._cancel_requests: List[_Ticket] = []
        # deadline enforcement: min-heap of (due_s, submit_seq, ticket)
        # over live deadline-carrying tickets, so the per-boundary shed
        # check costs O(expired log n); finished tickets are skipped
        # lazily at the top
        self._deadline_heap: List[tuple] = []
        self.tokens_generated = 0
        # growth-preemption livelock (``_grow_blocks``): the states seen at
        # growth preemptions since the last completion, and, from the one
        # that repeated until the next completion, the preemption edges
        # (victim -> its growers)
        self._completed = 0
        self._growth_epoch = 0
        self._growth_seen: set = set()
        self._growth_edges: Optional[Dict[_Ticket, set]] = None
        self.cycles_broken = 0
        # observability (None = off: the hot path pays one `is None` test
        # per hook). Trace timestamps run on a construction-epoch clock
        # (`_obs_now`), since `_t0` resets between drains and a track's
        # timestamps must never go backwards; metric durations are
        # differences of scheduler-clock stamps.
        self.obs = obs if (obs is not None and obs.enabled) else None
        if self.obs is not None:
            self._obs_epoch = time.perf_counter()
            self._phase: Dict[str, float] = {}
            r = self.obs.registry
            self._m = {
                "ttft": r.histogram(
                    "repro_ttft_seconds", TIME_BUCKETS_S,
                    help="arrival to first token (admission wait + prefill)"),
                "inter_token": r.histogram(
                    "repro_inter_token_seconds", TIME_BUCKETS_S,
                    help="steady-state gap between consecutive tokens "
                         "of one request"),
                "step": r.histogram(
                    "repro_step_duration_seconds", TIME_BUCKETS_S,
                    help="one scheduler iteration, boundary to boundary"),
                "queue_wait": r.histogram(
                    "repro_queue_wait_seconds", TIME_BUCKETS_S,
                    help="enqueue to admission pop"),
                "chunk": r.histogram(
                    "repro_prefill_chunk_tokens", SIZE_BUCKETS,
                    help="prompt tokens prefilled per admission/chunk step"),
                "blocks": r.histogram(
                    "repro_blocks_in_use", SIZE_BUCKETS,
                    help="paged KV blocks held, sampled each step"),
            }
            for ph in ("admission", "prefill", "decode", "sampling", "kv"):
                self._m["step_" + ph] = r.histogram(
                    f"repro_step_{ph}_seconds", TIME_BUCKETS_S,
                    help=f"per-step time inside the {ph} phase")
        # built after obs, so its per-unit tracks share the tracer
        self.core = ExecutionCore(s, obs=self.obs)

    @property
    def cache(self):
        return self.layout.cache

    @property
    def alloc(self) -> Optional[BlockAllocator]:
        return getattr(self.layout, "alloc", None)

    @property
    def block_tables(self) -> Optional[np.ndarray]:
        return getattr(self.layout, "block_tables", None)

    # -- public API ---------------------------------------------------------

    def submit(self, req: Request, arrival_s: float = 0.0) -> _Ticket:
        """Queue a request for admission at ``arrival_s`` (seconds from
        drain start). Returns the internal ticket."""
        validate_request_fits(self.cfg, req, self.max_len)
        self.layout.validate(req)
        if self.done:
            self._t0 = None         # a fresh drain starts a fresh epoch
        ticket = _Ticket(req=req, arrival_s=arrival_s,
                         submit_seq=self._submit_seq)
        self._submit_seq += 1
        self.backlog.append(ticket)
        self._backlog_dirty = True
        if self.sched.enforce_deadlines and req.deadline_s is not None:
            heapq.heappush(self._deadline_heap,
                           (request_due_s(ticket), ticket.submit_seq, ticket))
        return ticket

    def request_cancel(self, ticket: _Ticket) -> None:
        """Flag a ticket for cancellation; retired at the next boundary."""
        ticket.cancelled = True
        self._cancel_requests.append(ticket)

    @property
    def done(self) -> bool:
        """True when nothing is queued, active, mid-prefill or pending
        arrival."""
        return (self._backlog_pos >= len(self.backlog)
                and self._waiting() == 0
                and not self.active and self._chunking is None)

    # -- waiting-set heap ---------------------------------------------------

    def _waiting(self) -> int:
        return len(self.queue) - self._queue_stale

    def _enqueue(self, ticket: _Ticket) -> None:
        ticket.where = "queued"
        heapq.heappush(self.queue, (self.admission.key(ticket),
                                    ticket.submit_seq, ticket))
        if self.obs is not None:
            # only ever called while stepping, so _t0 is set
            ticket.queued_at_s = time.perf_counter() - self._t0
            self.obs.tracer.async_begin(
                "engine", "queue", f"req {ticket.req.id} queued",
                ticket.req.id, self._obs_now(),
                args={"restarts": ticket.restarts})

    def _queue_head(self) -> Optional[_Ticket]:
        while self.queue and self.queue[0][2].retired:
            heapq.heappop(self.queue)
            self._queue_stale -= 1
        return self.queue[0][2] if self.queue else None

    def run(self, on_completion: Optional[Callable[[Completion], None]] = None
            ) -> List[Completion]:
        """Drain every submitted request; returns completions by id."""
        if self._t0 is None or (self._waiting() == 0 and not self.active
                                and self._chunking is None):
            self._t0 = time.perf_counter()
        self._sort_pending()
        out: List[Completion] = []
        while not self.done:
            out.extend(self.step_once(on_completion))
        return sorted(out, key=lambda c: c.id)

    def step_once(self, on_completion: Optional[
            Callable[[Completion], None]] = None) -> List[Completion]:
        """One scheduler iteration: deliver arrivals, purge cancellations,
        shed expired deadlines, apply due failures, advance the in-flight
        chunked prefill, admit, and (if anything is active) run one
        decode step. Returns the completions this iteration produced."""
        if self.obs is None:
            return self._step_impl(on_completion)
        self._phase = {}
        w0 = time.perf_counter()
        out = self._step_impl(on_completion)
        self._obs_step_done(w0, time.perf_counter())
        return out

    def _step_impl(self, on_completion: Optional[
            Callable[[Completion], None]] = None) -> List[Completion]:
        with self.step_lock:
            done, pause_s = self._step_work()
        if pause_s:
            # an idle step's wait for the next arrival, or the
            # step_delay_s device-speed handicap after a non-idle step
            time.sleep(pause_s)
        return self._deliver(done, on_completion)

    def _step_work(self) -> Tuple[List[Completion], float]:
        """The step's model work: returns its completions and how long
        to sleep before delivering them."""
        if self._t0 is None:
            self._t0 = time.perf_counter()
        if self._backlog_dirty:
            self._sort_pending()
        t0 = self._t0
        done: List[Completion] = []
        now = time.perf_counter() - t0
        while (self._backlog_pos < len(self.backlog)
               and self.backlog[self._backlog_pos].arrival_s <= now):
            self._enqueue(self.backlog[self._backlog_pos])
            self._backlog_pos += 1
        done.extend(self._purge_cancelled(t0))
        done.extend(self._shed_expired(t0))
        if (self._waiting() == 0 and not self.active
                and self._chunking is None):
            if self.obs is not None:
                # an arrival-gap sleep (or a no-op boundary) is not an
                # engine step: keep it out of the step histograms
                self._phase["idle"] = 1.0
            if self._backlog_pos < len(self.backlog):
                # idle until the next arrival; failures due now still apply
                done.extend(self._apply_failures(t0))
                return done, max(
                    0.0, self.backlog[self._backlog_pos].arrival_s - now)
            return done, 0.0
        wa = time.perf_counter()
        done.extend(self._apply_failures(t0))
        _prefill.advance_chunked(self, t0)
        done.extend(self._admit(t0))
        if self.obs is not None:
            # admission machinery: this whole region less the prefill
            # compute the prefill helpers attributed to their own phase
            self._phase["admission"] = (
                time.perf_counter() - wa - self._phase.get("prefill", 0.0))
        if self.active:
            done.extend(self._decode_step(t0))
        if self.sched.debug:
            self._check_invariants()
        return done, self.sched.step_delay_s

    # -- observability hooks (self.obs is not None on every call) -----------

    def _obs_now(self) -> float:
        return time.perf_counter() - self._obs_epoch

    def _obs_step_done(self, w0: float, w1: float) -> None:
        ph = self._phase
        if "idle" in ph:
            return
        m = self._m
        m["step"].observe(w1 - w0)
        for k in ("admission", "prefill", "decode", "sampling", "kv"):
            if k in ph:
                m["step_" + k].observe(ph[k])
        alloc = self.alloc
        if alloc is not None:
            m["blocks"].observe(alloc.in_use)
        args = {k: round(v * 1e3, 4) for k, v in ph.items()}
        args.update(active=len(self.active), queued=self._waiting())
        self.obs.tracer.complete(
            "engine", "steps", f"step {self.step_count}",
            w0 - self._obs_epoch, w1 - w0, args=args)

    def _obs_dequeue(self, ticket: _Ticket) -> None:
        """Close the request's queued span (admission pop, queue-side
        shed or cancel: every way a ticket leaves the waiting set)."""
        self.obs.tracer.async_end(
            "engine", "queue", ticket.req.id, self._obs_now())

    def _obs_slot_begin(self, ticket: _Ticket, slot: int,
                        matched: int) -> None:
        ts = self._obs_now()
        tr = self.obs.tracer
        tr.begin("engine", f"slot {slot}", f"req {ticket.req.id}", ts,
                 args={"prompt_tokens": len(ticket.req.prompt),
                       "restarts": ticket.restarts})
        if matched:
            tr.instant("engine", f"slot {slot}", "prefix-hit", ts,
                       args={"request": ticket.req.id,
                             "matched_rows": matched})

    def _obs_prefill(self, slot: int, name: str, tp: float, dt: float,
                     tokens: int) -> None:
        """Attribute one prefill compute burst: phase accounting, the
        chunk-size histogram, and a span nested in the slot track.
        ``tp`` is the raw perf_counter() start stamp."""
        self._phase["prefill"] = self._phase.get("prefill", 0.0) + dt
        self._m["chunk"].observe(tokens)
        self.obs.tracer.complete("engine", f"slot {slot}", name,
                                 tp - self._obs_epoch, dt,
                                 args={"tokens": tokens})

    def kv_stats(self) -> Dict[str, float]:
        return self.layout.kv_stats(self.sched, self.cfg)

    def stats(self) -> Dict[str, int]:
        """Lifecycle counters accumulated so far."""
        c, lay = Counter(e.kind for e in self.events), self.layout
        return {"requests_submitted": self._submit_seq,
                "admissions": c["admit"], "evictions": c["evict"],
                "preemptions": c["preempt"], "slot_failures": c["fail"],
                "cancellations": c["cancel"], "sheds": c["shed"],
                "steps": self.step_count,
                "tokens_generated": self.tokens_generated,
                "prefix_hits": getattr(lay, "prefix_hits", 0),
                "victim_hits": getattr(lay, "victim_hits", 0),
                "victim_evictions": getattr(lay, "victim_evictions", 0),
                "prefill_tokens_total": self.prefill_tokens_total,
                "prefill_tokens_saved": self.prefill_tokens_saved}

    def unit_stats(self) -> Dict[str, Any]:
        return self.core.summary()

    # -- internals ----------------------------------------------------------

    def _sort_pending(self) -> None:
        pending = sorted(self.backlog[self._backlog_pos:],
                         key=lambda t: t.arrival_s)
        self.backlog[self._backlog_pos:] = pending
        self._backlog_dirty = False

    @staticmethod
    def _deliver(done: List[Completion],
                 on_completion: Optional[Callable[[Completion], None]]
                 ) -> List[Completion]:
        if on_completion is not None:
            for c in done:
                on_completion(c)
        return done

    def _event(self, t_s: float, kind: str, rid: int, slot: int) -> None:
        """Record a lifecycle event; disruptions (preempt, fail, shed,
        cancel) also land as instant markers on the trace track of the
        slot (or the queue, for never-admitted requests)."""
        self.events.append(SchedEvent(t_s, kind, rid, slot, self.step_count))
        if self.obs is not None and kind in ("preempt", "fail",
                                             "shed", "cancel"):
            thread = f"slot {slot}" if slot >= 0 else "queue"
            self.obs.tracer.instant("engine", thread, kind, self._obs_now(),
                                    args={"request": rid})

    def _emit(self, ticket: _Ticket, tok: int) -> None:
        """Append a token and stream it to the handle (which dedups a
        failure re-queue's replayed prefix by index)."""
        ticket.emitted.append(tok)
        self.tokens_generated += 1
        if ticket.handle is not None:
            ticket.handle._emit(len(ticket.emitted) - 1, tok)

    def _finish(self, ticket: _Ticket, reason: str, t0: float) -> Completion:
        now = time.perf_counter() - t0
        decode_s = now - ticket.first_token_s if ticket.first_token_s > 0.0 \
            else 0.0
        c = Completion(
            ticket.req.id, ticket.emitted, ticket.prefill_s, decode_s,
            arrival_s=ticket.arrival_s, first_token_s=ticket.first_token_s,
            finish_s=now, finish_reason=reason, restarts=ticket.restarts)
        ticket.where = "done"
        self._completed += 1
        if ticket.handle is not None:
            ticket.handle._complete(c)
        return c

    def _release_slot(self, slot: int) -> None:
        """Return a slot (and, paged, its blocks, exactly once) to the
        free pool, zeroing every host-side mirror."""
        self.free.append(slot)
        self.cache_len[slot] = 0
        self.tokens[slot] = 0
        self.layout.release(slot)
        self.core.release(slot)
        if self.obs is not None:
            # every occupied slot opened its span at admission; closing
            # here covers every exit path
            self.obs.tracer.end("engine", f"slot {slot}", self._obs_now())

    @staticmethod
    def _reset_ticket(ticket: _Ticket) -> None:
        ticket.slot = -1
        ticket.emitted = []
        ticket.prefill_s = 0.0
        ticket.first_token_s = 0.0
        ticket.admit_seq = -1

    def _purge_cancelled(self, t0: float) -> List[Completion]:
        """Retire every cancelled request at this step boundary."""
        out: List[Completion] = []
        if not self._cancel_requests:
            return out
        requests, self._cancel_requests = self._cancel_requests, []
        for ticket in requests:
            if ticket.where == "done":
                continue
            if ticket.where == "backlog":
                self.backlog.remove(ticket)
                out.append(self._cancel_ticket(ticket, t0))
            elif ticket.where == "queued":
                ticket.retired = True
                self._queue_stale += 1
                if self.obs is not None:
                    self._obs_dequeue(ticket)
                out.append(self._cancel_ticket(ticket, t0))
            elif ticket.where == "active":
                out.append(self._evict(ticket.slot, t0, "cancelled",
                                       kind="cancel"))
            elif ticket.where == "chunking":
                st = self._chunking
                self._chunking = None
                self._release_slot(st.slot)
                out.append(self._cancel_ticket(ticket, t0, slot=st.slot))
        return out

    def _cancel_ticket(self, ticket: _Ticket, t0: float,
                       slot: int = -1) -> Completion:
        """Complete a request that never reached the decode batch."""
        self._event(time.perf_counter() - t0, "cancel", ticket.req.id, slot)
        return self._finish(ticket, "cancelled", t0)

    def _shed_expired(self, t0: float) -> List[Completion]:
        """Deadline enforcement at a step boundary: complete every live
        request whose due instant has passed with
        ``finish_reason="timeout"``. A waiting request is retired in place
        (never prefilled); an active one is evicted before this step's
        decode, so not one token is emitted after the shed; a ticket
        mid-chunked-prefill releases its slot and blocks. The heap is fed
        only with ``enforce_deadlines=True``."""
        out: List[Completion] = []
        if not self._deadline_heap:
            return out
        now = time.perf_counter() - t0
        while self._deadline_heap and self._deadline_heap[0][0] <= now:
            _, _, ticket = heapq.heappop(self._deadline_heap)
            if ticket.where == "done" or ticket.cancelled:
                continue                    # finished or cancelled first
            if ticket.where == "backlog":
                # due <= now implies arrival_s <= now, so the arrival was
                # delivered above; kept for a ticket submitted mid-step
                self.backlog.remove(ticket)
                out.append(self._shed_ticket(ticket, t0))
            elif ticket.where == "queued":
                ticket.retired = True       # lazy heap deletion
                self._queue_stale += 1
                if self.obs is not None:
                    self._obs_dequeue(ticket)
                out.append(self._shed_ticket(ticket, t0))
            elif ticket.where == "active":
                out.append(self._evict(ticket.slot, t0, "timeout",
                                       kind="shed"))
            elif ticket.where == "chunking":
                st = self._chunking
                self._chunking = None
                self._release_slot(st.slot)
                out.append(self._shed_ticket(ticket, t0, slot=st.slot))
        return out

    def _shed_ticket(self, ticket: _Ticket, t0: float,
                     slot: int = -1) -> Completion:
        self._event(time.perf_counter() - t0, "shed", ticket.req.id, slot)
        return self._finish(ticket, "timeout", t0)

    def _requeue_or_fail(self, victims: List[_Ticket],
                         t0: float) -> List[Completion]:
        """Re-queue (restart from the prompt) while the request has
        restart budget, else complete as "failed"."""
        out: List[Completion] = []
        for ticket in sorted(victims, key=lambda t: t.arrival_s):
            mr = ticket.req.max_restarts
            if mr is not None and ticket.restarts >= mr:
                if ticket.handle is not None:
                    ticket.emitted = list(ticket.handle.tokens)
                out.append(self._finish(ticket, "failed", t0))
                continue
            ticket.restarts += 1
            self._reset_ticket(ticket)
            if ticket.handle is not None and not self.sampler.greedy:
                ticket.handle._restart()
            self._enqueue(ticket)
        return out

    def _apply_failures(self, t0: float) -> List[Completion]:
        """Apply injected slot failures due at this step boundary: the
        requests on failed slots are re-queued and re-prefilled."""
        out: List[Completion] = []
        while (self._failure_pos < len(self.failures)
               and self.failures[self._failure_pos].step <= self.step_count):
            f = self.failures[self._failure_pos]
            self._failure_pos += 1
            slots = list(self.active) if f.slots is None \
                else [s for s in f.slots if s in self.active]
            now = time.perf_counter() - t0
            victims = []
            for slot in slots:
                ticket = self.active.pop(slot)
                self._release_slot(slot)
                self._event(now, "fail", ticket.req.id, slot)
                victims.append(ticket)
            st = self._chunking
            if st is not None and (f.slots is None or st.slot in f.slots):
                self._chunking = None
                self._release_slot(st.slot)
                self._event(now, "fail", st.ticket.req.id, st.slot)
                victims.append(st.ticket)
            out.extend(self._requeue_or_fail(victims, t0))
        return out

    def _admit(self, t0: float) -> List[Completion]:
        """Admit waiting requests into free slots, in the admission
        policy's order, until slots or (paged) blocks run out. When the
        policy's next pick cannot be served, admission stops: no head-
        of-line bypass, so the policy order is also the service order."""
        out: List[Completion] = []
        while self.free:
            ticket = self._queue_head()
            if ticket is None:
                break
            if ticket.cancelled:
                heapq.heappop(self.queue)
                if self.obs is not None:
                    self._obs_dequeue(ticket)
                out.append(self._cancel_ticket(ticket, t0))
                continue
            if (self.sched.enforce_deadlines
                    and request_due_s(ticket) <= time.perf_counter() - t0):
                # expired while queued behind this pass's earlier
                # prefills: shed before prefill, not after
                heapq.heappop(self.queue)
                if self.obs is not None:
                    self._obs_dequeue(ticket)
                out.append(self._shed_ticket(ticket, t0))
                continue
            r = ticket.req
            chunked = self._chunk > 0 and r.embeds is None
            if chunked and self._chunking is not None:
                break           # one chunked prefill in flight at a time
            res = self.layout.try_reserve(r)
            if res is None:
                break           # pool exhausted: wait, don't over-commit
            heapq.heappop(self.queue)
            slot = self.free.pop()
            ticket.admit_seq = self._admit_seq
            self._admit_seq += 1
            self.layout.bind(slot, res)
            self.prefill_tokens_total += len(r.prompt)
            matched = getattr(res, "matched_rows", 0)
            if self.obs is not None:
                self._m["queue_wait"].observe(
                    time.perf_counter() - t0 - ticket.queued_at_s)
                self._obs_dequeue(ticket)
                self._obs_slot_begin(ticket, slot, matched)
            if chunked:
                # resume at the last chunk boundary inside the matched
                # region, so every extend step has the chunk's shape
                resume = (matched // self._chunk) * self._chunk
                scratch = T.init_cache(self.cfg, 1, self._scratch_len,
                                       device=self.device)
                if resume:
                    scratch = self.layout.seed_scratch(scratch, res, resume)
                    self.prefill_tokens_saved += resume
                ticket.slot = slot
                ticket.where = "chunking"
                self._chunking = _ChunkedPrefill(
                    ticket=ticket, slot=slot, cache=scratch, pos=resume)
            elif matched:
                _prefill.admit_prefix_resume(self, ticket, slot, res,
                                             matched, t0)
            else:
                _prefill.admit_one_shot(self, ticket, slot, t0)
        return out

    def _activate(self, ticket: _Ticket, slot: int, first: int, clen: int,
                  t0: float) -> None:
        ticket.first_token_s = time.perf_counter() - t0
        ticket.slot = slot
        ticket.where = "active"
        self._emit(ticket, first)
        self.cache_len[slot] = clen
        self.tokens[slot] = first
        self.active[slot] = ticket
        # prefill -> decode handoff: the slot's K/V joins the decode
        # batch in place (same pool blocks, same refcounts)
        self.core.handoff(slot, blocks=len(
            getattr(self.layout, "_slot_blocks", {}).get(slot, ())))
        self._event(ticket.first_token_s, "admit", ticket.req.id, slot)
        if self.obs is not None:
            self._m["ttft"].observe(ticket.first_token_s - ticket.arrival_s)
            ticket.last_emit_s = ticket.first_token_s

    def _finished(self, ticket: _Ticket) -> bool:
        return len(ticket.emitted) >= ticket.req.max_new_tokens

    def _pick_preempt_victim(self, exclude: int) -> Optional[_Ticket]:
        """Ask the preemption policy for a victim among the block
        holders other than ``exclude``; an in-flight chunked prefill
        counts (it holds its prompt blocks)."""
        cands = [tk for s, tk in self.active.items() if s != exclude]
        if self._chunking is not None and self._chunking.slot != exclude:
            cands.append(self._chunking.ticket)
        if not cands:
            return None
        return self.preemption.pick(cands)

    def _growth_state(self, grower: _Ticket) -> Optional[tuple]:
        """What the later choices read, at a growth preemption by
        ``grower``: each live request's place and progress, the holders'
        admission order, the queue's and the free slots' order, the pool
        (``growth_state``). None while input can still change them (an
        arrival, a failure, a cancellation, a deadline, a sampled end of
        sequence) or where the pool's state never repeats."""
        pool = self.layout.growth_state()
        holders = list(self.active.values())
        if self._chunking is not None:
            holders.append(self._chunking.ticket)
        queued = [t for _, _, t in sorted(self.queue, key=lambda e: e[:2])
                  if not t.retired]
        if (pool is None or self._backlog_pos < len(self.backlog)
                or self._failure_pos < len(self.failures)
                or self._cancel_requests or self._deadline_heap
                or (not self.sampler.greedy and any(
                    t.req.eos is not None for t in holders + queued))):
            return None

        def place(t: _Ticket) -> tuple:
            return (t.req.id, t.where, len(t.emitted),
                    t.restarts if t.req.max_restarts is not None else None)
        chunk = self._chunking
        return (grower.req.id, pool, tuple(self.free),
                tuple(self.cache_len.tolist()),
                None if chunk is None else (chunk.slot, chunk.pos),
                tuple((t.slot,) + place(t)
                      for t in sorted(holders, key=lambda t: t.admit_seq)),
                tuple(map(place, queued)))

    def _breaking_cycle(self, grower: _Ticket) -> bool:
        """True from the growth preemption whose state (``_growth_state``)
        was seen before since the last completion, until the next one."""
        if self._growth_epoch != self._completed:
            self._growth_epoch = self._completed
            self._growth_seen.clear()
            self._growth_edges = None
        if self._growth_edges is None:
            state = self._growth_state(grower)
            if state in self._growth_seen:
                self._growth_edges = {}
                self.cycles_broken += 1
            elif state is not None:
                self._growth_seen.add(state)
        return self._growth_edges is not None

    def _preempted_through(self, ticket: _Ticket) -> set:
        """The requests from which a chain of the recorded growth
        preemptions leads to ``ticket``."""
        seen: set = set()
        todo = [ticket]
        while todo:
            for t in self._growth_edges.get(todo.pop(), ()):
                if t not in seen:
                    seen.add(t)
                    todo.append(t)
        return seen

    def _preempt(self, slot: int, t0: float) -> Optional[Completion]:
        """Evict and re-queue to reclaim blocks for another request's
        decode growth: the victim restarts from its prompt (greedy decode
        makes the re-run identical), or completes as "failed" once its
        restart budget is spent (the returned Completion)."""
        if self._chunking is not None and self._chunking.slot == slot:
            ticket = self._chunking.ticket
            self._chunking = None
        else:
            ticket = self.active.pop(slot)
        self._release_slot(slot)
        self._event(time.perf_counter() - t0, "preempt", ticket.req.id, slot)
        out = self._requeue_or_fail([ticket], t0)
        return out[0] if out else None

    def _grow_blocks(self, t0: float) -> List[Completion]:
        """Paged decode growth: before a decode step, every active slot
        whose next K/V write falls in an unallocated (or shared) page
        gets a block; when the pool runs dry the preemption policy picks
        a victim among the other holders to evict and re-queue.

        The reference's choice can cycle: two requests re-admitted in
        turn evict each other without end, and the reference keeps that
        livelock (``src/repro/runtime/scheduler/core.py:795-802``). The
        port makes the reference's choices until a growth preemption
        meets a state seen since the last completion (``_growth_state``):
        with no input to come the run is deterministic, so from there it
        would repeat forever. From that preemption until the next
        completion a grower preempts itself where a chain of the growth
        preemptions made since leads from its victim to it. Why a
        completion then comes: the chains stay acyclic and only grow, so
        they settle; take a request restarted without end with no such
        request above it: its preemptor, or the victim that made it
        preempt itself, is restarted a finite number of times, so it is
        then held without a break and finishes. ``validate`` lets a lone
        request grow to its worst case.
        """
        out: List[Completion] = []
        if not self.layout.paged:
            return out
        for slot in sorted(self.active,
                           key=lambda s: self.active[s].admit_seq):
            if slot not in self.active:     # preempted earlier this pass
                continue
            pos = int(self.cache_len[slot])
            if not self.layout.needs_block(slot, pos):
                continue
            grower = self.active[slot]
            while not self.layout.grow_one(slot, pos):
                victim = self._pick_preempt_victim(exclude=slot)
                if victim is None:
                    raise RuntimeError(
                        f"paged KV pool exhausted growing slot {slot} with "
                        f"no other active request to preempt")
                if self._breaking_cycle(grower):
                    if victim in self._preempted_through(grower):
                        victim = grower
                    else:
                        self._growth_edges.setdefault(victim, set()).add(
                            grower)
                c = self._preempt(victim.slot, t0)
                if c is not None:
                    out.append(c)
                if victim is grower:
                    break
        return out

    def _decode_step(self, t0: float) -> List[Completion]:
        done: List[Completion] = []
        # requests satisfied by the prefill token alone never decode
        for slot in [s for s, tk in self.active.items() if self._finished(tk)]:
            done.append(self._evict(slot, t0, "length"))
        if not self.active:
            return done
        obs = self.obs
        wk = time.perf_counter()
        done.extend(self._grow_blocks(t0))
        if obs is not None:
            wd = time.perf_counter()
            self._phase["kv"] = self._phase.get("kv", 0.0) + (wd - wk)
        logits = self.layout.decode(
            torch.as_tensor(self.tokens, device=self.device),
            torch.as_tensor(self.cache_len, device=self.device))
        if obs is not None:
            # wait for the device, so that decode and sampling are timed
            # apart; the values are untouched
            if logits.is_cuda:
                torch.cuda.synchronize(logits.device)
            ws = time.perf_counter()
            self._phase["decode"] = self._phase.get("decode", 0.0) + (ws - wd)
        toks = self.sampler(logits).cpu().numpy()
        if obs is not None:
            now_s = time.perf_counter()
            self._phase["sampling"] = \
                self._phase.get("sampling", 0.0) + (now_s - ws)
            now_s -= t0
        self.step_count += 1
        self.core.decode_step(sorted(self.active))
        for slot in self.active:     # free slots keep cache_len == 0
            self.cache_len[slot] += 1
        for slot, ticket in list(self.active.items()):
            if ticket.cancelled:
                done.append(self._evict(slot, t0, "cancelled",
                                        kind="cancel"))
                continue
            t = int(toks[slot])
            if ticket.req.eos is not None and t == ticket.req.eos:
                done.append(self._evict(slot, t0, "eos"))
                continue
            self._emit(ticket, t)
            if obs is not None:
                self._m["inter_token"].observe(now_s - ticket.last_emit_s)
                ticket.last_emit_s = now_s
            self.tokens[slot] = t
            if self._finished(ticket):
                done.append(self._evict(slot, t0, "length"))
        return done

    def _evict(self, slot: int, t0: float, reason: str,
               kind: str = "evict") -> Completion:
        ticket = self.active.pop(slot)
        self._release_slot(slot)
        self._event(time.perf_counter() - t0, kind, ticket.req.id, slot)
        return self._finish(ticket, reason, t0)

    def _check_invariants(self) -> None:
        """Step-boundary slot and block accounting
        (``SchedulerConfig(debug=True)``): a free slot has no residual
        length, token or table, and the layout's books balance."""
        free = set(self.free)
        occupied = set(self.active)
        if self._chunking is not None:
            occupied.add(self._chunking.slot)
        if free & occupied:
            raise AssertionError(f"slots both free and occupied: "
                                 f"{free & occupied}")
        for slot in free:
            if self.cache_len[slot] or self.tokens[slot]:
                raise AssertionError(f"slot {slot}: stale length/token")
        self.layout.check(occupied, self.sched.max_slots)
