"""Unified serving facade of the port: one ``Engine``, policy-configured.

Counterpart of ``repro.runtime.engine`` with its ``EngineConfig`` (less
the knobs of features this slice has not ported) and its caller-pumped
surface — ``submit`` / ``step`` /
``run`` / ``generate`` / ``stats`` / ``kv_stats`` and a
``RequestHandle`` per request. ``admission`` picks the policy:
``"fifo"`` | ``"priority"`` | ``"edf"`` stream through the continuous
scheduler; ``"batch"`` runs the static-bucket executor (closed batches
grouped by prompt length), the oracle every other policy's greedy
tokens must equal. Under a continuous policy:

* ``kv_layout`` — ``"slotted"`` (dense per-slot rows) | ``"paged"``
  (a shared block pool of ``num_blocks`` blocks of ``block_size`` rows,
  an admission ``watermark``, and growth preemption whose victims the
  ``preemption`` policy picks);
* ``prefix_cache`` (paged only) — admissions share the resident blocks
  of a common prompt prefix copy-on-write and prefill only the rest;
* ``prefill_chunk`` — prompts are prefilled that many tokens per
  scheduler step, interleaved with decode steps.

The engine runs on ``device`` (default ``"cuda"``); there prefill (and
its chunked or prefix-resumed extension) runs the port's flash kernel
and decode runs the slotted or the paged decode kernel. It raises
without a card unless the caller passes ``device="cpu"``.

This slice leaves out, each refused by ``EngineConfig`` with the
ROADMAP item that brings it: the victim cache and tenant byte quotas,
deadline enforcement, the stage-partitioned decode step, observability
— and, with no ``start()``, the background drain thread and its asyncio
wrappers.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.runtime.policies import (BatchAdmission, Sampler,
                                          make_admission, make_preemption)
from repro_torch.runtime.scheduler import (COUNTER_KEYS, Completion,
                                           ContinuousScheduler, Request,
                                           SchedulerConfig, SlotFailure,
                                           validate_request_fits)

__all__ = ["Engine", "EngineConfig", "RequestHandle"]

KV_LAYOUTS = ("slotted", "paged")

# (field, value the slice runs, what brings the rest)
_LATER = (
    ("victim_cache", False, "the victim cache (ROADMAP queue 1, item 6b)"),
    ("prefix_cache_tenants", None,
     "tenant byte quotas (ROADMAP queue 1, item 6b)"),
    ("enforce_deadlines", False,
     "deadline shedding (ROADMAP queue 1, item 8)"),
    ("decode_stages", 1,
     "the stage-partitioned decode step (ROADMAP queue 1, item 7)"),
    ("observability", False,
     "metrics and tracing (ROADMAP queue 1, item 8)"),
)


@dataclass
class EngineConfig:
    """Structured engine configuration: the reference's fields that this
    slice runs, plus the feature switches of later slices, which must
    keep their defaults. Victim eviction order and ``step_delay_s``
    come with the slices that use them."""

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
    victim_cache: bool = False
    prefix_cache_tenants: Optional[Dict[str, int]] = None
    admission: Any = "fifo"     # "fifo" | "priority" | "edf" | "batch"
    # who loses their blocks under paged pool pressure
    preemption: Any = "evict-latest"    # | "lowest-priority"
    enforce_deadlines: bool = False
    units: int = 1
    prefill_units: int = 0
    decode_stages: int = 1
    placement: Any = "round-robin"      # | "least-loaded"
    greedy: bool = True
    temperature: float = 1.0
    seed: int = 0
    debug: bool = False
    observability: bool = False

    def __post_init__(self):
        for name, runs, later in _LATER:
            if getattr(self, name) != runs:
                raise ValueError(
                    f"EngineConfig.{name}={getattr(self, name)!r}: the "
                    f"PyTorch port runs {name}={runs!r} so far; {later} "
                    f"comes with a later slice")


class RequestHandle:
    """The caller's end of one submitted request: ``tokens`` streamed so
    far, ``on_token(cb)``, ``stream()``, ``cancel()`` and ``result()``.
    The engine is caller-pumped: ``stream()`` and ``result()`` step it."""

    def __init__(self, engine: "Engine", request: Request):
        self.request = request
        self.tokens: List[int] = []
        self.completion: Optional[Completion] = None
        self._engine = engine
        self._callbacks: List[Callable[[int], None]] = []
        self._cancelled = False
        self._ticket = None         # continuous path only

    @property
    def done(self) -> bool:
        return self.completion is not None

    @property
    def finish_reason(self) -> Optional[str]:
        return self.completion.finish_reason if self.completion else None

    def cancel(self) -> None:
        """After this returns, not one more token is emitted."""
        if self.completion is not None:
            return
        self._cancelled = True
        if self._ticket is not None:
            self._engine.scheduler.request_cancel(self._ticket)

    def on_token(self, cb: Callable[[int], None]) -> Callable[[int], None]:
        self._callbacks.append(cb)
        return cb

    def stream(self) -> Iterator[int]:
        """Yield tokens as the engine produces them, stepping it."""
        i = 0
        while True:
            if len(self.tokens) <= i and self.completion is None:
                self._engine.step()
            while i < len(self.tokens):
                yield self.tokens[i]
                i += 1
            if self.completion is not None and i >= len(self.tokens):
                return

    def result(self) -> Completion:
        """Step the engine until this request completes."""
        while self.completion is None:
            self._engine.step()
        return self.completion

    # -- engine-side hooks --------------------------------------------------

    def _emit(self, index: int, tok: int) -> None:
        if index < len(self.tokens):
            return          # failure-requeue replay of a streamed prefix
        self.tokens.append(tok)
        for cb in self._callbacks:
            cb(tok)

    def _restart(self) -> None:
        self.tokens = []

    def _complete(self, c: Completion) -> None:
        self.completion = c


class Engine:
    """Policy-based serving engine over one model on one device.

    ``model`` is the port's ``Transformer`` (``repro_torch.weights.
    from_jax_params`` or ``models.transformer.init_params``), already on
    ``device``."""

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
        self.admission = make_admission(c.admission)
        self.preemption = make_preemption(c.preemption)
        self.batch_mode = isinstance(self.admission, BatchAdmission)
        self.max_len = c.max_len
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
            if c.units != 1 or c.prefill_units:
                raise ValueError(
                    "the multi-unit execution core charges the continuous "
                    "scheduler's steps; use a continuous admission policy "
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
                    prefix_cache=c.prefix_cache, units=c.units,
                    prefill_units=c.prefill_units,
                    decode_stages=c.decode_stages, placement=c.placement,
                    debug=c.debug),
                failures=failures, admission=self.admission,
                preemption=self.preemption)
            self.sampler = self.scheduler.sampler

    # -- lifecycle API ------------------------------------------------------

    def submit(self, req: Request, arrival_s: float = 0.0) -> RequestHandle:
        """Register a request (admitted at ``arrival_s`` seconds from
        drain start under continuous policies) and return its handle."""
        handle = RequestHandle(self, req)
        if self.batch_mode:
            if arrival_s:
                raise ValueError(
                    "batch admission serves closed batches — arrivals need "
                    "a continuous admission policy (fifo | priority | edf)")
            validate_request_fits(self.cfg, req, self.max_len)
            self._pending.append(handle)
            return handle
        handle._ticket = self.scheduler.submit(req, arrival_s)
        handle._ticket.handle = handle
        return handle

    def step(self) -> List[Completion]:
        """One scheduler iteration (continuous), or a full drain of the
        pending buckets (batch admission)."""
        if self.batch_mode:
            return self._run_static(None)
        if self.scheduler.done:
            return []
        return self.scheduler.step_once()

    def run(self, on_completion: Optional[Callable[[Completion], None]] = None
            ) -> List[Completion]:
        """Drain every submitted request; completions sorted by id."""
        if self.batch_mode:
            return self._run_static(on_completion)
        return self.scheduler.run(on_completion)

    def generate(self, requests: List[Request], *,
                 arrivals: Optional[List[float]] = None,
                 on_completion: Optional[Callable[[Completion], None]] = None
                 ) -> List[Completion]:
        """Submit ``requests`` (each at its ``arrivals`` instant) and
        drain."""
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
        if self.scheduler is None:
            return {}
        return self.scheduler.kv_stats()

    def stats(self) -> Dict[str, int]:
        if self.scheduler is None:
            return dict.fromkeys(COUNTER_KEYS, 0)
        return self.scheduler.stats()

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
        """One (batch, prompt_len) prefill, then greedy decode of the
        whole bucket to completion, with the lifecycle hooks."""
        reqs = [h.request for h in handles]
        b = len(reqs)
        tokens = torch.as_tensor(np.stack([r.prompt for r in reqs]),
                                 dtype=torch.int64, device=self.device)
        t0 = time.perf_counter()
        logits, cache, clen = T.prefill(self.model, tokens,
                                        max_len=self.max_len)
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
