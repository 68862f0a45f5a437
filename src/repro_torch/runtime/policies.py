"""Serving policies of the port: admission order, preemption victims,
unit placement, victim-cache eviction, escalation, sampling.

Counterpart of ``repro.runtime.policies``. The admission, preemption,
placement, victim-eviction and escalation classes are framework-neutral
and copied as they are; the sampler draws from a ``torch.Generator``
instead of a JAX key. Greedy sampling never touches the generator, so
greedy tokens agree with the reference; temperature sampling cannot
replay JAX's PRNG stream and is held to the reference by its
distribution.
"""
from __future__ import annotations

import math
from typing import Any, List, Optional, Sequence, Tuple

import torch


def sample_tokens(gen: torch.Generator, logits: torch.Tensor, *,
                  greedy: bool, temperature: float) -> torch.Tensor:
    """Shared sampling rule for every engine path: (B, V) logits ->
    (B,) int32 tokens. Greedy ties take the first index, as
    ``jnp.argmax`` does."""
    if greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)


class Sampler:
    """Owns the random state for one engine: a ``torch.Generator`` on the
    engine's device, seeded with ``seed``."""

    def __init__(self, *, greedy: bool = True, temperature: float = 1.0,
                 seed: int = 0, device):
        self.greedy = greedy
        self.temperature = temperature
        self.gen = torch.Generator(device=device).manual_seed(seed)

    def __call__(self, logits: torch.Tensor) -> torch.Tensor:
        return sample_tokens(self.gen, logits, greedy=self.greedy,
                             temperature=self.temperature)


# ---------------------------------------------------------------------------
# admission policies
# ---------------------------------------------------------------------------
# A ticket (scheduler._Ticket, or any duck-typed record in unit tests)
# exposes: .req (with .priority / .deadline_s), .arrival_s, .submit_seq.


def request_due_s(ticket) -> float:
    """Absolute due instant of a ticket on the engine clock:
    ``arrival_s + Request.deadline_s``, or +inf without a deadline."""
    d = ticket.req.deadline_s
    return ticket.arrival_s + d if d is not None else math.inf


class FifoAdmission:
    """Arrival order; ties break by submission order."""

    name = "fifo"

    def key(self, ticket) -> tuple:
        return (ticket.arrival_s, ticket.submit_seq)


class PriorityAdmission:
    """Highest ``Request.priority`` first; FIFO within a level."""

    name = "priority"

    def key(self, ticket) -> tuple:
        return (-ticket.req.priority, ticket.arrival_s, ticket.submit_seq)


class DeadlineAdmission:
    """Earliest deadline first; requests without one sort last."""

    name = "edf"

    def key(self, ticket) -> tuple:
        return (request_due_s(ticket), ticket.arrival_s, ticket.submit_seq)


class BatchAdmission:
    """The static-bucket mode as a policy: closed batches bucketed by
    prompt length, each decoded to completion before the next."""

    name = "batch"

    def buckets(self, items: Sequence[Any],
                prompt_of=lambda r: r.prompt) -> List[Tuple[int, List[Any]]]:
        """Group ``items`` by prompt length, shortest bucket first."""
        by_len: dict = {}
        for it in items:
            by_len.setdefault(len(prompt_of(it)), []).append(it)
        return sorted(by_len.items())


# ---------------------------------------------------------------------------
# preemption policies (candidates: tickets holding KV; .pick -> victim)
# ---------------------------------------------------------------------------

class EvictLatest:
    """Preempt the latest-admitted request."""

    name = "evict-latest"

    def pick(self, candidates: List[Any]):
        return max(candidates, key=lambda t: t.admit_seq)


class LowestPriority:
    """Preempt the lowest-priority holder; among equals the latest."""

    name = "lowest-priority"

    def pick(self, candidates: List[Any]):
        return min(candidates, key=lambda t: (t.req.priority, -t.admit_seq))


# ---------------------------------------------------------------------------
# unit-placement policies (candidates expose .name and .busy_s)
# ---------------------------------------------------------------------------

class RoundRobinPlacement:
    """Cycle through the prefill units in order."""

    name = "round-robin"

    def __init__(self) -> None:
        self._next = 0

    def pick(self, executors: List[Any]):
        ex = executors[self._next % len(executors)]
        self._next += 1
        return ex


class LeastLoadedPlacement:
    """The prefill unit with the least modeled busy time so far."""

    name = "least-loaded"

    def pick(self, executors: List[Any]):
        return min(executors, key=lambda ex: ex.busy_s)


# ---------------------------------------------------------------------------
# victim-cache eviction: which reclaimable prefix block goes first
# ---------------------------------------------------------------------------
#
# The victim pool (scheduler/prefix_pool.VictimCache) sorts its blocks by
# ``policy.key(view)`` ascending and evicts from the front. ``view`` is an
# EvictionView: per-block re-match count (``hits``, persistent across
# revive/re-admit cycles), admission stamp (``stamp``, one per released
# chain), page depth within the chain (``page``) and owning ``tenant``.


class LruEviction:
    """Least recently admitted chain first; within a chain, deepest page
    first, so the chain head survives longest."""
    name = "lru"

    def key(self, view) -> Any:
        return (view.stamp, -view.page)


class WeightedLruEviction:
    """Recency weighted by proven reuse: a never-re-matched chain evicts
    before a matched one whatever its age (hits first), then LRU stamp,
    then deepest page first."""
    name = "weighted-lru"

    def key(self, view) -> Any:
        return (view.hits, view.stamp, -view.page)


# ---------------------------------------------------------------------------
# escalation policies
# ---------------------------------------------------------------------------
# Whether a request submitted to a TieredEngine (runtime.escalation) is
# answered by the local engine or escalated to the server tier. Policies
# receive an EscalationContext-shaped record exposing:
#   .req            the Request (priority / deadline_s / max_new_tokens)
#   .snapshot       lazy local-load view: queue_depth, active_slots and
#                   best-effort kv occupancy, read lock-free
#   .now_s          seconds on the tiered engine's clock
#   .confidence()   lazy local-model confidence in [0, 1]: the max
#                   softmax probability of the local model's next-token
#                   prediction, computed at most once per request and
#                   only if some policy asks.
# ``decide(ctx)`` returns a short reason string to escalate, or None to
# answer locally. The TieredEngine ORs its policy list: the first
# non-None reason wins and is recorded on the handle and in the trace.


class NeverEscalate:
    """Local-only: the endpoint answers everything itself (the paper's
    endpoint-alone baseline; no request ever leaves the device)."""

    name = "never"

    def decide(self, ctx) -> Optional[str]:
        return None


class AlwaysEscalate:
    """Server-only: every request escalates (the always-offload
    baseline)."""

    name = "always"

    def decide(self, ctx) -> Optional[str]:
        return "always"


class ConfidenceEscalation:
    """Escalate the requests the local model is unsure about (next-token
    max softmax probability below ``threshold``); confident requests are
    answered on the device."""

    name = "confidence"

    def __init__(self, threshold: float = 0.35):
        self.threshold = threshold

    def decide(self, ctx) -> Optional[str]:
        if ctx.confidence() < self.threshold:
            return "low_confidence"
        return None


class DeadlineRiskEscalation:
    """Escalate when the local tier probably cannot meet the request's
    deadline: estimated local completion time (queue ahead + own decode,
    at ``sec_per_token`` a token) times ``safety`` exceeds the deadline.
    Deadline-free requests never trip this policy."""

    name = "deadline-risk"

    def __init__(self, sec_per_token: float = 5e-3, safety: float = 1.5):
        self.sec_per_token = sec_per_token
        self.safety = safety

    def estimate_local_s(self, ctx) -> float:
        """Every queued request is assumed as long as this one."""
        waiting = ctx.snapshot.get("queue_depth", 0) + 1
        return waiting * ctx.req.max_new_tokens * self.sec_per_token

    def decide(self, ctx) -> Optional[str]:
        if ctx.req.deadline_s is None:
            return None
        if self.estimate_local_s(ctx) * self.safety > ctx.req.deadline_s:
            return "deadline_risk"
        return None


class LocalOverloadEscalation:
    """Escalate on local pressure: the endpoint's admission queue is
    deeper than ``max_queue_depth``, or (paged KV) the pool high-water
    mark has reached ``kv_frac`` of capacity."""

    name = "overload"

    def __init__(self, max_queue_depth: int = 2, kv_frac: float = 1.0):
        self.max_queue_depth = max_queue_depth
        self.kv_frac = kv_frac

    def decide(self, ctx) -> Optional[str]:
        if ctx.snapshot.get("queue_depth", 0) > self.max_queue_depth:
            return "local_overload"
        kv = ctx.snapshot.get("kv", {})
        pool = kv.get("paged_kv_pool_bytes", 0.0)
        if pool and kv.get("paged_kv_hwm_bytes", 0.0) >= self.kv_frac * pool:
            return "local_overload"
        return None


# ---------------------------------------------------------------------------
# factories (EngineConfig carries policy names or instances)
# ---------------------------------------------------------------------------

ADMISSION_POLICIES = {
    "fifo": FifoAdmission,
    "priority": PriorityAdmission,
    "edf": DeadlineAdmission,
    "deadline": DeadlineAdmission,
    "batch": BatchAdmission,
    "static-bucket": BatchAdmission,
}

PREEMPTION_POLICIES = {
    "evict-latest": EvictLatest,
    "lowest-priority": LowestPriority,
}

PLACEMENT_POLICIES = {
    "round-robin": RoundRobinPlacement,
    "least-loaded": LeastLoadedPlacement,
}

VICTIM_EVICTION_POLICIES = {
    "lru": LruEviction,
    "weighted-lru": WeightedLruEviction,
}

ESCALATION_POLICIES = {
    "never": NeverEscalate,
    "always": AlwaysEscalate,
    "confidence": ConfidenceEscalation,
    "deadline-risk": DeadlineRiskEscalation,
    "overload": LocalOverloadEscalation,
}


def _make(kind: str, registry: dict, spec) -> Any:
    if isinstance(spec, str):
        try:
            return registry[spec]()
        except KeyError:
            raise ValueError(f"{kind} policy {spec!r} not in "
                             f"{sorted(registry)}") from None
    return spec


def make_admission(spec) -> Any:
    """Resolve an admission policy name or pass an instance through."""
    return _make("admission", ADMISSION_POLICIES, spec)


def make_preemption(spec) -> Any:
    """Resolve a preemption policy name or pass an instance through."""
    return _make("preemption", PREEMPTION_POLICIES, spec)


def make_placement(spec) -> Any:
    """Resolve a unit-placement policy name or pass an instance through."""
    return _make("placement", PLACEMENT_POLICIES, spec)


def make_victim_eviction(spec) -> Any:
    """Resolve a victim-eviction policy name or pass an instance
    through."""
    return _make("victim-eviction", VICTIM_EVICTION_POLICIES, spec)


def make_escalation(spec) -> List[Any]:
    """Resolve an escalation policy specification into a policy list
    (the TieredEngine ORs them): a name, an instance, or a sequence of
    either."""
    if isinstance(spec, str) or not isinstance(spec, (list, tuple)):
        spec = [spec]
    return [_make("escalation", ESCALATION_POLICIES, s) for s in spec]
