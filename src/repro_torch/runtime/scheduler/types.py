"""Request/completion/config dataclasses shared across the scheduler package.

Counterpart of ``repro.runtime.scheduler.types``, copied (plain data, no
framework): the request the user submits, the completion they get back,
the scheduler's configuration, the observable event log entries, and
the internal ticket record and the state of an in-flight chunked
prefill. ``SchedulerConfig`` carries the knobs of the slotted and paged
layouts, chunked prefill, prefix sharing with its victim cache and
tenant quotas, deadline shedding and the multi-unit execution core;
``step_delay_s`` comes with the hierarchical tiers (ROADMAP queue 1,
item 9).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import frontend_rows

FINISH_REASONS = ("eos", "length", "cancelled", "failed", "timeout",
                  "local_fallback")

# stats() key schema — the typed-empty snapshot for policies with no
# continuous scheduler (Engine.stats on batch admission) must agree
COUNTER_KEYS = (
    "requests_submitted", "admissions", "evictions", "preemptions",
    "slot_failures", "cancellations", "sheds", "steps", "tokens_generated",
    "prefix_hits", "victim_hits", "victim_evictions",
    "prefill_tokens_total", "prefill_tokens_saved")


@dataclass
class Request:
    id: int
    prompt: np.ndarray                      # (S,) int32
    max_new_tokens: int = 16
    eos: Optional[int] = None
    embeds: Optional[np.ndarray] = None     # VLM/audio frontend output
    # lifecycle / policy fields
    priority: int = 0                       # higher = sooner (priority policy)
    deadline_s: Optional[float] = None      # seconds from arrival (EDF)
    # how many failure/preemption restarts before the request completes
    # as "failed" instead of re-queueing; None = restart forever (the
    # pre-lifecycle behavior, and the token-identity default)
    max_restarts: Optional[int] = None
    # prefix-cache namespace: a request only ever matches (and registers)
    # prefix chains under its own tenant, so a hash hit can never map
    # another tenant's K/V. "" is the default shared namespace.
    tenant: str = ""


@dataclass
class Completion:
    id: int
    tokens: List[int]
    prefill_s: float
    decode_s: float
    # Continuous-scheduler timeline (engine-clock seconds; 0.0 on the
    # static path which has no per-request timeline).
    arrival_s: float = 0.0
    first_token_s: float = 0.0
    finish_s: float = 0.0
    # why the request stopped:
    # "eos" | "length" | "cancelled" | "failed" | "timeout" |
    # "local_fallback" (a TieredEngine answered locally because the
    # escalation link was down and the deadline could not wait)
    finish_reason: str = "length"
    # times the request was re-queued (slot failure or pool preemption)
    restarts: int = 0

    @property
    def ttft_s(self) -> float:
        """Time to first token (admission wait + prefill)."""
        return self.first_token_s - self.arrival_s

    @property
    def latency_s(self) -> float:
        return self.finish_s - self.arrival_s


def cache_rows(cfg: ModelConfig, req: Request) -> int:
    """Rows a request's prefill writes into the decoder's cache: its
    prompt's, and with a vision frontend its ``embeds``' rows ahead of
    them (an encoder-decoder's source lives in the cross cache)."""
    return len(req.prompt) + frontend_rows(cfg, req.embeds)


def validate_request_fits(cfg: ModelConfig, req: Request,
                          max_len: int) -> None:
    """Shared admission check for every engine path. Decode writes KV
    rows at positions rows .. rows + max_new_tokens - 2, ``rows`` the
    prefill's ``cache_rows`` (a vision frontend's rows and the prompt);
    on an uncapped global-attention cache, rows past max_len would
    silently wrap the ring onto the prompt and corrupt the context.
    Sliding-window / recurrent (subquadratic) configs and explicitly
    capped caches (max_cache_len) wrap by design and are exempt. A
    frontend config needs ``embeds`` (F, frontend_dim), and an
    encoder-decoder's F source rows must fit its cross cache of
    max_len rows."""
    if cfg.frontend:
        if req.embeds is None:
            raise ValueError(f"request {req.id}: {cfg.name} reads "
                             f"{cfg.frontend} frontend embeds; the request "
                             f"carries none")
        shape = np.shape(req.embeds)
        if len(shape) != 2 or shape[1] != cfg.frontend_dim:
            raise ValueError(f"request {req.id}: embeds of shape {shape}, "
                             f"want (rows, {cfg.frontend_dim})")
        if cfg.n_encoder_layers and shape[0] > max_len:
            raise ValueError(f"request {req.id}: a source of {shape[0]} "
                             f"rows exceeds the cross cache's max_len "
                             f"{max_len}")
    rows = cache_rows(cfg, req)
    front = rows - len(req.prompt)
    what = (f"frontend ({front}) + prompt ({len(req.prompt)})" if front
            else f"prompt length {len(req.prompt)}")
    if rows > max_len:
        raise ValueError(f"request {req.id}: {what} exceeds max_len "
                         f"{max_len}")
    if cfg.is_subquadratic_decode or cfg.max_cache_len:
        return
    need = rows + req.max_new_tokens - 1
    if need > max_len:
        raise ValueError(
            f"request {req.id}: {what} + max_new_tokens "
            f"({req.max_new_tokens}) needs {need} cache rows, exceeding "
            f"max_len {max_len}")


@dataclass
class SchedulerConfig:
    max_slots: int = 8          # decode batch width
    max_len: int = 512          # KV rows per slot (rounded up to a whole
    #                             number of blocks in paged mode)
    greedy: bool = True
    temperature: float = 1.0
    seed: int = 0
    # paged KV cache: global-attn K/V in a shared block pool instead of
    # dense per-slot rows. num_blocks=0 sizes the pool for slotted parity
    # (max_slots full slots) + the reserved null block; size it smaller
    # to actually oversubscribe.
    paged: bool = False
    block_size: int = 16        # KV rows per block
    num_blocks: int = 0
    # admission watermark: require this many free blocks beyond the
    # prompt's need before admitting, so decode growth of the already-
    # running requests doesn't immediately preempt the newcomer back out
    watermark: int = 0
    # chunked prefill: admit prompts prefill_chunk tokens at a time,
    # interleaved with decode steps (0 = one-shot prefill). Configs
    # outside supports_chunked_prefill are served one-shot.
    prefill_chunk: int = 0
    # prefix sharing (paged only): admission matches new prompts against
    # resident block chains, maps fully-matched blocks into the request's
    # table (refcounted, copy-on-write on any write into a shared block)
    # and skips prefill for the matched region. Configs outside
    # supports_chunked_prefill are served paged without sharing.
    prefix_cache: bool = False
    # victim cache (requires prefix_cache): when a request completes,
    # its refcount-1 indexed blocks move to a reclaimable victim pool
    # instead of freeing, so the prefix index outlives the request and
    # cold admissions (even across drain epochs) still hit. Victim
    # blocks are evicted only under allocation pressure, in
    # victim_eviction order, and count as available for admission.
    victim_cache: bool = False
    # eviction order among victim blocks: a name from
    # policies.VICTIM_EVICTION_POLICIES ("lru" | "weighted-lru") or a
    # policy instance
    victim_eviction: Any = "weighted-lru"
    # per-tenant victim-pool byte budgets ({tenant: bytes}); a tenant
    # over its budget evicts only its own chains, never another
    # tenant's. Unlisted tenants are unbudgeted.
    prefix_cache_tenants: Optional[Dict[str, int]] = None
    # wall-clock deadline enforcement (EDF admission only orders by
    # deadline): a request whose due instant (arrival_s + deadline_s,
    # see policies.request_due_s) passes is shed at the next step
    # boundary, retired before prefill or evicted mid-decode, and
    # completes with finish_reason="timeout". Requests without a
    # deadline are untouched.
    enforce_deadlines: bool = False
    # --- multi-unit execution core (modeled per-unit clocks) -----------
    # units: processing units the execution core schedules over.
    # prefill_units of them are dedicated to prompt prefill
    # (0 = prefill shares the decode units — the classic colocated
    # setup); the remaining units run decode, with decode microbatches
    # pipelined across decode_stages stage-partitioned units (1 = whole-
    # model decode steps; more runs transformer.decode_step_staged). The
    # clocks are MODELED: token content is bit-identical to the single-
    # unit path in every configuration — units=1/prefill_units=0/
    # decode_stages=1 is the degenerate case with pure accounting and no
    # behavior change at all.
    units: int = 1
    prefill_units: int = 0
    decode_stages: int = 1
    # which prefill unit takes the next prompt burst: a name from
    # policies.PLACEMENT_POLICIES ("round-robin" | "least-loaded") or a
    # policy instance
    placement: Any = "round-robin"
    # deterministic modeled cost per prompt/decode token on one unit —
    # what the per-unit clocks charge (benches compare makespans across
    # unit topologies, so costs must not depend on wall-clock noise)
    prefill_sec_per_token: float = 1e-4
    decode_sec_per_token: float = 1e-4
    # wall-clock device-speed handicap: sleep this long after every
    # non-idle step. Emulates serving on a slower device (an edge
    # endpoint tier vs a server tier sharing one host, as in the
    # hierarchical-serving bench); token content is untouched, only
    # real elapsed time stretches.
    step_delay_s: float = 0.0
    # assert slot/block accounting invariants at every step boundary
    debug: bool = False


@dataclass
class SchedEvent:
    """Observable admission/eviction trace (asserted on by tests).
    ``kind`` is "admit" | "evict" | "fail" | "preempt" | "cancel" |
    "shed" (deadline enforcement timed the request out)."""
    t_s: float
    kind: str
    request_id: int
    slot: int
    step: int                   # decode-step counter at event time


@dataclass(frozen=True)
class SlotFailure:
    """Injected loss of decode slots at a step boundary — the scheduler-
    level view of a processing-unit failure (the unit hosting those KV
    slots went away). ``slots=None`` means every active slot: whole-unit
    loss, the companion fault-tolerance paper's server-loss scenario."""
    step: int
    slots: Optional[Tuple[int, ...]] = None


@dataclass(eq=False)                    # identity semantics: list/backlog
class _Ticket:                          # removal must never compare prompts
    req: Request
    arrival_s: float
    submit_seq: int = -1        # submission order (admission tie-break)
    slot: int = -1
    emitted: List[int] = field(default_factory=list)
    prefill_s: float = 0.0
    first_token_s: float = 0.0
    admit_seq: int = -1         # admission order (preemption input)
    restarts: int = 0           # failure/preemption re-queues so far
    cancelled: bool = False     # set via request_cancel()
    retired: bool = False       # completed while a stale heap entry remains
    where: str = "backlog"      # backlog | queued | active | chunking | done
    handle: Any = None          # RequestHandle, when served via Engine
    # observability bookkeeping (scheduler-clock seconds)
    queued_at_s: float = 0.0    # last _enqueue instant (queue-wait metric)
    last_emit_s: float = 0.0    # last token instant (inter-token metric)


@dataclass
class _ChunkedPrefill:
    """A prompt mid-way through chunked admission: its slot (and, paged,
    its prompt blocks) are reserved; K/V accumulates in a batch=1 scratch
    cache that is inserted into the shared cache once the prompt is
    done."""
    ticket: _Ticket
    slot: int
    cache: Any
    pos: int = 0                # prompt tokens consumed so far
