"""Durable escalation queue of the port: on-disk journal, tier
transports, and the in-order replay protocol.

Counterpart of ``repro.runtime.escalation_queue``, framework-neutral
and copied as it is over the port's ``checkpoint``, ``Engine`` and
``resilience``. The load-bearing half of ``runtime.escalation``, split
out so the queue protocol (journal durability, at-least-once in-order
replay, ack-side de-dup, fail-back accounting) is readable and testable
with no tiered engine in scope; ``runtime.escalation`` re-exports every
public name here.

* ``EscalationJournal``: a bounded on-disk FIFO. Every escalated
  request is appended as a ``runtime.checkpoint`` record (``.npz``
  arrays + ``.meta.json`` sidecar) before anything is sent, so a crash
  or link cut loses nothing: a fresh journal over the same directory
  rebuilds the pending set from a directory scan. The records are the
  reference's, so a journal directory written by either package
  rebuilds and replays in the other.
* ``JournalReplayer``: sends pending entries strictly in sequence order
  through a transport, acking (deleting) each entry only after its
  completion has been surfaced. A ``LinkDown`` stops replay at the head
  of the line; delivery is at-least-once and in order, and the
  ``delivered`` seq set de-duplicates on ack, so a resend after a lost
  acknowledgement surfaces exactly one completion.
* transports: ``InProcessTransport`` wraps a second ``Engine`` in the
  same process; ``HttpTransport`` posts to the HTTP front end's
  ``/escalate`` route (the port's or the reference's server);
  ``FlakyTransport`` wraps either and injects link up/down from a
  ``resilience.FailureTrace``, raising ``LinkDown`` when the link is
  dead at send or at acknowledgement time.
"""
from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.runtime import checkpoint
from repro_torch.runtime.engine import Engine
from repro_torch.runtime.resilience import FailureTrace
from repro_torch.runtime.scheduler import Completion, Request

__all__ = [
    "LinkDown", "TransportError", "JournalFull",
    "EscalationJournal", "JournalEntry", "JournalReplayer",
    "InProcessTransport", "HttpTransport", "FlakyTransport",
]


class LinkDown(RuntimeError):
    """The endpoint↔server link is (or went) down: the send did not
    complete, or its acknowledgement was lost. Retryable — the journal
    entry stays pending and replays when the link revives."""


class TransportError(RuntimeError):
    """Permanent per-request transport failure (e.g. the server refused
    the request as malformed). Not retryable: replay would loop."""


class JournalFull(OverflowError):
    """The bounded journal is at capacity; the caller must degrade
    (answer locally) instead of queueing without bound."""


# ---------------------------------------------------------------------------
# durable journal
# ---------------------------------------------------------------------------


@dataclass
class JournalEntry:
    """One pending escalated request, reconstructed from disk."""

    seq: int
    req: Request
    meta: Dict[str, Any]


class EscalationJournal:
    """Bounded on-disk FIFO of escalated requests.

    Each entry is two files under ``root`` — ``esc-<seq>.npz`` (the
    prompt, and embeds when present) written through
    ``checkpoint.save`` and its ``.meta.json`` sidecar carrying the
    scalar request fields — so ``pending()`` needs nothing but a
    directory scan: append / ack / crash-restart all converge on the
    same on-disk truth. A small ``journal.state.json`` persists the
    next sequence number so seqs stay monotone across restarts even
    when the journal drains empty (seq reuse would break ack de-dup).

    Thread-safe: one lock serializes append/ack/scan (submit threads
    append while the pump replays).
    """

    PREFIX = "esc-"

    def __init__(self, root: str, capacity: int = 256):
        if capacity < 1:
            raise ValueError("journal capacity must be >= 1")
        self.root = root
        self.capacity = capacity
        self._lock = threading.Lock()
        os.makedirs(root, exist_ok=True)
        pending = self._scan()
        persisted = 0
        state = os.path.join(root, "journal.state.json")
        if os.path.exists(state):
            with open(state) as fh:
                persisted = json.load(fh).get("next_seq", 0)
        self._next_seq = max(persisted,
                             (pending[-1] + 1) if pending else 0)

    # -- paths / scan -------------------------------------------------------

    def _base(self, seq: int) -> str:
        return os.path.join(self.root, f"{self.PREFIX}{seq:08d}")

    def _scan(self) -> List[int]:
        """Seqs of complete entries on disk, ascending. An entry is
        complete only when both files exist (a crash mid-append leaves
        at most one torn record, which is ignored and overwritten)."""
        seqs = []
        for name in os.listdir(self.root):
            if name.startswith(self.PREFIX) and name.endswith(".npz"):
                seq = int(name[len(self.PREFIX):-len(".npz")])
                if os.path.exists(self._base(seq) + ".meta.json"):
                    seqs.append(seq)
        return sorted(seqs)

    # -- FIFO surface -------------------------------------------------------

    @property
    def depth(self) -> int:
        with self._lock:
            return len(self._scan())

    def __len__(self) -> int:
        return self.depth

    def append(self, req: Request, *, arrival_s: float = 0.0,
               source: str = "endpoint") -> int:
        """Persist ``req`` and return its journal sequence number.
        Raises ``JournalFull`` at capacity — durability is bounded, the
        caller degrades to a local answer instead of queueing forever."""
        with self._lock:
            if len(self._scan()) >= self.capacity:
                raise JournalFull(
                    f"escalation journal full ({self.capacity} pending)")
            seq = self._next_seq
            self._next_seq += 1
            arrays = {"prompt": np.asarray(req.prompt, np.int32)}
            if req.embeds is not None:
                arrays["embeds"] = np.asarray(req.embeds)
            checkpoint.save(self._base(seq), arrays, meta={
                "seq": seq, "id": req.id,
                "max_new_tokens": req.max_new_tokens, "eos": req.eos,
                "priority": req.priority, "deadline_s": req.deadline_s,
                "max_restarts": req.max_restarts,
                "arrival_s": arrival_s, "source": source})
            with open(os.path.join(self.root, "journal.state.json"),
                      "w") as fh:
                json.dump({"next_seq": self._next_seq}, fh)
            return seq

    def ack(self, seq: int) -> None:
        """Remove an entry (idempotent): its completion was surfaced, or
        it was answered locally / shed — either way replay must skip it."""
        with self._lock:
            for suffix in (".npz", ".meta.json"):
                try:
                    os.remove(self._base(seq) + suffix)
                except FileNotFoundError:
                    pass

    def pending(self) -> List[JournalEntry]:
        """Every unacked entry in sequence order, rebuilt from disk —
        the crash-restart recovery path and the replay path are the
        same code."""
        with self._lock:
            out = []
            for seq in self._scan():
                meta = checkpoint.load_meta(self._base(seq))
                arrays = checkpoint.load_flat(self._base(seq) + ".npz")
                req = Request(
                    id=meta["id"], prompt=arrays["prompt"],
                    max_new_tokens=meta["max_new_tokens"], eos=meta["eos"],
                    embeds=arrays.get("embeds"),
                    priority=meta["priority"],
                    deadline_s=meta["deadline_s"],
                    max_restarts=meta["max_restarts"])
                out.append(JournalEntry(seq=seq, req=req, meta=meta))
            return out


# ---------------------------------------------------------------------------
# transports
# ---------------------------------------------------------------------------


class InProcessTransport:
    """Remote tier in the same process: sends block on a second
    ``Engine`` (typically the big server-tier model). Works against
    both background-drained and caller-pumped engines —
    ``RequestHandle.result`` pumps the latter itself."""

    def __init__(self, engine: Engine, *, tier: str = "server",
                 timeout_s: float = 120.0):
        self.engine = engine
        self.tier = tier
        self.timeout_s = timeout_s

    def healthy(self) -> bool:
        return True

    def send(self, req: Request, *, seq: Optional[int] = None) -> Completion:
        handle = self.engine.submit(req)
        if self.engine.running:
            return handle.result(self.timeout_s)
        return handle.result()


class HttpTransport:
    """Remote tier behind the HTTP front end: posts to the server's
    ``/escalate`` ingress route. Connection-level failures raise
    ``LinkDown`` (retryable — the journal holds the request); HTTP 4xx
    raises ``TransportError`` (permanent); 5xx/429 raise ``LinkDown``
    so backpressured servers are retried rather than dropped."""

    def __init__(self, url: str, *, tier: str = "server",
                 timeout_s: float = 120.0, route: str = "/escalate"):
        from urllib.parse import urlparse
        u = urlparse(url)
        self.host, self.port = u.hostname, u.port
        self.tier = tier
        self.timeout_s = timeout_s
        self.route = route

    def healthy(self) -> bool:
        import http.client
        try:
            conn = http.client.HTTPConnection(self.host, self.port,
                                              timeout=5)
            try:
                conn.request("GET", "/health/ready")
                r = conn.getresponse()
                r.read()        # drained, so the close sends no reset
                return r.status == 200
            finally:
                conn.close()
        except OSError:
            return False

    def send(self, req: Request, *, seq: Optional[int] = None) -> Completion:
        import http.client
        body = {"prompt": [int(t) for t in req.prompt],
                "max_new_tokens": req.max_new_tokens, "eos": req.eos,
                "priority": req.priority, "deadline_s": req.deadline_s,
                "seq": seq, "source": "endpoint"}
        try:
            conn = http.client.HTTPConnection(self.host, self.port,
                                              timeout=self.timeout_s)
            try:
                conn.request("POST", self.route, json.dumps(body),
                             {"Content-Type": "application/json"})
                r = conn.getresponse()
                raw = r.read()
            finally:
                conn.close()
        except OSError as e:
            raise LinkDown(f"escalation link down: {e}") from e
        if 400 <= r.status < 500 and r.status != 429:
            raise TransportError(f"/escalate -> {r.status}: {raw!r}")
        if r.status != 200:
            raise LinkDown(f"/escalate -> {r.status}")
        obj = json.loads(raw)
        return Completion(
            id=req.id, tokens=list(obj["tokens"]),
            prefill_s=0.0, decode_s=0.0,
            finish_reason=obj["finish_reason"],
            restarts=obj.get("restarts", 0))


class FlakyTransport:
    """Failure-injected wrapper: consults a ``resilience.FailureTrace``
    for the endpoint↔server link on every send. Dead at send time →
    the request never leaves (``LinkDown``). Dead at *completion* time →
    the server computed but the acknowledgement was lost, which is also
    ``LinkDown``: the entry stays journaled and is re-sent on revival —
    the replayer's de-dup makes the duplicate harmless."""

    def __init__(self, inner: Any, trace: FailureTrace, *,
                 a: str = "endpoint", b: str = "server",
                 clock: Optional[Callable[[], float]] = None):
        self.inner = inner
        self.trace = trace
        self.a, self.b = a, b
        self._t0 = time.perf_counter()
        self._clock = clock

    @property
    def tier(self) -> str:
        return self.inner.tier

    def bind_clock(self, clock: Callable[[], float]) -> None:
        """Adopt the tiered engine's clock so trace timestamps line up
        with its arrival/deadline instants (``TieredEngine.start`` calls
        this automatically)."""
        self._clock = clock

    def now(self) -> float:
        return self._clock() if self._clock is not None \
            else time.perf_counter() - self._t0

    def _dead(self) -> bool:
        return self.trace.link_dead_at(self.a, self.b, self.now())

    def healthy(self) -> bool:
        return not self._dead() and self.inner.healthy()

    def send(self, req: Request, *, seq: Optional[int] = None) -> Completion:
        if self._dead():
            raise LinkDown(
                f"link {self.a}<->{self.b} down at t={self.now():.3f}s")
        c = self.inner.send(req, seq=seq)
        if self._dead():
            raise LinkDown(
                f"link {self.a}<->{self.b} died before ack "
                f"(t={self.now():.3f}s); completion dropped")
        return c


# ---------------------------------------------------------------------------
# replay protocol
# ---------------------------------------------------------------------------


class JournalReplayer:
    """In-order at-least-once delivery of journal entries with ack-side
    de-duplication.

    ``step()`` walks the pending set in sequence order and sends each
    entry through the transport; an entry is acked (removed from disk)
    only after its completion has been handed to ``on_complete``. A
    ``LinkDown`` stops the walk at the head of the line — nothing after
    the failed entry is *surfaced*, preserving order across failures.
    ``delivered`` records surfaced seqs so a duplicate completion (a
    resend whose first ack was lost) is acked without being surfaced
    twice. ``link_up`` flips on observed send outcomes and on
    ``probe()``; each down→up transition is one *fail-back*, counted in
    ``failbacks``.

    ``window`` pipelines: up to that many sends are dispatched
    concurrently (the server tier batches them across its slots —
    serial replay would waste its decode width), but completions are
    still surfaced strictly in sequence order, and a failure anywhere
    in the window leaves every later entry unsurfaced and pending (the
    server may have computed it — the resend after revival is the
    at-least-once half the de-dup exists for). ``window=1`` is the
    fully synchronous, thread-free protocol the hypothesis property
    suite drives one operation at a time.
    """

    def __init__(self, journal: EscalationJournal, transport: Any, *,
                 on_complete: Optional[
                     Callable[[JournalEntry, Completion], None]] = None,
                 on_permanent_error: Optional[
                     Callable[[JournalEntry, Exception], None]] = None,
                 window: int = 1):
        self.journal = journal
        self.transport = transport
        self.on_complete = on_complete or (lambda entry, c: None)
        self.on_permanent_error = on_permanent_error or (lambda entry, e: None)
        self.window = max(1, window)
        self.delivered: Set[int] = set()
        self.link_up = True
        self.failbacks = 0

    def _note_up(self) -> None:
        if not self.link_up:
            self.link_up = True
            self.failbacks += 1

    def _note_down(self) -> None:
        self.link_up = False

    def probe(self) -> bool:
        """Poll transport health (a cheap liveness check, not a send)
        and fold the answer into the link state — how a revival is
        noticed while the journal is empty."""
        if self.transport.healthy():
            self._note_up()
        else:
            self._note_down()
        return self.link_up

    def step(self, max_sends: Optional[int] = None) -> int:
        """Send pending entries in order; returns completions surfaced.
        Stops at the first ``LinkDown`` (head-of-line order guarantee)
        or after ``max_sends`` sends (pump fairness bound). With
        ``window > 1`` each round dispatches a window of concurrent
        sends, then surfaces the results in sequence order."""
        surfaced = 0
        sends = 0
        while True:
            batch: List[JournalEntry] = []
            for entry in self.journal.pending():
                if entry.seq in self.delivered:
                    self.journal.ack(entry.seq)     # gc a stale duplicate
                    continue
                if max_sends is not None \
                        and sends + len(batch) >= max_sends:
                    break
                batch.append(entry)
                if len(batch) >= self.window:
                    break
            if not batch:
                return surfaced
            sends += len(batch)
            if len(batch) == 1:                     # serial fast path
                results = [self._send_one(batch[0])]
            else:
                results = [None] * len(batch)

                def _send(i: int, e: JournalEntry) -> None:
                    results[i] = self._send_one(e)

                threads = [threading.Thread(target=_send, args=(i, e),
                                            daemon=True)
                           for i, e in enumerate(batch)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
            for entry, (kind, val) in zip(batch, results):
                if kind == "down":
                    # head-of-line: nothing at or after the failure is
                    # surfaced or acked this round — even window-mates
                    # that succeeded (the server computed them; the
                    # resend after revival is de-duplicated on ack)
                    self._note_down()
                    return surfaced
                if kind == "error":
                    self.delivered.add(entry.seq)
                    self.on_permanent_error(entry, val)
                    self.journal.ack(entry.seq)
                    continue
                self._note_up()
                self.delivered.add(entry.seq)
                self.on_complete(entry, val)
                self.journal.ack(entry.seq)
                surfaced += 1
            if max_sends is not None and sends >= max_sends:
                return surfaced

    def _send_one(self, entry: JournalEntry) -> Tuple[str, Any]:
        try:
            return ("ok", self.transport.send(entry.req, seq=entry.seq))
        except LinkDown as e:
            return ("down", e)
        except TransportError as e:
            return ("error", e)
