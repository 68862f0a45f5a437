"""Resilience subsystem of the port: failure injection, heartbeat
failover, re-mapping.

Counterpart of ``repro.runtime.resilience``, framework-neutral and
copied as it is over the port's ``core`` and ``observability``. The
fault-tolerant Edge-PRUNE follow-up (arXiv 2206.08152) builds on the
framework's central property: the application graph never changes
across distributed scenarios, only the mapping does. When a processing
unit or link dies mid-inference, the runtime switches to an alternative
mapping of the same graph onto the surviving units and keeps serving.

* **Failure model**: ``FailureEvent`` / ``FailureTrace`` describe kills
  and revivals of ``ProcessingUnit``s and ``Link``s at modeled
  timestamps. The token-accurate ``core.Simulator`` consumes a trace
  directly (``Simulator.run(..., failures=trace)``): firings on a dead
  unit wait for its revival (or block forever), tokens that land at or
  sit buffered on a dead unit are lost, and lost frames are re-fired
  from the last consistent frame boundary. ``FailureInjector`` is the
  stateful consumer that delivers events as modeled time advances.
* **Detection**: ``HeartbeatMonitor`` models the liveness protocol:
  every unit beats every ``interval_s``; a unit whose beat has been
  missing for ``timeout_s`` is declared dead, so detection latency is
  part of every recovery-latency figure.
* **Failover controller**: ``FailoverController`` serves a stream of
  frames through a synthesized ``StagedProgram`` with per-frame ack
  points, holding at most ``checkpoint_frames`` unacknowledged frames in
  a bounded FIFO ``CheckpointBuffer``. On a detected failure it selects
  the first viable mapping from a ranked fallback list
  (``Explorer.rank_fallbacks``), re-synthesizes the staged program on
  the surviving units, replays the unacknowledged frames and records
  the recovery latency. Stage functions are pure and the graph is
  mapping-invariant, so every served frame's output is bit-identical to
  the failure-free run whichever mapping produced it.
"""
from __future__ import annotations

import math
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import (Any, Dict, FrozenSet, Iterable, List, Optional, Sequence,
                    Tuple)

from repro_torch.core.graph import Graph
from repro_torch.core.mapping import Mapping, PlatformModel
from repro_torch.core.synthesis import StagedProgram, synthesize
from repro_torch.runtime.observability import (TIME_BUCKETS_S, Observability,
                                               failover_trace)

__all__ = [
    "FailureEvent", "FailureTrace", "FailureInjector", "HeartbeatConfig",
    "HeartbeatMonitor", "CheckpointBuffer", "FailoverEvent",
    "FailoverReport", "FailoverController", "NoViableMappingError",
]


# ---------------------------------------------------------------------------
# Failure model
# ---------------------------------------------------------------------------

UNIT = "unit"
LINK = "link"
KILL = "kill"
REVIVE = "revive"


@dataclass(frozen=True)
class FailureEvent:
    """One modeled fault-domain transition.

    ``kind`` is ``"unit"`` or ``"link"``; ``target`` is the unit name or
    the frozenset of the link's two endpoint unit names; ``action`` is
    ``"kill"`` or ``"revive"``.
    """

    t_s: float
    kind: str
    target: Any
    action: str


def _link_key(a: str, b: str) -> FrozenSet[str]:
    return frozenset((a, b))


class FailureTrace:
    """An ordered script of kill/revive events, queryable by modeled time.

    The trace is the *ground truth* the injector and the simulator consume;
    detection (heartbeats) is layered on top, so a component is physically
    dead from its kill instant even though the controller only learns of it
    ``HeartbeatMonitor.detect_time`` later.
    """

    def __init__(self, events: Iterable[FailureEvent] = ()):
        self.events: List[FailureEvent] = sorted(events, key=lambda e: e.t_s)

    # -- builders -----------------------------------------------------------

    def _add(self, t_s: float, kind: str, target: Any,
             action: str) -> "FailureTrace":
        if t_s < 0:
            raise ValueError(f"failure event at negative time {t_s}")
        self.events.append(FailureEvent(t_s, kind, target, action))
        self.events.sort(key=lambda e: e.t_s)
        return self

    def kill_unit(self, unit: str, at: float) -> "FailureTrace":
        return self._add(at, UNIT, unit, KILL)

    def revive_unit(self, unit: str, at: float) -> "FailureTrace":
        return self._add(at, UNIT, unit, REVIVE)

    def kill_link(self, a: str, b: str, at: float) -> "FailureTrace":
        return self._add(at, LINK, _link_key(a, b), KILL)

    def revive_link(self, a: str, b: str, at: float) -> "FailureTrace":
        return self._add(at, LINK, _link_key(a, b), REVIVE)

    # -- interval queries ---------------------------------------------------

    def _dead_intervals(self, kind: str, target: Any
                        ) -> List[Tuple[float, float]]:
        """Closed-open [kill, revive) intervals for one component."""
        out: List[Tuple[float, float]] = []
        open_at: Optional[float] = None
        for e in self.events:
            if e.kind != kind or e.target != target:
                continue
            if e.action == KILL and open_at is None:
                open_at = e.t_s
            elif e.action == REVIVE and open_at is not None:
                out.append((open_at, e.t_s))
                open_at = None
        if open_at is not None:
            out.append((open_at, math.inf))
        return out

    @staticmethod
    def _dead_at(intervals: List[Tuple[float, float]], t: float) -> bool:
        return any(k <= t < r for k, r in intervals)

    @staticmethod
    def _next_alive(intervals: List[Tuple[float, float]],
                    t: float) -> Optional[float]:
        """Earliest time >= t at which the component is alive; None if it
        stays dead forever from t on."""
        for k, r in intervals:
            if k <= t < r:
                return None if math.isinf(r) else r
        return t

    @staticmethod
    def _killed_between(intervals: List[Tuple[float, float]],
                        t0: float, t1: float) -> bool:
        """Did a kill happen in (t0, t1]? (A token that landed at t0 and
        would be consumed at t1 is lost iff its unit died in between.)"""
        return any(t0 < k <= t1 for k, _ in intervals)

    # unit-facing ----------------------------------------------------------

    def unit_dead_at(self, unit: str, t: float) -> bool:
        return self._dead_at(self._dead_intervals(UNIT, unit), t)

    def unit_next_alive(self, unit: str, t: float) -> Optional[float]:
        return self._next_alive(self._dead_intervals(UNIT, unit), t)

    def unit_killed_between(self, unit: str, t0: float, t1: float) -> bool:
        return self._killed_between(self._dead_intervals(UNIT, unit), t0, t1)

    # link-facing ----------------------------------------------------------

    def link_dead_at(self, a: str, b: str, t: float) -> bool:
        return self._dead_at(self._dead_intervals(LINK, _link_key(a, b)), t)

    def link_next_alive(self, a: str, b: str, t: float) -> Optional[float]:
        return self._next_alive(self._dead_intervals(LINK, _link_key(a, b)), t)

    def link_killed_between(self, a: str, b: str, t0: float,
                            t1: float) -> bool:
        return self._killed_between(
            self._dead_intervals(LINK, _link_key(a, b)), t0, t1)

    # controller-facing ----------------------------------------------------

    def first_kill_affecting(self, units: Sequence[str],
                             link_pairs: Sequence[Tuple[str, str]],
                             *, after: float,
                             before: float = math.inf
                             ) -> Optional[FailureEvent]:
        """Earliest kill event in (after, before] hitting any of ``units``
        or any link between the given unit pairs."""
        keys = {_link_key(a, b) for a, b in link_pairs}
        for e in self.events:
            if e.action != KILL or not (after < e.t_s <= before):
                continue
            if e.kind == UNIT and e.target in units:
                return e
            if e.kind == LINK and e.target in keys:
                return e
        return None

    def dead_units(self, t: float) -> List[str]:
        targets = {e.target for e in self.events if e.kind == UNIT}
        return sorted(u for u in targets if self.unit_dead_at(u, t))

    def dead_links(self, t: float) -> List[FrozenSet[str]]:
        targets = {e.target for e in self.events if e.kind == LINK}
        return sorted((k for k in targets
                       if self._dead_at(self._dead_intervals(LINK, k), t)),
                      key=sorted)


class FailureInjector:
    """Stateful trace consumer: delivers events as modeled time advances.

    The controller (or any runtime component with a clock) calls
    ``advance(now)`` each scheduling round and receives the events whose
    timestamps have elapsed since the previous call — the injection side
    of the companion paper's experiments, where a device is powered off at
    a chosen instant mid-inference.

    Beyond the raw event feed, the injector folds delivered kill/revive
    events into *current* up/down state — ``unit_up`` / ``link_up`` /
    ``dead_units`` / ``dead_links`` answer "as of the last advance()".
    The escalation layer (``runtime.escalation``) polls ``link_up`` for
    its endpoint↔server link each pump round; a down→up transition there
    is what triggers journal fail-back.
    """

    def __init__(self, trace: FailureTrace):
        self.trace = trace
        self._cursor = 0
        self._dead_units: set = set()
        self._dead_links: set = set()

    def advance(self, now: float) -> List[FailureEvent]:
        fresh: List[FailureEvent] = []
        while (self._cursor < len(self.trace.events)
               and self.trace.events[self._cursor].t_s <= now):
            e = self.trace.events[self._cursor]
            fresh.append(e)
            dead = self._dead_units if e.kind == UNIT else self._dead_links
            if e.action == KILL:
                dead.add(e.target)
            else:
                dead.discard(e.target)
            self._cursor += 1
        return fresh

    # -- current state (as of the last advance) -----------------------------

    def unit_up(self, unit: str) -> bool:
        return unit not in self._dead_units

    def link_up(self, a: str, b: str) -> bool:
        return _link_key(a, b) not in self._dead_links

    @property
    def dead_units(self) -> List[str]:
        return sorted(self._dead_units)

    @property
    def dead_links(self) -> List[FrozenSet[str]]:
        return sorted(self._dead_links, key=sorted)

    @property
    def exhausted(self) -> bool:
        return self._cursor >= len(self.trace.events)


# ---------------------------------------------------------------------------
# Detection: heartbeats
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class HeartbeatConfig:
    """Liveness protocol constants. ``timeout_s`` is measured from a unit's
    last successful beat, so it must cover at least one full interval or
    healthy units would flap."""

    interval_s: float = 0.050
    timeout_s: float = 0.150

    def __post_init__(self) -> None:
        if self.interval_s <= 0:
            raise ValueError("heartbeat interval must be positive")
        if self.timeout_s < self.interval_s:
            raise ValueError(
                f"timeout_s ({self.timeout_s}) must be >= interval_s "
                f"({self.interval_s}) or healthy units time out")


class HeartbeatMonitor:
    """Models when a failure becomes *known*: a unit killed at ``t_fail``
    beats for the last time at ``floor(t_fail / interval) * interval``; the
    monitor declares it dead once ``timeout_s`` elapses past that beat."""

    def __init__(self, cfg: Optional[HeartbeatConfig] = None):
        self.cfg = cfg or HeartbeatConfig()

    def detect_time(self, t_fail: float) -> float:
        last_beat = math.floor(t_fail / self.cfg.interval_s) * self.cfg.interval_s
        return max(t_fail, last_beat + self.cfg.timeout_s)


# ---------------------------------------------------------------------------
# Bounded FIFO checkpoint buffer
# ---------------------------------------------------------------------------

class CheckpointBuffer:
    """Bounded FIFO of unacknowledged frames (frame_id -> external inputs).

    The controller never has more than ``capacity`` frames in flight: a
    frame enters the buffer when submitted to the staged pipeline and
    leaves on its ack. After a failure, ``unacked()`` is exactly the set
    of frames that must be replayed on the fallback mapping — bounding the
    buffer bounds both replay work and recovery memory.
    """

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError("checkpoint buffer capacity must be >= 1")
        self.capacity = capacity
        self._buf: "OrderedDict[int, Any]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._buf)

    @property
    def full(self) -> bool:
        return len(self._buf) >= self.capacity

    def push(self, frame_id: int, inputs: Any) -> None:
        if self.full:
            raise OverflowError(
                f"checkpoint buffer full ({self.capacity} unacked frames); "
                f"ack before submitting more")
        self._buf[frame_id] = inputs

    def ack(self, frame_id: int) -> None:
        self._buf.pop(frame_id, None)

    def unacked(self) -> List[Tuple[int, Any]]:
        return list(self._buf.items())

    def clear(self) -> None:
        self._buf.clear()


# ---------------------------------------------------------------------------
# Failover controller
# ---------------------------------------------------------------------------

class NoViableMappingError(RuntimeError):
    """No fallback mapping survives the current dead unit/link set."""


@dataclass
class FailoverEvent:
    """One recovery: failure instant -> detection -> re-map -> replay."""

    t_fail_s: float
    t_detect_s: float
    resynth_s: float
    mapping_from: str
    mapping_to: Optional[str]
    dead_units: List[str] = field(default_factory=list)
    dead_links: List[Tuple[str, str]] = field(default_factory=list)
    replayed_frames: List[int] = field(default_factory=list)

    @property
    def recovery_latency_s(self) -> float:
        """Time from the physical failure until the replacement program is
        ready to serve: detection delay + re-synthesis."""
        return (self.t_detect_s - self.t_fail_s) + self.resynth_s


@dataclass
class FailoverReport:
    """Aggregate outcome of one ``FailoverController.serve`` call."""

    events: List[FailoverEvent] = field(default_factory=list)
    frames_replayed: List[int] = field(default_factory=list)
    frames_unserved: List[int] = field(default_factory=list)
    mapping_history: List[str] = field(default_factory=list)
    makespan_s: float = 0.0
    exhausted: bool = False          # ran out of viable mappings

    @property
    def recovery_latency_s(self) -> float:
        """Total modeled recovery latency across all failovers."""
        return sum(e.recovery_latency_s for e in self.events)

    @property
    def num_failovers(self) -> int:
        return len(self.events)


class FailoverController:
    """Serves frame streams through re-mappable staged programs.

    ``fallbacks`` is a ranked list of alternative ``Mapping``s (best
    first); the controller starts on ``primary`` and, on each detected
    failure, walks the list for the first mapping that is *viable* — every
    unit it uses alive, every boundary edge backed by an alive (and
    existing) platform link. Candidates are typically precomputed with
    ``Explorer.rank_fallbacks`` at deployment time, exactly as the
    Edge-PRUNE Explorer precomputes partition-point mapping files.
    """

    def __init__(self, g: Graph, primary: Mapping,
                 fallbacks: Sequence[Mapping] = (), *,
                 platform: Optional[PlatformModel] = None,
                 heartbeat: Optional[HeartbeatConfig] = None,
                 checkpoint_frames: int = 8,
                 obs: Optional[Observability] = None):
        self.g = g
        self.platform = platform
        self.monitor = HeartbeatMonitor(heartbeat)
        self.checkpoint_frames = checkpoint_frames
        self.candidates: List[Mapping] = [primary, *fallbacks]
        self.mapping = primary
        self.program: StagedProgram = synthesize(g, primary)
        # observability: each failover lands as modeled-clock detection /
        # resynthesis spans plus latency histograms
        self.obs = obs if (obs is not None and obs.enabled) else None
        if self.obs is not None:
            r = self.obs.registry
            self._h_detect = r.histogram(
                "repro_failover_detection_seconds", TIME_BUCKETS_S,
                help="modeled failure instant to heartbeat detection")
            self._h_recover = r.histogram(
                "repro_failover_recovery_seconds", TIME_BUCKETS_S,
                help="modeled failure instant to replacement program ready"
                     " (detection + re-synthesis)")
            self._c_failovers = r.counter(
                "repro_failovers_total", help="mapping switches performed")

    # -- mapping viability --------------------------------------------------

    def _boundary_pairs(self, m: Mapping) -> List[Tuple[str, str]]:
        return sorted({(m.unit_of(f.src.actor.name),
                        m.unit_of(f.dst.actor.name))
                       for f in m.boundary_edges(self.g)})

    def _viable(self, m: Mapping, failures: FailureTrace, t: float) -> bool:
        if any(failures.unit_dead_at(u, t) for u in m.units_used()):
            return False
        for a, b in self._boundary_pairs(m):
            if failures.link_dead_at(a, b, t):
                return False
            if (self.platform is not None
                    and self.platform.platform.link_between(a, b) is None):
                return False
        return True

    def _select(self, failures: FailureTrace, t: float) -> Optional[Mapping]:
        for m in self.candidates:
            if self._viable(m, failures, t):
                return m
        return None

    # -- serving ------------------------------------------------------------

    def serve(self, frames: List[Dict[str, Any]], *,
              failures: Optional[FailureTrace] = None,
              arrivals: Optional[List[float]] = None
              ) -> Tuple[List[Optional[Dict[str, Any]]], FailoverReport]:
        """Serve ``frames`` (external-input dicts) to completion.

        Returns one sink-output dict per frame (``None`` for frames that
        could not be served because no viable mapping remained) plus the
        ``FailoverReport``. Committed outputs are bit-identical to a
        failure-free run: a frame is only committed once its final stage
        acked, and un-acked frames are recomputed from their checkpointed
        inputs on the fallback mapping — stage functions are pure and the
        graph is mapping-invariant, so the replayed result is the same
        tensor.
        """
        failures = failures or FailureTrace()
        if arrivals is not None and len(arrivals) != len(frames):
            raise ValueError(f"arrivals has {len(arrivals)} entries for "
                             f"{len(frames)} frames")
        arrivals = arrivals or [0.0] * len(frames)
        pending: deque = deque(range(len(frames)))
        outputs: List[Optional[Dict[str, Any]]] = [None] * len(frames)
        buffer = CheckpointBuffer(self.checkpoint_frames)
        report = FailoverReport(mapping_history=[self.mapping.name])
        clock = 0.0

        while pending:
            # A failure may already be pending at `clock` (e.g. the unit
            # died while we were re-synthesizing, or at t=0 before the
            # first frame — the failure-during-prefill case).
            if not self._viable(self.mapping, failures, clock):
                t_detect = max(clock, self.monitor.detect_time(clock))
                if not self._failover(failures, clock, t_detect, [], report):
                    report.frames_unserved = list(pending)
                    break
                clock = report.events[-1].t_detect_s \
                    + report.events[-1].resynth_s
                continue

            window = list(pending)[:self.checkpoint_frames]
            for fid in window:
                buffer.push(fid, frames[fid])
            win_arrivals = [max(arrivals[fid], clock) for fid in window]
            sinks, sched = self.program.run_pipelined(
                [frames[fid] for fid in window],
                platform=self.platform, arrivals=win_arrivals)
            window_end = max(sched.makespan_s, clock)

            kill = failures.first_kill_affecting(
                self.mapping.units_used(),
                self._boundary_pairs(self.mapping),
                after=clock, before=window_end)
            if kill is None:
                for wi, fid in enumerate(window):
                    outputs[fid] = sinks[wi]
                    buffer.ack(fid)
                    pending.popleft()
                clock = window_end
                continue

            # Commit only frames whose final-stage ack beat the failure;
            # everything else in the window is unacknowledged state on a
            # (partially) dead mapping and will be replayed.
            t_fail = kill.t_s
            for wi, fid in enumerate(window):
                if sched.frame_done_s[wi] <= t_fail:
                    outputs[fid] = sinks[wi]
                    buffer.ack(fid)
                    pending.remove(fid)
            replay = [fid for fid, _ in buffer.unacked()]
            buffer.clear()
            if not self._failover(failures, t_fail,
                                  self.monitor.detect_time(t_fail),
                                  replay, report):
                report.frames_unserved = list(pending)
                break
            ev = report.events[-1]
            clock = ev.t_detect_s + ev.resynth_s
            report.frames_replayed.extend(replay)

        report.makespan_s = max(report.makespan_s, clock)
        return outputs, report

    def _failover(self, failures: FailureTrace, t_fail: float,
                  t_detect: float, replay: List[int],
                  report: FailoverReport) -> bool:
        """Switch to the best viable fallback at ``t_detect``. Returns
        False (and records an exhausted event) when none survives."""
        dead_u = failures.dead_units(t_detect)
        dead_l = [tuple(sorted(k)) for k in failures.dead_links(t_detect)]
        nxt = self._select(failures, t_detect)
        wall0 = time.perf_counter()
        if nxt is not None:
            program = synthesize(self.g, nxt)
        resynth = time.perf_counter() - wall0
        ev = FailoverEvent(
            t_fail_s=t_fail, t_detect_s=t_detect, resynth_s=resynth,
            mapping_from=self.mapping.name,
            mapping_to=nxt.name if nxt is not None else None,
            dead_units=dead_u, dead_links=dead_l,
            replayed_frames=list(replay))
        report.events.append(ev)
        if self.obs is not None:
            failover_trace(self.obs.tracer, [ev])
            self._h_detect.observe(ev.t_detect_s - ev.t_fail_s)
            self._h_recover.observe(ev.recovery_latency_s)
            if nxt is not None:
                self._c_failovers.inc()
        if nxt is None:
            report.exhausted = True
            report.makespan_s = max(report.makespan_s, t_detect)
            return False
        self.mapping = nxt
        self.program = program
        report.mapping_history.append(nxt.name)
        return True
