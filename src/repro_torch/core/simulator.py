"""Token-accurate execution of a VR-PRUNE graph (the Edge-PRUNE "runtime").

A copy of ``repro.core.simulator`` for the port. ``FiringRecord.wall_s``
is host time around the fire function: with actors on a GPU it
times the host's launch of the actor's kernels, not the device.

The paper's runtime instantiates each actor as a thread and synchronizes
FIFOs with mutexes. A literal thread-per-actor port is the wrong idiom for
a host driving an accelerator; the simulator instead executes
the *identical* firing semantics — an actor fires iff every input FIFO
holds atr(p) tokens and every output FIFO has space — under a sequential
event loop. This keeps the MoC behaviour bit-exact while staying
deterministic and profileable.

Two clocks are maintained per firing:

* ``wall`` — real measured wall-clock of the fire function on the host
  (used to reproduce the paper's *measured* experiments), and
* ``modeled`` — cost_flops / device_flops + token_bytes / link_bandwidth
  under a ``PlatformModel`` (used to transplant the sweep onto the paper's
  N2 / N270 / i7 devices and Ethernet / WiFi links, and onto TPU pods).

Distributed semantics: when a ``Mapping`` is supplied, every edge whose
endpoints map to different processing units is treated as a TX/RX FIFO pair
(Sec III.B) — tokens flow identically, but the modeled clock charges the
link with ``token_bytes / bandwidth + latency`` and the per-device busy
clocks advance independently, mimicking pipelined client/server execution.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core.clocks import UnitClocks
from repro_torch.core.graph import Actor, ActorType, Fifo, Graph
from repro_torch.core.mapping import Mapping, PlatformModel


@dataclass
class FiringRecord:
    actor: str
    firing_index: int
    wall_s: float
    modeled_s: float
    unit: str
    # Pipelined-clock timeline: when this firing started/finished on its
    # unit's concurrent busy clock (0.0/modeled_s without a platform).
    start_s: float = 0.0
    finish_s: float = 0.0


@dataclass
class SimResult:
    outputs: Dict[str, List[Any]]
    firings: List[FiringRecord] = field(default_factory=list)
    # Per processing unit: total modeled busy seconds (compute only — the
    # Figs 4-6 accounting; sender-side TX CPU cost is ledgered apart).
    unit_busy_s: Dict[str, float] = field(default_factory=dict)
    # Modeled seconds spent on boundary (TX/RX) transfers, per edge.
    link_busy_s: Dict[str, float] = field(default_factory=dict)
    # Sender-side CPU cost of boundary transfers (readback + syscalls),
    # per unit. Charged to the sender's concurrent clock as well.
    tx_cpu_busy_s: Dict[str, float] = field(default_factory=dict)
    wall_total_s: float = 0.0
    # Modeled completion time with per-device busy clocks advancing
    # concurrently (pipelined client/server execution, Sec III.B). The
    # sequential reference is ``modeled_total_s()``.
    modeled_makespan_s: float = 0.0
    # Failure accounting (populated when ``failures=`` is given): frames
    # whose in-flight tokens were lost and re-fired from the last
    # consistent frame boundary, and frames lost for good (the failed
    # component never revived, so replaying onto it cannot succeed —
    # recovering those is the FailoverController's job, via re-mapping).
    frames_replayed: List[int] = field(default_factory=list)
    frames_lost: List[int] = field(default_factory=list)
    failure_log: List[str] = field(default_factory=list)

    @property
    def modeled_endpoint_s(self) -> float:
        """Modeled busy time summed over every non-server unit — the
        'endpoint device inference time' metric of Figs 4-6."""
        return sum(v for k, v in self.unit_busy_s.items() if not k.startswith("server"))

    def modeled_total_s(self) -> float:
        return (sum(self.unit_busy_s.values())
                + sum(self.link_busy_s.values())
                + sum(self.tx_cpu_busy_s.values()))

    @property
    def pipeline_speedup(self) -> float:
        """Sequential / pipelined modeled time — the overlap win. An empty
        run (no firings, or no platform so every modeled charge is zero)
        has no overlap to measure on either side: report 1.0 rather than
        dividing zero by zero."""
        if not self.modeled_makespan_s or not self.modeled_total_s():
            return 1.0
        return self.modeled_total_s() / self.modeled_makespan_s


class FifoState:
    """Run-time state of one FIFO edge: a bounded token deque.

    Each token carries a modeled *availability timestamp* (when it lands
    at the consuming unit) and a *frame tag* (which source firing it
    descends from) in parallel deques. Timestamps let the event loop
    advance per-device clocks concurrently; frame tags let failure
    handling re-fire a lost frame from its last consistent boundary.
    Initial delay tokens carry frame ``-1`` (they precede every frame)."""

    def __init__(self, f: Fifo):
        self.fifo = f
        self.q: deque = deque()
        self.ts: deque = deque()
        self.fr: deque = deque()
        for _ in range(f.delay_tokens):
            self.q.append(None)  # initial delay tokens carry no payload
            self.ts.append(0.0)
            self.fr.append(-1)

    def can_pop(self, n: int) -> bool:
        return len(self.q) >= n

    def can_push(self, n: int) -> bool:
        return len(self.q) + n <= self.fifo.capacity

    def pop(self, n: int) -> List[Any]:
        return self.pop_timed(n)[0]

    def pop_timed(self, n: int) -> Tuple[List[Any], float]:
        """Pop ``n`` tokens; also return when the last became available."""
        toks, ready, _ = self.pop_full(n)
        return toks, ready

    def pop_full(self, n: int) -> Tuple[List[Any], float, List[Tuple[float, int]]]:
        """Pop ``n`` tokens; return (tokens, last-availability, per-token
        (availability, frame) pairs)."""
        ready = 0.0
        toks: List[Any] = []
        meta: List[Tuple[float, int]] = []
        for _ in range(n):
            t = self.ts.popleft()
            ready = max(ready, t)
            toks.append(self.q.popleft())
            meta.append((t, self.fr.popleft()))
        return toks, ready, meta

    def push(self, toks: List[Any], ready_s: float = 0.0,
             frame: int = -1) -> None:
        if len(self.q) + len(toks) > self.fifo.capacity:
            raise OverflowError(
                f"fifo {self.fifo.name} overflow: {len(self.q)}+{len(toks)} > "
                f"{self.fifo.capacity}")
        self.q.extend(toks)
        self.ts.extend([ready_s] * len(toks))
        self.fr.extend([frame] * len(toks))

    def purge_frame(self, frame: int) -> int:
        """Drop every buffered token of ``frame``. Replay (and permanent
        loss) is whole-frame: a lost frame's surviving tokens on healthy
        branches must go too, or a later join would pair branch outputs
        from different frames."""
        keep = [(q, t, f) for q, t, f in zip(self.q, self.ts, self.fr)
                if f != frame]
        dropped = len(self.q) - len(keep)
        if dropped:
            self.q = deque(x[0] for x in keep)
            self.ts = deque(x[1] for x in keep)
            self.fr = deque(x[2] for x in keep)
        return dropped


class Simulator:
    def __init__(self, g: Graph, *, mapping: Optional[Mapping] = None,
                 platform: Optional[PlatformModel] = None,
                 atr_fn: Optional[Callable[[Actor, int], Dict[str, int]]] = None):
        """``atr_fn(actor, firing_index) -> {port_name: atr}`` plays the CA
        role for variable-rate ports; defaults to url on every port."""
        self.g = g
        self.mapping = mapping
        self.platform = platform
        self.atr_fn = atr_fn
        self.states: Dict[str, Any] = {}

    def _atr(self, a: Actor, k: int) -> Dict[str, int]:
        rates = {p.name: p.url for p in a.in_ports + a.out_ports}
        if self.atr_fn is not None and a.actor_type in (ActorType.DA, ActorType.DPA,
                                                        ActorType.CA):
            over = self.atr_fn(a, k)
            for pname, r in over.items():
                p = a.port(pname)
                if not (p.lrl <= r <= p.url):
                    raise ValueError(
                        f"atr({a.name}.{pname})={r} outside [{p.lrl},{p.url}]")
                rates[pname] = r
        return rates

    def _unit(self, a: Actor) -> str:
        return self.mapping.unit_of(a.name) if self.mapping else "local"

    MAX_REPLAYS_PER_FRAME = 4

    def run(self, num_source_firings: int, *,
            source_inputs: Optional[Dict[str, List[Any]]] = None,
            max_steps: int = 10_000_000,
            failures: Optional[Any] = None) -> SimResult:
        """Run until every source actor has fired ``num_source_firings``
        times and no further firings are possible.

        ``source_inputs`` optionally supplies per-source-actor token
        payloads (one per firing); otherwise the source fire_fn is invoked
        with no input tokens.

        ``failures`` (a ``repro_torch.runtime.resilience.FailureTrace``,
        duck-typed so core stays import-free of runtime) injects unit/link
        kills and revivals on the modeled clocks:

        * a firing whose start falls inside a dead interval of its unit is
          delayed to the revival (blocked forever without one);
        * tokens buffered on a unit across a kill, or landing at a dead
          unit, are lost, and their frame is re-fired from the source —
          the last consistent frame boundary (replay is deterministic when
          ``source_inputs`` feeds the sources);
        * transfers over a dead link wait for its revival; without one the
          token (and frame) is lost.

        Frames whose failed component never revives are reported in
        ``frames_lost`` — recovering *those* requires a different mapping,
        which is the ``FailoverController``'s job, not the simulator's.
        Replay granularity is whole frames: a lost frame's surviving
        in-flight tokens are purged everywhere (so joins stay
        frame-aligned) and the healthy branches recompute.

        Whole-frame replay is only sound for the synthesis-path graph
        class — static-rate, acyclic, stateless actors (the paper's and
        our DNN inference graphs). Stateful actors cannot be rolled back,
        loop-carried delay tokens would be purged, and variable rates
        cannot be reproduced at replay time, so ``failures=`` combined
        with ``atr_fn``, delay tokens, or ``init_fn`` raises rather than
        silently corrupting outputs.
        """
        if failures is not None:
            if self.atr_fn is not None:
                raise ValueError(
                    "failure injection requires static-rate graphs: replay "
                    "cannot reproduce atr_fn's per-firing-index rates")
            cyclic = [f.name for f in self.g.fifos.values() if f.delay_tokens]
            if cyclic:
                raise ValueError(
                    f"failure injection does not support feedback edges "
                    f"(delay tokens on {cyclic}): whole-frame replay would "
                    f"purge loop-carried state")
            stateful = [a.name for a in self.g.actors.values() if a.init_fn]
            if stateful:
                raise ValueError(
                    f"failure injection requires stateless actors (init_fn "
                    f"on {stateful}): replay cannot roll back actor state")
        fstate = {name: FifoState(f) for name, f in self.g.fifos.items()}
        for a in self.g.actors.values():
            self.states[a.name] = a.init_fn() if a.init_fn else None
        fired: Dict[str, int] = {n: 0 for n in self.g.actors}
        result = SimResult(outputs={})
        sink_capture: Dict[str, List[Any]] = {a.name: [] for a in self.g.sinks()}
        # Failure mode captures sinks per frame so a replayed frame lands
        # exactly once, in frame order, no matter how often it re-fires.
        sink_by_frame: Dict[str, Dict[int, List[Any]]] = \
            {a.name: {} for a in self.g.sinks()}
        order = self.g.topo_order()
        t0 = time.perf_counter()
        src_feed = source_inputs or {}
        unit_clock = UnitClocks()
        source_names = [a.name for a in self.g.sources()]

        # Replay state: per-source queues of frames to re-fire, the time
        # each replay may start (failure observation), and attempt caps so
        # a frame that keeps dying eventually lands in frames_lost.
        src_next: Dict[str, int] = {n: 0 for n in source_names}
        replay_q: Dict[str, deque] = {n: deque() for n in source_names}
        replay_ready: Dict[int, float] = {}
        replay_attempts: Dict[int, int] = {}
        lost_frames: set = set()
        replayed_frames: List[int] = []

        def lose(frames: List[int], *, recoverable: bool, when: float,
                 what: str) -> None:
            for f in sorted({f for f in frames if f >= 0}):
                # Several token losses from one outage belong to one
                # replay round: only a *new* round (frame not already
                # queued at the sources) consumes a replay attempt.
                pending = any(f in replay_q[s] for s in source_names)
                can_retry = recoverable and (
                    pending or
                    replay_attempts.get(f, 0) < self.MAX_REPLAYS_PER_FRAME)
                if can_retry:
                    if not pending:
                        replay_attempts[f] = replay_attempts.get(f, 0) + 1
                    replay_ready[f] = max(replay_ready.get(f, 0.0), when)
                    for s in source_names:
                        if f not in replay_q[s]:
                            replay_q[s].append(f)
                    if f not in replayed_frames:
                        replayed_frames.append(f)
                else:
                    lost_frames.add(f)
                    # A permanently lost frame must not leave partial
                    # outputs behind (multi-sink graphs).
                    for by_f in sink_by_frame.values():
                        by_f.pop(f, None)
                # Whole-frame consistency: drop the frame's surviving
                # in-flight tokens everywhere, or a downstream join would
                # pair branch outputs from different frames.
                for fs in fstate.values():
                    fs.purge_frame(f)
                result.failure_log.append(
                    f"t={when:.6g} {what}: frame {f} "
                    f"{'replayed' if can_retry else 'lost'}")

        steps = 0
        progress = True
        while progress and steps < max_steps:
            progress = False
            for a in order:
                steps += 1
                frame = -1            # frame tag this firing belongs to
                is_replay = False
                if a.is_source:
                    if src_next[a.name] < num_source_firings:
                        frame = src_next[a.name]
                    elif replay_q[a.name]:
                        frame = replay_q[a.name][0]
                        is_replay = True
                    else:
                        continue
                rates = self._atr(a, fired[a.name])
                # firing rule: inputs available AND output space available
                ready = all(fstate[p.fifo.name].can_pop(rates[p.name])
                            for p in a.in_ports if p.fifo is not None)
                space = all(fstate[p.fifo.name].can_push(rates[p.name])
                            for p in a.out_ports if p.fifo is not None)
                if not (ready and space):
                    continue
                inputs = {}
                in_ready = 0.0
                tok_meta: List[Tuple[float, int]] = []
                for p in a.in_ports:
                    if p.fifo is None:
                        continue
                    toks, t_ready, meta = fstate[p.fifo.name].pop_full(
                        rates[p.name])
                    inputs[p.name] = toks
                    in_ready = max(in_ready, t_ready)
                    tok_meta.extend(meta)
                if not a.is_source and tok_meta:
                    frame = max(fr for _, fr in tok_meta)
                if is_replay:
                    in_ready = max(in_ready, replay_ready.get(frame, 0.0))
                unit = self._unit(a)
                # Concurrent per-device clocks: the firing starts once its
                # inputs have landed AND its unit is free; devices overlap.
                mstart = unit_clock.start(unit, in_ready)
                if failures is not None:
                    alive = failures.unit_next_alive(unit, mstart)
                    if alive is None:
                        # Dead forever: a source simply never fires again;
                        # buffered inputs are stranded on a dead unit.
                        if tok_meta:
                            lose([fr for _, fr in tok_meta],
                                 recoverable=False, when=mstart,
                                 what=f"unit {unit} dead (no revival), "
                                      f"tokens at {a.name} stranded")
                            progress = True
                        continue
                    if any(failures.unit_killed_between(unit, ts, alive)
                           for ts, _ in tok_meta):
                        # Unit died while these tokens sat in its FIFOs:
                        # in-flight state is gone, re-fire the frame(s)
                        # once the unit is back.
                        lose([fr for _, fr in tok_meta], recoverable=True,
                             when=alive,
                             what=f"unit {unit} died holding {a.name} inputs")
                        progress = True
                        continue
                    mstart = alive
                if a.is_source and a.name in src_feed:
                    inputs["__feed__"] = [src_feed[a.name][frame]]
                if a.is_source:
                    if is_replay:
                        replay_q[a.name].popleft()
                    else:
                        src_next[a.name] += 1
                tstart = time.perf_counter()
                if a.fire_fn is not None:
                    outputs, self.states[a.name] = a.fire_fn(
                        inputs, self.states[a.name], rates)
                else:
                    outputs = {}
                wall = time.perf_counter() - tstart
                modeled = 0.0
                if self.platform is not None:
                    modeled = self.platform.actor_time_s(unit, a)
                result.unit_busy_s[unit] = result.unit_busy_s.get(unit, 0.0) + modeled
                mfinish = mstart + modeled
                result.firings.append(FiringRecord(a.name, fired[a.name], wall,
                                                   modeled, unit,
                                                   start_s=mstart,
                                                   finish_s=mfinish))
                frame_lost_in_firing = False
                for p in a.out_ports:
                    if p.fifo is None:
                        continue
                    toks = outputs.get(p.name, [])
                    if len(toks) != rates[p.name]:
                        raise ValueError(
                            f"{a.name} produced {len(toks)} tokens on {p.name}, "
                            f"atr says {rates[p.name]} (symmetric token rate "
                            f"requirement violated)")
                    # TX/RX modeled link charge when the edge crosses units.
                    dst_unit = self._unit(p.fifo.dst.actor)
                    tok_ready = mfinish
                    if self.platform is not None and dst_unit != unit:
                        send_start = mfinish
                        if failures is not None:
                            w = failures.link_next_alive(unit, dst_unit,
                                                         mfinish)
                            if w is None:
                                lose([frame], recoverable=False, when=mfinish,
                                     what=f"link {unit}-{dst_unit} dead "
                                          f"(no revival)")
                                frame_lost_in_firing = True
                                continue
                            send_start = w
                        cpu_s, link_s, block_s, delay_s = (
                            self.platform.boundary_charge_s(
                                unit, dst_unit,
                                p.token_bytes * rates[p.name]))
                        result.link_busy_s[p.fifo.name] = (
                            result.link_busy_s.get(p.fifo.name, 0.0) + link_s)
                        result.tx_cpu_busy_s[unit] = (
                            result.tx_cpu_busy_s.get(unit, 0.0) + cpu_s)
                        tok_ready = send_start + delay_s
                        mfinish = send_start + block_s
                    if failures is not None:
                        d_alive = failures.unit_next_alive(dst_unit, tok_ready)
                        if d_alive is None:
                            lose([frame], recoverable=False, when=tok_ready,
                                 what=f"unit {dst_unit} dead (no revival), "
                                      f"token from {a.name} dropped")
                            frame_lost_in_firing = True
                            continue
                        if d_alive > tok_ready:
                            lose([frame], recoverable=True, when=d_alive,
                                 what=f"token from {a.name} landed at dead "
                                      f"unit {dst_unit}")
                            frame_lost_in_firing = True
                            continue
                    fstate[p.fifo.name].push(toks, tok_ready, frame)
                    result.modeled_makespan_s = max(result.modeled_makespan_s,
                                                    tok_ready)
                if frame_lost_in_firing:
                    # Out-ports pushed after the losing one re-introduced
                    # tokens of the lost frame: finish the whole-frame purge.
                    for fs in fstate.values():
                        fs.purge_frame(frame)
                unit_clock.set(unit, mfinish)
                result.modeled_makespan_s = max(result.modeled_makespan_s,
                                                mfinish)
                if a.is_sink:
                    # Sinks with no out ports: capture whatever fire returned
                    # under the reserved key "result".
                    if isinstance(outputs, dict) and "result" in outputs:
                        sink_capture[a.name].extend(outputs["result"])
                        sink_by_frame[a.name][frame] = list(outputs["result"])
                fired[a.name] += 1
                progress = True
        result.wall_total_s = time.perf_counter() - t0
        if failures is not None:
            # Frames the sources never (re-)fired — a source on a dead-
            # forever unit, or a replay that could not run before the
            # drain stalled — are lost too, not silently absent.
            for s in source_names:
                for f in range(src_next[s], num_source_firings):
                    lost_frames.add(f)
                for f in replay_q[s]:
                    lost_frames.add(f)
            # Likewise frames whose tokens are still stranded in FIFOs
            # when the drain stalls: they never completed.
            for fs in fstate.values():
                for f in fs.fr:
                    if f >= 0:
                        lost_frames.add(f)
        if failures is not None:
            # Frame-ordered, replay-deduplicated sink outputs.
            result.outputs = {name: [tok for f in sorted(by_f)
                                     for tok in by_f[f]]
                              for name, by_f in sink_by_frame.items()}
        else:
            result.outputs = sink_capture
        result.frames_replayed = sorted(replayed_frames)
        result.frames_lost = sorted(lost_frames)
        for a in self.g.actors.values():
            if a.deinit_fn:
                a.deinit_fn(self.states[a.name])
        return result
