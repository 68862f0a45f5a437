"""Code synthesis: graph + mapping -> executable staged program (Sec III.B-C).

A copy of ``repro.core.synthesis`` for the port.

The Edge-PRUNE compiler takes the application graph, actor behaviours, the
platform graph and a mapping file, and synthesizes a top-level application
per device; TX/RX FIFOs are inserted automatically wherever an edge crosses
the device boundary, so the application graph itself never changes.

This module is the port's analogue:

* ``split(graph, mapping)`` — partition the actor set by processing unit
  and derive the boundary *channels* (the TX/RX FIFO pairs). Pure graph
  transformation, no tensors.
* ``StagedProgram`` — an executable distributed program: one ``StageFn``
  per processing unit (a topologically-fused composition of that unit's
  actor fire functions), plus channel metadata. ``run_local`` executes
  the stages in precedence order in-process (functionally identical to
  distributed execution; the channels become tensor hand-offs: a token
  crossing a channel is the very tensor its producer returned, on the
  device it was made on, so partitioning moves no content).
* ``write_mapping_file`` / ``read_mapping_file`` — the paper's on-disk
  mapping-file workflow (the Explorer emits one pair per partition point).

Restriction (same as the paper's synthesis path): the synthesized *staged*
program assumes single-rate (HSDF) behaviour per iteration — every actor
fires once per graph iteration with atr == url == lrl == 1 on every port.
Multi-rate and variable-rate graphs are executed by the token-accurate
``Simulator``; DNN inference graphs (the paper's and ours) are single-rate.

A unit may appear *multiple times* along the dataflow: an
endpoint→server→endpoint mapping synthesizes into three stage *segments*
(maximal dependency-respecting runs of one unit), two of them on the
endpoint. Segments of the same unit share one physical busy clock in
``run_pipelined`` (they contend, never overlap), and cross-segment edges
within one unit hand tokens over for free — only genuinely cross-unit
channels are charged against the platform's links.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core.clocks import UnitClocks
from repro_torch.core.graph import Actor, Fifo, Graph
from repro_torch.core.mapping import Mapping


@dataclass(frozen=True)
class Channel:
    """A synthesis-inserted TX/RX FIFO pair crossing a unit boundary."""

    name: str
    src_unit: str
    dst_unit: str
    src_actor: str
    src_port: str
    dst_actor: str
    dst_port: str
    token_shape: Tuple[int, ...]
    token_dtype: str
    token_bytes: int


@dataclass
class Stage:
    """One stage *segment*: a maximal dependency-respecting run of actors
    on one processing unit, in precedence order. ``key`` is the segment's
    unique name — the bare unit name for a unit's first segment (so every
    pre-existing mapping keeps its stage keys), ``unit#k`` for revisits."""

    unit: str
    actors: List[Actor]
    key: str = ""
    # Channels whose dst is in this stage (RX) / src is in this stage (TX).
    rx: List[Channel] = field(default_factory=list)
    tx: List[Channel] = field(default_factory=list)


def split(g: Graph, mapping: Mapping) -> Tuple[List[Stage], List[Channel]]:
    """Partition ``g`` by the mapping; derive boundary channels.

    Stages are segments, not whole units: walking the topo order, an
    actor joins its unit's latest segment when every producer it depends
    on lives in that segment or earlier, and opens a *new* segment of the
    same unit otherwise. A mapping that visits each unit once therefore
    splits exactly as before (one stage per unit); an
    endpoint→server→endpoint mapping yields three segments instead of
    fusing the endpoint's halves into one stage that would need the
    server's output before the server ran. Channels are emitted for every
    edge crossing a *segment* boundary — cross-unit ones carry the
    platform's link charge, same-unit ones (a unit handing tokens to its
    own later segment) are free. Cyclic unit dependencies (legal in the
    MoC via delay tokens) keep declaration order, as before.
    """
    order = g.topo_order()
    stages: List[Stage] = []
    seg_of: Dict[str, int] = {}         # actor name -> segment index
    last_seg: Dict[str, int] = {}       # unit -> its latest segment index
    seg_count: Dict[str, int] = {}      # unit -> segments opened so far
    for a in order:
        u = mapping.unit_of(a.name)
        # latest segment any producer of this actor lives in (back edges
        # from delay tokens resolve later; treat them as unconstraining)
        dep = max((seg_of.get(p.fifo.src.actor.name, -1)
                   for p in a.in_ports if p.fifo is not None), default=-1)
        si = last_seg.get(u, -1)
        if si >= 0 and si >= dep:
            stages[si].actors.append(a)
            seg_of[a.name] = si
        else:
            k = seg_count.get(u, 0)
            stages.append(Stage(unit=u, actors=[a],
                                key=u if k == 0 else f"{u}#{k}"))
            seg_count[u] = k + 1
            last_seg[u] = seg_of[a.name] = len(stages) - 1

    channels: List[Channel] = []
    for f in g.fifos.values():
        src, dst = f.src.actor.name, f.dst.actor.name
        if seg_of.get(src) == seg_of.get(dst):
            continue                    # intra-segment edge: env hand-off
        su = mapping.unit_of(src)
        du = mapping.unit_of(dst)
        ch = Channel(
            name=f"ch:{f.name}", src_unit=su, dst_unit=du,
            src_actor=src, src_port=f.src.name,
            dst_actor=dst, dst_port=f.dst.name,
            token_shape=f.src.token_shape, token_dtype=f.src.token_dtype,
            token_bytes=f.token_bytes)
        channels.append(ch)
        stages[seg_of[src]].tx.append(ch)
        stages[seg_of[dst]].rx.append(ch)
    return stages, channels


class StageFn:
    """Executable form of one stage: fuses the stage's actor firings.

    Calling convention::

        outputs = stage_fn(external_inputs, rx_tokens)

    ``external_inputs`` maps source-actor name -> token (for source actors
    in this stage); ``rx_tokens`` maps channel name -> token. The return
    is ``(tx_tokens, sink_outputs)``. The body is pure (all FIFO dynamics
    are resolved at synthesis time for the single-rate case): each actor
    fires with no state, once per call.
    """

    def __init__(self, g: Graph, stage: Stage):
        self.g = g
        self.stage = stage
        self.unit = stage.unit
        self.key = stage.key or stage.unit
        self._member = {a.name for a in stage.actors}
        # Precompute wiring: for each actor input port, where does its
        # token come from (an intra-stage edge value or an RX channel)?
        self._rx_by_dst = {(c.dst_actor, c.dst_port): c for c in stage.rx}
        self._tx_by_src: Dict[Tuple[str, str], List[Channel]] = {}
        for c in stage.tx:
            self._tx_by_src.setdefault((c.src_actor, c.src_port), []).append(c)

    def __call__(self, external_inputs: Dict[str, Any],
                 rx_tokens: Dict[str, Any]
                 ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        # Value environment keyed by (actor, out_port).
        env: Dict[Tuple[str, str], Any] = {}
        tx_out: Dict[str, Any] = {}
        sink_out: Dict[str, Any] = {}
        for a in self.stage.actors:
            inputs: Dict[str, List[Any]] = {}
            for p in a.in_ports:
                if p.fifo is None:
                    continue
                key = (a.name, p.name)
                if key in self._rx_by_dst:
                    inputs[p.name] = [rx_tokens[self._rx_by_dst[key].name]]
                else:
                    src = p.fifo.src
                    inputs[p.name] = [env[(src.actor.name, src.name)]]
            if a.is_source and a.name in external_inputs:
                inputs["__feed__"] = [external_inputs[a.name]]
            rates = {p.name: 1 for p in a.in_ports + a.out_ports}
            outputs, _ = a.fire_fn(inputs, None, rates) if a.fire_fn else ({}, None)
            for p in a.out_ports:
                toks = outputs.get(p.name, [])
                if len(toks) != 1:
                    raise ValueError(
                        f"staged synthesis requires single-rate actors; "
                        f"{a.name}.{p.name} produced {len(toks)} tokens")
                env[(a.name, p.name)] = toks[0]
                for ch in self._tx_by_src.get((a.name, p.name), []):
                    tx_out[ch.name] = toks[0]
            if a.is_sink and isinstance(outputs, dict) and "result" in outputs:
                sink_out[a.name] = outputs["result"]
        return tx_out, sink_out


@dataclass
class StageExec:
    """One (frame, stage) execution in a pipelined schedule."""

    frame: int
    unit: str
    start_s: float
    finish_s: float


@dataclass
class PipelineSchedule:
    """Modeled timeline of pipelined multi-frame execution.

    ``makespan_s`` lets frame i+1 enter stage k-1 while frame i occupies
    stage k (per-unit clocks advance concurrently); ``sequential_s`` is
    the same stage/link costs with each frame draining completely before
    the next starts — the paper's non-pipelined baseline. Their ratio is
    the modeled pipelining speedup (Edge-PRUNE Sec III.B / Fig 6).
    """

    entries: List[StageExec] = field(default_factory=list)
    makespan_s: float = 0.0
    sequential_s: float = 0.0
    unit_busy_s: Dict[str, float] = field(default_factory=dict)
    # Per-frame ack instants: when frame i's last stage finished (the
    # point at which the failover controller may drop its checkpoint —
    # everything after it is replayable state, Edge-PRUNE follow-up).
    frame_done_s: List[float] = field(default_factory=list)

    @property
    def speedup(self) -> float:
        return self.sequential_s / self.makespan_s if self.makespan_s else 1.0


@dataclass
class StagedProgram:
    graph: Graph
    mapping: Mapping
    stages: List[Stage]
    channels: List[Channel]
    stage_fns: Dict[str, StageFn]

    def run_local(self, external_inputs: Dict[str, Any]) -> Dict[str, Any]:
        """Execute all stages in precedence order in-process. Functionally
        identical to distributed execution over TX/RX channels."""
        tokens: Dict[str, Any] = {}
        sinks: Dict[str, Any] = {}
        for st in self.stages:
            fn = self.stage_fns[st.key or st.unit]
            rx = {c.name: tokens[c.name] for c in st.rx}
            tx, sk = fn(external_inputs, rx)
            tokens.update(tx)
            sinks.update(sk)
        return sinks

    def run_pipelined(self, frames: List[Dict[str, Any]], *,
                      platform=None, arrivals: Optional[List[float]] = None
                      ) -> Tuple[List[Dict[str, Any]], PipelineSchedule]:
        """Execute ``frames`` (a list of ``external_inputs``) through the
        stages as a pipeline: stage k of frame i overlaps stage k-1 of
        frame i+1 on the modeled clocks.

        Outputs are token-identical to ``run_local`` per frame (stage
        functions are pure); what pipelining changes is the *modeled*
        timeline, computed against ``platform`` (a ``PlatformModel``) with
        per-unit busy clocks and per-channel link charges. Non-overlapping
        links (calibration's additive Ethernet behaviour) also block the
        sending unit for the transfer duration; overlapping links only
        delay token availability at the receiver.

        Each frame has an *ack point*: the modeled instant its final stage
        finished, recorded in ``PipelineSchedule.frame_done_s`` — the
        timestamps the resilience subsystem compares against a failure
        instant to decide which checkpointed frames are committed and
        which must replay.
        """
        if arrivals is not None and len(arrivals) != len(frames):
            raise ValueError(f"arrivals has {len(arrivals)} entries for "
                             f"{len(frames)} frames")
        arrivals = arrivals or [0.0] * len(frames)
        stage_s = [platform.stage_time_s(st.unit, st.actors)
                   if platform else 0.0 for st in self.stages]
        # clocks are per PHYSICAL unit: two segments of the same unit
        # (an endpoint→server→endpoint mapping) contend for one clock
        unit_clock = UnitClocks()
        sched = PipelineSchedule()
        sinks_per_frame: List[Dict[str, Any]] = []
        seq_clock = 0.0   # sequential baseline: one frame at a time
        for fi, frame in enumerate(frames):
            tokens: Dict[str, Any] = {}
            tok_ready: Dict[str, float] = {}
            sinks: Dict[str, Any] = {}
            frame_cost = 0.0
            frame_done = 0.0
            for si, st in enumerate(self.stages):
                ready = arrivals[fi]
                for c in st.rx:
                    ready = max(ready, tok_ready[c.name])
                start = unit_clock.start(st.unit, ready)
                finish = start + stage_s[si]
                frame_cost += stage_s[si]
                rx = {c.name: tokens[c.name] for c in st.rx}
                tx, sk = self.stage_fns[st.key or st.unit](frame, rx)
                tokens.update(tx)
                sinks.update(sk)
                for c in st.tx:
                    block_s = delay_s = 0.0
                    if platform is not None and c.src_unit != c.dst_unit:
                        _, _, block_s, delay_s = platform.boundary_charge_s(
                            c.src_unit, c.dst_unit, c.token_bytes)
                    tok_ready[c.name] = finish + delay_s
                    frame_cost += delay_s
                    finish += block_s
                unit_clock.set(st.unit, finish)
                sched.unit_busy_s[st.unit] = (
                    sched.unit_busy_s.get(st.unit, 0.0) + finish - start)
                sched.entries.append(StageExec(fi, st.unit, start, finish))
                sched.makespan_s = max(sched.makespan_s,
                                       *tok_ready.values(), finish)
                frame_done = max(frame_done, finish)
            seq_clock = max(seq_clock, arrivals[fi]) + frame_cost
            sched.frame_done_s.append(frame_done)
            sinks_per_frame.append(sinks)
        sched.sequential_s = seq_clock
        return sinks_per_frame, sched

    def comm_bytes_per_iteration(self) -> int:
        """Bytes that actually cross a device boundary per iteration —
        same-unit cross-segment hand-offs are in-memory and free."""
        return sum(c.token_bytes for c in self.channels
                   if c.src_unit != c.dst_unit)


def synthesize(g: Graph, mapping: Mapping) -> StagedProgram:
    """The Edge-PRUNE 'compiler': graph + mapping -> staged program."""
    stages, channels = split(g, mapping)
    fns = {st.key or st.unit: StageFn(g, st) for st in stages}
    return StagedProgram(g, mapping, stages, channels, fns)


def compile_local_step(g: Graph) -> Callable[[Dict[str, Any]], Dict[str, Any]]:
    """Single-unit special case: one callable running a whole iteration."""
    mapping = Mapping("local", {n: "local" for n in g.actors})
    prog = synthesize(g, mapping)
    return prog.run_local


# ---------------------------------------------------------------------------
# Mapping files on disk (the Explorer's output format, Sec III.C)
# ---------------------------------------------------------------------------

def write_mapping_file(path: str, mapping: Mapping, *, local_unit: str) -> None:
    """Write one platform-specific mapping file: every actor marked either
    'local' or 'remote' relative to ``local_unit`` — mirroring the paper's
    per-device mapping files."""
    data = {
        "mapping": mapping.name,
        "local_unit": local_unit,
        "actors": {a: ("local" if u == local_unit else "remote")
                   for a, u in mapping.assignment.items()},
        "units": mapping.assignment,
    }
    with open(path, "w") as fh:
        json.dump(data, fh, indent=2, sort_keys=True)


def read_mapping_file(path: str) -> Mapping:
    with open(path) as fh:
        data = json.load(fh)
    return Mapping(data["mapping"], data["units"])
