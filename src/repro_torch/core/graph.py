"""VR-PRUNE dataflow model of computation (Edge-PRUNE, Sec III.A).

A copy of ``repro.core.graph`` for the port.

A DNN application is a directed graph ``G = (A, F)``: nodes ``A`` are
*actors* (computation, e.g. groups of DNN layers) and edges ``F`` are FIFO
buffers carrying *tokens* (tensors) in first-in-first-out order.

Token-rate semantics
--------------------
Every port ``p`` carries three non-negative integers::

    lrl(p) <= atr(p) <= url(p)

``lrl`` (lower rate limit) and ``url`` (upper rate limit) are fixed at
design time; ``atr`` (active token rate) may be set before each firing of
``parent(p)`` — but only inside dynamic processing subgraphs (DPGs), and
subject to the *symmetric token rate requirement*: for every edge
``f = fifo(p_a) = fifo(p_b)`` it must hold that ``atr(p_a) == atr(p_b)``.

Actor taxonomy (Sec III.A):

* ``SPA``  static processing actor — fixed rates (lrl == url on all ports).
* ``DA``   dynamic actor — DPG boundary actor implementing rate variability.
* ``CA``   configuration actor — sets the current token rate within a DPG.
* ``DPA``  dynamic processing actor — variable-rate compute inside a DPG.

DAs, DPAs and CAs may only appear inside DPGs; a DPG consists of exactly
one CA, exactly two DAs (entry + exit), and any number of DPAs/SPAs.
Well-formed DPGs are compile-time analyzable for consistency (absence of
deadlock / buffer overflow) — see ``analyzer.py``.

Distribution (Sec III.B): the application graph never changes for
distributed execution. TX/RX FIFO pairs are inserted automatically at
synthesis time wherever an edge crosses a device boundary (``synthesis.py``).
"""
from __future__ import annotations

import enum
import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple


class ActorType(enum.Enum):
    SPA = "spa"  # static processing actor
    DA = "da"    # dynamic (DPG boundary) actor
    CA = "ca"    # configuration actor
    DPA = "dpa"  # dynamic processing actor


class PortDir(enum.Enum):
    IN = "in"
    OUT = "out"


@dataclass
class Port:
    """Connection point between an edge and an actor.

    ``token_shape``/``token_dtype`` describe one token (one tensor). The
    byte size of a token — used by the explorer's communication model and
    reported in the paper's Fig. 2/3 — is ``token_bytes``.
    """

    name: str
    direction: PortDir
    lrl: int = 1
    url: int = 1
    token_shape: Tuple[int, ...] = ()
    token_dtype: str = "float32"
    # Set by the framework when the port is attached.
    actor: Optional["Actor"] = field(default=None, repr=False)
    fifo: Optional["Fifo"] = field(default=None, repr=False)

    def __post_init__(self) -> None:
        if not (0 <= self.lrl <= self.url):
            raise ValueError(
                f"port {self.name}: rate limits must satisfy 0 <= lrl <= url, "
                f"got lrl={self.lrl} url={self.url}")

    @property
    def is_static_rate(self) -> bool:
        return self.lrl == self.url

    @property
    def token_bytes(self) -> int:
        itemsize = {"float32": 4, "bfloat16": 2, "float16": 2, "int32": 4,
                    "int8": 1, "uint8": 1, "bool": 1, "int64": 8,
                    "float64": 8}.get(self.token_dtype)
        if itemsize is None:
            raise ValueError(f"unknown dtype {self.token_dtype}")
        return itemsize * int(math.prod(self.token_shape)) if self.token_shape else itemsize


def parent(port: Port) -> "Actor":
    """``parent(p)`` from the paper: the actor owning port ``p``."""
    if port.actor is None:
        raise ValueError(f"port {port.name} is not attached to an actor")
    return port.actor


def fifo(port: Port) -> "Fifo":
    """``fifo(p)`` from the paper: the edge connected to port ``p``."""
    if port.fifo is None:
        raise ValueError(f"port {port.name} is not connected to a fifo")
    return port.fifo


@dataclass
class Actor:
    """A dataflow actor: computation triggered by input-token availability.

    ``fire_fn(inputs, state, atr) -> (outputs, state)`` implements the
    firing behaviour: ``inputs`` maps input-port name -> list of tokens
    (length == the port's active token rate), and it must return one list
    of tokens per output port. ``init_fn() -> state`` and ``deinit_fn``
    mirror the paper's initialization / deinitialization behaviours.
    """

    name: str
    actor_type: ActorType = ActorType.SPA
    in_ports: List[Port] = field(default_factory=list)
    out_ports: List[Port] = field(default_factory=list)
    fire_fn: Optional[Callable[..., Any]] = field(default=None, repr=False)
    init_fn: Optional[Callable[[], Any]] = field(default=None, repr=False)
    deinit_fn: Optional[Callable[[Any], None]] = field(default=None, repr=False)
    # DPG membership (None for actors outside any dynamic subgraph).
    dpg: Optional[str] = None
    # Estimated MACs/FLOPs per firing, used by the explorer cost model.
    cost_flops: float = 0.0
    # Bytes of parameter/weight traffic per firing (roofline memory term).
    cost_mem_bytes: float = 0.0
    # Arbitrary metadata (e.g. which DNN layers this actor encapsulates).
    meta: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self) -> None:
        for p in self.in_ports:
            if p.direction != PortDir.IN:
                raise ValueError(f"{self.name}: {p.name} in in_ports is not IN")
            p.actor = self
        for p in self.out_ports:
            if p.direction != PortDir.OUT:
                raise ValueError(f"{self.name}: {p.name} in out_ports is not OUT")
            p.actor = self
        names = [p.name for p in self.in_ports + self.out_ports]
        if len(names) != len(set(names)):
            raise ValueError(f"{self.name}: duplicate port names {names}")
        if self.actor_type == ActorType.SPA:
            for p in self.in_ports + self.out_ports:
                if not p.is_static_rate:
                    raise ValueError(
                        f"SPA {self.name} has variable-rate port {p.name} "
                        f"(lrl={p.lrl} != url={p.url}); only DA/DPA/CA ports "
                        f"inside DPGs may vary")

    def port(self, name: str) -> Port:
        for p in self.in_ports + self.out_ports:
            if p.name == name:
                return p
        raise KeyError(f"{self.name} has no port {name}")

    @property
    def is_source(self) -> bool:
        return not self.in_ports

    @property
    def is_sink(self) -> bool:
        return not self.out_ports


class FifoKind(enum.Enum):
    LOCAL = "local"      # ordinary in-memory FIFO
    TRANSMIT = "tx"      # boundary-crossing sender half (synthesis-inserted)
    RECEIVE = "rx"       # boundary-crossing receiver half (synthesis-inserted)


@dataclass
class Fifo:
    """A FIFO buffer edge with a fixed token ``capacity``.

    ``src`` is an OUT port, ``dst`` an IN port. TX/RX FIFOs (Sec III.B) are
    never authored by the user — ``synthesis.py`` splits a LOCAL fifo into a
    TX/RX pair when the mapping places ``src`` and ``dst`` on different
    devices. ``delay_tokens`` are initial tokens (dataflow "delays"),
    required on feedback edges for deadlock-freedom.
    """

    name: str
    src: Port
    dst: Port
    capacity: int = 2
    kind: FifoKind = FifoKind.LOCAL
    delay_tokens: int = 0

    def __post_init__(self) -> None:
        if self.src.direction != PortDir.OUT:
            raise ValueError(f"fifo {self.name}: src must be an OUT port")
        if self.dst.direction != PortDir.IN:
            raise ValueError(f"fifo {self.name}: dst must be an IN port")
        if self.capacity < 1:
            raise ValueError(f"fifo {self.name}: capacity must be >= 1")
        self.src.fifo = self
        self.dst.fifo = self

    @property
    def token_bytes(self) -> int:
        return self.src.token_bytes


@dataclass
class Dpg:
    """A dynamic processing subgraph: 1 CA, 2 DAs, any number of DPAs/SPAs."""

    name: str
    ca: str                 # configuration actor name
    entry_da: str           # DA at the DPG entry
    exit_da: str            # DA at the DPG exit
    members: List[str]      # all actor names inside the DPG (incl. above)


class Graph:
    """Application graph ``G = (A, F)`` with DPG annotations."""

    def __init__(self, name: str):
        self.name = name
        self.actors: Dict[str, Actor] = {}
        self.fifos: Dict[str, Fifo] = {}
        self.dpgs: Dict[str, Dpg] = {}

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    def add_actor(self, actor: Actor) -> Actor:
        if actor.name in self.actors:
            raise ValueError(f"duplicate actor {actor.name}")
        self.actors[actor.name] = actor
        return actor

    def connect(self, src: Port, dst: Port, *, capacity: int = 2,
                name: Optional[str] = None, delay_tokens: int = 0) -> Fifo:
        if src.token_shape != dst.token_shape or src.token_dtype != dst.token_dtype:
            raise ValueError(
                f"token type mismatch on edge {src.actor.name}.{src.name} -> "
                f"{dst.actor.name}.{dst.name}: {src.token_shape}/{src.token_dtype}"
                f" vs {dst.token_shape}/{dst.token_dtype}")
        fname = name or f"{src.actor.name}.{src.name}->{dst.actor.name}.{dst.name}"
        if fname in self.fifos:
            raise ValueError(f"duplicate fifo {fname}")
        f = Fifo(fname, src, dst, capacity=capacity, delay_tokens=delay_tokens)
        self.fifos[fname] = f
        return f

    def add_dpg(self, dpg: Dpg) -> Dpg:
        if dpg.name in self.dpgs:
            raise ValueError(f"duplicate DPG {dpg.name}")
        self.dpgs[dpg.name] = dpg
        for member in dpg.members:
            self.actors[member].dpg = dpg.name
        return dpg

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------
    def in_edges(self, actor: Actor) -> List[Fifo]:
        return [p.fifo for p in actor.in_ports if p.fifo is not None]

    def out_edges(self, actor: Actor) -> List[Fifo]:
        return [p.fifo for p in actor.out_ports if p.fifo is not None]

    def predecessors(self, actor: Actor) -> List[Actor]:
        return [f.src.actor for f in self.in_edges(actor)]

    def successors(self, actor: Actor) -> List[Actor]:
        return [f.dst.actor for f in self.out_edges(actor)]

    def sources(self) -> List[Actor]:
        return [a for a in self.actors.values() if a.is_source]

    def sinks(self) -> List[Actor]:
        return [a for a in self.actors.values() if a.is_sink]

    def topo_order(self, *, ignore_delay_edges: bool = True) -> List[Actor]:
        """Topological order of actors (Kahn). Edges carrying initial delay
        tokens are feedback edges and are excluded from the precedence
        relation (they do not constrain the first firing)."""
        indeg: Dict[str, int] = {n: 0 for n in self.actors}
        adj: Dict[str, List[str]] = {n: [] for n in self.actors}
        for f in self.fifos.values():
            if ignore_delay_edges and f.delay_tokens > 0:
                continue
            adj[f.src.actor.name].append(f.dst.actor.name)
            indeg[f.dst.actor.name] += 1
        queue = sorted(n for n, d in indeg.items() if d == 0)
        order: List[Actor] = []
        while queue:
            n = queue.pop(0)
            order.append(self.actors[n])
            for m in adj[n]:
                indeg[m] -= 1
                if indeg[m] == 0:
                    # insertion sort to keep deterministic order
                    import bisect
                    bisect.insort(queue, m)
        if len(order) != len(self.actors):
            cyclic = set(self.actors) - {a.name for a in order}
            raise ValueError(
                f"graph {self.name} has a zero-delay cycle through {sorted(cyclic)}; "
                f"add delay tokens on a feedback edge")
        return order

    def precedence_index(self) -> Dict[str, int]:
        """Ascending precedence index per actor — the ordering the Explorer
        uses to enumerate partition points (Sec III.C, 'Explorer')."""
        return {a.name: i for i, a in enumerate(self.topo_order())}

    # ------------------------------------------------------------------
    # convenience constructors
    # ------------------------------------------------------------------
    @staticmethod
    def chain(name: str, stages: Sequence[Tuple[str, Callable, Tuple[int, ...]]],
              *, dtype: str = "float32", input_shape: Tuple[int, ...] = (),
              costs: Optional[Sequence[float]] = None) -> "Graph":
        """Build a simple chain graph: source -> stage1 -> ... -> sink-ish.

        ``stages`` is a list of (actor_name, fire_fn, output_token_shape).
        ``fire_fn`` receives a single token and returns a single token.
        The first stage consumes tokens of ``input_shape``.
        """
        g = Graph(name)
        prev_shape = input_shape
        prev_out: Optional[Port] = None
        for i, (aname, fn, oshape) in enumerate(stages):
            inp = [] if prev_out is None else [
                Port("in", PortDir.IN, token_shape=prev_shape, token_dtype=dtype)]
            outp = [Port("out", PortDir.OUT, token_shape=oshape, token_dtype=dtype)]

            def make_fire(fn):
                def fire(inputs, state, atr):
                    if inputs:
                        (tok,) = inputs["in"]
                        return {"out": [fn(tok)]}, state
                    return {"out": [fn()]}, state
                return fire

            a = Actor(aname, ActorType.SPA, inp, outp, fire_fn=make_fire(fn),
                      cost_flops=(costs[i] if costs else 0.0))
            g.add_actor(a)
            if prev_out is not None:
                g.connect(prev_out, a.port("in"))
            prev_out = a.port("out")
            prev_shape = oshape
        return g

    def __repr__(self) -> str:
        return (f"Graph({self.name!r}, actors={len(self.actors)}, "
                f"fifos={len(self.fifos)}, dpgs={len(self.dpgs)})")
