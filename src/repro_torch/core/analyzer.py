"""Graph analyzer: VR-PRUNE design-rule and consistency checks (Sec III.C).

A copy of ``repro.core.analyzer`` for the port.

The paper's Analyzer checks the application graph against the VR-PRUNE
design rules and patterns so that DPGs are compile-time analyzable for
*consistency*: absence of deadlock and buffer overflow. This module
implements:

1. structural rules (port wiring, symmetric token-rate requirement on the
   static limits, DPG composition: 1 CA + 2 DAs + DPAs/SPAs, dynamic actor
   types only inside DPGs);
2. SDF-style *balance equations* over the static-rate skeleton to compute
   the repetition vector (consistency ⇒ bounded buffers);
3. bounded-buffer verification for a computed periodic schedule;
4. deadlock detection: every directed cycle must carry enough initial
   delay tokens to fire once.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from fractions import Fraction
from typing import Dict, List, Optional

from repro_torch.core.graph import Actor, ActorType, Fifo, Graph


@dataclass
class AnalysisReport:
    ok: bool
    errors: List[str] = field(default_factory=list)
    warnings: List[str] = field(default_factory=list)
    repetition_vector: Optional[Dict[str, int]] = None
    max_buffer_occupancy: Optional[Dict[str, int]] = None

    def raise_on_error(self) -> "AnalysisReport":
        if not self.ok:
            raise ValueError("graph analysis failed:\n  " + "\n  ".join(self.errors))
        return self


def _check_structure(g: Graph, errors: List[str], warnings: List[str]) -> None:
    # Every port connected; every fifo endpoints attached.
    for a in g.actors.values():
        for p in a.in_ports + a.out_ports:
            if p.fifo is None and not (a.is_source and not a.in_ports):
                # Dangling OUT ports on sinks / IN ports on sources are the
                # only holes a valid app graph may not have.
                errors.append(f"dangling port {a.name}.{p.name}")
    # Dynamic actor types must live inside a DPG.
    for a in g.actors.values():
        if a.actor_type in (ActorType.DA, ActorType.DPA, ActorType.CA) and a.dpg is None:
            errors.append(
                f"{a.actor_type.value.upper()} actor {a.name} is outside any DPG "
                f"(VR-PRUNE rule: DAs, DPAs and CAs may only appear within DPGs)")
    # DPG composition rule: one CA, two DAs.
    for dpg in g.dpgs.values():
        members = [g.actors[m] for m in dpg.members]
        cas = [a for a in members if a.actor_type == ActorType.CA]
        das = [a for a in members if a.actor_type == ActorType.DA]
        if len(cas) != 1:
            errors.append(f"DPG {dpg.name}: must contain exactly 1 CA, found {len(cas)}")
        elif cas[0].name != dpg.ca:
            errors.append(f"DPG {dpg.name}: declared CA {dpg.ca} != actual {cas[0].name}")
        if len(das) != 2:
            errors.append(f"DPG {dpg.name}: must contain exactly 2 DAs, found {len(das)}")
        else:
            if {dpg.entry_da, dpg.exit_da} != {d.name for d in das}:
                errors.append(f"DPG {dpg.name}: entry/exit DA declaration mismatch")
        for a in members:
            if a.actor_type not in (ActorType.CA, ActorType.DA, ActorType.DPA, ActorType.SPA):
                errors.append(f"DPG {dpg.name}: illegal member type {a.actor_type}")
            if a.dpg != dpg.name:
                errors.append(f"DPG {dpg.name}: member {a.name} tagged with dpg={a.dpg}")
        # Variable-rate ports of boundary DAs must face *into* the DPG: the
        # external faces keep static rates so the enclosing graph stays SDF.
        member_set = set(dpg.members)
        for da_name in (dpg.entry_da, dpg.exit_da):
            if da_name not in g.actors:
                errors.append(f"DPG {dpg.name}: unknown DA {da_name}")
                continue
            da = g.actors[da_name]
            for p in da.in_ports + da.out_ports:
                if p.fifo is None:
                    continue
                other = (p.fifo.dst.actor if p is p.fifo.src else p.fifo.src.actor)
                crosses = other.name not in member_set
                if crosses and not p.is_static_rate:
                    errors.append(
                        f"DPG {dpg.name}: DA {da.name} port {p.name} crosses the "
                        f"DPG boundary but has a variable rate ({p.lrl}..{p.url}); "
                        f"boundary-facing ports must be static-rate")
    # Symmetric token-rate requirement — static limits must agree per edge
    # (atr symmetry is enforced at run time by the simulator/runtime).
    for f in g.fifos.values():
        if (f.src.lrl, f.src.url) != (f.dst.lrl, f.dst.url):
            # Rates may legitimately differ in SDF (multi-rate); the
            # *symmetric token rate requirement* applies to variable-rate
            # (DPG-internal) edges where atr(src)==atr(dst) must hold.
            src_dyn = not f.src.is_static_rate
            dst_dyn = not f.dst.is_static_rate
            if src_dyn or dst_dyn:
                errors.append(
                    f"edge {f.name}: variable-rate endpoints must carry identical "
                    f"rate limits (symmetric token rate requirement), got "
                    f"src=({f.src.lrl},{f.src.url}) dst=({f.dst.lrl},{f.dst.url})")


def repetition_vector(g: Graph) -> Dict[str, int]:
    """Solve the SDF balance equations over the static-rate skeleton.

    For each edge ``a --(prod r_a)--> (cons r_b)-- b`` consistency requires
    ``q[a] * r_a == q[b] * r_b``. Variable-rate edges are balanced at their
    upper rate limit (worst case for buffer sizing), which is sound because
    the symmetric token rate requirement forces atr(src)==atr(dst) — a
    variable-rate edge is *always* balanced token-for-token at run time.
    """
    q: Dict[str, Fraction] = {}
    adj: Dict[str, List[Fifo]] = {n: [] for n in g.actors}
    for f in g.fifos.values():
        adj[f.src.actor.name].append(f)
        adj[f.dst.actor.name].append(f)

    for start in g.actors:
        if start in q:
            continue
        q[start] = Fraction(1)
        stack = [start]
        while stack:
            n = stack.pop()
            for f in adj[n]:
                a, b = f.src.actor.name, f.dst.actor.name
                ra = max(f.src.url, 1)
                rb = max(f.dst.url, 1)
                if a in q and b not in q:
                    q[b] = q[a] * ra / rb
                    stack.append(b)
                elif b in q and a not in q:
                    q[a] = q[b] * rb / ra
                    stack.append(a)
                elif a in q and b in q:
                    if q[a] * ra != q[b] * rb:
                        raise ValueError(
                            f"graph {g.name} is inconsistent at edge {f.name}: "
                            f"{q[a]}*{ra} != {q[b]}*{rb} — no bounded-memory "
                            f"periodic schedule exists")
    # Scale to smallest integer vector.
    from math import lcm
    denom = 1
    for v in q.values():
        denom = lcm(denom, v.denominator)
    iq = {n: int(v * denom) for n, v in q.items()}
    from math import gcd
    gg = 0
    for v in iq.values():
        gg = gcd(gg, v)
    return {n: v // max(gg, 1) for n, v in iq.items()}


def check_deadlock(g: Graph, errors: List[str]) -> None:
    """Every directed cycle must contain initial delay tokens."""
    # Collapse to actor-level digraph; find SCCs (Tarjan); any SCC with >1
    # node or a self-loop must have at least one delay-carrying edge.
    index = 0
    idx: Dict[str, int] = {}
    low: Dict[str, int] = {}
    onstack: Dict[str, bool] = {}
    stack: List[str] = []
    sccs: List[List[str]] = []
    succ: Dict[str, List[str]] = {n: [] for n in g.actors}
    for f in g.fifos.values():
        succ[f.src.actor.name].append(f.dst.actor.name)

    def strongconnect(v: str) -> None:
        nonlocal index
        work = [(v, iter(succ[v]))]
        idx[v] = low[v] = index
        index += 1
        stack.append(v)
        onstack[v] = True
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in idx:
                    idx[w] = low[w] = index
                    index += 1
                    stack.append(w)
                    onstack[w] = True
                    work.append((w, iter(succ[w])))
                    advanced = True
                    break
                elif onstack.get(w):
                    low[node] = min(low[node], idx[w])
            if advanced:
                continue
            work.pop()
            if work:
                low[work[-1][0]] = min(low[work[-1][0]], low[node])
            if low[node] == idx[node]:
                comp = []
                while True:
                    w = stack.pop()
                    onstack[w] = False
                    comp.append(w)
                    if w == node:
                        break
                sccs.append(comp)

    for n in g.actors:
        if n not in idx:
            strongconnect(n)

    for comp in sccs:
        cset = set(comp)
        internal = [f for f in g.fifos.values()
                    if f.src.actor.name in cset and f.dst.actor.name in cset]
        has_cycle = len(comp) > 1 or any(
            f.src.actor.name == f.dst.actor.name for f in internal)
        if has_cycle and not any(f.delay_tokens > 0 for f in internal):
            errors.append(
                f"deadlock: cycle through {sorted(cset)} carries no initial "
                f"delay tokens — no actor in the cycle can ever fire")


def check_buffer_bounds(g: Graph, rep: Dict[str, int],
                        errors: List[str]) -> Dict[str, int]:
    """Simulate one periodic iteration symbolically (token *counts* only,
    worst-case rates) and verify no FIFO exceeds its declared capacity."""
    remaining = dict(rep)
    occupancy = {f.name: f.delay_tokens for f in g.fifos.values()}
    peak = dict(occupancy)
    progress = True
    while any(v > 0 for v in remaining.values()) and progress:
        progress = False
        for a in g.topo_order():
            if remaining[a.name] <= 0:
                continue
            fires = remaining[a.name]
            for _ in range(fires):
                if not all(occupancy[p.fifo.name] >= p.url
                           for p in a.in_ports if p.fifo is not None):
                    break
                for p in a.in_ports:
                    if p.fifo is not None:
                        occupancy[p.fifo.name] -= p.url
                for p in a.out_ports:
                    if p.fifo is not None:
                        occupancy[p.fifo.name] += p.url
                        peak[p.fifo.name] = max(peak[p.fifo.name],
                                                occupancy[p.fifo.name])
                remaining[a.name] -= 1
                progress = True
    for f in g.fifos.values():
        if peak[f.name] > f.capacity:
            errors.append(
                f"buffer overflow: fifo {f.name} peaks at {peak[f.name]} tokens "
                f"but capacity is {f.capacity}")
    return peak


def analyze(g: Graph) -> AnalysisReport:
    """Run the full VR-PRUNE consistency analysis."""
    errors: List[str] = []
    warnings: List[str] = []
    _check_structure(g, errors, warnings)
    rep = None
    peak = None
    if not errors:
        try:
            rep = repetition_vector(g)
        except ValueError as e:
            errors.append(str(e))
        check_deadlock(g, errors)
        if rep is not None and not errors:
            peak = check_buffer_bounds(g, rep, errors)
    return AnalysisReport(ok=not errors, errors=errors, warnings=warnings,
                          repetition_vector=rep, max_buffer_occupancy=peak)
