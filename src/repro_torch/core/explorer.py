"""Explorer: partition-point design-space exploration (Sec III.C).

A copy of ``repro.core.explorer`` for the port.

The Edge-PRUNE Explorer indexes the N actors of the application graph into
ascending precedence order and generates N mapping-file pairs (endpoint +
server) by shifting the client-server partition point actor-by-actor from
the inference input towards the inference output, plus profiling scripts
for every alternative.

This module reproduces that workflow with two evaluation backends:

* ``evaluate_modeled`` — the analytic platform model (calibrated paper
  devices or TPU pods): per-frame *endpoint inference time* =
  endpoint-mapped actor compute + boundary token transfer. This is the
  quantity plotted in the paper's Figs 4-6.
* ``evaluate_simulated`` — token-accurate simulation, actually executing
  the actor fire functions (real conv/GEMM in torch) and recording both
  the host's wall-clock and the modeled clocks.

``explore`` sweeps every partition point, optionally writes the mapping
file pairs + a profiling script (the paper's artifact set), and returns a
table of records from which benchmarks derive the figures.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.graph import Graph
from repro_torch.core.mapping import Mapping, PlatformGraph, PlatformModel
from repro_torch.core.simulator import Simulator
from repro_torch.core.synthesis import synthesize, write_mapping_file


@dataclass
class PartitionRecord:
    pp: int
    mapping_name: str
    endpoint_actors: List[str]
    boundary_bytes: int
    endpoint_compute_s: float
    transfer_s: float
    server_compute_s: float
    endpoint_time_s: float       # the Fig-4/5/6 metric
    e2e_latency_s: float         # single-frame end-to-end latency (Sec IV.D)
    wall_s: Optional[float] = None  # host clock per frame when simulated


@dataclass
class ExplorationResult:
    graph: str
    platform: str
    records: List[PartitionRecord] = field(default_factory=list)

    def best(self, *, privacy: bool = False,
             metric: str = "endpoint_time_s") -> PartitionRecord:
        """Best partition point. ``privacy=True`` excludes pp<=1 — i.e.
        configurations that ship the raw input off-device (the paper's
        privacy-preserving constraint)."""
        cands = [r for r in self.records if (r.pp > 1 if privacy else True)]
        return min(cands, key=lambda r: getattr(r, metric))

    def full_endpoint(self) -> PartitionRecord:
        return max(self.records, key=lambda r: r.pp)

    def speedup(self, *, privacy: bool = False) -> float:
        return (self.full_endpoint().endpoint_time_s /
                self.best(privacy=privacy).endpoint_time_s)


class Explorer:
    def __init__(self, g: Graph, platform: PlatformGraph,
                 *, endpoint: str = "endpoint", server: str = "server"):
        self.g = g
        self.platform = platform
        self.model = PlatformModel(platform)
        self.endpoint = endpoint
        self.server = server
        self.order = g.topo_order()

    # ------------------------------------------------------------------
    def mappings(self) -> List[Mapping]:
        """One mapping per partition point pp = 1..N (pp actors on the
        endpoint). pp=1 keeps only the input/source actor on-device (raw
        offload); pp=N is full endpoint inference."""
        n = len(self.order)
        return [Mapping.partition_point(self.g, pp, endpoint=self.endpoint,
                                        server=self.server,
                                        platform=self.platform)
                for pp in range(1, n + 1)]

    def rank_fallbacks(self, *, exclude_units: Sequence[str] = (),
                       exclude_links: Sequence[Tuple[str, str]] = ()
                       ) -> List[Mapping]:
        """Ranked fallback mappings for the resilience subsystem.

        Candidates are the partition-point family plus one all-on-a-single-
        unit mapping per platform unit (the degenerate recovery mappings —
        full endpoint inference when the server dies, raw offload when the
        endpoint's accelerator dies). A candidate survives the filter when
        it touches no unit in ``exclude_units`` and none of its boundary
        edges needs a link in ``exclude_links`` (or a link the platform
        doesn't have); survivors are ranked best-first by modeled
        single-frame end-to-end latency — computed per mapped unit (not
        just the endpoint/server pair), so mappings onto arbitrarily
        named units rank correctly. Precomputing this list at deployment
        time is the failover analogue of the Explorer's mapping-file
        artifact set.
        """
        dead_u = set(exclude_units)
        dead_l = {frozenset(p) for p in exclude_links}
        candidates: List[Mapping] = list(self.mappings())
        for u in self.platform.units:
            candidates.append(Mapping(f"{self.g.name}-all-{u}",
                                      {n: u for n in self.g.actors},
                                      self.platform))
        seen: set = set()
        ranked: List[Tuple[float, Mapping]] = []
        for m in candidates:
            key = tuple(sorted(m.assignment.items()))
            if key in seen:
                continue
            seen.add(key)
            if dead_u & set(m.units_used()):
                continue
            pairs = {frozenset((m.unit_of(f.src.actor.name),
                                m.unit_of(f.dst.actor.name)))
                     for f in m.boundary_edges(self.g)}
            if any(p in dead_l or self.platform.links.get(p) is None
                   for p in pairs):
                continue
            ranked.append((self._e2e_latency_s(m), m))
        ranked.sort(key=lambda t: t[0])
        return [m for _, m in ranked]

    def _e2e_latency_s(self, m: Mapping) -> float:
        """Modeled single-frame end-to-end latency of an arbitrary
        mapping: every actor's compute on its assigned unit, plus every
        boundary channel's wire time, link latency, and sender-side TX
        CPU cost (nothing overlaps within one frame, Sec IV.D)."""
        prog = synthesize(self.g, m)
        t = sum(self.model.actor_time_s(m.unit_of(a.name), a)
                for a in self.order)
        t += sum(self.model.transfer_time_s(c.src_unit, c.dst_unit,
                                            c.token_bytes)
                 for c in prog.channels)
        t += sum(self.model.tx_cpu_time_s(c.src_unit, c.token_bytes)
                 for c in prog.channels)
        return t

    def generate_artifacts(self, outdir: str) -> List[str]:
        """Write the paper's artifact set: per-partition-point mapping file
        pairs (endpoint-side + server-side) and a profiling script."""
        os.makedirs(outdir, exist_ok=True)
        paths: List[str] = []
        for pp, m in enumerate(self.mappings(), start=1):
            for side, unit in (("endpoint", self.endpoint), ("server", self.server)):
                p = os.path.join(outdir, f"pp{pp:02d}.{side}.mapping.json")
                write_mapping_file(p, m, local_unit=unit)
                paths.append(p)
        script = os.path.join(outdir, "profile_all.sh")
        with open(script, "w") as fh:
            fh.write("#!/bin/sh\n# Auto-generated by the Edge-PRUNE Explorer.\n")
            fh.write("# Profiles every partition-point mapping alternative.\n")
            for pp in range(1, len(self.order) + 1):
                fh.write(
                    f"python -m repro.launch.profile_mapping --graph {self.g.name} "
                    f"--mapping pp{pp:02d} --frames \"$1\"\n")
        os.chmod(script, 0o755)
        paths.append(script)
        return paths

    # ------------------------------------------------------------------
    def _modeled_record(self, pp: int, m: Mapping) -> PartitionRecord:
        prog = synthesize(self.g, m)
        endpoint_actors = [a.name for a in self.order
                           if m.unit_of(a.name) == self.endpoint]
        ep_s = sum(self.model.actor_time_s(self.endpoint, a)
                   for a in self.order if m.unit_of(a.name) == self.endpoint)
        sv_s = sum(self.model.actor_time_s(self.server, a)
                   for a in self.order if m.unit_of(a.name) == self.server)
        # Split boundary traffic by link semantics: additive links charge
        # the endpoint's per-frame budget; overlapping links (buffered
        # sockets) pipeline against compute -> max() combining.
        tx_add = sum(self.model.transfer_bw_time_s(c.src_unit, c.dst_unit,
                                                   c.token_bytes)
                     for c in prog.channels
                     if not self.model.link_overlaps(c.src_unit, c.dst_unit))
        tx_ovl = sum(self.model.transfer_bw_time_s(c.src_unit, c.dst_unit,
                                                   c.token_bytes)
                     for c in prog.channels
                     if self.model.link_overlaps(c.src_unit, c.dst_unit))
        lat = sum(self.model.transfer_time_s(c.src_unit, c.dst_unit, 0)
                  for c in prog.channels)
        # Sender-side CPU cost (GPU readback + socket syscalls) never
        # overlaps: it is charged to the endpoint's per-frame budget.
        tx_cpu = sum(self.model.tx_cpu_time_s(c.src_unit, c.token_bytes)
                     for c in prog.channels if c.src_unit == self.endpoint)
        endpoint_time = max(ep_s + tx_add + tx_cpu, tx_ovl)
        return PartitionRecord(
            pp=pp, mapping_name=m.name, endpoint_actors=endpoint_actors,
            boundary_bytes=prog.comm_bytes_per_iteration(),
            endpoint_compute_s=ep_s, transfer_s=tx_add + tx_ovl,
            server_compute_s=sv_s,
            # Fig 4-6 metric: what the endpoint spends per frame.
            endpoint_time_s=endpoint_time,
            # Single-frame latency: nothing overlaps (Sec IV.D).
            e2e_latency_s=ep_s + tx_add + tx_ovl + tx_cpu + lat + sv_s)

    def evaluate_modeled(self) -> ExplorationResult:
        res = ExplorationResult(self.g.name, self.platform.name)
        for pp, m in enumerate(self.mappings(), start=1):
            res.records.append(self._modeled_record(pp, m))
        return res

    def evaluate_simulated(self, frames: int,
                           source_inputs: Optional[Dict[str, List[Any]]] = None
                           ) -> ExplorationResult:
        """Token-accurate simulation: actually fires the actors (real torch
        compute on their device) at every partition point; ``wall_s``
        is the host's clock per frame, not device time."""
        res = ExplorationResult(self.g.name, self.platform.name)
        for pp, m in enumerate(self.mappings(), start=1):
            sim = Simulator(self.g, mapping=m, platform=self.model)
            out = sim.run(frames, source_inputs=source_inputs)
            rec = self._modeled_record(pp, m)
            rec.wall_s = out.wall_total_s / max(frames, 1)
            res.records.append(rec)
        return res
