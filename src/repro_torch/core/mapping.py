"""Platform graph + mapping files (Edge-PRUNE Sec III.C) and device models.

A copy of ``repro.core.mapping`` for the port. Its platforms are
modeled ones: the paper's N2 / N270 / i7 devices and links
(``paper_platform``) and the reference's TPU pods
(``tpu_pod_platform``). None of their rates is a measurement of the
port or of the GPU it runs on.

Edge-PRUNE requires, besides the application graph, (a) an undirected
*platform graph* listing processing units and their interconnections, and
(b) a *mapping file* assigning each actor to exactly one processing unit.
Only the mapping file changes between distributed scenarios.

``PlatformModel`` additionally carries analytic device/link constants so
the Explorer can *model* execution time on hardware we do not have (the
paper's N2 / N270 / i7 devices, and TPU v5e pods). Constants for the
paper's platforms are calibrated in ``repro_torch.core.calibration`` from the
paper's own measurements (Tables I-II, Figs 4-6).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Tuple


@dataclass(frozen=True)
class ProcessingUnit:
    name: str
    kind: str = "cpu"             # cpu | gpu | tpu
    flops: float = 1e9            # effective sustained FLOP/s for conv/gemm
    mem_bandwidth: float = 1e9    # bytes/s effective weight-read bandwidth
    firing_overhead_s: float = 0.0  # thread wakeup / kernel launch per firing
    # CPU-side cost of *sending* one byte off-device (GPU buffer readback +
    # socket syscalls); charged to the sender on top of link time.
    tx_cost_per_byte: float = 0.0


@dataclass(frozen=True)
class Link:
    a: str
    b: str
    bandwidth: float              # bytes/s (measured throughput, Table II)
    latency_s: float = 0.0
    # overlap=True: transfers overlap with endpoint compute (DMA/socket
    # buffering), so per-frame time is max(compute, tx) instead of
    # compute + tx. Calibration shows the paper's WiFi runs behave this
    # way while the (CPU-bound) 100 Mbit Ethernet path is additive.
    overlap: bool = False

    @property
    def key(self) -> FrozenSet[str]:
        return frozenset((self.a, self.b))


@dataclass
class PlatformGraph:
    """Undirected platform graph: processing units + interconnections."""

    name: str
    units: Dict[str, ProcessingUnit] = field(default_factory=dict)
    links: Dict[FrozenSet[str], Link] = field(default_factory=dict)

    def add_unit(self, u: ProcessingUnit) -> "PlatformGraph":
        self.units[u.name] = u
        return self

    def add_link(self, link: Link) -> "PlatformGraph":
        if link.a not in self.units or link.b not in self.units:
            raise ValueError(f"link {link.a}-{link.b} references unknown unit")
        self.links[link.key] = link
        return self

    def link_between(self, a: str, b: str) -> Optional[Link]:
        return self.links.get(frozenset((a, b)))


@dataclass
class PlatformModel:
    """Analytic roofline-style execution model on a platform graph:

        t_actor = overhead + max(flops / FLOPS, weight_bytes / MEM_BW)
    """

    platform: PlatformGraph

    def compute_time_s(self, unit: str, flops: float,
                       mem_bytes: float = 0.0) -> float:
        u = self.platform.units[unit]
        return u.firing_overhead_s + max(flops / u.flops,
                                         mem_bytes / u.mem_bandwidth)

    def actor_time_s(self, unit: str, actor) -> float:
        """Per-actor modeled time. An actor may pin calibrated wall times
        per unit in ``meta['unit_time_s']`` (used for the SSD-Mobilenet
        actors whose OpenCL depthwise/NMS/tracking costs do not follow a
        single per-device FLOP rate); otherwise the roofline formula."""
        pinned = actor.meta.get("unit_time_s") if actor.meta else None
        if pinned and unit in pinned:
            return pinned[unit]
        return self.compute_time_s(unit, actor.cost_flops, actor.cost_mem_bytes)

    def stage_time_s(self, unit: str, actors) -> float:
        """Modeled time for one pipeline stage: every actor mapped to
        ``unit`` firing once (one graph iteration's worth of work)."""
        return sum(self.actor_time_s(unit, a) for a in actors)

    def transfer_bw_time_s(self, src_unit: str, dst_unit: str,
                           nbytes: int) -> float:
        if src_unit == dst_unit:
            return 0.0
        link = self.platform.link_between(src_unit, dst_unit)
        if link is None:
            raise ValueError(f"no link between {src_unit} and {dst_unit}")
        return nbytes / link.bandwidth

    def transfer_time_s(self, src_unit: str, dst_unit: str, nbytes: int) -> float:
        if src_unit == dst_unit:
            return 0.0
        link = self.platform.link_between(src_unit, dst_unit)
        if link is None:
            raise ValueError(f"no link between {src_unit} and {dst_unit}")
        return link.latency_s + nbytes / link.bandwidth

    def link_overlaps(self, src_unit: str, dst_unit: str) -> bool:
        link = self.platform.link_between(src_unit, dst_unit)
        return bool(link and link.overlap)

    def tx_cpu_time_s(self, src_unit: str, nbytes: int) -> float:
        return self.platform.units[src_unit].tx_cost_per_byte * nbytes

    def boundary_charge_s(self, src_unit: str, dst_unit: str,
                          nbytes: int) -> Tuple[float, float, float, float]:
        """The single source of truth for how a cross-unit transfer is
        charged on pipelined clocks. Returns ``(cpu_s, link_s,
        sender_block_s, token_delay_s)`` relative to the sender's compute
        finish: the sender stays busy for its CPU readback/syscall cost
        plus — on additive (non-overlapping) links — the wire time; the
        token lands at the receiver after CPU + wire time either way."""
        link_s = self.transfer_time_s(src_unit, dst_unit, nbytes)
        cpu_s = self.tx_cpu_time_s(src_unit, nbytes)
        block_s = cpu_s + (0.0 if self.link_overlaps(src_unit, dst_unit)
                           else link_s)
        return cpu_s, link_s, block_s, cpu_s + link_s


class Mapping:
    """Assigns each actor to exactly one processing unit.

    In each platform-specific mapping file, each actor is defined either
    for local or remote execution; the Edge-PRUNE compiler needs only this
    file to change the distributed scenario.
    """

    def __init__(self, name: str, assignment: Dict[str, str],
                 platform: Optional[PlatformGraph] = None):
        self.name = name
        self.assignment = dict(assignment)
        self.platform = platform
        if platform is not None:
            for actor, unit in assignment.items():
                if unit not in platform.units:
                    raise ValueError(
                        f"mapping {name}: actor {actor} mapped to unknown "
                        f"unit {unit}")

    def unit_of(self, actor_name: str) -> str:
        try:
            return self.assignment[actor_name]
        except KeyError:
            raise KeyError(
                f"mapping {self.name}: actor {actor_name} is unmapped — every "
                f"actor must be assigned to exactly one processing unit")

    def units_used(self) -> List[str]:
        return sorted(set(self.assignment.values()))

    def boundary_edges(self, g) -> List:
        """Edges whose endpoints live on different units — these are the
        edges the synthesizer replaces with TX/RX FIFO pairs."""
        out = []
        for f in g.fifos.values():
            if self.unit_of(f.src.actor.name) != self.unit_of(f.dst.actor.name):
                out.append(f)
        return out

    def excluding(self, dead_units, fallback_unit: str, *,
                  name: Optional[str] = None) -> "Mapping":
        """Re-map every actor assigned to a unit in ``dead_units`` onto
        ``fallback_unit`` — the failover controller's last-resort recovery
        when no precomputed fallback mapping avoids the dead set. The
        application graph is untouched (the Edge-PRUNE invariant): only
        the assignment changes, so the re-synthesized program computes the
        same function on the surviving units."""
        dead = set(dead_units)
        if fallback_unit in dead:
            raise ValueError(
                f"fallback unit {fallback_unit} is itself in the dead set")
        if self.platform is not None and fallback_unit not in self.platform.units:
            raise ValueError(f"fallback unit {fallback_unit} not in platform")
        assignment = {actor: (fallback_unit if unit in dead else unit)
                      for actor, unit in self.assignment.items()}
        return Mapping(name or f"{self.name}-sans-{'+'.join(sorted(dead))}",
                       assignment, self.platform)

    @staticmethod
    def partition_point(g, pp: int, *, endpoint: str = "endpoint",
                        server: str = "server",
                        platform: Optional[PlatformGraph] = None) -> "Mapping":
        """The Explorer's canonical mapping family: actors with precedence
        index < pp run on the endpoint device, the rest on the server.
        ``pp == 0`` → everything on the server (raw-input offload);
        ``pp == len(actors)`` → full endpoint inference."""
        prec = g.precedence_index()
        assignment = {name: (endpoint if idx < pp else server)
                      for name, idx in prec.items()}
        return Mapping(f"{g.name}-pp{pp}", assignment, platform)


# ---------------------------------------------------------------------------
# Paper platforms (Tables I and II) with calibrated effective FLOP rates.
# ---------------------------------------------------------------------------

def paper_platform(endpoint: str = "N2", connection: str = "ethernet",
                   *, link_model: str = "effective",
                   workload: str = "vehicle") -> PlatformGraph:
    """Platform graph for the paper's experiments (Tables I-II).

    Effective FLOP/s and FC memory bandwidths are *calibrated* from the
    paper's own anchor measurements — see ``repro_torch.core.calibration`` for
    the derivation and EXPERIMENTS.md for the fidelity check.

    ``workload`` selects the endpoint compute library the paper used:
    'vehicle' = ARM CL (N2) / plain C (N270); 'ssd' = generic OpenCL.
    ``link_model`` is 'synthetic' (Table II measured throughput) or
    'effective' (calibrated in-application throughput; differs only for
    WiFi — see calibration.py).
    """
    from repro_torch.core import calibration as cal
    if endpoint == "N2":
        flops = cal.N2_OPENCL_FLOPS if workload == "ssd" else cal.N2_FLOPS
        tx_cost = cal.N2_SSD_TX_COST_PER_BYTE if workload == "ssd" else 0.0
        dev = ProcessingUnit("endpoint", "gpu", flops, cal.N2_FC_MEM_BW,
                             cal.N2_FIRING_OVERHEAD_S, tx_cost)
    elif endpoint == "N270":
        dev = ProcessingUnit("endpoint", "cpu", cal.N270_FLOPS,
                             cal.N270_FC_MEM_BW, cal.N270_FIRING_OVERHEAD_S)
    else:
        raise ValueError(f"unknown endpoint {endpoint}")
    server_flops = cal.I7_OPENCL_FLOPS if workload == "ssd" else cal.I7_FLOPS
    server = ProcessingUnit("server", "cpu", server_flops, cal.I7_FC_MEM_BW,
                            cal.I7_FIRING_OVERHEAD_S)
    key = (endpoint, connection, link_model)
    if workload == "ssd" and (endpoint, connection, "ssd_" + link_model) in cal.LINKS:
        key = (endpoint, connection, "ssd_" + link_model)
    bw, lat, overlap = cal.LINKS[key]
    pg = PlatformGraph(f"{endpoint}-i7-{connection}")
    pg.add_unit(dev).add_unit(server)
    pg.add_link(Link("endpoint", "server", bandwidth=bw, latency_s=lat,
                     overlap=overlap))
    return pg


def tpu_pod_platform(num_pods: int = 2, *, chips_per_pod: int = 256,
                     chip_flops: float = 197e12, ici_bw: float = 50e9,
                     dcn_bw: float = 25e9) -> PlatformGraph:
    """TPU analogue of the paper's endpoint/server split: each pod is one
    'processing unit' (inference stage); pods are linked by DCN. Used by
    the Explorer to reason about pod-boundary partition points."""
    pg = PlatformGraph(f"tpu-{num_pods}pods")
    for i in range(num_pods):
        name = "endpoint" if i == 0 else (f"server{i - 1}" if num_pods > 2 else "server")
        pg.add_unit(ProcessingUnit(name, "tpu", chip_flops * chips_per_pod))
    units = list(pg.units)
    for i in range(len(units) - 1):
        pg.add_link(Link(units[i], units[i + 1], bandwidth=dcn_bw, latency_s=1e-5))
    return pg
