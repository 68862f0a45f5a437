"""The port's copy of the VR-PRUNE core (``repro_torch.core``) against the
reference's (``repro.core``), and the port's paper benches
(``benchmarks/torch_paper.py``) against the reference's.

The core is pure Python, so everything is held for exact equality: on
the graphs ``tests/test_core_graph.py`` builds (and a DPG like the
early-exit example's), the analyzer's repetition vectors and verdicts;
the synthesized stages and channels; the ``PipelineSchedule`` entries,
makespans and ``frame_done_s``; the Simulator's modeled clocks; the
Explorer's modeled records with the privacy optimum; the mapping files
and the profiling script, byte for byte; and the five paper benches'
rows, row for row.
"""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.core as RC
import repro_torch.core as TC
from repro.core import synthesis as RS
from repro_torch.core import synthesis as TS

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import (dual_input, fig4_vehicle_n2,  # noqa: E402
                        fig5_vehicle_n270, fig6_ssd_n2, latency_breakdown,
                        torch_paper)

PACKAGES = {"ref": RC, "port": TC}


# ---------------------------------------------------------------------------
# graph builders over either package's core (numpy fire functions)
# ---------------------------------------------------------------------------

def _spa(C, name, n_in=1, n_out=1, fn=None, shape=(4,), rate=1):
    inp = [C.Port(f"in{i}" if n_in > 1 else "in", C.PortDir.IN, rate, rate,
                  token_shape=shape) for i in range(n_in)]
    out = [C.Port(f"out{i}" if n_out > 1 else "out", C.PortDir.OUT, rate,
                  rate, token_shape=shape) for i in range(n_out)]

    def fire(inputs, state, atr):
        toks = [t for v in inputs.values() for t in v if t is not None]
        val = fn(toks) if fn else (toks[0] if toks
                                   else np.zeros(shape, np.float32))
        return {p.name: [val] * atr[p.name] for p in out}, state

    return C.Actor(name, C.ActorType.SPA, inp, out, fire_fn=fire)


def _source(C, name, shape=(4,)):
    def fire(inputs, state, atr):
        feed = inputs.get("__feed__")
        return {"out": [feed[0] if feed else np.ones(shape, np.float32)]}, \
            state
    return C.Actor(name, C.ActorType.SPA, [],
                   [C.Port("out", C.PortDir.OUT, token_shape=shape)],
                   fire_fn=fire)


def _sink(C, name, shape=(4,)):
    return C.Actor(name, C.ActorType.SPA,
                   [C.Port("in", C.PortDir.IN, token_shape=shape)], [],
                   fire_fn=lambda i, s, r: ({"result": list(i["in"])}, s))


def chain(C, n_mid=3, costs=None):
    g = C.Graph("chain")
    prev = g.add_actor(_source(C, "src"))
    for i in range(n_mid):
        a = g.add_actor(_spa(C, f"a{i}", fn=lambda ts: ts[0] + 1.0))
        g.connect(prev.port("out"), a.port("in"))
        prev = a
    snk = g.add_actor(_sink(C, "snk"))
    g.connect(prev.port("out"), snk.port("in"))
    for name, fl in (costs or {}).items():
        g.actors[name].cost_flops = fl
    return g


def multirate(C):
    g = C.Graph("mr")
    a = g.add_actor(C.Actor(
        "p", C.ActorType.SPA, [],
        [C.Port("out", C.PortDir.OUT, 2, 2, token_shape=(1,))],
        fire_fn=lambda i, s, r: ({"out": [np.zeros(1)] * 2}, s)))
    b = g.add_actor(C.Actor(
        "c", C.ActorType.SPA,
        [C.Port("in", C.PortDir.IN, 3, 3, token_shape=(1,))], [],
        fire_fn=lambda i, s, r: ({}, s)))
    g.connect(a.port("out"), b.port("in"), capacity=6)
    return g


def inconsistent(C):
    g = C.Graph("bad")
    s = g.add_actor(C.Actor(
        "s", C.ActorType.SPA, [],
        [C.Port("out0", C.PortDir.OUT, 1, 1, token_shape=(1,)),
         C.Port("out1", C.PortDir.OUT, 2, 2, token_shape=(1,))],
        fire_fn=lambda i, st, r: ({"out0": [0], "out1": [0, 0]}, st)))
    t = g.add_actor(C.Actor(
        "t", C.ActorType.SPA,
        [C.Port("in0", C.PortDir.IN, 1, 1, token_shape=(1,)),
         C.Port("in1", C.PortDir.IN, 1, 1, token_shape=(1,))], [],
        fire_fn=lambda i, st, r: ({}, st)))
    g.connect(s.port("out0"), t.port("in0"))
    g.connect(s.port("out1"), t.port("in1"))
    return g


def cycle(C, delay):
    g = C.Graph("cyc")
    a = g.add_actor(_spa(C, "a"))
    b = g.add_actor(_spa(C, "b"))
    g.connect(a.port("out"), b.port("in"))
    g.connect(b.port("out"), a.port("in"), delay_tokens=delay)
    return g


def overflow(C):
    g = C.Graph("ovf")
    a = g.add_actor(C.Actor(
        "p", C.ActorType.SPA, [],
        [C.Port("out", C.PortDir.OUT, 4, 4, token_shape=(1,))],
        fire_fn=lambda i, s, r: ({"out": [0] * 4}, s)))
    b = g.add_actor(C.Actor(
        "c", C.ActorType.SPA,
        [C.Port("in", C.PortDir.IN, 1, 1, token_shape=(1,))], [],
        fire_fn=lambda i, s, r: ({}, s)))
    g.connect(a.port("out"), b.port("in"), capacity=2)
    return g


def dynamic_outside_dpg(C):
    g = chain(C)
    g.actors["a1"].actor_type = C.ActorType.DPA
    return g


def bad_dpg(C):
    g = chain(C, 3)
    for n in ("a0", "a1", "a2"):
        g.actors[n].dpg = "d"
    g.actors["a0"].actor_type = C.ActorType.DA
    g.actors["a2"].actor_type = C.ActorType.DA
    g.actors["a1"].actor_type = C.ActorType.DPA
    g.dpgs["d"] = C.Dpg("d", ca="missing", entry_da="a0", exit_da="a2",
                        members=["a0", "a1", "a2"])
    return g


def offload_dpg(C):
    """The early-exit example's graph shape: a CA, an entry DA, a
    variable-rate DPA and an exit DA, with numpy fire functions."""
    g = C.Graph("offload")
    P, D = C.Port, C.PortDir
    g.add_actor(_source(C, "Input"))
    g.add_actor(C.Actor(
        "Gate", C.ActorType.CA, [P("in", D.IN, token_shape=(4,))],
        [P("feat", D.OUT, token_shape=(4,)),
         P("shallow", D.OUT, token_shape=(4,))],
        fire_fn=lambda i, s, r: ({"feat": i["in"], "shallow": i["in"]}, s)))
    g.add_actor(C.Actor(
        "EntryDA", C.ActorType.DA, [P("in", D.IN, token_shape=(4,))],
        [P("out", D.OUT, lrl=0, url=1, token_shape=(4,))],
        fire_fn=lambda i, s, r: ({"out": list(i["in"])[:r["out"]]}, s)))
    g.add_actor(C.Actor(
        "Deep", C.ActorType.DPA,
        [P("in", D.IN, lrl=0, url=1, token_shape=(4,))],
        [P("out", D.OUT, lrl=0, url=1, token_shape=(4,))],
        fire_fn=lambda i, s, r: ({"out": [x * 2.0 for x in i.get("in", [])]},
                                 s)))
    g.add_actor(C.Actor(
        "ExitDA", C.ActorType.DA,
        [P("deep", D.IN, lrl=0, url=1, token_shape=(4,)),
         P("shallow", D.IN, token_shape=(4,))],
        [P("result", D.OUT, token_shape=(4,))],
        fire_fn=lambda i, s, r: (
            {"result": [i["deep"][0] if i.get("deep") else i["shallow"][0]]},
            s)))
    g.add_actor(_sink(C, "Sink"))
    g.connect(g.actors["Input"].port("out"), g.actors["Gate"].port("in"))
    g.connect(g.actors["Gate"].port("feat"), g.actors["EntryDA"].port("in"))
    g.connect(g.actors["Gate"].port("shallow"),
              g.actors["ExitDA"].port("shallow"), capacity=4)
    g.connect(g.actors["EntryDA"].port("out"), g.actors["Deep"].port("in"))
    g.connect(g.actors["Deep"].port("out"), g.actors["ExitDA"].port("deep"))
    g.connect(g.actors["ExitDA"].port("result"), g.actors["Sink"].port("in"))
    g.add_dpg(C.Dpg("offload", ca="Gate", entry_da="EntryDA",
                    exit_da="ExitDA",
                    members=["Gate", "EntryDA", "Deep", "ExitDA"]))
    return g


GRAPHS = {
    "chain": chain, "multirate": multirate, "inconsistent": inconsistent,
    "deadlock": lambda C: cycle(C, 0), "delay": lambda C: cycle(C, 1),
    "overflow": overflow, "dynamic_outside_dpg": dynamic_outside_dpg,
    "bad_dpg": bad_dpg, "offload_dpg": offload_dpg,
}


def _toy_platform(C):
    pg = C.PlatformGraph("toy")
    pg.add_unit(C.ProcessingUnit("endpoint", flops=1e9))
    pg.add_unit(C.ProcessingUnit("server", flops=100e9))
    pg.add_link(C.Link("endpoint", "server", bandwidth=1e6, latency_s=0.0))
    return pg


PLATFORMS = {"toy": _toy_platform,
             "n2_ethernet": lambda C: C.paper_platform("N2", "ethernet"),
             "n270_wifi": lambda C: C.paper_platform("N270", "wifi")}
COSTS = {"src": 0.0, "a0": 5e6, "a1": 5e6, "a2": 5e6, "snk": 0.0}


def both(build, *args):
    return {k: build(C, *args) for k, C in PACKAGES.items()}


# ---------------------------------------------------------------------------
# analyzer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(GRAPHS))
def test_analyzer_verdicts_and_repetition_vectors_equal(name):
    reports = {k: C.analyze(GRAPHS[name](C)) for k, C in PACKAGES.items()}
    ref, port = reports["ref"], reports["port"]
    assert (port.ok, port.errors, port.warnings) == \
        (ref.ok, ref.errors, ref.warnings)
    assert port.repetition_vector == ref.repetition_vector


@pytest.mark.parametrize("name", ["chain", "multirate", "offload_dpg"])
def test_repetition_vector_function_equal(name):
    got = {k: C.repetition_vector(GRAPHS[name](C))
           for k, C in PACKAGES.items()}
    assert got["port"] == got["ref"]


# ---------------------------------------------------------------------------
# synthesis
# ---------------------------------------------------------------------------

def _chain_mapping(C, g, kind, ep="ep", sv="sv"):
    if kind.startswith("pp"):
        return C.Mapping.partition_point(g, int(kind[2:]), endpoint=ep,
                                         server=sv)
    # endpoint -> server -> endpoint: three segments, two on the endpoint
    return C.Mapping("revisit", {"src": ep, "a0": ep, "a1": sv, "a2": ep,
                                 "snk": ep})


def _stages(prog):
    return [(st.unit, st.key, [a.name for a in st.actors],
             [c.name for c in st.rx], [c.name for c in st.tx])
            for st in prog.stages]


MAPPINGS = ["pp1", "pp2", "pp3", "pp5", "revisit"]


@pytest.mark.parametrize("kind", MAPPINGS)
def test_synthesized_stages_and_channels_equal(kind):
    progs = {}
    for k, C in PACKAGES.items():
        g = chain(C, 3)
        progs[k] = C.synthesize(g, _chain_mapping(C, g, kind))
    ref, port = progs["ref"], progs["port"]
    assert _stages(port) == _stages(ref)
    assert [dataclasses.astuple(c) for c in port.channels] == \
        [dataclasses.astuple(c) for c in ref.channels]
    assert port.comm_bytes_per_iteration() == ref.comm_bytes_per_iteration()
    feed = np.arange(4, dtype=np.float32)
    np.testing.assert_array_equal(port.run_local({"src": feed})["snk"][0],
                                  ref.run_local({"src": feed})["snk"][0])


@pytest.mark.parametrize("kind", MAPPINGS)
@pytest.mark.parametrize("plat", ["toy", "n2_ethernet"])
def test_pipeline_schedules_equal(kind, plat):
    out = {}
    for k, C in PACKAGES.items():
        g = chain(C, 3, COSTS)
        m = _chain_mapping(C, g, kind, "endpoint", "server")
        pm = C.PlatformModel(PLATFORMS[plat](C))
        frames = [{"src": np.full(4, float(i), np.float32)}
                  for i in range(5)]
        arrivals = [0.0, 1e-3, 1e-3, 5e-3, 0.02]
        sinks, sched = C.synthesize(g, m).run_pipelined(
            frames, platform=pm, arrivals=arrivals)
        out[k] = (sinks, sched)
    (rs, ref), (ps, port) = out["ref"], out["port"]
    assert [dataclasses.astuple(e) for e in port.entries] == \
        [dataclasses.astuple(e) for e in ref.entries]
    assert (port.makespan_s, port.sequential_s, port.unit_busy_s,
            port.frame_done_s, port.speedup) == \
        (ref.makespan_s, ref.sequential_s, ref.unit_busy_s,
         ref.frame_done_s, ref.speedup)
    for a, b in zip(ps, rs):
        np.testing.assert_array_equal(a["snk"][0], b["snk"][0])


def test_simulator_modeled_clocks_equal():
    res = {}
    for k, C in PACKAGES.items():
        g = chain(C, 3, COSTS)
        pg = C.paper_platform("N2", "wifi")
        m = C.Mapping.partition_point(g, 3, platform=pg)
        res[k] = C.Simulator(g, mapping=m, platform=C.PlatformModel(pg)) \
            .run(4, source_inputs={"src": [np.full(4, float(i), np.float32)
                                           for i in range(4)]})
    ref, port = res["ref"], res["port"]
    assert (port.unit_busy_s, port.link_busy_s, port.tx_cpu_busy_s,
            port.modeled_makespan_s, port.modeled_total_s(),
            port.pipeline_speedup) == \
        (ref.unit_busy_s, ref.link_busy_s, ref.tx_cpu_busy_s,
         ref.modeled_makespan_s, ref.modeled_total_s(),
         ref.pipeline_speedup)
    assert [(f.actor, f.firing_index, f.modeled_s, f.unit, f.start_s,
             f.finish_s) for f in port.firings] == \
        [(f.actor, f.firing_index, f.modeled_s, f.unit, f.start_s,
          f.finish_s) for f in ref.firings]
    for a, b in zip(port.outputs["snk"], ref.outputs["snk"]):
        np.testing.assert_array_equal(a, b)


def test_variable_rate_dpg_simulation_equal():
    """The offload DPG fired with run-time rates set per frame (the CA's
    decision 1 or 0 on every DPG edge): the same tokens and firings."""
    decisions = [1, 0, 1, 1, 0, 0]

    def atr_fn(actor, k):
        d = decisions[k] if k < len(decisions) else 1
        return {"EntryDA": {"out": d}, "Deep": {"in": d, "out": d},
                "ExitDA": {"deep": d}}.get(actor.name, {})
    res = {}
    for k, C in PACKAGES.items():
        feeds = [np.full(4, float(i), np.float32) for i in range(6)]
        res[k] = C.Simulator(offload_dpg(C), atr_fn=atr_fn).run(
            6, source_inputs={"Input": feeds})
    ref, port = res["ref"], res["port"]
    assert [(f.actor, f.firing_index) for f in port.firings] == \
        [(f.actor, f.firing_index) for f in ref.firings]
    assert len(port.outputs["Sink"]) == len(ref.outputs["Sink"]) == 6
    for a, b in zip(port.outputs["Sink"], ref.outputs["Sink"]):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# explorer and mapping files
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("plat", list(PLATFORMS))
def test_explorer_modeled_records_equal(plat):
    res = {k: C.Explorer(chain(C, 3, COSTS), PLATFORMS[plat](C))
           .evaluate_modeled() for k, C in PACKAGES.items()}
    ref, port = res["ref"], res["port"]
    assert [dataclasses.asdict(r) for r in port.records] == \
        [dataclasses.asdict(r) for r in ref.records]
    for privacy in (False, True):
        assert port.best(privacy=privacy).pp == ref.best(privacy=privacy).pp
        assert port.speedup(privacy=privacy) == ref.speedup(privacy=privacy)
    assert port.full_endpoint().pp == ref.full_endpoint().pp


def test_explorer_fallback_ranking_equal():
    ranked = {}
    for k, C in PACKAGES.items():
        ex = C.Explorer(chain(C, 3, COSTS), C.paper_platform("N2", "wifi"))
        ranked[k] = [(m.name, sorted(m.assignment.items()))
                     for m in ex.rank_fallbacks()]
    assert ranked["port"] == ranked["ref"]


def test_artifacts_equal_byte_for_byte(tmp_path):
    paths = {k: C.Explorer(chain(C, 3, COSTS), _toy_platform(C))
             .generate_artifacts(str(tmp_path / k))
             for k, C in PACKAGES.items()}
    names = [Path(p).name for p in paths["ref"]]
    assert [Path(p).name for p in paths["port"]] == names
    for a, b in zip(paths["port"], paths["ref"]):
        assert Path(a).read_bytes() == Path(b).read_bytes(), Path(a).name
    m = {k: (RS if k == "ref" else TS).read_mapping_file(p[0])
         for k, p in paths.items()}
    assert m["port"].assignment == m["ref"].assignment


@pytest.mark.parametrize("local", ["ep", "sv"])
def test_mapping_file_writer_equal_byte_for_byte(tmp_path, local):
    for k, C in PACKAGES.items():
        g = chain(C, 2)
        m = C.Mapping.partition_point(g, 2, endpoint="ep", server="sv")
        (RS if k == "ref" else TS).write_mapping_file(
            str(tmp_path / f"{k}.json"), m, local_unit=local)
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "ref.json").read_bytes()


# ---------------------------------------------------------------------------
# the paper benches
# ---------------------------------------------------------------------------

REF_BENCHES = {"fig4": fig4_vehicle_n2, "fig5": fig5_vehicle_n270,
               "fig6": fig6_ssd_n2, "dual_input": dual_input,
               "latency": latency_breakdown}


@pytest.mark.parametrize("name", list(REF_BENCHES))
def test_paper_bench_rows_equal(name):
    """Row for row: name, value, unit and paper anchor, exactly."""
    ref = REF_BENCHES[name].run()
    port = torch_paper.BENCHES[name]("cpu")
    assert [dataclasses.astuple(r) for r in port] == \
        [dataclasses.astuple(r) for r in ref]


def test_chip_smoke_paper_rows_are_the_references():
    """``chip_smoke.py`` phase 7 holds the port's modeled Fig 4-6 rows on
    the card against constants: they must be the reference's rows."""
    import chip_smoke
    assert set(chip_smoke.PAPER_ROWS) == {"fig4", "fig5", "fig6"}
    for key, rows in chip_smoke.PAPER_ROWS.items():
        assert rows == [(r.name, r.value) for r in REF_BENCHES[key].run()]
