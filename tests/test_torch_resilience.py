"""The port's resilience subsystem (``repro_torch.runtime.resilience``).

tests/test_resilience.py and tests/test_resilience_props.py in the port:
the failure model, the simulator's failure injection, heartbeat
detection, the bounded checkpoint buffer and the failover controller, on
the port's ``core``. The contract under test is the fault-tolerant
Edge-PRUNE property (arXiv 2206.08152): the application graph never
changes, only the mapping does, so after any recoverable failure every
served frame is bit-identical to the failure-free run. Beyond the
reference's cases, one ``FailureTrace`` goes through both packages'
``FailoverController`` on the same tiny transformer actor graph: the
reports agree (events, mapping history, frames replayed and unserved,
modeled times) and the logits lie within 1e-5.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import Explorer as RefExplorer
from repro.core import PlatformModel as RefPlatformModel
from repro.core import paper_platform as ref_paper_platform
from repro.models import transformer as RT
from repro.models.config import ModelConfig as RefConfig
from repro.runtime.resilience import FailoverController as RefController
from repro.runtime.resilience import FailureTrace as RefTrace
from repro.runtime.resilience import HeartbeatConfig as RefHeartbeat
from repro_torch.core import (Actor, ActorType, Explorer, Graph, Link,
                              Mapping, Port, PortDir, PlatformGraph,
                              PlatformModel, ProcessingUnit, SimResult,
                              Simulator, paper_platform, synthesize)
from repro_torch.models import transformer as PT
from repro_torch.models.config import ModelConfig
from repro_torch.runtime.resilience import (CheckpointBuffer,
                                            FailoverController,
                                            FailureInjector, FailureTrace,
                                            HeartbeatConfig, HeartbeatMonitor)
from repro_torch.weights import from_jax_params

HB = HeartbeatConfig(interval_s=1e-4, timeout_s=2e-4)


# ---------------------------------------------------------------------------
# helpers: a pure-python int chain (bit-exactness is trivially observable)
# ---------------------------------------------------------------------------

def chain_graph(n_mid: int = 2, muls=None) -> Graph:
    """Source -> n_mid affine stages -> Sink, int tokens, 1e6 flops each
    (so modeled firings take 1 ms on a 1 GFLOP/s unit)."""
    muls = muls or [10 + i for i in range(n_mid)]
    g = Graph(f"chain{n_mid}")
    src = Actor("Src", ActorType.SPA, [],
                [Port("out", PortDir.OUT, token_shape=(), token_dtype="int32")],
                fire_fn=lambda ins, st, atr: ({"out": [ins["__feed__"][0]]}, st),
                cost_flops=1e6)
    g.add_actor(src)
    prev = src
    for i in range(n_mid):
        def make_fire(m):
            return lambda ins, st, atr: ({"out": [ins["in"][0] * m + 1]}, st)
        a = Actor(f"M{i}", ActorType.SPA,
                  [Port("in", PortDir.IN, token_shape=(), token_dtype="int32")],
                  [Port("out", PortDir.OUT, token_shape=(), token_dtype="int32")],
                  fire_fn=make_fire(muls[i]), cost_flops=1e6)
        g.add_actor(a)
        g.connect(prev.port("out"), a.port("in"), capacity=64)
        prev = a
    snk = Actor("Snk", ActorType.SPA,
                [Port("in", PortDir.IN, token_shape=(), token_dtype="int32")], [],
                fire_fn=lambda ins, st, atr: ({"result": [ins["in"][0]]}, st),
                cost_flops=1e6)
    g.add_actor(snk)
    g.connect(prev.port("out"), snk.port("in"), capacity=64)
    return g


def two_unit_platform() -> PlatformModel:
    pg = PlatformGraph("p2")
    pg.add_unit(ProcessingUnit("endpoint", flops=1e9, mem_bandwidth=1e9))
    pg.add_unit(ProcessingUnit("server", flops=1e9, mem_bandwidth=1e9))
    pg.add_link(Link("endpoint", "server", bandwidth=1e9, latency_s=1e-5))
    return PlatformModel(pg)


def partition(g: Graph, pp: int) -> Mapping:
    """First ``pp`` actors (topo order) on the endpoint, rest on server —
    pipeline-ordered, both units used for 1 <= pp < N."""
    order = [a.name for a in g.topo_order()]
    return Mapping(f"pp{pp}", {n: ("endpoint" if i < pp else "server")
                               for i, n in enumerate(order)})


def all_on(g: Graph, unit: str) -> Mapping:
    return Mapping(f"all-{unit}", {n: unit for n in g.actors})


# ---------------------------------------------------------------------------
# failure model
# ---------------------------------------------------------------------------

def test_failure_trace_intervals():
    t = (FailureTrace().kill_unit("u", at=1.0).revive_unit("u", at=2.0)
         .kill_unit("u", at=3.0))
    assert not t.unit_dead_at("u", 0.5)
    assert t.unit_dead_at("u", 1.0) and t.unit_dead_at("u", 1.999)
    assert not t.unit_dead_at("u", 2.0)
    assert t.unit_dead_at("u", 100.0)          # second kill never revives
    assert t.unit_next_alive("u", 1.5) == 2.0
    assert t.unit_next_alive("u", 3.5) is None
    assert t.unit_killed_between("u", 0.5, 1.5)
    assert not t.unit_killed_between("u", 1.2, 1.8)
    assert t.unit_killed_between("u", 2.5, 3.0)


def test_failure_trace_links_symmetric():
    t = FailureTrace().kill_link("a", "b", at=1.0)
    assert t.link_dead_at("b", "a", 2.0)
    assert t.link_next_alive("a", "b", 2.0) is None
    assert t.dead_links(2.0) == [frozenset(("a", "b"))]


def test_first_kill_affecting_scopes_to_components():
    t = (FailureTrace().kill_unit("x", at=1.0)
         .kill_unit("server", at=2.0).kill_link("a", "b", at=3.0))
    e = t.first_kill_affecting(["server"], [("a", "b")], after=0.0)
    assert e.t_s == 2.0
    e = t.first_kill_affecting(["nope"], [("a", "b")], after=0.0)
    assert e.t_s == 3.0
    assert t.first_kill_affecting(["nope"], [], after=0.0) is None
    assert t.first_kill_affecting(["server"], [], after=2.0) is None


def test_failure_injector_delivers_in_order():
    t = FailureTrace().kill_unit("u", at=1.0).revive_unit("u", at=2.0)
    inj = FailureInjector(t)
    assert inj.advance(0.5) == []
    ev = inj.advance(1.5)
    assert len(ev) == 1 and ev[0].action == "kill"
    assert len(inj.advance(10.0)) == 1 and inj.exhausted


def test_heartbeat_detection_and_validation():
    m = HeartbeatMonitor(HeartbeatConfig(interval_s=0.05, timeout_s=0.15))
    # last beat before a kill at 0.12 was at 0.10 -> declared at 0.25
    assert m.detect_time(0.12) == pytest.approx(0.25)
    assert m.detect_time(0.0) == pytest.approx(0.15)
    with pytest.raises(ValueError, match="timeout"):
        HeartbeatConfig(interval_s=0.1, timeout_s=0.05)


def test_checkpoint_buffer_bounded_fifo():
    b = CheckpointBuffer(2)
    b.push(0, "f0")
    b.push(1, "f1")
    with pytest.raises(OverflowError, match="full"):
        b.push(2, "f2")
    b.ack(0)
    b.push(2, "f2")
    assert [fid for fid, _ in b.unacked()] == [1, 2]


# ---------------------------------------------------------------------------
# simulator failure injection
# ---------------------------------------------------------------------------

def _sim(g, mapping, pm, frames, failures=None):
    feed = {"Src": list(range(1, frames + 1))}
    return Simulator(g, mapping=mapping, platform=pm).run(
        frames, source_inputs=feed, failures=failures)


def test_simulator_kill_revive_replays_bit_exact():
    pm = two_unit_platform()
    nom = _sim(chain_graph(), partition(chain_graph(), 2), pm, 8)
    tr = FailureTrace().kill_unit("server", at=0.0025).revive_unit(
        "server", at=0.006)
    res = _sim(chain_graph(), partition(chain_graph(), 2), pm, 8, failures=tr)
    assert res.outputs["Snk"] == nom.outputs["Snk"]
    assert res.frames_replayed and not res.frames_lost
    # downtime + replay must push completion out
    assert res.modeled_makespan_s > nom.modeled_makespan_s
    assert res.failure_log


def test_simulator_kill_forever_loses_frames():
    pm = two_unit_platform()
    tr = FailureTrace().kill_unit("server", at=0.0025)
    res = _sim(chain_graph(), partition(chain_graph(), 2), pm, 8, failures=tr)
    nom = _sim(chain_graph(), partition(chain_graph(), 2), pm, 8)
    assert res.frames_lost, "dead-forever unit must lose frames"
    served = len(res.outputs["Snk"])
    assert served == 8 - len(res.frames_lost)
    # what *was* served is still the bit-exact prefix
    assert res.outputs["Snk"] == nom.outputs["Snk"][:served]


def test_simulator_link_failure_delays_or_replays():
    pm = two_unit_platform()
    nom = _sim(chain_graph(), partition(chain_graph(), 2), pm, 8)
    tr = FailureTrace().kill_link("endpoint", "server", at=0.0015) \
        .revive_link("endpoint", "server", at=0.005)
    res = _sim(chain_graph(), partition(chain_graph(), 2), pm, 8, failures=tr)
    assert res.outputs["Snk"] == nom.outputs["Snk"]
    assert res.modeled_makespan_s > nom.modeled_makespan_s


def test_simulator_failures_none_is_legacy_path():
    pm = two_unit_platform()
    a = _sim(chain_graph(), partition(chain_graph(), 2), pm, 5)
    b = _sim(chain_graph(), partition(chain_graph(), 2), pm, 5,
             failures=FailureTrace())
    assert a.outputs["Snk"] == b.outputs["Snk"]
    assert b.frames_replayed == [] and b.frames_lost == []


def _port(name, d):
    return Port(name, d, token_shape=(), token_dtype="int32")


def diamond_graph() -> Graph:
    """Src fans one frame out to B and C; J joins the branches — the
    whole-frame-consistency stress case: losing one branch's token must
    purge the surviving branch too, or J pairs different frames."""
    g = Graph("diamond")
    src = Actor("Src", ActorType.SPA, [],
                [_port("o1", PortDir.OUT), _port("o2", PortDir.OUT)],
                fire_fn=lambda ins, st, atr: (
                    {"o1": [ins["__feed__"][0]], "o2": [ins["__feed__"][0]]},
                    st),
                cost_flops=1e6)
    b = Actor("B", ActorType.SPA, [_port("in", PortDir.IN)],
              [_port("out", PortDir.OUT)],
              fire_fn=lambda ins, st, atr: ({"out": [ins["in"][0] * 10]}, st),
              cost_flops=1e6)
    c = Actor("C", ActorType.SPA, [_port("in", PortDir.IN)],
              [_port("out", PortDir.OUT)],
              fire_fn=lambda ins, st, atr: ({"out": [ins["in"][0] * 3]}, st),
              cost_flops=1e6)
    j = Actor("J", ActorType.SPA,
              [_port("i1", PortDir.IN), _port("i2", PortDir.IN)], [],
              fire_fn=lambda ins, st, atr: (
                  {"result": [(ins["i1"][0], ins["i2"][0])]}, st),
              cost_flops=1e6)
    for a in (src, b, c, j):
        g.add_actor(a)
    g.connect(src.port("o1"), b.port("in"), capacity=64)
    g.connect(src.port("o2"), c.port("in"), capacity=64)
    g.connect(b.port("out"), j.port("i1"), capacity=64)
    g.connect(c.port("out"), j.port("i2"), capacity=64)
    return g


def test_simulator_fanout_join_stays_frame_aligned():
    """One branch crosses the dying unit, the other stays healthy: replay
    must purge the healthy branch's surviving tokens so the join never
    pairs branch outputs from different frames."""
    pm = two_unit_platform()
    m = Mapping("d", {"Src": "endpoint", "B": "endpoint", "C": "server",
                      "J": "endpoint"})
    feed = {"Src": [2 * i for i in range(5)]}
    nom = Simulator(diamond_graph(), mapping=m, platform=pm).run(
        5, source_inputs=feed)
    tr = FailureTrace().kill_unit("server", at=5e-4).revive_unit(
        "server", at=2.5e-3)
    res = Simulator(diamond_graph(), mapping=m, platform=pm).run(
        5, source_inputs=feed, failures=tr)
    assert res.outputs["J"] == nom.outputs["J"]
    assert res.frames_replayed and not res.frames_lost


def test_simulator_multiple_losses_one_outage_single_replay_round():
    """Both branches land on the dead unit: two token losses of the same
    frame are one replay round, not two burned attempts — the frame must
    still recover after the revival."""
    pm = two_unit_platform()
    m = Mapping("d2", {"Src": "endpoint", "B": "server", "C": "server",
                       "J": "endpoint"})
    feed = {"Src": [2 * i for i in range(5)]}
    nom = Simulator(diamond_graph(), mapping=m, platform=pm).run(
        5, source_inputs=feed)
    tr = FailureTrace().kill_unit("server", at=5e-4).revive_unit(
        "server", at=2.5e-3)
    res = Simulator(diamond_graph(), mapping=m, platform=pm).run(
        5, source_inputs=feed, failures=tr)
    assert res.outputs["J"] == nom.outputs["J"]
    assert not res.frames_lost


def test_simulator_dead_source_unit_accounts_all_frames():
    """Killing the unit hosting the source must report every unserved
    frame in frames_lost — never-fired frames included."""
    pm = two_unit_platform()
    tr = FailureTrace().kill_unit("endpoint", at=2.2e-3)
    res = _sim(chain_graph(), partition(chain_graph(), 2), pm, 5,
               failures=tr)
    assert len(res.outputs["Snk"]) + len(res.frames_lost) == 5
    assert res.frames_lost == sorted(res.frames_lost)


def test_simulator_rejects_unsupported_graph_classes_under_failures():
    """Whole-frame replay cannot roll back actor state, reproduce
    variable rates, or preserve loop-carried delay tokens — combining
    failures= with those graph features must raise, not corrupt."""
    pm = two_unit_platform()
    tr = FailureTrace().kill_unit("server", at=1.0)

    g = chain_graph()
    g.actors["M0"].init_fn = lambda: 0
    with pytest.raises(ValueError, match="stateless"):
        Simulator(g, mapping=partition(g, 2), platform=pm).run(
            2, source_inputs={"Src": [1, 2]}, failures=tr)

    g2 = chain_graph()
    with pytest.raises(ValueError, match="static-rate"):
        Simulator(g2, mapping=partition(g2, 2), platform=pm,
                  atr_fn=lambda a, k: {}).run(
            2, source_inputs={"Src": [1, 2]}, failures=tr)

    g3 = Graph("loop")
    a = Actor("A", ActorType.SPA,
              [_port("in", PortDir.IN)], [_port("out", PortDir.OUT)],
              fire_fn=lambda ins, st, atr: ({"out": [ins["in"][0] + 1]}, st))
    g3.add_actor(a)
    g3.connect(a.port("out"), a.port("in"), delay_tokens=1)
    with pytest.raises(ValueError, match="feedback"):
        Simulator(g3, platform=pm,
                  mapping=Mapping("l", {"A": "server"})).run(
            2, failures=tr)
    # ...and the same graphs still simulate fine without failure injection
    out = Simulator(g, mapping=partition(g, 2), platform=pm).run(
        2, source_inputs={"Src": [1, 2]})
    assert len(out.outputs["Snk"]) == 2


def test_pipeline_speedup_guards_empty_run():
    assert SimResult(outputs={}).pipeline_speedup == 1.0
    # makespan set but zero modeled charges (no platform): still 1.0,
    # not a ZeroDivisionError / 0-by-0
    assert SimResult(outputs={}, modeled_makespan_s=1.0).pipeline_speedup == 1.0
    res = Simulator(chain_graph()).run(3, source_inputs={"Src": [1, 2, 3]})
    assert res.pipeline_speedup == 1.0


# ---------------------------------------------------------------------------
# failover controller: property + edge cases
# ---------------------------------------------------------------------------

def _controller(g, primary, fallbacks, pm, *, window=None):
    return FailoverController(g, primary, fallbacks, platform=pm,
                              heartbeat=HB,
                              checkpoint_frames=window or 64)


def test_failover_mid_stream_server_loss():
    g = chain_graph()
    pm = two_unit_platform()
    primary = partition(g, 2)
    frames = [{"Src": i} for i in range(10)]
    nominal, nrep = _controller(g, primary, [all_on(g, "endpoint")],
                                pm).serve(frames)
    assert nrep.num_failovers == 0
    ctl = _controller(g, primary, [all_on(g, "endpoint")], pm, window=4)
    outs, rep = ctl.serve(
        frames, failures=FailureTrace().kill_unit("server", at=0.004))
    assert rep.num_failovers == 1 and not rep.exhausted
    assert rep.frames_replayed and not rep.frames_unserved
    assert ctl.mapping.units_used() == ["endpoint"]
    assert [o["Snk"] for o in outs] == [o["Snk"] for o in nominal]
    ev = rep.events[0]
    assert ev.t_detect_s >= ev.t_fail_s
    assert ev.recovery_latency_s > 0


def test_failover_during_prefill():
    """Kill before the first frame ever acks: everything replays on the
    fallback and the full stream is still served bit-exactly."""
    g = chain_graph()
    pm = two_unit_platform()
    frames = [{"Src": i} for i in range(6)]
    nominal, _ = _controller(g, partition(g, 2),
                             [all_on(g, "endpoint")], pm).serve(frames)
    ctl = _controller(g, partition(g, 2), [all_on(g, "endpoint")], pm)
    outs, rep = ctl.serve(
        frames, failures=FailureTrace().kill_unit("server", at=0.0))
    assert [o["Snk"] for o in outs] == [o["Snk"] for o in nominal]
    assert rep.num_failovers == 1 and not rep.frames_unserved


def test_failover_of_only_fallback_exhausts():
    g = chain_graph()
    pm = two_unit_platform()
    frames = [{"Src": i} for i in range(10)]
    ctl = _controller(g, partition(g, 2), [all_on(g, "endpoint")], pm,
                      window=4)
    tr = (FailureTrace().kill_unit("server", at=0.004)
          .kill_unit("endpoint", at=0.009))
    outs, rep = ctl.serve(frames, failures=tr)
    assert rep.exhausted and rep.frames_unserved
    # served prefix is committed, the rest is explicitly None
    nominal, _ = _controller(g, partition(g, 2),
                             [all_on(g, "endpoint")],
                             pm).serve(frames)
    for i, o in enumerate(outs):
        if i in rep.frames_unserved:
            assert o is None
        else:
            assert o["Snk"] == nominal[i]["Snk"]


def test_failover_link_only_failure():
    """A dead link with both units alive still breaks every boundary-
    crossing mapping: the controller must fall over to a single-unit
    mapping and keep the stream bit-exact."""
    g = chain_graph()
    pm = two_unit_platform()
    frames = [{"Src": i} for i in range(8)]
    nominal, _ = _controller(g, partition(g, 2),
                             [all_on(g, "endpoint")], pm).serve(frames)
    ctl = _controller(g, partition(g, 2), [all_on(g, "endpoint")], pm,
                      window=3)
    outs, rep = ctl.serve(
        frames,
        failures=FailureTrace().kill_link("endpoint", "server", at=0.003))
    assert rep.num_failovers == 1
    assert len(ctl.mapping.units_used()) == 1
    assert [o["Snk"] for o in outs] == [o["Snk"] for o in nominal]


def test_mapping_excluding_remaps_dead_units():
    g = chain_graph()
    m = partition(g, 2)
    fb = m.excluding(["server"], "endpoint")
    assert fb.units_used() == ["endpoint"]
    assert set(fb.assignment) == set(m.assignment)
    with pytest.raises(ValueError, match="dead set"):
        m.excluding(["server"], "server")


# ---------------------------------------------------------------------------
# property: any mapping x any single-unit failure after frame k
# ---------------------------------------------------------------------------

@settings(max_examples=25, deadline=None)
@given(data=st.data())
def test_property_failure_after_frame_k_preserves_prefix(data):
    n_mid = data.draw(st.integers(1, 4), label="n_mid")
    n_frames = data.draw(st.integers(3, 7), label="n_frames")
    muls = data.draw(st.lists(st.integers(2, 99), min_size=n_mid,
                              max_size=n_mid), label="muls")
    g = chain_graph(n_mid, muls)
    n_actors = len(g.actors)
    pp = data.draw(st.integers(1, n_actors - 1), label="pp")
    k = data.draw(st.integers(0, n_frames - 2), label="k")
    dead = data.draw(st.sampled_from(["endpoint", "server"]), label="dead")
    pm = two_unit_platform()
    primary = partition(g, pp)
    fallbacks = [all_on(g, "endpoint"), all_on(g, "server")]
    frames = [{"Src": 7 * i + 1} for i in range(n_frames)]

    nominal, nrep = _controller(g, primary, fallbacks, pm).serve(frames)
    assert nrep.num_failovers == 0

    # Fail strictly between frame k's ack and frame k+1's ack on the
    # nominal timeline (one window => controller timeline == pipeline's).
    done = synthesize(g, primary).run_pipelined(
        frames, platform=pm)[1].frame_done_s
    t_fail = (done[k] + done[k + 1]) / 2
    assert done[k] < t_fail < done[k + 1]

    ctl = _controller(g, primary, fallbacks, pm)
    outs, rep = ctl.serve(
        frames, failures=FailureTrace().kill_unit(dead, at=t_fail))
    # frames 0..k acked before the failure: bit-exact and never replayed
    for i in range(k + 1):
        assert outs[i]["Snk"] == nominal[i]["Snk"], f"frame {i} diverged"
        assert i not in rep.frames_replayed
    # a viable single-unit fallback exists, so the whole stream completes
    # bit-exactly
    assert not rep.frames_unserved
    for i in range(n_frames):
        assert outs[i]["Snk"] == nominal[i]["Snk"]
    assert rep.num_failovers == 1
    assert dead not in ctl.mapping.units_used()


# ---------------------------------------------------------------------------
# cross-package: one failure trace through both controllers
# ---------------------------------------------------------------------------

TINY = dict(name="failover-tiny", arch_type="dense", n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=128,
            dtype="float32", param_dtype="float32", attn_chunk=16,
            remat=False)
SEQ = 12
LOGITS_TOL = 1e-5


def _serve_both(n_frames: int, checkpoint_frames: int, fail_frac: float):
    """The same graph, ranked fallbacks, frames and server kill through
    the reference's controller and the port's; returns both (outputs,
    report, controller) triples."""
    rcfg, tcfg = RefConfig(**TINY), ModelConfig(**TINY)
    params = RT.init_params(rcfg, jax.random.PRNGKey(0))
    model = from_jax_params(jax.device_get(params), tcfg, device="cpu")
    rng = np.random.RandomState(3)
    tokens = [rng.randint(0, tcfg.vocab_size, (1, SEQ)).astype(np.int32)
              for _ in range(n_frames)]
    sides = {
        "ref": (RT.to_actor_graph(rcfg, params, batch=1, seq=SEQ,
                                  group_size=1),
                ref_paper_platform("N270", "ethernet"), RefExplorer,
                RefPlatformModel, RefController, RefTrace, RefHeartbeat,
                [{"Input": jax.numpy.asarray(t)} for t in tokens]),
        "port": (PT.to_actor_graph(tcfg, model, batch=1, seq=SEQ,
                                   group_size=1),
                 paper_platform("N270", "ethernet"), Explorer, PlatformModel,
                 FailoverController, FailureTrace, HeartbeatConfig,
                 [{"Input": torch.from_numpy(t)} for t in tokens]),
    }
    out = {}
    for side, (g, pg, explorer, pmodel, controller, trace, hb,
               frames) in sides.items():
        pm = pmodel(pg)
        ranked = explorer(g, pg).rank_fallbacks()
        primary = next(m for m in ranked if len(m.units_used()) == 2)

        def make(heartbeat=None):
            return controller(g, primary, ranked, platform=pm,
                              heartbeat=heartbeat,
                              checkpoint_frames=checkpoint_frames)
        _, nominal = make().serve(frames)
        gap = nominal.makespan_s / n_frames
        ctl = make(hb(interval_s=gap / 2, timeout_s=gap))
        outs, rep = ctl.serve(frames, failures=trace().kill_unit(
            "server", at=fail_frac * nominal.makespan_s))
        out[side] = (outs, rep, ctl, nominal)
    return out


def test_failover_report_and_logits_match_reference():
    both = _serve_both(n_frames=6, checkpoint_frames=2, fail_frac=0.4)
    (r_outs, r_rep, r_ctl, r_nom), (outs, rep, ctl, nom) = \
        both["ref"], both["port"]
    assert nom.makespan_s == pytest.approx(r_nom.makespan_s, rel=1e-12)
    assert rep.num_failovers == r_rep.num_failovers >= 1
    assert rep.mapping_history == r_rep.mapping_history
    assert rep.frames_replayed == r_rep.frames_replayed
    assert rep.frames_replayed, "the kill must catch unacked frames"
    assert rep.frames_unserved == r_rep.frames_unserved == []
    assert rep.exhausted == r_rep.exhausted is False
    assert ctl.mapping.name == r_ctl.mapping.name
    for ev, r_ev in zip(rep.events, r_rep.events):
        assert (ev.mapping_from, ev.mapping_to, ev.dead_units,
                ev.dead_links, ev.replayed_frames) == (
            r_ev.mapping_from, r_ev.mapping_to, r_ev.dead_units,
            r_ev.dead_links, r_ev.replayed_frames)
        assert ev.t_fail_s == pytest.approx(r_ev.t_fail_s, rel=1e-12)
        assert ev.t_detect_s == pytest.approx(r_ev.t_detect_s, rel=1e-12)
    # the makespan carries each failover's wall-clock re-synthesis; the
    # modeled rest of it is the same schedule in both packages
    modeled = rep.makespan_s - sum(e.resynth_s for e in rep.events)
    r_modeled = r_rep.makespan_s - sum(e.resynth_s for e in r_rep.events)
    assert modeled == pytest.approx(r_modeled, rel=1e-9)
    for i, (o, r_o) in enumerate(zip(outs, r_outs)):
        np.testing.assert_allclose(
            o["Head"].numpy(), np.asarray(r_o["Head"]), atol=LOGITS_TOL,
            rtol=LOGITS_TOL, err_msg=f"frame {i}")
