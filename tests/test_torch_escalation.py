"""Hierarchical serving on the port (``repro_torch.runtime.escalation``).

tests/test_escalation.py in the port: the escalation policies on
fabricated contexts, the journal's basics, token identity through a
``TieredEngine`` that never / always escalates, the degraded modes
(link down + tight deadline => ``local_fallback``, link down + expired
deadline => ``timeout``), fail-back after a link cut, and the HTTP
integration. Beyond the reference's cases, the two packages meet:

* the port's confidence probe against the reference's jitted one on the
  same weights, within 1e-5;
* one threshold gives the same escalated request set in both packages;
* a journal directory written by either package is rebuilt and replayed
  in order by the other;
* a port ``TieredEngine`` escalates over ``HttpTransport`` to the
  reference's ``EngineServer``, and a reference one to the port's: the
  tokens equal the answering engine's alone.

Tiny fp32 models, weights carried from JAX; every wait has a timeout and
every server an ephemeral port.
"""
from __future__ import annotations

import json
import os

import jax
import numpy as np
import pytest

from repro.models import transformer as RT
from repro.models.config import ModelConfig as RefConfig
from repro.runtime import escalation as RE
from repro.runtime.engine import Engine as RefEngine
from repro.runtime.engine import EngineConfig as RefEngineConfig
from repro.runtime.scheduler import Completion as RefCompletion
from repro.runtime.scheduler import Request as RefRequest
from repro.runtime.server import EngineServer as RefServer
from repro.runtime.server import ServerConfig as RefServerConfig
from repro_torch.models.config import ModelConfig
from repro_torch.runtime.escalation import (EscalationContext,
                                            EscalationJournal,
                                            FlakyTransport, HttpTransport,
                                            InProcessTransport, JournalFull,
                                            JournalReplayer, TieredConfig,
                                            TieredEngine)
from repro_torch.runtime.policies import (AlwaysEscalate,
                                          ConfidenceEscalation,
                                          DeadlineRiskEscalation,
                                          LocalOverloadEscalation,
                                          NeverEscalate, make_escalation)
from repro_torch.runtime.resilience import FailureTrace
from repro_torch.runtime.scheduler import Completion
from repro_torch.serving import (FINISH_REASONS, EngineServer, Request,
                                 ServerConfig, parse_prometheus)
from repro_torch.serving import Engine as _Engine
from repro_torch.serving import EngineConfig
from repro_torch.weights import from_jax_params

TINY = dict(name="tiny", arch_type="dense", n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=64,
            dtype="float32", param_dtype="float32", attn_chunk=16,
            remat=False)
PROBE_TOL = 1e-5
WAIT_S = 60


def Engine(cfg, model, config=None):
    return _Engine(cfg, model, config, device="cpu")


@pytest.fixture(scope="module")
def both():
    """The reference's (config, params) and the port's (config, model)
    over the same weights."""
    rcfg = RefConfig(**TINY)
    params = RT.init_params(rcfg, jax.random.PRNGKey(0))
    cfg = ModelConfig(**TINY)
    return rcfg, params, cfg, from_jax_params(jax.device_get(params), cfg,
                                              device="cpu")


@pytest.fixture(scope="module")
def setup(both):
    return both[2], both[3]


def _prompts(n, length=6, vocab=64, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=length).astype(np.int32)
            for _ in range(n)]


def _local(cfg, params, **kw):
    kw.setdefault("max_slots", 1)
    kw.setdefault("max_len", 64)
    return Engine(cfg, params, EngineConfig(**kw))


# ---------------------------------------------------------------------------
# policies
# ---------------------------------------------------------------------------


class _Ctx:
    """Fabricated EscalationContext stand-in (duck-typed)."""

    def __init__(self, req=None, snapshot=None, conf=1.0, now_s=0.0):
        self.req = req or Request(id=0, prompt=np.zeros(4, np.int32),
                                  max_new_tokens=8)
        self.snapshot = snapshot or {"queue_depth": 0, "kv": {}}
        self.now_s = now_s
        self._conf = conf

    def confidence(self):
        return self._conf


def test_policy_decisions():
    assert NeverEscalate().decide(_Ctx()) is None
    assert AlwaysEscalate().decide(_Ctx()) == "always"
    conf = ConfidenceEscalation(threshold=0.5)
    assert conf.decide(_Ctx(conf=0.9)) is None
    assert conf.decide(_Ctx(conf=0.1)) == "low_confidence"
    risk = DeadlineRiskEscalation(sec_per_token=0.01, safety=1.0)
    slow = _Ctx(req=Request(id=1, prompt=np.zeros(4, np.int32),
                            max_new_tokens=100, deadline_s=0.5),
                snapshot={"queue_depth": 3, "kv": {}})
    assert risk.decide(slow) == "deadline_risk"          # 4*100*0.01 > 0.5
    assert risk.decide(_Ctx()) is None                   # no deadline
    over = LocalOverloadEscalation(max_queue_depth=2)
    assert over.decide(_Ctx(snapshot={"queue_depth": 5, "kv": {}})) \
        == "local_overload"
    assert over.decide(_Ctx()) is None


def test_make_escalation_specs():
    assert [p.name for p in make_escalation("confidence")] == ["confidence"]
    assert [p.name for p in make_escalation(("confidence", "overload"))] \
        == ["confidence", "overload"]
    inst = ConfidenceEscalation(threshold=0.9)
    assert make_escalation(inst) == [inst]
    with pytest.raises(ValueError):
        make_escalation("no-such-policy")


# ---------------------------------------------------------------------------
# journal
# ---------------------------------------------------------------------------


def test_journal_roundtrip_and_capacity(tmp_path):
    j = EscalationJournal(str(tmp_path), capacity=2)
    r = Request(id=5, prompt=np.arange(4, dtype=np.int32), max_new_tokens=3,
                eos=7, priority=2, deadline_s=1.5)
    s0 = j.append(r, arrival_s=0.25)
    s1 = j.append(Request(id=6, prompt=np.ones(2, np.int32)))
    with pytest.raises(JournalFull):
        j.append(Request(id=7, prompt=np.ones(2, np.int32)))
    assert j.depth == 2 and s1 == s0 + 1

    entries = j.pending()
    assert [e.seq for e in entries] == [s0, s1]
    back = entries[0].req
    assert back.id == 5 and back.eos == 7 and back.priority == 2
    assert back.deadline_s == 1.5 and back.max_new_tokens == 3
    np.testing.assert_array_equal(back.prompt, r.prompt)
    assert entries[0].meta["arrival_s"] == 0.25

    j.ack(s0)
    j.ack(s0)                           # idempotent
    assert [e.seq for e in j.pending()] == [s1]
    # restart: pending survives, seq counter never reuses
    j2 = EscalationJournal(str(tmp_path), capacity=2)
    assert [e.seq for e in j2.pending()] == [s1]
    assert j2.append(Request(id=8, prompt=np.ones(2, np.int32))) == s1 + 1


# ---------------------------------------------------------------------------
# tiered engine: identity + escalation paths
# ---------------------------------------------------------------------------


def test_never_escalate_tokens_bit_identical(setup, tmp_path):
    cfg, params = setup
    prompts = _prompts(3)
    with _local(cfg, params) as plain:
        plain.start()
        want = [plain.submit(Request(id=i, prompt=p, max_new_tokens=6))
                .result(WAIT_S).tokens for i, p in enumerate(prompts)]

    server = Engine(cfg, params, EngineConfig(max_slots=2, max_len=64))
    tiered = TieredEngine(
        _local(cfg, params), InProcessTransport(server.start()),
        TieredConfig(policies=("never",), journal_dir=str(tmp_path)))
    with tiered, server:
        tiered.start()
        handles = [tiered.submit(Request(id=i, prompt=p, max_new_tokens=6))
                   for i, p in enumerate(prompts)]
        got = [h.result(WAIT_S).tokens for h in handles]
        assert all(not h.escalated and h.tier == "endpoint" for h in handles)
    assert got == want
    assert tiered.escalation_stats()["escalated"] == 0


def test_always_escalate_matches_and_counts(setup, tmp_path):
    cfg, params = setup
    prompts = _prompts(3, seed=11)
    with _local(cfg, params) as plain:
        plain.start()
        want = [plain.submit(Request(id=i, prompt=p, max_new_tokens=6))
                .result(WAIT_S).tokens for i, p in enumerate(prompts)]

    server = Engine(cfg, params, EngineConfig(max_slots=2, max_len=64))
    tiered = TieredEngine(
        _local(cfg, params), InProcessTransport(server.start()),
        TieredConfig(policies=("always",), journal_dir=str(tmp_path)))
    with tiered, server:
        tiered.start()
        handles = [tiered.submit(Request(id=i, prompt=p, max_new_tokens=6))
                   for i, p in enumerate(prompts)]
        results = [h.result(WAIT_S) for h in handles]
        # same params on both tiers: escalation moved the requests, not
        # the content
        assert [c.tokens for c in results] == want
        assert all(h.escalated and h.tier == "server" for h in handles)
        assert all(h.reason == "always" for h in handles)
        stats = tiered.escalation_stats()
        assert stats["escalated"] == 3 and stats["queue_depth"] == 0


def test_stream_surface_on_both_paths(setup, tmp_path):
    cfg, params = setup
    server = Engine(cfg, params, EngineConfig(max_slots=2, max_len=64))
    tiered = TieredEngine(
        _local(cfg, params), InProcessTransport(server.start()),
        TieredConfig(policies=("never",), journal_dir=str(tmp_path / "a")))
    with tiered, server:
        tiered.start()
        h = tiered.submit(Request(id=0, prompt=_prompts(1)[0],
                                  max_new_tokens=5))
        toks = list(h.stream())
        assert h.completion is not None and toks == list(h.completion.tokens)

    server2 = Engine(cfg, params, EngineConfig(max_slots=2, max_len=64))
    tiered2 = TieredEngine(
        _local(cfg, params), InProcessTransport(server2.start()),
        TieredConfig(policies=("always",), journal_dir=str(tmp_path / "b")))
    with tiered2, server2:
        tiered2.start()
        h = tiered2.submit(Request(id=0, prompt=_prompts(1)[0],
                                   max_new_tokens=5))
        toks = list(h.stream())
        assert h.escalated and toks == list(h.completion.tokens)


# ---------------------------------------------------------------------------
# degraded modes: link down
# ---------------------------------------------------------------------------


def _dead_link_transport(server, *, revive_at=None):
    trace = FailureTrace().kill_link("endpoint", "server", at=0.0)
    if revive_at is not None:
        trace.revive_link("endpoint", "server", at=revive_at)
    return FlakyTransport(InProcessTransport(server), trace)


def test_local_fallback_when_link_down_and_deadline_tight(setup, tmp_path):
    cfg, params = setup
    server = Engine(cfg, params, EngineConfig(max_slots=2, max_len=64))
    tiered = TieredEngine(
        _local(cfg, params), _dead_link_transport(server.start()),
        TieredConfig(policies=("always",), journal_dir=str(tmp_path),
                     fallback_slack_s=10.0))     # any deadline => fallback now
    with tiered, server:
        tiered.start()
        h = tiered.submit(Request(id=0, prompt=_prompts(1)[0],
                                  max_new_tokens=5, deadline_s=5.0))
        c = h.result(WAIT_S)
    assert c.finish_reason == "local_fallback"
    assert c.finish_reason in FINISH_REASONS
    assert len(c.tokens) == 5                    # answered, on-device
    assert h.escalated and h.tier == "endpoint"  # decided up, served down
    stats = tiered.escalation_stats()
    assert stats["local_fallback"] == 1 and stats["escalated"] == 0
    assert stats["queue_depth"] == 0             # fallback acked the entry


def test_timeout_shed_when_link_down_and_deadline_expired(setup, tmp_path):
    cfg, params = setup
    server = Engine(cfg, params, EngineConfig(max_slots=2, max_len=64))
    tiered = TieredEngine(
        _local(cfg, params), _dead_link_transport(server.start()),
        TieredConfig(policies=("always",), journal_dir=str(tmp_path),
                     fallback_slack_s=0.0))      # no fallback window: shed
    with tiered, server:
        tiered.start()
        h = tiered.submit(Request(id=0, prompt=_prompts(1)[0],
                                  max_new_tokens=5, deadline_s=0.05))
        c = h.result(WAIT_S)
    assert c.finish_reason == "timeout" and c.finish_reason in FINISH_REASONS
    assert c.tokens == []                        # shed, never decoded
    assert tiered.escalation_stats()["sheds"] == 1


def test_link_cut_then_failback_replays_durably(setup, tmp_path):
    cfg, params = setup
    server = Engine(cfg, params, EngineConfig(max_slots=2, max_len=64))
    tiered = TieredEngine(
        _local(cfg, params),
        _dead_link_transport(server.start(), revive_at=1.0),
        TieredConfig(policies=("always",), journal_dir=str(tmp_path)))
    with tiered, server:
        tiered.start()
        # deadline-free: waits durably in the journal through the cut
        hs = [tiered.submit(Request(id=i, prompt=p, max_new_tokens=4))
              for i, p in enumerate(_prompts(2, seed=3))]
        assert tiered.journal.depth == 2         # stranded behind the cut
        results = [h.result(WAIT_S) for h in hs]     # ...until revival
        assert [c.finish_reason for c in results] == ["length", "length"]
        assert all(h.tier == "server" for h in hs)
        stats = tiered.escalation_stats()
        assert stats["failback"] >= 1 and stats["escalated"] == 2
        assert stats["queue_depth"] == 0 and stats["link_up"]


# ---------------------------------------------------------------------------
# HTTP integration
# ---------------------------------------------------------------------------


def _http(srv, method, path, body=None):
    import http.client
    conn = http.client.HTTPConnection(srv.config.host, srv.port, timeout=WAIT_S)
    try:
        conn.request(method, path,
                     json.dumps(body) if body is not None else None,
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def test_server_fronting_tiered_engine(setup, tmp_path):
    cfg, params = setup
    remote = Engine(cfg, params, EngineConfig(max_slots=2, max_len=64))
    tiered = TieredEngine(
        _local(cfg, params, observability=True),
        InProcessTransport(remote.start()),
        TieredConfig(policies=("always",), journal_dir=str(tmp_path)))
    with remote, \
            EngineServer(tiered, ServerConfig(port=0, max_inflight=4)) as srv:
        status, raw = _http(srv, "POST", "/generate",
                            {"prompt": [1, 2, 3], "max_new_tokens": 4})
        assert status == 200
        out = json.loads(raw)
        assert len(out["tokens"]) == 4
        assert out["finish_reason"] in FINISH_REASONS

        status, raw = _http(srv, "GET", "/status")
        st = json.loads(raw)
        assert st["tier"] == "endpoint"
        esc = st["escalation"]
        # warmup goes through the policy gate too, so >= the one client
        # request; everything that finished left the journal
        assert esc["escalated"] >= 1 and esc["queue_depth"] == 0

        status, raw = _http(srv, "GET", "/metrics")
        m = parse_prometheus(raw.decode())
        for name in ("repro_escalated_total", "repro_local_fallback_total",
                     "repro_failback_total"):
            assert name in m["counters"], name
        assert "repro_escalation_queue_depth" in m["gauges"]
        assert m["counters"]["repro_escalated_total"] == esc["escalated"]
        assert m["histograms"]["repro_tier_server_ttft_seconds"]["count"] \
            >= 1


def test_escalate_route_and_http_transport(setup):
    cfg, params = setup
    eng = Engine(cfg, params, EngineConfig(max_slots=2, max_len=64))
    with EngineServer(eng, ServerConfig(port=0, tier="edge-server")) as srv:
        # raw route: metadata echo + tier identity
        status, raw = _http(srv, "POST", "/escalate",
                            {"prompt": [1, 2, 3], "max_new_tokens": 4,
                             "seq": 17, "source": "endpoint"})
        assert status == 200
        out = json.loads(raw)
        assert out["seq"] == 17 and out["tier"] == "edge-server"
        assert len(out["tokens"]) == 4

        # the ingress is counted separately from client traffic
        _, raw = _http(srv, "GET", "/status")
        st = json.loads(raw)
        assert st["tier"] == "edge-server"
        assert st["escalations_received"] == 1

        # HttpTransport: the client half of the same wire
        tr = HttpTransport(srv.url, tier="edge-server")
        assert tr.healthy()
        c = tr.send(Request(id=9, prompt=np.array([1, 2, 3], np.int32),
                            max_new_tokens=4), seq=18)
        assert len(c.tokens) == 4 and c.finish_reason in FINISH_REASONS
        _, raw = _http(srv, "GET", "/status")
        assert json.loads(raw)["escalations_received"] == 2


# ---------------------------------------------------------------------------
# cross-package: probe, escalated set, journal, HTTP both ways
# ---------------------------------------------------------------------------


def test_context_is_lazy_and_cached():
    calls = []
    ctx = EscalationContext(
        req=Request(id=0, prompt=np.zeros(4, np.int32)), now_s=0.0,
        snapshot_fn=lambda: calls.append("snap") or {"queue_depth": 1},
        confidence_fn=lambda: calls.append("conf") or 0.25)
    assert calls == []
    assert ctx.confidence() == ctx.confidence() == 0.25
    assert ctx.snapshot == ctx.snapshot == {"queue_depth": 1}
    assert calls == ["conf", "snap"]


def _tiered_pair(both, tmp_path, policies):
    """An unstarted reference and port TieredEngine over the same weights
    (in-process server tiers of 2 slots)."""
    rcfg, params, cfg, model = both
    ref = RE.TieredEngine(
        RefEngine(rcfg, params, RefEngineConfig(max_slots=1, max_len=64)),
        RE.InProcessTransport(RefEngine(rcfg, params, RefEngineConfig(
            max_slots=2, max_len=64))),
        RE.TieredConfig(policies=policies,
                        journal_dir=str(tmp_path / "ref")))
    port = TieredEngine(
        _local(cfg, model),
        InProcessTransport(Engine(cfg, model, EngineConfig(
            max_slots=2, max_len=64))),
        TieredConfig(policies=policies, journal_dir=str(tmp_path / "port")))
    return ref, port


def test_confidence_probe_matches_reference(both, tmp_path):
    ref, port = _tiered_pair(both, tmp_path, ("never",))
    for seed, length in ((1, 6), (2, 6), (3, 9)):
        for p in _prompts(2, length=length, seed=seed):
            req = Request(id=0, prompt=p)
            got = port._confidence(req)
            want = ref._confidence(RefRequest(id=0, prompt=p))
            assert 0.0 < got <= 1.0
            assert abs(got - want) <= PROBE_TOL, (got, want)


def _drive(tiered, request, prompts, max_new=2):
    """Start ``tiered`` and its in-process server tier, submit
    ``prompts`` (built by ``request``, the package's Request), and return
    each handle's (escalated, reason, tokens, tier)."""
    tiered.transport.engine.start()
    tiered.start()
    try:
        hs = [tiered.submit(request(id=i, prompt=p, max_new_tokens=max_new))
              for i, p in enumerate(prompts)]
        return [(h.escalated, h.reason, list(h.result(WAIT_S).tokens),
                 h.tier) for h in hs]
    finally:
        tiered.shutdown()
        tiered.transport.engine.shutdown()


def test_same_escalated_set_under_one_threshold(both, tmp_path):
    """The threshold sits halfway between two neighbouring reference
    probe values, each far more than the probe tolerance from it, so
    both packages must split the traffic the same way, and every
    request must get the same tokens from the same tier."""
    prompts = _prompts(8, seed=21)
    ref, _ = _tiered_pair(both, tmp_path / "probe", ("never",))
    confs = sorted(ref._confidence(RefRequest(id=0, prompt=p))
                   for p in prompts)
    k = len(confs) // 2
    assert confs[k] - confs[k - 1] > 10 * PROBE_TOL
    gate = (ConfidenceEscalation((confs[k - 1] + confs[k]) / 2),)
    ref, port = _tiered_pair(both, tmp_path, gate)
    want = _drive(ref, RefRequest, prompts)
    got = _drive(port, Request, prompts)
    assert [w[0] for w in want].count(True) == k
    assert got == want


class _Ledger:
    """Server tier as a ledger: answers each request with its prompt."""

    tier = "server"

    def __init__(self, completion):
        self.completion = completion
        self.sent = []

    def healthy(self):
        return True

    def send(self, req, *, seq=None):
        self.sent.append((seq, req.id, [int(t) for t in req.prompt],
                          req.max_new_tokens, req.eos, req.priority,
                          req.deadline_s))
        return self.completion(req.id, [int(t) for t in req.prompt], 0.0,
                               0.0, finish_reason="eos")


JOURNALS = {"ref": (RE.EscalationJournal, RE.JournalReplayer, RefRequest,
                    RefCompletion),
            "port": (EscalationJournal, JournalReplayer, Request,
                     Completion)}


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_journal_restores_and_replays_across_packages(tmp_path, writer,
                                                      reader):
    """Entries appended (and one acked) by one package's journal are
    rebuilt by the other's from the directory alone, replayed in seq
    order with their fields intact, acked off the disk, and the seq
    counter carries on past the writer's."""
    w_journal, _, w_request, _ = JOURNALS[writer]
    r_journal, r_replayer, r_request, r_completion = JOURNALS[reader]
    root = str(tmp_path)
    j = w_journal(root, capacity=8)
    specs = [dict(id=10 + i, prompt=np.arange(i, i + 3 + i, dtype=np.int32),
                  max_new_tokens=2 + i, eos=[None, 5, 7, None][i],
                  priority=i % 2, deadline_s=[None, 1.5, None, 0.25][i])
             for i in range(4)]
    seqs = [j.append(w_request(**s), arrival_s=0.5 * k)
            for k, s in enumerate(specs)]
    j.ack(seqs[1])
    live = [s for k, s in enumerate(specs) if k != 1]

    back = r_journal(root, capacity=8)
    entries = back.pending()
    assert [e.seq for e in entries] == [seqs[0], seqs[2], seqs[3]]
    for e, s in zip(entries, live):
        assert (e.req.id, e.req.max_new_tokens, e.req.eos, e.req.priority,
                e.req.deadline_s) == (s["id"], s["max_new_tokens"], s["eos"],
                                      s["priority"], s["deadline_s"])
        np.testing.assert_array_equal(e.req.prompt, s["prompt"])
    assert [e.meta["arrival_s"] for e in entries] == [0.0, 1.0, 1.5]
    ledger = _Ledger(r_completion)
    surfaced = []
    rep = r_replayer(back, ledger,
                     on_complete=lambda e, c: surfaced.append((e.seq, c)))
    assert rep.step() == 3
    assert [seq for seq, _ in surfaced] == [seqs[0], seqs[2], seqs[3]]
    assert [c.tokens for _, c in surfaced] == [
        [int(t) for t in s["prompt"]] for s in live]
    assert back.depth == 0
    assert sorted(os.listdir(root)) == ["journal.state.json"]
    assert back.append(r_request(id=99, prompt=np.ones(2, np.int32))) \
        == seqs[-1] + 1


def _ref_server(both, port_tier="ref-server"):
    rcfg, params, _, _ = both
    return RefServer(RefEngine(rcfg, params, RefEngineConfig(
        max_slots=2, max_len=64)), RefServerConfig(port=0, tier=port_tier))


def test_port_tiered_engine_escalates_to_reference_server(both, tmp_path):
    """A port endpoint escalates over HTTP to the reference's server: the
    tokens equal the reference engine's answer and the port engine's."""
    rcfg, params, cfg, model = both
    prompts = _prompts(3, seed=5)
    with _local(cfg, model) as plain:
        plain.start()
        want = [plain.submit(Request(id=i, prompt=p, max_new_tokens=4))
                .result(WAIT_S).tokens for i, p in enumerate(prompts)]
    with _ref_server(both) as srv:
        tiered = TieredEngine(
            _local(cfg, model), HttpTransport(srv.url, tier="ref-server",
                                              timeout_s=WAIT_S),
            TieredConfig(policies=("always",), journal_dir=str(tmp_path)))
        with tiered:
            tiered.start()
            hs = [tiered.submit(Request(id=i, prompt=p, max_new_tokens=4))
                  for i, p in enumerate(prompts)]
            got = [h.result(WAIT_S) for h in hs]
        assert all(h.escalated and h.tier == "ref-server" for h in hs)
        assert srv.status()["escalations_received"] == len(prompts)
    assert [c.tokens for c in got] == want
    assert all(c.finish_reason == "length" for c in got)


def test_reference_tiered_engine_escalates_to_port_server(both, tmp_path):
    """And the other way round: a reference endpoint escalates over HTTP
    to the port's server."""
    rcfg, params, cfg, model = both
    prompts = _prompts(3, seed=6)
    with _local(cfg, model) as plain:
        plain.start()
        want = [plain.submit(Request(id=i, prompt=p, max_new_tokens=4))
                .result(WAIT_S).tokens for i, p in enumerate(prompts)]
    eng = Engine(cfg, model, EngineConfig(max_slots=2, max_len=64))
    with EngineServer(eng, ServerConfig(port=0, tier="port-server")) as srv:
        tiered = RE.TieredEngine(
            RefEngine(rcfg, params, RefEngineConfig(max_slots=1,
                                                    max_len=64)),
            RE.HttpTransport(srv.url, tier="port-server", timeout_s=WAIT_S),
            RE.TieredConfig(policies=("always",),
                            journal_dir=str(tmp_path)))
        with tiered:
            tiered.start()
            hs = [tiered.submit(RefRequest(id=i, prompt=p, max_new_tokens=4))
                  for i, p in enumerate(prompts)]
            got = [h.result(WAIT_S) for h in hs]
        assert all(h.escalated and h.tier == "port-server" for h in hs)
        assert srv.status()["escalations_received"] == len(prompts)
    assert [list(c.tokens) for c in got] == want


def test_engines_on_one_device_take_turns_a_step_at_a_time(setup):
    """The endpoint and server engines of a tiered setup share the
    device's step lock: with both draining at once (and a short switch
    interval), no two steps' model work overlaps, and every request
    gets the tokens it gets alone."""
    import sys
    import threading
    from repro_torch.runtime.scheduler import device_step_lock
    cfg, model = setup
    prompts = _prompts(6, seed=13)
    with _local(cfg, model) as plain:
        plain.start()
        want = [plain.submit(Request(id=i, prompt=p, max_new_tokens=5))
                .result(WAIT_S).tokens for i, p in enumerate(prompts)]
    engines = [_local(cfg, model),
               Engine(cfg, model, EngineConfig(max_slots=3, max_len=64))]
    assert engines[0].scheduler.step_lock \
        is engines[1].scheduler.step_lock is device_step_lock("cpu")
    inside, peak, guard = [0], [0], threading.Lock()

    def watched(work):
        def step_work():
            with guard:
                inside[0] += 1
                peak[0] = max(peak[0], inside[0])
            try:
                return work()
            finally:
                with guard:
                    inside[0] -= 1
        return step_work
    for e in engines:
        e.scheduler._step_work = watched(e.scheduler._step_work)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for e in engines:
            e.start()
        hs = [engines[i % 2].submit(Request(id=i, prompt=p,
                                            max_new_tokens=5))
              for i, p in enumerate(prompts)]
        got = [h.result(WAIT_S).tokens for h in hs]
    finally:
        sys.setswitchinterval(interval)
        for e in engines:
            e.shutdown()
    assert got == want
    assert peak[0] == 1
