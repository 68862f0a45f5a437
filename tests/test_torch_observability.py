"""The port's copy of the observability layer, and its engine wiring.

tests/test_observability.py in the port: the metric primitives
(histogram buckets and percentiles, counters, gauges, the registry under
concurrent observers), the Prometheus exposition round trip, the Chrome
``Tracer`` and its validator, and the modeled-clock exporters, run
against ``repro_torch.runtime.observability``; then the engine wiring on
the ``cm-scan`` weights of the golden fixture: greedy tokens identical
with observability on and off, ``metrics_text()`` agreeing with
``snapshot()``, observability off inert, batch admission raise-free, and
counters consistent under submits racing the drain thread.
"""
from __future__ import annotations

import json
import threading

import numpy as np
import pytest

from repro_torch.models.config import ModelConfig
from repro_torch.runtime.observability import (MODELED, SIZE_BUCKETS,
                                               TIME_BUCKETS_S, Counter, Gauge,
                                               Histogram, MetricsRegistry,
                                               Observability, Tracer,
                                               failover_trace,
                                               parse_prometheus,
                                               pipeline_trace,
                                               simulator_trace,
                                               validate_chrome_trace)
from repro_torch.serving import Engine, EngineConfig, Request
from repro_torch.weights import from_jax_params
from test_torch_golden import CONFIG_KW, load_golden

NAME = "cm-scan"
CFG = ModelConfig(**CONFIG_KW[NAME])
WAIT_S = 60


@pytest.fixture(scope="module")
def model():
    g = load_golden()
    n = len(f"{NAME}|params|")
    return from_jax_params({k[n:]: v for k, v in g.items()
                            if k.startswith(f"{NAME}|params|")}, CFG,
                           device="cpu")


def _engine(model, **kw):
    return Engine(CFG, model, EngineConfig(**kw), device="cpu")


def _reqs(specs, seed=0):
    rng = np.random.RandomState(seed)
    return [Request(i, rng.randint(1, CFG.vocab_size, n).astype(np.int32),
                    max_new_tokens=m) for i, (n, m) in enumerate(specs)]


# ---------------------------------------------------------------------------
# histogram math
# ---------------------------------------------------------------------------

def _hist(bounds=(1.0, 2.0, 4.0)):
    return Histogram("h", "", bounds, threading.Lock())


def test_histogram_bucket_edges_inclusive():
    h = _hist()
    for v in (0.5, 1.0, 1.5, 2.0, 4.0, 99.0):
        h.observe(v)
    # inclusive upper edges: 1.0 lands in the le=1 bucket, 2.0 in le=2,
    # 4.0 in le=4, 99.0 overflows
    assert h.buckets() == [(1.0, 2), (2.0, 4), (4.0, 5), (float("inf"), 6)]
    assert h.count == 6 and h.min == 0.5 and h.max == 99.0


def test_histogram_single_value_exact_at_every_quantile():
    h = _hist()
    h.observe(1.7)
    for q in (0, 50, 90, 99, 100):
        assert h.percentile(q) == pytest.approx(1.7)
    s = h.summary()
    assert s["count"] == 1 and s["p50"] == pytest.approx(1.7)


def test_histogram_percentiles_interpolate_and_clamp():
    h = _hist(bounds=tuple(float(b) for b in range(1, 101)))
    for v in range(1, 101):
        h.observe(float(v))
    # uniform 1..100: interpolated percentiles track the data within a
    # bucket's width
    assert h.percentile(50) == pytest.approx(50.0, abs=1.0)
    assert h.percentile(90) == pytest.approx(90.0, abs=1.0)
    # clamped to the observed extremes
    assert h.percentile(0) == 1.0 and h.percentile(100) == 100.0


def test_histogram_overflow_percentile_is_observed_max():
    h = _hist(bounds=(1.0,))
    for v in (10.0, 20.0, 30.0):
        h.observe(v)
    assert h.percentile(99) == 30.0


def test_histogram_empty_summary_and_reset():
    h = _hist()
    assert h.summary() == {"count": 0, "sum": 0.0}
    h.observe(2.0)
    assert h.summary()["count"] == 1
    h.reset()
    assert h.summary() == {"count": 0, "sum": 0.0}
    assert h.buckets()[-1][1] == 0


def test_histogram_rejects_unsorted_bounds():
    with pytest.raises(ValueError, match="increasing"):
        _hist(bounds=(2.0, 1.0))
    with pytest.raises(ValueError, match="increasing"):
        _hist(bounds=(1.0, 1.0))


def test_histogram_percentile_range_checked():
    h = _hist()
    h.observe(1.0)
    with pytest.raises(ValueError, match="percentile"):
        h.percentile(101)


# ---------------------------------------------------------------------------
# counters, gauges, registry
# ---------------------------------------------------------------------------

def test_counter_inc_and_monotone_sync():
    c = Counter("c", "", threading.Lock())
    c.inc()
    c.inc(4)
    assert c.value == 5
    c.sync(12)                      # external total overtakes
    assert c.value == 12
    c.sync(3)                       # never goes backwards
    assert c.value == 12


def test_gauge_set_inc_dec():
    g = Gauge("g", "", threading.Lock())
    g.set(5.0)
    g.inc(2.0)
    g.dec(3.0)
    assert g.value == 4.0


def test_registry_get_or_create_and_kind_mismatch():
    reg = MetricsRegistry()
    h1 = reg.histogram("x", TIME_BUCKETS_S)
    assert reg.histogram("x") is h1
    with pytest.raises(TypeError, match="already registered"):
        reg.counter("x")
    snap = reg.snapshot()
    assert set(snap) == {"counters", "gauges", "histograms"}
    assert "x" in snap["histograms"]


def test_registry_reset_histograms_keeps_counters():
    reg = MetricsRegistry()
    reg.counter("c").inc(7)
    reg.histogram("h", (1.0,)).observe(0.5)
    reg.reset_histograms()
    snap = reg.snapshot()
    assert snap["counters"]["c"] == 7
    assert snap["histograms"]["h"]["count"] == 0


def test_registry_concurrent_observers_exact_totals():
    """8 threads x 500 samples through one shared lock: no sample lost,
    no double count."""
    reg = MetricsRegistry()
    h = reg.histogram("lat", (0.5, 1.0))
    c = reg.counter("n")
    n_threads, per = 8, 500

    def work(i):
        for k in range(per):
            h.observe((i + k) % 3 * 0.4)
            c.inc()

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert c.value == n_threads * per
    assert h.count == n_threads * per
    assert h.buckets()[-1][1] == n_threads * per


# ---------------------------------------------------------------------------
# Prometheus exposition
# ---------------------------------------------------------------------------

def test_render_parse_round_trip():
    reg = MetricsRegistry()
    reg.counter("repro_things_total", help="things").inc(3)
    reg.gauge("repro_depth").set(2.5)
    h = reg.histogram("repro_lat_seconds", (0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    parsed = parse_prometheus(reg.render())
    assert parsed["counters"]["repro_things_total"] == 3
    assert parsed["gauges"]["repro_depth"] == 2.5
    ph = parsed["histograms"]["repro_lat_seconds"]
    assert ph["count"] == 3 and ph["sum"] == pytest.approx(5.55)
    assert ph["buckets"] == [(0.1, 1), (1.0, 2), (float("inf"), 3)]
    cums = [c for _, c in ph["buckets"]]
    assert cums == sorted(cums)


# ---------------------------------------------------------------------------
# tracer + validator
# ---------------------------------------------------------------------------

def test_tracer_produces_validating_trace():
    tr = Tracer()
    tr.begin("engine", "slot 0", "req 1", 0.0)
    tr.complete("engine", "slot 0", "prefill", 0.0, 0.01)
    tr.instant("engine", "slot 0", "prefix-hit", 0.015)
    tr.end("engine", "slot 0", 0.02)
    tr.async_begin("engine", "queue", "req 2 queued", 2, 0.001)
    tr.async_end("engine", "queue", 2, 0.005)
    trace = tr.chrome_trace()
    n = validate_chrome_trace(trace)
    assert n == tr.event_count()
    # metadata first, then ts-sorted events
    evs = trace["traceEvents"]
    meta = [e for e in evs if e["ph"] == "M"]
    rest = [e for e in evs if e["ph"] != "M"]
    assert {e["args"]["name"] for e in meta} >= {"engine", "slot 0", "queue"}
    assert [e["ts"] for e in rest] == sorted(e["ts"] for e in rest)
    assert json.loads(json.dumps(trace)) == trace      # JSON-serializable


def test_tracer_snapshot_closes_open_spans_in_copy_only():
    tr = Tracer()
    tr.begin("engine", "slot 0", "req 9", 0.0)
    t1 = tr.chrome_trace()
    assert validate_chrome_trace(t1) > 0
    closer = [e for e in t1["traceEvents"] if e["ph"] == "E"]
    assert closer and closer[0]["args"]["snapshot_closed"]
    # the live span is still open: ending it later is legal and a new
    # snapshot carries the real E, not a synthetic one
    tr.end("engine", "slot 0", 1.0)
    t2 = tr.chrome_trace()
    assert validate_chrome_trace(t2) > 0
    ends = [e for e in t2["traceEvents"] if e["ph"] == "E"]
    assert len(ends) == 1 and "args" not in ends[0]


def test_tracer_refuses_clock_mixing_per_track():
    tr = Tracer()
    tr.complete("sim", "unit", "a", 0.0, 1.0, clock=MODELED)
    with pytest.raises(ValueError, match="clock"):
        tr.instant("sim", "unit", "b", 2.0)            # wall on modeled track
    # a different track in the same process may use another clock
    tr.instant("sim", "other", "b", 2.0)
    assert validate_chrome_trace(tr.chrome_trace()) > 0


def test_tracer_unmatched_ends_raise():
    tr = Tracer()
    with pytest.raises(RuntimeError, match="no open span"):
        tr.end("p", "t", 0.0)
    with pytest.raises(RuntimeError, match="no open span"):
        tr.async_end("p", "t", 7, 0.0)


def _base_event(**kw):
    ev = {"name": "x", "ph": "X", "pid": 1, "tid": 1, "ts": 1.0, "dur": 1.0,
          "cat": "wall"}
    ev.update(kw)
    return ev


@pytest.mark.parametrize("events,frag", [
    ([{"name": "x", "ph": "X", "pid": 1}], "missing"),
    ([_base_event(ts="soon")], "numeric ts"),
    ([_base_event(ts=5.0), _base_event(ts=1.0)], "out of order"),
    ([_base_event(ph="E", dur=None)], "without matching B"),
    ([_base_event(ph="B")], "unclosed B"),
    ([_base_event(dur=-1.0)], "negative dur"),
    ([_base_event(ph="e", id="7")], "without open 'b'"),
    ([_base_event(ph="b", id="7")], "unclosed async"),
    ([_base_event(ph="?")], "unknown phase"),
    ([_base_event(cat="wall"), _base_event(ts=2.0, cat="modeled")],
     "mixes clocks"),
])
def test_validator_rejects_malformed_traces(events, frag):
    with pytest.raises(ValueError, match=frag):
        validate_chrome_trace({"traceEvents": events})
    with pytest.raises(ValueError, match="traceEvents"):
        validate_chrome_trace({"events": []})


# ---------------------------------------------------------------------------
# modeled-clock exporters
# ---------------------------------------------------------------------------

class _Firing:
    def __init__(self, unit, actor, start_s, finish_s, idx):
        self.unit, self.actor = unit, actor
        self.start_s, self.finish_s = start_s, finish_s
        self.firing_index, self.modeled_s = idx, finish_s - start_s


class _SimResult:
    def __init__(self, firings):
        self.firings = firings


class _FailoverEvent:
    def __init__(self):
        self.t_fail_s, self.t_detect_s, self.resynth_s = 1.0, 1.5, 0.25
        self.dead_units, self.dead_links = ("server",), ()
        self.mapping_from, self.mapping_to = "half", "all-endpoint"
        self.recovery_latency_s, self.replayed_frames = 0.75, 2


class _StageExec:
    def __init__(self, frame, unit, start_s, finish_s):
        self.frame, self.unit = frame, unit
        self.start_s, self.finish_s = start_s, finish_s


class _PipelineSchedule:
    def __init__(self, entries):
        self.entries = entries


def test_pipeline_trace_and_write(tmp_path):
    sched = _PipelineSchedule(entries=[
        _StageExec(0, "endpoint", 0.0, 0.5),
        _StageExec(0, "server", 0.5, 1.0),
        _StageExec(1, "endpoint", 0.5, 1.0),   # overlaps frame 0's stage 2
    ])
    obs = Observability(enabled=True)
    assert pipeline_trace(obs.tracer, sched) == 3
    path = tmp_path / "pipeline_trace.json"
    n = obs.write_trace(str(path))
    trace = json.loads(path.read_text())
    assert validate_chrome_trace(trace) == n
    by_thread = {e["args"]["name"] for e in trace["traceEvents"]
                 if e["ph"] == "M" and e["name"] == "thread_name"}
    assert {"endpoint", "server"} <= by_thread


def test_modeled_exporters_share_one_validating_trace():
    tr = Tracer()
    n_sim = simulator_trace(tr, _SimResult([
        _Firing("endpoint", "Embed", 0.0, 0.4, 0),
        _Firing("server", "Head", 0.4, 0.9, 0)]))
    n_fo = failover_trace(tr, [_FailoverEvent()])
    assert (n_sim, n_fo) == (2, 3)
    trace = tr.chrome_trace()
    assert validate_chrome_trace(trace) == tr.event_count()
    cats = {e["cat"] for e in trace["traceEvents"] if e["ph"] != "M"}
    assert cats == {MODELED}
    names = [e["name"] for e in trace["traceEvents"] if e["ph"] == "X"]
    assert {"Embed", "Head", "detection", "resynthesis"} <= set(names)


# ---------------------------------------------------------------------------
# engine wiring
# ---------------------------------------------------------------------------

def test_greedy_tokens_identical_with_observability(model):
    specs = [(8, 6), (12, 6), (10, 4)]
    outs = {}
    for on in (False, True):
        eng = _engine(model, max_len=64, max_slots=2, observability=on)
        outs[on] = [c.tokens for c in eng.generate(_reqs(specs))]
    assert outs[True] == outs[False]


def test_engine_metrics_agree_with_snapshot(model):
    eng = _engine(model, max_len=64, max_slots=2, observability=True)
    eng.generate(_reqs([(8, 5), (10, 5)]))
    parsed = parse_prometheus(eng.metrics_text())
    snap = eng.snapshot()
    assert snap["observability"]
    for k, v in snap["counters"].items():
        name = f"repro_{k}" if k.endswith("_total") else f"repro_{k}_total"
        assert parsed["counters"][name] == v, k
    hists = snap["metrics"]["histograms"]
    assert hists["repro_ttft_seconds"]["count"] == 2
    assert parsed["histograms"]["repro_ttft_seconds"]["count"] == 2
    expect_gaps = snap["counters"]["tokens_generated"] - 2
    assert hists["repro_inter_token_seconds"]["count"] == expect_gaps
    for ph in ("admission", "prefill", "decode", "sampling", "kv"):
        assert hists[f"repro_step_{ph}_seconds"]["count"] > 0, ph
    assert validate_chrome_trace(eng.trace_json()) > 0


def test_engine_observability_off_is_inert(model):
    eng = _engine(model, max_len=64, max_slots=2)
    eng.generate(_reqs([(8, 4)]))
    snap = eng.snapshot()
    assert not snap["observability"]
    assert snap["metrics"]["histograms"] == {}
    assert eng.trace_json()["traceEvents"] == []
    parsed = parse_prometheus(eng.metrics_text())
    assert parsed["counters"]["repro_admissions_total"] == 1


def test_batch_admission_snapshots_raise_free(model):
    eng = _engine(model, max_len=64, admission="batch")
    snap = eng.snapshot()
    assert snap["active_slots"] == 0 and snap["kv"] == {}
    assert set(snap["counters"]) and all(
        v == 0 for v in snap["counters"].values())
    assert eng.stats()["admissions"] == 0
    assert eng.kv_stats() == {}
    parse_prometheus(eng.metrics_text())


def test_concurrent_submit_consistent_counters(model):
    """Submits racing the live drain thread: every request completes,
    counters and histogram counts agree with the total, and the trace
    validates."""
    eng = _engine(model, max_len=64, max_slots=2, observability=True)
    n_threads, per = 4, 3
    handles, errs = [], []
    lock = threading.Lock()

    def client(i):
        try:
            rng = np.random.RandomState(i)
            for k in range(per):
                r = Request(i * per + k,
                            rng.randint(1, CFG.vocab_size, 8).astype(np.int32),
                            max_new_tokens=3)
                with lock:
                    handles.append(eng.submit(r))
        except Exception as e:          # noqa: BLE001 — surfaced below
            errs.append(e)

    with eng.start():
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT_S)
        assert not any(t.is_alive() for t in threads)
        assert not errs
        outs = [h.result(timeout=WAIT_S) for h in handles]
    assert all(c.finish_reason == "length" and len(c.tokens) == 3
               for c in outs)
    snap = eng.snapshot()
    total = n_threads * per
    assert snap["counters"]["requests_submitted"] == total
    assert snap["counters"]["admissions"] == total
    assert snap["counters"]["tokens_generated"] == total * 3
    hists = snap["metrics"]["histograms"]
    assert hists["repro_ttft_seconds"]["count"] == total
    assert hists["repro_queue_wait_seconds"]["count"] == total
    assert validate_chrome_trace(eng.trace_json()) > 0


def test_property_interleaved_observers():
    """ANY interleaving of histogram observes and counter incs across
    two workers keeps registry totals exact (hypothesis; skipped on the
    fast lane)."""
    hypothesis = pytest.importorskip(
        "hypothesis", reason="property tests need hypothesis (see "
                             "nightly lane)")
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=30, deadline=None)
    @given(st.lists(st.tuples(st.integers(0, 1), st.floats(0.0, 10.0)),
                    max_size=60))
    def prop(ops):
        reg = MetricsRegistry()
        h = reg.histogram("h", (1.0, 5.0))
        c = reg.counter("c")
        half = len(ops) // 2
        done = []

        def run(chunk):
            for kind, v in chunk:
                (h.observe(v) if kind else c.inc())
            done.append(1)

        ts = [threading.Thread(target=run, args=(chunk,))
              for chunk in (ops[:half], ops[half:])]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert len(done) == 2
        n_obs = sum(1 for kind, _ in ops if kind)
        assert h.count == n_obs and h.buckets()[-1][1] == n_obs
        assert c.value == len(ops) - n_obs

    prop()


def test_size_buckets_cover_prompt_scale():
    assert SIZE_BUCKETS[0] == 1 and SIZE_BUCKETS[-1] >= 4096
    assert list(SIZE_BUCKETS) == sorted(SIZE_BUCKETS)
