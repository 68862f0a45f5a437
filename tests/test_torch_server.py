"""The port's HTTP front end (``repro_torch.runtime.server``).

tests/test_server.py in the port: a real ``EngineServer`` on an
ephemeral port over the ``cm-scan`` weights of the golden fixture,
driven over sockets with ``http.client``: the health and status
contracts, 404 and 400, ``/generate`` equal to an in-process
caller-pumped run, NDJSON streaming, deadline shedding, 429
backpressure, concurrent clients, ``/metrics`` and ``/trace`` with
observability off and on, a batch engine refused, the multi-tenant
victim cache over HTTP, ``/escalate`` as a plain ingress, and the CLI's
``--probe`` on the CPU. Every socket has a timeout and every thread is
joined with one, so a hang fails in seconds.
"""
from __future__ import annotations

import http.client
import json
import threading
import time

import numpy as np
import pytest

from repro_torch.models.config import ModelConfig
from repro_torch.runtime import server as server_mod
from repro_torch.serving import (Engine, EngineConfig, EngineServer, Request,
                                 ServerConfig, parse_prometheus,
                                 validate_chrome_trace)
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


@pytest.fixture(scope="module")
def server(model):
    eng = _engine(model, max_len=512, max_slots=2, admission="edf",
                  enforce_deadlines=True)
    with EngineServer(eng, ServerConfig(port=0, max_inflight=3)) as srv:
        yield srv


@pytest.fixture(scope="module")
def obs_server(model):
    eng = _engine(model, max_len=512, max_slots=2, observability=True)
    with EngineServer(eng, ServerConfig(port=0, max_inflight=3)) as srv:
        yield srv


def _conn(srv):
    return http.client.HTTPConnection(srv.config.host, srv.port,
                                      timeout=WAIT_S)


def _request(srv, method, path, body=None):
    conn = _conn(srv)
    try:
        conn.request(method, path,
                     json.dumps(body) if body is not None else None,
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, dict(r.getheaders()), r.read()
    finally:
        conn.close()


def _generate(srv, body, path="/generate"):
    status, _, raw = _request(srv, "POST", path, body)
    return status, (json.loads(raw) if raw else None)


def _prompt(seed, n=8):
    return [int(t) for t in np.random.RandomState(seed).randint(1, 64, n)]


def test_health_and_status(server):
    status, _, raw = _request(server, "GET", "/health/live")
    assert status == 200 and json.loads(raw)["status"] == "live"
    status, _, raw = _request(server, "GET", "/health/ready")
    assert status == 200 and json.loads(raw)["status"] == "ready"
    status, _, raw = _request(server, "GET", "/status")
    st = json.loads(raw)
    assert status == 200
    assert st["ready"] and st["max_inflight"] == 3 and st["tier"] == "server"
    assert {"inflight", "queue_depth", "active_slots", "kv", "counters",
            "units"} <= set(st)
    assert st["counters"]["admissions"] >= 1        # the warmup request


def test_unknown_routes(server):
    assert _request(server, "GET", "/nope")[0] == 404
    assert _request(server, "POST", "/nope")[0] == 404


@pytest.mark.parametrize("body,frag", [
    ({}, "prompt"),
    ({"prompt": "hi"}, "prompt"),
    ({"prompt": []}, "prompt"),
    ({"prompt": [1, 2], "max_new_tokens": 0}, "max_new_tokens"),
    ({"prompt": [1, 2], "deadline_s": "soon"}, "deadline_s"),
    ({"prompt": [1, 2], "eos": "x"}, "eos"),
    ({"prompt": [1, 2], "priority": 1.5}, "priority"),
])
def test_bad_requests(server, body, frag):
    status, out = _generate(server, body)
    assert status == 400 and frag in out["error"]


def test_bad_json_body(server):
    conn = _conn(server)
    try:
        conn.request("POST", "/generate", b"{not json",
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        assert r.status == 400 and "bad JSON" in json.loads(r.read())["error"]
    finally:
        conn.close()


def test_generate_matches_inprocess(server, model):
    prompt = _prompt(5, 10)
    status, out = _generate(server, {"prompt": prompt, "max_new_tokens": 7})
    assert status == 200
    assert out["finish_reason"] == "length" and len(out["tokens"]) == 7
    assert out["ttft_s"] >= 0 and out["latency_s"] >= out["ttft_s"]
    ref = _engine(model, max_len=512, max_slots=2)
    (c,) = ref.generate([Request(0, np.asarray(prompt, np.int32),
                                 max_new_tokens=7)])
    assert out["tokens"] == [int(t) for t in c.tokens]


def test_streaming_ndjson(server):
    prompt = _prompt(6)
    conn = _conn(server)
    try:
        conn.request("POST", "/generate",
                     json.dumps({"prompt": prompt, "max_new_tokens": 5,
                                 "stream": True}),
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        assert r.status == 200
        assert r.getheader("Content-Type") == "application/x-ndjson"
        lines = [json.loads(ln) for ln in r.read().splitlines()
                 if ln.strip()]
    finally:
        conn.close()
    toks = [ln["token"] for ln in lines if "token" in ln]
    final = lines[-1]
    assert final["done"] and final["finish_reason"] == "length"
    assert final["tokens"] == toks and len(toks) == 5
    _, out = _generate(server, {"prompt": prompt, "max_new_tokens": 5})
    assert out["tokens"] == toks


def test_escalate_is_a_counted_plain_ingress(server):
    """``/escalate`` takes the ``/generate`` schema, never streams, echoes
    ``seq`` and this server's ``tier``, and is counted apart."""
    before = json.loads(_request(server, "GET", "/status")[2])
    prompt = _prompt(12)
    status, out = _generate(server, {"prompt": prompt, "max_new_tokens": 3,
                                     "stream": True, "seq": 41},
                            path="/escalate")
    assert status == 200
    assert out["tier"] == "server" and out["seq"] == 41
    assert len(out["tokens"]) == 3
    _, plain = _generate(server, {"prompt": prompt, "max_new_tokens": 3})
    assert plain["tokens"] == out["tokens"]
    after = json.loads(_request(server, "GET", "/status")[2])
    assert after["escalations_received"] == before["escalations_received"] + 1


def test_deadline_shed_over_http(server):
    status, out = _generate(server, {"prompt": [1, 2, 3], "deadline_s": 0.0,
                                     "max_new_tokens": 8})
    assert status == 200
    assert out["finish_reason"] == "timeout" and out["tokens"] == []


def test_backpressure_429(server):
    """Fill the bound (3) with long streams: the next request bounces
    with 429 + Retry-After, and capacity returns once they complete."""
    prompt = _prompt(7)
    conns = []
    try:
        for _ in range(3):
            c = _conn(server)
            c.request("POST", "/generate",
                      json.dumps({"prompt": prompt, "max_new_tokens": 300,
                                  "stream": True}),
                      {"Content-Type": "application/json"})
            conns.append(c)
        deadline = time.monotonic() + WAIT_S
        while time.monotonic() < deadline:
            st = json.loads(_request(server, "GET", "/status")[2])
            if st["inflight"] >= 3:
                break
            time.sleep(0.01)
        status, headers, raw = _request(
            server, "POST", "/generate",
            {"prompt": prompt, "max_new_tokens": 2})
        assert status == 429
        assert "admission queue full" in json.loads(raw)["error"]
        assert headers.get("Retry-After") == "1"
    finally:
        for c in conns:
            c.getresponse().read()
            c.close()
    status, out = _generate(server, {"prompt": prompt, "max_new_tokens": 2})
    assert status == 200 and out["finish_reason"] == "length"


def test_concurrent_http_clients(server):
    results, errs = [], []

    def client(i):
        try:
            results.append(_generate(server, {"prompt": _prompt(i),
                                              "max_new_tokens": 4}))
        except Exception as e:          # noqa: BLE001 — surfaced below
            errs.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT_S)
    assert not any(t.is_alive() for t in threads)
    assert not errs
    assert [s for s, _ in results] == [200, 200, 200]
    assert all(len(o["tokens"]) == 4 for _, o in results)


def test_metrics_without_observability(server):
    status, headers, raw = _request(server, "GET", "/metrics")
    assert status == 200
    assert headers["Content-Type"].startswith("text/plain")
    parsed = parse_prometheus(raw.decode())
    st = json.loads(_request(server, "GET", "/status")[2])
    assert not st["observability"]
    assert parsed["counters"]["repro_admissions_total"] \
        == st["counters"]["admissions"]
    assert parsed["counters"]["repro_steps_total"] == st["counters"]["steps"]
    assert parsed["gauges"]["repro_http_max_inflight"] == 3
    ttft = parsed["histograms"].get("repro_ttft_seconds")
    assert ttft is None or ttft["count"] == 0


def test_trace_empty_without_observability(server):
    status, _, raw = _request(server, "GET", "/trace")
    assert status == 200
    trace = json.loads(raw)
    assert validate_chrome_trace(trace) == 0
    assert trace["traceEvents"] == []


def test_metrics_with_observability(obs_server):
    status, out = _generate(obs_server, {"prompt": _prompt(9),
                                         "max_new_tokens": 6})
    assert status == 200 and len(out["tokens"]) == 6
    status, _, raw = _request(obs_server, "GET", "/metrics")
    assert status == 200
    parsed = parse_prometheus(raw.decode())
    st = json.loads(_request(obs_server, "GET", "/status")[2])
    assert st["observability"]
    assert parsed["counters"]["repro_admissions_total"] \
        == st["counters"]["admissions"]
    snap_hists = st["metrics"]["histograms"]
    for name in ("repro_ttft_seconds", "repro_inter_token_seconds",
                 "repro_step_duration_seconds", "repro_queue_wait_seconds"):
        assert parsed["histograms"][name]["count"] \
            == snap_hists[name]["count"], name
    assert snap_hists["repro_ttft_seconds"]["count"] >= 1
    cums = [c for _, c in parsed["histograms"]["repro_ttft_seconds"]
            ["buckets"]]
    assert cums == sorted(cums)
    assert cums[-1] == parsed["histograms"]["repro_ttft_seconds"]["count"]


def test_trace_with_observability(obs_server):
    status, _ = _generate(obs_server, {"prompt": _prompt(10),
                                       "max_new_tokens": 4})
    assert status == 200
    status, _, raw = _request(obs_server, "GET", "/trace")
    assert status == 200
    trace = json.loads(raw)
    assert validate_chrome_trace(trace) > 0
    names = {e.get("name") for e in trace["traceEvents"]}
    assert any(isinstance(n, str) and n.startswith("req ") for n in names)
    assert any(isinstance(n, str) and n.startswith("step ") for n in names)
    cats = {e.get("cat") for e in trace["traceEvents"] if e.get("ph") != "M"}
    assert cats <= {"wall"}


def test_server_rejects_batch_engine(model):
    with pytest.raises(ValueError, match="batch"):
        EngineServer(_engine(model, max_len=64, admission="batch"))


def test_multi_tenant_victim_cache_over_http(model):
    """Two tenants post the same prompt twice each: /status shows the
    per-tenant parked bytes, the second round hits the parked chains
    with unchanged tokens, and a non-string tenant is a 400."""
    eng = _engine(model, max_len=64, max_slots=2, kv_layout="paged",
                  block_size=8, num_blocks=24, prefix_cache=True,
                  victim_cache=True,
                  prefix_cache_tenants={"acme": 1 << 20, "globex": 1 << 20},
                  debug=True)
    prompt = _prompt(11, 20)
    with EngineServer(eng, ServerConfig(port=0, max_inflight=3)) as srv:
        status, out = _generate(srv, {"prompt": prompt, "tenant": 7})
        assert status == 400 and "tenant" in out["error"]
        first = {}
        for tenant in ("acme", "globex"):
            status, out = _generate(srv, {"prompt": prompt,
                                          "max_new_tokens": 6,
                                          "tenant": tenant})
            assert status == 200
            first[tenant] = out["tokens"]
        assert first["acme"] == first["globex"]
        pc = json.loads(_request(srv, "GET", "/status")[2])["prefix_cache"]
        assert pc["enabled"] and pc["victim_cache"]
        assert pc["per_tenant_bytes"].get("acme", 0) > 0
        assert pc["per_tenant_bytes"].get("globex", 0) > 0
        assert pc["tenant_quotas"] == {"acme": 1 << 20, "globex": 1 << 20}
        before = pc["victim_hits"]
        for tenant in ("acme", "globex"):
            status, out = _generate(srv, {"prompt": prompt,
                                          "max_new_tokens": 6,
                                          "tenant": tenant})
            assert status == 200 and out["tokens"] == first[tenant]
        pc = json.loads(_request(srv, "GET", "/status")[2])["prefix_cache"]
        assert pc["victim_hits"] > before
        assert pc["prefill_tokens_saved"] > 0 and pc["bytes_saved"] > 0


def test_cli_probe_serves_on_the_cpu(capsys):
    """``python -m repro_torch.runtime.server --arch qwen2_1_5b --device
    cpu --probe``: the smoke config's server starts, streams a request
    and passes its probes, with the engine flags of the slice on."""
    server_mod.main(["--arch", "qwen2_1_5b", "--device", "cpu", "--probe",
                     "--victim-cache", "--units", "2", "--decode-stages",
                     "2", "--enforce-deadlines"])
    out = capsys.readouterr().out
    assert "probe OK: 8 tokens streamed, finish_reason=length" in out
    assert "layout=paged" in out
