"""The port's serving CLI (``repro_torch.launch.serve``) against the
reference's, on the CPU at the smoke size.

``load_trace`` gives the reference's requests and arrival offsets on one
JSONL file (explicit prompts, ``prompt_len`` lines drawn from the seed,
out-of-order arrivals, ``eos`` / ``priority`` / ``deadline_s``);
``--mode`` maps onto ``--policy`` as the reference maps it; ``--trace``
replays the file through the continuous scheduler with the tokens of an
engine run on the same requests; ``--serve --port 0`` parses, and its
``serve_http`` over the CLI's engine answers a ``POST /generate`` on an
ephemeral port and shuts down when told; and
``--trace-out`` writes a Chrome trace that parses. Every wait has a
timeout.
"""
from __future__ import annotations

import http.client
import json
import queue
import threading

import numpy as np
import pytest

from repro.configs import get_config as jax_config
from repro.launch.serve import load_trace as jax_load_trace
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from repro_torch.runtime.engine import Engine, EngineConfig

TIMEOUT_S = 60
LINES = [
    {"arrival_s": 0.02, "prompt_len": 12, "max_new": 4, "priority": 2},
    {"arrival_s": 0.0, "prompt": [5, 9, 2, 7, 1], "max_new": 6,
     "deadline_s": 0.5, "eos": 3},
    {"prompt_len": 20, "max_new": 3},
    {"arrival_s": 0.01, "prompt_len": 9},
]
ARGV = ["--arch", "gemma3_1b", "--device", "cpu", "--slots", "2"]


@pytest.fixture
def trace_file(tmp_path):
    path = tmp_path / "trace.jsonl"
    path.write_text("\n".join(json.dumps(d) for d in LINES[:2]) + "\n\n"
                    + "\n".join(json.dumps(d) for d in LINES[2:]) + "\n")
    return str(path)


def _fields(r):
    return (r.id, r.prompt.tolist(), r.max_new_tokens, r.eos, r.priority,
            r.deadline_s)


@pytest.mark.parametrize("seed", [0, 3])
def test_load_trace_gives_the_references_requests(trace_file, seed):
    got, got_at = serve.load_trace(trace_file, get_config("gemma3_1b").smoke(),
                                   np.random.RandomState(seed))
    want, want_at = jax_load_trace(trace_file, jax_config("gemma3_1b").smoke(),
                                   np.random.RandomState(seed))
    assert [_fields(r) for r in got] == [_fields(r) for r in want]
    assert got_at == want_at == [0.02, 0.0, 0.0, 0.01]
    assert [r.id for r in got] == [0, 1, 3, 4]     # line numbers


@pytest.mark.parametrize("argv,policy", [
    ([], "batch"), (["--mode", "static-bucket"], "batch"),
    (["--mode", "continuous"], "fifo"),
    (["--mode", "static-bucket", "--policy", "edf"], "edf"),
    (["--mode", "static-bucket", "--serve"], "fifo"),
    (["--trace", "x.jsonl"], "fifo"), (["--paged"], "fifo"),
    (["--prefill-chunk", "4"], "fifo")])
def test_mode_maps_onto_policy_as_in_the_reference(argv, policy):
    assert serve.resolve_policy(serve.parse_args(ARGV + argv)) == policy


def test_trace_replays_through_the_continuous_scheduler(trace_file):
    summary = serve.main(ARGV + ["--trace", trace_file])
    cfg = get_config("gemma3_1b").smoke()
    reqs, _ = serve.load_trace(trace_file, cfg, np.random.RandomState(0))
    eng = Engine(cfg, T.init_params(cfg, 0, device="cpu"), EngineConfig(
        max_len=max(len(r.prompt) + r.max_new_tokens for r in reqs) + 8,
        max_slots=2, admission="fifo"), device="cpu")
    want = eng.generate(reqs)
    assert summary["policy"] == "fifo"
    assert [c.id for c in summary["completions"]] == [r.id for r in reqs]
    assert [c.tokens for c in summary["completions"]] == \
        [c.tokens for c in want]


def test_serve_answers_a_generate_on_an_ephemeral_port():
    args = serve.parse_args(ARGV + ["--serve", "--port", "0"])
    assert args.serve and args.port == 0
    cfg = get_config("gemma3_1b").smoke()
    eng = Engine(cfg, T.init_params(cfg, 0, device="cpu"),
                 EngineConfig.from_args(args, max_len=32, admission="fifo"),
                 device="cpu")
    stop, servers = threading.Event(), queue.Queue()
    t = threading.Thread(target=serve.serve_http, args=(eng, args.port),
                         kwargs=dict(stop=stop, listening=servers.put),
                         daemon=True)
    t.start()
    try:
        srv = servers.get(timeout=TIMEOUT_S)
        conn = http.client.HTTPConnection("127.0.0.1", srv.port,
                                          timeout=TIMEOUT_S)
        try:
            conn.request("POST", "/generate",
                         json.dumps({"prompt": [1, 2, 3], "max_new_tokens": 4}),
                         {"Content-Type": "application/json"})
            r = conn.getresponse()
            out = json.loads(r.read())
        finally:
            conn.close()
        assert r.status == 200
        assert len(out["tokens"]) == 4 and out["finish_reason"] == "length"
    finally:
        stop.set()
        t.join(timeout=TIMEOUT_S)
    assert not t.is_alive()
    assert not srv.engine.running


def test_trace_out_writes_a_chrome_trace(tmp_path):
    path = tmp_path / "trace.json"
    serve.main(ARGV + ["--requests", "3", "--prompt-len", "12",
                       "--max-new", "4", "--policy", "fifo",
                       "--observability", "--trace-out", str(path)])
    trace = json.loads(path.read_text())
    events = trace["traceEvents"]
    assert events and all("ph" in e and "name" in e for e in events)
