"""HTTP serving front end of the port over the background-drained
``Engine``.

Counterpart of ``repro.runtime.server`` over the port's ``Engine``, with
every route of the reference. A deliberately dependency-free server (stdlib ``http.server`` only — the
container has no web framework) that exposes the wall-clock serving
surface built in ``runtime.engine``:

* ``POST /generate`` — submit one request. Body is JSON::

      {"prompt": [1, 2, 3], "max_new_tokens": 32,
       "eos": null, "priority": 0, "deadline_s": null, "stream": false}

  ``prompt`` is a list of token ids (the repro has no tokenizer — the
  model speaks ids). Non-streaming responses return one JSON object
  ``{"id", "tokens", "finish_reason", "ttft_s", "latency_s"}``;
  ``"stream": true`` switches to chunked transfer encoding with one
  NDJSON line per token (``{"token": 17}``) and a terminal line
  carrying the completion (``{"done": true, "finish_reason": ...}``),
  so time-to-first-byte tracks time-to-first-token.
* ``GET /health/live`` — process is up (200 always once listening).
* ``GET /health/ready`` — 200 after the warmup request has built and
  launched the prefill/decode kernels, 503 before; load balancers gate
  on this.
* ``GET /status`` — queue depth, in-flight count, KV pool occupancy,
  lifecycle counters, and (observability on) histogram summaries — one
  consistent ``Engine.snapshot()`` taken under the engine's own lock.
* ``GET /metrics`` — Prometheus text exposition: lifecycle counters and
  occupancy gauges always; TTFT / inter-token / step-duration /
  queue-wait / per-phase histograms when the engine was built with
  ``EngineConfig(observability=True)``.
* ``GET /trace`` — the engine's Chrome trace-event JSON so far (loads
  in Perfetto / ``chrome://tracing``; empty-but-valid with
  observability off).
* ``POST /escalate`` — the tier-to-tier ingress: same request schema as
  ``/generate`` (plus optional ``seq``/``source`` echoed back) but
  always non-streaming, counted separately
  (``repro_escalations_received_total``). A ``runtime.escalation``
  ``HttpTransport`` on an endpoint posts its journal replays here; the
  response carries this server's ``tier`` so the endpoint can label
  per-tier latency. ``/status`` reports ``tier`` — from ``ServerConfig``
  for a plain engine, or the fronted ``TieredEngine``'s own identity —
  so topology is discoverable.

Backpressure: admission is bounded. At most ``max_inflight`` requests
may be open (queued + decoding) at once; a ``/generate`` beyond that is
refused with 429 + ``Retry-After`` instead of growing the queue without
bound — on an edge device the right failure mode is to shed at the
front door, not to OOM. Per-request wall-clock deadlines compose with
this: with ``enforce_deadlines`` on, an admitted-but-expired request
comes back with ``finish_reason="timeout"``.

``ThreadingHTTPServer`` gives one thread per connection; every handler
thread just blocks on its ``RequestHandle`` (condition-variable waits)
while the engine's single drain thread pumps the scheduler — the model
never runs concurrently with itself, so there is exactly one step loop
no matter how many clients connect.

Run it on the card at full width, or rehearse it on the CPU::

    PYTHONPATH=src python -m repro_torch.runtime.server --arch qwen2_1_5b \
        --no-smoke --paged --port 8800
    PYTHONPATH=src python -m repro_torch.runtime.server --arch qwen2_1_5b \
        --device cpu --port 0 --probe

``--smoke`` (the default) serves the config's reduced ``.smoke()``
variant and ``--no-smoke`` its full width and depth, as in
``repro_torch.launch.serve``; weights are the port's seeded init.
``--probe`` starts the server, streams one request through the HTTP
surface, checks ``/health/ready``, ``/status``, ``/metrics`` and
``/trace``, and exits (the reference's ``--smoke`` liveness run).
"""
from __future__ import annotations

import itertools
import json
import threading
import time
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

import numpy as np

from repro_torch.runtime.engine import Engine, EngineConfig
from repro_torch.runtime.scheduler import Request

__all__ = ["ServerConfig", "EngineServer", "main"]


@dataclass
class ServerConfig:
    host: str = "127.0.0.1"
    port: int = 8800            # 0 = ephemeral (tests); read .port after start
    # admission bound: open requests (queued + decoding) before /generate
    # starts returning 429. Sized to a small multiple of the decode batch
    # so the queue stays short enough for deadlines to be meetable.
    max_inflight: int = 32
    retry_after_s: int = 1      # Retry-After hint on 429
    # per-request cap on max_new_tokens (a client can't pin a slot for
    # an unbounded decode); 0 disables the cap
    max_new_cap: int = 0
    # run one request before reporting ready: it builds and launches the
    # kernels, so readiness means ready
    warmup: bool = True
    # this server's tier identity in a hierarchical (endpoint <-> server)
    # topology: reported in /status and echoed by /escalate. A fronted
    # TieredEngine's own tier takes precedence.
    tier: str = "server"


class _BadRequest(ValueError):
    """Client error -> 400 with the message in the JSON body."""


class EngineServer:
    """Own an ``Engine`` (background-drained) plus the HTTP listener.

    ``start()`` spawns the engine drain thread, runs the warmup request
    (so the first client never pays for building the kernels and
    readiness actually means ready), then starts serving; ``close()``
    tears both down. Usable as a context manager."""

    def __init__(self, engine: Engine, config: Optional[ServerConfig] = None):
        if engine.batch_mode:
            raise ValueError(
                "the HTTP server drives the background drain; batch "
                "admission has no step loop — use a continuous admission "
                "policy (fifo | priority | edf)")
        self.engine = engine
        self.config = config or ServerConfig()
        self.ready = threading.Event()
        self._ids = itertools.count()
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._http_thread: Optional[threading.Thread] = None
        self.port = self.config.port
        self._escalations = engine.obs.registry.counter(
            "repro_escalations_received_total",
            help="requests ingested through /escalate (tier-to-tier "
                 "traffic, vs. client traffic on /generate)")

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "EngineServer":
        self.engine.start()
        if self.config.warmup:
            self._warmup()
        server = self

        class Handler(_Handler):
            srv = server

        self._httpd = ThreadingHTTPServer(
            (self.config.host, self.config.port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, name="engine-http", daemon=True)
        self._http_thread.start()
        self.ready.set()
        return self

    def close(self) -> None:
        self.ready.clear()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        self.engine.shutdown()

    def __enter__(self) -> "EngineServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def url(self) -> str:
        return f"http://{self.config.host}:{self.port}"

    def _warmup(self) -> None:
        """One short greedy request through the live engine builds and
        launches the prefill/decode kernels before /health/ready reports
        200."""
        prompt = np.ones(min(8, self.engine.max_len - 2), np.int32)
        self.engine.submit(
            Request(id=next(self._ids), prompt=prompt,
                    max_new_tokens=2)).result()

    # -- request plumbing (called from handler threads) ---------------------

    def admit(self, body: Dict[str, Any]):
        """Validate + submit under the admission bound. Returns the
        ``RequestHandle`` or raises ``_BadRequest`` / ``_Overloaded``."""
        prompt = body.get("prompt")
        if (not isinstance(prompt, list) or not prompt
                or not all(isinstance(t, int) for t in prompt)):
            raise _BadRequest("'prompt' must be a non-empty list of "
                              "token ids (ints)")
        max_new = body.get("max_new_tokens", 16)
        if not isinstance(max_new, int) or max_new < 1:
            raise _BadRequest("'max_new_tokens' must be a positive int")
        cap = self.config.max_new_cap
        if cap:
            max_new = min(max_new, cap)
        deadline_s = body.get("deadline_s")
        if deadline_s is not None \
                and not isinstance(deadline_s, (int, float)):
            raise _BadRequest("'deadline_s' must be a number (seconds)")
        eos = body.get("eos")
        if eos is not None and not isinstance(eos, int):
            raise _BadRequest("'eos' must be an int token id")
        priority = body.get("priority", 0)
        if not isinstance(priority, int):
            raise _BadRequest("'priority' must be an int")
        tenant = body.get("tenant", "")
        if not isinstance(tenant, str):
            raise _BadRequest("'tenant' must be a string (prefix-cache "
                              "namespace)")
        req = Request(
            id=next(self._ids),
            prompt=np.asarray(prompt, np.int32),
            max_new_tokens=max_new, eos=eos, priority=priority,
            deadline_s=float(deadline_s) if deadline_s is not None else None,
            tenant=tenant)
        with self._inflight_lock:
            if self._inflight >= self.config.max_inflight:
                raise _Overloaded(self.config.max_inflight)
            self._inflight += 1
        try:
            handle = self.engine.submit(req)
        except Exception:
            with self._inflight_lock:
                self._inflight -= 1
            raise
        return handle

    def release(self) -> None:
        with self._inflight_lock:
            self._inflight -= 1

    def status(self) -> Dict[str, Any]:
        st = self.engine.snapshot()     # engine state under the engine lock
        st.update(ready=self.ready.is_set(), inflight=self._inflight,
                  max_inflight=self.config.max_inflight,
                  escalations_received=int(self._escalations.value))
        # a TieredEngine snapshot already carries its own tier identity
        st.setdefault("tier", self.config.tier)
        return st

    def metrics_text(self) -> str:
        """Prometheus exposition: the engine's registry plus the
        server-side admission-bound gauges."""
        with self._inflight_lock:
            inflight = self._inflight
        return self.engine.metrics_text(extra_gauges={
            "repro_http_inflight": float(inflight),
            "repro_http_max_inflight": float(self.config.max_inflight)})


class _Overloaded(RuntimeError):
    """Admission bound hit -> 429."""

    def __init__(self, bound: int):
        super().__init__(f"admission queue full ({bound} requests in flight)")


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"       # keep-alive + chunked streaming
    srv: EngineServer = None            # bound per-server in start()

    # quiet: the default handler logs every request line to stderr
    def log_message(self, fmt, *args):  # noqa: D102
        pass

    # -- helpers ------------------------------------------------------------

    def _json(self, code: int, obj: Dict[str, Any],
              headers: Optional[Dict[str, str]] = None) -> None:
        data = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def _chunk(self, data: bytes) -> None:
        self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")

    # -- routes -------------------------------------------------------------

    def do_GET(self) -> None:
        if self.path == "/health/live":
            self._json(200, {"status": "live"})
        elif self.path == "/health/ready":
            if self.srv.ready.is_set():
                self._json(200, {"status": "ready"})
            else:
                self._json(503, {"status": "starting"})
        elif self.path == "/status":
            self._json(200, self.srv.status())
        elif self.path == "/metrics":
            data = self.srv.metrics_text().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
        elif self.path == "/trace":
            self._json(200, self.srv.engine.trace_json())
        else:
            self._json(404, {"error": f"no route {self.path!r}"})

    def do_POST(self) -> None:
        if self.path not in ("/generate", "/escalate"):
            self._json(404, {"error": f"no route {self.path!r}"})
            return
        escalate = self.path == "/escalate"
        try:
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n) or b"{}")
            if not isinstance(body, dict):
                raise _BadRequest("body must be a JSON object")
        except (ValueError, json.JSONDecodeError) as e:
            self._json(400, {"error": f"bad JSON body: {e}"})
            return
        try:
            handle = self.srv.admit(body)
        except _BadRequest as e:
            self._json(400, {"error": str(e)})
            return
        except _Overloaded as e:
            self._json(429, {"error": str(e)},
                       {"Retry-After": str(self.srv.config.retry_after_s)})
            return
        if escalate:
            self.srv._escalations.inc()
        try:
            if body.get("stream") and not escalate:
                self._stream(handle)
            else:
                c = handle.result()
                out = _completion_json(c)
                if escalate:
                    # echo routing metadata so the endpoint's replayer
                    # can correlate and label the answering tier
                    out["tier"] = getattr(self.srv.engine, "tier",
                                          self.srv.config.tier)
                    if body.get("seq") is not None:
                        out["seq"] = body["seq"]
                self._json(200, out)
        except (BrokenPipeError, ConnectionResetError):
            handle.cancel()     # client went away: free the slot
        finally:
            self.srv.release()

    def _stream(self, handle) -> None:
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        for tok in handle.stream():
            self._chunk(json.dumps({"token": int(tok)}).encode() + b"\n")
            self.wfile.flush()
        final = dict(done=True, **_completion_json(handle.completion))
        self._chunk(json.dumps(final).encode() + b"\n")
        self._chunk(b"")        # terminal chunk
        self.wfile.flush()


def _completion_json(c) -> Dict[str, Any]:
    return {
        "id": c.id,
        "tokens": [int(t) for t in c.tokens],
        "finish_reason": c.finish_reason,
        "ttft_s": c.ttft_s,
        "latency_s": c.latency_s,
        "restarts": c.restarts,
    }


# ---------------------------------------------------------------------------
# CLI: PYTHONPATH=src python -m repro_torch.runtime.server --arch <id> [...]
# ---------------------------------------------------------------------------


def build_engine(args) -> Engine:
    """The served engine: ``--arch`` (its ``.smoke()`` variant unless
    ``--no-smoke``) with the port's seeded weights on ``--device``, under
    the engine flags of ``EngineConfig.add_cli_args``."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    model = T.init_params(cfg, args.seed, device=args.device)
    ec = EngineConfig.from_args(args, max_len=args.max_len,
                                admission=args.policy or "fifo")
    return Engine(cfg, model, ec, device=args.device)


def _expect(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"probe failed: {what}")


def _smoke(url: str, trace_out: Optional[str] = None) -> None:
    """One streamed request + health/status/metrics/trace probes over
    real HTTP; raises on the first that fails. ``trace_out``
    additionally writes the schema-validated Chrome trace to disk."""
    import http.client
    from urllib.parse import urlparse

    from repro_torch.runtime.observability import (parse_prometheus,
                                                   validate_chrome_trace)

    u = urlparse(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=60)
    try:
        conn.request("GET", "/health/ready")
        r = conn.getresponse()
        r.read()
        _expect(r.status == 200, f"/health/ready -> {r.status}")
        body = json.dumps({"prompt": [1, 2, 3, 4], "max_new_tokens": 8,
                           "stream": True})
        conn.request("POST", "/generate", body,
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        raw = r.read()
        _expect(r.status == 200, f"/generate -> {r.status}")
        lines = [json.loads(ln) for ln in raw.splitlines() if ln.strip()]
        toks = [ln["token"] for ln in lines if "token" in ln]
        final = lines[-1]
        _expect(final.get("done") and final["tokens"] == toks,
                f"stream mismatch: {lines}")
        conn.request("GET", "/status")
        r = conn.getresponse()
        raw = r.read()
        _expect(r.status == 200, f"/status -> {r.status}")
        st = json.loads(raw)
        _expect(st["ready"] and "kv" in st and "counters" in st, str(st))
        conn.request("GET", "/metrics")
        r = conn.getresponse()
        raw = r.read()
        _expect(r.status == 200, f"/metrics -> {r.status}")
        metrics = parse_prometheus(raw.decode())
        _expect(metrics["counters"]["repro_admissions_total"]
                == st["counters"]["admissions"],
                f"{metrics['counters']} against {st['counters']}")
        if st["observability"]:
            _expect(metrics["histograms"]["repro_ttft_seconds"]["count"]
                    >= 1, "no TTFT sample")
        conn.request("GET", "/trace")
        r = conn.getresponse()
        raw = r.read()
        _expect(r.status == 200, f"/trace -> {r.status}")
        trace = json.loads(raw)
        n_events = validate_chrome_trace(trace)
        if st["observability"]:
            _expect(n_events > 0, "observability on but the trace is empty")
    finally:
        conn.close()
    if trace_out:
        with open(trace_out, "w") as fh:
            json.dump(trace, fh)
    print(f"probe OK: {len(toks)} tokens streamed, "
          f"finish_reason={final['finish_reason']}, "
          f"admissions={st['counters']['admissions']}, "
          f"sheds={st['counters']['sheds']}, "
          f"trace_events={n_events}"
          + (f" -> {trace_out}" if trace_out else ""))


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        description="HTTP serving front end over the port's Engine")
    EngineConfig.add_cli_args(ap)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="serve the config's reduced smoke variant "
                         "(--no-smoke: full width and depth)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8800,
                    help="listen port (0 = ephemeral)")
    ap.add_argument("--max-len", type=int, default=128,
                    help="KV rows per slot (prompt + generation budget)")
    ap.add_argument("--max-inflight", type=int, default=32,
                    help="open-request bound before /generate returns 429")
    ap.add_argument("--probe", action="store_true",
                    help="start, stream one request, probe health/status/"
                         "metrics/trace, exit (implies --observability so "
                         "the probes are meaningful)")
    ap.add_argument("--trace-out", default=None,
                    help="with --probe: write the schema-validated Chrome "
                         "trace JSON here")
    args = ap.parse_args(argv)
    if args.probe:
        args.observability = True
    if (args.policy or "fifo") == "batch":
        ap.error("--policy batch is the closed-batch executor; the server "
                 "needs a continuous policy (fifo | priority | edf)")
    engine = build_engine(args)
    sc = ServerConfig(host=args.host, port=0 if args.probe else args.port,
                      max_inflight=args.max_inflight)
    with EngineServer(engine, sc) as srv:
        print(f"serving {engine.cfg.name} on {srv.url} "
              f"(device={engine.device}, policy={engine.admission.name}, "
              f"layout={engine.config.kv_layout})", flush=True)
        if args.probe:
            _smoke(srv.url, trace_out=args.trace_out)
            return
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            pass


if __name__ == "__main__":
    main()
