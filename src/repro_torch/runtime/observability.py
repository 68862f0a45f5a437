"""Observability of the port: metrics registry, lifecycle tracing,
Chrome-trace export.

A copy of ``repro.runtime.observability`` (stdlib only, no framework),
kept in the port so that ``repro_torch`` imports nothing of ``repro``.
Three cooperating pieces, all safe to import anywhere in the runtime:

* :class:`MetricsRegistry` — named counters, gauges, and fixed-bucket
  histograms behind one lock.  Histograms track count/sum/min/max plus
  per-bucket counts and answer p50/p90/p99 by linear interpolation
  inside the owning bucket; :meth:`MetricsRegistry.render` emits the
  Prometheus text exposition format served at ``GET /metrics``.

* :class:`Tracer` — an append-only Chrome trace-event recorder.  Tracks
  are ``(process, thread)`` pairs; each track is pinned to exactly one
  clock domain (``"wall"`` for the engine drain path, ``"modeled"`` for
  Simulator / failover-controller timelines) at first use, and mixing
  clocks on a track raises.  :meth:`Tracer.chrome_trace` snapshots the
  event list into ``{"traceEvents": [...]}`` JSON that loads directly in
  Perfetto / ``chrome://tracing``; spans still open at snapshot time are
  closed in the *copy* so a mid-run ``GET /trace`` always validates.

* :class:`Observability` — the bundle the engine threads through the
  scheduler and resilience layers.  When the ``EngineConfig.observability``
  knob is off the scheduler holds ``None`` instead, so the hot path pays
  a single ``is None`` test.

Helpers at the bottom export already-recorded modeled timelines
(`SimResult` firings, `FailoverReport` events) into a tracer, and
:func:`validate_chrome_trace` / :func:`parse_prometheus` give tests and
benches a schema gate without external dependencies.
"""
from __future__ import annotations

import bisect
import json
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "Tracer", "Observability",
    "TIME_BUCKETS_S", "SIZE_BUCKETS",
    "validate_chrome_trace", "parse_prometheus",
    "simulator_trace", "failover_trace",
]

# Log-spaced latency buckets: 100 µs resolution at the bottom (a tiny
# CPU decode step), a minute at the top (a stalled request is still
# countable).  Shared by every duration histogram so /metrics panels
# line up.
TIME_BUCKETS_S: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

# Power-of-two-ish buckets for token / block counts.
SIZE_BUCKETS: Tuple[float, ...] = (
    1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)


# ---------------------------------------------------------------------------
# metrics


class Counter:
    """Monotonic counter. ``sync`` lets the engine mirror an externally
    maintained total (scheduler event counts) without double counting."""

    __slots__ = ("name", "help", "_lock", "_value")

    def __init__(self, name: str, help: str, lock: threading.Lock):
        self.name = name
        self.help = help
        self._lock = lock
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += amount

    def sync(self, total: float) -> None:
        """Set the counter to an externally tracked monotone total."""
        with self._lock:
            if total > self._value:
                self._value = float(total)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """A value that can go up and down (queue depth, blocks in use)."""

    __slots__ = ("name", "help", "_lock", "_value")

    def __init__(self, name: str, help: str, lock: threading.Lock):
        self.name = name
        self.help = help
        self._lock = lock
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Fixed-bucket histogram with interpolated percentiles.

    ``bounds`` are inclusive upper edges; one implicit +Inf overflow
    bucket sits past the last bound.  Percentiles interpolate linearly
    inside the owning bucket and clamp to the observed min/max, so a
    histogram fed a single value reports that value exactly at every
    quantile.
    """

    __slots__ = ("name", "help", "bounds", "_lock", "_counts",
                 "count", "sum", "min", "max")

    def __init__(self, name: str, help: str,
                 bounds: Sequence[float], lock: threading.Lock):
        if list(bounds) != sorted(bounds) or len(set(bounds)) != len(bounds):
            raise ValueError(f"histogram bounds must be strictly "
                             f"increasing: {bounds!r}")
        self.name = name
        self.help = help
        self.bounds = tuple(float(b) for b in bounds)
        self._lock = lock
        self._counts = [0] * (len(self.bounds) + 1)     # +1 overflow
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, value: float) -> None:
        v = float(value)
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self._counts[i] += 1
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v

    def reset(self) -> None:
        """Drop every recorded sample (benchmark window scoping — e.g.
        excluding a compile warmup from the measured summaries).
        Prometheus histograms never reset in production; scrapers rely
        on monotone cumulative buckets."""
        with self._lock:
            self._counts = [0] * (len(self.bounds) + 1)
            self.count = 0
            self.sum = 0.0
            self.min = float("inf")
            self.max = float("-inf")

    def percentile(self, q: float) -> float:
        """Interpolated q-th percentile (q in [0, 100])."""
        if not 0 <= q <= 100:
            raise ValueError(f"percentile out of range: {q}")
        with self._lock:
            if self.count == 0:
                return 0.0
            rank = (q / 100.0) * self.count
            cum = 0
            lo = 0.0
            for ub, c in zip(self.bounds, self._counts):
                if cum + c >= rank and c > 0:
                    frac = (rank - cum) / c
                    lo_c = min(max(lo, self.min), self.max)
                    hi_c = max(min(ub, self.max), self.min)
                    return lo_c + frac * (hi_c - lo_c)
                cum += c
                lo = ub
            return self.max                 # rank lands in the overflow

    def buckets(self) -> List[Tuple[float, int]]:
        """Cumulative (upper_bound, count) pairs, +Inf last."""
        with self._lock:
            out, cum = [], 0
            for ub, c in zip(self.bounds, self._counts):
                cum += c
                out.append((ub, cum))
            out.append((float("inf"), cum + self._counts[-1]))
            return out

    def summary(self) -> Dict[str, float]:
        with self._lock:
            if self.count == 0:
                return {"count": 0, "sum": 0.0}
        return {
            "count": self.count,
            "sum": self.sum,
            "min": self.min,
            "max": self.max,
            "p50": self.percentile(50),
            "p90": self.percentile(90),
            "p99": self.percentile(99),
        }


class MetricsRegistry:
    """Get-or-create registry for the three metric kinds.

    One lock serializes registration *and* every sample — simple,
    correct under concurrent ``Engine.submit``, and cheap at the rates a
    Python scheduler step loop reaches.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Any] = {}

    def _get(self, name: str, kind, factory):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = factory()
                self._metrics[name] = m
            elif not isinstance(m, kind):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{type(m).__name__}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, Counter,
                         lambda: Counter(name, help, self._lock))

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(name, Gauge, lambda: Gauge(name, help, self._lock))

    def histogram(self, name: str, bounds: Sequence[float] = TIME_BUCKETS_S,
                  help: str = "") -> Histogram:
        return self._get(name, Histogram,
                         lambda: Histogram(name, help, bounds, self._lock))

    def reset_histograms(self) -> None:
        """Reset every histogram's samples (counters and gauges keep
        their values).  Benchmark window scoping only — see
        ``Histogram.reset``."""
        with self._lock:
            items = list(self._metrics.values())
        for m in items:
            if isinstance(m, Histogram):
                m.reset()

    def snapshot(self) -> Dict[str, Any]:
        """Plain-dict view: counters/gauges as numbers, histograms as
        p50/p90/p99 summaries.  Safe to json-serialize."""
        with self._lock:
            items = list(self._metrics.items())
        out: Dict[str, Any] = {"counters": {}, "gauges": {}, "histograms": {}}
        for name, m in items:
            if isinstance(m, Counter):
                out["counters"][name] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][name] = m.value
            else:
                out["histograms"][name] = m.summary()
        return out

    def render(self) -> str:
        """Prometheus text exposition (version 0.0.4)."""
        with self._lock:
            items = sorted(self._metrics.items())
        lines: List[str] = []
        for name, m in items:
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            if isinstance(m, Counter):
                lines.append(f"# TYPE {name} counter")
                lines.append(f"{name} {_fmt(m.value)}")
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {name} gauge")
                lines.append(f"{name} {_fmt(m.value)}")
            else:
                lines.append(f"# TYPE {name} histogram")
                for ub, cum in m.buckets():
                    le = "+Inf" if ub == float("inf") else _fmt(ub)
                    lines.append(f'{name}_bucket{{le="{le}"}} {cum}')
                lines.append(f"{name}_sum {_fmt(m.sum)}")
                lines.append(f"{name}_count {m.count}")
        return "\n".join(lines) + "\n"


def _fmt(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def parse_prometheus(text: str) -> Dict[str, Any]:
    """Parse the subset of the text exposition format ``render`` emits.

    Returns ``{"counters": {name: v}, "gauges": {name: v},
    "histograms": {name: {"buckets": [(le, cum)], "sum": s, "count": n}}}``.
    Used by the tests and benches to cross-check /metrics against
    ``Engine.snapshot()``.
    """
    out: Dict[str, Any] = {"counters": {}, "gauges": {}, "histograms": {}}
    types: Dict[str, str] = {}
    for ln in text.splitlines():
        ln = ln.strip()
        if not ln:
            continue
        if ln.startswith("#"):
            parts = ln.split(None, 3)
            if len(parts) >= 3 and parts[1] == "TYPE":
                types[parts[2]] = parts[3] if len(parts) > 3 else ""
            continue
        name_part, _, val = ln.rpartition(" ")
        value = float(val)
        if "{" in name_part:
            base, _, label = name_part.partition("{")
            label = label.rstrip("}")
            if base.endswith("_bucket") and label.startswith('le="'):
                hname = base[: -len("_bucket")]
                le_s = label[4:-1]
                le = float("inf") if le_s == "+Inf" else float(le_s)
                h = out["histograms"].setdefault(
                    hname, {"buckets": [], "sum": 0.0, "count": 0})
                h["buckets"].append((le, value))
            continue
        if name_part.endswith("_sum") and name_part[:-4] in out["histograms"]:
            out["histograms"][name_part[:-4]]["sum"] = value
        elif (name_part.endswith("_count")
              and name_part[:-6] in out["histograms"]):
            out["histograms"][name_part[:-6]]["count"] = int(value)
        elif types.get(name_part) == "gauge":
            out["gauges"][name_part] = value
        else:
            out["counters"][name_part] = value
    return out


# ---------------------------------------------------------------------------
# tracing

WALL = "wall"
MODELED = "modeled"
_CLOCKS = (WALL, MODELED)


@dataclass
class _Track:
    pid: int
    tid: int
    clock: str
    stack: List[Tuple[str, float]] = field(default_factory=list)
    last_ts: float = 0.0


class Tracer:
    """Chrome trace-event recorder with per-track clock discipline.

    Timestamps come in as *seconds* on the track's clock and are stored
    in microseconds (the trace-event unit).  Duration events (``B``/``E``)
    keep a per-track stack so exports always have matched pairs; async
    spans (``b``/``e``) are matched per ``(pid, id)`` and model the
    overlapping request-queued intervals that don't nest.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._events: List[Dict[str, Any]] = []
        self._pids: Dict[str, int] = {}
        self._tracks: Dict[Tuple[str, str], _Track] = {}
        self._open_async: Dict[Tuple[int, str], List[str]] = {}

    # -- track bookkeeping --------------------------------------------------

    def _track(self, process: str, thread: str, clock: str) -> _Track:
        if clock not in _CLOCKS:
            raise ValueError(f"unknown clock {clock!r}")
        key = (process, thread)
        tr = self._tracks.get(key)
        if tr is None:
            pid = self._pids.get(process)
            if pid is None:
                pid = len(self._pids) + 1
                self._pids[process] = pid
                self._events.append({
                    "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                    "args": {"name": process}})
            tid = 1 + sum(1 for k in self._tracks if k[0] == process)
            tr = _Track(pid=pid, tid=tid, clock=clock)
            self._tracks[key] = tr
            self._events.append({
                "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                "args": {"name": thread}})
        elif tr.clock != clock:
            raise ValueError(
                f"track {process}/{thread} is on the {tr.clock!r} clock; "
                f"refusing to mix in {clock!r} events")
        return tr

    def _push(self, tr: _Track, ev: Dict[str, Any]) -> None:
        tr.last_ts = max(tr.last_ts, ev["ts"])
        self._events.append(ev)

    # -- duration spans -----------------------------------------------------

    def begin(self, process: str, thread: str, name: str, ts_s: float,
              *, clock: str = WALL,
              args: Optional[Dict[str, Any]] = None) -> None:
        with self._lock:
            tr = self._track(process, thread, clock)
            ts = ts_s * 1e6
            tr.stack.append((name, ts))
            ev = {"name": name, "cat": clock, "ph": "B",
                  "ts": ts, "pid": tr.pid, "tid": tr.tid}
            if args:
                ev["args"] = args
            self._push(tr, ev)

    def end(self, process: str, thread: str, ts_s: float,
            *, clock: str = WALL,
            args: Optional[Dict[str, Any]] = None) -> None:
        with self._lock:
            tr = self._track(process, thread, clock)
            if not tr.stack:
                raise RuntimeError(
                    f"end() with no open span on {process}/{thread}")
            name, begin_ts = tr.stack.pop()
            ts = max(ts_s * 1e6, begin_ts)
            ev = {"name": name, "cat": clock, "ph": "E",
                  "ts": ts, "pid": tr.pid, "tid": tr.tid}
            if args:
                ev["args"] = args
            self._push(tr, ev)

    def complete(self, process: str, thread: str, name: str, ts_s: float,
                 dur_s: float, *, clock: str = WALL,
                 args: Optional[Dict[str, Any]] = None) -> None:
        """A self-contained ``X`` event (start + duration)."""
        with self._lock:
            tr = self._track(process, thread, clock)
            ev = {"name": name, "cat": clock, "ph": "X",
                  "ts": ts_s * 1e6, "dur": max(dur_s, 0.0) * 1e6,
                  "pid": tr.pid, "tid": tr.tid}
            if args:
                ev["args"] = args
            tr.last_ts = max(tr.last_ts, ev["ts"] + ev["dur"])
            self._events.append(ev)

    def instant(self, process: str, thread: str, name: str, ts_s: float,
                *, clock: str = WALL,
                args: Optional[Dict[str, Any]] = None) -> None:
        with self._lock:
            tr = self._track(process, thread, clock)
            ev = {"name": name, "cat": clock, "ph": "i", "s": "t",
                  "ts": ts_s * 1e6, "pid": tr.pid, "tid": tr.tid}
            if args:
                ev["args"] = args
            self._push(tr, ev)

    # -- async (non-nesting) spans ------------------------------------------

    def async_begin(self, process: str, thread: str, name: str,
                    span_id: Any, ts_s: float, *, clock: str = WALL,
                    args: Optional[Dict[str, Any]] = None) -> None:
        with self._lock:
            tr = self._track(process, thread, clock)
            sid = str(span_id)
            ev = {"name": name, "cat": clock, "ph": "b", "id": sid,
                  "ts": ts_s * 1e6, "pid": tr.pid, "tid": tr.tid}
            if args:
                ev["args"] = args
            self._open_async.setdefault((tr.pid, sid), []).append(name)
            self._push(tr, ev)

    def async_end(self, process: str, thread: str, span_id: Any,
                  ts_s: float, *, clock: str = WALL,
                  args: Optional[Dict[str, Any]] = None) -> None:
        with self._lock:
            tr = self._track(process, thread, clock)
            sid = str(span_id)
            open_names = self._open_async.get((tr.pid, sid))
            if not open_names:
                raise RuntimeError(
                    f"async_end() with no open span id={sid} in {process}")
            name = open_names.pop()
            if not open_names:
                del self._open_async[(tr.pid, sid)]
            ev = {"name": name, "cat": clock, "ph": "e", "id": sid,
                  "ts": ts_s * 1e6, "pid": tr.pid, "tid": tr.tid}
            if args:
                ev["args"] = args
            self._push(tr, ev)

    # -- export -------------------------------------------------------------

    def chrome_trace(self) -> Dict[str, Any]:
        """Snapshot into a Perfetto-loadable dict.

        Spans still open at snapshot time (a live engine mid-request)
        are closed *in the copy* at the track's latest timestamp, so the
        export always validates; the live stacks are untouched and a
        later snapshot sees the spans still running.
        """
        with self._lock:
            events = [dict(ev) for ev in self._events]
            for (process, thread), tr in self._tracks.items():
                for name, _begin_ts in reversed(tr.stack):
                    events.append({
                        "name": name, "cat": tr.clock, "ph": "E",
                        "ts": tr.last_ts, "pid": tr.pid, "tid": tr.tid,
                        "args": {"snapshot_closed": True}})
            for (pid, sid), names in self._open_async.items():
                last = max((t.last_ts for t in self._tracks.values()
                            if t.pid == pid), default=0.0)
                for name in reversed(names):
                    events.append({
                        "name": name, "cat": WALL, "ph": "e", "id": sid,
                        "ts": last, "pid": pid, "tid": 0,
                        "args": {"snapshot_closed": True}})
        meta = [ev for ev in events if ev["ph"] == "M"]
        rest = [ev for ev in events if ev["ph"] != "M"]
        rest.sort(key=lambda ev: ev["ts"])          # stable: ties keep order
        return {"traceEvents": meta + rest, "displayTimeUnit": "ms"}

    def event_count(self) -> int:
        with self._lock:
            return len(self._events)


def validate_chrome_trace(trace: Dict[str, Any]) -> int:
    """Schema-check a Chrome trace dict; returns the event count.

    Raises ``ValueError`` on: missing required fields, per-track
    timestamps out of order, unmatched ``B``/``E`` pairs, unmatched
    async ``b``/``e`` pairs, negative ``X`` durations, or two clock
    domains (``cat``) sharing one ``(pid, tid)`` track.
    """
    if not isinstance(trace, dict) or "traceEvents" not in trace:
        raise ValueError("trace must be a dict with a 'traceEvents' list")
    events = trace["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("'traceEvents' must be a list")
    last_ts: Dict[Tuple[Any, Any], float] = {}
    clocks: Dict[Tuple[Any, Any], str] = {}
    stacks: Dict[Tuple[Any, Any], List[str]] = {}
    async_open: Dict[Tuple[Any, str], int] = {}
    for i, ev in enumerate(events):
        for k in ("name", "ph", "pid", "tid"):
            if k not in ev:
                raise ValueError(f"event {i} missing {k!r}: {ev!r}")
        ph = ev["ph"]
        if ph == "M":
            continue
        if "ts" not in ev or not isinstance(ev["ts"], (int, float)):
            raise ValueError(f"event {i} has no numeric ts: {ev!r}")
        key = (ev["pid"], ev["tid"])
        ts = ev["ts"]
        if ts < last_ts.get(key, float("-inf")):
            raise ValueError(
                f"event {i} out of order on track {key}: "
                f"{ts} < {last_ts[key]}")
        last_ts[key] = ts
        cat = ev.get("cat", "")
        if cat:
            prev = clocks.setdefault(key, cat)
            if prev != cat:
                raise ValueError(
                    f"track {key} mixes clocks {prev!r} and {cat!r}")
        if ph == "B":
            stacks.setdefault(key, []).append(ev["name"])
        elif ph == "E":
            st = stacks.get(key)
            if not st:
                raise ValueError(f"event {i}: E without matching B on {key}")
            st.pop()
        elif ph == "X":
            if ev.get("dur", 0) < 0:
                raise ValueError(f"event {i}: negative dur")
        elif ph == "b":
            akey = (ev["pid"], str(ev.get("id")))
            async_open[akey] = async_open.get(akey, 0) + 1
        elif ph == "e":
            akey = (ev["pid"], str(ev.get("id")))
            if async_open.get(akey, 0) <= 0:
                raise ValueError(
                    f"event {i}: async 'e' without open 'b' (id={akey[1]})")
            async_open[akey] -= 1
        elif ph == "i":
            pass
        else:
            raise ValueError(f"event {i}: unknown phase {ph!r}")
    leftovers = [k for k, st in stacks.items() if st]
    if leftovers:
        raise ValueError(f"unclosed B spans on tracks {leftovers}")
    dangling = [k for k, n in async_open.items() if n > 0]
    if dangling:
        raise ValueError(f"unclosed async spans {dangling}")
    return len(events)


# ---------------------------------------------------------------------------
# the bundle the engine wires through


class Observability:
    """Registry + tracer pair handed to scheduler / resilience layers."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.registry = MetricsRegistry()
        self.tracer = Tracer()

    def snapshot(self) -> Dict[str, Any]:
        return self.registry.snapshot()

    def write_trace(self, path: str) -> int:
        trace = self.tracer.chrome_trace()
        n = validate_chrome_trace(trace)
        with open(path, "w") as fh:
            json.dump(trace, fh)
        return n


# ---------------------------------------------------------------------------
# exporters for already-recorded modeled timelines


def simulator_trace(tracer: Tracer, result: Any,
                    *, process: str = "simulator") -> int:
    """Export ``SimResult.firings`` as one modeled-clock track per unit.

    Each firing becomes an ``X`` event spanning its modeled
    ``start_s → finish_s`` window on the unit that executed it.
    Returns the number of events added.
    """
    n = 0
    for f in getattr(result, "firings", ()):
        unit = f.unit or "local"
        tracer.complete(
            process, unit, f.actor, f.start_s, f.finish_s - f.start_s,
            clock=MODELED,
            args={"firing": f.firing_index, "modeled_s": f.modeled_s})
        n += 1
    return n


def pipeline_trace(tracer: Tracer, schedule: Any,
                   *, process: str = "pipeline") -> int:
    """Export a ``PipelineSchedule`` (``run_pipelined``) as modeled-clock
    unit tracks: each ``StageExec`` becomes an ``X`` event spanning its
    ``start_s → finish_s`` window, so the frame-overlap that produces
    the pipelining speedup is visible as staggered slices across units.
    Returns the number of events added.
    """
    n = 0
    for ex in getattr(schedule, "entries", ()):
        tracer.complete(
            process, ex.unit or "local", f"frame {ex.frame}",
            ex.start_s, ex.finish_s - ex.start_s, clock=MODELED,
            args={"frame": ex.frame})
        n += 1
    return n


def failover_trace(tracer: Tracer, events: Sequence[Any],
                   *, process: str = "failover",
                   thread: str = "controller") -> int:
    """Export ``FailoverEvent`` records as modeled-clock spans.

    Per event: a ``detection`` span (fail → detect), a ``resynthesis``
    span (detect → detect + resynth), and a ``failover`` instant carrying
    the mapping change.  Returns the number of trace events added.
    """
    n = 0
    for ev in events:
        tracer.complete(
            process, thread, "detection", ev.t_fail_s,
            ev.t_detect_s - ev.t_fail_s, clock=MODELED,
            args={"dead_units": list(ev.dead_units),
                  "dead_links": [list(l) for l in ev.dead_links]})
        tracer.complete(
            process, thread, "resynthesis", ev.t_detect_s, ev.resynth_s,
            clock=MODELED,
            args={"mapping_from": ev.mapping_from, "mapping_to": ev.mapping_to})
        tracer.instant(
            process, thread, "failover",
            ev.t_detect_s + ev.resynth_s, clock=MODELED,
            args={"recovery_latency_s": ev.recovery_latency_s,
                  "replayed_frames": ev.replayed_frames})
        n += 3
    return n
