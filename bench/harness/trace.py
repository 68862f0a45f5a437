"""The traced run's instruments, kept in the benchmark's own files:
probes around the calls into the port's layers, ``torch.profiler`` over
a sub-window, and the reduction of its device trace.

``Probes`` wraps, for the traced run only, the port's attention kernel
entry points as ``models.layers`` calls them (``flash_attention``,
``decode_attention``) to record each call's host interval and its
frozen cost (``yardstick.cost``), and the engine's model calls
(``transformer.prefill``, the layout's ``decode``, the sampler) to
record the host's step phases. Host intervals are stamped with
``time.time_ns``, the clock of the profiler's events.

``reduce`` reads the profiler's raw results: the kernels (device
events) and the host's launch calls (CPU events carrying the same
``correlation_id``). A kernel belongs to the probed call whose host
interval holds its launch. From them: the device's busy time (the
union of the kernels' intervals) over the profiled window, the kernels
that took the most time, the longest idle gaps labelled by the host
phase their start fell in, and for each probed kernel kind the pairs
(bound seconds, device seconds) of its calls.
"""
from __future__ import annotations

import bisect
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from bench.yardstick import cost as C
from bench.yardstick import peaks

# profiles a traced run takes at most, where one records no kernel
PROFILE_TRIES = 3
# kernel-name fragments of the probed kinds
KERNELS = {"flash_attention": ("fa_fwd",),
           "decode_attention": ("decode_partial_kernel",
                                "decode_combine_kernel")}


@dataclass
class Call:
    kind: str
    t0: int
    t1: int
    bound_s: float


@dataclass
class Probes:
    """Wrappers installed into the port's modules; ``on`` gates the
    recording of kernel calls to the profiled sub-window."""
    on: bool = False
    calls: List[Call] = field(default_factory=list)
    phases: List[Tuple[int, int, str]] = field(default_factory=list)
    live_rows: int = 0
    _undo: List[Callable] = field(default_factory=list)
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def _patch(self, owner, name: str, wrap) -> None:
        orig = getattr(owner, name)
        setattr(owner, name, wrap(orig))
        self._undo.append(lambda: setattr(owner, name, orig))

    def remove(self) -> None:
        while self._undo:
            self._undo.pop()()

    def _record(self, kind: str, t0: int, bound_s: float) -> None:
        if self.on:
            with self._lock:
                self.calls.append(Call(kind, t0, time.time_ns(), bound_s))

    def _phase(self, label: str, fn):
        def run(*a, **k):
            t0 = time.time_ns()
            try:
                return fn(*a, **k)
            finally:
                self.phases.append((t0, time.time_ns(), label))
        return run

    def install_kernels(self) -> None:
        """Probe the attention kernels as ``models.layers`` calls them."""
        from repro_torch.models import layers

        def flash(orig):
            def call(q, k, v, **kw):
                t0 = time.time_ns()
                out = orig(q, k, v, **kw)
                c = C.flash_attention_cost(
                    tuple(q.shape), tuple(k.shape),
                    causal=kw.get("causal", True),
                    window=kw.get("window", 0),
                    return_lse=kw.get("return_lse", False),
                    itemsize=q.element_size()) \
                    if kw.get("q_offset") is None and kw.get("kv_len") is None \
                    else None
                if c is not None:
                    self._record("flash_attention", t0,
                                 peaks.bound_s(c.flops, c.bytes))
                return out
            return call

        def decode(orig):
            def call(q, kc, vc, lengths, **kw):
                t0 = time.time_ns()
                out = orig(q, kc, vc, lengths, **kw)
                b, h, d = q.shape
                c = C.decode_attention_cost(
                    b, h, kc.shape[2], d, live_rows=self.live_rows,
                    itemsize=q.element_size(),
                    return_lse=kw.get("return_lse", False))
                self._record("decode_attention", t0,
                             peaks.bound_s(c.flops, c.bytes))
                return out
            return call

        self._patch(layers, "flash_attention", flash)
        self._patch(layers, "decode_attention", decode)

    def install_engine(self, scheduler) -> None:
        """Probe the engine's model calls: prefill, the decode step
        (whose host ``cache_len`` gives the decode kernel's live rows),
        and sampling."""
        from repro_torch.models import transformer as T
        layout = scheduler.layout
        rows = layout.cache[0]["k"].shape[1]

        def decode(orig):
            def run(tokens, cache_len):
                self.live_rows = int(
                    (scheduler.cache_len.astype("int64") + 1)
                    .clip(max=rows).sum())
                return self._phase("decode", orig)(tokens, cache_len)
            return run

        self._patch(T, "prefill", lambda f: self._phase("prefill", f))
        self._patch(layout, "decode", decode)
        self._patch(scheduler, "sampler",
                    lambda f: _Proxy(f, self._phase("sample", f)))


class _Proxy:
    """A callable in an object's place that forwards its attributes."""

    def __init__(self, obj, call):
        self._obj, self._call = obj, call

    def __call__(self, *a, **k):
        return self._call(*a, **k)

    def __getattr__(self, name):
        return getattr(self._obj, name)


class Profile:
    """``torch.profiler`` over a sub-window, started and stopped from the
    calling thread: device activity only (on a CPU test run, the host's,
    which holds no device events)."""

    def __init__(self, device: str = "cuda"):
        from torch.profiler import ProfilerActivity, profile
        self.device = device
        self.prof = profile(activities=[
            ProfilerActivity.CUDA if device == "cuda"
            else ProfilerActivity.CPU])
        self.t0 = self.t1 = 0

    @staticmethod
    def warm(device: str = "cuda") -> None:
        """Start and stop a profiler once: the first start in a process
        initialises the tracer, which took seconds on the card, so a
        traced run pays it in set-up and not in its window."""
        import torch
        p = Profile(device)
        p.prof.start()
        torch.ones(8, device=device).add_(1)
        if device == "cuda":
            torch.cuda.synchronize()
        p.prof.stop()

    def start(self) -> None:
        self.prof.start()
        self.t0 = time.time_ns()

    def stop(self) -> None:
        self.t1 = time.time_ns()
        self.prof.stop()

    def kernels_seen(self) -> bool:
        """Whether the trace holds a kernel. A profiler that kept CUPTI
        attached from an earlier profile recorded a sub-window's copies
        and no kernel while the engine ran hundreds (``main.environment``
        tears it down at each stop): such a trace is to be taken again,
        not read. A CPU run has none to see."""
        if self.device != "cuda":
            return True
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        return any(e.device_type() == cuda
                   and not e.name().startswith(("Memcpy", "Memset"))
                   for e in self.prof.profiler.kineto_results.events())


@dataclass
class Reduced:
    busy_s: float
    window_s: float
    device_ops: List[List]
    idle_gaps: List[List]
    kernel_calls: Dict[str, List[Tuple[float, float]]]
    linked: int


def _kind(name: str) -> Optional[str]:
    for kind, frags in KERNELS.items():
        if any(f in name for f in frags):
            return kind
    return None


def reduce(profile: Profile, probes: Probes, top: int = 10) -> Reduced:
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    lo, hi = profile.t0, profile.t1
    kernels, launches = [], {}
    for e in profile.prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            s, t = e.start_ns(), e.start_ns() + e.duration_ns()
            if t > lo and s < hi:
                kernels.append((max(s, lo), min(t, hi), e.name(),
                                e.correlation_id(), t - s))
        elif "aunch" in e.name():
            launches[e.correlation_id()] = e.start_ns()
    kernels.sort()
    by_name: Dict[str, float] = defaultdict(float)
    busy, end, gaps = 0, lo, []
    for s, t, name, _, _ in kernels:
        by_name[name] += (t - s) / 1e9
        if s > end:
            gaps.append((s - end, end))
        if t > end:
            busy += t - max(s, end)
            end = t
    if hi > end:
        gaps.append((hi - end, end))
    phases = sorted(probes.phases)
    starts = [p[0] for p in phases]

    def label(at: int) -> str:
        i = bisect.bisect_right(starts, at) - 1
        if i >= 0 and at <= phases[i][1]:
            return phases[i][2]
        return "scheduler"
    gaps.sort(reverse=True)
    calls = sorted(probes.calls, key=lambda c: c.t0)
    c0 = [c.t0 for c in calls]
    dev: Dict[int, float] = defaultdict(float)
    linked = 0
    for s, t, name, corr, dur in kernels:
        kind = _kind(name)
        if kind is None or corr not in launches:
            continue
        at = launches[corr]
        i = bisect.bisect_right(c0, at) - 1
        if i >= 0 and calls[i].kind == kind and calls[i].t1 >= at:
            dev[i] += dur / 1e9
            linked += 1
    kernel_calls: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
    for i, sec in dev.items():
        kernel_calls[calls[i].kind].append((calls[i].bound_s, sec))
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return Reduced(
        busy / 1e9, (hi - lo) / 1e9,
        [[n[:96], v] for n, v in ops],
        [[label(at), g / 1e9] for g, at in gaps[:top]],
        dict(kernel_calls), linked)
