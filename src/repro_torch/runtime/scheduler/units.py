"""Unit-aware execution core: prefill/decode disaggregation on modeled clocks.

Counterpart of ``repro.runtime.scheduler.units``, copied with its trace
hooks: with observability on and more than one unit, each unit gets a
modeled-clock track in the trace, in a process ``"units"`` with one
thread per unit.

The serving paper's collaborative-inference story, brought to the
``Engine``: the scheduler's work no longer all lands on one implicit
unit. ``ExecutionCore`` owns a set of ``UnitExecutor``s over shared
``UnitClocks`` (the same recurrence the Simulator and ``run_pipelined``
use — ``start = max(ready, clock[unit])``):

* ``PrefillExecutor`` — one per dedicated prefill unit. Every prompt
  burst (one-shot, prefix-resume tail, or one chunk of a chunked
  prefill) is charged to a prefill unit chosen by the *placement
  policy*; the finish instant becomes the slot's K/V-ready time.
* the prefill→decode **handoff** is zero-copy: the slot's KV blocks stay
  exactly where prefill wrote them in the shared pool, the decode units
  simply start addressing them through the block table. No bytes move
  and no refcount changes — the handoff is pure bookkeeping, which is
  why ``BlockAllocator``'s books balance across arbitrary
  handoff/preemption/failure interleavings
  (tests/test_kv_handoff_props.py).
* ``DecodeExecutor`` — one per pipeline stage on the decode units.
  Each decode step's batch is split into ``decode_stages`` microbatches
  that pipeline across the stage-partitioned units in the in-flight
  batching shape: stage k of microbatch m overlaps stage k−1 of
  microbatch m+1, and a microbatch's next token waits for its previous
  token to clear the last stage (the sampled token feeds back).

The clocks are *modeled* (deterministic ``sec_per_token`` costs, not
wall time): token content is bit-identical across every unit topology —
``units=1`` is the degenerate case whose makespan equals the sequential
work sum — and the modeled makespans are reproducible enough to gate in
CI (benchmarks/serving_bench.py asserts the 2-unit prefill/decode split
beats single-unit by >= 1.3x).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.clocks import UnitClocks
from repro_torch.runtime.observability import MODELED
from repro_torch.runtime.policies import make_placement

__all__ = ["UnitSpec", "UnitExecutor", "PrefillExecutor", "DecodeExecutor",
           "ExecutionCore"]


@dataclass(frozen=True)
class UnitSpec:
    """One modeled processing unit. ``role`` is "prefill" | "decode";
    ``stage`` is the decode pipeline stage the unit hosts (decode only)."""
    name: str
    role: str
    stage: int = 0


class UnitExecutor:
    """Work runner bound to one unit's clock: charging it occupies the
    unit from ``max(ready, clock)`` for the given cost."""

    role = "unit"

    def __init__(self, spec: UnitSpec, clocks: UnitClocks):
        self.spec = spec
        self.clocks = clocks

    @property
    def name(self) -> str:
        return self.spec.name

    @property
    def busy_s(self) -> float:
        return self.clocks.busy_s.get(self.spec.name, 0.0)

    def charge(self, ready_s: float, cost_s: float) -> Tuple[float, float]:
        return self.clocks.charge(self.spec.name, ready_s, cost_s)


class PrefillExecutor(UnitExecutor):
    role = "prefill"


class DecodeExecutor(UnitExecutor):
    role = "decode"

    @property
    def stage(self) -> int:
        return self.spec.stage


class ExecutionCore:
    """Modeled multi-unit timeline of one scheduler's work.

    The scheduler calls in at three points: ``prefill`` for every prompt
    compute burst, ``handoff`` when a slot's finished K/V joins the
    decode batch, and ``decode_step`` once per batched decode step.
    ``release`` drops a slot's pending state on any exit path
    (finish/evict/preempt/fail/shed/cancel), so a reused slot never
    inherits a stale ready time.
    """

    def __init__(self, s, obs: Any = None):
        if s.units < 1:
            raise ValueError(f"units must be >= 1, got {s.units}")
        if not 0 <= s.prefill_units < s.units:
            raise ValueError(
                f"prefill_units must be in [0, units): {s.prefill_units} "
                f"of {s.units} (at least one unit must decode)")
        decode_units = s.units - s.prefill_units
        if not 1 <= s.decode_stages <= decode_units:
            raise ValueError(
                f"decode_stages must be in [1, {decode_units}] "
                f"(the decode-unit count), got {s.decode_stages}")
        self.decode_stages = s.decode_stages
        self.prefill_spt = s.prefill_sec_per_token
        self.decode_spt = s.decode_sec_per_token
        self.clocks = UnitClocks()
        self.units: List[UnitSpec] = []
        self.decode_execs: List[DecodeExecutor] = []
        for k in range(decode_units):
            spec = UnitSpec(f"decode{k}", "decode", stage=k)
            self.units.append(spec)
            if k < s.decode_stages:     # extra decode units stay idle
                self.decode_execs.append(DecodeExecutor(spec, self.clocks))
        self.prefill_execs: List[PrefillExecutor] = []
        for k in range(s.prefill_units):
            spec = UnitSpec(f"prefill{k}", "prefill")
            self.units.append(spec)
            self.prefill_execs.append(PrefillExecutor(spec, self.clocks))
        if not self.prefill_execs:
            # colocated prefill: prompt bursts run on the first decode
            # stage's unit (the classic single-unit serialization)
            self.prefill_execs = [
                PrefillExecutor(self.decode_execs[0].spec, self.clocks)]
        self.placement = make_placement(s.placement)
        # slot -> modeled instant its K/V is ready (prefill chain tail)
        self.slot_ready: Dict[int, float] = {}
        # microbatch lane -> finish of its previous decode step (the
        # token-feedback dependency: lane m's next token starts after
        # its previous token left the last stage)
        self._lane_done: Dict[int, float] = {}
        self.sequential_s = 0.0     # sum of all work = 1-unit makespan
        self.handoffs = 0
        self.steps = 0
        # per-unit MODELED trace tracks only for non-trivial topologies:
        # the single-unit degenerate timeline would just duplicate the
        # wall-clock step slices, and the engine's default trace stays
        # wall-clock-only (tests/test_server.py pins that)
        self._obs = obs if (obs is not None and s.units > 1
                            and getattr(obs, "enabled", False)) else None

    # -- scheduler hooks ----------------------------------------------------

    def prefill(self, slot: int, tokens: int,
                label: str = "prefill") -> float:
        """Charge one prompt compute burst of ``tokens`` to a placement-
        chosen prefill unit; returns (and records) the slot's new K/V-
        ready instant. Chunks of one slot chain: each starts no earlier
        than the previous chunk's finish."""
        if tokens <= 0:
            return self.slot_ready.get(slot, 0.0)
        ex = self.placement.pick(self.prefill_execs)
        cost = tokens * self.prefill_spt
        start, finish = ex.charge(self.slot_ready.get(slot, 0.0), cost)
        self.slot_ready[slot] = finish
        self.sequential_s += cost
        if self._obs is not None:
            self._trace(ex.name, label, start, finish - start,
                        {"slot": slot, "tokens": tokens})
        return finish

    def handoff(self, slot: int, blocks: int = 0) -> None:
        """The slot's finished K/V joins the decode batch. Zero-copy by
        construction: the KV blocks stay in the shared pool where the
        prefill unit wrote them (no bytes charged, no refcount change) —
        only the ready-time bookkeeping crosses units."""
        self.handoffs += 1
        if self._obs is not None and self.decode_execs:
            self._instant(self.decode_execs[0].name, "kv-handoff",
                          self.slot_ready.get(slot, 0.0),
                          {"slot": slot, "blocks": blocks})

    def decode_step(self, slots: List[int]) -> None:
        """Charge one batched decode step. The batch splits into
        ``decode_stages`` contiguous microbatches; microbatch m flows
        through the stage executors in order, overlapping stage k−1 of
        microbatch m+1 with stage k of microbatch m (in-flight
        batching). Slots fresh from prefill gate their microbatch on the
        handoff-ready instant."""
        if not slots:
            return
        k = len(self.decode_execs)
        self.steps += 1
        step = self.steps
        # contiguous split keeps lane membership stable step to step
        # while the active set is stable, so the token-feedback chain
        # (lane m waits for its own previous token) is honest
        per = -(-len(slots) // k)
        for m in range(k):
            lane = slots[m * per:(m + 1) * per]
            if not lane:
                break
            # a lane waits for its own previous token to clear the last
            # stage, and for any member's prefill handoff to land
            ready = self._lane_done.get(m, 0.0)
            for s in lane:
                if s in self.slot_ready:
                    ready = max(ready, self.slot_ready.pop(s))
            cost = len(lane) * self.decode_spt / k  # per-stage share
            finish = ready
            for ex in self.decode_execs:
                start, finish = ex.charge(finish, cost)
                if self._obs is not None:
                    self._trace(ex.name, f"step {step} mb{m}", start,
                                finish - start,
                                {"slots": len(lane), "stage": ex.stage})
            self._lane_done[m] = finish
            self.sequential_s += len(lane) * self.decode_spt

    def release(self, slot: int) -> None:
        """Forget a slot's pending ready time (every slot-exit path)."""
        self.slot_ready.pop(slot, None)

    # -- reporting ----------------------------------------------------------

    @property
    def makespan_s(self) -> float:
        return self.clocks.makespan_s

    @property
    def speedup(self) -> float:
        """Modeled speedup of this unit topology over serializing the
        same work on one unit."""
        m = self.clocks.makespan_s
        return self.sequential_s / m if m > 0 else 1.0

    def summary(self) -> Dict[str, Any]:
        return {
            "units": [{"name": u.name, "role": u.role, "stage": u.stage}
                      for u in self.units],
            "decode_stages": self.decode_stages,
            "modeled_makespan_s": self.clocks.makespan_s,
            "modeled_sequential_s": self.sequential_s,
            "modeled_speedup": self.speedup,
            "unit_busy_s": self.clocks.busy_s,
            "kv_handoffs": self.handoffs,
        }

    # -- per-unit trace tracks (modeled clock) ------------------------------

    def _trace(self, unit: str, name: str, start_s: float, dur_s: float,
               args: Dict[str, Any]) -> None:
        self._obs.tracer.complete("units", unit, name, start_s, dur_s,
                                  clock=MODELED, args=args)

    def _instant(self, unit: str, name: str, ts_s: float,
                 args: Dict[str, Any]) -> None:
        self._obs.tracer.instant("units", unit, name, ts_s,
                                 clock=MODELED, args=args)
