"""Per-unit modeled clocks — the one scheduling recurrence everything shares.

A verbatim copy of ``repro.core.clocks`` for the port.

Every modeled timeline in this repo (the token-accurate ``Simulator``,
``StagedProgram.run_pipelined``, the serving stack's multi-unit
``ExecutionCore``) advances the same way: a piece of work on unit ``u``
starts when its inputs are ready AND the unit is free, and occupies the
unit until it finishes::

    start  = max(ready_s, clock[u])
    finish = start + cost_s
    clock[u] = finish

``UnitClocks`` is that recurrence as an object, so the three consumers
stop re-implementing it (and so their accounting — busy seconds per
unit, makespan — agrees by construction). Units exist lazily: a unit's
clock is 0.0 until the first charge touches it.
"""
from __future__ import annotations

from typing import Dict, Tuple

__all__ = ["UnitClocks"]


class UnitClocks:
    """Concurrent per-unit busy clocks over one modeled timeline."""

    def __init__(self) -> None:
        self._clock: Dict[str, float] = {}
        self._busy: Dict[str, float] = {}

    def now(self, unit: str) -> float:
        """The instant ``unit`` becomes free (0.0 if never charged)."""
        return self._clock.get(unit, 0.0)

    def start(self, unit: str, ready_s: float) -> float:
        """When work whose inputs land at ``ready_s`` could start."""
        return max(ready_s, self._clock.get(unit, 0.0))

    def set(self, unit: str, finish_s: float) -> None:
        """Advance ``unit``'s clock to ``finish_s`` (never backwards).
        For callers that compute the finish themselves (the Simulator
        folds link blocking into it); busy time is NOT accumulated —
        pair with ``busy_add`` when the caller tracks busy seconds."""
        if finish_s > self._clock.get(unit, 0.0):
            self._clock[unit] = finish_s

    def busy_add(self, unit: str, dur_s: float) -> None:
        self._busy[unit] = self._busy.get(unit, 0.0) + dur_s

    def charge(self, unit: str, ready_s: float,
               cost_s: float) -> Tuple[float, float]:
        """Occupy ``unit`` for ``cost_s`` starting no earlier than
        ``ready_s``: returns ``(start_s, finish_s)`` and advances the
        clock and the unit's busy total."""
        start = max(ready_s, self._clock.get(unit, 0.0))
        finish = start + cost_s
        self._clock[unit] = finish
        self._busy[unit] = self._busy.get(unit, 0.0) + cost_s
        return start, finish

    @property
    def makespan_s(self) -> float:
        """Latest clock across all units (0.0 when nothing ran)."""
        return max(self._clock.values(), default=0.0)

    @property
    def busy_s(self) -> Dict[str, float]:
        """Busy seconds per unit accumulated through ``charge``/
        ``busy_add`` (a copy; safe to mutate)."""
        return dict(self._busy)

    def clocks(self) -> Dict[str, float]:
        return dict(self._clock)
