"""Mean host time of the scheduler's decode phase a step (the engine's
``repro_step_decode_seconds`` histogram, sum over count in the window;
the phase ends on a device synchronise when observability is on)."""


def read(run):
    n, s = run.hist.get("repro_step_decode_seconds", (0, 0.0))
    return 1e3 * s / n if n else None
