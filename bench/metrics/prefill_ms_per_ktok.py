"""Host time of the scheduler's prefill phase per 1,024 prompt tokens
prefilled in the window (``repro_step_prefill_seconds`` over the sum of
``repro_prefill_chunk_tokens``)."""


def read(run):
    _, s = run.hist.get("repro_step_prefill_seconds", (0, 0.0))
    _, tokens = run.hist.get("repro_prefill_chunk_tokens", (0, 0.0))
    return 1e3 * s / tokens * 1024 if tokens else None
