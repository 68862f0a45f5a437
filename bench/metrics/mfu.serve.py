"""Model operations of every prompt and output token processed in the
window (``yardstick.flops``) over the window's seconds, as a share of
the card's bf16 peak."""
from bench.yardstick import peaks


def read(run):
    if getattr(run, "kind", "") != "serve" or not run.window_s:
        return None
    return 100.0 * run.flops / (run.window_s * peaks.BF16_FLOPS)
