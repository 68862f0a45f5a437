"""Model operations of the training steps completed in the window (3 x
their forward count, ``yardstick.flops``) over their time, as a share
of the card's bf16 peak."""
from bench.yardstick import peaks


def read(run):
    if getattr(run, "kind", "") != "train" or not run.window_s:
        return None
    return 100.0 * run.flops / (run.window_s * peaks.BF16_FLOPS)
