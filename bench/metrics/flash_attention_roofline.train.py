"""The flash kernel's forward share of its roofline: the summed bound
time (``yardstick.cost`` at each call's shapes, live causal pairs only,
over the card's peaks) of the calls probed in the profiled sub-window,
over the device time of their ``fa_fwd`` kernels."""


def read(run):
    t = run.trace
    calls = t.kernel_calls.get("flash_attention") if t else None
    if getattr(run, "kind", "") != "train" or not calls:
        return None
    return 100.0 * sum(b for b, _ in calls) / sum(d for _, d in calls)
