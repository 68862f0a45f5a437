"""Share of the profiled sub-window in which no kernel ran on the card
(one minus the union of the kernels' intervals over the sub-window)."""


def read(run):
    t = run.trace
    if getattr(run, "kind", "") != "serve" or t is None or not t.window_s:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
