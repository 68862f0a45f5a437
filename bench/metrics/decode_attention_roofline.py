"""The decode kernel's share of its roofline: the summed bound time
(``yardstick.cost`` at each call's shapes and live rows, over the
card's peaks) of the calls probed in the profiled sub-window, over the
device time of their kernels (``decode_partial_kernel`` and
``decode_combine_kernel``)."""


def read(run):
    t = run.trace
    calls = t.kernel_calls.get("decode_attention") if t else None
    if not calls:
        return None
    return 100.0 * sum(b for b, _ in calls) / sum(d for _, d in calls)
