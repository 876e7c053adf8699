"""The share of the traced window in which no kernel, copy or set ran on
the card, in %, on the lane walk's cell, by device_idle_pct's rule; None
where the trace holds no device time."""


def read(ctx):
    t = ctx.trace
    if not t.busy_s or not t.window_s:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
