"""The 95th percentile, in ms, of a call's host clock from the call to
its value over every call of the traced window, on the lane walk's cell,
by call_p95_ms' rule: the tail in which the host's stalls show; None
where the window holds no call."""

import numpy as np


def read(ctx):
    if not ctx.calls:
        return None
    walls = [c.wall_s for c in ctx.calls]
    return float(np.percentile(walls, 95)) * 1e3
