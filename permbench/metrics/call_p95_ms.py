"""The 95th percentile, in ms, of a call's host clock from the call to
its value, over every call of the traced window: the end-to-end tail,
read beside the device's trace.  `p95_ms` is bounded end to end only in
the cells whose runs repeat it closely enough; this reads it in every
cell."""

import numpy as np


def read(ctx):
    if not ctx.calls:
        return None
    walls = [c.wall_s for c in ctx.calls]
    return float(np.percentile(walls, 95)) * 1e3
