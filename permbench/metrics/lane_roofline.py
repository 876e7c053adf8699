"""Share of its roofline of the lane walk (ops/ryser_walk.walk_lanes,
PyTorch's own elementwise and reduce kernels, which have no name of the
walk's), in %: the least time of the window's walks, counted as any walk
of the tier (permbench/roofline.call_least_s: 2^(n-1) steps a matrix,
whatever implements them), over the device seconds of every kernel of
the traced window, copies and sets left out.  The lane walk is all the
cell runs on the card.  None off the card or where the trace holds no
kernel."""

from permbench.roofline import call_least_s

#: device operations that are no kernel: the profiler's names of copies
#: and sets
NOT_KERNELS = ("Memcpy", "Memset")


def read(ctx):
    if not ctx.on_card:
        return None
    dev_s = sum(s for k, s in ctx.trace.device_s.items()
                if not k.startswith(NOT_KERNELS))
    least = [call_least_s(c, ctx.n, ctx.batch > 1) for c in ctx.calls]
    tot = sum(x[1] for x in least if x is not None)
    if not dev_s or not tot:
        return None
    return 100.0 * tot / dev_s
