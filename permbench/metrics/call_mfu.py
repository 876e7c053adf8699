"""The whole call's share of the card's peak, in %: the least time of all
the walks of the window (permbench/roofline.py, the same work the
kernels' rooflines count) over the window's host-clock seconds. It
bounds every kernel's roofline share times that kernel's busy share, so
a kernel taken off the path cannot hide a slower call."""

from permbench.roofline import call_least_s


def read(ctx):
    if not ctx.on_card:
        return None
    least = [call_least_s(c, ctx.n, ctx.batch > 1) for c in ctx.calls]
    tot = sum(x[1] for x in least if x is not None)
    if not tot:
        return None
    return 100.0 * tot / ctx.window_s
