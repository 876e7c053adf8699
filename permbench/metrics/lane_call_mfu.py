"""The whole call's share of the card's peak on the lane walk's cell, in
%, by call_mfu's rule: the least time of all the walks of the window
(permbench/roofline.py) over the window's host-clock seconds; None off
the card or where no call returned a walk's value."""

from permbench.roofline import call_least_s


def read(ctx):
    if not ctx.on_card:
        return None
    least = [call_least_s(c, ctx.n, ctx.batch > 1) for c in ctx.calls]
    tot = sum(x[1] for x in least if x is not None)
    if not tot:
        return None
    return 100.0 * tot / ctx.window_s
