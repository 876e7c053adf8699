"""The whole call's share of the peak of the cell's cards together, in
%: the least time of all the walks of the window on one card's peak
(permbench/roofline.py, the work the kernels' rooflines count) over the
window's host-clock seconds times the cell's cards.  call_mfu, which
divides by the window alone, would read up to 100% a card over a mesh."""

from permbench.roofline import call_least_s


def read(ctx):
    if not ctx.on_card:
        return None
    least = [call_least_s(c, ctx.n, ctx.batch > 1) for c in ctx.calls]
    tot = sum(x[1] for x in least if x is not None)
    if not tot:
        return None
    return 100.0 * tot / (ctx.window_s * ctx.cell.chips)
