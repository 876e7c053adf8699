"""ms a call of the walk's launch and transfer
(parallel/sharding.compute_total: ids to the card, the kernel, the
partials back, the host sum), span `walk`: the span's total over the
window's calls, divided by the calls."""


def read(ctx):
    return ctx.span_ms("walk")
