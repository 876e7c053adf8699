"""ms a call of the batch's launch and transfer (ops/batch.walk_stack),
span `batch_walk`: the span's total over the window's calls, divided by
the calls."""


def read(ctx):
    return ctx.span_ms("batch_walk")
