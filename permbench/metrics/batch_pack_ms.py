"""ms a call of the batch's host side (ops/batch.pack_stack), span
`batch_pack`: the span's total over the window's calls, divided by the
calls."""


def read(ctx):
    return ctx.span_ms("batch_pack")
