"""ms a call of the batch's input checks (ops/batch.permanent_batch: each
matrix square and finite), span `batch_check`: the span's total over the
window's calls, divided by the calls."""


def read(ctx):
    return ctx.span_ms("batch_check")
