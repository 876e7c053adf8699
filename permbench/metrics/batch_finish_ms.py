"""ms a call of the batch's finish (ops/batch.permanent_batch_kernel: the
word sums and each matrix's 2^E; permanent_batch: the Results), span
`batch_finish`: the span's total over the window's calls, divided by the
calls."""


def read(ctx):
    return ctx.span_ms("batch_finish")
