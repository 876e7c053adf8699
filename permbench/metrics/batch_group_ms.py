"""ms a call of the batch's grouping (ops/batch.permanent_batch: the groups
by order and tier, each group's stack; permanent_batch_kernel's checks
and exact_storage_mask), span `batch_group`: the span's total over the
window's calls, divided by the calls."""


def read(ctx):
    return ctx.span_ms("batch_group")
