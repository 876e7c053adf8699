"""ms a call of the sparse planner (ops/pruning.plan_sparse via
ops/ryser.py), span `sparse_plan`: the span's total over the window's
calls, divided by the calls."""


def read(ctx):
    return ctx.span_ms("sparse_plan")
