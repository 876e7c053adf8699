"""ms a call of the engine's checks and plan (ops/ryser.ryser_exact before
and after the sparse planner: the storage and density checks, make_plan
or the sparse RyserPlan, the chunk ids), span `engine_plan`: the span's
total over the window's calls, divided by the calls."""


def read(ctx):
    return ctx.span_ms("engine_plan")
