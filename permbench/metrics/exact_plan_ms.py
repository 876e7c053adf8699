"""ms a call of the exact engine's plan (ops/modp.crt_perman_core: the
bound, the primes, core_fingerprint, core_plan with the sparse planner
and the exact live mask on a miss of its cache, the column permutation),
span `exact_plan`: the span's total over the window's calls, divided by
the calls."""


def read(ctx):
    return ctx.span_ms("exact_plan")
