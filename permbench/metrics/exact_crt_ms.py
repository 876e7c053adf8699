"""ms a call of the exact engine's CRT and value
(ops/modp.crt_perman_core's CRT and held-out check; ops/exact.py: the
Fraction, its float and log2, the Result), span `exact_crt`: the span's
total over the window's calls, divided by the calls."""


def read(ctx):
    return ctx.span_ms("exact_crt")
