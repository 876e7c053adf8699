"""ms a call of the exact engine's walks, one a prime (ops/modp._walk_sum:
ids and pack to the card, the Z_p kernel, the residues back, their sum),
span `exact_walk`: the span's total over the window's calls, divided by
the calls."""


def read(ctx):
    return ctx.span_ms("exact_walk")
