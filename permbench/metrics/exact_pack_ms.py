"""ms a call of the exact engine's residue packs, one a prime
(ops/modp.perman_core_mod: reduce_core_mod, pack_mod), span
`exact_pack`: the span's total over the window's calls, divided by the
calls."""


def read(ctx):
    return ctx.span_ms("exact_pack")
