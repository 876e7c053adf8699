"""ms a call of the exact engine's dyadic lift and line folds
(ops/exact.perman_exact_fraction: dyadic_int_matrix, _fold_lines), span
`exact_lift`: the span's total over the window's calls, divided by the
calls."""


def read(ctx):
    return ctx.span_ms("exact_lift")
