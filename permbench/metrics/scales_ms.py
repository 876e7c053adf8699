"""ms a call of the engine's row scales (ops/ryser.ryser_exact:
_row_scales, _center_scales, and each attempt's ldexp of the matrix),
span `scales`: the span's total over the window's calls, divided by the
calls."""


def read(ctx):
    return ctx.span_ms("scales")
