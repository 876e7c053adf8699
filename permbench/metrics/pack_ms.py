"""ms a call of the engine's scales and pack (ops/ryser.py), span `pack`:
the span's total over the window's calls, divided by the calls."""


def read(ctx):
    return ctx.span_ms("pack")
