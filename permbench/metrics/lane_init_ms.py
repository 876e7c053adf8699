"""ms a call of the lane walk's set-up (ops/ryser_walk.ryser_walk below
n=19: the row scales, the lanes' Gray start on the host, their copies to
the card), span `lane_init`: the span's total over the window's calls,
divided by the calls; None where no call recorded it."""


def read(ctx):
    return ctx.span_ms("lane_init")
