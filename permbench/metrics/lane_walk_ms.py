"""ms a call of the lane walk itself (ops/ryser_walk.ryser_walk below
n=19: the 2^r - 1 Gray steps of PyTorch launches, the lane sums back, the
host sum and the scale multiplied back), span `lane_walk`: the span's
total over the window's calls, divided by the calls; None where no call
recorded it."""


def read(ctx):
    return ctx.span_ms("lane_walk")
