"""ms a call of the API's preparation on the lane walk's cell, by
api_prepare_ms' rule: span `api_prepare`'s total over the window's
calls, divided by the calls; None where no call recorded it."""


def read(ctx):
    return ctx.span_ms("api_prepare")
