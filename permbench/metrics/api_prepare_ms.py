"""ms a call of the API's preparation (api.permanent: the flags, the
device, _as_dense and its checks), span `api_prepare`: the span's total
over the window's calls, divided by the calls."""


def read(ctx):
    return ctx.span_ms("api_prepare")
