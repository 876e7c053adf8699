"""ms a call of the API and the runner (api.py, drivers/runner.py,
ops/batch.permanent_batch's grouping): each call's host clock less the
program's spans inside it (all but the outer `permanent[...]`), summed
over the window's calls and divided by them."""


def read(ctx):
    calls = [c for c in ctx.calls if c.spans]
    if not calls:
        return None
    rest = sum(c.wall_s - sum(v for k, v in c.spans.items()
                              if not k.startswith("permanent["))
               for c in calls)
    return rest / len(calls) * 1e3
