"""ms a call of the API and the runner on the lane walk's route, by
dispatch_ms' rule: each call's host clock less the program's spans inside
it (all but the outer `permanent[...]`), summed over the window's calls
that took the lane walk (span `lane_walk`) and divided by them; None where
no call did."""


def read(ctx):
    calls = [c for c in ctx.calls if "lane_walk" in c.spans]
    if not calls:
        return None
    rest = sum(c.wall_s - sum(v for k, v in c.spans.items()
                              if not k.startswith("permanent["))
               for c in calls)
    return rest / len(calls) * 1e3
