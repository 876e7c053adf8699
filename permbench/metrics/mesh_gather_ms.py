"""ms a call of gathering a walk dealt over several cards
(parallel/sharding._deal): each entry's block pairs back and their
interleave into the rows' order, span `mesh_gather`: the span's total over the window's calls, divided by the
calls.  None where no call dealt its walk."""


def read(ctx):
    return ctx.span_ms("mesh_gather")
