"""ms a call of the host's wait for a walk dealt over several cards
(parallel/sharding._deal): blocked in mesh.synchronize() until every
entry's stream is done, so the slowest card sets it, span `mesh_wait`:
the span's total over the window's calls, divided by the calls.  None
where no call dealt its walk."""


def read(ctx):
    return ctx.span_ms("mesh_wait")
