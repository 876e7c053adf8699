"""ms a call of queuing a walk dealt over several cards
(parallel/sharding._deal): every mesh entry's uploads, ids and K1 launch
queued on its own stream, span `mesh_launch`: the span's total over the
window's calls, divided by the calls.  None where no call dealt its
walk."""


def read(ctx):
    return ctx.span_ms("mesh_launch")
