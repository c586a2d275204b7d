"""Host milliseconds a train step: the host clock around each ``step()``
call up to its return, summed over the window's steps, over the steps."""


def read(ctx):
    return 1e3 * ctx["host_s"] / ctx["steps"] if ctx.get("steps") else None
