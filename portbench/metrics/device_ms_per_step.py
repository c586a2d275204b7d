"""Device milliseconds a step: the union of the profiler's device intervals
over the profiled steps (CUDA activities alone), a step. It does not depend
on the host's pace, so it stays steady where the host's time moves a
host-paced cell's frames/s."""


def read(ctx):
    if "trace" not in ctx:
        return None
    return 1e3 * ctx["trace"].busy_s() / ctx["traced_steps"]
