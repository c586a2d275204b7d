"""Device milliseconds a step of the kernels launched inside the
optimizer's step (the ``Optimizer.step`` range torch.optim records), in the
traced window that records the host's ops."""


def read(ctx):
    if "ops_trace" not in ctx:
        return None
    seconds, ranges = ctx["ops_trace"].range_device_s("Optimizer.step#")
    return 1e3 * seconds / ctx["traced_steps"] if ranges else None
