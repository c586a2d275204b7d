"""Share of the window in which no operation ran on the device, in %: one
less the device's busy time a profiled step (the union of the profiler's
device intervals, traced with CUDA activities alone) over the untraced
window's time a step (``readers.device_idle``)."""

from portbench.readers import device_idle


def read(ctx):
    return device_idle(ctx)
