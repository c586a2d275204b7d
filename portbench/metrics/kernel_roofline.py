"""Share of their roofline that the program's kernels reach in the traced
window: the frozen bounds of the counted kernel-op calls over the device
time of the program's kernels (``kernels.json``), in %."""

from portbench.readers import kernel_roofline


def read(ctx):
    return kernel_roofline(ctx)
