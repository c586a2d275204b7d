"""Model FLOPs of the window's completed work (``counts/<model>.py``), over
the window's seconds and the card's bf16 tensor peak, in %."""

from portbench.readers import mfu


def read(ctx):
    return mfu(ctx)
