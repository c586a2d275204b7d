"""Timing of one call, the counterpart of the JAX package's
``vss_cffm_tpu/utils/benchmark.py:time_apply_chunked``.

On the card: after ``warmup`` calls, chunks of ``chunk`` back-to-back calls,
each chunk between two CUDA events on the current stream; the time per call
of the fastest chunk (each chunk already averages ``chunk`` calls, and the
fastest is the one least held up by the host). The events are recorded on
the device's stream, so there is no host round trip to subtract. On the CPU
(a tool run with ``--device cpu``) the host clock, which times PyTorch's CPU
kernels and is no device metric.
"""

from __future__ import annotations

import time
from typing import Callable

import torch

__all__ = ["time_apply_chunked"]


def time_apply_chunked(fn: Callable[[], object], device: torch.device | str,
                       iters: int = 100, warmup: int = 2, chunk: int = 50) -> float:
    """Seconds per call of ``fn()``, the fastest of ``max(iters // chunk, 1)``
    chunks of ``chunk`` calls."""
    cuda = torch.device(device).type == "cuda"
    for _ in range(warmup):
        fn()
    if cuda:
        torch.cuda.synchronize()
    times = []
    for _ in range(max(iters // chunk, 1)):
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(chunk):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            for _ in range(chunk):
                fn()
            times.append(time.perf_counter() - t0)
    return min(times) / chunk
