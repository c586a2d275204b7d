"""The ``force=`` rule shared by every op with a kernel, and launch helpers.

``force=None`` launches the kernel for a CUDA tensor and runs the plain
PyTorch version for a CPU tensor; ``"torch"`` always runs the plain version;
``"kernel"`` launches the kernel and raises on a CPU tensor. There is no
fallback: a CUDA tensor the kernel does not take raises.
"""

from __future__ import annotations

import torch

__all__ = ["use_kernel", "require", "refuse_grad", "stream_of", "ptr"]

_FORCES = (None, "torch", "kernel")

# peak shared memory one block can use on the H100 (sm_90)
SMEM_LIMIT = 232448


def use_kernel(force: str | None, x: torch.Tensor, op: str) -> bool:
    if force not in _FORCES:
        raise ValueError(f"{op}: force must be one of {_FORCES}, got {force!r}")
    if force == "torch":
        return False
    if force == "kernel" and not x.is_cuda:
        raise RuntimeError(f"{op}: force='kernel' needs CUDA tensors, got {x.device}")
    return x.is_cuda


def require(cond: bool, op: str, what) -> None:
    """Raise the wrapper's refusal when a kernel cannot take its inputs;
    ``what`` is the reason, or a callable that formats it (only on refusal,
    so that a hot wrapper does not format shapes on every call)."""
    if not cond:
        if callable(what):
            what = what()
        raise ValueError(f"{op}: the CUDA kernel does not take this input: {what}")


def refuse_grad(op: str, args: tuple, instead: str) -> None:
    """Raise, rather than cut a gradient, when an op with no backward is
    called while autograd records and one of its inputs requires grad."""
    if torch.is_grad_enabled() and any(isinstance(a, torch.Tensor) and a.requires_grad
                                       for a in args):
        raise RuntimeError(f"{op} has no backward: train with {instead}, or run it under "
                           "torch.no_grad()")


def ptr(t: torch.Tensor | None, op: str) -> int | None:
    if t is None:
        return None
    require(t.is_contiguous(), op, "a non-contiguous tensor")
    require(t.data_ptr() % 16 == 0, op, "a tensor not 16-byte aligned")
    return t.data_ptr()


def stream_of(x: torch.Tensor) -> tuple[int, int]:
    """(device index, current stream handle) for launches on x's device."""
    dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
    return dev, torch.cuda.current_stream(dev).cuda_stream
