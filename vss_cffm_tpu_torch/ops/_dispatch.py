"""The ``force=`` rule shared by every op with a kernel, and launch helpers.

``force=None`` launches the kernel for a CUDA tensor and runs the plain
PyTorch version for a CPU tensor; ``"torch"`` always runs the plain version;
``"kernel"`` launches the kernel and raises on a CPU tensor. There is no
fallback: a CUDA tensor the kernel does not take raises. ``custom_op``
registers an op's implementation as ``torch.ops.vss_cffm.<op>``.
"""

from __future__ import annotations

import torch

__all__ = ["use_kernel", "require", "refuse_grad", "records_grad", "custom_op", "NAMESPACE",
           "stream_of", "ptr", "sm_count"]

# the namespace of the port's custom ops (``torch.ops.vss_cffm.<op>``)
NAMESPACE = "vss_cffm"

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


def records_grad(args) -> bool:
    """Whether autograd records a call on ``args``: grad mode is on and one
    of the tensors among them requires grad."""
    return torch.is_grad_enabled() and any(isinstance(a, torch.Tensor) and a.requires_grad
                                           for a in args)


def refuse_grad(op: str, args: tuple, instead: str) -> None:
    """Raise, rather than cut a gradient, when an op with no backward is
    called while autograd records and one of its inputs requires grad."""
    if records_grad(args):
        raise RuntimeError(f"{op} has no backward: train with {instead}, or run it under "
                           "torch.no_grad()")


# the library that holds the port's custom ops (kept for the process's life:
# a library that is collected unregisters its ops)
_LIB = torch.library.Library(NAMESPACE, "FRAGMENT")


def _like_first(x: torch.Tensor, *args) -> torch.Tensor:
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def custom_op(name: str, fake=_like_first):
    """Register the decorated function as the op ``vss_cffm::<name>`` (its
    schema from the annotations, no argument mutated) and return the op.
    The function is the op's real implementation, which keeps the ``force=``
    rule and counts its launches; ``fake`` gives the output's shape and
    dtype alone (by default those of the first argument, contiguous), so
    that ``torch.export`` keeps the op as one node of the graph and a
    reloaded program calls the real implementation. The
    implementation is a CompositeExplicitAutograd kernel, one dispatcher
    hop (``torch.library.custom_op`` adds a Python autograd layer to every
    call): autograd never records it, as the wrappers route calls that
    autograd would record to their ``torch.autograd.Function`` or refuse
    them."""
    def register(fn):
        _LIB.define(name + torch.library.infer_schema(fn, mutates_args=()))
        _LIB.impl(name, fn, "CompositeExplicitAutograd")
        torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)
        return getattr(getattr(torch.ops, NAMESPACE), name).default
    return register


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


def sm_count(x: torch.Tensor) -> int:
    """Streaming multiprocessors of x's device (the plans size their grids by it)."""
    return torch.cuda.get_device_properties(x.device).multi_processor_count
