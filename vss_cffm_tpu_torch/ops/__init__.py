"""Ops of the port. Each op with a CUDA kernel takes ``force=None|'torch'|'kernel'``
and carries its launch count as ``<op>.launches``."""

from .cfm_attention import cfm_attention, cfm_attention_torch
from .dwconv import dwconv3x3, dwconv3x3_torch
from .resize import resize_bilinear, resize_nearest
from .stage_block import mit_block_fused, mit_block_step_errors, mit_block_torch

__all__ = [
    "cfm_attention", "cfm_attention_torch",
    "dwconv3x3", "dwconv3x3_torch",
    "mit_block_fused", "mit_block_torch", "mit_block_step_errors",
    "resize_bilinear", "resize_nearest",
    "KERNEL_OPS", "reset_launches", "launches",
]

# the ops whose wrappers launch a CUDA kernel of this package
KERNEL_OPS = {"mit_block_fused": mit_block_fused, "cfm_attention": cfm_attention,
              "dwconv3x3": dwconv3x3}


def reset_launches() -> None:
    for fn in KERNEL_OPS.values():
        fn.launches = 0


def launches() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNEL_OPS.items()}
