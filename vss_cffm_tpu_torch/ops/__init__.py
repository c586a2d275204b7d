"""Ops of the port. Each op with a CUDA kernel takes ``force=None|'torch'|'kernel'``
and carries its launch count as ``<op>.launches``."""

from .ce_upsampled import (ce_upsampled_loss, ce_upsampled_loss_bwd,
                           ce_upsampled_loss_bwd_torch, ce_upsampled_loss_torch,
                           ce_upsampled_nll, ce_upsampled_nll_bwd, ce_upsampled_nll_bwd_torch,
                           ce_upsampled_nll_torch)
from .cfm_attention import (cfm_attention, cfm_attention_bwd, cfm_attention_bwd_torch,
                            cfm_attention_torch)
from .dwconv import dwconv3x3, dwconv3x3_bwd_torch, dwconv3x3_torch
from .mixffn import (block_ffn_fused, block_ffn_fused_torch, block_ffn_train,
                     block_ffn_train_bwd, block_ffn_train_bwd_torch, block_ffn_train_fits,
                     block_ffn_train_torch, mixffn_fused, mixffn_fused_torch)
from .resize import resize_bilinear, resize_nearest
from .stage_block import (mit_block_fused, mit_block_step_errors, mit_block_torch,
                          mit_block_train, mit_block_train_bwd, mit_block_train_bwd_torch,
                          mit_block_train_fits, mit_block_train_torch)

__all__ = [
    "cfm_attention", "cfm_attention_torch", "cfm_attention_bwd", "cfm_attention_bwd_torch",
    "dwconv3x3", "dwconv3x3_torch", "dwconv3x3_bwd_torch",
    "ce_upsampled_loss", "ce_upsampled_loss_torch", "ce_upsampled_loss_bwd",
    "ce_upsampled_loss_bwd_torch", "ce_upsampled_nll", "ce_upsampled_nll_torch",
    "ce_upsampled_nll_bwd", "ce_upsampled_nll_bwd_torch",
    "mit_block_fused", "mit_block_torch", "mit_block_step_errors",
    "mit_block_train", "mit_block_train_torch", "mit_block_train_bwd",
    "mit_block_train_bwd_torch", "mit_block_train_fits",
    "block_ffn_train", "block_ffn_train_torch", "block_ffn_train_bwd",
    "block_ffn_train_bwd_torch", "block_ffn_train_fits",
    "block_ffn_fused", "block_ffn_fused_torch", "mixffn_fused", "mixffn_fused_torch",
    "resize_bilinear", "resize_nearest",
    "KERNEL_OPS", "reset_launches", "launches",
]

# the ops whose wrappers launch a CUDA kernel of this package
KERNEL_OPS = {"mit_block_fused": mit_block_fused, "cfm_attention": cfm_attention,
              "dwconv3x3": dwconv3x3, "cfm_attention_bwd": cfm_attention_bwd,
              "ce_upsampled_loss": ce_upsampled_loss,
              "ce_upsampled_loss_bwd": ce_upsampled_loss_bwd,
              "mit_block_train": mit_block_train, "mit_block_train_bwd": mit_block_train_bwd,
              "block_ffn_train": block_ffn_train, "block_ffn_train_bwd": block_ffn_train_bwd,
              "block_ffn_fused": block_ffn_fused, "mixffn_fused": mixffn_fused,
              "ce_upsampled_nll": ce_upsampled_nll, "ce_upsampled_nll_bwd": ce_upsampled_nll_bwd}


def reset_launches() -> None:
    for fn in KERNEL_OPS.values():
        fn.launches = 0


def launches() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNEL_OPS.items()}
