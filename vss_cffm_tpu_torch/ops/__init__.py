"""Ops of the port. Each op with a CUDA kernel takes ``force=None|'torch'|'kernel'``
and carries its launch count as ``<op>.launches``.

The inference ops that a clip forward reaches (``mit_block_fused``,
``cfm_attention`` and ``dwconv3x3`` where autograd does not record,
``block_ffn_fused``, ``mixffn_fused``) call custom ops of the ``vss_cffm``
namespace (``_dispatch.custom_op``), which ``torch.export`` keeps as one
node each: importing this package registers them, which a process that
reloads an exported program must do. The training ops stay plain Python
wrappers and ``torch.autograd.Function``s."""

from .ce_upsampled import (ce_bwd_loss_v2, ce_bwd_loss_v3, ce_fwd_loss_v3, ce_fwd_loss_v5,
                           ce_upsampled_loss, ce_upsampled_loss_bwd,
                           ce_upsampled_loss_bwd_torch, ce_upsampled_loss_torch,
                           ce_upsampled_nll, ce_upsampled_nll_bwd, ce_upsampled_nll_bwd_torch,
                           ce_upsampled_nll_torch, labels_to_phase, labels_to_phase_w,
                           phase_labels_u8, phase_to_natural)
from .cfm_attention import (attention_fwd_tiled, cfm_attention, cfm_attention_bwd, cfm_attention_bwd_probs,
                            cfm_attention_bwd_probs_torch, cfm_attention_bwd_torch,
                            cfm_attention_probs, cfm_attention_probs_torch, cfm_attention_torch)
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
    "cfm_attention_probs", "cfm_attention_probs_torch", "cfm_attention_bwd_probs",
    "cfm_attention_bwd_probs_torch", "attention_fwd_tiled",
    "dwconv3x3", "dwconv3x3_torch", "dwconv3x3_bwd_torch",
    "ce_upsampled_loss", "ce_upsampled_loss_torch", "ce_upsampled_loss_bwd",
    "ce_upsampled_loss_bwd_torch", "ce_upsampled_nll", "ce_upsampled_nll_torch",
    "ce_upsampled_nll_bwd", "ce_upsampled_nll_bwd_torch",
    "ce_bwd_loss_v2", "ce_fwd_loss_v5", "ce_fwd_loss_v3", "ce_bwd_loss_v3",
    "labels_to_phase", "labels_to_phase_w", "phase_to_natural", "phase_labels_u8",
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
              "attention_fwd_tiled": attention_fwd_tiled,
              "dwconv3x3": dwconv3x3, "cfm_attention_bwd": cfm_attention_bwd,
              "cfm_attention_bwd_probs": cfm_attention_bwd_probs,
              "ce_upsampled_loss": ce_upsampled_loss,
              "ce_upsampled_loss_bwd": ce_upsampled_loss_bwd,
              "mit_block_train": mit_block_train, "mit_block_train_bwd": mit_block_train_bwd,
              "block_ffn_train": block_ffn_train, "block_ffn_train_bwd": block_ffn_train_bwd,
              "block_ffn_fused": block_ffn_fused, "mixffn_fused": mixffn_fused,
              "ce_upsampled_nll": ce_upsampled_nll, "ce_upsampled_nll_bwd": ce_upsampled_nll_bwd,
              "ce_bwd_loss_v2": ce_bwd_loss_v2, "ce_fwd_loss_v5": ce_fwd_loss_v5,
              "ce_fwd_loss_v3": ce_fwd_loss_v3, "ce_bwd_loss_v3": ce_bwd_loss_v3}


def reset_launches() -> None:
    for fn in KERNEL_OPS.values():
        fn.launches = 0


def launches() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNEL_OPS.items()}
