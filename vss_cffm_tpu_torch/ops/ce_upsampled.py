"""Fully reduced cross-entropy on ×s bilinear-upsampled logits.

``ce_upsampled_loss(logits, labels, s, img_w, count_acc=True, force=None)``
with logits (N, h, w, C) and labels (N, h·s, w·s) in natural layout
(uint8 or int32 on the kernel path) returns ``(wsum, corr)``:

- ``wsum = img_w · Σ_valid (lse(up) − up[label])`` over the pixels of the
  ``align_corners=False`` bilinear upsample ``up`` of the logits;
- ``corr`` = the count of valid pixels whose label's logit equals the
  pixel's largest logit (the kernel's tie rule, not a first-max argmax);
  0 when ``count_acc`` is False.

A label is valid when ``0 ≤ label < C``. The op is differentiable with
respect to ``logits`` only; ``corr`` carries no gradient.

Its CUDA kernels (``csrc/ce_upsampled.cu``) replace the TPU kernels
``vss_cffm_tpu/ops/ce_upsampled.py:_ce_fwd_loss_pallas`` (``_fwd_loss_kernel``)
and ``_ce_bwd_loss_pallas5`` (``_bwd_loss_kernel5``): neither writes anything
pixel-sized. The JAX package feeds them labels in phase layouts, which
answered TPU tiling questions; the port takes natural labels.

``ce_upsampled_loss_torch`` / ``ce_upsampled_loss_bwd_torch`` are the plain
versions: an f32 ``F.interpolate``, ``logsumexp − picked``; the backward
applies the adjoint of that upsample to ``img_w·g·(softmax − onehot)`` on
the valid pixels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from ._dispatch import ptr, require, stream_of, use_kernel

__all__ = ["ce_upsampled_loss", "ce_upsampled_loss_bwd", "ce_upsampled_loss_torch",
           "ce_upsampled_loss_bwd_torch"]

# classes one warp lane holds: a warp covers up to 32·CPL classes
_MAX_CLASSES = 256


def _check_shapes(logits: torch.Tensor, labels: torch.Tensor, s: int, op: str) -> None:
    if logits.dim() != 4 or labels.dim() != 3:
        raise ValueError(f"{op}: logits (N, h, w, C) and labels (N, H, W), got "
                         f"{tuple(logits.shape)} and {tuple(labels.shape)}")
    n, h, w, _ = logits.shape
    if tuple(labels.shape) != (n, h * s, w * s):
        raise ValueError(f"{op}: labels {tuple(labels.shape)} are not logits "
                         f"{tuple(logits.shape)} upsampled ×{s}")


def _upsample(x: torch.Tensor, s: int) -> torch.Tensor:
    """(N, h, w, C) → f32 (N, C, h·s, w·s)."""
    n, h, w, _ = x.shape
    return F.interpolate(x.float().permute(0, 3, 1, 2), size=(h * s, w * s),
                         mode="bilinear", align_corners=False)


def _valid_safe(labels: torch.Tensor, c: int) -> tuple[torch.Tensor, torch.Tensor]:
    lbl = labels.long()
    valid = (lbl >= 0) & (lbl < c)
    return valid, torch.where(valid, lbl, 0)


def ce_upsampled_loss_torch(logits: torch.Tensor, labels: torch.Tensor, s: int,
                            img_w: float, count_acc: bool = True
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    _check_shapes(logits, labels, s, "ce_upsampled_loss")
    c = logits.shape[-1]
    up = _upsample(logits, s)
    valid, safe = _valid_safe(labels, c)
    lse = torch.logsumexp(up, dim=1)
    picked = up.gather(1, safe[:, None])[:, 0]
    wsum = torch.where(valid, lse - picked, 0.0).sum() * img_w
    if count_acc:
        corr = (valid & (picked == up.amax(dim=1))).sum().float()
    else:
        corr = torch.zeros((), device=logits.device)
    return wsum, corr


def ce_upsampled_loss_bwd_torch(logits: torch.Tensor, labels: torch.Tensor,
                                g: torch.Tensor, s: int, img_w: float) -> torch.Tensor:
    """dlogits (logits' dtype) for the cotangent g of ``wsum``."""
    _check_shapes(logits, labels, s, "ce_upsampled_loss_bwd")
    c = logits.shape[-1]
    x = logits.detach().float().requires_grad_(True)
    with torch.enable_grad():
        up = _upsample(x, s)
    with torch.no_grad():
        valid, safe = _valid_safe(labels, c)
        t = torch.softmax(up.detach(), dim=1)
        t.scatter_add_(1, safe[:, None], -torch.ones_like(t[:, :1]))
        t = t * torch.where(valid, g.float() * img_w, 0.0)[:, None]
    (dx,) = torch.autograd.grad(up, x, t)
    return dx.to(logits.dtype)


def _kernel_inputs(logits: torch.Tensor, labels: torch.Tensor, s: int, op: str):
    require(logits.is_cuda and labels.is_cuda, op, "a CPU tensor")
    require(logits.dtype == torch.bfloat16, op, f"logits of dtype {logits.dtype} (bf16 only)")
    require(labels.dtype in (torch.uint8, torch.int32), op,
            f"labels of dtype {labels.dtype} (uint8 or int32)")
    c = logits.shape[-1]
    require(c <= _MAX_CLASSES, op, f"{c} classes (at most {_MAX_CLASSES})")
    require(s >= 1, op, f"scale {s}")
    return logits.contiguous(), labels.contiguous(), int(labels.dtype == torch.int32)


def _ce_fwd_launch(logits, labels, s: int, img_w: float, count_acc: bool):
    op = "ce_upsampled_loss"
    logits, labels, lbl32 = _kernel_inputs(logits, labels, s, op)
    n, h, w, c = logits.shape
    rows = n * h * s
    partial = torch.empty((rows, 2), device=logits.device, dtype=torch.float32)
    dev, stream = stream_of(logits)
    rc = _build.library("ce_upsampled").ce_fwd_loss(
        ptr(logits, op), ptr(labels, op), ptr(partial, op), n, h, w, c, s, lbl32,
        float(img_w), int(count_acc), dev, stream)
    _build.check(rc, op)
    sums = partial.sum(dim=0)
    return sums[0], sums[1]


def _ce_bwd_launch(logits, labels, g: torch.Tensor, s: int, img_w: float) -> torch.Tensor:
    op = "ce_upsampled_loss_bwd"
    logits, labels, lbl32 = _kernel_inputs(logits, labels, s, op)
    n, h, w, c = logits.shape
    gf = g.detach().to(device=logits.device, dtype=torch.float32).reshape(1).contiguous()
    out = torch.empty_like(logits)
    dev, stream = stream_of(logits)
    rc = _build.library("ce_upsampled").ce_bwd_loss(
        ptr(logits, op), ptr(labels, op), ptr(gf, op), ptr(out, op), n, h, w, c, s, lbl32,
        float(img_w), dev, stream)
    _build.check(rc, op)
    return out


def ce_upsampled_loss_bwd(logits: torch.Tensor, labels: torch.Tensor, g: torch.Tensor,
                          s: int, img_w: float, force: str | None = None) -> torch.Tensor:
    """The backward of ``ce_upsampled_loss``: dlogits for the cotangent g of
    ``wsum``. force: None (kernel on CUDA, plain on CPU) | 'torch' | 'kernel'."""
    if not use_kernel(force, logits, "ce_upsampled_loss_bwd"):
        return ce_upsampled_loss_bwd_torch(logits, labels, g, s, img_w)
    out = _ce_bwd_launch(logits, labels, g, s, img_w)
    ce_upsampled_loss_bwd.launches += 1
    return out


class _CEUpsampledLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, s, img_w, count_acc, force, kernel):
        if kernel:
            wsum, corr = _ce_fwd_launch(logits, labels, s, img_w, count_acc)
            ce_upsampled_loss.launches += 1
        else:
            wsum, corr = ce_upsampled_loss_torch(logits, labels, s, img_w, count_acc)
        ctx.save_for_backward(logits, labels)
        ctx.args = (s, img_w, force)
        ctx.mark_non_differentiable(corr)
        return wsum, corr

    @staticmethod
    def backward(ctx, g_wsum, g_corr):
        logits, labels = ctx.saved_tensors
        s, img_w, force = ctx.args
        dlogits = ce_upsampled_loss_bwd(logits, labels, g_wsum, s, img_w, force=force)
        return dlogits, None, None, None, None, None, None


def ce_upsampled_loss(logits: torch.Tensor, labels: torch.Tensor, s: int, img_w: float,
                      count_acc: bool = True, force: str | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """force: None (kernel on CUDA, plain on CPU) | 'torch' | 'kernel'; the
    backward follows the same rule (``ce_upsampled_loss_bwd``)."""
    _check_shapes(logits, labels, s, "ce_upsampled_loss")
    kernel = use_kernel(force, logits, "ce_upsampled_loss")
    return _CEUpsampledLoss.apply(logits, labels, s, float(img_w), count_acc, force, kernel)


ce_upsampled_loss.launches = 0
ce_upsampled_loss_bwd.launches = 0
