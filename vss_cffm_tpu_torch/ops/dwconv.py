"""3×3 depthwise conv + bias (+ exact GELU), NHWC.

``dwconv3x3(x, kernel, bias, gelu, force=None)`` with x (B, H, W, C) and
kernel (3, 3, 1, C) in the JAX package's layout. Its CUDA kernel
(``csrc/dwconv.cu``) replaces the TPU kernel
``vss_cffm_tpu/ops/dwconv.py:_dwconv3x3_pallas``; ``dwconv3x3_torch`` is the
plain version with the same arithmetic: taps accumulated in f32, f32 bias,
exact erf GELU, one cast to x's dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from ._dispatch import ptr, require, stream_of, use_kernel

__all__ = ["dwconv3x3", "dwconv3x3_torch", "dwconv3x3_launch"]


def dwconv3x3_torch(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                    gelu: bool = False) -> torch.Tensor:
    b, h, w, c = x.shape
    k = kernel.reshape(3, 3, c).float()
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    acc = None
    for di in range(3):
        for dj in range(3):
            term = xp[:, di:di + h, dj:dj + w, :] * k[di, dj]
            acc = term if acc is None else acc + term
    acc = acc + bias.float()
    if gelu:
        acc = F.gelu(acc)
    return acc.to(x.dtype)


def dwconv3x3_launch(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                     gelu: bool, op: str = "dwconv3x3") -> torch.Tensor:
    """Launch the CUDA kernel: x bf16 or f32 (B, H, W, C) → bf16. No count."""
    require(x.is_cuda, op, "a CPU tensor")
    require(x.dim() == 4, op, f"x of shape {tuple(x.shape)}")
    require(x.dtype in (torch.bfloat16, torch.float32), op, f"x of dtype {x.dtype}")
    b, h, w, c = x.shape
    require(c % 8 == 0, op, f"C={c} not a multiple of 8")
    require(tuple(kernel.shape) == (3, 3, 1, c), op, f"kernel of shape {tuple(kernel.shape)}")
    require(tuple(bias.shape) == (c,), op, f"bias of shape {tuple(bias.shape)}")
    wk = kernel.reshape(9, c).to(device=x.device, dtype=torch.float32).contiguous()
    bb = bias.to(device=x.device, dtype=torch.float32).contiguous()
    out = torch.empty(x.shape, device=x.device, dtype=torch.bfloat16)
    dev, stream = stream_of(x)
    rc = _build.library("dwconv").dwconv3x3_nhwc(
        ptr(x, op), ptr(wk, op), ptr(bb, op), ptr(out, op), b, h, w, c,
        int(x.dtype == torch.float32), int(gelu), dev, stream)
    _build.check(rc, op)
    return out


def dwconv3x3(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
              gelu: bool = False, force: str | None = None) -> torch.Tensor:
    """force: None (kernel on CUDA, plain on CPU) | 'torch' | 'kernel'."""
    if not use_kernel(force, x, "dwconv3x3"):
        return dwconv3x3_torch(x, kernel, bias, gelu)
    require(x.dtype == torch.bfloat16, "dwconv3x3", f"x of dtype {x.dtype} (bf16 only)")
    out = dwconv3x3_launch(x, kernel, bias, gelu)
    dwconv3x3.launches += 1
    return out


dwconv3x3.launches = 0
