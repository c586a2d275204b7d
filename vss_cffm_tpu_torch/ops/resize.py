"""Bilinear and nearest resize of channels-last maps through ``F.interpolate``.

The JAX package's ``ops/resize.py`` reproduces PyTorch's ``interpolate``
(half-pixel centres for ``align_corners=False``, no antialias), so the port
calls it directly. Maps are (..., H, W, C), the JAX package's layout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["resize_bilinear", "resize_nearest"]


def _resize(x: torch.Tensor, out_hw: tuple[int, int], **kw) -> torch.Tensor:
    h_out, w_out = int(out_hw[0]), int(out_hw[1])
    if tuple(x.shape[-3:-1]) == (h_out, w_out):
        return x
    lead = x.shape[:-3]
    h, w, c = x.shape[-3:]
    nchw = x.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    out = F.interpolate(nchw, size=(h_out, w_out), **kw)
    return out.permute(0, 2, 3, 1).reshape(*lead, h_out, w_out, c)


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int],
                    align_corners: bool = False) -> torch.Tensor:
    return _resize(x, out_hw, mode="bilinear", align_corners=align_corners)


def resize_nearest(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    return _resize(x, out_hw, mode="nearest")
