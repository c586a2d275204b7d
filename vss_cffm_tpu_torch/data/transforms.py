"""Eval-time clip preprocessing as tensor operations on the device.

The port's own copy of the JAX package's eval pipeline
(``vss_cffm_tpu/data/transforms.py``): keep-ratio rescale of every frame to
fit ``img_scale`` (mmcv ``imrescale``), a second rescale of both sides up to
multiples of 32 (``AlignedResize_clips``), then BGR→RGB and
(x − mean) / std with the mmcv ImageNet statistics.

One difference, by design: the JAX package resizes uint8 frames with cv2's
fixed-point ``INTER_LINEAR`` and rounds back to uint8; here frames are
resized as f32 with ``F.interpolate`` (bilinear, half-pixel centres, no
antialias) and not rounded. The two agree up to that rounding, and exactly
when a resize is the identity.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

__all__ = ["IMG_MEAN", "IMG_STD", "rescale_size", "aligned_size", "aligned_resize_clip",
           "normalize_clip"]

IMG_MEAN = (123.675, 116.28, 103.53)
IMG_STD = (58.395, 57.12, 57.375)


def rescale_size(hw: tuple[int, int], scale: tuple[int, int]) -> tuple[int, int]:
    """mmcv ``rescale_size``: (h, w) fit into (long, short), ratio kept."""
    h, w = hw
    f = min(max(scale) / max(h, w), min(scale) / min(h, w))
    return int(h * f + 0.5), int(w * f + 0.5)


def aligned_size(hw: tuple[int, int], size_divisor: int = 32) -> tuple[int, int]:
    return (int(math.ceil(hw[0] / size_divisor)) * size_divisor,
            int(math.ceil(hw[1] / size_divisor)) * size_divisor)


def _resize(frames: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    if tuple(frames.shape[1:3]) == tuple(hw):
        return frames
    out = F.interpolate(frames.permute(0, 3, 1, 2), size=hw, mode="bilinear",
                        align_corners=False)
    return out.permute(0, 2, 3, 1)


def aligned_resize_clip(frames: torch.Tensor, img_scale: tuple[int, int] = (853, 480),
                        size_divisor: int = 32) -> torch.Tensor:
    """frames (T, H, W, 3) → f32 (T, H', W', 3), H' and W' multiples of 32."""
    x = frames.float()
    x = _resize(x, rescale_size(tuple(x.shape[1:3]), img_scale))
    return _resize(x, aligned_size(tuple(x.shape[1:3]), size_divisor))


@functools.lru_cache(maxsize=None)
def _stats(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """mean and std on ``device``, copied there once: a copy from host memory
    synchronises the stream, so it is kept off the per-clip path."""
    return (torch.tensor(IMG_MEAN, dtype=torch.float32, device=device),
            torch.tensor(IMG_STD, dtype=torch.float32, device=device))


def normalize_clip(frames: torch.Tensor, to_rgb: bool = True) -> torch.Tensor:
    """mmcv ``imnormalize``: optional BGR→RGB, then (x − mean) / std, f32."""
    x = frames.float()
    if to_rgb:
        x = x.flip(-1)
    mean, std = _stats(x.device)
    return (x - mean) / std
