"""Whole / sliding-window inference and test-time augmentation.

The port's copy of ``vss_cffm_tpu/eval/inference.py`` (reference
``mmseg/models/segmentors/encoder_decoder.py``), on NHWC tensors:

- ``whole_inference`` (``:502-516``): logits, bilinear to the network input,
  bilinear to the original shape, softmax;
- ``slide_inference`` (``:457-500``): the same grid of overlapping crops,
  each crop's logits (resized to the crop) added in place into an f32 map
  and a count map, the map divided by the counts, resized, softmax;
- ``tta_inference`` (``aug_test`` with ``MultiScaleFlipAug``, ``base.py:76-111``,
  ``test_time_aug.py:10-133``): the mean of the views' softmax, each flipped
  view unflipped before the mean (``encoder_decoder.py:543-551``).

The softmax is taken in f32 whatever the logits' dtype (the JAX package
takes it in theirs): the views' probabilities are averaged, and bf16 would
round each before the sum.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..ops.resize import resize_bilinear

__all__ = ["whole_inference", "slide_inference", "tta_inference", "slide_grid"]


def whole_inference(logits_fn: Callable, imgs: torch.Tensor,
                    ori_shape: tuple[int, int]) -> torch.Tensor:
    """imgs (B, T, H, W, 3) clip → f32 softmax probabilities (B, *ori_shape, C)."""
    logits = logits_fn(imgs)  # (B, h, w, C)
    logits = resize_bilinear(logits, tuple(imgs.shape[-3:-1]))
    logits = resize_bilinear(logits, ori_shape)
    return torch.softmax(logits.float(), dim=-1)


def slide_grid(hw: tuple[int, int], crop_size: tuple[int, int],
               stride: tuple[int, int]) -> list[tuple[int, int]]:
    """Top-left corners (y1, x1) of the crops over an (H, W) image, in the
    reference's order; the last crop of a row or column is moved in to end
    at the border."""
    h_img, w_img = hw
    h_crop, w_crop = crop_size
    h_stride, w_stride = stride
    h_grids = max(h_img - h_crop + h_stride - 1, 0) // h_stride + 1
    w_grids = max(w_img - w_crop + w_stride - 1, 0) // w_stride + 1
    return [(min(hi * h_stride, max(h_img - h_crop, 0)), min(wi * w_stride, max(w_img - w_crop, 0)))
            for hi in range(h_grids) for wi in range(w_grids)]


def slide_inference(logits_fn: Callable, imgs: torch.Tensor, ori_shape: tuple[int, int],
                    crop_size: tuple[int, int], stride: tuple[int, int]) -> torch.Tensor:
    """imgs (B, T, H, W, 3) → f32 softmax probabilities (B, *ori_shape, C)."""
    b, _, h_img, w_img, _ = imgs.shape
    h_crop, w_crop = crop_size
    preds = None
    count = torch.zeros((1, h_img, w_img, 1), dtype=torch.float32, device=imgs.device)
    for y1, x1 in slide_grid((h_img, w_img), crop_size, stride):
        crop = imgs[:, :, y1:y1 + h_crop, x1:x1 + w_crop]
        logit = resize_bilinear(logits_fn(crop), (h_crop, w_crop))
        if preds is None:
            preds = torch.zeros((b, h_img, w_img, logit.shape[-1]), dtype=torch.float32,
                                device=imgs.device)
        preds[:, y1:y1 + h_crop, x1:x1 + w_crop] += logit.float()
        count[:, y1:y1 + h_crop, x1:x1 + w_crop] += 1.0
    preds = resize_bilinear(preds / count, ori_shape)
    return torch.softmax(preds, dim=-1)


def tta_inference(logits_fn: Callable, clips: Sequence[torch.Tensor], flips: Sequence[bool],
                  ori_shape: tuple[int, int]) -> torch.Tensor:
    """clips: one (B, T, H_s, W_s, 3) per view; a flipped view is mirrored
    along W before the network and its probabilities mirrored back before
    the mean. → f32 (B, *ori_shape, C)."""
    total = None
    for imgs, flip in zip(clips, flips):
        view = imgs.flip(3) if flip else imgs
        prob = whole_inference(logits_fn, view, ori_shape)
        if flip:
            prob = prob.flip(2)
        total = prob if total is None else total + prob
    return total / len(clips)
