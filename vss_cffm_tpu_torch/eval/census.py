"""Eval-shape census: the network input shapes an eval pass will see.

The port's copy of ``vss_cffm_tpu/eval/census.py``. Each distinct
(T, aligned H, aligned W, original H, original W) is one input geometry of
the forward; the census counts them from one image header per video (the
frames of a video share their size), with no decode and no device. On VSPW
(480p, one aspect ratio) it is one shape, 480×864 at ``img_scale`` (853,
480); multi-scale TTA multiplies it by the number of ratios (a flip reuses
its ratio's shape).
"""

from __future__ import annotations

from collections import Counter

from ..data.transforms import aligned_size, rescale_size

__all__ = ["eval_shape_census"]


def eval_shape_census(dataset, tta_ratios=None) -> dict:
    """``{"shapes": {(T, ah, aw, oh, ow): n_frames}, "num_compiles",
    "num_videos", "num_frames"}`` of one eval pass over ``dataset``
    (``num_compiles``: the number of distinct shapes, the JAX package's name)."""
    from PIL import Image

    ratios = list(tta_ratios) if tta_ratios else [1.0]
    t = len(dataset.dilation) + 1
    shapes: Counter = Counter()
    for video, frames in dataset.frames.items():
        with Image.open(dataset._img_path(video, frames[0])) as im:
            w0, h0 = im.size
        for r in ratios:
            scale = (int(dataset.img_scale[0] * r), int(dataset.img_scale[1] * r))
            ah, aw = aligned_size(rescale_size((h0, w0), scale))
            shapes[(t, ah, aw, h0, w0)] += len(frames)
    return {
        "shapes": dict(shapes),
        "num_compiles": len(shapes),
        "num_videos": len(dataset.frames),
        "num_frames": sum(len(f) for f in dataset.frames.values()),
    }
