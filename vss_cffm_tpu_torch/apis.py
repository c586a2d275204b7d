"""Clip inference API of the port.

- ``init_segmentor(model_config_or_variant, state_dict=None, device="cuda",
  dtype=torch.bfloat16, img_scale=(853, 480), seed=0)`` builds a
  ``CFFMSegmentor``. Without a ``state_dict`` the weights are random, drawn
  from ``seed``; with one, it is loaded strictly (reference PyTorch names).
  It runs on the card unless ``device="cpu"`` is asked for, and raises when
  no CUDA device is present.
- ``inference_segmentor(bundle, frames)`` takes a clip (a list of HWC uint8
  BGR frames, numpy arrays or tensors; the last is the target frame) or one
  frame, runs the eval pipeline (aligned rescale to /32 multiples, normalise)
  and returns the (H, W) int64 mask of the target frame at its original size:
  logits → resize to the network input → resize to the original → argmax.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from .config import SegmentorConfig, build_model_config
from .data.transforms import aligned_resize_clip, normalize_clip
from .models.segmentor import CFFMSegmentor
from .ops.resize import resize_bilinear

__all__ = ["SegmentorBundle", "init_segmentor", "inference_segmentor", "clip_logits"]


@dataclasses.dataclass
class SegmentorBundle:
    model: CFFMSegmentor
    config: SegmentorConfig
    device: torch.device
    img_scale: tuple[int, int]


def init_segmentor(model_config_or_variant: SegmentorConfig | str = "b1",
                   state_dict: dict[str, torch.Tensor] | None = None,
                   device: str | torch.device = "cuda",
                   dtype: torch.dtype = torch.bfloat16,
                   img_scale: tuple[int, int] = (853, 480),
                   seed: int = 0) -> SegmentorBundle:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_segmentor: no CUDA device is present; pass device='cpu' "
                           "to run on the CPU")
    cfg = model_config_or_variant
    if isinstance(cfg, str):
        cfg = build_model_config(cfg)
    model = CFFMSegmentor(cfg, dtype=dtype)
    if state_dict is None:
        model.init_weights(torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(state_dict, strict=True)
    model.to(device).eval()
    return SegmentorBundle(model, cfg, device, tuple(img_scale))


def _prepare_clip(bundle: SegmentorBundle, frames) -> tuple[torch.Tensor, tuple[int, int]]:
    if isinstance(frames, (np.ndarray, torch.Tensor)) and frames.ndim == 3:
        frames = [frames]
    if not isinstance(frames, Sequence) or not frames:
        raise ValueError("frames: expected a non-empty list of HWC uint8 frames")
    clip = torch.stack([torch.as_tensor(f) for f in frames]).to(bundle.device)
    ori = tuple(clip.shape[1:3])
    x = normalize_clip(aligned_resize_clip(clip, bundle.img_scale))
    return x[None], ori


@torch.inference_mode()
def clip_logits(bundle: SegmentorBundle, frames) -> tuple[torch.Tensor, tuple[int, int]]:
    """Network logits (1, h, w, K) of the target frame, and its original size."""
    x, ori = _prepare_clip(bundle, frames)
    logits = bundle.model(x)
    return resize_bilinear(logits, tuple(x.shape[2:4])), ori


@torch.inference_mode()
def inference_segmentor(bundle: SegmentorBundle, frames) -> torch.Tensor:
    logits, ori = clip_logits(bundle, frames)
    return resize_bilinear(logits, ori).argmax(dim=-1)[0]
