"""Inference API of the port (reference ``mmseg/apis/inference.py``).

- ``init_segmentor(config, state_dict=None, device="cuda", dtype=None,
  img_scale=None, seed=0, checkpoint=None)`` builds the segmentor of
  ``config``, which is an experiment config file (loaded with
  ``config.load_config``), an ``ExperimentConfig``, a ``SegmentorConfig`` or
  a CFFM variant name ("b0", "b1", ...). The model is the one of
  ``arch`` (``models.build_segmentor``: the CFFM clip segmentor or the
  single-frame SegFormer). From an experiment config, ``img_scale`` is
  ``cfg.data.img_scale`` and the compute dtype bf16, or f32 where ``cfg.bf16``
  is false; an explicit keyword wins over the config; without one
  ``img_scale`` is (853, 480) and the dtype bf16. Without a ``state_dict``
  or ``checkpoint`` the weights are random, drawn from ``seed``; a
  ``state_dict`` is loaded strictly (reference PyTorch names).
  ``checkpoint`` (as ``vss_cffm_tpu/apis.py:38-58``) is a reference
  ``.pth`` / ``.pt`` (the port's names are the reference's: every weight of
  the model must be in it, keys the model lacks, such as mmseg's unused
  ``conv_seg``, are ignored) or a ``CheckpointManager`` directory (its
  latest step overlaid on the random init). It runs on the card unless
  ``device="cpu"`` is asked for, and raises when no CUDA device is present.
  The bundle carries the experiment config as ``cfg`` (None when it was
  given a model config or a variant).
- ``inference_segmentor(bundle, frames)`` takes a clip (a list of HWC uint8
  BGR frames, numpy arrays, tensors or image paths; the last is the target
  frame) or one frame, runs the eval pipeline (aligned rescale to /32
  multiples, normalise) and returns the (H, W) int64 mask of the target
  frame at its original size: logits → resize to the network input →
  resize to the original → argmax. An image model sees the target frame
  alone (``vss_cffm_tpu/apis.py:83-85``); a clip model given a clip of
  another length than ``num_clips`` gives its plain per-frame logits.
- ``show_result(img, seg, palette=VSPW_PALETTE, opacity=0.5)``: the mask's
  colours blended over the BGR frame (reference ``base.py:241-303``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Sequence

import numpy as np
import torch

from .config import ExperimentConfig, SegmentorConfig, build_model_config, load_config
from .data.palette import VSPW_PALETTE
from .data.transforms import aligned_resize_clip, normalize_clip
from .models.segmentor import build_segmentor, target_logits
from .ops.resize import resize_bilinear

__all__ = ["SegmentorBundle", "init_segmentor", "inference_segmentor", "clip_logits",
           "show_result"]


@dataclasses.dataclass
class SegmentorBundle:
    model: torch.nn.Module  # CFFMSegmentor | ImageSegmentor
    config: SegmentorConfig
    device: torch.device
    img_scale: tuple[int, int]
    cfg: ExperimentConfig | None = None


def init_segmentor(config: ExperimentConfig | SegmentorConfig | str = "b1",
                   state_dict: dict[str, torch.Tensor] | None = None,
                   device: str | torch.device = "cuda",
                   dtype: torch.dtype | None = None,
                   img_scale: tuple[int, int] | None = None,
                   seed: int = 0, checkpoint: str | None = None) -> SegmentorBundle:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_segmentor: no CUDA device is present; pass device='cpu' "
                           "to run on the CPU")
    exp = None
    if isinstance(config, str):
        is_file = config.endswith(".py") or os.path.isfile(config)
        config = load_config(config) if is_file else build_model_config(config)
    if isinstance(config, ExperimentConfig):
        exp, config = config, config.model
        img_scale = img_scale or exp.data.img_scale
        dtype = dtype or (torch.bfloat16 if exp.bf16 else torch.float32)
    if state_dict is not None and checkpoint is not None:
        raise ValueError("init_segmentor: a state_dict or a checkpoint, not both")
    model = build_segmentor(config, dtype=dtype or torch.bfloat16)
    if state_dict is None:
        model.init_weights(torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(state_dict, strict=True)
    if checkpoint is not None and checkpoint.endswith((".pth", ".pt")):
        from .utils.weights import load_torch_state_dict

        missing = model.load_state_dict(load_torch_state_dict(checkpoint),
                                        strict=False).missing_keys
        if missing:
            raise KeyError(f"init_segmentor: {checkpoint} lacks {len(missing)} weights of the "
                           f"model, e.g. {missing[:3]}")
    elif checkpoint is not None:
        from .train.checkpoint import CheckpointManager

        CheckpointManager(checkpoint).load_params(model)
    model.to(device).eval()
    return SegmentorBundle(model, config, device, tuple(img_scale or (853, 480)), exp)


def _prepare_clip(bundle: SegmentorBundle, frames) -> tuple[torch.Tensor, tuple[int, int]]:
    if isinstance(frames, str) or (isinstance(frames, (np.ndarray, torch.Tensor))
                                   and frames.ndim == 3):
        frames = [frames]
    if not isinstance(frames, Sequence) or not frames:
        raise ValueError("frames: expected a non-empty list of HWC uint8 frames or image paths")
    if any(isinstance(f, str) for f in frames):
        from .data.vspw import load_image

        frames = [load_image(f) if isinstance(f, str) else f for f in frames]
    clip = torch.stack([torch.as_tensor(f) for f in frames]).to(bundle.device)
    ori = tuple(clip.shape[1:3])
    x = normalize_clip(aligned_resize_clip(clip, bundle.img_scale))
    return x[None], ori


@torch.inference_mode()
def clip_logits(bundle: SegmentorBundle, frames) -> tuple[torch.Tensor, tuple[int, int]]:
    """Network logits (1, h, w, K) of the target frame, and its original size."""
    x, ori = _prepare_clip(bundle, frames)
    logits = target_logits(bundle.model, x)
    return resize_bilinear(logits, tuple(x.shape[2:4])), ori


@torch.inference_mode()
def inference_segmentor(bundle: SegmentorBundle, frames) -> torch.Tensor:
    logits, ori = clip_logits(bundle, frames)
    return resize_bilinear(logits, ori).argmax(dim=-1)[0]


def show_result(img, seg, palette=VSPW_PALETTE, opacity: float = 0.5) -> np.ndarray:
    """(H, W, 3) uint8 BGR: the mask's palette colours (given as RGB) blended
    over ``img``, a BGR array or an image path (reference ``base.py:241-303``)."""
    if isinstance(img, str):
        from .data.vspw import load_image

        img = load_image(img)
    seg = np.asarray(seg.cpu() if isinstance(seg, torch.Tensor) else seg)
    color = np.zeros((*seg.shape, 3), np.uint8)
    for cls, rgb in enumerate(palette):
        color[seg == cls] = rgb[::-1]  # BGR
    out = np.asarray(img) * (1 - opacity) + color * opacity
    return out.astype(np.uint8)
