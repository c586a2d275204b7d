"""Segmentors: the CFFM clip segmentor and the single-frame SegFormer.

Port of ``vss_cffm_tpu/models/segmentor.py``:

- ``CFFMSegmentor``: MiT backbone + CFFM clip head. The (B, T) clip is
  flattened into a (B·T) frame batch through the backbone and the per-frame
  decode, and the CFFM head refines the last frame; in training it returns
  every frame's logits and the refined last frame.
- ``ImageSegmentor``: MiT backbone + SegFormer head, one frame in, its
  logits out (``SegmentorConfig.arch == "image"``).
- ``build_segmentor(config, dtype)`` picks one by ``config.arch``;
  ``target_logits(model, clip)`` gives either the target frame's logits of
  a normalised clip.

``CFFMSegmentor(config, dtype, force)`` (and ``ImageSegmentor`` alike):
parameters are f32; ``dtype`` is the compute dtype of every module;
``force`` is handed to every op with a kernel (see ``set_force``; the train
step hands the model's ``force`` to the loss). ``init_weights(generator)``
draws random weights with the reference's initialisers from an explicit
generator.

CFFM++ (``head.mode="finetune"``): ``forward`` and ``predict_from_features``
take the video's ``cluster_centers``; in finetune training the backbone
keeps its train form (drop path) but runs without autograd, since only the
head's cluster branch trains. ``prototype_features`` gives phase A's fused
1/8 features.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn as nn

from .. import parallel
from ..config import SegmentorConfig
from .cffm_transformer import CFFMWindowAttention, _PoolLinear
from .heads import CFFMHead, SegFormerHead
from .mit import MiT

__all__ = ["CFFMSegmentor", "ImageSegmentor", "build_segmentor", "target_logits",
           "is_image_model", "set_force", "set_compute_dtype"]


def set_force(model: nn.Module, force: str | None) -> None:
    """Set the ``force=`` of every op call inside ``model``."""
    for m in model.modules():
        if hasattr(m, "force"):
            m.force = force


def set_compute_dtype(model: nn.Module, dtype: torch.dtype) -> None:
    for m in model.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = dtype


def _trunc_normal(t: torch.Tensor, std: float, g: torch.Generator) -> None:
    nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=g)


class _EncoderDecoder(nn.Module):
    """A MiT backbone and a decode head built by ``head_cls``, with the
    reference's initialisers."""

    def __init__(self, config: SegmentorConfig, head_cls, dtype: torch.dtype,
                 force: str | None):
        super().__init__()
        self.config = config
        self.backbone = MiT(config.backbone_config)
        self.decode_head = head_cls(config.head)
        self.force: str | None = None
        set_compute_dtype(self, dtype)
        set_force(self, force)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Reference initialisers: trunc-normal(0.02) dense kernels, fan-out
        normal convs, normal(0.01) class convs, identity norms, zero biases,
        mean-initialised pooling, zero window bias table."""
        g = generator
        for name, m in self.named_modules():
            if isinstance(m, _PoolLinear):
                m.weight.fill_(1.0 / m.in_features)
                m.bias.zero_()
            elif isinstance(m, nn.Linear):
                _trunc_normal(m.weight, 0.02, g)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.Conv2d):
                if name.endswith(("linear_pred", "linear_pred2", "linear_pred3")):
                    m.weight.normal_(0.0, 0.01, generator=g)
                elif name.endswith("linear_fuse.conv"):
                    # variance scaling (1, fan_out) truncated normal
                    _trunc_normal(m.weight, math.sqrt(1.0 / m.out_channels) / 0.8796256610342398, g)
                else:
                    kh, kw = m.kernel_size
                    fan_out = kh * kw * m.out_channels // m.groups
                    m.weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=g)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.LayerNorm, nn.BatchNorm2d)):
                m.weight.fill_(1.0)
                m.bias.zero_()
                if isinstance(m, nn.BatchNorm2d):
                    m.running_mean.zero_()
                    m.running_var.fill_(1.0)
            elif isinstance(m, CFFMWindowAttention):
                m.relative_position_bias_table.zero_()
                _trunc_normal(m.relative_position_bias_table_to_neighbors, 0.02, g)
                for p in (*m.relative_position_bias_table_to_windows,
                          *m.relative_position_bias_table_to_windows_clips):
                    _trunc_normal(p, 0.02, g)


class CFFMSegmentor(_EncoderDecoder):
    def __init__(self, config: SegmentorConfig, dtype: torch.dtype = torch.float32,
                 force: str | None = None):
        if config.arch != "cffm":
            raise ValueError(f"CFFMSegmentor: arch={config.arch!r}; build_segmentor builds "
                             "the model of any arch")
        super().__init__(config, CFFMHead, dtype, force)

    def forward(self, imgs: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None,
                cluster_centers=None, mesh: parallel.ClipMesh | None = None) -> torch.Tensor:
        """imgs (B, T, H, W, 3) normalised → refined target logits
        (B, H/4, W/4, K); with ``train`` (the model in ``train()`` mode),
        (B, T+1, H/4, W/4, K) with dropout and stochastic depth drawn from
        ``generator``. ``cluster_centers``: the videos' centres (B, n, C) or a
        ``(centers, mask)`` pair, required in finetune mode.

        ``mesh`` (``parallel.create_clip_mesh``): imgs are this rank's
        ``T / mesh.frames`` frames of its B clips (``shard_clip_batch``). The
        backbone and the per-frame decode run on them, the fused 1/4 features
        are gathered over the frames group, and the rest runs on the whole
        clips on every rank of the group: the output is that of the whole
        clips. Every random draw takes this rank's entries of the global
        batch's draw, and the fuse BN's moments are the world's, so a train
        step on the grid computes the one-process step's (``train/step.py``).
        Every rank of the grid must call it together."""
        if train and not self.training:
            raise ValueError("forward(train=True) needs the model in train() mode")
        b, t, h, w, c = imgs.shape
        frozen = train and self.decode_head.finetune
        with torch.no_grad() if frozen else contextlib.nullcontext():
            feats = self.backbone(imgs.reshape(b * t, h, w, c), train, generator,
                                  mesh.draws(rows=b) if mesh is not None else None)
        return self.decode_head(feats, b, t, train, generator, cluster_centers, mesh)

    def frame_features(self, frames: torch.Tensor) -> torch.Tensor:
        """Per-frame fused 1/4 features (N, H/4, W/4, embed_dim) — the
        cacheable prefix of clip inference (backbone + per-frame decode)."""
        return self.decode_head.decode(self.backbone(frames))

    def predict_from_features(self, fused: torch.Tensor, cluster_centers=None) -> torch.Tensor:
        """Eval logits from cached per-frame features (B, T, h, w, embed_dim)."""
        b, t = fused.shape[:2]
        return self.decode_head.forward_fused(fused.reshape(b * t, *fused.shape[2:]), b, t,
                                              cluster_centers=cluster_centers)

    def prototype_features(self, imgs: torch.Tensor) -> torch.Tensor:
        """Fused 1/8 features of each frame for CFFM++'s phase-A k-means:
        imgs (B, T, H, W, 3) → (B, T, H/8, W/8, embed_dim), in eval form."""
        b, t, h, w, c = imgs.shape
        fused = self.decode_head.fused_features(self.backbone(imgs.reshape(b * t, h, w, c)))
        return fused.reshape(b, t, *fused.shape[1:])


class ImageSegmentor(_EncoderDecoder):
    """Single-frame segmentor (SegFormer): MiT backbone + SegFormer head."""

    def __init__(self, config: SegmentorConfig, dtype: torch.dtype = torch.float32,
                 force: str | None = None):
        if config.arch != "image":
            raise ValueError(f"ImageSegmentor: arch={config.arch!r}, expected 'image'")
        super().__init__(config, SegFormerHead, dtype, force)

    def forward(self, imgs: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """imgs (B, H, W, 3) normalised → logits (B, H/4, W/4, K); with
        ``train`` (the model in ``train()`` mode), dropout and stochastic depth
        drawn from ``generator`` and the fuse BN on batch statistics."""
        if train and not self.training:
            raise ValueError("forward(train=True) needs the model in train() mode")
        return self.decode_head(self.backbone(imgs, train, generator), train, generator)


def build_segmentor(config: SegmentorConfig, dtype: torch.dtype = torch.float32
                    ) -> _EncoderDecoder:
    """The segmentor of ``config.arch``: ``ImageSegmentor`` for "image",
    ``CFFMSegmentor`` for "cffm"."""
    cls = ImageSegmentor if config.arch == "image" else CFFMSegmentor
    return cls(config, dtype)


def target_logits(model: _EncoderDecoder, clip: torch.Tensor, **kwargs) -> torch.Tensor:
    """The eval logits (B, h, w, K) of the target (last) frame of the
    normalised clips (B, T, H, W, 3): an image model sees that frame alone
    (JAX ``eval/evaluator.py:108-115``), a clip model the clip; ``kwargs``
    (CFFM++'s ``cluster_centers``) go to a clip model."""
    if is_image_model(model):
        return model(clip[:, -1])
    return model(clip, **kwargs)


def is_image_model(model: nn.Module) -> bool:
    """Whether ``model``'s config has ``arch="image"`` (a model without a
    config, e.g. a fixed logits function, counts as a clip model, as in the
    JAX evaluator)."""
    return getattr(getattr(model, "config", None), "arch", "cffm") == "image"
