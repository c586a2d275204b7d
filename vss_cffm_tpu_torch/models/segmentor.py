"""CFFM clip segmentor: MiT backbone + CFFM clip head.

Port of ``vss_cffm_tpu/models/segmentor.py:CFFMSegmentor`` for inference.
The (B, T) clip is flattened into a (B·T) frame batch through the backbone
and the per-frame decode, and the CFFM head refines the last frame.

``CFFMSegmentor(config, dtype, force)``: parameters are f32; ``dtype`` is
the compute dtype of every module; ``force`` is handed to every op with a
kernel (see ``set_force``). ``init_weights(generator)`` draws random
weights with the reference's initialisers from an explicit generator.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from ..config import SegmentorConfig
from .cffm_transformer import CFFMWindowAttention, _PoolLinear
from .heads import CFFMHead
from .mit import MiT

__all__ = ["CFFMSegmentor", "set_force", "set_compute_dtype"]


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


class CFFMSegmentor(nn.Module):
    def __init__(self, config: SegmentorConfig, dtype: torch.dtype = torch.float32,
                 force: str | None = None):
        super().__init__()
        self.config = config
        self.backbone = MiT(config.backbone_config)
        self.decode_head = CFFMHead(config.head)
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
                if name.endswith(("linear_pred", "linear_pred2")):
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

    def forward(self, imgs: torch.Tensor) -> torch.Tensor:
        """imgs (B, T, H, W, 3) normalised → refined target logits (B, H/4, W/4, K)."""
        b, t, h, w, c = imgs.shape
        feats = self.backbone(imgs.reshape(b * t, h, w, c))
        return self.decode_head(feats, b, t)

    def frame_features(self, frames: torch.Tensor) -> torch.Tensor:
        """Per-frame fused 1/4 features (N, H/4, W/4, embed_dim) — the
        cacheable prefix of clip inference (backbone + per-frame decode)."""
        return self.decode_head.decode(self.backbone(frames))

    def predict_from_features(self, fused: torch.Tensor) -> torch.Tensor:
        """Eval logits from cached per-frame features (B, T, h, w, embed_dim)."""
        b, t = fused.shape[:2]
        return self.decode_head.forward_fused(fused.reshape(b * t, *fused.shape[2:]), b, t)
