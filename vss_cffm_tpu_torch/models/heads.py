"""CFFM clip head at inference (``cffm`` mode), channels-last.

Port of ``vss_cffm_tpu/models/heads.py:CFFMHead``: per-frame SegFormer MLP
decode (4 levels projected, upsampled to 1/4, fused by a 1×1 conv + BN in
eval mode + ReLU), then the CFFM focal decoder over the clip at 1/8 and
``linear_pred2`` on [target features, refined target features], resized back
to 1/4. Parameter names follow the reference (``linear_c4.proj.weight``,
``linear_fuse.conv.weight`` (f, 4f, 1, 1), ``linear_fuse.bn.running_mean``,
``decoder_focal.blocks.0...``).

The per-frame decode uses the merged form of the JAX package: the level
embedding and its slice of the 1×1 fuse conv are both linear and commute
with the bilinear resize, so each level is one matmul at its own resolution
and the (B·T, h, w, 4f) concat never exists.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import CFFMHeadConfig
from ..ops import resize_bilinear
from .cffm_transformer import CFFMDecoder
from .mit import derived

__all__ = ["CFFMHead"]


class _MLPEmbed(nn.Module):
    def __init__(self, in_ch: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Linear(in_ch, embed_dim)


class _ConvBN(nn.Module):
    """1×1 conv (no bias) + BatchNorm: the reference ``linear_fuse`` ConvModule."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, 1, bias=False)
        self.bn = nn.BatchNorm2d(out_ch)


def _conv1x1(x: torch.Tensor, conv: nn.Conv2d, dt: torch.dtype) -> torch.Tensor:
    w, b = derived(conv, ("1x1", dt), (conv.weight, conv.bias), lambda: (
        conv.weight.reshape(conv.out_channels, conv.in_channels).to(dt), conv.bias.to(dt)))
    return F.linear(x.to(dt), w, b)


class CFFMHead(nn.Module):
    def __init__(self, cfg: CFFMHeadConfig):
        super().__init__()
        self.cfg = cfg
        f = cfg.embed_dim
        for i, c in enumerate(cfg.in_channels):
            setattr(self, f"linear_c{i + 1}", _MLPEmbed(c, f))
        self.linear_fuse = _ConvBN(4 * f, f)
        self.linear_pred = nn.Conv2d(f, cfg.num_classes, 1)
        self.decoder_focal = CFFMDecoder(cfg.decoder)
        self.linear_pred2 = nn.Conv2d(2 * f, cfg.num_classes, 1)
        self.compute_dtype = torch.float32

    def decode(self, feats: list[torch.Tensor]) -> torch.Tensor:
        """Per-frame fused 1/4 features (N, h, w, f) from the 4 backbone maps."""
        dt = self.compute_dtype
        f = self.cfg.embed_dim
        c1 = feats[0]
        size = tuple(c1.shape[1:3])
        fuse_w = self.linear_fuse.conv.weight
        acc = None
        for i, lvl in enumerate((4, 3, 2, 1)):
            proj = getattr(self, f"linear_c{lvl}").proj

            def merge(i=i, proj=proj):
                # fuse kernel rows ordered [c4, c3, c2, c1] (the reference concat order)
                post = fuse_w[:, :, 0, 0].t().to(dt)[i * f:(i + 1) * f]
                return proj.weight.t().to(dt) @ post, proj.bias.to(dt) @ post

            w, b = derived(self, ("merged", lvl, dt), (fuse_w, proj.weight, proj.bias), merge)
            y = feats[lvl - 1].to(dt) @ w + b
            if tuple(y.shape[1:3]) != size:
                y = resize_bilinear(y, size)
            acc = y if acc is None else acc + y
        bn = self.linear_fuse.bn
        z = ((acc.float() - bn.running_mean) * torch.rsqrt(bn.running_var + bn.eps)
             * bn.weight + bn.bias)
        return torch.relu(z).to(dt)

    def forward_fused(self, _c: torch.Tensor, batch_size: int, num_clips: int) -> torch.Tensor:
        """Eval logits from per-frame fused features (B·T, h, w, f): the refined
        target-frame logits (B, h, w, classes), or, when the clip length is not
        ``num_clips``, the plain per-frame logits of the last frame."""
        cfg = self.cfg
        dt = self.compute_dtype
        h, w = _c.shape[1:3]
        if num_clips != cfg.num_clips:
            x = _conv1x1(_c, self.linear_pred, dt)
            return x.reshape(batch_size, num_clips, h, w, cfg.num_classes)[:, -1]
        _c8 = resize_bilinear(_c.to(dt), (h // 2, w // 2))
        _c_further = _c8.reshape(batch_size, num_clips, h // 2, w // 2, cfg.embed_dim)
        _c2 = self.decoder_focal(_c_further)
        fused_last = torch.cat([_c_further[:, -1], _c2[:, -1]], dim=-1)
        x2 = _conv1x1(fused_last, self.linear_pred2, dt)
        return resize_bilinear(x2, (h, w))

    def forward(self, feats: list[torch.Tensor], batch_size: int,
                num_clips: int) -> torch.Tensor:
        return self.forward_fused(self.decode(feats), batch_size, num_clips)
