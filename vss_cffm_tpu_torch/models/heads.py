"""The decode heads, channels-last: SegFormer's single-frame head and the
CFFM clip head.

Both start with the per-frame SegFormer MLP decode of ``MLPDecodeHead`` (4
levels projected, upsampled to 1/4, fused by a 1×1 conv + BN + ReLU) and its
``linear_pred``. ``SegFormerHead`` (port of
``vss_cffm_tpu/models/heads.py:SegFormerHead``, reference
``segformer_head.py``) ends there: Dropout2d, then ``linear_pred``.
``CFFMHead`` (``vss_cffm_tpu/models/heads.py:CFFMHead``) adds the CFFM focal
decoder over the clip at 1/8 and ``linear_pred2`` on [target features,
refined target features], resized back to 1/4. Parameter names follow the
reference (``linear_c4.proj.weight``, ``linear_fuse.conv.weight`` (f, 4f, 1,
1), ``linear_fuse.bn.running_mean``, ``linear_pred.weight``,
``decoder_focal.blocks.0...``).

The per-frame decode uses the merged form of the JAX package: the level
embedding and its slice of the 1×1 fuse conv are both linear and commute
with the bilinear resize, so each level is one matmul at its own resolution
and the (B·T, h, w, 4f) concat never exists.

In training (``forward(..., train=True, generator=g)``) the fuse BatchNorm
normalises with the f32 batch statistics of the merged sum, over the global
batch when several ranks train (``batch_moments``), and updates its
running statistics the flax way, and Dropout2d (whole channels per sample)
precedes ``linear_pred`` and ``linear_pred2``. The CFFM head then returns
(B, T+1, h, w, classes): the per-frame logits of all T frames and the
refined last frame; the SegFormer head returns every frame's logits.

In ``finetune`` mode (CFFM++, ``CFFMHeadConfig.mode``, the JAX head's
``:200-277``) the head adds the cluster branch: ``decoder_swin`` (a
``ClusterDecoder`` over the refined-input target features at 1/8 and the
video's cluster centres), ``dropout3`` and ``linear_pred3``. Only that
branch trains: the fused features are detached, the fuse BN normalises with
its running statistics and does not update them, and the per-frame logits
are computed without autograd. The focal decoder and ``linear_pred2`` do
not run in finetune training (their output x2 is not in the training output
``[x, x3]``; the JAX step's XLA drops that work too). In eval the output is
``x2 + cluster_blend · x3``.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import parallel
from ..config import CFFMHeadConfig
from ..ops import resize_bilinear
from .cffm_transformer import CFFMDecoder
from .cluster_head import ClusterDecoder
from .mit import derived, keep_mask

__all__ = ["MLPDecodeHead", "SegFormerHead", "CFFMHead", "dropout2d", "batch_moments"]

BN_MOMENTUM = 0.9  # flax BatchNorm: running = 0.9·running + 0.1·batch


def dropout2d(x: torch.Tensor, rate: float, generator: torch.Generator | None,
              shard: parallel.DrawShard | None = None) -> torch.Tensor:
    """torch ``Dropout2d`` on channels-last x (N, h, w, C): each (sample,
    channel) is zeroed with probability ``rate``, the rest divided by the
    keep probability; ``shard`` as in ``keep_mask``."""
    if rate == 0.0:
        return x
    n, c = x.shape[0], x.shape[-1]
    keep = keep_mask(n * c, rate, generator, x.device, shard).reshape(n, 1, 1, c)
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def batch_moments(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The per-channel mean and biased variance of a (N, h, w, C) f32 over the
    global batch (the JAX package's SyncBN): without a process group over
    ``a``; in a group from two differentiable sum all-reduces, [Σx, count]
    and then Σ(x − mean)², whose backward is the global-batch BN's. In a
    group every rank must call it together (a train-mode forward on one
    rank alone waits for the others)."""
    if not parallel.is_distributed():
        mean = a.mean(dim=(0, 1, 2))
        return mean, (a - mean).square().mean(dim=(0, 1, 2))
    count = a.new_full((1,), a.shape[0] * a.shape[1] * a.shape[2])
    sums = parallel.all_reduce_sum(torch.cat([a.sum(dim=(0, 1, 2)), count]))
    mean = sums[:-1] / sums[-1]
    var = parallel.all_reduce_sum((a - mean).square().sum(dim=(0, 1, 2))) / sums[-1]
    return mean, var


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


class MLPDecodeHead(nn.Module):
    """The per-frame SegFormer MLP decode and ``linear_pred``, shared by both
    heads (JAX ``_PerFrameDecoder`` and the heads' ``linear_pred``)."""

    def __init__(self, cfg: CFFMHeadConfig):
        super().__init__()
        self.cfg = cfg
        f = cfg.embed_dim
        for i, c in enumerate(cfg.in_channels):
            setattr(self, f"linear_c{i + 1}", _MLPEmbed(c, f))
        self.linear_fuse = _ConvBN(4 * f, f)
        self.linear_pred = nn.Conv2d(f, cfg.num_classes, 1)
        self.compute_dtype = torch.float32

    def decode(self, feats: list[torch.Tensor], train: bool = False) -> torch.Tensor:
        """Per-frame fused 1/4 features (N, h, w, f) from the 4 backbone maps;
        ``train`` normalises with batch statistics and updates the running
        ones."""
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
        a = acc.float()
        if train:
            mean, var = batch_moments(a)
            with torch.no_grad():
                # flax's rule with the biased batch variance, where
                # nn.BatchNorm2d would use the unbiased one
                bn.running_mean.mul_(BN_MOMENTUM).add_(mean, alpha=1.0 - BN_MOMENTUM)
                bn.running_var.mul_(BN_MOMENTUM).add_(var, alpha=1.0 - BN_MOMENTUM)
        else:
            mean, var = bn.running_mean, bn.running_var
        z = (a - mean) * torch.rsqrt(var + bn.eps) * bn.weight + bn.bias
        return torch.relu(z).to(dt)

    def frame_logits(self, _c: torch.Tensor, rate: float, generator: torch.Generator | None,
                     shard: parallel.DrawShard | None = None) -> torch.Tensor:
        """``linear_pred`` of the fused features (N, h, w, f) after Dropout2d
        at ``rate``: (N, h, w, classes)."""
        return _conv1x1(dropout2d(_c, rate, generator, shard), self.linear_pred,
                        self.compute_dtype)


class SegFormerHead(MLPDecodeHead):
    """Single-frame SegFormer head: the decode, Dropout2d, ``linear_pred``.
    No ``linear_pred2``, focal decoder or cluster branch."""

    def forward(self, feats: list[torch.Tensor], train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """Logits (N, h, w, classes) of the N frames' 4 backbone maps; with
        ``train``, BN batch statistics and dropout from ``generator``."""
        rate = self.cfg.dropout_ratio if train else 0.0
        return self.frame_logits(self.decode(feats, train), rate, generator)


class CFFMHead(MLPDecodeHead):
    def __init__(self, cfg: CFFMHeadConfig):
        super().__init__(cfg)
        f = cfg.embed_dim
        self.decoder_focal = CFFMDecoder(cfg.decoder)
        self.linear_pred2 = nn.Conv2d(2 * f, cfg.num_classes, 1)
        self.finetune = cfg.mode == "finetune"
        if self.finetune:
            self.decoder_swin = ClusterDecoder(f, cfg.decoder.num_heads)
            self.linear_pred3 = nn.Conv2d(f, cfg.num_classes, 1)

    def forward_fused(self, _c: torch.Tensor, batch_size: int, num_clips: int,
                      train: bool = False, generator: torch.Generator | None = None,
                      cluster_centers=None, shard: parallel.DrawShard | None = None
                      ) -> torch.Tensor:
        """Logits from per-frame fused features (B·T, h, w, f). Eval: the
        refined target-frame logits (B, h, w, classes), or, when the clip
        length is not ``num_clips``, the plain per-frame logits of the last
        frame. Train: (B, T+1, h, w, classes), every frame's plain logits and
        the refined last frame (in finetune mode the cluster branch's).
        ``cluster_centers`` (B, K, f), or a ``(centers, mask)`` pair, is
        required in finetune mode; ``shard``: where these B clips sit in the
        global batch's random draws (``keep_mask``)."""
        cfg = self.cfg
        dt = self.compute_dtype
        rate = cfg.dropout_ratio if train else 0.0
        h, w = _c.shape[1:3]
        frozen = self.finetune and train
        if self.finetune:
            _c = _c.detach()
        if train or num_clips != cfg.num_clips:
            with torch.no_grad() if frozen else contextlib.nullcontext():
                x = self.frame_logits(_c, rate, generator, shard)
            x = x.reshape(batch_size, num_clips, h, w, cfg.num_classes)
            if not train:
                return x[:, -1]
        _c8 = resize_bilinear(_c.to(dt), (h // 2, w // 2))
        _c_further = _c8.reshape(batch_size, num_clips, h // 2, w // 2, cfg.embed_dim)
        if not frozen:
            _c2 = self.decoder_focal(_c_further, train, generator, shard)
            fused_last = torch.cat([_c_further[:, -1], _c2[:, -1]], dim=-1)
            x2 = _conv1x1(dropout2d(fused_last, rate, generator, shard), self.linear_pred2, dt)
            x2 = resize_bilinear(x2, (h, w))
            if not self.finetune:
                return x2 if not train else torch.cat([x, x2[:, None]], dim=1)
        # ---- CFFM++: the cluster cross-attention branch
        if cluster_centers is None:
            raise ValueError("CFFMHead in finetune mode needs the video's cluster centres")
        _c3 = self.decoder_swin(_c_further[:, -1], cluster_centers)
        x3 = _conv1x1(dropout2d(_c3, rate, generator, shard), self.linear_pred3, dt)
        x3 = resize_bilinear(x3, (h, w))
        if not train:
            return x2 + cfg.cluster_blend * x3
        return torch.cat([x, x3[:, None]], dim=1)

    def forward(self, feats: list[torch.Tensor], batch_size: int, num_clips: int,
                train: bool = False, generator: torch.Generator | None = None,
                cluster_centers=None, mesh: parallel.ClipMesh | None = None) -> torch.Tensor:
        """``feats`` of ``batch_size`` clips of ``num_clips`` frames each; on a
        ``mesh`` with a frames split, this rank's frames of its clips: the
        fused features are gathered over the frames group into whole clips
        before ``forward_fused``, which every rank of the group runs alike."""
        # finetune mode: the fuse BN on its running statistics, not updated,
        # and no gradient to the decode
        with torch.no_grad() if train and self.finetune else contextlib.nullcontext():
            _c = self.decode(feats, train and not self.finetune)
        shard = None
        if mesh is not None:
            _c = mesh.gather_frames(_c, batch_size)
            num_clips *= mesh.frames
            shard = mesh.draws()
        return self.forward_fused(_c, batch_size, num_clips, train, generator, cluster_centers,
                                  shard)

    def fused_features(self, feats: list[torch.Tensor]) -> torch.Tensor:
        """Fused features at 1/8 (N, h/8, w/8, f) for CFFM++'s prototypes: the
        per-frame decode (eval BN), resized to half its size (reference
        ``cffm_head.py:267-284``)."""
        _c = self.decode(feats, False)
        h, w = _c.shape[1:3]
        return resize_bilinear(_c, (h // 2, w // 2))
