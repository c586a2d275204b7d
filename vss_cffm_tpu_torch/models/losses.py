"""Clip segmentation losses, channels-last (..., H, W, C) logits.

Port of ``vss_cffm_tpu/models/losses.py`` for the CE route the train step
runs (mmseg-v0.13 reduction semantics):

- ``clip_ce_loss``: the clip case table of the reference
  ``BaseDecodeHead_clips_flow.losses`` (``_split_clip_cases``), then
  ``loss_weight·(0.5·CE(per-frame) + CE(refined last))`` on the ×s
  bilinear upsample of the logits, each CE a mean over all pixels with
  ignored pixels adding 0, as two ``ops.ce_upsampled_loss`` calls with the
  static weights 0.5/p_ori and 1/p_last; ``acc_seg = 100·corr/p_ori``.
- ``cross_entropy`` and ``accuracy``: the plain per-pixel versions.

Labels are valid when 0 ≤ label < C, so ``ignore_index`` must lie outside
[0, C). OHEM, class weights, Lovász and the city loss raise
``NotImplementedError`` (ROADMAP Queue A item 10, Queue B item 12).
"""

from __future__ import annotations

import functools

import torch

from ..config import LossConfig
from ..ops import ce_upsampled_loss

__all__ = ["LossConfig", "make_clip_loss", "clip_ce_loss", "cross_entropy", "accuracy"]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_index: int = 255) -> torch.Tensor:
    """Mean CE over all pixels; ignored pixels add 0 but count in the mean."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0).long()
    lf = logits.float()
    nll = torch.logsumexp(lf, dim=-1) - lf.gather(-1, safe[..., None])[..., 0]
    return torch.where(valid, nll, 0.0).mean()


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Top-1 accuracy in percent over all pixels (ignored pixels count wrong)."""
    return 100.0 * (logits.argmax(dim=-1) == labels).float().mean()


def _flatten_frames(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, *x.shape[2:])


def _split_clip_cases(seg_logits: torch.Tensor, seg_labels: torch.Tensor):
    """The T' ∈ {T+1, T+3, 2T, 2T+1} case table → (logit_ori, logit_last,
    label_ori, label_last), frame-flattened."""
    tp, tl = seg_logits.shape[1], seg_labels.shape[1]
    if tp == tl + 1:
        logit_ori, logit_last = seg_logits[:, :-1], seg_logits[:, -1:]
        label_ori, label_last = seg_labels, seg_labels[:, -1:]
    elif tp == tl + 3:
        logit_ori, logit_last = seg_logits[:, :-3], seg_logits[:, -3:]
        label_ori = seg_labels
        label_last = torch.cat([seg_labels[:, -1:]] * 3, dim=1)
    elif tp == 2 * tl:
        logit_ori, logit_last = seg_logits[:, :-1], seg_logits[:, -1:]
        label_ori = torch.cat([seg_labels, seg_labels], dim=1)[:, :-1]
        label_last = seg_labels[:, -1:]
    elif tp == 2 * tl + 1:
        logit_ori, logit_last = seg_logits[:, :-2], seg_logits[:, -2:]
        label_ori = torch.cat([seg_labels, seg_labels], dim=1)[:, :-1]
        label_last = torch.cat([seg_labels[:, -1:]] * 2, dim=1)
    else:
        raise ValueError(f"unsupported logits/labels clip lengths {tp}/{tl}")
    return (_flatten_frames(logit_ori), _flatten_frames(logit_last),
            _flatten_frames(label_ori), _flatten_frames(label_last))


def clip_ce_loss(seg_logits: torch.Tensor, seg_labels: torch.Tensor, ignore_index: int = 255,
                 loss_weight: float = 1.0, force: str | None = None) -> dict[str, torch.Tensor]:
    """seg_logits (B, T', h, w, C), seg_labels (B, T, H, W) with H = s·h →
    {"loss_seg", "acc_seg"}."""
    c = seg_logits.shape[-1]
    if 0 <= ignore_index < c:
        raise ValueError(f"ignore_index {ignore_index} is a class of {c}: labels are "
                         "ignored by lying outside [0, C)")
    logit_ori, logit_last, label_ori, label_last = _split_clip_cases(seg_logits, seg_labels)
    s = label_ori.shape[1] // logit_ori.shape[1]
    p_ori, p_last = float(label_ori.numel()), float(label_last.numel())
    wsum_o, corr = ce_upsampled_loss(logit_ori, label_ori, s, 0.5 / p_ori, force=force)
    wsum_l, _ = ce_upsampled_loss(logit_last, label_last, s, 1.0 / p_last, count_acc=False,
                                  force=force)
    return {"loss_seg": loss_weight * (wsum_o + wsum_l), "acc_seg": 100.0 * corr / p_ori}


def make_clip_loss(cfg: LossConfig, ignore_index: int = 255):
    """LossConfig → ``(seg_logits, seg_labels, force=None) -> {loss_seg, acc_seg}``."""
    if cfg.type == "lovasz":
        raise NotImplementedError("the Lovász clip loss is not ported yet "
                                  "(ROADMAP Queue A item 10)")
    if cfg.type != "ce":
        raise ValueError(f"unknown loss type {cfg.type!r}")
    if cfg.use_ohem or cfg.class_weight is not None:
        raise NotImplementedError("OHEM and class weights need the per-pixel CE kernels "
                                  "(ROADMAP Queue B item 12, Queue A item 10)")
    return functools.partial(clip_ce_loss, ignore_index=ignore_index,
                             loss_weight=cfg.loss_weight)
