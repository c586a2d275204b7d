"""Clip segmentation losses, channels-last (..., H, W, C) logits.

Port of ``vss_cffm_tpu/models/losses.py`` (mmseg-v0.13 reduction
semantics):

- ``clip_ce_loss``: the clip case table of the reference
  ``BaseDecodeHead_clips_flow.losses`` (``_split_clip_cases``), then
  ``loss_weight·(0.5·CE(per-frame) + CE(refined last))`` on the ×s
  bilinear upsample of the logits, each CE a mean over all pixels with
  ignored pixels adding 0. Without OHEM and class weights: two
  ``ops.ce_upsampled_loss`` calls with the static weights 0.5/p_ori and
  1/p_last, ``acc_seg = 100·corr/p_ori``. With either: the per-pixel route,
  two ``ops.ce_upsampled_nll`` calls (the JAX route concatenates the two
  branches into one call); the gt-class probability is exp(−nll), the OHEM
  mask is drawn per branch with that branch's frame count, nll is weighted
  by ``class_weight[label]``, and ``acc_seg`` is the first-max accuracy of
  the per-frame branch over all its pixels.
- ``clip_lovasz_loss`` (``lovasz_softmax``, plain PyTorch: the JAX package
  has no kernel there either) and ``clip_ce_loss_city`` (only the last frame
  supervised, on the ``ce_upsampled_loss`` pair).
- ``cross_entropy`` (with class and pixel weights and ``avg_factor``),
  ``accuracy`` and ``ohem_weight``: the plain per-pixel versions.

Labels are valid when 0 ≤ label < C, so ``ignore_index`` must lie outside
[0, C). A label outside [0, C) that is not ``ignore_index`` is ignored too,
as everywhere in the port; the JAX per-pixel route, which tests ``label !=
ignore_index``, would count it as a pixel of class 0.

While a ``torch.distributed`` group is up, the OHEM mask (``ohem_weight``
and the per-pixel route) and the Lovász loss are the global batch's: every
rank of the group must compute them together, each on its own rows, as the
train step does (``parallel``'s contract); a rank that calls one alone
waits for the others. ``group`` (None: the world) names the ranks that hold
distinct rows: on a clip mesh with a frames split, the data group, since
the ranks of a frames group hold the same clips after the frames' gather.
"""

from __future__ import annotations

import functools

import torch

from .. import parallel
from ..config import LossConfig
from ..ops import ce_upsampled_loss, ce_upsampled_nll, ce_upsampled_nll_bwd
from ..ops.ce_upsampled import valid_safe
from ..ops.resize import resize_bilinear

__all__ = ["LossConfig", "make_clip_loss", "clip_ce_loss", "clip_ce_loss_city",
           "clip_lovasz_loss", "cross_entropy", "accuracy", "ohem_weight", "lovasz_softmax",
           "ohem_path_errors"]


def _check_ignore(ignore_index: int, c: int) -> None:
    if 0 <= ignore_index < c:
        raise ValueError(f"ignore_index {ignore_index} is a class of {c}: labels are "
                         "ignored by lying outside [0, C)")


def _class_weight(cw, c: int, device: torch.device) -> torch.Tensor | None:
    if cw is None:
        return None
    cw = torch.as_tensor(cw, dtype=torch.float32, device=device)
    if tuple(cw.shape) != (c,):
        raise ValueError(f"class_weight of shape {tuple(cw.shape)} for {c} classes")
    return cw


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, ignore_index: int = 255,
                  class_weight=None, pixel_weight: torch.Tensor | None = None,
                  avg_factor: float | None = None) -> torch.Tensor:
    """Mean CE over all pixels; ignored pixels add 0 but count in the mean.
    ``class_weight`` scales each pixel by its label's weight, ``pixel_weight``
    by its own; ``avg_factor`` replaces the pixel count of the mean."""
    c = logits.shape[-1]
    valid, safe = valid_safe(labels, c)
    lf = logits.float()
    nll = torch.logsumexp(lf, dim=-1) - lf.gather(-1, safe[..., None])[..., 0]
    cw = _class_weight(class_weight, c, logits.device)
    if cw is not None:
        nll = nll * cw[safe]
    nll = torch.where(valid, nll, 0.0)
    if pixel_weight is not None:
        nll = nll * pixel_weight
    if avg_factor is not None:
        return nll.sum() / avg_factor
    return nll.mean()


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Top-1 accuracy in percent over all pixels (ignored pixels count wrong)."""
    return 100.0 * (logits.argmax(dim=-1) == labels).float().mean()


@torch.no_grad()
def _ohem_from_gt_prob(gt_prob: torch.Tensor, valid: torch.Tensor, thresh: float,
                       min_kept: int, n_imgs: int, group=None) -> torch.Tensor:
    """OHEM 0/1 weight map (``OHEMPixelSampler``): keep the valid pixels whose
    gt-class probability is below max(thresh, the k-th smallest valid
    probability), k = min(min_kept·n_imgs, n_valid − 1) clipped to the
    pixels; invalid pixels sort last (+inf). No gradient. Any pixel layout:
    the sort and the threshold are permutation-invariant. Over the N ranks of
    ``group`` (``n_imgs`` each) the sort, ``n_valid`` and k are the global
    batch's: the probabilities of every rank are gathered
    (``parallel.all_gather_cat``), so every rank must call it together."""
    p = torch.where(valid, gt_prob.float(), torch.inf)
    world = parallel.group_size(group)
    flat = torch.sort(parallel.all_gather_cat(p.reshape(-1), group)).values
    n_valid = parallel.all_reduce_sum(valid.sum(), group)
    k = torch.clamp(torch.clamp(n_valid - 1, max=min_kept * n_imgs * world), 0,
                    flat.numel() - 1)
    kth = torch.where(n_valid > 0, flat[k], 0.0)
    eff = torch.clamp(kth, min=thresh)
    return (valid & (p < eff)).float()


def ohem_weight(logits: torch.Tensor, labels: torch.Tensor, ignore_index: int = 255,
                thresh: float = 0.7, min_kept: int = 100000) -> torch.Tensor:
    """OHEM pixel weights from logits (..., H, W, C) and labels (..., H, W);
    the image count is the leading dimension of 3-d labels. In a process
    group every rank must call it together (the threshold is the global
    batch's)."""
    _check_ignore(ignore_index, logits.shape[-1])
    valid, safe = valid_safe(labels, logits.shape[-1])
    with torch.no_grad():
        prob = torch.softmax(logits.float(), dim=-1)
        gt_prob = prob.gather(-1, safe[..., None])[..., 0]
    n_imgs = labels.shape[0] if labels.dim() > 2 else 1
    return _ohem_from_gt_prob(gt_prob, valid, thresh, min_kept, n_imgs)


def lovasz_softmax(logits: torch.Tensor, labels: torch.Tensor, ignore_index: int = 255,
                   classes: str = "present") -> torch.Tensor:
    """Multi-class Lovász-Softmax loss (reference ``lovasz_loss.py:225``), as
    the JAX package writes it: ignored pixels get error −1 and sort last, the
    Lovász gradient comes from cumulative sums over the errors sorted in
    descending order (a stable sort, so ties keep the JAX order), and the
    mean is over the classes present in the labels (``classes="present"``)."""
    c = logits.shape[-1]
    _check_ignore(ignore_index, c)
    probs = torch.softmax(logits.float(), dim=-1).reshape(-1, c)            # (P, C)
    valid, safe = valid_safe(labels.reshape(-1), c)
    fg = ((safe[:, None] == torch.arange(c, device=logits.device)) & valid[:, None]).float()
    errors = torch.where(valid[:, None], (fg - probs).abs(), -1.0)
    order = torch.sort(-errors, dim=0, stable=True).indices
    errors_sorted = errors.gather(0, order)
    fg_sorted = fg.gather(0, order)
    valid_sorted = (errors_sorted >= 0.0).float()
    gts = fg_sorted.sum(dim=0)
    inter = gts - fg_sorted.cumsum(dim=0)
    union = gts + ((1.0 - fg_sorted) * valid_sorted).cumsum(dim=0)
    jaccard = 1.0 - inter / union.clamp(min=1e-12)
    grad = torch.cat([jaccard[:1], jaccard[1:] - jaccard[:-1]], dim=0)
    losses = (errors_sorted.clamp(min=0.0) * grad * valid_sorted).sum(dim=0)
    if classes == "present":
        present = gts > 0
        return torch.where(present, losses, 0.0).sum() / present.sum().clamp(min=1)
    return losses.mean()


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


def _pixel_nll(logits: torch.Tensor, labels: torch.Tensor, s: int, use_ohem: bool,
               ohem_cfg: dict, cw: torch.Tensor | None, force: str | None, group=None):
    """One branch of the per-pixel route: (mean of the weighted nll over all
    pixels, first-max prediction)."""
    nll, pred, _ = ce_upsampled_nll(logits, labels, s, force=force)
    valid, safe = valid_safe(labels, logits.shape[-1])
    if use_ohem:
        nll = nll * _ohem_from_gt_prob(torch.exp(-nll.detach()), valid,
                                       ohem_cfg.get("thresh", 0.7),
                                       ohem_cfg.get("min_kept", 100000), logits.shape[0],
                                       group)
    if cw is not None:
        nll = nll * cw[safe]
    return torch.where(valid, nll, 0.0).mean(), pred


@torch.no_grad()
def ohem_path_errors(logits: torch.Tensor, labels: torch.Tensor, s: int, thresh: float = 0.7,
                     min_kept: int = 100000, class_weight: torch.Tensor | None = None) -> dict:
    """One branch of the per-pixel route with OHEM (``_pixel_nll``), its
    kernels (rows 12, 13) against the plain versions on the card, for a check
    with a mask that bites: nll from each route, the sort and the k-th
    threshold, the weighted mean; then the backward of that mean, on both
    routes, for the plain route's weights (the same g for both, so that a
    pixel whose probability sits within an nll rounding of the threshold
    cannot move the dlogits). Returns the kept shares of the valid pixels,
    the valid pixels whose kept flag differs, the two losses and the two
    dlogits."""
    valid, safe = valid_safe(labels, logits.shape[-1])
    n_valid = int(valid.sum())
    cw = 1.0 if class_weight is None else class_weight[safe]
    runs = {}
    for force in ("kernel", "torch"):
        nll, _, lse = ce_upsampled_nll(logits, labels, s, force=force)
        keep = _ohem_from_gt_prob(torch.exp(-nll), valid, thresh, min_kept, logits.shape[0])
        loss = torch.where(valid, nll * keep * cw, 0.0).mean()
        runs[force] = (keep, loss, lse)
    (keep_k, loss_k, lse_k), (keep_p, loss_p, lse_p) = runs["kernel"], runs["torch"]
    g = torch.where(valid, keep_p * cw, 0.0) / labels.numel()
    return {"kept": keep_k[valid].sum().item() / max(n_valid, 1),
            "kept_plain": keep_p[valid].sum().item() / max(n_valid, 1),
            "flag_differs": int((keep_k != keep_p)[valid].sum()), "valid": n_valid,
            "loss": (loss_k.item(), loss_p.item()),
            "dlogits": (ce_upsampled_nll_bwd(logits, labels, lse_k, g, s, force="kernel"),
                        ce_upsampled_nll_bwd(logits, labels, lse_p, g, s, force="torch"))}


def clip_ce_loss(seg_logits: torch.Tensor, seg_labels: torch.Tensor, ignore_index: int = 255,
                 use_ohem: bool = False, ohem_cfg: dict | None = None, class_weight=None,
                 loss_weight: float = 1.0, force: str | None = None,
                 group=None) -> dict[str, torch.Tensor]:
    """seg_logits (B, T', h, w, C), seg_labels (B, T, H, W) with H = s·h →
    {"loss_seg", "acc_seg"}, this rank's; OHEM's threshold is that of the
    ranks of ``group``."""
    c = seg_logits.shape[-1]
    _check_ignore(ignore_index, c)
    logit_ori, logit_last, label_ori, label_last = _split_clip_cases(seg_logits, seg_labels)
    s = label_ori.shape[1] // logit_ori.shape[1]
    cw = _class_weight(class_weight, c, seg_logits.device)
    if use_ohem or cw is not None:
        cfg = ohem_cfg or {}
        mean_o, pred = _pixel_nll(logit_ori, label_ori, s, use_ohem, cfg, cw, force, group)
        mean_l, _ = _pixel_nll(logit_last, label_last, s, use_ohem, cfg, cw, force, group)
        acc = 100.0 * (pred == label_ori).float().mean()
        return {"loss_seg": loss_weight * (0.5 * mean_o + mean_l), "acc_seg": acc}
    p_ori, p_last = float(label_ori.numel()), float(label_last.numel())
    wsum_o, corr = ce_upsampled_loss(logit_ori, label_ori, s, 0.5 / p_ori, force=force)
    wsum_l, _ = ce_upsampled_loss(logit_last, label_last, s, 1.0 / p_last, count_acc=False,
                                  force=force)
    return {"loss_seg": loss_weight * (wsum_o + wsum_l), "acc_seg": 100.0 * corr / p_ori}


def clip_lovasz_loss(seg_logits: torch.Tensor, seg_labels: torch.Tensor,
                     ignore_index: int = 255, loss_weight: float = 1.0,
                     force: str | None = None, group=None) -> dict[str, torch.Tensor]:
    """The clip case table with ``LovaszLoss`` (multi-class, per_image=False)
    on the upsampled logits. No kernel: ``force`` is taken and unused.

    Its sort is over the whole batch: over the ranks of ``group`` (None: the
    world) each rank's logits, at their own resolution (before the resize),
    and labels are gathered in rank order (``parallel.gather_cat``, whose
    backward hands each rank its slice of the summed gradient), and every
    rank computes the global batch's loss and accuracy. A rank then holds
    the upsampled logits, the sort and its gradient of the global batch: its
    memory is that of one process at the global batch."""
    seg_logits = parallel.gather_cat(seg_logits, 0, group)
    seg_labels = parallel.all_gather_cat(seg_labels, group)
    logit_ori, logit_last, label_ori, label_last = _split_clip_cases(seg_logits, seg_labels)
    size = tuple(seg_labels.shape[2:4])
    logit_ori = resize_bilinear(logit_ori, size)
    logit_last = resize_bilinear(logit_last, size)
    loss = (0.5 * lovasz_softmax(logit_ori, label_ori, ignore_index)
            + lovasz_softmax(logit_last, label_last, ignore_index))
    return {"loss_seg": loss_weight * loss, "acc_seg": accuracy(logit_ori, label_ori)}


def clip_ce_loss_city(seg_logits: torch.Tensor, seg_labels: torch.Tensor,
                      ignore_index: int = 255, force: str | None = None
                      ) -> dict[str, torch.Tensor]:
    """``BaseDecodeHead_clips_flow_city.losses``: seg_logits (B, T+1, h, w, C),
    seg_labels (B, T, H, W); only the last frame is supervised, 0.5·CE(last
    per-frame logits) + CE(refined logits) against the last label, as two
    ``ce_upsampled_loss`` calls."""
    if seg_logits.shape[1] != seg_labels.shape[1] + 1:
        raise ValueError(f"clip_ce_loss_city: logits of {seg_logits.shape[1]} frames for "
                         f"{seg_labels.shape[1]} labels (expected T+1)")
    _check_ignore(ignore_index, seg_logits.shape[-1])
    label = seg_labels[:, -1]
    s = label.shape[1] // seg_logits.shape[2]
    p = float(label.numel())
    wsum_o, corr = ce_upsampled_loss(seg_logits[:, -2], label, s, 0.5 / p, force=force)
    wsum_l, _ = ce_upsampled_loss(seg_logits[:, -1], label, s, 1.0 / p, count_acc=False,
                                  force=force)
    return {"loss_seg": wsum_o + wsum_l, "acc_seg": 100.0 * corr / p}


def make_clip_loss(cfg: LossConfig, ignore_index: int = 255):
    """LossConfig → ``(seg_logits, seg_labels, force=None) -> {loss_seg, acc_seg}``."""
    if cfg.type == "lovasz":
        return functools.partial(clip_lovasz_loss, ignore_index=ignore_index,
                                 loss_weight=cfg.loss_weight)
    if cfg.type != "ce":
        raise ValueError(f"unknown loss type {cfg.type!r}")
    return functools.partial(clip_ce_loss, ignore_index=ignore_index, use_ohem=cfg.use_ohem,
                             ohem_cfg={"thresh": cfg.ohem_thresh,
                                       "min_kept": cfg.ohem_min_kept},
                             class_weight=cfg.class_weight, loss_weight=cfg.loss_weight)
