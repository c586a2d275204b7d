"""Evaluation metrics: confusion matrix, mIoU / mAcc / aAcc, seen-mIoU,
FWIoU, and video consistency (VC).

The port's copy of ``vss_cffm_tpu/eval/metrics.py`` (reference
``mmseg/core/evaluation/metrics.py`` and ``VC_perclip.py``):

- ``update_confusion`` adds a frame's (gt, pred) pairs into a (C, C) int64
  matrix on the prediction's device with one ``index_add_`` (a
  ``torch.bincount`` on the card would wait for the device to size its
  output); labels outside [0, C) go to a dropped bin. Torch has int64 on
  the device, so the JAX package's int32 accumulator and its host fold are
  not needed: a VSPW val pass (~1e10 pixels) fits.
- ``eval_metrics`` (``metrics.py:300-351``): aAcc, per-class Acc and IoU,
  nan for absent classes; ``mean_iou_seen`` (``:25-31``) averages over the
  classes present in the ground truth; ``fwiou`` (``:33-40``).
- ``video_consistency``: VC_n (``VC_perclip.py:64-80``), for every run of n
  consecutive frames the share of the pixels whose ground truth is static
  over the run whose prediction is static too.
- ``aggregate_confusion``: the matrix summed over the ranks of a
  ``torch.distributed`` group with one int64 all-reduce (the JAX package
  gathers an int32 digit split, ``_split_int64`` / ``_merge_int64``, kept
  here with its parity tests, as JAX's default integers are 32-bit).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import parallel

__all__ = [
    "update_confusion",
    "confusion_matrix_np",
    "aggregate_confusion",
    "eval_metrics",
    "format_class_table",
    "mean_iou_seen",
    "fwiou",
    "video_consistency",
]


def _split_int64(cm: np.ndarray) -> np.ndarray:
    """(C, C) int64 → (2, C, C) int32 [hi, lo] base-2³¹ digits (non-negative
    counts < 2⁶²), so that a gather across processes can move int32."""
    cm = np.asarray(cm, np.int64)
    return np.stack([(cm >> 31).astype(np.int32), (cm & ((1 << 31) - 1)).astype(np.int32)])


def _merge_int64(parts: np.ndarray) -> np.ndarray:
    """(..., 2, C, C) int32 → summed (C, C) int64 over all leading axes."""
    parts = np.asarray(parts, np.int64)
    hi, lo = parts[..., 0, :, :], parts[..., 1, :, :]
    total = (hi << 31) + lo
    return total.reshape((-1,) + total.shape[-2:]).sum(0)


def aggregate_confusion(cm: np.ndarray, group=None) -> np.ndarray:
    """The (C, C) confusion summed over the ranks of ``group`` (None: the
    world), int64 and exact (one sum all-reduce of int64 counts); the
    identity without a process group. On a clip mesh with a frames split the
    ranks of a frames group predict the same target frames: sum over the
    data group (``ClipMesh.data_group``), so that each row counts once."""
    cm = np.asarray(cm, np.int64)
    if not parallel.is_distributed():
        return cm
    t = torch.from_numpy(cm.copy()).to(parallel.collective_device())
    torch.distributed.all_reduce(t, group=group)
    return t.cpu().numpy()


def update_confusion(confusion: torch.Tensor, pred: torch.Tensor, label: torch.Tensor,
                     num_classes: int) -> torch.Tensor:
    """confusion (C, C) int64, gt-major, plus the (gt, pred) pairs of pred and
    label (same shape, integer); labels outside [0, C) are dropped. Returns
    the new matrix on confusion's device."""
    label = label.to(device=pred.device, dtype=torch.int64)
    valid = (label >= 0) & (label < num_classes)
    flat = torch.where(valid, label * num_classes + pred.to(torch.int64),
                       num_classes * num_classes)
    flat = flat.reshape(-1)
    counts = torch.zeros(num_classes * num_classes + 1, dtype=torch.int64, device=pred.device)
    counts.index_add_(0, flat, torch.ones_like(flat))
    return confusion + counts[:-1].reshape(num_classes, num_classes).to(confusion.device)


def confusion_matrix_np(pred: np.ndarray, label: np.ndarray, num_classes: int) -> np.ndarray:
    """Reference ``Evaluator._generate_matrix`` (numpy, host-side)."""
    mask = (label >= 0) & (label < num_classes)
    idx = num_classes * label[mask].astype(np.int64) + pred[mask].astype(np.int64)
    return np.bincount(idx, minlength=num_classes**2).reshape(num_classes, num_classes)


def _iou_from_confusion(cm: np.ndarray) -> np.ndarray:
    inter = np.diag(cm)
    union = cm.sum(1) + cm.sum(0) - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        return inter / union


def eval_metrics(cm: np.ndarray) -> dict[str, np.ndarray | float]:
    """mmseg-style summary: aAcc, per-class Acc, per-class IoU, mIoU / mAcc."""
    cm = np.asarray(cm, np.float64)
    inter = np.diag(cm)
    with np.errstate(divide="ignore", invalid="ignore"):
        acc = inter / cm.sum(1)
    iou = _iou_from_confusion(cm)
    return {
        "aAcc": float(inter.sum() / cm.sum()) if cm.sum() else float("nan"),
        "Acc": acc,
        "IoU": iou,
        "mIoU": float(np.nanmean(iou)),
        "mAcc": float(np.nanmean(acc)),
    }


def _ascii_table(rows: list[list[str]]) -> str:
    """Grid-style ASCII table (the reference prints per-class results with
    terminaltables.AsciiTable, ``custom.py:2700-2705``)."""
    widths = [max(len(str(r[c])) for r in rows) for c in range(len(rows[0]))]
    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
    out = [sep]
    for i, row in enumerate(rows):
        out.append("| " + " | ".join(str(v).ljust(w) for v, w in zip(row, widths)) + " |")
        if i == 0:
            out.append(sep)
    out.append(sep)
    return "\n".join(out)


def format_class_table(cm: np.ndarray, class_names=None) -> str:
    """Per-class IoU / Acc table and the global summary (reference
    ``custom.py:2678-2709``): values ×100, 2 decimals, nan printed as nan."""
    m = eval_metrics(cm)
    n = cm.shape[0]
    names = class_names if class_names is not None else [str(i) for i in range(n)]

    def fmt(x: float) -> str:
        return "nan" if np.isnan(x) else f"{100.0 * x:.2f}"

    class_rows = [["Class", "IoU", "Acc"]]
    for i in range(n):
        class_rows.append([names[i], fmt(m["IoU"][i]), fmt(m["Acc"][i])])
    summary_rows = [
        ["Scope", "mIoU", "mAcc", "aAcc"],
        ["global", fmt(m["mIoU"]), fmt(m["mAcc"]), fmt(m["aAcc"])],
    ]
    return ("per class results:\n" + _ascii_table(class_rows)
            + "\nSummary:\n" + _ascii_table(summary_rows))


def mean_iou_seen(cm: np.ndarray) -> float:
    """Reference Evaluator mIoU: the mean over classes present in the GT."""
    cm = np.asarray(cm, np.float64)
    iou = _iou_from_confusion(cm)
    seen = cm.sum(1) > 0
    if seen.sum() == 0:
        return float("nan")
    return float(np.nansum(iou * seen) / seen.sum())


def fwiou(cm: np.ndarray) -> float:
    """Frequency-weighted IoU."""
    cm = np.asarray(cm, np.float64)
    freq = cm.sum(1) / cm.sum()
    iou = _iou_from_confusion(cm)
    keep = freq > 0
    return float((freq[keep] * iou[keep]).sum())


def video_consistency(gts: list[np.ndarray], preds: list[np.ndarray],
                      clip_num: int) -> list[float]:
    """Per-window VC_n accuracies of one video."""
    accs = []
    for i in range(len(gts) - clip_num):
        gt_common = np.ones_like(gts[0], bool)
        pred_common = np.ones_like(gts[0], bool)
        for j in range(1, clip_num):
            gt_common &= gts[i] == gts[i + j]
            pred_common &= preds[i] == preds[i + j]
        hit = (pred_common & gt_common).sum()
        denom = gt_common.sum()
        accs.append(hit / denom if denom else np.nan)
    return accs
