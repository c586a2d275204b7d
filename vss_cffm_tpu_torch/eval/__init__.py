"""Evaluation of the port: metrics, whole / slide / TTA inference, the clip
and streaming evaluators, the eval-shape census, and CFFM++'s prototypes
(phase A and the cluster store)."""

from .census import eval_shape_census
from .evaluator import ClipEvaluator, StreamingVideoEvaluator, save_pred_png
from .inference import slide_inference, tta_inference, whole_inference
from .metrics import (aggregate_confusion, confusion_matrix_np, eval_metrics,
                      format_class_table, fwiou, mean_iou_seen, update_confusion,
                      video_consistency)
from .prototypes import ClusterStore, generate_prototypes

__all__ = [
    "ClipEvaluator",
    "StreamingVideoEvaluator",
    "save_pred_png",
    "whole_inference",
    "slide_inference",
    "tta_inference",
    "eval_shape_census",
    "aggregate_confusion",
    "confusion_matrix_np",
    "eval_metrics",
    "format_class_table",
    "fwiou",
    "mean_iou_seen",
    "update_confusion",
    "video_consistency",
    "ClusterStore",
    "generate_prototypes",
]
