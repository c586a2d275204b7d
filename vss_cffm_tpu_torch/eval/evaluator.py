"""Clip evaluation, per clip and streamed through a feature cache.

The port's copy of ``vss_cffm_tpu/eval/evaluator.py`` (reference
``tools/test.py`` → ``apis/test.py`` → ``EncoderDecoder_clips.simple_test``):

- ``ClipEvaluator`` evaluates one clip per frame (the dataset's test
  sampler): uint8 BGR frames go to the model's device, are resized
  (AlignedResize to /32) and normalised there, and the target frame's mask
  is logits → bilinear to the network input → bilinear to the original
  shape → argmax (the reference's softmax is monotone, so it is skipped
  where nothing averages probabilities); ``mode="slide"`` takes the crop
  grid of ``eval/inference.py``, ``predict_tta`` the multi-scale flip
  views of ``get_test_item_tta``. Each mask goes into an int64 (C, C)
  confusion matrix on the device (``update_confusion``); the host reads
  only the final matrix, and the masks when VC, PNGs or a callback ask for
  them.
- ``StreamingVideoEvaluator.run_streaming`` walks a video in order and keeps
  each frame's fused 1/4 features (backbone and per-frame decode, the
  model's ``frame_features``) in a cache keyed by (video, frame index), so a
  frame passes through the backbone once instead of once per clip it is in
  (up to 4 with the dilation (-9, -6, -3)); the head runs
  ``predict_from_features`` on the clip's cached features. Frames older than
  ``max_lag`` before the target, and a video's frames at its end, leave the
  cache. Only the frames not in the cache are decoded.

CFFM++: with a ``cluster_store`` (``eval.prototypes.ClusterStore``) both
evaluators hand the model each item's video centres and mask, in every mode
(whole, slide, TTA, streamed); a video's centres go to the device once. The
feature cache is unchanged: the centres enter only the head.

An image model (``arch="image"``, SegFormer) is evaluated by
``ClipEvaluator`` on the target frame of each item (``models.target_logits``,
JAX ``eval/evaluator.py:108-115``), in whole and slide mode. TTA and the
streamed evaluator raise ``ValueError`` for it, as the JAX package cannot
run them either (its TTA passes three positional arguments to
``ImageSegmentor.__call__``, and its streamed evaluator calls a
``frame_features`` that ``ImageSegmentor`` lacks).
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Callable, Iterable

import numpy as np
import torch

from ..data.palette import VSPW_PALETTE
from ..data.transforms import aligned_resize_clip, aligned_size, normalize_clip, rescale_size
from ..models.segmentor import is_image_model, target_logits
from ..ops.resize import resize_bilinear
from .inference import slide_inference, tta_inference
from .metrics import (aggregate_confusion, eval_metrics, fwiou, mean_iou_seen, update_confusion,
                      video_consistency)

__all__ = ["ClipEvaluator", "StreamingVideoEvaluator", "save_pred_png"]

MODES = ("whole", "slide")


def save_pred_png(pred: np.ndarray, path: str, palette=VSPW_PALETTE) -> None:
    """Palette PNG of a mask (``format_results``, ``custom.py:2525-2546``)."""
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    # Image.fromarray(arr, mode="P") corrupts the pixels; mode L + putpalette
    # gives a correct mode-P PNG
    img = Image.fromarray(np.asarray(pred).astype(np.uint8))
    flat = [c for rgb in palette for c in rgb]
    img.putpalette(flat + [0] * (768 - len(flat)))
    img.save(path)


def _refuse_image(model, what: str) -> None:
    if is_image_model(model):
        raise ValueError(f"{what} evaluates clip models only; this model has arch='image' "
                         "(the JAX package cannot run it on an image model either)")


def _device(device: str | torch.device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("evaluator: no CUDA device is present; pass device='cpu' to run "
                           "on the CPU")
    return device


class ClipEvaluator:
    """Accumulates the masks of test clips into a confusion matrix.

    ``model``: a ``CFFMSegmentor`` or an ``ImageSegmentor`` (moved to
    ``device``, put in eval mode);
    ``mode``: 'whole' (the CFFM configs' ``test_cfg.mode``) or 'slide' with
    ``crop_size`` / ``stride`` (reference ``encoder_decoder.py:457-500``);
    ``cluster_store``: CFFM++'s per-video centres, for a finetune-mode model.
    """

    def __init__(self, model, num_classes: int, mode: str = "whole",
                 crop_size: tuple[int, int] = (480, 480), stride: tuple[int, int] = (320, 320),
                 device: str | torch.device = "cuda", cluster_store=None):
        if mode not in MODES:
            raise ValueError(f"mode {mode!r}: expected one of {MODES}")
        self.device = _device(device)
        self.model = model.to(self.device).eval()
        self.num_classes = num_classes
        self.mode = mode
        self.crop_size = tuple(crop_size)
        self.stride = tuple(stride)
        self.cluster_store = cluster_store
        self._confusion = torch.zeros((num_classes, num_classes), dtype=torch.int64,
                                      device=self.device)
        self._vc_preds: dict[str, list[np.ndarray]] = defaultdict(list)
        self._vc_gts: dict[str, list[np.ndarray]] = defaultdict(list)

    def set_params(self, state_dict: dict) -> None:
        """Load new weights into the same module (e.g. the next eval interval
        of a training run)."""
        self.model.load_state_dict(state_dict, strict=True)

    def reset(self) -> None:
        """Zero the confusion matrix and the VC state for a new pass."""
        self._confusion = torch.zeros_like(self._confusion)
        self._vc_preds.clear()
        self._vc_gts.clear()

    def _input(self, imgs, img_scale: tuple[int, int]) -> torch.Tensor:
        """uint8 BGR frames (T, H, W, 3) → the normalised clip (1, T, H', W', 3)
        on the device, H' and W' multiples of 32."""
        clip = torch.as_tensor(imgs).to(self.device)
        return normalize_clip(aligned_resize_clip(clip, tuple(img_scale)))[None]

    def _mask(self, logits: torch.Tensor, input_hw, ori_shape) -> torch.Tensor:
        logits = resize_bilinear(logits, tuple(input_hw))
        return resize_bilinear(logits, tuple(ori_shape)).argmax(dim=-1)[0]

    def _centers(self, video: str):
        """The video's (centres (1, n, C), mask (1, n)) on the device, or None
        without a store."""
        if self.cluster_store is None:
            return None
        return self.cluster_store.on_device([video], self.device)

    def _logits_fn(self, video: str) -> Callable:
        centers = self._centers(video)
        kwargs = {} if centers is None else {"cluster_centers": centers}
        return lambda clip: target_logits(self.model, clip, **kwargs)

    @torch.inference_mode()
    def predict(self, item: dict) -> torch.Tensor:
        """The target frame's (H, W) int64 mask on the device, from a test item."""
        x = self._input(item["imgs"], item["img_scale"])
        ori = tuple(item["ori_shape"])
        logits_fn = self._logits_fn(item["video"])
        if self.mode == "slide":
            prob = slide_inference(logits_fn, x, ori, self.crop_size, self.stride)
            return prob.argmax(dim=-1)[0]
        return self._mask(logits_fn(x), x.shape[2:4], ori)

    @torch.inference_mode()
    def _predict_tta(self, item: dict) -> torch.Tensor:
        _refuse_image(self.model, "TTA")
        views = [self._input(item["imgs"], scale) for scale in item["scales"]]
        prob = tta_inference(self._logits_fn(item["video"]), views, item["flips"],
                             tuple(item["ori_shape"]))
        return prob.argmax(dim=-1)[0]

    def predict_tta(self, item: dict) -> np.ndarray:
        """Multi-scale flip TTA (``aug_test``'s mean of softmax) of an item of
        ``get_test_item_tta``: the (H, W) int64 mask on the host."""
        return self._predict_tta(item).cpu().numpy()

    def _accumulate(self, pred: torch.Tensor, gt: np.ndarray) -> None:
        self._confusion = update_confusion(self._confusion, pred, torch.from_numpy(gt),
                                           self.num_classes)

    def _record(self, video: str, frame: str, index: int, pred: torch.Tensor,
                gt: np.ndarray, keep_for_vc: bool, save_dir: str | None, on_pred) -> None:
        """Confusion, and the host copy of the mask where something reads it."""
        self._accumulate(pred, gt)
        if not (keep_for_vc or save_dir is not None or on_pred is not None):
            return
        pred_np = pred.cpu().numpy()
        if keep_for_vc:
            self._vc_preds[video].append(pred_np.astype(np.uint8))
            self._vc_gts[video].append(gt.astype(np.int32))
        if on_pred is not None:
            on_pred({"video": video, "frame": frame, "index": index}, pred_np)
        if save_dir is not None:
            save_pred_png(pred_np, os.path.join(save_dir, video,
                                                frame.rsplit(".", 1)[0] + ".png"))

    def _predict_item(self, item: dict) -> torch.Tensor:
        """A test item's mask on the device; a TTA item has ``scales``."""
        return self._predict_tta(item) if "scales" in item else self.predict(item)

    def add(self, item: dict, gt: np.ndarray, keep_for_vc: bool = False) -> np.ndarray:
        """Predict one test item and add it to the confusion matrix; returns
        the mask on the host."""
        pred = self._predict_item(item)
        self._record(item["video"], item["frame"], item.get("index"), pred, gt, keep_for_vc,
                     None, None)
        return pred.cpu().numpy()

    def run(self, items: Iterable[dict], gt_fn: Callable[[int], np.ndarray] | None = None,
            dataset=None, keep_for_vc: bool = False, save_dir: str | None = None,
            on_pred: Callable[[dict, np.ndarray], None] | None = None) -> dict:
        """Evaluate every item; the ground truth of each is looked up by the
        item's own ``index`` (items may be a shard), from ``dataset.load_gt``
        or ``gt_fn``. ``on_pred(meta, mask)`` is called per frame."""
        for i, item in enumerate(items):
            idx = item.get("index", i)
            gt = dataset.load_gt(idx) if dataset is not None else gt_fn(idx)
            self._record(item["video"], item["frame"], idx, self._predict_item(item), gt,
                         keep_for_vc, save_dir, on_pred)
        return self.summary(with_vc=keep_for_vc)

    @property
    def confusion(self) -> np.ndarray:
        """The (C, C) confusion matrix, int64 on the host."""
        return self._confusion.cpu().numpy()

    def aggregate_across_processes(self) -> None:
        """Sum the confusion matrix over the ranks, each of which evaluated its
        own shard of frames or videos (JAX ``evaluator.py:195-204``). Call once,
        after the local pass; ``summary()`` then gives the global metrics on
        every rank. VC8 / VC16 stay the rank's own: they need whole videos on
        one rank (shard by video). Nothing without a process group."""
        self._confusion = torch.from_numpy(aggregate_confusion(self.confusion)).to(self.device)

    def summary(self, with_vc: bool = False) -> dict:
        cm = self.confusion
        out = eval_metrics(cm)
        out["mIoU_seen"] = mean_iou_seen(cm)
        out["FWIoU"] = fwiou(cm)
        if with_vc:
            for n, key in ((8, "VC8"), (16, "VC16")):
                accs = []
                for video, preds in self._vc_preds.items():
                    gts = self._vc_gts[video]
                    if len(gts) <= n:
                        continue
                    accs.extend(video_consistency(gts, preds, n))
                out[key] = float(np.nanmean(accs)) if accs else float("nan")
        return out


class StreamingVideoEvaluator(ClipEvaluator):
    """Video-sequential evaluation with a per-frame feature cache, whole mode.

    The cache holds the trailing ``max_lag + 1`` frames of a video (10 for
    the default dilation). Use ``run_streaming(dataset)`` with a test-split
    ``VSPWVideoDataset`` (or anything with its ``frames``, ``frame_index``,
    ``img_scale``, ``sample_test_clip``, ``read_frame`` and ``load_gt``).
    """

    def __init__(self, model, num_classes: int, max_lag: int = 9,
                 device: str | torch.device = "cuda", cluster_store=None):
        _refuse_image(model, "StreamingVideoEvaluator")
        super().__init__(model, num_classes, device=device, cluster_store=cluster_store)
        self.max_lag = max_lag

    @torch.inference_mode()
    def run_streaming(self, dataset, keep_for_vc: bool = False, save_dir: str | None = None,
                      videos=None,
                      on_pred: Callable[[dict, np.ndarray], None] | None = None) -> dict:
        """``videos``: an optional collection of the videos to evaluate (a
        shard by video keeps the cache local and VC defined)."""
        cache: dict[tuple[str, int], torch.Tensor] = {}
        wanted = None if videos is None else set(videos)
        frame_pos: dict[str, dict[str, int]] = {}  # video → {frame: position}
        scale = tuple(dataset.img_scale)
        for idx in range(len(dataset)):
            video, frame = dataset.frame_index[idx]
            if wanted is not None and video not in wanted:
                continue
            frames_list = dataset.frames[video]
            if video not in frame_pos:
                frame_pos[video] = {f: i for i, f in enumerate(frames_list)}
            t = frame_pos[video][frame]
            sample = dataset.sample_test_clip(idx)
            # encode only the frames not in the cache; the target, last in
            # the clip, is always new, so img ends as the target frame
            for fi in sample.frame_indices:
                if (video, fi) not in cache:
                    img = dataset.read_frame(video, frames_list[fi])
                    cache[(video, fi)] = self.model.frame_features(self._input(img[None],
                                                                               scale)[0])
            ori = tuple(img.shape[:2])
            fused = torch.stack([cache[(video, fi)][0] for fi in sample.frame_indices])[None]
            logits = self.model.predict_from_features(fused,
                                                      cluster_centers=self._centers(video))
            pred = self._mask(logits, aligned_size(rescale_size(ori, scale)), ori)
            self._record(video, frame, idx, pred, dataset.load_gt(idx), keep_for_vc, save_dir,
                         on_pred)
            # evict frames older than the dilation window, and a video at its end
            for key in [k for k in cache if k[0] == video and k[1] < t - self.max_lag]:
                del cache[key]
            if t == len(frames_list) - 1:
                cache = {k: v for k, v in cache.items() if k[0] != video}
        return self.summary(with_vc=keep_for_vc)
