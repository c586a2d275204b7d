"""Evaluate a checkpoint of the port on VSPW (mIoU / FWIoU / VC) and/or
write its predictions.

The port of the JAX package's ``tools/test.py`` (reference ``tools/test.py``
and ``mmseg/apis/test.py``)::

    python -m vss_cffm_tpu_torch.tools.test vss_cffm_tpu_torch/configs/cffm_b1_vspw_160k.py \\
        work_dirs/cffm_b1_vspw_160k/ckpt [--split val] [--eval | --no-eval] [--vc] \\
        [--streaming] [--aug-test] [--format-only --show-dir DIR] [--show --opacity 0.5] \\
        [--out metrics.json | masks.pkl [--efficient-test]] [--shape-census] \\
        [--device cuda|cuda:N|cpu] [--distributed [--backend nccl|gloo]
        [--coordinator HOST:PORT --num-processes N --process-id R]]
        [--options data.data_root=... ...]

One process on one device (``--device``, the card unless ``cpu`` is asked
for; without a card ``cuda`` raises), or, with ``--distributed``, one
process a rank (``tools/dist_test.sh``, torchrun's environment or the
coordinator flags, as ``tools/train.py`` takes them). Each rank evaluates
a shard, every ``world``-th frame from its rank per clip and with
``--aug-test``, every ``world``-th video with ``--streaming``, and the
confusion matrices are summed over the ranks
(``aggregate_across_processes``): the metrics are the whole pass's on every
rank; VC8 / VC16 are the rank's own videos' (as in the JAX CLI). Rank 0
logs the class table and writes the ``--out`` JSON; ``--out x.pkl`` is
written by each rank as ``x.pkl.rank{r}`` with its own frames' masks; PNGs
and overlays come from the rank that evaluated the frame. The checkpoint is what
``apis.init_segmentor(cfg, checkpoint=...)`` loads: a reference ``.pth`` /
``.pt`` or a ``CheckpointManager`` directory. The model and its compute
dtype come from the config (``arch``, ``bf16``), as do the frames'
``img_scale`` and dilation; a CFFM++ finetune config evaluates with the
centres of ``cfg.cluster_dir`` (``eval.ClusterStore``).

- ``ClipEvaluator`` by default, in ``cfg.model.test_cfg``'s mode (whole or
  slide); ``--aug-test``: multi-scale flip TTA (ratios 0.5-1.75, flipped and
  not); ``--streaming``: ``StreamingVideoEvaluator`` with its feature cache
  (whole mode: a slide ``test_cfg`` is warned about and ignored), frames
  kept ``-min(dilation)`` behind the target. An image model (``arch="image"``)
  is evaluated per frame; it has no TTA or streamed form.
- ``--eval`` (the default) logs the per-class IoU / Acc table; the metrics
  are logged in any case; ``--vc`` adds VC8 / VC16.
- ``--format-only`` writes palette PNGs to ``--show-dir``; ``--show`` writes
  the masks blended over the frames (``apis.show_result``) to
  ``<show-dir>_vis``; ``--out x.json`` the metrics, ``--out x.pkl`` the
  masks in dataset order (``--efficient-test``: each mask to
  ``x_masks/<index>.npy``, the pickle holding the paths).
- ``--shape-census`` prints the network input shapes of the pass, from one
  image header a video, and stops before loading anything.

Left out: the JAX CLI's ``--host-normalize`` (the port always normalises on
the device). ``main(argv)`` returns the metrics, the confusion matrix (the
sum over the ranks) and the census, for callers in the same process.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle

import numpy as np

from .. import parallel
from ..config import apply_overrides, load_config
from ..data import VSPWVideoDataset, iterate_eval, iterate_eval_tta
from ..data.palette import VSPW_CLASSES
from ..data.vspw import TTA_RATIOS
from ..eval import (ClipEvaluator, ClusterStore, StreamingVideoEvaluator, eval_shape_census,
                    format_class_table)
from ..utils.logging import get_logger

__all__ = ["build_parser", "main"]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Evaluate a checkpoint of the port on VSPW.")
    ap.add_argument("config")
    ap.add_argument("checkpoint", help="a .pth / .pt or a checkpoint directory")
    ap.add_argument("--split", default="val")
    ap.add_argument("--eval", action="store_true", default=True,
                    help="log the per-class IoU / Acc table (the default)")
    ap.add_argument("--no-eval", dest="eval", action="store_false")
    ap.add_argument("--vc", action="store_true", help="also VC8 / VC16")
    ap.add_argument("--streaming", action="store_true",
                    help="video-sequential evaluation with a per-frame feature cache")
    ap.add_argument("--aug-test", action="store_true",
                    help="multi-scale (0.5-1.75) flip TTA (reference --aug-test)")
    ap.add_argument("--format-only", action="store_true",
                    help="write palette PNGs of the masks to --show-dir")
    ap.add_argument("--show", action="store_true",
                    help="write the masks blended over the frames to <show-dir>_vis")
    ap.add_argument("--opacity", type=float, default=0.5, help="overlay opacity of --show")
    ap.add_argument("--show-dir", default="result_submission")
    ap.add_argument("--out", help="metrics JSON (.json) or the masks' pickle (.pkl)")
    ap.add_argument("--efficient-test", action="store_true",
                    help="with --out *.pkl: each mask to <out>_masks/*.npy, the pickle "
                         "holding the paths")
    ap.add_argument("--shape-census", action="store_true",
                    help="print the network input shapes of the pass and stop")
    parallel.add_arguments(ap)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the rank's own card), cuda:N (every rank on card N) "
                         "or cpu")
    ap.add_argument("--options", nargs="*", default=[])
    return ap


def _mask_writers(args, dataset):
    """The ``on_pred`` callback of ``--out *.pkl`` and ``--show`` (None
    without them), and the dict the pickle's masks gather in."""
    preds: dict[int, object] = {}
    writers = []
    if args.out and args.out.endswith(".pkl"):
        mask_dir = args.out[: -len(".pkl")] + "_masks"
        if args.efficient_test:
            os.makedirs(mask_dir, exist_ok=True)

        def dump(meta, pred):
            if args.efficient_test:
                path = os.path.join(mask_dir, f"{meta['index']:08d}.npy")
                np.save(path, pred.astype(np.uint8))
                preds[meta["index"]] = path
            else:
                preds[meta["index"]] = pred.astype(np.uint8)

        writers.append(dump)
    if args.show:
        from PIL import Image

        from ..apis import show_result

        vis_dir = args.show_dir.rstrip("/") + "_vis"

        def show(meta, pred):
            blend = show_result(dataset._img_path(meta["video"], meta["frame"]), pred,
                                opacity=args.opacity)
            dst = os.path.join(vis_dir, meta["video"])
            os.makedirs(dst, exist_ok=True)
            Image.fromarray(np.ascontiguousarray(blend[..., ::-1])).save(
                os.path.join(dst, meta["frame"].rsplit(".", 1)[0] + ".png"))

        writers.append(show)
    if not writers:
        return None, preds
    return lambda meta, pred: [w(meta, pred) for w in writers], preds


def main(argv: list[str] | None = None) -> dict:
    """Returns {"metrics": the summary's scalars, "confusion": (C, C) int64,
    "census": the shape census}; with ``--shape-census`` only the census."""
    args = build_parser().parse_args(argv)
    distributed = parallel.options(args)
    if distributed is None:
        return _main(args, args.device)
    device = parallel.init_distributed(args.device, **distributed)
    try:
        return _main(args, device)
    finally:
        parallel.shutdown()


def _main(args, device) -> dict:
    rank, world = parallel.rank(), parallel.world_size()
    cfg = apply_overrides(load_config(args.config), args.options)
    logger = get_logger()
    dataset = VSPWVideoDataset(cfg.data.data_root, args.split, dilation=cfg.data.dilation,
                               img_scale=cfg.data.img_scale)
    census = eval_shape_census(dataset, tta_ratios=TTA_RATIOS if args.aug_test else None)
    logger.info(f"eval shape census: {census['num_compiles']} distinct input shape(s) over "
                f"{census['num_frames']} frames / {census['num_videos']} videos")
    if args.shape_census:
        for (t, ah, aw, oh, ow), n in sorted(census["shapes"].items(), key=lambda kv: -kv[1]):
            print(f"T={t} aligned=({ah},{aw}) ori=({oh},{ow}): {n} frames")
        return {"census": census}

    from ..apis import init_segmentor

    bundle = init_segmentor(cfg, checkpoint=args.checkpoint, device=device)
    num_classes = cfg.model.head.num_classes
    store = ClusterStore(cfg.cluster_dir) if cfg.model.head.mode == "finetune" else None
    on_pred, preds = _mask_writers(args, dataset)
    save_dir = args.show_dir if args.format_only else None
    tc = cfg.model.test_cfg
    if args.streaming:
        if tc.mode != "whole":
            logger.warning("--streaming uses whole-image inference; ignoring "
                           f"test_cfg.mode={tc.mode!r} (drop --streaming for slide)")
        evaluator = StreamingVideoEvaluator(bundle.model, num_classes,
                                            max_lag=-min(cfg.data.dilation, default=0),
                                            device=bundle.device, cluster_store=store)
        # a shard of whole videos: the feature cache stays local and VC defined
        evaluator.run_streaming(dataset, keep_for_vc=args.vc, save_dir=save_dir,
                                videos=dataset.videos[rank::world] if world > 1 else None,
                                on_pred=on_pred)
    else:
        evaluator = ClipEvaluator(bundle.model, num_classes, mode=tc.mode,
                                  crop_size=tc.crop_size, stride=tc.stride,
                                  device=bundle.device, cluster_store=store)
        iterate = iterate_eval_tta if args.aug_test else iterate_eval
        evaluator.run(iterate(dataset, num_workers=cfg.data.num_workers, shard_id=rank,
                              num_shards=world), dataset=dataset,
                      keep_for_vc=args.vc, save_dir=save_dir, on_pred=on_pred)
    evaluator.aggregate_across_processes()
    metrics = evaluator.summary(with_vc=args.vc)
    summary = {k: float(v) for k, v in metrics.items() if np.isscalar(v)}
    confusion = evaluator.confusion
    if args.eval and rank == 0:
        names = VSPW_CLASSES if len(VSPW_CLASSES) == num_classes else None
        logger.info("\n" + format_class_table(confusion, names))
    logger.info(f"metrics: {summary}")
    if args.out and args.out.endswith(".pkl"):
        path = args.out if world == 1 else f"{args.out}.rank{rank}"
        with open(path, "wb") as f:
            pickle.dump([preds[k] for k in sorted(preds)], f)
        logger.info(f"dumped {len(preds)} masks to {path}")
    elif args.out and rank == 0:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=2)
    return {"metrics": summary, "confusion": confusion, "census": census}


if __name__ == "__main__":
    main()
