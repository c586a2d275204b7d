"""CFFM++ phase A: per-video k-means prototypes from a trained CFFM checkpoint.

The port of the JAX package's ``tools/generate_prototypes.py`` (which
replaces the reference's ``dist_test.sh`` with a ``_gene_prototype`` head
config, ``cffm_head.py:161-301``)::

    python -m vss_cffm_tpu_torch.tools.generate_prototypes \\
        vss_cffm_tpu_torch/configs/cffm_b1_vspw_gene_prototype.py <checkpoint> \\
        [--cluster-dir DIR] [--n-clusters K] [--num-frames T] [--device cuda|cpu] \\
        [--options ...]

The checkpoint is loaded as ``apis.init_segmentor(checkpoint=...)`` loads it:
a reference ``.pth`` / ``.pt`` holding every weight of the model, or a
``CheckpointManager`` directory. For every video of the train, val and test
lists (``VSPWVideoDataset`` split ``train_val_generate_prototype``, frames
resized to ``cfg.data.img_scale``), the fused 1/8 features of ``num_frames``
evenly spaced frames are clustered into ``n_clusters`` centres
(``cfg.proto.kmeans_iters`` Lloyd iterations) on the device, written as
``<cluster-dir>/<video>/centers.npy``. The flags override the config's
``ProtoConfig`` and ``cluster_dir``. One process, one device (the card
unless ``--device cpu``; without a card ``cuda`` raises).
"""

from __future__ import annotations

import argparse
import time

import torch

from ..apis import init_segmentor
from ..config import ExperimentConfig, apply_overrides, load_config
from ..data import VSPWVideoDataset
from ..eval.prototypes import generate_prototypes
from ..utils.logging import get_logger

__all__ = ["build_parser", "main", "run"]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="CFFM++ phase A: per-video cluster centres.")
    ap.add_argument("config")
    ap.add_argument("checkpoint")
    ap.add_argument("--cluster-dir", default=None, help="default: cfg.cluster_dir")
    ap.add_argument("--n-clusters", type=int, default=None, help="default: cfg.proto.n_clusters")
    ap.add_argument("--num-frames", type=int, default=None, help="default: cfg.proto.num_frames")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--options", nargs="*", default=[])
    return ap


def main(argv: list[str] | None = None) -> list[str]:
    args = build_parser().parse_args(argv)
    cfg = apply_overrides(load_config(args.config), args.options)
    return run(cfg, args.checkpoint, cluster_dir=args.cluster_dir or cfg.cluster_dir,
               n_clusters=args.n_clusters or cfg.proto.n_clusters,
               num_frames=args.num_frames or cfg.proto.num_frames, device=args.device)


def run(cfg: ExperimentConfig, checkpoint: str, *, cluster_dir: str, n_clusters: int,
        num_frames: int, device: str | torch.device = "cuda", dataset=None) -> list[str]:
    """Phase A of ``cfg``'s model from ``checkpoint`` into ``cluster_dir``;
    ``dataset`` replaces the prototype split of ``cfg.data.data_root``.
    Returns the paths written."""
    logger = get_logger()
    bundle = init_segmentor(cfg.model, device=device,
                            dtype=torch.bfloat16 if cfg.bf16 else torch.float32,
                            img_scale=cfg.data.img_scale, seed=cfg.seed, checkpoint=checkpoint)
    if dataset is None:
        dataset = VSPWVideoDataset(cfg.data.data_root, "train_val_generate_prototype",
                                   img_scale=cfg.data.img_scale)
    logger.info(f"generating prototypes for {len(dataset)} videos -> {cluster_dir} "
                f"({n_clusters} centres, {num_frames} frames, {cfg.proto.kmeans_iters} "
                f"iterations, device {bundle.device})")
    t0 = time.time()
    paths = generate_prototypes(bundle.model, dataset, cluster_dir, n_clusters=n_clusters,
                                max_iter=cfg.proto.kmeans_iters, num_frames=num_frames)
    logger.info(f"done: {len(paths)} videos in {time.time() - t0:.1f} s")
    return paths


if __name__ == "__main__":
    main()
