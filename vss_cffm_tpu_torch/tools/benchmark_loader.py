"""Throughput of the port's train data path: can the loader keep the card
fed? The port of the JAX package's ``tools/benchmark_loader.py``::

    python -m vss_cffm_tpu_torch.tools.benchmark_loader [--frames-hw 480 853] \\
        [--batch-size 2] [--num-workers 4] [--worker-mode thread|process] \\
        [--batches 20] [--device cuda|cuda:N|cpu]

Writes a synthetic VSPW tree at the real frame geometry (3 videos of 24
480 × 853 JPEGs of noise rolled frame to frame, PNG masks; PIL) into a
temporary directory, then times ``TrainLoader`` over ``--batches`` batches
after one: JPEG decode, the clip-synchronised train augmentation at 480 ×
480 crops, batching and the copy of the uint8 batch to ``--device`` (pinned
memory, ``non_blocking``; synchronised before the clock stops), on threads
or, with ``--worker-mode process``, in spawned worker processes. Prints
whether the native library is built and with which codecs (the route the
items take: ``data/vspw.py``), then clips/s and frames/s.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from ..utils.benchmark import device_of

__all__ = ["build_tree", "main"]


def build_tree(root: str, hw, videos: int = 3, frames: int = 24) -> str:
    """A VSPW tree under ``root``: ``videos`` videos of ``frames`` JPEG frames
    (quality 90) of size ``hw`` and PNG masks of classes 0-123."""
    from PIL import Image

    rng = np.random.RandomState(0)
    names = [f"vid_{i}" for i in range(videos)]
    for split in ("train", "val", "test"):
        with open(os.path.join(root, f"{split}.txt"), "w") as f:
            f.write("\n".join(names) + "\n")
    h, w = hw
    for v in names:
        odir = os.path.join(root, "data", v, "origin")
        mdir = os.path.join(root, "data", v, "mask")
        os.makedirs(odir)
        os.makedirs(mdir)
        base = rng.randint(0, 255, (h, w, 3), np.uint8)
        for i in range(frames):
            Image.fromarray(np.roll(base, i * 7, axis=1)).save(
                os.path.join(odir, f"{i:08d}.jpg"), quality=90)
            Image.fromarray(rng.randint(0, 124, (h, w)).astype(np.uint8)).save(
                os.path.join(mdir, f"{i:08d}.png"))
    return root


def main(argv: list[str] | None = None) -> dict:
    """Prints the rates; returns {"clips_per_s", "frames_per_s", "batches",
    "device", "worker_mode", "native", "codecs"}."""
    ap = argparse.ArgumentParser(description="Throughput of the port's train loader.")
    ap.add_argument("--frames-hw", type=int, nargs=2, default=(480, 853))
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--num-workers", type=int, default=4)
    ap.add_argument("--worker-mode", default="thread", choices=["thread", "process"],
                    help="process: spawned workers, items back through shared memory")
    ap.add_argument("--batches", type=int, default=20)
    ap.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    args = ap.parse_args(argv)

    from .. import native
    from ..data import TrainLoader, VSPWVideoDataset

    device = device_of(args.device, "benchmark_loader")
    with tempfile.TemporaryDirectory(prefix="loaderbench_") as root:
        build_tree(root, tuple(args.frames_hw))
        dataset = VSPWVideoDataset(root, "train", crop_size=(480, 480))
        loader = TrainLoader(dataset, args.batch_size, num_workers=args.num_workers,
                             device_normalize=True, worker_mode=args.worker_mode, device=device)
        it = iter(loader)
        try:
            next(it)  # warm the pool
            clips = frames = 0
            t0 = time.perf_counter()
            for _ in range(args.batches):
                batch = next(it)
                clips += batch["imgs"].shape[0]
                frames += batch["imgs"].shape[0] * batch["imgs"].shape[1]
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0
        finally:
            it.close()
    print(f"native library available: {native.available()}, codecs: "
          f"{', '.join(native.codecs()) or 'none'}")
    print(f"{clips / dt:.3f} clips/s, {frames / dt:.3f} frames/s host decode+augment+copy to "
          f"{device} ({args.batch_size}-clip batches, {loader.num_workers} "
          f"{args.worker_mode} workers, {args.batches} batches)")
    return {"clips_per_s": clips / dt, "frames_per_s": frames / dt, "batches": args.batches,
            "device": str(device), "worker_mode": args.worker_mode,
            "native": native.available(), "codecs": native.codecs()}


if __name__ == "__main__":
    main()
