"""CFFM++ prototypes: phase A's per-video cluster centres, and their store.

The port of ``vss_cffm_tpu/eval/prototypes.py`` (reference
``cffm_head.py:161-301``, SURVEY §3.4):

- ``generate_prototypes`` (phase A): for every video of a prototype-split
  dataset, the fused 1/8 features of ``num_frames`` evenly spaced frames
  (``CFFMSegmentor.prototype_features``) are clustered by k-means
  (``ops.kmeans``) on the model's device, and the centres are written as
  ``<save_dir>/<video>/centers.npy`` (f32, (n_clusters, C));
- ``ClusterStore`` (phase B and evaluation): a video's centres by name,
  memoised in host memory (the reference reads its files again every
  step, ``cffm_head.py:435``). With several files for one video it
  concatenates them and keeps a random 80 % subset
  (``np.random.RandomState(seed).permutation``, the JAX store's draws, so
  the subset is the JAX one), used as it is: the centres are zero-padded to
  a store-wide ``pad_to`` and come with a validity mask, which the cluster
  head's softmax honours (−inf on padded rows), equal to attention over the
  valid subset alone. ``on_device`` keeps each video's tensors on a device
  after their first copy.
"""

from __future__ import annotations

import glob
import os
from typing import Sequence

import numpy as np
import torch

from ..ops.kmeans import kmeans

__all__ = ["generate_prototypes", "ClusterStore"]


def generate_prototypes(model, dataset, save_dir: str, n_clusters: int = 100,
                        max_iter: int = 10, seed: int = 0, num_frames: int = 10) -> list[str]:
    """Phase A over every video of ``dataset`` (``get_prototype_item``, e.g.
    a ``VSPWVideoDataset`` of the ``train_val_generate_prototype`` split)
    with ``model`` (a ``CFFMSegmentor``, eval form, on its device). The
    initial centroids of each video are drawn from one ``torch.Generator``
    on the model's device seeded with ``seed`` (the JAX function splits a
    PRNG key a video; the two draws differ). Returns the paths written, one
    a video in the dataset's order (a video listed twice is written twice)."""
    device = next(model.parameters()).device
    model.eval()
    gen = torch.Generator(device).manual_seed(seed)
    paths = []
    for idx in range(len(dataset)):
        item = dataset.get_prototype_item(idx, num_frames)
        with torch.inference_mode():
            imgs = torch.from_numpy(item["imgs"]).to(device)[None]
            feats = model.prototype_features(imgs)  # (1, T, h, w, C)
            centers, _ = kmeans(feats.reshape(-1, feats.shape[-1]), n_clusters, max_iter, gen)
        out = os.path.join(save_dir, item["video"])
        os.makedirs(out, exist_ok=True)
        path = os.path.join(out, "centers.npy")
        np.save(path, centers.cpu().numpy().astype(np.float32))
        paths.append(path)
    return paths


class ClusterStore:
    """Per-video centres with host-memory memoisation.

    ``store(video)`` returns ``(centers (pad_to, C) f32, mask (pad_to,)
    bool)``, the centres zero-padded to the store-wide ``pad_to`` rows; for
    one file a video this is (n_clusters, C) with a mask of all True."""

    def __init__(self, save_dir: str, n_clusters: int = 100, subset_ratio: float = 0.8,
                 seed: int = 0):
        self.save_dir = save_dir
        self.n_clusters = n_clusters
        self.subset_ratio = subset_ratio
        self._rng = np.random.RandomState(seed)
        self._cache: dict[str, tuple[np.ndarray, np.ndarray]] = {}
        self._device: dict[tuple[str, str], tuple[torch.Tensor, torch.Tensor]] = {}
        self._pad_to: int | None = None

    @property
    def pad_to(self) -> int:
        """The rows every video's centres are padded to: the most kept
        centres of any video, at least ``n_clusters``, read once from the
        ``.npy`` headers (mmap, no data read)."""
        if self._pad_to is None:
            best = self.n_clusters
            for vdir in sorted(glob.glob(os.path.join(self.save_dir, "*"))):
                paths = sorted(glob.glob(os.path.join(vdir, "*.npy")))
                if not paths:
                    continue
                rows = sum(np.load(p, mmap_mode="r").shape[0] for p in paths)
                kept = rows if len(paths) == 1 else int(rows * self.subset_ratio)
                best = max(best, kept)
            self._pad_to = best
        return self._pad_to

    def _load(self, video: str) -> np.ndarray:
        single = os.path.join(self.save_dir, video, "centers.npy")
        if os.path.isfile(single):
            return np.load(single)
        paths = sorted(glob.glob(os.path.join(self.save_dir, video, "*.npy")))
        if not paths:
            raise FileNotFoundError(f"no prototypes for video {video!r} in {self.save_dir}")
        # several files: concatenated, a random 80 % subset kept as it is
        # (reference ``cffm_head.py:444-452``)
        centers = np.concatenate([np.load(p) for p in paths], axis=0)
        keep = int(centers.shape[0] * self.subset_ratio)
        idx = self._rng.permutation(centers.shape[0])[:keep]
        return centers[idx]

    def __call__(self, video: str) -> tuple[np.ndarray, np.ndarray]:
        if video in self._cache:
            return self._cache[video]
        centers = self._load(video).astype(np.float32)
        p, k = self.pad_to, centers.shape[0]
        if k > p:
            raise ValueError(f"video {video!r} has {k} centres, more than pad_to {p}")
        mask = np.zeros((p,), bool)
        mask[:k] = True
        if k < p:
            centers = np.concatenate([centers, np.zeros((p - k, centers.shape[1]), np.float32)])
        self._cache[video] = (centers, mask)
        return self._cache[video]

    def batch(self, videos: Sequence[str]) -> tuple[np.ndarray, np.ndarray]:
        """((B, pad_to, C), (B, pad_to)): the videos' centres and masks, stacked."""
        pairs = [self(v) for v in videos]
        return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])

    def on_device(self, videos: Sequence[str], device: str | torch.device
                  ) -> tuple[torch.Tensor, torch.Tensor]:
        """``batch(videos)`` as tensors on ``device``; each video's centres
        are copied there once and kept."""
        device = torch.device(device)
        pairs = []
        for v in videos:
            key = (v, str(device))
            if key not in self._device:
                c, m = self(v)
                self._device[key] = (torch.from_numpy(c).to(device), torch.from_numpy(m).to(device))
            pairs.append(self._device[key])
        return torch.stack([p[0] for p in pairs]), torch.stack([p[1] for p in pairs])
