"""k-means (Lloyd, euclidean) for CFFM++ prototype generation.

The port of ``vss_cffm_tpu/ops/kmeans.py`` (which replaces the reference's
``fast_pytorch_kmeans.KMeans(n_clusters=100, max_iter=10, mode='euclidean')``,
``cffm_head.py:276-284``): centroids start at randomly chosen points, then a
fixed number of Lloyd iterations, each two dense f32 matmuls on the points'
device:

- assignment: argmin over ``‖p‖² − 2 p·c + ‖c‖²`` written as the JAX code
  writes it (``torch.cdist`` rounds otherwise and flips near-ties); argmin
  takes the first index on ties;
- update: the means from a one-hot (N, K) matmul, as in JAX, which gives the
  same centres from run to run (``index_add_`` on the card adds with
  atomics, in no fixed order); an empty cluster keeps its centroid.

The JAX package computes this outside any Pallas kernel, so the port's
counterpart is plain PyTorch. The matmuls run in f32: TF32 stays off, as it
is by default in PyTorch (``torch.backends.cuda.matmul.allow_tf32``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["kmeans", "kmeans_from", "kmeans_init"]


def kmeans_init(n_points: int, n_clusters: int, generator: torch.Generator) -> torch.Tensor:
    """(K,) int64 distinct point indices, ``randperm(n)[:K]`` drawn from
    ``generator`` on its device."""
    if n_clusters > n_points:
        raise ValueError(f"k-means: {n_clusters} clusters from {n_points} points")
    return torch.randperm(n_points, generator=generator, device=generator.device)[:n_clusters]


def kmeans_from(points: torch.Tensor, init_idx: torch.Tensor, max_iter: int = 10
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's iterations from the given initial point indices.

    points (N, D), any float dtype (computed in f32); init_idx (K,) indices
    into the points. Returns (centroids (K, D) f32, labels (N,) int64)."""
    points = points.float()
    k = int(init_idx.shape[0])
    centroids = points[init_idx.to(points.device)]
    sq_p = torch.sum(points * points, dim=1, keepdim=True)  # (N, 1)
    two_p = 2.0 * points

    def assign(c: torch.Tensor) -> torch.Tensor:
        sq_c = torch.sum(c * c, dim=1)  # (K,)
        d = sq_p - two_p @ c.t() + sq_c[None, :]
        return torch.argmin(d, dim=1)

    for _ in range(max_iter):
        onehot = F.one_hot(assign(centroids), k).to(torch.float32)  # (N, K)
        counts = onehot.sum(0)[:, None]  # (K, 1)
        sums = onehot.t() @ points  # (K, D)
        centroids = torch.where(counts > 0, sums / torch.clamp(counts, min=1.0), centroids)
    return centroids, assign(centroids)


def kmeans(points: torch.Tensor, n_clusters: int = 100, max_iter: int = 10,
           generator: torch.Generator | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(centroids (K, D) f32, labels (N,) int64) of ``points`` (N, D), the
    initial centroids drawn from ``generator`` (required: the draw is
    explicit, as the JAX function takes its key)."""
    if generator is None:
        raise ValueError("kmeans: pass the torch.Generator that draws the initial centroids")
    return kmeans_from(points, kmeans_init(points.shape[0], n_clusters, generator), max_iter)
