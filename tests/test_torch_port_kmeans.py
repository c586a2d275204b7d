"""PyTorch port, CFFM++'s k-means (``vss_cffm_tpu_torch/ops/kmeans.py``)
against the JAX package's ``ops/kmeans.py`` on the CPU, f32:

- from the initial indices the JAX function draws (``jax.random.choice`` of
  its key; JAX's RNG cannot be reproduced in torch, so ``kmeans_from`` takes
  them): labels equal, centres within 1e-5 (both sides compute the same two
  matmuls in f32, summed in other orders), on blobs and on plain Gaussian
  points;
- an empty cluster (two initial centroids on one duplicated point: the
  second index loses every tie) keeps its centroid on both sides;
- separated clusters (``tests/test_eval.py:77``), ``kmeans`` with a
  generator, and the initial draw.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from vss_cffm_tpu.ops.kmeans import kmeans as jax_kmeans
from vss_cffm_tpu_torch.ops.kmeans import kmeans, kmeans_from, kmeans_init


def _jax_init(key, n: int, k: int) -> np.ndarray:
    """The initial indices the JAX function draws from ``key``."""
    return np.array(jax.random.choice(key, n, (k,), replace=False))


def _points(kind: str, seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    if kind == "blobs":
        means = 4.0 * rng.randn(12, 32)
        return (means[rng.randint(0, 12, 1500)] + rng.randn(1500, 32)).astype(np.float32)
    return rng.randn(1200, 16).astype(np.float32)


@pytest.mark.parametrize("kind,k", [("blobs", 12), ("blobs", 20), ("gaussian", 10)])
def test_kmeans_matches_jax_from_its_init(kind, k):
    pts = _points(kind, 3)
    key = jax.random.PRNGKey(7)
    want_c, want_l = jax_kmeans(key, pts, k, 10)
    got_c, got_l = kmeans_from(torch.from_numpy(pts), torch.from_numpy(_jax_init(key, len(pts), k)),
                               10)
    assert got_c.dtype == torch.float32 and got_l.dtype == torch.int64
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=1e-5, atol=1e-5)


def test_empty_cluster_keeps_its_centroid_as_in_jax():
    """Points 1 and 5 are equal; a key whose draw takes both makes the later
    index's cluster empty at the first assignment (argmin takes the first
    index on ties), so after one iteration its centroid is still that point;
    five iterations agree with JAX as well."""
    pts = np.random.RandomState(0).randn(8, 4).astype(np.float32)
    pts[5] = pts[1]
    for seed in range(200):
        key = jax.random.PRNGKey(seed)
        init = _jax_init(key, 8, 4)
        if 1 in init and 5 in init:
            break
    else:
        raise AssertionError("no key drew both copies")
    empty = int(max(np.flatnonzero(init == 1)[0], np.flatnonzero(init == 5)[0]))
    for iters in (1, 5):
        want_c, want_l = jax_kmeans(key, pts, 4, iters)
        got_c, got_l = kmeans_from(torch.from_numpy(pts), torch.from_numpy(init), iters)
        np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
        np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=1e-6, atol=1e-6)
        if iters == 1:
            np.testing.assert_array_equal(got_c[empty].numpy(), pts[1])
            np.testing.assert_array_equal(np.asarray(want_c)[empty], pts[1])


def test_kmeans_separates_clusters():
    rng = np.random.RandomState(0)
    pts = np.concatenate([rng.randn(100, 8) + 10, rng.randn(100, 8) - 10]).astype(np.float32)
    centers, labels = kmeans(torch.from_numpy(pts), 2, 10, torch.Generator().manual_seed(0))
    labels = labels.numpy()
    assert len(set(labels[:100])) == 1 and len(set(labels[100:])) == 1
    assert labels[0] != labels[100]
    np.testing.assert_allclose(np.sort(centers[:, 0].numpy()), [-10, 10], atol=0.5)


def test_init_draw_is_the_generators():
    a = kmeans_init(500, 100, torch.Generator().manual_seed(4))
    b = kmeans_init(500, 100, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and len(set(a.tolist())) == 100 and int(a.max()) < 500
    assert torch.equal(a, torch.randperm(500, generator=torch.Generator().manual_seed(4))[:100])
    with pytest.raises(ValueError):
        kmeans(torch.zeros(10, 2), 3, 2)  # no generator
    with pytest.raises(ValueError):
        kmeans_init(5, 6, torch.Generator())


def test_kmeans_takes_bf16_features_in_f32():
    pts = torch.from_numpy(_points("blobs", 5)).to(torch.bfloat16)
    idx = kmeans_init(len(pts), 12, torch.Generator().manual_seed(1))
    c16, l16 = kmeans_from(pts, idx, 4)
    c32, l32 = kmeans_from(pts.float(), idx, 4)
    assert c16.dtype == torch.float32
    assert torch.equal(c16, c32) and torch.equal(l16, l32)
