"""PyTorch port, CFFM++'s phase A and cluster store on the CPU:

- ``VSPWVideoDataset.get_prototype_item`` equal bit for bit to the JAX item
  of its numpy / cv2 route, frames of 64×96 at ``img_scale`` (120, 80):
  resized to 80×120, then up to 96×128, normalised, each package on the
  same route: the native one (whose normalisation multiplies by 1 / std)
  and the numpy one (which divides);
- ``generate_prototypes`` on a ``make_fake_vspw`` tree (the
  ``train_val_generate_prototype`` split) with a small port model: one
  ``centers.npy`` (K, C) f32 a video, equal to ``kmeans_from`` of the
  item's ``prototype_features`` from the generator's draws in order;
- ``ClusterStore`` against the JAX store: one file a video, and several
  files, whose 80 % subset equals the JAX store's bit for bit; ``pad_to``
  from the headers, the masks, ``batch``, the memoisation and
  ``on_device``.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from fixtures import make_fake_vspw
from vss_cffm_tpu import native
from vss_cffm_tpu_torch import native as port_native
from vss_cffm_tpu.data.vspw import VSPWVideoDataset as JaxDataset
from vss_cffm_tpu.eval.prototypes import ClusterStore as JaxClusterStore
from vss_cffm_tpu_torch import config as pcfg
from vss_cffm_tpu_torch.data import VSPWVideoDataset
from vss_cffm_tpu_torch.eval import ClusterStore, generate_prototypes
from vss_cffm_tpu_torch.models import CFFMSegmentor
from vss_cffm_tpu_torch.ops.kmeans import kmeans_from, kmeans_init

SCALE = (120, 80)
SPLIT = "train_val_generate_prototype"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_fake_vspw(str(tmp_path_factory.mktemp("vspw")), frames_per_video=12,
                          hw=(64, 96))


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_prototype_items_equal_the_jax_items(root, route, monkeypatch):
    if route == "native" and not (native.available() and port_native.available()):
        pytest.skip("a native library did not build here (no toolchain)")
    if route == "numpy":
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(port_native, "available", lambda: False)
    jds, pds = JaxDataset(root, SPLIT, img_scale=SCALE), VSPWVideoDataset(root, SPLIT,
                                                                          img_scale=SCALE)
    assert len(pds) == len(jds) == 4
    for idx in range(len(pds)):
        for t in (10, 4):
            want, got = jds.get_prototype_item(idx, t), pds.get_prototype_item(idx, t)
            assert got["imgs"].dtype == np.float32 and got["imgs"].shape == (t, 96, 128, 3)
            np.testing.assert_array_equal(got["imgs"], want["imgs"])
            assert got["video"] == want["video"]


def _small_model(seed: int = 0) -> CFFMSegmentor:
    head = pcfg.CFFMHeadConfig(in_channels=tuple(pcfg.MIT_VARIANTS["mit_b0"].embed_dims),
                               embed_dim=32, num_classes=5,
                               decoder=pcfg.CFFMDecoderConfig(dim=32, depth=1, num_heads=2))
    m = CFFMSegmentor(pcfg.SegmentorConfig(backbone="mit_b0", head=head))
    m.init_weights(torch.Generator().manual_seed(seed))
    return m.eval()


def test_generate_prototypes_writes_each_videos_centres(root, tmp_path):
    model = _small_model()
    ds = VSPWVideoDataset(root, SPLIT, img_scale=SCALE)
    paths = generate_prototypes(model, ds, str(tmp_path), n_clusters=8, max_iter=3, seed=5,
                                num_frames=4)
    assert [os.path.relpath(p, tmp_path) for p in paths] == [
        os.path.join(v, "centers.npy") for v in ds.videos]
    gen = torch.Generator().manual_seed(5)
    last = {}  # a video listed twice (train and val) is written again: its last draw stays
    for idx, video in enumerate(ds.videos):
        item = ds.get_prototype_item(idx, 4)
        with torch.no_grad():
            feats = model.prototype_features(torch.from_numpy(item["imgs"])[None])
        assert feats.shape == (1, 4, 12, 16, 32)
        pts = feats.reshape(-1, 32)
        last[video], _ = kmeans_from(pts, kmeans_init(len(pts), 8, gen), 3)
    for video, want in last.items():
        saved = np.load(os.path.join(tmp_path, video, "centers.npy"))
        assert saved.dtype == np.float32 and saved.shape == (8, 32)
        np.testing.assert_array_equal(saved, want.numpy())


def _centre_tree(path, rng) -> str:
    """vid_x: two files of 10 centres (16 kept); vid_y: one file of 10;
    vid_z: three files of 7 (16 kept); an empty directory."""
    files = {"vid_x": [10, 10], "vid_y": [10], "vid_z": [7, 7, 7]}
    for video, sizes in files.items():
        os.makedirs(os.path.join(path, video))
        names = ["centers.npy"] if len(sizes) == 1 else [f"c{i}.npy" for i in range(len(sizes))]
        for name, n in zip(names, sizes):
            np.save(os.path.join(path, video, name), rng.randn(n, 8).astype(np.float32))
    os.makedirs(os.path.join(path, "empty"))
    return str(path)


def test_cluster_store_equals_the_jax_store(tmp_path):
    root = _centre_tree(tmp_path / "centers", np.random.RandomState(0))
    jax_store, store = JaxClusterStore(root, n_clusters=10), ClusterStore(root, n_clusters=10)
    assert store.pad_to == jax_store.pad_to == 16
    for video in ("vid_x", "vid_y", "vid_z", "vid_x"):
        (c, m), (jc, jm) = store(video), jax_store(video)
        assert c.dtype == np.float32 and c.shape == (16, 8) and m.dtype == bool
        np.testing.assert_array_equal(c, jc)
        np.testing.assert_array_equal(m, jm)
    c, m = store("vid_y")
    assert m.sum() == 10 and not c[10:].any()
    c, m = store("vid_x")
    assert m.sum() == 16
    # the subset is a subset of the files' rows, each kept once
    rows = np.concatenate([np.load(os.path.join(root, "vid_x", f"c{i}.npy")) for i in (0, 1)])
    kept = {tuple(r) for r in c[m]}
    assert len(kept) == 16 and kept <= {tuple(r) for r in rows}
    cb, mb = store.batch(["vid_y", "vid_x"])
    assert cb.shape == (2, 16, 8) and mb.shape == (2, 16)
    jcb, jmb = jax_store.batch(["vid_y", "vid_x"])
    np.testing.assert_array_equal(cb, jcb)
    np.testing.assert_array_equal(mb, jmb)
    with pytest.raises(FileNotFoundError):
        store("empty")


def test_cluster_store_single_files_and_the_device_copies(tmp_path):
    rng = np.random.RandomState(1)
    for video in ("a", "b"):
        os.makedirs(tmp_path / video)
        np.save(tmp_path / video / "centers.npy", rng.randn(12, 4).astype(np.float64))
    store = ClusterStore(str(tmp_path), n_clusters=12)
    assert store.pad_to == 12
    c, m = store("a")
    assert c.dtype == np.float32 and m.all() and store("a")[0] is c
    np.testing.assert_array_equal(c, np.load(tmp_path / "a" / "centers.npy").astype(np.float32))
    tc, tm = store.on_device(["b", "a"], "cpu")
    assert tc.shape == (2, 12, 4) and tm.dtype == torch.bool and tm.all()
    np.testing.assert_array_equal(tc[1].numpy(), c)
    first = store._device[("a", "cpu")][0]
    store.on_device(["a"], "cpu")
    assert store._device[("a", "cpu")][0] is first
