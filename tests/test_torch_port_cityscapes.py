"""PyTorch port, the Cityscapes clip dataset against the JAX package's, on the
fake tree of ``tests/test_cityscapes.py`` (rebuilt here, with a second
sequence): the sample list, the frame names (``_shift_frame``, reversed
dilations), train items from the same ``RandomState`` seeds, test items and
the ground truth, element for element. Both packages run their numpy route
(each ``native.available`` False): their native routes normalise by a
multiplication by 1 / std, one ulp from the division."""

from __future__ import annotations

import os

import cv2
import numpy as np
import pytest
from PIL import Image

from vss_cffm_tpu import native
from vss_cffm_tpu_torch import native as port_native
from vss_cffm_tpu.data import cityscapes as jax_city
from vss_cffm_tpu_torch.data import CityscapesClipDataset
from vss_cffm_tpu_torch.data import cityscapes as city

GEOM = dict(crop_size=(64, 64), img_scale=(128, 64))


@pytest.fixture(scope="module")
def city_root(tmp_path_factory):
    """aachen sequence 0 (frames 0-29, frame 19 annotated), as in
    ``tests/test_cityscapes.py``, and bremen sequence 3 (frames 2-25, frame 14
    annotated, 48×80 frames)."""
    root = str(tmp_path_factory.mktemp("cityscapes"))
    rng = np.random.RandomState(0)
    for name, seq, frames, target, hw in (("aachen", 0, range(30), 19, (64, 128)),
                                          ("bremen", 3, range(2, 26), 14, (48, 80))):
        img_dir = os.path.join(root, "leftImg8bit_sequence", "train", name)
        ann_dir = os.path.join(root, "gtFine", "train", name)
        os.makedirs(img_dir)
        os.makedirs(ann_dir)
        for f in frames:
            img = rng.randint(0, 255, (*hw, 3), np.uint8)
            cv2.imwrite(os.path.join(img_dir, f"{name}_{seq:06d}_{f:06d}_leftImg8bit.png"), img)
        gt = rng.randint(0, 19, hw).astype(np.uint8)
        gt[: hw[0] // 4] = 255
        Image.fromarray(gt).save(
            os.path.join(ann_dir, f"{name}_{seq:06d}_{target:06d}_gtFine_labelTrainIds.png"))
    return root


@pytest.fixture
def datasets(city_root, monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(port_native, "available", lambda: False)
    return (jax_city.CityscapesClipDataset(city_root, "train", **GEOM),
            CityscapesClipDataset(city_root, "train", **GEOM))


def test_names_match_jax(datasets):
    jds, ds = datasets
    assert ds.samples == jds.samples and len(ds) == len(jds) == 2
    for rel, _ in ds.samples:
        for dil in ([-9, -6, -3], [9, 6, 3], [-1, -2, -3]):
            assert ds._clip_names(rel, dil) == jds._clip_names(rel, dil)
    for name, off in (("aachen_000000_000019_leftImg8bit.png", -9),
                      ("aachen_000000_000019_leftImg8bit.png", 3),
                      ("frankfurt_000001_000009_leftImg8bit.png", 991),
                      ("bremen_000003_000014_leftImg8bit.png", -14)):
        assert city._shift_frame(name, off) == jax_city._shift_frame(name, off)
    assert city.CITYSCAPES_CLASSES == jax_city.CITYSCAPES_CLASSES
    assert city.CITYSCAPES_PALETTE == jax_city.CITYSCAPES_PALETTE


def test_train_items_match_jax(datasets):
    """Both samples at 8 seeds (each reversal branch taken): images and
    labels bitwise, the meta, and the RNG left at the same point."""
    jds, ds = datasets
    for seed in range(8):
        for idx in range(len(ds)):
            rj, rp = np.random.RandomState(seed), np.random.RandomState(seed)
            want, got = jds.get_train_item(idx, rj), ds.get_train_item(idx, rp)
            assert got["imgs"].dtype == np.float32 and got["imgs"].shape == (4, 64, 64, 3)
            assert got["labels"].dtype == np.int32
            np.testing.assert_array_equal(got["imgs"], want["imgs"])
            np.testing.assert_array_equal(got["labels"], want["labels"])
            for t in range(1, 4):
                np.testing.assert_array_equal(got["labels"][t], got["labels"][0])
            assert (got["video"], got["frame"]) == (want["video"], want["frame"])
            assert rj.randint(1 << 30) == rp.randint(1 << 30)


def test_test_items_and_gt_match_jax(datasets):
    jds, ds = datasets
    for idx in range(len(ds)):
        want, got = jds.get_test_item(idx), ds.get_test_item(idx)
        assert got["imgs"].dtype == np.float32
        np.testing.assert_array_equal(got["imgs"], want["imgs"])
        assert got["ori_shape"] == want["ori_shape"]
        assert (got["video"], got["frame"]) == (want["video"], want["frame"])
        np.testing.assert_array_equal(ds.load_gt(idx), jds.load_gt(idx))
    assert ds.get_test_item(0)["imgs"].shape == (4, 64, 128, 3)


def test_a_missing_frame_raises(city_root):
    ds = CityscapesClipDataset(city_root, "train", dilation=(-30, -6, -3), **GEOM)
    with pytest.raises(FileNotFoundError):
        ds.get_test_item(0)
