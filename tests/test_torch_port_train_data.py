"""PyTorch port, the train side of the data layer against the JAX package's
and cv2 (cv2 is here for the tests; the port does not import it):

- ``VSPWVideoDataset.get_train_item(i, RandomState(s), normalize=False)``
  equal bit for bit to the JAX one (images, labels, video, frame) at 24
  seeds on a ``make_fake_vspw`` tree, once on each route, both packages on
  the same one (their native C++ pipelines, and their numpy pipelines with
  each ``native.available`` False), and the RNG left at the same point;
- the window resizes against ``cv2.resize`` (bilinear at random geometries
  and windows, nearest), BGR→HSV and HSV→BGR against ``cv2.cvtColor`` at
  row widths that put the 32-pixel blocks and the tail in each mix, the
  HSV→BGR factors against their exact values, the photometric distortion
  against the JAX one;
- ``TrainLoader``: the first 3 batches equal the JAX loader's at
  ``num_workers`` 0 and 2, shards split the videos as the JAX shards do; in
  the process mode (2 spawned workers) the first 3 batches equal the thread
  mode's and the synchronous ones bit for bit, and after that early close
  no worker is alive and no shared-memory segment of the loader is left in
  ``/dev/shm``; a worker's exception reaches the consumer, with the same
  clean-up; an unknown worker mode is refused.
"""

from __future__ import annotations

import multiprocessing
import os

import cv2
import numpy as np
import pytest
import torch

from fixtures import make_fake_vspw
from vss_cffm_tpu import native
from vss_cffm_tpu.data import transforms as JT
from vss_cffm_tpu.data.loader import TrainLoader as JaxTrainLoader
from vss_cffm_tpu.data.vspw import VSPWVideoDataset as JaxDataset
from vss_cffm_tpu_torch import native as port_native
from vss_cffm_tpu_torch.data import TrainLoader, VSPWVideoDataset
from vss_cffm_tpu_torch.data import transforms as T

GEOM = dict(crop_size=(64, 64), img_scale=(96, 64))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_fake_vspw(str(tmp_path_factory.mktemp("vspw")),
                          videos=("vid_a", "vid_b", "vid_c"), frames_per_video=13, hw=(64, 96))


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_train_items_equal_the_jax_items_bitwise(root, route, monkeypatch):
    if route == "native" and not (native.available() and port_native.available()):
        pytest.skip("a native library did not build here (no toolchain)")
    if route == "numpy":
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(port_native, "available", lambda: False)
    jds, pds = JaxDataset(root, "train", **GEOM), VSPWVideoDataset(root, "train", **GEOM)
    assert len(pds) == len(jds) == 3
    for seed in range(24):
        for idx in range(len(pds)):
            rj, rp = np.random.RandomState(seed), np.random.RandomState(seed)
            want = jds.get_train_item(idx, rj, normalize=False)
            got = pds.get_train_item(idx, rp, normalize=False)
            assert got["imgs"].dtype == np.uint8 and got["imgs"].shape == (4, 64, 64, 3)
            assert got["labels"].dtype == np.int32
            np.testing.assert_array_equal(got["imgs"], want["imgs"])
            np.testing.assert_array_equal(got["labels"], want["labels"])
            assert (got["video"], got["frame"]) == (want["video"], want["frame"])
            assert rj.randint(1 << 30) == rp.randint(1 << 30)


def test_normalized_train_item_equals_the_jax_numpy_route(root, monkeypatch):
    """normalize=True: RGB (x − mean) / std in f32 on the host, as the JAX
    numpy route computes it, padding 0 after it (both packages on their numpy
    route)."""
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(port_native, "available", lambda: False)
    jds = JaxDataset(root, "train", crop_size=(80, 112), img_scale=(96, 64))
    pds = VSPWVideoDataset(root, "train", crop_size=(80, 112), img_scale=(96, 64))
    for seed in range(4):
        want = jds.get_train_item(1, np.random.RandomState(seed))
        got = pds.get_train_item(1, np.random.RandomState(seed))
        assert got["imgs"].dtype == np.float32
        np.testing.assert_array_equal(got["imgs"], want["imgs"])
        np.testing.assert_array_equal(got["labels"], want["labels"])


def test_constructor_matches_the_jax_signature(root):
    import inspect

    jp = list(inspect.signature(JaxDataset.__init__).parameters.items())
    pp = list(inspect.signature(VSPWVideoDataset.__init__).parameters.items())
    assert [(n, p.default) for n, p in pp] == [(n, p.default) for n, p in jp]
    ds = VSPWVideoDataset(root, "train", (-9, -6, -3), (48, 48), (96, 64), False)
    assert (ds.crop_size, ds.img_scale, ds.flip_video) == ((48, 48), (96, 64), False)
    assert ds.split == VSPWVideoDataset(root).split == "train"


def test_short_videos_are_redrawn(root):
    ds = VSPWVideoDataset(root, "train", **GEOM)
    ds.frames = dict(ds.frames, vid_a=ds.frames["vid_a"][:5])  # shorter than the window
    sample, _ = ds.sample_train_clip(0, np.random.RandomState(0))
    assert sample.video != "vid_a" and len(sample.frame_indices) == 4
    ds.frames = {v: f[:5] for v, f in ds.frames.items()}
    with pytest.raises(RuntimeError):
        ds.sample_train_clip(0, np.random.RandomState(0))


def test_bilinear_window_resize_matches_cv2():
    rng = np.random.RandomState(0)
    for case in range(40):
        sh, sw = rng.randint(5, 200), rng.randint(5, 260)
        f = [0.5, 2.0][case] if case < 2 else rng.uniform(0.3, 2.5)  # 2x down: cv2's area path
        rh, rw = max(1, int(sh * f + 0.5)), max(1, int(sw * f + 0.5))
        src = rng.randint(0, 256, (sh, sw, 3)).astype(np.uint8)
        ref = cv2.resize(src, (rw, rh), interpolation=cv2.INTER_LINEAR)
        y1, x1 = rng.randint(0, max(rh - 48, 0) + 1), rng.randint(0, max(rw - 48, 0) + 1)
        vh, vw = min(48, rh - y1), min(48, rw - x1)
        np.testing.assert_array_equal(T.resize_window(src, rh, rw, y1, x1, vh, vw),
                                      ref[y1:y1 + vh, x1:x1 + vw])
        np.testing.assert_array_equal(T.imrescale(src, (int(sw * f), int(sh * f))),
                                      JT.imrescale(src, (int(sw * f), int(sh * f))))


def test_nearest_window_resize_matches_cv2():
    rng = np.random.RandomState(1)
    for _ in range(40):
        sh, sw = rng.randint(3, 300), rng.randint(3, 300)
        f = rng.uniform(0.3, 2.5)
        rh, rw = max(1, int(sh * f + 0.5)), max(1, int(sw * f + 0.5))
        seg = rng.randint(0, 125, (sh, sw)).astype(np.uint8)
        ref = cv2.resize(seg, (rw, rh), interpolation=cv2.INTER_NEAREST)
        y1, x1 = rng.randint(0, rh), rng.randint(0, rw)
        vh, vw = rng.randint(1, rh - y1 + 1), rng.randint(1, rw - x1 + 1)
        np.testing.assert_array_equal(T.label_window(seg, rh, rw, y1, x1, vh, vw),
                                      ref[y1:y1 + vh, x1:x1 + vw])


def test_bgr2hsv_matches_cv2():
    """Every (b, g, r) with b in 0..255 step 3, every g and r (5.6 M pixels)."""
    b, g, r = np.meshgrid(np.arange(0, 256, 3), np.arange(256), np.arange(256), indexing="ij")
    img = np.stack([b, g, r], -1).astype(np.uint8).reshape(-1, 512, 3)
    np.testing.assert_array_equal(T.bgr2hsv(img), cv2.cvtColor(img, cv2.COLOR_BGR2HSV))


@pytest.mark.parametrize("width", [256, 31, 53, 480])
def test_hsv2bgr_matches_cv2(width):
    """cv2 truncates in the 32-pixel blocks of a row and rounds in its tail:
    256 and 480 are all blocks, 31 all tail, 53 a block and a tail. Every
    (h, s) pair with v in 0..255 step 5 (2.4 M pixels)."""
    h, s, v = np.meshgrid(np.arange(180), np.arange(256), np.arange(0, 256, 5), indexing="ij")
    hsv = np.stack([h, s, v], -1).astype(np.uint8).reshape(-1, 3)
    hsv = np.concatenate([hsv, hsv[:(-len(hsv)) % width]]).reshape(-1, width, 3)
    np.testing.assert_array_equal(T.hsv2bgr(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR))


def test_hsv2bgr_factors_are_rounded_once():
    """1 − s·f and 1 − s·(1 − f) of each (h, s) byte pair equal the exact
    value rounded once to f32 (``fmaf``): in 64-bit-mantissa long double the
    product of two f32 values is exact and so is 1 minus it (its bits span
    below 2^-59 at most), so one cast to f32 rounds once."""
    assert np.finfo(np.longdouble).nmant >= 63, "needs x87 long double"
    _, _, _, factors = T._hsv_tables()
    h = np.arange(256, dtype=np.float32) * (np.float32(6.0) / np.float32(180.0))
    f = h - np.floor(h)
    s = np.arange(256, dtype=np.float32) * (np.float32(1.0) / np.float32(255.0))
    for k, frac in ((2, f), (3, np.float32(1.0) - f)):
        exact = 1 - s[None, :].astype(np.longdouble) * frac[:, None].astype(np.longdouble)
        np.testing.assert_array_equal(factors[k], exact.astype(np.float32))


def test_photometric_distortion_matches_jax():
    rng = np.random.RandomState(2)
    for seed in range(40):
        h, w = [(37, 53), (16, 32), (21, 95), (7, 31), (48, 64)][seed % 5]
        imgs = [rng.randint(0, 256, (h, w, 3)).astype(np.uint8) for _ in range(2)]
        r1, r2 = np.random.RandomState(seed), np.random.RandomState(seed)
        want = JT.photometric_distortion_clip([im.copy() for im in imgs], r1)
        got = T.photometric_distortion_clip([im.copy() for im in imgs], r2)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        assert r1.randint(1 << 30) == r2.randint(1 << 30)
        np.testing.assert_array_equal(T.draw_pmd_params(np.random.RandomState(seed)),
                                      JT.draw_pmd_params(np.random.RandomState(seed)))


def test_clip_transforms_match_jax():
    """random_scale_clip, random_crop_clip, random_flip_clip and pad_clip on
    whole frames, with the same draws."""
    rng = np.random.RandomState(3)
    for seed in range(6):
        imgs = [rng.randint(0, 256, (60, 90, 3)).astype(np.uint8) for _ in range(2)]
        segs = [rng.randint(0, 6, (60, 90)).astype(np.uint8) for _ in range(2)]
        r1, r2 = np.random.RandomState(seed), np.random.RandomState(seed)
        outs = []
        for mod, r in ((JT, r1), (T, r2)):
            a, b = mod.random_scale_clip(imgs, segs, r, (90, 60))
            a, b = mod.random_crop_clip(a, b, r, (50, 50))
            a, b, _ = mod.random_flip_clip(a, b, r)
            outs.append(mod.pad_clip(a, b, (56, 56)))
        for x, y in zip(outs[0][0] + outs[0][1], outs[1][0] + outs[1][1]):
            np.testing.assert_array_equal(x, y)
        assert r1.randint(1 << 30) == r2.randint(1 << 30)


def _batches(loader, n):
    it = iter(loader)
    try:
        return [next(it) for _ in range(n)]
    finally:
        it.close()


@pytest.mark.parametrize("workers", [0, 2])
def test_train_loader_batches_equal_the_jax_loader(root, workers):
    jl = JaxTrainLoader(JaxDataset(root, "train", **GEOM), 2, seed=5, num_workers=workers,
                        device_normalize=True)
    pl = TrainLoader(VSPWVideoDataset(root, "train", **GEOM), 2, seed=5, num_workers=workers,
                     device_normalize=True, device="cpu")
    for want, got in zip(_batches(jl, 3), _batches(pl, 3)):
        assert isinstance(got["imgs"], torch.Tensor) and got["imgs"].dtype == torch.uint8
        assert got["labels"].dtype == torch.int32 and got["imgs"].shape == (2, 4, 64, 64, 3)
        np.testing.assert_array_equal(got["imgs"].numpy(), want["imgs"])
        np.testing.assert_array_equal(got["labels"].numpy(), want["labels"])
        assert got["videos"] == want["videos"]


def test_train_loader_shards_split_as_jax(root):
    for shards in (2, 3):
        for sid in range(shards):
            jl = JaxTrainLoader(JaxDataset(root, "train", **GEOM), 1, seed=9,
                                shard_id=sid, num_shards=shards)
            pl = TrainLoader(VSPWVideoDataset(root, "train", **GEOM), 1, seed=9,
                             shard_id=sid, num_shards=shards, device="cpu")
            js, ps = jl._index_stream(), pl._index_stream()
            assert [next(ps) for _ in range(6)] == [next(js) for _ in range(6)]


def test_train_loader_refuses_the_process_mode_and_a_missing_card(root):
    """The process mode is accepted now (its batches are held below); an
    unknown mode and a missing card are refused."""
    ds = VSPWVideoDataset(root, "train", **GEOM)
    assert TrainLoader(ds, 2, worker_mode="process", device="cpu").worker_mode == "process"
    with pytest.raises(ValueError, match="worker_mode"):
        TrainLoader(ds, 2, worker_mode="fork", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            TrainLoader(ds, 2)


def _loader_segments() -> list[str]:
    """This process's loaders' shared-memory segments (``vssl_<pid>_...``)."""
    return [f for f in os.listdir("/dev/shm") if f.startswith(f"vssl_{os.getpid()}_")]


def test_process_workers_give_the_thread_batches_and_clean_up(root):
    ds, before = VSPWVideoDataset(root, "train", **GEOM), set(multiprocessing.active_children())
    make = lambda mode, workers: TrainLoader(ds, 2, seed=5, num_workers=workers,
                                             worker_mode=mode, device_normalize=True,
                                             device="cpu")
    got = _batches(make("process", 2), 3)
    assert set(multiprocessing.active_children()) <= before and _loader_segments() == []
    for want in (_batches(make("thread", 2), 3), _batches(make("thread", 0), 3)):
        for a, b in zip(got, want):
            assert torch.equal(a["imgs"], b["imgs"]) and torch.equal(a["labels"], b["labels"])
            assert a["videos"] == b["videos"]


def test_process_worker_errors_reach_the_consumer(root, tmp_path):
    ds, before = VSPWVideoDataset(root, "train", **GEOM), set(multiprocessing.active_children())
    ds.data_root = str(tmp_path / "gone")  # every frame's file is missing in the workers
    with pytest.raises(FileNotFoundError, match="gone"):
        _batches(TrainLoader(ds, 2, num_workers=2, worker_mode="process", device="cpu"), 1)
    assert set(multiprocessing.active_children()) <= before and _loader_segments() == []
