"""PyTorch port, the native host data path (``vss_cffm_tpu_torch/native``,
built here by g++ with its codecs) on the CPU:

- each of the 14 bindings equal bit for bit to ``vss_cffm_tpu.native``'s of
  the same name, on inputs made from a numpy seed (JPEGs and palette PNGs
  written with PIL);
- the pixel half against the port's numpy functions: the window resizes
  (flipped, and from a band of label rows), BGR↔HSV at row widths with and
  without a 32-pixel tail, the photometric distortion;
- ``decode_jpeg`` against PIL at qualities 75 / 90 / 95 with 4:4:4, 4:2:2
  and 4:2:0 subsampling, ``decode_label`` against PIL;
- the native train item (fused JPEG route, and the pixel-half route that a
  host without the codecs takes) against the port's numpy route and the JAX
  item, at 10 seeds × 3 videos, both flips and crops larger than the resized
  frame: bit for bit (with ``normalize=True`` against ``normalize_f32`` of the
  numpy route's uint8 item, as the numpy route divides by std);
- test items, ``load_gt`` and prototype items against the numpy route;
- a build whose compiler fails raises with its output; without g++
  ``available()`` is False and items take the numpy route; a dataset that
  overrides ``read_frame`` keeps its frames.
"""

from __future__ import annotations

import io

import numpy as np
import pytest
from PIL import Image

from fixtures import make_fake_vspw
from vss_cffm_tpu import native as jax_native
from vss_cffm_tpu.data.vspw import VSPWVideoDataset as JaxDataset
from vss_cffm_tpu_torch import native
from vss_cffm_tpu_torch.data import VSPWVideoDataset
from vss_cffm_tpu_torch.data import transforms as T
from vss_cffm_tpu_torch.data import vspw

PAD_GEOM = dict(crop_size=(80, 112), img_scale=(96, 64))  # crops pad below ratio ~1.3
MEAN, STD = np.array(T.IMG_MEAN, np.float32), np.array(T.IMG_STD, np.float32)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    if not native.available() or not native.codecs():
        pytest.skip("the port's native library or its codecs did not build here")
    return make_fake_vspw(str(tmp_path_factory.mktemp("vspw")),
                          videos=("vid_a", "vid_b", "vid_c"), frames_per_video=13, hw=(64, 96))


def _jpeg(img_bgr: np.ndarray, quality: int = 90, subsampling: int = 2) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(img_bgr[..., ::-1])).save(
        buf, format="JPEG", quality=quality, subsampling=subsampling)
    return buf.getvalue()


def _png(label: np.ndarray) -> bytes:
    im = Image.fromarray(label)
    im.putpalette([v for k in range(256) for v in (k, k, k)])
    buf = io.BytesIO()
    im.save(buf, format="PNG")
    return buf.getvalue()


def _binding_cases(rng):
    """{binding: [(args, kwargs), ...]} shared by the port and the JAX call."""
    img = rng.randint(0, 256, (45, 67, 3)).astype(np.uint8)
    lab = rng.randint(0, 125, (45, 67)).astype(np.uint8)
    frames = [np.roll(img, 5 * i, axis=1) for i in range(3)]
    jpegs, png = [_jpeg(f) for f in frames], _png(lab)
    lut = vspw._LUT_REDUCE
    pmd = np.stack([T.draw_pmd_params(np.random.RandomState(s)) for s in range(3)])
    geo = (45, 67, 80, 119, 7, 11, 64, 96)  # sh, sw, rh, rw, y1, x1, ch, cw (pads cols)
    return {
        "decode_jpeg": [((jpegs[0],), {})],
        "normalize_f32": [((img, MEAN, STD), {"to_rgb": r}) for r in (True, False)],
        "jpeg_dims": [((jpegs[1],), {})],
        "decode_label": [((png, lut), {}), ((png, vspw._LUT_IDENTITY), {})],
        "resize_window": [((img, 80, 119, 7, 11, 50, 60), {"flip": f}) for f in (False, True)]
        + [((img, 30, 44, 0, 3, 30, 41), {})],
        "train_clip": [((jpegs, *geo), {"flip": f}) for f in (False, True)],
        "train_clip_v2": [((jpegs, *geo, f, pmd), {}) for f in (False, True)]
        + [((jpegs, *geo, False, None), {})],
        "pmd_apply": [((img.copy(), p), {}) for p in pmd],
        "cvt_hsv": [((img,), {"inverse": i}) for i in (False, True)],
        "label_window": [((lab, 80, 119, 7, 11, 50, 60), {"flip": f}) for f in (False, True)]
        + [((lab[10:40], 80, 119, 20, 0, 40, 100), {"src_row0": 10, "sh": 45})],
        "label_window_rows": [((45, 80, 7, 50), {}), ((45, 30, 0, 30), {})],
        "decode_label_band": [((png, lut, 3, 30), {}), ((png, lut, 0, 44), {})],
        "png_dims": [((png,), {}), ((jpegs[0],), {})],
        "decode_clip_normalized": [((jpegs, 45, 67, MEAN, STD), {"to_rgb": r})
                                   for r in (True, False)],
    }


@pytest.mark.parametrize("name", sorted(_binding_cases(np.random.RandomState(0))))
def test_bindings_equal_the_jax_bindings(name, root):
    if not jax_native.available():
        pytest.skip("the JAX package's native library did not build here")
    for args, kw in _binding_cases(np.random.RandomState(0))[name]:
        copy = lambda a: [x.copy() if isinstance(x, np.ndarray) else x for x in a]
        got = getattr(native, name)(*copy(args), **kw)
        want = getattr(jax_native, name)(*copy(args), **kw)
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)
        else:
            assert got == want


def test_pixel_half_equals_the_numpy_functions(root):
    rng = np.random.RandomState(1)
    for case in range(12):
        sh, sw = rng.randint(5, 120), rng.randint(5, 160)
        f = rng.uniform(0.3, 2.5)
        rh, rw = max(1, int(sh * f + 0.5)), max(1, int(sw * f + 0.5))
        y1, x1 = rng.randint(0, rh), rng.randint(0, rw)
        vh, vw = rng.randint(1, rh - y1 + 1), rng.randint(1, rw - x1 + 1)
        img = rng.randint(0, 256, (sh, sw, 3)).astype(np.uint8)
        seg = rng.randint(0, 125, (sh, sw)).astype(np.uint8)
        want = T.resize_window(img, rh, rw, y1, x1, vh, vw)
        np.testing.assert_array_equal(native.resize_window(img, rh, rw, y1, x1, vh, vw), want)
        np.testing.assert_array_equal(
            native.resize_window(img, rh, rw, y1, x1, vh, vw, flip=True), want[:, ::-1])
        want = T.label_window(seg, rh, rw, y1, x1, vh, vw)
        np.testing.assert_array_equal(native.label_window(seg, rh, rw, y1, x1, vh, vw), want)
        lo, hi = native.label_window_rows(sh, rh, y1, vh)
        np.testing.assert_array_equal(
            native.label_window(seg[lo:hi + 1], rh, rw, y1, x1, vh, vw, True, src_row0=lo,
                                sh=sh), want[:, ::-1])
    for width in (31, 53, 64, 97):  # tail only, block + tail, blocks only, 3 blocks + tail
        img = rng.randint(0, 256, (23, width, 3)).astype(np.uint8)
        hsv = T.bgr2hsv(img)
        np.testing.assert_array_equal(native.cvt_hsv(img), hsv)
        hsv[..., 0] %= 180
        np.testing.assert_array_equal(native.cvt_hsv(hsv, inverse=True), T.hsv2bgr(hsv))
        for seed in range(6):
            p = T.draw_pmd_params(np.random.RandomState(seed))
            np.testing.assert_array_equal(native.pmd_apply(img.copy(), p), T.pmd_apply(img, p))


def test_decodes_equal_pil(root, tmp_path, monkeypatch):
    """``decode_jpeg`` against ``load_image`` on PIL's route, and
    ``decode_label`` against ``load_label`` there."""
    rng = np.random.RandomState(2)
    img = rng.randint(0, 256, (60, 94, 3)).astype(np.uint8)
    img = (0.5 * img + 0.5 * np.roll(img, 3, axis=0)).astype(np.uint8)  # some structure
    lab = rng.randint(0, 125, (60, 94)).astype(np.uint8)
    files = {}
    for q in (75, 90, 95):
        for sub in (0, 1, 2):
            files[q, sub] = tmp_path / f"q{q}_s{sub}.jpg"
            files[q, sub].write_bytes(_jpeg(img, q, sub))
    (tmp_path / "label.png").write_bytes(_png(lab))
    got = {k: native.decode_jpeg(p.read_bytes()) for k, p in files.items()}
    seg = native.decode_label((tmp_path / "label.png").read_bytes(), vspw._LUT_REDUCE)
    monkeypatch.setattr(native, "available", lambda: False)
    for k, p in files.items():
        np.testing.assert_array_equal(got[k], vspw.load_image(str(p)),
                                      err_msg=f"quality, subsampling {k}")
    np.testing.assert_array_equal(seg, vspw.load_label(str(tmp_path / "label.png")))


def _numpy_item(ds, idx, seed, normalize, monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(native, "available", lambda: False)
        return ds.get_train_item(idx, np.random.RandomState(seed), normalize)


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("route", ["fused", "pixel"])
def test_native_train_items_equal_numpy_and_jax(root, route, normalize, monkeypatch):
    """``fused``: the codec route (``train_clip_v2``); ``pixel``: codecs taken
    away, PIL decodes and the pixel half resizes, flips and distorts."""
    if route == "pixel":
        monkeypatch.setattr(native, "codecs", lambda: ())
    seen = []  # (the crop pads, the clip is flipped) of each native clip

    def spy(fn, read):
        orig = getattr(native, fn)

        def wrapped(*a, **k):
            seen.append(read(*a, **k))
            return orig(*a, **k)
        monkeypatch.setattr(native, fn, wrapped)

    if route == "fused":
        spy("train_clip_v2", lambda bufs, sh, sw, rh, rw, y1, x1, ch, cw, flip, pmd:
            (rh - y1 < ch or rw - x1 < cw, flip))
    else:
        spy("resize_window", lambda src, rh, rw, y1, x1, vh, vw, flip=False:
            (vh < 80 or vw < 112, flip))
    jds, ds = JaxDataset(root, "train", **PAD_GEOM), VSPWVideoDataset(root, "train", **PAD_GEOM)
    for seed in range(10):
        for idx in range(3):
            got = ds.get_train_item(idx, np.random.RandomState(seed), normalize)
            if jax_native.available():
                want = jds.get_train_item(idx, np.random.RandomState(seed), normalize)
                np.testing.assert_array_equal(got["imgs"], want["imgs"])
                np.testing.assert_array_equal(got["labels"], want["labels"])
            plain = _numpy_item(ds, idx, seed, False, monkeypatch)
            np.testing.assert_array_equal(got["labels"], plain["labels"])
            assert (got["video"], got["frame"]) == (plain["video"], plain["frame"])
            if normalize:  # the pad is 0.0, which no normalised pixel is
                pad = (got["imgs"] == 0).all(-1, keepdims=True)
                norm = native.normalize_f32(plain["imgs"].reshape(-1, 112, 3), MEAN, STD)
                np.testing.assert_array_equal(got["imgs"],
                                              np.where(pad, 0, norm.reshape(got["imgs"].shape)))
            else:
                np.testing.assert_array_equal(got["imgs"], plain["imgs"])
    assert {f for _, f in seen} == {False, True} and {p for p, _ in seen} == {False, True}


def test_test_items_gt_and_prototypes_equal_the_numpy_route(root, monkeypatch):
    ds = VSPWVideoDataset(root, "val")
    proto = VSPWVideoDataset(root, "train_val_generate_prototype", img_scale=(120, 80))
    got = [ds.get_test_item(i) for i in (0, 5, 12)], [ds.load_gt(i) for i in (0, 5, 12)]
    got_p = proto.get_prototype_item(1, 4)
    monkeypatch.setattr(native, "available", lambda: False)
    want = [ds.get_test_item(i) for i in (0, 5, 12)], [ds.load_gt(i) for i in (0, 5, 12)]
    for a, b in zip(got[0], want[0]):
        np.testing.assert_array_equal(a["imgs"], b["imgs"])
        assert a["ori_shape"] == b["ori_shape"] and a["frame"] == b["frame"]
    for a, b in zip(got[1], want[1]):
        np.testing.assert_array_equal(a, b)
    frames = proto._clip(proto.sample_prototype_clip(1, 4))
    resized = [vspw._resized(vspw._resized(f, (80, 120)), (96, 128)) for f in frames]
    monkeypatch.undo()
    want_p = np.stack([native.normalize_f32(f, MEAN, STD) for f in resized])
    np.testing.assert_array_equal(got_p["imgs"], want_p)


def test_failed_build_raises_and_no_compiler_takes_numpy(root, tmp_path, monkeypatch):
    ds = VSPWVideoDataset(root, "train", **PAD_GEOM)
    want = ds.get_train_item(1, np.random.RandomState(3), False)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "CXXFLAGS", native.CXXFLAGS + ("-fno-such-option",))
    for lib_state in ("_lib", "_info"):
        monkeypatch.setattr(native, lib_state, None)
    with pytest.raises(RuntimeError, match="no-such-option"):
        native.available()
    assert not list(tmp_path.iterdir())  # the failed build left no file
    monkeypatch.setattr(native, "CXX", "no-such-compiler-g++")
    assert native.available() is False and native.codecs() == ()
    assert native.build_info()["compiler"] is None
    got = ds.get_train_item(1, np.random.RandomState(3), False)  # the numpy route
    np.testing.assert_array_equal(got["imgs"], want["imgs"])
    np.testing.assert_array_equal(got["labels"], want["labels"])


class _Inverted(VSPWVideoDataset):
    """Frames read as 255 − the file's: a dataset with frames of its own."""

    def read_frame(self, video, frame):
        return 255 - super().read_frame(video, frame)


def test_an_overriding_dataset_keeps_its_frames(root, monkeypatch):
    ds, base = _Inverted(root, "train", **PAD_GEOM), VSPWVideoDataset(root, "train", **PAD_GEOM)
    got = ds.get_train_item(2, np.random.RandomState(4), False)
    other = base.get_train_item(2, np.random.RandomState(4), False)
    want = _numpy_item(ds, 2, 4, False, monkeypatch)
    np.testing.assert_array_equal(got["imgs"], want["imgs"])
    np.testing.assert_array_equal(got["labels"], want["labels"])
    assert not np.array_equal(got["imgs"], other["imgs"])
