"""PyTorch port, video evaluation against the JAX package on a fake VSPW
tree (frames of 64×96, ``img_scale`` (96, 64): neither side resizes): the
test sampler, items and ground truth, ``ClipEvaluator`` (whole) and
``StreamingVideoEvaluator`` against JAX's on the same weights in f32 (masks
may differ only at f32-rounding ties of the argmax: ≥ 99.5 % agreement, as
``test_torch_port_apis.py`` holds ``inference_segmentor``), the port's
streamed confusion equal to its clip confusion, the summary's keys, the
palette PNG, the shape census and ``show_result``. Slide mode is held in
``test_torch_port_inference.py``."""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch
from PIL import Image

from fixtures import make_fake_vspw
from torch_port_common import EVAL_CLASSES, EVAL_HW, EVAL_SCALE, eval_models, mask_agreement
from vss_cffm_tpu.apis import show_result as jax_show_result
from vss_cffm_tpu.data import VSPWVideoDataset as JaxDataset
from vss_cffm_tpu.eval import ClipEvaluator as JaxClipEvaluator
from vss_cffm_tpu.eval import save_pred_png as jax_save_pred_png
from vss_cffm_tpu.eval.census import eval_shape_census as jax_census
from vss_cffm_tpu.eval.evaluator import StreamingVideoEvaluator as JaxStreaming
from vss_cffm_tpu_torch import apis
from vss_cffm_tpu_torch.data import VSPWVideoDataset, iterate_eval
from vss_cffm_tpu_torch.eval import (ClipEvaluator, StreamingVideoEvaluator, eval_shape_census,
                                     save_pred_png)


@pytest.fixture(scope="module")
def vspw_root(tmp_path_factory):
    return make_fake_vspw(str(tmp_path_factory.mktemp("vspw")), hw=EVAL_HW,
                          num_classes=EVAL_CLASSES)


@pytest.fixture(scope="module")
def models():
    return eval_models()


@pytest.fixture(scope="module")
def datasets(vspw_root):
    return (JaxDataset(vspw_root, "val", img_scale=EVAL_SCALE),
            VSPWVideoDataset(vspw_root, "val", img_scale=EVAL_SCALE))


@pytest.mark.parametrize("split", ["val", "train_val_generate_prototype"])
def test_samplers_match_jax(vspw_root, split):
    """Every frame's test clip (the dropped dilations of frames 0-2 and the
    schedules of frames 3-8 included) and every video's prototype clip."""
    jds = JaxDataset(vspw_root, split, img_scale=EVAL_SCALE)
    ds = VSPWVideoDataset(vspw_root, split, img_scale=EVAL_SCALE)
    assert ds.frame_index == jds.frame_index and ds.frames == jds.frames
    assert len(ds) == len(jds)
    for i in range(len(ds.frame_index)):
        got, want = ds.sample_test_clip(i), jds.sample_test_clip(i)
        assert (got.video, got.frame_indices, got.target_frame) == (
            want.video, want.frame_indices, want.target_frame)
    assert [ds.sample_test_clip(i).frame_indices for i in range(9)] == [
        [0], [1], [2], [0, 1, 2, 3], [0, 2, 3, 4], [0, 2, 4, 5], [0, 2, 4, 6], [0, 3, 5, 7],
        [0, 3, 6, 8]]
    for i in range(len(ds.videos)):
        got, want = ds.sample_prototype_clip(i), jds.sample_prototype_clip(i)
        assert (got.frame_indices, got.target_frame) == (want.frame_indices, want.target_frame)


def test_items_and_gt_match_jax(datasets):
    jds, ds = datasets
    for i in (0, 4, len(ds) - 1):
        want, got = jds.get_test_item(i, normalize=False), ds.get_test_item(i)
        assert got["imgs"].dtype == np.uint8
        np.testing.assert_array_equal(got["imgs"], want["imgs"])
        assert got["ori_shape"] == tuple(want["ori_shape"]) == EVAL_HW
        assert (got["video"], got["frame"], got["index"], got["img_scale"]) == (
            want["video"], want["frame"], want["index"], EVAL_SCALE)
        gt = ds.load_gt(i)
        np.testing.assert_array_equal(gt, jds.load_gt(i))
        assert gt.max() == 255 and gt.min() == 0
    tta, jtta = ds.get_test_item_tta(5, ratios=(0.5, 1.0)), jds.get_test_item_tta(
        5, ratios=(0.5, 1.0), normalize=False)
    assert tta["flips"] == jtta["flips"] == [False, True, False, True]
    assert tta["scales"] == [(48, 32), (48, 32), (96, 64), (96, 64)]
    np.testing.assert_array_equal(tta["imgs"], jtta["views"][2])


def _jax_masks(evaluator, jds, indices) -> dict:
    masks = {}
    evaluator.run([jds.get_test_item(i, normalize=False) for i in indices], dataset=jds,
                  on_pred=lambda item, p: masks.__setitem__(item["index"], np.asarray(p)))
    return masks


def _collect(masks: dict):
    return lambda meta, p: masks.__setitem__(meta["index"], p)


def test_clip_evaluator_matches_jax(datasets, models):
    """Whole mode over the clips of four frames (one JAX compile)."""
    jds, ds = datasets
    jm, variables, pm = models
    indices = range(3, len(ds))
    want = _jax_masks(JaxClipEvaluator(jm, variables["params"], variables["batch_stats"],
                                       EVAL_CLASSES), jds, indices)
    got = {}
    ce = ClipEvaluator(pm, EVAL_CLASSES, device="cpu")
    ce.run((ds.get_test_item(i) for i in indices), dataset=ds, on_pred=_collect(got))
    assert mask_agreement(want, got) >= 0.995
    assert ce.confusion.dtype == np.int64
    assert ce.confusion.sum() == sum(int((ds.load_gt(i) < EVAL_CLASSES).sum()) for i in indices)


def test_streaming_evaluator_matches_jax_and_its_clip_evaluator(datasets, models):
    """The streamed masks against JAX's streamed ones; the port's streamed
    confusion equal to its own clip confusion, exactly, over every frame
    (the one-frame clips of frames 0-2 included), as
    ``tests/test_streaming_eval.py`` holds the JAX pair; the summaries'
    keys equal JAX's with VC."""
    jds, ds = datasets
    jm, variables, pm = models
    want = {}
    js = JaxStreaming(jm, variables["params"], variables["batch_stats"], EVAL_CLASSES)
    jsum = js.run_streaming(jds, keep_for_vc=True,
                            on_pred=lambda m, p: want.__setitem__(m["index"], np.asarray(p)))
    got = {}
    se = StreamingVideoEvaluator(pm, EVAL_CLASSES, device="cpu")
    summary = se.run_streaming(ds, keep_for_vc=True, on_pred=_collect(got))
    assert mask_agreement(want, got) >= 0.995
    assert sorted(summary) == sorted(jsum)
    ce = ClipEvaluator(pm, EVAL_CLASSES, device="cpu")
    clip_summary = ce.run(iterate_eval(ds, num_workers=2), dataset=ds, keep_for_vc=True)
    np.testing.assert_array_equal(se.confusion, ce.confusion)
    assert clip_summary["VC8"] == summary["VC8"]
    assert summary["mIoU"] == pytest.approx(jsum["mIoU"], abs=0.02)
    # the videos filter and reset
    se.reset()
    assert se.confusion.sum() == 0
    se.run_streaming(ds, videos=["no_such_video"])
    assert se.confusion.sum() == 0


def test_save_pred_png_matches_jax(tmp_path):
    pred = np.random.RandomState(3).randint(0, 124, (17, 23))
    a, b = str(tmp_path / "jax" / "v" / "f.png"), str(tmp_path / "port" / "v" / "f.png")
    jax_save_pred_png(pred, a)
    save_pred_png(pred, b)
    with Image.open(a) as ja, Image.open(b) as pb:
        assert pb.mode == ja.mode == "P"
        np.testing.assert_array_equal(np.array(pb), np.array(ja))
        assert pb.getpalette() == ja.getpalette()
    np.testing.assert_array_equal(np.array(Image.open(b)), pred)


def test_eval_shape_census_matches_jax(datasets):
    jds, ds = datasets
    for ratios in (None, (0.5, 1.0, 1.75)):
        assert eval_shape_census(ds, ratios) == jax_census(jds, ratios)


def test_show_result_matches_jax(tmp_path):
    rng = np.random.RandomState(4)
    img = rng.randint(0, 256, (20, 30, 3)).astype(np.uint8)
    seg = rng.randint(0, 124, (20, 30))
    np.testing.assert_array_equal(apis.show_result(img, seg), jax_show_result(img, seg))
    np.testing.assert_array_equal(apis.show_result(img, torch.from_numpy(seg), opacity=0.3),
                                  jax_show_result(img, seg, opacity=0.3))
    path = os.path.join(str(tmp_path), "frame.png")  # a lossless file: both decoders agree
    Image.fromarray(img[..., ::-1]).save(path)
    np.testing.assert_array_equal(apis.show_result(path, seg), jax_show_result(path, seg))
