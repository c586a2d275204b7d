"""PyTorch port, evaluation metrics against the JAX package's on the same
inputs: the confusion update (labels 255 and C dropped), the metrics to the
last bit, the class table text, VC, the int64 digit split."""

from __future__ import annotations

import contextlib
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vss_cffm_tpu.eval import metrics as jm
from vss_cffm_tpu_torch.data.palette import VSPW_CLASSES
from vss_cffm_tpu_torch.eval import metrics as pm

C = 7


@contextlib.contextmanager
def _quiet():
    """nan means of empty or all-nan rows warn on both sides."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        yield


def _frame(seed: int, shape=(37, 53)):
    """pred in [0, C), labels in [0, C) with ~10 % 255 and ~5 % C."""
    rng = np.random.RandomState(seed)
    pred = rng.randint(0, C, shape)
    label = rng.randint(0, C, shape)
    label[rng.rand(*shape) < 0.1] = 255
    label[rng.rand(*shape) < 0.05] = C
    return pred, label


def test_update_confusion_matches_jax_and_numpy():
    cm = torch.zeros((C, C), dtype=torch.int64)
    jcm = jnp.zeros((C, C), jnp.int32)
    ref = np.zeros((C, C), np.int64)
    for seed in range(3):
        pred, label = _frame(seed)
        cm = pm.update_confusion(cm, torch.from_numpy(pred), torch.from_numpy(label), C)
        jcm = jm.update_confusion(jcm, jnp.asarray(pred), jnp.asarray(label), C)
        ref += pm.confusion_matrix_np(pred, label, C)
    assert cm.dtype == torch.int64
    np.testing.assert_array_equal(cm.numpy(), np.asarray(jcm))
    np.testing.assert_array_equal(cm.numpy(), ref)
    np.testing.assert_array_equal(ref, sum(jm.confusion_matrix_np(*_frame(s), C)
                                           for s in range(3)))
    valid = sum(int(((_frame(s)[1] >= 0) & (_frame(s)[1] < C)).sum()) for s in range(3))
    assert int(cm.sum()) == valid
    # uint8 labels, as load_gt gives them
    pred, label = _frame(5)
    got = pm.update_confusion(torch.zeros((C, C), dtype=torch.int64), torch.from_numpy(pred),
                              torch.from_numpy(label.astype(np.uint8)), C)
    np.testing.assert_array_equal(got.numpy(), pm.confusion_matrix_np(pred, label, C))


def _matrices():
    rng = np.random.RandomState(7)
    cm = rng.randint(0, 1000, (C, C)).astype(np.int64)
    absent = cm.copy()
    absent[2] = 0       # class 2 never in the GT
    absent[:, 2] = 0    # nor predicted: nan IoU and Acc
    absent[4] = 0       # class 4 predicted but never in the GT
    return [cm, absent, np.zeros((C, C), np.int64)]


@pytest.mark.parametrize("which", [0, 1, 2], ids=["full", "absent_classes", "empty"])
def test_metrics_match_jax_bitwise(which):
    cm = _matrices()[which]
    with _quiet():
        got, want = pm.eval_metrics(cm), jm.eval_metrics(cm)
        assert sorted(got) == sorted(want)
        for k in ("aAcc", "mIoU", "mAcc", "Acc", "IoU"):
            np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(pm.mean_iou_seen(cm), jm.mean_iou_seen(cm))
        np.testing.assert_array_equal(pm.fwiou(cm), jm.fwiou(cm))


def test_class_table_text_matches_jax():
    cm = _matrices()[1]
    with _quiet():
        assert pm.format_class_table(cm) == jm.format_class_table(cm)
        names = list(VSPW_CLASSES[:C])
        assert pm.format_class_table(cm, names) == jm.format_class_table(cm, names)


def test_video_consistency_matches_jax():
    rng = np.random.RandomState(9)
    gts = [rng.randint(0, 3, (12, 9)) for _ in range(20)]
    preds = [np.where(rng.rand(12, 9) < 0.8, g, rng.randint(0, 3, (12, 9))) for g in gts]
    gts[5][:] = np.arange(12 * 9).reshape(12, 9)  # a window with no static GT pixel: nan
    for n in (8, 16):
        got, want = pm.video_consistency(gts, preds, n), jm.video_consistency(gts, preds, n)
        assert len(got) == len(want) == 20 - n
        np.testing.assert_array_equal(np.asarray(got, np.float64), np.asarray(want, np.float64))
        assert np.isnan(got).any()


def test_int64_split_round_trip_above_2_31():
    rng = np.random.RandomState(11)
    parts = []
    total = np.zeros((C, C), np.int64)
    for _ in range(3):
        cm = rng.randint(0, 2**40, (C, C), dtype=np.int64)
        cm[0, 0] = 2**31 + 5
        cm[1, 1] = 2**61 - 1
        total += cm
        split = pm._split_int64(cm)
        assert split.dtype == np.int32 and split.shape == (2, C, C)
        np.testing.assert_array_equal(split, jm._split_int64(cm))
        np.testing.assert_array_equal(pm._merge_int64(split), cm)
        parts.append(split)
    np.testing.assert_array_equal(pm._merge_int64(np.stack(parts)), total)
    np.testing.assert_array_equal(pm._merge_int64(np.stack(parts)),
                                  jm._merge_int64(np.stack(parts)))


def test_aggregate_confusion_is_one_process_only(monkeypatch):
    """The identity in one process; in a group of 2 ranks (faked here: its
    all-reduce adds the other rank's matrix) one int64 all-reduce, exact
    past 2³¹ (the 2-rank gloo run is in ``test_torch_port_parallel.py``)."""
    cm = _matrices()[0]
    cm[0, 0] = 2**40 + 3
    np.testing.assert_array_equal(pm.aggregate_confusion(cm), cm)
    other = np.full_like(cm, 2**31 + 1)
    seen = []

    def all_reduce(t):
        seen.append(t.dtype)
        t += torch.from_numpy(other)

    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    monkeypatch.setattr(torch.distributed, "get_backend", lambda: "gloo")
    monkeypatch.setattr(torch.distributed, "all_reduce", all_reduce)
    got = pm.aggregate_confusion(cm)
    assert got.dtype == np.int64 and seen == [torch.int64]
    np.testing.assert_array_equal(got, cm + other)
