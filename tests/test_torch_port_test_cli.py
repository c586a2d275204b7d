"""PyTorch port, the test CLI (``vss_cffm_tpu_torch.tools.test``) on the CPU
against the JAX evaluators on the same weights, on a fake VSPW tree of
64×96 frames (``img_scale`` (96, 64): neither side resizes) with one val
video of 6 frames (one-frame clips for frames 0-2, four-frame clips after):

- a CFFM config (MiT-B0, decoder depth 1, 5 classes, f32), per clip and
  streamed, against ``ClipEvaluator`` / ``StreamingVideoEvaluator`` of the
  JAX package: masks ≥ 99.5 % equal (f32-rounding ties of the argmax), the
  confusions, aAcc and mIoU close; the CLI's confusion equal to the port's
  own evaluator's on the same bundle, exactly;
- a CFFM++ finetune config with a cluster directory, per clip against the
  JAX ``ClipEvaluator`` with the JAX ``ClusterStore``, and ``--aug-test`` on
  a 2-frame video (dilation (-1, -1, -1): the second frame's clip has four
  frames, so the cluster branch runs under TTA) against the JAX evaluator's
  ``predict_tta`` with the JAX store, whose network is the port model on
  the JAX evaluator's views and centres (a jitted JAX forward at each of
  the 12 view shapes would compile for minutes; the network itself is held
  against JAX in ``test_torch_port_cffm_pp.py``);
- ``--out`` JSON and pickle (``--efficient-test``), ``--format-only``,
  ``--shape-census``; a missing card raises, and so does ``--distributed``
  without a rank environment.
"""

from __future__ import annotations

import json
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fixtures import make_fake_vspw
from torch_port_common import few_threads  # noqa: F401 (the module's fixture)
from torch_port_common import (EVAL_CLASSES, EVAL_HW, EVAL_SCALE, eval_models, finetune_models,
                               mask_agreement, port_config, write_config)
from vss_cffm_tpu.data import VSPWVideoDataset as JaxDataset
from vss_cffm_tpu.eval import ClipEvaluator as JaxClipEvaluator
from vss_cffm_tpu.eval import ClusterStore as JaxClusterStore
from vss_cffm_tpu.eval.census import eval_shape_census as jax_census
from vss_cffm_tpu.eval.evaluator import StreamingVideoEvaluator as JaxStreaming
from vss_cffm_tpu_torch.config import DataConfig, ExperimentConfig
from vss_cffm_tpu_torch.data import VSPWVideoDataset
from vss_cffm_tpu_torch.data.vspw import TTA_RATIOS
from vss_cffm_tpu_torch.eval import ClipEvaluator
from vss_cffm_tpu_torch.tools import test as test_cli

pytestmark = pytest.mark.usefixtures("few_threads")

FRAMES = 6
TTA_DILATION = (-1, -1, -1)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_fake_vspw(str(tmp_path_factory.mktemp("vspw")), hw=EVAL_HW,
                          num_classes=EVAL_CLASSES, frames_per_video=FRAMES)


@pytest.fixture(scope="module")
def cffm(tree, tmp_path_factory):
    """(JAX model, variables, port model, config path, .pth path)."""
    jm, variables, pm = eval_models()
    d = tmp_path_factory.mktemp("cffm")
    cfg = ExperimentConfig(model=pm.config, bf16=False, data=DataConfig(
        data_root=tree, img_scale=EVAL_SCALE, num_workers=2))
    ckpt = str(d / "cffm.pth")
    torch.save({"state_dict": pm.state_dict()}, ckpt)
    return jm, variables, pm, write_config(d / "cfg.py", cfg), ckpt


def _jax_masks(run) -> dict:
    masks = {}
    run(lambda item, p: masks.__setitem__(item["index"], np.asarray(p)))
    return masks


def _pkl_masks(path: str) -> dict:
    with open(path, "rb") as f:
        masks = pickle.load(f)
    return {i: np.load(m) if isinstance(m, str) else m for i, m in enumerate(masks)}


def _held(out: dict, want_masks: dict, got_masks: dict, jev) -> None:
    assert mask_agreement(want_masks, got_masks) >= 0.995
    cm, jcm = out["confusion"], np.asarray(jev.confusion)
    assert cm.dtype == np.int64 and cm.sum() == jcm.sum()
    differ = sum(int((want_masks[i] != got_masks[i]).sum()) for i in want_masks)
    assert np.abs(cm - jcm).sum() <= 2 * differ
    jsum = jev.summary()
    for key in ("aAcc", "mIoU"):
        assert out["metrics"][key] == pytest.approx(jsum[key], abs=0.02), key


@pytest.mark.parametrize("mode", ["per_clip", "streamed"])
def test_cli_matches_the_jax_evaluators(cffm, tree, tmp_path, mode):
    jm, variables, pm, cfg_path, ckpt = cffm
    jds = JaxDataset(tree, "val", img_scale=EVAL_SCALE)
    pkl = str(tmp_path / "masks.pkl")
    if mode == "per_clip":
        argv = ["--out", pkl, "--efficient-test"]
        jev = JaxClipEvaluator(jm, variables["params"], variables["batch_stats"], EVAL_CLASSES)
        want = _jax_masks(lambda cb: jev.run(
            [jds.get_test_item(i, normalize=False) for i in range(len(jds))], dataset=jds,
            on_pred=cb))
    else:
        argv = ["--streaming", "--vc", "--out", pkl]
        jev = JaxStreaming(jm, variables["params"], variables["batch_stats"], EVAL_CLASSES)
        want = _jax_masks(lambda cb: jev.run_streaming(jds, on_pred=cb))
    out = test_cli.main([cfg_path, ckpt, "--device", "cpu", *argv])
    got = _pkl_masks(pkl)
    assert sorted(got) == list(range(FRAMES))
    _held(out, want, got, jev)
    if mode == "streamed":
        assert {"VC8", "VC16"} <= set(out["metrics"])
        return
    # the masks spilled to .npy files, the pickle holding their paths
    assert len(os.listdir(str(tmp_path / "masks_masks"))) == FRAMES
    # the CLI's confusion is the port's evaluator's on the same weights, exactly
    ds = VSPWVideoDataset(tree, "val", img_scale=EVAL_SCALE)
    ev = ClipEvaluator(pm, EVAL_CLASSES, device="cpu")
    ev.run((ds.get_test_item(i) for i in range(len(ds))), dataset=ds)
    np.testing.assert_array_equal(out["confusion"], ev.confusion)


def test_cli_outputs(cffm, tree, tmp_path, capsys):
    """``--out .json`` holds the returned metrics; ``--format-only`` writes a
    palette PNG a frame; ``--shape-census`` prints the input shapes and
    loads nothing (its checkpoint does not exist)."""
    from PIL import Image

    _, _, _, cfg_path, ckpt = cffm
    js, sub = str(tmp_path / "m.json"), str(tmp_path / "sub")
    out = test_cli.main([cfg_path, ckpt, "--device", "cpu", "--no-eval", "--out", js,
                         "--format-only", "--show-dir", sub])
    with open(js) as f:
        assert json.load(f) == out["metrics"]
    assert {"aAcc", "mIoU", "mAcc", "mIoU_seen", "FWIoU"} <= set(out["metrics"])
    ds = VSPWVideoDataset(tree, "val", img_scale=EVAL_SCALE)
    video = ds.videos[0]
    names = sorted(os.listdir(os.path.join(sub, video)))
    assert names == [f.replace(".jpg", ".png") for f in ds.frames[video]]
    with Image.open(os.path.join(sub, video, names[0])) as im:
        assert im.mode == "P" and im.size == EVAL_HW[::-1]
    capsys.readouterr()
    census = test_cli.main([cfg_path, str(tmp_path / "absent.pth"), "--shape-census",
                            "--aug-test"])["census"]
    printed = capsys.readouterr().out.strip().splitlines()
    want = jax_census(JaxDataset(tree, "val", img_scale=EVAL_SCALE),
                      tta_ratios=TTA_RATIOS)
    assert census == want and len(printed) == census["num_compiles"] > 1
    assert all(line.startswith("T=4 aligned=") for line in printed)


def test_cli_refuses_distributed_and_a_missing_card(cffm, monkeypatch):
    """``--distributed`` without a rank environment names what is missing
    (the 2-rank runs are in ``test_torch_port_parallel.py``)."""
    _, _, _, cfg_path, ckpt = cffm
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="--distributed needs a rank environment"):
        test_cli.main([cfg_path, ckpt, "--distributed", "--device", "cpu"])
    assert not torch.distributed.is_initialized()
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the rule under test is its absence")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        test_cli.main([cfg_path, ckpt])


@pytest.fixture(scope="module")
def finetune(tmp_path_factory):
    """(JAX config, JAX model, variables, port model, the cluster directory
    with 7 centres for each video, the .pth)."""
    jcfg, jm, variables, pm = finetune_models()
    d = tmp_path_factory.mktemp("finetune")
    rng = np.random.RandomState(4)
    for video in ("vid_a", "vid_b"):
        os.makedirs(d / "clusters" / video)
        np.save(d / "clusters" / video / "centers.npy",
                rng.standard_normal((7, jcfg.head.embed_dim)).astype(np.float32))
    ckpt = str(d / "finetune.pth")
    torch.save({"state_dict": pm.state_dict()}, ckpt)
    return jcfg, jm, variables, pm, str(d / "clusters"), ckpt


class _PortNetwork:
    """The JAX model's place in the JAX evaluator's TTA: ``apply`` runs the
    port model on the JAX evaluator's (normalised) views and centres."""

    def __init__(self, jm, pm):
        self.config, self.dtype, self.pm = jm.config, jnp.float32, pm

    def apply(self, variables, imgs, train, centers):
        assert not train and centers is not None
        c = tuple(torch.from_numpy(np.array(a)) for a in centers)
        with torch.no_grad():
            out = self.pm(torch.from_numpy(np.array(imgs)), cluster_centers=c)
        return jnp.asarray(out.numpy())


@pytest.mark.parametrize("mode", ["per_clip", "aug_test"])
def test_cli_on_a_finetune_config_matches_the_jax_evaluators(finetune, tree, tmp_path, mode):
    jcfg, jm, variables, pm, clusters, ckpt = finetune
    if mode == "per_clip":
        root, dilation, argv = tree, (-9, -6, -3), []
    else:
        root, dilation, argv = make_fake_vspw(str(tmp_path / "vspw2"), hw=EVAL_HW,
                                              num_classes=EVAL_CLASSES,
                                              frames_per_video=2), TTA_DILATION, ["--aug-test"]
    cfg = ExperimentConfig(model=port_config(jcfg), bf16=False, cluster_dir=clusters,
                           data=DataConfig(data_root=root, img_scale=EVAL_SCALE,
                                           dilation=dilation, num_workers=2))
    pkl = str(tmp_path / "masks.pkl")
    out = test_cli.main([write_config(tmp_path / "cfg.py", cfg), ckpt, "--device", "cpu",
                         "--out", pkl, *argv])
    jds = JaxDataset(root, "val", dilation=list(dilation), img_scale=EVAL_SCALE)
    store = JaxClusterStore(clusters)
    if mode == "per_clip":
        jev = JaxClipEvaluator(jm, variables["params"], variables["batch_stats"], EVAL_CLASSES,
                               cluster_store=store)
        items = [jds.get_test_item(i, normalize=False) for i in range(len(jds))]
    else:
        assert [len(jds.sample_test_clip(i).frame_indices) for i in range(len(jds))] == [1, 4]
        jev = JaxClipEvaluator(_PortNetwork(jm, pm), variables["params"],
                               variables["batch_stats"], EVAL_CLASSES, cluster_store=store)
        items = [jds.get_test_item_tta(i, normalize=False) for i in range(len(jds))]
    want = _jax_masks(lambda cb: jev.run(items, dataset=jds, on_pred=cb))
    _held(out, want, _pkl_masks(pkl), jev)
