"""PyTorch port, the image model (SegFormer, ``arch="image"``) against the JAX
package: a JAX ``ImageSegmentor`` (MiT-B0, a head 32 wide, 5 classes) with
perturbed weights carried by ``state_dict_from_jax``; its logits (f32, within
1e-4 of the largest); ``ClipEvaluator`` whole and slide on a fake VSPW tree
of 64×96 frames with ``dilation=()`` against the JAX evaluator (masks may
differ only at f32-rounding ties of the argmax: ≥ 99.5 % agreement);
``inference_segmentor``; a SegFormer ``.pth`` of the reference's names
loaded back bit-equal; the test CLI on the image config; and the paths the
JAX package cannot run on an image model (TTA, streaming, training), which
raise."""

from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fixtures import make_fake_vspw
from test_heads_segmentor import TINY_HEAD
from torch_port_common import few_threads  # noqa: F401 (the module's fixture)
from torch_port_common import (EVAL_HW, EVAL_SCALE, mask_agreement, perturbed_variables,
                               port_config, write_config)
from vss_cffm_tpu.apis import SegmentorBundle as JaxBundle
from vss_cffm_tpu.apis import inference_segmentor as jax_inference_segmentor
from vss_cffm_tpu.config import DataConfig as JaxDataConfig
from vss_cffm_tpu.config import ExperimentConfig as JaxExperimentConfig
from vss_cffm_tpu.data import VSPWVideoDataset as JaxDataset
from vss_cffm_tpu.eval import ClipEvaluator as JaxClipEvaluator
from vss_cffm_tpu.models.mit import MIT_VARIANTS
from vss_cffm_tpu.models.segmentor import ImageSegmentor as JaxImageSegmentor
from vss_cffm_tpu.models.segmentor import SegmentorConfig as JaxSegmentorConfig
from vss_cffm_tpu_torch import apis
from vss_cffm_tpu_torch.config import DataConfig, ExperimentConfig, OptimConfig
from vss_cffm_tpu_torch.data import VSPWVideoDataset
from vss_cffm_tpu_torch.eval import ClipEvaluator, StreamingVideoEvaluator
from vss_cffm_tpu_torch.models import ImageSegmentor, build_segmentor
from vss_cffm_tpu_torch.utils import state_dict_from_jax

pytestmark = pytest.mark.usefixtures("few_threads")

CLASSES = 5
SLIDE_CROP, SLIDE_STRIDE = (64, 64), (32, 32)  # two crops of a 64x96 frame


@pytest.fixture(scope="module")
def models():
    """(JAX image segmentor, its variables, the port model on the same
    weights in eval mode)."""
    jcfg = JaxSegmentorConfig(
        backbone="mit_b0", arch="image",
        head=dataclasses.replace(TINY_HEAD, in_channels=tuple(MIT_VARIANTS["mit_b0"].embed_dims)))
    jm = JaxImageSegmentor(jcfg)
    variables = perturbed_variables(jm, np.zeros((1, *EVAL_HW, 3), np.float32), seed=3)
    pm = build_segmentor(port_config(jcfg))
    assert isinstance(pm, ImageSegmentor)
    pm.load_state_dict(state_dict_from_jax(variables, jcfg), strict=True)
    return jm, variables, pm.eval()


@pytest.fixture(scope="module")
def vspw_root(tmp_path_factory):
    return make_fake_vspw(str(tmp_path_factory.mktemp("vspw")), hw=EVAL_HW, num_classes=CLASSES,
                          frames_per_video=6)


def test_image_segmentor_matches_jax(models):
    jm, variables, pm = models
    x = np.random.RandomState(7).randn(2, *EVAL_HW, 3).astype(np.float32)
    want = np.asarray(jax.jit(jm.apply, static_argnums=2)(variables, jnp.asarray(x), False))
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, EVAL_HW[0] // 4, EVAL_HW[1] // 4, CLASSES)
    err = np.abs(got - want).max()
    assert err <= 1e-4 * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("mode", ["whole", "slide"])
def test_clip_evaluator_on_the_image_model_matches_jax(models, vspw_root, mode):
    """One frame an item (``dilation=()``); the evaluators feed the model the
    target frame."""
    jm, variables, pm = models
    jds = JaxDataset(vspw_root, "val", dilation=(), img_scale=EVAL_SCALE)
    ds = VSPWVideoDataset(vspw_root, "val", dilation=(), img_scale=EVAL_SCALE)
    kw = dict(mode=mode, crop_size=SLIDE_CROP, stride=SLIDE_STRIDE)
    want = {}
    JaxClipEvaluator(jm, variables["params"], variables["batch_stats"], CLASSES, **kw).run(
        [jds.get_test_item(i, normalize=False) for i in range(len(jds))], dataset=jds,
        on_pred=lambda item, p: want.__setitem__(item["index"], np.asarray(p)))
    got = {}
    ev = ClipEvaluator(pm, CLASSES, device="cpu", **kw)
    ev.run((ds.get_test_item(i) for i in range(len(ds))), dataset=ds,
           on_pred=lambda meta, p: got.__setitem__(meta["index"], p))
    assert ds.get_test_item(0)["imgs"].shape[0] == 1
    assert mask_agreement(want, got) >= 0.995
    assert ev.confusion.sum() == sum(int((ds.load_gt(i) < CLASSES).sum()) for i in range(len(ds)))


def test_inference_segmentor_on_the_image_model_matches_jax(models):
    """One frame, and a list whose last frame is the target: an image model
    sees that frame alone."""
    jm, variables, pm = models
    exp = JaxExperimentConfig(model=jm.config, data=JaxDataConfig(img_scale=EVAL_SCALE,
                                                                   dilation=()))
    jb = JaxBundle(jm, variables["params"], variables["batch_stats"], exp)
    rng = np.random.RandomState(11)
    frames = [rng.randint(0, 256, (*EVAL_HW, 3)).astype(np.uint8) for _ in range(2)]
    want = np.asarray(jax_inference_segmentor(jb, frames[1]))
    pb = apis.init_segmentor(pm.config, pm.state_dict(), device="cpu", dtype=torch.float32,
                             img_scale=EVAL_SCALE)
    got = apis.inference_segmentor(pb, frames[1])
    assert tuple(got.shape) == want.shape == EVAL_HW
    assert (got.numpy() == want).mean() >= 0.995
    torch.testing.assert_close(apis.inference_segmentor(pb, frames), got, rtol=0, atol=0)


def test_segformer_pth_loads_bit_equal(models, tmp_path):
    """A reference SegFormer checkpoint (mmcv's ``state_dict`` entry, a DDP
    ``module.`` prefix, mmseg's unused ``conv_seg``) through
    ``init_segmentor(checkpoint=...)``; a checkpoint without the head raises."""
    _, _, pm = models
    sd = {f"module.{k}": v.clone() for k, v in pm.state_dict().items()}
    sd["module.decode_head.conv_seg.weight"] = torch.zeros(CLASSES, 32, 1, 1)
    sd["module.decode_head.conv_seg.bias"] = torch.zeros(CLASSES)
    path = str(tmp_path / "segformer.pth")
    torch.save({"state_dict": sd, "meta": {}}, path)
    b = apis.init_segmentor(pm.config, device="cpu", dtype=torch.float32, checkpoint=path,
                            seed=99)
    got = b.model.state_dict()
    assert sorted(got) == sorted(pm.state_dict())
    for k, v in pm.state_dict().items():
        assert torch.equal(got[k], v), k
    torch.save({k: v for k, v in sd.items() if "linear_pred" not in k}, path)
    with pytest.raises(KeyError, match="lacks 2 weights"):
        apis.init_segmentor(pm.config, device="cpu", checkpoint=path)


def test_tta_streaming_and_training_refuse_the_image_model(models, vspw_root, tmp_path):
    from vss_cffm_tpu_torch.tools import train as train_cli
    from vss_cffm_tpu_torch.train import build_optimizer, make_train_step

    _, _, pm = models
    ds = VSPWVideoDataset(vspw_root, "val", dilation=(), img_scale=EVAL_SCALE)
    with pytest.raises(ValueError, match="arch='image'"):
        ClipEvaluator(pm, CLASSES, device="cpu").predict_tta(ds.get_test_item_tta(0))
    with pytest.raises(ValueError, match="arch='image'"):
        StreamingVideoEvaluator(pm, CLASSES, device="cpu")
    opt, sched = build_optimizer(pm, OptimConfig())
    with pytest.raises(ValueError, match="arch='image'"):
        make_train_step(pm, opt, sched)
    cfg = ExperimentConfig(model=pm.config, data=DataConfig(data_root=vspw_root, dilation=()))
    with pytest.raises(ValueError, match="arch='image'"):
        train_cli.train(cfg, work_dir=str(tmp_path / "w"), device="cpu")
    with pytest.raises(ValueError, match="arch='cffm'"):
        ImageSegmentor(dataclasses.replace(pm.config, arch="cffm"))
    with pytest.raises(ValueError, match="expected one of"):
        dataclasses.replace(pm.config, arch="video")


def test_test_cli_on_the_image_config(models, vspw_root, tmp_path):
    """``tools.test`` on an image config and a SegFormer ``.pth``:
    ``--format-only --show`` writes one palette PNG and one overlay a frame;
    the confusion equals ``ClipEvaluator``'s on the same model."""
    from PIL import Image

    from vss_cffm_tpu_torch.tools import test as test_cli

    _, _, pm = models
    ckpt = str(tmp_path / "segformer.pth")
    torch.save({"state_dict": pm.state_dict()}, ckpt)
    cfg_path = write_config(tmp_path / "image_cfg.py", ExperimentConfig(
        model=pm.config, bf16=False, data=DataConfig(data_root=vspw_root, img_scale=EVAL_SCALE,
                                                     dilation=(), num_workers=2)))
    show_dir = str(tmp_path / "sub")
    out = test_cli.main([cfg_path, ckpt, "--device", "cpu", "--format-only", "--show",
                         "--show-dir", show_dir, "--no-eval"])
    ds = VSPWVideoDataset(vspw_root, "val", dilation=(), img_scale=EVAL_SCALE)
    ev = ClipEvaluator(pm, CLASSES, device="cpu")
    ev.run((ds.get_test_item(i) for i in range(len(ds))), dataset=ds)
    np.testing.assert_array_equal(out["confusion"], ev.confusion)
    video = ds.videos[0]
    for d in (show_dir, show_dir + "_vis"):
        names = sorted(os.listdir(os.path.join(d, video)))
        assert names == [f.replace(".jpg", ".png") for f in ds.frames[video]], d
    with Image.open(os.path.join(show_dir + "_vis", video, names[0])) as im:
        assert im.size == EVAL_HW[::-1] and im.mode == "RGB"


def test_demos_write_their_overlays(models, tmp_path):
    """``demo.image_demo`` on the image config (the image itself) and on a
    clip config (the image repeated as a still clip of ``len(dilation) + 1``
    frames), ``demo.video_demo`` on four frame paths: each writes the
    overlay of the mask it returns, an RGB image of the frame's size."""
    from PIL import Image

    from vss_cffm_tpu_torch.config import build_model_config
    from vss_cffm_tpu_torch.demo import image_demo, video_demo

    _, _, pm = models
    rng = np.random.RandomState(5)
    frames = []
    for i in range(4):
        frames.append(str(tmp_path / f"{i}.png"))
        Image.fromarray(rng.randint(0, 256, (*EVAL_HW, 3)).astype(np.uint8)).save(frames[-1])
    data = DataConfig(img_scale=EVAL_SCALE)
    image_cfg = write_config(tmp_path / "image.py", ExperimentConfig(
        model=pm.config, data=dataclasses.replace(data, dilation=()), bf16=False))
    image_ckpt = str(tmp_path / "image.pth")
    torch.save({"state_dict": pm.state_dict()}, image_ckpt)
    clip_cfg = write_config(tmp_path / "clip.py", ExperimentConfig(
        model=build_model_config("b0", num_classes=CLASSES), data=data, bf16=False))
    clip_model = build_segmentor(build_model_config("b0", num_classes=CLASSES))
    clip_model.init_weights(torch.Generator().manual_seed(0))
    clip_ckpt = str(tmp_path / "clip.pth")
    torch.save({"state_dict": clip_model.state_dict()}, clip_ckpt)
    runs = [
        (image_demo, [frames[0], image_cfg, image_ckpt], apis.init_segmentor(
            image_cfg, checkpoint=image_ckpt, device="cpu"), frames[0]),
        (image_demo, [frames[0], clip_cfg, clip_ckpt], apis.init_segmentor(
            clip_cfg, checkpoint=clip_ckpt, device="cpu"), [frames[0]] * 4),
        (video_demo, [clip_cfg, clip_ckpt, *frames], apis.init_segmentor(
            clip_cfg, checkpoint=clip_ckpt, device="cpu"), frames),
    ]
    for i, (demo, argv, bundle, imgs) in enumerate(runs):
        out = str(tmp_path / f"overlay{i}.png")
        seg = demo.main([*argv, "--out", out, "--device", "cpu"])
        np.testing.assert_array_equal(seg, apis.inference_segmentor(bundle, imgs).numpy())
        with Image.open(out) as im:
            assert im.mode == "RGB" and im.size == EVAL_HW[::-1]
            overlay = np.asarray(im)[..., ::-1]
        np.testing.assert_array_equal(overlay, apis.show_result(frames[-1] if demo is video_demo
                                                                else frames[0], seg))
