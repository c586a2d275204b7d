"""PyTorch port, entry points: ``inference_segmentor`` against the JAX
package's, the eval transforms, configs and overrides, the device rule, and
that the port imports nothing of JAX."""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import few_threads  # noqa: F401 (the module's fixture)
from torch_port_common import jax_config, port_config, port_weights
from vss_cffm_tpu.apis import SegmentorBundle as JaxBundle
from vss_cffm_tpu.apis import inference_segmentor as jax_inference_segmentor
from vss_cffm_tpu.config import DataConfig, ExperimentConfig
from vss_cffm_tpu.data import transforms as jax_transforms
from vss_cffm_tpu.models.segmentor import CFFMSegmentor as JaxSegmentor
from vss_cffm_tpu.models.segmentor import build_model_config as jax_build_model_config
from vss_cffm_tpu_torch import apis, config as pcfg
from vss_cffm_tpu_torch.data import transforms as port_transforms

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.usefixtures("few_threads")


def test_inference_segmentor_matches_jax():
    """128×128 uint8 frames with img_scale (128, 128): the keep-ratio factor
    is 1 and 128 is a /32 multiple, so both pipelines feed the network the
    same normalised clip. f32 on both sides; masks may differ only at exact
    (or f32-rounding) ties of the argmax, hence ≥ 99.5% agreement."""
    jcfg = jax_config("b0", num_classes=7, depth=1)
    jm = JaxSegmentor(jcfg)
    variables, state_dict = port_weights(jcfg, seed=5)
    exp = ExperimentConfig(model=jcfg, data=DataConfig(crop_size=(128, 128),
                                                       img_scale=(128, 128)))
    jb = JaxBundle(jm, variables["params"], variables["batch_stats"], exp)
    frames = [np.random.RandomState(10 + i).randint(0, 256, (128, 128, 3)).astype(np.uint8)
              for i in range(4)]
    want = np.asarray(jax_inference_segmentor(jb, frames))

    pb = apis.init_segmentor(port_config(jcfg), state_dict, device="cpu", dtype=torch.float32,
                             img_scale=(128, 128))
    got = apis.inference_segmentor(pb, frames)
    assert got.dtype == torch.int64 and tuple(got.shape) == want.shape == (128, 128)
    agree = (got.numpy() == want).mean()
    assert agree >= 0.995, agree
    # tensors are taken as well as numpy arrays
    got_t = apis.inference_segmentor(pb, [torch.from_numpy(f) for f in frames])
    torch.testing.assert_close(got_t, got, rtol=0, atol=0)


def test_init_segmentor_from_an_experiment_config():
    """A config path and an ``ExperimentConfig`` (each of which the port
    refused before: a ``KeyError`` and an ``AttributeError``) build the
    CFFM++-B1 finetune model with ``img_scale`` from ``cfg.data`` and the
    bundle carries the config; ``bf16=False`` computes in f32; an explicit
    keyword wins over the config; the image config builds an
    ``ImageSegmentor``; a ``SegmentorConfig`` and a variant name still work."""
    from vss_cffm_tpu.config import load_config as jax_load_config
    from vss_cffm_tpu_torch.models import CFFMSegmentor, ImageSegmentor

    name = "cffm_b1_vspw_finetune_40k.py"
    path = os.path.join(REPO, "vss_cffm_tpu_torch", "configs", name)
    jcfg = jax_load_config(os.path.join(REPO, "configs", name))
    b = apis.init_segmentor(path, device="cpu")
    assert isinstance(b.model, CFFMSegmentor) and b.model.decode_head.finetune
    assert b.img_scale == tuple(jcfg.data.img_scale) == (853, 480)
    assert b.cfg == pcfg.load_config(path) and b.config == b.cfg.model
    assert (b.config.backbone, b.model.backbone.compute_dtype) == ("mit_b1", torch.bfloat16)
    b = apis.init_segmentor(pcfg.load_config(path), device="cpu")
    assert b.model.decode_head.finetune and b.img_scale == (853, 480)
    exp = dataclasses.replace(pcfg.load_config(path), bf16=False,
                              model=pcfg.build_model_config("b0"),
                              data=pcfg.DataConfig(img_scale=(96, 64)))
    b = apis.init_segmentor(exp, device="cpu")
    assert (b.img_scale, b.model.decode_head.compute_dtype) == ((96, 64), torch.float32)
    assert b.cfg is exp and b.config.backbone == "mit_b0"
    b = apis.init_segmentor(exp, device="cpu", img_scale=(128, 128), dtype=torch.bfloat16)
    assert (b.img_scale, b.model.decode_head.compute_dtype) == ((128, 128), torch.bfloat16)
    b = apis.init_segmentor(os.path.join(REPO, "vss_cffm_tpu_torch", "configs",
                                         "segformer_b0_image.py"), device="cpu")
    assert isinstance(b.model, ImageSegmentor) and b.config.arch == "image"
    assert b.cfg.data.dilation == () and b.config.backbone == "mit_b0"
    for form in ("b0", pcfg.build_model_config("b0")):
        b = apis.init_segmentor(form, device="cpu")
        assert isinstance(b.model, CFFMSegmentor) and b.cfg is None
        assert b.img_scale == (853, 480)


def test_inference_segmentor_takes_frame_paths(tmp_path):
    """Frame paths (PNG, read as BGR) give the mask of the same frames as
    arrays, for a clip and for one frame."""
    from PIL import Image

    b = apis.init_segmentor("b0", device="cpu", dtype=torch.float32, img_scale=(96, 64))
    rng = np.random.RandomState(2)
    frames = [rng.randint(0, 256, (64, 96, 3)).astype(np.uint8) for _ in range(4)]
    paths = []
    for i, f in enumerate(frames):
        paths.append(str(tmp_path / f"{i}.png"))
        Image.fromarray(f[..., ::-1]).save(paths[-1])
    want = apis.inference_segmentor(b, frames)
    torch.testing.assert_close(apis.inference_segmentor(b, paths), want, rtol=0, atol=0)
    torch.testing.assert_close(apis.inference_segmentor(b, paths[-1]),
                               apis.inference_segmentor(b, frames[-1]), rtol=0, atol=0)


@pytest.mark.parametrize("hw,scale", [((128, 128), (128, 128)), ((480, 853), (853, 480)),
                                      ((60, 90), (96, 64)), ((37, 55), (853, 480))])
def test_aligned_size_matches_jax(hw, scale):
    frame = np.zeros((*hw, 3), np.uint8)
    (want,), _ = jax_transforms.aligned_resize_clip([frame], None, scale)
    out = port_transforms.aligned_resize_clip(torch.from_numpy(frame)[None], scale)
    assert tuple(out.shape[1:3]) == want.shape[:2]
    assert out.dtype == torch.float32


def test_normalize_matches_jax(rng):
    frames = [rng.randint(0, 256, (9, 13, 3)).astype(np.uint8) for _ in range(2)]
    want = np.stack(jax_transforms.normalize_clip(frames))
    got = port_transforms.normalize_clip(torch.from_numpy(np.stack(frames)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("variant", ["b0", "b1", "b2", "b5"])
def test_port_config_matches_jax(variant):
    want = jax_build_model_config(variant)
    got = pcfg.build_model_config(variant)
    assert got.backbone == want.backbone
    assert got.block_impl == want.block_impl
    for f in dataclasses.fields(pcfg.MiTConfig):
        if f.name != "block_impl":
            assert getattr(got.backbone_config, f.name) == getattr(want.backbone_config, f.name)
    for f in ("in_channels", "embed_dim", "num_classes", "num_clips", "dropout_ratio"):
        if hasattr(got.head, f):
            assert getattr(got.head, f) == getattr(want.head, f), f
    for f in dataclasses.fields(pcfg.CFFMDecoderConfig):
        assert getattr(got.head.decoder, f.name) == getattr(want.head.decoder, f.name), f.name


def test_overrides_reject_short_tuples():
    cfg = pcfg.build_model_config("b1")
    with pytest.raises(ValueError, match="has 2 entries; the field has 4"):
        pcfg.apply_overrides(cfg, ["block_impl=fused,fused"])
    assert pcfg.apply_overrides(cfg, ["block_impl=,fused,,"]).block_impl == (
        None, "fused", None, None)
    assert pcfg.apply_overrides(cfg, ["block_impl=fused"]).block_impl == "fused"
    out = pcfg.apply_overrides(cfg, ["head.decoder.depth=4", "head.num_classes=19"])
    assert (out.head.decoder.depth, out.head.num_classes) == (4, 19)


def test_device_rule():
    """Entry points run on the card unless the caller asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the rule under test is its absence")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        apis.init_segmentor("b0")
    b = apis.init_segmentor("b0", device="cpu", dtype=torch.float32)
    assert next(b.model.parameters()).device.type == "cpu"


_IMPORT_CHECK = r"""
import ast, importlib, importlib.util, pkgutil, sys
import vss_cffm_tpu_torch as pkg
walked = []
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
    walked.append(m.name)
print("WALKED", " ".join(walked))
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)  # defines only; its main runs under __main__
bad = sorted(n for n in sys.modules
             if n in ("jax", "flax", "vss_cffm_tpu", "cv2")
             or n.startswith(("jax.", "flax.", "vss_cffm_tpu.", "cv2.")))
tree = ast.parse(open(sys.argv[1]).read())
for node in ast.walk(tree):
    names = ([a.name for a in node.names] if isinstance(node, ast.Import)
             else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
    bad += [n for n in names if n.split(".")[0] in ("jax", "flax", "vss_cffm_tpu", "cv2")]
print("BAD", bad)
"""


def test_port_and_chip_smoke_import_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", _IMPORT_CHECK,
                        os.path.join(REPO, "chip_smoke.py")],
                       capture_output=True, text=True, cwd=REPO, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "BAD []" in r.stdout, r.stdout
    walked = r.stdout.split("WALKED", 1)[1].split()
    for name in ("models.losses", "train.optim", "train.state", "train.step",
                 "ops.ce_upsampled", "tools.train", "data.loader",
                 "configs.cffm_b1_vspw_160k", "configs.cffm_b0_vspw_gene_prototype",
                 "configs.cffm_b1_vspw_finetune_40k", "ops.kmeans", "models.cluster_head",
                 "eval.prototypes", "tools.generate_prototypes", "tools.test",
                 "configs.segformer_b0_image", "demo.image_demo", "demo.video_demo"):
        assert f"vss_cffm_tpu_torch.{name}" in walked, name
