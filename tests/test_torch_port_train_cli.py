"""PyTorch port, the train CLI (``vss_cffm_tpu_torch.tools.train``) on the CPU,
called in process on a ``make_fake_vspw`` tree with a tiny config (MiT-B0
widths, head and decoder at 32 channels, decoder depth 1, frames of 64×96,
``img_scale`` (96, 64), crops of 64×64, batches of 2 clips, f32):

- 2 steps with the val mIoU at ``--eval-interval 2`` and a checkpoint at 2
  holding the config; ``--resume-from`` it to step 4 (the schedule's lr at
  step 2, a profiler window of one iteration);
- ``--load-from`` a ``.pth`` of the port's ``state_dict()`` and of a
  backbone alone without prefix (an ImageNet ``head.*`` dropped);
- ``--device cuda`` without a card raises, and so does ``--distributed``
  without a rank environment (the 2-rank runs are in
  ``test_torch_port_parallel.py``);
- CFFM++: ``tools.generate_prototypes`` (phase A) from a ``.pth`` of run A's
  CFFM weights into a cluster directory, then 2 finetune steps
  (``model.head.mode=finetune``) ``--load-from`` that ``.pth`` with the
  val mIoU at step 2 through the cluster store: every frozen parameter at
  its decay alone (w·Π(1 − lr_t·wd) or w by its group), the fuse BN's
  statistics as loaded, the cluster branch moved;
- the whole slice: the JAX variables carried into the port through a
  ``.pth`` (``state_dict_from_jax``), the first batch of each package's
  loader at one seed, and the port CLI's first step's loss against the JAX
  ``make_train_step`` loss (rtol 1e-5; drop rates 0 on both sides).
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from fixtures import make_fake_vspw
from torch_port_common import few_threads  # noqa: F401 (the module's fixture)
from vss_cffm_tpu_torch.config import apply_overrides, load_config
from vss_cffm_tpu_torch.tools import generate_prototypes as proto_cli
from vss_cffm_tpu_torch.tools import train as train_cli
from vss_cffm_tpu_torch.train import poly_schedule
from vss_cffm_tpu_torch.train.optim import paramwise_multipliers

pytestmark = pytest.mark.usefixtures("few_threads")

TINY = """
from vss_cffm_tpu_torch.config import (CFFMDecoderConfig, CFFMHeadConfig, DataConfig,
                                       ExperimentConfig, MIT_VARIANTS, OptimConfig,
                                       SegmentorConfig)


def config():
    head = CFFMHeadConfig(in_channels=tuple(MIT_VARIANTS["mit_b0"].embed_dims), embed_dim=32,
                          num_classes=124, num_clips=4, dropout_ratio={dropout},
                          decoder=CFFMDecoderConfig(dim=32, depth=1, num_heads=2))
    return ExperimentConfig(
        model=SegmentorConfig(backbone="mit_b0", head=head),
        optim=OptimConfig(lr=1e-3, max_iters=2, warmup_iters=3),
        data=DataConfig(data_root={root!r}, crop_size=(64, 64), img_scale=(96, 64),
                        batch_size=2, num_workers=0),
        work_dir={work!r}, checkpoint_interval=2, log_interval=1, bf16=False, seed=1)
"""


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    # 10 frames a video: the train clip's window (dilation -9) and 10 val clips
    root = make_fake_vspw(str(tmp_path_factory.mktemp("vspw")), frames_per_video=10,
                          hw=(64, 96))
    work = str(tmp_path_factory.mktemp("work"))
    path = os.path.join(work, "tiny.py")
    with open(path, "w") as f:
        f.write(TINY.format(root=root, work=os.path.join(work, "run"), dropout=0.1))
    return root, work, path


@pytest.fixture(scope="module")
def run_a(tree):
    _, work, path = tree
    cfg = load_config(path)
    return cfg, train_cli.train(cfg, work_dir=os.path.join(work, "a"), device="cpu",
                                eval_interval=2)


def test_two_steps_write_a_checkpoint_and_evaluate(run_a, tree):
    cfg, out = run_a
    assert [s["step"] for s in out["steps"]] == [1, 2]
    for s in out["steps"]:
        assert np.isfinite([s["loss_seg"], s["acc_seg"], s["grad_norm"]]).all(), s
        assert s["grad_norm"] > 0
    assert out["state"].step == 2 and out["checkpoints"] == [2]
    ckpt = os.path.join(tree[1], "a", "ckpt")
    assert sorted(os.listdir(ckpt)) == ["ckpt_2.pt", "metadata_2.json"]
    with open(os.path.join(ckpt, "metadata_2.json")) as f:
        meta = json.load(f)
    assert meta["config"]["data"]["crop_size"] == [64, 64]
    assert meta["config"]["model"]["backbone"] == "mit_b0"
    assert len(meta["classes"]) == 124 and len(meta["palette"]) == 124
    [ev] = out["evals"]
    assert ev["step"] == 2 and 0.0 <= ev["mIoU"] <= 1.0 and np.isfinite(ev["FWIoU"])
    assert out["state"].model.training
    assert len(out["iter_ms"]) == 2


def test_resume_to_four_steps(run_a, tree, monkeypatch):
    cfg, a = run_a
    _, work, path = tree
    monkeypatch.setattr(train_cli, "PROFILE_FIRST", 1)
    monkeypatch.setattr(train_cli, "PROFILE_LAST", 1)
    prof = os.path.join(work, "prof")
    out = train_cli.main([path, "--work-dir", os.path.join(work, "b"), "--resume-from",
                          os.path.join(work, "a", "ckpt"), "--device", "cpu", "--profile-dir",
                          prof, "--options", "optim.max_iters=4"])
    assert [s["step"] for s in out["steps"]] == [3, 4]
    assert out["state"].step == 4 and out["checkpoints"] == [4]
    sched = poly_schedule(dataclasses.replace(cfg.optim, max_iters=4))
    # step 3 (it = 2) runs at the schedule's lr of 2: the restored schedule
    np.testing.assert_allclose(out["steps"][0]["lr"], sched(2), rtol=1e-12)
    np.testing.assert_allclose(out["steps"][1]["lr"], sched(3), rtol=1e-12)
    assert np.isfinite([s["loss_seg"] for s in out["steps"]]).all()
    assert out["profile"] == {"iterations": 1, "device_busy_ms": None}
    assert os.path.exists(os.path.join(prof, "trace.json"))
    assert os.path.exists(os.path.join(work, "b", "ckpt", "ckpt_4.pt"))


class _Stop(Exception):
    pass


def _weights_at_the_first_step(monkeypatch, cfg, work_dir, **kw) -> dict:
    """The model's state_dict as the loop would start (when the train step is
    made, after ``--load-from``); the run stops there."""
    seen = {}

    def capture(model, *a, **k):
        seen.update({n: v.clone() for n, v in model.state_dict().items()})
        raise _Stop

    monkeypatch.setattr(train_cli, "make_train_step", capture)
    with pytest.raises(_Stop):
        train_cli.train(cfg, work_dir=work_dir, device="cpu", **kw)
    return seen


def test_load_from_a_port_state_dict(run_a, tree, monkeypatch):
    cfg, a = run_a
    _, work, _ = tree
    sd = {k: v.clone() for k, v in a["state"].model.state_dict().items()}
    path = os.path.join(work, "whole.pth")
    torch.save({"state_dict": sd, "meta": {}}, path)
    got = _weights_at_the_first_step(monkeypatch, cfg, os.path.join(work, "c"), load_from=path)
    assert got.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(got[k], v), k


def test_load_from_a_backbone_without_prefix(run_a, tree, monkeypatch):
    cfg, a = run_a
    _, work, _ = tree
    full = a["state"].model.state_dict()
    sd = {k.removeprefix("backbone."): v.clone() for k, v in full.items()
          if k.startswith("backbone.")}
    sd["head.weight"] = torch.zeros(1000, 256)  # the ImageNet classifier, dropped
    path = os.path.join(work, "mit_b0.pth")
    torch.save(sd, path)
    got = _weights_at_the_first_step(monkeypatch, cfg, os.path.join(work, "d"), load_from=path)
    init = _weights_at_the_first_step(monkeypatch, cfg, os.path.join(work, "e"))
    for k, v in got.items():
        want = full[k] if k.startswith("backbone.") else init[k]
        assert torch.equal(v, want), k
    assert any(not torch.equal(full[k], init[k]) for k in full if k.startswith("backbone."))


def test_no_card_and_distributed_raise(tree, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, work, path = tree
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main([path, "--work-dir", os.path.join(work, "f")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main([path, "--work-dir", os.path.join(work, "f"), "--device", "cuda"])
    # --distributed without torchrun's environment or the coordinator flags
    # names what is missing, and starts no group
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="rank environment.*missing: RANK"):
        train_cli.main([path, "--distributed", "--device", "cpu"])
    with pytest.raises(RuntimeError, match="missing: --process-id"):
        train_cli.main([path, "--distributed", "--device", "cpu", "--coordinator",
                        "127.0.0.1:1", "--num-processes", "2"])
    assert not torch.distributed.is_initialized()


@pytest.fixture(scope="module")
def prototypes(run_a, tree):
    """Phase A through the CLI: a ``.pth`` of run A's CFFM weights, 6 centres
    of 4 frames a video written to a cluster directory."""
    _, work, path = tree
    ckpt = os.path.join(work, "cffm.pth")
    torch.save({"state_dict": run_a[1]["state"].model.state_dict()}, ckpt)
    cluster = os.path.join(work, "clusters")
    paths = proto_cli.main([path, ckpt, "--cluster-dir", cluster, "--n-clusters", "6",
                            "--num-frames", "4", "--device", "cpu"])
    return ckpt, cluster, paths


def test_generate_prototypes_cli_writes_each_videos_centres(prototypes, tree):
    ckpt, cluster, paths = prototypes
    # train (vid_a, vid_b), val (vid_a) and test (vid_b) lists
    assert [os.path.relpath(p, cluster) for p in paths] == [
        os.path.join(v, "centers.npy") for v in ("vid_a", "vid_b", "vid_a", "vid_b")]
    for v in ("vid_a", "vid_b"):
        c = np.load(os.path.join(cluster, v, "centers.npy"))
        assert c.dtype == np.float32 and c.shape == (6, 32) and np.isfinite(c).all()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            proto_cli.main([tree[2], ckpt, "--cluster-dir", cluster])


def test_two_finetune_steps_train_only_the_cluster_branch(prototypes, tree):
    ckpt, cluster, _ = prototypes
    _, work, path = tree
    cfg = apply_overrides(load_config(path), ["model.head.mode=finetune",
                                              f"cluster_dir={cluster}"])
    loaded = torch.load(ckpt)["state_dict"]
    out = train_cli.train(cfg, work_dir=os.path.join(work, "ft"), device="cpu",
                          load_from=ckpt, eval_interval=2)
    assert [s["step"] for s in out["steps"]] == [1, 2]
    assert all(np.isfinite([s["loss_seg"], s["grad_norm"]]).all() for s in out["steps"])
    [ev] = out["evals"]
    assert 0.0 <= ev["mIoU"] <= 1.0
    model = out["state"].model
    sched, wd = poly_schedule(cfg.optim), cfg.optim.weight_decay
    moved = set()
    for name, p in model.named_parameters():
        if name not in loaded:
            assert name.startswith(("decode_head.decoder_swin.", "decode_head.linear_pred3."))
            moved.add(name.split(".")[1])
            continue
        mult, decayed = paramwise_multipliers(name, cfg.optim.head_lr_mult)
        factor = np.prod([1 - sched(t) * mult * wd for t in (0, 1)]) if decayed else 1.0
        np.testing.assert_allclose(p.detach().numpy(), loaded[name].numpy() * factor,
                                   rtol=1e-6, atol=1e-9, err_msg=name)
    assert moved == {"decoder_swin", "linear_pred3"}
    sd = model.state_dict()
    for s in ("running_mean", "running_var"):
        key = f"decode_head.linear_fuse.bn.{s}"
        assert torch.equal(sd[key], loaded[key]), key


def test_first_step_loss_matches_the_jax_step(tree, tmp_path):
    """The whole slice against the JAX package: config, data, loader, weights
    and one train step. Drop path and head dropout 0 on both sides (their
    masks come from different generators); the JAX blocks composed, the
    port's the config's default train form (the block pair's plain version
    here)."""
    import jax
    import jax.numpy as jnp

    from torch_port_common import no_drop_path, port_config, to_jax_tree
    from vss_cffm_tpu.data.loader import TrainLoader as JaxTrainLoader
    from vss_cffm_tpu.data.vspw import VSPWVideoDataset as JaxDataset
    from vss_cffm_tpu.models.cffm_transformer import CFFMDecoderConfig as JDec
    from vss_cffm_tpu.models.heads import CFFMHeadConfig as JHead
    from vss_cffm_tpu.models.mit import MIT_VARIANTS as JMIT
    from vss_cffm_tpu.models.segmentor import CFFMSegmentor as JaxSegmentor
    from vss_cffm_tpu.models.segmentor import SegmentorConfig as JSeg
    from vss_cffm_tpu.train import optim as jax_optim
    from vss_cffm_tpu.train.state import TrainState as JaxTrainState
    from vss_cffm_tpu.train.step import make_train_step as jax_make_train_step
    from vss_cffm_tpu_torch.models import CFFMSegmentor
    from vss_cffm_tpu_torch.utils import state_dict_from_jax

    root, _, _ = tree
    path = str(tmp_path / "tiny0.py")
    with open(path, "w") as f:
        f.write(TINY.format(root=root, work=str(tmp_path / "run"), dropout=0.0))
    cfg = load_config(path)
    cfg = dataclasses.replace(cfg, optim=dataclasses.replace(cfg.optim, max_iters=1))
    jcfg = JSeg(backbone="mit_b0", train_block_impl=None, head=JHead(
        in_channels=tuple(JMIT["mit_b0"].embed_dims), embed_dim=32, num_classes=124,
        num_clips=4, dropout_ratio=0.0, decoder=JDec(dim=32, depth=1, num_heads=2)))
    with no_drop_path("b0"):
        jm = JaxSegmentor(jcfg)
        # JAX variables from a port init (the JAX init compiles for ~14 s
        # here), every leaf moved off its init; carried back through a .pth
        pm = CFFMSegmentor(port_config(jcfg))
        pm.init_weights(torch.Generator().manual_seed(3))
        noise = np.random.RandomState(4)
        variables = jax.tree_util.tree_map_with_path(
            lambda p, a: (np.abs(a + 0.02 * noise.standard_normal(a.shape)) + 0.5
                          if any(getattr(k, "key", None) == "var" for k in p)
                          else a + 0.02 * noise.standard_normal(a.shape)).astype(np.float32),
            to_jax_tree(pm, {}, jcfg))
        torch.save(state_dict_from_jax(variables, jcfg), str(tmp_path / "carried.pth"))
        jl = JaxTrainLoader(JaxDataset(root, "train", crop_size=(64, 64), img_scale=(96, 64)),
                            2, seed=cfg.seed, num_workers=0, device_normalize=True)
        it = iter(jl)
        jbatch = next(it)
        it.close()
        jopt = jax_optim.OptimConfig(**dataclasses.asdict(cfg.optim))
        jtx = jax_optim.build_optimizer(variables["params"], jopt)
        jstep = jax_make_train_step(jm, jtx, donate=False)
        _, jmetrics = jstep(JaxTrainState.create(variables, jtx),
                            {"imgs": jnp.asarray(jbatch["imgs"]),
                             "labels": jnp.asarray(jbatch["labels"])}, jax.random.PRNGKey(0))
        out = train_cli.train(cfg, work_dir=str(tmp_path / "port"), device="cpu",
                              load_from=str(tmp_path / "carried.pth"))
    [s] = out["steps"]
    np.testing.assert_allclose(s["loss_seg"], float(jmetrics["loss_seg"]), rtol=1e-5)
    assert abs(s["acc_seg"] - float(jmetrics["acc_seg"])) <= 0.01
    np.testing.assert_allclose(s["grad_norm"], float(jmetrics["grad_norm"]), rtol=1e-4)
