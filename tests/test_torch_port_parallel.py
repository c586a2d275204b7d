"""PyTorch port, data parallelism over processes (``vss_cffm_tpu_torch.parallel``)
on the CPU: 2 gloo ranks, spawned once with a free port on localhost (2 torch
threads each; a rank imports ``torch_port_ranks``, which imports no JAX),
against the port's one-process run on the global batch:

- the fuse BN in training across the ranks against the one-process BN on the
  concatenated batch: output, input gradient and the parameters' gradients
  (summed over the ranks) within 1e-5 of each tensor's largest value (those
  of the per-channel constants before the BN, zero but for rounding, within
  1e-5 of the largest gradient: ``torch_port_ranks.grads_close``); the
  running statistics within 1e-6;
- one default train step (MiT-B0 widths at 64×64, 124 classes, f32, drop
  path 0.1 in the backbone and the decoder, head dropout 0.1, default CE),
  one clip a rank, from the same generator seed: loss, accuracy and gradient
  norm within a relative 1e-5, every gradient within 1e-5 of its tensor's
  largest value (those before the fuse BN as above), the running statistics
  within 1e-6; the two ranks' parameters after the step bitwise equal;
- the same with OHEM at a threshold of 0 and a small ``min_kept``, so that
  the global k-th probability sets the mask and keeps 15-40 % of the
  pixels: the OHEM weights equal the one-process weights exactly; and
  ``_ohem_from_gt_prob`` on the rows of a fixed probability map equal to the
  one-process map's exactly;
- ``aggregate_confusion`` over the ranks with counts past 2³¹, exact;
- ``ClipEvaluator`` on frame shards and ``StreamingVideoEvaluator`` on video
  shards, aggregated, equal to the one-process confusions exactly;
- ``clip_lovasz_loss`` refuses several ranks;
- the test CLI (``tools/test.py``) per clip on the 2 ranks, over their
  group: its JSON metrics equal the one-process CLI's, its confusion the
  one process's exactly; ``tools/dist_test.sh`` hands the CLI to torchrun
  with ``--distributed`` for N > 1 and runs it plainly for N = 1 (its
  command, read through ``PYTHON=echo``);
- the training launcher: ``tools/dist_train.sh`` with 2 ranks on the CPU
  for 2 steps (the checkpoint written once, each ``iter [k/2]`` line once),
  started before the ranks above and run beside them;
- ``--distributed`` without a rank environment raises, naming what is
  missing.

The 2-rank step against the JAX step is in ``test_torch_port_train.py``,
which holds the JAX step's compile.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_port_ranks as ranks
from fixtures import make_fake_vspw
from torch_port_common import few_threads  # noqa: F401 (the module's fixture)
from vss_cffm_tpu_torch import parallel
from vss_cffm_tpu_torch.apis import init_segmentor
from vss_cffm_tpu_torch.models import CFFMSegmentor
from vss_cffm_tpu_torch.models.heads import MLPDecodeHead
from vss_cffm_tpu_torch.tools import test as test_cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (64, 64)
B = 2
CLASSES = 124
OPTIM = dict(lr=1e-3, warmup_iters=0, max_iters=100)
OHEM = dict(use_ohem=True, ohem_thresh=0.0, ohem_min_kept=900)
EVAL_SCALE = (96, 64)  # the fake tree's 64×96 frames, at their own size


pytestmark = pytest.mark.usefixtures("few_threads")


def _batch(seed: int = 3) -> dict:
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, CLASSES, (B, 4, *HW)).astype(np.uint8)
    labels[rng.rand(*labels.shape) < 0.05] = 255
    return {"imgs": rng.randint(0, 256, (B, 4, *HW, 3)).astype(np.uint8), "labels": labels}


def _weights(cfg, seed: int = 0) -> dict:
    model = CFFMSegmentor(cfg)
    model.init_weights(torch.Generator().manual_seed(seed))
    return model.state_dict()


@pytest.fixture(scope="module")
def launch_files(tmp_path_factory):
    """A fake VSPW tree (2 videos of 10 frames of 64×96), a tiny experiment
    config on it (``LAUNCH_CONFIG``) and a ``.pth`` of that config's model
    from seed 0: (config path, tree, checkpoint, directory)."""
    d = tmp_path_factory.mktemp("launch")
    root = make_fake_vspw(str(d / "vspw"), frames_per_video=10, hw=(64, 96))
    path = str(d / "tiny.py")
    with open(path, "w") as f:
        f.write(LAUNCH_CONFIG.format(root=root))
    pth = str(d / "tiny.pth")
    torch.save({"state_dict": init_segmentor(path, device="cpu", seed=0).model.state_dict()},
               pth)
    return path, root, pth, d


@pytest.fixture(scope="module")
def inputs(launch_files):
    """The inputs of every case, the same for the ranks and the one process."""
    rng = np.random.RandomState(5)
    cfg, cfg_ohem = ranks.tiny_config(), ranks.tiny_config(OHEM)
    weights = _weights(cfg)
    batch = _batch()
    head = MLPDecodeHead(cfg.head)
    with torch.no_grad():
        for p in head.parameters():
            p.copy_(torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32)) * 0.1)
    chans = cfg.head.in_channels
    feats = [(rng.standard_normal((4, 8 >> i, 8 >> i, c)) * (i + 1) + i).astype(np.float32)
             for i, c in enumerate(chans)]
    gt_prob = rng.rand(4, 16, 16).astype(np.float32)
    valid = rng.rand(4, 16, 16) > 0.1
    matrices = []
    for r in range(2):
        cm = rng.randint(0, 2**40, (CLASSES, CLASSES), dtype=np.int64)
        cm[r, r] = 2**31 + 7 + r
        cm[2, 3] = 2**61 - 1 - r
        matrices.append(cm)
    d = launch_files[3]
    root = make_fake_vspw(str(d / "eval"), frames_per_video=6, hw=EVAL_SCALE[::-1])
    return {
        "train": dict(cfg=cfg, state_dict=weights, batch=batch, optim=OPTIM),
        "ohem": dict(cfg=cfg_ohem, state_dict=weights, batch=batch, optim=OPTIM,
                     record_ohem=True),
        "bn": dict(head_cfg=cfg.head, state_dict=head.state_dict(), feats=feats,
                   cotangent=rng.standard_normal((4, 8, 8, cfg.head.embed_dim)
                                                 ).astype(np.float32)),
        "ohem_map": dict(gt_prob=gt_prob, valid=valid, thresh=0.0, min_kept=150),
        "matrices": matrices,
        "evaluation": dict(cfg=cfg, state_dict=weights, root=root, img_scale=EVAL_SCALE),
        "cli": [launch_files[0], launch_files[2], "--device", "cpu", "--out",
                str(d / "two.json"), *CLI_OPTIONS],
    }


@pytest.fixture(scope="module")
def world(inputs, training_launch):
    """Every case on 2 gloo ranks (``torch_port_ranks.cases``), one start,
    while ``training_launch`` runs."""
    return parallel.spawn(ranks.cases, 2, *inputs.values(), device="cpu")


def _rows(x: torch.Tensor, r: int) -> torch.Tensor:
    return parallel.shard_batch(x, r, 2)


def test_sync_bn_matches_the_global_batch(world, inputs):
    one = ranks.decode_bn("cpu", **inputs["bn"])
    for r, res in enumerate(w["bn"] for w in world):
        ranks.close_to_largest(res["out"], _rows(one["out"], r), 1e-5, f"out, rank {r}")
        for i, (dx, want) in enumerate(zip(res["dx"], one["dx"])):
            ranks.close_to_largest(dx, _rows(want, r), 1e-5, f"input {i} grad, rank {r}")
        ranks.grads_close(res["grads"], one["grads"], f"grad, rank {r}")
        for got, want in zip(res["bn"], one["bn"]):
            torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def _steps_match(res: dict, one: dict) -> None:
    for got, want in zip(res["metrics"], one["metrics"]):
        for k in ("loss_seg", "acc_seg", "grad_norm"):
            assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k]), (k, got[k], want[k])
    for got, want in zip(res["grads"], one["grads"]):
        ranks.grads_close(got, want, "grad")
    for got, want in zip(res["bn"], one["bn"]):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_two_rank_train_step_matches_one_process(world, inputs):
    one = ranks.train_steps("cpu", **inputs["train"])
    res0, res1 = (w["train"] for w in world)
    _steps_match(res0, one)
    for name, p in res0["params"].items():
        assert torch.equal(p, res1["params"][name]), name
    assert res0["metrics"] == res1["metrics"]


def test_two_rank_ohem_step_matches_one_process(world, inputs):
    one = ranks.train_steps("cpu", **inputs["ohem"])
    _steps_match(world[0]["ohem"], one)
    assert len(one["ohem"]) == 2  # the per-frame and the refined branch
    for r, res in enumerate(w["ohem"] for w in world):
        for got, want in zip(res["ohem"], one["ohem"]):
            assert torch.equal(got, _rows(want, r))
    for want in one["ohem"]:
        assert 0.15 <= want.mean().item() <= 0.4, want.mean().item()


def test_ohem_threshold_is_the_global_batchs(world, inputs):
    one = ranks.ohem_weights("cpu", **inputs["ohem_map"])
    assert 0.2 < one.mean().item() < 0.8
    for r, w in enumerate(world):
        assert torch.equal(w["ohem_map"], _rows(one, r))
    # a rank's own k-th probability would keep another mask
    alone = ranks.ohem_weights("cpu", **{**inputs["ohem_map"],
                                        "gt_prob": inputs["ohem_map"]["gt_prob"][:2],
                                        "valid": inputs["ohem_map"]["valid"][:2]})
    assert not torch.equal(alone, _rows(one, 0))


def test_aggregate_confusion_sums_the_ranks_exactly(world, inputs):
    want = inputs["matrices"][0] + inputs["matrices"][1]
    assert want.max() > 2**61
    for w in world:
        assert w["confusion"].dtype == np.int64
        np.testing.assert_array_equal(w["confusion"], want)


def test_sharded_evaluators_sum_to_the_one_process_confusion(world, inputs):
    one = ranks.evaluate("cpu", **inputs["evaluation"])
    assert one["clip"].sum() > 0
    for w in world:
        for kind in ("clip", "streamed"):
            np.testing.assert_array_equal(w["eval"][kind], one[kind])


def test_lovasz_refuses_several_ranks(world):
    for w in world:
        assert "2 ranks" in w["lovasz"] and "Lovász" in w["lovasz"]


def test_distributed_without_a_rank_environment_raises(monkeypatch, tmp_path):
    for k in parallel.RANK_ENV:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="rank environment.*missing: RANK"):
        parallel.init_distributed("cpu")
    with pytest.raises(RuntimeError, match=r"missing: --num-processes, --process-id"):
        parallel.init_distributed("cpu", coordinator="127.0.0.1:1")
    assert not torch.distributed.is_initialized()


# ---- the launchers -------------------------------------------------------------

LAUNCH_CONFIG = """
from vss_cffm_tpu_torch.config import (CFFMDecoderConfig, CFFMHeadConfig, DataConfig,
                                       ExperimentConfig, MIT_VARIANTS, OptimConfig,
                                       SegmentorConfig)


def config():
    head = CFFMHeadConfig(in_channels=tuple(MIT_VARIANTS["mit_b0"].embed_dims), embed_dim=32,
                          num_classes=124, num_clips=4,
                          decoder=CFFMDecoderConfig(dim=32, depth=1, num_heads=2))
    return ExperimentConfig(
        model=SegmentorConfig(backbone="mit_b0", head=head),
        optim=OptimConfig(lr=1e-3, max_iters=2, warmup_iters=0),
        data=DataConfig(data_root={root!r}, crop_size=(64, 64), img_scale=(96, 64),
                        batch_size=2, num_workers=0),
        checkpoint_interval=2, log_interval=1, bf16=False, seed=1)
"""


CLI_OPTIONS = ["--options", "data.img_scale=96,64", "data.num_workers=0"]


def _env() -> dict:
    env = {**os.environ, "PORT": str(parallel.free_port()), "PYTHON": sys.executable,
           "OMP_NUM_THREADS": str(ranks.THREADS)}
    for k in parallel.RANK_ENV:
        env.pop(k, None)
    return env


def _script(name: str) -> str:
    return os.path.join(REPO, "vss_cffm_tpu_torch", "tools", name)


@pytest.fixture(scope="module")
def training_launch(launch_files):
    """``dist_train.sh`` with 2 CPU ranks for 2 steps on the fake tree (one
    clip a rank), started here and left to run: (process, work dir, log)."""
    path, _, _, d = launch_files
    work, log = str(d / "work"), str(d / "train.log")
    with open(log, "w") as f:
        proc = subprocess.Popen(["bash", _script("dist_train.sh"), path, "2", "--device", "cpu",
                                 "--work-dir", work], env=_env(), stdout=f,
                                stderr=subprocess.STDOUT, text=True)
    yield proc, work, log
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def test_dist_train_launcher_two_ranks(training_launch):
    proc, work, log = training_launch
    assert proc.wait(timeout=600) == 0, open(log).read()[-5000:]
    with open(log) as f:
        text = f.read()
    assert sorted(os.listdir(os.path.join(work, "ckpt"))) == ["ckpt_2.pt", "metadata_2.json"]
    assert text.count("saved checkpoint at iter 2") == 1, text[-3000:]
    for k in (1, 2):
        assert text.count(f"iter [{k}/2]") == 1, text[-3000:]
    assert "rank 0 of 2, 1 of the 2 clips a step" in text


def test_dist_test_launcher_matches_one_process(world, inputs, launch_files, tmp_path):
    """Per clip (frame shards); the video shards of ``--streaming`` are held in
    ``test_sharded_evaluators_sum_to_the_one_process_confusion``."""
    path, _, pth, _ = launch_files
    one_json = str(tmp_path / "one.json")
    one = test_cli.main([path, pth, "--device", "cpu", "--out", one_json, *CLI_OPTIONS])
    assert one["confusion"].sum() > 0
    for w in world:
        np.testing.assert_array_equal(w["test_cli"]["confusion"], one["confusion"])
    two_json = inputs["cli"][inputs["cli"].index("--out") + 1]
    with open(one_json) as f, open(two_json) as g:
        want, got = json.load(f), json.load(g)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    env = {**_env(), "PYTHON": "echo", "PORT": "29622"}
    runs = {n: subprocess.run(["bash", _script("dist_test.sh"), path, pth, n, "--device", "cpu"],
                              env=env, capture_output=True, text=True, check=True).stdout.split()
            for n in ("1", "2")}
    cli = ["-m", "vss_cffm_tpu_torch.tools.test", path, pth]
    assert runs["1"] == [*cli, "--device", "cpu"]
    assert runs["2"] == ["-m", "torch.distributed.run", "--nproc_per_node", "2",
                         "--master_port", "29622", *cli, "--distributed", "--device", "cpu"]
