"""PyTorch port, the publishing and launching tools (``vss_cffm_tpu_torch/tools/``)
on the CPU:

- ``publish_model`` on a train checkpoint of a tiny config: the output is
  ``<out>-<sha8>`` of the state dict's sha256, holds the model's state and
  no optimizer or scheduler state, carries the metadata; publishing the same
  weights twice gives the same name; ``init_segmentor`` on it gives logits
  bitwise equal to the source's, and the test CLI on it the source's
  confusion exactly;
- ``bf16_dynamics --steps 4 --hw 32 --device cpu``: both trajectories
  finite, the JAX tool's lines;
- ``slurm_train.sh`` / ``slurm_test.sh`` through a stub ``srun`` on ``PATH``
  that prints its flags and runs the task's command with a Slurm task's
  environment (``scontrol`` stubbed, ``PYTHON=echo``): one task a GPU, the
  CLI with ``--distributed`` and the coordinator flags from Slurm's
  variables.
"""

from __future__ import annotations

import json
import math
import os
import subprocess

import numpy as np
import pytest
import torch

from fixtures import make_fake_vspw
from torch_port_common import few_threads, write_config  # noqa: F401 (the module's fixture)
from vss_cffm_tpu_torch import config as pcfg
from vss_cffm_tpu_torch.apis import init_segmentor
from vss_cffm_tpu_torch.data.palette import VSPW_CLASSES, VSPW_PALETTE
from vss_cffm_tpu_torch.models import CFFMSegmentor
from vss_cffm_tpu_torch.tools import bf16_dynamics, publish_model
from vss_cffm_tpu_torch.tools import test as test_cli
from vss_cffm_tpu_torch.train import CheckpointManager, TrainState

pytestmark = pytest.mark.usefixtures("few_threads")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "vss_cffm_tpu_torch", "tools")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A tiny config on a fake VSPW tree (2 videos of 6 frames of 64×96) and a
    train checkpoint of it at step 3 whose optimizer holds moments: (config
    path, checkpoint directory, tree, the model's state dict)."""
    d = tmp_path_factory.mktemp("publish")
    root = make_fake_vspw(str(d / "vspw"), frames_per_video=6, hw=(64, 96))
    head = pcfg.CFFMHeadConfig(in_channels=tuple(pcfg.MIT_VARIANTS["mit_b0"].embed_dims),
                               embed_dim=32, num_classes=124, num_clips=4,
                               decoder=pcfg.CFFMDecoderConfig(dim=32, depth=1, num_heads=1))
    cfg = pcfg.ExperimentConfig(
        model=pcfg.SegmentorConfig(backbone="mit_b0", head=head),
        data=pcfg.DataConfig(data_root=root, img_scale=(96, 64), num_workers=0), bf16=False)
    path = write_config(d / "tiny.py", cfg)
    model = CFFMSegmentor(cfg.model)
    model.init_weights(torch.Generator().manual_seed(0))
    state = TrainState.create(model, cfg.optim)
    for p in model.parameters():  # moments in the optimizer, and moved weights
        p.grad = torch.full_like(p, 1e-3)
    for _ in range(3):
        state.optimizer.step()
        state.scheduler.step()
    ckpt = str(d / "ckpt")
    CheckpointManager(ckpt).save(state, metadata={"classes": list(VSPW_CLASSES),
                                                  "palette": [list(p) for p in VSPW_PALETTE],
                                                  "config": cfg})
    return path, ckpt, root, {k: v.clone() for k, v in model.state_dict().items()}, d


def test_publish_strips_the_optimizer_and_names_by_content(trained, capsys):
    path, ckpt, _, weights, d = trained
    out = publish_model.main([ckpt, str(d / "published" / "tiny")])
    assert capsys.readouterr().out.strip() == out
    assert os.path.basename(out) == f"tiny-{publish_model.content_hash(weights)[:8]}"
    assert sorted(os.listdir(out)) == ["ckpt_0.pt", "metadata_0.json"]
    saved = torch.load(os.path.join(out, "ckpt_0.pt"), weights_only=False)
    assert set(saved) == {"step", "model"}  # no optimizer or scheduler state
    assert "optimizer" in CheckpointManager(ckpt).read()
    assert saved["model"].keys() == weights.keys()
    assert all(torch.equal(saved["model"][k], v) for k, v in weights.items())
    with open(os.path.join(ckpt, "metadata_3.json")) as f, \
            open(os.path.join(out, "metadata_0.json")) as g:
        assert json.load(g) == json.load(f)
    # the same weights, the same name (the directory is written again)
    assert publish_model.main([ckpt, str(d / "published" / "tiny")]) == out
    changed = {**weights, "decode_head.linear_pred.bias":
               weights["decode_head.linear_pred.bias"] + 1.0}
    assert publish_model.content_hash(changed) != publish_model.content_hash(weights)


def test_the_published_checkpoint_reads_as_its_source(trained, tmp_path):
    path, ckpt, root, _, d = trained
    out = publish_model.publish(ckpt, str(d / "published" / "read"))
    clip = [np.random.RandomState(i).randint(0, 256, (64, 96, 3), dtype=np.uint8)
            for i in range(4)]
    from vss_cffm_tpu_torch.apis import clip_logits

    logits = [clip_logits(init_segmentor(path, checkpoint=c, device="cpu"), clip)[0]
              for c in (ckpt, out)]
    assert torch.equal(logits[0], logits[1])
    runs = [test_cli.main([path, c, "--device", "cpu", "--out", str(tmp_path / f"{i}.json")])
            for i, c in enumerate((ckpt, out))]
    assert runs[0]["confusion"].sum() > 0
    np.testing.assert_array_equal(runs[1]["confusion"], runs[0]["confusion"])
    assert runs[1]["metrics"] == runs[0]["metrics"]


def test_bf16_dynamics_runs_both_trajectories(capsys):
    out = bf16_dynamics.main(["--steps", "4", "--hw", "32", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("steps=4 variant=b0 hw=32 device=cpu")
    assert [ln.split("]")[0] for ln in lines[1:4]] == ["loss[first10", "loss[mid    ",
                                                        "loss[last20 "]
    assert lines[4].startswith("final-step loss") and lines[5].startswith("eval mIoU")
    for run in ("f32", "bf16"):
        assert len(out[run]["losses"]) == 4 and np.isfinite(out[run]["losses"]).all()
        assert 0.0 <= out[run]["mIoU_seen"] <= 1.0 and math.isfinite(out[run]["mIoU_seen"])


STUB_SRUN = """#!/usr/bin/env bash
# prints srun's flags, then runs the task's command as Slurm task 9 of 16
# (node 1, local id 1) would
while [[ $# -gt 0 && $1 == -* ]]; do
    if [[ $1 == -p ]]; then echo "FLAG $1 $2"; shift 2; else echo "FLAG $1"; shift; fi
done
SLURM_NTASKS=16 SLURM_PROCID=9 SLURM_LOCALID=1 SLURM_JOB_NODELIST='gpu[3-4]' exec "$@"
"""
STUB_SCONTROL = """#!/usr/bin/env bash
printf 'gpu3\\ngpu4\\n'
"""


def _stubbed(tmp_path, script: str, *args: str, env: dict | None = None):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir(exist_ok=True)
    for name, text in (("srun", STUB_SRUN), ("scontrol", STUB_SCONTROL)):
        (bin_dir / name).write_text(text)
        (bin_dir / name).chmod(0o755)
    env = {**os.environ, "PATH": f"{bin_dir}:{os.environ['PATH']}", "PYTHON": "echo",
           **(env or {})}
    return subprocess.run(["bash", os.path.join(TOOLS, script), *args], env=env,
                          capture_output=True, text=True)


@pytest.mark.parametrize("script", ["slurm_train.sh", "slurm_test.sh"])
def test_slurm_launchers_start_one_rank_a_gpu(script, tmp_path):
    args = (["gpu", "cfg.py", "--work-dir", "w d"] if script == "slurm_train.sh"
            else ["gpu", "cfg.py", "ck pt", "--streaming"])
    run = _stubbed(tmp_path, script, *args, env={"GPUS": "16", "PORT": "29700"})
    assert run.returncode == 0, run.stderr
    lines = run.stdout.splitlines()
    flags = [ln.split(" ", 1)[1] for ln in lines if ln.startswith("FLAG ")]
    assert flags == ["-p gpu", "--job-name=vss_cffm" + ("" if script == "slurm_train.sh"
                                                         else "_eval"),
                         "--ntasks=16", "--ntasks-per-node=8", "--gres=gpu:8",
                         "--cpus-per-task=5", "--kill-on-bad-exit=1"]
    cli = "train" if script == "slurm_train.sh" else "test"
    tail = ("cfg.py --work-dir w d" if cli == "train" else "cfg.py ck pt --streaming")
    assert lines[-1] == (f"-u -m vss_cffm_tpu_torch.tools.{cli} {tail} --distributed "
                         "--coordinator gpu3:29700 --num-processes 16 --process-id 9")


def test_slurm_launcher_refuses_a_partial_node(tmp_path):
    run = _stubbed(tmp_path, "slurm_train.sh", "gpu", "cfg.py",
                   env={"GPUS": "12", "GPUS_PER_NODE": "8"})
    assert run.returncode == 2 and "not a multiple" in run.stderr
