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
- a clip's frames split over the 2 ranks (a 1 × 2 grid,
  ``parallel.create_clip_mesh(2)``, each rank 2 of the 4 frames of both
  clips): the eval logits within 1e-5 of their largest value and 2 default
  steps as above, against the one-process run; on 4 ranks started beside
  (a 2 × 2 grid: one clip and 2 frames a rank) the same, and the target
  frames' confusion summed over the data group equal to the one process's
  exactly, to the JAX package's ``confusion_matrix_np`` of the one-process
  predictions, its total the valid pixels;
- a Lovász step on the 2 ranks against one process as above, and
  ``clip_lovasz_loss`` of each rank's rows of fixed logits: the loss and the
  accuracy those of the JAX ``clip_lovasz_loss`` on the global batch, each
  rank's gradient twice the JAX gradient of its rows (the gather's backward
  sums the two ranks' equal upstream gradients), within 1e-5 of the
  largest;
- ``shard_clip_batch``, ``create_clip_mesh`` without a group,
  ``DrawShard``'s frames rule against the one-process draw, and the local
  rank under the coordinator flags (``LOCAL_RANK``, ``SLURM_LOCALID``);
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
import threading

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
LOVASZ = dict(type="lovasz")
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
    cfg, cfg_ohem, cfg_lovasz = (ranks.tiny_config(), ranks.tiny_config(OHEM),
                                 ranks.tiny_config(LOVASZ))
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
        "frames": dict(cfg=cfg, state_dict=weights, batch=batch, optim=OPTIM, steps=2,
                       frame_axis=2, infer=True),
        "lovasz": dict(cfg=cfg_lovasz, state_dict=weights, batch=batch, optim=OPTIM),
        "lovasz_loss": dict(logits=rng.standard_normal((B, 5, 8, 8, 5)).astype(np.float32),
                            labels=_lovasz_labels(rng)),
    }


def _lovasz_labels(rng) -> np.ndarray:
    labels = rng.randint(0, 5, (B, 4, 32, 32)).astype(np.int64)
    labels[rng.rand(*labels.shape) < 0.1] = 255
    labels[1, :, :, :16] = 2  # a class only the second clip holds much of
    return labels


@pytest.fixture(scope="module")
def grid_launch(inputs):
    """The 2 × 2 grid's case on 4 gloo ranks (``torch_port_ranks.grid_cases``),
    started from a thread here: a callable that waits for the ranks'
    results."""
    out = {}

    def run():
        try:
            out["world"] = parallel.spawn(ranks.grid_cases, 4, inputs["frames"], device="cpu")
        except Exception as e:  # raised again in the test thread
            out["error"] = e

    thread = threading.Thread(target=run, daemon=True)
    thread.start()

    def result() -> list:
        thread.join(timeout=900)
        assert not thread.is_alive(), "the 4 ranks did not finish"
        if "error" in out:
            raise out["error"]
        return out["world"]

    return result


@pytest.fixture(scope="module")
def world(inputs, training_launch, grid_launch):
    """Every 2-rank case on 2 gloo ranks (``torch_port_ranks.cases``), one
    start, while ``training_launch`` and the 4 ranks of ``grid_launch`` run."""
    return parallel.spawn(ranks.cases, 2, *inputs.values(), device="cpu")


@pytest.fixture(scope="module")
def grid_world(world, grid_launch):
    return grid_launch()


@pytest.fixture(scope="module")
def one_frames(inputs):
    """The one-process run of the frames cases: eval logits and confusion,
    then 2 steps."""
    return ranks.train_steps("cpu", **inputs["frames"])


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


def _steps_match(res: dict, one: dict, zero_names: tuple = ranks.BEFORE_BN) -> None:
    """Metrics, gradients (``grads_close``) and the fuse BN's running
    statistics after each step. The AdamW step turns the rounding noise of
    the zero gradients of ``BEFORE_BN`` (~1e-10) into moves of up to ~2e-4
    (its eps 1e-8), which the BN takes out of its output but not out of its
    batch mean: from the second step on the running mean is held after the
    shift those parameters account for, 0.9·(the last step's) + 0.1·(the
    difference of their constants, ``bn_constant``)."""
    for got, want in zip(res["metrics"], one["metrics"]):
        for k in ("loss_seg", "acc_seg", "grad_norm"):
            assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k]), (k, got[k], want[k])
    for got, want in zip(res["grads"], one["grads"]):
        ranks.grads_close(got, want, "grad", zero_names)
    shift = torch.zeros_like(one["bn_consts"][0])
    for s_, (got, want) in enumerate(zip(res["bn_steps"], one["bn_steps"])):
        if s_:
            shift = 0.9 * shift + 0.1 * (res["bn_consts"][s_ - 1] - one["bn_consts"][s_ - 1])
        torch.testing.assert_close(got[0] - shift, want[0], rtol=0, atol=1e-6)
        torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-6)



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


@pytest.mark.parametrize("grid", ["1x2", "2x2"])
def test_frames_split_inference_matches_one_process(grid, world, grid_world, one_frames):
    """Each rank's eval logits are its rows' whole clips' (the frames of a
    row gathered over its frames group)."""
    results = [w["frames"] for w in (world if grid == "1x2" else grid_world)]
    data = 1 if grid == "1x2" else 2
    for r, res in enumerate(results):
        want = parallel.shard_batch(one_frames["logits"], r // (len(results) // data), data)
        ranks.close_to_largest(res["logits"], want, 1e-5, f"logits, {grid} rank {r}")


@pytest.mark.parametrize("grid", ["1x2", "2x2"])
def test_frames_split_train_steps_match_one_process(grid, world, grid_world, one_frames):
    results = [w["frames"] for w in (world if grid == "1x2" else grid_world)]
    _steps_match(results[0], one_frames)
    for res in results[1:]:
        assert res["metrics"] == results[0]["metrics"]
        for name, p in res["params"].items():
            assert torch.equal(p, results[0]["params"][name]), name


def test_grid_confusion_equals_one_process_exactly(grid_world, one_frames, inputs):
    from vss_cffm_tpu.eval.metrics import confusion_matrix_np

    labels = inputs["frames"]["batch"]["labels"][:, -1]
    want = one_frames["confusion"]
    np.testing.assert_array_equal(
        want, confusion_matrix_np(one_frames["pred"].numpy(), labels, CLASSES))
    assert want.sum() == int((labels != 255).sum())
    for w in grid_world:
        assert w["frames"]["confusion"].dtype == np.int64
        np.testing.assert_array_equal(w["frames"]["confusion"], want)


# under the Lovász loss at this size, besides BEFORE_BN: 4.6e-13 in one process,
# 2.6e-8 of the largest gradient (1.8e-5), rounding
LOVASZ_ZERO = (*ranks.BEFORE_BN, "pool_layers_clips.2.bias")


def test_two_rank_lovasz_step_matches_one_process(world, inputs):
    one = ranks.train_steps("cpu", **inputs["lovasz"])
    res0, res1 = (w["lovasz"] for w in world)
    _steps_match(res0, one, LOVASZ_ZERO)
    for name, p in res0["params"].items():
        assert torch.equal(p, res1["params"][name]), name


def test_two_rank_lovasz_loss_matches_jax_on_the_global_batch(world, inputs):
    """Every rank computes the global batch's loss; the gather's backward
    sums the two ranks' (equal) upstream gradients, so a rank's gradient is
    2 × the JAX gradient of its rows, and the world mean of the parameter
    gradients the one-process one (the step above)."""
    import jax
    import jax.numpy as jnp

    from vss_cffm_tpu.models import losses as jax_losses

    case = inputs["lovasz_loss"]
    logits, labels = jnp.asarray(case["logits"]), jnp.asarray(case["labels"])

    def loss(x):
        out = jax_losses.clip_lovasz_loss(x, labels)
        return out["loss_seg"], out["acc_seg"]

    (want, acc), grad = jax.jit(jax.value_and_grad(loss, has_aux=True))(logits)
    grad = torch.from_numpy(np.array(grad))
    for r, w in enumerate(world):
        got = w["lovasz_loss"]
        assert abs(got["loss"] - float(want)) <= 1e-5 * abs(float(want)), (got["loss"], want)
        assert abs(got["acc"] - float(acc)) <= 1e-4, (got["acc"], acc)
        ranks.close_to_largest(got["grad"] / 2, _rows(grad, r), 1e-5, f"grad, rank {r}")
        assert got["grad"].abs().max() > 0


def test_shard_clip_batch_takes_rows_and_frames():
    mesh = parallel.ClipMesh(data=2, frames=2, data_index=1, frame_index=1)
    imgs = torch.arange(2 * 4 * 3).reshape(2, 4, 3)
    labels = torch.arange(2 * 4).reshape(2, 4)
    out = parallel.shard_clip_batch({"imgs": imgs, "labels": labels, "videos": ["a", "b"]},
                                    mesh)
    assert torch.equal(out["imgs"], imgs[1:, 2:])
    assert torch.equal(out["labels"], labels[1:])  # the whole clips' labels
    assert out["videos"] == ["b"]
    with pytest.raises(ValueError, match="clips of 4 frames over 3 frame ranks"):
        parallel.shard_clip_batch(imgs, parallel.ClipMesh(frames=3))
    assert parallel.create_clip_mesh(4) == parallel.ClipMesh()  # no group: 1 x 1


def test_draw_shard_takes_the_one_process_draws_entries():
    """A (data, frames) grid's backbone draws: each rank's frames of its rows
    of the one-process draw over (B, T) samples, in its sample order."""
    b, t, data, frames = 2, 4, 2, 2
    whole = torch.rand((data * b * t,), generator=torch.Generator().manual_seed(3))
    whole = whole.view(data * b, t)
    for d in range(data):
        for f in range(frames):
            shard = parallel.DrawShard(data, d, frames, f, rows=b)
            got = shard.uniforms(b * t // frames, torch.Generator().manual_seed(3))
            want = whole[d * b:(d + 1) * b, f * (t // frames):(f + 1) * (t // frames)]
            assert torch.equal(got, want.reshape(-1))
        got = parallel.DrawShard(data, d).uniforms(b, torch.Generator().manual_seed(3))
        assert torch.equal(got, whole.reshape(-1)[d * b:(d + 1) * b])


@pytest.mark.parametrize("env, local", [({}, 5), ({"SLURM_LOCALID": "1"}, 1),
                                        ({"LOCAL_RANK": "2", "SLURM_LOCALID": "1"}, 2)])
def test_coordinator_flags_take_the_local_rank_from_the_environment(monkeypatch, env, local):
    """Under the coordinator flags on a node past the first, the card is the
    node's local rank, not the process id."""
    from vss_cffm_tpu_torch.parallel import mesh

    for k in (*parallel.RANK_ENV, *parallel.LOCAL_RANK_ENV):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert mesh._rank_settings("node0:29500", 8, 5) == ("tcp://node0:29500", 8, 5, local)


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
