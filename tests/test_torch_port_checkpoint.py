"""PyTorch port, checkpoints: ``CheckpointManager`` save / restore / prune /
warm start / metadata, and ``init_segmentor(checkpoint=...)`` from a
reference-style ``.pth`` and from a manager directory, each giving the masks
of the ``state_dict`` route."""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from vss_cffm_tpu_torch import apis
from vss_cffm_tpu_torch.config import OptimConfig, build_model_config
from vss_cffm_tpu_torch.models import CFFMSegmentor
from vss_cffm_tpu_torch.train import CheckpointManager, TrainState
from vss_cffm_tpu_torch.utils import load_torch_state_dict


def _config(num_classes: int = 5):
    cfg = build_model_config("b0", num_classes=num_classes)
    dec = dataclasses.replace(cfg.head.decoder, depth=1)
    return dataclasses.replace(cfg, head=dataclasses.replace(cfg.head, decoder=dec))


class _Tiny(torch.nn.Module):
    """A backbone and a head under the reference names' prefixes (the
    paramwise rules key on them), with a buffer."""

    def __init__(self, seed: int):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.backbone = torch.nn.Linear(6, 8)
        self.decode_head = torch.nn.Sequential(torch.nn.LayerNorm(8), torch.nn.Linear(8, 3))
        self.register_buffer("running", torch.zeros(3))
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=g))
            self.running.copy_(torch.randn(3, generator=g))


def _state(seed: int, steps: int) -> TrainState:
    """A train state after ``steps`` AdamW steps on a quadratic loss, so that
    its weights, moments and schedule all differ from a fresh one."""
    model = _Tiny(seed)
    state = TrainState.create(model, OptimConfig(warmup_iters=2, max_iters=10))
    for _ in range(steps):
        loss = sum((p.float() ** 2).sum() for p in model.parameters())
        state.optimizer.zero_grad()
        loss.backward()
        state.optimizer.step()
        state.scheduler.step()
    return state


def _equal_states(a: TrainState, b: TrainState) -> None:
    for (n, x), (_, y) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert torch.equal(x, y), n
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for k in sa["state"]:
        for name in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(torch.as_tensor(sa["state"][k][name]),
                               torch.as_tensor(sb["state"][k][name]))
    assert a.step == b.step and a.scheduler.get_last_lr() == b.scheduler.get_last_lr()


def test_save_then_restore(tmp_path):
    saved = _state(0, 3)
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() is None
    mgr.save(saved)
    assert mgr.latest_step() == 3
    fresh = _state(1, 1)
    mgr.restore(fresh)
    _equal_states(fresh, saved)


def test_max_to_keep(tmp_path):
    state = _state(0, 0)
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for _ in range(4):
        state.optimizer.step()  # no gradients: the weights stay, the schedule moves
        state.scheduler.step()
        mgr.save(state, metadata={"step": state.step})
    assert mgr.steps() == [3, 4]
    assert sorted(os.listdir(tmp_path)) == ["ckpt_3.pt", "ckpt_4.pt", "metadata_3.json",
                                            "metadata_4.json"]


def test_load_params_keeps_what_the_checkpoint_lacks(tmp_path):
    """A checkpoint without the head's last layer (as a CFFM checkpoint lacks
    a finetune head's modules): the overlay loads the rest, leaves that
    module at its init, and reports it."""
    src = _state(0, 2)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(src)
    path = os.path.join(str(tmp_path), "ckpt_2.pt")
    ckpt = torch.load(path, weights_only=False)
    ckpt["model"] = {k: v for k, v in ckpt["model"].items()
                     if not k.startswith("decode_head.1.")}
    torch.save(ckpt, path)
    dst = _Tiny(7)
    init = {k: v.clone() for k, v in dst.state_dict().items()}
    kept = mgr.load_params(dst)
    assert sorted(kept) == ["decode_head.1.bias", "decode_head.1.weight"]
    for name, value in dst.state_dict().items():
        want = init[name] if name in kept else src.model.state_dict()[name]
        assert torch.equal(value, want), name


def test_metadata_round_trip(tmp_path):
    state = _state(0, 1)
    mgr = CheckpointManager(str(tmp_path))
    meta = {"config": _config(), "CLASSES": ["wall", "sky"], "PALETTE": [(1, 2, 3)]}
    mgr.save(state, metadata=meta)
    got = mgr.metadata()
    assert got == json.loads(json.dumps(got))
    assert got["CLASSES"] == ["wall", "sky"] and got["PALETTE"] == [[1, 2, 3]]
    assert got["config"]["backbone"] == "mit_b0"
    assert got["config"]["head"]["decoder"]["depth"] == 1
    assert got["config"]["block_impl"] == [None, "fused", "fused", None]
    assert mgr.metadata(step=99) is None


def test_init_segmentor_from_a_checkpoint(tmp_path):
    """A ``.pth`` written as the reference writes it (``{"state_dict": ...,
    "meta": ...}``, DDP's ``module.`` prefixes, mmseg's unused ``conv_seg``)
    and a manager directory load the weights the ``state_dict`` route loads,
    and give its masks."""
    src = CFFMSegmentor(_config())
    src.init_weights(torch.Generator().manual_seed(3))
    sd = src.state_dict()
    ref = {f"module.{k}": v for k, v in sd.items()}
    ref["module.decode_head.conv_seg.weight"] = torch.zeros(5, 8, 1, 1)
    pth = str(tmp_path / "iter_160000.pth")
    torch.save({"state_dict": ref, "meta": {"CLASSES": ["a"] * 5}}, pth)
    assert sorted(load_torch_state_dict(pth)) == sorted([*sd, "decode_head.conv_seg.weight"])
    mgr_dir = str(tmp_path / "work")
    state = TrainState.create(src, OptimConfig())
    CheckpointManager(mgr_dir).save(state)

    kw = dict(device="cpu", dtype=torch.float32, img_scale=(96, 64))
    frames = [np.random.RandomState(i).randint(0, 256, (64, 96, 3)).astype(np.uint8)
              for i in range(4)]
    want = apis.inference_segmentor(apis.init_segmentor(_config(), sd, **kw), frames)
    for ckpt in (pth, mgr_dir):
        bundle = apis.init_segmentor(_config(), checkpoint=ckpt, **kw)
        for name, value in bundle.model.state_dict().items():
            assert torch.equal(value, sd[name]), (ckpt, name)
        assert torch.equal(apis.inference_segmentor(bundle, frames), want)
    # a .pth without some of the model's weights is refused
    del ref["module.decode_head.linear_pred.weight"]
    torch.save({"state_dict": ref}, pth)
    with pytest.raises(KeyError, match="lacks 1 weights"):
        apis.init_segmentor(_config(), checkpoint=pth, **kw)
