"""PyTorch port, inference modes against the JAX package: whole, slide (an
overlapping crop grid) and TTA (two scales, flipped and not) through the
same fixed logits function, probabilities within 1e-5; the slide-mode
``ClipEvaluator`` against JAX's through that function; and the MiT block's
route at test-time augmentation's key counts: the inference block form up
to 2048 keys, the composed block above (as the JAX block)."""

from __future__ import annotations

from typing import Any

import flax.linen as flax_nn
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fixtures import make_fake_vspw
from torch_port_common import EVAL_HW, EVAL_SCALE, mask_agreement
from vss_cffm_tpu.data import VSPWVideoDataset as JaxDataset
from vss_cffm_tpu.eval import ClipEvaluator as JaxClipEvaluator
from vss_cffm_tpu.eval import inference as jinf
from vss_cffm_tpu_torch.data import VSPWVideoDataset
from vss_cffm_tpu_torch.eval import ClipEvaluator
from vss_cffm_tpu_torch.eval import inference as pinf
from vss_cffm_tpu_torch.models import mit as pmit

K = 6
_W = np.random.RandomState(0).randn(3, K).astype(np.float32)
_B = np.random.RandomState(1).randn(K).astype(np.float32)


def _jax_logits(imgs):
    """(B, T, H, W, 3) → (B, H/4, W/4, K): the clip's mean frame, every 4th
    pixel, a dense layer and a sine."""
    x = imgs.mean(axis=1)[:, ::4, ::4]
    return jnp.sin(x @ jnp.asarray(_W) + jnp.asarray(_B)) * 3.0


def _port_logits(imgs):
    x = imgs.mean(dim=1)[:, ::4, ::4]
    return torch.sin(x @ torch.from_numpy(_W) + torch.from_numpy(_B)) * 3.0


def _clip(seed, hw, t=2):
    return np.random.RandomState(seed).randn(1, t, *hw, 3).astype(np.float32)


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_whole_inference_matches_jax():
    imgs = _clip(2, (40, 56))
    want = jinf.whole_inference(_jax_logits, jnp.asarray(imgs), (37, 61))
    _close(pinf.whole_inference(_port_logits, torch.from_numpy(imgs), (37, 61)), want)


@pytest.mark.parametrize("hw,crop,stride", [((40, 56), (24, 32), (16, 16)),
                                            ((64, 64), (32, 32), (20, 24))])
def test_slide_inference_matches_jax(hw, crop, stride):
    """Overlapping crops, the last of a row and a column moved in to the
    border; the count map divides the overlaps."""
    grid = pinf.slide_grid(hw, crop, stride)
    assert len(grid) > 2 and len(set(grid)) == len(grid)
    assert max(y for y, _ in grid) == hw[0] - crop[0] and max(x for _, x in grid) == hw[1] - crop[1]
    imgs = _clip(3, hw)
    want = jinf.slide_inference(_jax_logits, jnp.asarray(imgs), (45, 50), crop, stride)
    _close(pinf.slide_inference(_port_logits, torch.from_numpy(imgs), (45, 50), crop, stride),
           want)


def test_tta_inference_matches_jax():
    clips = [_clip(4, (32, 48)), _clip(4, (32, 48)), _clip(5, (64, 96)), _clip(5, (64, 96))]
    flips = [False, True, False, True]
    want = jinf.tta_inference(_jax_logits, [jnp.asarray(c) for c in clips], flips, (50, 70))
    got = pinf.tta_inference(_port_logits, [torch.from_numpy(c) for c in clips], flips, (50, 70))
    _close(got, want)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-5)


class _JaxPixelModel(flax_nn.Module):
    """``_jax_logits`` as a flax module with no parameters, in the evaluator's
    calling convention (clip, train, cluster centres)."""

    config: Any = None

    def __call__(self, imgs, train=False, centers=None):
        return _jax_logits(imgs)


class _PortPixelModel(torch.nn.Module):
    def forward(self, imgs):
        return _port_logits(imgs)


def test_slide_clip_evaluator_matches_jax(tmp_path):
    """Slide mode of both evaluators (crops of 64×64 at stride 32 over the
    64×96 frames: two overlapping crops a frame) through the fixed logits
    function: the same masks, and the confusion matrix of those masks."""
    root = make_fake_vspw(str(tmp_path / "vspw"), videos=("vid_a",), frames_per_video=6,
                          hw=EVAL_HW, num_classes=K)
    jds = JaxDataset(root, "val", img_scale=EVAL_SCALE)
    ds = VSPWVideoDataset(root, "val", img_scale=EVAL_SCALE)
    kw = dict(mode="slide", crop_size=(64, 64), stride=(32, 32))
    want, got = {}, {}
    je = JaxClipEvaluator(_JaxPixelModel(), {}, {}, K, **kw)
    je.run([jds.get_test_item(i, normalize=False) for i in range(6)], dataset=jds,
           on_pred=lambda item, p: want.__setitem__(item["index"], np.asarray(p)))
    ce = ClipEvaluator(_PortPixelModel(), K, device="cpu", **kw)
    ce.run((ds.get_test_item(i) for i in range(6)), dataset=ds,
           on_pred=lambda meta, p: got.__setitem__(meta["index"], p))
    assert mask_agreement(want, got) == 1.0
    np.testing.assert_array_equal(ce.confusion, je.confusion)
    assert ce.confusion.sum() == sum(int((ds.load_gt(i) < K).sum()) for i in range(6))


@pytest.mark.parametrize("hw,fused", [((45, 45), True), ((46, 46), False)])
def test_block_runs_composed_above_2048_keys(monkeypatch, hw, fused):
    """A "fused" block (sr 1, so the keys are the H·W tokens) takes the
    inference block form at 2025 keys and the composed block at 2116, as
    the JAX block gates on n_kv <= 2048; both forms give the composed
    block's output."""
    torch.manual_seed(0)
    blk = pmit.MiTBlock(32, 1, 1, 4, True, 1e-6, fused=True).eval()
    ref = pmit.MiTBlock(32, 1, 1, 4, True, 1e-6, fused=False).eval()
    ref.load_state_dict(blk.state_dict())
    calls = []
    real = pmit.mit_block_fused
    monkeypatch.setattr(pmit, "mit_block_fused",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    x = torch.randn(1, *hw, 32)
    with torch.no_grad():
        out, want = blk(x), ref(x)
    assert blk.n_kv(x) == hw[0] * hw[1] and (blk.n_kv(x) <= pmit.FUSED_MAX_KV) == fused
    assert len(calls) == int(fused)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
