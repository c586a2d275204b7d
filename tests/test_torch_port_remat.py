"""PyTorch port, the CFFM decoder's remat (``CFFMDecoderConfig.use_checkpoint``,
JAX ``nn.remat`` at ``models/cffm_transformer.py:694-695``): each block runs
under ``torch.utils.checkpoint`` and is recomputed in the backward.

With drop path on (rate 0.5, so that nearly every draw matters) and one
generator seed, the remat decoder gives the plain decoder's forward, input
gradient and parameter gradients to 1e-5, and leaves the generator where
the plain decoder leaves it; a checkpoint that hands the block the caller's
generator itself draws other masks in the recompute, and the same
comparison catches it. Then a B0 train step with remat against one without.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from torch_port_common import few_threads  # noqa: F401 (the module's fixture)
from vss_cffm_tpu_torch import config as pcfg
from vss_cffm_tpu_torch.models import cffm_transformer
from vss_cffm_tpu_torch.models.cffm_transformer import CFFMDecoder

pytestmark = pytest.mark.usefixtures("few_threads")

CFG = pcfg.CFFMDecoderConfig(dim=16, depth=2, num_heads=2, drop_path=0.5)


def _run(decoder: CFFMDecoder, x: torch.Tensor, seed: int = 3):
    decoder.zero_grad(set_to_none=True)
    xi = x.clone().requires_grad_(True)
    g = torch.Generator().manual_seed(seed)
    out = decoder(xi, True, g)
    (out.square() * torch.linspace(0.5, 1.5, out.shape[-1])).mean().backward()
    return (out.detach(), xi.grad, {n: p.grad.clone() for n, p in decoder.named_parameters()},
            g.get_state())


def _pair():
    torch.manual_seed(0)
    plain = CFFMDecoder(CFG)
    for p in plain.parameters():  # the bias tables and pooling away from their init
        p.data.add_(0.05 * torch.randn_like(p))
    remat = CFFMDecoder(dataclasses.replace(CFG, use_checkpoint=True))
    remat.load_state_dict(plain.state_dict())
    x = torch.from_numpy(np.random.RandomState(1).randn(4, 4, 14, 14, 16).astype(np.float32))
    return plain, remat, x


def _max_err(a, b) -> float:
    errs = [(a[0] - b[0]).abs().max().item(), (a[1] - b[1]).abs().max().item()]
    errs += [(a[2][n] - b[2][n]).abs().max().item() for n in a[2]]
    return max(errs)


def test_remat_decoder_equals_the_plain_decoder_under_drop_path():
    plain, remat, x = _pair()
    want, got = _run(plain, x), _run(remat, x)
    assert _max_err(got, want) <= 1e-5
    assert torch.equal(got[3], want[3])  # the generator moved on alike
    assert all(g.abs().max() > 0 for g in got[2].values())
    # inference: no checkpoint, the same output
    with torch.no_grad():
        np.testing.assert_array_equal(remat(x).numpy(), plain(x).numpy())


def test_a_naive_checkpoint_redraws_the_masks(monkeypatch):
    """Checkpointing the block with the caller's generator: the recompute
    draws the next masks, and the gradients leave the plain decoder's."""
    plain, remat, x = _pair()
    want = _run(plain, x)
    monkeypatch.setattr(cffm_transformer, "_checkpointed", lambda blk, x, train, g: checkpoint(
        blk, x, train, g, use_reentrant=False))
    got = _run(remat, x)
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())  # the forward is the same
    assert _max_err(got, want) > 1e-2


def test_remat_train_step_equals_the_plain_step():
    """A B0 train step (64², f32, decoder drop path 0.3) with and without
    the decoder remat, from the same weights, batch and generator seed: loss
    and every parameter after the AdamW step to 1e-5."""
    from torch_port_common import train_batch
    from vss_cffm_tpu_torch.models import CFFMSegmentor
    from vss_cffm_tpu_torch.train import TrainState, make_train_step

    imgs, labels = train_batch(1, (64, 64), 11, seed=4)
    labels[labels == 11] = 255
    results = []
    for remat in (False, True):
        cfg = pcfg.build_model_config("b0", num_classes=11)
        dec = dataclasses.replace(cfg.head.decoder, drop_path=0.3, use_checkpoint=remat)
        cfg = dataclasses.replace(cfg, head=dataclasses.replace(cfg.head, decoder=dec))
        model = CFFMSegmentor(cfg)
        model.init_weights(torch.Generator().manual_seed(0))
        model.train()
        state = TrainState.create(model, pcfg.OptimConfig(lr=1e-3, warmup_iters=0))
        step = make_train_step(model, state.optimizer, state.scheduler)
        m = step({"imgs": torch.from_numpy(imgs), "labels": torch.from_numpy(labels)},
                 torch.Generator().manual_seed(5))
        results.append((m, {n: p.detach().clone() for n, p in model.named_parameters()}))
    (m0, p0), (m1, p1) = results
    np.testing.assert_allclose(m1["loss_seg"].item(), m0["loss_seg"].item(), rtol=1e-5)
    np.testing.assert_allclose(m1["grad_norm"].item(), m0["grad_norm"].item(), rtol=1e-5)
    for n in p0:
        np.testing.assert_allclose(p1[n].numpy(), p0[n].numpy(), rtol=0, atol=1e-5, err_msg=n)


@pytest.mark.parametrize("depth", [1, 4])
def test_remat_at_other_depths(depth):
    cfg = dataclasses.replace(CFG, depth=depth)
    torch.manual_seed(2)
    plain = CFFMDecoder(cfg)
    remat = CFFMDecoder(dataclasses.replace(cfg, use_checkpoint=True))
    remat.load_state_dict(plain.state_dict())
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 4, 9, 11, 16).astype(np.float32))
    assert _max_err(_run(remat, x, 7), _run(plain, x, 7)) <= 1e-5
