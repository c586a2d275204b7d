"""PyTorch port, inference with ``dwconv_impl="fused"`` on the CPU: the plain
versions of ``block_ffn_fused`` and ``mixffn_fused`` against the JAX Pallas
kernels in interpret mode, in f32 and bf16; the port's MiT and the B0
segmentor in eval mode against the JAX modules with
``dwconv_impl="fused-interpret"`` on the same weights; the module gates."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import jax_and_port, to_np
from vss_cffm_tpu.models.mit import MiT as JaxMiT
from vss_cffm_tpu.ops import mixffn as jax_mixffn
from vss_cffm_tpu_torch import apis, ops
from vss_cffm_tpu_torch import config as pcfg
from vss_cffm_tpu_torch.models import CFFMSegmentor
from vss_cffm_tpu_torch.models import mit as port_mit


def _j(t: torch.Tensor):
    """The same values as a JAX array of the same dtype (bf16 or f32)."""
    return jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)


def _np(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _ffn_inputs(rng, shape, dt):
    """x in dt; γ, β, W1, b1, kdw, bdw, W2, b2 f32 (as in the model), scaled
    so that the FFN branch is O(1) next to x."""
    c = shape[-1]
    ch = 4 * c
    f = lambda *sh, sc=1.0: torch.from_numpy((rng.randn(*sh) * sc).astype(np.float32))
    x = f(*shape).to(dt)
    return x, (1.0 + f(c, sc=0.1), f(c, sc=0.1), f(c, ch, sc=c ** -0.5), f(ch, sc=0.1),
               f(3, 3, 1, ch, sc=1 / 3), f(ch, sc=0.1), f(ch, c, sc=ch ** -0.5), f(c, sc=0.1))


def _assert_matches(got: torch.Tensor, want, label: str) -> None:
    """f32: the same arithmetic in other summation orders (and the Pallas
    tanh-polynomial erf, within 6.6e-8 of erff), 1e-5 of the largest value.
    bf16: rounded at the same points from f32 sums in other orders, so a
    rounding flips one ulp only where a sum lies within f32 rounding of a
    bf16 boundary: ≥ 99 % of the elements bitwise equal (a rounding point
    moved, added or dropped leaves far fewer) and none off by more than 2^-6
    of the largest."""
    g, w = got.float().numpy(), _np(want)
    assert g.shape == w.shape, label
    scale = np.abs(w).max()
    if got.dtype == torch.float32:
        assert np.abs(g - w).max() <= 1e-5 * scale, (label, np.abs(g - w).max(), scale)
    else:
        assert got.dtype == torch.bfloat16, label
        assert np.mean(g == w) >= 0.99, (label, np.mean(g == w))
        assert np.abs(g - w).max() <= 2.0 ** -6 * scale, label


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 8, 8, 32), (1, 7, 10, 24)], ids=["8x8", "ragged"])
def test_block_ffn_fused_matches_pallas_interpret(shape, dt):
    """Row 8: x + FFN(LN(x)) with the hidden map in f32 and one rounding of
    the f32 sum, against ``_kernel_ln`` interpreted."""
    x, p = _ffn_inputs(np.random.RandomState(0), shape, dt)
    want = jax_mixffn.block_ffn_fused(_j(x), *map(_j, p), eps=1e-6, interpret=True)
    got = ops.block_ffn_fused(x, *p, eps=1e-6)
    _assert_matches(got, want, "block_ffn_fused")
    torch.testing.assert_close(got, ops.block_ffn_fused_torch(x, *p, eps=1e-6), rtol=0, atol=0)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 8, 8, 32), (1, 7, 10, 24)], ids=["8x8", "ragged"])
def test_mixffn_fused_matches_pallas_interpret(shape, dt):
    """Row 9: fc1 → depthwise → GELU → fc2 without LN and residual, against
    ``_kernel`` interpreted."""
    x, p = _ffn_inputs(np.random.RandomState(1), shape, dt)
    mix = (p[2], p[3], p[4], p[5], p[6], p[7])
    want = jax_mixffn.mixffn_fused(_j(x), *map(_j, mix), interpret=True)
    got = ops.mixffn_fused(x, *mix)
    _assert_matches(got, want, "mixffn_fused")
    torch.testing.assert_close(got, ops.mixffn_fused_torch(x, *mix), rtol=0, atol=0)


def test_block_ffn_fused_rounds_where_the_kernel_does():
    """bf16: the port keeps the hidden map in f32 and rounds x + branch once,
    as ``_kernel_ln``; the XLA twin ``block_ffn_xla`` rounds the hidden map
    (composed MixFFN) and the branch, and differs from both."""
    x, p = _ffn_inputs(np.random.RandomState(2), (2, 8, 8, 32), torch.bfloat16)
    kern = _np(jax_mixffn.block_ffn_fused(_j(x), *map(_j, p), eps=1e-6, interpret=True))
    twin = _np(jax_mixffn.block_ffn_xla(_j(x), *map(_j, p), eps=1e-6))
    got = ops.block_ffn_fused(x, *p, eps=1e-6).float().numpy()
    assert np.mean(got == kern) >= 0.99
    assert np.mean(got == twin) < np.mean(got == kern)


@pytest.fixture(scope="module")
def fused_pair():
    """B0 at 112², decoder depth 2 (the weights of ``test_torch_port_models``):
    the JAX model with every FFN half through ``block_ffn_fused``
    interpreted, applied once, jitted, to the clip: its logits and, captured
    on the way, the backbone's four feature maps; the port, built by
    ``init_segmentor`` on the CPU from the same weights, with
    ``dwconv_impl="fused"`` (stages 1 and 4: ``block_ffn_fused``; 2 and 3:
    the whole block)."""
    jm, var, pm, clip = jax_and_port("b0", hw=(112, 112), depth=2,
                                     dwconv_impl="fused-interpret")
    bundle = apis.init_segmentor(pm.config, pm.state_dict(), device="cpu", dtype=torch.float32)
    assert bundle.config.backbone_config.dwconv_impl == "fused"
    mit = lambda mdl, name: isinstance(mdl, JaxMiT) and name == "__call__"
    logits, state = jax.jit(lambda v, x: jm.apply(
        v, x, False, capture_intermediates=mit, mutable=["intermediates"]))(var, jnp.asarray(clip))
    (feats,) = state["intermediates"]["backbone"]["__call__"]
    return bundle.model, clip, np.asarray(logits), [np.asarray(f) for f in feats]


# f32 end to end: sums in other orders leave ~1e-6 on O(1) activations
TOL = dict(rtol=1e-4, atol=1e-4)


def test_mit_with_fused_ffn_matches_flax(fused_pair, monkeypatch):
    """The four feature maps, and the port's route: ``block_ffn_fused`` at
    the four blocks of stages 1 and 4, never the composed MixFFN there."""
    pm, clip, _, want = fused_pair
    calls = []
    monkeypatch.setattr(port_mit, "block_ffn_fused",
                        lambda *a, **k: calls.append(a[0].shape) or ops.block_ffn_fused(*a, **k))
    with torch.no_grad():
        got = pm.backbone(torch.from_numpy(clip.reshape(-1, *clip.shape[2:])))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_np(g), w, **TOL)
    assert [s[-1] for s in calls] == [32, 32, 256, 256]


def test_segmentor_with_fused_ffn_matches_jax(fused_pair):
    pm, clip, want, _ = fused_pair
    with torch.no_grad():
        got = pm(torch.from_numpy(clip))
    assert tuple(got.shape) == want.shape == (1, 28, 28, 7)
    np.testing.assert_allclose(to_np(got), want, **TOL)


def test_fused_ffn_gates():
    """MixFFN in eval mode takes ``mixffn_fused``, in train mode the composed
    path; a width the launches refuse (C % 8 != 0) runs composed; the ops
    raise under autograd; the block in train mode never takes row 8."""
    rng = np.random.RandomState(3)
    mlp = port_mit.MixFFN(16, 64, "fused").eval()
    x = torch.from_numpy(rng.randn(2, 5, 6, 16).astype(np.float32))
    with torch.no_grad():
        fused = mlp(x)
        torch.testing.assert_close(fused, ops.mixffn_fused_torch(x, *mlp.fused_params()),
                                   rtol=0, atol=0)
        assert mlp.fuses(x)
        mlp.train()
        assert not mlp.fuses(x)
        torch.testing.assert_close(mlp(x), fused, rtol=1e-5, atol=1e-5)
    assert not port_mit.MixFFN(12, 48, "fused").eval().fuses(torch.zeros(1, 4, 4, 12))
    with pytest.raises(RuntimeError, match="block_ffn_fused has no backward"):
        blk = port_mit.MiTBlock(16, 1, 2, 4, True, 1e-6, fused=False, dwconv_impl="fused")
        blk.eval()(x)
    blk.train()
    blk(x).sum().backward()                     # composed: a graph to every parameter
    assert blk.mlp.fc1.weight.grad is not None
    with pytest.raises(ValueError, match="dwconv_impl"):
        pcfg.SegmentorConfig(dwconv_impl="fused-interpret")
    model = CFFMSegmentor(dataclasses.replace(pcfg.build_model_config("b0", num_classes=7),
                                              dwconv_impl="fused"))
    assert all(b.mlp.dwconv_impl == "fused" for s in range(1, 5)
               for b in getattr(model.backbone, f"block{s}"))
