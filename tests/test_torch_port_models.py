"""PyTorch port, modules: MiT, CFFMDecoder and CFFMHead each against the flax
module of the JAX package, on the same weights carried across by
``state_dict_from_jax`` and the same numpy inputs (f32, CPU)."""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from torch_port_common import jax_and_port, to_np

# f32 on both sides through a deep stack of layers: LayerNorm variances,
# matmuls and resizes are summed in other orders, which leaves a few 1e-6
# relative; 1e-4 absolute on O(1) activations is ~100× that margin.
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def pair():
    return jax_and_port("b0", hw=(112, 112), depth=2)


def test_mit_matches_flax(pair):
    jm, var, pm, clip = pair
    x = clip.reshape(-1, *clip.shape[2:])
    want = jax.jit(lambda v, x: jm.apply(v, x, method=lambda m, x: m.backbone(x, True)))(
        var, jnp.asarray(x))
    with torch.no_grad():
        got = pm.backbone(torch.from_numpy(x))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(to_np(g), np.asarray(w), **TOL)


@pytest.mark.parametrize("hw", [(14, 14), (9, 11)])
def test_cffm_decoder_matches_flax(pair, hw):
    jm, var, pm, _ = pair
    x = np.random.RandomState(1).randn(1, 4, *hw, 256).astype(np.float32)
    want = jax.jit(lambda v, x: jm.apply(
        v, x, method=lambda m, x: m.decode_head.decoder_focal(x, deterministic=True)))(
        var, jnp.asarray(x))
    with torch.no_grad():
        got = pm.decode_head.decoder_focal(torch.from_numpy(x))
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("t", [4, 2])
def test_cffm_head_matches_flax(pair, t):
    """t=4: refined target logits; t=2 ≠ num_clips: the per-frame fallback."""
    jm, var, pm, _ = pair
    rng = np.random.RandomState(2)
    shapes = [(t, 28, 28, 32), (t, 14, 14, 64), (t, 7, 7, 160), (t, 4, 4, 256)]
    feats = [rng.randn(*s).astype(np.float32) for s in shapes]
    head = lambda m, f: m.decode_head(f, 1, t, False)
    want = jax.jit(lambda v, f: jm.apply(v, f, method=head))(var, [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        got = pm.decode_head([torch.from_numpy(f) for f in feats], 1, t)
    assert tuple(got.shape) == want.shape == (1, 28, 28, 7)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


def test_frame_features_then_predict_equals_forward(pair):
    """The cacheable prefix (backbone + per-frame decode) composes with
    ``predict_from_features`` to the whole forward, exactly."""
    _, _, pm, clip = pair
    x = torch.from_numpy(clip)
    with torch.no_grad():
        whole = pm(x)
        feats = pm.frame_features(x.reshape(-1, *x.shape[2:]))
        split = pm.predict_from_features(feats.reshape(1, 4, *feats.shape[1:]))
    torch.testing.assert_close(split, whole, rtol=0, atol=0)
