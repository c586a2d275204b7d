"""PyTorch port, ops: each kernel's plain version against the JAX Pallas kernel
in interpret mode (f32), the decoder's geometry tables, resize, and the
``force=`` rule."""

from __future__ import annotations

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from vss_cffm_tpu.models import cffm_transformer as jax_cffm
from vss_cffm_tpu.ops import resize as jax_resize
from vss_cffm_tpu.ops.cfm_attention import cfm_attention as jax_cfm_attention
from vss_cffm_tpu.ops.dwconv import dwconv3x3 as jax_dwconv3x3
from vss_cffm_tpu.ops.stage_block import mit_block_fused as jax_mit_block_fused
from vss_cffm_tpu.ops.stage_block import mit_block_xla as jax_mit_block_xla
from vss_cffm_tpu_torch import ops
from vss_cffm_tpu_torch.models import cffm_transformer as port_cffm

# f32 on both sides; the sums run in other orders (and the Pallas GELU uses a
# tanh·polynomial erf within 6.6e-8 of exact), so agreement is to a few f32
# ulps of the O(1) outputs.
F32_TOL = dict(rtol=2e-5, atol=2e-5)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("shape,gelu", [((1, 9, 11, 16), True), ((2, 7, 5, 24), False),
                                        ((1, 15, 15, 40), True)])
def test_dwconv_plain_matches_pallas_interpret(rng, shape, gelu):
    x = rng.randn(*shape).astype(np.float32)
    k = (rng.randn(3, 3, 1, shape[-1]) * 0.3).astype(np.float32)
    b = (rng.randn(shape[-1]) * 0.1).astype(np.float32)
    want = np.asarray(jax_dwconv3x3(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b),
                                    gelu=gelu, force="interpret"))
    got = ops.dwconv3x3(_t(x), _t(k), _t(b), gelu=gelu).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)


@pytest.mark.parametrize("layout", ["packed", "grouped"])
def test_cfm_attention_plain_matches_pallas_interpret(rng, layout):
    nw, nh, hd, area = 10, 2, 32, 49  # nw not a multiple of the TPU window tile
    c = nh * hd
    gsizes = [49, 20, 9] if layout == "grouped" else [78]
    n = sum(gsizes)
    q = rng.randn(nw, area, c).astype(np.float32)
    ks = [rng.randn(nw, g, c).astype(np.float32) for g in gsizes]
    vs = [rng.randn(nw, g, c).astype(np.float32) for g in gsizes]
    bias = rng.randn(nh, area, n).astype(np.float32)
    mask = np.where(rng.rand(nw, n) < 0.2, -100.0, 0.0).astype(np.float32)
    want = np.asarray(jax_cfm_attention(
        jnp.asarray(q), [jnp.asarray(k) for k in ks], [jnp.asarray(v) for v in vs],
        jnp.asarray(bias), jnp.asarray(mask), nh, force="interpret"))
    got = ops.cfm_attention(_t(q), [_t(k) for k in ks], [_t(v) for v in vs], _t(bias),
                            _t(mask), nh).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)


def _block_inputs(rng, shape, ch, s):
    b, h, w, c = shape
    g = lambda *sh: (rng.randn(*sh) * 0.05).astype(np.float32)
    return dict(
        x=rng.randn(*shape).astype(np.float32),
        g1=(1.0 + 0.1 * rng.randn(c)).astype(np.float32), be1=g(c),
        wq=g(c, c), bq=g(c),
        k=(rng.randn(b, s, c) * 0.2).astype(np.float32),
        v=(rng.randn(b, s, c) * 0.2).astype(np.float32),
        wproj=g(c, c), bproj=g(c),
        g2=(1.0 + 0.1 * rng.randn(c)).astype(np.float32), be2=g(c),
        w1=g(c, ch), b1=g(ch),
        kdw=(rng.randn(3, 3, 1, ch) * 0.2).astype(np.float32), bdw=g(ch),
        w2=g(ch, c), b2=g(c),
    )


@pytest.mark.parametrize("shape,ch,s,nh", [
    ((2, 9, 11, 64), 256, 12, 2),   # multi-head, odd H and W
    ((1, 8, 8, 32), 128, 4, 1),     # one head
    ((1, 6, 7, 80), 320, 9, 5),     # five heads (stage-3-like)
])
def test_mit_block_plain_matches_pallas_interpret(rng, shape, ch, s, nh):
    p = _block_inputs(rng, shape, ch, s)
    want = np.asarray(jax_mit_block_fused(
        *[jnp.asarray(a) for a in p.values()], num_heads=nh, eps=1e-6, interpret=True))
    got = ops.mit_block_fused(*[_t(a) for a in p.values()], num_heads=nh, eps=1e-6).numpy()
    np.testing.assert_allclose(got, want, rtol=3e-5, atol=3e-5)


def test_mit_block_plain_bf16_matches_xla_twin(rng):
    """The bf16 dtype plan (f32 LN and residuals, bf16 product inputs with f32
    accumulation, f32 hidden map): the plain version against JAX's identical-
    math ``mit_block_xla`` in bf16. Tolerance: one bf16 ulp (2⁻⁷ relative)
    where a rounding step lands on the other side of a tie."""
    p = _block_inputs(rng, (1, 9, 11, 64), 256, 12)
    jx = {k: jnp.asarray(v) for k, v in p.items()}
    jx["x"] = jx["x"].astype(jnp.bfloat16)
    jx["k"] = jx["k"].astype(jnp.bfloat16)
    jx["v"] = jx["v"].astype(jnp.bfloat16)
    want = np.asarray(jax_mit_block_xla(*jx.values(), num_heads=2, eps=1e-6)
                      .astype(jnp.float32))
    tx = {k: _t(v) for k, v in p.items()}
    for k in ("x", "k", "v"):
        tx[k] = tx[k].to(torch.bfloat16)
    got = ops.mit_block_fused(*tx.values(), num_heads=2, eps=1e-6)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=8e-3, atol=1e-4)


@pytest.mark.parametrize("hw", [(14, 14), (9, 11)])
def test_build_geometry_tables_equal(hw):
    want = jax_cffm.build_geometry(*hw)
    got = port_cffm.build_geometry(*hw)
    for f in ("hp", "wp", "n_wh", "n_ww"):
        assert getattr(got, f) == getattr(want, f)
    for f in ("win_idx", "rolled_idx", "win_bias_index"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert len(got.target_levels) == len(want.target_levels)
    assert len(got.clip_levels) == len(want.clip_levels)
    for g, w in zip(got.target_levels + got.clip_levels,
                    want.target_levels + want.clip_levels):
        for f in ("pool_window", "pooled_hw", "resize_hw", "trim_pad", "bias_table_size",
                  "kernel", "stride", "valid_keep"):
            assert getattr(g, f) == getattr(w, f), f
        for f in ("unfold_idx", "unfold_mask", "bias_index"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))
    np.testing.assert_array_equal(port_cffm._rolled_valid_subset(7, 3),
                                  jax_cffm._rolled_valid_subset(7, 3))


@pytest.mark.parametrize("src,dst", [((9, 11), (18, 22)), ((28, 28), (14, 14)),
                                     ((15, 15), (60, 60)), ((10, 12), (10, 12))])
def test_resize_matches_jax(rng, src, dst):
    x = rng.randn(2, *src, 3).astype(np.float32)
    want = np.asarray(jax_resize.resize_bilinear(jnp.asarray(x), dst))
    got = ops.resize_bilinear(_t(x), dst).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    want_n = np.asarray(jax_resize.resize_nearest(jnp.asarray(x), dst))
    np.testing.assert_array_equal(ops.resize_nearest(_t(x), dst).numpy(), want_n)


def test_force_rule_on_cpu(rng):
    """On a CPU tensor, force=None and 'torch' run the plain version,
    'kernel' raises, anything else is refused; no launch is counted."""
    x = _t(rng.randn(1, 5, 5, 8).astype(np.float32))
    k = _t(rng.randn(3, 3, 1, 8).astype(np.float32))
    b = _t(rng.randn(8).astype(np.float32))
    ops.reset_launches()
    torch.testing.assert_close(ops.dwconv3x3(x, k, b, force=None),
                               ops.dwconv3x3(x, k, b, force="torch"))
    with pytest.raises(RuntimeError, match="force='kernel' needs CUDA"):
        ops.dwconv3x3(x, k, b, force="kernel")
    with pytest.raises(ValueError, match="force must be one of"):
        ops.dwconv3x3(x, k, b, force="pallas")
    q = torch.zeros(2, 49, 16)
    with pytest.raises(RuntimeError, match="force='kernel' needs CUDA"):
        ops.cfm_attention(q, [q], [q], torch.zeros(2, 49, 49), torch.zeros(2, 49), 2,
                          force="kernel")
    p = _block_inputs(rng, (1, 4, 4, 16), 32, 4)
    with pytest.raises(RuntimeError, match="force='kernel' needs CUDA"):
        ops.mit_block_fused(*[_t(a) for a in p.values()], num_heads=1, force="kernel")
    assert ops.launches() == {n: 0 for n in ops.KERNEL_OPS}
