"""PyTorch port, on the card: each CUDA kernel against its plain version at
shapes beyond the main path's (odd maps, ragged row tiles, grouped K/V,
several head counts), in bf16.

Marked ``cuda`` and skipped where no CUDA device is present. On a machine
with one, from the repository root::

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q

(``--noconftest`` because the suite's shared conftest imports JAX, which the
port neither needs nor finds there.) This file imports nothing of JAX.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from vss_cffm_tpu_torch import ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(rng, *shape, scale=1.0, dtype=torch.bfloat16, dev="cpu"):
    return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)).to(dev, dtype)


def _close(got, want, rel):
    """Both sides round to bf16 at the same points but from f32 sums taken in
    other orders, so a rounding may flip by one bf16 ulp and carry on: the
    bound is ``rel`` of the largest output."""
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.isfinite(got.float()).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= rel * want.float().abs().max().item(), err


@pytest.mark.parametrize("shape,gelu,f32_in", [
    ((1, 9, 11, 16), True, False), ((2, 7, 5, 24), False, False),
    ((1, 1, 1, 8), True, False), ((2, 13, 3, 40), True, True),
])
def test_dwconv_kernel_matches_plain(dev, shape, gelu, f32_in):
    rng = np.random.RandomState(0)
    c = shape[-1]
    x = _rand(rng, *shape, dtype=torch.float32 if f32_in else torch.bfloat16, dev=dev)
    k = _rand(rng, 3, 3, 1, c, scale=0.3, dtype=torch.float32, dev=dev)
    b = _rand(rng, c, scale=0.1, dtype=torch.float32, dev=dev)
    if f32_in:  # the whole-block path feeds the f32 hidden map (bf16 out)
        got = ops.dwconv.dwconv3x3_launch(x, k, b, gelu)
        want = ops.dwconv3x3_torch(x, k, b, gelu).to(torch.bfloat16)
    else:
        got = ops.dwconv3x3(x, k, b, gelu, force="kernel")
        want = ops.dwconv3x3(x, k, b, gelu, force="torch")
    _close(got, want, 2.0 ** -7)


@pytest.mark.parametrize("nw,area,nh,hd,gsizes", [
    (10, 49, 2, 32, [78]),              # packed K/V
    (10, 49, 2, 32, [49, 20, 9]),       # grouped K/V
    (3, 100, 2, 32, [49, 40]),          # more query rows than one row tile
    (5, 49, 8, 32, [49, 132, 25, 49, 25, 9]),  # the B1 decoder's groups
    (2, 30, 4, 32, [17]),
])
def test_cfm_attention_kernel_matches_plain(dev, nw, area, nh, hd, gsizes):
    rng = np.random.RandomState(1)
    c = nh * hd
    n = sum(gsizes)
    q = _rand(rng, nw, area, c, dev=dev)
    ks = [_rand(rng, nw, g, c, dev=dev) for g in gsizes]
    vs = [_rand(rng, nw, g, c, dev=dev) for g in gsizes]
    bias = _rand(rng, nh, area, n, dtype=torch.float32, dev=dev)
    mask = torch.from_numpy(np.where(rng.rand(nw, n) < 0.2, -100.0, 0.0)
                            .astype(np.float32)).to(dev)
    got = ops.cfm_attention(q, ks, vs, bias, mask, nh, force="kernel")
    want = ops.cfm_attention(q, ks, vs, bias, mask, nh, force="torch")
    _close(got, want, 2.0 ** -6)


@pytest.mark.parametrize("shape,ch,s,nh", [
    ((2, 9, 11, 64), 256, 12, 2),   # multi-head, odd H and W
    ((1, 8, 8, 32), 128, 4, 1),     # one head
    ((1, 6, 7, 160), 640, 9, 5),    # five heads of 32
    ((1, 17, 9, 128), 512, 15, 2),  # heads of 64, more rows than one attention row tile
])
def test_mit_block_kernel_matches_plain(dev, shape, ch, s, nh):
    """The whole block, with weights scaled so that the attention and FFN
    branches are O(1) next to x, held as out − x so that a wrong branch
    cannot hide under the residual; then each of its six launches against its
    plain step, at a tolerance relative to its own output
    (``mit_block_step_errors``)."""
    rng = np.random.RandomState(2)
    b, h, w, c = shape
    f = lambda *sh, sc: _rand(rng, *sh, scale=sc, dtype=torch.float32, dev=dev)
    args = (_rand(rng, *shape, scale=0.3, dev=dev), 1.0 + f(c, sc=0.1), f(c, sc=0.1),
            f(c, c, sc=c ** -0.5), f(c, sc=0.1), _rand(rng, b, s, c, dev=dev),
            _rand(rng, b, s, c, dev=dev), f(c, c, sc=c ** -0.5), f(c, sc=0.1),
            1.0 + f(c, sc=0.1), f(c, sc=0.1), f(c, ch, sc=c ** -0.5), f(ch, sc=0.1),
            f(3, 3, 1, ch, sc=1 / 3), f(ch, sc=0.1), f(ch, c, sc=ch ** -0.5), f(c, sc=0.1))
    got = ops.mit_block_fused(*args, num_heads=nh, eps=1e-6, force="kernel")
    want = ops.mit_block_fused(*args, num_heads=nh, eps=1e-6, force="torch")
    x = args[0].float()
    # bf16 roundings at the same points from f32 sums in other orders, carried
    # through the chain: 2^-5 of the largest branch sum
    _close(got.float() - x, want.float() - x, 2.0 ** -5)
    for name, err, tol in ops.mit_block_step_errors(*args, num_heads=nh, eps=1e-6):
        assert err <= tol, (name, err, tol)


def test_launch_counts_on_the_card(dev):
    """On CUDA tensors force=None launches (and counts), 'torch' does not."""
    rng = np.random.RandomState(3)
    x = _rand(rng, 1, 5, 5, 8, dev=dev)
    k = _rand(rng, 3, 3, 1, 8, dtype=torch.float32, dev=dev)
    b = _rand(rng, 8, dtype=torch.float32, dev=dev)
    ops.reset_launches()
    ops.dwconv3x3(x, k, b, force="torch")
    assert ops.launches()["dwconv3x3"] == 0
    ops.dwconv3x3(x, k, b)
    assert ops.launches() == {"mit_block_fused": 0, "cfm_attention": 0, "dwconv3x3": 1}
    with pytest.raises(ValueError, match="does not take"):
        ops.dwconv3x3(_rand(rng, 1, 5, 5, 6, dev=dev), k[..., :6], b[:6])  # C % 8 != 0
