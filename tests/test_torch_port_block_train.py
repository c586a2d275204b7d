"""PyTorch port, the block train pairs on the CPU: the whole-block pair
(``mit_block_train``) and the block-FFN pair (``block_ffn_train``) against
the JAX Pallas kernels in interpret mode and their ``jax.vjp``, in f32 and
bf16, with branch scales 0 and 1/0.9; ``MiTBlock`` in the "full" and "ffn"
train forms against the JAX ``MiTBlock`` with "full-interpret" /
"ffn-interpret"; the forms drawing the composed block's drop-path masks; the
gates; the ctypes signatures of the C entry points."""

from __future__ import annotations

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vss_cffm_tpu.ops import mixffn as jax_mixffn
from vss_cffm_tpu.ops import stage_block as jax_sb
from vss_cffm_tpu.utils.torch_convert import _conv, _dwconv, _linear, _norm
from vss_cffm_tpu_torch import ops
from vss_cffm_tpu_torch.models.mit import MiTBlock
from vss_cffm_tpu_torch.ops import _build
from vss_cffm_tpu_torch.ops.mixffn import FFN_GRADS
from vss_cffm_tpu_torch.ops.stage_block import GRADS

# branch scales of two frames: the attention branch dropped in frame 0, the
# FFN branch in frame 1 (drop path 0.1)
S_ATTN = np.array([0.0, 1 / 0.9], np.float32)
S_FFN = np.array([1 / 0.9, 0.0], np.float32)


def _j(t: torch.Tensor):
    """The same values as a JAX array of the same dtype (bf16 or f32)."""
    return jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)


def _np(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _block_inputs(rng, shape, s, ch, dt):
    """x, k, v in dt, parameters f32 (as in the model), branch scales."""
    b, h, w, c = shape
    f = lambda *sh, sc=1.0: torch.from_numpy((rng.randn(*sh) * sc).astype(np.float32))
    x = f(*shape).to(dt)
    k, v = f(b, s, c).to(dt), f(b, s, c).to(dt)
    params = (1.0 + f(c, sc=0.1), f(c, sc=0.1), f(c, c, sc=c ** -0.5), f(c, sc=0.1), k, v,
              f(c, c, sc=c ** -0.5), f(c, sc=0.1), 1.0 + f(c, sc=0.1), f(c, sc=0.1),
              f(c, ch, sc=c ** -0.5), f(ch, sc=0.1), f(3, 3, 1, ch, sc=1 / 3), f(ch, sc=0.1),
              f(ch, c, sc=ch ** -0.5), f(c, sc=0.1))
    return (x, *params), torch.from_numpy(S_ATTN), torch.from_numpy(S_FFN)


def _assert_bf16_rounded_alike(got: torch.Tensor, want, label: str) -> None:
    """bf16 outputs rounded at the same points from f32 sums taken in other
    orders: a rounding flips one ulp only where an f32 sum lies within f32
    rounding of a bf16 boundary. So ≥ 99 % of the elements are bitwise equal
    (a rounding moved, added or dropped leaves 60-75 % equal) and none is off
    by more than 2^-6 of the largest (one flip carried through a product)."""
    assert got.dtype == torch.bfloat16, label
    g, w = got.float().numpy(), _np(want)
    assert np.mean(g == w) >= 0.99, (label, np.mean(g == w))
    assert np.abs(g - w).max() <= 2.0 ** -6 * np.abs(w).max(), label


def _assert_grad_close(got: torch.Tensor, want, rel: float, label: str) -> None:
    w = _np(want)
    assert tuple(got.shape) == w.shape, label
    err = np.abs(got.float().numpy() - w).max()
    assert err <= rel * np.abs(w).max(), (label, err, np.abs(w).max())


# f32: the same arithmetic in another order (sums over rows, heads and
# products), 1e-4 of each output's largest value. bf16: f32 gradients whose
# inputs (d_hid, d_attn, d_ctx, d_s, d_q, p, ...) are bf16 roundings that
# may each flip one ulp: 2^-7 of each gradient's largest value.
GRAD_REL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}

BLOCK_CASES = [((2, 8, 8, 32), 2, 2), ((2, 6, 10, 64), 2, 2)]  # ragged: W 10, S = 15


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,nh,sr", BLOCK_CASES, ids=["8x8", "ragged"])
def test_mit_block_train_matches_pallas_interpret(shape, nh, sr, dt):
    """The plain forward and backward (``mit_block_train_torch`` /
    ``mit_block_train_bwd_torch``) and the autograd Function against the
    JAX pair in interpret mode: the output and all 17 cotangents."""
    rng = np.random.RandomState(0)
    b, h, w, c = shape
    s = (h // sr) * (w // sr)
    ins, s_attn, s_ffn = _block_inputs(rng, shape, s, 4 * c, dt)
    go = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dt)
    jins = [_j(t) for t in ins] + [_j(s_attn), _j(s_ffn)]
    jout, vjp = jax.vjp(lambda *a: jax_sb.mit_block_train(*a, nh, 1e-6, True), *jins)
    jgrads = vjp(_j(go))

    out = ops.mit_block_train_torch(*ins, s_attn, s_ffn, num_heads=nh, eps=1e-6)
    grads = ops.mit_block_train_bwd_torch(*ins[:16], s_attn, s_ffn, go, num_heads=nh, eps=1e-6)
    if dt == torch.bfloat16:
        _assert_bf16_rounded_alike(out, jout, "out")
        _assert_bf16_rounded_alike(grads[0], jgrads[0], "dx")
    else:
        np.testing.assert_allclose(out.numpy(), _np(jout), rtol=1e-5, atol=1e-5)
        _assert_grad_close(grads[0], jgrads[0], GRAD_REL[dt], "dx")
    for name, g, jg in zip(GRADS[1:], grads[1:], jgrads[1:17]):
        _assert_grad_close(g, jg, GRAD_REL[dt], name)
    assert not np.any(_np(jgrads[17])) and not np.any(_np(jgrads[18]))

    # the differentiable op: the same gradients, each in its input's dtype
    leaves = [t.clone().requires_grad_(True) for t in ins]
    ops.mit_block_train(*leaves, s_attn, s_ffn, num_heads=nh, eps=1e-6).backward(go)
    for name, leaf, g in zip(GRADS, leaves, grads):
        assert leaf.grad.dtype == leaf.dtype, name
        torch.testing.assert_close(leaf.grad, g.to(leaf.dtype), rtol=0, atol=0, msg=name)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 8, 8, 32), (2, 7, 10, 24)], ids=["8x8", "ragged"])
def test_block_ffn_train_matches_pallas_interpret(shape, dt):
    """``block_ffn_train`` (plain forward and backward, and the autograd
    Function) against the JAX FFN-half pair in interpret mode: the output
    and the 9 cotangents, in f32 and bf16, scale (1/0.9, 0)."""
    rng = np.random.RandomState(1)
    b, h, w, c = shape
    ins, _, scale = _block_inputs(rng, shape, 4, 4 * c, dt)
    x, ffn = ins[0], ins[9:]       # γ2, β2, W1, b1, kdw, bdw, W2, b2
    go = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dt)
    jins = [_j(x)] + [_j(t) for t in ffn] + [_j(scale)]
    jout, vjp = jax.vjp(lambda *a: jax_mixffn.block_ffn_train(*a, 1e-6, True), *jins)
    jgrads = vjp(_j(go))

    out = ops.block_ffn_train_torch(x, *ffn, scale, eps=1e-6)
    grads = ops.block_ffn_train_bwd_torch(x, *ffn[:7], scale, go, eps=1e-6)
    if dt == torch.bfloat16:
        _assert_bf16_rounded_alike(out, jout, "out")
        _assert_bf16_rounded_alike(grads[0], jgrads[0], "dx")
    else:
        np.testing.assert_allclose(out.numpy(), _np(jout), rtol=1e-5, atol=1e-5)
        _assert_grad_close(grads[0], jgrads[0], GRAD_REL[dt], "dx")
    for name, g, jg in zip(FFN_GRADS[1:], grads[1:], jgrads[1:9]):
        _assert_grad_close(g, jg, GRAD_REL[dt], name)

    leaves = [t.clone().requires_grad_(True) for t in (x, *ffn)]
    ops.block_ffn_train(*leaves, scale, eps=1e-6).backward(go)
    for name, leaf, g in zip(FFN_GRADS, leaves, grads):
        assert leaf.grad.dtype == leaf.dtype, name
        torch.testing.assert_close(leaf.grad, g.to(leaf.dtype), rtol=0, atol=0, msg=name)


def _jax_block_tree(sd: dict) -> dict:
    """A port ``MiTBlock`` state dict (or gradients by the same names) as the
    JAX block's parameter tree."""
    sd = {k: v.detach().float().numpy() for k, v in sd.items()}
    attn = {"q": _linear(sd, "attn.q"), "kv": _linear(sd, "attn.kv"),
            "proj": _linear(sd, "attn.proj")}
    if "attn.sr.weight" in sd:
        attn.update(sr=_conv(sd, "attn.sr"), norm=_norm(sd, "attn.norm"))
    return {"norm1": _norm(sd, "norm1"), "attn": attn, "norm2": _norm(sd, "norm2"),
            "mlp": {"fc1": _linear(sd, "mlp.fc1"), "dwconv": _dwconv(sd, "mlp.dwconv.dwconv"),
                    "fc2": _linear(sd, "mlp.fc2")}}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {f"{prefix}{k}": v})
    return out


@pytest.mark.parametrize("impl", ["full", "ffn"])
def test_mit_block_train_forms_match_jax_module(impl):
    """The port's ``MiTBlock`` in train mode with "full" / "ffn" against the
    JAX ``MiTBlock`` with "full-interpret" / "ffn-interpret" on the same
    weights (f32, drop path 0): the value of Σ cos(out) and every
    parameter's gradient, including the sr conv, its norm and kv, which
    reach the loss only through dK and dV. 1e-4 of each gradient's largest
    value (f32 sums in other orders)."""
    from vss_cffm_tpu.models.mit import MiTBlock as JaxMiTBlock

    rng = np.random.RandomState(2)
    x = rng.randn(2, 8, 8, 64).astype(np.float32)
    blk = MiTBlock(64, 2, 2, 4, True, 1e-6, fused=False, train_impl=impl).train()
    with torch.no_grad():
        for p in blk.parameters():
            p.add_(torch.from_numpy((0.05 * rng.randn(*p.shape)).astype(np.float32)))
    jblk = JaxMiTBlock(dim=64, num_heads=2, sr_ratio=2, mlp_ratio=4, qkv_bias=True, drop=0.0,
                       attn_drop=0.0, drop_path_rate=0.0, norm_eps=1e-6,
                       train_block_impl=f"{impl}-interpret")
    params = {"params": _jax_block_tree(blk.state_dict())}
    jval, jgrad = jax.value_and_grad(
        lambda p: jnp.sum(jnp.cos(jblk.apply(p, jnp.asarray(x), False))))(params)

    launches = ops.launches()
    out = blk(torch.from_numpy(x), train=True)
    assert ops.launches() == launches          # CPU tensors: the plain versions
    val = out.cos().sum()
    val.backward()
    np.testing.assert_allclose(val.item(), float(jval), rtol=1e-5)
    want = _flat(jax.device_get(jgrad["params"]))
    got = _flat(_jax_block_tree({n: p.grad for n, p in blk.named_parameters()}))
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        w = np.asarray(want[name])
        assert np.abs(w).max() > 0, name
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), name


@pytest.mark.parametrize("impl", ["full", "ffn"])
def test_train_forms_draw_the_composed_masks(impl):
    """Under one generator seed and drop path 0.3, the "full" / "ffn" block
    gives the composed block's output and gradients (f32): the branch scales
    are drawn as the composed block draws its two masks. 1e-5 of the largest
    value (x / keep there, x · (1 / keep) here)."""
    torch.manual_seed(0)
    ref = MiTBlock(64, 2, 2, 4, True, 1e-6, fused=False, drop_path_rate=0.3).train()
    blk = MiTBlock(64, 2, 2, 4, True, 1e-6, fused=False, drop_path_rate=0.3,
                   train_impl=impl).train()
    blk.load_state_dict(ref.state_dict())
    x = torch.randn(6, 8, 7, 64)
    runs = []
    for m in (ref, blk):
        xx = x.clone().requires_grad_(True)
        out = m(xx, True, torch.Generator().manual_seed(5))
        out.sin().sum().backward()
        runs.append([out.detach(), xx.grad] + [p.grad for p in m.parameters()])
    g = torch.Generator().manual_seed(5)
    draws = torch.stack([torch.rand(6, generator=g) < 0.7 for _ in range(2)])
    assert draws.any() and not draws.all()  # the masks drop some branches, keep others
    for a, b in zip(runs[1], runs[0]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * b.abs().max().item())


def test_gates_of_the_pairs():
    """The port's own gates: what its launches take, forward and backward
    (head dim 32 or 64, widths multiples of 8, C <= 512, the attention's
    keys within one block's shared memory). B1's stages 1-3 at 480² pass."""
    for c, nh in ((64, 1), (128, 2), (320, 5)):
        assert ops.mit_block_train_fits(120, 120, c, 4 * c, nh, 225)
        assert ops.block_ffn_train_fits(120, 120, c, 4 * c)
    assert not ops.mit_block_train_fits(8, 8, 32, 128, 2, 16)       # head dim 16
    assert not ops.mit_block_train_fits(8, 8, 64, 256, 3, 16)       # 64 % 3
    assert not ops.mit_block_train_fits(30, 30, 1024, 4096, 16, 9)  # C > 512
    assert not ops.mit_block_train_fits(80, 80, 64, 256, 1, 1600)   # 1600 keys
    assert not ops.block_ffn_train_fits(8, 8, 1024, 4096)
    assert not ops.block_ffn_train_fits(8, 8, 36, 144)


def test_ctypes_signatures_match_the_c_prototypes():
    """Every C entry point's argument kinds in ``_build._SIGNATURES`` against
    its prototype in ``csrc/`` (a 64-bit argument passed as a 32-bit one would
    cut it): pointers, 64-bit ints, floats, ints."""
    for lib, fns in _build._SIGNATURES.items():
        with open(f"{_build.CSRC}/{lib}.cu") as fh:
            src = fh.read()
        for fn, sig in fns.items():
            m = re.search(r"VSS_EXPORT int " + fn + r"\((.*?)\)\s*\{", src, re.S)
            assert m, (lib, fn)
            kinds = "".join("p" if "*" in a else "l" if a.strip().startswith("long long")
                            else "f" if a.strip().startswith("float") else "i"
                            for a in m.group(1).split(","))
            assert kinds == sig, (lib, fn, kinds, sig)
    assert set(_build._SIGNATURES) == set(_build.SOURCES)
