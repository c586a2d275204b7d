"""PyTorch port, on the card: each CUDA kernel against its plain version at
shapes beyond the main path's (odd maps, ragged row tiles, grouped K/V,
several head counts, ragged window tiles, ignored labels, B0 widths, zero
branch scales, C = 7 and 124 classes), in bf16; train steps in each block
form, and with OHEM and class weights, whose gradients go through the
kernels; B0 clip inference with the fused FFN.

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


def _block_train_inputs(rng, shape, ch, s, dev):
    """bf16 x, K, V and go, f32 parameters scaled so that both branches are
    O(1) next to x, branch scales with a dropped branch in frame 0."""
    b, h, w, c = shape
    f = lambda *sh, sc: _rand(rng, *sh, scale=sc, dtype=torch.float32, dev=dev)
    ins = (_rand(rng, *shape, scale=0.3, dev=dev), 1.0 + f(c, sc=0.1), f(c, sc=0.1),
           f(c, c, sc=c ** -0.5), f(c, sc=0.1), _rand(rng, b, s, c, dev=dev),
           _rand(rng, b, s, c, dev=dev), f(c, c, sc=c ** -0.5), f(c, sc=0.1),
           1.0 + f(c, sc=0.1), f(c, sc=0.1), f(c, ch, sc=c ** -0.5), f(ch, sc=0.1),
           f(3, 3, 1, ch, sc=1 / 3), f(ch, sc=0.1), f(ch, c, sc=ch ** -0.5), f(c, sc=0.1))
    s_attn = torch.tensor(([0.0] + [1 / 0.9] * b)[:b], device=dev)
    s_ffn = torch.tensor(([1 / 0.9, 0.0] + [1.0] * b)[:b], device=dev)
    go = _rand(rng, *shape, dev=dev)
    return ins, s_attn, s_ffn, go


# bf16 roundings at the same points from f32 sums in other orders, carried
# through the chain of launches: 2^-5 of each output's largest value
WHOLE_REL = 2.0 ** -5

TRAIN_BLOCK_SHAPES = [
    ((2, 9, 11, 32), 128, 12, 1),    # B0 stage 1 widths, odd H and W
    ((1, 8, 8, 64), 256, 16, 2),     # B0 stage 2: two heads of 32
    ((2, 7, 5, 160), 640, 20, 5),    # B0 stage 3: five heads of 32, ragged W
    ((1, 17, 9, 128), 512, 15, 2),   # heads of 64, more queries than one tile
]


@pytest.mark.parametrize("shape,ch,s,nh", TRAIN_BLOCK_SHAPES)
def test_mit_block_train_kernels_match_plain(dev, shape, ch, s, nh):
    """The whole-block train pair: every forward and backward launch against
    its plain step, fed the plain path's inputs, at its own tolerance
    (``mit_block_step_errors`` with the branch scales,
    ``mit_block_train_bwd_step_errors``); then the forward (held as out − x)
    and all 17 outputs of the backward, each at its own scale."""
    rng = np.random.RandomState(8)
    ins, s_attn, s_ffn, go = _block_train_inputs(rng, shape, ch, s, dev)
    sb = ops.stage_block
    for name, err, tol in (
            sb.mit_block_step_errors(*ins, num_heads=nh, s_attn=s_attn, s_ffn=s_ffn,
                                     op="mit_block_train")
            + sb.mit_block_train_bwd_step_errors(*ins[:16], s_attn, s_ffn, go, num_heads=nh)):
        assert err <= tol, (name, err, tol)
    got = ops.mit_block_train(*ins, s_attn, s_ffn, num_heads=nh, force="kernel")
    want = ops.mit_block_train(*ins, s_attn, s_ffn, num_heads=nh, force="torch")
    x = ins[0].float()
    _close(got.float() - x, want.float() - x, WHOLE_REL)
    gk = ops.mit_block_train_bwd(*ins[:16], s_attn, s_ffn, go, nh, force="kernel")
    gp = ops.mit_block_train_bwd(*ins[:16], s_attn, s_ffn, go, nh, force="torch")
    for name, a, b in zip(ops.stage_block.GRADS, gk, gp):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        err = (a.float() - b.float()).abs().max().item()
        assert err <= WHOLE_REL * b.float().abs().max().item(), (name, err)


@pytest.mark.parametrize("shape,ch", [((2, 9, 11, 32), 128), ((1, 7, 13, 160), 640),
                                      ((2, 6, 6, 320), 1280)])
def test_block_ffn_train_kernels_match_plain(dev, shape, ch):
    """The FFN-half pair: each launch against its plain step
    (``block_ffn_train_step_errors``), then the forward and its 9 gradients
    at their own scales."""
    rng = np.random.RandomState(9)
    ins, _, s_ffn, go = _block_train_inputs(rng, shape, ch, 4, dev)
    x, ffn = ins[0], ins[9:]
    for name, err, tol in (ops.mixffn.block_ffn_train_step_errors(x, *ffn, s_ffn)
                           + ops.mixffn.block_ffn_train_bwd_step_errors(x, *ffn[:7], s_ffn, go)):
        assert err <= tol, (name, err, tol)
    got = ops.block_ffn_train(x, *ffn, s_ffn, force="kernel")
    want = ops.block_ffn_train(x, *ffn, s_ffn, force="torch")
    _close(got.float() - x.float(), want.float() - x.float(), WHOLE_REL)
    gk = ops.block_ffn_train_bwd(x, *ffn[:7], s_ffn, go, force="kernel")
    gp = ops.block_ffn_train_bwd(x, *ffn[:7], s_ffn, go, force="torch")
    for name, a, b in zip(ops.mixffn.FFN_GRADS, gk, gp):
        err = (a.float() - b.float()).abs().max().item()
        assert err <= WHOLE_REL * b.float().abs().max().item(), (name, err)


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
    assert ops.launches() == {**{n: 0 for n in ops.KERNEL_OPS}, "dwconv3x3": 1}
    with pytest.raises(ValueError, match="does not take"):
        ops.dwconv3x3(_rand(rng, 1, 5, 5, 6, dev=dev), k[..., :6], b[:6])  # C % 8 != 0


def _labels(rng, n, hh, ww, c, dtype, dev):
    lab = rng.randint(0, c, (n, hh, ww))
    lab[rng.rand(n, hh, ww) < 0.1] = 255
    lab[rng.rand(n, hh, ww) < 0.02] = c  # out of range: ignored too
    return torch.from_numpy(lab.astype(np.int32)).to(dev, dtype)


@pytest.mark.parametrize("n,h,w,c,s,ldt", [
    (2, 8, 12, 19, 4, torch.uint8), (1, 7, 9, 124, 4, torch.int32),
    (3, 6, 5, 40, 2, torch.uint8), (1, 30, 61, 124, 4, torch.uint8),
])
def test_ce_upsampled_kernels_match_plain(dev, n, h, w, c, s, ldt):
    """Forward: the loss sum to 1e-4 relative (f32 sums in other orders, and
    the lerp rounded differently from F.interpolate's); the correct count
    within 1e-3 of the pixels (near-ties may fall either way). Backward: bf16
    dlogits, one bf16 rounding of f32 sums taken in other orders: 2^-7 of the
    largest."""
    rng = np.random.RandomState(4)
    x = _rand(rng, n, h, w, c, scale=2.0, dev=dev)
    lab = _labels(rng, n, h * s, w * s, c, ldt, dev)
    img_w = 0.5 / lab.numel()
    got = ops.ce_upsampled_loss(x, lab, s, img_w, force="kernel")
    want = ops.ce_upsampled_loss(x, lab, s, img_w, force="torch")
    torch.cuda.synchronize()
    assert abs(got[0].item() - want[0].item()) <= 1e-4 * abs(want[0].item())
    assert abs(got[1].item() - want[1].item()) <= max(1.0, 1e-3 * lab.numel())
    g = torch.tensor(1.7, device=dev)
    gk = ops.ce_upsampled_loss_bwd(x, lab, g, s, img_w, force="kernel")
    gp = ops.ce_upsampled_loss_bwd(x, lab, g, s, img_w, force="torch")
    _close(gk, gp, 2.0 ** -7)


@pytest.mark.parametrize("nw,nh,hd,gsizes", [
    (10, 2, 32, [49, 20, 9]),
    (11, 8, 32, [49, 132, 25, 49, 25, 9]),   # the B1 decoder's groups
    (3, 2, 64, [49, 71]),
])
def test_cfm_attention_bwd_kernel_matches_plain(dev, nw, nh, hd, gsizes):
    """dq, dK, dV (bf16) each to 2^-6 of its own largest value: ds and p are
    rounded to bf16 at the same points from f32 sums in other orders, so a
    rounding may flip by one ulp and carry through one product. dbias (f32,
    summed over windows) to 2^-10 of its largest."""
    rng = np.random.RandomState(5)
    c = nh * hd
    n = sum(gsizes)
    q = _rand(rng, nw, 49, c, dev=dev)
    k = _rand(rng, nw, n, c, dev=dev)
    v = _rand(rng, nw, n, c, dev=dev)
    g = _rand(rng, nw, 49, c, dev=dev)
    bias = _rand(rng, nh, 49, n, dtype=torch.float32, dev=dev)
    mask = torch.from_numpy(np.where(rng.rand(nw, n) < 0.2, -100.0, 0.0)
                            .astype(np.float32)).to(dev)
    got = ops.cfm_attention_bwd(q, k, v, bias, mask, g, nh, force="kernel")
    want = ops.cfm_attention_bwd(q, k, v, bias, mask, g, nh, force="torch")
    for a, b, rel in zip(got, want, (2.0 ** -6,) * 3 + (2.0 ** -10,)):
        _close(a, b, rel)


def test_dwconv_kernel_writes_the_preactivation(dev):
    """Under grad the kernel also writes z = taps + bias (bf16), the plain
    backward's residual: within one bf16 ulp of the plain z."""
    rng = np.random.RandomState(6)
    x = _rand(rng, 2, 9, 7, 32, dev=dev)
    k = _rand(rng, 3, 3, 1, 32, scale=0.3, dtype=torch.float32, dev=dev)
    b = _rand(rng, 32, scale=0.1, dtype=torch.float32, dev=dev)
    z = torch.empty_like(x)
    ops.dwconv.dwconv3x3_launch(x, k, b, True, z=z)
    _close(z, ops.dwconv._preact(x, k, b).to(torch.bfloat16), 2.0 ** -7)
    xg = x.clone().requires_grad_(True)
    ops.dwconv3x3(xg, k, b, gelu=True, force="kernel").float().square().sum().backward()
    xp = x.clone().requires_grad_(True)
    ops.dwconv3x3(xp, k, b, gelu=True, force="torch").float().square().sum().backward()
    _close(xg.grad, xp.grad, 2.0 ** -5)


# per block form, launches of one forward/backward of B0 (2 blocks a stage,
# stage 4 composed)
TRAIN_FORMS = {
    ("full", "full", "full", None): {"mit_block_train": 6, "mit_block_train_bwd": 6,
                                     "block_ffn_train": 0, "dwconv3x3": 2},
    ("ffn", "ffn", "ffn", None): {"block_ffn_train": 6, "block_ffn_train_bwd": 6,
                                  "mit_block_train": 0, "dwconv3x3": 2},
    None: {"mit_block_train": 0, "block_ffn_train": 0, "dwconv3x3": 8},
}


@pytest.mark.parametrize("form", list(TRAIN_FORMS), ids=["full", "ffn", "composed"])
def test_train_step_gradients_through_the_kernels(dev, form):
    """A B0 train step at 64² on the card, bf16, in each block form: the
    gradients of parameters behind each kernel op (depthwise taps, CFM bias
    tables, q/kv of the decoder, the class convs behind the CE, the sr conv
    behind dK/dV) exist and are not zero, and the kernel path's gradients
    point where the plain path's do (cosine ≥ 0.99 over all parameters; bf16
    roundings at other points)."""
    import dataclasses

    from vss_cffm_tpu_torch import config as pcfg
    from vss_cffm_tpu_torch.models import CFFMSegmentor, set_force
    from vss_cffm_tpu_torch.train.step import device_normalize

    cfg = dataclasses.replace(pcfg.build_model_config("b0", num_classes=11),
                              train_block_impl=form)
    model = CFFMSegmentor(cfg, dtype=torch.bfloat16)
    model.init_weights(torch.Generator().manual_seed(0))
    model.to(dev).train()
    rng = np.random.RandomState(7)
    imgs = device_normalize(torch.from_numpy(
        rng.randint(0, 256, (1, 4, 64, 64, 3)).astype(np.uint8)).to(dev), torch.bfloat16)
    lab = _labels(rng, 4, 64, 64, 11, torch.uint8, dev).reshape(1, 4, 64, 64)
    from vss_cffm_tpu_torch.models.losses import clip_ce_loss

    grads = {}
    for force in (None, "torch"):
        set_force(model, force)
        model.zero_grad(set_to_none=True)
        ops.reset_launches()
        out = model(imgs, train=True, generator=torch.Generator(dev).manual_seed(1))
        clip_ce_loss(out, lab, force=force)["loss_seg"].backward()
        grads[force] = {n: p.grad.float().clone() for n, p in model.named_parameters()}
        if force is None:
            counts = ops.launches()
            assert counts["mit_block_fused"] == 0
            for name in ("dwconv3x3", "cfm_attention", "cfm_attention_bwd",
                         "ce_upsampled_loss", "ce_upsampled_loss_bwd"):
                assert counts[name] > 0, (name, counts)
            for name, n in TRAIN_FORMS[form].items():
                assert counts[name] == n, (form, name, counts)
    set_force(model, None)
    for name in ("backbone.block1.0.mlp.dwconv.dwconv.weight",
                 "backbone.block1.0.attn.sr.weight", "backbone.block3.1.mlp.fc1.weight",
                 "decode_head.decoder_focal.blocks.0.attn.relative_position_bias_table",
                 "decode_head.decoder_focal.blocks.0.attn.qkv.weight",
                 "decode_head.linear_pred.weight", "decode_head.linear_pred2.weight"):
        assert grads[None][name].abs().max() > 0, name
    a = torch.cat([g.reshape(-1) for g in grads[None].values()])
    b = torch.cat([g.reshape(-1) for g in grads["torch"].values()])
    assert torch.nn.functional.cosine_similarity(a, b, dim=0) >= 0.99


FFN_SHAPES = [((2, 9, 11, 32), 128), ((1, 7, 13, 160), 640), ((2, 4, 4, 256), 1024),
              ((1, 30, 30, 64), 256)]


@pytest.mark.parametrize("shape,ch", FFN_SHAPES)
def test_inference_ffn_kernels_match_plain(dev, shape, ch):
    """``block_ffn_fused``: its three launches against their plain steps
    (``block_ffn_train_step_errors`` without a scale), then the whole output
    held as out − x; ``mixffn_fused`` whole, 2^-6 of its largest value (bf16
    a and out rounded at the same points, one ulp carried through fc2)."""
    rng = np.random.RandomState(10)
    ins, _, _, _ = _block_train_inputs(rng, shape, ch, 4, dev)
    x, ffn = ins[0], ins[9:]
    for name, err, tol in ops.mixffn.block_ffn_train_step_errors(x, *ffn, None):
        assert err <= tol, (name, err, tol)
    got = ops.block_ffn_fused(x, *ffn, force="kernel")
    want = ops.block_ffn_fused(x, *ffn, force="torch")
    _close(got.float() - x.float(), want.float() - x.float(), WHOLE_REL)
    mix = (ffn[2], ffn[3], ffn[4], ffn[5], ffn[6], ffn[7])
    _close(ops.mixffn_fused(x, *mix, force="kernel"), ops.mixffn_fused(x, *mix, force="torch"),
           2.0 ** -6)


@pytest.mark.parametrize("n,h,w,c,s,ldt", [
    (2, 8, 12, 7, 4, torch.uint8), (1, 7, 9, 124, 4, torch.int32),
    (3, 6, 5, 40, 2, torch.uint8), (1, 30, 61, 124, 4, torch.uint8),
])
def test_ce_nll_kernels_match_plain(dev, n, h, w, c, s, ldt):
    """The per-pixel pair: nll and lse to 1e-5 of their largest value (f32
    from the same bf16 inputs, the lerp rounded as F.interpolate rounds it),
    pred on ≥ 99.9 % of the pixels (near-ties may pick either; ignored and
    out-of-range labels pick class 0 on both sides); dlogits for a per-pixel
    cotangent with zeros on the ignored pixels and on a share of the rest, 2^-7
    of the largest (one bf16 rounding of f32 sums in other orders)."""
    rng = np.random.RandomState(11)
    x = _rand(rng, n, h, w, c, scale=2.0, dev=dev)
    lab = _labels(rng, n, h * s, w * s, c, ldt, dev)
    got = ops.ce_upsampled_nll(x, lab, s, force="kernel")
    want = ops.ce_upsampled_nll(x, lab, s, force="torch")
    torch.cuda.synchronize()
    for i in (0, 2):
        _close(got[i], want[i], 1e-5)
    assert got[1].dtype == want[1].dtype == torch.int32
    assert (got[1] == want[1]).float().mean().item() >= 0.999
    keep = ((lab.long() < c) & torch.from_numpy(rng.rand(*lab.shape) < 0.7).to(dev)).float()
    g = _rand(rng, *lab.shape, dtype=torch.float32, dev=dev) * keep
    gk = ops.ce_upsampled_nll_bwd(x, lab, want[2], g, s, force="kernel")
    gp = ops.ce_upsampled_nll_bwd(x, lab, want[2], g, s, force="torch")
    _close(gk, gp, 2.0 ** -7)


def _b0_model(dev, **cfg_fields):
    import dataclasses

    from vss_cffm_tpu_torch import config as pcfg
    from vss_cffm_tpu_torch.models import CFFMSegmentor

    cfg = dataclasses.replace(pcfg.build_model_config("b0", num_classes=11), **cfg_fields)
    model = CFFMSegmentor(cfg, dtype=torch.bfloat16)
    model.init_weights(torch.Generator().manual_seed(0))
    return model.to(dev)


def test_fused_ffn_clip_on_the_card(dev):
    """B0 clip inference with ``dwconv_impl="fused"``: the FFN halves of
    stages 1 and 4 through ``block_ffn_fused`` (4 launches), no depthwise
    conv launch, the logits within 5 % of the largest plain logit."""
    from vss_cffm_tpu_torch.models import set_force
    from vss_cffm_tpu_torch.train.step import device_normalize

    model = _b0_model(dev, dwconv_impl="fused").eval()
    rng = np.random.RandomState(12)
    clip = device_normalize(torch.from_numpy(
        rng.randint(0, 256, (1, 4, 64, 96, 3)).astype(np.uint8)).to(dev), torch.bfloat16)
    ops.reset_launches()
    with torch.inference_mode():
        got = model(clip)
        counts = ops.launches()
        set_force(model, "torch")
        want = model(clip)
    assert counts["block_ffn_fused"] == 4 and counts["mit_block_fused"] == 4, counts
    assert counts["dwconv3x3"] == 0 and counts["mixffn_fused"] == 0, counts
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 0.05 * want.float().abs().max().item(), err


def test_ohem_train_step_goes_through_the_per_pixel_kernels(dev):
    """A B0 train step at 64² with OHEM and class weights: two
    ``ce_upsampled_nll`` launches and two of its backward, none of the fully
    reduced pair; the loss and the gradients against the plain path (loss
    1e-2 relative, cosine of all gradients ≥ 0.99). OHEM at its defaults
    keeps every valid pixel of a fresh model (a threshold inside the
    near-uniform probabilities would let bf16 roundings move pixels across
    it); the CPU tests hold a mask that bites."""
    from vss_cffm_tpu_torch import config as pcfg
    from vss_cffm_tpu_torch.models import set_force
    from vss_cffm_tpu_torch.models.losses import make_clip_loss
    from vss_cffm_tpu_torch.train.step import device_normalize

    cw = tuple(np.random.RandomState(13).uniform(0.5, 1.5, 11))
    loss_cfg = pcfg.LossConfig(use_ohem=True, class_weight=cw)
    model = _b0_model(dev).train()
    loss_of = make_clip_loss(loss_cfg)
    rng = np.random.RandomState(14)
    imgs = device_normalize(torch.from_numpy(
        rng.randint(0, 256, (1, 4, 64, 64, 3)).astype(np.uint8)).to(dev), torch.bfloat16)
    lab = _labels(rng, 4, 64, 64, 11, torch.uint8, dev).reshape(1, 4, 64, 64)
    runs = {}
    for force in (None, "torch"):
        set_force(model, force)
        model.zero_grad(set_to_none=True)
        ops.reset_launches()
        out = model(imgs, train=True, generator=torch.Generator(dev).manual_seed(1))
        loss = loss_of(out, lab, force=force)["loss_seg"]
        loss.backward()
        runs[force] = (loss.item(), ops.launches(),
                       torch.cat([p.grad.float().reshape(-1) for p in model.parameters()]))
    set_force(model, None)
    counts = runs[None][1]
    assert counts["ce_upsampled_nll"] == 2 and counts["ce_upsampled_nll_bwd"] == 2, counts
    assert counts["ce_upsampled_loss"] == 0 and counts["ce_upsampled_loss_bwd"] == 0, counts
    assert np.isfinite(runs[None][0])
    assert abs(runs[None][0] - runs["torch"][0]) <= 1e-2 * abs(runs["torch"][0])
    assert torch.nn.functional.cosine_similarity(runs[None][2], runs["torch"][2], dim=0) >= 0.99
