"""PyTorch port, on the card: each CUDA kernel against its plain version at
shapes beyond the main path's (odd maps, ragged row tiles, grouped K/V,
several head counts, ragged window tiles, ignored labels, B0 widths, zero
branch scales, C = 7 and 124 classes), in bf16; the CFM attention's
probabilities pair (f32 and bf16 probabilities) and the CE loss pair's
label-layout variants (odd h, ragged column segments); train steps in each
block form, with OHEM and class weights, and with the CFM attention's
backward from probabilities, whose gradients go through the kernels; B0 clip
inference with the fused FFN; the redesigned block_gemm (rows 1, 6-11), CE
backward (rows 17, 13) and CE forward (rows 14, 12) at the path's shapes and
at ragged ones, with forced plans, two runs bitwise equal, and the CE
microbench's phase-layout backwards and forwards on those two templates
(rows 15, 19 and 16, 18), pinned to rows 17 and 14 bit for bit; the
inference FFN launch of rows 1 and 8 (``ops/ffn_fused.py``) at the main
path's, eval's, TTA's and B0's shapes, with the f32 and the bf16 residual,
with and without its split, two runs bitwise equal, and its launch count;
the per-pixel CE backward's own kernel (row 13, ``csrc/ce_nll_bwd.cu``) with
cotangents zero on whole units, on a scattered half and nowhere; and
``mixffn_fused`` (row 9) on the FFN launch without its LayerNorm at B1's
four widths.

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
    ((1, 30, 30, 64), 256, 225, 1),   # the spatial-reduction attention of B1 stage 3's
    ((1, 30, 32, 128), 512, 225, 2),  # geometry: Lq 900 / 960, N 225, heads of 64
    ((1, 23, 40, 128), 512, 920, 2),  # test-time augmentation's keys at stage 2 (1.5x):
    ((1, 27, 47, 320), 1280, 1269, 5),  # the key-tiled attention; stage 3 at 1.75x
])
def test_mit_block_kernel_matches_plain(dev, shape, ch, s, nh):
    """The whole block, with weights scaled so that the attention and FFN
    branches are O(1) next to x, held as out − x so that a wrong branch
    cannot hide under the residual; then each of its launches (q, ctx, y
    and the FFN launch, alone and with the residual y) against its plain
    steps, at a tolerance relative to its own output
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
    """``block_ffn_fused``: its launch against the plain steps, alone and with
    the residual (``block_ffn_fused_step_errors``), and the three launches it
    replaced, which the composed path keeps, against
    theirs (``block_ffn_train_step_errors`` without a scale); then the whole
    output held as out − x; ``mixffn_fused`` whole, 2^-6 of its largest value
    (bf16 a and out rounded at the same points, one ulp carried through
    fc2)."""
    rng = np.random.RandomState(10)
    ins, _, _, _ = _block_train_inputs(rng, shape, ch, 4, dev)
    x, ffn = ins[0], ins[9:]
    for name, err, tol in (ops.mixffn.block_ffn_fused_step_errors(x, *ffn)
                           + ops.mixffn.block_ffn_train_step_errors(x, *ffn, None)):
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


@pytest.mark.parametrize("nw,nh,hd,gsizes,p_dtype", [
    (10, 2, 32, [49, 20, 9], torch.float32),                  # a ragged window tile
    (11, 8, 32, [49, 132, 25, 49, 25, 9], torch.float32),     # the B1 decoder's groups
    (3, 2, 64, [49, 71], torch.float32),
    (5, 4, 64, [49, 30], torch.bfloat16),
    (7, 2, 32, [78], torch.bfloat16),
])
def test_cfm_attention_probs_kernels_match_plain(dev, monkeypatch, nw, nh, hd, gsizes, p_dtype):
    """The forward with its probabilities output: out to 2^-6 of its largest
    value (as without), f32 p to 2^-14 of its largest (f32 softmaxes of the
    same inputs, scores summed in other orders), bf16 p to 2^-7 (one ulp
    where that difference crosses a rounding boundary). The backward from the
    plain forward's p: dq, dK, dV to 2^-6, dbias to 2^-10, as row 4's."""
    import importlib

    monkeypatch.setattr(importlib.import_module("vss_cffm_tpu_torch.ops.cfm_attention"),
                        "_PROBS_DTYPE", p_dtype)
    rng = np.random.RandomState(15)
    c = nh * hd
    n = sum(gsizes)
    q = _rand(rng, nw, 49, c, dev=dev)
    ks = [_rand(rng, nw, gs, c, dev=dev) for gs in gsizes]
    vs = [_rand(rng, nw, gs, c, dev=dev) for gs in gsizes]
    g = _rand(rng, nw, 49, c, dev=dev)
    bias = _rand(rng, nh, 49, n, dtype=torch.float32, dev=dev)
    mask = torch.from_numpy(np.where(rng.rand(nw, n) < 0.2, -100.0, 0.0)
                            .astype(np.float32)).to(dev)
    ops.reset_launches()
    out_k, p_k = ops.cfm_attention_probs(q, ks, vs, bias, mask, nh, force="kernel")
    out_p, p_p = ops.cfm_attention_probs(q, ks, vs, bias, mask, nh, force="torch")
    assert ops.launches()["cfm_attention"] == 1
    assert p_k.dtype == p_dtype and tuple(p_k.shape) == (nw, nh, 49, n)
    _close(out_k, out_p, 2.0 ** -6)
    _close(p_k, p_p, 2.0 ** -14 if p_dtype == torch.float32 else 2.0 ** -7)
    k, v = torch.cat(ks, 1), torch.cat(vs, 1)
    got = ops.cfm_attention_bwd_probs(q, k, v, p_p, g, nh, force="kernel")
    want = ops.cfm_attention_bwd_probs(q, k, v, p_p, g, nh, force="torch")
    assert ops.launches()["cfm_attention_bwd_probs"] == 1
    for a, b, rel in zip(got, want, (2.0 ** -6,) * 3 + (2.0 ** -10,)):
        _close(a, b, rel)


@pytest.mark.parametrize("n,h,w,c,s,ldt", [
    (2, 8, 12, 7, 4, torch.uint8), (1, 7, 9, 124, 4, torch.uint8),
    (3, 5, 33, 40, 4, torch.uint8), (1, 30, 61, 124, 4, torch.uint8),
    (2, 9, 10, 19, 2, torch.uint8),
])
def test_ce_variant_kernels_match_plain(dev, n, h, w, c, s, ldt):
    """The four label-layout variants against their plain versions: wsum to
    1e-4 relative and the correct count within 1e-3 of the pixels (as row
    14's); the f32 dlogits to 2^-14 of their largest value (f32 sums of the
    same terms in other orders, the lerp rounded as F.interpolate rounds
    it). Odd h (the TPU backwards refuse it), column segments with ragged
    tails (w 33, 61), s 4 and 2; int32 labels with values past 255 and below
    0 give the uint8 labels' results."""
    rng = np.random.RandomState(16)
    x = _rand(rng, n, h, w, c, scale=2.0, dev=dev)
    lab = _labels(rng, n, h * s, w * s, c, ldt, dev)
    ph = ops.labels_to_phase(lab, s).contiguous()
    phw = ops.labels_to_phase_w(lab, s).contiguous()
    img_w, g = 0.5 / lab.numel(), torch.tensor(1.7, device=dev)
    ops.reset_launches()
    for op in (ops.ce_fwd_loss_v5, ops.ce_fwd_loss_v3):
        got = op(x, phw, s, img_w, force="kernel")
        want = op(x, phw, s, img_w, force="torch")
        torch.cuda.synchronize()
        assert abs(got[0].item() - want[0].item()) <= 1e-4 * abs(want[0].item()), op
        assert abs(got[1].item() - want[1].item()) <= max(1.0, 1e-3 * lab.numel()), op
    for op, labels in ((ops.ce_bwd_loss_v2, ph), (ops.ce_bwd_loss_v3, phw)):
        gk = op(x, labels, g, s, img_w, force="kernel")
        gp = op(x, labels, g, s, img_w, force="torch")
        assert gk.dtype == torch.float32
        _close(gk, gp, 2.0 ** -14)
    assert {k: v for k, v in ops.launches().items() if v} == {
        "ce_fwd_loss_v5": 1, "ce_fwd_loss_v3": 1, "ce_bwd_loss_v2": 1, "ce_bwd_loss_v3": 1}
    # int32 labels, some past 255 or below 0 (ignored as every label outside
    # [0, C)): the kernels give what they give for the same labels in uint8
    wide = phw.int().clone()
    out = wide >= c
    wide[out] = torch.from_numpy(rng.choice([-7, 255, 300, 1000], int(out.sum()))).to(
        dev, torch.int32)
    got = ops.ce_fwd_loss_v5(x, wide, s, img_w, force="kernel")
    want = ops.ce_fwd_loss_v5(x, phw, s, img_w, force="kernel")
    assert got[0].item() == want[0].item() and got[1].item() == want[1].item()
    assert torch.equal(ops.ce_bwd_loss_v3(x, wide, g, s, img_w, force="kernel"),
                       ops.ce_bwd_loss_v3(x, phw, g, s, img_w, force="kernel"))


def test_ce_runtime_phase_loop_takes_any_scale(dev):
    """The v3 pair's runtime loop at s = 3 (the unrolled variants take 2 and 4
    and refuse 3)."""
    rng = np.random.RandomState(17)
    x = _rand(rng, 1, 6, 11, 40, scale=2.0, dev=dev)
    lab = _labels(rng, 1, 18, 33, 40, torch.uint8, dev)
    phw = ops.labels_to_phase_w(lab, 3).contiguous()
    img_w, g = 0.5 / lab.numel(), torch.tensor(0.8, device=dev)
    got = ops.ce_fwd_loss_v3(x, phw, 3, img_w, force="kernel")
    want = ops.ce_fwd_loss_v3(x, phw, 3, img_w, force="torch")
    assert abs(got[0].item() - want[0].item()) <= 1e-4 * abs(want[0].item())
    _close(ops.ce_bwd_loss_v3(x, phw, g, 3, img_w, force="kernel"),
           ops.ce_bwd_loss_v3(x, phw, g, 3, img_w, force="torch"), 2.0 ** -14)
    with pytest.raises(ValueError, match="does not take"):
        ops.ce_fwd_loss_v5(x, phw, 3, img_w, force="kernel")


def test_train_step_with_the_probabilities_backward(dev, monkeypatch):
    """A B0 train step at 64² with ``_BWD = "kernel"``: every CFM attention
    forward writes p and every backward reads it (as many
    ``cfm_attention_bwd_probs`` launches as forwards, no recompute backward);
    the loss and the gradients against the plain path in the same mode (loss
    1e-2 relative, cosine of all gradients ≥ 0.99)."""
    import importlib

    from vss_cffm_tpu_torch.models import set_force
    from vss_cffm_tpu_torch.models.losses import clip_ce_loss
    from vss_cffm_tpu_torch.train.step import device_normalize

    monkeypatch.setattr(importlib.import_module("vss_cffm_tpu_torch.ops.cfm_attention"),
                        "_BWD", "kernel")
    model = _b0_model(dev, train_block_impl=("full", "full", "full", None)).train()
    rng = np.random.RandomState(18)
    imgs = device_normalize(torch.from_numpy(
        rng.randint(0, 256, (1, 4, 64, 64, 3)).astype(np.uint8)).to(dev), torch.bfloat16)
    lab = _labels(rng, 4, 64, 64, 11, torch.uint8, dev).reshape(1, 4, 64, 64)
    runs = {}
    for force in (None, "torch"):
        set_force(model, force)
        model.zero_grad(set_to_none=True)
        ops.reset_launches()
        out = model(imgs, train=True, generator=torch.Generator(dev).manual_seed(1))
        loss = clip_ce_loss(out, lab, force=force)["loss_seg"]
        loss.backward()
        runs[force] = (loss.item(), ops.launches(),
                       torch.cat([p.grad.float().reshape(-1) for p in model.parameters()]))
    set_force(model, None)
    counts = runs[None][1]
    depth = model.config.head.decoder.depth
    assert counts["cfm_attention"] == depth and counts["cfm_attention_bwd_probs"] == depth, counts
    assert counts["cfm_attention_bwd"] == 0 and counts["mit_block_train_bwd"] == 6, counts
    assert all(v == 0 for v in runs["torch"][1].values())
    assert np.isfinite(runs[None][0])
    assert abs(runs[None][0] - runs["torch"][0]) <= 1e-2 * abs(runs["torch"][0])
    assert torch.nn.functional.cosine_similarity(runs[None][2], runs["torch"][2], dim=0) >= 0.99


def _cfm_inputs(rng, nw, area, nh, hd, n, dev):
    """q, K, V, bias and a -100 mask (20 % of the keys) whose window 0 keeps
    one key only."""
    c = nh * hd
    q = _rand(rng, nw, area, c, dev=dev)
    k = _rand(rng, nw, n, c, dev=dev)
    v = _rand(rng, nw, n, c, dev=dev)
    bias = _rand(rng, nh, area, n, dtype=torch.float32, dev=dev)
    mask = np.where(rng.rand(nw, n) < 0.2, -100.0, 0.0).astype(np.float32)
    mask[0] = -100.0
    mask[0, n // 2] = 0.0
    return q, k, v, bias, torch.from_numpy(mask).to(dev)


@pytest.mark.parametrize("area,n,hd", [
    (49, 5, 32),     # N below one 16-key step
    (49, 37, 32),    # N not a multiple of it
    (49, 289, 32),   # the B1 decoder's N, 19 steps
    (100, 100, 32),  # Lq past one 64-row tile
    (49, 23, 64),
    (100, 90, 64),
])
@pytest.mark.parametrize("p_dtype", [torch.float32, torch.bfloat16])
def test_cfm_attention_kernel_edges(dev, monkeypatch, area, n, hd, p_dtype):
    """The forward at the edges of its tiles, with and without its
    probabilities output: out to 2^-6, f32 p to 2^-14, bf16 p to 2^-7 of the
    largest value (as at the main path's shapes); a window masked on all keys
    but one puts all its weight there."""
    import importlib

    monkeypatch.setattr(importlib.import_module("vss_cffm_tpu_torch.ops.cfm_attention"),
                        "_PROBS_DTYPE", p_dtype)
    rng = np.random.RandomState(19)
    nh = 2
    q, k, v, bias, mask = _cfm_inputs(rng, 3, area, nh, hd, n, dev)
    _close(ops.cfm_attention(q, [k], [v], bias, mask, nh, force="kernel"),
           ops.cfm_attention(q, [k], [v], bias, mask, nh, force="torch"), 2.0 ** -6)
    out_k, p_k = ops.cfm_attention_probs(q, [k], [v], bias, mask, nh, force="kernel")
    out_p, p_p = ops.cfm_attention_probs(q, [k], [v], bias, mask, nh, force="torch")
    _close(out_k, out_p, 2.0 ** -6)
    _close(p_k, p_p, 2.0 ** -14 if p_dtype == torch.float32 else 2.0 ** -7)
    assert (p_k[0, :, :, n // 2].float() > 0.99).all()


def _bwd_tiles(n_w, nh, n, hd, mode):
    """(windows per block, blocks, the most blocks per head) as the backward's
    wrapper picks them."""
    import importlib

    mod = importlib.import_module("vss_cffm_tpu_torch.ops.cfm_attention")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cap = mod.blocks_per_sm("bwd", n, hd, 0, mode) * sms // nh
    tw = -(-n_w // max(1, min(n_w, cap)))
    return tw, -(-n_w // tw), cap


@pytest.mark.parametrize("nw,nh,hd,n,p_dtype", [
    (3, 2, 32, 5, None),                 # N below one 16-key step
    (3, 2, 32, 37, None),                # N not a multiple of it
    (3, 2, 32, 300, torch.float32),      # five 64-key tiles, the last one ragged
    (4, 2, 64, 90, torch.bfloat16),      # head dim 64
    (None, 8, 32, 289, None),            # None: a window count whose last window
    (None, 8, 32, 289, torch.float32),   # tile is shorter than the others
    (None, 2, 32, 78, torch.bfloat16),
])
def test_cfm_attention_bwd_kernel_edges(dev, nw, nh, hd, n, p_dtype):
    """The backward, recomputing the softmax (p_dtype None) or from the plain
    forward's p in f32 or bf16, at the edges of its key steps and tiles and
    with a last window tile shorter than the others: dq, dK, dV to 2^-6 and
    dbias to 2^-10 of each one's largest value, as at the main path's shapes."""
    mode = 0 if p_dtype is None else 1 if p_dtype == torch.float32 else 2
    if nw is None:  # past one window per block, the first count with a ragged last tile
        nw = _bwd_tiles(1, nh, n, hd, mode)[2] + 1
        while nw % _bwd_tiles(nw, nh, n, hd, mode)[0] == 0:
            nw += 1
        tw, tiles, _ = _bwd_tiles(nw, nh, n, hd, mode)
        assert tw > 1 and tiles > 1 and nw % tw != 0, (nw, tw, tiles)
    rng = np.random.RandomState(20)
    q, k, v, bias, mask = _cfm_inputs(rng, nw, 49, nh, hd, n, dev)
    g = _rand(rng, nw, 49, nh * hd, dev=dev)
    if p_dtype is None:
        got = ops.cfm_attention_bwd(q, k, v, bias, mask, g, nh, force="kernel")
        want = ops.cfm_attention_bwd(q, k, v, bias, mask, g, nh, force="torch")
    else:
        _, p = ops.cfm_attention_probs_torch(q, [k], [v], bias, mask, nh)
        p = p.to(p_dtype)
        got = ops.cfm_attention_bwd_probs(q, k, v, p, g, nh, force="kernel")
        want = ops.cfm_attention_bwd_probs(q, k, v, p, g, nh, force="torch")
    for a, b, rel in zip(got, want, (2.0 ** -6,) * 3 + (2.0 ** -10,)):
        _close(a, b, rel)


@pytest.mark.parametrize("p_dtype", [None, torch.float32, torch.bfloat16])
def test_cfm_attention_bwd_is_deterministic(dev, p_dtype):
    """Two backward runs on the same inputs are bitwise equal (the dbias
    partials are summed in a fixed order, no atomics), at the train step's
    window count."""
    rng = np.random.RandomState(21)
    q, k, v, bias, mask = _cfm_inputs(rng, 162, 49, 8, 32, 289, dev)
    g = _rand(rng, 162, 49, 256, dev=dev)
    if p_dtype is None:
        run = lambda: ops.cfm_attention_bwd(q, k, v, bias, mask, g, 8, force="kernel")
    else:
        p = ops.cfm_attention_probs_torch(q, [k], [v], bias, mask, 8)[1].to(p_dtype)
        run = lambda: ops.cfm_attention_bwd_probs(q, k, v, p, g, 8, force="kernel")
    first, second = run(), run()
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_attention_softmax_division_is_the_operators(dev):
    """The attention kernels' p = e / sum (``vss::div_rn``: a reciprocal per
    row, two corrections, no branch) against the ``/`` operator on the
    kernels' operands: e = exp(x) for x in [-110, 0], and e of every binary
    exponent down to 2^-149, over sums in [1, 4096]. Bit for bit for a
    quotient of 2^-110 or more; below it (a p that no tolerance sees, where
    the remainder can fall under the subnormal grid) within one ulp."""
    from vss_cffm_tpu_torch.ops import _build
    from vss_cffm_tpu_torch.ops._dispatch import ptr, stream_of

    gen = torch.Generator().manual_seed(23)
    n = 1 << 24
    k = torch.arange(0, 150).repeat_interleave(4096)
    a = torch.cat([torch.exp(-110.0 * torch.rand(n, generator=gen, dtype=torch.float64)),
                   (1.0 + torch.rand(k.numel(), generator=gen, dtype=torch.float64))
                   * torch.pow(2.0, -k.double()),
                   torch.tensor([1.0, 0.0, 1.0, 1.0], dtype=torch.float64)]).float()
    b = torch.cat([1.0 + 4095.0 * torch.rand(n + k.numel(), generator=gen),
                   torch.tensor([1.0, 289.0, 3.0, 4096.0])])
    a, b = a.to(dev), b.to(dev)
    q, q_ref = torch.empty_like(a), torch.empty_like(a)
    op = "attention_div_check"
    dev_i, stream = stream_of(a)
    _build.check(_build.library("attention").attention_div_check(
        ptr(a, op), ptr(b, op), ptr(q, op), ptr(q_ref, op), a.numel(), dev_i, stream), op)
    torch.cuda.synchronize()
    big = q_ref >= 2.0 ** -110
    assert big.float().mean().item() > 0.6
    assert torch.equal(q[big], q_ref[big])
    small, small_ref = q[~big].double(), q_ref[~big].double()
    assert ((small - small_ref).abs() <= 2.0 ** -23 * small_ref + 2.0 ** -149).all()


# ---- the redesigned depthwise conv (row 3) and row 7's fused launches --------

@pytest.mark.parametrize("shape,rows,f32_in", [
    ((4, 120, 120, 256), None, False), ((4, 15, 15, 2048), None, False),   # inference, B1
    ((8, 15, 15, 2048), None, False), ((8, 120, 120, 256), None, True),    # train; hid in f32
    ((2, 13, 7, 24), 5, False), ((1, 9, 11, 16), 4, True),                 # strips of 5, 5, 3; 4, 4, 1
    ((2, 6, 3, 8), 1, False), ((1, 5, 5, 40), 7, True),                    # one row a strip; one strip
])
def test_dwconv_strips_match_plain(dev, monkeypatch, shape, rows, f32_in):
    """The strip kernel against the plain version at the main path's shapes
    (its own strip plan) and with strips forced to lengths that do not divide
    H: out (GELU) to one bf16 ulp, z to one ulp; two runs bitwise equal."""
    if rows is not None:
        monkeypatch.setattr(ops.dwconv, "strip_plan", lambda *a: (rows, -(-shape[1] // rows)))
    rng = np.random.RandomState(30)
    c = shape[-1]
    x = _rand(rng, *shape, dtype=torch.float32 if f32_in else torch.bfloat16, dev=dev)
    k = _rand(rng, 3, 3, 1, c, scale=0.3, dtype=torch.float32, dev=dev)
    b = _rand(rng, c, scale=0.1, dtype=torch.float32, dev=dev)
    z = torch.empty(shape, device=dev, dtype=torch.bfloat16)
    got = ops.dwconv.dwconv3x3_launch(x, k, b, True, z=z)
    _close(got, ops.dwconv3x3_torch(x, k, b, True).to(torch.bfloat16), 2.0 ** -7)
    _close(z, ops.dwconv._preact(x, k, b).to(torch.bfloat16), 2.0 ** -7)
    z2 = torch.empty_like(z)
    again = ops.dwconv.dwconv3x3_launch(x, k, b, True, z=z2)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.equal(z, z2)


SRA_SHAPES = [
    ((8, 120, 120, 64), 225, 1, None), ((8, 60, 60, 128), 225, 2, None),   # B1 stages 1-3 at 480²
    ((8, 30, 30, 320), 225, 5, None),
    ((2, 9, 11, 64), 20, 1, 1),      # 99 queries: a last tile of 35 rows; a split a tile
    ((1, 17, 9, 64), 15, 2, 2),      # heads of 32; 153 queries in splits of 2 tiles and 1
    ((3, 10, 10, 32), 236, 1, None), # head dim 32 at 236 keys: a last key chunk of 16
    ((1, 20, 20, 64), 233, 1, 3),    # the most keys the block holds at head dim 64
    ((2, 4, 4, 64), 9, 1, None),     # one 16-key step: the second warp group has no keys
]


@pytest.mark.parametrize("shape,s,nh,tps", SRA_SHAPES)
def test_sra_attention_bwd_fused_matches_plain(dev, monkeypatch, shape, s, nh, tps):
    """The attention backward with dK and dV fused (p and d_s never written)
    against its plain step, each output at ``BWD_STEP_TOLERANCE``, at the
    main path's shapes and at ragged ones (a last tile short of 64 queries,
    splits of forced lengths with a short last one, a last key chunk of 16,
    a second warp group with no keys); two runs bitwise equal (the split
    partials summed in a fixed order)."""
    sb = ops.stage_block
    if tps is not None:
        monkeypatch.setattr(sb, "sra_bwd_splits", lambda b, h, ntq, slots: (tps, -(-ntq // tps)))
    b, h, w, c = shape
    rng = np.random.RandomState(31)
    q = _rand(rng, b * h * w, c, dev=dev)
    k, v = _rand(rng, b, s, c, dev=dev), _rand(rng, b, s, c, dev=dev)
    g = _rand(rng, b * h * w, c, scale=0.5, dev=dev)
    run = lambda kernel: sb.sra_attention_bwd(q, k, v, g, shape, nh, torch.bfloat16,
                                              kernel=kernel, op="sra_attention_bwd")
    got, want = run(True), run(False)
    assert set(got) == set(want) == {"d_q", "dbq", "dk", "dv"}
    for key in got:
        _close(got[key], want[key], sb.BWD_STEP_TOLERANCE[key])
    again = run(True)
    torch.cuda.synchronize()
    assert all(torch.equal(got[key], again[key]) for key in got)


def test_sra_attention_bwd_smem_is_the_kernels(dev):
    """The gate's shared-memory sum (``sra_attention_bwd_smem``, which the CPU
    gate reads) equals the kernel's own layout, which its launch asks for."""
    from vss_cffm_tpu_torch.ops import _build

    lib = _build.library("sra_attention_bwd")
    for s in (1, 15, 225, 233, 234, 512, 513):
        for hd in (32, 64):
            assert lib.sra_attention_bwd_smem_bytes(s, hd) == \
                ops.stage_block.sra_attention_bwd_smem(s, hd), (s, hd)
    assert lib.sra_attention_bwd_blocks_per_sm(225, 64, 0) >= 1


@pytest.mark.parametrize("shape,rows", [
    ((8, 120, 120, 256), None), ((8, 60, 60, 512), None), ((8, 30, 30, 1280), None),  # B1
    ((2, 23, 19, 64), 6),    # strips of 6, 6, 6, 5; column tiles of 8, 8, 3
    ((1, 9, 11, 40), 4),     # 40 channels: a slab of 8 live lanes
    ((2, 5, 4, 128), 1),     # one row a strip, a map narrower than a tile
])
def test_dz_dhid_fused_matches_plain(dev, monkeypatch, shape, rows):
    """The d_z → d_hid pass (d_z on chip) against its plain step, each output at
    ``BWD_STEP_TOLERANCE``, at the main path's shapes and at strips and tiles
    that do not divide the map; two runs bitwise equal."""
    sb = ops.stage_block
    b, h, w, ch = shape
    if rows is not None:
        monkeypatch.setattr(sb, "dz_dhid_plan", lambda *a: (rows, -(-h // rows), -(-w // 8)))
    rng = np.random.RandomState(32)
    f = lambda *sh, sc: _rand(rng, *sh, scale=sc, dtype=torch.float32, dev=dev)
    d_a, hid = f(*shape, sc=0.5), f(*shape, sc=1.0)
    kdw, bdw = f(3, 3, 1, ch, sc=1 / 3), f(ch, sc=0.1)
    run = lambda kernel: sb.dz_dhid(d_a, hid, kdw, bdw, torch.bfloat16, kernel=kernel, op="dz_dhid")
    got, want = run(True), run(False)
    assert set(got) == set(want) == {"d_hid", "db1", "dkdw", "dbdw"}
    for key in got:
        _close(got[key], want[key], sb.BWD_STEP_TOLERANCE[key])
    again = run(True)
    torch.cuda.synchronize()
    assert all(torch.equal(got[key], again[key]) for key in got)


def _ohem_biting(rng, n, h, w, c, s, dev):
    """bf16 logits with a margin of 30 on the label class at half the
    low-resolution pixels (easy: p ≈ 1), labels constant on each s x s block,
    5 % ignored: an OHEM mask at thresh 0.7 keeps about the other half."""
    low = rng.randint(0, c, (n, h, w))
    logits = rng.randn(n, h, w, c).astype(np.float32)
    easy = rng.rand(n, h, w) < 0.5
    logits[easy, low[easy]] += 30.0
    lab = low.repeat(s, 1).repeat(s, 2)
    lab[rng.rand(*lab.shape) < 0.05] = 255
    return (torch.from_numpy(logits).to(dev, torch.bfloat16),
            torch.from_numpy(lab.astype(np.uint8)).to(dev))


@pytest.mark.parametrize("n,h,w,c,min_kept,cw", [(2, 30, 30, 19, 1000, False),
                                                  (4, 24, 36, 124, 3000, True)])
def test_ohem_cuda_path_with_a_partial_mask(dev, n, h, w, c, min_kept, cw):
    """The OHEM CUDA path (rows 12, 13, the sort and the k-th threshold)
    against the plain path with a mask that keeps 25-75 % of the valid
    pixels: the kept flags equal, the loss to 1e-4 relative, dlogits (for the
    plain route's weights on both) to one bf16 ulp of the largest."""
    from vss_cffm_tpu_torch.models import losses

    rng = np.random.RandomState(33)
    logits, lab = _ohem_biting(rng, n, h, w, c, 4, dev)
    weights = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)).to(dev) if cw else None
    r = losses.ohem_path_errors(logits, lab, 4, 0.7, min_kept, weights)
    assert 0.25 <= r["kept"] <= 0.75, r["kept"]
    assert r["flag_differs"] == 0 and r["kept"] == r["kept_plain"]
    lk, lp = r["loss"]
    assert abs(lk - lp) <= 1e-4 * abs(lp)
    _close(*r["dlogits"], 2.0 ** -7)


# ---- the redesigned block_gemm (row 6, shared by rows 1, 7-11) and CE
# backward (rows 17 and 13) -----------------------------------------------------

def _gemm_plain(a, w, bias, out_dtype, ln=None, res=None, a_scale=None, o_scale=None,
                rows_per_frame=1):
    """block_gemm's steps with its rounding points: LN in f32 (or A times its
    frame's scale), bf16 before the product, f32 sums, bias, scale, residual,
    the output dtype."""
    sb = ops.stage_block
    af = a.float()
    if ln is not None:
        af = sb._ln_f32(af, ln[0].float(), ln[1].float(), ln[2])
    elif a_scale is not None:
        af = af * sb._frame_rows(a_scale, rows_per_frame)
    out = af.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float()
    if bias is not None:
        out = out + bias.float()
    if o_scale is not None:
        out = out * sb._frame_rows(o_scale, rows_per_frame)
    if res is not None:
        out = out + res.float()
    return out.to(out_dtype)


# (M, N, K, LN, A dtype, out dtype, residual dtype, a_scale, o_scale, rows a
# frame): the B1 train step's launches at stages 1 and 3 (q, y, hid, out; d_a,
# d_ln2, d_ctx), row 8's stage-4 FFN, and ragged ones (M short of a 64-row
# block, N = 8 x odd, K not a multiple of the 32-deep K step)
F32, BF16 = torch.float32, torch.bfloat16
GEMM_CASES = [
    (115200, 64, 64, True, BF16, BF16, None, False, False, 14400),
    (115200, 64, 64, False, BF16, F32, BF16, False, True, 14400),
    (115200, 256, 64, True, F32, F32, None, False, False, 14400),
    (115200, 64, 256, False, BF16, BF16, F32, False, True, 14400),
    (115200, 256, 64, False, BF16, F32, None, True, False, 14400),
    (115200, 64, 256, False, BF16, F32, None, False, False, 14400),
    (7200, 320, 320, True, BF16, BF16, None, False, False, 900),
    (7200, 1280, 320, True, F32, F32, None, False, False, 900),
    (7200, 320, 1280, False, BF16, BF16, F32, False, True, 900),
    (7200, 320, 1280, False, BF16, F32, None, False, False, 900),
    (900, 2048, 512, True, BF16, F32, None, False, False, 225),
    (900, 512, 2048, False, BF16, BF16, BF16, False, False, 225),
    (1000, 24, 40, True, F32, BF16, BF16, False, True, 250),
    (1000, 40, 24, False, BF16, F32, F32, True, True, 250),
    (1000, 72, 200, False, BF16, BF16, None, False, False, 250),
    (77, 200, 72, True, BF16, F32, F32, False, True, 7),
    (77, 136, 8, False, F32, F32, None, False, False, 77),
]


@pytest.mark.parametrize("split", [False, True], ids=["plan", "one_slab"])
@pytest.mark.parametrize("m,n,k,ln,adt,odt,rdt,a_sc,o_sc,rpf", GEMM_CASES)
def test_block_gemm_matches_plain(dev, monkeypatch, split, m, n, k, ln, adt, odt, rdt, a_sc,
                                  o_sc, rpf):
    """block_gemm against its plain steps at the path's launch shapes and at
    ragged ones, with the plan's column runs and with one slab a block (every
    row block's A read once per run): f32 outputs held as the branch (out −
    residual) to 2^-10 of its largest value (the same bf16 inputs, f32 sums
    in another order), or 2^-7 after a LayerNorm (its bf16 output may flip
    one ulp); bf16 outputs to 2^-7 (one rounding); two runs bitwise equal."""
    sb = ops.stage_block
    if split:
        monkeypatch.setattr(sb, "block_gemm_plan",
                            lambda m_, n_, k_, res, sms: ((1, 64) if n_ <= 64 else (2, 128)))
    rng = np.random.RandomState(40 + k)
    frames = -(-m // rpf)
    a = _rand(rng, m, k, dtype=adt, dev=dev)
    w = _rand(rng, k, n, scale=k ** -0.5, dev=dev)
    bias = _rand(rng, n, scale=0.1, dtype=F32, dev=dev)
    lnp = (_rand(rng, k, scale=0.2, dtype=F32, dev=dev) + 1, _rand(rng, k, scale=0.1, dtype=F32,
                                                                     dev=dev), 1e-6) if ln else None
    res = None if rdt is None else _rand(rng, m, n, dtype=rdt, dev=dev)
    sa = torch.from_numpy(rng.uniform(0.5, 1.5, frames).astype(np.float32)).to(dev) if a_sc else None
    so = torch.from_numpy(rng.uniform(0.5, 1.5, frames).astype(np.float32)).to(dev) if o_sc else None
    kw = dict(ln=lnp, res=res, a_scale=sa, o_scale=so, rows_per_frame=rpf)
    got = sb._gemm(a, w, bias, out_dtype=odt, **kw)
    want = _gemm_plain(a, w, bias, odt, **kw)
    torch.cuda.synchronize()
    if odt == F32:
        r = 0.0 if res is None else res.float()
        _close(got - r, want - r, 2.0 ** -7 if ln else 2.0 ** -10)
    else:
        _close(got, want, 2.0 ** -7)
    again = sb._gemm(a, w, bias, out_dtype=odt, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)


def test_block_gemm_smem_is_the_kernels(dev):
    """The plan's shared-memory sum (``block_gemm_smem``) equals the kernel's."""
    from vss_cffm_tpu_torch.ops import _build

    lib = _build.library("block_gemm")
    for k in (8, 24, 64, 320, 512, 1280, 2048):
        for res in (0, 1):
            for nb in (1, 2):
                assert lib.gemm_smem_bytes(k, res, nb) == ops.stage_block.block_gemm_smem(
                    k, bool(res), nb)


# (N, h, w, C, s, label dtype, plan): the train step's two branches, ragged
# maps, s 2 / 4 / 8, C 19 / 124 / 150, and forced plans (strips of 3 and 1
# column, segments of 2 rows: partials at every segment boundary)
CE_BWD_CASES = [
    (8, 120, 120, 124, 4, torch.uint8, None), (2, 120, 120, 124, 4, torch.int32, None),
    (2, 37, 53, 19, 2, torch.uint8, None), (1, 37, 53, 150, 8, torch.int32, None),
    (3, 13, 7, 124, 4, torch.uint8, (3, 6)), (2, 9, 10, 40, 2, torch.int32, (1, 4)),
]


@pytest.mark.parametrize("n,h,w,c,s,ldt,plan", CE_BWD_CASES)
def test_ce_bwd_redesign_matches_plain(dev, monkeypatch, n, h, w, c, s, ldt, plan):
    """Rows 17 and 13 against their plain versions, bf16 dlogits to 2^-7 of
    the largest (one rounding of f32 sums in other orders), with a strip of
    source pixels whose labels are all ignored (and whose per-pixel cotangent
    is 0); two runs bitwise equal."""
    ce = ops.ce_upsampled
    if plan is not None:
        g_, cpl = ce.ce_bwd_groups(c)
        monkeypatch.setattr(ce, "ce_bwd_plan", lambda *a: (plan[0], plan[1], g_ * cpl + 1))
        monkeypatch.setattr(ce, "ce_nll_bwd_plan", lambda *a: plan)
    rng = np.random.RandomState(50 + c)
    x = _rand(rng, n, h, w, c, scale=2.0, dev=dev)
    lab = _labels(rng, n, h * s, w * s, c, ldt, dev)
    lab[:, : 2 * s, : 3 * s] = 255  # every label of a 2 x 3 source tile ignored
    img_w = 0.5 / lab.numel()
    g = torch.tensor(1.3, device=dev)
    valid = lab.long() < c
    gn = _rand(rng, *lab.shape, dtype=torch.float32, dev=dev) * valid
    lse = ops.ce_upsampled_nll(x, lab, s, force="torch")[2].contiguous()
    runs = {
        17: lambda force: ops.ce_upsampled_loss_bwd(x, lab, g, s, img_w, force=force),
        13: lambda force: ops.ce_upsampled_nll_bwd(x, lab, lse, gn, s, force=force),
    }
    for row, run in runs.items():
        got, want = run("kernel"), run("torch")
        _close(got, want, 2.0 ** -7)
        again = run("kernel")
        torch.cuda.synchronize()
        assert torch.equal(got, again), row


# (N, h, w, C, s, label dtype, forced (tw, nseg) or None): the "ohem" step's
# two branches, ragged maps at s 2 / 4 / 8, C 19 / 124 / 150 / 256, and
# forced plans (strips of 3 and 1 column, segments of 1 and 2 rows)
CE_NLL_BWD_CASES = [
    (8, 120, 120, 124, 4, torch.uint8, None), (2, 120, 120, 124, 4, torch.int32, None),
    (2, 37, 53, 124, 2, torch.uint8, None), (1, 37, 53, 150, 8, torch.int32, None),
    (2, 37, 53, 19, 2, torch.uint8, None), (1, 21, 19, 256, 4, torch.uint8, None),
    (3, 13, 7, 124, 4, torch.uint8, (3, 6)), (2, 9, 10, 40, 2, torch.int32, (1, 9)),
    (1, 11, 13, 123, 3, torch.uint8, (2, 5)),
]


def _nll_cotangent(rng, lab, c, pattern, dev):
    """A per-pixel cotangent: 0 on ignored labels and on the pixels of
    ``pattern`` — "units": whole bands of output rows and columns, so that
    every pixel of some units is 0; "half": a scattered half; "none": 0
    nowhere (not even on the ignored labels, whose safe class is 0)."""
    n, hh, ww = lab.shape
    g = _rand(rng, n, hh, ww, dtype=torch.float32, dev=dev)
    if pattern == "none":
        return g
    g = g * (lab.long() < c)
    if pattern == "units":
        g[:, : hh // 2] = 0.0
        g[:, :, ww // 3: 2 * ww // 3] = 0.0
    else:
        g = g * torch.from_numpy(rng.rand(n, hh, ww) < 0.5).to(dev)
    return g


@pytest.mark.parametrize("n,h,w,c,s,ldt,plan", CE_NLL_BWD_CASES)
def test_ce_nll_bwd_kernel_matches_plain(dev, monkeypatch, n, h, w, c, s, ldt, plan):
    """Row 13's kernel against its plain version for each cotangent pattern
    (``_nll_cotangent``), bf16 dlogits to 2^-7 of the largest (one rounding of
    f32 sums in other orders), labels with 255 and ≥ C; two runs bitwise
    equal; one launch a call."""
    ce = ops.ce_upsampled
    if plan is not None:
        monkeypatch.setattr(ce, "ce_nll_bwd_plan", lambda *a: plan)
    rng = np.random.RandomState(60 + c + s)
    x = _rand(rng, n, h, w, c, scale=2.0, dev=dev)
    lab = _labels(rng, n, h * s, w * s, c, ldt, dev)
    lse = ops.ce_upsampled_nll(x, lab, s, force="torch")[2].contiguous()
    for pattern in ("units", "half", "none"):
        g = _nll_cotangent(rng, lab, c, pattern, dev)
        before = ops.ce_upsampled_nll_bwd.launches
        got = ops.ce_upsampled_nll_bwd(x, lab, lse, g, s, force="kernel")
        again = ops.ce_upsampled_nll_bwd(x, lab, lse, g, s, force="kernel")
        assert ops.ce_upsampled_nll_bwd.launches == before + 2
        _close(got, ops.ce_upsampled_nll_bwd(x, lab, lse, g, s, force="torch"), 2.0 ** -7)
        assert torch.equal(got, again), pattern


def test_ce_nll_bwd_smem_is_the_kernels(dev):
    """``ce_nll_bwd_smem`` equals the kernel's layout, and the step's plan
    holds at least 3 blocks an SM."""
    from vss_cffm_tpu_torch.ops import _build

    ce = ops.ce_upsampled
    lib = _build.library("ce_nll_bwd")
    for c in (19, 40, 123, 124, 150, 256):
        for s in (1, 2, 3, 4, 8):
            for tw in range(1, ce.ce_nll_bwd_strip_max(c) + 1):
                assert lib.ce_nll_bwd_smem_bytes(c, s, tw) == ce.ce_nll_bwd_smem(c, s, tw)
    for n in (8, 2):
        tw, _ = ce.ce_nll_bwd_plan(n, 120, 120, 124, 4, 132)
        assert lib.ce_nll_bwd_blocks_per_sm(124, 4, tw) >= 3


# (N, h, w, C, s, label dtype, forced strip width): the train step's two
# branches, ragged maps at s 2 / 4 / 8, C 19 / 124 / 150 / 256, and forced
# strips of 3 and 1 columns (ragged last strips)
CE_FWD_CASES = [
    (8, 120, 120, 124, 4, torch.uint8, None), (2, 120, 120, 124, 4, torch.int32, None),
    (2, 37, 53, 19, 2, torch.uint8, None), (1, 37, 53, 124, 4, torch.int32, None),
    (1, 37, 53, 150, 8, torch.uint8, None), (2, 37, 53, 256, 4, torch.int32, None),
    (3, 13, 7, 124, 4, torch.uint8, 3), (2, 9, 10, 40, 2, torch.int32, 1),
]


@pytest.mark.parametrize("n,h,w,c,s,ldt,tw", CE_FWD_CASES)
def test_ce_fwd_redesign_matches_plain(dev, monkeypatch, n, h, w, c, s, ldt, tw):
    """Rows 14 and 12 against their plain versions: wsum to 1e-4 relative, the
    correct count within 1e-4 of the valid pixels (at least 1: a near-tie may
    count either way), nll and lse to 1e-5 of the largest, pred on all but
    1e-4 of the pixels (at least 1); with the first band of every frame all
    ignored; two calls bitwise equal; then with three classes sharing bf16
    logits that lead every pixel (in different lanes): pred the first of
    them, as torch's argmax."""
    ce = ops.ce_upsampled
    if tw is not None:
        band = 32 // ce.ce_bwd_groups(c)[0]
        monkeypatch.setattr(ce, "ce_fwd_plan", lambda *a: (tw, band))
    rng = np.random.RandomState(70 + c)
    x = _rand(rng, n, h, w, c, scale=2.0, dev=dev)
    lab = _labels(rng, n, h * s, w * s, c, ldt, dev) if c < 256 else torch.from_numpy(
        rng.randint(-1, c, (n, h * s, w * s)).astype(np.int32)).to(dev, ldt)
    lab[:, :8] = 255 if c <= 255 else -1  # every label of a frame's first band ignored
    img_w = 0.5 / lab.numel()
    n_valid = int(((lab.long() >= 0) & (lab.long() < c)).sum())

    def check(x):
        got = ops.ce_upsampled_loss(x, lab, s, img_w, force="kernel")
        want = ops.ce_upsampled_loss(x, lab, s, img_w, force="torch")
        torch.cuda.synchronize()
        assert abs(got[0].item() - want[0].item()) <= 1e-4 * abs(want[0].item())
        assert abs(got[1].item() - want[1].item()) <= max(1.0, 1e-4 * n_valid)
        again = ops.ce_upsampled_loss(x, lab, s, img_w, force="kernel")
        assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
        maps = ops.ce_upsampled_nll(x, lab, s, force="kernel")
        plain = ops.ce_upsampled_nll(x, lab, s, force="torch")
        for i in (0, 2):
            _close(maps[i], plain[i], 1e-5)
        assert maps[1].dtype == torch.int32
        assert int((maps[1] != plain[1]).sum()) <= max(1, 1e-4 * lab.numel())
        again = ops.ce_upsampled_nll(x, lab, s, force="kernel")
        assert all(torch.equal(a, b) for a, b in zip(maps, again))
        return maps[1]

    check(x)
    t1, t2 = c // 3, c - 1
    x[..., t1] = x[..., t2] = x[..., 2 * c // 3] = x[..., 0] + 30.0
    assert (check(x) == t1).all()


def test_ce_fwd_smem_is_the_kernels(dev):
    """The forward plan's shared memory (``ce_fwd_smem``) is the layout the
    kernel launches with (``ce_fwd_smem_bytes``), at every class table row,
    scale and strip width; the train step's plan keeps 4 blocks an SM."""
    from vss_cffm_tpu_torch.ops import _build
    lib = _build.library("ce_upsampled")
    for c in (19, 64, 124, 256):
        for s in range(1, 9):
            for tw in (1, 8, 15):
                for pixel in (0, 1):
                    assert lib.ce_fwd_smem_bytes(c, s, tw, pixel) == ops.ce_upsampled.ce_fwd_smem(
                        c, s, tw, bool(pixel))
    # the plan's 4 blocks an SM at the train step
    for n in (8, 2):
        tw, _ = ops.ce_upsampled.ce_fwd_plan(n, 120, 120, 124, 4, 132)
        assert lib.ce_fwd_blocks_per_sm(124, 4, tw, 0) == lib.ce_fwd_blocks_per_sm(124, 4, tw, 1) == 4


# (N, h, w, C, s, rows, plan): rows 15 and 19 at the bench's two batches,
# ragged maps at s 2 and 4 (row 19, the runtime loop, also at s 3 and 8), C
# 19 / 40 / 124 / 256, and forced plans (strips of 3 and 1 column, segments
# of 2 rows: partials at every segment boundary)
CE_PHASE_BWD_CASES = [
    (8, 120, 120, 124, 4, (15, 19), None), (2, 120, 120, 124, 4, (15, 19), None),
    (2, 37, 53, 19, 2, (15, 19), None), (1, 37, 53, 124, 4, (15, 19), None),
    (1, 37, 53, 40, 3, (19,), None), (1, 37, 53, 256, 8, (19,), None),
    (3, 13, 7, 124, 4, (15, 19), (3, 6)), (2, 9, 10, 19, 2, (15, 19), (1, 4)),
    (1, 12, 9, 256, 4, (15, 19), (1, 3)),
]


@pytest.mark.parametrize("n,h,w,c,s,rows,plan", CE_PHASE_BWD_CASES)
def test_ce_phase_bwd_redesign_matches_plain(dev, monkeypatch, n, h, w, c, s, rows, plan):
    """Rows 15 (h-major labels) and 19 (w-major) on the loss backward's kernel
    against their plain versions: f32 dlogits to 2^-14 of the largest (f32
    sums of the same terms in other orders, the lerp rounded as
    F.interpolate rounds it), with a band of output rows whose labels are all
    ignored (C < 256: uint8 labels hold no ignored value at C 256); two runs
    bitwise equal; at s 4, where both coefficient rules agree, each rounded
    to bf16 is row 17's result on the same natural labels bit for bit."""
    ce = ops.ce_upsampled
    if plan is not None:
        g_, cpl = ce.ce_bwd_groups(c)
        monkeypatch.setattr(ce, "ce_bwd_plan", lambda *a: (plan[0], plan[1], g_ * cpl + 1))
    rng = np.random.RandomState(90 + c + s)
    x = _rand(rng, n, h, w, c, scale=2.0, dev=dev)
    if c < 256:
        lab = _labels(rng, n, h * s, w * s, c, torch.uint8, dev)
        lab[:, s: 3 * s] = 255  # every label of two source rows' output rows ignored
    else:
        lab = torch.from_numpy(rng.randint(0, 256, (n, h * s, w * s)).astype(np.uint8)).to(dev)
    img_w, g = 0.5 / lab.numel(), torch.tensor(1.3, device=dev)
    ops_by_row = {15: (ops.ce_bwd_loss_v2, ops.labels_to_phase(lab, s).contiguous()),
                  19: (ops.ce_bwd_loss_v3, ops.labels_to_phase_w(lab, s).contiguous())}
    row17 = ops.ce_upsampled_loss_bwd(x, lab, g, s, img_w, force="kernel") if s == 4 else None
    ops.reset_launches()
    for row in rows:
        op, labels = ops_by_row[row]
        got = op(x, labels, g, s, img_w, force="kernel")
        assert got.dtype == torch.float32
        _close(got, op(x, labels, g, s, img_w, force="torch"), 2.0 ** -14)
        again = op(x, labels, g, s, img_w, force="kernel")
        torch.cuda.synchronize()
        assert torch.equal(got, again), row
        if row17 is not None:
            assert torch.equal(got.to(torch.bfloat16), row17), row
    assert {k: v for k, v in ops.launches().items() if v} == {
        {15: "ce_bwd_loss_v2", 19: "ce_bwd_loss_v3"}[r]: 2 for r in rows}


def test_ce_phase_bwd_occupancy_is_row17s(dev):
    """Rows 15 and 19 keep row 17's blocks an SM at the bench's plans (the
    label addressing and the f32 stores cost no occupancy): 3, the launch
    bounds' cap."""
    from vss_cffm_tpu_torch.ops import _build
    lib = _build.library("ce_upsampled")
    for n in (8, 2):
        tw, _, cs = ops.ce_upsampled.ce_bwd_plan(n, 120, 120, 124, 4, 132)
        assert [lib.ce_bwd_blocks_per_sm(124, tw, cs, layout) for layout in (0, 1, 2)] == [3] * 3


# (N, h, w, C, s, rows, forced strip width): rows 16 and 18 at the bench's two
# batches, ragged maps at s 2 and 4 (row 18, the runtime loop, also at s 3
# and 8), C 19 / 40 / 124 / 256, and forced strips of 3 and 1 columns (ragged
# last strips)
CE_PHASE_FWD_CASES = [
    (8, 120, 120, 124, 4, (16, 18), None), (2, 120, 120, 124, 4, (16, 18), None),
    (2, 37, 53, 19, 2, (16, 18), None), (1, 37, 53, 124, 4, (16, 18), None),
    (1, 37, 53, 40, 3, (18,), None), (1, 37, 53, 256, 8, (18,), None),
    (3, 13, 7, 124, 4, (16, 18), 3), (2, 9, 10, 19, 2, (16, 18), 1),
    (1, 12, 9, 256, 4, (16, 18), 3),
]


@pytest.mark.parametrize("n,h,w,c,s,rows,tw", CE_PHASE_FWD_CASES)
def test_ce_phase_fwd_redesign_matches_plain(dev, monkeypatch, n, h, w, c, s, rows, tw):
    """Rows 16 and 18 (w-major labels) on the loss forward's kernel against
    their plain versions, at row 14's tolerances: wsum to 1e-4 relative, the
    correct count within 1e-4 of the valid pixels (at least 1: a near-tie may
    count either way); with the first output rows of every frame all ignored
    (C < 256: uint8 labels hold no ignored value at C 256); two calls bitwise
    equal; where both coefficient rules agree (s 2, 4 and 8), each equal to
    row 14's (wsum, corr) on the same natural labels bit for bit."""
    ce = ops.ce_upsampled
    if tw is not None:
        band = 32 // ce.ce_bwd_groups(c)[0]
        monkeypatch.setattr(ce, "ce_fwd_plan", lambda *a: (tw, band))
    rng = np.random.RandomState(110 + c + s)
    x = _rand(rng, n, h, w, c, scale=2.0, dev=dev)
    if c < 256:
        lab = _labels(rng, n, h * s, w * s, c, torch.uint8, dev)
        lab[:, :8] = 255  # a band of output rows whose labels are all ignored
    else:
        lab = torch.from_numpy(rng.randint(0, 256, (n, h * s, w * s)).astype(np.uint8)).to(dev)
    phw = ops.labels_to_phase_w(lab, s).contiguous()
    img_w = 0.5 / lab.numel()
    n_valid = int((lab.long() < c).sum())
    row14 = ops.ce_upsampled_loss(x, lab, s, img_w, force="kernel") if s != 3 else None
    ops.reset_launches()
    op_of = {16: ops.ce_fwd_loss_v5, 18: ops.ce_fwd_loss_v3}
    for row in rows:
        op = op_of[row]
        got = op(x, phw, s, img_w, force="kernel")
        want = op(x, phw, s, img_w, force="torch")
        torch.cuda.synchronize()
        assert abs(got[0].item() - want[0].item()) <= 1e-4 * abs(want[0].item()), row
        assert abs(got[1].item() - want[1].item()) <= max(1.0, 1e-4 * n_valid), row
        again = op(x, phw, s, img_w, force="kernel")
        assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]), row
        if row14 is not None:
            assert torch.equal(got[0], row14[0]) and torch.equal(got[1], row14[1]), row
    assert {k: v for k, v in ops.launches().items() if v} == {
        {16: "ce_fwd_loss_v5", 18: "ce_fwd_loss_v3"}[r]: 2 for r in rows}


def test_ce_phase_fwd_occupancy_is_row14s(dev):
    """Rows 16 and 18 keep row 14's blocks an SM at the bench's plans (the
    label addressing costs no occupancy): 4, the launch bounds' cap."""
    from vss_cffm_tpu_torch.ops import _build
    lib = _build.library("ce_upsampled")
    for n in (8, 2):
        tw, _ = ops.ce_upsampled.ce_fwd_plan(n, 120, 120, 124, 4, 132)
        assert lib.ce_fwd_phase_blocks_per_sm(124, 4, tw) == lib.ce_fwd_blocks_per_sm(
            124, 4, tw, 0) == 4


# ---- the key-tiled attention (row 1 at test-time augmentation's key counts) ----


def _attention_inputs(rng, g, lq, n, nh, hd, bm, dev):
    """q, K, V (bf16) and, with ``bm``, bias and a mask of -100 on a fifth of
    the keys, for ``attention_launch``."""
    c = nh * hd
    q, k, v = (_rand(rng, g, lq, c, dev=dev), _rand(rng, g, n, c, dev=dev),
               _rand(rng, g, n, c, dev=dev))
    if not bm:
        return q, k, v, None, None
    bias = _rand(rng, nh, lq, n, dtype=torch.float32, dev=dev)
    mask = torch.from_numpy(np.where(rng.rand(g, n) < 0.2, -100.0, 0.0)
                            .astype(np.float32)).to(dev)
    return q, k, v, bias, mask


def _attention_scales(hd, bm):
    """(q_scale, k_scale) as the two callers pass them: the CFM attention
    scales q, the MiT block folds the scale into K."""
    from vss_cffm_tpu_torch.ops.cfm_attention import scale_in

    s = scale_in(torch.bfloat16, hd ** -0.5)
    return (s, 1.0) if bm else (1.0, s)


@pytest.mark.parametrize("bm", [False, True], ids=["sra", "bias_mask"])
@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("n", [405, 920, 1269, 2048])
def test_attention_tiled_matches_plain(dev, n, hd, bm):
    """The key-tiled instance at the MiT stages' key counts at 480x864 (405)
    and in multi-scale test-time augmentation (920 at 1.5x, 1269 at 1.75x),
    and at the fused block's limit (2048), against the plain attention, with
    100 query rows (a ragged 64-row tile): 2^-6 of the largest output, as the
    resident instance is held; each call counts one launch."""
    from vss_cffm_tpu_torch.ops.cfm_attention import attention_launch, attention_torch

    rng = np.random.RandomState(31)
    nh = 2
    q, k, v, bias, mask = _attention_inputs(rng, 3, 100, n, nh, hd, bm, dev)
    qs, ks = _attention_scales(hd, bm)
    before = ops.attention_fwd_tiled.launches
    got = attention_launch(q, k, v, bias, mask, nh, qs, ks, "test", tiled=True)
    assert ops.attention_fwd_tiled.launches == before + 1
    _close(got, attention_torch(q, k, v, bias, mask, nh, qs, ks), 2.0 ** -6)


@pytest.mark.parametrize("n,hd,bm", [(37, 32, True), (289, 32, True), (405, 64, False),
                                     (896, 64, True), (1808, 32, False)])
def test_attention_tiled_equals_resident(dev, n, hd, bm):
    """Where both instances run (up to 896 keys at head dim 64 and 1808 at
    32, the resident instance's limits), the key-tiled one gives the same
    bits: the same 16-key steps in the same order."""
    from vss_cffm_tpu_torch.ops.cfm_attention import attention_launch

    rng = np.random.RandomState(32)
    q, k, v, bias, mask = _attention_inputs(rng, 2, 130, n, 2, hd, bm, dev)
    qs, ks = _attention_scales(hd, bm)
    tiled = attention_launch(q, k, v, bias, mask, 2, qs, ks, "test", tiled=True)
    resident = attention_launch(q, k, v, bias, mask, 2, qs, ks, "test", tiled=False)
    torch.cuda.synchronize()
    assert torch.equal(tiled, resident)


def test_attention_picks_its_instance_by_keys(dev):
    """The wrapper's choice: resident up to the keys whose K and V fit one
    block's shared memory (896 at head dim 64), key-tiled beyond; the
    probabilities output stays resident-only and keeps its refusal."""
    from vss_cffm_tpu_torch.ops.cfm_attention import attention_launch

    rng = np.random.RandomState(33)
    for n, tiled in ((896, 0), (897, 1), (1269, 1)):
        q, k, v, _, _ = _attention_inputs(rng, 1, 64, n, 1, 64, False, dev)
        before = ops.attention_fwd_tiled.launches
        attention_launch(q, k, v, None, None, 1, 1.0, 0.125, "test")
        assert ops.attention_fwd_tiled.launches == before + tiled, n
    q, k, v, bias, mask = _attention_inputs(rng, 1, 49, 1269, 1, 64, True, dev)
    probs = torch.empty((1, 1, 49, 1269), device=dev)
    with pytest.raises(ValueError, match="exceed"):
        attention_launch(q, k, v, bias, mask, 1, 0.125, 1.0, "test", probs=probs)


# ---- the key-tiled instance's edges (TMA ring, wgmma, K scaled once) --------


@pytest.mark.parametrize("n", [16, 17, 64, 65, 2048])
@pytest.mark.parametrize("lq", [1, 63, 129, 5076])
def test_attention_tiled_ragged(dev, lq, n):
    """Ragged query tiles (one row, a half warpgroup, one row past a 128-row
    block, stage 3's 5076 rows at 1.75x) and key counts at the edges of the
    16-key groups and the 64-key tiles (TMA zero-fills the last tile's rows
    past N), up to the fused block's 2048: 2^-6 of the largest output."""
    from vss_cffm_tpu_torch.ops.cfm_attention import attention_launch, attention_torch

    rng = np.random.RandomState(40)
    q, k, v, _, _ = _attention_inputs(rng, 2, lq, n, 2, 64, False, dev)
    qs, ks = _attention_scales(64, False)
    got = attention_launch(q, k, v, None, None, 2, qs, ks, "test", tiled=True)
    _close(got, attention_torch(q, k, v, None, None, 2, qs, ks), 2.0 ** -6)


@pytest.mark.parametrize("hd", [32, 64])
def test_attention_tiled_smem_is_the_plan(dev, hd):
    """The library's shared memory of a key-tiled block is the Python
    mirror's (``tiled_plan``: two rings of 64-key tiles, two mbarriers a
    stage, the alignment), and a block of either instance fits an SM."""
    from vss_cffm_tpu_torch.ops import _build
    from vss_cffm_tpu_torch.ops.cfm_attention import tiled_plan

    lib = _build.library("attention")
    assert lib.attention_fwd_tiled_smem_bytes(hd) == tiled_plan(1269, hd)["smem_bytes"]
    for bm in (0, 1):
        assert lib.attention_fwd_tiled_blocks_per_sm(hd, bm, 0) >= 1


def test_attention_tiled_is_deterministic(dev):
    """Two launches at stage 3's TTA shape give the same bits."""
    from vss_cffm_tpu_torch.ops.cfm_attention import attention_launch

    rng = np.random.RandomState(41)
    q, k, v, _, _ = _attention_inputs(rng, 2, 5076, 1269, 5, 64, False, dev)
    qs, ks = _attention_scales(64, False)
    a = attention_launch(q, k, v, None, None, 5, qs, ks, "test", tiled=True)
    b = attention_launch(q, k, v, None, None, 5, qs, ks, "test", tiled=True)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("where", ["q_scale", "k_scale"])
def test_attention_tiled_scale_placements(dev, where):
    """The scale on q (rounded in the kernel's q fragments) or on K (rounded
    once by the wrapper, then launched with k_scale 1): against the plain
    version, and K scaled by the wrapper equal bit for bit to K scaled
    before the call."""
    from vss_cffm_tpu_torch.ops.cfm_attention import attention_launch, attention_torch, scale_in

    rng = np.random.RandomState(42)
    q, k, v, _, _ = _attention_inputs(rng, 2, 300, 920, 2, 32, False, dev)
    s = scale_in(torch.bfloat16, 32 ** -0.5)
    qs, ks = (s, 1.0) if where == "q_scale" else (1.0, s)
    got = attention_launch(q, k, v, None, None, 2, qs, ks, "test", tiled=True)
    _close(got, attention_torch(q, k, v, None, None, 2, qs, ks), 2.0 ** -6)
    pre = attention_launch(q, k * ks if ks != 1.0 else k, v, None, None, 2, qs, 1.0, "test",
                           tiled=True)
    torch.cuda.synchronize()
    assert torch.equal(got, pre)


def test_attention_tiled_counts_its_launches(dev):
    """One count a call, on its own counter alone, with K scaled by the
    wrapper or not."""
    from vss_cffm_tpu_torch.ops.cfm_attention import attention_launch

    rng = np.random.RandomState(43)
    q, k, v, _, _ = _attention_inputs(rng, 1, 64, 920, 1, 64, False, dev)
    before = ops.launches()
    attention_launch(q, k, v, None, None, 1, 1.0, 0.125, "test", tiled=True)
    attention_launch(q, k, v, None, None, 1, 1.0, 1.0, "test", tiled=True)
    after = ops.launches()
    assert {n: after[n] - before[n] for n in after if after[n] != before[n]} == {
        "attention_fwd_tiled": 2}


@pytest.mark.parametrize("hd", [32, 64])
def test_wgmma_products_against_mma_sync(dev, hd):
    """The diagnostic of one tile: S = q Kᵀ (64 rows x 64 keys, four 16-key
    steps) and O = p V (64 x hd) through wgmma, as the key-tiled instance
    computes them, and through mma.sync m16n8k16, as the resident one does,
    from the same bf16 inputs. Prints the share of bitwise-equal f32 elements
    and the largest difference in f32 ulps; the two key-tiled / resident
    bitwise checks rest on them being equal."""
    from vss_cffm_tpu_torch.ops import _build
    from vss_cffm_tpu_torch.ops._dispatch import ptr, stream_of

    rng = np.random.RandomState(44)
    q, k, v = (_rand(rng, 64, hd, dev=dev), _rand(rng, 64, hd, dev=dev),
               _rand(rng, 64, hd, dev=dev))
    p = torch.softmax(_rand(rng, 64, 64, scale=3.0, dtype=torch.float32, dev=dev), -1).to(
        torch.bfloat16)
    outs = [torch.empty(64, w, device=dev) for w in (64, 64, hd, hd)]
    devi, stream = stream_of(q)
    _build.check(_build.library("attention").attention_mma_check(
        *(ptr(t, "test") for t in (q, k, p, v, *outs)), hd, devi, stream), "attention_mma_check")
    torch.cuda.synchronize()
    report = []
    for what, a, b in (("S", outs[0], outs[1]), ("O", outs[2], outs[3])):
        ai, bi = a.view(torch.int32).long(), b.view(torch.int32).long()
        report.append((what, (ai == bi).float().mean().item(), (ai - bi).abs().max().item()))
    print(f"[wgmma vs mma.sync] hd={hd}: " + "; ".join(
        f"{w} {eq:.6f} of the elements bitwise equal, at most {ulp} f32 ulps apart"
        for w, eq, ulp in report))
    assert all(eq == 1.0 for _, eq, _ in report), report


def test_decoder_remat_step_on_the_card(dev):
    """The decoder remat (``use_checkpoint``) on the card: one B0 train
    forward/backward at 64² in bf16 with decoder drop path 0.3, against the
    same without remat from the same weights, batch and generator seed. The
    recompute launches the CFM attention forward once more a block. The
    forward is deterministic, so the loss agrees to 1e-5; the backward is
    not (``F.interpolate``'s backward adds with atomics), so the plain step
    is run twice and the remat step's gradients are held to 1e-5 of their
    norm plus three times the plain step's own run-to-run difference. A
    recompute that drew other masks would miss by O(1)."""
    import dataclasses

    from vss_cffm_tpu_torch import config as pcfg
    from vss_cffm_tpu_torch.models.losses import clip_ce_loss
    from vss_cffm_tpu_torch.train.step import device_normalize

    head = pcfg.build_model_config("b0", num_classes=11).head
    rng = np.random.RandomState(21)
    imgs = device_normalize(torch.from_numpy(
        rng.randint(0, 256, (1, 4, 64, 64, 3)).astype(np.uint8)).to(dev), torch.bfloat16)
    lab = _labels(rng, 4, 64, 64, 11, torch.uint8, dev).reshape(1, 4, 64, 64)
    runs = []
    for remat in (False, False, True):
        dec = dataclasses.replace(head.decoder, drop_path=0.3, use_checkpoint=remat)
        model = _b0_model(dev, head=dataclasses.replace(head, decoder=dec)).train()
        ops.reset_launches()
        out = model(imgs, train=True, generator=torch.Generator(dev).manual_seed(3))
        loss = clip_ce_loss(out, lab)["loss_seg"]
        loss.backward()
        torch.cuda.synchronize()
        runs.append((loss.item(), ops.launches(),
                     {n: p.grad.float().clone() for n, p in model.named_parameters()}))
    (l0, c0, g0), (l0b, _, g0b), (l1, c1, g1) = runs
    depth = dec.depth
    assert c0["cfm_attention"] == depth and c1["cfm_attention"] == 2 * depth, (c0, c1)
    assert c1["cfm_attention_bwd"] == c0["cfm_attention_bwd"] == depth
    assert l0b == l0 and abs(l1 - l0) <= 1e-5 * abs(l0), (l0, l0b, l1)
    flat = lambda g: torch.cat([v.reshape(-1) for v in g.values()]).double()
    a, b, r = flat(g0), flat(g0b), flat(g1)
    noise, err = (b - a).norm().item(), (r - a).norm().item()
    worst = sorted(((g1[n] - g0[n]).abs().max().item(), (g0b[n] - g0[n]).abs().max().item(), n)
                   for n in g0)[-3:]
    print(f"remat vs plain: |dg| {err:.3e}, plain vs plain {noise:.3e}, |g| {a.norm().item():.3e};"
          f" largest element differences (remat, plain): {worst}")
    assert err <= 1e-5 * a.norm().item() + 3 * noise, (err, noise)


@pytest.mark.parametrize("n,d,k", [(64_800, 256, 100), (3_000, 32, 17)])
def test_kmeans_on_the_card_matches_the_cpu(dev, n, d, k):
    """CFFM++'s k-means (plain PyTorch on both sides, f32 matmuls, TF32 off)
    on the card against the CPU from the same initial indices, on points
    drawn around k well-separated means (phase A's size first: 10 frames of
    60×108 at 256 dims), one initial point in each: no cluster is split, so
    no point lies near a tie that the matmuls' other order of summation
    could flip. Labels equal; centres within 1e-5 of the largest |centre|;
    two runs on the card bitwise equal (the one-hot update has no
    atomics)."""
    from vss_cffm_tpu_torch.ops.kmeans import kmeans_from

    rng = np.random.RandomState(n % 97)
    means = 6.0 * rng.randn(k, d)
    which = rng.randint(0, k, n)
    which[:k] = rng.permutation(k)  # every mean drawn at least once
    pts = torch.from_numpy((means[which] + rng.randn(n, d)).astype(np.float32))
    idx = torch.from_numpy(np.array([np.flatnonzero(which == j)[0] for j in range(k)]))
    want_c, want_l = kmeans_from(pts, idx, 10)
    got_c, got_l = kmeans_from(pts.to(dev), idx.to(dev), 10)
    again_c, again_l = kmeans_from(pts.to(dev), idx.to(dev), 10)
    torch.cuda.synchronize()
    assert torch.equal(got_l.cpu(), want_l)
    err = (got_c.cpu() - want_c).abs().max().item()
    assert err <= 1e-5 * want_c.abs().max().item(), err
    assert torch.equal(got_c, again_c) and torch.equal(got_l, again_l)


def test_image_segmentor_on_the_card(dev):
    """SegFormer-B0 (``arch="image"``) on a 64×96 frame: rows 1 and 3 launched
    4 times each, no CFM attention, the logits within 5 % of the largest plain
    logit."""
    import dataclasses

    from vss_cffm_tpu_torch import config as pcfg
    from vss_cffm_tpu_torch.models import ImageSegmentor, build_segmentor, set_force
    from vss_cffm_tpu_torch.train.step import device_normalize

    cfg = dataclasses.replace(pcfg.build_model_config("b0", num_classes=11, num_clips=1),
                              arch="image")
    model = build_segmentor(cfg, dtype=torch.bfloat16)
    assert isinstance(model, ImageSegmentor)
    model.init_weights(torch.Generator().manual_seed(0))
    model = model.to(dev).eval()
    rng = np.random.RandomState(13)
    x = device_normalize(torch.from_numpy(
        rng.randint(0, 256, (2, 64, 96, 3)).astype(np.uint8)).to(dev), torch.bfloat16)
    ops.reset_launches()
    with torch.inference_mode():
        got = model(x)
    torch.cuda.synchronize()
    counts = ops.launches()
    assert (counts["mit_block_fused"], counts["cfm_attention"], counts["dwconv3x3"]) == (4, 0, 4)
    set_force(model, "torch")
    with torch.inference_mode():
        want = model(x)
    assert got.shape == want.shape == (2, 16, 24, 11)
    _close(got, want, 0.05)


def test_test_cli_on_the_card_matches_the_cpu(dev, tmp_path):
    """``tools.test.main`` on a 6-frame VSPW tree (64×96, written with PIL),
    CFFM-B0 from a ``.pth`` whose class layer is scaled up so that no argmax
    is near a tie: ``--device cuda`` against ``--device cpu``, the masks ≥ 99 %
    equal and the confusions' totals equal."""
    import pickle

    from PIL import Image

    from vss_cffm_tpu_torch import config as pcfg
    from vss_cffm_tpu_torch.models import CFFMSegmentor
    from vss_cffm_tpu_torch.tools import test as test_cli

    rng = np.random.RandomState(14)
    root = tmp_path / "vspw"
    (root / "data" / "v" / "origin").mkdir(parents=True)
    (root / "data" / "v" / "mask").mkdir()
    (root / "val.txt").write_text("v\n")
    for i in range(6):
        Image.fromarray(rng.randint(0, 256, (64, 96, 3)).astype(np.uint8)).save(
            root / "data" / "v" / "origin" / f"{i:08d}.jpg")
        Image.fromarray(rng.randint(0, 6, (64, 96)).astype(np.uint8)).save(
            root / "data" / "v" / "mask" / f"{i:08d}.png")
    model_cfg = pcfg.build_model_config("b0", num_classes=5)
    model = CFFMSegmentor(model_cfg)
    model.init_weights(torch.Generator().manual_seed(1))
    sd = model.state_dict()
    for k in ("linear_pred.weight", "linear_pred2.weight"):
        sd[f"decode_head.{k}"] = sd[f"decode_head.{k}"] * 100
    ckpt = str(tmp_path / "b0.pth")
    torch.save({"state_dict": sd}, ckpt)
    cfg = pcfg.ExperimentConfig(model=model_cfg, data=pcfg.DataConfig(
        data_root=str(root), img_scale=(96, 64), num_workers=2))
    cfg_path = tmp_path / "cfg.py"
    cfg_path.write_text(f"from vss_cffm_tpu_torch.config import *  # noqa: F403\n\n\n"
                        f"def config():\n    return {cfg!r}\n")
    masks, totals = {}, {}
    for device in ("cuda", "cpu"):
        pkl = str(tmp_path / f"{device}.pkl")
        out = test_cli.main([str(cfg_path), ckpt, "--device", device, "--out", pkl])
        totals[device] = int(out["confusion"].sum())
        with open(pkl, "rb") as f:
            masks[device] = np.stack(pickle.load(f))
    assert masks["cuda"].shape == (6, 64, 96)
    assert (masks["cuda"] == masks["cpu"]).mean() >= 0.99
    assert totals["cuda"] == totals["cpu"] > 0


def test_two_gloo_ranks_on_one_card_match_one_process(dev):
    """The fuse BN and one default train step on 2 gloo ranks pinned to
    ``cuda:0`` (``parallel.spawn``, ``torch_port_ranks.bn_and_step``), one clip
    each, against the one-process run on the global batch: the BN in f32
    (output, input gradients, the parameters' gradients summed over the
    ranks, within 1e-5 of each tensor's largest value; the running
    statistics within 1e-6); the step at MiT-B0 widths, 64², bf16, drop path
    and head dropout 0.1, at ``PERF.md`` §2's train limits (loss and gradient
    norm within 1 %, cosine of all gradients ≥ 0.999: the card's step is not
    deterministic, ``F.interpolate``'s backward adds with atomics), the fuse
    BN's running statistics within 1 % of their largest value; the OHEM
    weights of a fixed probability map (the gathered threshold over gloo on
    the card) equal to the one process's exactly."""
    import torch_port_ranks as ranks
    from vss_cffm_tpu_torch import parallel
    from vss_cffm_tpu_torch.models import CFFMSegmentor
    from vss_cffm_tpu_torch.models.heads import MLPDecodeHead

    rng = np.random.RandomState(8)
    cfg = ranks.tiny_config()
    model = CFFMSegmentor(cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    labels = rng.randint(0, 124, (2, 4, 64, 64)).astype(np.uint8)
    labels[rng.rand(*labels.shape) < 0.05] = 255
    train = dict(cfg=cfg, state_dict=model.state_dict(), optim=dict(lr=1e-3, max_iters=100),
                 batch={"imgs": rng.randint(0, 256, (2, 4, 64, 64, 3)).astype(np.uint8),
                        "labels": labels}, dtype=torch.bfloat16)
    head = MLPDecodeHead(cfg.head)
    feats = [(rng.standard_normal((4, 8 >> i, 8 >> i, c)) * (i + 1) + i).astype(np.float32)
             for i, c in enumerate(cfg.head.in_channels)]
    bn = dict(head_cfg=cfg.head, state_dict=head.state_dict(), feats=feats,
              cotangent=rng.standard_normal((4, 8, 8, 32)).astype(np.float32))
    ohem_map = dict(gt_prob=rng.rand(4, 16, 16).astype(np.float32),
                    valid=rng.rand(4, 16, 16) > 0.1, thresh=0.0, min_kept=150)
    world = parallel.spawn(ranks.bn_and_step, 2, bn, train, ohem_map, device="cuda:0",
                           backend="gloo")
    one = ranks.bn_and_step(dev, bn, train, ohem_map)
    assert 0.2 < one["ohem_map"].mean().item() < 0.8
    for r, w in enumerate(world):
        assert torch.equal(w["ohem_map"], parallel.shard_batch(one["ohem_map"], r, 2))
        got, want = w["bn"], one["bn"]
        ranks.close_to_largest(got["out"], parallel.shard_batch(want["out"], r, 2), 1e-5, "out")
        for g, x in zip(got["dx"], want["dx"]):
            ranks.close_to_largest(g, parallel.shard_batch(x, r, 2), 1e-5, "input grad")
        ranks.grads_close(got["grads"], want["grads"], f"rank {r}")
        for g, x in zip(got["bn"], want["bn"]):
            torch.testing.assert_close(g, x, rtol=0, atol=1e-6)
        got, want = w["train"], one["train"]
        for k in ("loss_seg", "grad_norm"):
            a, b = got["metrics"][0][k], want["metrics"][0][k]
            assert abs(a - b) <= 1e-2 * abs(b), (k, a, b)
        flat = lambda g: torch.cat([v.float().reshape(-1) for v in g.values()]).double()
        cos = torch.nn.functional.cosine_similarity(flat(got["grads"][0]),
                                                    flat(want["grads"][0]), dim=0).item()
        assert cos >= 0.999, cos
        for g, x in zip(got["bn"], want["bn"]):
            ranks.close_to_largest(g, x, 1e-2, "running statistics")


def test_frames_split_on_two_gloo_ranks_on_one_card_matches_one_process(dev):
    """A clip's frames split over 2 gloo ranks pinned to ``cuda:0`` (a 1 x 2
    clip mesh, ``parallel.create_clip_mesh(2)``: 2 of the 4 frames of both
    clips a rank, the fused features gathered over the frames group;
    ``torch_port_ranks.grid_cases``) against the one-process run, MiT-B0
    widths, 64², bf16 through the kernels: the eval logits within 5 % of the
    one process's largest (the backbone's kernels see 2 frames a call there,
    4 here), the target frames' confusion's total the valid pixels, and one
    default step at ``PERF.md`` §2's train limits (loss and gradient norm
    within 1 %, cosine of all gradients ≥ 0.999, the fuse BN's running
    statistics within 1 % of their largest value); the ranks' parameters
    after the step equal."""
    import torch_port_ranks as ranks
    from vss_cffm_tpu_torch import parallel
    from vss_cffm_tpu_torch.models import CFFMSegmentor

    rng = np.random.RandomState(9)
    cfg = ranks.tiny_config()
    model = CFFMSegmentor(cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    labels = rng.randint(0, 124, (2, 4, 64, 64)).astype(np.uint8)
    labels[rng.rand(*labels.shape) < 0.05] = 255
    frames = dict(cfg=cfg, state_dict=model.state_dict(), optim=dict(lr=1e-3, max_iters=100),
                  batch={"imgs": rng.randint(0, 256, (2, 4, 64, 64, 3)).astype(np.uint8),
                         "labels": labels}, dtype=torch.bfloat16, frame_axis=2, infer=True)
    world = parallel.spawn(ranks.grid_cases, 2, frames, device="cuda:0", backend="gloo")
    one = ranks.train_steps(dev, **frames)
    assert one["confusion"].sum() == int((labels[:, -1] != 255).sum())
    for w in world:
        got = w["frames"]
        ranks.close_to_largest(got["logits"].float(), one["logits"].float(), 0.05, "logits")
        assert got["confusion"].sum() == one["confusion"].sum()
        for k in ("loss_seg", "grad_norm"):
            a, b = got["metrics"][0][k], one["metrics"][0][k]
            assert abs(a - b) <= 1e-2 * abs(b), (k, a, b)
        flat = lambda g: torch.cat([v.float().reshape(-1) for v in g.values()]).double()
        cos = torch.nn.functional.cosine_similarity(flat(got["grads"][0]),
                                                    flat(one["grads"][0]), dim=0).item()
        assert cos >= 0.999, cos
        for g, x in zip(got["bn"], one["bn"]):
            ranks.close_to_largest(g, x, 1e-2, "running statistics")
    for name, p in world[0]["frames"]["params"].items():
        assert torch.equal(p, world[1]["frames"]["params"][name]), name


# The inference FFN launch (rows 1 and 8): (b, h, w, C, Ch, the input's and
# residual's dtype, a forced (rows, cols, hc, splits) or None for the plan):
# B1's stages on the main path (stages 2, 3: row 1's f32 y; 1, 4: row 8's
# bf16 x), at 480x864 and at TTA's 1.75x view (stage 3, 54x94), B0's
# stages 1 and 3, and ragged forced tiles with and without splits
FFN_FUSED_CASES = [
    (4, 60, 60, 128, 512, F32, None), (4, 30, 30, 320, 1280, F32, None),
    (4, 120, 120, 64, 256, BF16, None), (4, 15, 15, 512, 2048, BF16, None),
    (4, 60, 108, 128, 512, F32, None), (4, 30, 54, 320, 1280, F32, None),
    (4, 54, 94, 320, 1280, F32, None), (4, 120, 120, 32, 128, BF16, None),
    (4, 30, 30, 160, 640, F32, None),
    (4, 30, 30, 320, 1280, F32, (8, 8, 64, 1)), (4, 15, 15, 512, 2048, BF16, (8, 4, 64, 1)),
    (2, 9, 11, 64, 256, BF16, (2, 5, 32, 3)), (1, 7, 13, 160, 640, F32, (4, 4, 64, 2)),
    (1, 1, 1, 8, 8, BF16, None), (2, 5, 1, 24, 200, BF16, (3, 1, 32, 2)),
]


def _ffn_inputs(rng, b, h, w, c, ch, xdt):
    f = lambda *sh, sc: _rand(rng, *sh, scale=sc, dtype=torch.float32, dev="cuda")
    return (f(b, h, w, c, sc=1.0).to(xdt), 1.0 + f(c, sc=0.1), f(c, sc=0.1),
            f(c, ch, sc=c ** -0.5).to(BF16), f(ch, sc=0.1), f(3, 3, 1, ch, sc=1 / 3),
            f(ch, sc=0.1), f(ch, c, sc=ch ** -0.5).to(BF16), f(c, sc=0.1))


def _plain_ffn(args, res: bool):
    x = args[0]
    st = ops.stage_block._ffn_fwd_steps(*args[1:], None, 1e-6, tuple(x.shape), BF16, False, "t")
    y = x.reshape(-1, x.shape[-1])
    return st["out"](st["a"](st["hid"](y)), y if res else None)


@pytest.mark.parametrize("b,h,w,c,ch,xdt,forced", FFN_FUSED_CASES)
def test_ffn_fused_launch_matches_plain(dev, b, h, w, c, ch, xdt, forced):
    """The launch alone (no residual) and with the residual (row 1's f32 y,
    row 8's bf16 x) against the plain steps at 2^-6 of the largest output
    (``stage_block.STEP_TOLERANCE``: a bf16 rounding of the LN output or of a
    may flip one ulp from f32 sums in other orders and carry through fc1 or
    fc2), each run twice, bitwise equal (no atomics; the split's partials
    summed in a fixed order)."""
    ff = ops.ffn_fused
    rng = np.random.RandomState(21)
    args = _ffn_inputs(rng, b, h, w, c, ch, xdt)
    x = args[0]
    plan = None
    if forced is not None:
        rows, cols, hc, splits = forced
        nch = -(-ch // hc)
        per = -(-nch // splits)
        plan = ff.FfnPlan(rows, cols, hc, -(-nch // per), per, ff.ffn_fused_smem(rows, cols, c, hc))
    for res in (False, True):
        r = x.reshape(-1, c) if res else None
        got = ff.ffn_fused_launch(x, *args[1:], 1e-6, r, "t", plan=plan)
        again = ff.ffn_fused_launch(x, *args[1:], 1e-6, r, "t", plan=plan)
        _close(got, _plain_ffn(args, res), 2.0 ** -6)
        assert torch.equal(got, again)


# (B, H, W, C, Ch, forced (rows, cols, hc, splits) or None): B1's four widths
# at their 480x480 maps, clips of 4 frames, and ragged maps with forced
# splits
MIXFFN_CASES = [
    (4, 120, 120, 64, 256, None), (4, 60, 60, 128, 512, None), (4, 30, 30, 320, 1280, None),
    (4, 15, 15, 512, 2048, None), (2, 9, 11, 64, 256, (2, 5, 32, 3)),
    (1, 7, 13, 320, 1280, (4, 4, 64, 2)), (1, 5, 3, 512, 2048, (2, 2, 64, 4)),
]


@pytest.mark.parametrize("b,h,w,c,ch,forced", MIXFFN_CASES)
def test_mixffn_fused_launch_matches_plain(dev, monkeypatch, b, h, w, c, ch, forced):
    """Row 9 as the FFN launch without the LayerNorm or a residual, against
    ``mixffn_fused_torch`` at 2^-6 of the largest output (bf16 a and out at
    the same points, one ulp carried through fc2), two runs bitwise equal,
    one count a call."""
    ff = ops.ffn_fused
    if forced is not None:
        rows, cols, hc, splits = forced
        nch = -(-ch // hc)
        per = -(-nch // splits)
        plan = ff.FfnPlan(rows, cols, hc, -(-nch // per), per, ff.ffn_fused_smem(rows, cols, c, hc))
        monkeypatch.setattr(ff, "ffn_fused_plan", lambda *a: plan)
    rng = np.random.RandomState(23)
    args = _ffn_inputs(rng, b, h, w, c, ch, BF16)
    mix = (args[0], *args[3:])
    before = ops.mixffn_fused.launches
    got = ops.mixffn_fused(*mix, force="kernel")
    again = ops.mixffn_fused(*mix, force="kernel")
    assert ops.mixffn_fused.launches == before + 2
    _close(got, ops.mixffn.mixffn_fused_torch(*mix), 2.0 ** -6)
    assert torch.equal(got, again)


def test_ffn_fused_smem_is_the_kernels(dev):
    """The planner's shared-memory sum (``ffn_fused_smem``) equals the
    kernel's layout."""
    from vss_cffm_tpu_torch.ops import _build

    lib = _build.library("ffn_fused")
    for c in (8, 32, 64, 128, 160, 320, 512):
        for rows, cols in ((1, 1), (4, 15), (8, 8), (15, 8), (2, 30)):
            if rows * cols <= ops.ffn_fused.max_pixels(c):
                for hc in (32, 64):
                    assert lib.ffn_fused_smem_bytes(rows, cols, c, hc) == \
                        ops.ffn_fused.ffn_fused_smem(rows, cols, c, hc)


def _device_kernels(fn) -> int:
    """CUDA kernels one call of fn launches, as torch.profiler traces them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation)


@pytest.mark.parametrize("shape,ch,nh", [((4, 60, 60, 128), 512, 2), ((4, 30, 30, 320), 1280, 5)])
def test_inference_block_launches_four_kernels(dev, shape, ch, nh):
    """With the model's dtypes (bf16 x, K, V and weights, f32 vectors) the
    inference block runs four CUDA kernels (q, ctx, y, the FFN launch), five
    where the FFN plan splits the hidden channels; ``block_ffn_fused`` one,
    or two."""
    rng = np.random.RandomState(22)
    b, h, w, c = shape
    f = lambda *sh, sc: _rand(rng, *sh, scale=sc, dtype=torch.float32, dev=dev)
    s = 225
    args = (_rand(rng, *shape, dev=dev), 1.0 + f(c, sc=0.1), f(c, sc=0.1),
            f(c, c, sc=c ** -0.5).to(BF16), f(c, sc=0.1), _rand(rng, b, s, c, dev=dev),
            _rand(rng, b, s, c, dev=dev), f(c, c, sc=c ** -0.5).to(BF16), f(c, sc=0.1),
            1.0 + f(c, sc=0.1), f(c, sc=0.1), f(c, ch, sc=c ** -0.5).to(BF16), f(ch, sc=0.1),
            f(3, 3, 1, ch, sc=1 / 3), f(ch, sc=0.1), f(ch, c, sc=ch ** -0.5).to(BF16),
            f(c, sc=0.1))
    split = ops.ffn_fused.ffn_fused_plan(b, h, w, c, ch, torch.cuda.get_device_properties(
        0).multi_processor_count).splits > 1
    with torch.no_grad():
        assert _device_kernels(lambda: ops.mit_block_fused(*args, num_heads=nh)) == 4 + split
        assert _device_kernels(lambda: ops.block_ffn_fused(args[0], *args[9:])) == 1 + split


# The block-FFN train pair's launches (rows 10 and 11, and the FFN half of
# rows 6 and 7): (b, h, w, C, Ch, the whole block's mode, a forced (rows,
# cols, hc, splits) or None for the plan): the train step's stages 1-3 (8
# frames of 480x480 at B1's widths) on their plans and with forced splits,
# in the pair's mode (bf16 x in, bf16 dx out) and the whole block's (f32 y
# in, f32 d_y and bf16 d_attn out); ragged tiles and chunks, one pixel a frame
FFN_BWD_CASES = [
    (8, 120, 120, 64, 256, False, None), (8, 60, 60, 128, 512, False, None),
    (8, 30, 30, 320, 1280, False, None), (8, 120, 120, 64, 256, True, None),
    (8, 60, 60, 128, 512, True, None), (8, 30, 30, 320, 1280, True, None),
    (8, 120, 120, 64, 256, False, (12, 10, 64, 2)), (8, 30, 30, 320, 1280, True, (8, 8, 32, 3)),
    (8, 60, 60, 128, 512, True, (8, 16, 32, 2)),
    (2, 9, 11, 64, 256, False, (3, 4, 32, 3)), (1, 7, 13, 160, 648, True, (4, 4, 64, 2)),
    (3, 1, 1, 16, 40, False, None), (2, 5, 1, 24, 200, True, (3, 1, 32, 2)),
]


def _ffn_bwd_inputs(rng, b, h, w, c, ch, full):
    """x (bf16, or the block's f32 y), go (bf16), the f32 parameters of
    ``block_ffn_train`` and branch scales with a dropped branch in frame 0
    (attention) and frame 1 (FFN)."""
    f = lambda *sh, sc: _rand(rng, *sh, scale=sc, dtype=torch.float32, dev="cuda")
    x = f(b, h, w, c, sc=1.0)
    ffn = (1.0 + f(c, sc=0.1), f(c, sc=0.1), f(c, ch, sc=c ** -0.5), f(ch, sc=0.1),
           f(3, 3, 1, ch, sc=1 / 3), f(ch, sc=0.1), f(ch, c, sc=ch ** -0.5), f(c, sc=0.1))
    s_ffn = torch.tensor(([1 / 0.9, 0.0] + [1.0, 0.37] * b)[:b], device="cuda")
    s_attn = torch.tensor(([0.0] + [1 / 0.9, 1.0] * b)[:b], device="cuda")
    return (x if full else x.to(BF16)), ffn, _rand(rng, b, h, w, c, dev="cuda"), s_ffn, s_attn


def _ffn_bwd_plan(b, h, w, c, ch, forced):
    if forced is None:
        return None
    rows, cols, hc, splits = forced
    nch = -(-ch // hc)
    per = -(-nch // splits)
    return ops.ffn_bwd.FfnBwdPlan(rows, cols, hc, -(-nch // per), per,
                                  ops.ffn_bwd.ffn_bwd_smem(rows, cols, c, hc))


@pytest.mark.parametrize("b,h,w,c,ch,full,forced", FFN_BWD_CASES)
def test_ffn_bwd_launch_matches_plain(dev, b, h, w, c, ch, full, forced):
    """Each output of the backward launch against the plain steps of the FFN
    half (``stage_block.ffn_bwd_steps``, fed the same y and go) at
    ``stage_block.FFN_BWD_TOLERANCE`` (a flipped bf16 ulp of the LN output,
    a, go_s or d_hid_b, from f32 sums in other orders, carried into what
    follows: 2^-6; ln2 2^-7; db2 2^-10); two runs bitwise equal (no atomics,
    every partial summed in a fixed order)."""
    sb = ops.stage_block
    rng = np.random.RandomState(23)
    x, ffn, go, s_ffn, s_attn = _ffn_bwd_inputs(rng, b, h, w, c, ch, full)
    p = dict(shape=(b, h, w, c), dt=BF16, g2=ffn[0], be2=ffn[1], w1=ffn[2], b1=ffn[3], kdw=ffn[4],
             bdw=ffn[5], w2=ffn[6], s_ffn=s_ffn, s_attn=s_attn if full else None, eps=1e-6)
    t = {"y": x.reshape(-1, c), "go": go.reshape(-1, c)}
    ref = sb.run_steps(sb.ffn_bwd_steps(p, False, full, "t"), t)
    plan = _ffn_bwd_plan(b, h, w, c, ch, forced)
    run = lambda: ops.ffn_bwd.ffn_bwd_launch(x, go.reshape(-1, c), *ffn[:7], s_ffn, 1e-6, "t",
                                             s_attn=s_attn if full else None, full=full,
                                             plan=plan)
    got, again = run(), run()
    torch.cuda.synchronize()
    assert set(got) == {"a", "d_hid", "ln2", "dkdw", "dbdw", "db1", "dg2", "dbe2", "db2"} | (
        {"d_y", "d_attn", "dbproj"} if full else {"dx"})
    for key, g in got.items():
        want = ref[key]
        assert g.dtype == want.dtype and g.shape == want.shape, key
        assert torch.isfinite(g.float()).all(), key
        err = (g.float() - want.float()).abs().max().item()
        assert err <= sb.FFN_BWD_TOLERANCE[key] * want.float().abs().max().item(), (key, err)
        assert torch.equal(g, again[key]), key


@pytest.mark.parametrize("scale", [(0.0, 0.0), (1 / 0.9, 0.37), (1.0, 1.0)],
                         ids=["dropped", "scaled", "one"])
@pytest.mark.parametrize("b,h,w,c,ch,xdt,forced", [
    (2, 60, 60, 128, 512, F32, None), (2, 30, 30, 320, 1280, F32, (8, 8, 64, 2)),
    (2, 120, 120, 64, 256, BF16, None), (2, 9, 11, 64, 256, BF16, (2, 5, 32, 3))])
def test_ffn_fused_launch_with_branch_scale(dev, b, h, w, c, ch, xdt, forced, scale):
    """The forward launch of the train pairs: out = res + s·FFN(LN(x)) with
    the per-frame scale s, against the plain steps at 2^-6 (as without the
    scale), the f32 residual of the whole block (row 6) and the bf16 x of
    the pair (row 10), with and without the split; a scale of 0 gives the
    residual itself, rounded once; two runs bitwise equal."""
    ff = ops.ffn_fused
    rng = np.random.RandomState(24)
    args = _ffn_inputs(rng, b, h, w, c, ch, xdt)
    x = args[0]
    s = torch.tensor(scale, device=dev)
    plan = None
    if forced is not None:
        rows, cols, hc, splits = forced
        nch = -(-ch // hc)
        per = -(-nch // splits)
        plan = ff.FfnPlan(rows, cols, hc, -(-nch // per), per, ff.ffn_fused_smem(rows, cols, c, hc))
    st = ops.stage_block._ffn_fwd_steps(*args[1:], s, 1e-6, tuple(x.shape), BF16, False, "t")
    y = x.reshape(-1, c)
    want = st["out"](st["a"](st["hid"](y)), y)
    got = ff.ffn_fused_launch(x, *args[1:], 1e-6, y, "t", plan=plan, scale=s)
    again = ff.ffn_fused_launch(x, *args[1:], 1e-6, y, "t", plan=plan, scale=s)
    _close(got, want, 2.0 ** -6)
    assert torch.equal(got, again)
    if scale == (0.0, 0.0):
        assert torch.equal(got, y.to(BF16))


def _port_kernels(fn) -> int:
    """The port's own CUDA kernels (csrc/, all in anonymous namespaces) one
    call of fn launches, as torch.profiler traces them: dtype copies and
    torch's reductions of the partials left out."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    own = re.compile(r"^(void )?\(anonymous namespace\)::")
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and own.match(e.key))


@pytest.mark.parametrize("shape,ch,s,nh", [((8, 60, 60, 128), 512, 225, 2),
                                           ((8, 30, 30, 320), 1280, 225, 5)])
def test_train_pairs_launch_counts(dev, shape, ch, s, nh):
    """Kernels of the port per call at the step's stage 2 and 3 shapes: the
    block-FFN pair's forward 1 (2 where the forward's plan splits), its
    backward the launch (2 with a split) and the dW2, dW1 reductions; the
    whole block's forward q, ctx, y and the FFN launch, its backward the FFN
    half's three (four) and the attention half's six."""
    rng = np.random.RandomState(25)
    ins, s_attn, s_ffn, go = _block_train_inputs(rng, shape, ch, s, dev)
    b, h, w, c = shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    fsplit = ops.ffn_fused.ffn_fused_plan(b, h, w, c, ch, sms).splits > 1
    bsplit = ops.ffn_bwd.ffn_bwd_plan(b, h, w, c, ch, sms).splits > 1
    x, ffn = ins[0], ins[9:]
    with torch.no_grad():
        assert _port_kernels(lambda: ops.block_ffn_train(x, *ffn, s_ffn)) == 1 + fsplit
        assert _port_kernels(lambda: ops.mit_block_train(*ins, s_attn, s_ffn, num_heads=nh)) \
            == 4 + fsplit
    assert _port_kernels(lambda: ops.block_ffn_train_bwd(x, *ffn[:7], s_ffn, go)) == 3 + bsplit
    sb = ops.stage_block
    acts = sb._run(sb._block_steps(*ins[:16], None, num_heads=nh, eps=1e-6, kernel=True,
                                   s_attn=s_attn, s_ffn=s_ffn), names=sb._ACTS)
    assert _port_kernels(lambda: ops.mit_block_train_bwd(*ins[:16], s_attn, s_ffn, go,
                                                         num_heads=nh, acts=acts)) == 9 + bsplit


def test_ffn_bwd_memory_rise(dev):
    """At the train step's stage 1 (8 frames of 120x120, C 64, Ch 256) the
    pair's backward allocates beyond its inputs and outputs at most M·Ch·4
    bytes (a and d_hid_b in bf16, for the weight products) + M·C·2 (ln2) +
    the per-block partial sums (11·Ch + 4·C f32 a tile of its plan, and the
    weight products' row-split partials of Ch x C f32) + 1 MiB; an f32 map
    of M x Ch (the d_a the six launches it replaced wrote, M·Ch·6 with
    d_hid) would add M·Ch·4 more."""
    rng = np.random.RandomState(26)
    b, h, w, c, ch = 8, 120, 120, 64, 256
    m = b * h * w
    x, ffn, go, s_ffn, _ = _ffn_bwd_inputs(rng, b, h, w, c, ch, False)
    ops.block_ffn_train_bwd(x, *ffn[:7], s_ffn, go)  # built and warmed up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    grads = ops.block_ffn_train_bwd(x, *ffn[:7], s_ffn, go)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - base - sum(g.numel() * g.element_size()
                                                          for g in grads)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = ops.ffn_bwd.ffn_bwd_plan(b, h, w, c, ch, sms)
    tiles = b * -(-h // plan.rows) * -(-w // plan.cols)
    # the weight products' partials (stage_block.gemm_tn's split of the rows)
    gemm_splits = max(1, min(-(-4 * sms // (-(-ch // 64) * -(-c // 64))), -(-m // 256)))
    partials = tiles * (11 * ch + 4 * c) * 4 + gemm_splits * ch * c * 4
    assert rise <= m * ch * 4 + m * c * 2 + partials + 2 ** 20, (rise, m * ch * 4)


def test_ffn_bwd_smem_is_the_kernels(dev):
    """The planner's shared-memory sum (``ffn_bwd_smem``) equals the kernel's
    layout."""
    from vss_cffm_tpu_torch.ops import _build

    lib = _build.library("ffn_bwd")
    for c in (8, 32, 64, 128, 160, 320, 512):
        for rows, cols in ((1, 1), (4, 15), (8, 8), (12, 10), (5, 3)):
            if rows * cols <= ops.ffn_fused.max_pixels(c):
                for hc in (32, 64):
                    assert lib.ffn_bwd_smem_bytes(rows, cols, c, hc) == \
                        ops.ffn_bwd.ffn_bwd_smem(rows, cols, c, hc)
