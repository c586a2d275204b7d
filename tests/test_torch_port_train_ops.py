"""PyTorch port, the train step's ops on the CPU: each new plain version (the
CE on upsampled logits, forward and backward; the CFM attention backward;
the depthwise conv backward) against the JAX Pallas kernel in interpret mode
or the JAX custom VJP, in f32 and, for the backwards that round to bf16, in
bf16, and against autograd of its own plain forward; dropout and stochastic
depth; the refusals of this slice."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import assert_bf16_rounded_alike
from vss_cffm_tpu.ops import ce_upsampled as jax_ce
from vss_cffm_tpu.ops import cfm_attention as jax_cfm
from vss_cffm_tpu.ops import dwconv as jax_dw
from vss_cffm_tpu_torch import config as pcfg
from vss_cffm_tpu_torch import ops
from vss_cffm_tpu_torch.models import CFFMSegmentor
from vss_cffm_tpu_torch.models.heads import dropout2d
from vss_cffm_tpu_torch.models.losses import clip_ce_loss, make_clip_loss
from vss_cffm_tpu_torch.models.mit import MiTBlock, drop_path

# f32 on both sides, sums in other orders (and the bilinear lerp rounded as
# F.interpolate rounds it): a few f32 ulps of O(1) values.
F32_TOL = dict(rtol=2e-5, atol=2e-5)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a))


def _ce_inputs(rng, n, h, w, c, s):
    logits = (rng.randn(n, h, w, c) * 2).astype(np.float32)
    labels = rng.randint(0, c, (n, h * s, w * s)).astype(np.int32)
    labels[rng.rand(*labels.shape) < 0.1] = 255
    labels[rng.rand(*labels.shape) < 0.03] = c + 3  # out of range, not 255: ignored too
    return logits, labels


@pytest.mark.parametrize("n,h,w,c,s", [(2, 6, 10, 19, 4), (1, 8, 6, 19, 2),
                                       (2, 4, 7, 130, 4)])
def test_ce_loss_plain_matches_pallas_interpret(rng, n, h, w, c, s):
    """wsum to f32 rounding; the correct count exactly (no near-ties at
    these random logits)."""
    logits, labels = _ce_inputs(rng, n, h, w, c, s)
    img_w = 0.5 / labels.size
    want = jax_ce._ce_fwd_loss_pallas(jnp.asarray(logits),
                                      jax_ce.labels_to_phase(jnp.asarray(labels), s), s, img_w,
                                      interpret=True)
    got = ops.ce_upsampled_loss(_t(logits), _t(labels), s, img_w)
    np.testing.assert_allclose(got[0].item(), float(want[0]), **F32_TOL)
    assert got[1].item() == float(want[1])
    none = ops.ce_upsampled_loss(_t(logits), _t(labels), s, img_w, count_acc=False)
    assert none[1].item() == 0.0


@pytest.mark.parametrize("n,h,w,c,s", [(1, 6, 10, 19, 4), (2, 8, 5, 23, 2)])
def test_ce_loss_bwd_plain_matches_pallas_interpret(rng, n, h, w, c, s):
    logits, labels = _ce_inputs(rng, n, h, w, c, s)
    img_w, g = 1.0 / labels.size, 1.3
    want = np.asarray(jax_ce._ce_bwd_loss_pallas5(
        jnp.asarray(logits), jax_ce.labels_to_phase_w(jnp.asarray(labels), s),
        jnp.asarray(g, jnp.float32), s, c, img_w, interpret=True))
    got = ops.ce_upsampled_loss_bwd(_t(logits), _t(labels), torch.tensor(g), s, img_w)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=1e-9)


def test_ce_loss_bwd_plain_matches_autograd(rng):
    logits, labels = _ce_inputs(rng, 2, 5, 6, 11, 4)
    x = _t(logits).requires_grad_(True)
    wsum, _ = ops.ce_upsampled_loss_torch(x, _t(labels), 4, 0.01)
    (wsum * 0.7).backward()
    got = ops.ce_upsampled_loss_bwd_torch(_t(logits), _t(labels), torch.tensor(0.7), 4, 0.01)
    torch.testing.assert_close(got, x.grad, rtol=1e-5, atol=1e-9)


def _cfm_inputs(rng, nw, nh, hd, gsizes):
    c = nh * hd
    n = sum(gsizes)
    f = lambda *sh: rng.randn(*sh).astype(np.float32)
    q = f(nw, 49, c)
    ks = [f(nw, g, c) for g in gsizes]
    vs = [f(nw, g, c) for g in gsizes]
    bias = f(nh, 49, n)
    mask = np.where(rng.rand(nw, n) < 0.2, -100.0, 0.0).astype(np.float32)
    return q, ks, vs, bias, mask, f(nw, 49, c)


def test_cfm_attention_bwd_plain_matches_pallas_interpret(rng):
    """Grouped K/V [49, 132, 25], 10 windows (not a multiple of the TPU
    kernel's window tile of 8: its ragged dbias tail), 2 heads of 32, a mask
    with −100 entries. The port's backward runs on the packed K/V; dK and dV
    are split back into the groups."""
    gsizes = [49, 132, 25]
    q, ks, vs, bias, mask, g = _cfm_inputs(rng, 10, 2, 32, gsizes)
    dq, dks, dvs, dbias = jax_cfm._cfm_attention_bwd_pallas_rc(
        jnp.asarray(q), tuple(map(jnp.asarray, ks)), tuple(map(jnp.asarray, vs)),
        jnp.asarray(bias), jnp.asarray(mask), jnp.asarray(g), 2, interpret=True)
    got = ops.cfm_attention_bwd(_t(q), torch.cat([_t(k) for k in ks], 1),
                                torch.cat([_t(v) for v in vs], 1), _t(bias), _t(mask), _t(g), 2)
    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(dq), **tol)
    np.testing.assert_allclose(got[1].numpy(), np.concatenate(dks, 1), **tol)
    np.testing.assert_allclose(got[2].numpy(), np.concatenate(dvs, 1), **tol)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(dbias), **tol)


def _bf16(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _j(t: torch.Tensor):
    """The same values as a JAX array of the same dtype (bf16 or f32)."""
    return jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)


def test_cfm_attention_bwd_plain_matches_pallas_interpret_bf16(rng):
    """bf16 q, K, V and g, as on the card: the rounding points of
    ``_bwd_kernel_rc`` and its wrapper (q·scale in q's dtype, ds and p
    rounded to bf16, dq rounded twice) held element by element; dbias is an
    f32 sum over windows, 1e-5 of its largest."""
    gsizes = [49, 132, 25]
    q, ks, vs, bias, mask, g = _cfm_inputs(rng, 10, 2, 32, gsizes)
    q, g, ks, vs = _bf16(q), _bf16(g), [_bf16(k) for k in ks], [_bf16(v) for v in vs]
    bias, mask = _t(bias), _t(mask)
    dq, dks, dvs, dbias = jax_cfm._cfm_attention_bwd_pallas_rc(
        _j(q), tuple(map(_j, ks)), tuple(map(_j, vs)), _j(bias), _j(mask), _j(g), 2,
        interpret=True)
    got = ops.cfm_attention_bwd(q, torch.cat(ks, 1), torch.cat(vs, 1), bias, mask, g, 2)
    assert_bf16_rounded_alike(got[0], dq, "dq")
    assert_bf16_rounded_alike(got[1], jnp.concatenate(dks, 1), "dk")
    assert_bf16_rounded_alike(got[2], jnp.concatenate(dvs, 1), "dv")
    np.testing.assert_allclose(got[3].numpy(), np.asarray(dbias),
                               atol=1e-5 * np.abs(np.asarray(dbias)).max())


def test_cfm_attention_grads_through_the_op(rng):
    """Autograd of ``ops.cfm_attention`` (the Function over the packed K/V,
    split back into groups by autograd) equals autograd of the plain
    forward; the mask gets no gradient."""
    gsizes = [49, 20, 9]
    q, ks, vs, bias, mask, g = _cfm_inputs(rng, 3, 2, 32, gsizes)

    def grads(fn):
        leaves = [_t(q).requires_grad_(True), *[_t(k).requires_grad_(True) for k in ks],
                  *[_t(v).requires_grad_(True) for v in vs], _t(bias).requires_grad_(True)]
        m = _t(mask).requires_grad_(True)
        out = fn(leaves[0], leaves[1:4], leaves[4:7], leaves[7], m, 2)
        (out * _t(g)).sum().backward()
        return [x.grad for x in leaves], m.grad

    got, gmask = grads(ops.cfm_attention)
    want, _ = grads(ops.cfm_attention_torch)
    assert gmask is None
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shape", [(1, 7, 9, 16), (2, 5, 11, 24)])
def test_dwconv_bwd_plain_matches_jax_vjp(rng, shape):
    """Odd H and W; the JAX hand-written VJP (``_dwconv3x3_shifts_cvjp``)."""
    c = shape[-1]
    x = rng.randn(*shape).astype(np.float32)
    k = (rng.randn(3, 3, 1, c) * 0.3).astype(np.float32)
    b = (rng.randn(c) * 0.1).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jax_dw._dwconv3x3_shifts_cvjp(*a, True), jnp.asarray(x),
                     jnp.asarray(k), jnp.asarray(b))
    want = vjp(jnp.asarray(g))
    leaves = [_t(x).requires_grad_(True), _t(k).requires_grad_(True), _t(b).requires_grad_(True)]
    (ops.dwconv3x3(*leaves, gelu=True) * _t(g)).sum().backward()
    for a, w in zip(leaves, want):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)
    # and against autograd of the plain forward
    plain = [_t(x).requires_grad_(True), _t(k).requires_grad_(True), _t(b).requires_grad_(True)]
    (ops.dwconv3x3_torch(*plain, gelu=True) * _t(g)).sum().backward()
    for a, p in zip(leaves, plain):
        torch.testing.assert_close(a.grad, p.grad, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shape", [(1, 7, 9, 16), (2, 5, 11, 24)])
def test_dwconv_bwd_plain_matches_jax_vjp_bf16(rng, shape):
    """bf16 x and g with f32 taps and bias, as in the model: the one bf16
    rounding of gz = g·GELU′(z) before the dx correlation held element by
    element; dk and dbias are f32 sums of the unrounded gz, 1e-5 of their
    largest (rounding gz there moves them by ~1e-3)."""
    c = shape[-1]
    x, g = _bf16(rng.randn(*shape)), _bf16(rng.randn(*shape))
    k = _t((rng.randn(3, 3, 1, c) * 0.3).astype(np.float32))
    b = _t((rng.randn(c) * 0.1).astype(np.float32))
    _, vjp = jax.vjp(lambda *a: jax_dw._dwconv3x3_shifts_cvjp(*a, True), _j(x), _j(k), _j(b))
    want = vjp(_j(g))
    leaves = [x.clone().requires_grad_(True), k.clone().requires_grad_(True),
              b.clone().requires_grad_(True)]
    ops.dwconv3x3(*leaves, gelu=True).backward(g)
    assert_bf16_rounded_alike(leaves[0].grad, want[0], "dx")
    for leaf, w in zip(leaves[1:], want[1:]):
        w = np.asarray(w)
        np.testing.assert_allclose(leaf.grad.numpy(), w, atol=1e-5 * np.abs(w).max())


def test_cfm_attention_bwd_plain_matches_autograd(rng):
    q, ks, vs, bias, mask, g = _cfm_inputs(rng, 4, 2, 32, [30])
    leaves = [_t(q).requires_grad_(True), _t(ks[0]).requires_grad_(True),
              _t(vs[0]).requires_grad_(True), _t(bias).requires_grad_(True)]
    out = ops.cfm_attention_torch(leaves[0], [leaves[1]], [leaves[2]], leaves[3], _t(mask), 2)
    (out * _t(g)).sum().backward()
    got = ops.cfm_attention_bwd_torch(_t(q), _t(ks[0]), _t(vs[0]), _t(bias), _t(mask), _t(g), 2)
    for a, leaf in zip(got, leaves):
        torch.testing.assert_close(a, leaf.grad, rtol=1e-4, atol=1e-5)


def test_dropout2d_and_drop_path_semantics():
    """Dropout2d zeroes whole channels per sample and scales the rest by
    1/keep; drop path zeroes whole samples (frames); both reproduce from the
    same generator seed and differ with another."""
    x = torch.ones(6, 5, 4, 32)
    a = dropout2d(x, 0.3, torch.Generator().manual_seed(3))
    per_channel = a.reshape(6, 20, 32)
    assert torch.all(per_channel == per_channel[:, :1])            # whole (sample, channel)
    assert set(torch.unique(a).tolist()) == {0.0, float(np.float32(1.0 / 0.7))}
    assert 0 < (a == 0).float().mean() < 1
    torch.testing.assert_close(a, dropout2d(x, 0.3, torch.Generator().manual_seed(3)))
    assert not torch.equal(a, dropout2d(x, 0.3, torch.Generator().manual_seed(4)))
    d = drop_path(x, 0.5, torch.Generator().manual_seed(0))
    per_frame = d.reshape(6, -1)
    assert torch.all(per_frame == per_frame[:, :1])
    assert set(per_frame[:, 0].tolist()) <= {0.0, 2.0}
    torch.testing.assert_close(d, drop_path(x, 0.5, torch.Generator().manual_seed(0)))
    assert drop_path(x, 0.0, None) is x
    with pytest.raises(ValueError, match="explicit torch.Generator"):
        drop_path(x, 0.1, None)


def test_fused_block_refuses_grad_and_train_mode_runs_composed(rng):
    blk = MiTBlock(32, 1, 2, 4, True, 1e-6, fused=True)
    x = torch.from_numpy(rng.randn(1, 6, 6, 32).astype(np.float32))
    args, kw = blk.fused_args(x)
    with pytest.raises(RuntimeError, match="mit_block_fused has no backward"):
        ops.mit_block_fused(*args, **kw)
    with torch.no_grad():
        ops.mit_block_fused(*args, **kw)
    blk.train()
    ops.reset_launches()
    out = blk(x)
    out.sum().backward()                       # composed: a graph to every parameter
    assert blk.mlp.fc1.weight.grad is not None and blk.attn.q.weight.grad is not None
    blk.eval()
    with torch.no_grad():
        torch.testing.assert_close(blk(x), out.detach(), rtol=1e-4, atol=1e-4)


def test_unsupported_train_settings_raise():
    """The train block forms are None, "full" and "ffn" per stage, as the JAX
    package's (without its interpret modes); anything else raises. The JAX
    default is the port's, and the override parser takes per-stage forms.
    ``dwconv_impl`` takes None and "fused"; the JAX package's TPU and
    interpret names raise. Every loss the JAX ``make_clip_loss`` serves is
    built; an unknown loss type, a class weight of the wrong length, an
    ``ignore_index`` inside [0, C) and a decoder dropout rate of 1 (a keep
    probability of 0 cannot scale) raise."""
    assert pcfg.build_model_config("b1").train_block_impl == ("full", "full", "full", None)
    cfg = pcfg.apply_overrides(pcfg.build_model_config("b1"),
                               ["train_block_impl=ffn,ffn,full,"])
    assert cfg.train_block_impl == ("ffn", "ffn", "full", None)
    assert cfg.backbone_config.train_block_impl == ("ffn", "ffn", "full", None)
    with pytest.raises(ValueError, match="train_block_impl"):
        pcfg.SegmentorConfig(train_block_impl=("full", "fused", "full", None))
    with pytest.raises(ValueError, match="train_block_impl"):
        pcfg.apply_overrides(pcfg.build_model_config("b1"), ["train_block_impl=full-interpret"])
    assert pcfg.apply_overrides(pcfg.build_model_config("b1"),
                                ["dwconv_impl=fused"]).backbone_config.dwconv_impl == "fused"
    for name in ("fused-interpret", "xla", "shifts", "shifts-cvjp", "pallas", "interpret"):
        with pytest.raises(ValueError, match="dwconv_impl"):
            pcfg.apply_overrides(pcfg.build_model_config("b1"), [f"dwconv_impl={name}"])
        with pytest.raises(ValueError, match="dwconv_impl"):
            pcfg.MiTConfig(dwconv_impl=name)
    logits = torch.zeros(1, 5, 2, 2, 7)
    labels = torch.zeros(1, 4, 8, 8, dtype=torch.uint8)
    for cfg in (pcfg.LossConfig(type="lovasz"), pcfg.LossConfig(use_ohem=True),
                pcfg.LossConfig(class_weight=(1.0,) * 7)):
        out = make_clip_loss(cfg)(logits, labels)
        assert set(out) == {"loss_seg", "acc_seg"} and torch.isfinite(out["loss_seg"])
    with pytest.raises(ValueError, match="unknown loss type"):
        make_clip_loss(pcfg.LossConfig(type="dice"))
    with pytest.raises(ValueError, match="class_weight"):
        make_clip_loss(pcfg.LossConfig(class_weight=(1.0, 2.0)))(logits, labels)
    with pytest.raises(ValueError, match="ignore_index 3 is a class"):
        clip_ce_loss(torch.zeros(1, 5, 2, 2, 7), torch.zeros(1, 4, 8, 8, dtype=torch.uint8),
                     ignore_index=3)
    cfg = pcfg.build_model_config("b0", num_classes=7)
    with pytest.raises(ValueError, match=r"attn_drop=1.0: a dropout rate must be in \[0, 1\)"):
        dec = dataclasses.replace(cfg.head.decoder, attn_drop=1.0)
        CFFMSegmentor(dataclasses.replace(cfg, head=dataclasses.replace(cfg.head, decoder=dec)))
    model = CFFMSegmentor(cfg).eval()
    with pytest.raises(ValueError, match="train\\(\\) mode"):
        model(torch.zeros(1, 4, 64, 64, 3), train=True)


def test_train_step_builds_its_loss_from_the_head_config(monkeypatch):
    """``make_train_step`` reads ``model.config.head.loss`` by default, as the
    JAX step does: a head configured for OHEM with class weights or for
    Lovász trains with that loss, an explicit ``LossConfig`` overrides it."""
    from vss_cffm_tpu_torch.train import build_optimizer, make_train_step
    from vss_cffm_tpu_torch.train import step as step_mod

    built = []
    monkeypatch.setattr(step_mod, "make_clip_loss",
                        lambda c, ignore_index: built.append(c) or make_clip_loss(c, ignore_index))
    cfg = pcfg.build_model_config("b0", num_classes=7)
    for loss in (pcfg.LossConfig(use_ohem=True, class_weight=(0.5,) * 7),
                 pcfg.LossConfig(type="lovasz")):
        model = CFFMSegmentor(dataclasses.replace(
            cfg, head=dataclasses.replace(cfg.head, loss=loss))).train()
        opt, sched = build_optimizer(model, pcfg.OptimConfig())
        make_train_step(model, opt, sched)
        make_train_step(model, opt, sched, pcfg.LossConfig())   # an explicit CE config
        assert built[-2:] == [loss, pcfg.LossConfig()]


def test_force_rule_of_the_new_ops_on_cpu(rng):
    logits, labels = _ce_inputs(rng, 1, 4, 4, 5, 2)
    with pytest.raises(RuntimeError, match="force='kernel' needs CUDA"):
        ops.ce_upsampled_loss(_t(logits), _t(labels), 2, 1.0, force="kernel")
    with pytest.raises(RuntimeError, match="force='kernel' needs CUDA"):
        ops.ce_upsampled_loss_bwd(_t(logits), _t(labels), torch.tensor(1.0), 2, 1.0,
                                  force="kernel")
    q = torch.zeros(2, 49, 64)
    with pytest.raises(RuntimeError, match="force='kernel' needs CUDA"):
        ops.cfm_attention_bwd(q, q, q, torch.zeros(2, 49, 49), torch.zeros(2, 49), q, 2,
                              force="kernel")
    with pytest.raises(ValueError, match="upsampled"):
        ops.ce_upsampled_loss(_t(logits), _t(labels)[:, :-1], 2, 1.0)


def test_global_norm_clip_matches_optax(rng):
    """``clip_by_global_norm_`` against optax's, above and below the limit
    (f32 norms summed in other orders: 1e-6 relative)."""
    import optax

    from vss_cffm_tpu_torch.train.optim import clip_by_global_norm_, global_norm

    arrays = [rng.randn(3, 4).astype(np.float32), rng.randn(7).astype(np.float32)]
    for max_norm in (1.0, 100.0):
        want, _ = optax.clip_by_global_norm(max_norm).update(
            [jnp.asarray(a) for a in arrays], optax.EmptyState())
        grads = [_t(a.copy()) for a in arrays]
        norm = global_norm(grads)
        np.testing.assert_allclose(norm.item(), float(optax.global_norm(arrays)), rtol=1e-6)
        clip_by_global_norm_(grads, max_norm, norm)
        for g, w in zip(grads, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def test_cross_entropy_and_accuracy_match_jax(rng):
    """The plain per-pixel CE (mean over all pixels, ignored ones adding 0)
    and accuracy (ignored pixels count wrong) against the JAX package's."""
    from vss_cffm_tpu.models import losses as jax_losses
    from vss_cffm_tpu_torch.models.losses import accuracy, cross_entropy

    logits = rng.randn(2, 6, 5, 9).astype(np.float32)
    labels = rng.randint(0, 9, (2, 6, 5)).astype(np.int32)
    labels[rng.rand(*labels.shape) < 0.2] = 255
    np.testing.assert_allclose(
        cross_entropy(_t(logits), _t(labels)).item(),
        float(jax_losses.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))), rtol=1e-6)
    np.testing.assert_allclose(accuracy(_t(logits), _t(labels)).item(),
                               float(jax_losses.accuracy(jnp.asarray(logits),
                                                         jnp.asarray(labels))), rtol=1e-6)


@pytest.mark.parametrize("tp", [5, 7, 8, 9])  # T' = T+1, T+3, 2T, 2T+1 with T = 4
def test_clip_loss_case_table_matches_jax(rng, tp):
    """``_split_clip_cases`` equals the JAX table in every case, and
    ``clip_ce_loss`` (the fused route) equals 0.5·CE(ori) + CE(last) of the
    plain per-pixel CE on the upsampled logits (f32 sums in other orders)."""
    from vss_cffm_tpu.models import losses as jax_losses
    from vss_cffm_tpu_torch.models.losses import _split_clip_cases, cross_entropy

    logits = rng.randn(2, tp, 3, 4, 6).astype(np.float32)
    labels = rng.randint(0, 6, (2, 4, 12, 16)).astype(np.int32)
    labels[rng.rand(*labels.shape) < 0.1] = 255
    want = jax_losses._split_clip_cases(jnp.asarray(logits), jnp.asarray(labels))
    got = _split_clip_cases(_t(logits), _t(labels))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    up = lambda x: ops.resize_bilinear(x, (12, 16))
    plain = 0.5 * cross_entropy(up(got[0]), got[2]) + cross_entropy(up(got[1]), got[3])
    out = clip_ce_loss(_t(logits), _t(labels))
    np.testing.assert_allclose(out["loss_seg"].item(), plain.item(), rtol=1e-5)
