"""PyTorch port, the CFM attention backward from saved probabilities on the
CPU (``_BWD = "kernel"``): the plain forward that also returns p against the
JAX Pallas kernel's probabilities call in interpret mode; the plain backward
from p against the JAX Pallas backward from p in interpret mode, on the same
p; the op's gradients in that mode against the JAX custom VJP in the same
mode; and a small segmentor's forward/backward with the decoder in that mode
on both sides.

Tolerances: f32 on both sides, sums in other orders: 2e-5 relative and
absolute (``F32_TOL``). bf16 on both sides: the rounding points held element
by element (``assert_bf16_rounded_alike``, ≥ 99 % bitwise equal), dbias (an
f32 sum over windows) to 1e-5 of its largest value (with bf16 p: 99.9 % of
its elements, every one within 2^-8), and p to 2e-6 (f32 softmaxes of the
same bf16 inputs, scores summed in other orders).
"""

from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import (assert_bf16_rounded_alike, flat, no_drop_path, to_jax_tree,
                               train_batch, train_configs)
from vss_cffm_tpu.models.losses import LossConfig as JaxLossConfig
from vss_cffm_tpu.models.losses import make_clip_loss as jax_make_clip_loss
from vss_cffm_tpu.models.segmentor import CFFMSegmentor as JaxSegmentor
from vss_cffm_tpu.ops import cfm_attention as jax_cfm
from vss_cffm_tpu.train.step import device_normalize as jax_device_normalize
from vss_cffm_tpu_torch import config as pcfg
from vss_cffm_tpu_torch import ops
from vss_cffm_tpu_torch.models import CFFMSegmentor
from vss_cffm_tpu_torch.models.losses import make_clip_loss

# the module (the package's name cfm_attention is the op)
port_cfm = importlib.import_module("vss_cffm_tpu_torch.ops.cfm_attention")
# the jitted JAX probabilities call, kept before any test patches the module
_JAX_IMPL = jax_cfm._cfm_attention_pallas_impl

F32_TOL = dict(rtol=2e-5, atol=2e-5)
GSIZES = [49, 20, 9]
NW, NH, HD = 10, 2, 32  # 10 windows: a ragged tail of the TPU kernel's window tile of 8


def _inputs(rng, dtype):
    c, n = NH * HD, sum(GSIZES)
    f = lambda *sh: torch.from_numpy(rng.randn(*sh).astype(np.float32)).to(dtype)
    q = f(NW, 49, c)
    ks = [f(NW, g, c) for g in GSIZES]
    vs = [f(NW, g, c) for g in GSIZES]
    bias = torch.from_numpy(rng.randn(NH, 49, n).astype(np.float32))
    mask = torch.from_numpy(np.where(rng.rand(NW, n) < 0.2, -100.0, 0.0).astype(np.float32))
    return q, ks, vs, bias, mask, f(NW, 49, c)


def _j(t: torch.Tensor):
    """The same values as a JAX array of the same dtype (bf16 or f32)."""
    return jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)


def _np(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.fixture
def probs_dtype(request, monkeypatch):
    """The residual's dtype on both sides: "f32" or "q" (None, q's dtype).
    The JAX module reads its switch while tracing, so its compiled probabilities
    call is dropped before and after."""
    _JAX_IMPL.clear_cache()
    monkeypatch.setattr(jax_cfm, "_PROBS_DTYPE", jnp.float32 if request.param == "f32" else None)
    monkeypatch.setattr(port_cfm, "_PROBS_DTYPE",
                        torch.float32 if request.param == "f32" else None)
    yield request.param
    _JAX_IMPL.clear_cache()


# (input dtype, the residual's dtype): p in q's dtype is p in f32 when q is f32
MODES = pytest.mark.parametrize("dtype,probs_dtype", [(torch.float32, "f32"),
                                                      (torch.bfloat16, "f32"),
                                                      (torch.bfloat16, "q")],
                                ids=["f32", "bf16-probs-f32", "bf16-probs-bf16"],
                                indirect=["probs_dtype"])


@MODES
def test_forward_with_probs_matches_pallas_interpret(rng, dtype, probs_dtype):
    """out and p: p (nW, nh, 49, N) in the port, (nh, nW, 49, N) in JAX."""
    q, ks, vs, bias, mask, _ = _inputs(rng, dtype)
    want_out, want_p = jax_cfm._cfm_attention_pallas_impl(
        _j(q), tuple(map(_j, ks)), tuple(map(_j, vs)), _j(bias), _j(mask), NH, interpret=True,
        with_probs=True)
    out, p = ops.cfm_attention_probs(q, ks, vs, bias, mask, NH)
    want_p = np.transpose(_np(want_p), (1, 0, 2, 3))
    p_dtype = torch.float32 if probs_dtype == "f32" else dtype
    assert p.dtype == p_dtype and tuple(p.shape) == want_p.shape
    if dtype == torch.float32:
        np.testing.assert_allclose(out.numpy(), _np(want_out), **F32_TOL)
        np.testing.assert_allclose(p.numpy(), want_p, **F32_TOL)
        return
    assert_bf16_rounded_alike(out, want_out, "out")
    if p_dtype == torch.float32:
        np.testing.assert_allclose(p.numpy(), want_p, rtol=0, atol=2e-6)
    else:
        assert_bf16_rounded_alike(p, want_p, "p")


@pytest.mark.parametrize("dtype,p_dtype", [(torch.float32, torch.float32),
                                           (torch.bfloat16, torch.float32),
                                           (torch.bfloat16, torch.bfloat16)],
                         ids=["f32", "bf16-probs-f32", "bf16-probs-bf16"])
def test_backward_from_probs_matches_pallas_interpret(rng, dtype, p_dtype):
    """The same p (the port's plain forward's, cast to p_dtype) into both
    backwards; dK and dV split back into the groups."""
    q, ks, vs, bias, mask, g = _inputs(rng, dtype)
    k, v = torch.cat(ks, 1), torch.cat(vs, 1)
    p = port_cfm._fwd_torch(q, ks, vs, bias, mask, NH)[1].to(p_dtype)
    dq, dks, dvs, dbias = jax_cfm._cfm_attention_bwd_pallas(
        _j(q), tuple(map(_j, ks)), tuple(map(_j, vs)), _j(p).transpose(1, 0, 2, 3), _j(g), NH,
        interpret=True)
    got = ops.cfm_attention_bwd_probs(q, k, v, p, g, NH)
    want = (dq, jnp.concatenate(dks, 1), jnp.concatenate(dvs, 1))
    if dtype == torch.float32:
        for a, b in zip(got, (*want, dbias)):
            np.testing.assert_allclose(a.numpy(), _np(b), **F32_TOL)
        return
    for a, b, label in zip(got, want, ("dq", "dk", "dv")):
        assert_bf16_rounded_alike(a, b, label)
    np.testing.assert_allclose(got[3].numpy(), _np(dbias), rtol=0,
                               atol=1e-5 * np.abs(_np(dbias)).max())


def _jax_kernel_mode(mp):
    """The JAX custom VJP in its "kernel" mode, its Pallas kernels in interpret
    mode (as ``tests/test_cfm_attention_kernel.py`` runs them)."""
    impl, bwd = jax_cfm._cfm_attention_pallas_impl, jax_cfm._cfm_attention_bwd_pallas
    mp.setattr(jax_cfm, "_BWD", "kernel")
    mp.setattr(jax_cfm, "_cfm_attention_pallas_impl",
               lambda *a, **kw: impl(*a, **{**kw, "interpret": True}))
    mp.setattr(jax_cfm, "_cfm_attention_bwd_pallas",
               lambda *a, **kw: bwd(*a, **{**kw, "interpret": True}))


@MODES
def test_op_gradients_match_the_jax_kernel_mode(rng, monkeypatch, dtype, probs_dtype):
    """``ops.cfm_attention`` with ``_BWD = "kernel"`` against the JAX custom
    VJP with ``_BWD = "kernel"``: gradients of q, each K/V group and the bias
    for the same output cotangent. With p in q's dtype under bf16 both sides
    round p to bf16 before the backward."""
    _jax_kernel_mode(monkeypatch)
    monkeypatch.setattr(port_cfm, "_BWD", "kernel")
    q, ks, vs, bias, mask, g = _inputs(rng, dtype)
    _, vjp = jax.vjp(lambda *a: jax_cfm.cfm_attention(*a, _j(mask), NH, force="pallas"),
                     _j(q), tuple(map(_j, ks)), tuple(map(_j, vs)), _j(bias))
    jq, jks, jvs, jbias = vjp(_j(g))
    leaves = [t.clone().requires_grad_(True) for t in (q, *ks, *vs, bias)]
    ops.reset_launches()
    out = ops.cfm_attention(leaves[0], leaves[1:4], leaves[4:7], leaves[7], mask, NH)
    out.backward(g)
    assert ops.launches()["cfm_attention_bwd_probs"] == 0  # CPU tensors: the plain versions
    want = [jq, *jks, *jvs]
    if dtype == torch.float32:
        for t, w in zip(leaves, (*want, jbias)):
            np.testing.assert_allclose(t.grad.numpy(), _np(w), **F32_TOL)
        return
    for i, (t, w) in enumerate(zip(leaves[:7], want)):
        assert_bf16_rounded_alike(t.grad, w, f"grad {i}")
    err = np.abs(leaves[7].grad.numpy() - _np(jbias))
    top = np.abs(_np(jbias)).max()
    if probs_dtype == "f32":
        assert err.max() <= 1e-5 * top
    else:
        # p rounded to bf16 on each side from f32 softmaxes that differ in the
        # last bits: where one p flips by a bf16 ulp, its ds moves by up to
        # 2^-8 of itself, so a few dbias sums move; the rest hold at 1e-5
        assert np.mean(err <= 1e-5 * top) >= 0.999 and err.max() <= 2.0 ** -8 * top


def test_the_switch_is_read_at_the_forward(rng, monkeypatch):
    """The mode of a forward decides its backward; an unknown mode raises."""
    q, ks, vs, bias, mask, g = _inputs(rng, torch.float32)
    q = q.requires_grad_(True)
    monkeypatch.setattr(port_cfm, "_BWD", "kernel")
    out = ops.cfm_attention(q, ks, vs, bias, mask, NH)
    monkeypatch.setattr(port_cfm, "_BWD", "recompute")
    called = []
    monkeypatch.setattr(port_cfm, "cfm_attention_bwd_probs",
                        lambda *a, **kw: called.append(1) or ops.cfm_attention_bwd_probs(*a, **kw))
    out.backward(g)
    assert called == [1]
    monkeypatch.setattr(port_cfm, "_BWD", "xla")
    with pytest.raises(ValueError, match="_BWD"):
        ops.cfm_attention(q, ks, vs, bias, mask, NH)


# ---- a segmentor in the probs form, the model and clip of test_torch_port_train ----

HW = (112, 112)
CLASSES = 7


def test_segmentor_gradients_in_the_probs_form_match_jax(monkeypatch):
    """CFFM-B0 112² (the model and clip of ``test_torch_port_train``), composed blocks, one train forward + CE loss + backward
    on each side with the decoder's attention in the "kernel" backward mode
    (on the JAX side the Pallas pair in interpret mode, reached through
    ``force="pallas"``; its CE composed in XLA, the port's plain): the loss to 1e-5 relative and every parameter's
    gradient to 1e-3 of its own largest entry plus 1e-5 of the model's
    largest, the limits of ``test_torch_port_train``'s forward/backward."""
    _jax_kernel_mode(monkeypatch)
    pallas = jax_cfm.cfm_attention
    monkeypatch.setattr(jax_cfm, "cfm_attention",
                        lambda *a, **kw: pallas(*a[:6], force="pallas"))
    monkeypatch.setattr(port_cfm, "_BWD", "kernel")
    with no_drop_path("b0"):
        jcfg, pc = train_configs("b0", CLASSES, depth=1)
        jm = JaxSegmentor(jcfg)
        # the port's init, every parameter + 0.02·N(0, 1) so that zero biases
        # and bias tables are exercised, carried to the JAX tree (no JAX init)
        pm = CFFMSegmentor(pc)
        pm.init_weights(torch.Generator().manual_seed(0))
        rng = np.random.RandomState(1)
        with torch.no_grad():
            for p in pm.parameters():
                p += torch.from_numpy(0.02 * rng.standard_normal(p.shape).astype(np.float32))
        variables = to_jax_tree(pm, {}, jcfg)
        pm.train()
        imgs_u8, labels = train_batch(1, HW, CLASSES)
        # the JAX composed CE counts a label outside [0, C) other than 255 as
        # class 0, the port ignores it: classes and 255 only
        labels[labels == CLASSES] = 255
        imgs = np.array(jax_device_normalize(jnp.asarray(imgs_u8)))
        jloss = jax_make_clip_loss(JaxLossConfig())

        def loss_fn(params):
            out, _ = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                              jnp.asarray(imgs), True, mutable=["batch_stats"])
            return jloss(out, jnp.asarray(labels).astype(jnp.int32))["loss_seg"]

        jl, jgrads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
        pl = make_clip_loss(pcfg.LossConfig())(pm(torch.from_numpy(imgs), train=True),
                                               torch.from_numpy(labels))["loss_seg"]
        pl.backward()
    np.testing.assert_allclose(pl.item(), float(jl), rtol=1e-5)
    jg = flat(jax.device_get(jgrads))
    pg = flat(to_jax_tree(pm, {n: p.grad for n, p in pm.named_parameters()}, jcfg)["params"])
    top = max(np.abs(g).max() for g in jg.values())
    bias_tables = [n for n in jg if "relative_position_bias_table" in n]
    assert bias_tables and all(np.abs(jg[n]).max() > 0 for n in bias_tables)
    for name, want in jg.items():
        err = np.abs(pg[name] - want).max()
        assert err <= 1e-3 * np.abs(want).max() + 1e-5 * top, (name, err)
