"""PyTorch port, the per-pixel loss route on the CPU: the plain versions of
``ce_upsampled_nll`` and its backward against the JAX Pallas kernels
``_ce_fwd_pallas`` / ``_ce_bwd_pallas`` in interpret mode (through
``phase_to_natural``); ``clip_ce_loss`` with OHEM, with class weights and with
both, against the JAX per-pixel route (its kernels interpreted) and its
composed route, loss, ``acc_seg`` and the gradient from ``jax.grad``, at
OHEM settings that keep 20–80 % of the valid pixels; the Lovász and city
losses and the plain per-pixel helpers against their JAX functions.

Labels here are classes or 255: a label outside [0, C) that is not the
ignore index is ignored by the port, and the JAX per-pixel route would count
it as a pixel of class 0 (``models/losses.py``); a test pins the port's rule.

The JAX per-pixel route runs eagerly, not under one ``jax.jit``: its Pallas
pair is jitted per shape and dtype, so the interpret-mode compile (most of
these tests' time) is made once, by the first pair test, at the clip tests'
shapes and uint8 labels, and serves every per-pixel case after it."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vss_cffm_tpu.models import losses as jax_losses
from vss_cffm_tpu.ops import ce_upsampled as jax_ce
from vss_cffm_tpu_torch import config as pcfg
from vss_cffm_tpu_torch import ops
from vss_cffm_tpu_torch.models import losses


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a))


def _close(got, want, rel: float, label: str) -> None:
    """Held to ``rel`` of the largest |want|: f32 on both sides, sums in
    other orders and the bilinear lerp rounded as F.interpolate rounds it."""
    g, w = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert g.shape == w.shape, label
    err = np.abs(g - w).max()
    assert err <= rel * np.abs(w).max(), (label, err, np.abs(w).max())


B, T, H, W, C = 2, 4, 6, 8, 7


# the first case is the JAX per-pixel route's call in the clip tests below
# (both branches concatenated, B·(T+1) frames, ×4, uint8 labels); the second
# has C > 128
@pytest.mark.parametrize("n,h,w,c,s", [(B * (T + 1), H, W, C, 4), (1, 8, 6, 130, 2)])
def test_ce_nll_pair_matches_pallas_interpret(n, h, w, c, s):
    """Rows 12 and 13: nll, lse and dlogits to 1e-5 of their largest value,
    pred (first maximum) exactly; labels with 255 and out-of-range entries
    (class 0 picked on both sides) and a per-pixel cotangent that is not 0
    there either."""
    rng = np.random.RandomState(0)
    logits = (rng.randn(n, h, w, c) * 2).astype(np.float32)
    labels = rng.randint(0, c, (n, h * s, w * s)).astype(np.uint8)
    labels[rng.rand(*labels.shape) < 0.1] = 255
    labels[rng.rand(*labels.shape) < 0.03] = c + 3
    g = rng.randn(*labels.shape).astype(np.float32)
    lab_ph = jax_ce.labels_to_phase(jnp.asarray(labels), s)
    nll_ph, pred_ph, lse_ph = jax_ce._ce_fwd_pallas(jnp.asarray(logits), lab_ph, s,
                                                    interpret=True)
    nat = lambda a: np.asarray(jax_ce.phase_to_natural(a, s))
    nll, pred, lse = ops.ce_upsampled_nll(_t(logits), _t(labels), s)
    _close(nll.numpy(), nat(nll_ph), 1e-5, "nll")
    _close(lse.numpy(), nat(lse_ph), 1e-5, "lse")
    assert pred.dtype == torch.int32
    np.testing.assert_array_equal(pred.numpy(), nat(pred_ph))
    want = jax_ce._ce_bwd_pallas(jnp.asarray(logits), lab_ph, lse_ph,
                                 jax_ce.labels_to_phase(jnp.asarray(g), s), s, c, interpret=True)
    got = ops.ce_upsampled_nll_bwd(_t(logits), _t(labels), lse, _t(g), s)
    _close(got.numpy(), np.asarray(want), 1e-5, "dlogits")
    # the autograd Function: the same backward, its cotangent from nll only
    x = _t(logits).requires_grad_(True)
    out, _, _ = ops.ce_upsampled_nll(x, _t(labels), s)
    (out * _t(g)).sum().backward()
    torch.testing.assert_close(x.grad, got, rtol=0, atol=0)


# (LossConfig fields) per case: OHEM whose k-th smallest gt probability sets
# the threshold (min_kept·frames below the valid pixels, thresh below it),
# class weights alone, and both with thresh setting the threshold
CASES = {
    "ohem": dict(use_ohem=True, ohem_thresh=0.01, ohem_min_kept=200),
    "class_weight": dict(class_weight=tuple(np.random.RandomState(5).uniform(0.5, 1.5, C))),
    "both": dict(use_ohem=True, ohem_thresh=0.15, ohem_min_kept=10,
                 class_weight=tuple(np.random.RandomState(6).uniform(0.5, 1.5, C))),
}


def _clip_inputs(seed: int = 1):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(B, T + 1, H, W, C) * 2).astype(np.float32)
    labels = rng.randint(0, C, (B, T, 4 * H, 4 * W)).astype(np.int32)
    labels[rng.rand(*labels.shape) < 0.05] = 255
    return logits, labels


def _jax_loss(fn, logits, labels, jit: bool = True):
    """(loss_seg, acc_seg, dloss/dlogits) of a JAX clip loss, jitted or eager."""
    def loss(x):
        out = fn(x, jnp.asarray(labels))
        return out["loss_seg"], out["acc_seg"]
    grad_fn = jax.value_and_grad(loss, has_aux=True)
    (val, acc), grad = (jax.jit(grad_fn) if jit else grad_fn)(jnp.asarray(logits))
    return float(val), float(acc), np.asarray(grad)


def _port_loss(fn, logits, labels):
    x = _t(logits).requires_grad_(True)
    out = fn(x, _t(labels))
    out["loss_seg"].backward()
    return out["loss_seg"].item(), out["acc_seg"].item(), x.grad.numpy()


@pytest.mark.parametrize("route", ["pixel", "composed"])
@pytest.mark.parametrize("case", list(CASES))
def test_clip_ce_loss_per_pixel_route_matches_jax(case, route, monkeypatch):
    """The loss to 1e-5 relative and every dlogit to 1e-5 of the largest (f32
    sums over ~10⁴ pixels in other orders); ``acc_seg`` exactly (first-max
    argmax on both sides, no near-ties at these logits). The JAX side runs
    its per-pixel route with the Pallas pair interpreted ("pixel") or its
    composed route on the upsampled logits ("composed")."""
    monkeypatch.setattr(jax_losses, "_FORCE_FUSED", route == "pixel")
    monkeypatch.setattr(jax_ce, "_INTERPRET", True)
    logits, labels = _clip_inputs()
    cfg = CASES[case]
    if cfg.get("use_ohem"):
        # the mask bites: each branch keeps 20-80 % of its valid pixels
        lo, la, bo, bl = losses._split_clip_cases(_t(logits), _t(labels))
        for lg, lb in ((lo, bo), (la, bl)):
            up = ops.resize_bilinear(lg, (4 * H, 4 * W))
            kept = losses.ohem_weight(up, lb, thresh=cfg["ohem_thresh"],
                                      min_kept=cfg["ohem_min_kept"]).sum().item()
            share = kept / ((lb != 255).sum().item())
            assert 0.2 <= share <= 0.8, share
    want = _jax_loss(jax_losses.make_clip_loss(jax_losses.LossConfig(**cfg)), logits, labels,
                     jit=route == "composed")
    got = _port_loss(losses.make_clip_loss(pcfg.LossConfig(**cfg)), logits, labels)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    assert got[1] == pytest.approx(want[1], abs=1e-4)
    _close(got[2], want[2], 1e-5, "dlogits")


def test_per_pixel_route_ignores_labels_outside_the_classes():
    """The port's label rule on the per-pixel route: a label in [C, 255) is
    ignored as 255 is (the JAX per-pixel route would count it as class 0)."""
    logits, labels = _clip_inputs(7)
    odd = np.where(labels == 255, C + 3, labels).astype(np.int32)
    fn = losses.make_clip_loss(pcfg.LossConfig(**CASES["both"]))
    got, want = _port_loss(fn, logits, odd), _port_loss(fn, logits, labels)
    assert got[:2] == want[:2]
    np.testing.assert_array_equal(got[2], want[2])


def test_clip_lovasz_loss_matches_jax():
    """Loss, accuracy and gradient of the Lovász clip loss (f32, 1e-5)."""
    logits, labels = _clip_inputs(2)
    fn = jax_losses.make_clip_loss(jax_losses.LossConfig(type="lovasz", loss_weight=0.7))
    want = _jax_loss(fn, logits, labels)
    got = _port_loss(losses.make_clip_loss(pcfg.LossConfig(type="lovasz", loss_weight=0.7)),
                     logits, labels)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    assert got[1] == pytest.approx(want[1], abs=1e-4)
    _close(got[2], want[2], 1e-5, "dlogits")


@pytest.mark.parametrize("route", ["fused", "composed"])
def test_clip_ce_loss_city_matches_jax(route, monkeypatch):
    """Only the last frame supervised: against the JAX v2 kernels in
    interpret mode and against its composed CE (loss 1e-5, acc exactly,
    gradient 1e-5 of its largest)."""
    monkeypatch.setattr(jax_losses, "_FORCE_FUSED", route == "fused")
    monkeypatch.setattr(jax_ce, "_INTERPRET", True)
    logits, labels = _clip_inputs(3)
    want = _jax_loss(jax_losses.clip_ce_loss_city, logits, labels)
    got = _port_loss(losses.clip_ce_loss_city, logits, labels)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    assert got[1] == pytest.approx(want[1], abs=1e-4)
    _close(got[2], want[2], 1e-5, "dlogits")
    with pytest.raises(ValueError, match="T\\+1"):
        losses.clip_ce_loss_city(_t(logits)[:, :-1], _t(labels))


def test_plain_per_pixel_helpers_match_jax():
    """``cross_entropy`` with class weights, pixel weights and ``avg_factor``;
    ``ohem_weight`` (exactly: the same sort and strict threshold);
    ``lovasz_softmax`` with every class absent but one. The JAX functions are
    jitted (the OHEM settings as traced arguments: one compile)."""
    rng = np.random.RandomState(4)
    logits = rng.randn(3, 6, 5, 9).astype(np.float32)
    labels = rng.randint(0, 9, (3, 6, 5)).astype(np.int32)
    labels[rng.rand(*labels.shape) < 0.2] = 255
    cw = rng.uniform(0.5, 1.5, 9).astype(np.float32)
    pw = rng.rand(3, 6, 5).astype(np.float32)
    jl, jb = jnp.asarray(logits), jnp.asarray(labels)
    np.testing.assert_allclose(
        losses.cross_entropy(_t(logits), _t(labels), class_weight=cw, pixel_weight=_t(pw),
                             avg_factor=17.0).item(),
        float(jax.jit(jax_losses.cross_entropy)(jl, jb, class_weight=jnp.asarray(cw),
                                                pixel_weight=jnp.asarray(pw), avg_factor=17.0)),
        rtol=1e-6)
    ohem = jax.jit(jax_losses.ohem_weight)
    for thresh, min_kept in ((0.3, 5), (0.01, 20), (0.9, 1000)):
        np.testing.assert_array_equal(
            losses.ohem_weight(_t(logits), _t(labels), thresh=thresh, min_kept=min_kept).numpy(),
            np.asarray(ohem(jl, jb, thresh=thresh, min_kept=min_kept)))
    one = np.where(labels == 255, 255, 4).astype(np.int32)
    np.testing.assert_allclose(losses.lovasz_softmax(_t(logits), _t(one)).item(),
                               float(jax.jit(jax_losses.lovasz_softmax)(jl, jnp.asarray(one))),
                               rtol=1e-6)
