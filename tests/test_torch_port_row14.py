"""PyTorch port, on the CPU: the plan of the redesigned upsampled-CE forward
(row 14, ``ce_upsampled_loss``, and row 12, ``ce_upsampled_nll``, on one
template).

- ``ce_upsampled.ce_fwd_plan`` / ``ce_fwd_units``: at ragged maps (7×11,
  37×53, ...), s 2, 4, 8 and N 1, 2, 8, every output pixel belongs to exactly
  one unit (the forward has no halo: recompute factor 1), and a band is one
  output row a lane group; the train step's N 2 fills the card.
- A plain-torch replay of that decomposition (each unit's pixels from the
  kernel's lerps, row then column, in f32; the loss as per-unit (img_w · sum,
  count) partials summed in unit order; the maps written unit by unit)
  against the JAX ``_ce_fwd_loss_pallas`` and ``_ce_fwd_pallas`` in
  interpret mode and against the port's plain versions: wsum, nll and lse to
  1e-5 relative (the same terms rounded and summed in other orders), corr and
  pred exactly (random logits leave no ties).
- Ties built from equal bf16 logits pick the first maximum, as JAX does.
- int32 labels past 255 and below 0 stay ignored (row 14) or become class 0
  (row 12), as in the JAX kernels.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import pixel_stats, replay_loss

from vss_cffm_tpu.ops import ce_upsampled as jax_ce
from vss_cffm_tpu_torch.ops import ce_upsampled as ce
from vss_cffm_tpu_torch.ops._dispatch import SMEM_LIMIT


def replay_nll(logits, labels, s, plan):
    """(nll, pred, lse) maps, written unit by unit; pred the first maximum."""
    n, h, w, c = logits.shape
    up, m, lse, _, picked = pixel_stats(logits, labels, s)
    first = torch.where(up == m[..., None], torch.arange(c), c).amin(dim=-1).int()
    out = [torch.full(labels.shape, float("nan")), torch.full(labels.shape, -1, dtype=torch.int32),
           torch.full(labels.shape, float("nan"))]
    for f, y0, y1, v0, v1 in ce.ce_fwd_units(n, h, w, c, s, plan):
        sl = (f, slice(y0, y1), slice(s * v0, s * v1))
        for o, src in zip(out, (lse - picked, first, lse)):
            o[sl] = src[sl]
    assert all(bool((o == o).all()) for o in out) and (out[1] >= 0).all()
    return tuple(out)


PLAN_CASES = [(7, 11, 124, 4, 1), (37, 53, 124, 4, 2), (37, 53, 19, 2, 8), (37, 53, 150, 8, 1),
              (7, 11, 256, 2, 2), (13, 7, 40, 8, 2), (1, 1, 3, 1, 1), (120, 120, 124, 4, 8),
              (120, 120, 124, 4, 2)]


@pytest.mark.parametrize("h,w,c,s,n", PLAN_CASES)
def test_ce_fwd_units_cover_every_output_pixel_once(h, w, c, s, n):
    tw, band = plan = ce.ce_fwd_plan(n, h, w, c, s, 132)
    assert 1 <= tw <= ce._CE_FWD_STRIPS[0] and band == 32 // ce.ce_bwd_groups(c)[0]
    # a block's shared memory within the kernel's limit, the maps' above the loss's
    assert ce.ce_fwd_smem(c, s, tw, False) < ce.ce_fwd_smem(c, s, tw) <= ce._CE_FWD_SMEM
    assert ce._CE_FWD_SMEM <= SMEM_LIMIT
    seen = np.zeros((n, h * s, w * s), np.int32)
    units = ce.ce_fwd_units(n, h, w, c, s, plan)
    for f, y0, y1, v0, v1 in units:
        assert 0 < y1 - y0 <= band and 0 < v1 - v0 <= tw and y0 % band == 0
        seen[f, y0:y1, s * v0:s * v1] += 1
    assert (seen == 1).all()
    assert len(units) == n * -(-h * s // band) * -(-w // tw)


def test_ce_fwd_plan_fills_the_card_at_the_train_step():
    """N 2 (the clip's last frames) gives at least 4 warps an SM of 132."""
    for n in (2, 8):
        tw, band = ce.ce_fwd_plan(n, 120, 120, 124, 4, 132)
        assert band == 4 and len(ce.ce_fwd_units(n, 120, 120, 124, 4, (tw, band))) >= 132 * 4


def _inputs(n, h, w, c, s, seed, ldt=np.uint8):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(n, h, w, c) * 2).astype(np.float32)
    labels = rng.randint(0, c, (n, h * s, w * s)).astype(ldt)
    labels[rng.rand(*labels.shape) < 0.1] = 255
    return logits, labels


def _plans(n, h, w, c, s):
    """The card's plan, and strips of 3 and 1 columns (ragged last strips)."""
    band = 32 // ce.ce_bwd_groups(c)[0]
    return [ce.ce_fwd_plan(n, h, w, c, s, 132), (3, band), (1, band)]


def _rel(got, want, rel=1e-5):
    g, w_ = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert g.shape == w_.shape
    err = np.abs(g - w_).max()
    assert err <= rel * np.abs(w_).max(), (err, np.abs(w_).max())


def _jax_loss(logits, labels, s, img_w, count_acc=True):
    wsum, corr = jax_ce._ce_fwd_loss_pallas(
        jnp.asarray(logits), jax_ce.labels_to_phase(jnp.asarray(labels), s), s, img_w,
        count_acc=count_acc, interpret=True)
    return float(wsum), float(corr)


def _jax_nll(logits, labels, s):
    out = jax_ce._ce_fwd_pallas(jnp.asarray(logits), jax_ce.labels_to_phase(jnp.asarray(labels), s),
                                s, interpret=True)
    return [np.asarray(jax_ce.phase_to_natural(o, s)) for o in out]


def test_replay_matches_the_loss_forward_pallas_interpret():
    """Row 14's decomposition against ``_ce_fwd_loss_pallas`` and the port's
    plain loss, at a ragged 6×10 map (strips of 3 and 1: ragged last strips)."""
    n, h, w, c, s = 2, 6, 10, 19, 4
    logits, labels = _inputs(n, h, w, c, s, 1)
    img_w = 0.5 / labels.size
    want = _jax_loss(logits, labels, s, img_w)
    x, lab = torch.from_numpy(logits), torch.from_numpy(labels)
    plain = ce.ce_upsampled_loss_torch(x, lab, s, img_w)
    for plan in _plans(n, h, w, c, s):
        wsum, corr = replay_loss(x, lab, s, img_w, plan)
        _rel(wsum, want[0])
        _rel(wsum, plain[0])
        assert float(corr) == want[1] == float(plain[1])
        assert float(replay_loss(x, lab, s, img_w, plan, count_acc=False)[1]) == 0.0


def test_replay_matches_the_per_pixel_forward_pallas_interpret():
    """Row 12's decomposition against ``_ce_fwd_pallas`` and the port's plain
    maps: nll and lse to 1e-5 of the largest, pred equal everywhere."""
    n, h, w, c, s = 1, 6, 10, 19, 4
    logits, labels = _inputs(n, h, w, c, s, 2)
    want = _jax_nll(logits, labels, s)
    x, lab = torch.from_numpy(logits), torch.from_numpy(labels)
    plain = ce.ce_upsampled_nll_torch(x, lab, s)
    for plan in _plans(n, h, w, c, s):
        got = replay_nll(x, lab, s, plan)
        for i in (0, 2):
            _rel(got[i], want[i])
            _rel(got[i], plain[i])
        assert np.array_equal(got[1].numpy(), want[1]) and torch.equal(got[1], plain[1])


@pytest.mark.parametrize("s", [2, 8])
def test_replay_matches_the_plain_forward_at_ragged_maps(s):
    """At 7×11 (ragged bands and strips), C 40, s 2 and 8: both rows'
    decompositions against the port's plain versions."""
    n, h, w, c = 2, 7, 11, 40
    logits, labels = _inputs(n, h, w, c, s, 3 + s)
    x, lab = torch.from_numpy(logits), torch.from_numpy(labels)
    img_w = 1.0 / labels.size
    loss = ce.ce_upsampled_loss_torch(x, lab, s, img_w)
    maps = ce.ce_upsampled_nll_torch(x, lab, s)
    for plan in _plans(n, h, w, c, s):
        wsum, corr = replay_loss(x, lab, s, img_w, plan)
        _rel(wsum, loss[0])
        assert float(corr) == float(loss[1])
        got = replay_nll(x, lab, s, plan)
        _rel(got[0], maps[0])
        _rel(got[2], maps[2])
        assert torch.equal(got[1], maps[1])


def test_ties_of_equal_bf16_logits_pick_the_first_maximum():
    """Classes 3 and 17 (in different lanes at 16 classes a lane, C 40: the
    group's min) and 5 (in 3's lane) share their bf16 logits and lead every
    pixel: pred is 3 everywhere, in JAX, the plain maps and the replay; the
    correct count takes a label of any of them."""
    n, h, w, c, s = 1, 5, 6, 40, 2
    logits, labels = _inputs(n, h, w, c, s, 9)
    lead = np.asarray(torch.from_numpy(logits[..., 3] + 12.0).bfloat16().float())
    for k in (3, 5, 17):
        logits[..., k] = lead
    labels[..., :4] = 5
    labels[..., 4:6] = 17
    logits = np.asarray(torch.from_numpy(logits).bfloat16().float())
    x, lab = torch.from_numpy(logits), torch.from_numpy(labels)
    want = _jax_nll(logits, labels, s)
    got = replay_nll(x, lab, s, _plans(n, h, w, c, s)[0])
    plain = ce.ce_upsampled_nll_torch(x, lab, s)
    assert (want[1] == 3).all() and (got[1] == 3).all() and (plain[1] == 3).all()
    img_w = 1.0 / labels.size
    valid = int((labels < c).sum())
    corr = replay_loss(x, lab, s, img_w, _plans(n, h, w, c, s)[1])[1]
    assert float(corr) >= int(((labels == 5) | (labels == 17)).sum()) and float(corr) <= valid
    assert float(corr) == float(ce.ce_upsampled_loss_torch(x, lab, s, img_w)[1])


def test_int32_labels_past_255_and_below_0():
    """Row 14 ignores them, row 12 takes class 0 for them, in JAX and in the
    replay (the kernels read int32 labels as they are)."""
    n, h, w, c, s = 1, 6, 5, 19, 2
    logits, labels = _inputs(n, h, w, c, s, 4, ldt=np.int32)
    rng = np.random.RandomState(5)
    labels[rng.rand(*labels.shape) < 0.1] = 300
    labels[rng.rand(*labels.shape) < 0.1] = -7
    labels[rng.rand(*labels.shape) < 0.05] = c
    x, lab = torch.from_numpy(logits), torch.from_numpy(labels)
    img_w = 1.0 / labels.size
    plan = _plans(n, h, w, c, s)[0]
    wsum, corr = replay_loss(x, lab, s, img_w, plan)
    inside = np.where((labels >= 0) & (labels < c), labels, 255).astype(np.uint8)
    want = _jax_loss(logits, labels, s, img_w)
    _rel(wsum, want[0])
    assert float(corr) == want[1]
    # the same as ignoring them outright
    _rel(wsum, replay_loss(x, torch.from_numpy(inside), s, img_w, plan)[0])
    got = replay_nll(x, lab, s, plan)
    ref = _jax_nll(logits, labels, s)
    for i in (0, 2):
        _rel(got[i], ref[i])
    assert np.array_equal(got[1].numpy(), ref[1])
    zero = torch.from_numpy(np.where((labels >= 0) & (labels < c), labels, 0))
    assert torch.equal(got[0], replay_nll(x, zero, s, plan)[0])
