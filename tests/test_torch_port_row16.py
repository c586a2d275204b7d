"""PyTorch port, on the CPU: rows 16 and 18 (the CE microbench's phase-layout
forwards ``ce_fwd_loss_v5`` / ``ce_fwd_loss_v3``) on the loss forward's kernel
(``csrc/ce_upsampled.cu`` ``ce_fwd_kernel``, row 14's template).

- The kernel stages each unit's labels band row by band row, at the row base
  of the row's (k, ph) plus each column's offset, the rows of a frame's
  ragged last band clamped to its last row. Replayed unit by unit, that read
  is ``ce_label_index("w-major")`` at every output pixel and gathers the
  natural labels, at ragged maps, s 1-8 and the card's plan and forced ones.
- Row 14's plain-torch replay of the decomposition, fed w-major labels
  gathered through that index, against the JAX ``_ce_fwd_loss_pallas5`` (s 2
  and 4) and ``_ce_fwd_loss_pallas3`` (s 3 with the runtime loop's f32
  coefficients, and s 4) in interpret mode, and against the port's plain
  versions: wsum to 1e-5 relative (the same terms rounded and summed in other
  orders), corr exactly.
- Where the two coefficient rules agree (s 1, 2, 4, 8), the replay of rows 16
  and 18 on the gathered labels is row 14's on the natural labels bit for
  bit: the CPU twin of the card test that pins the shared code. At s 3 row
  18's coefficients differ from row 14's at one phase.
"""

from __future__ import annotations

import jax.numpy as jnp
import pytest
import torch
from torch_port_common import ce_inputs, close_to_largest, phase_table, replay_loss

from vss_cffm_tpu.ops import ce_upsampled as jax_ce
from vss_cffm_tpu_torch.ops import ce_upsampled as ce


def _fwd_plans(n, h, w, c, s):
    """The card's plan and strips of 3 columns (a ragged last strip at w 10)."""
    band = 32 // ce.ce_bwd_groups(c)[0]
    return [ce.ce_fwd_plan(n, h, w, c, s, 132), (3, band)]


def staged_label_index(n, h, w, c, s, plan) -> torch.Tensor:
    """int64 (N, H, W): where the kernel's staging loop reads each output
    pixel's label in flat w-major labels, unit by unit: band row g at output
    row y0 + min(g, live − 1), its base ((n·h + k)·w)·s² + ph·s; strip column
    i = lane + 32·t at (v0 + q)·s² + r, each lane's (q, r) = (i // s, i % s)
    stepped by (32 // s, 32 % s) with a carry, as the kernel steps them."""
    _, band = plan
    idx = torch.full((n, h * s, w * s), -1, dtype=torch.long)
    lane = torch.arange(32)
    for f, y0, y1, v0, v1 in ce.ce_fwd_units(n, h, w, c, s, plan):
        cnt = s * (v1 - v0)
        for g in range(band):
            y = y0 + min(g, y1 - y0 - 1)
            base = (f * h + y // s) * w * s * s + (y % s) * s
            q, r = lane // s, lane % s
            for i in range(0, cnt, 32):
                live = lane + i < cnt
                idx[f, y, s * v0 + (lane + i)[live]] = base + ((v0 + q) * s * s + r)[live]
                q, r = q + 32 // s, r + 32 % s
                q, r = torch.where(r >= s, q + 1, q), torch.where(r >= s, r - s, r)
    return idx


@pytest.mark.parametrize("n,h,w,c", [(1, 7, 11, 19), (2, 13, 5, 124)])
def test_staged_labels_are_the_natural_labels(n, h, w, c):
    rng = torch.Generator().manual_seed(h * w)
    for s in range(1, 9):
        lab = torch.randint(0, 256, (n, h * s, w * s), generator=rng, dtype=torch.uint8)
        phw = ce.labels_to_phase_w(lab, s).contiguous().reshape(-1)
        want = ce.ce_label_index("w-major", n, h, w, s)
        for plan in _fwd_plans(n, h, w, c, s) + [(1, 32 // ce.ce_bwd_groups(c)[0])]:
            idx = staged_label_index(n, h, w, c, s, plan)
            assert torch.equal(idx, want), (s, plan)
            assert torch.equal(phw[idx], lab), (s, plan)


def _case(s, seed):
    """1×6×10 at C 19, natural labels with ~10 % ignored, the same labels
    w-major, and those gathered back through the kernel's index."""
    n, h, w, c = 1, 6, 10, 19
    logits, labels, _ = ce_inputs(n, h, w, c, s, seed)
    lab = torch.from_numpy(labels)
    phw = ce.labels_to_phase_w(lab, s).contiguous()
    gathered = phw.reshape(-1)[ce.ce_label_index("w-major", n, h, w, s)]
    return (n, h, w, c), logits, lab, phw, gathered, 0.5 / labels.size


def _check(jax_fn, port_op, s, loop, seed):
    (n, h, w, c), logits, lab, phw, gathered, img_w = _case(s, seed)
    want = [float(v) for v in jax_fn(jnp.asarray(logits), jnp.asarray(phw.numpy()), s, img_w,
                                     interpret=True)]
    x = torch.from_numpy(logits)
    plain = port_op(x, phw, s, img_w, force="torch")
    assert torch.equal(gathered, lab)
    for plan in _fwd_plans(n, h, w, c, s):
        wsum, corr = replay_loss(x, gathered, s, img_w, plan, loop=loop)
        close_to_largest(wsum, want[0])
        close_to_largest(wsum, plain[0])
        assert float(corr) == want[1] == float(plain[1])


@pytest.mark.parametrize("s", [2, 4])
def test_replay_matches_row16_pallas_interpret(s):
    """Row 16: w-major labels, the double coefficients, against
    ``_ce_fwd_loss_pallas5``."""
    _check(jax_ce._ce_fwd_loss_pallas5, ce.ce_fwd_loss_v5, s, False, 20 + s)


@pytest.mark.parametrize("s", [3, 4])
def test_replay_matches_row18_pallas_interpret(s):
    """Row 18: w-major labels, the runtime loop's f32 coefficients, against
    ``_ce_fwd_loss_pallas3``."""
    _check(jax_ce._ce_fwd_loss_pallas3, ce.ce_fwd_loss_v3, s, True, 30 + s)


@pytest.mark.parametrize("s", [1, 2, 3, 4, 8])
def test_rows_16_18_replay_is_row14s_bit_for_bit(s):
    """At the same plan, rows 16 (s 2, 4) and 18 (s 1-8) give row 14's
    (wsum, corr) bit for bit wherever their coefficients are row 14's; at s 3
    row 18's table differs from row 14's in f alone and the loss stays
    within 1e-5."""
    (n, h, w, c), logits, lab, _, gathered, img_w = _case(s, 40 + s)
    x = torch.from_numpy(logits)
    plan = _fwd_plans(n, h, w, c, s)[1]
    row14 = replay_loss(x, lab, s, img_w, plan)
    rows = {18: replay_loss(x, gathered, s, img_w, plan, loop=True)}
    if s in (2, 4):
        rows[16] = replay_loss(x, gathered, s, img_w, plan)
    for row, got in rows.items():
        if s == 3 and row == 18:
            loop, double = phase_table(h * s, s, h, True), phase_table(h * s, s, h)
            assert torch.equal(loop[0], double[0]) and torch.equal(loop[1], double[1])
            assert not torch.equal(loop[2], double[2])
            close_to_largest(got[0], row14[0])
        else:
            assert torch.equal(got[0], row14[0]) and torch.equal(got[1], row14[1]), row
