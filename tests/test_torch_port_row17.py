"""PyTorch port, on the CPU: the plans of the redesigned upsampled-CE backwards
(row 17, and row 13's own kernel) and MiT-block GEMM (``block_gemm``, rows 1
and 6-11).

- ``ce_upsampled.ce_bwd_plan`` / ``ce_bwd_units``: at ragged maps (37×53,
  13×7, ...) and s 2, 4, 8, every output row belongs to one segment, every
  (output pixel → source pixel) share of the upsample's adjoint is added by
  exactly one unit, and every source pixel is written once, either by its
  unit or as the sum of exactly two partials, the upper segment's first.
- The lane groups of a unit walk in lockstep: the columns they flush into
  the unit's shared rows in any one step are distinct (a replay of the
  kernel's window arithmetic), so no share is lost to a race.
- A plain-torch replay of that decomposition (units, column windows with the
  edge shares, rows written whole or as partials, the combine pass) against
  the JAX ``_ce_bwd_loss_pallas5`` in interpret mode, and against the port's
  plain backward at s 2 and 8; row 13's (``ce_nll_bwd_units``: each unit
  writes its own source pixels from its output rows and columns and their
  halo) against the JAX ``_ce_bwd_pallas`` in interpret mode and the port's
  plain backward at ragged maps, s 2 and 4 (s 8 in
  ``test_torch_port_row13.py``), with cotangents zero on whole units, on a
  scattered half and nowhere: f32, 1e-5 of the largest value (the same terms
  summed in another order).
- The recompute factor at the train step's shapes: at most 1.2 for row 17,
  1.4 for row 13 (its halo rows and columns).
- ``stage_block.block_gemm_plan`` at every launch shape of the B0 and B1
  inference and train paths: shared memory within the card's 227 KB, N
  covered by whole slabs, and no resident A deeper than its 512 columns (the
  wrapper refuses one).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch_port_common import (ce_bwd_plans, ce_inputs, ce_nll_bwd_plans, close_to_largest,
                               col_shares, nll_replay_case, phase_coeff, replay, replay_nll,
                               row_shares, unit_rows)

from vss_cffm_tpu.ops import ce_upsampled as jax_ce
from vss_cffm_tpu_torch.ops import ce_upsampled as ce
from vss_cffm_tpu_torch.ops import stage_block as sb
from vss_cffm_tpu_torch.ops._dispatch import SMEM_LIMIT


PLAN_CASES = [(37, 53, 124, 4, 8), (37, 53, 19, 2, 2), (37, 53, 150, 8, 1), (13, 7, 40, 4, 3),
              (5, 2, 124, 2, 1), (120, 120, 124, 4, 8), (120, 120, 124, 4, 2), (2, 31, 7, 8, 1)]


@pytest.mark.parametrize("h,w,c,s,n", PLAN_CASES)
def test_ce_bwd_plan_adds_every_share_once(h, w, c, s, n):
    """Each (output row, output column → source column) share is added by one
    unit; each source pixel is written once whole or from two partials of one
    segment boundary, upper segment first."""
    plan = ce.ce_bwd_plan(n, h, w, c, s, 132)
    tw, nseg, cs = plan
    g, cpl = ce.ce_bwd_groups(c)
    assert cs >= g * cpl and (nseg == 1 or h // nseg >= 2)
    hh, ww = h * s, w * s
    for f0 in range(n):
        units = [u for u in ce.ce_bwd_units(n, h, w, c, s, plan) if u[0] == f0]
        # every output row in one segment, every segment over every strip
        owner = np.zeros((hh, w), np.int32)
        whole = np.zeros((h, w), np.int32)
        parts: dict = {}
        col_share = np.zeros((ww, w), np.int32)
        for _, k_lo, k_hi, v0, v1, xa, xb, run in units:
            assert run % s == 0 and run >= 2 * s and (32 // g) * run >= xb - xa
            owner[s * k_lo:s * k_hi, v0:v1] += 1
            if k_lo == 0:  # one segment row: the column shares of each strip
                for x in range(xa, xb):
                    for col, wt in col_shares(x, s, w):
                        if v0 <= col < v1 and wt != 0:
                            col_share[x, col] += 1
            rows, top, bottom = unit_rows(k_lo, k_hi, h)
            whole[rows, v0:v1] += 1
            for side, b, rs in ((1, k_lo, top), (0, k_hi, bottom)):
                for r in rs:
                    parts.setdefault((r, b), []).append((side, v0, v1))
            # the output rows' row shares land in the unit's rows
            for y in range(s * k_lo, s * k_hi):
                for r, wt in row_shares(y, s, h):
                    assert wt == 0 or max(k_lo - 1, 0) <= r <= min(k_hi, h - 1)
        assert (owner == 1).all()
        # every nonzero column share of every output column added exactly once
        need = np.zeros((ww, w), np.int32)
        for x in range(ww):
            for col, wt in col_shares(x, s, w):
                need[x, col] = int(wt != 0)
        assert (col_share == need).all()
        # a source pixel: whole once, or the two partials of one boundary
        part_count = np.zeros((h, w), np.int32)
        for (r, b), lst in parts.items():
            assert b - 1 <= r <= b
            for v in range(w):
                sides = [side for side, v0, v1 in lst if v0 <= v < v1]
                assert sorted(sides) == [0, 1], (r, b, v, sides)
                part_count[r, v] += 1
        assert ((whole == 1) ^ (part_count == 1)).all() and (whole + part_count == 1).all()


def _lockstep_flushes(unit, c: int, s: int, w: int) -> list[list[int]]:
    """The columns the unit's lane groups flush into its shared rows, step by
    step (the kernel's window arithmetic: slides in the loop, then the last
    two columns, even groups, then odd ones)."""
    _, _, _, v0, v1, xa, xb, run = unit
    ng = 32 // ce.ce_bwd_groups(c)[0]
    W = w * s
    groups = []
    for gi in range(ng):
        xg = xa + gi * run
        v, pw = divmod(min(xg, W - 1), s)
        groups.append(dict(x=xg, v=v, pw=pw, wc=v + phase_coeff(pw, s)[0], active=xg < xb))
    steps = []
    for jx in range(run):
        step = []
        for gr in groups:
            vn, pwn = gr["v"], gr["pw"] + 1
            if pwn == s:
                vn, pwn = vn + 1, 0
            more = jx + 1 < run and gr["x"] + 1 < W
            if more and vn + phase_coeff(pwn, s)[0] > gr["wc"]:
                if gr["active"] and v0 <= gr["wc"] < v1:
                    step.append(gr["wc"])
                gr["wc"] += 1
            gr["v"], gr["pw"], gr["x"] = vn, pwn, gr["x"] + 1
        steps.append(step)
    for par in (0, 1):
        steps.append([col for gi, gr in enumerate(groups) if gi % 2 == par and gr["active"]
                      for col in (gr["wc"], gr["wc"] + 1) if v0 <= col < v1])
    return steps


@pytest.mark.parametrize("h,w,c,s,n", PLAN_CASES)
def test_ce_bwd_lane_groups_never_flush_one_column_at_once(h, w, c, s, n):
    plan = ce.ce_bwd_plan(n, h, w, c, s, 132)
    for unit in ce.ce_bwd_units(1, h, w, c, s, plan):
        for step in _lockstep_flushes(unit, c, s, w):
            assert len(step) == len(set(step)), (unit, step)


def test_replay_matches_the_loss_backward_pallas_interpret():
    """Row 17's decomposition against ``_ce_bwd_loss_pallas5`` (f32)."""
    n, h, w, c, s = 1, 6, 10, 19, 4
    logits, labels, _ = ce_inputs(n, h, w, c, s, 1)
    img_w, g = 1.0 / labels.size, 1.3
    want = np.asarray(jax_ce._ce_bwd_loss_pallas5(
        jnp.asarray(logits), jax_ce.labels_to_phase_w(jnp.asarray(labels), s),
        jnp.asarray(g, jnp.float32), s, c, img_w, interpret=True))
    for plan in ce_bwd_plans(n, h, w, c, s):
        close_to_largest(replay(torch.from_numpy(logits), torch.from_numpy(labels), s, plan, g=g,
                      img_w=img_w), want)


@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("pattern", ["units", "half", "none"])
def test_replay_matches_the_per_pixel_backward_pallas_interpret(s, pattern):
    """``nll_replay_case`` at s 2 and 4 (s 8: ``test_torch_port_row13.py``)."""
    nll_replay_case(s, pattern)


@pytest.mark.parametrize("s", [2, 8])
def test_replay_matches_the_plain_backward_at_ragged_maps(s):
    """At 13×11 (ragged strips and segments) and s 2, 8: the decompositions
    of both rows against the port's plain backwards in f32."""
    n, h, w, c = 2, 13, 11, 23
    logits, labels, rng = ce_inputs(n, h, w, c, s, 3 + s)
    x, lab = torch.from_numpy(logits), torch.from_numpy(labels)
    img_w = 0.5 / labels.size
    want17 = ce._loss_bwd_f32(x, lab, torch.tensor(0.9), s, img_w)
    lse = torch.logsumexp(F.interpolate(x.permute(0, 3, 1, 2), size=lab.shape[1:],
                                        mode="bilinear", align_corners=False), dim=1)
    g = torch.from_numpy(rng.randn(*labels.shape).astype(np.float32))
    want13 = ce.ce_upsampled_nll_bwd_torch(x, lab, lse, g, s)
    for plan in ce_bwd_plans(n, h, w, c, s):
        close_to_largest(replay(x, lab, s, plan, g=0.9, img_w=img_w), want17)
    for plan in ce_nll_bwd_plans(n, h, w, c, s):
        close_to_largest(replay_nll(x, lab, s, plan, g=g, lse=lse), want13)


def test_recompute_factor_at_the_train_step():
    """Exps executed over C × the pixels that need them at N 8 and N 2: row
    17 ≤ 1.2 (it counts every pixel of its lane groups' runs, ignored ones
    too), row 13 ≤ 1.4 (its units' halo rows and columns; pixels with g = 0
    cost none)."""
    rng = np.random.RandomState(0)
    for n in (8, 2):
        lab = torch.from_numpy(rng.randint(0, 124, (n, 480, 480)).astype(np.uint8))
        lab[torch.from_numpy(rng.rand(n, 480, 480) < 0.05)] = 255
        valid = lab.long() < 124
        f17 = ce.ce_bwd_exps(lab, 124, 4, ce.ce_bwd_plan(n, 120, 120, 124, 4, 132), False) / (
            124 * int(valid.sum()))
        f13 = ce.ce_bwd_exps(valid, 124, 4, ce.ce_nll_bwd_plan(n, 120, 120, 124, 4, 132),
                             True) / (124 * int(valid.sum()))
        assert 1.0 <= f17 <= 1.2 and 1.0 <= f13 <= 1.4, (n, f13, f17)


def _gemm_launches(variant: str, frames: int, train: bool):
    """(M, N, K, resident) of every block_gemm launch of a MiT variant's
    block pairs (stages 1-3) and inference blocks (stages 2-3) and fused
    FFNs (stages 1, 4) at 480²."""
    widths = {"b0": (32, 64, 160, 256), "b1": (64, 128, 320, 512)}[variant]
    out = []
    for stage, c in enumerate(widths):
        hw = (120 >> stage) ** 2
        m, ch = frames * hw, 4 * c
        out += [(m, c, c, True), (m, c, c, False), (m, ch, c, True), (m, c, ch, False)]
        if train:
            out += [(m, ch, c, True), (m, c, ch, False), (m, c, c, False)]
    return out


@pytest.mark.parametrize("variant", ["b0", "b1"])
def test_block_gemm_plan_at_every_launch_shape(variant):
    for frames, train in ((4, False), (8, True), (2, True)):
        for m, n, k, res in _gemm_launches(variant, frames, train):
            assert not res or k <= sb.GEMM_KMAX_RES
            for sms in (132, 114, 8):
                nb, cols = sb.block_gemm_plan(m, n, k, res, sms)
                assert nb in (1, 2) and (nb == 2 or n <= 64)
                assert cols % (64 * nb) == 0 and cols >= 64 * nb
                runs = -(-n // cols)
                assert (runs - 1) * cols < n <= runs * cols   # N covered, no empty run
                assert sb.block_gemm_smem(k, res, nb) + 1024 <= SMEM_LIMIT


def test_block_gemm_refuses_a_resident_a_past_512_columns():
    a = torch.zeros(64, 1024, dtype=torch.bfloat16)
    w = torch.zeros(1024, 64, dtype=torch.bfloat16)
    ln = (torch.ones(1024), torch.zeros(1024), 1e-6)
    with pytest.raises(ValueError, match="512"):
        sb._gemm(a, w, None, out_dtype=torch.float32, ln=ln)
    with pytest.raises(ValueError, match="512"):
        sb._gemm(a, w, None, out_dtype=torch.float32, a_scale=torch.ones(1), rows_per_frame=64)
