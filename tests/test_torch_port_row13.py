"""PyTorch port, on the CPU: the plan of row 13's own kernel, the per-pixel
upsampled-CE backward (``csrc/ce_nll_bwd.cu``, ``ce_upsampled.ce_nll_bwd_plan``
/ ``ce_nll_bwd_units``).

- At ragged maps (37×53, 13×7, ...) and s 2, 3, 4, 8: every source pixel is
  written by exactly one unit, and every output row and column whose
  bilinear share reaches a unit's rows or columns lies in the unit's output
  range (so no share is lost); the strips and segments split their sides
  evenly; the block's shared memory (``ce_nll_bwd_smem``) fits 3 an SM.
- ``ce_bwd_exps(pixel=True)`` at the "ohem" step's N 8 and N 2 with half the
  pixels' cotangent 0: C × the live pixels each unit computes, counted unit
  by unit.
- The decomposition's replay against the JAX ``_ce_bwd_pallas`` in interpret
  mode at s 8 (s 2 and 4: ``test_torch_port_row17.py``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch_port_common import col_shares, nll_replay_case, row_shares

from vss_cffm_tpu_torch.ops import ce_upsampled as ce
from vss_cffm_tpu_torch.ops._dispatch import SMEM_LIMIT

PLAN_CASES = [(37, 53, 124, 4, 8), (37, 53, 19, 2, 2), (37, 53, 150, 8, 1), (13, 7, 40, 4, 3),
              (5, 2, 124, 2, 1), (120, 120, 124, 4, 8), (120, 120, 124, 4, 2), (2, 31, 7, 8, 1),
              (11, 13, 256, 3, 2), (9, 10, 40, 1, 2)]


@pytest.mark.parametrize("h,w,c,s,n", PLAN_CASES)
def test_nll_bwd_units_cover_every_share_once(h, w, c, s, n):
    plan = ce.ce_nll_bwd_plan(n, h, w, c, s, 132)
    tw, nseg = plan
    assert 1 <= tw <= ce.ce_nll_bwd_strip_max(c) and s * (tw + 1) <= 128 and 1 <= nseg <= h
    smem = ce.ce_nll_bwd_smem(c, s, tw)
    assert smem <= 200 * 1024 and 3 * (smem + 1024) <= SMEM_LIMIT
    units = ce.ce_nll_bwd_units(n, h, w, s, plan)
    assert len(units) == n * nseg * -(-w // tw)
    owner = np.zeros((n, h, w), np.int32)
    for f, k_lo, k_hi, v0, v1, ya, yb, xa, xb in units:
        assert 1 <= v1 - v0 <= tw and k_hi - k_lo in (h // nseg, -(-h // nseg))
        owner[f, k_lo:k_hi, v0:v1] += 1
        if f > 0:  # every frame's units are frame 0's
            continue
        for y in range(h * s):
            if any(wt != 0 and k_lo <= r < k_hi for r, wt in row_shares(y, s, h)):
                assert ya <= y < yb, (y, ya, yb)
        for x in range(w * s):
            if any(wt != 0 and v0 <= col < v1 for col, wt in col_shares(x, s, w)):
                assert xa <= x < xb, (x, xa, xb)
        assert 0 <= ya < yb <= h * s and 0 <= xa < xb <= w * s and xb - xa <= s * (tw + 1)
    assert (owner == 1).all()


def test_nll_bwd_exps_count_each_unit_s_live_pixels():
    """At N 8 and N 2 (480², C 124, s 4), half the cotangent 0: the count is
    C × each unit's live pixels, summed unit by unit, and at most 1.4 × C ×
    the live pixels (the halo rows and columns)."""
    rng = np.random.RandomState(3)
    for n in (8, 2):
        live = torch.from_numpy(rng.rand(n, 480, 480) < 0.5)
        plan = ce.ce_nll_bwd_plan(n, 120, 120, 124, 4, 132)
        got = ce.ce_bwd_exps(live, 124, 4, plan, True)
        want = 124 * sum(int(live[f, ya:yb, xa:xb].sum())
                         for f, _, _, _, _, ya, yb, xa, xb in ce.ce_nll_bwd_units(
                             n, 120, 120, 4, plan))
        assert got == want
        assert 1.0 < got / (124 * int(live.sum())) <= 1.4


@pytest.mark.parametrize("pattern", ["units", "half", "none"])
def test_replay_at_s8_matches_the_per_pixel_backward_pallas_interpret(pattern):
    nll_replay_case(8, pattern)
