"""PyTorch port, on the CPU: rows 15 and 19 (the CE microbench's phase-layout
backwards ``ce_bwd_loss_v2`` / ``ce_bwd_loss_v3``) on the loss backward's
kernel (``csrc/ce_upsampled.cu`` ``ce_bwd_kernel``, row 17's template).

- ``ce_upsampled.ce_label_index`` (where the kernel reads each output
  pixel's label: a row base plus a column offset) gathers from flat h-major
  and w-major labels exactly the natural labels that ``phase_to_natural``
  gives, at ragged maps, s 1-8 and N 1-2.
- Row 17's plain-torch replay of the kernel's decomposition, fed labels
  gathered through that index, against the JAX ``_ce_bwd_loss_pallas``
  (h-major) and ``_ce_bwd_loss_pallas3`` (w-major) in interpret mode: f32,
  1e-5 of the largest value (the same terms summed in another order).
- The shared-memory fill of the phase coefficients for row 19
  (``ce_bwd_coeffs(s, loop=True)``) equals the JAX ``_phase_coeff_dyn`` bit
  for bit at s 1-8, and differs from the double rule of rows 15 and 17 at
  s 3 by one f32 ulp, where f32 arithmetic says it must.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import (ce_bwd_plans, ce_inputs, close_to_largest, phase_coeff,
                               replay)

from vss_cffm_tpu.ops import ce_upsampled as jax_ce
from vss_cffm_tpu_torch.ops import ce_upsampled as ce

LAYOUTS = {"natural": lambda lab, s: lab, "h-major": ce.labels_to_phase,
           "w-major": ce.labels_to_phase_w}


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("n,h,w", [(1, 7, 11), (2, 13, 5)])
def test_label_index_gathers_the_natural_labels(layout, n, h, w):
    rng = np.random.RandomState(h * w)
    for s in range(1, 9):
        lab = torch.from_numpy(rng.randint(0, 256, (n, h * s, w * s)).astype(np.uint8))
        laid = LAYOUTS[layout](lab, s).contiguous()
        idx = ce.ce_label_index(layout, n, h, w, s)
        # one read per output pixel, each element of the layout read once
        assert idx.shape == lab.shape
        assert torch.equal(torch.sort(idx.reshape(-1)).values, torch.arange(laid.numel()))
        want = lab if layout == "natural" else ce.phase_to_natural(
            laid.transpose(2, 3) if layout == "w-major" else laid, s)
        assert torch.equal(laid.reshape(-1)[idx], want), (layout, s)


def _phase_case(seed):
    """A small shape with h even, as the TPU backwards need, and C 19."""
    n, h, w, c, s = 1, 6, 10, 19, 4
    logits, labels, _ = ce_inputs(n, h, w, c, s, seed)
    return n, h, w, c, s, logits, torch.from_numpy(labels), 1.0 / labels.size, 1.3


def test_replay_matches_row15_pallas_interpret():
    """Row 15's decomposition (h-major labels gathered through the kernel's
    index) against ``_ce_bwd_loss_pallas`` (f32)."""
    n, h, w, c, s, logits, lab, img_w, g = _phase_case(5)
    ph = ce.labels_to_phase(lab, s).contiguous()
    want = np.asarray(jax_ce._ce_bwd_loss_pallas(
        jnp.asarray(logits), jnp.asarray(ph.numpy()), jnp.asarray(g, jnp.float32), s, c, img_w,
        interpret=True))
    gathered = ph.reshape(-1)[ce.ce_label_index("h-major", n, h, w, s)]
    for plan in ce_bwd_plans(n, h, w, c, s):
        close_to_largest(replay(torch.from_numpy(logits), gathered, s, plan, g=g, img_w=img_w),
                         want)


def test_replay_matches_row19_pallas_interpret():
    """Row 19's decomposition (w-major labels gathered through the kernel's
    index) against ``_ce_bwd_loss_pallas3`` (f32), at s 4, where its
    coefficients are rows 15 and 17's
    (``test_row19_coefficients_are_the_runtime_loops``)."""
    n, h, w, c, s, logits, lab, img_w, g = _phase_case(6)
    phw = ce.labels_to_phase_w(lab, s).contiguous()
    want = np.asarray(jax_ce._ce_bwd_loss_pallas3(
        jnp.asarray(logits), jnp.asarray(phw.numpy()), jnp.asarray(g, jnp.float32), s, c, img_w,
        interpret=True))
    gathered = phw.reshape(-1)[ce.ce_label_index("w-major", n, h, w, s)]
    for plan in ce_bwd_plans(n, h, w, c, s):
        close_to_largest(replay(torch.from_numpy(logits), gathered, s, plan, g=g, img_w=img_w),
                         want)


@pytest.mark.parametrize("s", range(1, 9))
def test_row19_coefficients_are_the_runtime_loops(s):
    delta, f = jax_ce._phase_coeff_dyn(jnp.arange(s), s)
    want = list(zip(np.asarray(delta).tolist(), np.asarray(f, np.float32).tolist()))
    got = ce.ce_bwd_coeffs(s, loop=True)
    assert got == want
    assert got == [(d, float(v)) for d, v in (phase_coeff(p, s, True) for p in range(s))]
    # rows 15 and 17 keep the double rule; the two agree where s is a power of 2
    double = ce.ce_bwd_coeffs(s)
    assert double == [(d, float(v)) for d, v in (phase_coeff(p, s) for p in range(s))]
    if s in (1, 2, 4, 8):
        assert got == double
    if s == 3:
        # phase 2: (2.5f / 3) − 0.5 rounds below 1/3; the double rule rounds 1/3 once
        assert [d for d, _ in got] == [d for d, _ in double]
        diff = [p for p in range(s) if got[p][1] != double[p][1]]
        assert diff == [2]
        assert got[2][1] == float(np.nextafter(np.float32(double[2][1]), np.float32(0)))
