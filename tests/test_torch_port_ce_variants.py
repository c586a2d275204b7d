"""PyTorch port, the CE microbench's layout variants on the CPU: the port's
phase-layout helpers against the JAX package's; each variant's plain version
against its Pallas kernel in interpret mode (``_ce_bwd_loss_pallas`` v2,
``_ce_fwd_loss_pallas5`` v5, ``_ce_fwd_loss_pallas3`` / ``_ce_bwd_loss_pallas3``
v3) at C = 7, 40 and 124, s 4, bf16 logits and uint8 labels with 255, and
against the natural-layout loss pair's plain versions; the refusals.

Tolerances: the loss sum and the f32 dlogits are f32 on both sides, sums in
other orders and the lerp rounded as F.interpolate rounds it: 2e-5 relative
(plus 1e-9 absolute for dlogits, whose zero entries are exact); the correct
count exactly (no near-ties at these random logits).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vss_cffm_tpu.ops import ce_upsampled as jax_ce
from vss_cffm_tpu_torch import ops

S = 4
N, H, W = 2, 8, 8  # the TPU backwards need an even row chunk of h


def _inputs(seed: int, c: int, n=N, h=H, w=W):
    """bf16 logits (N, h, w, C) and uint8 labels (N, h·s, w·s), 10 % 255."""
    rng = np.random.RandomState(seed)
    logits = torch.from_numpy((rng.randn(n, h, w, c) * 2).astype(np.float32)).to(torch.bfloat16)
    labels = rng.randint(0, c, (n, h * S, w * S)).astype(np.uint8)
    labels[rng.rand(*labels.shape) < 0.1] = 255
    return logits, torch.from_numpy(labels)


def _j(t: torch.Tensor):
    """A JAX copy of t in bf16 (a copy: no JAX buffer aliases a tensor's memory)."""
    return jnp.array(t.float().numpy()).astype(jnp.bfloat16)


@pytest.mark.parametrize("shape,s", [((2, 8, 12), 4), ((1, 6, 10), 2), ((3, 9, 15), 3)])
def test_layout_helpers_match_jax(shape, s):
    lab = np.random.RandomState(0).randint(0, 256, shape).astype(np.uint8)
    t, j = torch.from_numpy(lab), jnp.asarray(lab)
    ph, phw = ops.labels_to_phase(t, s), ops.labels_to_phase_w(t, s)
    np.testing.assert_array_equal(ph.numpy(), np.asarray(jax_ce.labels_to_phase(j, s)))
    np.testing.assert_array_equal(phw.numpy(), np.asarray(jax_ce.labels_to_phase_w(j, s)))
    np.testing.assert_array_equal(ops.phase_to_natural(ph, s).numpy(),
                                  np.asarray(jax_ce.phase_to_natural(jax_ce.labels_to_phase(j, s),
                                                                     s)))
    np.testing.assert_array_equal(ops.phase_to_natural(ph, s).numpy(), lab)


# count_acc both ways across the three class counts
FWD_CASES = [(7, True), (40, False), (124, True)]


@pytest.mark.parametrize("c,count_acc", FWD_CASES)
@pytest.mark.parametrize("variant", ["v5", "v3"])
def test_fwd_variant_plain_matches_pallas_interpret(variant, c, count_acc):
    logits, labels = _inputs(c, c)
    img_w = 0.5 / labels.numel()
    phw = ops.labels_to_phase_w(labels, S)
    pallas = {"v5": jax_ce._ce_fwd_loss_pallas5, "v3": jax_ce._ce_fwd_loss_pallas3}[variant]
    # the JAX result complete before the port runs: no JAX work in flight
    # beside the two port calls compared bitwise below
    want = jax.block_until_ready(pallas(_j(logits), jnp.array(phw.numpy()), S, img_w,
                                        count_acc, interpret=True))
    op = {"v5": ops.ce_fwd_loss_v5, "v3": ops.ce_fwd_loss_v3}[variant]
    got = op(logits, phw, S, img_w, count_acc)
    np.testing.assert_allclose(got[0].item(), float(want[0]), rtol=2e-5)
    assert got[1].item() == float(want[1])
    assert (got[1].item() > 0) == count_acc
    # the plain version is row 14's on the natural labels
    natural = ops.ce_upsampled_loss_torch(logits, labels, S, img_w, count_acc)
    assert got[0].item() == natural[0].item() and got[1].item() == natural[1].item()


@pytest.mark.parametrize("c", [7, 40, 124])
@pytest.mark.parametrize("variant", ["v2", "v3"])
def test_bwd_variant_plain_matches_pallas_interpret(variant, c):
    """f32 dlogits on both sides (the TPU backwards return f32)."""
    logits, labels = _inputs(100 + c, c)
    img_w, ct = 1.0 / labels.numel(), torch.tensor(1.3)
    if variant == "v2":
        lab = ops.labels_to_phase(labels, S)
        want = jax_ce._ce_bwd_loss_pallas(_j(logits), jnp.asarray(lab.numpy()),
                                          jnp.asarray(1.3, jnp.float32), S, c, img_w,
                                          interpret=True)
        got = ops.ce_bwd_loss_v2(logits, lab, ct, S, img_w)
    else:
        lab = ops.labels_to_phase_w(labels, S)
        want = jax_ce._ce_bwd_loss_pallas3(_j(logits), jnp.asarray(lab.numpy()),
                                           jnp.asarray(1.3, jnp.float32), S, c, img_w,
                                           interpret=True)
        got = ops.ce_bwd_loss_v3(logits, lab, ct, S, img_w)
    assert got.dtype == torch.float32 and tuple(got.shape) == tuple(logits.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=1e-9)
    # the plain version is row 17's on the natural labels, before its cast
    natural = ops.ce_upsampled_loss_bwd_torch(logits.float(), labels, ct, S, img_w)
    torch.testing.assert_close(got, natural, rtol=0, atol=0)


def test_variants_at_odd_h_agree_with_the_natural_pair():
    """h = 7 (the TPU backwards refuse it; the port's kernels take it): the
    plain versions of all four against the natural-layout pair."""
    logits, labels = _inputs(7, 19, n=1, h=7, w=5)
    img_w, ct = 0.25 / labels.numel(), torch.tensor(0.9)
    ph, phw = ops.labels_to_phase(labels, S), ops.labels_to_phase_w(labels, S)
    want = ops.ce_upsampled_loss_torch(logits, labels, S, img_w)
    for op in (ops.ce_fwd_loss_v5, ops.ce_fwd_loss_v3):
        got = op(logits, phw, S, img_w)
        assert got[0].item() == want[0].item() and got[1].item() == want[1].item()
    want_d = ops.ce_upsampled_loss_bwd_torch(logits.float(), labels, ct, S, img_w)
    torch.testing.assert_close(ops.ce_bwd_loss_v2(logits, ph, ct, S, img_w), want_d,
                               rtol=0, atol=0)
    torch.testing.assert_close(ops.ce_bwd_loss_v3(logits, phw, ct, S, img_w), want_d,
                               rtol=0, atol=0)


def test_variant_refusals():
    """A label tensor in the other layout (or natural) raises on every path; a
    CPU tensor at force="kernel" raises; no variant counts a launch on the CPU."""
    logits, labels = _inputs(3, 7, h=8, w=6)
    ph, phw = ops.labels_to_phase(labels, S), ops.labels_to_phase_w(labels, S)
    ct = torch.tensor(1.0)
    ops.reset_launches()
    for bad in (phw, labels):
        with pytest.raises(ValueError, match="h-major phase layout"):
            ops.ce_bwd_loss_v2(logits, bad, ct, S, 0.1)
    for bad in (ph, labels):
        with pytest.raises(ValueError, match="w-major phase layout"):
            ops.ce_fwd_loss_v5(logits, bad, S, 0.1)
        with pytest.raises(ValueError, match="w-major phase layout"):
            ops.ce_fwd_loss_v3(logits, bad, S, 0.1, force="torch")
        with pytest.raises(ValueError, match="w-major phase layout"):
            ops.ce_bwd_loss_v3(logits, bad, ct, S, 0.1)
    for call in (lambda: ops.ce_bwd_loss_v2(logits, ph, ct, S, 0.1, force="kernel"),
                 lambda: ops.ce_fwd_loss_v5(logits, phw, S, 0.1, force="kernel"),
                 lambda: ops.ce_fwd_loss_v3(logits, phw, S, 0.1, force="kernel"),
                 lambda: ops.ce_bwd_loss_v3(logits, phw, ct, S, 0.1, force="kernel")):
        with pytest.raises(RuntimeError, match="needs CUDA tensors"):
            call()
    ops.ce_fwd_loss_v5(logits, phw, S, 0.1)
    assert all(v == 0 for v in ops.launches().values())


def test_bench_ce_runs_the_six_kernels_plain_on_the_cpu():
    """``bench_ce --device cpu`` at a tiny size: one timed line per kernel, the
    skips honoured, and its inputs in the JAX tool's layouts."""
    from vss_cffm_tpu_torch.tools import bench_ce

    args = ["--device", "cpu", "--n", "1", "--hw", "6", "5", "--c", "9", "--iters", "1",
            "--chunk", "1"]
    assert list(bench_ce.main(args)) == ["v2 fwd", "v2 bwd", "v5 fwd", "v5 bwd", "v3 fwd",
                                         "v3 bwd"]
    assert list(bench_ce.main(args + ["--skip-v2", "--skip-v3"])) == ["v5 fwd", "v5 bwd"]
    inp = bench_ce.make_inputs(1, (6, 5), 9, 4, "cpu")
    lab = inp["labels"].numpy()
    assert lab.dtype == np.uint8 and set(np.unique(lab)) <= set(range(9)) | {255}
    np.testing.assert_array_equal(inp["lphw"].numpy(),
                                  np.asarray(jax_ce.labels_to_phase_w(jnp.asarray(lab), 4)))


@pytest.mark.parametrize("variant", ["v5 fwd", "v3 bwd"])
def test_variants_take_int32_labels_as_the_pallas_kernels_do(variant):
    """int32 labels with values past 255 and below 0 (ignored, as every label
    outside [0, C)): the plain versions against the Pallas kernels in
    interpret mode, which cast any integer labels to int32; and the uint8
    labels the CUDA kernels read (``phase_labels_u8``: outside [0, C) → 255)
    give the plain versions the same result bit for bit, where a cast alone
    would turn 263 into class 7 and -250 into class 6."""
    c = 19
    logits, labels = _inputs(21, c)
    rng = np.random.RandomState(22)
    lab = labels.numpy().astype(np.int32)
    wide = rng.rand(*lab.shape)
    lab[wide < 0.05] = rng.randint(256, 1000, int((wide < 0.05).sum()))
    lab[(wide >= 0.05) & (wide < 0.1)] = rng.randint(-300, 0, int(((wide >= 0.05)
                                                                   & (wide < 0.1)).sum()))
    lab32 = torch.from_numpy(lab)
    u8 = ops.phase_labels_u8(lab32, c)
    assert u8.dtype == torch.uint8
    np.testing.assert_array_equal(u8.numpy(), np.where((lab >= 0) & (lab < c), lab, 255))
    assert not torch.equal(lab32.to(torch.uint8), u8)  # a plain cast would not ignore them
    img_w, ct = 0.5 / lab.size, torch.tensor(1.1)
    phw32, phw8 = ops.labels_to_phase_w(lab32, S), ops.labels_to_phase_w(u8, S)
    if variant == "v5 fwd":
        want = jax.block_until_ready(jax_ce._ce_fwd_loss_pallas5(
            _j(logits), jnp.array(phw32.numpy()), S, img_w, True, interpret=True))
        got = ops.ce_fwd_loss_v5(logits, phw32, S, img_w)
        np.testing.assert_allclose(got[0].item(), float(want[0]), rtol=2e-5)
        assert got[1].item() == float(want[1])
        got8 = ops.ce_fwd_loss_v5(logits, phw8, S, img_w)
        assert got8[0].item() == got[0].item() and got8[1].item() == got[1].item()
    else:
        want = jax_ce._ce_bwd_loss_pallas3(_j(logits), jnp.array(phw32.numpy()),
                                           jnp.asarray(1.1, jnp.float32), S, c, img_w,
                                           interpret=True)
        got = ops.ce_bwd_loss_v3(logits, phw32, ct, S, img_w)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=1e-9)
        torch.testing.assert_close(ops.ce_bwd_loss_v3(logits, phw8, ct, S, img_w), got,
                                   rtol=0, atol=0)


def test_wide_labels_need_an_ignore_value_outside_the_classes():
    """With 256 classes no uint8 value is ignored: wider labels are refused."""
    with pytest.raises(ValueError, match="256 classes"):
        ops.phase_labels_u8(torch.zeros(2, 4, dtype=torch.int32), 256)
    with pytest.raises(ValueError, match="integer dtype"):
        ops.phase_labels_u8(torch.zeros(2, 4), 7)
    u8 = torch.full((2, 4), 255, dtype=torch.uint8)
    assert ops.phase_labels_u8(u8, 256) is u8
