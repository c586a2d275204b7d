"""PyTorch port, on the CPU: the whole-block train backward (row 7) in its
twelve-launch form, and the planning of the redesigned kernels.

- The plain steps (the attention backward returning dK and dV itself, the
  one d_z → d_hid step) against the JAX ``_mit_block_train_bwd`` (through
  ``mit_block_train``'s VJP, the Pallas kernels in interpret mode), f32 and
  bf16, at a geometry with 90 queries a frame (a last 64-query tile of 26
  rows) and ragged W. Tolerances as ``test_torch_port_block_train.py``'s:
  f32 1e-4 of each output's largest value (sums in other orders); bf16 2^-7
  (f32 gradients of bf16 roundings that may each flip one ulp), dx ≥ 99 %
  bitwise equal.
- The step table: twelve launches, and p, d_s and d_z are outputs of none.
- The strip, tile and split plans that the wrappers hand the kernels
  (``dwconv.strip_plan``, ``stage_block.dz_dhid_plan`` / ``dz_dhid_tiles``,
  ``stage_block.sra_bwd_splits``): they cover the map or the query tiles
  exactly, so every pixel's partial is counted once, and halos stay one
  pixel (two for hid) around owned pixels.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from test_torch_port_block_train import (GRAD_REL, _assert_bf16_rounded_alike,
                                         _assert_grad_close, _block_inputs, _j)
from vss_cffm_tpu.ops import stage_block as jax_sb
from vss_cffm_tpu_torch import ops
from vss_cffm_tpu_torch.ops import stage_block as sb
from vss_cffm_tpu_torch.ops.dwconv import strip_plan


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_twelve_step_backward_matches_pallas_interpret(dt):
    shape, nh, sr = (1, 9, 10, 64), 2, 3          # 90 queries, heads of 32, S = 9
    rng = np.random.RandomState(5)
    b, h, w, c = shape
    s = (h // sr) * (w // sr)
    ins, s_attn, s_ffn = _block_inputs(rng, shape, s, 4 * c, dt)
    s_attn, s_ffn = s_attn[:b], s_ffn[:b]
    go = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dt)
    jins = [_j(t) for t in ins] + [_j(s_attn), _j(s_ffn)]
    _, vjp = jax.vjp(lambda *a: jax_sb.mit_block_train(*a, nh, 1e-6, True), *jins)
    jgrads = vjp(_j(go))
    grads = ops.mit_block_train_bwd_torch(*ins[:16], s_attn, s_ffn, go, num_heads=nh, eps=1e-6)
    if dt == torch.bfloat16:
        _assert_bf16_rounded_alike(grads[0], jgrads[0], "dx")
    else:
        _assert_grad_close(grads[0], jgrads[0], GRAD_REL[dt], "dx")
    for name, g, jg in zip(sb.GRADS[1:], grads[1:], jgrads[1:17]):
        _assert_grad_close(g, jg, GRAD_REL[dt], name)


def test_step_table_keeps_p_d_s_and_d_z_on_chip():
    """Twelve launches; the attention step returns dK and dV itself and no
    step returns p, d_s or d_z (the kernels keep them on chip)."""
    rng = np.random.RandomState(6)
    shape = (2, 4, 6, 32)
    ins, s_attn, s_ffn = _block_inputs(rng, shape, 4, 128, torch.float32)
    p = dict(zip(sb._INPUTS, ins[:16]), shape=shape, dt=torch.float32, num_heads=1, eps=1e-6,
             s_attn=s_attn, s_ffn=s_ffn)
    steps = sb._train_bwd_steps(p, False, "mit_block_train_bwd")
    assert [n for n, _ in steps] == ["d_a", "d_hid", "d_ln2", "ln2_bwd", "dW2", "dW1", "d_ctx",
                                     "attn_bwd", "d_ln1", "ln1_bwd", "dWproj", "dWq"]
    acts = sb._run(sb._block_steps(*ins[:16], None, num_heads=1, eps=1e-6, kernel=False,
                                   s_attn=s_attn, s_ffn=s_ffn), names=sb._ACTS)
    t = sb.bwd_table(ins[0], torch.randn(shape), acts)
    outs = set()
    for _, fn in steps:
        new = fn(t)
        outs |= set(new)
        t.update(new)
    assert not outs & {"p_b", "d_s", "d_z"}
    assert {"dk", "dv", "dkdw", "dbdw", "db1"} <= outs
    assert set(sb.BWD_STEP_TOLERANCE) >= outs


@pytest.mark.parametrize("sms", [132, 8, 1])
@pytest.mark.parametrize("shape", [(4, 120, 120, 256), (4, 15, 15, 2048), (8, 15, 15, 2048),
                                   (8, 60, 60, 512), (1, 13, 7, 24), (2, 1, 1, 8)])
def test_dwconv_strips_cover_the_map(shape, sms):
    """Strips of ``rows`` rows, the last shorter, cover 0 .. H-1 once; each
    strip's thread reads rows i0 - 1 .. i1 (zero outside the map)."""
    b, h, w, c = shape
    rows, strips = strip_plan(b, h, w, c, sms)
    assert 1 <= rows <= h and strips == -(-h // rows)
    covered = [i for k in range(strips) for i in range(k * rows, min(h, k * rows + rows))]
    assert covered == list(range(h))
    # more SMs never give longer strips
    assert strip_plan(b, h, w, c, 4 * sms)[0] <= rows


@pytest.mark.parametrize("sms", [132, 4])
@pytest.mark.parametrize("shape", [(8, 120, 120, 256), (8, 60, 60, 512), (8, 30, 30, 1280),
                                   (2, 23, 19, 64), (1, 5, 4, 40)])
def test_dz_dhid_tiles_count_each_pixel_once(shape, sms):
    """The blocks' owned pixels partition the map (every pixel's tap, Σ d_z and
    Σ d_hid partial counted once); the halo a block computes d_z on (one
    pixel) and reads hid on (two) lies within [-1, H] x [-1, W] and
    [-2, H + 1] x [-2, W + 1], the kernel's zero padding."""
    b, h, w, ch = shape
    rows, strips, ctiles = sb.dz_dhid_plan(b, h, w, ch, sms)
    assert strips == -(-h // rows) and ctiles == -(-w // sb.DZ_TILE_W)
    tiles = sb.dz_dhid_tiles(b, h, w, rows)
    assert len(tiles) == b * strips * ctiles
    count = np.zeros((b, h, w), np.int64)
    for f, i0, i1, j0, j1 in tiles:
        assert 0 <= i0 < i1 <= h and 0 <= j0 < j1 <= w
        assert -1 <= i0 - 1 and i1 <= h and -1 <= j0 - 1 and j1 <= w      # the d_z halo
        count[f, i0:i1, j0:j1] += 1
    assert (count == 1).all()


@pytest.mark.parametrize("b,nh,hw,slots", [(8, 1, 14400, 132), (8, 2, 3600, 132),
                                           (8, 5, 900, 132), (2, 1, 99, 132), (1, 2, 153, 4),
                                           (3, 1, 100, 1), (16, 5, 900, 264)])
def test_sra_splits_cover_the_query_tiles(b, nh, hw, slots):
    """Each (frame, head)'s 64-query tiles are cut into consecutive splits of
    ``tps`` tiles, the last shorter and none empty, covering every tile once;
    the blocks fill whole waves no worse than one split per pair."""
    ntq = -(-hw // 64)
    tps, splits = sb.sra_bwd_splits(b, nh, ntq, slots)
    assert splits == -(-ntq // tps)
    tiles = [t for k in range(splits) for t in range(k * tps, min(ntq, k * tps + tps))]
    assert tiles == list(range(ntq))
    assert all(k * tps < ntq for k in range(splits))
    cost = lambda sp, tp: -(-b * nh * sp // slots) * (tp + 1)
    assert cost(splits, tps) <= cost(1, ntq)


def test_bench_dwconv_needs_the_card_and_plans_every_shape():
    """``tools/bench_dwconv`` refuses without a CUDA device (a CPU number is
    no device number); every shape it times has a strip plan that covers it."""
    from vss_cffm_tpu_torch.tools import bench_dwconv

    for (b, h, w, c), _ in bench_dwconv.SHAPES:
        rows, strips = strip_plan(b, h, w, c, 132)
        assert (strips - 1) * rows < h <= strips * rows
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            bench_dwconv.main(["--iters", "1"])
