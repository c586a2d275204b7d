"""PyTorch port, on the CPU: the inference FFN launch of rows 1, 8 and 9
(``ops/ffn_fused.py``, ``csrc/ffn_fused.cu``). Its planner at every geometry
the segmentor feeds the two rows (B1 at 480x480 and 480x864, test-time
augmentation's scales, the B0, B2 and B5 widths, SegFormer-B0), its tiles
covering each output pixel once, and a plain-torch replay of the kernel's
decomposition (tiles of rows x columns with their one-pixel halo, chunks of
hidden channels, splits over blocks summed in split order) against the
port's plain FFN and the JAX package's XLA twins ``block_ffn_xla`` and,
through the port's plain attention steps, ``mit_block_xla``; without the
LayerNorm and the residual (row 9) against ``mixffn_fused_torch``, the JAX
``mixffn_fused`` in interpret mode and ``mixffn_xla``."""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from torch_port_common import few_threads  # noqa: F401  (fixture)
from vss_cffm_tpu.ops import mixffn as jax_mixffn
from vss_cffm_tpu.ops.mixffn import block_ffn_xla
from vss_cffm_tpu.ops.stage_block import mit_block_xla
from vss_cffm_tpu_torch import config as pcfg
from vss_cffm_tpu_torch.data.vspw import TTA_RATIOS
from vss_cffm_tpu_torch.ops._dispatch import SMEM_LIMIT

ff = importlib.import_module("vss_cffm_tpu_torch.ops.ffn_fused")
sb = importlib.import_module("vss_cffm_tpu_torch.ops.stage_block")
mixffn = importlib.import_module("vss_cffm_tpu_torch.ops.mixffn")

pytestmark = pytest.mark.usefixtures("few_threads")

H100_SMS = 132


def _stage_maps(h: int, w: int) -> list:
    """The four MiT stage maps of an (h, w) input: the 7x7 stride-4 embed,
    then three 3x3 stride-2 embeds (each ceil)."""
    maps = [(-(-h // 4), -(-w // 4))]
    for _ in range(3):
        maps.append((-(-maps[-1][0] // 2), -(-maps[-1][1] // 2)))
    return maps


def _path_geometries() -> list:
    """(b, h, w, c, ch) of every launch of rows 1 and 8 on the segmentor's
    paths: clips of 4 frames at 480x480 and 480x864 (VSPW eval), the TTA
    views of a 480x853 frame (img_scale (853, 480) times each ratio, aligned
    to 32), each stage of the B0, B1, B2 and B5 widths; SegFormer-B0 on one
    frame at 480x864."""
    inputs = {(480, 480), (480, 864)}
    for r in TTA_RATIOS:
        inputs.add((-(-int(480 * r) // 32) * 32, -(-int(853 * r) // 32) * 32))
    out = set()
    for variant in ("mit_b0", "mit_b1", "mit_b2", "mit_b5"):
        mit = pcfg.MIT_VARIANTS[variant]
        for h, w in sorted(inputs):
            for (mh, mw), c, ratio in zip(_stage_maps(h, w), mit.embed_dims, mit.mlp_ratios):
                out.add((4, mh, mw, c, c * ratio))
                if variant == "mit_b0" and (h, w) == (480, 864):
                    out.add((1, mh, mw, c, c * ratio))
    return sorted(out)


PATH_GEOMETRIES = _path_geometries()
_block_ffn_xla = jax.jit(block_ffn_xla, static_argnames=("eps",))
_mit_block_xla = jax.jit(mit_block_xla, static_argnames=("num_heads", "eps"))
_mixffn_xla = jax.jit(jax_mixffn.mixffn_xla)


@pytest.mark.parametrize("b,h,w,c,ch", PATH_GEOMETRIES)
def test_plan_fits_every_path_geometry(b, h, w, c, ch):
    """The plan's block fits 227 KB of shared memory (the smem mirror of the
    kernel's layout), its tile at most ``max_pixels(c)``, and its splits run
    every chunk once, none empty."""
    plan = ff.ffn_fused_plan(b, h, w, c, ch, H100_SMS)
    assert plan.smem == ff.ffn_fused_smem(plan.rows, plan.cols, c, plan.hc) <= SMEM_LIMIT
    assert 1 <= plan.rows <= h and 1 <= plan.cols <= w
    assert plan.rows * plan.cols <= ff.max_pixels(c)
    nchunks = -(-ch // plan.hc)
    assert plan.hc in ff.FFN_HCS and plan.chunks >= 1
    assert plan.splits * plan.chunks >= nchunks > (plan.splits - 1) * plan.chunks


def _covered_once(b, h, w, plan):
    seen = np.zeros((b, h, w), np.int32)
    for f, i0, i1, j0, j1 in ff.ffn_fused_tiles(b, h, w, plan):
        assert 0 <= i0 < i1 <= h and 0 <= j0 < j1 <= w
        assert i1 - i0 <= plan.rows and j1 - j0 <= plan.cols
        seen[f, i0:i1, j0:j1] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("b,h,w,c,ch", PATH_GEOMETRIES[::7])
def test_plan_tiles_cover_every_output_pixel_once(b, h, w, c, ch):
    _covered_once(b, h, w, ff.ffn_fused_plan(b, h, w, c, ch, H100_SMS))


def _plan(rows, cols, c, ch, hc, splits):
    nch = -(-ch // hc)
    per = -(-nch // splits)
    return ff.FfnPlan(rows, cols, hc, -(-nch // per), per, ff.ffn_fused_smem(rows, cols, c, hc))


def replay(x, gamma, beta, w1, b1, kdw, bdw, w2, b2, eps, res, plan, dt):
    """The kernel's decomposition in plain torch: per split and tile, the LN
    of the tile and its halo in dt (without gamma x itself in dt; zeros
    outside the image), per chunk of
    hidden channels fc1 of the halo in f32 + b1, zero outside the image, the
    taps in (di, dj) order + bdw, GELU, a in dt, fc2's f32 partial added into
    the tile's accumulator; the splits' partials summed in split order, then
    b2, then the residual, one cast to dt."""
    b, h, w, c = x.shape
    ch = w1.shape[1]
    ln = (x if gamma is None else sb._ln_f32(x.float(), gamma.float(), beta.float(), eps)).to(dt)
    w1d, w2d = w1.to(dt).float(), w2.to(dt).float()
    taps = kdw.reshape(9, ch).float()
    nch = -(-ch // plan.hc)
    parts = torch.zeros((plan.splits, b, h, w, c))
    lnp = F.pad(ln.float(), (0, 0, 1, 1, 1, 1))
    inside = F.pad(torch.ones((b, h, w, 1)), (0, 0, 1, 1, 1, 1))
    for s in range(plan.splits):
        for f, i0, i1, j0, j1 in ff.ffn_fused_tiles(b, h, w, plan):
            rr, cc = i1 - i0, j1 - j0
            halo = lnp[f, i0:i1 + 2, j0:j1 + 2]          # halo rows i0-1 .. i1, padded coords
            valid = inside[f, i0:i1 + 2, j0:j1 + 2]
            acc = torch.zeros((rr, cc, c))
            for ck in range(s * plan.chunks, min(nch, (s + 1) * plan.chunks)):
                hs = slice(ck * plan.hc, min(ch, (ck + 1) * plan.hc))
                hid = (halo @ w1d[:, hs] + b1[hs].float()) * valid
                z = None
                for di in range(3):
                    for dj in range(3):
                        term = hid[di:di + rr, dj:dj + cc] * taps[di * 3 + dj, hs]
                        z = term if z is None else z + term
                a = F.gelu(z + bdw[hs].float()).to(dt)
                acc = acc + a.float() @ w2d[hs]
            parts[s, f, i0:i1, j0:j1] = acc
    out = parts[0]
    for s in range(1, plan.splits):
        out = out + parts[s]
    out = out + b2.float()
    if res is not None:
        out = out + res.float()
    return out.to(dt)


def _inputs(rng, b, h, w, c, ch, dt):
    f = lambda *sh, sc: torch.from_numpy((rng.randn(*sh) * sc).astype(np.float32))
    return (f(b, h, w, c, sc=1.0).to(dt), 1.0 + f(c, sc=0.1), f(c, sc=0.1),
            f(c, ch, sc=c ** -0.5), f(ch, sc=0.1), f(3, 3, 1, ch, sc=1 / 3), f(ch, sc=0.1),
            f(ch, c, sc=ch ** -0.5), f(c, sc=0.1))


def _jax(t):
    return jnp.asarray(t.float().numpy())


# (b, h, w, c, ch, forced plan (rows, cols, hc, splits) or None for the planner's)
REPLAY_CASES = [
    ((2, 7, 9, 32, 128), (3, 4, 32, 1)),     # H, W not multiples of the tile
    ((1, 1, 5, 16, 72), (1, 2, 32, 2)),      # H = 1; Ch not a multiple of hc; a split
    ((1, 6, 1, 24, 40), (4, 1, 32, 2)),      # W = 1; C not a multiple of 16
    ((2, 5, 6, 64, 200), (2, 3, 64, 3)),     # three splits, the last chunk short
    ((1, 9, 8, 40, 96), None),               # the planner's own plan
]


@pytest.mark.parametrize("shape,forced", REPLAY_CASES)
def test_tiling_replay_matches_plain_and_xla(shape, forced):
    """f32: the replay against ``block_ffn_fused_torch`` and the JAX
    ``block_ffn_xla`` within 1e-5 of the largest FFN output (the same math,
    f32 sums in other orders: per chunk, per split); bf16: the replay against
    ``block_ffn_fused_torch`` within 2^-6 of the largest FFN output (the
    same rounding points, a bf16 rounding of the LN output or of a may flip
    one ulp and carry through fc2: the card's ``ffn (out - y)`` bound)."""
    b, h, w, c, ch = shape
    plan = ff.ffn_fused_plan(b, h, w, c, ch, H100_SMS) if forced is None else _plan(
        forced[0], forced[1], c, ch, forced[2], forced[3])
    _covered_once(b, h, w, plan)
    rng = np.random.RandomState(0)
    for dt, rel in ((torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -6)):
        args = _inputs(rng, b, h, w, c, ch, dt)
        x = args[0]
        got = replay(*args, 1e-6, x, plan, dt)
        want = mixffn.block_ffn_fused_torch(*args, eps=1e-6)
        scale = (want.float() - x.float()).abs().max().item()
        assert (got.float() - want.float()).abs().max().item() <= rel * scale
        if dt == torch.float32:
            xla = torch.from_numpy(np.array(_block_ffn_xla(*map(_jax, args), eps=1e-6)))
            assert (got - xla).abs().max().item() <= rel * scale
            # and without the residual: the FFN alone against the plain fc2 step
            alone = replay(*args, 1e-6, None, plan, dt)
            assert (alone - (want - x)).abs().max().item() <= rel * scale


@pytest.mark.parametrize("shape,nh,forced", [
    ((1, 5, 7, 32, 128), 1, (2, 4, 32, 2)),
    ((2, 4, 4, 64, 256), 2, (3, 3, 64, 1)),
])
def test_block_replay_matches_mit_block_xla(shape, nh, forced):
    """The inference block on the kernel route's decomposition (the plain
    q, ctx and y steps, then the FFN launch's replay with the residual y)
    against the JAX ``mit_block_xla`` in f32, within 1e-4 of the largest
    block branch (attention and FFN sums in other orders)."""
    b, h, w, c = shape[:4]
    ch = shape[4]
    rng = np.random.RandomState(1)
    f = lambda *sh, sc=1.0: torch.from_numpy((rng.randn(*sh) * sc).astype(np.float32))
    s = 6
    args = (f(b, h, w, c), 1.0 + f(c, sc=0.1), f(c, sc=0.1), f(c, c, sc=c ** -0.5),
            f(c, sc=0.1), f(b, s, c), f(b, s, c), f(c, c, sc=c ** -0.5), f(c, sc=0.1),
            1.0 + f(c, sc=0.1), f(c, sc=0.1), f(c, ch, sc=c ** -0.5), f(ch, sc=0.1),
            f(3, 3, 1, ch, sc=1 / 3), f(ch, sc=0.1), f(ch, c, sc=ch ** -0.5), f(c, sc=0.1))
    t = sb._run(sb._block_steps(*args, num_heads=nh, eps=1e-6, kernel=False),
                names=("q", "ctx", "y"))
    y = t["y"].reshape(b, h, w, c)
    plan = _plan(forced[0], forced[1], c, ch, forced[2], forced[3])
    got = replay(y, *args[9:], 1e-6, y, plan, torch.float32)
    want = torch.from_numpy(np.array(_mit_block_xla(*map(_jax, args), num_heads=nh, eps=1e-6)))
    x = args[0]
    assert (got - want).abs().max().item() <= 1e-4 * (want - x).abs().max().item()


# (b, h, w, c, ch, forced plan or None): B1's stage-1 and stage-4 widths at
# ragged maps, with and without a split
MIXFFN_REPLAY_CASES = [
    ((1, 7, 9, 64, 256), (3, 4, 32, 1)),
    ((2, 5, 6, 64, 256), (2, 3, 64, 3)),
    ((1, 3, 5, 512, 2048), None),
]


@pytest.mark.parametrize("shape,forced", MIXFFN_REPLAY_CASES)
def test_mixffn_tiling_replay_matches_plain_and_jax(shape, forced):
    """Row 9 on the launch without the LayerNorm or a residual: the replay
    (``replay`` with gamma None) against ``mixffn_fused_torch``, the JAX
    ``mixffn_fused`` in interpret mode and ``mixffn_xla``, f32 within 1e-5 of
    the largest output (sums in other orders: per chunk, per split); bf16
    against ``mixffn_fused_torch`` within 2^-6 (the same rounding points: fc1
    in bf16 with f32 sums, the hidden map in f32, a in bf16, fc2 in f32 + b2,
    out in bf16; a rounding of a may flip one ulp and carry through fc2)."""
    b, h, w, c, ch = shape
    plan = ff.ffn_fused_plan(b, h, w, c, ch, H100_SMS) if forced is None else _plan(
        forced[0], forced[1], c, ch, forced[2], forced[3])
    rng = np.random.RandomState(5)
    for dt, rel in ((torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -6)):
        args = _inputs(rng, b, h, w, c, ch, dt)
        mix = (args[0], *args[3:])
        got = replay(args[0], None, None, *args[3:], 0.0, None, plan, dt)
        want = mixffn.mixffn_fused_torch(*mix)
        scale = want.float().abs().max().item()
        assert (got.float() - want.float()).abs().max().item() <= rel * scale
        if dt == torch.float32:
            for jax_out in (jax_mixffn.mixffn_fused(*map(_jax, mix), interpret=True),
                            _mixffn_xla(*map(_jax, mix))):
                assert (got - torch.from_numpy(np.array(jax_out))).abs().max().item() <= \
                    rel * scale


def test_launch_gates():
    """What the launch takes: C and Ch multiples of 8, C at most 512 (the
    widths ``block_ffn_train_fits`` lets the segmentor route to it), any H, W;
    the smallest map gets a one-pixel tile."""
    assert ff.ffn_fused_fits(512, 2048) and ff.ffn_fused_fits(8, 8)
    assert not ff.ffn_fused_fits(520, 2080) and not ff.ffn_fused_fits(36, 144)
    assert not ff.ffn_fused_fits(64, 260)
    plan = ff.ffn_fused_plan(1, 1, 1, 8, 8, H100_SMS)
    assert (plan.rows, plan.cols, plan.splits) == (1, 1, 1)


def test_cpu_tensors_take_the_plain_ffn():
    """On CPU tensors both ops run their plain versions (force None), and
    force='kernel' raises rather than fall back."""
    rng = np.random.RandomState(2)
    args = _inputs(rng, 1, 3, 4, 16, 32, torch.bfloat16)
    got = mixffn.block_ffn_fused(*args)
    assert torch.equal(got, mixffn.block_ffn_fused_torch(*args))
    with pytest.raises(RuntimeError, match="needs CUDA"):
        mixffn.block_ffn_fused(*args, force="kernel")
