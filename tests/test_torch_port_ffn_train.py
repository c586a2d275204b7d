"""PyTorch port, on the CPU: the block-FFN train pair's launches (rows 10 and
11, and the FFN half of rows 6 and 7): the backward's planner
(``ops/ffn_bwd.py:ffn_bwd_plan``) at every geometry the segmentor trains,
its tiles covering each pixel once; a plain-torch replay of the backward
launch's decomposition (tiles with their two- and one-pixel halos, chunks of
hidden channels, splits whose d_ln partials are summed in split order, the
per-block partial sums in the plan's order) against the port's plain
backward, the whole block's FFN half and the JAX pair in interpret mode;
and the pairs' saved tensors (no M x Ch activation kept)."""

from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torch_port_common import few_threads  # noqa: F401  (fixture)
from vss_cffm_tpu.ops import mixffn as jax_mixffn
from vss_cffm_tpu_torch import config as pcfg
from vss_cffm_tpu_torch import ops
from vss_cffm_tpu_torch.ops._dispatch import SMEM_LIMIT
from vss_cffm_tpu_torch.ops.mixffn import FFN_GRADS

fb = importlib.import_module("vss_cffm_tpu_torch.ops.ffn_bwd")
ff = importlib.import_module("vss_cffm_tpu_torch.ops.ffn_fused")
sb = importlib.import_module("vss_cffm_tpu_torch.ops.stage_block")

pytestmark = pytest.mark.usefixtures("few_threads")

H100_SMS = 132
BF16 = torch.bfloat16


def _train_geometries() -> list:
    """(b, h, w, c, ch) of the pairs' launches in training: 8 frames (2 clips
    of 4) of 480x480, stages 1-3 (stage 4 trains composed) of the B0, B1, B2
    and B5 widths, and every other width ``block_ffn_train_fits`` admits at
    those maps (C a multiple of 8 up to 512, Ch = 4·C)."""
    out = set()
    maps = (120, 60, 30)
    for variant in ("mit_b0", "mit_b1", "mit_b2", "mit_b5"):
        mit = pcfg.MIT_VARIANTS[variant]
        for hw, c, ratio in zip(maps, mit.embed_dims, mit.mlp_ratios):
            out.add((8, hw, hw, c, c * ratio))
    for hw in maps:
        for c in range(8, 513, 8):
            assert ops.block_ffn_train_fits(hw, hw, c, 4 * c)
            out.add((8, hw, hw, c, 4 * c))
    return sorted(out)


TRAIN_GEOMETRIES = _train_geometries()


def _covered_once(b, h, w, plan):
    seen = np.zeros((b, h, w), np.int32)
    for f, i0, i1, j0, j1 in ff.ffn_fused_tiles(b, h, w, plan):
        assert 0 <= i0 < i1 <= h and 0 <= j0 < j1 <= w
        assert i1 - i0 <= plan.rows and j1 - j0 <= plan.cols
        seen[f, i0:i1, j0:j1] += 1
    assert (seen == 1).all()


def test_plan_fits_every_train_geometry():
    """At each geometry: the plan's block fits 227 KB of shared memory (the
    mirror of the kernel's layout), its tile at most ``max_pixels(c)``, its
    splits run every chunk once, none empty; the tiles of the B0-B5 stage
    geometries cover each pixel once."""
    named = {(8, hw, hw, c, 4 * c) for hw, cs in ((120, (32, 64)), (60, (64, 128)),
                                                     (30, (160, 320))) for c in cs}
    for b, h, w, c, ch in TRAIN_GEOMETRIES:
        plan = fb.ffn_bwd_plan(b, h, w, c, ch, H100_SMS)
        assert plan.smem == fb.ffn_bwd_smem(plan.rows, plan.cols, c, plan.hc) <= SMEM_LIMIT
        assert 1 <= plan.rows <= h and 1 <= plan.cols <= w
        assert plan.rows * plan.cols <= ff.max_pixels(c)
        nchunks = -(-ch // plan.hc)
        assert plan.hc in ff.FFN_HCS and plan.chunks >= 1
        assert plan.splits * plan.chunks >= nchunks > (plan.splits - 1) * plan.chunks
        if (b, h, w, c, ch) in named:
            _covered_once(b, h, w, plan)


def _plan(rows, cols, c, ch, hc, splits):
    nch = -(-ch // hc)
    per = -(-nch // splits)
    return fb.FfnBwdPlan(rows, cols, hc, -(-nch // per), per, fb.ffn_bwd_smem(rows, cols, c, hc))


def _gelu_grad(z):
    return 0.5 * (1.0 + torch.erf(z * 0.7071067811865476)) + z * (
        torch.exp(-0.5 * z * z) * 0.3989422804014327)


def _halo(t, f, i0, i1, j0, j1, pad):
    """Rows [i0 - pad, i1 + pad) x columns [j0 - pad, j1 + pad) of frame f of
    t (B, H, W, C), zero outside the image, and the mask of inside."""
    b, h, w, _ = t.shape
    tp = F.pad(t[f], (0, 0, pad, pad, pad, pad))
    inside = F.pad(torch.ones(h, w), (pad, pad, pad, pad))
    return tp[i0:i1 + 2 * pad, j0:j1 + 2 * pad], inside[i0:i1 + 2 * pad, j0:j1 + 2 * pad]


def replay(x, go, gamma, beta, w1, b1, kdw, bdw, w2, s_ffn, eps, plan, full=False, s_attn=None):
    """The backward launch's decomposition in plain torch, with its rounding
    points: per tile, LN of the tile and its two-pixel halo rounded to bf16
    and bf16(go·s) of its one-pixel halo, zero outside the image; per split
    and chunk, hid = LN·W1 + b1 (zero outside), d_a = go_s·W2ᵀ, z = the taps
    in (di, dj) order + bdw, d_z = d_a·GELU′(z) (zero outside), on the tile a
    = bf16(GELU(z)), the tap sums, Σ d_z, d_hid = dw3×3ᵀ(d_z) in (dj, di)
    order, Σ d_hid, d_hid_b added into the split's d_ln partial; the splits
    summed in split order, the LayerNorm backward, and the per-block partial
    sums added in block order. Returns the launch's outputs and dW2, dW1."""
    b, h, w, c = x.shape
    ch = w1.shape[1]
    m = b * h * w
    w1d, w2d = w1.to(BF16).float(), w2.to(BF16).float()
    taps = kdw.reshape(9, ch).float()
    gos = (go.float().reshape(b, h, w, c) * s_ffn.float().reshape(b, 1, 1, 1)).to(BF16).float()
    ln_full = sb._ln_f32(x.float(), gamma.float(), beta.float(), eps).to(BF16).float()
    nch = -(-ch // plan.hc)
    tiles = ff.ffn_fused_tiles(b, h, w, plan)
    a_out = torch.zeros(b, h, w, ch)
    dh_out = torch.zeros(b, h, w, ch)
    cpart = torch.zeros(len(tiles), 11, ch)
    dl_parts = torch.zeros(plan.splits, b, h, w, c)
    for ti, (f, i0, i1, j0, j1) in enumerate(tiles):
        r, tw = i1 - i0, j1 - j0
        ln2, in2 = _halo(ln_full, f, i0, i1, j0, j1, 2)
        go1, in1 = _halo(gos, f, i0, i1, j0, j1, 1)
        for sp in range(plan.splits):
            for ck in range(sp * plan.chunks, min(nch, (sp + 1) * plan.chunks)):
                h0, h1 = ck * plan.hc, min(ch, (ck + 1) * plan.hc)
                hid = (ln2 @ w1d[:, h0:h1] + b1.float()[h0:h1]) * in2[..., None]
                d_a = go1 @ w2d[h0:h1].t()
                k = taps[:, h0:h1]
                z = None
                for q in range(9):
                    term = hid[q // 3:q // 3 + r + 2, q % 3:q % 3 + tw + 2] * k[q]
                    z = term if z is None else z + term
                z = z + bdw.float()[h0:h1]
                d_z = d_a * _gelu_grad(z) * in1[..., None]
                own = (slice(1, r + 1), slice(1, tw + 1))
                a_out[f, i0:i1, j0:j1, h0:h1] = F.gelu(z[own]).to(BF16).float()
                sums = [(hid[q // 3 + 1:q // 3 + 1 + r, q % 3 + 1:q % 3 + 1 + tw]
                         * d_z[own]).sum(dim=(0, 1)) for q in range(9)]
                d_hid = None
                for dj in range(3):
                    for di in range(3):
                        term = d_z[2 - di:2 - di + r, 2 - dj:2 - dj + tw] * k[di * 3 + dj]
                        d_hid = term if d_hid is None else d_hid + term
                cpart[ti, :, h0:h1] = torch.stack(sums + [d_z[own].sum(dim=(0, 1)),
                                                          d_hid.sum(dim=(0, 1))])
                d_hid_b = d_hid.to(BF16).float()
                dh_out[f, i0:i1, j0:j1, h0:h1] = d_hid_b
                dl_parts[sp, f, i0:i1, j0:j1] += d_hid_b @ w1d[:, h0:h1].t()
    d_ln = dl_parts[0]
    for sp in range(1, plan.splits):
        d_ln = d_ln + dl_parts[sp]
    s_out = s_attn if full else None
    o = sb.ln_bwd(d_ln.reshape(m, c), x.reshape(m, c), gamma, beta, eps, go.reshape(m, c),
                  torch.float32 if full else x.dtype, BF16, kernel=False, s_out=s_out,
                  s_res=s_ffn, rows_per_frame=h * w, op="replay")
    # the per-block partials of the LayerNorm pass: a tile's pixels, or runs of
    # EPI_ROWS rows after a split, added in block order
    xhat = sb._ln_f32(x.float(), torch.ones(c), torch.zeros(c), eps).reshape(m, c)
    res_s = go.float().reshape(m, c) * sb._frame_rows(s_ffn, h * w)
    per_pixel = [d_ln.reshape(m, c) * xhat, d_ln.reshape(m, c), res_s]
    if full:
        per_pixel.append(o["dx"].float() * sb._frame_rows(s_attn, h * w))
    rows = torch.arange(m).reshape(b, h, w)
    if plan.splits == 1:
        blocks = [rows[f, i0:i1, j0:j1].reshape(-1) for f, i0, i1, j0, j1 in tiles]
    else:
        blocks = [torch.arange(r0, min(m, r0 + fb.EPI_ROWS)) for r0 in range(0, m, fb.EPI_ROWS)]
    esum = None
    for idx in blocks:
        part = torch.stack([t[idx].sum(dim=0) for t in per_pixel])
        esum = part if esum is None else esum + part
    csum = cpart[0]
    for t in range(1, len(tiles)):
        csum = csum + cpart[t]
    a_b, dh_b = a_out.reshape(m, ch), dh_out.reshape(m, ch)
    out = {"a": a_b.to(BF16), "d_hid": dh_b.to(BF16), "ln2": o["ln"],
           "dkdw": csum[:9].reshape(3, 3, 1, ch), "dbdw": csum[9], "db1": csum[10],
           "dg2": esum[0], "dbe2": esum[1], "db2": esum[2],
           "dw2": a_b.t() @ gos.reshape(m, c), "dw1": o["ln"].float().t() @ dh_b}
    if full:
        out.update(d_y=o["dx"], d_attn=o["dx_s"], dbproj=esum[3])
    else:
        out["dx"] = o["dx"]
    return out


def _inputs(rng, shape, ch, dt=BF16):
    b, h, w, c = shape
    f = lambda *sh, sc=1.0: torch.from_numpy((rng.randn(*sh) * sc).astype(np.float32))
    x = f(*shape).to(dt)
    ffn = (1.0 + f(c, sc=0.1), f(c, sc=0.1), f(c, ch, sc=c ** -0.5), f(ch, sc=0.1),
           f(3, 3, 1, ch, sc=1 / 3), f(ch, sc=0.1), f(ch, c, sc=ch ** -0.5), f(c, sc=0.1))
    go = f(*shape).to(BF16)
    scale = torch.from_numpy(np.resize(np.array([1 / 0.9, 0.0], np.float32), b))
    return x, ffn, go, scale


def _close(got, want, rel, label):
    g, w = got.float(), want.float()
    assert g.shape == w.shape, label
    err = (g - w).abs().max().item()
    assert err <= rel * w.abs().max().item() + 1e-30, (label, err, w.abs().max().item())


def _bf16_alike(got, want, label):
    """bf16 outputs rounded at the same points from f32 sums in other orders:
    ≥ 99 % of the elements bitwise equal, none off by more than 2^-6 of the
    largest (one flip carried through a product)."""
    assert got.dtype == BF16 == want.dtype, label
    assert (got == want).float().mean().item() >= 0.99, label
    _close(got, want, 2.0 ** -6, label)


# shape, Ch, forced plan (rows, cols, hc, splits): ragged tiles (7 = 3 + 3 +
# 1 rows, 10 = 4 + 4 + 2 columns), a ragged last chunk (Ch 80 = 32 + 32 +
# 16) and a ragged last split (3 chunks in runs of 2); one pixel a frame
REPLAY_CASES = [((2, 7, 10, 24), 80, (3, 4, 32, 2)), ((2, 7, 10, 24), 80, (4, 5, 64, 1)),
                ((3, 1, 1, 16), 40, (1, 1, 32, 1))]


@pytest.mark.parametrize("shape,ch,forced", REPLAY_CASES, ids=["split", "one-split", "1x1"])
def test_backward_replay_matches_plain_and_jax(shape, ch, forced):
    """The replay against the port's plain backward (``FFN_GRADS`` and the
    launch's a, d_hid, ln2 against the plain steps) and, at the ragged shape,
    against the JAX pair's ``jax.vjp`` in interpret mode. Tolerances: bf16
    outputs as ``_bf16_alike``; the f32 gradients, from bf16 inputs (d_hid_b,
    a, go_s, ln2) that may each flip one ulp in the other order of sums,
    2^-7 of each one's largest value (the bf16 bound of
    ``test_torch_port_block_train.py``)."""
    rng = np.random.RandomState(7)
    x, ffn, go, scale = _inputs(rng, shape, ch)
    plan = _plan(*forced[:2], shape[-1], ch, forced[2], forced[3])
    got = replay(x, go, *ffn[:7], scale, 1e-6, plan)
    p = dict(shape=shape, dt=BF16, g2=ffn[0], be2=ffn[1], w1=ffn[2], b1=ffn[3], kdw=ffn[4],
             bdw=ffn[5], w2=ffn[6], s_ffn=scale, s_attn=None, eps=1e-6)
    y = x.reshape(-1, shape[-1])
    ref = sb.run_steps(sb.ffn_bwd_steps(p, False, False, "t"),
                       sb.bwd_table(x, go, {"y": y}, ("y",)))
    for key in ("a", "d_hid", "ln2", "dx"):
        _bf16_alike(got[key], ref[key], key)
    for key in FFN_GRADS[1:]:
        _close(got[key], ref[key], 2.0 ** -7, key)
    if forced[3] == 1:
        return
    jins = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16 if t.dtype == BF16
                                                  else jnp.float32)
            for t in (x, *ffn, scale)]
    _, vjp = jax.vjp(lambda *a: jax_mixffn.block_ffn_train(*a, 1e-6, True), *jins)
    jgrads = vjp(jnp.asarray(go.float().numpy()).astype(jnp.bfloat16))
    jx = torch.from_numpy(np.array(jgrads[0].astype(jnp.float32))).to(BF16)
    _bf16_alike(got["dx"].reshape(shape), jx, "dx (JAX)")
    for key, jg in zip(FFN_GRADS[1:], jgrads[1:9]):
        _close(got[key], torch.from_numpy(np.array(jg.astype(jnp.float32))), 2.0 ** -7,
               f"{key} (JAX)")


def test_backward_replay_full_mode_matches_the_block_steps():
    """The whole block's mode (``full``: the f32 y in, d_y, d_attn, dbproj
    out) with a split against the plain FFN half of ``mit_block_train_bwd``
    (``ffn_bwd_steps(full=True)``), at the tolerances above."""
    rng = np.random.RandomState(8)
    shape, ch = (2, 5, 6, 16), 72
    x, ffn, go, scale = _inputs(rng, shape, ch, torch.float32)
    s_attn = scale.flip(0)
    plan = _plan(2, 4, shape[-1], ch, 32, 3)
    got = replay(x, go, *ffn[:7], scale, 1e-6, plan, full=True, s_attn=s_attn)
    p = dict(shape=shape, dt=BF16, g2=ffn[0], be2=ffn[1], w1=ffn[2], b1=ffn[3], kdw=ffn[4],
             bdw=ffn[5], w2=ffn[6], s_ffn=scale, s_attn=s_attn, eps=1e-6)
    ref = sb.run_steps(sb.ffn_bwd_steps(p, False, True, "t"),
                       {"go": go.reshape(-1, 16), "y": x.reshape(-1, 16)})
    for key in ("a", "d_hid", "ln2", "d_attn"):
        _bf16_alike(got[key], ref[key], key)
    for key in ("d_y", "dbproj", "dg2", "dbe2", "db2", "dkdw", "dbdw", "db1", "dw1", "dw2"):
        _close(got[key], ref[key], 2.0 ** -7, key)


def test_pairs_keep_no_hidden_map():
    """Neither autograd Function saves a tensor of M x Ch elements (the hidden
    map or a): the backward recomputes them from x (``block_ffn_train``) or
    y (``mit_block_train``), as the TPU kernels do."""
    rng = np.random.RandomState(9)
    shape, ch = (2, 4, 4, 16), 64
    m = 2 * 4 * 4
    x, ffn, _, scale = _inputs(rng, shape, ch)
    out = ops.block_ffn_train(x, *(t.requires_grad_(True) for t in ffn), scale)
    saved = out.grad_fn.saved_tensors
    assert saved and all(t.numel() != m * ch for t in saved)
    c = shape[-1]
    f = lambda *sh: torch.from_numpy(rng.randn(*sh).astype(np.float32) * 0.2)
    k, v = f(2, 4, c), f(2, 4, c)
    blk = (x, 1.0 + f(c), f(c), f(c, c), f(c), k, v, f(c, c), f(c), *ffn)
    out = ops.mit_block_train(*(t.requires_grad_(True) if t.dtype == torch.float32 else t
                                for t in blk), scale.flip(0), scale, num_heads=1)
    saved = out.grad_fn.saved_tensors
    assert saved and all(t.numel() != m * ch for t in saved)
    assert len(saved) == len(blk) - 1 + 2 + len(sb._ACTS)
