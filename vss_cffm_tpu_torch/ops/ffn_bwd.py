"""The backward of a MiT block's FFN half in training as one launch
(``csrc/ffn_bwd.cu``), for out = x + s·FFN(LN2(x)) and the output cotangent
go:

    dx = go + LN2ᵀ(d_ln),  d_ln = d_hid_b·W1ᵀ,  d_hid = dw3×3ᵀ(d_a·GELU′(z)),
    d_a = bf16(go·s)·W2ᵀ,  z = dw3×3(mask(bf16(LN2 x)·W1 + b1)) + bdw

x (B, H, W, C) is the half's input (bf16 x in ``block_ffn_train``, the f32 y
of the whole block); in the whole block's mode (``full``) dx is the f32 d_y
and the launch also writes d_attn = bf16(d_y·s_attn). A block owns a tile of
``rows`` x ``cols`` pixels of one frame and recomputes LN2 on its two-pixel
halo and bf16(go·s) on its one-pixel halo (kept in shared memory), then walks
the hidden channels in chunks of ``hc``: the hidden map, z, d_a, d_z and
d_hid of the chunk stay on chip, d_ln is summed in registers. What leaves the
SM: a = bf16(GELU(z)) and d_hid_b (M, Ch) for the weight products dW2 =
aᵀ·bf16(go·s) and dW1 = ln2ᵀ·d_hid_b (``stage_block.gemm_tn``), ln2, dx, and
per block the partial sums of the depthwise taps, dbdw, db1, dγ2, dβ2, db2
(and dbproj), reduced here in a fixed order. Where the plan splits the
hidden channels over blocks, each writes its f32 partial of d_ln and a
second pass sums them in split order before the LayerNorm backward. No
atomics: two runs give the same bits.

It replaces the TPU kernel ``vss_cffm_tpu/ops/mixffn.py:_bwd_kernel_ln``
(row 11 of ``PERF.md``'s table) and the FFN half of
``vss_cffm_tpu/ops/stage_block.py:_train_bwd_kernel`` (row 7), with the
rounding points of their plain version (``stage_block.ffn_bwd_steps``).

``ffn_bwd_plan`` picks the tile, the chunk and the split; the C entry
launches what it returns and refuses anything else, as ``require`` refuses
what the kernel does not take (C and Ch multiples of 8, C ≤ 512, H, W ≥ 1).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import _build
from ._dispatch import SMEM_LIMIT, ptr, require, sm_count, stream_of
from .ffn_fused import FFN_HCS, ffn_fused_fits, max_pixels

__all__ = ["FfnBwdPlan", "ffn_bwd_plan", "ffn_bwd_smem", "ffn_bwd_launch", "EPI_ROWS"]

_F32 = torch.float32
_BF16 = torch.bfloat16

# pixels of a block of the LayerNorm pass after a split (csrc/ffn_bwd.cu)
EPI_ROWS = 64
_WARPS = 8


def _rup(a: int, b: int) -> int:
    return -(-a // b) * b


def ffn_bwd_smem(rows: int, cols: int, c: int, hc: int) -> int:
    """Shared memory of one block (the kernel's ``layout``) for tiles of at
    most rows x cols pixels: the W1 and W2 chunks (round_up(C, 64) x hc bf16
    each), b1, bdw and the nine taps (f32), the LN of the two-pixel halo tile
    and bf16(go·s) of the one-pixel halo tile (round_up(C, 64) bf16 a pixel;
    after the last chunk the tile's f32 d_ln, rows of C + 8), the f32 hidden
    chunk of the two-pixel halo (also d_hid_b of the tile and the warps'
    partial sums), the f32 d_a / d_z chunk of the one-pixel halo, a byte a
    halo pixel, and 1024 bytes to align the base."""
    cp64 = _rup(c, 64)
    p2, p1, pout = (rows + 4) * (cols + 4), (rows + 2) * (cols + 2), rows * cols
    return (2 * cp64 * hc * 2 + 11 * hc * 4
            + max((p2 + p1) * cp64 * 2, pout * (c + 8) * 4)
            + max(p2 * hc * 4, _rup(pout * hc * 2, 16) + _WARPS * 11 * hc * 4, 4 * c * 4)
            + p1 * hc * 4 + _rup(p2, 16) + 1024)


class FfnBwdPlan(NamedTuple):
    rows: int     # pixel rows of a tile (the last band of a frame shorter)
    cols: int     # pixel columns of a tile (the last strip shorter)
    hc: int       # hidden channels of a chunk
    splits: int   # blocks over the hidden channels (> 1: f32 partials of d_ln, a second pass)
    chunks: int   # chunks of one split (the last split shorter)
    smem: int     # shared memory a block asks for


# The planner's weights, in SM cycles (estimates from the forward launch's
# measured phases, ops/ffn_fused.py): one k-step of a warpgroup's m64 product
# (load A, issue, wait), the tensor cores' bf16 rate (FLOP a cycle) for d_ln,
# a depthwise item of the halo (9 + 1 loads, 4 z, GELU′ and, on the tile,
# GELU and the partials) and of d_hid (9 loads, 36 FMAs, stores), a chunk's
# barriers, loads and partial sums, a round of the LayerNorm, the LayerNorm
# backward of a pixel, and the split's f32 partials of d_ln (written and read
# again) and its second pass.
_K_STEP, _TENSOR_FLOP = 190, 4096
_DW_ITEM, _DH_ITEM, _CHUNK, _LN_ROUND, _EPI_PIXEL = 420, 160, 2500, 8000, 700
_CYCLES_PER_BYTE, _PASS_CYCLES = 1.9e9 / 2.5e12, 6000


def _block_cycles(rows: int, cols: int, c: int, hc: int, chunks: int) -> float:
    """Estimated SM cycles of one block of ``chunks`` chunks: fc1 and d_a
    (the halos' m-tiles, the two warpgroups in turn), the depthwise items on
    the threads, d_ln on the tensor cores, the LayerNorm rounds and its
    backward once."""
    p2, p1, pout = (rows + 4) * (cols + 4), (rows + 2) * (cols + 2), rows * cols
    mt = -(-(-(-p2 // 64) + -(-p1 // 64)) // 2)
    prod = mt * (_rup(c, 32) // 16) * _K_STEP
    dln = 2 * max(64, pout) * hc * _rup(c, 64) / _TENSOR_FLOP / 0.7
    q4 = hc // 4
    dw = -(-p1 * q4 // 256) * _DW_ITEM + -(-pout * q4 // 256) * _DH_ITEM
    ln = -(-p2 // 64) * _LN_ROUND
    return ln + -(-pout // _WARPS) * _EPI_PIXEL + chunks * (prod + dln + dw + _CHUNK)


def _tiles(h: int, w: int, pmax: int):
    """(rows, cols) of the tiles the planner weighs: for each height the
    widest strip of at most pmax pixels and its halves (the widths where the
    halo tiles of the widest do not fit), balanced over the frame."""
    seen = set()
    for rows in range(1, min(h, pmax) + 1):
        rows_b = -(-h // -(-h // rows))             # balanced bands
        cols = min(w, pmax // rows)
        while cols >= 1:
            cols_b = -(-w // -(-w // cols))         # balanced strips
            if (rows_b, cols_b) not in seen:
                seen.add((rows_b, cols_b))
                yield rows_b, cols_b
            cols //= 2


@functools.lru_cache(maxsize=256)
def ffn_bwd_plan(b: int, h: int, w: int, c: int, ch: int, sms: int) -> FfnBwdPlan:
    """The launch of one (b, h, w, c) map with ch hidden channels on ``sms``
    SMs, one block an SM: of the tiles (``_tiles``: rows x cols ≤
    ``max_pixels(c)``) and chunks (64 or 32 channels) whose block fits the
    shared memory, and the splits of the chunks over blocks, the one with the
    least estimated time: waves of blocks times a block's cycles
    (``_block_cycles``), plus, with a split, the partials' bytes and the
    second pass. Of equal estimates the smaller halo wins, then the taller
    tile."""
    best = None
    m = b * h * w
    tiles_of = list(_tiles(h, w, max_pixels(c)))
    for hc in FFN_HCS:
        nchunks = -(-ch // hc)
        for rows, cols in tiles_of:
            smem = ffn_bwd_smem(rows, cols, c, hc)
            if smem > SMEM_LIMIT:
                continue
            tiles = b * -(-h // rows) * -(-w // cols)
            for splits in range(1, nchunks + 1):
                per = -(-nchunks // splits)
                splits = -(-nchunks // per)
                waves = -(-tiles * splits // sms)
                cost = waves * _block_cycles(rows, cols, c, hc, per)
                if splits > 1:
                    cost += (2 * splits * 4 + 6) * m * c * _CYCLES_PER_BYTE + _PASS_CYCLES
                key = (cost, (rows + 4) * (cols + 4), -rows)
                if best is None or key < best[0]:
                    best = (key, FfnBwdPlan(rows, cols, hc, splits, per, smem))
                if tiles * splits >= 4 * sms:
                    break
    require(best is not None, "ffn_bwd", lambda: f"no tile of C={c} fits {SMEM_LIMIT} bytes")
    return best[1]


def ffn_bwd_launch(x: torch.Tensor, go: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   w1: torch.Tensor, b1: torch.Tensor, kdw: torch.Tensor, bdw: torch.Tensor,
                   w2: torch.Tensor, s_ffn: torch.Tensor, eps: float, op: str, *,
                   s_attn: torch.Tensor | None = None, full: bool = False,
                   plan: FfnBwdPlan | None = None) -> dict:
    """The FFN half's backward on the card: x (B, H, W, C) bf16 or f32
    contiguous, go (M, C) bf16, s_ffn (B,) (and s_attn with ``full``) →
    {a, d_hid (M, Ch) bf16; ln2 (M, C) bf16; dx (M, C) in x's dtype, or with
    ``full`` d_y (M, C) f32 and d_attn (M, C) bf16; dkdw (3, 3, 1, Ch), dbdw,
    db1, dg2, dbe2, db2 [, dbproj] f32}. ``plan`` replaces ``ffn_bwd_plan``'s
    (the card tests force splits and ragged tiles)."""
    require(x.dim() == 4 and x.dtype in (_BF16, _F32) and x.is_cuda and x.is_contiguous(), op,
            lambda: f"FFN input {x.dtype} {tuple(x.shape)} on {x.device} (bf16 or f32 NHWC)")
    b, h, w, c = x.shape
    ch = w1.shape[1]
    m = b * h * w
    require(ffn_fused_fits(c, ch) and h >= 1 and w >= 1, op,
            lambda: f"FFN of C={c}, Ch={ch} at {h}x{w} (C, Ch multiples of 8, C <= 512)")
    require(tuple(w1.shape) == (c, ch) and tuple(w2.shape) == (ch, c)
            and kdw.numel() == 9 * ch, op,
            lambda: f"W1 {tuple(w1.shape)}, W2 {tuple(w2.shape)}, kdw {tuple(kdw.shape)}")
    require(go.dtype == _BF16 and go.numel() == m * c, op,
            lambda: f"go {go.dtype} {tuple(go.shape)} against x {tuple(x.shape)}")
    require(s_ffn is not None and tuple(s_ffn.shape) == (b,), op,
            lambda: f"branch scale {None if s_ffn is None else tuple(s_ffn.shape)}, expected ({b},)")
    require(not full or (s_attn is not None and tuple(s_attn.shape) == (b,)), op,
            lambda: "the whole block's mode takes the attention branch scale (B,)")
    dev = x.device
    # the operands in the kernel's dtypes, held until the launch is queued
    f32 = lambda t: t.to(device=dev, dtype=_F32).contiguous()
    bf = lambda t: t.to(device=dev, dtype=_BF16).contiguous()
    held = (bf(go.reshape(m, c)), f32(gamma), f32(beta), bf(w1), f32(b1),
            f32(kdw.reshape(9, ch)), f32(bdw), bf(w2), f32(s_ffn),
            f32(s_attn) if full else None)
    if plan is None:
        plan = ffn_bwd_plan(b, h, w, c, ch, sm_count(x))
    tiles = b * -(-h // plan.rows) * -(-w // plan.cols)
    a = torch.empty((m, ch), device=dev, dtype=_BF16)
    d_hid = torch.empty((m, ch), device=dev, dtype=_BF16)
    ln2 = torch.empty((m, c), device=dev, dtype=_BF16)
    dx = torch.empty((m, c), device=dev, dtype=_F32 if full else x.dtype)
    d_attn = torch.empty((m, c), device=dev, dtype=_BF16) if full else None
    cpart = torch.empty((tiles, 11, ch), device=dev, dtype=_F32)
    eblocks = tiles if plan.splits == 1 else -(-m // EPI_ROWS)
    epart = torch.empty((eblocks, 4, c), device=dev, dtype=_F32)
    dlpart = (torch.empty((plan.splits, m, c), device=dev, dtype=_F32) if plan.splits > 1
              else None)
    devi, stream = stream_of(x)
    rc = _build.library("ffn_bwd").ffn_bwd(
        ptr(x, op), *(ptr(t, op) for t in held), ptr(a, op), ptr(d_hid, op), ptr(ln2, op),
        ptr(dx, op), ptr(d_attn, op), ptr(cpart, op), ptr(epart, op), ptr(dlpart, op),
        b, h, w, c, ch, int(x.dtype == _F32), int(full), plan.rows, plan.cols, plan.hc,
        plan.splits, plan.chunks, eps, devi, stream)
    _build.check(rc, op)
    cs, es = cpart.sum(dim=0), epart.sum(dim=0)
    out = {"a": a, "d_hid": d_hid, "ln2": ln2, "dkdw": cs[:9].reshape(3, 3, 1, ch),
           "dbdw": cs[9], "db1": cs[10], "dg2": es[0], "dbe2": es[1], "db2": es[2]}
    if full:
        out.update(d_y=dx, d_attn=d_attn, dbproj=es[3])
    else:
        out["dx"] = dx
    return out
