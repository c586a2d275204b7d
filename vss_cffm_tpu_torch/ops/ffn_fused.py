"""The FFN half of a MiT block at inference as one launch
(``csrc/ffn_fused.cu``):

    out = bf16([res] + [s]·(bf16(GELU(dw3×3(mask([LN](x)·W1 + b1)) + bdw))·W2 + b2))

x (B, H, W, C) is the FFN's input (f32 y in the whole block, bf16 x in
``block_ffn_fused``, ``block_ffn_train`` and ``mixffn_fused``); ``res`` the
residual (the same tensor, or none); ``scale`` (B,) the per-frame branch
scale of training (stochastic depth), or none at inference; gamma and beta
none for the MixFFN alone (``mixffn_fused``: fc1 reads x as it is). The
hidden map (f32) and the GELU output a (bf16) never reach device memory: a
block owns a tile of ``rows`` x ``cols`` output pixels of one frame, keeps
the LayerNorm of the tile and its one-pixel halo in shared memory in bf16,
and walks the hidden channels in chunks of ``hc``: fc1 of the halo tile →
the f32 chunk of the hidden map (zero outside the image) → depthwise 3×3 +
bias + GELU → the bf16 chunk of a → fc2's partial, added into register
accumulators of the tile's pixels × C. Where the tiles alone leave the card
short of work, the hidden channels are split over blocks (``splits``): each
writes its f32 partial, and a second pass sums them in a fixed order and
adds b2, the residual and the bf16 cast. No atomics: two runs give the same
bits.

It replaces the FFN half of the TPU kernels
``vss_cffm_tpu/ops/stage_block.py:_kernel`` (:134-150, row 1 of ``PERF.md``'s
table) and of ``_train_fwd_kernel`` (row 6, with the scale), and
``vss_cffm_tpu/ops/mixffn.py:_kernel_ln`` without a scale (row 8) and with it
(row 10), and ``_kernel`` (row 9, no LayerNorm and no residual), with their
rounding points (``ops/stage_block.py:_ffn_fwd_steps``'s
plain steps): LN statistics in f32, the LN output rounded to bf16, the hidden
map in f32, the nine taps in the plain version's (di, dj) order, exact erf
GELU, a in bf16, fc2 summed in f32, then b2, then the scale, then the
residual, one bf16 rounding. In training nothing is kept for the backward
(``ops/ffn_bwd.py`` recomputes it from x, as the TPU kernels do).

``ffn_fused_plan`` picks the tile, the chunk and the split; the C entry
launches what it returns and refuses anything else, as ``require`` refuses
what the kernel does not take (C and Ch multiples of 8, C ≤ 512, H, W ≥ 1).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import _build
from ._dispatch import SMEM_LIMIT, ptr, require, sm_count, stream_of

__all__ = ["FfnPlan", "ffn_fused_plan", "ffn_fused_smem", "ffn_fused_tiles", "ffn_fused_launch",
           "ffn_fused_fits", "max_pixels", "FFN_THREADS", "FFN_HCS"]

_F32 = torch.float32
_BF16 = torch.bfloat16

# threads of a block (csrc/ffn_fused.cu THREADS: two warpgroups, one block an SM)
FFN_THREADS = 256
# hidden channels of a chunk, in the planner's order of preference
FFN_HCS = (64, 32)
# fc2's split of the work by width (csrc/ffn_fused.cu Cls<K>): (the widest C
# of the class, whether each warpgroup owns 64 of the tile's pixels and all
# the na 64-column atoms of C (else both own the tile's pixels and take
# every other atom), na); a thread holds na · 32 f32 accumulators
_CLASSES = ((64, True, 1), (128, True, 2), (256, False, 2), (384, False, 3), (512, False, 4))


def _cls(c: int) -> tuple:
    return next(k for k in _CLASSES if c <= k[0])


def max_pixels(c: int) -> int:
    """The most output pixels of one tile at width c."""
    return 128 if _cls(c)[1] else 64


def _w2_cols(c: int) -> int:
    """Columns of the W2 chunk in shared memory: every atom fc2 runs."""
    _, pix2, na = _cls(c)
    return 64 * na * (1 if pix2 else 2)


def _rup(a: int, b: int) -> int:
    return -(-a // b) * b


def _prow(rows: int, cols: int) -> int:
    """Halo pixels of a tile, in wgmma's 64-row m-tiles."""
    return _rup((rows + 2) * (cols + 2), 64)


def ffn_fused_smem(rows: int, cols: int, c: int, hc: int) -> int:
    """Shared memory of one block (the kernel's ``layout``): the LN of the
    halo tile (rows of round_up(C, 64) bf16), the W1 chunk (round_up(C, 32)
    x hc bf16), the W2 chunk (hc x every atom fc2 runs, bf16), b1, bdw and
    the nine taps of the chunk (f32), the hidden chunk (halo pixels x (hc +
    8) f32), the a chunk (the tile's pixels x hc bf16), a byte a halo pixel
    (inside the image or not), and 1024 bytes to align the base."""
    prow = _prow(rows, cols)
    return (prow * _rup(c, 64) * 2 + _rup(c, 32) * hc * 2 + hc * _w2_cols(c) * 2 + 11 * hc * 4
            + prow * (hc + 8) * 4 + max_pixels(c) * hc * 2 + _rup(prow, 16) + 1024)


class FfnPlan(NamedTuple):
    rows: int     # output rows of a tile (the last band of a frame shorter)
    cols: int     # output columns of a tile (the last strip shorter)
    hc: int       # hidden channels of a chunk
    splits: int   # blocks over the hidden channels (> 1: f32 partials, a second pass)
    chunks: int   # chunks of one split (the last split shorter)
    smem: int     # shared memory a block asks for


# The planner's weights, in SM cycles, read off the kernel's clock64() phase
# counters at B1 stages 2 and 3 (H100 SXM): the tensor cores' bf16 rate
# (FLOP a cycle) and fc2's share of it, one k-step of a warpgroup's fc1
# (load A, issue, wait for the step before), a depthwise row step of an item
# (3 shared loads, 24 FMAs and, for a finished row, 12 FMAs, 4 GELUs and a
# store), a chunk's barriers and loads, a round of the LayerNorm's passes
# (loads in flight), and the split's f32 partials (written and read again)
# and its second pass.
_TENSOR_FLOP, _FC2_SHARE, _K_STEP, _DW_ROW = 4096, 0.7, 190, 550
_CHUNK, _LN_ROUND = 800, 8000
_CYCLES_PER_BYTE, _PASS_CYCLES = 1.9e9 / 2.5e12, 4000


def _dw_segments(rows: int, cols: int, hc: int) -> tuple[int, int]:
    """(rows a depthwise item walks, items along a column) of a rows x cols
    tile: the kernel cuts each column into the fewest runs of rows that give
    every thread an item, as long as the runs keep a row."""
    cq = cols * (hc // 4)
    nseg = min(rows, -(-FFN_THREADS // cq))
    rs = -(-rows // nseg)
    return rs, -(-rows // rs)


def _block_cycles(rows: int, cols: int, c: int, hc: int, chunks: int) -> float:
    """Estimated SM cycles of one block of ``chunks`` chunks: fc1 (the halo
    tile's m-tiles, the two warpgroups in turn, a k-step at a time), fc2 on
    the tensor cores, the depthwise items on the threads in turn, the
    LayerNorm rounds once."""
    prow = _prow(rows, cols)
    fc1 = -(-(prow // 64) // 2) * (_rup(c, 32) // 16) * _K_STEP
    pix = 128 if _cls(c)[1] and rows * cols > 64 else 64
    fc2 = 2 * pix * hc * _w2_cols(c) / _TENSOR_FLOP / _FC2_SHARE
    rs, nseg = _dw_segments(rows, cols, hc)
    dw = -(-(cols * (hc // 4) * nseg) // FFN_THREADS) * (rs + 2) * _DW_ROW
    c8 = c // 8
    lpr = 1
    while lpr < 32 and lpr * 2 < c8:
        lpr *= 2
    ln = -(-prow // (8 * 4 * 32 // lpr)) * _LN_ROUND
    return ln + chunks * (fc1 + fc2 + dw + _CHUNK)


@functools.lru_cache(maxsize=256)
def ffn_fused_plan(b: int, h: int, w: int, c: int, ch: int, sms: int) -> FfnPlan:
    """The launch of one (b, h, w, c) map with ch hidden channels on ``sms``
    SMs, one block an SM: of the tiles that fit (rows x cols ≤
    ``max_pixels(c)``, balanced over the frame), the chunks (64, else 32
    channels) whose block fits the shared memory, and the splits of the
    chunks over blocks, the one with the least estimated time: waves of
    blocks times a block's cycles (``_block_cycles``), plus, with a split,
    the partials' bytes and the second pass. A tile with more rows recomputes
    fewer halo rows of fc1; a split fills the card where the tiles do not.
    Of equal estimates the smaller halo wins, then the taller tile: at B1
    stage 3 a sweep of the plans on an H100 SXM measured 30 x 2 (86.0 µs)
    ahead of 8 x 8 (90.3), both 128 halo pixels."""
    best = None
    pmax = max_pixels(c)
    m = b * h * w
    for hc in FFN_HCS:
        nchunks = -(-ch // hc)
        for rows in range(1, min(h, pmax) + 1):
            cols = min(w, pmax // rows)
            cols = -(-w // -(-w // cols))           # balanced strips
            rows_b = -(-h // -(-h // rows))         # balanced bands
            smem = ffn_fused_smem(rows_b, cols, c, hc)
            if smem > SMEM_LIMIT:
                continue
            tiles = b * -(-h // rows_b) * -(-w // cols)
            for splits in range(1, nchunks + 1):
                per = -(-nchunks // splits)
                splits = -(-nchunks // per)
                waves = -(-tiles * splits // sms)
                cost = waves * _block_cycles(rows_b, cols, c, hc, per)
                if splits > 1:
                    cost += (2 * splits * 4 + 6) * m * c * _CYCLES_PER_BYTE + _PASS_CYCLES
                key = (cost, _prow(rows_b, cols), -rows_b)
                if best is None or key < best[0]:
                    best = (key, FfnPlan(rows_b, cols, hc, splits, per, smem))
                if tiles * splits >= 4 * sms:
                    break
    require(best is not None, "ffn_fused", lambda: f"no tile of C={c} fits {SMEM_LIMIT} bytes")
    return best[1]


def ffn_fused_tiles(b: int, h: int, w: int, plan: FfnPlan) -> list:
    """(frame, rows [i0, i1), columns [j0, j1)) of each tile in the order of
    the kernel's block index (the split aside)."""
    th, tw = -(-h // plan.rows), -(-w // plan.cols)
    out = []
    for t in range(b * th * tw):
        tj, ti, f = t % tw, (t // tw) % th, t // (tw * th)
        i0, j0 = ti * plan.rows, tj * plan.cols
        out.append((f, i0, min(h, i0 + plan.rows), j0, min(w, j0 + plan.cols)))
    return out


def ffn_fused_fits(c: int, ch: int) -> bool:
    """Whether the launch takes widths c, ch (any H, W ≥ 1)."""
    return c % 8 == 0 and ch % 8 == 0 and 0 < c <= 512 and ch > 0


def ffn_fused_launch(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                     w1: torch.Tensor, b1: torch.Tensor, kdw: torch.Tensor, bdw: torch.Tensor,
                     w2: torch.Tensor, b2: torch.Tensor, eps: float,
                     res: torch.Tensor | None, op: str,
                     plan: FfnPlan | None = None,
                     scale: torch.Tensor | None = None) -> torch.Tensor:
    """out (M, C) bf16 = [res] + [scale]·FFN([LN](x)) on the card; x (B, H,
    W, C) bf16 or f32, contiguous; gamma and beta (C,), or both None (no
    LayerNorm); res (M, C) bf16 or f32, or None; scale (B,) per frame, or
    None. ``plan`` replaces ``ffn_fused_plan``'s (the card tests force splits
    and ragged tiles)."""
    require(x.dim() == 4 and x.dtype in (_BF16, _F32) and x.is_cuda, op,
            lambda: f"FFN input {x.dtype} {tuple(x.shape)} on {x.device} (bf16 or f32 NHWC)")
    b, h, w, c = x.shape
    ch = w1.shape[1]
    require(ffn_fused_fits(c, ch) and h >= 1 and w >= 1, op,
            lambda: f"FFN of C={c}, Ch={ch} at {h}x{w} (C, Ch multiples of 8, C <= 512)")
    require(tuple(w1.shape) == (c, ch) and tuple(w2.shape) == (ch, c)
            and kdw.numel() == 9 * ch, op,
            lambda: f"W1 {tuple(w1.shape)}, W2 {tuple(w2.shape)}, kdw {tuple(kdw.shape)}")
    m = b * h * w
    dev = x.device
    res_kind = 0
    if res is not None:
        require(tuple(res.shape) == (m, c), op, lambda: f"residual {tuple(res.shape)}")
        res_kind = {_BF16: 1, _F32: 2}[res.dtype]
    # the operands in the kernel's dtypes, held until the launch is queued: a
    # converted copy freed earlier could be handed to the next allocation
    require((gamma is None) == (beta is None), op, "gamma and beta: both or neither")
    f32 = lambda t: None if t is None else t.to(device=dev, dtype=_F32).contiguous()
    bf = lambda t: t.to(device=dev, dtype=_BF16).contiguous()
    held = (f32(gamma), f32(beta), bf(w1), f32(b1), f32(kdw.reshape(9, ch)), f32(bdw), bf(w2),
            f32(b2))
    if scale is not None:
        require(tuple(scale.shape) == (b,), op, lambda: f"branch scale {tuple(scale.shape)}")
        scale = f32(scale)
    if plan is None:
        plan = ffn_fused_plan(b, h, w, c, ch, sm_count(x))
    out = torch.empty((m, c), device=dev, dtype=_BF16)
    part = (torch.empty((plan.splits, m, c), device=dev, dtype=_F32) if plan.splits > 1
            else None)
    devi, stream = stream_of(x)
    rc = _build.library("ffn_fused").ffn_fused(
        ptr(x, op), *(ptr(t, op) for t in held), ptr(scale, op), ptr(res, op), ptr(out, op),
        ptr(part, op),
        b, h, w, c, ch, int(x.dtype == _F32), res_kind, plan.rows, plan.cols, plan.hc,
        plan.splits, plan.chunks, eps, devi, stream)
    _build.check(rc, op)
    return out
