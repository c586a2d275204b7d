"""CFFM cross-frame focal decoder, channels-last.

Port of ``vss_cffm_tpu/models/cffm_transformer.py``. One block takes a
(B, T, H, W, C) clip of 1/8-resolution features, pools each frame into coarse
focal windows and lets every 7×7 window of the target (last) frame attend to
its own 49 tokens, 132 neighbours reached by four diagonal circular rolls,
pooled windows of the target frame and pooled windows of each reference
frame (coarser with temporal distance), with four families of learned
relative-position biases and additive −100 padding masks. Residual and MLP
update the last frame only. ``forward(x, train=True, generator=g)`` adds the
config's stochastic depth; dropout and attention dropout are 0 in every
CFFM config and are not ported (a rate > 0 raises). With
``use_checkpoint`` each block runs under ``torch.utils.checkpoint`` (JAX:
``nn.remat``) and is recomputed in the backward, with the same drop-path
masks (``_checkpointed``).

The roll / unfold / mask geometry is a set of static numpy index tables per
(H, W) (``build_geometry``, a copy of the JAX package's); the attention itself
goes through ``ops.cfm_attention``. Parameter names follow the reference
PyTorch module (``attn.relative_position_bias_table_to_neighbors`` of shape
(1, nh, 49, n), ``pool_layers.0.weight``, ...).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..config import CFFMDecoderConfig
from ..ops import cfm_attention, resize_bilinear
from ..parallel import DrawShard
from .mit import derived, drop_path, layer_norm, linear

__all__ = ["CFFMDecoder", "CFFMBlock", "CFFMWindowAttention", "build_geometry",
           "CFFMGeometry"]


# ---------------------------------------------------------------------------
# Static geometry: gather indices + masks, computed in numpy per (H, W).
# ---------------------------------------------------------------------------


def _window_index(hp: int, wp: int, ws: int) -> np.ndarray:
    """(nW, ws*ws) flat indices into hp*wp selecting each window's pixels."""
    rows = np.arange(hp).reshape(hp // ws, ws)
    cols = np.arange(wp).reshape(wp // ws, ws)
    r = rows[:, None, :, None]
    c = cols[None, :, None, :]
    idx = r * wp + c
    return idx.reshape(-1, ws * ws)


def _roll_masks(ws: int, expand: int) -> list[np.ndarray]:
    """Kept positions of the tl, tr, bl, br rolled windows (reference
    ``valid_ind_rolled``)."""
    e = expand
    masks = []
    for name in ("tl", "tr", "bl", "br"):
        m = np.ones((ws, ws), bool)
        if name == "tl":
            m[:-e, :-e] = False
        elif name == "tr":
            m[:-e, e:] = False
        elif name == "bl":
            m[e:, :-e] = False
        else:
            m[e:, e:] = False
        masks.append(m.reshape(-1))
    return masks


def _rolled_index(hp: int, wp: int, ws: int, expand: int) -> np.ndarray:
    """(nW, n_valid) wrapped absolute positions of the 4 diagonal rolls."""
    shifts = [(-expand, -expand), (-expand, expand), (expand, -expand), (expand, expand)]
    win = _window_index(hp, wp, ws)
    wr, wc = win // wp, win % wp
    per_roll = []
    for (sr, sc), m in zip(shifts, _roll_masks(ws, expand)):
        rr = (wr - sr) % hp
        cc = (wc - sc) % wp
        per_roll.append((rr * wp + cc)[:, m])
    return np.concatenate(per_roll, axis=1)


def _unfold_index(map_h: int, map_w: int, kernel: int, stride: int, pad: int,
                  valid_keep: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """``nn.Unfold`` positions (nOut, n_entries), clamped where out of
    bounds, and the additive 0 / −100 mask of the padded entries; entries
    with di or dj < valid_keep are dropped."""
    out_h = (map_h + 2 * pad - kernel) // stride + 1
    out_w = (map_w + 2 * pad - kernel) // stride + 1
    di = np.arange(kernel)
    dj = np.arange(kernel)
    if valid_keep > 0:
        keep = (di[:, None] >= valid_keep) & (dj[None, :] >= valid_keep)
    else:
        keep = np.ones((kernel, kernel), bool)
    oi = np.arange(out_h) * stride - pad
    oj = np.arange(out_w) * stride - pad
    rows = oi[:, None] + di[None, :]
    cols = oj[:, None] + dj[None, :]
    rv = (rows >= 0) & (rows < map_h)
    cv = (cols >= 0) & (cols < map_w)
    rows_c = np.clip(rows, 0, map_h - 1)
    cols_c = np.clip(cols, 0, map_w - 1)
    pos = rows_c[:, None, :, None] * map_w + cols_c[None, :, None, :]
    valid = rv[:, None, :, None] & cv[None, :, None, :]
    pos = pos.reshape(out_h * out_w, kernel * kernel)[:, keep.reshape(-1)]
    valid = valid.reshape(out_h * out_w, kernel * kernel)[:, keep.reshape(-1)]
    mask = np.where(valid, 0.0, -100.0).astype(np.float32)
    return pos, mask


def _relative_position_index(q_hw: tuple[int, int], k_hw: tuple[int, int]) -> np.ndarray:
    """Reference ``get_relative_position_index``."""
    qh, qw = q_hw
    kh, kw = k_hw
    cq = np.stack(np.meshgrid(np.arange(qh), np.arange(qw), indexing="ij"), 0).reshape(2, -1)
    ck = np.stack(np.meshgrid(np.arange(kh), np.arange(kw), indexing="ij"), 0).reshape(2, -1)
    rel = cq[:, :, None] - ck[:, None, :]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += kh - 1
    rel[:, :, 1] += kw - 1
    rel[:, :, 0] *= qw + kw - 1
    return rel.sum(-1)


def _rolled_valid_subset(ws: int, expand: int) -> np.ndarray:
    """Indices into the concatenated 4×ws² rolled-window axis, in the
    reference's (tl, tr, bl, br) order."""
    return np.concatenate([r * ws * ws + np.nonzero(m)[0]
                           for r, m in enumerate(_roll_masks(ws, expand))])


@dataclasses.dataclass(frozen=True)
class _PooledLevel:
    """Geometry of one pooled K/V source (target focal level or clip level)."""

    pool_window: int
    pooled_hw: tuple[int, int]
    resize_hw: tuple[int, int] | None
    trim_pad: tuple[int, int, int, int] | None  # (top, bottom, left, right); +pad / −trim
    unfold_idx: np.ndarray
    unfold_mask: np.ndarray
    bias_index: np.ndarray
    bias_table_size: int
    kernel: int
    stride: int
    valid_keep: int = 0


@dataclasses.dataclass(frozen=True)
class CFFMGeometry:
    h0: int
    w0: int
    hp: int
    wp: int
    n_wh: int
    n_ww: int
    win_idx: np.ndarray
    rolled_idx: np.ndarray
    win_bias_index: np.ndarray
    target_levels: tuple[_PooledLevel, ...]
    clip_levels: tuple[_PooledLevel, ...]

    @property
    def num_windows(self) -> int:
        return self.n_wh * self.n_ww


def _trim_pad(cur: int, tgt: int) -> tuple[int, int]:
    if cur > tgt:
        t = (cur - tgt) // 2
        return (-t, -(cur - tgt - t))
    if cur < tgt:
        p = (tgt - cur) // 2
        return (p, tgt - cur - p)
    return (0, 0)


@functools.lru_cache(maxsize=64)
def build_geometry(h0: int, w0: int, window_size: int = 7, expand_size: int = 3,
                   focal_window: int = 5, focal_level: int = 2,
                   focal_l_clips: tuple[int, ...] = (1, 2, 3),
                   focal_kernel_clips: tuple[int, ...] = (7, 5, 3)) -> CFFMGeometry:
    ws = window_size
    hp = math.ceil(h0 / ws) * ws
    wp = math.ceil(w0 / ws) * ws
    n_wh, n_ww = hp // ws, wp // ws

    target_levels = []
    for k in range(focal_level - 1):
        stride = 2**k
        pool_window = ws // stride
        ph, pw = n_wh * stride, n_ww * stride
        (tt, tb), (tl, tr) = _trim_pad(hp, ph * pool_window), _trim_pad(wp, pw * pool_window)
        trim_pad = None if (tt, tb, tl, tr) == (0, 0, 0, 0) else (tt, tb, tl, tr)
        kernel = 2 * (focal_window // 2) + 2**k + (2**k - 1)
        idx, mask = _unfold_index(ph, pw, kernel, stride, kernel // 2, valid_keep=2**k - 1)
        kk = focal_window + 2**k - 1
        target_levels.append(_PooledLevel(
            pool_window=pool_window, pooled_hw=(ph, pw), resize_hw=None, trim_pad=trim_pad,
            unfold_idx=idx, unfold_mask=mask,
            bias_index=_relative_position_index((ws, ws), (kk, kk)),
            bias_table_size=(ws + kk - 1) ** 2, kernel=kernel, stride=stride,
            valid_keep=2**k - 1))

    clip_levels = []
    for k, fl in enumerate(focal_l_clips):
        if fl > ws:
            raise ValueError("focal_l_clips entries must not exceed window_size")
        pool_window = ws // fl
        ph, pw = n_wh * fl, n_ww * fl
        h_pool, w_pool = ph * pool_window, pw * pool_window
        kernel = focal_kernel_clips[k]
        if kernel % 2 != 1:
            raise ValueError("focal_kernel_clips entries must be odd")
        idx, mask = _unfold_index(ph, pw, kernel, fl, kernel // 2)
        clip_levels.append(_PooledLevel(
            pool_window=pool_window, pooled_hw=(ph, pw),
            resize_hw=None if (h_pool, w_pool) == (hp, wp) else (h_pool, w_pool),
            trim_pad=None, unfold_idx=idx, unfold_mask=mask,
            bias_index=_relative_position_index((ws, ws), (kernel, kernel)),
            bias_table_size=(ws + kernel - 1) ** 2, kernel=kernel, stride=fl))

    return CFFMGeometry(
        h0=h0, w0=w0, hp=hp, wp=wp, n_wh=n_wh, n_ww=n_ww,
        win_idx=_window_index(hp, wp, ws),
        rolled_idx=_rolled_index(hp, wp, ws, expand_size),
        win_bias_index=_relative_position_index((ws, ws), (ws, ws)),
        target_levels=tuple(target_levels), clip_levels=tuple(clip_levels))


def _geometry(cfg: CFFMDecoderConfig, h0: int, w0: int) -> CFFMGeometry:
    return build_geometry(h0, w0, cfg.window_size, cfg.expand_size, cfg.focal_window,
                          cfg.focal_level, tuple(cfg.focal_l_clips),
                          tuple(cfg.focal_kernel_clips))


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


def _partition_windows(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, Hp, Wp, C) -> (B, nW, ws*ws, C)."""
    b, hp, wp, c = x.shape
    x = x.reshape(b, hp // ws, ws, wp // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, (hp // ws) * (wp // ws), ws * ws, c)


class _Tables:
    """Device copies of a geometry's index tables, made once per device."""

    def __init__(self):
        self._cache: dict = {}

    def get(self, key, device: torch.device, make) -> torch.Tensor:
        k = (key, str(device))
        t = self._cache.get(k)
        if t is None:
            t = torch.as_tensor(make(), device=device)
            self._cache[k] = t
        return t


def _unfold_patches(x: torch.Tensor, kernel: int, stride: int, pad: int, valid_keep: int,
                    tables: _Tables) -> torch.Tensor:
    """``nn.Unfold`` of (B, H, W, C) as an exact gather: (B, nOut, n_entries, C),
    entries in (di, dj) row-major order, zeros where the window leaves the map."""
    b, h, w, c = x.shape
    key = ("unfold", h, w, kernel, stride, pad, valid_keep)
    np_pos = lambda: _unfold_index(h, w, kernel, stride, pad, valid_keep)
    pos = tables.get(key + ("pos",), x.device, lambda: np_pos()[0].astype(np.int64))
    valid = tables.get(key + ("valid",), x.device, lambda: np_pos()[1] == 0.0)
    out = x.reshape(b, h * w, c)[:, pos.reshape(-1)].reshape(b, *pos.shape, c)
    return torch.where(valid[None, :, :, None], out, torch.zeros((), dtype=x.dtype,
                                                                  device=x.device))


class CFFMWindowAttention(nn.Module):
    """CFM attention of the target frame's windows over all K/V sources."""

    def __init__(self, cfg: CFFMDecoderConfig):
        super().__init__()
        self.cfg = cfg
        c, nh, ws = cfg.dim, cfg.num_heads, cfg.window_size
        area = ws * ws
        self.qkv = nn.Linear(c, 3 * c, bias=cfg.qkv_bias)
        self.proj = nn.Linear(c, c)
        self.relative_position_bias_table = nn.Parameter(torch.zeros((2 * ws - 1) ** 2, nh))
        n_rolled = sum(int(m.sum()) for m in _roll_masks(ws, cfg.expand_size))
        self.relative_position_bias_table_to_neighbors = nn.Parameter(
            torch.zeros(1, nh, area, n_rolled))
        # table sizes depend only on the window/focal settings, not on (H, W)
        sizes = []
        for k in range(cfg.focal_level - 1):
            kk = cfg.focal_window + 2**k - 1
            sizes.append((ws + kk - 1) ** 2)
        self.relative_position_bias_table_to_windows = nn.ParameterList(
            nn.Parameter(torch.zeros(nh, s)) for s in sizes)
        self.relative_position_bias_table_to_windows_clips = nn.ParameterList(
            nn.Parameter(torch.zeros(nh, (ws + kc - 1) ** 2)) for kc in cfg.focal_kernel_clips)
        self.compute_dtype = torch.float32
        self.force: str | None = None
        self._tables = _Tables()

    def _bias(self, geom: CFFMGeometry, device: torch.device) -> torch.Tensor:
        """(nh, 49, N) f32: the four bias families, in source-group order,
        gathered once per geometry (``derived``)."""
        tables = (self.relative_position_bias_table,
                  self.relative_position_bias_table_to_neighbors,
                  *self.relative_position_bias_table_to_windows,
                  *self.relative_position_bias_table_to_windows_clips)
        return derived(self, ("bias", geom.h0, geom.w0, str(device)), tables,
                       lambda: self._gather_bias(geom, device))

    def _gather_bias(self, geom: CFFMGeometry, device: torch.device) -> torch.Tensor:
        cfg = self.cfg
        nh, area = cfg.num_heads, cfg.window_size ** 2
        t = self._tables
        win = t.get(("win_bias", cfg.window_size), device,
                    lambda: geom.win_bias_index.reshape(-1).astype(np.int64))
        chunks = [self.relative_position_bias_table[win].reshape(area, area, nh)
                  .permute(2, 0, 1),
                  self.relative_position_bias_table_to_neighbors[0]]
        levels = list(zip(self.relative_position_bias_table_to_windows, geom.target_levels))
        levels += list(zip(self.relative_position_bias_table_to_windows_clips,
                           geom.clip_levels))
        for i, (tbl, level) in enumerate(levels):
            idx = t.get(("level_bias", i, level.kernel), device,
                        lambda lv=level: lv.bias_index.reshape(-1).astype(np.int64))
            chunks.append(tbl[:, idx].reshape(nh, area, -1))
        return torch.cat(chunks, dim=-1).float()

    def attention_inputs(self, x_target: torch.Tensor, pooled_target: Sequence[torch.Tensor],
                         pooled_clips: Sequence[torch.Tensor], geom: CFFMGeometry) -> tuple:
        """Arguments of ``cfm_attention``: window-major q (B·nW, 49, C), the K
        and V source groups, the (nh, 49, N) bias, the (B·nW, N) mask, nh."""
        cfg = self.cfg
        dt = self.compute_dtype
        c, nh, ws = cfg.dim, cfg.num_heads, cfg.window_size
        area = ws * ws
        b = x_target.shape[0]
        dev = x_target.device
        t = self._tables

        q_map, k_map, v_map = linear(x_target, self.qkv, dt).split(c, dim=-1)
        q_win = _partition_windows(q_map, ws)
        valid_rolled = t.get(("rolled", ws, cfg.expand_size), dev,
                             lambda: _rolled_valid_subset(ws, cfg.expand_size))
        e = cfg.expand_size

        def rolled(mp):
            rolls = [_partition_windows(torch.roll(mp, shifts=s, dims=(1, 2)), ws)
                     for s in ((-e, -e), (-e, e), (e, -e), (e, e))]
            return torch.cat(rolls, dim=2)[:, :, valid_rolled]

        k_parts = [_partition_windows(k_map, ws), rolled(k_map)]
        v_parts = [_partition_windows(v_map, ws), rolled(v_map)]
        mask_parts = [np.zeros(geom.win_idx.shape, np.float32),
                      np.zeros(geom.rolled_idx.shape, np.float32)]

        qkv = self.qkv
        kv_params = [p for p in (qkv.weight, qkv.bias) if p is not None]
        w_kv, b_kv = derived(self, ("kv", dt), kv_params, lambda: (
            qkv.weight[c:].to(dt), None if qkv.bias is None else qkv.bias[c:].to(dt)))
        for pooled, level in (list(zip(pooled_target, geom.target_levels))
                              + list(zip(pooled_clips, geom.clip_levels))):
            k_p, v_p = F.linear(pooled.to(dt), w_kv, b_kv).split(c, dim=-1)
            pad = level.kernel // 2 if level.stride <= ws else 0
            k_parts.append(_unfold_patches(k_p, level.kernel, level.stride, pad,
                                           level.valid_keep, t))
            v_parts.append(_unfold_patches(v_p, level.kernel, level.stride, pad,
                                           level.valid_keep, t))
            mask_parts.append(level.unfold_mask)

        n_w = geom.num_windows
        mask = t.get(("mask", geom.h0, geom.w0), dev,
                     lambda: np.concatenate(mask_parts, axis=1))
        return (q_win.reshape(b * n_w, area, c),
                [kp.reshape(b * n_w, kp.shape[2], c) for kp in k_parts],
                [vp.reshape(b * n_w, vp.shape[2], c) for vp in v_parts],
                self._bias(geom, dev), mask.repeat(b, 1), nh)

    def forward(self, x_target: torch.Tensor, pooled_target: Sequence[torch.Tensor],
                pooled_clips: Sequence[torch.Tensor], geom: CFFMGeometry) -> torch.Tensor:
        """(B, nW, 49, C) attention output of the target frame's windows."""
        b = x_target.shape[0]
        out = cfm_attention(*self.attention_inputs(x_target, pooled_target, pooled_clips,
                                                   geom), force=self.force)
        return linear(out.reshape(b, geom.num_windows, -1, self.cfg.dim), self.proj,
                      self.compute_dtype)


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        return linear(F.gelu(linear(x, self.fc1, dt)), self.fc2, dt)


class CFFMBlock(nn.Module):
    """One CFFA + CFM block; updates only the last frame."""

    def __init__(self, cfg: CFFMDecoderConfig):
        super().__init__()
        self.cfg = cfg
        c, ws = cfg.dim, cfg.window_size
        self.norm1 = nn.LayerNorm(c, eps=cfg.norm_eps)
        self.norm2 = nn.LayerNorm(c, eps=cfg.norm_eps)
        self.attn = CFFMWindowAttention(cfg)
        self.mlp = _Mlp(c, int(c * cfg.mlp_ratio))
        self.pool_layers = nn.ModuleList(
            _PoolLinear(ws // 2**k) for k in range(cfg.focal_level - 1))
        self.pool_layers_clips = nn.ModuleList(
            _PoolLinear(ws // fl) for fl in cfg.focal_l_clips)
        self.compute_dtype = torch.float32

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None,
                shard: DrawShard | None = None) -> torch.Tensor:
        """``shard``: where this rank's clips sit in the global drop-path draw
        (``mit.keep_mask``)."""
        cfg = self.cfg
        dt = self.compute_dtype
        rate = cfg.drop_path if train else 0.0
        b, t, h0, w0, c = x.shape
        if t != len(cfg.focal_l_clips) + 1:
            raise ValueError(f"clip length {t}: expected {len(cfg.focal_l_clips) + 1}")
        geom = _geometry(cfg, h0, w0)
        xn = layer_norm(x, self.norm1, dt)
        pad_b, pad_r = geom.hp - h0, geom.wp - w0
        if pad_b or pad_r:
            xn = F.pad(xn, (0, 0, 0, pad_r, 0, pad_b))
        target = xn[:, -1]

        pooled_target = []
        for pool, level in zip(self.pool_layers, geom.target_levels):
            src = target
            if level.trim_pad is not None:
                tt, tb, tl, tr = level.trim_pad
                src = src[:, max(-tt, 0): src.shape[1] - max(-tb, 0)]
                src = src[:, :, max(-tl, 0): src.shape[2] - max(-tr, 0)]
                src = F.pad(src, (0, 0, max(tl, 0), max(tr, 0), max(tt, 0), max(tb, 0)))
            pooled_target.append(pool(src, dt))

        pooled_clips = []
        for k, (pool, level) in enumerate(zip(self.pool_layers_clips, geom.clip_levels)):
            src = xn[:, k]
            if level.resize_hw is not None:
                src = resize_bilinear(src, level.resize_hw)
            pooled_clips.append(pool(src, dt))

        win = self.attn(target, pooled_target, pooled_clips, geom)
        ws = cfg.window_size
        out = win.reshape(b, geom.n_wh, geom.n_ww, ws, ws, c)
        out = out.permute(0, 1, 3, 2, 4, 5).reshape(b, geom.hp, geom.wp, c)[:, :h0, :w0]
        last = x[:, -1] + drop_path(out, rate, generator, shard)
        last = last + drop_path(self.mlp(layer_norm(last, self.norm2, dt), dt), rate, generator,
                                shard)
        return torch.cat([x[:, :-1], last[:, None].to(x.dtype)], dim=1)


class _PoolLinear(nn.Linear):
    """``pool_layers.k``: Linear(pw² → 1) applied as a learned pw×pw pooling."""

    def __init__(self, pool_window: int):
        super().__init__(pool_window * pool_window, 1)
        self.pool_window = pool_window

    def forward(self, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        b, h, w, c = x.shape
        pw = self.pool_window
        x6 = x.to(dt).reshape(b, h // pw, pw, w // pw, pw, c)
        wt, bt = derived(self, ("pool", dt), (self.weight, self.bias), lambda: (
            self.weight.to(dt).reshape(pw, pw), self.bias.to(dt)))
        out = torch.einsum("bipjqc,pq->bijc", x6, wt)
        return out + bt


class CFFMDecoder(nn.Module):
    """Stack of ``depth`` CFFM blocks over a (B, T, H, W, C) clip."""

    def __init__(self, cfg: CFFMDecoderConfig):
        super().__init__()
        if cfg.drop > 0.0 or cfg.attn_drop > 0.0:
            raise NotImplementedError("CFFM decoder dropout (drop / attn_drop > 0) is not "
                                      "ported: it is 0 in every CFFM config")
        self.cfg = cfg
        self.blocks = nn.ModuleList(CFFMBlock(cfg) for _ in range(cfg.depth))

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None,
                shard: DrawShard | None = None) -> torch.Tensor:
        remat = self.cfg.use_checkpoint and torch.is_grad_enabled()
        for blk in self.blocks:
            run = functools.partial(blk, shard=shard)
            x = _checkpointed(run, x, train, generator) if remat else run(x, train, generator)
        return x


def _checkpointed(blk, x: torch.Tensor, train: bool,
                  generator: torch.Generator | None) -> torch.Tensor:
    """``blk(x, train, generator)`` under ``torch.utils.checkpoint``: its
    activations are not kept, and the backward runs the block again.

    ``checkpoint`` restores the global RNG states for the recompute, not a
    ``torch.Generator`` object, which the recompute would draw on from where
    the forward left it: other drop-path masks, wrong gradients. So each run
    of the block draws from a generator of its own, started from the caller's
    state before the block; after the forward the caller's generator takes
    the state that run left, as if the block had drawn from it directly."""
    if generator is None:
        return checkpoint(blk, x, train, None, use_reentrant=False)
    start = generator.get_state()
    ends = []

    def run(x: torch.Tensor) -> torch.Tensor:
        g = torch.Generator(generator.device)
        g.set_state(start)
        out = blk(x, train, g)
        ends.append(g.get_state())
        return out

    out = checkpoint(run, x, use_reentrant=False)
    generator.set_state(ends[0])
    return out
