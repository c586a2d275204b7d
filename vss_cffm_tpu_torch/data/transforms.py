"""Clip preprocessing: eval transforms as tensor operations on the device,
train transforms as host numpy on uint8 BGR frames.

**Eval.** 
The port's own copy of the JAX package's eval pipeline
(``vss_cffm_tpu/data/transforms.py``): keep-ratio rescale of every frame to
fit ``img_scale`` (mmcv ``imrescale``), a second rescale of both sides up to
multiples of 32 (``AlignedResize_clips``), then BGR→RGB and
(x − mean) / std with the mmcv ImageNet statistics.

One difference, by design: the JAX package resizes uint8 frames with cv2's
fixed-point ``INTER_LINEAR`` and rounds back to uint8; here frames are
resized as f32 with ``F.interpolate`` (bilinear, half-pixel centres, no
antialias) and not rounded. The two agree up to that rounding, and exactly
when a resize is the identity.

**Train.** The live ``*_clips`` pipeline of the reference
(``mmseg/datasets/pipelines/transforms.py``) as pure functions on frame
lists with an explicit ``numpy.random.RandomState``, drawing in the JAX
package's order: one draw a clip for scale, crop and flip
(``Resize(process_clips=True)`` ``:475``, ``RandomCrop_clips`` ``:1524``,
``RandomFlip_clips`` ``:852``) and draws re-rolled a frame for the
photometric distortion (``:2114-2137``). The JAX package runs them through
cv2; the port has no cv2 and gives its bits with int32 / f32 numpy, after
the recipes of ``vss_cffm_tpu/native/dataloader.cpp``:

- bilinear resize: cv2's fixed-point ``INTER_LINEAR`` (11-bit weights, the
  x taps clamped at the borders, the y taps clamped only when fetched, the
  vertical sum rounded as cv2's SIMD path rounds), computed for a window of
  the resized image only (``resize_window``);
- nearest resize: ``floor(x · src / dst)``, clamped (``label_window``);
- BGR→HSV: cv2's fixed-point kernel with its ``hsv_shift`` 12 division
  tables; HSV→BGR: cv2's f32 sector kernel, whose cast truncates in the
  32-pixel blocks of a row and rounds half to even in the row's tail;
- brightness and contrast: the f32 table of ``transforms._convert``,
  truncated to uint8.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["IMG_MEAN", "IMG_STD", "rescale_size", "aligned_size", "aligned_resize_clip",
           "normalize_clip", "resize_window", "label_window", "imrescale",
           "random_scale_clip", "sample_crop_box", "sample_crop_box_windowed",
           "random_crop_clip", "random_flip_clip",
           "bgr2hsv", "hsv2bgr", "pmd_apply", "draw_pmd_params",
           "photometric_distortion_clip", "pad_clip"]

IMG_MEAN = (123.675, 116.28, 103.53)
IMG_STD = (58.395, 57.12, 57.375)


def rescale_size(hw: tuple[int, int], scale: tuple[int, int]) -> tuple[int, int]:
    """mmcv ``rescale_size``: (h, w) fit into (long, short), ratio kept."""
    h, w = hw
    f = min(max(scale) / max(h, w), min(scale) / min(h, w))
    return int(h * f + 0.5), int(w * f + 0.5)


def aligned_size(hw: tuple[int, int], size_divisor: int = 32) -> tuple[int, int]:
    return (int(math.ceil(hw[0] / size_divisor)) * size_divisor,
            int(math.ceil(hw[1] / size_divisor)) * size_divisor)


def _resize(frames: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    if tuple(frames.shape[1:3]) == tuple(hw):
        return frames
    out = F.interpolate(frames.permute(0, 3, 1, 2), size=hw, mode="bilinear",
                        align_corners=False)
    return out.permute(0, 2, 3, 1)


def aligned_resize_clip(frames: torch.Tensor, img_scale: tuple[int, int] = (853, 480),
                        size_divisor: int = 32) -> torch.Tensor:
    """frames (T, H, W, 3) → f32 (T, H', W', 3), H' and W' multiples of 32."""
    x = frames.float()
    x = _resize(x, rescale_size(tuple(x.shape[1:3]), img_scale))
    return _resize(x, aligned_size(tuple(x.shape[1:3]), size_divisor))


@functools.lru_cache(maxsize=None)
def _stats(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """mean and std on ``device``, copied there once: a copy from host memory
    synchronises the stream, so it is kept off the per-clip path."""
    return (torch.tensor(IMG_MEAN, dtype=torch.float32, device=device),
            torch.tensor(IMG_STD, dtype=torch.float32, device=device))


def normalize_clip(frames: torch.Tensor, to_rgb: bool = True) -> torch.Tensor:
    """mmcv ``imnormalize``: optional BGR→RGB, then (x − mean) / std, f32."""
    x = frames.float()
    if to_rgb:
        x = x.flip(-1)
    mean, std = _stats(x.device)
    return (x - mean) / std


# ---------------------------------------------------------------------------
# Train side: host numpy on uint8 BGR frames.
# ---------------------------------------------------------------------------


def _lin_coeffs(slen: int, dlen: int, o0: int, n: int, clamp_frac: bool):
    """cv2's bilinear taps of output positions [o0, o0 + n) of a resize from
    ``slen`` to ``dlen``: (first source index, weight 0, weight 1), weights in
    units of 1/2048. The x taps zero the fraction at the borders
    (``clamp_frac``); the y taps keep it and clamp the rows when fetched."""
    scale = 1.0 / (dlen / slen)  # as cv2: 1 / inv_scale, in double
    f = ((np.arange(o0, o0 + n, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    if clamp_frac:
        f = np.where((s < 0) | (s >= slen - 1), np.float32(0), f)
        s = np.clip(s, 0, slen - 1)
    a0 = np.rint((np.float32(1) - f) * np.float32(2048)).astype(np.int32)
    a1 = np.rint(f * np.float32(2048)).astype(np.int32)
    return s, a0, a1


def resize_window(img: np.ndarray, rh: int, rw: int, y1: int, x1: int, vh: int,
                  vw: int) -> np.ndarray:
    """Rows [y1, y1 + vh) and columns [x1, x1 + vw) of ``cv2.resize(img, (rw,
    rh), interpolation=INTER_LINEAR)`` for an (H, W, C) or (H, W) uint8
    image, bit for bit, without the rest of the resized image."""
    sh, sw = img.shape[:2]
    src = img if img.ndim == 3 else img[..., None]
    xs, a0, a1 = _lin_coeffs(sw, rw, x1, vw, True)
    ys, b0, b1 = _lin_coeffs(sh, rh, y1, vh, False)
    r0, r1 = np.clip(ys, 0, sh - 1), np.clip(ys + 1, 0, sh - 1)
    rows, inv = np.unique(np.concatenate([r0, r1]), return_inverse=True)
    band = src[rows].astype(np.int32)
    hz = (band[:, xs] * a0[None, :, None]
          + band[:, np.minimum(xs + 1, sw - 1)] * a1[None, :, None])
    h0, h1 = hz[inv[:vh]], hz[inv[vh:]]
    v = (((b0[:, None, None] * (h0 >> 4)) >> 16)
         + ((b1[:, None, None] * (h1 >> 4)) >> 16))
    out = ((v + 2) >> 2).astype(np.uint8)
    return out if img.ndim == 3 else out[..., 0]


def label_window(seg: np.ndarray, rh: int, rw: int, y1: int, x1: int, vh: int,
                 vw: int) -> np.ndarray:
    """The same window of ``cv2.resize(seg, (rw, rh), interpolation=
    INTER_NEAREST)``: source index floor(x · src / dst), clamped."""
    sh, sw = seg.shape[:2]
    ify, ifx = 1.0 / (rh / sh), 1.0 / (rw / sw)
    ys = np.minimum(np.floor(np.arange(y1, y1 + vh) * ify).astype(np.int64), sh - 1)
    xs = np.minimum(np.floor(np.arange(x1, x1 + vw) * ifx).astype(np.int64), sw - 1)
    return seg[ys[:, None], xs[None, :]]


def imrescale(img: np.ndarray, scale: tuple[int, int], nearest: bool = False) -> np.ndarray:
    """mmcv ``imrescale``: the ratio-keeping resize that fits (long, short),
    bilinear or nearest, with cv2's bits."""
    rh, rw = rescale_size(img.shape[:2], scale)
    resize = label_window if nearest else resize_window
    return resize(img, rh, rw, 0, 0, rh, rw)


def draw_scale(rng: np.random.RandomState, img_scale: tuple[int, int] = (853, 480),
               ratio_range: tuple[float, float] = (0.5, 2.0)) -> tuple[int, int]:
    """The clip's one ratio draw of ``Resize(img_scale, ratio_range)``."""
    lo, hi = ratio_range
    ratio = rng.random_sample() * (hi - lo) + lo
    return int(img_scale[0] * ratio), int(img_scale[1] * ratio)


def random_scale_clip(imgs: list[np.ndarray], segs: list[np.ndarray] | None,
                      rng: np.random.RandomState, img_scale: tuple[int, int] = (853, 480),
                      ratio_range: tuple[float, float] = (0.5, 2.0)):
    """``Resize(img_scale, ratio_range, process_clips=True)``: one ratio for
    every frame of the clip (ratio-keeping rescale)."""
    scale = draw_scale(rng, img_scale, ratio_range)
    imgs = [imrescale(im, scale) for im in imgs]
    if segs is not None:
        segs = [imrescale(s, scale, nearest=True) for s in segs]
    return imgs, segs


def sample_crop_box_windowed(h: int, w: int, window_fn, rng: np.random.RandomState,
                             crop_size: tuple[int, int] = (480, 480),
                             cat_max_ratio: float = 0.75,
                             ignore_index: int = 255) -> tuple[int, int, int, int]:
    """The crop box of ``RandomCrop_clips`` (reference ``:1566-1579``) on a
    virtual (h, w) label plane, whose windows ``window_fn(y1, y2, x1, x2)``
    gives (bounds clamped to the plane): redrawn up to 10 times while one
    class covers ``cat_max_ratio`` or more of the box's labelled pixels. The
    native train item reads the windows straight from the unresized last
    label (``native.label_window``), with the same draws."""
    ch, cw = crop_size

    def sample_box():
        oy = rng.randint(0, max(h - ch, 0) + 1)
        ox = rng.randint(0, max(w - cw, 0) + 1)
        return oy, oy + ch, ox, ox + cw

    def label_counts(seg_tmp):
        if seg_tmp.dtype == np.uint8:
            cnt = np.bincount(seg_tmp.ravel(), minlength=256)
            if 0 <= ignore_index < 256:
                cnt[ignore_index] = 0
            return cnt[cnt > 0]
        labels, cnt = np.unique(seg_tmp, return_counts=True)
        return cnt[labels != ignore_index]

    box = sample_box()
    if cat_max_ratio < 1.0:
        for _ in range(10):
            y1, y2, x1, x2 = box
            cnt = label_counts(window_fn(y1, min(y2, h), x1, min(x2, w)))
            if len(cnt) > 1 and cnt.max() / cnt.sum() < cat_max_ratio:
                break
            box = sample_box()
    return box


def sample_crop_box(seg_last: np.ndarray, rng: np.random.RandomState,
                    crop_size: tuple[int, int] = (480, 480), cat_max_ratio: float = 0.75,
                    ignore_index: int = 255) -> tuple[int, int, int, int]:
    """``sample_crop_box_windowed`` on the clip's (resized) last label."""
    h, w = seg_last.shape[:2]
    return sample_crop_box_windowed(h, w, lambda y1, y2, x1, x2: seg_last[y1:y2, x1:x2], rng,
                                    crop_size, cat_max_ratio, ignore_index)


def random_crop_clip(imgs: list[np.ndarray], segs: list[np.ndarray],
                     rng: np.random.RandomState, crop_size: tuple[int, int] = (480, 480),
                     cat_max_ratio: float = 0.75, ignore_index: int = 255):
    """One crop box for the whole clip (``sample_crop_box``)."""
    y1, y2, x1, x2 = sample_crop_box(segs[-1], rng, crop_size, cat_max_ratio, ignore_index)
    return [im[y1:y2, x1:x2] for im in imgs], [s[y1:y2, x1:x2] for s in segs]


def random_flip_clip(imgs: list[np.ndarray], segs: list[np.ndarray] | None,
                     rng: np.random.RandomState, prob: float = 0.5):
    """One horizontal-flip draw for the clip; returns (imgs, segs, flipped)."""
    flip = rng.rand() < prob
    if flip:
        imgs = [np.ascontiguousarray(im[:, ::-1]) for im in imgs]
        if segs is not None:
            segs = [np.ascontiguousarray(s[:, ::-1]) for s in segs]
    return imgs, segs, flip


def _convert_lut(alpha: float = 1.0, beta: float = 0.0) -> np.ndarray:
    """``transforms._convert`` as a table: clip(f32(i)·alpha + beta, 0, 255),
    truncated to uint8."""
    v = np.arange(256, dtype=np.float32) * np.float32(alpha) + np.float32(beta)
    return np.clip(v, 0, 255).astype(np.uint8)


_HSV_SHIFT = 12


@functools.lru_cache(maxsize=None)
def _hsv_tables():
    """cv2's tables: the BGR→HSV divisions (rounded half to even, as
    ``saturate_cast``), and for HSV→BGR each (h, s) byte pair's sector, the
    fraction's factors ``1 − s`` and, rounded once as ``fmaf`` rounds them,
    ``1 − s·f`` and ``1 − s·(1 − f)``."""
    i = np.arange(1, 256, dtype=np.float64)
    sdiv = np.concatenate([[0], np.rint((255 << _HSV_SHIFT) / i)]).astype(np.int32)
    hdiv = np.concatenate([[0], np.rint((180 << _HSV_SHIFT) / (6.0 * i))]).astype(np.int32)
    h = np.arange(256, dtype=np.float32) * (np.float32(6.0) / np.float32(180.0))
    sector = np.floor(h).astype(np.int64)
    f = h - sector.astype(np.float32)
    s = np.arange(256, dtype=np.float32) * (np.float32(1.0) / np.float32(255.0))
    # s·f is exact in f64 (24 + 24 bits) and 1 − s·f then rounds once more
    # before f32: over these 256 × 256 pairs that equals one rounding (a
    # test holds the tables against the exact rational values)
    sf = s[None, :].astype(np.float64) * f[:, None].astype(np.float64)
    sg = s[None, :].astype(np.float64) * (np.float32(1.0) - f)[:, None].astype(np.float64)
    one_s = np.broadcast_to(np.float32(1.0) - s, (256, 256))
    factors = np.stack([np.ones((256, 256), np.float32), one_s,
                        (1.0 - sf).astype(np.float32), (1.0 - sg).astype(np.float32)])
    return sdiv, hdiv, sector % 6, factors


_SECTOR_TAPS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def bgr2hsv(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_BGR2HSV)`` of uint8 BGR (H in [0, 180))."""
    sdiv, hdiv, _, _ = _hsv_tables()
    x = img.astype(np.int32)
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * sdiv[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * hdiv[diff] + half) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], -1).astype(np.uint8)


def hsv2bgr(hsv: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)`` of an (H, W, 3) uint8 image:
    v · factor(h, s) · 255 in f32, truncated in the 32-pixel blocks of each
    row and rounded half to even in the row's tail, as cv2's kernel
    dispatches."""
    _, _, sector, factors = _hsv_tables()
    hb, sb = hsv[..., 0].astype(np.intp), hsv[..., 1].astype(np.intp)
    v = hsv[..., 2].astype(np.float32) * (np.float32(1.0) / np.float32(255.0))
    taps = _SECTOR_TAPS[sector[hb]]                       # (H, W, 3) factor index
    x = v[..., None] * factors[taps, hb[..., None], sb[..., None]]
    x = x * np.float32(255.0)
    vec = x.shape[1] & ~31
    out = np.empty(x.shape, np.uint8)
    out[:, :vec] = np.clip(x[:, :vec], 0, 255).astype(np.uint8)
    out[:, vec:] = np.clip(np.rint(x[:, vec:]), 0, 255).astype(np.uint8)
    return out


def draw_pmd_params(rng: np.random.RandomState, brightness_delta: int = 32,
                    contrast_range: tuple[float, float] = (0.5, 1.5),
                    saturation_range: tuple[float, float] = (0.5, 1.5),
                    hue_delta: int = 18) -> np.ndarray:
    """One frame's photometric-distortion draws, in the reference's order
    (contrast before HSV in mode 1, after it in mode 0; a coin flip skips a
    step's value): ``[bright?, beta, contrast_pre?, alpha1, sat?, sat_alpha,
    hue?, hue_delta, contrast_post?, alpha2]`` as f32, flags 1 / 0."""
    p = np.zeros(10, np.float32)
    if rng.randint(2):
        p[0], p[1] = 1.0, rng.uniform(-brightness_delta, brightness_delta)
    mode = rng.randint(2)
    if mode == 1 and rng.randint(2):
        p[2], p[3] = 1.0, rng.uniform(*contrast_range)
    if rng.randint(2):
        p[4], p[5] = 1.0, rng.uniform(*saturation_range)
    if rng.randint(2):
        p[6], p[7] = 1.0, rng.randint(-hue_delta, hue_delta)
    if mode == 0 and rng.randint(2):
        p[8], p[9] = 1.0, rng.uniform(*contrast_range)
    return p


def pmd_apply(img: np.ndarray, p: np.ndarray) -> np.ndarray:
    """The photometric distortion of one uint8 BGR frame with the draws ``p``
    of ``draw_pmd_params``: brightness, contrast (mode 1), saturation and hue
    each through a BGR→HSV→BGR round trip, contrast (mode 0)."""
    if p[0]:
        img = _convert_lut(beta=p[1])[img]
    if p[2]:
        img = _convert_lut(alpha=p[3])[img]
    if p[4]:
        hsv = bgr2hsv(img)
        hsv[..., 1] = _convert_lut(alpha=p[5])[hsv[..., 1]]
        img = hsv2bgr(hsv)
    if p[6]:
        hsv = bgr2hsv(img)
        hsv[..., 0] = ((np.arange(256) + int(p[7])) % 180).astype(np.uint8)[hsv[..., 0]]
        img = hsv2bgr(hsv)
    if p[8]:
        img = _convert_lut(alpha=p[9])[img]
    return img


def photometric_distortion_clip(imgs: list[np.ndarray], rng: np.random.RandomState,
                                **kw) -> list[np.ndarray]:
    """Brightness / contrast / saturation / hue jitter, drawn anew for each
    frame (reference ``PhotoMetricDistortion_clips.__call__:2114-2137``)."""
    return [pmd_apply(im, draw_pmd_params(rng, **kw)) for im in imgs]


def pad_clip(imgs: list[np.ndarray], segs: list[np.ndarray] | None, size: tuple[int, int],
             pad_val: float = 0.0, seg_pad_val: int = 255):
    """Bottom / right pad to ``size`` (``Pad_clips``, reference ``:990``)."""
    th, tw = size

    def pad(im, val):
        ph, pw = max(th - im.shape[0], 0), max(tw - im.shape[1], 0)
        if ph == 0 and pw == 0:
            return im
        return np.pad(im, [(0, ph), (0, pw)] + [(0, 0)] * (im.ndim - 2), constant_values=val)

    imgs = [pad(im, pad_val) for im in imgs]
    if segs is not None:
        segs = [pad(s, seg_pad_val) for s in segs]
    return imgs, segs
