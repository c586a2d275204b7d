"""The port's native host data path: ``dataloader.cpp`` built by g++ at first
use and bound with ctypes.

The same 14 functions as ``vss_cffm_tpu/native``, on the port's own copy of
its C++ source, with the same arithmetic: bit for bit the numpy pipeline of
``data/transforms.py`` (cv2's bits), in one pass over the crop window. The
source has two halves:

- the **pixel half** (``normalize_f32``, ``resize_window``, ``cvt_hsv``,
  ``pmd_apply``, ``label_window``, ``label_window_rows``) needs no header and
  is always built;
- the **codec half** (``decode_jpeg``, ``jpeg_dims``, ``png_dims``,
  ``decode_label``, ``decode_label_band``, ``train_clip``, ``train_clip_v2``,
  ``decode_clip_normalized``) is compiled only where g++ finds ``jpeglib.h``
  and ``png.h``, and is then linked with ``-ljpeg -lpng16 -lz``.
  ``codecs()`` says which were built; a codec function raises where they
  were not.

**Build.** ``load()`` (and so ``available()``) compiles the library the first
time it is needed, with ``g++`` from ``PATH``, into
``vss_cffm_tpu_torch/_build/`` (listed in ``.gitignore``), named by a hash of
the source, the flags, the codecs and the host's name (``-march=native``): a
changed source rebuilds, an unchanged one is loaded as it is. It is written to a temporary name and renamed into
place, so processes that build at once (test workers, the loader's spawned
workers) never load a half-written file. Without ``g++`` on ``PATH``,
``available()`` is False and the data path is numpy; with ``g++``, a build or
a load that fails raises, with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
import time

import numpy as np

__all__ = ["available", "codecs", "build_info", "load", "decode_jpeg", "normalize_f32",
           "jpeg_dims", "decode_label", "resize_window", "train_clip", "train_clip_v2",
           "pmd_apply", "cvt_hsv", "label_window", "label_window_rows", "decode_label_band",
           "png_dims", "decode_clip_normalized"]

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "dataloader.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(SOURCE)), "_build")
CXX = "g++"
# -ffp-contract=off: each float expression rounds per operation, as numpy and
# cv2 do (the HSV kernel's intended fused multiply-adds are explicit fmaf)
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-ffp-contract=off",
            "-shared")
CODEC_HEADERS = ("jpeglib.h", "png.h")
CODEC_LIBS = ("-ljpeg", "-lpng16", "-lz")

# argument kinds of each C entry point: "p" pointer, "i" int, "l" 64-bit int;
# the return: "i" int, None void
_PIXEL = {
    "vss_normalize_f32": ("pplppi", None),
    "vss_resize_window_u8c3": ("piiiiiiiiipi", None),
    "vss_cvt_hsv_u8": ("ppiii", None),
    "vss_pmd_apply": ("pilp", None),
    "vss_label_window": ("piiiiiiiiiipi", None),
    "vss_label_window_rows": ("iiiipp", None),
}
_CODEC = {
    "vss_decode_jpeg": ("plpii", "i"),
    "vss_jpeg_dims": ("plpp", "i"),
    "vss_png_dims": ("plpp", "i"),
    "vss_decode_label": ("plpiip", "i"),
    "vss_decode_label_band": ("plpiipii", "i"),
    "vss_train_clip": ("ppiiiiiiiiiipi", "i"),
    "vss_train_clip_v2": ("ppiiiiiiiiiippi", "i"),
    "vss_decode_clip_normalized": ("ppiiippipi", "i"),
}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "l": ctypes.c_int64, None: None}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_info: dict | None = None  # set by the first load(): the build's facts


def _has_header(cxx: str, header: str) -> bool:
    src = f"#include <cstdio>\n#include <{header}>\n"
    r = subprocess.run([cxx, "-x", "c++", "-E", "-o", os.devnull, "-"], input=src,
                       capture_output=True, text=True)
    return r.returncode == 0


def _build(cxx: str) -> dict:
    headers = {h: _has_header(cxx, h) for h in CODEC_HEADERS}
    codec_names = ("jpeg", "png") if all(headers.values()) else ()
    flags = [*CXXFLAGS, *(["-DVSS_CODECS"] if codec_names else [])]
    libs = [*(CODEC_LIBS if codec_names else ()), "-lpthread"]
    # -march=native builds for this host's CPU: the host's name is in the hash
    h = hashlib.sha256(" ".join([platform.node(), *flags, *libs]).encode())
    with open(SOURCE, "rb") as fh:
        h.update(fh.read())
    path = os.path.join(BUILD_DIR, f"libvssdata_{h.hexdigest()[:16]}.so")
    seconds = None
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        t0 = time.perf_counter()
        r = subprocess.run([cxx, *flags, SOURCE, "-o", tmp, *libs], capture_output=True,
                           text=True)
        if r.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(f"{cxx} failed to build {SOURCE} (exit {r.returncode}):\n"
                               f"{r.stderr}{r.stdout}")
        os.replace(tmp, path)
        seconds = time.perf_counter() - t0
    return {"compiler": cxx, "headers": headers, "codecs": codec_names, "path": path,
            "build_s": seconds}


def load() -> ctypes.CDLL | None:
    """The loaded library, built first if needed; None where there is no g++."""
    global _lib, _info
    if _info is not None:
        return _lib
    with _lock:
        if _info is None:
            cxx = shutil.which(CXX)
            if cxx is None:
                _info = {"compiler": None, "headers": {}, "codecs": (), "path": None,
                         "build_s": None}
                return None
            info = _build(cxx)
            try:
                lib = ctypes.CDLL(info["path"])
            except OSError as e:
                raise RuntimeError(f"could not load {info['path']}: {e}") from e
            for table in (_PIXEL, _CODEC) if info["codecs"] else (_PIXEL,):
                for name, (args, res) in table.items():
                    fn = getattr(lib, name)
                    fn.argtypes = [_CTYPES[k] for k in args]
                    fn.restype = _CTYPES[res]
            _lib, _info = lib, info
    return _lib


def available() -> bool:
    """True where the library is built (g++ on ``PATH``)."""
    return load() is not None


def codecs() -> tuple[str, ...]:
    """The codecs built into the library: ("jpeg", "png"), or () where the
    host lacks their headers or there is no library."""
    load()
    return _info["codecs"]


def build_info() -> dict:
    """{"compiler" (None without g++), "headers" ({header: found}), "codecs",
    "path" (the library), "build_s" (seconds of this process's build, None
    where the library was already built)}."""
    load()
    return dict(_info)


def _pixel_lib() -> ctypes.CDLL:
    lib = load()
    if lib is None:
        raise RuntimeError("the native library is not available (no g++ on PATH)")
    return lib


def _codec_lib() -> ctypes.CDLL:
    lib = _pixel_lib()
    if not _info["codecs"]:
        raise RuntimeError("the native library was built without its codecs "
                           f"(headers found: {_info['headers']})")
    return lib


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _u8_image(img: np.ndarray, what: str) -> np.ndarray:
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[-1] != 3:
        raise ValueError(f"{what}: expected (H, W, 3) uint8, got {img.shape} {img.dtype}")
    return img


def _window_checked(rh: int, rw: int, y1: int, x1: int, vh: int, vw: int) -> None:
    if not (rh >= 1 and rw >= 1 and vh >= 0 and vw >= 0 and 0 <= y1 and y1 + vh <= rh
            and 0 <= x1 and x1 + vw <= rw):
        raise ValueError(f"window rows [{y1}, {y1 + vh}) cols [{x1}, {x1 + vw}) outside the "
                         f"resized ({rh}, {rw})")


def _buffers(buffers: list[bytes]):
    """ctypes arrays of the buffers' pointers and lengths; the numpy views
    that own the pointers are returned too and must outlive the call."""
    arrays = [np.frombuffer(b, np.uint8) for b in buffers]
    ptrs = (ctypes.c_void_p * len(arrays))(*[_ptr(a) for a in arrays])
    lens = (ctypes.c_int64 * len(arrays))(*[len(b) for b in buffers])
    return arrays, ptrs, lens


def _dims(fn, data: bytes) -> tuple[int, tuple[int, int]]:
    buf = np.frombuffer(data, np.uint8)
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = fn(_ptr(buf), len(data), ctypes.addressof(h), ctypes.addressof(w))
    return rc, (h.value, w.value)


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes → uint8 BGR (H, W, 3), as cv2.imread gives it."""
    lib = _codec_lib()
    h, w = jpeg_dims(data)
    buf = np.frombuffer(data, np.uint8)
    out = np.empty((h, w, 3), np.uint8)
    rc = lib.vss_decode_jpeg(_ptr(buf), len(data), _ptr(out), h, w)
    if rc != 0:
        raise ValueError(f"JPEG decode failed ({rc})")
    return out


def normalize_f32(img: np.ndarray, mean, std, to_rgb: bool = True) -> np.ndarray:
    """uint8 BGR (H, W, 3) → f32 (x − mean) · (1 / std), RGB with ``to_rgb``,
    in one pass (mean and std in the output's channel order)."""
    lib = _pixel_lib()
    img = _u8_image(img, "normalize_f32")
    m = np.ascontiguousarray(mean, np.float32)
    s = np.ascontiguousarray(std, np.float32)
    if m.shape != (3,) or s.shape != (3,):
        raise ValueError("normalize_f32: mean and std take 3 values")
    out = np.empty(img.shape, np.float32)
    lib.vss_normalize_f32(_ptr(img), _ptr(out), img.shape[0] * img.shape[1], _ptr(m), _ptr(s),
                          int(to_rgb))
    return out


def jpeg_dims(data: bytes) -> tuple[int, int]:
    """(height, width) from a JPEG header, without a decode."""
    rc, hw = _dims(_codec_lib().vss_jpeg_dims, data)
    if rc != 0:
        raise ValueError("invalid JPEG header")
    return hw


def decode_label(data: bytes, lut: np.ndarray) -> np.ndarray | None:
    """A palette or gray PNG's index plane → uint8 (H, W) through a 256-entry
    table (``reduce_zero_label`` in the same pass). None for a PNG that the
    native decoder does not take (the caller decodes it with PIL)."""
    lib = _codec_lib()
    lut = np.ascontiguousarray(lut, np.uint8)
    if lut.size != 256:
        raise ValueError("decode_label: the table takes 256 entries")
    rc, (h, w) = _dims(lib.vss_png_dims, data)
    if rc != 0:
        return None
    buf = np.frombuffer(data, np.uint8)
    out = np.empty((h, w), np.uint8)
    rc = lib.vss_decode_label(_ptr(buf), len(data), _ptr(out), h, w, _ptr(lut))
    return out if rc == 0 else None


def resize_window(src: np.ndarray, rh: int, rw: int, y1: int, x1: int, vh: int, vw: int,
                  flip: bool = False) -> np.ndarray:
    """Rows [y1, y1 + vh) and columns [x1, x1 + vw) of cv2's bilinear resize of
    (sh, sw, 3) uint8 to (rh, rw), bit for bit, optionally flipped in the
    window; only the window is computed."""
    lib = _pixel_lib()
    src = _u8_image(src, "resize_window")
    _window_checked(rh, rw, y1, x1, vh, vw)
    out = np.empty((vh, vw, 3), np.uint8)
    lib.vss_resize_window_u8c3(_ptr(src), src.shape[0], src.shape[1], rh, rw, y1, x1, vh, vw,
                               int(flip), _ptr(out), vw)
    return out


def _clip_args(buffers, sh, sw, rh, rw, y1, x1, ch, cw):
    if not buffers or ch < 1 or cw < 1 or sh < 1 or sw < 1:
        raise ValueError("train clip: no frames, or an empty source or crop")
    _window_checked(rh, rw, y1, x1, min(ch, rh - y1), min(cw, rw - x1))
    return _buffers(buffers), np.zeros((len(buffers), ch, cw, 3), np.uint8)


def train_clip(buffers: list[bytes], sh: int, sw: int, rh: int, rw: int, y1: int, x1: int,
               ch: int, cw: int, flip: bool, n_threads: int = 2) -> np.ndarray:
    """A clip's JPEG band decodes → bilinear resize of the crop window → flip,
    threaded over the frames: (N, ch, cw, 3) uint8 BGR, zero outside the
    valid (min(ch, rh − y1), min(cw, rw − x1)) window."""
    lib = _codec_lib()
    (arrays, ptrs, lens), out = _clip_args(buffers, sh, sw, rh, rw, y1, x1, ch, cw)
    rc = lib.vss_train_clip(ptrs, lens, len(arrays), sh, sw, rh, rw, y1, x1, ch, cw, int(flip),
                            _ptr(out), n_threads)
    if rc != 0:
        raise ValueError(f"train clip decode failed ({rc})")
    return out


def train_clip_v2(buffers: list[bytes], sh: int, sw: int, rh: int, rw: int, y1: int, x1: int,
                  ch: int, cw: int, flip: bool, pmd: np.ndarray | None,
                  n_threads: int = 2) -> np.ndarray:
    """``train_clip`` with each frame's photometric distortion (``pmd``: the
    (N, 10) f32 draws of ``transforms.draw_pmd_params``, or None) applied to
    its valid window while it is in cache."""
    lib = _codec_lib()
    (arrays, ptrs, lens), out = _clip_args(buffers, sh, sw, rh, rw, y1, x1, ch, cw)
    if pmd is not None:
        pmd = np.ascontiguousarray(pmd, np.float32)
        if pmd.shape != (len(arrays), 10):
            raise ValueError(f"train_clip_v2: pmd {pmd.shape}, expected ({len(arrays)}, 10)")
    rc = lib.vss_train_clip_v2(ptrs, lens, len(arrays), sh, sw, rh, rw, y1, x1, ch, cw,
                               int(flip), None if pmd is None else _ptr(pmd), _ptr(out),
                               n_threads)
    if rc != 0:
        raise ValueError(f"train clip decode failed ({rc})")
    return out


def pmd_apply(img: np.ndarray, params: np.ndarray) -> np.ndarray:
    """The photometric distortion, in place, of a C-contiguous (H, W, 3) uint8
    BGR image with one frame's 10 draws (its row width matters: cv2's HSV→BGR
    truncates in a row's 32-pixel blocks and rounds in its tail)."""
    lib = _pixel_lib()
    if not (isinstance(img, np.ndarray) and img.dtype == np.uint8 and img.ndim == 3
            and img.shape[-1] == 3 and img.flags.c_contiguous and img.flags.writeable):
        raise ValueError("pmd_apply: expected a writable C-contiguous (H, W, 3) uint8 image")
    params = np.ascontiguousarray(params, np.float32)
    if params.size != 10:
        raise ValueError("pmd_apply: 10 parameters")
    lib.vss_pmd_apply(_ptr(img), img.shape[0], img.shape[1], _ptr(params))
    return img


def cvt_hsv(src: np.ndarray, inverse: bool = False) -> np.ndarray:
    """cv2's uint8 BGR→HSV of an (H, W, 3) image, or HSV→BGR with ``inverse``."""
    lib = _pixel_lib()
    src = _u8_image(src, "cvt_hsv")
    out = np.empty_like(src)
    lib.vss_cvt_hsv_u8(_ptr(src), _ptr(out), src.shape[0], src.shape[1], int(inverse))
    return out


def label_window(src: np.ndarray, rh: int, rw: int, y1: int, x1: int, vh: int, vw: int,
                 flip: bool = False, src_row0: int = 0, sh: int | None = None) -> np.ndarray:
    """The [y1, y1 + vh) × [x1, x1 + vw) window of cv2's nearest resize of a
    (sh, sw) uint8 plane to (rh, rw), optionally flipped in the window.
    ``src`` may be the band of rows from ``src_row0`` of a plane ``sh`` high."""
    lib = _pixel_lib()
    src = np.ascontiguousarray(src)
    if src.dtype != np.uint8 or src.ndim != 2:
        raise ValueError(f"label_window: expected (H, W) uint8, got {src.shape} {src.dtype}")
    if sh is None:
        sh = src_row0 + src.shape[0]
    _window_checked(rh, rw, y1, x1, vh, vw)
    if vh:
        lo, hi = label_window_rows(sh, rh, y1, vh)
        if lo < src_row0 or hi >= src_row0 + src.shape[0]:
            raise ValueError(f"label_window: rows {lo}-{hi} are outside the band from "
                             f"{src_row0} of {src.shape[0]} rows")
    out = np.empty((vh, vw), np.uint8)
    lib.vss_label_window(_ptr(src), src_row0, sh, src.shape[1], rh, rw, y1, x1, vh, vw,
                         int(flip), _ptr(out), vw)
    return out


def label_window_rows(sh: int, rh: int, y1: int, vh: int) -> tuple[int, int]:
    """The source rows [lo, hi] (inclusive) that ``label_window`` reads for the
    window rows [y1, y1 + vh) of the (rh, ·) resized geometry."""
    lib = _pixel_lib()
    lo, hi = ctypes.c_int(), ctypes.c_int()
    lib.vss_label_window_rows(sh, rh, y1, vh, ctypes.addressof(lo), ctypes.addressof(hi))
    return lo.value, hi.value


def decode_label_band(data: bytes, lut: np.ndarray, r0: int, r1: int) -> np.ndarray | None:
    """``decode_label`` of the index rows [r0, r1] (inclusive) only; the rows
    below r1 are not read. None for a PNG that the native decoder does not
    take (the caller decodes it whole)."""
    lib = _codec_lib()
    lut = np.ascontiguousarray(lut, np.uint8)
    if lut.size != 256:
        raise ValueError("decode_label_band: the table takes 256 entries")
    rc, (h, w) = _dims(lib.vss_png_dims, data)
    if rc != 0 or not 0 <= r0 <= r1 < h:
        return None
    buf = np.frombuffer(data, np.uint8)
    out = np.empty((r1 - r0 + 1, w), np.uint8)
    rc = lib.vss_decode_label_band(_ptr(buf), len(data), _ptr(out), h, w, _ptr(lut), r0, r1)
    return out if rc == 0 else None


def png_dims(data: bytes) -> tuple[int, int] | None:
    """(height, width) from a PNG header, or None where it is not a PNG."""
    rc, hw = _dims(_codec_lib().vss_png_dims, data)
    return hw if rc == 0 else None


def decode_clip_normalized(buffers: list[bytes], h: int, w: int, mean, std,
                           to_rgb: bool = True, n_threads: int = 4) -> np.ndarray:
    """N JPEGs of (h, w) → (N, h, w, 3) f32 ``normalize_f32``'d, decoded on
    ``n_threads`` threads."""
    lib = _codec_lib()
    if not buffers:
        raise ValueError("decode_clip_normalized: no frames")
    arrays, ptrs, lens = _buffers(buffers)
    m = np.ascontiguousarray(mean, np.float32)
    s = np.ascontiguousarray(std, np.float32)
    out = np.empty((len(arrays), h, w, 3), np.float32)
    rc = lib.vss_decode_clip_normalized(ptrs, lens, len(arrays), h, w, _ptr(m), _ptr(s),
                                        int(to_rgb), _ptr(out), n_threads)
    if rc != 0:
        raise ValueError(f"clip decode failed ({rc})")
    return out
