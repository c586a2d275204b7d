"""VSPW video dataset: directory scan, clip samplers, train and test items.

The port's copy of ``vss_cffm_tpu/data/vspw.py`` (reference
``mmseg/datasets/custom.py:1959-2713``, ``vspw.py:151-294``). Tree layout::

    data_root/
      train.txt / val.txt / test.txt       (one video name per line)
      data/<video>/origin/*.jpg            (frames)
      data/<video>/mask/*.png              (palette PNG annotations)

- **train** clips (``prepare_train_img2:2242-2324``): one a video an epoch;
  the whole video reversed with probability 0.5; a target drawn from the
  frames that admit the full dilation window; frames ``target + dilation``
  then ``target`` (default dilation ``[-9, -6, -3]``);
- **test** clips (``prepare_test_img2:2355-2445``): one clip per frame, the
  dilations that fall outside the video dropped, and the schedules of
  target frames 3 to 8 for ``dilation == [-9, -6, -3]`` (``:2376-2388``);
- **prototype** clips (``prepare_train_val:2458-2522``): 10 evenly spaced
  frames per video over the train, val and test lists
  (``split="train_val_generate_prototype"``); ``get_prototype_item`` resizes
  and normalises them on the host, with cv2's bits, as the JAX item does;
- labels are palette PNGs read as they are; ``reduce_zero_label`` maps 0 to
  255 (ignore) and k to k − 1 (``loading.py:205-214``).

A train item runs the host pipeline of ``data/transforms.py`` (scale,
crop, flip, photometric distortion, pad) with cv2's bits, the crop box drawn
from the nearest-resized last label and only the crop window of each frame
resized. Test frames are decoded to uint8 BGR at their original size: the
evaluator resizes (AlignedResize to /32) and normalises them on the device,
so a test item carries the ``img_scale`` of each of its views. PIL decodes,
imported inside the reading functions (it is not needed to import the
package).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Sequence

import numpy as np

from . import transforms as T

__all__ = ["VSPWVideoDataset", "ClipSample", "load_label", "load_image", "reduce_zero_label",
           "normalized", "resized_normalized", "scaled_crop", "TTA_RATIOS"]

# the img_scale ratios of --aug-test (reference ``MultiScaleFlipAug``)
TTA_RATIOS = (0.5, 0.75, 1.0, 1.25, 1.5, 1.75)

# reduce_zero_label as a 256-entry table: 0 → 255, k → k − 1, 255 stays 255
_LUT_REDUCE = np.where(np.arange(256) == 0, 255, np.arange(256) - 1)
_LUT_REDUCE = np.where(_LUT_REDUCE == 254, 255, _LUT_REDUCE).astype(np.uint8)


def reduce_zero_label(seg: np.ndarray) -> np.ndarray:
    """0 → 255 (ignore), k → k − 1 (reference ``loading.py:205-214``)."""
    return _LUT_REDUCE[np.asarray(seg, np.uint8)]


def load_label(path: str, reduce_zero: bool = True) -> np.ndarray:
    """(H, W) uint8 label of a palette PNG (its indices, not its colours)."""
    from PIL import Image

    with Image.open(path) as im:
        seg = np.array(im)
    return reduce_zero_label(seg) if reduce_zero else seg


def load_image(path: str) -> np.ndarray:
    """(H, W, 3) uint8 BGR, as cv2.imread gives it."""
    from PIL import Image

    with Image.open(path) as im:
        rgb = np.asarray(im.convert("RGB"))
    return np.ascontiguousarray(rgb[..., ::-1])


def _resized(img: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, hw[::-1])`` bilinear, bit for bit (to the same size
    it copies)."""
    return img if tuple(hw) == img.shape[:2] else T.resize_window(img, *hw, 0, 0, *hw)


def normalized(imgs: Sequence[np.ndarray]) -> list[np.ndarray]:
    """uint8 BGR frames → RGB (x − mean) / std in f32, as the JAX numpy route."""
    mean, std = np.array(T.IMG_MEAN, np.float32), np.array(T.IMG_STD, np.float32)
    return [(im[..., ::-1].astype(np.float32) - mean) / std for im in imgs]


def resized_normalized(img: np.ndarray, img_scale: tuple[int, int]) -> np.ndarray:
    """One uint8 BGR frame resized to fit ``img_scale``, then up to multiples
    of 32 (``AlignedResize``), with cv2's bilinear bits, and normalised."""
    img = _resized(img, T.rescale_size(img.shape[:2], img_scale))
    return normalized([_resized(img, T.aligned_size(img.shape[:2]))])[0]


def scaled_crop(imgs: list[np.ndarray], segs: list[np.ndarray], rng: np.random.RandomState,
                img_scale: tuple[int, int], crop_size: tuple[int, int]
                ) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """``random_scale_clip`` then ``random_crop_clip`` with their draws (the
    ratio, then the crop box on the nearest-resized last label), resizing
    only the crop window of each frame and label: the same bits."""
    scale = T.draw_scale(rng, img_scale)
    y1, y2, x1, x2 = T.sample_crop_box(T.imrescale(segs[-1], scale, nearest=True), rng,
                                       crop_size)

    def window(a: np.ndarray, resize) -> np.ndarray:
        rh, rw = T.rescale_size(a.shape[:2], scale)
        return resize(a, rh, rw, y1, x1, max(min(y2, rh) - y1, 0), max(min(x2, rw) - x1, 0))

    return [window(im, T.resize_window) for im in imgs], [window(s, T.label_window) for s in segs]


@dataclasses.dataclass
class ClipSample:
    video: str
    frame_indices: list[int]
    target_frame: str  # filename of the target (last) frame


class VSPWVideoDataset:
    """Scans the VSPW tree and yields train, test and prototype clips."""

    def __init__(
        self,
        data_root: str,
        split: str = "train",
        dilation: Sequence[int] = (-9, -6, -3),
        crop_size: tuple[int, int] = (480, 480),
        img_scale: tuple[int, int] = (853, 480),
        flip_video: bool = True,
        reduce_zero: bool = True,
        img_suffix: str = ".jpg",
        seg_suffix: str = ".png",
    ):
        self.data_root = data_root
        self.split = split
        self.dilation = list(dilation)
        self.crop_size = tuple(crop_size)
        self.img_scale = tuple(img_scale)
        self.flip_video = flip_video
        self.reduce_zero = reduce_zero
        self.img_suffix = img_suffix
        self.seg_suffix = seg_suffix
        parts = ("train", "val", "test") if split == "train_val_generate_prototype" else (split,)
        names = []
        for part in parts:
            with open(os.path.join(data_root, part + ".txt")) as f:
                names += [ln.rstrip("\n") for ln in f if ln.strip()]
        self.videos = names
        self.frames = {
            v: sorted(os.listdir(os.path.join(data_root, "data", v, "origin")))
            for v in names
        }
        self.frame_index = [(v, f) for v in names for f in self.frames[v]]

    def __len__(self) -> int:
        if self.split in ("train", "train_val_generate_prototype"):
            return len(self.videos)
        return len(self.frame_index)

    # ------------------------------------------------------------- samplers
    def sample_train_clip(self, idx: int, rng: np.random.RandomState
                          ) -> tuple[ClipSample, list[str]]:
        """The clip of video ``idx`` and the video's frame names in the order
        drawn. A video shorter than the dilation window cannot hold a clip:
        the reference returns None and its loader draws another video
        (``custom.py:2260-2262``); so does this, up to 100 times."""
        for _ in range(100):
            video = self.videos[idx]
            frames = self.frames[video]
            if len(frames) + self.dilation[0] >= 1:
                break
            idx = rng.randint(0, len(self.videos))
        else:
            raise RuntimeError(f"no video admits the dilation window {self.dilation} "
                               f"(all ≤ {-self.dilation[0]} frames)")
        if self.flip_video and rng.rand() < 0.5:
            frames = frames[::-1]
        tail = len(frames) + self.dilation[0]  # frames that admit the full window
        target = rng.randint(0, tail) - self.dilation[0]
        indices = [target + d for d in self.dilation] + [target]
        return ClipSample(video, indices, frames[target]), frames

    def sample_test_clip(self, idx: int) -> ClipSample:
        video, frame = self.frame_index[idx]
        frames = self.frames[video]
        t = frames.index(frame)
        indices = [t + d for d in self.dilation if 0 <= t + d < len(frames)]
        indices.append(t)
        if self.dilation == [-9, -6, -3]:
            special = {
                3: [0, 1, 2, 3], 4: [0, 2, 3, 4], 5: [0, 2, 4, 5],
                6: [0, 2, 4, 6], 7: [0, 3, 5, 7], 8: [0, 3, 6, 8],
            }
            if t in special:
                indices = special[t]
        return ClipSample(video, indices, frame)

    def sample_prototype_clip(self, idx: int, num_frames: int = 10) -> ClipSample:
        video = self.videos[idx]
        frames = self.frames[video]
        interval = len(frames) // num_frames
        indices = [int((i + 0.5) * interval) for i in range(num_frames)]
        return ClipSample(video, indices, frames[indices[-1]])

    # ------------------------------------------------------------------- IO
    def _img_path(self, video: str, frame: str) -> str:
        return os.path.join(self.data_root, "data", video, "origin", frame)

    def _seg_path(self, video: str, frame: str) -> str:
        return os.path.join(
            self.data_root, "data", video, "mask",
            frame.replace(self.img_suffix, self.seg_suffix),
        )

    def read_frame(self, video: str, frame: str) -> np.ndarray:
        """One frame, (H, W, 3) uint8 BGR at its original size."""
        return load_image(self._img_path(video, frame))

    def read_label(self, video: str, frame: str) -> np.ndarray:
        """The (H, W) uint8 label of one frame (``reduce_zero`` applied)."""
        return load_label(self._seg_path(video, frame), self.reduce_zero)

    def _clip(self, sample: ClipSample) -> np.ndarray:
        frames = self.frames[sample.video]
        return np.stack([self.read_frame(sample.video, frames[i])
                         for i in sample.frame_indices])

    # ------------------------------------------------------------- assembly
    def get_train_item(self, idx: int, rng: np.random.RandomState,
                       normalize: bool = True) -> dict:
        """The train pipeline: imgs (T, H, W, 3), labels (T, H, W) int32 at
        ``crop_size``. Draws in the reference's order: the clip, the scale
        ratio, the crop box (on the last label, nearest-resized), the flip,
        each frame's photometric distortion. Only the crop window of each
        frame is resized. With ``normalize=False`` the images stay uint8 BGR,
        normalised later on the device (``train.step.device_normalize``);
        else they are RGB (x − mean) / std in f32 here."""
        sample, frames = self.sample_train_clip(idx, rng)
        names = [frames[i] for i in sample.frame_indices]
        imgs = [self.read_frame(sample.video, n) for n in names]
        segs = [self.read_label(sample.video, n) for n in names]
        imgs, segs = scaled_crop(imgs, segs, rng, self.img_scale, self.crop_size)
        imgs, segs, _ = T.random_flip_clip(imgs, segs, rng)
        imgs = T.photometric_distortion_clip(imgs, rng)
        if normalize:
            imgs = normalized(imgs)
        imgs, segs = T.pad_clip(imgs, segs, self.crop_size)
        return {
            "imgs": np.stack(imgs),
            "labels": np.stack(segs).astype(np.int32),
            "video": sample.video,
            "frame": sample.target_frame,
        }

    def get_test_item(self, idx: int) -> dict:
        """The test clip of frame ``idx``: imgs (T, H, W, 3) uint8 BGR at the
        original size, the ``img_scale`` the evaluator resizes them to, and
        the target frame's meta."""
        sample = self.sample_test_clip(idx)
        imgs = self._clip(sample)
        return {
            "imgs": imgs,
            "img_scale": self.img_scale,
            "ori_shape": tuple(imgs.shape[1:3]),
            "video": sample.video,
            "frame": sample.target_frame,
            "index": idx,
        }

    def get_test_item_tta(
        self,
        idx: int,
        ratios: Sequence[float] = TTA_RATIOS,
        flip: bool = True,
    ) -> dict:
        """Multi-scale (+ flip) views of the test clip of frame ``idx``
        (``MultiScaleFlipAug``, ``tools/test.py --aug-test``): one img_scale a
        ratio, each also flipped; the frames are decoded once and the
        evaluator resizes them for each view."""
        item = self.get_test_item(idx)
        scales, flips = [], []
        for r in ratios:
            scale = (int(self.img_scale[0] * r), int(self.img_scale[1] * r))
            scales += [scale, scale] if flip else [scale]
            flips += [False, True] if flip else [False]
        del item["img_scale"]
        return {**item, "scales": scales, "flips": flips}

    def get_prototype_item(self, idx: int, num_frames: int = 10) -> dict:
        """CFFM++ phase A's item of video ``idx`` (``sample_prototype_clip``):
        imgs (T, H', W', 3) f32, each frame resized to ``img_scale`` and up
        to multiples of 32 with cv2's bilinear bits (``AlignedResize``), then
        RGB (x − mean) / std, as the JAX item; and the video's name."""
        sample = self.sample_prototype_clip(idx, num_frames)
        imgs = [resized_normalized(im, self.img_scale) for im in self._clip(sample)]
        return {"imgs": np.stack(imgs), "video": sample.video}

    def load_gt(self, idx: int) -> np.ndarray:
        """Ground-truth mask of the target frame of test item ``idx``."""
        video, frame = self.frame_index[idx]
        return load_label(self._seg_path(video, frame), self.reduce_zero)
