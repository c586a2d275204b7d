"""Cityscapes clip dataset (video sequences with one annotated frame each).

The port's copy of ``vss_cffm_tpu/data/cityscapes.py`` (reference
``CustomDataset_cityscape_clips`` / ``CityscapesDataset_clips``,
``mmseg/datasets/custom.py:801-1460``, ``mmseg/datasets/cityscapes.py:427+``).
Cityscapes annotates one frame a sequence; the clip's other frames are found
by arithmetic on the frame number of ``{city}_{seq}_{frame}_leftImg8bit.png``
in the ``leftImg8bit_sequence`` tree. The reversal augmentation negates the
dilation offsets (``custom.py:1060-1066``) rather than reversing a frame
list. Only the annotated (target, last) frame has ground truth: the label
clip repeats it over the frames for a uniform shape, and
``models.losses.clip_ce_loss_city`` supervises the last frame alone.

Tree layout::

    data_root/
      leftImg8bit_sequence/{split}/{city}/{city}_{seq}_{frame}_leftImg8bit.png
      gtFine/{split}/{city}/{city}_{seq}_{frame}_gtFine_labelTrainIds.png

Items are the JAX dataset's, element for element: the train pipeline of
``data/transforms.py`` with cv2's bits (scale, crop, flip, photometric
distortion, then RGB (x − mean) / std in f32 and the pad), and test clips
resized to ``img_scale`` and up to multiples of 32 and normalised on the
host (``vspw.resized_normalized``). PIL decodes (imported where a file is
read); the classes and palette are ``data/palette.py``'s.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from . import transforms as T
from .palette import CITYSCAPES_CLASSES, CITYSCAPES_PALETTE
from .vspw import load_image, load_label, normalized, resized_normalized, scaled_crop

__all__ = ["CITYSCAPES_CLASSES", "CITYSCAPES_PALETTE", "CityscapesClipDataset"]

_IMG_SUFFIX = "_leftImg8bit.png"
_SEG_SUFFIX = "_gtFine_labelTrainIds.png"


def _shift_frame(img_name: str, offset: int) -> str:
    """{city}_{seq}_{frame}{suffix} with the frame number moved by ``offset``."""
    parts = img_name.split("_")
    frame = str(int(parts[-2]) + offset).rjust(6, "0")
    return "_".join(parts[:-2] + [frame] + parts[-1:])


class CityscapesClipDataset:
    def __init__(
        self,
        data_root: str,
        split: str = "train",
        dilation: Sequence[int] = (-9, -6, -3),
        crop_size: tuple[int, int] = (512, 512),
        img_scale: tuple[int, int] = (2048, 1024),
        flip_video: bool = True,
    ):
        self.data_root = data_root
        self.split = split
        self.dilation = list(dilation)
        self.crop_size = crop_size
        self.img_scale = img_scale
        self.flip_video = flip_video
        self.img_dir = os.path.join(data_root, "leftImg8bit_sequence", split)
        self.ann_dir = os.path.join(data_root, "gtFine", split)

        self.samples: list[tuple[str, str]] = []  # (image, label) relative to their dirs
        for city in sorted(os.listdir(self.ann_dir)):
            cdir = os.path.join(self.ann_dir, city)
            for name in sorted(os.listdir(cdir)):
                if name.endswith(_SEG_SUFFIX):
                    img = name.replace(_SEG_SUFFIX, _IMG_SUFFIX)
                    self.samples.append((os.path.join(city, img), os.path.join(city, name)))

    def __len__(self) -> int:
        return len(self.samples)

    def _clip_names(self, rel_img: str, dilation: list[int]) -> list[str]:
        return [_shift_frame(rel_img, d) for d in dilation] + [rel_img]

    def _load_clip(self, rel_img: str, dilation: list[int]) -> list[np.ndarray]:
        """The clip's frames, uint8 BGR; a missing frame raises."""
        return [load_image(os.path.join(self.img_dir, rel))
                for rel in self._clip_names(rel_img, dilation)]

    def _meta(self, rel_img: str) -> dict:
        return {"video": rel_img.rsplit("_", 2)[0], "frame": rel_img}

    def get_train_item(self, idx: int, rng: np.random.RandomState) -> dict:
        """imgs (T, H, W, 3) f32 RGB (x − mean) / std, labels (T, H, W)
        int32 (the target's, repeated) at ``crop_size``; draws in the JAX
        order: reversal, scale, crop box, flip, each frame's distortion."""
        rel_img, _ = self.samples[idx]
        dilation = [-d for d in self.dilation] if (self.flip_video and rng.rand() < 0.5) \
            else self.dilation
        imgs = self._load_clip(rel_img, dilation)
        gt = self.load_gt(idx)
        imgs, segs = scaled_crop(imgs, [gt] * len(imgs), rng, self.img_scale, self.crop_size)
        imgs, segs, _ = T.random_flip_clip(imgs, segs, rng)
        imgs = normalized(T.photometric_distortion_clip(imgs, rng))
        imgs, segs = T.pad_clip(imgs, segs, self.crop_size)
        return {"imgs": np.stack(imgs), "labels": np.stack(segs).astype(np.int32),
                **self._meta(rel_img)}

    def get_test_item(self, idx: int) -> dict:
        """imgs (T, H', W', 3) f32, resized and normalised on the host as the
        JAX item is, and the frames' original (H, W)."""
        rel_img, _ = self.samples[idx]
        imgs = self._load_clip(rel_img, self.dilation)
        return {"imgs": np.stack([resized_normalized(im, self.img_scale) for im in imgs]),
                "ori_shape": imgs[0].shape[:2], **self._meta(rel_img)}

    def load_gt(self, idx: int) -> np.ndarray:
        """The (H, W) uint8 train ids of sample ``idx``'s annotated frame."""
        return load_label(os.path.join(self.ann_dir, self.samples[idx][1]), reduce_zero=False)
