"""Single-image inference demo (the port of ``demo/image_demo.py``,
reference ``demo/image_demo.py``)::

    python -m vss_cffm_tpu_torch.demo.image_demo IMG CONFIG CHECKPOINT --out overlay.png \\
        [--palette vspw|cityscapes] [--opacity 0.5] [--device cuda|cpu]

An image config (``configs/segformer_b0_image.py``) segments the image; a
clip config sees it repeated as a still clip of ``len(dilation) + 1``
frames. The overlay (``apis.show_result``) is written with PIL. Runs on the
card unless ``--device cpu`` is asked for.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..apis import inference_segmentor, init_segmentor, show_result
from ..data import get_palette

__all__ = ["build_parser", "main", "save_overlay"]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Segment one image with a config and checkpoint.")
    ap.add_argument("img", help="image file")
    ap.add_argument("config", help="config file")
    ap.add_argument("checkpoint", help="a .pth / .pt or a checkpoint directory")
    ap.add_argument("--out", default="demo_out.png")
    ap.add_argument("--palette", default="vspw", help="vspw | cityscapes")
    ap.add_argument("--opacity", type=float, default=0.5)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def save_overlay(overlay: np.ndarray, path: str) -> None:
    """Write a BGR overlay as an RGB image file."""
    from PIL import Image

    Image.fromarray(np.ascontiguousarray(overlay[..., ::-1])).save(path)


def main(argv: list[str] | None = None) -> np.ndarray:
    """Returns the (H, W) mask."""
    args = build_parser().parse_args(argv)
    bundle = init_segmentor(args.config, checkpoint=args.checkpoint, device=args.device)
    if bundle.cfg.model.arch == "image":
        imgs = args.img
    else:  # a clip model: the still image repeated as a clip
        imgs = [args.img] * (len(bundle.cfg.data.dilation) + 1)
    seg = inference_segmentor(bundle, imgs).cpu().numpy()
    save_overlay(show_result(args.img, seg, palette=get_palette(args.palette),
                             opacity=args.opacity), args.out)
    print(f"wrote {args.out}")
    return seg


if __name__ == "__main__":
    main()
