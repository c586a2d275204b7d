"""Clip inference demo (the port of ``demo/video_demo.py``)::

    python -m vss_cffm_tpu_torch.demo.video_demo CONFIG CHECKPOINT frame1.jpg frame2.jpg \\
        frame3.jpg frame4.jpg --out overlay.png [--device cuda|cpu]

The frames form one clip, the target last; the overlay of its mask on the
target frame is written with PIL. Runs on the card unless ``--device cpu``
is asked for.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..apis import inference_segmentor, init_segmentor, show_result
from .image_demo import save_overlay

__all__ = ["build_parser", "main"]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Segment the last frame of a clip.")
    ap.add_argument("config")
    ap.add_argument("checkpoint", help="a .pth / .pt or a checkpoint directory")
    ap.add_argument("frames", nargs="+", help="clip frames, target last")
    ap.add_argument("--out", default="demo_out.png")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv: list[str] | None = None) -> np.ndarray:
    """Returns the (H, W) mask of the target frame."""
    args = build_parser().parse_args(argv)
    bundle = init_segmentor(args.config, checkpoint=args.checkpoint, device=args.device)
    seg = inference_segmentor(bundle, args.frames).cpu().numpy()
    save_overlay(show_result(args.frames[-1], seg), args.out)
    print(f"wrote {args.out}")
    return seg


if __name__ == "__main__":
    main()
