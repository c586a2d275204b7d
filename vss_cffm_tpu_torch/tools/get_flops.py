"""Analytic FLOPs of a CFFM config, the port's copy of the JAX package's
``tools/get_flops.py`` (reference ``tools/get_flops.py``, which patches
mmcv's counter with hand-derived SRA attention FLOPs). A multiply-add
counts as 2 FLOPs::

    python -m vss_cffm_tpu_torch.tools.get_flops vss_cffm_tpu_torch/configs/cffm_b1_vspw_160k.py \\
        [--shape 480 480] [--options k=v ...]

Pure arithmetic on the config's widths: it builds no model and touches no
device, so it takes no ``--device``. Its lines are the JAX tool's.
"""

from __future__ import annotations

import argparse
import math

from ..config import CFFMHeadConfig, MiTConfig, apply_overrides, load_config

__all__ = ["mit_flops", "cffm_head_flops", "main"]


def mit_flops(cfg: MiTConfig, h: int, w: int) -> int:
    """FLOPs of the MiT backbone on one h × w frame."""
    total = 0
    ph, pw = h, w
    in_ch = 3
    for s in range(4):
        k, st = cfg.patch_sizes[s], cfg.patch_strides[s]
        ph, pw = ph // st, pw // st
        d = cfg.embed_dims[s]
        total += 2 * ph * pw * d * in_ch * k * k  # patch embed conv
        n = ph * pw
        sr = cfg.sr_ratios[s]
        n_kv = (ph // sr) * (pw // sr)
        for _ in range(cfg.depths[s]):
            total += 2 * n * d * d  # q
            if sr > 1:
                total += 2 * n_kv * d * d * sr * sr  # sr conv
            total += 2 * n_kv * d * 2 * d  # kv
            total += 2 * cfg.num_heads[s] * n * n_kv * (d // cfg.num_heads[s]) * 2  # qk + av
            total += 2 * n * d * d  # proj
            hidden = d * cfg.mlp_ratios[s]
            total += 2 * n * d * hidden * 2  # fc1 + fc2
            total += 2 * n * hidden * 9  # dwconv 3x3
        in_ch = d
    return total


def cffm_head_flops(head: CFFMHeadConfig, h4: int, w4: int) -> int:
    """FLOPs of the CFFM head on one clip whose 1/4 maps are h4 × w4."""
    e = head.embed_dim
    total = 0
    # linear_cX projections + fuse at 1/4
    strides = [1, 2, 4, 8]
    for cin, s in zip(head.in_channels, strides):
        total += 2 * (h4 // s) * (w4 // s) * cin * e
    total += 2 * h4 * w4 * 4 * e * e  # linear_fuse 1x1
    total += 2 * h4 * w4 * e * head.num_classes  # linear_pred
    # decoder at 1/8
    dec = head.decoder
    h8, w8 = h4 // 2, w4 // 2
    ws = dec.window_size
    hp = math.ceil(h8 / ws) * ws
    wp = math.ceil(w8 / ws) * ws
    n_w = (hp // ws) * (wp // ws)
    n_src = ws * ws + 132 + 25 + sum(k * k for k in dec.focal_kernel_clips)
    per_block = (
        2 * hp * wp * e * 3 * e  # qkv target
        + 2 * n_w * (25 + 49 + 25 + 9) * e * 2 * e  # pooled kv (approx)
        + 2 * dec.num_heads * n_w * ws * ws * n_src * (e // dec.num_heads) * 2
        + 2 * n_w * ws * ws * e * e  # proj
        + 2 * hp * wp * e * e * dec.mlp_ratio * 2  # mlp
    )
    total += dec.depth * per_block
    total += 2 * h4 * w4 * 2 * e * head.num_classes  # linear_pred2
    return total


def main(argv: list[str] | None = None) -> dict:
    """Prints the JAX tool's four lines; returns the FLOPs of the backbone
    (all frames), the head and both."""
    ap = argparse.ArgumentParser(description="Analytic FLOPs of a CFFM config.")
    ap.add_argument("config")
    ap.add_argument("--shape", type=int, nargs=2, default=[480, 480])
    ap.add_argument("--options", nargs="*", default=[])
    args = ap.parse_args(argv)
    cfg = apply_overrides(load_config(args.config), args.options)
    h, w = args.shape
    t = len(cfg.data.dilation) + 1
    bb = mit_flops(cfg.model.backbone_config, h, w) * t
    head = cffm_head_flops(cfg.model.head, h // 4, w // 4)
    print(f"input: {t}x{h}x{w}")
    print(f"backbone: {bb / 1e9:.2f} GFLOPs")
    print(f"head:     {head / 1e9:.2f} GFLOPs")
    print(f"total:    {(bb + head) / 1e9:.2f} GFLOPs")
    return {"frames": t, "backbone": bb, "head": head, "total": bb + head}


if __name__ == "__main__":
    main()
