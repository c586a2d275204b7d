"""FLOPs of CFFM (MiT backbone + CFFM head) and the kernel-op calls of its
train step and of an eval clip, from a configuration dict.

A corrected copy of the program's ``tools/get_flops.py``: the per-frame
decode (``linear_cX``, ``linear_fuse``, ``linear_pred``) counted once a
frame, not once a clip; the decoder's pooled K/V counted on the pooled maps
(each pooled token once); the bilinear resizes counted (7 FLOPs an output
value); ``linear_pred`` counted only where it runs (every frame in training,
a one-frame clip at eval). Products: 2 FLOPs a multiply-add.
"""

from __future__ import annotations

import math

RESIZE = 7  # FLOPs an output value of a bilinear resize


def _rolled(ws: int, e: int) -> int:
    return 4 * (ws * ws - (ws - e) * (ws - e))


def decoder_geometry(dec: dict, h8: int, w8: int) -> dict:
    """Windows, keys a window and the pooled sources of one decoder block on
    an h8 x w8 map."""
    ws = dec["window_size"]
    hp, wp = math.ceil(h8 / ws) * ws, math.ceil(w8 / ws) * ws
    n_wh, n_ww = hp // ws, wp // ws
    keys = ws * ws + _rolled(ws, dec["expand_size"])
    sources = []  # (pooled tokens, pool window, resized input values / channel)
    for k in range(dec["focal_level"] - 1):
        kernel = 2 * (dec["focal_window"] // 2) + 2 ** k + (2 ** k - 1)
        keys += (kernel - (2 ** k - 1)) ** 2
        sources.append((n_wh * 2 ** k * n_ww * 2 ** k, ws // 2 ** k, 0))
    for fl, kernel in zip(dec["focal_l_clips"], dec["focal_kernel_clips"]):
        keys += kernel * kernel
        pw = ws // fl
        side = (n_wh * fl * pw, n_ww * fl * pw)
        resized = 0 if side == (hp, wp) else side[0] * side[1]
        sources.append((n_wh * fl * n_ww * fl, pw, resized))
    return {"hp": hp, "wp": wp, "nw": n_wh * n_ww, "keys": keys, "sources": sources}


def backbone_flops(cfg: dict, h: int, w: int) -> float:
    """One h x w frame through the MiT backbone."""
    total, in_ch = 0, 3
    for s, (h, w) in enumerate(stage_hw(cfg, h, w)):
        k = cfg["patch_sizes"][s]
        d, sr = cfg["embed_dims"][s], cfg["sr_ratios"][s]
        n = h * w
        n_kv = (h // sr) * (w // sr) if sr > 1 else n
        ch = d * cfg["mlp_ratios"][s]
        total += 2 * n * d * in_ch * k * k
        block = 2 * n * d * d * 2 + 2 * n_kv * d * 2 * d + 2 * 2 * n * n_kv * d
        block += 2 * n * d * ch * 2 + 2 * 9 * n * ch
        if sr > 1:
            block += 2 * n_kv * d * d * sr * sr
        total += cfg["depths"][s] * block
        in_ch = d
    return float(total)


def stage_hw(cfg: dict, h: int, w: int) -> list[tuple[int, int]]:
    """The four stage maps' sizes of an h x w frame."""
    out = []
    for k, st in zip(cfg["patch_sizes"], cfg["patch_strides"]):
        h, w = (h + 2 * (k // 2) - k) // st + 1, (w + 2 * (k // 2) - k) // st + 1
        out.append((h, w))
    return out


def decode_flops(cfg: dict, h: int, w: int, pred: bool) -> float:
    """The per-frame MLP decode of one h x w frame (its four stage maps),
    with ``linear_pred`` when ``pred``."""
    f = cfg["embed_dim"]
    sizes = stage_hw(cfg, h, w)
    h4, w4 = sizes[0]
    total = 0
    for i, (c, (hi, wi)) in enumerate(zip(cfg["embed_dims"], sizes)):
        total += 2 * hi * wi * c * f
        if i:
            total += RESIZE * h4 * w4 * f
    total += 2 * h4 * w4 * 4 * f * f
    if pred:
        total += 2 * h4 * w4 * f * cfg["num_classes"]
    return float(total)


def head_clip_flops(cfg: dict, frames: int, h4: int, w4: int) -> float:
    """The clip part of the CFFM head for one clip of ``frames`` fused maps:
    the resize to 1/8, the focal decoder, ``linear_pred2`` and its resize to
    1/4."""
    dec, f, k_cls = cfg["decoder"], cfg["embed_dim"], cfg["num_classes"]
    h8, w8 = h4 // 2, w4 // 2
    c = dec["dim"]
    g = decoder_geometry(dec, h8, w8)
    total = RESIZE * frames * h8 * w8 * f
    block = 2 * g["hp"] * g["wp"] * c * 3 * c
    for tokens, pw, resized in g["sources"]:
        block += RESIZE * resized * c + 2 * tokens * pw * pw * c + 2 * tokens * c * 2 * c
    block += 2 * 2 * g["nw"] * 49 * g["keys"] * c + 2 * g["nw"] * 49 * c * c
    block += 2 * 2 * h8 * w8 * c * int(c * dec["mlp_ratio"])
    total += dec["depth"] * block
    total += 2 * h8 * w8 * 2 * f * k_cls + RESIZE * h4 * w4 * k_cls
    return float(total)


def train_step_flops(cfg: dict, clips: int, frames: int, h: int, w: int) -> float:
    """Forward and backward (twice the forward) of one train step: every
    frame through backbone and decode with ``linear_pred``, the head on each
    clip, the loss's x4 upsample of the T + 1 logit maps."""
    h4, w4 = stage_hw(cfg, h, w)[0]
    fwd = clips * frames * (backbone_flops(cfg, h, w) + decode_flops(cfg, h, w, True))
    fwd += clips * head_clip_flops(cfg, frames, h4, w4)
    fwd += clips * (frames + 1) * RESIZE * h * w * cfg["num_classes"]
    return 3.0 * fwd


def eval_clip_flops(cfg: dict, frames: int, ori_hw, net_hw) -> float:
    """One eval item: the frames resized to the network input, backbone and
    decode of each, the head (a clip of the configured length) or
    ``linear_pred`` (a shorter clip), and the logits resized to the network
    input and to the original size."""
    h, w = net_hw
    h4, w4 = stage_hw(cfg, h, w)[0]
    full = frames == cfg["num_clips"]
    total = frames * RESIZE * h * w * 3 if tuple(ori_hw) != tuple(net_hw) else 0
    total += frames * (backbone_flops(cfg, h, w) + decode_flops(cfg, h, w, not full))
    if full:
        total += head_clip_flops(cfg, frames, h4, w4)
    total += RESIZE * h * w * cfg["num_classes"] + RESIZE * ori_hw[0] * ori_hw[1] * \
        cfg["num_classes"]
    return float(total)


def _stage_shapes(cfg: dict, n: int, h: int, w: int) -> list[dict]:
    out = []
    for s, (h, w) in enumerate(stage_hw(cfg, h, w)):
        d, sr = cfg["embed_dims"][s], cfg["sr_ratios"][s]
        keys = (h // sr) * (w // sr) if sr > 1 else h * w
        out.append({"n": n, "h": h, "w": w, "c": d, "ch": d * cfg["mlp_ratios"][s],
                    "nh": cfg["num_heads"][s], "s": keys})
    return out


def _attention_shape(cfg: dict, clips: int, h4: int, w4: int) -> dict:
    dec = cfg["decoder"]
    g = decoder_geometry(dec, h4 // 2, w4 // 2)
    return {"nw": clips * g["nw"], "lq": dec["window_size"] ** 2, "keys": g["keys"],
            "c": dec["dim"], "nh": dec["num_heads"]}


def train_calls(cfg: dict, clips: int, frames: int, h: int, w: int) -> list[tuple[str, dict]]:
    """Kernel-op calls of one train step: per backbone block the form its
    stage trains in (``train_block_impl``: "full" the block pair, None the
    composed block with its depthwise op), the decoder's attention pair, two
    CE pairs (every frame, the refined last frame)."""
    calls = []
    for s, shape in enumerate(_stage_shapes(cfg, clips * frames, h, w)):
        form = cfg["train_block_impl"][s]
        for _ in range(cfg["depths"][s]):
            if form == "full":
                calls += [("mit_block_train", shape), ("mit_block_train_bwd", shape)]
            elif form is None:
                calls.append(("dwconv3x3", shape))
            else:
                raise ValueError(f"train form {form!r} is not counted")
    att = _attention_shape(cfg, clips, h // 4, w // 4)
    calls += [("cfm_attention", att), ("cfm_attention_bwd", att)] * cfg["decoder"]["depth"]
    k = cfg["num_classes"]
    for n in (clips * frames, clips):
        ce = {"n": n, "h": h // 4, "w": w // 4, "k": k, "s": 4}
        calls += [("ce_upsampled_loss", ce), ("ce_upsampled_loss_bwd", ce)]
    return calls


def eval_calls(cfg: dict, frames: int, h: int, w: int) -> list[tuple[str, dict]]:
    """Kernel-op calls of one eval item of ``frames`` frames at the network
    size h x w: per block the inference form of its stage (``block_impl``:
    "fused" the whole-block op, None the composed block's depthwise op), and
    the decoder's attention on a clip of the configured length."""
    calls = []
    for s, shape in enumerate(_stage_shapes(cfg, frames, h, w)):
        form = cfg["block_impl"][s]
        op = {"fused": "mit_block_fused", None: "dwconv3x3"}[form]
        calls += [(op, shape)] * cfg["depths"][s]
    if frames == cfg["num_clips"]:
        calls += [("cfm_attention", _attention_shape(cfg, 1, h // 4, w // 4))] * \
            cfg["decoder"]["depth"]
    return calls
