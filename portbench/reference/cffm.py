"""Plain reference of CFFM (MiT backbone + CFFM clip head), its clip CE loss
and the recipe's AdamW, written against the published architecture
(GuoleiSun/VSS-CFFM, SegFormer's MiT) in plain PyTorch.

It imports nothing but torch, numpy and the standard library: no JAX and
nothing of the program under test. Parameters are a ``{name: tensor}`` dict
keyed by the reference PyTorch names (``backbone.block1.0.attn.q.weight``,
``decode_head.decoder_focal.blocks.0.attn.qkv.weight``, ...), which
``param_shapes`` lists from a configuration dict (a benchmark config file).

Everything computes in float32 with TF32 off (``exact_math``). A ``Quant``
other than the identity computes in fp8 where the program computes in bf16:
it rounds the operands of every matrix product and convolution, the output
of every linear layer, convolution, LayerNorm and block, and the attention
probabilities to e4m3, and the gradient arriving at each of them to e5m2
(per-tensor scales); statistics, softmax and the loss stay float32. That is
the lower-precision control that a correctness limit must reject.

Random draws (stochastic depth, Dropout2d) are taken from a
``torch.Generator`` in the order the architecture meets them, all of a step
up front (``draw_masks``): per backbone block with a rate above 0 one
per-sample draw for the attention branch and one for the FFN branch, then
Dropout2d before ``linear_pred`` (frames x channels) and before
``linear_pred2`` (clips x 2 channels).
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

IMG_MEAN = (123.675, 116.28, 103.53)
IMG_STD = (58.395, 57.12, 57.375)
BUFFER_SUFFIXES = ("running_mean", "running_var", "num_batches_tracked")


# ---------------------------------------------------------------- precision


class _FakeFP8(torch.autograd.Function):
    """Forward: x rounded to e4m3 at a per-tensor scale; backward: the
    gradient rounded to e5m2 likewise (fp8 training's usual pair)."""

    @staticmethod
    def forward(ctx, x):
        return _round_fp8(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g, torch.float8_e5m2, 57344.0)


def _round_fp8(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return ((x.float() / scale).to(dtype).float() * scale).to(x.dtype)


class Quant:
    """Operand rounding of matrix products and convolutions: none ("f32") or
    fp8 ("fp8")."""

    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "fp8"):
            raise ValueError(f"precision {kind!r}: expected 'f32' or 'fp8'")
        self.kind = kind

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.kind == "f32" else _FakeFP8.apply(x)


@contextlib.contextmanager
def exact_math():
    """float32 products without TF32, restored afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# ---------------------------------------------------------------- parameters


def _rolled_masks(ws: int, e: int) -> list[np.ndarray]:
    """Kept positions of the tl, tr, bl, br rolled windows."""
    out = []
    for rs, cs in ((slice(None, -e), slice(None, -e)), (slice(None, -e), slice(e, None)),
                   (slice(e, None), slice(None, -e)), (slice(e, None), slice(e, None))):
        m = np.ones((ws, ws), bool)
        m[rs, cs] = False
        out.append(m.reshape(-1))
    return out


def param_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """Every parameter and buffer of the segmentor, in model order."""
    shapes: dict[str, tuple[int, ...]] = {}
    dims, depths = cfg["embed_dims"], cfg["depths"]
    in_ch = 3
    for s in range(4):
        d = dims[s]
        k = cfg["patch_sizes"][s]
        pre = f"backbone.patch_embed{s + 1}"
        shapes[f"{pre}.proj.weight"] = (d, in_ch, k, k)
        shapes[f"{pre}.proj.bias"] = (d,)
        shapes[f"{pre}.norm.weight"] = (d,)
        shapes[f"{pre}.norm.bias"] = (d,)
        hidden = d * cfg["mlp_ratios"][s]
        sr = cfg["sr_ratios"][s]
        for i in range(depths[s]):
            b = f"backbone.block{s + 1}.{i}"
            shapes |= {f"{b}.norm1.weight": (d,), f"{b}.norm1.bias": (d,),
                       f"{b}.attn.q.weight": (d, d), f"{b}.attn.q.bias": (d,),
                       f"{b}.attn.kv.weight": (2 * d, d), f"{b}.attn.kv.bias": (2 * d,),
                       f"{b}.attn.proj.weight": (d, d), f"{b}.attn.proj.bias": (d,)}
            if sr > 1:
                shapes |= {f"{b}.attn.sr.weight": (d, d, sr, sr), f"{b}.attn.sr.bias": (d,),
                           f"{b}.attn.norm.weight": (d,), f"{b}.attn.norm.bias": (d,)}
            shapes |= {f"{b}.norm2.weight": (d,), f"{b}.norm2.bias": (d,),
                       f"{b}.mlp.fc1.weight": (hidden, d), f"{b}.mlp.fc1.bias": (hidden,),
                       f"{b}.mlp.dwconv.dwconv.weight": (hidden, 1, 3, 3),
                       f"{b}.mlp.dwconv.dwconv.bias": (hidden,),
                       f"{b}.mlp.fc2.weight": (d, hidden), f"{b}.mlp.fc2.bias": (d,)}
        shapes[f"backbone.norm{s + 1}.weight"] = (d,)
        shapes[f"backbone.norm{s + 1}.bias"] = (d,)
        in_ch = d
    f, k_cls = cfg["embed_dim"], cfg["num_classes"]
    h = "decode_head"
    for i, c in enumerate(dims):
        shapes[f"{h}.linear_c{i + 1}.proj.weight"] = (f, c)
        shapes[f"{h}.linear_c{i + 1}.proj.bias"] = (f,)
    shapes[f"{h}.linear_fuse.conv.weight"] = (f, 4 * f, 1, 1)
    for n in ("weight", "bias", "running_mean", "running_var"):
        shapes[f"{h}.linear_fuse.bn.{n}"] = (f,)
    shapes[f"{h}.linear_fuse.bn.num_batches_tracked"] = ()
    shapes[f"{h}.linear_pred.weight"] = (k_cls, f, 1, 1)
    shapes[f"{h}.linear_pred.bias"] = (k_cls,)
    dec = cfg["decoder"]
    c, nh, ws = dec["dim"], dec["num_heads"], dec["window_size"]
    n_rolled = int(sum(m.sum() for m in _rolled_masks(ws, dec["expand_size"])))
    hid = int(c * dec["mlp_ratio"])
    for j in range(dec["depth"]):
        b = f"{h}.decoder_focal.blocks.{j}"
        shapes |= {f"{b}.norm1.weight": (c,), f"{b}.norm1.bias": (c,),
                   f"{b}.norm2.weight": (c,), f"{b}.norm2.bias": (c,),
                   f"{b}.attn.qkv.weight": (3 * c, c), f"{b}.attn.qkv.bias": (3 * c,),
                   f"{b}.attn.proj.weight": (c, c), f"{b}.attn.proj.bias": (c,),
                   f"{b}.attn.relative_position_bias_table": ((2 * ws - 1) ** 2, nh),
                   f"{b}.attn.relative_position_bias_table_to_neighbors":
                       (1, nh, ws * ws, n_rolled)}
        for k in range(dec["focal_level"] - 1):
            kk = dec["focal_window"] + 2 ** k - 1
            shapes[f"{b}.attn.relative_position_bias_table_to_windows.{k}"] = (
                nh, (ws + kk - 1) ** 2)
        for k, kc in enumerate(dec["focal_kernel_clips"]):
            shapes[f"{b}.attn.relative_position_bias_table_to_windows_clips.{k}"] = (
                nh, (ws + kc - 1) ** 2)
        shapes |= {f"{b}.mlp.fc1.weight": (hid, c), f"{b}.mlp.fc1.bias": (hid,),
                   f"{b}.mlp.fc2.weight": (c, hid), f"{b}.mlp.fc2.bias": (c,)}
        for k in range(dec["focal_level"] - 1):
            pw = ws // 2 ** k
            shapes[f"{b}.pool_layers.{k}.weight"] = (1, pw * pw)
            shapes[f"{b}.pool_layers.{k}.bias"] = (1,)
        for k, fl in enumerate(dec["focal_l_clips"]):
            pw = ws // fl
            shapes[f"{b}.pool_layers_clips.{k}.weight"] = (1, pw * pw)
            shapes[f"{b}.pool_layers_clips.{k}.bias"] = (1,)
    shapes[f"{h}.linear_pred2.weight"] = (k_cls, 2 * f, 1, 1)
    shapes[f"{h}.linear_pred2.bias"] = (k_cls,)
    return shapes


def is_buffer(name: str) -> bool:
    return name.endswith(BUFFER_SUFFIXES)


def drop_path_rates(cfg: dict) -> list[float]:
    """Stochastic depth per backbone block, linear over all blocks."""
    total = sum(cfg["depths"])
    return [cfg["drop_path_rate"] * i / max(total - 1, 1) for i in range(total)]


def draw_masks(cfg: dict, gen: torch.Generator, clips: int, frames: int, train: bool) -> dict:
    """The step's random draws, in the order the forward meets them: keep
    masks (bool) per block branch, then the two Dropout2d masks."""
    if not train:
        return {}
    n = clips * frames
    dev = gen.device
    out: dict = {"blocks": []}
    for rate in drop_path_rates(cfg):
        if rate == 0.0:
            out["blocks"].append(None)
            continue
        ua = torch.rand((n,), generator=gen, device=dev)
        uf = torch.rand((n,), generator=gen, device=dev)
        out["blocks"].append((rate, ua < 1.0 - rate, uf < 1.0 - rate))
    f, p = cfg["embed_dim"], cfg["dropout_ratio"]
    if p > 0.0:
        out["drop_frames"] = torch.rand((n * f,), generator=gen, device=dev) < 1.0 - p
        if frames == cfg["num_clips"]:
            out["drop_last"] = torch.rand((clips * 2 * f,), generator=gen, device=dev) < 1.0 - p
    return out


# ---------------------------------------------------------------- layers


def _ln(x, P, name, eps, q=None):
    y = F.layer_norm(x, x.shape[-1:], P[f"{name}.weight"], P[f"{name}.bias"], eps)
    return q(y) if q is not None else y


def _linear(x, P, name, q):
    return q(F.linear(q(x), q(P[f"{name}.weight"]), P[f"{name}.bias"]))


def _conv(x_nhwc, w, b, q, stride=1, padding=0, groups=1):
    y = F.conv2d(q(x_nhwc.permute(0, 3, 1, 2)), q(w), b, stride=stride, padding=padding,
                 groups=groups)
    return q(y.permute(0, 2, 3, 1))


def _resize(x_nhwc, hw):
    if tuple(x_nhwc.shape[1:3]) == tuple(hw):
        return x_nhwc
    y = F.interpolate(x_nhwc.permute(0, 3, 1, 2), size=tuple(hw), mode="bilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 1)


def _attention(qh, kh, vh, q, bias=None):
    """softmax(q k^T / sqrt(hd) + bias) v over heads: (..., L, hd) operands."""
    s = q(qh) @ q(kh).transpose(-1, -2) * qh.shape[-1] ** -0.5
    if bias is not None:
        s = s + bias
    return q(q(torch.softmax(s, dim=-1)) @ q(vh))


def _branch(x, keep, rate):
    """Stochastic depth of a per-sample branch: kept samples / (1 - rate)."""
    if keep is None:
        return x
    return x * (keep.float() / (1.0 - rate)).reshape(-1, *([1] * (x.dim() - 1)))


def mit_block(x, P, b, cfg, s, q, draw):
    d = cfg["embed_dims"][s]
    nh = cfg["num_heads"][s]
    sr = cfg["sr_ratios"][s]
    eps = cfg["norm_eps"]
    n, h, w, _ = x.shape
    y = _ln(x, P, f"{b}.norm1", eps, q)
    qm = _linear(y, P, f"{b}.attn.q", q)
    kv_in = y
    if sr > 1:
        kv_in = _conv(y, P[f"{b}.attn.sr.weight"], P[f"{b}.attn.sr.bias"], q, stride=sr)
        kv_in = _ln(kv_in, P, f"{b}.attn.norm", 1e-5, q)
    kv = _linear(kv_in, P, f"{b}.attn.kv", q).reshape(n, -1, 2 * d)
    hd = d // nh
    heads = lambda t: t.reshape(n, -1, nh, hd).transpose(1, 2)
    ctx = _attention(heads(qm), heads(kv[..., :d]), heads(kv[..., d:]), q)
    ctx = ctx.transpose(1, 2).reshape(n, h, w, d)
    rate, keep_a, keep_f = draw if draw is not None else (0.0, None, None)
    x = q(x + _branch(_linear(ctx, P, f"{b}.attn.proj", q), keep_a, rate))
    z = _linear(_ln(x, P, f"{b}.norm2", eps, q), P, f"{b}.mlp.fc1", q)
    z = _conv(z, P[f"{b}.mlp.dwconv.dwconv.weight"], P[f"{b}.mlp.dwconv.dwconv.bias"], q,
              padding=1, groups=z.shape[-1])
    z = _linear(F.gelu(z), P, f"{b}.mlp.fc2", q)
    return q(x + _branch(z, keep_f, rate))


def backbone(x, P, cfg, q, draws, remat=False):
    """x (N, H, W, 3) normalised -> the four stage maps (N, h_s, w_s, C_s)."""
    outs = []
    block_draws = draws.get("blocks") or [None] * sum(cfg["depths"])
    g = 0
    for s in range(4):
        pre = f"backbone.patch_embed{s + 1}"
        k = cfg["patch_sizes"][s]
        x = _conv(x, P[f"{pre}.proj.weight"], P[f"{pre}.proj.bias"], q,
                  stride=cfg["patch_strides"][s], padding=k // 2)
        x = _ln(x, P, f"{pre}.norm", 1e-5, q)
        for i in range(cfg["depths"][s]):
            run = lambda t, s=s, i=i, g=g: mit_block(t, P, f"backbone.block{s + 1}.{i}", cfg,
                                                     s, q, block_draws[g])
            x = checkpoint(run, x, use_reentrant=False) if remat else run(x)
            g += 1
        x = _ln(x, P, f"backbone.norm{s + 1}", cfg["norm_eps"], q)
        outs.append(x)
    return outs


def decode(feats, P, cfg, q, train):
    """Per-frame MLP decode: each level projected, resized to 1/4,
    concatenated [c4, c3, c2, c1], fused by a 1x1 conv, BatchNorm (batch
    statistics in training), ReLU. (N, h, w, f)."""
    h = "decode_head"
    size = feats[0].shape[1:3]
    levels = [_resize(_linear(feats[l - 1], P, f"{h}.linear_c{l}.proj", q), size)
              for l in (4, 3, 2, 1)]
    a = _conv(torch.cat(levels, dim=-1), P[f"{h}.linear_fuse.conv.weight"], None, q)
    if train:
        mean = a.mean(dim=(0, 1, 2))
        var = (a - mean).square().mean(dim=(0, 1, 2))
    else:
        mean = P[f"{h}.linear_fuse.bn.running_mean"]
        var = P[f"{h}.linear_fuse.bn.running_var"]
    z = (a - mean) * torch.rsqrt(var + 1e-5) * P[f"{h}.linear_fuse.bn.weight"]
    return q(torch.relu(z + P[f"{h}.linear_fuse.bn.bias"]))


def _dropout2d(x, keep, p):
    if keep is None:
        return x
    n, c = x.shape[0], x.shape[-1]
    return x * (keep.float() / (1.0 - p)).reshape(n, 1, 1, c)


def _pred(x, P, name, q):
    w = P[f"{name}.weight"]
    return q(F.linear(q(x), q(w.reshape(w.shape[0], -1)), P[f"{name}.bias"]))


# ---- CFFM focal decoder


def _rel_index(q_hw, k_hw) -> np.ndarray:
    qh, qw = q_hw
    kh, kw = k_hw
    cq = np.stack(np.meshgrid(np.arange(qh), np.arange(qw), indexing="ij")).reshape(2, -1)
    ck = np.stack(np.meshgrid(np.arange(kh), np.arange(kw), indexing="ij")).reshape(2, -1)
    rel = (cq[:, :, None] - ck[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += kh - 1
    rel[:, :, 1] += kw - 1
    rel[:, :, 0] *= qw + kw - 1
    return rel.sum(-1)


def _windows(x, ws):
    """(B, Hp, Wp, C) -> (B, nW, ws*ws, C)."""
    b, hp, wp, c = x.shape
    x = x.reshape(b, hp // ws, ws, wp // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, -1, ws * ws, c)


def _unfold(x, kernel, stride, pad, keep_from=0):
    """nn.Unfold of (B, H, W, C) with zero padding: (B, nOut, entries, C) and
    the additive 0 / -100 mask of the padded entries (nOut, entries)."""
    b, h, w, c = x.shape
    cols = F.unfold(x.permute(0, 3, 1, 2), kernel, padding=pad, stride=stride)
    cols = cols.reshape(b, c, kernel * kernel, -1).permute(0, 3, 2, 1)
    ones = torch.ones((1, 1, h, w), device=x.device, dtype=x.dtype)
    valid = F.unfold(ones, kernel, padding=pad, stride=stride)[0].t() > 0.5
    sel = torch.tensor([di >= keep_from and dj >= keep_from
                        for di in range(kernel) for dj in range(kernel)], device=x.device)
    return cols[:, :, sel], torch.where(valid[:, sel], 0.0, -100.0)


def _pool(x, P, name, pw, q):
    """pool_layers: a learned pw x pw pooling, Linear(pw^2 -> 1) per window."""
    b, h, w, c = x.shape
    x6 = x.reshape(b, h // pw, pw, w // pw, pw, c)
    wt = P[f"{name}.weight"].reshape(pw, pw)
    return q(torch.einsum("bipjqc,pq->bijc", q(x6), q(wt)) + P[f"{name}.bias"])


def cffm_block(x, P, name, dec, q):
    """One CFFM block on (B, T, H, W, C): the target (last) frame's 7x7
    windows attend to their own tokens, the four diagonal rolls, the pooled
    target windows and the pooled reference frames; the last frame is
    updated by the attention and an MLP."""
    b, t, h0, w0, c = x.shape
    ws, e, nh = dec["window_size"], dec["expand_size"], dec["num_heads"]
    hp, wp = math.ceil(h0 / ws) * ws, math.ceil(w0 / ws) * ws
    n_wh, n_ww = hp // ws, wp // ws
    xn = F.pad(_ln(x, P, f"{name}.norm1", dec["norm_eps"], q), (0, 0, 0, wp - w0, 0, hp - h0))
    target = xn[:, -1]
    at = f"{name}.attn"
    qkv = _linear(target, P, f"{at}.qkv", q)
    qm, km, vm = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
    sel = torch.as_tensor(np.concatenate([r * ws * ws + np.nonzero(m)[0] for r, m in
                                          enumerate(_rolled_masks(ws, e))]), device=x.device)
    rolls = ((-e, -e), (-e, e), (e, -e), (e, e))
    rolled = lambda m: torch.cat([_windows(torch.roll(m, sh, dims=(1, 2)), ws)
                                  for sh in rolls], dim=2)[:, :, sel]
    ks, vs = [_windows(km, ws), rolled(km)], [_windows(vm, ws), rolled(vm)]
    n_w = n_wh * n_ww
    masks = [torch.zeros((n_w, ws * ws + sel.numel()), device=x.device)]
    wkv = P[f"{at}.qkv.weight"][c:]
    bkv = P[f"{at}.qkv.bias"][c:]
    biases = [P[f"{at}.relative_position_bias_table"][
        torch.as_tensor(_rel_index((ws, ws), (ws, ws)).reshape(-1), device=x.device)
    ].reshape(ws * ws, ws * ws, nh).permute(2, 0, 1),
        P[f"{at}.relative_position_bias_table_to_neighbors"][0]]
    sources = []
    for k in range(dec["focal_level"] - 1):
        stride, pw = 2 ** k, ws // 2 ** k
        ph, pwid = n_wh * stride, n_ww * stride
        src = target
        if (ph * pw, pwid * pw) != (hp, wp):
            raise ValueError("target focal levels other than the window's own size")
        kernel = 2 * (dec["focal_window"] // 2) + 2 ** k + (2 ** k - 1)
        kk = dec["focal_window"] + 2 ** k - 1
        sources.append((_pool(src, P, f"{name}.pool_layers.{k}", pw, q), kernel, stride,
                        2 ** k - 1, f"{at}.relative_position_bias_table_to_windows.{k}", kk))
    for k, fl in enumerate(dec["focal_l_clips"]):
        pw = ws // fl
        src = _resize(xn[:, k], (n_wh * fl * pw, n_ww * fl * pw))
        kernel = dec["focal_kernel_clips"][k]
        sources.append((_pool(src, P, f"{name}.pool_layers_clips.{k}", pw, q), kernel, fl, 0,
                        f"{at}.relative_position_bias_table_to_windows_clips.{k}", kernel))
    for pooled, kernel, stride, keep_from, table, kk in sources:
        kv = F.linear(q(pooled), q(wkv), bkv)
        pad = kernel // 2 if stride <= ws else 0
        kp, mk = _unfold(kv[..., :c], kernel, stride, pad, keep_from)
        vp, _ = _unfold(kv[..., c:], kernel, stride, pad, keep_from)
        ks.append(kp)
        vs.append(vp)
        masks.append(mk)
        idx = torch.as_tensor(_rel_index((ws, ws), (kk, kk)).reshape(-1), device=x.device)
        biases.append(P[table][:, idx].reshape(nh, ws * ws, -1))
    kk_ = torch.cat(ks, dim=2)
    vv_ = torch.cat(vs, dim=2)
    bias = torch.cat(biases, dim=-1)[None, None] + torch.cat(masks, dim=1)[None, :, None, None]
    hd = c // nh
    heads = lambda t_: t_.reshape(b, n_w, t_.shape[2], nh, hd).transpose(2, 3)
    out = _attention(heads(_windows(qm, ws)), heads(kk_), heads(vv_), q, bias)
    out = _linear(out.transpose(2, 3).reshape(b, n_w, ws * ws, c), P, f"{at}.proj", q)
    out = out.reshape(b, n_wh, n_ww, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    out = out.reshape(b, hp, wp, c)[:, :h0, :w0]
    last = q(x[:, -1] + out)
    mlp = _linear(F.gelu(_linear(_ln(last, P, f"{name}.norm2", dec["norm_eps"], q), P,
                                 f"{name}.mlp.fc1", q)), P, f"{name}.mlp.fc2", q)
    return torch.cat([x[:, :-1], q(last + mlp)[:, None]], dim=1)


def segmentor(imgs, P, cfg, q=None, train=False, draws=None, remat=False):
    """imgs (B, T, H, W, 3) normalised. Eval: the target frame's logits
    (B, H/4, W/4, K) (the last frame's plain logits when T is not the
    configured clip length). Train: (B, T+1, H/4, W/4, K), every frame's
    logits and the refined last frame."""
    q = q or Quant()
    draws = draws or {}
    b, t, hh, ww, _ = imgs.shape
    feats = backbone(imgs.reshape(b * t, hh, ww, 3), P, cfg, q, draws, remat)
    fused = decode(feats, P, cfg, q, train)
    h, w = fused.shape[1:3]
    f = cfg["embed_dim"]
    if train or t != cfg["num_clips"]:
        p = cfg["dropout_ratio"]
        x = _pred(_dropout2d(fused, draws.get("drop_frames") if train else None, p), P,
                  "decode_head.linear_pred", q).reshape(b, t, h, w, -1)
        if not train:
            return x[:, -1]
    clip = _resize(fused, (h // 2, w // 2)).reshape(b, t, h // 2, w // 2, f)
    refined = clip
    for j in range(cfg["decoder"]["depth"]):
        refined = cffm_block(refined, P, f"decode_head.decoder_focal.blocks.{j}", cfg["decoder"],
                             q)
    last = torch.cat([clip[:, -1], refined[:, -1]], dim=-1)
    keep = draws.get("drop_last") if train else None
    x2 = _resize(_pred(_dropout2d(last, keep, cfg["dropout_ratio"]), P,
                       "decode_head.linear_pred2", q), (h, w))
    return torch.cat([x, x2[:, None]], dim=1) if train else x2


# ---------------------------------------------------------------- data, loss


def normalize(frames_u8: torch.Tensor) -> torch.Tensor:
    """uint8 BGR (..., 3) -> RGB (x - mean) / std, float32."""
    x = frames_u8.float().flip(-1)
    mean = torch.tensor(IMG_MEAN, device=x.device)
    std = torch.tensor(IMG_STD, device=x.device)
    return (x - mean) / std


def eval_input(frames_u8: torch.Tensor, img_scale) -> torch.Tensor:
    """Test pipeline of a clip (T, H, W, 3) uint8: the frame fit into
    img_scale (long, short), ratio kept, then up to multiples of 32, both
    bilinear on the float pixels, then normalised: (1, T, H', W', 3)."""
    x = frames_u8.float()
    h, w = x.shape[1:3]
    f = min(max(img_scale) / max(h, w), min(img_scale) / min(h, w))
    size = (int(h * f + 0.5), int(w * f + 0.5))
    x = _resize(x, size)
    x = _resize(x, (math.ceil(size[0] / 32) * 32, math.ceil(size[1] / 32) * 32))
    return normalize(x)[None]


def eval_logits(frames_u8, P, cfg, img_scale, q=None) -> torch.Tensor:
    """(K, H, W) logits of the clip's target frame at its original size:
    network logits resized to the network input, then to the original."""
    x = eval_input(frames_u8, img_scale)
    logits = segmentor(x, P, cfg, q)
    logits = _resize(_resize(logits, x.shape[2:4]), frames_u8.shape[1:3])
    return logits[0].permute(2, 0, 1)


def ce_mean(logits, labels, num_classes, s):
    """Mean over all pixels of the cross-entropy of the x s bilinear upsample
    of logits (N, h, w, K) against labels (N, H, W); a label outside [0, K)
    adds 0 and counts in the mean."""
    up = F.interpolate(logits.permute(0, 3, 1, 2), scale_factor=None,
                       size=(logits.shape[1] * s, logits.shape[2] * s), mode="bilinear",
                       align_corners=False)
    lbl = labels.long()
    valid = (lbl >= 0) & (lbl < num_classes)
    nll = F.cross_entropy(up, torch.where(valid, lbl, 0), reduction="none")
    return torch.where(valid, nll, 0.0).mean()


def clip_loss(out, labels, cfg):
    """0.5 x CE(every frame's logits) + CE(refined last frame)."""
    b, t = labels.shape[:2]
    k = cfg["num_classes"]
    s = labels.shape[2] // out.shape[2]
    ori = ce_mean(out[:, :t].reshape(b * t, *out.shape[2:]), labels.reshape(b * t,
                                                                            *labels.shape[2:]),
                  k, s)
    last = ce_mean(out[:, t], labels[:, -1], k, s)
    return 0.5 * ori + last


# ---------------------------------------------------------------- optimizer


def lr_at(opt: dict, step: int) -> float:
    """Poly lr with linear warmup at schedule step ``step``."""
    frac = 1.0 - step / opt["max_iters"]
    poly = (opt["lr"] - opt["min_lr"]) * max(frac, 0.0) ** opt["power"] + opt["min_lr"]
    if opt["warmup_iters"] <= 0:
        return poly
    warm = min(step / opt["warmup_iters"], 1.0)
    return poly * (1.0 - (1.0 - opt["warmup_ratio"]) * (1.0 - warm))


def group_of(name: str, opt: dict) -> tuple[float, bool]:
    """(lr multiplier, decayed) of a parameter, by the recipe's first match
    over pos_block, head, norm."""
    if "pos_block" in name:
        return 1.0, False
    if "head" in name:
        return opt["head_lr_mult"], True
    if "norm" in name:
        return 1.0, False
    return 1.0, True


class AdamW:
    """AdamW (decoupled decay lr x wd x p before the Adam update, bias
    corrections), one lr multiplier and decay flag a parameter."""

    def __init__(self, params: dict, opt: dict):
        self.params, self.opt = params, opt
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: dict, lr: float) -> None:
        self.t += 1
        b1, b2 = self.opt["betas"]
        eps = self.opt["eps"]
        for n, p in self.params.items():
            g = grads[n]
            mult, decayed = group_of(n, self.opt)
            lr_p = lr * mult
            if decayed:
                p.mul_(1.0 - lr_p * self.opt["weight_decay"])
            self.m[n].mul_(b1).add_(g, alpha=1.0 - b1)
            self.v[n].mul_(b2).addcmul_(g, g, value=1.0 - b2)
            denom = (self.v[n] / (1.0 - b2 ** self.t)).sqrt_().add_(eps)
            p.addcdiv_(self.m[n], denom, value=-lr_p / (1.0 - b1 ** self.t))


def train_steps(P0: dict, cfg: dict, batches, gen: torch.Generator, start_iter: int,
                q=None, remat=False) -> dict:
    """Follow the recipe's steps from parameters P0 on ``batches`` (each
    {"imgs": (B, T, H, W, 3) uint8, "labels": (B, T, H, W)}), drawing from
    ``gen``. Returns each step's loss, the first step's gradients and the
    parameters after the last step (f32, the trainable ones)."""
    q = q or Quant()
    params = {n: p.detach().clone().float() for n, p in P0.items() if not is_buffer(n)}
    buffers = {n: p for n, p in P0.items() if is_buffer(n)}
    adam = AdamW(params, cfg["optim"])
    losses, first = [], None
    for i, batch in enumerate(batches):
        imgs, labels = batch["imgs"], batch["labels"]
        b, t = imgs.shape[:2]
        draws = draw_masks(cfg, gen, b, t, train=True)
        leaves = {n: p.detach().requires_grad_(True) for n, p in params.items()}
        out = segmentor(normalize(imgs), {**leaves, **buffers}, cfg, q, train=True,
                        draws=draws, remat=remat)
        loss = clip_loss(out, labels, cfg)
        names = list(leaves)
        grads = dict(zip(names, torch.autograd.grad(loss, [leaves[n] for n in names],
                                                    allow_unused=True)))
        grads = {n: g if g is not None else torch.zeros_like(params[n])
                 for n, g in grads.items()}
        del out, leaves
        losses.append(float(loss.detach()))
        if first is None:
            first = {n: g.clone() for n, g in grads.items()}
        adam.step(grads, lr_at(cfg["optim"], start_iter + i))
    return {"losses": losses, "grad1": first, "params": params}
