"""MiT (Mix Vision Transformer) encoder, channels-last (B, H, W, C).

Port of ``vss_cffm_tpu/models/mit.py``: four stages of overlapping patch
embed → transformer blocks with spatial-reduction attention (SRA) and a
Mix-FFN (fc1 → 3×3 depthwise conv → exact GELU → fc2) → LayerNorm.

Parameters keep the reference PyTorch names (``block1.0.attn.q.weight``,
``block2.1.mlp.dwconv.dwconv.weight``, ...) and are f32; every module
computes in ``compute_dtype`` (bf16 on the main path) with f32 LayerNorm
statistics and softmax, like the JAX modules' ``dtype`` plan.

Per stage, ``MiTConfig.block_impl`` picks the block form: "fused" runs LN1
and the spatial-reduced K/V here and the rest of the block through
``ops.mit_block_fused``; None runs the composed block, whose depthwise conv
goes through ``ops.dwconv3x3``. Both forms share one parameter tree.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import MiTConfig
from ..ops import dwconv3x3, mit_block_fused
from ..ops.cfm_attention import scale_in

__all__ = ["MiT", "MiTBlock", "OverlapPatchEmbed", "SRAttention", "MixFFN",
           "linear", "layer_norm", "conv2d_nhwc", "derived"]


def derived(owner: nn.Module, key: Any, params: Sequence[torch.Tensor],
            make: Callable[[], Any]) -> Any:
    """``make()``, a value computed from ``params`` alone (a weight cast to the
    compute dtype, laid out for a kernel, or gathered into a bias), made once
    and kept on ``owner`` under ``key`` until one of ``params`` gets new
    storage (``.to``, a new device) or is changed in place (its version
    counter: ``load_state_dict``, ``init_weights``). Nothing is kept while
    autograd records, so no graph is reused."""
    if torch.is_grad_enabled():
        return make()
    stamp = tuple((p.device, p.data_ptr(), p._version) for p in params)
    cache = owner.__dict__.setdefault("_derived", {})
    hit = cache.get(key)
    if hit is not None and hit[0] == stamp:
        return hit[1]
    value = make()
    cache[key] = (stamp, value)
    return value


def _cast(mod: nn.Module, name: str, dt: torch.dtype) -> torch.Tensor | None:
    """Parameter ``name`` of ``mod`` in dtype dt, made once (``derived``)."""
    p = getattr(mod, name)
    if p is None:
        return None
    return derived(mod, (name, dt), (p,), lambda: p.to(dt))


def linear(x: torch.Tensor, lin: nn.Linear, dt: torch.dtype) -> torch.Tensor:
    return F.linear(x.to(dt), _cast(lin, "weight", dt), _cast(lin, "bias", dt))


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm, dt: torch.dtype) -> torch.Tensor:
    """LayerNorm with f32 statistics, output in dt."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                        ln.bias.float(), ln.eps).to(dt)


def conv2d_nhwc(x: torch.Tensor, conv: nn.Conv2d, dt: torch.dtype) -> torch.Tensor:
    y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), _cast(conv, "weight", dt),
                 _cast(conv, "bias", dt), stride=conv.stride, padding=conv.padding,
                 groups=conv.groups)
    return y.permute(0, 2, 3, 1)


class OverlapPatchEmbed(nn.Module):
    """Strided conv (padding k//2) + LayerNorm(eps 1e-5)."""

    def __init__(self, in_chans: int, embed_dim: int, patch_size: int, stride: int):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, stride, patch_size // 2)
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5)
        self.compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return layer_norm(conv2d_nhwc(x, self.proj, dt), self.norm, dt)


class SRAttention(nn.Module):
    """Attention whose K/V come from an sr×sr stride-sr conv (VALID, floor)
    of the token map + LayerNorm(eps 1e-5); no reduction when sr == 1."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int, qkv_bias: bool = True):
        super().__init__()
        self.dim, self.num_heads, self.sr_ratio = dim, num_heads, sr_ratio
        self.q = nn.Linear(dim, dim, bias=qkv_bias)
        self.kv = nn.Linear(dim, 2 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = nn.Conv2d(dim, dim, sr_ratio, sr_ratio)
            self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.compute_dtype = torch.float32

    def kv_only(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Spatial-reduced (K, V), each (B, S, C) contiguous, from LN1(x)."""
        dt = self.compute_dtype
        kv_in = x
        if self.sr_ratio > 1:
            kv_in = layer_norm(conv2d_nhwc(x, self.sr, dt), self.norm, dt)
        b = x.shape[0]
        kv = linear(kv_in, self.kv, dt).reshape(b, -1, 2, self.dim)
        return kv[:, :, 0].contiguous(), kv[:, :, 1].contiguous()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        b, h, w, c = x.shape
        nh, hd = self.num_heads, c // self.num_heads
        q = linear(x, self.q, dt).reshape(b, h * w, nh, hd).transpose(1, 2)
        k, v = self.kv_only(x)
        k = k.reshape(b, -1, nh, hd).transpose(1, 2)
        v = v.reshape(b, -1, nh, hd).transpose(1, 2)
        attn = (q * scale_in(dt, hd ** -0.5)) @ k.transpose(-1, -2)
        attn = torch.softmax(attn.float(), dim=-1).to(dt)
        ctx = (attn @ v).transpose(1, 2).reshape(b, h, w, c)
        return linear(ctx, self.proj, dt)


class DWConv(nn.Module):
    """Holder of the depthwise conv (reference name ``mlp.dwconv.dwconv``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 3, 1, 1, groups=dim)

    def kernel(self) -> torch.Tensor:
        """(3, 3, 1, C) contiguous, the JAX package's depthwise layout."""
        w = self.dwconv.weight
        return derived(self, "kernel", (w,), lambda: w.permute(2, 3, 1, 0).contiguous())


class MixFFN(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.dwconv = DWConv(hidden)
        self.fc2 = nn.Linear(hidden, dim)
        self.compute_dtype = torch.float32
        self.force: str | None = None

    def dwconv_args(self, x: torch.Tensor) -> tuple:
        """Arguments of ``dwconv3x3`` (with gelu=True) for FFN input x."""
        h = linear(x, self.fc1, self.compute_dtype)
        return h, self.dwconv.kernel(), self.dwconv.dwconv.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = dwconv3x3(*self.dwconv_args(x), gelu=True, force=self.force)
        return linear(h, self.fc2, self.compute_dtype)


class MiTBlock(nn.Module):
    """Pre-norm block: x + SRA(LN1(x)), then + MixFFN(LN2(x))."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int, mlp_ratio: int,
                 qkv_bias: bool, norm_eps: float, fused: bool):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=norm_eps)
        self.attn = SRAttention(dim, num_heads, sr_ratio, qkv_bias)
        self.norm2 = nn.LayerNorm(dim, eps=norm_eps)
        self.mlp = MixFFN(dim, int(dim * mlp_ratio))
        self.fused = fused
        self.compute_dtype = torch.float32
        self.force: str | None = None

    def fused_args(self, x: torch.Tensor) -> tuple[tuple, dict]:
        """Arguments of ``mit_block_fused`` for input x: LN1 and the
        spatial-reduced K/V are computed here, weights in the JAX layout."""
        dt = self.compute_dtype
        a, m = self.attn, self.mlp
        k, v = a.kv_only(layer_norm(x, self.norm1, dt))
        bq = a.q.bias if a.q.bias is not None else torch.zeros_like(a.proj.bias)
        # dense kernels (in, out) contiguous in dt, as the block's GEMMs read them
        wt = lambda lin: derived(lin, ("t", dt), (lin.weight,),
                                 lambda: lin.weight.t().to(dt).contiguous())
        args = (x.to(dt), self.norm1.weight, self.norm1.bias, wt(a.q), bq, k, v,
                wt(a.proj), a.proj.bias, self.norm2.weight, self.norm2.bias,
                wt(m.fc1), m.fc1.bias, m.dwconv.kernel(), m.dwconv.dwconv.bias,
                wt(m.fc2), m.fc2.bias)
        return args, dict(num_heads=a.num_heads, eps=self.norm1.eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if self.fused:
            args, kw = self.fused_args(x)
            return mit_block_fused(*args, **kw, force=self.force)
        x = x + self.attn(layer_norm(x, self.norm1, dt))
        return x + self.mlp(layer_norm(x, self.norm2, dt))


class MiT(nn.Module):
    """4-stage encoder returning (B, H/4·k, W/4·k, C_k) maps at 1/4…1/32."""

    def __init__(self, cfg: MiTConfig):
        super().__init__()
        self.cfg = cfg
        in_ch = 3
        for s in range(4):
            impl = cfg.block_impl[s] if isinstance(cfg.block_impl, tuple) else cfg.block_impl
            if impl not in (None, "fused"):
                raise ValueError(f"block_impl {impl!r}: expected None or 'fused'")
            dim = cfg.embed_dims[s]
            setattr(self, f"patch_embed{s + 1}", OverlapPatchEmbed(
                in_ch, dim, cfg.patch_sizes[s], cfg.patch_strides[s]))
            setattr(self, f"block{s + 1}", nn.ModuleList(
                MiTBlock(dim, cfg.num_heads[s], cfg.sr_ratios[s], cfg.mlp_ratios[s],
                         cfg.qkv_bias, cfg.norm_eps, fused=impl == "fused")
                for _ in range(cfg.depths[s])))
            setattr(self, f"norm{s + 1}", nn.LayerNorm(dim, eps=cfg.norm_eps))
            in_ch = dim
        self.compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        outs = []
        for s in range(1, 5):
            x = getattr(self, f"patch_embed{s}")(x)
            for blk in getattr(self, f"block{s}"):
                x = blk(x)
            x = layer_norm(x, getattr(self, f"norm{s}"), self.compute_dtype)
            outs.append(x)
        return outs
