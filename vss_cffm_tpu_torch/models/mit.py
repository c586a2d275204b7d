"""MiT (Mix Vision Transformer) encoder, channels-last (B, H, W, C).

Port of ``vss_cffm_tpu/models/mit.py``: four stages of overlapping patch
embed → transformer blocks with spatial-reduction attention (SRA) and a
Mix-FFN (fc1 → 3×3 depthwise conv → exact GELU → fc2) → LayerNorm.

Parameters keep the reference PyTorch names (``block1.0.attn.q.weight``,
``block2.1.mlp.dwconv.dwconv.weight``, ...) and are f32; every module
computes in ``compute_dtype`` (bf16 on the main path) with f32 LayerNorm
statistics and softmax, like the JAX modules' ``dtype`` plan.

Per stage, ``MiTConfig.block_impl`` picks the block form at inference:
"fused" runs LN1 and the spatial-reduced K/V here and the rest of the block
through ``ops.mit_block_fused`` where the attention has at most
``FUSED_MAX_KV`` (2048) keys, and composed above, as the JAX block does;
None runs the composed block, whose depthwise conv goes through
``ops.dwconv3x3``, or with
``MiTConfig.dwconv_impl="fused"`` its FFN half ``x + FFN(LN2 x)`` through
``ops.block_ffn_fused`` (the JAX order: the whole-block kernel first, then
the training forms, then the fused FFN). ``MixFFN`` in eval mode with
"fused" runs ``ops.mixffn_fused``; inside the block the FFN half takes
``block_ffn_fused`` first, so the segmentor never calls it. A geometry that
the FFN launches refuse (``ops.block_ffn_train_fits``) runs composed. A
block in ``train()`` mode
never takes the inference form, as the JAX block takes it only when
deterministic. ``forward(x, train=True, generator=g)`` adds stochastic depth
(timm ``DropPath``, the linear schedule over all blocks) drawn from g, and
``MiTConfig.train_block_impl`` picks the training form per stage: "full"
runs LN1 and K/V here (autograd) and the rest of the block through the
differentiable pair ``ops.mit_block_train``; "ffn" runs the attention half
composed and ``x + s·FFN(LN2 x)`` through ``ops.block_ffn_train``; None runs
the composed block. The pairs take the drop-path draws as per-frame branch
scales, drawn in the composed block's order (attention, then FFN), so one
generator seed gives every form the same masks; a geometry the pair's gate
refuses runs composed. Every form shares one parameter tree. Dropout inside
SRA and the MixFFN is 0 in every MiT variant and is not ported: a rate > 0
raises.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import parallel
from ..config import TRAIN_BLOCK_IMPLS, MiTConfig
from ..ops import (block_ffn_fused, block_ffn_train, block_ffn_train_fits, dwconv3x3,
                   mit_block_fused, mit_block_train, mit_block_train_fits, mixffn_fused)
from ..ops.cfm_attention import scale_in

# the most keys of the spatial-reduced attention that the inference block
# form takes; above, the block runs composed, as the JAX block does
FUSED_MAX_KV = 2048

__all__ = ["MiT", "MiTBlock", "OverlapPatchEmbed", "SRAttention", "MixFFN", "dense_t",
           "linear", "layer_norm", "conv2d_nhwc", "derived", "drop_path", "keep_mask",
           "branch_scale"]


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


def keep_mask(n: int, rate: float, generator: torch.Generator | None,
              device: torch.device, shard: parallel.DrawShard | None = None) -> torch.Tensor:
    """(n,) bool: each entry kept with probability 1 − rate, drawn on the
    generator's device from ``generator`` (required). ``n`` counts this
    rank's share of a batch, sample-major; over several ranks the draw is
    the global batch's, of which the rank takes its own entries (``shard``,
    by default its rows of the world's batch: ``parallel.world_draws``), so
    that every rank's generator stays in step with the one-process run's;
    every rank must draw the same masks in the same order (a rank that draws
    alone takes its rows of a draw the others did not make)."""
    if generator is None:
        raise ValueError(f"a random rate of {rate} needs an explicit torch.Generator")
    u = (shard or parallel.world_draws()).uniforms(n, generator)
    return (u < 1.0 - rate).to(device)


def branch_scale(n: int, rate: float, generator: torch.Generator | None,
                 device: torch.device, shard: parallel.DrawShard | None = None
                 ) -> torch.Tensor:
    """(n,) f32 per-sample stochastic-depth scales: keep / (1 − rate), the
    draw ``drop_path`` makes (none when rate is 0: ones)."""
    if rate == 0.0:
        return torch.ones((n,), dtype=torch.float32, device=device)
    return keep_mask(n, rate, generator, device, shard).float() / (1.0 - rate)


def drop_path(x: torch.Tensor, rate: float, generator: torch.Generator | None,
              shard: parallel.DrawShard | None = None) -> torch.Tensor:
    """Per-sample stochastic depth (timm ``DropPath``): each sample along
    dim 0 is zeroed with probability ``rate``, the rest divided by the keep
    probability."""
    if rate == 0.0:
        return x
    keep = keep_mask(x.shape[0], rate, generator, x.device, shard)
    return torch.where(keep.reshape(-1, *([1] * (x.dim() - 1))), x / (1.0 - rate),
                       torch.zeros((), dtype=x.dtype, device=x.device))


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


def dense_t(lin: nn.Linear, dt: torch.dtype) -> torch.Tensor:
    """The dense kernel (in, out) contiguous in dt, as the block GEMMs read
    it, made once (``derived``)."""
    return derived(lin, ("t", dt), (lin.weight,), lambda: lin.weight.t().to(dt).contiguous())


class MixFFN(nn.Module):
    def __init__(self, dim: int, hidden: int, dwconv_impl: str | None = None):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.dwconv = DWConv(hidden)
        self.fc2 = nn.Linear(hidden, dim)
        self.dwconv_impl = dwconv_impl
        self.compute_dtype = torch.float32
        self.force: str | None = None

    def dwconv_args(self, x: torch.Tensor) -> tuple:
        """Arguments of ``dwconv3x3`` (with gelu=True) for FFN input x."""
        h = linear(x, self.fc1, self.compute_dtype)
        return h, self.dwconv.kernel(), self.dwconv.dwconv.bias

    def fused_params(self) -> tuple:
        """(W1, b1, kdw, bdw, W2, b2) of the inference FFN ops: dense kernels
        (in, out) in the compute dtype."""
        dt = self.compute_dtype
        return (dense_t(self.fc1, dt), self.fc1.bias, self.dwconv.kernel(),
                self.dwconv.dwconv.bias, dense_t(self.fc2, dt), self.fc2.bias)

    def fuses(self, x: torch.Tensor) -> bool:
        """Whether the inference FFN ops serve input x (B, H, W, C)."""
        _, h, w, c = x.shape
        return (self.dwconv_impl == "fused" and not self.training
                and block_ffn_train_fits(h, w, c, self.fc1.out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fuses(x):
            return mixffn_fused(x.to(self.compute_dtype), *self.fused_params(),
                                force=self.force)
        h = dwconv3x3(*self.dwconv_args(x), gelu=True, force=self.force)
        return linear(h, self.fc2, self.compute_dtype)


class MiTBlock(nn.Module):
    """Pre-norm block: x + SRA(LN1(x)), then + MixFFN(LN2(x))."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int, mlp_ratio: int,
                 qkv_bias: bool, norm_eps: float, fused: bool, drop_path_rate: float = 0.0,
                 train_impl: str | None = None, dwconv_impl: str | None = None):
        super().__init__()
        if train_impl not in TRAIN_BLOCK_IMPLS:
            raise ValueError(f"train_block_impl {train_impl!r}: expected one of "
                             f"{TRAIN_BLOCK_IMPLS}")
        self.drop_path_rate = drop_path_rate
        self.train_impl = train_impl
        self.norm1 = nn.LayerNorm(dim, eps=norm_eps)
        self.attn = SRAttention(dim, num_heads, sr_ratio, qkv_bias)
        self.norm2 = nn.LayerNorm(dim, eps=norm_eps)
        self.mlp = MixFFN(dim, int(dim * mlp_ratio), dwconv_impl)
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
        args = (x.to(dt), self.norm1.weight, self.norm1.bias, dense_t(a.q, dt), bq, k, v,
                dense_t(a.proj, dt), a.proj.bias, self.norm2.weight, self.norm2.bias,
                *m.fused_params())
        return args, dict(num_heads=a.num_heads, eps=self.norm1.eps)

    def train_args(self, x: torch.Tensor) -> tuple[tuple, dict]:
        """Arguments of ``mit_block_train`` (without the branch scales) for
        input x: LN1 and the spatial-reduced K/V computed here with autograd,
        as the JAX block does; the f32 parameters in the JAX layout (views),
        so that the pair's f32 gradients reach them unrounded."""
        dt = self.compute_dtype
        a, m = self.attn, self.mlp
        k, v = a.kv_only(layer_norm(x, self.norm1, dt))
        bq = a.q.bias if a.q.bias is not None else torch.zeros_like(a.proj.bias)
        args = (x.to(dt), self.norm1.weight, self.norm1.bias, a.q.weight.t(), bq, k, v,
                a.proj.weight.t(), a.proj.bias, *self.ffn_params())
        return args, dict(num_heads=a.num_heads, eps=self.norm1.eps)

    def ffn_params(self) -> tuple:
        """(γ2, β2, W1, b1, kdw, bdw, W2, b2) of ``block_ffn_train``: f32, JAX layout."""
        m = self.mlp
        return (self.norm2.weight, self.norm2.bias, m.fc1.weight.t(), m.fc1.bias,
                m.dwconv.kernel(), m.dwconv.dwconv.bias, m.fc2.weight.t(), m.fc2.bias)

    def n_kv(self, x: torch.Tensor) -> int:
        """Keys of the spatial-reduced attention for input x (B, H, W, C)."""
        _, h, w, _ = x.shape
        sr = self.attn.sr_ratio
        return (h // sr) * (w // sr) if sr > 1 else h * w

    def _pair_fits(self, x: torch.Tensor) -> bool:
        _, h, w, c = x.shape
        return mit_block_train_fits(h, w, c, self.mlp.fc1.out_features, self.attn.num_heads,
                                    self.n_kv(x))

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None,
                shard: parallel.DrawShard | None = None) -> torch.Tensor:
        """``shard``: where this rank's samples sit in the global drop-path
        draw (``keep_mask``)."""
        dt = self.compute_dtype
        if self.fused and not self.training and self.n_kv(x) <= FUSED_MAX_KV:
            args, kw = self.fused_args(x)
            return mit_block_fused(*args, **kw, force=self.force)
        rate = self.drop_path_rate if train else 0.0
        if train and self.train_impl == "full" and self._pair_fits(x):
            args, kw = self.train_args(x)
            s_attn = branch_scale(x.shape[0], rate, generator, x.device, shard)
            s_ffn = branch_scale(x.shape[0], rate, generator, x.device, shard)
            return mit_block_train(*args, s_attn, s_ffn, **kw, force=self.force)
        x = x + drop_path(self.attn(layer_norm(x, self.norm1, dt)), rate, generator, shard)
        _, h, w, c = x.shape
        if (train and self.train_impl == "ffn"
                and block_ffn_train_fits(h, w, c, self.mlp.fc1.out_features)):
            s_ffn = branch_scale(x.shape[0], rate, generator, x.device, shard)
            return block_ffn_train(x.to(dt), *self.ffn_params(), s_ffn, self.norm2.eps,
                                   force=self.force)
        if self.mlp.fuses(x):
            return block_ffn_fused(x.to(dt), self.norm2.weight, self.norm2.bias,
                                   *self.mlp.fused_params(), self.norm2.eps, force=self.force)
        return x + drop_path(self.mlp(layer_norm(x, self.norm2, dt)), rate, generator, shard)


class MiT(nn.Module):
    """4-stage encoder returning (B, H/4·k, W/4·k, C_k) maps at 1/4…1/32."""

    def __init__(self, cfg: MiTConfig):
        super().__init__()
        self.cfg = cfg
        if cfg.drop_rate > 0.0 or cfg.attn_drop_rate > 0.0:
            raise NotImplementedError("MiT dropout (drop_rate / attn_drop_rate > 0) is not "
                                      "ported: it is 0 in every MiT variant")
        total = sum(cfg.depths)
        dpr = [cfg.drop_path_rate * i / max(total - 1, 1) for i in range(total)]
        in_ch = 3
        per_stage = lambda v, s: v[s] if isinstance(v, tuple) else v
        for s in range(4):
            impl = per_stage(cfg.block_impl, s)
            if impl not in (None, "fused"):
                raise ValueError(f"block_impl {impl!r}: expected None or 'fused'")
            dim = cfg.embed_dims[s]
            setattr(self, f"patch_embed{s + 1}", OverlapPatchEmbed(
                in_ch, dim, cfg.patch_sizes[s], cfg.patch_strides[s]))
            first = sum(cfg.depths[:s])
            setattr(self, f"block{s + 1}", nn.ModuleList(
                MiTBlock(dim, cfg.num_heads[s], cfg.sr_ratios[s], cfg.mlp_ratios[s],
                         cfg.qkv_bias, cfg.norm_eps, fused=impl == "fused",
                         drop_path_rate=dpr[first + i],
                         train_impl=per_stage(cfg.train_block_impl, s),
                         dwconv_impl=cfg.dwconv_impl)
                for i in range(cfg.depths[s])))
            setattr(self, f"norm{s + 1}", nn.LayerNorm(dim, eps=cfg.norm_eps))
            in_ch = dim
        self.compute_dtype = torch.float32

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None,
                shard: parallel.DrawShard | None = None) -> list[torch.Tensor]:
        outs = []
        for s in range(1, 5):
            x = getattr(self, f"patch_embed{s}")(x)
            for blk in getattr(self, f"block{s}"):
                x = blk(x, train, generator, shard)
            x = layer_norm(x, getattr(self, f"norm{s}"), self.compute_dtype)
            outs.append(x)
        return outs
