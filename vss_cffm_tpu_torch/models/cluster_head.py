"""CFFM++'s global-temporal-context head: cross-attention from the target
frame's tokens to the video's cluster centres, channels-last.

Port of ``vss_cffm_tpu/models/cluster_head.py`` (the reference
``BasicLayer_cluster`` chain with ``only_use_cluster_center_as_context=True``,
``swin_transformer_2d.py:157-262, 563-665, 1039-1148``). With no shift and
attention only between each token and the centres, the reference's window
partition is a no-op, so the layer is one pre-norm block: per-token
cross-attention over the centres, then the MLP.

Parameter names follow the reference, so that the JAX package's
``utils/torch_convert.py:178-190`` reads them unchanged:
``decoder_swin.blocks.0.{norm1, norm2, attn.qkv, attn.qkv_cluster,
attn.proj_cluster, mlp.fc1, mlp.fc2}``. ``attn.qkv`` is (3C, C) as in the
reference, which uses only q: the port multiplies by its first C rows.

One ``norm1`` normalises both the tokens and the centres (reference
``SwinTransformerBlock_cluster.forward:616-622``). The scores are taken in
the compute dtype and the softmax in f32, padded centres at −inf, then cast
back; GELU is exact. The JAX package computes this with ``einsum``s outside
any Pallas kernel, so the port's counterpart is plain PyTorch.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.cfm_attention import scale_in
from .cffm_transformer import _Mlp
from .mit import derived, layer_norm, linear

__all__ = ["ClusterCrossAttention", "ClusterBlock", "ClusterDecoder"]


class ClusterCrossAttention(nn.Module):
    """q from the tokens, k / v from the cluster centres (reference ``:209-262``)."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.qkv_cluster = nn.Linear(dim, 2 * dim, bias=qkv_bias)
        self.proj_cluster = nn.Linear(dim, dim)

    def _q(self, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        c, qkv = self.dim, self.qkv
        w, b = derived(self, ("q", dt), (qkv.weight, qkv.bias), lambda: (
            qkv.weight[:c].to(dt), None if qkv.bias is None else qkv.bias[:c].to(dt)))
        return F.linear(x.to(dt), w, b)

    def forward(self, x: torch.Tensor, centers: torch.Tensor, mask: torch.Tensor | None,
                dt: torch.dtype) -> torch.Tensor:
        """x (B, N, C) and centers (B, K, C), both normalised; mask (B, K)
        bool, True on the valid centres, or None."""
        b, n, c = x.shape
        nh = self.num_heads
        hd = c // nh
        q = self._q(x, dt).reshape(b, n, nh, hd).transpose(1, 2)
        kv = linear(centers, self.qkv_cluster, dt).reshape(b, -1, 2, nh, hd)
        k, v = kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)
        attn = ((q * scale_in(dt, hd ** -0.5)) @ k.transpose(-1, -2)).float()
        if mask is not None:
            attn = attn.masked_fill(~mask[:, None, None, :], float("-inf"))
        attn = torch.softmax(attn, dim=-1).to(dt)
        out = (attn @ v).transpose(1, 2).reshape(b, n, c)
        return linear(out, self.proj_cluster, dt)


class ClusterBlock(nn.Module):
    """Pre-norm block: x + attn(norm1 x, norm1 centres), then + MLP(norm2 x)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 norm_eps: float = 1e-5):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=norm_eps)
        self.attn = ClusterCrossAttention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=norm_eps)
        self.mlp = _Mlp(dim, int(dim * mlp_ratio))
        self.compute_dtype = torch.float32

    def forward(self, tokens: torch.Tensor, centers: torch.Tensor,
                mask: torch.Tensor | None) -> torch.Tensor:
        dt = self.compute_dtype
        attn = self.attn(layer_norm(tokens, self.norm1, dt), layer_norm(centers, self.norm1, dt),
                         mask, dt)
        tokens = tokens.to(dt) + attn
        return tokens + self.mlp(layer_norm(tokens, self.norm2, dt), dt)


class ClusterDecoder(nn.Module):
    """(B, H, W, C) features of the target frame and (B, K, C) centres, or a
    ``(centers, mask)`` pair whose mask (B, K) marks the valid rows of a
    zero-padded centre set (``eval.prototypes.ClusterStore``) →
    (B, H, W, C)."""

    def __init__(self, dim: int, num_heads: int = 8, mlp_ratio: float = 4.0,
                 norm_eps: float = 1e-5):
        super().__init__()
        self.blocks = nn.ModuleList([ClusterBlock(dim, num_heads, mlp_ratio, norm_eps)])

    def forward(self, x: torch.Tensor, centers) -> torch.Tensor:
        mask = None
        if isinstance(centers, (tuple, list)):
            centers, mask = centers
        b, h, w, c = x.shape
        tokens = x.reshape(b, h * w, c)
        for blk in self.blocks:
            tokens = blk(tokens, centers, mask)
        return tokens.reshape(b, h, w, c)
