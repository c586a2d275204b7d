"""CFM window attention forward.

``cfm_attention(q, ks, vs, bias, mask, nh, force=None)`` keeps the JAX
signature: window-major q (nW, 49, nh·hd), lists of K/V source groups
(nW, n_g, nh·hd), relative-position bias (nh, 49, N) and additive mask
(nW, N) with N = Σ n_g. Its CUDA kernel (``csrc/attention.cu``) replaces the
TPU kernel ``vss_cffm_tpu/ops/cfm_attention.py:_cfm_attention_pallas_impl``
(``_fwd_kernel``); the wrapper packs the groups into one K and one V with a
concat, the layout the JAX package uses for B1 at inference.

``cfm_attention_torch`` is the plain version with the kernel's arithmetic:
q·scale rounded in q's dtype, f32 scores from the rounded inputs, + bias +
mask in f32, f32 softmax, probabilities rounded to q's dtype, f32 P·V, one
cast to q's dtype.

``attention_launch`` launches the same kernel without counting; the
whole-block path (``ops/stage_block.py``) uses it for its attention step.
"""

from __future__ import annotations

from typing import Sequence

import torch

from . import _build
from ._dispatch import SMEM_LIMIT, ptr, require, stream_of, use_kernel

__all__ = ["cfm_attention", "cfm_attention_torch", "attention_launch", "scale_in"]


def scale_in(dtype: torch.dtype, value: float) -> float:
    """The attention scale rounded to ``dtype``, as JAX's weak-typed scalar
    is: x·scale_in(x.dtype, s) then rounds like x · s in x's dtype. A Python
    number, so that no host-to-device copy (and stream sync) is needed."""
    return float(torch.tensor(value, dtype=dtype))


def cfm_attention_torch(q: torch.Tensor, ks: Sequence[torch.Tensor],
                        vs: Sequence[torch.Tensor], bias: torch.Tensor,
                        mask: torch.Tensor, nh: int) -> torch.Tensor:
    n_w, area, c = q.shape
    hd = c // nh
    dt = q.dtype
    qs = q * scale_in(dt, hd ** -0.5)
    k = torch.cat(list(ks), dim=1)
    v = torch.cat(list(vs), dim=1)
    qh = qs.reshape(n_w, area, nh, hd).transpose(1, 2).float()
    kh = k.reshape(n_w, -1, nh, hd).transpose(1, 2).float()
    vh = v.reshape(n_w, -1, nh, hd).transpose(1, 2).float()
    s = qh @ kh.transpose(-1, -2)
    s = s + bias.float()[None]
    s = s + mask.float()[:, None, None, :]
    p = torch.softmax(s, dim=-1).to(dt)
    out = (p.float() @ vh).to(dt)
    return out.transpose(1, 2).reshape(n_w, area, c)


def _pick_warps(lib, n: int, hd: int, lq: int, bias: bool, mask: bool, op: str) -> int:
    for nwarps in (4, 2, 1):
        if lib.attention_smem_bytes(n, hd, nwarps, lq, int(bias), int(mask)) <= SMEM_LIMIT:
            return nwarps
    require(False, op, f"{n} keys at head dim {hd}: K, V and one warp's scores "
                       f"exceed {SMEM_LIMIT} bytes of shared memory")
    return 0


def attention_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor | None, mask: torch.Tensor | None, nh: int,
                     q_scale: float, k_scale: float, op: str) -> torch.Tensor:
    """Launch the attention kernel: q (G, Lq, C), k/v (G, N, C) bf16 → bf16.

    bias (nh, Lq, N) and mask (G, N) are f32 or None; q_scale / k_scale
    multiply q / K, rounding to bf16, before the scores. No count."""
    require(q.is_cuda, op, "a CPU tensor")
    for name, t in (("q", q), ("k", k), ("v", v)):
        require(t.dtype == torch.bfloat16, op, f"{name} of dtype {t.dtype} (bf16 only)")
        require(t.dim() == 3, op, f"{name} of shape {tuple(t.shape)}")
    g, lq, c = q.shape
    n = k.shape[1]
    require(tuple(k.shape) == (g, n, c) and k.shape == v.shape, op,
            f"k {tuple(k.shape)} / v {tuple(v.shape)} against q {tuple(q.shape)}")
    require(c % nh == 0, op, f"C={c} not divisible by {nh} heads")
    hd = c // nh
    require(hd in (32, 64), op, f"head dim {hd} (32 or 64)")
    if bias is not None:
        require(bias.dtype == torch.float32 and tuple(bias.shape) == (nh, lq, n), op,
                f"bias {bias.dtype} {tuple(bias.shape)}")
    if mask is not None:
        require(mask.dtype == torch.float32 and tuple(mask.shape) == (g, n), op,
                f"mask {mask.dtype} {tuple(mask.shape)}")
    lib = _build.library("attention")
    nwarps = _pick_warps(lib, n, hd, lq, bias is not None, mask is not None, op)
    out = torch.empty_like(q)
    dev, stream = stream_of(q)
    rc = lib.attention_fwd(ptr(q, op), ptr(k, op), ptr(v, op), ptr(bias, op),
                           ptr(mask, op), ptr(out, op), g, lq, n, nh, hd, c,
                           q_scale, k_scale, nwarps, dev, stream)
    _build.check(rc, op)
    return out


def cfm_attention(q: torch.Tensor, ks: Sequence[torch.Tensor], vs: Sequence[torch.Tensor],
                  bias: torch.Tensor, mask: torch.Tensor, nh: int,
                  force: str | None = None) -> torch.Tensor:
    """force: None (kernel on CUDA, plain on CPU) | 'torch' | 'kernel'."""
    if not use_kernel(force, q, "cfm_attention"):
        return cfm_attention_torch(q, ks, vs, bias, mask, nh)
    k = torch.cat(list(ks), dim=1).contiguous()
    v = torch.cat(list(vs), dim=1).contiguous()
    hd = q.shape[-1] // nh
    q_scale = scale_in(q.dtype, hd ** -0.5)
    out = attention_launch(q.contiguous(), k, v, bias.float().contiguous(),
                           mask.float().contiguous(), nh, q_scale, 1.0, "cfm_attention")
    cfm_attention.launches += 1
    return out


cfm_attention.launches = 0
