"""CFM window attention, forward and backward.

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

The op is differentiable: a ``torch.autograd.Function`` over the packed
(q, K, V, bias, mask) holds the forward kernel and the backward kernel
(``csrc/attention_bwd.cu``), which replaces the TPU kernel
``_cfm_attention_bwd_pallas_rc`` (``_bwd_kernel_rc``): the softmax is
recomputed, then dq, dK, dV and dbias (summed over windows) come out. The
concat of the K/V groups stays outside the Function, so autograd splits dK
and dV back into groups; the mask gets no gradient; dbias flows through the
bias gather to the relative-position tables. ``cfm_attention_bwd`` is the
backward's own op (force rule and launch count), ``cfm_attention_bwd_torch``
its plain version with ``_bwd_kernel_rc``'s arithmetic: qs = q·scale
rounded to q's dtype, f32 scores + bias + mask and f32 softmax p, dP from g
and V, ds = p∘(dP − Σ dP∘p) in f32, ds rounded to q's dtype for dq and dK,
p rounded for dV, dbias = Σ over windows of the f32 ds, dq = (dq_h rounded
to q's dtype)·scale, rounded again.

Two module switches, named and defaulted as in the JAX package and read
when the op's forward runs, choose the backward:

- ``_BWD = "recompute"`` (the default) takes the backward above;
  ``"kernel"`` makes the forward also write the normalised softmax p
  (``cfm_attention_probs``, the same kernel with its probabilities output;
  the TPU kernel's ``_cfm_attention_pallas_impl(..., with_probs=True)``)
  and keeps (q, K, V, p) for the backward ``cfm_attention_bwd_probs``
  (``csrc/attention_bwd.cu`` in its probabilities mode), which replaces
  ``_cfm_attention_bwd_pallas`` (``_bwd_kernel``): no q·Kᵀ recompute and no
  exps. p is (nW, nh, 49, N) and held from the forward to the backward.
- ``_PROBS_DTYPE = torch.float32``: the dtype p is kept in; None keeps it in
  q's dtype (bf16 on the card), which moves the gradients by about 1 %.

``cfm_attention_probs_torch`` and ``cfm_attention_bwd_probs_torch`` are the
plain versions: the forward above returning p (f32 softmax, cast to the
probabilities' dtype), and ``_bwd_kernel``'s arithmetic from ``probs.float()``
on, as in the recompute backward.

``attention_launch`` launches the forward kernel without counting; the
whole-block path (``ops/stage_block.py``) uses it for its attention step.
It chooses between the kernel's two instances by N: the resident one (K and
V of a (group, head) in shared memory) wherever they fit, the key-tiled one
(``attention_fwd_tiled``) beyond, which multi-scale test-time augmentation
reaches in the MiT stages (920 and 1269 keys at head dim 64, where the
resident one stops at 896). The key-tiled instance writes no probabilities,
and counts its own launches. It replaces row 1's attention step at those
keys (``vss_cffm_tpu/ops/stage_block.py``, ``_kernel`` of
``mit_block_fused``) and is bound by the special-function units and the
tensor cores of two passes over the keys (the reference normalises p before
rounding it, so the statistics come first): its wrapper scales K once (a
bf16 elementwise pass, as the JAX block scales K outside its kernel), and
the kernel streams 64-key K and V tiles by TMA through a ring of
``TILED_STAGES`` stages with mbarriers into blocks of 128 query rows (two
warpgroups, ``wgmma`` for q·Kᵀ and P·V), in the resident instance's order of
arithmetic. ``tiled_plan`` mirrors its ring and shared memory.
The wrappers' gates ask the libraries for a block's shared memory
(``attention_fwd_smem_bytes``, ``attention_bwd_smem_bytes``), and
``blocks_per_sm`` gives the blocks one SM holds (the backward's window
tiles fill one wave of them).
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch

from . import _build
from ._dispatch import SMEM_LIMIT, ptr, require, stream_of, use_kernel

__all__ = ["cfm_attention", "cfm_attention_torch", "cfm_attention_bwd",
           "cfm_attention_bwd_torch", "cfm_attention_probs", "cfm_attention_probs_torch",
           "cfm_attention_bwd_probs", "cfm_attention_bwd_probs_torch", "attention_launch",
           "attention_fwd_tiled", "attention_torch", "blocks_per_sm", "scale_in", "tiled_plan"]

# the backward of cfm_attention: "recompute" (the softmax recomputed from q
# and K) or "kernel" (the forward saves p, the backward reads it)
_BWD = "recompute"
# the dtype of the saved p; None: q's dtype
_PROBS_DTYPE = torch.float32
_BWD_MODES = ("recompute", "kernel")


@functools.lru_cache(maxsize=None)
def scale_in(dtype: torch.dtype, value: float) -> float:
    """The attention scale rounded to ``dtype``, as JAX's weak-typed scalar
    is: x·scale_in(x.dtype, s) then rounds like x · s in x's dtype. A Python
    number, so that no host-to-device copy (and stream sync) is needed."""
    return float(torch.tensor(value, dtype=dtype))


def _fwd_torch(q, ks, vs, bias, mask, nh: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(out, the f32 softmax p (nW, nh, 49, N)) with the kernel's arithmetic."""
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
    p = torch.softmax(s, dim=-1)
    out = (p.to(dt).float() @ vh).to(dt)
    return out.transpose(1, 2).reshape(n_w, area, c), p


def cfm_attention_torch(q: torch.Tensor, ks: Sequence[torch.Tensor],
                        vs: Sequence[torch.Tensor], bias: torch.Tensor,
                        mask: torch.Tensor, nh: int) -> torch.Tensor:
    return _fwd_torch(q, ks, vs, bias, mask, nh)[0]


def _probs_dtype(q: torch.Tensor) -> torch.dtype:
    return _PROBS_DTYPE or q.dtype


def cfm_attention_probs_torch(q: torch.Tensor, ks: Sequence[torch.Tensor],
                              vs: Sequence[torch.Tensor], bias: torch.Tensor,
                              mask: torch.Tensor, nh: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(out, p): p (nW, nh, 49, N) in ``_PROBS_DTYPE`` (None: q's dtype)."""
    out, p = _fwd_torch(q, ks, vs, bias, mask, nh)
    return out, p.to(_probs_dtype(q))


_occupancy: dict = {}


def blocks_per_sm(kind: str, n: int, hd: int, device: int, mode: int = 0) -> int:
    """Blocks of the forward (kind "fwd"; mode 1 with bias and mask, 0
    without, + 2 when it writes probabilities) or backward ("bwd"; mode 0
    recompute, 1 f32 p, 2 bf16 p) kernel one SM holds, from
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``; cached per shape."""
    key = (kind, n, hd, device, mode)
    if key not in _occupancy:
        if kind == "fwd":
            got = _build.library("attention").attention_fwd_blocks_per_sm(
                n, hd, mode & 1, mode >> 1, device)
        else:
            got = _build.library("attention_bwd").attention_bwd_blocks_per_sm(
                n, hd, mode, device)
        if got <= 0:
            raise RuntimeError(f"attention {kind}: no block fits an SM at N={n}, hd={hd} "
                               f"(CUDA error {-got})")
        _occupancy[key] = got
    return _occupancy[key]


def attention_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor | None, mask: torch.Tensor | None, nh: int,
                     q_scale: float, k_scale: float, op: str,
                     probs: torch.Tensor | None = None,
                     tiled: bool | None = None) -> torch.Tensor:
    """Launch the attention kernel: q (G, Lq, C), k/v (G, N, C) bf16 → bf16.

    bias (nh, Lq, N) and mask (G, N) are f32 or None; q_scale / k_scale
    multiply q / K, rounding to bf16, before the scores. ``probs``, when
    given, (G, nh, Lq, N) f32 or bf16, receives the normalised softmax.
    ``tiled``: None picks the resident instance where K and V fit one
    block's shared memory and the key-tiled one beyond; True / False ask for
    one. No count, but the key-tiled instance's own (``attention_fwd_tiled``)."""
    require(q.is_cuda, op, "a CPU tensor")
    for name, t in (("q", q), ("k", k), ("v", v)):
        require(t.dtype == torch.bfloat16, op, lambda: f"{name} of dtype {t.dtype} (bf16 only)")
        require(t.dim() == 3, op, lambda: f"{name} of shape {tuple(t.shape)}")
    g, lq, c = q.shape
    n = k.shape[1]
    require(tuple(k.shape) == (g, n, c) and k.shape == v.shape, op,
            lambda: f"k {tuple(k.shape)} / v {tuple(v.shape)} against q {tuple(q.shape)}")
    require(c % nh == 0, op, lambda: f"C={c} not divisible by {nh} heads")
    hd = c // nh
    require(hd in (32, 64), op, lambda: f"head dim {hd} (32 or 64)")
    if bias is not None:
        require(bias.dtype == torch.float32 and tuple(bias.shape) == (nh, lq, n), op,
                lambda: f"bias {bias.dtype} {tuple(bias.shape)}")
    if mask is not None:
        require(mask.dtype == torch.float32 and tuple(mask.shape) == (g, n), op,
                lambda: f"mask {mask.dtype} {tuple(mask.shape)}")
    require((bias is None) == (mask is None), op,
            "a bias without a mask or a mask without a bias (both or neither)")
    if probs is not None:
        require(probs.dtype in (torch.float32, torch.bfloat16)
                and tuple(probs.shape) == (g, nh, lq, n), op,
                lambda: f"probs {probs.dtype} {tuple(probs.shape)} "
                        f"(f32 or bf16, {(g, nh, lq, n)})")
    require(g <= 65535 and nh <= 65535, op,
            lambda: f"{g} groups of {nh} heads (at most 65535 each)")
    lib = _build.library("attention")
    resident = lib.attention_fwd_smem_bytes(n, hd, int(probs is not None)) <= SMEM_LIMIT
    if tiled is None:
        tiled = not resident and probs is None
    if tiled:
        require(probs is None, op, "probabilities from the key-tiled instance (the resident "
                                   "instance alone writes them)")
        return attention_fwd_tiled(q, k, v, bias, mask, nh, q_scale, k_scale, op)
    require(resident, op,
            lambda: f"{n} keys at head dim {hd}: K and V exceed {SMEM_LIMIT} bytes of "
                    "shared memory")
    out = torch.empty_like(q)
    dev, stream = stream_of(q)
    rc = lib.attention_fwd(ptr(q, op), ptr(k, op), ptr(v, op), ptr(bias, op),
                           ptr(mask, op), ptr(out, op), ptr(probs, op),
                           int(probs is not None and probs.dtype == torch.bfloat16), g, lq, n,
                           nh, hd, c, q_scale, k_scale, dev, stream)
    _build.check(rc, op)
    return out


def attention_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor | None, mask: torch.Tensor | None, nh: int,
                    q_scale: float, k_scale: float) -> torch.Tensor:
    """The plain version of ``attention_launch`` (either instance): q·q_scale
    and K·k_scale rounded to their dtype, f32 scores (+ bias, + mask), f32
    softmax, p rounded to q's dtype, f32 P·V, one cast."""
    dt = q.dtype
    qh = _heads(q * q_scale if q_scale != 1.0 else q, nh).float()
    kh = _heads(k * k_scale if k_scale != 1.0 else k, nh).float()
    s = qh @ kh.transpose(-1, -2)
    if bias is not None:
        s = s + bias.float()[None]
        s = s + mask.float()[:, None, None, :]
    p = torch.softmax(s, dim=-1)
    return _merge((p.to(dt).float() @ _heads(v, nh).float()).to(dt))


def attention_fwd_tiled(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: torch.Tensor | None, mask: torch.Tensor | None, nh: int,
                        q_scale: float, k_scale: float, op: str) -> torch.Tensor:
    """The key-tiled instance on inputs ``attention_launch`` has checked;
    counted here (``attention_fwd_tiled.launches``). K·k_scale is rounded to
    bf16 here, once (the bits the kernel's own scaling gave), and the kernel
    takes K as it comes."""
    g, lq, c = q.shape
    require(c * 2 % 16 == 0, op, lambda: f"C={c}: TMA needs rows of a multiple of 16 bytes")
    if k_scale != 1.0:
        k = k * k_scale
    out = torch.empty_like(q)
    dev, stream = stream_of(q)
    rc = _build.library("attention").attention_fwd_tiled(
        ptr(q, op), ptr(k, op), ptr(v, op), ptr(bias, op), ptr(mask, op), ptr(out, op), g, lq,
        k.shape[1], nh, c // nh, c, q_scale, 1.0, dev, stream)
    _build.check(rc, op)
    attention_fwd_tiled.launches += 1
    return out


attention_fwd_tiled.launches = 0

# the key-tiled instance's constants (csrc/attention.cu)
TILED_WGS = 2         # consumer warpgroups of a block, 64 query rows each
TILED_ROWS = 64 * TILED_WGS
TILED_KEYS = 64       # keys of a K or V tile
TILED_STAGES = 4      # stages of the ring


def tiled_plan(n: int, hd: int) -> dict:
    """The key-tiled instance's ring at N keys and head dim hd, as the kernel
    lays it out: ``tiles`` of 64 keys (the last zero-filled past N by TMA),
    ``entries`` (pass, tile, stage, round) in the order the producer loads
    them (pass 1: K; pass 2: K and V; round = the stage's use, its barriers'
    parity), ``tile_bytes``, ``swizzle`` (bytes: the rows' width), and
    ``smem_bytes``: the K and V rings, a full and an empty mbarrier a stage
    and 1024 bytes to align the base (``attention_fwd_tiled_smem_bytes``)."""
    tiles = -(-n // TILED_KEYS)
    entries = [(1 + i // tiles, i % tiles, i % TILED_STAGES, i // TILED_STAGES)
               for i in range(2 * tiles)]
    tile_bytes = TILED_KEYS * hd * 2
    return dict(tiles=tiles, entries=entries, tile_bytes=tile_bytes, swizzle=hd * 2,
                smem_bytes=2 * TILED_STAGES * tile_bytes + 2 * TILED_STAGES * 8 + 1024)


def _heads(t: torch.Tensor, nh: int) -> torch.Tensor:
    """(G, L, nh·hd) → (G, nh, L, hd)."""
    g, l, c = t.shape
    return t.reshape(g, l, nh, c // nh).transpose(1, 2)


def _merge(t: torch.Tensor) -> torch.Tensor:
    g, nh, l, hd = t.shape
    return t.transpose(1, 2).reshape(g, l, nh * hd)


def _bwd_from_p(q, k, v, p, g, nh: int) -> tuple[torch.Tensor, ...]:
    """(dq, dk, dv, dbias) from the f32 softmax p (nW, nh, 49, N), with
    ``_bwd_kernel``'s roundings (the recompute backward's too)."""
    dt = q.dtype
    sc = scale_in(dt, (q.shape[-1] // nh) ** -0.5)
    qh = _heads(q * sc, nh).float()
    kh, vh, gh = _heads(k, nh).float(), _heads(v, nh).float(), _heads(g.to(dt), nh).float()
    dp = gh @ vh.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dsb = ds.to(dt).float()
    dq_h = (dsb @ kh).to(dt)
    dk = (dsb.transpose(-1, -2) @ qh).to(dt)
    dv = (p.to(dt).float().transpose(-1, -2) @ gh).to(dt)
    return (_merge(dq_h * sc).to(dt), _merge(dk).to(k.dtype), _merge(dv).to(v.dtype),
            ds.sum(dim=0))


def cfm_attention_bwd_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            bias: torch.Tensor, mask: torch.Tensor, g: torch.Tensor,
                            nh: int) -> tuple[torch.Tensor, ...]:
    """(dq, dk, dv, dbias) of the packed attention for the output cotangent g."""
    sc = scale_in(q.dtype, (q.shape[-1] // nh) ** -0.5)
    s = _heads(q * sc, nh).float() @ _heads(k, nh).float().transpose(-1, -2) + bias.float()[None]
    s = s + mask.float()[:, None, None, :]
    return _bwd_from_p(q, k, v, torch.softmax(s, dim=-1), g, nh)


def cfm_attention_bwd_probs_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  probs: torch.Tensor, g: torch.Tensor,
                                  nh: int) -> tuple[torch.Tensor, ...]:
    """(dq, dk, dv, dbias) from the forward's p (nW, nh, 49, N), any float dtype."""
    return _bwd_from_p(q, k, v, probs.float(), g, nh)


def _bwd_launch(q, k, v, bias, mask, g, nh: int, probs=None) -> tuple[torch.Tensor, ...]:
    """The backward kernel: the softmax recomputed from bias and mask, or,
    with ``probs``, read from the forward's p (bias and mask then None)."""
    op = "cfm_attention_bwd" if probs is None else "cfm_attention_bwd_probs"
    require(q.is_cuda, op, "a CPU tensor")
    for name, t in (("q", q), ("k", k), ("v", v), ("g", g)):
        require(t.dtype == torch.bfloat16 and t.dim() == 3, op,
                lambda: f"{name} {t.dtype} {tuple(t.shape)} (bf16, 3-d)")
    n_w, lq, c = q.shape
    n = k.shape[1]
    require(tuple(k.shape) == (n_w, n, c) and k.shape == v.shape and g.shape == q.shape, op,
            lambda: f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
                    f"g {tuple(g.shape)}")
    require(c % nh == 0 and c // nh in (32, 64), op,
            lambda: f"C={c} over {nh} heads (head dim 32 or 64)")
    hd = c // nh
    if probs is None:
        require(bias.dtype == torch.float32 and tuple(bias.shape) == (nh, lq, n), op,
                lambda: f"bias {bias.dtype} {tuple(bias.shape)}")
        require(mask.dtype == torch.float32 and tuple(mask.shape) == (n_w, n), op,
                lambda: f"mask {mask.dtype} {tuple(mask.shape)}")
    else:
        require(probs.dtype in (torch.float32, torch.bfloat16)
                and tuple(probs.shape) == (n_w, nh, lq, n), op,
                lambda: f"probs {probs.dtype} {tuple(probs.shape)} "
                        f"(f32 or bf16, {(n_w, nh, lq, n)})")
    require(lq <= 64, op, lambda: f"{lq} query rows (at most 64)")
    require(nh <= 65535, op, lambda: f"{nh} heads (at most 65535)")
    lib = _build.library("attention_bwd")
    require(lib.attention_bwd_smem_bytes(n, hd) <= SMEM_LIMIT, op,
            lambda: f"{n} keys at head dim {hd} exceed {SMEM_LIMIT} bytes of shared memory")
    dev, stream = stream_of(q)
    # one wave: as many window tiles per head as blocks fit on the card at once
    # (each tile writes one dbias partial)
    mode = 0 if probs is None else 1 if probs.dtype == torch.float32 else 2
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    tiles = max(1, min(n_w, blocks_per_sm("bwd", n, hd, dev, mode) * sms // nh))
    tw = -(-n_w // tiles)
    tiles = -(-n_w // tw)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    partial = torch.empty((tiles, nh, lq, n), device=q.device, dtype=torch.float32)
    scale = scale_in(q.dtype, hd ** -0.5)
    if probs is None:
        rc = lib.attention_bwd(ptr(q, op), ptr(k, op), ptr(v, op), ptr(bias, op), ptr(mask, op),
                               ptr(g, op), ptr(dq, op), ptr(dk, op), ptr(dv, op),
                               ptr(partial, op), n_w, lq, n, nh, hd, c, scale, tw, dev, stream)
    else:
        rc = lib.attention_bwd_probs(ptr(q, op), ptr(k, op), ptr(v, op), ptr(probs, op),
                                     int(probs.dtype == torch.bfloat16), ptr(g, op), ptr(dq, op),
                                     ptr(dk, op), ptr(dv, op), ptr(partial, op), n_w, lq, n, nh,
                                     hd, c, scale, tw, dev, stream)
    _build.check(rc, op)
    return dq, dk, dv, partial.sum(dim=0)


def cfm_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
                      mask: torch.Tensor, g: torch.Tensor, nh: int,
                      force: str | None = None) -> tuple[torch.Tensor, ...]:
    """(dq, dk, dv, dbias) of the packed attention. force: None (kernel on
    CUDA, plain on CPU) | 'torch' | 'kernel'."""
    if not use_kernel(force, q, "cfm_attention_bwd"):
        return cfm_attention_bwd_torch(q, k, v, bias, mask, g, nh)
    out = _bwd_launch(q, k, v, bias, mask, g.contiguous(), nh)
    cfm_attention_bwd.launches += 1
    return out


def cfm_attention_bwd_probs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            probs: torch.Tensor, g: torch.Tensor, nh: int,
                            force: str | None = None) -> tuple[torch.Tensor, ...]:
    """(dq, dk, dv, dbias) of the packed attention from the forward's p
    (nW, nh, 49, N). force: None (kernel on CUDA, plain on CPU) | 'torch' |
    'kernel'."""
    if not use_kernel(force, q, "cfm_attention_bwd_probs"):
        return cfm_attention_bwd_probs_torch(q, k, v, probs, g, nh)
    out = _bwd_launch(q, k, v, None, None, g.contiguous(), nh, probs=probs.contiguous())
    cfm_attention_bwd_probs.launches += 1
    return out


def _fwd(q, k, v, bias, mask, nh: int, kernel: bool, with_probs: bool):
    """(out, p or None) of the packed attention; a kernel launch is counted."""
    if not kernel:
        if with_probs:
            return cfm_attention_probs_torch(q, [k], [v], bias, mask, nh)
        return cfm_attention_torch(q, [k], [v], bias, mask, nh), None
    probs = None
    if with_probs:
        probs = torch.empty((q.shape[0], nh, q.shape[1], k.shape[1]), device=q.device,
                            dtype=_probs_dtype(q))
    out = attention_launch(q, k, v, bias, mask, nh, scale_in(q.dtype, (q.shape[-1] // nh) ** -0.5),
                           1.0, "cfm_attention", probs=probs)
    cfm_attention.launches += 1
    return out, probs


class _CFMAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, mask, nh, force, kernel):
        if _BWD not in _BWD_MODES:
            raise ValueError(f"cfm_attention: _BWD must be one of {_BWD_MODES}, got {_BWD!r}")
        from_probs = _BWD == "kernel"
        out, probs = _fwd(q, k, v, bias, mask, nh, kernel, from_probs)
        if from_probs:
            ctx.save_for_backward(q, k, v, probs)
        else:
            ctx.save_for_backward(q, k, v, bias, mask)
        ctx.args = (nh, force, from_probs, bias.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        nh, force, from_probs, bias_dtype = ctx.args
        if from_probs:
            q, k, v, probs = ctx.saved_tensors
            dq, dk, dv, dbias = cfm_attention_bwd_probs(q, k, v, probs, g, nh, force=force)
        else:
            q, k, v, bias, mask = ctx.saved_tensors
            dq, dk, dv, dbias = cfm_attention_bwd(q, k, v, bias, mask, g, nh, force=force)
        return dq, dk, dv, dbias.to(bias_dtype), None, None, None, None


def _packed(q, ks, vs, bias, mask, kernel: bool):
    k = torch.cat(list(ks), dim=1)
    v = torch.cat(list(vs), dim=1)
    if kernel:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        bias, mask = bias.float().contiguous(), mask.float().contiguous()
    return q, k, v, bias, mask


def cfm_attention(q: torch.Tensor, ks: Sequence[torch.Tensor], vs: Sequence[torch.Tensor],
                  bias: torch.Tensor, mask: torch.Tensor, nh: int,
                  force: str | None = None) -> torch.Tensor:
    """force: None (kernel on CUDA, plain on CPU) | 'torch' | 'kernel'; the
    backward follows the same rule (``cfm_attention_bwd``, or with
    ``_BWD = "kernel"`` ``cfm_attention_bwd_probs``)."""
    kernel = use_kernel(force, q, "cfm_attention")
    return _CFMAttention.apply(*_packed(q, ks, vs, bias, mask, kernel), nh, force, kernel)


def cfm_attention_probs(q: torch.Tensor, ks: Sequence[torch.Tensor], vs: Sequence[torch.Tensor],
                        bias: torch.Tensor, mask: torch.Tensor, nh: int,
                        force: str | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(out, p): the forward that ``_BWD = "kernel"`` runs, without autograd;
    p (nW, nh, 49, N) in ``_PROBS_DTYPE`` (None: q's dtype). Its launches
    count as ``cfm_attention``'s. force as for ``cfm_attention``."""
    kernel = use_kernel(force, q, "cfm_attention")
    q, k, v, bias, mask = _packed(q, ks, vs, bias, mask, kernel)
    return _fwd(q, k, v, bias, mask, nh, kernel, True)


cfm_attention.launches = 0
cfm_attention_bwd.launches = 0
cfm_attention_bwd_probs.launches = 0
