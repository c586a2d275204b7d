"""Whole MiT block: inference (``mit_block_fused``) and the differentiable
train pair (``mit_block_train``, forward and backward).

Both keep the JAX signature: x (B, H, W, C); k / v (B, S, C), the
spatial-reduced keys and values per frame, computed outside (the scale is
folded into K here); dense kernels in the JAX layout (in, out); kdw
(3, 3, 1, Ch). The train pair adds the per-frame stochastic-depth branch
scales s_attn and s_ffn (B,):

    y = x + s_attn·(attn(LN1 x)·Wproj + bproj);  out = y + s_ffn·FFN(LN2 y)

**Forward** (inference: the TPU kernel ``vss_cffm_tpu/ops/stage_block.py:
mit_block_fused`` (``_kernel``); training: ``_mit_block_train_fwd``
(``_train_fwd_kernel``)). The TPU kernels keep the whole block in VMEM per
(frame, row tile); the stage-3 working set does not fit one H100 block's
227 KB of shared memory, so the CUDA path is a short run of hand-written
launches, four (``FUSED_STEPS``; five where the FFN plan splits):

  1. ``block_gemm``  q   = bf16(LN1(x)·Wq + bq)              LN1 in the prologue
  2. ``attention``   ctx = bf16(softmax(q·(s·K)ᵀ)·V)          scores stay in shared memory
  3. ``block_gemm``  y   = f32(x + s_attn·(ctx·Wproj + bproj)) per-frame scale in the epilogue
  4. ``ffn_fused``   out = bf16(y + s_ffn·FFN(LN2 y))         hid and a in shared memory

The FFN launch (``ops/ffn_fused.py``, ``csrc/ffn_fused.cu``) takes a tile of
pixels at a time; where its plan splits the hidden channels over blocks, a
second pass sums the f32 partials. At inference it runs without the branch
scale. The train pair keeps q, ctx and y for the backward; the FFN half's
hid and a are recomputed there, as the TPU kernel recomputes everything
from x because VMEM is small. The plain route runs the FFN half as three
steps (``STEPS``: hid, a, out); the rounding points are the same on every
route.

**Backward** (``_mit_block_train_bwd`` (``_train_bwd_kernel``)): dx, dK,
dV and the 14 parameter gradients, as nine launches of five sources (ten
where the FFN backward's plan splits):

  1. ``ffn_bwd``      the FFN half in one launch (``ops/ffn_bwd.py``): per
                      tile LN2(y), hid, z = dw3×3(hid) + bdw, d_a =
                      bf16(go·s_ffn)·W2ᵀ, d_z = d_a·GELU′(z), d_hid and d_ln2 =
                      d_hid_b·W1ᵀ recomputed on chip, then the LN2 backward:
                      d_y = go + LN2ᵀ(d_ln2) (f32), d_attn_b = bf16(d_y·s_attn),
                      ln2 and a, d_hid_b (bf16) out; partials of the 9
                      depthwise taps Σ hid·d_z, of Σ d_z, Σ d_hid (db1), dg2,
                      dbe2, db2 = Σ go·s_ffn, dbproj = Σ d_y·s_attn
  2-3. ``gemm_tn``    dW2 = aᵀ·go_s, dW1 = ln2ᵀ·d_hid_b
  4. ``block_gemm``   d_ctx = bf16(d_attn_b·Wprojᵀ)
  5. ``sra_attention_bwd``  per (frame, head, split of its 64-query tiles):
                      p and d_s = bf16(p∘(d_p − Σ d_p∘p)) recomputed from q,
                      K, V and never written, d_q → bf16, partial Σ d_q (dbq),
                      and per split dK = scale·Σ d_sᵀ·q, dV = Σ bf16(p)ᵀ·d_ctx
                      (f32 partials summed in a fixed order)
  6. ``block_gemm``   d_ln1 = d_q_b·Wqᵀ                       (f32)
  7. ``block_bwd``    LN1 backward: dx = d_y + LN1ᵀ(d_ln1) (x's dtype), ln1
                      (bf16); partials dg1, dbe1
  8-9. ``gemm_tn``    dWproj = ctxᵀ·d_attn_b, dWq = ln1ᵀ·d_q_b: sums over the
                      rows, split over blocks, partials reduced in a fixed
                      order.

No atomics: every reduction over rows writes per-block partials that one
``torch.sum`` reduces, so results repeat exactly. The rounding points are
``_train_bwd_kernel``'s: bf16 at ln1, q, p, ctx, ln2, a, go_s, d_hid_b,
d_ctx_b, d_s and d_q_b; f32 elsewhere (z, d_z, GELU′, the LN statistics, the
bias, γ and β sums). dK is the gradient of the scaled K, times the scale.

The plain versions (``mit_block_train_torch``, ``mit_block_train_bwd_torch``)
run the same steps in PyTorch with those rounding points, so that
``mit_block_step_errors`` (with the branch scales) and
``mit_block_train_bwd_step_errors`` hold each launch on its own against its
plain steps, at a tolerance relative to that output's own largest value.
``ops/mixffn.py`` reuses the FFN launches of both (``block_ffn_train``,
``block_ffn_fused``) and the three launches of the plain FFN steps without
LN2 and the residual (``mixffn_fused``). The six launches the FFN backward
launch replaced stay as ``ffn_bwd_unfused_steps``, the yardstick it is
timed against.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import Tensor

from . import _build
from ._dispatch import (SMEM_LIMIT, custom_op, ptr, refuse_grad, require, sm_count, stream_of,
                        use_kernel)
from .cfm_attention import attention_launch, scale_in
from .dwconv import _gelu_grad, _preact, dwconv3x3_launch, dwconv3x3_torch
from .ffn_bwd import ffn_bwd_launch
from .ffn_fused import ffn_fused_launch

__all__ = ["mit_block_fused", "mit_block_torch", "mit_block_step_errors",
           "mit_block_train", "mit_block_train_bwd", "mit_block_train_torch",
           "mit_block_train_bwd_torch", "mit_block_train_fits", "mit_block_train_bwd_step_errors"]

_F32 = torch.float32
_BF16 = torch.bfloat16


def _ln_f32(xf: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
            eps: float) -> torch.Tensor:
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return (xf - mu) * torch.rsqrt(var + eps) * gamma + beta


def _mm(a: torch.Tensor, w: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """Product of inputs rounded to dt, accumulated in f32."""
    return a.to(dt).float() @ w.to(dt).float()


def _frame_rows(s: torch.Tensor, rows: int) -> torch.Tensor:
    """(B,) per-frame scales → (B·rows, 1) f32, one per row of a frame."""
    return s.float().repeat_interleave(rows).reshape(-1, 1)


def _scales(s: torch.Tensor | None, b: int, dev: torch.device, op: str) -> torch.Tensor | None:
    if s is None:
        return None
    require(tuple(s.shape) == (b,), op, f"branch scale of shape {tuple(s.shape)}, expected ({b},)")
    return s.to(device=dev, dtype=_F32).contiguous()


# block_gemm (csrc/block_gemm.cu): rows of a block (BM), the deepest
# resident A (KMAX_RES), the K step and the depth of the cp.async ring
GEMM_BM, GEMM_KMAX_RES, _GEMM_BK, _GEMM_STAGES = 64, 512, 32, 3
# blocks of 128 threads an SM holds when shared memory allows (the kernel's
# launch bounds: 3)
_GEMM_BLOCKS_PER_SM = 3


def block_gemm_smem(k: int, resident: bool, nb: int) -> int:
    """Shared memory of one block_gemm block (its ``smem_bytes``): resident A
    (BM x K rounded up to 64, bf16) or the A ring, and the W ring of nb
    64-column chunks."""
    w_ring = _GEMM_STAGES * _GEMM_BK * 64 * nb * 2
    a = -(-k // 64) * 64 * GEMM_BM * 2 if resident else _GEMM_STAGES * GEMM_BM * _GEMM_BK * 2
    return a + w_ring


@functools.lru_cache(maxsize=None)
def block_gemm_plan(m: int, n: int, k: int, resident: bool, sms: int) -> tuple[int, int]:
    """(nb, cols_per_block) of a block_gemm launch: slabs of 64·nb columns (nb
    2 unless N ≤ 64), and the columns one block walks, all of N unless the
    row blocks alone leave the card short of work: then N is cut into the
    fewest equal runs of slabs that take the least time in waves of blocks
    (a block costing its slabs, plus one for a resident A's prologue), so
    that each row block's A is read once per run."""
    nb = 1 if n <= 64 else 2
    bn = 64 * nb
    slabs = -(-n // bn)
    smem = block_gemm_smem(k, resident, nb)
    per_sm = max(1, min(_GEMM_BLOCKS_PER_SM, SMEM_LIMIT // (smem + 1024)))
    mblocks = -(-m // GEMM_BM)
    best = None
    for runs in range(1, slabs + 1):
        per_run = -(-slabs // runs)
        runs = -(-slabs // per_run)
        waves = -(-mblocks * runs // (sms * per_sm))
        cost = waves * (per_run + int(resident))
        if best is None or cost < best[0]:
            best = (cost, per_run)
    return nb, best[1] * bn


def _gemm(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None, *,
          out_dtype: torch.dtype, ln: tuple[torch.Tensor, torch.Tensor, float] | None = None,
          res: torch.Tensor | None = None, a_scale: torch.Tensor | None = None,
          o_scale: torch.Tensor | None = None, rows_per_frame: int = 1,
          op: str = "mit_block_fused", bwd: bool = False) -> torch.Tensor:
    """out (M, N) = [LN(a) | bf16(a·a_scale) | a] · w [+ bias], times o_scale,
    [+ res], on the block_gemm kernel. The scales are per frame (B,), frame
    = row // rows_per_frame. ``bwd`` launches the backward's instance of the
    kernel (the same code under its own name, for the profile)."""
    m, kdim = a.shape
    n = w.shape[1]
    require(kdim % 8 == 0 and n % 8 == 0, op, lambda: f"GEMM K={kdim}, N={n} not multiples of 8")
    require(tuple(w.shape) == (kdim, n), op, lambda: f"weight {tuple(w.shape)} for K={kdim}")
    require(a.dtype in (_BF16, _F32), op, lambda: f"GEMM input of dtype {a.dtype}")
    resident = ln is not None or a_scale is not None or a.dtype == _F32
    require(not resident or kdim <= GEMM_KMAX_RES, op,
            lambda: f"GEMM K={kdim} > {GEMM_KMAX_RES} with a LayerNorm, a scaled or an f32 A "
                    "(its rows are held in shared memory)")
    dev = a.device
    wb = w.to(device=dev, dtype=_BF16).contiguous()
    bb = None if bias is None else bias.to(device=dev, dtype=_F32).contiguous()
    g = bt = None
    eps = 0.0
    if ln is not None:
        g = ln[0].to(device=dev, dtype=_F32).contiguous()
        bt = ln[1].to(device=dev, dtype=_F32).contiguous()
        eps = ln[2]
    res_kind = 0
    if res is not None:
        require(tuple(res.shape) == (m, n), op, lambda: f"residual {tuple(res.shape)}")
        res_kind = {_BF16: 1, _F32: 2}[res.dtype]
    nb_frames = -(-m // rows_per_frame)
    sa, so = _scales(a_scale, nb_frames, dev, op), _scales(o_scale, nb_frames, dev, op)
    out = torch.empty((m, n), device=dev, dtype=out_dtype)
    nb, cols = block_gemm_plan(m, n, kdim, resident, sm_count(a))
    devi, stream = stream_of(a)
    rc = _build.library("block_gemm").gemm_ln_bias_res(
        ptr(a, op), ptr(g, op), ptr(bt, op), ptr(wb, op), ptr(bb, op), ptr(res, op),
        ptr(sa, op), ptr(so, op), ptr(out, op), m, n, kdim, int(a.dtype == _F32),
        int(ln is not None), res_kind, int(out_dtype == _F32), rows_per_frame, eps, nb, cols,
        int(bwd), devi, stream)
    _build.check(rc, op)
    return out


# ---- the forward: its steps ------------------------------------------------

# The block's six plain steps, in order, with the steps whose outputs each
# reads (every step also reads the block's own inputs). Activations are
# (M, ·) with M = B·H·W: q, ctx, a and out in x's dtype, y and hid in f32.
# The kernel route runs the FFN half as one step (FUSED_STEPS).
STEPS = (("q", ()), ("ctx", ("q",)), ("y", ("ctx",)), ("hid", ("y",)), ("a", ("hid",)),
         ("out", ("a", "y")))
FUSED_STEPS = (("q", ()), ("ctx", ("q",)), ("y", ("ctx",)), ("out", ("y",)))


def _ffn_fwd_steps(g2, be2, w1, b1, kdw, bdw, w2, b2, s_ffn, eps: float, shape, dt,
                   kernel: bool, op: str) -> dict:
    """Steps hid, a, out of the block (also the forward of the FFN-half pair
    and of the inference FFN ops in ``ops/mixffn.py``): y is the FFN's input
    and residual, (M, C) f32 or in x's dtype. Without g2 fc1 reads y as it
    is (no LayerNorm), and ``out(a, None)`` adds no residual. On the card
    these are three launches (fc1 with LN, dwconv, fc2); with g2 the kernel
    steps add ``ffn(y, res)``, the whole half as one launch (``ffn_fused``,
    with the branch scale), which every block route runs (``mixffn_fused``
    runs that launch without the LayerNorm)."""
    b, h, w, c = shape
    ch = w1.shape[1]
    m = b * h * w
    if not kernel:
        sf = None if s_ffn is None else _frame_rows(s_ffn, h * w)

        def hid_torch(y):
            ln = y if g2 is None else _ln_f32(y.float(), g2.float(), be2.float(), eps)
            return _mm(ln.to(dt), w1, dt) + b1.float()

        def out_torch(a, y):
            br = _mm(a, w2, dt) + b2.float()
            br = br if sf is None else sf * br
            return (br if y is None else br + y.float()).to(dt)

        return {
            "hid": hid_torch,
            "a": lambda hid: dwconv3x3_torch(hid.reshape(b, h, w, ch), kdw, bdw,
                                             gelu=True).to(dt).reshape(m, ch),
            "out": out_torch,
        }
    ln = None if g2 is None else (g2, be2, eps)
    steps = {
        "hid": lambda y: _gemm(y, w1, b1, out_dtype=_F32, ln=ln, op=op),
        "a": lambda hid: dwconv3x3_launch(hid.view(b, h, w, ch), kdw, bdw, gelu=True,
                                          op=op).view(m, ch),
        "out": lambda a, y: _gemm(a, w2, b2, out_dtype=_BF16, res=y, o_scale=s_ffn,
                                  rows_per_frame=h * w, op=op),
    }
    if g2 is not None:
        steps["ffn"] = lambda y, res: ffn_fused_launch(y.view(b, h, w, c), g2, be2, w1, b1, kdw,
                                                       bdw, w2, b2, eps, res, op, scale=s_ffn)
    return steps


def _block_steps(x, g1, be1, wq, bq, k, v, wproj, bproj, g2, be2, w1, b1, kdw, bdw, w2, b2,
                 num_heads: int, eps: float, kernel: bool, s_attn=None, s_ffn=None,
                 op: str = "mit_block_fused") -> dict:
    """The step functions of one block: the plain ones, or (kernel=True) the
    hand-written launches, which check their inputs first. The kernel route
    runs the FFN half as one launch, with the branch scale s_ffn in training:
    ``out(y)``, and ``ffn(y, res)`` with the residual res or none
    (``FUSED_STEPS``); the plain route runs ``STEPS``."""
    dt = x.dtype
    b, h, w, c = x.shape
    nh, dh = num_heads, c // num_heads
    m = b * h * w
    ffn = (g2, be2, w1, b1, kdw, bdw, w2, b2, s_ffn, eps, x.shape, dt, kernel, op)
    if not kernel:
        xf = x.float().reshape(m, c)
        ns = k.shape[1]
        sa = None if s_attn is None else _frame_rows(s_attn, h * w)

        def ctx_torch(q):
            qh = q.reshape(b, h * w, nh, dh).transpose(1, 2).float()      # (b, nh, hw, dh)
            kh = (k.to(dt) * scale_in(dt, dh ** -0.5)).reshape(b, ns, nh, dh)
            vh = v.to(dt).reshape(b, ns, nh, dh)
            s = qh @ kh.permute(0, 2, 3, 1).float()                        # (b, nh, hw, S)
            p = torch.softmax(s, dim=-1).to(dt)
            ctx = (p.float() @ vh.transpose(1, 2).float()).to(dt)          # (b, nh, hw, dh)
            return ctx.transpose(1, 2).reshape(m, c)

        def y_torch(ctx):
            br = _mm(ctx, wproj, dt) + bproj.float()
            return xf + (br if sa is None else sa * br)

        return {
            "q": lambda: (_mm(_ln_f32(xf, g1.float(), be1.float(), eps).to(dt), wq, dt)
                          + bq.float()).to(dt),
            "ctx": ctx_torch,
            "y": y_torch,
            **_ffn_fwd_steps(*ffn),
        }
    require(x.dim() == 4 and x.dtype == _BF16, op, f"x {x.dtype} {tuple(x.shape)} (bf16 NHWC only)")
    require(c % num_heads == 0, op, f"C={c} not divisible by {num_heads} heads")
    require(k.dim() == 3 and k.shape[0] == b and k.shape[2] == c and k.shape == v.shape, op,
            f"k {tuple(k.shape)} / v {tuple(v.shape)}")
    xf = x.contiguous().view(m, c)
    kb = k.to(_BF16).contiguous()
    vb = v.to(_BF16).contiguous()
    k_scale = scale_in(_BF16, dh ** -0.5)
    steps = {
        "q": lambda: _gemm(xf, wq, bq, out_dtype=_BF16, ln=(g1, be1, eps), op=op),
        "ctx": lambda q: attention_launch(q.view(b, h * w, c), kb, vb, None, None, nh, 1.0,
                                          k_scale, op).view(m, c),
        "y": lambda ctx: _gemm(ctx, wproj, bproj, out_dtype=_F32, res=xf, o_scale=s_attn,
                               rows_per_frame=h * w, op=op),
    }
    ffn_fused = _ffn_fwd_steps(*ffn)["ffn"]
    return {**steps, "ffn": ffn_fused, "out": lambda y: ffn_fused(y, y)}


def _run(steps: dict, t: dict | None = None, names=None, order=STEPS) -> dict:
    t = dict(t or {})
    for name, reads in order:
        if names is None or name in names:
            t[name] = steps[name](*(t[r] for r in reads))
    return t


def mit_block_torch(x, g1, be1, wq, bq, k, v, wproj, bproj, g2, be2, w1, b1, kdw, bdw,
                    w2, b2, num_heads: int = 1, eps: float = 1e-6) -> torch.Tensor:
    args = (x, g1, be1, wq, bq, k, v, wproj, bproj, g2, be2, w1, b1, kdw, bdw, w2, b2)
    return _run(_block_steps(*args, num_heads=num_heads, eps=eps, kernel=False))["out"] \
        .view(x.shape)


# Per-step checks of the kernel path (on the card): each kernel step is fed
# the plain path's own inputs to it and held to a fraction of the largest
# output of what it computes. bf16 outputs (q, ctx, out) come from f32 sums
# taken in another order than the plain version's, so one rounding may flip
# by one bf16 ulp (2^-7 of the largest value), or, after a product whose
# inputs were themselves rounded (q after LN1, ctx after P), carry through
# it: 2^-6. y is f32: proj is held as y − x, the attention branch alone, to
# 2^-10 (same bf16 inputs, f32 sums in another order). The FFN launch is held
# whole, alone ("ffn (out - y)", no residual: s·branch in training) and with
# the residual y: its bf16 roundings (the LN output, a, out) are the plain
# steps', from f32 sums in other orders, so a flipped ulp of the LN output or
# of a carries through fc1 or fc2 into the output's own rounding: 2^-6 of the
# largest value, the bound the separate fc2 launch it replaced was held to
# (an H100 read at most 2^-7.6 at random inputs of the B0 and B1 widths).
STEP_TOLERANCE = {"q": 2.0 ** -6, "ctx": 2.0 ** -6, "proj (y - x)": 2.0 ** -10,
                  "ffn (out - y)": 2.0 ** -6, "ffn + y (out)": 2.0 ** -6}


def _held(name: str, got: torch.Tensor, want: torch.Tensor, rel: float, op: str) -> tuple:
    """(name, max |got − want|, rel · max |want|): no absolute floor."""
    require(got.dtype == want.dtype and got.shape == want.shape, op,
            f"step {name}: {got.dtype} {tuple(got.shape)} vs {want.dtype} {tuple(want.shape)}")
    err = (got.float() - want.float()).abs().max().item() if got.numel() else 0.0
    if not torch.isfinite(got.float()).all():
        err = float("inf")
    scale = want.float().abs().max().item() if want.numel() else 0.0
    return (name, err, rel * max(scale, 1e-30))


def mit_block_step_errors(x, g1, be1, wq, bq, k, v, wproj, bproj, g2, be2, w1, b1, kdw, bdw,
                          w2, b2, num_heads: int = 1, eps: float = 1e-6, s_attn=None,
                          s_ffn=None, op: str = "mit_block_fused") -> list:
    """[(check, max |kernel - plain|, tolerance), ...] for each forward step of
    the kernel path, run on CUDA tensors against the plain steps (no count):
    q, ctx, proj and the FFN launch (with the branch scale s_ffn in
    training)."""
    args = (x, g1, be1, wq, bq, k, v, wproj, bproj, g2, be2, w1, b1, kdw, bdw, w2, b2)
    kw = dict(num_heads=num_heads, eps=eps, s_attn=s_attn, s_ffn=s_ffn, op=op)
    plain = _block_steps(*args, kernel=False, **kw)
    kern = _block_steps(*args, kernel=True, **kw)
    ref = _run(plain)
    xf = x.float().reshape(ref["y"].shape)
    pairs = {
        "q": (kern["q"](), ref["q"]),
        "ctx": (kern["ctx"](ref["q"]), ref["ctx"]),
        "proj (y - x)": (kern["y"](ref["ctx"]) - xf, ref["y"] - xf),
    }
    pairs["ffn (out - y)"] = (kern["ffn"](ref["y"], None), plain["out"](ref["a"], None))
    pairs["ffn + y (out)"] = (kern["ffn"](ref["y"], ref["y"]), ref["out"])
    return [_held(name, got, want, STEP_TOLERANCE[name], op)
            for name, (got, want) in pairs.items()]


@custom_op("mit_block_fused")
def _mit_block_fused_op(x: Tensor, g1: Tensor, be1: Tensor, wq: Tensor, bq: Tensor, k: Tensor,
                        v: Tensor, wproj: Tensor, bproj: Tensor, g2: Tensor, be2: Tensor,
                        w1: Tensor, b1: Tensor, kdw: Tensor, bdw: Tensor, w2: Tensor, b2: Tensor,
                        num_heads: int, eps: float, force: Optional[str]) -> Tensor:
    args = (x, g1, be1, wq, bq, k, v, wproj, bproj, g2, be2, w1, b1, kdw, bdw, w2, b2)
    if not use_kernel(force, x, "mit_block_fused"):
        return mit_block_torch(*args, num_heads=num_heads, eps=eps)
    out = _run(_block_steps(*args, num_heads=num_heads, eps=eps, kernel=True),
               order=FUSED_STEPS)["out"]
    mit_block_fused.launches += 1
    return out.view(x.shape)


def mit_block_fused(x, g1, be1, wq, bq, k, v, wproj, bproj, g2, be2, w1, b1, kdw, bdw,
                    w2, b2, num_heads: int = 1, eps: float = 1e-6,
                    force: str | None = None) -> torch.Tensor:
    """force: None (kernel on CUDA, plain on CPU) | 'torch' | 'kernel'; the
    custom op ``vss_cffm::mit_block_fused``, which ``torch.export`` keeps
    as one node.

    Inference only: it raises rather than cut a gradient when autograd
    records and an input requires grad; training takes ``mit_block_train``."""
    args = (x, g1, be1, wq, bq, k, v, wproj, bproj, g2, be2, w1, b1, kdw, bdw, w2, b2)
    refuse_grad("mit_block_fused", args, "mit_block_train (MiTBlock in train() mode)")
    return _mit_block_fused_op(*args, num_heads, eps, force)


mit_block_fused.launches = 0


# ---- the backward's launches, each with its plain version --------------------
#
# Every function below takes ``kernel``: False runs the plain PyTorch version
# (any device, any float dtype dt), True the hand-written launch (CUDA, bf16
# activations). Reductions over rows come back as their final sums.

# blocks per SM that the row-split reductions aim for
_BLOCKS_PER_SM = 4


def lin_bwd(a: torch.Tensor, w_t: torch.Tensor, dt: torch.dtype, *, kernel: bool,
            a_scale: torch.Tensor | None = None, rows_per_frame: int = 1,
            out_dtype: torch.dtype = _F32, op: str) -> torch.Tensor:
    """a (M, K) · w_t (K, N) with a (times its per-frame scale) and w_t
    rounded to dt, f32 accumulation, out in f32 or rounded to dt."""
    if kernel:
        return _gemm(a, w_t, None, out_dtype=out_dtype, a_scale=a_scale,
                     rows_per_frame=rows_per_frame, op=op, bwd=True)
    ar = a.float() if a_scale is None else a.float() * _frame_rows(a_scale, rows_per_frame)
    out = _mm(ar.to(dt), w_t, dt)
    return out if out_dtype == _F32 else out.to(dt)


def gemm_tn(a: torch.Tensor, b: torch.Tensor, *, kernel: bool, b_scale: torch.Tensor | None = None,
            rows_per_frame: int = 1, dt: torch.dtype, op: str) -> torch.Tensor:
    """Σ over rows of aᵀ·b: a (M, K1), b (M, N), b times its per-frame scale
    rounded to dt → (K1, N) f32."""
    m, k1 = a.shape
    n = b.shape[1]
    if not kernel:
        bf = b.float()
        if b_scale is not None:
            bf = bf * _frame_rows(b_scale, rows_per_frame)
        return a.to(dt).float().t() @ bf.to(dt).float()
    require(a.dtype == _BF16 and b.dtype == _BF16 and b.shape[0] == m, op,
            lambda: f"gemm_tn a {a.dtype} {tuple(a.shape)}, b {b.dtype} {tuple(b.shape)}")
    require(k1 % 8 == 0 and n % 8 == 0, op, lambda: f"gemm_tn K1={k1}, N={n} not multiples of 8")
    sb = None if b_scale is None else _scales(b_scale, -(-m // rows_per_frame), a.device, op)
    tiles = -(-k1 // 64) * -(-n // 64)
    splits = max(1, min(-(-_BLOCKS_PER_SM * sm_count(a) // tiles), -(-m // 256)))
    rps = -(-m // splits)
    splits = -(-m // rps)
    partial = torch.empty((splits, k1, n), device=a.device, dtype=_F32)
    dev, stream = stream_of(a)
    rc = _build.library("gemm_tn").gemm_tn(
        ptr(a, op), ptr(b, op), ptr(sb, op), ptr(partial, op), m, k1, n, rps, rows_per_frame,
        dev, stream)
    _build.check(rc, op)
    return partial.sum(dim=0)


def _row_chunks(t: torch.Tensor, rows: int, cols_blocks: int = 1) -> tuple[int, int]:
    """(rows per block, blocks) for a row-split reduction over ``rows``."""
    want = max(1, -(-_BLOCKS_PER_SM * sm_count(t) // cols_blocks))
    per = max(8, -(-rows // want))
    return per, -(-rows // per)


# owned columns of a dz_dhid block (csrc/block_bwd.cu kTileW), and the
# blocks of 320 threads per SM its strips aim for: two are resident (96
# registers a thread), and the longest strips that fill them recompute the
# fewest halo rows (at the B1 stage shapes: one strip of all rows)
DZ_TILE_W = 8
_DZ_BLOCKS_PER_SM = 2


def dz_dhid_plan(b: int, h: int, w: int, ch: int, sms: int) -> tuple[int, int, int]:
    """(rows, strips, column tiles) of ``dz_dhid``'s blocks: a block owns
    ``rows`` rows (the last strip shorter when rows does not divide h) x
    DZ_TILE_W columns x 64 channels of one frame; strips are as long as the
    blocks of all strips still fill ``_DZ_BLOCKS_PER_SM`` blocks on each of
    ``sms`` SMs."""
    ctiles = -(-w // DZ_TILE_W)
    per_strip = b * ctiles * -(-ch // 64)
    strips = min(h, max(1, -(-_DZ_BLOCKS_PER_SM * sms // per_strip)))
    rows = -(-h // strips)
    return rows, -(-h // rows), ctiles


def dz_dhid_tiles(b: int, h: int, w: int, rows: int) -> list:
    """The (frame, owned rows [i0, i1), owned columns [j0, j1)) of each block
    of ``dz_dhid`` in its partial's order, as the kernel derives them from its
    block index (the channel slabs aside)."""
    strips, ctiles = -(-h // rows), -(-w // DZ_TILE_W)
    out = []
    for blk in range(b * strips * ctiles):
        ct, t = blk % ctiles, blk // ctiles
        strip, f = t % strips, t // strips
        out.append((f, strip * rows, min(h, strip * rows + rows), ct * DZ_TILE_W,
                    min(w, ct * DZ_TILE_W + DZ_TILE_W)))
    return out


def dz_dhid(d_a: torch.Tensor, hid: torch.Tensor, kdw: torch.Tensor, bdw: torch.Tensor,
            dt: torch.dtype, *, kernel: bool, op: str) -> dict:
    """The depthwise conv + GELU backward in one pass (hid, d_a f32 (B, H, W,
    Ch)): z = dw3×3(hid) + bdw in f32, d_z = d_a·GELU′(z) (f32, not kept),
    d_hid = the transposed 3×3 depthwise conv of d_z, zero outside the image
    → {d_hid rounded to dt, db1 = Σ d_hid, dkdw (3, 3, 1, Ch) = Σ hid(shifted)
    ·d_z per tap, dbdw = Σ d_z}, the sums in f32."""
    b, h, w, ch = hid.shape
    if not kernel:
        z = _preact(hid, kdw, bdw)
        d_z = d_a.float() * _gelu_grad(z)
        hp = F.pad(hid.float(), (0, 0, 1, 1, 1, 1))
        taps = [(hp[:, di:di + h, dj:dj + w, :] * d_z).sum(dim=(0, 1, 2))
                for di in range(3) for dj in range(3)]
        k = kdw.reshape(3, 3, ch).float()
        gp = F.pad(d_z, (0, 0, 1, 1, 1, 1))
        d_hid = None
        for dj in range(3):
            for di in range(3):
                term = gp[:, 2 - di:2 - di + h, 2 - dj:2 - dj + w, :] * k[di, dj]
                d_hid = term if d_hid is None else d_hid + term
        return {"d_hid": d_hid.to(dt), "db1": d_hid.sum(dim=(0, 1, 2)),
                "dkdw": torch.stack(taps).reshape(3, 3, 1, ch), "dbdw": d_z.sum(dim=(0, 1, 2))}
    require(hid.dtype == _F32 and d_a.dtype == _F32 and ch % 8 == 0, op,
            lambda: f"d_a {d_a.dtype} / hid {hid.dtype}, Ch={ch}")
    wk = kdw.reshape(9, ch).to(device=hid.device, dtype=_F32).contiguous()
    bb = bdw.to(device=hid.device, dtype=_F32).contiguous()
    rows, strips, ctiles = dz_dhid_plan(b, h, w, ch, sm_count(hid))
    d_hid = torch.empty(hid.shape, device=hid.device, dtype=_BF16)
    partial = torch.empty((b * strips * ctiles, 11, ch), device=hid.device, dtype=_F32)
    dev, stream = stream_of(hid)
    rc = _build.library("block_bwd").dz_dhid(
        ptr(d_a, op), ptr(hid, op), ptr(wk, op), ptr(bb, op), ptr(d_hid, op), ptr(partial, op),
        b, h, w, ch, rows, dev, stream)
    _build.check(rc, op)
    sums = partial.sum(dim=0)
    return {"d_hid": d_hid, "db1": sums[10], "dkdw": sums[:9].reshape(3, 3, 1, ch),
            "dbdw": sums[9]}


def ln_bwd(dl: torch.Tensor, xin: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
           eps: float, res: torch.Tensor, dx_dtype: torch.dtype, dt: torch.dtype, *,
           kernel: bool, s_out: torch.Tensor | None = None,
           s_res: torch.Tensor | None = None, rows_per_frame: int = 1, op: str) -> dict:
    """Backward of a LayerNorm (f32 statistics of xin over C) plus a residual,
    per row of (M, C):

      dx    = res + rsig·(dly − mean(dly) − x̂·mean(dly·x̂)),  dly = dl·γ  (dx_dtype)
      ln    = bf16-or-dt(x̂·γ + β)          (the LN output the forward rounded)
      dx_s  = dx·s_out rounded to dt        (with s_out: the attention branch's d_attn_b)
      dg    = Σ dl·x̂,  dbe = Σ dl,  sdx = Σ dx·s_out,  sres = Σ res·s_res (f32)
    """
    m, c = dl.shape
    if not kernel:
        xf = xin.float()
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        rsig = torch.rsqrt(var + eps)
        xhat = (xf - mu) * rsig
        dly = dl * gamma.float()
        dxl = rsig * (dly - dly.mean(dim=-1, keepdim=True)
                      - xhat * (dly * xhat).mean(dim=-1, keepdim=True))
        dx = res.float() + dxl
        out = {"dx": dx.to(dx_dtype), "ln": (xhat * gamma.float() + beta.float()).to(dt),
               "dg": (dl * xhat).sum(dim=0), "dbe": dl.sum(dim=0)}
        if s_out is not None:
            dxs = dx * _frame_rows(s_out, rows_per_frame)
            out.update(dx_s=dxs.to(dt), sdx=dxs.sum(dim=0))
        if s_res is not None:
            out["sres"] = (res.float() * _frame_rows(s_res, rows_per_frame)).sum(dim=0)
        return out
    require(dl.dtype == _F32 and c % 8 == 0 and c <= 512, op,
            f"LayerNorm backward over {c} channels of {dl.dtype} (f32, C % 8 == 0, C <= 512)")
    require(xin.dtype in (_BF16, _F32) and res.dtype in (_BF16, _F32), op,
            f"LayerNorm backward input {xin.dtype} / residual {res.dtype}")
    dev = dl.device
    nb = -(-m // rows_per_frame)
    so, sr = _scales(s_out, nb, dev, op), _scales(s_res, nb, dev, op)
    g = gamma.to(device=dev, dtype=_F32).contiguous()
    bt = beta.to(device=dev, dtype=_F32).contiguous()
    per, nblocks = _row_chunks(dl, m)
    dx = torch.empty((m, c), device=dev, dtype=dx_dtype)
    ln = torch.empty((m, c), device=dev, dtype=_BF16)
    dxs = torch.empty((m, c), device=dev, dtype=_BF16) if s_out is not None else None
    partial = torch.empty((nblocks, 4, c), device=dev, dtype=_F32)
    devi, stream = stream_of(dl)
    rc = _build.library("block_bwd").ln_bwd(
        ptr(dl, op), ptr(xin, op), ptr(g, op), ptr(bt, op), ptr(res, op), ptr(so, op),
        ptr(sr, op), ptr(dx, op), ptr(ln, op), ptr(dxs, op), ptr(partial, op), m, c,
        int(xin.dtype == _F32), int(res.dtype == _F32), int(dx_dtype == _F32), rows_per_frame,
        per, eps, devi, stream)
    _build.check(rc, op)
    sums = partial.sum(dim=0)
    out = {"dx": dx, "ln": ln, "dg": sums[0], "dbe": sums[1]}
    if s_out is not None:
        out.update(dx_s=dxs, sdx=sums[2])
    if s_res is not None:
        out["sres"] = sums[3]
    return out


def round16(n: int) -> int:
    return -(-n // 16) * 16


def sra_attention_bwd_smem(s: int, dh: int) -> int:
    """Shared memory of one block of ``csrc/sra_attention_bwd.cu`` (its
    ``Smem``, which the kernel's launch asks for): K and V (Sp, dh) bf16, a
    ring of 2 stages of q and d_ctx (64, dh) bf16, each warp group's p and
    d_s tiles (64, 32) bf16 (also the exchange of d_q, (64, dh) f32), the dK
    and dV accumulators (S, dh) f32, the groups' row statistics and r (2, 64,
    3) f32 and four (dh,) f32 column sums of d_q."""
    return (2 * round16(s) * dh * 2 + 2 * 2 * 64 * dh * 2 + max(2 * 2 * 64 * 32 * 2, 64 * dh * 4)
            + 2 * s * dh * 4 + 2 * 64 * 3 * 4 + 4 * dh * 4)


def sra_bwd_splits(b: int, nh: int, ntq: int, slots: int) -> tuple[int, int]:
    """(tiles per split, splits) of the attention backward: each of the b·nh
    (frame, head) pairs cuts its ntq 64-query tiles into ``splits``
    consecutive runs of ``tiles per split`` (the last one shorter), one block
    each. Of the splits the fewest that give the least time in waves of
    ``slots`` blocks (SMs times blocks per SM), a block costing its tiles plus
    one for its K/V load and its partial."""
    best = None
    for sp in range(1, ntq + 1):
        tps = -(-ntq // sp)
        sp = -(-ntq // tps)
        cost = -(-b * nh * sp // slots) * (tps + 1)
        if best is None or cost < best[0]:
            best = (cost, tps, sp)
    return best[1], best[2]


_bwd_slots: dict = {}


def _sra_bwd_slots(s: int, dh: int, dev: int) -> int:
    """SMs × blocks of the kernel per SM at s keys and head dim dh (a CUDA
    occupancy query, cached)."""
    key = (s, dh, dev)
    if key not in _bwd_slots:
        n = _build.library("sra_attention_bwd").sra_attention_bwd_blocks_per_sm(s, dh, dev)
        require(n > 0, "mit_block_train_bwd",
                lambda: f"no block of the attention backward fits an SM at {s} keys, "
                        f"head dim {dh} (CUDA error {-n})")
        _bwd_slots[key] = n * torch.cuda.get_device_properties(dev).multi_processor_count
    return _bwd_slots[key]


def sra_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, d_ctx: torch.Tensor,
                      shape, nh: int, dt: torch.dtype, *, kernel: bool, op: str) -> dict:
    """The attention backward of the block per (frame, head): q and d_ctx
    (M, C) in dt, k / v (B, S, C). p = softmax(q·(s·K)ᵀ) recomputed in f32,
    d_p = d_ctx·Vᵀ, d_s = bf16(p∘(d_p − Σ d_p∘p)), d_q = d_s·(s·K) →
    {d_q in dt (M, C); dbq (C,) = Σ d_q; dk (B, S, C) = scale·Σ d_sᵀ·q, the
    gradient of the scaled K times the scale; dv (B, S, C) = Σ bf16(p)ᵀ·d_ctx;
    all sums in f32}."""
    b, h, w, c = shape
    hw, s = h * w, k.shape[1]
    dh = c // nh
    ksc = scale_in(dt, dh ** -0.5)

    def heads(t, n):
        return t.reshape(b, n, nh, dh).transpose(1, 2)        # (b, nh, n, dh)

    def merged(g):
        return g.transpose(1, 2).reshape(b, -1, c)             # (b, n, c)

    if not kernel:
        qh = heads(q.to(dt), hw).float()
        kh = heads((k.to(dt) * ksc).to(dt), s).float()
        vh = heads(v.to(dt), s).float()
        gh = heads(d_ctx.to(dt), hw).float()
        p = torch.softmax(qh @ kh.transpose(-1, -2), dim=-1)          # (b, nh, hw, S)
        dp = gh @ vh.transpose(-1, -2)
        ds_b = (p * (dp - (dp * p).sum(dim=-1, keepdim=True))).to(dt).float()
        dq = ds_b @ kh                                                  # (b, nh, hw, dh)
        return {"d_q": merged(dq).reshape(b * hw, c).to(dt), "dbq": dq.sum(dim=(0, 2)).reshape(c),
                "dk": merged(ds_b.transpose(-1, -2) @ qh) * (dh ** -0.5),
                "dv": merged(p.to(dt).float().transpose(-1, -2) @ gh)}
    require(dh in (32, 64), op, lambda: f"head dim {dh} (32 or 64)")
    lib = _build.library("sra_attention_bwd")
    require(0 < lib.sra_attention_bwd_smem_bytes(s, dh) <= SMEM_LIMIT, op,
            lambda: f"{s} keys at head dim {dh} exceed {SMEM_LIMIT} bytes of shared memory")
    for name, t in (("q", q), ("d_ctx", d_ctx)):
        require(t.dtype == _BF16 and tuple(t.shape) == (b * hw, c), op,
                lambda: f"{name} {t.dtype} {tuple(t.shape)}")
    require(tuple(k.shape) == (b, s, c) and k.shape == v.shape, op,
            lambda: f"k {tuple(k.shape)} / v {tuple(v.shape)}")
    kb, vb = k.to(_BF16).contiguous(), v.to(_BF16).contiguous()
    ntq = -(-hw // 64)
    dev, stream = stream_of(q)
    tps, splits = sra_bwd_splits(b, nh, ntq, _sra_bwd_slots(s, dh, dev))
    d_q = torch.empty_like(q)
    dbq = torch.empty((b, ntq, nh, dh), device=q.device, dtype=_F32)
    dkv = torch.empty((splits, b, nh, 2, s, dh), device=q.device, dtype=_F32)
    rc = lib.sra_attention_bwd(
        ptr(q, op), ptr(kb, op), ptr(vb, op), ptr(d_ctx, op), ptr(d_q, op), ptr(dbq, op),
        ptr(dkv, op), b, hw, s, nh, dh, c, ksc, tps, dev, stream)
    _build.check(rc, op)
    g = dkv.sum(dim=0)                                                   # (b, nh, 2, S, dh)
    return {"d_q": d_q, "dbq": dbq.sum(dim=(0, 1)).reshape(c),
            "dk": merged(g[:, :, 0]) * (dh ** -0.5), "dv": merged(g[:, :, 1])}


# ---- the backward as a table of steps ------------------------------------------
#
# Each step reads tensors of the table ``t`` (the inputs, the forward's kept
# activations and earlier steps' outputs) and returns new ones. The FFN half
# (``ffn_bwd_steps``) is shared with ``ops/mixffn.py``.

def ffn_bwd_steps(p: dict, kernel: bool, full: bool, op: str) -> list:
    """[(name, fn(t) -> dict)] of the FFN half's backward from its input y
    and go. p: the block's parameters and geometry; ``full`` continues into
    the attention half (d_y in f32, d_attn_b), else dx is the half's input
    gradient in x's dtype. The kernel route is one launch (``ffn_bwd``:
    ``ops/ffn_bwd.py``, hid, z, d_a, d_z and d_ln on chip), then the dW2 and
    dW1 row reductions; the plain route recomputes hid and a from y and runs
    the half's steps one by one, with the same rounding points."""
    b, h, w, c = p["shape"]
    dt, hw = p["dt"], h * w
    ch = p["w1"].shape[1]
    m = b * hw

    def dw2(t):
        return {"dw2": gemm_tn(t["a"], t["go"], kernel=kernel, b_scale=p["s_ffn"],
                               rows_per_frame=hw, dt=dt, op=op)}

    def dw1(t):
        return {"dw1": gemm_tn(t["ln2"], t["d_hid"], kernel=kernel, dt=dt, op=op)}

    if kernel:
        def ffn_bwd(t):
            return ffn_bwd_launch(t["y"].view(b, h, w, c), t["go"], p["g2"], p["be2"], p["w1"],
                                  p["b1"], p["kdw"], p["bdw"], p["w2"], p["s_ffn"], p["eps"], op,
                                  s_attn=p["s_attn"], full=full)

        return [("ffn_bwd", ffn_bwd), ("dW2", dw2), ("dW1", dw1)]

    fwd = _ffn_fwd_steps(p["g2"], p["be2"], p["w1"], p["b1"], p["kdw"], p["bdw"], p["w2"], None,
                         None, p["eps"], p["shape"], dt, False, op)

    def acts(t):
        hid = fwd["hid"](t["y"])
        return {"hid": hid, "a": fwd["a"](hid)}

    def d_a(t):
        return {"d_a": lin_bwd(t["go"], p["w2"].t(), dt, kernel=False, a_scale=p["s_ffn"],
                               rows_per_frame=hw, op=op)}

    def d_hid(t):
        o = dz_dhid(t["d_a"].view(b, h, w, ch), t["hid"].view(b, h, w, ch), p["kdw"], p["bdw"],
                    dt, kernel=False, op=op)
        return dict(o, d_hid=o["d_hid"].reshape(m, ch))

    def d_ln2(t):
        return {"d_ln2": lin_bwd(t["d_hid"], p["w1"].t(), dt, kernel=False, op=op)}

    def ln2_bwd(t):
        o = ln_bwd(t["d_ln2"], t["y"], p["g2"], p["be2"], p["eps"], t["go"],
                   _F32 if full else dt, dt, kernel=False,
                   s_out=p["s_attn"] if full else None, s_res=p["s_ffn"],
                   rows_per_frame=hw, op=op)
        out = {"ln2": o["ln"], "dg2": o["dg"], "dbe2": o["dbe"], "db2": o["sres"]}
        if full:
            out.update(d_y=o["dx"], d_attn=o["dx_s"], dbproj=o["sdx"])
        else:
            out["dx"] = o["dx"]
        return out

    return [("acts", acts), ("d_a", d_a), ("d_hid", d_hid), ("d_ln2", d_ln2),
            ("ln2_bwd", ln2_bwd), ("dW2", dw2), ("dW1", dw1)]


def ffn_bwd_unfused_steps(p: dict, full: bool, op: str) -> list:
    """The FFN half's backward as the six launches the fused one replaced
    (d_a and d_ln2 on ``block_gemm``, ``dz_dhid``, ``ln_bwd``, dW2 and dW1 on
    ``gemm_tn``), from the forward's hid and a in the table, with the outputs
    of ``ffn_bwd_steps``: no route runs it; it is the yardstick the fused
    launch is timed against (``chip_smoke.py``'s ``[ffn_train]``)."""
    b, h, w, c = p["shape"]
    dt, hw = p["dt"], h * w
    ch = p["w1"].shape[1]
    m = b * hw

    def d_a(t):
        return {"d_a": lin_bwd(t["go"], p["w2"].t(), dt, kernel=True, a_scale=p["s_ffn"],
                               rows_per_frame=hw, op=op)}

    def d_hid(t):
        o = dz_dhid(t["d_a"].view(b, h, w, ch), t["hid"].view(b, h, w, ch), p["kdw"], p["bdw"],
                    dt, kernel=True, op=op)
        return dict(o, d_hid=o["d_hid"].reshape(m, ch))

    def d_ln2(t):
        return {"d_ln2": lin_bwd(t["d_hid"], p["w1"].t(), dt, kernel=True, op=op)}

    def ln2_bwd(t):
        o = ln_bwd(t["d_ln2"], t["y"], p["g2"], p["be2"], p["eps"], t["go"],
                   _F32 if full else dt, dt, kernel=True, s_out=p["s_attn"] if full else None,
                   s_res=p["s_ffn"], rows_per_frame=hw, op=op)
        out = {"ln2": o["ln"], "dg2": o["dg"], "dbe2": o["dbe"], "db2": o["sres"]}
        if full:
            out.update(d_y=o["dx"], d_attn=o["dx_s"], dbproj=o["sdx"])
        else:
            out["dx"] = o["dx"]
        return out

    def dws(t):
        return {"dw2": gemm_tn(t["a"], t["go"], kernel=True, b_scale=p["s_ffn"],
                               rows_per_frame=hw, dt=dt, op=op),
                "dw1": gemm_tn(t["ln2"], t["d_hid"], kernel=True, dt=dt, op=op)}

    return [("d_a", d_a), ("d_hid", d_hid), ("d_ln2", d_ln2), ("ln2_bwd", ln2_bwd),
            ("dW", dws)]


def _attn_bwd_steps(p: dict, kernel: bool, op: str) -> list:
    dt, nh = p["dt"], p["num_heads"]

    def d_ctx(t):
        return {"d_ctx": lin_bwd(t["d_attn"], p["wproj"].t(), dt, kernel=kernel, out_dtype=dt,
                                 op=op)}

    def attn_bwd(t):
        return sra_attention_bwd(t["q"], p["k"], p["v"], t["d_ctx"], p["shape"], nh, dt,
                                 kernel=kernel, op=op)

    def d_ln1(t):
        return {"d_ln1": lin_bwd(t["d_q"], p["wq"].t(), dt, kernel=kernel, op=op)}

    def ln1_bwd(t):
        o = ln_bwd(t["d_ln1"], t["x"], p["g1"], p["be1"], p["eps"], t["d_y"], dt, dt,
                   kernel=kernel, op=op)
        return {"dx": o["dx"], "ln1": o["ln"], "dg1": o["dg"], "dbe1": o["dbe"]}

    def dwproj(t):
        return {"dwproj": gemm_tn(t["ctx"], t["d_attn"], kernel=kernel, dt=dt, op=op)}

    def dwq(t):
        return {"dwq": gemm_tn(t["ln1"], t["d_q"], kernel=kernel, dt=dt, op=op)}

    return [("d_ctx", d_ctx), ("attn_bwd", attn_bwd), ("d_ln1", d_ln1), ("ln1_bwd", ln1_bwd),
            ("dWproj", dwproj), ("dWq", dwq)]


def _train_bwd_steps(p: dict, kernel: bool, op: str) -> list:
    return ffn_bwd_steps(p, kernel, True, op) + _attn_bwd_steps(p, kernel, op)


# the backward's outputs in the JAX order, as the table names them
GRADS = ("dx", "dg1", "dbe1", "dwq", "dbq", "dk", "dv", "dwproj", "dbproj", "dg2", "dbe2",
         "dw1", "db1", "dkdw", "dbdw", "dw2", "db2")
_INPUTS = ("x", "g1", "be1", "wq", "bq", "k", "v", "wproj", "bproj", "g2", "be2", "w1", "b1",
           "kdw", "bdw", "w2")
_ACTS = ("q", "ctx", "y")


def bwd_table(x: torch.Tensor, go: torch.Tensor, acts: dict, names=_ACTS) -> dict:
    """The backward's starting table: x and go as (M, C) rows, and the
    forward's activations ``names``."""
    c = x.shape[-1]
    t = {"x": x.reshape(-1, c), "go": go.reshape(-1, c)}
    t.update({n: acts[n] for n in names})
    return t


def run_steps(steps: list, t: dict) -> dict:
    t = dict(t)
    for _, fn in steps:
        t.update(fn(t))
    return t


def _train_bwd(args: tuple, s_attn, s_ffn, go, num_heads: int, eps: float, kernel: bool,
               acts: dict | None, op: str) -> tuple:
    x = args[0]
    if acts is None:  # recompute the forward's activations, as the TPU kernel does
        acts = _run(_block_steps(*args, None, num_heads=num_heads, eps=eps, kernel=kernel,
                                 s_attn=s_attn, s_ffn=s_ffn, op=op), names=_ACTS)
    p = dict(zip(_INPUTS, args), shape=tuple(x.shape), dt=x.dtype, num_heads=num_heads,
             eps=eps, s_attn=s_attn, s_ffn=s_ffn)
    t = run_steps(_train_bwd_steps(p, kernel, op), bwd_table(x, go, acts))
    t["dx"] = t["dx"].reshape(x.shape)
    return tuple(t[n] for n in GRADS)


def mit_block_train_torch(x, g1, be1, wq, bq, k, v, wproj, bproj, g2, be2, w1, b1, kdw, bdw,
                          w2, b2, s_attn, s_ffn, num_heads: int = 1,
                          eps: float = 1e-6) -> torch.Tensor:
    """The plain forward of the train pair, ``mit_block_train_xla``'s math."""
    args = (x, g1, be1, wq, bq, k, v, wproj, bproj, g2, be2, w1, b1, kdw, bdw, w2, b2)
    t = _run(_block_steps(*args, num_heads=num_heads, eps=eps, kernel=False, s_attn=s_attn,
                          s_ffn=s_ffn))
    return t["out"].reshape(x.shape)


def mit_block_train_bwd_torch(x, g1, be1, wq, bq, k, v, wproj, bproj, g2, be2, w1, b1, kdw,
                              bdw, w2, s_attn, s_ffn, go, num_heads: int = 1,
                              eps: float = 1e-6) -> tuple:
    """The plain backward, written out with ``_train_bwd_kernel``'s rounding
    points (not autograd of the forward): the forward recomputed from x, then
    the backward's steps. Returns ``GRADS``: dx in x's dtype, the rest f32."""
    args = (x, g1, be1, wq, bq, k, v, wproj, bproj, g2, be2, w1, b1, kdw, bdw, w2)
    return _train_bwd(args, s_attn, s_ffn, go, num_heads, eps, False, None,
                      "mit_block_train_bwd")


def mit_block_train_bwd(x, g1, be1, wq, bq, k, v, wproj, bproj, g2, be2, w1, b1, kdw, bdw, w2,
                        s_attn, s_ffn, go, num_heads: int = 1, eps: float = 1e-6,
                        force: str | None = None, acts: dict | None = None) -> tuple:
    """``GRADS`` of the block for the output cotangent go: dx in x's dtype, the
    rest f32. force: None (kernels on CUDA, plain on CPU) | 'torch' |
    'kernel'. ``acts``: the forward's kept activations (q, ctx, y as (M, ·)
    rows), recomputed from x when None."""
    op = "mit_block_train_bwd"
    kernel = use_kernel(force, x, op)
    if kernel:
        require(go.dtype == _BF16 and go.shape == x.shape, op,
                f"go {go.dtype} {tuple(go.shape)} against x {tuple(x.shape)}")
        go = go.contiguous()
    args = (x, g1, be1, wq, bq, k, v, wproj, bproj, g2, be2, w1, b1, kdw, bdw, w2)
    out = _train_bwd(args, s_attn, s_ffn, go, num_heads, eps, kernel, acts, op)
    if kernel:
        mit_block_train_bwd.launches += 1
    return out


class _MitBlockTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g1, be1, wq, bq, k, v, wproj, bproj, g2, be2, w1, b1, kdw, bdw, w2, b2,
                s_attn, s_ffn, num_heads, eps, force, kernel):
        ins = (x, g1, be1, wq, bq, k, v, wproj, bproj, g2, be2, w1, b1, kdw, bdw, w2, b2)
        t = _run(_block_steps(*ins, num_heads=num_heads, eps=eps, kernel=kernel,
                              s_attn=s_attn, s_ffn=s_ffn, op="mit_block_train"),
                 order=FUSED_STEPS if kernel else STEPS)
        if kernel:
            mit_block_train.launches += 1
        # q, ctx and y only: the backward recomputes the FFN half's hid and a
        ctx.save_for_backward(*ins[:-1], s_attn, s_ffn, *(t[n] for n in _ACTS))
        ctx.args = (num_heads, eps, force, [a.dtype for a in ins])
        return t["out"].reshape(x.shape)

    @staticmethod
    def backward(ctx, go):
        saved = ctx.saved_tensors
        num_heads, eps, force, dtypes = ctx.args
        args, (s_attn, s_ffn), acts = saved[:16], saved[16:18], saved[18:]
        grads = mit_block_train_bwd(*args, s_attn, s_ffn, go, num_heads, eps, force=force,
                                    acts=dict(zip(_ACTS, acts)))
        return (*(g.to(d) for g, d in zip(grads, dtypes)), None, None, None, None, None, None)


def mit_block_train(x, g1, be1, wq, bq, k, v, wproj, bproj, g2, be2, w1, b1, kdw, bdw, w2, b2,
                    s_attn, s_ffn, num_heads: int = 1, eps: float = 1e-6,
                    force: str | None = None) -> torch.Tensor:
    """Differentiable whole MiT block, ``y = x + s_attn·attn(LN1 x); out = y +
    s_ffn·FFN(LN2 y)``, with the JAX signature (``force`` in place of
    ``interpret``). k / v are the spatial-reduced keys and values, computed
    outside so that their producer chain backpropagates through autograd; the
    backward returns their cotangents. s_attn / s_ffn (B,) are per-frame
    branch scales and get no gradient. Every gradient is cast to its own
    input's dtype. force: None (kernels on CUDA, plain on CPU) | 'torch' |
    'kernel'; the backward follows it (``mit_block_train_bwd``)."""
    kernel = use_kernel(force, x, "mit_block_train")
    return _MitBlockTrain.apply(x, g1, be1, wq, bq, k, v, wproj, bproj, g2, be2, w1, b1, kdw,
                                bdw, w2, b2, s_attn, s_ffn, num_heads, eps, force, kernel)


mit_block_train.launches = 0
mit_block_train_bwd.launches = 0


def mit_block_train_fits(h: int, w: int, c: int, ch: int, nh: int, n_kv: int) -> bool:
    """Whether the train pair's launches take an (h, w, c) block with hidden
    width ch, nh heads and n_kv keys, forward and backward: head dim 32 or
    64, widths multiples of 8, C <= 512 (the LayerNorm backward's rows), the
    attention backward within one block's shared memory (it holds the
    forward's K and V and more, so the forward then fits too). The MiT block
    runs composed otherwise, on every device alike."""
    if nh < 1 or c % nh or n_kv < 1 or h < 1 or w < 1:
        return False
    dh = c // nh
    return (dh in (32, 64) and c % 8 == 0 and ch % 8 == 0 and c <= 512
            and sra_attention_bwd_smem(n_kv, dh) <= SMEM_LIMIT)


# Per-step checks of the backward on the card, as STEP_TOLERANCE for the
# forward: each launch fed the plain path's inputs, each output held to a
# fraction of its own largest value. f32 outputs computed from the same
# inputs in another order (the input-gradient products, the depthwise and
# LayerNorm passes, every sum over rows): 2^-10. bf16 outputs rounded once
# from such sums (d_hid, d_attn, d_ctx, ln1, ln2, dx): one ulp, 2^-7. The
# attention backward rounds p and d_s inside: dV sums bf16(p), any of which
# may flip one ulp (2^-7); d_s = p∘(d_p − r) rounds after a difference that
# may cancel, and d_q, Σ d_q and dK follow a product with it: 2^-6. (The FFN
# half's six launches, ``ffn_bwd_unfused_steps``, are held by the card tests
# of ``dz_dhid`` and the GEMMs at these.)
BWD_STEP_TOLERANCE = {
    "d_a": 2.0 ** -10, "dkdw": 2.0 ** -10, "dbdw": 2.0 ** -10,
    "d_hid": 2.0 ** -7, "db1": 2.0 ** -10, "d_ln2": 2.0 ** -10, "ln2": 2.0 ** -7,
    "dg2": 2.0 ** -10, "dbe2": 2.0 ** -10, "db2": 2.0 ** -10, "d_y": 2.0 ** -10,
    "d_attn": 2.0 ** -7, "dbproj": 2.0 ** -10, "dx": 2.0 ** -7, "dw2": 2.0 ** -10,
    "dw1": 2.0 ** -10, "d_ctx": 2.0 ** -7, "d_q": 2.0 ** -6, "dbq": 2.0 ** -6,
    "dk": 2.0 ** -6, "dv": 2.0 ** -7, "d_ln1": 2.0 ** -10, "ln1": 2.0 ** -7,
    "dg1": 2.0 ** -10, "dbe1": 2.0 ** -10, "dwproj": 2.0 ** -10, "dwq": 2.0 ** -10,
}

# The FFN half's backward launch (``ffn_bwd``) against the plain steps, fed
# the same y, go and parameters. It recomputes LN2's bf16 output and the
# hidden map on chip from f32 sums in another order, so a flipped ulp of the
# LN output (or of a, go_s, d_hid_b) carries through fc1, GELU′ or d_ln into
# everything after it: 2^-6 of each output's largest value, as the forward's
# FFN launch is held. ln2 is LN2's own rounding (one ulp, 2^-7); db2 = Σ go·s
# reads only inputs (2^-10).
FFN_BWD_TOLERANCE = {
    "a": 2.0 ** -6, "d_hid": 2.0 ** -6, "ln2": 2.0 ** -7, "dx": 2.0 ** -6, "d_y": 2.0 ** -6,
    "d_attn": 2.0 ** -6, "dkdw": 2.0 ** -6, "dbdw": 2.0 ** -6, "db1": 2.0 ** -6,
    "dg2": 2.0 ** -6, "dbe2": 2.0 ** -6, "db2": 2.0 ** -10, "dbproj": 2.0 ** -6,
}


def bwd_step_errors(steps_of, p: dict, t: dict, op: str) -> list:
    """[(check, max |kernel − plain|, tolerance)] of each backward launch, fed
    the plain steps' outputs, against its plain step (on CUDA tensors)."""
    ref = dict(t)
    out = []
    for (name, plain), (_, kern) in zip(steps_of(p, False, op), steps_of(p, True, op)):
        want = plain(ref)
        got = kern(ref)
        out += [_held(f"{name}: {key}", got[key], w, BWD_STEP_TOLERANCE[key], op)
                for key, w in want.items()]
        ref.update(want)
    return out


def ffn_bwd_step_errors(p: dict, t: dict, full: bool, op: str) -> tuple[list, dict]:
    """([(check, max |kernel − plain|, tolerance)], the plain table) of the
    FFN half's backward: each output of the ``ffn_bwd`` launch from the
    table's y and go at ``FFN_BWD_TOLERANCE``, then dW2 and dW1 fed the plain
    steps' a, ln2 and d_hid (CUDA tensors, no count)."""
    ref = run_steps(ffn_bwd_steps(p, False, full, op), t)
    kern = dict(ffn_bwd_steps(p, True, full, op))
    out = [_held(f"ffn_bwd: {key}", got, ref[key], FFN_BWD_TOLERANCE[key], op)
           for key, got in kern["ffn_bwd"](t).items()]
    for name in ("dW2", "dW1"):
        out += [_held(f"{name}: {key}", got, ref[key], BWD_STEP_TOLERANCE[key], op)
                for key, got in kern[name](ref).items()]
    return out, ref


def mit_block_train_bwd_step_errors(x, g1, be1, wq, bq, k, v, wproj, bproj, g2, be2, w1, b1,
                                    kdw, bdw, w2, s_attn, s_ffn, go, num_heads: int = 1,
                                    eps: float = 1e-6) -> list:
    """[(check, max |kernel − plain|, tolerance)] of the backward's launches,
    each fed the plain path's inputs (CUDA tensors, no count): the FFN half's
    (``ffn_bwd_step_errors``), then the attention half's six."""
    op = "mit_block_train_bwd"
    ins = (x, g1, be1, wq, bq, k, v, wproj, bproj, g2, be2, w1, b1, kdw, bdw, w2)
    acts = _run(_block_steps(*ins, None, num_heads=num_heads, eps=eps, kernel=False,
                             s_attn=s_attn, s_ffn=s_ffn, op=op), names=_ACTS)
    p = dict(zip(_INPUTS, ins), shape=tuple(x.shape), dt=x.dtype, num_heads=num_heads, eps=eps,
             s_attn=s_attn, s_ffn=s_ffn)
    errs, ref = ffn_bwd_step_errors(p, bwd_table(x.contiguous(), go.contiguous(), acts), True,
                                    op)
    return errs + bwd_step_errors(_attn_bwd_steps, p, ref, op)
