"""Whole MiT block at inference: LN1 → q → SRA attention → proj + x → LN2 →
fc1 → 3×3 depthwise + GELU → fc2 + y.

``mit_block_fused(x, g1, be1, wq, bq, k, v, wproj, bproj, g2, be2, w1, b1,
kdw, bdw, w2, b2, num_heads, eps, force=None)`` keeps the JAX signature:
x (B, H, W, C); k / v (B, S, C), the spatial-reduced keys and values per
frame, computed outside (the scale is folded into K here); dense kernels in
the JAX layout (in, out); kdw (3, 3, 1, Ch).

It replaces the TPU kernel ``vss_cffm_tpu/ops/stage_block.py:
mit_block_fused`` (``_kernel``), which kept the whole block in VMEM per
(frame, row tile). On the H100 the block's stage-3 working set does not fit
one block's 227 KB of shared memory, so the CUDA path is a sequence of six
hand-written launches, with no library kernel inside:

  1. ``block_gemm``  q   = bf16(LN1(x)·Wq + bq)          LN1 fused in the prologue
  2. ``attention``   ctx = bf16(softmax(q·(s·K)ᵀ)·V)      scores stay in shared memory
  3. ``block_gemm``  y   = f32(x + ctx·Wproj + bproj)
  4. ``block_gemm``  hid = f32(LN2(y)·W1 + b1)            LN2 fused in the prologue
  5. ``dwconv``      a   = bf16(GELU(dw3×3(hid) + bdw))   zero padding outside the image
  6. ``block_gemm``  out = bf16(y + a·W2 + b2)

q, ctx, y, hid and a go through device memory where the TPU kernel kept
them in VMEM (their bytes are recorded in PERF.md). Fusing the block back
into fewer launches is later work.

``mit_block_torch`` is the plain version, the same dtype plan as the JAX
``mit_block_xla``: f32 LayerNorm statistics and residual chain, inputs of
every product rounded to x's dtype, f32 accumulation, y and the hidden map
kept in f32. Both paths run the same six steps (``_block_steps``), so
``mit_block_step_errors`` can hold each launch on its own against its plain
step, at a tolerance relative to that step's own output.
"""

from __future__ import annotations

import torch

from . import _build
from ._dispatch import ptr, require, stream_of, use_kernel
from .cfm_attention import attention_launch, scale_in
from .dwconv import dwconv3x3_launch, dwconv3x3_torch

__all__ = ["mit_block_fused", "mit_block_torch", "mit_block_step_errors"]


def _ln_f32(xf: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
            eps: float) -> torch.Tensor:
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return (xf - mu) * torch.rsqrt(var + eps) * gamma + beta


def _mm(a: torch.Tensor, w: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """Product of inputs rounded to dt, accumulated in f32."""
    return a.to(dt).float() @ w.to(dt).float()


def _gemm(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, *, out_dtype: torch.dtype,
          ln: tuple[torch.Tensor, torch.Tensor, float] | None = None,
          res: torch.Tensor | None = None, op: str = "mit_block_fused") -> torch.Tensor:
    """out (M, N) = [LN(a) | a] · w + bias [+ res] on the block_gemm kernel."""
    m, kdim = a.shape
    n = w.shape[1]
    require(kdim % 8 == 0 and n % 8 == 0, op, f"GEMM K={kdim}, N={n} not multiples of 8")
    require(tuple(w.shape) == (kdim, n), op, f"weight {tuple(w.shape)} for K={kdim}")
    dev = a.device
    wb = w.to(device=dev, dtype=torch.bfloat16).contiguous()
    bb = bias.to(device=dev, dtype=torch.float32).contiguous()
    g = bt = None
    eps = 0.0
    if ln is not None:
        require(kdim <= 2048, op, f"LayerNorm over {kdim} > 2048 channels")
        g = ln[0].to(device=dev, dtype=torch.float32).contiguous()
        bt = ln[1].to(device=dev, dtype=torch.float32).contiguous()
        eps = ln[2]
    res_kind = 0
    if res is not None:
        require(tuple(res.shape) == (m, n), op, f"residual {tuple(res.shape)}")
        res_kind = {torch.bfloat16: 1, torch.float32: 2}[res.dtype]
    out = torch.empty((m, n), device=dev, dtype=out_dtype)
    devi, stream = stream_of(a)
    rc = _build.library("block_gemm").gemm_ln_bias_res(
        ptr(a, op), ptr(g, op), ptr(bt, op), ptr(wb, op), ptr(bb, op), ptr(res, op),
        ptr(out, op), m, n, kdim, int(a.dtype == torch.float32), int(ln is not None),
        res_kind, int(out_dtype == torch.float32), eps, devi, stream)
    _build.check(rc, op)
    return out


# The block's six steps, in order, with the steps whose outputs each reads
# (every step also reads the block's own inputs). Activations are (M, ·)
# with M = B·H·W: q, ctx, a and out in x's dtype, y and hid in f32.
STEPS = (("q", ()), ("ctx", ("q",)), ("y", ("ctx",)), ("hid", ("y",)), ("a", ("hid",)),
         ("out", ("a", "y")))


def _block_steps(x, g1, be1, wq, bq, k, v, wproj, bproj, g2, be2, w1, b1, kdw, bdw, w2, b2,
                 num_heads: int, eps: float, kernel: bool) -> dict:
    """The step functions of one block: the plain ones, or (kernel=True) the
    hand-written launches, which check their inputs first."""
    dt = x.dtype
    b, h, w, c = x.shape
    nh, dh = num_heads, c // num_heads
    ch = w1.shape[1]
    m = b * h * w
    if not kernel:
        xf = x.float().reshape(m, c)
        ns = k.shape[1]

        def ctx_torch(q):
            qh = q.reshape(b, h * w, nh, dh).transpose(1, 2).float()      # (b, nh, hw, dh)
            kh = (k.to(dt) * scale_in(dt, dh ** -0.5)).reshape(b, ns, nh, dh)
            vh = v.to(dt).reshape(b, ns, nh, dh)
            s = qh @ kh.permute(0, 2, 3, 1).float()                        # (b, nh, hw, S)
            p = torch.softmax(s, dim=-1).to(dt)
            ctx = (p.float() @ vh.transpose(1, 2).float()).to(dt)          # (b, nh, hw, dh)
            return ctx.transpose(1, 2).reshape(m, c)

        return {
            "q": lambda: (_mm(_ln_f32(xf, g1.float(), be1.float(), eps).to(dt), wq, dt)
                          + bq.float()).to(dt),
            "ctx": ctx_torch,
            "y": lambda ctx: xf + (_mm(ctx, wproj, dt) + bproj.float()),
            "hid": lambda y: _mm(_ln_f32(y, g2.float(), be2.float(), eps).to(dt), w1, dt)
            + b1.float(),
            "a": lambda hid: dwconv3x3_torch(hid.reshape(b, h, w, ch), kdw, bdw,
                                             gelu=True).to(dt).reshape(m, ch),
            "out": lambda a, y: ((_mm(a, w2, dt) + b2.float()) + y).to(dt),
        }
    op = "mit_block_fused"
    require(x.dim() == 4 and x.dtype == torch.bfloat16, op,
            f"x {x.dtype} {tuple(x.shape)} (bf16 NHWC only)")
    require(c % num_heads == 0, op, f"C={c} not divisible by {num_heads} heads")
    require(k.dim() == 3 and k.shape[0] == b and k.shape[2] == c and k.shape == v.shape, op,
            f"k {tuple(k.shape)} / v {tuple(v.shape)}")
    xf = x.contiguous().view(m, c)
    kb = k.to(torch.bfloat16).contiguous()
    vb = v.to(torch.bfloat16).contiguous()
    k_scale = scale_in(torch.bfloat16, dh ** -0.5)
    return {
        "q": lambda: _gemm(xf, wq, bq, out_dtype=torch.bfloat16, ln=(g1, be1, eps)),
        "ctx": lambda q: attention_launch(q.view(b, h * w, c), kb, vb, None, None, nh, 1.0,
                                          k_scale, op).view(m, c),
        "y": lambda ctx: _gemm(ctx, wproj, bproj, out_dtype=torch.float32, res=xf),
        "hid": lambda y: _gemm(y, w1, b1, out_dtype=torch.float32, ln=(g2, be2, eps)),
        "a": lambda hid: dwconv3x3_launch(hid.view(b, h, w, ch), kdw, bdw, gelu=True,
                                          op=op).view(m, ch),
        "out": lambda a, y: _gemm(a, w2, b2, out_dtype=torch.bfloat16, res=y),
    }


def _run(steps: dict) -> dict:
    t = {}
    for name, reads in STEPS:
        t[name] = steps[name](*(t[r] for r in reads))
    return t


def mit_block_torch(x, g1, be1, wq, bq, k, v, wproj, bproj, g2, be2, w1, b1, kdw, bdw,
                    w2, b2, num_heads: int = 1, eps: float = 1e-6) -> torch.Tensor:
    args = (x, g1, be1, wq, bq, k, v, wproj, bproj, g2, be2, w1, b1, kdw, bdw, w2, b2)
    return _run(_block_steps(*args, num_heads=num_heads, eps=eps, kernel=False))["out"] \
        .view(x.shape)


# Per-step checks of the kernel path (on the card): each kernel step is fed
# the plain path's own inputs to it and held to a fraction of the largest
# output of what it computes. bf16 outputs (q, ctx, a, out) come from f32
# sums taken in another order than the plain version's, so one rounding may
# flip by one bf16 ulp (2^-7 of the largest value), or, after a product
# whose inputs were themselves rounded (q after LN1, ctx after P), carry
# through it: 2^-6. y and hid are f32: proj is held as y − x, the attention
# branch alone, to 2^-10 (same bf16 inputs, f32 sums in another order); fc1
# to 2^-7, as LN2's bf16 output may flip one ulp. fc2 is held alone (zero
# residual) and with the residual y.
STEP_TOLERANCE = {"q": 2.0 ** -6, "ctx": 2.0 ** -6, "proj (y - x)": 2.0 ** -10,
                  "fc1 (hid)": 2.0 ** -7, "dwconv+GELU (a)": 2.0 ** -7,
                  "fc2 (out - y)": 2.0 ** -6, "fc2 + y (out)": 2.0 ** -6}


def mit_block_step_errors(x, g1, be1, wq, bq, k, v, wproj, bproj, g2, be2, w1, b1, kdw, bdw,
                          w2, b2, num_heads: int = 1, eps: float = 1e-6) -> list:
    """[(check, max |kernel - plain|, tolerance), ...] for each step of the
    kernel path, run on CUDA tensors against the plain steps (no count)."""
    args = (x, g1, be1, wq, bq, k, v, wproj, bproj, g2, be2, w1, b1, kdw, bdw, w2, b2)
    plain = _block_steps(*args, num_heads=num_heads, eps=eps, kernel=False)
    kern = _block_steps(*args, num_heads=num_heads, eps=eps, kernel=True)
    ref = _run(plain)
    xf = x.float().reshape(ref["y"].shape)
    zero = torch.zeros_like(ref["y"])
    pairs = {
        "q": (kern["q"](), ref["q"]),
        "ctx": (kern["ctx"](ref["q"]), ref["ctx"]),
        "proj (y - x)": (kern["y"](ref["ctx"]) - xf, ref["y"] - xf),
        "fc1 (hid)": (kern["hid"](ref["y"]), ref["hid"]),
        "dwconv+GELU (a)": (kern["a"](ref["hid"]), ref["a"]),
        "fc2 (out - y)": (kern["out"](ref["a"], zero), plain["out"](ref["a"], zero)),
        "fc2 + y (out)": (kern["out"](ref["a"], ref["y"]), ref["out"]),
    }
    out = []
    for name, (got, want) in pairs.items():
        require(got.dtype == want.dtype and got.shape == want.shape, "mit_block_fused",
                f"step {name}: {got.dtype} {tuple(got.shape)} vs {want.dtype} "
                f"{tuple(want.shape)}")
        err = (got.float() - want.float()).abs().max().item()
        if not torch.isfinite(got.float()).all():
            err = float("inf")
        scale = want.float().abs().max().item()
        out.append((name, err, STEP_TOLERANCE[name] * max(scale, 1e-30)))
    return out


def mit_block_fused(x, g1, be1, wq, bq, k, v, wproj, bproj, g2, be2, w1, b1, kdw, bdw,
                    w2, b2, num_heads: int = 1, eps: float = 1e-6,
                    force: str | None = None) -> torch.Tensor:
    """force: None (kernel on CUDA, plain on CPU) | 'torch' | 'kernel'."""
    args = (x, g1, be1, wq, bq, k, v, wproj, bproj, g2, be2, w1, b1, kdw, bdw, w2, b2)
    if not use_kernel(force, x, "mit_block_fused"):
        return mit_block_torch(*args, num_heads=num_heads, eps=eps)
    out = _run(_block_steps(*args, num_heads=num_heads, eps=eps, kernel=True))["out"]
    mit_block_fused.launches += 1
    return out.view(x.shape)


mit_block_fused.launches = 0
