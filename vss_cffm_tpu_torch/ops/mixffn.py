"""The FFN half of a MiT block, ``out = x + s·FFN(LN(x))``, in training and
at inference, and the MixFFN alone.

``block_ffn_train(x, gamma, beta, w1, b1, kdw, bdw, w2, b2, scale, eps,
force=None)`` keeps the JAX signature (``force`` in place of ``interpret``):
x (B, H, W, C), dense kernels in the JAX layout (in, out), kdw (3, 3, 1, Ch),
``scale`` (B,) the per-frame stochastic-depth branch scale (no gradient). It
is the ``train_block_impl="ffn"`` form of the block: the attention half runs
composed, this pair the rest.

It replaces the TPU kernels ``vss_cffm_tpu/ops/mixffn.py:
_block_ffn_fwd_scaled`` (``_kernel_ln`` with a scale) and
``_block_ffn_bwd_pallas`` (``_bwd_kernel_ln``), whose bodies are line for
line the FFN half of the whole-block train pair. So the CUDA path is that
pair's FFN launches (``ops/stage_block.py``): the forward is launches 4-6
(``block_gemm`` with LN in the prologue, ``dwconv``, ``block_gemm`` with the
scale and the residual in the epilogue), keeping hid and a for the
backward; the backward is d_a, d_hid (with d_z on chip), d_ln2, the LayerNorm backward
(dx = go + LNᵀ(d_ln) in x's dtype) and the dW2, dW1 row reductions.

``block_ffn_train_torch`` and ``block_ffn_train_bwd_torch`` are the plain
versions with the TPU kernel's rounding points: f32 LN statistics, the LN
output, a, bf16(go·s) and d_hid rounded to x's dtype, the hidden map, z and
every sum in f32, and one rounding of the f32 x + s·branch (where
``block_ffn_train_xla`` rounds the branch first).

**Inference** (``SegmentorConfig.dwconv_impl="fused"``), no backward: like
``mit_block_fused`` each raises when autograd records and an input requires
grad.

- ``block_ffn_fused(x, gamma, beta, w1, b1, kdw, bdw, w2, b2, eps, force)``
  = x + (GELU(dw3×3(LN(x)·W1 + b1) + bdw)·W2 + b2) replaces the TPU kernel
  ``vss_cffm_tpu/ops/mixffn.py:block_ffn_fused`` (``_kernel_ln`` without a
  scale): the forward's three launches without the branch scale. Its
  rounding points are the Pallas kernel's: f32 LN statistics, the LN output
  in x's dtype, the hidden map in f32 (the composed block rounds it), a =
  GELU(·) rounded once, one rounding of the f32 x + branch. The XLA twin
  ``block_ffn_xla`` rounds the branch before the residual; the port follows
  the kernel.
- ``mixffn_fused(x, w1, b1, kdw, bdw, w2, b2, force)`` = GELU(dw3×3(x·W1 +
  b1) + bdw)·W2 + b2 replaces ``mixffn_fused`` (``_kernel``): the same
  launches without the LayerNorm prologue and without the residual, the
  hidden map in f32, the output in x's dtype.

In the MiT block with ``dwconv_impl="fused"`` the FFN half of every block
that ``block_impl`` does not fuse takes ``block_ffn_fused`` at inference, so
no block of the segmentor reaches ``mixffn_fused`` (the JAX gates are the
same): ``MixFFN`` in eval mode takes it when called as a module of its own.
``block_ffn_fused_torch`` and ``mixffn_fused_torch`` are the plain versions.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from ._dispatch import custom_op, refuse_grad, require, use_kernel
from .stage_block import (STEP_TOLERANCE, _ffn_fwd_steps, _held, bwd_step_errors, bwd_table,
                          ffn_bwd_steps, run_steps)

__all__ = ["block_ffn_fused", "block_ffn_fused_torch", "mixffn_fused", "mixffn_fused_torch",
           "block_ffn_train", "block_ffn_train_bwd", "block_ffn_train_torch",
           "block_ffn_train_bwd_torch", "block_ffn_train_fits", "block_ffn_train_step_errors",
           "block_ffn_train_bwd_step_errors", "FFN_GRADS"]

# the backward's outputs in the JAX order, as the table names them
FFN_GRADS = ("dx", "dg2", "dbe2", "dw1", "db1", "dkdw", "dbdw", "dw2", "db2")
_ACTS = ("hid", "a")
# what trains in place of the inference FFN ops, which have no backward
_TRAIN_INSTEAD = "block_ffn_train or the composed MixFFN (train() mode)"


def _forward(x, gamma, beta, w1, b1, kdw, bdw, w2, b2, scale, eps: float, kernel: bool,
             op: str, names=("hid", "a", "out"), residual: bool = True) -> dict:
    """{hid, a[, out]} of the FFN's forward; x is the FFN's input and (with
    ``residual``) its residual; gamma None skips the LayerNorm."""
    if kernel:
        require(x.dim() == 4 and x.dtype == torch.bfloat16, op,
                f"x {x.dtype} {tuple(x.shape)} (bf16 NHWC only)")
        x = x.contiguous()
    steps = _ffn_fwd_steps(gamma, beta, w1, b1, kdw, bdw, w2, b2, scale, eps, tuple(x.shape),
                           x.dtype, kernel, op)
    y = x.reshape(-1, x.shape[-1])
    t = {"hid": steps["hid"](y)}
    t["a"] = steps["a"](t["hid"])
    if "out" in names:
        t["out"] = steps["out"](t["a"], y if residual else None).reshape(x.shape)
    return t


def block_ffn_fused_torch(x, gamma, beta, w1, b1, kdw, bdw, w2, b2,
                          eps: float = 1e-6) -> torch.Tensor:
    """The plain ``block_ffn_fused``, with ``_kernel_ln``'s rounding points."""
    return _forward(x, gamma, beta, w1, b1, kdw, bdw, w2, b2, None, eps, False,
                    "block_ffn_fused")["out"]


@custom_op("block_ffn_fused")
def _block_ffn_fused_op(x: Tensor, gamma: Tensor, beta: Tensor, w1: Tensor, b1: Tensor,
                        kdw: Tensor, bdw: Tensor, w2: Tensor, b2: Tensor, eps: float,
                        force: Optional[str]) -> Tensor:
    op = "block_ffn_fused"
    kernel = use_kernel(force, x, op)
    out = _forward(x, gamma, beta, w1, b1, kdw, bdw, w2, b2, None, eps, kernel, op)["out"]
    if kernel:
        block_ffn_fused.launches += 1
    return out


def block_ffn_fused(x, gamma, beta, w1, b1, kdw, bdw, w2, b2, eps: float = 1e-6,
                    force: str | None = None) -> torch.Tensor:
    """Inference ``x + FFN(LN(x))``, x (B, H, W, C), dense kernels (in, out),
    kdw (3, 3, 1, Ch). force: None (kernels on CUDA, plain on CPU) | 'torch'
    | 'kernel'; the custom op ``vss_cffm::block_ffn_fused``. Raises under
    autograd when an input requires grad."""
    args = (x, gamma, beta, w1, b1, kdw, bdw, w2, b2)
    refuse_grad("block_ffn_fused", args, _TRAIN_INSTEAD)
    return _block_ffn_fused_op(*args, eps, force)


def mixffn_fused_torch(x, w1, b1, kdw, bdw, w2, b2) -> torch.Tensor:
    """The plain ``mixffn_fused``, with ``_kernel``'s rounding points."""
    return _forward(x, None, None, w1, b1, kdw, bdw, w2, b2, None, 0.0, False, "mixffn_fused",
                    residual=False)["out"]


@custom_op("mixffn_fused",
           fake=lambda x, w1, b1, kdw, bdw, w2, *args: x.new_empty((*x.shape[:-1], w2.shape[1])))
def _mixffn_fused_op(x: Tensor, w1: Tensor, b1: Tensor, kdw: Tensor, bdw: Tensor, w2: Tensor,
                     b2: Tensor, force: Optional[str]) -> Tensor:
    op = "mixffn_fused"
    kernel = use_kernel(force, x, op)
    out = _forward(x, None, None, w1, b1, kdw, bdw, w2, b2, None, 0.0, kernel, op,
                   residual=False)["out"]
    if kernel:
        mixffn_fused.launches += 1
    return out


def mixffn_fused(x, w1, b1, kdw, bdw, w2, b2, force: str | None = None) -> torch.Tensor:
    """Inference ``GELU(dw3×3(x·W1 + b1) + bdw)·W2 + b2`` in x's dtype. force:
    None (kernels on CUDA, plain on CPU) | 'torch' | 'kernel'; the custom op
    ``vss_cffm::mixffn_fused``. Raises under autograd when an input requires
    grad."""
    args = (x, w1, b1, kdw, bdw, w2, b2)
    refuse_grad("mixffn_fused", args, _TRAIN_INSTEAD)
    return _mixffn_fused_op(*args, force)


block_ffn_fused.launches = 0
mixffn_fused.launches = 0


def _params(x, gamma, beta, w1, kdw, bdw, w2, scale, eps: float) -> dict:
    return dict(shape=tuple(x.shape), dt=x.dtype, g2=gamma, be2=beta, w1=w1, kdw=kdw, bdw=bdw,
                w2=w2, s_ffn=scale, s_attn=None, eps=eps)


def _backward(x, gamma, beta, w1, b1, kdw, bdw, w2, scale, go, eps: float, kernel: bool,
              acts: dict | None, op: str) -> tuple:
    if acts is None:  # recompute the forward's activations, as the TPU kernel does
        acts = _forward(x, gamma, beta, w1, b1, kdw, bdw, w2, None, scale, eps, kernel, op,
                        names=_ACTS)
    t = bwd_table(x, go, dict(acts, y=x.reshape(-1, x.shape[-1])), _ACTS + ("y",))
    p = _params(x, gamma, beta, w1, kdw, bdw, w2, scale, eps)
    t = run_steps(ffn_bwd_steps(p, kernel, False, op), t)
    t["dx"] = t["dx"].reshape(x.shape)
    return tuple(t[n] for n in FFN_GRADS)


def block_ffn_train_torch(x, gamma, beta, w1, b1, kdw, bdw, w2, b2, scale,
                          eps: float = 1e-6) -> torch.Tensor:
    """The plain forward of the pair."""
    return _forward(x, gamma, beta, w1, b1, kdw, bdw, w2, b2, scale, eps, False,
                    "block_ffn_train")["out"]


def block_ffn_train_bwd_torch(x, gamma, beta, w1, b1, kdw, bdw, w2, scale, go,
                              eps: float = 1e-6) -> tuple:
    """The plain backward, written out with ``_bwd_kernel_ln``'s rounding
    points: the forward recomputed from x, then the FFN half's backward
    steps. Returns ``FFN_GRADS``: dx in x's dtype, the rest f32."""
    return _backward(x, gamma, beta, w1, b1, kdw, bdw, w2, scale, go, eps, False, None,
                     "block_ffn_train_bwd")


def block_ffn_train_bwd(x, gamma, beta, w1, b1, kdw, bdw, w2, scale, go, eps: float = 1e-6,
                        force: str | None = None, acts: dict | None = None) -> tuple:
    """``FFN_GRADS`` for the output cotangent go. force: None (kernels on
    CUDA, plain on CPU) | 'torch' | 'kernel'. ``acts``: the forward's kept
    hid and a as (M, ·) rows, recomputed from x when None."""
    op = "block_ffn_train_bwd"
    kernel = use_kernel(force, x, op)
    if kernel:
        require(x.dtype == torch.bfloat16 and go.dtype == torch.bfloat16 and go.shape == x.shape,
                op, f"x {x.dtype} {tuple(x.shape)}, go {go.dtype} {tuple(go.shape)}")
        x, go = x.contiguous(), go.contiguous()
    out = _backward(x, gamma, beta, w1, b1, kdw, bdw, w2, scale, go, eps, kernel, acts, op)
    if kernel:
        block_ffn_train_bwd.launches += 1
    return out


class _BlockFFNTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, w1, b1, kdw, bdw, w2, b2, scale, eps, force, kernel):
        ins = (x, gamma, beta, w1, b1, kdw, bdw, w2, b2)
        t = _forward(*ins, scale, eps, kernel, "block_ffn_train")
        if kernel:
            block_ffn_train.launches += 1
        ctx.save_for_backward(*ins[:-1], scale, t["hid"], t["a"])
        ctx.args = (eps, force, [a.dtype for a in ins])
        return t["out"]

    @staticmethod
    def backward(ctx, go):
        x, gamma, beta, w1, b1, kdw, bdw, w2, scale, hid, a = ctx.saved_tensors
        eps, force, dtypes = ctx.args
        grads = block_ffn_train_bwd(x, gamma, beta, w1, b1, kdw, bdw, w2, scale, go, eps,
                                    force=force, acts={"hid": hid, "a": a})
        return (*(g.to(d) for g, d in zip(grads, dtypes)), None, None, None, None)


def block_ffn_train(x, gamma, beta, w1, b1, kdw, bdw, w2, b2, scale, eps: float = 1e-6,
                    force: str | None = None) -> torch.Tensor:
    """Differentiable ``x + scale·FFN(LN(x))``; every gradient is cast to its
    own input's dtype, the scale gets none. force: None (kernels on CUDA,
    plain on CPU) | 'torch' | 'kernel'; the backward follows it
    (``block_ffn_train_bwd``)."""
    kernel = use_kernel(force, x, "block_ffn_train")
    return _BlockFFNTrain.apply(x, gamma, beta, w1, b1, kdw, bdw, w2, b2, scale, eps, force,
                                kernel)


block_ffn_train.launches = 0
block_ffn_train_bwd.launches = 0


def block_ffn_train_fits(h: int, w: int, c: int, ch: int) -> bool:
    """Whether the pair's launches take the geometry: widths multiples of 8
    and C <= 512 (the LayerNorm backward's rows). The MiT block runs its FFN
    half composed otherwise, on every device alike."""
    return h >= 1 and w >= 1 and c % 8 == 0 and ch % 8 == 0 and 0 < c <= 512


def block_ffn_train_step_errors(x, gamma, beta, w1, b1, kdw, bdw, w2, b2, scale,
                                eps: float = 1e-6) -> list:
    """[(check, max |kernel − plain|, tolerance)] of the forward's three
    launches, each fed the plain path's inputs (CUDA tensors, no count), at
    ``stage_block.STEP_TOLERANCE``; scale None gives ``block_ffn_fused``'s."""
    op = "block_ffn_train"
    ins = (x, gamma, beta, w1, b1, kdw, bdw, w2, b2, scale, eps)
    plain = _ffn_fwd_steps(*ins[1:], tuple(x.shape), x.dtype, False, op)
    kern = _ffn_fwd_steps(*ins[1:], tuple(x.shape), x.dtype, True, op)
    ref = _forward(*ins, False, op)
    y = x.contiguous().reshape(-1, x.shape[-1])
    zero = torch.zeros_like(y)
    return [_held(name, got, want, STEP_TOLERANCE[name], op) for name, got, want in (
        ("fc1 (hid)", kern["hid"](y), ref["hid"]),
        ("dwconv+GELU (a)", kern["a"](ref["hid"]), ref["a"]),
        ("fc2 (out - y)", kern["out"](ref["a"], zero), plain["out"](ref["a"], zero)),
        ("fc2 + y (out)", kern["out"](ref["a"], y), ref["out"].reshape(y.shape)))]


def block_ffn_train_bwd_step_errors(x, gamma, beta, w1, b1, kdw, bdw, w2, scale, go,
                                    eps: float = 1e-6) -> list:
    """[(check, max |kernel − plain|, tolerance)] of the backward's six
    launches, each fed the plain path's inputs (CUDA tensors, no count), at
    ``stage_block.BWD_STEP_TOLERANCE``."""
    op = "block_ffn_train_bwd"
    acts = _forward(x, gamma, beta, w1, b1, kdw, bdw, w2, None, scale, eps, False, op,
                    names=_ACTS)
    y = x.contiguous().reshape(-1, x.shape[-1])
    t = bwd_table(x.contiguous(), go.contiguous(), dict(acts, y=y), _ACTS + ("y",))
    p = _params(x, gamma, beta, w1, kdw, bdw, w2, scale, eps)
    return bwd_step_errors(lambda p_, k, o: ffn_bwd_steps(p_, k, False, o), p, t, op)
