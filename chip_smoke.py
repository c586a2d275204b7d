#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Drives the port's two paths with random weights drawn from a fixed seed:
CFFM-B1 clip inference (4 frames of 480×480 in, one refined target-frame
mask out) through ``init_segmentor`` and ``inference_segmentor``, then
CFFM-B1 train steps (2 clips of 4 frames, 480×480, bf16 compute, f32
parameters) through ``TrainState`` and ``make_train_step``, in the three
block forms of training: the default ``train_block_impl=("full", "full",
"full", None)`` (the whole-block train pair at stages 1-3), "ffn" (the
block-FFN pair) and None (composed blocks).

Phases (any failure raises and exits non-zero; nothing is caught):
  1. the device: name, ``nvidia-smi`` name and power limit, torch and CUDA;
  2. build every kernel from ``vss_cffm_tpu_torch/csrc`` (one nvcc per
     source, all at once), timed;
  3. each kernel at the main path's own inputs (captured from one forward of
     the plain path), in bf16: kernel against its plain PyTorch version on the
     card (max abs error, stated tolerance), then CUDA-event times of the
     kernel, the plain version and, where one PyTorch call computes the same
     function, that call (``library_ms``); ``bound_ms`` is the least time the
     card could take, the largest of bytes / 3.35 TB/s, tensor ops / 989
     TFLOP/s and f32 ops / 67 TFLOP/s (H100 SXM data-sheet peaks); the whole
     block is also held step by step: each of its six launches against its
     plain step, at a tolerance relative to that step's own output;
  4. the main path: launch counts set to 0, CLIPS synthetic uint8 clips through
     ``inference_segmentor``, counts read and held to 4 / 2 / 4 per clip
     (whole block / CFM attention / depthwise conv); logits against the same
     model under ``force="torch"`` on the card; end-to-end frames/s (one output
     frame per clip, the repo's bench convention), the median of ROUNDS
     rounds of TIMED_CLIPS clips with every round printed, and peak memory;
  5. the train phase, once per block form (``TRAIN_FORMS``): a synthetic
     uint8 batch (2, 4, 480, 480, 3) with labels in [0, 124), ~5 % ignored
     (255); the inputs of the form's kernels captured from one plain
     forward/backward (with the output cotangent of each block pair), and
     each held against its plain version as in 3: in the default form the
     CE forward and backward at N 8 and N 2, the CFM attention forward and
     backward at 162 windows, the depthwise conv at stage 4 and the
     whole-block train pair at stages 1-3, forward (its six launches step by
     step) and backward (its fifteen launches step by step, then its 17
     outputs each at its own scale); in "ffn" the block-FFN pair likewise;
     composed, the depthwise conv with its pre-activation output at the
     four stages; the gradients of one forward/backward with the kernels
     against the plain path's on the same weights, batch and generator;
     then, with the counts set to 0, TRAIN_COUNTED train steps, the counts
     held to the form's launches per step and a finite loss; then ms per
     step, train frames/s (B·T frames per step) over the form's rounds of
     TRAIN_STEPS steps, every round printed, and peak memory;
  6. one JSON line of kernels, the ``nvidia-smi`` line, and the final
     ``{"ok": true, "device": {...}}`` line.

``--profile`` adds, for one clip and for one train step of each form, the
device busy time, the number of kernel launches and of ``aten::_to_copy``
calls, and a torch.profiler table of device time by kernel, written to
``chiprun_out/profile.txt`` and ``chiprun_out/profile_train{,_ffn,_composed}.txt``.

Per-kernel times in the JSON line are per call, averaged over the kernel's
shapes on its path (``ms``: the wrapper call between CUDA events, host
included; with ``--profile``, ``device_ms``: the device time of its launches
from torch.profiler); the per-shape times are printed above it. ``bound_ms`` is the least time the card could
take: the largest of bytes / 3.35 TB/s, tensor ops / 989 TFLOP/s, f32 ops /
67 TFLOP/s and exponentials / the MUFU rate (16 per SM per clock, 132 SMs at
1.98 GHz), H100 SXM data-sheet figures at 700 W.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet, 700 W
BF16_TENSOR_FLOPS = 989e12
F32_FLOPS = 67e12
MUFU_EXP_PER_S = 16 * 132 * 1.98e9  # ex2 on the special-function units
CLIPS = 3
TIMED_CLIPS = 10
ROUNDS = 3
SEED = 0
TRAIN_B, TRAIN_T, TRAIN_HW, NUM_CLASSES = 2, 4, 480, 124
TRAIN_COUNTED = 2
TRAIN_STEPS = 3
TRAIN_ROUNDS = 3
# bf16 roundings at the same points from f32 sums in other orders, carried
# through a block pair's chain of launches: 2^-5 of each output's largest
# value (the launches themselves are held one by one, at their own scales)
PAIR_REL = 2.0 ** -5


def _smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def _time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, iters: int = 5) -> float:
    """Device time of one call of fn: the CUDA kernels of ``iters`` calls as
    torch.profiler traces them, over iters (``--profile`` only)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation) / 1e3 / iters


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if isinstance(t, torch.Tensor))


def _bound_ms(nbytes: float, tensor_ops: float, f32_ops: float,
              exps: float = 0.0) -> tuple[float, str]:
    """The tensor cores, the f32 units and the special-function units (exp)
    run at the same time, so each sets its own floor; the bound is the
    largest of the four."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(tensor_ops / BF16_TENSOR_FLOPS, f32_ops / F32_FLOPS, exps / MUFU_EXP_PER_S)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


# ---- the three kernels: inputs captured from the main path, bounds, yardsticks ----


def _dwconv_case(ops, args):
    x, k, b = args
    n, h, w, c = x.shape
    out_bytes = x.numel() * 2
    # per output: 9 multiply-adds, the bias, GELU (~5 ops with erf as one)
    bound = _bound_ms(_nbytes(x, k, b) + out_bytes, 0, x.numel() * (18 + 1 + 5))
    wk = k.permute(3, 2, 0, 1).to(x.dtype).contiguous()   # (C, 1, 3, 3)
    xc = x.permute(0, 3, 1, 2)                            # NCHW view, channels-last memory
    bb = b.to(x.dtype)
    library = lambda: torch.nn.functional.gelu(
        torch.nn.functional.conv2d(xc, wk, bb, padding=1, groups=c))
    return dict(call=lambda force: ops.dwconv3x3(x, k, b, gelu=True, force=force),
                bound=bound, library=library, shape=f"x{tuple(x.shape)}")


def _cfm_case(ops, args):
    q, ks, vs, bias, mask, nh = args
    nw, area, c = q.shape
    n = sum(k.shape[1] for k in ks)
    hd = c // nh
    out_bytes = q.numel() * 2
    bound = _bound_ms(_nbytes(q, *ks, *vs, bias, mask) + out_bytes,
                      2 * 2 * nw * nh * area * n * hd, nw * nh * area * n * 5)
    heads = lambda t: t.reshape(nw, -1, nh, hd).transpose(1, 2)
    qh = heads(q)
    kh, vh = heads(torch.cat(ks, 1)), heads(torch.cat(vs, 1))
    attn_mask = (bias[None] + mask[:, None, None, :]).to(q.dtype)
    library = lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=attn_mask)
    return dict(call=lambda force: ops.cfm_attention(q, ks, vs, bias, mask, nh, force=force),
                bound=bound, library=library, shape=f"q{tuple(q.shape)} N={n} nh={nh}")


def _block_case(ops, args_kw):
    args, kw = args_kw
    x, k = args[0], args[5]
    b, h, w, c = x.shape
    ch = args[11].shape[1]
    m, s = b * h * w, k.shape[1]
    tensor_ops = 2 * m * c * c * 2 + 2 * m * s * c * 2 + 2 * m * c * ch * 2
    f32_ops = m * ch * (18 + 1 + 5) + m * c * 20      # depthwise + GELU, LN / softmax / residual
    bound = _bound_ms(_nbytes(*args) + x.numel() * 2, tensor_ops, f32_ops)
    return dict(call=lambda force: ops.mit_block_fused(*args, **kw, force=force),
                bound=bound, library=None, steps=lambda: ops.mit_block_step_errors(*args, **kw),
                shape=f"x{tuple(x.shape)} S={s} nh={kw['num_heads']} Ch={ch}")


def _capture_main_path_inputs(model, clip):
    """One plain forward; pre-hooks record each kernel's arguments at its
    main-path call sites (stage-1/-4 FFNs, stage-2/-3 blocks, decoder block)."""
    from vss_cffm_tpu_torch.models import set_force

    caught = {"dwconv3x3": [], "mit_block_fused": [], "cfm_attention": []}
    hooks = []
    bb = model.backbone
    for s in (1, 4):
        mlp = getattr(bb, f"block{s}")[0].mlp
        hooks.append(mlp.register_forward_pre_hook(
            lambda mod, a: caught["dwconv3x3"].append(mod.dwconv_args(a[0]))))
    for s in (2, 3):
        blk = getattr(bb, f"block{s}")[0]
        hooks.append(blk.register_forward_pre_hook(
            lambda mod, a: caught["mit_block_fused"].append(mod.fused_args(a[0]))))
    attn = model.decode_head.decoder_focal.blocks[0].attn
    hooks.append(attn.register_forward_pre_hook(
        lambda mod, a: caught["cfm_attention"].append(mod.attention_inputs(*a))))
    set_force(model, "torch")
    try:
        with torch.inference_mode():
            model(clip)
    finally:
        set_force(model, None)
        for hk in hooks:
            hk.remove()
    return caught


KERNELS = {
    "mit_block_fused": dict(
        # six launches of three sources: GEMM (q, proj, fc1, fc2), attention, dwconv
        sources=["vss_cffm_tpu_torch/csrc/block_gemm.cu", "vss_cffm_tpu_torch/csrc/attention.cu",
                 "vss_cffm_tpu_torch/csrc/dwconv.cu"],
        replaces="vss_cffm_tpu/ops/stage_block.py:106",  # _kernel of mit_block_fused
        # bf16 q, ctx and GELU output are rounded at the same points on both
        # sides, but from f32 sums taken in other orders (wmma vs cuBLAS), so
        # a rounding can flip by one bf16 ulp and carry through two products:
        # 2^-5 of the largest output. The residual x dominates that output,
        # so this whole-block check is only a sanity check: the steps are
        # held one by one (``ops.mit_block_step_errors``) at their own scales.
        rel_tol=2.0 ** -5, case=_block_case),
    "cfm_attention": dict(
        sources=["vss_cffm_tpu_torch/csrc/attention.cu"],
        # _fwd_kernel, called without probabilities by _cfm_attention_pallas_impl :372
        replaces="vss_cffm_tpu/ops/cfm_attention.py:81",
        # f32 scores in another summation order: P (rounded to bf16) and the
        # output may each flip one bf16 ulp: 2^-6 of the largest output.
        rel_tol=2.0 ** -6, case=_cfm_case),
    "dwconv3x3": dict(
        sources=["vss_cffm_tpu_torch/csrc/dwconv.cu"],
        replaces="vss_cffm_tpu/ops/dwconv.py:61",  # _kernel of _dwconv3x3_pallas
        # the same f32 sums (FMA contraction aside), one bf16 rounding: one ulp
        rel_tol=2.0 ** -7, case=_dwconv_case),
}


def _compare_one(got, want, rel_tol):
    """[(label, max |got − want|, tolerance)] for one tensor held to rel_tol of
    its largest value (train-step gradients are small: no absolute floor)."""
    if not torch.isfinite(got.float()).all():
        return [("out", float("inf"), 0.0)]
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    return [("out", err, rel_tol * max(scale, 1e-30))]


@torch.no_grad()
def check_kernels(ops, caught, kernels: dict, profile: bool = False) -> dict:
    results = {}
    for name, spec in kernels.items():
        per_shape = []
        for args in caught[name]:
            case = spec["case"](ops, args)
            got = case["call"]("kernel")
            want = case["call"]("torch")
            torch.cuda.synchronize()
            compare = case.get("compare") or (lambda g, w: _compare_one(g, w, spec["rel_tol"]))
            checks = compare(got, want)
            for label, err, tol in checks:
                print(f"[kernel] {name} {case['shape']} {label}: max_abs_err={err:.3e} "
                      f"tol={tol:.3e} ({err / tol if tol else float('inf'):.3f} of it)",
                      flush=True)
                if not err <= tol:
                    raise RuntimeError(f"{name}: kernel disagrees with its plain version "
                                       f"({label}: {err} > {tol}) at {case['shape']}")
            for step, s_err, s_tol in case["steps"]() if "steps" in case else ():
                print(f"[kernel] {name} {case['shape']} step {step}: max_abs_err={s_err:.3e} "
                      f"tol={s_tol:.3e}", flush=True)
                if not s_err <= s_tol:
                    raise RuntimeError(f"{name}: step {step} disagrees with its plain "
                                       f"version ({s_err} > {s_tol}) at {case['shape']}")
            ms = _time_ms(lambda: case["call"]("kernel"))
            plain_ms = _time_ms(lambda: case["call"]("torch"))
            lib_ms = _time_ms(case["library"]) if case["library"] is not None else None
            dev_ms = _device_ms(lambda: case["call"]("kernel")) if profile else None
            bound_ms, bound_by = case["bound"]
            print(f"[kernel] {name} {case['shape']}: ms={ms:.4f} plain_ms={plain_ms:.4f} "
                  f"library_ms={lib_ms} bound_ms={bound_ms:.4f} ({bound_by}) "
                  f"device_ms={dev_ms}", flush=True)
            per_shape.append(dict(shape=case["shape"], err=max(c[1] for c in checks), ms=ms,
                                  plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                                  bound_by=bound_by, device_ms=dev_ms))
        n = len(per_shape)
        mean = lambda k: sum(p[k] for p in per_shape) / n
        lib = None if per_shape[0]["library_ms"] is None else mean("library_ms")
        by = max(per_shape, key=lambda p: p["bound_ms"])["bound_by"]
        results[name] = dict(max_abs_err=max(p["err"] for p in per_shape), ms=mean("ms"),
                             plain_ms=mean("plain_ms"), bound_ms=mean("bound_ms"),
                             bound_by=by, library_ms=lib,
                             device_ms=mean("device_ms") if profile else None)
    return results


# ---- the train step's kernels: inputs captured from one plain step --------


def _ce_case(ops, args):
    logits, labels, s, img_w, count_acc = args
    c = logits.shape[-1]
    n_valid = int(((labels >= 0) & (labels < c)).sum())
    exps = n_valid * c
    # per class of a valid pixel: two lerps (6), max, subtract, sum (3)
    bound = _bound_ms(_nbytes(logits, labels), 0, exps * 9, exps)
    lab = labels.long()
    f = torch.nn.functional

    def library():
        # two calls: F.interpolate and F.cross_entropy (sum, ignore_index 255)
        up = f.interpolate(logits.permute(0, 3, 1, 2).float(), size=tuple(labels.shape[1:]),
                           mode="bilinear", align_corners=False)
        return f.cross_entropy(up, lab, reduction="sum", ignore_index=255)

    def compare(got, want):
        # wsum: f32 sums of ~10^6 NLLs in other orders, the lerp rounded as
        # F.interpolate rounds it: 1e-4 relative. corr: a pixel whose two
        # largest logits are within rounding may count either way: 1e-4 of
        # the valid pixels
        return [("wsum", abs(got[0].item() - want[0].item()), 1e-4 * abs(want[0].item())),
                ("corr", abs(got[1].item() - want[1].item()), 1e-4 * n_valid)]

    return dict(call=lambda force: ops.ce_upsampled_loss(logits, labels, s, img_w, count_acc,
                                                         force=force),
                bound=bound, library=library, compare=compare,
                shape=f"logits{tuple(logits.shape)} s={s}")


def _ce_bwd_case(ops, args):
    logits, labels, g, s, img_w = args
    c = logits.shape[-1]
    exps = int(((labels >= 0) & (labels < c)).sum()) * c
    # per class of a valid pixel: lerps, softmax, the weighted adjoint (~16)
    bound = _bound_ms(_nbytes(logits, labels) + logits.numel() * 2, 0, exps * 16, exps)
    f = torch.nn.functional
    x = logits.detach().clone().requires_grad_(True)
    lab = labels.long()
    with torch.enable_grad():
        up = f.interpolate(x.permute(0, 3, 1, 2).float(), size=tuple(labels.shape[1:]),
                           mode="bilinear", align_corners=False)
        loss = f.cross_entropy(up, lab, reduction="sum", ignore_index=255)
    gw = (g * img_w).float()
    library = lambda: torch.autograd.grad(loss, x, gw, retain_graph=True)
    return dict(call=lambda force: ops.ce_upsampled_loss_bwd(logits, labels, g, s, img_w,
                                                             force=force),
                bound=bound, library=library, shape=f"logits{tuple(logits.shape)} s={s}")


def _cfm_bwd_case(ops, args):
    q, k, v, bias, mask, g, nh = args
    nw, area, c = q.shape
    n, hd = k.shape[1], c // nh
    pairs = nw * nh * area * n
    out_bytes = _nbytes(q, k, v) + nh * area * n * 4
    # five products (S, dP, dV, dq, dK), one exp per score, ~12 f32 ops per score
    bound = _bound_ms(_nbytes(q, k, v, g, bias, mask) + out_bytes, 5 * 2 * pairs * hd,
                      12 * pairs, pairs)
    heads = lambda t: t.reshape(nw, -1, nh, hd).transpose(1, 2).detach().clone()
    qh, kh, vh, gh = heads(q), heads(k), heads(v), heads(g)
    am = (bias[None] + mask[:, None, None, :]).to(q.dtype)
    leaves = [t.requires_grad_(True) for t in (qh, kh, vh, am)]
    library = None
    try:
        with torch.enable_grad():
            out = torch.nn.functional.scaled_dot_product_attention(*leaves[:3],
                                                                   attn_mask=leaves[3])
            torch.autograd.grad(out, leaves, gh, retain_graph=True)
        library = lambda: torch.autograd.grad(out, leaves, gh, retain_graph=True)
    except RuntimeError as e:  # the yardstick only; the port never calls SDPA
        print(f"[kernel] cfm_attention_bwd: no library time: SDPA backward with a "
              f"grad-carrying attn_mask failed: {str(e).splitlines()[0]}", flush=True)

    def compare(got, want):
        # dq, dK, dV: bf16 ds and p rounded at the same points from f32 sums
        # in other orders, one ulp that may carry through one product: 2^-6
        # of each output's largest value; dbias: f32 sums over windows, 2^-10
        out = []
        for label, a, b, rel in zip(("dq", "dk", "dv", "dbias"), got, want,
                                    (2.0 ** -6,) * 3 + (2.0 ** -10,)):
            out += [(label, e, t) for _, e, t in _compare_one(a, b, rel)]
        return out

    return dict(call=lambda force: ops.cfm_attention_bwd(q, k, v, bias, mask, g, nh, force=force),
                bound=bound, library=library, compare=compare,
                shape=f"q{tuple(q.shape)} N={n} nh={nh}")


def _dwconv_train_case(ops, args):
    case = _dwconv_case(ops, args)
    x, k, b = args

    def z_check():
        # the pre-activation output the backward keeps: one bf16 rounding of
        # f32 sums taken in the same order, FMA contraction aside: one ulp
        z = torch.empty_like(x)
        ops.dwconv.dwconv3x3_launch(x, k, b, True, z=z)
        want = ops.dwconv._preact(x, k, b).to(torch.bfloat16)
        torch.cuda.synchronize()
        return [("z", *_compare_one(z, want, 2.0 ** -7)[0][1:])]

    case["steps"] = z_check
    return case


def _held_outputs(labels, got, want, rel):
    """[(label, err, tol)] of each output of a tuple, at rel of its own largest."""
    return [(label, e, t) for label, a, b in zip(labels, got, want)
            for _, e, t in _compare_one(a, b, rel)]


def _block_train_case(ops, rec):
    """Row 6: the whole-block train forward at a captured block's inputs."""
    args, kw, _ = rec
    x, k, w1 = args[0], args[5], args[11]
    b, h, w, c = x.shape
    m, s, ch, nh = b * h * w, k.shape[1], w1.shape[1], kw["num_heads"]
    # q, scores, P·V, proj, fc1, fc2; one exp per score; depthwise + GELU,
    # LayerNorms, softmax and residuals on the f32 units
    bound = _bound_ms(_nbytes(*args) + x.numel() * 2, 2 * m * (2 * c * c + 2 * s * c + 2 * c * ch),
                      m * ch * 24 + m * c * 20 + m * s * nh * 5, m * s * nh)

    def call(force):
        with torch.no_grad():
            return ops.mit_block_train(*args, **kw, force=force)

    # out is bf16 at the residual's scale, which dominates it at the step's
    # weights: the whole output is a sanity check (2^-5 of its largest
    # value), the six launches are held one by one at their own scales
    return dict(call=call, bound=bound, library=None,
                compare=lambda got, want: _compare_one(got, want, PAIR_REL),
                steps=lambda: ops.mit_block_step_errors(*args[:17], **kw, s_attn=args[17],
                                                        s_ffn=args[18], op="mit_block_train"),
                shape=f"x{tuple(x.shape)} S={s} nh={nh} Ch={ch}")


def _block_train_bwd_case(ops, rec):
    """Row 7: the whole-block train backward at a captured block's inputs and
    output cotangent, from the forward's kept activations (as in the step)."""
    args, kw, go = rec
    ins, s_attn, s_ffn = args[:16], args[17], args[18]
    x, k, w1 = args[0], args[5], args[11]
    b, h, w, c = x.shape
    m, s, ch, nh = b * h * w, k.shape[1], w1.shape[1], kw["num_heads"]
    sb = ops.stage_block
    acts = {force: sb._run(sb._block_steps(*ins, None, **kw, kernel=force == "kernel",
                                           s_attn=s_attn, s_ffn=s_ffn), names=sb._ACTS)
            for force in ("kernel", "torch")}
    grad_bytes = sum(t.numel() * 4 for t in ins[1:]) + _nbytes(k, args[6])
    # the TPU kernel's products, its recompute from x included: q and the
    # scores twice, P·V twice, proj, fc1; d_a, d_ln2, d_ctx, d_p, d_q, d_ln1;
    # dW2, dW1, dWproj, dWq, dKᵀ, dV. Exps: the softmax twice, GELU′ once.
    bound = _bound_ms(_nbytes(*ins, go) + x.numel() * 2 + grad_bytes,
                      2 * m * (7 * c * c + 8 * s * c + 5 * c * ch),
                      m * ch * 64 + m * c * 40 + m * s * nh * 10, 2 * m * s * nh + m * ch)
    return dict(call=lambda force: ops.mit_block_train_bwd(*ins, s_attn, s_ffn, go, **kw,
                                                           force=force, acts=acts[force]),
                bound=bound, library=None,
                compare=lambda g, w_: _held_outputs(sb.GRADS, g, w_, PAIR_REL),
                steps=lambda: sb.mit_block_train_bwd_step_errors(*ins, s_attn, s_ffn, go, **kw),
                shape=f"x{tuple(x.shape)} S={s} nh={nh} Ch={ch}")


def _ffn_train_case(ops, rec):
    """Row 10: the block-FFN train forward at a captured block's inputs."""
    args, eps, _ = rec
    x, w1 = args[0], args[3]
    b, h, w, c = x.shape
    m, ch = b * h * w, w1.shape[1]
    bound = _bound_ms(_nbytes(*args) + x.numel() * 2, 2 * m * 2 * c * ch,
                      m * ch * 24 + m * c * 20)

    def call(force):
        with torch.no_grad():
            return ops.block_ffn_train(*args, eps, force=force)

    # a sanity check of the whole output, as for row 6; the launches are held
    # one by one
    return dict(call=call, bound=bound, library=None,
                compare=lambda got, want: _compare_one(got, want, PAIR_REL),
                steps=lambda: ops.mixffn.block_ffn_train_step_errors(*args, eps),
                shape=f"x{tuple(x.shape)} Ch={ch}")


def _ffn_train_bwd_case(ops, rec):
    """Row 11: the block-FFN train backward, from the forward's kept hid and a."""
    args, eps, go = rec
    ins, scale = args[:8], args[9]
    x, w1 = args[0], args[3]
    b, h, w, c = x.shape
    m, ch = b * h * w, w1.shape[1]
    mx = ops.mixffn
    acts = {force: mx._forward(*args, eps, force == "kernel", "block_ffn_train",
                               names=mx._ACTS) for force in ("kernel", "torch")}
    grad_bytes = sum(t.numel() * 4 for t in ins[1:])
    # the TPU kernel's products: fc1 (recompute), d_a, d_ln, dW2, dW1; GELU′ exps
    bound = _bound_ms(_nbytes(*ins, go) + x.numel() * 2 + grad_bytes, 2 * m * 5 * c * ch,
                      m * ch * 64 + m * c * 40, m * ch)
    return dict(call=lambda force: mx.block_ffn_train_bwd(*ins, scale, go, eps, force=force,
                                                          acts=acts[force]),
                bound=bound, library=None,
                compare=lambda g, w_: _held_outputs(mx.FFN_GRADS, g, w_, PAIR_REL),
                steps=lambda: mx.block_ffn_train_bwd_step_errors(*ins, scale, go, eps),
                shape=f"x{tuple(x.shape)} Ch={ch}")


TRAIN_KERNELS = {
    "ce_upsampled_loss": dict(
        sources=["vss_cffm_tpu_torch/csrc/ce_upsampled.cu"],
        replaces="vss_cffm_tpu/ops/ce_upsampled.py:377",  # _fwd_loss_kernel, called at :448
        case=_ce_case),
    "ce_upsampled_loss_bwd": dict(
        sources=["vss_cffm_tpu_torch/csrc/ce_upsampled.cu"],
        replaces="vss_cffm_tpu/ops/ce_upsampled.py:764",  # _bwd_loss_kernel5, called at :883
        # bf16 dlogits, one rounding of f32 sums in other orders: one ulp
        rel_tol=2.0 ** -7, case=_ce_bwd_case),
    "cfm_attention_bwd": dict(
        sources=["vss_cffm_tpu_torch/csrc/attention_bwd.cu"],
        replaces="vss_cffm_tpu/ops/cfm_attention.py:120",  # _bwd_kernel_rc, called at :204
        case=_cfm_bwd_case),
    "mit_block_train": dict(
        # the six forward launches of the block, with the branch scales
        sources=["vss_cffm_tpu_torch/csrc/block_gemm.cu", "vss_cffm_tpu_torch/csrc/attention.cu",
                 "vss_cffm_tpu_torch/csrc/dwconv.cu"],
        replaces="vss_cffm_tpu/ops/stage_block.py:321",  # _train_fwd_kernel, called at :672
        case=_block_train_case),
    "mit_block_train_bwd": dict(
        # fifteen launches: input-gradient GEMMs, depthwise / LayerNorm passes,
        # the attention backward, the row-reduction GEMMs
        sources=["vss_cffm_tpu_torch/csrc/sra_attention_bwd.cu",
                 "vss_cffm_tpu_torch/csrc/block_bwd.cu", "vss_cffm_tpu_torch/csrc/gemm_tn.cu",
                 "vss_cffm_tpu_torch/csrc/block_gemm.cu"],
        replaces="vss_cffm_tpu/ops/stage_block.py:369",  # _train_bwd_kernel, called at :732
        case=_block_train_bwd_case),
    # the forward kernels of the inference path, held again at the train
    # shapes (the decoder's 162 windows at B·T = 8; the depthwise conv with
    # its z output at stage 4); their rows of the kernels line stay the
    # inference path's (KERNELS), with the tolerances stated there
    "cfm_attention": dict(rel_tol=2.0 ** -6, case=_cfm_case),
    "dwconv3x3": dict(rel_tol=2.0 ** -7, case=_dwconv_train_case),
}

FFN_KERNELS = {
    "block_ffn_train": dict(
        # launches 4-6 of the block's forward: fc1 with LN2, dwconv, fc2
        sources=["vss_cffm_tpu_torch/csrc/block_gemm.cu", "vss_cffm_tpu_torch/csrc/dwconv.cu"],
        # _kernel_ln with the branch scale, called by _block_ffn_fwd_scaled at :467
        replaces="vss_cffm_tpu/ops/mixffn.py:106",
        case=_ffn_train_case),
    "block_ffn_train_bwd": dict(
        # seven launches: the FFN half of the block's backward
        sources=["vss_cffm_tpu_torch/csrc/block_bwd.cu", "vss_cffm_tpu_torch/csrc/gemm_tn.cu",
                 "vss_cffm_tpu_torch/csrc/block_gemm.cu"],
        replaces="vss_cffm_tpu/ops/mixffn.py:313",  # _bwd_kernel_ln, called at :517
        case=_ffn_train_bwd_case),
}

# the block forms of training: train_block_impl, the kernels held at the
# form's inputs, launches per step, timed rounds
_SHARED = {"ce_upsampled_loss": 2, "ce_upsampled_loss_bwd": 2, "cfm_attention": 2,
           "cfm_attention_bwd": 2, "mit_block_fused": 0}
TRAIN_FORMS = {
    "train": dict(impl=("full", "full", "full", None), kernels=TRAIN_KERNELS,
                  per_step={**_SHARED, "mit_block_train": 6, "mit_block_train_bwd": 6,
                            "dwconv3x3": 2, "block_ffn_train": 0, "block_ffn_train_bwd": 0},
                  rounds=TRAIN_ROUNDS),
    "train_ffn": dict(impl=("ffn", "ffn", "ffn", None), kernels=FFN_KERNELS,
                      per_step={**_SHARED, "block_ffn_train": 6, "block_ffn_train_bwd": 6,
                                "dwconv3x3": 2, "mit_block_train": 0, "mit_block_train_bwd": 0},
                      rounds=1),
    "train_composed": dict(impl=None, kernels={"dwconv3x3": TRAIN_KERNELS["dwconv3x3"]},
                           per_step={**_SHARED, "dwconv3x3": 8, "mit_block_train": 0,
                                     "mit_block_train_bwd": 0, "block_ffn_train": 0,
                                     "block_ffn_train_bwd": 0},
                           rounds=1),
}


def _capture_train_inputs(model, x, labels, force_loss, kernels: dict):
    """One plain forward/backward of the train step; the arguments of each
    kernel op in ``kernels`` at its call sites are recorded (copies): the CE
    and its backward, the CFM attention forward (first decoder block) and
    backward (both decoder blocks), the depthwise conv of each composed FFN
    (first block of the stage), and the block pairs of the first block of
    stages 1-3 with their output cotangents."""
    from vss_cffm_tpu_torch.models import losses, set_force

    # the modules (the package's names cfm_attention etc. are the ops)
    ce_upsampled = importlib.import_module("vss_cffm_tpu_torch.ops.ce_upsampled")
    cfm_attention = importlib.import_module("vss_cffm_tpu_torch.ops.cfm_attention")
    mit = importlib.import_module("vss_cffm_tpu_torch.models.mit")

    caught = {name: [] for name in kernels}
    copy = lambda a: a.detach().clone() if isinstance(a, torch.Tensor) else a

    def recorder(name, fn, nargs, extra=()):
        def wrapped(*a, **kw):
            caught[name].append(tuple(copy(t) for t in a[:nargs])
                                + tuple(kw.get(k, d) for k, d in extra))
            return fn(*a, **kw)
        return wrapped

    def pair_recorder(names, fn, split):
        """Record (inputs, the rest, output cotangent) of a block pair."""
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            rec = [tuple(copy(t) for t in a[:split]),
                   {k: v for k, v in kw.items() if k != "force"} or a[split], None]
            out.register_hook(lambda g: rec.__setitem__(2, g.detach().clone()))
            for n in names:
                caught[n].append(rec)
            return out
        return wrapped

    patches = [(losses, "ce_upsampled_loss", recorder(
                   "ce_upsampled_loss", losses.ce_upsampled_loss, 4, (("count_acc", True),))),
               (ce_upsampled, "ce_upsampled_loss_bwd", recorder(
                   "ce_upsampled_loss_bwd", ce_upsampled.ce_upsampled_loss_bwd, 5)),
               (cfm_attention, "cfm_attention_bwd", recorder(
                   "cfm_attention_bwd", cfm_attention.cfm_attention_bwd, 7)),
               (mit, "mit_block_train", pair_recorder(
                   ("mit_block_train", "mit_block_train_bwd"), mit.mit_block_train, 19)),
               (mit, "block_ffn_train", pair_recorder(
                   ("block_ffn_train", "block_ffn_train_bwd"), mit.block_ffn_train, 10))]
    patches = [pt for pt in patches if pt[1] in caught]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patches]
    hooks = []
    if "dwconv3x3" in caught:
        hooks = [getattr(model.backbone, f"block{s}")[0].mlp.register_forward_pre_hook(
            lambda mod, a: caught["dwconv3x3"].append(tuple(copy(t)
                                                            for t in mod.dwconv_args(a[0]))))
            for s in range(1, 5)]

    def attention_inputs(mod, a):
        q, ks, vs, bias, mask, nh = mod.attention_inputs(*a)
        caught["cfm_attention"].append((copy(q), [copy(k) for k in ks], [copy(v) for v in vs],
                                        copy(bias), copy(mask), nh))

    if "cfm_attention" in caught:
        hooks.append(model.decode_head.decoder_focal.blocks[0].attn.register_forward_pre_hook(
            attention_inputs))
    set_force(model, "torch")
    try:
        for mod, attr, fn in patches:
            setattr(mod, attr, fn)
        model.zero_grad(set_to_none=True)
        out = model(x, train=True, generator=torch.Generator("cuda").manual_seed(SEED))
        force_loss(out, labels, force="torch")["loss_seg"].backward()
        torch.cuda.synchronize()
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
        for hk in hooks:
            hk.remove()
        set_force(model, None)
        model.zero_grad(set_to_none=True)
    # the block pairs: the first block of each of stages 1-3 (B1: 2 blocks a stage)
    depths = model.config.backbone_config.depths
    firsts = [sum(depths[:s]) for s in range(3)]
    for name in ("mit_block_train", "mit_block_train_bwd", "block_ffn_train",
                 "block_ffn_train_bwd"):
        if name in caught:
            caught[name] = [caught[name][i] for i in firsts]
    return caught


def _grad_agreement(model, x, labels, loss_of, form: str) -> None:
    """One forward/backward with the kernels and one on the plain path, same
    weights, batch and generator seed; the loss, each parameter's gradient
    (cosine) and the global norm are held, the worst parameter printed."""
    from vss_cffm_tpu_torch.models import set_force

    runs = {}
    for force in (None, "torch"):
        set_force(model, force)
        model.zero_grad(set_to_none=True)
        out = model(x, train=True, generator=torch.Generator("cuda").manual_seed(SEED))
        loss = loss_of(out, labels, force=force)["loss_seg"]
        loss.backward()
        runs[force] = (loss.item(), {n: p.grad.float().clone()
                                     for n, p in model.named_parameters()})
    set_force(model, None)
    model.zero_grad(set_to_none=True)
    (lk, gk), (lp, gp) = runs[None], runs["torch"]
    norms = {n: g.norm().item() for n, g in gp.items()}
    top = max(norms.values())
    cos = {n: torch.nn.functional.cosine_similarity(gk[n].reshape(-1), gp[n].reshape(-1),
                                                    dim=0).item()
           for n in gp if norms[n] >= 1e-3 * top}
    worst = min(cos, key=cos.get)
    flat_k = torch.cat([g.reshape(-1) for g in gk.values()])
    flat_p = torch.cat([g.reshape(-1) for g in gp.values()])
    nk, np_ = flat_k.norm().item(), flat_p.norm().item()
    total = torch.nn.functional.cosine_similarity(flat_k, flat_p, dim=0).item()
    print(f"[{form}] kernel vs plain path, one forward/backward: loss {lk:.6f} vs {lp:.6f} "
          f"(rel {abs(lk - lp) / abs(lp):.3e}); grad norm {nk:.6f} vs {np_:.6f} "
          f"(rel {abs(nk - np_) / np_:.3e}); cosine of all gradients {total:.6f}; worst of "
          f"{len(cos)} parameters with norm >= 1e-3 of the largest: {worst} cosine "
          f"{cos[worst]:.6f}; {len(gp) - len(cos)} smaller ones not held", flush=True)
    # bf16 activations through 8 blocks, the head and 2 decoder blocks, with
    # roundings at other points on the two paths: the loss and the gradient
    # norm within 1 %, every non-negligible gradient pointing the same way
    if not (abs(lk - lp) <= 1e-2 * abs(lp) and abs(nk - np_) <= 1e-2 * np_
            and total >= 0.999 and cos[worst] >= 0.99):
        raise RuntimeError("kernel-path gradients disagree with the plain path's")


def train_phase(apis, ops, opts, root, kind, smi, form: str) -> tuple[dict, dict]:
    """One block form of the train step (``TRAIN_FORMS``): kernel checks at its
    inputs, gradient agreement, the counted steps and the timed rounds.
    Returns (kernel stats, launch counts over TRAIN_COUNTED steps)."""
    import dataclasses

    from vss_cffm_tpu_torch.config import OptimConfig, build_model_config
    from vss_cffm_tpu_torch.models.losses import clip_ce_loss
    from vss_cffm_tpu_torch.train import TrainState, device_normalize, make_train_step

    spec = TRAIN_FORMS[form]
    cfg = dataclasses.replace(build_model_config("b1"), train_block_impl=spec["impl"])
    print(f"[{form}] train_block_impl={cfg.train_block_impl}", flush=True)
    bundle = apis.init_segmentor(cfg, device="cuda", dtype=torch.bfloat16, seed=SEED)
    model = bundle.model.train()
    rng = np.random.RandomState(SEED + 1)
    shape = (TRAIN_B, TRAIN_T, TRAIN_HW, TRAIN_HW)
    imgs = torch.from_numpy(rng.randint(0, 256, (*shape, 3), dtype=np.uint8)).cuda()
    labels = rng.randint(0, NUM_CLASSES, shape).astype(np.uint8)
    labels[rng.rand(*shape) < 0.05] = 255
    batch = {"imgs": imgs, "labels": torch.from_numpy(labels).cuda()}
    x = device_normalize(imgs, torch.bfloat16)

    caught = _capture_train_inputs(model, x, batch["labels"], clip_ce_loss, spec["kernels"])
    stats = check_kernels(ops, caught, spec["kernels"], opts.profile)
    del caught
    _grad_agreement(model, x, batch["labels"], clip_ce_loss, form)

    state = TrainState.create(model, OptimConfig())
    step = make_train_step(model, state.optimizer, state.scheduler)
    gen = torch.Generator("cuda").manual_seed(SEED)
    step(batch, gen)                                     # warm-up (cuDNN, allocator)
    torch.cuda.synchronize()
    ops.reset_launches()
    metrics = [step(batch, gen) for _ in range(TRAIN_COUNTED)]
    torch.cuda.synchronize()
    counts = ops.launches()
    print(f"[{form}] launches over {TRAIN_COUNTED} steps: {counts}", flush=True)
    for name, n in spec["per_step"].items():
        if counts[name] != n * TRAIN_COUNTED:
            raise RuntimeError(f"{form} step: {name} launched {counts[name]} times, expected "
                               f"{n} x {TRAIN_COUNTED}")
    for m in metrics:
        vals = {k: v.item() for k, v in m.items()}
        print(f"[{form}] step metrics: {vals}", flush=True)
        if not all(np.isfinite(v) for v in vals.values()):
            raise RuntimeError(f"non-finite train metrics {vals}")

    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for _ in range(spec["rounds"]):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        for _ in range(TRAIN_STEPS):
            step(batch, gen)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - ts) * 1e3 / TRAIN_STEPS)
    med = float(np.median(step_ms))
    frames = TRAIN_B * TRAIN_T
    print(f"[{form}] CFFM-B1 480x480 B={TRAIN_B} clip-{TRAIN_T} bf16 train step "
          f"(train_block_impl={spec['impl']}): {med:.3f} ms, median of {spec['rounds']} "
          f"round(s) of {TRAIN_STEPS} steps ({', '.join(f'{t:.3f}' for t in step_ms)}); "
          f"{1e3 * frames / med:.3f} train frames/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB", flush=True)
    if opts.profile:
        fname = "profile_" + ("train" if form == "train" else form) + ".txt"
        _profile(lambda: step(batch, gen), f"one train step ({form})", fname, root, kind, smi)
    del bundle, model, state, step
    torch.cuda.empty_cache()
    return stats, counts


def _profile(fn, what: str, fname: str, root: str, kind: str, smi: str) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    # device events only, as the table's own "Self CUDA time total" sums them
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation) / 1e3
    n_launch = sum(e.count for e in events if e.key in ("cudaLaunchKernel",
                                                         "cuLaunchKernelEx",
                                                         "cuLaunchKernel"))
    n_copy = sum(e.count for e in events if e.key == "aten::_to_copy")
    print(f"[profile] {what}: device busy {busy:.3f} ms, {n_launch} kernel launches, "
          f"{n_copy} aten::_to_copy calls (dtype or device copies)", flush=True)
    table = events.table(sort_by="cuda_time_total", row_limit=120)
    os.makedirs(os.path.join(root, "chiprun_out"), exist_ok=True)
    with open(os.path.join(root, "chiprun_out", fname), "w") as fh:
        fh.write(f"{kind} | {smi}\n{table}\n")
    print("\n".join(table.splitlines()[:25]), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also write a device-time table by kernel to chiprun_out/")
    opts = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from vss_cffm_tpu_torch import apis, ops
    from vss_cffm_tpu_torch.models import set_force
    from vss_cffm_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()

    # ---- 1. device -----------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = _smi()
    print(f"[device] {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | python {sys.version.split()[0]}", flush=True)

    # ---- 2. build --------------------------------------------------------------
    tb = time.perf_counter()
    _build.build_all()
    for name in _build.SOURCES:
        _build.library(name)
    print(f"[build] {len(_build.SOURCES)} sources in {time.perf_counter() - tb:.1f} s",
          flush=True)

    # ---- model and synthetic clips -------------------------------------------
    bundle = apis.init_segmentor("b1", device="cuda", dtype=torch.bfloat16, seed=SEED)
    model = bundle.model
    rng = np.random.RandomState(SEED)
    clips = [[rng.randint(0, 256, (480, 480, 3), dtype=np.uint8) for _ in range(4)]
             for _ in range(CLIPS)]

    # ---- 3. kernels at the main path's inputs --------------------------------
    x0, _ = apis._prepare_clip(bundle, clips[0])
    caught = _capture_main_path_inputs(model, x0.to(torch.float32))
    kernel_stats = check_kernels(ops, caught, KERNELS, opts.profile)

    # ---- 4. the main path ----------------------------------------------------
    cfg = bundle.config.backbone_config
    fused = [s for s in range(4) if (cfg.block_impl[s] if isinstance(cfg.block_impl, tuple)
                                     else cfg.block_impl) == "fused"]
    per_clip = {"mit_block_fused": sum(cfg.depths[s] for s in fused),
                "cfm_attention": bundle.config.head.decoder.depth,
                "dwconv3x3": sum(cfg.depths[s] for s in range(4) if s not in fused)}
    if per_clip != {"mit_block_fused": 4, "cfm_attention": 2, "dwconv3x3": 4}:
        raise RuntimeError(f"unexpected B1 launch plan {per_clip}")
    apis.inference_segmentor(bundle, clips[0])          # warm-up (cuDNN, allocator)
    torch.cuda.synchronize()
    ops.reset_launches()
    masks = [apis.inference_segmentor(bundle, c) for c in clips]
    torch.cuda.synchronize()
    counts = ops.launches()
    print(f"[main] launches over {CLIPS} clips: {counts}", flush=True)
    for name, n in per_clip.items():
        if counts[name] != n * CLIPS:
            raise RuntimeError(f"{name}: {counts[name]} launches, expected {n} x {CLIPS}")
    for m in masks:
        if tuple(m.shape) != (480, 480) or m.dtype != torch.int64:
            raise RuntimeError(f"mask of shape {tuple(m.shape)} {m.dtype}")
        if int(m.min()) < 0 or int(m.max()) >= bundle.config.head.num_classes:
            raise RuntimeError("mask class out of range")

    logits, _ = apis.clip_logits(bundle, clips[0])
    set_force(model, "torch")
    ref, _ = apis.clip_logits(bundle, clips[0])
    ref_mask = apis.inference_segmentor(bundle, clips[0])
    set_force(model, None)
    if not torch.isfinite(logits.float()).all():
        raise RuntimeError("non-finite logits")
    err = (logits.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    agree = (masks[0] == ref_mask).float().mean().item()
    # bf16 end to end through 16 blocks with rounding at different points on the
    # two paths: logits agree within 5% of the largest logit
    print(f"[main] logits {tuple(logits.shape)} kernel vs plain on the card: "
          f"max_abs_err={err:.3e} max|ref|={scale:.3e} mask agreement={agree:.5f}", flush=True)
    if err > 0.05 * scale:
        raise RuntimeError(f"main-path logits disagree with the plain path: {err} > "
                           f"{0.05 * scale}")

    # ROUNDS rounds of TIMED_CLIPS clips, each round timed on the host clock
    # up to a synchronize: the loop is host-bound, so the spread between
    # rounds is printed along with the median
    torch.cuda.reset_peak_memory_stats()
    rates = []
    for _ in range(ROUNDS):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        for i in range(TIMED_CLIPS):
            apis.inference_segmentor(bundle, clips[i % CLIPS])
        torch.cuda.synchronize()
        rates.append(TIMED_CLIPS / (time.perf_counter() - ts))
    fps = float(np.median(rates))
    peak = torch.cuda.max_memory_allocated() / 2**20
    print(f"[main] CFFM-B1 480x480 clip-4 bf16: {fps:.3f} frames/s, median of {ROUNDS} rounds "
          f"of {TIMED_CLIPS} clips ({', '.join(f'{x:.3f}' for x in rates)}); "
          f"{1e3 / fps:.3f} ms per clip, {4 * fps:.3f} input frames/s; peak memory "
          f"{peak:.1f} MiB; host: {os.cpu_count()} cores, load average "
          f"{os.getloadavg()[0]:.2f}, {torch.get_num_threads()} torch threads", flush=True)

    if opts.profile:
        _profile(lambda: apis.inference_segmentor(bundle, clips[1]), "one clip", "profile.txt",
                 root, kind, smi)
    del bundle, model, caught
    torch.cuda.empty_cache()

    # ---- 5. the train step, in each block form ------------------------------
    train_stats, train_counts = {}, {}
    for form in TRAIN_FORMS:
        train_stats[form], train_counts[form] = train_phase(apis, ops, opts, root, kind, smi, form)

    # ---- 6. result lines -----------------------------------------------------
    # launches: each kernel's count on its own path (the inference clips for
    # the inference kernels, the counted steps of the default train form for
    # the train ones, of the "ffn" form for the block-FFN pair);
    # launches_by_path gives every path's
    kernels = []
    rows = [(n, spec, kernel_stats[n], "inference") for n, spec in KERNELS.items()]
    rows += [(n, spec, train_stats[form][n], form) for form in TRAIN_FORMS
             for n, spec in TRAIN_FORMS[form]["kernels"].items() if "sources" in spec]
    for name, spec, st, path in rows:
        by_path = {"inference": counts[name], **{f: c[name] for f, c in train_counts.items()}}
        kernels.append({"name": name, "route": "cuda", "source": spec["sources"][0],
                        "sources": spec["sources"],
                        "replaces": spec["replaces"], "launches": by_path[path], "path": path,
                        "launches_by_path": by_path,
                        "max_abs_err": st["max_abs_err"], "ms": st["ms"],
                        "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
                        "bound_by": st["bound_by"], "library_ms": st["library_ms"],
                        "device_ms": st["device_ms"]})
    print(f"[done] {time.perf_counter() - t0:.1f} s; kernels checked: "
          f"{', '.join(k['name'] for k in kernels)}", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
