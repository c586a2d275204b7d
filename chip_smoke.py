#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Drives the port's main path, CFFM-B1 clip inference (4 frames of 480×480 in,
one refined target-frame mask out), through ``init_segmentor`` and
``inference_segmentor``, with random weights drawn from a fixed seed.

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
  5. one JSON line of kernels, the ``nvidia-smi`` line, and the final
     ``{"ok": true, "device": {...}}`` line.

``--profile`` adds, for one clip, the device busy time, the number of kernel
launches and of ``aten::_to_copy`` calls, and a torch.profiler table of device
time by kernel, written to ``chiprun_out/profile.txt``.

Per-kernel times in the JSON line are per call, averaged over the kernel's
calls in one clip (each main-path shape weighted by its calls); the per-shape
times are printed above it.
"""

from __future__ import annotations

import argparse
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
CLIPS = 3
TIMED_CLIPS = 10
ROUNDS = 3
SEED = 0


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


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if isinstance(t, torch.Tensor))


def _bound_ms(nbytes: float, tensor_ops: float, f32_ops: float) -> tuple[float, str]:
    """The tensor cores and the f32 units run at the same time, so each sets
    its own floor; the bound is the largest of the three."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(tensor_ops / BF16_TENSOR_FLOPS, f32_ops / F32_FLOPS)
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


@torch.inference_mode()
def check_kernels(ops, caught) -> dict:
    results = {}
    for name, spec in KERNELS.items():
        per_shape = []
        for args in caught[name]:
            case = spec["case"](ops, args)
            got = case["call"]("kernel")
            want = case["call"]("torch")
            torch.cuda.synchronize()
            if not torch.isfinite(got.float()).all():
                raise RuntimeError(f"{name}: non-finite kernel output at {case['shape']}")
            err = (got.float() - want.float()).abs().max().item()
            scale = want.float().abs().max().item()
            tol = spec["rel_tol"] * max(scale, 1e-3)
            print(f"[kernel] {name} {case['shape']}: max_abs_err={err:.3e} "
                  f"rel={err / max(scale, 1e-30):.3e} tol={tol:.3e}", flush=True)
            if err > tol:
                raise RuntimeError(f"{name}: kernel disagrees with its plain version "
                                   f"({err} > {tol}) at {case['shape']}")
            for step, s_err, s_tol in case["steps"]() if "steps" in case else ():
                print(f"[kernel] {name} {case['shape']} step {step}: max_abs_err={s_err:.3e} "
                      f"tol={s_tol:.3e}", flush=True)
                if not s_err <= s_tol:
                    raise RuntimeError(f"{name}: step {step} disagrees with its plain "
                                       f"version ({s_err} > {s_tol}) at {case['shape']}")
            ms = _time_ms(lambda: case["call"]("kernel"))
            plain_ms = _time_ms(lambda: case["call"]("torch"))
            lib_ms = _time_ms(case["library"]) if case["library"] is not None else None
            bound_ms, bound_by = case["bound"]
            print(f"[kernel] {name} {case['shape']}: ms={ms:.4f} plain_ms={plain_ms:.4f} "
                  f"library_ms={lib_ms} bound_ms={bound_ms:.4f} ({bound_by})", flush=True)
            per_shape.append(dict(shape=case["shape"], err=err, ms=ms, plain_ms=plain_ms,
                                  library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by))
        n = len(per_shape)
        mean = lambda k: sum(p[k] for p in per_shape) / n
        lib = None if per_shape[0]["library_ms"] is None else mean("library_ms")
        by = max(per_shape, key=lambda p: p["bound_ms"])["bound_by"]
        results[name] = dict(max_abs_err=max(p["err"] for p in per_shape), ms=mean("ms"),
                             plain_ms=mean("plain_ms"), bound_ms=mean("bound_ms"),
                             bound_by=by, library_ms=lib)
    return results


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
    kernel_stats = check_kernels(ops, caught)

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
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            apis.inference_segmentor(bundle, clips[1])
            torch.cuda.synchronize()
        events = prof.key_averages()
        # device events only, as the table's own "Self CUDA time total" sums them
        busy = sum(e.self_device_time_total for e in events
                   if e.device_type == DeviceType.CUDA and not e.is_user_annotation) / 1e3
        n_launch = sum(e.count for e in events if e.key in ("cudaLaunchKernel",
                                                             "cuLaunchKernelEx",
                                                             "cuLaunchKernel"))
        n_copy = sum(e.count for e in events if e.key == "aten::_to_copy")
        print(f"[profile] one clip: device busy {busy:.3f} ms, {n_launch} kernel launches, "
              f"{n_copy} aten::_to_copy calls (dtype or device copies)", flush=True)
        table = events.table(sort_by="cuda_time_total", row_limit=40)
        os.makedirs(os.path.join(root, "chiprun_out"), exist_ok=True)
        with open(os.path.join(root, "chiprun_out", "profile.txt"), "w") as fh:
            fh.write(f"{kind} | {smi}\n{table}\n")
        print("\n".join(table.splitlines()[:25]), flush=True)

    # ---- 5. result lines -----------------------------------------------------
    kernels = []
    for name, spec in KERNELS.items():
        st = kernel_stats[name]
        kernels.append({"name": name, "route": "cuda", "source": spec["sources"][0],
                        "sources": spec["sources"],
                        "replaces": spec["replaces"], "launches": counts[name],
                        "max_abs_err": st["max_abs_err"], "ms": st["ms"],
                        "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
                        "bound_by": st["bound_by"], "library_ms": st["library_ms"]})
    print(f"[done] {time.perf_counter() - t0:.1f} s; kernels checked: "
          f"{', '.join(KERNELS)}", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
