#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Drives the port's paths with random weights drawn from a fixed seed:
CFFM-B1 clip inference (4 frames of 480×480 in, one refined target-frame
mask out) through ``init_segmentor`` and ``inference_segmentor``, by
default and with ``dwconv_impl="fused"`` (the FFN half of the stage-1 and
stage-4 blocks through ``block_ffn_fused``), then CFFM-B1 train steps (2
clips of 4 frames, 480×480, bf16 compute, f32 parameters) through
``TrainState`` and ``make_train_step``, in the three block forms of
training: the default ``train_block_impl=("full", "full", "full", None)``
(the whole-block train pair at stages 1-3), "ffn" (the block-FFN pair) and
None (composed blocks), in a fourth form, "ohem": the default blocks
with the head's loss configured for OHEM and class weights (the per-pixel CE
pair ``ce_upsampled_nll``), and in a fifth, "train_probs": the default
blocks with the CFM attention's backward from the forward's saved
probabilities (``ops.cfm_attention._BWD = "kernel"``, f32 probabilities);
then the CE microbench (``vss_cffm_tpu_torch.tools.bench_ce``) with the
four label-layout variants of the CE loss pair.

Phases (any failure raises and exits non-zero; nothing is caught):
  1. the device: name, ``nvidia-smi`` name and power limit, torch and CUDA,
     the SM clock (``[clocks]``, again after the train phase);
  2. build every kernel from ``vss_cffm_tpu_torch/csrc`` (one nvcc per
     source, all at once), timed; for the two attention kernels, what
     ``ptxas -v`` reported per instance (registers, stack and spill bytes)
     and the blocks one SM holds at the main path's shapes
     (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``);
  3. each kernel at the main path's own inputs (captured from one forward of
     the plain path), in bf16: kernel against its plain PyTorch version on the
     card (max abs error, stated tolerance), then CUDA-event times of the
     kernel, the plain version and, where one PyTorch call computes the same
     function, that call (``library_ms``, and kernel/library beside it);
     ``bound_ms`` is the least time the card could take, the largest of
     bytes / 3.35 TB/s, tensor ops / 989 TFLOP/s and f32 ops / 67 TFLOP/s
     (H100 SXM data-sheet peaks); the whole block is also held step by
     step: each of its four launches (q, ctx, y and the FFN launch, alone
     and with the residual y) against its plain steps, at a tolerance
     relative to that step's own output;
  4. the main path: launch counts set to 0, CLIPS synthetic uint8 clips through
     ``inference_segmentor``, counts read and held to 4 / 2 / 4 per clip
     (whole block / CFM attention / depthwise conv); logits against the same
     model under ``force="torch"`` on the card;
  4b. the fused-FFN path (a second bundle, ``dwconv_impl="fused"``, the same
     weights): the inputs of ``block_ffn_fused`` (its launch alone and with
     the residual, then its whole output) and of ``mixffn_fused`` (LN2 of
     the same blocks) captured at stages 1 and 4 from one plain forward and
     held against their plain versions; ``[ffn]``: the FFN half of rows 1
     (stages 2, 3) and 8 (stages 1, 4), and row 9 (``mixffn_fused`` at
     stages 1, 4: the same launch without its LayerNorm), as one launch
     against the three launches it replaced, in the order new, old, old,
     new, device µs queued behind a sleep, beside its bound, two runs
     bitwise equal (``ffn_phase``); CLIPS clips with the counts held to
     4 / 4 / 2 / 0 per clip (whole block / fused FFN / CFM attention /
     depthwise conv), the logits against ``force="torch"``; then
     ``mixffn_fused``'s own path, ``MixFFN.forward`` in eval mode at the
     stage-1 and stage-4 inputs (the segmentor never calls it: the block
     takes ``block_ffn_fused`` first), its launches counted there; then
     end-to-end frames/s of both paths, ROUNDS rounds of TIMED_CLIPS clips
     each, alternating (default, fused, fused, default, ...), every round
     printed, the median of each, and peak memory;
  4c. ``[eval]``: CFFM-B1 evaluation of a synthetic 32-frame 480x853 video
     (network at 480x864, ``eval_phase``): rows 1-3 at the inputs of one
     plain forward there, the key-tiled attention at TTA's key counts (920,
     1269, 2048; bitwise against the resident one at 405), the streamed
     evaluation (launches held per target frame, logits against the plain
     path and the clip path, the confusion's total), the clip and streamed
     masks (held in f32 with the plain ops), eval frames/s of both, slide
     and TTA on 2 frames each (TTA's key-tiled launches held);
  4d. ``[image]``: SegFormer-B0 (``configs/segformer_b0_image.py``: MiT-B0
     32/64/160/256, head 256 wide, 124 classes) through ``init_segmentor``
     from its config, on ``[eval]``'s video one frame an item (network at
     480x864, ``image_phase``): rows 1 and 3 at the inputs of one plain
     forward there (B0's channel counts), ``inference_segmentor`` on one
     frame against ``force="torch"``, the whole-mode ``ClipEvaluator`` with
     each target frame's launches held (4 / 0 / 4) and the confusion's
     total, eval frames/s and device busy a target frame, slide on 2 frames,
     and a streamed evaluator refused;
  5. the train phase, once per block form (``TRAIN_FORMS``): a synthetic
     uint8 batch (2, 4, 480, 480, 3) with labels in [0, 124), ~5 % ignored
     (255); the inputs of the form's kernels captured from one plain
     forward/backward (with the output cotangent of each block pair), and
     each held against its plain version as in 3: in the default form the
     CE forward and backward at N 8 and N 2, the CFM attention forward and
     backward at 162 windows (the backward also at its first 81, beside
     its library call), the depthwise conv at stage 4 and the
     whole-block train pair at stages 1-3, forward (its four launches step
     by step: q, ctx, y and the FFN half as one launch with the branch
     scale) and backward (each output of the FFN half's launch, its dW2,
     dW1, then the attention half's six launches step by step, then its 17
     outputs each at its own scale); in "ffn" the block-FFN pair likewise
     (its forward launch, and its backward launch's outputs, dW2, dW1);
     ``[ffn_train]`` in both (``ffn_train_phase``): the FFN half at stages
     1-3 as the new launches against the three + six they replaced, new,
     old, old, new, device µs queued, beside its bound, two runs bitwise
     equal, and in the default form rows 6 and 7 whole on both routes;
     composed, the depthwise conv with its pre-activation output at the
     four stages; in "ohem" the per-pixel CE pair at N 8 and N 2 (nll, lse,
     pred, and dlogits from row 13's own kernel, ``csrc/ce_nll_bwd.cu``)
     and the share of valid pixels that OHEM kept (near 1
     at thresh 0.7 with random weights), then the OHEM path (rows 12, 13,
     the sort and the threshold) against the plain path on the same
     branches with a margin added to the label class at half the pixels,
     so that the mask keeps 25-75 % of them; in "train_probs" the CFM
     attention forward with its
     probabilities output and the backward from them (then again from the
     same probabilities in bf16), and the size of the probabilities held
     from the forward to the backward; the gradients of one forward/backward with the kernels
     against the plain path's on the same weights, batch and generator;
     then, with the counts set to 0, TRAIN_COUNTED train steps, the counts
     held to the form's launches per step and a finite loss; then ms per
     step, train frames/s (B·T frames per step) over the form's rounds of
     TRAIN_STEPS steps, every round printed, and peak memory;
  5a. ``[native]`` (``native_phase``): the port's native data path
     (``vss_cffm_tpu_torch/native``) built by g++ on the card's host (build
     time, the codec headers found, the codecs built, the core count), then
     on a VSPW train tree written to disk with PIL (2 videos of 24 JPEG
     frames of 480x853, PNG masks, ``train.txt``): the native train item
     against the numpy route (the library patched away in this process) for
     seeds 0-7 bit for bit, ``normalize`` False and True, and the native JPEG
     and PNG decodes against PIL's where the codecs are built; host ms a
     clip on one thread on each route; the loader's clips/s with 4 workers,
     threads on the numpy route, threads native and processes native, in
     alternating rounds; the train CLI on the tree (B1 config, batch 2, 14
     steps with the CLI's profiler window; the second pair 10 steps
     untraced) on the native and the numpy route, ABBA: launches a step held
     to the default plan, metrics finite, host ms a step, device busy and
     idle share;
  5b. ``[train_cli]``: the train CLI (``vss_cffm_tpu_torch.tools.train``) from
     ``vss_cffm_tpu_torch/configs/cffm_b1_vspw_160k.py`` at full B1 widths,
     batch 2, on an in-memory VSPW train set (2 videos of 24 frames of
     480x853 through the real train transforms, crops of 480x480): the
     loader's clips/s with 4 workers; run A (2 steps) and run B (resumed
     from A's checkpoint to step 4) with the launches per step held to the
     default form's plan, the metrics finite, the resumed lr equal to the
     schedule's, checkpoints 2 and 4 holding the config; a run of 14 steps
     with the CLI's profiler window (host ms a step, device busy a step);
     step 5 with and without the decoder remat (``use_checkpoint``), row 2
     launched 4 and 2 times, held as the train forms' gradients are;
  5c. ``[cffm_pp]``: CFFM++-B1 at full width. Phase A: a random CFFM-B1
     checkpoint (``.pth``), then ``tools.generate_prototypes.run`` from
     ``configs/cffm_b1_vspw_gene_prototype.py`` over the two ``[train_cli]``
     videos and the ``[eval]`` video (10 frames each at 480x864, 100
     centres, 10 iterations): launches held (4 / 0 / 4 a video), the card's
     k-means against the CPU's from the same initial indices (labels on
     ≥ 99.9 %, centres within 1e-3 of the largest), the written centres
     against the card's k-means, ms a video of the features and of the
     k-means. Phase B: ``tools.train`` on
     ``configs/cffm_b1_vspw_finetune_40k.py`` (batch 2, no warmup, 14
     steps) ``--load-from`` that checkpoint: launches a step held to the
     finetune plan (row 6 6, row 3 2, rows 14 and 17 2 each, nothing else),
     every frozen weight at w·Π(1 − lr_t·wd) or w by its group (2^-23), the
     fuse BN's statistics as loaded, the cluster branch moved; host ms and
     device busy a step. Evaluation with the store, streamed and per clip
     on the ``[eval]`` video: each target frame's launches (4 / 2 / 4),
     streamed logits against the clip path's and ``force="torch"`` within
     5 %, eval frames/s, device busy a target frame (always profiled);
  5d. ``[test_cli]``: ``tools.test.main`` as a user runs it, on VSPW trees
     written to disk with PIL (2 videos of 10 JPEG frames of 480x853 with PNG
     masks; one video of 2 frames): the CFFM-B1 config on ``[train_cli]``'s
     checkpoint directory, ``--streaming --vc --out m.json`` and per clip,
     each confusion equal to the direct evaluator's, VC8 finite; the
     CFFM++-B1 finetune config on ``[cffm_pp]``'s checkpoint and cluster
     directory with ``--aug-test`` on the 2-frame video (rows 1, 1′, 2, 3
     launches held); the SegFormer-B0 config on a random ``.pth`` with
     ``--format-only --show`` (a PNG and an overlay a frame); host ms a
     frame of each run (``test_cli_phase``). The artefacts of 5b and 5c are
     kept for it and for 5e in one temporary directory, removed at the end;
  5e. ``[dist]``: CFFM-B1 (``configs/cffm_b1_vspw_160k.py``, 480x480 crops,
     global batch 2, bf16, drop path and head dropout 0.1) over several
     processes (``dist_phase``): 2 default train steps in a group of one
     NCCL rank here and on 2 gloo ranks pinned to ``cuda:0``
     (``parallel.spawn``: processes started by ``spawn``, importing this
     file and the port only), each on its rows of a fixed batch whose two
     clips differ in brightness and contrast, against the one-process
     steps on the whole batch (loss and the fuse BN's running statistics
     within 1e-3, gradient norm 2e-3, cosine of the parameter deltas
     ≥ 0.999, every rank's launches a step), then the same steps on the 2
     ranks with the BN on each rank's own moments, which that check must
     reject; host ms a step, the gradient all-reduce's ms and bytes, peak
     memory a rank; then, started together, ``tools/dist_train.sh`` for 2
     CLI steps with 1 NCCL rank and with 2 gloo ranks on ``cuda:0`` (one
     checkpoint, each ``iter`` line once) and ``tools/dist_test.sh`` with 2
     gloo ranks, streamed (JSON metrics equal to 5d's one-process CLI's)
     and per clip (the ranks' pickled masks hold every frame, their
     confusion equal to 5d's). On the same 2 ranks: (e) a clip's frames
     split over them (``parallel.create_clip_mesh(2)``, 2 of the 4 frames a
     rank, the fused features gathered over the frames group): eval logits
     within 5 % of the one process's largest logit, launches a clip 4 / 2 /
     4 on each rank, and the 2 default steps held as above; (f) 2 steps with
     the Lovász loss (data 2: each rank its clip, the loss of the global
     batch on each) held as above against one process; host ms a step and
     peak memory a rank;
  6. the CE microbench: ``bench_ce.main`` at N 8 (the step's frames) with
     the counts set to 0 before it and held after (each of its six kernels
     launched warm-up + timed times), then each of the six kernels held
     against its plain version at the bench's inputs at N 8 and N 2, timed
     as in 3;
  5f. ``[tools]`` (``tools_phase``): ``benchmark.py`` at CFFM-B1 480x864 (50
     clips), ``--streaming`` and ``--train`` (batch 2, 10 steps), each with
     its launches held per clip, frame and step; ``profile_forward.py``
     (B1 480x480, 10 clips: its top 30 kernels name rows 1-3);
     ``get_flops.py``; ``benchmark_loader.py`` (10 batches of 480x853
     JPEGs); ``publish_model.py`` on 5b's checkpoint and the test CLI on the
     published one (5d's per-clip confusion, exactly); ``bf16_dynamics.py``
     (B0 64x64, 60 steps each run: finite, the last 20 losses' mean below
     the first 10's);
  5g. ``[export]`` (``export_phase``): ``tools/export.py``'s ``main`` with
     ``--verify`` on CFFM-B1 at full widths (``configs/cffm_b1_vspw_160k.py``,
     a random ``.pth`` from SEED), a 480x480 clip of 4 frames in bf16: the
     graph's ``vss_cffm::`` ops and the live and reloaded launches held to
     4 / 2 / 4 (rows 1 / 2 / 3); a process that imports only
     ``vss_cffm_tpu_torch.ops`` reloads the ``.pt2`` and runs the clip
     (launches 4 / 2 / 4, no model module imported, logits within 1e-3 of
     the live forward's largest, bitwise equality printed); host ms a clip
     of the program against the live forward in alternating rounds; one
     clip of each under torch.profiler (device busy, the ``aten::_to_copy``
     casts' calls and device ms); the host µs of a ``dwconv3x3`` call
     through its custom op against the bare launch function (launch
     replaced by nothing); then ``[dropout]``: one default train step of B1
     with MiT ``drop_rate`` = ``attn_drop_rate`` = decoder ``drop`` =
     ``attn_drop`` = 0.1, twice from the same weights and generator seed
     (finite, rows 6 / 7 and 2 / 4 not launched, dwconv3x3 8, the same
     loss);
  7. one JSON line of kernels (``launches_by_path`` with each path's counts,
     ``dist_rank0`` / ``dist_rank1`` the ranks' launches over 5e's steps,
     ``dist_frames*`` / ``dist_lovasz*`` over (e) and (f), ``tools_*`` over
     5f's runs, ``export_reloaded`` over 5g's reloaded clip,
     ``dropout_step`` over its first step and ``native_cli`` over 5a's
     first native CLI run),
     the ``nvidia-smi`` line, and the final ``{"ok": true, "device": {...}}``
     line.

``--profile`` adds, for one clip of each inference path and for one train
step of each form, the device busy time, the number of kernel launches and
of ``aten::_to_copy`` calls, and a torch.profiler table of device time by
kernel, written to ``chiprun_out/profile{,_ffn}.txt`` and
``chiprun_out/profile_train{,_ffn,_composed,_ohem,_probs}.txt``.
From the default step's table it prints ``[row6]`` and ``[row7]`` lines (each
of the two rows' kernels by name: launches, ms a step, µs a launch; the block
pair's GEMM runs as a Fwd and a Bwd instance); then ``[row14]`` lines (rows 14
and 12 alone at N 8 and N 2: device µs, exp bound and its share, the library
calls' µs, a digest of the output), ``[row16]`` and ``[row18]`` lines (the
phase-layout forwards on row 14's kernel, alike), ``[row17]`` lines (rows 17
and 13 alone at N 8 and N 2: device µs, exp bound, recompute factor; row 13
on its own kernel and plan),
``[row15]`` and ``[row19]`` lines (the
phase-layout backwards on row 17's kernel, alike) and
``[gemm]`` lines (every block_gemm launch of a default step and a clip: device
µs, bytes bound, share of 3.35 TB/s, torch.matmul's µs on the same operands).

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
import contextlib
import dataclasses
import importlib
import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
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


def _smi(query: str = "name,power.limit") -> str:
    r = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def _clocks(when: str) -> None:
    """The SM clock, its maximum, power draw and temperature: compute-bound
    kernels move with the clock between calls."""
    print(f"[clocks] {when}: "
          f"{_smi('clocks.sm,clocks.max.sm,power.draw,temperature.gpu')}", flush=True)


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
    torch.profiler traces them, over iters (``--profile`` only); the larger of
    two such windows, as the profiler now and then drops a window's events
    (some or all of them: a kernel then read half its time, or 0)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best = 0.0
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        best = max(best, sum(e.self_device_time_total for e in prof.key_averages()
                             if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
                   / 1e3 / iters)
    return best


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
                bound=bound, library=library, shape=f"x{tuple(x.shape)}",
                host_us=lambda: _dwconv_host_us(ops, x, k, b))


def _dwconv_host_us(ops, x, k, b, calls: int = 2000) -> float:
    """Host µs of one ``dwconv3x3`` call with the kernel's launch replaced by
    nothing: the wrapper with the C entry's no-launch twin in its place
    (same arguments, device check, no launch), on the host clock."""
    from vss_cffm_tpu_torch.ops import _build

    dw = importlib.import_module("vss_cffm_tpu_torch.ops.dwconv")
    real, count = dw._c_entry(), ops.dwconv3x3.launches
    dw._entry["dwconv3x3_nhwc"] = _build.library("dwconv").dwconv3x3_nhwc_nolaunch
    try:
        for _ in range(50):
            ops.dwconv3x3(x, k, b, gelu=True)
        torch.cuda.synchronize()
        ts = time.perf_counter()
        for _ in range(calls):
            ops.dwconv3x3(x, k, b, gelu=True)
        us = (time.perf_counter() - ts) * 1e6 / calls
    finally:
        dw._entry["dwconv3x3_nhwc"] = real
        ops.dwconv3x3.launches = count  # nothing was launched
    return us


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
    """One plain forward of the target frame's logits; pre-hooks record each
    kernel's arguments at its main-path call sites (stage-1/-4 FFNs,
    stage-2/-3 blocks, and a clip model's decoder block)."""
    from vss_cffm_tpu_torch.models import set_force
    from vss_cffm_tpu_torch.models.segmentor import target_logits

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
    if model.config.arch == "cffm":
        attn = model.decode_head.decoder_focal.blocks[0].attn
        hooks.append(attn.register_forward_pre_hook(
            lambda mod, a: caught["cfm_attention"].append(mod.attention_inputs(*a))))
    set_force(model, "torch")
    try:
        with torch.inference_mode():
            target_logits(model, clip)
    finally:
        set_force(model, None)
        for hk in hooks:
            hk.remove()
    return caught


KERNELS = {
    "mit_block_fused": dict(
        # four launches of three sources (five where the FFN plan splits its
        # hidden channels): GEMM (q, proj), attention, the FFN half in one
        # launch (ffn_fused, hid and a on chip)
        sources=["vss_cffm_tpu_torch/csrc/ffn_fused.cu", "vss_cffm_tpu_torch/csrc/block_gemm.cu",
                 "vss_cffm_tpu_torch/csrc/attention.cu"],
        replaces="vss_cffm_tpu/ops/stage_block.py:106",  # _kernel of mit_block_fused
        # bf16 q, ctx and GELU output are rounded at the same points on both
        # sides, but from f32 sums taken in other orders (mma.sync vs cuBLAS), so
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


def _ffn_fused_case(ops, rec):
    """Row 8: x + FFN(LN2 x) at a captured block's inputs."""
    args, eps = rec
    x, w1 = args[0], args[3]
    b, h, w, c = x.shape
    m, ch = b * h * w, w1.shape[1]
    # fc1, fc2 on the tensor cores; depthwise + GELU, LayerNorm and residual
    bound = _bound_ms(_nbytes(*args) + x.numel() * 2, 2 * m * 2 * c * ch,
                      m * ch * 24 + m * c * 20)
    # out is bf16 at the residual's scale: the whole output is a sanity check
    # (2^-5 of its largest value); the launch is held alone (no residual) and
    # with the residual x at its own scales (block_ffn_fused_step_errors)
    return dict(call=lambda force: ops.block_ffn_fused(*args, eps, force=force), bound=bound,
                library=None, compare=lambda got, want: _compare_one(got, want, PAIR_REL),
                steps=lambda: ops.mixffn.block_ffn_fused_step_errors(*args, eps),
                shape=f"x{tuple(x.shape)} Ch={ch}")


def _mixffn_case(ops, args):
    """Row 9: fc1 → depthwise → GELU → fc2 at LN2 of a captured block's input."""
    x, w1 = args[0], args[1]
    b, h, w, c = x.shape
    m, ch = b * h * w, w1.shape[1]
    bound = _bound_ms(_nbytes(*args) + x.numel() * 2, 2 * m * 2 * c * ch, m * ch * 24)
    return dict(call=lambda force: ops.mixffn_fused(*args, force=force), bound=bound,
                library=None, shape=f"x{tuple(x.shape)} Ch={ch}")


FFN_INFER_KERNELS = {
    "block_ffn_fused": dict(
        # one launch (two where its plan splits the hidden channels): LN, fc1,
        # the depthwise conv + GELU and fc2 with hid and a on chip
        sources=["vss_cffm_tpu_torch/csrc/ffn_fused.cu"],
        # block_ffn_fused, whose pallas_call (:179) runs _kernel_ln (:106) without a scale
        replaces="vss_cffm_tpu/ops/mixffn.py:165",
        case=_ffn_fused_case),
    "mixffn_fused": dict(
        # the same launch without the LayerNorm prologue and the residual
        sources=["vss_cffm_tpu_torch/csrc/ffn_fused.cu"],
        replaces="vss_cffm_tpu/ops/mixffn.py:62",  # _kernel, called by mixffn_fused at :234
        # no residual: bf16 a and out rounded at the same points from f32 sums
        # in other orders, one ulp carried through fc2: 2^-6 of the largest
        rel_tol=2.0 ** -6, case=_mixffn_case),
}


def _capture_ffn_inputs(model, clip):
    """One plain forward of the fused-FFN model; ``block_ffn_fused``'s
    arguments at the first block of stages 1 and 4, and the MixFFN input
    there (LN2 of the same x, in the compute dtype) with the MixFFN module."""
    from vss_cffm_tpu_torch.models import set_force
    from vss_cffm_tpu_torch.models.mit import layer_norm

    mit = importlib.import_module("vss_cffm_tpu_torch.models.mit")
    calls = []
    fn = mit.block_ffn_fused

    def recorder(*a, **kw):
        calls.append((tuple(t.detach().clone() for t in a[:9]), a[9]))
        return fn(*a, **kw)

    set_force(model, "torch")
    try:
        mit.block_ffn_fused = recorder
        with torch.inference_mode():
            model(clip)
    finally:
        mit.block_ffn_fused = fn
        set_force(model, None)
    depths = model.config.backbone_config.depths
    firsts = [0, depths[0]]                      # stage 1 and stage 4, first block each
    bb = model.backbone
    mlps = [getattr(bb, f"block{s}")[0] for s in (1, 4)]
    caught = {"block_ffn_fused": [calls[i] for i in firsts], "mixffn_fused": [], "mlp": []}
    with torch.inference_mode():
        for blk, (args, _) in zip(mlps, caught["block_ffn_fused"]):
            ln = layer_norm(args[0], blk.norm2, blk.compute_dtype)
            caught["mixffn_fused"].append((ln, *blk.mlp.fused_params()))
            caught["mlp"].append((blk.mlp, ln))
    return caught


# [ffn_train]'s records by form, for the kernels JSON line
FFN_TRAIN: dict = {}

# the FFN half alone against its plain steps, of the largest output: the
# launch's own bound (``stage_block.STEP_TOLERANCE["ffn + y (out)"]``)
FFN_REL = 2.0 ** -6
FFN_SLEEP_CYCLES = int(2e7)    # ~10 ms of the card's clock, longer than queuing the calls


def _queued_us(fn, iters: int = 20) -> float:
    """Device µs of one call of fn: ``iters`` calls queued behind a
    ``torch.cuda._sleep``, so that the host's launch cost is off the clock,
    between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(FFN_SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / iters


@torch.no_grad()
def ffn_phase(ops, caught: dict, caught_f: dict, smi: str) -> dict:
    """``[ffn]``: the FFN half of each main-path call of rows 1 (stages 2, 3:
    the f32 y from the block's own q, ctx, y launches, its residual) and 8
    (stages 1, 4 of the fused-FFN path: bf16 x), and row 9 (``mixffn_fused``
    at LN2 of the same stage 1, 4 blocks: no LayerNorm, no residual), as one
    launch (``ffn_fused``) against the three launches it replaced (fc1 with
    or without LN, dwconv, fc2 with or without the residual; the composed
    path keeps them), in the order new, old, old, new: device µs, the bound
    of the half's own work (inputs and weights read once, out written once;
    fc1 and fc2 on the tensor cores) and its share; the launch held against
    the plain steps at ``FFN_REL`` and two runs bitwise equal; for row 1 also
    the whole block on both routes (its q, ctx and y launches, then the FFN
    half), in the same order. Returns {row: [per shape]}."""
    sb, ff = ops.stage_block, ops.ffn_fused
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = []
    for args, kw in caught["mit_block_fused"]:
        kern = sb._block_steps(*args, **kw, kernel=True)
        attn = lambda kern=kern: kern["y"](kern["ctx"](kern["q"]()))
        y = attn()
        cases.append(("mit_block_fused", y.view(args[0].shape), y, args[9:17], kw["eps"], attn))
    for args, eps in caught_f["block_ffn_fused"]:
        x = args[0].contiguous()
        cases.append(("block_ffn_fused", x, x.view(-1, x.shape[-1]), args[1:9], eps, None))
    for mix in caught_f["mixffn_fused"]:  # no gamma, beta: the launch without its LayerNorm
        cases.append(("mixffn_fused", mix[0].contiguous(), None, (None, None, *mix[1:]), 0.0,
                      None))
    names = {"mit_block_fused": "row 1", "block_ffn_fused": "row 8", "mixffn_fused": "row 9"}
    out = {}
    for name, x, res, ffn, eps, attn in cases:
        b, h, w, c = x.shape
        m, ch = b * h * w, ffn[2].shape[1]
        plan = ff.ffn_fused_plan(b, h, w, c, ch, sms)
        new = lambda: ff.ffn_fused_launch(x, *ffn, eps, res, "ffn")
        old_steps = sb._ffn_fwd_steps(*ffn, None, eps, tuple(x.shape), torch.bfloat16, True, "ffn")
        plain = sb._ffn_fwd_steps(*ffn, None, eps, tuple(x.shape), torch.bfloat16, False, "ffn")
        rows = x.view(m, c)
        old = lambda: old_steps["out"](old_steps["a"](old_steps["hid"](rows)), res)
        got, again = new(), new()
        want = plain["out"](plain["a"](plain["hid"](rows)), res)
        err = (got.float() - want.float()).abs().max().item()
        tol = FFN_REL * want.float().abs().max().item()
        bitwise = torch.equal(got, again)
        ts = [_queued_us(new), _queued_us(old), _queued_us(old), _queued_us(new)]
        ln = ffn[0] is not None  # LayerNorm and residual: m c 20 more f32 operations
        bound_ms, by = _bound_ms(_nbytes(x, *ffn) + m * c * 2, 2 * m * c * ch * 2,
                                 m * ch * (18 + 1 + 5) + ln * m * c * 20)
        us, old_us = (ts[0] + ts[3]) / 2, (ts[1] + ts[2]) / 2
        row = names[name]
        block = ""
        if attn is not None:
            def block_new(attn=attn):
                yb = attn()
                return ff.ffn_fused_launch(yb.view(x.shape), *ffn, eps, yb, "ffn")

            def block_old(attn=attn):
                yb = attn()
                return old_steps["out"](old_steps["a"](old_steps["hid"](yb)), yb)

            tb = [_queued_us(block_new), _queued_us(block_old), _queued_us(block_old),
                  _queued_us(block_new)]
            block_us, block_old_us = (tb[0] + tb[3]) / 2, (tb[1] + tb[2]) / 2
            block = (f"; the whole block: q, ctx, y and one launch {tb[0]:.1f} / {tb[3]:.1f} "
                     f"device us, with the three launches {tb[1]:.1f} / {tb[2]:.1f}")
        print(f"[ffn] {row} x{tuple(x.shape)} {str(x.dtype)[6:]} Ch={ch} plan=(rows {plan.rows}, "
              f"cols {plan.cols}, hc {plan.hc}, splits {plan.splits}, {plan.smem} B smem): "
              f"one launch {ts[0]:.1f} / {ts[3]:.1f} device us, three launches {ts[1]:.1f} / "
              f"{ts[2]:.1f} (new, old, old, new, queued behind a sleep){block}; bound "
              f"{bound_ms * 1e3:.1f} us ({by}), share {bound_ms * 1e3 / us:.3f}; "
              f"max_abs_err={err:.3e} tol={tol:.3e} (2^-6 of the largest output), two runs "
              f"bitwise equal: {bitwise} | {smi}", flush=True)
        if not err <= tol or not bitwise:
            raise RuntimeError(f"[ffn] {row} at x{tuple(x.shape)}: err {err} > {tol} or two "
                               f"runs differ ({bitwise})")
        rec = dict(shape=f"x{tuple(x.shape)} Ch={ch}", device_us=us, three_launch_us=old_us,
                   bound_us=bound_ms * 1e3, bound_by=by, splits=plan.splits)
        if attn is not None:
            rec.update(block_device_us=block_us, block_parent_device_us=block_old_us)
        out.setdefault(name, []).append(rec)
    return out


def _abba_us(new, old) -> tuple[list, float, float]:
    """Device µs of new and old, queued, in the order new, old, old, new:
    (the four times, new's mean, old's mean)."""
    ts = [_queued_us(new), _queued_us(old), _queued_us(old), _queued_us(new)]
    return ts, (ts[0] + ts[3]) / 2, (ts[1] + ts[2]) / 2


def _bitwise(fn) -> bool:
    """Two calls of fn give the same bits (a tensor or a dict of them)."""
    a, b = fn(), fn()
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return all(torch.equal(a[k], b[k]) for k in a if isinstance(a[k], torch.Tensor))


@torch.no_grad()
def ffn_train_phase(ops, caught: dict, form: str, smi: str) -> list:
    """``[ffn_train]``: the train pairs' FFN half at each captured stage of the
    step (the first block of stages 1-3): in the "ffn" form the pair's own
    input x (rows 10 and 11), in the default form the whole block's f32 y from
    its own q, ctx, y launches (the FFN half of rows 6 and 7, whose backward
    also writes d_attn). The forward as one launch with the branch scale
    (``ffn_fused``) against the three launches it replaced (fc1 with LN2,
    dwconv, fc2 with the scale and residual), and the backward as one launch
    and its dW2, dW1 reductions (``ffn_bwd_steps``) against the six it
    replaced (``ffn_bwd_unfused_steps``, from the three launches' hid and
    a), each pair timed new, old, old, new (device µs queued behind a sleep),
    beside the bound of the half's own work and its share; in the default
    form also rows 6 and 7 whole on both routes, in the same order. Each new
    launch runs twice bitwise equal, the forward held against the plain steps
    at FFN_REL. Returns one record a stage."""
    sb, ff = ops.stage_block, ops.ffn_fused
    out = []
    full = form == "train"
    for rec in caught["mit_block_train" if full else "block_ffn_train"]:
        if full:
            args, kw, go = rec
            ins, s_attn, s_ffn = args[:17], args[17], args[18]
            eps, ffn = kw["eps"], ins[9:17]
            kern = sb._block_steps(*ins, **kw, kernel=True, s_attn=s_attn, s_ffn=s_ffn,
                                   op="ffn_train")
            acts = sb._run(kern, names=sb._ACTS)
            xin = acts["y"].view(ins[0].shape)
        else:
            args, eps, go = rec
            xin, ffn, s_ffn, s_attn = args[0].contiguous(), args[1:9], args[9], None
        b, h, w, c = xin.shape
        m, ch = b * h * w, ffn[2].shape[1]
        rows = xin.view(m, c)
        go_rows = go.contiguous().view(m, c)
        p = dict(shape=(b, h, w, c), dt=torch.bfloat16, g2=ffn[0], be2=ffn[1], w1=ffn[2],
                 b1=ffn[3], kdw=ffn[4], bdw=ffn[5], w2=ffn[6], s_ffn=s_ffn, s_attn=s_attn, eps=eps)
        old_f = sb._ffn_fwd_steps(*ffn, s_ffn, eps, (b, h, w, c), torch.bfloat16, True, "ffn_train")
        plain_f = sb._ffn_fwd_steps(*ffn, s_ffn, eps, (b, h, w, c), torch.bfloat16, False,
                                    "ffn_train")
        new_fwd = lambda: ff.ffn_fused_launch(xin, *ffn, eps, rows, "ffn_train", scale=s_ffn)
        old_fwd = lambda: old_f["out"](old_f["a"](old_f["hid"](rows)), rows)
        hid = old_f["hid"](rows)
        t = {"y": rows, "go": go_rows}
        t_old = dict(t, hid=hid, a=old_f["a"](hid))
        new_bwd = lambda: sb.run_steps(sb.ffn_bwd_steps(p, True, full, "ffn_train"), t)
        old_bwd = lambda: sb.run_steps(sb.ffn_bwd_unfused_steps(p, full, "ffn_train"), t_old)
        want = plain_f["out"](plain_f["a"](plain_f["hid"](rows)), rows)
        got = new_fwd()
        err = (got.float() - want.float()).abs().max().item()
        tol = FFN_REL * want.float().abs().max().item()
        bitwise = _bitwise(new_fwd) and _bitwise(new_bwd)
        tf, fwd_us, fwd_old = _abba_us(new_fwd, old_fwd)
        tb, bwd_us, bwd_old = _abba_us(new_bwd, old_bwd)
        # the half's own work: the forward's fc1, fc2 (tensor cores), the
        # depthwise + GELU and LayerNorm (f32); the backward's five products
        # (fc1 recomputed, d_a, d_ln, dW2, dW1), GELU′ exps; inputs, weights
        # and outputs moved once
        grads = sum(t_.numel() * 4 for t_ in ffn[:7])
        fb_ms, fby = _bound_ms(_nbytes(xin, *ffn) + m * c * 2, 2 * m * c * ch * 2,
                               m * ch * 24 + m * c * 20)
        bb_ms, bby = _bound_ms(_nbytes(xin, go_rows, *ffn[:7]) + m * c * (4 if full else 2)
                               + (m * c * 2 if full else 0) + grads, 2 * m * 5 * c * ch,
                               m * ch * 64 + m * c * 40, m * ch)
        fplan = ff.ffn_fused_plan(b, h, w, c, ch, torch.cuda.get_device_properties(0)
                                  .multi_processor_count)
        bplan = ops.ffn_bwd.ffn_bwd_plan(b, h, w, c, ch, torch.cuda.get_device_properties(0)
                                         .multi_processor_count)
        row = "rows 6, 7 (FFN half)" if full else "rows 10, 11"
        whole = ""
        r = dict(shape=f"x{tuple(xin.shape)} Ch={ch}", row=row, fwd_us=fwd_us,
                 fwd_parent_us=fwd_old, bwd_us=bwd_us, bwd_parent_us=bwd_old,
                 fwd_bound_us=fb_ms * 1e3, bwd_bound_us=bb_ms * 1e3)
        if full:
            pb = dict(zip(sb._INPUTS, ins[:16]), shape=(b, h, w, c), dt=torch.bfloat16,
                      num_heads=kw["num_heads"], eps=eps, s_attn=s_attn, s_ffn=s_ffn)
            attn = lambda: kern["y"](kern["ctx"](kern["q"]()))
            table = sb.bwd_table(ins[0].contiguous(), go.contiguous(), acts)
            def row6_new():
                yb = attn()
                return ff.ffn_fused_launch(yb.view(xin.shape), *ffn, eps, yb, "ffn_train",
                                           scale=s_ffn)

            def row6_old():
                yb = attn()
                return old_f["out"](old_f["a"](old_f["hid"](yb)), yb)

            r6 = _abba_us(row6_new, row6_old)
            r7 = _abba_us(
                lambda: sb.run_steps(sb._train_bwd_steps(pb, True, "ffn_train"), table),
                lambda: sb.run_steps(sb.ffn_bwd_unfused_steps(pb, True, "ffn_train")
                                     + sb._attn_bwd_steps(pb, True, "ffn_train"),
                                     dict(table, hid=t_old["hid"], a=t_old["a"])))
            r.update(row6_us=r6[1], row6_parent_us=r6[2], row7_us=r7[1], row7_parent_us=r7[2])
            whole = (f"; row 6 whole (q, ctx, y, then the half) {r6[0][0]:.1f} / {r6[0][3]:.1f} "
                     f"device us, with the three launches {r6[0][1]:.1f} / {r6[0][2]:.1f}; row 7 "
                     f"whole {r7[0][0]:.1f} / {r7[0][3]:.1f}, with the six {r7[0][1]:.1f} / "
                     f"{r7[0][2]:.1f}")
        print(f"[ffn_train] {row} x{tuple(xin.shape)} {str(xin.dtype)[6:]} Ch={ch} fwd plan "
              f"(rows {fplan.rows}, cols {fplan.cols}, hc {fplan.hc}, splits {fplan.splits}), "
              f"bwd plan (rows {bplan.rows}, cols {bplan.cols}, hc {bplan.hc}, splits "
              f"{bplan.splits}, {bplan.smem} B smem): forward one launch {tf[0]:.1f} / "
              f"{tf[3]:.1f} device us, three launches {tf[1]:.1f} / {tf[2]:.1f}, bound "
              f"{fb_ms * 1e3:.1f} us ({fby}), share {fb_ms * 1e3 / fwd_us:.3f}; backward one "
              f"launch + dW2, dW1 {tb[0]:.1f} / {tb[3]:.1f}, six launches {tb[1]:.1f} / "
              f"{tb[2]:.1f}, bound {bb_ms * 1e3:.1f} us ({bby}), share {bb_ms * 1e3 / bwd_us:.3f} "
              f"(new, old, old, new, queued behind a sleep){whole}; forward max_abs_err="
              f"{err:.3e} tol={tol:.3e} (2^-6 of the largest output), two runs of each new launch "
              f"bitwise equal: {bitwise} | {smi}", flush=True)
        if not err <= tol or not bitwise:
            raise RuntimeError(f"[ffn_train] {row} at x{tuple(xin.shape)}: err {err} > {tol} or "
                               f"two runs differ ({bitwise})")
        out.append(r)
    return out


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
                share = f"{err / tol:.3f} of it" if tol else "exact" if err == 0 else "inexact"
                print(f"[kernel] {name} {case['shape']} {label}: max_abs_err={err:.3e} "
                      f"tol={tol:.3e} ({share})", flush=True)
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
            if "host_us" in case:
                print(f"[kernel] {name} {case['shape']}: host_us={case['host_us']():.2f} per call "
                      f"with the launch replaced by nothing (wrapper, checks, allocation, "
                      f"ctypes call)", flush=True)
            bound_ms, bound_by = case["bound"]
            ratio = f" kernel/library={ms / lib_ms:.3f}" if lib_ms else ""
            print(f"[kernel] {name} {case['shape']}: ms={ms:.4f} plain_ms={plain_ms:.4f} "
                  f"library_ms={lib_ms}{ratio} bound_ms={bound_ms:.4f} ({bound_by}) "
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


def _ce_bwd_case(ops, args, out_bytes: int = 2):
    """dlogits, bf16 (row 17) or f32 (``out_bytes`` 4, rows 15, 19)."""
    logits, labels, g, s, img_w = args
    c = logits.shape[-1]
    exps = int(((labels >= 0) & (labels < c)).sum()) * c
    # per class of a valid pixel: lerps, softmax, the weighted adjoint (~16)
    bound = _bound_ms(_nbytes(logits, labels) + logits.numel() * out_bytes, 0, exps * 16, exps)
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


def _ce_nll_case(ops, args):
    """Row 12: the per-pixel maps nll, pred, lse at a captured branch."""
    logits, labels, s = args
    n, h, w, c = logits.shape
    pixels = labels.numel()
    # every pixel: C exps, two lerps, max, subtract, sum and the argmax (~10
    # per class); nll, pred and lse written, 12 B a pixel
    bound = _bound_ms(_nbytes(logits, labels) + 12 * pixels, 0, pixels * c * 10, pixels * c)
    f = torch.nn.functional
    lab = labels.long()

    def library():
        up = f.interpolate(logits.permute(0, 3, 1, 2).float(), size=tuple(labels.shape[1:]),
                           mode="bilinear", align_corners=False)
        return f.cross_entropy(up, lab, reduction="none", ignore_index=255)

    def compare(got, want):
        # nll and lse: f32 from the same bf16 inputs, the lerp rounded as
        # F.interpolate rounds it and sums in other orders: 1e-5 of the
        # largest; pred: a pixel whose two largest upsampled logits lie
        # within that rounding may pick either (ties of equal bf16 inputs are
        # exact on both sides): agreement on >= 99.99 % of the pixels
        out = [(label, *_compare_one(a, b, 1e-5)[0][1:])
               for label, a, b in (("nll", got[0], want[0]), ("lse", got[2], want[2]))]
        disagree = (got[1] != want[1]).float().mean().item()
        return out + [("pred (share of pixels disagreeing)", disagree, 1e-4)]

    return dict(call=lambda force: ops.ce_upsampled_nll(logits, labels, s, force=force),
                bound=bound, library=library, compare=compare,
                shape=f"logits{tuple(logits.shape)} s={s}")


def _ce_nll_bwd_case(ops, args):
    """Row 13: dlogits for a captured per-pixel cotangent, from the plain lse."""
    logits, labels, lse, g, s = args
    c = logits.shape[-1]
    live = int((g != 0).sum())
    # the pixels whose cotangent is not 0: C exps, lerps, the weighted
    # adjoint (~16 per class); logits, labels, lse, g read, dlogits written
    bound = _bound_ms(_nbytes(logits, labels, lse, g) + logits.numel() * 2, 0, live * c * 16,
                      live * c)
    f = torch.nn.functional
    x = logits.detach().clone().requires_grad_(True)
    lab = labels.long()
    with torch.enable_grad():
        up = f.interpolate(x.permute(0, 3, 1, 2).float(), size=tuple(labels.shape[1:]),
                           mode="bilinear", align_corners=False)
        nll = f.cross_entropy(up, lab, reduction="none", ignore_index=255)
    gf = g.float()
    library = lambda: torch.autograd.grad(nll, x, gf, retain_graph=True)
    return dict(call=lambda force: ops.ce_upsampled_nll_bwd(logits, labels, lse, g, s,
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


def _cfm_probs_case(ops, args):
    """Row 2's :357 call: the forward that also writes p (nW, nh, 49, N)."""
    q, ks, vs, bias, mask, nh = args
    nw, area, c = q.shape
    n = sum(k.shape[1] for k in ks)
    hd = c // nh
    pdt = importlib.import_module("vss_cffm_tpu_torch.ops.cfm_attention")._probs_dtype(q)
    p_bytes = nw * nh * area * n * torch.empty((), dtype=pdt).element_size()
    bound = _bound_ms(_nbytes(q, *ks, *vs, bias, mask) + q.numel() * 2 + p_bytes,
                      2 * 2 * nw * nh * area * n * hd, nw * nh * area * n * 5,
                      nw * nh * area * n)

    def compare(got, want):
        # out: as row 2's :372 call, 2^-6 of its largest value; p: f32
        # softmaxes of the same bf16 inputs with the scores summed in other
        # orders (wmma against an f32 matmul), moving p by p times a few f32
        # ulps of the scores: 2^-14 of the largest p
        return [("out", *_compare_one(got[0], want[0], 2.0 ** -6)[0][1:]),
                ("probs", *_compare_one(got[1], want[1], 2.0 ** -14)[0][1:])]

    # library: none, no one PyTorch call returns the probabilities with the
    # output (SDPA's forward is row 2's yardstick)
    return dict(call=lambda force: ops.cfm_attention_probs(q, ks, vs, bias, mask, nh,
                                                           force=force),
                bound=bound, library=None, compare=compare,
                shape=f"q{tuple(q.shape)} N={n} nh={nh} probs {str(pdt).split('.')[-1]}")


def _cfm_bwd_probs_case(ops, args):
    """Row 5: the backward from the forward's p, held again with p in bf16."""
    q, k, v, probs, g, nh = args
    nw, area, c = q.shape
    n, hd = k.shape[1], c // nh
    pairs = nw * nh * area * n
    # four products (dP, dV, dq, dK), ~8 f32 ops per score, no exps; p read
    bound = _bound_ms(_nbytes(q, k, v, g, probs) + _nbytes(q, k, v) + nh * area * n * 4,
                      4 * 2 * pairs * hd, 8 * pairs)
    rels = (2.0 ** -6,) * 3 + (2.0 ** -10,)

    def compare(got, want):
        # as row 4's: dq, dK, dV 2^-6, dbias 2^-10 of each one's largest value
        return (_held_outputs(("dq", "dk", "dv"), got[:3], want[:3], rels[0])
                + _held_outputs(("dbias",), got[3:], want[3:], rels[3]))

    def bf16_probs():
        pb = probs.to(torch.bfloat16)
        got = ops.cfm_attention_bwd_probs(q, k, v, pb, g, nh, force="kernel")
        want = ops.cfm_attention_bwd_probs(q, k, v, pb, g, nh, force="torch")
        torch.cuda.synchronize()
        return [(f"bf16 probs {label}", e, t) for label, e, t in compare(got, want)]

    # library: none, no PyTorch call takes saved probabilities (SDPA's
    # backward, row 4's yardstick, recomputes them from q, K, bias and mask)
    return dict(call=lambda force: ops.cfm_attention_bwd_probs(q, k, v, probs, g, nh,
                                                               force=force),
                bound=bound, library=None, compare=compare, steps=bf16_probs,
                shape=f"q{tuple(q.shape)} N={n} nh={nh} probs {str(probs.dtype).split('.')[-1]}")


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
    # value), the four launches are held one by one at their own scales
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
    """Row 11: the block-FFN train backward, recomputed from x (the forward
    keeps nothing else)."""
    args, eps, go = rec
    ins, scale = args[:8], args[9]
    x, w1 = args[0], args[3]
    b, h, w, c = x.shape
    m, ch = b * h * w, w1.shape[1]
    mx = ops.mixffn
    grad_bytes = sum(t.numel() * 4 for t in ins[1:])
    # the TPU kernel's products: fc1 (recompute), d_a, d_ln, dW2, dW1; GELU′ exps
    bound = _bound_ms(_nbytes(*ins, go) + x.numel() * 2 + grad_bytes, 2 * m * 5 * c * ch,
                      m * ch * 64 + m * c * 40, m * ch)
    return dict(call=lambda force: mx.block_ffn_train_bwd(*ins, scale, go, eps, force=force),
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
        # four forward launches (five where the FFN plan splits): q, ctx, y,
        # then the FFN half in one launch with the branch scale
        sources=["vss_cffm_tpu_torch/csrc/block_gemm.cu", "vss_cffm_tpu_torch/csrc/attention.cu",
                 "vss_cffm_tpu_torch/csrc/ffn_fused.cu"],
        replaces="vss_cffm_tpu/ops/stage_block.py:321",  # _train_fwd_kernel, called at :672
        case=_block_train_case),
    "mit_block_train_bwd": dict(
        # nine launches (ten where the FFN plan splits): the FFN half in one
        # launch with hid, z, d_a, d_z and d_ln on chip, its dW2, dW1 row
        # reductions; the attention half's input-gradient GEMMs, attention
        # backward with dK and dV, LN1 backward and dWproj, dWq
        sources=["vss_cffm_tpu_torch/csrc/ffn_bwd.cu",
                 "vss_cffm_tpu_torch/csrc/sra_attention_bwd.cu",
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
        # one launch (two where its plan splits): LN2, fc1, the depthwise conv
        # + GELU and fc2 with hid and a on chip, the branch scale, the residual
        sources=["vss_cffm_tpu_torch/csrc/ffn_fused.cu"],
        # _kernel_ln with the branch scale, called by _block_ffn_fwd_scaled at :467
        replaces="vss_cffm_tpu/ops/mixffn.py:106",
        case=_ffn_train_case),
    "block_ffn_train_bwd": dict(
        # three launches (four where its plan splits): the backward with hid,
        # z, d_a, d_z and d_ln on chip, then dW2 and dW1 on gemm_tn
        sources=["vss_cffm_tpu_torch/csrc/ffn_bwd.cu", "vss_cffm_tpu_torch/csrc/gemm_tn.cu"],
        replaces="vss_cffm_tpu/ops/mixffn.py:313",  # _bwd_kernel_ln, called at :517
        case=_ffn_train_bwd_case),
}

OHEM_KERNELS = {
    "ce_upsampled_nll": dict(
        sources=["vss_cffm_tpu_torch/csrc/ce_upsampled.cu"],
        replaces="vss_cffm_tpu/ops/ce_upsampled.py:106",  # _fwd_kernel, called at :171
        case=_ce_nll_case),
    "ce_upsampled_nll_bwd": dict(
        # a kernel of its own: a warp a pixel, the g = 0 pixels skipped
        sources=["vss_cffm_tpu_torch/csrc/ce_nll_bwd.cu"],
        replaces="vss_cffm_tpu/ops/ce_upsampled.py:192",  # _bwd_kernel, called at :337
        # bf16 dlogits, one rounding of f32 sums in other orders: one ulp
        rel_tol=2.0 ** -7, case=_ce_nll_bwd_case),
}

PROBS_KERNELS = {
    "cfm_attention_probs": dict(
        sources=["vss_cffm_tpu_torch/csrc/attention.cu"],
        # _fwd_kernel, called with probabilities by _cfm_attention_pallas_impl :357
        replaces="vss_cffm_tpu/ops/cfm_attention.py:81",
        counter="cfm_attention",  # the same kernel with its probabilities output
        case=_cfm_probs_case),
    "cfm_attention_bwd_probs": dict(
        sources=["vss_cffm_tpu_torch/csrc/attention_bwd.cu"],
        replaces="vss_cffm_tpu/ops/cfm_attention.py:250",  # _bwd_kernel, called at :400
        case=_cfm_bwd_probs_case),
}

# the "ohem" form's loss: OHEM at the reference sampler's defaults and class
# weights in [0.5, 1.5] drawn from SEED
OHEM_LOSS = dict(use_ohem=True, ohem_thresh=0.7, ohem_min_kept=100000,
                 class_weight=tuple(float(v) for v in
                                    np.random.RandomState(SEED).uniform(0.5, 1.5, NUM_CLASSES)))

# the block forms of training: train_block_impl, the kernels held at the
# form's inputs, launches per step, timed rounds (and the head's loss)
_SHARED = {"ce_upsampled_loss": 2, "ce_upsampled_loss_bwd": 2, "cfm_attention": 2,
           "cfm_attention_bwd": 2, "cfm_attention_bwd_probs": 0, "mit_block_fused": 0,
           "ce_upsampled_nll": 0, "ce_upsampled_nll_bwd": 0, "block_ffn_fused": 0,
           "mixffn_fused": 0, "ce_bwd_loss_v2": 0, "ce_fwd_loss_v5": 0, "ce_fwd_loss_v3": 0,
           "ce_bwd_loss_v3": 0}
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
    "train_ohem": dict(impl=("full", "full", "full", None), kernels=OHEM_KERNELS, loss=OHEM_LOSS,
                       per_step={**_SHARED, "ce_upsampled_loss": 0, "ce_upsampled_loss_bwd": 0,
                                 "ce_upsampled_nll": 2, "ce_upsampled_nll_bwd": 2,
                                 "mit_block_train": 6, "mit_block_train_bwd": 6, "dwconv3x3": 2,
                                 "block_ffn_train": 0, "block_ffn_train_bwd": 0},
                       rounds=1),
    # the CFM attention backward from the forward's f32 probabilities
    "train_probs": dict(impl=("full", "full", "full", None), kernels=PROBS_KERNELS,
                        cfm_bwd=("kernel", torch.float32),
                        per_step={**_SHARED, "cfm_attention_bwd": 0,
                                  "cfm_attention_bwd_probs": 2, "mit_block_train": 6,
                                  "mit_block_train_bwd": 6, "dwconv3x3": 2,
                                  "block_ffn_train": 0, "block_ffn_train_bwd": 0},
                        rounds=1),
}


@contextlib.contextmanager
def _cfm_switches(bwd: str, probs_dtype):
    """The CFM attention's module switches (``_BWD``, ``_PROBS_DTYPE``) for a form."""
    mod = importlib.import_module("vss_cffm_tpu_torch.ops.cfm_attention")
    saved = mod._BWD, mod._PROBS_DTYPE
    mod._BWD, mod._PROBS_DTYPE = bwd, probs_dtype
    try:
        yield
    finally:
        mod._BWD, mod._PROBS_DTYPE = saved


def _capture_train_inputs(model, x, labels, force_loss, kernels: dict):
    """One plain forward/backward of the train step; the arguments of each
    kernel op in ``kernels`` at its call sites are recorded (copies): the CE
    pair in use and its backward, the CFM attention forward (first decoder
    block; with or without probabilities) and backward (both decoder blocks;
    recomputing or from probabilities), the depthwise conv of each composed FFN
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
               (losses, "ce_upsampled_nll", recorder(
                   "ce_upsampled_nll", losses.ce_upsampled_nll, 3)),
               (ce_upsampled, "ce_upsampled_nll_bwd", recorder(
                   "ce_upsampled_nll_bwd", ce_upsampled.ce_upsampled_nll_bwd, 5)),
               (cfm_attention, "cfm_attention_bwd", recorder(
                   "cfm_attention_bwd", cfm_attention.cfm_attention_bwd, 7)),
               (cfm_attention, "cfm_attention_bwd_probs", recorder(
                   "cfm_attention_bwd_probs", cfm_attention.cfm_attention_bwd_probs, 6)),
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

    forwards = [key for key in ("cfm_attention", "cfm_attention_probs") if key in caught]

    def attention_inputs(mod, a):
        q, ks, vs, bias, mask, nh = mod.attention_inputs(*a)
        for key in forwards:
            caught[key].append((copy(q), [copy(k) for k in ks], [copy(v) for v in vs],
                                copy(bias), copy(mask), nh))

    if forwards:
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


def _ohem_bites(ops, logits, s: int) -> None:
    """The OHEM CUDA path (rows 12, 13, the sort and the k-th threshold) against
    the plain path with a mask that keeps 25-75 % of the valid pixels: the
    branch's logits plus a margin of 30 on the label class at half the
    low-resolution pixels (labels constant on each s x s block, 5 % ignored),
    so that those pixels are easy (p ≈ 1 > thresh) and the rest hard; min_kept
    · N stays below the hard share, so the threshold is thresh itself."""
    from vss_cffm_tpu_torch.models import losses

    n, h, w, c = logits.shape
    g = torch.Generator("cuda").manual_seed(SEED + 2)
    low = torch.randint(0, c, (n, h, w), generator=g, device="cuda")
    easy = torch.rand((n, h, w), generator=g, device="cuda") < 0.5
    lg = (logits.float() + 30.0 * torch.nn.functional.one_hot(low, c).float()
          * easy[..., None]).to(logits.dtype)
    lab = low.repeat_interleave(s, 1).repeat_interleave(s, 2)
    lab = torch.where(torch.rand(lab.shape, generator=g, device="cuda") < 0.05, 255,
                      lab).to(torch.uint8)
    cw = torch.tensor(OHEM_LOSS["class_weight"], device="cuda")
    r = losses.ohem_path_errors(lg, lab, s, OHEM_LOSS["ohem_thresh"], OHEM_LOSS["ohem_min_kept"],
                                cw)
    (lk, lp), (dk, dp) = r["loss"], r["dlogits"]
    d_err = (dk.float() - dp.float()).abs().max().item()
    d_tol = 2.0 ** -7 * dp.float().abs().max().item()
    print(f"[ohem] N={n} crafted margin: OHEM kept {r['kept']:.6f} of the {r['valid']} valid "
          f"pixels (plain path {r['kept_plain']:.6f}), kept flags differing "
          f"{r['flag_differs']}; loss {lk:.8f} vs {lp:.8f} (rel {abs(lk - lp) / abs(lp):.3e}); "
          f"dlogits max_abs_err={d_err:.3e} tol={d_tol:.3e}", flush=True)
    # a pixel may flip only where its gt probability lies within an nll
    # rounding of the threshold (1e-5 of the valid pixels); the loss is a mean
    # of f32 nll computed in two orders (1e-4); dlogits bf16, one ulp (2^-7)
    if not (0.25 <= r["kept"] <= 0.75 and r["flag_differs"] <= 1e-5 * r["valid"]
            and abs(lk - lp) <= 1e-4 * abs(lp) and d_err <= d_tol):
        raise RuntimeError(f"OHEM path with a partial mask disagrees with the plain path: {r}")


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


def _synthetic_train_batch(seed: int) -> dict:
    """A (TRAIN_B, TRAIN_T, 480, 480) uint8 batch on the card, labels in
    [0, NUM_CLASSES) with ~5 % ignored (255)."""
    rng = np.random.RandomState(seed)
    shape = (TRAIN_B, TRAIN_T, TRAIN_HW, TRAIN_HW)
    imgs = torch.from_numpy(rng.randint(0, 256, (*shape, 3), dtype=np.uint8)).cuda()
    labels = rng.randint(0, NUM_CLASSES, shape).astype(np.uint8)
    labels[rng.rand(*shape) < 0.05] = 255
    return {"imgs": imgs, "labels": torch.from_numpy(labels).cuda()}


def train_phase(apis, ops, opts, root, kind, smi, form: str) -> tuple[dict, dict]:
    """One block form of the train step (``TRAIN_FORMS``): kernel checks at its
    inputs, gradient agreement, the counted steps and the timed rounds.
    Returns (kernel stats, launch counts over TRAIN_COUNTED steps)."""
    from vss_cffm_tpu_torch.config import LossConfig, OptimConfig, build_model_config
    from vss_cffm_tpu_torch.models import losses
    from vss_cffm_tpu_torch.train import TrainState, device_normalize, make_train_step

    spec = TRAIN_FORMS[form]
    cfg = build_model_config("b1")
    cfg = dataclasses.replace(cfg, train_block_impl=spec["impl"], head=dataclasses.replace(
        cfg.head, loss=LossConfig(**spec.get("loss", {}))))
    loss_of = losses.make_clip_loss(cfg.head.loss)
    print(f"[{form}] train_block_impl={cfg.train_block_impl} loss={cfg.head.loss}", flush=True)
    bundle = apis.init_segmentor(cfg, device="cuda", dtype=torch.bfloat16, seed=SEED)
    model = bundle.model.train()
    batch = _synthetic_train_batch(SEED + 1)
    x = device_normalize(batch["imgs"], torch.bfloat16)

    caught = _capture_train_inputs(model, x, batch["labels"], loss_of, spec["kernels"])
    for q, ks, _, _, _, nh in caught.get("cfm_attention_probs", ()):
        # p is held from each decoder block's forward to its backward
        n, nb = sum(k.shape[1] for k in ks), cfg.head.decoder.depth
        per_block = nh * q.shape[0] * q.shape[1] * n * 4
        print(f"[{form}] probabilities residual: nh={nh} nW={q.shape[0]} Lq={q.shape[1]} N={n}, "
              f"{per_block} B (f32) per decoder block, {nb * per_block} B for the {nb} blocks",
              flush=True)
    stats = check_kernels(ops, caught, spec["kernels"], opts.profile)
    if form in ("train", "train_ffn"):
        FFN_TRAIN[form] = ffn_train_phase(ops, caught, form, smi)
    if "cfm_attention_bwd" in caught:
        # row 4 also at inference's 81 windows, checked and timed beside its
        # library call (not part of the form's statistics)
        check_kernels(ops, {"cfm_attention_bwd": [_first_windows(a, a[0].shape[0] // 2)
                                                  for a in caught["cfm_attention_bwd"]]},
                      {"cfm_attention_bwd": spec["kernels"]["cfm_attention_bwd"]}, opts.profile)
    for logits, labels, s in caught.get("ce_upsampled_nll", ()):
        # the share of valid pixels the form's OHEM mask keeps, per branch
        with torch.no_grad():
            nll = ops.ce_upsampled_nll(logits, labels, s, force="torch")[0]
        valid = (labels.long() >= 0) & (labels.long() < NUM_CLASSES)
        kept = losses._ohem_from_gt_prob(torch.exp(-nll), valid, OHEM_LOSS["ohem_thresh"],
                                         OHEM_LOSS["ohem_min_kept"], logits.shape[0])
        print(f"[{form}] OHEM kept {kept.sum().item() / valid.sum().item():.6f} of the "
              f"{int(valid.sum())} valid pixels of the N={logits.shape[0]} branch (thresh "
              f"{OHEM_LOSS['ohem_thresh']}, min_kept {OHEM_LOSS['ohem_min_kept']}; near 1 with "
              f"random weights; the [ohem] check holds a mask that bites)", flush=True)
    for logits, _, s in caught.get("ce_upsampled_nll", ()):
        _ohem_bites(ops, logits, s)
    del caught
    _grad_agreement(model, x, batch["labels"], loss_of, form)

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


# ---- [train_cli]: the train CLI from the B1 config at VSPW's train geometry --

CLI_VIDEOS, CLI_FRAMES = 2, 24
CLI_HW = (480, 853)            # VSPW 480p frames; img_scale (853, 480), crops 480x480
CLI_OPTIONS = ["data.batch_size=2", "log_interval=1", "checkpoint_interval=2"]
CLI_LOADER_BATCHES = 8
CLI_PROFILE_STEPS = 14         # the CLI's --profile-dir traces iterations 10-13


def _synthetic_train_videos(seed: int):
    """CLI_VIDEOS videos of CLI_FRAMES frames of 480x853 uint8 BGR in memory, with
    the VSPW train dataset's interface (``VSPWVideoDataset``: its train sampler
    and the real train transforms; frames and labels read from memory): each
    video a pattern moving its own way, with noise; labels in [0, 124) over
    the pattern, ~5 % ignored (255)."""
    from vss_cffm_tpu_torch.data.vspw import VSPWVideoDataset

    class SyntheticTrainVideos(VSPWVideoDataset):
        def __init__(self):
            self.split, self.dilation = "train", [-9, -6, -3]
            self.crop_size, self.img_scale, self.flip_video = (480, 480), (853, 480), True
            self.reduce_zero, self.img_suffix, self.seg_suffix = True, ".jpg", ".png"
            self.videos = [f"synthetic_{v}" for v in range(CLI_VIDEOS)]
            names = [f"{i:08d}.jpg" for i in range(CLI_FRAMES)]
            self.frames = {v: names for v in self.videos}
            self.frame_index = [(v, f) for v in self.videos for f in names]
            rng = np.random.RandomState(seed)
            y, x = np.mgrid[0:CLI_HW[0], 0:CLI_HW[1]].astype(np.float32)
            self.imgs, self.labels = {}, {}
            for v, video in enumerate(self.videos):
                for t, name in enumerate(names):
                    xs, ys = x + (11.0 - 19 * v) * t, y + (5.0 * v - 6.0) * t
                    chans = [np.sin(xs / (37.0 + 9 * c + 5 * v)) * np.cos(ys / (53.0 - 7 * c))
                             for c in range(3)]
                    img = 128.0 + 90.0 * np.stack(chans, -1) + rng.randint(-20, 21, (*CLI_HW, 3))
                    self.imgs[video, name] = np.clip(img, 0, 255).astype(np.uint8)
                    lab = ((xs // (71 - 20 * v)).astype(np.int64)
                           + 13 * (ys // 59).astype(np.int64)) % NUM_CLASSES
                    lab[rng.rand(*CLI_HW) < 0.05] = 255
                    self.labels[video, name] = lab.astype(np.uint8)

        def read_frame(self, video, frame):
            return self.imgs[video, frame]

        def read_label(self, video, frame):
            return self.labels[video, frame]

    return SyntheticTrainVideos()


def _cli_launches_held(counts: dict, steps: int, what: str, plan: dict,
                       tag: str = "[train_cli]") -> None:
    print(f"{tag} {what}: launches over {steps} steps: {counts}", flush=True)
    for name, n in plan.items():
        if counts[name] != n * steps:
            raise RuntimeError(f"train CLI, {what}: {name} launched {counts[name]} times, "
                               f"expected {n} x {steps}")


def _cli_steps_held(out: dict, first: int, last: int, what: str) -> None:
    steps = [s["step"] for s in out["steps"]]
    if steps != list(range(first + 1, last + 1)) or out["state"].step != last:
        raise RuntimeError(f"train CLI, {what}: steps {steps}, state at {out['state'].step}; "
                           f"expected {first + 1}..{last}")
    for s in out["steps"]:
        print(f"[train_cli] {what} step {s['step']}: loss_seg {s['loss_seg']:.6f} acc_seg "
              f"{s['acc_seg']:.4f} grad_norm {s['grad_norm']:.6f} lr {s['lr']:.6e}", flush=True)
        if not all(np.isfinite(s[k]) for k in ("loss_seg", "acc_seg", "grad_norm")):
            raise RuntimeError(f"train CLI, {what}: non-finite metrics {s}")


def _cli_checkpoint_held(ckpt_dir: str, step: int, cfg) -> None:
    meta_path = os.path.join(ckpt_dir, f"metadata_{step}.json")
    if not (os.path.exists(os.path.join(ckpt_dir, f"ckpt_{step}.pt"))
            and os.path.exists(meta_path)):
        raise RuntimeError(f"train CLI: no checkpoint at step {step} in {ckpt_dir}")
    with open(meta_path) as fh:
        meta = json.load(fh)
    if (meta["config"]["model"]["backbone"] != cfg.model.backbone
            or meta["config"]["optim"]["max_iters"] != step
            or len(meta["classes"]) != NUM_CLASSES):
        raise RuntimeError(f"train CLI: the metadata of step {step} does not hold the config")


def train_cli_phase(ops, root: str, smi: str, work_root: str) -> tuple[dict, str]:
    """``[train_cli]``: ``tools.train`` from ``configs/cffm_b1_vspw_160k.py`` at
    full B1 widths (``CLI_OPTIONS``: batch 2, a log line a step, a checkpoint
    every 2) on an in-memory VSPW train set (2 videos of 24 frames of 480x853:
    the real transforms at VSPW's geometry, crops of 480x480): the loader's
    clips/s with the config's 4 workers; run A, 2 steps; run B, resumed from
    A's checkpoints to step 4 (the schedule's lr at step 2); launches per step
    held to the default train form's plan, metrics finite, checkpoints 2 and 4
    with the config; a profiled run of CLI_PROFILE_STEPS steps (host ms a
    step, device busy a step over the CLI's traced iterations); then step 5
    with and without the decoder remat from B's checkpoint, same batch and
    generator seed: row 2 launched 4 times with remat, loss, gradient norm and
    gradients held as the train forms hold theirs. Everything is written
    under ``work_root``. Returns runs A and B's launch counts and the
    checkpoint directory of runs A and B (its latest step 4), which
    ``[test_cli]`` evaluates."""

    from vss_cffm_tpu_torch.config import apply_overrides, load_config
    from vss_cffm_tpu_torch.data import TrainLoader
    from vss_cffm_tpu_torch.data.loader import _sample_rng
    from vss_cffm_tpu_torch.tools import train as train_cli
    from vss_cffm_tpu_torch.train import poly_schedule

    path = os.path.join(root, "vss_cffm_tpu_torch", "configs", "cffm_b1_vspw_160k.py")
    base = apply_overrides(load_config(path), CLI_OPTIONS)
    if base.model.backbone != "mit_b1" or base.model.head.decoder.depth != 2:
        raise RuntimeError(f"[train_cli] the B1 config gave {base.model.backbone}")
    t0 = time.perf_counter()
    ds = _synthetic_train_videos(SEED + 5)
    print(f"[train_cli] {path}, options {CLI_OPTIONS}: {base.model.backbone} widths "
          f"{base.model.backbone_config.embed_dims}, decoder depth {base.model.head.decoder.depth}; "
          f"dataset {len(ds)} videos of {CLI_FRAMES} frames of {CLI_HW[0]}x{CLI_HW[1]}, "
          f"img_scale {ds.img_scale}, crop {ds.crop_size} (made in "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)

    # the loader alone: one item on the caller's thread, then clips/s with the
    # config's workers, batches copied to the card
    t0 = time.perf_counter()
    for i in range(4):
        ds.get_train_item(i % len(ds), _sample_rng(SEED, 0, i), normalize=False)
    item_ms = (time.perf_counter() - t0) * 1e3 / 4
    loader = TrainLoader(ds, base.data.batch_size, seed=SEED, num_workers=base.data.num_workers,
                         device_normalize=True, device="cuda")
    batches = iter(loader)
    next(batches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CLI_LOADER_BATCHES):
        batch = next(batches)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    batches.close()
    if batch["imgs"].shape != (2, 4, 480, 480, 3) or batch["imgs"].dtype != torch.uint8:
        raise RuntimeError(f"[train_cli] loader batch {tuple(batch['imgs'].shape)}")
    print(f"[train_cli] loader at 480x853 -> 480x480 crops: "
          f"{CLI_LOADER_BATCHES * base.data.batch_size / dt:.3f} clips/s with "
          f"{loader.num_workers} workers ({CLI_LOADER_BATCHES} batches of "
          f"{base.data.batch_size} after one); {item_ms:.1f} host ms a clip on one thread; "
          f"host {os.cpu_count()} cores | {smi}", flush=True)
    del batch, batches, loader

    plan = TRAIN_FORMS["train"]["per_step"]
    work = os.path.join(work_root, "train_cli")
    try:
        # run A, then run B resumed from its checkpoints
        cfg_a = apply_overrides(base, ["optim.max_iters=2"])
        ops.reset_launches()
        out_a = train_cli.train(cfg_a, work_dir=os.path.join(work, "a"), device="cuda",
                                dataset=ds)
        torch.cuda.synchronize()
        counts_a = ops.launches()
        _cli_launches_held(counts_a, 2, "run A", plan)
        _cli_steps_held(out_a, 0, 2, "run A")
        ckpt_dir = os.path.join(work, "a", "ckpt")
        _cli_checkpoint_held(ckpt_dir, 2, cfg_a)
        del out_a

        cfg_b = apply_overrides(base, ["optim.max_iters=4"])
        ops.reset_launches()
        out_b = train_cli.train(cfg_b, work_dir=os.path.join(work, "a"), device="cuda",
                                resume_from=ckpt_dir, dataset=ds)
        torch.cuda.synchronize()
        counts_b = ops.launches()
        _cli_launches_held(counts_b, 2, "run B", plan)
        _cli_steps_held(out_b, 2, 4, "run B")
        want_lr = poly_schedule(cfg_b.optim)(2)
        lr = out_b["steps"][0]["lr"]
        print(f"[train_cli] run B resumed at step 2: lr {lr:.9e}, poly_schedule(2) "
              f"{want_lr:.9e}", flush=True)
        if abs(lr - want_lr) > 1e-12 * want_lr:
            raise RuntimeError(f"[train_cli] resumed lr {lr} != poly_schedule(2) {want_lr}")
        _cli_checkpoint_held(ckpt_dir, 2, cfg_a)
        _cli_checkpoint_held(ckpt_dir, 4, cfg_b)
        del out_b

        # a profiled run: host ms a step, device busy a step (CLI --profile-dir)
        cfg_c = apply_overrides(base, [f"optim.max_iters={CLI_PROFILE_STEPS}",
                                       "checkpoint_interval=100000"])
        prof_dir = os.path.join(work, "profile")
        out_c = train_cli.train(cfg_c, work_dir=os.path.join(work, "c"), device="cuda",
                                profile_dir=prof_dir, dataset=ds)
        _cli_steps_held(out_c, 0, CLI_PROFILE_STEPS, "profiled run")
        # host ms of the steps before the traced window (the first two
        # warm up), and of the traced ones (the profiler adds host time)
        steady = out_c["iter_ms"][2:train_cli.PROFILE_FIRST]
        traced = out_c["iter_ms"][train_cli.PROFILE_FIRST:]
        prof = out_c["profile"]
        busy = prof["device_busy_ms"] / prof["iterations"]
        host = float(np.median(steady))
        os.makedirs(os.path.join(root, "chiprun_out"), exist_ok=True)
        shutil.copy(os.path.join(prof_dir, "key_averages.txt"),
                    os.path.join(root, "chiprun_out", "profile_train_cli.txt"))
        print(f"[train_cli] CFFM-B1 480x480 B=2 clip-4 bf16, the CLI's loop: {host:.3f} host ms "
              f"a step (median of steps 3-{train_cli.PROFILE_FIRST}: "
              f"{', '.join(f'{t:.1f}' for t in steady)}; traced steps "
              f"{', '.join(f'{t:.1f}' for t in traced)}); device busy {busy:.3f} ms a step "
              f"(torch.profiler over iterations {train_cli.PROFILE_FIRST}-"
              f"{train_cli.PROFILE_LAST}), idle share {1 - busy / host:.3f} of the untraced "
              f"steps | {smi}", flush=True)
        del out_c

        # step 5 with and without the decoder remat, from B's state
        runs = {}
        for remat in (False, True):
            cfg_r = apply_overrides(base, ["optim.max_iters=5", "checkpoint_interval=100000",
                                           f"model.head.decoder.use_checkpoint={remat}"])
            ops.reset_launches()
            out_r = train_cli.train(cfg_r, work_dir=os.path.join(work, f"r{int(remat)}"),
                                    device="cuda", resume_from=ckpt_dir, dataset=ds)
            torch.cuda.synchronize()
            counts_r = ops.launches()
            _cli_launches_held(counts_r, 1, f"step 5, remat={remat}",
                               {**plan, "cfm_attention": 4 if remat else 2})
            _cli_steps_held(out_r, 4, 5, f"step 5, remat={remat}")
            model = out_r["state"].model
            runs[remat] = (out_r["steps"][0],
                           torch.cat([p.grad.float().reshape(-1) for p in model.parameters()]))
            del out_r, model
        (s0, g0), (s1, g1) = runs[False], runs[True]
        cos = torch.nn.functional.cosine_similarity(g1.double(), g0.double(), dim=0).item()
        rl = abs(s1["loss_seg"] - s0["loss_seg"]) / abs(s0["loss_seg"])
        rn = abs(s1["grad_norm"] - s0["grad_norm"]) / s0["grad_norm"]
        print(f"[train_cli] decoder remat, step 5: loss {s1['loss_seg']:.6f} vs "
              f"{s0['loss_seg']:.6f} (rel {rl:.3e}); grad norm {s1['grad_norm']:.6f} vs "
              f"{s0['grad_norm']:.6f} (rel {rn:.3e}); cosine of all gradients {cos:.6f}; "
              f"bitwise equal: {torch.equal(g0, g1)}", flush=True)
        if not (rl <= 1e-2 and rn <= 1e-2 and cos >= 0.999):
            raise RuntimeError("the decoder remat's step disagrees with the plain step")
    finally:
        # the other runs' directories: [test_cli] reads only runs A and B's checkpoints
        for name in ("c", "profile", "r0", "r1"):
            shutil.rmtree(os.path.join(work, name), ignore_errors=True)
    torch.cuda.empty_cache()
    return {name: counts_a[name] + counts_b[name] for name in counts_a}, ckpt_dir


# ---- [native]: the native data path on the card's host, and the train CLI on disk

NATIVE_SEEDS = range(8)
NATIVE_ITEMS = 4               # items timed on one thread, each route
NATIVE_LOADERS = (("thread", "numpy"), ("thread", "native"), ("process", "native"))
NATIVE_ROUNDS = 2              # each loader once a round, the order reversed every round
NATIVE_BATCHES = 6             # timed batches of a loader, after one
# the CLI's runs: (route, traced); a traced run writes its profiler trace (~15 s)
NATIVE_CLI_RUNS = (("native", True), ("numpy", True), ("numpy", False), ("native", False))


@contextlib.contextmanager
def _numpy_route(native):
    """The port's data path without its native library, in this process
    (threads included): ``native.available`` patched to False."""
    available = native.available
    native.available = lambda: False
    try:
        yield
    finally:
        native.available = available


def _route(native, name: str):
    return _numpy_route(native) if name == "numpy" else contextlib.nullcontext()


def native_phase(ops, root: str, smi: str, work_root: str) -> dict:
    """``[native]``: ``vss_cffm_tpu_torch/native`` built by g++ on the card's
    host (build time, the codec headers found, the codecs built), then on a
    VSPW train tree written to disk with PIL (CLI_VIDEOS videos of CLI_FRAMES
    480x853 JPEG frames with PNG masks, ``train.txt``): the native train item
    against the numpy route (the library patched away in this process) for
    seeds 0-7, bit for bit, with ``normalize`` False and True (True: against
    ``normalize_f32`` of the numpy route's uint8 item, which is what the
    native route computes; the numpy route's own division is printed beside
    it), and, where the codecs are built, each JPEG and PNG decode against
    PIL's; host ms a clip on one thread on each route; clips/s of the loader
    with 4 workers on threads (numpy route), on threads (native) and in
    processes (native), in alternating rounds, every round printed; then the
    train CLI (``tools.train``) from ``configs/cffm_b1_vspw_160k.py`` on the
    tree (batch 2) on the native and the numpy route in ABBA order, the first
    pair CLI_PROFILE_STEPS steps with the CLI's profiler window, the second
    ``PROFILE_FIRST`` steps untraced: launches a step held to the default
    form's plan, metrics finite, host ms a step, and for the traced pair
    device busy a step and the idle share. Returns the first native CLI
    run's launch counts."""
    from vss_cffm_tpu_torch import native
    from vss_cffm_tpu_torch.config import apply_overrides, load_config
    from vss_cffm_tpu_torch.data import TrainLoader, VSPWVideoDataset
    from vss_cffm_tpu_torch.data.loader import _sample_rng
    from vss_cffm_tpu_torch.data.transforms import IMG_MEAN, IMG_STD
    from vss_cffm_tpu_torch.data.vspw import load_image, load_label
    from vss_cffm_tpu_torch.tools import train as train_cli

    t0 = time.perf_counter()
    info = native.build_info()
    print(f"[native] g++ {info['compiler']}: library ready in {time.perf_counter() - t0:.2f} s "
          f"(compile {info['build_s'] if info['build_s'] is None else round(info['build_s'], 2)}"
          f" s); headers {info['headers']}; codecs {', '.join(info['codecs']) or 'none'}; "
          f"host {os.cpu_count()} cores | {smi}", flush=True)
    if info["compiler"] is None:
        raise RuntimeError("[native] no g++ on the card's host: the native library is not built")

    t0 = time.perf_counter()
    mem = _synthetic_train_videos(SEED + 5)
    tree = _write_vspw_tree(os.path.join(work_root, "native_vspw"), {
        v: [(mem.imgs[v, n], mem.labels[v, n]) for n in mem.frames[v]] for v in mem.videos},
        split="train")
    del mem
    ds = VSPWVideoDataset(tree, "train")
    print(f"[native] VSPW train tree: {len(ds)} videos of {CLI_FRAMES} JPEG frames of "
          f"{CLI_HW[0]}x{CLI_HW[1]} (quality 95) with PNG masks, written in "
          f"{time.perf_counter() - t0:.1f} s; crop {ds.crop_size}, img_scale {ds.img_scale}",
          flush=True)

    # the native item against the numpy route, bit for bit
    ulps = 0
    for normalize in (False, True):
        for seed in NATIVE_SEEDS:
            idx = seed % len(ds)
            got = ds.get_train_item(idx, np.random.RandomState(seed), normalize)
            with _numpy_route(native):
                want = ds.get_train_item(idx, np.random.RandomState(seed), False)
                divided = normalize and ds.get_train_item(idx, np.random.RandomState(seed), True)
            same = np.array_equal(got["labels"], want["labels"])
            if normalize:  # the pad is 0.0, which no normalised pixel is
                pad = (got["imgs"] == 0).all(-1, keepdims=True)
                f32 = native.normalize_f32(want["imgs"].reshape(-1, ds.crop_size[1], 3),
                                           IMG_MEAN, IMG_STD).reshape(got["imgs"].shape)
                same &= np.array_equal(got["imgs"], np.where(pad, 0, f32))
                ulps = max(ulps, int(np.max(np.abs(got["imgs"] - divided["imgs"])
                                            / np.spacing(np.abs(divided["imgs"])))))
            else:
                same &= np.array_equal(got["imgs"], want["imgs"])
            if not same or got["imgs"].shape != (4, *ds.crop_size, 3):
                raise RuntimeError(f"[native] the native train item of seed {seed} (normalize="
                                   f"{normalize}) differs from the numpy route's")
    print(f"[native] native train items equal the numpy route's bit for bit: seeds "
          f"{NATIVE_SEEDS[0]}-{NATIVE_SEEDS[-1]}, normalize False and True (the numpy route's "
          f"division by std within {ulps} ulp of the library's multiplication by 1 / std)",
          flush=True)
    if native.codecs():
        names = [(v, n) for v in ds.videos for n in ds.frames[v]]

        def decoded(k):
            with open(ds._img_path(*k), "rb") as f:
                return native.decode_jpeg(f.read())

        jpegs = {k: decoded(k) for k in names}
        pngs = {k: load_label(ds._seg_path(*k)) for k in names}
        with _numpy_route(native):
            if not all(np.array_equal(jpegs[k], load_image(ds._img_path(*k)))
                       and np.array_equal(pngs[k], load_label(ds._seg_path(*k)))
                       for k in names):
                raise RuntimeError("[native] a native decode differs from PIL's")
        print(f"[native] libjpeg and libpng decodes equal PIL's on all {len(names)} frames and "
              f"masks", flush=True)

    # host ms a clip on one thread, each route, and of its frames' and labels'
    # decodes alone (what the item reads: libjpeg / libpng with the codecs, else PIL)
    item_ms = {}
    for name in ("numpy", "native", "native", "numpy"):
        with _route(native, name):
            t0 = time.perf_counter()
            for i in range(NATIVE_ITEMS):
                ds.get_train_item(i % len(ds), _sample_rng(SEED, 0, i), normalize=False)
            item_ms.setdefault(name, []).append((time.perf_counter() - t0) * 1e3 / NATIVE_ITEMS)
    t0 = time.perf_counter()
    for i in range(NATIVE_ITEMS):
        video = ds.videos[i % len(ds)]
        for n in ds.frames[video][:4]:
            ds.read_frame(video, n), ds.read_label(video, n)
    decode_ms = (time.perf_counter() - t0) * 1e3 / NATIVE_ITEMS
    print(f"[native] host ms a clip on one thread: " + "; ".join(
        f"{n} {', '.join(f'{x:.2f}' for x in v)}" for n, v in item_ms.items())
        + f"; its 4 frames' and labels' decodes alone {decode_ms:.2f} "
        f"({'libjpeg / libpng' if native.codecs() else 'PIL'})", flush=True)

    # the loader's clips/s with 4 workers, in alternating rounds
    rates = {mode: [] for mode in NATIVE_LOADERS}
    for r in range(NATIVE_ROUNDS):
        for mode, name in (NATIVE_LOADERS if r % 2 == 0 else NATIVE_LOADERS[::-1]):
            with _route(native, name):
                loader = TrainLoader(ds, 2, seed=SEED + r, num_workers=4, worker_mode=mode,
                                     device_normalize=True, device="cuda")
                batches = iter(loader)
                next(batches)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(NATIVE_BATCHES):
                    batch = next(batches)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                batches.close()
            if batch["imgs"].shape != (2, 4, 480, 480, 3):
                raise RuntimeError(f"[native] loader batch {tuple(batch['imgs'].shape)}")
            rates[mode, name].append(NATIVE_BATCHES * 2 / dt)
            print(f"[native] round {r}: loader {mode} {name}: {rates[mode, name][-1]:.3f} "
                  f"clips/s ({loader.num_workers} workers, {NATIVE_BATCHES} batches of 2 after "
                  f"one)", flush=True)
    print("[native] loader clips/s at 480x853 -> 480x480, median of "
          f"{NATIVE_ROUNDS} rounds: " + "; ".join(
              f"{m} {n} {float(np.median(v)):.3f}" for (m, n), v in rates.items())
          + f"; host {os.cpu_count()} cores | {smi}", flush=True)

    # the train CLI on the tree, native and numpy routes in ABBA order; the
    # first pair traced over the CLI's profiler window, the second not (it
    # stops after the steps that give host ms)
    path = os.path.join(root, "vss_cffm_tpu_torch", "configs", "cffm_b1_vspw_160k.py")
    base = apply_overrides(load_config(path), CLI_OPTIONS + [
        f"data.data_root={tree}", "checkpoint_interval=100000"])
    plan = TRAIN_FORMS["train"]["per_step"]
    runs, first = {}, None
    for i, (name, traced) in enumerate(NATIVE_CLI_RUNS):
        n_steps = CLI_PROFILE_STEPS if traced else train_cli.PROFILE_FIRST
        cfg = apply_overrides(base, [f"optim.max_iters={n_steps}"])
        with _route(native, name):
            ops.reset_launches()
            out = train_cli.train(cfg, work_dir=os.path.join(work_root, f"native_cli{i}"),
                                  device="cuda", profile_dir=os.path.join(
                                      work_root, f"native_prof{i}") if traced else None)
            torch.cuda.synchronize()
            counts = ops.launches()
        _cli_launches_held(counts, n_steps, f"the CLI on disk, {name} route", plan,
                           tag="[native]")
        steps = out["steps"]
        if [s["step"] for s in steps] != list(range(1, n_steps + 1)) or not all(
                np.isfinite(s[k]) for s in steps for k in ("loss_seg", "acc_seg", "grad_norm")):
            raise RuntimeError(f"[native] the CLI's {name} run: steps or metrics {steps}")
        first = counts if first is None and name == "native" else first
        host = float(np.median(out["iter_ms"][2:train_cli.PROFILE_FIRST]))
        busy = (out["profile"]["device_busy_ms"] / out["profile"]["iterations"] if traced
                else None)
        runs.setdefault(name, []).append((host, busy))
        print(f"[native] run {i}, {name} route: CFFM-B1 480x480 B=2 clip-4 bf16 from "
              f"{cfg.data.data_root}: {host:.3f} host ms a step (median of steps 3-"
              f"{train_cli.PROFILE_FIRST}), " + (
                  f"device busy {busy:.3f} ms a step (iterations {train_cli.PROFILE_FIRST}-"
                  f"{train_cli.PROFILE_LAST}), idle share {1 - busy / host:.3f}" if traced
                  else "not traced") + f"; loss_seg {steps[0]['loss_seg']:.4f} -> "
              f"{steps[-1]['loss_seg']:.4f} | {smi}", flush=True)
        del out
    print("[native] the CLI on disk, host ms a step (device busy ms): " + "; ".join(
        f"{n} " + ", ".join(f"{h:.3f}" + (f" ({b:.3f})" if b is not None else "") for h, b in v)
        for n, v in runs.items()), flush=True)
    torch.cuda.empty_cache()
    return {"native_cli": first}


# ---- [cffm_pp]: CFFM++ on the card: phase A, the finetune step, eval with the store

PP_CLUSTERS, PP_FRAMES, PP_ITERS = 100, 10, 10   # the _gene_prototype configs' ProtoConfig
PP_STEPS = 14                  # the CLI's --profile-dir traces iterations 10-13
PP_OPTIONS = ["data.batch_size=2", "log_interval=1", "checkpoint_interval=100000",
              f"optim.max_iters={PP_STEPS}", "optim.warmup_iters=0"]
# k-means on the card against the CPU from the same initial indices: the
# features' matmuls sum in other orders, so a near-tie may flip a label and
# move its two centres by a point's share
PP_LABEL_SHARE, PP_CENTRE_REL = 0.999, 1e-3


class _PrototypeSet:
    """The videos of several in-memory datasets as one prototype split: item
    ``i`` is ``get_prototype_item`` of its dataset's video."""

    def __init__(self, *sets):
        self.items = [(ds, i) for ds in sets for i in range(len(ds.videos))]
        self.videos = [ds.videos[i] for ds, i in self.items]

    def __len__(self):
        return len(self.items)

    def get_prototype_item(self, idx: int, num_frames: int = 10) -> dict:
        ds, i = self.items[idx]
        return ds.get_prototype_item(i, num_frames)


def _pp_phase_a(ops, root: str, work: str, smi: str) -> tuple[str, str, dict]:
    """Phase A: a random CFFM-B1 checkpoint (``.pth``), then
    ``tools.generate_prototypes.run`` from ``configs/cffm_b1_vspw_gene_prototype.py``
    over the two train videos of ``[train_cli]`` and the ``[eval]`` video
    (480x853, 10 frames each at 480x864): launches held (4 / 0 / 4 a video),
    the written centres equal to the card's k-means of the features from
    the first initial draw, that k-means against the CPU's from the same
    indices, ms a video of the features and of the k-means. Returns (the
    checkpoint, the cluster directory, the launch counts)."""
    from vss_cffm_tpu_torch.apis import init_segmentor
    from vss_cffm_tpu_torch.config import load_config
    from vss_cffm_tpu_torch.ops.kmeans import kmeans_from, kmeans_init
    from vss_cffm_tpu_torch.tools import generate_prototypes as proto_cli

    cfg = load_config(os.path.join(root, "vss_cffm_tpu_torch", "configs",
                                   "cffm_b1_vspw_gene_prototype.py"))
    if (cfg.model.head.mode, cfg.proto.n_clusters, cfg.proto.num_frames,
            cfg.proto.kmeans_iters) != ("cffm", PP_CLUSTERS, PP_FRAMES, PP_ITERS):
        raise RuntimeError(f"[cffm_pp] the gene_prototype config gave {cfg.proto}")
    ckpt = os.path.join(work, "cffm_b1.pth")
    bundle = init_segmentor(cfg.model, device="cpu", dtype=torch.bfloat16, seed=SEED)
    torch.save({"state_dict": bundle.model.state_dict()}, ckpt)
    del bundle
    videos = _PrototypeSet(_synthetic_train_videos(SEED + 5), _synthetic_video(SEED + 2))
    cluster_dir = os.path.join(work, "clusters")
    ops.reset_launches()
    paths = proto_cli.run(cfg, ckpt, cluster_dir=cluster_dir, n_clusters=PP_CLUSTERS,
                          num_frames=PP_FRAMES, device="cuda", dataset=videos)
    torch.cuda.synchronize()
    counts = ops.launches()
    n = len(videos)
    want = {name: 0 for name in counts}
    want.update({"mit_block_fused": 4 * n, "dwconv3x3": 4 * n})
    print(f"[cffm_pp] phase A: {n} videos {videos.videos}, {PP_FRAMES} frames each of "
          f"{CLI_HW[0]}x{CLI_HW[1]} at img_scale {cfg.data.img_scale}; launches "
          f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    if counts != want:
        raise RuntimeError(f"[cffm_pp] phase A launches {counts}, expected {want}")

    # the written centres, the card's k-means and the CPU's, on video 0's features
    bundle = init_segmentor(cfg.model, device="cuda", dtype=torch.bfloat16, seed=SEED,
                            checkpoint=ckpt)
    model = bundle.model
    item = videos.get_prototype_item(0, PP_FRAMES)
    imgs = torch.from_numpy(item["imgs"]).cuda()[None]
    with torch.inference_mode():
        feats = model.prototype_features(imgs)
    if tuple(feats.shape) != (1, PP_FRAMES, 60, 108, 256):
        raise RuntimeError(f"[cffm_pp] prototype features {tuple(feats.shape)}")
    pts = feats.reshape(-1, 256)
    first = kmeans_init(len(pts), PP_CLUSTERS, torch.Generator("cuda").manual_seed(0))
    card_c, card_l = kmeans_from(pts, first, PP_ITERS)
    saved = torch.from_numpy(np.load(paths[0])).cuda()
    same_file = torch.equal(saved, card_c)
    file_err = (saved - card_c).abs().max().item()
    cpu_c, cpu_l = kmeans_from(pts.cpu(), first.cpu(), PP_ITERS)
    share = (card_l.cpu() == cpu_l).float().mean().item()
    err = (card_c.cpu() - cpu_c).abs().max().item()
    scale = cpu_c.abs().max().item()
    print(f"[cffm_pp] k-means of video 0 ({len(pts)} points x 256, {PP_CLUSTERS} centres, "
          f"{PP_ITERS} iterations): card vs CPU from the same initial indices: labels equal on "
          f"{share:.6f} (limit {PP_LABEL_SHARE}), centres max_abs_err={err:.3e} max|c|="
          f"{scale:.3e} (limit {PP_CENTRE_REL} of it); the written file against the card's "
          f"k-means: {'bitwise equal' if same_file else f'max_abs_err={file_err:.3e}'}",
          flush=True)
    if not (share >= PP_LABEL_SHARE and err <= PP_CENTRE_REL * scale
            and file_err <= PP_CENTRE_REL * scale and torch.isfinite(card_c).all()):
        raise RuntimeError("[cffm_pp] phase A's k-means disagrees")
    for p in paths:
        c = np.load(p)
        if c.shape != (PP_CLUSTERS, 256) or c.dtype != np.float32 or not np.isfinite(c).all():
            raise RuntimeError(f"[cffm_pp] {p}: centres {c.shape} {c.dtype}")
    with torch.inference_mode():
        feat_ms = _time_ms(lambda: model.prototype_features(imgs), iters=5, warmup=1)
        km_ms = _time_ms(lambda: kmeans_from(pts, first, PP_ITERS), iters=5, warmup=1)
    print(f"[cffm_pp] phase A a video: features {feat_ms:.3f} ms ({PP_FRAMES} frames 480x864), "
          f"k-means {km_ms:.3f} ms (CUDA events over 5 calls after one) | {smi}", flush=True)
    del bundle, model, feats, pts, imgs
    torch.cuda.empty_cache()
    return ckpt, cluster_dir, counts


def _pp_phase_b(ops, root: str, work: str, ckpt: str, cluster_dir: str, smi: str):
    """Phase B: ``tools.train.train`` on ``configs/cffm_b1_vspw_finetune_40k.py``
    (``PP_OPTIONS``: batch 2, no warmup, so that the decay shows) ``--load-from``
    phase A's checkpoint, the centres from its cluster directory, on
    ``[train_cli]``'s in-memory videos: launches a step held to the finetune
    plan, every frozen weight at its decay alone, the BN statistics as
    loaded, the cluster branch moved off its init; host ms and device busy a
    step (the CLI's profiler window). Returns (the trained model, counts)."""
    from vss_cffm_tpu_torch.config import apply_overrides, load_config
    from vss_cffm_tpu_torch.models import CFFMSegmentor
    from vss_cffm_tpu_torch.tools import train as train_cli
    from vss_cffm_tpu_torch.train import poly_schedule
    from vss_cffm_tpu_torch.train.optim import paramwise_multipliers

    path = os.path.join(root, "vss_cffm_tpu_torch", "configs", "cffm_b1_vspw_finetune_40k.py")
    cfg = apply_overrides(load_config(path), PP_OPTIONS + [f"cluster_dir={cluster_dir}"])
    if (cfg.model.head.mode, cfg.model.backbone, cfg.optim.lr) != ("finetune", "mit_b1", 2e-4):
        raise RuntimeError(f"[cffm_pp] the finetune config gave {cfg.model.head.mode}, "
                           f"{cfg.model.backbone}, lr {cfg.optim.lr}")
    plan = {name: 0 for name in ops.KERNEL_OPS}
    plan.update({"mit_block_train": 6, "dwconv3x3": 2, "ce_upsampled_loss": 2,
                 "ce_upsampled_loss_bwd": 2})
    prof_dir = os.path.join(work, "profile_ft")
    ops.reset_launches()
    out = train_cli.train(cfg, work_dir=os.path.join(work, "ft"), device="cuda", load_from=ckpt,
                          profile_dir=prof_dir, dataset=_synthetic_train_videos(SEED + 5))
    torch.cuda.synchronize()
    counts = ops.launches()
    print(f"[cffm_pp] finetune: launches over {PP_STEPS} steps "
          f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    if counts != {k: n * PP_STEPS for k, n in plan.items()}:
        raise RuntimeError(f"[cffm_pp] finetune launches {counts}, expected {plan} a step")
    _cli_steps_held(out, 0, PP_STEPS, "[cffm_pp] finetune")

    model = out["state"].model
    loaded = torch.load(ckpt)["state_dict"]
    init = CFFMSegmentor(cfg.model)
    init.init_weights(torch.Generator().manual_seed(cfg.seed))
    init = init.state_dict()
    sched, wd = poly_schedule(cfg.optim), cfg.optim.weight_decay
    decayed_n = kept_n = 0
    worst = 0.0
    moved = set()
    for name, p in model.named_parameters():
        if name not in loaded:  # the cluster branch: trained from its init
            if torch.equal(p.detach().cpu(), init[name]):
                raise RuntimeError(f"[cffm_pp] {name} did not move")
            moved.add(name.split(".")[1])
            continue
        mult, decayed = paramwise_multipliers(name, cfg.optim.head_lr_mult)
        want = loaded[name].cuda()
        if decayed:  # AdamW's p·(1 − lr·wd) a step, the lr of the group at step t
            base = cfg.optim.lr * mult  # LambdaLR: the group's base lr times the schedule's factor
            for t in range(PP_STEPS):
                want = want * (1 - base * (sched(t) / cfg.optim.lr) * wd)
            decayed_n += 1
        else:
            kept_n += 1
        got = p.detach()
        e = ((got - want).abs().max() / want.abs().max().clamp(min=1e-30)).item()
        worst = max(worst, e)
        if e > 2.0 ** -23 or (decayed and loaded[name].any()
                              and torch.equal(got, loaded[name].cuda())):
            raise RuntimeError(f"[cffm_pp] frozen {name}: rel err {e} against w(1 - lr wd)^t")
    bn = "decode_head.linear_fuse.bn"
    sd = model.state_dict()
    bn_same = all(torch.equal(sd[f"{bn}.{s}"].cpu(), loaded[f"{bn}.{s}"])
                  for s in ("running_mean", "running_var"))
    print(f"[cffm_pp] finetune: {decayed_n} frozen tensors at w·Π(1 − lr_t·wd) and {kept_n} at w "
          f"(worst relative error {worst:.3e}, limit 2^-23); trained from their init: "
          f"{sorted(moved)}; fuse BN statistics {'as loaded' if bn_same else 'MOVED'}",
          flush=True)
    if moved != {"decoder_swin", "linear_pred3"} or not bn_same:
        raise RuntimeError("[cffm_pp] the finetune step trained other parameters or moved the BN")
    steady = out["iter_ms"][2:train_cli.PROFILE_FIRST]
    prof = out["profile"]
    busy = prof["device_busy_ms"] / prof["iterations"]
    host = float(np.median(steady))
    os.makedirs(os.path.join(root, "chiprun_out"), exist_ok=True)
    shutil.copy(os.path.join(prof_dir, "key_averages.txt"),
                os.path.join(root, "chiprun_out", "profile_cffm_pp_train.txt"))
    print(f"[cffm_pp] CFFM++-B1 finetune 480x480 B=2 clip-4 bf16, the CLI's loop: {host:.3f} host "
          f"ms a step (median of steps 3-{train_cli.PROFILE_FIRST}: "
          f"{', '.join(f'{t:.1f}' for t in steady)}); device busy {busy:.3f} ms a step "
          f"(torch.profiler over iterations {train_cli.PROFILE_FIRST}-{train_cli.PROFILE_LAST}), "
          f"idle share {1 - busy / host:.3f} | {smi}", flush=True)
    return model, counts


def _pp_phase_c(ops, root: str, kind: str, smi: str, model, cluster_dir: str) -> dict:
    """Evaluation with the store: the finetuned model (bf16) streamed and per
    clip on ``[eval]``'s video (480x853, the network at 480x864), each target
    frame's launches held (4 / 2 / 4; 4 / 0 / 4 for the one-frame clips of
    frames 0-2), streamed logits against the clip path's and against
    ``force="torch"`` within 5 % of the largest logit, eval frames/s and
    device busy a target frame. Returns the launch counts of both."""
    from vss_cffm_tpu_torch.eval import ClipEvaluator, ClusterStore, StreamingVideoEvaluator
    from vss_cffm_tpu_torch.models import set_force

    model.eval()
    video = _synthetic_video(SEED + 2)
    store = ClusterStore(cluster_dir)
    per_clip = {"mit_block_fused": 4, "cfm_attention": 2, "dwconv3x3": 4}
    counts, logits = {}, {}
    evs = {"streamed": StreamingVideoEvaluator(model, NUM_CLASSES, device="cuda",
                                               cluster_store=store),
           "per clip": ClipEvaluator(model, NUM_CLASSES, device="cuda", cluster_store=store)}
    runs = {"streamed": lambda on_pred=None: evs["streamed"].run_streaming(video, on_pred=on_pred),
            "per clip": lambda on_pred=None: evs["per clip"].run(
                (video.get_test_item(i) for i in range(len(video))), dataset=video,
                on_pred=on_pred)}
    runs["streamed"]()  # warm-up
    for name in runs:
        evs[name].reset()
        torch.cuda.synchronize()
        if name == "streamed":
            seen, restore = _logits_recorder(model)
        else:
            seen = []
            hook = model.register_forward_hook(lambda mod, a, o: seen.append(o.detach().clone()))
            restore = hook.remove
        ops.reset_launches()
        deltas, on_pred = _launch_deltas(ops)
        m = runs[name](on_pred)
        torch.cuda.synchronize()
        counts[name] = ops.launches()
        restore()
        logits[name] = seen
        for index, got in deltas:
            want = _expected_launches(video, per_clip, index)
            if got != want:
                raise RuntimeError(f"[cffm_pp] eval {name}, frame {index}: launches {got}, "
                                   f"expected {want}")
        print(f"[cffm_pp] eval with the store, {name}: launches "
              f"{ {k: counts[name][k] for k in per_clip} } over {EVAL_FRAMES} target frames "
              f"(each frame held); mIoU {m['mIoU']:.5f}", flush=True)
    set_force(model, "torch")
    plain, restore = _logits_recorder(model)
    StreamingVideoEvaluator(model, NUM_CLASSES, device="cuda",
                            cluster_store=store).run_streaming(video)
    restore()
    set_force(model, None)
    worst = {"per clip": 0.0, "plain": 0.0}
    for t, got in enumerate(logits["streamed"]):
        if not torch.isfinite(got.float()).all():
            raise RuntimeError(f"[cffm_pp] non-finite streamed logits at frame {t}")
        for ref_name, ref in (("per clip", logits["per clip"][t]), ("plain", plain[t])):
            e = (got.float() - ref.float()).abs().max().item()
            s = ref.float().abs().max().item()
            worst[ref_name] = max(worst[ref_name], e / s)
            if e > 0.05 * s:
                raise RuntimeError(f"[cffm_pp] streamed logits of frame {t} disagree with the "
                                   f"{ref_name} path: {e} > {0.05 * s}")
    print(f"[cffm_pp] streamed logits {tuple(logits['streamed'][0].shape)} of "
          f"{len(logits['streamed'])} target frames: worst max_abs_err / max|ref| "
          f"{worst['per clip']:.4f} against the clip path, {worst['plain']:.4f} against "
          f"force='torch' (limit 0.05)", flush=True)
    del logits, plain
    for name in runs:
        rates = []
        for _ in range(EVAL_ROUNDS):
            evs[name].reset()
            torch.cuda.synchronize()
            ts = time.perf_counter()
            runs[name]()
            torch.cuda.synchronize()
            rates.append(EVAL_FRAMES / (time.perf_counter() - ts))
        busy = _profile(runs[name], f"cffm_pp eval {name}, {EVAL_FRAMES} frames",
                        f"profile_cffm_pp_eval_{name.replace(' ', '_')}.txt", root, kind, smi)
        print(f"[cffm_pp] CFFM++-B1 {EVAL_HW[0]}x{EVAL_HW[1]} video with the store, {name}: "
              f"{float(np.median(rates)):.3f} eval frames/s, median of {EVAL_ROUNDS} rounds "
              f"({', '.join(f'{x:.3f}' for x in rates)}); device busy "
              f"{busy / EVAL_FRAMES:.3f} ms a target frame | {smi}", flush=True)
    return {f"cffm_pp_eval_{name.replace(' ', '_')}": c for name, c in counts.items()}


def cffm_pp_phase(ops, root: str, kind: str, smi: str, work_root: str) -> tuple[dict, str, str]:
    """``[cffm_pp]``: CFFM++-B1 on the card, phase A (``_pp_phase_a``), the
    finetune train CLI (``_pp_phase_b``) and evaluation with the cluster store
    (``_pp_phase_c``), everything written under ``work_root``. Returns the
    launch counts by path, the finetune's checkpoint directory and the
    cluster directory, which ``[test_cli]`` evaluates."""
    t0 = time.perf_counter()
    work = os.path.join(work_root, "cffm_pp")
    os.makedirs(work)
    ckpt, cluster_dir, counts_a = _pp_phase_a(ops, root, work, smi)
    model, counts_b = _pp_phase_b(ops, root, work, ckpt, cluster_dir, smi)
    counts = _pp_phase_c(ops, root, kind, smi, model, cluster_dir)
    del model
    torch.cuda.empty_cache()
    print(f"[cffm_pp] done in {time.perf_counter() - t0:.1f} s", flush=True)
    return ({"cffm_pp_phase_a": counts_a, "cffm_pp_finetune": counts_b, **counts},
            os.path.join(work, "ft", "ckpt"), cluster_dir)


# ---- [image]: SegFormer-B0 at VSPW's eval geometry ---------------------------

IMAGE_CONFIG = os.path.join("vss_cffm_tpu_torch", "configs", "segformer_b0_image.py")
# an image model's launches a target frame: rows 1 and 3 at stages 2-3 and
# 1, 4; no CFM decoder, no key-tiled attention at 480x864
IMAGE_PER_FRAME = {"mit_block_fused": 4, "cfm_attention": 0, "dwconv3x3": 4,
                   "attention_fwd_tiled": 0}


def _launches_held(counts: dict, want: dict, what: str) -> None:
    got = {k: counts[k] for k in want}
    if got != want:
        raise RuntimeError(f"{what}: launches {got}, expected {want}")


def _logits_held(bundle, frames, what: str, rel: float = 0.05) -> float:
    """The target frame's logits through ``apis.clip_logits``, kernels
    against ``force="torch"`` on the card: finite, within ``rel`` of the
    largest plain logit. Returns max_abs_err / max|plain|."""
    from vss_cffm_tpu_torch.apis import clip_logits
    from vss_cffm_tpu_torch.models import set_force

    logits, _ = clip_logits(bundle, frames)
    set_force(bundle.model, "torch")
    try:
        ref, _ = clip_logits(bundle, frames)
    finally:
        set_force(bundle.model, None)
    if not torch.isfinite(logits.float()).all():
        raise RuntimeError(f"{what}: non-finite logits")
    err = (logits.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    if err > rel * scale:
        raise RuntimeError(f"{what}: logits disagree with the plain path: {err} > {rel * scale}")
    return err / scale


def image_phase(apis, ops, opts, root, kind, smi) -> tuple[dict, dict]:
    """``[image]``: SegFormer-B0 (MiT-B0 32/64/160/256, head 256 wide, 124
    classes; random weights from SEED, bf16) from its config through
    ``init_segmentor``, on ``[eval]``'s synthetic video at the config's
    ``dilation=()`` (480x853, the network at 480x864): rows 1 and 3 at the
    inputs of one plain forward there (B0's channel counts);
    ``inference_segmentor`` on one frame (launches 4 / 0 / 4, logits against
    ``force="torch"`` within 5 % of the largest); the whole-mode
    ``ClipEvaluator`` over the video (launches held 4 / 0 / 4 a target frame,
    the confusion's total = the valid GT pixels, eval frames/s over
    EVAL_ROUNDS rounds, device busy a target frame); slide on 2 frames; a
    streamed evaluator refused with a ``ValueError``. Returns (kernel stats
    at B0's shapes, launch counts by path)."""
    from vss_cffm_tpu_torch.data import iterate_eval
    from vss_cffm_tpu_torch.eval import ClipEvaluator, StreamingVideoEvaluator
    from vss_cffm_tpu_torch.eval.inference import slide_grid
    from vss_cffm_tpu_torch.models import ImageSegmentor

    t0 = time.perf_counter()
    bundle = apis.init_segmentor(os.path.join(root, IMAGE_CONFIG), device="cuda", seed=SEED)
    model, cfg = bundle.model, bundle.cfg
    widths = model.config.backbone_config.embed_dims
    print(f"[image] {IMAGE_CONFIG}: {type(model).__name__}, {model.config.backbone} widths "
          f"{widths}, head {model.config.head.embed_dim} wide, {model.config.head.num_classes} "
          f"classes, img_scale {bundle.img_scale}, dilation {cfg.data.dilation}, compute "
          f"{model.backbone.compute_dtype}", flush=True)
    if not (isinstance(model, ImageSegmentor) and widths == (32, 64, 160, 256)
            and model.config.head.embed_dim == 256 and bundle.img_scale == EVAL_SCALE
            and cfg.data.dilation == () and model.backbone.compute_dtype == torch.bfloat16):
        raise RuntimeError("[image] the SegFormer-B0 config gave another model")
    video = _synthetic_video(SEED + 2, dilation=cfg.data.dilation)
    valid = sum(int((lab < NUM_CLASSES).sum()) for lab in video.labels)
    ev = ClipEvaluator(model, NUM_CLASSES, device="cuda")
    item = video.get_test_item(EVAL_CLIP_TARGET)
    x = ev._input(item["imgs"], item["img_scale"])
    if tuple(x.shape) != (1, 1, *EVAL_INPUT_HW, 3):
        raise RuntimeError(f"[image] network input {tuple(x.shape)}")

    # rows 1 and 3 at the inputs of one plain forward at 480x864
    kernels = {name: KERNELS[name] for name in ("mit_block_fused", "dwconv3x3")}
    stats = check_kernels(ops, _capture_main_path_inputs(model, x), kernels, opts.profile)

    # inference_segmentor on one frame
    frame = video.imgs[EVAL_CLIP_TARGET]
    apis.inference_segmentor(bundle, frame)  # warm-up
    torch.cuda.synchronize()
    ops.reset_launches()
    mask = apis.inference_segmentor(bundle, frame)
    torch.cuda.synchronize()
    counts = {"image_inference": ops.launches()}
    _launches_held(counts["image_inference"], IMAGE_PER_FRAME, "[image] inference_segmentor")
    rel = _logits_held(bundle, frame, "[image] inference_segmentor")
    print(f"[image] inference_segmentor on one {EVAL_HW[0]}x{EVAL_HW[1]} frame: mask "
          f"{tuple(mask.shape)}, launches {IMAGE_PER_FRAME}; logits vs force='torch' "
          f"max_abs_err / max|ref| = {rel:.4f} (limit 0.05)", flush=True)

    # the whole-mode evaluation over the video, each target frame's launches held
    ops.reset_launches()
    deltas, on_pred = _launch_deltas(ops)
    m = ev.run((video.get_test_item(i) for i in range(len(video))), dataset=video,
               on_pred=on_pred)
    torch.cuda.synchronize()
    counts["image_eval"] = ops.launches()
    for index, got in deltas:
        if got != IMAGE_PER_FRAME:
            raise RuntimeError(f"[image] eval frame {index}: launches {got}, expected "
                               f"{IMAGE_PER_FRAME}")
    total = int(ev.confusion.sum())
    print(f"[image] ClipEvaluator (whole) over {EVAL_FRAMES} frames: launches "
          f"{ {k: counts['image_eval'][k] for k in IMAGE_PER_FRAME} } (each frame held); "
          f"confusion total {total}, valid GT pixels {valid}; mIoU {m['mIoU']:.5f}", flush=True)
    if total != valid:
        raise RuntimeError(f"[image] confusion counts {total} pixels, the GT has {valid}")

    # eval frames/s and device busy a target frame
    run = lambda: ev.run(iterate_eval(video, num_workers=2), dataset=video)
    rates = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(EVAL_ROUNDS):
        ev.reset()
        torch.cuda.synchronize()
        ts = time.perf_counter()
        run()
        torch.cuda.synchronize()
        rates.append(EVAL_FRAMES / (time.perf_counter() - ts))
    peak = torch.cuda.max_memory_allocated() / 2**20
    busy = _profile(run, f"image eval, {EVAL_FRAMES} frames", "profile_image_eval.txt", root,
                    kind, smi)
    print(f"[image] SegFormer-B0 {EVAL_HW[0]}x{EVAL_HW[1]} video, per frame: "
          f"{float(np.median(rates)):.3f} eval frames/s, median of {EVAL_ROUNDS} rounds "
          f"({', '.join(f'{r:.3f}' for r in rates)}); device busy {busy / EVAL_FRAMES:.3f} ms a "
          f"target frame; peak memory {peak:.1f} MiB | {smi}", flush=True)

    # slide: 3 crops of 480x480 a frame
    grid = slide_grid(EVAL_INPUT_HW, EVAL_CROP, EVAL_STRIDE)
    slide_ev = ClipEvaluator(model, NUM_CLASSES, mode="slide", crop_size=EVAL_CROP,
                             stride=EVAL_STRIDE, device="cuda")
    slide_ev.predict(video.get_test_item(EVAL_SLIDE_FRAMES[0]))  # warm-up
    torch.cuda.synchronize()
    ops.reset_launches()
    ts = time.perf_counter()
    slide_ev.run((video.get_test_item(i) for i in EVAL_SLIDE_FRAMES), dataset=video)
    torch.cuda.synchronize()
    slide_s = (time.perf_counter() - ts) / len(EVAL_SLIDE_FRAMES)
    counts["image_slide"] = ops.launches()
    want = {k: len(grid) * n * len(EVAL_SLIDE_FRAMES) for k, n in IMAGE_PER_FRAME.items()}
    _launches_held(counts["image_slide"], want, "[image] slide")
    print(f"[image] slide ({len(grid)} crops of {EVAL_CROP}) on {len(EVAL_SLIDE_FRAMES)} frames: "
          f"{slide_s:.4f} s a frame; launches {want}", flush=True)

    try:
        StreamingVideoEvaluator(model, NUM_CLASSES, device="cuda")
    except ValueError as e:
        print(f"[image] StreamingVideoEvaluator refused the image model: {e}", flush=True)
    else:
        raise RuntimeError("[image] a StreamingVideoEvaluator took the image model")
    del bundle, model, ev, slide_ev, video
    torch.cuda.empty_cache()
    print(f"[image] done in {time.perf_counter() - t0:.1f} s", flush=True)
    return stats, counts


# ---- [test_cli]: the test CLI as a user runs it, on a VSPW tree on disk --------

# 2 videos of 10 frames (VC8 needs more than 8 frames a video), from the
# [train_cli] videos (whose centres phase A wrote), and one video of 2
# frames, [eval]'s (its centres too), for TTA
TEST_CLI_FRAMES, TEST_CLI_TTA_FRAMES = 10, 2
# with the TTA tree's 2 frames: frame 1's clip is (0, 0, 0, 1), four frames,
# so the focal decoder and the cluster branch run under TTA
TEST_CLI_TTA_DILATION = "-1,-1,-1"


def _write_vspw_tree(root: str, videos: dict, split: str = "val") -> str:
    """A VSPW tree (``<split>.txt``, ``data/<video>/origin/*.jpg``,
    ``mask/*.png``) from {video: [(BGR frame, label), ...]}, written with PIL:
    the labels as raw VSPW masks (label + 1, 0 where ignored), which
    ``reduce_zero_label`` reads back as they were."""
    from PIL import Image

    os.makedirs(root)
    with open(os.path.join(root, f"{split}.txt"), "w") as f:
        f.write("\n".join(videos) + "\n")
    for video, frames in videos.items():
        d = os.path.join(root, "data", video)
        os.makedirs(os.path.join(d, "origin"))
        os.makedirs(os.path.join(d, "mask"))
        for i, (img, lab) in enumerate(frames):
            Image.fromarray(np.ascontiguousarray(img[..., ::-1])).save(
                os.path.join(d, "origin", f"{i:08d}.jpg"), quality=95)
            raw = np.where(lab == 255, 0, lab.astype(np.int64) + 1).astype(np.uint8)
            Image.fromarray(raw).save(os.path.join(d, "mask", f"{i:08d}.png"))
    return root


def _clip_plan(ds, views: int = 1) -> dict:
    """Rows 1-3's launches of one evaluation pass: 4 / 4 an item and view,
    row 2 twice a view where the item's clip has 4 frames."""
    n = len(ds)
    full = sum(len(ds.sample_test_clip(i).frame_indices) == 4 for i in range(n))
    return {"mit_block_fused": 4 * n * views, "cfm_attention": 2 * full * views,
            "dwconv3x3": 4 * n * views}


def test_cli_phase(ops, root: str, smi: str, work_root: str, cffm_ckpt: str, ft_ckpt: str,
                   cluster_dir: str) -> dict:
    """``[test_cli]``: ``tools.test.main`` on VSPW trees written with PIL (JPEG
    frames, PNG masks of 480x853): the CFFM-B1 config on ``[train_cli]``'s
    checkpoint directory, ``--streaming --vc --out m.json`` and per clip, each
    confusion equal to the direct evaluator's on the same tree and weights,
    VC8 finite; the CFFM++-B1 finetune config on ``[cffm_pp]``'s checkpoint and
    cluster directory with ``--aug-test`` on a one-video 2-frame tree (rows 1,
    1′, 2, 3 launches held; confusion equal to the direct evaluator's); the
    SegFormer-B0 config on a random ``.pth`` with ``--format-only --show``
    (a PNG and an overlay a frame). Host ms a frame of each run. Returns the
    launch counts of each run, and for ``[dist]`` the B1 runs' tree, config
    and outputs ({"tree", "config", "streamed", "per_clip"})."""
    from vss_cffm_tpu_torch.apis import init_segmentor
    from vss_cffm_tpu_torch.config import apply_overrides, load_config
    from vss_cffm_tpu_torch.data import VSPWVideoDataset, iterate_eval, iterate_eval_tta
    from vss_cffm_tpu_torch.eval import ClipEvaluator, ClusterStore, StreamingVideoEvaluator
    from vss_cffm_tpu_torch.tools import test as test_cli

    t0 = time.perf_counter()
    work = os.path.join(work_root, "test_cli")
    train = _synthetic_train_videos(SEED + 5)
    # each frame with its video's first label map: the pattern moves 11-19 px a
    # frame, so moving labels would leave VC8's windows no pixel whose GT stays
    tree = _write_vspw_tree(os.path.join(work, "vspw"), {
        v: [(train.imgs[v, f], train.labels[v, train.frames[v][0]])
            for f in train.frames[v][:TEST_CLI_FRAMES]] for v in train.videos})
    video = _synthetic_video(SEED + 2)
    tta_tree = _write_vspw_tree(os.path.join(work, "vspw_tta"), {
        video.videos[0]: list(zip(video.imgs, video.labels))[:TEST_CLI_TTA_FRAMES]})
    del train, video
    print(f"[test_cli] VSPW trees written with PIL: {len(os.listdir(os.path.join(tree, 'data')))} "
          f"videos of {TEST_CLI_FRAMES} frames and 1 of {TEST_CLI_TTA_FRAMES} "
          f"({CLI_HW[0]}x{CLI_HW[1]} JPEG frames, PNG masks) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    configs = os.path.join(root, "vss_cffm_tpu_torch", "configs")
    counts = {}

    def run(name: str, argv: list, n: int, want: dict) -> dict:
        ops.reset_launches()
        ts = time.perf_counter()
        out = test_cli.main(argv)
        torch.cuda.synchronize()
        dt = time.perf_counter() - ts
        counts[name] = ops.launches()
        _launches_held(counts[name], want, f"[test_cli] {name}")
        print(f"[test_cli] {name} ({' '.join(a for a in argv[2:] if not a.startswith('data.'))}):"
              f" {dt * 1e3 / n:.1f} host ms a frame ({n} frames in {dt:.2f} s, the CLI's "
              f"loading and its first calls included); launches {want}; mIoU "
              f"{out['metrics']['mIoU']:.5f}", flush=True)
        return out

    def equal(out: dict, ev, what: str) -> None:
        same = np.array_equal(out["confusion"], ev.confusion)
        print(f"[test_cli] {what}: the CLI's confusion (total {int(out['confusion'].sum())}) "
              f"{'equals' if same else 'DIFFERS FROM'} the direct evaluator's", flush=True)
        if not same:
            raise RuntimeError(f"[test_cli] {what}: the CLI's confusion differs from the "
                               "direct evaluator's")

    # 1. CFFM-B1 on [train_cli]'s checkpoint directory, streamed and per clip
    path = os.path.join(configs, "cffm_b1_vspw_160k.py")
    options = [f"data.data_root={tree}"]
    cfg = apply_overrides(load_config(path), options)
    ds = VSPWVideoDataset(tree, "val", dilation=cfg.data.dilation, img_scale=cfg.data.img_scale)
    bundle = init_segmentor(cfg, checkpoint=cffm_ckpt, device="cuda")
    plan = {**_clip_plan(ds), "attention_fwd_tiled": 0}
    one_process = {"tree": tree, "config": path}
    for name, flags in (("streamed", ["--streaming"]), ("per_clip", [])):
        out_json = os.path.join(work, f"{name}.json")
        out = run(f"test_cli_{name}", [path, cffm_ckpt, *flags, "--vc", "--out", out_json,
                                       "--options", *options], len(ds), plan)
        if name == "streamed":
            ev = StreamingVideoEvaluator(bundle.model, NUM_CLASSES,
                                         max_lag=-min(cfg.data.dilation), device="cuda")
            ev.run_streaming(ds, keep_for_vc=True)
        else:
            ev = ClipEvaluator(bundle.model, NUM_CLASSES, device="cuda")
            ev.run(iterate_eval(ds), dataset=ds, keep_for_vc=True)
        equal(out, ev, f"CFFM-B1 {name}")
        with open(out_json) as f:
            written = json.load(f)
        vc8 = out["metrics"]["VC8"]
        print(f"[test_cli] CFFM-B1 {name}: VC8 {vc8:.5f} VC16 {out['metrics']['VC16']}; "
              f"{out_json} holds {sorted(written)}", flush=True)
        same = json.dumps(written, sort_keys=True) == json.dumps(out["metrics"], sort_keys=True)
        if not np.isfinite(vc8) or not same:  # (VC16 is NaN: the videos have 10 frames)
            raise RuntimeError(f"[test_cli] {name}: VC8 {vc8}, or the JSON is not the metrics")
        one_process[name] = out
    del bundle, ev

    # 2. CFFM++-B1 on [cffm_pp]'s finetune checkpoint and centres, with TTA
    path = os.path.join(configs, "cffm_b1_vspw_finetune_40k.py")
    options = [f"data.data_root={tta_tree}", f"data.dilation={TEST_CLI_TTA_DILATION}",
               f"cluster_dir={cluster_dir}"]
    cfg = apply_overrides(load_config(path), options)
    ds = VSPWVideoDataset(tta_tree, "val", dilation=cfg.data.dilation,
                          img_scale=cfg.data.img_scale)
    bundle = init_segmentor(cfg, checkpoint=ft_ckpt, device="cuda")
    items = [ds.get_test_item_tta(i) for i in range(len(ds))]
    views = len(items[0]["scales"])
    tiled = sum(_tta_tiled_expected(bundle.model, it["ori_shape"], it["scales"]) for it in items)
    plan = {**_clip_plan(ds, views), "attention_fwd_tiled": tiled}
    if not (tiled > 0 and plan["cfm_attention"] > 0):
        raise RuntimeError(f"[test_cli] the TTA plan {plan} runs no row 1′ or no row 2")
    out = run("test_cli_tta", [path, ft_ckpt, "--aug-test", "--options", *options], len(ds), plan)
    ev = ClipEvaluator(bundle.model, NUM_CLASSES, device="cuda",
                       cluster_store=ClusterStore(cluster_dir))
    ev.run(iterate_eval_tta(ds), dataset=ds)
    equal(out, ev, f"CFFM++-B1 with the store, TTA ({views} views a frame)")
    del bundle, ev, items

    # 3. SegFormer-B0 on a random .pth, --format-only --show
    path = os.path.join(root, IMAGE_CONFIG)
    pth = os.path.join(work, "segformer_b0.pth")
    torch.save({"state_dict": init_segmentor(path, device="cpu", seed=SEED).model.state_dict()},
               pth)
    show_dir = os.path.join(work, "submission")
    options = [f"data.data_root={tree}"]
    ds = VSPWVideoDataset(tree, "val", dilation=(), img_scale=EVAL_SCALE)
    plan = {k: v * len(ds) for k, v in IMAGE_PER_FRAME.items()}
    out = run("test_cli_image", [path, pth, "--format-only", "--show", "--show-dir", show_dir,
                                 "--options", *options], len(ds), plan)
    written = {d: sum(len(os.listdir(os.path.join(d, v))) for v in ds.videos)
               for d in (show_dir, show_dir + "_vis")}
    valid = sum(int((ds.load_gt(i) < NUM_CLASSES).sum()) for i in range(len(ds)))
    print(f"[test_cli] SegFormer-B0 --format-only --show: {written} PNGs for {len(ds)} frames; "
          f"confusion total {int(out['confusion'].sum())}, valid GT pixels {valid}", flush=True)
    if set(written.values()) != {len(ds)} or int(out["confusion"].sum()) != valid:
        raise RuntimeError("[test_cli] the image run wrote other PNGs or counted other pixels")
    torch.cuda.empty_cache()
    print(f"[test_cli] done in {time.perf_counter() - t0:.1f} s | {smi}", flush=True)
    return counts, one_process


# ---- [dist]: training and evaluation over several processes ------------------

DIST_STEPS = 2
DIST_OPTIONS = ["data.batch_size=2", "optim.max_iters=2", "log_interval=1",
                "checkpoint_interval=2"]
DIST_TIMED = 3                 # all-reduce calls timed after one warm-up
DIST_REL = {"loss_seg": 1e-3, "grad_norm": 2e-3, "bn": 1e-3}  # relative, against one
# process: the gradient norm carries the card's nondeterministic upsampling
# backward (2.1e-4 read with SyncBN, 0.28 with each rank's own BN moments)
DIST_COS = 0.999               # cosine of the parameter deltas (PERF.md §2)
DIST_ACC = 0.1                 # accuracy, in points


def _own_moments(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The fuse BN's moments over this rank's rows alone: what a BatchNorm
    without SyncBN computes on each rank."""
    mean = a.mean(dim=(0, 1, 2))
    return mean, (a - mean).square().mean(dim=(0, 1, 2))


def _all_reduce_ms(grads: list, device) -> dict:
    """Host ms of ``parallel.all_reduce_mean_`` of ``grads`` and of the
    collective alone on their flat buffer, each the mean of DIST_TIMED calls
    after one, in the process group that is up."""
    import torch.distributed as dist

    from vss_cffm_tpu_torch import parallel

    flat = torch.cat([g.reshape(-1) for g in grads])

    def timed(fn) -> float:
        fn()
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(DIST_TIMED):
            fn()
        torch.cuda.synchronize(device)
        return (time.perf_counter() - t0) * 1e3 / DIST_TIMED

    return {"all_reduce_mean_ms": timed(lambda: parallel.all_reduce_mean_(grads)),
            "collective_ms": timed(lambda: dist.all_reduce(flat))}


def _dist_steps(device, model_cfg, state_dict: dict, batch: dict, optim_cfg,
                own_bn: bool = False, mesh=None, profile: bool = False) -> dict:
    """DIST_STEPS default train steps of the model of ``model_cfg`` (bf16
    compute, f32 parameters) from ``state_dict`` on this rank's rows of the
    global ``batch`` (without a process group: all of it), or on ``mesh``
    (``parallel.create_clip_mesh``) its share there (``shard_clip_batch``);
    step ``it`` draws from ``step_seed(SEED, it)``. ``own_bn``: the fuse BN on
    each rank's own moments (``_own_moments``), the fault that the check of
    ``[dist]`` (a) must catch. Returns each step's metrics, host ms (to a
    synchronize) and launches; the parameter deltas (rank 0) and a digest of
    them; the fuse BN's running statistics; the gradients' bytes and, in a
    process group, the ms of their all-reduce (``_all_reduce_ms``); peak
    memory; with ``profile``, the device busy ms of the last step
    (torch.profiler)."""
    from vss_cffm_tpu_torch import ops, parallel
    from vss_cffm_tpu_torch.models import CFFMSegmentor, heads
    from vss_cffm_tpu_torch.tools.train import step_seed
    from vss_cffm_tpu_torch.train import TrainState, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = CFFMSegmentor(model_cfg, dtype=torch.bfloat16)
    model.load_state_dict(state_dict, strict=True)
    model.to(device).train()
    state = TrainState.create(model, optim_cfg)
    step = make_train_step(model, state.optimizer, state.scheduler, mesh=mesh)
    tensors = {k: torch.from_numpy(v) for k, v in batch.items()}
    rows = (parallel.shard_clip_batch(tensors, mesh) if mesh is not None
            else parallel.shard_batch(tensors))
    rows = {k: v.to(device) for k, v in rows.items()}
    before = [p.detach().clone() for p in model.parameters()]
    torch.cuda.reset_peak_memory_stats(device)
    out = {"metrics": [], "host_ms": [], "counts": []}
    moments = heads.batch_moments
    heads.batch_moments = _own_moments if own_bn else moments
    try:
        for it in range(DIST_STEPS):
            prof = None
            if profile and it == DIST_STEPS - 1:
                from torch.profiler import ProfilerActivity

                prof = torch.profiler.profile(
                    activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            torch.cuda.synchronize(device)
            ops.reset_launches()
            t0 = time.perf_counter()
            with prof if prof is not None else contextlib.nullcontext():
                m = step(rows, torch.Generator(device).manual_seed(step_seed(SEED, it)))
                torch.cuda.synchronize(device)
            out["host_ms"].append((time.perf_counter() - t0) * 1e3)
            if prof is not None:
                from torch.autograd import DeviceType

                out["device_busy_ms"] = sum(
                    e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA and not e.is_user_annotation) / 1e3
            out["counts"].append(ops.launches())
            out["metrics"].append({k: v.item() for k, v in m.items()})
    finally:
        heads.batch_moments = moments
    out["peak_mib"] = torch.cuda.max_memory_allocated(device) / 2**20
    delta = torch.cat([(p.detach() - b).float().reshape(-1)
                       for p, b in zip(model.parameters(), before)])
    out["digest"] = (delta.double().sum().item(), delta.double().square().sum().item())
    if parallel.rank() == 0:
        out["delta"] = delta.cpu()
    bn = model.decode_head.linear_fuse.bn
    out["bn"] = torch.cat([bn.running_mean, bn.running_var]).cpu()
    grads = [p.grad.clone() for p in model.parameters() if p.grad is not None]
    out["grad_bytes"] = sum(g.numel() * g.element_size() for g in grads)
    if parallel.is_distributed() and not own_bn and mesh is None:
        out.update(_all_reduce_ms(grads, device))
    return out


@torch.no_grad()
def _dist_infer(device, model_cfg, state_dict: dict, clip: np.ndarray, mesh=None) -> dict:
    """The eval logits of the normalised clip ``clip`` (1, T, H, W, 3) f32 by the
    model of ``model_cfg`` (bf16) from ``state_dict``, on ``mesh`` from this
    rank's frames of it (``shard_clip_batch``): the logits (whole on every
    rank of the frames group), the launches of the forward and peak memory."""
    from vss_cffm_tpu_torch import ops, parallel
    from vss_cffm_tpu_torch.models import CFFMSegmentor

    model = CFFMSegmentor(model_cfg, dtype=torch.bfloat16)
    model.load_state_dict(state_dict, strict=True)
    model.to(device).eval()
    x = torch.from_numpy(clip)
    x = (parallel.shard_clip_batch(x, mesh) if mesh is not None else x).to(device)
    model(x, mesh=mesh)  # warm-up (cuDNN's choices)
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    ops.reset_launches()
    logits = model(x, mesh=mesh)
    torch.cuda.synchronize(device)
    return {"logits": logits.float().cpu(), "counts": ops.launches(),
            "peak_mib": torch.cuda.max_memory_allocated(device) / 2**20}


def _dist_ranks(device, model_cfg, state_dict: dict, batch: dict, optim_cfg, clip: np.ndarray,
                lovasz_cfg) -> dict:
    """On each rank: (a) the DIST_STEPS steps, then the same steps from the
    same weights with the fuse BN on the rank's own moments (``own_bn``);
    (e) a 1 x 2 clip mesh (``create_clip_mesh(2)``, the frames split over the
    two ranks): the eval logits of ``clip`` and the DIST_STEPS steps; (f) the
    steps with the Lovász loss (``lovasz_cfg``), each rank its rows."""
    from vss_cffm_tpu_torch import parallel

    args = (model_cfg, state_dict, batch, optim_cfg)
    out = {"sync": _dist_steps(device, *args), "own_bn": _dist_steps(device, *args, own_bn=True)}
    mesh = parallel.create_clip_mesh(2)
    out["frames_infer"] = _dist_infer(device, model_cfg, state_dict, clip, mesh)
    out["frames"] = _dist_steps(device, *args, mesh=mesh)
    out["lovasz"] = _dist_steps(device, lovasz_cfg, state_dict, batch, optim_cfg)
    return out


def _dist_readings(got: dict, want: dict) -> dict:
    """The largest departures over the steps of a world's rank 0 from the one
    process: relative loss and gradient norm, accuracy in points, the
    cosine of the parameter deltas, the fuse BN's statistics relative to
    their largest value."""
    rel = {k: max(abs(g[k] - w[k]) / abs(w[k]) for g, w in zip(got["metrics"], want["metrics"]))
           for k in ("loss_seg", "grad_norm")}
    return {**rel, "acc_seg": max(abs(g["acc_seg"] - w["acc_seg"])
                                  for g, w in zip(got["metrics"], want["metrics"])),
            "cos": torch.nn.functional.cosine_similarity(got["delta"].double(),
                                                         want["delta"].double(), dim=0).item(),
            "bn": (got["bn"] - want["bn"]).abs().max().item() / want["bn"].abs().max().item()}


def _dist_held(r: dict) -> bool:
    return (all(r[k] <= lim for k, lim in DIST_REL.items()) and r["acc_seg"] <= DIST_ACC
            and r["cos"] >= DIST_COS)


def _parallel():
    return importlib.import_module("vss_cffm_tpu_torch.parallel")


def _dist_launch(root: str, runs: dict) -> dict:
    """Each of ``runs`` ({log name: (script, args)}) started together:
    ``vss_cffm_tpu_torch/tools/<script>`` with ``args``, its output in
    ``chiprun_out/<log>``. Returns each output; raises with the output's end
    unless every run exits 0."""
    ports = set()
    while len(ports) < len(runs):
        ports.add(_parallel().free_port())
    os.makedirs(os.path.join(root, "chiprun_out"), exist_ok=True)
    ts, procs = time.perf_counter(), {}
    for (log, (script, args)), port in zip(runs.items(), sorted(ports)):
        env = {**os.environ, "PYTHON": sys.executable, "PORT": str(port)}
        for k in _parallel().RANK_ENV:
            env.pop(k, None)
        with open(os.path.join(root, "chiprun_out", log), "w") as f:
            procs[log] = subprocess.Popen(
                ["bash", os.path.join(root, "vss_cffm_tpu_torch", "tools", script), *args],
                env=env, stdout=f, stderr=subprocess.STDOUT, text=True)
    texts = {}
    try:
        for log, proc in procs.items():
            rc = proc.wait(timeout=600)
            with open(os.path.join(root, "chiprun_out", log)) as f:
                texts[log] = f.read()
            script, args = runs[log]
            print(f"[dist] {script} {' '.join(a for a in args if '/' not in a)}: exit {rc} "
                  f"(output in chiprun_out/{log})", flush=True)
            if rc:
                raise RuntimeError(f"[dist] {script} exited with {rc}:\n{texts[log][-4000:]}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    print(f"[dist] {len(runs)} launch(es) together in {time.perf_counter() - ts:.1f} s",
          flush=True)
    return texts


def _dist_train_held(text: str, work: str, what: str) -> None:
    """One checkpoint (step 2) and each ``iter [k/2]`` line once."""
    files = sorted(os.listdir(os.path.join(work, "ckpt")))
    lines = [text.count(f"iter [{k}/2]") for k in (1, 2)]
    saved = text.count("saved checkpoint at iter 2")
    print(f"[dist] {what}: checkpoint files {files}, 'iter [1/2]' / 'iter [2/2]' logged "
          f"{lines[0]} / {lines[1]} times, 'saved checkpoint' {saved}", flush=True)
    if files != ["ckpt_2.pt", "metadata_2.json"] or lines != [1, 1] or saved != 1:
        raise RuntimeError(f"[dist] {what}: the checkpoint or the log lines are not once each")


DIST_LOGITS_REL = 0.05        # the frames split's logits, of the largest (as [main])
DIST_PER_CLIP = {"mit_block_fused": 4, "cfm_attention": 2, "dwconv3x3": 4}


def _steps_checked(results: list, want: dict, plan: dict, what: str) -> dict:
    """Each rank's launches a step held to ``plan`` and its parameters to rank
    0's; rank 0's readings against the one-process ``want`` printed and held
    to the limits of (a). Returns the readings."""
    for r, res in enumerate(results):
        for s_, c in enumerate(res["counts"]):
            _launches_held(c, plan, f"[dist] {what} rank {r} step {s_ + 1}")
        if res["digest"] != results[0]["digest"]:
            raise RuntimeError(f"[dist] {what}: rank {r}'s parameters differ from rank 0's")
    rd = _dist_readings(results[0], want)
    for s_, (got, ref) in enumerate(zip(results[0]["metrics"], want["metrics"])):
        print(f"[dist] {what} step {s_ + 1}: loss_seg {got['loss_seg']:.6f} vs "
              f"{ref['loss_seg']:.6f}, acc_seg {got['acc_seg']:.4f} vs {ref['acc_seg']:.4f}, "
              f"grad_norm {got['grad_norm']:.6f} vs {ref['grad_norm']:.6f}", flush=True)
    print(f"[dist] {what}, against one process: loss_seg rel {rd['loss_seg']:.3e} (limit "
          f"{DIST_REL['loss_seg']:g}), grad_norm rel {rd['grad_norm']:.3e} (limit "
          f"{DIST_REL['grad_norm']:g}), fuse BN statistics {rd['bn']:.3e} of their largest "
          f"(limit {DIST_REL['bn']:g}), acc_seg {rd['acc_seg']:.4f} points (limit {DIST_ACC:g}), "
          f"cosine of the parameter deltas {rd['cos']:.6f} (limit {DIST_COS:g}): "
          f"{'held' if _dist_held(rd) else 'rejected'}; every rank's launches a step {plan}",
          flush=True)
    if not _dist_held(rd):
        raise RuntimeError(f"[dist] {what} disagrees with one process: {rd}")
    return rd


def _dist_frames_lovasz(ranks: list, one: dict, one_infer: dict, one_lovasz: dict, plan: dict,
                        smi: str) -> dict:
    """(e) and (f) of ``dist_phase``, from the ranks' results; returns their
    launch counts by path."""
    infer = [r["frames_infer"] for r in ranks]
    scale = one_infer["logits"].abs().max().item()
    _launches_held(one_infer["counts"], DIST_PER_CLIP, "[dist] (e) one process clip")
    for r, res in enumerate(infer):
        _launches_held(res["counts"], DIST_PER_CLIP, f"[dist] (e) frames split rank {r} clip")
        err = (res["logits"] - one_infer["logits"]).abs().max().item()
        print(f"[dist] (e) frames split 1 x 2 (2 of the 4 frames a rank), rank {r}: eval logits "
              f"{tuple(res['logits'].shape)} against one process max_abs_err {err:.3e}, "
              f"max|ref| {scale:.3e} (limit {DIST_LOGITS_REL:g} of it); launches a clip "
              f"{DIST_PER_CLIP}, as one process; peak {res['peak_mib']:.1f} MiB (one process "
              f"{one_infer['peak_mib']:.1f})", flush=True)
        if not torch.isfinite(res["logits"]).all() or err > DIST_LOGITS_REL * scale:
            raise RuntimeError(f"[dist] (e) rank {r}'s logits disagree: {err} > "
                               f"{DIST_LOGITS_REL * scale}")
    frames = [r["frames"] for r in ranks]
    _steps_checked(frames, one, plan, "(e) frames split 1 x 2, default steps")
    lovasz_plan = {**plan, "ce_upsampled_loss": 0, "ce_upsampled_loss_bwd": 0}
    lovasz = [r["lovasz"] for r in ranks]
    _steps_checked(lovasz, one_lovasz, lovasz_plan, "(f) Lovász at data 2")
    ms = lambda res: ", ".join(f"{g['host_ms'][-1]:.3f}" for g in res)
    mib = lambda res: ", ".join(f"{g['peak_mib']:.1f}" for g in res)
    print(f"[dist] (e) host ms a step (step {DIST_STEPS}): frames split {ms(frames)} (2 gloo "
          f"ranks on one card), one process {one['host_ms'][-1]:.3f}; peak a rank "
          f"{mib(frames)} MiB, one process {one['peak_mib']:.1f} MiB | {smi}", flush=True)
    print(f"[dist] (f) Lovász step: host ms (step {DIST_STEPS}) {ms(lovasz)} a rank, one "
          f"process {one_lovasz['host_ms'][-1]:.3f} (device busy "
          f"{one_lovasz['device_busy_ms']:.3f} ms, torch.profiler, the profiled step); peak a "
          f"rank {mib(lovasz)} MiB (the global batch's loss on each), one process "
          f"{one_lovasz['peak_mib']:.1f} MiB | {smi}", flush=True)
    summed = lambda res: {k: sum(c[k] for c in res["counts"]) for k in res["counts"][0]}
    out = {}
    for r in range(len(ranks)):
        out[f"dist_frames_infer_rank{r}"] = infer[r]["counts"]
        out[f"dist_frames_rank{r}"] = summed(frames[r])
        out[f"dist_lovasz_rank{r}"] = summed(lovasz[r])
    return out


def dist_phase(ops, root: str, smi: str, work_root: str, cffm_ckpt: str,
               one_process: dict) -> dict:
    """``[dist]``: CFFM-B1 (``configs/cffm_b1_vspw_160k.py``, 480x480, global batch
    2, bf16 compute, f32 parameters, drop path and head dropout 0.1) over
    several processes. (a) DIST_STEPS default steps in a group of one NCCL
    rank here and on 2 gloo ranks pinned to ``cuda:0`` (``parallel.spawn``),
    each on its rows of a fixed synthetic batch whose two clips differ in
    brightness and contrast, against the one-process steps here (no group)
    on the whole batch from the same generator seeds: loss, gradient norm
    and the fuse BN's running statistics within DIST_REL, accuracy within
    DIST_ACC points, the cosine of the parameter deltas ≥ DIST_COS, the
    ranks' parameters alike, each rank's launches a step the default
    form's; the 2 ranks then run the steps with the BN on each rank's own
    moments, which the check must reject; host ms a step in each world, the
    gradient all-reduce's ms and bytes under NCCL and gloo, peak memory a
    rank. Then, started together: (b) ``tools/dist_train.sh`` with 1 rank
    under NCCL and (c) with 2 gloo ranks on ``cuda:0``, 2 CLI steps from
    ``[train_cli]``'s checkpoint on ``[test_cli]``'s VSPW tree (its videos as
    the train split): one checkpoint, each ``iter`` line once; (d)
    ``tools/dist_test.sh`` with 2 gloo ranks on ``cuda:0``, streamed
    (``--out`` JSON: its metrics equal the one-process CLI's of
    ``[test_cli]``) and per clip (``--out`` pickle: the two shards hold
    every frame once, and their masks' confusion equals the one-process
    CLI's). Returns each rank's launches over the steps of (a)."""
    from vss_cffm_tpu_torch.config import LossConfig, load_config
    from vss_cffm_tpu_torch.data import VSPWVideoDataset
    from vss_cffm_tpu_torch.eval.metrics import confusion_matrix_np
    from vss_cffm_tpu_torch.models import CFFMSegmentor
    from vss_cffm_tpu_torch.train.step import device_normalize

    parallel = _parallel()
    t0 = time.perf_counter()
    path = os.path.join(root, "vss_cffm_tpu_torch", "configs", "cffm_b1_vspw_160k.py")
    cfg = load_config(path)
    if (cfg.model.backbone_config.drop_path_rate, cfg.model.head.dropout_ratio) != (0.1, 0.1):
        raise RuntimeError(f"[dist] the B1 config's drop rates {cfg.model}")
    init = CFFMSegmentor(cfg.model)
    init.init_weights(torch.Generator().manual_seed(SEED))
    state_dict = init.state_dict()
    del init
    rng = np.random.RandomState(SEED + 7)
    labels = rng.randint(0, NUM_CLASSES, (TRAIN_B, TRAIN_T, TRAIN_HW, TRAIN_HW)).astype(np.uint8)
    labels[rng.rand(*labels.shape) < 0.05] = 255
    imgs = rng.randint(0, 256, (TRAIN_B, TRAIN_T, TRAIN_HW, TRAIN_HW, 3)).astype(np.uint8)
    imgs[1] = imgs[1] // 4 + 16  # clip 1 dark and flat: a rank's own BN moments stand apart
    args = (cfg.model, state_dict, {"imgs": imgs, "labels": labels}, cfg.optim)
    plan = TRAIN_FORMS["train"]["per_step"]
    clip = device_normalize(torch.from_numpy(imgs[:1])).numpy()
    lovasz_cfg = dataclasses.replace(cfg.model, head=dataclasses.replace(
        cfg.model.head, loss=LossConfig(type="lovasz")))

    # (a) the step: one process here, then a group of one NCCL rank here, then
    # 2 gloo ranks sharing the card
    ta = time.perf_counter()
    one = _dist_steps(torch.device("cuda"), *args)
    parallel.init_distributed("cuda", "nccl", f"127.0.0.1:{parallel.free_port()}", 1, 0)
    try:
        nccl = _dist_steps(torch.device("cuda"), *args)
    finally:
        parallel.shutdown()
    # the one-process references of (e) and (f)
    one_infer = _dist_infer(torch.device("cuda"), cfg.model, state_dict, clip)
    one_lovasz = _dist_steps(torch.device("cuda"), lovasz_cfg, *args[1:], profile=True)
    torch.cuda.empty_cache()
    ranks = parallel.spawn(_dist_ranks, 2, *args, clip, lovasz_cfg, device="cuda:0",
                           backend="gloo")
    gloo = [r["sync"] for r in ranks]
    print(f"[dist] (a) CFFM-B1 480x480, global batch {TRAIN_B} clip-{TRAIN_T} (clip 1's pixels "
          f"x/4 + 16), bf16, {DIST_STEPS} default steps (drop path and head dropout 0.1) in one "
          f"process, in a group of one NCCL rank and on 2 gloo ranks on cuda:0 (with SyncBN, "
          f"then with each rank's own BN) in {time.perf_counter() - ta:.1f} s", flush=True)
    worlds = {"world 1": [one], "world 1, NCCL": [nccl], "world 2, gloo": gloo}
    for name, results in worlds.items():
        for r, res in enumerate(results):
            for s_, counts in enumerate(res["counts"]):
                _launches_held(counts, plan, f"[dist] {name} rank {r} step {s_ + 1}")
            if res["digest"] != results[0]["digest"]:
                raise RuntimeError(f"[dist] {name}: rank {r}'s parameters differ from rank 0's")
    for s_, (got, want) in enumerate(zip(gloo[0]["metrics"], one["metrics"])):
        print(f"[dist] (a) world 2 step {s_ + 1}: loss_seg {got['loss_seg']:.6f} vs "
              f"{want['loss_seg']:.6f}, acc_seg {got['acc_seg']:.4f} vs {want['acc_seg']:.4f}, "
              f"grad_norm {got['grad_norm']:.6f} vs {want['grad_norm']:.6f}", flush=True)
    readings = {"world 1, NCCL": _dist_readings(nccl, one),
                "world 2, gloo, SyncBN": _dist_readings(gloo[0], one),
                "world 2, gloo, each rank's own BN": _dist_readings(ranks[0]["own_bn"], one)}
    for name, rd in readings.items():
        print(f"[dist] (a) {name}, against one process: loss_seg rel {rd['loss_seg']:.3e} "
              f"(limit {DIST_REL['loss_seg']:g}), grad_norm rel {rd['grad_norm']:.3e} (limit "
              f"{DIST_REL['grad_norm']:g}), fuse BN statistics {rd['bn']:.3e} of their largest "
              f"(limit {DIST_REL['bn']:g}), acc_seg {rd['acc_seg']:.4f} points (limit "
              f"{DIST_ACC:g}), cosine of the parameter deltas {rd['cos']:.6f} (limit "
              f"{DIST_COS:g}): {'held' if _dist_held(rd) else 'rejected'}", flush=True)
    *sound, own = readings.values()
    if not all(_dist_held(rd) for rd in sound):
        raise RuntimeError(f"[dist] (a) a world disagrees with one process: {readings}")
    if _dist_held(own):
        raise RuntimeError(f"[dist] (a) the check passes a BN on each rank's own moments: {own}")
    print(f"[dist] (a) every rank's launches a step the default form's; ranks' parameters alike",
          flush=True)
    g0 = gloo[0]
    print(f"[dist] gradient all-reduce, {g0['grad_bytes']} bytes "
          f"({g0['grad_bytes'] / 1e6:.3f} MB) of f32 in one flat buffer: gloo, 2 ranks on one "
          f"card, all_reduce_mean_ {g0['all_reduce_mean_ms']:.3f} ms, the collective alone "
          f"{g0['collective_ms']:.3f} ms; NCCL, a group of one rank, all_reduce_mean_ "
          f"{nccl['all_reduce_mean_ms']:.4f} ms, the collective alone "
          f"{nccl['collective_ms']:.4f} ms (one rank: no multi-card figure) | {smi}", flush=True)
    gloo_mib = ", ".join(f"{g['peak_mib']:.1f}" for g in gloo)
    print(f"[dist] peak memory a rank: world 1 {one['peak_mib']:.1f} MiB, world 1 under NCCL "
          f"{nccl['peak_mib']:.1f} MiB, world 2 {gloo_mib} MiB | {smi}", flush=True)
    gloo_ms = ", ".join(f"{g['host_ms'][-1]:.3f}" for g in gloo)
    print(f"[dist] host ms a step (step {DIST_STEPS}, to a synchronize): world 1 "
          f"{one['host_ms'][-1]:.3f}, world 1 under NCCL {nccl['host_ms'][-1]:.3f}, world 2 "
          f"gloo {gloo_ms} (ranks 0, 1 sharing one card: no scaling figure) | {smi}", flush=True)
    counts = {f"dist_rank{r}": {k: sum(c[k] for c in g["counts"]) for k in g["counts"][0]}
              for r, g in enumerate(gloo)}
    counts.update(_dist_frames_lovasz(ranks, one, one_infer, one_lovasz, plan, smi))
    del one, nccl, gloo, ranks, one_infer, one_lovasz

    # (b), (c) the train CLI through dist_train.sh, from [train_cli]'s checkpoint
    # on [test_cli]'s tree, its videos as the train split, and (d) the test CLI
    # through dist_test.sh on [train_cli]'s checkpoint, all started together
    tree = one_process["tree"]
    shutil.copy(os.path.join(tree, "val.txt"), os.path.join(tree, "train.txt"))
    work = os.path.join(work_root, "dist")
    options = ["--load-from", cffm_ckpt, "--options", f"data.data_root={tree}", *DIST_OPTIONS]
    gloo_args = ["--device", "cuda:0", "--backend", "gloo"]
    out_json, out_pkl = os.path.join(work, "streamed.json"), os.path.join(work, "masks.pkl")
    texts = _dist_launch(root, {
        "dist_train_nccl.log": ("dist_train.sh", [
            path, "1", "--distributed", "--coordinator", f"127.0.0.1:{parallel.free_port()}",
            "--num-processes", "1", "--process-id", "0", "--device", "cuda", "--work-dir",
            os.path.join(work, "nccl"), *options]),
        "dist_train_gloo.log": ("dist_train.sh", [path, "2", *gloo_args, "--work-dir",
                                                  os.path.join(work, "gloo"), *options]),
        "dist_test_streamed.log": ("dist_test.sh", [
            path, cffm_ckpt, "2", *gloo_args, "--streaming", "--out", out_json, "--options",
            f"data.data_root={tree}"]),
        "dist_test_per_clip.log": ("dist_test.sh", [
            path, cffm_ckpt, "2", *gloo_args, "--out", out_pkl, "--options",
            f"data.data_root={tree}"])})
    _dist_train_held(texts["dist_train_nccl.log"], os.path.join(work, "nccl"),
                     "(b) 1 rank under NCCL")
    _dist_train_held(texts["dist_train_gloo.log"], os.path.join(work, "gloo"),
                     "(c) 2 gloo ranks on cuda:0")

    ds = VSPWVideoDataset(tree, "val", dilation=cfg.data.dilation, img_scale=cfg.data.img_scale)
    with open(out_json) as f:
        got = json.load(f)
    want = {k: one_process["streamed"]["metrics"][k] for k in got}
    same = json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    print(f"[dist] (d) streamed, 2 ranks (a video each): JSON metrics {sorted(got)} "
          f"{'equal' if same else 'DIFFER FROM'} the one-process CLI's (mIoU {got['mIoU']:.6f}; "
          f"VC8 / VC16 are each rank's own videos', not asked for)", flush=True)
    if not same or set(got) & {"VC8", "VC16"}:
        raise RuntimeError(f"[dist] (d) streamed metrics {got} != {want}")
    shards = []
    for r in range(2):
        with open(f"{out_pkl}.rank{r}", "rb") as f:
            shards.append(pickle.load(f))
    if [len(sh) for sh in shards] != [len(range(r, len(ds), 2)) for r in range(2)]:
        raise RuntimeError(f"[dist] (d) pickle shards of {[len(sh) for sh in shards]} masks "
                           f"for {len(ds)} frames")
    cm = sum(confusion_matrix_np(shards[i % 2][i // 2], ds.load_gt(i), NUM_CLASSES)
             for i in range(len(ds)))
    same = np.array_equal(cm, one_process["per_clip"]["confusion"])
    print(f"[dist] (d) per clip, 2 ranks (every other frame): pickle shards of "
          f"{[len(sh) for sh in shards]} masks hold the {len(ds)} frames; their confusion "
          f"(total {int(cm.sum())}) {'equals' if same else 'DIFFERS FROM'} the one-process "
          f"CLI's", flush=True)
    if not same:
        raise RuntimeError("[dist] (d) per clip: the ranks' masks give another confusion")
    torch.cuda.empty_cache()
    print(f"[dist] done in {time.perf_counter() - t0:.1f} s | {smi}", flush=True)
    return counts


# ---- [tools]: the measuring and publishing tools on the card -----------------

TOOLS_CLIP_ITERS = 50          # benchmark's clip inference (+ its 5 warm-up calls)
TOOLS_STREAM_ITERS = 50        # --streaming (+ 2 warm-up calls of each half)
TOOLS_TRAIN_ITERS = 10         # --train (+ 3 warm-up steps), batch 2 (a GPU's share)
TOOLS_PROFILE_ITERS = 10       # profile_forward (+ 1 call outside the window)
TOOLS_LOADER_BATCHES = 10
TOOLS_DYN_STEPS = 60
# the kernels of rows 1, 2 and 3 by their CUDA names: row 1's GEMM, its
# SRA attention (head dim 64, no bias) and its FFN launch, row 2 the CFM attention (head dim 32,
# bias and mask), row 3 the depthwise conv
PROFILE_ROWS = {"row 1": ("gemm_kernel", "attention_fwd_kernel<64", "ffn_fused_kernel"),
                "row 2": ("attention_fwd_kernel<32",), "row 3": ("dwconv3x3_kernel",)}


def _scaled(plan: dict, n: int) -> dict:
    return {k: v * n for k, v in plan.items()}


def tools_phase(ops, root: str, smi: str, cffm_ckpt: str, one_process: dict) -> dict:
    """``[tools]``: the port's tools as a user runs them, in process:
    ``benchmark`` (clip inference at 480x864, ``--streaming``, ``--train`` at
    batch 2) with the launches of each held to the path's per clip, frame
    and step; ``profile_forward`` (B1, 480x480), whose top entries must name
    the kernels of rows 1-3 (``PROFILE_ROWS``); ``get_flops`` of B1;
    ``benchmark_loader``; ``publish_model`` on ``[train_cli]``'s checkpoint,
    then the test CLI on the published checkpoint, whose confusion must
    equal ``[test_cli]``'s on the source exactly; ``bf16_dynamics`` (B0,
    64x64): both trajectories finite, and in each the mean of the last 20
    losses below that of the first 10. Returns the launch counts by path."""
    from vss_cffm_tpu_torch.tools import (benchmark, benchmark_loader, bf16_dynamics,
                                          get_flops, profile_forward, publish_model)
    from vss_cffm_tpu_torch.tools import test as test_cli

    t0 = time.perf_counter()
    b1 = os.path.join(root, "vss_cffm_tpu_torch", "configs", "cffm_b1_vspw_160k.py")
    counts = {}

    def counted(name: str, fn, want: dict | None):
        torch.cuda.synchronize()
        ops.reset_launches()
        ts = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - ts
        counts[name] = ops.launches()
        if want is not None:
            _launches_held(counts[name], want, f"[tools] {name}")
        return out, dt

    clip_plan = {**DIST_PER_CLIP, "attention_fwd_tiled": 0}
    out, dt = counted("tools_benchmark_clip", lambda: benchmark.main(
        [b1, "--iters", str(TOOLS_CLIP_ITERS)]), _scaled(clip_plan, TOOLS_CLIP_ITERS + 5))
    clip_fps = out["fps"]
    print(f"[tools] benchmark.py clip inference, CFFM-B1 480x864 batch 1: {out['fps']:.3f} "
          f"clips/s ({1e3 / out['fps']:.3f} ms a clip, CUDA events, the fastest chunk of "
          f"{TOOLS_CLIP_ITERS}); launches {clip_plan} a clip over {TOOLS_CLIP_ITERS + 5} clips; "
          f"{dt:.1f} s | {smi}", flush=True)
    calls = TOOLS_STREAM_ITERS + 2
    stream_plan = {"mit_block_fused": 4 * calls, "dwconv3x3": 4 * calls,
                   "cfm_attention": 2 * calls, "attention_fwd_tiled": 0}
    out, dt = counted("tools_benchmark_streaming", lambda: benchmark.main(
        [b1, "--streaming", "--iters", str(TOOLS_STREAM_ITERS)]), stream_plan)
    print(f"[tools] benchmark.py --streaming, CFFM-B1 480x864: frame_features "
          f"{out['frame_features_ms']} ms, predict {out['predict_ms']} ms, "
          f"{out['frames_per_sec']} frames/s; launches 4 / 4 a frame's features (rows 1, 3) "
          f"and 2 a prediction (row 2) over {calls} calls each; {dt:.1f} s | {smi}", flush=True)
    steps = TOOLS_TRAIN_ITERS + 3
    out, dt = counted("tools_benchmark_train", lambda: benchmark.main(
        [b1, "--train", "--batch", "2", "--iters", str(TOOLS_TRAIN_ITERS)]),
        _scaled(TRAIN_FORMS["train"]["per_step"], steps))
    print(f"[tools] benchmark.py --train, CFFM-B1 480x480 batch 2 clip 4: "
          f"{out['train_ms_per_iter']} ms a step, {out['frames_per_sec']} train frames/s, "
          f"loss {out['loss']}; launches the default form's a step over {steps} steps; "
          f"{dt:.1f} s | {smi}", flush=True)

    out, dt = counted("tools_profile_forward", lambda: profile_forward.main(
        ["--variant", "b1", "--iters", str(TOOLS_PROFILE_ITERS), "--top", "30"]),
        _scaled(clip_plan, TOOLS_PROFILE_ITERS + 1))
    names = [name for name, *_ in out["top"]]
    found = {row: [next((n for n in names if key in n), None) for key in keys]
             for row, keys in PROFILE_ROWS.items()}
    print(f"[tools] profile_forward.py CFFM-B1 480x480, {TOOLS_PROFILE_ITERS} clips: device "
          f"{out['per_iter_us']:.1f} us a clip; the top 30 name "
          + "; ".join(f"{row}: {', '.join(str(n)[:60] for n in ns)}" for row, ns in found.items())
          + f"; {dt:.1f} s | {smi}", flush=True)
    if out["kind"] != "device" or any(n is None for ns in found.values() for n in ns):
        raise RuntimeError(f"[tools] profile_forward's top entries miss a kernel of rows 1-3: "
                           f"{found}")

    flops = get_flops.main([b1, "--shape", "480", "864"])
    print(f"[tools] get_flops.py CFFM-B1 4x480x864: {flops['total'] / 1e9:.2f} GFLOPs a clip; "
          f"at benchmark.py's {clip_fps:.3f} clips/s, {flops['total'] * clip_fps / 1e12:.3f} "
          f"TFLOP/s achieved ({flops['total'] * clip_fps / 989e12:.4f} of 989 TFLOP/s bf16) "
          f"| {smi}", flush=True)

    out, dt = counted("tools_benchmark_loader", lambda: benchmark_loader.main(
        ["--batches", str(TOOLS_LOADER_BATCHES)]), None)
    print(f"[tools] benchmark_loader.py, 480x853 JPEGs, 2-clip batches, 4 threads, "
          f"{TOOLS_LOADER_BATCHES} batches: {out['clips_per_s']:.3f} clips/s, "
          f"{out['frames_per_s']:.3f} frames/s (to the card); {dt:.1f} s | {smi}", flush=True)

    published = publish_model.publish(cffm_ckpt, os.path.join(os.path.dirname(cffm_ckpt),
                                                              "published", "cffm_b1"))
    tree = one_process["tree"]
    out, dt = counted("tools_test_cli_published", lambda: test_cli.main(
        [one_process["config"], published, "--vc", "--options", f"data.data_root={tree}"]),
        None)
    same = np.array_equal(out["confusion"], one_process["per_clip"]["confusion"])
    print(f"[tools] publish_model.py {os.path.basename(published)} (files "
          f"{sorted(os.listdir(published))}); tools/test.py per clip on it: confusion (total "
          f"{int(out['confusion'].sum())}) {'equals' if same else 'DIFFERS FROM'} the source "
          f"checkpoint's in [test_cli]; {dt:.1f} s", flush=True)
    if not same:
        raise RuntimeError("[tools] the published checkpoint gives another confusion")

    out, dt = counted("tools_bf16_dynamics", lambda: bf16_dynamics.main(
        ["--steps", str(TOOLS_DYN_STEPS), "--hw", "64"]), None)
    for run in ("f32", "bf16"):
        losses = out[run]["losses"]
        first, last = float(np.mean(losses[:10])), float(np.mean(losses[-20:]))
        print(f"[tools] bf16_dynamics.py {run} run, B0 64x64, {TOOLS_DYN_STEPS} steps: first 10 "
              f"{first:.4f}, last 20 {last:.4f}, mIoU_seen {out[run]['mIoU_seen']:.4f}",
              flush=True)
        if not np.isfinite(losses).all() or not last < first:
            raise RuntimeError(f"[tools] bf16_dynamics: the {run} run did not learn ({first} "
                               f"-> {last}) or is not finite")
    launched = {k: v for k, v in counts["tools_bf16_dynamics"].items() if v}
    print(f"[tools] bf16_dynamics.py launches (the bf16 run's: the f32 run asks for the plain "
          f"versions): {launched}; {dt:.1f} s | {smi}", flush=True)
    for name in ("mit_block_fused", "cfm_attention", "cfm_attention_bwd", "dwconv3x3",
                 "mit_block_train", "mit_block_train_bwd", "ce_upsampled_loss",
                 "ce_upsampled_loss_bwd"):
        if not launched.get(name):
            raise RuntimeError(f"[tools] bf16_dynamics's bf16 run launched no {name}")
    torch.cuda.empty_cache()
    print(f"[tools] done in {time.perf_counter() - t0:.1f} s | {smi}", flush=True)
    return counts


# ---- [export]: the clip forward through tools/export.py, reloaded apart --------

EXPORT_CONFIG = os.path.join("vss_cffm_tpu_torch", "configs", "cffm_b1_vspw_160k.py")
EXPORT_HW = (480, 480)
# rows 1 / 2 / 3 in the graph and in a reloaded clip's launches
EXPORT_PLAN = {"mit_block_fused": 4, "cfm_attention": 2, "dwconv3x3": 4}
EXPORT_REL = 1e-3              # reloaded vs live logits, of the live forward's largest
EXPORT_ROUNDS, EXPORT_CLIPS = 3, 10
DROP_RATE = 0.1

# run by a process that imports only the ops: argv = program, clip, output
_RELOAD = """
import json, sys, time
import torch
import vss_cffm_tpu_torch.ops as ops
t0 = time.perf_counter()
program = torch.export.load(sys.argv[1]).module()
load_s = time.perf_counter() - t0
x = torch.load(sys.argv[2]).cuda()
with torch.no_grad():
    program(x)
    torch.cuda.synchronize()
    ops.reset_launches()
    out = program(x)
    torch.cuda.synchronize()
torch.save(out.cpu(), sys.argv[3])
print(json.dumps({"launches": ops.launches(), "load_s": load_s,
                  "modules": sorted(m for m in sys.modules if m.startswith("vss_cffm_tpu_torch"))}))
"""


def _host_ms_rounds(runs: dict, x: torch.Tensor) -> dict:
    """Host ms a clip of each callable, EXPORT_ROUNDS rounds of EXPORT_CLIPS
    clips up to a synchronize, alternating their order round by round."""
    ms = {name: [] for name in runs}
    with torch.no_grad():
        for fn in runs.values():
            fn(x)
        for r in range(EXPORT_ROUNDS):
            for name in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
                torch.cuda.synchronize()
                ts = time.perf_counter()
                for _ in range(EXPORT_CLIPS):
                    runs[name](x)
                torch.cuda.synchronize()
                ms[name].append((time.perf_counter() - ts) * 1e3 / EXPORT_CLIPS)
    return ms


def _cast_device_ms(fn, x: torch.Tensor) -> tuple[float, float, int]:
    """(device busy ms, device ms under ``aten::_to_copy``, its calls) of one
    clip, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        fn(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn(x)
            torch.cuda.synchronize()
    events = prof.key_averages()
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation) / 1e3
    casts = [e for e in events if e.key == "aten::_to_copy"]
    return (busy, sum(e.device_time_total for e in casts) / 1e3, sum(e.count for e in casts))


def _dispatch_us(ops, x, k, b, calls: int = 2000) -> tuple[float, float]:
    """Host µs of one ``dwconv3x3`` call (the custom op's dispatch, the
    wrapper, its checks, allocation and ctypes call) and of the bare launch
    function at the same input, both with the C entry's no-launch twin in
    place (``_dwconv_host_us``), in alternating halves."""
    from vss_cffm_tpu_torch.ops import _build

    dw = importlib.import_module("vss_cffm_tpu_torch.ops.dwconv")
    calls_of = {"op": lambda: ops.dwconv3x3(x, k, b, gelu=True),
                "bare": lambda: dw.dwconv3x3_launch(x, k, b, True)}
    real, count = dw._c_entry(), ops.dwconv3x3.launches
    dw._entry["dwconv3x3_nhwc"] = _build.library("dwconv").dwconv3x3_nhwc_nolaunch
    us = {name: 0.0 for name in calls_of}
    try:
        with torch.no_grad():
            for order in (("op", "bare"), ("bare", "op")):
                for name in order:
                    fn = calls_of[name]
                    for _ in range(50):
                        fn()
                    torch.cuda.synchronize()
                    ts = time.perf_counter()
                    for _ in range(calls // 2):
                        fn()
                    us[name] += (time.perf_counter() - ts) * 1e6 / calls
    finally:
        dw._entry["dwconv3x3_nhwc"] = real
        ops.dwconv3x3.launches = count  # nothing was launched
    return us["op"], us["bare"]


def _dropout_steps(ops) -> dict:
    """One default train step of CFFM-B1 with MiT ``drop_rate`` and
    ``attn_drop_rate`` and the decoder's ``drop`` and ``attn_drop`` at
    DROP_RATE, twice from the same weights and generator seed: a finite
    loss, the MiT blocks composed (rows 6 / 7 not launched) and the
    decoder's attention on its probabilities path (rows 2 / 4 not
    launched), the same loss both times. Returns the first step's launches."""
    from vss_cffm_tpu_torch import apis
    from vss_cffm_tpu_torch.config import MIT_VARIANTS, OptimConfig, build_model_config
    from vss_cffm_tpu_torch.train import TrainState, make_train_step

    # the MiT rates come from the variant's registry entry, as in the JAX package
    name = "mit_b1_dropout"
    MIT_VARIANTS[name] = dataclasses.replace(MIT_VARIANTS["mit_b1"], drop_rate=DROP_RATE,
                                             attn_drop_rate=DROP_RATE)
    batch = _synthetic_train_batch(SEED + 1)
    losses, counts = [], None
    try:
        cfg = build_model_config("b1")
        cfg = dataclasses.replace(cfg, backbone=name, head=dataclasses.replace(
            cfg.head, decoder=dataclasses.replace(cfg.head.decoder, drop=DROP_RATE,
                                                  attn_drop=DROP_RATE)))
        for run in range(2):
            model = apis.init_segmentor(cfg, device="cuda", dtype=torch.bfloat16,
                                        seed=SEED).model.train()
            state = TrainState.create(model, OptimConfig())
            step = make_train_step(model, state.optimizer, state.scheduler)
            torch.cuda.synchronize()
            ops.reset_launches()
            ts = time.perf_counter()
            m = step(batch, torch.Generator("cuda").manual_seed(SEED))
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - ts) * 1e3
            losses.append(m["loss_seg"].item())
            counts = counts or ops.launches()
            print(f"[dropout] run {run}: loss_seg {losses[-1]!r} acc_seg {m['acc_seg'].item():.6f} "
                  f"grad_norm {m['grad_norm'].item():.6f}; host ms of the step (the first of a "
                  f"model: cuDNN and allocator warm-up included) {step_ms:.1f}", flush=True)
            del model, state, step
    finally:
        del MIT_VARIANTS[name]
    print(f"[dropout] CFFM-B1 480x480 B={TRAIN_B} clip-{TRAIN_T} bf16, MiT drop_rate = "
          f"attn_drop_rate = decoder drop = attn_drop = {DROP_RATE}, train_block_impl "
          f"{cfg.train_block_impl}: launches of one step {counts}", flush=True)
    if not np.isfinite(losses[0]):
        raise RuntimeError(f"dropout step: loss {losses[0]}")
    zero = ("mit_block_train", "mit_block_train_bwd", "cfm_attention", "cfm_attention_bwd")
    if any(counts[k] for k in zero) or counts["dwconv3x3"] != 8:
        raise RuntimeError(f"dropout step: launches {counts}; expected rows 6 / 7 / 2 / 4 at 0 "
                           "(composed blocks, the probabilities path) and dwconv3x3 8")
    print(f"[dropout] the same loss from the same generator seed: {losses[0]!r} vs "
          f"{losses[1]!r} (bitwise {losses[0] == losses[1]})", flush=True)
    if losses[0] != losses[1]:
        raise RuntimeError(f"dropout step: losses {losses} differ from one generator seed")
    return counts


def export_phase(ops, root: str, smi: str, work_root: str) -> dict:
    """``[export]``: CFFM-B1 at full widths (random weights from SEED as a
    ``.pth``) through ``tools/export.py``'s ``main`` with ``--verify`` on a
    480x480 clip of 4 frames in bf16; the graph's custom ops and the live
    and reloaded launches held to EXPORT_PLAN; a process that imports only
    the ops reloads the program and runs the clip (launches held, logits
    within EXPORT_REL of the live forward's largest); host ms a clip of the
    program against the live forward in alternating rounds; the weight
    casts' device time in the program; the custom op's dispatch µs; then
    the dropout step (``_dropout_steps``). Returns the launches by path."""
    from vss_cffm_tpu_torch import apis
    from vss_cffm_tpu_torch.tools import export

    t0 = time.perf_counter()
    config = os.path.join(root, EXPORT_CONFIG)
    ckpt, out = os.path.join(work_root, "export_b1.pth"), os.path.join(work_root, "b1.pt2")
    torch.save(apis.init_segmentor(config, device="cuda", seed=SEED).model.state_dict(), ckpt)
    ts = time.perf_counter()
    res = export.main([config, ckpt, out, "--shape", *map(str, EXPORT_HW), "--verify"])
    tool_s = time.perf_counter() - ts
    plan = {f"vss_cffm::{k}": v for k, v in EXPORT_PLAN.items()}
    print(f"[export] tools/export.py {EXPORT_CONFIG} --shape {EXPORT_HW[0]} {EXPORT_HW[1]} "
          f"--verify: {tool_s:.1f} s (export, save, reload, two verify clips); {res['mb']:.1f} "
          f"MB; graph {res['graph_ops']}; live launches {res['live_launches']}, reloaded "
          f"{res['reloaded_launches']}; reloaded vs live max_abs_err={res['max_abs_err']:.3e} "
          f"of max|live| {res['max_abs_live']:.3e}, bitwise equal {res['bitwise']}", flush=True)
    if res["graph_ops"] != plan:
        raise RuntimeError(f"export: graph custom ops {res['graph_ops']}, expected {plan}")
    for what in ("live_launches", "reloaded_launches"):
        got = {k: v for k, v in res[what].items() if k in EXPORT_PLAN}
        if got != EXPORT_PLAN:
            raise RuntimeError(f"export: {what} {res[what]}, expected {EXPORT_PLAN}")
    if not res["max_abs_err"] <= EXPORT_REL * res["max_abs_live"]:
        raise RuntimeError(f"export: reloaded logits {res['max_abs_err']} from the live ones")

    bundle = apis.init_segmentor(config, checkpoint=ckpt, device="cuda")
    model = bundle.model
    x = torch.from_numpy(np.random.RandomState(SEED).randn(1, 4, *EXPORT_HW, 3)
                         .astype(np.float32)).cuda()
    module = res["program"]
    nodes = [n for n in module.graph.nodes if n.op == "call_function"]
    n_to = sum(1 for n in nodes if str(n.target).startswith("aten.to"))
    with torch.no_grad():
        live = model(x)
    xin = os.path.join(work_root, "export_clip.pt")
    yout = os.path.join(work_root, "export_out.pt")
    torch.save(x.cpu(), xin)
    ts = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", _RELOAD, out, xin, yout], capture_output=True,
                       text=True, timeout=600, env=dict(os.environ, PYTHONPATH=root))
    if r.returncode != 0:
        raise RuntimeError(f"export: the reloading process failed:\n{r.stderr[-4000:]}")
    sub = json.loads(r.stdout.strip().splitlines()[-1])
    got = torch.load(yout).cuda()
    err = (got.float() - live.float()).abs().max().item()
    scale = live.float().abs().max().item()
    reloaded = {k: v for k, v in sub["launches"].items() if v}
    print(f"[export] a process importing only vss_cffm_tpu_torch.ops (modules "
          f"{sub['modules']}) reloaded the program in {sub['load_s']:.2f} s and ran the clip "
          f"in {time.perf_counter() - ts:.1f} s of wall time (process start included): "
          f"launches {reloaded}; logits {tuple(got.shape)} vs live max_abs_err={err:.3e} "
          f"max|live|={scale:.3e} (limit {EXPORT_REL} of it), bitwise equal "
          f"{bool(torch.equal(got, live))}", flush=True)
    if any(m.startswith("vss_cffm_tpu_torch.models") for m in sub["modules"]):
        raise RuntimeError("export: the reloading process imported the model code")
    if {k: v for k, v in reloaded.items() if k in EXPORT_PLAN} != EXPORT_PLAN:
        raise RuntimeError(f"export: the reloaded program launched {reloaded}")
    if not err <= EXPORT_REL * scale or not torch.isfinite(got.float()).all():
        raise RuntimeError(f"export: reloaded logits {err} from the live ones")

    ms = _host_ms_rounds({"program": module, "live": model}, x)
    med = {k: float(np.median(v)) for k, v in ms.items()}
    print(f"[export] CFFM-B1 480x480 clip-4 bf16, host ms a clip (to a synchronize), "
          f"{EXPORT_ROUNDS} rounds of {EXPORT_CLIPS} alternating: exported program "
          f"{med['program']:.3f} ({', '.join(f'{v:.3f}' for v in ms['program'])}), live "
          f"forward {med['live']:.3f} ({', '.join(f'{v:.3f}' for v in ms['live'])}); "
          f"program/live {med['program'] / med['live']:.3f} | {smi}", flush=True)
    busy_p, cast_p, n_cast_p = _cast_device_ms(module, x)
    busy_l, cast_l, n_cast_l = _cast_device_ms(model, x)
    print(f"[export] one clip under torch.profiler: exported program device busy "
          f"{busy_p:.3f} ms, aten::_to_copy {n_cast_p} calls {cast_p:.3f} device ms (the graph "
          f"holds {n_to} aten.to* nodes of {len(nodes)}); live forward device busy {busy_l:.3f} "
          f"ms, aten::_to_copy {n_cast_l} calls {cast_l:.3f} device ms (its casts kept by "
          f"derived())", flush=True)
    xs, k, b = _capture_main_path_inputs(model, x)["dwconv3x3"][0]
    op_us, bare_us = _dispatch_us(ops, xs, k, b)
    print(f"[export] dwconv3x3 at x{tuple(xs.shape)}, the launch replaced by nothing: "
          f"custom op {op_us:.2f} host us a call, bare launch function {bare_us:.2f}: "
          f"dispatch {op_us - bare_us:.2f} us | {smi}", flush=True)
    del bundle, model, module, live, got, res
    torch.cuda.empty_cache()
    counts = {"export_reloaded": sub["launches"], "dropout_step": _dropout_steps(ops)}
    torch.cuda.empty_cache()
    print(f"[export] done in {time.perf_counter() - t0:.1f} s | {smi}", flush=True)
    return counts


# ---- the CE microbench: its six kernels at its own inputs --------------------

CE_BENCH_N = (8, 2)  # the train step's frames, and one clip's branch
CE_BENCH_HW = (120, 120)  # the logits of a 480x480 frame


def _ce_bench_fwd_case(ops, rec):
    """Row 14 (natural labels) or 16, 18 (w-major labels) at the bench's inputs:
    row 14's bound, yardstick and wsum tolerance (the label layouts differ
    only in where the same bytes lie); corr exactly: the bench's fixed
    inputs hold no near-tie that the kernels' lerps and F.interpolate's
    split."""
    bench, inp = rec
    case = _ce_case(ops, (inp["logits"], inp["labels"], inp["s"], inp["img_w"], True))
    case["call"] = _bench_ce().cases(inp)[bench][1]
    case["shape"] += f" {bench}"
    row14 = case["compare"]
    case["compare"] = lambda got, want: [
        (label, err, 0.0 if label == "corr" else tol) for label, err, tol in row14(got, want)]
    return case


def _ce_bench_bwd_case(ops, rec):
    """Row 17 (natural labels, bf16 out) or 15, 19 (phase labels, f32 out)."""
    bench, inp = rec
    case = _ce_bwd_case(ops, (inp["logits"], inp["labels"], inp["ct"], inp["s"], inp["img_w"]),
                        out_bytes=4 if bench != "v5 bwd" else 2)
    case["call"] = _bench_ce().cases(inp)[bench][1]
    case["shape"] += f" {bench}"
    return case


def _bench_ce():
    return importlib.import_module("vss_cffm_tpu_torch.tools.bench_ce")


# f32 dlogits from the same terms summed in other orders, the lerp rounded as
# F.interpolate rounds it: 2^-14 of the largest value
CE_F32_REL = 2.0 ** -14
CE_BENCH_KERNELS = {
    "ce_upsampled_loss": dict(bench="v2 fwd", case=_ce_bench_fwd_case),
    "ce_bwd_loss_v2": dict(
        sources=["vss_cffm_tpu_torch/csrc/ce_upsampled.cu"],
        replaces="vss_cffm_tpu/ops/ce_upsampled.py:470",  # _bwd_loss_kernel, called at :599
        bench="v2 bwd", rel_tol=CE_F32_REL, case=_ce_bench_bwd_case),
    "ce_fwd_loss_v5": dict(
        sources=["vss_cffm_tpu_torch/csrc/ce_upsampled.cu"],
        replaces="vss_cffm_tpu/ops/ce_upsampled.py:671",  # _fwd_loss_kernel5, called at :743
        bench="v5 fwd", case=_ce_bench_fwd_case),
    # bf16 dlogits, as in the train step: one ulp
    "ce_upsampled_loss_bwd": dict(bench="v5 bwd", rel_tol=2.0 ** -7, case=_ce_bench_bwd_case),
    "ce_fwd_loss_v3": dict(
        sources=["vss_cffm_tpu_torch/csrc/ce_upsampled.cu"],
        replaces="vss_cffm_tpu/ops/ce_upsampled.py:917",  # _fwd_loss_kernel3, called at :999
        bench="v3 fwd", case=_ce_bench_fwd_case),
    "ce_bwd_loss_v3": dict(
        sources=["vss_cffm_tpu_torch/csrc/ce_upsampled.cu"],
        replaces="vss_cffm_tpu/ops/ce_upsampled.py:1020",  # _bwd_loss_kernel3, called at :1148
        bench="v3 bwd", rel_tol=CE_F32_REL, case=_ce_bench_bwd_case),
}
CE_BENCH_ITERS, CE_BENCH_CHUNK, CE_BENCH_WARMUP = 20, 10, 2


def ce_bench_phase(ops, opts) -> tuple[dict, dict]:
    """The port's CE microbench at N 8 with the launch counts held, then its
    six kernels against their plain versions at N 8 and N 2."""
    bench_ce = _bench_ce()
    argv = ["--n", str(CE_BENCH_N[0]), "--hw", *map(str, CE_BENCH_HW),
            "--c", str(NUM_CLASSES), "--iters", str(CE_BENCH_ITERS), "--chunk", str(CE_BENCH_CHUNK)]
    print(f"[ce_bench] python -m vss_cffm_tpu_torch.tools.bench_ce {' '.join(argv)}", flush=True)
    torch.cuda.synchronize()
    ops.reset_launches()
    times = bench_ce.main(argv)
    torch.cuda.synchronize()
    counts = ops.launches()
    print(f"[ce_bench] launches: {counts}", flush=True)
    calls = CE_BENCH_WARMUP + CE_BENCH_ITERS // CE_BENCH_CHUNK * CE_BENCH_CHUNK
    for name in CE_BENCH_KERNELS:
        if counts[name] != calls:
            raise RuntimeError(f"ce_bench: {name} launched {counts[name]} times, expected {calls}")
    if sum(counts.values()) != calls * len(CE_BENCH_KERNELS) or len(times) != 6:
        raise RuntimeError(f"ce_bench: other launches or lines than its six kernels' ({counts})")
    inputs = [bench_ce.make_inputs(n, CE_BENCH_HW, NUM_CLASSES, 4, "cuda") for n in CE_BENCH_N]
    caught = {name: [(spec["bench"], inp) for inp in inputs]
              for name, spec in CE_BENCH_KERNELS.items()}
    stats = check_kernels(ops, caught, CE_BENCH_KERNELS, opts.profile)
    del inputs, caught
    torch.cuda.empty_cache()
    return stats, counts


# kernels that only row 7's backward launches in the default step (the
# backward's block_gemm instance is named by its Bwd tag; the FFN half's
# launch and its split pass by ffn_bwd); the launches that FFN launch
# replaced (dz_dhid, and the d_z / d_hid pair dgelu_dz, dwconv_t before
# them) are listed too, so that the profile of an older tree reads the same
# way
ROW7_KERNELS = ("ffn_bwd", "sra_attention_bwd_kernel", "gemm_tn_kernel", "dz_dhid_kernel",
                "dgelu_dz_kernel", "dwconv_t_kernel", "ln_bwd_kernel", "::Bwd")
# row 6's launches in the default step: the forward's block_gemm instance
# (Fwd tag), the attention without bias and mask (the MiT blocks'
# spatial-reduction attention) and the FFN launch with its split pass (the
# depthwise conv on the f32 hidden map of older trees too)
ROW6_KERNELS = ("::Fwd", "attention_fwd_kernel<64, false>", "ffn_fused_kernel",
                "ffn_reduce_kernel", "dwconv3x3_kernel<float>")


# ---- the eval phase: video evaluation at VSPW's eval geometry ----------------

EVAL_FRAMES = 32
EVAL_HW = (480, 853)           # a VSPW 480p frame
EVAL_SCALE = (853, 480)        # img_scale: the network sees 480x864
EVAL_INPUT_HW = (480, 864)
EVAL_CROP, EVAL_STRIDE, EVAL_SLIDE_CROPS = (480, 480), (320, 320), 3
EVAL_ROUNDS = 3
EVAL_CLIP_TARGET = 9           # the first target frame past the early schedules
EVAL_SLIDE_FRAMES = (9, 10)
EVAL_TTA_FRAMES = (9, 10)
# the key-tiled attention's cases: (N, C, heads, query rows a frame, what);
# 4 frames a clip
TILED_CASES = ((920, 128, 2, 92 * 160, "stage 2 at TTA 1.5x (736x1280)"),
               (1269, 128, 2, 108 * 188, "stage 2 at TTA 1.75x (864x1504)"),
               (1269, 320, 5, 54 * 94, "stage 3 at TTA 1.75x"),
               (2048, 320, 5, 4 * 2048, "stage 3 widths at the fused block's limit"))
# where both instances run: stage 2 at 480x864
TILED_RESIDENT_CASE = (405, 128, 2, 60 * 108, "stage 2 at 480x864")


def _synthetic_video(seed: int, dilation=(-9, -6, -3)):
    """One video of EVAL_FRAMES frames of 480x853 uint8 BGR in memory, with
    the VSPW test dataset's interface (``VSPWVideoDataset``'s samplers and
    items at ``dilation``; frames and labels read from memory): a pattern
    that moves from frame to frame, so that the frames and their masks
    differ, with noise; labels in [0, 124) laid over the same pattern, ~5 %
    ignored (255)."""
    from vss_cffm_tpu_torch.data.vspw import VSPWVideoDataset

    class SyntheticVideo(VSPWVideoDataset):
        def __init__(self):
            self.split, self.dilation, self.img_scale = "val", list(dilation), EVAL_SCALE
            self.reduce_zero, self.img_suffix, self.seg_suffix = True, ".jpg", ".png"
            names = [f"{i:08d}.jpg" for i in range(EVAL_FRAMES)]
            self.videos, self.frames = ["synthetic"], {"synthetic": names}
            self.frame_index = [("synthetic", f) for f in names]
            rng = np.random.RandomState(seed)
            y, x = np.mgrid[0:EVAL_HW[0], 0:EVAL_HW[1]].astype(np.float32)
            self.imgs, self.labels = [], []
            for t in range(EVAL_FRAMES):
                xs, ys = x + 11.0 * t, y - 6.0 * t
                chans = [np.sin(xs / (37.0 + 9 * c)) * np.cos(ys / (53.0 - 7 * c)) for c in range(3)]
                img = 128.0 + 90.0 * np.stack(chans, -1) + rng.randint(-20, 21, (*EVAL_HW, 3))
                self.imgs.append(np.clip(img, 0, 255).astype(np.uint8))
                lab = ((xs // 71).astype(np.int64) + 13 * (ys // 59).astype(np.int64)) % NUM_CLASSES
                lab[rng.rand(*EVAL_HW) < 0.05] = 255
                self.labels.append(lab.astype(np.uint8))

        def read_frame(self, video, frame):
            return self.imgs[self.frames[video].index(frame)]

        def load_gt(self, idx):
            return self.labels[idx]

    return SyntheticVideo()


def _tiled_case(ops, args):
    """The key-tiled attention (row 1's SRA attention with the scale folded
    into K) on random bf16 inputs at a TTA shape, against the plain attention."""
    cfm = importlib.import_module("vss_cffm_tpu_torch.ops.cfm_attention")
    q, k, v, nh = args
    g, lq, c = q.shape
    n, hd = k.shape[1], c // nh
    ks = cfm.scale_in(torch.bfloat16, hd ** -0.5)
    # a score, its exp once, the softmax's max / sum / division and P·V's
    # input rounding as f32 operations
    bound = _bound_ms(_nbytes(q, k, v) + q.numel() * 2, 2 * 2 * g * nh * lq * n * hd,
                      g * nh * lq * n * 5, g * nh * lq * n)
    heads = lambda t: t.view(g, -1, nh, hd).transpose(1, 2)
    library = lambda: torch.nn.functional.scaled_dot_product_attention(heads(q), heads(k),
                                                                       heads(v))

    def call(force):
        if force == "torch":
            return cfm.attention_torch(q, k, v, None, None, nh, 1.0, ks)
        return cfm.attention_launch(q, k, v, None, None, nh, 1.0, ks, "attention_fwd_tiled",
                                    tiled=True)

    return dict(call=call, bound=bound, library=library,
                shape=f"q{tuple(q.shape)} N={n} nh={nh}")


EVAL_KERNELS = {
    "attention_fwd_tiled": dict(
        sources=["vss_cffm_tpu_torch/csrc/attention.cu"],
        # row 1's attention step at TTA's key counts: _kernel of mit_block_fused
        replaces="vss_cffm_tpu/ops/stage_block.py:106",
        # as the resident instance: P and the output may each flip one bf16 ulp
        rel_tol=2.0 ** -6, case=_tiled_case),
}


def _tiled_inputs(seed: int, n: int, c: int, nh: int, lq: int):
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device="cuda").to(torch.bfloat16)
    return r(4, lq, c), r(4, n, c), r(4, n, c), nh


def _launch_deltas(ops, names=("mit_block_fused", "cfm_attention", "dwconv3x3",
                               "attention_fwd_tiled")):
    """A callback for ``on_pred`` that records each frame's launches (the
    counts read after its mask, less the counts after the previous one)."""
    seen, last = [], [dict(ops.launches())]

    def on_pred(meta, _mask):
        now = ops.launches()
        seen.append((meta["index"], {k: now[k] - last[0][k] for k in names}))
        last[0] = dict(now)

    return seen, on_pred


def _expected_launches(video, per_clip: dict, index: int) -> dict:
    """Launches of one target frame: the backbone once (the whole clip in one
    batch, or the new frame streamed), the CFM decoder only on a clip of
    num_clips frames (frames 0-2 have clips of one)."""
    t = len(video.sample_test_clip(index).frame_indices)
    return {"mit_block_fused": per_clip["mit_block_fused"], "dwconv3x3": per_clip["dwconv3x3"],
            "cfm_attention": per_clip["cfm_attention"] if t == 4 else 0,
            "attention_fwd_tiled": 0}


def _tta_tiled_expected(model, ori, scales) -> int:
    """Key-tiled launches of one TTA prediction, from its views' geometry:
    each fused block whose attention has more keys than the resident
    instance holds (K and V in one block's shared memory) and at most the
    fused block's limit."""
    from vss_cffm_tpu_torch.data.transforms import aligned_size, rescale_size
    from vss_cffm_tpu_torch.models.mit import FUSED_MAX_KV
    from vss_cffm_tpu_torch.ops import _build
    from vss_cffm_tpu_torch.ops._dispatch import SMEM_LIMIT

    lib = _build.library("attention")
    n = 0
    for scale in scales:
        h, w = aligned_size(rescale_size(ori, scale))
        for s in (1, 2, 3, 4):  # each patch embed: a stride of 4, then 2, padded
            div = 4 if s == 1 else 2
            h, w = -(-h // div), -(-w // div)
            for blk in getattr(model.backbone, f"block{s}"):
                kv = blk.n_kv(torch.empty(1, h, w, 1))
                hd = blk.attn.dim // blk.attn.num_heads
                if (blk.fused and kv <= FUSED_MAX_KV
                        and lib.attention_fwd_smem_bytes(kv, hd, 0) > SMEM_LIMIT):
                    n += 1
    return n


def _logits_recorder(model):
    """Record every ``predict_from_features`` output (the target frames'
    logits) while the returned list lives; ``restore()`` removes the hook."""
    seen, real = [], model.predict_from_features

    def wrapped(fused, *args, **kwargs):
        out = real(fused, *args, **kwargs)
        seen.append(out.detach().clone())
        return out

    model.predict_from_features = wrapped
    return seen, lambda: model.__dict__.pop("predict_from_features")


def _f32_agreement(model, video) -> tuple[float, bool]:
    """(share of mask pixels, confusion equal) of the clip and the streamed
    evaluation with every op's plain version in f32 compute on the card."""
    from vss_cffm_tpu_torch.eval import ClipEvaluator, StreamingVideoEvaluator
    from vss_cffm_tpu_torch.models import set_force
    from vss_cffm_tpu_torch.models.segmentor import set_compute_dtype

    masks = {"clip": {}, "streamed": {}}
    set_force(model, "torch")
    set_compute_dtype(model, torch.float32)
    try:
        clip = ClipEvaluator(model, NUM_CLASSES, device="cuda")
        clip.run((video.get_test_item(i) for i in range(len(video))), dataset=video,
                 on_pred=lambda m, p: masks["clip"].__setitem__(m["index"], p))
        stream = StreamingVideoEvaluator(model, NUM_CLASSES, device="cuda")
        stream.run_streaming(video, on_pred=lambda m, p: masks["streamed"].__setitem__(
            m["index"], p))
    finally:
        set_compute_dtype(model, torch.bfloat16)
        set_force(model, None)
    same = sum(int((masks["clip"][i] == masks["streamed"][i]).sum()) for i in masks["clip"])
    total = sum(m.size for m in masks["clip"].values())
    return same / total, bool(np.array_equal(clip.confusion, stream.confusion))


def eval_phase(apis, ops, opts, root, kind, smi) -> tuple[dict, dict]:
    """``[eval]``: CFFM-B1 (random weights from SEED, bf16) on a synthetic
    VSPW video of EVAL_FRAMES frames at 480x853 (the network at 480x864):
    rows 1-3 at the inputs of one plain forward there, the key-tiled
    attention at TTA's key counts, the streamed evaluation (launches per
    target frame, logits against the plain path, the confusion's total),
    the clip evaluation against it, frames/s of both, slide on 2 frames,
    TTA on 2 frames (the key-tiled launches counted). Returns (kernel stats
    at this geometry, launch counts by path)."""
    from vss_cffm_tpu_torch.eval import ClipEvaluator, StreamingVideoEvaluator
    from vss_cffm_tpu_torch.eval.inference import slide_grid
    from vss_cffm_tpu_torch.models import set_force

    bundle = apis.init_segmentor("b1", device="cuda", dtype=torch.bfloat16, seed=SEED,
                                 img_scale=EVAL_SCALE)
    model = bundle.model
    video = _synthetic_video(SEED + 2)
    valid = sum(int((lab < NUM_CLASSES).sum()) for lab in video.labels)
    print(f"[eval] synthetic video: {EVAL_FRAMES} frames {EVAL_HW[0]}x{EVAL_HW[1]} uint8 BGR, "
          f"img_scale={EVAL_SCALE}, {valid} valid GT pixels", flush=True)
    clip_ev = ClipEvaluator(model, NUM_CLASSES, device="cuda")
    stream_ev = StreamingVideoEvaluator(model, NUM_CLASSES, device="cuda")
    item = video.get_test_item(EVAL_CLIP_TARGET)
    x = clip_ev._input(item["imgs"], item["img_scale"])
    print(f"[eval] network input {tuple(x.shape)}", flush=True)
    if tuple(x.shape[2:4]) != EVAL_INPUT_HW:
        raise RuntimeError(f"eval geometry {tuple(x.shape)}, expected {EVAL_INPUT_HW}")

    # rows 1-3 at the inputs of one plain forward at 480x864
    stats = {f"{name} (480x864)": st for name, st in check_kernels(
        ops, _capture_main_path_inputs(model, x), KERNELS, opts.profile).items()}
    # the key-tiled attention at TTA's keys, and against the resident one where both run
    caught = {"attention_fwd_tiled": [_tiled_inputs(i, *case[:4])
                                      for i, case in enumerate(TILED_CASES)]}
    stats.update(check_kernels(ops, caught, EVAL_KERNELS, opts.profile))
    del caught
    cfm = importlib.import_module("vss_cffm_tpu_torch.ops.cfm_attention")
    q, k, v, nh = _tiled_inputs(9, *TILED_RESIDENT_CASE[:4])
    ks = cfm.scale_in(torch.bfloat16, (q.shape[-1] // nh) ** -0.5)
    tiled = cfm.attention_launch(q, k, v, None, None, nh, 1.0, ks, "eval", tiled=True)
    resident = cfm.attention_launch(q, k, v, None, None, nh, 1.0, ks, "eval", tiled=False)
    plain = cfm.attention_torch(q, k, v, None, None, nh, 1.0, ks)
    torch.cuda.synchronize()
    err = (tiled.float() - plain.float()).abs().max().item()
    tol = 2.0 ** -6 * plain.float().abs().max().item()
    same = torch.equal(tiled, resident)
    print(f"[eval] attention N=405 ({TILED_RESIDENT_CASE[4]}): key-tiled vs resident "
          f"{'bitwise equal' if same else 'DIFFER'}; key-tiled vs plain max_abs_err={err:.3e} "
          f"tol={tol:.3e}", flush=True)
    if not same or not err <= tol:
        raise RuntimeError("key-tiled attention at N 405 disagrees with the resident instance "
                           "or the plain version")
    del q, k, v, tiled, resident, plain
    torch.cuda.empty_cache()

    # the streamed evaluation: counted, masks and logits kept; warm-up first
    per_clip = {"mit_block_fused": 4, "cfm_attention": 2, "dwconv3x3": 4}
    stream_ev.run_streaming(video)
    stream_ev.reset()
    torch.cuda.synchronize()
    counts = {}
    stream_masks, clip_masks = {}, {}
    logits, restore = _logits_recorder(model)
    ops.reset_launches()
    deltas, on_pred = _launch_deltas(ops)
    stream_ev.run_streaming(video, on_pred=lambda m, p: (stream_masks.__setitem__(m["index"], p),
                                                          on_pred(m, p)))
    torch.cuda.synchronize()
    counts["eval_streamed"] = ops.launches()
    restore()
    for index, got in deltas:
        want = _expected_launches(video, per_clip, index)
        if got != want:
            raise RuntimeError(f"streamed frame {index}: launches {got}, expected {want}")
    steady = [d for i, d in deltas if i >= 9]
    print(f"[eval] streamed launches over {EVAL_FRAMES} target frames: "
          f"{ {k: counts['eval_streamed'][k] for k in deltas[0][1]} }; per target frame from "
          f"frame 9 on: {steady[0]} (all {len(steady)} alike)", flush=True)
    if any(d != {**per_clip, "attention_fwd_tiled": 0} for d in steady):
        raise RuntimeError("streamed launches per target frame are not 4 / 2 / 4")
    cm_stream = stream_ev.confusion
    if int(cm_stream.sum()) != valid:
        raise RuntimeError(f"streamed confusion counts {int(cm_stream.sum())} pixels, the GT "
                           f"has {valid} valid ones")
    set_force(model, "torch")
    plain_logits, restore = _logits_recorder(model)
    plain_ev = StreamingVideoEvaluator(model, NUM_CLASSES, device="cuda")
    plain_ev.run_streaming(video)
    restore()
    set_force(model, None)
    worst = 0.0
    for t, (got, want) in enumerate(zip(logits, plain_logits)):
        if not torch.isfinite(got.float()).all():
            raise RuntimeError(f"non-finite streamed logits at frame {t}")
        e = (got.float() - want.float()).abs().max().item()
        s = want.float().abs().max().item()
        worst = max(worst, e / s)
        if e > 0.05 * s:
            raise RuntimeError(f"streamed logits of frame {t} disagree with the plain path: "
                               f"{e} > {0.05 * s}")
    print(f"[eval] streamed logits {tuple(logits[0].shape)} of {len(logits)} target frames vs "
          f"the plain path: worst max_abs_err / max|ref| = {worst:.4f} (limit 0.05); "
          f"confusion total {int(cm_stream.sum())} = valid GT pixels", flush=True)
    del plain_logits, plain_ev

    # the clip evaluation on the same video and weights, counted, its logits kept
    clip_logits = []
    hook = model.register_forward_hook(lambda mod, a, out: clip_logits.append(out.clone()))
    ops.reset_launches()
    deltas, on_pred = _launch_deltas(ops)
    clip_ev.run((video.get_test_item(i) for i in range(len(video))), dataset=video,
                on_pred=lambda m, p: (clip_masks.__setitem__(m["index"], p), on_pred(m, p)))
    torch.cuda.synchronize()
    counts["eval_clip"] = ops.launches()
    hook.remove()
    for index, got in deltas:
        want = _expected_launches(video, per_clip, index)
        if got != want:
            raise RuntimeError(f"clip frame {index}: launches {got}, expected {want}")
    cm_clip = clip_ev.confusion
    same_px = sum(int((stream_masks[i] == clip_masks[i]).sum()) for i in stream_masks)
    share = same_px / sum(m.size for m in stream_masks.values())
    print(f"[eval] clip evaluation: launches {counts['eval_clip']['mit_block_fused']} / "
          f"{counts['eval_clip']['cfm_attention']} / {counts['eval_clip']['dwconv3x3']}; masks "
          f"agree with the streamed ones on {share:.6f} of the pixels; confusion "
          f"{'exactly equal' if np.array_equal(cm_clip, cm_stream) else 'not equal'} "
          f"(sum |diff| {int(np.abs(cm_clip - cm_stream).sum())}); mIoU streamed "
          f"{stream_ev.summary()['mIoU']:.5f} clip {clip_ev.summary()['mIoU']:.5f}", flush=True)
    # bf16 through library convolutions and GEMMs that round a batch of 4
    # frames and a batch of 1 differently (from the third patch embed on):
    # the logits are held as [main] holds the kernel path against the plain
    # one; random weights leave the logits near-tied (a top-2 margin of one
    # bf16 ulp at the flipped pixels), so the mask agreement is printed here
    # and held in f32 below, where rounding cannot flip it
    worst = 0.0
    for t, (got, want) in enumerate(zip(logits, clip_logits)):
        e = (got.float() - want.float()).abs().max().item()
        s = want.float().abs().max().item()
        worst = max(worst, e / s)
        if e > 0.05 * s:
            raise RuntimeError(f"streamed logits of frame {t} disagree with the clip path's: "
                               f"{e} > {0.05 * s}")
    print(f"[eval] streamed vs clip logits, bf16 kernel paths: worst max_abs_err / max|clip| "
          f"= {worst:.4f} (limit 0.05)", flush=True)
    del logits, clip_logits
    share32, exact32 = _f32_agreement(model, video)
    print(f"[eval] f32 plain paths (force='torch', f32 compute, same weights): clip and streamed "
          f"masks agree on {share32:.6f} of the pixels; confusion "
          f"{'exactly equal' if exact32 else 'not equal'}", flush=True)
    if share32 < 0.999:
        raise RuntimeError(f"clip and streamed masks agree on {share32} < 0.999 of the pixels "
                           "in f32")

    # frames/s of both, EVAL_ROUNDS rounds each in alternating order
    from vss_cffm_tpu_torch.data import iterate_eval

    runs = {"streamed": lambda: stream_ev.run_streaming(video),
            "per clip": lambda: clip_ev.run(iterate_eval(video, num_workers=2), dataset=video)}
    rates = {name: [] for name in runs}
    torch.cuda.reset_peak_memory_stats()
    for r in range(EVAL_ROUNDS):
        for name in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
            ev = stream_ev if name == "streamed" else clip_ev
            ev.reset()
            torch.cuda.synchronize()
            ts = time.perf_counter()
            runs[name]()
            torch.cuda.synchronize()
            rates[name].append(EVAL_FRAMES / (time.perf_counter() - ts))
    peak = torch.cuda.max_memory_allocated() / 2**20
    for name, rs in rates.items():
        fps = float(np.median(rs))
        print(f"[eval] CFFM-B1 {EVAL_HW[0]}x{EVAL_HW[1]} video, {name}: {fps:.3f} eval frames/s, "
              f"median of "
              f"{EVAL_ROUNDS} rounds of {EVAL_FRAMES} frames ({', '.join(f'{x:.3f}' for x in rs)}); "
              f"{1e3 / fps:.3f} ms per frame", flush=True)
    print(f"[eval] peak memory of both {peak:.1f} MiB", flush=True)
    if opts.profile:
        for name, fname in (("streamed", "profile_eval_streamed.txt"),
                            ("per clip", "profile_eval_clip.txt")):
            busy = _profile(runs[name], f"eval {name}, {EVAL_FRAMES} frames", fname, root, kind,
                            smi)
            print(f"[eval] device busy per target frame, {name}: {busy / EVAL_FRAMES:.3f} ms",
                  flush=True)

    # slide: 3 crops of 480x480 a frame
    grid = slide_grid(EVAL_INPUT_HW, EVAL_CROP, EVAL_STRIDE)
    if len(grid) != EVAL_SLIDE_CROPS:
        raise RuntimeError(f"slide grid {grid}, expected {EVAL_SLIDE_CROPS} crops")
    slide_ev = ClipEvaluator(model, NUM_CLASSES, mode="slide", crop_size=EVAL_CROP,
                             stride=EVAL_STRIDE, device="cuda")
    slide_ev.predict(video.get_test_item(EVAL_SLIDE_FRAMES[0]))  # warm-up
    torch.cuda.synchronize()
    ops.reset_launches()
    ts = time.perf_counter()
    slide_ev.run((video.get_test_item(i) for i in EVAL_SLIDE_FRAMES), dataset=video)
    torch.cuda.synchronize()
    slide_s = (time.perf_counter() - ts) / len(EVAL_SLIDE_FRAMES)
    counts["eval_slide"] = ops.launches()
    want = {k: EVAL_SLIDE_CROPS * n * len(EVAL_SLIDE_FRAMES) for k, n in per_clip.items()}
    if {k: counts["eval_slide"][k] for k in want} != want:
        raise RuntimeError(f"slide launches {counts['eval_slide']}, expected {want}")
    print(f"[eval] slide (crops of {EVAL_CROP} at {grid}, stride {EVAL_STRIDE}) on "
          f"{len(EVAL_SLIDE_FRAMES)} frames: "
          f"{slide_s:.4f} s a frame; launches {want}", flush=True)

    # TTA: 6 ratios x flip, the key-tiled instance at 1.5x and 1.75x
    tta_items = [video.get_test_item_tta(i) for i in EVAL_TTA_FRAMES]
    expected_tiled = sum(_tta_tiled_expected(model, it["ori_shape"], it["scales"])
                         for it in tta_items)
    clip_ev.predict_tta(tta_items[0])  # warm-up at the views' shapes
    torch.cuda.synchronize()
    ops.reset_launches()
    ts = time.perf_counter()
    tta_masks = [clip_ev.predict_tta(it) for it in tta_items]
    torch.cuda.synchronize()
    tta_s = (time.perf_counter() - ts) / len(tta_items)
    counts["eval_tta"] = ops.launches()
    n_tiled = counts["eval_tta"]["attention_fwd_tiled"]
    print(f"[eval] TTA ({len(tta_items[0]['scales'])} views a frame: img_scale "
          f"{sorted(set(tta_items[0]['scales']))}, flipped and not) on {len(tta_items)} frames: "
          f"{tta_s:.4f} s a frame; launches "
          f"{ {k: v for k, v in counts['eval_tta'].items() if v} }; key-tiled {n_tiled}, "
          f"expected {expected_tiled} from the views' keys; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB", flush=True)
    if not 0 < n_tiled == expected_tiled:
        raise RuntimeError(f"TTA launched the key-tiled attention {n_tiled} times, expected "
                           f"{expected_tiled} (> 0)")
    for m in tta_masks:
        if m.shape != EVAL_HW or m.min() < 0 or m.max() >= NUM_CLASSES:
            raise RuntimeError(f"TTA mask of shape {m.shape}, range [{m.min()}, {m.max()}]")
    del bundle, model, clip_ev, stream_ev, slide_ev, video
    torch.cuda.empty_cache()
    return stats, counts


def _profile(fn, what: str, fname: str, root: str, kind: str, smi: str) -> float:
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
    line = (f"[profile] {what}: device busy {busy:.3f} ms, {n_launch} kernel launches, "
            f"{n_copy} aten::_to_copy calls (dtype or device copies)")
    print(line, flush=True)
    for e in events if fname == "profile_train.txt" else ():
        # rows 6 and 7's own kernels by name, one step
        for tag, names in (("row6", ROW6_KERNELS), ("row7", ROW7_KERNELS)):
            if e.device_type == DeviceType.CUDA and any(k in e.key for k in names):
                us = e.self_device_time_total
                print(f"[{tag}] {e.key[:110]}: {e.count} launches, {us / 1e3:.3f} ms per step, "
                      f"{us / e.count:.1f} us per launch", flush=True)
    table = events.table(sort_by="cuda_time_total", row_limit=120)
    os.makedirs(os.path.join(root, "chiprun_out"), exist_ok=True)
    with open(os.path.join(root, "chiprun_out", fname), "w") as fh:
        fh.write(f"{kind} | {smi}\n{line}\n{table}\n")
    print("\n".join(table.splitlines()[:25]), flush=True)
    return busy


def row_splits() -> None:
    """``[row14]``: rows 14 and 12 alone at N 8 and N 2, then ``[row16]`` and
    ``[row18]``: the phase-layout forwards at the same inputs (device µs, exp
    bound, its share, the library calls' µs, a digest of the output;
    ``tools/bench_ce_fwd.py``);
    ``[row17]``: rows 17 and 13 alone at N 8 and N 2, then ``[row15]`` and
    ``[row19]``: the phase-layout backwards at the same inputs (device µs, exp
    bound, recompute factor; ``tools/bench_ce_bwd.py``); ``[gemm]``: each
    block_gemm launch of a default step and a clip (device µs, bytes bound,
    share of 3.35 TB/s, torch.matmul's µs; ``tools/bench_gemm.py``)."""
    importlib.import_module("vss_cffm_tpu_torch.tools.bench_ce_fwd").main([])
    torch.cuda.empty_cache()
    importlib.import_module("vss_cffm_tpu_torch.tools.bench_ce_bwd").main([])
    torch.cuda.empty_cache()
    importlib.import_module("vss_cffm_tpu_torch.tools.bench_gemm").main([])
    torch.cuda.empty_cache()


def _check_masks(masks, num_classes: int) -> None:
    for m in masks:
        if tuple(m.shape) != (480, 480) or m.dtype != torch.int64:
            raise RuntimeError(f"mask of shape {tuple(m.shape)} {m.dtype}")
        if int(m.min()) < 0 or int(m.max()) >= num_classes:
            raise RuntimeError("mask class out of range")


# the CFM attention (B1 decoder: N 289, heads of 32, with bias and mask) and
# the spatial-reduction attention of the MiT blocks (N 225, heads of 64,
# neither) at the main path's shapes: (N, head dim, with bias and mask, what)
ATTENTION_SHAPES = ((289, 32, 1, "CFM window attention"),
                    (225, 64, 0, "spatial-reduction attention"))


def attention_resources(build) -> None:
    """What ``ptxas -v`` reported for each instance of the attention kernels,
    the depthwise conv, the block backward's passes, the GEMM and the
    upsampled-CE kernels (registers, static shared memory, stack and spill
    bytes), and the blocks one SM holds
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) at the main path's
    shapes, the CE forward's with its plan."""
    cfm = importlib.import_module("vss_cffm_tpu_torch.ops.cfm_attention")
    fwd, bwd = build.library("attention"), build.library("attention_bwd")
    for src in ("attention", "attention_bwd", "sra_attention_bwd", "dwconv", "block_bwd",
                "block_gemm", "ce_upsampled", "ffn_fused"):
        for k in build.ptxas_usage(src):
            print(f"[ptxas] csrc/{src}.cu {k['kernel']}: {k['registers']} registers, "
                  f"{k['smem']} B static smem, {k['stack']} B stack, spill stores "
                  f"{k['spill_stores']} B, spill loads {k['spill_loads']} B", flush=True)
    for n, hd, with_bias, what in ATTENTION_SHAPES:
        for probs in (False, True) if with_bias else (False,):
            print(f"[occupancy] attention_fwd N={n} hd={hd} ({what}"
                  f"{', writing p' if probs else ''}): "
                  f"{fwd.attention_fwd_smem_bytes(n, hd, int(probs))} B dynamic smem, "
                  f"{cfm.blocks_per_sm('fwd', n, hd, 0, with_bias + 2 * probs)} blocks per SM",
                  flush=True)
    for hd in (64, 32):  # the key-tiled instance (TTA's keys: stages 2, 3 at heads of 64)
        for with_bias in (0, 1):
            print(f"[occupancy] attention_fwd_tiled hd={hd}{' with bias and mask' if with_bias else ''}"
                  f": {fwd.attention_fwd_tiled_smem_bytes(hd)} B dynamic smem, "
                  f"{fwd.attention_fwd_tiled_blocks_per_sm(hd, with_bias, 0)} blocks per SM "
                  f"of {cfm.TILED_ROWS} query rows", flush=True)
    for n, hd, _, _ in ATTENTION_SHAPES:
        for mode, label in ((0, "recompute"), (1, "f32 p"), (2, "bf16 p")):
            print(f"[occupancy] attention_bwd N={n} hd={hd} {label}: "
                  f"{bwd.attention_bwd_smem_bytes(n, hd)} B dynamic smem, "
                  f"{cfm.blocks_per_sm('bwd', n, hd, 0, mode)} blocks per SM", flush=True)
    ce = importlib.import_module("vss_cffm_tpu_torch.ops.ce_upsampled")
    lib = build.library("ce_upsampled")
    for n in (8, 2):  # the upsampled-CE forward (rows 14, 12) at the train step's two branches
        tw, band = ce.ce_fwd_plan(n, 120, 120, NUM_CLASSES, 4, torch.cuda.get_device_properties(0)
                                  .multi_processor_count)
        # and the phase-layout forwards on its kernel (rows 16, 18: w-major labels)
        for pixel, row in ((0, 14), (1, 12), (0, 16), (0, 18)):
            blocks = (lib.ce_fwd_phase_blocks_per_sm(NUM_CLASSES, 4, tw) if row in (16, 18)
                      else lib.ce_fwd_blocks_per_sm(NUM_CLASSES, 4, tw, pixel))
            print(f"[occupancy] ce_fwd (row {row}) N={n} C={NUM_CLASSES} s=4: strips of {tw}, "
                  f"bands of {band}, {lib.ce_fwd_smem_bytes(NUM_CLASSES, 4, tw, pixel)} B dynamic "
                  f"smem, {blocks} blocks per SM", flush=True)
        # the loss backward (row 17) and the phase-layout backwards on its kernel
        tw, nseg, cs = ce.ce_bwd_plan(n, 120, 120, NUM_CLASSES, 4, torch.cuda
                                      .get_device_properties(0).multi_processor_count)
        for layout, row in ((0, 17), (1, 15), (2, 19)):
            print(f"[occupancy] ce_bwd (row {row}) N={n} C={NUM_CLASSES} s=4: strips of {tw}, "
                  f"{nseg} segments, {ce.CE_BWD_WARPS * 2 * tw * cs * 4} B dynamic smem, "
                  f"{lib.ce_bwd_blocks_per_sm(NUM_CLASSES, tw, cs, layout)} blocks per SM",
                  flush=True)
        # the per-pixel backward (row 13), its own kernel and plan
        tw, nseg = ce.ce_nll_bwd_plan(n, 120, 120, NUM_CLASSES, 4, torch.cuda
                                      .get_device_properties(0).multi_processor_count)
        nll = build.library("ce_nll_bwd")
        print(f"[occupancy] ce_nll_bwd (row 13) N={n} C={NUM_CLASSES} s=4: strips of at most "
              f"{tw}, {nseg} segments, {nll.ce_nll_bwd_smem_bytes(NUM_CLASSES, 4, tw)} B dynamic "
              f"smem, {nll.ce_nll_bwd_blocks_per_sm(NUM_CLASSES, 4, tw)} blocks per SM",
              flush=True)
    sra = build.library("sra_attention_bwd")
    for n, hd in ((225, 64), (225, 32)):  # the MiT stages at 480² (B1: heads of 64; B0: 32)
        print(f"[occupancy] sra_attention_bwd S={n} hd={hd}: "
              f"{sra.sra_attention_bwd_smem_bytes(n, hd)} B dynamic smem, "
              f"{sra.sra_attention_bwd_blocks_per_sm(n, hd, 0)} blocks per SM", flush=True)


def _first_windows(args, count: int):
    """The tensors of a backward's arguments cut to their first ``count``
    windows (bias, shared by the windows, and nh as they are)."""
    nw = args[0].shape[0]
    return tuple(a[:count] if isinstance(a, torch.Tensor) and a.shape[0] == nw else a
                 for a in args)


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
    _clocks("start")

    # ---- 2. build --------------------------------------------------------------
    tb = time.perf_counter()
    _build.build_all()
    for name in _build.SOURCES:
        _build.library(name)
    print(f"[build] {len(_build.SOURCES)} sources in {time.perf_counter() - tb:.1f} s",
          flush=True)
    attention_resources(_build)

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
    _check_masks(masks, bundle.config.head.num_classes)

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

    # ---- 4b. the fused-FFN path, same weights --------------------------------
    cfg_f = dataclasses.replace(bundle.config, dwconv_impl="fused")
    bundle_f = apis.init_segmentor(cfg_f, device="cuda", dtype=torch.bfloat16, seed=SEED)
    print(f"[ffn] dwconv_impl={cfg_f.dwconv_impl} block_impl={cfg_f.block_impl}", flush=True)
    caught_f = _capture_ffn_inputs(bundle_f.model, x0.to(torch.float32))
    kernel_stats.update(check_kernels(ops, caught_f, FFN_INFER_KERNELS, opts.profile))
    ffn_half = ffn_phase(ops, caught, caught_f, smi)
    plan_f = {"mit_block_fused": 4, "block_ffn_fused": 4, "cfm_attention": 2, "dwconv3x3": 0,
              "mixffn_fused": 0}
    apis.inference_segmentor(bundle_f, clips[0])        # warm-up
    torch.cuda.synchronize()
    ops.reset_launches()
    masks_f = [apis.inference_segmentor(bundle_f, c) for c in clips]
    torch.cuda.synchronize()
    counts_f = ops.launches()
    print(f"[ffn] launches over {CLIPS} clips: {counts_f}", flush=True)
    for name, n in plan_f.items():
        if counts_f[name] != n * CLIPS:
            raise RuntimeError(f"fused-FFN path: {name} launched {counts_f[name]} times, "
                               f"expected {n} x {CLIPS}")
    _check_masks(masks_f, bundle_f.config.head.num_classes)
    logits_f, _ = apis.clip_logits(bundle_f, clips[0])
    set_force(bundle_f.model, "torch")
    ref_f, _ = apis.clip_logits(bundle_f, clips[0])
    set_force(bundle_f.model, None)
    if not torch.isfinite(logits_f.float()).all():
        raise RuntimeError("non-finite logits on the fused-FFN path")
    err_f = (logits_f.float() - ref_f.float()).abs().max().item()
    scale_f = ref_f.float().abs().max().item()
    print(f"[ffn] logits {tuple(logits_f.shape)} kernel vs plain on the card: "
          f"max_abs_err={err_f:.3e} max|ref|={scale_f:.3e}; mask agreement with the default "
          f"path {(masks_f[0] == masks[0]).float().mean().item():.5f}", flush=True)
    if err_f > 0.05 * scale_f:
        raise RuntimeError(f"fused-FFN logits disagree with the plain path: {err_f} > "
                           f"{0.05 * scale_f}")
    # mixffn_fused's own path: MixFFN in eval mode, as a module, at the stage-1
    # and stage-4 inputs (the segmentor reaches block_ffn_fused first)
    ops.reset_launches()
    with torch.inference_mode():
        outs = [mlp(ln) for mlp, ln in caught_f["mlp"]]
    torch.cuda.synchronize()
    counts_mix = ops.launches()
    print(f"[mixffn] MixFFN.forward (eval, dwconv_impl='fused') at stages 1 and 4: launches "
          f"{counts_mix}", flush=True)
    if counts_mix["mixffn_fused"] != 2 or sum(counts_mix.values()) != 2:
        raise RuntimeError(f"MixFFN path: launches {counts_mix}, expected mixffn_fused 2")
    if not all(torch.isfinite(o.float()).all() for o in outs):
        raise RuntimeError("non-finite MixFFN output")

    # frames/s of both paths: ROUNDS rounds of TIMED_CLIPS clips each, timed
    # on the host clock up to a synchronize, in alternating order (default,
    # fused, fused, default, ...): the loop is host-bound, so every round is
    # printed along with the medians
    torch.cuda.reset_peak_memory_stats()
    paths = {"default": bundle, "fused FFN": bundle_f}
    rates = {name: [] for name in paths}
    for r in range(ROUNDS):
        for name in (list(paths) if r % 2 == 0 else list(paths)[::-1]):
            torch.cuda.synchronize()
            ts = time.perf_counter()
            for i in range(TIMED_CLIPS):
                apis.inference_segmentor(paths[name], clips[i % CLIPS])
            torch.cuda.synchronize()
            rates[name].append(TIMED_CLIPS / (time.perf_counter() - ts))
    peak = torch.cuda.max_memory_allocated() / 2**20
    for name, rs in rates.items():
        fps = float(np.median(rs))
        print(f"[main] CFFM-B1 480x480 clip-4 bf16, {name}: {fps:.3f} frames/s, median of "
              f"{ROUNDS} rounds of {TIMED_CLIPS} clips ({', '.join(f'{x:.3f}' for x in rs)}); "
              f"{1e3 / fps:.3f} ms per clip, {4 * fps:.3f} input frames/s", flush=True)
    print(f"[main] peak memory of both paths {peak:.1f} MiB; host: {os.cpu_count()} cores, "
          f"load average {os.getloadavg()[0]:.2f}, {torch.get_num_threads()} torch threads",
          flush=True)

    if opts.profile:
        _profile(lambda: apis.inference_segmentor(bundle, clips[1]), "one clip", "profile.txt",
                 root, kind, smi)
        _profile(lambda: apis.inference_segmentor(bundle_f, clips[1]), "one clip, fused FFN",
                 "profile_ffn.txt", root, kind, smi)
    del bundle, bundle_f, model, caught, caught_f, outs
    torch.cuda.empty_cache()

    # ---- 4c. video evaluation at VSPW's eval geometry -------------------------
    eval_stats, eval_counts = eval_phase(apis, ops, opts, root, kind, smi)

    # ---- 4d. the image model, SegFormer-B0, at the same geometry --------------
    image_stats, image_counts = image_phase(apis, ops, opts, root, kind, smi)

    # ---- 5. the train step, in each block form ------------------------------
    train_stats, train_counts = {}, {}
    for form, spec in TRAIN_FORMS.items():
        with _cfm_switches(*spec.get("cfm_bwd", ("recompute", torch.float32))):
            train_stats[form], train_counts[form] = train_phase(apis, ops, opts, root, kind, smi,
                                                                form)

    work_root = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        # ---- 5a. the native data path, and the train CLI on a tree on disk
        native_counts = native_phase(ops, root, smi, work_root)

        # ---- 5b. the train CLI from the B1 config, resumed, with the decoder remat
        cli_counts, cffm_ckpt = train_cli_phase(ops, root, smi, work_root)

        # ---- 5c. CFFM++: phase A, the finetune step, evaluation with the store
        pp_counts, ft_ckpt, cluster_dir = cffm_pp_phase(ops, root, kind, smi, work_root)

        # ---- 5d. the test CLI on 5b's and 5c's checkpoints, and the image model
        test_cli_counts, one_process = test_cli_phase(ops, root, smi, work_root, cffm_ckpt,
                                                      ft_ckpt, cluster_dir)

        # ---- 5e. training and evaluation over several processes
        dist_counts = dist_phase(ops, root, smi, work_root, cffm_ckpt, one_process)

        # ---- 5f. the measuring and publishing tools
        tools_counts = tools_phase(ops, root, smi, cffm_ckpt, one_process)

        # ---- 5g. the clip forward exported with its kernels; dropout above 0
        export_counts = export_phase(ops, root, smi, work_root)
    finally:
        shutil.rmtree(work_root, ignore_errors=True)

    # ---- 6. the CE microbench and its six kernels ----------------------------
    _clocks("after the train phase")
    ce_stats, ce_counts = ce_bench_phase(ops, opts)
    if opts.profile:
        row_splits()

    # ---- 7. result lines -----------------------------------------------------
    # launches: each kernel's count on its own path (the inference clips for
    # the inference kernels, the fused-FFN clips for block_ffn_fused, the
    # MixFFN module for mixffn_fused, the counted steps of the default train
    # form for the train ones (train_cli: the CLI's runs A and B, 4 steps), of the "ffn" form for the block-FFN pair, of
    # the "ohem" form for the per-pixel CE pair, of "train_probs" for the
    # probabilities pair (its forward counts as cfm_attention), the CE
    # microbench for the four layout variants); launches_by_path gives every
    # path's
    kernels = []
    rows = [(n, spec, kernel_stats[n], "inference") for n, spec in KERNELS.items()]
    rows += [(n, spec, kernel_stats[n], "inference_ffn" if n == "block_ffn_fused" else "mixffn")
             for n, spec in FFN_INFER_KERNELS.items()]
    rows += [(n, spec, train_stats[form][n], form) for form in TRAIN_FORMS
             for n, spec in TRAIN_FORMS[form]["kernels"].items() if "sources" in spec]
    rows += [(n, spec, ce_stats[n], "ce_bench") for n, spec in CE_BENCH_KERNELS.items()
             if "sources" in spec]
    rows += [(n, spec, eval_stats[n], "eval_tta") for n, spec in EVAL_KERNELS.items()]
    for name, spec, st, path in rows:
        cn = spec.get("counter", name)
        by_path = {"inference": counts[cn], "inference_ffn": counts_f[cn],
                   "mixffn": counts_mix[cn], **{f: c[cn] for f, c in train_counts.items()},
                   "train_cli": cli_counts[cn], "ce_bench": ce_counts[cn],
                   **{p: c[cn] for p, c in eval_counts.items()},
                   **{p: c[cn] for p, c in pp_counts.items()},
                   **{p: c[cn] for p, c in image_counts.items()},
                   **{p: c[cn] for p, c in test_cli_counts.items()},
                   **{p: c[cn] for p, c in dist_counts.items()},
                   **{p: c[cn] for p, c in tools_counts.items()},
                   **{p: c[cn] for p, c in export_counts.items()},
                   **{p: c[cn] for p, c in native_counts.items()}}
        row = {"name": name, "route": "cuda", "source": spec["sources"][0],
               "sources": spec["sources"],
               "replaces": spec["replaces"], "launches": by_path[path], "path": path,
               "launches_by_path": by_path,
               "max_abs_err": st["max_abs_err"], "ms": st["ms"],
               "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
               "bound_by": st["bound_by"], "library_ms": st["library_ms"],
               "device_ms": st["device_ms"]}
        if f"{name} (480x864)" in eval_stats:  # rows 1-3 at the eval geometry too
            row["eval_480x864"] = eval_stats[f"{name} (480x864)"]
        if name in image_stats:  # rows 1 and 3 at SegFormer-B0's widths there
            row["image_b0_480x864"] = image_stats[name]
        if name in ffn_half:  # rows 1, 8, 9: the FFN launch alone against the old route
            row["ffn_half"] = ffn_half[name]
        # rows 6, 7, 10 and 11: the train pairs' FFN half against the old route
        ffn_form = {"mit_block_train": "train", "mit_block_train_bwd": "train",
                    "block_ffn_train": "train_ffn", "block_ffn_train_bwd": "train_ffn"}.get(name)
        if ffn_form in FFN_TRAIN:
            row["ffn_train"] = FFN_TRAIN[ffn_form]
        kernels.append(row)
    print(f"[done] {time.perf_counter() - t0:.1f} s; kernels checked: "
          f"{', '.join(k['name'] for k in kernels)}", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
