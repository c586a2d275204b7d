"""Arithmetic shared by the per-layer metric readers (``metrics/*.py``):
the card's peaks (``peaks.json``), the roofline bound of a list of kernel-op
calls, the program's device time and the device's busy time from a trace."""

from __future__ import annotations

import json
import os
import sys

import torch

from . import trace as tr


def peaks(ctx: dict) -> dict | None:
    """The published peaks of the card the run used, or None for a card the
    table lacks (and for a run off the card)."""
    dev = ctx["device"]
    if dev.type != "cuda":
        return None
    with open(os.path.join(ctx["root"], "portbench", "peaks.json")) as f:
        table = json.load(f)
    return table.get(torch.cuda.get_device_name(dev))


def bound_s(ctx: dict, calls: list[tuple[str, dict]]) -> float | None:
    """The least time of the calls on the card: per call, the largest of its
    bytes over the memory bandwidth, its tensor FLOPs over the bf16 tensor
    peak and its f32 FLOPs over the f32 peak."""
    pk = peaks(ctx)
    if pk is None:
        return None
    cell = ctx["cell"]
    total = 0.0
    for op, shape in calls:
        nbytes, tensor, f32 = cell.op_work(op)(shape)
        total += max(nbytes / pk["hbm_bytes_per_s"], tensor / pk["bf16_tensor_flops_per_s"],
                     f32 / pk["f32_flops_per_s"])
    return total


def calls_match(ctx: dict) -> bool:
    """Whether the counted calls are the launches the program made in the
    traced window, op by op (otherwise a bound would count other work)."""
    want: dict[str, int] = {}
    for op, _ in ctx["calls"]:
        want[op] = want.get(op, 0) + 1
    got = {op: n for op, n in ctx["trace"].launches.items() if n}
    if want != got:
        print(f"[readers] counted calls {want} differ from the launches {got}", file=sys.stderr)
        return False
    return True


def kernel_roofline(ctx: dict) -> float | None:
    """Sum of the bounds of the program's kernel-op calls in the traced
    window over the device time of the program's kernels there, in %."""
    if "trace" not in ctx or "calls" not in ctx or not calls_match(ctx):
        return None
    bound = bound_s(ctx, ctx["calls"])
    pattern = tr.kernel_pattern(ctx["root"])
    device = sum(e - s for s, e, _, _ in ctx["trace"].kernels(pattern)) * 1e-9
    if bound is None or device <= 0:
        return None
    return 100.0 * bound / device


def device_busy_s(ctx: dict) -> float | None:
    """Seconds in which an operation ran on the device during the window:
    the busy time a step of the profiled steps (traced with CUDA activities
    alone) times the window's steps. The profiler slows the host's launches
    (B1's traced steps ran ~35 % slower than untraced), so the profiled
    steps' own window would count the profiler's overhead as idle time; the
    device's busy time a step does not depend on the host's pace."""
    if "trace" not in ctx or not ctx.get("steps"):
        return None
    return ctx["trace"].busy_s() / ctx["traced_steps"] * ctx["steps"]


def device_idle(ctx: dict) -> float | None:
    """Share of the window in which no operation ran on the device, in %."""
    busy = device_busy_s(ctx)
    return None if busy is None else 100.0 * (1.0 - busy / ctx["window_s"])


def mfu(ctx: dict) -> float | None:
    """Model FLOPs of the window's completed work over its seconds and the
    bf16 tensor peak, in %."""
    pk = peaks(ctx)
    if pk is None:
        return None
    return 100.0 * ctx["model_flops"] / ctx["window_s"] / pk["bf16_tensor_flops_per_s"]
