"""Rows 1 and 2 at the inference shapes of a CFFM-B1 clip, at 480×480 and at
VSPW's eval geometry (480×864), and the key-tiled attention at test-time
augmentation's key counts, each timed alone on the card: ``python -m
vss_cffm_tpu_torch.tools.bench_attention [--iters 20]``.

Row 1 is ``ops.mit_block_fused`` at stages 2 and 3 (4 frames, heads of 64,
225 keys at 480×480, 405 at 480×864), row 2 ``ops.cfm_attention`` at the
B1 decoder's groups (N 289, 8 heads of 32) over 81 and 144 windows; inputs
are random from a fixed seed, the block's weights scaled so that its
branches are O(1). One line per case: the wrapper's ms per call (CUDA
events over ``--iters`` calls), the kernels' device µs per call
(torch.profiler, the larger of two windows) and a digest of the output, so
that two trees that launch the same kernels on the same inputs print the
same digest.

The key-tiled lines (``attention_launch(..., tiled=True)``, row 1's
attention step with the scale folded into K, 4 frames) come at
``chip_smoke.py``'s four ``TILED_CASES`` (920 and 1269 keys at TTA's 1.5x
and 1.75x, 2048 at the fused block's limit), then the key-tiled and the
resident instance side by side at 225 and 405 keys (stages 2 and 3 at
480×480 and 480×864, where both run); each adds ``bound_ms`` (the largest
of the bytes over 3.35 TB/s, one pass of tensor work over 989 TFLOP/s, five
f32 operations a score over 67 TFLOP/s and one exp a score over the MUFU
rate: chip_smoke's ``_tiled_case`` bound), the bound's share of the device
time, and ``sdpa_ms`` (``scaled_dot_product_attention`` on the same q, K, V,
timed as a yardstick). The key-tiled lines appear only where the tree has
that instance. The tool uses only what every tree of the port since its
first slice has, so the same file times an older checkout:
``PYTHONPATH=<checkout> python .../bench_attention.py``; compare trees
inside one chip call, in ABBA order.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib

import numpy as np
import torch

__all__ = ["main"]

# (stage, frames, H, W, C, keys, heads, hidden) of row 1's launches
ROW1 = (("stage 2, 480x480", 4, 60, 60, 128, 225, 2, 512),
        ("stage 3, 480x480", 4, 30, 30, 320, 225, 5, 1280),
        ("stage 2, 480x864", 4, 60, 108, 128, 405, 2, 512),
        ("stage 3, 480x864", 4, 30, 54, 320, 405, 5, 1280))
# (what, windows) of row 2's launches; the B1 decoder's K/V groups
ROW2 = (("480x480", 81), ("480x864", 144))
GROUPS = (49, 132, 25, 49, 25, 9)
# (what, frames, query rows a frame, C, keys, heads) of the key-tiled attention:
# chip_smoke.py's TILED_CASES
TILED = (("stage 2 at TTA 1.5x", 4, 92 * 160, 128, 920, 2),
         ("stage 2 at TTA 1.75x", 4, 108 * 188, 128, 1269, 2),
         ("stage 3 at TTA 1.75x", 4, 54 * 94, 320, 1269, 5),
         ("stage 3 widths at the fused block's limit", 4, 4 * 2048, 320, 2048, 5))
# where both instances run: row 1's attention at 480x480 and 480x864
BOTH = (("stage 2, 480x480", 4, 60 * 60, 128, 225, 2),
        ("stage 3, 480x480", 4, 30 * 30, 320, 225, 5),
        ("stage 2, 480x864", 4, 60 * 108, 128, 405, 2),
        ("stage 3, 480x864", 4, 30 * 54, 320, 405, 5))
# H100 SXM data-sheet peaks at 700 W (chip_smoke.py's)
HBM_BYTES_PER_S, BF16_TENSOR_FLOPS, F32_FLOPS = 3.35e12, 989e12, 67e12
MUFU_EXP_PER_S = 16 * 132 * 1.98e9


def _tiled_bound_ms(g: int, lq: int, n: int, c: int, nh: int) -> float:
    """chip_smoke.py's bound of one key-tiled call: q, K, V read and out
    written once; one pass of tensor work; five f32 operations and one exp a
    score."""
    scores = g * nh * lq * n
    t_bytes = (2 * g * lq * c + 2 * g * n * c) * 2 / HBM_BYTES_PER_S
    t_ops = max(2 * 2 * scores * (c // nh) / BF16_TENSOR_FLOPS, scores * 5 / F32_FLOPS,
                scores / MUFU_EXP_PER_S)
    return max(t_bytes, t_ops) * 1e3

def _device_us(fn, iters: int) -> float:
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
                   / iters)
    return best


def _ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.float().cpu().numpy().tobytes()).hexdigest()[:16]


def _row1_args(seed: int, b, h, w, c, s, ch):
    rng = np.random.RandomState(seed)
    t = lambda *sh, sc=1.0, dt=torch.float32: torch.from_numpy(
        (rng.randn(*sh) * sc).astype(np.float32)).to("cuda", dt)
    return (t(b, h, w, c, sc=0.3, dt=torch.bfloat16), 1.0 + t(c, sc=0.1), t(c, sc=0.1),
            t(c, c, sc=c ** -0.5), t(c, sc=0.1), t(b, s, c, dt=torch.bfloat16),
            t(b, s, c, dt=torch.bfloat16), t(c, c, sc=c ** -0.5), t(c, sc=0.1),
            1.0 + t(c, sc=0.1), t(c, sc=0.1), t(c, ch, sc=c ** -0.5), t(ch, sc=0.1),
            t(3, 3, 1, ch, sc=1 / 3), t(ch, sc=0.1), t(ch, c, sc=ch ** -0.5), t(c, sc=0.1))


def _row2_args(seed: int, nw: int):
    rng = np.random.RandomState(seed)
    t = lambda *sh, dt=torch.bfloat16: torch.from_numpy(
        rng.randn(*sh).astype(np.float32)).to("cuda", dt)
    n, c, nh = sum(GROUPS), 256, 8
    mask = torch.from_numpy(np.where(rng.rand(nw, n) < 0.2, -100.0, 0.0)
                            .astype(np.float32)).cuda()
    return (t(nw, 49, c), [t(nw, g, c) for g in GROUPS], [t(nw, g, c) for g in GROUPS],
            t(nh, 49, n, dt=torch.float32), mask, nh)


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    opts = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    ops = importlib.import_module("vss_cffm_tpu_torch.ops")
    cfm = importlib.import_module("vss_cffm_tpu_torch.ops.cfm_attention")
    print(f"[bench_attention] package {ops.__file__.rsplit('/ops/', 1)[0]}", flush=True)
    cases = []
    for i, (what, b, h, w, c, s, nh, ch) in enumerate(ROW1):
        args = _row1_args(i, b, h, w, c, s, ch)
        cases.append((f"row 1 mit_block_fused {what} x{(b, h, w, c)} S={s}",
                      lambda a=args, nh=nh: ops.mit_block_fused(*a, num_heads=nh, eps=1e-6,
                                                                force="kernel")))
    for i, (what, nw) in enumerate(ROW2):
        q, ks, vs, bias, mask, nh = _row2_args(10 + i, nw)
        cases.append((f"row 2 cfm_attention {what} q{tuple(q.shape)} N={sum(GROUPS)}",
                      lambda q=q, ks=ks, vs=vs, bias=bias, mask=mask, nh=nh:
                      ops.cfm_attention(q, ks, vs, bias, mask, nh, force="kernel")))
    if hasattr(cfm, "attention_fwd_tiled"):
        inputs = [(what, case, ("key-tiled",)) for what, *case in TILED]
        inputs += [(what, case, ("key-tiled", "resident")) for what, *case in BOTH]
        for i, (what, (g, lq, c, n, nh), labels) in enumerate(inputs):
            gen = torch.Generator(device="cuda").manual_seed(20 + i)
            r = lambda *sh: torch.randn(*sh, generator=gen, device="cuda").to(torch.bfloat16)
            q, k, v = r(g, lq, c), r(g, n, c), r(g, n, c)
            ks = cfm.scale_in(torch.bfloat16, (c // nh) ** -0.5)
            heads = lambda t, nh=nh: t.view(t.shape[0], t.shape[1], nh, -1).transpose(1, 2)
            sdpa = lambda q=q, k=k, v=v, heads=heads: \
                torch.nn.functional.scaled_dot_product_attention(heads(q), heads(k), heads(v))
            for label in labels:
                cases.append((f"{label} attention {what} q{tuple(q.shape)} N={n} nh={nh}",
                              lambda q=q, k=k, v=v, nh=nh, ks=ks, t=label == "key-tiled":
                              cfm.attention_launch(q, k, v, None, None, nh, 1.0, ks, "bench",
                                                   tiled=t),
                              dict(bound=_tiled_bound_ms(g, lq, n, c, nh), sdpa=sdpa)))
    out = []
    with torch.no_grad():
        for name, fn, *extra in cases:
            digest = _digest(fn())
            ms, us = _ms(fn, opts.iters), _device_us(fn, max(opts.iters // 4, 2))
            line = f"ms={ms:.4f} device_us={us:.1f}"
            row = dict(name=name, ms=ms, device_us=us, digest=digest)
            if extra:
                bound, sdpa_ms = extra[0]["bound"], _ms(extra[0]["sdpa"], opts.iters)
                line += (f" bound_ms={bound:.4f} bound/device={bound * 1e3 / us:.3f} "
                         f"sdpa_ms={sdpa_ms:.4f}")
                row.update(bound_ms=bound, sdpa_ms=sdpa_ms)
            print(f"[bench_attention] {name}: {line} digest={digest}", flush=True)
            out.append(row)
    return out


if __name__ == "__main__":
    main()
