"""Time the depthwise conv kernel over strip lengths at the CFFM-B1 path's
shapes, on the card: ``python -m vss_cffm_tpu_torch.tools.bench_dwconv``.

For each shape (x in bf16 at the MixFFN's call sites, f32 where the whole
block's hidden map feeds it; GELU, no z) and each strip length in ``--rows``
plus the one ``ops.dwconv.strip_plan`` picks, one line: µs per launch
between CUDA events over ``--iters`` launches, and the largest difference
from the plain version. The plan's line is marked; a strip length the plan
should take shows here first.
"""

from __future__ import annotations

import argparse

import torch

from ..ops import dwconv
from ..ops._dispatch import ptr, stream_of

# (shape, dtype of x): inference (B = 4 frames) and the train step (B = 8)
SHAPES = (((4, 120, 120, 256), torch.bfloat16), ((4, 15, 15, 2048), torch.bfloat16),
          ((8, 120, 120, 256), torch.bfloat16), ((8, 15, 15, 2048), torch.bfloat16),
          ((4, 60, 60, 512), torch.float32), ((4, 30, 30, 1280), torch.float32),
          ((8, 120, 120, 256), torch.float32), ((8, 60, 60, 512), torch.float32),
          ((8, 30, 30, 1280), torch.float32))


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, nargs="+", default=[3, 5, 8, 15, 20, 30, 40, 60, 120])
    ap.add_argument("--iters", type=int, default=200)
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_dwconv: no CUDA device")
    gen = torch.Generator("cuda").manual_seed(0)
    out = []
    for shape, dt in SHAPES:
        b, h, w, c = shape
        x = torch.randn(shape, generator=gen, device="cuda").to(dt)
        k = torch.randn((3, 3, 1, c), generator=gen, device="cuda") * 0.3
        bias = torch.randn((c,), generator=gen, device="cuda") * 0.1
        want = dwconv.dwconv3x3_torch(x, k, bias, True).to(torch.bfloat16)
        y = torch.empty(shape, device="cuda", dtype=torch.bfloat16)
        dev, stream = stream_of(x)
        plan = dwconv.strip_plan(b, h, w, c, dwconv._sm_count(dev))[0]
        for rows in sorted({r for r in opts.rows if r <= h} | {plan}):
            def launch():
                return dwconv._c_entry()(ptr(x, "bench"), ptr(k, "bench"), ptr(bias, "bench"),
                                         ptr(y, "bench"), None, b, h, w, c, rows,
                                         int(dt == torch.float32), 1, dev, stream)
            assert launch() == 0
            torch.cuda.synchronize()
            err = (y.float() - want.float()).abs().max().item()
            for _ in range(10):
                launch()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(opts.iters):
                launch()
            end.record()
            torch.cuda.synchronize()
            us = start.elapsed_time(end) * 1e3 / opts.iters
            out.append((shape, str(dt).split(".")[-1], rows, us, err))
            print(f"[bench_dwconv] x{shape} {str(dt).split('.')[-1]} rows={rows}: {us:.1f} us, "
                  f"max_abs_err={err:.2e}{'  <- plan' if rows == plan else ''}", flush=True)
    return out


if __name__ == "__main__":
    main()
