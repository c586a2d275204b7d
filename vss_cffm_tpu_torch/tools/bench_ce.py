"""Microbench of the CE-on-upsampled-logits kernels, each timed alone at the
train geometry: ``python -m vss_cffm_tpu_torch.tools.bench_ce [--n 32]
[--hw 120 120] [--c 124] [--s 4] [--iters 40] [--chunk 20] [--skip-v2]
[--skip-v3] [--device cuda]``.

The port of the JAX package's ``tools/bench_ce.py``: the same bf16 logits
and uint8 labels (``RandomState(0)``, labels in [0, 140) with those ≥ C set to
255), one line per kernel:

- v2 fwd: ``ce_upsampled_loss``'s kernel (natural labels; the TPU's v2
  forward read them h-major);
- v2 bwd: ``ce_bwd_loss_v2`` (h-major labels, phases unrolled);
- v5 fwd: ``ce_fwd_loss_v5`` (w-major labels, phases unrolled);
- v5 bwd: ``ce_upsampled_loss_bwd``'s kernel (natural labels; the TPU's v5
  backward read them w-major);
- v3 fwd / v3 bwd: ``ce_fwd_loss_v3`` / ``ce_bwd_loss_v3`` (w-major labels,
  phases a runtime loop).

The TPU tool's ``--ch`` (its row-chunk sweep) has no counterpart here. Times
come from ``utils.benchmark.time_apply_chunked`` (CUDA events, the fastest
chunk); the tool runs on the card and raises without one, unless
``--device cpu`` asks for the plain versions on the host clock.
"""

from __future__ import annotations

import argparse
from typing import Callable

import numpy as np
import torch

from .. import ops
from ..utils.benchmark import time_apply_chunked

__all__ = ["make_inputs", "cases", "main"]


def make_inputs(n: int, hw: tuple[int, int], c: int, s: int, device) -> dict:
    """The bench's logits (N, h, w, C) bf16, natural uint8 labels (N, h·s,
    w·s) and their h-major / w-major phase layouts, img_w and a cotangent 1."""
    h, w = hw
    rng = np.random.RandomState(0)
    logits = torch.from_numpy(rng.randn(n, h, w, c).astype(np.float32)).to(device, torch.bfloat16)
    labels = rng.randint(0, 140, (n, h * s, w * s))
    labels = torch.from_numpy(np.where(labels >= c, 255, labels).astype(np.uint8)).to(device)
    return dict(logits=logits, labels=labels, lph=ops.labels_to_phase(labels, s).contiguous(),
                lphw=ops.labels_to_phase_w(labels, s).contiguous(), s=s,
                img_w=0.5 / float(labels.numel()), ct=torch.ones((), device=device))


def cases(inp: dict) -> dict[str, tuple[str, Callable]]:
    """name → (the op, call(force)) of each of the six kernels."""
    x, lab, lph, lphw = inp["logits"], inp["labels"], inp["lph"], inp["lphw"]
    s, img_w, ct = inp["s"], inp["img_w"], inp["ct"]
    return {
        "v2 fwd": ("ce_upsampled_loss",
                   lambda force: ops.ce_upsampled_loss(x, lab, s, img_w, True, force=force)),
        "v2 bwd": ("ce_bwd_loss_v2",
                   lambda force: ops.ce_bwd_loss_v2(x, lph, ct, s, img_w, force=force)),
        "v5 fwd": ("ce_fwd_loss_v5",
                   lambda force: ops.ce_fwd_loss_v5(x, lphw, s, img_w, True, force=force)),
        "v5 bwd": ("ce_upsampled_loss_bwd",
                   lambda force: ops.ce_upsampled_loss_bwd(x, lab, ct, s, img_w, force=force)),
        "v3 fwd": ("ce_fwd_loss_v3",
                   lambda force: ops.ce_fwd_loss_v3(x, lphw, s, img_w, True, force=force)),
        "v3 bwd": ("ce_bwd_loss_v3",
                   lambda force: ops.ce_bwd_loss_v3(x, lphw, ct, s, img_w, force=force)),
    }


def main(argv: list[str] | None = None) -> dict[str, float]:
    """Prints one line per kernel; returns name → seconds per call."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument("--hw", type=int, nargs=2, default=(120, 120))
    ap.add_argument("--c", type=int, default=124)
    ap.add_argument("--s", type=int, default=4)
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--chunk", type=int, default=20)
    ap.add_argument("--skip-v2", action="store_true")
    ap.add_argument("--skip-v3", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (plain versions)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("bench_ce: no CUDA device (pass --device cpu for the plain "
                               "versions on the host clock)")
        where = torch.cuda.get_device_name(device)
    else:
        where = "cpu, plain versions, host clock"
    inp = make_inputs(args.n, tuple(args.hw), args.c, args.s, device)
    print(f"bench_ce: N={args.n} hw={tuple(args.hw)} C={args.c} s={args.s} on {where}",
          flush=True)
    out = {}
    with torch.no_grad():
        for name, (_, call) in cases(inp).items():
            if (args.skip_v2 and name.startswith("v2")) or (args.skip_v3 and name.startswith("v3")):
                continue
            t = time_apply_chunked(lambda: call(None), device, iters=args.iters,
                                   chunk=args.chunk)
            print(f"{name:34s} {t * 1e3:8.3f} ms", flush=True)
            out[name] = t
    return out


if __name__ == "__main__":
    main()
