"""The CE forwards of the train step, timed alone on the card: ``python -m
vss_cffm_tpu_torch.tools.bench_ce_fwd [--iters 5]``.

Row 14 (``ce_upsampled_loss``, the default loss) and row 12
(``ce_upsampled_nll``, OHEM and class weights) at the step's two branches,
on the inputs of ``tools/bench_ce_bwd.make_inputs``: logits (N, 120, 120,
124) bf16 for N 8 (the clip's frames) and N 2 (its last frames), ×4 to 480²,
uint8 labels uniform in [0, 124) with 5 % ignored (255). One line each:
device µs per call (torch.profiler over ``--iters`` calls, the larger of two
windows: the kernel and, for row 14, the sum of its partials), the exp bound
(C exps per valid pixel for row 14, per pixel for row 12, at the MUFU rate
of 16 a clock on 132 SMs at 1.98 GHz), the share of the bound (bound over
device time), and the device µs of the PyTorch calls that compute the same
function (``F.interpolate`` and ``F.cross_entropy``, summed or per pixel).
Uses only what older trees of the port also have, so the same file times an
older checkout (``PYTHONPATH=<checkout> python .../bench_ce_fwd.py``).
"""

from __future__ import annotations

import argparse
import importlib

import torch
import torch.nn.functional as F

from vss_cffm_tpu_torch.tools import bench_ce_bwd as bwd

__all__ = ["measure", "main"]


def measure(n: int, iters: int = 5) -> list[dict]:
    """[{row, n, us, bound_us, library_us}] of rows 14 and 12 at N n."""
    ops = importlib.import_module("vss_cffm_tpu_torch.ops")
    c, s = bwd.C, bwd.S
    inp = bwd.make_inputs(n)
    x, lab, valid = inp["logits"], inp["labels"], inp["valid"]
    lab64 = lab.long()

    def library(reduction: str):
        up = F.interpolate(x.permute(0, 3, 1, 2).float(), size=tuple(lab.shape[1:]),
                           mode="bilinear", align_corners=False)
        return F.cross_entropy(up, lab64, reduction=reduction, ignore_index=255)

    rows = []
    with torch.no_grad():
        for row, call, pixels, reduction in (
                (14, lambda: ops.ce_upsampled_loss(x, lab, s, inp["img_w"]), int(valid.sum()),
                 "sum"),
                (12, lambda: ops.ce_upsampled_nll(x, lab, s), lab.numel(), "none")):
            rows.append(dict(row=row, n=n, us=bwd._device_us(call, iters),
                             bound_us=c * pixels / bwd.MUFU_EXP_PER_S * 1e6,
                             library_us=bwd._device_us(lambda: library(reduction), iters)))
    return rows


def format_row(r: dict) -> str:
    return (f"row {r['row']} N={r['n']} logits({r['n']}, {bwd.HW[0]}, {bwd.HW[1]}, {bwd.C}) "
            f"s={bwd.S}: "
            f"{r['us']:.1f} us (exp bound {r['bound_us']:.1f} us, share "
            f"{r['bound_us'] / r['us']:.3f}); library {r['library_us']:.1f} us")


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=5)
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_ce_fwd: needs a CUDA device (the kernels have no CPU mode)")
    out = []
    for n in (8, 2):
        for r in measure(n, opts.iters):
            print(f"[row14] {format_row(r)}", flush=True)
            out.append(r)
        torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    main()
